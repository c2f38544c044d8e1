"""The port's copy of ``c2m_tpu/eval/cityscapes_eval.py`` over the port's
``data/labels.py``, held to the original by
``tests/test_torch_preprocess_tools.py``.

Cityscapes benchmark evaluators: pixel-level semantic labeling (IoU +
instance-weighted iIoU, per class and per category) and instance-level
segmentation (AP / AP50).

Covers the evaluation half of the vendored cityscapesScripts the reference
ships (SURVEY.md 2.8): semantics match
cityscapesScripts/cityscapesscripts/evaluation/evalPixelLevelSemanticLabeling
.py (confusion/IoU rules :228-352, instance weighting :604-645) and
evalInstanceLevelSemanticLabeling.py (matching :254-348, AP :351-546).
Independent numpy design: arrays in / dicts out, vectorized confusion via
bincount; file handling lives in
c2m_tpu_torch/tools/evaluate_cityscapes.py. The distance-sliced metrics (AP_50m/AP_100m) are NOT carried: they require
per-frame vehicle odometry ("distance data") that none of the C2M datasets
provide, and the upstream default path disables them too.

All label ids are the standard Cityscapes *ids* (0..33, data/labels.py);
"ignored in eval" means trainId 255 (void/rare classes). Instance-id
images use the gtFine encoding: pixels of instance k of class c carry
c*1000+k; group/crowd regions carry the bare class id (< 1000).
"""

from collections import OrderedDict

import numpy as np

from c2m_tpu_torch.data.labels import LABELS

# ---------------------------------------------------------------- label sets
_VALID = [l for l in LABELS if l.id >= 0]
N_IDS = max(l.id for l in _VALID) + 1
ID2LABEL = {l.id: l for l in _VALID}

def _ignored(label):
    return not (0 <= label.trainId < 255)

EVAL_IDS = [l.id for l in _VALID if not _ignored(l)]
# classes scored by the instance-level benchmark and the iIoU weighting
INSTANCE_LABELS = [l for l in _VALID if l.has_instances and not _ignored(l)]
INSTANCE_NAMES = [l.name for l in INSTANCE_LABELS]
CATEGORIES = list(OrderedDict((l.category, None) for l in _VALID))
# categories whose every member class has instances (eligible for cat-iIoU)
_INSTANCE_CATEGORIES = [
    c for c in CATEGORIES
    if all(l.has_instances for l in _VALID if l.category == c)
]

# Benchmark constants: dataset-wide mean instance size per class, published
# with the benchmark (evalPixelLevelSemanticLabeling.py:147-158) — the iIoU
# weight normalizer. These are properties of the Cityscapes dataset itself.
AVG_INSTANCE_SIZE = {
    "person": 3462.4756337644, "rider": 3930.4788056518,
    "car": 12794.0202738185, "truck": 27855.1264367816,
    "bus": 35732.1511111111, "train": 67583.7075812274,
    "motorcycle": 6298.7200839748, "bicycle": 4672.3249222261,
    "caravan": 36771.8241758242, "trailer": 16926.9763313609,
}

MIN_REGION_SIZE = 100                      # gt instances smaller are ignored
OVERLAPS = np.arange(0.5, 1.0, 0.05)       # AP thresholds 0.50..0.95


# ====================================================== pixel-level semantic
def confusion_matrix(pred, gt):
    """[N_IDS, N_IDS] pixel counts, gt id on rows / predicted id on columns.

    Every gt pixel counts (ignored classes keep their rows — the IoU rules
    below decide what enters each score). Unknown ids on EITHER side are an
    error — deliberately stricter than upstream, which validates only gt
    ids (evalPixelLevelSemanticLabeling.py:300-303): an out-of-table
    predicted id is always a prediction-pipeline bug worth failing on.
    """
    pred = np.asarray(pred).ravel()
    gt = np.asarray(gt).ravel()
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape}")
    known = np.zeros(256, bool)
    known[[l.id for l in _VALID]] = True
    for which, arr in (("gt", gt), ("predicted", pred)):
        if not known[arr].all():
            bad = np.unique(arr[~known[arr.astype(np.int64)]])
            raise ValueError(
                f"unknown {which} label ids {bad.tolist()} — label *ids* "
                f"(0..33) are expected, not trainIds")
    flat = gt.astype(np.int64) * N_IDS + pred.astype(np.int64)
    return np.bincount(flat, minlength=N_IDS * N_IDS).reshape(
        N_IDS, N_IDS).astype(np.uint64)


def _fp_pixels(conf, label_id):
    """Column sum over non-ignored gt rows other than label_id."""
    rows = [i for i in EVAL_IDS if i != label_id]
    return int(conf[rows, label_id].sum())


def class_iou(conf):
    """name -> IoU for every non-ignored class (NaN when the class never
    appears on either side)."""
    out = {}
    for i in EVAL_IDS:
        tp = int(conf[i, i])
        fn = int(conf[i, :].sum()) - tp
        denom = tp + fn + _fp_pixels(conf, i)
        out[ID2LABEL[i].name] = tp / denom if denom else float("nan")
    return out


def category_iou(conf):
    out = {}
    for cat in CATEGORIES:
        ids = [i for i in EVAL_IDS if ID2LABEL[i].category == cat]
        if not ids:
            # pure-void categories (e.g. 'void') carry no scorable class;
            # upstream reports them as NaN entries — keep key-level parity
            # with its result JSON (means skip NaN either way).
            out[cat] = float("nan")
            continue
        tp = int(conf[np.ix_(ids, ids)].sum())
        fn = int(conf[ids, :].sum()) - tp
        other = [i for i in EVAL_IDS if ID2LABEL[i].category != cat]
        fp = int(conf[np.ix_(other, ids)].sum())
        denom = tp + fn + fp
        out[cat] = tp / denom if denom else float("nan")
    return out


def instance_stats(pred, gt_instance):
    """Weighted tp/fn tallies for iIoU from one (prediction, instanceIds)
    pair. Each gt instance contributes with weight avg_class_size/its size,
    so small (typically distant) instances count as much as large ones."""
    pred = np.asarray(pred)
    gt_instance = np.asarray(gt_instance)
    stats = {"classes": {n: {"tpw": 0.0, "fnw": 0.0} for n in INSTANCE_NAMES
                         if n in AVG_INSTANCE_SIZE},
             "categories": {c: {"tpw": 0.0, "fnw": 0.0}
                            for c in _INSTANCE_CATEGORIES}}
    cat_ids = {c: [l.id for l in _VALID if l.category == c]
               for c in _INSTANCE_CATEGORIES}
    cat_mask = {c: np.isin(pred, ids) for c, ids in cat_ids.items()}
    for inst_id in np.unique(gt_instance[gt_instance > 1000]):
        label = ID2LABEL[int(inst_id) // 1000]
        if _ignored(label) or label.name not in AVG_INSTANCE_SIZE:
            continue
        mask = gt_instance == inst_id
        size = int(mask.sum())
        weight = AVG_INSTANCE_SIZE[label.name] / size
        tp = int((pred[mask] == label.id).sum())
        cls = stats["classes"][label.name]
        cls["tpw"] += tp * weight
        cls["fnw"] += (size - tp) * weight
        if label.category in stats["categories"]:
            ctp = int((cat_mask[label.category] & mask).sum())
            cat = stats["categories"][label.category]
            cat["tpw"] += ctp * weight
            cat["fnw"] += (size - ctp) * weight
    return stats


def _merge_stats(acc, new):
    for kind in ("classes", "categories"):
        for name, s in new[kind].items():
            acc[kind][name]["tpw"] += s["tpw"]
            acc[kind][name]["fnw"] += s["fnw"]
    return acc


def class_iiou(conf, stats):
    out = {}
    for label in INSTANCE_LABELS:
        if label.name not in stats["classes"]:
            continue
        s = stats["classes"][label.name]
        denom = s["tpw"] + s["fnw"] + _fp_pixels(conf, label.id)
        out[label.name] = s["tpw"] / denom if denom else float("nan")
    return out


def category_iiou(conf, stats):
    out = {}
    for cat, s in stats["categories"].items():
        # fp columns span ALL the category's ids, ignored members included
        # (unlike category_iou) — the benchmark builds this column set from
        # its instance stats, which keep caravan/trailer
        ids = [l.id for l in _VALID if l.category == cat]
        other = [i for i in EVAL_IDS if ID2LABEL[i].category != cat]
        fp = int(conf[np.ix_(other, ids)].sum())
        denom = s["tpw"] + s["fnw"] + fp
        out[cat] = s["tpw"] / denom if denom else float("nan")
    return out


def _mean(scores):
    vals = [v for v in scores.values() if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")


def evaluate_pixel_level(pairs, instance_gts=None):
    """pairs: iterable of (pred_ids, gt_ids) HxW arrays of Cityscapes label
    ids. instance_gts: matching iterable of gtFine instanceIds arrays; when
    given, the instance-weighted iIoU scores are computed too.

    Returns {"classScores", "categoryScores", "averageScoreClasses",
    "averageScoreCategories"} (+ the four iIoU counterparts when
    instance_gts is given), keys named as the upstream result dict.
    """
    conf = np.zeros((N_IDS, N_IDS), np.uint64)
    stats = None
    pairs = list(pairs)
    if instance_gts is not None:
        instance_gts = list(instance_gts)
        if len(instance_gts) != len(pairs):
            raise ValueError("instance_gts length mismatch")
        stats = {"classes": {n: {"tpw": 0.0, "fnw": 0.0}
                             for n in INSTANCE_NAMES},
                 "categories": {c: {"tpw": 0.0, "fnw": 0.0}
                                for c in _INSTANCE_CATEGORIES}}
    for k, (pred, gt) in enumerate(pairs):
        conf += confusion_matrix(pred, gt)
        if stats is not None:
            _merge_stats(stats, instance_stats(pred, instance_gts[k]))
    res = {"classScores": class_iou(conf),
           "categoryScores": category_iou(conf)}
    res["averageScoreClasses"] = _mean(res["classScores"])
    res["averageScoreCategories"] = _mean(res["categoryScores"])
    if stats is not None:
        res["classInstScores"] = class_iiou(conf, stats)
        res["categoryInstScores"] = category_iiou(conf, stats)
        res["averageScoreInstClasses"] = _mean(res["classInstScores"])
        res["averageScoreInstCategories"] = _mean(res["categoryInstScores"])
    res["confMatrix"] = conf
    return res


# ================================================== instance-level AP / AP50
def collect_gt_instances(gt_instance):
    """Per-class-name instance records from one instanceIds image.

    Group/crowd regions (bare class id < 1000) are kept — they never count
    as scorable gt but turn overlapping predictions into ignores.
    """
    gt_instance = np.asarray(gt_instance)
    out = {n: [] for n in INSTANCE_NAMES}
    for inst_id in np.unique(gt_instance):
        iid = int(inst_id)
        label = ID2LABEL.get(iid if iid < 1000 else iid // 1000)
        if label is None or label.name not in out:
            continue
        out[label.name].append({
            "inst_id": iid,
            "pixel_count": int((gt_instance == inst_id).sum()),
        })
    return out


def match_image(gt_instance, predictions):
    """Intersections between one image's predictions and its gt instances.

    predictions: list of {"mask": HxW bool/0-1, "label_id": int,
    "confidence": float}. Returns {"gt": per-class gt records each with
    "matched" pred list, "pred": per-class pred records each with "matched"
    gt list and its void-pixel overlap}.
    """
    gt_instance = np.asarray(gt_instance)
    gts = collect_gt_instances(gt_instance)
    for recs in gts.values():
        for g in recs:
            g["matched"] = []
    void_ids = [l.id for l in _VALID if _ignored(l)]
    void = np.isin(gt_instance, void_ids)
    preds = {n: [] for n in INSTANCE_NAMES}
    for p in predictions:
        label = ID2LABEL.get(int(p["label_id"]))
        if label is None or label.name not in preds:
            continue
        mask = np.asarray(p["mask"]) != 0
        if mask.shape != gt_instance.shape:
            raise ValueError("prediction mask shape mismatch")
        count = int(mask.sum())
        if not count:
            continue
        rec = {"pixel_count": count,
               "confidence": float(p["confidence"]),
               "void_intersection": int((void & mask).sum()),
               "matched": []}
        for g in gts[label.name]:
            inter = int(((gt_instance == g["inst_id"]) & mask).sum())
            if inter:
                rec["matched"].append(
                    {"gt": g, "intersection": inter})
                g["matched"].append(
                    {"pred": rec, "intersection": inter})
        preds[label.name].append(rec)
    return {"gt": gts, "pred": preds}


def _iou(inter, a, b):
    return inter / (a + b - inter)


def _ap_from_curve(y_true, y_score, hard_fns):
    """Average precision by the benchmark's step-wise integration over the
    unique-confidence precision/recall points (+ the artificial p=1/r=0
    point)."""
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    cum = np.concatenate([np.cumsum(y_true), [0.0]])
    thresholds, first_idx = np.unique(y_score, return_index=True)
    n, n_true = len(y_score), cum[-2] if len(y_score) else 0.0
    precision = np.ones(len(first_idx) + 1)
    recall = np.zeros(len(first_idx) + 1)
    for k, idx in enumerate(first_idx):
        below = cum[idx - 1]           # true positives scored under idx
        tp = n_true - below
        fp = n - idx - tp
        fn = below + hard_fns
        precision[k] = tp / (tp + fp)
        recall[k] = tp / (tp + fn)
    # step widths: centered differences of the recall sequence, padded with
    # its first value on the left and 0 on the right
    padded = np.concatenate([[recall[0]], recall, [0.0]])
    widths = (padded[:-2] - padded[2:]) * 0.5
    return float(np.dot(precision, widths))


def average_precision(matches, overlaps=None, min_region_size=None):
    """ap[class, overlap] over per-image match dicts (match_image outputs).

    NaN where a class has no gt instances anywhere; 0.0 where it has gt but
    no predictions.
    """
    overlaps = OVERLAPS if overlaps is None else np.asarray(overlaps)
    min_sz = MIN_REGION_SIZE if min_region_size is None else min_region_size
    ap = np.zeros((len(INSTANCE_NAMES), len(overlaps)))
    for li, name in enumerate(INSTANCE_NAMES):
        for oi, th in enumerate(overlaps):
            y_true, y_score = [], []
            hard_fns = 0
            have_gt = have_pred = False
            for m in matches:
                gts = [g for g in m["gt"][name]
                       if g["inst_id"] >= 1000 and g["pixel_count"] >= min_sz]
                preds = m["pred"][name]
                have_gt |= bool(gts)
                have_pred |= bool(preds)
                cur_true, cur_score = [], []
                for g in gts:
                    best = -np.inf
                    for pm in g["matched"]:
                        p = pm["pred"]
                        if _iou(pm["intersection"], g["pixel_count"],
                                p["pixel_count"]) <= th:
                            continue
                        c = p["confidence"]
                        if best == -np.inf:
                            best = c
                        else:  # duplicate hit: weaker one becomes an FP
                            lo, best = min(best, c), max(best, c)
                            cur_true.append(0.0)
                            cur_score.append(lo)
                    if best == -np.inf:
                        hard_fns += 1
                    else:
                        cur_true.append(1.0)
                        cur_score.append(best)
                for p in preds:
                    if any(_iou(gm["intersection"], gm["gt"]["pixel_count"],
                                p["pixel_count"]) > th
                           for gm in p["matched"]):
                        continue
                    # unmatched: FP unless mostly covering ignore regions
                    # (void pixels, group regions, too-small gt instances;
                    # a region that is both group AND small adds twice,
                    # matching the benchmark's two independent checks)
                    ignore = p["void_intersection"]
                    for gm in p["matched"]:
                        g = gm["gt"]
                        if g["inst_id"] < 1000:
                            ignore += gm["intersection"]
                        if g["pixel_count"] < min_sz:
                            ignore += gm["intersection"]
                    if ignore / p["pixel_count"] <= th:
                        cur_true.append(0.0)
                        cur_score.append(p["confidence"])
                y_true.extend(cur_true)
                y_score.extend(cur_score)
            if not have_gt:
                ap[li, oi] = float("nan")
            elif not have_pred:
                ap[li, oi] = 0.0
            else:
                ap[li, oi] = _ap_from_curve(
                    np.asarray(y_true), np.asarray(y_score), hard_fns)
    return ap


def evaluate_instance_level(gt_instances, predictions_per_image,
                            overlaps=None):
    """gt_instances: iterable of instanceIds images; predictions_per_image:
    matching iterable of prediction lists (see match_image). Returns
    {"allAp", "allAp50%", "classes": {name: {"ap", "ap50%"}}}."""
    gt_instances = list(gt_instances)
    predictions_per_image = list(predictions_per_image)
    if len(gt_instances) != len(predictions_per_image):
        raise ValueError("length mismatch")
    matches = [match_image(g, p)
               for g, p in zip(gt_instances, predictions_per_image)]
    overlaps = OVERLAPS if overlaps is None else np.asarray(overlaps)
    ap = average_precision(matches, overlaps)
    o50 = int(np.argmin(np.abs(overlaps - 0.5)))
    res = {"allAp": float(np.nanmean(ap)) if not np.isnan(ap).all()
           else float("nan"),
           "allAp50%": float(np.nanmean(ap[:, o50]))
           if not np.isnan(ap[:, o50]).all() else float("nan"),
           "classes": {}}
    for li, name in enumerate(INSTANCE_NAMES):
        res["classes"][name] = {"ap": float(np.mean(ap[li])),
                                "ap50%": float(ap[li, o50])}
    return res
