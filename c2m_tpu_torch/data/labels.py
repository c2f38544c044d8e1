"""The port's copy of ``c2m_tpu/data/labels.py``, held to the original by
``tests/test_torch_data.py``.

Cityscapes label table + KITTI-360 mapping.

Reference: cityscapesScripts/cityscapesscripts/helpers/labels.py:62 (the
standard label list; only the fields the pipeline consumes) and
src/kitti2cityscapes_semantic.py (KITTI-360 ids -> cityscapes trainIds).
trainIds 0..10 are the "stuff"/background channels, 11..18 the "thing"
foreground channels (the 11/9 bg/fg one-hot split, cityscapes.py:36-42 —
note channel fg covers trainIds 11..19 giving 9 channels).
"""

from collections import namedtuple

Label = namedtuple("Label", ["name", "id", "trainId", "category",
                             "has_instances", "color"])

LABELS = [
    Label("unlabeled",            0, 255, "void",         False, (0, 0, 0)),
    Label("ego vehicle",          1, 255, "void",         False, (0, 0, 0)),
    Label("rectification border", 2, 255, "void",         False, (0, 0, 0)),
    Label("out of roi",           3, 255, "void",         False, (0, 0, 0)),
    Label("static",               4, 255, "void",         False, (0, 0, 0)),
    Label("dynamic",              5, 255, "void",         False, (111, 74, 0)),
    Label("ground",               6, 255, "void",         False, (81, 0, 81)),
    Label("road",                 7,   0, "flat",         False, (128, 64, 128)),
    Label("sidewalk",             8,   1, "flat",         False, (244, 35, 232)),
    Label("parking",              9, 255, "flat",         False, (250, 170, 160)),
    Label("rail track",          10, 255, "flat",         False, (230, 150, 140)),
    Label("building",            11,   2, "construction", False, (70, 70, 70)),
    Label("wall",                12,   3, "construction", False, (102, 102, 156)),
    Label("fence",               13,   4, "construction", False, (190, 153, 153)),
    Label("guard rail",          14, 255, "construction", False, (180, 165, 180)),
    Label("bridge",              15, 255, "construction", False, (150, 100, 100)),
    Label("tunnel",              16, 255, "construction", False, (150, 120, 90)),
    Label("pole",                17,   5, "object",       False, (153, 153, 153)),
    Label("polegroup",           18, 255, "object",       False, (153, 153, 153)),
    Label("traffic light",       19,   6, "object",       False, (250, 170, 30)),
    Label("traffic sign",        20,   7, "object",       False, (220, 220, 0)),
    Label("vegetation",          21,   8, "nature",       False, (107, 142, 35)),
    Label("terrain",             22,   9, "nature",       False, (152, 251, 152)),
    Label("sky",                 23,  10, "sky",          False, (70, 130, 180)),
    Label("person",              24,  11, "human",        True,  (220, 20, 60)),
    Label("rider",               25,  12, "human",        True,  (255, 0, 0)),
    Label("car",                 26,  13, "vehicle",      True,  (0, 0, 142)),
    Label("truck",               27,  14, "vehicle",      True,  (0, 0, 70)),
    Label("bus",                 28,  15, "vehicle",      True,  (0, 60, 100)),
    Label("caravan",             29, 255, "vehicle",      True,  (0, 0, 90)),
    Label("trailer",             30, 255, "vehicle",      True,  (0, 0, 110)),
    Label("train",               31,  16, "vehicle",      True,  (0, 80, 100)),
    Label("motorcycle",          32,  17, "vehicle",      True,  (0, 0, 230)),
    Label("bicycle",             33,  18, "vehicle",      True,  (119, 11, 32)),
    # negative id => never drawn in GT rasters (json2labelImg.py:91-92);
    # present so polygon annotations naming it resolve (tools/prepare_gt_labels)
    Label("license plate",       -1,  -1, "vehicle",      False, (0, 0, 142)),
]

ID_TO_TRAINID = {l.id: l.trainId for l in LABELS if l.id >= 0}
TRAINID_TO_NAME = {l.trainId: l.name for l in LABELS
                   if 0 <= l.trainId < 255}
TRAINID_TO_COLOR = {l.trainId: l.color for l in LABELS
                    if 0 <= l.trainId < 255}
THING_TRAINIDS = tuple(sorted({l.trainId for l in LABELS
                               if l.has_instances and 0 <= l.trainId < 255}))


def id_to_trainid(arr):
    """Vectorized label-id -> trainId map (255 = ignore)."""
    import numpy as np
    lut = np.full(256, 255, np.uint8)
    for lid, tid in ID_TO_TRAINID.items():
        lut[lid] = tid
    return lut[arr]


# ---- KITTI-360 extension (src/kitti2cityscapes_semantic.py:66-116) --------
# Ids 0..33 carry the standard cityscapes trainIds above; KITTI-360 adds
# ids 34..44 with the reference's C2M assignments: garage->building(2),
# gate->fence(4), smallpole->pole(5), everything else ignored. The thing
# split for instance renumbering is the hardcoded trainId list 11..18
# (:121), not the table's hasInstances column.
KITTI360_EXTRA_ID_TO_TRAINID = {
    34: 2,    # garage -> building
    35: 4,    # gate -> fence
    36: 255,  # stop
    37: 5,    # smallpole -> pole
    38: 255,  # lamp
    39: 255,  # trash bin
    40: 255,  # vending machine
    41: 255,  # box
    42: 255,  # unknown construction
    43: 255,  # unknown vehicle
    44: 255,  # unknown object
}
KITTI360_ID_TO_TRAINID = {**ID_TO_TRAINID, **KITTI360_EXTRA_ID_TO_TRAINID}


def kitti360_id_to_trainid(arr):
    """Vectorized KITTI-360 label-id -> cityscapes trainId (255 = ignore)."""
    import numpy as np
    lut = np.full(256, 255, np.uint8)
    for lid, tid in KITTI360_ID_TO_TRAINID.items():
        lut[lid] = tid
    return lut[arr]
