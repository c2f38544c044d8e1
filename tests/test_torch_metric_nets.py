"""The port's metric nets (c2m_tpu_torch/eval/{inception,i3d,yolov3}.py) and
their weight bridge against the JAX package on the CPU.

- InceptionV3 at [2,75,75,3], I3D at [1,5,32,32,3] (both endpoints) and
  YOLOv3 at [1,64,64,3] against the jitted JAX ``apply`` with the same
  weights (tests/torch_metric_fixtures.py), within 1e-4 abs + 1e-4
  relative to the largest output (YOLOv3: centres and scores so, box sizes
  as their logs, since they are exponentials of logits).
- The bridge: JAX tree -> npz -> port -> JAX tree bit for bit; a leaf too
  many or too few raises; torchvision's and pytorch-i3d's layouts load
  into the port as they are and agree with ``tools/convert_inception.py``
  and ``tools/convert_i3d.py``.
- ``_decode``'s anchor-major order on a prediction whose channels encode
  (anchor, field, y, x); ``_conv_block_order``; the darknet loader (every
  float consumed once, the JAX loader's state carried across); NMS and the
  detection CLI's geometry equal to the JAX ones; ``yolo_detect_torch.py``
  writes a ``.txt`` and a ``.png`` per image with the JAX package's boxes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c2m_tpu.eval import yolov3 as jyolo
from c2m_tpu_torch.eval import i3d as pi3d
from c2m_tpu_torch.eval import inception as pinc
from c2m_tpu_torch.eval import yolov3 as pyolo
from c2m_tpu_torch.utils import convert
from tests.torch_metric_fixtures import NETS, net_weights, seeded, within

_CACHE = {}


def weights(name):
    if name not in _CACHE:
        _CACHE[name] = net_weights(name, seed=len(name))
    return _CACHE[name]


_JITTED = {}


def jax_apply(name, variables, x, **kw):
    """The JAX net's jitted apply, one compile per net and keywords."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _JITTED:
        model = NETS[name][0]()
        _JITTED[key] = jax.jit(lambda v, x: model.apply(v, x, **kw))
    return np.asarray(_JITTED[key](variables, jnp.asarray(x)))


@pytest.mark.parametrize("name,shape,kw", [
    ("inception", (2, 75, 75, 3), {}),
    ("i3d", (1, 5, 32, 32, 3), {"endpoint": "embedding"}),
    ("i3d", (1, 5, 32, 32, 3), {"endpoint": "logits"}),
], ids=["inception", "i3d-embedding", "i3d-logits"])
def test_net_matches_the_jax_net(name, shape, kw):
    variables, net = weights(name)
    x = seeded(shape, seed=7)
    want = jax_apply(name, variables, x, **kw)
    with torch.no_grad():
        got = net(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1 and np.isfinite(want).all()
    assert within(got, want) <= 1.0, within(got, want)


def test_yolov3_matches_the_jax_net():
    variables, net = weights("yolov3")
    x = seeded((1, 64, 64, 3), 0.0, 1.0, seed=8)
    want = jax_apply("yolov3", variables, x, train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 3 * (4 + 16 + 64), 85)
    for cols in (slice(0, 2), slice(4, 85)):
        assert within(got[..., cols], want[..., cols]) <= 1.0, cols
    # box sizes are exp(logit) x anchor: their float32 error is relative
    # per box (with boxes of 1e11 pixels it was 1.03e-4 of the largest),
    # so they are held as logs, i.e. as the logits
    assert within(np.log(got[..., 2:4]), np.log(want[..., 2:4])) <= 1.0
    # the confidences and classes are not saturated: the input shows
    assert 0.05 < want[..., 4].std()


@pytest.mark.parametrize("name", ["inception", "i3d", "yolov3"])
def test_bridge_round_trip_through_npz_is_bit_for_bit(name, tmp_path):
    variables, net = weights(name)
    path = str(tmp_path / f"{name}.npz")
    convert.write_variables_npz(path, variables)
    back = convert.read_variables_npz(path)
    flat, flat_back = convert.flatten(variables), convert.flatten(back)
    assert flat.keys() == flat_back.keys()
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k])
    sd = getattr(convert, f"{name}_from_jax")(back)
    want = net.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("name", ["inception", "i3d", "yolov3"])
def test_bridge_fails_loudly(name):
    variables, _ = weights(name)
    flat = convert.flatten(variables)
    extra = dict(flat, **{"params/stray/kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="not consumed"):
        getattr(convert, f"{name}_from_jax")(convert.unflatten(extra))
    short = dict(flat)
    short.pop(sorted(k for k in flat if k.endswith("/var"))[0])
    with pytest.raises(KeyError, match="lack"):
        getattr(convert, f"{name}_from_jax")(convert.unflatten(short))


def test_torchvision_layout_loads_and_agrees_with_its_converter():
    from tests.torch_inception import InceptionV3Trunk
    from tools.convert_inception import convert as convert_inception
    torch.manual_seed(0)
    ref = InceptionV3Trunk().eval()
    sd = ref.state_dict()
    net = pinc.InceptionV3Pool3().eval()
    net.load_state_dict(sd, strict=True)
    x = torch.from_numpy(seeded((1, 75, 75, 3), seed=3))
    with torch.no_grad():
        torch.testing.assert_close(net(x), ref(x.permute(0, 3, 1, 2)),
                                   rtol=0, atol=0)
    p, s = convert_inception(sd)
    got = convert.inception_from_jax({"params": p, "batch_stats": s})
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_pytorch_i3d_layout_loads_and_agrees_with_its_converter():
    from tests.torch_i3d import I3DTrunk
    from tools.convert_i3d import convert as convert_i3d
    torch.manual_seed(0)
    ref = I3DTrunk().eval()
    sd = ref.state_dict()
    net = pi3d.InceptionI3d().eval()
    net.load_state_dict(sd, strict=True)
    x = torch.from_numpy(seeded((1, 5, 32, 32, 3), seed=4))
    with torch.no_grad():
        torch.testing.assert_close(net(x), ref(x.permute(0, 4, 1, 2, 3)),
                                   rtol=0, atol=0)
    p, s = convert_i3d(sd)
    got = convert.i3d_from_jax({"params": p, "batch_stats": s})
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_decode_order_equals_the_jax_decode(scale):
    """Every (anchor, field, y, x) gets its own logit, a permutation of an
    even grid: a wrong split or transpose moves values to other rows."""
    b, a, f, h, w = 2, 3, 85, 3, 4
    n = b * a * f * h * w
    codes = np.random.RandomState(scale).permutation(n).astype(np.float32)
    codes = (codes / n * 6.0 - 3.0).reshape(b, a, f, h, w)
    nchw = codes.reshape(b, a * f, h, w)
    nhwc = codes.transpose(0, 3, 4, 1, 2).reshape(b, h, w, a * f)
    stride = (32, 16, 8)[scale]
    want = np.asarray(jyolo._decode(jnp.asarray(nhwc), jyolo.ANCHORS[scale],
                                    stride))
    got = pyolo._decode(torch.from_numpy(nchw), pyolo.ANCHORS[scale],
                        stride).numpy()
    assert got.shape == want.shape == (b, a * h * w, f)
    # XLA's and PyTorch's exp and logistic differ by an ulp on 0.7% of
    # these elements (1.6e-7 relative, measured); an element in another
    # row or field differs by the grid spacing, >= 1e-4 relative
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)


def test_conv_block_order_is_the_jax_one():
    assert pyolo._conv_block_order() == jyolo._conv_block_order()
    blocks = pyolo.YoloV3().conv_blocks()
    assert len(blocks) == len(jyolo._conv_block_order()) == 75
    assert [b.bn is None for _, b in blocks].count(True) == 3


def darknet_size(model):
    """Floats a ``yolov3.weights`` blob holds after its header."""
    total = 0
    for _, blk in model.conv_blocks():
        w = blk.conv.weight
        total += w.numel() + w.shape[0] * (4 if blk.bn is not None else 1)
    return total


def write_darknet(path, n, seed=0):
    with open(path, "wb") as f:
        np.arange(5, dtype=np.int32).tofile(f)
        np.random.default_rng(seed).standard_normal(
            n, dtype=np.float32).tofile(f)


def test_darknet_loader_consumes_every_float_and_matches_the_jax_loader(
        tmp_path):
    model = pyolo.YoloV3()
    n = darknet_size(model)
    assert n == 62001757                   # the COCO yolov3.weights' count
    path = str(tmp_path / "yolov3.weights")
    write_darknet(path, n)
    pyolo.load_darknet_weights(model, path)
    blob = np.fromfile(path, np.float32)[5:]
    np.testing.assert_array_equal(model.backbone.stem.bn.bias.detach().numpy(),
                                  blob[:32])
    np.testing.assert_array_equal(
        model.heads[2].detect.conv.weight.detach().numpy().ravel(),
        blob[-255 * 256:])
    # the JAX loader on a tree of the same shapes, carried across
    loaded = jyolo.load_darknet_weights(weights("yolov3")[0], path)
    want = convert.yolov3_from_jax(loaded)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    with open(path, "ab") as f:                          # one float too many
        np.zeros(1, np.float32).tofile(f)
    with pytest.raises(ValueError, match="1 unconsumed"):
        pyolo.load_darknet_weights(pyolo.YoloV3(), path)
    write_darknet(path, n // 2)
    with pytest.raises(ValueError, match="exhausted"):
        pyolo.load_darknet_weights(pyolo.YoloV3(), path)


def nms_preds(seed, n=300):
    """Boxes crowded into a 60-pixel square, most of them of three classes,
    so that the greedy pass suppresses within a class and keeps across."""
    rng = np.random.RandomState(seed)
    pred = np.zeros((n, 85), np.float32)
    pred[:, :2] = rng.uniform(20, 80, (n, 2))
    pred[:, 2:4] = rng.uniform(8, 40, (n, 2))
    pred[:, 4] = rng.uniform(0, 1, n)
    pred[:, 5:] = rng.uniform(0, 1, (n, 80)) ** 8
    pred[np.arange(n), 5 + rng.randint(0, 3, n)] += 0.5
    return pred


@pytest.mark.parametrize("seed,conf,nms", [(0, 0.5, 0.4), (1, 0.5, 0.4),
                                           (2, 0.8, 0.3), (3, 0.95, 0.4),
                                           (4, 1.1, 0.4)])
def test_nms_equals_the_jax_nms(seed, conf, nms):
    pred = nms_preds(seed)
    want = jyolo.non_max_suppression(pred, conf, nms)
    got = pyolo.non_max_suppression(pred, conf, nms)
    if want is None:
        assert got is None
    else:
        assert 0 < len(want) <= (pred[:, 4] >= conf).sum()
        np.testing.assert_array_equal(got, want)
    if conf <= 0.8:                       # the crowded boxes suppressed some
        assert len(want) < (pred[:, 4] >= conf).sum()


def test_detect_geometry_equals_the_jax_cli():
    import yolo_detect_torch as port
    from tools import yolo_detect as ref
    for h, w, size in ((100, 160, 64), (90, 60, 96), (64, 64, 32)):
        img = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
        x, geom = port.pad_to_square_resize(img, size)
        wx, wgeom = ref.pad_to_square_resize(img, size)
        np.testing.assert_array_equal(x, wx)
        assert geom == wgeom
        boxes = np.random.RandomState(w).uniform(0, size, (7, 4))
        np.testing.assert_array_equal(port.rescale_boxes(boxes, geom, size),
                                      ref.rescale_boxes(boxes, wgeom, size))


def test_yolo_detect_cli_writes_the_jax_boxes(tmp_path):
    from PIL import Image
    import yolo_detect_torch
    from tools.yolo_detect import pad_to_square_resize, rescale_boxes
    variables, _ = weights("yolov3")
    npz = str(tmp_path / "yolo.npz")
    convert.write_variables_npz(npz, variables)
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.RandomState(5)
    # square images: no zero band, which the calibration did not see; at
    # 64x64, the size test_yolov3_matches_the_jax_net compiled the JAX net at
    for name, size in (("a", 48), ("b", 80)):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            src / f"{name}.png")
    out = tmp_path / "out"
    assert yolo_detect_torch.main(
        ["--image-folder", str(src), "--weights", npz, "--img-size", "64",
         "--conf-thres", "0.5", "--out", str(out), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["a.png", "a.txt", "b.png", "b.txt"]
    total = 0
    for name in ("a", "b"):
        img = np.asarray(Image.open(src / f"{name}.png").convert("RGB"),
                         np.float32) / 255.0
        x, geom = pad_to_square_resize(img, 64)
        pred = jax_apply("yolov3", variables, x[None], train=False)
        det = jyolo.non_max_suppression(pred[0], 0.5, 0.4)
        rows = [ln.split() for ln in open(out / f"{name}.txt").read()
                .splitlines()]
        want = [] if det is None else det
        assert len(rows) == len(want)
        total += len(rows)
        if len(rows):
            boxes = rescale_boxes(det[:, :4], geom, 64)
            got = np.array([[float(v) for v in r[1:]] for r in rows])
            assert [int(r[0]) for r in rows] == [int(c) for c in det[:, 6]]
            np.testing.assert_allclose(got[:, 0], det[:, 4], atol=1e-4)
            np.testing.assert_allclose(got[:, 1:], boxes, atol=0.06)
    assert total > 0
