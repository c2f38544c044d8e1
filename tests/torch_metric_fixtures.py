"""Shared helpers of the metric-net parity tests (tests/test_torch_metric_nets.py,
tests/test_torch_eval_nets.py).

A net's JAX variable tree comes from ``jax.eval_shape`` of its Flax
``init`` (no compile, no Flax init run) with leaves drawn by
``random_leaves``; the port takes it through the bridge. Random kernels
shrink the activations layer by layer until the biases alone are left, so
each BatchNorm's running statistics are then set from its own input over
one forward of a seeded batch (biased variance, layer after layer, by
``torch_seeded_nets.calibrate_bn_``, which seeds the nets on the card
too): the activations stay of order 1 through the depth and the output
depends on the input. The calibrated state goes back through the bridge, so both
packages hold the same weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.eval import i3d as ji3d
from c2m_tpu.eval import inception as jinc
from c2m_tpu.eval import yolov3 as jyolo
from tests.torch_seeded_nets import calibrate_bn_
from c2m_tpu_torch.eval import i3d as pi3d
from c2m_tpu_torch.eval import inception as pinc
from c2m_tpu_torch.eval import yolov3 as pyolo
from c2m_tpu_torch.utils import convert
from tests.torch_port_fixtures import random_leaves

# name -> (JAX module, port module, JAX init keywords, calibration batch,
# its value range)
NETS = {
    "inception": (jinc.InceptionV3Pool3, pinc.InceptionV3Pool3, {},
                  (4, 75, 75, 3), (-1.0, 1.0)),
    "i3d": (ji3d.InceptionI3d, pi3d.InceptionI3d, {"endpoint": "logits"},
            (2, 5, 64, 64, 3), (-1.0, 1.0)),
    # at 64x64 the stride-32 map is 2x2, too few values for statistics
    # that hold at another input: boxes of 1e11 pixels followed
    "yolov3": (jyolo.YoloV3, pyolo.YoloV3, {"train": False},
               (2, 128, 128, 3), (0.0, 1.0)),
}


def seeded(shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def net_weights(name: str, seed: int = 0, calib=None):
    """(the JAX variables as a nested numpy tree, the port's net in eval
    mode on the CPU), the same weights, calibrated on ``calib`` (default a
    seeded uniform batch). Calibrate on inputs like those the net then
    sees: a zero band the calibration never saw drives YOLOv3's box logits
    past exp's float32 range."""
    jcls, pcls, kw, shape, (lo, hi) = NETS[name]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jcls().init(
        key, jnp.zeros(shape, jnp.float32), **kw))
    net = pcls()
    net.load_state_dict(getattr(convert, f"{name}_from_jax")(
        random_leaves(shapes, seed)))
    net.eval()
    if calib is None:
        calib = seeded(shape, lo, hi, seed + 1)
    calibrate_bn_(net, torch.from_numpy(calib))
    return getattr(convert, f"{name}_to_jax")(net.state_dict()), net


def within(got, want, rel=1e-4, abs_=1e-4) -> float:
    """max |got - want| over (abs_ + rel · max |want|): <= 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / (abs_ + rel * np.abs(want).max()))
