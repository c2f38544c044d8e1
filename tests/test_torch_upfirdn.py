"""``c2m_tpu_torch/ops/upfirdn.py`` against ``c2m_tpu/ops/upfirdn.py`` on
random inputs, within 1e-5: ``upfirdn2d`` over up- and downsampling,
positive and negative pads and asymmetric filters (so a missing flip
shows), ``bias_act`` over every activation with and without bias, gain and
clamp."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from c2m_tpu.ops import upfirdn as jup
from c2m_tpu_torch.ops import upfirdn as pup

TOL = 1e-5


@pytest.mark.parametrize("up,down,pad,k", [
    (1, 1, (0, 0), (1, 1)),
    (1, 1, (1, 2), (3, 3)),
    (2, 1, (2, 1), (4, 4)),
    (1, 2, (1, 1), (4, 4)),
    (2, 2, (1, 0), (2, 2)),
    (3, 2, (2, 3), (3, 5)),
    (2, 1, (-1, -2), (3, 3)),
    (1, 1, (-2, 1), (2, 3)),
])
def test_upfirdn2d_matches_jax(up, down, pad, k):
    rng = np.random.RandomState(sum(k) + 10 * up + down)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    kernel = rng.rand(*k).astype(np.float32)
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), jnp.asarray(kernel), up,
                                    down, pad))
    got = pup.upfirdn2d(torch.from_numpy(x), torch.from_numpy(kernel), up,
                        down, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_upfirdn2d_is_a_convolution():
    """The filter is flipped: with one pixel of padding, a one-hot filter at
    its first tap moves an impulse up-left (a cross-correlation would move
    it down-right)."""
    x = np.zeros((1, 5, 5, 1), np.float32)
    x[0, 1, 1, 0] = 1.0
    k = np.zeros((3, 3), np.float32)
    k[0, 0] = 1.0
    y = pup.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k),
                      pad=(1, 1)).numpy()
    assert y[0, 0, 0, 0] == 1.0 and y.sum() == 1.0


@pytest.mark.parametrize("act", sorted(pup._ACTS))
@pytest.mark.parametrize("bias,gain,clamp", [(False, None, None),
                                             (True, None, 0.5),
                                             (True, 0.7, None),
                                             (False, 2.0, 1.0)])
def test_bias_act_matches_jax(act, bias, gain, clamp):
    rng = np.random.RandomState(len(act))
    x = rng.randn(2, 4, 5, 6).astype(np.float32) * 2
    b = rng.randn(6).astype(np.float32) if bias else None
    want = np.asarray(jup.bias_act(jnp.asarray(x), None if b is None else
                                   jnp.asarray(b), act, gain, clamp))
    got = pup.bias_act(torch.from_numpy(x), None if b is None else
                       torch.from_numpy(b), act, gain, clamp).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert set(pup._ACTS) == set(jup._ACTS)
