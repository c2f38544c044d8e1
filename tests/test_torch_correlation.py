"""The port's correlation, channel norm and pixel-space resample against
the JAX package, on the CPU.

On a CPU tensor ``c2m_tpu_torch.ops.correlation.correlation`` takes kernel
K5's plain version; the Pallas kernel it replaces runs in interpret mode,
as ``tests/test_pallas.py`` runs it. Tolerance 1e-5 abs everywhere: the
same float32 products summed over at most 32 channels in another order
(inputs of order 1).
"""

from unittest import mock

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

import c2m_tpu.ops.pallas.correlation_kernel as jax_kernel
from c2m_tpu.ops import correlation as jax_corr
from c2m_tpu.ops import warp as jax_warp
from c2m_tpu_torch.ops import correlation as port_corr
from c2m_tpu_torch.ops import warp as port_warp
from c2m_tpu_torch.ops.hopper import correlation_kernel

TOL = 1e-5


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,md,stride", [
    ((2, 8, 12, 16), 4, 2),      # the Pallas test's own size
    ((1, 6, 8, 4), 4, 2),
    ((2, 5, 7, 3), 3, 1),        # ragged sizes, dense displacements
    ((1, 9, 11, 32), 6, 3),
    ((1, 4, 4, 8), 20, 2),       # FlowNetC's grid on a map smaller than it
])
def test_correlation_matches_jnp(shape, md, stride):
    a, b = _pair(shape, 0)
    got = port_corr.correlation(torch.from_numpy(a), torch.from_numpy(b),
                                max_displacement=md, stride=stride)
    want = np.asarray(jax_corr.correlation(jnp.asarray(a), jnp.asarray(b),
                                           max_displacement=md, stride=stride))
    d = 2 * (md // stride) + 1
    assert got.shape == (*shape[:3], d * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape,md,stride", [((2, 8, 12, 16), 4, 2),
                                             ((1, 6, 10, 8), 2, 1)])
def test_correlation_matches_pallas_interpret(shape, md, stride):
    a, b = _pair(shape, 1)
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want = np.asarray(jax_kernel.correlation_pallas(
            jnp.asarray(a), jnp.asarray(b), max_displacement=md,
            stride=stride))
    got = port_corr.correlation(torch.from_numpy(a), torch.from_numpy(b),
                                max_displacement=md, stride=stride)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_correlation_channel_order_and_zero_border():
    """Channel k = dyi * D + dxi (dx fastest); a displacement that leaves
    the image reads zeros."""
    a = torch.ones(1, 3, 3, 2)
    b = torch.zeros(1, 3, 3, 2)
    b[0, 1, 2] = 4.0                                  # one hot pixel (y=1, x=2)
    out = port_corr.correlation(a, b, max_displacement=1, stride=1)
    # pixel (1, 1) sees it at dy=0, dx=+1: channel 1 * 3 + 2
    assert out[0, 1, 1].tolist() == [0, 0, 0, 0, 0, 4.0, 0, 0, 0]
    # pixel (0, 0) cannot reach it (dx=2); pixel (2, 2) at dy=-1, dx=0
    assert float(out[0, 0, 0].abs().sum()) == 0
    assert out[0, 2, 2].tolist() == [0, 4.0, 0, 0, 0, 0, 0, 0, 0]


def test_correlation_bfloat16_accumulates_in_float32():
    a, b = _pair((1, 6, 8, 16), 2)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = port_corr.correlation(ta, tb, max_displacement=2, stride=2)
    want = port_corr.correlation(ta.float(), tb.float(), max_displacement=2,
                                 stride=2)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_correlation_rejects_a_grid_the_kernel_does_not_take():
    a = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        port_corr.correlation(a, a, max_displacement=5, stride=2)
    with pytest.raises(ValueError):
        correlation_kernel.correlation(a.to("meta"), a.to("meta"))


def test_channel_norm_matches_jnp():
    x = np.random.RandomState(3).randn(2, 5, 7, 6).astype(np.float32)
    got = port_corr.channel_norm(torch.from_numpy(x))
    want = np.asarray(jax_corr.channel_norm(jnp.asarray(x)))
    assert got.shape == (2, 5, 7, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert float(port_corr.channel_norm(torch.tensor([[[[3.0, 4.0]]]]))) == 5.0


@pytest.mark.parametrize("shape,scale", [((2, 16, 24, 3), 6.0),
                                         ((1, 9, 13, 5), 40.0)])
def test_resample_pixel_matches_jnp(shape, scale):
    """Pixel-space border warp, flows past the border included."""
    rng = np.random.RandomState(4)
    img = rng.rand(*shape).astype(np.float32)
    flow = ((rng.rand(*shape[:3], 2) - 0.5) * scale).astype(np.float32)
    got = port_warp.resample_pixel(torch.from_numpy(img),
                                   torch.from_numpy(flow))
    want = np.asarray(jax_warp.resample_pixel(jnp.asarray(img),
                                              jnp.asarray(flow)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_resample_pixel_zero_flow_is_identity():
    img = torch.rand(1, 6, 7, 2, generator=torch.Generator().manual_seed(0))
    out = port_warp.resample_pixel(img, torch.zeros(1, 6, 7, 2))
    assert torch.equal(out, img)
