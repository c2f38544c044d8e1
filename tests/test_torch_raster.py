"""The port's rasterizer (gather form, K2's plain version) against the JAX
package's on the CPU.

Gates, each for its reason:
- half-integer displacements: winner maps IDENTICAL to every JAX path (no
  sample lies near the 1 − 1e-5 interior threshold);
- general affines: winner maps differ on <= 1e-4 of pixels (STATUS round 3
  flip class: float rounding of samples next to the threshold);
- flows and previews where the winners agree: 1e-5 x the flow scale
  ((size−1)/2 px per normalized unit).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.ops.raster import generate_sparse_motion as jraster
from c2m_tpu_torch.ops.hopper import maskwarp_kernel
from c2m_tpu_torch.ops.raster import generate_sparse_motion
from tests.torch_port_fixtures import general_raster, half_integer_raster

KEYS = ("sparse_motion_bw", "sparse_motion_fw", "sparse_motion_bin",
        "sparse_occ_bw", "sparse_occ_fw", "winner_bw")


def _port(inst, ids, mask, th):
    out = generate_sparse_motion(*(torch.as_tensor(a) for a in
                                   (inst, ids, mask, th)))
    return {k: v.numpy() for k, v in out.items()}


def _jax(inst, ids, mask, th, **kw):
    # jitted: one compile of the rasterizer, where eager JAX compiles each
    # of its operations on its own (11 s against under 1 s on 8 cores)
    out = jax.jit(functools.partial(jraster, compute_fw=True, **kw))(
        jnp.asarray(inst), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(th))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("axis_aligned", [False, True])
def test_half_integer_raster_identical(axis_aligned):
    """GT-style thetas: the port's gather form equals both the JAX gather
    path and the separable path that JAX inference takes under use_gt_eval."""
    args = half_integer_raster()
    got = _port(*args)
    want = _jax(*args, axis_aligned=axis_aligned, use_pallas=False)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["winner_bw"], want["winner_bw"])
    assert got["winner_bw"].dtype == np.int32 and got["winner_bw"].max() > 0
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * 32, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(2, 4, 3, 32, 64), (1, 16, 5, 128, 256)])
def test_general_raster_matches_gather_path(shape):
    args = general_raster(*shape)
    h, w = shape[3:]
    got = _port(*args)
    want = _jax(*args, use_pallas=False)
    same = got["winner_bw"] == want["winner_bw"]
    assert 1.0 - same.mean() <= 1e-4
    scale = 1e-5 * (max(h, w) - 1) / 2
    for k in ("sparse_motion_bw", "sparse_motion_bin"):
        np.testing.assert_allclose(got[k][same], want[k][same], atol=scale,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["sparse_motion_fw"],
                               want["sparse_motion_fw"], atol=scale, rtol=0)
    for k in ("sparse_occ_bw", "sparse_occ_fw"):
        assert np.mean(got[k] != want[k]) <= 1e-4, k


def test_winner_matches_pallas_maskwarp_interpret():
    """K2's plain winner == the winner composed from the Pallas mask-warp
    kernel it replaces (interpret mode), at the gather path's eps."""
    from unittest import mock
    from jax.experimental import pallas as pl
    import c2m_tpu.ops.pallas.maskwarp_kernel as mw
    inst, ids, mask, th = general_raster(2, 3, 2, 16, 128, seed=5)
    valid = mask & (ids != 0)
    obj = ((inst[:, None, :, :, 0] == ids[:, :, None, None])
           & valid[:, :, None, None]).astype(np.float32)
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp_call):
        warped = np.asarray(mw.warp_masks(jnp.asarray(obj), jnp.asarray(th)))
    covered = (warped >= 1.0 - maskwarp_kernel.INTERIOR_EPS) \
        & valid[:, :, None, None, None]
    rank = np.arange(1, obj.shape[1] + 1)[None, :, None, None, None]
    want = np.max(np.where(covered, rank, 0), axis=1)
    got = maskwarp_kernel.warp_masks_winner(
        torch.as_tensor(inst[..., 0]), torch.as_tensor(ids),
        torch.as_tensor(valid), torch.as_tensor(th)).numpy()
    assert np.mean(got != want) <= 1e-4


def test_invalid_and_zero_id_nodes_never_win():
    inst, ids, mask, th = half_integer_raster(seed=3)
    ids[0, 0] = 0                                    # id 0: skip
    got = _port(inst, ids, mask, th)["winner_bw"]
    assert not np.any(got[0] == 1)                   # node 0 of row 0
    assert not np.any(got == ids.shape[1])           # the padding node
