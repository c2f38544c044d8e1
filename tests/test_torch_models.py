"""The port's layers and model modules against the JAX package's, on the CPU.

Same weights (seeded numpy leaves carried across by
c2m_tpu_torch.utils.convert) and the same numpy inputs, float32. Tolerance
1e-4 abs: each module stacks several convolutions whose float32 sums XLA
and PyTorch's CPU kernels take in different orders (single ops hold 1e-5,
tests/test_torch_ops.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.models.c2m import C2MGenerator as JaxC2M
from c2m_tpu.nn import layers as jl
from c2m_tpu_torch.nn import layers as tl
from c2m_tpu_torch.utils.convert import module_state_from_jax
from tests.torch_port_fixtures import (LEVEL0, make_batch, port_model,
                                       random_jax_variables, random_leaves,
                                       tiny_cfg, to_jax, to_torch)

ATOL = 1e-4
# relative part: the encoder input carries raw instance ids (~1e4) into the
# first conv, so float32 sums there are exact only to ~1e-5 relative
RTOL = 1e-4


def _close(got, want, atol=ATOL, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


# (flax module, port module, input shape): reflect padding with the edge
# fallback (2x3 maps), strided 3D convs (kt-major kernel layout), blocks
LAYERS = [
    ("conv_reflect_tiny", lambda: jl.Conv(6, 3, 1, 1, "reflect"),
     lambda: tl.Conv(4, 6, 3, 1, 1, "reflect"), (2, 2, 3, 4)),
    ("conv_strided_zeros", lambda: jl.Conv(5, 4, 2, 1, "zeros"),
     lambda: tl.Conv(3, 5, 4, 2, 1, "zeros"), (2, 9, 12, 3)),
    ("conv3d", lambda: jl.Conv3d(5, (3, 4, 4), (1, 2, 2), 1, "reflect"),
     lambda: tl.Conv3d(3, 5, (3, 4, 4), (1, 2, 2), 1, "reflect"),
     (2, 5, 8, 12, 3)),
    ("conv3d_short_time", lambda: jl.Conv3d(4, 3, 1, 1, "reflect"),
     lambda: tl.Conv3d(2, 4, 3, 1, 1, "reflect"), (1, 1, 6, 8, 2)),
    ("down3d", lambda: jl.DownBlock3d(4), lambda: tl.DownBlock3d(3, 4),
     (2, 3, 6, 8, 3)),
    ("up2d", lambda: jl.UpBlock2d(4, padding_mode="reflect"),
     lambda: tl.UpBlock2d(3, 4, padding_mode="reflect"), (2, 5, 7, 3)),
    ("same_two_conv", lambda: jl.SameBlockTwoConv2d(6, padding_mode="reflect"),
     lambda: tl.SameBlockTwoConv2d(3, 6, padding_mode="reflect"),
     (2, 6, 8, 3)),
    ("residual", lambda: jl.ResidualBlock(4), lambda: tl.ResidualBlock(4),
     (2, 6, 8, 4)),
]


@pytest.mark.parametrize("name,jmod,tmod,shape", LAYERS,
                         ids=[row[0] for row in LAYERS])
def test_layer_matches_flax(name, jmod, tmod, shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jm = jmod()
    kwargs = {} if name.startswith(("conv", "same")) else {"train": False}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), **kwargs))
    variables = random_leaves(shapes, seed=2)
    want = jm.apply(variables, jnp.asarray(x), **kwargs)
    tm = tmod().eval()
    tm.load_state_dict(module_state_from_jax(tm, variables))
    _close(tm(torch.as_tensor(x)).detach(), want, atol=1e-5, msg=name, rtol=0)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    batch = make_batch(cfg, seed=0)
    variables = random_jax_variables(cfg, batch, seed=0)
    return cfg, batch, variables, JaxC2M(cfg), port_model(cfg, variables)


def _japply(setup, fn, *args):
    _, _, variables, jm, _ = setup
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn),
                   compiler_options=LEVEL0)(variables, *args)


@pytest.fixture(scope="module")
def appearance(setup):
    _, batch, _, _, tm = setup
    want = _japply(setup, lambda m, b: m._appearance(b, False), to_jax(batch))
    with torch.no_grad():
        got = tm._appearance(to_torch(batch))
    return got, want


def test_appearance_encoder(appearance):
    got, want = appearance
    assert set(got) == set(want)
    # the first conv's ~1e-5 relative error on activations of ~25 (raw
    # instance ids in the input) reaches the deeper levels as ~2e-4 abs
    for k in want:
        _close(got[k], want[k], atol=5e-4, msg=k)


def test_sparse_motion_estimator(setup, appearance):
    cfg, batch, _, _, tm = setup
    feat = np.asarray(appearance[1]["objects_feature"])
    click = np.zeros(batch["node_mask"].shape, np.float32)
    click[0, 0] = 1.0
    args = (batch["nodes_x"], feat, batch["targets_theta"],
            batch["node_mask"], click)
    want = _japply(setup, lambda m, *a: m.sparse_motion_estimator(
        *a, train=False), *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm.sparse_motion_estimator(*(torch.as_tensor(a) for a in args))
    thetas = np.asarray(want["thetas"])
    assert np.abs(thetas - [1, 0, 0, 0, 1, 0]).max() > 1e-3   # not identity
    np.testing.assert_array_equal(thetas[0, 0], batch["targets_theta"][0, 0])
    _close(got["thetas"], thetas, atol=1e-5)


def test_motion_code_and_sparse_encoder(setup, appearance):
    cfg, batch, _, _, tm = setup
    app = np.asarray(appearance[1]["app_encoded"])
    z = np.random.RandomState(3).randn(2, 256).astype(np.float32)
    want = _japply(setup, lambda m, zz, a: m._motion_code(zz, a),
                   jnp.asarray(z), jnp.asarray(app))
    with torch.no_grad():
        got = tm._motion_code(torch.as_tensor(z), torch.as_tensor(app))
    _close(got, want)
    sm = batch["target_bw_of"]
    want = _japply(setup, lambda m, s: m.sparse_feature_encoder(s, False),
                   jnp.asarray(sm))
    with torch.no_grad():
        got = tm.sparse_feature_encoder(torch.as_tensor(sm))
    for k in want:
        _close(got[k], want[k], msg=k)


def test_dense_motion_decoder(setup, appearance):
    cfg, batch, _, _, tm = setup
    app = {k: np.asarray(v) for k, v in appearance[1].items()}
    sm, so = batch["target_bw_of"], batch["target_bw_occ"]
    sf = {k: np.asarray(v) for k, v in _japply(
        setup, lambda m, s: m.sparse_feature_encoder(s, False),
        jnp.asarray(sm)).items()}
    z = np.random.RandomState(4).randn(
        2, 5, 1, 2, app["app_encoded"].shape[-1] + 16).astype(np.float32)
    want = _japply(setup, lambda m, a, f, s, o, zz: m.dense_generator_bw(
        a, f, s, o, zz, False), to_jax(app), to_jax(sf), jnp.asarray(sm),
        jnp.asarray(so), jnp.asarray(z))
    with torch.no_grad():
        got = tm.dense_generator_bw(to_torch(app), to_torch(sf),
                                    torch.as_tensor(sm), torch.as_tensor(so),
                                    torch.as_tensor(z))
    for k in want:
        _close(got[k], want[k], msg=k)


def test_generator(setup):
    _, batch, _, _, tm = setup
    rng = np.random.RandomState(5)
    src = batch["video"][:, 0].repeat(5, axis=0)              # [B*T, H, W, 3]
    flow = (rng.rand(*src.shape[:3], 2) * 8 - 4).astype(np.float32)
    occ = rng.rand(*src.shape[:3], 1).astype(np.float32)
    want = _japply(setup, lambda m, s, f, o: m.generator(s, f, o, False),
                   jnp.asarray(src), jnp.asarray(flow), jnp.asarray(occ))
    with torch.no_grad():
        got = tm.generator(*(torch.as_tensor(a) for a in (src, flow, occ)))
    _close(got, want)
