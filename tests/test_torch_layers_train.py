"""Train-mode layers of the port against the JAX package's, on the CPU:
BatchNorm (batch statistics and running-stat updates, which take the BIASED
variance as flax does), MaskedBatchNorm1d (masked statistics, UNBIASED
running variance) and SpectralNormConv (one power iteration per training
forward, ``u`` after one and two forwards). Same numpy weights and inputs,
float32; 1e-5 abs: single layers (a conv's float32 sum of <= 100 terms).
Gradients through the train-mode norms: 1e-4 relative to the largest.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.models.sparse_motion import (MaskedBatchNorm1d as JaxMaskedBN,
                                          sample_click_indices as jax_click)
from c2m_tpu.nn import layers as jl
from c2m_tpu_torch.models.sparse_motion import (MaskedBatchNorm1d,
                                                sample_click_indices)
from c2m_tpu_torch.nn import layers as tl
from c2m_tpu_torch.utils.convert import (module_state_from_jax,
                                         module_state_to_jax)
from tests.torch_port_fixtures import random_leaves

ATOL = 1e-5


def _variables(jmod, *args, seed=0, **kwargs):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init({"params": key}, *args, **kwargs))
    return random_leaves(shapes, seed)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("shape", [(3, 6, 5, 7), (2, 3, 4, 5, 6)])
def test_batchnorm_train_mode_and_running_stats(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    jmod = jl.BatchNorm()
    variables = _variables(jmod, jnp.asarray(x), train=True, seed=2)
    tmod = tl.BatchNorm(shape[-1]).train()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    for _ in range(2):                      # two forwards: the stats compound
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = tmod(torch.as_tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
        x = x * 1.5 - 0.2
    back = _flat(module_state_to_jax(tmod, tmod.state_dict()))
    for k, v in _flat(variables).items():
        np.testing.assert_allclose(back[k], v, atol=ATOL, rtol=0, err_msg=k)
    # the running variance took the biased batch variance, as flax stores it
    n = x.size // shape[-1]
    assert n > 1
    tmod2 = tl.BatchNorm(shape[-1]).train()
    tmod2(torch.as_tensor(x))
    biased = x.reshape(-1, shape[-1]).var(axis=0)
    np.testing.assert_allclose(tmod2.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-4)
    # eval mode reads the running statistics and leaves them alone
    tmod.eval()
    before = tmod.running_mean.clone()
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(tmod(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(tmod.running_mean, before)


def test_batchnorm_train_mode_gradient():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 5, 6, 3).astype(np.float32)
    gout = rng.randn(4, 5, 6, 3).astype(np.float32)
    jmod = jl.BatchNorm()
    variables = _variables(jmod, jnp.asarray(x), train=True, seed=3)

    def jloss(xx):
        y, _ = jmod.apply(variables, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * gout)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tmod = tl.BatchNorm(3).train()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    tx = torch.tensor(x, requires_grad=True)
    (tmod(tx) * torch.as_tensor(gout)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_masked_batchnorm1d_train_mode():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 8).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0], [1, 1, 1, 1, 1]], bool)
    jmod = JaxMaskedBN()
    variables = _variables(jmod, jnp.asarray(x), jnp.asarray(mask), train=True,
                           seed=4)
    tmod = MaskedBatchNorm1d(8).train()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    want, mutated = jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                               train=True, mutable=["batch_stats"])
    got = tmod(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    stats = _flat(mutated["batch_stats"])
    np.testing.assert_allclose(tmod.running_mean.numpy(), stats["mean"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tmod.running_var.numpy(), stats["var"],
                               atol=ATOL, rtol=0)
    # unbiased running variance: n/(n-1) of the masked batch variance
    valid = x[mask]
    np.testing.assert_allclose(
        tmod.running_var.numpy(),
        0.9 * np.asarray(variables["batch_stats"]["var"])
        + 0.1 * valid.var(axis=0, ddof=1), rtol=1e-4)
    # no valid node at all: the count is floored at 1, nothing is NaN
    none = torch.zeros(3, 5, dtype=torch.bool)
    assert torch.isfinite(tmod(torch.as_tensor(x), none)).all()
    assert torch.isfinite(tmod.running_var).all()


def test_spectral_norm_conv_power_iteration():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 5, 12).astype(np.float32)
    jmod = jl.SpectralNormConv(4, kernel_size=1)
    variables = _variables(jmod, jnp.asarray(x), train=True, seed=6)
    tmod = tl.SpectralNormConv(12, 4, kernel_size=1).train()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    u0 = tmod.u.clone()
    for n_forward in (1, 2):
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["spectral"])
        variables = {"params": variables["params"], **mutated}
        got = tmod(torch.as_tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=str(n_forward))
        np.testing.assert_allclose(tmod.u.numpy(),
                                   np.asarray(variables["spectral"]["u"]),
                                   atol=ATOL, rtol=0, err_msg=str(n_forward))
    assert not torch.equal(tmod.u, u0) and not tmod.u.requires_grad
    # eval: v recomputed from the stored u, u untouched
    tmod.eval()
    u1 = tmod.u.clone()
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(tmod(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(tmod.u, u1)


def test_spectral_norm_conv_gradient_treats_u_v_as_constants():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    gout = rng.randn(2, 4, 4, 3).astype(np.float32)
    jmod = jl.SpectralNormConv(3, kernel_size=1)
    variables = _variables(jmod, jnp.asarray(x), train=True, seed=8)

    def jloss(params):
        y, _ = jmod.apply({"params": params, "spectral": variables["spectral"]},
                          jnp.asarray(x), train=True, mutable=["spectral"])
        return jnp.sum(y * gout)

    want = jax.grad(jloss)(variables["params"])
    tmod = tl.SpectralNormConv(6, 3, kernel_size=1).train()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    (tmod(torch.as_tensor(x)) * torch.as_tensor(gout)).sum().backward()
    grads = {"weight": tmod.weight.grad, "bias": tmod.bias.grad,
             "u": torch.zeros_like(tmod.u)}
    back = module_state_to_jax(tmod, grads)["params"]
    for k in ("kernel", "bias"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(back[k], w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=k)


def test_compute_dtype_casts_at_use_and_keeps_float32_parameters():
    conv = tl.Conv(3, 4, 3, 1, 1, "reflect")
    tl.use_compute_dtype(conv, torch.bfloat16)
    x = torch.rand(1, 5, 5, 3)
    y = conv(x)
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    want = torch.nn.functional.conv2d(
        tl.pad_spatial(x, [(1, 1), (1, 1)], "reflect").bfloat16().permute(0, 3, 1, 2),
        conv.weight.bfloat16(), conv.bias.bfloat16()).permute(0, 2, 3, 1)
    assert torch.equal(y, want)
    tl.use_compute_dtype(conv, torch.float32)
    assert conv(x).dtype == torch.float32


def test_sample_click_indices_matches_jax_formula(monkeypatch):
    """Fed the same uniforms, the port picks the JAX package's nodes; with
    its own generator it picks one real node per graph."""
    num_real = np.array([3, 1, 0, 4], np.int32)
    idx, mask = sample_click_indices(torch.as_tensor(num_real), 4,
                                     torch.Generator().manual_seed(0))
    assert mask.shape == (4, 4) and mask.dtype == torch.float32
    assert mask.sum(dim=1).tolist() == [1, 1, 0, 1]
    assert all(int(i) < max(int(n), 1) for i, n in zip(idx, num_real))
    key = jax.random.PRNGKey(3)
    uni = np.asarray(jax.random.uniform(key, (4,)))
    _, jmask = jax_click(key, jnp.asarray(num_real), 4)

    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(uni))
    _, tmask = sample_click_indices(torch.as_tensor(num_real), 4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
