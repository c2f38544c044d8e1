"""The port's VGG19 feature extractor against ``c2m_tpu/nn/vgg.py`` on the
CPU: every tap, float32, 1e-4 abs + 1e-4 rel (sixteen convolutions deep,
float32 sums of up to 4608 terms); frozen parameters; the npz loader.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.nn import vgg as jvgg
from c2m_tpu_torch.nn import vgg as tvgg
from c2m_tpu_torch.utils.convert import module_state_from_jax
from tests.torch_port_fixtures import random_leaves


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 32, 48, 3).astype(np.float32)
    jmod = jvgg.Vgg19Features()
    key = jax.random.PRNGKey(0)
    variables = random_leaves(jax.eval_shape(
        lambda: jmod.init({"params": key}, jnp.asarray(x))), seed=seed + 1)
    # He-scale the kernels so activations neither die nor blow up in depth
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v * np.sqrt(6.0) if p[-1].key == "kernel" else v, variables)
    tmod = tvgg.Vgg19Features()
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    return x, jmod, variables, tmod


def test_vgg_taps_match_jax():
    x, jmod, variables, tmod = _pair()
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.as_tensor(x))
    assert tuple(got) == tvgg.TAPS == jvgg.TAPS and set(got) == set(want)
    for k in tvgg.TAPS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert np.abs(w).max() > 1e-3, k                    # not a dead tap
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_vgg_normalizes_inside_and_is_frozen():
    x, _, _, tmod = _pair()
    assert all(not p.requires_grad for p in tmod.parameters())
    bare = tvgg.Vgg19Features(normalize=False)
    bare.load_state_dict(tmod.state_dict())
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    with torch.no_grad():
        a = tmod(torch.as_tensor(x))["relu1_1"]
        b = bare(torch.as_tensor((x - mean) / std))["relu1_1"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # gradient reaches the input (the generated frames), not the weights
    tx = torch.tensor(x, requires_grad=True)
    tmod(tx)["relu3_1"].sum().backward()
    assert tx.grad is not None and tx.grad.abs().sum() > 0
    assert all(p.grad is None for p in tmod.parameters())


def test_load_vgg19_params_reads_the_converted_npz(tmp_path, monkeypatch):
    x, jmod, variables, tmod = _pair(seed=3)
    arrays = {}
    for name, leaf in variables["params"].items():
        arrays[f"{name}.kernel"] = np.asarray(leaf["Conv_0"]["kernel"])
        arrays[f"{name}.bias"] = np.asarray(leaf["Conv_0"]["bias"])
    path = tmp_path / "vgg19.npz"
    np.savez(path, **arrays)
    state = tvgg.load_vgg19_params(str(path))
    want = tmod.state_dict()
    assert set(state) == set(want)
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k].numpy(), k)
    # the same file through the JAX package's loader gives the same taps
    jparams = jvgg.load_vgg19_params(str(path))
    fresh = tvgg.Vgg19Features()
    fresh.load_state_dict(state)
    with torch.no_grad():
        got = fresh(torch.as_tensor(x))["relu2_1"].numpy()
    np.testing.assert_allclose(
        got, np.asarray(jmod.apply(jparams, jnp.asarray(x))["relu2_1"]),
        atol=1e-4, rtol=1e-4)
    monkeypatch.delenv("VGG19_WEIGHTS", raising=False)
    assert tvgg.load_vgg19_params() is None
    assert tvgg.load_vgg19_params(str(tmp_path / "absent.npz")) is None
