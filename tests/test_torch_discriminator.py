"""The port's PatchGAN discriminators against
``c2m_tpu/models/discriminator.py`` on the CPU, train and eval mode: every
feature map and the prediction map, the BatchNorm running statistics and
the spectral ``u`` after the forward. Same numpy weights and inputs,
float32, 1e-4 abs + 1e-4 rel (four conv blocks with train-mode BatchNorm).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.config import DiscriminatorParams as JaxParams
from c2m_tpu.models.discriminator import MultiScaleDiscriminator as JaxDisc
from c2m_tpu.serving import flatten_tree
from c2m_tpu_torch.config import DiscriminatorParams
from c2m_tpu_torch.models.discriminator import MultiScaleDiscriminator
from c2m_tpu_torch.utils.convert import (module_state_from_jax,
                                         module_state_to_jax)
from tests.torch_port_fixtures import random_leaves

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    x = rng.rand(3, 32, 64, 6).astype(np.float32)
    jmod = JaxDisc(JaxParams(ndf=8, num_D=2))
    key = jax.random.PRNGKey(0)
    variables = random_leaves(jax.eval_shape(
        lambda: jmod.init({"params": key}, jnp.asarray(x), train=True)), seed=1)
    tmod = MultiScaleDiscriminator(DiscriminatorParams(ndf=8, num_D=2), 6)
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    return x, jmod, variables, tmod


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(pair, train):
    x, jmod, variables, tmod = pair
    tmod = MultiScaleDiscriminator(DiscriminatorParams(ndf=8, num_D=2), 6)
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    tmod.train(train)
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=train,
                               mutable=["batch_stats", "spectral"])
    with torch.no_grad():
        got = tmod(torch.as_tensor(x))
    assert set(got) == set(want)
    for scale in range(2):
        pred = got[f"prediction_map_{scale}"]
        assert pred.dtype == torch.float32 and pred.shape == (3, 2, 4, 1)
        np.testing.assert_allclose(pred.numpy(),
                                   np.asarray(want[f"prediction_map_{scale}"]),
                                   **TOL)
        fg, fw = got[f"feature_maps_{scale}"], want[f"feature_maps_{scale}"]
        assert len(fg) == len(fw) == 4
        for a, b in zip(fg, fw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    after = flatten_tree(module_state_to_jax(tmod, tmod.state_dict()))
    new = flatten_tree({"params": variables["params"],
                        "batch_stats": mutated.get("batch_stats",
                                                   variables["batch_stats"]),
                        "spectral": mutated.get("spectral",
                                                variables["spectral"])})
    old = flatten_tree(variables)
    assert set(after) == set(new)
    for k, v in new.items():
        np.testing.assert_allclose(after[k], np.asarray(v), err_msg=k, **TOL)
    moved = [k for k in new if not np.array_equal(after[k], np.asarray(old[k]))]
    if train:          # running statistics and spectral u moved, no parameter
        assert moved and not any(k.startswith("params/") for k in moved)
        assert any(k.startswith("spectral/") for k in moved)
    else:
        assert not moved


def test_discriminator_bfloat16_compute_keeps_float32_state():
    from c2m_tpu_torch.nn.layers import use_compute_dtype
    tmod = MultiScaleDiscriminator(DiscriminatorParams(ndf=8), 3).train()
    use_compute_dtype(tmod, torch.bfloat16)
    out = tmod(torch.rand(2, 32, 32, 3))
    assert out["prediction_map_0"].dtype == torch.float32
    assert out["feature_maps_0"][0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in tmod.state_dict().values())


def test_discriminator_init_is_dcgan():
    torch.manual_seed(0)
    tmod = MultiScaleDiscriminator(DiscriminatorParams(ndf=64), 3)
    block = tmod.disc_0.down_1
    assert abs(float(block.conv.weight.std()) - 0.02) < 2e-3
    assert float(block.conv.bias.abs().max()) == 0
    assert abs(float(block.norm.weight.mean()) - 1.0) < 1e-2
    assert 0.005 < float(block.norm.weight.std()) < 0.04
