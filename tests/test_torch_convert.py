"""The weight bridge (c2m_tpu_torch/utils/convert.py) and the port's JAX-free
synthetic batches."""

import numpy as np
import pytest
import torch

from c2m_tpu.data import synthetic as jax_synthetic
from c2m_tpu.serving import flatten_tree
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.utils.convert import (convert_with_report,
                                         from_jax_variables)
from tests.torch_port_fixtures import (make_batch, port_cfg,
                                       random_jax_variables, tiny_cfg)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    batch = make_batch(cfg, seed=0)
    return port_cfg(cfg), random_jax_variables(cfg, batch, seed=3)


def test_every_leaf_consumed_once_and_every_tensor_filled(setup):
    cfg, variables = setup
    sd, used = convert_with_report(variables, cfg)
    flat = set(flatten_tree(variables))
    assert any(k.split("/")[1] == "motion_encoder_bg" for k in used)
    assert used == flat                    # the VAE encoders included
    model = C2MGenerator(cfg)
    want = model.state_dict()
    assert set(sd) == set(want)
    # the consumed JAX values fill the port exactly: element counts agree
    model.load_state_dict(sd)
    n_port = sum(t.numel() for t in want.values())
    n_jax = sum(np.asarray(v).size for k, v in flatten_tree(variables).items()
                if k in used)
    assert n_port == n_jax


def test_converted_values_and_layouts(setup):
    cfg, variables = setup
    sd = from_jax_variables(variables, cfg)
    p, s = variables["params"], variables["batch_stats"]
    k = p["generator"]["down_0"]["Conv_0"]["Conv_0"]["kernel"]   # [kh,kw,C,F]
    assert torch.equal(sd["generator.down_0.conv.weight"],
                       torch.as_tensor(k).permute(3, 2, 0, 1))
    k3 = p["sparse_feature_encoder"]["down_1"]["Conv3d_0"]["Conv_0"]["kernel"]
    w3 = sd["sparse_feature_encoder.down_1.conv.weight"]       # [F,C,kt,kh,kw]
    f, c, kt, kh, kw = w3.shape
    for t in range(kt):                 # kt-major taps in the JAX channels
        assert torch.equal(w3[:, :, t], torch.as_tensor(
            k3[:, :, t * c:(t + 1) * c, :]).permute(3, 2, 0, 1))
    d = p["fc"]["Dense_0"]["kernel"]
    assert torch.equal(sd["fc.weight"], torch.as_tensor(d).t())
    bn = s["generator"]["middle_0"]["BatchNorm_1"]["BatchNorm_0"]
    assert torch.equal(sd["generator.middle_0.norm2.running_var"],
                       torch.as_tensor(bn["var"]))
    assert torch.equal(
        sd["sparse_motion_estimator.scene_bn1.running_mean"],
        torch.as_tensor(s["sparse_motion_estimator"]["scene_bn1"]["mean"]))


def test_missing_or_extra_leaves_raise(setup):
    cfg, variables = setup
    flat = flatten_tree(variables)
    missing = dict(flat)
    del missing["params/zconv/Conv_1/Conv_0/bias"]
    with pytest.raises(KeyError):
        from_jax_variables(missing, cfg)
    extra = dict(flat)
    extra["params/zconv/Conv_2/Conv_0/bias"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        from_jax_variables(extra, cfg)


@pytest.mark.parametrize("seed,num_objects", [(0, None), (5, 4)])
def test_make_batch_equals_jax(seed, num_objects):
    """The port's make_batch (port rasterizer) == the JAX one (JAX
    rasterizer) on the CPU: same numpy scenes, same flows."""
    cfg = tiny_cfg(batch_size=2)
    got = make_batch(cfg, seed=seed, num_objects=num_objects)
    want = jax_synthetic.make_batch(cfg, seed=seed, num_objects=num_objects)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        # flows: float32 rounding of the affine flow, scaled by (W-1)/2
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * 64, rtol=0,
                                   err_msg=k)
