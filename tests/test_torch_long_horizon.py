"""The long-horizon configuration (``configs/c2m_long_horizon.yaml``:
512x1024, 1 + 10 frames, 24 object nodes) in the port, on the CPU.

The YAML loads into the port's config as into the JAX package's. A model of
its shape at a small size (width-shrunk, 10 predicted frames, 24 nodes, all
real, the map pushed above the rasterizer's size rule so that K3's route is
the one taken) matches ``c2m_tpu`` in sampled inference and in the metrics
of one train step, with the gates of the 5-frame tests:
- inference: ``generated`` 5e-4 abs (float32 conv stacks in two
  frameworks), thetas 1e-5, the winner map identical up to 1e-4 of the
  pixels;
- train step: every metric 1e-4 abs + 1e-4 rel.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.config import Config as JaxConfig
from c2m_tpu.config import shrink_model, tiny_config
from c2m_tpu.models.c2m import C2MGenerator as JaxGenerator
from c2m_tpu.train.model import C2MTrainModel as JaxTrainModel
from c2m_tpu.train.state import TrainState as JaxTrainState, build_optimizer
from c2m_tpu_torch.config import load_config
from c2m_tpu_torch.ops import raster
from c2m_tpu_torch.ops.hopper import maskwarp_banded
from c2m_tpu_torch.serving import z_dim
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.train.step import make_train_step
from c2m_tpu_torch.utils.convert import from_jax_variables
from tests.test_torch_train_step import _jax_draws, _jax_step
from tests.torch_port_fixtures import (make_batch, port_cfg, port_model,
                                       random_jax_variables, random_leaves,
                                       to_jax, to_torch)

YAML = "configs/c2m_long_horizon.yaml"
H, W, FRAMES, NODES = 64, 128, 10, 24


def long_cfg(batch_size=1):
    cfg = shrink_model(tiny_config(h=H, w=W, num_predicted=FRAMES,
                                   max_objects=NODES, batch_size=batch_size))
    cfg.train_params.dtype = "float32"
    return cfg


@pytest.fixture
def banded_route(monkeypatch):
    """Push every map above the size rule and count K3's route."""
    monkeypatch.setattr(raster, "BANDED_ABOVE", 0)
    calls = []
    real = maskwarp_banded.warp_masks_winner_banded
    monkeypatch.setattr(maskwarp_banded, "warp_masks_winner_banded",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def test_yaml_loads_as_in_the_jax_package():
    cfg, jcfg = load_config(YAML), JaxConfig.from_yaml(YAML)
    tp = cfg.train_params
    assert tuple(tp.input_size) == (512, 1024)
    assert (tp.num_input_frames, tp.num_predicted_frames) == (1, 10)
    assert cfg.dataset_params.max_objects == 24 and tp.dtype == "bfloat16"
    assert tuple(cfg.test_params.input_size) == (512, 1024)
    # the JAX package's memory and layout keys are read and carried
    assert tp.remat and tp.remat_segments == "dense_bw,dense_fw,generator"
    assert tp.scan_frames == 2 and tp.s2d_tail
    assert cfg.to_dict() == jcfg.to_dict()
    # one clip of this config is above the rasterizer's size rule
    assert raster.banded(1, 24, 10, 512, 1024)


def test_full_width_model_has_the_long_horizon_shapes():
    """The full-width generator on the meta device: the appearance fuse
    layer, the latent ``fc`` and one GNN head per predicted frame."""
    from c2m_tpu_torch.models.c2m import C2MGenerator
    cfg = load_config(YAML)
    with torch.device("meta"):
        model = C2MGenerator(cfg)
    fuse = model.appearance_encoder.fuse_appearance_roi
    assert fuse.in_features == 65664
    assert model.fc.out_features == 64 * model.h_app * model.w_app
    assert (model.h_app, model.w_app) == (8, 16)
    heads = [n for n, _ in model.sparse_motion_estimator.named_children()
             if n.startswith("loc_")]
    assert len(heads) == 10


@pytest.mark.parametrize("use_gt", [True, False])
def test_inference_matches_jax(banded_route, use_gt):
    cfg = long_cfg(batch_size=2)
    batch = make_batch(cfg, seed=5, num_objects=NODES)
    assert batch["targets_theta"].shape == (2, NODES, FRAMES, 6)
    variables = random_jax_variables(cfg, batch, seed=6)
    rng = np.random.RandomState(7)
    z = rng.randn(2, z_dim(port_cfg(cfg))).astype(np.float32)
    click = np.zeros((2, NODES), np.float32)
    click[[0, 1], [3, 17]] = 1
    # jitted: one compile of the graph, where an eager apply compiles each
    # of its operations on its own (both cases on an 8-core CPU: 28 s
    # against 80 s)
    want = jax.jit(lambda v, b, zz, c: JaxGenerator(cfg).apply(
        v, b, zz, c, use_gt_eval=use_gt, method="inference"))(
        variables, to_jax(batch), jnp.asarray(z), jnp.asarray(click))
    model = port_model(cfg, variables)
    banded_route.clear()                 # make_batch rasterized its targets
    got = model.inference(to_torch(batch), torch.from_numpy(z),
                          torch.from_numpy(click), use_gt)
    assert banded_route == [1]
    assert got["generated"].shape == (2, FRAMES, H, W, 3)
    np.testing.assert_allclose(got["thetas"].numpy(),
                               np.asarray(want["thetas"]), atol=1e-5)
    np.testing.assert_allclose(got["generated"].numpy(),
                               np.asarray(want["generated"]), atol=5e-4)
    flow = np.abs(got["dense_motion_bw"].numpy()
                  - np.asarray(want["dense_motion_bw"])).max()
    assert flow < 5e-3, flow


def test_train_step_metrics_match_jax(banded_route):
    cfg = long_cfg(batch_size=1)
    pcfg = port_cfg(cfg)
    batch = make_batch(cfg, seed=8, num_objects=NODES)
    jmodel = JaxTrainModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "sample": key}, to_jax(batch), train=True))
    variables = random_leaves(shapes, seed=9)
    tx = build_optimizer(cfg)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], spectral=variables["spectral"],
        apply_fn=jmodel.apply, tx=tx)
    rng = jax.random.PRNGKey(3)
    _, jmetrics, _, mu, jclick = _jax_step(cfg, jmodel)(state, to_jax(batch),
                                                       rng)
    eps, click = _jax_draws(jmodel, variables, jax.random.fold_in(rng, 0),
                            mu.shape, batch["num_real_nodes"], NODES)
    np.testing.assert_array_equal(click, np.asarray(jclick))

    tstate = create_train_state(pcfg, seed=0, device="cpu")
    tstate.model.load_state_dict(from_jax_variables(variables, pcfg))
    banded_route.clear()                 # make_batch rasterized its targets
    tmetrics = make_train_step(pcfg)(tstate, to_torch(batch),
                                     torch.as_tensor(eps),
                                     torch.as_tensor(click))
    assert banded_route == [1]
    assert set(tmetrics) == set(jmetrics)
    for k in sorted(jmetrics):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
