"""Shared body of the variant slice tests (``tests/test_torch_slice_kitti.py``,
``tests/test_torch_slice_spade.py``): the KITTI or the SPADE model at
``tiny_config`` with ``shrink_model``, float32, batch 2, in both packages
with the same numpy weights and inputs.

- ``C2MGenerator.inference``, GT thetas: ``generated`` under the structural
  gate of ``tests/test_c2m_converter.py`` (max |d| < 1e-2 and a share of
  pixels off by more than 1e-3 below 0.05). Both variants warp the
  full-resolution image by the dense flow, whose float32 differences flip
  bilinear ``floor()`` at near-integer sample positions, and InstanceNorm
  (every SPADE norm, the KITTI branch's encoder) spreads a flipped pixel
  over its whole map.
- One train step of the JAX package's (``tests/test_torch_train_step._jax_step``:
  ``make_train_step``'s body, which also returns the gradient) against the
  port's ``make_train_step`` with the same draws, under the train-step
  gates of ``tests/test_torch_train_step.py`` (ROADMAP section C), which
  hold for both variants.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.serving import flatten_tree
from c2m_tpu.train.model import C2MTrainModel as JaxTrainModel
from c2m_tpu.train.state import (TrainState as JaxTrainState, build_optimizer,
                                 param_labels)
from c2m_tpu_torch.train.model import C2MTrainModel
from c2m_tpu_torch.train.state import GROUPS, create_train_state
from c2m_tpu_torch.train.step import combined_loss, make_train_step
from c2m_tpu_torch.utils.convert import from_jax_variables, to_jax_variables
from tests.test_torch_train_step import _jax_draws, _jax_step
from tests.torch_port_fixtures import (make_batch, port_cfg, random_leaves,
                                       tiny_cfg, to_jax, to_torch)

ATOL = RTOL = 1e-4
# the variant's own parameters: each must receive a gradient
BRANCHES = {"kitti": ("first_warped", "down_warped_0", "pre_decode"),
            "spade": ("flowembedder", "up_0")}


def variant_cfg(variant: str):
    cfg = tiny_cfg()
    if variant == "kitti":
        cfg.dataset_params.dataset = "kitti"
    else:
        cfg.model_params.generator.use_spade = True
    return cfg


def run(variant: str):
    """Both packages' inference and one train step of ``variant``."""
    cfg = variant_cfg(variant)
    pcfg = port_cfg(cfg)
    batch = make_batch(cfg, seed=0)
    jmodel = JaxTrainModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "sample": key}, to_jax(batch), train=True))
    variables = random_leaves(shapes, seed=4)

    # inference, GT thetas, eval mode
    rng = np.random.RandomState(2)
    z = rng.randn(2, 2 * cfg.model_params.motion_estimator
                  .dense_motion_encoder.out_channel_bg).astype(np.float32)
    click = np.zeros((2, cfg.dataset_params.max_objects), np.float32)
    click[:, 1] = 1.0
    want_inf = jax.jit(lambda v, b, zz, c: jmodel.apply(
        v, b, zz, c, True, method="inference"))(
        variables, to_jax(batch), jnp.asarray(z), jnp.asarray(click))
    probe = C2MTrainModel(pcfg)
    probe.load_state_dict(from_jax_variables(variables, pcfg))
    with torch.inference_mode():
        got_inf = probe.eval().inference(to_torch(batch), torch.as_tensor(z),
                                         torch.as_tensor(click), True)

    # one train step
    tx = build_optimizer(cfg)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], spectral=variables["spectral"],
        apply_fn=jmodel.apply, tx=tx)
    rng = jax.random.PRNGKey(7)
    new_state, jmetrics, jgrads, mu, _ = _jax_step(cfg, jmodel)(
        state, to_jax(batch), rng)
    eps, click_mask = _jax_draws(jmodel, variables, jax.random.fold_in(rng, 0),
                                 mu.shape, batch["num_real_nodes"],
                                 cfg.dataset_params.max_objects)
    tstate = create_train_state(pcfg, seed=0, device="cpu")
    tstate.model.load_state_dict(from_jax_variables(variables, pcfg))
    tbatch = to_torch(batch)
    probe.train()
    _, ld, ldi, ldv = probe(tbatch, torch.as_tensor(eps),
                            torch.as_tensor(click_mask))
    combined_loss(pcfg, ld, ldi, ldv)[0].backward()
    tgrads = {n: p.grad for n, p in probe.named_parameters()}
    tmetrics = make_train_step(pcfg)(tstate, tbatch, torch.as_tensor(eps),
                                     torch.as_tensor(click_mask))
    return dict(variant=variant, pcfg=pcfg, variables=variables,
                want_inf=want_inf, got_inf=got_inf, new_state=new_state,
                jmetrics=jmetrics, jgrads=jgrads, tstate=tstate,
                tmetrics=tmetrics, tgrads=tgrads, probe=probe)


def check_inference(r):
    want = np.asarray(r["want_inf"]["generated"], np.float32)
    got = r["got_inf"]["generated"].float().numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < 1e-2 and (d > 1e-3).mean() < 0.05, (
        d.max(), (d > 1e-3).mean())
    for k in ("dense_motion_bw", "occlusion_bw"):
        np.testing.assert_allclose(r["got_inf"][k].float().numpy(),
                                   np.asarray(r["want_inf"][k]), atol=1e-3,
                                   rtol=1e-4, err_msg=k)


def check_metrics(r):
    jm, tm = r["jmetrics"], r["tmetrics"]
    assert set(tm) == set(jm)
    for k in sorted(jm):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def _grad_trees(r):
    sd = {k: torch.zeros_like(v) for k, v in r["probe"].state_dict().items()}
    sd.update({n: g for n, g in r["tgrads"].items() if g is not None})
    got = flatten_tree({"params": to_jax_variables(sd, r["pcfg"])["params"]})
    want = flatten_tree({"params": r["jgrads"]})
    return got, want


def check_gradients(r, group):
    got, want = _grad_trees(r)
    labels = flatten_tree({"params": param_labels(r["variables"]["params"])})
    keys = sorted(k for k, lab in labels.items() if lab == group)
    g = np.concatenate([np.ravel(got[k]) for k in keys])
    w = np.concatenate([np.ravel(np.asarray(want[k])) for k in keys])
    ng, nw = np.linalg.norm(g), np.linalg.norm(w)
    assert nw > 0 and ng > 0
    cos = float(g @ w / (ng * nw))
    assert cos > 0.9995, (group, cos)
    assert 0.98 < ng / nw < 1.02, (group, ng / nw)


def check_branch_gradients(r):
    got, want = _grad_trees(r)
    for branch in BRANCHES[r["variant"]]:
        prefix = f"params/c2m/generator/{branch}/"
        for tree in (got, want):
            norms = [np.abs(np.asarray(v)).max() for k, v in tree.items()
                     if k.startswith(prefix)]
            assert norms and max(norms) > 0, branch


def check_state_after_step(r):
    """The train-step test's gate: statistics and spectral ``u`` 1e-4; per
    group fewer than 2% of the weights off by more than 5% of Adam's first
    step (~lr)."""
    pcfg, tstate = r["pcfg"], r["tstate"]
    assert tstate.step == 1
    got = flatten_tree(to_jax_variables(tstate.model.state_dict(), pcfg))
    new = r["new_state"]
    want = flatten_tree({"params": new.params, "batch_stats": new.batch_stats,
                         "spectral": new.spectral})
    assert set(got) == set(want)
    labels = flatten_tree({"params": param_labels(r["variables"]["params"])})
    tp = pcfg.train_params
    lr = {"gen": tp.lr_rate_g, "gnn": tp.lr_rate_gnn, "d_image": tp.lr_rate_d,
          "d_video": tp.lr_rate_d}
    off = {g: [0, 0] for g in GROUPS}
    for k in sorted(want):
        w = np.asarray(want[k])
        if not k.startswith("params/"):
            np.testing.assert_allclose(got[k], w, atol=ATOL, rtol=RTOL,
                                       err_msg=k)
            continue
        group = str(labels[k])
        if group == "frozen":
            continue
        bad = np.abs(got[k] - w) > 0.05 * lr[group]
        off[group][0] += int(bad.sum())
        off[group][1] += bad.size
    for group, (n_bad, n) in off.items():
        assert n_bad / n < 0.02, (group, n_bad, n)
