"""The port's train step against the JAX package's, on the CPU.

One step of ``c2m_tpu``'s train step (``C2MTrainModel.apply(train=True)``,
``jax.grad`` of the one combined scalar, optax's four Adam groups) and one
step of the port's ``make_train_step`` at ``tiny_config(64x128)`` with
shrunk widths, float32, batch 2: the same numpy batch, the same weights
(numpy leaves carried by ``from_jax_variables``), and the VAE noise and the
click mask of the JAX draw handed to the port.

Gates, and why:
- every key of the metrics dict: 1e-4 abs + 1e-4 rel (deep float32 conv
  stacks summed in different orders by XLA and PyTorch's CPU kernels; the
  weighted totals reach ~1e2, hence the relative part);
- gradients per optimizer group: cos > 0.9995 and norm within 2%, the gates
  of ``tests/test_grad_parity.py`` (train-mode BatchNorm backward amplifies
  float32 reassociation); a wrong detach point drops or adds a whole term
  and fails both;
- after one optimizer step: BatchNorm running statistics and the spectral
  ``u`` 1e-4 abs + 1e-4 rel (forward quantities); parameters, carried back
  by ``to_jax_variables``, per group within 5% of the step's own length in
  max norm: Adam's first step moves every weight by ~lr whatever its
  gradient's size, so where a gradient is near zero its sign, and the
  step, is noise, and the bound is on the share of such weights, not on
  each one.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from c2m_tpu.train.model import (C2MTrainModel as JaxTrainModel,
                                 total_discriminator_loss,
                                 total_generator_loss)
from c2m_tpu.train.state import (TrainState as JaxTrainState, build_optimizer,
                                 multistep_schedule, param_labels)
from c2m_tpu.serving import flatten_tree
from c2m_tpu_torch.train.model import C2MTrainModel
from c2m_tpu_torch.train.state import (GROUPS, create_train_state,
                                       multistep_factor, param_group)
from c2m_tpu_torch.train.step import (combined_loss, make_eval_step,
                                      make_train_step)
from c2m_tpu_torch.utils.convert import (convert_with_report,
                                         from_jax_variables, to_jax_variables)
from tests.torch_port_fixtures import (LEVEL0, make_batch, port_cfg,
                                       port_shapes, random_leaves, tiny_cfg,
                                       to_jax, to_torch)

ATOL = RTOL = 1e-4


def _jax_loss(cfg, state, batch, step_rng):
    """The JAX package's train objective (train/step.py) as a function of
    the parameters -> (total, (metrics, mutated collections, mu, click))."""
    def loss_fn(params):
        (out, ld, ldi, ldv), mutated = state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats,
             "spectral": state.spectral}, batch, train=True,
            rngs={"sample": step_rng},
            mutable=["batch_stats", "spectral"])
        total_gen = total_generator_loss(cfg, ld)
        total_di = total_discriminator_loss(ldi)
        total_dv = total_discriminator_loss(ldv)
        metrics = dict(ld, total_gen=total_gen, total_image_dis=total_di,
                       d_real_image=ldi["d_real"],
                       d_fake_image=ldi["d_fake"],
                       total_video_dis=total_dv,
                       d_real_video=ldv["d_real"],
                       d_fake_video=ldv["d_fake"])
        aux = (metrics, mutated, out["mu"], out["click_mask"])
        return total_gen + total_di + total_dv, aux
    return loss_fn


def _jax_step(cfg, model):
    """The JAX package's train step (train/step.py), also returning the
    gradient and the two draws of the 'sample' stream."""
    def step(state, batch, rng):
        step_rng = jax.random.fold_in(rng, state.step)
        grads, (metrics, mutated, mu, click) = jax.grad(
            _jax_loss(cfg, state, batch, step_rng), has_aux=True)(
            state.params)
        new_state = state.apply_gradients(grads).replace(
            batch_stats=mutated["batch_stats"], spectral=mutated["spectral"])
        return new_state, metrics, grads, mu, click
    return jax.jit(step, compiler_options=LEVEL0)


def _jax_metrics(cfg, model):
    """The forward half of :func:`_jax_step`: its metrics and the two draws,
    without the gradient (10 s against 47 s of compile and run at the
    long-horizon test's size, 8 cores)."""
    def metrics(state, batch, rng):
        step_rng = jax.random.fold_in(rng, state.step)
        _, (m, _, mu, click) = _jax_loss(cfg, state, batch, step_rng)(
            state.params)
        return m, mu, click
    return jax.jit(metrics, compiler_options=LEVEL0)


def _jax_draws(model, variables, step_rng, mu_shape, num_real, n_max):
    """The VAE noise and the click mask that ``C2MGenerator.__call__`` draws
    from the 'sample' stream: its first and second ``make_rng``."""
    from c2m_tpu.models.sparse_motion import sample_click_indices
    k_eps, k_click = model.apply(
        variables, rngs={"sample": step_rng},
        method=lambda m: (m.c2m.make_rng("sample"), m.c2m.make_rng("sample")))
    eps = jax.random.normal(k_eps, mu_shape, jnp.float32)
    _, click = sample_click_indices(k_click, jnp.asarray(num_real), n_max)
    return np.asarray(eps), np.asarray(click)


@pytest.fixture(scope="module")
def both():
    cfg = tiny_cfg()
    pcfg = port_cfg(cfg)
    batch = make_batch(cfg, seed=0)
    jmodel = JaxTrainModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "sample": key}, to_jax(batch), train=True))
    variables = random_leaves(shapes, seed=4)
    tx = build_optimizer(cfg)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], spectral=variables["spectral"],
        apply_fn=jmodel.apply, tx=tx)
    rng = jax.random.PRNGKey(7)
    new_state, jmetrics, jgrads, mu, jclick = _jax_step(cfg, jmodel)(
        state, to_jax(batch), rng)
    eps, click = _jax_draws(jmodel, variables, jax.random.fold_in(rng, 0),
                            mu.shape, batch["num_real_nodes"],
                            cfg.dataset_params.max_objects)
    np.testing.assert_array_equal(click, np.asarray(jclick))

    # the port: same weights, one step with the JAX draws
    tstate = create_train_state(pcfg, seed=0, device="cpu")
    tmodel = tstate.model
    tmodel.load_state_dict(from_jax_variables(variables, pcfg))
    vgg_before = {k: v.clone() for k, v in tmodel.vgg.state_dict().items()}
    tbatch = to_torch(batch)
    # a second model with the weights before the step, for the tests that
    # run their own forward
    probe = C2MTrainModel(pcfg)
    probe.load_state_dict(tmodel.state_dict())

    tmetrics = make_train_step(pcfg)(tstate, tbatch, torch.as_tensor(eps),
                                     torch.as_tensor(click))
    # the step leaves the gradient it took in each parameter's .grad
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    return dict(cfg=cfg, pcfg=pcfg, variables=variables, new_state=new_state,
                jmetrics=jmetrics, jgrads=jgrads, tstate=tstate,
                tmetrics=tmetrics, tgrads=tgrads, probe=probe,
                vgg_before=vgg_before, batch=tbatch, eps=eps, click=click,
                shapes=shapes)


def test_metrics_match(both):
    jm, tm = both["jmetrics"], both["tmetrics"]
    assert set(tm) == set(jm)
    for k in sorted(jm):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert all(np.isfinite(float(v)) for v in tm.values())


def _group_vectors(both):
    """Per optimizer group, the port's gradient carried into the JAX layout
    and the JAX gradient, as flat vectors in the same order."""
    pcfg = both["pcfg"]
    sd = {k: torch.zeros_like(v) for k, v in both["probe"].state_dict().items()}
    for name, g in both["tgrads"].items():
        if g is not None:
            sd[name] = g
    got = flatten_tree({"params": to_jax_variables(sd, pcfg)["params"]})
    want = flatten_tree({"params": both["jgrads"]})
    labels = flatten_tree({"params": param_labels(both["variables"]["params"])})
    out = {}
    for group in GROUPS + ("frozen",):
        keys = sorted(k for k, lab in labels.items() if lab == group)
        out[group] = (np.concatenate([np.ravel(got[k]) for k in keys]),
                      np.concatenate([np.ravel(np.asarray(want[k]))
                                      for k in keys]))
    return out


@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_per_group(both, group):
    got, want = _group_vectors(both)[group]
    ng, nw = np.linalg.norm(got), np.linalg.norm(want)
    assert nw > 0 and ng > 0
    cos = float(got @ want / (ng * nw))
    assert cos > 0.9995, (group, cos)
    assert 0.98 < ng / nw < 1.02, (group, ng / nw)


def test_port_groups_are_the_jax_labels(both):
    """Each port parameter falls into the group its JAX leaf is labelled
    with, and the frozen group is exactly VGG."""
    pcfg = both["pcfg"]
    names = [n for n, _ in both["probe"].named_parameters()]
    marks = {n: torch.full_like(p, float(i))
             for i, (n, p) in enumerate(both["probe"].named_parameters())}
    sd = dict(both["probe"].state_dict())
    sd.update(marks)
    flat = flatten_tree({"params": to_jax_variables(sd, pcfg)["params"]})
    labels = flatten_tree({"params": param_labels(both["variables"]["params"])})
    for path, arr in flat.items():
        name = names[int(np.ravel(arr)[0])]
        assert param_group(name) == labels[path], (name, path)
    assert {n for n in names if param_group(n) == "frozen"} == \
        {n for n in names if n.startswith("vgg.")}


def test_state_after_one_step(both):
    pcfg, tstate = both["pcfg"], both["tstate"]
    assert tstate.step == 1
    got = flatten_tree(to_jax_variables(tstate.model.state_dict(), pcfg))
    new = both["new_state"]
    want = flatten_tree({"params": new.params, "batch_stats": new.batch_stats,
                         "spectral": new.spectral})
    assert set(got) == set(want)
    old = flatten_tree(both["variables"])
    labels = flatten_tree({"params": param_labels(both["variables"]["params"])})
    tp = pcfg.train_params
    lr = {"gen": tp.lr_rate_g, "gnn": tp.lr_rate_gnn, "d_image": tp.lr_rate_d,
          "d_video": tp.lr_rate_d}
    moved = {g: False for g in GROUPS}
    off = {g: [0, 0] for g in GROUPS}
    for k in sorted(want):
        w = np.asarray(want[k])
        if not k.startswith("params/"):
            # running statistics and spectral u: forward quantities
            np.testing.assert_allclose(got[k], w, atol=ATOL, rtol=RTOL,
                                       err_msg=k)
            assert np.abs(w - old[k]).max() > 0, k        # they moved
            continue
        group = str(labels[k])
        if group == "frozen":
            np.testing.assert_array_equal(got[k], old[k], err_msg=k)
            np.testing.assert_array_equal(w, old[k], err_msg=k)
            continue
        moved[group] |= bool(np.abs(got[k] - old[k]).max() > 0)
        # no weight moves by more than Adam's first step, ~lr
        assert np.abs(got[k] - old[k]).max() <= lr[group] * 1.001, k
        bad = np.abs(got[k] - w) > 0.05 * lr[group]
        off[group][0] += int(bad.sum())
        off[group][1] += bad.size
    assert all(moved.values()), moved
    for group, (n_bad, n) in off.items():
        # weights whose gradient is float32 noise around zero step either
        # way; everywhere else the two packages take the same step
        assert n_bad / n < 0.02, (group, n_bad, n)


def test_vgg_is_frozen(both):
    after = both["tstate"].model.vgg.state_dict()
    for k, v in both["vgg_before"].items():
        assert torch.equal(after[k], v), k
    assert all(not p.requires_grad
               for p in both["tstate"].model.vgg.parameters())
    assert all(g is None for n, g in both["tgrads"].items()
               if n.startswith("vgg."))


def test_discriminators_get_the_generator_terms_gradient(both):
    """The G-GAN and feature-matching terms are not shielded from D's
    parameters: with only those terms in the scalar, D's gradient is not
    zero (reference quirk kept by the JAX package)."""
    pcfg, probe = both["pcfg"], both["probe"]
    probe.zero_grad(set_to_none=True)
    _, ld, _, _ = probe(both["batch"], torch.as_tensor(both["eps"]),
                        torch.as_tensor(both["click"]))
    (ld["g_gan_image"] + ld["feature_matching_video"]).backward()
    for prefix in ("netd_image.", "netd_video."):
        norm = sum(float(p.grad.square().sum())
                   for n, p in probe.named_parameters()
                   if n.startswith(prefix) and p.grad is not None)
        assert norm > 0, prefix


def test_port_shapes_are_the_eval_shape_tree(both):
    """``tests/torch_port_fixtures.port_shapes`` (the port's model through
    the bridge) gives the paths and shapes of ``jax.eval_shape`` of the JAX
    init, which the other parity fixtures then skip."""
    def shapes(tree):
        return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(port_shapes(both["cfg"])) == shapes(both["shapes"])


def test_converter_covers_the_train_tree(both):
    pcfg = both["pcfg"]
    sd, used = convert_with_report(both["variables"], pcfg)
    flat = flatten_tree(both["variables"])
    assert used == set(flat)
    assert any(k.startswith("spectral/netd_video/") for k in used)
    assert any(k.startswith("batch_stats/netd_image/") for k in used)
    assert any(k.startswith("params/vgg/") for k in used)
    # there and back is the identity
    back = flatten_tree(to_jax_variables(sd, pcfg))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32),
                                      err_msg=k)


def test_eval_step_updates_nothing(both):
    pcfg, tstate = both["pcfg"], both["tstate"]
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    out, losses = make_eval_step(pcfg)(tstate, both["batch"],
                                       torch.as_tensor(both["eps"]),
                                       torch.as_tensor(both["click"]))
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert out["generated"].shape == both["batch"]["video"][:, 1:].shape
    after = tstate.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert tstate.step == 1
    tstate.model.train()


@pytest.mark.parametrize("group,gamma", [("gen", 0.9), ("d_image", 0.8),
                                         ("gnn", 1.0)])
def test_multistep_lr_boundaries(group, gamma):
    """The per-step lr factor equals the JAX package's optax schedule at
    every step around every boundary (steps_per_epoch = 3)."""
    milestones, spe = [2, 4, 5], 3
    sched = multistep_schedule(1.0, gamma, milestones, spe)
    factor = multistep_factor(gamma, milestones, spe)
    for step in range(0, 20):
        assert factor(step) == pytest.approx(float(sched(step)), rel=1e-6), step


def test_scheduler_steps_each_group():
    cfg = port_cfg(tiny_cfg())
    cfg.train_params.milestone_start = 1
    cfg.train_params.milestone_end = 3
    cfg.train_params.milestone_every = 1
    state = create_train_state(cfg, seed=0, device="cpu")
    tp = cfg.train_params
    want = {"gen": (tp.lr_rate_g, tp.gamma_g), "gnn": (tp.lr_rate_gnn, tp.gamma_gnn),
            "d_image": (tp.lr_rate_d, tp.gamma_d),
            "d_video": (tp.lr_rate_d, tp.gamma_d)}
    assert [g["name"] for g in state.optimizer.param_groups] == list(GROUPS)
    for step in range(4):
        for g in state.optimizer.param_groups:
            base, gamma = want[g["name"]]
            n = sum(1 for b in (1, 2) if b <= step)
            assert g["lr"] == pytest.approx(base * gamma ** n), (step, g["name"])
        state.optimizer.step()
        state.scheduler.step()


def test_adam_matches_optax_over_two_steps():
    """torch.optim.Adam and optax.adam with the config's betas and eps take
    the same two steps from the same gradients (bias correction, eps
    outside the square root): 1e-6 abs on weights of order 1, lr 1e-2."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) * s for s in (1.0, 1e-4)]
    tx = optax.adam(1e-2, b1=0.5, b2=0.999, eps=1e-7)
    params, opt = jnp.asarray(w0), None
    opt = tx.init(params)
    w = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    adam = torch.optim.Adam([w], lr=1e-2, betas=(0.5, 0.999), eps=1e-7)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, params)
        params = optax.apply_updates(params, upd)
        w.grad = torch.as_tensor(g.copy())
        adam.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   atol=1e-6, rtol=0)


def test_training_forward_draws_from_the_generator():
    """Without eps / click_mask the forward draws both from the generator:
    the same seed gives the same losses, another seed another KL-free
    stream (the click changes the thetas)."""
    cfg = port_cfg(tiny_cfg())
    batch = to_torch(make_batch(tiny_cfg(), seed=1, num_objects=4))
    model = C2MTrainModel(cfg).eval()
    with torch.no_grad():
        a = model(batch, generator=torch.Generator().manual_seed(1))[0]
        b = model(batch, generator=torch.Generator().manual_seed(1))[0]
        c = model(batch, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a["generated"], b["generated"])
    assert torch.equal(a["click_mask"], b["click_mask"])
    assert not torch.equal(a["generated"], c["generated"])
    assert a["click_mask"].sum(dim=1).eq(1).all()
    assert (a["click_mask"] * (~batch["node_mask"]).float()).sum() == 0


def test_forward_flow_branch_trains_both_decoders():
    """``use_fw_of``: the second decoder, the forward-flow terms and the
    flow-consistency loss (each flow is image and flow of a K1 warp); the
    converter's walk reaches the second decoder too."""
    jcfg = tiny_cfg()
    jcfg.train_params.use_fw_of = True
    cfg = port_cfg(jcfg)
    cfg.train_params.loss_weights.flowcon = 1.0
    batch = to_torch(make_batch(jcfg, seed=2))
    assert "target_fw_of" in batch
    model = C2MTrainModel(cfg).train()
    out, ld, ldi, ldv = model(batch, generator=torch.Generator().manual_seed(0))
    assert {"flowcon", "occlusion_fw"} <= set(ld)
    assert out["dense_motion_fw"].shape == out["dense_motion_bw"].shape
    total, metrics = combined_loss(cfg, ld, ldi, ldv)
    assert all(torch.isfinite(v) for v in metrics.values())
    total.backward()
    for name in ("dense_generator_fw", "dense_generator_bw"):
        grads = [p.grad for p in getattr(model.c2m, name).parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        assert sum(float(g.abs().sum()) for g in grads) > 0, name
    tree = flatten_tree(to_jax_variables(model.state_dict(), cfg))
    assert any(k.startswith("params/c2m/dense_generator_fw/") for k in tree)
