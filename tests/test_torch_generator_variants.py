"""The generator's SPADE and KITTI variants against the JAX package's, on
the CPU, module by module.

Same weights (seeded numpy leaves carried by ``c2m_tpu_torch.utils.convert``)
and the same numpy inputs, float32, at the sizes of
``tests/test_generator_variants.py``: the default widths, batch 2, 32x64,
the flow non-integer noise of a few pixels. Gates, and why:

- forward: 1e-4 abs + 1e-4 rel (each module stacks convolutions whose
  float32 sums XLA and PyTorch's CPU kernels take in other orders);
- the resizes SPADE meets at odd shape pairs: 1e-5 abs (single ops);
- gradients of the generator's parameters against ``jax.grad`` in train
  mode: cos > 0.9995 and norm within 2% (train-mode BatchNorm backward
  amplifies float32 reassociation, ``tests/test_grad_parity.py``), with
  the variant's own branch receiving a non-zero gradient on both sides;
- the weight bridge: JAX -> port -> JAX gives every leaf back unchanged
  and leaves none over, for the KITTI and the SPADE tree of the model.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.config import Config
from c2m_tpu.models import generator as jg
from c2m_tpu.ops import warp as jwarp
from c2m_tpu_torch.models import generator as tg
from c2m_tpu_torch.ops import warp as twarp
from c2m_tpu_torch.utils.convert import (convert_with_report, flatten,
                                         module_state_from_jax,
                                         module_state_to_jax,
                                         to_jax_variables)
from tests.torch_port_fixtures import (LEVEL0, make_batch, port_cfg,
                                       random_jax_variables, random_leaves,
                                       tiny_cfg)

ATOL = RTOL = 1e-4
B, H, W = 2, 32, 64


def _close(got, want, msg="", atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _carry(jmod, tmod, *inputs, seed=3, **kwargs):
    """Random JAX variables for ``jmod`` on ``inputs`` and the port module
    holding the same weights."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs], **kwargs))
    variables = random_leaves(shapes, seed=seed)
    tmod.load_state_dict(module_state_from_jax(tmod, variables))
    return variables


def _inputs(seed=0, c=3):
    rng = np.random.RandomState(seed)
    frame = rng.rand(B, H, W, c).astype(np.float32)
    flow = (2.0 * rng.randn(B, H, W, 2)).astype(np.float32)
    occ = rng.rand(B, H, W, 1).astype(np.float32)
    return frame, flow, occ


# -- the resizes at the shape pairs SPADE meets ------------------------------

@pytest.mark.parametrize("src,dst", [((8, 16), (8, 16)), ((4, 8), (8, 16)),
                                     ((5, 7), (8, 16)), ((8, 16), (5, 7)),
                                     ((7, 13), (14, 26)), ((3, 5), (32, 64)),
                                     ((33, 65), (16, 32))])
def test_resizes_at_odd_shape_pairs(src, dst):
    """Bilinear (align_corners=False; a feature map to its condition's
    scale, the 2x after each SPADE block) and nearest (a condition to its
    feature map's scale), upsampling and downsampling, odd sizes."""
    x = np.random.RandomState(5).randn(2, *src, 3).astype(np.float32)
    _close(twarp.resize_bilinear(torch.as_tensor(x), dst),
           jwarp.resize_bilinear(jnp.asarray(x), dst), f"bilinear {src}->{dst}",
           atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        twarp.resize_nearest(torch.as_tensor(x), dst).numpy(),
        np.asarray(jwarp.resize_nearest(jnp.asarray(x), dst)))


# -- SPADE's modules ----------------------------------------------------------

def test_flow_embedder():
    """Every map in train mode, with the finest up block's running
    statistics; in eval mode the maps the generator reads, the finest
    (which it does not read) left out."""
    cfg = Config()
    fp = cfg.model_params.flow_embedder
    frame, flow, occ = _inputs()
    x = np.concatenate([frame, flow, occ], axis=-1)
    jm = jg.FlowEmbedder(fp)
    tm = tg.FlowEmbedder(port_cfg(cfg).model_params.flow_embedder, 6)
    variables = _carry(jm, tm, x, train=False)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False),
                   compiler_options=LEVEL0)(variables, jnp.asarray(x))
    got = tm.eval()(torch.as_tensor(x))
    assert len(got) == len(want) == fp.num_down_blocks + 1
    assert got[0] is None
    for i, (g, w) in enumerate(zip(got[1:], want[1:]), 1):
        assert tuple(g.shape) == w.shape, i
        _close(g.detach(), w, f"eval map {i}")

    want, moved = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"]),
        compiler_options=LEVEL0)(variables, jnp.asarray(x))
    got = tm.train()(torch.as_tensor(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        _close(g.detach(), w, f"train map {i}")
    stats = module_state_to_jax(tm, tm.state_dict())["batch_stats"]["up_0"]
    for leaf, w in flatten(moved["batch_stats"]["up_0"]).items():
        _close(flatten(stats)[leaf], w, f"up_0 {leaf}")


@pytest.mark.parametrize("cond_hw", [(8, 16), (32, 64), (5, 7)],
                         ids=["equal", "finer", "odd"])
def test_spatially_adaptive_norm(cond_hw):
    """The condition at x's size, finer (nearest down) and at an odd
    coarser size (nearest up)."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, 8, 16, 24).astype(np.float32)
    cond = rng.randn(B, *cond_hw, 12).astype(np.float32)
    jm = jg.SpatiallyAdaptiveNorm()
    tm = tg.SpatiallyAdaptiveNorm(24, 12)
    variables = _carry(jm, tm, x, cond)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    _close(tm(torch.as_tensor(x), torch.as_tensor(cond)).detach(), want)


@pytest.mark.parametrize("features", [24, 16], ids=["same_width",
                                                   "norm_s_conv_s"])
def test_residual_spade_block(features):
    rng = np.random.RandomState(2)
    x = rng.randn(B, 8, 16, 24).astype(np.float32)
    cond = rng.randn(B, 8, 16, 12).astype(np.float32)
    jm = jg.ResidualSpadeBlock(features)
    tm = tg.ResidualSpadeBlock(24, features, 12)
    variables = _carry(jm, tm, x, cond)
    assert ("conv_s" in variables["params"]) == (features != 24)
    assert "bias" not in variables["params"].get("conv_s", {"Conv_0": {}})[
        "Conv_0"]
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    _close(tm(torch.as_tensor(x), torch.as_tensor(cond)).detach(), want)


# -- the whole generator, per variant -----------------------------------------

VARIANTS = {"spade": (True, "cityscapes", "flowembedder"),
            "kitti": (False, "kitti", "first_warped")}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def generator_pair(request):
    use_spade, dataset, branch = VARIANTS[request.param]
    cfg = Config()
    cfg.model_params.generator.use_spade = use_spade
    pcfg = port_cfg(cfg)
    frame, flow, occ = _inputs(seed=4)
    jm = jg.OcclusionAwareGenerator(cfg.model_params.generator,
                                    cfg.model_params.flow_embedder,
                                    dataset=dataset)
    tm = tg.OcclusionAwareGenerator(pcfg.model_params.generator,
                                    pcfg.model_params.flow_embedder,
                                    dataset=dataset)
    variables = _carry(jm, tm, frame, flow, occ, seed=6, train=False)
    return dict(name=request.param, branch=branch, jm=jm, tm=tm,
                variables=variables, inputs=(frame, flow, occ))


def test_generator_forward(generator_pair):
    jm, tm, variables = (generator_pair[k] for k in ("jm", "tm", "variables"))
    frame, flow, occ = generator_pair["inputs"]
    branch = generator_pair["branch"]
    assert branch in variables["params"]
    if generator_pair["name"] == "kitti":
        assert {"pre_decode", "down_warped_0"} <= set(variables["params"])
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False),
                   compiler_options=LEVEL0)(
        variables, *map(jnp.asarray, (frame, flow, occ)))
    with torch.no_grad():
        got = tm.eval()(*map(torch.as_tensor, (frame, flow, occ)))
    assert tuple(got.shape) == want.shape == (B, H, W, 3)
    _close(got, want, generator_pair["name"])


def test_generator_gradients(generator_pair):
    """Train mode, loss mean(out²): the gradient of every parameter, as one
    vector in the JAX layout, against ``jax.grad``."""
    jm, tm, variables = (generator_pair[k] for k in ("jm", "tm", "variables"))
    frame, flow, occ = generator_pair["inputs"]

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *map(jnp.asarray, (frame, flow, occ)), train=True,
                          mutable=["batch_stats"])
        return jnp.mean(jnp.square(out))

    jgrads = jax.jit(jax.grad(loss), compiler_options=LEVEL0)(
        variables["params"])
    tm.train().zero_grad()
    out = tm(*map(torch.as_tensor, (frame, flow, occ)))
    out.square().mean().backward()
    sd = {k: torch.zeros_like(v) for k, v in tm.state_dict().items()}
    # the embedder's finest map conditions no block: no gradient reaches
    # up_0 there (zero on the JAX side)
    sd.update({n: p.grad for n, p in tm.named_parameters()
               if p.grad is not None})
    got = flatten({"params": module_state_to_jax(tm, sd)["params"]})
    want = flatten({"params": jgrads})
    assert set(got) == set(want)
    keys = sorted(want)
    g = np.concatenate([np.ravel(got[k]) for k in keys])
    w = np.concatenate([np.ravel(np.asarray(want[k])) for k in keys])
    cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
    assert cos > 0.9995, cos
    assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) < 0.02
    branches = [generator_pair["branch"]]
    if generator_pair["name"] == "kitti":
        branches.append("pre_decode")
    for branch in branches:
        for tree in (got, want):
            assert max(np.abs(np.asarray(v)).max() for k, v in tree.items()
                       if k.startswith(f"params/{branch}/")) > 0, branch


def test_generator_reads_the_image_once(generator_pair):
    """The time-folded source frame (each image twice in a row) warped
    through ``frames=2``, which reads each image once, against the copies
    warped one by one: output and flow gradient bit-equal, train mode."""
    tm = copy.deepcopy(generator_pair["tm"]).train()
    frame, flow, occ = generator_pair["inputs"]
    frame = np.repeat(frame[:1], B, axis=0)
    results = []
    for frames in (1, B):
        f = torch.as_tensor(flow).requires_grad_()
        out = tm(torch.as_tensor(frame), f, torch.as_tensor(occ), frames)
        out.square().mean().backward()
        results.append((out.detach(), f.grad))
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- the weight bridge for the variant trees -----------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_round_trip(variant):
    """The JAX C2MGenerator tree of each variant: every leaf consumed once,
    every port tensor filled, and back to JAX unchanged."""
    cfg = tiny_cfg()
    if variant == "kitti":
        cfg.dataset_params.dataset = "kitti"
    else:
        cfg.model_params.generator.use_spade = True
    variables = random_jax_variables(cfg, make_batch(cfg, seed=0), seed=1)
    flat = flatten(variables)
    sd, used = convert_with_report(variables, port_cfg(cfg))
    assert used == set(flat)
    assert any(k.startswith(f"params/generator/{VARIANTS[variant][2]}/")
               for k in flat)
    back = flatten(to_jax_variables(sd, port_cfg(cfg)))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
