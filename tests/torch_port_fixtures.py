"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs and weights, made from a seed with numpy:
the JAX variable tree's structure comes from ``jax.eval_shape`` of
``C2MGenerator.init`` (no compile), its leaves are drawn with numpy and the
port takes them through ``c2m_tpu_torch.utils.convert``. Each package gets
its own config object: ``tiny_cfg`` makes the JAX package's, ``port_cfg``
carries it into the port's dataclasses. The port runs on the CPU here.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.config import shrink_model, tiny_config
from c2m_tpu.serving import unflatten_tree
from c2m_tpu_torch import config as port_config
from c2m_tpu_torch.data import synthetic as port_synthetic


# XLA's backend optimizations off for a JAX reference: each is compiled once
# per test module and run once or twice, and on the CPU its compile is the
# larger part of its time (8 cores: the tiny_config train step 20 s against
# 33 s, the KITTI model's inference 5.8 s against 7.3 s, Panoptic-DeepLab at
# 64x128 14.4 s against 17.1 s); the outputs move by float32 rounding only,
# inside the gates
LEVEL0 = {"xla_backend_optimization_level": 0}


def share_cores():
    """Under pytest-xdist, give each worker its share of the cores for
    PyTorch's intra-op threads. Six workers that each start a thread per
    core oversubscribe the CPU, and PyTorch's CPU kernels then wait on
    threads that are not running: one port test file that takes 21 s alone
    took minutes with five other copies of it beside it. Every worker
    imports this module when it collects the suite, so the setting holds
    for the whole run."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()


def tiny_cfg(max_objects: int = 4, batch_size: int = 2):
    """The parity tests' size: 64x128, 5 predicted frames, width-shrunk."""
    cfg = shrink_model(tiny_config(h=64, w=128, num_predicted=5,
                                   max_objects=max_objects,
                                   batch_size=batch_size))
    cfg.train_params.dtype = "float32"
    return cfg


def port_cfg(cfg):
    """The port's Config with the values of a ``c2m_tpu.config.Config``."""
    return port_config.check(port_config._update_dataclass(
        port_config.Config(), cfg.to_dict()))


def make_batch(cfg, **kwargs):
    """The port's synthetic batch for a JAX-package config, on the CPU."""
    return port_synthetic.make_batch(port_cfg(cfg), device="cpu", **kwargs)


def random_jax_variables(cfg, batch, seed: int = 0):
    """A JAX C2MGenerator {'params', 'batch_stats'} tree of numpy arrays,
    every leaf drawn from ``seed``: kernels U(±1/sqrt(fan_in)), norms near
    identity, running stats away from (0, 1), and the affine heads' fc2
    given small random weights so the GNN emits general affines (at
    init they are zero, every theta the identity)."""
    from c2m_tpu.models.c2m import C2MGenerator
    model = C2MGenerator(cfg)
    key = jax.random.PRNGKey(0)
    return random_leaves(jax.eval_shape(
        lambda: model.init({"params": key, "sample": key},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           train=False)), seed)


def port_shapes(cfg):
    """The JAX ``C2MTrainModel`` variable tree of ``cfg`` (a JAX-package
    config) with unset numpy leaves, for :func:`random_leaves`, which reads
    only their paths and shapes: the port's model, allocated but not
    initialised, carried through the bridge, which consumes every JAX leaf
    and fills every port tensor. It is the tree ``jax.eval_shape`` of the
    JAX init gives (``tests/test_torch_train_step.py`` holds the two equal)
    without tracing the JAX model."""
    from c2m_tpu_torch.train.model import C2MTrainModel
    from c2m_tpu_torch.utils.convert import to_jax_variables
    pcfg = port_cfg(cfg)
    with torch.device("meta"):
        model = C2MTrainModel(pcfg)
    return to_jax_variables(model.to_empty(device="cpu").state_dict(), pcfg)


def random_leaves(shapes, seed: int = 0):
    """Numpy leaves for a tree of JAX shapes (see random_jax_variables)."""
    rng = np.random.RandomState(seed)
    flat = {}
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for keys, leaf in leaves:
        path = "/".join(str(k.key) for k in keys)
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        if name == "kernel":
            bound = 1.0 / np.sqrt(max(int(np.prod(shape[:-1])), 1))
            if "/fc2/" in path:
                bound = 0.01
            arr = rng.uniform(-bound, bound, shape)
        elif name == "bias" and "/fc2/" in path:
            arr = np.array([1, 0, 0, 0, 1, 0]) + rng.uniform(-0.01, 0.01, shape)
        elif name in ("bias", "mean"):
            arr = rng.uniform(-0.1, 0.1, shape)
        elif name == "scale":
            arr = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "var":
            arr = rng.uniform(0.5, 1.5, shape)
        else:                                            # GAT attention
            arr = rng.uniform(-0.3, 0.3, shape)
        flat[path] = arr.astype(np.float32)
    return unflatten_tree(flat)


def port_model(cfg, variables):
    """The port's C2MGenerator carrying the same weights, eval mode, CPU."""
    from c2m_tpu_torch.models.c2m import C2MGenerator
    from c2m_tpu_torch.utils.convert import from_jax_variables
    model = C2MGenerator(port_cfg(cfg))
    model.load_state_dict(from_jax_variables(variables, port_cfg(cfg)))
    return model.eval()


def to_torch(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def half_integer_raster(b=2, n=4, t=3, h=32, w=64, seed=0):
    """Instance map + axis-aligned thetas whose displacements are
    half-integer pixels: exact integers are adversarial for the interior
    test (samples of 1 - ulp at mask edges, STATUS round 3)."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((b, h, w, 1), np.float32)
    ids = np.zeros((b, n), np.int32)
    th = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (b, n, t, 1))
    for bi in range(b):
        for k in range(n):
            y0, x0 = rng.randint(0, h - 10), rng.randint(0, w - 16)
            inst[bi, y0:y0 + rng.randint(4, 10), x0:x0 + rng.randint(4, 16),
                 0] = 1000 * (bi + 1) + k + 1
            ids[bi, k] = 1000 * (bi + 1) + k + 1
    # normalized shift d moves by d*W/2 pixels: pick half-integer pixels
    dx = (rng.randint(-6, 7, (b, n, t)) + 0.5) * 2.0 / w
    dy = (rng.randint(-4, 5, (b, n, t)) + 0.5) * 2.0 / h
    th[..., 2] = dx
    th[..., 5] = dy
    mask = np.ones((b, n), bool)
    mask[:, -1] = False                                   # one padding node
    return inst, ids, mask, th.astype(np.float32)


def general_raster(b=2, n=4, t=3, h=32, w=64, seed=1):
    """Instance map + general (sheared, scaled) affines, GNN-like."""
    inst, ids, mask, _ = half_integer_raster(b, n, t, h, w, seed)
    rng = np.random.RandomState(seed + 100)
    th = np.zeros((b, n, t, 6), np.float32)
    th[..., 0] = 1 + rng.randn(b, n, t) * 0.08
    th[..., 4] = 1 + rng.randn(b, n, t) * 0.08
    th[..., 1] = rng.randn(b, n, t) * 0.05
    th[..., 3] = rng.randn(b, n, t) * 0.05
    th[..., 2] = rng.randn(b, n, t) * 0.2
    th[..., 5] = rng.randn(b, n, t) * 0.2
    return inst, ids, mask, th
