"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs and weights, made from a seed with numpy:
the JAX variable tree's structure comes from ``jax.eval_shape`` of
``C2MGenerator.init`` (no compile), its leaves are drawn with numpy and the
port takes them through ``c2m_tpu_torch.utils.convert``. Each package gets
its own config object: ``tiny_cfg`` makes the JAX package's, ``port_cfg``
carries it into the port's dataclasses. The port runs on the CPU here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.config import shrink_model, tiny_config
from c2m_tpu.serving import unflatten_tree
from c2m_tpu_torch import config as port_config
from c2m_tpu_torch.data import synthetic as port_synthetic


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
