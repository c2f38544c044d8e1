"""Seeded weights by parameter name and shape, made on the device.

The same seed and the same names give the same values to the port and to
the reference, whatever module classes hold them. Every leaf gets its
value from its name and shape alone:

- ``*.running_mean`` 0, ``*.running_var`` 1 (norms at identity);
- ``*.u`` (spectral norm's power-iteration vector) standard normal;
- ``*.att`` (GATv2 attention) glorot-uniform over its [heads, features];
- the GNN affine heads ``loc_<k>.fc2``: weight U(+-0.01) (their zero init
  would make every theta the identity), bias the identity affine
  [1, 0, 0, 0, 1, 0], as ``chip_smoke.build_model`` gives them;
- a weight of two or more axes (linear, conv, conv3d) U(+-1/sqrt(fan_in)),
  fan_in its size over its first axis (torch's default bound); its bias
  the same bound;
- any other 1-axis weight 1 and bias 0 (norm scales and shifts, GAT bias).

A leaf that none of these names fits raises, so that a new kind of
parameter is seen rather than silently drawn.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch

_AFFINE_HEAD = re.compile(r"(^|\.)loc_\d+\.fc2\.(weight|bias)$")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    words = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32,
         *tag.encode()]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31 | int(words[1])) & (2 ** 63 - 1)


def _rule(name: str, shape, shapes: Mapping[str, tuple]):
    """('zeros' | 'ones' | 'normal' | 'identity_affine', None) or
    ('uniform', bound)."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_mean":
        return "zeros", None
    if last == "running_var":
        return "ones", None
    if last == "u":
        return "normal", None
    head = _AFFINE_HEAD.search(name)
    if head:
        return ("uniform", 0.01) if head.group(2) == "weight" else \
            ("identity_affine", None)
    if last == "att":
        return "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))
    if last == "weight":
        if len(shape) >= 2:
            return "uniform", 1.0 / math.sqrt(math.prod(shape[1:]))
        return "ones", None
    if last == "bias":
        sibling = shapes.get(name[:-len("bias")] + "weight")
        if sibling is not None and len(sibling) >= 2:
            return "uniform", 1.0 / math.sqrt(math.prod(sibling[1:]))
        return "zeros", None
    raise KeyError(f"no weight rule for {name} {tuple(shape)}")


def seeded_state(shapes: Mapping[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape) of
    ``shapes`` (a state_dict's names and shapes), drawn from ``seed`` by a
    generator on ``device``: one uniform and one normal draw in all, cut
    into leaves in the order of their sorted names."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n]), shapes) for n in names}
    n_uniform = sum(math.prod(shapes[n]) for n in names
                    if rules[n][0] == "uniform")
    n_normal = sum(math.prod(shapes[n]) for n in names
                   if rules[n][0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at_u = at_n = 0
    for n in names:
        shape = tuple(shapes[n])
        size = math.prod(shape)
        kind, scale = rules[n]
        if kind == "uniform":
            out[n] = ((uniform[at_u:at_u + size] * 2.0 - 1.0)
                      * scale).reshape(shape)
            at_u += size
        elif kind == "normal":
            out[n] = normal[at_n:at_n + size].reshape(shape).clone()
            at_n += size
        elif kind == "zeros":
            out[n] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[n] = torch.ones(shape, device=device)
        else:
            out[n] = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                                  device=device).reshape(shape)
    return out


def build_on_device(make_module, seed: int, device) -> torch.nn.Module:
    """``make_module()`` built on the meta device (no weight is drawn on the
    host), then given storage on ``device`` and the seeded state."""
    with torch.device("meta"):
        module = make_module()
    module = module.to_empty(device=device)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    state = seeded_state(shapes, seed, device)
    module.load_state_dict(state)
    return module
