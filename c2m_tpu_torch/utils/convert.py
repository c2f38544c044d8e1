"""Weight bridge between the JAX package's variable trees and the port's
state_dicts, both ways.

The JAX tree is ``{'params': ..., 'batch_stats': ..., 'spectral': ...}``,
given nested or flattened with '/'-joined paths (the layout of a serving
artifact's ``variables.npz``), as numpy arrays: either the tree of
``C2MGenerator`` or that of ``C2MTrainModel`` (children ``c2m``,
``netd_image``, ``netd_video``, ``vgg``). The walk follows the port's
module tree; ``JAX_NAMES`` on a block names its children in the JAX tree.
Layouts:

- Conv: JAX ``[kh, kw, C, F]`` <-> torch ``[F, C, kh, kw]``;
- Conv3d: JAX folds the kt time taps kt-major into the input channels,
  ``[kh, kw, kt·C, F]`` <-> torch ``[F, C, kt, kh, kw]``;
- Dense: ``[in, out]`` <-> ``[out, in]``;
- BatchNorm: scale/bias + batch_stats mean/var <-> weight/bias +
  running_mean/running_var;
- SpectralNormConv: kernel/bias + spectral ``u`` <-> weight/bias + buffer
  ``u``.

The three NHWC flattens of the JAX model (``fc`` -> (b, h, w, 64), the
appearance bottleneck, ``roi_conv``) and the NTHWC flatten in front of the
VAE heads are kept in the port's forward, so those weights carry over
unpermuted.

From JAX, every JAX leaf is consumed exactly once and every port tensor is
filled, or the conversion raises. :func:`to_jax_variables` is the way back:
it carries a port state_dict (for instance after an optimizer step) into
the JAX layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from c2m_tpu_torch.models.sparse_motion import MaskedBatchNorm1d
from c2m_tpu_torch.nn.layers import (BatchNorm, Conv, Conv3d, Dense,
                                     InstanceNorm, SpectralNormConv)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}; a flat dict passes through."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """{'a/b/c': array} -> nested dict."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _same(t):
    return t


def _conv3d_to_torch(kt: int) -> Callable:
    def f(k):                                            # [kh, kw, kt*C, F]
        kh, kw, _, feats = k.shape
        return k.reshape(kh, kw, kt, -1, feats).permute(4, 3, 2, 0, 1)
    return f


def _conv3d_to_jax(w):                                   # [F, C, kt, kh, kw]
    feats, c, kt, kh, kw = w.shape
    return w.permute(3, 4, 2, 1, 0).reshape(kh, kw, kt * c, feats)


# one entry per tensor of a leaf module: (name in the port, JAX collection,
# path below the module in the JAX tree, JAX -> torch, torch -> JAX)
Entry = Tuple[str, str, Tuple[str, ...], Callable, Callable]


def _entries(mod: nn.Module) -> Iterator[Entry]:
    # a bare flax module has its leaves directly below its name; the JAX
    # package's own wrappers add one level named after the flax class
    bare = getattr(mod, "jax_bare", False)

    def below(name):
        return () if bare else (name,)

    if isinstance(mod, Conv3d):
        kt = mod.kernel_size[0]
        yield ("weight", "params", below("Conv_0") + ("kernel",),
               _conv3d_to_torch(kt), _conv3d_to_jax)
        yield "bias", "params", below("Conv_0") + ("bias",), _same, _same
    elif isinstance(mod, Conv):
        yield ("weight", "params", below("Conv_0") + ("kernel",),
               lambda k: k.permute(3, 2, 0, 1), lambda w: w.permute(2, 3, 1, 0))
        yield "bias", "params", below("Conv_0") + ("bias",), _same, _same
    elif isinstance(mod, SpectralNormConv):
        yield ("weight", "params", ("kernel",),
               lambda k: k.permute(3, 2, 0, 1), lambda w: w.permute(2, 3, 1, 0))
        yield "bias", "params", ("bias",), _same, _same
        yield "u", "spectral", ("u",), _same, _same
    elif isinstance(mod, Dense):
        yield ("weight", "params", ("Dense_0", "kernel"),
               lambda k: k.t(), lambda w: w.t())
        yield "bias", "params", ("Dense_0", "bias"), _same, _same
    elif isinstance(mod, (BatchNorm, MaskedBatchNorm1d)):
        sub = below("BatchNorm_0") if isinstance(mod, BatchNorm) else ()
        yield "weight", "params", sub + ("scale",), _same, _same
        yield "bias", "params", sub + ("bias",), _same, _same
        yield "running_mean", "batch_stats", sub + ("mean",), _same, _same
        yield "running_var", "batch_stats", sub + ("var",), _same, _same
    elif isinstance(mod, InstanceNorm):
        yield "weight", "params", ("scale",), _same, _same
        yield "bias", "params", ("bias",), _same, _same
    else:
        raise TypeError(f"no JAX layout known for {type(mod).__name__}")


_LEAVES = (Conv, Conv3d, Dense, BatchNorm, MaskedBatchNorm1d, InstanceNorm,
           SpectralNormConv)


def _walk(mod: nn.Module, port: str = "", jax: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, str, Callable, Callable]]:
    """Every tensor under ``mod`` as (port key, JAX '/'-path, JAX -> torch,
    torch -> JAX)."""
    if isinstance(mod, _LEAVES):
        for name, coll, sub, to_torch, to_jax in _entries(mod):
            yield port + name, "/".join((coll,) + jax + sub), to_torch, to_jax
        return
    for name, _ in mod.named_parameters(recurse=False):      # e.g. GAT att
        yield port + name, "/".join(("params",) + jax + (name,)), _same, _same
    names = getattr(mod, "JAX_NAMES", {})
    for name, child in mod.named_children():
        yield from _walk(child, f"{port}{name}.", jax + (names.get(name, name),))


def _skeleton(cfg, train: bool) -> nn.Module:
    from c2m_tpu_torch.models.c2m import C2MGenerator
    from c2m_tpu_torch.train.model import C2MTrainModel
    with torch.device("meta"):
        return C2MTrainModel(cfg) if train else C2MGenerator(cfg)


def _state_from_jax(module: nn.Module, flat: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, torch.Tensor], Set[str]]:
    sd: Dict[str, torch.Tensor] = {}
    used: Set[str] = set()
    for key, path, to_torch, _ in _walk(module):
        if path not in flat:
            raise KeyError(f"JAX variables lack {path}")
        if path in used:
            raise ValueError(f"JAX leaf {path} consumed twice")
        used.add(path)
        leaf = torch.from_numpy(np.asarray(flat[path], np.float32).copy())
        sd[key] = to_torch(leaf).contiguous()
    return sd, used


def module_state_from_jax(module: nn.Module, variables: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """State of any port module from the variables of its JAX counterpart
    (``{'params': ..., 'batch_stats': ..., 'spectral': ...}`` of that one
    module)."""
    return _state_from_jax(module, flatten(variables))[0]


def module_state_to_jax(module: nn.Module, state_dict: Mapping) -> Dict:
    """The way back of :func:`module_state_from_jax`: nested numpy tree."""
    flat = {path: to_jax(state_dict[key].detach().cpu().float()).contiguous()
            .numpy() for key, path, _, to_jax in _walk(module)}
    return unflatten(flat)


def is_train_tree(flat: Mapping[str, np.ndarray]) -> bool:
    """Whether a flat JAX tree is ``C2MTrainModel``'s (generator under
    ``c2m``) and not ``C2MGenerator``'s."""
    return any(k.startswith("params/c2m/") for k in flat)


def from_jax_variables(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX variables (nested or '/'-flat numpy tree) -> the state_dict of
    the port's counterpart: ``C2MTrainModel(cfg)`` for a train tree
    (generator, VAE encoders, both discriminators with their BatchNorm
    statistics and spectral ``u``, VGG), ``C2MGenerator(cfg)`` otherwise."""
    return convert_with_report(variables, cfg)[0]


def convert_with_report(variables: Mapping, cfg
                        ) -> Tuple[Dict[str, torch.Tensor], Set[str]]:
    """:func:`from_jax_variables` plus the set of JAX leaf paths consumed."""
    flat = flatten(variables)
    skeleton = _skeleton(cfg, is_train_tree(flat))
    sd, used = _state_from_jax(skeleton, flat)

    want = skeleton.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"port tensors not filled: {missing[:8]}")
    for key, ref in want.items():
        if tuple(sd[key].shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX gives {tuple(sd[key].shape)}, the "
                             f"port needs {tuple(ref.shape)}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"JAX leaves not consumed: {left[:8]}")
    return sd, used


def to_jax_variables(state_dict: Mapping[str, torch.Tensor], cfg) -> Dict:
    """A port state_dict (``C2MTrainModel``'s when its keys start with
    ``c2m.``, else ``C2MGenerator``'s) -> the nested JAX tree of numpy
    arrays, float32."""
    train = any(k.startswith("c2m.") for k in state_dict)
    return module_state_to_jax(_skeleton(cfg, train), state_dict)
