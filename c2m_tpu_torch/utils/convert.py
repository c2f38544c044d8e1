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
- ConvTranspose (FlowNet2's deconvs, flax ``transpose_kernel=True``): JAX
  ``[kh, kw, out, in]`` <-> torch ``[in, out, kh, kw]``, taps unflipped;
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
the JAX layout. :func:`flownet2_from_jax` / :func:`flownet2_to_jax` are the
same bridge for the FlowNet2 parameter tree.

The evaluator's metric nets have a pair each, on the ``{'params',
'batch_stats'}`` trees of the JAX package's ``eval/inception.py``,
``eval/i3d.py`` and ``eval/yolov3.py`` (the npz files of
``tools/convert_inception.py`` and ``tools/convert_i3d.py``, read and
written by :func:`read_variables_npz` / :func:`write_variables_npz`):
:func:`inception_from_jax` / :func:`inception_to_jax` (the port keeps
torchvision's names, the JAX tree the same path with ``Conv_0`` /
``BatchNorm_0`` below it), :func:`i3d_from_jax` / :func:`i3d_to_jax` (the
port keeps the pytorch-i3d names ``b0``..``b3b`` / ``logits``, the JAX tree
``Branch_0``..``Branch_3b`` / ``Logits``; kernels ``[kt, kh, kw, I, O]``
<-> ``[O, I, kt, kh, kw]``) and :func:`yolov3_from_jax` /
:func:`yolov3_to_jax` (the conv blocks of ``YoloV3.conv_blocks`` paired in
darknet cfg order with flax's auto-numbered scopes,
``eval/yolov3._conv_block_order``). Each consumes every JAX leaf once and
fills every port tensor, or raises.

The preprocessing nets have a pair each, on the trees of
``tools/convert_panoptic.py`` and ``tools/convert_siamrpn.py``:
:func:`panoptic_from_jax` / :func:`panoptic_to_jax` and
:func:`siamrpn_from_jax` / :func:`siamrpn_to_jax`. The port keeps the
torch checkpoints' own names, and each key maps to its JAX path by those
converters' rules; the same checks apply (that converter for SiamRPN++
reports no unmapped key, this bridge does).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from c2m_tpu_torch.models.flownet2 import Deconv, FlowNet2
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
        if mod.bias is not None:
            yield "bias", "params", below("Conv_0") + ("bias",), _same, _same
    elif isinstance(mod, Deconv):
        # the same axis map as a conv's, read on [kh, kw, out, in]
        yield ("weight", "params", ("ConvTranspose_0", "kernel"),
               lambda k: k.permute(3, 2, 0, 1), lambda w: w.permute(2, 3, 1, 0))
        if mod.bias is not None:
            yield "bias", "params", ("ConvTranspose_0", "bias"), _same, _same
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
        if mod.weight is not None:          # affine=False holds nothing
            yield "weight", "params", ("scale",), _same, _same
            yield "bias", "params", ("bias",), _same, _same
    else:
        raise TypeError(f"no JAX layout known for {type(mod).__name__}")


_LEAVES = (Conv, Conv3d, Deconv, Dense, BatchNorm, MaskedBatchNorm1d,
           InstanceNorm, SpectralNormConv)


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
        jax_name = names.get(name, name)       # None: no level in the JAX tree
        yield from _walk(child, f"{port}{name}.",
                         jax if jax_name is None else jax + (jax_name,))


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


def _flownet2_skeleton() -> nn.Module:
    with torch.device("meta"):
        return FlowNet2()


def flownet2_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX FlowNet2 ``params`` tree (nested or '/'-flat, numpy) -> the
    port's ``FlowNet2().state_dict()``, whose keys are the reference torch
    checkpoint's. Every JAX leaf is consumed once and every port tensor is
    filled, or this raises."""
    flat = flatten({"params": params})
    sd, used = _state_from_jax(_flownet2_skeleton(), flat)
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"JAX leaves not consumed: {left[:8]}")
    return sd


def flownet2_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The way back: a FlowNet2 ``state_dict`` -> the nested JAX ``params``
    tree of numpy arrays, float32."""
    return module_state_to_jax(_flownet2_skeleton(), state_dict)["params"]


# -- the metric nets ----------------------------------------------------------

def read_variables_npz(path: str) -> Dict:
    """An npz of the JAX converters (``params`` and ``batch_stats``, each a
    pickled nested dict of numpy arrays) -> ``{'params', 'batch_stats'}``."""
    data = np.load(path, allow_pickle=True)
    return {"params": data["params"].item(),
            "batch_stats": data["batch_stats"].item()}


def write_variables_npz(path: str, variables: Mapping) -> None:
    """The way back of :func:`read_variables_npz`."""
    np.savez(path, params=np.asarray(variables["params"], dtype=object),
             batch_stats=np.asarray(variables["batch_stats"], dtype=object))


_K2D = (lambda k: k.permute(3, 2, 0, 1), lambda w: w.permute(2, 3, 1, 0))
_K3D = (lambda k: k.permute(4, 3, 0, 1, 2), lambda w: w.permute(2, 3, 4, 1, 0))
_I3D_SCOPES = {"b0": "Branch_0", "b1a": "Branch_1a", "b1b": "Branch_1b",
               "b2a": "Branch_2a", "b2b": "Branch_2b", "b3b": "Branch_3b",
               "logits": "Logits"}


def _conv_entries(port: str, scope: Tuple[str, ...], conv: str, bn,
                  kernel, conv_scope: Tuple[str, ...] = ("Conv_0",)
                  ) -> Iterator[Tuple[str, str, Callable, Callable]]:
    """(port key, JAX path, JAX -> torch, torch -> JAX) of one conv block:
    its conv ``{port}{conv}`` at ``scope/conv_scope`` in the JAX tree, then
    the BatchNorm ``{port}{bn}`` at ``scope/BatchNorm_0`` or, when ``bn`` is
    None, the conv's bias."""
    c = "/".join(scope + conv_scope)
    yield f"{port}{conv}.weight", f"params/{c}/kernel", *kernel
    if bn is None:
        yield f"{port}{conv}.bias", f"params/{c}/bias", _same, _same
        return
    b = "/".join(scope + ("BatchNorm_0",))
    yield f"{port}{bn}.weight", f"params/{b}/scale", _same, _same
    yield f"{port}{bn}.bias", f"params/{b}/bias", _same, _same
    yield f"{port}{bn}.running_mean", f"batch_stats/{b}/mean", _same, _same
    yield f"{port}{bn}.running_var", f"batch_stats/{b}/var", _same, _same


def _metric_net(name: str):
    """(skeleton on the meta device, its entries) of a metric net."""
    from c2m_tpu_torch.eval import i3d, inception, yolov3
    with torch.device("meta"):
        net = {"inception": inception.InceptionV3Pool3, "i3d": i3d.InceptionI3d,
               "yolov3": yolov3.YoloV3}[name]()
    entries = []
    if name == "inception":
        for path, mod in net.named_modules():
            if isinstance(mod, inception.BasicConv2d):
                entries += _conv_entries(f"{path}.", tuple(path.split(".")),
                                         "conv", "bn", _K2D)
    elif name == "i3d":
        for path, mod in net.named_modules():
            if isinstance(mod, i3d.Unit3D):
                scope = tuple(_I3D_SCOPES.get(p, p) for p in path.split("."))
                entries += _conv_entries(f"{path}.", scope, "conv3d",
                                         None if mod.bn is None else "bn",
                                         _K3D)
    else:
        for (path, blk), (scope, has_bn) in zip(net.conv_blocks(),
                                                yolov3._conv_block_order()):
            assert has_bn == (blk.bn is not None), (path, scope)
            if has_bn:
                entries += _conv_entries(f"{path}.", scope, "conv", "bn", _K2D)
            else:
                entries += _conv_entries(f"{path}.", (), "conv", None, _K2D,
                                         conv_scope=scope)
    return net, entries


def _from_entries(net: nn.Module, entries, variables: Mapping
                  ) -> Dict[str, torch.Tensor]:
    """``net``'s state_dict from JAX variables along ``entries`` (port key,
    JAX path, JAX -> torch, torch -> JAX): every JAX leaf consumed once,
    every port tensor filled with its shape, or this raises."""
    flat = flatten(variables)
    sd: Dict[str, torch.Tensor] = {}
    used: Set[str] = set()
    for key, path, to_torch, _ in entries:
        if path not in flat:
            raise KeyError(f"JAX variables lack {path}")
        if path in used:
            raise ValueError(f"JAX leaf {path} consumed twice")
        used.add(path)
        leaf = torch.from_numpy(np.asarray(flat[path], np.float32).copy())
        sd[key] = to_torch(leaf).contiguous()
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):      # no JAX counterpart
            sd[key] = torch.zeros((), dtype=torch.long)
        elif key not in sd:
            raise KeyError(f"port tensor not filled: {key}")
        elif tuple(sd[key].shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX gives {tuple(sd[key].shape)}, the "
                             f"port needs {tuple(ref.shape)}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"JAX leaves not consumed: {left[:8]}")
    return sd


def _to_entries(entries, state_dict: Mapping) -> Dict:
    """The way back of :func:`_from_entries`: the nested JAX tree."""
    return unflatten({path: to_jax(state_dict[key].detach().cpu().float())
                      .contiguous().numpy()
                      for key, path, _, to_jax in entries})


def _metric_net_from_jax(name: str, variables: Mapping
                         ) -> Dict[str, torch.Tensor]:
    return _from_entries(*_metric_net(name), variables)


def _metric_net_to_jax(name: str, state_dict: Mapping) -> Dict:
    return _to_entries(_metric_net(name)[1], state_dict)


def inception_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3Pool3`` variables -> the port's state_dict."""
    return _metric_net_from_jax("inception", variables)


def inception_to_jax(state_dict: Mapping) -> Dict:
    """The port's ``InceptionV3Pool3`` state_dict -> the nested JAX tree."""
    return _metric_net_to_jax("inception", state_dict)


def i3d_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionI3d`` variables -> the port's state_dict."""
    return _metric_net_from_jax("i3d", variables)


def i3d_to_jax(state_dict: Mapping) -> Dict:
    """The port's ``InceptionI3d`` state_dict -> the nested JAX tree."""
    return _metric_net_to_jax("i3d", state_dict)


def yolov3_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``YoloV3`` variables -> the port's state_dict."""
    return _metric_net_from_jax("yolov3", variables)


def yolov3_to_jax(state_dict: Mapping) -> Dict:
    """The port's ``YoloV3`` state_dict -> the nested JAX tree."""
    return _metric_net_to_jax("yolov3", state_dict)


# -- the preprocessing nets ---------------------------------------------------
#
# Panoptic-DeepLab and SiamRPN++ carry the torch checkpoints' own names
# (Bowen Cheng's and pysot's), so their bridge maps each port key to its JAX
# path by the rules of ``tools/convert_panoptic.py`` and
# ``tools/convert_siamrpn.py``: a conv + BatchNorm pair of the checkpoint is
# one JAX scope holding ``Conv_0`` and ``BatchNorm_0``.

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_SAME = (_same, _same)


def _conv_or_bn(scope: str, is_conv: bool, leaf: str):
    """(JAX path, (JAX -> torch, torch -> JAX)) of a conv weight or a
    BatchNorm tensor of the JAX scope ``scope``."""
    if is_conv:
        if leaf != "weight":
            raise KeyError(f"a bias-free conv has no {leaf}")
        return f"params/{scope}/Conv_0/kernel", _K2D
    coll, name = _BN_LEAVES[leaf]
    return f"{coll}/{scope}/BatchNorm_0/{name}", _SAME


def _panoptic_entry(key: str):
    """A ``PanopticDeepLab`` state_dict key -> (JAX path, transforms)."""
    fm = re.fullmatch
    m = fm(r"backbone\.(conv|bn)([12])\.(\w+)", key)
    if m:
        return _conv_or_bn(f"backbone/stem{m[2]}", m[1] == "conv", m[3])
    m = fm(r"backbone\.layer1\.(\d+)\.(conv|bn)(\d)\.(\w+)", key)
    if m:
        return _conv_or_bn(f"backbone/layer1_{m[1]}/ConvBNRelu_"
                           f"{int(m[3]) - 1}", m[2] == "conv", m[4])
    m = fm(r"backbone\.layer1\.(\d+)\.downsample\.([01])\.(\w+)", key)
    if m:
        return _conv_or_bn(f"backbone/layer1_{m[1]}/downsample", m[2] == "0",
                           m[3])
    m = fm(r"backbone\.transition(\d)\.(\d+)\.(?:(\d+)\.)?([01])\.(\w+)", key)
    if m:
        t, i, j, idx, leaf = m.groups()
        scope = f"backbone/transition{t}_{i}" + ("" if j is None else f"_{j}")
        return _conv_or_bn(scope, idx == "0", leaf)
    m = fm(r"backbone\.stage(\d)\.(\d+)\.branches\.(\d+)\.(\d+)\.(conv|bn)"
           r"(\d)\.(\w+)", key)
    if m:
        s, mod, br, blk, kind, n, leaf = m.groups()
        return _conv_or_bn(f"backbone/stage{s}_{mod}/branch{br}_block{blk}/"
                           f"ConvBNRelu_{int(n) - 1}", kind == "conv", leaf)
    m = fm(r"backbone\.stage(\d)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\."
           r"(?:(\d+)\.)?([01])\.(\w+)", key)
    if m:
        s, mod, i, j, k, idx, leaf = m.groups()
        scope = (f"backbone/stage{s}_{mod}/fuse_{i}_{j}"
                 + ("" if k is None else f"_{k}"))
        return _conv_or_bn(scope, idx == "0", leaf)
    m = fm(r"decoder\.(semantic|instance)_decoder\.aspp\.convs\.(\d)\."
           r"(?:aspp_pooling\.)?(\d)\.(\w+)", key)
    if m:
        which, branch, idx, leaf = m.groups()
        if branch == "4":            # image pooling: a bare conv, no BN
            if (idx, leaf) != ("1", "weight"):
                raise KeyError(key)
            return f"params/{which}_decoder/aspp/pool_conv/kernel", _K2D
        sub = "conv1x1" if branch == "0" else f"rate{int(branch) - 1}"
        return _conv_or_bn(f"{which}_decoder/aspp/{sub}", idx == "0", leaf)
    m = fm(r"decoder\.(semantic|instance)_decoder\.aspp\.project\.([01])\."
           r"(\w+)", key)
    if m:
        return _conv_or_bn(f"{m[1]}_decoder/aspp/project", m[2] == "0", m[3])
    m = fm(r"decoder\.(semantic|instance)_decoder\.project\.(\d)\.([01])\."
           r"(\w+)", key)
    if m:
        return _conv_or_bn(f"{m[1]}_decoder/project_{m[2]}", m[3] == "0",
                           m[4])
    # a depthwise-separable conv: .0.{0,1} depthwise conv + BN, .1 / .2
    # pointwise conv / BN
    m = fm(r"decoder\.(semantic|instance)_decoder\.fuse\.(\d)\.0\."
           r"(?:0\.([01])|([12]))\.(\w+)", key)
    if m:
        which, i, dw, pw, leaf = m.groups()
        if dw is not None:
            return _conv_or_bn(f"{which}_decoder/fuse_{i}/dw", dw == "0", leaf)
        return _conv_or_bn(f"{which}_decoder/fuse_{i}/pw", pw == "1", leaf)
    m = fm(r"decoder\.(?:semantic|instance)_head\.classifier\."
           r"(semantic|center|offset)\.(?:0\.0\.(?:0\.([01])|([12]))|1)\."
           r"(\w+)", key)
    if m:
        name, dw, pw, leaf = m.groups()
        head = f"{name}_head"
        if dw is not None:
            return _conv_or_bn(f"{head}/conv/dw", dw == "0", leaf)
        if pw is not None:
            return _conv_or_bn(f"{head}/conv/pw", pw == "1", leaf)
        if leaf == "weight":
            return f"params/{head}/out/kernel", _K2D
        return f"params/{head}/out/bias", _SAME
    raise KeyError(f"no JAX path known for the Panoptic-DeepLab key {key}")


def _siamrpn_entry(key: str):
    """A ``SiamRPNpp`` state_dict key -> (JAX path, transforms)."""
    fm = re.fullmatch
    m = fm(r"rpn_head\.(cls|loc)_weight", key)
    if m:
        return f"params/{m[1]}_weight", _SAME
    m = fm(r"backbone\.(conv|bn)1\.(\w+)", key)
    if m:
        return _conv_or_bn("backbone/conv1", m[1] == "conv", m[2])
    m = fm(r"backbone\.layer(\d)\.(\d+)\.(conv|bn)(\d)\.(\w+)", key)
    if m:
        l, b, kind, k, leaf = m.groups()
        return _conv_or_bn(f"backbone/layer{l}_{b}/conv{k}", kind == "conv",
                           leaf)
    m = fm(r"backbone\.layer(\d)\.(\d+)\.downsample\.([01])\.(\w+)", key)
    if m:
        return _conv_or_bn(f"backbone/layer{m[1]}_{m[2]}/downsample",
                           m[3] == "0", m[4])
    m = fm(r"neck\.downsample(\d)\.downsample\.([01])\.(\w+)", key)
    if m:
        return _conv_or_bn(f"neck_{int(m[1]) - 2}/downsample", m[2] == "0",
                           m[3])
    m = fm(r"rpn_head\.rpn(\d)\.(cls|loc)\.(conv_kernel|conv_search|head)\."
           r"(\d)\.(\w+)", key)
    if m:
        n, branch, part, idx, leaf = m.groups()
        base = f"rpn_{int(n) - 2}/{branch}"
        if part != "head":                   # Sequential(conv, BN, ReLU)
            sub = "kernel_conv" if part == "conv_kernel" else "search_conv"
            return _conv_or_bn(f"{base}/{sub}", idx == "0", leaf)
        if idx in ("0", "1"):               # [conv, BN, ReLU, conv + bias]
            return _conv_or_bn(f"{base}/head1", idx == "0", leaf)
        if idx == "3":
            if leaf == "weight":
                return f"params/{base}/head2/kernel", _K2D
            return f"params/{base}/head2/bias", _SAME
    raise KeyError(f"no JAX path known for the SiamRPN++ key {key}")


def _keyed_entries(keys, entry, prefix: str = ""):
    """(port key, JAX path, JAX -> torch, torch -> JAX) of each state_dict
    key (``num_batches_tracked`` has no JAX counterpart), mapped by
    ``entry`` after ``prefix``: a submodule of the whole net takes the
    prefix of its keys there, with its variables nested at its scope in the
    whole net's tree (as the tests convert submodules)."""
    out = []
    for key in keys:
        if not key.endswith("num_batches_tracked"):
            path, (to_torch, to_jax) = entry(prefix + key)
            out.append((key, path, to_torch, to_jax))
    return out


def panoptic_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PanopticDeepLab`` variables (``{'params', 'batch_stats'}``, the
    npz of ``tools/convert_panoptic.py``) -> the port's state_dict."""
    from c2m_tpu_torch.models.panoptic_deeplab import PanopticDeepLab
    with torch.device("meta"):
        net = PanopticDeepLab()
    return _from_entries(net, _keyed_entries(net.state_dict(),
                                             _panoptic_entry), variables)


def panoptic_to_jax(state_dict: Mapping) -> Dict:
    """The port's ``PanopticDeepLab`` state_dict -> the nested JAX
    ``{'params', 'batch_stats'}`` tree."""
    return _to_entries(_keyed_entries(state_dict, _panoptic_entry),
                       state_dict)


def siamrpn_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SiamRPNpp`` variables (the npz of ``tools/convert_siamrpn.py``)
    -> the port's state_dict."""
    from c2m_tpu_torch.models.siamrpn import SiamRPNpp
    with torch.device("meta"):
        net = SiamRPNpp()
    return _from_entries(net, _keyed_entries(net.state_dict(),
                                             _siamrpn_entry), variables)


def siamrpn_to_jax(state_dict: Mapping) -> Dict:
    """The port's ``SiamRPNpp`` state_dict -> the nested JAX tree."""
    return _to_entries(_keyed_entries(state_dict, _siamrpn_entry),
                       state_dict)
