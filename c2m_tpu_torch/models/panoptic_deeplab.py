"""Panoptic-DeepLab with its HRNet-48 backbone, the segmenter of the
preprocessing chain: the port of ``c2m_tpu/models/panoptic_deeplab.py``.

Reference: panoptic_deeplab/ (Bowen Cheng's implementation): HRNet-48
(stem of two stride-2 3x3 convs, a Bottleneck stage, then three
multi-resolution stages of BasicBlocks fused across resolutions after every
module), the Panoptic-DeepLab decoder (ASPP with rates 3, 6, 9 over res5,
top-down fusion with the projected res4 / res3 / res2 through 5x5
depthwise-separable convs) and three heads: semantic (19 classes), center
heatmap and center offset. Inference only: BatchNorm uses its running
statistics, and nothing here has a backward or a kernel of its own.

The submodules carry the names of that implementation's torch checkpoint
(``backbone.stage3.2.fuse_layers.2.0.1.0.weight``,
``decoder.semantic_decoder.aspp.convs.4.aspp_pooling.1.weight``,
``decoder.instance_head.classifier.offset.1.bias``), the names that
``tools/convert_panoptic.py`` reads, so the original checkpoint loads with
``load_state_dict(strict=True)``; ``utils/convert.panoptic_from_jax`` loads
the JAX package's npz. The net takes ``[B, H, W, 3]`` and returns
channels-last maps, as the JAX module does; NCHW inside.

:func:`postprocess` is the JAX package's numpy post-processing in torch, on
the device of the head outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# HRNET_48 stage configuration (hrnet_config.py:16-49)
STAGE2 = dict(modules=1, channels=(48, 96))
STAGE3 = dict(modules=4, channels=(48, 96, 192))
STAGE4 = dict(modules=3, channels=(48, 96, 192, 384))
FEATURE_CHANNELS = {"res2": 48, "res3": 96, "res4": 192, "res5": 384}


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear with ``align_corners=True``, as the JAX module resizes in
    the fusion, the decoder and the final upsample."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


class ConvBNRelu(nn.Sequential):
    """conv (no bias) -> BatchNorm -> ReLU (left out with ``relu=False``);
    ``depthwise`` groups the conv by input channel. Index 0 is the conv and
    1 the BatchNorm, as in the checkpoint's Sequentials."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 dilation: int = 1, relu: bool = True,
                 depthwise: bool = False):
        pad = (kernel - 1) // 2 if padding is None else padding
        layers = [nn.Conv2d(in_channels, features, kernel, stride, pad,
                            dilation, groups=in_channels if depthwise else 1,
                            bias=False),
                  nn.BatchNorm2d(features)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


def _downsample(in_channels: int, features: int, stride: int = 1
                ) -> nn.Sequential:
    return ConvBNRelu(in_channels, features, 1, stride, padding=0, relu=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_downsample(in_channels, planes, stride)
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (_downsample(in_channels, planes * 4, stride)
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch BasicBlocks, then every output
    resolution sums all branches (hrnet.py:138-285). ``fuse_layers[i][j]``
    is None for i == j, a 1x1 conv + BN then an align-corners upsample for
    j > i, and a chain of stride-2 3x3 conv + BN for j < i whose every conv
    but the last has a ReLU."""

    def __init__(self, channels: Sequence[int], blocks: int = 4):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(blocks)])
            for c in channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(_downsample(channels[j], channels[i]))
                else:
                    steps = i - j
                    row.append(nn.Sequential(*[
                        ConvBNRelu(channels[j],
                                   channels[i] if k == steps - 1
                                   else channels[j], 3, 2,
                                   relu=k != steps - 1)
                        for k in range(steps)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    z = outs[j]
                elif j > i:
                    z = _resize(layer(outs[j]), outs[i].shape[-2:])
                else:
                    z = layer(outs[j])
                y = z if y is None else y + z
            fused.append(F.relu(y))
        return fused


def _transition(prev: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    """A layer only where the channel count changes (None where it does
    not), and a stride-2 chain from the last branch for each new one."""
    layers = []
    for i in range(len(cur)):
        if i < len(prev):
            layers.append(ConvBNRelu(prev[i], cur[i], 3)
                          if prev[i] != cur[i] else None)
        else:
            new = i - len(prev)
            layers.append(nn.Sequential(*[
                ConvBNRelu(prev[-1], cur[i] if j == new else prev[-1], 3, 2)
                for j in range(new + 1)]))
    return nn.ModuleList(layers)


def _apply_transition(layers: nn.ModuleList, xs):
    outs = []
    for i, layer in enumerate(layers):
        if i < len(xs):
            outs.append(xs[i] if layer is None else layer(xs[i]))
        else:
            outs.append(layer(xs[-1]))
    return outs


class HRNet48(nn.Module):
    """NCHW image -> {'res2', 'res3', 'res4', 'res5'} at 1/4 .. 1/32."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(
            BottleneckBlock(64, 64, has_downsample=True),
            *[BottleneckBlock(256, 64) for _ in range(3)])
        self.transition1 = _transition((256,), STAGE2["channels"])
        self.stage2 = nn.Sequential(*[HRModule(STAGE2["channels"])
                                      for _ in range(STAGE2["modules"])])
        self.transition2 = _transition(STAGE2["channels"], STAGE3["channels"])
        self.stage3 = nn.Sequential(*[HRModule(STAGE3["channels"])
                                      for _ in range(STAGE3["modules"])])
        self.transition3 = _transition(STAGE3["channels"], STAGE4["channels"])
        self.stage4 = nn.Sequential(*[HRModule(STAGE4["channels"])
                                      for _ in range(STAGE4["modules"])])

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = self.stage2(_apply_transition(self.transition1, [x]))
        xs = self.stage3(_apply_transition(self.transition2, xs))
        xs = self.stage4(_apply_transition(self.transition3, xs))
        return {"res2": xs[0], "res3": xs[1], "res4": xs[2], "res5": xs[3]}


class _ASPPPooling(nn.Module):
    """Global average, a 1x1 conv without bias and without BatchNorm, ReLU
    (aspp.py:23-31); its bilinear upsample from 1x1 is a broadcast."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.aspp_pooling = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(in_channels, out_channels, 1, bias=False), nn.ReLU())

    def forward(self, x):
        return self.aspp_pooling(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """decoder/aspp.py: 1x1 + three dilated 3x3 + image pooling, projected
    by a 1x1 conv (the checkpoint's Dropout after it is the identity at
    inference and holds no weights)."""

    def __init__(self, in_channels: int, out_channels: int,
                 rates: Sequence[int] = (3, 6, 9)):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNRelu(in_channels, out_channels, 1, padding=0)]
            + [ConvBNRelu(in_channels, out_channels, 3, padding=r, dilation=r)
               for r in rates]
            + [_ASPPPooling(in_channels, out_channels)])
        self.project = ConvBNRelu(out_channels * (len(rates) + 2),
                                  out_channels, 1, padding=0)

    def forward(self, x):
        return self.project(torch.cat([conv(x) for conv in self.convs], 1))


class SeparableConv5(nn.Sequential):
    """The depthwise-separable 5x5 of conv_module.py: depthwise 5x5 conv +
    BN + ReLU (index 0), pointwise conv (1), BN (2), ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(
            ConvBNRelu(in_channels, in_channels, 5, depthwise=True),
            nn.Conv2d(in_channels, features, 1, bias=False),
            nn.BatchNorm2d(features), nn.ReLU())


def _stacked(in_channels: int, features: int) -> nn.Sequential:
    """stacked_conv with one depthwise-separable conv, as the checkpoint
    nests it (``fuse.0.0.0.0.weight`` is the depthwise kernel)."""
    return nn.Sequential(SeparableConv5(in_channels, features))


class SingleDecoder(nn.Module):
    """ASPP over res5, then for res4, res3, res2: project the feature by a
    1x1 conv, upsample x to it (align corners) and fuse [x, projection]."""

    def __init__(self, decoder_channels: int, aspp_channels: int,
                 project_channels: Sequence[int],
                 in_channels: Dict[str, int] = FEATURE_CHANNELS):
        super().__init__()
        self.aspp = ASPP(in_channels["res5"], aspp_channels)
        keys = ("res4", "res3", "res2")
        self.project = nn.ModuleList(
            ConvBNRelu(in_channels[k], c, 1, padding=0)
            for k, c in zip(keys, project_channels))
        self.fuse = nn.ModuleList(
            _stacked((aspp_channels if i == 0 else decoder_channels) + c,
                     decoder_channels)
            for i, c in enumerate(project_channels))

    def forward(self, feats):
        x = self.aspp(feats["res5"])
        for key, project, fuse in zip(("res4", "res3", "res2"), self.project,
                                      self.fuse):
            low = project(feats[key])
            x = fuse(torch.cat([_resize(x, low.shape[-2:]), low], 1))
        return x


class Head(nn.Module):
    """``classifier[name]``: a depthwise-separable 5x5 to ``head_channels``,
    then a 1x1 conv with bias to ``classes[name]`` channels; returns
    {name: map}."""

    def __init__(self, in_channels: int, head_channels: int,
                 classes: Dict[str, int]):
        super().__init__()
        self.classifier = nn.ModuleDict({
            name: nn.Sequential(_stacked(in_channels, head_channels),
                                nn.Conv2d(head_channels, n, 1))
            for name, n in classes.items()})

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {name: head(x) for name, head in self.classifier.items()}


class PanopticDeepLab(nn.Module):
    """``[B, H, W, 3]`` (ImageNet-normalized) -> {'semantic' [B, H, W, 19],
    'center' [..., 1], 'offset' [..., 2]}; ``upsample=False`` keeps the
    decoder's own 1/4 resolution."""

    def __init__(self, num_classes: int = 19, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.backbone = HRNet48()
        self.decoder = nn.ModuleDict({
            "semantic_decoder": SingleDecoder(256, 256, (128, 64, 32)),
            "semantic_head": Head(256, 256, {"semantic": num_classes}),
            "instance_decoder": SingleDecoder(128, 256, (64, 32, 16)),
            "instance_head": Head(128, 32, {"center": 1, "offset": 2}),
        })

    def forward(self, x) -> Dict[str, torch.Tensor]:
        size = x.shape[1:3]
        feats = self.backbone(x.permute(0, 3, 1, 2))
        d = self.decoder
        out = d["semantic_head"](d["semantic_decoder"](feats))
        out.update(d["instance_head"](d["instance_decoder"](feats)))
        if self.upsample:
            out = {k: _resize(v, size) for k, v in out.items()}
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Post-processing (post_processing/instance_post_processing.py:182,
# semantic_post_processing.py:11)
# ---------------------------------------------------------------------------

THING_CLASSES = tuple(range(11, 19))
LABEL_DIVISOR = 1000
# elements of one chunk of the [rows, W, K] float64 distances
_VOTE_CHUNK = 1 << 24


@torch.no_grad()
def postprocess(semantic: torch.Tensor, center: torch.Tensor,
                offset: torch.Tensor, center_threshold: float = 0.1,
                nms_kernel: int = 7, top_k: int = 200
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's head outputs ``semantic [H, W, C]``, ``center [H, W, 1]``,
    ``offset [H, W, 2]`` -> (semantic trainId map, instance-id map), both
    ``[H, W]`` int32 on the outputs' device, equal to the JAX package's
    numpy ``postprocess``:

    - centers: a ``nms_kernel`` max pool padded with -inf, kept where the
      heat is ``>=`` the pooled heat and above ``center_threshold``, in
      row-major order; above ``top_k`` of them, the ``top_k`` highest by a
      stable sort of ``-heat`` (numpy's default sort leaves the order of
      exactly tied heats unspecified, so only there may the two differ);
    - every pixel votes for the nearest center to ``(y, x) + offset``,
      squared distances in float64 as numpy promotes them, the first
      center on ties; rows go in chunks so that ``[H, W, K]`` stays bounded;
    - a thing pixel (trainId 11..18) gets ``trainId * 1000 + k``, k
      counting the centers voted for within its class in ascending order.
    """
    dev = semantic.device
    sem = semantic.argmax(-1)
    heat = center[..., 0]
    h, w = heat.shape
    pooled = F.max_pool2d(heat[None, None], nms_kernel, stride=1,
                          padding=nms_kernel // 2)[0, 0]
    ys, xs = torch.nonzero((heat >= pooled) & (heat > center_threshold),
                           as_tuple=True)
    if len(ys) > top_k:
        order = torch.argsort(-heat[ys, xs], stable=True)[:top_k]
        ys, xs = ys[order], xs[order]
    instance = torch.zeros((h, w), dtype=torch.int32, device=dev)
    if not len(ys):
        return sem.to(torch.int32), instance

    cy, cx = ys.to(torch.float64), xs.to(torch.float64)
    off = offset.to(torch.float64)
    xx = torch.arange(w, device=dev, dtype=torch.float64)
    rows = max(1, _VOTE_CHUNK // (w * len(ys)))
    nearest = torch.empty((h, w), dtype=torch.int64, device=dev)
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        yy = torch.arange(r0, r1, device=dev, dtype=torch.float64)[:, None]
        vote_y = yy + off[r0:r1, :, 0]
        vote_x = xx + off[r0:r1, :, 1]
        d2 = ((vote_y[..., None] - cy) ** 2 + (vote_x[..., None] - cx) ** 2)
        nearest[r0:r1] = d2.argmin(-1) + 1
    things = torch.tensor(THING_CLASSES, device=dev)
    inst_map = torch.where(torch.isin(sem, things), nearest, 0)
    for cls in THING_CLASSES:
        mask = (sem == cls) & (inst_map > 0)
        ids = torch.unique(inst_map[mask])          # ascending
        if not len(ids):
            continue
        k = torch.searchsorted(ids, inst_map) + 1
        instance = torch.where(mask, (cls * LABEL_DIVISOR + k).to(torch.int32),
                               instance)
    return sem.to(torch.int32), instance
