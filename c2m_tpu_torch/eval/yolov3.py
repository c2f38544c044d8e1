"""YOLOv3 detector, NMS and the darknet weights loader: the port of
``c2m_tpu/eval/yolov3.py`` (reference src/modules/networks/yolo_v3/, the
COCO YOLOv3 the evaluator's detection metric runs, utils_yolov3.py:67-169).

Darknet-53 and three detection scales, 80 classes: ``ConvBL`` = conv +
BatchNorm(eps 1e-5) + LeakyReLU(0.1), or a conv with a bias and nothing
after it (the three 1x1 detection convs). ``YoloV3`` maps ``[B, H, W, 3]``
(channels last, as the JAX module takes it; NCHW inside) to ``[B, 3·(h5² +
h4² + h3²), 85]`` rows (cx, cy, w, h, conf, 80 class scores) in pixels,
anchor-major per scale as the JAX ``_decode`` orders them. ``conv_blocks``
lists the conv blocks in darknet cfg order: ``load_darknet_weights`` reads
the original ``yolov3.weights`` into them, and ``utils/convert`` pairs them
with the JAX package's auto-numbered scopes (``_conv_block_order``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),   # stride 32
    ((30, 61), (62, 45), (59, 119)),       # stride 16
    ((10, 13), (16, 30), (33, 23)),        # stride 8
)
NUM_CLASSES = 80


class ConvBL(nn.Module):
    """conv + BN + LeakyReLU(0.1) (darknet convolutional block); with
    ``bn=False`` a conv with a bias alone."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride,
                              (kernel - 1) // 2, bias=not bn)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5) if bn else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is None:
            return x
        return F.leaky_relu(self.bn(x), 0.1)


class Residual(nn.Module):
    def __init__(self, features: int):
        """features: the bottleneck width; input and output are 2x."""
        super().__init__()
        self.conv1 = ConvBL(2 * features, features, 1)
        self.conv2 = ConvBL(features, 2 * features, 3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


# (width after the stride-2 conv, residual blocks) of Darknet-53's stages
_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


class Darknet53(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBL(3, 32, 3)
        stages, ch = [], 32
        for width, n in _STAGES:
            stages.append(nn.Sequential(ConvBL(ch, width, 3, 2),
                                        *[Residual(width // 2)
                                          for _ in range(n)]))
            ch = width
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """-> (c3, c4, c5): the stride-8, -16 and -32 maps."""
        x = self.stem(x)
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs[2], outs[3], outs[4]


def _decode(pred: torch.Tensor, anchors, stride: int) -> torch.Tensor:
    """[B, A·(5+C), H, W] -> [B, A·H·W, 5+C] absolute boxes (cx, cy, w, h,
    conf, classes), anchor-major: the channel axis splits as (anchor,
    field), as the JAX ``_decode`` splits its last axis."""
    b, _, h, w = pred.shape
    a = len(anchors)
    p = pred.view(b, a, 5 + NUM_CLASSES, h, w).permute(0, 1, 3, 4, 2)
    xs = torch.arange(w, dtype=pred.dtype, device=pred.device)
    ys = torch.arange(h, dtype=pred.dtype, device=pred.device)
    anc = torch.tensor(anchors, dtype=pred.dtype, device=pred.device)
    cx = (torch.sigmoid(p[..., 0]) + xs[None, None, None, :]) * stride
    cy = (torch.sigmoid(p[..., 1]) + ys[None, None, :, None]) * stride
    pw = torch.exp(p[..., 2]) * anc[None, :, None, None, 0]
    ph = torch.exp(p[..., 3]) * anc[None, :, None, None, 1]
    out = torch.cat([torch.stack([cx, cy, pw, ph], -1),
                     torch.sigmoid(p[..., 4:])], -1)
    return out.reshape(b, -1, 5 + NUM_CLASSES)


class Head(nn.Module):
    """One detection scale: the 5-conv block, the 3x3 head conv, the 1x1
    detection conv and (scales 32 and 16) the 1x1 route conv whose output
    is upsampled into the next scale."""

    def __init__(self, in_ch: int, ch: int, route: bool):
        super().__init__()
        self.block = nn.Sequential(
            ConvBL(in_ch, ch, 1), ConvBL(ch, 2 * ch, 3), ConvBL(2 * ch, ch, 1),
            ConvBL(ch, 2 * ch, 3), ConvBL(2 * ch, ch, 1))
        self.head = ConvBL(ch, 2 * ch, 3)
        self.detect = ConvBL(2 * ch, 3 * (5 + NUM_CLASSES), 1, bn=False)
        self.route = ConvBL(ch, ch // 2, 1) if route else None


class YoloV3(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = Darknet53()
        self.heads = nn.ModuleList([Head(1024, 512, True),
                                    Head(512 + 256, 256, True),
                                    Head(256 + 128, 128, False)])

    def forward(self, x):
        """x: [B, H, W, 3] in [0, 1] -> [B, N, 85]."""
        c3, c4, c5 = self.backbone(x.permute(0, 3, 1, 2))
        outs, x = [], c5
        for head, anchors, stride, skip in zip(self.heads, ANCHORS,
                                               (32, 16, 8), (c4, c3, None)):
            r = head.block(x)
            outs.append(_decode(head.detect(head.head(r)), anchors, stride))
            if head.route is not None:
                # nearest 2x, then the route before the backbone's map
                u = F.interpolate(head.route(r), scale_factor=2,
                                  mode="nearest")
                x = torch.cat([u, skip], 1)
        return torch.cat(outs, 1)

    def conv_blocks(self) -> List[Tuple[str, ConvBL]]:
        """(name, block) of every conv block in darknet cfg order: the
        trunk, then per scale the 5-conv block, the head conv, the
        detection conv and the route conv."""
        named = dict(self.named_modules())
        names = ["backbone.stem"]
        for si, (_, n) in enumerate(_STAGES):
            names.append(f"backbone.stages.{si}.0")
            for r in range(1, n + 1):
                names += [f"backbone.stages.{si}.{r}.conv1",
                          f"backbone.stages.{si}.{r}.conv2"]
        for hi in range(3):
            names += [f"heads.{hi}.block.{k}" for k in range(5)]
            names += [f"heads.{hi}.head", f"heads.{hi}.detect"]
            if hi < 2:
                names.append(f"heads.{hi}.route")
        return [(n, named[n]) for n in names]


def non_max_suppression(pred: np.ndarray, conf_thresh: float = 0.5,
                        nms_thresh: float = 0.4) -> Optional[np.ndarray]:
    """Greedy per-class NMS. pred [N, 85] (cx, cy, w, h, conf, cls...)
    -> [M, 7] rows (x1, y1, x2, y2, conf, cls_conf, cls) or None."""
    keep = pred[pred[:, 4] >= conf_thresh]
    if not len(keep):
        return None
    boxes = np.empty((len(keep), 4))
    boxes[:, 0] = keep[:, 0] - keep[:, 2] / 2
    boxes[:, 1] = keep[:, 1] - keep[:, 3] / 2
    boxes[:, 2] = keep[:, 0] + keep[:, 2] / 2
    boxes[:, 3] = keep[:, 1] + keep[:, 3] / 2
    cls_conf = keep[:, 5:].max(axis=1)
    cls_pred = keep[:, 5:].argmax(axis=1)
    score = keep[:, 4] * cls_conf
    order = np.argsort(-score)
    out = []
    suppressed = np.zeros(len(keep), bool)
    for i in order:
        if suppressed[i]:
            continue
        out.append([*boxes[i], keep[i, 4], cls_conf[i], cls_pred[i]])
        same = cls_pred == cls_pred[i]
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
        suppressed |= same & (iou > nms_thresh)
    return np.asarray(out) if out else None


def _conv_block_order() -> List[Tuple[Tuple[str, ...], bool]]:
    """Conv blocks in darknet cfg order as (JAX scope path, has_bn): the
    JAX package's module creation order mirrors the cfg and flax numbers
    inline submodules in call order, so the scopes (``backbone/ConvBL_i``,
    ``backbone/Residual_r/ConvBL_j``, ``ConvBL_k``, ``Conv_d``) are
    reconstructible; :meth:`YoloV3.conv_blocks` lists the same blocks."""
    order: List[Tuple[Tuple[str, ...], bool]] = []
    conv_i = res_i = 0
    for stage, (_, n) in enumerate(((32, 0),) + _STAGES):
        order.append((("backbone", f"ConvBL_{conv_i}"), True))
        conv_i += 1
        for _ in range(n):
            for j in range(2):
                order.append((("backbone", f"Residual_{res_i}",
                               f"ConvBL_{j}"), True))
            res_i += 1
    k = d = 0           # ConvBL and raw detection Conv index in YoloV3
    for scale in range(3):
        for _ in range(6):                       # block5 and the head conv
            order.append(((f"ConvBL_{k}",), True))
            k += 1
        order.append(((f"Conv_{d}",), False))    # 1x1 detection conv
        d += 1
        if scale < 2:
            order.append(((f"ConvBL_{k}",), True))  # route conv
            k += 1
    return order


def load_darknet_weights(model: YoloV3, path: str) -> YoloV3:
    """Load the original darknet ``yolov3.weights`` into ``model`` in place.

    Binary layout (reference models.py load_darknet_weights): 5-int32
    header, then per conv block in cfg order [bn_bias, bn_scale, bn_mean,
    bn_var] (or the conv bias when the block has no BN), then the conv
    kernel in OIHW. Every float is consumed once, or this raises."""
    with open(path, "rb") as f:
        np.fromfile(f, np.int32, 5)
        blob = torch.from_numpy(np.fromfile(f, np.float32))
    ptr = 0

    def take(like: torch.Tensor) -> torch.Tensor:
        nonlocal ptr
        n = like.numel()
        if ptr + n > len(blob):
            raise ValueError(f"weights file exhausted at {ptr} (+{n})")
        ptr += n
        return blob[ptr - n:ptr].view_as(like)

    with torch.no_grad():
        for _, blk in model.conv_blocks():
            if blk.bn is not None:
                for t in (blk.bn.bias, blk.bn.weight, blk.bn.running_mean,
                          blk.bn.running_var):
                    t.copy_(take(t))
            else:
                blk.conv.bias.copy_(take(blk.conv.bias))
            blk.conv.weight.copy_(take(blk.conv.weight))
    if ptr != len(blob):
        raise ValueError(f"{len(blob) - ptr} unconsumed weights — "
                         "architecture/cfg mismatch")
    return model


def load_yolov3(path: str, device) -> YoloV3:
    """The detector with the weights of ``path``: a darknet ``.weights``
    binary, or an npz of the JAX variables (``params`` and
    ``batch_stats``); float32, eval mode, on ``device``."""
    model = YoloV3()
    if path.endswith(".npz"):
        from c2m_tpu_torch.utils.convert import (read_variables_npz,
                                                 yolov3_from_jax)
        model.load_state_dict(yolov3_from_jax(read_variables_npz(path)))
    else:
        load_darknet_weights(model, path)
    return model.to(device).eval()
