"""SiamRPN++ single-object tracker, the tracker of the preprocessing chain:
the port of ``c2m_tpu/models/siamrpn.py``.

Reference: pysot (SenseTime), config siamrpn_r50_l234_dwxcorr: the atrous
ResNet-50 backbone (pysot/models/backbone/resnet_atrous.py, with its
quirks: conv1 7x7 stride 2 padding 0; ``padding = 2 - stride`` in a
bottleneck; layers 3 and 4 at stride 1 with dilation 2 and 4, the first
block's dilation halved; a 3x3 downsample wherever stride or dilation is
not 1), the AdjustAllLayer neck with its 7x7 centre crop of the template
(neck.py:22-26), the MultiRPN heads over the depthwise cross-correlation
with softmax weights (head/rpn.py:54-121, core/xcorr.py:39-48) and the
SiamRPNTracker's scale, ratio and window penalties
(tracker/siamrpn_tracker.py).

The submodules carry pysot's checkpoint names (``backbone.layer3.0.
downsample.0.weight``, ``neck.downsample2.downsample.1.running_var``,
``rpn_head.rpn4.loc.head.3.bias``, ``rpn_head.cls_weight``), the names
``tools/convert_siamrpn.py`` reads, so the pysot checkpoint loads with
``load_state_dict(strict=True)``; ``utils/convert.siamrpn_from_jax`` loads
the JAX package's npz. ``features`` and ``heads`` take and return
channels-last tensors, as the JAX methods do; NCHW inside. The depthwise
cross-correlation folds the batch into the channels of one grouped conv,
as pysot does.

The tracker keeps its state on the host in numpy and repeats the JAX
tracker's numpy arithmetic; the template features stay on the net's
device, and each frame makes one ``features`` and one ``heads`` call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Backbone: atrous ResNet-50
# ---------------------------------------------------------------------------

class _ConvBN(nn.Sequential):
    """conv (no bias) + BatchNorm, indices 0 and 1 (pysot's downsample)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, features, kernel, stride, padding,
                      dilation, bias=False),
            nn.BatchNorm2d(features))


class Bottleneck(nn.Module):
    """resnet_atrous.py:62-111 with its stride / dilation / padding quirks."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        d = dilation
        padding = 2 - stride
        if has_downsample and d > 1:
            d = d // 2
            padding = d
        if d > 1:
            padding = d
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding, d,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if has_downsample:
            if stride == 1 and dilation == 1:
                self.downsample = _ConvBN(in_channels, planes * 4, 1, stride)
            else:
                dd, pad = ((dilation // 2, dilation // 2) if dilation > 1
                           else (1, 0))
                self.downsample = _ConvBN(in_channels, planes * 4, 3, stride,
                                          pad, dd)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet50Atrous(nn.Module):
    """NCHW image -> the outputs of ``used_layers`` (0: conv1, 1-4: the
    layers)."""

    def __init__(self, used_layers: Sequence[int] = (2, 3, 4)):
        super().__init__()
        self.used_layers = tuple(used_layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for i, (planes, blocks, stride, dilation) in enumerate(
                ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2),
                 (512, 3, 1, 4)), start=1):
            layer = [Bottleneck(inplanes, planes, stride, dilation,
                                has_downsample=True)]
            layer += [Bottleneck(planes * 4, planes, 1, dilation)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))
            inplanes = planes * 4

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        # max_pool2d pads with -inf
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return [feats[i] for i in self.used_layers]


# ---------------------------------------------------------------------------
# Neck + RPN heads
# ---------------------------------------------------------------------------

class AdjustLayer(nn.Module):
    """1x1 conv + BN; a map narrower than 20 (the template's) is cropped
    to its centre ``center_size`` x ``center_size``."""

    def __init__(self, in_channels: int, features: int, center_size: int = 7):
        super().__init__()
        self.center_size = center_size
        self.downsample = _ConvBN(in_channels, features, 1)

    def forward(self, x):
        x = self.downsample(x)
        if x.shape[3] < 20:
            l = (x.shape[3] - self.center_size) // 2
            x = x[:, :, l:l + self.center_size, l:l + self.center_size]
        return x


class AdjustAllLayer(nn.Module):
    """pysot's neck: ``downsample{2,3,4}``, one AdjustLayer per feature."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: Sequence[int] = (256, 256, 256)):
        super().__init__()
        for i, (c_in, c_out) in enumerate(zip(in_channels, out_channels)):
            setattr(self, f"downsample{i + 2}", AdjustLayer(c_in, c_out))

    def forward(self, feats):
        return [getattr(self, f"downsample{i + 2}")(f)
                for i, f in enumerate(feats)]


def xcorr_depthwise(search: torch.Tensor, kernel: torch.Tensor
                    ) -> torch.Tensor:
    """Per-sample depthwise cross-correlation (core/xcorr.py:39-48), NCHW:
    search [B, C, H, W], kernel [B, C, h, w] -> [B, C, H-h+1, W-w+1], the
    batch folded into the channels of one grouped conv."""
    b, c = kernel.shape[:2]
    out = F.conv2d(search.reshape(1, b * c, *search.shape[2:]),
                   kernel.reshape(b * c, 1, *kernel.shape[2:]), groups=b * c)
    return out.reshape(b, c, *out.shape[2:])


class DepthwiseXCorr(nn.Module):
    def __init__(self, in_channels: int, hidden: int, out_channels: int):
        super().__init__()
        self.conv_kernel = nn.Sequential(*_ConvBN(in_channels, hidden, 3),
                                         nn.ReLU())
        self.conv_search = nn.Sequential(*_ConvBN(in_channels, hidden, 3),
                                         nn.ReLU())
        self.head = nn.Sequential(*_ConvBN(hidden, hidden, 1), nn.ReLU(),
                                  nn.Conv2d(hidden, out_channels, 1))

    def forward(self, kernel, search):
        return self.head(xcorr_depthwise(self.conv_search(search),
                                         self.conv_kernel(kernel)))


class DepthwiseRPN(nn.Module):
    def __init__(self, anchor_num: int = 5, in_channels: int = 256,
                 out_channels: int = 256):
        super().__init__()
        self.cls = DepthwiseXCorr(in_channels, out_channels, 2 * anchor_num)
        self.loc = DepthwiseXCorr(in_channels, out_channels, 4 * anchor_num)

    def forward(self, z_f, x_f):
        return self.cls(z_f, x_f), self.loc(z_f, x_f)


class MultiRPN(nn.Module):
    """``rpn{2,3,4}`` and the softmax-weighted sum of their outputs."""

    def __init__(self, anchor_num: int, in_channels: Sequence[int]):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"rpn{i + 2}", DepthwiseRPN(anchor_num, c, c))
        self.cls_weight = nn.Parameter(torch.ones(len(in_channels)))
        self.loc_weight = nn.Parameter(torch.ones(len(in_channels)))

    def forward(self, zf, xf):
        cls_all, loc_all = [], []
        for i, (z, x) in enumerate(zip(zf, xf)):
            c, l = getattr(self, f"rpn{i + 2}")(z, x)
            cls_all.append(c)
            loc_all.append(l)
        cw = F.softmax(self.cls_weight, 0)
        lw = F.softmax(self.loc_weight, 0)
        cls = sum(c * w for c, w in zip(cls_all, cw))
        loc = sum(l * w for l, w in zip(loc_all, lw))
        return cls, loc


class SiamRPNpp(nn.Module):
    """Backbone + neck + weighted MultiRPN (model_builder.py:18-66)."""

    def __init__(self, anchor_num: int = 5,
                 adjust_channels: Sequence[int] = (256, 256, 256)):
        super().__init__()
        self.backbone = ResNet50Atrous()
        self.neck = AdjustAllLayer((512, 1024, 2048), adjust_channels)
        self.rpn_head = MultiRPN(anchor_num, adjust_channels)

    def features(self, img: torch.Tensor) -> List[torch.Tensor]:
        """[B, H, W, 3] -> the neck's three maps, channels last."""
        feats = self.neck(self.backbone(img.permute(0, 3, 1, 2)))
        return [f.permute(0, 2, 3, 1) for f in feats]

    def heads(self, zf: List[torch.Tensor], xf: List[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Template and search features (channels last) -> (cls [B, H, W,
        2A], loc [B, H, W, 4A])."""
        def nchw(fs):
            return [f.permute(0, 3, 1, 2) for f in fs]
        cls, loc = self.rpn_head(nchw(zf), nchw(xf))
        return cls.permute(0, 2, 3, 1), loc.permute(0, 2, 3, 1)

    def forward(self, template, search):
        return self.heads(self.features(template), self.features(search))


# ---------------------------------------------------------------------------
# Tracker (host-side numpy port of tracker/siamrpn_tracker.py)
# ---------------------------------------------------------------------------

@dataclass
class TrackConfig:
    penalty_k: float = 0.05
    window_influence: float = 0.42
    lr: float = 0.38
    exemplar_size: int = 127
    instance_size: int = 255
    base_size: int = 8
    context_amount: float = 0.5
    stride: int = 8
    ratios: Tuple[float, ...] = (0.33, 0.5, 1, 2, 3)
    scales: Tuple[int, ...] = (8,)


def generate_anchors(cfg: TrackConfig, score_size: int) -> np.ndarray:
    """pysot/utils/anchor.py + tracker.generate_anchor."""
    anchors = []
    size = cfg.stride * cfg.stride
    for r in cfg.ratios:
        ws = int(np.sqrt(size / r))
        hs = int(ws * r)
        for s in cfg.scales:
            w, h = ws * s, hs * s
            anchors.append([0.0, 0.0, float(w), float(h)])
    anchor = np.array(anchors, np.float32)
    anchor = np.tile(anchor, score_size * score_size).reshape((-1, 4))
    ori = -(score_size // 2) * cfg.stride
    xx, yy = np.meshgrid([ori + cfg.stride * dx for dx in range(score_size)],
                         [ori + cfg.stride * dy for dy in range(score_size)])
    num = len(cfg.ratios) * len(cfg.scales)
    anchor[:, 0] = np.tile(xx.flatten(), (num, 1)).flatten()
    anchor[:, 1] = np.tile(yy.flatten(), (num, 1)).flatten()
    return anchor


def get_subwindow(im: np.ndarray, pos, model_sz: int, original_sz: int,
                  avg_chans) -> np.ndarray:
    """Padded square crop + resize (base_tracker.py:38-95), PIL bilinear
    in place of cv2.resize, as the JAX package has it."""
    from PIL import Image
    sz = int(original_sz)
    im_h, im_w = im.shape[:2]
    c = (original_sz + 1) / 2
    xmin = int(np.floor(pos[0] - c + 0.5))
    ymin = int(np.floor(pos[1] - c + 0.5))
    xmax = xmin + sz - 1
    ymax = ymin + sz - 1
    left = max(0, -xmin)
    top = max(0, -ymin)
    right = max(0, xmax - im_w + 1)
    bottom = max(0, ymax - im_h + 1)
    if any((left, top, right, bottom)):
        padded = np.zeros((im_h + top + bottom, im_w + left + right, 3),
                          im.dtype)
        padded[top:top + im_h, left:left + im_w] = im
        padded[:top] = avg_chans
        padded[top + im_h:] = avg_chans
        padded[:, :left] = avg_chans
        padded[:, left + im_w:] = avg_chans
        patch = padded[ymin + top:ymax + top + 1, xmin + left:xmax + left + 1]
    else:
        patch = im[ymin:ymax + 1, xmin:xmax + 1]
    if patch.shape[0] != model_sz:
        patch = np.asarray(Image.fromarray(patch.astype(np.uint8)).resize(
            (model_sz, model_sz), Image.BILINEAR))
    return patch.astype(np.float32)


class SiamRPNTracker:
    """One object's tracker around a ``SiamRPNpp`` that already holds its
    weights, on its device. After each ``track`` call, ``best`` is the
    anchor it picked and ``pscore`` the penalized scores it picked it from
    (for the comparisons of the tests and of chip_smoke.py)."""

    def __init__(self, model: SiamRPNpp, cfg: TrackConfig = None):
        self.cfg = cfg or TrackConfig()
        c = self.cfg
        self.score_size = ((c.instance_size - c.exemplar_size) // c.stride
                           + 1 + c.base_size)
        self.anchor_num = len(c.ratios) * len(c.scales)
        hanning = np.hanning(self.score_size)
        self.window = np.tile(np.outer(hanning, hanning).flatten(),
                              self.anchor_num)
        self.anchors = generate_anchors(c, self.score_size)
        self.model = model
        self.device = next(model.parameters()).device
        self.zf = None
        self.best, self.pscore = None, None

    @torch.no_grad()
    def _features(self, patch: np.ndarray) -> List[torch.Tensor]:
        return self.model.features(
            torch.from_numpy(patch)[None].to(self.device))

    def init(self, img: np.ndarray, bbox) -> None:
        c = self.cfg
        self.center_pos = np.array([bbox[0] + (bbox[2] - 1) / 2,
                                    bbox[1] + (bbox[3] - 1) / 2])
        self.size = np.array([bbox[2], bbox[3]], np.float64)
        w_z = self.size[0] + c.context_amount * self.size.sum()
        h_z = self.size[1] + c.context_amount * self.size.sum()
        s_z = round(np.sqrt(w_z * h_z))
        self.channel_average = img.mean(axis=(0, 1))
        z = get_subwindow(img, self.center_pos, c.exemplar_size, s_z,
                          self.channel_average)
        self.zf = self._features(z)

    def track(self, img: np.ndarray) -> Dict:
        c = self.cfg
        w_z = self.size[0] + c.context_amount * self.size.sum()
        h_z = self.size[1] + c.context_amount * self.size.sum()
        s_z = np.sqrt(w_z * h_z)
        scale_z = c.exemplar_size / s_z
        s_x = s_z * (c.instance_size / c.exemplar_size)
        x = get_subwindow(img, self.center_pos, c.instance_size, round(s_x),
                          self.channel_average)
        with torch.no_grad():
            cls, loc = self.model.heads(self.zf, self._features(x))
        cls = cls[0].cpu().numpy()
        loc = loc[0].cpu().numpy()

        # scores: [H, W, 2A] -> softmax over the 2-way fg/bg split; channel
        # k of the channels-last map is torch's channel k of [2A, H, W]
        h, w = cls.shape[:2]
        a = self.anchor_num
        cls_t = cls.transpose(2, 0, 1).reshape(2, a, h, w)
        score = np.exp(cls_t[1]) / (np.exp(cls_t[0]) + np.exp(cls_t[1]))
        score = score.reshape(-1)

        loc = loc.transpose(2, 0, 1).reshape(4, a, h, w)
        delta = loc.reshape(4, -1)
        pred = np.empty_like(delta)
        pred[0] = delta[0] * self.anchors[:, 2] + self.anchors[:, 0]
        pred[1] = delta[1] * self.anchors[:, 3] + self.anchors[:, 1]
        pred[2] = np.exp(delta[2]) * self.anchors[:, 2]
        pred[3] = np.exp(delta[3]) * self.anchors[:, 3]

        def change(r):
            return np.maximum(r, 1.0 / r)

        def sz(w_, h_):
            pad = (w_ + h_) * 0.5
            return np.sqrt((w_ + pad) * (h_ + pad))

        s_c = change(sz(pred[2], pred[3])
                     / sz(self.size[0] * scale_z, self.size[1] * scale_z))
        r_c = change((self.size[0] / self.size[1]) / (pred[2] / pred[3]))
        penalty = np.exp(-(r_c * s_c - 1) * c.penalty_k)
        pscore = penalty * score
        pscore = (pscore * (1 - c.window_influence)
                  + self.window * c.window_influence)
        best = int(np.argmax(pscore))
        self.best, self.pscore = best, pscore

        bbox = pred[:, best] / scale_z
        lr = penalty[best] * score[best] * c.lr
        cx = bbox[0] + self.center_pos[0]
        cy = bbox[1] + self.center_pos[1]
        width = self.size[0] * (1 - lr) + bbox[2] * lr
        height = self.size[1] * (1 - lr) + bbox[3] * lr
        cx = max(0, min(cx, img.shape[1]))
        cy = max(0, min(cy, img.shape[0]))
        width = max(10, min(width, img.shape[1]))
        height = max(10, min(height, img.shape[0]))
        self.center_pos = np.array([cx, cy])
        self.size = np.array([width, height])
        return {"bbox": [cx - width / 2, cy - height / 2, width, height],
                "best_score": float(score[best])}
