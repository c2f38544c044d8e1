"""FlowNet2 (C + S1 + S2 + SD + Fusion): port of
``c2m_tpu/models/flownet2.py``, the frozen optical-flow network behind
on-the-fly flow for training.

Layout NHWC at every public function, as the JAX package; LeakyReLU(0.1)
convs; ``ConvTranspose2d(4, 2, 1)`` deconvs; no batch norm. The three CUDA
extensions of the reference map to
  correlation -> ``ops.correlation.correlation`` (kernel K5),
  resample2d  -> ``ops.warp.resample_pixel`` (plain PyTorch),
  channelnorm -> ``ops.correlation.channel_norm``,
and the confidence of :func:`compute_flow_and_conf` is the forward splat
(kernel K4).

Spans (``trace``; recorded only under a profiler): ``c2m.flow.inference``
around :func:`compute_flow_and_conf`, ``c2m.flow.conf`` around its splat and
resizes; ``c2m.flownet.c``, ``.s1``, ``.s2``, ``.sd`` and ``.fusion`` around
the five sub-networks; ``c2m.flownet.correlation`` around the cost volume,
counting ``bytes`` (both feature maps read, the volume written) and
``flops`` (2 x C for each pixel and displacement that stays inside the
map: the others are zeros); ``c2m.flownet.warp`` around each of the
four warps with its channel norm, counting ``bytes`` (both images and the
flow read, the warped image and the norm written); ``c2m.flownet.deconv``
around each transposed convolution.

Module names are the reference torch checkpoint's, so its ``state_dict``
loads as it is: ``<net>.<layer>.0.{weight,bias}`` for conv + LeakyReLU and
deconv + LeakyReLU blocks, ``<net>.predict_flowX.*`` and
``<net>.upsampled_flowX_to_Y.*`` for the bare layers. ``JAX_NAMES`` gives
the names the same layers have in the JAX tree (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from c2m_tpu_torch import trace
from c2m_tpu_torch.nn.layers import Conv
from c2m_tpu_torch.ops.correlation import channel_norm, correlation
from c2m_tpu_torch.ops.splat import occlusion_map
from c2m_tpu_torch.ops.warp import (resample_pixel, resize_bilinear,
                                    resize_nearest)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(in_features: int, features: int, kernel: int = 3, stride: int = 1
          ) -> Conv:
    return Conv(in_features, features, kernel, stride, (kernel - 1) // 2,
                "zeros")


class Deconv(nn.ConvTranspose2d):
    """torch ``ConvTranspose2d(k=4, s=2, p=1)`` on NHWC. Parameters:
    ``weight`` [in, out, 4, 4], ``bias`` [out] or none."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__(in_features, features, 4, stride=2, padding=1,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("c2m.flownet.deconv"):
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                                   self.bias, stride=2, padding=1)
            return y.permute(0, 2, 3, 1)


class _Block(nn.Sequential):
    """One layer + LeakyReLU(0.1) (or none), kept a Sequential so that the
    layer's key is ``<name>.0.*`` as in the reference checkpoint; the JAX
    tree has no such level."""
    JAX_NAMES = {"0": None}

    def __init__(self, layer: nn.Module, act: bool = True):
        super().__init__(layer)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self[0](x)
        return _leaky(y) if self.act else y


def ConvL(in_features: int, features: int, kernel: int = 3, stride: int = 1,
          act: bool = True) -> _Block:
    """conv(pad (k-1)//2) + LeakyReLU(0.1) (submodules.py conv())."""
    return _Block(_conv(in_features, features, kernel, stride), act)


def DeconvL(in_features: int, features: int) -> _Block:
    """ConvTranspose2d(4, 2, 1) + LeakyReLU(0.1) (submodules.py deconv())."""
    return _Block(Deconv(in_features, features))


def _up_flow_names(levels) -> dict:
    return {f"upsampled_flow{i}_to_{i - 1}": f"up_flow{i}" for i in levels}


class _Refinement(nn.Module):
    """The decoder FlowNetS and FlowNetC share (levels 6 -> 2): predict a
    flow, upsample it and the features, concatenate with the skip."""
    JAX_NAMES = _up_flow_names(range(3, 7))

    def _make_decoder(self, skips: Tuple[int, int, int, int],
                      up_flow_bias: bool) -> None:
        """skips: channels of the conv5, conv4, conv3, conv2 skips."""
        self.deconv5 = DeconvL(1024, 512)
        self.deconv4 = DeconvL(skips[0] + 512 + 2, 256)
        self.deconv3 = DeconvL(skips[1] + 256 + 2, 128)
        self.deconv2 = DeconvL(skips[2] + 128 + 2, 64)
        self.predict_flow6 = _conv(1024, 2)
        self.predict_flow5 = _conv(skips[0] + 512 + 2, 2)
        self.predict_flow4 = _conv(skips[1] + 256 + 2, 2)
        self.predict_flow3 = _conv(skips[2] + 128 + 2, 2)
        self.predict_flow2 = _conv(skips[3] + 64 + 2, 2)
        for i in range(3, 7):
            self.add_module(f"upsampled_flow{i}_to_{i - 1}",
                            Deconv(2, 2, bias=up_flow_bias))

    def _decode(self, c6, c5, c4, c3, c2) -> torch.Tensor:
        cat = c6
        for level, skip in ((6, c5), (5, c4), (4, c3), (3, c2)):
            flow = getattr(self, f"predict_flow{level}")(cat)
            up = getattr(self, f"upsampled_flow{level}_to_{level - 1}")(flow)
            deconv = getattr(self, f"deconv{level - 1}")(cat)
            cat = torch.cat([skip, deconv, up], dim=-1)
        return self.predict_flow2(cat)


class FlowNetS(_Refinement):
    """networks/flownet_s.py: plain encoder-decoder refinement net. Its
    ``upsampled_flowX_to_Y`` layers have no bias (flownet_s.py:57-64)."""

    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = ConvL(input_channels, 64, 7, 2)
        self.conv2 = ConvL(64, 128, 5, 2)
        self.conv3 = ConvL(128, 256, 5, 2)
        self.conv3_1 = ConvL(256, 256)
        self.conv4 = ConvL(256, 512, 3, 2)
        self.conv4_1 = ConvL(512, 512)
        self.conv5 = ConvL(512, 512, 3, 2)
        self.conv5_1 = ConvL(512, 512)
        self.conv6 = ConvL(512, 1024, 3, 2)
        self.conv6_1 = ConvL(1024, 1024)
        self._make_decoder((512, 512, 256, 128), up_flow_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self._decode(c6, c5, c4, c3, c2)


class FlowNetC(_Refinement):
    """networks/flownet_c.py: siamese encoder + correlation cost volume."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvL(3, 64, 7, 2)
        self.conv2 = ConvL(64, 128, 5, 2)
        self.conv3 = ConvL(128, 256, 5, 2)
        self.conv_redir = ConvL(256, 32, 1, 1)
        self.conv3_1 = ConvL(32 + 441, 256)
        self.conv4 = ConvL(256, 512, 3, 2)
        self.conv4_1 = ConvL(512, 512)
        self.conv5 = ConvL(512, 512, 3, 2)
        self.conv5_1 = ConvL(512, 512)
        self.conv6 = ConvL(512, 1024, 3, 2)
        self.conv6_1 = ConvL(1024, 1024)
        self._make_decoder((512, 512, 256, 128), up_flow_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[..., :3], x[..., 3:]
        # the last concat takes conv2 of the FIRST image (flownet_c.py:152),
        # not of the merged stream
        c2a = self.conv2(self.conv1(x1))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x2))).contiguous()
        c3a = c3a.contiguous()
        with trace.span("c2m.flownet.correlation"):
            corr = correlation(c3a, c3b, max_displacement=20, stride=2)
            trace.count("bytes", 2 * c3a.numel() * c3a.element_size()
                        + corr.numel() * corr.element_size())
            bsz, h, w, c = c3a.shape
            trace.count("flops", 2 * c * bsz * _inside(h) * _inside(w))
        corr = _leaky(corr)
        redir = self.conv_redir(c3a)
        c3_1 = self.conv3_1(torch.cat([redir, corr.to(redir.dtype)], dim=-1))
        c4 = self.conv4_1(self.conv4(c3_1))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self._decode(c6, c5, c4, c3_1, c2a)


def _inside(n: int, max_displacement: int = 20, stride: int = 2) -> int:
    """The (position, displacement) pairs of one axis of n positions whose
    displaced position stays inside it: the cost volume's entries that need
    a channel product (the others are zeros)."""
    return sum(max(0, n - abs(d))
               for d in range(-max_displacement, max_displacement + 1, stride))


class FlowNetSD(nn.Module):
    """networks/flownet_sd.py: small-displacement net with inter convs."""
    JAX_NAMES = _up_flow_names(range(3, 7))

    def __init__(self):
        super().__init__()
        self.conv0 = ConvL(6, 64)
        self.conv1 = ConvL(64, 64, 3, 2)
        self.conv1_1 = ConvL(64, 128)
        self.conv2 = ConvL(128, 128, 3, 2)
        self.conv2_1 = ConvL(128, 128)
        self.conv3 = ConvL(128, 256, 3, 2)
        self.conv3_1 = ConvL(256, 256)
        self.conv4 = ConvL(256, 512, 3, 2)
        self.conv4_1 = ConvL(512, 512)
        self.conv5 = ConvL(512, 512, 3, 2)
        self.conv5_1 = ConvL(512, 512)
        self.conv6 = ConvL(512, 1024, 3, 2)
        self.conv6_1 = ConvL(1024, 1024)
        self.deconv5 = DeconvL(1024, 512)
        self.deconv4 = DeconvL(1026, 256)
        self.deconv3 = DeconvL(770, 128)
        self.deconv2 = DeconvL(386, 64)
        self.inter_conv5 = ConvL(1026, 512, act=False)
        self.inter_conv4 = ConvL(770, 256, act=False)
        self.inter_conv3 = ConvL(386, 128, act=False)
        self.inter_conv2 = ConvL(194, 64, act=False)
        self.predict_flow6 = _conv(1024, 2)
        self.predict_flow5 = _conv(512, 2)
        self.predict_flow4 = _conv(256, 2)
        self.predict_flow3 = _conv(128, 2)
        self.predict_flow2 = _conv(64, 2)
        for i in range(3, 7):
            self.add_module(f"upsampled_flow{i}_to_{i - 1}", Deconv(2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flow = self.predict_flow6(c6)
        cat = c6
        for level, skip in ((6, c5), (5, c4), (4, c3), (3, c2)):
            up = getattr(self, f"upsampled_flow{level}_to_{level - 1}")(flow)
            deconv = getattr(self, f"deconv{level - 1}")(cat)
            cat = torch.cat([skip, deconv, up], dim=-1)
            inter = getattr(self, f"inter_conv{level - 1}")(cat)
            flow = getattr(self, f"predict_flow{level - 1}")(inter)
        return flow


class FlowNetFusion(nn.Module):
    """networks/flownet_fusion.py: full-resolution fusion of SD + S2 flows."""
    JAX_NAMES = _up_flow_names(range(1, 3))

    def __init__(self):
        super().__init__()
        self.conv0 = ConvL(11, 64)
        self.conv1 = ConvL(64, 64, 3, 2)
        self.conv1_1 = ConvL(64, 128)
        self.conv2 = ConvL(128, 128, 3, 2)
        self.conv2_1 = ConvL(128, 128)
        self.deconv1 = DeconvL(128, 32)
        self.deconv0 = DeconvL(162, 16)
        self.inter_conv1 = ConvL(162, 32, act=False)
        self.inter_conv0 = ConvL(82, 16, act=False)
        self.predict_flow2 = _conv(128, 2)
        self.predict_flow1 = _conv(32, 2)
        self.predict_flow0 = _conv(16, 2)
        self.upsampled_flow2_to_1 = Deconv(2, 2)
        self.upsampled_flow1_to_0 = Deconv(2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        cat1 = torch.cat([c1, self.deconv1(c2),
                          self.upsampled_flow2_to_1(flow2)], dim=-1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        cat0 = torch.cat([c0, self.deconv0(cat1),
                          self.upsampled_flow1_to_0(flow1)], dim=-1)
        return self.predict_flow0(self.inter_conv0(cat0))


def _up4_bilinear(f: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(f, (f.shape[1] * 4, f.shape[2] * 4),
                           align_corners=False)


def _up4_nearest(f: torch.Tensor) -> torch.Tensor:
    return resize_nearest(f, (f.shape[1] * 4, f.shape[2] * 4))


class FlowNet2(nn.Module):
    """The full stacked network (models.py:20-172). Input: two RGB frames
    [B, H, W, 3] each (H, W divisible by 64); output flow [B, H, W, 2]."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def _refine_input(self, x, x1, x2, flow_up) -> torch.Tensor:
        warped, diff = _warp_and_norm(x1, x2, flow_up)
        return torch.cat([x, warped, flow_up / self.div_flow, diff], dim=-1)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        # per-pair, per-channel mean normalization (models.py:119-123)
        mean = torch.stack([im1, im2], dim=1).mean(dim=(1, 2, 3), keepdim=True)
        x1 = (im1 - mean[:, 0]) / self.rgb_max
        x2 = (im2 - mean[:, 0]) / self.rgb_max
        x = torch.cat([x1, x2], dim=-1)

        with trace.span("c2m.flownet.c"):
            flowc = self.flownetc(x)
        flowc_up = _up4_bilinear(flowc * self.div_flow)
        refine1 = self._refine_input(x, x1, x2, flowc_up)
        with trace.span("c2m.flownet.s1"):
            flows1 = self.flownets_1(refine1)
        flows1_up = _up4_bilinear(flows1 * self.div_flow)
        refine2 = self._refine_input(x, x1, x2, flows1_up)
        with trace.span("c2m.flownet.s2"):
            flows2 = self.flownets_2(refine2)
        flows2_up = _up4_nearest(flows2 * self.div_flow)
        norm_s2 = channel_norm(flows2_up)
        diff_s2 = _warp_and_norm(x1, x2, flows2_up)[1]
        with trace.span("c2m.flownet.sd"):
            flowsd = self.flownets_d(x)
        # flowsd / div_flow is the reference's own (models.py:151)
        flowsd_up = _up4_nearest(flowsd / self.div_flow)
        norm_sd = channel_norm(flowsd_up)
        diff_sd = _warp_and_norm(x1, x2, flowsd_up)[1]
        fused = torch.cat(
            [x1, flowsd_up, flows2_up, norm_sd, norm_s2, diff_sd, diff_s2],
            dim=-1)
        with trace.span("c2m.flownet.fusion"):
            return self.flownetfusion(fused)


def _warp_and_norm(x1: torch.Tensor, x2: torch.Tensor, flow: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 warped by ``flow`` (resample2d) and the channel norm of x1 minus
    it (channelnorm), in the span ``c2m.flownet.warp``."""
    with trace.span("c2m.flownet.warp"):
        warped = resample_pixel(x2, flow)
        norm = channel_norm(x1 - warped)
        trace.count("bytes", sum(t.numel() * t.element_size()
                                 for t in (x1, x2, flow, warped, norm)))
    return warped, norm


def compute_flow_and_conf(model: nn.Module, im1: torch.Tensor,
                          im2: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FlowNet wrapper semantics (flow_net.py:54-95): resize to a multiple
    of 64, run, confidence = forward-splat occlusion of the flow, resize
    back with the height-ratio magnitude rescale. Spans
    ``c2m.flow.inference`` around the call and ``c2m.flow.conf`` around the
    splat and the resizes back."""
    with trace.span("c2m.flow.inference"):
        old = tuple(im1.shape[1:3])
        new = (max(old[0] // 64 * 64, 64), max(old[1] // 64 * 64, 64))
        if old != new:
            im1 = resize_bilinear(im1, new, align_corners=False)
            im2 = resize_bilinear(im2, new, align_corners=False)
        flow = model(im1, im2)
        with trace.span("c2m.flow.conf"):
            conf = occlusion_map(flow.contiguous())
            if old != new:
                flow = resize_bilinear(flow, old, align_corners=False) * (
                    old[0] / new[0])
                conf = resize_bilinear(conf, old, align_corners=False)
        return flow, conf
