"""FlowNet2 (Ilg et al., CVPR 2017) in plain PyTorch, as NVIDIA's
flownet2-pytorch publishes it (``models.py``, class ``FlowNet2``;
``networks/flownet_c.py``, ``flownet_s.py``, ``flownet_sd.py``,
``flownet_fusion.py``, ``submodules.py``), with C2M's wrapper around it
(upstream C2M ``src/modules/third_party/flow_net/flow_net.py``): the
benchmark's reference for the port's ``c2m_tpu_torch/models/flownet2.py``.
It imports nothing of the port.

Layout NCHW inside, as upstream; every convolution is ``F.conv2d`` or
``F.conv_transpose2d``, in float32 unless a compute dtype is set
(:func:`use_compute_dtype`, the precision control). Module names are
upstream's, so a state_dict of either side loads into the other.

Departures from the published code, none of which changes a value:
- the correlation and the channel norm are the plain loops of
  ``reference/ops/correlation.py`` in place of the CUDA extensions, and
  resample2d is ``reference/ops/warp.resample_pixel`` (x + fx, border
  clamp) on a channels-last view;
- batch norm is left out: FlowNet2 as C2M builds it has ``batchNorm``
  false, so every conv has a bias and no norm;
- the sub-networks return their finest flow alone (upstream's eval-mode
  tuple, of which FlowNet2 takes element 0);
- the inputs of :func:`compute_flow_and_conf` are channels-last pairs of
  frames [B, H, W, 3], and so are its outputs, as C2M's wrapper hands
  them on; the confidence is C2M's forward splat
  (``reference/ops/splat.occlusion_map``, its plain version).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.ops.correlation import channel_norm, correlation
from perfbench.reference.ops.splat import occlusion_map
from perfbench.reference.ops.warp import resample_pixel, resize_bilinear


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` through ``F.conv2d``, in ``compute_dtype`` when set
    (operands cast at use, output back to float32)."""
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding).float()


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` through ``F.conv_transpose2d``, likewise."""
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding).float()


def use_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every convolution under ``module`` computes in ``dtype``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype
    return module


def conv(in_planes: int, out_planes: int, kernel_size: int = 3,
         stride: int = 1) -> nn.Sequential:
    """submodules.py ``conv`` without batch norm: conv + LeakyReLU(0.1)."""
    return nn.Sequential(
        Conv2d(in_planes, out_planes, kernel_size, stride,
               (kernel_size - 1) // 2, bias=True),
        nn.LeakyReLU(0.1))


def i_conv(in_planes: int, out_planes: int) -> nn.Sequential:
    """submodules.py ``i_conv``: a bare 3x3 conv with a bias."""
    return nn.Sequential(Conv2d(in_planes, out_planes, 3, 1, 1, bias=True))


def predict_flow(in_planes: int) -> Conv2d:
    return Conv2d(in_planes, 2, 3, 1, 1, bias=True)


def deconv(in_planes: int, out_planes: int) -> nn.Sequential:
    """ConvTranspose2d(4, 2, 1) + LeakyReLU(0.1)."""
    return nn.Sequential(
        ConvTranspose2d(in_planes, out_planes, 4, 2, 1, bias=True),
        nn.LeakyReLU(0.1))


def up_flow(bias: bool = True) -> ConvTranspose2d:
    return ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


class FlowNetC(nn.Module):
    """networks/flownet_c.py."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv3 = conv(128, 256, 5, 2)
        self.conv_redir = conv(256, 32, 1, 1)
        self.conv3_1 = conv(473, 256)
        self.conv4 = conv(256, 512, stride=2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, stride=2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, stride=2)
        self.conv6_1 = conv(1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        self.upsampled_flow6_to_5 = up_flow()
        self.upsampled_flow5_to_4 = up_flow()
        self.upsampled_flow4_to_3 = up_flow()
        self.upsampled_flow3_to_2 = up_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[:, 0:3], x[:, 3:]
        out_conv2a = self.conv2(self.conv1(x1))
        out_conv3a = self.conv3(out_conv2a)
        out_conv3b = self.conv3(self.conv2(self.conv1(x2)))
        out_corr = F.leaky_relu(correlation(out_conv3a, out_conv3b, 20, 2),
                                0.1)
        out_conv_redir = self.conv_redir(out_conv3a)
        out_conv3_1 = self.conv3_1(torch.cat((out_conv_redir, out_corr), 1))
        out_conv4 = self.conv4_1(self.conv4(out_conv3_1))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return _decode(self, out_conv6, out_conv5, out_conv4, out_conv3_1,
                       out_conv2a)


def _decode(net, out_conv6, out_conv5, out_conv4, out_conv3, out_conv2):
    """The refinement of flownet_c.py and flownet_s.py, levels 6 -> 2."""
    concat = out_conv6
    for level, skip in ((6, out_conv5), (5, out_conv4), (4, out_conv3),
                        (3, out_conv2)):
        flow = getattr(net, f"predict_flow{level}")(concat)
        flow_up = getattr(net, f"upsampled_flow{level}_to_{level - 1}")(flow)
        out_deconv = getattr(net, f"deconv{level - 1}")(concat)
        concat = torch.cat((skip, out_deconv, flow_up), 1)
    return net.predict_flow2(concat)


class FlowNetS(nn.Module):
    """networks/flownet_s.py; its flow upsamplers have no bias."""

    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = conv(input_channels, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv3 = conv(128, 256, 5, 2)
        self.conv3_1 = conv(256, 256)
        self.conv4 = conv(256, 512, stride=2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, stride=2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, stride=2)
        self.conv6_1 = conv(1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        self.upsampled_flow6_to_5 = up_flow(bias=False)
        self.upsampled_flow5_to_4 = up_flow(bias=False)
        self.upsampled_flow4_to_3 = up_flow(bias=False)
        self.upsampled_flow3_to_2 = up_flow(bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return _decode(self, out_conv6, out_conv5, out_conv4, out_conv3,
                       out_conv2)


class FlowNetSD(nn.Module):
    """networks/flownet_sd.py."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv(6, 64)
        self.conv1 = conv(64, 64, stride=2)
        self.conv1_1 = conv(64, 128)
        self.conv2 = conv(128, 128, stride=2)
        self.conv2_1 = conv(128, 128)
        self.conv3 = conv(128, 256, stride=2)
        self.conv3_1 = conv(256, 256)
        self.conv4 = conv(256, 512, stride=2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, stride=2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, stride=2)
        self.conv6_1 = conv(1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.inter_conv5 = i_conv(1026, 512)
        self.inter_conv4 = i_conv(770, 256)
        self.inter_conv3 = i_conv(386, 128)
        self.inter_conv2 = i_conv(194, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(512)
        self.predict_flow4 = predict_flow(256)
        self.predict_flow3 = predict_flow(128)
        self.predict_flow2 = predict_flow(64)
        self.upsampled_flow6_to_5 = up_flow()
        self.upsampled_flow5_to_4 = up_flow()
        self.upsampled_flow4_to_3 = up_flow()
        self.upsampled_flow3_to_2 = up_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        flow = self.predict_flow6(out_conv6)
        concat = out_conv6
        for level, skip in ((6, out_conv5), (5, out_conv4), (4, out_conv3),
                            (3, out_conv2)):
            flow_up = getattr(self, f"upsampled_flow{level}_to_{level - 1}")(
                flow)
            out_deconv = getattr(self, f"deconv{level - 1}")(concat)
            concat = torch.cat((skip, out_deconv, flow_up), 1)
            out_interconv = getattr(self, f"inter_conv{level - 1}")(concat)
            flow = getattr(self, f"predict_flow{level - 1}")(out_interconv)
        return flow


class FlowNetFusion(nn.Module):
    """networks/flownet_fusion.py."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv(11, 64)
        self.conv1 = conv(64, 64, stride=2)
        self.conv1_1 = conv(64, 128)
        self.conv2 = conv(128, 128, stride=2)
        self.conv2_1 = conv(128, 128)
        self.deconv1 = deconv(128, 32)
        self.deconv0 = deconv(162, 16)
        self.inter_conv1 = i_conv(162, 32)
        self.inter_conv0 = i_conv(82, 16)
        self.predict_flow2 = predict_flow(128)
        self.predict_flow1 = predict_flow(32)
        self.predict_flow0 = predict_flow(16)
        self.upsampled_flow2_to_1 = up_flow()
        self.upsampled_flow1_to_0 = up_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        flow2 = self.predict_flow2(out_conv2)
        flow2_up = self.upsampled_flow2_to_1(flow2)
        out_deconv1 = self.deconv1(out_conv2)
        concat1 = torch.cat((out_conv1, out_deconv1, flow2_up), 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        flow1_up = self.upsampled_flow1_to_0(flow1)
        out_deconv0 = self.deconv0(concat1)
        concat0 = torch.cat((out_conv0, out_deconv0, flow1_up), 1)
        return self.predict_flow0(self.inter_conv0(concat0))


def _resample2d(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """resample2d on NCHW through the channels-last plain warp."""
    return resample_pixel(image.permute(0, 2, 3, 1).contiguous(),
                          flow.permute(0, 2, 3, 1).contiguous()
                          ).permute(0, 3, 1, 2)


class FlowNet2(nn.Module):
    """models.py ``FlowNet2``: inputs [B, 3, 2, H, W] (two RGB frames, H and
    W multiples of 64) -> the fused flow [B, 2, H, W]."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rgb_mean = inputs.contiguous().view(inputs.size()[:2] + (-1,)).mean(
            dim=-1).view(inputs.size()[:2] + (1, 1, 1))
        x = (inputs - rgb_mean) / self.rgb_max
        x1, x2 = x[:, :, 0], x[:, :, 1]
        x = torch.cat((x1, x2), dim=1)

        def up4(f, mode):
            return F.interpolate(f, scale_factor=4, mode=mode,
                                 **({"align_corners": False}
                                    if mode == "bilinear" else {}))

        flownetc_flow = up4(self.flownetc(x) * self.div_flow, "bilinear")
        resampled_img1 = _resample2d(x[:, 3:], flownetc_flow)
        norm_diff_img0 = channel_norm(x[:, :3] - resampled_img1)
        concat1 = torch.cat((x, resampled_img1, flownetc_flow / self.div_flow,
                             norm_diff_img0), dim=1)
        flownets1_flow = up4(self.flownets_1(concat1) * self.div_flow,
                             "bilinear")
        resampled_img1 = _resample2d(x[:, 3:], flownets1_flow)
        norm_diff_img0 = channel_norm(x[:, :3] - resampled_img1)
        concat2 = torch.cat((x, resampled_img1, flownets1_flow / self.div_flow,
                             norm_diff_img0), dim=1)
        flownets2_flow = up4(self.flownets_2(concat2) * self.div_flow,
                             "nearest")
        norm_flownets2_flow = channel_norm(flownets2_flow)
        diff_flownets2_img1 = channel_norm(
            x[:, :3] - _resample2d(x[:, 3:], flownets2_flow))
        # upstream divides FlowNetSD's flow by div_flow (models.py:151)
        flownetsd_flow = up4(self.flownets_d(x) / self.div_flow, "nearest")
        norm_flownetsd_flow = channel_norm(flownetsd_flow)
        diff_flownetsd_img1 = channel_norm(
            x[:, :3] - _resample2d(x[:, 3:], flownetsd_flow))
        concat3 = torch.cat((x[:, :3], flownetsd_flow, flownets2_flow,
                             norm_flownetsd_flow, norm_flownets2_flow,
                             diff_flownetsd_img1, diff_flownets2_img1), dim=1)
        return self.flownetfusion(concat3)


def compute_flow_and_conf(model: FlowNet2, im1: torch.Tensor,
                          im2: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C2M's wrapper (flow_net.py): frames [B, H, W, 3] -> the flow
    [B, H, W, 2] and its confidence [B, H, W, 1]. Frames whose sides are no
    multiple of 64 are resized down to one first, and the flow and
    confidence back after, the flow's magnitude scaled by the heights'
    ratio."""
    old = tuple(im1.shape[1:3])
    new = (max(old[0] // 64 * 64, 64), max(old[1] // 64 * 64, 64))
    im1 = resize_bilinear(im1, new, align_corners=False)
    im2 = resize_bilinear(im2, new, align_corners=False)
    inputs = torch.stack((im1, im2), dim=-1).permute(0, 3, 4, 1, 2)
    flow = model(inputs).permute(0, 2, 3, 1).contiguous()
    conf = occlusion_map(flow)
    if old != new:
        flow = resize_bilinear(flow, old, align_corners=False) * (
            old[0] / new[0])
        conf = resize_bilinear(conf, old, align_corners=False)
    return flow, conf
