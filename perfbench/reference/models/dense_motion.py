# Frozen copy of c2m_tpu_torch/models/dense_motion.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Dense motion network (port of ``c2m_tpu/models/dense_motion.py``).

``DenseMotionEncoder`` (the 3D-conv VAE encoder of the training forward,
with ``reparameterize``), ``SparseMotionFeatureEncoder`` (3D-conv pyramid
over the sparse flow) and the plain ``DenseMotionDecoder``: at each scale
the appearance skip is warped by the resized sparse flow and masked by the
resized sparse occlusion in one pass of kernel K1 (``resample_masked``,
whose image gradient reaches the appearance encoder in training). The
frame-scan and space-to-depth variants of the JAX package were memory and
layout rewrites of the same math for its own hardware.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from perfbench.reference.config import (DenseMotionDecoderParams,
                                  DenseMotionEncoderParams,
                                  SparseMotionEncoderParams)
from perfbench.reference.nn.layers import (Conv, Dense, DownBlock3d, InstanceNorm,
                                     SameBlock3d, UpBlock2d, fold_time, leaky,
                                     unfold_time)
from perfbench.reference.ops.warp import resample_masked, resize_bilinear, resize_flow


def sparse_level_features(p: SparseMotionEncoderParams, i: int) -> int:
    return min(p.max_expansion, p.block_expansion * (2 ** i))


class DenseMotionEncoder(nn.Module):
    """3D-conv VAE encoder (motion_autoencoder.py:11-59): one DownBlock3d
    per entry of the config's t/h/w kernel/stride/padding lists, then the
    linear heads ``fc_mu`` / ``fc_logvar`` (float32) on the NTHWC flatten of
    the last map, the order the JAX package's Dense kernels expect."""

    def __init__(self, p: DenseMotionEncoderParams, in_features: int,
                 output_channel: int, video_shape: Tuple[int, int, int]):
        """video_shape: (T, H, W) of the input clip, which fixes the
        flattened width of the linear heads."""
        super().__init__()
        self.num_blocks = len(p.t_kernel)
        prev, dims = in_features, list(video_shape)
        for i in range(self.num_blocks):
            f = min(p.max_expansion, p.block_expansion * (2 ** i))
            kernel = (p.t_kernel[i], p.h_kernel[i], p.w_kernel[i])
            stride = (p.t_stride[i], p.h_stride[i], p.w_stride[i])
            pad = (p.t_padding[i], p.h_padding[i], p.w_padding[i])
            self.add_module(f"down_{i}", DownBlock3d(
                prev, f, kernel, stride, pad, padding_mode=p.padding_mode))
            dims = [(d + 2 * q - k) // s + 1
                    for d, k, s, q in zip(dims, kernel, stride, pad)]
            prev = f
        flat = prev * dims[0] * dims[1] * dims[2]
        self.fc_mu = Dense(flat, output_channel)
        self.fc_logvar = Dense(flat, output_channel)

    def forward(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = video                                          # [B, T, H, W, C]
        for i in range(self.num_blocks):
            x = getattr(self, f"down_{i}")(x)
        flat = x.reshape(x.shape[0], -1).float()
        return {"mu": self.fc_mu(flat), "logvar": self.fc_logvar(flat)}


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VAE reparameterization mu + eps·exp(logvar/2); ``eps`` is given or
    drawn standard normal from ``generator`` (a CPU generator; the draw is
    moved to mu's device, so a seed gives the same noise on any device)."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype)
    return mu + eps.to(mu.device) * torch.exp(0.5 * logvar)


class SparseMotionFeatureEncoder(nn.Module):
    """3D-conv pyramid over the rasterized sparse flow (sparse_encoder.py)."""

    def __init__(self, p: SparseMotionEncoderParams):
        super().__init__()
        self.p = p
        prev = p.in_channel
        for i in range(p.num_down_blocks):
            f = sparse_level_features(p, i)
            self.add_module(f"down_{i}", DownBlock3d(
                prev, f, kernel_size=(3, 4, 4), strides=(1, 2, 2), padding=1,
                padding_mode=p.padding_mode))
            prev = f

    def forward(self, sparse_motion: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        x = sparse_motion                                  # [B, T, H, W, 2]
        for i in range(self.p.num_down_blocks):
            x = getattr(self, f"down_{i}")(x)
            out[f"enco_sparse_{i}"] = x
        return out


class PredictorHeads(nn.Module):
    """Flow + occlusion heads: one fused 32->64 ``block_conv`` split into the
    flow and occlusion halves (the JAX package's parameter layout)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.block_conv = Conv(in_features, 64, 3, 1, 1, "reflect")
        self.norm_flow = InstanceNorm(32)
        self.norm_occ = InstanceNorm(32)
        self.flow_head = Conv(32, 2, 3, 1, 1, "reflect")
        self.occ_head = Conv(32, 1, 3, 1, 1, "reflect")

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.block_conv(x)
        hf = leaky(self.norm_flow(h[..., :32]))
        ho = leaky(self.norm_occ(h[..., 32:]))
        return self.flow_head(hf), torch.sigmoid(self.occ_head(ho))


class DenseMotionDecoder(nn.Module):
    """Decode z -> per-frame dense flow + occlusion
    (motion_autoencoder.py:62-149), plain folded path."""

    def __init__(self, p: DenseMotionDecoderParams, num_predicted_frames: int,
                 sparse_p: SparseMotionEncoderParams,
                 app_features: Dict[str, int], z_features: int):
        """app_features: channels of each appearance level ``enco{i}``;
        z_features: channels of the motion code z."""
        super().__init__()
        self.p = p
        self.t = num_predicted_frames
        nb = p.num_up_blocks
        self.sparse_down = sparse_p.num_down_blocks
        cur = min(p.max_expansion, p.block_expansion * (2 ** nb))
        self.first = SameBlock3d(z_features, cur, 3, 1, 1,
                                 padding_mode=p.padding_mode)
        fuse_idx = 0
        for i in range(nb):
            f = min(p.max_expansion, p.block_expansion * (2 ** (nb - i - 1)))
            in_f = cur
            if i > 0 and p.use_appearance_feature:
                in_f += app_features[f"enco{nb - i}"]
            self.add_module(f"up_{i}", UpBlock2d(
                in_f, f, 3, 1, 1, padding_mode=p.padding_mode))
            cur = f
            if i >= nb - self.sparse_down:
                sp = sparse_level_features(sparse_p, nb - i - 1)
                self.add_module(f"fuse_{fuse_idx}", SameBlock3d(
                    f + sp, sp, 3, 1, 1, padding_mode=p.padding_mode))
                fuse_idx += 1
                cur = sp
        self.final_up = UpBlock2d(cur, p.out_channel, 3, 1, 1,
                                  padding_mode=p.padding_mode)
        self.final_fuse = SameBlock3d(p.out_channel + 2, p.out_channel, 3, 1,
                                      1, padding_mode=p.padding_mode)
        self.heads = PredictorHeads(p.out_channel)

    def forward(self, appearance: Dict[str, torch.Tensor],
                sparse_features: Dict[str, torch.Tensor],
                sparse_motion: torch.Tensor, sparse_occlusion: torch.Tensor,
                z: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.p
        t = self.t
        nb = p.num_up_blocks
        out = self.first(z)
        sm_flat, _ = fold_time(sparse_motion)            # [B*T, H, W, 2]
        so_flat, _ = fold_time(sparse_occlusion)         # [B*T, H, W, 1]
        fuse_idx = 0
        for i in range(nb):
            x, _ = fold_time(out)
            if i > 0 and p.use_appearance_feature:
                app = appearance[f"enco{nb - i}"]        # [B, h, w, C]
                b, ah, aw, ac = app.shape
                if p.use_feature_resample:
                    obj_motion = resize_flow(sm_flat, (ah, aw)).contiguous()
                    obj_occ = resize_bilinear(so_flat, (ah, aw),
                                              align_corners=False).contiguous()
                    # resample(app repeated T times, obj_motion) * obj_occ,
                    # fused (K1), reading the T frames from one image
                    app_rep = resample_masked(app.contiguous(),
                                              obj_motion.float(),
                                              obj_occ.float(), frames=t)
                else:
                    app_rep = app[:, None].expand(b, t, ah, aw, ac).reshape(
                        b * t, ah, aw, ac)
                if x.shape[1:3] != (ah, aw):
                    x = resize_bilinear(x, (ah, aw), align_corners=False)
                x = torch.cat([x, app_rep.to(x.dtype)], dim=-1)
            x = getattr(self, f"up_{i}")(x)
            out = unfold_time(x, t)
            if i >= nb - self.sparse_down:
                sp = sparse_features[f"enco_sparse_{nb - i - 1}"]
                sh, sw = sp.shape[2:4]
                if out.shape[2:4] != (sh, sw):
                    flat, _ = fold_time(out)
                    out = unfold_time(resize_bilinear(flat, (sh, sw)), t)
                out = getattr(self, f"fuse_{fuse_idx}")(
                    torch.cat([out, sp.to(out.dtype)], dim=-1))
                fuse_idx += 1

        x, _ = fold_time(out)
        out = unfold_time(self.final_up(x), t)
        out = self.final_fuse(torch.cat([out, sparse_motion.to(out.dtype)],
                                        dim=-1))
        flat, _ = fold_time(out)
        flow, occ = self.heads(flat)
        return {"dense_motion": unfold_time(flow.float(), t),
                "occlusion": unfold_time(occ.float(), t)}
