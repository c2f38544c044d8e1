# Frozen copy of c2m_tpu_torch/models/appearance.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Appearance encoder: conv pyramid + per-object ROI features.

Port of ``c2m_tpu/models/appearance.py`` (reference
appearance_encoder.py:8-79), eval mode.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from perfbench.reference.config import AppearanceEncoderParams
from perfbench.reference.nn.layers import Dense, DownBlock2d, SameBlock2d
from perfbench.reference.ops.roi import roi_align


def level_features(p: AppearanceEncoderParams, i: int) -> int:
    """Channels of pyramid level i."""
    return min(p.max_expansion, p.block_expansion * (2 ** i))


class AppearanceEncoder(nn.Module):
    def __init__(self, p: AppearanceEncoderParams, in_features: int,
                 input_size: Sequence[int]):
        super().__init__()
        self.p = p
        prev = in_features
        for i in range(p.num_down_blocks):
            f = level_features(p, i)
            self.add_module(f"down_{i}", DownBlock2d(
                prev, f, kernel_size=4, strides=2, padding=1,
                padding_mode=p.padding_mode))
            prev = f
        roi_out = p.block_expansion * (2 ** p.pooling_after)
        self.roi_conv = SameBlock2d(level_features(p, p.pooling_after - 1),
                                    roi_out * 2, kernel_size=p.pool_size,
                                    strides=1, padding=0,
                                    padding_mode=p.padding_mode,
                                    use_norm=False)
        self.roi_fc = Dense(roi_out * 2, roi_out * 2)
        self.roi_regressor = Dense(roi_out * 2, roi_out)
        down = 2 ** p.num_down_blocks
        scene = prev * (input_size[0] // down) * (input_size[1] // down)
        self.fuse_appearance_roi = Dense(scene + roi_out, roi_out)

    def forward(self, first_frame: torch.Tensor, rois_padded: torch.Tensor,
                node_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """first_frame [B, H, W, C_in]; rois_padded [B, N, 4] (x1, y1, x2, y2
        pixels); node_mask [B, N] -> enco{i}, app_encoded, objects_feature."""
        p = self.p
        out: Dict[str, torch.Tensor] = {}
        x = first_frame
        for i in range(p.num_down_blocks):
            x = getattr(self, f"down_{i}")(x)
            out["app_encoded" if i == p.num_down_blocks - 1 else f"enco{i}"] = x

        feats = out[f"enco{p.pooling_after - 1}"]
        pooled = roi_align(feats.float(), rois_padded.float(),
                           output_size=p.pool_size,
                           spatial_scale=1.0 / (2 ** p.pooling_after))
        b, n = pooled.shape[:2]
        pooled = pooled.reshape(b * n, p.pool_size, p.pool_size, -1).to(
            feats.dtype)
        obj = self.roi_conv(pooled).reshape(b * n, -1)   # 1x1 spatial: NHWC
        obj = self.roi_regressor(self.roi_fc(obj))
        # NHWC flatten of the bottleneck, as the JAX package's weights expect
        scene = out["app_encoded"].reshape(b, -1)
        scene_rep = scene[:, None, :].expand(b, n, scene.shape[-1]).reshape(
            b * n, -1)
        fused = self.fuse_appearance_roi(
            torch.cat([scene_rep.to(obj.dtype), obj], dim=-1))
        out["objects_feature"] = (fused.reshape(b, n, -1)
                                  * node_mask[..., None].to(fused.dtype))
        return out
