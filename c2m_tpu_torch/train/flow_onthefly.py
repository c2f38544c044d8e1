"""On-the-fly optical flow for training (``use_pre_processed_of: false``):
port of ``c2m_tpu/train/flow_onthefly.py``.

Per batch, the frozen FlowNet2 computes the forward flow between
consecutive input frames (the conditioning stream) and the forward and
backward flow between the last input frame and every predicted frame (the
supervision targets); the occlusion is the confidence splat of the FlowNet
wrapper. Frames are scaled to [-1, 1] first (the reference does
``video * 2 - 1``). All 2 * T_out + T_in - 1 frame pairs of a batch go
through FlowNet2 in one call, without gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.models.flownet2 import FlowNet2, compute_flow_and_conf
from c2m_tpu_torch.utils.convert import flownet2_from_jax


def _load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's converted parameter tree (``.npz`` with one
    ``params`` entry) -> the port's ``state_dict``."""
    with np.load(path, allow_pickle=True) as data:
        return flownet2_from_jax(data["params"].item())


class OnTheFlyFlow:
    """``OnTheFlyFlow(t_in, t_out)(video)`` -> the batch's flow entries.

    ``weights_path``: the ``.npz`` the JAX package reads, its converted
    parameter tree (the reference torch checkpoint itself loads into
    ``self.model`` with ``load_state_dict``: the keys are its own); without
    it the weights are PyTorch's default init from seed 0. ``device=None``
    means the card, and an error where there is none; ``"cpu"`` must be
    asked for."""

    def __init__(self, num_input_frames: int, num_predicted_frames: int,
                 weights_path: Optional[str] = None, device=None):
        self.t_in = num_input_frames
        self.t_out = num_predicted_frames
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.model = FlowNet2()
        if weights_path:
            self.model.load_state_dict(_load_weights(weights_path))
        self.model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """video [B, T, H, W, 3] in [0, 1] -> ``target_bw_of`` /
        ``target_fw_of`` [B, T_out, H, W, 2], ``target_bw_occ`` /
        ``target_fw_occ`` [B, T_out, H, W, 1] and, with more than one input
        frame, ``input_of`` / ``input_occ`` [B, T_in - 1, ...]."""
        t_in, t_out = self.t_in, self.t_out
        v = video.to(self.device, torch.float32) * 2.0 - 1.0
        bsz = v.shape[0]
        src = v[:, t_in - 1]
        # one (a, b) pair per required flow: the input stream's forward
        # flows, then source -> target and target -> source per target
        a = ([v[:, i] for i in range(t_in - 1)] + [src] * t_out
             + [v[:, t_in + i] for i in range(t_out)])
        b = ([v[:, i + 1] for i in range(t_in - 1)]
             + [v[:, t_in + i] for i in range(t_out)] + [src] * t_out)
        flow, conf = compute_flow_and_conf(self.model, torch.cat(a, dim=0),
                                           torch.cat(b, dim=0))

        def grab(x, start, count):
            x = x[start * bsz:(start + count) * bsz]
            return x.reshape(count, bsz, *x.shape[1:]).transpose(0, 1) \
                .contiguous()

        out: Dict[str, torch.Tensor] = {}
        if t_in > 1:
            out["input_of"] = grab(flow, 0, t_in - 1)
            out["input_occ"] = grab(conf, 0, t_in - 1)
        fw, bw = t_in - 1, t_in - 1 + t_out
        # naming per the reference: the confidence returned with the forward
        # flow supervises the BACKWARD occlusion and vice versa
        # (trainer.py:63-87: fw_flow pairs with bw_conf)
        out["target_bw_of"] = grab(flow, bw, t_out)
        out["target_bw_occ"] = grab(conf, fw, t_out)
        out["target_fw_of"] = grab(flow, fw, t_out)
        out["target_fw_occ"] = grab(conf, bw, t_out)
        return out
