# Frozen copy of c2m_tpu_torch/train/model.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Full training model: generator stack + discriminators + frozen VGG (port
of ``c2m_tpu/train/model.py``, folded path).

The reference's torch class owns four optimizers and calls ``.backward()``
three times, the gradients of the discriminator losses AND of the
generator's GAN terms (which flow through the discriminators' parameters:
the reference does not detach D there) accumulating before any optimizer
steps. One combined scalar with ``.detach()`` exactly at the reference's
detach points gives the same gradients from one ``backward()``; the train
step (``train/step.py``) builds that scalar from what this module returns.

Each discriminator runs three times per step, in this order: on the real
clip, on the detached fake, on the attached fake. In train mode each pass
updates its BatchNorm running statistics and advances the spectral-norm
power iteration, three times per discriminator per step, as in the JAX
package. The frame-chunked loss tail of the JAX package (``scan_frames``)
was a memory lever for its hardware and is not carried over.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from perfbench.reference.config import Config
from perfbench.reference.losses.losses import (feature_matching_loss, gan_mse_loss,
                                         training_losses)
from perfbench.reference.models.c2m import DTYPES, C2MGenerator
from perfbench.reference.models.discriminator import MultiScaleDiscriminator
from perfbench.reference.nn.layers import fold_time, use_compute_dtype
from perfbench.reference.nn.vgg import Vgg19Features, load_vgg19_params

Batch = Dict[str, torch.Tensor]
Losses = Dict[str, torch.Tensor]


class C2MTrainModel(nn.Module):
    """Children ``c2m``, ``netd_image``, ``netd_video``, ``vgg``: the
    optimizer groups are chosen by these names (``train/state.py``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        tp = cfg.train_params
        dp = cfg.model_params.discriminator
        self.c2m = C2MGenerator(cfg)
        if tp.use_image_discriminator:
            self.netd_image = MultiScaleDiscriminator(dp, dp.in_channel)
        if tp.use_video_discriminator:
            self.netd_video = MultiScaleDiscriminator(
                dp, dp.in_channel * tp.num_frames)
        if tp.loss_weights.perceptual > 0:
            self.vgg = Vgg19Features()
            pretrained = load_vgg19_params()
            if pretrained is not None:
                self.vgg.load_state_dict(pretrained)
        self.use_compute_dtype(DTYPES[tp.dtype])

    def use_compute_dtype(self, dtype: torch.dtype) -> "C2MTrainModel":
        """Conv compute in ``dtype`` for the generator stack, the
        discriminators and VGG; parameters, BatchNorm statistics and the
        spectral ``u`` stay float32, and the loss reductions accumulate in
        float32."""
        self.c2m.use_compute_dtype(dtype)
        for name in ("netd_image", "netd_video", "vgg"):
            if hasattr(self, name):
                use_compute_dtype(getattr(self, name), dtype)
        return self

    def _gan_losses(self, netd: nn.Module, real: torch.Tensor,
                    fake: torch.Tensor):
        """D on real, D on detached fake, D on attached fake; LSGAN +
        feature matching. The attached pass is NOT shielded from D's
        parameters: its gradient reaches them, as in the reference."""
        pred_real = netd(real)
        pred_fake_det = netd(fake.detach())
        d_real = gan_mse_loss(pred_real["prediction_map_0"], True)
        d_fake = gan_mse_loss(pred_fake_det["prediction_map_0"], False)
        pred_fake = netd(fake)
        g_gan = gan_mse_loss(pred_fake["prediction_map_0"], True)
        fm = feature_matching_loss(pred_real["feature_maps_0"],
                                   pred_fake["feature_maps_0"])
        return d_real, d_fake, g_gan, fm

    def forward(self, batch: Batch, eps: Optional[torch.Tensor] = None,
                click_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], Losses, Losses, Losses]:
        """-> (outputs, generator losses, image-D losses, video-D losses);
        the norms follow ``self.training``; ``eps``, ``click_mask`` and
        ``generator`` as in ``C2MGenerator.forward``."""
        tp = self.cfg.train_params
        out = self.c2m(batch, eps, click_mask, generator)
        vgg = self.vgg if tp.loss_weights.perceptual > 0 else None
        loss_dict = training_losses(tp, batch, out, vgg)
        loss_dis_image: Losses = {}
        loss_dis_video: Losses = {}

        nif = tp.num_input_frames
        if tp.use_image_discriminator:
            real, _ = fold_time(batch["video"][:, nif:])
            fake, _ = fold_time(out["generated"])
            d_real, d_fake, g_gan, fm = self._gan_losses(self.netd_image,
                                                         real, fake)
            loss_dict["g_gan_image"] = g_gan
            loss_dict["feature_matching_image"] = fm
            loss_dis_image = {"d_real": d_real, "d_fake": d_fake}
        if tp.use_video_discriminator:
            def chan_concat(v):        # [B, T, H, W, C] -> [B, H, W, T*C]
                return v.permute(0, 2, 3, 1, 4).reshape(
                    v.shape[0], v.shape[2], v.shape[3], -1)
            real = chan_concat(batch["video"])
            fake = torch.cat([chan_concat(batch["video"][:, :nif]),
                              chan_concat(out["generated"])], dim=-1)
            d_real, d_fake, g_gan, fm = self._gan_losses(self.netd_video,
                                                         real, fake)
            loss_dict["g_gan_video"] = g_gan
            loss_dict["feature_matching_video"] = fm
            loss_dis_video = {"d_real": d_real, "d_fake": d_fake}
        return out, loss_dict, loss_dis_image, loss_dis_video

    def inference(self, batch: Batch, z_m: torch.Tensor,
                  click_mask: torch.Tensor,
                  use_gt_eval: Optional[bool] = None):
        return self.c2m.inference(batch, z_m, click_mask, use_gt_eval)


def total_generator_loss(cfg: Config, loss_dict: Losses) -> torch.Tensor:
    """Weighted sum over ``loss_weights``."""
    w = cfg.train_params.loss_weights.as_dict()
    return sum(value * w[key] for key, value in loss_dict.items())


def total_discriminator_loss(loss_dis: Losses):
    """(d_real + d_fake) * 0.5; 0.0 for a discriminator that is off."""
    if not loss_dis:
        return 0.0
    return (loss_dis["d_real"] + loss_dis["d_fake"]) * 0.5
