"""The training step (port of ``c2m_tpu/train/step.py``).

One combined scalar — the weighted generator objective plus
0.5·(d_real + d_fake) per discriminator — and one ``backward()``
differentiate like the reference's three ``.backward()`` calls into shared
gradient buffers (``.detach()`` marks the detach points inside the model).
Then all four Adam groups step and the per-group MultiStepLR advances.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.train.model import (total_discriminator_loss,
                                       total_generator_loss)
from c2m_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def combined_loss(cfg: Config, loss_dict, loss_dis_image, loss_dis_video):
    """-> (the scalar to differentiate, the metrics dict of the JAX train
    step: every generator term, ``total_gen`` and, per discriminator that is
    on, ``total_*_dis``, ``d_real_*``, ``d_fake_*``)."""
    total_gen = total_generator_loss(cfg, loss_dict)
    total_di = total_discriminator_loss(loss_dis_image)
    total_dv = total_discriminator_loss(loss_dis_video)
    metrics = dict(loss_dict)
    metrics["total_gen"] = total_gen
    if loss_dis_image:
        metrics["total_image_dis"] = total_di
        metrics["d_real_image"] = loss_dis_image["d_real"]
        metrics["d_fake_image"] = loss_dis_image["d_fake"]
    if loss_dis_video:
        metrics["total_video_dis"] = total_dv
        metrics["d_real_video"] = loss_dis_video["d_real"]
        metrics["d_fake_video"] = loss_dis_video["d_fake"]
    return total_gen + total_di + total_dv, metrics


def make_train_step(cfg: Config) -> Callable:
    def train_step(state: TrainState, batch: Batch,
                   eps: Optional[torch.Tensor] = None,
                   click_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (tensors on the model's device).
        Updates ``state`` in place (parameters, running statistics, spectral
        ``u``, optimizer, scheduler, step count) and returns the metrics as
        detached scalars. ``eps`` / ``click_mask`` replace the draws from
        ``state.generator``."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        _, loss_dict, ldi, ldv = state.model(batch, eps, click_mask,
                                             state.generator)
        total, metrics = combined_loss(cfg, loss_dict, ldi, ldv)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: Config) -> Callable:
    """Forward-only loss evaluation: no optimizer, eval-mode norms (running
    statistics, stored spectral ``u``), nothing updated."""
    def eval_step(state: TrainState, batch: Batch,
                  eps: Optional[torch.Tensor] = None,
                  click_mask: Optional[torch.Tensor] = None):
        state.model.eval()
        with torch.no_grad():
            out, loss_dict, _, _ = state.model(batch, eps, click_mask,
                                               state.generator)
        return out, loss_dict

    return eval_step
