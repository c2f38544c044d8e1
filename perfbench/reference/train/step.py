# Frozen copy of c2m_tpu_torch/train/step.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""The training step (port of ``c2m_tpu/train/step.py``).

One combined scalar — the weighted generator objective plus
0.5·(d_real + d_fake) per discriminator — and one ``backward()``
differentiate like the reference's three ``.backward()`` calls into shared
gradient buffers (``.detach()`` marks the detach points inside the model).
Then all four Adam groups step and the per-group MultiStepLR advances.

Under a live process group (``parallel/mesh``, one rank per card) each
rank takes its share of the global batch: the VAE noise and the click
mask are drawn for the global batch from the generator every rank holds
alike, each rank takes its rows, the gradients are averaged over the
ranks once after the ``backward()``, and the metrics are the ranks'
mean, so that a step of W ranks is one step over their concatenated
batches (the norms' statistics are global inside the model).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from perfbench.reference.config import Config
from perfbench.reference.models.sparse_motion import sample_click_indices
from perfbench.reference import mesh
from perfbench.reference.train.model import (total_discriminator_loss,
                                       total_generator_loss)
from perfbench.reference.train.state import TrainState, grouped_parameters

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


def global_draws(cfg: Config, generator: torch.Generator,
                 num_real_nodes: torch.Tensor, n_max: int):
    """The VAE noise [b, z_dim] and the click mask [b, N] of this rank's
    rows, drawn for the global batch in the order the model's forward
    draws them (noise, then clicks); one process draws exactly what the
    forward would."""
    enc = cfg.model_params.motion_estimator.dense_motion_encoder
    num_real = mesh.gather_rows(num_real_nodes)
    eps = torch.randn((num_real.shape[0],
                       enc.out_channel_bg + enc.out_channel_fg),
                      generator=generator, dtype=torch.float32)
    _, click = sample_click_indices(num_real, n_max, generator)
    return (mesh.local_rows(eps).to(num_real_nodes.device),
            mesh.local_rows(click))


def make_train_step(cfg: Config) -> Callable:
    def train_step(state: TrainState, batch: Batch,
                   eps: Optional[torch.Tensor] = None,
                   click_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (tensors on the model's device).
        Updates ``state`` in place (parameters, running statistics, spectral
        ``u``, optimizer, scheduler, step count) and returns the metrics as
        detached scalars. ``eps`` / ``click_mask`` replace the draws from
        ``state.generator`` (:func:`global_draws`)."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if eps is None and click_mask is None:
            eps, click_mask = global_draws(cfg, state.generator,
                                           batch["num_real_nodes"],
                                           batch["node_mask"].shape[1])
        _, loss_dict, ldi, ldv = state.model(batch, eps, click_mask,
                                             state.generator)
        total, metrics = combined_loss(cfg, loss_dict, ldi, ldv)
        total.backward()
        if mesh.is_live():
            mesh.all_reduce_gradients(
                p for group in grouped_parameters(state.model).values()
                for p in group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return mesh.mean_metrics({k: v.detach() for k, v in metrics.items()})

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
