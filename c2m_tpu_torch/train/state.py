"""Train state: one model, four Adam parameter groups with per-group
MultiStepLR (port of ``c2m_tpu/train/state.py``).

Groups, chosen by parameter path:
  gen      ``c2m.*`` outside the GNN (appearance encoder, dense motion
           network, generator)                      lr_rate_g,   gamma_g
  gnn      anything under ``sparse_motion_estimator``  lr_rate_gnn, gamma_gnn
  d_image  ``netd_image.*``                          lr_rate_d,   gamma_d
  d_video  ``netd_video.*``                          lr_rate_d,   gamma_d
  frozen   VGG19 (``requires_grad=False``), in no group.

One ``torch.optim.Adam`` holds the four groups (betas (beta1, beta2), eps
from the config; bias-corrected, eps added outside the square root, as
optax's ``adam``; ``tests/test_torch_train_step.py`` checks the agreement
over two steps). The reference steps its MultiStepLR once per epoch with
milestones in epochs; here the scheduler steps once per train step, with
the milestones converted to step boundaries by ``steps_per_epoch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.parallel import mesh
from c2m_tpu_torch.train.model import C2MTrainModel

GROUPS = ("gen", "gnn", "d_image", "d_video")


def param_group(name: str) -> str:
    """Optimizer group of a parameter of ``C2MTrainModel`` by its name."""
    top = name.split(".")[0]
    if top == "c2m":
        return "gnn" if "sparse_motion_estimator" in name.split(".") else "gen"
    return {"netd_image": "d_image", "netd_video": "d_video"}.get(top, "frozen")


def grouped_parameters(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        g = param_group(name)
        if g != "frozen" and p.requires_grad:
            groups[g].append(p)
    return groups


def multistep_factor(gamma: float, milestones_epochs, steps_per_epoch: int):
    """torch MultiStepLR as an lr factor per step: gamma^(#boundaries <= step),
    boundaries = milestone epochs x steps_per_epoch."""
    boundaries = sorted({int(m * steps_per_epoch) for m in milestones_epochs})

    def factor(step: int) -> float:
        return gamma ** sum(1 for b in boundaries if step >= b)
    return factor


@dataclasses.dataclass
class TrainState:
    model: C2MTrainModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator          # draws the VAE noise and the clicks
    step: int = 0


def build_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int = 1):
    tp = cfg.train_params
    groups = grouped_parameters(model)
    lr = {"gen": (tp.lr_rate_g, tp.gamma_g), "gnn": (tp.lr_rate_gnn, tp.gamma_gnn),
          "d_image": (tp.lr_rate_d, tp.gamma_d),
          "d_video": (tp.lr_rate_d, tp.gamma_d)}
    names = [g for g in GROUPS if groups[g]]
    optimizer = torch.optim.Adam(
        [{"params": groups[g], "lr": lr[g][0], "name": g} for g in names],
        betas=(tp.beta1, tp.beta2), eps=float(tp.eps))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [multistep_factor(lr[g][1], tp.milestones, steps_per_epoch)
                    for g in names])
    return optimizer, scheduler


def create_train_state(cfg: Config, seed: Optional[int] = None, device=None,
                       steps_per_epoch: int = 1) -> TrainState:
    """A ``C2MTrainModel(cfg)`` in train mode on
    ``device`` (the card when None; an error without one) with its
    optimizer, scheduler and a CPU ``torch.Generator`` seeded with ``seed``
    (default ``train_params.seed``). Weights are drawn on the CPU from that
    seed before the model moves, so a seed gives the same weights on any
    device; under a process group every rank then takes rank 0's."""
    device = resolve_device(device)
    seed = cfg.train_params.seed if seed is None else seed
    generator = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = C2MTrainModel(cfg)
    model = model.to(device).train()
    mesh.broadcast_state(model)             # rank 0's, under a process group
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch)
    return TrainState(model, optimizer, scheduler, generator)
