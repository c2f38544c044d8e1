"""Sparse (per-object) motion estimator — the "click" GNN.

Port of ``c2m_tpu/models/sparse_motion.py``: dense masked GATv2 over padded
nodes, one affine head per predicted frame, clicked nodes clamped to GT.
At inference the click mask is an input; the training forward draws it with
:func:`sample_click_indices`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from c2m_tpu_torch.config import SparseMotionEstimatorParams
from c2m_tpu_torch.nn.layers import BN_MOMENTUM, Dense, leaky
from c2m_tpu_torch.parallel import mesh


class MaskedBatchNorm1d(nn.Module):
    """BatchNorm over valid nodes only. Train mode: masked mean and (biased)
    variance over the valid nodes of the batch, the count floored at 1; the
    running variance takes the UNBIASED estimate (var·n/(n−1), as torch's
    BatchNorm1d does; unlike ``nn.layers.BatchNorm``), momentum 0.1. Eval
    mode uses the running statistics. Under a live process group the sums
    and the count are the global batch's (``parallel/mesh``), as in the
    JAX package under ``jit`` on a data mesh."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, N, C]; mask [B, N]."""
        if self.training:
            m = mask[..., None].to(x.dtype)
            total, count = (x * m).sum(dim=(0, 1)), m.sum()
            if mesh.is_live():
                total, count = mesh.global_sums(total, count)
            count = count.clamp_min(1.0)
            mean = total / count
            spread = ((x - mean).square() * m).sum(dim=(0, 1))
            var = mesh.global_sum(spread) / count
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.running_mean.lerp_(mean, BN_MOMENTUM)
                self.running_var.lerp_(unbiased, BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class DenseGATv2(nn.Module):
    """PyG ``GATv2Conv(F, F, heads, concat=False, add_self_loops=False)`` as
    dense masked attention: e_ij = a_h · leaky(W_l x_j + W_r x_i),
    softmax over j, mean over heads, + bias."""

    def __init__(self, in_features: int, features: int, heads: int = 4):
        super().__init__()
        self.heads, self.features = heads, features
        self.lin_l = Dense(in_features, heads * features)
        self.lin_r = Dense(in_features, heads * features)
        self.att = nn.Parameter(torch.empty(heads, features))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.xavier_uniform_(self.att)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x [B, N, F]; adj [B, N(i), N(j)] bool, True where edge j -> i."""
        b, n, _ = x.shape
        h, f = self.heads, self.features
        gl = self.lin_l(x).reshape(b, n, h, f)                   # source j
        gr = self.lin_r(x).reshape(b, n, h, f)                   # target i
        s = leaky(gr[:, :, None] + gl[:, None, :, :])            # [B,i,j,h,f]
        e = torch.einsum("bijhf,hf->bijh", s, self.att)
        e = torch.where(adj[..., None], e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e, dim=2)
        out = torch.einsum("bijh,bjhf->bihf", alpha, gl).mean(dim=2)
        out = out + self.bias
        row_has_edge = adj.any(dim=2)[..., None]
        return torch.where(row_has_edge, out, torch.zeros_like(out))


def build_adjacency(node_mask: torch.Tensor) -> torch.Tensor:
    """Fully connected within a graph, no self loops; a single-node graph
    gets a self loop (reference cityscapes.py:173-175)."""
    _, n = node_mask.shape
    valid = node_mask.bool()
    pair = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)[None]
    single = (valid.sum(dim=1) == 1)[:, None, None]
    return torch.where(single, pair & eye & valid[:, :, None], pair & ~eye)


class AffineHead(nn.Module):
    """fc_loc: Linear -> leaky -> Linear(6), zero weights, identity bias."""

    def __init__(self, h_dim: int):
        super().__init__()
        self.fc1 = Dense(h_dim, h_dim)
        self.fc2 = Dense(h_dim, 6)
        with torch.no_grad():
            self.fc2.weight.zero_()
            self.fc2.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))

    def forward(self, x):
        return self.fc2(leaky(self.fc1(x)))


class SparseMotionEstimator(nn.Module):
    def __init__(self, p: SparseMotionEstimatorParams,
                 num_predicted_frames: int, scene_features: int = 128):
        super().__init__()
        h = p.h_dim
        self.num_predicted_frames = num_predicted_frames
        self.x_enc1 = Dense(p.num_features_x, h // 2)
        self.x_enc2 = Dense(h // 2, h)
        self.scene_fc1 = Dense(h + scene_features, scene_features // 2)
        self.scene_bn1 = MaskedBatchNorm1d(scene_features // 2)
        self.scene_fc2 = Dense(scene_features // 2, h * 2)
        self.scene_bn2 = MaskedBatchNorm1d(h * 2)
        self.scene_fc3 = Dense(h * 2, h)
        for t in range(num_predicted_frames):
            self.add_module(f"gat_{t}", DenseGATv2(h, h, heads=p.num_head))
            self.add_module(f"loc_{t}", AffineHead(h))

    def forward(self, x_nodes: torch.Tensor, scene_feat: torch.Tensor,
                targets_theta: torch.Tensor, node_mask: torch.Tensor,
                click_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x_nodes [B, N, 23]; scene_feat [B, N, S]; targets_theta
        [B, N, T, 6]; node_mask, click_mask [B, N] -> {"thetas": [B,N,T,6]}."""
        u = click_mask[..., None].to(x_nodes.dtype)
        xm = self.x_enc2(leaky(self.x_enc1(x_nodes)))
        z = self.scene_fc1(torch.cat([xm, scene_feat], dim=-1))
        z = leaky(self.scene_bn1(z, node_mask))
        z = leaky(self.scene_bn2(self.scene_fc2(z), node_mask))
        x = self.scene_fc3(z)
        adj = build_adjacency(node_mask)
        thetas = []
        for t in range(self.num_predicted_frames):
            x = getattr(self, f"gat_{t}")(x, adj)
            theta_t = getattr(self, f"loc_{t}")(x)
            thetas.append(theta_t * (1.0 - u) + targets_theta[:, :, t] * u)
        return {"thetas": torch.stack(thetas, dim=2)}


def sample_click_indices(num_real_nodes: torch.Tensor, n_max: int,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One random real node per graph as the user's click: idx =
    floor(U·n) clipped to n−1, U uniform from ``generator`` (a generator on
    the CPU; the draw is moved to the nodes' device). Returns (indices [B],
    click_mask [B, N] float32, zero rows for graphs without real nodes)."""
    b = num_real_nodes.shape[0]
    dev = num_real_nodes.device
    uni = torch.rand(b, generator=generator).to(dev)
    n = num_real_nodes.to(torch.float32)
    idx = torch.floor(uni * n.clamp_min(1.0)).long()
    idx = torch.minimum(idx, (num_real_nodes.long() - 1).clamp_min(0))
    mask = torch.nn.functional.one_hot(idx, n_max).to(torch.float32)
    return idx, mask * (num_real_nodes > 0)[:, None].to(torch.float32)
