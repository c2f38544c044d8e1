"""Training objectives (port of ``c2m_tpu/losses/losses.py``; weights in the
YAML ``train_params.loss_weights``).

Plain functions on channels-last tensors; the perceptual loss takes the VGG
feature extractor as a callable. Quirks of the reference kept on purpose:
frames feed VGG in [0, 1] and the extractor ImageNet-normalizes them itself;
the theta losses are the GNN's only gradient path under
``use_gt_training``; L1-masked means divide by the full element count, not
the mask mass; every GAN loss reads the LAST batch element's patch map only
(:func:`gan_mse_loss`). ``.detach()`` stands where the JAX package has
``stop_gradient``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from c2m_tpu_torch.nn.layers import fold_time
from c2m_tpu_torch.ops.warp import resample
from c2m_tpu_torch.parallel import mesh

Taps = Dict[str, torch.Tensor]


def l1_masked(source: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.l1_loss(source*mask, target*mask): mean over ALL elements."""
    if mask is not None:
        source = source * mask
        target = target * mask
    return (source - target).abs().mean()


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """VAE KL normalized by numel."""
    kld = -0.5 * torch.sum(1.0 + logvar - mu.square() - logvar.exp())
    return kld / mu.numel()


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 unpadded average pool on [B, H, W, C]."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM)/2 clamped to [0, 1], mean. x, y: [B, T, H, W, C]."""
    return ssim_loss_folded(fold_time(x)[0], fold_time(y)[0])


def ssim_loss_folded(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ssim_loss on time-folded [B*T, H, W, C] frames."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = _avg_pool3(x), _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x ** 2
    sigma_y = _avg_pool3(y * y) - mu_y ** 2
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return ((1.0 - ssim_n / ssim_d) / 2.0).clamp(0.0, 1.0).mean()


def smooth_loss(flow: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order flow smoothness. flow [B, T, H, W, 2]; image
    [B, T, H, W, C]."""
    flow, _ = fold_time(flow)
    img, _ = fold_time(image)

    def grads(v, axis):
        if axis == "y":
            return v[:, :-1] - v[:, 1:]
        return v[:, :, :-1] - v[:, :, 1:]

    wx = torch.exp(-grads(img, "y").abs().mean(dim=-1, keepdim=True))
    wy = torch.exp(-grads(img, "x").abs().mean(dim=-1, keepdim=True))
    total = 0.0
    for i in range(2):
        f = flow[..., i:i + 1]
        total = total + ((grads(f, "y") * wx).abs().mean()
                         + (grads(f, "x") * wy).abs().mean())
    return total / 2.0


def flow_consistency_loss(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                          mask_fw: Optional[torch.Tensor],
                          mask_bw: Optional[torch.Tensor],
                          num_predicted_frames: int) -> torch.Tensor:
    """fw/bw cross-resampling consistency; each flow is both the image and
    the flow of a K1 warp, so both of K1's gradients are used."""
    f = fold_time(flow_fw)[0].contiguous()
    b = fold_time(flow_bw)[0].contiguous()
    nextloss = (resample(b, f) + f).abs()
    prevloss = (resample(f, b) + b).abs()
    if mask_fw is not None:
        nextloss = fold_time(mask_fw)[0] * nextloss
        prevloss = fold_time(mask_bw)[0] * prevloss
    return (prevloss.mean() + nextloss.mean()) * num_predicted_frames


def perceptual_loss(vgg: Callable[[torch.Tensor], Taps], gt: torch.Tensor,
                    fake: torch.Tensor, style_weight: float = 0.0
                    ) -> Dict[str, torch.Tensor]:
    """VGG19 relu{1..5}_1 L1 (+ optional Gram style), per frame, averaged
    over T. gt, fake: [B, T, H, W, 3] in [0, 1]."""
    return perceptual_loss_folded(vgg, fold_time(gt)[0], fold_time(fake)[0],
                                  style_weight)


def perceptual_loss_folded(vgg: Callable[[torch.Tensor], Taps],
                           gt_flat: torch.Tensor, fake_flat: torch.Tensor,
                           style_weight: float = 0.0
                           ) -> Dict[str, torch.Tensor]:
    """perceptual_loss on time-folded [B*T, H, W, 3] frames. The target side
    carries no gradient; the taps may be bfloat16, the means accumulate in
    float32."""
    with torch.no_grad():
        x_taps = vgg(gt_flat)
    y_taps = vgg(fake_flat)

    def l1(a, b):
        return (a - b).abs().mean(dtype=torch.float32)

    out = {"perceptual": sum(
        l1(x_taps[tap], y_taps[tap])
        for tap in ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"))}
    if style_weight > 0:
        def gram(f):
            b, h, w, c = f.shape
            m = f.reshape(b, h * w, c)
            return torch.einsum("bnc,bnd->bcd", m, m) / (h * w * c)
        out["style"] = sum(
            l1(gram(x_taps[tap]), gram(y_taps[tap]))
            for tap in ("relu2_2", "relu3_4", "relu4_4", "relu5_2"))
    return out


def masked_theta_losses(thetas: torch.Tensor, targets_theta: torch.Tensor,
                        node_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-timestep L1 of the GNN's thetas against GT over the valid nodes,
    summed over T. thetas, targets: [B, N, T, 6]. Under a live process
    group the count is the global batch's per rank (its sum over the ranks
    over their number), so that the mean of the ranks' losses, and of their
    gradients, is the global batch's loss, as under ``jit`` on a data
    mesh."""
    m = node_mask[:, :, None].to(thetas.dtype)                # [B, N, 1]
    count = node_mask.sum().to(thetas.dtype)
    if mesh.is_live():
        count = mesh.global_sum(count.detach()) / mesh.world_size()
    count = count.clamp_min(1.0)

    def per_t_sum(i):
        d = (thetas[..., i] - targets_theta[..., i]).abs() * m
        return (d.sum(dim=(0, 1)) / count).sum()

    return {"translation": per_t_sum(2) + per_t_sum(5),
            "scale": per_t_sum(0) + per_t_sum(4),
            "rotation": per_t_sum(1) + per_t_sum(3)}


def gan_mse_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """LSGAN MSE against a 0/1 label. Reference quirk, kept for parity: the
    reference's ``GANLoss`` indexes ``input[-1]`` of the prediction-map
    TENSOR, so the loss is the MSE over the LAST batch element's patch map
    only (the last frame of the last sample in the time fold). Under a live
    process group that element is the global batch's, on the last rank: its
    loss is scaled by the number of ranks there and by 0 elsewhere, so that
    the mean over the ranks is the global batch's loss."""
    target = 1.0 if target_is_real else 0.0
    loss = (pred[-1] - target).square().mean()
    if mesh.is_live():
        world = mesh.world_size()
        loss = loss * (float(world) if mesh.rank() == world - 1 else 0.0)
    return loss


def feature_matching_loss(real_feats: Sequence[torch.Tensor],
                          fake_feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of L1 over the discriminator's feature maps, real side detached,
    float32 accumulation."""
    return sum((a.detach() - b).abs().mean(dtype=torch.float32)
               for a, b in zip(real_feats, fake_feats))


def training_losses(tp, batch: Dict[str, torch.Tensor],
                    out: Dict[str, torch.Tensor],
                    vgg: Optional[Callable[[torch.Tensor], Taps]]
                    ) -> Dict[str, torch.Tensor]:
    """Generator-side objective (reference TrainingLosses.forward). ``tp``
    is ``cfg.train_params``. The ``warped`` term warps the float32 source
    frame by the dense flow through K1, so K1's flow gradient runs at full
    resolution."""
    w = tp.loss_weights
    nif = tp.num_input_frames
    tpred = tp.num_predicted_frames
    frames = batch["video"]
    source_frame = frames[:, nif - 1]
    target_frames = frames[:, nif:]
    use_fw = tp.use_fw_of and batch.get("target_fw_of") is not None
    loss: Dict[str, torch.Tensor] = {}

    loss["flow_reconstruction"] = l1_masked(
        out["dense_motion_bw"], batch["target_bw_of"], batch["target_bw_occ"])
    if use_fw:
        loss["flow_reconstruction"] = loss["flow_reconstruction"] + l1_masked(
            out["dense_motion_fw"], batch["target_fw_of"],
            batch["target_fw_occ"])
        loss["flowcon"] = flow_consistency_loss(
            out["dense_motion_fw"], out["dense_motion_bw"],
            out["occlusion_fw"], out["occlusion_bw"], tpred)

    b = source_frame.shape[0]
    src_rep = source_frame[:, None].expand(b, tpred, *source_frame.shape[1:])
    flow_flat = fold_time(out["dense_motion_bw"])[0].float().contiguous()
    # the source frame once for its T warps (K1's frames per image)
    warped = resample(source_frame.contiguous(), flow_flat,
                      frames=tpred).reshape(target_frames.shape)
    loss["warped"] = l1_masked(warped, target_frames)

    if w.flow_smooth > 0:
        loss["flow_smooth"] = smooth_loss(out["dense_motion_bw"], target_frames)
        if use_fw:
            loss["flow_smooth"] = loss["flow_smooth"] + smooth_loss(
                out["dense_motion_fw"], src_rep)

    loss["kl"] = kl_loss(out["mu"], out["logvar"])
    loss["ssim"] = ssim_loss(out["generated"], target_frames)
    loss["reconstruction"] = l1_masked(out["generated"], target_frames)
    if w.perceptual > 0 and vgg is not None:
        loss.update(perceptual_loss(vgg, target_frames, out["generated"],
                                    style_weight=w.style))
    loss["occlusion_bw"] = l1_masked(batch["target_bw_occ"], out["occlusion_bw"])
    if tp.use_fw_of and batch.get("target_fw_occ") is not None:
        loss["occlusion_fw"] = l1_masked(batch["target_fw_occ"],
                                         out["occlusion_fw"])
    loss.update(masked_theta_losses(out["thetas"], batch["targets_theta"],
                                    batch["node_mask"]))
    return loss
