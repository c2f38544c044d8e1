"""C2MGenerator (port of ``c2m_tpu/models/c2m.py``).

``inference``: sampled generation (reference model.py:241-324) with an
explicit motion latent and clicks, no VAE encoders, eval-mode norms.
``forward``: the training forward (``__call__`` in the JAX package): the two
VAE encoders give the latent, the click is drawn, the norms follow the
module's train/eval mode.

Batch layout: the padded dense, channels-last dict documented in
``c2m_tpu/models/c2m.py`` (video [B, T, H, W, 3], instance_mask
[B, T, H, W, 1], nodes_x [B, N, 23], targets_theta [B, N, Tp, 6], ...), as
torch tensors on one device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from c2m_tpu_torch import trace
from c2m_tpu_torch.config import Config
from c2m_tpu_torch.models.appearance import AppearanceEncoder, level_features
from c2m_tpu_torch.models.dense_motion import (DenseMotionDecoder,
                                               DenseMotionEncoder,
                                               SparseMotionFeatureEncoder,
                                               reparameterize)
from c2m_tpu_torch.models.generator import OcclusionAwareGenerator
from c2m_tpu_torch.models.sparse_motion import (AffineHead, DenseGATv2,
                                                SparseMotionEstimator,
                                                sample_click_indices)
from c2m_tpu_torch.nn.layers import (Dense, SameBlockTwoConv2d, fold_time,
                                     unfold_time, use_compute_dtype)
from c2m_tpu_torch.ops.raster import generate_sparse_motion
from c2m_tpu_torch.ops.warp import resample, resize_video

Batch = Dict[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# submodules whose convolutions run in ``train_params.dtype``; the GNN and
# the latent ``fc`` stay float32, as in the JAX package
CONV_STACKS = ("appearance_encoder", "sparse_feature_encoder",
               "dense_generator_bw", "dense_generator_fw", "zconv",
               "generator")
VAE_ENCODERS = ("motion_encoder_bg", "motion_encoder_fg")


def encoder_in_features(cfg: Config) -> int:
    """Channels of the appearance-encoder input stack (_encoder_input)."""
    cp = cfg.model_params.common_params
    nif = cfg.train_params.num_input_frames
    per_frame = (cp.image_channel + cp.seg_channel_bg + cp.seg_channel_fg
                 + cp.instance_channel)
    extra = (nif - 1) * (cp.flow_channel + cp.occlusion_channel)
    return nif * per_frame + extra


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight from ``generator`` (call on the CPU, before
    moving the model, so a seed gives the same weights on any device):
    convs and linears U(±1/sqrt(fan_in)) as torch's default (and the JAX
    package's), GAT attention glorot-uniform, norms at identity. The affine
    heads keep their zero/identity init (reference
    sparse_motion_estimator.py:118-122)."""
    heads = {id(m.fc2) for m in model.modules() if isinstance(m, AffineHead)}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)) and id(m) not in heads:
            bound = 1.0 / float(m.weight[0].numel()) ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, DenseGATv2):
            h, f = m.att.shape
            bound = (6.0 / (h + f)) ** 0.5
            m.att.uniform_(-bound, bound, generator=generator)
    return model


class C2MGenerator(nn.Module):
    """Appearance encoder + GNN + rasterizer + dense motion decoder +
    generator, the generator side of the reference's model."""

    def __init__(self, cfg: Config):
        """A dataset name (``cfg.dataset_params.dataset``) holding ``kitti``
        gives the generator its warped-image branch, as in the JAX
        package."""
        super().__init__()
        self.cfg = cfg
        mp, tp = cfg.model_params, cfg.train_params
        me = mp.motion_estimator
        ap = mp.appearance_encoder
        tpred = tp.num_predicted_frames
        self.appearance_encoder = AppearanceEncoder(
            ap, encoder_in_features(cfg), tp.input_size)
        scene_features = ap.block_expansion * (2 ** ap.pooling_after)
        self.sparse_motion_estimator = SparseMotionEstimator(
            me.sparse_motion_estimator, tpred, scene_features=scene_features)
        self.sparse_feature_encoder = SparseMotionFeatureEncoder(
            me.sparse_motion_encoder)
        cp = mp.common_params
        nif = tp.num_input_frames
        sf = cp.scale_factor
        clip = (tpred, int(tp.input_size[0] * sf), int(tp.input_size[1] * sf))
        flows = cp.flow_channel + cp.occlusion_channel
        enc = me.dense_motion_encoder
        self.motion_encoder_bg = DenseMotionEncoder(
            enc, (nif + 1) * (cp.image_channel + cp.seg_channel_bg) + flows,
            enc.out_channel_bg, clip)
        self.motion_encoder_fg = DenseMotionEncoder(
            enc, (nif + 1) * (cp.image_channel + cp.seg_channel_fg
                              + cp.instance_channel) + flows,
            enc.out_channel_fg, clip)
        app_ch = level_features(ap, ap.num_down_blocks - 1)
        app_features = {f"enco{i}": level_features(ap, i)
                        for i in range(ap.num_down_blocks - 1)}
        self.dense_generator_bw = DenseMotionDecoder(
            me.dense_motion_decoder, tpred, me.sparse_motion_encoder,
            app_features, z_features=app_ch + 16)
        if tp.use_fw_of:
            self.dense_generator_fw = DenseMotionDecoder(
                me.dense_motion_decoder, tpred, me.sparse_motion_encoder,
                app_features, z_features=app_ch + 16)
        down = 2 ** ap.num_down_blocks
        self.h_app = int(tp.input_size[0] / down * sf)
        self.w_app = int(tp.input_size[1] / down * sf)
        self.fc = Dense(enc.out_channel_bg + enc.out_channel_fg,
                        64 * self.h_app * self.w_app)
        self.zconv = SameBlockTwoConv2d(64 + app_ch, 16 * tpred, 3, 1, 1,
                                        padding_mode="reflect")
        self.generator = OcclusionAwareGenerator(
            mp.generator, mp.flow_embedder,
            dataset=cfg.dataset_params.dataset)

    def use_compute_dtype(self, dtype: torch.dtype) -> "C2MGenerator":
        """For training and serving alike: the conv stacks and the VAE
        encoders compute in ``dtype`` while every parameter stays float32
        (each layer casts its weight and input at use). The GNN, ``fc``, the
        VAE heads ``fc_mu``/``fc_logvar``, the norms' statistics and the
        rasterizer stay float32."""
        for name in CONV_STACKS + VAE_ENCODERS:
            if hasattr(self, name):
                use_compute_dtype(getattr(self, name), dtype)
        for name in VAE_ENCODERS:
            enc = getattr(self, name)
            enc.fc_mu.compute_dtype = enc.fc_logvar.compute_dtype = None
        return self

    # -- shared pieces ------------------------------------------------------

    def _prepare(self, batch: Batch) -> Batch:
        """scale_factor resizing of every stream (model.py:126-153)."""
        sf = self.cfg.model_params.common_params.scale_factor
        if sf == 1:
            return dict(batch)
        h, w = batch["video"].shape[2:4]
        size = (int(h * sf), int(w * sf))
        out = dict(batch)
        out["video"] = resize_video(batch["video"], size, "bilinear")
        for k in ("bg_mask", "fg_mask", "instance_mask"):
            out[k] = resize_video(batch[k], size, "nearest")
        for k in ("target_bw_of", "target_fw_of", "input_of"):
            if batch.get(k) is not None:
                out[k] = resize_video(batch[k], size, is_flow=True)
        for k in ("target_bw_occ", "target_fw_occ", "input_occ"):
            if batch.get(k) is not None:
                out[k] = resize_video(batch[k], size, "bilinear")
        return out

    def _encoder_input(self, batch: Batch) -> torch.Tensor:
        """Conditioning stack (model.py:162-175): channel-concat of the input
        frames, the seg one-hots, the instance map (+ input flow/occ)."""
        nif = self.cfg.train_params.num_input_frames

        def flat(x, n):
            x = x[:, :n].permute(0, 2, 3, 1, 4)
            return x.reshape(*x.shape[:3], -1)

        parts = [flat(batch["video"], nif), flat(batch["bg_mask"], nif),
                 flat(batch["fg_mask"], nif), flat(batch["instance_mask"], nif)]
        if batch.get("input_of") is not None and nif > 1:
            parts += [flat(batch["input_of"], nif - 1),
                      flat(batch["input_occ"], nif - 1)]
        return torch.cat(parts, dim=-1)

    def _appearance(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.appearance_encoder(self._encoder_input(batch),
                                       batch["rois_padded"], batch["node_mask"])

    def _vae_inputs(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """bg/fg VAE encoder stacks (dense_motion.py:170-203): for each
        predicted timestep, channels = [all input frames, target frame t]."""
        tp = self.cfg.train_params
        nif, tpred = tp.num_input_frames, tp.num_predicted_frames

        def tile_and_pair(x):
            b, _, h, w, c = x.shape
            inp = x[:, :nif].permute(0, 2, 3, 1, 4).reshape(b, h, w, nif * c)
            inp = inp[:, None].expand(b, tpred, h, w, nif * c)
            return torch.cat([inp, x[:, nif:]], dim=-1)

        frames = tile_and_pair(batch["video"])
        bg = tile_and_pair(batch["bg_mask"])
        fg = tile_and_pair(batch["fg_mask"])
        inst = tile_and_pair(batch["instance_mask"])
        flows = torch.cat([batch["target_bw_of"], batch["target_bw_occ"]],
                          dim=-1)
        return {"bg": torch.cat([frames, bg, flows], dim=-1),
                "fg": torch.cat([frames, fg, inst, flows], dim=-1)}

    def _motion_code(self, z_m: torch.Tensor, app_encoded: torch.Tensor
                     ) -> torch.Tensor:
        """z = [appearance code | per-t motion code] (dense_motion.py:218-223)."""
        tpred = self.cfg.train_params.num_predicted_frames
        b = z_m.shape[0]
        # NHWC reshape, as the JAX package's fc weights expect
        zmap = self.fc(z_m).reshape(b, self.h_app, self.w_app, 64)
        code = self.zconv(torch.cat([zmap.to(app_encoded.dtype), app_encoded],
                                    dim=-1))
        code = code.reshape(b, self.h_app, self.w_app, tpred, 16)
        code = code.permute(0, 3, 1, 2, 4)                   # [B, Tp, h, w, 16]
        codex = app_encoded[:, None].expand(b, tpred, *app_encoded.shape[1:])
        return torch.cat([codex, code.to(codex.dtype)], dim=-1)

    def _generate_frames(self, batch: Batch,
                         dense_bw: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The generator on the time-folded batch (model.py:195-202)."""
        tp = self.cfg.train_params
        tpred = tp.num_predicted_frames
        src = batch["video"][:, tp.num_input_frames - 1]
        b = src.shape[0]
        src_rep = src[:, None].expand(b, tpred, *src.shape[1:]).reshape(
            b * tpred, *src.shape[1:])
        flow, _ = fold_time(dense_bw["dense_motion"])
        occ, _ = fold_time(dense_bw["occlusion"])
        return unfold_time(self.generator(src_rep, flow, occ, tpred), tpred)

    def _sparse_previews(self, batch: Batch, out: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """Sparse-warp previews (model.py:203-211), through K1."""
        tp = self.cfg.train_params
        tpred = tp.num_predicted_frames
        src = batch["video"][:, tp.num_input_frames - 1].contiguous()
        sm, _ = fold_time(out["sparse_motion_bw"])
        with torch.no_grad():                      # previews carry no gradient
            warped = unfold_time(
                resample(src, sm.contiguous(), frames=tpred), tpred)
            return {"generated_sparse": warped,
                    "generated_sparse_occ": warped * out["sparse_occ_bw"]}

    # -- training forward ---------------------------------------------------

    def forward(self, batch: Batch, eps: Optional[torch.Tensor] = None,
                click_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The training forward. The norms follow ``self.training``. The VAE
        noise ``eps`` [B, z_dim] and the ``click_mask`` [B, N] are drawn from
        ``generator`` unless given. The rasterizer gets the GT thetas when
        ``train_params.use_gt_training``; its outputs and the previews carry
        no gradient (the JAX package's ``stop_gradient``s), so the theta
        losses are the GNN's only gradient path."""
        tp = self.cfg.train_params
        batch = self._prepare(batch)
        out: Dict[str, torch.Tensor] = {}

        with trace.span("c2m.model.appearance"):
            app = self._appearance(batch)
        with trace.span("c2m.model.motion_encoder"):
            vae_in = self._vae_inputs(batch)
            bg = self.motion_encoder_bg(vae_in["bg"])
            fg = self.motion_encoder_fg(vae_in["fg"])
            out["mu"] = torch.cat([bg["mu"], fg["mu"]], dim=-1).float()
            out["logvar"] = torch.cat([bg["logvar"], fg["logvar"]],
                                      dim=-1).float()
            z_m = reparameterize(out["mu"], out["logvar"], generator, eps)

        with trace.span("c2m.model.gnn"):
            if click_mask is None:
                _, click_mask = sample_click_indices(
                    batch["num_real_nodes"], batch["node_mask"].shape[1],
                    generator)
            gnn = self.sparse_motion_estimator(
                batch["nodes_x"], app["objects_feature"].float(),
                batch["targets_theta"], batch["node_mask"], click_mask)
        out["thetas"] = gnn["thetas"]
        out["click_mask"] = click_mask

        raster_thetas = (batch["targets_theta"] if tp.use_gt_training
                         else gnn["thetas"])
        instance_src = batch["instance_mask"][:, tp.num_input_frames - 1]
        with torch.no_grad():
            sparse = generate_sparse_motion(instance_src, batch["inst_ids"],
                                            batch["node_mask"],
                                            raster_thetas.float())
        out.update(sparse)

        with trace.span("c2m.model.dense_motion"):
            sparse_feats = self.sparse_feature_encoder(
                sparse["sparse_motion_bw"])
            z = self._motion_code(z_m, app["app_encoded"])
            dense_bw = self.dense_generator_bw(app, sparse_feats,
                                               sparse["sparse_motion_bw"],
                                               sparse["sparse_occ_bw"], z)
            out["dense_motion_bw"] = dense_bw["dense_motion"]
            out["occlusion_bw"] = dense_bw["occlusion"]
            if tp.use_fw_of:
                feats_fw = self.sparse_feature_encoder(
                    sparse["sparse_motion_fw"])
                dense_fw = self.dense_generator_fw(app, feats_fw,
                                                   sparse["sparse_motion_fw"],
                                                   sparse["sparse_occ_fw"], z)
                out["dense_motion_fw"] = dense_fw["dense_motion"]
                out["occlusion_fw"] = dense_fw["occlusion"]

        with trace.span("c2m.model.generator"):
            out["generated"] = self._generate_frames(batch, dense_bw)
            out.update(self._sparse_previews(batch, out))
        return out

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def inference(self, batch: Batch, z_m: torch.Tensor,
                  click_mask: torch.Tensor,
                  use_gt_eval: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Sampled generation: explicit latent ``z_m`` [B, z_dim] and clicks
        ``click_mask`` [B, N]. GT thetas drive the rasterizer when
        ``use_gt_eval`` (default ``train_params.use_gt_eval``, as the JAX
        method), the GNN's thetas otherwise."""
        tp = self.cfg.train_params
        if use_gt_eval is None:
            use_gt_eval = tp.use_gt_eval
        batch = self._prepare(batch)
        out: Dict[str, torch.Tensor] = {}

        with trace.span("c2m.model.appearance"):
            app = self._appearance(batch)
        with trace.span("c2m.model.gnn"):
            gnn = self.sparse_motion_estimator(
                batch["nodes_x"], app["objects_feature"].float(),
                batch["targets_theta"], batch["node_mask"], click_mask)
        out["thetas"] = gnn["thetas"]
        out["click_mask"] = click_mask
        raster_thetas = batch["targets_theta"] if use_gt_eval else gnn["thetas"]
        instance_src = batch["instance_mask"][:, tp.num_input_frames - 1]
        sparse = generate_sparse_motion(instance_src, batch["inst_ids"],
                                        batch["node_mask"],
                                        raster_thetas.float())
        out.update(sparse)

        with trace.span("c2m.model.dense_motion"):
            sparse_feats = self.sparse_feature_encoder(
                sparse["sparse_motion_bw"])
            z = self._motion_code(z_m, app["app_encoded"])
            dense_bw = self.dense_generator_bw(app, sparse_feats,
                                               sparse["sparse_motion_bw"],
                                               sparse["sparse_occ_bw"], z)
            out["dense_motion_bw"] = dense_bw["dense_motion"]
            out["occlusion_bw"] = dense_bw["occlusion"]
        with trace.span("c2m.model.generator"):
            out["generated"] = self._generate_frames(batch, dense_bw)
            out.update(self._sparse_previews(batch, out))
        return out
