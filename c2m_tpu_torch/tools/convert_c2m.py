"""Convert a reference C2M checkpoint (``latest_c2m_model.pth.tar``, the
``GeneratorFullModel`` state_dict of the reference trainer) into a job dir
of the port: the port of ``tools/convert_c2m.py``.

  python -m c2m_tpu_torch.tools.convert_c2m --checkpoint latest_c2m_model.pth.tar
      --config configs/c2m_journal_cityscapes.yaml --out <job dir>
      [--device cpu]

:func:`convert_state_dict` and its helpers are a copy of the JAX tool's
(numpy only): the reference keys go onto the JAX package's variable tree
(``{'params', 'batch_stats', 'spectral'}`` of ``C2MTrainModel``) with the
layout transforms the channels-last model needs:

- conv2d [Co,C,kh,kw] -> [kh,kw,C,Co]; conv3d [Co,C,kt,kh,kw] -> the
  time-unrolled 2D kernel [kh,kw,kt*C,Co];
- Linear [out,in] -> [in,out];
- the flatten-boundary Linears get their rows / columns permuted from the
  reference's channels-first (C,h,w) flatten to (h,w,C): the VAE fc heads,
  ``fuse_appearance_roi`` and the output of the z -> map ``fc``;
- the decoder's flow and occlusion predictors merge into the fused 32 -> 64
  head conv;
- GATv2: lin_l / lin_r / att / bias map 1:1 (PyG's att [1,H,C] accepted);
  the model's lin_r carries a bias the reference lacks, set to zero (the
  sum lin_l(x_i) + lin_r(x_j) has one free offset, so the functions are
  the same);
- both discriminators' spectral-norm ``weight_orig`` / ``weight_u``.

Dead reference parameters are consumed and dropped: y_encoder and
decoder.linear_z (outputs never read), the per-scale flow / occlusion
predictors (created, never called), the roi SameBlock2d norm and the SPADE
and flow-embedder ``use_norm=False`` norms, VGG's mean / std buffers, the
spectral ``weight_v`` (recomputed) and ``num_batches_tracked``. A key left
over raises.

``utils/convert.from_jax_variables`` then carries the tree into the port's
``C2MTrainModel`` state_dict. :func:`main` overlays it on a fresh
``create_train_state(cfg, seed=0)``: a source saved with
``is_inference=True`` lacks VGG and the discriminators, and those keep their
init, as the JAX tool's ``merge`` does. It writes the state at step 0,
epoch 0 through ``utils/checkpoint.save_checkpoint``, so that
``train_torch.py --job-dir`` (with ``continue_train``) and
``eval_torch.py --job-dir`` read it. The model is built on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping

import numpy as np


def _conv2d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w):
    co, c, kt, kh, kw = w.shape
    return np.ascontiguousarray(
        np.transpose(w, (3, 4, 2, 1, 0)).reshape(kh, kw, kt * c, co))


def _linear(w):
    return np.ascontiguousarray(w.T)


def _perm_chw_to_hwc(c, h, w):
    """perm[i_ours(h,w,c)] = i_ref(c,h,w)."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


class _Tree:
    def __init__(self):
        self.params: Dict = {}
        self.batch_stats: Dict = {}
        self.spectral: Dict = {}

    @staticmethod
    def _set(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value, np.float32)

    def p(self, path, value):
        self._set(self.params, path, value)

    def s(self, path, value):
        self._set(self.batch_stats, path, value)

    def sp(self, path, value):
        self._set(self.spectral, path, value)


class _Source:
    """state_dict access with consumption tracking."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used = set()

    def take(self, key):
        self.used.add(key)
        return self.sd[key]

    def drop(self, key):
        if key in self.sd:
            self.used.add(key)

    def has(self, key):
        return key in self.sd

    def leftovers(self):
        return sorted(set(self.sd) - self.used)


def _bn_fix(src, tree, ref, ours):
    # batch_stats path mirrors the params path
    tree.p(ours + ["scale"], src.take(ref + ".weight"))
    tree.p(ours + ["bias"], src.take(ref + ".bias"))
    tree.s(ours + ["mean"], src.take(ref + ".running_mean"))
    tree.s(ours + ["var"], src.take(ref + ".running_var"))
    src.drop(ref + ".num_batches_tracked")


def _inorm(src, tree, ref, ours):
    tree.p(ours + ["scale"], src.take(ref + ".weight"))
    tree.p(ours + ["bias"], src.take(ref + ".bias"))


def _conv_block2d(src, tree, ref, ours):
    """reference {conv, norm(BN)} -> ours {Conv_0/Conv_0, BatchNorm_0/BatchNorm_0}."""
    tree.p(ours + ["Conv_0", "Conv_0", "kernel"], _conv2d(src.take(ref + ".conv.weight")))
    tree.p(ours + ["Conv_0", "Conv_0", "bias"], src.take(ref + ".conv.bias"))
    _bn_fix(src, tree, ref + ".norm", ours + ["BatchNorm_0", "BatchNorm_0"])


def _conv_block3d(src, tree, ref, ours):
    tree.p(ours + ["Conv3d_0", "Conv_0", "kernel"], _conv3d(src.take(ref + ".conv.weight")))
    tree.p(ours + ["Conv3d_0", "Conv_0", "bias"], src.take(ref + ".conv.bias"))
    _bn_fix(src, tree, ref + ".norm", ours + ["BatchNorm_0", "BatchNorm_0"])


def _up_block(src, tree, ref, ours):
    """reference UpBlock2d {main.1 conv, main.2 BN} (up_block.py:5-27)."""
    tree.p(ours + ["Conv_0", "Conv_0", "kernel"], _conv2d(src.take(ref + ".main.1.weight")))
    tree.p(ours + ["Conv_0", "Conv_0", "bias"], src.take(ref + ".main.1.bias"))
    _bn_fix(src, tree, ref + ".main.2", ours + ["BatchNorm_0", "BatchNorm_0"])


def _dense(src, tree, ref, ours, in_perm=None, out_perm=None):
    w = _linear(src.take(ref + ".weight"))
    b = src.take(ref + ".bias")
    if in_perm is not None:
        w = w[in_perm]
    if out_perm is not None:
        w = w[:, out_perm]
        b = b[out_perm]
    tree.p(ours + ["Dense_0", "kernel"], w)
    tree.p(ours + ["Dense_0", "bias"], b)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Dict]:
    """Reference GeneratorFullModel state_dict -> {params, batch_stats,
    spectral} matching C2MTrainModel's variable tree (train/model.py)."""
    tp, mp = cfg.train_params, cfg.model_params
    src = _Source(sd)
    t = _Tree()
    h, w = tp.input_size
    sf = mp.common_params.scale_factor
    nd_app = mp.appearance_encoder.num_down_blocks
    h_app = int(h / (2 ** nd_app) * sf)
    w_app = int(w / (2 ** nd_app) * sf)
    c_app = min(mp.appearance_encoder.max_expansion,
                mp.appearance_encoder.block_expansion * 2 ** (nd_app - 1))
    tpred = tp.num_predicted_frames

    # ---- appearance encoder ------------------------------------------------
    base = ["c2m", "appearance_encoder"]
    for i in range(nd_app):
        _conv_block2d(src, t, f"appearance_encoder.down_blocks.{i}",
                      base + [f"down_{i}"])
    t.p(base + ["roi_conv", "Conv_0", "Conv_0", "kernel"],
        _conv2d(src.take("appearance_encoder.roi_align_blocks.0.conv.weight")))
    t.p(base + ["roi_conv", "Conv_0", "Conv_0", "bias"],
        src.take("appearance_encoder.roi_align_blocks.0.conv.bias"))
    # use_norm=False: the reference creates but never applies this norm
    # (appearance_encoder.py:43, same_block.py)
    src.drop("appearance_encoder.roi_align_blocks.0.norm.weight")
    src.drop("appearance_encoder.roi_align_blocks.0.norm.bias")
    _dense(src, t, "appearance_encoder.roi_align_blocks.2", base + ["roi_fc"])
    _dense(src, t, "appearance_encoder.roi_align_regressor",
           base + ["roi_regressor"])
    # fuse input = [scene_flat | object]: scene rows go (C,h,w) -> (h,w,C)
    n_scene = c_app * h_app * w_app
    n_obj = src.sd["appearance_encoder.fuse_appearance_roi.weight"].shape[1] \
        - n_scene
    perm = np.concatenate([_perm_chw_to_hwc(c_app, h_app, w_app),
                           n_scene + np.arange(n_obj)])
    _dense(src, t, "appearance_encoder.fuse_appearance_roi",
           base + ["fuse_appearance_roi"], in_perm=perm)

    # ---- sparse motion estimator (click GNN) --------------------------------
    base = ["c2m", "sparse_motion_estimator"]
    _dense(src, t, "motion_encoder.sparse_motion_estimator.x_encoder.0",
           base + ["x_enc1"])
    _dense(src, t, "motion_encoder.sparse_motion_estimator.x_encoder.2",
           base + ["x_enc2"])
    esf = "motion_encoder.sparse_motion_estimator.encode_scene_features"
    _dense(src, t, esf + ".0", base + ["scene_fc1"])
    _bn_fix(src, t, esf + ".1", base + ["scene_bn1"])
    _dense(src, t, esf + ".3", base + ["scene_fc2"])
    _bn_fix(src, t, esf + ".4", base + ["scene_bn2"])
    _dense(src, t, esf + ".6", base + ["scene_fc3"])
    dec = "motion_encoder.sparse_motion_estimator.decoder"
    for tt in range(tpred):
        g = f"{dec}.conv_time_steps.{tt}"
        ours = base + [f"gat_{tt}"]
        att = src.take(g + ".att")
        if att.ndim == 3:      # real torch_geometric stores [1, heads, C]
            att = att[0]
        t.p(ours + ["att"], att)
        t.p(ours + ["bias"], src.take(g + ".bias"))
        t.p(ours + ["lin_l", "Dense_0", "kernel"], _linear(src.take(g + ".lin_l.weight")))
        t.p(ours + ["lin_l", "Dense_0", "bias"], src.take(g + ".lin_l.bias"))
        t.p(ours + ["lin_r", "Dense_0", "kernel"], _linear(src.take(g + ".lin_r.weight")))
        # the reference's lin_r has no bias; ours does (one redundant offset
        # in lin_l(x_i)+lin_r(x_j)) -> zero it
        t.p(ours + ["lin_r", "Dense_0", "bias"],
            np.zeros(src.sd[g + ".lin_l.bias"].shape, np.float32))
        _dense(src, t, f"{dec}.loc_time_steps.{tt}.0", base + [f"loc_{tt}", "fc1"])
        _dense(src, t, f"{dec}.loc_time_steps.{tt}.2", base + [f"loc_{tt}", "fc2"])
    # dead paths: y_encoder output overwritten (sparse_motion_estimator.py:
    # 126-141), linear_z writes y_n which nothing reads (:128)
    for k in list(src.sd):
        if (".sparse_motion_estimator.y_encoder." in k
                or ".decoder.linear_z." in k):
            src.drop(k)

    # ---- VAE encoders + sparse pyramid --------------------------------------
    for name in ("motion_encoder_bg", "motion_encoder_fg"):
        base = ["c2m", name]
        ref = f"motion_encoder.{name}"
        n_down = len(mp.motion_estimator.dense_motion_encoder.t_kernel)
        for i in range(n_down):
            _conv_block3d(src, t, f"{ref}.down_blocks.{i}", base + [f"down_{i}"])
        # fc input: ref flattens [B, C, T=1, h', w'] -> (C,h,w); ours (T,h,w,C)
        c_enc = src.sd[f"{ref}.down_blocks.{n_down - 1}.conv.bias"].shape[0]
        n_in = src.sd[f"{ref}.fc1.weight"].shape[1]
        hw = n_in // c_enc
        # bottleneck is (h', w') with h'/w' from the encoder strides; recover
        # the aspect from the input size (strides halve h and w equally)
        ratio = (w * sf) / (h * sf)
        h_enc = int(round((hw / ratio) ** 0.5))
        w_enc = hw // h_enc
        assert h_enc * w_enc == hw, (h_enc, w_enc, hw)
        perm = _perm_chw_to_hwc(c_enc, h_enc, w_enc)
        _dense(src, t, f"{ref}.fc1", base + ["fc_mu"], in_perm=perm)
        _dense(src, t, f"{ref}.fc2", base + ["fc_logvar"], in_perm=perm)

    base = ["c2m", "sparse_feature_encoder"]
    for i in range(mp.motion_estimator.sparse_motion_encoder.num_down_blocks):
        _conv_block3d(src, t, f"motion_encoder.sparse_feature_encoder.down_blocks.{i}",
                      base + [f"down_{i}"])

    # ---- dense motion decoder(s) --------------------------------------------
    decoders = [("dense_generator_bw", True)]
    if tp.use_fw_of:
        decoders.append(("dense_generator_fw", True))
    nb = mp.motion_estimator.dense_motion_decoder.num_up_blocks
    sparse_down = mp.motion_estimator.sparse_motion_encoder.num_down_blocks
    for name, _ in decoders:
        base = ["c2m", name]
        ref = f"motion_encoder.{name}"
        _conv_block3d(src, t, f"{ref}.first", base + ["first"])
        for i in range(nb):
            _up_block(src, t, f"{ref}.up_blocks.{i}", base + [f"up_{i}"])
        for i in range(sparse_down):
            _conv_block3d(src, t, f"{ref}.fuse_convs.{i}", base + [f"fuse_{i}"])
        _up_block(src, t, f"{ref}.final_up_block", base + ["final_up"])
        _conv_block3d(src, t, f"{ref}.final_fuse", base + ["final_fuse"])
        # fused heads: block_conv = [flow block conv | occ block conv]
        wf = _conv2d(src.take(f"{ref}.flow.flow_predictor.0.conv.weight"))
        wo = _conv2d(src.take(f"{ref}.occlusion.occlusion_predictor.0.conv.weight"))
        bf = src.take(f"{ref}.flow.flow_predictor.0.conv.bias")
        bo = src.take(f"{ref}.occlusion.occlusion_predictor.0.conv.bias")
        hb = base + ["heads"]
        t.p(hb + ["block_conv", "Conv_0", "kernel"], np.concatenate([wf, wo], -1))
        t.p(hb + ["block_conv", "Conv_0", "bias"], np.concatenate([bf, bo]))
        _inorm(src, t, f"{ref}.flow.flow_predictor.0.norm", hb + ["norm_flow"])
        _inorm(src, t, f"{ref}.occlusion.occlusion_predictor.0.norm",
               hb + ["norm_occ"])
        t.p(hb + ["flow_head", "Conv_0", "kernel"],
            _conv2d(src.take(f"{ref}.flow.flow_predictor.2.weight")))
        t.p(hb + ["flow_head", "Conv_0", "bias"],
            src.take(f"{ref}.flow.flow_predictor.2.bias"))
        t.p(hb + ["occ_head", "Conv_0", "kernel"],
            _conv2d(src.take(f"{ref}.occlusion.occlusion_predictor.2.weight")))
        t.p(hb + ["occ_head", "Conv_0", "bias"],
            src.take(f"{ref}.occlusion.occlusion_predictor.2.bias"))
        # per-scale predictors are created but never called
        # (motion_autoencoder.py:93-95 vs forward :107-149) — dead
        for k in list(src.sd):
            if (k.startswith(f"{ref}.flow_predictors.")
                    or k.startswith(f"{ref}.occlusion_predictors.")):
                src.drop(k)

    # ---- z plumbing ----------------------------------------------------------
    # fc output: ref .view(-1, 64, h_app, w_app) (dense_motion.py:218) is a
    # (64,h,w) unflatten; ours reshapes (h,w,64)
    _dense(src, t, "motion_encoder.fc", ["c2m", "fc"],
           out_perm=_perm_chw_to_hwc(64, h_app, w_app))
    zb = ["c2m", "zconv"]
    t.p(zb + ["Conv_0", "Conv_0", "kernel"],
        _conv2d(src.take("motion_encoder.zconv.conv.weight")))
    t.p(zb + ["Conv_0", "Conv_0", "bias"],
        src.take("motion_encoder.zconv.conv.bias"))
    t.p(zb + ["Conv_1", "Conv_0", "kernel"],
        _conv2d(src.take("motion_encoder.zconv.conv2.weight")))
    t.p(zb + ["Conv_1", "Conv_0", "bias"],
        src.take("motion_encoder.zconv.conv2.bias"))
    _inorm(src, t, "motion_encoder.zconv.norm", zb + ["InstanceNorm_0"])

    # ---- generator ------------------------------------------------------------
    base = ["c2m", "generator"]
    t.p(base + ["first", "Conv_0", "Conv_0", "kernel"],
        _conv2d(src.take("generator.first.conv.weight")))
    t.p(base + ["first", "Conv_0", "Conv_0", "bias"],
        src.take("generator.first.conv.bias"))
    _inorm(src, t, "generator.first.norm", base + ["first", "InstanceNorm_0"])
    for i in range(mp.generator.num_down_blocks):
        _conv_block2d(src, t, f"generator.down_blocks.{i}", base + [f"down_{i}"])
    for i in range(mp.generator.num_bottleneck_blocks):
        mb = base + [f"middle_{i}"]
        t.p(mb + ["Conv_0", "Conv_0", "kernel"],
            _conv2d(src.take(f"generator.middle.{i}.conv1.weight")))
        t.p(mb + ["Conv_0", "Conv_0", "bias"],
            src.take(f"generator.middle.{i}.conv1.bias"))
        t.p(mb + ["Conv_1", "Conv_0", "kernel"],
            _conv2d(src.take(f"generator.middle.{i}.conv2.weight")))
        t.p(mb + ["Conv_1", "Conv_0", "bias"],
            src.take(f"generator.middle.{i}.conv2.bias"))
        _bn_fix(src, t, f"generator.middle.{i}.norm1",
                mb + ["BatchNorm_0", "BatchNorm_0"])
        _bn_fix(src, t, f"generator.middle.{i}.norm2",
                mb + ["BatchNorm_1", "BatchNorm_0"])
    use_spade = src.has("generator.up_blocks.0.conv1.weight")
    for i in range(mp.generator.num_down_blocks):
        if not use_spade:
            _up_block(src, t, f"generator.up_blocks.{i}", base + [f"up_{i}"])
            continue
        # SPADE residual up block (residual_block.py:34-71 + spade_block.py)
        ub = base + [f"up_{i}"]
        ref = f"generator.up_blocks.{i}"
        for cname in ("conv1", "conv2"):
            t.p(ub + [cname, "Conv_0", "kernel"],
                _conv2d(src.take(f"{ref}.{cname}.weight")))
            t.p(ub + [cname, "Conv_0", "bias"],
                src.take(f"{ref}.{cname}.bias"))
        if src.has(f"{ref}.conv_s.weight"):
            t.p(ub + ["conv_s", "Conv_0", "kernel"],
                _conv2d(src.take(f"{ref}.conv_s.weight")))
        for nname in ("norm1", "norm2", "norm_s"):
            if not src.has(f"{ref}.{nname}.mlps.0.1.weight"):
                continue
            nb2 = ub + [nname]
            t.p(nb2 + ["mlp", "Conv_0", "Conv_0", "kernel"],
                _conv2d(src.take(f"{ref}.{nname}.mlps.0.0.conv.weight")))
            t.p(nb2 + ["mlp", "Conv_0", "Conv_0", "bias"],
                src.take(f"{ref}.{nname}.mlps.0.0.conv.bias"))
            # SameBlock2d(use_norm=False): created-but-unapplied norm params
            src.drop(f"{ref}.{nname}.mlps.0.0.norm.weight")
            src.drop(f"{ref}.{nname}.mlps.0.0.norm.bias")
            t.p(nb2 + ["gamma_beta", "Conv_0", "kernel"],
                _conv2d(src.take(f"{ref}.{nname}.mlps.0.1.weight")))
            t.p(nb2 + ["gamma_beta", "Conv_0", "bias"],
                src.take(f"{ref}.{nname}.mlps.0.1.bias"))
    if src.has("generator.flowembedder.conv_first.conv.weight"):
        fb = base + ["flowembedder"]
        t.p(fb + ["first", "Conv_0", "Conv_0", "kernel"],
            _conv2d(src.take("generator.flowembedder.conv_first.conv.weight")))
        t.p(fb + ["first", "Conv_0", "Conv_0", "bias"],
            src.take("generator.flowembedder.conv_first.conv.bias"))
        src.drop("generator.flowembedder.conv_first.norm.weight")  # use_norm=False
        src.drop("generator.flowembedder.conv_first.norm.bias")
        for i in range(mp.flow_embedder.num_down_blocks):
            _conv_block2d(src, t, f"generator.flowembedder.down_blocks.{i}",
                          fb + [f"down_{i}"])
            if src.has(f"generator.flowembedder.up_blocks.{i}.main.1.weight"):
                _up_block(src, t, f"generator.flowembedder.up_blocks.{i}",
                          fb + [f"up_{i}"])
    t.p(base + ["final", "Conv_0", "kernel"],
        _conv2d(src.take("generator.final.0.weight")))
    t.p(base + ["final", "Conv_0", "bias"], src.take("generator.final.0.bias"))
    if src.has("generator.first_warped.conv.weight"):
        # KITTI warped-image encoder branch (reference generator.py:37-48)
        t.p(base + ["first_warped", "Conv_0", "Conv_0", "kernel"],
            _conv2d(src.take("generator.first_warped.conv.weight")))
        t.p(base + ["first_warped", "Conv_0", "Conv_0", "bias"],
            src.take("generator.first_warped.conv.bias"))
        _inorm(src, t, "generator.first_warped.norm",
               base + ["first_warped", "InstanceNorm_0"])
        for i in range(mp.generator.num_down_blocks):
            _conv_block2d(src, t, f"generator.down_blocks_warped.{i}",
                          base + [f"down_warped_{i}"])
        t.p(base + ["pre_decode", "Conv_0", "Conv_0", "kernel"],
            _conv2d(src.take("generator.pre_decode.0.conv.weight")))
        t.p(base + ["pre_decode", "Conv_0", "Conv_0", "bias"],
            src.take("generator.pre_decode.0.conv.bias"))
        _inorm(src, t, "generator.pre_decode.0.norm",
               base + ["pre_decode", "InstanceNorm_0"])

    # ---- VGG19 (perceptual loss; absent from is_inference=True models) --------
    vgg_layout = [(1, 1, 0), (1, 2, 2), (2, 1, 5), (2, 2, 7), (3, 1, 10),
                  (3, 2, 12), (3, 3, 14), (3, 4, 16), (4, 1, 19), (4, 2, 21),
                  (4, 3, 23), (4, 4, 25), (5, 1, 28), (5, 2, 30), (5, 3, 32),
                  (5, 4, 34)]
    if src.has("objective_func.perceptual_loss.vgg19.relu1_1.0.weight"):
        for stage, j, idx in vgg_layout:
            ref = f"objective_func.perceptual_loss.vgg19.relu{stage}_{j}.{idx}"
            ours = ["vgg", f"conv{stage}_{j}", "Conv_0"]
            t.p(ours + ["kernel"], _conv2d(src.take(ref + ".weight")))
            t.p(ours + ["bias"], src.take(ref + ".bias"))
        src.drop("objective_func.perceptual_loss.vgg19.mean")
        src.drop("objective_func.perceptual_loss.vgg19.std")

    # ---- discriminators (absent from is_inference=True models) -----------------
    for ref_name, ours_name in (("netD_image", "netd_image"),
                                ("netD_video", "netd_video")):
        if not src.has(f"{ref_name}.discs.0.down_blocks.0.conv.weight"):
            continue
        for s in range(mp.discriminator.num_D):
            base = [ours_name, f"disc_{s}"]
            ref = f"{ref_name}.discs.{s}"
            for i in range(mp.discriminator.n_layers_D):
                db = base + [f"down_{i}"]
                t.p(db + ["Conv_0", "kernel"],
                    _conv2d(src.take(f"{ref}.down_blocks.{i}.conv.weight")))
                t.p(db + ["Conv_0", "bias"],
                    src.take(f"{ref}.down_blocks.{i}.conv.bias"))
                _bn_fix(src, t, f"{ref}.down_blocks.{i}.norm",
                        db + ["BatchNorm_0"])
            t.p(base + ["pred", "kernel"],
                _conv2d(src.take(f"{ref}.conv.weight_orig")))
            t.p(base + ["pred", "bias"], src.take(f"{ref}.conv.bias"))
            t.sp(base + ["pred", "u"], src.take(f"{ref}.conv.weight_u"))
            src.drop(f"{ref}.conv.weight_v")   # recomputed each forward

    left = [k for k in src.leftovers() if not k.endswith("num_batches_tracked")]
    if left:
        raise ValueError(f"unconverted reference keys ({len(left)}): "
                         f"{left[:10]} ...")
    for k in src.leftovers():
        src.drop(k)
    return {"params": t.params, "batch_stats": t.batch_stats,
            "spectral": t.spectral}


def merge(init: Mapping, conv: Mapping) -> Dict:
    """Deep-merge the converted tree over ``init`` (the fresh state's JAX
    tree): a branch the source lacks keeps its init; a converted branch or
    leaf with no place in ``init`` raises KeyError."""
    out = dict(init)
    for k, v in conv.items():
        if k not in init:
            raise KeyError(f"converted entry {k!r} has no place in the "
                           f"port's tree")
        out[k] = merge(init[k], v) if isinstance(v, dict) else v
    return out


def load_reference(path: str) -> Dict[str, np.ndarray]:
    """The generator state_dict of a reference ``.pth.tar`` as numpy arrays:
    the trainer's ``{"c2m": state_dict, ...}`` or a bare state_dict."""
    import torch
    blob = torch.load(path, map_location="cpu")
    sd = blob.get("c2m", blob)
    return {k: v.detach().numpy() for k, v in sd.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference latest_c2m_model.pth.tar")
    ap.add_argument("--config", required=True, help="yaml config")
    ap.add_argument("--out", required=True,
                    help="output job dir (a port checkpoint that "
                         "train_torch.py / eval_torch.py read)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from c2m_tpu_torch.config import load_config
    from c2m_tpu_torch.device import resolve_device
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.utils.checkpoint import save_checkpoint
    from c2m_tpu_torch.utils.convert import (from_jax_variables,
                                             to_jax_variables)

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    tree = convert_state_dict(load_reference(args.checkpoint), cfg)
    # a real port checkpoint (fresh optimizer state, step 0), so that the
    # entry points read it as they read their own
    state = create_train_state(cfg, seed=0, device=dev)
    init = to_jax_variables(state.model.state_dict(), cfg)
    state.model.load_state_dict(from_jax_variables(merge(init, tree), cfg))
    path = save_checkpoint(args.out, state, epoch=0, epoch_iter=0)
    print(f"wrote port checkpoint {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
