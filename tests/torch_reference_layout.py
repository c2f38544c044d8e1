"""The way back of the reference-checkpoint converter, for the tests: a port
``C2MTrainModel`` state_dict -> the reference ``GeneratorFullModel``
state_dict (its keys and layouts), as ``latest_c2m_model.pth.tar`` holds it.
No package has this direction; ``tools/convert_c2m.convert_state_dict`` and
its copy in ``c2m_tpu_torch/tools/convert_c2m.py`` go the other way, and
the tests hold them to it. Torch and numpy only: ``chip_smoke.py`` imports
it on a machine without JAX.

Each reference key is taken from the port tensor that the bridge
(``utils/convert``) puts at the JAX path ``convert_state_dict`` writes it
to. Torch keeps the reference's own layouts (conv [Co,C,kh,kw], conv3d
[Co,C,kt,kh,kw], Linear [out,in]), so the transposes of the JAX layout
fall away here; what is left:

- the flatten-boundary Linears: the VAE heads' and ``fuse_appearance_roi``'s
  input columns and ``motion_encoder.fc``'s output rows go back from the
  (h,w,C) order to the reference's (C,h,w);
- the fused 32 -> 64 predictor head conv splits into the flow and the
  occlusion predictors' convs;
- GATv2: PyG's att [1,H,C]; the reference's lin_r has no bias, so the
  port's must be zero (the converter sets it so), else this raises;
- the discriminators' spectral norm: ``conv.weight_orig``, ``weight_u`` and
  a ``weight_v``;
- the keys ``convert_state_dict`` consumes and drops (y_encoder,
  decoder.linear_z, the per-scale predictors, the unapplied norms, VGG's
  mean / std, ``weight_v``, ``num_batches_tracked``) are filled from
  ``seed``, so that dropping them is exercised.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from c2m_tpu_torch.utils.convert import _skeleton, _walk

VGG_LAYOUT = [(1, 1, 0), (1, 2, 2), (2, 1, 5), (2, 2, 7), (3, 1, 10),
              (3, 2, 12), (3, 3, 14), (3, 4, 16), (4, 1, 19), (4, 2, 21),
              (4, 3, 23), (4, 4, 25), (5, 1, 28), (5, 2, 30), (5, 3, 32),
              (5, 4, 34)]


def _perm_chw_to_hwc(c, h, w):
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


class _Inverse:
    """Reads port tensors by JAX path, each at most once, and writes
    reference keys."""

    def __init__(self, state_dict, cfg, seed):
        self.port = {path: key for key, path, _, _ in
                     _walk(_skeleton(cfg, train=True))}
        self.state = state_dict
        self.used = set()
        self.sd: Dict[str, np.ndarray] = {}
        self.rng = np.random.RandomState(seed)

    def take(self, path: str) -> np.ndarray:
        if path in self.used:
            raise ValueError(f"{path} read twice")
        self.used.add(path)
        return self.state[self.port[path]].detach().cpu().float().numpy()

    def has(self, path: str) -> bool:
        return path in self.port

    def put(self, key: str, value: np.ndarray) -> None:
        if key in self.sd:
            raise ValueError(f"reference key {key} written twice")
        self.sd[key] = np.ascontiguousarray(value)

    def dead(self, key: str, *shape) -> None:
        """A key the converter drops, with a random value."""
        self.put(key, self.rng.randn(*shape).astype(np.float32))

    def conv(self, ref: str, ours: str, bias: bool = True) -> None:
        self.put(ref + ".weight", self.take(f"params/{ours}/kernel"))
        if bias:
            self.put(ref + ".bias", self.take(f"params/{ours}/bias"))

    def bn(self, ref: str, ours: str) -> None:
        self.put(ref + ".weight", self.take(f"params/{ours}/scale"))
        self.put(ref + ".bias", self.take(f"params/{ours}/bias"))
        self.put(ref + ".running_mean", self.take(f"batch_stats/{ours}/mean"))
        self.put(ref + ".running_var", self.take(f"batch_stats/{ours}/var"))
        self.put(ref + ".num_batches_tracked",
                 np.asarray(self.rng.randint(1, 10000), np.int64))

    def inorm(self, ref: str, ours: str) -> None:
        self.put(ref + ".weight", self.take(f"params/{ours}/scale"))
        self.put(ref + ".bias", self.take(f"params/{ours}/bias"))

    def block2d(self, ref: str, ours: str) -> None:
        self.conv(ref + ".conv", ours + "/Conv_0/Conv_0")
        self.bn(ref + ".norm", ours + "/BatchNorm_0/BatchNorm_0")

    def block3d(self, ref: str, ours: str) -> None:
        self.conv(ref + ".conv", ours + "/Conv3d_0/Conv_0")
        self.bn(ref + ".norm", ours + "/BatchNorm_0/BatchNorm_0")

    def up_block(self, ref: str, ours: str) -> None:
        self.conv(ref + ".main.1", ours + "/Conv_0/Conv_0")
        self.bn(ref + ".main.2", ours + "/BatchNorm_0/BatchNorm_0")

    def dense(self, ref: str, ours: str, in_perm=None, out_perm=None) -> None:
        w = self.take(f"params/{ours}/Dense_0/kernel")          # [out, in]
        b = self.take(f"params/{ours}/Dense_0/bias")
        if in_perm is not None:
            w_ref = np.empty_like(w)
            w_ref[:, in_perm] = w
            w = w_ref
        if out_perm is not None:
            w_ref, b_ref = np.empty_like(w), np.empty_like(b)
            w_ref[out_perm], b_ref[out_perm] = w, b
            w, b = w_ref, b_ref
        self.put(ref + ".weight", w)
        self.put(ref + ".bias", b)


def reference_state_dict(state_dict, cfg, seed: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """A port ``C2MTrainModel`` state_dict -> the reference state_dict that
    ``convert_state_dict`` maps back onto ``to_jax_variables`` of it."""
    tp, mp = cfg.train_params, cfg.model_params
    r = _Inverse(state_dict, cfg, seed)
    h, w = tp.input_size
    sf = mp.common_params.scale_factor
    nd_app = mp.appearance_encoder.num_down_blocks
    h_app = int(h / (2 ** nd_app) * sf)
    w_app = int(w / (2 ** nd_app) * sf)
    c_app = min(mp.appearance_encoder.max_expansion,
                mp.appearance_encoder.block_expansion * 2 ** (nd_app - 1))

    # appearance encoder
    base = "c2m/appearance_encoder"
    for i in range(nd_app):
        r.block2d(f"appearance_encoder.down_blocks.{i}", f"{base}/down_{i}")
    roi = "appearance_encoder.roi_align_blocks.0"
    r.conv(roi + ".conv", f"{base}/roi_conv/Conv_0/Conv_0")
    c_roi = r.sd[roi + ".conv.bias"].shape[0]
    r.dead(roi + ".norm.weight", c_roi)
    r.dead(roi + ".norm.bias", c_roi)
    r.dense("appearance_encoder.roi_align_blocks.2", f"{base}/roi_fc")
    r.dense("appearance_encoder.roi_align_regressor", f"{base}/roi_regressor")
    n_scene = c_app * h_app * w_app
    n_in = state_dict[r.port[f"params/{base}/fuse_appearance_roi/Dense_0/"
                             "kernel"]].shape[1]
    perm = np.concatenate([_perm_chw_to_hwc(c_app, h_app, w_app),
                           n_scene + np.arange(n_in - n_scene)])
    r.dense("appearance_encoder.fuse_appearance_roi",
            f"{base}/fuse_appearance_roi", in_perm=perm)

    # sparse motion estimator (click GNN)
    base = "c2m/sparse_motion_estimator"
    sme = "motion_encoder.sparse_motion_estimator"
    r.dense(f"{sme}.x_encoder.0", f"{base}/x_enc1")
    r.dense(f"{sme}.x_encoder.2", f"{base}/x_enc2")
    for i, (fc, bn) in enumerate(((0, 1), (3, 4))):
        r.dense(f"{sme}.encode_scene_features.{fc}", f"{base}/scene_fc{i + 1}")
        r.bn(f"{sme}.encode_scene_features.{bn}", f"{base}/scene_bn{i + 1}")
    r.dense(f"{sme}.encode_scene_features.6", f"{base}/scene_fc3")
    d_x = r.sd[f"{sme}.x_encoder.0.weight"].shape[1]
    r.dead(f"{sme}.y_encoder.0.weight", 16, d_x)
    r.dead(f"{sme}.y_encoder.0.bias", 16)
    r.dead(f"{sme}.decoder.linear_z.weight", 8, 16)
    r.dead(f"{sme}.decoder.linear_z.bias", 8)
    for t in range(tp.num_predicted_frames):
        g, ours = f"{sme}.decoder.conv_time_steps.{t}", f"{base}/gat_{t}"
        r.put(g + ".att", r.take(f"params/{ours}/att")[None])
        r.put(g + ".bias", r.take(f"params/{ours}/bias"))
        for lin in ("lin_l", "lin_r"):
            r.put(f"{g}.{lin}.weight",
                  r.take(f"params/{ours}/{lin}/Dense_0/kernel"))
        r.put(g + ".lin_l.bias", r.take(f"params/{ours}/lin_l/Dense_0/bias"))
        if np.any(r.take(f"params/{ours}/lin_r/Dense_0/bias")):
            raise ValueError(f"{ours}/lin_r has a bias the reference lacks: "
                             "zero it first")
        loc = f"{sme}.decoder.loc_time_steps.{t}"
        r.dense(loc + ".0", f"{base}/loc_{t}/fc1")
        r.dense(loc + ".2", f"{base}/loc_{t}/fc2")

    # VAE encoders and the sparse pyramid
    for name in ("motion_encoder_bg", "motion_encoder_fg"):
        ref, base = f"motion_encoder.{name}", f"c2m/{name}"
        n_down = len(mp.motion_estimator.dense_motion_encoder.t_kernel)
        for i in range(n_down):
            r.block3d(f"{ref}.down_blocks.{i}", f"{base}/down_{i}")
        c_enc = r.sd[f"{ref}.down_blocks.{n_down - 1}.conv.bias"].shape[0]
        hw = state_dict[r.port[f"params/{base}/fc_mu/Dense_0/kernel"]
                        ].shape[1] // c_enc
        h_enc = int(round((hw / (w / h)) ** 0.5))
        perm = _perm_chw_to_hwc(c_enc, h_enc, hw // h_enc)
        r.dense(f"{ref}.fc1", f"{base}/fc_mu", in_perm=perm)
        r.dense(f"{ref}.fc2", f"{base}/fc_logvar", in_perm=perm)
    sparse_down = mp.motion_estimator.sparse_motion_encoder.num_down_blocks
    for i in range(sparse_down):
        r.block3d(f"motion_encoder.sparse_feature_encoder.down_blocks.{i}",
                  f"c2m/sparse_feature_encoder/down_{i}")

    # dense motion decoder(s)
    nb = mp.motion_estimator.dense_motion_decoder.num_up_blocks
    for name in ("dense_generator_bw",) + (
            ("dense_generator_fw",) if tp.use_fw_of else ()):
        ref, base = f"motion_encoder.{name}", f"c2m/{name}"
        r.block3d(f"{ref}.first", f"{base}/first")
        for i in range(nb):
            r.up_block(f"{ref}.up_blocks.{i}", f"{base}/up_{i}")
        for i in range(sparse_down):
            r.block3d(f"{ref}.fuse_convs.{i}", f"{base}/fuse_{i}")
        r.up_block(f"{ref}.final_up_block", f"{base}/final_up")
        r.block3d(f"{ref}.final_fuse", f"{base}/final_fuse")
        heads = f"{base}/heads"
        wk = r.take(f"params/{heads}/block_conv/Conv_0/kernel")
        bk = r.take(f"params/{heads}/block_conv/Conv_0/bias")
        cf = state_dict[r.port[f"params/{heads}/norm_flow/scale"]].shape[0]
        flow, occ = f"{ref}.flow.flow_predictor", \
            f"{ref}.occlusion.occlusion_predictor"
        r.put(flow + ".0.conv.weight", wk[:cf])
        r.put(flow + ".0.conv.bias", bk[:cf])
        r.put(occ + ".0.conv.weight", wk[cf:])
        r.put(occ + ".0.conv.bias", bk[cf:])
        r.inorm(flow + ".0.norm", f"{heads}/norm_flow")
        r.inorm(occ + ".0.norm", f"{heads}/norm_occ")
        r.conv(flow + ".2", f"{heads}/flow_head/Conv_0")
        r.conv(occ + ".2", f"{heads}/occ_head/Conv_0")
        for kind in ("flow_predictors", "occlusion_predictors"):
            r.dead(f"{ref}.{kind}.0.weight", 2, cf, 3, 3)
            r.dead(f"{ref}.{kind}.0.bias", 2)

    # z plumbing
    r.dense("motion_encoder.fc", "c2m/fc",
            out_perm=_perm_chw_to_hwc(64, h_app, w_app))
    r.conv("motion_encoder.zconv.conv", "c2m/zconv/Conv_0/Conv_0")
    r.conv("motion_encoder.zconv.conv2", "c2m/zconv/Conv_1/Conv_0")
    r.inorm("motion_encoder.zconv.norm", "c2m/zconv/InstanceNorm_0")

    # generator
    base = "c2m/generator"
    r.conv("generator.first.conv", f"{base}/first/Conv_0/Conv_0")
    r.inorm("generator.first.norm", f"{base}/first/InstanceNorm_0")
    for i in range(mp.generator.num_down_blocks):
        r.block2d(f"generator.down_blocks.{i}", f"{base}/down_{i}")
    for i in range(mp.generator.num_bottleneck_blocks):
        ref, mb = f"generator.middle.{i}", f"{base}/middle_{i}"
        r.conv(ref + ".conv1", f"{mb}/Conv_0/Conv_0")
        r.conv(ref + ".conv2", f"{mb}/Conv_1/Conv_0")
        r.bn(ref + ".norm1", f"{mb}/BatchNorm_0/BatchNorm_0")
        r.bn(ref + ".norm2", f"{mb}/BatchNorm_1/BatchNorm_0")
    for i in range(mp.generator.num_down_blocks):
        ref, ub = f"generator.up_blocks.{i}", f"{base}/up_{i}"
        if not r.has(f"params/{ub}/conv1/Conv_0/kernel"):
            r.up_block(ref, ub)
            continue
        r.conv(ref + ".conv1", f"{ub}/conv1/Conv_0")
        r.conv(ref + ".conv2", f"{ub}/conv2/Conv_0")
        if r.has(f"params/{ub}/conv_s/Conv_0/kernel"):
            r.conv(ref + ".conv_s", f"{ub}/conv_s/Conv_0", bias=False)
        for nname in ("norm1", "norm2", "norm_s"):
            if not r.has(f"params/{ub}/{nname}/gamma_beta/Conv_0/kernel"):
                continue
            mlp = f"{ref}.{nname}.mlps.0"
            r.conv(mlp + ".0.conv", f"{ub}/{nname}/mlp/Conv_0/Conv_0")
            c_mlp = r.sd[mlp + ".0.conv.bias"].shape[0]
            r.dead(mlp + ".0.norm.weight", c_mlp)
            r.dead(mlp + ".0.norm.bias", c_mlp)
            r.conv(mlp + ".1", f"{ub}/{nname}/gamma_beta/Conv_0")
    fb = f"{base}/flowembedder"
    if r.has(f"params/{fb}/first/Conv_0/Conv_0/kernel"):
        emb = "generator.flowembedder"
        r.conv(emb + ".conv_first.conv", f"{fb}/first/Conv_0/Conv_0")
        c_first = r.sd[emb + ".conv_first.conv.bias"].shape[0]
        r.dead(emb + ".conv_first.norm.weight", c_first)
        r.dead(emb + ".conv_first.norm.bias", c_first)
        for i in range(mp.flow_embedder.num_down_blocks):
            r.block2d(f"{emb}.down_blocks.{i}", f"{fb}/down_{i}")
            if r.has(f"params/{fb}/up_{i}/Conv_0/Conv_0/kernel"):
                r.up_block(f"{emb}.up_blocks.{i}", f"{fb}/up_{i}")
    r.conv("generator.final.0", f"{base}/final/Conv_0")
    if r.has(f"params/{base}/first_warped/Conv_0/Conv_0/kernel"):
        r.conv("generator.first_warped.conv",
               f"{base}/first_warped/Conv_0/Conv_0")
        r.inorm("generator.first_warped.norm",
                f"{base}/first_warped/InstanceNorm_0")
        for i in range(mp.generator.num_down_blocks):
            r.block2d(f"generator.down_blocks_warped.{i}",
                      f"{base}/down_warped_{i}")
        r.conv("generator.pre_decode.0.conv",
               f"{base}/pre_decode/Conv_0/Conv_0")
        r.inorm("generator.pre_decode.0.norm",
                f"{base}/pre_decode/InstanceNorm_0")

    # VGG19 and the discriminators, where the model has them
    vgg = "objective_func.perceptual_loss.vgg19"
    if r.has("params/vgg/conv1_1/Conv_0/kernel"):
        for stage, j, idx in VGG_LAYOUT:
            r.conv(f"{vgg}.relu{stage}_{j}.{idx}",
                   f"vgg/conv{stage}_{j}/Conv_0")
        r.dead(f"{vgg}.mean", 1, 3, 1, 1)
        r.dead(f"{vgg}.std", 1, 3, 1, 1)
    for ref_name, ours_name in (("netD_image", "netd_image"),
                                ("netD_video", "netd_video")):
        if not r.has(f"params/{ours_name}/disc_0/pred/kernel"):
            continue
        for s in range(mp.discriminator.num_D):
            ref, base = f"{ref_name}.discs.{s}", f"{ours_name}/disc_{s}"
            for i in range(mp.discriminator.n_layers_D):
                r.conv(f"{ref}.down_blocks.{i}.conv",
                       f"{base}/down_{i}/Conv_0")
                r.bn(f"{ref}.down_blocks.{i}.norm",
                     f"{base}/down_{i}/BatchNorm_0")
            r.put(ref + ".conv.weight_orig",
                  r.take(f"params/{base}/pred/kernel"))
            r.put(ref + ".conv.bias", r.take(f"params/{base}/pred/bias"))
            u = r.take(f"spectral/{base}/pred/u")
            r.put(ref + ".conv.weight_u", u)
            fan_in = int(np.prod(r.sd[ref + ".conv.weight_orig"].shape[1:]))
            r.dead(ref + ".conv.weight_v", fan_in)

    left = sorted(set(r.port) - r.used)
    if left:
        raise KeyError(f"port tensors with no reference key: {left[:8]}")
    return {k: torch.from_numpy(v) for k, v in r.sd.items()}


def save_reference(path: str, state_dict, cfg, seed: int = 0) -> None:
    """Write a port state_dict as the reference trainer's checkpoint:
    ``{"c2m": reference state_dict, "epoch": 0}``."""
    torch.save({"c2m": reference_state_dict(state_dict, cfg, seed),
                "epoch": 0}, path)
