# Frozen copy of c2m_tpu_torch/config.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Typed configuration of the port: its own copy of ``c2m_tpu/config.py``.

The same dataclasses, section by section (``dataset_params / train_params /
model_params / test_params / visualizer_params / checkpoint_params``), the
same key checking when a YAML file is applied, ``tiny_config`` and
``shrink_model``. The port imports nothing of the JAX package, so it keeps
this copy; ``tests/test_torch_config.py`` compares the two field by field so
they cannot drift apart. In place of ``Config.validate`` (which imports the
JAX layer library) stands :func:`check`, which checks what the port needs.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
JOURNAL = os.path.join(CONFIG_DIR, "c2m_journal_cityscapes.yaml")


def _update_dataclass(obj, data: Dict[str, Any], path: str = ""):
    """Recursively apply a dict onto a dataclass instance, validating keys."""
    names = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"Unknown config key '{path}{key}' for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value, path=f"{path}{key}.")
        else:
            setattr(obj, key, value)
    return obj


@dataclass(eq=False)
class DatasetParams:
    root: str = ""
    dataset: str = "cityscapes"  # cityscapes | kitti | mvtid | synthetic
    train_images_path: str = "train256_128/"
    val_images_path: str = "val256_128/"
    train_data_list: str = "cityscapes_train.txt"
    val_data_list: str = "cityscapes_val.txt"
    train_segmasks_path: str = "train_semantic_segmask256x128"
    val_segmasks_path: str = "val_semantic_segmask256x128"
    segmask_suffix: str = "ssmask.png"
    train_instances_path: str = "train_instance256x128"
    val_instances_path: str = "val_instance256x128"
    instance_suffix: str = "gtFine_instanceIds.png"
    train_tracking_path: str = "train_instance_tracking_test"
    val_tracking_path: str = "val_instance_tracking_test"
    train_bw_occ_path: str = "train_bw_occlusion_128x256"
    val_bw_occ_path: str = "val_bw_occlusion_128x256"
    bw_occ_suffix: str = "leftImg8bit_occlusion_bw.png"
    train_bw_of_path: str = "train_bw_optical_flow_128x256"
    val_bw_of_path: str = "val_bw_optical_flow_128x256"
    bw_of_suffix: str = "leftImg8bit_flow_backward.flow"
    train_fw_occ_path: str = "train_fw_occlusion_128x256"
    val_fw_occ_path: str = "val_fw_occlusion_128x256"
    fw_occ_suffix: str = "leftImg8bit_occlusion_fw.png"
    train_fw_of_path: str = "train_fw_optical_flow_128x256"
    val_fw_of_path: str = "val_fw_optical_flow_128x256"
    fw_of_suffix: str = "leftImg8bit_flow_forward.flow"
    # static max number of tracked objects per clip (padded dense nodes)
    max_objects: int = 16


@dataclass(eq=False)
class LossWeights:
    flow_reconstruction: float = 10.0
    flow_smooth: float = 0.0
    flowcon: float = 0.0
    reconstruction: float = 100.0
    kl: float = 100.0
    ssim: float = 10.0
    perceptual: float = 10.0
    style: float = 0.0
    occlusion_bw: float = 20.0
    occlusion_fw: float = 20.0
    g_gan_image: float = 1.0
    g_gan_video: float = 1.0
    feature_matching_image: float = 10.0
    feature_matching_video: float = 10.0
    warped: float = 100.0
    scale: float = 2.0
    rotation: float = 1.0
    translation: float = 100.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclass(eq=False)
class TrainParams:
    num_input_frames: int = 1
    num_predicted_frames: int = 5
    input_size: List[int] = field(default_factory=lambda: [128, 256])  # [H, W]
    num_epochs: int = 300
    lr_rate_d: float = 4.0e-4
    lr_rate_g: float = 2.0e-4
    lr_rate_gnn: float = 1.0e-4
    gamma_d: float = 0.8
    gamma_g: float = 0.9
    gamma_gnn: float = 1.0
    milestone_start: int = 100
    milestone_end: int = 400
    milestone_every: int = 50
    seed: int = 31415
    batch_size: int = 3
    workers: int = 4
    local_world_size: int = 1
    use_gt_training: bool = True
    use_gt_eval: bool = False
    use_pre_processed_of: bool = True
    use_fw_of: bool = False
    beta1: float = 0.5
    beta2: float = 0.999
    eps: float = 1e-7
    continue_train: bool = False
    use_image_discriminator: bool = True
    use_video_discriminator: bool = True
    eval_freq: int = 4600
    which_epoch: str = "latest"
    loss_weights: LossWeights = field(default_factory=LossWeights)
    dtype: str = "bfloat16"        # compute dtype of the conv stacks
    steps_per_epoch: Optional[int] = None
    # Keys of the JAX package's YAML files that only its TPU train step
    # reads (rematerialisation, frame scan, space-to-depth tail). They are
    # read so the same files load, and ignored by the port.
    remat: bool = False
    remat_policy: str = ""
    remat_segments: str = "all"
    scan_frames: int = 0
    s2d_tail: bool = False

    @property
    def num_frames(self) -> int:
        return self.num_input_frames + self.num_predicted_frames

    @property
    def milestones(self) -> List[int]:
        return list(range(self.milestone_start, self.milestone_end, self.milestone_every))


@dataclass(eq=False)
class CommonParams:
    scale_factor: float = 1.0
    image_channel: int = 3
    seg_channel_bg: int = 11
    seg_channel_fg: int = 9
    instance_channel: int = 1
    flow_channel: int = 2
    occlusion_channel: int = 1


@dataclass(eq=False)
class SparseMotionEstimatorParams:
    h_dim: int = 512
    z_dim: int = 1024
    num_features_x: int = 23
    num_features_y: int = 6
    num_head: int = 4


@dataclass(eq=False)
class SparseMotionEncoderParams:
    block_expansion: int = 32
    num_down_blocks: int = 4
    max_expansion: int = 512
    in_channel: int = 2
    padding_mode: str = "reflect"


@dataclass(eq=False)
class DenseMotionEncoderParams:
    out_channel_bg: int = 512
    out_channel_fg: int = 512
    max_expansion: int = 512
    block_expansion: int = 32
    num_down_blocks: int = 6
    padding_mode: str = "reflect"
    t_kernel: List[int] = field(default_factory=lambda: [4, 3, 3, 4, 1, 1, 1])
    h_kernel: List[int] = field(default_factory=lambda: [4, 4, 4, 4, 4, 4, 3])
    w_kernel: List[int] = field(default_factory=lambda: [4, 4, 4, 4, 4, 4, 3])
    t_stride: List[int] = field(default_factory=lambda: [2, 1, 1, 2, 1, 1, 1])
    h_stride: List[int] = field(default_factory=lambda: [2, 2, 2, 2, 2, 2, 1])
    w_stride: List[int] = field(default_factory=lambda: [2, 2, 2, 2, 2, 2, 1])
    t_padding: List[int] = field(default_factory=lambda: [1, 1, 1, 1, 0, 0, 0])
    h_padding: List[int] = field(default_factory=lambda: [1, 1, 1, 1, 1, 1, 1])
    w_padding: List[int] = field(default_factory=lambda: [1, 1, 1, 1, 1, 1, 1])


@dataclass(eq=False)
class DenseMotionDecoderParams:
    in_channel: int = 528
    out_channel: int = 32
    block_expansion: int = 32
    max_expansion: int = 512
    num_up_blocks: int = 5
    padding_mode: str = "reflect"
    use_appearance_feature: bool = True
    use_feature_resample: bool = True


@dataclass(eq=False)
class MotionEstimatorParams:
    sparse_motion_estimator: SparseMotionEstimatorParams = field(
        default_factory=SparseMotionEstimatorParams)
    sparse_motion_encoder: SparseMotionEncoderParams = field(
        default_factory=SparseMotionEncoderParams)
    dense_motion_encoder: DenseMotionEncoderParams = field(
        default_factory=DenseMotionEncoderParams)
    dense_motion_decoder: DenseMotionDecoderParams = field(
        default_factory=DenseMotionDecoderParams)


@dataclass(eq=False)
class DiscriminatorParams:
    in_channel: int = 3
    ndf: int = 32
    n_layers_D: int = 4
    num_D: int = 1
    padding_mode: str = "reflect"


@dataclass(eq=False)
class AppearanceEncoderParams:
    block_expansion: int = 32
    num_down_blocks: int = 6
    max_expansion: int = 512
    pooling_after: int = 2
    padding_mode: str = "reflect"
    pool_size: int = 7


@dataclass(eq=False)
class GeneratorParams:
    block_expansion: int = 32
    num_down_blocks: int = 3
    max_expansion: int = 512
    num_bottleneck_blocks: int = 4
    padding_mode: str = "reflect"
    use_skip: bool = False
    # missing from the reference YAML but read by the reference generator
    use_spade: bool = False


@dataclass(eq=False)
class FlowEmbedderParams:
    input_channel: int = 6
    block_expansion: int = 32
    num_down_blocks: int = 3
    max_expansion: int = 512
    padding_mode: str = "reflect"
    use_decoder: bool = True


@dataclass(eq=False)
class ModelParams:
    common_params: CommonParams = field(default_factory=CommonParams)
    motion_estimator: MotionEstimatorParams = field(default_factory=MotionEstimatorParams)
    discriminator: DiscriminatorParams = field(default_factory=DiscriminatorParams)
    appearance_encoder: AppearanceEncoderParams = field(default_factory=AppearanceEncoderParams)
    generator: GeneratorParams = field(default_factory=GeneratorParams)
    flow_embedder: FlowEmbedderParams = field(default_factory=FlowEmbedderParams)


@dataclass(eq=False)
class TestParams:
    phase: str = "test"
    use_pre_processed_of: bool = True
    input_size: List[int] = field(default_factory=lambda: [128, 256])
    seed: int = 31415
    batch_size: int = 12
    workers: int = 10
    num_input_frames: int = 1
    num_predicted_frames: int = 5
    use_gt_eval: bool = True
    lambda_traj: float = 1.0
    custom_test: bool = True
    yolo_version: int = 3
    load_index_user_guidance: bool = True
    save_index_user_guidance: bool = False
    num_samples: int = 1
    which_epoch: str = "latest"


@dataclass(eq=False)
class VisualizerParams:
    display_winsize: int = 512
    tf_log: bool = True
    display_freq: int = 1460
    print_freq: int = 400
    save_latest_freq: int = 100
    use_html: bool = True
    grid_size: List[int] = field(default_factory=lambda: [2, 4])


@dataclass(eq=False)
class CheckpointParams:
    save_epoch_freq: int = 10


@dataclass(eq=False)
class ParallelParams:
    """Device-mesh layout of the JAX package; read from YAML, unused here."""
    data_axis: int = -1
    model_axis: int = 1


@dataclass(eq=False)
class Config:
    name: str = "c2m_journal"
    suffix: str = ""
    workspace: str = "runs"
    dataset_params: DatasetParams = field(default_factory=DatasetParams)
    train_params: TrainParams = field(default_factory=TrainParams)
    model_params: ModelParams = field(default_factory=ModelParams)
    test_params: TestParams = field(default_factory=TestParams)
    visualizer_params: VisualizerParams = field(default_factory=VisualizerParams)
    checkpoint_params: CheckpointParams = field(default_factory=CheckpointParams)
    parallel_params: ParallelParams = field(default_factory=ParallelParams)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def tiny_config(h: int = 64, w: int = 128, num_predicted: int = 5,
                max_objects: int = 4, batch_size: int = 1) -> Config:
    """Small config for tests (64x128 by default)."""
    cfg = Config()
    cfg.dataset_params.dataset = "synthetic"
    cfg.dataset_params.max_objects = max_objects
    cfg.train_params.input_size = [h, w]
    cfg.train_params.batch_size = batch_size
    cfg.train_params.num_predicted_frames = num_predicted
    cfg.test_params.input_size = [h, w]
    cfg.test_params.num_predicted_frames = num_predicted
    return check(cfg)


def shrink_model(cfg: Config, block_expansion: int = 16,
                 max_expansion: int = 128) -> Config:
    """Width-shrink every module (structure unchanged: same modules, losses,
    optimizer groups) for cheap tests."""
    mp = cfg.model_params
    for section in (mp.appearance_encoder, mp.generator, mp.discriminator,
                    mp.flow_embedder, mp.motion_estimator.sparse_motion_encoder,
                    mp.motion_estimator.dense_motion_encoder,
                    mp.motion_estimator.dense_motion_decoder):
        if hasattr(section, "block_expansion"):
            section.block_expansion = block_expansion
        if hasattr(section, "max_expansion"):
            section.max_expansion = max_expansion
        if hasattr(section, "ndf"):
            section.ndf = block_expansion
    me = cfg.model_params.motion_estimator
    me.dense_motion_encoder.out_channel_bg = max_expansion
    me.dense_motion_encoder.out_channel_fg = max_expansion
    me.sparse_motion_estimator.h_dim = max_expansion
    me.sparse_motion_estimator.z_dim = max_expansion * 2
    return cfg


def check(cfg: Config) -> Config:
    tp, mp = cfg.train_params, cfg.model_params
    down = 2 ** mp.appearance_encoder.num_down_blocks
    for size in (tp.input_size, cfg.test_params.input_size):
        if size[0] % down or size[1] % down:
            raise ValueError(f"input_size {size} must be divisible by the "
                             f"appearance encoder's downsampling {down}")
    if tp.num_input_frames < 1 or tp.num_predicted_frames < 1:
        raise ValueError("need at least 1 input and 1 predicted frame")
    enc = mp.motion_estimator.dense_motion_encoder
    if len({len(getattr(enc, f"{a}_{k}")) for a in "thw"
            for k in ("kernel", "stride", "padding")}) != 1:
        raise ValueError("dense_motion_encoder kernel/stride/padding lists "
                         "must all have the same length")
    if cfg.dataset_params.max_objects < 1:
        raise ValueError("max_objects must be >= 1")
    if tp.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown dtype {tp.dtype}")
    return cfg


def load_config(path: str = JOURNAL) -> Config:
    """YAML file -> checked ``Config`` (unknown keys raise, as in c2m_tpu)."""
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return check(_update_dataclass(Config(), data))
