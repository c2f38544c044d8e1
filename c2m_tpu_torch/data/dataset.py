"""Dataset factory: the port's copy of ``c2m_tpu/data/dataset.py`` (dispatch
on ``dataset_params.dataset``, reference src/datasets/dataset.py:4-131).

``SyntheticDataset`` draws each clip from the port's
``data/synthetic.make_batch``, whose target flows are rasterized on
``device``: the card when None (an error without one), ``"cpu"`` on
request. The on-disk datasets read numpy only and take no device.
"""

from __future__ import annotations

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.device import resolve_device


class SyntheticDataset:
    """Hermetic synthetic clips with the full batch contract: clip ``i`` is
    ``make_batch(cfg, batch_size=1, seed=seed_offset + i)``."""

    def __init__(self, cfg: Config, n: int = 64, seed_offset: int = 0,
                 device=None):
        self.cfg, self.n, self.seed_offset = cfg, n, seed_offset
        self.device = resolve_device(device)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from c2m_tpu_torch.data.synthetic import make_batch
        b = make_batch(self.cfg, batch_size=1, seed=self.seed_offset + i,
                       device=self.device)
        return {k: v[0] for k, v in b.items()}


def get_training_set(cfg: Config, device=None):
    name = cfg.dataset_params.dataset
    if name in ("cityscapes", "kitti"):
        from c2m_tpu_torch.data.cityscapes import ClipDataset
        return ClipDataset(cfg, split="train")
    if name == "mvtid":
        from c2m_tpu_torch.data.mvtid import MvtidDataset
        return MvtidDataset(cfg, split="train")
    if name == "synthetic":
        return SyntheticDataset(cfg, device=device)
    raise ValueError(f"unknown dataset {name!r} "
                     "(cityscapes | kitti | mvtid | synthetic)")


def get_test_set(cfg: Config, device=None):
    name = cfg.dataset_params.dataset
    if name in ("cityscapes", "kitti"):
        from c2m_tpu_torch.data.cityscapes import ClipDataset
        return ClipDataset(cfg, split="val")
    if name == "mvtid":
        from c2m_tpu_torch.data.mvtid import MvtidDataset
        return MvtidDataset(cfg, split="val")
    if name == "synthetic":
        return SyntheticDataset(cfg, n=8, seed_offset=10_000, device=device)
    raise ValueError(f"unknown dataset {name!r}")
