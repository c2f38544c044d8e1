"""The port refuses the KITTI configuration instead of building another model.

``configs/c2m_kitti.yaml`` sets ``dataset: "kitti"``, for which the JAX
generator adds its warped-image branch (``c2m_tpu/models/generator.py``).
The port has no such branch yet, so its generator raises before any weight
is built, and every entry point that builds through it (``C2MTrainModel``,
``create_train_state``, ``ServingModel``) raises with it.
"""

import os

import pytest

from c2m_tpu_torch.config import load_config
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.train.state import create_train_state

KITTI_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "c2m_kitti.yaml")


@pytest.mark.parametrize("build", [
    C2MGenerator, lambda cfg: create_train_state(cfg, device="cpu")],
    ids=["C2MGenerator", "create_train_state"])
def test_kitti_config_is_refused(build):
    cfg = load_config(KITTI_YAML)
    assert "kitti" in cfg.dataset_params.dataset
    with pytest.raises(NotImplementedError, match="KITTI"):
        build(cfg)
