"""The port's own copies of ``c2m_tpu/config.py`` and of the numpy scene code
of ``c2m_tpu/data/synthetic.py`` against the originals, so that they cannot
drift apart unnoticed: the same YAML files and the same ``tiny_config`` /
``shrink_model`` calls give equal ``dataclasses.asdict`` trees, and
``make_batch`` gives the same batch key by key (identical numpy streams;
the rasterized flows and occlusions within the raster gates: flows 1e-5 of
the width, {0,1} maps on <= 1e-4 of pixels).
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from c2m_tpu import config as jconfig
from c2m_tpu.data import synthetic as jsynthetic
from c2m_tpu_torch import config as pconfig
from c2m_tpu_torch.data import synthetic as psynthetic
from tests.torch_port_fixtures import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_the_dataclasses_have_the_same_fields_and_defaults():
    assert dataclasses.asdict(pconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    for name in dir(jconfig):
        cls = getattr(jconfig, name)
        if dataclasses.is_dataclass(cls) and isinstance(cls, type):
            twin = getattr(pconfig, name)
            assert [(f.name, f.type) for f in dataclasses.fields(twin)] == \
                [(f.name, f.type) for f in dataclasses.fields(cls)], name
    tp = pconfig.TrainParams()
    assert tp.num_frames == jconfig.TrainParams().num_frames
    assert tp.milestones == jconfig.TrainParams().milestones
    assert pconfig.LossWeights().as_dict() == jconfig.LossWeights().as_dict()


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_files_load_the_same(path):
    """Every shipped YAML, the TPU-only training keys included: read, kept
    in the tree, and ignored by the port."""
    assert YAMLS
    want = jconfig.Config.from_yaml(path)
    got = pconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("kwargs", [{}, dict(h=128, w=256, num_predicted=3,
                                             max_objects=6, batch_size=2)])
def test_tiny_config_and_shrink_model(kwargs):
    want, got = jconfig.tiny_config(**kwargs), pconfig.tiny_config(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want, got = jconfig.shrink_model(want, 8, 64), pconfig.shrink_model(got, 8, 64)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_keys_and_bad_sizes_raise():
    with pytest.raises(KeyError):
        pconfig._update_dataclass(pconfig.Config(), {"train_params": {"nope": 1}})
    cfg = pconfig.Config()
    cfg.train_params.input_size = [100, 256]
    with pytest.raises(ValueError):
        pconfig.check(cfg)
    cfg = pconfig.Config()
    cfg.train_params.dtype = "float16"
    with pytest.raises(ValueError):
        pconfig.check(cfg)
    cfg = pconfig.Config()
    cfg.model_params.motion_estimator.dense_motion_encoder.t_kernel = [4, 3]
    with pytest.raises(ValueError):
        pconfig.check(cfg)


@pytest.mark.parametrize("seed,num_objects,use_fw", [(0, None, False),
                                                     (3, 4, True),
                                                     (7, 1, False)])
def test_make_batch_equals_the_jax_package(seed, num_objects, use_fw):
    jcfg = jconfig.shrink_model(jconfig.tiny_config(batch_size=2))
    jcfg.train_params.use_fw_of = use_fw
    want = jsynthetic.make_batch(jcfg, seed=seed, num_objects=num_objects)
    got = psynthetic.make_batch(port_cfg(jcfg), seed=seed,
                                num_objects=num_objects, device="cpu")
    assert set(got) == set(want)
    assert ("target_fw_of" in got) == use_fw
    w = jcfg.train_params.input_size[1]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.endswith("_of"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5 * w, rtol=0,
                                       err_msg=k)
        elif k.endswith("_occ"):
            assert np.mean(got[k] != want[k]) <= 1e-4, k
        else:                       # the numpy scene code: the same stream
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
