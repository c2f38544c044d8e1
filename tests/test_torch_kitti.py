"""The KITTI configuration builds the KITTI model in the port.

``configs/c2m_kitti.yaml`` sets ``dataset: "kitti"``, for which the JAX
generator adds its warped-image branch (``first_warped``,
``down_warped_i``, ``pre_decode``; ``c2m_tpu/models/generator.py``). The
port's generator keys the same branch on the same name, so every entry
point that builds through it (``C2MGenerator``, ``C2MTrainModel``,
``create_train_state``, ``ServingModel``) builds that model, and its
parameters carry one to one onto the JAX package's tree of the same
config. The numbers are held in ``tests/test_torch_generator_variants.py``
and ``tests/test_torch_variants_slice.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from c2m_tpu.config import Config as JaxConfig
from c2m_tpu.data.synthetic import make_batch as jax_make_batch
from c2m_tpu.models.c2m import C2MGenerator as JaxC2M
from c2m_tpu_torch.config import load_config
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.utils.convert import _walk

KITTI_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "c2m_kitti.yaml")


def _branch_names(module):
    nd = load_config(KITTI_YAML).model_params.generator.num_down_blocks
    names = {n for n, _ in module.named_children()}
    want = {"first_warped", "pre_decode"} | {f"down_warped_{i}"
                                              for i in range(nd)}
    assert want <= names, sorted(want - names)
    return want


@pytest.fixture(scope="module")
def kitti_generator():
    cfg = load_config(KITTI_YAML)
    assert "kitti" in cfg.dataset_params.dataset
    return cfg, C2MGenerator(cfg)


def test_generator_builds_the_warped_image_branch(kitti_generator):
    cfg, model = kitti_generator
    _branch_names(model.generator)
    # the branch re-encodes the 3-channel warped image at full width
    assert model.generator.first_warped.conv.weight.shape[1] == 3
    assert model.generator.kitti


def test_create_train_state_builds_the_warped_image_branch():
    cfg = load_config(KITTI_YAML)
    state = create_train_state(cfg, device="cpu")
    _branch_names(state.model.c2m.generator)
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    branch = [p for n, p in state.model.named_parameters()
              if n.startswith("c2m.generator.pre_decode.")]
    assert branch and all(id(p) in trained for p in branch)


def test_state_dict_maps_one_to_one_onto_the_jax_tree(kitti_generator):
    """Every tensor of the port's KITTI generator has exactly one leaf of
    the JAX package's init tree of the same YAML, with the same number of
    elements, and no JAX leaf is left over."""
    cfg, model = kitti_generator
    jcfg = JaxConfig.from_yaml(KITTI_YAML)
    batch = {k: jnp.asarray(v) for k, v in jax_make_batch(
        jcfg, batch_size=1, seed=0).items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: JaxC2M(jcfg).init(
        {"params": key, "sample": key}, batch, train=False))
    leaves = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(shapes)[0]}
    sd = model.state_dict()
    pairs = [(key, path) for key, path, _, _ in _walk(model)]
    assert sorted(k for k, _ in pairs) == sorted(sd)
    paths = [p for _, p in pairs]
    assert len(set(paths)) == len(paths)
    assert set(paths) == set(leaves), sorted(set(paths) ^ set(leaves))[:8]
    for key, path in pairs:
        assert sd[key].numel() == int(np.prod(leaves[path].shape)), key
    assert any("/pre_decode/" in p for p in paths)
