"""Reference C2M checkpoints into the port (``c2m_tpu_torch/tools/
convert_c2m.py``), on the CPU, for the plain, KITTI and SPADE generator
families at ``tiny_config`` with ``shrink_model``.

No reference checkpoint is in the repository, so a port ``C2MTrainModel``
with every tensor drawn from a seed (running statistics and spectral ``u``
too; GATv2's ``lin_r`` bias zero, as the reference has none) is written in
the reference's keys and layouts by ``tests/torch_reference_layout.py``,
dead keys included. Then, bit for bit:

- the JAX tool's ``convert_state_dict`` of that state_dict is
  ``to_jax_variables`` of the port's, leaf for leaf;
- the port's copy of ``convert_state_dict`` gives the same tree, and
  ``from_jax_variables`` of it gives back the port's state_dict;
- the CLI writes a job dir from a ``.pth.tar`` saved without the
  discriminators (as an ``is_inference=True`` model is), which
  ``load_checkpoint`` restores (the discriminators at their seed-0 init)
  and ``eval_torch.py --device cpu`` evaluates.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from c2m_tpu_torch.train.model import C2MTrainModel
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.tools import convert_c2m as pconv
from c2m_tpu_torch.utils.checkpoint import latest_step, load_checkpoint
from c2m_tpu_torch.utils.convert import (flatten, from_jax_variables,
                                         to_jax_variables)
from tests.test_torch_trainer import trainer_cfg
from tests.torch_port_fixtures import port_cfg, tiny_cfg
from tests.torch_port_variants import variant_cfg
from tests.torch_reference_layout import reference_state_dict, save_reference
from tools import convert_c2m as jconv

FAMILIES = ("plain", "kitti", "spade")


def seeded_state(pcfg, seed: int):
    """Every floating tensor of a ``C2MTrainModel`` from ``seed``; GATv2's
    ``lin_r`` biases zero."""
    with torch.device("meta"):
        keys = C2MTrainModel(pcfg).state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in keys.items():
        value = rng.uniform(0.5, 1.5, tuple(v.shape)) if k.endswith(
            "running_var") else rng.randn(*v.shape) * 0.1
        if ".lin_r." in k and k.endswith(".bias"):
            value = np.zeros(tuple(v.shape))
        sd[k] = torch.from_numpy(value.astype(np.float32))
    return sd


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg = tiny_cfg() if request.param == "plain" else variant_cfg(
        request.param)
    pcfg = port_cfg(cfg)
    sd = seeded_state(pcfg, seed=FAMILIES.index(request.param))
    ref = {k: v.numpy() for k, v in reference_state_dict(sd, pcfg).items()}
    return cfg, pcfg, sd, ref


def test_reference_layout_has_the_dead_keys(family):
    _, _, _, ref = family
    for part in (".y_encoder.", ".decoder.linear_z.", ".flow_predictors.",
                 ".occlusion_predictors.", "roi_align_blocks.0.norm.",
                 ".num_batches_tracked", ".conv.weight_v", "vgg19.mean"):
        assert any(part in k for k in ref), part
    att = [v for k, v in ref.items() if k.endswith("conv_time_steps.0.att")]
    assert att and att[0].ndim == 3 and att[0].shape[0] == 1
    assert not any(".lin_r.bias" in k for k in ref)


def test_jax_converter_gives_the_bridge_tree(family):
    """tools/convert_c2m.convert_state_dict(reference layout) ==
    to_jax_variables(port state_dict), leaf for leaf."""
    cfg, pcfg, sd, ref = family
    got = flatten(jconv.convert_state_dict(ref, cfg))
    want = flatten(to_jax_variables(sd, pcfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_converter_gives_back_the_state_dict(family):
    """The port's copy agrees with the JAX tool's, and the bridge carries
    its tree back onto every tensor of the port's state_dict."""
    cfg, pcfg, sd, ref = family
    tree = pconv.convert_state_dict(ref, pcfg)
    got, want = flatten(tree), flatten(jconv.convert_state_dict(ref, cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = from_jax_variables(tree, pcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_unknown_reference_key_raises():
    pcfg = port_cfg(tiny_cfg())
    ref = {k: v.numpy() for k, v in
           reference_state_dict(seeded_state(pcfg, 3), pcfg).items()}
    ref["generator.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        pconv.convert_state_dict(ref, pcfg)


def test_merge_keeps_what_the_source_lacks_and_refuses_extra_entries():
    init = {"params": {"g": {"w": 1, "b": 2}, "vgg": {"w": 3}}}
    assert pconv.merge(init, {"params": {"g": {"w": 5}}}) == {
        "params": {"g": {"w": 5, "b": 2}, "vgg": {"w": 3}}}
    for extra in ({"params": {"g": {"x": 5}}}, {"params": {"h": {"w": 5}}}):
        with pytest.raises(KeyError, match="no place"):
            pconv.merge(init, extra)


def test_cli_writes_a_job_dir_the_entry_points_read(tmp_path):
    import eval_torch
    pcfg = trainer_cfg()
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(pcfg.to_dict()))
    sd = seeded_state(pcfg, seed=5)
    ckpt = str(tmp_path / "latest_c2m_model.pth.tar")
    save_reference(ckpt, sd, pcfg)
    blob = torch.load(ckpt)                 # drop what inference lacks
    blob["c2m"] = {k: v for k, v in blob["c2m"].items()
                   if not k.startswith("netD_")}
    torch.save(blob, ckpt)
    job = str(tmp_path / "job")
    assert pconv.main(["--checkpoint", ckpt, "--config", str(cfg_path),
                       "--out", job, "--device", "cpu"]) == 0
    assert latest_step(job) == 0
    assert open(os.path.join(job, "iter.txt")).read() == "0,0"

    state = create_train_state(pcfg, seed=1, device="cpu")
    assert load_checkpoint(job, state) == (0, 0)
    got = state.model.state_dict()
    init = create_train_state(pcfg, seed=0, device="cpu").model.state_dict()
    for k, v in sd.items():
        want = init[k] if k.startswith("netd_") else v
        assert torch.equal(got[k], want), k
    assert eval_torch.main(["--config", str(cfg_path), "--device", "cpu",
                            "--job-dir", job, "--max-batches", "1"]) == 0
    assert os.path.exists(os.path.join(job, "eval", "results.txt"))
