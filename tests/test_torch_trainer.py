"""The port's trainer, checkpoints, export and entry points on the CPU, at
64x128 with shrunk widths in float32.

- A run broken by a save and resumed by a fresh ``Trainer`` with
  ``continue_train`` equals an unbroken run bit for bit: parameters,
  buffers, Adam moments, per-group lr, the CPU generator's state,
  ``total_iter``, ``iter.txt`` and the batches taken. Two breaks: at an
  epoch's end and inside an epoch. The scheduler crosses a milestone.
- The lr per group per step equals ``c2m_tpu.train.state.
  multistep_schedule`` over three epochs with milestones.
- The mid-train sampled eval draws fresh z and clicks per call and writes
  under the ``eval`` tag (the twin of ``tests/test_trainer_eval.py``).
- ``use_pre_processed_of: false`` wires ``OnTheFlyFlow`` (a stub stands in
  for FlowNet2; ``tests/test_torch_flownet2.py`` and the card cover the
  net).
- ``export_artifact`` writes the JAX layout (``c2m_tpu.serving.
  _load_variables`` reads it with the structure, shapes and dtypes of the
  JAX ``generator_variables`` tree) and ``ServingModel.from_artifact``
  serves the source model's output bit for bit.
- ``train_torch.main`` then ``eval_torch.main`` on the CPU.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from c2m_tpu.serving import _load_variables
from c2m_tpu.serving import generator_variables as jax_generator_variables
from c2m_tpu.train.model import C2MTrainModel as JaxTrainModel
from c2m_tpu.train.state import multistep_schedule
from c2m_tpu_torch import config as pconfig
from c2m_tpu_torch.data.dataset import SyntheticDataset
from c2m_tpu_torch.serving import ServingModel, export_artifact, z_dim
from c2m_tpu_torch.train.state import GROUPS, create_train_state
from c2m_tpu_torch.train.trainer import Trainer
from c2m_tpu_torch.utils.checkpoint import (latest_step, load_payload,
                                            saved_steps)
from tests.torch_port_fixtures import make_batch, port_cfg, tiny_cfg, to_jax


def trainer_cfg():
    """Batch 1, one milestone at epoch 1 (two clips: step 2), every cadence
    firing within four steps, no VGG (its weights are frozen anyway),
    widths shrunk to 8 / 32."""
    cfg = pconfig.shrink_model(pconfig.tiny_config(h=64, w=128,
                                                   num_predicted=5,
                                                   max_objects=4,
                                                   batch_size=1), 8, 32)
    tp, vz = cfg.train_params, cfg.visualizer_params
    tp.dtype = "float32"
    tp.loss_weights.perceptual = 0.0
    tp.workers = 0
    tp.milestone_start, tp.milestone_end, tp.milestone_every = 1, 2, 1
    tp.eval_freq = 3
    cfg.test_params.batch_size = 2
    vz.print_freq, vz.display_freq, vz.save_latest_freq = 1, 4, 1
    vz.tf_log = False
    cfg.checkpoint_params.save_epoch_freq = 1
    return cfg


class Held:
    """The clips of a dataset made once and held in memory. The loader's
    threads then only stack arrays: torch CPU ops in those threads (the
    synthetic clips are rasterized with torch) would share the intra-op
    thread pool with the train step, whose float sums then depend on
    timing, and two runs would differ in the last bits."""

    def __init__(self, dataset):
        self.items = [dataset[i] for i in range(len(dataset))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


_HELD = {}


def datasets(cfg):
    if not _HELD:
        _HELD["sets"] = (Held(SyntheticDataset(cfg, n=2, device="cpu")),
                         Held(SyntheticDataset(cfg, n=2, seed_offset=100,
                                               device="cpu")))
    return _HELD["sets"]


def snapshot(trainer):
    st = trainer.state
    opt = st.optimizer.state_dict()
    return {
        "model": {k: v.clone() for k, v in st.model.state_dict().items()},
        "moments": {(i, k): v.clone() for i, s in opt["state"].items()
                    for k, v in s.items()},
        "lr": [g["lr"] for g in st.optimizer.param_groups],
        "scheduler": st.scheduler.state_dict()["last_epoch"],
        "generator": st.generator.get_state().clone(),
        "total_iter": trainer.total_iter,
        "step": st.step,
        "iter_txt": open(os.path.join(trainer.job_dir, "iter.txt")).read(),
        "history": [(h["step"], h["epoch"], h["indices"], h["lr"],
                     {k: float(v) for k, v in h["metrics"].items()})
                    for h in trainer.history],
    }


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    cfg = trainer_cfg()
    trainer = Trainer(cfg, *datasets(cfg),
                      job_dir=str(tmp_path_factory.mktemp("unbroken")),
                      device="cpu")
    trainer.fit(num_epochs=2)
    return snapshot(trainer)


def assert_same_state(got, want):
    assert got["model"].keys() == want["model"].keys()
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    assert got["moments"].keys() == want["moments"].keys()
    for k in want["moments"]:
        assert torch.equal(got["moments"][k], want["moments"][k]), k
    for key in ("lr", "scheduler", "total_iter", "step", "iter_txt"):
        assert got[key] == want[key], key
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("first", [dict(num_epochs=1),
                                   dict(num_epochs=1, max_steps=1)],
                         ids=["at-epoch-end", "inside-an-epoch"])
def test_resumed_run_equals_unbroken_run(unbroken, tmp_path, first):
    cfg = trainer_cfg()
    ds = datasets(cfg)
    a = Trainer(cfg, *ds, job_dir=str(tmp_path), device="cpu")
    a.fit(**first)
    taken = a.total_iter
    saved = load_payload(str(tmp_path))
    assert saved["step"] == taken == latest_step(str(tmp_path))
    assert open(tmp_path / "iter.txt").read() == f"1,{taken}"
    del a

    cfg2 = copy.deepcopy(cfg)
    cfg2.train_params.continue_train = True
    b = Trainer(cfg2, *ds, job_dir=str(tmp_path), device="cpu")
    assert b.total_iter == taken
    # the checkpoint round trip: what was saved is what the state holds
    got = b.state.model.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(got[k], v), k
    assert torch.equal(b.state.generator.get_state(), saved["generator"])
    b.fit(num_epochs=2)
    got = snapshot(b)
    assert_same_state(got, unbroken)
    # the resumed steps took the unbroken run's batches, lr and metrics
    assert got["history"] == unbroken["history"][taken:]
    # one save per global step, the newest three kept
    assert saved_steps(str(tmp_path)) == [2, 3, 4]


def test_restoring_a_payload_twice_repeats_the_step(tmp_path):
    """``restore_state`` leaves the payload as it was: on the CPU the
    optimizer's state would otherwise alias the payload's tensors and the
    step would update them, so a second restore would start elsewhere."""
    from c2m_tpu_torch.train.step import make_train_step
    from c2m_tpu_torch.utils.checkpoint import restore_state, state_payload
    cfg = trainer_cfg()
    state = create_train_state(cfg, device="cpu")
    held = datasets(cfg)[0]
    batch = {k: torch.as_tensor(v[None]) for k, v in held[0].items()}
    step = make_train_step(cfg)
    step(state, batch)
    payload = state_payload(state, 1, 1)
    after = []
    for _ in range(2):
        restore_state(state, payload)
        step(state, batch)
        after.append({k: v.clone() for k, v in
                      state.optimizer.state_dict()["state"][0].items()})
    for k in after[0]:
        assert torch.equal(after[0][k], after[1][k]), k
    assert state.step == 2


def test_lr_per_group_follows_the_jax_schedule(unbroken):
    """Per step over three epochs of two steps, milestones at epochs 1 and
    2: every group's lr is ``multistep_schedule``'s at that step."""
    cfg = trainer_cfg()
    tp = cfg.train_params
    tp.milestone_start, tp.milestone_end, tp.milestone_every = 1, 3, 1
    state = create_train_state(cfg, device="cpu", steps_per_epoch=2)
    base = {"gen": (tp.lr_rate_g, tp.gamma_g),
            "gnn": (tp.lr_rate_gnn, tp.gamma_gnn),
            "d_image": (tp.lr_rate_d, tp.gamma_d),
            "d_video": (tp.lr_rate_d, tp.gamma_d)}
    for step in range(6):
        for g in state.optimizer.param_groups:
            lr, gamma = base[g["name"]]
            want = float(multistep_schedule(lr, gamma, tp.milestones, 2)(step))
            assert g["lr"] == pytest.approx(want, rel=1e-6), (step, g["name"])
        state.optimizer.step()
        state.scheduler.step()
    # the trainer's own steps (milestone at epoch 1 only)
    for step, (_, _, _, lrs, _) in enumerate(unbroken["history"]):
        for name, lr in zip(GROUPS, lrs):
            want = float(multistep_schedule(base[name][0], base[name][1], [1],
                                            2)(step))
            assert lr == pytest.approx(want, rel=1e-6), (step, name)


def eval_outputs(batch, click, tpred=5, h=64, w=128):
    b = batch["video"].shape[0]

    def zeros(*shape):
        return torch.zeros(shape)
    return {
        "generated": zeros(b, tpred, h, w, 3),
        "generated_sparse": zeros(b, tpred, h, w, 3),
        "generated_sparse_occ": zeros(b, tpred, h, w, 3),
        "dense_motion_bw": zeros(b, tpred, h, w, 2),
        "occlusion_bw": zeros(b, tpred, h, w, 1),
        "sparse_motion_bw": zeros(b, tpred, h, w, 2),
        "sparse_occ_bw": zeros(b, tpred, h, w, 1),
        "sparse_motion_bin": zeros(b, tpred, h, w, 1),
        "thetas": batch["targets_theta"],
        "click_mask": click,
    }


def test_generate_eval_samples_fresh_latents(tmp_path):
    """With the inference stubbed: ``_generate_eval`` passes fresh z and
    clicks per call (the same again for the same ``total_iter``), takes
    the val batches in turn, and visualizes under 'eval'."""
    cfg = trainer_cfg()
    train_set, val_set = datasets(cfg)
    trainer = Trainer(cfg, train_set, val_set, job_dir=str(tmp_path),
                      device="cpu")
    calls = []

    def fake_infer(batch, z, click):
        calls.append({"z": z.clone(), "click": click.clone(),
                      "video": batch["video"].clone()})
        return eval_outputs(batch, click)

    trainer._infer = fake_infer
    for it in (1, 2, 1):
        trainer.total_iter = it
        assert trainer._generate_eval(epoch=1) is not None
    z = [c["z"] for c in calls]
    assert not torch.allclose(z[0], z[1])
    assert torch.equal(z[0], z[2])
    assert float(z[0].std()) > 0.1
    assert z[0].shape == (2, z_dim(cfg))
    for c in calls:
        assert torch.equal(c["click"].sum(-1), torch.ones(2))
    # val batches (seed offset 100), not the training clips
    assert not torch.allclose(calls[0]["video"][0],
                              torch.as_tensor(train_set[0]["video"]))
    np.testing.assert_array_equal(calls[0]["video"][0].numpy(),
                                  val_set[0]["video"])
    assert "[eval]" in open(trainer.visualizer.traj_path).read()
    web = os.path.join(trainer.job_dir, "web", "images")
    assert any(f.startswith("eval_") for f in os.listdir(web))
    # the training generator was not touched
    fresh = create_train_state(cfg, device="cpu")
    assert torch.equal(trainer.state.generator.get_state(),
                       fresh.generator.get_state())


class StubFlow:
    """Stands in for ``OnTheFlyFlow``: records how it was built and called,
    and returns zero flows and unit occlusions of the batch's shapes."""
    built = []

    def __init__(self, t_in, t_out, weights_path=None, device=None):
        self.calls = []
        StubFlow.built.append((t_in, t_out, weights_path, device))

    def __call__(self, video):
        self.calls.append(tuple(video.shape))
        b, t, h, w, _ = video.shape
        return {"target_bw_of": torch.zeros(b, t - 1, h, w, 2),
                "target_bw_occ": torch.ones(b, t - 1, h, w, 1)}


def test_onthefly_flow_is_wired_when_flows_are_not_precomputed(
        tmp_path, monkeypatch):
    from c2m_tpu_torch.train import flow_onthefly
    monkeypatch.setattr(flow_onthefly, "OnTheFlyFlow", StubFlow)
    monkeypatch.setenv("FLOWNET2_WEIGHTS", "/weights/flownet2.npz")
    StubFlow.built.clear()
    cfg = trainer_cfg()
    trainer = Trainer(cfg, *datasets(cfg), job_dir=str(tmp_path / "pre"),
                      device="cpu")
    assert trainer.flow_onthefly is None and not StubFlow.built
    cfg.train_params.use_pre_processed_of = False
    cfg.visualizer_params.display_freq = cfg.train_params.eval_freq = 100
    trainer = Trainer(cfg, *datasets(cfg), job_dir=str(tmp_path / "otf"),
                      device="cpu")
    assert isinstance(trainer.flow_onthefly, StubFlow)
    assert StubFlow.built == [(1, 5, "/weights/flownet2.npz",
                               torch.device("cpu"))]
    trainer.fit(num_epochs=1, max_steps=1)
    assert trainer.flow_onthefly.calls == [(1, 6, 64, 128, 3)]
    # the step trained on the stub's flows
    assert np.isfinite(float(trainer.history[-1]["metrics"]["total_gen"]))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = tiny_cfg()
    cfg.train_params.loss_weights.perceptual = 0.0
    pcfg = port_cfg(cfg)
    state = create_train_state(pcfg, seed=3, device="cpu")
    out_dir = str(tmp_path_factory.mktemp("artifact"))
    export_artifact(out_dir, pcfg, state.model, batch_sizes=(2,))
    return cfg, pcfg, state, out_dir


def test_export_has_the_jax_generator_tree(exported):
    cfg, _, _, out_dir = exported
    got = _load_variables(os.path.join(out_dir, "variables.npz"))
    batch = make_batch(cfg, seed=0)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: JaxTrainModel(cfg).init(
        {"params": key, "sample": key}, to_jax(batch), train=True))
    want = jax_generator_variables(shapes)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    meta = json.load(open(os.path.join(out_dir, "meta.json")))
    assert meta["format_version"] == 1 and meta["platforms"] == []
    assert meta["batch_sizes"] == [2]
    assert yaml.safe_load(open(os.path.join(out_dir, "config.yaml"))) == \
        cfg.to_dict()


def test_served_artifact_equals_the_source_model(exported):
    cfg, pcfg, state, out_dir = exported
    batch = make_batch(cfg, seed=5)
    g = torch.Generator().manual_seed(0)
    z = torch.randn(2, z_dim(pcfg), generator=g)
    click = torch.zeros(2, cfg.dataset_params.max_objects)
    click[:, 1] = 1
    model = state.model.eval()
    want = model.inference({k: torch.as_tensor(v) for k, v in batch.items()},
                           z, click, use_gt_eval=False)
    server = ServingModel.from_artifact(out_dir, device="cpu",
                                        use_gt_eval=False)
    got = server(batch, z.numpy(), click.numpy())
    for k in ("generated", "dense_motion_bw", "occlusion_bw", "thetas"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)


def test_train_then_eval_entry_points(tmp_path):
    import eval_torch
    import train_torch
    cfg = trainer_cfg()
    cfg.visualizer_params.print_freq = 1
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    job = str(tmp_path / "job")
    assert train_torch.main(["--config", str(path), "--device", "cpu",
                             "--max-steps", "2", "--num-epochs", "1",
                             "--job-dir", job, "--device_ids", "0"]) == 0
    assert open(os.path.join(job, "iter.txt")).read() == "1,2"
    assert latest_step(job) == 2
    assert os.path.exists(os.path.join(job, "params", "config.txt"))
    assert eval_torch.main(["--config", str(path), "--device", "cpu",
                            "--job-dir", job, "--max-batches", "1"]) == 0
    text = open(os.path.join(job, "eval", "results.txt")).read()
    assert "trajectory_mse_theta" in text and "fid: nan" in text
