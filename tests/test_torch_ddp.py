"""Data-parallel training (``c2m_tpu_torch/parallel/mesh.py``) on the CPU:
two gloo ranks, each on its half of a batch of 2, against one process on
the whole batch, at ``tiny_config`` with ``shrink_model``, float32.

The gates are those ``tests/test_parallel.py`` holds the JAX data mesh to
against one device: every metric within 1e-3 relative (plus 1e-5), the
gradient of all trained parameters within cos > 0.999 and norm 1e-2
(float32 sums over half batches in another order, amplified by train-mode
BatchNorm's backward); and the BatchNorm running statistics within 1e-4
abs + 1e-4 rel (the first norms of the encoders see raw instance ids and
hold variances of ~1e5). Measured on this model: every metric within 1e-5
relative, the gradient's cos 0.99997 and norm ratio 1.008, where one
process alone moves its gradient's norm by 0.5% when only the rounding of
its norms' sums changes (summed in float64): train-mode BatchNorm turns
float32 reduction order into gradient differences of that size.
The ranks' parameters after the step are bit-equal: they apply one
averaged gradient. A second step with each rank's norms on its own rows
(the port before global-batch BatchNorm) shows that gate is not a
formality: it fails it. The loader's shards are disjoint and cover the
epoch, and under a ``Trainer`` rank 0 alone writes the job dir.

The ranks are spawned processes with one thread each, meeting through a
``file://`` rendezvous in the test's directory, with a timeout on every
collective.
"""

import multiprocessing
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch

from c2m_tpu_torch.config import shrink_model, tiny_config
from c2m_tpu_torch.data.dataset import SyntheticDataset
from c2m_tpu_torch.data.loader import DataLoader
from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.parallel import mesh
from c2m_tpu_torch.train.state import create_train_state, grouped_parameters
from c2m_tpu_torch.train.step import make_train_step

WORLD = 2
TIMEOUT_S = 120


def ddp_cfg():
    cfg = shrink_model(tiny_config(h=64, w=128, num_predicted=5,
                                   max_objects=4, batch_size=1))
    cfg.train_params.dtype = "float32"
    return cfg


def global_batch(cfg):
    return {k: torch.as_tensor(v) for k, v in
            make_batch(cfg, batch_size=WORLD, seed=0, device="cpu").items()}


def one_step(cfg, batch):
    """One step from the seeded initial state: the metrics, the (averaged)
    gradient of every trained parameter, the running statistics and the
    parameters after the step."""
    state = create_train_state(cfg, seed=0, device="cpu")
    metrics = make_train_step(cfg)(state, batch)
    trained = [p for group in grouped_parameters(state.model).values()
               for p in group if p.grad is not None]
    sd = state.model.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grad": torch.cat([p.grad.reshape(-1) for p in trained]),
            "stats": {k: v.clone() for k, v in sd.items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()}}


def _worker(rank, root):
    torch.set_num_threads(1)
    mesh.init(rank, WORLD, torch.device("cpu"),
              init_method="file://" + os.path.join(root, "rendezvous"),
              timeout_s=TIMEOUT_S)
    try:
        cfg = ddp_cfg()
        rows = {k: v[rank:rank + 1] for k, v in global_batch(cfg).items()}
        out = {"global_bn": one_step(cfg, rows)}
        # the same step with each rank's norms on its own rows
        local = types.SimpleNamespace(is_live=lambda: False,
                                      global_sum=lambda t: t)
        from c2m_tpu_torch.models import sparse_motion
        from c2m_tpu_torch.nn import layers
        with mock.patch.object(layers, "mesh", local), \
                mock.patch.object(sparse_motion, "mesh", local):
            out["local_bn"] = one_step(cfg, rows)

        # a Trainer: one step with every cadence firing, each rank in its
        # own job dir, so that what rank 1 writes shows
        from c2m_tpu_torch.train.trainer import Trainer
        tcfg = ddp_cfg()
        vz = tcfg.visualizer_params
        vz.print_freq = vz.display_freq = vz.save_latest_freq = 1
        tcfg.train_params.eval_freq = 1
        tcfg.train_params.workers = 1
        vz.tf_log = False
        trainer = Trainer(tcfg, SyntheticDataset(tcfg, n=2 * WORLD + 1,
                                                 device="cpu"),
                          job_dir=os.path.join(root, f"job{rank}"),
                          device="cpu")
        out["shard"] = [int(i) for i in trainer.loader._indices()]
        trainer.fit(num_epochs=1, max_steps=1)
        out["trainer_metrics"] = {k: float(v) for k, v in
                                  trainer.history[-1]["metrics"].items()}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, root)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    cfg = ddp_cfg()
    return root, ranks, one_step(cfg, global_batch(cfg))


def _gate_failures(rank_runs, ref):
    """What of the JAX mesh's gates a data-parallel step misses."""
    fails = []
    for k, want in ref["metrics"].items():
        got = np.mean([r["metrics"][k] for r in rank_runs])
        if abs(got - want) > 1e-5 + 1e-3 * abs(want):
            fails.append(f"metric {k}: {got} vs {want}")
    g, w = rank_runs[0]["grad"].double(), ref["grad"].double()
    cos = float(g @ w / (g.norm() * w.norm()))
    ratio = float(g.norm() / w.norm())
    if not (cos > 0.999 and abs(ratio - 1) < 1e-2):
        fails.append(f"gradient: cos {cos}, norm ratio {ratio}")
    for k, want in ref["stats"].items():
        err = (rank_runs[0]["stats"][k] - want).abs() - 1e-4 * want.abs()
        if float(err.max()) > 1e-4:
            fails.append(f"{k}: {float(err.max())}")
    return fails


def test_two_ranks_equal_one_process_on_the_whole_batch(runs):
    _, ranks, ref = runs
    assert _gate_failures([r["global_bn"] for r in ranks], ref) == []
    # every rank reports the global metrics
    assert ranks[0]["global_bn"]["metrics"] == ranks[1]["global_bn"]["metrics"]


def test_parameters_bit_equal_across_ranks(runs):
    _, ranks, ref = runs
    a, b = ranks[0]["global_bn"]["params"], ranks[1]["global_bn"]["params"]
    assert a.keys() == b.keys() == ref["params"].keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for k, v in ranks[0]["global_bn"]["stats"].items():
        assert torch.equal(v, ranks[1]["global_bn"]["stats"][k]), k


def test_local_batch_norm_fails_the_gate(runs):
    _, ranks, ref = runs
    fails = _gate_failures([r["local_bn"] for r in ranks], ref)
    assert any("running_" in f for f in fails), fails
    assert any(f.startswith(("metric", "gradient")) for f in fails), fails


def test_loader_shards_are_disjoint_and_cover_the_epoch(runs):
    _, ranks, _ = runs
    shards = [r["shard"] for r in ranks]
    n = 2 * WORLD + 1                 # odd: the last shard wraps around
    assert set(shards[0]) | set(shards[1]) == set(range(n))
    assert len(shards[0]) == len(shards[1]) == -(-n // WORLD)
    # disjoint up to the one index DistributedSampler's padding repeats
    assert len(set(shards[0]) & set(shards[1])) == WORLD * len(shards[0]) - n
    for epoch in (1, 2):
        loaders = [DataLoader(list(range(8)), 2, shuffle=True, seed=3,
                              host_id=r, num_hosts=WORLD) for r in range(WORLD)]
        parts = []
        for loader in loaders:
            loader.set_epoch(epoch)
            parts.append(set(loader._indices().tolist()))
        assert not parts[0] & parts[1] and parts[0] | parts[1] == set(range(8))


def test_rank_zero_alone_writes_the_job_dir(runs):
    root, ranks, _ = runs
    written = [sorted(os.path.relpath(os.path.join(d, f), os.path.join(
        root, f"job{r}")) for d, _, files in os.walk(os.path.join(
            root, f"job{r}")) for f in files) for r in range(WORLD)]
    assert written[1] == []
    assert {"iter.txt", "checkpoints/latest", "checkpoints/1/state.pt",
            "params/config.txt", "loss_log.txt"} <= set(written[0])
    assert any(f.startswith("web/images/eval_") for f in written[0])
    assert any(f.startswith("web/images/train_") for f in written[0])
    assert ranks[0]["trainer_metrics"] == ranks[1]["trainer_metrics"]


def test_no_process_group_means_one_process():
    assert not mesh.is_live()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_rows(t) is t and mesh.local_rows(t) is t
    assert mesh.global_sum(t) is t


def test_one_rank_group_is_bit_equal_to_no_group(tmp_path):
    """A group of one rank runs every collective of the step (the gradient
    all-reduce, the norms' sums, the metrics' mean) and changes no bit of
    the forward: the step's metrics equal those of no group, as phase 14
    of ``chip_smoke.py`` holds NCCL to on the card."""
    cfg = ddp_cfg()
    batch = global_batch(cfg)
    alone = one_step(cfg, batch)
    mesh.init(0, 1, torch.device("cpu"),
              init_method="file://" + str(tmp_path / "rendezvous"),
              timeout_s=TIMEOUT_S)
    try:
        assert mesh.is_live() and mesh.world_size() == 1
        grouped = one_step(cfg, batch)
    finally:
        mesh.shutdown()
    assert not mesh.is_live()
    assert grouped["metrics"] == alone["metrics"]
    for k, v in alone["stats"].items():
        assert torch.equal(grouped["stats"][k], v), k
