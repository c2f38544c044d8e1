"""The export CLI (``c2m_tpu_torch/tools/export_serving.py``) on the CPU: the
artifact it writes from a job dir holds the ``variables.npz`` that
``serving.export_artifact`` writes from the same model, key for key and bit
for bit, and ``ServingModel.from_artifact`` of it answers a request as the
model does; ``--random-init`` exports the seeded init, and a job dir
without a checkpoint is refused."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.serving import ServingModel, export_artifact, z_dim
from c2m_tpu_torch.tools import export_serving
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_trainer import trainer_cfg


def _npz(path):
    with np.load(os.path.join(path, "variables.npz")) as data:
        return {k: data[k] for k in data.files}


def _same_npz(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    cfg = trainer_cfg()
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    state = create_train_state(cfg, seed=11, device="cpu")
    save_checkpoint(str(root / "job"), state, epoch=2, epoch_iter=1)
    return cfg, str(path), state, root


def test_cli_artifact_equals_export_artifact(job):
    cfg, path, state, root = job
    out = str(root / "cli")
    assert export_serving.main(["--config", path, "--job-dir",
                                str(root / "job"), "--out", out,
                                "--batch-sizes", "1,2", "--device",
                                "cpu"]) == 0
    want = str(root / "direct")
    export_artifact(want, cfg, state.model, batch_sizes=(1, 2))
    _same_npz(_npz(out), _npz(want))
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["batch_sizes"] == [1, 2] and meta["platforms"] == []

    batch = make_batch(cfg, batch_size=2, seed=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    z = torch.randn(2, z_dim(cfg), generator=g)
    click = torch.zeros(2, cfg.dataset_params.max_objects)
    click[:, 0] = 1
    server = ServingModel.from_artifact(out, device="cpu")
    got = server(batch, z.numpy(), click.numpy())
    model = state.model.c2m.eval()
    with torch.inference_mode():
        ref = model.inference({k: torch.as_tensor(v) for k, v in
                               batch.items()}, z, click,
                              cfg.test_params.use_gt_eval)
    assert got["generated"].shape == tuple(batch["video"][:, 1:].shape)
    assert np.isfinite(got["generated"]).all()
    np.testing.assert_array_equal(got["generated"], ref["generated"].numpy())


def test_random_init_and_missing_checkpoint(job):
    cfg, path, _, root = job
    out = str(root / "init")
    assert export_serving.main(["--config", path, "--out", out,
                                "--random-init", "--device", "cpu"]) == 0
    want = str(root / "init_direct")
    export_artifact(want, cfg, create_train_state(cfg, device="cpu").model)
    _same_npz(_npz(out), _npz(want))
    with pytest.raises(SystemExit):
        export_serving.main(["--config", path, "--job-dir",
                             str(root / "empty"), "--out", str(root / "x"),
                             "--device", "cpu"])
