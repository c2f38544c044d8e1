"""The port's serving slice end to end against the JAX package, on the CPU.

``C2MGenerator.inference`` with the same weights (carried by
from_jax_variables) and inputs, for GT thetas and for the click path.
Gates: ``generated`` <= 5e-4 abs (the converter-parity class measured in
STATUS round 3, ~2e-4); winner maps differ on <= 1e-4 of pixels (the
rasterizer's edge-flip class); the other streams 1e-3 abs with 1e-4
relative (deep conv stacks, flows of tens of pixels). Then the port's
ServingModel: bucket padding against an unpadded request, the outputs=
filter, artifact loading, and an import of the serving path with JAX
blocked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from c2m_tpu import serving as jserving
from c2m_tpu.models.c2m import C2MGenerator as JaxC2M
from c2m_tpu_torch.serving import ServingModel, z_dim
from tests.torch_port_fixtures import (LEVEL0, make_batch, port_cfg, port_model, random_jax_variables,
                                       tiny_cfg, to_jax, to_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    batch = make_batch(cfg, seed=0)
    variables = random_jax_variables(cfg, batch, seed=1)
    rng = np.random.RandomState(2)
    z = rng.randn(2, z_dim(cfg)).astype(np.float32)
    click = np.zeros((2, cfg.dataset_params.max_objects), np.float32)
    click[0, 1] = 1.0
    return cfg, batch, variables, z, click


@pytest.mark.parametrize("use_gt_eval", [True, False])
def test_inference_matches_jax(setup, use_gt_eval):
    cfg, batch, variables, z, click = setup
    jm = JaxC2M(cfg)
    want = jax.jit(lambda v, b, zz, c: jm.apply(
        v, b, zz, c, use_gt_eval, method="inference"),
        compiler_options=LEVEL0)(
        variables, to_jax(batch), jnp.asarray(z), jnp.asarray(click))
    with torch.inference_mode():
        got = port_model(cfg, variables).inference(
            to_torch(batch), torch.as_tensor(z), torch.as_tensor(click),
            use_gt_eval)
    assert set(got) == set(want)
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    got = {k: v.float().numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["generated"], want["generated"], atol=5e-4,
                               rtol=0)
    assert np.mean(got["winner_bw"] != want["winner_bw"]) <= 1e-4
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k not in ("generated", "winner_bw"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=1e-4,
                                       err_msg=k)
    if not use_gt_eval:          # the click path saw general affines
        assert np.abs(want["thetas"] - [1, 0, 0, 0, 1, 0]).max() > 1e-3


@pytest.fixture(scope="module")
def served(setup):
    cfg, _, variables, _, _ = setup
    return ServingModel.from_variables(port_cfg(cfg), variables,
                                       batch_sizes=(1, 3), device="cpu")


def test_serving_padding_matches_unpadded(setup, served):
    cfg, batch, _, z, click = setup
    assert served.bucket_for(1) == 1 and served.bucket_for(2) == 3
    with pytest.raises(ValueError):
        served.bucket_for(4)
    padded = served(batch, z, click)                   # 2 -> bucket 3
    assert padded["generated"].shape[0] == 2
    for i in range(2):
        one = served({k: v[i:i + 1] for k, v in batch.items()}, z[i:i + 1],
                     click[i:i + 1])                    # bucket 1, no padding
        # rows are independent in eval mode; the CPU conv kernels block
        # their float32 sums by batch size, hence 1e-4 and not equality
        for k in ("generated", "dense_motion_bw", "sparse_motion_bw"):
            np.testing.assert_allclose(padded[k][i], one[k][0], atol=1e-4,
                                       rtol=0, err_msg=k)


def test_serving_outputs_filter(setup, served):
    _, batch, _, z, click = setup
    one = {k: v[:1] for k, v in batch.items()}
    full = served(one, z[:1], click[:1])
    sel = served(one, z[:1], click[:1], outputs=("generated",))
    assert set(sel) == {"generated"}
    np.testing.assert_array_equal(sel["generated"], full["generated"])
    with pytest.raises(KeyError):
        served(one, z[:1], click[:1], outputs=("nope",))


def test_serving_from_artifact(setup, served, tmp_path):
    """An artifact directory's variables.npz + meta.json + config.yaml (the
    JAX exporter's layout; its .stablehlo files are not read)."""
    cfg, batch, variables, z, click = setup
    jserving._save_variables(str(tmp_path / "variables.npz"), variables)
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"format_version": 1, "batch_sizes": [2]}, f)
    loaded = ServingModel.from_artifact(str(tmp_path), device="cpu")
    assert loaded.batch_sizes == [2]
    np.testing.assert_array_equal(loaded(batch, z, click)["generated"],
                                  served(batch, z, click)["generated"])


_BLOCKED_JAX = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "c2m_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
import chip_smoke
from c2m_tpu_torch.config import Config, shrink_model
from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.serving import ServingModel, z_dim
cfg = shrink_model(Config())
cfg.train_params.input_size = cfg.test_params.input_size = [64, 128]
cfg.dataset_params.max_objects = 3
cfg.train_params.dtype = "float32"
served = ServingModel(C2MGenerator(cfg), (1,))
out = served(make_batch(cfg, batch_size=1, seed=0, device="cpu"),
             np.zeros((1, z_dim(cfg))), np.zeros((1, 3)))
assert np.isfinite(out["generated"]).all()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "flax", "optax", "c2m_tpu")]
print("ok")
"""


def test_serving_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_import_no_jax():
    import re
    pattern = re.compile(r"^\s*(import|from) (jax|flax)\b")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "c2m_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            bad = [line for line in f if pattern.match(line)]
        assert not bad, (path, bad)
