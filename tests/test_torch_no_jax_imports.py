"""The port stands alone: no module of ``c2m_tpu_torch/`` and not
``chip_smoke.py``, ``kernel_ab.py``, ``train_torch.py``, ``eval_torch.py``
or ``yolo_detect_torch.py`` imports the JAX package ``c2m_tpu``, ``jax``, ``flax`` or
``optax``, at top level or inside any function. Every source is parsed with
``ast`` (docstrings that name the counterpart file are not imports and
stay). Each entry point defaults to the card and says so where there is
none.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"c2m_tpu", "jax", "jaxlib", "flax", "optax"}


def _sources():
    paths = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "kernel_ab.py", "train_torch.py",
              "eval_torch.py", "yolo_detect_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "c2m_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(name, line) for name, line in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, (os.path.relpath(path, REPO), bad)


def test_the_walk_sees_the_port_and_catches_an_import(tmp_path):
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"chip_smoke.py", "train_torch.py", "eval_torch.py",
            "c2m_tpu_torch/config.py",
            "c2m_tpu_torch/train/trainer.py",
            "c2m_tpu_torch/eval/evaluator.py",
            "c2m_tpu_torch/utils/checkpoint.py",
            "c2m_tpu_torch/data/loader.py",
            "c2m_tpu_torch/train/step.py",
            "c2m_tpu_torch/data/synthetic.py",
            "c2m_tpu_torch/models/flownet2.py",
            "c2m_tpu_torch/train/flow_onthefly.py",
            "c2m_tpu_torch/ops/correlation.py",
            "c2m_tpu_torch/ops/hopper/correlation_kernel.py",
            "c2m_tpu_torch/ops/hopper/maskwarp_banded.py",
            "yolo_detect_torch.py",
            "c2m_tpu_torch/eval/inception.py",
            "c2m_tpu_torch/eval/i3d.py",
            "c2m_tpu_torch/eval/yolov3.py",
            "c2m_tpu_torch/eval/detection_metric.py",
            "c2m_tpu_torch/utils/convert.py",
            "c2m_tpu_torch/models/panoptic_deeplab.py",
            "c2m_tpu_torch/models/siamrpn.py",
            "c2m_tpu_torch/native/__init__.py",
            "c2m_tpu_torch/eval/tracker_benchmark.py",
            "c2m_tpu_torch/eval/cityscapes_eval.py",
            "c2m_tpu_torch/tools/__init__.py",
            "c2m_tpu_torch/tools/generate_segmentation.py",
            "c2m_tpu_torch/tools/generate_trajectories.py",
            "c2m_tpu_torch/tools/precompute_flow.py",
            "c2m_tpu_torch/tools/evaluate_cityscapes.py",
            "c2m_tpu_torch/tools/convert_c2m.py",
            "c2m_tpu_torch/tools/export_serving.py",
            "c2m_tpu_torch/tools/make_synthetic_dataset.py",
            "c2m_tpu_torch/tools/prepare_gt_labels.py",
            "c2m_tpu_torch/tools/kitti2cityscapes_semantic.py",
            "c2m_tpu_torch/ops/upfirdn.py"} <= names
    probe = tmp_path / "probe.py"
    probe.write_text('"""from c2m_tpu import x (a docstring)"""\n'
                     "def f():\n    from c2m_tpu.config import Config\n"
                     "    import jax.numpy as jnp\n")
    found = {name.split(".")[0] for name, _ in _imports(str(probe))}
    assert found == {"c2m_tpu", "jax"}


_IMPORT_ALL = """
import importlib, os, pkgutil, sys
import c2m_tpu_torch
for m in pkgutil.walk_packages(c2m_tpu_torch.__path__, "c2m_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke, eval_torch, train_torch, yolo_detect_torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("c2m_tpu", "jax", "jaxlib", "flax", "optax"))
assert not bad, bad
print("ok")
"""


def test_importing_every_module_loads_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _entry_points():
    import eval_torch
    import train_torch
    import yolo_detect_torch
    from c2m_tpu_torch.eval.detection_metric import make_yolo_detector
    from c2m_tpu_torch.config import shrink_model, tiny_config
    from c2m_tpu_torch.data.dataset import SyntheticDataset
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import ServingModel
    from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.train.trainer import Trainer
    from c2m_tpu_torch.tools import (convert_c2m, export_serving,
                                     generate_segmentation,
                                     generate_trajectories,
                                     make_synthetic_dataset, precompute_flow)
    cfg = shrink_model(tiny_config())
    return {
        "make_batch": lambda: make_batch(cfg, seed=0),
        "ServingModel.from_variables":
            lambda: ServingModel.from_variables(cfg, {}),
        "ServingModel.from_artifact":
            lambda: ServingModel.from_artifact("/nonexistent"),
        "create_train_state": lambda: create_train_state(cfg),
        "OnTheFlyFlow": lambda: OnTheFlyFlow(1, 5),
        "SyntheticDataset": lambda: SyntheticDataset(cfg),
        "Trainer": lambda: Trainer(cfg, [], job_dir="/nonexistent"),
        "train_torch.main": lambda: train_torch.main(
            ["--config", "/nonexistent.yaml"]),
        "eval_torch.main": lambda: eval_torch.main(
            ["--config", "/nonexistent.yaml"]),
        "yolo_detect_torch.main": lambda: yolo_detect_torch.main(
            ["--image-folder", "/nonexistent", "--weights",
             "/nonexistent.npz"]),
        "make_yolo_detector": lambda: make_yolo_detector("/nonexistent.npz"),
        "generate_segmentation.main": lambda: generate_segmentation.main(
            ["--images-root", "/nonexistent", "--out-semantic", "/nonexistent",
             "--out-instance", "/nonexistent"]),
        "generate_trajectories.main": lambda: generate_trajectories.main(
            ["--images-root", "/nonexistent", "--instance-root",
             "/nonexistent", "--out", "/nonexistent"]),
        "precompute_flow.main": lambda: precompute_flow.main(
            ["--config", "/nonexistent.yaml"]),
        "convert_c2m.main": lambda: convert_c2m.main(
            ["--checkpoint", "/nonexistent.pth.tar", "--config",
             "/nonexistent.yaml", "--out", "/nonexistent"]),
        "export_serving.main": lambda: export_serving.main(
            ["--config", "/nonexistent.yaml", "--job-dir", "/nonexistent",
             "--out", "/nonexistent"]),
        "make_synthetic_dataset.main": lambda: make_synthetic_dataset.main(
            ["--root", "/nonexistent"]),
    }


@pytest.mark.parametrize("name", ["make_batch", "ServingModel.from_variables",
                                  "ServingModel.from_artifact",
                                  "create_train_state", "OnTheFlyFlow",
                                  "SyntheticDataset", "Trainer",
                                  "train_torch.main", "eval_torch.main",
                                  "yolo_detect_torch.main",
                                  "make_yolo_detector",
                                  "generate_segmentation.main",
                                  "generate_trajectories.main",
                                  "precompute_flow.main", "convert_c2m.main",
                                  "export_serving.main",
                                  "make_synthetic_dataset.main"])
def test_entry_point_defaults_to_the_card(name):
    """With no ``device`` an entry point asks for the card. This host has
    none, so it must raise an error that names CUDA, before anything else
    (a missing artifact, empty variables), and not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default would succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_resolve_device():
    from c2m_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
