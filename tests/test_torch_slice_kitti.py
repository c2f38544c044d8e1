"""The KITTI model's slice against the JAX package's, on the CPU: inference
under the structural gate and one train step under the train-step gates
(the body and the gates are in ``tests/torch_port_variants.py``)."""

import pytest

from c2m_tpu_torch.train.state import GROUPS
from tests import torch_port_variants as variants


@pytest.fixture(scope="module")
def run():
    return variants.run("kitti")


def test_inference_matches_jax(run):
    variants.check_inference(run)


def test_step_metrics_match(run):
    variants.check_metrics(run)


@pytest.mark.parametrize("group", GROUPS)
def test_step_gradients_match_per_group(run, group):
    variants.check_gradients(run, group)


def test_branch_receives_gradient(run):
    variants.check_branch_gradients(run)


def test_state_after_one_step(run):
    variants.check_state_after_step(run)
