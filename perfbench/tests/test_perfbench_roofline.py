"""The frozen bound arithmetic reproduces rows of PERF.md's kernel table
(NVIDIA H100 peaks: 3.35 TB/s, 67 TFLOP/s float32)."""

import pytest
import torch

from perfbench import roofline


def test_k4_journal_request_row():
    # K4 [60,128,256,2]: 0.0070 ms, bound by bytes
    b = roofline.k4(60, 128, 256)
    assert b["bound_ms"] == pytest.approx(0.0070, abs=5e-5)
    assert b["bound_by"] == "bytes"


def test_k1_long_request_bottleneck_row():
    # K1 [40,64,128,256] bf16 x mask: 0.1013 ms
    b = roofline.k1_forward("bfloat16", 40, 64, 128, 256, frames=1,
                            masked=True)
    assert b["bound_ms"] == pytest.approx(0.1013, abs=5e-5)


def test_k2_pairs_counts_last_to_first():
    valid = torch.tensor([[True, True, False, True]])
    # pixel won by node 1 (rank 2) visits valid nodes 1..3: two of them;
    # a background pixel visits all three valid nodes
    winner = torch.tensor([[[[2, 0]]]], dtype=torch.int32)
    assert roofline.k2_pairs(valid, winner) == 2 + 3
