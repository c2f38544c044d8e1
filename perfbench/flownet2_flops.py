#!/usr/bin/env python3
"""Count the floating-point operations of FlowNet2 (the plain reference,
``perfbench/reference/models/flownet2.py``) at a configuration's input size
and write them into its file under ``flownet2_flops``, so that no run pays
for the count.

    python3 perfbench/flownet2_flops.py <config> [...]

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
transposed convolutions of one frame pair on the meta device; it does not
see the cost volume, which is added as 2 x 441 x C operations a pixel of
the features it correlates (C = 256 at an eighth of the input's sides).
A clip of T frames is 2(T - 1) pairs (``tools/precompute_flow.batch_flows``).
The key is its own because ``perfbench/flops.py`` writes ``flops`` whole.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CORRELATION_CHANNELS = 256
DISPLACEMENTS = 21 * 21


def correlation_flops(h: int, w: int, pairs: int = 1) -> int:
    """2 x 441 x C x pixels x pairs at the features' eighth of (h, w)."""
    return 2 * DISPLACEMENTS * CORRELATION_CHANNELS * (h // 8) * (w // 8) \
        * pairs


def count(h: int, w: int, frames: int, device="meta") -> dict:
    """{'pair', 'correlation_per_pair', 'per_clip'} at input (h, w) and
    ``frames`` frames a clip."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.models.flownet2 import FlowNet2
    with torch.device(device):
        model = FlowNet2().eval()
        inputs = torch.zeros(1, 3, 2, h, w)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model(inputs)
    corr = correlation_flops(h, w)
    pair = int(fc.get_total_flops()) + corr
    return {"pair": pair, "correlation_per_pair": corr,
            "per_clip": pair * 2 * (frames - 1)}


def main(argv) -> int:
    from perfbench import harness
    for name in argv:
        path = os.path.join(HERE, "configs", f"{name}.json")
        data = harness.read_json(path)
        tp = data["config"]["train_params"]
        frames = tp["num_input_frames"] + tp["num_predicted_frames"]
        data["flownet2_flops"] = count(*tp["input_size"], frames)
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        print(name, json.dumps(data["flownet2_flops"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
