#!/usr/bin/env python3
"""Count the floating-point operations of each configuration's reference
and write them into its file, so that no run pays for the count.

    python3 perfbench/flops.py [<config> ...]

For every ``perfbench/configs/<config>.json`` (all of them by default) it
builds the frozen reference (``perfbench/reference``) on the meta device
and counts, with ``torch.utils.flop_counter.FlopCounterMode``:
- ``serve_forward_per_clip``: ``C2MGenerator.inference`` on one clip, the
  click path (GNN thetas), as a request serves it;
- ``train_step_per_clip``: the train forward of ``C2MTrainModel`` on one
  clip with the combined objective's backward, as one train step computes
  it (Adam's elementwise update is not counted).
The counter counts matrix products and convolutions; both sides of a
step and of a request scale with the clips, so one clip's count times the
clips is the count of a batch. The numbers are fixed with the
configuration: a later change to the program does not move them.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def clip_batch(cfg, device) -> dict:
    """One clip's batch of the scene generator's layout, as zeros on
    ``device`` (shapes only matter to the count)."""
    import torch
    tp = cfg.train_params
    h, w = tp.input_size
    t, tpred, n = tp.num_frames, tp.num_predicted_frames, \
        cfg.dataset_params.max_objects

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"video": z(1, t, h, w, 3), "bg_mask": z(1, t, h, w, 11),
            "fg_mask": z(1, t, h, w, 9), "instance_mask": z(1, t, h, w, 1),
            "target_bw_of": z(1, tpred, h, w, 2),
            "target_bw_occ": z(1, tpred, h, w, 1),
            "nodes_x": z(1, n, 23), "targets_theta": z(1, n, tpred, 6),
            "node_mask": z(1, n, dtype=torch.bool),
            "num_real_nodes": z(1, dtype=torch.int32),
            "inst_ids": z(1, n, dtype=torch.int32),
            "rois_padded": z(1, n, 4), "rois_target_last": z(1, n, 4)}


def count(cfg, device="meta") -> dict:
    """{'serve_forward_per_clip': F, 'train_step_per_clip': F} of the
    reference at ``cfg`` (a reference config)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.models.c2m import C2MGenerator
    from perfbench.reference.train.model import C2MTrainModel
    from perfbench.reference.train.step import combined_loss
    enc = cfg.model_params.motion_estimator.dense_motion_encoder
    zd = enc.out_channel_bg + enc.out_channel_fg
    n = cfg.dataset_params.max_objects
    out = {}
    with torch.device(device):
        gen = C2MGenerator(cfg).eval()
        batch = clip_batch(cfg, device)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            gen.inference(batch, torch.zeros(1, zd), torch.zeros(1, n),
                          use_gt_eval=False)
        out["serve_forward_per_clip"] = int(fc.get_total_flops())
        del gen
        model = C2MTrainModel(cfg).train()
        with FlopCounterMode(display=False) as fc:
            _, losses, ldi, ldv = model(batch, torch.zeros(1, zd),
                                        torch.zeros(1, n))
            total, _ = combined_loss(cfg, losses, ldi, ldv)
            total.backward()
        out["train_step_per_clip"] = int(fc.get_total_flops())
    return out


def main(argv) -> int:
    from perfbench import harness
    names = argv or sorted(f[:-5] for f in os.listdir(
        os.path.join(HERE, "configs")) if f.endswith(".json"))
    for name in names:
        path = os.path.join(HERE, "configs", f"{name}.json")
        data = harness.read_json(path)
        flops = count(harness.reference_config({"config_file": data}))
        data["flops"] = flops
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        print(name, json.dumps(flops))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
