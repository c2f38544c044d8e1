#!/usr/bin/env python3
"""Evaluation entry point of the PyTorch port (counterpart of ``test.py``;
reference src/test.py).

  python3 eval_torch.py --config configs/c2m_journal_cityscapes.yaml \
      [--job-dir DIR] [--max-batches N] [--device cuda|cpu]

Loads the job dir's latest checkpoint, runs sampled inference over the val
set (z and clicks from a generator seeded with ``test_params.seed``), dumps
gifs / pngs / flow and occlusion strips and an HTML page, computes the
metrics it can and writes ``<job_dir>/eval/results.txt``. Runs on the card
unless ``--device cpu`` is given; ``--device_ids`` is accepted and ignored.

The metric nets come from weights files named by three environment
variables, as for the JAX package's ``test.py``: ``INCEPTION_WEIGHTS`` (the
npz of ``tools/convert_inception.py``: InceptionV3 for FID; without it
torchvision's checkpoint in the local torch hub cache, if there),
``I3D_WEIGHTS`` (the npz of ``tools/convert_i3d.py``: I3D for FVD) and
``YOLO_WEIGHTS`` (an npz of the JAX YOLOv3 variables or a darknet
``.weights``: the detector of the detection metric). The run prints which
nets it built; without them FID and FVD read NaN and no detection metric
is written.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("c2m-tpu-torch eval")
    p.add_argument("--config", required=True)
    p.add_argument("--device_ids", default=None, help="ignored")
    p.add_argument("--job-dir", default=None)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    import torch
    from c2m_tpu_torch.config import load_config
    from c2m_tpu_torch.data.dataset import get_test_set
    from c2m_tpu_torch.data.loader import DataLoader
    from c2m_tpu_torch.device import resolve_device
    from c2m_tpu_torch.eval.evaluator import Evaluator
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.utils.checkpoint import load_checkpoint, latest_step

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    job_dir = args.job_dir or os.path.join(
        cfg.workspace, f"{cfg.dataset_params.dataset}_{cfg.name}{cfg.suffix}")
    if latest_step(job_dir) is None:
        print(f"no checkpoint under {job_dir}", file=sys.stderr)
        return 1
    loader = DataLoader(get_test_set(cfg, device=device),
                        batch_size=cfg.test_params.batch_size, shuffle=False,
                        num_workers=cfg.test_params.workers, drop_last=False)
    state = create_train_state(cfg, seed=cfg.test_params.seed, device=device)
    epoch, _ = load_checkpoint(job_dir, state)
    print(f"evaluating the checkpoint of step {state.step} (epoch {epoch})")

    evaluator = Evaluator(cfg, state.model, job_dir)
    nets = evaluator.metric_nets
    print("metric nets: " + ("; ".join(f"{k}: {v}" for k, v in nets.items())
                             if nets else "none"), flush=True)
    generator = torch.Generator().manual_seed(cfg.test_params.seed)
    for bi, batch in enumerate(loader):
        if args.max_batches is not None and bi >= args.max_batches:
            break
        out = evaluator.evaluate_batch(batch, bi, generator)
        evaluator.save_samples(batch, out, bi)
        evaluator.fetch_metrics_data(batch, out)
        print(f"batch {bi} done", flush=True)

    results = evaluator.generate_metrics()
    path = evaluator.write_metrics(results)
    if evaluator.detector is not None:
        print(f"detector ran on {evaluator.detector_frames} last frames; "
              f"{len(evaluator._det['gt_detected'])} ground-truth detections "
              f"matched")
    print(f"wrote {path}: {results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
