#!/usr/bin/env python3
"""Training entry point of the PyTorch port (counterpart of ``train.py``;
reference src/train.py + src/options/options.py).

  python3 train_torch.py --config configs/c2m_journal_cityscapes.yaml \
      [--seed N] [--num-epochs N] [--max-steps N] [--job-dir DIR] \
      [--device cuda|cpu] [--profile]

Runs on the card unless ``--device cpu`` is given. ``--profile`` traces 7
steps with torch.profiler into ``<job_dir>/profile`` and exits, as
``train.py`` does with jax.profiler.

Data-parallel over N cards of one host, one process per card:

  torchrun --nproc_per_node=N train_torch.py --config ...

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``) at ``train_params.batch_size`` clips per rank, as ``train.py``
trains over every local device at that batch per host; rank 0 writes the
job dir. Without ``torchrun``'s variables it runs as one process.
``--device_ids`` is accepted for the reference CLI and ignored: the cards
are the ranks'.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("c2m-tpu-torch train")
    p.add_argument("--config", required=True, help="path to the yaml config")
    p.add_argument("--device_ids", default=None,
                   help="accepted for reference-CLI parity; ignored")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile", action="store_true",
                   help="trace 7 steps with torch.profiler, then exit")
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--job-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from c2m_tpu_torch.device import resolve_device
    from c2m_tpu_torch.parallel import mesh

    if mesh.launched_by_torchrun():
        device = mesh.init_from_env(args.device)
    else:
        device = resolve_device(args.device)
    try:
        return run(args, device)
    finally:
        mesh.shutdown()


def run(args, device) -> int:
    from c2m_tpu_torch.config import load_config
    from c2m_tpu_torch.data.dataset import get_test_set, get_training_set
    from c2m_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if args.seed is not None:
        cfg.train_params.seed = args.seed
    dataset = get_training_set(cfg, device=device)
    try:
        # the val set feeds the eval_freq-cadenced mid-train sampled
        # inference (reference src/train.py:62-66 + trainer.py:186-209)
        val_dataset = get_test_set(cfg, device=device)
    except (OSError, ValueError) as e:
        print(f"no val set ({e}); mid-train eval falls back to train batches")
        val_dataset = None
    trainer = Trainer(cfg, dataset, val_dataset=val_dataset,
                      job_dir=args.job_dir, device=device)

    if args.profile:
        # reference --profile: 7 iterations under the profiler, then exit
        # (src/train.py:103-123)
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        trace_dir = os.path.join(trainer.job_dir, "profile")
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(trace_dir)):
            trainer.fit(num_epochs=trainer.start_epoch, max_steps=7)
        print(f"profile trace written to {trace_dir}")
        return 0

    trainer.fit(num_epochs=args.num_epochs, max_steps=args.max_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
