"""Export a serving artifact from a job dir of the port: the port of
``tools/export_serving.py``.

  python -m c2m_tpu_torch.tools.export_serving --config YAML
      --job-dir DIR --out ARTIFACT_DIR [--batch-sizes 1,4,12]
      [--random-init] [--device cpu]

The state is built as ``train_torch.py`` builds it (``create_train_state``
from the config's seed) and the job dir's latest checkpoint is loaded into
it, unless ``--random-init`` exports the seeded init; a job dir without a
checkpoint is an error, not an export of the init. ``serving.
export_artifact`` then writes ``variables.npz`` (the generator's weights in
the JAX layout, which both packages serve), ``meta.json`` and
``config.yaml``; ``ServingModel.from_artifact`` reads it. The JAX tool's
``--platforms`` is not taken: the port serves from the weights and writes
no StableHLO, so its ``meta.json`` says ``"platforms": []``. The model is
built on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--job-dir", default=None,
                   help="checkpoint dir; omit with --random-init")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-sizes", default="1",
                   help="comma-separated serving buckets")
    p.add_argument("--random-init", action="store_true",
                   help="export the seeded init (smoke/testing)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device); the JAX "
                        "tool's --platforms has no counterpart: no StableHLO "
                        "is written")
    args = p.parse_args(argv)

    from c2m_tpu_torch.config import load_config
    from c2m_tpu_torch.device import resolve_device
    from c2m_tpu_torch.serving import export_artifact
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.utils.checkpoint import latest_step, load_checkpoint

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    if not args.random_init:
        if not args.job_dir:
            p.error("--job-dir required unless --random-init")
        if latest_step(args.job_dir) is None:
            p.error(f"no checkpoint under {args.job_dir}")
    state = create_train_state(cfg, device=dev)
    if not args.random_init:
        epoch, _ = load_checkpoint(args.job_dir, state)
        print(f"exporting the checkpoint of step {state.step} (epoch {epoch})")
    export_artifact(args.out, cfg, state.model, batch_sizes=batch_sizes)
    print(f"artifact written to {args.out}:")
    for f in sorted(os.listdir(args.out)):
        kb = os.path.getsize(os.path.join(args.out, f)) // 1024
        print(f"  {f:28s} {kb:8d} KiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
