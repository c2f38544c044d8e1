"""Checkpoints of a ``TrainState`` (counterpart of
``c2m_tpu/utils/checkpoint.py``; reference trainer.py:245-260, one
``torch.save`` of model and optimizers plus ``iter.txt``).

Layout under the job dir::

  checkpoints/<global step>/state.pt   one torch.save per save
  checkpoints/latest                   the global step of the newest save
  iter.txt                             "epoch,epoch_iter"

A save is keyed by the global step (``TrainState.step``), so every save of
a run lands, and a second save at the same step (the epoch's last step
when it is also a save step) writes the same state again. The newest
three are kept, as the JAX package's ``max_to_keep=3``. ``epoch_iter`` is
the number of batches done within ``epoch``: a resumed run continues at
the next batch of that epoch (``data/loader.DataLoader.set_epoch``).

What a save holds: the model's ``state_dict`` (parameters, BatchNorm
running statistics, spectral ``u``), the Adam optimizer with its four
groups, the ``LambdaLR`` scheduler (its ``last_epoch`` and lrs; the lr
functions are rebuilt from the config), ``TrainState.step``, the state of
the CPU ``torch.Generator`` that draws the VAE noise and the clicks, and
the epoch with its batch count. Every tensor is copied to the CPU before
it is written, one at a time, so the card never holds a second copy.

A checkpoint of the JAX package (Orbax) is not read: the serving artifact
(``serving.export_artifact``) is the format the two packages share.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from c2m_tpu_torch.train.state import TrainState

MAX_TO_KEEP = 3


def _on_cpu(obj: Any) -> Any:
    """``obj`` with every tensor inside it (dicts, lists, tuples) copied to
    the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def state_payload(state: TrainState, epoch: int, epoch_iter: int
                  ) -> Dict[str, Any]:
    """What :func:`save_checkpoint` writes, with every tensor on the CPU."""
    return {
        "model": _on_cpu(state.model.state_dict()),
        "optimizer": _on_cpu(state.optimizer.state_dict()),
        "scheduler": _on_cpu(state.scheduler.state_dict()),
        "generator": state.generator.get_state(),
        "step": int(state.step),
        "epoch": int(epoch),
        "epoch_iter": int(epoch_iter),
    }


def _ckpt_dir(job_dir: str) -> str:
    return os.path.join(os.path.abspath(job_dir), "checkpoints")


def checkpoint_path(job_dir: str, step: int) -> str:
    return os.path.join(_ckpt_dir(job_dir), str(int(step)), "state.pt")


def saved_steps(job_dir: str) -> list:
    root = _ckpt_dir(job_dir)
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit()
                  and os.path.exists(os.path.join(root, d, "state.pt")))


def latest_step(job_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(_ckpt_dir(job_dir), "latest")) as f:
            return int(f.read().strip())
    except FileNotFoundError:
        return None


def save_checkpoint(job_dir: str, state: TrainState, epoch: int,
                    epoch_iter: int) -> str:
    """Write the state under its global step, point ``latest`` at it, drop
    all but the newest ``MAX_TO_KEEP`` saves and write ``iter.txt``.
    Returns the path written."""
    path = checkpoint_path(job_dir, state.step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state_payload(state, epoch, epoch_iter), tmp)
    os.replace(tmp, path)
    latest = os.path.join(_ckpt_dir(job_dir), "latest")
    with open(latest + ".tmp", "w") as f:
        f.write(str(int(state.step)))
    os.replace(latest + ".tmp", latest)
    for old in saved_steps(job_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(_ckpt_dir(job_dir), str(old)))
    with open(os.path.join(job_dir, "iter.txt"), "w") as f:
        f.write(f"{epoch},{epoch_iter}")
    return path


def load_payload(job_dir: str, step: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """The saved payload at ``step`` (default the latest), tensors on the
    CPU; None when the job dir holds no checkpoint."""
    step = latest_step(job_dir) if step is None else step
    if step is None:
        return None
    return torch.load(checkpoint_path(job_dir, step), map_location="cpu",
                      weights_only=True)


def restore_state(state: TrainState, payload: Dict[str, Any]) -> None:
    """Load a payload into ``state`` in place (tensors go to the devices of
    the state's own). The payload stays as it was: the optimizer's state is
    loaded from a copy, since ``Optimizer.load_state_dict`` keeps a tensor
    that is already on its parameter's device and the next step would
    update it in place."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(_on_cpu(payload["optimizer"]))
    state.scheduler.load_state_dict(payload["scheduler"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])


def load_checkpoint(job_dir: str, state: TrainState,
                    step: Optional[int] = None) -> Tuple[int, int]:
    """Restore ``state`` in place from the save at ``step`` (default the
    latest) -> (epoch, epoch_iter) of that save; (1, 0) and ``state``
    untouched when there is none."""
    payload = load_payload(job_dir, step)
    if payload is None:
        return 1, 0
    restore_state(state, payload)
    return int(payload["epoch"]), int(payload["epoch_iter"])
