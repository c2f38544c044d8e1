"""Trainer: epoch loop, logging cadence, checkpoints and resume, mid-train
eval (port of ``c2m_tpu/train/trainer.py``; reference
src/trainer/{base.py, trainer.py}).

The job dir and its ``params/config.txt`` snapshot, the print / display /
eval / save hooks by ``total_iter`` and the epoch checkpoints are the JAX
trainer's. What differs:

- A save is keyed by the global step, and ``iter.txt`` counts the batches
  done within the epoch (``utils/checkpoint.py``). ``continue_train``
  resumes at the next batch of the saved epoch, in that epoch's shuffled
  order, with the optimizer, scheduler and the CPU generator that draws the
  VAE noise and the clicks restored, so a resumed run takes the same steps
  as an unbroken one. (The JAX trainer keys its Orbax saves by the epoch,
  so within an epoch only the first save lands, counts the resume's
  ``total_iter`` twice after epoch 1 and restarts the epoch at batch 0.)
- The display (``make_eval_step``) and the sampled eval draw their noise
  and clicks from generators seeded from ``(seed + 1, total_iter)``, never
  from the training generator, so the cadences leave the training stream
  alone.
- A batch goes to the card once per step, copied ``non_blocking`` from
  pinned host memory that the loader's threads fill.

Under a live process group (``parallel/mesh``: ``train_torch.py`` under
``torchrun``, one process per card) the loader reads this rank's shard of
each epoch, ``train_params.batch_size`` clips per rank as the JAX loader's
per host; the step takes the global batch's draws and averages the
gradients and the metrics (``train/step.py``). Rank 0 alone writes: the
config snapshot, the logs, checkpoints and ``iter.txt``, the display and
the sampled eval; every rank reads a resume. The display gathers the
ranks' outputs to rank 0 first; the sampled eval trims the val batch to a
multiple of the number of ranks and gives each rank its rows.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.data.loader import DataLoader
from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.models.sparse_motion import sample_click_indices
from c2m_tpu_torch.parallel import mesh
from c2m_tpu_torch.serving import z_dim
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.train.step import make_eval_step, make_train_step
from c2m_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from c2m_tpu_torch.utils.visualizer import Visualizer

# salts of the per-iteration generators: the display's forward and the
# sampled eval (the JAX trainer folds 7 into its key for the latter)
_DISPLAY, _EVAL = 0, 7


def device_batch(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or pinned tensors) as tensors on
    ``device``; ``"names"`` stays behind. Copies from pinned memory do not
    block the host."""
    out = {}
    for k, v in batch.items():
        if k == "names":
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=t.is_pinned())
    return out


def host_arrays(tree) -> Dict[str, np.ndarray]:
    """Tensors (any device, any float dtype) and arrays -> float32 / integer
    numpy arrays on the host; ``"names"`` dropped."""
    out = {}
    for k, v in tree.items():
        if k == "names":
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = (v.float() if v.is_floating_point() else v).cpu().numpy()
        out[k] = np.asarray(v)
    return out


def step_generator(seed: int, total_iter: int, salt: int) -> torch.Generator:
    """A CPU generator seeded from (seed + 1, total_iter, salt)."""
    words = np.random.SeedSequence([seed + 1, total_iter, salt]).generate_state(2)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


class Trainer:
    def __init__(self, cfg: Config, dataset, val_dataset=None,
                 job_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        tp = cfg.train_params
        self.device = resolve_device(device)
        self.job_dir = job_dir or os.path.join(
            cfg.workspace, f"{cfg.dataset_params.dataset}_{cfg.name}{cfg.suffix}")
        self.is_main = mesh.is_main()
        os.makedirs(self.job_dir, exist_ok=True)
        if self.is_main:
            self._snapshot_config()

        pinned = self.device.type == "cuda"
        self.loader = DataLoader(dataset, batch_size=tp.batch_size,
                                 shuffle=True, seed=tp.seed,
                                 num_workers=tp.workers, pin_memory=pinned,
                                 host_id=mesh.rank(),
                                 num_hosts=mesh.world_size())
        self.val_dataset = val_dataset
        self.steps_per_epoch = max(len(self.loader), 1)
        self.state = create_train_state(cfg, device=self.device,
                                        steps_per_epoch=self.steps_per_epoch)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self._val_loader = None
        self._val_iter = None

        # on-the-fly FlowNet2 supervision when flows aren't precomputed
        # (reference trainer.py:42-98)
        self.flow_onthefly = None
        if not tp.use_pre_processed_of:
            from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow
            self.flow_onthefly = OnTheFlyFlow(
                tp.num_input_frames, tp.num_predicted_frames,
                weights_path=os.environ.get("FLOWNET2_WEIGHTS"),
                device=self.device)

        self.start_epoch, self.epoch_iter = 1, 0
        if tp.continue_train:
            self._stand_at(*load_checkpoint(self.job_dir, self.state))
            print(f"resumed at step {self.state.step}: epoch "
                  f"{self.start_epoch}, batch {self.epoch_iter}", flush=True)

        vz = cfg.visualizer_params
        self.visualizer = Visualizer(self.job_dir, use_html=vz.use_html,
                                     tf_log=vz.tf_log) if self.is_main else None
        self.total_iter = self.state.step
        # the newest steps: total_iter, epoch, the dataset indices of the
        # batch, the lr per group it was taken with, and the metrics
        # (tensors on the device, read when needed)
        self.history = collections.deque(maxlen=64)

    def _stand_at(self, epoch: int, epoch_iter: int) -> None:
        """Where the next step starts: batch ``epoch_iter`` of ``epoch``,
        or the next epoch's first batch when ``epoch`` is finished."""
        if epoch_iter >= self.steps_per_epoch:
            epoch, epoch_iter = epoch + 1, 0
        self.start_epoch, self.epoch_iter = epoch, epoch_iter

    def _snapshot_config(self) -> None:
        params_dir = os.path.join(self.job_dir, "params")
        os.makedirs(params_dir, exist_ok=True)
        import yaml
        with open(os.path.join(params_dir, "config.txt"), "w") as f:
            yaml.safe_dump(self.cfg.to_dict(), f)

    def fit(self, num_epochs: Optional[int] = None,
            max_steps: Optional[int] = None) -> None:
        """Train from the current epoch and batch through ``num_epochs``
        (default ``train_params.num_epochs``). ``max_steps`` caps the
        batches of each epoch, counted from its first batch, so a resumed
        epoch stops where an unbroken one would."""
        cfg = self.cfg
        tp = cfg.train_params
        vz = cfg.visualizer_params
        epochs = num_epochs or tp.num_epochs

        first = self.start_epoch
        for epoch in range(first, epochs + 1):
            start = self.epoch_iter if epoch == first else 0
            self.loader.set_epoch(epoch, start)
            order = self.loader.batch_indices()
            epoch_iter = start
            t_epoch = time.time()
            t_iter = time.time()
            for batch_np, indices in zip(self.loader, order):
                if max_steps is not None and epoch_iter >= max_steps:
                    break
                batch = device_batch(batch_np, self.device)
                if self.flow_onthefly is not None:
                    batch.update(self.flow_onthefly(batch["video"]))
                lrs = [g["lr"] for g in self.state.optimizer.param_groups]
                metrics = self.train_step(self.state, batch)
                epoch_iter += 1
                self.total_iter += 1
                self.history.append({"step": self.total_iter, "epoch": epoch,
                                     "indices": indices.tolist(), "lr": lrs,
                                     "metrics": metrics})

                if self.is_main and self.total_iter % vz.print_freq == 0:
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                    self.visualizer.log_losses(epoch, self.total_iter,
                                               metrics_host,
                                               time.time() - t_iter)
                if self.total_iter % vz.display_freq == 0:
                    self._display(batch, epoch)
                if self.total_iter % tp.eval_freq == 0:
                    self._generate_eval(epoch, batch_np)
                if self.total_iter % vz.save_latest_freq == 0:
                    self._save(epoch, epoch_iter)
                t_iter = time.time()

            if epoch % cfg.checkpoint_params.save_epoch_freq == 0:
                self._save(epoch, epoch_iter)
            self._stand_at(epoch, epoch_iter)
            if self.is_main:
                print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s",
                      flush=True)

    def _save(self, epoch: int, epoch_iter: int) -> None:
        """Rank 0 writes the checkpoint; the others wait for it."""
        if self.is_main:
            save_checkpoint(self.job_dir, self.state, epoch, epoch_iter)
        mesh.barrier()

    # -- the display (reference _generate_eval, trainer.py:186-209) ----------

    def _draws(self, num_real_nodes: torch.Tensor, n_max: int, salt: int):
        """Noise [b, z_dim] and a click mask [b, n_max] for this rank's b
        rows of this iteration's display or eval, drawn for the global
        batch, on the model's device."""
        g = step_generator(self.cfg.train_params.seed, self.total_iter, salt)
        num_real = mesh.gather_rows(num_real_nodes)
        z = torch.randn(num_real.shape[0], z_dim(self.cfg), generator=g)
        _, click = sample_click_indices(num_real, n_max, g)
        return mesh.local_rows(z).to(self.device), mesh.local_rows(click)

    def _display(self, batch, epoch: int) -> None:
        """A train=False forward of the step's batch (``make_eval_step``),
        the ranks' rows gathered to rank 0 and dumped to the gallery with
        their trajectories."""
        out, _ = self._eval_forward(batch)
        host_out = host_arrays({k: mesh.gather_rows(v) for k, v in out.items()
                                if v.dim() > 0})
        host_batch = host_arrays({k: mesh.gather_rows(v)
                                  for k, v in batch.items()})
        if not self.is_main:
            return
        self.visualizer.display_results(host_batch, host_out, epoch,
                                        self.total_iter)
        self.visualizer.log_trajectories(
            epoch, self.total_iter, host_out["thetas"],
            host_batch["targets_theta"], host_batch["node_mask"])

    def _eval_forward(self, batch):
        n_max = batch["node_mask"].shape[1]
        eps, click = self._draws(batch["num_real_nodes"], n_max, _DISPLAY)
        return self.eval_step(self.state, batch, eps, click)

    # -- the mid-train sampled eval (trainer.py:186-209, base.py:115-121) ----

    def _next_val_batch(self):
        """Cycle one batch off the val set; None without a val set (the
        training batch is then the fallback)."""
        if self.val_dataset is None:
            return None
        if self._val_loader is None:
            tp = self.cfg.train_params
            self._val_loader = DataLoader(
                self.val_dataset, batch_size=self.cfg.test_params.batch_size,
                shuffle=False, seed=tp.seed, num_workers=0)
            self._val_iter = iter(self._val_loader)
        try:
            return next(self._val_iter)
        except StopIteration:
            self._val_iter = iter(self._val_loader)
            try:
                return next(self._val_iter)
            except StopIteration:  # val set smaller than the test batch
                return None

    def _infer(self, batch, z_m, click):
        """The model's sampled ``inference`` in eval mode (no gradient)."""
        self.state.model.eval()
        return self.state.model.inference(batch, z_m, click)

    def _generate_eval(self, epoch: int, batch=None):
        """Mid-train SAMPLED-inference eval: fresh z ~ N(0, 1) and fresh
        random clicks per call (from ``(seed + 1, total_iter)``), the
        ``inference`` path (not a train=False forward), on the next val
        batch; visualized under the "eval" tag. Returns the outputs as
        host arrays, or None without a batch."""
        host_batch = self._next_val_batch()
        if host_batch is None:
            host_batch = batch
        if host_batch is None:
            return None
        # every rank holds the same val batch (its training batch is its
        # own: gathered first); the rows are shared out evenly
        hb = host_arrays(host_batch if host_batch is not batch else
                         {k: mesh.gather_rows(v) for k, v in
                          device_batch(batch, self.device).items()})
        world = mesh.world_size()
        b_keep = (len(hb["video"]) // world) * world
        if b_keep == 0:
            return None
        hb = {k: v[:b_keep] for k, v in hb.items()}
        dev_batch = {k: mesh.local_rows(v)
                     for k, v in device_batch(hb, self.device).items()}
        n_max = dev_batch["node_mask"].shape[1]
        z, click = self._draws(dev_batch["num_real_nodes"], n_max, _EVAL)
        out = host_arrays({k: mesh.gather_rows(v) for k, v in
                           self._infer(dev_batch, z, click).items()})
        if not self.is_main:
            return out
        self.visualizer.display_results(hb, out, epoch, self.total_iter,
                                        tag="eval")
        self.visualizer.log_trajectories(
            epoch, self.total_iter, out["thetas"], hb["targets_theta"],
            hb["node_mask"], tag="eval")
        return out
