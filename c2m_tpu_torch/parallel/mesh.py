"""Data-parallel training over processes, one per card (the counterpart of
``c2m_tpu/parallel/mesh.py`` on its ``data`` axis; the spatial sharding of
the JAX mesh is not carried over).

Under ``jit`` on a data mesh the JAX package gets four things from XLA:
the gradient is the mean over the global batch, every reduction over the
batch (BatchNorm statistics, the masked GNN norm, the theta losses' node
count) spans all shards, the parameters stay replicated, and the metrics
are global. Here each is explicit:

- :func:`init_from_env` joins the process group that ``torchrun`` describes
  (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``): NCCL on the card
  (``cuda:LOCAL_RANK``), gloo on the CPU;
- :func:`broadcast_state` gives every rank rank 0's parameters and buffers;
- :func:`all_reduce_gradients` averages the gradients of the trained
  parameters once after the step's one ``backward()``, in flat buckets;
- :func:`global_sum` adds a tensor over the ranks inside autograd
  (``torch.distributed.nn.functional.all_reduce``: its backward adds the
  gradients over the ranks too), for the norms' statistics;
- :func:`mean_metrics` averages the step's metrics.

Each is the identity when no process group is live, so a single process
runs as before. With a group of one rank the collectives run and change
no bit (a sum over one rank, a division by 1).

A hand-written all-reduce, not ``DistributedDataParallel``: the step
differentiates one combined scalar whose parts pass through the
discriminators three times per step with ``.detach()`` at the reference's
points, and the norms need their statistics over all ranks inside the
forward anyway; one reduction of the finished gradients is the JAX mesh's
semantics with nothing to prove about DDP's hooks.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

# gradients are reduced in flat buffers of at most this many bytes
BUCKET_BYTES = 64 * 2 ** 20


def is_live() -> bool:
    """Whether a default process group is initialized (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_live() else 1


def rank() -> int:
    return dist.get_rank() if is_live() else 0


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return rank() == 0


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(rank_: int, world: int, device: torch.device,
         init_method: str = "env://", timeout_s: float = 300.0) -> None:
    """Join a process group of ``world`` ranks as ``rank_``: NCCL when
    ``device`` is a CUDA device (made the current one), gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)


def init_from_env(device: Optional[str] = None) -> torch.device:
    """Join the group ``torchrun`` describes and return this rank's device:
    ``cuda:LOCAL_RANK``, or the CPU when ``device`` says so."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None else \
        torch.device("cuda", local)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev)
    return dev


def shutdown() -> None:
    if is_live():
        dist.destroy_process_group()


def barrier() -> None:
    if is_live():
        dist.barrier()


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` from rank 0."""
    if not is_live():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def _buckets(tensors, limit: int = BUCKET_BYTES):
    bucket, size = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if bucket and (size + nb > limit or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nb
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Each ``.grad`` becomes its mean over the ranks. Parameters without a
    gradient are skipped (the same ones on every rank: the graph is)."""
    if not is_live():
        return
    grads = [p.grad for p in params if p.grad is not None]
    world = float(world_size())
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably: the backward sums the
    incoming gradients over the ranks as well, so a statistic that mixes
    every rank's rows sends each rank its share of the gradient."""
    if not is_live():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def global_sums(*sums):
    """Per-channel sums ``[C]`` (or 0-d counts) of one dtype and device,
    added over the ranks in one differentiable collective; returned in the
    shapes they came in."""
    flat = global_sum(torch.cat([t.reshape(-1) for t in sums]))
    out, offset = [], 0
    for t in sums:
        out.append(flat[offset:offset + t.numel()].reshape(t.shape))
        offset += t.numel()
    return tuple(out)


@torch.no_grad()
def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks, in one collective."""
    if not is_live() or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat /= float(world_size())
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Equal-shaped per-rank tensors concatenated along axis 0 in rank
    order (the global batch), on every rank, on ``t``'s device (through
    the card when NCCL carries the group)."""
    if not is_live():
        return t
    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    if dist.get_backend() == "nccl" and src.device.type != "cuda":
        src = src.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device, t.dtype)


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's equal share of a global batch along axis 0."""
    if not is_live():
        return t
    n = t.shape[0] // world_size()
    return t[rank() * n:(rank() + 1) * n]
