"""The traced run's instruments: a record of every hand-written kernel
launch with its shapes, and a summary of one torch.profiler window.

Nothing here is in the port. The launch record wraps the port's launch
functions (``_launch`` / ``_launch_backward`` of ``c2m_tpu_torch/ops/
hopper/*``) for the profiled units only; each wrapper notes the launch's
shapes and, for the winner kernels, keeps its inputs so that the
reference can count the (pixel, node) pairs they need once the window has
closed.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

# device kernels of each hand-written kernel, by a part of their name
KERNEL_NAMES = {
    "k1_forward": ("resample_vec_kernel", "resample_pixel_kernel",
                   "resample_scalar_kernel", "resample_scalar64_kernel"),
    "k1_backward": ("resample_bwd_",),
    "k2": ("warp_masks_winner_kernel",),
    "k3": ("node_boxes_kernel", "warp_masks_tiles_kernel"),
    "k4": ("splat_kernel",),
}

UNIT_SPAN = "perfbench.unit"
WINDOW_SPAN = "perfbench.window"


def kernel_of(name: str) -> Optional[str]:
    """Which hand-written kernel a device kernel's name belongs to."""
    for kernel, parts in KERNEL_NAMES.items():
        if any(p in name for p in parts):
            return kernel
    return None


@dataclasses.dataclass
class Launch:
    kernel: str                  # a key of KERNEL_NAMES
    args: Dict                   # shapes and flags, as roofline takes them
    inputs: Tuple = ()           # the winner kernels' inputs


class LaunchRecord:
    """Context manager: while active, every launch of a hand-written kernel
    appends a :class:`Launch` to ``launches``."""

    def __init__(self):
        self.launches: List[Launch] = []
        self._saved = []

    def __enter__(self):
        from c2m_tpu_torch.ops.hopper import (maskwarp_banded,
                                              maskwarp_kernel, splat_kernel,
                                              warp_kernels)
        record = self.launches

        def dtype_name(t):
            return "bfloat16" if t.dtype == torch.bfloat16 else "float32"

        def k1_forward(orig):
            def launch(image, flow, mask, frames=1, route=None):
                out = orig(image, flow, mask, frames, route)
                b, h, w, c = out.shape
                record.append(Launch("k1_forward", dict(
                    dtype=dtype_name(image), b=b, h=h, w=w, c=c,
                    frames=frames, masked=mask is not None)))
                return out
            return launch

        def k1_backward(orig):
            def launch(grad_out, image, flow, mask, need_image, need_flow,
                       need_mask, frames=1, route=None):
                out = orig(grad_out, image, flow, mask, need_image, need_flow,
                           need_mask, frames, route)
                b, h, w, c = grad_out.shape
                record.append(Launch("k1_backward", dict(
                    dtype=dtype_name(image), b=b, h=h, w=w, c=c,
                    frames=frames, masked=mask is not None,
                    need_image=bool(need_image), need_flow=bool(need_flow),
                    need_mask=bool(need_mask and mask is not None))))
                return out
            return launch

        def winner(kernel, orig):
            def launch(instance, inst_ids, valid, thetas):
                out = orig(instance, inst_ids, valid, thetas)
                b, n, t = thetas.shape[:3]
                h, w = instance.shape[1:3]
                record.append(Launch(kernel, dict(b=b, n=n, t=t, h=h, w=w),
                                     (instance, inst_ids, valid, thetas)))
                return out
            return launch

        def splat(orig):
            def launch(coords):
                out = orig(coords)
                b, h, w = coords.shape[:3]
                record.append(Launch("k4", dict(b=b, h=h, w=w)))
                return out
            return launch

        patches = [(warp_kernels, "_launch", k1_forward),
                   (warp_kernels, "_launch_backward", k1_backward),
                   (maskwarp_kernel, "_launch",
                    lambda o: winner("k2", o)),
                   (maskwarp_banded, "_launch",
                    lambda o: winner("k3", o)),
                   (splat_kernel, "_launch", splat)]
        for module, attr, wrap in patches:
            orig = getattr(module, attr)
            self._saved.append((module, attr, orig))
            setattr(module, attr, wrap(orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()
        return False


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: float        # microseconds, on the profiler's clock
    end: float


@dataclasses.dataclass
class TraceSummary:
    """What the readers take from one profiled window."""
    window: Tuple[float, float]          # the window span, microseconds
    units: int                           # requests or steps in the window
    kernels: List[DeviceEvent]           # device kernels
    copies: List[DeviceEvent]            # memcpy / memset on the device
    busy_us: float                       # union of kernels and copies
    idle_gaps: List[Tuple[str, float]]   # (host activity, seconds)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block (CPU and CUDA activities); yields the
    profiler, whose events the block's caller summarises afterwards."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Merged [start, end] intervals clipped to [lo, hi]."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise(prof, units: int) -> TraceSummary:
    """Device events, busy time and idle gaps of the window span
    (``WINDOW_SPAN``) recorded inside ``prof``."""
    from torch.autograd import DeviceType
    events = prof.events()
    cpu, kernels, copies = [], [], []
    window = None
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue            # a host span drawn on the device's line
            ev = DeviceEvent(e.name, tr.start, tr.end)
            low = e.name.lower()
            (copies if low.startswith(("memcpy", "memset")) else
             kernels).append(ev)
        elif e.device_type == DeviceType.CPU:
            if e.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
            elif not e.name.startswith(("perfbench.", "ProfilerStep",
                                        "[memory]")):
                cpu.append((tr.start, tr.end, e.name))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    kernels = [k for k in kernels if k.end > lo and k.start < hi]
    copies = [k for k in copies if k.end > lo and k.start < hi]
    busy = _union([(k.start, k.end) for k in kernels + copies], lo, hi)
    busy_us = sum(e - s for s, e in busy)

    # idle gaps, each named by the innermost host activity at its middle
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    cpu.sort()
    starts = [c[0] for c in cpu]
    by_name: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        name = "(python between ops)"
        # the latest-starting host op that still covers the middle
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 400), -1):
            if cpu[i][1] >= mid:
                name = cpu[i][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    idle = sorted(by_name.items(), key=lambda kv: -kv[1])
    return TraceSummary(window, units, kernels, copies, busy_us, idle)


def top_device_ops(summary: TraceSummary, n: int = 10):
    """[[device op name, seconds], ...], the n that took most time."""
    total: Dict[str, float] = {}
    for ev in summary.kernels + summary.copies:
        total[ev.name] = total.get(ev.name, 0.0) + (ev.end - ev.start) / 1e6
    rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], sec] for name, sec in rows]


def launch_bound_ms(launch: Launch) -> float:
    """The least time of one recorded launch (``roofline``)."""
    from perfbench import roofline
    a = launch.args
    if launch.kernel == "k1_forward":
        return roofline.k1_forward(**a)["bound_ms"]
    if launch.kernel == "k1_backward":
        return roofline.k1_backward(**a)["bound_ms"]
    if launch.kernel in ("k2", "k3"):
        return roofline.k2(a["b"], a["n"], a["t"], a["h"], a["w"],
                           a["pairs"])["bound_ms"]
    return roofline.k4(a["b"], a["h"], a["w"])["bound_ms"]


def roofline_pct(run) -> Optional[float]:
    """The recorded launches' least time over the device time of their
    kernels in the trace, in percent; None without launches or trace."""
    if run.trace is None or not run.launches:
        return None
    device_ms = sum((k.end - k.start) / 1e3 for k in run.trace.kernels
                    if kernel_of(k.name))
    if device_ms <= 0:
        return None
    return 100.0 * sum(launch_bound_ms(x) for x in run.launches) / device_ms


def idle_pct(run) -> Optional[float]:
    """The share of the traced window with nothing running on the device."""
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)


def launches_per_unit(run) -> Optional[float]:
    """Device kernels per traced request or step."""
    if run.trace is None:
        return None
    return len(run.trace.kernels) / run.trace.units


def mfu_pct(flops: Optional[float], seconds: float,
            cell: dict) -> Optional[float]:
    """``flops`` done in ``seconds`` over the peak of the precision the
    cell's configuration states (``roofline.peak_flops``), in percent."""
    from perfbench import roofline
    if not flops or seconds <= 0:
        return None
    cf = cell["config_file"]
    peak = roofline.peak_flops(cf["config"]["train_params"]["dtype"],
                               bool(cf.get("allow_tf32", False)))
    return 100.0 * flops / seconds / peak
