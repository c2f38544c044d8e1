"""What every cell shares: finding cells, configurations, traffic kinds and
metric readers by name, the configuration objects of the port and of the
reference, the run's environment, and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level modules a run must not hold (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "c2m_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell needs."""


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, base: str = HERE) -> Dict:
    """``workloads/<name>.json`` with its configuration file attached under
    ``"config_file"``; KeyError naming what is missing."""
    path = os.path.join(base, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"unknown workload {name!r}: no {path}")
    cell = read_json(path)
    cell["name"] = name
    cpath = os.path.join(base, "configs", f"{cell['config']}.json")
    if not os.path.isfile(cpath):
        raise KeyError(f"workload {name!r} names configuration "
                       f"{cell['config']!r}: no {cpath}")
    cell["config_file"] = read_json(cpath)
    return cell


def _load_file(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_kind(kind: str, base: str = HERE):
    """The module ``traffic/<kind>.py``."""
    path = os.path.join(base, "traffic", f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"unknown traffic kind {kind!r}: no {path}")
    return _load_file(path, f"perfbench_traffic_{kind}")


def metric_readers(base: str = HERE) -> Dict[str, Callable]:
    """{metric name: (read(run), unit)} for every ``metrics/<name>.py``."""
    folder = os.path.join(base, "metrics")
    out = {}
    for fname in sorted(os.listdir(folder)):
        if fname.endswith(".py") and not fname.startswith("_"):
            name = fname[:-3]
            module = _load_file(os.path.join(folder, fname),
                                "perfbench_metric_" + name.replace(".", "_"))
            out[name] = (module.read, module.UNIT)
    return out


def program_config(cell: Dict):
    """The port's ``Config`` of the cell's configuration file."""
    from c2m_tpu_torch import config as pc
    return pc.check(pc._update_dataclass(pc.Config(),
                                         cell["config_file"]["config"]))


def reference_config(cell: Dict):
    """The reference's ``Config`` of the same file."""
    from perfbench.reference import config as rc
    return rc.check(rc._update_dataclass(rc.Config(),
                                         cell["config_file"]["config"]))


def set_environment(root: str) -> None:
    """Caches inside the checkout at fixed paths; no JAX through
    transformers-like libraries; the port's kernels built into its own
    build directory (``c2m_tpu_torch/_build``, the port's default)."""
    cache = os.path.join(root, ".perfbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    # one process, one intra-op thread: idle worker threads spinning beside
    # the launching thread made the host-bound step spread 46% from run to
    # run on the card's 8-core host, against 5% with one thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("VGG19_WEIGHTS", None)


def one_thread() -> None:
    """PyTorch's intra-op threads to one (``set_environment`` sets the
    variables a fresh import reads; this holds where torch was imported
    first)."""
    import torch
    torch.set_num_threads(1)


def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} cards, the cell needs "
                     f"{count}")


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Check:
    """One compared number beside its limit (correct when value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def device_info(trace_summary=None) -> Dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": 0}
    if trace_summary is not None:
        info["busy_s"] = trace_summary.busy_us / 1e6
        info["window_s"] = trace_summary.window_us / 1e6
    return info


def finite_or_none(x: float) -> Optional[float]:
    """JSON has no NaN or infinity: such a reading is written as null."""
    return x if math.isfinite(x) else None


def emit(result: Dict, checks: List[Check]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line (with the same numbers under
    ``checks``, its last key) as the last line on standard output."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {c.name: {"value": finite_or_none(c.value),
                                 "limit": c.limit} for c in checks}
    print(json.dumps(result), flush=True)


class tf32:
    """float32 matmuls and convolutions in TF32 (``allow``) or in full
    float32 inside the block; the settings before it come back after it."""

    def __init__(self, allow: bool = False):
        self.allow = bool(allow)

    def __enter__(self):
        import torch
        self.before = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.allow
        torch.backends.cudnn.allow_tf32 = self.allow

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.before
        return False


def program_precision(cell: Dict) -> None:
    """The precision the configuration states, for the rest of the
    process: TF32 on for float32 matmuls and convolutions only where its
    file says ``"allow_tf32": true``."""
    import torch
    allow = bool(cell["config_file"].get("allow_tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
