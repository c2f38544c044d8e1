# Stands in for c2m_tpu_torch/parallel/mesh.py in the frozen reference: the
# reference runs as one process with no process group.
"""The process-group helpers the model code calls, for one process."""


def is_live() -> bool:
    return False


def is_main() -> bool:
    return True


def world_size() -> int:
    return 1


def rank() -> int:
    return 0


def broadcast_state(model) -> None:
    return None


def global_sum(t):
    return t


def global_sums(*sums):
    return tuple(sums)


def gather_rows(t):
    return t


def local_rows(t):
    return t


def mean_metrics(metrics):
    return metrics


def all_reduce_gradients(params) -> None:
    raise RuntimeError("the reference runs without a process group")
