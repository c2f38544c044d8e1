"""Host time inside the ``train_step(state, batch, eps, click_mask)`` call,
per step, over the window's untraced steps: the step has no synchronise
inside, so this is how long the host takes to queue it."""

UNIT = "ms"


def read(run):
    if run.kind != "train" or not run.enqueue:
        return None
    return 1e3 * sum(run.enqueue) / len(run.enqueue)
