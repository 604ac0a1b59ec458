"""Optimizer applies completed over the traced window's time (the
profiler's cost included)."""


def read(run):
    if run.trace is None:
        return None
    return run.work["applies"] / run.window_s
