"""Transitions counted into the table over the traced window's time (the
profiler's cost included)."""


def read(run):
    if run.trace is None:
        return None
    return run.work["transitions"] / run.window_s
