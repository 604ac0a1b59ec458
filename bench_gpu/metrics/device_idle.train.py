"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of the profiler's device events), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
