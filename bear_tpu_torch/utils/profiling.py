"""Profiling hooks (port of bear_tpu/utils/profiling.py).

``trace`` records the enclosed block with ``torch.profiler`` (the CPU, and
the card's kernels and copies when one is present) and writes a Chrome
trace into ``out_dir`` (viewable in Perfetto or chrome://tracing).
``StageTimer`` is named wall-clock stage timing that lands in the same
scalars.jsonl stream as training metrics.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the enclosed block; on exit write ``out_dir/trace.json``.
    Yields the ``torch.profiler.profile`` object (``key_averages()`` etc.)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class StageTimer:
    """Named wall-clock stage timing, optionally teed to a MetricsWriter.

    >>> timer = StageTimer(writer)
    >>> with timer.stage("counting"):
    ...     run_counting(...)
    >>> timer.report()
    """

    def __init__(self, writer=None):
        self.writer = writer
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages.append((name, dt))
            if self.writer is not None:
                self.writer.scalar(f"stage_seconds/{name}", dt, step=len(self.stages))

    def report(self) -> str:
        lines = [f"{name}: {dt:.3f}s" for name, dt in self.stages]
        out = "\n".join(lines)
        print(out)
        return out
