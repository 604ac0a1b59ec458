"""Profiling hooks (port of bear_tpu/utils/profiling.py).

``trace`` records the enclosed block with ``torch.profiler`` (the CPU, and
the card's kernels and copies when one is present) and writes a Chrome
trace into ``out_dir`` (viewable in Perfetto or chrome://tracing).

``span`` marks a layer boundary of the program. With no profiler running
it records nothing. While a ``torch.profiler`` profile is open it enters a
``record_function`` of its name, so the span lands in the profiler's host
timeline (the clock the device trace is aligned to), and it keeps a
:class:`SpanRecord` in memory: ``recorded`` returns them, ``clear`` drops
them, and ``trace`` clears them on entry. The program's span names start
with ``bear.``.

``StageTimer`` is named wall-clock stage timing that lands in the same
scalars.jsonl stream as training metrics; each stage is a span and ends
when the card has finished its work.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from array import array
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.autograd import _profiler_enabled


@dataclass(slots=True)
class SpanRecord:
    """One span of a profiled block: host times from
    ``time.perf_counter_ns``, ``end_ns`` None while the span is open;
    ``parent`` the index in :func:`recorded` of the enclosing span of the
    same thread (None for an outermost span), ``root`` that of the
    outermost one (its own index for an outermost span)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    root: int


# The records are kept flat, so that a span leaves no object behind for the
# garbage collector: objects kept per span set off collections, and under
# the profiler a collection in the middle of a training call costs tenths
# of a second. Span i is _names[i], _times[2i:2i+2] (start, end; -1 while
# open) and _links[2i:2i+2] (parent, -1 for none; root). clear() starts a
# new generation, so that a span open across it is dropped, not misfiled.
_names: List[str] = []
_times = array("q")
_links = array("q")
_generation = 0
_lock = threading.Lock()
_open = threading.local()  # .stack: (generation, index) of this thread's open spans


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_rf", "_at")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The record's times enclose the profiler's event of the same name.
        self._rf = torch.profiler.record_function(self.name)
        start = time.perf_counter_ns()
        self._rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        with _lock:
            index = len(_names)
            parent = stack[-1][1] if stack and stack[-1][0] == _generation else -1
            _names.append(self.name)
            _times.append(start)
            _times.append(-1)
            _links.append(parent)
            _links.append(index if parent < 0 else _links[2 * parent + 1])
            self._at = (_generation, index)
        stack.append(self._at)
        return None

    def __exit__(self, *exc):
        _open.stack.pop()
        self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        with _lock:
            if self._at[0] == _generation:
                _times[2 * self._at[1] + 1] = end
        return False


def span(name: str):
    """A context manager that marks the enclosed block as the span
    ``name``: nothing while no profiler runs, else a ``record_function``
    of that name and a record in :func:`recorded`."""
    return _Span(name) if _profiler_enabled() else _OFF


def recorded() -> List[SpanRecord]:
    """The spans recorded since the last :func:`clear`, in the order they
    were entered."""
    out = []
    with _lock:
        for i, name in enumerate(_names):
            start, end = _times[2 * i : 2 * i + 2]
            parent, root = _links[2 * i : 2 * i + 2]
            out.append(SpanRecord(name, start, None if end < 0 else end,
                                  None if parent < 0 else parent, root))
    return out


def clear() -> None:
    """Drop the recorded spans; a span open meanwhile is dropped too."""
    global _generation
    with _lock:
        _names.clear()
        del _times[:], _links[:]
        _generation += 1


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the enclosed block; on exit write ``out_dir/trace.json``.
    Yields the ``torch.profiler.profile`` object (``key_averages()`` etc.).
    The block's spans are in :func:`recorded` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class StageTimer:
    """Named wall-clock stage timing, optionally teed to a MetricsWriter.
    A stage is a :func:`span` of its name, and ends with a
    ``torch.cuda.synchronize()`` once CUDA is in use, so that it times the
    card's work and not only its enqueue.

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
            with span(name):
                try:
                    yield
                finally:
                    if torch.cuda.is_initialized():
                        torch.cuda.synchronize()
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
