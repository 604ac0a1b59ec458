"""One run of one benchmark cell: set-up, a measured window, the metrics,
and the check of what the window produced.

Everything a cell needs is found by name (the benchmark's files, none of
which this module names):

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  the metrics it reports, each with its unit and, where given, its cells;
- ``bench_gpu/cells/<cell>.json``: the traffic driver, its parameters, and
  the limit of each number the check compares;
- ``bench_gpu/configs/<config>.json``: the configuration's sizes;
- ``bench_gpu/traffic/<driver>.py``: ``setup(run)`` returns an object with
  ``warmup()``, ``step()`` (one timed call, finished on the device when it
  returns), ``release()`` (drops the program's state that the check does
  not read) and ``check()`` ({number: value} of the comparison with the
  plain reference);
- ``bench_gpu/metrics/<metric>.py``: ``read(run)`` gives the metric's value,
  or None where it finds nothing to read.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "bear_tpu")


def load_module(kind: str, name: str):
    """``bench_gpu/<kind>/<name>.py`` as a module."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_gpu_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str):
    """The ``kind`` metrics ("end_to_end" or "per_layer") a cell reports: a
    metric with ``workloads`` in the cells it lists, else (end to end) in
    every cell, or (per layer) in every cell that reports the end-to-end
    metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_loaded(modules=None):
    """Top-level names of loaded modules that the benchmark may not load."""
    names = {m.split(".")[0] for m in (modules if modules is not None else list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


@dataclass
class Run:
    """What a driver and the metric readers share."""

    cell: str
    config: dict
    params: dict
    seed: int
    device: torch.device
    work: dict = field(default_factory=lambda: defaultdict(float))
    spans: dict = field(default_factory=lambda: defaultdict(list))
    latencies: list = field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    trace: "TraceSummary | None" = None
    driver: object = None
    t_start: float = 0.0
    marks: list = field(default_factory=list)

    def mark(self, name: str):
        """Note the seconds since the process started, at the end of a
        stage of set-up."""
        self.marks.append((name, time.perf_counter() - self.t_start))

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of the enclosed block, kept under ``name``; a profiler
        annotation of the same name in a traced run."""
        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans[name].append(time.perf_counter() - t0)


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernel_s: dict  # device seconds by operation name
    idle_by_host: dict  # idle device seconds by what the host was doing

    def kernel_seconds(self, name: str) -> float:
        return sum(s for k, s in self.kernel_s.items() if name in k)


def _ns(e, which):
    fn = getattr(e, f"{which}_ns", None)
    return fn() if fn is not None else getattr(e, f"{which}_us")() * 1000


ANNOTATION_PREFIXES = ("bench.", "Optimizer.")
OUTSIDE_OPS = "host Python outside torch ops"


def _innermost(events, t, back: int):
    """The name of the shortest of the ``back`` events (sorted by start)
    that start last before ``t`` and span it, or None."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    inside = [e for e in events[max(0, i - back):i] if e[1] >= t]
    return min(inside, key=lambda e: e[1] - e[0])[2] if inside else None


def summarize_trace(prof) -> TraceSummary:
    """Device busy time (the union of kernels, copies and sets), device
    seconds by name, and the idle time inside the ``bench.window``
    annotation by what the host was doing at each gap's middle: the
    innermost of the host events that started just before, else of the
    benchmark's and the optimizer's annotations, else Python outside any
    torch op."""
    from torch.autograd import DeviceType

    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((start, end, e.name()))
        else:
            if e.name() == "bench.window":
                window = (start, end)
            host.append((start, end, e.name()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window annotation")
    w0, w1 = window
    kernel_s = defaultdict(float)
    merged = []
    for s, t, name in sorted(dev):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        kernel_s[name] += (t - s) / 1e9
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    host.sort()
    annotations = [h for h in host if h[2].startswith(ANNOTATION_PREFIXES)
                   and h[2] != "bench.window"]
    idle = defaultdict(float)
    for length, s in gaps:
        mid = s + length // 2
        label = (_innermost(host, mid, 32) or _innermost(annotations, mid, 64)
                 or OUTSIDE_OPS)
        idle[label] += length / 1e9
    return TraceSummary(busy / 1e9, (w1 - w0) / 1e9, dict(kernel_s), dict(idle))


def _top(d: dict, n: int = 10):
    """The n largest entries, names cut to 160 characters."""
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of ``cell`` as the benchmark's files define it; returns the
    result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    spec = load_json(BENCH, "cells", f"{cell}.json")
    config = load_json(BENCH, "configs", f"{entry['config']}.json")
    kind = "per_layer" if trace else "end_to_end"
    return execute(cell, spec, config, cell_metrics(bench, cell, kind), seed, seconds, trace,
                   device, t_start)


def execute(cell: str, spec: dict, config: dict, metric_list, seed: int, seconds: float,
            trace: bool, device, t_start: float) -> dict:
    """Set up the cell's driver, measure a window of ``seconds`` (in a
    traced run at most the cell's ``trace_seconds``, under the profiler),
    read ``metric_list``, then check what the window produced."""
    dev = torch.device(device)
    run = Run(cell, config, spec["params"], seed, dev, t_start=t_start)
    run.mark("imports")
    driver = run.driver = load_module("traffic", spec["driver"]).setup(run)
    run.mark("driver set-up")
    driver.warmup()
    _sync(dev)
    run.mark("warm-up")
    run.setup_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(f"{name} {t:.3f} s" for name, t in run.marks), file=sys.stderr)

    window = min(seconds, spec["params"].get("trace_seconds", seconds)) if trace else seconds
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                driver.step()
                run.latencies.append(time.perf_counter() - t)
                if time.perf_counter() - t0 >= window:
                    break
            _sync(dev)
            run.window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    breakdown = None
    if prof is not None:
        run.trace = summarize_trace(prof)
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = {"device_ops": _top(run.trace.kernel_s),
                     "idle_gaps": _top(run.trace.idle_by_host)}
        del prof
    metrics = {}
    for m in metric_list:
        value = load_module("metrics", m["name"]).read(run)
        if value is None and not trace and (dev.type == "cuda" or m["source"] == "host_clock"):
            # Off the card only a reading of the device (its memory) may be missing.
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.release()
    _sync(dev)
    readings = driver.check()
    limits = spec["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    correct = set(checks) == set(limits) and all(c["value"] <= c["limit"]
                                                 for c in checks.values())
    line = {"correct": correct, "attempted": len(run.latencies), "failed": 0,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
