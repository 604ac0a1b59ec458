"""Device time under each of the program's spans, for one cell (not part
of a benchmark run): the cell's driver is set up and warmed up as a run
does it, then ``--calls`` timed calls run under ``torch.profiler``. Each
kernel, copy or set on the card counts under every ``bear.*`` span that was
open on the host when its launch was made (the launch and the device event
share a correlation id); the union of all of them is the card's busy time.

    python3 bench_gpu/span_device_time.py <cell> <seed> [--calls N]

Prints one JSON line: ``busy_ms`` and ``window_ms`` per call, and by span
its device ms per call and share of the busy time (the device time of a
span includes its inner spans'; ``(none)`` is work launched outside any).
A kernel launched through ctypes counts as any other: its launch is a
runtime call on the host.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bench_gpu import harness  # noqa: E402


def device_ms_by_span(prof, prefix="bear."):
    """({span: device ns of the work launched inside it, inner spans'
    included}, busy ns, window ns) of a profile with a ``bench.window``
    annotation."""
    from torch.autograd import DeviceType

    spans, launches, device = [], {}, []
    window = None
    for e in prof.profiler.kineto_results.events():
        start = harness._ns(e, "start")
        end = start + harness._ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id()))
        elif e.name() == "bench.window":
            window = (start, end)
        elif e.name().startswith(prefix):
            spans.append((start, end, e.name()))
        elif e.correlation_id():
            launches[e.correlation_id()] = start
    spans.sort()
    starts = [s[0] for s in spans]
    by_span = defaultdict(int)
    merged = []
    for s, t, corr in sorted(device):
        at = launches.get(corr)
        names = set()
        if at is not None:
            i = bisect.bisect_right(starts, at)
            names = {n for s0, t0, n in spans[max(0, i - 256):i] if t0 >= at}
        for n in names or ("(none)",):
            by_span[n] += t - s
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    return dict(by_span), busy, (window[1] - window[0]) if window else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == args.cell)
    spec = harness.load_json(harness.BENCH, "cells", f"{args.cell}.json")
    config = harness.load_json(harness.BENCH, "configs", f"{entry['config']}.json")
    if not torch.cuda.is_available():
        sys.exit("span_device_time.py measures the card: no CUDA card found")
    dev = torch.device("cuda")
    run = harness.Run(args.cell, config, spec["params"], args.seed, dev,
                      t_start=time.perf_counter())
    driver = harness.load_module("traffic", spec["driver"]).setup(run)
    driver.warmup()
    harness._sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            for _ in range(args.calls):
                driver.step()
            harness._sync(dev)
    by_span, busy, window = device_ms_by_span(prof)
    calls = args.calls
    print(json.dumps({
        "cell": args.cell, "seed": args.seed, "calls": calls,
        "device": torch.cuda.get_device_name(dev),
        "busy_ms": busy / 1e6 / calls, "window_ms": window / 1e6 / calls,
        "spans": {n: {"device_ms": v / 1e6 / calls, "share_of_busy": v / busy if busy else None}
                  for n, v in sorted(by_span.items(), key=lambda kv: -kv[1])}}))


if __name__ == "__main__":
    main()
