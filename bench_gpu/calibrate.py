"""Readings that the check's limits are set from, for one cell over many
seeds in one process (not part of a benchmark run):

- ``program``: the numbers the check compares, as a run reads them (set-up,
  ``calls`` timed calls, the check);
- ``control``: the plain reference put in the program's place, in the
  nearest precision below the configuration's (TF32 for float32 with TF32
  off), against the reference;
- for a training cell, ``half_batch``: the reference in the program's place
  with half of each batch's rows left out and the mean taken over the rest;
- for a scoring cell, the widest gaps and the share of reads over each of
  ``SHARES_OVER``, of the program and of the control;
- for the counting cell the control counts in int16 (counts wrap past
  32,767), the type below the configuration's exact int32 counts.

    python3 bench_gpu/calibrate.py <cell> <seed> [<seed> ...] [--calls N]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_gpu import harness  # noqa: E402
from bench_gpu.reference import counts as ref_counts  # noqa: E402


def train_readings(run, driver, calls):
    from bench_gpu.traffic import train

    driver.warmup()
    out = {"program": driver.check()}
    want = driver.reference()
    ctrl = driver.reference(dtype=torch.float32, tf32=True)
    out["control"] = train.readings(ctrl, want, driver.params0)
    half = driver.reference(dtype=torch.float32, half=True)
    out["half_batch"] = train.readings(half, want, driver.params0)
    return out


SHARES_OVER = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4)


def score_readings(run, driver, calls):
    from bench_gpu.traffic import score

    driver.warmup()
    for _ in range(calls):
        driver.step()
    driver.release()
    out = {"program": driver.check()}
    idx = driver.checked_calls()
    want = [driver.reference_scores(i) for i in idx]
    got = [driver.outputs[i] for i in idx]
    ctrl = [driver.reference_scores(i, tf32=True) for i in idx]
    out["control"] = score.readings(ctrl, want, run.params["share_over"])
    out["widest"] = {"program": [float(g.max()) for g in score.gaps(got, want)],
                     "control": [float(g.max()) for g in score.gaps(ctrl, want)]}
    out["shares_over"] = {
        side: {str(t): float(np.mean(score.gaps(g, want)[0] > t)) for t in SHARES_OVER}
        for side, g in (("program", got), ("control", ctrl))}
    return out


def count_readings(run, driver, calls):
    from bench_gpu.traffic import count

    for _ in range(max(calls, run.params["kept_choices"])):  # the drawn pass runs
        driver.step()
    out = {"program": driver.check()}
    cfg, dev = run.config, run.device
    keys, n = ref_counts.count_keys(torch.as_tensor(driver.reads, device=dev),
                                    torch.as_tensor(driver.groups, device=dev),
                                    cfg["lag"], cfg["n_groups"])
    table = torch.zeros(ref_counts.n_rows(cfg["lag"]) * cfg["n_groups"] * 5,
                        dtype=torch.int16, device=dev)
    table[keys] = n.to(torch.int16)  # wraps past 32,767
    out["control"] = {"mismatches": count.mismatches(table, keys, n)}
    out["max_count"] = int(n.max())
    return out


READINGS = {"train": train_readings, "score": score_readings, "count": count_readings}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args()
    spec = harness.load_json(harness.BENCH, "cells", f"{args.cell}.json")
    config = harness.load_json(harness.BENCH, "configs", f"{spec['config']}.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(args.cell, config, spec["params"], seed, torch.device("cuda"),
                          t_start=t0)
        driver = run.driver = harness.load_module("traffic", spec["driver"]).setup(run)
        line = READINGS[spec["driver"]](run, driver, args.calls)
        line.update(cell=args.cell, seed=seed, seconds=time.perf_counter() - t0,
                    memory_peak_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(line), flush=True)
        del driver, run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
