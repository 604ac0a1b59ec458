"""Small versions of the benchmark's cells, for its tests on the CPU: the
same drivers and checks at sizes a test run holds (a 20 kb genome of
30-letter reads at lag 6, a narrow CNN, few samples), with the cells' own
limits."""

from __future__ import annotations

import copy

from bench_gpu import harness

CELLS = ("genome13_train", "ysd1_train", "genome13_score_mc41", "genome13_count")


def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def config(cell: str) -> dict:
    name = harness.load_json(harness.BENCH, "cells", f"{cell}.json")["config"]
    cfg = copy.deepcopy(harness.load_json(harness.BENCH, "configs", f"{name}.json"))
    if "genome" in cfg:
        cfg["lag"] = 6
        cfg["genome"].update(genome_mb=0.02, coverage=2, read_len=30, chunk_rows=64,
                             template_len=2000)
        cfg["model"].update(filter_width=3, num_filters=8, kmer_layer1_width=4, batch_size=64)
    return cfg


def spec(cell: str) -> dict:
    s = copy.deepcopy(harness.load_json(harness.BENCH, "cells", f"{cell}.json"))
    small = {"genome13_score_mc41": dict(seqs_per_call=16, mc_samples=5),
             "ysd1_train": dict(epochs_per_call=5),
             "genome13_count": dict(kept_choices=1)}
    s["params"].update(small.get(cell, {}))
    return s


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False) -> dict:
    """One run of the small cell on the CPU: the result line."""
    import time

    kind = "per_layer" if trace else "end_to_end"
    return harness.execute(cell, spec(cell), config(cell),
                           harness.cell_metrics(bench(), cell, kind), seed, seconds, trace,
                           "cpu", time.perf_counter())
