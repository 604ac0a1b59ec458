"""The cells of scoring over a sparse count map (lag 20) and of the SNV scan
(lag 13; built, and kept out of BENCHMARK.json while its runs spread), small
on the CPU: a sound run reads ``correct``, faults of the
sparse and Δ paths put in the program's place make it false, and the
lookup's metrics read None untraced. The small configurations keep each
cell's lag-20 or Δ path, its limits and its keying, with a 20 kb genome of
50-letter reads at coverage 4, a narrow CNN and 5 samples; the SNV cell
runs at lag 6 (as ``tiny_cells``) over the 600 SNVs of 200 letters."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_gpu import harness, tiny_cells
from bear_tpu_torch.utils import profiling

SPARSE, SNV = "genome20_score_mc41", "genome13_snv_mc41"


def config(cell):
    name = harness.load_json(harness.BENCH, "cells", f"{cell}.json")["config"]
    cfg = copy.deepcopy(harness.load_json(harness.BENCH, "configs", f"{name}.json"))
    if cell == SNV:
        cfg["lag"] = 6
    cfg["genome"].update(genome_mb=0.02, coverage=4, read_len=50, chunk_rows=64,
                         template_len=2000)
    cfg["model"].update(filter_width=3, num_filters=8, kmer_layer1_width=4)
    return cfg


def spec(cell):
    s = copy.deepcopy(harness.load_json(harness.BENCH, "cells", f"{cell}.json"))
    s["params"].update(seqs_per_call=16 if cell == SPARSE else 600, mc_samples=5)
    return s


def run(cell, trace=False, seed=2**31 + 11):
    kind = "per_layer" if trace else "end_to_end"
    profiling.clear()
    try:
        return harness.execute(cell, spec(cell), config(cell),
                               harness.cell_metrics(tiny_cells.bench(), cell, kind), seed, 0.3,
                               trace, "cpu", time.perf_counter())
    finally:
        profiling.clear()


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", [SPARSE, SNV])
def test_a_sound_small_run_is_correct(cell, trace):
    line = run(cell, trace)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(spec(cell)["limits"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(tiny_cells.bench(), cell, kind)
            if trace or m["source"] == "host_clock"}
    if trace:  # on the CPU no kernel runs, and the rooflines and the search read nothing
        want -= {"cnn_forward_roofline", "keyed_draw_roofline",
                 "score_lookup_device_ms_per_call"}
    assert set(line["metrics"]) == want


def test_the_lookup_metrics_read_none_untraced_and_without_lookups():
    from types import SimpleNamespace

    untraced = harness.Run(SPARSE, config(SPARSE), spec(SPARSE)["params"], 1,
                           torch.device("cpu"))
    untraced.latencies = [0.1]
    traced_dense = SimpleNamespace(trace=harness.TraceSummary(1.0, 1.0, {"k": 1.0}, {}),
                                   latencies=[0.1])
    for name in ("score_lookup_ms_per_call", "score_lookup_device_ms_per_call"):
        read = harness.load_module("metrics", name).read
        assert read(untraced) is None
        assert read(traced_dense) is None  # no lookup span recorded, no search kernel
    read = harness.load_module("metrics", "score_lookup_device_ms_per_call").read
    searched = SimpleNamespace(trace=harness.TraceSummary(
        1.0, 1.0, {"void at::native::searchsorted_cuda_kernel<long, long>": 0.004}, {}),
        latencies=[0.1, 0.1])
    assert read(searched) == pytest.approx(2.0)


def _int32_rows(monkeypatch):
    """Rows worked out in int32: each wraps modulo 2^32, as int32 arithmetic
    would."""
    from bear_tpu_torch.inference import serving

    original = serving._context_rows_and_next

    def rows_and_next(codes, lengths, lag, A=4):
        rows, nxt, mask = original(codes, lengths, lag, A)
        return rows.to(torch.int32).to(rows.dtype), nxt, mask

    monkeypatch.setattr(serving, "_context_rows_and_next", rows_and_next)


def _neighbours_counts(monkeypatch):
    """The lookup without its hit test: a miss reads the counts of the map's
    row at its slot."""
    from bear_tpu_torch.inference import serving

    def gather(rows_sorted, counts, rows):
        slot = torch.searchsorted(rows_sorted, rows.to(torch.int64))
        return counts[slot.clamp_max(rows_sorted.numel() - 1)]

    monkeypatch.setattr(serving, "sparse_gather", gather)


def _slot_keys(monkeypatch):
    """Draws keyed on the row's slot in the map in place of the row."""
    from bear_tpu_torch.inference import serving

    original = serving.BearServer._draw_picked

    def draw(self, base_keys, group, rows, nxt, conc):
        slot = torch.searchsorted(self._sparse[0], rows.to(torch.int64))
        return original(self, base_keys, group, slot, nxt, conc)

    monkeypatch.setattr(serving.BearServer, "_draw_picked", draw)


def _half_counts(monkeypatch):
    from bear_tpu_torch.inference import serving

    original = serving.BearServer._gather
    monkeypatch.setattr(serving.BearServer, "_gather",
                        lambda self, rows: original(self, rows) * 0.5)


def _wrong_power(monkeypatch):
    """The mutant's context rows shifted by A^(i - 2) where A^(i - 1) is
    right (window i >= 2 of a substitution), kept inside the table."""
    from bear_tpu_torch.counting import table_rows
    from bear_tpu_torch.inference import serving

    original = serving.BearServer._delta

    def delta(self, mt, wt, keys):
        (r_mt, n_mt, m_mt), (r_wt, _, _) = mt, wt
        i = torch.arange(r_mt.shape[1], device=r_mt.device)[None, :]
        wrong = torch.where(i >= 2, r_wt + torch.div(r_mt - r_wt, self._A, rounding_mode="floor"),
                            r_mt) % table_rows(self.lag, self._A)
        return original(self, (wrong, n_mt, m_mt), wt, keys)

    monkeypatch.setattr(serving.BearServer, "_delta", delta)


FAULTS = {
    "int32_rows": (SPARSE, _int32_rows),
    "miss_reads_its_neighbour": (SPARSE, _neighbours_counts),
    "draws_keyed_on_the_slot": (SPARSE, _slot_keys),
    "half_the_counts": (SPARSE, _half_counts),
    "half_the_counts_snv": (SNV, _half_counts),
    "mutant_row_wrong_power": (SNV, _wrong_power),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_incorrect(monkeypatch, fault):
    cell, put_in = FAULTS[fault]
    put_in(monkeypatch)
    line = run(cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [SPARSE, SNV])
def test_the_control_fails_the_cells_check(cell):
    """On the card, at the cell's own size: the plain reference with its
    products in TF32, put in the program's place, fails at least one of
    the cell's limits, and the program passes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "calibrate_sparse.py"),
                          cell, str(2**31 + 101), "--calls", "2"],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = spec(cell)["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
