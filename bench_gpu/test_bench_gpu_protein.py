"""The cell of MC-41 scoring of ragged proteins, small on the CPU: a sound
run reads ``correct``, faults of the ragged path put in the program's place
make it false, and ``score_padded_share`` reads None untraced and a number
traced. The small configuration keeps the cell's alphabet, CNN widths and
limits, with 400 proteins of 5-80 residues, lag 3 (so that most held-out
contexts were counted, and a fault in the counts shows) and 5 samples."""

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

CELL = "proteome6_score_mc41"


def config():
    cfg = copy.deepcopy(harness.load_json(harness.BENCH, "configs", "proteome_lag6_cnn.json"))
    cfg["lag"] = 3
    cfg["proteome"].update(families=40, members=10, median_len=30, min_len=5, max_len=80,
                           chunk_rows=64)
    return cfg


def spec():
    s = copy.deepcopy(harness.load_json(harness.BENCH, "cells", f"{CELL}.json"))
    s["params"].update(seqs_per_call=16, mc_samples=5)
    return s


def run(trace=False, seed=2**31 + 11):
    kind = "per_layer" if trace else "end_to_end"
    profiling.clear()
    try:
        return harness.execute(CELL, spec(), config(),
                               harness.cell_metrics(tiny_cells.bench(), CELL, kind), seed, 0.3,
                               trace, "cpu", time.perf_counter())
    finally:
        profiling.clear()


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_sound_small_run_is_correct(trace):
    line = run(trace)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(spec()["limits"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(tiny_cells.bench(), CELL, kind)
            if trace or m["source"] == "host_clock"}
    if trace:  # on the CPU no kernel runs, and the rooflines read nothing
        want -= {"cnn_forward_roofline", "keyed_draw_roofline"}
    assert set(line["metrics"]) == want


def _faulty_rows(fault):
    """``serving._context_rows_and_next`` with one fault of the ragged path."""
    from bear_tpu_torch.inference import serving

    original = serving._context_rows_and_next

    def rows_and_next(codes, lengths, lag, A=4):
        rows, nxt, mask = original(codes, lengths, lag, A)
        j = torch.arange(mask.shape[1], device=mask.device)[None, :]
        lengths = lengths.to(j.dtype)[:, None]
        if fault == "padded_position_summed":  # the position after the stop, a padding one
            return rows, nxt, mask | (j == lengths + 1)
        top = lengths.max()  # "stop_at_maxlen": every stop at the call's longest length
        rows_top, nxt_top, _ = original(codes, torch.full_like(lengths[:, 0], int(top)), lag, A)
        stop = j == top
        return (torch.where(stop, rows_top, rows), torch.where(stop, nxt_top, nxt),
                (j < lengths) | stop)

    return rows_and_next


def _sampled_multi(key_on):
    """``BearServer.log_prob_sampled_multi`` with each draw keyed on the
    transition's context row (``key_on`` "row", as the program keys it) or
    on its index in the padded [B, L + 1] matrix ("padded_index")."""
    from bear_tpu_torch.inference import serving
    from bear_tpu_torch.ops import keyed_random as kr

    def sampled_multi(self, codes, lengths, keys):
        codes = torch.as_tensor(codes, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        keys = kr._as_keys(keys, self.device).reshape(-1)
        rows, nxt, mask = serving._context_rows_and_next(codes, lengths, self.lag, self._A)
        b_idx, p_idx = mask.nonzero(as_tuple=True)
        rv, nv = rows[b_idx, p_idx], nxt[b_idx, p_idx]
        conc = self._row_concentrations(rv)
        seq = torch.arange(codes.shape[0], dtype=torch.int64, device=self.device)
        seq_keys = kr.fold_in(keys[:, None], seq[None, :])
        key_rows = rv if key_on == "row" else b_idx * mask.shape[1] + p_idx
        picked = self._draw_picked(seq_keys, b_idx, key_rows, nv, conc)
        full = picked.new_zeros((keys.shape[0],) + tuple(mask.shape))
        full[:, b_idx, p_idx] = picked
        return full.sum(dim=-1).T

    return sampled_multi


@pytest.mark.parametrize("fault", ["half_the_counts", "padded_position_summed",
                                   "stop_at_maxlen", "draws_keyed_on_padded_index"])
def test_ragged_path_faults_come_out_incorrect(monkeypatch, fault):
    from bear_tpu_torch.inference import serving

    if fault == "half_the_counts":
        original = serving.BearServer._gather
        monkeypatch.setattr(serving.BearServer, "_gather",
                            lambda self, rows: original(self, rows) * 0.5)
    elif fault == "draws_keyed_on_padded_index":
        monkeypatch.setattr(serving.BearServer, "log_prob_sampled_multi",
                            _sampled_multi("padded_index"))
    else:
        monkeypatch.setattr(serving, "_context_rows_and_next", _faulty_rows(fault))
    line = run()
    assert line["correct"] is False, line["checks"]


def test_the_sound_copy_of_the_sampled_path_passes(monkeypatch):
    """The fault's copy of ``log_prob_sampled_multi``, keyed on the row as
    the program keys it, reads ``correct``: only the key is at fault."""
    from bear_tpu_torch.inference import serving

    monkeypatch.setattr(serving.BearServer, "log_prob_sampled_multi", _sampled_multi("row"))
    line = run()
    assert line["correct"] is True, line["checks"]


def test_padded_share_reads_none_untraced_a_number_traced_and_none_without_the_counter(
        monkeypatch):
    read = harness.load_module("metrics", "score_padded_share").read
    traced = run(trace=True)
    share = traced["metrics"]["score_padded_share"]["value"]
    assert 0 < share < 100
    untraced = harness.Run(CELL, config(), spec()["params"], 1, torch.device("cpu"))
    untraced.work["windows"] = 10.0
    assert read(untraced) is None
    from types import SimpleNamespace

    from bear_tpu_torch.inference import serving

    monkeypatch.delattr(serving, "padded_positions")
    assert read(SimpleNamespace(trace=object(), work={"windows": 10.0})) is None


@pytest.mark.cuda
def test_the_control_fails_the_cells_check():
    """On the card, at the cell's own size: the plain reference with its
    products in TF32, put in the program's place, fails at least one of
    the cell's limits, and the program passes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "calibrate_protein.py"),
                          CELL, str(2**31 + 101), "--calls", "2"],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = spec()["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
