"""Whole runs of the small cells on the CPU: the result line's keys, the
refusal without a card, and ``correct`` coming out false when the timed
path is broken underneath (each fault a cell can have)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_gpu import harness, tiny_cells

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", tiny_cells.CELLS)
def test_result_line_of_a_sound_run(cell):
    line = tiny_cells.run(cell)
    assert list(line) == KEYS, "the checks come last"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    e2e = harness.cell_metrics(tiny_cells.bench(), cell, "end_to_end")
    # On the CPU a reading of the device (its memory) has nothing to read.
    assert set(line["metrics"]) == {m["name"] for m in e2e if m["source"] == "host_clock"}
    assert set(line["checks"]) == set(tiny_cells.spec(cell)["limits"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    traced = tiny_cells.run(cell, trace=True)
    assert list(traced) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
                          "genome13_count", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.parametrize("cell", ["genome13_train", "ysd1_train"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_faults_come_out_incorrect(monkeypatch, cell, fault):
    from bear_tpu_torch.models import bear_net

    if fault == "unchanged_state":
        step = bear_net._apply

        def unchanged(optimizer, losses, sync=None):
            params = optimizer.param_groups[0]["params"]
            before = [p.detach().clone() for p in params]
            loss = step(optimizer, losses, sync)
            with torch.no_grad():  # the step's parameters are thrown away
                for p, b in zip(params, before):
                    p.copy_(b)
            return loss

        monkeypatch.setattr(bear_net, "_apply", unchanged)
    else:
        original = bear_net._batch_loss

        def half(params, ar_func, train_ar, codes_b, counts_b, scale, ref_b=None):
            h = codes_b.shape[0] // 2  # the first half's rows, the mean taken over them
            return 2 * original(params, ar_func, train_ar, codes_b[:h], counts_b[:h], scale,
                                ref_b)

        monkeypatch.setattr(bear_net, "_batch_loss", half)
    line = tiny_cells.run(cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["partial_scale", "stacking"])
def test_window_call_faults_come_out_incorrect(monkeypatch, fault):
    """Faults that only a call over the whole set has (its last batch
    partial, later batches at later indices), which the first three
    applies, each a call on one full batch, cannot show."""
    from bear_tpu_torch.models import bear_net

    original = bear_net._stack_batches

    def broken(codes, counts, batch_size, pad_multiple=1):
        codes_s, counts_s, sizes = original(codes, counts, batch_size, pad_multiple)
        if fault == "partial_scale":
            sizes = np.full_like(sizes, sizes[0])  # the partial batch scaled as a full one
        else:
            codes_s, counts_s = codes_s.clone(), counts_s.clone()
            codes_s[1:], counts_s[1:] = codes_s[0], counts_s[0]  # every step batch 0
        return codes_s, counts_s, sizes

    monkeypatch.setattr(bear_net, "_stack_batches", broken)
    line = tiny_cells.run("genome13_train")
    assert line["correct"] is False, line["checks"]
    assert all(line["checks"][k]["value"] <= line["checks"][k]["limit"]
               for k in ("loss_gap", "grad_gap", "change_gap")), "only the call shows it"


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer", "one_read"])
def test_scoring_faults_come_out_incorrect(monkeypatch, fault):
    from bear_tpu_torch.inference import serving

    if fault in ("half_batch", "one_read"):
        original = serving.BearServer.log_prob_sampled_multi

        def broken(self, codes, lengths, keys):
            out = original(self, codes, lengths, keys)
            if fault == "half_batch":
                out[out.shape[0] // 2:] = 0.0
            else:  # one read of the call, under the 75th percentile
                out[0] += 0.5
            return out

        monkeypatch.setattr(serving.BearServer, "log_prob_sampled_multi", broken)
    else:
        original = serving.keyed_draw_picked

        def altered(*args, **kwargs):
            out = original(*args, **kwargs)
            out[0] += 0.5  # sample 0's picked log-probs, where the draws produce them
            return out

        monkeypatch.setattr(serving, "keyed_draw_picked", altered)
    line = tiny_cells.run("genome13_score_mc41")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_counting_faults_come_out_incorrect(monkeypatch, fault):
    from bear_tpu_torch.counting import engine

    original = engine.count_chunk_update

    def broken(table, codes, meta, *args, **kwargs):
        if fault == "half_batch":
            meta = meta.clone()
            meta[meta.shape[0] // 2:, 0] = 0  # the second half's reads left out
            meta[meta.shape[0] // 2:, 3] = 0
        out = original(table, codes, meta, *args, **kwargs)
        if fault == "altered_answer":
            table[7] += 1
        return out

    monkeypatch.setattr(engine, "count_chunk_update", broken)
    line = tiny_cells.run("genome13_count")
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny_cells.CELLS)
def test_the_control_fails_the_cells_check(cell):
    """On the card, at the cell's own size: the plain reference in the
    precision below the configuration's, put in the program's place, fails
    at least one of the cell's limits (calibrate.py's readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "calibrate.py"), cell,
                          str(2**31 + 101), "--calls", "2"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = tiny_cells.spec(cell)["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
