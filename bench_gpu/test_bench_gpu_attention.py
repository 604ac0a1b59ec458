"""The cells of the attention AR's MC-41 scoring and of MAP scoring, small on
the CPU: sound runs read ``correct``, faults put in the program's place make
it false, and their metric readers read None untraced and a number traced.
The small attention configuration keeps the genome of ``tiny_cells`` and
the published head count at width 16 (4 heads of 4, an MLP of 32)."""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_gpu import harness, tiny_cells
from bear_tpu_torch.utils import profiling

ATTN, MAP = "genome13_attn_score_mc41", "genome13_score_map"
NEW_METRICS = ("attn_score_call_mfu", "attn_ar_host_ms_per_call", "attn_rows_per_window")


def config(cell):
    cfg = tiny_cells.config(cell)
    if cfg["model"]["ar_func"] == "attention":
        cfg["model"] = {**{k: v for k, v in cfg["model"].items()
                           if k not in ("filter_width", "num_filters", "kmer_layer1_width",
                                        "batch_size")},
                        "d_model": 16, "num_heads": 4, "mlp_width": 32}
    return cfg


def spec(cell):
    s = copy.deepcopy(harness.load_json(harness.BENCH, "cells", f"{cell}.json"))
    s["params"].update(seqs_per_call=16)
    if "mc_samples" in s["params"]:
        s["params"].update(mc_samples=5)
    return s


def run(cell, trace=False, seed=2**31 + 11):
    kind = "per_layer" if trace else "end_to_end"
    return harness.execute(cell, spec(cell), config(cell),
                           harness.cell_metrics(tiny_cells.bench(), cell, kind), seed, 0.3,
                           trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", [ATTN, MAP])
def test_a_sound_small_run_is_correct(cell, trace):
    profiling.clear()
    try:
        line = run(cell, trace)
    finally:
        profiling.clear()
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(spec(cell)["limits"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(tiny_cells.bench(), cell, kind)
            if trace or m["source"] == "host_clock"}
    if trace:  # on the CPU no kernel runs, and the roofline reads nothing
        want -= {"cnn_forward_roofline", "keyed_draw_roofline"}
    assert set(line["metrics"]) == want
    if trace and cell == ATTN:
        assert line["metrics"]["attn_rows_per_window"]["value"] == 1.0
        assert line["metrics"]["attn_ar_host_ms_per_call"]["value"] > 0
        assert line["metrics"]["attn_score_call_mfu"]["value"] > 0


def _block_with(fault):
    """AttentionAR._block with one fault (its arithmetic otherwise as the
    program's)."""
    from bear_tpu_torch.models.ar_funcs import _normalize_layer

    def block(self, params, oh, lead, out_dt):
        embed, pos, wqkv, wo, w1, b1, w2, b2, w_out, b_out = params
        n, H, dh = oh.shape[0], self.num_heads, self.d_head
        x = oh @ embed + (0 if fault == "no_pos" else pos)
        h = _normalize_layer(x)
        q = (h[:, -1] @ wqkv[0]).reshape(n, H, dh)
        k = (h @ wqkv[1]).reshape(n, self.lag, H, dh)
        v = (h @ wqkv[2]).reshape(n, self.lag, H, dh)
        scale = 1.0 / math.sqrt(self.d_model if fault == "scale_by_d_model" else dh)
        att = torch.softmax(torch.einsum("nhd,nkhd->nhk", q, k) * scale, dim=-1)
        ctx = torch.einsum("nhk,nkhd->nhd", att, v).reshape(n, self.d_model)
        x = x[:, -1] + ctx @ wo
        y = _normalize_layer(x)
        mlp = torch.nn.functional.gelu(y @ w1 + b1, approximate="tanh") @ w2 + b2
        x = mlp if fault == "no_mlp_residual" else x + mlp
        logits = x @ w_out + b_out
        return torch.softmax(logits.to(out_dt), dim=-1).reshape(lead + (self.A1,))

    return block


@pytest.mark.parametrize("fault", ["scale_by_d_model", "no_pos", "no_mlp_residual", "sound"])
def test_attention_faults_come_out_incorrect(monkeypatch, fault):
    from bear_tpu_torch.models import ar_funcs

    monkeypatch.setattr(ar_funcs.AttentionAR, "_block", _block_with(fault))
    line = run(ATTN)
    # The sound copy of the block passes: each fault alone fails.
    assert line["correct"] is (fault == "sound"), line["checks"]


def test_map_fault_half_the_counts_comes_out_incorrect(monkeypatch):
    from bear_tpu_torch.inference import serving

    original = serving.BearServer._gather

    def half(self, rows):
        out = original(self, rows).clone()
        out[out.shape[0] // 2:] = 0.0  # the second half of the batch's reads, unseen
        return out

    monkeypatch.setattr(serving.BearServer, "_gather", half)
    line = run(MAP)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_read_none_untraced_and_a_number_traced(name):
    read = harness.load_module("metrics", name).read
    profiling.clear()
    try:
        traced = run(ATTN, trace=True)
        assert traced["metrics"][name]["value"] > 0
    finally:
        profiling.clear()
    untraced = harness.Run(ATTN, config(ATTN), spec(ATTN)["params"], 1, torch.device("cpu"))
    untraced.work["windows"] = 10.0
    assert read(untraced) is None


def test_the_rows_reader_reads_none_from_a_program_without_the_counter(monkeypatch):
    from types import SimpleNamespace

    from bear_tpu_torch.models import ar_funcs

    monkeypatch.delattr(ar_funcs, "attention_rows")
    read = harness.load_module("metrics", "attn_rows_per_window").read
    assert read(SimpleNamespace(trace=object(), work={"windows": 10.0})) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ATTN, MAP])
def test_the_control_fails_the_new_cells_check(cell):
    """On the card, at the cell's own size: the plain reference with its
    products in TF32, put in the program's place, fails at least one of
    the cell's limits, and the program passes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "calibrate_cells.py"),
                          cell, str(2**31 + 101), "--calls", "2"],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = spec(cell)["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
