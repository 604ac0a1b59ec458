"""The metrics that read the program's own spans: the small cells, traced on
the CPU, report them; an untraced run, and a program that keeps no span
records, read None without raising."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_gpu import harness, tiny_cells
from bear_tpu_torch.utils import profiling

SPAN_METRICS = {m["name"]: m for m in tiny_cells.bench()["per_layer"]
                if m["source"] == "program_span" and m["name"] != "count_feed_ms_per_chunk"}
# The CPU path stages no chunk: its staging spans exist only on the card.
CARD_ONLY = {"count_stage_ms_per_chunk", "count_stage_wait_ms_per_chunk"}


def _traced(cell):
    profiling.clear()
    try:
        return tiny_cells.run(cell, trace=True)
    finally:
        profiling.clear()


@pytest.mark.parametrize("cell", ["genome13_train", "genome13_score_mc41", "genome13_count"])
def test_a_traced_small_cell_reports_its_span_metrics(cell):
    line = _traced(cell)
    assert line["correct"] is True
    mine = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    assert mine, "every benchmarked path has a metric of its spans"
    got = line["metrics"]
    for name in mine - CARD_ONLY:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    assert not (mine & CARD_ONLY) & set(got)
    if cell == "genome13_count":
        # The program's span lies inside the benchmark's around the same call.
        assert got["count_feed_ms_per_chunk.program"]["value"] <= \
            got["count_feed_ms_per_chunk"]["value"]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_read_none_without_spans(monkeypatch, name):
    read = harness.load_module("metrics", name).read
    profiling.clear()
    untraced = SimpleNamespace(trace=None)
    traced = SimpleNamespace(trace=object())
    assert read(untraced) is None
    assert read(traced) is None  # traced, but no span recorded
    monkeypatch.delattr(profiling, "recorded")  # a program that keeps no records
    assert read(traced) is None
