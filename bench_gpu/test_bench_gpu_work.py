"""The yardstick's arithmetic against counts made by hand."""

from __future__ import annotations

import pytest
import torch

from bench_gpu import harness, tiny_cells
from bench_gpu.metrics import _work
from bench_gpu.reference import counts as ref_counts


def test_cnn_forward_flops_of_the_lag13_cnn():
    cfg = harness.load_json(harness.BENCH, "configs", "genome_lag13_cnn.json")
    # conv: 6 outputs x (8 x 5) inputs x 96 filters; dense 6 x 96 -> 64; head 64 -> 5
    assert _work.cnn_forward_flops(cfg) == 2 * (6 * 8 * 5 * 96 + 6 * 96 * 64 + 64 * 5) == 120_448


def test_count_chunk_bytes_on_a_small_chunk():
    # Two reads of 3 letters at lag 2, one group: keys and their sectors by hand.
    reads = torch.tensor([[0, 1, 2], [0, 1, 3]])
    keys, _ = ref_counts.count_keys(reads, torch.zeros(2, dtype=torch.int32), 2, 1)
    # transitions (row, next): '[[' -> A twice, '[A' -> C twice, 'AC' -> G and T,
    # 'CG' -> $ and 'CT' -> $: rows 0, 1 (A) and 5 + AC = 6, CG = 11, CT = 12
    assert keys.tolist() == [0, 6, 32, 33, 59, 64]
    sectors = int(torch.unique(keys // 8).numel())
    assert sectors == 4  # 0, 6 | 32, 33 | 59 | 64
    assert _work.count_chunk_bytes(2, 3, sectors) == 2 * 3 + 16 * 2 + 2 * 32 * 4 == 294


def test_keyed_draw_ops_and_bytes_by_hand():
    # One draw of 5 categories: a fold_in block; 15 words (3.75 blocks of 98);
    # 15 conversions of 4; 5 normals of 4; 10 exponentials of 2; 5 proposals
    # of 12 + 3; the pick 4 x 5 + 1.
    per_draw = 98 + 98 * 15 / 4 + 4 * 15 + 4 * 5 + 2 * 10 + 15 * 5 + 21
    assert per_draw == 661.5
    assert _work.keyed_draw_ops(41, 10, 5) == 41 * 10 * per_draw + 10 * 5 * 5
    assert _work.keyed_draw_bytes(41, 10, 5, 2, 4) == 41 * 2 * 8 + 10 * (8 + 8 + 20 + 4) + 41 * 10 * 4


def test_least_seconds_takes_the_larger_bound():
    assert _work.least_seconds(67e12, 0) == (1.0, "operations")
    assert _work.least_seconds(0, 3.35e12) == (1.0, "bytes")


@pytest.mark.parametrize("cell", tiny_cells.CELLS)
def test_traced_metrics_read_no_device_number_on_the_cpu(cell):
    """A traced run on the CPU names no kernel and gives no roofline: a
    reader with nothing to read returns nothing, never 0."""
    line = tiny_cells.run(cell, trace=True)
    assert not any(k.endswith("_roofline") for k in line["metrics"])
    assert line["device"]["busy_s"] == 0.0 and line["breakdown"]["device_ops"] == []
