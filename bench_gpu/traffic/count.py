"""Counting traffic: closed-loop passes over the genome's reads, each a
fresh ``TransitionCounter`` fed every chunk by ``add_chunk`` and then
synchronised, with no flush (the counts stay on the device, as the
genome example counts before its handoff).

Set-up makes the reads and their chunks. One pass of the first
``params["kept_choices"]``, drawn from the seed, and the window's last pass
keep their counters; the check recounts the reads with the plain reference
and compares both tables with it entry by entry (``mismatches``, exact).
``sector_count`` counts, by the reference's key math, the distinct 32-byte
table sectors each chunk touches (``count_chunk``'s byte bound).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_gpu import genome
from bench_gpu.reference import counts as ref_counts


def setup(run):
    return Count(run)


def chunk_sectors(reads, groups, cfg, dev) -> int:
    """Sum over chunks of the distinct int32 table sectors (8 entries of 4
    bytes) that each chunk's transitions touch."""
    n, rows = reads.shape[0], cfg["genome"]["chunk_rows"]
    total = 0
    for s in range(0, n, rows):
        keys, _ = ref_counts.count_keys(torch.as_tensor(reads[s:s + rows], device=dev),
                                        torch.as_tensor(groups[s:s + rows], device=dev),
                                        cfg["lag"], cfg["n_groups"])
        total += int(torch.unique(keys // 8).numel())
    return total


class Count:
    def __init__(self, run):
        from bear_tpu_torch.counting import ReadChunk, TransitionCounter

        self.run, self.Counter = run, TransitionCounter
        cfg, dev = run.config, run.device
        self.reads, self.groups = genome.genome_traffic(run.seed, cfg)
        run.mark("reads")
        self.chunks = [ReadChunk(*a) for a in
                       genome.chunk_arrays(self.reads, self.groups, cfg["genome"]["chunk_rows"])]
        n, self.read_len = self.reads.shape
        self.transitions = n * (self.read_len + 1)
        self.launch_rows = len(self.chunks) * cfg["genome"]["chunk_rows"]  # rows a pass launches
        self.sectors = None  # counted on first use (a traced run's metrics)
        self.keep = int(np.random.default_rng(run.seed).integers(run.params["kept_choices"]))
        self.passes = 0
        self.kept, self.last = None, None

    def one_pass(self):
        cfg = self.run.config
        counter = self.Counter(lags=[cfg["lag"]], n_groups=cfg["n_groups"],
                               device=self.run.device)
        for chunk in self.chunks:
            with self.run.span("add_chunk"):
                counter.add_chunk(chunk)
        counter.sync()
        return counter

    def warmup(self):
        self.one_pass()
        self.run.spans.clear()

    def step(self):
        counter = self.one_pass()
        if self.passes == self.keep:
            self.kept = counter
        self.last = counter
        self.passes += 1
        self.run.work["transitions"] += self.transitions
        self.run.work["passes"] += 1

    def sector_count(self) -> int:
        """Distinct table sectors summed over one pass's chunks."""
        if self.sectors is None:
            self.sectors = chunk_sectors(self.reads, self.groups, self.run.config,
                                         self.run.device)
        return self.sectors

    def release(self):
        self.chunks = None

    def check(self):
        cfg, dev = self.run.config, self.run.device
        keys, n = ref_counts.count_keys(torch.as_tensor(self.reads, device=dev),
                                        torch.as_tensor(self.groups, device=dev),
                                        cfg["lag"], cfg["n_groups"])
        bad = 0
        for counter in {id(c): c for c in (self.kept, self.last) if c is not None}.values():
            bad += mismatches(counter.table(cfg["lag"]).reshape(-1), keys, n)
        if self.kept is None:  # the drawn pass never ran: nothing to compare it with
            bad += 1
        return {"mismatches": bad}


def mismatches(table, keys, counts) -> int:
    """Entries of the flat table that differ from the reference's counts:
    the reference's entries counted otherwise, and nonzero entries the
    reference does not have."""
    got = table[keys].to(torch.int64)
    wrong = int((got != counts).sum())
    extra = int(torch.count_nonzero(table)) - int(torch.count_nonzero(got))
    return wrong + extra
