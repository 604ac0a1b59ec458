"""The genome traffic: a synthetic E. coli-sized genome and reads of it,
made from the run's seed (a frozen copy of the generators of
examples/torch_genome_lag13.py, so that a change to the program cannot
change the yardstick).

The genome is a random template tiled to the genome's length with point
substitutions (real genomes are repetitive, which is what BEAR exploits);
reads are uniform windows of it, a share of them held out as group 1.
Everything is drawn from one numpy generator in a fixed order: the genome,
then the read starts, then the groups.
"""

from __future__ import annotations

import numpy as np


def synth_genome(rng, length, template_len=100_000, mutation_rate=0.01):
    """int8 codes [length] in 0..3: a random template tiled to ``length``
    with point substitutions."""
    template = rng.integers(0, 4, template_len, dtype=np.int8)
    reps = -(-length // template_len)
    genome = np.tile(template, reps)[:length]
    mut = rng.random(length) < mutation_rate
    genome[mut] = (genome[mut] + rng.integers(1, 4, mut.sum())) % 4
    return genome


def synth_reads(seed, genome_mb, coverage, read_len, held_out, template_len=100_000,
                mutation_rate=0.01):
    """(reads [n, read_len] int8 codes, groups [n] int32: 0 = train, 1 =
    held out) from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    G = int(genome_mb * 1e6)
    genome = synth_genome(rng, G, template_len, mutation_rate)
    n_reads = int(G * coverage / read_len)
    starts = rng.integers(0, G - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    groups = (rng.random(n_reads) < held_out).astype(np.int32)
    return reads, groups


def chunk_arrays(reads, groups, rows):
    """Constant-shape chunks of ``rows`` reads, as (codes, lengths, skip,
    stopped, groups) numpy arrays; zero-length pad rows fill the last."""
    n_reads, read_len = reads.shape
    out = []
    for s in range(0, n_reads, rows):
        n = min(rows, n_reads - s)
        codes = np.zeros((rows, read_len), np.int8)
        codes[:n] = reads[s:s + n]
        lengths = np.zeros(rows, np.int32)
        lengths[:n] = read_len
        stopped = np.zeros(rows, bool)
        stopped[:n] = True
        grp = np.zeros(rows, np.int32)
        grp[:n] = groups[s:s + n]
        out.append((codes, lengths, np.zeros(rows, np.int32), stopped, grp))
    return out


def genome_traffic(seed, config):
    """The reads of a genome configuration (its ``genome`` group of keys)."""
    g = config["genome"]
    return synth_reads(seed, g["genome_mb"], g["coverage"], g["read_len"], g["held_out"],
                       g["template_len"], g["mutation_rate"])
