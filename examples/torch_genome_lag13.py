"""End-to-end genome-scale demo on one CUDA card: an E. coli-sized genome at
lag 13, through the PyTorch port (bear_tpu_torch).

Synthesizes a 4.6 Mb genome (a repeated template with point mutations, so
there is real transition structure to learn), slices it into 150 bp reads
at a chosen coverage, then:

1. counts the reads at lag 13 on the card (TransitionCounter: one
   count_chunk kernel launch per chunk of 16,384 reads, no flush), with a
   train/test split as two dataset groups;
2. hands the counts to training on the card (to_device_dataset: the table
   never crosses to the host);
3. trains a CNN embedded-AR BEAR with empirical-Bayes h;
4. evaluates held-out perplexity and accuracy against the AR and BMM
   readings.

Run:

    python examples/torch_genome_lag13.py [--genome-mb 4.6] [--coverage 10]
    python examples/torch_genome_lag13.py --genome-mb 0.02 --coverage 2 --device cpu

``main(argv)`` returns what it computed (see :func:`main`).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

CHUNK_ROWS = 16384  # reads per count_chunk launch


def synth_genome(rng, length, template_len=100_000, mutation_rate=0.01):
    """Repeat-with-mutations genome: a random template tiled to `length` with
    point substitutions (real genomes are repetitive, which is what BEAR
    exploits)."""
    template = rng.integers(0, 4, template_len, dtype=np.int8)
    reps = -(-length // template_len)
    genome = np.tile(template, reps)[:length]
    mut = rng.random(length) < mutation_rate
    genome[mut] = (genome[mut] + rng.integers(1, 4, mut.sum())) % 4
    return genome


def synth_reads(genome_mb, coverage, read_len, seed=0):
    """(reads [n, read_len] int8 codes, groups [n] int32: 0 = train, 1 =
    test), drawn from one numpy generator in a fixed order: the genome,
    then the read starts, then the groups."""
    rng = np.random.default_rng(seed)
    G = int(genome_mb * 1e6)
    genome = synth_genome(rng, G)
    n_reads = int(G * coverage / read_len)
    starts = rng.integers(0, G - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    groups = (rng.random(n_reads) < 0.25).astype(np.int32)
    return reads, groups


def read_chunks(reads, groups, rows=CHUNK_ROWS):
    """Constant-shape ReadChunks of ``rows`` reads (zero-length pad rows
    fill the last)."""
    from bear_tpu_torch.counting import ReadChunk

    n_reads, read_len = reads.shape
    for s in range(0, n_reads, rows):
        n = min(rows, n_reads - s)
        codes = np.zeros((rows, read_len), np.int8)
        codes[:n] = reads[s : s + n]
        lengths = np.zeros(rows, np.int32)
        lengths[:n] = read_len
        stopped = np.zeros(rows, bool)
        stopped[:n] = True
        grp = np.zeros(rows, np.int32)
        grp[:n] = groups[s : s + n]
        yield ReadChunk(codes, lengths, np.zeros(rows, np.int32), stopped, grp)


def main(argv=None) -> dict:
    """Run the demo. Returns a dict: ``reads``, ``rows`` (distinct lag
    contexts), ``transitions``, ``codes`` and ``counts`` (the handoff, as numpy),
    ``h``, ``params`` (the trained AR parameters, numpy), ``elbos``,
    ``evaluation`` (bear_net.evaluation's tuple, numpy), ``stages``
    (StageTimer's (name, seconds) list, each stage timed to the end of its
    work on the card) and ``count_s``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--coverage", type=float, default=10.0)
    ap.add_argument("--lag", type=int, default=13)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1 << 15)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where counting, training and evaluation run (default: the card)")
    args = ap.parse_args(argv)

    from bear_tpu_torch.counting import TransitionCounter
    from bear_tpu_torch.models import bear_net, get_ar_func
    from bear_tpu_torch.utils import StageTimer

    device = args.device
    timer = StageTimer()
    with timer.stage("synthesize reads"):
        reads, groups = synth_reads(args.genome_mb, args.coverage, args.read_len)
    n_reads = len(reads)

    counter = TransitionCounter(lags=[args.lag], n_groups=2, device=device)
    count_name = f"count lag-{args.lag}"
    with timer.stage(count_name):
        for chunk in read_chunks(reads, groups):
            counter.add_chunk(chunk)
        # No flush: the counts stay on the device for the handoff below.
        counter.sync()
    total_transitions = n_reads * (args.read_len + 1)

    with timer.stage("on-device dataset handoff"):
        codes_d, counts_d = counter.to_device_dataset(args.lag)
        num_kmers = int(codes_d.shape[0])
    print(f"{num_kmers:,} distinct lag-{args.lag} contexts "
          f"from {total_transitions:,} transitions")

    ar = get_ar_func("cnn", args.lag, 4,
                     {"filter_width": min(8, args.lag),
                      "num_filters": 96, "kmer_layer1_width": 64},
                     dtype=torch.float32, device=device)
    with timer.stage("train BEAR"):
        res = bear_net.train(
            codes_d, counts_d[:, 0], num_kmers=num_kmers, ar_func=ar,
            batch_size=args.batch_size, epochs=args.epochs,
            learning_rate=0.005, train_ar=False, dtype=torch.float32, device=device,
        )
    print(f"learned h = {res.h:.4g}; ELBO {res.elbos[0]:.4g} -> {res.elbos[-1]:.4g}")

    with timer.stage("evaluate"):
        out = bear_net.evaluation(
            codes_d, counts_d, 0, 1, "dna", res.h, ar, res.params["ar"],
            np.array([0.1, 1.0, 10.0]), dtype=torch.float32, device=device,
        )
    out = tuple(np.asarray(o) for o in out)
    print(f"heldout perplexity: BEAR {float(out[3]):.4f}  AR {float(out[4]):.4f}  "
          f"BMM {np.array2string(out[5], precision=4)}")
    print(f"heldout accuracy:   BEAR {float(out[6]):.4f}  AR {float(out[7]):.4f}")
    timer.report()

    count_s = dict(timer.stages)[count_name]
    print(f"counting throughput: {total_transitions / count_s / 1e6:.1f}M transitions/s")
    return {"reads": n_reads, "rows": num_kmers, "transitions": total_transitions,
            "codes": codes_d.cpu().numpy(), "counts": counts_d.cpu().numpy(),
            "h": res.h, "params": res.params_list[1:], "elbos": res.elbos,
            "evaluation": out, "stages": list(timer.stages), "count_s": count_s}


if __name__ == "__main__":
    main()
