#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: every kernel of the path, from bear_tpu_torch/csrc (one nvcc per
   source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card, on
   edge cases and on the main path's chunk 0 (exact equality), then timed
   at the main path's chunk beside its bound and a library call:
   window_hist (keys -> counts, off the main path since count_chunk) with
   an ablation of what holds its atomics back, and count_chunk (codes ->
   counts, the main path's kernel) beside the earlier keys design;
4. main path: the examples/genome_lag13.py workload — a 4.6 Mb synthetic
   genome (seed 0) cut into 150 bp reads at coverage 10, train/test groups —
   counted at lag 13 by TransitionCounter on the card (one count_chunk
   launch per chunk), then 4,096 held-out reads scored by BearServer (MAP)
   with a seeded lag-13 LinearAR, held against the same scores from the
   port on the CPU in float64; after the path's kernel counts are read,
   four chunks and one scoring call are profiled;
4b. training, the published YSD1 protocol: train_bear_net.main on the
   values of bear_lin_bear.cfg in float32 (10,000 Adam applies, held-out
   and train-as-test evaluation, config.cfg + results.pickle), then the
   same training alone, timed; h and the BEAR held-out perplexity against
   the published values, BMM against the port's CPU float64 evaluation;
4c. training on the main path: the same chunks counted again into a fresh
   TransitionCounter, handed off on the card (to_device_dataset, before
   any flush), a CNN BEAR of examples/genome_lag13.py's widths trained
   (its first ELBOs against CPU float64), evaluated, written, reloaded by
   load_bear and served to the 4,096 held-out reads (against CPU float64);
   then 200 YSD1 applies and 20 CNN applies are profiled;
4d. posterior-sampled serving and variant scoring, from the main path's
   train table with 4c's reloaded CNN and its h: (C) the 4,096 held-out
   reads at MC-41 (41 posterior draws, reduce "mean_std" and "none"); (D)
   the deep-mutational-scan grid of the first 10 kb of the genome (30,000
   SNVs), MAP and MC-41; (E) 10,000 seeded SNVs, substitutions, insertions
   and deletions on the same 10 kb, MAP and MC-41; (F) the score CLI on
   4b's YSD1 model (snv --all --sample --std, variants --device, seqs
   --map). MAP against the port on the CPU in float64; sampled float64 on
   the card against the CPU in float64 from the same keys, on subsets; the
   in-call reductions against the raw draws. Rates, peak device memory,
   the sampler's share of device time, and profiles of (C) and (D);
4e. the on-disk workflow: phase 4's reads written as FASTQ (the train
   group over 3 files, one gzip-compressed; the held-out group in 1), the
   summarize CLI at -l 13 through its parser on the card (native parser for
   every file, one count_chunk launch per chunk over all 13 lag tables,
   conservation at every lag, the lag-13 shards read back equal to phase
   4's counts), count_chunk timed at the summarize chunk over 13 lags, then
   the streaming training CLI on the lag-13 shards (4c's CNN BEAR, shuffle,
   shard cache, checkpoints every 32 applies; first ELBOs against CPU
   float64 from the same start and stream, streamed held-out perplexities
   against the in-memory evaluation on the card) and the score CLI on the
   trained model directory;
5. one JSON line of the kernels, then the device line, last.

Needs one CUDA card. Imports nothing of JAX and nothing of bear_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_MB = 4.6
COVERAGE = 10.0
READ_LEN = 150
LAG = 13
N_GROUPS = 2
CHUNK_ROWS = 16384  # reads per chunk, as in examples/genome_lag13.py
N_SCORE = 4096
H = 0.05
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, CUDA cores
# count_chunk's integer work: the rolling code (4 ops per position) and the
# key (6 ops per position and lag), against the CUDA cores' rate.
ROLL_OPS, KEY_OPS = 4, 6
COUNT_CASES = ["multi_lag_1_4_7", "reverse", "ambig_not_fresh", "segmented_skip",
               "zero_length_rows", "protein_lag6", "row_longer_than_tile"]
# GPU float32 vs CPU float64 scores: float32 rounding of ~1e-7 relative per
# log term, summed over <= 193 transition positions of a ~-100..-300 score.
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-3
# Phase 4b: the published YSD1 model results (reference docs/usage.rst:253-265),
# held within 2% (h) and 0.01 (BEAR held-out perplexity) in float32. BMM
# does not depend on training: card float32 against CPU float64 at 1e-5
# (float32 lgamma of counts up to ~1e5, summed over 1,365 rows).
YSD1_H, YSD1_H_RTOL = 0.04326, 0.02
YSD1_PERPLEXITY, YSD1_PERPLEXITY_ATOL = 3.79, 0.01
BMM_RTOL = 1e-5
VAN_REG = [0.1, 1.0, 10.0]
# Phase 4c: the CNN BEAR of examples/genome_lag13.py, trained on the counts
# handed off on the card; its first applies' ELBOs against CPU float64 from
# the same initial parameters on the same batches (float32 rounding of
# sums over 2^15 rows).
CNN_KW = {"filter_width": 8, "num_filters": 96, "kmer_layer1_width": 64}
TRAIN_BATCH = 1 << 15
TRAIN_EPOCHS = 3
TRAIN_LR = 0.005
N_ELBO_CHECK = 5
ELBO_RTOL = 1e-4
# Phase 4d: posterior-sampled serving at the reference's Monte Carlo
# default (41 draws), the deep-mutational-scan grid and seeded arbitrary
# variants on the genome's first 10 kb, and the subsets held against the
# CPU in float64: sampled float64 values agree to 1e-9 but for draws whose
# Marsaglia-Tsang accept test lands on its boundary (at most 1e-4 of them).
MC = 41
DMS_BP = 10_000
N_VARIANTS = 10_000
SAMPLED_CHECK = (256, 2000, 1000)  # reads, SNVs, variants
MAP_CHECK = (3000, 1000)  # SNVs, variants
SAMPLED_RTOL = 1e-9
SAMPLED_FLIPS = 1e-4
PEAK_BUDGET = 8 << 30  # bytes a call may take above what is resident
CLI_WT_BP = 500
CLI_READS = 64
# Phase 4e: the on-disk workflow. The reads as FASTQ (the train group over 3
# files, one gzip-compressed), summarize -l 13 (every lag 1..13 in one table,
# chunks of 1,024 reads), the CNN BEAR of 4c trained by the streaming CLI on
# the lag-13 shards. Streamed and in-memory evaluation on the card differ only
# in batch boundaries (float32 per batch, float64 sums).
N_TRAIN_FILES = 3
STREAM_CHECKPOINT_EVERY = 32
EVAL_RTOL = 1e-5


def ysd1_config(out_folder):
    """The published YSD1 protocol: the values of
    bear_tpu/models/config_files/bear_lin_bear.cfg (linear BEAR, lag 5,
    batch 1500, 10,000 epochs = 10,000 Adam applies, lr 0.01, seed 10),
    in float32, on the port's bundled YSD1 counts (files_path TEST)."""
    import configparser

    cfg = configparser.ConfigParser()
    cfg.read_dict({
        "general": {"out_folder": out_folder, "seed": "10", "precision": "float32"},
        "data": {"files_path": "TEST", "start_token": "TEST", "sparse": "False",
                 "num_ds": "3", "alphabet": "dna", "train_column": "0",
                 "test_column": "1", "reference_column": "2"},
        "hyperp": {"lag": "5"},
        "train": {"train": "True", "epochs": "10000", "batch_size": "1500",
                  "optimizer_name": "Adam", "learning_rate": "0.01",
                  "train_ar": "False", "accumulation_steps": "1", "cache": "True",
                  "restart": "False", "restart_path": "temp_name"},
        "test": {"test": "True", "train_test": "True", "van_reg": "[0.1, 1.0, 10.0]"},
        "model": {"ar_func_name": "linear", "af_kwargs": "{}"},
        "results": {},
    })
    return cfg


def synth_genome(rng, length, template_len=100_000, mutation_rate=0.01):
    """Repeat-with-mutations genome (the generator of
    examples/genome_lag13.py): a random template tiled to `length` with
    point substitutions."""
    template = rng.integers(0, 4, template_len, dtype=np.int8)
    reps = -(-length // template_len)
    genome = np.tile(template, reps)[:length]
    mut = rng.random(length) < mutation_rate
    genome[mut] = (genome[mut] + rng.integers(1, 4, mut.sum())) % 4
    return genome


def make_reads(genome_mb=GENOME_MB, coverage=COVERAGE, read_len=READ_LEN,
               seed=SEED):
    """(reads [n, read_len] int8, groups [n] int32: 1 = held-out test)."""
    rng = np.random.default_rng(seed)
    G = int(genome_mb * 1e6)
    genome = synth_genome(rng, G)
    n_reads = int(G * coverage / read_len)
    starts = rng.integers(0, G - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    groups = (rng.random(n_reads) < 0.25).astype(np.int32)
    return reads, groups


def read_chunks(reads, groups, rows=CHUNK_ROWS):
    """Constant-shape ReadChunks (zero-length pad rows fill the last)."""
    from bear_tpu_torch.counting.engine import ReadChunk

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


def genome_prefix(n, genome_mb=GENOME_MB, seed=SEED):
    """The first n bases of make_reads' genome, as a string."""
    genome = synth_genome(np.random.default_rng(seed), int(genome_mb * 1e6))
    return decode_reads(genome[None, :n])[0]


def snv_grid(wt):
    """Every position x every other base: (positions, alternates)."""
    pos = np.repeat(np.arange(len(wt)), 3)
    alts = [b for ref in wt for b in "ACGT" if b != ref]
    return pos, np.array(alts)


def make_variants(wt, n, seed=0):
    """n variants on wt in parse_var syntax, from a numpy seed: 40% SNVs,
    20% 2-3 bp substitutions, 20% 1-5 bp insertions, 20% 1-5 bp
    deletions."""
    rng = np.random.default_rng(seed)
    L = len(wt)
    out = []
    for kind in rng.choice(4, size=n, p=[0.4, 0.2, 0.2, 0.2]):
        if kind == 0:
            p = int(rng.integers(L))
            out.append(f"{wt[p]}{p}{rng.choice([b for b in 'ACGT' if b != wt[p]])}")
        elif kind == 1:
            m = int(rng.integers(2, 4))
            p = int(rng.integers(L - m + 1))
            out.append(f"{wt[p:p + m]}{p}{''.join(rng.choice(list('ACGT'), m))}")
        elif kind == 2:
            p = int(rng.integers(L + 1))
            out.append(f"{p}{''.join(rng.choice(list('ACGT'), int(rng.integers(1, 6))))}")
        else:
            m = int(rng.integers(1, 6))
            p = int(rng.integers(L - m + 1))
            out.append(f"{wt[p:p + m]}{p}")
    return out


def decode_reads(reads):
    letters = np.frombuffer(b"ACGT", np.uint8)
    return [r.tobytes().decode("ascii") for r in letters[reads]]


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed_ms(fn, reps, l2_flush):
    """Mean device time of fn over reps launches (CUDA events), warmed up,
    with L2 evicted before each launch as the counting loop leaves it
    (``l2_flush=None``: not evicted)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        if l2_flush is not None:
            l2_flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_breakdown(label, fn, card, top=8):
    """Run fn once plain and once under torch.profiler: wall times, device busy
    time (sum of the kernels and copies on the one stream) and the top
    device entries. Host-side op rows are left out: they repeat the device
    time of the kernels they launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        # A record_function span (e.g. Optimizer.step) shows on the device
        # as an annotation covering its kernels: left out, not counted twice.
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA and us > 0 and not annotation:
            rows.append((us / 1e3, e.count, e.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        print(f"[profile] {label}: wall {wall_ms:.3f} ms; device time not measured "
              "(the profiler recorded none)")
        return
    print(f"[profile] {label}: wall {plain_wall_ms:.3f} ms ({wall_ms:.3f} ms profiled), "
          f"device busy {busy_ms:.3f} ms = {100 * busy_ms / plain_wall_ms:.1f}% of the "
          f"unprofiled wall, idle {100 * (1 - busy_ms / plain_wall_ms):.1f}% [{card}]")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        print(f"[profile]   {ms:9.4f} ms {n:5d}x {key[:100]}")


def host_breakdown(label, fn, top=8):
    """Run fn under cProfile and print the host functions that took the
    most time of their own (the count loop's host side)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt * 1e3, nc, f"{os.path.basename(k[0])}:{k[1]}({k[2]})")
                   for k, (_, nc, tt, _, _) in stats.items()), reverse=True)
    print(f"[host] {label}: {wall_ms:.3f} ms under cProfile; own time by function:")
    for ms, n, key in rows[:top]:
        print(f"[host]   {ms:9.4f} ms {n:5d}x {key[:100]}")


def hist_edge_cases(dev):
    """(name, base table, keys) cases for window_update on the card."""
    import torch

    rng = np.random.default_rng(1)
    n = 3 * 32768 - 1234
    i32 = np.iinfo(np.int32)
    dup = rng.integers(0, n, 200_000).astype(np.int32)
    dup[:5000] = dup[0]
    dup[5000:5010] = 32768
    dup[5010:5020] = 32767
    dup[rng.random(dup.size) < 0.1] = n
    cases = [
        ("random_heavy_dup", np.zeros(n, np.int32), dup),
        ("negative", np.zeros(n, np.int32), np.concatenate([
            np.arange(6), np.full(1000, -1), np.full(100, i32.min)]).astype(np.int32)),
        ("beyond_table", np.zeros(n, np.int32), np.concatenate([
            rng.integers(0, n, 5000), np.full(64, n), np.full(30, n + 12345),
            np.full(10, i32.max)]).astype(np.int32)),
        ("all_sentinel", np.zeros(n, np.int32), np.full(512, n, np.int32)),
        ("empty", np.zeros(n, np.int32), np.zeros(0, np.int32)),
        ("accumulate", rng.integers(0, 5, n).astype(np.int32),
         rng.integers(0, n, 100_000).astype(np.int32)),
        ("one_hot_spot", np.zeros(n, np.int32), np.full(1 << 20, 7, np.int32)),
    ]
    out = [(name, torch.from_numpy(b).to(dev), torch.from_numpy(k).to(dev))
           for name, b, k in cases]
    # Keys at a 4-byte offset: exercises the kernel's non-vector path.
    out.append(("unaligned_keys", out[0][1], out[0][2][1:]))
    return out


def count_case(name):
    """(lags, n_groups, A, [(codes, meta)]): the host inputs of every
    count_chunk launch of one edge case, made with numpy from a seed."""
    from bear_tpu_torch.counting import count_chunk, engine, fastx

    rng = np.random.default_rng(100 + COUNT_CASES.index(name))

    def reads(n, lo, hi, A=4):
        return [(rng.integers(0, A, size=int(rng.integers(lo, hi))).astype(np.int8), i % 2)
                for i in range(n)]

    lags, n_groups, A, reverse, kw = (1, 4, 7), 2, 4, False, {}
    if name in ("multi_lag_1_4_7", "reverse"):
        items = reads(300, 0, 300)
        reverse = name == "reverse"
    elif name == "ambig_not_fresh":  # pieces after an ambiguous base
        items = list(engine.split_ambiguous(
            (fastx.encode_seq("".join(rng.choice(list("ACGTN"), size=int(n))), ambig=True),
             i % 2) for i, n in enumerate(rng.integers(0, 300, 300))))
    elif name == "segmented_skip":  # continuation segments carry skip > 0
        items, kw = reads(20, 500, 3000), {"segment_len": 256}
    elif name == "zero_length_rows":  # empty reads: stopped, and not
        items = [(np.zeros(0, np.int8), i % 2, i % 3 == 0, i % 2 == 0) for i in range(40)]
        items += reads(30, 0, 12)
    elif name == "protein_lag6":
        # The deepest dense protein table int32 indexing holds: 20^6 contexts
        # x 21 symbols, one group, 1.41e9 entries (lag 7 would need 5.6e10).
        lags, n_groups, A = (6,), 1, 20
        items = [(r, 0) for r, _ in reads(200, 0, 200, A=20)]
    elif name == "row_longer_than_tile":
        items = reads(3, 4000, 6000) + reads(20, 0, 100)
    else:
        raise KeyError(name)
    chunks = engine.chunk_reads(iter(items), max(lags), batch_size=64, **kw)
    return lags, n_groups, A, [
        (np.ascontiguousarray(codes, np.int8), count_chunk.pack_meta(*rows))
        for c in chunks for codes, *rows in engine.chunk_passes(c, reverse)]


def count_chunk_vs_plain(dev, lags, n_groups, A, passes):
    """Tables counted on the card by the kernel and by its plain version,
    each over every (codes, meta) pass."""
    import torch
    from bear_tpu_torch.counting.count_chunk import (count_chunk_plain,
                                                     count_chunk_update, lag_offsets)

    _, total = lag_offsets(lags, n_groups, A)
    a = torch.zeros(total, dtype=torch.int32, device=dev)
    b = torch.zeros(total, dtype=torch.int32, device=dev)
    for codes, meta in passes:
        c = torch.from_numpy(codes).to(dev)
        m = torch.from_numpy(meta).to(dev)
        count_chunk_update(a, c, m, lags, n_groups, A)
        count_chunk_plain(b, c, m, lags, n_groups, A)
    torch.cuda.synchronize()
    return a, b


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ysd1_phase(out_dir, card, device="cuda"):
    """4b: the published YSD1 protocol through the training CLI's ``main``
    in float32, then the same training alone, timed; checks h and the BEAR
    held-out perplexity against the published values and the BMM
    perplexities against the port's CPU float64 evaluation."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net, train_bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.checkpoint import load_params_list, load_results
    from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path

    cfg = ysd1_config(out_dir + "*")
    run = RunConfig.from_configparser(cfg)
    t0 = time.perf_counter()
    train_bear_net.main(cfg, device=device)
    synchronize(device)
    cli_s = time.perf_counter() - t0
    res = cfg["results"]  # main writes its results into the config
    applies = load_results(out_dir)["torch_opt_state"]["step"]
    h = float(res["h"])
    perp = {k: json.loads(res[f"heldout_perplex_{k}"]) for k in ("BEAR", "AR", "BMM")}
    acc = {k: json.loads(res[f"heldout_accuracy_{k}"]) for k in ("BEAR", "AR", "BMM")}

    ds = load_dense(bundled_ysd1_path(), "dna", run.num_ds)
    ar = get_ar_func("linear", run.lag, 4, dtype=torch.float32, device=device)
    kw = dict(num_kmers=ds.num_kmers, ar_func=ar, batch_size=int(run.batch_size_raw),
              learning_rate=run.learning_rate, seed=run.seed, dtype=torch.float32,
              device=device)
    synchronize(device)
    t0 = time.perf_counter()
    alone = bear_net.train(ds.codes, ds.counts[:, 0], epochs=applies, **kw)
    synchronize(device)
    train_s = time.perf_counter() - t0

    ar64 = get_ar_func("linear", run.lag, 4, dtype=torch.float64, device="cpu")
    ref = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", h, ar64,
                              load_params_list(out_dir)[1:], VAN_REG,
                              dtype=torch.float64, device="cpu")
    bmm_err = float(np.max(np.abs(np.asarray(perp["BMM"]) / ref[5] - 1)))
    print(f"[ysd1] train_bear_net.main, bear_lin_bear.cfg values in float32: {applies:,} "
          f"optimizer applies; the CLI run (load, train, evaluate twice, write) "
          f"{cli_s:.3f} s; training alone {train_s:.3f} s = {applies / train_s:.6g} "
          f"applies/s (h {alone.h:.6g}) [{card}]")
    print(f"[ysd1] h {h:.6g} (published {YSD1_H}); held-out perplexity BEAR "
          f"{perp['BEAR']:.6f} AR {perp['AR']:.6f} BMM {perp['BMM']}; accuracy BEAR "
          f"{acc['BEAR']:.6f} AR {acc['AR']:.6f} BMM {acc['BMM']}; BMM vs CPU float64 "
          f"max rel err {bmm_err:.3e} [{card}]")
    check(abs(h / YSD1_H - 1) <= YSD1_H_RTOL, f"YSD1 h {h} not within 2% of {YSD1_H}")
    check(abs(perp["BEAR"] - YSD1_PERPLEXITY) <= YSD1_PERPLEXITY_ATOL,
          f"YSD1 BEAR held-out perplexity {perp['BEAR']} not within 0.01 of 3.79")
    check(bmm_err <= BMM_RTOL, f"YSD1 BMM perplexities {perp['BMM']} differ from "
          f"CPU float64 {ref[5]} by {bmm_err:.3e}")
    return ds, kw


def lag13_train_phase(chunks, reads, groups, out_dir, card, device="cuda", lag=LAG,
                      cnn_kw=CNN_KW, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                      n_score=N_SCORE):
    """4c: count the chunks into a fresh TransitionCounter, hand the counts
    off on the device before any flush, train the CNN BEAR, evaluate,
    write and reload the model and serve held-out reads with it. Checks
    conservation of the handoff, the first applies' ELBOs against CPU
    float64 and the trained model's scores against CPU float64. Returns
    what the profiles reuse."""
    import shutil

    import torch
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.inference import BearServer, load_bear
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.checkpoint import save_results
    from bear_tpu_torch.utils.cli_common import write_config

    count_chunk_update.launches = 0
    t_first_read = time.perf_counter()
    counter = engine.TransitionCounter(lags=[lag], n_groups=N_GROUPS, device=device)
    for chunk in chunks:
        counter.add_chunk(chunk)
    counter.sync()
    launches = count_chunk_update.launches
    t0 = time.perf_counter()
    count_s = t0 - t_first_read
    codes, counts = counter.to_device_dataset(lag)
    synchronize(device)
    handoff_s = time.perf_counter() - t0
    n_rows = codes.shape[0]

    gen = torch.Generator().manual_seed(SEED)
    ar = get_ar_func("cnn", lag, 4, cnn_kw, device=device)
    init = bear_net.init_params(gen, ar)
    p0 = [init["h_signed"]] + init["ar"]
    synchronize(device)
    t0 = time.perf_counter()
    res = bear_net.train(codes, counts[:, 0], num_kmers=n_rows, ar_func=ar,
                         batch_size=batch, epochs=epochs, learning_rate=TRAIN_LR,
                         params_restart=p0, dtype=torch.float32, device=device)
    synchronize(device)
    t_trained = time.perf_counter()
    train_s = t_trained - t0

    # The checks, outside the timed span: conservation of the handoff
    # against validate(), which flushes the table (hence after the handoff).
    handed = counts.sum(dim=(0, 2), dtype=torch.float64).cpu().numpy()
    expected = len(reads) * (reads.shape[1] + 1)
    counter.validate(expected)
    per_group = counter.tables[lag].sum(axis=(1, 2))
    check(np.array_equal(handed, per_group),
          f"handoff totals {handed} differ from the tables' {per_group}")
    check(codes.is_cuda == counts.is_cuda == (torch.device(device).type == "cuda"),
          "the handoff left the device")
    print(f"[train] count again into a fresh counter ({launches} count_chunk launches, "
          f"{count_s:.4f} s), then to_device_dataset({lag}) before any flush: {n_rows:,} "
          f"rows in {handoff_s:.4f} s; per-group totals {handed.astype(np.int64).tolist()} "
          f"== the tables' [{card}]")
    elbos = res.elbos
    check(np.isfinite(elbos).all() and len(elbos) == epochs * -(-n_rows // batch),
          f"ELBOs not finite or of the wrong count: {len(elbos)}")
    print(f"[train] CNN BEAR {cnn_kw}, batch {batch}, {epochs} epochs, lr {TRAIN_LR}, "
          f"float32: {len(elbos)} applies in {train_s:.3f} s = {len(elbos) / train_s:.6g} "
          f"applies/s; h {res.h:.6g}; ELBO {elbos[0]:.7g} -> {elbos[-1]:.7g}; from the "
          f"first read to a trained model {t_trained - t_first_read:.3f} s [{card}]")

    k = min(N_ELBO_CHECK, -(-n_rows // batch))  # applies of the first epoch
    ar64 = get_ar_func("cnn", lag, 4, cnn_kw, dtype=torch.float64, device="cpu")
    ref = bear_net.train(codes[: k * batch].cpu(), counts[: k * batch, 0].cpu(),
                         num_kmers=n_rows, ar_func=ar64, batch_size=batch, epochs=1,
                         learning_rate=TRAIN_LR, params_restart=p0, dtype=torch.float64,
                         device="cpu")
    elbo_err = float(np.max(np.abs(elbos[:k] / ref.elbos[:k] - 1)))
    check(len(ref.elbos) == k and elbo_err <= ELBO_RTOL,
          f"first {k} ELBOs {elbos[:k]} differ from CPU float64 {ref.elbos} "
          f"by {elbo_err:.3e}")
    print(f"[train] first {k} ELBOs vs CPU float64 from the same initial parameters: "
          f"max rel err {elbo_err:.3e} (tolerance {ELBO_RTOL})")

    synchronize(device)
    t0 = time.perf_counter()
    out = bear_net.evaluation(codes, counts, 0, 1, "dna", res.h, ar, res.params["ar"],
                              VAN_REG, dtype=torch.float32, device=device)
    eval_s = time.perf_counter() - t0
    print(f"[train] evaluation {eval_s:.3f} s: held-out perplexity BEAR {float(out[3]):.6f} "
          f"AR {float(out[4]):.6f} BMM {np.asarray(out[5]).tolist()}; accuracy BEAR "
          f"{float(out[6]):.6f} AR {float(out[7]):.6f} [{card}]")
    check(all(np.isfinite(np.asarray(o)).all() for o in out), "evaluation not finite")

    # Write the model directory, reload it, and serve with the trained CNN.
    cfg = ysd1_config(out_dir + "*")
    cfg["hyperp"]["lag"] = str(lag)
    cfg["data"]["num_ds"] = str(N_GROUPS)
    cfg["model"]["ar_func_name"] = "cnn"
    cfg["model"]["af_kwargs"] = json.dumps(cnn_kw)
    cfg["train"].update(epochs=str(epochs), batch_size=str(batch), learning_rate=str(TRAIN_LR))
    cfg["results"]["h"] = str(res.h)
    os.makedirs(out_dir, exist_ok=True)
    write_config(cfg, out_dir)
    save_results(out_dir, res.params_list, extra={"torch_opt_state": res.opt_state})
    dir64 = out_dir.rstrip("/") + "_float64"
    shutil.copytree(out_dir, dir64, dirs_exist_ok=True)
    cfg["general"]["precision"] = "float64"
    write_config(cfg, dir64)

    tables = counter.tables[lag]
    del counter
    seqs = decode_reads(reads[np.flatnonzero(groups == 1)[:n_score]])
    lag_, _, h, ar_apply, _ = load_bear(out_dir, device=device)
    check(lag_ == lag and abs(h / res.h - 1) < 1e-6, "load_bear read another model")
    server = BearServer(tables[0], lag, h=h, ar_apply=ar_apply, device=device)
    server.score(seqs)  # warm-up
    synchronize(device)
    t0 = time.perf_counter()
    scores = server.score(seqs)
    serve_s = time.perf_counter() - t0
    del server
    _, _, h64, ar_apply64, _ = load_bear(dir64, device="cpu")
    ref_scores = BearServer(tables[0], lag, h=h64, ar_apply=ar_apply64,
                            dtype=torch.float64, device="cpu").score(seqs)
    diff = np.abs(scores - ref_scores)
    check(scores.shape == (len(seqs),) and np.isfinite(scores).all()
          and bool((diff <= SCORE_ATOL + SCORE_RTOL * np.abs(ref_scores)).all()),
          f"trained-model scores differ from CPU float64: max {diff.max()}")
    print(f"[train] save_results + config.cfg -> load_bear -> BearServer with the trained "
          f"CNN: {len(seqs)} held-out reads in {serve_s:.4f} s = {len(seqs) / serve_s:.6g} "
          f"sequences/s; vs CPU float64 max |diff| {diff.max():.3e}; scores "
          f"{ref_scores.min():.3f}..{ref_scores.max():.3f} [{card}]")
    return launches, codes, counts, ar, p0, n_rows


def sampler_ops_per_draw(A1, F=3):
    """Operations of one keyed draw of A1 categories with F proposals,
    counted from the algorithm: 10 Philox rounds of ~10 integer operations
    (two multiplies, two high-word shifts, four XORs, two masks) for each
    block (the row key's fold_in, then the normal, exponential and boost
    words), ~25 float operations per proposal lane (its share of
    Box-Muller, the cube, the accept test with its log, the selection) and
    ~10 per category (boost, logsumexp, pick)."""
    blocks = 1 + -(-(F * A1 + F * A1 % 2) // 4) + -(-F * A1 // 4) + -(-A1 // 4)
    return 100 * blocks + 25 * F * A1 + 10 * A1


def sampler_share(server, fn):
    """(draw ms, call ms, draw bound ms, bound_by): device time of the keyed
    draws (BearServer._draw_picked) inside one call of fn and of the whole
    call, both between CUDA events, and the least time the card could take
    for those draws: their inputs (concentrations, rows, next symbols,
    groups, base keys) read and their [S, E] outputs written once at the
    HBM rate, against their operations (sampler_ops_per_draw) at the
    CUDA cores' float32 rate."""
    import torch

    spans = []
    work = [0, 0]  # bytes, operations
    inner = server._draw_picked

    def timed(base_keys, group, rows, nxt, conc):
        S, E = base_keys.shape[0], rows.shape[0]
        work[0] += (conc.numel() * conc.element_size() + rows.numel() * rows.element_size()
                    + nxt.numel() * nxt.element_size() + group.numel() * group.element_size()
                    + base_keys.numel() * 8 + S * E * conc.element_size())
        work[1] += S * E * sampler_ops_per_draw(conc.shape[-1])
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(base_keys, group, rows, nxt, conc)
        e.record()
        spans.append((s, e))
        return out

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    server._draw_picked = timed
    try:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
    finally:
        del server._draw_picked
    bytes_ms = work[0] / HBM_BYTES_PER_S * 1e3
    ops_ms = work[1] / FP32_OPS_PER_S * 1e3
    return (sum(s.elapsed_time(e) for s, e in spans), start.elapsed_time(end),
            max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def sampled_phase(table, lag, model_dir, ysd1_dir, seqs, wt, card, device="cuda",
                  mc=MC, n_variants=N_VARIANTS, sampled_check=SAMPLED_CHECK,
                  map_check=MAP_CHECK, cli_wt_bp=CLI_WT_BP, profile=True):
    """4d: posterior-sampled serving (C), the SNV scan (D), arbitrary
    variants (E) and the score CLI (F), from ``table`` with the model of
    ``model_dir`` (and its float64 copy ``model_dir + '_float64'``).
    Checks MAP against CPU float64, sampled float64 on the device against
    the CPU from the same keys on subsets, the reductions against the raw
    draws, and finiteness; reports rates and peak device memory, and with
    ``profile`` the sampler's share of device time and the profiles of (C)
    and (D)."""
    import contextlib
    import io

    import torch
    from bear_tpu_torch.inference import BearServer, load_bear, score_cli
    from bear_tpu_torch.ops.keyed_random import key as make_key

    on_card = torch.device(device).type == "cuda"
    dir64 = model_dir.rstrip("/") + "_float64"
    _, _, h, ar_apply, _ = load_bear(model_dir, device=device)
    server = BearServer(table, lag, h=h, ar_apply=ar_apply, device=device)
    _, _, h64, ar64, _ = load_bear(dir64, device=device)
    dev64 = BearServer(table, lag, h=h64, ar_apply=ar64, dtype=torch.float64, device=device)
    _, _, h64, ar64_cpu, _ = load_bear(dir64, device="cpu")
    cpu64 = BearServer(table, lag, h=h64, ar_apply=ar64_cpu, dtype=torch.float64,
                       device="cpu")
    key = make_key(SEED)

    def run(label, n, unit, fn):
        fn()  # warm-up
        synchronize(device)
        base = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        sec = time.perf_counter() - t0
        mem = ""
        if on_card:
            peak = torch.cuda.max_memory_allocated()
            mem = (f"; peak device memory {peak / 2**30:.3f} GiB, "
                   f"{(peak - base) / 2**30:.3f} GiB above the resident "
                   f"{base / 2**30:.3f} GiB")
            check(peak - base <= PEAK_BUDGET,
                  f"{label} took {peak - base} bytes above the resident, over the budget")
        print(f"[sample] {label}: {n:,} {unit} in {sec:.4f} s = {n / sec:.6g} {unit}/s"
              f"{mem} [{card}]")
        check(np.isfinite(out).all(), f"{label}: values not finite")
        return out

    def held(label, got, want, n_values):
        bad = int((np.abs(got - want) > SAMPLED_RTOL * np.abs(want) + 1e-12).sum())
        check(got.shape == want.shape and bad <= SAMPLED_FLIPS * n_values,
              f"{label}: {bad} of {n_values} sampled float64 values differ from the CPU")
        print(f"[sample] {label}: sampled float64 {device} vs CPU from the same keys: "
              f"{bad} of {n_values} values beyond rtol {SAMPLED_RTOL} (allowed "
              f"{SAMPLED_FLIPS:g} of them); max |diff| {np.abs(got - want).max():.3e}")

    def map_held(label, got, want):
        diff = np.abs(got - want)
        check(bool((diff <= SCORE_ATOL + SCORE_RTOL * np.abs(want)).all()),
              f"{label}: MAP float32 differs from CPU float64: max {diff.max()}")
        print(f"[sample] {label}: MAP float32 vs CPU float64 on {len(want):,}: max |diff| "
              f"{diff.max():.3e} (tolerance {SCORE_ATOL} + {SCORE_RTOL}*|score|)")

    def reductions_held(label, ms, raw):
        d_mean = np.abs(ms[:, 0] - raw.mean(-1))
        d_std = np.abs(ms[:, 1] - raw.std(-1, ddof=1))
        check(bool((d_mean <= 1e-3 + 1e-5 * np.abs(raw.mean(-1))).all()
                   and (d_std <= 1e-3 + 1e-4 * raw.std(-1)).all()),
              f"{label}: mean_std differs from the raw draws' statistics")
        print(f"[sample] {label}: reduce='mean_std' == mean, std of reduce='none' "
              f"(max |diff| {d_mean.max():.3e}, {d_std.max():.3e})")

    # (C) posterior-sampled serving
    n_r, n_s, n_v = sampled_check
    kw = dict(mode="sample", key=key, mc_samples=mc)
    score_ms = lambda: server.score(seqs, reduce="mean_std", **kw)  # noqa: E731
    ms = run(f"(C) {len(seqs)} reads, MC-{mc}, reduce='mean_std'", len(seqs),
             "sequences", score_ms)
    raw = run(f"(C) {len(seqs)} reads, MC-{mc}, reduce='none'", len(seqs), "sequences",
              lambda: server.score(seqs, **kw))
    check(ms.shape == (len(seqs), 2) and raw.shape == (len(seqs), mc), "(C) shapes")
    reductions_held("(C)", ms, raw)
    held(f"(C) {n_r} reads", dev64.score(seqs[:n_r], **kw), cpu64.score(seqs[:n_r], **kw),
         n_r * mc)

    # (D) the deep-mutational-scan grid
    pos, alts = snv_grid(wt)
    snv_ms = lambda: server.delta_scores_snv(wt, pos, alts, reduce="mean_std", **kw)  # noqa: E731
    d_map = run(f"(D) {len(pos):,} SNVs, MAP", len(pos), "SNVs",
                lambda: server.delta_scores_snv(wt, pos, alts))
    d_ms = run(f"(D) {len(pos):,} SNVs, MC-{mc}, reduce='mean_std'", len(pos), "SNVs", snv_ms)
    check(d_map.shape == (len(pos),) and d_ms.shape == (len(pos), 2), "(D) shapes")
    k = map_check[0]
    map_held(f"(D) first {k:,} SNVs", d_map[:k],
             cpu64.delta_scores_snv(wt, pos[:k], alts[:k]))
    held(f"(D) {n_s} SNVs", dev64.delta_scores_snv(wt, pos[:n_s], alts[:n_s], **kw),
         cpu64.delta_scores_snv(wt, pos[:n_s], alts[:n_s], **kw), n_s * mc)
    raw_snv = server.delta_scores_snv(wt, pos[:n_s], alts[:n_s], **kw)
    reductions_held(f"(D) {n_s} SNVs", d_ms[:n_s], raw_snv)

    # (E) arbitrary variants
    variants = make_variants(wt, n_variants)
    e_map = run(f"(E) {len(variants):,} variants, MAP", len(variants), "variants",
                lambda: server.delta_scores_variants(wt, variants))
    e_ms = run(f"(E) {len(variants):,} variants, MC-{mc}, reduce='mean_std'", len(variants),
               "variants", lambda: server.delta_scores_variants(wt, variants,
                                                                reduce="mean_std", **kw))
    check(e_map.shape == (len(variants),) and e_ms.shape == (len(variants), 2), "(E) shapes")
    k = map_check[1]
    map_held(f"(E) first {k:,} variants", e_map[:k],
             cpu64.delta_scores_variants(wt, variants[:k]))
    held(f"(E) {n_v} variants", dev64.delta_scores_variants(wt, variants[:n_v], **kw),
         cpu64.delta_scores_variants(wt, variants[:n_v], **kw), n_v * mc)
    del dev64, cpu64

    # (F) the score CLI on the YSD1 model
    def cli(argv, rows, header):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = score_cli.main(argv + ["--torch-device", torch.device(device).type])
        sec = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        vals = np.array([[float(x) for x in l.split("\t")[1:]] for l in lines[1:]])
        check(rc == 0 and lines[0] == header and len(lines) == rows + 1
              and np.isfinite(vals).all(), f"score_cli {argv[:1]} output: {lines[:2]}")
        print(f"[cli] score_cli {argv[0]} {' '.join(a for a in argv if a.startswith('--'))}"
              f": {rows:,} rows in {sec:.4f} s (model load included) [{card}]")

    cli_wt = "".join(np.random.default_rng(SEED).choice(list("ACGT"), cli_wt_bp))
    cli(["snv", ysd1_dir, cli_wt, "--all", "--sample", "--std"], 3 * cli_wt_bp,
        "variant\tBEAR\tmc_std")
    cli_vars = make_variants(cli_wt, 100, seed=1)
    cli(["variants", ysd1_dir, cli_wt, *cli_vars, "--device"], len(cli_vars),
        "target\tBEAR")
    cli(["seqs", ysd1_dir, *seqs[:CLI_READS], "--map"], min(CLI_READS, len(seqs)),
        "target\tAR\tBEAR")

    if profile:
        for label, fn in ((f"(C) serve {len(seqs)} reads MC-{mc} mean_std", score_ms),
                          (f"(D) {len(pos):,} SNVs MC-{mc} mean_std", snv_ms)):
            draw_ms, call_ms, bound_ms, bound_by = sampler_share(server, fn)
            print(f"[sample] {label}: keyed draws {draw_ms:.3f} ms of the call's "
                  f"{call_ms:.3f} ms on the device = {100 * draw_ms / call_ms:.1f}%; the "
                  f"draws' bound_ms {bound_ms:.6f} ({bound_by}) [{card}]")
            device_breakdown(label, fn, card, top=10)
            host_breakdown(label, fn, top=10)


def write_fastq(reads, groups, out_dir, n_train_files=N_TRAIN_FILES):
    """The reads as FASTQ: group 0 over ``n_train_files`` files (the second
    gzip-compressed), group 1 in one file, and an infiles.csv listing them.
    Returns (csv path, [(path, group, reads)])."""
    import gzip

    os.makedirs(out_dir, exist_ok=True)
    letters = np.frombuffer(b"ACGT", np.uint8)
    parts = [(idx, 0) for idx in np.array_split(np.flatnonzero(groups == 0), n_train_files)]
    parts.append((np.flatnonzero(groups == 1), 1))
    L = reads.shape[1]
    files = []
    for k, (idx, group) in enumerate(parts):
        head = np.frombuffer("".join(f"@r{i:09d}\n" for i in idx).encode(), np.uint8)
        rec = np.empty((len(idx), 12 + 2 * L + 4), np.uint8)  # @r + 9 digits + newline
        rec[:, :12] = head.reshape(len(idx), 12)
        rec[:, 12:12 + L] = letters[reads[idx]]
        rec[:, 12 + L:15 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 15 + L:15 + 2 * L] = ord("F")
        rec[:, -1] = ord("\n")
        path = os.path.join(out_dir, f"reads_{k}.fq" + (".gz" if k == 1 else ""))
        with (gzip.open(path, "wb", compresslevel=1) if k == 1 else open(path, "wb")) as fh:
            fh.write(rec.tobytes())
        files.append((path, group, len(idx)))
    csv = os.path.join(out_dir, "infiles.csv")
    with open(csv, "w") as fh:
        fh.writelines(f"{os.path.basename(p)},{g},fq\n" for p, g, _ in files)
    return csv, files


def codes_to_rows(codes, lag, A=4):
    """Table rows of int8 contexts ('[' coded A): the inverse of decode_rows."""
    c = np.asarray(codes, np.int64)
    suffix = (c != A).sum(axis=1)
    code = np.where(c == A, 0, c) @ (A ** np.arange(lag - 1, -1, -1, dtype=np.int64))
    return (A ** suffix - 1) // (A - 1) + code


def summarize_phase(reads, groups, want_rows, want_counts, work, card, device="cuda",
                    lag=LAG, profile=True):
    """4e, counting: write the reads as FASTQ, run the summarize CLI at
    ``-l lag`` on ``device`` through its parser, and read the lag-``lag``
    shards back. Checks that the native parser took every file, one
    count_chunk launch per chunk on the card, conservation (summarize's own
    check, at every lag) and that the shards hold exactly ``want_rows`` /
    ``want_counts`` (phase 4's nonzero rows and counts). With ``profile``,
    profiles the count loop on the card and the host side of the export.
    Returns what the later steps use."""
    import glob

    import torch
    from bear_tpu_torch.counting import summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.data import load_files

    t0 = time.perf_counter()
    csv, files = write_fastq(reads, groups, os.path.join(work, "reads"))
    write_s = time.perf_counter() - t0
    prefix = os.path.join(work, "counts", "run")
    os.makedirs(os.path.dirname(prefix))
    args = summarize.build_parser().parse_args(
        [csv, prefix, "-l", str(lag), "--device", torch.device(device).type])
    report = {}
    count_chunk_update.launches = 0
    t0 = time.perf_counter()
    n_bins, _ = summarize.main(args, report)
    synchronize(device)
    wall_s = time.perf_counter() - t0
    launches = count_chunk_update.launches
    run = report["forward"]
    stats = run["stats"]
    per_lag = stats["bases"] + stats["reads"]
    on_card = torch.device(device).type == "cuda"
    check(per_lag == len(reads) * (reads.shape[1] + 1), "summarize read another input")
    check(sorted(stats["parser"].values()) == ["native"] * len(files),
          f"not every file went through the native parser: {stats['parser']}")
    check(launches == (stats["chunks"] if on_card else 0),
          f"summarize launched count_chunk {launches} times for {stats['chunks']} chunks")
    print(f"[summarize] {len(files)} FASTQ files ({', '.join(os.path.basename(p) for p, _, _ in files)}; "
          f"{stats['reads']:,} reads) written in {write_s:.3f} s; parsers: "
          f"{sorted(set(stats['parser'].values()))} for all {len(files)}")
    print(f"[summarize] -l {lag}: {per_lag:,} transitions per lag x {lag} lags conserved; "
          f"parse {stats['parse_s']:.4f} s (inside the native parser, overlapped with "
          f"counting), count {run['count_s']:.4f} s = {lag * per_lag / run['count_s']:.6g} "
          f"transitions/s over all {lag} lags, export {run['export_s']:.4f} s = "
          f"{sum(run['rows'].values()) / run['export_s']:.6g} rows/s; whole CLI {wall_s:.3f} s "
          f"[{card}]")
    print(f"[summarize] table {run['table_bytes']:,} bytes (int32, lags 1..{lag} x "
          f"{N_GROUPS} groups) on {device}; {stats['chunks']} chunks, {launches} count_chunk "
          f"launches; {n_bins} shards per lag; nonzero rows per lag "
          f"{[run['rows'][l] for l in sorted(run['rows'])]}")

    shards = sorted(glob.glob(f"{prefix}_lag_{lag}_file_*.tsv"))
    check(len(shards) == n_bins, f"{len(shards)} lag-{lag} shards, expected {n_bins}")
    ds = load_files(shards, "dna", N_GROUPS)
    rows = codes_to_rows(ds.codes, lag)
    order = np.argsort(rows)
    check(np.array_equal(rows[order], want_rows)
          and np.array_equal(ds.counts[order], want_counts.astype(np.float64)),
          f"the lag-{lag} shards ({len(rows):,} rows) differ from phase 4's counts "
          f"({len(want_rows):,} rows)")
    print(f"[summarize] lag-{lag} shards read back with load_files: {len(rows):,} rows, "
          "both groups' counts == phase 4's exactly")
    if profile:
        # Where the time goes: the count loop on the card (counting alone,
        # a fresh table each run), and the host side of one lag's export.
        from bear_tpu_torch.counting.engine import write_tsv_shards

        device_breakdown(f"summarize count, lags 1..{lag}", lambda: summarize.run_counting(
            csv, range(1, lag + 1), device=device).sync(), card)
        out = os.path.join(work, "profile", "run")
        os.makedirs(os.path.dirname(out))
        host_breakdown(f"export of lag {lag} ({len(rows):,} rows, {n_bins} shards)",
                       lambda: write_tsv_shards(out, lag, want_rows, want_counts,
                                                int(np.log2(n_bins))), top=10)
    return dict(launches=launches, chunks=stats["chunks"], prefix=prefix, files=files,
                shards=shards)


def summarize_chunk_timing(first_file, card, dev, lag=LAG, reps=20):
    """count_chunk at the summarize geometry: the first chunk that
    chunks_from_packed makes of ``first_file`` (1,024 reads, padded), over
    lags 1..lag, held against its plain version (exact) and timed like
    phase 3. The byte bound counts the distinct 32-byte sectors the chunk's
    keys touch over all the lag tables; the library call is index_put_ on
    those keys. Returns the kernel's JSON fields for this geometry."""
    import torch
    from bear_tpu_torch.counting import count_chunk, engine, native
    from bear_tpu_torch.counting.count_chunk import count_chunk_plain, count_chunk_update

    codes_flat, offsets = native.load().parse(first_file, "fq")
    chunk = next(iter(engine.chunks_from_packed(codes_flat, offsets, 0, lag)))
    lags = tuple(range(1, lag + 1))
    meta_np = count_chunk.pack_meta(chunk.lengths, chunk.skip, chunk.stopped, chunk.groups,
                                    chunk.fresh)
    codes = torch.from_numpy(chunk.codes).to(dev)
    meta = torch.from_numpy(meta_np).to(dev)
    _, total = count_chunk.lag_offsets(lags, N_GROUPS)
    a = torch.zeros(total, dtype=torch.int32, device=dev)
    b = torch.zeros(total, dtype=torch.int32, device=dev)
    count_chunk_update(a, codes, meta, lags, N_GROUPS, 4)
    count_chunk_plain(b, codes, meta, lags, N_GROUPS, 4)
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max())
    check(torch.equal(a, b), f"count_chunk differs from plain on the summarize chunk: {err}")
    del b
    lengths, skip, stopped, grp, fresh = count_chunk.unpack_meta(meta)
    keys = count_chunk.chunk_keys(codes, lengths, skip, stopped, grp, lags, N_GROUPS, 4,
                                  sentinel=total, fresh=fresh)
    valid = keys[(keys >= 0) & (keys < total)].long()
    ones = torch.ones_like(valid, dtype=torch.int32)
    sectors = int(torch.unique(valid // 8).numel())
    l2_flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    ms = timed_ms(lambda: count_chunk_update(a, codes, meta, lags, N_GROUPS, 4), reps, l2_flush)
    plain_ms = timed_ms(lambda: count_chunk_plain(a, codes, meta, lags, N_GROUPS, 4), reps,
                        l2_flush)
    library_ms = timed_ms(lambda: a.index_put_((valid,), ones, accumulate=True), reps, l2_flush)
    n_pos = codes.shape[0] * (codes.shape[1] + 1)
    bytes_ms = (codes.numel() + 4 * meta.numel() + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_pos * (ROLL_OPS + KEY_OPS * len(lags)) / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[kernel] count_chunk at the summarize chunk: {codes.shape[0]:,} x {codes.shape[1]} "
          f"codes over lags 1..{lag} ({valid.numel():,} keys counted, {sectors:,} table "
          f"sectors of {total:,} int32): == plain, max_abs_err {err}; ms {ms:.6f} plain_ms "
          f"{plain_ms:.6f} bound_ms {bound_ms:.6f} ({bound_by}) library_ms {library_ms:.6f} "
          f"(index_put_ on the chunk's keys) [{card}]")
    return {"shape": list(codes.shape), "lags": len(lags), "max_abs_err": float(err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def stream_config(out_folder, counts_prefix, lag=LAG, cnn_kw=CNN_KW, batch=TRAIN_BATCH,
                  epochs=TRAIN_EPOCHS, seed=SEED):
    """The streaming training config of phase 4e: 4c's CNN BEAR on the
    lag-``lag`` shards, streamed with a per-epoch file order, the shard
    cache and mid-run checkpoints, evaluated held out (column 1) and as
    train-as-test."""
    cfg = ysd1_config(out_folder)
    cfg["general"]["seed"] = str(seed)
    cfg["data"].update(files_path=os.path.dirname(counts_prefix),
                       start_token=f"{os.path.basename(counts_prefix)}_lag_{lag}_file_",
                       num_ds=str(N_GROUPS))
    cfg["hyperp"]["lag"] = str(lag)
    cfg["train"].update(epochs=str(epochs), batch_size=str(batch), learning_rate=str(TRAIN_LR),
                        streaming="True", shuffle="True", cache="True",
                        checkpoint_every=str(STREAM_CHECKPOINT_EVERY))
    cfg["model"].update(ar_func_name="cnn", af_kwargs=json.dumps(cnn_kw))
    return cfg


def streaming_train_phase(prefix, shards, reads, groups, out_dir, card, device="cuda",
                          lag=LAG, cnn_kw=CNN_KW, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                          n_cli=CLI_READS, profile=True):
    """4e, training: the streaming training CLI on the lag-``lag`` shards,
    timed by wrapping its load, train and evaluation calls. Checks the
    first ELBOs against train_streaming on the CPU in float64 from the same
    initial parameters over the same shard stream, the streamed held-out
    perplexities against the in-memory evaluation of the concatenated
    shards on ``device``, that the mid-run state is gone and the shard
    cache is there, and scores held-out reads with the score CLI. With
    ``profile``, profiles one epoch of streamed training without loads."""
    import contextlib
    import io

    import torch
    from bear_tpu_torch.data import count_kmers, load_dense, load_files
    from bear_tpu_torch.inference import score_cli
    from bear_tpu_torch.models import bear_net, train_bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.checkpoint import TRAIN_STATE_FILE

    cfg = stream_config(out_dir + "*", prefix, lag, cnn_kw, batch, epochs)
    seed = int(cfg["general"]["seed"])
    cache = os.path.join(out_dir, "shard_cache")
    loads, spans, seen = [], {"eval": []}, {}
    real = (train_bear_net.load_files_cached, bear_net.train_streaming,
            bear_net.evaluation_streaming)

    def timed_load(files, *args, **kw):
        before = len(os.listdir(cache)) if os.path.isdir(cache) else 0
        t0 = time.perf_counter()
        out = real[0](files, *args, **kw)
        loads.append((time.perf_counter() - t0, len(os.listdir(cache)) == before))
        return out

    def timed_train(shard_fn, **kw):
        init = bear_net.init_params(torch.Generator().manual_seed(kw["seed"]), kw["ar_func"])
        seen.update(kw=kw, p0=[init["h_signed"]] + init["ar"])
        synchronize(device)
        t0 = time.perf_counter()
        seen["result"] = real[1](shard_fn, **kw)
        synchronize(device)
        spans["train"] = time.perf_counter() - t0
        return seen["result"]

    def timed_eval(*args, **kw):
        synchronize(device)
        t0 = time.perf_counter()
        out = real[2](*args, **kw)
        spans["eval"].append(time.perf_counter() - t0)
        return out

    train_bear_net.load_files_cached = timed_load
    bear_net.train_streaming, bear_net.evaluation_streaming = timed_train, timed_eval
    try:
        t0 = time.perf_counter()
        train_bear_net.main(cfg, device=device)
        synchronize(device)
        cli_s = time.perf_counter() - t0
    finally:
        train_bear_net.load_files_cached = real[0]
        bear_net.train_streaming, bear_net.evaluation_streaming = real[1], real[2]
    res, kw = seen["result"], seen["kw"]
    elbos = res.elbos
    F = len(shards)
    n_rows = kw["num_kmers"]
    n_batches = sum(-(-count_kmers([f]) // batch) for f in shards)
    check(len(elbos) == n_batches * epochs and np.isfinite(elbos).all(),
          f"{len(elbos)} ELBOs for {n_batches} batches x {epochs} epochs, or not finite")
    check(len(loads) == F * (epochs + 2), f"{len(loads)} shard loads, expected {F * (epochs + 2)}")
    per_epoch = [loads[e * F:(e + 1) * F] for e in range(epochs + 2)]
    check(not any(hit for _, hit in per_epoch[0]) and all(hit for _, hit in loads[F:]),
          "epoch 1 should parse every shard and every later load hit the cache")
    load_in_train = sum(t for t, _ in loads[: F * epochs])
    print(f"[stream] train_bear_net.main, streaming CNN BEAR {cnn_kw} on {F} lag-{lag} shards "
          f"({n_rows:,} rows), batch {batch}, {epochs} epochs, shuffle, cache, checkpoint_every "
          f"{STREAM_CHECKPOINT_EVERY}: {len(elbos)} applies in {spans['train']:.3f} s = "
          f"{len(elbos) / spans['train']:.6g} applies/s, of which shard loads "
          f"{load_in_train:.3f} s ({len(elbos) / (spans['train'] - load_in_train):.6g} "
          f"applies/s without them); the CLI run {cli_s:.3f} s; ELBO {elbos[0]:.7g} -> "
          f"{elbos[-1]:.7g} [{card}]")
    labels = [f"epoch {e + 1}" for e in range(epochs)] + ["held-out eval", "train-as-test eval"]
    print("[stream] shard loads: " + "; ".join(
        f"{label} {sum(t for t, _ in part):.4f} s ({sum(h for _, h in part)}/{F} cache hits)"
        for label, part in zip(labels, per_epoch)))
    print(f"[stream] streamed evaluation {' + '.join(f'{t:.3f}' for t in spans['eval'])} s "
          f"(held out, train-as-test) [{card}]")

    # The first ELBOs against CPU float64: the first shard of epoch 0's file
    # order, permuted as train_streaming permutes it, its first batches.
    order = list(range(F))
    np.random.default_rng([seed, 0]).shuffle(order)
    first = load_dense(shards[order[0]], "dna", N_GROUPS)
    perm = np.random.default_rng([seed, 0, 0]).permutation(first.num_kmers)
    k = min(N_ELBO_CHECK, -(-first.num_kmers // batch))
    take = perm[: k * batch]
    ar64 = get_ar_func("cnn", lag, 4, cnn_kw, dtype=torch.float64, device="cpu")
    ref = bear_net.train_streaming(
        lambda: iter([(first.codes[take], first.counts[take, 0])]), num_kmers=n_rows,
        ar_func=ar64, batch_size=batch, epochs=1, learning_rate=TRAIN_LR,
        params_restart=seen["p0"], dtype=torch.float64, device="cpu")
    elbo_err = float(np.max(np.abs(elbos[:k] / ref.elbos[:k] - 1)))
    check(len(ref.elbos) == k and elbo_err <= ELBO_RTOL,
          f"first {k} streamed ELBOs {elbos[:k]} differ from CPU float64 {ref.elbos} by "
          f"{elbo_err:.3e}")
    print(f"[stream] first {k} ELBOs vs train_streaming on the CPU in float64 from the same "
          f"initial parameters and shard stream: max rel err {elbo_err:.3e} (tolerance "
          f"{ELBO_RTOL})")

    results = cfg["results"]
    h = float(results["h"])
    ds = load_files(shards, "dna", N_GROUPS)
    synchronize(device)
    t0 = time.perf_counter()
    memory = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", h, kw["ar_func"],
                                 res.params["ar"], VAN_REG, dtype=torch.float32, seed=seed,
                                 device=device)
    memory_s = time.perf_counter() - t0
    streamed = [float(results["heldout_perplex_BEAR"]), float(results["heldout_perplex_AR"]),
                *json.loads(results["heldout_perplex_BMM"])]
    in_memory = [float(memory[3]), float(memory[4]), *np.asarray(memory[5]).tolist()]
    perp_err = float(np.max(np.abs(np.array(streamed) / np.array(in_memory) - 1)))
    check(perp_err <= EVAL_RTOL, f"streamed held-out perplexities {streamed} differ from "
          f"the in-memory evaluation's {in_memory} by {perp_err:.3e}")
    print(f"[stream] held-out perplexity BEAR {streamed[0]:.6f} AR {streamed[1]:.6f} BMM "
          f"{streamed[2:]}; vs in-memory evaluation on {device} ({memory_s:.3f} s) max rel "
          f"err {perp_err:.3e} (tolerance {EVAL_RTOL}); h {h:.6g}")
    cached = [f for f in os.listdir(cache) if f.endswith(".npz")]
    check(not os.path.exists(os.path.join(out_dir, TRAIN_STATE_FILE)) and len(cached) == F,
          f"after the run: train_state.pickle present or {len(cached)} cached shards of {F}")

    if profile:
        # Where streamed training's time goes without its shard loads: one
        # epoch over the shards held in memory, no checkpoints.
        held = [(d.codes, d.counts[:, 0]) for d in (load_dense(f, "dna", N_GROUPS)
                                                    for f in shards)]
        one = {k: v for k, v in kw.items() if k not in ("checkpoint_dir", "checkpoint_every")}
        one.update(epochs=1, writer=None)
        label = f"streamed training, 1 epoch over {F} shards held in memory"
        device_breakdown(label, lambda: bear_net.train_streaming(lambda: iter(held), **one),
                         card, top=10)
        host_breakdown(label, lambda: bear_net.train_streaming(lambda: iter(held), **one),
                       top=10)

    seqs = decode_reads(reads[np.flatnonzero(groups == 1)[:n_cli]])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = score_cli.main(["seqs", out_dir, *seqs, "--map", "--torch-device",
                             torch.device(device).type])
    cli_score_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    vals = np.array([[float(x) for x in l.split("\t")[1:]] for l in lines[1:]])
    check(rc == 0 and len(lines) == len(seqs) + 1 and np.isfinite(vals).all(),
          f"score_cli seqs on the streamed model: {lines[:2]}")
    print(f"[stream] train_state.pickle cleared, {len(cached)} shards cached; score_cli seqs "
          f"--map on {len(seqs)} held-out reads against the streamed model: finite, "
          f"{cli_score_s:.3f} s (model and counts load included) [{card}]")
    return len(elbos)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bear_tpu_torch import _build
    from bear_tpu_torch.counting import count_chunk, engine, window_hist
    from bear_tpu_torch.counting.count_chunk import count_chunk_plain, count_chunk_update
    from bear_tpu_torch.counting.window_hist import window_update, window_update_plain
    from bear_tpu_torch.inference.serving import BearServer
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import LinearAR

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: every kernel, one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = _build.build([window_hist.SOURCE, count_chunk.SOURCE])
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s")
    for p in libs.values():
        log = p.with_suffix(".log")
        if log.exists():
            print("[build] ptxas: " + " | ".join(
                l.strip() for l in log.read_text().splitlines() if l.strip()))

    # 3. kernels against their plain versions on the card
    hist_err = 0
    for name, base, keys in hist_edge_cases(dev):
        a = window_update(base.clone(), keys)
        b = window_update_plain(base.clone(), keys)
        torch.cuda.synchronize()
        err = int((a.long() - b.long()).abs().max())
        hist_err = max(hist_err, err)
        check(torch.equal(a, b), f"window_hist differs from plain on {name}: {err}")
        print(f"[kernel] window_hist == plain on {name} ({keys.numel()} keys)")

    count_err = 0

    def hold_count_chunk(name, lags, n_groups, A, passes):
        nonlocal count_err
        a, b = count_chunk_vs_plain(dev, lags, n_groups, A, passes)
        err = int((a.long() - b.long()).abs().max())
        count_err = max(count_err, err)
        check(torch.equal(a, b), f"count_chunk differs from plain on {name}: {err}")
        print(f"[kernel] count_chunk == plain on {name} ({len(passes)} launches, "
              f"{int(a.sum()):,} transitions, max_abs_err {err})")

    for name in COUNT_CASES:
        hold_count_chunk(name, *count_case(name))

    reads, groups = make_reads()
    n_reads = len(reads)
    chunks = list(read_chunks(reads, groups))
    _, total = count_chunk.lag_offsets((LAG,), N_GROUPS)
    c0 = chunks[0]
    meta0 = count_chunk.pack_meta(c0.lengths, c0.skip, c0.stopped, c0.groups, c0.fresh)
    hold_count_chunk("the main path's chunk 0", (LAG,), N_GROUPS, 4, [(c0.codes, meta0)])
    codes = torch.from_numpy(c0.codes).to(dev)
    meta = torch.from_numpy(meta0).to(dev)
    lengths, skip, stopped, grp, _ = count_chunk.unpack_meta(meta)

    def chunk0_keys():  # the earlier keys design's index math, on the card
        return count_chunk.chunk_keys(codes, lengths, skip, stopped, grp, (LAG,),
                                      N_GROUPS, 4, sentinel=total)

    keys = chunk0_keys()
    a = window_update(torch.zeros(total, dtype=torch.int32, device=dev), keys)
    b = window_update_plain(torch.zeros(total, dtype=torch.int32, device=dev), keys)
    err = int((a - b).abs().max())
    hist_err = max(hist_err, err)
    check(torch.equal(a, b), f"window_hist differs from plain on chunk 0: {err}")
    print(f"[kernel] window_hist == plain on the main path's chunk 0 ({keys.numel():,} keys)")
    del a, b

    table = torch.zeros(total, dtype=torch.int32, device=dev)
    l2_flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    valid = keys[(keys >= 0) & (keys < total)]
    valid_long = valid.long()
    ones = torch.ones_like(valid)
    sectors = int(torch.unique(valid // 8).numel())  # 8 int32 per 32 B sector
    n_keys = keys.numel()

    def hist(k):
        return lambda: window_update(table, k)

    kernel_ms = timed_ms(hist(keys), 20, l2_flush)
    plain_ms = timed_ms(lambda: window_update_plain(table, keys), 20, l2_flush)
    library_ms = timed_ms(
        lambda: table.index_put_((valid_long,), ones, accumulate=True), 20, l2_flush)
    bytes_ms = (4 * n_keys + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_keys / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[kernel] window_hist at the main path's chunk: {n_keys:,} keys "
          f"({valid.numel():,} valid, {sectors:,} table sectors) into "
          f"{total:,} int32: kernel_ms {kernel_ms:.6f} plain_ms {plain_ms:.6f} "
          f"library_ms {library_ms:.6f} (index_put_ accumulate) bound_ms "
          f"{bound_ms:.6f} ({bound_by}) [{card}]")

    # What holds the atomics back: (a) as above, (b) the same keys sorted
    # (same-address adds adjacent, sectors in address order), (c) without
    # the L2 eviction (the ~17 MB of touched sectors stay in the 50 MB L2),
    # (d) as many distinct keys in address order (8 adds per sector, no
    # repeats); then (a) again, as the turns run a, b, c, d, a.
    sorted_keys = torch.sort(keys).values
    dense_keys = torch.arange(n_keys, dtype=torch.int32, device=dev)
    abl = [timed_ms(hist(keys), 20, l2_flush), timed_ms(hist(sorted_keys), 20, l2_flush),
           timed_ms(hist(keys), 20, None), timed_ms(hist(dense_keys), 20, l2_flush),
           timed_ms(hist(keys), 20, l2_flush)]
    distinct = int(torch.unique(valid).numel())
    lines = int(torch.unique(valid // 32).numel())  # 32 int32 per 128 B L2 line
    print(f"[ablation] window_hist on chunk 0's keys ({distinct:,} distinct, {lines:,} "
          f"128 B lines; (d): {n_keys // 32:,} lines): (a) as "
          f"today {abl[0]:.6f} ms, (b) sorted {abl[1]:.6f} ms, (c) without L2 eviction "
          f"{abl[2]:.6f} ms, (d) distinct keys in address order {abl[3]:.6f} ms, "
          f"(a) again {abl[4]:.6f} ms [{card}]")
    del sorted_keys, dense_keys

    count_ms = timed_ms(
        lambda: count_chunk_update(table, codes, meta, (LAG,), N_GROUPS, 4), 20, l2_flush)
    count_plain_ms = timed_ms(
        lambda: count_chunk_plain(table, codes, meta, (LAG,), N_GROUPS, 4), 20, l2_flush)
    earlier_ms = timed_ms(lambda: window_update(table, chunk0_keys()), 20, l2_flush)
    n_pos = codes.shape[0] * (codes.shape[1] + 1)
    count_bytes_ms = (codes.numel() + 4 * meta.numel() + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    count_ops_ms = n_pos * (ROLL_OPS + KEY_OPS) / FP32_OPS_PER_S * 1e3
    count_bound_ms = max(count_bytes_ms, count_ops_ms)
    count_bound_by = "bytes" if count_bytes_ms >= count_ops_ms else "operations"
    print(f"[kernel] count_chunk at the main path's chunk: {codes.shape[0]:,} x "
          f"{codes.shape[1]} codes, {n_pos:,} positions ({valid.numel():,} counted, "
          f"{sectors:,} table sectors): ms {count_ms:.6f} plain_ms {count_plain_ms:.6f} "
          f"bound_ms {count_bound_ms:.6f} ({count_bound_by}) earlier_ms {earlier_ms:.6f} "
          f"(chunk_keys + window_hist) library_ms {library_ms:.6f} (index_put_ on the "
          f"chunk's keys) [{card}]")
    del table, l2_flush, valid, valid_long, ones, keys, codes, meta
    del lengths, skip, stopped, grp
    torch.cuda.empty_cache()

    # 4. main path: counts set to 0 just before it, read just after
    window_update.launches = 0
    count_chunk_update.launches = 0
    t0 = time.perf_counter()
    counter = engine.TransitionCounter(lags=[LAG], n_groups=N_GROUPS)
    for i, chunk in enumerate(chunks):
        counter.add_chunk(chunk)
        if i == 0:  # the table and the first pinned staging set are allocated
            counter.sync()
            first_s = time.perf_counter() - t0
    counter.sync()
    count_s = time.perf_counter() - t0
    expected = n_reads * (READ_LEN + 1)
    counter.validate(expected)
    # Phase 4e's reference: the nonzero rows and their counts, read on the card.
    p4_rows = counter.nonzero_rows(LAG)
    p4_counts = counter.row_counts(LAG, p4_rows)
    tables = counter.tables[LAG]
    distinct = int(np.count_nonzero(tables[0].sum(axis=1)))
    print(f"[count] {n_reads:,} reads, {expected:,} transitions at lag {LAG} "
          f"conserved; {distinct:,} distinct train contexts")
    print(f"[count] {count_s:.4f} s = {expected / count_s:.6g} transitions/s; the "
          f"first chunk (with the table's and staging's allocation) {first_s:.4f} s, "
          f"the other {len(chunks) - 1} chunks {count_s - first_s:.4f} s "
          f"[{card}]")

    test_reads = reads[np.flatnonzero(groups == 1)[:N_SCORE]]
    seqs = decode_reads(test_reads)
    ar = LinearAR(LAG, 4, generator=torch.Generator().manual_seed(SEED))
    server = BearServer(tables[0], LAG, h=H, ar_apply=ar)
    server.score(seqs)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = server.score(seqs)
    serve_s = time.perf_counter() - t0
    launches = count_chunk_update.launches
    hist_launches = window_update.launches
    print(f"[serve] {len(seqs)} held-out reads, MAP: {serve_s:.4f} s = "
          f"{len(seqs) / serve_s:.6g} sequences/s [{card}]")
    check(launches == len(chunks),
          f"the main path launched count_chunk {launches} times for {len(chunks)} chunks")
    print(f"[count] kernel launches on the main path: count_chunk {launches} "
          f"({len(chunks)} chunks), window_hist {hist_launches} (off the main path)")

    # The main path's table allocation, alone.
    del counter
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh_table = torch.zeros(total, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    print(f"[count] set-up alone: table of {total:,} int32 allocated and zeroed on "
          f"the card in {time.perf_counter() - t0:.4f} s [{card}]")
    del fresh_table
    torch.cuda.empty_cache()

    # Where the main path's time goes (after its counts were read), in
    # steady state: the table and both pinned staging sets are allocated
    # before the windows.
    prof_counter = engine.TransitionCounter(lags=[LAG], n_groups=N_GROUPS)
    for chunk in chunks[:2]:
        prof_counter.add_chunk(chunk)

    def count_four(first):
        def run():
            for chunk in chunks[first : first + 4]:
                prof_counter.add_chunk(chunk)
            prof_counter.sync()
        return run

    device_breakdown("count, 4 chunks", count_four(2), card)
    host_breakdown("count, 4 chunks", count_four(10))
    device_breakdown(f"serve, {len(seqs)} reads", lambda: server.score(seqs), card)
    del prof_counter
    torch.cuda.empty_cache()

    ar64 = LinearAR(LAG, 4, dtype=torch.float64, device="cpu")
    ar64.load_params([ar.mat.detach().cpu()])
    ref = BearServer(tables[0], LAG, h=H, ar_apply=ar64, dtype=torch.float64,
                     device="cpu").score(seqs)
    check(scores.shape == (len(seqs),) and np.isfinite(scores).all(),
          "scores are not finite of the expected shape")
    diff = np.abs(scores - ref)
    check(bool((diff <= SCORE_ATOL + SCORE_RTOL * np.abs(ref)).all()),
          f"GPU float32 scores differ from CPU float64: max {diff.max()}")
    print(f"[serve] float32 card vs float64 CPU: max |diff| {diff.max():.3e} "
          f"(tolerance {SCORE_ATOL} + {SCORE_RTOL}*|score|); scores "
          f"{ref.min():.3f}..{ref.max():.3f}")
    train_table = tables[0]  # the main path's counts, for phase 4d
    del server, tables, ar, ar64
    torch.cuda.empty_cache()

    # 4b. the published YSD1 protocol through the training CLI;
    # 4c. count -> on-device handoff -> CNN training -> evaluation -> serve;
    # 4d. sampled serving and variant scoring with 4c's model, on the main
    # path's table, and the score CLI on 4b's model
    with tempfile.TemporaryDirectory() as tmp:
        ysd1, ysd1_kw = ysd1_phase(os.path.join(tmp, "ysd1"), card)
        launches_4c, codes_d, counts_d, cnn, p0, n_rows = lag13_train_phase(
            chunks, reads, groups, os.path.join(tmp, "cnn"), card)
        check(launches_4c == len(chunks),
              f"4c launched count_chunk {launches_4c} times for {len(chunks)} chunks")
        torch.cuda.empty_cache()
        window_update.launches = 0
        count_chunk_update.launches = 0
        sampled_phase(train_table, LAG, os.path.join(tmp, "cnn"), os.path.join(tmp, "ysd1"),
                      seqs, genome_prefix(DMS_BP), card)
        print(f"[sample] kernel launches in phase 4d: count_chunk "
              f"{count_chunk_update.launches}, window_hist {window_update.launches} "
              "(the sampler and the Δ window math are PyTorch ops)")
    del train_table
    torch.cuda.empty_cache()

    # Where training's time goes.
    def ysd1_200():
        bear_net.train(ysd1.codes, ysd1.counts[:, 0], epochs=200, **ysd1_kw)

    device_breakdown("train YSD1 linear BEAR, 200 applies", ysd1_200, card, top=10)
    host_breakdown("train YSD1 linear BEAR, 200 applies", ysd1_200, top=10)
    n_prof = 20 * TRAIN_BATCH
    device_breakdown("train lag-13 CNN BEAR, 20 applies",
                     lambda: bear_net.train(codes_d[:n_prof], counts_d[:n_prof, 0],
                                            num_kmers=n_rows, ar_func=cnn,
                                            batch_size=TRAIN_BATCH, epochs=1,
                                            learning_rate=TRAIN_LR, params_restart=p0,
                                            dtype=torch.float32), card, top=10)

    # 4e. the on-disk workflow: reads as FASTQ -> summarize -l 13 (its
    # count_chunk launches counted from 0 just before, read just after) ->
    # lag-13 TSV shards -> the streaming training CLI -> scoring
    t_4e = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        s_run = summarize_phase(reads, groups, p4_rows, p4_counts, os.path.join(tmp, "disk"),
                                card)
        torch.cuda.empty_cache()
        s_chunk = summarize_chunk_timing(s_run["files"][0][0], card, dev)
        torch.cuda.empty_cache()
        streaming_train_phase(s_run["prefix"], s_run["shards"], reads, groups,
                              os.path.join(tmp, "stream"), card)
    count_err = max(count_err, int(s_chunk["max_abs_err"]))
    print(f"[stream] phase 4e {time.perf_counter() - t_4e:.3f} s (profiles and checks "
          f"included) [{card}]")

    # 5. kernels, then the device line
    print(json.dumps({"kernels": [{
        "name": "window_hist", "route": "cuda",
        "source": "bear_tpu_torch/csrc/window_hist.cu",
        "replaces": "bear_tpu/counting/pallas_hist.py:81",
        "launches": hist_launches, "max_abs_err": float(hist_err),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }, {
        "name": "count_chunk", "route": "cuda",
        "source": "bear_tpu_torch/csrc/count_chunk.cu",
        "replaces": "bear_tpu/counting/pallas_hist.py:81",
        "launches": launches + s_run["launches"],
        "launches_by_path": {"count_serve": launches, "summarize": s_run["launches"]},
        "max_abs_err": float(count_err),
        "ms": count_ms, "plain_ms": count_plain_ms, "bound_ms": count_bound_ms,
        "bound_by": count_bound_by, "library_ms": library_ms,
        "summarize_chunk": s_chunk,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
