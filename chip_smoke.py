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
    del server, tables, ar, ar64
    torch.cuda.empty_cache()

    # 4b. the published YSD1 protocol through the training CLI;
    # 4c. count -> on-device handoff -> CNN training -> evaluation -> serve
    with tempfile.TemporaryDirectory() as tmp:
        ysd1, ysd1_kw = ysd1_phase(os.path.join(tmp, "ysd1"), card)
        launches_4c, codes_d, counts_d, cnn, p0, n_rows = lag13_train_phase(
            chunks, reads, groups, os.path.join(tmp, "cnn"), card)
    check(launches_4c == len(chunks),
          f"4c launched count_chunk {launches_4c} times for {len(chunks)} chunks")
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
        "launches": launches, "max_abs_err": float(count_err),
        "ms": count_ms, "plain_ms": count_plain_ms, "bound_ms": count_bound_ms,
        "bound_by": count_bound_by, "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
