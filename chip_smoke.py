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
5. one JSON line of the kernels, then the device line, last.

Needs one CUDA card. Imports nothing of JAX and nothing of bear_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
        if e.device_type == DeviceType.CUDA and us > 0:
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
