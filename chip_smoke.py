#!/usr/bin/env python3
"""Drive the PyTorch port's whole path once on one CUDA card, and check it.

    python3 chip_smoke.py

This is the card gate: it checks the path, it does not measure it. Each
fact about the card has one home: a kernel against its plain version on
edge cases and at launch edges is tests/test_torch_cuda.py's (pytest -m
cuda); the speed of a path is a cell of bench_gpu/; this script holds the
whole path at genome scale against the CPU in float64, the published
results and the launch counts per path, and times each kernel alone beside
its bound (the kernels line; keyed_draw_timing.py and count_chunk_timing.py
time one kernel in turns against another checkout).

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: every kernel, from bear_tpu_torch/csrc (one nvcc per source, all
   started together), with ptxas's report;
3. kernels: window_hist (keys -> counts, off the main path) and count_chunk
   (codes -> counts, the main path's kernel) against their plain versions
   on the main path's chunk 0 (exact), then each timed alone there beside
   its bound and a library call, with count_chunk's launch shape;
4. main path: the examples/genome_lag13.py workload — a 4.6 Mb synthetic
   genome (seed 0) cut into 150 bp reads at coverage 10, train/test groups —
   counted at lag 13 by TransitionCounter on the card (conservation; one
   count_chunk launch per chunk), then 4,096 held-out reads scored by
   BearServer (MAP) with a seeded lag-13 LinearAR, against the port on the
   CPU in float64;
4b. the published YSD1 protocol: train_bear_net.main on bear_lin_bear.cfg's
   values in float32 (10,000 Adam applies, held-out and train-as-test
   evaluation); h and the BEAR held-out perplexity against the published
   values, BMM against the port's CPU float64 evaluation;
4c. training on the main path: the same chunks counted again into a fresh
   TransitionCounter and handed off on the card (to_device_dataset, before
   any flush; conservation), a CNN BEAR of examples/genome_lag13.py's widths
   trained (its first ELBOs against CPU float64), evaluated, written,
   reloaded by load_bear and served to the 4,096 held-out reads (against
   CPU float64);
4d. posterior-sampled serving and variant scoring from the main path's
   table with 4c's reloaded CNN: (C) the 4,096 held-out reads at MC-41 (41
   posterior draws, reduce "mean_std" and "none"); (D) the 30,000 SNVs of
   the genome's first 10 kb, MAP and MC-41; (E) 10,000 seeded SNVs,
   substitutions, insertions and deletions on the same 10 kb, MAP and
   MC-41; (F) the score CLI on 4b's YSD1 model. MAP against the CPU in
   float64; sampled float64 on the card against the CPU from the same keys,
   on subsets; the in-call reductions against the raw draws; each call's
   peak device memory within PEAK_BUDGET of what is resident. (C)'s draw
   input holds keyed_draw against its plain version (float32 and float64,
   picked and full; and (K)'s per-step draw), (C)'s AR slices hold
   cnn_forward against the plain forward (float32 and float64), and each
   is timed alone there beside its bound. keyed_draw's launches are counted
   on (C)-(F) and 4f (K) and 4g (O), cnn_forward's on (C)-(E), each path
   from 0 just before it, none of them its narrow instance's; (Cp) the
   protein cell's CNN (lag 6, 30 filters, 16 hidden units) over its
   proteome's lag-6 table, one MC-41 call of 2,048 held-out proteins, every
   cnn_forward launch the narrow instance's, its AR slices held against the
   plain forward (float32 and float64) and timed alone beside the bound;
4e. the on-disk workflow: phase 4's reads written as FASTQ (the train group
   over 3 files, one gzip-compressed; the held-out group in 1), the
   summarize CLI at -l 13 on the card (the native parser for every file, one
   count_chunk launch per chunk over all 13 lag tables, conservation at
   every lag, the lag-13 shards equal to phase 4's counts), count_chunk held
   and timed alone on a summarize chunk over 13 lags, then the streaming
   training CLI on the lag-13 shards (4c's CNN BEAR, shuffle, shard cache,
   checkpoints every 32 applies: first ELBOs against CPU float64 from the
   same start and stream, epoch 1 parsing every shard and every later load
   hitting the cache, streamed held-out perplexities against the in-memory
   evaluation, the mid-run state cleared) and the score CLI on its model;
4f. generation and the other models, in 4e's directory: (H) the reads as
   groups 0 and 1 and the genome's unmutated template as reference group 2,
   counted at lag 13 (conservation), handed off on the card, the
   reference-guided CNN BEAR trained (first ELBOs against CPU float64) and
   evaluated, then the reference-guided CLI on YSD1 (BMM against
   bmm_likelihood); (I) vBEAR on YSD1, 3,000 applies (h within 25% of
   0.0433, sigma below 0.25); (J) lag selection at lags 1..13 by the
   resident table of a recount, the TSV shards and both CLI routes (all
   agree); (K) the assembly CLI on 4e's reads with 4e's streamed CNN, 64
   seeds x 16 samples, 500 letters each side, sampled and MAP (its FASTA
   checked; its count and generation called apart give its sequences), and
   float64 rollouts on the card, BMM and BEAR, against the CPU sequence for
   sequence;
4g. counting beyond the dense table, in 4e's directory: count_chunk's
   row-range form held against its plain version on a summarize chunk in
   every pass and timed alone in pass 0; (L) the summarize CLI at -l 15 in
   the fewest row-range passes the int32 guard takes (9: one count_chunk
   launch per chunk and pass); (M) the summarize CLI at -l 20, which routes
   itself to the sparse-first counter (no count_chunk launch; 4 chunks on
   the card against the CPU), then 200 linear-BEAR applies on its lag-20
   rows (first ELBOs against CPU float64); the nonzero rows of every lag
   against a plain torch.unique recount, and the shards of lags 1..13 byte
   for byte against 4e's and of lags 14-15 against each other; (N)
   select_lag over (M)'s counter (lags 1..13 against (J)) and
   lag_select_cli -l 15 --passes 9; (O) the held-out reads scored at lag 20
   through TableCounter on (M)'s counter (against CPU float64), BMM
   assembly at lag 20 from a SparseTableIndex (float64 card against CPU),
   and at lag 13 the sparse index against the dense table;
4h. the remaining model options: (P) the attention BEAR of
   bear_attn_bear.cfg through train_bear_net.main on YSD1 in float32 (10,000
   Adam applies; its first ELBOs and its held-out perplexities, evaluated by
   the attention_forward kernel, against CPU float64 from the same
   parameters; the BEAR perplexity against the first card run's); the
   lag-13 attention AR served at MC-41 through BearServer.score on the main
   path's table and reads (one attention_forward launch an AR slice); then
   the kernel held against the plain block at a genome13_attn_score_mc41
   call's AR slices (ATTN_SLICES) in both float types and timed alone there
   beside its bound; (Q) the seven optax optimizers (adamw, adamax, rmsprop,
   adagrad, nadam, adadelta, lion) on the YSD1 linear BEAR, 200 float64
   applies on the card against the CPU, then 200 float32 applies of each
   (and of Adam) finite; (R) bfloat16 compute on 4c's lag-13 handoff, the
   CNN and a lag-13 attention AR, each against float32 from the same start
   (last ELBO within 1%, float32 probabilities summing to 1), with one
   bfloat16 run traced by utils.profiling.trace (the trace lists a kernel);
4i. counting across devices and processes, one card playing every device
   of each mesh: (S) count -> serve's chunks through
   ShardedTransitionCounter with rows split over 2 replicas of the lag-13
   table (each replica after chunk 0 against count_chunk_plain on its
   rows, the tables against phase 4's, 2 launches per chunk); (T) 4e's
   files at lags 1..14 through KmerShardedTransitionCounter over 3 row
   ranges (the int32 reckoning: 2 refused), summarize's iter_chunks and
   export, shards of lags 1..13 byte for byte against 4e's and of lag 14
   against summarize -l 14 --passes 3, 3 launches per chunk, and summarize
   --kmer-shards 3 refused on one card; (U) (M)'s -l 20 through
   SparseTransitionCounter with rows over 2 replicas, every shard against
   (M)'s; (V) two processes on the card joined by multihost.initialize
   over TCP on 127.0.0.1, each counting its host_shard of count -> serve's
   chunks (lag 13) and of 4e's files (-l 20), merged twice by
   allreduce_tables, every rank's tables against phase 4's and (U)'s
   (python3 chip_smoke.py --child SPEC RANK runs one process; a child that
   fails or outlasts its timeout fails the run);
4j. data parallelism on the card, one card playing each mesh's entries:
   (W) count -> serve's chunks counted again and handed off, 4c's CNN BEAR
   over a 2-entry data mesh: 5 float64 applies on the mesh against off it,
   4c's float32 protocol (first ELBOs against 4c's CPU float64),
   evaluation(mesh=) against evaluation in float64, train_streaming(mesh=)
   on 4e's lag-13 shards (32 applies, a checkpoint every 16, resumed after
   completion) and evaluation_streaming(mesh=) against the calls without;
   (X) train_bear_net.main with [train] data_parallel = True on YSD1 (h and
   BEAR as 4b), train_bear_ref.main over the mesh (BMM against
   bmm_likelihood), vBEAR over it (200 float64 applies against off it, then
   4f (I)'s protocol); (Y) 4c's CNN served by from_model_dir(mesh=) with
   the lag-13 table's rows split over a 2-entry kmer mesh (MAP bits equal
   to 4c's unsplit server's; float64 MAP, MC-41 and SNV Δ against
   unsplit), bmm_likelihood(mesh=); (Z) in (V)'s children, after their
   dense merge: (W)'s CNN trained 16 float32 applies and evaluated over a
   mesh that spans both processes (ranks bit-equal, first ELBOs against
   (W)'s), and YSD1 train_streaming resumed from a shared checkpoint
   directory and aborted on diverged rank-local ones;
4k. the example programs, at their defaults on the card: (AA)
   examples/torch_genome_lag13.py's main([]) in this process (19
   count_chunk launches, 4c's rows, conservation, BMM against 4c's); (AB)
   examples/torch_multihost_counting.py --nproc 2 --bench (two gloo
   processes on the card, lags 1..5, 4 files x 20,000 reads x 150 bp; its
   bench line's transitions); (AC) examples/torch_multihost_train.py
   --nproc 2 --bench, then with --streaming (ranks' h bit-equal, the same
   k-mers in both);
5. one JSON line of the kernels (launches by path, errors, times alone),
   then the device line, last.

Needs one CUDA card. Imports nothing of JAX and nothing of bear_tpu.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# The main path's workload is the genome example's: its genome, reads and
# constant-shape chunks (zero-length pad rows fill the last).
from examples.torch_genome_lag13 import read_chunks, synth_genome, synth_reads

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
# The keyed-draw kernel against its plain version on the card: float64 at
# rtol 1e-12 and float32 at 2e-6 of the operands' scale (keyed_draw_vs_plain),
# at most SAMPLED_FLIPS of the lanes beyond (an accept test flipped by an
# ulp). Its cases: both alphabets' rows, each proposal count, both types and
# modes, on KEYED_DRAW_SHAPE = (samples, elements, groups) with the element
# count not a multiple of the 128-thread block.
KEYED_DRAW_RTOL = {"float64": 1e-12, "float32": 2e-6}
KEYED_DRAW_CASES = [(A1, F, dtype, mode) for A1 in (5, 21) for F in (3, 4, 6)
                    for dtype in ("float32", "float64") for mode in ("picked", "full")]
KEYED_DRAW_SHAPE = (3, 1037, 50)
# keyed_draw_timing.py's seeded draw inputs at the main path's shapes,
# (samples, elements, groups), type, proposals, mode: (C)'s draw (41
# samples of 618,496 transitions of 4,096 reads), in both types; (E)'s
# (289,737 window transitions under one sample key each); (K)'s per-step
# draw (one row for each of 64 seeds x 16 sequences, sequence b under group
# b, assembly's 4 proposals, the whole row).
KEYED_DRAW_FORMS = {
    "C_float32": ((41, 618_496, 4096), "float32", 3, "picked"),
    "C_float64": ((41, 618_496, 4096), "float64", 3, "picked"),
    "E_float32": ((41, 289_737, 1), "float32", 3, "picked"),
    "K_step": ((1, 1024, 1024), "float32", 4, "full"),
}
# The paths that draw through keyed_draw: (C), (D), (E), (F), (K) as the CLI
# and its generation called apart, (O).
KEYED_DRAW_PATHS = ("sampled_serving", "snv_scan", "variants", "score_cli", "assemble_cli",
                    "assemble", "sparse_assembly")
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
# Phase 4f: generation and the other models. (H) the reference-guided CNN BEAR
# on count -> serve's reads with the genome's template counted as the
# reference group; (I) vBEAR on YSD1 (docs/usage.md:176-185); (J) lag
# selection over (G) by every route (float64 sums: the routes agree to
# reassociation); (K) the assembly CLI on (G)'s reads with the streamed CNN,
# and a float64 rollout on the card against the CPU from a small table,
# where only a Gumbel near-tie may pick another letter.
N_REF_GROUPS = 3
VBEAR_APPLIES = 3000
YSD1_VBEAR_H, VBEAR_H_RTOL, VBEAR_SIGMA_MAX = 0.0433, 0.25, 0.25
LAG_SELECT_RTOL = 1e-10
ASM_SEEDS, ASM_NUM, ASM_FLANK, ASM_SEED_BP = 64, 16, 500, 150
ASM_CHECK = (8, 4, 8, 50)  # seeds, samples, lag, letters each side
ASM_MARGIN = 1e-12
# Phase 4g: counting beyond the dense table, in 4e's directory on (G)'s FASTQ
# files. (L) summarize -l 15 in the fewest row-range passes the int32 guard
# takes; (M) summarize -l 20 (the sparse-first counter), then linear-BEAR
# applies on its lag-20 rows; (N) lag selection over (M)'s counter and the
# CLI's --passes route; (O) scoring and BMM generation at lag 20 from the
# sparse table. count_chunk's row-range form is held against its plain
# version on each SHARD_CASES input split over that many passes, on a
# poly-T lag-15 chunk and on an (L) chunk in every pass.
PASSES_LAG = 15
SPARSE_LAG = 20
SHARD_CASES = [("multi_lag_1_4_7", 3), ("reverse", 2), ("ambig_not_fresh", 5),
               ("segmented_skip", 7), ("zero_length_rows", 2), ("protein_lag6", 4)]
SPARSE_CHECK_CHUNKS = 4
SPARSE_APPLIES = 200
# Phase 4h: the remaining model options. (P) the attention BEAR of
# bear_attn_bear.cfg on YSD1 through the training CLI in float32, its first
# ELBOs and its evaluation against CPU float64 from the same parameters; (Q)
# the seven optax optimizers on the YSD1 linear BEAR, float64 on the card
# against the CPU (the same update rules, summed in another order), then
# finite in float32; (R) bfloat16 compute of the AR network on 4c's lag-13
# handoff, CNN and attention, each against float32 from the same start
# (tests/test_ar_funcs.py:244's 1%).
ATTN_KW = {"d_model": 64, "num_heads": 4, "mlp_width": 128}
ATTN_LR = 0.002
# The attention BEAR's held-out perplexity, from the port's first card run
# of (P) (NVIDIA H100 80GB HBM3, 700 W): BEAR 3.790651 (the counts dominate,
# as the linear BEAR's 3.790637), held within 0.01 as (A)'s.
ATTN_PERPLEXITY, ATTN_PERPLEXITY_ATOL = 3.790651, 0.01
OPTAX_NAMES = ["adamw", "adamax", "rmsprop", "adagrad", "nadam", "adadelta", "lion"]
OPT_CHECK_APPLIES = 200
OPT_RTOL = 1e-9
BF16_EPOCHS = 3  # 108 applies of 2^15 rows on 4c's 1,158,428
BF16_LOSS_RTOL = 1e-2
BF16_SUM_ATOL = 1e-5
# Phase 4i: counting across devices and processes. One card plays each mesh:
# (S) count -> serve's chunks split by rows over 2 replicas of the lag-13
# table; (T) (G)'s files at lags 1..14 over 3 row ranges (1.59e9 int32
# entries each; 2 would need 2.39e9, past the int32 guard); (U) (M)'s lag-20
# count with rows over 2 replicas; (V) 2 processes on the card, merged over
# gloo. Every result is held exactly.
MESH_DATA = 2
MESH_ROWS = 3
MESH_ROW_LAG = 14
MESH_PROCS = 2
CHILD_TIMEOUT_S = 600
# Phase 4j: data parallelism on the card. (W) 4c's CNN BEAR over a mesh that
# names the card twice: float64 on it against off it at bear_tpu's shard-
# invariance tolerance (tests/test_bear_net.py:243-278), parameters with an
# atol for those near 0; the float32 protocol within ELBO_RTOL of CPU
# float64; 32 streamed applies with a checkpoint every 16. (X) the CLIs and
# vBEAR (200 float64 applies at MESH_RTOL). (Y) row-split serving: float32
# bit-equal (the gather is exact), float64 at 1e-12, as bear_tpu's
# tests/test_serving.py:120-155. (Z) 16 applies over two processes.
MESH_TRAIN = 2
MESH_F64_APPLIES = 5
MESH_RTOL, MESH_ATOL = 1e-9, 1e-12
MESH_STREAM_APPLIES, MESH_STREAM_EVERY = 32, 16
MESH_VBEAR_CHECK = 200
SPLIT_RTOL = 1e-12
SPLIT_READS, SPLIT_SNV_BP = 256, 1000
Z_APPLIES = 16
# Phase 4k: the example programs at their defaults. (AA) is 4c's count ->
# train -> evaluate, so its handoff has 4c's rows and its BMM perplexities
# (which do not depend on training) 4c's, up to float32 batch sums.
GENOME_ROWS = 1_158_428
GENOME_TRANSITIONS = 306_666 * 151  # reads x (150 bases + 1 stop)
GENOME_BMM_RTOL = 1e-6
MH_COUNT_TRANSITIONS = 4 * 20_000 * 151  # files x reads x (150 bases + 1 stop)
EXAMPLE_TIMEOUT_S = 600


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


def attn_config(out_folder):
    """The values of bear_tpu/models/config_files/bear_attn_bear.cfg
    (attention BEAR, lag 5, d_model 64, 4 heads, mlp 128, batch 1500,
    10,000 epochs = 10,000 Adam applies, lr 0.002, seed 10), in float32, on
    the port's bundled YSD1 counts."""
    cfg = ysd1_config(out_folder)
    cfg["train"]["learning_rate"] = str(ATTN_LR)
    cfg["model"]["ar_func_name"] = "attention"
    cfg["model"]["af_kwargs"] = json.dumps(ATTN_KW)
    return cfg


def make_reads(genome_mb=GENOME_MB, coverage=COVERAGE, read_len=READ_LEN,
               seed=SEED):
    """(reads [n, read_len] int8, groups [n] int32: 1 = held-out test):
    examples/torch_genome_lag13.py's reads, by default at its size."""
    return synth_reads(genome_mb, coverage, read_len, seed)


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


def device_ms(fn, reps, l2_flush=None, sleep_cycles=2_000_000):
    """Mean device time of fn over reps calls, warmed up: the L2 evicted
    (``l2_flush`` zeroed; None: not evicted), then a sleep kernel (~1 ms)
    keeps the card busy while the host enqueues fn, so that the events
    bracket fn's kernels and not the host's work around them."""
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
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def ysd1_phase(out_dir, device="cuda"):
    """4b: the published YSD1 protocol through the training CLI's ``main``
    in float32; checks h and the BEAR held-out perplexity against the
    published values and the BMM perplexities against the port's CPU
    float64 evaluation."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net, train_bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.checkpoint import load_params_list, load_results
    from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path

    cfg = ysd1_config(out_dir + "*")
    run = RunConfig.from_configparser(cfg)
    train_bear_net.main(cfg, device=device)
    res = cfg["results"]  # main writes its results into the config
    applies = load_results(out_dir)["torch_opt_state"]["step"]
    h = float(res["h"])
    perp = {k: json.loads(res[f"heldout_perplex_{k}"]) for k in ("BEAR", "AR", "BMM")}
    acc = {k: json.loads(res[f"heldout_accuracy_{k}"]) for k in ("BEAR", "AR", "BMM")}

    ds = load_dense(bundled_ysd1_path(), "dna", run.num_ds)
    ar64 = get_ar_func("linear", run.lag, 4, dtype=torch.float64, device="cpu")
    ref = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", h, ar64,
                              load_params_list(out_dir)[1:], VAN_REG,
                              dtype=torch.float64, device="cpu")
    bmm_err = float(np.max(np.abs(np.asarray(perp["BMM"]) / ref[5] - 1)))
    print(f"[ysd1] train_bear_net.main, bear_lin_bear.cfg values in float32: {applies:,} "
          f"optimizer applies; h {h:.6g} (published {YSD1_H}); held-out perplexity BEAR "
          f"{perp['BEAR']:.6f} AR {perp['AR']:.6f} BMM {perp['BMM']}; accuracy BEAR "
          f"{acc['BEAR']:.6f} AR {acc['AR']:.6f} BMM {acc['BMM']}; BMM vs CPU float64 "
          f"max rel err {bmm_err:.3e}")
    check(abs(h / YSD1_H - 1) <= YSD1_H_RTOL, f"YSD1 h {h} not within 2% of {YSD1_H}")
    check(abs(perp["BEAR"] - YSD1_PERPLEXITY) <= YSD1_PERPLEXITY_ATOL,
          f"YSD1 BEAR held-out perplexity {perp['BEAR']} not within 0.01 of 3.79")
    check(bmm_err <= BMM_RTOL, f"YSD1 BMM perplexities {perp['BMM']} differ from "
          f"CPU float64 {ref[5]} by {bmm_err:.3e}")


def write_model_dir(out_dir, res, lag, ar_name, af_kwargs, epochs, batch, lr=TRAIN_LR):
    """A model directory of a bear_net.train result (config.cfg in float32
    and the parameters), and its copy that loads in float64, for the CPU
    references. Returns the copy's path."""
    import shutil

    from bear_tpu_torch.utils.checkpoint import save_results
    from bear_tpu_torch.utils.cli_common import write_config

    cfg = ysd1_config(out_dir + "*")
    cfg["hyperp"]["lag"] = str(lag)
    cfg["data"]["num_ds"] = str(N_GROUPS)
    cfg["model"]["ar_func_name"] = ar_name
    cfg["model"]["af_kwargs"] = json.dumps(af_kwargs)
    cfg["train"].update(epochs=str(epochs), batch_size=str(batch), learning_rate=str(lr))
    cfg["results"]["h"] = str(res.h)
    os.makedirs(out_dir, exist_ok=True)
    write_config(cfg, out_dir)
    save_results(out_dir, res.params_list, extra={"torch_opt_state": res.opt_state})
    dir64 = out_dir.rstrip("/") + "_float64"
    shutil.copytree(out_dir, dir64, dirs_exist_ok=True)
    cfg["general"]["precision"] = "float64"
    write_config(cfg, dir64)
    return dir64


def lag13_train_phase(chunks, reads, groups, out_dir, device="cuda", lag=LAG, cnn_kw=CNN_KW,
                      batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS, n_score=N_SCORE, record=None):
    """4c: count the chunks into a fresh TransitionCounter, hand the counts
    off on the device before any flush, train the CNN BEAR, evaluate,
    write and reload the model and serve held-out reads with it. Checks
    conservation of the handoff, the first applies' ELBOs against CPU
    float64 and the trained model's scores against CPU float64. Returns
    the count_chunk launches, the handoff (codes, counts), the AR, its
    start and the row count; ``record`` (a dict) receives what phase 4j holds
    its mesh runs against: the CPU float64 ELBOs, the trained parameters
    and h, the reads and their scores."""
    import torch
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.inference import BearServer, load_bear
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    count_chunk_update.launches = 0
    counter = engine.TransitionCounter(lags=[lag], n_groups=N_GROUPS, device=device)
    for chunk in chunks:
        counter.add_chunk(chunk)
    counter.sync()
    launches = count_chunk_update.launches
    codes, counts = counter.to_device_dataset(lag)
    n_rows = codes.shape[0]

    gen = torch.Generator().manual_seed(SEED)
    ar = get_ar_func("cnn", lag, 4, cnn_kw, device=device)
    init = bear_net.init_params(gen, ar)
    p0 = [init["h_signed"]] + init["ar"]
    res = bear_net.train(codes, counts[:, 0], num_kmers=n_rows, ar_func=ar,
                         batch_size=batch, epochs=epochs, learning_rate=TRAIN_LR,
                         params_restart=p0, dtype=torch.float32, device=device)

    # Conservation of the handoff against validate(), which flushes the
    # table (hence after the handoff).
    handed = counts.sum(dim=(0, 2), dtype=torch.float64).cpu().numpy()
    expected = len(reads) * (reads.shape[1] + 1)
    counter.validate(expected)
    per_group = counter.tables[lag].sum(axis=(1, 2))
    check(np.array_equal(handed, per_group),
          f"handoff totals {handed} differ from the tables' {per_group}")
    check(codes.is_cuda == counts.is_cuda == (torch.device(device).type == "cuda"),
          "the handoff left the device")
    print(f"[train] count again into a fresh counter ({launches} count_chunk launches), then "
          f"to_device_dataset({lag}) before any flush: {n_rows:,} rows; per-group totals "
          f"{handed.astype(np.int64).tolist()} == the tables'")
    elbos = res.elbos
    check(np.isfinite(elbos).all() and len(elbos) == epochs * -(-n_rows // batch),
          f"ELBOs not finite or of the wrong count: {len(elbos)}")
    print(f"[train] CNN BEAR {cnn_kw}, batch {batch}, {epochs} epochs, lr {TRAIN_LR}, "
          f"float32: {len(elbos)} applies; h {res.h:.6g}; ELBO {elbos[0]:.7g} -> "
          f"{elbos[-1]:.7g}")

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

    out = bear_net.evaluation(codes, counts, 0, 1, "dna", res.h, ar, res.params["ar"],
                              VAN_REG, dtype=torch.float32, device=device)
    print(f"[train] evaluation: held-out perplexity BEAR {float(out[3]):.6f} AR "
          f"{float(out[4]):.6f} BMM {np.asarray(out[5]).tolist()}; accuracy BEAR "
          f"{float(out[6]):.6f} AR {float(out[7]):.6f}")
    check(all(np.isfinite(np.asarray(o)).all() for o in out), "evaluation not finite")

    # Write the model directory, reload it, and serve with the trained CNN.
    dir64 = write_model_dir(out_dir, res, lag, "cnn", cnn_kw, epochs, batch)

    tables = counter.tables[lag]
    del counter
    seqs = decode_reads(reads[np.flatnonzero(groups == 1)[:n_score]])
    lag_, _, h, ar_apply, _ = load_bear(out_dir, device=device)
    check(lag_ == lag and abs(h / res.h - 1) < 1e-6, "load_bear read another model")
    server = BearServer(tables[0], lag, h=h, ar_apply=ar_apply, device=device)
    scores = server.score(seqs)
    del server
    _, _, h64, ar_apply64, _ = load_bear(dir64, device="cpu")
    ref_scores = BearServer(tables[0], lag, h=h64, ar_apply=ar_apply64,
                            dtype=torch.float64, device="cpu").score(seqs)
    diff = np.abs(scores - ref_scores)
    check(scores.shape == (len(seqs),) and np.isfinite(scores).all()
          and bool((diff <= SCORE_ATOL + SCORE_RTOL * np.abs(ref_scores)).all()),
          f"trained-model scores differ from CPU float64: max {diff.max()}")
    print(f"[train] save_results + config.cfg -> load_bear -> BearServer with the trained "
          f"CNN: {len(seqs)} held-out reads; vs CPU float64 max |diff| {diff.max():.3e}; "
          f"scores {ref_scores.min():.3f}..{ref_scores.max():.3f}")
    if record is not None:
        record.update(bmm=np.asarray(out[5]), rows=n_rows, elbo_ref=ref.elbos[:k],
                      params=res.params_list, h=res.h, seqs=seqs, scores=scores, p0=p0)
    return launches, codes, counts, ar, p0, n_rows


# One H100 SM's lanes a clock by execution unit (CUDA C++ Programming
# Guide, "Arithmetic Instructions", compute capability 9.0): every
# instruction takes an issue slot (4 schedulers x 32 lanes); 32-bit integer
# multiply-add (IMAD: Philox's products, and the moves the compiler puts on
# that pipe) and float64 run at half that rate; the special-function and
# conversion unit (MUFU, I2F, F2I, F2F) at an eighth.
SM_LANES_PER_CLOCK = {"issue": 128, "imad": 64, "fp64": 64, "sfu": 16}
# SASS instructions of one call of each library routine, by unit, on the
# path a normal-range input takes: read by ``keyed_draw_timing.py --sass``
# (cuobjdump -sass of csrc/keyed_draw.cu built with -DKEYED_DRAW_PROBES and
# the kernel's flags, -fmad=false, sm_90a, CUDA 12.8; each probe minus its
# copy baseline, a unit the baseline outnumbers counted 0; the toolkit of
# an NVIDIA H100 80GB HBM3 machine). The Philox block runs from round keys
# already scheduled; uniform_f32's int-to-float is I2FP, an ALU instruction.
ROUTINE_SASS = {
    "philox_block": {"issue": 42, "imad": 22},
    "key_schedule": {"issue": 19},
    "uniform_f32": {"issue": 4},
    "log_f32": {"issue": 27},
    "sqrt_f32": {"issue": 10, "sfu": 1},
    "sincos_f32": {"issue": 34, "imad": 1, "sfu": 1},
    "cos_f32": {"issue": 28, "imad": 3, "sfu": 1},
    "exp_f32": {"issue": 10, "sfu": 1},
    "div_f32": {"issue": 10, "sfu": 1},
    "uniform_f64": {"issue": 2, "fp64": 2, "sfu": 1},
    "log_f64": {"issue": 83, "imad": 11, "fp64": 30, "sfu": 1},
    "sqrt_f64": {"issue": 18, "imad": 2, "fp64": 8, "sfu": 1},
    "sincos_f64": {"issue": 78, "imad": 5, "fp64": 20, "sfu": 2},
    "cos_f64": {"issue": 47, "imad": 3, "fp64": 15, "sfu": 2},
    "exp_f64": {"issue": 60, "imad": 6, "fp64": 18},
    "div_f64": {"issue": 18, "imad": 1, "fp64": 8, "sfu": 1},
}
# The kernel's own instructions around the routines, counted from its
# source: per category of a draw, the float operations of the proposal,
# the accept test and the row (d, cc*x, 1 +, t*t, *t, v > 0, vs, 0.5*x, *x,
# + d, d*vs, -, d*lv, +, <, log d + lv, - boost/safe, the accept's select)
# and the predicate and mask operations (pos && test, the reject bit, the
# -inf select); per draw, the base key's address and load, the fold's
# counter and the sample loop; per element, its load, safe, d and 9d and
# the concentration's bit.
FLOAT_OPS_PER_CATEGORY = 18
INT_OPS_PER_CATEGORY = 4
OPS_PER_DRAW = 8
OPS_PER_ELEMENT_CATEGORY = 7


def _add(total, units, times=1):
    for k, v in units.items():
        total[k] = total.get(k, 0) + v * times
    return total


def _float_ops(dtype, n):
    return {"issue": n, "fp64": n} if dtype == "float64" else {"issue": n}


def sampler_work_per_draw(A1, dtype="float32", picked=True):
    """{unit: instructions} of one keyed draw of A1 categories, on the path
    where every category's first Marsaglia-Tsang proposal accepts (>= 95%
    do; a rejection adds a proposal, not counted): the fold's and the
    draw's key schedules, the fold's Philox block and each category quad's
    NORMAL, EXPONENTIAL and BOOST blocks (ROUTINE_SASS); per Box-Muller
    pair two uniforms, log, sqrt and sincos (cos alone for a pair whose
    sine is unused) and its multiplies; per category the exponential's and
    the boost's uniforms and logs, log(vs), the division boost / safe and
    FLOAT_OPS_PER_CATEGORY + INT_OPS_PER_CATEGORY of its own; picked: the
    logsumexp's max, A1 exps, its sum, log and the pick. The element's
    constants are per element (sampler_work_per_element)."""
    t = "f64" if dtype == "float64" else "f32"

    def r(name):
        return ROUTINE_SASS[f"{name}_{t}"]

    w = {}
    pairs, lone = -(-A1 // 2), A1 % 2
    _add(w, ROUTINE_SASS["key_schedule"], 2)
    _add(w, ROUTINE_SASS["philox_block"], 1 + 3 * -(-A1 // 4))
    _add(w, r("uniform"), 2 * pairs + 2 * A1)
    _add(w, r("log"), pairs + 3 * A1)
    _add(w, r("sqrt"), pairs)
    _add(w, r("sincos"), pairs - lone)
    _add(w, r("cos"), lone)
    _add(w, r("div"), A1)
    _add(w, _float_ops(dtype, 4 * pairs - lone + FLOAT_OPS_PER_CATEGORY * A1))
    _add(w, {"issue": INT_OPS_PER_CATEGORY * A1 + OPS_PER_DRAW})
    if picked:  # max, isinf, A1 x (sub, exp, add), log, + max, the pick's select and sub
        _add(w, r("exp"), A1)
        _add(w, r("log"))
        _add(w, _float_ops(dtype, 3 * A1 + 3))
        _add(w, {"issue": A1 + 2})
    else:  # the row through the staging and out
        _add(w, {"issue": 2 * A1})
    return w


def sampler_work_per_element(A1, dtype="float32"):
    """{unit: instructions} of an element's constants, computed once per
    sample tile (counted here once per element): per category its load,
    safe, d, 9d and bit (OPS_PER_ELEMENT_CATEGORY), sqrt(9d), 1 / sqrt and
    log d."""
    t = "f64" if dtype == "float64" else "f32"
    w = {}
    for name in ("sqrt", "div", "log"):
        _add(w, ROUTINE_SASS[f"{name}_{t}"], A1)
    _add(w, _float_ops(dtype, 3 * A1))
    return _add(w, {"issue": (OPS_PER_ELEMENT_CATEGORY - 3) * A1})


def keyed_draw_work(base_keys, group, rows, conc, nxt, picked=True):
    """(bytes, {unit: instructions}) of one keyed-draw call on these
    inputs: each input read once and the output ([S, E] picked, [S, E, A1]
    full) written once; S * E draws (sampler_work_per_draw) and E elements
    (sampler_work_per_element)."""
    S, (E, A1) = base_keys.shape[0], conc.shape
    dtype = str(conc.dtype).removeprefix("torch.")
    ins = (base_keys, group, rows, conc) + ((nxt,) if picked else ())
    nbytes = S * E * (1 if picked else A1) * conc.element_size() + sum(
        t.numel() * t.element_size() for t in ins)
    work = _add(_add({}, sampler_work_per_draw(A1, dtype, picked), S * E),
                sampler_work_per_element(A1, dtype), E)
    return nbytes, work


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "--id=0"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip()) * 1e6


def bound_of(nbytes, work, clock_hz=None, sms=None):
    """(bound ms, bound_by, {unit: ms}): the largest of the bytes at the HBM
    rate and each unit's instructions at its SM_LANES_PER_CLOCK on ``sms``
    SMs at ``clock_hz`` (the card's, read when not given); bound_by is
    "bytes" or the unit."""
    import torch

    clock_hz = clock_hz or sm_clock_hz()
    sms = sms or torch.cuda.get_device_properties(0).multi_processor_count
    unit_ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for unit, n in work.items():
        unit_ms[unit] = n / (SM_LANES_PER_CLOCK[unit] * sms * clock_hz) * 1e3
    by = max(unit_ms, key=unit_ms.get)
    return unit_ms[by], by, unit_ms


def keyed_draw_inputs(A1, dtype, dev, shape=KEYED_DRAW_SHAPE, seed=SEED):
    """Seeded draw inputs on ``dev``: base keys [S, G] over the whole int64
    range, group ids, int64 rows (negative and past 2^32), concentrations
    1e-4..1e4 in ``dtype`` with a tenth at 0 (each row keeps one above 0)
    and int32 next symbols (a tenth of them at a zero concentration)."""
    import torch

    S, E, G = shape
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    base = rng.integers(i64.min, i64.max, (S, G), dtype=np.int64, endpoint=True)
    conc = 10.0 ** rng.uniform(-4, 4, (E, A1))
    conc[rng.random((E, A1)) < 0.1] = 0.0
    conc[np.arange(E), rng.integers(0, A1, E)] = 10.0 ** rng.uniform(-4, 4, E)
    return (torch.as_tensor(base).to(dev), torch.as_tensor(rng.integers(0, G, E)).to(dev),
            torch.as_tensor(rng.integers(-(1 << 40), 1 << 40, E)).to(dev),
            torch.as_tensor(conc, dtype=getattr(torch, dtype)).to(dev),
            torch.as_tensor(rng.integers(0, A1, E), dtype=torch.int32).to(dev))


def ptxas_report(log):
    """{kernel instantiation: {registers, stack, spill_stores, spill_loads}}
    from a library's ``-Xptxas -v`` log (the mangled name from the kernel's
    name on)."""
    out, name, entry, props = {}, None, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            name = entry[entry.find("kernel"):].split("Ev")[0] if "kernel" in entry else entry
            out[name] = {}
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name and props == entry:  # not a called function's frame
            out[name].update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def keyed_draw_form(name, dev):
    """The seeded draw inputs of KEYED_DRAW_FORMS[name] on ``dev`` (A1 5)."""
    import torch

    shape, dtype, _, _ = KEYED_DRAW_FORMS[name]
    inputs = keyed_draw_inputs(5, dtype, dev, shape=shape)
    if name == "K_step":  # sequence b draws under its own key
        inputs = (inputs[0], torch.arange(shape[1], device=dev)) + inputs[2:]
    return inputs


def keyed_draw_plain_sliced(inputs, F, mode, budget=4 << 30):
    """The plain version over every element, in slices of elements whose
    temporaries stay within ``budget`` bytes (as BearServer._draw_picked
    slices it on the CPU)."""
    import torch
    from bear_tpu_torch.inference.serving import _draw_bytes
    from bear_tpu_torch.ops.keyed_draw import keyed_draw_plain

    base, group, rows, conc, nxt = inputs
    S, (E, A1) = base.shape[0], conc.shape
    step = max(1, budget // (S * _draw_bytes(A1, conc.element_size(), F)))
    parts = [keyed_draw_plain(base, group[s:s + step], rows[s:s + step], conc[s:s + step], F,
                              None if mode == "full" else nxt[s:s + step])
             for s in range(0, E, step)]
    return torch.cat(parts, dim=1)


def keyed_draw_vs_plain(inputs, F, mode):
    """The kernel (through its wrapper) against the plain version on the
    same card inputs: {lanes, beyond, max_abs_err, max_rel_err,
    same_special}. A (sample, element) lane is beyond when a value differs
    by more than KEYED_DRAW_RTOL of its operands' scale: |value| + 1, and
    + |logsumexp| for a picked log-prob (the difference of the two); -inf,
    +inf and NaN must sit exactly where the plain version has them."""
    import torch
    from bear_tpu_torch.ops.keyed_draw import keyed_draw_full, keyed_draw_picked

    base, group, rows, conc, nxt = inputs
    got = (keyed_draw_picked(base, group, rows, conc, nxt, F) if mode == "picked"
           else keyed_draw_full(base, group, rows, conc, F))
    want = keyed_draw_plain_sliced(inputs, F, mode)
    synchronize(conc.device)
    got, want = got.double(), want.double()
    scale = want.abs() + 1
    if mode == "picked":
        scale += torch.logsumexp(keyed_draw_plain_sliced(inputs, F, "full").double(), -1).abs()

    def special(t):
        return torch.stack([torch.isneginf(t), torch.isposinf(t), torch.isnan(t)])

    fin = torch.isfinite(got) & torch.isfinite(want)
    err = torch.where(fin, (got - want).abs(), 0.0)
    rel = torch.where(fin, err / scale, 0.0)
    beyond = rel > KEYED_DRAW_RTOL[str(conc.dtype).removeprefix("torch.")]
    if mode == "full":
        beyond = beyond.any(dim=-1)
    return dict(lanes=int(beyond.numel()), beyond=int(beyond.sum()),
                max_abs_err=float(err.max()), max_rel_err=float(rel.max()),
                same_special=torch.equal(special(got), special(want)))


def keyed_draw_held(label, stats):
    check(stats["same_special"] and stats["beyond"] <= SAMPLED_FLIPS * stats["lanes"],
          f"keyed_draw differs from its plain version on {label}: {stats}")
    print(f"[kernel] keyed_draw == plain on {label}: {stats['beyond']} of {stats['lanes']:,} "
          f"lanes beyond tolerance, max_rel_err {stats['max_rel_err']:.3e}, max_abs_err "
          f"{stats['max_abs_err']:.3e}, -inf/NaN where the plain version has them")


def keyed_draw_timing(server, fn, card, reps=20):
    """4d: the draw input of one call of fn (BearServer._draw_picked's
    arguments, captured) held kernel against plain in float32 and float64,
    picked and full (keyed_draw_vs_plain's gates); then the kernel timed on
    it in float32 (CUDA events, ``reps`` launches) beside the plain version
    (sliced as on the CPU, the same events) and its bound, in float64
    picked, and at (K)'s per-step full-mode draw (KEYED_DRAW_FORMS,
    seeded, held the same way; device_ms). Returns the JSON line's fields."""
    import torch
    from bear_tpu_torch.inference.serving import SAMPLE_PROPOSALS
    from bear_tpu_torch.ops.keyed_draw import keyed_draw_full, keyed_draw_picked

    captured = []
    inner = server._draw_picked

    def capture(base_keys, group, rows, nxt, conc):
        captured.append((base_keys, group, rows, conc, nxt))
        return inner(base_keys, group, rows, nxt, conc)

    server._draw_picked = capture
    try:
        fn()
    finally:
        del server._draw_picked
    check(len(captured) == 1, f"the call drew {len(captured)} times, not once")
    inputs = captured[0]
    S, (E, A1) = inputs[0].shape[0], inputs[3].shape
    F = SAMPLE_PROPOSALS
    held = {}
    timed = {}
    for dtype in ("float32", "float64"):
        cast = inputs[:3] + (inputs[3].to(getattr(torch, dtype)),) + inputs[4:]
        for mode in ("picked", "full"):
            held[f"{dtype} {mode}"] = stats = keyed_draw_vs_plain(cast, F, mode)
            keyed_draw_held(f"(C)'s draw input, (S, E, A1) ({S}, {E:,}, {A1}), F {F}, "
                            f"{dtype}, {mode}", stats)
        timed[dtype] = (timed_ms(lambda: keyed_draw_picked(*cast[:4], cast[4], F), reps, None),
                        *bound_of(*keyed_draw_work(*cast)))
        del cast
        torch.cuda.empty_cache()
    plain_ms = timed_ms(lambda: keyed_draw_plain_sliced(inputs, F, "picked"), reps, None)
    _, _, k_F, _ = KEYED_DRAW_FORMS["K_step"]
    k_in = keyed_draw_form("K_step", inputs[0].device)
    held["assembly step"] = stats = keyed_draw_vs_plain(k_in, k_F, "full")
    keyed_draw_held(f"(K)'s per-step draw {tuple(k_in[3].shape)}, F {k_F}, full", stats)
    # device-only: at 1,024 draws the wrapper's host work outlasts the kernel
    timed["step"] = (device_ms(lambda: keyed_draw_full(*k_in[:4], k_F), reps),
                     *bound_of(*keyed_draw_work(*k_in, picked=False)))
    out = dict(max_abs_err=held["float32 picked"]["max_abs_err"],
               max_rel_err=max(h["max_rel_err"] for h in held.values()), shape=[S, E, A1],
               plain_ms=plain_ms, clock_mhz=sm_clock_hz() / 1e6)
    for key, field in (("float32", ""), ("float64", "_float64"), ("step", "_assembly_step")):
        ms, bound_ms, unit, unit_ms = timed[key]
        out.update({f"ms{field}": ms, f"bound_ms{field}": bound_ms,
                    f"bound_by{field}": "bytes" if unit == "bytes" else "operations",
                    f"bound_unit{field}": unit, f"unit_ms{field}": unit_ms})
        print(f"[kernel] keyed_draw {key} at {'(K)' if key == 'step' else '(C)'}'s draw "
              f"input: ms {ms:.6f} bound_ms {bound_ms:.6f} ({unit}; " + ", ".join(
                  f"{u} {v:.6f}" for u, v in unit_ms.items()) + f") [{card}]")
    print(f"[kernel] keyed_draw at (C)'s draw input ({S} samples x {E:,} elements, A1 {A1}, "
          f"F {F}, float32, picked): ms {out['ms']:.6f} plain_ms {plain_ms:.6f} bound_ms "
          f"{out['bound_ms']:.6f} ({out['bound_unit']}) library_ms null (no PyTorch call draws "
          f"keyed log-Gamma variates) [{card}]")
    return out


# The CNN kernel (csrc/cnn_forward.cu) against the plain forward
# (CNNAR._forward_plain) on the card: float64 at rtol 1e-12, float32 at
# CNN_F32_ATOL on the probabilities. The two sum the conv, the statistics,
# the dense layer and the head in different orders, and each lies up to
# ~2e-6 from the plain forward in float64 on 2^18 dense random rows (1.9e-6
# and 1.6e-6 on an H100), so they may differ by twice that.
# CNN_FLOPS_PER_S: one H100 SXM's float32 peak outside the tensor cores.
CNN_F32_ATOL = 4e-6
CNN_F64_RTOL = 1e-12
CNN_FLOPS_PER_S = 67e12


def cnn_plain_module(x, params):
    """A CNNAR of the widths of x [N, lag, A1] and ``params``, for its plain
    forward (the parameters are passed to it, not loaded)."""
    from bear_tpu_torch.models.ar_funcs import CNNAR

    fw, A1, nf = params[0].shape
    return CNNAR(x.shape[1], A1 - 1, fw, nf, params[2].shape[2], dtype=x.dtype, device=x.device)


def cnn_forward_vs_plain(x, params, shape=None):
    """{max_abs_err, max_rel_err, held}: the kernel (in launch shape
    ``shape``, or the chosen one) against the plain forward on x [N, lag,
    A1]; in float32 also each one's largest gap from the plain forward in
    float64 (``kernel_err64``, ``plain_err64``)."""
    import torch
    from bear_tpu_torch.ops import cnn_forward

    with torch.no_grad():
        want = cnn_plain_module(x, params)._forward_plain(x, params)
        if shape is None:
            got = cnn_forward.cnn_probs(x, params)
        else:
            got = cnn_forward.launch(x.contiguous(), params, torch.empty_like(want), shape)
        truth = None
        if x.dtype == torch.float32:
            p64 = [p.double() for p in params]
            truth = cnn_plain_module(x.double(), p64)._forward_plain(x.double(), p64)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = (CNN_F64_RTOL * want.abs() if x.dtype == torch.float64
           else torch.full_like(want, CNN_F32_ATOL))
    out = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
           "max_rel_err": float((diff / want.abs()).max()) if diff.numel() else 0.0,
           "held": bool((diff <= tol).all())}
    if truth is not None and diff.numel():
        out["kernel_err64"] = float((got.double() - truth).abs().max())
        out["plain_err64"] = float((want.double() - truth).abs().max())
    return out


def cnn_forward_timing(fn, card, reps=20, label="(C)'s AR slices"):
    """4d: the k-mers of one call of fn (the AR slices that CNNAR.forward
    hands to ops.cnn_forward.cnn_probs, captured) held kernel against the
    plain forward in float32 and float64 (cnn_forward_vs_plain); then the
    kernel and the plain forward timed on them in float32 (CUDA events,
    ``reps`` calls of all the slices) beside the bound (the model FLOPs at
    CNN_FLOPS_PER_S). Returns the JSON line's fields."""
    import torch
    from bear_tpu_torch.ops import cnn_forward
    from bench_gpu.metrics import _work  # the benchmark's count of a row's FLOPs

    captured = []
    inner = cnn_forward.cnn_probs

    def capture(x, params):
        captured.append((x, [p.detach() for p in params]))
        return inner(x, params)

    cnn_forward.cnn_probs = capture
    try:
        fn()
    finally:
        cnn_forward.cnn_probs = inner
    check(len(captured) > 0, "the call ran no CNN forward through the kernel")
    rows = [x.shape[0] for x, _ in captured]
    x0, p0 = captured[0]
    (fw, A1, nf), w1, lag = p0[0].shape, p0[2].shape[2], x0.shape[1]
    held = {}
    for dtype in (torch.float32, torch.float64):
        for i, (x, params) in enumerate(captured):
            stats = cnn_forward_vs_plain(x.to(dtype), [p.to(dtype) for p in params])
            held[f"{dtype} slice {i}"] = stats
            check(stats["held"], f"cnn_forward differs from the plain forward on slice {i} "
                                 f"({x.shape[0]:,} rows) in {dtype}: {stats}")
    plain = cnn_plain_module(x0, p0)
    with torch.no_grad():
        ms = timed_ms(lambda: [inner(x, p) for x, p in captured], reps, None)
        plain_ms = timed_ms(lambda: [plain._forward_plain(x, p) for x, p in captured], reps,
                            None)
        slice_ms = timed_ms(lambda: inner(x0, p0), reps, None)
    flops = _work.cnn_forward_flops({"lag": lag, "alphabet_size": A1 - 1, "model": {
        "filter_width": fw, "num_filters": nf, "kmer_layer1_width": w1}})
    bound_ms = flops * sum(rows) / CNN_FLOPS_PER_S * 1e3
    slice_bound_ms = flops * rows[0] / CNN_FLOPS_PER_S * 1e3
    shape = cnn_forward.launch_shape(rows[0], 4, torch.cuda.get_device_properties(0)
                                     .multi_processor_count, lag, A1, fw, nf, w1)
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
               slice_ms=slice_ms, slice_bound_ms=slice_bound_ms, slices=rows,
               roofline_pct=100 * bound_ms / ms, launch_shape=list(shape),
               smem_bytes=cnn_forward.smem_bytes(shape.rows, 4, lag, A1, fw, nf, w1),
               max_abs_err=max(h["max_abs_err"] for k, h in held.items() if "float32" in k),
               max_rel_err_float64=max(h["max_rel_err"] for k, h in held.items()
                                       if "float64" in k),
               kernel_err64=max(h["kernel_err64"] for k, h in held.items() if "float32" in k),
               plain_err64=max(h["plain_err64"] for k, h in held.items() if "float32" in k))
    print(f"[kernel] cnn_forward at {label} {rows} (lag {lag}, A1 {A1}, fw {fw}, nf "
          f"{nf}, w1 {w1}, float32): ms {ms:.6f} plain_ms {plain_ms:.6f} bound_ms "
          f"{bound_ms:.6f} (operations: {flops:,} FLOPs a row at 67 TFLOP/s) = "
          f"{out['roofline_pct']:.2f}% of the roofline; one {rows[0]:,}-row slice "
          f"{slice_ms:.6f} ms, bound {slice_bound_ms:.6f}; tiles of {shape.rows} rows, "
          f"{shape.threads} threads, {out['smem_bytes']:,} bytes of shared memory a block; "
          f"max_abs_err {out['max_abs_err']:.3e} (float32; from float64 the kernel "
          f"{out['kernel_err64']:.3e}, the plain forward {out['plain_err64']:.3e}), max_rel_err "
          f"{out['max_rel_err_float64']:.3e} (float64) [{card}]")
    return out


# (Cp) the protein cell's CNN, the one that takes cnn_forward's narrow
# instance (bench_gpu's proteome_lag6_cnn configuration: lag 6, the 20
# residues, bear_cnn_bear.cfg's 30 filters of width 3 and 16 hidden units):
# the cell's proteome drawn from SEED, its training proteins counted into
# the lag-6 table (5.66 GB), one MC-41 call of PROTEIN_SEQS held-out
# proteins, ragged, as the cell makes its calls.
PROTEIN_CONFIG = "bench_gpu/configs/proteome_lag6_cnn.json"
PROTEIN_SEQS = 2048


def protein_server(device="cuda", lag=None, families=None, seqs=PROTEIN_SEQS):
    """(server, proteins): a BearServer of PROTEIN_CONFIG's CNN at seeded
    weights over the table of its proteome's training proteins, and the
    first ``seqs`` held-out proteins as strings. ``lag`` and ``families``
    replace the configuration's (a rehearsal at a small size)."""
    import torch
    from bear_tpu_torch.counting import TransitionCounter, chunk_reads
    from bear_tpu_torch.inference import BearServer
    from bear_tpu_torch.models import get_ar_func
    from bench_gpu import proteome

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), PROTEIN_CONFIG)) as f:
        cfg = json.load(f)
    lag = cfg["lag"] if lag is None else lag
    p = dict(cfg["proteome"], **({} if families is None else {"families": families}))
    residues, lengths, groups = proteome.synth_proteome(
        SEED, p["families"], p["members"], p["median_len"], p["len_sigma"], p["min_len"],
        p["max_len"], p["substitution_rate"], p["held_out"])
    counter = TransitionCounter(lags=[lag], n_groups=1, alphabet=cfg["alphabet"], device=device)
    codes = proteome.sequences(residues, lengths)
    for chunk in chunk_reads(((codes[k], 0) for k in np.flatnonzero(groups == 0)), lag,
                             batch_size=p["chunk_rows"]):
        counter.add_chunk(chunk)
    m = cfg["model"]
    ar = get_ar_func("cnn", lag, cfg["alphabet_size"],
                     {k: m[k] for k in ("num_filters", "filter_width", "kmer_layer1_width")},
                     device=device, generator=torch.Generator().manual_seed(SEED))
    ar.requires_grad_(False)
    server = BearServer(counter.table(lag)[0], lag, h=m["serve_h"], ar_apply=ar,
                        alphabet=cfg["alphabet"], device=device)
    held = np.flatnonzero(groups == 1)[:seqs]
    return server, proteome.strings(*proteome.select(residues, lengths, held))


def protein_phase(card, device="cuda", mc=MC, **size):
    """4d (Cp): one MC-41 call of protein_server's proteins (``size``: its
    ``lag``, ``families`` and ``seqs``), finite, its cnn_forward launches
    counted from 0 just before it, every one of them the narrow instance on
    the card; there its AR slices held against the plain forward and timed
    (cnn_forward_timing). Returns {launches, narrow_launches} and, on the
    card, the timing's fields."""
    import torch
    from bear_tpu_torch.ops import cnn_forward
    from bear_tpu_torch.ops.keyed_random import key as make_key

    server, proteins = protein_server(device, **size)
    key = make_key(SEED)
    call = lambda: server.score(proteins, mode="sample", key=key, mc_samples=mc,  # noqa: E731
                                reduce="mean_std")
    call()  # warm-up
    cnn_forward.launches = cnn_forward.narrow_launches = 0
    out = call()
    rec = {"launches": cnn_forward.launches, "narrow_launches": cnn_forward.narrow_launches}
    check(out.shape == (len(proteins), 2) and np.isfinite(out).all(),
          f"(Cp) scores of {len(proteins)} proteins: {out.shape}, not all finite")
    print(f"[sample] (Cp) {len(proteins):,} proteins, MC-{mc}, reduce='mean_std': finite; "
          f"cnn_forward {rec['launches']} launches, {rec['narrow_launches']} of the narrow "
          f"instance")
    if torch.device(device).type == "cuda":
        check(rec["launches"] > 0 and rec["narrow_launches"] == rec["launches"],
              f"(Cp) the protein CNN's call did not take the narrow instance alone: {rec}")
        rec.update(cnn_forward_timing(call, card, label="(Cp)'s AR slices"))
    return rec


# The attention kernel (csrc/attention_forward.cu) against the plain block
# (AttentionAR._block_plain) on the card: float64 at rtol 1e-12, float32 at
# ATTN_F32_ATOL on the probabilities and, from float64, within twice the plain
# block's own float32 gap (+1e-7). ATTN_SLICES: the AR slices of a
# genome13_attn_score_mc41 call (618,496 windows in slices of 2^18 rows).
ATTN_F32_ATOL = 1e-6
ATTN_SLICES = (1 << 18, 1 << 18, 94_208)


def attention_case(dev, dtype, lag=LAG, A=4, kw=ATTN_KW, seed=SEED):
    """An AttentionAR of these widths on ``dev`` and seeded parameters with
    every leaf away from its init (pos and the biases non-zero)."""
    import torch
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    g = torch.Generator().manual_seed(seed)
    ar = get_ar_func("attention", lag, A, kw, dtype=dtype, device=dev, generator=g)
    params = [(p + 0.05 * torch.randn(p.shape, generator=g, dtype=dtype).to(dev)).detach()
              for p in ar.params_list()]
    return ar, params


def attention_contexts(n, lag, A1, dtype, dev, seed=SEED):
    """n seeded one-hot contexts [n, lag, A1] on ``dev``."""
    import torch

    g = torch.Generator().manual_seed(seed + n)
    codes = torch.randint(0, A1, (n, lag), generator=g)
    return torch.nn.functional.one_hot(codes, A1).to(dtype).to(dev)


def attention_forward_vs_plain(ar, x, params, shape=None):
    """{max_abs_err, max_rel_err, held}: the kernel (in launch shape
    ``shape``, or the chosen one) against the plain block on contexts x [N,
    lag, A1]; in float32 also each one's largest gap from the plain block in
    float64 (``kernel_err64``, ``plain_err64``)."""
    import torch
    from bear_tpu_torch.ops import attention_forward

    n = x.shape[0]
    with torch.no_grad():
        want = ar._block_plain(params, x, (n,), x.dtype)
        if shape is None:
            got = attention_forward.attention_probs(x, params, ar.num_heads)
        else:
            got = attention_forward.launch(x, params, ar.num_heads, torch.empty_like(want),
                                           shape)
        truth = None
        if x.dtype == torch.float32:
            p64 = [p.double() for p in params]
            truth = ar._block_plain(p64, x.double(), (n,), torch.float64)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = (CNN_F64_RTOL * want.abs() if x.dtype == torch.float64
           else torch.full_like(want, ATTN_F32_ATOL))
    out = {"max_abs_err": float(diff.max()) if n else 0.0,
           "max_rel_err": float((diff / want.abs()).max()) if n else 0.0,
           "held": bool((diff <= tol).all())}
    if truth is not None and n:
        out["kernel_err64"] = float((got.double() - truth).abs().max())
        out["plain_err64"] = float((want.double() - truth).abs().max())
        out["held"] = out["held"] and out["kernel_err64"] <= 2 * out["plain_err64"] + 1e-7
    return out


def attention_forward_timing(card, slices=ATTN_SLICES, reps=20):
    """The kernel at a scoring call's AR slices of the lag-13 attention AR
    (ATTN_KW): held against the plain block in float32 and float64 on every
    slice (attention_forward_vs_plain), then the kernel and the plain block
    timed in float32 (CUDA events, ``reps`` calls of all the slices) beside
    the bound (the model FLOPs at CNN_FLOPS_PER_S), with the kernel's
    registers and spills. Returns the JSON line's fields."""
    import torch
    from bear_tpu_torch import _build
    from bear_tpu_torch.ops import attention_forward
    from bench_gpu.metrics import _work_attention  # the benchmark's count of a row's FLOPs

    dev = torch.device("cuda", 0)
    held = {}
    for dtype in (torch.float32, torch.float64):
        ar, params = attention_case(dev, dtype)
        for i, n in enumerate(slices):
            stats = attention_forward_vs_plain(ar, attention_contexts(n, LAG, 5, dtype, dev),
                                               params)
            held[f"{dtype} slice {i}"] = stats
            check(stats["held"], f"attention_forward differs from the plain block on slice {i} "
                                 f"({n:,} rows) in {dtype}: {stats}")
    ar, params = attention_case(dev, torch.float32)
    xs = [attention_contexts(n, LAG, 5, torch.float32, dev) for n in slices]
    H, D, M = ar.num_heads, ar.d_model, ar.mlp_width
    with torch.no_grad():
        ms = timed_ms(lambda: [attention_forward.attention_probs(x, params, H) for x in xs],
                      reps, None)
        plain_ms = timed_ms(lambda: [ar._block_plain(params, x, (x.shape[0],), x.dtype)
                                     for x in xs], reps, None)
        slice_ms = timed_ms(lambda: attention_forward.attention_probs(xs[0], params, H), reps,
                            None)
    flops = _work_attention.attention_forward_flops(
        {"lag": LAG, "alphabet_size": 4, "model": {"d_model": D, "mlp_width": M}})
    bound_ms = flops * sum(slices) / CNN_FLOPS_PER_S * 1e3
    slice_bound_ms = flops * slices[0] / CNN_FLOPS_PER_S * 1e3
    shape = attention_forward.launch_shape(slices[0], 4, torch.cuda.get_device_properties(0)
                                           .multi_processor_count, LAG, 5, D, H, M)
    log = _build.library_path(attention_forward.SOURCE).with_suffix(".log")
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
               slice_ms=slice_ms, slice_bound_ms=slice_bound_ms, slices=list(slices),
               roofline_pct=100 * bound_ms / ms, launch_shape=list(shape),
               smem_bytes=attention_forward.smem_bytes(shape.warps, 4, LAG, 5, D, H, M,
                                                       shape.resident),
               max_abs_err=max(h["max_abs_err"] for k, h in held.items() if "float32" in k),
               max_rel_err_float64=max(h["max_rel_err"] for k, h in held.items()
                                       if "float64" in k),
               kernel_err64=max(h["kernel_err64"] for k, h in held.items() if "float32" in k),
               plain_err64=max(h["plain_err64"] for k, h in held.items() if "float32" in k),
               ptxas=ptxas_report(log.read_text()) if log.exists() else None)
    print(f"[kernel] attention_forward at a scoring call's AR slices {list(slices)} (lag {LAG}, "
          f"A1 5, D {D}, {H} heads, M {M}, float32): ms {ms:.6f} plain_ms {plain_ms:.6f} "
          f"bound_ms {bound_ms:.6f} (operations: {flops:,} FLOPs a row at 67 TFLOP/s) = "
          f"{out['roofline_pct']:.2f}% of the roofline; one {slices[0]:,}-row slice "
          f"{slice_ms:.6f} ms, bound {slice_bound_ms:.6f}; {shape.blocks} blocks of "
          f"{shape.warps} warps, weights resident {shape.resident}, {out['smem_bytes']:,} bytes "
          f"of shared memory a block; ptxas "
          f"{out['ptxas']}; max_abs_err {out['max_abs_err']:.3e} (float32; from float64 the "
          f"kernel {out['kernel_err64']:.3e}, the plain block {out['plain_err64']:.3e}), "
          f"max_rel_err {out['max_rel_err_float64']:.3e} (float64) [{card}]")
    return out


def attention_serving_launches(table, seqs):
    """The lag-13 attention AR (ATTN_KW, float32) served through
    ``BearServer.score`` at MC-41, reduced to mean and std, on the main
    path's table and held-out reads, at the real ``AR_SLICE_ROWS``: one
    ``attention_forward`` launch an AR slice, counted from 0 just before the
    call. Returns the launches."""
    import torch
    from bear_tpu_torch.inference import serving
    from bear_tpu_torch.inference.serving import BearServer
    from bear_tpu_torch.ops import attention_forward
    from bear_tpu_torch.ops import keyed_random as kr

    ar, params = attention_case(torch.device("cuda", 0), torch.float32)
    ar.load_params(params)
    ar.requires_grad_(False)
    server = BearServer(table, LAG, h=H, ar_apply=ar)
    attention_forward.launches = 0
    got = server.score(seqs, key=kr.key(SEED), mode="sample", mc_samples=41, reduce="mean_std")
    launches = attention_forward.launches
    slices = -(-len(seqs) * (READ_LEN + 1) // serving.AR_SLICE_ROWS)
    check(launches == slices, f"BearServer.score with the attention AR launched "
                              f"attention_forward {launches} times for {slices} AR slices")
    check(got.shape == (len(seqs), 2) and bool(np.isfinite(got).all()),
          "the attention AR's MC-41 scores are not finite of shape [reads, 2]")
    print(f"[serve] {len(seqs):,} held-out reads at MC-41 with the lag-{LAG} attention AR "
          f"(float32): attention_forward launches {launches} for {slices} AR slices of "
          f"{serving.AR_SLICE_ROWS:,} rows")
    return launches


def sampled_phase(table, lag, model_dir, ysd1_dir, seqs, wt, card, device="cuda",
                  mc=MC, n_variants=N_VARIANTS, sampled_check=SAMPLED_CHECK,
                  map_check=MAP_CHECK, cli_wt_bp=CLI_WT_BP, record=None):
    """4d: posterior-sampled serving (C), the SNV scan (D), arbitrary
    variants (E) and the score CLI (F), from ``table`` with the model of
    ``model_dir`` (and its float64 copy ``model_dir + '_float64'``).
    Checks MAP against CPU float64, sampled float64 on the device against
    the CPU from the same keys on subsets, the reductions against the raw
    draws, finiteness and, on the card, each call's peak device memory
    against PEAK_BUDGET. On the card (labelled ``card``), (C)'s draw input
    and AR slices hold keyed_draw and cnn_forward against their plain
    versions and time them alone (keyed_draw_timing, cnn_forward_timing).
    ``record`` gets each path's keyed_draw and cnn_forward launches
    (counted from 0 just before its calls, read just after) under
    "keyed_launches" and "cnn_launches", and the kernels' numbers under
    "keyed_draw" and "cnn_forward"."""
    import contextlib
    import io

    import torch
    from bear_tpu_torch.inference import BearServer, load_bear, score_cli
    from bear_tpu_torch.ops import cnn_forward, keyed_draw
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

    def run(label, fn):
        fn()  # warm-up: what a first call leaves resident is not held to the budget
        base = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = fn()
        mem = ""
        if on_card:
            peak = torch.cuda.max_memory_allocated()
            mem = (f"; peak device memory {peak / 2**30:.3f} GiB, "
                   f"{(peak - base) / 2**30:.3f} GiB above the resident "
                   f"{base / 2**30:.3f} GiB")
            check(peak - base <= PEAK_BUDGET,
                  f"{label} took {peak - base} bytes above the resident, over the budget")
        check(np.isfinite(out).all(), f"{label}: values not finite")
        print(f"[sample] {label}: {out.shape} values, finite{mem}")
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

    record = {} if record is None else record
    launches = record.setdefault("keyed_launches", {})
    cnn_launches = record.setdefault("cnn_launches", {})

    # (C) posterior-sampled serving
    n_r, n_s, n_v = sampled_check
    kw = dict(mode="sample", key=key, mc_samples=mc)
    score_ms = lambda: server.score(seqs, reduce="mean_std", **kw)  # noqa: E731
    keyed_draw.launches = cnn_forward.launches = 0
    ms = run(f"(C) {len(seqs)} reads, MC-{mc}, reduce='mean_std'", score_ms)
    raw = run(f"(C) {len(seqs)} reads, MC-{mc}, reduce='none'", lambda: server.score(seqs, **kw))
    launches["sampled_serving"] = keyed_draw.launches
    cnn_launches["sampled_serving"] = cnn_forward.launches
    check(ms.shape == (len(seqs), 2) and raw.shape == (len(seqs), mc), "(C) shapes")
    reductions_held("(C)", ms, raw)
    held(f"(C) {n_r} reads", dev64.score(seqs[:n_r], **kw), cpu64.score(seqs[:n_r], **kw),
         n_r * mc)
    if on_card:
        record["keyed_draw"] = keyed_draw_timing(server, score_ms, card)
        record["cnn_forward"] = cnn_forward_timing(score_ms, card)

    # (D) the deep-mutational-scan grid
    pos, alts = snv_grid(wt)
    keyed_draw.launches = cnn_forward.launches = 0
    d_map = run(f"(D) {len(pos):,} SNVs, MAP", lambda: server.delta_scores_snv(wt, pos, alts))
    d_ms = run(f"(D) {len(pos):,} SNVs, MC-{mc}, reduce='mean_std'",
               lambda: server.delta_scores_snv(wt, pos, alts, reduce="mean_std", **kw))
    launches["snv_scan"] = keyed_draw.launches
    cnn_launches["snv_scan"] = cnn_forward.launches
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
    keyed_draw.launches = cnn_forward.launches = 0
    e_map = run(f"(E) {len(variants):,} variants, MAP",
                lambda: server.delta_scores_variants(wt, variants))
    e_ms = run(f"(E) {len(variants):,} variants, MC-{mc}, reduce='mean_std'",
               lambda: server.delta_scores_variants(wt, variants, reduce="mean_std", **kw))
    launches["variants"] = keyed_draw.launches
    cnn_launches["variants"] = cnn_forward.launches
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
        with contextlib.redirect_stdout(buf):
            rc = score_cli.main(argv + ["--torch-device", torch.device(device).type])
        lines = buf.getvalue().splitlines()
        vals = np.array([[float(x) for x in l.split("\t")[1:]] for l in lines[1:]])
        check(rc == 0 and lines[0] == header and len(lines) == rows + 1
              and np.isfinite(vals).all(), f"score_cli {argv[:1]} output: {lines[:2]}")
        print(f"[cli] score_cli {argv[0]} {' '.join(a for a in argv if a.startswith('--'))}"
              f": {rows:,} rows, finite")

    cli_wt = "".join(np.random.default_rng(SEED).choice(list("ACGT"), cli_wt_bp))
    keyed_draw.launches = 0
    cli(["snv", ysd1_dir, cli_wt, "--all", "--sample", "--std"], 3 * cli_wt_bp,
        "variant\tBEAR\tmc_std")
    cli_vars = make_variants(cli_wt, 100, seed=1)
    cli(["variants", ysd1_dir, cli_wt, *cli_vars, "--device"], len(cli_vars),
        "target\tBEAR")
    cli(["seqs", ysd1_dir, *seqs[:CLI_READS], "--map"], min(CLI_READS, len(seqs)),
        "target\tAR\tBEAR")
    launches["score_cli"] = keyed_draw.launches


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


def summarize_phase(reads, groups, want_rows, want_counts, work, device="cuda", lag=LAG):
    """4e, counting: write the reads as FASTQ, run the summarize CLI at
    ``-l lag`` on ``device`` through its parser, and read the lag-``lag``
    shards back. Checks that the native parser took every file, one
    count_chunk launch per chunk on the card, conservation (summarize's own
    check, at every lag) and that the shards hold exactly ``want_rows`` /
    ``want_counts`` (phase 4's nonzero rows and counts). Returns what the
    later steps use."""
    import glob

    import torch
    from bear_tpu_torch.data import load_files

    csv, files = write_fastq(reads, groups, os.path.join(work, "reads"))
    prefix = os.path.join(work, "counts", "run")
    n_bins, run, launches = summarize_run(csv, prefix, ["-l", str(lag)], device)
    stats = run["stats"]
    per_lag = stats["bases"] + stats["reads"]
    on_card = torch.device(device).type == "cuda"
    check(per_lag == len(reads) * (reads.shape[1] + 1), "summarize read another input")
    check(sorted(stats["parser"].values()) == ["native"] * len(files),
          f"not every file went through the native parser: {stats['parser']}")
    check(launches == (stats["chunks"] if on_card else 0),
          f"summarize launched count_chunk {launches} times for {stats['chunks']} chunks")
    print(f"[summarize] {len(files)} FASTQ files ({', '.join(os.path.basename(p) for p, _, _ in files)}; "
          f"{stats['reads']:,} reads); parsers: {sorted(set(stats['parser'].values()))} for all "
          f"{len(files)}")
    print(f"[summarize] -l {lag}: {per_lag:,} transitions per lag x {lag} lags conserved; "
          f"table {run['table_bytes']:,} bytes (int32, lags 1..{lag} x {N_GROUPS} groups) on "
          f"{device}; {stats['chunks']} chunks, {launches} count_chunk launches; {n_bins} shards "
          f"per lag; nonzero rows per lag {[run['rows'][l] for l in sorted(run['rows'])]}")

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
    return dict(launches=launches, chunks=stats["chunks"], prefix=prefix, files=files,
                shards=shards, csv=csv, n_bins=n_bins)


def launch_fields(B, L, n_lags):
    """The launch shape count_chunk_update picks for a [B, L] chunk over
    ``n_lags`` lags on card 0, for the kernels line: blocks of the grid,
    threads per block, positions per tile and per thread, lag groups and
    lags per thread."""
    from bear_tpu_torch.counting import count_chunk

    s = count_chunk.launch_shape(B, L, n_lags, count_chunk.sm_count(0))
    return {"blocks": s.blocks, "threads": count_chunk.THREADS, "tile": s.tile,
            "positions_per_thread": s.run, "lag_groups": s.groups,
            "lags_per_thread": -(-n_lags // s.groups)}


def summarize_chunk_timing(first_file, card, dev, lag=LAG, reps=20, passes=None):
    """count_chunk at the summarize geometry: the first chunk that
    chunks_from_packed makes of ``first_file`` (1,024 reads, padded), over
    lags 1..lag, held against its plain version (exact) and timed like
    phase 3. The byte bound counts the distinct 32-byte sectors the chunk's
    keys touch over all the lag tables; the library call is index_put_ on
    those keys. With ``passes``, count_chunk's row-range form in
    MultiPassTransitionCounter's layout: the chunk is held against its
    plain version in every pass's row range and timed in pass 0, its bound
    and library call on that pass's keys. Returns the kernel's JSON fields
    for this geometry."""
    import torch
    from bear_tpu_torch.counting import count_chunk, engine, native
    from bear_tpu_torch.counting.count_chunk import count_chunk_plain, count_chunk_update
    from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter

    codes_flat, offsets = native.load().parse(first_file, "fq")
    chunk = next(iter(engine.chunks_from_packed(codes_flat, offsets, 0, lag)))
    lags = tuple(range(1, lag + 1))
    meta_np = count_chunk.pack_meta(chunk.lengths, chunk.skip, chunk.stopped, chunk.groups,
                                    chunk.fresh)
    codes = torch.from_numpy(chunk.codes).to(dev)
    meta = torch.from_numpy(meta_np).to(dev)
    if passes is None:
        shards = [None]
        _, total = count_chunk.lag_offsets(lags, N_GROUPS)
    else:
        layout = MultiPassTransitionCounter(lags, n_groups=N_GROUPS, passes=passes, device=dev)
        shards = [(d, layout._per_lag) for d in range(passes)]
        total = layout.table_size
    a = torch.zeros(total, dtype=torch.int32, device=dev)
    b = torch.zeros(total, dtype=torch.int32, device=dev)
    err = 0
    for shard in shards:
        a.zero_()
        b.zero_()
        count_chunk_update(a, codes, meta, lags, N_GROUPS, 4, shard=shard)
        count_chunk_plain(b, codes, meta, lags, N_GROUPS, 4, shard=shard)
        torch.cuda.synchronize()
        differ = a != b
        if bool(differ.any()):
            err = int((a[differ].long() - b[differ].long()).abs().max())
        where = "" if shard is None else f" in pass {shard[0]} of {passes}"
        check(err == 0, f"count_chunk differs from plain on the summarize chunk{where}: {err}")
    del b, differ
    shard = shards[0]
    lengths, skip, stopped, grp, fresh = count_chunk.unpack_meta(meta)
    keys = count_chunk.chunk_keys(codes, lengths, skip, stopped, grp, lags, N_GROUPS, 4,
                                  sentinel=total, fresh=fresh, shard=shard)
    valid = keys[(keys >= 0) & (keys < total)].long()
    ones = torch.ones_like(valid, dtype=torch.int32)
    sectors = int(torch.unique(valid // 8).numel())
    l2_flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)

    def kernel(fn):
        return lambda: fn(a, codes, meta, lags, N_GROUPS, 4, shard=shard)

    ms = timed_ms(kernel(count_chunk_update), reps, l2_flush)
    plain_ms = timed_ms(kernel(count_chunk_plain), reps, l2_flush)
    library_ms = timed_ms(lambda: a.index_put_((valid,), ones, accumulate=True), reps, l2_flush)
    n_pos = codes.shape[0] * (codes.shape[1] + 1)
    bytes_ms = (codes.numel() + 4 * meta.numel() + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_pos * (ROLL_OPS + KEY_OPS * len(lags)) / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    form = ("" if passes is None else
            f" in row-range form, held in all {passes} passes, timed in pass 0")
    shape = launch_fields(*codes.shape, len(lags))
    print(f"[kernel] count_chunk at the summarize chunk{form}: {codes.shape[0]:,} x "
          f"{codes.shape[1]} codes over lags 1..{lag} ({valid.numel():,} keys counted, "
          f"{sectors:,} table sectors of {total:,} int32): == plain, max_abs_err {err}; ms "
          f"{ms:.6f} plain_ms {plain_ms:.6f} bound_ms {bound_ms:.6f} ({bound_by}) library_ms "
          f"{library_ms:.6f} (index_put_ on the chunk's keys); launch {shape} [{card}]")
    out = {"shape": list(codes.shape), "lags": len(lags), "max_abs_err": float(err),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "launch_shape": shape}
    if passes is not None:
        out.update(passes=passes, timed_pass=0, table_entries=total, keys=valid.numel())
    return out


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


def streaming_train_phase(prefix, shards, reads, groups, out_dir, device="cuda", lag=LAG,
                          cnn_kw=CNN_KW, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS, n_cli=CLI_READS,
                          record=None):
    """4e, training: the streaming training CLI on the lag-``lag`` shards,
    its shard loads and its training call seen through wrappers. Checks
    the first ELBOs against train_streaming on the CPU in float64 from the
    same initial parameters over the same shard stream, that epoch 1 parses
    every shard and every later load hits the cache, the streamed held-out
    perplexities against the in-memory evaluation of the concatenated
    shards on ``device``, that the mid-run state is gone and the shard
    cache is there, and scores held-out reads with the score CLI.
    ``record`` (a dict) receives the run's ELBOs, its initial parameters,
    seed and k-mer count, and the CLI's data config, for phase 4j."""
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
    hits, seen = [], {}
    real = (train_bear_net.load_files_cached, bear_net.train_streaming)

    def seen_load(files, *args, **kw):
        before = len(os.listdir(cache)) if os.path.isdir(cache) else 0
        out = real[0](files, *args, **kw)
        hits.append(len(os.listdir(cache)) == before)
        return out

    def seen_train(shard_fn, **kw):
        init = bear_net.init_params(torch.Generator().manual_seed(kw["seed"]), kw["ar_func"])
        seen.update(kw=kw, p0=[init["h_signed"]] + init["ar"])
        seen["result"] = real[1](shard_fn, **kw)
        return seen["result"]

    train_bear_net.load_files_cached, bear_net.train_streaming = seen_load, seen_train
    try:
        train_bear_net.main(cfg, device=device)
    finally:
        train_bear_net.load_files_cached, bear_net.train_streaming = real
    res, kw = seen["result"], seen["kw"]
    elbos = res.elbos
    if record is not None:
        record.update(elbos=elbos, p0=seen["p0"], seed=seed, num_kmers=kw["num_kmers"],
                      data=dict(cfg["data"]))
    F = len(shards)
    n_rows = kw["num_kmers"]
    n_batches = sum(-(-count_kmers([f]) // batch) for f in shards)
    check(len(elbos) == n_batches * epochs and np.isfinite(elbos).all(),
          f"{len(elbos)} ELBOs for {n_batches} batches x {epochs} epochs, or not finite")
    check(len(hits) == F * (epochs + 2), f"{len(hits)} shard loads, expected {F * (epochs + 2)}")
    check(not any(hits[:F]) and all(hits[F:]),
          "epoch 1 should parse every shard and every later load hit the cache")
    print(f"[stream] train_bear_net.main, streaming CNN BEAR {cnn_kw} on {F} lag-{lag} shards "
          f"({n_rows:,} rows), batch {batch}, {epochs} epochs, shuffle, cache, checkpoint_every "
          f"{STREAM_CHECKPOINT_EVERY}: {len(elbos)} applies; ELBO {elbos[0]:.7g} -> "
          f"{elbos[-1]:.7g}")
    labels = [f"epoch {e + 1}" for e in range(epochs)] + ["held-out eval", "train-as-test eval"]
    print("[stream] shard loads: " + "; ".join(
        f"{label} ({sum(hits[i * F:(i + 1) * F])}/{F} cache hits)"
        for i, label in enumerate(labels)))

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
    memory = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", h, kw["ar_func"],
                                 res.params["ar"], VAN_REG, dtype=torch.float32, seed=seed,
                                 device=device)
    streamed = [float(results["heldout_perplex_BEAR"]), float(results["heldout_perplex_AR"]),
                *json.loads(results["heldout_perplex_BMM"])]
    in_memory = [float(memory[3]), float(memory[4]), *np.asarray(memory[5]).tolist()]
    perp_err = float(np.max(np.abs(np.array(streamed) / np.array(in_memory) - 1)))
    check(perp_err <= EVAL_RTOL, f"streamed held-out perplexities {streamed} differ from "
          f"the in-memory evaluation's {in_memory} by {perp_err:.3e}")
    print(f"[stream] held-out perplexity BEAR {streamed[0]:.6f} AR {streamed[1]:.6f} BMM "
          f"{streamed[2:]}; vs in-memory evaluation on {device} max rel err {perp_err:.3e} "
          f"(tolerance {EVAL_RTOL}); h {h:.6g}")
    cached = [f for f in os.listdir(cache) if f.endswith(".npz")]
    check(not os.path.exists(os.path.join(out_dir, TRAIN_STATE_FILE)) and len(cached) == F,
          f"after the run: train_state.pickle present or {len(cached)} cached shards of {F}")

    seqs = decode_reads(reads[np.flatnonzero(groups == 1)[:n_cli]])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = score_cli.main(["seqs", out_dir, *seqs, "--map", "--torch-device",
                             torch.device(device).type])
    lines = buf.getvalue().splitlines()
    vals = np.array([[float(x) for x in l.split("\t")[1:]] for l in lines[1:]])
    check(rc == 0 and len(lines) == len(seqs) + 1 and np.isfinite(vals).all(),
          f"score_cli seqs on the streamed model: {lines[:2]}")
    print(f"[stream] train_state.pickle cleared, {len(cached)} shards cached; score_cli seqs "
          f"--map on {len(seqs)} held-out reads against the streamed model: finite")
    return len(elbos)


def reference_template(genome_mb=GENOME_MB, seed=SEED, template_len=100_000):
    """The genome's unmutated template: the first draw of synth_genome's rng
    (make_reads' genome is this template tiled, with ~1% substitutions),
    tiled to the genome's length."""
    template = np.random.default_rng(seed).integers(0, 4, template_len, dtype=np.int8)
    G = int(genome_mb * 1e6)
    return np.tile(template, -(-G // template_len))[:G]


def reference_phase(reads, chunks, out_dir, device="cuda", lag=LAG, genome_mb=GENOME_MB,
                    cnn_kw=CNN_KW, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS):
    """4f (H): count -> serve's reads as groups 0 (train) and 1 (held out)
    and the genome's template, counted as one long sequence, as group 2 (the
    reference), at ``lag``; the counts handed off on the device; the
    reference-guided CNN BEAR trained and evaluated (test column 1,
    reference column 2); then the reference-guided CLI on YSD1 with
    bear_test.cfg's values in float32. Checks conservation, the first
    ELBOs against the CPU in float64 from the same initial parameters, and
    the CLI's BMM perplexities against bmm_likelihood in float64. Returns
    the recount's count_chunk launches."""
    import torch
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.data import bmm_likelihood, load_dense
    from bear_tpu_torch.models import bear_ref, train_bear_ref
    from bear_tpu_torch.ops.distributions import EPSILON
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    ref = reference_template(genome_mb)
    count_chunk_update.launches = 0
    counter = engine.TransitionCounter(lags=[lag], n_groups=N_REF_GROUPS, device=device)
    for chunk in chunks:
        counter.add_chunk(chunk)
    for chunk in engine.chunk_reads(iter([(ref, 2)]), lag):
        counter.add_chunk(chunk)
    counter.sync()
    launches = count_chunk_update.launches
    counter.validate(len(reads) * (reads.shape[1] + 1) + len(ref) + 1)
    codes, counts = counter.to_device_dataset(lag)
    n_rows, table_bytes = codes.shape[0], 4 * counter.table_size
    del counter
    print(f"[ref] reads (groups 0, 1) and the {len(ref):,} bp template (group 2) counted at "
          f"lag {lag} into {table_bytes:,} bytes ({launches} count_chunk launches), conserved; "
          f"handed off on {device}: {n_rows:,} rows")

    gen = torch.Generator().manual_seed(SEED)
    ar = bear_ref.make_ref_ar("cnn", lag, 4, cnn_kw, device=device)
    p0 = [torch.zeros(())] + ar.init(gen)
    kw = dict(lag=lag, batch_size=batch, learning_rate=TRAIN_LR, params_restart=p0)
    res = bear_ref.train(codes, counts[:, 0], counts[:, 2], n_rows, "cnn", cnn_kw,
                         epochs=epochs, dtype=torch.float32, device=device, **kw)
    elbos = res.elbos
    steps = -(-n_rows // batch)
    check(np.isfinite(elbos).all() and len(elbos) == epochs * steps,
          f"reference-guided ELBOs not finite or of the wrong count: {len(elbos)}")
    print(f"[ref] reference-guided CNN BEAR {cnn_kw}, batch {batch}, {epochs} epochs, lr "
          f"{TRAIN_LR}, float32: {len(elbos)} applies; h {res.h:.6g}, error_rate "
          f"{bear_ref.error_rate(res.params):.6g}, stop_rate "
          f"{bear_ref.stop_rate_inverse(res.params):.6g}; ELBO {elbos[0]:.7g} -> "
          f"{elbos[-1]:.7g}")
    k = min(N_ELBO_CHECK, steps)
    cpu = bear_ref.train(codes[: k * batch].cpu(), counts[: k * batch, 0].cpu(),
                         counts[: k * batch, 2].cpu(), n_rows, "cnn", cnn_kw, epochs=1,
                         dtype=torch.float64, device="cpu", **kw)
    elbo_err = float(np.max(np.abs(elbos[:k] / cpu.elbos[:k] - 1)))
    check(len(cpu.elbos) == k and elbo_err <= ELBO_RTOL,
          f"first {k} reference-guided ELBOs {elbos[:k]} differ from CPU float64 "
          f"{cpu.elbos} by {elbo_err:.3e}")
    print(f"[ref] first {k} ELBOs vs CPU float64 from the same initial parameters: max rel "
          f"err {elbo_err:.3e} (tolerance {ELBO_RTOL})")
    out = bear_ref.evaluation(codes, counts, 0, 1, 2, "dna", res.h, ar, res.params["ar"],
                              VAN_REG, dtype=torch.float32, device=device)
    check(all(np.isfinite(np.asarray(o)).all() for o in out), "reference-guided evaluation "
          "not finite")
    print(f"[ref] evaluation: held-out perplexity BEAR {float(out[3]):.6f} AR "
          f"{float(out[4]):.6f} BMM {np.asarray(out[5]).tolist()}; accuracy BEAR "
          f"{float(out[6]):.6f} AR {float(out[7]):.6f}")
    del codes, counts, res, ar

    cfg = ysd1_config(os.path.join(out_dir, "ysd1_ref") + "*")
    cfg["train"].update(epochs="1", train_ar="True")  # bear_test.cfg's values
    _, ll_van, perp_van = train_bear_ref.main(cfg, device=device)
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    calc = bmm_likelihood(ds.counts, np.array(VAN_REG) + EPSILON, device="cpu")[0]
    want = np.exp(-calc / ds.counts[:, 0].sum())
    bmm_err = float(np.max(np.abs(np.asarray(perp_van) / want - 1)))
    check(bmm_err <= BMM_RTOL, f"train_bear_ref BMM perplexities {perp_van} differ from "
          f"bmm_likelihood's {want} by {bmm_err:.3e}")
    res = cfg["results"]
    print(f"[ref] train_bear_ref.main on YSD1, bear_test.cfg's values in float32: h "
          f"{float(res['h']):.6g}, error_rate {float(res['error_rate']):.6g}, stop_rate "
          f"{float(res['stop_rate']):.6g}, held-out perplexity BEAR "
          f"{float(res['heldout_perplex_BEAR']):.6f}; BMM vs bmm_likelihood float64 max rel "
          f"err {bmm_err:.3e} (tolerance {BMM_RTOL})")
    return launches


def vbear_phase(device="cuda", applies=VBEAR_APPLIES, gate=True):
    """4f (I): vBEAR on YSD1 (docs/usage.md:176-185): linear, batch 1,500,
    ``applies`` applies, lr 0.01, seed 10, float32. With ``gate``, checks
    the posterior median h within 25% of the published 0.0433 and sigma
    below 0.25."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import vbear
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    ar = get_ar_func("linear", 5, 4, dtype=torch.float32, device=device)
    vb = vbear.train_variational_h(ds.codes, ds.counts[:, 0], ds.num_kmers, ar, epochs=applies,
                                   batch_size=1500, learning_rate=0.01, seed=10,
                                   dtype=torch.float32, device=device)
    mu, sigma = vb.h_posterior
    check(np.isfinite(vb.losses).all() and len(vb.losses) == applies, "vBEAR losses")
    print(f"[vbear] YSD1 linear, batch 1500, lr 0.01, seed 10, float32: {applies:,} applies; "
          f"h {vb.h:.6g} (published EB 0.0433), mu {mu:.6g}, sigma {sigma:.6g}")
    if gate:
        check(abs(vb.h - YSD1_VBEAR_H) / YSD1_VBEAR_H < VBEAR_H_RTOL and sigma < VBEAR_SIGMA_MAX,
              f"vBEAR h {vb.h} not within 25% of {YSD1_VBEAR_H}, or sigma {sigma} >= 0.25")


def lag_select_phase(csv, prefix, device="cuda", lag=LAG):
    """4f (J): lag selection over (G) by every route: select_lag on a
    recount of the reads at lags 1..lag (the summarize counter is gone),
    select_lag_from_tsvs on summarize's shards, and the CLI's counting and
    --counts routes with --json. Checks that all four agree at
    LAG_SELECT_RTOL and on the best lag. Returns the count_chunk launches
    of the recount and of the CLI's counting route, and the recount's
    LagSelection."""
    import contextlib
    import io

    import torch
    from bear_tpu_torch.counting import summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.models import lag_select_cli, lag_selection

    lags = range(1, lag + 1)
    count_chunk_update.launches = 0
    counter = summarize.run_counting(csv, lags, device=device)
    counter.sync()
    launches = {"lag_select": count_chunk_update.launches}
    table = lag_selection.select_lag(counter)
    del counter
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    tsv = lag_selection.select_lag_from_tsvs(prefix, lags, device=device)

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            best = lag_select_cli.main(lag_select_cli.build_parser().parse_args(
                argv + ["-l", str(lag), "--json", "--device", torch.device(device).type]))
        payload = json.loads(buf.getvalue())
        check(best == payload["best_lag"], "lag_select_cli's best lag")
        return np.array(payload["log_marginals"]), payload["best_lag"]

    count_chunk_update.launches = 0
    counted, counted_best = cli([csv])
    launches["lag_select_cli"] = count_chunk_update.launches
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    from_tsv, tsv_best = cli([prefix, "--counts"])
    err = max(float(np.max(np.abs(m / table.log_marginals - 1)))
              for m in (tsv.log_marginals, counted, from_tsv))
    check(err <= LAG_SELECT_RTOL and table.best == tsv.best == counted_best == tsv_best,
          f"lag selection routes disagree: max rel err {err:.3e}, best lags {table.best}, "
          f"{tsv.best}, {counted_best}, {tsv_best}")
    print(f"[lag] lags 1..{lag}, alphas {table.alphas.tolist()}: best lag {table.best} (alpha "
          f"{table.best_alpha(table.best):g}); the four routes agree to {err:.3e} (tolerance "
          f"{LAG_SELECT_RTOL}); log marginals at the best alpha "
          f"{[round(float(v), 1) for v in table.log_marginals.max(axis=-1)]}; count_chunk "
          f"launches of the recount {launches['lag_select']}, of the CLI's counting route "
          f"{launches['lag_select_cli']}")
    return launches, table


def assembly_margin(gen, seed_s, index, direction, step, table, lag, prior, seed, n_seqs,
                    flank, get_map):
    """The CPU float64 Gumbel-max margin (best score minus the runner-up) at
    one step of one generated sequence, replayed from its keys: how close
    the pick was to another letter. ``prior`` maps the step's window codes
    [lag] to the concentration added to its counts (van, or ar / h)."""
    import torch
    from bear_tpu_torch.inference import assemble
    from bear_tpu_torch.ops import keyed_random as kr
    from bear_tpu_torch.ops.loggamma import log_dirichlet_draw_keyed

    if direction == 0:  # the left flank extends the seed's reverse complement
        prefix = assemble._revcomp(gen)[: flank + len(seed_s) + step]
    else:
        prefix = gen[: flank + len(seed_s) + step]
    window = ["ACGT".index(c) for c in prefix[-lag:]]
    row = (4**lag - 1) // 3 + int("".join(str(c) for c in window), 4)
    batch_key = kr.fold_in(kr.key(seed), direction * assemble.DIRECTION_STRIDE)
    conc = prior(torch.tensor(window)) + torch.as_tensor(table[row], dtype=torch.float64)
    conc[-1] = 0.0
    if get_map:
        lp = torch.log(torch.clamp_min(conc, 1e-30) / conc[:4].sum())
    else:
        key = kr.fold_in(kr.fold_in(batch_key, index), row)
        lg = log_dirichlet_draw_keyed(key, conc, n_iter=assemble.DRAW_ITERS)
        lp = lg - torch.logsumexp(lg, dim=-1)
    g = assemble._gumbel(batch_key, range(step, step + 1), n_seqs, torch.float64, "cpu")
    top = torch.sort(g[0, index] + lp[:4], descending=True).values
    return float(top[0] - top[1])


def assembly_phase(reads, groups, csv, model_dir, out_dir, device="cuda", lag=LAG,
                   genome_mb=GENOME_MB, n_seeds=ASM_SEEDS, num=ASM_NUM, flank=ASM_FLANK,
                   check_cfg=ASM_CHECK, keyed=None):
    """4f (K): the assembly CLI on (G)'s reads (counted with reverse=True at
    ``lag``) with the streamed CNN of ``model_dir``: ``n_seeds`` seeded 150
    bp windows of the genome, ``num`` samples each, ``flank`` letters left
    and right, sampled and --map, its FASTA checked (count, lengths,
    letters, the seed in place). Its count and its generation, called apart
    by ``run_counting`` and ``assemble_no_ends`` the way the CLI calls
    them, must give the CLI's sequences. Then float64 rollouts on
    ``device`` of ``check_cfg`` = (seeds, samples, lag, flank letters) from
    a small table, BMM and BEAR (a small linear AR), are held against the
    same on the CPU, sequence for sequence (a flip is allowed only at a
    Gumbel margin below ASM_MARGIN). Returns the count_chunk launches of
    the CLI and of the direct count; ``keyed`` gets the keyed_draw
    launches of the sampled CLI run ("assemble_cli") and of its generation
    called apart ("assemble")."""
    import torch
    from bear_tpu_torch.counting import engine, fastx
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.counting.summarize import run_counting
    from bear_tpu_torch.inference import assemble, assemble_cli
    from bear_tpu_torch.inference.scoring import load_bear
    from bear_tpu_torch.models.ar_funcs import LinearAR
    from bear_tpu_torch.ops import keyed_draw

    keyed = {} if keyed is None else keyed
    seeds = assembly_seeds(genome_mb, n_seeds)
    os.makedirs(out_dir, exist_ok=True)
    seeds_fa = os.path.join(out_dir, "seeds.fa")
    with open(seeds_fa, "w") as fh:
        fh.writelines(f">s{i}\n{s}\n" for i, s in enumerate(seeds))
    dev_type = torch.device(device).type
    argv = [seeds_fa, "--counts-csv", csv, "--model-dir", model_dir, "--left", str(flank),
            "--right", str(flank), "--num", str(num), "--seed", str(SEED), "--device", dev_type]
    launches = {"assemble_cli": 0}
    cli = {}
    for mode in ("sampled", "map"):
        out = os.path.join(out_dir, mode)
        count_chunk_update.launches = 0
        keyed_draw.launches = 0
        rc = assemble_cli.main(argv + ["--out", out] + (["--map"] if mode == "map" else []))
        launches["assemble_cli"] += count_chunk_update.launches
        if mode == "sampled":
            keyed["assemble_cli"] = keyed_draw.launches
        gen = [s for _, s in fastx.iter_fasta(os.path.join(out, "seqs.fa"))]
        L = ASM_SEED_BP + 2 * flank
        ok = (rc == 0 and len(gen) == n_seeds * num and all(
            len(s) == L and set(s) <= set("ACGT") and s[flank:flank + ASM_SEED_BP]
            == seeds[i // num] for i, s in enumerate(gen)))
        check(ok, f"assemble_cli {mode}: {len(gen)} sequences, or wrong lengths/letters")
        cli[mode] = (gen, count_chunk_update.launches)

    # the CLI's count and generation, called apart with its arguments
    lag_m, _, h, ar_apply, _ = load_bear(model_dir, device=device)
    check(lag_m == lag, f"the model directory's lag {lag_m} is not {lag}")
    count_chunk_update.launches = 0
    counter = run_counting(csv, lags=[lag], reverse=True, alphabet="dna", device=device)
    counter.sync()
    launches["assemble"] = count_chunk_update.launches
    table = counter.table(lag)[0]
    for mode in ("sampled", "map"):
        keyed_draw.launches = 0
        gen, _ = assemble.assemble_no_ends(
            seeds, [[flank, flank]] * n_seeds, num, lag=lag, counter_table=table, h=h,
            ar_apply=ar_apply, get_map=mode == "map", seed=SEED, device=device)
        if mode == "sampled":
            keyed["assemble"] = keyed_draw.launches
        cli_gen, cli_launches = cli[mode]
        same = int(np.sum(gen.reshape(-1) == np.array(cli_gen)))
        check(same == len(cli_gen), f"assemble_no_ends {mode} called apart gives {same} of "
              f"{len(cli_gen)} of the CLI's sequences")
        print(f"[assemble] assemble_cli {mode}, lag {lag}, {n_seeds} seeds x {num}, "
              f"--left {flank} --right {flank}: the CLI ({cli_launches} count_chunk launches) "
              f"{len(set(cli_gen))} distinct sequences; its generation called apart "
              f"{2 * flank * n_seeds * num:,} letters, the same {same} sequences; its reverse "
              f"count called apart {launches['assemble']} count_chunk launches")
    del counter, table
    if dev_type == "cuda":
        torch.cuda.empty_cache()

    # float64 on the device against the CPU, from the same seed, small table
    c_seeds, c_num, c_lag, c_flank = check_cfg
    counter = engine.TransitionCounter(lags=[c_lag], n_groups=1, device=device)
    for chunk in read_chunks(reads[:20_000], np.zeros(min(20_000, len(reads)), np.int32),
                             rows=4096):
        counter.add_chunk(chunk)
    table = counter.table(c_lag)[0]
    cpu_table = table.cpu()
    # a small linear AR, scaled so that ar / h is of the counts' size here
    ar_cpu = LinearAR(c_lag, 4, dtype=torch.float64, device="cpu",
                      generator=torch.Generator().manual_seed(SEED))
    ar_cpu.load_params([40.0 * p for p in ar_cpu.params_list()])
    ar_cpu.requires_grad_(False)
    ar_dev = LinearAR(c_lag, 4, dtype=torch.float64, device=device)
    ar_dev.load_params(ar_cpu.params_list())
    ar_dev.requires_grad_(False)
    bear_h = 0.02
    models = {
        "BMM": (dict(van=0.5), dict(van=0.5),
                lambda w: torch.full((5,), 0.5, dtype=torch.float64)),
        "BEAR": (dict(h=bear_h, ar_apply=ar_dev), dict(h=bear_h, ar_apply=ar_cpu),
                 lambda w: ar_cpu(torch.eye(5, dtype=torch.float64)[w]) / bear_h),
    }
    lengths = [[c_flank, c_flank]] * c_seeds
    for name, (dev_kw, cpu_kw, prior) in models.items():
        for get_map in (False, True):
            kw = dict(lag=c_lag, seed=3, dtype=torch.float64, get_map=get_map)
            on_dev, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num,
                                                  counter_table=table, device=device,
                                                  **kw, **dev_kw)
            on_cpu, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num,
                                                  counter_table=cpu_table, device="cpu",
                                                  **kw, **cpu_kw)
            flat_d, flat_c = on_dev.reshape(-1), on_cpu.reshape(-1)
            flips = []
            for i in np.flatnonzero(flat_d != flat_c):
                diff = [p for p, (a, b) in enumerate(zip(flat_d[i], flat_c[i])) if a != b]
                left = [p for p in diff if p < c_flank]  # generated first, outward
                direction, step = ((0, c_flank - 1 - max(left)) if left
                                   else (1, min(diff) - c_flank - ASM_SEED_BP))
                margin = assembly_margin(flat_c[i], seeds[i // c_num], i, direction, step,
                                         cpu_table.numpy(), c_lag, prior, 3, len(flat_c),
                                         c_flank, get_map)
                flips.append((int(i), direction, step, margin))
            check(all(m < ASM_MARGIN for *_, m in flips),
                  f"assembly {name} float64 {device} differs from the CPU beyond a Gumbel tie: "
                  f"{flips}")
            print(f"[assemble] {name} float64 {device} vs CPU, lag {c_lag}, {c_seeds} seeds x "
                  f"{c_num}, {c_flank} letters each side, {'MAP' if get_map else 'sampled'}: "
                  f"{len(flat_d) - len(flips)} of {len(flat_d)} sequences identical; flips "
                  f"(sequence, direction, step, margin): {flips}")
    return launches


def shard_case(name):
    """(lags, n_groups, A, [(codes, meta)], passes, [pass indices]): the
    host inputs of one row-range edge case of count_chunk and the row
    ranges it is held in. The count_case inputs split over a few passes,
    and a poly-T lag-15 chunk (whole and shorter-than-the-lag reads) in the
    first and last of phase 4g (L)'s passes: its '['-padded rows lie in
    pass 0, the all-T context at the last row, 1,431,655,764."""
    from bear_tpu_torch.counting import count_chunk, engine
    from bear_tpu_torch.counting.multipass import min_passes

    if name != "poly_t_lag15":
        passes = dict(SHARD_CASES)[name]
        return (*count_case(name), passes, list(range(passes)))
    lags = tuple(range(1, PASSES_LAG + 1))
    items = [(np.full(n, 3, np.int8), i % 2) for i, n in enumerate([150] * 8 + list(range(15)))]
    chunks = engine.chunk_reads(iter(items), PASSES_LAG, batch_size=64)
    passes = min_passes(lags, N_GROUPS)
    return lags, N_GROUPS, 4, [
        (np.ascontiguousarray(c.codes, np.int8),
         count_chunk.pack_meta(c.lengths, c.skip, c.stopped, c.groups, c.fresh))
        for c in chunks], passes, [0, passes - 1]


def shard_vs_plain(dev, lags, n_groups, A, inputs, passes, pass_idx):
    """One row range's table counted on the card by count_chunk's row-range
    form and by its plain version, each over every (codes, meta) input, in
    MultiPassTransitionCounter's layout for ``passes``."""
    import torch
    from bear_tpu_torch.counting.count_chunk import count_chunk_plain, count_chunk_update
    from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter

    layout = MultiPassTransitionCounter(lags, n_groups=n_groups, passes=passes,
                                        alphabet="dna" if A == 4 else "prot", device=dev)
    shard = (pass_idx, layout._per_lag)
    a = torch.zeros(layout.table_size, dtype=torch.int32, device=dev)
    b = torch.zeros_like(a)
    for codes, meta in inputs:
        c = torch.from_numpy(codes).to(dev)
        m = torch.from_numpy(meta).to(dev)
        count_chunk_update(a, c, m, lags, n_groups, A, shard=shard)
        count_chunk_plain(b, c, m, lags, n_groups, A, shard=shard)
    torch.cuda.synchronize()
    return a, b


def distinct_rows(reads, max_lag, dev):
    """{lag: distinct context rows} at lags 1..max_lag over whole, stopped
    reads (positions 0..L, '['-padded prefixes): a plain torch.unique
    recount on ``dev``, independent of the counters."""
    import torch

    r = torch.from_numpy(reads).to(dev, torch.int64)
    L = r.shape[1]
    padded = torch.nn.functional.pad(r, (max_lag, 0))
    code = torch.zeros((r.shape[0], L + 1), dtype=torch.int64, device=dev)
    out = {}
    for lag in range(1, max_lag + 1):
        code += padded[:, max_lag - lag : max_lag - lag + L + 1] * 4 ** (lag - 1)
        suffix = np.minimum(np.arange(L + 1), lag)
        offset = torch.as_tensor((4**suffix - 1) // 3, device=dev)
        out[lag] = int(torch.unique(code + offset).numel())
    return out


def mf_for(rows, n_bins):
    """summarize's -mf that makes ``rows`` nonzero rows (all lags, N_GROUPS
    dataset columns) into ``n_bins`` shards per lag (compute_n_bin_bits)."""
    return repr(rows * N_GROUPS * 32 / (0.75 * n_bins * 1e9))


def same_shards(prefix_a, prefix_b, lags):
    """Check that two summarize runs wrote the same shards, byte for byte,
    at ``lags``; returns the number of files compared."""
    import filecmp
    import glob

    n = 0
    for lag in lags:
        a = sorted(glob.glob(f"{prefix_a}_lag_{lag}_file_*.tsv"))
        b = sorted(glob.glob(f"{prefix_b}_lag_{lag}_file_*.tsv"))
        check(len(a) == len(b) > 0 and [os.path.basename(p) for p in a]
              == [os.path.basename(p) for p in b], f"lag {lag}: shards {a} vs {b}")
        for x, y in zip(a, b):
            check(filecmp.cmp(x, y, shallow=False), f"{y} differs from {x}")
        n += len(a)
    return n


def summarize_run(csv, prefix, argv, device):
    """summarize.main through its parser, its count_chunk launches counted
    from 0 just before and read just after. Returns (shards per lag, the
    forward pass's report, launches)."""
    import torch
    from bear_tpu_torch.counting import summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update

    os.makedirs(os.path.dirname(prefix))
    args = summarize.build_parser().parse_args(
        [csv, prefix, *argv, "--device", torch.device(device).type])
    report = {}
    count_chunk_update.launches = 0
    n_bins, _ = summarize.main(args, report)
    return n_bins, report["forward"], count_chunk_update.launches


def passes_phase(s_run, ref_rows, work, device="cuda", dense_lag=LAG, lag=PASSES_LAG,
                 passes=None):
    """4g (L): summarize -l ``lag`` in ``passes`` row-range passes (by
    default the fewest the int32 guard accepts) on 4e's FASTQ files, -mf set
    for 4e's shard count. Checks one count_chunk launch per chunk and pass,
    conservation at every lag (summarize's own check), the nonzero rows of
    every lag against the plain recount, and lags 1..dense_lag byte for
    byte against 4e's shards. Returns what (M) and (N) use."""
    from bear_tpu_torch.counting.multipass import min_passes

    lags = range(1, lag + 1)
    passes = passes or min_passes(lags, N_GROUPS)
    prefix = os.path.join(work, "passes", "run")
    mf = mf_for(sum(ref_rows[l] for l in lags), s_run["n_bins"])
    n_bins, run, launches = summarize_run(
        s_run["csv"], prefix, ["-l", str(lag), "--passes", str(passes), "-mf", mf], device)
    stats = run["stats"]
    on_card = device != "cpu"
    check(launches == (passes * stats["chunks"] if on_card else 0),
          f"summarize --passes {passes} launched count_chunk {launches} times for "
          f"{stats['chunks']} chunks")
    check(run["rows"] == {l: ref_rows[l] for l in lags},
          f"nonzero rows per lag {run['rows']} differ from the plain recount's")
    check(n_bins == s_run["n_bins"], f"{n_bins} shards per lag, 4e wrote {s_run['n_bins']}")
    n_files = same_shards(s_run["prefix"], prefix, range(1, dense_lag + 1))
    per_lag = stats["bases"] + stats["reads"]
    print(f"[passes] summarize -l {lag} --passes {passes} (-mf {mf}): {stats['chunks']} chunks "
          f"per pass, {launches} count_chunk launches, a {run['table_bytes']:,}-byte row range "
          f"on {device}; {per_lag:,} transitions per lag x {lag} lags conserved")
    print(f"[passes] nonzero rows per lag == the plain torch.unique recount's; lags "
          f"1..{dense_lag}: {n_files} shards byte-identical to 4e's; rows at lags "
          f"{dense_lag + 1}..{lag}: {[run['rows'][l] for l in range(dense_lag + 1, lag + 1)]}")
    return dict(passes=passes, prefix=prefix, launches=launches, chunks=stats["chunks"])


def sparse_phase(s_run, p_run, ref_rows, work, device="cuda", dense_lag=LAG,
                 passes_lag=PASSES_LAG, lag=SPARSE_LAG, applies=SPARSE_APPLIES,
                 batch=TRAIN_BATCH, check_chunks=SPARSE_CHECK_CHUNKS):
    """4g (M): summarize -l ``lag`` on 4e's files, which routes itself to
    the sparse-first counter (key buffers sorted on the card; no
    count_chunk), -mf set for 4e's shard count. Checks no count_chunk
    launch, conservation at every lag, the nonzero rows against the plain
    recount, lags 1..dense_lag byte for byte against 4e's shards and lags
    dense_lag+1..passes_lag against (L)'s, and exact counts of the first
    ``check_chunks`` chunks on the card against the CPU. Then
    ``to_dataset(lag)`` and ``applies`` linear-BEAR applies (first ELBOs
    against CPU float64), written as a model directory. Returns (the
    counter, the model directory)."""
    import itertools

    import torch
    from bear_tpu_torch.counting import engine, native
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    lags = range(1, lag + 1)
    prefix = os.path.join(work, "sparse", "run")
    mf = mf_for(sum(ref_rows[l] for l in lags), s_run["n_bins"])
    n_bins, run, launches = summarize_run(s_run["csv"], prefix, ["-l", str(lag), "-mf", mf],
                                          device)
    counter = run["counter"]
    stats = run["stats"]
    check(isinstance(counter, SparseTransitionCounter) and launches == 0,
          f"-l {lag} ran {type(counter).__name__} with {launches} count_chunk launches")
    check(run["rows"] == {l: ref_rows[l] for l in lags},
          f"nonzero rows per lag {run['rows']} differ from the plain recount's")
    check(n_bins == s_run["n_bins"], f"{n_bins} shards per lag, 4e wrote {s_run['n_bins']}")
    n_dense = same_shards(s_run["prefix"], prefix, range(1, dense_lag + 1))
    n_passes = same_shards(p_run["prefix"], prefix, range(dense_lag + 1, passes_lag + 1))
    per_lag = stats["bases"] + stats["reads"]
    print(f"[sparse] summarize -l {lag} (-mf {mf}) -> SparseTransitionCounter: "
          f"{stats['chunks']} chunks, 0 count_chunk launches, key buffers "
          f"{run['table_bytes']:,} bytes on {device}; {per_lag:,} transitions per lag x {lag} "
          f"lags conserved")
    print(f"[sparse] nonzero rows per lag == the plain recount's; {n_dense} shards of lags "
          f"1..{dense_lag} == 4e's and {n_passes} of lags {dense_lag + 1}..{passes_lag} == "
          f"(L)'s, byte for byte; rows at lags {passes_lag + 1}..{lag}: "
          f"{[run['rows'][l] for l in range(passes_lag + 1, lag + 1)]}")

    first = s_run["files"][0][0]
    codes_flat, offsets = native.load().parse(first, "fq")
    some = list(itertools.islice(engine.chunks_from_packed(codes_flat, offsets, 0, lag),
                                 check_chunks))
    on = {}
    for where in (device, "cpu"):
        on[where] = SparseTransitionCounter(lags, n_groups=N_GROUPS, device=where)
        for chunk in some:
            on[where].add_chunk(chunk)
    for l in lags:
        (ka, va), (kb, vb) = on[device]._consolidated(l), on["cpu"]._consolidated(l)
        check(np.array_equal(ka, kb) and np.array_equal(va, vb),
              f"sparse counts of {len(some)} chunks at lag {l} on {device} differ from the CPU")
    print(f"[sparse] {len(some)} chunks of {os.path.basename(first)} counted on {device} and "
          f"on the CPU: the same keys and counts at all {lag} lags "
          f"({sum(len(on['cpu']._consolidated(l)[0]) for l in lags):,} keys)")
    del on

    ds = counter.to_dataset(lag)
    n_rows = len(ds.kmers)
    n_use = min(n_rows, applies * batch)
    per_epoch = -(-n_use // batch)
    epochs = -(-applies // per_epoch)
    codes = torch.as_tensor(ds.codes[:n_use], device=device)
    counts = torch.as_tensor(ds.counts[:n_use, 0], dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(SEED)
    ar = get_ar_func("linear", lag, 4, device=device)
    init = bear_net.init_params(gen, ar)
    p0 = [init["h_signed"]] + init["ar"]
    kw = dict(num_kmers=n_rows, batch_size=batch, learning_rate=0.01, params_restart=p0)
    res = bear_net.train(codes, counts, ar_func=ar, epochs=epochs, dtype=torch.float32,
                         device=device, **kw)
    elbos = res.elbos
    check(np.isfinite(elbos).all(), "lag-20 ELBOs not finite")
    k = min(N_ELBO_CHECK, per_epoch)
    ar64 = get_ar_func("linear", lag, 4, dtype=torch.float64, device="cpu")
    cpu = bear_net.train(codes[: k * batch].cpu(), counts[: k * batch].cpu().double(),
                         ar_func=ar64, epochs=1, dtype=torch.float64, device="cpu", **kw)
    elbo_err = float(np.max(np.abs(elbos[:k] / cpu.elbos[:k] - 1)))
    check(elbo_err <= ELBO_RTOL, f"first {k} lag-{lag} ELBOs {elbos[:k]} differ from CPU "
          f"float64 {cpu.elbos} by {elbo_err:.3e}")
    model_dir = os.path.join(work, f"linear_lag{lag}")
    write_model_dir(model_dir, res, lag, "linear", {}, epochs, batch, lr=0.01)
    print(f"[sparse] to_dataset({lag}): {n_rows:,} rows; linear BEAR on {n_use:,} of them, "
          f"batch {batch}: {len(elbos)} applies, h {res.h:.6g}; first {k} ELBOs vs CPU "
          f"float64 max rel err {elbo_err:.3e} (tolerance {ELBO_RTOL})")
    return counter, model_dir


def sparse_lag_phase(counter, dense, csv, passes, chunks, device="cuda", dense_lag=LAG,
                     passes_lag=PASSES_LAG):
    """4g (N): select_lag over (M)'s counter (lags 1..counter's max), which
    routes to select_lag_sparse, against (J)'s dense sweep ``dense`` at lags
    1..dense_lag; then lag_select_cli -l passes_lag --passes ``passes``
    against select_lag_sparse's lags (one count_chunk launch per chunk and
    pass). Returns the CLI's count_chunk launches."""
    import contextlib
    import io

    import torch
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.models import lag_select_cli, lag_selection

    sel = lag_selection.select_lag(counter)
    err = float(np.max(np.abs(sel.log_marginals[:dense_lag] / dense.log_marginals - 1)))
    check(sel.lags == tuple(counter.lags) and err <= LAG_SELECT_RTOL,
          f"select_lag_sparse differs from (J)'s dense sweep at lags 1..{dense_lag}: {err:.3e}")
    buf = io.StringIO()
    count_chunk_update.launches = 0
    with contextlib.redirect_stdout(buf):
        best = lag_select_cli.main(lag_select_cli.build_parser().parse_args(
            [csv, "-l", str(passes_lag), "--passes", str(passes), "--json", "--device",
             torch.device(device).type]))
    launches = count_chunk_update.launches
    payload = json.loads(buf.getvalue())
    cli_err = float(np.max(np.abs(np.array(payload["log_marginals"])
                                  / sel.log_marginals[:passes_lag] - 1)))
    check(best == payload["best_lag"] and cli_err <= LAG_SELECT_RTOL,
          f"lag_select_cli --passes differs from select_lag_sparse: {cli_err:.3e}")
    check(launches == (passes * chunks if device != "cpu" else 0),
          f"lag_select_cli --passes {passes} launched count_chunk {launches} times")
    print(f"[lag] select_lag over the sparse counter, lags 1..{max(counter.lags)}: best lag "
          f"{sel.best} (alpha {sel.best_alpha(sel.best):g}); lags 1..{dense_lag} vs (J)'s dense "
          f"sweep max rel err {err:.3e}; lag_select_cli -l {passes_lag} --passes {passes}: "
          f"{launches} count_chunk launches, best lag {best}, vs select_lag_sparse "
          f"{cli_err:.3e} (tolerance {LAG_SELECT_RTOL})")
    return launches


def assembly_seeds(genome_mb=GENOME_MB, n_seeds=ASM_SEEDS):
    """(K)'s seeds: ``n_seeds`` 150 bp windows of the genome."""
    G = int(genome_mb * 1e6)
    genome = synth_genome(np.random.default_rng(SEED), G)
    starts = np.random.default_rng(SEED + 1).integers(0, G - ASM_SEED_BP, n_seeds)
    return decode_reads(genome[starts[:, None] + np.arange(ASM_SEED_BP)[None, :]])


def sparse_generation_phase(counter, model_dir, reads, groups, device="cuda",
                            lag=SPARSE_LAG, dense_lag=LAG, genome_mb=GENOME_MB,
                            n_seeds=ASM_SEEDS, num=ASM_NUM, flank=ASM_FLANK,
                            check_cfg=ASM_CHECK, n_score=N_SCORE, keyed=None):
    """4g (O): the held-out reads scored through TableCounter on (M)'s
    counter at ``lag`` (get_bear_probs_seqs, MAP: AR, BEAR and BMM columns,
    (M)'s model on the card in float32 against its float64 copy on the
    CPU); then a reverse sparse count of the train reads at ``lag``, its
    SparseTableIndex, and BMM assembly from it, (K)'s seeds and sizes,
    sampled and MAP; float64 generation of ``check_cfg`` = (seeds, samples,
    -, letters each side) on the card against the CPU, and at ``dense_lag``
    a sparse index against the dense table of the same reads. ``keyed`` gets
    the sampled generation's keyed_draw launches ("sparse_assembly")."""
    import torch
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.inference import assemble
    from bear_tpu_torch.inference.scoring import (SparseTableIndex, TableCounter,
                                                  get_bear_probs_seqs)
    from bear_tpu_torch.ops import keyed_draw

    keyed = {} if keyed is None else keyed
    test = np.flatnonzero(groups == 1)[:n_score]
    seqs = decode_reads(reads[test])
    table_counter = TableCounter(counter, lag)
    kw = dict(vans=VAN_REG, get_map=True, counter=table_counter)
    scores = get_bear_probs_seqs(model_dir, seqs, 0, device=device, **kw)
    ref = get_bear_probs_seqs(model_dir + "_float64", seqs, 0, device="cpu", **kw)
    diff = np.abs(scores - ref)
    check(scores.shape == (len(seqs), 2 + len(VAN_REG)) and np.isfinite(scores).all()
          and bool((diff <= SCORE_ATOL + SCORE_RTOL * np.abs(ref)).all()),
          f"lag-{lag} scores through the sparse index differ from CPU float64: max "
          f"{diff.max()}")
    print(f"[sparse] {len(seqs)} held-out reads scored at lag {lag} through TableCounter on "
          f"the sparse counter: get_bear_probs_seqs MAP, AR + BEAR + {len(VAN_REG)} BMM "
          f"columns; vs CPU float64 max |diff| {diff.max():.3e}")
    del table_counter

    train = np.flatnonzero(groups == 0)
    sp = SparseTransitionCounter([lag], reverse=True, device=device)
    for chunk in read_chunks(reads[train], np.zeros(len(train), np.int32)):
        sp.add_chunk(chunk)
    index = SparseTableIndex(sp, lag)
    seeds = assembly_seeds(genome_mb, n_seeds)
    van = VAN_REG[0]
    for mode in ("sampled", "map"):
        keyed_draw.launches = 0
        gen, _ = assemble.assemble_no_ends(seeds, [[flank, flank]] * n_seeds, num, lag=lag,
                                           counter_table=index, van=van,
                                           get_map=mode == "map", seed=SEED, device=device)
        if mode == "sampled":
            keyed["sparse_assembly"] = keyed_draw.launches
        flat = gen.reshape(-1)
        check(len(flat) == n_seeds * num and all(
            len(s) == ASM_SEED_BP + 2 * flank and set(s) <= set("ACGT")
            and s[flank:flank + ASM_SEED_BP] == seeds[i // num] for i, s in enumerate(flat)),
            f"lag-{lag} sparse assembly {mode}: wrong count, lengths or letters")
        print(f"[sparse] assembly at lag {lag} from a SparseTableIndex ({len(index.rows):,} "
              f"rows; reverse count of {len(train):,} reads), BMM van {van}, {mode}, {n_seeds} "
              f"seeds x {num}, {flank} letters each side: {len(set(flat))} distinct sequences")

    c_seeds, c_num, _, c_flank = check_cfg
    lengths = [[c_flank, c_flank]] * c_seeds
    for get_map in (False, True):
        kw = dict(lag=lag, van=van, seed=3, dtype=torch.float64, get_map=get_map)
        on_dev, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num,
                                              counter_table=index, device=device, **kw)
        on_cpu, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num,
                                              counter_table=index, device="cpu", **kw)
        same = int(np.sum(on_dev.reshape(-1) == on_cpu.reshape(-1)))
        check(same == on_cpu.size, f"lag-{lag} sparse assembly float64 {device} vs CPU: "
              f"{same} of {on_cpu.size} sequences identical")
        print(f"[sparse] BMM float64 {device} vs CPU from the lag-{lag} sparse index, "
              f"{'MAP' if get_map else 'sampled'}: {same} of {on_cpu.size} sequences identical")
    del sp, index

    small = read_chunks(reads[train], np.zeros(len(train), np.int32))
    sp = SparseTransitionCounter([dense_lag], reverse=True, device=device)
    dense = engine.TransitionCounter([dense_lag], reverse=True, device=device)
    for chunk in small:
        sp.add_chunk(chunk)
        dense.add_chunk(chunk)
    index, table = SparseTableIndex(sp, dense_lag), dense.table(dense_lag)[0]
    for get_map in (False, True):
        kw = dict(lag=dense_lag, van=van, seed=5, get_map=get_map, device=device)
        a, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num, counter_table=index,
                                         **kw)
        b, _ = assemble.assemble_no_ends(seeds[:c_seeds], lengths, c_num, counter_table=table,
                                         **kw)
        check(np.array_equal(a, b), f"lag-{dense_lag} assembly from the sparse index differs "
              f"from the dense table's ({'MAP' if get_map else 'sampled'})")
    print(f"[sparse] lag {dense_lag}: a SparseTableIndex ({len(index.rows):,} rows) and the "
          f"dense table of the same reverse count give the same {a.size} sequences, sampled "
          f"and MAP")


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a / b - 1)))


def attention_phase(out_dir, device="cuda", epochs=None):
    """4h (P): bear_attn_bear.cfg's values through ``train_bear_net.main`` in
    float32 (``epochs`` overrides its 10,000 for a rehearsal). Checks the
    first ELBOs against CPU float64 from the same initial parameters, the
    CLI's held-out perplexities (evaluated on the device) against CPU
    float64 evaluation of the written parameters and, at the full 10,000,
    the BEAR perplexity against the first card run's."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net, train_bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.checkpoint import load_params_list
    from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path

    cfg = attn_config(out_dir + "*")
    if epochs is not None:
        cfg["train"]["epochs"] = str(epochs)
    run = RunConfig.from_configparser(cfg)
    train_bear_net.main(cfg, device=device)
    res = cfg["results"]
    h = float(res["h"])
    perp = {k: json.loads(res[f"heldout_perplex_{k}"]) for k in ("BEAR", "AR", "BMM")}
    acc = {k: json.loads(res[f"heldout_accuracy_{k}"]) for k in ("BEAR", "AR", "BMM")}
    with open(os.path.join(out_dir, "scalars.jsonl")) as fh:
        elbos = [r["value"] for r in map(json.loads, fh) if r["tag"] == "elbo"]
    check(len(elbos) == int(run.epochs_raw) and np.isfinite(elbos).all(),
          f"attention CLI: {len(elbos)} ELBOs for {run.epochs_raw} applies, or not finite")

    # The CLI's start: a fresh init from seed 10, drawn on the CPU in float32.
    ds = load_dense(bundled_ysd1_path(), "dna", run.num_ds)
    init = bear_net.init_params(torch.Generator().manual_seed(run.seed),
                                get_ar_func("attention", run.lag, 4, ATTN_KW, device="cpu"))
    p0 = [init["h_signed"]] + init["ar"]
    ar64 = get_ar_func("attention", run.lag, 4, ATTN_KW, dtype=torch.float64, device="cpu")
    base = dict(num_kmers=ds.num_kmers, batch_size=int(run.batch_size_raw),
                learning_rate=run.learning_rate, seed=run.seed)
    k = min(N_ELBO_CHECK, len(elbos))
    ref = bear_net.train(ds.codes, ds.counts[:, 0], ar_func=ar64, epochs=k, params_restart=p0,
                         dtype=torch.float64, device="cpu", **base)
    elbo_err = rel_err(elbos[:k], ref.elbos)
    check(elbo_err <= ELBO_RTOL, f"attention: first {k} ELBOs {elbos[:k]} differ from CPU "
          f"float64 {ref.elbos} by {elbo_err:.3e}")
    written = load_params_list(out_dir)
    out64 = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", float(np.exp(written[0])),
                                ar64, written[1:], VAN_REG, dtype=torch.float64, device="cpu")
    eval_err = max(rel_err(perp["BEAR"], out64[3]), rel_err(perp["AR"], out64[4]),
                   rel_err(perp["BMM"], out64[5]))
    check(eval_err <= ELBO_RTOL, f"attention: held-out perplexities {perp} differ from CPU "
          f"float64 {out64[3:6]} by {eval_err:.3e}")
    if epochs is None:
        check(abs(perp["BEAR"] - ATTN_PERPLEXITY) <= ATTN_PERPLEXITY_ATOL,
              f"attention BEAR held-out perplexity {perp['BEAR']} not within "
              f"{ATTN_PERPLEXITY_ATOL} of {ATTN_PERPLEXITY}")

    print(f"[attn] train_bear_net.main, bear_attn_bear.cfg values in float32 (d_model 64, 4 "
          f"heads, mlp 128, lr {run.learning_rate}): {len(elbos):,} applies; h {h:.6g}; "
          f"held-out perplexity BEAR {perp['BEAR']:.6f} AR {perp['AR']:.6f} BMM {perp['BMM']}; "
          f"accuracy BEAR {acc['BEAR']:.6f} AR {acc['AR']:.6f} BMM {acc['BMM']}; ELBO "
          f"{elbos[0]:.7g} -> {elbos[-1]:.7g}")
    print(f"[attn] first {k} ELBOs vs CPU float64 from the same initial parameters: max rel "
          f"err {elbo_err:.3e}; held-out perplexities vs CPU float64 evaluation of the "
          f"written parameters: max rel err {eval_err:.3e} (tolerance {ELBO_RTOL})")


def optimizer_phase(device="cuda", check_applies=OPT_CHECK_APPLIES):
    """4h (Q): the seven optax optimizers on the YSD1 linear BEAR:
    ``check_applies`` float64 applies on the device and on the CPU from the
    same parameters, then ``check_applies`` float32 applies on the device
    of each and of Adam, their ELBOs finite. Returns {name: float32
    applies}.

    Each rule's float64 run is also repeated on the CPU from a start one ulp
    away (the AR matrix times 1 + 2^-52), which measures how far the rule's
    own dynamics carry a last-bit difference. Where they keep it below
    1e-12 for all ``check_applies`` applies, the device is held to the CPU
    within OPT_RTOL in every ELBO and parameter; where they amplify it
    (rmsprop here: decay 0.9, no momentum, lr 0.01), the device's ELBOs are
    held within OPT_RTOL up to the first apply where the one-ulp runs part,
    and its end within 10x the one-ulp runs' spread."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    init = bear_net.init_params(torch.Generator().manual_seed(10),
                                get_ar_func("linear", 5, 4, device="cpu"))
    p0 = [init["h_signed"]] + init["ar"]
    p_ulp = [p0[0].double(), p0[1].double() * (1 + 2.0 ** -52)]
    base = dict(num_kmers=ds.num_kmers, batch_size=1500, learning_rate=0.01, seed=10)
    c, n = ds.codes, ds.counts[:, 0]

    def run64(name, dev, start):
        ar64 = get_ar_func("linear", 5, 4, dtype=torch.float64, device=dev)
        return bear_net.train(c, n, ar_func=ar64, epochs=check_applies, optimizer_name=name,
                              params_restart=start, dtype=torch.float64, device=dev, **base)

    def param_err(a, b):
        return max(float(np.max(np.abs(x - y))) for x, y in zip(a.params_list, b.params_list))

    for name in OPTAX_NAMES:
        got, want, ulp = run64(name, device, p0), run64(name, "cpu", p0), run64(name, "cpu", p_ulp)
        check(got.opt_state["step"] == check_applies, f"{name}: {got.opt_state['step']} applies")
        parted = np.abs(ulp.elbos / want.elbos - 1) > 1e-12
        n_held = int(np.argmax(parted)) if parted.any() else check_applies
        elbo_ok = np.allclose(got.elbos[:n_held], want.elbos[:n_held], rtol=OPT_RTOL, atol=0)
        if n_held == check_applies:
            end_ok = all(np.allclose(a, b, rtol=OPT_RTOL, atol=1e-15)
                         for a, b in zip(got.params_list, want.params_list))
            held = f"every ELBO and parameter within rtol {OPT_RTOL}"
        else:
            end_ok = param_err(got, want) <= 10 * param_err(ulp, want)
            held = (f"its dynamics amplify a one-ulp start: the CPU's one-ulp runs part at apply "
                    f"{n_held} and end {param_err(ulp, want):.3e} apart; ELBOs held within rtol "
                    f"{OPT_RTOL} over the first {n_held} applies, the end within 10x that "
                    f"spread")
        check(elbo_ok and end_ok, f"{name}: float64 {device} vs CPU differ: ELBOs "
              f"{rel_err(got.elbos[:n_held], want.elbos[:n_held]):.3e} over {n_held} applies, "
              f"parameters {param_err(got, want):.3e} after {check_applies} ({held})")
        print(f"[optim] {name}: {check_applies} float64 applies, {device} vs CPU: ELBO max rel "
              f"err {rel_err(got.elbos, want.elbos):.3e}, parameters max abs err "
              f"{param_err(got, want):.3e}; {held}; h {got.h:.6g}")
    ran = {}
    for name in ["adam"] + OPTAX_NAMES:
        ar = get_ar_func("linear", 5, 4, device=device)
        res = bear_net.train(c, n, ar_func=ar, epochs=check_applies, optimizer_name=name,
                             params_restart=p0, dtype=torch.float32, device=device, **base)
        check(np.isfinite(res.elbos).all(), f"{name}: float32 ELBOs not finite")
        ran[name] = res.opt_state["step"]
    print(f"[optim] YSD1 linear BEAR, float32, {check_applies:,} applies each, ELBOs finite: "
          + ", ".join(ran))
    return ran


def bf16_phase(codes, counts, n_rows, out_dir, device="cuda", lag=LAG, cnn_kw=CNN_KW,
               attn_kw=ATTN_KW, batch=TRAIN_BATCH, epochs=BF16_EPOCHS, trace_applies=20):
    """4h (R): bfloat16 compute of the AR network on the lag-``lag`` handoff:
    the CNN and an attention AR, each trained in float32 and with
    compute_dtype=bfloat16 from the same parameters. Checks the last ELBOs
    within BF16_LOSS_RTOL and the bfloat16 probabilities (float32, summing
    to 1); traces ``trace_applies`` bfloat16 attention applies with
    ``utils.profiling.trace`` and checks the trace lists a kernel of the
    device (on the CPU: an operator)."""
    import torch
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.utils.profiling import trace

    on_card = torch.device(device).type == "cuda"
    train_kw = dict(num_kmers=n_rows, batch_size=batch, learning_rate=TRAIN_LR,
                    dtype=torch.float32, device=device)
    n_apply = epochs * -(-n_rows // batch)
    for name, kw in (("cnn", cnn_kw), ("attention", attn_kw)):
        init = bear_net.init_params(torch.Generator().manual_seed(SEED),
                                    get_ar_func(name, lag, 4, kw, device="cpu"))
        p0 = [init["h_signed"]] + init["ar"]
        res = {}
        for cd in (None, torch.bfloat16):
            ar = get_ar_func(name, lag, 4, kw, compute_dtype=cd, device=device)
            r = bear_net.train(codes, counts[:, 0], ar_func=ar, epochs=epochs,
                               params_restart=p0, **train_kw)
            check(len(r.elbos) == n_apply and np.isfinite(r.elbos).all(),
                  f"{name} {cd}: {len(r.elbos)} ELBOs for {n_apply} applies, or not finite")
            label = "bfloat16" if cd is not None else "float32"
            print(f"[bf16] lag-{lag} {name} BEAR {kw}, {label} compute: {n_apply} applies of "
                  f"{batch:,} rows; ELBO {r.elbos[0]:.7g} -> {r.elbos[-1]:.7g}")
            res[label] = (r, ar)
        (r32, _), (r16, ar16) = res["float32"], res["bfloat16"]
        loss_err = rel_err(r16.elbos[-1], r32.elbos[-1])
        check(loss_err <= BF16_LOSS_RTOL, f"{name}: bfloat16's last ELBO {r16.elbos[-1]} not "
              f"within 1% of float32's {r32.elbos[-1]}")
        with torch.no_grad():
            probs = ar16.apply_codes(codes[:4096], r16.params["ar"])
        sum_err = float((probs.sum(-1) - 1).abs().max())
        check(probs.dtype == torch.float32 and sum_err <= BF16_SUM_ATOL,
              f"{name}: bfloat16 probabilities {probs.dtype}, sums off 1 by {sum_err:.3e}")
        print(f"[bf16] {name}: last ELBO bfloat16 vs float32 rel diff {loss_err:.3e} (tolerance "
              f"{BF16_LOSS_RTOL}); bfloat16 probabilities {probs.dtype}, |sum - 1| <= "
              f"{sum_err:.3e}")

    n_trace = trace_applies * batch
    with trace(out_dir):
        bear_net.train(codes[:n_trace], counts[:n_trace, 0], ar_func=ar16, epochs=1,
                       params_restart=p0, **train_kw)
    path = os.path.join(out_dir, "trace.json")
    check(os.path.exists(path), f"no trace file at {path}")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    want = "kernel" if on_card else "cpu_op"
    n_events = sum(e.get("cat") == want for e in events)
    check(n_events > 0, f"the trace lists no {want} event")
    print(f"[bf16] utils.profiling.trace over {trace_applies} bfloat16 attention applies: "
          f"{os.path.getsize(path):,} bytes, {n_events:,} {want} events")


def refused(fn, match):
    """The message of the ValueError ``fn()`` raises, which must contain
    ``match``; a call that does not raise it fails the run."""
    try:
        fn()
    except ValueError as e:
        if match in str(e):
            return str(e)
        raise
    raise RuntimeError(f"expected a ValueError with {match!r}; the call returned")


def mesh_of(device, n, axis):
    """A 1-D mesh that names ``device`` (the card, or the CPU) n times."""
    import torch
    from bear_tpu_torch.parallel import Mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return Mesh([dev] * n, (axis,))


def mem_available_gb():
    """The host's MemAvailable from /proc/meminfo, in GB."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def data_sharded_phase(chunks, want_rows, want_counts, device="cuda", lag=LAG, shards=MESH_DATA):
    """4i (S): count -> serve's chunks through ShardedTransitionCounter on a
    mesh that names the card ``shards`` times (one int32 replica of the
    lag-``lag`` table each). Checks each replica after chunk 0 against
    count_chunk_plain on that replica's rows, one count_chunk launch per
    replica per chunk, conservation, and the summed tables against phase
    4's nonzero rows and counts exactly. Returns the launches."""
    import torch
    from bear_tpu_torch.counting.count_chunk import (count_chunk_plain, count_chunk_update,
                                                     pack_meta)
    from bear_tpu_torch.parallel import ShardedTransitionCounter
    from bear_tpu_torch.parallel.counting import split_rows

    mesh = mesh_of(device, shards, "data")
    expected = sum(int(c.lengths.sum()) + int(c.stopped.sum()) for c in chunks)
    count_chunk_update.launches = 0
    counter = ShardedTransitionCounter(mesh, [lag], n_groups=N_GROUPS)
    counter.add_chunk(chunks[0])
    counter.sync()
    c0 = chunks[0]
    blocks = split_rows((c0.codes, c0.lengths, c0.skip, c0.stopped, c0.groups, c0.fresh),
                        shards)
    for d, (part, (codes, *rows)) in enumerate(zip(counter.partial_tables(), blocks)):
        want = torch.zeros_like(part)
        count_chunk_plain(want, torch.from_numpy(np.ascontiguousarray(codes)).to(part.device),
                          torch.from_numpy(pack_meta(*rows)).to(part.device), (lag,), N_GROUPS, 4)
        check(torch.equal(part, want), f"(S) replica {d} after chunk 0 differs from "
              f"count_chunk_plain on its {len(codes):,} rows")
        del want
    print(f"[4i] (S) chunk 0 ({len(c0.codes):,} rows) split over {shards} replicas on "
          f"{device}: each replica's table == count_chunk_plain on its "
          f"{len(blocks[0][0]):,} rows, exactly")
    for chunk in chunks[1:]:
        counter.add_chunk(chunk)
    counter.sync()
    launches = count_chunk_update.launches
    on_card = torch.device(device).type == "cuda"
    check(launches == (shards * len(chunks) if on_card else 0),
          f"(S) launched count_chunk {launches} times for {len(chunks)} chunks x {shards}")
    counter.validate(expected)
    rows = counter.nonzero_rows(lag)
    check(np.array_equal(rows, want_rows)
          and np.array_equal(counter.row_counts(lag, rows), want_counts),
          f"(S) tables ({len(rows):,} rows) differ from phase 4's ({len(want_rows):,})")
    print(f"[4i] (S) ShardedTransitionCounter, {shards} replicas of {4 * counter.table_size:,} "
          f"bytes on {device}: {len(chunks)} chunks, {launches} count_chunk launches; "
          f"{expected:,} transitions conserved; tables == phase 4's exactly "
          f"({len(rows):,} rows, both groups)")
    return launches


def row_split_phase(s_run, ref_rows, work, device="cuda", dense_lag=LAG,
                    lag=MESH_ROW_LAG, shards=MESH_ROWS, passes=MESH_ROWS):
    """4i (T): (G)'s FASTQ files through KmerShardedTransitionCounter on a
    mesh that names the card ``shards`` times (a ``kmer`` axis: every slice
    takes the whole chunk, one row-range count_chunk launch each) at lags
    1..``lag``, with summarize's own iter_chunks and export_tsv and -mf set
    for 4e's shard count. Checks the int32 guard's reckoning (two slices
    refused), one launch per slice per chunk, conservation, the nonzero
    rows against the plain recount, lags 1..dense_lag byte for byte against
    4e's shards and lag ``lag`` against summarize -l ``lag`` --passes
    ``passes``; then the one-card refusal of summarize --kmer-shards.
    Returns {path: launches}."""
    import shutil

    import torch
    from bear_tpu_torch.counting import fastx, summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.parallel import KmerShardedTransitionCounter

    lags = range(1, lag + 1)
    # The int32 guard's reckoning at MESH_ROW_LAG (no table is allocated
    # before the first chunk): MESH_ROWS slices fit, one fewer does not.
    full = range(1, MESH_ROW_LAG + 1)
    reason = refused(lambda: KmerShardedTransitionCounter(
        full, n_groups=N_GROUPS, mesh=mesh_of(device, MESH_ROWS - 1, "kmer")), "int32 indexing")
    fits = KmerShardedTransitionCounter(full, n_groups=N_GROUPS,
                                        mesh=mesh_of(device, MESH_ROWS, "kmer")).table_size
    print(f"[4i] (T) lags 1..{MESH_ROW_LAG} x {N_GROUPS} groups: {fits:,} int32 entries "
          f"({4 * fits:,} bytes) per slice over {MESH_ROWS} slices; {MESH_ROWS - 1} slices "
          f"refused: {reason}")
    counter = KmerShardedTransitionCounter(lags, n_groups=N_GROUPS,
                                           mesh=mesh_of(device, shards, "kmer"))
    entries = fastx.read_input_csv(s_run["csv"])
    stats = {}
    count_chunk_update.launches = 0
    for chunk in summarize.iter_chunks(entries, lag, stats=stats):
        counter.add_chunk(chunk)
        stats["chunks"] = stats.get("chunks", 0) + 1
    counter.sync()
    launches = count_chunk_update.launches
    on_card = torch.device(device).type == "cuda"
    check(launches == (shards * stats["chunks"] if on_card else 0),
          f"(T) launched count_chunk {launches} times for {stats['chunks']} chunks x {shards}")
    per_lag = stats["bases"] + stats["reads"]
    counter.validate(expected_transitions=per_lag)
    rows = {l: counter.nonzero_rows(l) for l in lags}
    check({l: len(r) for l, r in rows.items()} == {l: ref_rows[l] for l in lags},
          f"(T) nonzero rows per lag differ from the plain recount's")
    mf = float(mf_for(sum(ref_rows[l] for l in lags), s_run["n_bins"]))
    bits = summarize.compute_n_bin_bits(sum(len(r) for r in rows.values()), N_GROUPS, mf)
    check(2**bits == s_run["n_bins"], f"(T) {2**bits} shards per lag, 4e wrote {s_run['n_bins']}")
    prefix = os.path.join(work, "row_split", "run")
    os.makedirs(os.path.dirname(prefix))
    for l in lags:
        counter.export_tsv(prefix, l, bits, rows=rows[l])
    n_dense = same_shards(s_run["prefix"], prefix, range(1, dense_lag + 1))
    del counter
    _, _, passes_launches = summarize_run(
        s_run["csv"], os.path.join(work, "row_split_passes", "run"),
        ["-l", str(lag), "--passes", str(passes), "-mf", repr(mf)], device)
    n_last = same_shards(os.path.join(work, "row_split_passes", "run"), prefix, [lag])
    print(f"[4i] (T) KmerShardedTransitionCounter, {shards} row ranges on {device}: "
          f"{stats['chunks']} chunks, {launches} count_chunk launches; {per_lag:,} transitions "
          f"per lag x {lag} lags conserved; nonzero rows per lag == the plain recount's; "
          f"{n_dense} shards of lags 1..{dense_lag} == 4e's and {n_last} of lag {lag} == "
          f"summarize -l {lag} --passes {passes}'s ({passes_launches} launches), byte for byte")
    n = max(3, torch.cuda.device_count() + 1)
    args = summarize.build_parser().parse_args(
        [s_run["csv"], os.path.join(work, "refused", "run"), "-l", str(lag),
         "--kmer-shards", str(n)])
    reason = refused(lambda: summarize.main(args),
                     f"needs that many devices; have {torch.cuda.device_count()}")
    print(f"[4i] summarize --kmer-shards {n} on the card's machine is refused: {reason}")
    shutil.rmtree(os.path.dirname(prefix))
    shutil.rmtree(os.path.join(work, "row_split_passes"))
    return {"row_split": launches, "row_split_passes": passes_launches}


def sparse_mesh_phase(s_run, ref_rows, m_prefix, work, device="cuda", lag=SPARSE_LAG,
                      shards=MESH_DATA):
    """4i (U): (M)'s ``-l lag`` count through SparseTransitionCounter on a
    mesh that names the card ``shards`` times (rows of every chunk split
    over a ``data`` axis, key buffers and window sorts per replica), with
    summarize's iter_chunks and export and (M)'s -mf. Checks conservation
    and every shard byte for byte against (M)'s. Returns the counter."""
    import shutil

    from bear_tpu_torch.counting import fastx, summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter

    lags = range(1, lag + 1)
    counter = SparseTransitionCounter(lags, n_groups=N_GROUPS,
                                      mesh=mesh_of(device, shards, "data"))
    stats = {}
    count_chunk_update.launches = 0
    for chunk in summarize.iter_chunks(fastx.read_input_csv(s_run["csv"]), lag, stats=stats):
        counter.add_chunk(chunk)
    counter.sync()
    check(count_chunk_update.launches == 0, "(U) the sparse-first path launched count_chunk")
    per_lag = stats["bases"] + stats["reads"]
    counter.validate(expected_transitions=per_lag)
    rows = {l: counter.nonzero_rows(l) for l in lags}
    mf = float(mf_for(sum(ref_rows[l] for l in lags), s_run["n_bins"]))
    bits = summarize.compute_n_bin_bits(sum(len(r) for r in rows.values()), N_GROUPS, mf)
    prefix = os.path.join(work, "sparse_mesh", "run")
    os.makedirs(os.path.dirname(prefix))
    for l in lags:
        counter.export_tsv(prefix, l, bits, rows=rows[l])
    n_files = same_shards(m_prefix, prefix, lags)
    shutil.rmtree(os.path.dirname(prefix))
    print(f"[4i] (U) SparseTransitionCounter, rows over {shards} replicas on {device} "
          f"(key buffers {4 * counter.table_size:,} bytes in all): {per_lag:,} transitions per "
          f"lag x {lag} lags conserved; all {n_files} shards == (M)'s, byte for byte; no "
          f"count_chunk launch")
    return counter


def two_process_phase(s_run, want_rows, want_counts, sparse_ref, work, device="cuda",
                      procs=MESH_PROCS, reads_kw=None, rows=CHUNK_ROWS, lag=LAG,
                      sparse_lag=SPARSE_LAG, timeout=CHILD_TIMEOUT_S, threads=None, z=None,
                      record=None):
    """4i (V): ``procs`` processes on the card, joined by multihost.initialize
    over TCP on 127.0.0.1. Each counts its host_shard of count -> serve's
    chunks at lag ``lag`` (dense), then of (G)'s FASTQ files at lags
    1..``sparse_lag`` (sparse-first), calling allreduce_tables twice after
    each (:func:`child`). Checks that every child exits 0 within
    ``timeout``, that the second merge changed nothing (in the child),
    and that every rank's merged tables equal phase 4's nonzero rows and
    counts and ``sparse_ref``'s keys and counts (the one-process count
    whose shards equal (M)'s). With ``z`` (phase 4j (Z): ``cnn_kw``,
    ``batch``, ``applies``), each child then trains and evaluates over a
    mesh that spans the processes (:func:`z_train`, :func:`z_checkpoints`),
    and every rank's results must be bit-equal; ``record`` receives them.
    Returns the count_chunk launches."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec_path = os.path.join(work, "two_process.json")
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(procs)]
    if z is not None:
        z = dict(z, ck_dir=os.path.join(work, "z_checkpoints"))
    with open(spec_path, "w") as fh:
        json.dump(dict(port=port, procs=procs, device=device, reads=reads_kw or {}, rows=rows,
                       lag=lag, sparse_lag=sparse_lag, csv=s_run["csv"], outs=outs,
                       timeout=timeout, threads=threads, z=z), fh)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = os.path.abspath(__file__)
    children = [subprocess.Popen([sys.executable, script, "--child", spec_path, str(r)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 env=env)
                for r in range(procs)]
    deadline = time.perf_counter() + timeout
    try:
        logs = [c.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
                for c in children]
    finally:
        for c in children:  # a child that hangs is killed; the run fails below
            if c.poll() is None:
                c.kill()
                c.communicate()
    for r, (c, log) in enumerate(zip(children, logs)):
        for line in log.splitlines():
            print(f"[4i] (V) rank {r}: {line}")
        check(c.returncode == 0, f"(V) rank {r} exited {c.returncode}")
    reports, z_ranks = [], []
    for r, out in enumerate(outs):
        with np.load(out) as got:
            check(np.array_equal(got["dense_rows"], want_rows)
                  and np.array_equal(got["dense_counts"], want_counts),
                  f"(V) rank {r}'s merged lag-{lag} table differs from phase 4's")
            for l in range(1, sparse_lag + 1):
                keys, vals = sparse_ref._consolidated(l)
                check(np.array_equal(got[f"keys_{l}"], keys)
                      and np.array_equal(got[f"vals_{l}"], vals),
                      f"(V) rank {r}'s merged lag-{l} counts differ from the one-process count")
            reports.append(json.loads(str(got["report"])))
            z_ranks.append({k: got[k] for k in got.files if k.startswith("z_")})
        os.remove(out)
    if z is not None:
        for k in z_ranks[0]:
            check(all(np.array_equal(zr[k], z_ranks[0][k]) for zr in z_ranks[1:]),
                  f"(Z) the ranks' {k} differ")
        zrep = [rep["z"] for rep in reports]
        print(f"[4j] (Z) {procs} processes, one mesh over their {zrep[0]['entries']} entries: "
              f"{z['applies']} float32 applies of the CNN BEAR and evaluation(mesh=); every "
              f"rank's ELBOs, parameters and metrics bit-equal; YSD1 train_streaming with a "
              f"shared checkpoint directory resumed identically, rank-local directories with "
              f"diverged state aborted both ranks ('differs across processes')")
        if record is not None:
            record.update(z_ranks[0], reports=zrep)
    launches = sum(rep["launches"] for rep in reports)
    print(f"[4i] (V) {procs} processes: every rank's merged tables == phase 4's lag-{lag} "
          f"table ({len(want_rows):,} rows) and the one-process lag 1..{sparse_lag} counts "
          f"(whose shards are (M)'s), exactly; {launches} count_chunk launches in all")
    return launches


def child(spec_path, rank):
    """One process of 4i (V); see :func:`two_process_phase`."""
    import torch

    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bear_tpu_torch.counting import engine, fastx, summarize
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{spec['port']}", spec["procs"], rank,
                         timeout_s=spec["timeout"])
    check(multihost.process_count() == spec["procs"], "the group has another size")
    device, lag = spec["device"], spec["lag"]
    reads, groups = make_reads(**spec["reads"])
    chunks = multihost.host_shard(list(read_chunks(reads, groups, rows=spec["rows"])))
    dense = engine.TransitionCounter([lag], n_groups=N_GROUPS, device=device)
    for chunk in chunks:
        dense.add_chunk(chunk)
    dense.sync()
    entries = dense.n_groups * engine.table_rows(lag) * dense.A1
    print(f"{len(chunks)} of the chunks counted at lag {lag} on {device}; the merge holds the "
          f"table, its baseline and the delta in host int64: 3 x {8 * entries / 1e9:.2f} GB = "
          f"{24 * entries / 1e9:.2f} GB; host MemAvailable {mem_available_gb():.2f} GB")
    answers = []
    for _ in range(2):
        multihost.allreduce_tables(dense)
        rows = dense.nonzero_rows(lag)
        answers.append((rows, dense.row_counts(lag, rows)))
    check(all(np.array_equal(a, b) for a, b in zip(*answers)),
          "the second dense merge changed the table")
    dense.validate(len(reads) * (reads.shape[1] + 1))
    launches = count_chunk_update.launches
    z_out, z_report = {}, {}
    if spec["z"]:
        z_out, z_report = z_train(dense, spec["z"], device, lag)
        z_out.update(z_checkpoints(spec["z"], rank, device))
    del dense

    files = multihost.host_shard(fastx.read_input_csv(spec["csv"]))
    sparse = SparseTransitionCounter(range(1, spec["sparse_lag"] + 1), n_groups=N_GROUPS,
                                     device=device)
    stats = {}
    for chunk in summarize.iter_chunks(files, spec["sparse_lag"], stats=stats):
        sparse.add_chunk(chunk)
    sparse.flush()
    total = multihost.allreduce_sum_i64([stats["bases"] + stats["reads"]])
    got = []
    for _ in range(2):
        multihost.allreduce_tables(sparse)
        got.append({l: sparse._consolidated(l) for l in sparse.lags})
    check(all(np.array_equal(a, b) for l in sparse.lags for a, b in zip(got[0][l], got[1][l])),
          "the second sparse merge changed the counts")
    sparse.validate(expected_transitions=int(total[0]))
    print(f"{len(files)} of the FASTQ files counted at lags 1..{spec['sparse_lag']} "
          f"(sparse-first); both merges' results equal")
    np.savez(spec["outs"][rank], dense_rows=answers[0][0], dense_counts=answers[0][1],
             report=json.dumps({"launches": launches, "z": z_report}),
             **z_out,
             **{f"{k}_{l}": a for l, (keys, vals) in got[1].items()
                for k, a in (("keys", keys), ("vals", vals))})
    torch.distributed.destroy_process_group()
    return 0


def close(a, b, rtol, atol=0.0):
    """Whether a and b agree as np.allclose(a, b, rtol, atol) does, and the
    largest |a - b| (for the message)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.allclose(a, b, rtol=rtol, atol=atol)), float(np.max(np.abs(a - b)))


def same_params(a, b, rtol, atol=MESH_ATOL):
    """(all parameters agree, the largest |difference|) of two lists."""
    got = [close(x, y, rtol, atol) for x, y in zip(a, b)]
    return all(ok for ok, _ in got), max(d for _, d in got)


def mesh_train_phase(chunks, b_rec, s_rec, shards, work, device="cuda", lag=LAG,
                     cnn_kw=CNN_KW, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                     entries=MESH_TRAIN, f64_applies=MESH_F64_APPLIES,
                     stream_applies=MESH_STREAM_APPLIES, stream_every=MESH_STREAM_EVERY):
    """4j (W): data-parallel training at full width over a mesh that names
    ``device`` ``entries`` times. count -> serve's chunks counted again and
    handed off on the device (their count_chunk launches counted from 0);
    float64 applies on the mesh and off it from 4c's start (ELBOs and
    parameters at MESH_RTOL); 4c's float32 protocol on the mesh (its first
    ELBOs against 4c's CPU float64 ones);
    evaluation(mesh=) against evaluation, float64; train_streaming(mesh=)
    on 4e's lag-13 shards, 4e's first ``stream_applies`` batches, a
    checkpoint every ``stream_every`` applies, resumed after completion
    (the same parameters; its first ELBOs against 4e's streamed run's);
    evaluation_streaming(mesh=) against the call without a mesh, float64.
    Returns (count_chunk launches, what (Y) and (Z) reuse)."""
    import torch
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.count_chunk import count_chunk_update
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    mesh = mesh_of(device, entries, "data")
    count_chunk_update.launches = 0
    counter = engine.TransitionCounter(lags=[lag], n_groups=N_GROUPS, device=device)
    for chunk in chunks:
        counter.add_chunk(chunk)
    codes, counts = counter.to_device_dataset(lag)
    launches = count_chunk_update.launches
    del counter
    n_rows = codes.shape[0]
    on_card = torch.device(device).type == "cuda"  # the plain version launches nothing
    check(launches == (len(chunks) if on_card else 0),
          f"(W) {launches} count_chunk launches for {len(chunks)} chunks")
    p0 = b_rec["p0"]

    # float64 from 4c's start, on the mesh and off it
    n5 = f64_applies * batch
    ar64 = get_ar_func("cnn", lag, 4, cnn_kw, dtype=torch.float64, device=device)
    kw64 = dict(num_kmers=n_rows, ar_func=ar64, batch_size=batch, epochs=1,
                learning_rate=TRAIN_LR, params_restart=p0, dtype=torch.float64, device=device)
    off = bear_net.train(codes[:n5], counts[:n5, 0], **kw64)
    on = bear_net.train(codes[:n5], counts[:n5, 0], mesh=mesh, **kw64)
    ok_e, d_e = close(on.elbos, off.elbos, MESH_RTOL)
    ok_p, d_p = same_params(on.params_list, off.params_list, MESH_RTOL)
    check(len(on.elbos) == len(off.elbos) == f64_applies and ok_e and ok_p,
          f"(W) float64 on the mesh differs from off it: ELBOs {d_e:.3e}, parameters {d_p:.3e}")
    print(f"[4j] (W) count -> serve's chunks counted again ({launches} count_chunk launches) "
          f"and handed off on {device}: {n_rows:,} rows; {f64_applies} float64 applies of the "
          f"CNN BEAR over {mesh} against off it, from 4c's start: max |dELBO| {d_e:.3e}, max "
          f"|dparam| {d_p:.3e} (rtol {MESH_RTOL})")

    # 4c's float32 protocol over the mesh
    cnn = get_ar_func("cnn", lag, 4, cnn_kw, device=device)
    kw = dict(num_kmers=n_rows, ar_func=cnn, batch_size=batch, learning_rate=TRAIN_LR,
              params_restart=p0, dtype=torch.float32, device=device, mesh=mesh)
    res = bear_net.train(codes, counts[:, 0], epochs=epochs, **kw)
    ref = b_rec["elbo_ref"]
    k = len(ref)
    elbo_err = rel_err(res.elbos[:k], ref)
    check(np.isfinite(res.elbos).all() and elbo_err <= ELBO_RTOL,
          f"(W) first {k} ELBOs on the mesh {res.elbos[:k]} differ from 4c's CPU float64 "
          f"{ref} by {elbo_err:.3e}")
    print(f"[4j] (W) 4c's protocol over the mesh, float32: {len(res.elbos)} applies; first "
          f"{k} ELBOs vs 4c's CPU float64 max rel err {elbo_err:.3e} (tolerance {ELBO_RTOL}); "
          f"h {res.h:.6g}")

    # evaluation, float64, on the mesh and off it
    args = (codes, counts, 0, 1, "dna", res.h, ar64, res.params_list[1:], VAN_REG)
    ev_on = bear_net.evaluation(*args, dtype=torch.float64, device=device, mesh=mesh)
    ev_off = bear_net.evaluation(*args, dtype=torch.float64, device=device)
    ok = [close(a, b, MESH_RTOL) for a, b in zip(ev_on[:6], ev_off[:6])]
    same_acc = all(np.array_equal(a, b) for a, b in zip(ev_on[6:], ev_off[6:]))
    check(all(o for o, _ in ok) and same_acc,
          f"(W) evaluation(mesh=) differs from evaluation: {[d for _, d in ok]}, accuracies "
          f"equal {same_acc}")
    print(f"[4j] (W) evaluation(mesh=) float64 == evaluation without a mesh (max |d| "
          f"{max(d for _, d in ok):.3e}, rtol {MESH_RTOL}; accuracies equal); held-out "
          f"perplexity BEAR {float(ev_on[3]):.6f}")

    # train_streaming over the mesh on 4e's lag-13 shards: 4e's first batches
    F, seed = len(shards), s_rec["seed"]
    order = list(range(F))
    np.random.default_rng([seed, 0]).shuffle(order)
    loaded = {}

    def shard(fi):
        if fi not in loaded:
            loaded[fi] = load_dense(shards[fi], "dna", N_GROUPS)
        return loaded[fi]

    def stream():
        """4e's epoch-0 stream (file order, in-shard permutation), cut
        after ``stream_applies`` batches."""
        left = stream_applies
        for pos, fi in enumerate(order):
            if left == 0:
                return
            d = shard(fi)
            perm = np.random.default_rng([seed, 0, pos]).permutation(d.num_kmers)
            take = min(-(-d.num_kmers // batch), left)
            left -= take
            rows = perm[: min(d.num_kmers, take * batch)]
            yield d.codes[rows], d.counts[rows, 0]

    ck = os.path.join(work, "w_checkpoints")
    os.makedirs(ck, exist_ok=True)
    skw = dict(num_kmers=s_rec["num_kmers"], ar_func=get_ar_func("cnn", lag, 4, cnn_kw,
                                                                 device=device),
               batch_size=batch, epochs=1, learning_rate=TRAIN_LR, params_restart=s_rec["p0"],
               dtype=torch.float32, device=device, mesh=mesh, block_steps=stream_every,
               checkpoint_every=stream_every, checkpoint_dir=ck)
    first = bear_net.train_streaming(stream, **skw)
    again = bear_net.train_streaming(stream, **skw)
    resumed_same = all(np.array_equal(a, b) for a, b in zip(first.params_list,
                                                            again.params_list))
    k = min(N_ELBO_CHECK, stream_applies)
    s_err = rel_err(first.elbos[:k], s_rec["elbos"][:k])
    check(len(first.elbos) == stream_applies and len(again.elbos) == 0 and resumed_same
          and s_err <= ELBO_RTOL,
          f"(W) train_streaming(mesh=): {len(first.elbos)} applies, {len(again.elbos)} on "
          f"resume, parameters equal {resumed_same}, first ELBOs vs 4e's {s_err:.3e}")
    print(f"[4j] (W) train_streaming(mesh=) on 4e's lag-13 shards: {stream_applies} applies, "
          f"a checkpoint every {stream_every}; resumed after completion: no apply run, the same "
          f"parameters; first {k} ELBOs vs 4e's streamed run max rel err {s_err:.3e} "
          f"(tolerance {ELBO_RTOL})")

    # evaluation_streaming, float64, on the mesh and off it
    for fi in range(F):
        shard(fi)
    eargs = (lambda: ((loaded[fi].codes, loaded[fi].counts) for fi in range(F)), 0, 1, "dna",
             first.h, ar64, first.params_list[1:], VAN_REG)
    es_on = bear_net.evaluation_streaming(*eargs, dtype=torch.float64, seed=seed, device=device,
                                          mesh=mesh)
    es_off = bear_net.evaluation_streaming(*eargs, dtype=torch.float64, seed=seed,
                                           device=device)
    ok = [close(a, b, MESH_RTOL) for a, b in zip(es_on[:6], es_off[:6])]
    same_acc = all(np.array_equal(a, b) for a, b in zip(es_on[6:], es_off[6:]))
    check(all(o for o, _ in ok) and same_acc,
          f"(W) evaluation_streaming(mesh=) differs: {[d for _, d in ok]}, accuracies equal "
          f"{same_acc}")
    print(f"[4j] (W) evaluation_streaming(mesh=) float64 over {F} shards == the call without "
          f"a mesh (max |d| {max(d for _, d in ok):.3e}, rtol {MESH_RTOL}; accuracies equal)")
    return launches, dict(codes=codes, counts=counts, elbos=res.elbos)


def mesh_cli_phase(out_dir, device="cuda", epochs=None, gate=True,
                   check_applies=MESH_VBEAR_CHECK, vbear_applies=VBEAR_APPLIES,
                   entries=MESH_TRAIN):
    """4j (X): train_bear_net.main on bear_lin_bear.cfg's values with
    ``[train] data_parallel = True`` (a mesh of every local card; with
    ``gate``, h and the BEAR held-out perplexity as 4b's), train_bear_ref.main
    with data_parallel over ``entries`` entries on YSD1 (its BMM against
    bmm_likelihood), and vBEAR over those entries: ``check_applies``
    float64 applies against the run without a mesh (MESH_RTOL), then 4f
    (I)'s float32 protocol (h within 25% of 0.0433, sigma < 0.25, with
    ``gate``)."""
    import torch
    from bear_tpu_torch.data import bmm_likelihood, load_dense
    from bear_tpu_torch.models import train_bear_net, train_bear_ref, vbear
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.ops.distributions import EPSILON
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    mesh = mesh_of(device, entries, "data")
    cfg = ysd1_config(os.path.join(out_dir, "ysd1_dp") + "*")
    cfg["train"]["data_parallel"] = "True"
    if epochs is not None:
        cfg["train"]["epochs"] = str(epochs)
    train_bear_net.main(cfg, device=device)
    h, perp = float(cfg["results"]["h"]), float(cfg["results"]["heldout_perplex_BEAR"])
    print(f"[4j] (X) train_bear_net.main, bear_lin_bear.cfg's values, data_parallel = True: "
          f"h {h:.6g} (published {YSD1_H}), held-out perplexity BEAR {perp:.6f}")
    if gate:
        check(abs(h / YSD1_H - 1) <= YSD1_H_RTOL and abs(perp - YSD1_PERPLEXITY)
              <= YSD1_PERPLEXITY_ATOL, f"(X) h {h} or BEAR {perp} off the published values")

    cfg = ysd1_config(os.path.join(out_dir, "ysd1_ref_dp") + "*")
    cfg["train"].update(epochs="1", train_ar="True", data_parallel="True")
    _, _, perp_van = train_bear_ref.main(cfg, mesh=mesh, device=device)
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    calc = bmm_likelihood(ds.counts, np.array(VAN_REG) + EPSILON, device="cpu")[0]
    bmm_err = rel_err(perp_van, np.exp(-calc / ds.counts[:, 0].sum()))
    check(bmm_err <= BMM_RTOL, f"(X) train_bear_ref BMM {perp_van} off bmm_likelihood's by "
          f"{bmm_err:.3e}")
    print(f"[4j] (X) train_bear_ref.main on YSD1, data_parallel over {mesh}: BMM vs "
          f"bmm_likelihood float64 max rel err {bmm_err:.3e} (tolerance {BMM_RTOL})")

    kw = dict(batch_size=1500, learning_rate=0.01, seed=10, device=device)
    ar64 = get_ar_func("linear", 5, 4, dtype=torch.float64, device=device)
    args = (ds.codes, ds.counts[:, 0], ds.num_kmers, ar64)
    off = vbear.train_variational_h(*args, epochs=check_applies, dtype=torch.float64, **kw)
    on = vbear.train_variational_h(*args, epochs=check_applies, dtype=torch.float64, mesh=mesh,
                                   **kw)
    ok, d = close(on.losses, off.losses, MESH_RTOL)
    ok_h, d_h = close(on.h_posterior, off.h_posterior, MESH_RTOL)
    check(ok and ok_h, f"(X) vBEAR float64 on the mesh differs: losses {d:.3e}, (mu, sigma) "
          f"{d_h:.3e}")
    ar = get_ar_func("linear", 5, 4, device=device)
    vb = vbear.train_variational_h(ds.codes, ds.counts[:, 0], ds.num_kmers, ar,
                                   epochs=vbear_applies, dtype=torch.float32, mesh=mesh, **kw)
    mu, sigma = vb.h_posterior
    print(f"[4j] (X) vBEAR over the mesh: {check_applies} float64 applies == without a mesh "
          f"(max |dloss| {d:.3e}, rtol {MESH_RTOL}); {vbear_applies:,} float32 applies; h "
          f"{vb.h:.6g}, sigma {sigma:.6g}")
    if gate:
        check(abs(vb.h - YSD1_VBEAR_H) / YSD1_VBEAR_H < VBEAR_H_RTOL and sigma < VBEAR_SIGMA_MAX,
              f"(X) vBEAR h {vb.h} not within 25% of {YSD1_VBEAR_H}, or sigma {sigma} >= 0.25")


def split_serving_phase(b_rec, s_rec, w_out, out_dir, device="cuda", lag=LAG,
                        cnn_kw=CNN_KW, entries=MESH_TRAIN, n_check=SPLIT_READS,
                        snv_bp=SPLIT_SNV_BP, genome_mb=GENOME_MB):
    """4j (Y): 4c's CNN written to a model directory whose counts are 4e's
    lag-13 shards (the train column == count -> serve's train table), served
    by from_model_dir(mesh=) with the table's rows split over ``entries``
    entries of a ``kmer`` mesh: the held-out reads' MAP scores bit-equal to
    4c's unsplit server's and to an unsplit server's of the same directory
    (float32); float64 on ``n_check`` reads, MC-41 on them, MAP and MC-41
    SNV Δ on the genome's first ``snv_bp`` bases, split against unsplit at
    SPLIT_RTOL; bmm_likelihood(mesh=) over a ``data`` mesh on (W)'s handoff
    counts against the call without."""
    import configparser
    import types

    import torch
    from bear_tpu_torch.data import bmm_likelihood
    from bear_tpu_torch.inference import BearServer, load_bear
    from bear_tpu_torch.inference.scoring import load_bear_dataset
    from bear_tpu_torch.inference.serving import table_from_dataset
    from bear_tpu_torch.ops import keyed_random as kr
    from bear_tpu_torch.utils.cli_common import write_config

    res = types.SimpleNamespace(h=b_rec["h"], params_list=b_rec["params"], opt_state=None)
    dir64 = write_model_dir(out_dir, res, lag, "cnn", cnn_kw, TRAIN_EPOCHS, TRAIN_BATCH)
    for d in (out_dir, dir64):  # the counts: 4e's lag-13 shards
        cfg = configparser.ConfigParser()
        cfg.read(os.path.join(d, "config.cfg"))
        cfg["data"].update(s_rec["data"])
        write_config(cfg, d)
    mesh = mesh_of(device, entries, "kmer")
    seqs = b_rec["seqs"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    split = BearServer.from_model_dir(out_dir, mesh=mesh, device=device)
    got = split.score(seqs)
    lag_, _, h, ar_apply, info = load_bear(out_dir, device=device)
    table = table_from_dataset(load_bear_dataset(info), lag)
    want = BearServer(table, lag, h=h, ar_apply=ar_apply, device=device).score(seqs)
    gap = float(np.max(np.abs(got - b_rec["scores"])))
    check(np.array_equal(got, b_rec["scores"]) and np.array_equal(got, want),
          f"(Y) row-split MAP scores differ from 4c's unsplit server's by {gap:.3e}")
    print(f"[4j] (Y) from_model_dir(mesh={mesh}): {len(seqs)} held-out reads MAP; float32 "
          f"scores bit-equal to 4c's unsplit server's and to an unsplit server's of the same "
          f"directory")
    del split
    _, _, h64, ar64, _ = load_bear(dir64, device=device)
    kw = dict(h=h64, ar_apply=ar64, dtype=torch.float64, device=device)
    split64 = BearServer(table, lag, mesh=mesh, **kw)
    dense64 = BearServer(table, lag, **kw)
    wt = genome_prefix(snv_bp, genome_mb=genome_mb)
    pos, alts = snv_grid(wt)
    key = kr.key(SEED)
    calls = {
        f"MAP, {n_check} reads": lambda s: s.score(seqs[:n_check]),
        f"MC-{MC}, {n_check} reads": lambda s: s.score(seqs[:n_check], mode="sample", key=key,
                                                       mc_samples=MC),
        f"MAP SNV, {len(pos):,}": lambda s: s.delta_scores_snv(wt, pos, alts),
        f"MC-{MC} SNV, {len(pos):,}": lambda s: s.delta_scores_snv(
            wt, pos, alts, mode="sample", key=key, mc_samples=MC),
    }
    diffs = {}
    for name, call in calls.items():
        ok, diffs[name] = close(call(split64), call(dense64), SPLIT_RTOL)
        check(ok, f"(Y) float64 {name}: row-split differs from unsplit by {diffs[name]:.3e}")
    del split64, dense64
    print(f"[4j] (Y) float64 row-split == unsplit (rtol {SPLIT_RTOL}), max |d|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
    counts = w_out["counts"].double()
    alpha = np.array(VAN_REG)
    data_mesh = mesh_of(device, entries, "data")
    on = bmm_likelihood(counts, alpha, mesh=data_mesh, device=device)
    off = bmm_likelihood(counts, alpha, device=device)
    ok, d = close(on, off, SPLIT_RTOL)
    check(ok, f"(Y) bmm_likelihood(mesh=) differs from the call without by {d:.3e}")
    print(f"[4j] (Y) bmm_likelihood(mesh={data_mesh}) on (W)'s handoff counts "
          f"({counts.shape[0]:,} rows, float64) == without a mesh (max |d| {d:.3e}, rtol "
          f"{SPLIT_RTOL})")


def z_against_w(z_rec, w_out, k=N_ELBO_CHECK):
    """4j (Z) against (W): the first ``k`` ELBOs of the mesh that spans two
    processes within ELBO_RTOL of (W)'s 2-entry mesh on one process (the
    same start and batches; the sums taken over gloo instead of on the
    card)."""
    z_err = rel_err(z_rec["z_elbos"][:k], w_out["elbos"][:k])
    check(z_err <= ELBO_RTOL, f"(Z) the two processes' first {k} ELBOs differ from (W)'s "
          f"2-entry run by {z_err:.3e}")
    print(f"[4j] (Z) first {k} ELBOs over two processes vs (W)'s 2-entry mesh on one process: "
          f"max rel err {z_err:.3e} (tolerance {ELBO_RTOL})")


def z_train(dense, z, device, lag):
    """4j (Z) in one process of (V), after the dense merge: the lag-``lag``
    dataset of the merged table, (W)'s CNN BEAR from the same seed trained
    ``z["applies"]`` float32 applies over ``data_parallel_mesh()``, which
    spans every process (one entry each on the card), then evaluated over
    it. Returns (arrays, report)."""
    import torch
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.parallel import data_parallel_mesh, multihost

    ds = dense.to_dataset(lag)
    mesh = data_parallel_mesh(device=device)
    check(mesh.spans_processes and mesh.size == multihost.process_count(),
          f"data_parallel_mesh() does not span the processes: {mesh}")
    ar = get_ar_func("cnn", lag, 4, z["cnn_kw"], device=device)
    init = bear_net.init_params(torch.Generator().manual_seed(SEED), ar)
    n = z["applies"] * z["batch"]
    res = bear_net.train(ds.codes[:n], ds.counts[:n, 0], num_kmers=len(ds.codes), ar_func=ar,
                         batch_size=z["batch"], epochs=1, learning_rate=TRAIN_LR,
                         params_restart=[init["h_signed"]] + init["ar"], dtype=torch.float32,
                         mesh=mesh, device=device)
    check(len(res.elbos) == z["applies"], f"(Z) {len(res.elbos)} applies")
    ev = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", res.h, ar, res.params_list[1:],
                             VAN_REG, dtype=torch.float32, mesh=mesh, device=device)
    out = {"z_elbos": res.elbos,
           "z_metrics": np.concatenate([np.asarray(m, np.float64).reshape(-1) for m in ev])}
    out.update({f"z_p{i}": p for i, p in enumerate(res.params_list)})
    return out, {"entries": mesh.size}


def z_checkpoints(z, rank, device):
    """4j (Z), at YSD1 size: train_streaming over the spanning mesh with a
    checkpoint directory every process shares (run, then resumed after
    completion: the same parameters, no apply run again), then with
    rank-local directories, rank 0's holding a mid-run state: both ranks
    must abort with the "differs across processes" error."""
    import torch
    from bear_tpu_torch.data import load_dense
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.parallel import data_parallel_mesh
    from bear_tpu_torch.utils.checkpoint import save_train_state
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    os.makedirs(z["ck_dir"], exist_ok=True)

    def shards():
        yield ds.codes[:700], ds.counts[:700, 0]
        yield ds.codes[700:], ds.counts[700:, 0]

    kw = dict(num_kmers=ds.num_kmers, ar_func=get_ar_func("linear", 5, 4, device=device),
              batch_size=256, epochs=2, learning_rate=0.01, seed=10, dtype=torch.float32,
              block_steps=2, checkpoint_every=2, mesh=data_parallel_mesh(device=device),
              device=device)
    first = bear_net.train_streaming(shards, checkpoint_dir=z["ck_dir"], **kw)
    again = bear_net.train_streaming(shards, checkpoint_dir=z["ck_dir"], **kw)
    check(len(again.elbos) == 0 and all(np.array_equal(a, b) for a, b in zip(
        first.params_list, again.params_list)), "(Z) the shared resume moved the parameters")
    mine = os.path.join(z["ck_dir"] + "_local", f"rank{rank}")
    os.makedirs(mine, exist_ok=True)
    if rank == 0:
        save_train_state(mine, {"params": first.params_list, "torch_opt_state": first.opt_state,
                                "applies_done": 4})
    try:
        bear_net.train_streaming(shards, checkpoint_dir=mine, **kw)
    except RuntimeError as e:
        check("differs across processes" in str(e), f"(Z) another error: {e}")
    else:
        raise RuntimeError("(Z) the diverged resume was not detected")
    return {"z_stream_elbos": first.elbos,
            **{f"z_stream_p{i}": p for i, p in enumerate(first.params_list)}}


def run_example(script, args, timeout=EXAMPLE_TIMEOUT_S):
    """examples/``script`` as a program; its output lines printed with the
    phase's tag. Returns (rc, stdout)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", script)
    out = subprocess.run([sys.executable, path, *args], capture_output=True, text=True,
                         timeout=timeout)
    for line in (out.stdout + out.stderr).splitlines():
        if "socket.cpp" not in line:  # gloo's hostname warning
            print(f"[4k] {script}: {line}")
    return out.returncode, out.stdout


def bench_line(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("BENCH ")]
    check(len(lines) == 1, f"{len(lines)} BENCH lines")
    return json.loads(lines[0][len("BENCH "):])


def genome_example_phase(b_rec, argv=(), device="cuda", want_rows=GENOME_ROWS,
                         want_transitions=GENOME_TRANSITIONS):
    """4k (AA): examples/torch_genome_lag13.py's main(argv) in this process,
    by default at its defaults on the card. Gates: one count_chunk launch
    per chunk (none on the CPU), 4c's rows, conservation of the handoff,
    and BMM perplexities against 4c's evaluation of the same counts
    (``b_rec``). Returns its count_chunk launches."""
    import torch
    import examples.torch_genome_lag13 as genome
    from bear_tpu_torch.counting.count_chunk import count_chunk_update

    count_chunk_update.launches = 0
    out = genome.main(list(argv))
    launches = count_chunk_update.launches
    n_chunks = -(-out["reads"] // CHUNK_ROWS) if device == "cuda" else 0
    check(launches == n_chunks, f"(AA) launched count_chunk {launches} times for "
          f"{n_chunks} chunks")
    check(out["rows"] == want_rows == b_rec["rows"],
          f"(AA) {out['rows']:,} rows; 4c handed off {b_rec['rows']:,}")
    handed = int(out["counts"].sum(dtype=np.float64))
    check(handed == out["transitions"] == want_transitions,
          f"(AA) the handoff holds {handed:,} transitions, not {want_transitions:,}")
    bmm, bmm_4c = np.asarray(out["evaluation"][5]), b_rec["bmm"]
    bmm_err = float(np.max(np.abs(bmm / bmm_4c - 1)))
    check(bmm_err <= GENOME_BMM_RTOL, f"(AA) BMM {bmm} differs from 4c's {bmm_4c} by "
          f"{bmm_err:.3e}")
    check(all(np.isfinite(np.asarray(o)).all() for o in out["evaluation"]),
          "(AA) evaluation not finite")
    print(f"[4k] (AA) torch_genome_lag13.main({list(argv)}): {launches} count_chunk launches, "
          f"{out['rows']:,} rows (== 4c's), {handed:,} transitions conserved; BMM "
          f"{bmm.tolist()} vs 4c's max rel err {bmm_err:.3e} (tolerance {GENOME_BMM_RTOL})")
    del out
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def multihost_examples_phase(work, extra=(), want_transitions=MH_COUNT_TRANSITIONS):
    """4k (AB) and (AC): the two multi-process programs, two gloo processes
    each, by default at their defaults on the card (``extra`` arguments go
    to every run). Returns the bench records of the three runs."""
    rc, stdout = run_example("torch_multihost_counting.py",
                             ["--nproc", "2", "--bench", "--workdir",
                              os.path.join(work, "mh_count"), *extra])
    check(rc == 0, f"(AB) torch_multihost_counting exited {rc}")
    rec = bench_line(stdout)
    check(rec["global_transitions_per_lag"] == want_transitions,
          f"(AB) {rec['global_transitions_per_lag']:,} transitions per lag, not "
          f"{want_transitions:,}")
    print(f"[4k] (AB) torch_multihost_counting --nproc 2 --bench: "
          f"{rec['global_transitions_per_lag']:,} transitions per lag at lags {rec['lags']} on "
          f"{rec['device']}")
    recs = [rec]
    for mode in ([], ["--streaming"]):
        rc, stdout = run_example("torch_multihost_train.py",
                                 ["--nproc", "2", "--bench", "--workdir",
                                  os.path.join(work, "mh_train"), *mode, *extra])
        check(rc == 0, f"(AC) torch_multihost_train {mode} exited {rc}")
        rec = bench_line(stdout)
        hs = re.findall(r"^\[rank \d+\] OK h=(.*)$", stdout, re.M)
        check(len(hs) == 2 and float(hs[0]) == float(hs[1]) == rec["h"],
              f"(AC) the ranks' h differ: {hs}")
        recs.append(rec)
        print(f"[4k] (AC) torch_multihost_train {' '.join(['--nproc', '2', '--bench', *mode])}: "
              f"{rec['kmers']:,} k-mers, {rec['devices']} mesh entries, h {rec['h']!r} on both "
              f"ranks, BEAR perplexity {rec['bear_perplexity']:.6f} on {rec['device']}")
    check(recs[1]["kmers"] == recs[2]["kmers"],
          f"(AC) k-mers differ between the runs: {[r['kmers'] for r in recs[1:]]}")
    return recs


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
    from bear_tpu_torch.ops import attention_forward, cnn_forward, keyed_draw

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: every kernel, one nvcc per source, all started together
    libs = _build.build([window_hist.SOURCE, count_chunk.SOURCE, keyed_draw.SOURCE,
                         cnn_forward.SOURCE, attention_forward.SOURCE])
    print(f"[build] {', '.join(p.name for p in libs.values())}")
    for p in libs.values():
        log = p.with_suffix(".log")
        if log.exists():
            print("[build] ptxas: " + " | ".join(
                l.strip() for l in log.read_text().splitlines() if l.strip()))

    # 3. the counting kernels against their plain versions on the main
    # path's chunk 0, then each timed alone there (the edge cases are
    # tests/test_torch_cuda.py's)
    reads, groups = make_reads()
    n_reads = len(reads)
    chunks = list(read_chunks(reads, groups))
    _, total = count_chunk.lag_offsets((LAG,), N_GROUPS)
    c0 = chunks[0]
    meta0 = count_chunk.pack_meta(c0.lengths, c0.skip, c0.stopped, c0.groups, c0.fresh)
    a, b = count_chunk_vs_plain(dev, (LAG,), N_GROUPS, 4, [(c0.codes, meta0)])
    count_err = int((a.long() - b.long()).abs().max())
    check(torch.equal(a, b), f"count_chunk differs from plain on the main path's chunk 0: "
          f"{count_err}")
    print(f"[kernel] count_chunk == plain on the main path's chunk 0 (1 launch, "
          f"{int(a.sum()):,} transitions, max_abs_err {count_err})")
    del a, b
    codes = torch.from_numpy(c0.codes).to(dev)
    meta = torch.from_numpy(meta0).to(dev)
    lengths, skip, stopped, grp, _ = count_chunk.unpack_meta(meta)
    keys = count_chunk.chunk_keys(codes, lengths, skip, stopped, grp, (LAG,), N_GROUPS, 4,
                                  sentinel=total)
    a = window_update(torch.zeros(total, dtype=torch.int32, device=dev), keys)
    b = window_update_plain(torch.zeros(total, dtype=torch.int32, device=dev), keys)
    hist_err = int((a - b).abs().max())
    check(torch.equal(a, b), f"window_hist differs from plain on chunk 0: {hist_err}")
    print(f"[kernel] window_hist == plain on the main path's chunk 0 ({keys.numel():,} keys)")
    del a, b

    table = torch.zeros(total, dtype=torch.int32, device=dev)
    l2_flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    valid = keys[(keys >= 0) & (keys < total)]
    valid_long = valid.long()
    ones = torch.ones_like(valid)
    sectors = int(torch.unique(valid // 8).numel())  # 8 int32 per 32 B sector
    n_keys = keys.numel()
    kernel_ms = timed_ms(lambda: window_update(table, keys), 20, l2_flush)
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

    count_ms = timed_ms(
        lambda: count_chunk_update(table, codes, meta, (LAG,), N_GROUPS, 4), 20, l2_flush)
    count_plain_ms = timed_ms(
        lambda: count_chunk_plain(table, codes, meta, (LAG,), N_GROUPS, 4), 20, l2_flush)
    n_pos = codes.shape[0] * (codes.shape[1] + 1)
    count_bytes_ms = (codes.numel() + 4 * meta.numel() + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    count_ops_ms = n_pos * (ROLL_OPS + KEY_OPS) / FP32_OPS_PER_S * 1e3
    count_bound_ms = max(count_bytes_ms, count_ops_ms)
    count_bound_by = "bytes" if count_bytes_ms >= count_ops_ms else "operations"
    count_shape = launch_fields(*codes.shape, 1)
    print(f"[kernel] count_chunk at the main path's chunk: {codes.shape[0]:,} x "
          f"{codes.shape[1]} codes, {n_pos:,} positions ({valid.numel():,} counted, "
          f"{sectors:,} table sectors): ms {count_ms:.6f} plain_ms {count_plain_ms:.6f} "
          f"bound_ms {count_bound_ms:.6f} ({count_bound_by}) library_ms {library_ms:.6f} "
          f"(index_put_ on the chunk's keys); launch {count_shape} [{card}]")
    del table, l2_flush, valid, valid_long, ones, keys, codes, meta
    del lengths, skip, stopped, grp
    torch.cuda.empty_cache()

    # 4. main path: counts set to 0 just before it, read just after
    window_update.launches = 0
    count_chunk_update.launches = 0
    counter = engine.TransitionCounter(lags=[LAG], n_groups=N_GROUPS)
    for chunk in chunks:
        counter.add_chunk(chunk)
    counter.sync()
    expected = n_reads * (READ_LEN + 1)
    counter.validate(expected)
    # Phase 4e's reference: the nonzero rows and their counts, read on the card.
    p4_rows = counter.nonzero_rows(LAG)
    p4_counts = counter.row_counts(LAG, p4_rows)
    tables = counter.tables[LAG]
    distinct = int(np.count_nonzero(tables[0].sum(axis=1)))
    print(f"[count] {n_reads:,} reads, {expected:,} transitions at lag {LAG} "
          f"conserved; {distinct:,} distinct train contexts")

    test_reads = reads[np.flatnonzero(groups == 1)[:N_SCORE]]
    seqs = decode_reads(test_reads)
    ar = LinearAR(LAG, 4, generator=torch.Generator().manual_seed(SEED))
    server = BearServer(tables[0], LAG, h=H, ar_apply=ar)
    scores = server.score(seqs)
    launches = count_chunk_update.launches
    hist_launches = window_update.launches
    check(launches == len(chunks),
          f"the main path launched count_chunk {launches} times for {len(chunks)} chunks")
    print(f"[count] kernel launches on the main path: count_chunk {launches} "
          f"({len(chunks)} chunks), window_hist {hist_launches} (off the main path)")
    del counter
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
    print(f"[serve] {len(seqs)} held-out reads, MAP, float32 card vs float64 CPU: max |diff| "
          f"{diff.max():.3e} (tolerance {SCORE_ATOL} + {SCORE_RTOL}*|score|); scores "
          f"{ref.min():.3f}..{ref.max():.3f}")
    train_table = tables[0]  # the main path's counts, for phase 4d
    del server, tables, ar, ar64
    torch.cuda.empty_cache()

    # 4b. the published YSD1 protocol through the training CLI;
    # 4c. count -> on-device handoff -> CNN training -> evaluation -> serve;
    # 4d. sampled serving and variant scoring with 4c's model, on the main
    # path's table, and the score CLI on 4b's model
    with tempfile.TemporaryDirectory() as tmp:
        ysd1_phase(os.path.join(tmp, "ysd1"))
        b_rec = {}  # what phase 4j holds its mesh runs against
        launches_4c, codes_d, counts_d, _, _, n_rows = lag13_train_phase(
            chunks, reads, groups, os.path.join(tmp, "cnn"), record=b_rec)
        check(launches_4c == len(chunks),
              f"4c launched count_chunk {launches_4c} times for {len(chunks)} chunks")
        torch.cuda.empty_cache()
        window_update.launches = 0
        count_chunk_update.launches = 0
        d_rec = {}
        cnn_forward.narrow_launches = 0
        sampled_phase(train_table, LAG, os.path.join(tmp, "cnn"), os.path.join(tmp, "ysd1"),
                      seqs, genome_prefix(DMS_BP), card, record=d_rec)
        cnn_narrow = cnn_forward.narrow_launches
        check(cnn_narrow == 0, f"the lag-13 CNN (96 filters, 64 hidden units) took the narrow "
                               f"instance {cnn_narrow} times in 4d")
        keyed_by_path, d_keyed = dict(d_rec["keyed_launches"]), d_rec["keyed_draw"]
        cnn_by_path, d_cnn = dict(d_rec["cnn_launches"]), d_rec["cnn_forward"]
        check(all(n > 0 for n in cnn_by_path.values()),
              f"a CNN path of 4d ran without launching cnn_forward: {cnn_by_path}")
        print(f"[sample] kernel launches in phase 4d: count_chunk "
              f"{count_chunk_update.launches}, window_hist {window_update.launches}, "
              f"keyed_draw by path {keyed_by_path}, cnn_forward by path {cnn_by_path} (the Δ "
              f"window math is PyTorch ops)")
    d_protein = protein_phase(card)
    torch.cuda.empty_cache()

    # 4e. the on-disk workflow: reads as FASTQ -> summarize -l 13 (its
    # count_chunk launches counted from 0 just before, read just after) ->
    # lag-13 TSV shards -> the streaming training CLI -> scoring
    with tempfile.TemporaryDirectory() as tmp:
        s_run = summarize_phase(reads, groups, p4_rows, p4_counts, os.path.join(tmp, "disk"))
        torch.cuda.empty_cache()
        s_chunk = summarize_chunk_timing(s_run["files"][0][0], card, dev)
        torch.cuda.empty_cache()
        s_rec = {}
        streaming_train_phase(s_run["prefix"], s_run["shards"], reads, groups,
                              os.path.join(tmp, "stream"), record=s_rec)

        # 4f. generation and the other models, in 4e's directory: each path's
        # count_chunk launches counted from 0 just before it, read just after
        ref_launches = reference_phase(reads, chunks, os.path.join(tmp, "ref"))
        torch.cuda.empty_cache()
        vbear_phase()
        lag_launches, lag_table = lag_select_phase(s_run["csv"], s_run["prefix"])
        torch.cuda.empty_cache()
        asm_launches = assembly_phase(reads, groups, s_run["csv"], os.path.join(tmp, "stream"),
                                      os.path.join(tmp, "assemble"), keyed=keyed_by_path)
        torch.cuda.empty_cache()

        # 4g. counting beyond the dense table, in 4e's directory: each path's
        # count_chunk launches counted from 0 just before it, read just after
        # (the sparse-first path sorts keys and launches none)
        work = os.path.join(tmp, "beyond")
        ref_rows = distinct_rows(reads, SPARSE_LAG, dev)
        torch.cuda.empty_cache()
        print(f"[4g] plain torch.unique recount: distinct context rows at lags 1..{SPARSE_LAG} "
              f"{[ref_rows[l] for l in range(1, SPARSE_LAG + 1)]}")
        p_run = passes_phase(s_run, ref_rows, work)
        torch.cuda.empty_cache()
        shard_chunk = summarize_chunk_timing(s_run["files"][0][0], card, dev, lag=PASSES_LAG,
                                             passes=p_run["passes"])
        torch.cuda.empty_cache()
        sparse_counter, model_dir = sparse_phase(s_run, p_run, ref_rows, work)
        torch.cuda.empty_cache()
        cli_passes = sparse_lag_phase(sparse_counter, lag_table, s_run["csv"], p_run["passes"],
                                      p_run["chunks"])
        torch.cuda.empty_cache()
        sparse_generation_phase(sparse_counter, model_dir, reads, groups, keyed=keyed_by_path)
        del sparse_counter
        torch.cuda.empty_cache()

        # 4h. the remaining model options: (P) attention BEAR through the CLI,
        # (Q) the seven optax optimizers, (R) bfloat16 compute on 4c's handoff;
        # none of them counts, so count_chunk's launches here stay 0
        count_chunk_update.launches = 0
        window_update.launches = 0
        attention_forward.launches = 0
        attention_phase(os.path.join(tmp, "attn"))
        attn_launches = {"attention_cli": attention_forward.launches}
        check(attn_launches["attention_cli"] > 0,
              "(P)'s evaluation under no_grad ran without launching attention_forward")
        torch.cuda.empty_cache()
        attn_launches["scoring"] = attention_serving_launches(train_table, seqs)
        del train_table
        torch.cuda.empty_cache()
        d_attn = attention_forward_timing(card)
        torch.cuda.empty_cache()
        optimizer_phase()
        torch.cuda.empty_cache()
        bf16_phase(codes_d, counts_d, n_rows, os.path.join(tmp, "trace"))
        del codes_d, counts_d
        torch.cuda.empty_cache()
        print(f"[4h] kernel launches in 4h: count_chunk {count_chunk_update.launches}, "
              f"window_hist {window_update.launches}, attention_forward by path "
              f"{attn_launches} (the options are PyTorch ops)")

        # 4i. counting across devices and processes, in 4e's directory: (S)
        # the data-sharded counter, (T) the row-split counter, (U) the sparse
        # counter's mesh=, (V) two processes merged by allreduce_tables; each
        # path's count_chunk launches counted from 0 just before it
        launches_s = data_sharded_phase(chunks, p4_rows, p4_counts)
        torch.cuda.empty_cache()
        launches_t = row_split_phase(s_run, ref_rows, work)
        torch.cuda.empty_cache()
        mesh_counter = sparse_mesh_phase(s_run, ref_rows, os.path.join(work, "sparse", "run"),
                                         work)
        torch.cuda.empty_cache()
        z_rec = {}  # (V)'s children also run phase 4j (Z)
        launches_v = two_process_phase(
            s_run, p4_rows, p4_counts, mesh_counter, work,
            z=dict(cnn_kw=CNN_KW, batch=TRAIN_BATCH, applies=Z_APPLIES), record=z_rec)
        del mesh_counter
        torch.cuda.empty_cache()

        # 4j. data parallelism on the card, in 4e's directory: (W) training
        # over a mesh (its recount's count_chunk launches counted from 0 just
        # before it), (X) the CLIs and vBEAR, (Y) row-split serving and the
        # likelihood; (Z) ran in (V)'s children and is held against (W) here
        launches_w, w_out = mesh_train_phase(chunks, b_rec, s_rec, s_run["shards"], work)
        z_against_w(z_rec, w_out)
        torch.cuda.empty_cache()
        mesh_cli_phase(os.path.join(tmp, "dp"))
        torch.cuda.empty_cache()
        split_serving_phase(b_rec, s_rec, w_out, os.path.join(tmp, "split"))
        del w_out
        torch.cuda.empty_cache()

        # 4k. the example programs: (AA) torch_genome_lag13 in this process
        # (its count_chunk launches counted from 0 just before it), (AB) and
        # (AC) the multi-process programs, each process on the card
        launches_aa = genome_example_phase(b_rec)
        multihost_examples_phase(work)

    count_err = max(count_err, int(s_chunk["max_abs_err"]), int(shard_chunk["max_abs_err"]))
    by_path = {"count_serve": launches, "summarize": s_run["launches"],
               "ref_recount": ref_launches, **lag_launches, **asm_launches,
               "multipass": p_run["launches"], "lag_select_cli_passes": cli_passes,
               "data_sharded": launches_s, **launches_t, "two_process": launches_v,
               "mesh_training": launches_w, "torch_genome_lag13": launches_aa}
    check(all(n > 0 for n in by_path.values()),
          f"a path ran without launching count_chunk: {by_path}")
    check(set(keyed_by_path) == set(KEYED_DRAW_PATHS)
          and all(n > 0 for n in keyed_by_path.values()),
          f"a sampled path ran without launching keyed_draw: {keyed_by_path}")
    print(f"[count] count_chunk launches by path {by_path}")
    print(f"[sample] keyed_draw launches by path {keyed_by_path}")

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
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": float(count_err),
        "ms": count_ms, "plain_ms": count_plain_ms, "bound_ms": count_bound_ms,
        "bound_by": count_bound_by, "library_ms": library_ms,
        "launch_shape": count_shape,
        "summarize_chunk": s_chunk,
        "shard_chunk": shard_chunk,
    }, {
        "name": "keyed_draw", "route": "cuda",
        "source": "bear_tpu_torch/csrc/keyed_draw.cu",
        "replaces": "bear_tpu/ops/loggamma.py:144",
        "replaces_kind": "jitted XLA (log_dirichlet_draw_keyed(_t), with "
                         "bear_tpu/inference/serving.py:41 _sampled_logp_picked); no pallas_call",
        "launches": sum(keyed_by_path.values()),
        "launches_by_path": keyed_by_path,
        "library_ms": None, **d_keyed,
        "ptxas": ptxas_report(libs[keyed_draw.SOURCE].with_suffix(".log").read_text()),
    }, {
        "name": "cnn_forward", "route": "cuda",
        "source": "bear_tpu_torch/csrc/cnn_forward.cu",
        "replaces": None,
        "replaces_kind": "no TPU kernel: bear_tpu's CNN (bear_tpu/models/ar_funcs.py "
                         "make_ar_func_cnn) is jitted XLA; the port's ATen forward before it",
        "launches": sum(cnn_by_path.values()),
        "launches_by_path": cnn_by_path,
        "narrow_launches": cnn_narrow,
        "library_ms": None, **d_cnn,
        "protein": d_protein,
        "ptxas": ptxas_report(libs[cnn_forward.SOURCE].with_suffix(".log").read_text()),
    }, {
        "name": "attention_forward", "route": "cuda",
        "source": "bear_tpu_torch/csrc/attention_forward.cu",
        "replaces": None,
        "replaces_kind": "no TPU kernel: bear_tpu's attention AR (bear_tpu/models/ar_funcs.py "
                         "make_ar_func_attention) is jitted XLA; the port's ATen block before it",
        "launches": sum(attn_launches.values()),
        "launches_by_path": attn_launches,
        "library_ms": None, **d_attn,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":  # a process of phase 4i (V)
        sys.exit(child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
