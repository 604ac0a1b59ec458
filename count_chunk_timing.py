#!/usr/bin/env python3
"""Time the count_chunk kernel at its three chunk forms on one CUDA card,
from this checkout or another one, and ablate its launch shape and key math.

    python3 count_chunk_timing.py [--root DIR] [--ablation] [--reps 20]

The forms are chip_smoke.py's: the main path's chunk 0 (16,384 x 150 codes
at lag 13, 2 groups), summarize's first chunk of FASTQ file 0 (1,024 x 192
over lags 1..13), and that chunk in row-range form over lags 1..15 in pass
0 of 9 (phase 4g's layout). Each is built from chip_smoke.py's seeded reads,
held against count_chunk_plain on the card (exact), then timed two ways,
the mean of ``--reps`` launches with the L2 evicted before each: ``ms`` as
chip_smoke.py times it (CUDA events around count_chunk_update), and
``device_ms`` (chip_smoke.device_ms) with a ~1 ms sleep kernel queued
between the eviction and the start event, so that the wrapper's host work
(checks, lag table, launch shape) is enqueued while the card is busy and
only the kernel lies between the events. Where the wrapper's host time
exceeds the eviction's device time, ``ms`` includes the difference.

``--root DIR`` imports bear_tpu_torch from the checkout at DIR (and builds
its csrc/count_chunk.cu there), e.g. an earlier commit unpacked with ``git
archive`` into build/parent; the reads and the timing come from this
checkout's chip_smoke.py. To compare two kernels on one card, run both in
one call, in turns: earlier, this, this, earlier.

``--ablation`` (a checkout whose wrapper has ``launch_shape``): at each
form, the four kernels of {runs of 8 in one lag group over tiles of 2,048
(the decomposition before launch_shape), launch_shape's} x {the lag code
as the remainder by A^l, as a mask}, each held against plain, timed
(``device_ms``) in two turns (forward, then reversed); the floor, the
chosen launch on the same chunk with every position masked (the staging
and the walk, no key); and at the two 1,024 x 192 forms a sweep of launch
shapes (runs x lag groups, the grid capped at 4 blocks per SM or one
block per tile).

Prints the card's name and power limit, the kernel's ptxas report, then
one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forms(cs, dev):
    """{name: (codes, meta, lags, shard or None, table entries)} on ``dev``."""
    import torch
    from bear_tpu_torch.counting import count_chunk as cc
    from bear_tpu_torch.counting import engine
    from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter, min_passes

    reads, groups = cs.make_reads()
    c0 = next(iter(cs.read_chunks(reads, groups)))
    out = {"main": (c0.codes, cc.pack_meta(c0.lengths, c0.skip, c0.stopped, c0.groups, c0.fresh),
                    (cs.LAG,), None, cc.lag_offsets((cs.LAG,), cs.N_GROUPS)[1])}
    # FASTQ file 0 of chip_smoke.write_fastq, as the parser hands it over.
    first = reads[np.array_split(np.flatnonzero(groups == 0), cs.N_TRAIN_FILES)[0]]
    offsets = np.arange(len(first) + 1, dtype=np.int64) * first.shape[1]
    for name, lag in (("summarize", cs.LAG), ("row_range", cs.PASSES_LAG)):
        chunk = next(iter(engine.chunks_from_packed(first.reshape(-1), offsets, 0, lag,
                                                    native=False)))
        lags = tuple(range(1, lag + 1))
        meta = cc.pack_meta(chunk.lengths, chunk.skip, chunk.stopped, chunk.groups, chunk.fresh)
        if name == "summarize":
            out[name] = (chunk.codes, meta, lags, None, cc.lag_offsets(lags, cs.N_GROUPS)[1])
        else:
            layout = MultiPassTransitionCounter(lags, n_groups=cs.N_GROUPS,
                                                passes=min_passes(lags, cs.N_GROUPS), device=dev)
            out[name] = (chunk.codes, meta, lags, (0, layout._per_lag), layout.table_size)
    return {k: (torch.from_numpy(np.ascontiguousarray(c, np.int8)).to(dev),
                torch.from_numpy(m).to(dev), lags, shard, total)
            for k, (c, m, lags, shard, total) in out.items()}


SWEEP = [(8, 1), (8, 2), (4, 2), (4, 4), (2, 2), (2, 4), (8, 4), (8, 8), (4, 8), (2, 8),
         (1, 1), (1, 4), (1, 8)]


def held(run, plain, total, dev):
    """max |kernel - plain| of one launch each on zeroed tables (must be 0)."""
    import torch

    a = torch.zeros(total, dtype=torch.int32, device=dev)
    b = torch.zeros(total, dtype=torch.int32, device=dev)
    run(a)
    plain(b)
    torch.cuda.synchronize()
    differ = a != b
    err = int((a[differ].long() - b[differ].long()).abs().max()) if bool(differ.any()) else 0
    del a, b, differ
    torch.cuda.empty_cache()
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose bear_tpu_torch to time")
    ap.add_argument("--ablation", action="store_true",
                    help="also time the launch shape x key math ablation")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("count_chunk_timing: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from bear_tpu_torch import _build
    from bear_tpu_torch.counting import count_chunk as cc

    if not cc.__file__.startswith(root + os.sep):
        raise RuntimeError(f"bear_tpu_torch came from {cc.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    lib = _build.build([cc.SOURCE])[cc.SOURCE]
    print("[build] ptxas: " + " | ".join(
        l.strip() for l in lib.with_suffix(".log").read_text().splitlines() if l.strip()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    l2_flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    record = {"root": os.path.relpath(root, HERE), "card": card, "sms": sms, "forms": {},
              "ablation": {}}
    for name, (codes, meta, lags, shard, total) in forms(cs, dev).items():
        B, L = codes.shape

        def update(t):
            return cc.count_chunk_update(t, codes, meta, lags, cs.N_GROUPS, 4, shard=shard)

        def plain(t):
            return cc.count_chunk_plain(t, codes, meta, lags, cs.N_GROUPS, 4, shard=shard)

        err = held(update, plain, total, dev)
        if err:
            raise SystemExit(f"count_chunk differs from plain at the {name} chunk: {err}")
        if hasattr(cc, "launch_shape"):
            shape = cc.launch_shape(B, L, len(lags), sms)._asdict()
        else:  # the launcher before launch_shape: runs of 8, one lag group
            tile = cc.tile_positions(L)
            shape = {"tile": tile, "run": 8, "groups": 1,
                     "blocks": min(-(-B * (L + 1) // tile), 4 * sms)}
        table = torch.zeros(total, dtype=torch.int32, device=dev)
        ms = cs.timed_ms(lambda: update(table), args.reps, l2_flush)
        dev_ms = cs.device_ms(lambda: update(table), args.reps, l2_flush)
        record["forms"][name] = {"shape": [B, L], "lags": len(lags), "launch_shape": shape,
                                 "ms": ms, "device_ms": dev_ms, "max_abs_err": float(err)}
        print(f"[time] {name}: {B:,} x {L} codes over {len(lags)} lags, launch {shape}: "
              f"ms {ms:.6f}, device_ms {dev_ms:.6f}, == plain [{card}]")
        if args.ablation:
            idx, per_lag = (0, None) if shard is None else (shard[0], tuple(sorted(shard[1].items())))
            mask = cc.lag_table(lags, cs.N_GROUPS, 4, per_lag)
            mod = cc.LagTable.from_buffer_copy(mask)
            mod.a_shift = 0  # the remainder by A^l, as for a protein alphabet
            tile = cc.tile_positions(L)
            earlier = cc.LaunchShape(tile, cc.RUN, 1, min(-(-B * (L + 1) // tile),
                                                          cc.BLOCKS_PER_SM * sms))
            chosen = cc.launch_shape(B, L, len(lags), sms)
            combos = {f"{s}_{k}": (shp, lt) for s, shp in (("earlier", earlier), ("chosen", chosen))
                      for k, lt in (("mod", mod), ("mask", mask))}
            times = {c: [] for c in combos}
            for c, (shp, lt) in combos.items():
                e = held(lambda t: cc.launch(t, codes, meta, lt, idx, shp), plain, total, dev)
                if e:
                    raise SystemExit(f"ablation kernel {c} differs from plain at {name}: {e}")
            for order in (list(combos), list(combos)[::-1]):
                for c in order:
                    shp, lt = combos[c]
                    times[c].append(cs.device_ms(
                        lambda: cc.launch(table, codes, meta, lt, idx, shp), args.reps, l2_flush))
            # The floor: the chosen launch walking the chunk with every
            # position masked (skip past the row's end), no key.
            none = meta.clone()
            none[:, 1] = L + 1
            times["floor_no_keys"] = [cs.device_ms(
                lambda: cc.launch(table, codes, none, mask, idx, chosen), args.reps, l2_flush)]
            # What the floor is made of: one block per SM; a single lag; one
            # row (one tile, one block); a one-element torch op, the events'
            # own floor.
            per_sm = chosen._replace(blocks=sms)
            times["floor_no_keys_one_block_per_sm"] = [cs.device_ms(
                lambda: cc.launch(table, codes, none, mask, idx, per_sm), args.reps, l2_flush)]
            one_lag = cc.lag_table(lags[-1:], cs.N_GROUPS, 4, None if per_lag is None else
                                   tuple(p for p in per_lag if p[0] == lags[-1]))
            shape1 = cc.launch_shape(B, L, 1, sms)
            times["floor_no_keys_one_lag"] = [cs.device_ms(
                lambda: cc.launch(table, codes, none, one_lag, idx, shape1), args.reps, l2_flush)]
            row1 = cc.launch_shape(1, L, len(lags), sms)
            times["floor_no_keys_one_row"] = [cs.device_ms(
                lambda: cc.launch(table, codes[:1], none[:1], mask, idx, row1), args.reps,
                l2_flush)]
            times["torch_one_element_add"] = [cs.device_ms(lambda: table[:1].add_(1),
                                                           args.reps, l2_flush)]
            table.zero_()
            record["ablation"][name] = times
            print(f"[ablation] {name} (device_ms): " + ", ".join(
                f"{c} " + " / ".join(f"{x:.6f}" for x in t) for c, t in times.items())
                  + f" (earlier = {earlier._asdict()}, chosen = {chosen._asdict()}) [{card}]")
            if name != "main":
                sweep = {}
                for run, groups in SWEEP:
                    if groups > len(lags):
                        continue
                    tile = cc.tile_positions(L, run, groups)
                    n_tiles = -(-B * (L + 1) // tile)
                    for cap, blocks in (("capped", min(n_tiles, cc.BLOCKS_PER_SM * sms)),
                                        ("per_tile", n_tiles)):
                        shp = cc.LaunchShape(tile, run, groups, blocks)
                        e = held(lambda t: cc.launch(t, codes, meta, mask, idx, shp), plain,
                                 total, dev)
                        if e:
                            raise SystemExit(f"sweep shape {shp} differs from plain at {name}")
                        sweep[f"run{run}_groups{groups}_{cap}"] = cs.device_ms(
                            lambda: cc.launch(table, codes, meta, mask, idx, shp), args.reps,
                            l2_flush)
                record["ablation"][name + "_sweep"] = sweep
                print(f"[sweep] {name} (device_ms): " + ", ".join(
                    f"{k} {v:.6f}" for k, v in sweep.items()) + f" [{card}]")
        del table
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
