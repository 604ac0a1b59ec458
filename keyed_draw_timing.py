#!/usr/bin/env python3
"""Time the keyed_draw kernel at the main path's draw shapes on one CUDA
card, from this checkout or another one, ablate what it spends, and count
its library routines' instructions in SASS.

    python3 keyed_draw_timing.py [--root DIR] [--ablation] [--sass] [--reps 20]

The inputs are chip_smoke.py's seeded draw inputs (keyed_draw_inputs) at
chip_smoke.KEYED_DRAW_FORMS: (C)'s draw shape (41 samples x 618,496
elements, A1 5, F 3, picked) in float32 and float64, an (E)-sized picked
input (41 x 289,737) and (K)'s per-step shape (1 sample x 1,024 sequences,
F 4, full mode, group b for sequence b). Each is held against
keyed_draw_plain on the card (chip_smoke.keyed_draw_vs_plain's gates),
then timed as chip_smoke.py times it: CUDA events around the wrapper's
call, the mean of ``--reps`` after 3 warm-up calls, L2 not evicted; and
device-only (chip_smoke.device_ms: the host enqueues while a sleep kernel
runs, so the events bracket the kernel alone). Each
form prints its bound (chip_smoke.keyed_draw_work, bound_of: the larger
of the bytes at 3.35 TB/s and each execution unit's instructions at its
rate and the card's maximum SM clock).

``--root DIR`` imports bear_tpu_torch from the checkout at DIR (and builds
its csrc/keyed_draw.cu there), e.g. an earlier commit unpacked with ``git
archive`` into build/parent; the inputs and the timing come from this
checkout's chip_smoke.py. To compare two kernels on one card, run both in
one call, in turns: earlier, this, this, earlier.

``--ablation`` (a checkout whose wrapper has ``launch``): at (C)'s float32
and float64 inputs, timing-only builds of the same source under -D
defines that the wrapper never loads: KEYED_DRAW_FORCE_ACCEPT (every first
proposal taken: what the rejections and their divergence cost, with the
accept test's own work, which the compiler then drops), KEYED_DRAW_NO_RETRY
(the accept test run, no retry: what the retries cost),
KEYED_DRAW_WORDS_ONLY (the Philox words alone: the generator's floor),
KEYED_DRAW_FAST_MATH (__logf, __sincosf/__cosf, __expf in float32: what
the accurate routines cost; other bits, so timing only) and
KEYED_DRAW_MIN_BLOCKS_F32/_F64 = 4, 5, 6, 8 (the register cap of 4-8
resident blocks an SM); and the shipped build with one sample a thread
(what the sample tile saves). Device-only times (chip_smoke.device_ms),
in two turns, forward then reversed.

``--sass``: builds csrc/keyed_draw.cu with -DKEYED_DRAW_PROBES (one small
kernel per library routine), runs ``cuobjdump -sass`` on the library and
counts each probe's instructions, minus its copy baseline, on the path a
normal-range input takes (conditional branches fall through, except one
that skips a call or a loop: a slow path), by execution unit. These are
the counts chip_smoke.ROUTINE_SASS holds. The SASS goes to
chiprun_out/keyed_draw_sass.txt.

Prints the card's name and power limit, the kernel's ptxas report, then
one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ABLATIONS = {"force_accept": ("-DKEYED_DRAW_FORCE_ACCEPT",),
             "no_retry": ("-DKEYED_DRAW_NO_RETRY",),
             "words_only": ("-DKEYED_DRAW_WORDS_ONLY",),
             "fast_math": ("-DKEYED_DRAW_FAST_MATH",)}
# The register cap: blocks of 128 an SM must keep resident, both types.
ABLATIONS.update({f"min_blocks_{n}": (f"-DKEYED_DRAW_MIN_BLOCKS_F32={n}",
                                      f"-DKEYED_DRAW_MIN_BLOCKS_F64={n}") for n in (4, 5, 6, 8)})
PROBES = ("-DKEYED_DRAW_PROBES",)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(log_path) -> str:
    return " | ".join(l.strip() for l in log_path.read_text().splitlines() if l.strip())


# -- SASS --------------------------------------------------------------------

SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FP64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
SFU = ("MUFU", "I2F", "F2I", "F2F", "FRND")  # but I2FP, an ALU instruction


def sass_functions(text: str) -> dict:
    """{function name: [(address, instruction)]} of cuobjdump -sass output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = SASS_LINE.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(ins: str) -> tuple:
    pred = ins.startswith("@")
    if pred:
        ins = ins.split(None, 1)[1]
    return pred, ins.split()[0] if ins else ""


def _target(ins: str):
    m = re.search(r"(?:BRA|CALL\S*)\s+(?:`?\()?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def units(op: str) -> dict:
    """The execution units one instruction occupies (every one an issue
    slot)."""
    u = {"issue": 1}
    if op.startswith(("IMAD", "IMUL")):
        u["imad"] = 1
    elif op.startswith(FP64):
        u["fp64"] = 1
    elif op.startswith(SFU) and not op.startswith("I2FP"):
        u["sfu"] = 1
    return u


def path_count(instrs) -> dict:
    """Instructions by unit on the path from the entry to EXIT: an
    unconditional branch is followed, a conditional one falls through
    unless it jumps forward over a call or a backward branch (a slow path),
    a call is not entered."""
    at = {a: i for i, (a, _) in enumerate(instrs)}
    total, i, steps = {}, 0, 0
    while i < len(instrs) and steps < 100_000:
        steps += 1
        addr, ins = instrs[i]
        pred, op = _opcode(ins)
        if op == "NOP":
            i += 1
            continue
        for k, v in units(op).items():
            total[k] = total.get(k, 0) + v
        if op == "EXIT" and not pred:
            break
        if op.startswith("BRA"):
            tgt = _target(ins)
            if tgt is not None and tgt in at:
                if not pred:
                    i = at[tgt]
                    continue
                skipped = instrs[i + 1:at[tgt]] if tgt > addr else []
                if any(_opcode(s)[1].startswith("CALL") or (
                        _opcode(s)[1].startswith("BRA") and (_target(s) or 1 << 62) <= a)
                        for a, s in skipped):
                    i = at[tgt]
                    continue
        if op.startswith("RET"):
            break
        i += 1
    return total


def _minus(a: dict, *bs: dict) -> dict:
    """a - b - ..., by unit; a unit the baselines outnumber counts 0 (their
    address arithmetic is scheduled otherwise than the probe's)."""
    out = dict(a)
    for b in bs:
        for k, v in b.items():
            out[k] = out.get(k, 0) - v
    return {k: v for k, v in out.items() if v > 0}


def routine_counts(text: str) -> dict:
    """The probes' instruction counts by unit, each minus its baseline."""
    fns = sass_functions(text)
    c = {name: path_count(ins) for name, ins in fns.items() if name.startswith("probe_")}
    out = {}
    for t in ("f32", "f64"):
        base, base2 = c[f"probe_copy_{t}"], c[f"probe_copy2_{t}"]
        for r in ("log", "sqrt", "exp", "cos"):
            out[f"{r}_{t}"] = _minus(c[f"probe_{r}_{t}"], base)
        out[f"sincos_{t}"] = _minus(c[f"probe_sincos_{t}"], base2)
        # a / b against a + b: the add is one instruction (float64: on the fp64 unit)
        add = {"issue": 1, **({"fp64": 1} if t == "f64" else {})}
        out[f"div_{t}"] = _minus(c[f"probe_div_{t}"], c[f"probe_add_{t}"], {k: -v for k, v in
                                                                         add.items()})
        out[f"uniform_{t}"] = _minus(c[f"probe_uniform_{t}"], c[f"probe_bits_{t}"])
    block = _minus(c["probe_philox2"], c["probe_philox1"], c["probe_copy2_u4"],
                   {k: -v for k, v in c["probe_copy_u4"].items()})
    out["philox_block"] = block
    out["key_schedule"] = _minus(c["probe_philox1"], block, c["probe_copy_u4"])
    return out


def sass_report() -> dict:
    from bear_tpu_torch import _build
    from bear_tpu_torch.ops import keyed_draw as kd

    lib = _build.build([kd.SOURCE], PROBES)[kd.SOURCE]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "keyed_draw_sass.txt"), "w") as fh:
        fh.write(text)
    counts = routine_counts(text)
    for name, u in counts.items():
        print(f"[sass] {name}: {u}")
    return counts


# -- timing --------------------------------------------------------------------

def ablation(cs, kd, inputs, F, reps, dtype, card) -> dict:
    """Device-only ms of the shipped kernel, one sample a thread and each
    ABLATIONS build (fast math in float32 only) on ``inputs`` (picked), in
    two turns."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from bear_tpu_torch import _build

    names = [k for k in ABLATIONS if dtype == "float32" or k != "fast_math"]
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per build, all at once
        paths = dict(zip(names, pool.map(
            lambda k: _build.build([kd.SOURCE], ABLATIONS[k])[kd.SOURCE], names)))
    for k, path in paths.items():
        print(f"[build] {k} ptxas: " + ptxas(path.with_suffix(".log")))
    libs = {k: kd.bind(ctypes.CDLL(str(path))) for k, path in paths.items()}
    base, group, rows, conc, nxt = inputs
    S, E = base.shape[0], conc.shape[0]
    chosen = kd.launch_shape(S, E, kd.sm_count(0))
    one = chosen._replace(tile=1, grid_y=S)
    out = torch.empty((S, E), dtype=conc.dtype, device=conc.device)
    runs = {"shipped": lambda: kd.launch(base, group, rows, conc, F, nxt, out, chosen),
            "one_sample_a_thread": lambda: kd.launch(base, group, rows, conc, F, nxt, out, one)}
    for k, lib in libs.items():
        runs[k] = (lambda v: lambda: kd.launch(base, group, rows, conc, F, nxt, out, chosen,
                                               lib=v))(lib)
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(cs.device_ms(runs[k], reps))
    print(f"[ablation] {dtype} at (C)'s shape (device_ms): " + ", ".join(
        f"{k} " + " / ".join(f"{x:.6f}" for x in t) for k, t in times.items()) + f" [{card}]")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose bear_tpu_torch to time")
    ap.add_argument("--ablation", action="store_true", help="also time the -D builds")
    ap.add_argument("--sass", action="store_true", help="count the routines' SASS")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("keyed_draw_timing: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from bear_tpu_torch import _build
    from bear_tpu_torch.ops import keyed_draw as kd

    if not kd.__file__.startswith(root + os.sep):
        raise RuntimeError(f"bear_tpu_torch came from {kd.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    lib = _build.build([kd.SOURCE])[kd.SOURCE]
    print("[build] ptxas: " + ptxas(lib.with_suffix(".log")))
    record = {"root": os.path.relpath(root, HERE), "card": card,
              "clock_mhz": cs.sm_clock_hz() / 1e6, "forms": {}, "ablation": {}}
    if args.sass:
        record["sass"] = sass_report()
    for name, (shape, dtype, F, mode) in cs.KEYED_DRAW_FORMS.items():
        inputs = cs.keyed_draw_form(name, dev)
        stats = cs.keyed_draw_vs_plain(inputs, F, mode)
        cs.keyed_draw_held(f"{name} {shape} {dtype} F {F} {mode}", stats)
        torch.cuda.empty_cache()
        base, group, rows, conc, nxt = inputs
        if mode == "picked":
            call = lambda: kd.keyed_draw_picked(base, group, rows, conc, nxt, F)  # noqa: E731
        else:
            call = lambda: kd.keyed_draw_full(base, group, rows, conc, F)  # noqa: E731
        ms = cs.timed_ms(call, args.reps, None)
        dev_ms = cs.device_ms(call, args.reps)
        nbytes, work = cs.keyed_draw_work(*inputs, picked=mode == "picked")
        bound_ms, bound_by, unit_ms = cs.bound_of(nbytes, work)
        shp = kd.launch_shape(shape[0], shape[1], kd.sm_count(0)) if hasattr(
            kd, "launch_shape") else None
        record["forms"][name] = {"shape": list(shape), "dtype": dtype, "F": F, "mode": mode,
                                 "ms": ms, "device_ms": dev_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by,
                                 "unit_ms": unit_ms, "max_abs_err": stats["max_abs_err"],
                                 "launch_shape": shp._asdict() if shp else None}
        units = ", ".join(f"{k} {v:.6f}" for k, v in unit_ms.items())
        print(f"[time] {name}: {shape} {dtype} F {F} {mode}: ms {ms:.6f}, device_ms "
              f"{dev_ms:.6f}, bound_ms {bound_ms:.6f} ({bound_by}; {units}), launch {shp} "
              f"[{card}]")
        if args.ablation and name in ("C_float32", "C_float64"):
            record["ablation"][name] = ablation(cs, kd, inputs, F, args.reps, dtype, card)
        del inputs, base, group, rows, conc, nxt
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
