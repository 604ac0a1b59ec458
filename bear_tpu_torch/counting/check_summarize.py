"""Standalone checker: verify summarize output TSVs against a brute-force
in-memory recount of the input sequences (port of
bear_tpu/counting/check_summarize.py).

Re-reads the input CSV with the Python readers, recounts every k-mer
transition for every lag with a plain Python dict, and compares exactly
against the TSV shards: forward and (with -r) reverse, for any supported
alphabet (--alphabet dna/rna/prot). It shares nothing with the counting
path but the base encoder.

``python -m bear_tpu_torch.counting.check_summarize file out_prefix -l L [-r]``
"""

from __future__ import annotations

import csv
import glob
import json
import sys
from collections import defaultdict

import numpy as np

from bear_tpu_torch.counting import fastx
from bear_tpu_torch.ops import alphabets as _alpha


def brute_force(entries, max_lag: int, n_groups: int, reverse: bool,
                alphabet: str = "dna", ambig: str = "a"):
    res = _alpha.residues(alphabet)
    A1 = len(res) + 1
    sym = {ch: i for i, ch in enumerate(res)}
    sym["]"] = len(res)
    # code-level complement is res[i] <-> res[3 - i]: A<->T, C<->G for dna,
    # A<->U, C<->G for rna (matching engine.reverse_complement_codes; the
    # old hardcoded ACGT->TGCA map crashed on rna reverse checks)
    rc_map = str.maketrans(res + "?", res[::-1] + "?") if len(res) == 4 else None
    skip_ambig = ambig == "skip"
    out = [
        defaultdict(lambda: np.zeros((n_groups, A1), dtype=np.int64))
        for _ in range(max_lag)
    ]
    # '?' marks ambiguous letters in skip mode — it cannot collide with a
    # residue ('N' would: asparagine).
    letters = np.array(list(res) + ["?"])
    for path, group, ftype in entries:
        for _, seq in fastx.iter_seqs(path, ftype):
            # normalize exactly as the counting engine does: out-of-alphabet
            # letters -> residue 0, or -> the ambiguity marker in skip mode
            seq = "".join(letters[fastx.encode_seq(seq, alphabet,
                                                   ambig=skip_ambig)])
            variants = [seq, seq.translate(rc_map)[::-1]] if reverse else [seq]
            for s in variants:
                for li in range(max_lag):
                    lag = li + 1
                    full = "[" * lag + s + "]"
                    for j in range(lag, len(full)):
                        if skip_ambig and "?" in full[j - lag : j + 1]:
                            continue  # skip mode: window crosses an ambig base
                        out[li][full[j - lag : j]][group][sym[full[j]]] += 1
    return out


def read_outputs(out_prefix: str, max_lag: int):
    found = [dict() for _ in range(max_lag)]
    for li in range(max_lag):
        for path in sorted(glob.glob(f"{out_prefix}_lag_{li+1}_file_*.tsv")):
            with open(path, newline="") as fh:
                for kmer, mat in csv.reader(fh, delimiter="\t"):
                    if kmer in found[li]:
                        raise AssertionError(
                            f"duplicate k-mer {kmer!r} across lag-{li+1} shards"
                        )
                    found[li][kmer] = np.array(json.loads(mat))
    return found


def check(input_csv: str, out_prefix: str, max_lag: int, reverse: bool,
          alphabet: str = "dna", skip_forward: bool = False,
          ambig: str = "a") -> int:
    if skip_forward and not reverse:
        raise ValueError("-nf without -r leaves nothing to check")
    if reverse and alphabet not in ("dna", "rna"):
        raise ValueError("-r (reverse complement) requires a 4-letter alphabet")
    entries = fastx.read_input_csv(input_csv)
    n_groups = max(g for _, g, _ in entries) + 1
    n_checked = 0
    passes = ([] if skip_forward else [(False, out_prefix)]) + (
        [(True, out_prefix + "_rev")] if reverse else []
    )
    for rev, prefix in passes:
        oracle = brute_force(entries, max_lag, n_groups, rev, alphabet,
                             ambig=ambig)
        found = read_outputs(prefix, max_lag)
        for li in range(max_lag):
            want = {k: m for k, m in oracle[li].items() if m.sum() > 0}
            if set(found[li]) != set(want):
                missing = set(want) - set(found[li])
                extra = set(found[li]) - set(want)
                raise AssertionError(
                    f"lag {li+1} ({prefix}): k-mer sets differ "
                    f"(missing {sorted(missing)[:5]}, extra {sorted(extra)[:5]})"
                )
            for kmer, mat in found[li].items():
                if not np.array_equal(mat, want[kmer]):
                    raise AssertionError(
                        f"lag {li+1} ({prefix}) kmer {kmer!r}: {mat.tolist()} != "
                        f"{want[kmer].tolist()}"
                    )
                n_checked += 1
    print(f"OK: {n_checked} k-mer rows verified exactly")
    return 0


def main(args) -> int:
    return check(args.file, args.out_prefix, args.l, args.r,
                 alphabet=args.alphabet, skip_forward=args.nf,
                 ambig=getattr(args, "ambig", "a"))


def cli():
    from bear_tpu_torch.counting.summarize import build_parser

    sys.exit(main(build_parser().parse_args()))


if __name__ == "__main__":
    cli()
