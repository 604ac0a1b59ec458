"""CLI: choose the BEAR lag by exact BMM marginal likelihood (port of
bear_tpu/models/lag_select_cli.py).

    python -m bear_tpu_torch.models.lag_select_cli reads.csv -l 10
    python -m bear_tpu_torch.models.lag_select_cli --counts out_prefix -l 10

Either counts every lag 1..l of a FILE,GROUP,TYPE csv in one pass on the
card (summarize's ``run_counting``, one ``count_chunk`` launch per chunk)
and sweeps the resident tables, or reads summarized count TSVs. ``--passes
N`` counts in N row-range passes (lags 14-15) and lags beyond 15 count
sparse-first; the sweep then streams the sparse rows. ``--kmer-shards N``
splits the tables' rows over N devices (summarize's mesh: the first N
cards, or N entries of the CPU). ``--device cpu`` runs all of it on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Select the BEAR lag by maximum BMM marginal likelihood."
    )
    p.add_argument("input", help="Input csv of FILE,GROUP,TYPE rows, or (with "
                                 "--counts) a summarize output prefix.")
    p.add_argument("--counts", action="store_true",
                   help="input is a summarize out_prefix; read "
                        "{prefix}_lag_{l}_file_*.tsv instead of counting.")
    p.add_argument("-l", type=int, default=10, help="Maximum lag to score.")
    p.add_argument("--min-lag", type=int, default=1, help="Smallest lag.")
    p.add_argument("--alphas", type=float, nargs="+", default=[0.01, 0.1, 1.0],
                   help="Symmetric Dirichlet prior concentrations to scan.")
    p.add_argument("--group", type=int, default=0, help="Dataset/group column to score.")
    p.add_argument("--alphabet", choices=["dna", "rna", "prot"], default="dna")
    p.add_argument("-r", action="store_true",
                   help="Also count reverse complements (counting mode).")
    p.add_argument("--ambig", choices=["a", "skip"], default="a",
                   help="Ambiguous-base handling in counting mode: 'a' folds N to A, "
                        "'skip' drops transitions whose window covers an N; must match "
                        "the mode of any --counts TSVs being compared.")
    p.add_argument("--num-ds", type=int, default=None,
                   help="Dataset columns in the TSVs (--counts mode; default: sniff).")
    p.add_argument("--passes", type=int, default=1,
                   help="Count in N sequential row-range passes on one card (lag "
                        "14-15 tables beyond one card; the marginal sweep then "
                        "streams the sparse rows).")
    p.add_argument("--kmer-shards", type=int, default=1,
                   help="Shard the count tables over N devices along a 'kmer' mesh "
                        "axis (counting mode).")
    p.add_argument("--json", action="store_true",
                   help="Print one machine-readable JSON line instead of the table.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where counting and the sweep run (default: cuda).")
    return p


def main(args) -> int:
    from bear_tpu_torch.models.lag_selection import select_lag, select_lag_from_tsvs

    lags = range(args.min_lag, args.l + 1)
    if args.counts:
        sel = select_lag_from_tsvs(args.input, lags, alphas=args.alphas, group=args.group,
                                   num_ds=args.num_ds, alphabet=args.alphabet,
                                   device=args.device)
    else:
        from bear_tpu_torch.counting.summarize import run_counting

        counter = run_counting(args.input, lags=lags, reverse=args.r, alphabet=args.alphabet,
                               ambig=args.ambig, passes=args.passes,
                               kmer_shards=args.kmer_shards, device=args.device)
        sel = select_lag(counter, alphas=args.alphas, group=args.group)

    best = sel.best
    if args.json:
        print(json.dumps({
            "best_lag": best,
            "best_alpha": sel.best_alpha(best),
            "lags": list(sel.lags),
            "alphas": list(map(float, sel.alphas)),
            "log_marginals": [[float(v) for v in row] for row in sel.log_marginals],
        }))
        return best

    print("lag  " + "".join(f"{f'alpha={a:g}':>18}" for a in sel.alphas))
    for lag, row in zip(sel.lags, sel.log_marginals):
        mark = " <- best" if lag == best else ""
        print(f"{lag:<5}" + "".join(f"{v:>18.4f}" for v in row) + mark)
    print(f"best lag: {best} (alpha={sel.best_alpha(best):g})")
    return best


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    sys.exit(cli())
