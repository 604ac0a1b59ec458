"""CLI for BEAR sequence generation (port of
bear_tpu/inference/assemble_cli.py).

    python -m bear_tpu_torch.inference.assemble_cli seeds.fa \\
        --counts-csv reads.csv --lag 10 --van 0.1 --right 500 --num 4 --out out_dir

    python -m bear_tpu_torch.inference.assemble_cli seeds.fa \\
        --counts-csv reads.csv --model-dir trained_model/ ...

Counts the reads with reverse=True (forward and reverse complement, the
reference's KMC convention for assembly) through summarize's
``run_counting`` on the card, then extends the seeds from the resident
table with ``assemble_no_ends``. Writes a FASTA of the generated sequences
and, where matplotlib imports, the site-wise entropy plot into --out.
``--device cpu`` runs everything on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds_fasta", help="FASTA of seed sequences (each >= lag long).")
    ap.add_argument("--counts-csv", required=True,
                    help="FILE,GROUP,TYPE csv of training reads to count.")
    ap.add_argument("--group", type=int, default=0,
                    help="count-group column to condition on (default 0).")
    ap.add_argument("--model-dir", default=None,
                    help="Trained model directory (config.cfg + results.pickle); provides "
                         "the BEAR posterior (lag/h/AR) for extension.")
    ap.add_argument("--van", type=float, default=None,
                    help="BMM prior concentration instead of a trained model.")
    ap.add_argument("--lag", type=int, default=None,
                    help="Markov lag (required with --van; from the model otherwise).")
    ap.add_argument("--left", type=int, default=0, help="letters to generate left of each seed.")
    ap.add_argument("--right", type=int, default=100,
                    help="letters to generate right of each seed.")
    ap.add_argument("--num", type=int, default=1, help="generated samples per seed.")
    ap.add_argument("--map", action="store_true",
                    help="extend with the MAP model instead of posterior draws.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--out", required=True, help="output folder (fasta + entropy plot).")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="Where counting and generation run (default: cuda).")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.model_dir is None) == (args.van is None):
        raise SystemExit("specify exactly one of --model-dir / --van")
    if args.van is not None and args.lag is None:
        raise SystemExit("--van requires --lag")

    h = ar_apply = None
    alphabet_name = "dna"
    if args.model_dir is not None:
        from bear_tpu_torch.inference.scoring import load_bear

        lag, alphabet_name, h, ar_apply, _ = load_bear(args.model_dir, device=args.device)
        if args.lag is not None and args.lag != lag:
            raise SystemExit(f"--lag {args.lag} != model lag {lag}")
    else:
        lag = args.lag

    from bear_tpu_torch.counting import fastx
    from bear_tpu_torch.counting.summarize import run_counting
    from bear_tpu_torch.inference.assemble import assemble_no_ends

    entries = fastx.read_input_csv(args.counts_csv)
    n_groups = max(group for _, group, _ in entries) + 1
    if not 0 <= args.group < n_groups:
        raise SystemExit(f"--group {args.group} out of range: {args.counts_csv} defines "
                         f"groups 0..{n_groups - 1}")
    counter = run_counting(args.counts_csv, lags=[lag], reverse=True, alphabet=alphabet_name,
                           device=args.device)
    table = counter.table(lag)[args.group]

    seeds = [seq for _, seq in fastx.iter_fasta(args.seeds_fasta)]
    if not seeds:
        raise SystemExit(f"no sequences in {args.seeds_fasta}")
    gen, _ = assemble_no_ends(
        seeds, [[args.left, args.right]] * len(seeds), args.num, lag=lag, counter_table=table,
        h=h, ar_apply=ar_apply, van=args.van, get_map=args.map, alphabet_name=alphabet_name,
        batch_size=args.batch_size, seed=args.seed, save_folder=args.out, device=args.device)
    print(f"generated {gen.size} sequences ({len(seeds)} seeds x {args.num}) -> {args.out}")
    return 0


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
