"""Scoring CLI: posterior-predictive variant and sequence scores from a
trained model directory (port of bear_tpu/inference/score_cli.py).

``python -m bear_tpu_torch.inference.score_cli snv MODEL_DIR WT_SEQ --all``
``python -m bear_tpu_torch.inference.score_cli variants MODEL_DIR WT_SEQ A12T C45G``
``python -m bear_tpu_torch.inference.score_cli seqs MODEL_DIR seq1 seq2 ...``
``python -m bear_tpu_torch.inference.score_cli seqs MODEL_DIR --fasta seqs.fa``

Outputs TSV to stdout: one row per variant/sequence with per-model scores
(BEAR at the fitted h, then each --van BMM prior; means over --mc-samples,
or exact values with --map, and for the seqs mode also exact marginals with
--marg). ``snv`` and ``variants --device`` run the batched BearServer
route. Everything runs on ``--torch-device`` (default cuda).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Score variants or sequences under a trained BEAR model.")
    sub = p.add_subparsers(dest="command", required=True)

    def torch_device(sp):
        sp.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                        help="Device that scores (default cuda).")

    def common(sp):
        sp.add_argument("model_dir", help="Trained model directory (config.cfg + results.pickle).")
        sp.add_argument("--train-col", type=int, default=0)
        sp.add_argument("--mc-samples", type=int, default=41)
        sp.add_argument("--van", type=float, action="append", default=None,
                        help="BMM prior(s) to score alongside BEAR (repeatable).")
        sp.add_argument("--map", action="store_true", help="Exact MAP scores instead of sampling.")
        sp.add_argument("--seed", type=int, default=0)
        torch_device(sp)

    v = sub.add_parser("variants", help="Δ log-prob of variants vs a wild-type sequence.")
    common(v)
    v.add_argument("wt_seq", help="Wild-type sequence (no padding symbols).")
    v.add_argument("vars", nargs="+", help="Variants like A12T, CG45T (wt, position, mutant).")
    v.add_argument("--device", action="store_true",
                   help="Batched device route (BearServer): BEAR scores only, "
                        "for large variant sets incl. indels.")

    s = sub.add_parser("seqs", help="Log-probabilities of whole sequences.")
    common(s)
    s.add_argument("seqs", nargs="*", help="Sequences to score.")
    s.add_argument("--fasta", help="Score the sequences in this FASTA file instead.")
    s.add_argument("--marg", action="store_true", help="Exact marginal likelihoods.")

    d = sub.add_parser(
        "snv",
        help="Deep-mutational-scan substitution scan on the device "
             "(BearServer): Δ log-prob per SNV under the fitted BEAR posterior.",
    )
    d.add_argument("model_dir", help="Trained model directory (config.cfg + results.pickle).")
    d.add_argument("wt_seq", help="Wild-type sequence (no padding symbols).")
    d.add_argument("vars", nargs="*",
                   help="SNVs like A12T (single-base wt, 0-based position, "
                        "single-base mutant); omit with --all.")
    d.add_argument("--all", action="store_true",
                   help="Score every position x every alternate base "
                        "(a full deep-mutational-scan grid).")
    d.add_argument("--train-col", type=int, default=0)
    d.add_argument("--mc-samples", type=int, default=41,
                   help="Posterior draws with --sample.")
    d.add_argument("--sample", action="store_true",
                   help="Posterior-sampled scores (mean over --mc-samples) "
                        "instead of exact MAP.")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--std", action="store_true",
                   help="With --sample: add a Monte-Carlo std column.")
    d.add_argument("--batch", type=int, default=1 << 17,
                   help="Device batch size (variants per step).")
    torch_device(d)
    return p


def _validate(args, parser):
    if getattr(args, "marg", False) and args.map:
        parser.error("--map and --marg are mutually exclusive")


def _main_snv(args, parser) -> int:
    """Device route: BearServer.from_model_dir + delta_scores_snv."""
    from bear_tpu_torch.inference import BearServer, parse_var
    from bear_tpu_torch.ops import alphabets
    from bear_tpu_torch.ops.keyed_random import key

    wt = args.wt_seq
    if args.all and args.vars:
        parser.error("give explicit SNVs or --all, not both")
    if not args.all and not args.vars:
        parser.error("no SNVs given (positional or --all)")
    if args.std and not args.sample:
        parser.error("--std requires --sample (MAP scores have no Monte-Carlo spread)")
    positions, alts, labels = [], [], []
    for var in args.vars:
        ref, alt, pos = parse_var(var)
        if len(ref) != 1 or len(alt) != 1:
            parser.error(
                f"{var!r} is not a single-base substitution; use the "
                "'variants' subcommand for indels/multi-base variants"
            )
        if pos < 0 or pos >= len(wt) or wt[pos] != ref:
            parser.error(f"{var!r} does not match the wild-type sequence")
        positions.append(pos)
        alts.append(alt)
        labels.append(var)
    server = BearServer.from_model_dir(args.model_dir, train_col=args.train_col,
                                       device=args.torch_device)
    if args.all:
        letters = alphabets.input_letters(server.alphabet)[:-1]  # residues only
        for i, ref in enumerate(wt):
            for alt in letters:
                if alt != ref:
                    positions.append(i)
                    alts.append(alt)
                    labels.append(f"{ref}{i}{alt}")
    stds = None
    if args.sample:
        out = server.delta_scores_snv(
            wt, positions, np.array(alts), batch=args.batch, mode="sample",
            key=key(args.seed), mc_samples=args.mc_samples, reduce="mean_std",
        )
        scores = out[:, 0]
        if args.std:
            stds = out[:, 1]
    else:
        scores = server.delta_scores_snv(wt, positions, np.array(alts),
                                         batch=args.batch, mode="map")
    if stds is None:
        print("variant\tBEAR")
        for label, val in zip(labels, scores):
            print(f"{label}\t{val:.6f}")
    else:
        print("variant\tBEAR\tmc_std")
        for label, val, sd in zip(labels, scores, stds):
            print(f"{label}\t{val:.6f}\t{sd:.6f}")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _validate(args, parser)
    if args.command == "snv":
        return _main_snv(args, parser)
    if args.command == "variants" and args.device:
        from bear_tpu_torch.inference import BearServer
        from bear_tpu_torch.ops.keyed_random import key

        server = BearServer.from_model_dir(args.model_dir, train_col=args.train_col,
                                           device=args.torch_device)
        if args.map:
            scores = server.delta_scores_variants(args.wt_seq, args.vars)
        else:
            scores = server.delta_scores_variants(
                args.wt_seq, args.vars, mode="sample", key=key(args.seed),
                mc_samples=args.mc_samples, reduce="mean_std",
            )[:, 0]
        print("target\tBEAR")
        for label, val in zip(args.vars, scores):
            print(f"{label}\t{val:.6f}")
        return 0
    from bear_tpu_torch.inference import get_bear_probs, get_bear_probs_seqs, model_column_names

    vans = args.van if args.van is not None else []
    kwargs = dict(train_col=args.train_col, mc_samples=args.mc_samples, vans=vans,
                  get_map=args.map, seed=args.seed, device=args.torch_device)

    if args.command == "variants":
        scores = get_bear_probs(args.model_dir, args.wt_seq, np.array(args.vars), **kwargs)
        labels = args.vars
    else:
        seqs = list(args.seqs)
        labels = list(args.seqs)
        if args.fasta:
            from bear_tpu_torch.counting import fastx

            for name, seq in fastx.iter_fasta(args.fasta):
                seqs.append(seq)
                labels.append(name)
        if not seqs:
            print("no sequences given (positional or --fasta)", file=sys.stderr)
            return 2
        if args.marg:
            kwargs["get_marg"] = True
            kwargs["get_map"] = False
        scores = get_bear_probs_seqs(args.model_dir, seqs, **kwargs)

    model_names = model_column_names(vans, get_map=args.map)
    if scores.ndim == 3:
        scores = scores.mean(-1)  # mean over mc samples
    print("target\t" + "\t".join(model_names))
    for label, row in zip(labels, scores):
        print(label + "\t" + "\t".join(f"{x:.6f}" for x in np.atleast_1d(row)))
    return 0


def cli():
    sys.exit(main())


if __name__ == "__main__":
    cli()
