"""Summarization CLI: sequence files -> per-lag transition-count TSVs, on the
card (port of bear_tpu/counting/summarize.py).

    python -m bear_tpu_torch.counting.summarize infiles.csv out/run -l 13

Same inputs (a csv of FILE,GROUP,TYPE rows), same outputs
(``{out_prefix}_lag_{l}_file_{b}.tsv`` with rows ``kmer\\t[[group0
counts],...]``; ``-r`` adds a reverse-complement pass written to
``{out_prefix}_rev_*``) and the same flags as bear_tpu's:

-l      max lag (default 10); every lag 1..l is counted in one table, one
        count_chunk launch per chunk
-nf     skip the forward pass
-r      additionally run a reverse-complement pass (counts fwd+rc)
-mf     max output chunk size in GB -> number of shard files
--ambig {a,skip}  fold ambiguous bases to A, or drop every transition whose
        window crosses one
--shuffle  shuffle rows within each shard
--checkpoint PATH  checkpoint counts after every input file; a rerun resumes
--passes N  count in N sequential row-range passes on one card, re-reading
        the input each pass (lags 14-15: the table is too large for one
        card; count_chunk's row-range form, one launch per chunk and pass)
-mk/-p/-pr/-t/-s12/-s3  accepted for compatibility; no-ops
--method  accepted and ignored: the port has one counting kernel
--device {cuda,cpu}  where the table lives and the kernel runs (default cuda)

Lags beyond the dense int32 range (DNA >= 16, protein >= 8) route
themselves to the sparse-first counter (counting/sparse.py: key buffers
sorted on the card, no dense table). ``--kmer-shards`` and ``--data-shards``
above 1 need several cards and raise NotImplementedError (ROADMAP.md Queue 1
item 13).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bear_tpu_torch.counting import engine, fastx
from bear_tpu_torch.counting.multipass import count_multipass
from bear_tpu_torch.counting.sparse import SparseTransitionCounter
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.parallel.counting import not_ported_multi_card


def iter_chunks(entries, max_lag: int, batch_size: int = 1024,
                segment_len: int = 1 << 16, reverse: bool = False,
                alphabet: str = "dna", stats: dict | None = None,
                ambig: str = "a", native: bool = True):
    """Yield ReadChunks over FILE,GROUP,TYPE ``entries``: the one place
    that routes files between the native parser and the Python readers.

    Files the native parser takes (:func:`fastx.native_reads`) are parsed
    whole in C++ and packed by :func:`engine.chunks_from_packed`, the next
    file parsing on a thread while this one's chunks are counted; all
    other files share one Python-reader stream. ``stats`` (optional dict)
    accumulates ``bases``, ``reads``, ``ambig`` (in skip mode),
    ``parse_s`` (seconds inside the native parser) and ``parser`` (path ->
    "native" or "python")."""
    if ambig not in ("a", "skip"):
        raise ValueError(f"ambig must be 'a' or 'skip', got {ambig!r}")
    skip_ambig = ambig == "skip"
    ambig_code = len(_alpha.residues(alphabet))
    native_entries, fallback = [], []
    for entry in entries:
        (native_entries if fastx.native_reads(entry[0], alphabet, native)
         else fallback).append(entry)

    def note(path, parser, codes, n_reads):
        if stats is None:
            return
        stats["bases"] = stats.get("bases", 0) + len(codes)
        stats["reads"] = stats.get("reads", 0) + n_reads
        stats.setdefault("parser", {})[path] = parser
        if skip_ambig:
            stats["ambig"] = stats.get("ambig", 0) + int(
                np.count_nonzero(codes == ambig_code))

    if native_entries:
        lib = fastx._native()

        def parse(entry):
            t0 = time.perf_counter()
            codes_flat, offsets = lib.parse(entry[0], entry[2], skip_ambig)
            return codes_flat, offsets, time.perf_counter() - t0

        # Depth-1 prefetch: the next file parses (C++, the GIL released)
        # while this file's chunks pack and count; at most two files'
        # codes are held.
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(parse, native_entries[0])
            for i, (path, group, _) in enumerate(native_entries):
                codes_flat, offsets, parse_s = fut.result()
                if i + 1 < len(native_entries):
                    fut = pool.submit(parse, native_entries[i + 1])
                note(path, "native", codes_flat, len(offsets) - 1)
                if stats is not None:
                    stats["parse_s"] = stats.get("parse_s", 0.0) + parse_s
                yield from engine.chunks_from_packed(
                    codes_flat, offsets, group, max_lag, batch_size, segment_len,
                    reverse=reverse, ambig_code=ambig_code if skip_ambig else None)
    if fallback:
        def stream():
            for path, group, ftype in fallback:
                for arr, g in fastx.stream_encoded([(path, group, ftype)], alphabet,
                                                   ambig=skip_ambig, native=False):
                    note(path, "python", arr, 1)
                    yield arr, g

        reads = stream()
        if skip_ambig:
            reads = engine.split_ambiguous(reads, ambig_code)
        yield from engine.chunk_reads(reads, max_lag, batch_size, segment_len,
                                      reverse=reverse)


def run_counting(input_csv: str, lags, reverse: bool = False, batch_size: int = 1024,
                 segment_len: int = 1 << 16, method: str = "auto", kmer_shards: int = 1,
                 alphabet: str = "dna", checkpoint: str | None = None,
                 stats: dict | None = None, ambig: str = "a", passes: int = 1,
                 data_shards: int = 1, device="cuda", native: bool = True):
    """Count transitions for all requested lags over the input file set on
    ``device``. Returns an engine.TransitionCounter; with ``passes`` > 1 a
    multipass.MultiPassTransitionCounter (each pass re-reads every file;
    ``stats`` cover one traversal); beyond the dense int32 range (DNA lag >=
    16, protein >= 8) a sparse.SparseTransitionCounter. The last two share
    the sparse host surface (nonzero_rows, counts_for_rows, export_tsv,
    validate, ...).

    method: accepted for bear_tpu's signature and ignored (one kernel).
    checkpoint: optional path; counts are saved after every completed input
    file (write + atomic rename) and a rerun resumes after the last finished
    file (not with ``passes``). ambig: "a" folds unknown bases to A; "skip"
    drops transitions whose window crosses one. kmer_shards and data_shards
    above 1 need several cards and raise NotImplementedError."""
    if reverse and alphabet not in ("dna", "rna"):
        raise ValueError("-r (reverse complement) requires a 4-letter alphabet")
    if data_shards > 1 and (passes > 1 or kmer_shards > 1):
        raise ValueError("--data-shards is mutually exclusive with --passes and "
                         "--kmer-shards (row-parallel vs table-split scaling)")
    lags = sorted(set(int(l) for l in lags))
    entries = fastx.read_input_csv(input_csv)
    n_groups = max(group for _, group, _ in entries) + 1
    # The reverse complement is emitted in the read stream (each read also
    # as its RC, before segmentation); the counter stays forward-only.
    chunk_kw = dict(batch_size=batch_size, segment_len=segment_len, reverse=reverse,
                    alphabet=alphabet, ambig=ambig, native=native)
    if passes > 1:
        if kmer_shards > 1:
            raise ValueError("--passes and --kmer-shards are mutually exclusive "
                             "(row-split in time vs over devices)")
        if checkpoint is not None:
            raise ValueError("--checkpoint is not supported with --passes "
                             "(each pass re-reads every file)")
        first_pass = [stats]

        def factory():
            # Parse and read stats cover ONE traversal: every pass re-reads
            # the same bytes.
            s = first_pass.pop() if first_pass else None
            chunks = iter_chunks(entries, max(lags), stats=s, **chunk_kw)
            return chunks if s is None else _counted(chunks, s)

        return count_multipass(factory, lags=lags, n_groups=n_groups, passes=passes,
                               alphabet=alphabet, device=device)
    if kmer_shards > 1:
        not_ported_multi_card(f"--kmer-shards {kmer_shards}")
    if _alpha.alphabet_size(alphabet) ** max(lags) > np.iinfo(np.int32).max:
        # Beyond the dense int32 range: the sparse-first counter sorts key
        # buffers on the card (KMC's design) and shares save/load_state, so
        # the file-granular checkpoint below works unchanged.
        if data_shards > 1:
            not_ported_multi_card(f"--data-shards {data_shards}")
        counter = SparseTransitionCounter(lags=lags, n_groups=n_groups, alphabet=alphabet,
                                          device=device)
    elif data_shards > 1:
        raise ValueError(
            "--data-shards applies to sparse-first counting (DNA lag >= 16 / protein "
            "lag >= 8); dense-range lags scale with --kmer-shards or --passes")
    else:
        counter = engine.TransitionCounter(lags=lags, n_groups=n_groups,
                                           alphabet=alphabet, device=device)
    chunk_kw["stats"] = stats
    if checkpoint is None:
        _count(counter, iter_chunks(entries, counter.max_lag, **chunk_kw), stats)
        return counter

    ckpt = checkpoint if checkpoint.endswith(".npz") else checkpoint + ".npz"
    files_json = ckpt + ".files.json"
    done: set[str] = set()
    if os.path.exists(ckpt) and os.path.exists(files_json):
        if isinstance(counter, SparseTransitionCounter):
            # Restore into the counter built above (its load_state checks
            # lags, groups, reverse and alphabet).
            counter.load_state(ckpt)
        else:
            counter = engine.TransitionCounter.load_state(ckpt, device=device)
            if (tuple(counter.lags) != tuple(lags) or counter.n_groups != n_groups
                    or counter.reverse or counter.alphabet != alphabet):
                raise ValueError(
                    f"checkpoint {ckpt} was written with different counting parameters "
                    "(lags/groups/reverse/alphabet); delete it or use a fresh path")
        with open(files_json) as fh:
            done = set(json.load(fh))
        print(f"resuming from {ckpt}: {len(done)} files already counted")
        if stats is not None and done:
            stats["partial"] = True  # this run's stats miss the files done before
    for entry in entries:
        if entry[0] in done:
            continue
        # One file per stream: the file is the resume unit.
        _count(counter, iter_chunks([entry], counter.max_lag, **chunk_kw), stats)
        done.add(entry[0])
        tmp = ckpt + ".tmp"
        counter.save_state(tmp)  # save_state appends .npz
        os.replace(tmp + ".npz", ckpt)
        tmp_json = files_json + ".tmp"
        with open(tmp_json, "w") as fh:
            json.dump(sorted(done), fh)
        os.replace(tmp_json, files_json)
    return counter


def _count(counter, chunks, stats):
    for chunk in _counted(chunks, stats):
        counter.add_chunk(chunk)


def _counted(chunks, stats):
    """The chunks, each counted in ``stats["chunks"]`` (when stats is a dict)."""
    for chunk in chunks:
        if stats is not None:
            stats["chunks"] = stats.get("chunks", 0) + 1
        yield chunk


def compute_n_bin_bits(total_rows: int, n_groups: int, mf_gb: float) -> int:
    """Shard count: rows are taken as ~32 bytes per group in TSV form, and
    shards hold at most ``mf_gb`` GB."""
    approx_bytes = total_rows * n_groups * 32
    return int(max(np.ceil(np.log2(max(approx_bytes / (mf_gb * 1e9), 1))), 0))


def run(args, report: dict | None = None) -> int:
    """One counting pass and its export; returns the shard count per lag.
    ``report`` (optional dict) receives the pass's ``stats`` (bases, reads,
    chunks, seconds inside the parser, the parser of each file), the
    seconds of counting (to the last kernel finished) and of export, the
    nonzero rows per lag, the bytes of the counter's device table or key
    buffers, and the counter itself."""
    print("Counting...", datetime.datetime.now())
    ckpt = args.checkpoint
    if ckpt and args.r:
        ckpt += "_rev"  # the reverse pass is a separate counting job
    stats = {"bases": 0, "reads": 0}
    t0 = time.perf_counter()
    counter = run_counting(args.file, lags=range(1, args.l + 1), reverse=args.r,
                           method=args.method, kmer_shards=args.kmer_shards,
                           alphabet=args.alphabet, checkpoint=ckpt, stats=stats,
                           ambig=args.ambig, passes=args.passes,
                           data_shards=args.data_shards, device=args.device)
    counter.sync()
    t1 = time.perf_counter()
    if stats.get("ambig"):
        print(f"ambig=skip: {stats['ambig']} ambiguous bases; transitions "
              "whose window crosses one were dropped")
    # Count conservation: a read of length n gives n+1 transitions at every
    # lag (x2 with -r). Not checkable after a resume (this run's stats miss
    # the earlier files) nor in skip mode (per-lag totals differ there).
    if not stats.get("partial") and not stats.get("ambig"):
        expected = (stats["bases"] + stats["reads"]) * (2 if args.r else 1)
        counter.validate(expected_transitions=expected)
        print(f"Counted {stats['reads']} reads / {stats['bases']} bases "
              f"({stats['bases'] + stats['reads']} transitions per lag"
              f"{' x2 rc' if args.r else ''}; conservation verified)")
    print("Writing...", datetime.datetime.now())
    # One scan per lag gives the rows for both the shard count and the export.
    rows_by_lag = {l: counter.nonzero_rows(l) for l in counter.lags}
    total_rows = sum(len(r) for r in rows_by_lag.values())
    n_bin_bits = compute_n_bin_bits(total_rows, counter.n_groups, args.mf)
    for l in counter.lags:
        counter.export_tsv(args.out_prefix, l, n_bin_bits, shuffle=args.shuffle,
                           rows=rows_by_lag[l])
    if report is not None:
        report.update(stats=stats, count_s=t1 - t0, export_s=time.perf_counter() - t1,
                      rows={l: len(r) for l, r in rows_by_lag.items()},
                      table_bytes=4 * counter.table_size, counter=counter)
    print("Finished.", datetime.datetime.now())
    return 2**n_bin_bits


def main(args, report: dict | None = None):
    """Forward pass, then the optional reverse pass with a ``_rev`` prefix
    (reference summarize.py:648-663). Returns (shards per lag forward,
    shards per lag reverse), None for a pass not run. ``report`` (optional
    dict) receives each pass's :func:`run` report under "forward" and
    "reverse"."""
    n_bins = n_bins_rev = None
    store_r = args.r
    args.r = False
    if not args.nf:
        n_bins = run(args, None if report is None else report.setdefault("forward", {}))
    if store_r:
        args.r = True
        args.out_prefix += "_rev"
        n_bins_rev = run(args, None if report is None else report.setdefault("reverse", {}))
    return n_bins, n_bins_rev


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Extract k-mer transition-count summary statistics for BEAR "
                    "training, counted on the card.")
    parser.add_argument("file", help="Input csv of FILE,GROUP,TYPE rows.")
    parser.add_argument("out_prefix", help="Prefix for output files.")
    parser.add_argument("-l", default=10, type=int, help="Maximum lag.")
    parser.add_argument("-mk", default=12, type=float, help="(compat; unused: no KMC)")
    parser.add_argument("-mf", default=0.1, type=float, help="Max output chunk size (GB).")
    parser.add_argument("-p", default="", help="(compat; unused: no KMC binaries)")
    parser.add_argument("-nf", action="store_true", default=False, help="Skip forward pass.")
    parser.add_argument("-r", action="store_true", default=False,
                        help="Also run reverse-complement pass.")
    parser.add_argument("-pr", action="store_true", default=False,
                        help="(compat; all lags always counted)")
    parser.add_argument("-t", default="tmp/", help="(compat; unused: no temp files)")
    parser.add_argument("-s12", action="store_true", default=False, help="(compat; unused)")
    parser.add_argument("--ambig", choices=["a", "skip"], default="a",
                        help="Ambiguous bases (N): fold to A (the reference's "
                             "behaviour) or skip every transition whose window "
                             "crosses one.")
    parser.add_argument("-s3", action="store_true", default=False, help="(compat; unused)")
    parser.add_argument("--shuffle", action="store_true", default=False,
                        help="Shuffle output rows within each shard.")
    parser.add_argument("--method", default="auto", choices=("auto", "sorted", "scatter"),
                        help="Accepted for bear_tpu's command line and ignored: the "
                             "port has one counting kernel (count_chunk).")
    parser.add_argument("--alphabet", default="dna", choices=("dna", "rna", "prot"),
                        help="Residue alphabet.")
    parser.add_argument("--kmer-shards", default=1, type=int, dest="kmer_shards",
                        help="Shard count tables over this many cards (not ported "
                             "yet: only 1; --passes splits them in time on one card).")
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint counts after every completed input file; a "
                             "rerun with the same flag resumes after the last "
                             "finished file.")
    parser.add_argument("--data-shards", default=1, type=int, dest="data_shards",
                        help="Sparse counting over this many cards (not ported yet: "
                             "only 1).")
    parser.add_argument("--passes", default=1, type=int,
                        help="Count in this many sequential row-range passes on one "
                             "card, re-reading the input each pass (lag 14-15 tables "
                             "beyond one card).")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Where the count table lives and the kernel runs "
                             "(default: cuda).")
    return parser


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
