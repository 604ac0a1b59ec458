"""The port's summarize CLI (bear_tpu_torch.counting.summarize) against
bear_tpu's, on the CPU: every output file byte-identical, for the same
inputs made with numpy from a seed. Also the chunk packer, the NumPy
formatter and packer against the native ones, the brute-force checker,
file-granular checkpoint resume, and count-state files read across the two
packages."""

import filecmp
import gzip
import os

import numpy as np
import pytest
import torch

from bear_tpu.counting import engine as jengine
from bear_tpu.counting import summarize as jsummarize
from bear_tpu_torch.counting import check_summarize, engine, fastx, native, summarize

torch.set_num_threads(2)
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"


def _seq(rng, letters, n, n_frac=0.0):
    s = rng.choice(list(letters), size=n)
    if n_frac:
        s[rng.random(n) < n_frac] = "N"
    return "".join(s)


def _write(path, kind, seqs, gz=False):
    if kind == "fq":
        text = "".join(f"@r{i} x\n{s}\n+\n{'F' * len(s)}\n" for i, s in enumerate(seqs))
    else:  # fasta, sequences wrapped at 30 letters, a blank line between records
        text = "".join(f">r{i} x\n" + "".join(s[j:j + 30] + "\n"
                                               for j in range(0, len(s), 30)) + "\n"
                       for i, s in enumerate(seqs))
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        fh.write(text)


def _inputs(tmp, case):
    """Write case's read files and its infiles.csv; returns (csv, args)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    letters, n_frac, args = "ACGT", 0.0, []
    files = [("a.fq", "fq", False, 0), ("b.fa", "fa", False, 0)]
    if case == "fastq":
        args = ["-l", "4"]
    elif case == "fasta_gzip_three_groups":
        files = [("a.fq.gz", "fq", True, 0), ("b.fa", "fa", False, 1),
                 ("c.fa.gz", "fa", True, 2), ("d.fq", "fq", False, 1)]
        args = ["-l", "5"]
    elif case == "reverse":
        args = ["-l", "4", "-r"]
    elif case == "ambig_skip":
        n_frac, args = 0.05, ["-l", "5", "--ambig", "skip"]
    elif case == "ambig_fold":
        n_frac, args = 0.05, ["-l", "3"]
    elif case == "shuffle_small_mf":
        args = ["-l", "6", "--shuffle", "-mf", "0.00005"]
    elif case == "protein_lag3":
        letters, args = PROTEIN, ["-l", "3", "--alphabet", "prot"]
        files = [("p.fa", "fa", False, 0), ("q.fq", "fq", False, 1)]
    rows = []
    for name, kind, gz, group in files:
        seqs = [_seq(rng, letters, int(rng.integers(0, 60)), n_frac) for _ in range(120)]
        _write(tmp / name, kind, seqs, gz)
        rows.append(f"{name},{group},{kind}\n")
    (tmp / "infiles.csv").write_text("".join(rows))
    return str(tmp / "infiles.csv"), args


def _outputs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".tsv"))


def _same_files(a, b):
    names = _outputs(a)
    assert names and names == _outputs(b)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)
    return names


def _run_both(tmp_path, csv, args):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jret = jsummarize.main(jsummarize.build_parser().parse_args(
        [csv, str(tmp_path / "jax" / "run"), *args]))
    report = {}
    pret = summarize.main(summarize.build_parser().parse_args(
        [csv, str(tmp_path / "port" / "run"), *args, "--device", "cpu"]), report)
    assert pret == jret
    return _same_files(tmp_path / "jax", tmp_path / "port"), report


CASES = ["fastq", "fasta_gzip_three_groups", "reverse", "ambig_skip", "ambig_fold",
         "shuffle_small_mf", "protein_lag3"]


@pytest.mark.parametrize("case", CASES)
def test_summarize_bytes_equal_bear_tpu(tmp_path, case):
    csv, args = _inputs(tmp_path, case)
    names, report = _run_both(tmp_path, csv, args)
    lag = int(args[args.index("-l") + 1])
    assert all(any(f"_lag_{l}_file_" in n for n in names) for l in range(1, lag + 1))
    if case == "shuffle_small_mf":
        assert len([n for n in names if "_lag_6_" in n]) >= 4
    if case == "reverse":
        assert any("_rev_lag_" in n for n in names)
        assert set(report) == {"forward", "reverse"}
    stats = report["forward"]["stats"]
    want = "python" if case == "protein_lag3" else "native"
    assert set(stats["parser"].values()) == {want}
    assert stats["chunks"] >= 1
    kw = dict(alphabet="prot" if case == "protein_lag3" else "dna",
              ambig="skip" if case == "ambig_skip" else "a")
    assert check_summarize.check(csv, str(tmp_path / "port" / "run"), lag,
                                 case == "reverse", **kw) == 0


def test_check_summarize_fails_on_a_corrupted_shard(tmp_path):
    csv, args = _inputs(tmp_path, "fastq")
    prefix = str(tmp_path / "run")
    summarize.main(summarize.build_parser().parse_args([csv, prefix, *args, "--device",
                                                        "cpu"]))
    assert check_summarize.check(csv, prefix, 4, False) == 0
    shard = f"{prefix}_lag_3_file_0.tsv"
    lines = open(shard).read().splitlines()
    kmer, mat = lines[5].split("\t")
    lines[5] = f"{kmer}\t{mat.replace('[[', '[[1', 1)}"  # one count gains a digit
    open(shard, "w").write("\n".join(lines) + "\n")
    with pytest.raises(AssertionError, match="lag 3"):
        check_summarize.check(csv, prefix, 4, False)


@pytest.mark.parametrize("mode", ["numpy_formatter", "python_reader_and_numpy_formatter"])
def test_numpy_paths_write_the_native_bytes(tmp_path, mode):
    csv, _ = _inputs(tmp_path, "fasta_gzip_three_groups")
    out = {}
    for native in (True, False):
        counter = summarize.run_counting(
            csv, range(1, 6), device="cpu",
            native=native if mode == "python_reader_and_numpy_formatter" else True)
        d = tmp_path / f"native_{native}"
        d.mkdir()
        for l in counter.lags:
            counter.export_tsv(str(d / "run"), l, 1, shuffle=True, native=native)
        out[native] = d
    _same_files(out[True], out[False])


def _packed_reads(rng, n_frac):
    seqs = [_seq(rng, "ACGT", int(rng.integers(0, 300)), n_frac) for _ in range(200)]
    seqs[3] = ""  # an empty read
    seqs[7] = "NNACGTN"
    codes = [fastx.encode_seq(s, ambig=n_frac > 0) for s in seqs]
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in codes])]).astype(np.int64)
    flat = np.concatenate(codes) if codes else np.zeros(0, np.int8)
    return flat, offsets, rng.integers(0, 3, size=len(seqs)).astype(np.int32)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", ["plain", "reverse_segmented", "ambig_reverse",
                                  "small_budget"])
def test_chunks_from_packed_equal_bear_tpu(case, native):
    rng = np.random.default_rng(["plain", "reverse_segmented", "ambig_reverse",
                                 "small_budget"].index(case))
    flat, offsets, groups = _packed_reads(rng, 0.03 if case == "ambig_reverse" else 0.0)
    kw = dict(batch_size=64, reverse=case != "plain")
    if case == "reverse_segmented":
        kw["segment_len"] = 100
    if case == "ambig_reverse":
        kw["ambig_code"] = 4
    if case == "small_budget":
        kw["max_chunk_elems"] = 2000
    got = list(engine.chunks_from_packed(flat, offsets, groups, 6, native=native, **kw))
    want = list(jengine.chunks_from_packed(flat, offsets, groups, 6, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for field in ("codes", "lengths", "skip", "stopped", "groups"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert (g.fresh is None) == (w.fresh is None)
        if g.fresh is not None:
            np.testing.assert_array_equal(g.fresh, w.fresh)


@pytest.mark.parametrize("reverse", [False, True])
def test_checkpoint_resume_writes_the_uninterrupted_bytes(tmp_path, monkeypatch, reverse):
    # Killed on the second file (of the reverse pass with -r), then rerun.
    # bear_tpu's own rerun of a -r pass refuses its checkpoint (ROADMAP,
    # Queue 3), so this run is held against the port's uninterrupted one.
    csv, args = _inputs(tmp_path, "fasta_gzip_three_groups")
    args += ["-r"] if reverse else []
    parser = summarize.build_parser()
    whole = tmp_path / "whole"
    whole.mkdir()
    summarize.main(parser.parse_args([csv, str(whole / "run"), *args, "--device", "cpu"]))

    resumed = tmp_path / "resumed"
    resumed.mkdir()
    argv = [csv, str(resumed / "run"), *args, "--device", "cpu", "--checkpoint",
            str(tmp_path / "ckpt")]
    real = summarize.iter_chunks
    calls = []

    class Killed(Exception):
        pass

    def dies_on_the_second_file(ents, *a, **kw):
        calls.append(ents[0][0])
        if len(calls) == (6 if reverse else 2):  # one call per file, 4 files a pass
            raise Killed
        return real(ents, *a, **kw)

    monkeypatch.setattr(summarize, "iter_chunks", dies_on_the_second_file)
    with pytest.raises(Killed):
        summarize.main(parser.parse_args(argv))
    ckpt = tmp_path / ("ckpt_rev.npz" if reverse else "ckpt.npz")
    assert ckpt.exists() and not any("_rev_" in f for f in _outputs(resumed))
    monkeypatch.setattr(summarize, "iter_chunks", real)
    report = {}
    summarize.main(parser.parse_args(argv), report)
    assert report["reverse" if reverse else "forward"]["stats"]["partial"]
    _same_files(whole, resumed)


def test_count_state_files_cross_packages(tmp_path):
    rng = np.random.default_rng(5)
    reads = [(rng.integers(0, 4, size=int(rng.integers(1, 50))).astype(np.int8), i % 2)
             for i in range(80)]
    port = engine.TransitionCounter([2, 4], n_groups=2, device="cpu")
    ref = jengine.TransitionCounter([2, 4], n_groups=2, method="scatter")
    for chunk in engine.chunk_reads(iter(reads), 4, batch_size=32):
        port.add_chunk(chunk)
        ref.add_chunk(chunk)
    port.save_state(str(tmp_path / "port"))
    ref.save_state(str(tmp_path / "jax"))
    from_port = jengine.TransitionCounter.load_state(str(tmp_path / "port"))
    from_jax = engine.TransitionCounter.load_state(str(tmp_path / "jax"), device="cpu")
    for l in (2, 4):
        np.testing.assert_array_equal(from_port.tables[l], ref.tables[l])
        np.testing.assert_array_equal(from_jax.tables[l], port.tables[l])
    assert (from_jax.lags, from_jax.n_groups, from_jax.alphabet) == ((2, 4), 2, "dna")
    # A loaded counter counts on: the same reads again double every count.
    for chunk in engine.chunk_reads(iter(reads), 4, batch_size=32):
        from_jax.add_chunk(chunk)
    np.testing.assert_array_equal(from_jax.tables[4], 2 * port.tables[4])


def test_not_ported_options_raise(tmp_path):
    # The options once refused run now: --kmer-shards and --data-shards on a
    # mesh of the CPU write bear_tpu's bytes (its 8 virtual devices). What
    # bear_tpu refuses, the port refuses: more cards than exist, and
    # --data-shards in the dense range. Row-range passes and the
    # sparse-first lags (DNA >= 16, protein >= 8) run and conserve counts.
    csv, _ = _inputs(tmp_path, "fastq")
    parser = summarize.build_parser()
    for extra, counter in ((["--kmer-shards", "2", "-r"], "KmerShardedTransitionCounter"),
                           (["-l", "16", "--data-shards", "2"], "SparseTransitionCounter")):
        work = tmp_path / extra[1]
        work.mkdir()
        _, report = _run_both(work, csv, ["-l", "3", *extra])
        assert type(report["forward"]["counter"]).__name__ == counter
        assert report["forward"]["counter"].n_dev == 2
    for extra, device, match in ((["--data-shards", "2"], "cpu", "kmer-shards"),
                                 (["--kmer-shards", "3"], "cuda",
                                  "--kmer-shards 3 needs that many devices; have")):
        if device == "cuda" and torch.cuda.device_count() >= 3:
            continue
        args = parser.parse_args([csv, str(tmp_path / "x"), "-l", "3", *extra,
                                  "--device", device])
        with pytest.raises(ValueError, match=match):
            summarize.main(args)
    for extra, counter in ((["--passes", "2"], "MultiPassTransitionCounter"),
                           (["-l", "16"], "SparseTransitionCounter"),
                           (["-l", "8", "--alphabet", "prot"], "SparseTransitionCounter")):
        out = tmp_path / "_".join(extra).strip("-")
        out.mkdir()
        report = {}
        summarize.main(parser.parse_args([csv, str(out / "run"), "-l", "3", *extra,
                                          "--device", "cpu"]), report)
        assert type(report["forward"]["counter"]).__name__ == counter
        lag = max(report["forward"]["rows"])
        assert os.path.exists(out / f"run_lag_{lag}_file_0.tsv")
    assert "ignored" in parser.format_help()


def test_gzip_through_python_writes_the_same_bytes(tmp_path, monkeypatch):
    # Where the library does not link zlib, gzip files go through Python's
    # gzip and the NumPy encoder: the shards must not change.
    csv, args = _inputs(tmp_path, "fasta_gzip_three_groups")
    _run_both(tmp_path, csv, args)
    lib = native.load()
    monkeypatch.setattr(lib, "supports_gzip", False)
    out = tmp_path / "no_zlib"
    out.mkdir()
    report = {}
    summarize.main(summarize.build_parser().parse_args(
        [csv, str(out / "run"), *args, "--device", "cpu"]), report)
    parsers = report["forward"]["stats"]["parser"]
    assert sorted(parsers.values()) == ["native", "native", "python", "python"]
    assert all(p.endswith(".gz") == (v == "python") for p, v in parsers.items())
    _same_files(tmp_path / "jax", out)
