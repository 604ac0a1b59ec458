"""The port's lag selection (bear_tpu_torch.models.lag_selection and
lag_select_cli) against bear_tpu's, on the CPU in float64: the marginal of
count rows, the sweep over a counter's tables (resident and flushed), the
sweep over summarize's TSV shards, and the CLI's JSON in both routes.
Tolerance rtol 1e-12 (torch.lgamma against scipy's gammaln, float64 sums
in another order) and the same best lag.
"""

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting.multipass import count_multipass as jcount_multipass
from bear_tpu.counting.sparse import SparseTransitionCounter as JSparse
from bear_tpu.models import lag_select_cli as jcli
from bear_tpu.models import lag_selection as jls
from bear_tpu_torch.counting import engine, fastx, summarize
from bear_tpu_torch.counting.multipass import count_multipass
from bear_tpu_torch.counting.sparse import SparseTransitionCounter
from bear_tpu_torch.data import load_dense, load_dense_counts
from bear_tpu_torch.models import lag_select_cli, lag_selection

torch.set_num_threads(2)
TOL = dict(rtol=1e-12)


def _reads(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "structured":  # deterministic at lag 3 (tests/test_lag_selection.py)
        return ["AACAAG" * 30] * 8
    if kind == "iid":
        return ["".join(rng.choice(list("ACGT"), 400)) for _ in range(6)]
    # a repeated template with substitutions: long-range structure
    template = rng.integers(0, 4, 300)
    out = []
    for _ in range(40):
        s = np.roll(template, int(rng.integers(300))).copy()
        mut = rng.random(300) < 0.02
        s[mut] = (s[mut] + 1) % 4
        out.append("".join("ACGT"[c] for c in s))
    return out


def _counters(seqs, lags, groups=1):
    jtc = JCounter(lags=lags, n_groups=groups)
    enc = [(jfastx.encode_seq(s), i % groups) for i, s in enumerate(seqs)]
    for chunk in jchunk_reads(iter(enc), max(lags), batch_size=64):
        jtc.add_chunk(chunk)
    tc = engine.TransitionCounter(lags=lags, n_groups=groups, device="cpu")
    enc = [(fastx.encode_seq(s), i % groups) for i, s in enumerate(seqs)]
    for chunk in engine.chunk_reads(iter(enc), max(lags), batch_size=64):
        tc.add_chunk(chunk)
    return jtc, tc


def test_marginal_from_counts_matches_bear_tpu():
    rng = np.random.default_rng(1)
    counts = rng.poisson(rng.gamma(0.5, 20.0, (300, 1)), (300, 5)).astype(np.int64)
    counts[:7] = 0
    for alphas in ([0.01, 0.1, 1.0], [0.5], [1e-3, 3.0, 30.0]):
        want = jls.marginal_from_counts(counts, alphas)
        got = lag_selection.marginal_from_counts(counts, alphas, device="cpu")
        assert got.shape == (len(alphas),) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            lag_selection.marginal_from_counts(torch.from_numpy(counts), alphas), want, **TOL)
    np.testing.assert_array_equal(
        lag_selection.marginal_from_counts(counts[:7], [0.1], device="cpu"), [0.0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lag_selection.marginal_from_counts(counts, [0.1])


@pytest.mark.parametrize("kind,lags,groups", [("structured", [1, 2, 3, 4], 1),
                                               ("iid", [1, 3, 5], 1),
                                               ("template", [2, 4, 6, 8], 2)])
def test_select_lag_matches_bear_tpu(kind, lags, groups):
    jtc, tc = _counters(_reads(kind), lags, groups)
    for group in range(groups):
        want = jls.select_lag(jtc, group=group)
        got = lag_selection.select_lag(tc, group=group)
        assert got.lags == want.lags == tuple(lags)
        np.testing.assert_allclose(got.log_marginals, want.log_marginals, **TOL)
        np.testing.assert_array_equal(got.alphas, want.alphas)
        assert got.best == want.best
        assert got.best_alpha(got.best) == want.best_alpha(want.best)
        # blocks of rows, and the host tables once a flush has moved the counts
        small = lag_selection.select_lag(tc, group=group, batch_size=7)
        np.testing.assert_allclose(small.log_marginals, want.log_marginals, **TOL)
    if kind == "structured":
        assert got.best == 3
    tc.flush()
    assert not tc._resident()
    flushed = lag_selection.select_lag(tc, group=groups - 1, alphas=(0.3, 2.0))
    np.testing.assert_allclose(flushed.log_marginals,
                               jls.select_lag(jtc, group=groups - 1,
                                              alphas=(0.3, 2.0)).log_marginals, **TOL)


def test_table_is_the_resident_device_table_until_a_flush():
    _, tc = _counters(_reads("iid"), [2, 3])
    resident = tc.table(3)
    assert resident.dtype == torch.int32 and resident.data_ptr() == tc._device_table(3).data_ptr()
    before = resident.clone()
    np.testing.assert_array_equal(before.numpy(), tc.tables[3])  # tables flushes
    host = tc.table(3)
    assert host.dtype == torch.int64 and host.data_ptr() != resident.data_ptr()
    np.testing.assert_array_equal(host.numpy(), tc.tables[3])


def _write_inputs(tmp_path, seqs, name="in"):
    fa = tmp_path / f"{name}.fasta"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    csv = tmp_path / f"{name}.csv"
    csv.write_text(f"{fa},0,fa\n")
    return str(csv)


def _json(main, parser, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = main(parser().parse_args(argv))
    payload = json.loads(buf.getvalue())
    assert best == payload["best_lag"]
    return payload


def test_tsv_route_and_cli_match_bear_tpu(tmp_path):
    seqs = _reads("template", seed=3)
    csv = _write_inputs(tmp_path, seqs)
    prefix = str(tmp_path / "counts" / "run")
    os.makedirs(os.path.dirname(prefix))
    summarize.main(summarize.build_parser().parse_args(
        [csv, prefix, "-l", "7", "-mf", "0.00001", "--device", "cpu"]))
    assert len([f for f in os.listdir(tmp_path / "counts") if "_lag_7_" in f]) > 1
    want = jls.select_lag_from_tsvs(prefix, range(1, 8))
    got = lag_selection.select_lag_from_tsvs(prefix, range(1, 8), device="cpu")
    np.testing.assert_allclose(got.log_marginals, want.log_marginals, **TOL)
    assert got.best == want.best
    small = lag_selection.select_lag_from_tsvs(prefix, range(1, 8), batch_size=5,
                                               device="cpu")
    np.testing.assert_allclose(small.log_marginals, want.log_marginals, **TOL)
    # both CLI routes, against bear_tpu's CLI and each other
    for argv in ([prefix, "--counts", "-l", "7", "--json"],
                 [csv, "-l", "7", "--json"],
                 [csv, "-l", "5", "--min-lag", "2", "-r", "--alphas", "0.2", "5", "--json"]):
        jout = _json(jcli.main, jcli.build_parser, argv)
        pout = _json(lag_select_cli.main, lag_select_cli.build_parser, argv + ["--device", "cpu"])
        assert pout["best_lag"] == jout["best_lag"] and pout["lags"] == jout["lags"]
        assert pout["best_alpha"] == jout["best_alpha"] and pout["alphas"] == jout["alphas"]
        np.testing.assert_allclose(pout["log_marginals"], jout["log_marginals"], **TOL)
    counted = _json(lag_select_cli.main, lag_select_cli.build_parser,
                    [csv, "-l", "7", "--json", "--device", "cpu"])
    np.testing.assert_allclose(counted["log_marginals"], got.log_marginals, **TOL)
    # the table form
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lag_select_cli.main(lag_select_cli.build_parser().parse_args(
            [prefix, "--counts", "-l", "7", "--device", "cpu"]))
    assert f"best lag: {got.best}" in buf.getvalue() and "<- best" in buf.getvalue()


def test_cli_counting_route_honors_ambig(tmp_path):
    csv = _write_inputs(tmp_path, ["AACNAAG" * 20] * 6)
    for extra in ([], ["--ambig", "skip"]):
        argv = [csv, "-l", "2", "--json"] + extra
        jout = _json(jcli.main, jcli.build_parser, argv)
        pout = _json(lag_select_cli.main, lag_select_cli.build_parser, argv + ["--device", "cpu"])
        np.testing.assert_allclose(pout["log_marginals"], jout["log_marginals"], **TOL)


def test_refusals(tmp_path):
    # --kmer-shards runs on a mesh of the CPU and gives bear_tpu's JSON
    # (tests/test_lag_selection.py:197); more cards than exist, and
    # --kmer-shards with --passes, are refused as bear_tpu refuses them.
    # --passes: test_sparse_routes_match_bear_tpu.
    csv = _write_inputs(tmp_path, ["ACGTACGGT" * 5])
    argv = [csv, "-l", "3", "--json", "--kmer-shards", "2"]
    jout = _json(jcli.main, jcli.build_parser, argv)
    pout = _json(lag_select_cli.main, lag_select_cli.build_parser, argv + ["--device", "cpu"])
    base = _json(lag_select_cli.main, lag_select_cli.build_parser, argv[:4] + ["--device", "cpu"])
    assert pout["best_lag"] == jout["best_lag"] == base["best_lag"]
    assert pout["lags"] == jout["lags"] and pout["best_alpha"] == jout["best_alpha"]
    np.testing.assert_allclose(pout["log_marginals"], jout["log_marginals"], **TOL)
    np.testing.assert_allclose(pout["log_marginals"], base["log_marginals"], **TOL)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--kmer-shards 2 needs that many devices"):
            lag_select_cli.main(lag_select_cli.build_parser().parse_args(
                [csv, "-l", "3", "--kmer-shards", "2"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        lag_select_cli.main(lag_select_cli.build_parser().parse_args(
            [csv, "-l", "3", "--device", "cpu", "--kmer-shards", "2", "--passes", "2"]))
    with pytest.raises(FileNotFoundError):
        lag_selection.select_lag_from_tsvs(str(tmp_path / "none"), [2], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lag_select_cli.main(lag_select_cli.build_parser().parse_args([csv, "-l", "3"]))


def test_tsv_route_sniffs_the_groups_past_an_empty_shard(tmp_path):
    # Lag 1 has 5 rows over 8 shards: the first shard is empty, and the
    # dataset columns are read from the first shard that has a row.
    # (bear_tpu's select_lag_from_tsvs sniffs only the first file, takes 1
    # column from it and fails on group 1; given num_ds it agrees.)
    rng = np.random.default_rng(0)
    rows = []
    for group in (0, 1):
        fa = tmp_path / f"g{group}.fasta"
        fa.write_text("".join(f">s{i}\n{''.join(rng.choice(list('ACGT'), 300))}\n"
                              for i in range(20)))
        rows.append(f"{fa},{group},fa\n")
    (tmp_path / "in.csv").write_text("".join(rows))
    prefix = str(tmp_path / "run")
    summarize.main(summarize.build_parser().parse_args(
        [str(tmp_path / "in.csv"), prefix, "-l", "3", "-mf", "0.0000001", "--device", "cpu"]))
    assert os.path.getsize(f"{prefix}_lag_1_file_0.tsv") == 0
    for f in sorted(glob.glob(f"{prefix}_lag_*_file_*.tsv"))[:6]:
        want = load_dense(f, "dna", 2).counts
        np.testing.assert_array_equal(load_dense_counts(f, "dna", 2), want)
    ragged = tmp_path / "ragged.tsv"  # contexts of two widths: the NumPy parse
    ragged.write_text("AC\t[[1,2,3,4,5],[0,0,1,0,0]]\nA\t[[0,1,0,0,0],[2,0,0,0,1]]\n")
    np.testing.assert_array_equal(load_dense_counts(str(ragged), "dna", 2),
                                  load_dense(str(ragged), "dna", 2).counts)
    counter = summarize.run_counting(str(tmp_path / "in.csv"), range(1, 4), device="cpu")
    for group in (0, 1):
        got = lag_selection.select_lag_from_tsvs(prefix, range(1, 4), group=group,
                                                 device="cpu")
        np.testing.assert_allclose(got.log_marginals,
                                   lag_selection.select_lag(counter, group=group).log_marginals,
                                   **TOL)
        want = jls.select_lag_from_tsvs(prefix, range(1, 4), group=group, num_ds=2)
        np.testing.assert_allclose(got.log_marginals, want.log_marginals, **TOL)
    with pytest.raises((ValueError, IndexError)):
        jls.select_lag_from_tsvs(prefix, range(1, 4), group=1)


def test_sparse_routes_match_bear_tpu(tmp_path):
    # select_lag_sparse over the sparse-first counter (lags 1..17) and over
    # a multi-pass count, against bear_tpu's at rtol 1e-12; select_lag
    # routes both counters there; the CLI's --passes JSON equals its
    # single-pass JSON.
    seqs = _reads("template", seed=4)[:12]
    lags = [1, 2, 4, 8, 16, 17]
    port = SparseTransitionCounter(lags, n_groups=2, device="cpu")
    ref = JSparse(lags, n_groups=2)
    enc = [(fastx.encode_seq(s), i % 2) for i, s in enumerate(seqs)]
    for chunk in engine.chunk_reads(iter(enc), 17, batch_size=8):
        port.add_chunk(chunk)
    jenc = [(jfastx.encode_seq(s), i % 2) for i, s in enumerate(seqs)]
    for chunk in jchunk_reads(iter(jenc), 17, batch_size=8):
        ref.add_chunk(chunk)
    for group in (0, 1):
        want = jls.select_lag_sparse(ref, group=group)
        for got in (lag_selection.select_lag_sparse(port, group=group, batch_size=50),
                    lag_selection.select_lag(port, group=group)):
            assert got.lags == want.lags == tuple(lags)
            np.testing.assert_allclose(got.log_marginals, want.log_marginals, **TOL)
            assert got.best == want.best
    # a multi-pass count sweeps like the dense counter of the same reads
    jtc, tc = _counters(seqs, [2, 5, 7], groups=2)

    def factory():
        return engine.chunk_reads(iter(enc), 7, batch_size=8)

    def jfactory():
        return jchunk_reads(iter(jenc), 7, batch_size=8)

    mp = count_multipass(factory, [2, 5, 7], n_groups=2, passes=3, device="cpu")
    jmp = jcount_multipass(jfactory, [2, 5, 7], n_groups=2, passes=3, method="scatter")
    want = jls.select_lag_sparse(jmp, group=1)
    for got in (lag_selection.select_lag(mp, group=1), lag_selection.select_lag(tc, group=1)):
        np.testing.assert_allclose(got.log_marginals, want.log_marginals, **TOL)
    csv = _write_inputs(tmp_path, seqs)
    one = _json(lag_select_cli.main, lag_select_cli.build_parser,
                [csv, "-l", "6", "--json", "--device", "cpu"])
    for argv in ([csv, "-l", "6", "--json", "--passes", "3"],
                 [csv, "-l", "6", "--json", "--passes", "2", "-r"]):
        jout = _json(jcli.main, jcli.build_parser, argv)
        pout = _json(lag_select_cli.main, lag_select_cli.build_parser,
                     argv + ["--device", "cpu"])
        assert pout["best_lag"] == jout["best_lag"] and pout["lags"] == jout["lags"]
        np.testing.assert_allclose(pout["log_marginals"], jout["log_marginals"], **TOL)
        if "-r" not in argv:
            assert pout == one
