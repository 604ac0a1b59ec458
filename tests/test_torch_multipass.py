"""The port's row-range counting (bear_tpu_torch.counting.multipass, the
single-card core of bear_tpu_torch.parallel.counting and count_chunk's
row-range form) against bear_tpu's, on the CPU: the same reads, made with
numpy from a seed, give exactly the same int64 counts pass by pass and in
all, the same state and TSV files byte for byte, and the same refusals.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting import summarize as jsummarize
from bear_tpu.counting.engine import _count_chunk_kernel, split_ambiguous as jsplit
from bear_tpu.counting.multipass import MultiPassTransitionCounter as JMultiPass
from bear_tpu.counting.multipass import count_multipass as jcount_multipass
from bear_tpu_torch.counting import count_chunk as cc
from bear_tpu_torch.counting import engine, fastx, summarize
from bear_tpu_torch.counting.multipass import (
    MultiPassTransitionCounter,
    count_multipass,
    min_passes,
)
from bear_tpu_torch.parallel import KmerShardedTransitionCounter, Mesh

torch.set_num_threads(2)


def _seqs(rng, n, lo=12, hi=40, letters="ACGT"):
    return ["".join(rng.choice(list(letters), int(rng.integers(lo, hi)))) for _ in range(n)]


def _factories(seqs, groups, max_lag, batch_size=4, ambig=False, reverse=False):
    """(bear_tpu's, the port's) chunk factories over the same reads."""
    def jf():
        enc = ((jfastx.encode_seq(s, ambig=ambig), g) for s, g in zip(seqs, groups))
        return jchunk_reads(jsplit(enc) if ambig else enc, max_lag, batch_size=batch_size,
                            reverse=reverse)

    def pf():
        enc = ((fastx.encode_seq(s, ambig=ambig), g) for s, g in zip(seqs, groups))
        return engine.chunk_reads(engine.split_ambiguous(enc) if ambig else enc, max_lag,
                                  batch_size=batch_size, reverse=reverse)

    return jf, pf


def _assert_same_counts(port, ref, lags):
    for l in lags:
        kp, vp = port._consolidated(l)
        kr, vr = ref._consolidated(l)
        np.testing.assert_array_equal(kp, kr, err_msg=f"lag {l} keys")
        np.testing.assert_array_equal(vp, vr, err_msg=f"lag {l} counts")


@pytest.mark.parametrize("passes", [1, 2, 3, 7])
def test_multipass_equals_bear_tpu_and_the_dense_counter(passes):
    rng = np.random.default_rng(31)
    seqs = _seqs(rng, 14)
    groups = [int(g) for g in rng.integers(0, 2, len(seqs))]
    lags = range(1, 6)
    jf, pf = _factories(seqs, groups, 5)
    mp = count_multipass(pf, lags, n_groups=2, passes=passes, device="cpu")
    _assert_same_counts(mp, jcount_multipass(jf, lags, n_groups=2, passes=passes,
                                             method="scatter"), lags)
    dense = engine.TransitionCounter(lags, n_groups=2, device="cpu")
    for chunk in pf():
        dense.add_chunk(chunk)
    for l in lags:
        rows = dense.nonzero_rows(l)
        np.testing.assert_array_equal(mp.nonzero_rows(l), rows)
        np.testing.assert_array_equal(mp.counts_for_rows(l, rows), dense.row_counts(l, rows))
        np.testing.assert_array_equal(mp.tables[l], dense.tables[l])
    n = sum(len(s) + 1 for s in seqs)
    assert mp.validate(expected_transitions=n) == {l: n for l in lags}
    with pytest.raises(AssertionError, match="conservation"):
        mp.validate(expected_transitions=n + 1)


def test_multipass_ambig_and_reverse_chunks_equal_bear_tpu():
    rng = np.random.default_rng(32)
    seqs = ["ACGTNAC", "NACGT", "CCGTN"] + _seqs(rng, 6, letters="ACGTN")
    jf, pf = _factories(seqs, [0] * len(seqs), 3, batch_size=3, ambig=True, reverse=True)
    mp = count_multipass(pf, range(1, 4), passes=3, device="cpu")
    _assert_same_counts(mp, jcount_multipass(jf, range(1, 4), passes=3, method="scatter"),
                        range(1, 4))
    # The counts of one pass alone: only its rows, each once.
    one = MultiPassTransitionCounter(range(1, 4), passes=3, device="cpu")
    one.begin_pass(1)
    for chunk in pf():
        one.add_chunk(chunk)
    for l in range(1, 4):
        stride = one._per_lag[l][0]
        rows = one.nonzero_rows(l)
        assert ((rows >= stride) & (rows < 2 * stride)).all()
        np.testing.assert_array_equal(one.counts_for_rows(l, rows), mp.counts_for_rows(l, rows))


@pytest.mark.parametrize("passes", [1, 3, 5])
def test_row_range_chunk_keys_equal_bear_tpu_pass_by_pass(passes):
    # count_chunk's plain row-range form against bear_tpu's
    # _count_chunk_kernel(shard=) with method="scatter", on chunks with
    # ambiguous pieces (fresh flags), reverse complements, stops and two
    # groups.
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + passes)
    seqs = _seqs(rng, 20, lo=0, hi=50, letters="ACGTN")
    groups = [i % 2 for i in range(len(seqs))]
    lags = (1, 3, 4, 6)
    jf, pf = _factories(seqs, groups, 6, batch_size=8, ambig=True)
    mp = MultiPassTransitionCounter(lags, n_groups=2, passes=passes, device="cpu")
    jmp = JMultiPass(lags, n_groups=2, passes=passes, method="scatter")
    assert mp._per_lag == jmp._per_lag and mp._local_padded == jmp._local_padded
    for d in range(passes):
        port = torch.zeros(mp.table_size, dtype=torch.int32)
        ref = jnp.zeros(jmp._local_padded, jnp.int32)
        for pc, jc in zip(pf(), jf()):
            for codes, *rows in engine.chunk_passes(pc, reverse=True):
                meta = torch.from_numpy(cc.pack_meta(*rows))
                cc.count_chunk_update(port, torch.from_numpy(codes), meta, lags, 2, 4,
                                      shard=(d, mp._per_lag))
            for codes, lengths, skip, stopped, grp, fresh in engine.chunk_passes(jc, True):
                ref = _count_chunk_kernel(
                    ref, jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(skip),
                    jnp.asarray(stopped), jnp.asarray(grp), lags, 2, "scatter",
                    shard=(jnp.int32(d), mp._per_lag), A=4,
                    fresh=None if fresh is None else jnp.asarray(fresh))
        ref = np.asarray(ref)
        np.testing.assert_array_equal(port.numpy(), ref[: mp.table_size])
        assert not ref[mp.table_size:].any()


def test_row_range_checks():
    lags = (2, 3)
    per_lag = MultiPassTransitionCounter(lags, passes=2, device="cpu")._per_lag
    size = cc.shard_size(per_lag, 1, 4)
    codes = torch.zeros((2, 5), dtype=torch.int8)
    meta = torch.from_numpy(cc.pack_meta(np.full(2, 5), np.zeros(2), np.ones(2, bool),
                                         np.zeros(2)))
    with pytest.raises(ValueError, match="need"):
        cc.count_chunk_update(torch.zeros(size + 1, dtype=torch.int32), codes, meta, lags, 1,
                              4, shard=(0, per_lag))
    with pytest.raises(ValueError, match="cover lags"):
        cc.count_chunk_update(torch.zeros(size, dtype=torch.int32), codes, meta, (2,), 1, 4,
                              shard=(0, per_lag))
    with pytest.raises(ValueError, match="do not fit"):
        cc.count_chunk_update(torch.zeros(size, dtype=torch.int32), codes, meta, lags, 1, 4,
                              shard=(-1, per_lag))
    lt = cc.lag_table(lags, 1, 4, tuple(sorted(per_lag.items())))
    for k, l in enumerate(lags):
        assert (lt.lag[k].stride, lt.lag[k].local_rows, lt.lag[k].offset) == per_lag[l]
        assert lt.lag[k].rows == cc.table_rows(l)
    dense = cc.lag_table(lags, 1, 4)
    assert [(dense.lag[k].stride, dense.lag[k].local_rows) for k in range(2)] == \
        [(cc.table_rows(l), cc.table_rows(l)) for l in lags]


def test_multipass_guards_refuse_what_bear_tpu_refuses():
    for kw in (dict(lags=[16], passes=64), dict(lags=[3], passes=0)):
        with pytest.raises(ValueError) as want:
            JMultiPass(**kw)
        with pytest.raises(ValueError) as got:
            MultiPassTransitionCounter(**kw, device="cpu")
        assert str(got.value).split(" —")[0] == str(want.value).split(" —")[0]
    with pytest.raises(ValueError, match="pass_idx"):
        MultiPassTransitionCounter(lags=[3], passes=2, device="cpu").begin_pass(2)
    # The padded int32 guard: lags 1..15 over 2 groups need 9 passes, one
    # group 5, lags 1..14 over 2 groups 3 — in both packages.
    for lags, groups, fewest in ((range(1, 16), 2, 9), (range(1, 16), 1, 5),
                                 (range(1, 15), 2, 3), ([15], 1, 4)):
        assert min_passes(lags, groups) == fewest
        for passes in (fewest - 1, fewest):
            ok = passes == fewest
            for cls, kw in ((JMultiPass, {}), (MultiPassTransitionCounter, {"device": "cpu"})):
                if ok:
                    cls(lags, n_groups=groups, passes=passes, **kw)
                else:
                    with pytest.raises(ValueError, match="use more passes"):
                        cls(lags, n_groups=groups, passes=passes, **kw)


def test_state_files_tsvs_and_merge_equal_bear_tpu(tmp_path):
    from bear_tpu.counting.multipass import MultiPassTransitionCounter as J

    rng = np.random.default_rng(34)
    seqs = _seqs(rng, 10)
    jf, pf = _factories(seqs, [0] * 10, 4)
    mp = count_multipass(pf, [2, 4], passes=2, device="cpu")
    ref = jcount_multipass(jf, [2, 4], passes=2, method="scatter")
    mp.save_state(str(tmp_path / "port"))
    ref.save_state(str(tmp_path / "jax"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    from_jax = MultiPassTransitionCounter([2, 4], passes=2, device="cpu")
    from_jax.load_state(str(tmp_path / "jax.npz"))
    from_port = J([2, 4], passes=2)
    from_port.load_state(str(tmp_path / "port.npz"))
    _assert_same_counts(from_jax, from_port, [2, 4])
    with pytest.raises(ValueError, match="do not match"):
        MultiPassTransitionCounter([2], passes=2, device="cpu").load_state(
            str(tmp_path / "jax.npz"))
    for lag in (2, 4):
        mp.export_tsv(str(tmp_path / "p"), lag, n_bin_bits=1, shuffle=True)
        ref.export_tsv(str(tmp_path / "j"), lag, n_bin_bits=1, shuffle=True)
        for b in range(2):
            assert filecmp.cmp(tmp_path / f"p_lag_{lag}_file_{b}.tsv",
                               tmp_path / f"j_lag_{lag}_file_{b}.tsv", shallow=False)
        ds, jds = mp.to_dataset(lag), ref.to_dataset(lag)
        np.testing.assert_array_equal(ds.kmers, jds.kmers)
        np.testing.assert_array_equal(ds.codes, jds.codes)
        np.testing.assert_array_equal(ds.counts, jds.counts)
    # merge_from: the loaded copy plus the counter doubles every count
    from_jax.merge_from(mp)
    ref.merge_from(from_port)
    _assert_same_counts(from_jax, ref, [2, 4])
    # counts_for_rows answers repeated and absent rows
    rows = mp.nonzero_rows(4)[:3]
    query = np.array([rows[1], 5, rows[1], rows[0]])
    np.testing.assert_array_equal(mp.counts_for_rows(4, query), ref.counts_for_rows(4, query) // 2)


def test_kmer_sharded_counter_on_one_card_equals_the_dense_counter():
    rng = np.random.default_rng(35)
    seqs = _seqs(rng, 8)
    _, pf = _factories(seqs, [i % 2 for i in range(8)], 3)
    ks = KmerShardedTransitionCounter([1, 3], n_groups=2, device="cpu")
    dense = engine.TransitionCounter([1, 3], n_groups=2, device="cpu")
    for chunk in pf():
        ks.add_chunk(chunk)
        dense.add_chunk(chunk)
    for l in (1, 3):
        np.testing.assert_array_equal(ks.tables[l], dense.tables[l])
    # Two row ranges need two devices: a mesh (the one CPU named twice)
    # gives bear_tpu's two-device split and the dense counter's counts.
    with pytest.raises(ValueError, match="pass mesh="):
        KmerShardedTransitionCounter([3], n_shards=2, device="cpu")
    two = KmerShardedTransitionCounter([1, 3], n_groups=2, n_shards=2,
                                       mesh=Mesh(["cpu", "cpu"], ("kmer",)))
    for chunk in pf():
        two.add_chunk(chunk)
    for l in (1, 3):
        np.testing.assert_array_equal(two.tables[l], dense.tables[l])
    with pytest.raises(ValueError, match="int32"):
        KmerShardedTransitionCounter(range(1, 16), n_groups=2, device="cpu")
    with pytest.raises(ValueError, match="counting method"):
        KmerShardedTransitionCounter([3], method="dense", device="cpu")


def _reads_csv(tmp_path, n=24, length=35, seed=36):
    rng = np.random.default_rng(seed)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{''.join(rng.choice(list('ACGT'), length))}\n"
                          for i in range(n)))
    fq = tmp_path / "more.fq"
    seqs = _seqs(rng, 10, 0, 60)
    fq.write_text("".join(f"@q{i}\n{s}\n+\n{'F' * len(s)}\n" for i, s in enumerate(seqs)))
    csv = tmp_path / "in.csv"
    csv.write_text(f"{fa},0,fa\n{fq},1,fq\n")
    return str(csv)


def _same_tsvs(a, b):
    names = sorted(f for f in os.listdir(a) if f.endswith(".tsv"))
    assert names and names == sorted(f for f in os.listdir(b) if f.endswith(".tsv"))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []
    return names


def test_summarize_passes_writes_bear_tpus_bytes(tmp_path):
    csv = _reads_csv(tmp_path)
    for d in ("jax", "port", "one"):
        (tmp_path / d).mkdir()
    argv = [csv, "-l", "4", "--passes", "3", "-r"]
    jsummarize.main(jsummarize.build_parser().parse_args(
        [argv[0], str(tmp_path / "jax" / "run"), *argv[1:]]))
    report = {}
    summarize.main(summarize.build_parser().parse_args(
        [argv[0], str(tmp_path / "port" / "run"), *argv[1:], "--device", "cpu"]), report)
    names = _same_tsvs(tmp_path / "jax", tmp_path / "port")
    assert any("_rev_lag_4_" in n for n in names)
    summarize.main(summarize.build_parser().parse_args(
        [csv, str(tmp_path / "one" / "run"), "-l", "4", "-r", "--device", "cpu"]))
    _same_tsvs(tmp_path / "one", tmp_path / "port")
    # stats cover one traversal of the input, though three passes read it
    stats = report["forward"]["stats"]
    one = {}
    summarize.run_counting(csv, range(1, 5), stats=one, device="cpu")
    assert (stats["reads"], stats["bases"], stats["chunks"]) == (
        one["reads"], one["bases"], one["chunks"])
    assert report["forward"]["table_bytes"] == 4 * MultiPassTransitionCounter(
        range(1, 5), n_groups=2, passes=3, device="cpu").table_size


def test_run_counting_passes_refusals(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGT\n")
    csv = tmp_path / "in.csv"
    csv.write_text(f"{fa},0,fa\n")
    for kw, err, match in ((dict(passes=2, kmer_shards=2), ValueError, "mutually exclusive"),
                           (dict(passes=2, checkpoint=str(tmp_path / "c")), ValueError,
                            "checkpoint"),
                           (dict(passes=2, data_shards=2), ValueError, "mutually exclusive"),
                           (dict(kmer_shards=2, device="cuda"), ValueError,
                            "--kmer-shards 2 needs that many devices; have")):
        if "device" in kw and torch.cuda.device_count() >= 2:
            continue  # the refusal is of more cards than exist
        with pytest.raises(err, match=match):
            summarize.run_counting(str(csv), lags=[2], **{"device": "cpu", **kw})
    # --kmer-shards itself runs: bear_tpu's tests/test_multipass.py:168
    # refusals above, and its row-split counts here.
    port = summarize.run_counting(str(csv), lags=[1, 2], kmer_shards=2, device="cpu")
    ref = jsummarize.run_counting(str(csv), lags=[1, 2], kmer_shards=2)
    assert isinstance(port, KmerShardedTransitionCounter) and port.n_dev == 2
    _assert_same_counts(port, ref, [1, 2])


@pytest.mark.slow
def test_multipass_lag15_row_codes_int32_edge():
    # tests/test_multipass.py:174: the all-T lag-15 context sits at the
    # table's last row, 1,431,655,764, and the '['-padded rows in pass 0.
    lag, P, rlen = 15, 16, 40
    chunk = engine.ReadChunk(np.full((2, rlen), 3, np.int8), np.full(2, rlen, np.int32),
                             np.zeros(2, np.int32), np.ones(2, bool), np.zeros(2, np.int32))
    mp = MultiPassTransitionCounter([lag], passes=P, device="cpu")
    for p in (0, P - 1):
        mp.begin_pass(p)
        mp.add_chunk(chunk)
    mp.finish()
    last_row = cc.table_rows(lag) - 1
    assert last_row == 1_431_655_764
    np.testing.assert_array_equal(mp.counts_for_rows(lag, np.array([last_row]))[0, 0],
                                  [0, 0, 0, 2 * (rlen - lag), 2])
    np.testing.assert_array_equal(mp.counts_for_rows(lag, np.array([0]))[0, 0],
                                  [0, 0, 0, 2, 0])
