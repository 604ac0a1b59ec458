"""The port's mesh helpers and mesh counters (bear_tpu_torch.parallel)
against bear_tpu's, on the CPU.

bear_tpu's counters run on tests/conftest.py's 8 virtual CPU devices; the
port's run on a CPU Mesh of the same shape (one CPU device named as many
times). The same reads, made with numpy from a seed, give exactly the
same int64 counts, and summarize writes the same bytes. One case for each
test of tests/test_sharded_counting.py and tests/test_parallel_utils.py.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting import summarize as jsummarize
from bear_tpu.counting.engine import ReadChunk as JReadChunk
from bear_tpu.parallel import data_parallel_mesh as jdata_parallel_mesh
from bear_tpu.parallel.counting import KmerShardedTransitionCounter as JKmer
from bear_tpu.parallel.counting import ShardedTransitionCounter as JSharded
from bear_tpu_torch.counting import engine, fastx, summarize
from bear_tpu_torch.inference.scoring import TableCounter
from bear_tpu_torch.parallel import (
    KmerShardedTransitionCounter,
    Mesh,
    ShardedTransitionCounter,
    data_parallel_mesh,
    grid_mesh,
    put_global,
    replicate,
    shard_along,
)
from bear_tpu_torch.parallel.counting import split_rows

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _seqs(rng, n, lo, hi):
    return ["".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))) for _ in range(n)]


def _count(counters, seqs, groups, max_lag, **kw):
    """Feed the same reads to bear_tpu's and the port's counters (each
    package's own encoder and chunker)."""
    for tc in counters:
        port = type(tc).__module__.startswith("bear_tpu_torch")
        enc_mod, chunker = (fastx, engine.chunk_reads) if port else (jfastx, jchunk_reads)
        enc = ((enc_mod.encode_seq(s), g) for s, g in zip(seqs, groups))
        for chunk in chunker(enc, max_lag, **kw):
            tc.add_chunk(chunk)


def _jmesh(n, axis):
    return JMesh(np.array(jax.devices()[:n]), (axis,))


# --- mesh helpers (tests/test_parallel_utils.py) ---------------------------


def test_grid_mesh_and_placement():
    mesh = grid_mesh({"data": 4, "kmer": 2}, device="cpu")
    assert mesh.shape == {"data": 4, "kmer": 2} and list(mesh.shape) == ["data", "kmer"]
    assert mesh.devices.shape == (4, 2) and mesh.size == 8 and mesh.axis_names == (
        "data", "kmer")
    x = np.arange(32.0).reshape(8, 4)
    pieces = shard_along(mesh, x, axis=0, mesh_axis="data")
    assert pieces.shape == (4, 2)
    np.testing.assert_array_equal(torch.cat(list(pieces[:, 0])).numpy(), x)
    np.testing.assert_array_equal(pieces[2, 1].numpy(), x[4:6])  # replicated over kmer
    # bear_tpu's placement holds the same array
    jx = jax.device_put(x, jax.sharding.NamedSharding(
        JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "kmer")),
        jax.sharding.PartitionSpec("data", None)))
    np.testing.assert_array_equal(np.asarray(jx), torch.cat(list(pieces[:, 0])).numpy())
    tree = replicate(mesh, {"a": np.ones(3)})
    for copy in tree.flat:
        np.testing.assert_array_equal(copy["a"].numpy(), np.ones(3))
    assert tree[0, 0]["a"].data_ptr() != tree[0, 1]["a"].data_ptr()  # copies
    np.testing.assert_array_equal(
        torch.cat(list(put_global(x, mesh)[:, 0])).numpy(), x)
    with pytest.raises(ValueError, match="evenly"):
        shard_along(mesh, np.arange(6.0), mesh_axis="data")


def test_data_parallel_mesh_subset():
    assert data_parallel_mesh(4, device="cpu").shape == {"data": 4}
    assert jdata_parallel_mesh(4).shape == data_parallel_mesh(4, device="cpu").shape
    mesh = Mesh([["cpu", CPU]], ("a", "b"))
    assert mesh.shape == {"a": 1, "b": 2} and mesh.along("b") == [CPU, CPU]
    with pytest.raises(ValueError, match="axis names"):
        Mesh([CPU, CPU], ("data", "kmer"))


def test_cuda_meshes_refuse_more_cards_than_exist():
    # bear_tpu's refusals; without a card the default device raises first.
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"requested {n + 1} devices, have {n}"):
            data_parallel_mesh(n + 1)
        with pytest.raises(ValueError, match="needs"):
            grid_mesh({"data": n + 1, "kmer": 1})
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_parallel_mesh(1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            grid_mesh({"data": 1})


# --- the data-sharded counter ---------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_matches_single_device(D):
    rng = np.random.default_rng(0)
    seqs = _seqs(rng, 37, 20, 60)
    groups = [int(g) for g in rng.integers(0, 2, len(seqs))]
    lags = [1, 2, 4]
    ref = JSharded(_jmesh(D, "data"), lags=lags, n_groups=2)
    single = engine.TransitionCounter(lags=lags, n_groups=2, device="cpu")
    port = ShardedTransitionCounter(data_parallel_mesh(D, device="cpu"), lags=lags, n_groups=2)
    _count((ref, single, port), seqs, groups, max(lags), batch_size=16)
    for l in lags:
        np.testing.assert_array_equal(port.tables[l], ref.tables[l])
        np.testing.assert_array_equal(port.tables[l], single.tables[l])
    port.validate(sum(len(s) + 1 for s in seqs))


def test_sharded_long_contig_reverse_stream():
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), 2000))
    ref = JSharded(_jmesh(8, "data"), lags=[3], n_groups=1)
    port = ShardedTransitionCounter(data_parallel_mesh(8, device="cpu"), lags=[3])
    _count((ref, port), [seq], [0], 3, segment_len=256, reverse=True)
    np.testing.assert_array_equal(port.tables[3], ref.tables[3])


def test_sharded_reverse_and_small_batches():
    # Batches smaller than the device count pad and still count exactly.
    seqs = ["ACGTACG", "TT"]
    ref = JSharded(_jmesh(8, "data"), lags=[3], n_groups=1, reverse=True)
    port = ShardedTransitionCounter(data_parallel_mesh(8, device="cpu"), lags=[3],
                                    reverse=True)
    _count((ref, port), seqs, [0, 0], 3, batch_size=4)
    np.testing.assert_array_equal(port.tables[3], ref.tables[3])
    assert port.tables[3].sum() == 2 * sum(len(s) + 1 for s in seqs)


def test_sharded_fresh_rows_flushes_and_partials():
    # Ambiguous pieces (fresh flags), several flushes and the per-device
    # partial tables: each replica holds exactly its row block's counts.
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGTN"), int(n))) for n in rng.integers(0, 80, 30)]
    enc = [(fastx.encode_seq(s, ambig=True), i % 2) for i, s in enumerate(seqs)]
    chunks = list(engine.chunk_reads(engine.split_ambiguous(iter(enc)), 5, batch_size=7))
    assert any(c.fresh is not None for c in chunks)
    jenc = [(jfastx.encode_seq(s, ambig=True), i % 2) for i, s in enumerate(seqs)]
    from bear_tpu.counting.engine import split_ambiguous as jsplit

    ref = JSharded(_jmesh(3, "data"), lags=[2, 5], n_groups=2)
    for c in jchunk_reads(jsplit(iter(jenc)), 5, batch_size=7):
        ref.add_chunk(c)
    port = ShardedTransitionCounter(Mesh([CPU] * 3, ("data",)), lags=[2, 5], n_groups=2)
    port.FLUSH_EVERY = 300  # several flushes
    from bear_tpu_torch.counting.count_chunk import count_chunk_plain, pack_meta

    for i, chunk in enumerate(chunks):
        port.add_chunk(chunk)
        if i == 0:
            blocks = split_rows((chunk.codes, chunk.lengths, chunk.skip, chunk.stopped,
                                 chunk.groups, chunk.fresh), 3)
            for part, (codes, *rows) in zip(port.partial_tables(), blocks):
                want = torch.zeros_like(part)
                count_chunk_plain(want, torch.from_numpy(np.ascontiguousarray(codes)),
                                  torch.from_numpy(pack_meta(*rows)), (2, 5), 2, 4)
                assert torch.equal(part, want)
    for l in (2, 5):
        np.testing.assert_array_equal(port.tables[l], ref.tables[l])


def test_sharded_guards():
    mesh = data_parallel_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="4-letter"):
        ShardedTransitionCounter(mesh, [2], reverse=True, alphabet="prot")
    with pytest.raises(ValueError, match="int32"):
        ShardedTransitionCounter(mesh, range(1, 15), n_groups=2)
    with pytest.raises(ValueError, match="SparseTransitionCounter"):
        ShardedTransitionCounter(mesh, [16])
    with pytest.raises(ValueError, match="counting method"):
        ShardedTransitionCounter(mesh, [2], method="dense")
    tc = ShardedTransitionCounter(mesh, [2], reverse=True)
    chunk = next(engine.chunk_reads(iter([(fastx.encode_seq("ACGTAC" * 20), 0)]), 2,
                                    segment_len=64))
    bad = engine.ReadChunk(chunk.codes, chunk.lengths, np.full_like(chunk.skip, 2),
                           chunk.stopped, chunk.groups)
    with pytest.raises(ValueError, match="skip == 0"):
        tc.add_chunk(bad)
    with pytest.raises(ValueError, match="group ids"):
        tc.add_chunk(engine.ReadChunk(chunk.codes, chunk.lengths, chunk.skip, chunk.stopped,
                                      chunk.groups + 1))
    assert tc.tables[2].sum() == 0  # the refused chunks counted nothing


# --- the row-split counter --------------------------------------------------


def _same_sparse(port, ref, lags):
    for l in lags:
        rows = ref.nonzero_rows(l)
        np.testing.assert_array_equal(port.nonzero_rows(l), rows)
        np.testing.assert_array_equal(port.counts_for_rows(l, rows), ref.counts_for_rows(l, rows))


def test_kmer_sharded_matches_single_device():
    rng = np.random.default_rng(11)
    seqs = _seqs(rng, 41, 15, 50)
    groups = [int(g) for g in rng.integers(0, 2, len(seqs))]
    lags = [1, 3, 5]
    ref = JKmer(_jmesh(8, "kmer"), lags=lags, n_groups=2)
    single = JCounter(lags=lags, n_groups=2)
    port = KmerShardedTransitionCounter(lags, n_groups=2,
                                        mesh=data_parallel_mesh(8, "kmer", device="cpu"))
    assert port.n_dev == 8 and port._per_lag == ref._per_lag
    _count((ref, single, port), seqs, groups, max(lags), batch_size=16)
    port.validate(expected_transitions=sum(len(s) + 1 for s in seqs))
    _same_sparse(port, ref, lags)
    for l in lags:
        rows = single.nonzero_rows(l)
        np.testing.assert_array_equal(port.counts_for_rows(l, rows),
                                      single.tables[l][:, rows, :].transpose(1, 0, 2))
        kp, vp = port._consolidated(l)
        kr, vr = ref._consolidated(l)
        np.testing.assert_array_equal(kp, kr)
        np.testing.assert_array_equal(vp, vr)
    ds, jds = port.to_dataset(5), ref.to_dataset(5)
    np.testing.assert_array_equal(ds.codes, jds.codes)
    np.testing.assert_array_equal(ds.counts, jds.counts)


def test_kmer_sharded_2d_mesh_replicas_not_double_counted():
    rng = np.random.default_rng(17)
    seqs = _seqs(rng, 12, 25, 26)
    ref = JKmer(JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "kmer")),
                lags=[3], n_groups=1)
    port = KmerShardedTransitionCounter(
        [3], mesh=grid_mesh({"data": 2, "kmer": 4}, device="cpu"))
    assert port.n_dev == 4
    _count((ref, port), seqs, [0] * 12, 3, batch_size=8)
    port.validate(expected_transitions=sum(len(s) + 1 for s in seqs))
    _same_sparse(port, ref, [3])


def test_counts_for_rows_duplicate_rows():
    rng = np.random.default_rng(19)
    seqs = _seqs(rng, 6, 20, 21)
    ref = JKmer(_jmesh(8, "kmer"), lags=[2], n_groups=1)
    port = KmerShardedTransitionCounter([2], mesh=data_parallel_mesh(8, "kmer", device="cpu"))
    _count((ref, port), seqs, [0] * 6, 2, batch_size=8)
    rows = port.nonzero_rows(2)
    dup = np.array([rows[0], rows[-1], rows[0], rows[0]])
    np.testing.assert_array_equal(port.counts_for_rows(2, dup), ref.counts_for_rows(2, dup))
    base = port.counts_for_rows(2, rows)
    np.testing.assert_array_equal(port.counts_for_rows(2, dup)[[0, 2, 3]], base[[0, 0, 0]])


def test_kmer_sharded_multiple_flushes():
    rng = np.random.default_rng(13)
    seqs = _seqs(rng, 20, 30, 31)
    ref = JKmer(_jmesh(8, "kmer"), lags=[4], n_groups=1)
    port = KmerShardedTransitionCounter([4], mesh=data_parallel_mesh(8, "kmer", device="cpu"))
    for i, s in enumerate(seqs):
        _count((ref, port), [s], [0], 4)
        if i % 7 == 3:
            ref.flush()
            port.flush()  # mid-stream flushes
    assert len(port._sparse[4]) > 8  # several drains of the 8 slices
    _same_sparse(port, ref, [4])


def test_summarize_cli_kmer_shards(tmp_path):
    # --kmer-shards 2 --device cpu writes bear_tpu's --kmer-shards bytes, and
    # the single-device counter's.
    rng = np.random.default_rng(17)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{''.join(rng.choice(list('ACGT'), 40))}\n"
                          for i in range(30)))
    fq = tmp_path / "more.fq"
    fq.write_text("".join(f"@q{i}\n{s}\n+\n{'F' * len(s)}\n"
                          for i, s in enumerate(_seqs(rng, 10, 0, 60))))
    csv = tmp_path / "in.csv"
    csv.write_text(f"{fa},0,fa\n{fq},1,fq\n")
    for d in ("jax", "port", "one"):
        (tmp_path / d).mkdir()
    jsummarize.main(jsummarize.build_parser().parse_args(
        [str(csv), str(tmp_path / "jax" / "run"), "-l", "4", "-r", "--kmer-shards", "8"]))
    report = {}
    summarize.main(summarize.build_parser().parse_args(
        [str(csv), str(tmp_path / "port" / "run"), "-l", "4", "-r", "--kmer-shards", "2",
         "--device", "cpu"]), report)
    summarize.main(summarize.build_parser().parse_args(
        [str(csv), str(tmp_path / "one" / "run"), "-l", "4", "-r", "--device", "cpu"]))
    assert isinstance(report["forward"]["counter"], KmerShardedTransitionCounter)
    assert report["forward"]["counter"].n_dev == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 8 and names == sorted(os.listdir(tmp_path / "port"))
    for other in ("port", "one"):
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / other, names,
                                               shallow=False)
        assert mismatch == [] and errors == []


def test_summarize_checkpoint_resume_kmer_shards(tmp_path):
    # A --kmer-shards job stopped between files resumes from the last
    # finished file and ends with bear_tpu's full-run counts.
    rng = np.random.default_rng(29)
    lines = []
    for fi in range(3):
        p = tmp_path / f"f{fi}.fa"
        p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(_seqs(rng, 4, 30, 31))))
        lines.append(f"{p},0,fa")
    full, part = tmp_path / "all.csv", tmp_path / "part.csv"
    full.write_text("\n".join(lines) + "\n")
    part.write_text("\n".join(lines[:2]) + "\n")
    lags = range(1, 4)
    ckpt = str(tmp_path / "count.ckpt")
    summarize.run_counting(str(part), lags, checkpoint=ckpt, kmer_shards=2, device="cpu")
    resumed = summarize.run_counting(str(full), lags, checkpoint=ckpt, kmer_shards=2,
                                     device="cpu")
    assert isinstance(resumed, KmerShardedTransitionCounter) and resumed.n_dev == 2
    oracle = jsummarize.run_counting(str(full), lags=lags, kmer_shards=8)
    _same_sparse(resumed, oracle, lags)
    with pytest.raises(ValueError, match="do not match"):
        summarize.run_counting(str(full), lags, checkpoint=ckpt, kmer_shards=2,
                               alphabet="rna", device="cpu")


def test_kmer_sharded_state_roundtrip_and_merge(tmp_path):
    rng = np.random.default_rng(23)
    seqs = _seqs(rng, 16, 25, 26)
    mesh = data_parallel_mesh(8, "kmer", device="cpu")
    a, b = (KmerShardedTransitionCounter([3], mesh=mesh) for _ in range(2))
    single = JCounter(lags=[3], n_groups=1)
    _count((a,), seqs[:8], [0] * 8, 3, batch_size=1)
    _count((b,), seqs[8:], [0] * 8, 3, batch_size=1)
    _count((single,), seqs, [0] * 16, 3, batch_size=1)
    p = str(tmp_path / "a_state.npz")
    a.save_state(p)
    ja = JKmer(_jmesh(8, "kmer"), lags=[3], n_groups=1)
    ja.load_state(p)  # bear_tpu reads the port's state file
    a2 = KmerShardedTransitionCounter([3], mesh=mesh)
    a2.load_state(p)
    a2.merge_from(b)
    np.testing.assert_array_equal(a2.tables[3], single.tables[3])
    np.testing.assert_array_equal(ja.counts_for_rows(3, a.nonzero_rows(3)),
                                  a.counts_for_rows(3, a.nonzero_rows(3)))


def test_to_device_dataset_float32_range_guard():
    # The data-sharded counter's handoff refuses float32 past 2^24.
    tc = ShardedTransitionCounter(data_parallel_mesh(2, device="cpu"), [2])
    _count((tc,), ["ACGTACG"], [0], 2)
    tc.flush()
    tc._host[2][0] += (1 << 24) + 3
    with pytest.raises(ValueError, match="float32"):
        tc.to_device_dataset(2, dtype=torch.float32)
    _, counts = tc.to_device_dataset(2, dtype=torch.float64)
    assert int(counts.max()) >= (1 << 24)


def test_kmer_sharded_protein_matches_single_device():
    rng = np.random.default_rng(41)
    B, L = 40, 18
    parts = (rng.integers(0, 20, (B, L)).astype(np.int8), np.full(B, L, np.int32),
             np.zeros(B, np.int32), np.ones(B, bool), rng.integers(0, 2, B).astype(np.int32))
    ref = JKmer(_jmesh(8, "kmer"), lags=[2], n_groups=2, alphabet="prot")
    port = KmerShardedTransitionCounter([2], n_groups=2, alphabet="prot",
                                        mesh=data_parallel_mesh(8, "kmer", device="cpu"))
    ref.add_chunk(JReadChunk(*parts))
    port.add_chunk(engine.ReadChunk(*parts))
    port.validate(expected_transitions=B * (L + 1))
    _same_sparse(port, ref, [2])
    ds, jds = port.to_dataset(2), ref.to_dataset(2)
    assert ds.alphabet == jds.alphabet == "prot"
    np.testing.assert_array_equal(ds.counts, jds.counts)
    np.testing.assert_array_equal(ds.codes, jds.codes)


def test_kmer_sharded_guards_and_empty_rows(tmp_path):
    mesh = data_parallel_mesh(8, "kmer", device="cpu")
    tc = KmerShardedTransitionCounter([2], alphabet="prot", mesh=mesh)
    rng = np.random.default_rng(3)
    tc.add_chunk(engine.ReadChunk(rng.integers(0, 20, (8, 10)).astype(np.int8),
                                  np.full(8, 10, np.int32), np.zeros(8, np.int32),
                                  np.ones(8, bool), np.zeros(8, np.int32)))
    assert tc.counts_for_rows(2, np.array([], dtype=np.int64)).shape == (0, 1, 21)
    p = str(tmp_path / "prot_state.npz")
    tc.save_state(p)
    with pytest.raises(ValueError, match="alphabet"):
        KmerShardedTransitionCounter([2], mesh=mesh).load_state(p)
    with pytest.raises(ValueError, match="base-20"):
        tc.to_dataset(2, alphabet="dna")
    # The int32 guard: lags 1..14 over two groups need three slices (a
    # 2.39e9-entry slice on two), as bear_tpu's.
    lags = range(1, 15)
    with pytest.raises(ValueError, match="int32 indexing"):
        JKmer(_jmesh(2, "kmer"), lags=lags, n_groups=2)
    with pytest.raises(ValueError, match="int32 indexing"):
        KmerShardedTransitionCounter(lags, n_groups=2, mesh=Mesh([CPU] * 2, ("kmer",)))
    three = KmerShardedTransitionCounter(lags, n_groups=2, mesh=Mesh([CPU] * 3, ("kmer",)))
    assert three._local_padded == JKmer(_jmesh(3, "kmer"), lags=lags, n_groups=2)._local_padded
    assert 1.5e9 < three.table_size < 1.6e9
    # Without a mesh only one slice; a mesh fixes the count.
    with pytest.raises(ValueError, match="pass mesh="):
        KmerShardedTransitionCounter([3], n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="has 8 devices"):
        KmerShardedTransitionCounter([3], n_shards=3, mesh=mesh)


def test_table_counter_over_kmer_sharded():
    rng = np.random.default_rng(9)
    seqs = _seqs(rng, 23, 15, 40)
    lag = 4
    single = engine.TransitionCounter(lags=[lag], n_groups=2, device="cpu")
    port = KmerShardedTransitionCounter([lag], n_groups=2,
                                        mesh=data_parallel_mesh(8, "kmer", device="cpu"))
    _count((single, port), seqs, [i % 2 for i in range(23)], lag, batch_size=8)
    queries = np.array(["ACGT", "TTTT", "ACGT", "A", "GC", "CGT", "GGGG", "A"])
    for group in (0, 1):
        np.testing.assert_array_equal(TableCounter(single, lag, group=group)(queries),
                                      TableCounter(port, lag, group=group)(queries))
    np.testing.assert_array_equal(TableCounter(single, lag, no_end=True)(queries),
                                  TableCounter(port, lag, no_end=True)(queries))
