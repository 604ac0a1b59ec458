"""The port's sparse-first counter (bear_tpu_torch.counting.sparse) against
bear_tpu's and against a brute-force recount, on the CPU: the same chunks,
made with numpy from a seed, give exactly the same int64 keys and counts;
state files, TSV shards and summarize's output at lags 16 and 17 are
byte-identical to bear_tpu's.
"""

import filecmp
import os
from collections import Counter as PyCounter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bear_tpu.counting import ReadChunk as JReadChunk
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting import summarize as jsummarize
from bear_tpu.counting.sparse import SparseTransitionCounter as JSparse
from bear_tpu.counting.sparse import max_sparse_lag as jmax_sparse_lag
from bear_tpu_torch.counting import engine, fastx, sparse, summarize
from bear_tpu_torch.counting.sparse import SparseTransitionCounter, max_sparse_lag
from bear_tpu_torch.inference.serving import contexts_to_rows
from bear_tpu_torch.parallel import Mesh

torch.set_num_threads(2)
LETTERS = "ACGT"


def _chunk(rng, B, L, n_groups=2, stop_p=0.8, A=4, fresh=False):
    """(the port's ReadChunk, bear_tpu's) of the same random rows."""
    parts = (rng.integers(0, A, (B, L)).astype(np.int8),
             rng.integers(0, L + 1, B).astype(np.int32), np.zeros(B, np.int32),
             rng.random(B) < stop_p, rng.integers(0, n_groups, B).astype(np.int32),
             rng.random(B) < 0.5 if fresh else None)
    return engine.ReadChunk(*parts), JReadChunk(*parts)


def _brute_force(chunks, lag):
    """(group, context, next) -> count over the port's chunks, straight from
    the ReadChunk definition (non-fresh rows drop positions j < lag)."""
    oracle, total = PyCounter(), 0
    for ch in chunks:
        for b in range(ch.codes.shape[0]):
            n, g = int(ch.lengths[b]), int(ch.groups[b])
            fresh = True if ch.fresh is None else bool(ch.fresh[b])
            s = "".join(LETTERS[c] for c in ch.codes[b, :n])
            padded = "[" * lag + s
            for j in range(n + bool(ch.stopped[b])):
                if fresh or j >= lag:
                    oracle[(g, padded[j : j + lag], s[j] if j < n else "]")] += 1
                    total += 1
    return dict(oracle), total


def _as_dict(counter, lag):
    rows = counter.nonzero_rows(lag)
    counts = counter.counts_for_rows(lag, rows)
    got = {}
    for i, ctx in enumerate(engine.rows_to_contexts(rows, lag)):
        for g, k in zip(*np.nonzero(counts[i])):
            got[(int(g), ctx, "ACGT]"[k])] = int(counts[i, g, k])
    return got


def _assert_same_counts(port, ref, lags):
    for l in lags:
        kp, vp = port._consolidated(l)
        kr, vr = ref._consolidated(l)
        assert kp.dtype == vp.dtype == np.int64
        np.testing.assert_array_equal(kp, kr, err_msg=f"lag {l} keys")
        np.testing.assert_array_equal(vp, vr, err_msg=f"lag {l} counts")


def _seq_oracle(seq, lag):
    """The brute-force recount of one whole sequence (a contig counted in
    segments)."""
    padded = "[" * lag + seq + "]"
    oracle = PyCounter((0, padded[j - lag : j], padded[j]) for j in range(lag, len(padded)))
    return dict(oracle), len(seq) + 1


def _case(name):
    """(counter kwargs, [(port chunk, bear_tpu chunk)], {lag: (brute-force
    recount, transitions)})."""
    rng = np.random.default_rng(list(CASES).index(name))
    kw = dict(lags=[16], n_groups=2)
    if name == "lag16_two_groups":
        chunks = [_chunk(rng, 40, 30) for _ in range(3)]
        kw["lags"] = [1, 3, 16]
    elif name == "lag17_reverse":
        chunks = [_chunk(rng, 30, 24, n_groups=1) for _ in range(2)]
        kw = dict(lags=[2, 17], n_groups=1, reverse=True)
    elif name == "lag20_fresh":
        chunks = [_chunk(rng, 40, 30, fresh=True) for _ in range(2)]
        kw["lags"] = [20]
    elif name == "lag17_segmented_contig":
        seq = "".join(rng.choice(list(LETTERS), 3000))
        pc = engine.chunk_reads([(fastx.encode_seq(seq), 0)], 17, segment_len=512)
        jc = jchunk_reads([(jfastx.encode_seq(seq), 0)], 17, segment_len=512)
        return dict(lags=[17], n_groups=1), list(zip(pc, jc)), {17: _seq_oracle(seq, 17)}
    elif name == "protein_lag9":
        chunks = [_chunk(rng, 60, 25, n_groups=1, stop_p=1.0, A=20)]
        kw = dict(lags=[3, 9], n_groups=1, alphabet="prot")
    elif name == "dna30":
        chunks = [_chunk(rng, 20, 40, n_groups=1)]
        kw = dict(lags=[30], n_groups=1)
    elif name == "protein13":
        chunks = [_chunk(rng, 15, 20, n_groups=1, stop_p=1.0, A=20)]
        kw = dict(lags=[13], n_groups=1, alphabet="prot")
    elif name == "tiny_buffer_row_slicing":  # windows smaller than one chunk
        chunks = [_chunk(rng, 40, 30) for _ in range(3)]
        kw["device_buffer"] = 64
    elif name == "cap_ratchet":  # a small chunk first, then a bigger one
        chunks = [_chunk(rng, 4, 10, n_groups=1), _chunk(rng, 200, 50, n_groups=1)]
        kw = dict(lags=[16], n_groups=1)
    else:
        raise KeyError(name)
    dna = kw.get("alphabet", "dna") == "dna" and not kw.get("reverse")
    return kw, chunks, {l: _brute_force([pc for pc, _ in chunks], l)
                        for l in kw["lags"] if dna and l >= 16}


CASES = ["lag16_two_groups", "lag17_reverse", "lag20_fresh", "lag17_segmented_contig",
         "protein_lag9", "dna30", "protein13", "tiny_buffer_row_slicing", "cap_ratchet"]


@pytest.mark.parametrize("name", CASES)
def test_counts_equal_bear_tpu_and_the_brute_force_recount(name):
    kw, chunks, oracles = _case(name)
    port = SparseTransitionCounter(**kw, device="cpu")
    ref = JSparse(**kw)
    caps = []
    for pc, jc in chunks:
        port.add_chunk(pc)
        ref.add_chunk(jc)
        caps.append(port._cap)
        assert port._cap == ref._cap
    _assert_same_counts(port, ref, kw["lags"])
    for lag, (oracle, total) in oracles.items():
        assert _as_dict(port, lag) == oracle
        port.validate(expected_transitions=total)
    if name == "cap_ratchet":
        assert caps[1] > caps[0] and caps[1] >= 200 * 51
    if name == "tiny_buffer_row_slicing":
        assert port._cap < 40 * 31  # every chunk went in row slices
    if name == "protein13":
        rows = port.nonzero_rows(13)
        np.testing.assert_array_equal(
            contexts_to_rows(engine.rows_to_contexts(rows[:10], 13, "prot"), 13, "prot"),
            rows[:10])
    if name == "dna30":
        assert port.nonzero_rows(30).max() < np.iinfo(np.int64).max // 5


def test_caps_and_refusals():
    for A, groups in ((4, 1), (20, 1), (4, 3), (20, 2)):
        assert max_sparse_lag(A, groups) == jmax_sparse_lag(A, groups)
    assert (max_sparse_lag(4), max_sparse_lag(20)) == (30, 13)
    assert (sparse.digit_split(4), sparse.digit_split(20)) == (15, 7)
    for kw in (dict(lags=[31]), dict(lags=[14], alphabet="prot"),
               dict(lags=[3], reverse=True, alphabet="prot"), dict(lags=[3], device_buffer=0)):
        with pytest.raises(ValueError) as want:
            JSparse(**kw)
        with pytest.raises(ValueError) as got:
            SparseTransitionCounter(**kw, device="cpu")
        assert str(got.value) == str(want.value)
    # mesh= runs: rows split over a 3-device data axis (the one CPU named
    # three times), bear_tpu's 3-device counts, key for key.
    meshed = SparseTransitionCounter(lags=[17], n_groups=2, device_buffer=256,
                                     mesh=Mesh(["cpu"] * 3, ("data",)))
    jmeshed = JSparse(lags=[17], n_groups=2, device_buffer=256,
                      mesh=JMesh(np.array(jax.devices()[:3]), ("data",)))
    for _ in range(3):
        pc, jc = _chunk(np.random.default_rng(_), 10, 21)
        meshed.add_chunk(pc)
        jmeshed.add_chunk(jc)
    _assert_same_counts(meshed, jmeshed, [17])
    with pytest.raises(ValueError, match="SparseTransitionCounter"):
        engine.TransitionCounter(lags=[16], device="cpu")
    sp = SparseTransitionCounter(lags=[17], reverse=True, device="cpu")
    rng = np.random.default_rng(1)
    pc, _ = _chunk(rng, 3, 5, n_groups=1)
    pc.skip[:] = 1
    with pytest.raises(ValueError, match="whole-read chunks"):
        sp.add_chunk(pc)
    with pytest.raises(ValueError, match="group"):
        SparseTransitionCounter(lags=[17], device="cpu").add_chunk(_chunk(rng, 3, 5, 3)[0])


def test_sparse_mesh_matches_bear_tpu():
    # tests/test_sparse_counting.py:343: rows over an 8-device data axis,
    # a fresh-flagged chunk among them; bear_tpu's 8-device counter and the
    # port's on a CPU mesh of 8 give the same keys and counts.
    rng = np.random.default_rng(12)
    pairs = [_chunk(rng, 52, 24) for _ in range(3)] + [_chunk(rng, 36, 24, fresh=True)]
    port = SparseTransitionCounter(lags=[17], n_groups=2, mesh=Mesh(["cpu"] * 8, ("data",)))
    ref = JSparse(lags=[17], n_groups=2, mesh=JMesh(np.array(jax.devices()[:8]), ("data",)))
    for pc, jc in pairs:
        port.add_chunk(pc)
        ref.add_chunk(jc)
    _assert_same_counts(port, ref, [17])
    oracle, total = _brute_force([pc for pc, _ in pairs], 17)
    assert _as_dict(port, 17) == oracle
    port.validate(expected_transitions=total)


def test_sparse_mesh_tiny_buffer_and_reverse():
    # tests/test_sparse_counting.py:377: a 4-device mesh with windows of a
    # few rows (chunks sliced by rows, many drains) and the reverse
    # complement.
    rng = np.random.default_rng(13)
    pairs = [_chunk(rng, 24, 20, n_groups=1) for _ in range(3)]
    kw = dict(lags=[16], reverse=True, device_buffer=128)
    port = SparseTransitionCounter(**kw, mesh=Mesh(["cpu"] * 4, ("data",)))
    ref = JSparse(**kw, mesh=JMesh(np.array(jax.devices()[:4]), ("data",)))
    one = JSparse(lags=[16], reverse=True)
    for pc, jc in pairs:
        port.add_chunk(pc)
        ref.add_chunk(jc)
        one.add_chunk(jc)
    assert port._cap < 24 * 21  # a chunk is more than a window
    _assert_same_counts(port, ref, [16])
    _assert_same_counts(port, one, [16])


def test_consolidation_resets_the_pending_count(monkeypatch):
    # After a consolidation the pending count is 0, not the store's size
    # (which would re-merge the whole store on every later push).
    monkeypatch.setattr(sparse, "CONSOLIDATE_PENDING", 4)
    rng = np.random.default_rng(5)
    dense = engine.TransitionCounter(lags=[1, 3], n_groups=1, device="cpu")
    sp = SparseTransitionCounter(lags=[1, 3], n_groups=1, device="cpu")
    for _ in range(3):
        pc, _ = _chunk(rng, 32, 16, n_groups=1)
        dense.add_chunk(pc)
        sp.add_chunk(pc)
    assert sp._pending == 0
    for l in (1, 3):
        np.testing.assert_array_equal(sp.tables[l], dense.tables[l])
        rows = dense.nonzero_rows(l)
        np.testing.assert_array_equal(sp.nonzero_rows(l), rows)
        np.testing.assert_array_equal(sp.counts_for_rows(l, rows), dense.row_counts(l, rows))


def test_window_runs_follow_the_lexicographic_order():
    # Keys whose order by (hi, lo) differs from their order by t; the
    # sentinel tail counts nowhere.
    t = torch.tensor([5, 2, 5, 2, sparse._SENT, 2, 5, sparse._SENT], dtype=torch.int32)
    hi = torch.tensor([0, 9, 0, 1, 0, 9, 3, 7], dtype=torch.int32)
    lo = torch.tensor([7, 0, 7, 2, 0, 0, 1, 7], dtype=torch.int32)
    ts, hs, ls, counts = sparse.window_runs(t, hi, lo)
    assert ts.tolist() == [2, 2, 5, 5] and hs.tolist() == [1, 9, 0, 3]
    assert ls.tolist() == [2, 0, 7, 1] and counts.tolist() == [1, 2, 2, 1]
    empty = sparse.window_runs(*(torch.full((3,), sparse._SENT, dtype=torch.int32),) * 3)
    assert [x.numel() for x in empty] == [0, 0, 0, 0]


def test_state_files_tsvs_and_merge_equal_bear_tpu(tmp_path):
    rng = np.random.default_rng(6)
    lag = 16
    (p1, j1), (p2, j2) = _chunk(rng, 50, 40, n_groups=1), _chunk(rng, 50, 40, n_groups=1)
    port = SparseTransitionCounter(lags=[2, lag], n_groups=1, device="cpu")
    ref = JSparse(lags=[2, lag], n_groups=1)
    port.add_chunk(p1)
    ref.add_chunk(j1)
    port.save_state(str(tmp_path / "port"))
    ref.save_state(str(tmp_path / "jax"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # each package loads the other's file and counts on
    from_jax = SparseTransitionCounter(lags=[2, lag], n_groups=1, device="cpu")
    from_jax.load_state(str(tmp_path / "jax.npz"))
    from_jax.add_chunk(p2)
    from_port = JSparse(lags=[2, lag], n_groups=1)
    from_port.load_state(str(tmp_path / "port.npz"))
    from_port.add_chunk(j2)
    _assert_same_counts(from_jax, from_port, [2, lag])
    with pytest.raises(ValueError, match="do not match"):
        SparseTransitionCounter(lags=[lag], reverse=True, device="cpu").load_state(
            str(tmp_path / "jax.npz"))
    # merge_from: the first chunk's counter plus the second's
    other = SparseTransitionCounter(lags=[2, lag], n_groups=1, device="cpu")
    other.add_chunk(p2)
    port.merge_from(other)
    _assert_same_counts(port, from_port, [2, lag])
    for shuffle in (False, True):
        port.export_tsv(str(tmp_path / "p"), lag, n_bin_bits=1, shuffle=shuffle)
        from_port.export_tsv(str(tmp_path / "j"), lag, n_bin_bits=1, shuffle=shuffle)
        for b in range(2):
            assert filecmp.cmp(tmp_path / f"p_lag_{lag}_file_{b}.tsv",
                               tmp_path / f"j_lag_{lag}_file_{b}.tsv", shallow=False)
    ds, jds = port.to_dataset(lag), from_port.to_dataset(lag)
    np.testing.assert_array_equal(ds.kmers, jds.kmers)
    np.testing.assert_array_equal(ds.codes, jds.codes)
    np.testing.assert_array_equal(ds.counts, jds.counts)
    np.testing.assert_array_equal(
        [engine.context_to_row(k, lag) for k in ds.kmers[:20]], port.nonzero_rows(lag)[:20])
    with pytest.raises(ValueError, match="nonzero_rows"):
        port.tables  # noqa: B018  (a dense lag-16 host table is refused)


def _reads_csv(tmp_path, n_files=2, seed=9, n_groups=2):
    rng = np.random.default_rng(seed)
    lines = []
    for fi in range(n_files):
        seqs = ["".join(rng.choice(list("ACGTN"), int(rng.integers(0, 60)))) for _ in range(12)]
        p = tmp_path / f"f{fi}.fa"
        p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
        lines.append(f"{p},{fi % n_groups},fa\n")
    csv = tmp_path / "all.csv"
    csv.write_text("".join(lines))
    part = tmp_path / "part.csv"
    part.write_text(lines[0])
    return str(csv), str(part)


def _same_dirs(a, b):
    names = sorted(f for f in os.listdir(a) if f.endswith(".tsv"))
    assert names and names == sorted(f for f in os.listdir(b) if f.endswith(".tsv"))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []
    return names


def test_summarize_beyond_the_dense_range_writes_bear_tpus_bytes(tmp_path):
    # -l 17: lags 1..17 (16 and 17 sparse-first), both strands, shuffled.
    csv, _ = _reads_csv(tmp_path)
    argv = ["-l", "17", "-r", "--shuffle"]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jsummarize.main(jsummarize.build_parser().parse_args(
        [csv, str(tmp_path / "jax" / "run"), *argv]))
    report = {}
    summarize.main(summarize.build_parser().parse_args(
        [csv, str(tmp_path / "port" / "run"), *argv, "--device", "cpu"]), report)
    names = _same_dirs(tmp_path / "jax", tmp_path / "port")
    assert sum("_lag_17_" in n for n in names) == sum("_lag_16_" in n for n in names) == 2
    counter = report["forward"]["counter"]
    assert isinstance(counter, SparseTransitionCounter)
    assert report["forward"]["table_bytes"] == 4 * counter.table_size > 0


def test_checkpoint_resume_at_lag_17_equals_a_fresh_run(tmp_path):
    csv, part = _reads_csv(tmp_path, n_files=3, seed=19, n_groups=1)
    ckpt = str(tmp_path / "count.ckpt")
    summarize.run_counting(part, lags=[17], checkpoint=ckpt, device="cpu")  # "killed"
    resumed = summarize.run_counting(csv, lags=[17], checkpoint=ckpt, device="cpu")
    assert isinstance(resumed, SparseTransitionCounter)
    fresh = summarize.run_counting(csv, lags=[17], device="cpu")
    jfresh = jsummarize.run_counting(csv, lags=[17])
    _assert_same_counts(resumed, fresh, [17])
    _assert_same_counts(fresh, jfresh, [17])
    # the checkpoint file is bear_tpu's: its counter resumes from it too
    jres = jsummarize.run_counting(csv, lags=[17], checkpoint=ckpt)
    _assert_same_counts(jres, fresh, [17])
    with pytest.raises(ValueError, match="do not match"):
        summarize.run_counting(csv, lags=[16, 17], checkpoint=ckpt, device="cpu")


def test_run_counting_routes_and_refusals(tmp_path):
    csv, _ = _reads_csv(tmp_path)
    assert isinstance(summarize.run_counting(csv, [8], alphabet="prot", device="cpu"),
                      SparseTransitionCounter)
    assert isinstance(summarize.run_counting(csv, [5], device="cpu"), engine.TransitionCounter)
    # --data-shards runs beyond the dense range: rows over two devices,
    # bear_tpu's two-device counts.
    port = summarize.run_counting(csv, [16], data_shards=2, device="cpu")
    assert isinstance(port, SparseTransitionCounter) and port.n_dev == 2
    _assert_same_counts(port, jsummarize.run_counting(csv, [16], data_shards=2), [16])
    for kw, match in ((dict(lags=[5], data_shards=2), "kmer-shards"),
                      (dict(lags=[17], data_shards=2, passes=2), "mutually exclusive")):
        with pytest.raises(ValueError, match=match):
            summarize.run_counting(csv, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jsummarize.run_counting(csv, **kw)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--data-shards 2 needs that many devices"):
            summarize.run_counting(csv, [16], data_shards=2, device="cuda")
