"""``BearServer`` over a sparse count map, the form of the lags past the dense
table (DNA lag 16-30, protein lag 8-13), on the CPU:

- at lags where both forms exist, the server over a
  ``SparseTransitionCounter``'s map scores exactly as the server over the
  dense table of the same reads (MAP, sampled, MC-41, Δ);
- the int64 row math against the plain reference
  (bench_gpu/reference/sparse.py, which imports nothing of the port);
- at lag 20 on a 20 kb genome, scores against that reference and against
  the port's host route;
- the loaders (``from_model_dir`` and the score CLI) on a lag-16 model
  directory, the lookup's span and counter, and int32 rows at the dense
  lags.

Tolerances, each with its reason: scores in float64, relative 1e-10 (the
port and the reference sum the same float64 terms in another order, and
draw float64 variates from the same keys); Δ against the difference of two
whole-sequence MAP scores, relative 1e-10 and absolute 1e-9 (the whole
sequences sum ~70 terms of size ~1-10 where the Δ sums 42, so float64
rounding of the sums, ~1e-13, is all that differs).
"""

import configparser

import numpy as np
import pytest
import torch

from bear_tpu_torch.counting import ReadChunk, TransitionCounter, table_rows
from bear_tpu_torch.counting.sparse import SparseTransitionCounter
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.score_cli import main as score_main
from bear_tpu_torch.inference.scoring import (
    SparseTable,
    SparseTableIndex,
    TableCounter,
    get_bear_probs,
    get_bear_probs_seqs,
)
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.parallel.mesh import Mesh
from bear_tpu_torch.utils import profiling
from bear_tpu_torch.utils.checkpoint import save_results
from bench_gpu import genome, weights
from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import ragged
from bench_gpu.reference import sparse as ref_sparse

torch.set_num_threads(2)
WIDTHS = {"filter_width": 8, "num_filters": 96, "kmer_layer1_width": 64}  # genome_lag13_cnn
SMALL = {"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 4}
H = 0.05
SEED = 2**31 + 53
GENOME = dict(genome_mb=0.02, coverage=4, read_len=50, held_out=0.25, template_len=2000,
              mutation_rate=0.01)


def _config(lag, widths):
    return {"lag": lag, "alphabet_size": 4, "model": {"ar_func": "cnn", **widths}}


def _ar(lag, widths, dtype):
    """The port's CNN AR at the benchmark's seeded weights (+ 1e-7, as the
    benchmark serves it), and the weights."""
    params = weights.make_params(_config(lag, widths), SEED, "cpu", dtype)
    ar = get_ar_func("cnn", lag, 4, widths, dtype=dtype, device="cpu")
    ar.load_params(params[1:])
    ar.requires_grad_(False)
    return (lambda oh: ar(oh) + ref_model.EPSILON), params


def _reads():
    return genome.synth_reads(SEED, **GENOME)


def _count(counter, reads, groups):
    for arrays in genome.chunk_arrays(reads, groups, 256):
        counter.add_chunk(ReadChunk(*arrays))
    return counter


def _strings(codes):
    return ["".join("ACGT"[c] for c in r) for r in codes]


# --- both forms agree where both exist ------------------------------------


@pytest.fixture(scope="module", params=[6, 10])
def both_forms(request):
    lag = request.param
    reads, groups = _reads()
    dense = _count(TransitionCounter(lags=[lag], n_groups=2, device="cpu"), reads, groups)
    sparse = _count(SparseTransitionCounter([lag], n_groups=2, device="cpu"), reads, groups)
    ar_apply, _ = _ar(lag, SMALL, torch.float32)
    kw = dict(h=H, ar_apply=ar_apply, dtype=torch.float32, device="cpu")
    held = _strings(reads[groups == 1][:24]) + ["ACG", "T" * 70]  # ragged, a miss
    wt = _strings(reads[:1])[0] + "ACGTTGCA"
    return (BearServer(dense.tables[lag][0], lag, **kw), BearServer(sparse, lag, **kw),
            held, wt)


CALLS = {
    "map": lambda s, q, wt: s.score(q),
    "sampled": lambda s, q, wt: s.score(q, mode="sample", key=kr.key(7)),
    "mc41": lambda s, q, wt: s.score(q, mode="sample", key=kr.key(8), mc_samples=41,
                                     reduce="mean_std"),
    "snv": lambda s, q, wt: s.delta_scores_snv(
        wt, np.repeat(np.arange(len(wt)), 3),
        np.array([a for c in wt for a in "ACGT" if a != c]), mode="sample", key=kr.key(9),
        mc_samples=41, reduce="mean_std"),
    "variants": lambda s, q, wt: s.delta_scores_variants(
        wt, [f"{wt[3:5]}3G", f"{wt[10]}10{wt[10]}AC", f"{wt[20:24]}20", f"{wt[0:3]}0CCCCC"],
        mode="sample", key=kr.key(10), mc_samples=41, reduce="mean_std"),
    "snv_map": lambda s, q, wt: s.delta_scores_snv(wt, np.arange(len(wt)),
                                                   np.array(["A"] * len(wt))),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_sparse_map_scores_as_the_dense_table(both_forms, call):
    dense, sparse, held, wt = both_forms
    assert sparse._sparse is not None and dense._sparse is None
    np.testing.assert_array_equal(CALLS[call](sparse, held, wt), CALLS[call](dense, held, wt))


def test_a_sparse_table_in_any_form_builds_one_map():
    reads, groups = _reads()
    lag = 6
    counter = _count(SparseTransitionCounter([lag], n_groups=2, device="cpu"), reads, groups)
    index = SparseTableIndex(counter, lag, 0)
    keep = index.counts.any(axis=1)
    assert not keep.all()  # rows counted only in the held-out group
    forms = [counter, index, SparseTable(index.rows[keep], index.counts[keep])]
    maps = [BearServer(f, lag, van=1.0, device="cpu")._sparse for f in forms]
    for rows, counts in maps:
        np.testing.assert_array_equal(rows.numpy(), index.rows[keep])
        np.testing.assert_array_equal(counts.numpy(), index.counts[keep].astype(np.float32))


def test_a_sparse_map_over_a_mesh_is_refused():
    table = SparseTable(np.array([0, 3], np.int64), np.ones((2, 5), np.int64))
    with pytest.raises(ValueError, match="sparse table"):
        BearServer(table, 20, van=1.0, device="cpu", mesh=Mesh(["cpu"] * 2, ("kmer",)))


# --- the int64 row math against the plain reference -----------------------


@pytest.mark.parametrize("alphabet,lag", [("dna", 16), ("dna", 20), ("dna", 30),
                                          ("prot", 8), ("prot", 13)])
def test_rows_and_contexts_past_int32_equal_the_reference(alphabet, lag):
    A = alphabets.alphabet_size(alphabet)
    assert table_rows(lag, A) > np.iinfo(np.int32).max
    g = torch.Generator().manual_seed(lag)
    codes = torch.randint(0, A, (9, 45), generator=g, dtype=torch.int8)
    rows, nxt, mask = serving._context_rows_and_next(
        codes, torch.full((9,), 45, dtype=torch.int32), lag, A)
    want_rows, want_nxt = ref_sparse.context_rows(codes, lag, A)
    assert rows.dtype == torch.int64 and bool(mask.all())
    assert torch.equal(rows, want_rows) and torch.equal(nxt.long(), want_nxt)
    oh = serving._rows_to_onehot_contexts(rows.reshape(-1), lag, torch.float64, A)
    want = ref_model.one_hot(ref_counts.decode(want_rows.reshape(-1), lag, A),
                             A + 1, torch.float64)
    assert torch.equal(oh, want)


@pytest.mark.parametrize("alphabet,lag", [("dna", 13), ("dna", 15), ("prot", 6), ("prot", 7)])
def test_rows_at_the_dense_lags_stay_int32(alphabet, lag):
    A = alphabets.alphabet_size(alphabet)
    codes = torch.zeros((2, 20), dtype=torch.int8)
    rows, nxt, _ = serving._context_rows_and_next(codes, torch.tensor([20, 7]), lag, A)
    assert serving.row_dtype(lag, A) == torch.int32
    assert rows.dtype == torch.int32 and nxt.dtype == torch.int32
    server = BearServer(SparseTable(np.zeros(0, np.int64), np.zeros((0, A + 1))), lag,
                        van=1.0, alphabet=alphabet, device="cpu")
    mt = server._mt_windows(torch.zeros((3, 2 * lag + 1), dtype=torch.int8),
                            torch.tensor([1, 2, 3]))
    assert mt[0].dtype == torch.int32


# --- lag 20 against the plain reference and the host route ----------------


@pytest.fixture(scope="module")
def lag20():
    lag = 20
    reads, groups = _reads()
    counter = _count(SparseTransitionCounter([lag], n_groups=2, device="cpu"), reads, groups)
    ar_apply, params = _ar(lag, WIDTHS, torch.float64)
    server = BearServer(counter, lag, h=H, ar_apply=ar_apply, dtype=torch.float64,
                        device="cpu")
    train = torch.as_tensor(reads[groups == 0])
    map_rows, map_counts = ref_sparse.count_map(train, lag)
    held = torch.as_tensor(reads[groups == 1][:16])
    rows, nxt = ref_sparse.context_rows(held, lag)
    conc = ref_sparse.concentrations(rows.reshape(-1), map_rows, map_counts,
                                     lambda oh: ref_model.cnn_probs(oh, params[1:]), lag, 4,
                                     H, torch.float64)
    seq = torch.arange(held.shape[0]).repeat_interleave(held.shape[1] + 1)
    return dict(lag=lag, counter=counter, server=server, held=held, rows=rows.reshape(-1),
                nxt=nxt.reshape(-1), conc=conc, seq=seq, map=(map_rows, map_counts),
                params=params, reads=reads)


def test_lag20_the_reference_map_hits_and_misses(lag20):
    counter_rows = SparseTableIndex(lag20["counter"], 20, 0)
    keep = counter_rows.counts.any(axis=1)
    map_rows, map_counts = lag20["map"]
    np.testing.assert_array_equal(map_rows.numpy(), counter_rows.rows[keep])
    np.testing.assert_array_equal(map_counts.numpy(), counter_rows.counts[keep])
    _, hit = ref_sparse.lookup(map_rows, map_counts, lag20["rows"])
    assert 0 < float(hit.float().mean()) < 1  # held-out windows both counted and not


def test_lag20_map_scores_equal_the_reference(lag20):
    got = lag20["server"].score(_strings(lag20["held"].numpy()))
    want = ragged.map_scores(lag20["seq"], lag20["nxt"], lag20["conc"],
                             lag20["held"].shape[0])
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10)


def test_lag20_mc41_scores_equal_the_reference(lag20):
    call_key = 2**40 + 17
    got = lag20["server"].score(_strings(lag20["held"].numpy()), mode="sample",
                                key=kr.key(call_key), mc_samples=41, reduce="mean_std")
    want = ragged.sampled_mean_std(call_key, 41, lag20["seq"], lag20["rows"], lag20["nxt"],
                                   lag20["conc"], lag20["held"].shape[0], 3)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10)


def test_lag20_sampled_snv_deltas_equal_the_reference(lag20):
    lag, call_key = lag20["lag"], 2**33 + 5
    wt = torch.as_tensor(lag20["reads"][5, :40])
    pos = torch.arange(40).repeat_interleave(3)
    alt = torch.stack([(wt + k) % 4 for k in (1, 2, 3)], dim=1).reshape(-1)
    got = lag20["server"].delta_scores_snv(_strings([wt.numpy()])[0], pos.numpy(), alt.numpy(),
                                           mode="sample", key=kr.key(call_key),
                                           mc_samples=41, reduce="mean_std")
    rw, nw, rm, nm, valid = ref_sparse.snv_windows(wt, pos, alt, lag)
    probs = lambda oh: ref_model.cnn_probs(oh, lag20["params"][1:])  # noqa: E731
    cw, cm = (ref_sparse.concentrations(r.reshape(-1), *lag20["map"], probs, lag, 4, H,
                                        torch.float64).reshape(r.shape + (5,))
              for r in (rw, rm))
    d = ref_sparse.snv_deltas(call_key, 41, rw, nw, cw, rm, nm, cm, valid, 3)
    want = torch.stack([d.mean(dim=1), d.std(dim=1, correction=1)], dim=1)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-12)


def test_lag20_snv_map_deltas_are_differences_of_whole_sequence_scores(lag20):
    wt = _strings(lag20["reads"][7:8, :45])[0]
    pos = np.repeat(np.arange(len(wt)), 3)
    alt = np.array([a for c in wt for a in "ACGT" if a != c])
    mutants = [wt[:p] + a + wt[p + 1:] for p, a in zip(pos, alt)]
    server = lag20["server"]
    d = server.delta_scores_snv(wt, pos, alt)
    np.testing.assert_allclose(d, server.score(mutants) - server.score([wt])[0],
                               rtol=1e-10, atol=1e-9)


def test_lag20_map_scores_equal_the_host_route(lag20):
    counter, van = lag20["counter"], 0.5
    seqs = _strings(lag20["held"].numpy()[:6]) + ["ACGTTGCAAC" * 3]
    want = get_bear_probs_seqs(None, seqs, 0, vans=[van], get_map=True, lag=20,
                               alphabet_name="dna", counter=TableCounter(counter, 20, 0),
                               device="cpu")[:, 0]
    got = BearServer(counter, 20, van=van, dtype=torch.float64, device="cpu").score(seqs)
    np.testing.assert_allclose(got, want, rtol=1e-10)


# --- the lookup's span and counter ----------------------------------------


def test_sparse_lookups_counts_sparse_calls_only(lag20, both_forms):
    dense, sparse, held, wt = both_forms
    serving.sparse_lookups = 0
    for call in ("map", "mc41", "snv_map", "variants"):
        CALLS[call](dense, held, wt)
    assert serving.sparse_lookups == 0
    for call in ("map", "mc41", "snv_map", "variants"):
        CALLS[call](sparse, held, wt)
    assert serving.sparse_lookups == 4
    serving.sparse_lookups = 0


def test_the_lookup_span_is_recorded_once_per_ar_slice(lag20, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(serving, "AR_SLICE_ROWS", 100)
    held = _strings(lag20["held"].numpy()[:5])  # 5 x 51 = 255 windows: 3 slices
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            lag20["server"].score(held, mode="sample", key=kr.key(1), mc_samples=3,
                                  reduce="mean_std")
        names = [r.name for r in profiling.recorded()]
    finally:
        profiling.clear()
    assert names.count("bear.score.lookup") == 3
    assert names.count("bear.score.call") == 1


# --- the loaders at a sparse lag ------------------------------------------


def _lag16_model_dir(tmp_path):
    """A model directory at lag 16: a linear BEAR at seeded weights over
    the count TSVs of a sparse counter (groups: train, test)."""
    lag = 16
    reads, groups = _reads()
    counter = _count(SparseTransitionCounter([lag], n_groups=2, device="cpu"), reads, groups)
    data = tmp_path / "data"
    data.mkdir()
    counter.export_tsv(str(data / "counts"), lag)
    ar = get_ar_func("linear", lag, 4, {}, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(16)
    params = [0.3 * torch.randn(p.shape, generator=g, dtype=torch.float64)
              for p in ar.params_list()]
    cfg = configparser.ConfigParser()
    cfg.read_dict({
        "general": {"out_folder": str(tmp_path), "seed": "1", "precision": "float64"},
        "data": {"files_path": str(data), "start_token": "counts", "sparse": "False",
                 "num_ds": "2", "alphabet": "dna", "train_column": "0", "test_column": "1"},
        "hyperp": {"lag": str(lag)},
        "model": {"ar_func_name": "linear", "af_kwargs": "{}"},
    })
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)
    save_results(str(tmp_path), [np.asarray(-2.3)] + [p.numpy() for p in params])
    return str(tmp_path), _strings(reads[:1])[0][:30]


def test_from_model_dir_and_the_cli_take_a_lag16_model_dir(tmp_path, capsys):
    path, wt = _lag16_model_dir(tmp_path)
    server = BearServer.from_model_dir(path, dtype=torch.float64, device="cpu")
    assert server.lag == 16 and server._sparse is not None
    pos = np.repeat(np.arange(len(wt)), 3)
    alt = np.array([a for c in wt for a in "ACGT" if a != c])
    labels = [f"{wt[p]}{p}{a}" for p, a in zip(pos, alt)]
    got = server.delta_scores_snv(wt, pos, alt)
    want = get_bear_probs(path, wt, labels, 0, get_map=True, device="cpu")[:, 1]  # BEAR
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    capsys.readouterr()
    assert score_main(["snv", path, wt, "--all", "--torch-device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "variant\tBEAR" and len(lines) == 1 + len(labels)
    assert score_main(["variants", path, wt, labels[0], labels[5], "--map", "--device",
                       "--torch-device", "cpu"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
