"""The port's protein BEAR over ragged proteins (the counter and
``BearServer`` over the ``prot`` alphabet, the CNN AR at A1 21) against the
benchmark's plain reference (bench_gpu/reference/ragged.py and model.py,
which import nothing of the port), on the CPU, from a small seeded proteome
(bench_gpu/proteome.py: lengths 1-40) and the benchmark's seeded weights.

At lag 3 the table is counted from the training proteins. At lag 6 the
table (67.4M rows x 21) is too large for a test on the CPU, so the server
holds an empty one, a zero row broadcast over every row (no memory): the
deep rows' math, the AR and the draws are compared, the counts are zero on
both sides.

Tolerances, each with its reason:
- the counted table: exact (integer counts).
- the CNN AR in float64, relative 1e-12: the two sum the same products in
  another order (the gaps seen are ~5e-16).
- the CNN AR in float32, relative 1e-6: each side rounds in float32 in its
  own order; the port lies up to ~2.2e-7 (about two ulps of the
  probabilities) from the float64 value, the two sides up to ~2.6e-7 from
  each other, so 1e-6 leaves about twice the sum of two such gaps.
- scores in float64, relative 1e-10: float64 sums of up to 41 terms in
  another order, and float64 draws from the same keys.
- MAP scores in float32, relative 1e-5: float32 rounding of the
  concentrations and of up to 41 log terms a protein (the gaps seen are
  ~1e-7).
"""

import numpy as np
import pytest
import torch

from bear_tpu_torch.counting import TransitionCounter, chunk_reads, table_rows
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops import keyed_random
from bear_tpu_torch.utils import profiling
from bench_gpu import proteome, weights
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import ragged
from bench_gpu.reference import sampler as ref_sampler

torch.set_num_threads(2)
A = 20
WIDTHS = {"num_filters": 30, "filter_width": 3, "kmer_layer1_width": 16}  # bear_cnn_bear.cfg
RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}
SEED = 2**31 + 37
H = 0.05


def _config(lag):
    return {"lag": lag, "alphabet_size": A, "model": {"ar_func": "cnn", **WIDTHS}}


def _ar(lag, dtype):
    """The port's CNN AR at the seeded weights, and the weights."""
    params = weights.make_params(_config(lag), SEED, "cpu", dtype)
    ar = get_ar_func("cnn", lag, A, WIDTHS, dtype=dtype, device="cpu")
    ar.load_params(params[1:])
    ar.requires_grad_(False)
    return ar, params[1:]


def _rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(((got - want).abs() / want.abs()).max())


def _proteins():
    """A small proteome: 100 proteins of 1-40 residues in 20 families."""
    return proteome.synth_proteome(SEED, 20, 5, 15, 0.8, 1, 40, 0.3, 0.25)


def _count(residues, lengths, groups, lag):
    counter = TransitionCounter(lags=[lag], n_groups=1, alphabet="prot", device="cpu")
    codes = proteome.sequences(residues, lengths)
    for chunk in chunk_reads(((codes[k], 0) for k in np.flatnonzero(groups == 0)), lag,
                             batch_size=16):
        counter.add_chunk(chunk)
    return counter


def _train_keys(residues, lengths, groups, lag):
    res, lens = proteome.select(residues, lengths, np.flatnonzero(groups == 0))
    return ragged.count_keys(torch.as_tensor(res), torch.as_tensor(lens), lag, A)


@pytest.mark.parametrize("lag", [3, 4])
def test_counter_table_of_ragged_proteins_equals_the_plain_count(lag):
    residues, lengths, groups = _proteins()
    assert lengths.min() >= 1 and lengths.max() <= 40 and len(set(lengths.tolist())) > 10
    table = _count(residues, lengths, groups, lag).table(lag)[0]
    want = ragged.dense_table(*_train_keys(residues, lengths, groups, lag), lag, A)
    assert table.shape == (table_rows(lag, A), A + 1)
    assert torch.equal(table.to(torch.int64), want)
    assert int(want.sum()) == int((lengths[groups == 0] + 1).sum())


@pytest.mark.parametrize("entry", ["forward", "apply_codes"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("lag", [3, 6])
def test_cnn_ar_at_a1_21_matches_the_plain_reference(lag, dtype, entry):
    ar, params = _ar(lag, dtype)
    codes = torch.randint(0, A + 1, (400, lag), generator=torch.Generator().manual_seed(lag))
    oh = ref_model.one_hot(codes, A + 1, dtype)
    want = ref_model.cnn_probs(oh, params)
    with torch.no_grad():
        got = ar(oh) if entry == "forward" else ar.apply_codes(codes)
    assert got.dtype == dtype and got.shape == (400, A + 1)
    assert _rel(got, want) <= RTOL[dtype]


def test_ragged_encode_of_protein_strings_equals_encode_string_per_string():
    residues, lengths, _ = _proteins()
    strs = proteome.strings(residues, lengths)
    server = BearServer(np.zeros((table_rows(1, A), A + 1)), 1, van=1.0, alphabet="prot",
                        device="cpu")
    before = serving.uniform_encodes
    got = server._encode_ragged(strs, lengths, 64)
    assert serving.uniform_encodes == before  # the ragged form
    want = np.zeros((len(strs), 64), np.int8)
    for k, s in enumerate(strs):
        want[k, :len(s)] = alphabets.encode_string(s, "prot")
    assert got.dtype == np.int8 and np.array_equal(got, want)
    rows = [got[k, :n] for k, n in enumerate(lengths.tolist())]
    assert np.array_equal(np.concatenate(rows), residues)  # the proteome's own codes


def _server_and_reference(lag, dtype):
    """(server, strings of 16 held-out proteins, (seq, rows, nxt, conc) of
    the reference in float64)."""
    residues, lengths, groups = _proteins()
    ar, params = _ar(lag, dtype)
    if lag <= 4:
        table = _count(residues, lengths, groups, lag).table(lag)[0]
        keys, n = _train_keys(residues, lengths, groups, lag)
    else:
        table = torch.zeros((1, A + 1), dtype=dtype).expand(table_rows(lag, A), A + 1)
        keys, n = torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64)
    server = BearServer(table, lag, h=H, ar_apply=lambda oh: ar(oh) + ref_model.EPSILON,
                        dtype=dtype, alphabet="prot", device="cpu")
    batch = np.flatnonzero(groups == 1)[:16]
    res, lens = proteome.select(residues, lengths, batch)
    assert len(set(lens.tolist())) > 5
    seq, rows, nxt = ragged.transitions(torch.as_tensor(res), torch.as_tensor(lens), lag, A)
    params64 = [p.double() for p in params]  # the server's weights, in float64
    conc = ragged.concentrations(rows, keys, n, lambda oh: ref_model.cnn_probs(oh, params64),
                                 lag, A, H, dtype=torch.float64)
    return server, proteome.strings(res, lens), (seq, rows, nxt, conc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("lag", [3, 6])
def test_map_scores_of_ragged_proteins_match_the_reference(lag, dtype):
    server, strs, (seq, _, nxt, conc) = _server_and_reference(lag, dtype)
    got = server.score(strs, mode="map")
    want = ragged.map_scores(seq, nxt, conc, len(strs))
    assert _rel(got, want) <= (1e-10 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("lag", [3, 6])
def test_mc41_mean_std_of_ragged_proteins_match_the_reference(lag):
    server, strs, (seq, rows, nxt, conc) = _server_and_reference(lag, torch.float64)
    key = ref_sampler.as_key(SEED + lag)
    got = server.score(strs, mode="sample", key=keyed_random.key(key), mc_samples=41,
                       reduce="mean_std")
    want = ragged.sampled_mean_std(key, 41, seq, rows, nxt, conc, len(strs),
                                   serving.SAMPLE_PROPOSALS)
    assert got.shape == (len(strs), 2)
    assert _rel(got, want) <= 1e-10


def test_reference_transitions_of_equal_lengths_are_the_counts_reference():
    """ragged.transitions over proteins of one length gives what
    reference/counts.py gives for equal-length reads (its A = 20)."""
    from bench_gpu.reference import counts as ref_counts

    batch = torch.randint(0, A, (7, 9), generator=torch.Generator().manual_seed(3))
    seq, rows, nxt = ragged.transitions(batch.reshape(-1), torch.full((7,), 9), 4, A)
    want_rows, want_nxt = ref_counts.transition_rows(batch, 4, A)
    assert torch.equal(rows, want_rows.reshape(-1)) and torch.equal(nxt, want_nxt.reshape(-1))
    assert torch.equal(seq, torch.arange(7).repeat_interleave(10))


@pytest.mark.parametrize("mode", ["mean_std", "one_sample", "map"])
def test_padded_positions_counted_and_assemble_span_once_per_sampled_call(mode):
    server, strs, _ = _server_and_reference(3, torch.float32)
    maxlen = -(-max(map(len, strs)) // 64) * 64  # score's padded width
    before = serving.padded_positions
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(2):
                if mode == "map":
                    server.score(strs, mode="map")
                elif mode == "one_sample":
                    server.score(strs, mode="sample", key=keyed_random.key(5))
                else:
                    server.score(strs, mode="sample", key=keyed_random.key(5), mc_samples=41,
                                 reduce="mean_std")
        names = [r.name for r in profiling.recorded()]
    finally:
        profiling.clear()
    sampled = mode != "map"
    assert serving.padded_positions - before == 2 * sampled * len(strs) * (maxlen + 1)
    assert names.count("bear.score.assemble") == 2 * sampled
    assert names.count("bear.score.call") == 2
    # Without a profiler the counter still counts, and no span is kept.
    server.score(strs, mode="sample", key=keyed_random.key(6), mc_samples=2)
    assert serving.padded_positions - before == (2 * sampled + 1) * len(strs) * (maxlen + 1)
    assert profiling.recorded() == []
