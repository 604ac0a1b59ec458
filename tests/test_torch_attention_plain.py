"""The port's attention AR function (bear_tpu_torch.models.ar_funcs.AttentionAR)
against the benchmark's plain reference (bench_gpu/reference/attention.py),
which is written from the block's equations and imports nothing of the port,
on the CPU from the benchmark's seeded weights (bench_gpu/weights_attention.py:
pos and every bias non-zero).

Tolerances, each with its reason:
- float64, relative 1e-12: the two sum the same products in another order
  (the reference computes every position's query and reads the last);
  the gaps seen are ~4e-16.
- float32, relative 1e-6: each side rounds in float32 in its own order; each
  lies ~1.6e-7 (about an ulp of the probabilities) from the float64 value of
  the same weights, so 1e-6 leaves three times the sum of the two.
- the server's MAP and sampled scores in float64 against the reference's
  concentrations and sampler, relative 1e-10: float64 sums of 31 terms in
  another order, and float64 draws from the same keys.
"""

import math

import pytest
import torch

from bear_tpu_torch.counting import ReadChunk, TransitionCounter
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models import ar_funcs
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import keyed_random
from bear_tpu_torch.utils import profiling
from bench_gpu import genome, weights_attention
from bench_gpu.reference import attention as ref_attention
from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler

torch.set_num_threads(2)
SMALL = {"d_model": 16, "num_heads": 4, "mlp_width": 32}
PUBLISHED = {"d_model": 64, "num_heads": 4, "mlp_width": 128}
RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}
SEED = 2**31 + 29


def _config(lag, widths):
    return {"lag": lag, "alphabet_size": 4, "model": dict(widths)}


def _ar(lag, widths, dtype, seed=SEED):
    """The port's attention AR at the seeded weights, and the weights."""
    params = weights_attention.make_params(_config(lag, widths), seed, "cpu", dtype)
    ar = get_ar_func("attention", lag, 4, widths, dtype=dtype, device="cpu")
    ar.load_params(params[1:])
    ar.requires_grad_(False)
    return ar, params[1:]


def _rel(got, want):
    return float(((got.double() - want.double()).abs() / want.double().abs()).max())


def test_seeded_weights_have_no_zero_leaf_and_follow_the_init_scales():
    params = weights_attention.make_params(_config(13, PUBLISHED), SEED, "cpu")
    assert float(params[0]) == 0.0  # h_signed: h = 1
    names = ar_funcs.AttentionAR.PARAM_NAMES
    shapes = [tuple(p.shape) for p in params[1:]]
    assert shapes == weights_attention.ar_shapes(_config(13, PUBLISHED))
    for name, p in zip(names, params[1:]):
        assert bool((p != 0).all()), name
    embed, w2, w_out = params[1], params[7], params[9]
    for w in (embed, w2, w_out):  # 0.05 x l2-normalised over the first axis
        torch.testing.assert_close(w.norm(dim=0), torch.full((w.shape[1],), 0.05))
    again = weights_attention.make_params(_config(13, PUBLISHED), SEED, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(params, again))


@pytest.mark.parametrize("entry", ["forward", "apply_codes"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("widths", [SMALL, PUBLISHED], ids=["16-4-32", "64-4-128"])
@pytest.mark.parametrize("lag", [6, 13])
def test_attention_ar_matches_the_plain_reference(lag, widths, dtype, entry):
    ar, params = _ar(lag, widths, dtype)
    codes = torch.randint(0, 5, (300, lag), generator=torch.Generator().manual_seed(lag))
    oh = ref_model.one_hot(codes, 5, dtype)
    want = ref_attention.attention_probs(oh, params, widths["num_heads"])
    with torch.no_grad():
        got = ar(oh) if entry == "forward" else ar.apply_codes(codes)
    assert got.dtype == dtype and got.shape == (300, 5)
    assert _rel(got, want) <= RTOL[dtype]


def _tiny_server(lag=6):
    """A lag-``lag`` table counted from a 20 kb genome's training reads, a
    float64 server over it with the attention AR at the seeded weights, and
    what the reference needs."""
    reads, groups = genome.synth_reads(SEED, 0.02, 2, 30, 0.25, template_len=2000)
    counter = TransitionCounter(lags=[lag], n_groups=2, device="cpu")
    for arrays in genome.chunk_arrays(reads, groups, 64):
        counter.add_chunk(ReadChunk(*arrays))
    ar, params = _ar(lag, SMALL, torch.float64)
    server = BearServer(counter.table(lag)[0], lag, h=0.05,
                        ar_apply=lambda oh: ar(oh) + ref_model.EPSILON,
                        dtype=torch.float64, device="cpu")
    return server, reads, groups, params


def _reference_concentrations(reads, groups, batch, lag, params, h=0.05):
    """(seq, rows, nxt, conc) of every transition of ``batch`` in float64:
    the counts worked out again from the training reads, the reference's
    probabilities + 1e-7 over h."""
    train = groups == 0
    keys, n = ref_counts.count_keys(torch.as_tensor(reads[train]),
                                    torch.zeros(int(train.sum()), dtype=torch.int32), lag, 1)
    rows, nxt = ref_counts.transition_rows(torch.as_tensor(batch), lag)
    rows, nxt = rows.reshape(-1), nxt.reshape(-1)
    seq = torch.arange(batch.shape[0]).repeat_interleave(batch.shape[1] + 1)
    counts = torch.zeros((rows.numel(), 5), dtype=torch.float64)
    for c in range(5):
        want = rows * 5 + c
        at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        counts[:, c] = torch.where(keys[at] == want, n[at], 0).double()
    oh = ref_model.one_hot(ref_counts.decode(rows, lag), 5, torch.float64)
    probs = ref_attention.attention_probs(oh, params, SMALL["num_heads"])
    return seq, rows, nxt, (probs + ref_model.EPSILON) / h + counts


def _strings(batch):
    return ["".join("ACGT"[c] for c in read) for read in batch]


@pytest.mark.parametrize("mode", ["map", "sample"])
def test_server_scores_match_the_reference(mode):
    server, reads, groups, params = _tiny_server()
    batch = reads[groups == 1][:16]
    seq, rows, nxt, conc = _reference_concentrations(reads, groups, batch, 6, params)
    if mode == "map":
        got = server.score(_strings(batch), mode="map")
        logp = torch.log(conc / conc.sum(dim=-1, keepdim=True)).gather(-1, nxt[:, None])[:, 0]
        want = torch.zeros(len(batch), dtype=torch.float64).index_add_(0, seq, logp)
    else:
        key = ref_sampler.as_key(SEED + 1)
        got = server.score(_strings(batch), mode="sample", key=keyed_random.key(key),
                           mc_samples=5, reduce="none")
        want = ref_sampler.sampled_scores(key, 5, seq, rows, nxt, conc, len(batch), 3)
    assert _rel(torch.as_tensor(got), want) <= 1e-10


@pytest.mark.parametrize("mode", ["map", "sample"])
def test_attention_span_once_per_ar_slice_and_rows_counted(monkeypatch, mode):
    server, reads, groups, _ = _tiny_server()
    batch = reads[groups == 1][:16]
    monkeypatch.setattr(serving, "AR_SLICE_ROWS", 64)
    before = ar_funcs.attention_rows
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            if mode == "map":
                server.score(_strings(batch), mode="map")
            else:
                server.score(_strings(batch), mode="sample", key=keyed_random.key(3),
                             mc_samples=2, reduce="mean_std")
        names = [r.name for r in profiling.recorded()]
    finally:
        profiling.clear()
    if mode == "map":  # every position of the padded [16, 64 + 1] windows, in one AR call
        windows, calls = 16 * 65, 1
    else:  # the masked-in windows, 16 x (30 + 1), in slices of 64 rows
        windows, calls = 16 * 31, math.ceil(16 * 31 / 64)
    assert names.count("bear.ar.attention") == calls
    assert names.count("bear.score.call") == 1
    assert ar_funcs.attention_rows - before == windows


def test_rows_are_counted_without_a_profiler_and_no_span_is_kept():
    ar, _ = _ar(6, SMALL, torch.float32)
    profiling.clear()
    before = ar_funcs.attention_rows
    with torch.no_grad():
        ar.apply_codes(torch.zeros((7, 3, 6), dtype=torch.int64))
    assert ar_funcs.attention_rows - before == 21
    assert profiling.recorded() == []
