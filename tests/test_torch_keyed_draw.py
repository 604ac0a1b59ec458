"""The keyed-draw kernel's module (bear_tpu_torch.ops.keyed_draw) on the CPU.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py holds it
against the plain version there). Here:

- a numpy model of the kernel's uint32 arithmetic (Philox4x32-10 with each
  64-bit product split into its high and low words, fold_in of int64 rows,
  the stream layout) equals the port's Philox, fold_in and stream_words bit
  for bit;
- a scalar model of the kernel's control flow (words drawn a block at a
  time, proposals only up to the first accepted one, the logsumexp summed in
  category order) equals the plain version: float64 at rtol 1e-12, float32
  at 2e-6 of the operands' scale, with no lane beyond;
- the plain version equals the composition the port ran before the kernel
  (fold_in, log_dirichlet_draw_keyed, the pick) bit for bit;
- against bear_tpu's _sampled_logp_picked by distribution (KS, moments):
  the two draw from different generators (Philox, threefry);
- CPU tensors run the plain version and launch nothing; other devices raise.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st

import chip_smoke
from bear_tpu.inference import serving as jserving
from bear_tpu.ops import loggamma as jloggamma
from bear_tpu_torch.inference import serving
from bear_tpu_torch.ops import keyed_draw
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops import loggamma
from bear_tpu_torch.ops.keyed_draw import keyed_draw_full, keyed_draw_picked, keyed_draw_plain
from test_torch_loggamma import PHILOX_KAT

torch.set_num_threads(2)
M32 = np.uint64(0xFFFFFFFF)
DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64)}


# -- the kernel's uint32 arithmetic, in numpy ------------------------------

def np_philox(counter, key):
    """Philox4x32-10 as the kernel computes it: uint32 words (held in
    uint64 arrays), each product's high word (__umulhi) and low word."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) & M32 for c in counter)
    k0, k1 = (np.asarray(k, np.uint64) & M32 for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = c0 * np.uint64(0xD2511F53)
        p1 = c2 * np.uint64(0xCD9E8D57)
        hi0, lo0 = p0 >> np.uint64(32), p0 & M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def np_split(x):
    """int64 -> (low, high) uint32 words, as the kernel reads them."""
    u = np.asarray(x, np.int64).view(np.uint64)
    return u & M32, u >> np.uint64(32)


def np_fold_in(keys, rows):
    w = np_philox((*np_split(rows), 0, 0), np_split(keys))
    return (w[0] | (w[1] << np.uint64(32))).view(np.int64)


def np_word(keys, sid, j):
    """Word j of stream sid under int64 keys: lane j % 4 of the block with
    counter (0, 0, sid, j // 4)."""
    return np_philox((0, 0, sid, j // 4), np_split(keys))[j % 4]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_numpy_philox_known_answers(counter, key, want):
    assert [int(w) for w in np_philox(counter, key)] == want


def test_numpy_philox_equals_the_port_bit_for_bit():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint64)
    c = [np.concatenate([edge, rng.integers(0, 1 << 32, 2000, dtype=np.uint64)])
         for _ in range(4)]
    k = [np.concatenate([edge[::-1], rng.integers(0, 1 << 32, 2000, dtype=np.uint64)])
         for _ in range(2)]
    want = kr.philox4x32([torch.from_numpy(x.astype(np.int64)) for x in c],
                         [torch.from_numpy(x.astype(np.int64)) for x in k])
    for a, b in zip(np_philox(c, k), want):
        np.testing.assert_array_equal(a.astype(np.int64), b.numpy())


def test_numpy_fold_in_and_streams_equal_the_port_bit_for_bit():
    rng = np.random.default_rng(1)
    i64 = np.iinfo(np.int64)
    keys = np.concatenate([[0, -1, i64.min, i64.max, 1 << 32],
                           rng.integers(i64.min, i64.max, 500, dtype=np.int64)])
    rows = np.concatenate([[0, -1, (1 << 31) + 5, -(1 << 40), 0xFFFFFFFF],
                           rng.integers(-(1 << 45), 1 << 45, 500)]).astype(np.int64)
    folded = np_fold_in(keys, rows)
    np.testing.assert_array_equal(folded, kr.fold_in(torch.from_numpy(keys),
                                                     torch.from_numpy(rows)).numpy())
    for A1, F in ((5, 3), (21, 6), (5, 1)):
        streams = [(kr.NORMAL, loggamma._pairs(F * A1)), (kr.EXPONENTIAL, F * A1),
                   (kr.BOOST, A1)]
        got = kr.stream_words(torch.from_numpy(folded), 0, streams)
        for (sid, n), words in zip(streams, got):
            want = np.stack([np_word(folded, sid, j) for j in range(n)], -1)
            np.testing.assert_array_equal(want.astype(np.int64), words.numpy())


# -- the kernel's control flow, as a scalar model --------------------------

def kernel_model(base, group, rows, conc, F, nxt, np_dtype):
    """csrc/keyed_draw.cu's algorithm for every (s, e) in numpy scalars of
    np_dtype: words a block at a time, each category's proposals only up to
    the first accepted one, the clamped last cube otherwise, the logsumexp
    in category order. Returns ([S, E] picked or [S, E, A1] full, the
    count of categories by the proposal that decided them: "first",
    "later" or "fallback")."""
    T = np_dtype
    S, (E, A1) = base.shape[0], conc.shape
    out = np.empty((S, E) if nxt is not None else (S, E, A1), T)
    paths = collections.Counter()

    def uniform(w):
        if T is np.float32:
            return (T(int(w) >> 9) + T(0.5)) * T(2.0**-23)
        return (T(int(w)) + T(0.5)) * T(2.0**-32)

    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        for s in range(S):
            for e in range(E):
                key = np_fold_in(base[s, group[e]], rows[e])
                cache = {}

                def word(sid, j):  # one cached block per stream
                    if cache.get(sid, (None,))[0] != j // 4:
                        cache[sid] = (j // 4, np_philox((0, 0, sid, j // 4), np_split(key)))
                    return cache[sid][1][j % 4]

                def normal(n):
                    m = n // 2
                    r = np.sqrt(T(-2.0) * np.log(uniform(word(kr.NORMAL, 2 * m))))
                    theta = T(2.0 * math.pi) * uniform(word(kr.NORMAL, 2 * m + 1))
                    return r * np.sin(theta) if n % 2 else r * np.cos(theta)

                lg = np.empty(A1, T)
                for a in range(A1):
                    c = T(conc[e, a])
                    safe = max(c, T(1e-30))
                    d = safe + T(1.0 - 1.0 / 3.0)
                    cc = T(1) / np.sqrt(T(9) * d)
                    v_fin = None
                    for f in range(F):
                        x = normal(f * A1 + a)
                        log_u = np.log(uniform(word(kr.EXPONENTIAL, f * A1 + a)))
                        t = T(1) + cc * x
                        v = t * t * t
                        vs = v if v > 0 else T(1)
                        if v > 0 and log_u < T(0.5) * x * x + d - d * vs + d * np.log(vs):
                            v_fin = vs
                            paths["first" if f == 0 else "later"] += 1
                            break
                    if v_fin is None:
                        v_fin = max(v, T(1e-3))
                        paths["fallback"] += 1
                    boost_e = -np.log(uniform(word(kr.BOOST, a)))
                    lg[a] = (np.log(d) + np.log(v_fin)) - boost_e / safe if c > 0 else -np.inf
                if nxt is None:
                    out[s, e] = lg
                    continue
                m = lg.max()
                m = T(0) if np.isinf(m) else m
                total = T(0)
                for a in range(A1):
                    total = total + np.exp(lg[a] - m)
                out[s, e] = lg[nxt[e]] - (np.log(total) + m)
    return out, paths


@pytest.mark.parametrize("A1", [5, 21])
@pytest.mark.parametrize("F", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["picked", "full"])
def test_kernel_model_equals_the_plain_version(A1, F, dtype, mode):
    inputs = chip_smoke.keyed_draw_inputs(A1, dtype, "cpu", shape=(2, 30, 7), seed=A1 + F)
    base, group, rows, conc, nxt = inputs
    torch_dtype, np_dtype = DTYPES[dtype]
    want = keyed_draw_plain(*inputs[:4], F, None if mode == "full" else nxt).double().numpy()
    got, paths = kernel_model(base.numpy(), group.numpy(), rows.numpy(), conc.numpy(), F,
                              None if mode == "full" else nxt.numpy(), np_dtype)
    got = got.astype(np.float64)
    # the inputs reach every branch: a rejected first proposal is then
    # decided by a later one, or with F = 1 by the clamped cube
    assert paths["first"] > 0 and paths["later" if F > 1 else "fallback"] > 0, paths
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = np.abs(want) + 1
    if mode == "picked":
        lse = torch.logsumexp(keyed_draw_plain(*inputs[:4], F), -1).double().numpy()
        scale += np.abs(lse)
    fin = np.isfinite(want)
    rel = np.abs(got[fin] - want[fin]) / scale[fin]
    assert rel.max() <= chip_smoke.KEYED_DRAW_RTOL[dtype], rel.max()


# -- the plain version is the composition the port ran before ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_equals_the_earlier_composition(dtype):
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(
        5, str(dtype).removeprefix("torch."), "cpu", shape=(4, 300, 9))
    rows32 = rows.to(torch.int32)  # serving's rows are int32
    for r in (rows, rows32):
        keys = loggamma.fold_in_many(base[:, group], r)
        lg = loggamma.log_dirichlet_draw_keyed(keys, conc, n_iter=serving.SAMPLE_PROPOSALS)
        idx = nxt.long().expand(lg.shape[:-1])[..., None]
        picked = lg.gather(-1, idx)[..., 0] - torch.logsumexp(lg, dim=-1)
        got = keyed_draw_picked(base, group, r, conc, nxt, serving.SAMPLE_PROPOSALS)
        assert got.dtype == dtype and torch.equal(got, picked)
        assert torch.equal(got, serving._sampled_logp_picked(keys, conc, nxt))
        assert torch.equal(keyed_draw_full(base, group, r, conc, serving.SAMPLE_PROPOSALS), lg)
    # assembly's form: base keys [1, B], group b, four proposals
    seq_keys = kr.fold_in(kr.key(7), torch.arange(300))
    lg = loggamma.log_dirichlet_draw_keyed(kr.fold_in(seq_keys, rows), conc, n_iter=4)
    got = keyed_draw_full(seq_keys[None], torch.arange(300), rows, conc, 4)
    assert got.shape == (1, 300, 5) and torch.equal(got[0], lg)
    assert torch.isneginf(got[0][conc == 0]).all()
    assert torch.isneginf(keyed_draw_picked(base, group, rows, conc, nxt, 3)[:, conc[
        torch.arange(300), nxt.long()] == 0]).all()


def test_serving_draws_slice_on_the_cpu_only(monkeypatch):
    assert serving._draw_bytes(5, 4, device_type="cuda") == 0
    assert serving._draw_bytes(5, 4) == serving._draw_bytes(5, 4, device_type="cpu") > 0
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float64", "cpu",
                                                                shape=(3, 100, 4))
    server = serving.BearServer(np.zeros((serving.table_rows(1), 5)), 1, van=0.1,
                                dtype=torch.float64, device="cpu")
    whole = server._draw_picked(base, group, rows, nxt, conc)
    monkeypatch.setattr(serving, "SAMPLE_BUDGET_BYTES", 3 * serving._draw_bytes(5, 8) * 7)
    assert torch.equal(server._draw_picked(base, group, rows, nxt, conc), whole)  # 7 a slice
    assert torch.equal(whole, keyed_draw_plain(base, group, rows, conc, 3, nxt))


# -- against bear_tpu, by distribution -------------------------------------

CONCS = [[1e-4, 0.5, 2.0, 30.0, 3e-4], [0.05, 0.05, 1e4, 1.0, 1e-4],
         [1.0, 1.0, 1.0, 1.0, 0.0]]


@pytest.mark.parametrize("conc", CONCS)
def test_picked_against_bear_tpu_by_distribution(conc):
    N = 20_000
    conc = np.asarray(conc)
    A1 = len(conc)
    c = np.broadcast_to(conc, (N, A1)).copy()
    base = kr.fold_in(kr.key(3), torch.arange(N))[None]
    jkeys = jloggamma.fold_in_many(jax.random.key(3), jnp.arange(N))
    for k in np.flatnonzero(conc > 0):
        got = keyed_draw_picked(base, torch.arange(N), torch.zeros(N, dtype=torch.int64),
                                torch.from_numpy(c), torch.full((N,), int(k)), 3).numpy()[0]
        want = np.asarray(jserving._sampled_logp_picked(
            jkeys, jnp.asarray(c), jnp.full((N,), int(k))), np.float64)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        assert st.ks_2samp(got, want).pvalue > 1e-3, (conc, k)
        se = np.sqrt(got.var() / N + want.var() / N)
        assert abs(got.mean() - want.mean()) < 5 * se, (conc, k)
        assert abs(np.log(got.var() / want.var())) < 0.1, (conc, k)
    zero = keyed_draw_picked(base, torch.arange(N), torch.zeros(N, dtype=torch.int64),
                             torch.from_numpy(c), torch.full((N,), A1 - 1), 3)
    assert bool(torch.isneginf(zero).all()) == (conc[-1] == 0)


# -- dispatch ---------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    inputs = chip_smoke.keyed_draw_inputs(21, "float32", "cpu", shape=(2, 50, 5))
    before = keyed_draw.launches
    got = keyed_draw_picked(*inputs[:4], inputs[4], 4)
    assert torch.equal(got, keyed_draw_plain(*inputs[:4], 4, inputs[4]))
    assert keyed_draw_full(*inputs[:4], 4).shape == (2, 50, 21)
    assert keyed_draw.launches == before


def test_other_devices_and_bad_inputs_raise():
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float32", "cpu",
                                                                shape=(2, 10, 3))
    meta = [t.to("meta") for t in (base, group, rows, conc, nxt)]
    with pytest.raises(ValueError, match="no path for device meta"):
        keyed_draw_picked(*meta[:4], meta[4], 3)
    with pytest.raises(ValueError, match="no path for device meta"):
        keyed_draw_full(*meta[:4], 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        keyed_draw_full(base, group, rows, conc.half(), 3)
    with pytest.raises(TypeError, match="int64 base keys"):
        keyed_draw_full(base.int(), group, rows, conc, 3)
    with pytest.raises(TypeError, match="integer nxt"):
        keyed_draw_picked(base, group, rows, conc, nxt.float(), 3)
    with pytest.raises(TypeError, match="integer rows"):
        keyed_draw_full(base, group, rows[:5], conc, 3)
    with pytest.raises(ValueError, match="categories"):
        keyed_draw_full(base, group, rows, torch.ones(10, 33), 3)
    with pytest.raises(ValueError, match="proposals"):
        keyed_draw_full(base, group, rows, conc, 0)
