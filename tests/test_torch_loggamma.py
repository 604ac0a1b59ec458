"""The port's keyed generator and log-gamma sampler
(bear_tpu_torch.ops.keyed_random / .loggamma) on the CPU: Philox against
its known answers, words independent of how a call is cut, the
Marsaglia-Tsang core against bear_tpu's on the same numpy draws (float64,
rtol 1e-12), and bear_tpu's distribution oracles (tests/test_loggamma.py)
re-run on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st
from scipy.special import digamma, gammainc, logsumexp

from bear_tpu.ops import loggamma as jloggamma
from bear_tpu_torch.inference.serving import SAMPLE_PROPOSALS
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops import loggamma

torch.set_num_threads(2)
I64 = torch.int64

# Random123's known answers for Philox4x32-10 (kat_vectors): counter, key,
# output words.
PHILOX_KAT = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = kr.philox4x32([torch.tensor(c, dtype=I64) for c in counter],
                        [torch.tensor(k, dtype=I64) for k in key])
    assert [int(w) for w in got] == want
    # vectorised: the same block in every lane of a batch
    many = kr.philox4x32([torch.full((5, 3), c, dtype=I64) for c in counter],
                         [torch.tensor(k, dtype=I64) for k in key])
    for w, v in zip(many, want):
        assert bool((w == v).all())


def test_keys_round_trip_and_fold_in():
    for seed in (0, 1, -1, 2**63 - 1, -(2**63), 2**64 - 5, 123456789012345):
        k = kr.key(seed)
        lo, hi = kr.split_key(k)
        assert 0 <= int(lo) < 2**32 and 0 <= int(hi) < 2**32
        assert int(kr.join_words(lo, hi)) == int(k)
        assert int(k) % 2**64 == seed % 2**64
    base = kr.key(7)
    data = torch.arange(50)
    vec = kr.fold_in(base, data)
    assert [int(kr.fold_in(base, int(d))) for d in data] == vec.tolist()
    assert len(set(vec.tolist())) == 50
    assert kr.fold_in(kr.key(8), data).tolist() != vec.tolist()
    # 64-bit data: the high word is part of the counter
    assert int(kr.fold_in(base, 1)) != int(kr.fold_in(base, 1 + 2**32))


def test_words_identical_across_chunkings():
    keys = kr.fold_in(kr.key(3), torch.arange(1000))
    streams = [(kr.NORMAL, 16), (kr.EXPONENTIAL, 15), (kr.BOOST, 5)]
    full = kr.stream_words(keys, 0, streams)
    for step in (1, 7, 333):
        parts = [kr.stream_words(keys[s : s + step], 0, streams) for s in range(0, 1000, step)]
        for i in range(3):
            assert torch.equal(torch.cat([p[i] for p in parts]), full[i])
    # a stream's words do not depend on which other streams are drawn
    assert torch.equal(kr.stream_words(keys, 0, [(kr.EXPONENTIAL, 15)])[0], full[1])
    assert all(bool(((w >= 0) & (w <= kr.MASK)).all()) for w in full)
    # keyed draws: a slice of the keys gives the same draws
    conc = torch.rand(1000, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    whole = loggamma.log_dirichlet_draw_keyed(keys, conc)
    assert torch.equal(loggamma.log_dirichlet_draw_keyed(keys[100:300], conc[100:300]),
                       whole[100:300])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniforms_open_interval(dtype):
    words = torch.tensor([0, 1, 2**23, 2**31, kr.MASK - 1, kr.MASK], dtype=I64)
    u = kr.uniform(words, dtype)
    assert u.dtype == dtype and bool((u > 0).all()) and bool((u < 1).all())
    assert bool(torch.isfinite(kr.normal(words, dtype)).all())
    assert bool(torch.isfinite(kr.exponential(words, dtype)).all())


def test_mt_core_matches_bear_tpu():
    rng = np.random.default_rng(0)
    F, N = 4, 5000
    conc = np.concatenate([rng.uniform(1e-4, 50.0, N - 200), np.full(200, 1e-30)])
    x = rng.normal(size=(F, N))
    neg_log_u = rng.exponential(size=(F, N))
    # Lanes that reject every proposal (v <= 0, or a huge exponential)
    # take the clamped last cube; the remaining lanes mix acceptances.
    x[:, :50] = -40.0
    neg_log_u[:, 50:100] = 1e6
    got = loggamma._mt_boosted_log_gamma_t(torch.from_numpy(x), torch.from_numpy(neg_log_u),
                                           torch.from_numpy(conc)).numpy()
    want = np.asarray(jloggamma._mt_boosted_log_gamma_t(
        jnp.asarray(x), jnp.asarray(neg_log_u), jnp.asarray(conc)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # multi-dimensional trailing shape ([F, N, A]), as the keyed draw uses
    x3, e3, c3 = x.reshape(F, 1000, 5), neg_log_u.reshape(F, 1000, 5), conc.reshape(1000, 5)
    got3 = loggamma._mt_boosted_log_gamma_t(torch.from_numpy(x3), torch.from_numpy(e3),
                                            torch.from_numpy(c3)).numpy()
    np.testing.assert_allclose(got3, want.reshape(1000, 5), rtol=1e-12, atol=0)


def test_loggamma_ks():
    concs = np.array([0.01, 0.1, 0.5, 0.99, 1.0, 5.0, 100.0])
    n = 100000
    tiled = torch.tensor(np.tile(concs[:, None], (1, n)), dtype=torch.float32)
    samples = loggamma.log_gamma(kr.key(0), tiled).numpy()
    for i, conc in enumerate(concs):
        pvalue = st.kstest(np.exp(samples[i].astype(np.float64)), cdf="gamma",
                           args=[conc]).pvalue
        assert pvalue > 0.1 / 6, (conc, pvalue)


def test_loggamma_tiny_conc_no_underflow():
    samples = loggamma.log_gamma(kr.key(1), torch.full((1000,), 1e-4)).numpy()
    assert np.all(np.isfinite(samples))
    assert abs(np.mean(samples) - digamma(1e-4)) / abs(digamma(1e-4)) < 0.1


def test_loggamma_size_and_determinism():
    concs = torch.ones(3, 5)
    out = loggamma.log_gamma(kr.key(2), concs, size=(7,))
    assert out.shape == (7, 3, 5) and out.dtype == torch.float32
    assert torch.equal(out, loggamma.log_gamma(kr.key(2), concs, size=(7,)))
    assert not torch.equal(out, loggamma.log_gamma(kr.key(3), concs, size=(7,)))
    d64 = loggamma.log_gamma(kr.key(2), concs, size=(7,), dtype=torch.float64)
    assert d64.dtype == torch.float64
    lg = loggamma.log_dirichlet_draw(kr.key(4), torch.tensor([0.0, 1.0, 2.0]))
    assert bool(torch.isneginf(lg[0])) and bool(torch.isfinite(lg[1:]).all())


def test_dirichlet_log_moments():
    concs = np.array([4.1, 1.0, 1.0, 2.0, 0.9], np.float32)
    draws = loggamma.sample_dirichlet_log(kr.key(3), torch.from_numpy(concs),
                                          size=(200000,)).numpy()
    np.testing.assert_allclose(logsumexp(draws, axis=-1), 0.0, atol=1e-5)
    want = digamma(concs) - digamma(concs.sum())
    np.testing.assert_allclose(draws.mean(0), want, rtol=0.02)


def test_log_gamma_pdf_matches_change_of_variables():
    from scipy.stats import gamma as sp_gamma

    ys = np.linspace(-8.0, 3.0, 200)
    for c in (0.01, 0.3, 1.0, 7.5):
        want = sp_gamma.pdf(np.exp(ys), c) * np.exp(ys)
        np.testing.assert_allclose(loggamma.log_gamma_pdf(c, ys).numpy(), want,
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(loggamma.log_gamma_pdf(c, ys).numpy(),
                                   np.asarray(jloggamma.log_gamma_pdf(c, ys)), rtol=1e-12)


@pytest.mark.parametrize("n_iter", [3, 6])
def test_log_dirichlet_draw_keyed_ks_and_determinism(n_iter):
    assert SAMPLE_PROPOSALS in (3, 6)
    N = 60_000
    keys = loggamma.fold_in_many(kr.key(0), torch.arange(N))
    concs = [0.01, 0.1, 1.0, 30.0]
    conc_mat = torch.tensor(concs, dtype=torch.float32).expand(N, 4)
    lg = loggamma.log_dirichlet_draw_keyed(keys, conc_mat, n_iter=n_iter).double().numpy()
    for j, c in enumerate(concs):
        u = gammainc(c, np.exp(np.clip(lg[:, j], -700.0, 700.0)))
        p = st.kstest(u, "uniform").pvalue
        assert p > 0.1 / len(concs), (c, p)
    lg2 = loggamma.log_dirichlet_draw_keyed(keys, conc_mat, n_iter=n_iter).double().numpy()
    np.testing.assert_array_equal(lg, lg2)
    keys_b = loggamma.fold_in_many(kr.key(0), torch.arange(N) + N)
    lg3 = loggamma.log_dirichlet_draw_keyed(keys_b, conc_mat, n_iter=n_iter).numpy()
    assert not np.array_equal(lg, lg3)
    lgz = loggamma.log_dirichlet_draw_keyed(
        keys[:8], torch.tensor([[0.0, 1.0, 2.0, 0.5]] * 8), n_iter=n_iter).numpy()
    assert np.all(np.isneginf(lgz[:, 0])) and np.all(np.isfinite(lgz[:, 1:]))
    lgt = loggamma.log_dirichlet_draw_keyed_t(keys[:100], conc_mat[:100].T, n_iter=n_iter)
    np.testing.assert_array_equal(lgt.T.double().numpy(), lg[:100])


@pytest.mark.parametrize("n_iter", [3, 6])
def test_log_dirichlet_draw_keyed_dirichlet_moments(n_iter):
    N = 120_000
    crow = np.array([0.3, 2.0, 0.0, 5.0, 0.05], np.float32)
    keys = loggamma.fold_in_many(kr.key(3), torch.arange(N))
    lg = loggamma.log_dirichlet_draw_keyed(
        keys, torch.from_numpy(crow).expand(N, 5), n_iter=n_iter).double().numpy()
    p = np.exp(lg - logsumexp(lg, axis=1, keepdims=True))
    want = crow / crow.sum()
    np.testing.assert_allclose(p.mean(0), want, atol=3e-3)
    var_want = want * (1 - want) / (crow.sum() + 1)
    np.testing.assert_allclose(p.var(0), var_want, rtol=0.05, atol=1e-5)
