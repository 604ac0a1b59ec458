"""The port's vBEAR (bear_tpu_torch.models.vbear) against bear_tpu's, on the
CPU in float64.

The loss and its gradients at fixed parameters and a fixed draw eps are
held against the same terms composed from bear_tpu's ``bear_log_prob``
under ``jax.grad`` (rtol 1e-10). The draws come from each package's own
generator, so whole runs are compared by what they estimate: the
identifiable case of tests/test_vbear.py, and (slow) the YSD1 protocol,
whose posterior mean of log h must lie within 0.05 of bear_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bear_tpu.models import bear_net as jbn
from bear_tpu.models.ar_funcs import ARFunc, make_ar_func_linear
from bear_tpu.models.vbear import train_variational_h as jtrain_vh
from bear_tpu.ops import alphabets as jalphabets
from bear_tpu.parallel import data_parallel_mesh as jdata_parallel_mesh
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.models import bear_net, vbear
from bear_tpu_torch.models.ar_funcs import LinearAR
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.parallel import Mesh
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)


class UniformAR(nn.Module):
    """f = 1 / A1 everywhere, no parameters (tests/test_vbear.py's)."""

    def __init__(self, A1=5):
        super().__init__()
        self.A1 = A1

    def init(self, generator=None):
        return []

    def apply_codes(self, codes, params=None):
        return torch.full(tuple(codes.shape[:-1]) + (self.A1,), 1.0 / self.A1,
                          dtype=torch.float64)


def _juniform(A1=5):
    return ARFunc(init=lambda key: [],
                  apply=lambda params, oh: jnp.full(oh.shape[:-2] + (A1,), 1.0 / A1, oh.dtype),
                  name="uniform")


@pytest.mark.parametrize("eps", [-1.3, 0.0, 0.4, 2.2])
def test_loss_and_gradients_match_bear_tpu_terms(eps):
    rng = np.random.default_rng(0)
    n, lag = 70, 5
    codes = rng.integers(0, 4, (n, lag)).astype(np.int8)
    counts = rng.poisson(4.0, (n, 5)).astype(np.float64)
    counts[60:] = 0.0  # zero-padded rows add nothing
    jar = make_ar_func_linear(lag, 4, dtype=jnp.float64)
    ar_p = [np.asarray(p) for p in jar.init(jax.random.key(3))]
    mu, log_sigma, num_kmers, size, prior_mu, prior_sigma = -2.1, np.log(0.3), 900.0, 60.0, \
        0.5, 4.0

    def jloss(p):
        sigma = jnp.exp(p["h_log_sigma"])
        log_h = p["h_mu"] + sigma * eps
        probs = jar.apply(p["ar"], jalphabets.one_hot(codes, 5, jnp.float64))
        ll = jnp.sum(jbn.bear_log_prob(jnp.asarray(counts), probs, jnp.exp(log_h)))
        kl = (jnp.log(prior_sigma / sigma)
              + (sigma**2 + (p["h_mu"] - prior_mu) ** 2) / (2.0 * prior_sigma**2) - 0.5)
        return -((num_kmers / size) * ll - kl)

    jp = {"h_mu": jnp.asarray(mu), "h_log_sigma": jnp.asarray(log_sigma),
          "ar": [jnp.asarray(p) for p in ar_p]}
    want, want_g = jax.value_and_grad(jloss)(jp)

    ar = LinearAR(lag, 4, dtype=torch.float64, device="cpu")
    f64 = dict(dtype=torch.float64, requires_grad=True)
    p = {"h_mu": torch.tensor(mu, **f64), "h_log_sigma": torch.tensor(log_sigma, **f64),
         "ar": [torch.tensor(x, requires_grad=True) for x in ar_p]}
    got = vbear._loss(p, ar, torch.from_numpy(codes), torch.from_numpy(counts), size,
                      torch.tensor(eps, dtype=torch.float64), num_kmers,
                      torch.tensor(prior_mu, dtype=torch.float64),
                      torch.tensor(prior_sigma, dtype=torch.float64))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    np.testing.assert_allclose(float(p["h_mu"].grad), float(want_g["h_mu"]), rtol=1e-10)
    np.testing.assert_allclose(float(p["h_log_sigma"].grad), float(want_g["h_log_sigma"]),
                               rtol=1e-10)
    np.testing.assert_allclose(p["ar"][0].grad.numpy(), np.asarray(want_g["ar"][0]),
                               rtol=1e-10, atol=1e-12)


def test_draws_are_keyed_by_seed_and_apply():
    eps = vbear._eps(4, 50, torch.float64, "cpu")
    assert eps.shape == (50,) and torch.equal(eps, vbear._eps(4, 50, torch.float64, "cpu"))
    assert torch.equal(eps[:20], vbear._eps(4, 20, torch.float64, "cpu"))
    one = kr.fold_in(kr.key(5), 7)
    assert float(eps[7]) == float(vbear._normals(one, 1, torch.float64)[0])
    assert not torch.equal(eps, vbear._eps(5, 50, torch.float64, "cpu"))
    assert abs(float(eps.mean())) < 0.5 and 0.6 < float(eps.std()) < 1.4


def test_identifiable_case_matches_point_h_and_bear_tpu():
    # tests/test_vbear.py:23: counts drawn from the model itself (f uniform,
    # h = 0.5), so h is identifiable and q concentrates at the point estimate.
    rng = np.random.default_rng(0)
    n, A1, h_true = 512, 5, 0.5
    p = rng.dirichlet(np.full(A1, (1.0 / A1) / h_true), size=n)
    counts = np.stack([rng.multinomial(40, pi) for pi in p]).astype(np.float64)
    codes = rng.integers(0, 4, (n, 3)).astype(np.int8)
    kw = dict(num_kmers=n, batch_size=n, epochs=600, learning_rate=0.05)

    point = bear_net.train(codes, counts, ar_func=UniformAR(), train_ar=False,
                           dtype=torch.float64, device="cpu", **kw)
    vb = vbear.train_variational_h(codes, counts, ar_func=UniformAR(), dtype=torch.float64,
                                   device="cpu", **kw)
    mu, sigma = vb.h_posterior
    assert abs(np.log(point.h) - np.log(h_true)) < 0.2
    assert abs(mu - np.log(point.h)) < 3 * sigma + 0.05
    assert sigma < 0.2
    assert np.isfinite(vb.losses).all() and vb.losses.shape == (600,)
    samples = vb.h_samples(kr.key(0), 10)
    assert samples.shape == (10,) and np.array_equal(samples, vb.h_samples(kr.key(0), 10))
    assert vb.h == pytest.approx(np.exp(mu), rel=1e-15)
    jvb = jtrain_vh(codes, counts, ar_func=_juniform(), dtype=jnp.float64, **kw)
    jmu, jsigma = jvb.h_posterior
    assert abs(mu - jmu) < 3 * max(sigma, jsigma)
    assert sigma == pytest.approx(jsigma, rel=0.5)


def test_refusals():
    ar = UniformAR()
    codes, counts = np.zeros((4, 3), np.int8), np.ones((4, 5))
    # mesh= is ported: the draws are the run's without a mesh, and the
    # estimate is bear_tpu's over its 4 virtual devices, in distribution
    rng = np.random.default_rng(3)
    big = np.stack([rng.multinomial(25, p) for p in rng.dirichlet(np.full(5, 0.4), 256)])
    kw = dict(num_kmers=256, batch_size=64, epochs=20, learning_rate=0.05, seed=5)
    one = vbear.train_variational_h(codes[:1].repeat(256, 0), big.astype(np.float64), ar_func=ar,
                                    dtype=torch.float64, device="cpu", **kw)
    four = vbear.train_variational_h(codes[:1].repeat(256, 0), big.astype(np.float64),
                                     ar_func=ar, dtype=torch.float64, device="cpu",
                                     mesh=Mesh(["cpu"] * 4, ("data",)), **kw)
    np.testing.assert_allclose(four.losses, one.losses, rtol=1e-8)
    jvb = jtrain_vh(codes[:1].repeat(256, 0), big.astype(np.float64), ar_func=_juniform(),
                    dtype=jnp.float64, mesh=jdata_parallel_mesh(4), **kw)
    (mu, sigma), (jmu, jsigma) = four.h_posterior, jvb.h_posterior
    assert abs(mu - jmu) < 3 * max(sigma, jsigma)
    with pytest.raises(AttributeError):  # a mesh is a Mesh
        vbear.train_variational_h(codes, counts, 4, ar, batch_size=4, mesh=object(),
                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vbear.train_variational_h(codes, counts, 4, ar, batch_size=4)


@pytest.mark.slow
def test_ysd1_protocol_matches_bear_tpu():
    # docs/usage.md:176-185 and tests/test_vbear.py:52: linear, batch 1,500,
    # 3,000 applies, lr 0.01, seed 10.
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    kw = dict(num_kmers=ds.num_kmers, batch_size=1500, epochs=3000, learning_rate=0.01,
              seed=10)
    vb = vbear.train_variational_h(ds.codes, ds.counts[:, 0],
                                   ar_func=LinearAR(5, 4, dtype=torch.float64, device="cpu"),
                                   dtype=torch.float64, device="cpu", **kw)
    mu, sigma = vb.h_posterior
    assert abs(vb.h - 0.0433) / 0.0433 < 0.25 and sigma < 0.25
    jvb = jtrain_vh(ds.codes, ds.counts[:, 0],
                    ar_func=make_ar_func_linear(5, 4, dtype=jnp.float64), dtype=jnp.float64,
                    **kw)
    assert abs(mu - jvb.h_posterior[0]) < 0.05


def test_bear_tpu_result_carries_across():
    # bear_tpu's VBearResult.params dict (h_mu, h_log_sigma, ar) reads as the
    # port's result, and its AR list loads into the port's module and
    # computes what bear_tpu's does.
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    jar = make_ar_func_linear(5, 4, dtype=jnp.float64)
    jvb = jtrain_vh(ds.codes[:300], ds.counts[:300, 0], num_kmers=300, ar_func=jar,
                    batch_size=100, epochs=4, learning_rate=0.05, dtype=jnp.float64)
    got = vbear.VBearResult(params=jvb.params, losses=jvb.losses)
    assert got.h_posterior == jvb.h_posterior and got.h == jvb.h
    assert got.h_samples(kr.key(1), 5).shape == (5,)
    ar = LinearAR(5, 4, dtype=torch.float64, device="cpu")
    ar.load_params(jvb.params["ar"])
    want = np.asarray(jar.apply(jvb.params["ar"], jalphabets.one_hot(ds.codes[:50], 5,
                                                                      jnp.float64)))
    np.testing.assert_allclose(ar.apply_codes(torch.from_numpy(ds.codes[:50])).detach().numpy(),
                               want, rtol=1e-12)
