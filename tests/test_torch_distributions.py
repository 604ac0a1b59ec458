"""The port's probability core (bear_tpu_torch.ops.distributions, and the
model's two likelihoods in bear_net) against bear_tpu's, on the CPU in
float64.

Tolerances: log-pmf values rtol 1e-12 (both sum the same lgamma terms,
XLA's and libm's lgamma differ by a few ulps); gradients against jax.grad
rtol 1e-10 (digamma implementations differ likewise). ml_output: exact
argmax on tie-free rows; on tied rows each maximum is picked with frequency
1/k within 5 sigma over 2,000 seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import bear_net as jbn
from bear_tpu.ops import distributions as jd
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.ops import distributions as pd

torch.set_num_threads(2)


def _inputs(seed, shape=(64, 5)):
    """Counts with many zeros, and concentrations spanning 1e-4 .. 1e3."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, size=shape).astype(np.float64)
    counts[rng.random(shape) < 0.4] = 0.0
    counts[0] = 0.0  # an all-zero row
    conc = 10.0 ** rng.uniform(-4, 3, size=shape)
    conc[1] = 1e-4
    return counts, conc


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_dm_multinomial_logcomb_values(seed):
    counts, conc = _inputs(seed)
    probs = conc / conc.sum(-1, keepdims=True)
    probs[2, 0] = 0.0  # 0 * log 0 = 0 where the count is 0 too
    counts[2, 0] = 0.0
    pairs = [
        (pd.dirichlet_multinomial_perm_logpmf(_t(counts), _t(conc)),
         jd.dirichlet_multinomial_perm_logpmf(counts, conc)),
        (pd.multinomial_perm_logpmf(_t(counts), _t(probs)),
         jd.multinomial_perm_logpmf(counts, probs)),
        (pd.log_combinations(_t(counts.sum(-1)), _t(counts)),
         jd.log_combinations(counts.sum(-1), counts)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
    assert float(pd.dirichlet_multinomial_perm_logpmf(_t(counts[:1]), _t(conc[:1]))) == 0.0


def test_dm_broadcasts_like_bear_tpu():
    # The evaluation's BMM reading: counts [B, 1, A1] against priors [V, A1].
    counts, _ = _inputs(2)
    conc = np.array([[0.1] * 5, [1.0] * 5, [10.0] * 5])
    got = pd.dirichlet_multinomial_perm_logpmf(_t(counts)[:, None, :], _t(conc))
    want = jd.dirichlet_multinomial_perm_logpmf(counts[:, None, :], conc)
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
def test_bmm_marginal_logpmf(seed):
    counts, _ = _inputs(seed, shape=(50, 3, 5))
    alpha = np.array([1e-4, 0.1, 1.0, 10.0])
    got = pd.bmm_marginal_logpmf(_t(counts), alpha)
    want = jd.bmm_marginal_logpmf(counts, alpha)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("seed", [5, 6])
def test_gradients_match_jax_grad(seed):
    counts, conc = _inputs(seed)
    probs = conc / conc.sum(-1, keepdims=True)
    cases = [
        (pd.dirichlet_multinomial_perm_logpmf, jd.dirichlet_multinomial_perm_logpmf, conc),
        (pd.multinomial_perm_logpmf, jd.multinomial_perm_logpmf, probs),
    ]
    for pf, jf, x in cases:
        xt = _t(x).requires_grad_(True)
        (pf(_t(counts), xt) * torch.arange(1.0, 65.0, dtype=torch.float64)).sum().backward()
        want = jax.grad(lambda c: jnp.sum(jf(counts, c) * jnp.arange(1.0, 65.0)))(x)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-10)


def test_ml_output_tie_free_is_argmax():
    rng = np.random.default_rng(7)
    scores = rng.normal(size=(500, 5))
    got = pd.ml_output(_t(scores), torch.Generator().manual_seed(0))
    want = jd.ml_output(scores, jax.random.key(0))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), scores.argmax(-1))


def test_ml_output_ties_uniform_among_maxima():
    # Row r has its maxima at `tied[r]` (k = 2, 3, 5); never elsewhere.
    scores = np.array([[1.0, 3.0, 3.0, 0.0, -1.0],
                       [2.0, 0.5, 2.0, 2.0, 1.0],
                       [4.0, 4.0, 4.0, 4.0, 4.0]])
    tied = [[1, 2], [0, 2, 3], [0, 1, 2, 3, 4]]
    n = 2000
    picks = np.stack([
        pd.ml_output(_t(scores), torch.Generator().manual_seed(s)).numpy().astype(int)
        for s in range(n)])
    for r, maxima in enumerate(tied):
        assert set(np.unique(picks[:, r])) <= set(maxima)
        k = len(maxima)
        sigma = np.sqrt(n * (1 / k) * (1 - 1 / k))
        for m in maxima:
            assert abs(np.sum(picks[:, r] == m) - n / k) <= 5 * sigma


@pytest.mark.parametrize("condition", [False, True])
def test_bear_and_ar_log_prob_values_and_gradients(condition):
    # The model's two likelihoods (bear_net.bear_log_prob / ar_log_prob) on
    # top of the log-pmfs, with gradients in the AR probabilities and in h.
    counts, conc = _inputs(8)
    probs = conc / conc.sum(-1, keepdims=True)
    cond = counts[::-1].copy() if condition else None
    h = 0.07
    pt, ht = _t(probs).requires_grad_(True), _t(h).requires_grad_(True)
    got = bear_net.bear_log_prob(_t(counts), pt, ht, None if cond is None else _t(cond))
    want = jbn.bear_log_prob(counts, probs, h, cond)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12)
    got.sum().backward()
    jg = jax.grad(lambda p, hh: jnp.sum(jbn.bear_log_prob(counts, p, hh, cond)),
                  argnums=(0, 1))(probs, h)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg[0]), rtol=1e-10)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg[1]), rtol=1e-10)
    np.testing.assert_allclose(bear_net.ar_log_prob(_t(counts), _t(probs)).numpy(),
                               np.asarray(jbn.ar_log_prob(counts, probs)), rtol=1e-12)
