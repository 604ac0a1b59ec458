"""Probability core (port of bear_tpu/ops/distributions.py).

Plain functions on tensors; autograd differentiates them (the backward of
``lgamma`` is ``digamma``).

- ``dirichlet_multinomial_perm_logpmf(counts, conc)`` is
  ``sum_b [lgamma(conc_b + n_b) - lgamma(conc_b)]
  - [lgamma(sum_conc + N) - lgamma(sum_conc)]``: the Dirichlet-multinomial
  likelihood of an ordered sequence of transitions, the per-k-mer term of
  the BEAR marginal likelihood.
- ``multinomial_perm_logpmf(counts, probs)`` is ``sum_b n_b log p_b``.
- ``ml_output`` is the argmax over the last axis with exact ties broken
  uniformly at random.
"""

from __future__ import annotations

import torch

# Regulariser added to AR probabilities wherever the reference adds one
# (bear_net.py:43 and :68 in the reference; load_bear's ar_apply).
EPSILON = 1e-7


def log_combinations(total_count, counts):
    """log multinomial coefficient: log(N! / prod_b n_b!)."""
    return torch.lgamma(total_count + 1.0) - torch.lgamma(counts + 1.0).sum(dim=-1)


def dirichlet_multinomial_perm_logpmf(counts, concentration):
    """Ordered Dirichlet-multinomial log-likelihood of transition counts.

    counts : [..., B] nonnegative counts (float).
    concentration : broadcastable to counts' shape; positive.
    Returns [...]: the broadcast batch shape of both, less the last axis.
    """
    total = counts.sum(dim=-1)
    sum_conc = concentration.sum(dim=-1)
    per_bucket = (torch.lgamma(concentration + counts)
                  - torch.lgamma(concentration)).sum(dim=-1)
    normalizer = torch.lgamma(sum_conc + total) - torch.lgamma(sum_conc)
    return per_bucket - normalizer


def multinomial_perm_logpmf(counts, probs):
    """Ordered multinomial log-likelihood: sum_b n_b log p_b (0 log 0 = 0)."""
    return torch.xlogy(counts, probs).sum(dim=-1)


def gumbel_noise(shape, generator: torch.Generator | None = None, device=None):
    """Standard Gumbel noise of ``shape`` in float32, from ``generator``."""
    return -torch.empty(shape, dtype=torch.float32, device=device
                        ).exponential_(generator=generator).log()


def ml_output(scores, generator: torch.Generator | None = None, gumbel=None):
    """Most likely transition: argmax over the last axis, as a float of
    scores' dtype. Exact ties are broken uniformly at random: Gumbel noise
    (``gumbel``, shaped like scores, else drawn from ``generator`` on
    scores' device) is consulted only among the entries equal to the row's
    maximum, so a row without ties gives its plain argmax."""
    top = scores.amax(dim=-1, keepdim=True)
    if gumbel is None:
        gumbel = gumbel_noise(scores.shape, generator, scores.device)
    masked = torch.where(scores == top, gumbel, -torch.inf)
    return masked.argmax(dim=-1).to(scores.dtype)


def ml_output_dm(concentration, generator: torch.Generator | None = None, gumbel=None):
    """ml_output for the Dirichlet-multinomial (reference core.py:69-71)."""
    return ml_output(concentration, generator, gumbel)


def ml_output_mult(probs, generator: torch.Generator | None = None, gumbel=None):
    """ml_output for the multinomial (reference core.py:134-136)."""
    return ml_output(probs, generator, gumbel)


def bmm_marginal_logpmf(counts, alpha):
    """Vanilla-BEAR (BMM) marginal likelihood of one batch of counts:
    ``lbeta(counts + alpha) - lbeta(alpha)`` for a symmetric Dirichlet prior
    per bucket, summed over the leading batch axis.

    counts : [batch, ..., B]; alpha : [num_alpha].
    Returns [..., num_alpha].
    """
    alpha = torch.as_tensor(alpha, dtype=counts.dtype, device=counts.device)
    expanded = counts[..., None, :] + alpha[:, None]
    zeros = torch.zeros_like(counts)[..., None, :] + alpha[:, None]

    def lbeta(v):
        return torch.lgamma(v).sum(dim=-1) - torch.lgamma(v.sum(dim=-1))

    return lbeta(expanded).sum(dim=0) - lbeta(zeros).sum(dim=0)
