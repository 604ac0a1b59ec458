"""vBEAR: a variational posterior over the concentration parameter h (port
of bear_tpu/models/vbear.py).

Empirical-Bayes BEAR fits a point estimate of h; vBEAR fits a mean-field
Gaussian posterior over log h,

    q(log h) = Normal(mu, sigma^2),   p(log h) = Normal(mu0, sigma0^2)

    ELBO = E_q [ sum_kmers log DM(counts | f(kmer) / h) ] - KL(q || p)

by the reparameterisation trick (one log h draw per optimizer apply),
jointly with the AR parameters. The spread of q says how identifiable the
misspecification scale is.

The draw of apply t is the standard normal of the port's keyed Philox
generator under ``fold_in(key(seed + 1), t)`` (bear_tpu keys JAX's draw the
same way), so a run is a function of its seed; the streams differ from
JAX's, so trajectories match bear_tpu's in distribution only. Batches are
stacked as ``bear_net.train`` stacks them and apply t takes batch
``t % steps_per_epoch``; Adam takes eps 1e-7. ``mesh`` is not ported yet
(ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from bear_tpu_torch.models import bear_net
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.utils.device import resolve_device


@dataclass
class VBearResult:
    params: dict  # {"h_mu", "h_log_sigma", "ar": [...]}: tensors on the device
    losses: np.ndarray  # -ELBO at each optimizer apply

    @property
    def h_posterior(self) -> tuple[float, float]:
        """(mu, sigma) of q(log h)."""
        return (float(bear_net._host(self.params["h_mu"])),
                float(np.exp(bear_net._host(self.params["h_log_sigma"]))))

    @property
    def h(self) -> float:
        """Posterior-median h = exp(mu)."""
        return float(np.exp(bear_net._host(self.params["h_mu"])))

    def h_samples(self, key, n: int) -> np.ndarray:
        """n draws of h from q, from the port's keyed generator under
        ``key`` (``keyed_random.key(seed)``)."""
        mu, sigma = self.h_posterior
        return np.exp(mu + sigma * _normals(key, n, torch.float64).numpy())


def _normals(key, n: int, dtype) -> torch.Tensor:
    """n standard normals under ``key`` (on the CPU)."""
    (words,) = kr.stream_words(key, 0, [(kr.NORMAL, n + n % 2)])
    return kr.normal(words, dtype)[:n]


def _eps(seed: int, n_apply: int, dtype, device) -> torch.Tensor:
    """The reparameterisation draws of applies 0..n_apply-1, made at once on
    ``device``: apply t's is the standard normal under
    ``fold_in(key(seed + 1), t)``."""
    keys = kr.fold_in(kr.key(seed + 1), torch.arange(n_apply, device=device))
    (words,) = kr.stream_words(keys, 0, [(kr.NORMAL, 2)])
    return kr.normal(words, dtype)[:, 0]


def _loss(params, ar_func, codes_b, counts_b, actual_size, eps, num_kmers, prior_mu,
          prior_sigma):
    """-ELBO of one batch at one draw ``eps`` of the reparameterised log h
    (bear_tpu/models/vbear.py:115-127): the batch's DM log-likelihood at
    h = exp(mu + sigma * eps), scaled by num_kmers / actual_size, minus
    KL(q || p)."""
    sigma = torch.exp(params["h_log_sigma"])
    log_h = params["h_mu"] + sigma * eps
    probs = ar_func.apply_codes(codes_b, params["ar"])
    ll = bear_net.bear_log_prob(counts_b, probs, torch.exp(log_h)).sum()
    expected_ll = (num_kmers / actual_size) * ll
    kl = (torch.log(prior_sigma / sigma)
          + (sigma**2 + (params["h_mu"] - prior_mu) ** 2) / (2.0 * prior_sigma**2)
          - 0.5)
    return -(expected_ll - kl)


def train_variational_h(codes, counts, num_kmers, ar_func, *, alphabet: str = "dna",
                        batch_size: int, epochs: int = 1, learning_rate: float = 0.01,
                        optimizer_name: str = "Adam", prior_mu: float = 0.0,
                        prior_sigma: float = 10.0, init_sigma: float = 0.1, seed: int = 0,
                        dtype=torch.float32, mesh=None, device="cuda") -> VBearResult:
    """Fit the AR parameters and a Gaussian variational posterior over log h.

    codes [N, lag] and counts [N, A+1] as ``bear_net.train``; the AR
    parameters start from ``ar_func.init(torch.Generator().manual_seed(seed))``,
    mu from 0 and sigma from ``init_sigma``. Runs on ``device``; "cuda"
    (default) raises without a card."""
    bear_net._not_ported(mesh=mesh)
    dev = resolve_device(device)
    init = ar_func.init(torch.Generator().manual_seed(seed))
    params = {
        "h_mu": torch.zeros((), dtype=dtype, device=dev),
        "h_log_sigma": torch.tensor(math.log(init_sigma), dtype=dtype, device=dev),
        "ar": [p.to(device=dev, dtype=dtype) for p in init],
    }
    leaves = [params["h_mu"], params["h_log_sigma"]] + params["ar"]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)  # every Adam state advances, as optax's
    optimizer = bear_net.make_optimizer(optimizer_name, learning_rate, leaves)

    codes, counts = bear_net._to_device(codes, counts, dtype, dev)
    codes_s, counts_s, sizes = bear_net._stack_batches(codes, counts, batch_size)
    steps_per_epoch = codes_s.shape[0]
    total_steps = steps_per_epoch * int(epochs)
    prior = (torch.tensor(float(prior_mu), dtype=dtype, device=dev),
             torch.tensor(float(prior_sigma), dtype=dtype, device=dev))
    eps = _eps(seed, total_steps, dtype, dev)
    losses = torch.empty(total_steps, dtype=dtype, device=dev)
    for t in range(total_steps):
        idx = t % steps_per_epoch
        optimizer.zero_grad(set_to_none=False)
        loss = _loss(params, ar_func, codes_s[idx], counts_s[idx], float(sizes[idx]), eps[t],
                     float(num_kmers), *prior)
        loss.backward()
        optimizer.step()
        losses[t] = loss.detach()
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return VBearResult(params=params, losses=losses.cpu().numpy())
