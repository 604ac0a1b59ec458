"""Whole-dataset BMM (vanilla-BEAR) marginal likelihood (port of
bear_tpu/data/likelihood.py, without ``mesh=``)."""

from __future__ import annotations

import numpy as np
import torch

from bear_tpu_torch.ops.distributions import bmm_marginal_logpmf
from bear_tpu_torch.utils.device import resolve_device


def bmm_likelihood(counts, alpha, batch_size: int = 1 << 16, *, device="cuda"):
    """Exact BMM marginal likelihood of a dataset for a vector of priors.

    counts : [num_kmers, num_ds, alphabet_size+1] array or tensor.
    alpha : [num_alpha] symmetric Dirichlet concentrations.
    batch_size : k-mer rows per device step (bounds device memory).

    Returns [num_ds, num_alpha] float64 log-likelihoods. Batches are summed
    on the host in float64 whatever the counts' float type.
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts)
    if not counts.is_floating_point():
        counts = counts.to(torch.float64)
    alpha_t = torch.as_tensor(np.asarray(alpha), dtype=counts.dtype, device=dev)
    total = np.zeros((counts.shape[1], alpha_t.shape[0]), dtype=np.float64)
    with torch.no_grad():
        for start in range(0, counts.shape[0], batch_size):
            batch = counts[start : start + batch_size].to(dev)
            total += bmm_marginal_logpmf(batch, alpha_t).cpu().numpy().astype(np.float64)
    return total
