"""Whole-dataset BMM (vanilla-BEAR) marginal likelihood (port of
bear_tpu/data/likelihood.py)."""

from __future__ import annotations

import numpy as np
import torch

from bear_tpu_torch.ops.distributions import bmm_marginal_logpmf


def bmm_likelihood(counts, alpha, batch_size: int = 1 << 16, mesh=None, *, device="cuda"):
    """Exact BMM marginal likelihood of a dataset for a vector of priors.

    counts : [num_kmers, num_ds, alphabet_size+1] array or tensor.
    alpha : [num_alpha] symmetric Dirichlet concentrations.
    batch_size : k-mer rows per device step (bounds device memory).
    mesh : optional :class:`bear_tpu_torch.parallel.Mesh`: the batch rounds
        up to a multiple of the mesh's size, each batch (a single-batch
        dataset included) pads with zero rows to one, and entry i of the
        flat mesh takes the i-th slice of every batch (the mesh's devices
        decide where it runs; over processes, the totals are summed over
        the gloo group).

    Returns [num_ds, num_alpha] float64 log-likelihoods. Batches (and the
    entries' slices of each, in mesh order) are summed on the host in
    float64 whatever the counts' float type.
    """
    # Imported here: the parallel package imports the counting engine,
    # which imports this package.
    from bear_tpu_torch.parallel.mesh import DataSplit

    split = DataSplit(mesh, device)
    counts = torch.as_tensor(counts)
    if not counts.is_floating_point():
        counts = counts.to(torch.float64)
    alpha = np.asarray(alpha)
    alpha_on = {d: torch.as_tensor(alpha, dtype=counts.dtype, device=d)
                for _, d in split.entries}
    batch_size = split.pad(batch_size)
    total = np.zeros((counts.shape[1], alpha.shape[0]), dtype=np.float64)
    with torch.no_grad():
        for start in range(0, counts.shape[0], batch_size):
            batch = counts[start : start + batch_size]
            pad = split.pad(batch.shape[0]) - batch.shape[0]
            if pad:  # zero rows add exactly 0
                batch = torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))])
            for part in split.split(batch):
                total += bmm_marginal_logpmf(part, alpha_on[part.device]).cpu().numpy(
                    ).astype(np.float64)
    if split.spans:
        total = split.allreduce([torch.from_numpy(total)])[0].numpy()
    return total
