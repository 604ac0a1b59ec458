"""What the held-out scoring drivers share: the plain reference's
concentrations of one call's reads. The context rows and next symbols of
every transition of the call's batch, the counts worked out again from the
training reads (float32), and the AR's probabilities from ``probs`` (one-hot
contexts [N, lag, A1] in float32, with products in full float32, or in TF32
where ``tf32`` asks), in slices of 2^18 rows, as (probabilities + 1e-7) / h
+ counts."""

from __future__ import annotations

import torch

from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model

SLICE_ROWS = 1 << 18


def concentrations(driver, i: int, probs, tf32: bool = False):
    """(batch [n, L], seq [E], rows [E], nxt [E], conc [E, A1]) of call
    ``i``'s reads, E = n (L + 1), by the plain reference; the counted
    training keys are kept on ``driver``."""
    cfg, dev = driver.run.config, driver.run.device
    lag, A = cfg["lag"], cfg["alphabet_size"]
    if not hasattr(driver, "_keys"):
        train = driver.groups == 0
        driver._keys, driver._n = ref_counts.count_keys(
            torch.as_tensor(driver.reads[train], device=dev),
            torch.zeros(int(train.sum()), dtype=torch.int32, device=dev), lag, 1, A)
    keys, n = driver._keys, driver._n
    batch = torch.as_tensor(driver.batches[i % len(driver.batches)], device=dev)
    rows, nxt = ref_counts.transition_rows(batch, lag, A)
    rows, nxt = rows.reshape(-1), nxt.reshape(-1)
    seq = torch.arange(batch.shape[0], device=dev).repeat_interleave(batch.shape[1] + 1)
    counts = torch.zeros((rows.numel(), A + 1), dtype=torch.float32, device=dev)
    for c in range(A + 1):
        want = rows * (A + 1) + c
        at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        counts[:, c] = torch.where(keys[at] == want, n[at], 0).float()
    conc = torch.empty_like(counts)
    h = cfg["model"]["serve_h"]
    with ref_model.matmul_precision(tf32), torch.no_grad():
        for s in range(0, rows.numel(), SLICE_ROWS):
            sl = slice(s, s + SLICE_ROWS)
            oh = ref_model.one_hot(ref_counts.decode(rows[sl], lag, A), A + 1, torch.float32)
            conc[sl] = (probs(oh) + ref_model.EPSILON) / h + counts[sl]
    return batch, seq, rows, nxt, conc
