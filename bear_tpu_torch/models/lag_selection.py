"""Lag (truncation level) selection by maximum BMM marginal likelihood
(port of bear_tpu/models/lag_selection.py).

The reference documents choosing the lag by maximising the vanilla-BEAR
marginal likelihood across lags; the counting engine counts every lag in one
pass, so selection is one sweep over the tables. The sweep runs where the
counts are: on the card it reads the counter's resident device table (row
totals, the nonzero rows, one gather per block of rows) and takes
``torch.lgamma`` in float64 there, with float64 sums, so no host copy of
the tables is ever made. Only nonzero rows contribute (a zero-count row's
term is exactly 0).

``select_lag_sparse`` sweeps a counter with a sparse host accumulator
(multi-pass and sparse-first counting, lags 14-30): its nonzero rows go to
the counter's device in blocks and the same float64 sums run there.
"""

from __future__ import annotations

import glob
import json
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from bear_tpu_torch.utils.device import resolve_device


@dataclass
class LagSelection:
    lags: tuple
    log_marginals: np.ndarray  # [num_lags, num_alpha]
    alphas: np.ndarray

    @property
    def best(self) -> int:
        """Lag maximising the marginal likelihood (at the best alpha)."""
        return int(self.lags[int(np.argmax(self.log_marginals.max(axis=-1)))])

    def best_alpha(self, lag: int) -> float:
        i = self.lags.index(lag)
        return float(self.alphas[int(np.argmax(self.log_marginals[i]))])


def _marginal(counts: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """[num_alpha] float64 sum over rows of lbeta(counts + alpha) -
    lbeta(alpha), on the counts' device."""
    c = counts.to(torch.float64)[:, None, :] + alphas[None, :, None]  # [n, a, A+1]
    a = alphas[:, None].expand(-1, counts.shape[-1])  # [a, A+1]
    prior = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
    return ((torch.lgamma(c).sum(-1) - torch.lgamma(c.sum(-1))) - prior).sum(dim=0)


def _alphas(alphas, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(list(alphas), dtype=np.float64), device=device)


def marginal_from_counts(counts, alphas, device="cuda") -> np.ndarray:
    """Exact BMM log marginal likelihood of count rows [n, A+1] for each
    alpha: sum over rows of [lbeta(counts + alpha) - lbeta(alpha)], in
    float64 on ``device`` (a tensor's own device when ``counts`` is one).
    Returns [num_alpha]."""
    if isinstance(counts, torch.Tensor):
        dev = counts.device
    else:
        dev = resolve_device(device)
        counts = torch.as_tensor(np.asarray(counts, dtype=np.float64), device=dev)
    return _marginal(counts, _alphas(alphas, dev)).cpu().numpy()


def _sweep(table: torch.Tensor, alphas: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Marginal of one group's table [rows, A+1] (any integer type, on any
    device): its nonzero rows, gathered ``batch_size`` at a time."""
    rows = torch.nonzero(table.sum(dim=-1)).squeeze(1)
    out = torch.zeros(len(alphas), dtype=torch.float64, device=table.device)
    for start in range(0, rows.numel(), batch_size):
        out += _marginal(table[rows[start : start + batch_size]], alphas)
    return out


def select_lag(counter, alphas: Sequence[float] = (0.01, 0.1, 1.0), group: int = 0,
               batch_size: int = 1 << 20) -> LagSelection:
    """Score every counted lag of a dense ``TransitionCounter`` by exact BMM
    marginal likelihood, at each symmetric Dirichlet prior in ``alphas``.

    Runs on the counter's device, in float64: evidence gaps between adjacent
    lags near the optimum can be far below float32 resolution at genome
    scale. The tables are read with ``counter.table(lag)``: the resident
    device table while it holds every count."""
    if hasattr(counter, "counts_for_rows"):
        return select_lag_sparse(counter, alphas, group, batch_size)
    dev = resolve_device(counter.device)
    a = _alphas(alphas, dev)
    out = torch.stack([_sweep(counter.table(lag)[group], a, batch_size)
                       for lag in counter.lags])
    return LagSelection(lags=tuple(counter.lags), log_marginals=out.cpu().numpy(),
                        alphas=a.cpu().numpy())


def select_lag_sparse(counter, alphas: Sequence[float] = (0.01, 0.1, 1.0), group: int = 0,
                      batch_size: int = 1 << 20) -> LagSelection:
    """select_lag over a counter with a sparse host accumulator
    (MultiPassTransitionCounter, SparseTransitionCounter): its nonzero rows
    stream through ``counts_for_rows`` in ``batch_size`` blocks, each
    uploaded to the counter's device for the float64 sums, so lag 14-30
    selection never builds a dense table. Rows absent from the sparse set
    contribute exactly 0: the result equals the dense sweep."""
    dev = resolve_device(counter.device)
    a = _alphas(alphas, dev)
    out = torch.zeros((len(counter.lags), len(a)), dtype=torch.float64, device=dev)
    for i, lag in enumerate(counter.lags):
        rows = counter.nonzero_rows(lag)
        for start in range(0, len(rows), batch_size):
            counts = counter.counts_for_rows(lag, rows[start : start + batch_size])[:, group]
            out[i] += _marginal(torch.from_numpy(counts).to(dev), a)
    return LagSelection(lags=tuple(counter.lags), log_marginals=out.cpu().numpy(),
                        alphas=a.cpu().numpy())


def select_lag_from_tsvs(prefix: str, lags: Sequence[int],
                         alphas: Sequence[float] = (0.01, 0.1, 1.0), group: int = 0,
                         num_ds: int | None = None, alphabet: str = "dna",
                         batch_size: int = 1 << 20, device="cuda") -> LagSelection:
    """Score lags from summarized count TSVs ``{prefix}_lag_{l}_file_*.tsv``
    (the summarize CLI's layout), their counts read by the native parser
    (``load_dense_counts``);
    ``group`` selects the dataset column, ``num_ds`` defaults to the column
    count of the first row of the first shard that has one (a shard may be
    empty). The sweep runs on ``device`` in float64."""
    from bear_tpu_torch.data.loaders import load_dense_counts

    dev = resolve_device(device)
    a = _alphas(alphas, dev)
    lags = list(lags)
    files_by_lag = [sorted(glob.glob(f"{prefix}_lag_{lag}_file_*.tsv")) for lag in lags]
    for lag, files in zip(lags, files_by_lag):
        if not files:
            raise FileNotFoundError(f"no {prefix}_lag_{lag}_file_*.tsv files")
    if num_ds is None:
        num_ds = _sniff_num_ds(f for files in files_by_lag for f in files)
    out = torch.zeros((len(lags), len(a)), dtype=torch.float64, device=dev)
    for i, files in enumerate(files_by_lag):
        for f in files:
            counts = torch.from_numpy(load_dense_counts(f, alphabet, num_ds)[:, group])
            for start in range(0, len(counts), batch_size):
                out[i] += _marginal(counts[start : start + batch_size].to(dev), a)
    return LagSelection(lags=tuple(lags), log_marginals=out.cpu().numpy(),
                        alphas=a.cpu().numpy())


def _sniff_num_ds(files) -> int:
    """Dataset columns of the first row of the first non-empty TSV (1 when
    every file is empty)."""
    for f in files:
        with open(f) as fh:
            first = fh.readline().split("\t", 1)
        if len(first) == 2:
            return len(json.loads(first[1]))
    return 1
