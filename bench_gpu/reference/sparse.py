"""Plain scoring over a sparse count map, at any lag up to 30 (DNA) where no
dense table exists: context rows in int64, a sorted map of the counted rows
looked up with hit or miss, concentrations from ``model.py``'s CNN, and the
Δ of single-letter substitutions drawn by ``sampler.py``. A sequence's MAP
and sampled scores from these concentrations are ``ragged.py``'s.

Rows are ``counts.py``'s: at position j of a sequence the context is the
``lag`` symbols before j, '['-padded where j < lag, of m = min(j, lag) real
symbols; its row is (A^m - 1) / (A - 1) + those symbols read as a base-A
number, the one just before j least significant. The next symbol is the
sequence's symbol j, or the stop (code A) at j = L.

A substitution of the letter at p by ``alt`` changes the transitions
p..p+lag of the sequence (the stop included, none past it): at p its next
symbol, after p its context. Its Δ is the sum over those transitions of the
mutant's log-probability less the wild type's, each window's draw keyed on
fold_in(fold_in(K, s), row) for sample s of a call with key K: the
sequence index is not folded in, so a window shared by two variants draws
the same.

Everything is int64 and float arithmetic of plain torch; matrix products
run in full float32 unless TF32 is asked for (``model.matmul_precision``).
"""

from __future__ import annotations

import torch

from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler

SLICE_ROWS = 1 << 18


def context_rows(reads: torch.Tensor, lag: int, A: int = 4):
    """(rows, nxt) of every transition of equal-length reads [n, L] (codes
    0..A-1): two int64 tensors [n, L + 1], each row summed digit by digit
    from the symbols before its position."""
    n, L = reads.shape
    reads = reads.to(torch.int64)
    j = torch.arange(L + 1, device=reads.device)
    value = torch.zeros((n, L + 1), dtype=torch.int64, device=reads.device)
    for d in range(1, lag + 1):  # the symbol d before j is digit d - 1
        before = reads[:, (j - d).clamp(min=0, max=L - 1)]
        value += torch.where(j >= d, before, 0) * A ** (d - 1)
    offsets = torch.tensor([ref_counts.row_offset(m, A) for m in range(lag + 1)],
                           dtype=torch.int64, device=reads.device)
    nxt = torch.cat([reads, torch.full((n, 1), A, dtype=torch.int64, device=reads.device)],
                    dim=1)
    return offsets[j.clamp(max=lag)] + value, nxt


def count_map(reads: torch.Tensor, lag: int, A: int = 4, block: int = 1 << 14):
    """The sorted map of the reads' counted contexts: (rows [N] int64
    ascending, counts [N, A + 1] int64), from the distinct (row, next) keys
    of every block of reads and their counts."""
    A1 = A + 1
    keys, counts = [], []
    for s in range(0, reads.shape[0], block):
        rows, nxt = context_rows(reads[s:s + block], lag, A)
        k, c = torch.unique(rows * A1 + nxt, return_counts=True)
        keys.append(k)
        counts.append(c)
    keys, at = torch.unique(torch.cat(keys), return_inverse=True)
    n = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
    n.index_add_(0, at, torch.cat(counts))
    map_rows, at = torch.unique(keys // A1, return_inverse=True)
    out = torch.zeros((map_rows.numel(), A1), dtype=torch.int64, device=keys.device)
    out.index_put_((at, keys % A1), n, accumulate=True)
    return map_rows, out


def lookup(map_rows: torch.Tensor, map_counts: torch.Tensor, rows: torch.Tensor):
    """(counts [E, A + 1], hit [E]) of the rows ``rows`` [E] in the map:
    a miss counts zero."""
    out = torch.zeros((rows.numel(), map_counts.shape[1]), dtype=map_counts.dtype,
                      device=rows.device)
    hit = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
    if map_rows.numel() == 0:
        return out, hit
    at = torch.searchsorted(map_rows, rows).clamp(max=map_rows.numel() - 1)
    hit = map_rows[at] == rows
    out[hit] = map_counts[at[hit]]
    return out, hit


def concentrations(rows, map_rows, map_counts, probs, lag: int, A: int, h: float,
                   dtype=torch.float32, tf32: bool = False):
    """[E, A + 1] (probs(one-hot contexts) + 1e-7) / h + counts of the rows,
    the probabilities in ``dtype`` with products in full precision, or in
    TF32 where ``tf32`` asks, in slices of 2^18 rows."""
    conc = lookup(map_rows, map_counts, rows)[0].to(dtype)
    with ref_model.matmul_precision(tf32), torch.no_grad():
        for s in range(0, rows.numel(), SLICE_ROWS):
            sl = slice(s, s + SLICE_ROWS)
            oh = ref_model.one_hot(ref_counts.decode(rows[sl], lag, A), A + 1, dtype)
            conc[sl] += (probs(oh) + ref_model.EPSILON) / h
    return conc


def snv_windows(wt: torch.Tensor, pos: torch.Tensor, alt: torch.Tensor, lag: int, A: int = 4):
    """The wild type's and the mutant's windows of each substitution:
    (rows_wt, nxt_wt, rows_mt, nxt_mt, valid), five [V, lag + 1] tensors,
    window i the transition p + i of a substitution at p (valid where
    p + i <= L). Each context is read letter by letter from the sequence,
    the mutant's with ``alt`` at p."""
    wt = wt.to(torch.int64)
    L = wt.numel()
    pos = pos.to(torch.int64)[:, None]
    alt = alt.to(torch.int64)[:, None]
    t = pos + torch.arange(lag + 1, device=wt.device)[None, :]
    valid = t <= L
    letters = torch.cat([wt, torch.full((1,), A, dtype=torch.int64, device=wt.device)])

    def letter(q, mutant):
        got = letters[q.clamp(0, L)]
        return torch.where(mutant & (q == pos), alt, got)

    out = []
    for mutant in (False, True):
        m = t.clamp(max=lag)
        value = torch.zeros_like(t)
        for d in range(1, lag + 1):
            q = t - d
            value += torch.where(d <= m, letter(q, mutant), 0) * A ** (d - 1)
        offsets = torch.tensor([ref_counts.row_offset(k, A) for k in range(lag + 1)],
                               dtype=torch.int64, device=wt.device)
        # Windows past the stop read the empty context and symbol 0.
        out += [torch.where(valid, offsets[m] + value, 0),
                torch.where(valid, letter(t, mutant), 0)]
    return out[0], out[1], out[2], out[3], valid


def snv_deltas(call_key: int, n_samples: int, rows_wt, nxt_wt, conc_wt, rows_mt, nxt_mt,
               conc_mt, valid, n_prop: int, draws: int = 1 << 21) -> torch.Tensor:
    """[V, n_samples] sampled Δ of each substitution, mutant less wild type
    over its valid windows [V, W], summed in float64: window e of sample s
    drawn under fold_in(fold_in(K, s), row) in the concentrations' type
    (``conc_*`` [V, W, A + 1])."""
    dev = conc_wt.device
    sample_keys = ref_sampler.fold_in(torch.tensor(ref_sampler.as_key(call_key), device=dev),
                                      torch.arange(n_samples, device=dev))
    V, W = rows_wt.shape
    out = torch.zeros((V, n_samples), dtype=torch.float64, device=dev)
    block = max(1, draws // (W * n_samples))
    for s in range(0, V, block):
        sl = slice(s, s + block)
        for rows, nxt, conc, sign in ((rows_mt, nxt_mt, conc_mt, 1.0),
                                      (rows_wt, nxt_wt, conc_wt, -1.0)):
            keys = ref_sampler.fold_in(sample_keys[None, None, :], rows[sl, :, None])
            lp = ref_sampler.picked_logp(
                keys, conc[sl, :, None, :].expand(-1, -1, n_samples, -1),
                nxt[sl, :, None].expand(-1, -1, n_samples), n_prop)
            lp = torch.where(valid[sl, :, None], lp.to(torch.float64), 0.0)
            out[sl] += sign * lp.sum(dim=1)
    return out
