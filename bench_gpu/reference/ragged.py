"""Plain transitions, counts and scores of ragged sequences over an alphabet
of any size A (proteins: A = 20), held flat: their codes 0..A-1
concatenated, and their lengths.

A sequence of length L gives L + 1 transitions: at position j the context
is the ``lag`` symbols before j, '['-padded where j < lag, and the next
symbol is the sequence's symbol j, or the stop symbol (code A) at j = L.
A context of m real symbols (m = min(j, lag)) has the row
(A^m - 1) / (A - 1) + its symbols read as a base-A number, the first one
most significant (``counts.py``'s rows, for sequences of any length). The
table of one group holds [rows, A + 1] counts.

Scores reuse ``model.cnn_probs`` (or any probabilities of one-hot
contexts) and ``sampler.sampled_scores`` unchanged: concentrations are
(probabilities + 1e-7) / h + counts.
"""

from __future__ import annotations

import torch

from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler

SLICE_ROWS = 1 << 18


def transitions(residues: torch.Tensor, lengths: torch.Tensor, lag: int, A: int):
    """(seq, rows, nxt) of every transition of the sequences, three int64
    tensors [sum(lengths + 1)], sequence by sequence, position by position:
    the sequence's index, its context row and its next symbol."""
    dev = residues.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    per = lengths + 1
    seq = torch.repeat_interleave(torch.arange(lengths.numel(), device=dev), per)
    j = torch.arange(seq.numel(), device=dev) - (torch.cumsum(per, 0) - per)[seq]
    first = (torch.cumsum(lengths, 0) - lengths)[seq]
    # One zero past the end, so that the stop of the last sequence reads in bounds.
    r = torch.cat([residues.to(torch.int64), torch.zeros(1, dtype=torch.int64, device=dev)])
    own = j < lengths[seq]
    nxt = torch.where(own, r[first + j], A)
    value = torch.zeros_like(j)
    for i in range(1, lag + 1):  # the symbol i before j is digit i - 1
        value += torch.where(j >= i, r[(first + j - i).clamp(min=0)], 0) * A ** (i - 1)
    offsets = torch.tensor([ref_counts.row_offset(m, A) for m in range(lag + 1)],
                           dtype=torch.int64, device=dev)
    return seq, offsets[j.clamp(max=lag)] + value, nxt


def _blocks(lengths: torch.Tensor, block: int):
    """(residue slice, length slice) of blocks of ``block`` sequences."""
    ends = torch.cumsum(lengths.to(torch.int64), 0).tolist()
    for s in range(0, lengths.numel(), block):
        e = min(s + block, lengths.numel())
        yield slice(ends[s - 1] if s else 0, ends[e - 1]), slice(s, e)


def count_keys(residues, lengths, lag: int, A: int, block: int = 1 << 14):
    """(keys, counts) of every distinct counted (row, next) of the
    sequences, ascending: key = row * (A + 1) + next, one group."""
    keys = []
    for rs, ls in _blocks(lengths, block):
        _, rows, nxt = transitions(residues[rs], lengths[ls], lag, A)
        keys.append(rows * (A + 1) + nxt)
    return torch.unique(torch.cat(keys), return_counts=True)


def row_counts(keys, counts, rows, A1: int, dtype=torch.int64):
    """[E, A1] counts of the table rows ``rows`` [E], looked up in ``keys``
    and ``counts`` of :func:`count_keys`."""
    out = torch.zeros((rows.numel(), A1), dtype=dtype, device=rows.device)
    if keys.numel() == 0:  # nothing counted
        return out
    for c in range(A1):
        want = rows * A1 + c
        at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        out[:, c] = torch.where(keys[at] == want, counts[at], 0).to(dtype)
    return out


def dense_table(keys, counts, lag: int, A: int) -> torch.Tensor:
    """The whole [rows, A + 1] int64 table of one group (small lags)."""
    A1 = A + 1
    table = torch.zeros(ref_counts.n_rows(lag, A) * A1, dtype=torch.int64, device=keys.device)
    table.index_put_((keys,), counts.to(torch.int64), accumulate=True)
    return table.view(-1, A1)


def concentrations(rows, keys, counts, probs, lag: int, A: int, h: float,
                   dtype=torch.float32, tf32: bool = False):
    """[E, A + 1] (probs(one-hot contexts) + 1e-7) / h + counts of the rows,
    the probabilities in ``dtype`` with products in full precision, or in
    TF32 where ``tf32`` asks, in slices of 2^18 rows."""
    A1 = A + 1
    conc = row_counts(keys, counts, rows, A1, dtype)
    with ref_model.matmul_precision(tf32), torch.no_grad():
        for s in range(0, rows.numel(), SLICE_ROWS):
            sl = slice(s, s + SLICE_ROWS)
            oh = ref_model.one_hot(ref_counts.decode(rows[sl], lag, A), A1, dtype)
            conc[sl] += (probs(oh) + ref_model.EPSILON) / h
    return conc


def map_scores(seq, nxt, conc, n_seqs: int) -> torch.Tensor:
    """[n_seqs] MAP log-probabilities, each sequence's sum in float64."""
    logp = torch.log(conc / conc.sum(dim=-1, keepdim=True)).gather(-1, nxt[:, None])[:, 0]
    out = torch.zeros(n_seqs, dtype=torch.float64, device=conc.device)
    return out.index_add_(0, seq, logp.to(torch.float64))


def sampled_mean_std(call_key: int, n_samples: int, seq, rows, nxt, conc, n_seqs: int,
                     n_prop: int) -> torch.Tensor:
    """[n_seqs, 2] mean and standard deviation (ddof 1) over the samples of
    each sequence's sampled log-probability (``sampler.sampled_scores``)."""
    d = ref_sampler.sampled_scores(call_key, n_samples, seq, rows, nxt, conc, n_seqs, n_prop)
    return torch.stack([d.mean(dim=1), d.std(dim=1, correction=1)], dim=1)
