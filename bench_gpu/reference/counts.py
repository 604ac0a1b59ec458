"""Plain transition counting: what the counter's table and the training
handoff hold, worked out again from the reads.

A read of length L gives L + 1 transitions: at position j the context is
the ``lag`` symbols before j, '['-padded where j < lag, and the next
symbol is the read's symbol j, or the stop symbol (code A) at j = L. A
context of m real symbols (m = min(j, lag)) has the row
(A^m - 1) / (A - 1) + its symbols read as a base-A number, the first one
most significant; the flat table holds [n_groups, rows, A + 1] counts.
"""

from __future__ import annotations

import numpy as np
import torch


def n_rows(lag: int, A: int = 4) -> int:
    """Rows of a lag-``lag`` table: contexts of 0..lag real symbols."""
    return sum(A ** m for m in range(lag + 1))


def row_offset(m: int, A: int = 4) -> int:
    """First row of the contexts with m real symbols."""
    return sum(A ** k for k in range(m))


def transition_rows(reads: torch.Tensor, lag: int, A: int = 4):
    """Context rows and next symbols of every transition of equal-length
    reads [n, L] (int codes 0..A-1): two int64 tensors [n, L + 1]."""
    n, L = reads.shape
    reads = reads.to(torch.int64)
    rows = torch.empty((n, L + 1), dtype=torch.int64, device=reads.device)
    value = torch.zeros(n, dtype=torch.int64, device=reads.device)
    for j in range(L + 1):
        m = min(j, lag)
        if j > 0:
            value = (value * A + reads[:, j - 1]) % (A ** lag)
        rows[:, j] = row_offset(m, A) + value
    nxt = torch.cat([reads, torch.full((n, 1), A, dtype=torch.int64, device=reads.device)],
                    dim=1)
    return rows, nxt


def count_keys(reads, groups, lag: int, n_groups: int, A: int = 4, block: int = 1 << 16):
    """(flat table keys, counts) of every distinct counted entry of the
    reads, ascending: key = (group * rows + row) * (A + 1) + next."""
    R = n_rows(lag, A)
    keys = []
    for s in range(0, reads.shape[0], block):
        rows, nxt = transition_rows(reads[s:s + block], lag, A)
        g = groups[s:s + block].to(torch.int64)[:, None]
        if int(g.min()) < 0 or int(g.max()) >= n_groups:
            raise ValueError("group outside 0..n_groups-1")
        keys.append(((g * R + rows) * (A + 1) + nxt).reshape(-1))
    return torch.unique(torch.cat(keys), return_counts=True)


def handoff(keys, counts, lag: int, n_groups: int, A: int = 4):
    """The training rows of a count: every context row with a count in any
    group, ascending, as (codes [N, lag] int64 with '[' coded A, counts
    [N, n_groups, A + 1] int64)."""
    R, A1 = n_rows(lag, A), A + 1
    row = (keys // A1) % R
    group = keys // (A1 * R)
    nxt = keys % A1
    rows, inverse = torch.unique(row, return_inverse=True)
    table = torch.zeros((rows.numel(), n_groups, A1), dtype=torch.int64, device=keys.device)
    table.index_put_((inverse, group, nxt), counts.to(torch.int64), accumulate=True)
    return decode(rows, lag, A), table


def decode(rows: torch.Tensor, lag: int, A: int = 4) -> torch.Tensor:
    """Context codes [N, lag] of table rows, '[' coded A."""
    rows = rows.to(torch.int64)
    m = torch.zeros_like(rows)
    for k in range(1, lag + 1):
        m += (rows >= row_offset(k, A)).to(torch.int64)
    offsets = torch.tensor([row_offset(k, A) for k in range(lag + 1)], dtype=torch.int64,
                           device=rows.device)
    value = rows - offsets[m]
    codes = torch.full((rows.numel(), lag), A, dtype=torch.int64, device=rows.device)
    for p in range(lag - 1, -1, -1):  # the last position holds the lowest digit
        real = (lag - 1 - p) < m
        codes[:, p] = torch.where(real, value % A, A)
        value = value // A
    return codes


def parse_count_tsv(path: str, num_ds: int, alphabet: str = "ACGT"):
    """A dense count TSV (``KMER<TAB>[[c0..cA], ...]`` per line, '[' pads
    leading) -> (codes [N, lag] int64, '[' coded A; counts
    [N, num_ds, A + 1] int64)."""
    A = len(alphabet)
    lut = {c: i for i, c in enumerate(alphabet)}
    lut["["] = A
    codes, counts = [], []
    with open(path) as f:
        for line in f:
            kmer, rest = line.rstrip("\n").split("\t")
            codes.append([lut[c] for c in kmer])
            nums = rest.replace("[", " ").replace("]", " ").replace(",", " ").split()
            counts.append([int(x) for x in nums])
    counts = np.asarray(counts, np.int64).reshape(len(codes), num_ds, A + 1)
    return torch.tensor(codes, dtype=torch.int64), torch.from_numpy(counts)
