"""Large-lag counting on one card in sequential row-range passes (port of
bear_tpu/counting/multipass.py).

The lag-14/15 DNA table (rows(15) = 1.43e9 rows; 57 GB of int32 over two
groups and five columns) does not fit one card, but a 1/``passes`` row range
of it does. Each pass re-streams the reads and the count_chunk kernel counts
only the transitions whose context row falls in this pass's range (its
row-range form, one launch per chunk); the pass's nonzero entries drain into
the sparse host accumulator under global int64 keys. This is
KmerShardedTransitionCounter with the shard axis in time: pass p plays
shard p, and every host accessor is shared.

Cost: ``passes`` x the input streaming and parsing, for 1/``passes`` x the
device memory. The smallest pass count the int32 guard takes is the
cheapest (``min_passes``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from bear_tpu_torch.counting.count_chunk import table_rows
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.parallel.counting import (
    KmerShardedTransitionCounter,
    _INT32_MAX,
    check_context_codes,
    padded_size,
)


def min_passes(lags, n_groups: int = 1, alphabet: str = "dna") -> int:
    """The fewest passes whose row range the int32 guard accepts."""
    A = _alpha.alphabet_size(alphabet)
    passes = 1
    while padded_size(sum(n_groups * -(-table_rows(l, A) // passes) * (A + 1)
                          for l in set(lags))) > _INT32_MAX:
        passes += 1
    return passes


class MultiPassTransitionCounter(KmerShardedTransitionCounter):
    """Count transitions at lags whose table exceeds one card, on one card.

    Usage::

        counter = MultiPassTransitionCounter(lags=[14], passes=8)
        for p in range(counter.passes):
            counter.begin_pass(p)
            for chunk in chunk_stream():   # re-streamed each pass
                counter.add_chunk(chunk)
        counter.finish()

    The chunk stream must be the same in every pass (the same reads in any
    order): each transition lands in exactly one pass's row range, so the
    union over the passes is the exact count. ``method`` is accepted for
    bear_tpu's signature and ignored (one kernel).
    """

    def __init__(self, lags: Sequence[int], n_groups: int = 1, passes: int = 2,
                 method: str = "auto", alphabet: str = "dna", device="cuda"):
        if method not in ("auto", "scatter", "sorted"):
            raise ValueError(f"unknown counting method {method!r}")
        if passes < 1:
            raise ValueError("passes must be >= 1")
        self.passes = int(passes)
        self.alphabet = alphabet
        self.A = _alpha.alphabet_size(alphabet)
        self.A1 = self.A + 1
        self.lags = tuple(sorted(set(int(l) for l in lags)))
        check_context_codes(self.lags, self.A)
        self.n_groups = n_groups
        self.method = method
        self.device = torch.device(device)
        self._init_row_split(self.passes, "use more passes")

    def begin_pass(self, pass_idx: int):
        """Flush the previous pass and count rows ``[pass_idx * stride,
        (pass_idx + 1) * stride)`` of each lag from now on."""
        if not 0 <= pass_idx < self.passes:
            raise ValueError(f"pass_idx {pass_idx} not in [0, {self.passes})")
        self.flush()
        self._shard = int(pass_idx)

    def finish(self):
        """Flush the last pass (every read accessor also flushes)."""
        self.flush()


def count_multipass(chunk_factory, lags, n_groups: int = 1, passes: int = 2,
                    method: str = "auto", alphabet: str = "dna",
                    device="cuda") -> MultiPassTransitionCounter:
    """A whole multi-pass count: ``chunk_factory()`` returns a fresh
    ReadChunk iterator and is called once per pass."""
    counter = MultiPassTransitionCounter(lags=lags, n_groups=n_groups, passes=passes,
                                         method=method, alphabet=alphabet, device=device)
    for p in range(counter.passes):
        counter.begin_pass(p)
        for chunk in chunk_factory():
            counter.add_chunk(chunk)
    counter.finish()
    return counter
