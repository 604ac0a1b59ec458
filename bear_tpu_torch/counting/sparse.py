"""Sparse-first transition counting: no dense table, lags up to DNA 30 and
protein 13 (port of bear_tpu/counting/sparse.py).

The dense counters index a ``~1.33 * A^lag x (A+1)`` table with int32
offsets, which caps DNA at lag 15 and proteins at lag 7. KMC, the
reference's counter, has no such cap because it sorts packed k-mer codes and
merges runs. This counter does that on the card:

    device: each chunk's context codes in TWO int32 halves (hi, lo: digit
            blocks of ``digit_split(A)`` digits) and a small type key t =
            (n_pad * (A+1) + next) * n_groups + group, written chunk after
            chunk into per-lag device buffers that start at the int32
            sentinel t (masked positions keep it)
            -> when a buffer window fills (~16 chunks) or at flush, one
            sort of the window by (t, hi, lo): a stable sort by hi * 2^31 +
            lo, then a stable sort by t (torch has no 3-key sort; the runs
            come out as bear_tpu's lexicographic ``lax.sort`` gives them)
            -> run heads and lengths -> (t, hi, lo, count) of each run
    host:   per window, exact int64 global keys (g * rows(lag) + row) *
            (A+1) + next are reassembled and merged into the sparse
            accumulator the row-range counters share.

Device memory is bounded by the buffer budget, never by A^lag: one card
counts at any lag whose distinct contexts fit host memory. Two int32 digit
halves hold 2 * digit_split(A) digits (DNA 30, protein 14) and the int64
global key caps n_groups * rows(lag) * (A+1) at 2^63 (``max_sparse_lag``:
DNA 30, protein 13). Counting semantics are the dense engine's (the same
ReadChunk contract, reverse complement included). ``mesh=`` (rows over
several cards) is ROADMAP.md Queue 1 item 13 and raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bear_tpu_torch.counting import count_chunk
from bear_tpu_torch.counting.engine import (
    FLUSH_EVERY,
    ReadChunk,
    chunk_passes,
    check_groups,
    pad_offset,
    table_rows,
    upload_chunk,
)
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.parallel.counting import KmerShardedTransitionCounter, not_ported_multi_card
from bear_tpu_torch.utils.device import resolve_device

_SENT = int(np.iinfo(np.int32).max)  # masked positions sort past every real key
# Consolidate the host accumulator when this many un-merged entries are
# pending (bounds host memory at ~1.5 GB of (key, count) pairs).
CONSOLIDATE_PENDING = 1 << 26
# Key-buffer budget in TOTAL entries, split across the lags (each lag owns
# one buffer triple: 3 int32 = 12 bytes an entry, 768 MB at the default).
# The window adapts down to ~16 chunks of the current chunk size.
DEVICE_BUFFER = 1 << 26
# Window size target in chunks between drains.
_WINDOW_CHUNKS = 16


def digit_split(A: int) -> int:
    """Digits per int32 half: the largest m with A^m <= int32 max (DNA 15,
    protein 7)."""
    m = 0
    while A ** (m + 1) <= np.iinfo(np.int32).max:
        m += 1
    return m


def max_sparse_lag(A: int, n_groups: int = 1) -> int:
    """Largest lag the sparse counter takes: two int32 digit halves (lag <=
    2m) and the int64 global key n_groups * rows(lag) * (A+1)."""
    lag = 2 * digit_split(A)
    while lag > 0 and n_groups * table_rows(lag, A) * (A + 1) > np.iinfo(np.int64).max:
        lag -= 1
    return lag


def chunk_keys(codes, lengths, skip, stopped, groups, fresh, lags, n_groups: int,
               A: int) -> dict:
    """Per lag: the flattened [B * (L+1)] int32 key triples (t, hi, lo) of
    every transition position of a chunk; masked positions carry the
    sentinel t. Tensors on one device; ``stopped`` and ``fresh`` bool
    (``fresh`` may be None). bear_tpu's ``_chunk_keys`` (sparse.py:110):

      lo = sum_{i=1..min(lag,m)} d_i * A^(i-1)    (d_i = i-th previous residue)
      hi = sum_{i=m+1..lag}      d_i * A^(i-1-m)
      t  = (n_pad * (A+1) + next) * n_groups + group

    Digits before the read start read the zero padding (the truncated
    prefix code); n_pad in t tells 'A' digits from '[' pads."""
    B, L = codes.shape
    P = L + 1
    dev = codes.device
    j = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    skip = skip.to(torch.int32)[:, None]
    groups32 = groups.to(torch.int32)[:, None]
    A1 = A + 1
    max_lag = max(lags)
    m = digit_split(A)
    padded = F.pad(codes.to(torch.int32), (max_lag, 1))
    nxt = torch.where(j < lengths, padded[:, max_lag : max_lag + P], A)
    mask = (j >= skip) & ((j < lengths) | ((j == lengths) & stopped[:, None]))
    fresh_col = None if fresh is None else fresh[:, None]
    base_t = nxt * n_groups + groups32  # t without its n_pad term
    out = {}
    lo = torch.zeros((B, P), dtype=torch.int32, device=dev)
    hi = torch.zeros((B, P), dtype=torch.int32, device=dev)
    pow_lo = pow_hi = 1
    for l in range(1, max_lag + 1):
        shifted = padded[:, max_lag - l : max_lag - l + P]
        if l <= m:
            lo = lo + shifted * pow_lo
            pow_lo *= A
        else:
            hi = hi + shifted * pow_hi
            pow_hi *= A
        if l not in lags:
            continue
        mask_l = mask if fresh_col is None else mask & (fresh_col | (j >= l))
        n_pad = (l - j).clamp_min(0)
        t = torch.where(mask_l, n_pad * (A1 * n_groups) + base_t, _SENT)
        out[l] = (t.reshape(-1), hi.reshape(-1), lo.reshape(-1))
    return out


def window_runs(bt: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor):
    """Sort one key-buffer window by (t, hi, lo) on its device and return
    its runs: (t, hi, lo, count) of every run of equal valid keys, in key
    order, as device tensors. Sentinel-t entries (masked positions and the
    unfilled tail) sort last and count nowhere."""
    packed = bh.to(torch.int64) * (1 << 31) + bl.to(torch.int64)  # hi, lo < 2^31
    order = torch.sort(packed, stable=True).indices
    order = order[torch.sort(bt[order], stable=True).indices]
    ts, hs, ls = bt[order], bh[order], bl[order]
    valid = ts != _SENT
    start = valid.clone()
    start[1:] &= (ts[1:] != ts[:-1]) | (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    pos = torch.nonzero(start).squeeze(1)
    n_valid = valid.sum().reshape(1)
    counts = torch.diff(pos, append=n_valid)
    return ts[pos], hs[pos], ls[pos], counts


class SparseTransitionCounter(KmerShardedTransitionCounter):
    """Sparse-first counter for lags beyond the dense tables (DNA lag >= 16,
    protein lag >= 8; up to 30 / 13), on one card.

    Shares the row-range counters' host surface (nonzero_rows,
    counts_for_rows, to_dataset, export_tsv, save/load_state, validate,
    merge_from) and the ReadChunk ingest (reverse complement, segment skip,
    fresh flags). Chunks append their key triples to device buffers with no
    sync; a buffer window sorts and drains to the host once per ~16 chunks
    or at ``flush()``.

    device_buffer : key-buffer budget in TOTAL entries, split across the
        lags (12 bytes an entry); each lag's window adapts down to ~16
        chunks of the current chunk size and ratchets up for bigger ones.
    mesh : several cards; not ported (raises NotImplementedError).
    """

    FLUSH_EVERY = FLUSH_EVERY

    def __init__(self, lags: Sequence[int], n_groups: int = 1, reverse: bool = False,
                 alphabet: str = "dna", mesh=None, axis: str = "data",
                 device_buffer: int = DEVICE_BUFFER, device="cuda"):
        if mesh is not None:
            not_ported_multi_card("sparse counting over a mesh of cards (mesh=)")
        del axis
        self.alphabet = alphabet
        self.A = _alpha.alphabet_size(alphabet)
        self.A1 = self.A + 1
        if reverse and self.A != 4:
            raise ValueError("reverse-complement counting requires a 4-letter alphabet")
        self.lags = tuple(sorted(set(int(l) for l in lags)))
        cap = max_sparse_lag(self.A, n_groups)
        if max(self.lags) > cap:
            raise ValueError(
                f"lag {max(self.lags)} exceeds the sparse counter's cap of {cap} for a "
                f"{self.A}-letter alphabet at n_groups={n_groups} (two int32 digit halves "
                "+ the int64 global key)")
        self.n_groups = n_groups
        self.reverse = reverse
        self.mesh = None
        if device_buffer < 1:
            raise ValueError("device_buffer must be >= 1")
        self.device_buffer = int(device_buffer)
        self.device = torch.device(device)
        self._m = digit_split(self.A)
        self._sparse = {l: [] for l in self.lags}
        self._consolidated_lags: set = set()
        self._grk_cache = {}
        self._pending = 0  # un-consolidated host entries across all lags
        self._buf = None  # {lag: (t, hi, lo)} device buffers
        self._cap = None  # window capacity per lag (set at the first chunk)
        self._fill = 0  # filled entries (the same for every lag)
        self._staging: list = []

    @property
    def table_size(self) -> int:
        """Entries of the int32 device key buffers (three per lag)."""
        return 3 * len(self.lags) * (self._cap or 0)

    def add_chunk(self, chunk: ReadChunk):
        check_groups(chunk.groups, self.n_groups)
        if self.reverse and np.any(np.asarray(chunk.skip) != 0):
            # The RC of a continuation segment needs right-side context the
            # row lacks; checked before the forward add.
            raise ValueError(
                "reverse=True requires whole-read chunks (skip == 0); "
                "for segmented long sequences use chunk_reads(reverse=True)")
        for rows in chunk_passes(chunk, self.reverse):
            self._add(*rows)

    # --- device buffers -----------------------------------------------------

    def _ensure_cap(self, n_local: int, row_width: int):
        """Window capacity: ~16 chunks of the current chunk's size, within
        the budget split across the lags, never below one row's transitions
        (so row slicing ends). It ratchets UP when a bigger chunk arrives
        (one drain, then bigger buffers): a small first chunk must not pin
        one-row windows, the per-chunk drain this design removes."""
        want = max(min(self.device_buffer // len(self.lags), _WINDOW_CHUNKS * n_local),
                   row_width)
        if self._cap is None:
            self._cap = want
        elif want > self._cap:
            self._drain_all()
            self._cap = want

    def _new_buffers(self):
        """Fresh buffers: t at the sentinel (hi and lo need no reset: runs
        key on t first, and sentinel entries never start a counted run)."""
        dev = resolve_device(self.device)
        self._buf = {l: (torch.full((self._cap,), _SENT, dtype=torch.int32, device=dev),
                         torch.zeros(self._cap, dtype=torch.int32, device=dev),
                         torch.zeros(self._cap, dtype=torch.int32, device=dev))
                     for l in self.lags}
        self._fill = 0

    def _add(self, codes, lengths, skip, stopped, groups, fresh=None):
        codes = np.asarray(codes)
        B, L = codes.shape
        if B == 0:
            return
        P = L + 1
        n_local = B * P
        self._ensure_cap(n_local, P)
        if n_local > self._cap:
            # A chunk larger than a window: its rows go in slices that fit.
            rows_per = max(1, self._cap // P)
            for s0 in range(0, B, rows_per):
                sl = slice(s0, s0 + rows_per)
                self._add(codes[sl], np.asarray(lengths)[sl], np.asarray(skip)[sl],
                          np.asarray(stopped)[sl], np.asarray(groups)[sl],
                          None if fresh is None else np.asarray(fresh)[sl])
            return
        if self._buf is not None and self._fill + n_local > self._cap:
            self._drain_all()
        if self._buf is None:
            self._new_buffers()
        dev = next(iter(self._buf.values()))[0].device
        codes_t, meta_t = upload_chunk(self._staging, dev, codes, lengths, skip, stopped,
                                       groups, fresh)
        lengths_t, skip_t, stopped_t, groups_t, fresh_t = count_chunk.unpack_meta(meta_t)
        keys = chunk_keys(codes_t, lengths_t, skip_t, stopped_t, groups_t,
                          None if fresh is None else fresh_t, self.lags, self.n_groups,
                          self.A)
        end = self._fill + n_local
        for l in self.lags:
            for buf, part in zip(self._buf[l], keys[l]):
                buf[self._fill : end] = part
        self._fill = end

    def _drain_all(self):
        """Sort every lag's window, fetch only its runs and merge them into
        the host accumulator: one sync and one fetch per lag per window."""
        # Detach the buffers first: _push may consolidate, and the inherited
        # consolidation calls flush(), which would re-enter this drain.
        buf, self._buf = self._buf, None
        fill, self._fill = self._fill, 0
        if buf is None or fill == 0:
            return
        for l in self.lags:
            t, hi, lo, counts = (x.cpu().numpy() for x in window_runs(*buf[l]))
            if len(t):
                self._push(l, t, hi, lo, counts.astype(np.int64))

    def _push(self, lag: int, t: np.ndarray, hi: np.ndarray, lo: np.ndarray,
              counts: np.ndarray):
        """Reassemble exact int64 global keys from the key triples and append
        them to the sparse accumulator."""
        A, A1, m = self.A, self.A1, self._m
        t = t.astype(np.int64)
        g = t % self.n_groups
        tn = t // self.n_groups
        nxt = tn % A1
        n_pad = tn // A1
        ctx = hi.astype(np.int64) * (A ** min(lag, m)) + lo.astype(np.int64)
        row = pad_offset(lag, n_pad, A) + ctx
        key = (g * table_rows(lag, A) + row) * A1 + nxt
        self._sparse[lag].append((key, counts))
        self._consolidated_lags.discard(lag)
        self._pending += len(key)
        if self._pending > CONSOLIDATE_PENDING:
            for l in self.lags:
                self._consolidated(l)
            # Everything is merged: the counter tracks UN-merged entries
            # only. Resetting it to the store's size instead would keep it
            # above the threshold once the corpus holds more distinct keys,
            # re-merging the whole store on every push (quadratic).
            self._pending = 0

    def flush(self):
        """Drain the device buffers into the host accumulator (every host
        read path calls it through the shared machinery)."""
        self._drain_all()

    def finish(self):
        self.flush()

    def sync(self):
        """Block until all queued device append work has completed."""
        if self._buf is not None:
            dev = next(iter(self._buf.values()))[0].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
