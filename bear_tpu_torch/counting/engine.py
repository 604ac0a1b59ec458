"""Dense k-mer transition counting on the card (port of
bear_tpu/counting/engine.py).

    host: reads -> int8 residue codes (fastx), padded ReadChunks; each
          chunk's row meta packed into one int32 [B, 4] array
    upload: codes and meta from pinned, double-buffered staging buffers,
            asynchronously (two copies per chunk)
    device: one count_chunk kernel launch per chunk (and per reverse
            complement): codes in, counts added into a single flat int32
            table; no index vector is ever written
    host: int64 accumulators, flushed into before the int32 table could
          overflow, and on output access
    handoff: ``to_device_dataset`` gives training codes and counts straight
             from the resident table (``to_dataset`` from the host tables)

The table layout and the chunk's index math live in
:mod:`bear_tpu_torch.counting.count_chunk`. Counts never clamp: the device
accumulates int32 per flush window and the host accumulator is int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from bear_tpu_torch.counting.count_chunk import (
    count_chunk_update,
    lag_offsets,
    pack_meta,
    pad_offset,
    table_rows,
)
from bear_tpu_torch.data.loaders import CountDataset
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.utils.device import resolve_device

PAD_LEN_ALIGN = 64
FLUSH_EVERY = (1 << 31) - (1 << 24)  # transitions between int32 flushes
NONZERO_CHUNK = 1 << 26  # bound device temps during nonzero extraction
_INT32_MAX = int(np.iinfo(np.int32).max)


def extract_nonzero(dev: torch.Tensor, chunk: int = NONZERO_CHUNK):
    """Yield (global int64 indices, int64 values) of a device vector's
    nonzero entries, chunked so device temporaries stay bounded."""
    for start in range(0, dev.numel(), chunk):
        part = dev[start : start + chunk]
        idx = torch.nonzero(part).squeeze(1)
        if idx.numel() == 0:
            continue
        vals = part[idx]
        yield (idx.cpu().numpy().astype(np.int64) + start,
               vals.cpu().numpy().astype(np.int64))


def exact_count_limit(dtype: torch.dtype) -> int:
    """Largest integer a float type holds exactly: 2^(mantissa bits + 1)
    (float32 2^24, float64 2^53, bfloat16 2^8)."""
    return 1 << (int(round(-np.log2(torch.finfo(dtype).eps))) + 1)


def decode_rows(rows: torch.Tensor, lag: int, A: int = 4) -> torch.Tensor:
    """Inverse of the table row index on the rows' device: [N] rows -> int8
    k-mer codes [N, lag], the '[' pad coded A (port of bear_tpu's
    ``decode_rows``, engine.py:216-236). Suffix-length bounds are
    (A^k - 1) / (A - 1); pure integer arithmetic, so counts can hand off
    to training without k-mer strings or a host round trip."""
    dev = rows.device
    rows = rows.to(torch.int64)
    bounds = torch.tensor([(A**k - 1) // (A - 1) for k in range(lag + 2)],
                          dtype=torch.int64, device=dev)
    m = torch.searchsorted(bounds, rows, right=True) - 1  # suffix length
    code = rows - bounds[m]
    # position p holds the suffix digit of exponent lag-1-p, valid for the
    # last m positions; earlier positions are the '[' pad (code A).
    exps = torch.tensor([A ** (lag - 1 - p) for p in range(lag)], dtype=torch.int64,
                        device=dev)
    digits = torch.div(code[:, None], exps[None, :], rounding_mode="floor") % A
    pad = torch.arange(lag, device=dev)[None, :] < (lag - m)[:, None]
    return torch.where(pad, A, digits).to(torch.int8)


def _check_exact(cmax: int, dtype) -> None:
    if cmax > exact_count_limit(dtype):
        raise ValueError(
            f"a count reached {cmax:,}, beyond {dtype}'s exact integer range "
            f"({exact_count_limit(dtype):,}): use dtype=torch.float64 (the "
            "no-clamp guarantee would otherwise silently round)"
        )


def check_groups(groups, n_groups: int) -> None:
    """Reject out-of-range dataset-group ids before they reach the device:
    the concatenated flat layout has no guard rows between lags, so a group
    id >= n_groups would land IN BOUNDS inside the next lag's table and
    silently corrupt counts."""
    g = np.asarray(groups)
    if g.size and (int(g.min()) < 0 or int(g.max()) >= n_groups):
        raise ValueError(
            f"chunk group ids must be in [0, {n_groups}); got range "
            f"[{int(g.min())}, {int(g.max())}]"
        )


def context_to_row(context: str, lag: int, alphabet: str = "dna") -> int:
    """Host-side: context string (may contain leading '[') -> table row."""
    letters = "".join(_alpha.input_letters(alphabet)[:-1])
    A = len(letters)
    if len(context) != lag:
        raise ValueError(f"context {context!r} does not have length {lag}")
    n_pad = len(context) - len(context.lstrip("["))
    code = 0
    for ch in context[n_pad:]:
        code = code * A + letters.index(ch)
    return pad_offset(lag, n_pad, A) + code


def rows_to_contexts(rows, lag: int, alphabet: str = "dna") -> np.ndarray:
    """Vectorized inverse of context_to_row: row indices -> context
    strings."""
    letters_s = "".join(_alpha.input_letters(alphabet)[:-1])
    A = len(letters_s)
    rows = np.asarray(rows, dtype=np.int64)
    bounds = np.array(
        [(A**k - 1) // (A - 1) for k in range(lag + 2)], dtype=np.int64
    )
    m = np.searchsorted(bounds, rows, side="right") - 1  # suffix length
    code = rows - (A**m - 1) // (A - 1)
    letters = np.frombuffer(letters_s.encode(), dtype=np.uint8)
    chars = np.full((len(rows), lag), ord("["), dtype=np.uint8)
    rem = code.copy()
    for i in range(lag):  # digit i is the (i+1)-th letter from the right
        pos = lag - 1 - i
        digit = (rem % A).astype(np.int64)
        rem //= A
        valid = i < m
        chars[valid, pos] = letters[digit[valid]]
    return np.char.decode(chars.view(f"S{lag}").reshape(-1), "ascii")


@dataclass
class ReadChunk:
    """A padded batch of encoded reads/segments ready for the device.

    codes : [B, L] int8 residue codes (padding is 0 and masked off).
    lengths : [B] number of real residues in each row.
    skip : [B] transitions at positions < skip are not counted (used for
        continuation segments of long sequences, which carry a max_lag
        overlap as context only).
    stopped : [B] whether a '$' transition is emitted at position == length.
    groups : [B] dataset group of each row.
    fresh : optional [B] bool; None means all True. A fresh row starts at a
        true read boundary: positions j < lag count with '['-padded prefix
        contexts. A non-fresh row (a split_ambiguous piece after an
        ambiguous base) instead DROPS, per lag l, transitions at positions
        j < l — their context window would cross the ambiguous base.
    """

    codes: np.ndarray
    lengths: np.ndarray
    skip: np.ndarray
    stopped: np.ndarray
    groups: np.ndarray
    fresh: np.ndarray | None = None


class TransitionCounter:
    """Accumulates transition counts over streamed read chunks.

    The per-lag tables live on ``device`` as ONE flat int32 buffer, updated
    in place by the count_chunk kernel — no per-chunk zeroing, no per-chunk
    device->host traffic. A flush into the host int64 accumulators happens
    only when the transitions since the last flush approach int32 range,
    on merge, and on output access.

    lags : which lags to count.
    n_groups : number of dataset groups (count columns).
    reverse : also count the reverse complement of every read.
    alphabet : 'dna' (default), 'rna' or 'prot'; reverse=True requires a
        4-letter alphabet.
    device : where the table lives and the kernel runs. "cuda" (default)
        raises at the first add_chunk when no card is present; "cpu" runs
        the kernel's plain PyTorch version.
    """

    FLUSH_EVERY = FLUSH_EVERY

    def __init__(self, lags: Sequence[int], n_groups: int = 1,
                 reverse: bool = False, alphabet: str = "dna",
                 device="cuda"):
        self.alphabet = alphabet
        self.A = _alpha.alphabet_size(alphabet)
        self.A1 = self.A + 1
        if reverse and self.A != 4:
            raise ValueError(
                "reverse-complement counting requires a 4-letter alphabet"
            )
        self.lags = tuple(sorted(set(int(l) for l in lags)))
        if self.A ** max(self.lags) > _INT32_MAX:
            raise ValueError(
                f"lag {max(self.lags)} context codes exceed int32 for a "
                f"{self.A}-letter alphabet; the dense counter cannot hold it"
            )
        self.n_groups = n_groups
        self.reverse = reverse
        self.device = torch.device(device)
        self._offsets, self._total_size = lag_offsets(
            self.lags, n_groups, self.A
        )
        if self._total_size > _INT32_MAX:
            # Flat indices (and the sentinel, == size) are int32; beyond
            # 2^31 entries they would wrap negative and silently drop counts.
            raise ValueError(
                f"concatenated count table has {self._total_size:,} entries, "
                "beyond int32 indexing — split the lags across multiple "
                "TransitionCounters or reduce n_groups"
            )
        # Host int64 accumulators, 8 bytes per table entry; np.zeros leaves
        # the pages untouched until a flush writes them.
        self._host: Dict[int, np.ndarray] = {
            l: np.zeros(n_groups * table_rows(l, self.A) * self.A1, np.int64)
            for l in self.lags
        }
        self._dev: Optional[torch.Tensor] = None  # lazy flat int32 buffer
        self._since_flush = 0
        self._host_dirty = False  # True once any count reached self._host
        self._staging: List[_Staging] = []  # two sets once on the card

    def _ensure_dev(self):
        if self._dev is None:
            dev = resolve_device(self.device)
            self._dev = torch.zeros(self._total_size, dtype=torch.int32,
                                    device=dev)

    def sync(self):
        """Block until all queued device counting work has completed."""
        if self._dev is not None and self._dev.is_cuda:
            torch.cuda.synchronize(self._dev.device)

    def flush(self):
        """Fold the device int32 partials into the host int64 accumulators
        and zero the device buffer in place. A sparse table (distinct
        k-mers << A^lag, the genome case) moves only its nonzero entries."""
        if self._dev is not None and self._since_flush > 0:
            dev = self._dev
            nnz = int(torch.count_nonzero(dev))
            if nnz * 3 < dev.numel():
                for idx, vals in extract_nonzero(dev):
                    self._scatter_host(idx, vals)
            else:
                dense = dev.cpu().numpy()
                for l in self.lags:
                    off = self._offsets[l]
                    self._host[l] += dense[off : off + self._host[l].size]
            dev.zero_()
            self._since_flush = 0
            self._host_dirty = True

    def _scatter_host(self, idx: np.ndarray, vals: np.ndarray):
        """Route concatenated-buffer indices into the per-lag host tables."""
        bounds = [self._offsets[l] for l in self.lags] + [self._total_size]
        for i, l in enumerate(self.lags):
            sel = (idx >= bounds[i]) & (idx < bounds[i + 1])
            if sel.any():
                self._host[l][idx[sel] - bounds[i]] += vals[sel]

    def add_chunk(self, chunk: ReadChunk):
        check_groups(chunk.groups, self.n_groups)
        if self.reverse and np.any(np.asarray(chunk.skip) != 0):
            # RC of a continuation segment would need right-side context;
            # checked BEFORE the forward add so a failed chunk leaves the
            # tables untouched.
            raise ValueError(
                "reverse=True requires whole-read chunks (skip == 0); "
                "for segmented long sequences use chunk_reads(reverse=True)"
            )
        for rows in chunk_passes(chunk, self.reverse):
            self._add(*rows)

    def _add(self, codes, lengths, skip, stopped, groups, fresh=None):
        codes = np.asarray(codes)
        new_transitions = codes.shape[0] * (codes.shape[1] + 1)
        if self._since_flush + new_transitions > self.FLUSH_EVERY:
            self.flush()
        self._ensure_dev()
        if self._dev.is_cuda:
            if not self._staging:
                self._staging = [_Staging(), _Staging()]
            self._staging.reverse()  # alternate between the two sets
            codes_t, meta_t = self._staging[0].upload(
                self._dev.device, codes, lengths, skip, stopped, groups, fresh)
        else:
            codes_t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8))
            meta_t = torch.from_numpy(pack_meta(lengths, skip, stopped, groups, fresh))
        count_chunk_update(self._dev, codes_t, meta_t, self.lags, self.n_groups,
                           self.A)
        self._since_flush += new_transitions

    @property
    def tables(self) -> Dict[int, np.ndarray]:
        """Host int64 tables {lag: [n_groups, rows(lag), A+1]} (flushes
        first)."""
        self.flush()
        return {
            l: self._host[l].reshape(
                self.n_groups, table_rows(l, self.A), self.A1
            )
            for l in self.lags
        }

    def merge_from(self, other: "TransitionCounter"):
        """Merge partial counts (cross-process reduction point)."""
        self.flush()
        other.flush()
        self._host_dirty = True
        for l in self.lags:
            self._host[l] += other._host[l]

    def validate(self, expected_transitions: Optional[int] = None):
        """Count-conservation invariant: every table must hold exactly the
        same grand total (= transitions counted, x2 if reverse). Returns the
        per-lag totals."""
        totals = {l: int(t.sum()) for l, t in self.tables.items()}
        values = set(totals.values())
        if len(values) > 1:
            raise AssertionError(f"count tables disagree on total transitions: {totals}")
        if expected_transitions is not None:
            want = expected_transitions * (2 if self.reverse else 1)
            got = next(iter(values)) if values else 0
            if got != want:
                raise AssertionError(
                    f"count conservation violated: counted {got}, expected {want}"
                )
        return totals

    def nonzero_rows(self, lag: int) -> np.ndarray:
        return np.nonzero(self.tables[lag].sum(axis=(0, 2)))[0]

    def _check_alphabet(self, alphabet: Optional[str]) -> str:
        alphabet = alphabet or self.alphabet
        if _alpha.alphabet_size(alphabet) != self.A:
            raise ValueError(
                f"count tables are base-{self.A}; alphabet {alphabet!r} has "
                f"{_alpha.alphabet_size(alphabet)} residues"
            )
        return alphabet

    def to_dataset(self, lag: int, alphabet: Optional[str] = None) -> CountDataset:
        """In-memory handoff to training on the host (no TSV round trip):
        the nonzero rows' contexts, codes and float64 counts
        [N, n_groups, A+1]."""
        alphabet = self._check_alphabet(alphabet)
        rows = self.nonzero_rows(lag)
        kmers = rows_to_contexts(rows, lag, alphabet)
        counts = self.tables[lag][:, rows, :].transpose(1, 0, 2).astype(np.float64)
        codes = (_alpha.encode_kmers(kmers, alphabet) if len(kmers)
                 else np.zeros((0, lag), np.int8))
        return CountDataset(kmers=kmers, codes=codes, counts=counts, alphabet=alphabet)

    def to_device_dataset(self, lag: int, alphabet: Optional[str] = None,
                          dtype=torch.float32):
        """Counts -> training handoff that stays on the device: the table
        never crosses to the host and no k-mer strings are built. Row
        totals of the resident table give the nonzero rows, decode_rows
        their codes, and one gather their counts.

        Once a flush has moved counts off the device, the device table
        alone no longer holds them all: the host accumulators' nonzero rows
        are uploaded instead. Returns (codes [N, lag] int8, counts
        [N, n_groups, A+1] in ``dtype``), tensors on the counter's device.
        Raises if a count exceeds ``dtype``'s exact integer range."""
        self._check_alphabet(alphabet)
        G, A1 = self.n_groups, self.A1
        n_rows = table_rows(lag, self.A)
        if self._dev is not None and not self._host_dirty:
            off = self._offsets[lag]
            table = self._dev[off : off + G * n_rows * A1].view(G, n_rows, A1)
            rows = torch.nonzero(table.sum(dim=(0, 2))).squeeze(1)
            counts = table[:, rows, :].permute(1, 0, 2).contiguous()
            _check_exact(int(counts.max()) if counts.numel() else 0, dtype)
            return decode_rows(rows, lag, self.A), counts.to(dtype)
        rows_np = self.nonzero_rows(lag)
        counts_np = self.tables[lag][:, rows_np, :].transpose(1, 0, 2)
        _check_exact(int(counts_np.max()) if counts_np.size else 0, dtype)
        dev = resolve_device(self.device)
        rows = torch.from_numpy(rows_np).to(dev)
        return (decode_rows(rows, lag, self.A),
                torch.from_numpy(counts_np).to(device=dev, dtype=dtype))


class _Staging:
    """One set of pinned host buffers for a chunk's two uploads (codes and
    meta), and the event recorded on the stream right after those copies."""

    def __init__(self):
        self.codes = torch.empty(0, dtype=torch.int8, pin_memory=True)
        self.meta = torch.empty((0, 4), dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()

    def upload(self, dev, codes, lengths, skip, stopped, groups, fresh):
        """Fill the buffers on the host and start their copies to ``dev``
        (non-blocking); returns the device (codes, meta)."""
        # The copies that last read these buffers may still be in flight:
        # writing the buffers before they end would change what the card
        # counts, silently. (A never-recorded event returns at once.)
        self.event.synchronize()
        B, L = codes.shape
        if self.codes.numel() < B * L:
            self.codes = torch.empty(B * L, dtype=torch.int8, pin_memory=True)
        if self.meta.shape[0] < B:
            self.meta = torch.empty((B, 4), dtype=torch.int32, pin_memory=True)
        host_codes = self.codes[: B * L].view(B, L)
        host_meta = self.meta[:B]
        np.copyto(host_codes.numpy(), codes, casting="unsafe")
        pack_meta(lengths, skip, stopped, groups, fresh, out=host_meta.numpy())
        with torch.cuda.device(dev):
            dev_codes = host_codes.to(dev, non_blocking=True)
            dev_meta = host_meta.to(dev, non_blocking=True)
            self.event.record(torch.cuda.current_stream(dev))
        return dev_codes, dev_meta


def chunk_passes(chunk: ReadChunk, reverse: bool = False):
    """(codes, lengths, skip, stopped, groups, fresh) of each kernel pass a
    chunk takes: the chunk itself, then, with ``reverse``, its reverse
    complement with the swapped boundary flags."""
    yield (chunk.codes, chunk.lengths, chunk.skip, chunk.stopped, chunk.groups,
           chunk.fresh)
    if reverse:
        rc, rlen = reverse_complement_codes(chunk.codes, chunk.lengths)
        st_rc, fr_rc = rc_boundary_flags(chunk)
        yield rc, rlen, chunk.skip, st_rc, chunk.groups, fr_rc


def reverse_complement_codes(codes: np.ndarray, lengths: np.ndarray):
    """RC on 2-bit codes: complement is 3 - c, reversal is per-row by length
    (vectorized gather; out-of-range slots read position 0 and stay masked)."""
    B, L = codes.shape
    j = np.arange(L)[None, :]
    src = lengths[:, None] - 1 - j
    valid = src >= 0
    rc = np.where(valid, 3 - codes[np.arange(B)[:, None], np.clip(src, 0, L - 1)], 0)
    return rc.astype(codes.dtype), lengths.copy()


def rc_boundary_flags(chunk: ReadChunk):
    """(stopped, fresh) flags for counting a chunk's reverse complement.

    Under reversal the true-read boundaries swap sides: the RC row may emit
    '['-prefix transitions iff the forward row ended at a true read end
    (stopped), and its '$' transition iff the forward row began at a true
    start (fresh). ``chunk.fresh is None`` means every row is fresh, NOT
    that every row is stopped, so the RC flags derive from both arrays.
    Length-0 rows are padding when stopped=False but real empty reads when
    stopped=True (their RC is the same empty read and keeps '[' -> '$').

    Returns (stopped_rc, fresh_rc); fresh_rc is None when all real rows are
    fresh AND stopped.
    """
    st = np.asarray(chunk.stopped, dtype=bool)
    real = np.asarray(chunk.lengths) > 0
    fr = (np.ones_like(st) if chunk.fresh is None
          else np.asarray(chunk.fresh, dtype=bool))
    if bool(((fr & st) | ~real).all()):
        return chunk.stopped, None
    return fr & (real | st), st


def split_ambiguous(
    encoded: Iterable[tuple], ambig_code: int = 4
) -> Iterable[tuple[np.ndarray, int, bool, bool]]:
    """Split encoded reads at ambiguous bases (code ``ambig_code``) into
    (piece, group, fresh, stop) items for chunk_reads.

    Any transition whose window (the lag-l context plus the next symbol)
    covers an ambiguous base is dropped. The first piece keeps its
    '['-padded prefix transitions, the last its '$' stop transition;
    interior boundaries emit neither. Per-lag validity is enforced by the
    ``fresh`` rule of :func:`chunk_keys`.
    """
    for item in encoded:
        arr, group = item[0], item[1]
        cuts = np.flatnonzero(arr == ambig_code)
        if len(cuts) == 0:
            yield arr, group, True, True
            continue
        bounds = np.concatenate([[-1], cuts, [len(arr)]])
        n_pieces = len(bounds) - 1
        for i in range(n_pieces):
            piece = arr[bounds[i] + 1 : bounds[i + 1]]
            if len(piece) == 0:
                continue  # nothing countable between adjacent ambig bases
            yield piece, group, i == 0, i == n_pieces - 1


def chunk_reads(
    encoded: Iterable[tuple],
    max_lag: int,
    batch_size: int = 1024,
    segment_len: int = 1 << 16,
    reverse: bool = False,
    max_chunk_elems: int = 1 << 25,
) -> Iterable[ReadChunk]:
    """Batch encoded reads (code_array, group) into padded ReadChunks.

    Items may also be (code_array, group, fresh, stop) — the output of
    split_ambiguous.

    Long sequences are split into segments of ``segment_len`` with a
    ``max_lag`` overlap carried as context only (skip = max_lag), so
    counting streams at constant memory. Chunks cap at ``max_chunk_elems``
    padded elements.

    reverse=True also emits each read's reverse complement as its own read
    BEFORE segmentation (the RC swaps fresh<->stop).
    """
    if reverse:
        def with_rc(stream):
            for item in stream:
                code_arr, group = item[0], item[1]
                f = bool(item[2]) if len(item) > 2 else True
                s = bool(item[3]) if len(item) > 3 else True
                yield code_arr, group, f, s
                yield (3 - code_arr[::-1]).astype(code_arr.dtype), group, s, f

        encoded = with_rc(encoded)

    # rows: codes, group, skip, stopped, fresh
    rows: List[tuple[np.ndarray, int, int, bool, bool]] = []
    run_maxlen = 0  # padded length of the widest pending row

    def emit():
        nonlocal rows, run_maxlen
        if not rows:
            return None
        maxlen = run_maxlen
        # Pad the row count to the batch size (element-budget-capped): zero-
        # length rows count nothing, and chunk shapes stay constant.
        B = max(
            len(rows),
            min(batch_size, max(1, max_chunk_elems // max(maxlen, 1))),
        )
        codes = np.zeros((B, maxlen), dtype=np.int8)
        lengths = np.zeros(B, dtype=np.int32)
        skip = np.zeros(B, dtype=np.int32)
        stopped = np.zeros(B, dtype=bool)
        groups = np.zeros(B, dtype=np.int32)
        fresh = np.ones(B, dtype=bool)
        for i, (c, g, s, st, fr) in enumerate(rows):
            codes[i, : len(c)] = c
            lengths[i] = len(c)
            skip[i] = s
            stopped[i] = st
            groups[i] = g
            fresh[i] = fr
        rows = []
        run_maxlen = 0
        return ReadChunk(codes, lengths, skip, stopped, groups,
                         None if fresh.all() else fresh)

    def push(row):
        """Append a row; returns a chunk to yield first if adding the row
        would push the pending batch past the element budget."""
        nonlocal run_maxlen
        padded = -(-len(row[0]) // PAD_LEN_ALIGN) * PAD_LEN_ALIGN
        flushed = None
        if rows and (len(rows) + 1) * max(run_maxlen, padded) > max_chunk_elems:
            flushed = emit()
        rows.append(row)
        run_maxlen = max(run_maxlen, padded)
        return flushed

    if segment_len < max_lag:
        raise ValueError(
            f"segment_len ({segment_len}) must be >= max_lag ({max_lag}): "
            "continuation segments carry a max_lag context overlap"
        )
    for item in encoded:
        code_arr, group = item[0], item[1]
        p_fresh = bool(item[2]) if len(item) > 2 else True
        p_stop = bool(item[3]) if len(item) > 3 else True
        n = len(code_arr)
        if n <= segment_len:
            pre = push((code_arr, group, 0, p_stop, p_fresh))
            if pre is not None:
                yield pre
        else:
            start = 0
            first = True
            while start < n:
                end = min(start + segment_len, n)
                seg_start = start if first else start - max_lag
                # Continuation segments are fresh=True: skip=max_lag already
                # drops every j < lag position, so the flag is inert there.
                pre = push((
                    code_arr[seg_start:end], group,
                    0 if first else max_lag,
                    (end == n) and p_stop,
                    p_fresh if first else True,
                ))
                if pre is not None:
                    yield pre
                if len(rows) >= batch_size:
                    yield emit()
                first = False
                start = end
        if len(rows) >= batch_size:
            yield emit()
    last = emit()
    if last is not None:
        yield last
