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
    output: ``nonzero_rows``, ``row_counts``, ``validate`` and
            ``export_tsv`` read the device table while it holds every count
            (only the nonzero rows cross to the host), the host
            accumulators after a flush; ``table`` gives one lag's counts
            on the device (the resident table itself, not a copy);
            ``write_tsv_shards`` writes
            bear_tpu's TSV shards byte for byte; ``save_state`` /
            ``load_state`` keep bear_tpu's ``.npz`` layout

``chunks_from_packed`` packs the native parser's whole-file buffers into
ReadChunks (the summarize path); ``chunk_reads`` batches streamed reads.

The table layout and the chunk's index math live in
:mod:`bear_tpu_torch.counting.count_chunk`. Counts never clamp: the device
accumulates int32 per flush window and the host accumulator is int64.
"""

from __future__ import annotations

import glob
import os
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
from bear_tpu_torch.counting.native import load as load_native
from bear_tpu_torch.data.loaders import CountDataset
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.utils.device import resolve_device
from bear_tpu_torch.utils.profiling import span

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


def rows_to_context_bytes(rows, lag: int, alphabet: str = "dna") -> np.ndarray:
    """Vectorized inverse of context_to_row: row indices -> contexts as an
    ``S{lag}`` byte-string array."""
    letters_s = "".join(_alpha.input_letters(alphabet)[:-1])
    A = len(letters_s)
    rows = np.asarray(rows, dtype=np.int64)
    bounds = np.array([(A**k - 1) // (A - 1) for k in range(lag + 2)], dtype=np.int64)
    m = np.searchsorted(bounds, rows, side="right") - 1  # suffix length
    rem = rows - bounds[m]
    letters = np.frombuffer(letters_s.encode(), dtype=np.uint8)
    chars = np.empty((len(rows), lag), dtype=np.uint8)
    for i in range(lag):  # digit i is the (i+1)-th letter from the right
        chars[:, lag - 1 - i] = np.where(i < m, letters[rem % A], ord("["))
        rem //= A
    return chars.view(f"S{lag}").reshape(-1)


def rows_to_contexts(rows, lag: int, alphabet: str = "dna") -> np.ndarray:
    """Vectorized inverse of context_to_row: row indices -> context
    strings."""
    return np.char.decode(rows_to_context_bytes(rows, lag, alphabet), "ascii")


def row_to_context(row: int, lag: int, alphabet: str = "dna") -> str:
    """Host-side inverse of context_to_row."""
    return str(rows_to_contexts(np.array([row]), lag, alphabet)[0])


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
                f"{self.A}-letter alphabet — use "
                "bear_tpu_torch.counting.sparse.SparseTransitionCounter (no dense "
                "table, DNA lag <= 30 / protein lag <= 13)"
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
                "TransitionCounters, reduce n_groups or count in row-range passes "
                "(counting.multipass)"
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
            with span("bear.count.table_alloc"):
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
        with span("bear.count.flush"):
            if self._dev is not None and self._since_flush > 0:
                self._fold(self._dev)
                self._dev.zero_()
                self._since_flush = 0
                self._host_dirty = True

    def _fold(self, dev: torch.Tensor):
        """Add a flat int32 device table into the host accumulators: only
        its nonzero entries where they are few, else the whole table."""
        nnz = int(torch.count_nonzero(dev))
        if nnz * 3 < dev.numel():
            for idx, vals in extract_nonzero(dev):
                self._scatter_host(idx, vals)
        else:
            dense = dev.cpu().numpy()
            for l in self.lags:
                off = self._offsets[l]
                self._host[l] += dense[off : off + self._host[l].size]

    def _scatter_host(self, idx: np.ndarray, vals: np.ndarray):
        """Route concatenated-buffer indices into the per-lag host tables."""
        bounds = [self._offsets[l] for l in self.lags] + [self._total_size]
        for i, l in enumerate(self.lags):
            sel = (idx >= bounds[i]) & (idx < bounds[i + 1])
            if sel.any():
                self._host[l][idx[sel] - bounds[i]] += vals[sel]

    def add_chunk(self, chunk: ReadChunk):
        with span("bear.count.add_chunk"):
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
        codes_t, meta_t = upload_chunk(self._staging, self._dev.device, codes, lengths,
                                       skip, stopped, groups, fresh)
        with span("bear.count.launch"):
            count_chunk_update(self._dev, codes_t, meta_t, self.lags, self.n_groups,
                               self.A)
        self._since_flush += new_transitions

    @property
    def max_lag(self) -> int:
        return max(self.lags)

    @property
    def table_size(self) -> int:
        """Entries of the flat int32 device table, all lags and groups."""
        return self._total_size

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

    def _resident(self) -> bool:
        """Whether the device table alone holds every count: nothing has
        been flushed to the host accumulators yet."""
        return self._dev is not None and not self._host_dirty

    def _device_table(self, lag: int) -> torch.Tensor:
        """The device table of one lag, a [n_groups, rows(lag), A+1] view."""
        n_rows = table_rows(lag, self.A)
        off = self._offsets[lag]
        return self._dev[off : off + self.n_groups * n_rows * self.A1].view(
            self.n_groups, n_rows, self.A1)

    def table(self, lag: int) -> torch.Tensor:
        """The counts of one lag, [n_groups, rows(lag), A+1], as a tensor on
        the counter's device: while the device table holds every count, that
        int32 table itself (a view, no copy); else the host int64
        accumulators, uploaded."""
        if self._resident():
            return self._device_table(lag)
        return torch.from_numpy(self.tables[lag]).to(resolve_device(self.device))

    def merge_from(self, other: "TransitionCounter"):
        """Merge partial counts (cross-process reduction point)."""
        self.flush()
        other.flush()
        self._host_dirty = True
        for l in self.lags:
            self._host[l] += other._host[l]

    def save_state(self, path: str):
        """Checkpoint the accumulated counts (flushes first) as bear_tpu's
        ``.npz`` layout, so either package loads the other's file."""
        self.flush()
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it; keep load_state symmetric
        np.savez_compressed(
            path,
            lags=np.array(self.lags),
            n_groups=np.array(self.n_groups),
            reverse=np.array(self.reverse),
            alphabet=np.array(self.alphabet),
            **{f"table_{l}": self._host[l] for l in self.lags},
        )

    @classmethod
    def load_state(cls, path: str, device="cuda") -> "TransitionCounter":
        """A counter holding a :meth:`save_state` file's counts (on the
        host), counting further on ``device``."""
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as data:
            tc = cls(
                lags=[int(l) for l in data["lags"]],
                n_groups=int(data["n_groups"]),
                reverse=bool(data["reverse"]),
                alphabet=str(data["alphabet"]) if "alphabet" in data else "dna",
                device=device,
            )
            for l in tc.lags:
                tc._host[l] = data[f"table_{l}"].astype(np.int64)
        tc._host_dirty = True
        return tc

    def validate(self, expected_transitions: Optional[int] = None):
        """Count-conservation invariant: every table must hold exactly the
        same grand total (= transitions counted, x2 if reverse). Returns the
        per-lag totals, summed on the device while its table holds every
        count, else on the host accumulators."""
        if self._resident():
            totals = {l: int(self._device_table(l).sum(dtype=torch.int64))
                      for l in self.lags}
        else:
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
        """Ascending int64 table rows with any count in any group. While the
        device table holds every count, the row totals are taken there and
        only the nonzero rows cross to the host (a lag-13 table is GBs)."""
        if self._resident():
            totals = self._device_table(lag).sum(dim=(0, 2))
            return torch.nonzero(totals).squeeze(1).cpu().numpy().astype(np.int64)
        return np.nonzero(self.tables[lag].sum(axis=(0, 2)))[0]

    def row_counts(self, lag: int, rows: np.ndarray) -> np.ndarray:
        """int64 counts [len(rows), n_groups, A+1] of the given table rows:
        gathered on the device while its table holds every count, else
        from the host accumulators."""
        if self._resident():
            idx = torch.as_tensor(np.asarray(rows, np.int64), device=self._dev.device)
            picked = self._device_table(lag)[:, idx, :].permute(1, 0, 2)
            return picked.cpu().numpy().astype(np.int64)
        return self.tables[lag][:, rows, :].transpose(1, 0, 2)

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
        counts = self.row_counts(lag, rows).astype(np.float64)
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
        if self._resident():
            table = self._device_table(lag)
            rows = torch.nonzero(table.sum(dim=(0, 2))).squeeze(1)
            counts = table[:, rows, :].permute(1, 0, 2).contiguous()
            _check_exact(int(counts.max()) if counts.numel() else 0, dtype)
            return decode_rows(rows, lag, self.A), counts.to(dtype)
        rows_np = self.nonzero_rows(lag)
        counts_np = self.row_counts(lag, rows_np)
        _check_exact(int(counts_np.max()) if counts_np.size else 0, dtype)
        dev = resolve_device(self.device)
        rows = torch.from_numpy(rows_np).to(dev)
        return (decode_rows(rows, lag, self.A),
                torch.from_numpy(counts_np).to(device=dev, dtype=dtype))

    def export_tsv(self, out_prefix: str, lag: int, n_bin_bits: int = 0, seed: int = 0,
                   shuffle: bool = False, rows: Optional[np.ndarray] = None,
                   native: bool = True):
        """Write reference-format TSVs ``{out_prefix}_lag_{lag}_file_{b}.tsv``
        (see :func:`write_tsv_shards`). Row totals, nonzero rows and their
        counts come from the device while its table holds every count."""
        if rows is None:
            rows = self.nonzero_rows(lag)
        return write_tsv_shards(out_prefix, lag, rows, self.row_counts(lag, rows),
                                n_bin_bits, seed=seed, shuffle=shuffle,
                                alphabet=self.alphabet, native=native)


def write_tsv_shards(out_prefix: str, lag: int, rows: np.ndarray,
                     per_row_counts: np.ndarray, n_bin_bits: int = 0, seed: int = 0,
                     shuffle: bool = False, alphabet: str = "dna",
                     native: bool = True) -> List[str]:
    """Write reference-format count TSV shards for the given table rows
    (bear_tpu's ``write_tsv_shards``, byte for byte).

    rows: [n] table rows; per_row_counts: [n, n_groups, A+1] aligned with
    them. Lines are ``kmer\\t[[g0 counts],[g1 counts],...]``. Rows go
    uniformly at random into 2^n_bin_bits files and, with ``shuffle``, in
    random order within each, both from ``np.random.default_rng(seed)``.
    Shards numbered beyond this run's count from an earlier run with the
    same prefix are removed. ``native`` formats with the C++ formatter
    (one call per shard), else with the per-row Python formatter."""
    rng = np.random.default_rng(seed)
    n_bins = 2**n_bin_bits
    if shuffle:
        perm = rng.permutation(len(rows))
        rows, per_row_counts = rows[perm], per_row_counts[perm]
    bins = (rng.integers(0, n_bins, size=len(rows)) if n_bins > 1
            else np.zeros(len(rows), int))
    paths = [f"{out_prefix}_lag_{lag}_file_{b}.tsv" for b in range(n_bins)]
    # Stale higher-numbered shards would be merged in by glob consumers
    # (check_summarize, training on a file prefix).
    for stale in glob.glob(f"{out_prefix}_lag_{lag}_file_*.tsv"):
        suffix = stale.rsplit("_file_", 1)[1][:-4]
        if suffix.isdigit() and int(suffix) >= n_bins:
            os.remove(stale)
    kmers_b = rows_to_context_bytes(rows, lag, alphabet)
    # One shard at a time (2^12+ shards would exceed the open-file limit);
    # a stable argsort gives each shard's rows, in order, as one slice.
    order = np.argsort(bins, kind="stable")
    bounds = np.searchsorted(bins[order], np.arange(n_bins + 1))
    lib = load_native() if native else None
    kmers = None if native else np.char.decode(kmers_b, "ascii")
    for b, p in enumerate(paths):
        sel = order[bounds[b] : bounds[b + 1]]
        if lib is not None:
            with open(p, "wb") as fh:
                fh.write(lib.format_tsv(kmers_b[sel], per_row_counts[sel]))
            continue
        with open(p, "w") as fh:
            for i in sel:
                mat = "[[" + "],[".join(
                    ",".join(str(int(c)) for c in per_row_counts[i, g])
                    for g in range(per_row_counts.shape[1])) + "]]"
                fh.write(f"{kmers[i]}\t{mat}\n")
    return paths


def upload_chunk(staging: list, device: torch.device, codes, lengths, skip, stopped,
                 groups, fresh=None):
    """(codes int8 [B, L], meta int32 [B, 4]) of a chunk's rows on
    ``device``. On the card they go through ``staging``, the caller's list
    of two pinned :class:`_Staging` sets (made at the first call), used in
    turn, so one chunk's copies overlap the previous chunk's kernel; on the
    CPU they are plain tensors."""
    if device.type != "cuda":
        return (torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)),
                torch.from_numpy(pack_meta(lengths, skip, stopped, groups, fresh)))
    if not staging:
        staging += [_Staging(), _Staging()]
    staging.reverse()  # alternate between the two sets
    return staging[0].upload(device, np.asarray(codes), lengths, skip, stopped, groups,
                             fresh)


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
        with span("bear.count.stage_wait"):
            self.event.synchronize()
        with span("bear.count.stage"):
            B, L = codes.shape
            if self.codes.numel() < B * L:
                self.codes = torch.empty(B * L, dtype=torch.int8, pin_memory=True)
            if self.meta.shape[0] < B:
                self.meta = torch.empty((B, 4), dtype=torch.int32, pin_memory=True)
            host_codes = self.codes[: B * L].view(B, L)
            host_meta = self.meta[:B]
            np.copyto(host_codes.numpy(), codes, casting="unsafe")
            pack_meta(lengths, skip, stopped, groups, fresh, out=host_meta.numpy())
        with span("bear.count.upload"), torch.cuda.device(dev):
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


def chunks_from_packed(
    codes_flat: np.ndarray,
    offsets: np.ndarray,
    groups,
    max_lag: int,
    batch_size: int = 1024,
    segment_len: int = 1 << 16,
    reverse: bool = False,
    max_chunk_elems: int = 1 << 25,
    ambig_code: int | None = None,
    native: bool = True,
) -> Iterable[ReadChunk]:
    """Padded ReadChunks straight from a packed read buffer (bear_tpu's
    ``chunks_from_packed``, chunk for chunk): the native parser gives a
    whole file as (codes_flat, offsets), and each chunk's rows are filled
    with one memcpy or reverse-complement copy per row
    (``bear_fill_chunks``; ``native=False``: a NumPy gather, the same
    bytes). No per-read Python loop.

    groups: scalar or [n_reads] per-read group ids.
    Long reads split into ``segment_len`` segments with a max_lag overlap
    (the skip rule of :func:`chunk_reads`). reverse=True also packs each
    read's reverse complement, after all forward rows. Chunks are capped at
    ``max_chunk_elems`` padded elements, so long segments shrink the row
    count instead of widening the chunk.

    ambig_code: when set (parse with ambig=True -> code 4), reads split at
    ambiguous bases into pieces: the first keeps its '['-prefix
    transitions, the last its '$' transition, and every transition whose
    window crosses the ambiguous base is dropped (:func:`split_ambiguous`'s
    semantics). Pieces reference the original buffer.
    """
    if segment_len < max_lag:
        raise ValueError(
            f"segment_len ({segment_len}) must be >= max_lag ({max_lag}): "
            "continuation segments carry a max_lag context overlap"
        )
    codes_flat = np.ascontiguousarray(codes_flat, dtype=np.int8)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths_all = np.diff(offsets)
    n_reads = len(lengths_all)
    if n_reads == 0:
        return
    groups = np.broadcast_to(np.asarray(groups, dtype=np.int32), (n_reads,))
    read_starts = offsets[:-1]
    read_fresh = read_stop = None  # None = all True
    if ambig_code is not None:
        amb = np.flatnonzero(codes_flat == ambig_code)
        if len(amb):
            # Expand reads into N-free pieces. Positions amb lie strictly
            # inside their read, so a 'right' search is exact even next to
            # empty reads.
            cut_read = np.searchsorted(offsets, amb, side="right") - 1
            n_cuts = np.bincount(cut_read, minlength=n_reads)
            cut_base = np.concatenate([[0], np.cumsum(n_cuts)[:-1]])
            per_read = n_cuts + 1
            piece_read = np.repeat(np.arange(n_reads), per_read)
            piece_ord = np.arange(len(piece_read)) - np.repeat(
                np.concatenate([[0], np.cumsum(per_read)[:-1]]), per_read)
            cut_at = cut_base[piece_read] + piece_ord
            p_starts = np.where(piece_ord == 0, offsets[piece_read],
                                amb[np.clip(cut_at - 1, 0, len(amb) - 1)] + 1)
            last = piece_ord == n_cuts[piece_read]
            p_ends = np.where(last, offsets[piece_read + 1],
                              amb[np.clip(cut_at, 0, len(amb) - 1)])
            fresh_p = piece_ord == 0
            # Empty pieces stay only for reads that were empty to begin with
            # (their '[' -> '$' transition); pieces emptied by a split
            # count nothing.
            keep = (p_ends > p_starts) | (fresh_p & last & (n_cuts[piece_read] == 0))
            read_starts = p_starts[keep]
            lengths_all = (p_ends - p_starts)[keep]
            groups = groups[piece_read[keep]]
            read_fresh = fresh_p[keep]
            read_stop = last[keep]
            n_reads = len(read_starts)
            if n_reads == 0:
                return
    lib = load_native() if native else None

    # Expand reads into (start, seg_len, skip, stopped, group) segment rows.
    n_segs = np.maximum(1, -(-lengths_all // segment_len)).astype(np.int64)
    seg_read = np.repeat(np.arange(n_reads), n_segs)
    seg_ord = np.arange(len(seg_read)) - np.repeat(
        np.concatenate([[0], np.cumsum(n_segs)[:-1]]), n_segs)
    seg_begin = seg_ord * segment_len  # position within the read
    read_len = lengths_all[seg_read]
    seg_end = np.minimum(seg_begin + segment_len, read_len)
    first = seg_ord == 0
    start_in_read = np.where(first, seg_begin, seg_begin - max_lag)
    seg_lengths = seg_end - start_in_read
    skip = np.where(first, 0, max_lag).astype(np.int32)
    at_end = seg_end == read_len
    seg_groups = groups[seg_read]
    # Boundary flags per strand: under reversal fresh and stop swap sides;
    # continuation segments are fresh (skip = max_lag already drops their
    # j < lag positions).
    if read_fresh is None:
        flags = {False: (at_end, None), True: (at_end, None)}
    else:
        flags = {
            False: (at_end & read_stop[seg_read], read_fresh[seg_read] | ~first),
            True: (at_end & read_fresh[seg_read], read_stop[seg_read] | ~first),
        }

    order = np.arange(len(seg_read))
    for rc in [False] + ([True] if reverse else []):
        s = 0
        while s < len(order):
            look = order[s : s + batch_size]
            # Long segments take fewer rows per chunk. Shrinking B can drop
            # the wide rows that forced the shrink, so the width is
            # recomputed over the kept prefix until it is stable.
            B = len(look)
            while True:
                L = int(seg_lengths[look[:B]].max())
                L = -(-L // PAD_LEN_ALIGN) * PAD_LEN_ALIGN
                B_new = max(1, min(len(look), max_chunk_elems // max(L, 1)))
                if B_new >= B:
                    break
                B = B_new
            sel = look[:B]
            s += len(sel)
            # Trailing partial chunks keep the budgeted (B, L) shape.
            B = max(len(sel), min(batch_size, max(1, max_chunk_elems // max(L, 1))))
            out = np.zeros((B, L), dtype=np.int8)
            lens = np.zeros(B, dtype=np.int32)
            lens[: len(sel)] = seg_lengths[sel]
            # The RC read has the same length and segmentation; its
            # position p reads the complement of forward position
            # read_len - 1 - p, so the copy starts at the range's last
            # forward base and walks backward.
            if rc:
                starts_abs = (read_starts[seg_read[sel]] + read_len[sel] - 1
                              - start_in_read[sel])
            else:
                starts_abs = read_starts[seg_read[sel]] + start_in_read[sel]
            if lib is not None:
                lib.fill_chunks(codes_flat, starts_abs, seg_lengths[sel],
                                np.full(len(sel), rc, np.uint8), out)
            else:
                j = np.arange(L)[None, :]
                src = starts_abs[:, None] + (-1 if rc else 1) * j
                valid = j < seg_lengths[sel][:, None]
                vals = codes_flat[np.clip(src, 0, len(codes_flat) - 1)]
                if rc:
                    vals = 3 - vals
                out[: len(sel)] = np.where(valid, vals, 0)
            sk = np.zeros(B, dtype=np.int32)
            st = np.zeros(B, dtype=bool)
            gr = np.zeros(B, dtype=np.int32)
            stopped_v, fresh_v = flags[rc]
            sk[: len(sel)] = skip[sel]
            st[: len(sel)] = stopped_v[sel]
            gr[: len(sel)] = seg_groups[sel]
            fr = None
            if fresh_v is not None:
                fr = np.ones(B, dtype=bool)
                fr[: len(sel)] = fresh_v[sel]
                if fr.all():
                    fr = None
            yield ReadChunk(out, lens, sk, st, gr, fr)
