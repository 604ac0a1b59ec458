"""Transition counting with the count table split by context rows (port of
bear_tpu/parallel/counting.py's ``KmerShardedTransitionCounter``, one card).

Each shard owns the rows ``[d * stride, (d + 1) * stride)`` of every lag's
table, ``stride = ceil(rows(lag) / n_shards)``, so every index the device
computes stays local and below 2^31 even where the global table (DNA lags
14-15) does not. Counts drain from the device into a SPARSE host
accumulator of global int64 keys ``(g * rows(lag) + row) * (A+1) + next``:
a dense lag-15 host table would be 57 GB, while reads touch a small share
of its rows. ``MultiPassTransitionCounter`` (one card, the shard axis in
time: pass p plays shard p) and ``SparseTransitionCounter`` (no dense table
at all) share this host surface: ``nonzero_rows``, ``counts_for_rows``,
``to_dataset``, ``tables``, ``merge_from``, ``save_state``/``load_state``
(bear_tpu's ``.npz`` keys), ``export_tsv`` and ``validate``.

Here the counter runs on one card as one shard (the dense table with a
sparse host accumulator); spreading the shards over several cards is
ROADMAP.md Queue 1 item 13 and raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bear_tpu_torch.counting.count_chunk import count_chunk_update, table_rows
from bear_tpu_torch.counting.engine import (
    FLUSH_EVERY,
    ReadChunk,
    check_groups,
    extract_nonzero,
    rows_to_contexts,
    upload_chunk,
    write_tsv_shards,
)
from bear_tpu_torch.data.loaders import CountDataset
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.utils.device import resolve_device

_INT32_MAX = int(np.iinfo(np.int32).max)
# bear_tpu pads every device table to whole histogram blocks of its TPU
# kernel (pallas_hist.padded_size: WINDOW * BLOCKS entries); its guards
# test the padded size, and the port's refuse the same configurations.
_PAD_BLOCK = 32768 * 8


def padded_size(total: int) -> int:
    """``total`` rounded up to a whole 262,144-entry block (bear_tpu's
    padded table size, which its int32 guards test)."""
    return -(-total // _PAD_BLOCK) * _PAD_BLOCK


def not_ported_multi_card(what: str):
    raise NotImplementedError(
        f"{what} needs more than one card, which the port does not do yet; see "
        "ROADMAP.md Queue 1 item 13")


def check_context_codes(lags, A: int) -> None:
    """Dense row codes are int32 on the device: DNA lag <= 15, protein <= 7."""
    if A ** max(lags) > _INT32_MAX:
        raise ValueError(
            f"lag {max(lags)} context codes exceed int32 for a {A}-letter alphabet — "
            "use bear_tpu_torch.counting.sparse.SparseTransitionCounter (no dense "
            "table, DNA lag <= 30 / protein lag <= 13)")


class KmerShardedTransitionCounter:
    """Transition counting with each lag's table split into row ranges and a
    sparse int64 host accumulator.

    lags, n_groups, alphabet : as for TransitionCounter.
    n_shards : row ranges (cards) the table is split over; only 1 is ported.
    method : accepted for bear_tpu's signature and ignored (one kernel).
    device : where the row range's table lives and the kernel runs.
    """

    FLUSH_EVERY = FLUSH_EVERY

    def __init__(self, lags: Sequence[int], n_groups: int = 1, n_shards: int = 1,
                 method: str = "auto", alphabet: str = "dna", device="cuda"):
        if method not in ("auto", "scatter", "sorted"):
            raise ValueError(f"unknown counting method {method!r}")
        if n_shards > 1:
            not_ported_multi_card(f"a count table split over {n_shards} cards")
        self.alphabet = alphabet
        self.A = _alpha.alphabet_size(alphabet)
        self.A1 = self.A + 1
        self.lags = tuple(sorted(set(int(l) for l in lags)))
        check_context_codes(self.lags, self.A)
        self.n_groups = n_groups
        self.method = method
        self.device = torch.device(device)
        self._init_row_split(1, "use more devices on the kmer axis")

    def _init_row_split(self, n_shards: int, remedy: str):
        """Per-lag row ranges over ``n_shards`` (shard d owns rows
        [d*stride, (d+1)*stride); the last shard's rows past rows(lag) never
        match), the int32 guard on the padded local size, and the sparse
        host accumulator. The layout and the drain decomposition are shared
        with MultiPassTransitionCounter (bear_tpu's, exactly)."""
        self._per_lag: Dict[int, tuple] = {}
        loc_off = 0
        for l in self.lags:
            stride = -(-table_rows(l, self.A) // n_shards)
            self._per_lag[l] = (stride, stride, loc_off)
            loc_off += self.n_groups * stride * self.A1
        self._local_size = loc_off
        self._local_padded = padded_size(loc_off)
        if self._local_padded > _INT32_MAX:
            raise ValueError(
                f"per-shard table slice has {self._local_padded:,} entries, beyond "
                f"int32 indexing — {remedy}")
        # Sparse host accumulator: per lag, a list of (int64 keys, int64 counts).
        self._sparse: Dict[int, list] = {l: [] for l in self.lags}
        self._consolidated_lags: set = set()  # lags whose one part is unique + sorted
        self._grk_cache: Dict[int, tuple] = {}  # lag -> (keys, g, r, k)
        self._dev: Optional[torch.Tensor] = None
        self._since_flush = 0
        self._shard = 0
        self._staging: list = []

    @property
    def max_lag(self) -> int:
        return max(self.lags)

    @property
    def table_size(self) -> int:
        """Entries of the int32 device table (one row range, all lags)."""
        return self._local_size

    # --- device side ------------------------------------------------------

    def _ensure_dev(self):
        if self._dev is None:
            self._dev = torch.zeros(self._local_size, dtype=torch.int32,
                                    device=resolve_device(self.device))

    def add_chunk(self, chunk: ReadChunk):
        """Count a chunk's transitions whose context row lies in the current
        row range (one count_chunk launch on the card)."""
        check_groups(chunk.groups, self.n_groups)
        codes = np.asarray(chunk.codes)
        new_transitions = codes.shape[0] * (codes.shape[1] + 1)
        if self._since_flush + new_transitions > self.FLUSH_EVERY:
            self.flush()
        self._ensure_dev()
        codes_t, meta_t = upload_chunk(self._staging, self._dev.device, codes, chunk.lengths,
                                       chunk.skip, chunk.stopped, chunk.groups, chunk.fresh)
        count_chunk_update(self._dev, codes_t, meta_t, self.lags, self.n_groups, self.A,
                           shard=(self._shard, self._per_lag))
        self._since_flush += new_transitions

    def flush(self):
        """Drain the device table's nonzero entries into the host accumulator
        (global keys) and drop the table."""
        if self._dev is None or self._since_flush == 0:
            return
        self._drain_part(self._dev, self._shard)
        self._dev = None
        self._since_flush = 0

    def sync(self):
        """Block until all queued device counting work has completed."""
        if self._dev is not None and self._dev.is_cuda:
            torch.cuda.synchronize(self._dev.device)

    def _drain_part(self, part: torch.Tensor, d: int):
        """Decompose one row range's nonzero local entries into GLOBAL int64
        keys ``(g * rows(lag) + d*stride + r) * (A+1) + k`` and append them
        to the sparse accumulator (in bounded pieces: extract_nonzero)."""
        A1 = self.A1
        for idx, vals in extract_nonzero(part):
            for l in self.lags:
                stride, local_rows, loc_off = self._per_lag[l]
                span = self.n_groups * local_rows * A1
                sel = (idx >= loc_off) & (idx < loc_off + span)
                if not sel.any():
                    continue
                t = idx[sel] - loc_off
                g = t // (local_rows * A1)
                r = (t % (local_rows * A1)) // A1
                k = t % A1
                key = (g * table_rows(l, self.A) + d * stride + r) * A1 + k
                self._sparse[l].append((key, vals[sel]))
                self._consolidated_lags.discard(l)

    # --- host side --------------------------------------------------------

    def _consolidated(self, lag: int):
        """(sorted unique int64 keys, int64 counts) of one lag. The same key
        array object comes back until new counts merge in (the staleness
        probe of SparseTableIndex and the ``_grk_cache`` rely on it)."""
        self.flush()
        parts = self._sparse[lag]
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if lag in self._consolidated_lags and len(parts) == 1:
            return parts[0]
        keys = np.concatenate([p[0] for p in parts])
        vals = np.concatenate([p[1] for p in parts])
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
        uniq = keys[starts]
        exact = (np.add.reduceat(vals[order], starts) if len(starts)
                 else np.zeros(0, np.int64))
        self._sparse[lag] = [(uniq, exact)]
        self._consolidated_lags.add(lag)
        return uniq, exact

    def nonzero_rows(self, lag: int) -> np.ndarray:
        """Ascending int64 table rows with any count in any group."""
        keys, _ = self._consolidated(lag)
        return np.unique(keys // self.A1 % table_rows(lag, self.A))

    def counts_for_rows(self, lag: int, rows: np.ndarray) -> np.ndarray:
        """Dense int64 [len(rows), n_groups, A+1] counts of the given rows
        (repeated rows each get their counts)."""
        keys, vals = self._consolidated(lag)
        A1 = self.A1
        out = np.zeros((len(rows), self.n_groups, A1), np.int64)
        if len(rows) == 0 or len(keys) == 0:
            return out
        # searchsorted maps each key to ONE position, so repeated query rows
        # are answered over the sorted unique rows and expanded at the end.
        uniq_rows, inv_rows = np.unique(np.asarray(rows), return_inverse=True)
        out_u = np.zeros((len(uniq_rows), self.n_groups, A1), np.int64)
        # The (g, r, k) split of the consolidated keys holds until they
        # change: repeated queries (one per scoring call) reuse it, keyed on
        # the identity of the key array.
        cache = self._grk_cache.get(lag)
        if cache is None or cache[0] is not keys:
            n_rows = table_rows(lag, self.A)
            g, r, k = keys // A1 // n_rows, keys // A1 % n_rows, keys % A1
            self._grk_cache[lag] = (keys, g, r, k)
        else:
            _, g, r, k = cache
        pos = np.searchsorted(uniq_rows, r)
        hit = (pos < len(uniq_rows)) & (uniq_rows[np.clip(pos, 0, len(uniq_rows) - 1)] == r)
        out_u[pos[hit], g[hit], k[hit]] = vals[hit]
        out[...] = out_u[inv_rows.reshape(-1)]
        return out

    def to_dataset(self, lag: int, alphabet: Optional[str] = None) -> CountDataset:
        """In-memory handoff to training on the host: the nonzero rows'
        contexts, codes and float64 counts [N, n_groups, A+1]."""
        alphabet = alphabet or self.alphabet
        if _alpha.alphabet_size(alphabet) != self.A:
            raise ValueError(
                f"count tables are base-{self.A}; alphabet {alphabet!r} has "
                f"{_alpha.alphabet_size(alphabet)} residues")
        rows = self.nonzero_rows(lag)
        kmers = rows_to_contexts(rows, lag, alphabet)
        counts = self.counts_for_rows(lag, rows).astype(np.float64)
        codes = (_alpha.encode_kmers(kmers, alphabet) if len(kmers)
                 else np.zeros((0, lag), np.int8))
        return CountDataset(kmers=kmers, codes=codes, counts=counts, alphabet=alphabet)

    def merge_from(self, other: "KmerShardedTransitionCounter"):
        """Merge another counter's partial counts (the reduction point across
        processes or jobs)."""
        self.flush()
        other.flush()
        for l in self.lags:
            self._sparse[l].extend(other._sparse[l])
            self._consolidated_lags.discard(l)

    @property
    def tables(self) -> Dict[int, np.ndarray]:
        """Dense host tables {lag: [n_groups, rows, A+1]}, only where they fit
        the host (at most 2^33 entries); else use nonzero_rows /
        counts_for_rows."""
        out = {}
        for l in self.lags:
            entries = self.n_groups * table_rows(l, self.A) * self.A1
            if entries > (1 << 33):
                raise ValueError(
                    f"dense lag-{l} host table would hold {entries:,} int64 entries; "
                    "use nonzero_rows/counts_for_rows instead")
            keys, vals = self._consolidated(l)
            tab = np.zeros(entries, np.int64)
            tab[keys] = vals
            out[l] = tab.reshape(self.n_groups, table_rows(l, self.A), self.A1)
        return out

    def save_state(self, path: str):
        """Checkpoint the accumulated counts as bear_tpu's ``.npz`` layout
        (keys_{lag}, vals_{lag}), so either package loads the other's."""
        self.flush()
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it; keep load_state symmetric
        arrays = {}
        for l in self.lags:
            keys, vals = self._consolidated(l)
            arrays[f"keys_{l}"] = keys
            arrays[f"vals_{l}"] = vals
        np.savez_compressed(
            path, lags=np.array(self.lags), n_groups=np.array(self.n_groups),
            alphabet=np.array(self.alphabet),
            reverse=np.array(getattr(self, "reverse", False)), **arrays)

    def load_state(self, path: str):
        """Add the counts of a :meth:`save_state` file to THIS counter (its
        lags, groups, alphabet and reverse flag must match)."""
        with np.load(path) as data:
            ckpt_alpha = str(data["alphabet"]) if "alphabet" in data else "dna"
            ckpt_rev = bool(data["reverse"]) if "reverse" in data else False
            if (tuple(int(l) for l in data["lags"]) != self.lags
                    or int(data["n_groups"]) != self.n_groups
                    or ckpt_alpha != self.alphabet
                    or ckpt_rev != bool(getattr(self, "reverse", False))):
                raise ValueError("checkpoint lags/n_groups/reverse/alphabet do not match counter")
            self.flush()
            for l in self.lags:
                self._sparse[l].append((data[f"keys_{l}"].astype(np.int64),
                                        data[f"vals_{l}"].astype(np.int64)))
                self._consolidated_lags.discard(l)

    def export_tsv(self, out_prefix: str, lag: int, n_bin_bits: int = 0, seed: int = 0,
                   shuffle: bool = False, rows=None, native: bool = True):
        """Reference-format TSV shards (see engine.write_tsv_shards)."""
        if rows is None:
            rows = self.nonzero_rows(lag)
        return write_tsv_shards(out_prefix, lag, rows, self.counts_for_rows(lag, rows),
                                n_bin_bits, seed=seed, shuffle=shuffle,
                                alphabet=self.alphabet, native=native)

    def validate(self, expected_transitions=None):
        """Count conservation: every lag holds the same grand total (and it
        equals ``expected_transitions`` when given). Returns the totals."""
        totals = {l: int(self._consolidated(l)[1].sum()) for l in self.lags}
        values = set(totals.values())
        if len(values) > 1:
            raise AssertionError(f"count tables disagree on total transitions: {totals}")
        if expected_transitions is not None:
            got = next(iter(values)) if values else 0
            if got != expected_transitions:
                raise AssertionError(
                    f"count conservation violated: counted {got}, expected "
                    f"{expected_transitions}")
        return totals
