"""Counting over a device mesh (port of bear_tpu/parallel/counting.py).

Two ways to spread counting over the devices of a :class:`Mesh`:

- ``ShardedTransitionCounter`` splits each chunk's ROWS over the ``data``
  axis. Each device counts its rows into its own replica of the dense
  int32 table (one count_chunk launch per device per chunk and pass), and
  a flush sums the replicas exactly into int64 host tables.
- ``KmerShardedTransitionCounter`` splits each lag's table ROWS over the
  ``kmer`` axis. Every device gets the whole chunk and counts, by
  count_chunk's row-range form, only the transitions whose context row is
  its own, so every index it computes stays local and below 2^31 even
  where the global table (DNA lags 14-15) does not.

Row ranges: shard d owns the rows ``[d * stride, (d + 1) * stride)`` of
every lag's table, ``stride = ceil(rows(lag) / n_shards)``. Counts drain
from the devices into a SPARSE host accumulator of global int64 keys ``(g *
rows(lag) + row) * (A+1) + next``: a dense lag-15 host table would be
57 GB, while reads touch a small share of its rows. Without a mesh the
counter holds one row range on one device: ``MultiPassTransitionCounter``
(the shard axis in time: pass p plays shard p) and
``SparseTransitionCounter`` (no dense table at all) build on that form and
share this host surface: ``nonzero_rows``, ``counts_for_rows``,
``to_dataset``, ``tables``, ``merge_from``, ``save_state``/``load_state``
(bear_tpu's ``.npz`` keys), ``export_tsv`` and ``validate``.

On a mesh with axes beyond the counter's own, bear_tpu replicates each
slice over them and drains one replica; the port keeps only that one, on
the device at index 0 of every other axis (``Mesh.along``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bear_tpu_torch.counting.count_chunk import count_chunk_update, lag_offsets, table_rows
from bear_tpu_torch.counting.engine import (
    FLUSH_EVERY,
    ReadChunk,
    TransitionCounter,
    check_groups,
    extract_nonzero,
    rows_to_contexts,
    upload_chunk,
    write_tsv_shards,
)
from bear_tpu_torch.data.loaders import CountDataset
from bear_tpu_torch.ops import alphabets as _alpha
from bear_tpu_torch.parallel.mesh import Mesh
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


def check_context_codes(lags, A: int) -> None:
    """Dense row codes are int32 on the device: DNA lag <= 15, protein <= 7."""
    if A ** max(lags) > _INT32_MAX:
        raise ValueError(
            f"lag {max(lags)} context codes exceed int32 for a {A}-letter alphabet — "
            "use bear_tpu_torch.counting.sparse.SparseTransitionCounter (no dense "
            "table, DNA lag <= 30 / protein lag <= 13)")


def check_method(method: str) -> None:
    if method not in ("auto", "scatter", "sorted"):
        raise ValueError(f"unknown counting method {method!r}")


def split_rows(rows, n: int) -> list:
    """A chunk's (codes, lengths, skip, stopped, groups, fresh) split into
    ``n`` equal row blocks, one per device, after padding the rows to a
    multiple of ``n`` with zero-length, unstopped, fresh rows that count
    nothing (bear_tpu's pad, parallel/counting.py:185-194)."""
    codes, lengths, skip, stopped, groups, fresh = (
        None if a is None else np.asarray(a) for a in rows)
    B, L = codes.shape
    pad = (-B) % n
    if pad:
        codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
        skip = np.concatenate([skip, np.zeros(pad, skip.dtype)])
        stopped = np.concatenate([stopped, np.zeros(pad, bool)])
        groups = np.concatenate([groups, np.zeros(pad, groups.dtype)])
        if fresh is not None:
            fresh = np.concatenate([fresh, np.ones(pad, bool)])
    Bl = (B + pad) // n
    return [tuple(None if a is None else a[d * Bl : (d + 1) * Bl]
                  for a in (codes, lengths, skip, stopped, groups, fresh))
            for d in range(n)]


class ShardedTransitionCounter(TransitionCounter):
    """Counting with each chunk's rows split over the ``data`` axis of a
    mesh: the multi-device form of TransitionCounter.

    Every device counts its block of rows (a chunk padded to a multiple of
    the axis size) into its own int32 replica of the dense table; a flush
    sums the replicas on the first device, exact in int32 below
    FLUSH_EVERY transitions, and folds the sum into the int64 host tables.
    The host side (``tables``, ``validate``, ``nonzero_rows``,
    ``export_tsv``, ``to_dataset``, ...) is TransitionCounter's.

    method : accepted for bear_tpu's signature and ignored (one kernel).
    """

    def __init__(self, mesh: Mesh, lags: Sequence[int], n_groups: int = 1,
                 reverse: bool = False, axis: str = "data", method: str = "auto",
                 alphabet: str = "dna"):
        check_method(method)
        A = _alpha.alphabet_size(alphabet)
        lags = tuple(sorted(set(int(l) for l in lags)))
        if reverse and A != 4:
            raise ValueError("reverse-complement counting requires a 4-letter alphabet")
        check_context_codes(lags, A)
        _, total = lag_offsets(lags, n_groups, A)
        if padded_size(total) > _INT32_MAX:
            raise ValueError(
                f"concatenated count table has {padded_size(total):,} entries "
                "(window-padded), beyond int32 indexing — split the lags across counters")
        self.mesh = mesh
        self.axis = axis
        self._replica_devices = mesh.along(axis)
        self.n_dev = len(self._replica_devices)
        self.method = method
        super().__init__(lags, n_groups=n_groups, reverse=reverse, alphabet=alphabet,
                         device=self._replica_devices[0])
        self._parts: Optional[list] = None  # one int32 table per replica
        self._staging = [[] for _ in range(self.n_dev)]

    def _add(self, codes, lengths, skip, stopped, groups, fresh=None):
        blocks = split_rows((codes, lengths, skip, stopped, groups, fresh), self.n_dev)
        new_transitions = self.n_dev * blocks[0][0].shape[0] * (blocks[0][0].shape[1] + 1)
        if self._since_flush + new_transitions > self.FLUSH_EVERY:
            self.flush()
        if self._parts is None:
            self._parts = [torch.zeros(self._total_size, dtype=torch.int32,
                                       device=resolve_device(dev))
                           for dev in self._replica_devices]
        for table, staging, rows in zip(self._parts, self._staging, blocks):
            codes_t, meta_t = upload_chunk(staging, table.device, *rows)
            count_chunk_update(table, codes_t, meta_t, self.lags, self.n_groups, self.A)
        self._since_flush += new_transitions

    def flush(self):
        """Sum the replicas into the first (int32, exact below FLUSH_EVERY),
        fold the sum into the host tables and zero every replica."""
        if self._parts is not None and self._since_flush > 0:
            total = self._parts[0]
            for part in self._parts[1:]:
                total += part.to(total.device)
            self._fold(total)
            for part in self._parts:
                part.zero_()
            self._since_flush = 0
            self._host_dirty = True

    def sync(self):
        """Block until every replica's queued counting work has completed."""
        for part in self._parts or []:
            if part.is_cuda:
                torch.cuda.synchronize(part.device)

    def partial_tables(self) -> list:
        """The replicas' int32 device tables since the last flush (None
        before the first chunk), in the axis's order."""
        return self._parts


class KmerShardedTransitionCounter:
    """Transition counting with each lag's table split into row ranges and a
    sparse int64 host accumulator.

    lags, n_groups, alphabet : as for TransitionCounter.
    mesh, axis : the row ranges go over the ``axis`` devices of ``mesh``,
        shard d on the device at position d. Without a mesh the counter
        holds one row range (the whole table) on ``device``.
    n_shards : without a mesh only 1 (the one-device form); with one, 1 or
        the axis's size.
    method : accepted for bear_tpu's signature and ignored (one kernel).
    """

    FLUSH_EVERY = FLUSH_EVERY

    def __init__(self, lags: Sequence[int], n_groups: int = 1, n_shards: int = 1,
                 method: str = "auto", alphabet: str = "dna", device="cuda",
                 mesh: Optional[Mesh] = None, axis: str = "kmer"):
        check_method(method)
        if mesh is None and n_shards > 1:
            raise ValueError(
                f"a count table split over {n_shards} row ranges needs as many devices: "
                f"pass mesh= (a Mesh with a {axis!r} axis of that size), or count in "
                "row-range passes on one device (counting.multipass)")
        if mesh is not None and n_shards not in (1, mesh.shape[axis]):
            raise ValueError(f"n_shards={n_shards}, but mesh axis {axis!r} has "
                             f"{mesh.shape[axis]} devices")
        self.alphabet = alphabet
        self.A = _alpha.alphabet_size(alphabet)
        self.A1 = self.A + 1
        self.lags = tuple(sorted(set(int(l) for l in lags)))
        check_context_codes(self.lags, self.A)
        self.n_groups = n_groups
        self.method = method
        self.mesh = mesh
        self.axis = axis
        if mesh is None:
            self.device = torch.device(device)
            self.n_dev = 1
        else:
            self._slice_devices = mesh.along(axis)
            self.device = self._slice_devices[0]
            self.n_dev = len(self._slice_devices)
        self._init_row_split(self.n_dev, "use more devices on the kmer axis")

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
        self._dev: Optional[list] = None  # one int32 row-range table per slice
        self._since_flush = 0
        self._shard = 0
        self._staging: dict = {}  # device -> its two pinned staging sets

    @property
    def max_lag(self) -> int:
        return max(self.lags)

    @property
    def table_size(self) -> int:
        """Entries of one slice's int32 device table (one row range, all
        lags)."""
        return self._local_size

    # --- device side ------------------------------------------------------

    def _placement(self) -> list:
        """(row range, device) of each table slice the counter holds."""
        if self.mesh is None:
            return [(self._shard, self.device)]
        return list(enumerate(self._slice_devices))

    def add_chunk(self, chunk: ReadChunk):
        """Count a chunk's transitions into every slice: one count_chunk
        launch per slice, each keeping the transitions of its own rows. The
        chunk goes to each distinct device once."""
        check_groups(chunk.groups, self.n_groups)
        codes = np.asarray(chunk.codes)
        new_transitions = codes.shape[0] * (codes.shape[1] + 1)
        if self._since_flush + new_transitions > self.FLUSH_EVERY:
            self.flush()
        placement = self._placement()
        if self._dev is None:
            self._dev = [torch.zeros(self._local_size, dtype=torch.int32,
                                     device=resolve_device(dev)) for _, dev in placement]
        uploads = {}
        for (d, _), table in zip(placement, self._dev):
            if table.device not in uploads:
                uploads[table.device] = upload_chunk(
                    self._staging.setdefault(table.device, []), table.device, codes,
                    chunk.lengths, chunk.skip, chunk.stopped, chunk.groups, chunk.fresh)
            count_chunk_update(table, *uploads[table.device], self.lags, self.n_groups,
                               self.A, shard=(d, self._per_lag))
        self._since_flush += new_transitions

    def flush(self):
        """Drain each slice's nonzero entries, on its own device, into the
        host accumulator (global keys) and drop the slices."""
        if self._dev is None or self._since_flush == 0:
            return
        for (d, _), part in zip(self._placement(), self._dev):
            self._drain_part(part, d)
        self._dev = None
        self._since_flush = 0

    def sync(self):
        """Block until all queued device counting work has completed."""
        for part in self._dev or []:
            if part.is_cuda:
                torch.cuda.synchronize(part.device)

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
