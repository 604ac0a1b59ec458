"""The counting engine's device entry: one chunk of int8 residue codes and
its per-row meta go in, transition counts come out (port of
bear_tpu/counting/engine.py:277 ``_count_chunk_kernel`` with
``method="sorted"``: the chunk's index math together with the TPU kernel
bear_tpu/counting/pallas_hist.py:81 ``_hist_kernel``).

Count-table layout
------------------
The context alphabet is residues + the start pad '['; since '[' occurs only
as a prefix run, a lag-l context is (n_pad, suffix) with suffix in base A of
length l - n_pad. Table row index:

    offset(n_pad) = (A^(l-n_pad) - 1) / (A - 1)
    row = offset(n_pad) + baseA(suffix)
    rows(l) = (A^(l+1) - 1) / (A - 1)

Columns are the transition symbols (residues, then '$'). Tables are
[n_groups, rows(l), A+1], concatenated over the lags into one flat int32
buffer (:func:`lag_offsets`). For lag l each read contributes len+1
transitions of the '['*l padded, '$'-terminated sequence.

Row meta
--------
A chunk's rows travel as one int32 [B, 4] array (:func:`pack_meta`):
length, skip, group and flags (bit 0 ``stopped``, bit 1 ``fresh``).

Row ranges
----------
``shard=(idx, per_lag)`` with ``per_lag = {lag: (stride, local_rows,
local_offset)}`` counts into a table that holds only the context rows
``[idx * stride, idx * stride + local_rows)`` of every group of each lag, at
``local_offset + (group * local_rows + rloc) * (A+1) + next`` with ``rloc =
row - idx * stride``; transitions of other rows are dropped (bear_tpu's
``_count_chunk_kernel(shard=...)``, engine.py:356-363, which multipass.py
and parallel/counting.py drive). The whole table stays below 2^31 entries
while the global one (lags 14-15) need not.

Launch shape
------------
:func:`launch_shape` picks the kernel's work decomposition from the chunk
and the card's SM count: tiles of ``(THREADS / groups) * run`` positions,
``run`` consecutive positions per thread and ``groups`` lag groups (a
thread counts the lags ``g, g + groups, ...`` of its run). Starting from
runs of 8 and one group, it halves the tile, alternately by splitting the
lags and by shortening the run, until the chunk has ``BLOCKS_PER_SM``
tiles per SM: the main path's 16,384 x 150 one-lag chunk keeps (8, 1);
summarize's and the row-range passes' 1,024 x 192 chunk over 13-15 lags
takes (4, 4).

``count_chunk_update(table, codes, meta, lags, n_groups, A, shard=None)``
adds every counted transition of the chunk into ``table`` in place. On a
CUDA tensor the hand-written kernel ``csrc/count_chunk.cu`` is launched
(built with nvcc at first use) or an error is raised; on a CPU tensor the
plain version :func:`count_chunk_plain` runs: :func:`chunk_keys`, then
``window_update_plain``. ``count_chunk_update.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bear_tpu_torch import _build
from bear_tpu_torch.counting.window_hist import window_update_plain
from bear_tpu_torch.utils.device import sm_count

SOURCE = "count_chunk"
# Mirrors of csrc/count_chunk.cu.
THREADS = 256  # threads of a block
RUN = 8  # most consecutive positions a thread takes
MAX_GROUPS = 8  # most lag groups of a tile (a warp each)
TILE = THREADS * RUN  # most positions of a tile
MAX_ROWS = 32  # most rows a tile spans
BLOCKS_PER_SM = 4  # tiles per SM the launch shape aims for, and the grid's cap
MAX_LAGS = 16
MAX_LAG = 15
STOPPED, FRESH = 1, 2  # meta flag bits
_INT32_MAX = int(np.iinfo(np.int32).max)


def table_rows(lag: int, A: int = 4) -> int:
    """Context rows of a lag-`lag` table over an A-residue alphabet:
    sum of A^k for k = 0..lag (every '['-padded suffix length)."""
    return (A ** (lag + 1) - 1) // (A - 1)


def pad_offset(lag: int, n_pad, A: int = 4) -> int:
    """Row offset of the contexts with n_pad leading '['s."""
    return (A ** (lag - n_pad) - 1) // (A - 1)


def lag_offsets(lags, n_groups, A: int = 4):
    """Offsets of each lag's flat table inside the single concatenated
    device buffer, and the total size (one buffer and one kernel launch per
    chunk covers all lags)."""
    offsets = {}
    total = 0
    for l in sorted(lags):
        offsets[l] = total
        total += n_groups * table_rows(l, A) * (A + 1)
    return offsets, total


def shard_size(per_lag, n_groups: int, A: int) -> int:
    """Entries of a row-range table: sum over lags of n_groups * local_rows
    * (A+1)."""
    return sum(n_groups * local_rows * (A + 1) for _, local_rows, _ in per_lag.values())


def chunk_keys(codes, lengths, skip, stopped, groups, lags, n_groups: int,
               A: int, sentinel: int, fresh=None, shard=None) -> torch.Tensor:
    """Flat int32 table indices of every transition of one chunk, for every
    lag: [n_lags * B * (L+1)], lag-major. Masked positions, and with
    ``shard`` the rows outside its range, carry ``sentinel``. All tensors
    lie on one device; ``stopped`` and ``fresh`` are bool. The index math
    of bear_tpu's ``_count_chunk_kernel`` (engine.py:296-367), int32-exact
    under the counters' guards."""
    B, L = codes.shape
    P = L + 1  # transition positions 0..L (the stop can land at j == L)
    dev = codes.device
    j = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    skip = skip.to(torch.int32)[:, None]
    groups32 = groups.to(torch.int32)[:, None]
    A1 = A + 1
    offsets, _ = lag_offsets(lags, n_groups, A)
    max_lag = max(lags)
    # ONE padded buffer [ max_lag zeros | codes | one zero ]; every shifted
    # view below is a slice of it.
    padded = F.pad(codes.to(torch.int32), (max_lag, 1))

    # next symbol at position j: s[j] for j < len, '$' at j == len
    nxt = torch.where(j < lengths, padded[:, max_lag : max_lag + P], A)
    mask = (j >= skip) & ((j < lengths) | ((j == lengths) & stopped[:, None]))
    fresh_col = None if fresh is None else fresh[:, None]
    jj = np.arange(P)
    code_acc = torch.zeros((B, P), dtype=torch.int32, device=dev)
    pow_a = 1
    keys = []
    for l in range(1, max_lag + 1):
        # Rolling base-A suffix code: digits before the read start read the
        # zero padding, which is exactly the truncated-prefix code.
        code_acc += padded[:, max_lag - l : max_lag - l + P] * pow_a
        pow_a *= A
        if l not in lags:
            continue
        # Non-fresh rows drop positions whose lag-l window would cross the
        # ambiguous base: j < l.
        mask_l = mask if fresh_col is None else mask & (fresh_col | (j >= l))
        row_off = torch.as_tensor(pad_offset(l, np.maximum(0, l - jj), A),
                                  dtype=torch.int32, device=dev)[None, :]
        if shard is None:
            flat = offsets[l] + (groups32 * table_rows(l, A) + row_off + code_acc) * A1 + nxt
        else:
            idx, per_lag = shard
            stride, local_rows, local_offset = per_lag[l]
            rloc = row_off + code_acc - idx * stride
            mask_l = mask_l & (rloc >= 0) & (rloc < local_rows)
            flat = local_offset + (groups32 * local_rows + rloc.clamp(0, local_rows - 1)) * A1 + nxt
        keys.append(torch.where(mask_l, flat, sentinel).reshape(-1))
    return torch.cat(keys)


def pack_meta(lengths, skip, stopped, groups, fresh=None, out=None) -> np.ndarray:
    """Host int32 [B, 4] meta of a chunk's rows: length, skip, group, flags
    (``stopped`` -> bit 0, ``fresh`` -> bit 1; ``fresh=None`` means every
    row is fresh). Written into ``out`` when given (a pinned staging
    buffer), else into a new array."""
    lengths = np.asarray(lengths)
    if out is None:
        out = np.empty((lengths.shape[0], 4), np.int32)
    out[:, 0] = lengths
    out[:, 1] = skip
    out[:, 2] = groups
    flags = np.where(np.asarray(stopped, dtype=bool), STOPPED, 0)
    if fresh is None:
        flags |= FRESH
    else:
        flags |= np.where(np.asarray(fresh, dtype=bool), FRESH, 0)
    out[:, 3] = flags
    return out


def unpack_meta(meta: torch.Tensor):
    """(lengths, skip, stopped, groups, fresh) of a meta tensor, on its
    device: int32 columns and bool flags."""
    flags = meta[:, 3]
    return (meta[:, 0], meta[:, 1], (flags & STOPPED) != 0, meta[:, 2],
            (flags & FRESH) != 0)


def tile_positions(row_len: int, run: int = RUN, groups: int = 1) -> int:
    """Positions per kernel tile for rows of ``row_len`` codes: the
    ``THREADS // groups`` runs of ``run`` positions, and few enough that a
    tile spans at most MAX_ROWS rows."""
    return min(THREADS // groups * run, (MAX_ROWS - 1) * (row_len + 1))


class LaunchShape(NamedTuple):
    """How one launch divides its chunk: positions per tile, positions per
    thread, lag groups, and the persistent grid's blocks."""

    tile: int
    run: int
    groups: int
    blocks: int


@functools.lru_cache(maxsize=256)
def launch_shape(n_rows: int, row_len: int, n_lags: int, sms: int) -> LaunchShape:
    """The launch shape of an [n_rows, row_len] chunk over ``n_lags`` lags on
    a card of ``sms`` SMs. From runs of RUN positions and one lag group, the
    tile halves, alternately by doubling the lag groups (at most MAX_GROUPS
    and ``n_lags``) and by halving the run, until the chunk has
    ``BLOCKS_PER_SM * sms`` tiles or neither can change. The grid is that
    many blocks, or one per tile when there are fewer."""
    n_pos = n_rows * (row_len + 1)
    target = BLOCKS_PER_SM * sms
    max_groups = min(MAX_GROUPS, 1 << (max(n_lags, 1).bit_length() - 1))
    run, groups, split = RUN, 1, True

    def n_tiles():
        return -(-n_pos // tile_positions(row_len, run, groups))

    while n_tiles() < target:
        if groups < max_groups and (split or run == 1):
            groups *= 2
        elif run > 1:
            run //= 2
        else:
            break
        split = not split
    return LaunchShape(tile_positions(row_len, run, groups), run, groups,
                       max(1, min(n_tiles(), target)))


class _Lag(ctypes.Structure):
    _fields_ = [("lag", ctypes.c_int32), ("offset", ctypes.c_int32),
                ("rows", ctypes.c_int32), ("modulus", ctypes.c_uint32),
                ("stride", ctypes.c_int32), ("local_rows", ctypes.c_int32),
                ("pad", ctypes.c_int32 * (MAX_LAG + 1))]


class LagTable(ctypes.Structure):
    """The kernel's by-value lag table (``CountLags`` in the source)."""

    _fields_ = [("n_lags", ctypes.c_int32), ("max_lag", ctypes.c_int32),
                ("A", ctypes.c_int32), ("top_power", ctypes.c_uint32),
                ("a_shift", ctypes.c_int32), ("lag", _Lag * MAX_LAGS)]


@functools.lru_cache(maxsize=64)
def lag_table(lags: tuple, n_groups: int, A: int, per_lag: tuple | None = None) -> LagTable:
    """The lag table of ``lags`` (ascending) for the kernel: the dense
    layout, or with ``per_lag`` (sorted ``(lag, (stride, local_rows,
    local_offset))`` items) a row range's. Shared between callers: never
    mutated."""
    offsets, _ = lag_offsets(lags, n_groups, A)
    t = LagTable(n_lags=len(lags), max_lag=max(lags), A=A,
                 top_power=A ** (max(lags) - 1),
                 a_shift=A.bit_length() - 1 if A & (A - 1) == 0 else 0)
    ranges = dict(per_lag) if per_lag is not None else {
        l: (table_rows(l, A), table_rows(l, A), offsets[l]) for l in lags}
    for k, l in enumerate(lags):
        lag = t.lag[k]
        lag.lag, lag.rows, lag.modulus = l, table_rows(l, A), A**l
        lag.stride, lag.local_rows, lag.offset = ranges[l]
        for n_pad in range(l + 1):
            lag.pad[n_pad] = pad_offset(l, n_pad, A)
    return t


def _check(table, codes, meta, lags, n_groups, A, shard=None) -> tuple:
    """Raise on what the kernel does not take; return the lags, ascending."""
    if table.dtype != torch.int32 or codes.dtype != torch.int8 or meta.dtype != torch.int32:
        raise TypeError(
            f"count_chunk needs an int32 table, int8 codes and int32 meta, got "
            f"{table.dtype}, {codes.dtype} and {meta.dtype}"
        )
    if table.dim() != 1 or codes.dim() != 2 or meta.shape != (codes.shape[0], 4):
        raise ValueError(
            f"count_chunk needs a 1-D table, [B, L] codes and [B, 4] meta, got "
            f"{tuple(table.shape)}, {tuple(codes.shape)} and {tuple(meta.shape)}"
        )
    if not (table.is_contiguous() and codes.is_contiguous() and meta.is_contiguous()):
        raise ValueError("count_chunk needs contiguous table, codes and meta")
    if not table.device == codes.device == meta.device:
        raise ValueError(
            f"table on {table.device}, codes on {codes.device}, meta on {meta.device}"
        )
    lags = tuple(sorted(set(int(l) for l in lags)))
    if not lags or not 1 <= lags[0] <= lags[-1] <= MAX_LAG:
        # At most MAX_LAG distinct lags, so the MAX_LAGS slots always suffice.
        raise ValueError(f"count_chunk takes lags in 1..{MAX_LAG}, got {lags}")
    if A < 2 or table_rows(lags[-1], A) > _INT32_MAX:
        # The kernel's context codes (A^lag) and rows lie below 2^31.
        raise ValueError(f"lag {lags[-1]} context codes exceed int32 for A = {A}")
    if shard is None:
        _, total = lag_offsets(lags, n_groups, A)
    else:
        idx, per_lag = shard
        if sorted(per_lag) != list(lags):
            raise ValueError(f"the row ranges cover lags {sorted(per_lag)}, not {lags}")
        total = shard_size(per_lag, n_groups, A)
        for l, (stride, local_rows, local_offset) in per_lag.items():
            if not (1 <= stride and 1 <= local_rows
                    and 0 <= local_offset <= total - n_groups * local_rows * (A + 1)
                    and 0 <= idx * stride <= _INT32_MAX):
                raise ValueError(f"row range {idx} of lag {l}: stride {stride}, "
                                 f"{local_rows} rows at {local_offset} do not fit")
    if table.numel() != total or total > _INT32_MAX:
        raise ValueError(
            f"table has {table.numel():,} entries; lags {lags} x {n_groups} groups "
            f"need {total:,} (at most {_INT32_MAX:,})"
        )
    return lags


def count_chunk_plain(table: torch.Tensor, codes: torch.Tensor, meta: torch.Tensor,
                      lags, n_groups: int, A: int, shard=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, in place):
    :func:`chunk_keys` of the unpacked meta, then ``window_update_plain``."""
    lengths, skip, stopped, groups, fresh = unpack_meta(meta)
    keys = chunk_keys(codes, lengths, skip, stopped, groups, tuple(sorted(set(lags))),
                      n_groups, A, sentinel=table.numel(), fresh=fresh, shard=shard)
    return window_update_plain(table, keys)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.count_chunk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(LagTable),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(table: torch.Tensor, codes: torch.Tensor, meta: torch.Tensor, lt: LagTable,
           shard_idx: int, shape: LaunchShape) -> torch.Tensor:
    """One kernel launch on the tensors' card with lag table ``lt`` and
    launch shape ``shape``, on the current stream; raises if the launcher
    refuses or the launch fails. :func:`count_chunk_update` checks the
    arguments and picks both; a caller may pass others (count_chunk_timing.py's
    ablation of the shape and of the key math, the card tests)."""
    B, L = codes.shape
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _library().count_chunk_launch(
            table.data_ptr(), table.numel(), codes.data_ptr(), meta.data_ptr(), B, L,
            shape.tile, shape.run, shape.groups, shape.blocks, shard_idx,
            ctypes.byref(lt), stream)
    if rc != 0:
        raise RuntimeError(f"count_chunk kernel launch failed: CUDA error {rc}")
    count_chunk_update.launches += 1
    return table


def count_chunk_update(table: torch.Tensor, codes: torch.Tensor, meta: torch.Tensor,
                       lags, n_groups: int, A: int, shard=None) -> torch.Tensor:
    """Add every counted transition of one chunk into ``table`` (updated in
    place and returned). ``codes`` int8 [B, L] must hold residues in [0, A)
    at every position < length; group ids must lie in [0, n_groups)
    (the counters check both on the host). ``shard=(idx, per_lag)`` counts
    one row range (module docstring). CUDA tensors launch the kernel; CPU
    tensors run :func:`count_chunk_plain`."""
    lags = _check(table, codes, meta, lags, n_groups, A, shard)
    if table.device.type == "cpu":
        return count_chunk_plain(table, codes, meta, lags, n_groups, A, shard)
    if table.device.type != "cuda":
        raise ValueError(f"count_chunk has no path for device {table.device}")
    for name, t in (("codes", codes), ("meta", meta)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"count_chunk needs 16-byte aligned {name} on the card")
    B, L = codes.shape
    if B == 0:
        return table
    idx, per_lag = (0, None) if shard is None else (int(shard[0]), tuple(sorted(shard[1].items())))
    lt = lag_table(lags, n_groups, A, per_lag)
    shape = launch_shape(B, L, len(lags), sm_count(table.device.index))
    return launch(table, codes, meta, lt, idx, shape)


count_chunk_update.launches = 0
