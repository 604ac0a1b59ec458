"""Counting and training across processes (port of
bear_tpu/parallel/multihost.py), on ``torch.distributed``'s gloo backend.

- call :func:`initialize` before any other collective: it joins this
  process to the group (a TCP rendezvous at the coordinator's address);
- shard the input FILES (or reads) across processes with
  :func:`host_shard`: each process counts its share on its own devices;
- merge the counters' host tables with :func:`allreduce_tables` (exact in
  int64, idempotent, safe to call after every flush);
- training, evaluation and serving over a mesh that spans the processes
  sum their gradients, metrics and gathers with :func:`allreduce_sum_`
  (see ``parallel.mesh.DataSplit``).

The tables merged are host int64 arrays in both packages, so the
collectives run on the CPU and need no NCCL. Gloo carries int64 exactly,
so bear_tpu's transport as two uint32 halves (its device transports are
32-bit) is not needed: the sums are the same integers.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Elements per collective call: bounds gloo's working buffers and keeps every
# message far below 2^31 bytes, however large the table.
PIECE = 1 << 26


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, auto_detect: bool = False,
               timeout_s: Optional[float] = None):
    """Join this process to the gloo group. A no-op when the group is
    already up, or when no coordinator is given and ``auto_detect`` is
    false (a single-process run).

    coordinator_address : ``host:port`` of rank 0's rendezvous (TCP).
    auto_detect : without a coordinator, read the group from the
        environment (``env://``: torchrun's MASTER_ADDR, MASTER_PORT, RANK
        and WORLD_SIZE).
    timeout_s : how long the rendezvous and every collective may wait for
        a peer before failing (default: torch's).
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and not auto_detect:
        return
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init, **kw)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_process_count = process_count  # host_shard's parameter shadows the name


def host_shard(items: Sequence, process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """Deterministic round-robin shard of a work list (input files, read
    batches) for this process."""
    pid = process_index() if process_id is None else process_id
    n = _process_count() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % n == pid]


def _allreduce_(arr: np.ndarray) -> np.ndarray:
    """Sum a contiguous int64 array across all processes, in place, in
    pieces of PIECE elements."""
    flat = torch.from_numpy(arr.reshape(-1))  # shares arr's memory
    for s in range(0, flat.numel(), PIECE):
        dist.all_reduce(flat[s : s + PIECE])
    return arr


def allgather_i64(arr) -> np.ndarray:
    """[process_count, len] of an equal-length int64 array from every
    process."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allreduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum a tensor across all processes, in place, in ONE gloo collective
    (a no-op in a single process). A tensor on a card goes through a host
    copy: gloo sums host memory, so the collective and its order are the
    same whatever the device. Every rank receives the same bits."""
    if process_count() == 1:
        return t
    host = t.detach().to("cpu", copy=True) if t.device.type != "cpu" else t
    dist.all_reduce(host)
    if host is not t:
        t.copy_(host)
    return t


def allreduce_sum_i64(arr) -> np.ndarray:
    """Exact int64 sum of an array across all processes (every process
    gets the total): a check of count conservation beside
    :func:`allreduce_tables`."""
    arr = np.array(arr, dtype=np.int64)  # a copy: the caller's array stays
    if process_count() == 1:
        return arr
    return _allreduce_(arr)


def allreduce_tables(counter) -> None:
    """Merge a counter's host counts across all processes, in place.

    IDEMPOTENT and safe while streaming: only the counts added since the
    previous merge (this process's delta against its baseline) cross the
    wire, so calling it after every flush, or again at the end, never
    counts a merged total twice. Afterwards every process holds the global
    counts, exact in int64.

    TransitionCounter and ShardedTransitionCounter: per lag, the dense
    delta summed across processes (the table, its baseline and the delta
    are host arrays of the table's size). The row-split, multi-pass and
    sparse counters: per lag, the (key, count) deltas, padded to the
    longest and all-gathered.
    """
    if process_count() == 1:
        return
    counter.flush()
    baselines = getattr(counter, "_allreduce_baseline", None)
    if baselines is None:
        baselines = counter._allreduce_baseline = {}
    if hasattr(counter, "_sparse"):
        for l in counter.lags:
            keys, vals = counter._consolidated(l)
            b_keys, b_vals = baselines.get(l, (np.zeros(0, np.int64), np.zeros(0, np.int64)))
            # The local delta: counts only grow, so the baseline's keys are
            # a subset of the current keys.
            d_vals = vals.copy()
            if len(b_keys):
                d_vals[np.searchsorted(keys, b_keys)] -= b_vals
            nz = d_vals > 0
            d_keys, d_vals = keys[nz], d_vals[nz]
            n_all = allgather_i64(np.array([len(d_keys)], np.int64)).reshape(-1)
            n_max = int(n_all.max())
            keys_all = allgather_i64(np.pad(d_keys, (0, n_max - len(d_keys))))
            vals_all = allgather_i64(np.pad(d_vals, (0, n_max - len(d_vals))))
            parts = [(b_keys, b_vals)] if len(b_keys) else []
            parts += [(keys_all[p, : n_all[p]], vals_all[p, : n_all[p]])
                      for p in range(len(n_all)) if n_all[p]]
            counter._sparse[l] = parts
            counter._consolidated_lags.discard(l)
            baselines[l] = counter._consolidated(l)
        return
    for l in counter.lags:
        base = baselines.get(l)
        delta = counter._host[l].copy() if base is None else counter._host[l] - base
        _allreduce_(delta)
        if base is not None:
            delta += base
        counter._host[l] = delta
        baselines[l] = delta.copy()
    counter._host_dirty = True
