"""Device meshes and placement helpers (port of bear_tpu/parallel/mesh.py).

A :class:`Mesh` is an n-D numpy array of ``torch.device`` with one name per
axis, as ``jax.sharding.Mesh`` is: the counters split chunk rows over a
``data`` axis (each device counts into its own replica of the table) or a
count table's rows over a ``kmer`` axis (each device owns a row range).
There is no XLA to place arrays for the port, so the counters hold one
tensor per device themselves; :func:`shard_along` and :func:`replicate`
give those per-device pieces for other callers.

A mesh may name one device more than once. That stands in for the many
virtual host devices bear_tpu's tests run on (torch has one CPU device) and
lets one card play several, each entry with its own tensors.

A mesh may span processes: after ``multihost.initialize``,
:func:`data_parallel_mesh` and :func:`grid_mesh` list every process's
devices in rank order, as JAX's global ``jax.devices()`` does, and the mesh
records which process owns each entry (``Mesh.processes``). A process
holds tensors only for its own entries (:func:`put_global`); the sums over
the other processes' entries go over the gloo group.
"""

from __future__ import annotations

import numpy as np
import torch

from bear_tpu_torch.parallel import multihost
from bear_tpu_torch.utils.device import resolve_device


class Mesh:
    """devices : nested list or numpy array of devices (``torch.device`` or
    strings), one array dimension per axis. axis_names : the axes' names.
    processes : the rank that owns each entry, shaped like ``devices``;
    by default this process owns every entry.

    ``shape`` is the ordered ``{axis: size}`` dict, as in JAX."""

    def __init__(self, devices, axis_names, processes=None):
        arr = np.array(devices, dtype=object)
        self.devices = np.frompyfunc(torch.device, 1, 1)(arr).astype(object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs as many axis "
                             f"names, got {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        if processes is None:
            processes = np.full(self.devices.shape, multihost.process_index())
        self.processes = np.asarray(processes, dtype=np.int64)
        if self.processes.shape != self.devices.shape:
            raise ValueError(f"processes {self.processes.shape} must be shaped like the "
                             f"devices {self.devices.shape}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def along(self, axis: str) -> list:
        """The device at each position of ``axis``, index 0 on every other
        axis: where the counters keep their one copy of each slice (other
        axes would only replicate it)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def owners(self, axis: str) -> list:
        """The rank that owns each position of :meth:`along`."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(int(self.processes[tuple(index)]))
        return out

    @property
    def spans_processes(self) -> bool:
        """Whether another process owns an entry."""
        return bool((self.processes != multihost.process_index()).any())

    def local_entries(self) -> list:
        """(flat index, device) of this process's entries, in mesh order."""
        me = multihost.process_index()
        return [(i, d) for i, (d, p) in enumerate(zip(self.devices.flat, self.processes.flat))
                if p == me]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def local_device_count() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count()


def _first_devices(n: int | None, device, what: str) -> tuple[list, list]:
    """(devices, owning ranks) of the first ``n`` (default all) entries of
    the global device list: every process's cards in rank order for
    ``device="cuda"`` (raising as bear_tpu's mesh functions do when there
    are fewer), or entries of the CPU, ``n`` in all split evenly over the
    processes (default one each)."""
    dev = resolve_device(device)
    nproc = multihost.process_count()
    if dev.type == "cpu":
        total = nproc if n is None else n
        if total % nproc:
            raise ValueError(f"{total} CPU entries do not split evenly over {nproc} processes")
        return [dev] * total, [r for r in range(nproc) for _ in range(total // nproc)]
    counts = [local_device_count()] if nproc == 1 else multihost.allgather_i64(
        [local_device_count()]).reshape(-1).tolist()
    have = [(torch.device(dev.type, i), r) for r in range(nproc) for i in range(counts[r])]
    if n is not None and n > len(have):
        raise ValueError(what.format(n=n, have=len(have)))
    have = have if n is None else have[:n]
    return [d for d, _ in have], [r for _, r in have]


def data_parallel_mesh(n_devices: int | None = None, axis_name: str = "data",
                       device="cuda") -> Mesh:
    """1-D mesh over the first n (default all) cards of every process; on
    ``device="cpu"`` n entries of the CPU (default one per process)."""
    devices, procs = _first_devices(
        n_devices, device,
        "requested {n} devices, have {have} — a silently smaller mesh would surface "
        "later as an opaque batch-divisibility error")
    return Mesh(devices, (axis_name,), processes=procs)


def grid_mesh(shape: dict, device="cuda") -> Mesh:
    """N-D mesh from {axis_name: size}, e.g. {'data': 2, 'kmer': 4}."""
    sizes = list(shape.values())
    n = int(np.prod(sizes))
    devices, procs = _first_devices(n, device,
                                    f"mesh {shape} needs {{n}} devices, have {{have}}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), tuple(shape.keys()),
                processes=np.asarray(procs).reshape(sizes))


def shard_along(mesh: Mesh, x, axis: int = 0, mesh_axis: str = "data") -> np.ndarray:
    """The per-device pieces of ``x`` split evenly along dim ``axis`` over
    ``mesh_axis``: an object array shaped like ``mesh.devices`` whose entry
    holds its position's piece on its device (replicated over the other
    axes; None at another process's entry, see :func:`put_global`)."""
    return put_global(x, mesh, axis=axis, mesh_axis=mesh_axis)


def replicate(mesh: Mesh, tree) -> np.ndarray:
    """Per-device copies of a tree (dicts, lists and tuples of tensors or
    arrays): an object array shaped like ``mesh.devices``."""
    def put(t, dev):
        if isinstance(t, dict):
            return {k: put(v, dev) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v, dev) for v in t)
        return torch.as_tensor(t).to(dev, copy=True)

    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, dev in np.ndenumerate(mesh.devices):
        out[idx] = put(tree, dev)
    return out


def put_global(x, mesh: Mesh, axis: int = 0, mesh_axis: str = "data") -> np.ndarray:
    """This process's pieces of ``x`` split along dim ``axis`` over
    ``mesh_axis`` (:func:`shard_along`), on a mesh that may span processes:
    every process passes the same whole array and keeps only the pieces of
    its own entries; the other entries hold None."""
    x = torch.as_tensor(x)
    n = mesh.shape[mesh_axis]
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not split evenly over "
                         f"the {n} devices of mesh axis {mesh_axis!r}")
    pieces = torch.chunk(x, n, dim=axis)
    k = mesh.axis_names.index(mesh_axis)
    me = multihost.process_index()
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, dev in np.ndenumerate(mesh.devices):
        if mesh.processes[idx] == me:
            out[idx] = pieces[idx[k]].to(dev, copy=True)
    return out


def check_device(dev) -> torch.device:
    """``dev`` as a usable device, a card with its index: a card that is
    not there raises (no fall-back to the CPU)."""
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} was asked for, but this process sees "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


class DataSplit:
    """How a data-parallel computation spreads batch rows over a mesh (or,
    without one, keeps them on ``device``): rows pad to a multiple of the
    mesh's size, entry ``i`` of the flat mesh takes the i-th contiguous
    slice, this process computes its own entries' slices, and the sums
    over entries are taken in mesh order on ``master``, this process's
    first entry, then over the gloo group when the mesh spans processes.

    With a mesh, the mesh's devices decide: a ``device`` that names
    another device raises."""

    def __init__(self, mesh: Mesh | None, device="cuda"):
        if mesh is None:
            self.entries, self.n, self.spans = [(0, check_device(device))], 1, False
        else:
            self.entries = [(i, check_device(d)) for i, d in mesh.local_entries()]
            if not self.entries:
                raise ValueError("this process owns no entry of the mesh")
            want, first = torch.device(device), self.entries[0][1]
            if want.type != first.type or want.index not in (None, first.index):
                raise ValueError(f"device={str(device)!r} is not the mesh's device "
                                 f"{first}; pass the mesh's device or leave device= out")
            self.n, self.spans = mesh.size, mesh.spans_processes
        self.master = self.entries[0][1]

    def pad(self, rows: int) -> int:
        """``rows`` rounded up to a multiple of the mesh's size."""
        return -(-int(rows) // self.n) * self.n

    def split(self, x, dim: int = 0) -> list:
        """This process's entries' slices of ``x`` along ``dim`` (whose
        size is a multiple of the mesh's), each on its entry's device: a
        view where the entry is ``x``'s own device. None stays None."""
        if x is None:
            return [None] * len(self.entries)
        per = x.shape[dim] // self.n
        return [x.narrow(dim, i * per, per).to(d) for i, d in self.entries]

    def sum(self, parts: list):
        """The sum of per-entry tensors on ``master``, in mesh order."""
        total = parts[0].to(self.master)
        for p in parts[1:]:
            total = total + p.to(self.master)
        return total

    def allreduce(self, tensors: list) -> list:
        """Sums of ``tensors`` over the processes of a spanning mesh, in one
        collective (the tensors flattened into one buffer); unchanged
        otherwise."""
        if not self.spans:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        multihost.allreduce_sum_(flat)
        return [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in tensors]),
                                              tensors)]
