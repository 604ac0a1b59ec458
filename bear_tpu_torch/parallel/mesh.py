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
"""

from __future__ import annotations

import numpy as np
import torch

from bear_tpu_torch.utils.device import resolve_device


class Mesh:
    """devices : nested list or numpy array of devices (``torch.device`` or
    strings), one array dimension per axis. axis_names : the axes' names.

    ``shape`` is the ordered ``{axis: size}`` dict, as in JAX."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        self.devices = np.frompyfunc(torch.device, 1, 1)(arr).astype(object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs as many axis "
                             f"names, got {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")

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

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def local_device_count() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count()


def _first_devices(n: int | None, device, what: str) -> list:
    """The first ``n`` cards for ``device="cuda"`` (raising as bear_tpu's
    mesh functions do when there are fewer), or ``n`` entries of the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n is None else n)
    have = [torch.device(dev.type, i) for i in range(local_device_count())]
    if n is not None and n > len(have):
        raise ValueError(what.format(n=n, have=len(have)))
    return have if n is None else have[:n]


def data_parallel_mesh(n_devices: int | None = None, axis_name: str = "data",
                       device="cuda") -> Mesh:
    """1-D mesh over the first n (default all) cards; on ``device="cpu"``
    n entries of the CPU."""
    devices = _first_devices(
        n_devices, device,
        "requested {n} devices, have {have} — a silently smaller mesh would surface "
        "later as an opaque batch-divisibility error")
    return Mesh(devices, (axis_name,))


def grid_mesh(shape: dict, device="cuda") -> Mesh:
    """N-D mesh from {axis_name: size}, e.g. {'data': 2, 'kmer': 4}."""
    sizes = list(shape.values())
    n = int(np.prod(sizes))
    devices = _first_devices(n, device, f"mesh {shape} needs {{n}} devices, have {{have}}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), tuple(shape.keys()))


def shard_along(mesh: Mesh, x, axis: int = 0, mesh_axis: str = "data") -> np.ndarray:
    """The per-device pieces of ``x`` split evenly along dim ``axis`` over
    ``mesh_axis``: an object array shaped like ``mesh.devices`` whose entry
    holds its position's piece on its device (replicated over the other
    axes)."""
    x = torch.as_tensor(x)
    n = mesh.shape[mesh_axis]
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not split evenly over "
                         f"the {n} devices of mesh axis {mesh_axis!r}")
    pieces = torch.chunk(x, n, dim=axis)
    k = mesh.axis_names.index(mesh_axis)
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, dev in np.ndenumerate(mesh.devices):
        out[idx] = pieces[idx[k]].to(dev, copy=True)
    return out


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
    """Place a host array, split along dim ``axis`` over ``mesh_axis``, on a
    mesh of this process's devices (:func:`shard_along`). bear_tpu's
    counterpart also places onto meshes that span processes; the port's
    training over such a mesh is the next slice of ROADMAP.md item 13
    (half 2)."""
    return shard_along(mesh, x, axis=axis, mesh_axis=mesh_axis)
