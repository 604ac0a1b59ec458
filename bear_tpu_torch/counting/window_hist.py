"""Dense-table histogram update: the port of the TPU kernel
bear_tpu/counting/pallas_hist.py:81 (``_hist_kernel``, driven by
``sorted_window_update``).

``window_update(table, keys)`` adds one count at ``table[k]`` for every key
``k`` with ``0 <= k < table.numel()``, in place (JAX donated the buffer and
returned a new one; here the caller's tensor is updated and returned). Keys
in any order and with any duplication are accepted; negative keys and keys
at or beyond the table size are dropped.

The table's device decides what runs. On a CUDA tensor the hand-written
kernel ``csrc/window_hist.cu`` is launched (built with nvcc at first use) or
an error is raised; on a CPU tensor the plain PyTorch version
:func:`window_update_plain` runs. ``window_update.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bear_tpu_torch import _build

SOURCE = "window_hist"


def window_update_plain(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, in place).

    index_put_ raises on out-of-range indices where JAX's mode="drop"
    drops them, so out-of-range keys are masked out first."""
    valid = keys[(keys >= 0) & (keys < table.numel())].long()
    table.index_put_((valid,), torch.ones_like(valid, dtype=table.dtype),
                     accumulate=True)
    return table


def _check(table: torch.Tensor, keys: torch.Tensor) -> None:
    if table.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError(
            f"window_update needs int32 table and keys, got {table.dtype} "
            f"and {keys.dtype}"
        )
    if table.dim() != 1 or keys.dim() != 1:
        raise ValueError("window_update needs 1-D table and keys")
    if not (table.is_contiguous() and keys.is_contiguous()):
        raise ValueError("window_update needs contiguous table and keys")
    if table.device != keys.device:
        raise ValueError(
            f"table on {table.device} but keys on {keys.device}"
        )


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.window_hist_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def window_update(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Add one count at each in-range key into ``table`` (updated in place
    and returned). CUDA tensors launch the kernel; CPU tensors run
    :func:`window_update_plain`."""
    _check(table, keys)
    if table.device.type == "cpu":
        return window_update_plain(table, keys)
    if table.device.type != "cuda":
        raise ValueError(f"window_update has no path for device {table.device}")
    if keys.numel() == 0:
        return table
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.window_hist_launch(table.data_ptr(), keys.data_ptr(),
                                    keys.numel(), table.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"window_hist kernel launch failed: CUDA error {rc}")
    window_update.launches += 1
    return table


window_update.launches = 0
