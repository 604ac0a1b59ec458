"""The CNN AR function's forward under inference as one hand-written kernel,
``csrc/cnn_forward.cu`` (its note says what it computes, what bounds it on
the card and what the design does about it).

:func:`cnn_probs` maps k-mers x [N, lag, A1] (one-hot, or any float) and
the CNN's parameters in checkpoint order (``models.ar_funcs.CNNAR``) to
probabilities [N, A1], on the tensors' card, in their float type (float32
or float64). Its plain PyTorch version is ``CNNAR._forward_plain``
(``bear_tpu_torch/models/ar_funcs.py``), the ATen path that the CPU,
autograd and a ``compute_dtype`` run; ``CNNAR.forward`` picks between the
two by what the call shows (its docstring), with no switch. A CUDA call
launches the kernel or raises. The module's ``launches`` counts kernel
launches, ``narrow_launches`` those of the narrow instance (callers reset
both).

The kernel takes any widths: it runs the filters in blocks of ``NF_BLOCK``
and the hidden units in blocks of ``W1_BLOCK``, padded in shared memory. A
CNN whose filters fit one block of ``NARROW_NF_BLOCK`` and whose hidden
units fit one of ``NARROW_W1_BLOCK`` takes the narrow instance instead: the
same function over those blocks, in the same tiles, chosen by the
launcher from the widths alone (:func:`is_narrow` mirrors its rule).
Shared memory alone bounds a CNN (:func:`smem_bytes`); one whose smallest
tile does not fit a block's shared memory is refused (:func:`widths`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from bear_tpu_torch import _build
from bear_tpu_torch.utils.device import sm_count

SOURCE = "cnn_forward"
NF_BLOCK = 96  # mirrors of csrc/cnn_forward.cu
W1_BLOCK = 64
NARROW_NF_BLOCK = 32
NARROW_W1_BLOCK = 16
SMEM_MAX = 232_448
BLOCKS_PER_SM = 2  # large float tiles an SM holds
PARAM_NAMES = ("filters", "intercept0", "weights1", "intercept1", "weights2", "intercept2",
               "scale0", "scale1")
launches = 0
narrow_launches = 0


class LaunchShape(NamedTuple):
    """A launch's blocks: ``rows`` rows a block, ``threads`` threads."""

    rows: int
    threads: int


# The tiles the launcher has, by itemsize, largest first: in float 64 rows of
# 256 threads, and 16 of 128 where those would leave the card under-filled or
# not fit; in double 16 of 128 alone (no cell runs float64). Both instances
# have them.
TILES = {4: (LaunchShape(64, 256), LaunchShape(16, 128)), 8: (LaunchShape(16, 128),)}


def is_narrow(nf: int, w1: int) -> bool:
    """Whether a CNN of nf filters and w1 hidden units takes the narrow
    instance: one block of NARROW_NF_BLOCK filters and one of
    NARROW_W1_BLOCK hidden units holds them. A mirror of the launcher's
    rule (csrc/cnn_forward.cu cnn_forward_launch), which reports the
    instance it ran to :func:`launch`."""
    return nf <= NARROW_NF_BLOCK and w1 <= NARROW_W1_BLOCK


def launch_shape(n: int, itemsize: int, sms: int, lag: int, A1: int, fw: int, nf: int,
                 w1: int) -> LaunchShape:
    """The blocks for n rows of a CNN of (lag, A1, fw, nf, w1) on a card of
    ``sms`` SMs: the first of the type's TILES that leaves at least
    BLOCKS_PER_SM tiles an SM and fits shared memory (:func:`smem_bytes`,
    of the instance that serves nf and w1), else the smallest, so that
    small calls (assembly's 1,024-row steps: 64 blocks) still spread over
    the SMs. The kernel's blocks are persistent: it launches as many as the
    SMs hold and each takes tiles in turn."""
    *large, small = TILES[itemsize]
    for shape in large:
        if (-(-n // shape.rows) >= BLOCKS_PER_SM * sms
                and smem_bytes(shape.rows, itemsize, lag, A1, fw, nf, w1) <= SMEM_MAX):
            return shape
    return small


def smem_bytes(rows: int, itemsize: int, lag: int, A1: int, fw: int, nf: int, w1: int) -> int:
    """Shared memory of a block of ``rows`` rows (csrc/cnn_forward.cu
    layout) of the instance that serves nf and w1: the next tile's inputs as
    they are in x (rounded up to 16 bytes), this tile's transposed and one
    position's activations of every filter block (rows minor, stride rows +
    16 bytes), the sums of every hidden unit (with more than one block of
    either), the filters, a block of weights1, the per-position scales and
    intercepts, the hidden layer's and the head."""
    nfb, w1b = ((NARROW_NF_BLOCK, NARROW_W1_BLOCK) if is_narrow(nf, w1)
                else (NF_BLOCK, W1_BLOCK))
    per16 = 16 // itemsize
    stride = rows + per16
    conv_len = lag - fw + 1
    nfp = -(-nf // nfb) * nfb
    w1p = -(-w1 // w1b) * w1b
    hacc = rows * (w1p + per16) if nfp > nfb or w1p > w1b else 0
    elems = (-(-rows * lag * A1 // per16) * per16 + (lag * A1 + nfp) * stride + hacc
             + fw * A1 * nfp + nfb * w1b + 2 * conv_len * nfp + 2 * w1p
             + w1 * A1 + A1)
    return elems * itemsize


def widths(x: torch.Tensor, params: Sequence[torch.Tensor]):
    """(lag, A1, fw, nf, w1) of x [N, lag, A1] and the parameters; raises
    where they disagree with each other or with the kernel."""
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"the CNN takes {len(PARAM_NAMES)} parameter arrays, got {len(params)}")
    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 3:
        raise TypeError(f"cnn_forward needs float32 or float64 k-mers [N, lag, A1], got "
                        f"{x.dtype} {tuple(x.shape)}")
    _, lag, A1 = x.shape
    filters, weights1 = params[0], params[2]
    if filters.dim() != 3 or weights1.dim() != 3:
        raise ValueError(f"filters [fw, A1, nf] and weights1 [conv_len, nf, w1], got "
                         f"{tuple(filters.shape)} and {tuple(weights1.shape)}")
    fw, nf, w1 = filters.shape[0], filters.shape[2], weights1.shape[2]
    cl = lag - fw + 1
    want = [(fw, A1, nf), (cl, nf), (cl, nf, w1), (w1,), (w1, A1), (A1,), (cl, nf), (w1,)]
    for name, p, shape in zip(PARAM_NAMES, params, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} is {tuple(p.shape)}, the CNN of k-mers "
                             f"{tuple(x.shape[1:])} needs {shape}")
    for name, p in zip(PARAM_NAMES, params):
        if p.dtype != x.dtype or p.device != x.device:
            raise TypeError(f"cnn_forward needs its tensors in one type on one device: "
                            f"{name} is {p.dtype} on {p.device}, x {x.dtype} on {x.device}")
    if not 1 <= fw <= lag:
        raise ValueError(f"cnn_forward takes filter widths up to the lag, got fw {fw} at lag "
                         f"{lag}")
    need = smem_bytes(TILES[x.element_size()][-1].rows, x.element_size(), lag, A1, fw, nf, w1)
    if need > SMEM_MAX:
        raise ValueError(f"the CNN of k-mers {tuple(x.shape[1:])}, filter width {fw}, {nf} "
                         f"filters and {w1} hidden units needs {need} bytes of shared memory "
                         f"a block, over {SMEM_MAX}")
    return lag, A1, fw, nf, w1


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its functions' argument types set."""
    lib = _build.load(SOURCE)
    fn = lib.cnn_forward_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] + [ctypes.c_int32] * 8
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)])
    fn.restype = ctypes.c_int
    return lib


def launch(x, params, out, shape: LaunchShape) -> torch.Tensor:
    """One kernel launch into ``out`` [N, A1] on the tensors' card in launch
    shape ``shape``, on the current stream; raises where :func:`widths`
    refuses the arguments, the launcher refuses the shape, or the launch
    fails. :func:`cnn_probs` picks the shape; a caller may pass another of
    TILES'. ``narrow_launches`` counts the launches in which the launcher
    reports the narrow instance."""
    global launches, narrow_launches
    lag, A1, fw, nf, w1 = widths(x, params)
    narrow = ctypes.c_int32(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().cnn_forward_launch(
            x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), x.shape[0], lag, A1,
            fw, nf, w1, x.element_size(), shape.rows, shape.threads, stream,
            ctypes.byref(narrow))
    if rc != 0:
        raise RuntimeError(f"cnn_forward kernel launch failed: CUDA error {rc}")
    launches += 1
    narrow_launches += narrow.value
    return out


def cnn_probs(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """Probabilities [N, A1] of k-mers x [N, lag, A1] under the CNN's
    parameters (checkpoint order), on a CUDA card, by one launch."""
    if x.device.type != "cuda":
        raise ValueError(f"cnn_forward runs on a CUDA card; x is on {x.device} (the CPU "
                         f"runs CNNAR's plain forward)")
    x = x.contiguous()
    params = [p.detach().contiguous() for p in params]
    lag, A1, fw, nf, w1 = widths(x, params)
    out = torch.empty((x.shape[0], A1), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    shape = launch_shape(x.shape[0], x.element_size(), sm_count(x.device.index), lag, A1, fw,
                         nf, w1)
    return launch(x, params, out, shape)
