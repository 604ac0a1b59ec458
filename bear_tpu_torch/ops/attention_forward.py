"""The attention AR function's block under inference as one hand-written
kernel, ``csrc/attention_forward.cu`` (its note says what it computes, what
bounds it on the card and what the design does about it).

:func:`attention_probs` maps one-hot contexts x [N, lag, A1] and the attention
AR's parameters in checkpoint order (``models.ar_funcs.AttentionAR``) to
probabilities [N, A1], on the tensors' card, in their float type (float32 or
float64). Its plain PyTorch version is ``AttentionAR._block_plain``
(``bear_tpu_torch/models/ar_funcs.py``), the ATen path that the CPU, autograd
and a ``compute_dtype`` run; ``AttentionAR._block`` picks between the two by
what the call shows, with no switch. A CUDA call launches the kernel or
raises. The module's ``launches`` counts kernel launches (callers reset it).

The kernel takes any widths whose block fits shared memory
(:func:`smem_bytes`): :func:`fits` says which, and :func:`widths` refuses the
rest. A head wider than a team of 16 lanes spans column blocks of its own
(:func:`column_blocks`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import torch

from bear_tpu_torch import _build
from bear_tpu_torch.utils.device import sm_count

SOURCE = "attention_forward"
TEAM = 16  # mirrors of csrc/attention_forward.cu
CHUNK = 13
SMEM_MAX = 232_448
PARAM_NAMES = ("embed", "pos", "wqkv", "wo", "w1", "b1", "w2", "b2", "w_out", "b_out")
launches = 0


class LaunchShape(NamedTuple):
    """A launch: ``warps`` warps a block (two rows at a time each),
    ``blocks`` blocks, and whether wq, wo, w1 and w2 are held in each block's
    shared memory (``resident``) or read from device memory."""

    warps: int
    blocks: int
    resident: bool


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def head_lanes(D: int, H: int, itemsize: int) -> int:
    """Lanes a head takes in a column block: its D / H columns over the C =
    16 / itemsize a lane owns, rounded up to a power of two, at most TEAM."""
    C, dh = 16 // itemsize, D // H
    lanes = 1
    while lanes < TEAM and lanes * C < dh:
        lanes *= 2
    return lanes


def column_blocks(D: int, H: int, itemsize: int) -> int:
    """Column blocks of TEAM x C columns that hold wk and wv: TEAM /
    :func:`head_lanes` heads a block, or, where a head is wider than a block,
    ceil(D / H / (TEAM x C)) blocks for each head."""
    C, lanes = 16 // itemsize, head_lanes(D, H, itemsize)
    span = -(-(D // H) // (lanes * C))
    return H * span if span > 1 else -(-H // (TEAM // lanes))


def smem_bytes(warps: int, itemsize: int, lag: int, A1: int, D: int, H: int, M: int,
               resident: bool = False) -> int:
    """Shared memory of a block of ``warps`` warps (csrc/attention_forward.cu
    layout): wk and wv padded by head, column blocks of 16 C, [D4] rows each;
    embed and pos; b1, b2, w_out and b_out; where ``resident``, wq, wo, w1 and
    w2, rows padded to whole 16-byte vectors; and each warp's two buffers of two rows' inputs and two
    rows' regions: the normalised activations at every position (lag rounded
    up to CHUNK; after the attention, the MLP's vectors), then the last
    position's x, the query and the context, the region padded so that the
    warp's two rows sit 4 banks apart."""
    V = 16 // itemsize
    blocks = column_blocks(D, H, itemsize)
    D4, M4, A1p = (_round_up(w, V) for w in (D, M, A1))
    LP = _round_up(lag, CHUNK)
    rs = max(LP * D4, D4 + M4 + A1p) + 3 * D4
    while (rs * itemsize // 4) % 32 != 4:
        rs += V
    per_warp = 2 * _round_up(2 * lag * A1, V) + 2 * rs
    small = _round_up(M4 + D4 + D * A1 + A1, V)
    weights = (2 * D + M) * D4 + D * M4 if resident else 0
    elems = (blocks * D4 * 2 * TEAM * V + A1 * D4 + lag * D4 + small + weights
             + warps * per_warp)
    return elems * itemsize


def fits(itemsize: int, lag: int, A1: int, D: int, H: int, M: int) -> bool:
    """Whether the kernel takes these widths: whether a block of one warp
    fits shared memory. Nothing else bounds them."""
    return smem_bytes(1, itemsize, lag, A1, D, H, M) <= SMEM_MAX


def launch_shape(n: int, itemsize: int, sms: int, lag: int, A1: int, D: int, H: int,
                 M: int) -> LaunchShape:
    """The blocks for n rows on a card of ``sms`` SMs: the weights resident
    where a block of 8 warps holds them, else the most warps (of 8, 4, 2, 1)
    whose block fits shared memory; as many blocks as the rows' pairs fill,
    at most one an SM (the blocks are persistent: each warp walks its pairs
    of rows)."""
    resident = smem_bytes(8, itemsize, lag, A1, D, H, M, True) <= SMEM_MAX
    warps = next(w for w in (8, 4, 2, 1)
                 if smem_bytes(w, itemsize, lag, A1, D, H, M, resident) <= SMEM_MAX)
    pairs = -(-n // 2)
    return LaunchShape(warps, max(1, min(sms, -(-pairs // warps))), resident)


def widths(x: torch.Tensor, params: Sequence[torch.Tensor], num_heads: int):
    """(lag, A1, D, H, M) of x [N, lag, A1], the parameters and ``num_heads``;
    raises where they disagree with each other or with the kernel."""
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"the attention AR takes {len(PARAM_NAMES)} parameter arrays, got "
                         f"{len(params)}")
    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 3:
        raise TypeError(f"attention_forward needs float32 or float64 contexts [N, lag, A1], "
                        f"got {x.dtype} {tuple(x.shape)}")
    _, lag, A1 = x.shape
    embed, w1 = params[0], params[4]
    if embed.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"embed [A1, D] and w1 [D, M], got {tuple(embed.shape)} and "
                         f"{tuple(w1.shape)}")
    D, M, H = embed.shape[1], w1.shape[1], int(num_heads)
    want = [(A1, D), (lag, D), (3, D, D), (D, D), (D, M), (M,), (M, D), (D,), (D, A1), (A1,)]
    for name, p, shape in zip(PARAM_NAMES, params, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} is {tuple(p.shape)}, the attention AR of contexts "
                             f"{tuple(x.shape[1:])} needs {shape}")
    for name, t in (("x", x),) + tuple(zip(PARAM_NAMES, params)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"attention_forward needs its tensors in one type on one device: "
                            f"{name} is {t.dtype} on {t.device}, x {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention_forward needs contiguous tensors; {name} is not")
    if H < 1 or D % H:
        raise ValueError(f"d_model {D} is not a multiple of num_heads {H}")
    if not fits(x.element_size(), lag, A1, D, H, M):
        raise ValueError(f"the attention AR of contexts {tuple(x.shape[1:])}, d_model {D}, "
                         f"{H} heads and MLP width {M} in {x.dtype} needs "
                         f"{smem_bytes(1, x.element_size(), lag, A1, D, H, M)} bytes of "
                         f"shared memory a block, at most {SMEM_MAX}")
    return lag, A1, D, H, M


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its function's argument types set."""
    lib = _build.load(SOURCE)
    fn = lib.attention_forward_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] + [ctypes.c_int32] * 9
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def launch(x, params, num_heads, out, shape: LaunchShape) -> torch.Tensor:
    """One kernel launch into ``out`` [N, A1] on the tensors' card in launch
    shape ``shape``, on the current stream; raises where :func:`widths`
    refuses the arguments, the launcher refuses the shape, or the launch
    fails. :func:`attention_probs` picks the shape; a caller may pass
    another."""
    global launches
    lag, A1, D, H, M = widths(x, params, num_heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().attention_forward_launch(
            x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), x.shape[0], lag, A1,
            D, H, M, x.element_size(), shape.warps, shape.blocks, int(shape.resident),
            1.0 / math.sqrt(D // H), stream)
    if rc != 0:
        raise RuntimeError(f"attention_forward kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def attention_probs(x: torch.Tensor, params: Sequence[torch.Tensor],
                    num_heads: int) -> torch.Tensor:
    """Probabilities [N, A1] of one-hot contexts x [N, lag, A1] under the
    attention AR's parameters (checkpoint order), on a CUDA card, by one
    launch."""
    if x.device.type != "cuda":
        raise ValueError(f"attention_forward runs on a CUDA card; x is on {x.device} (the CPU "
                         f"runs AttentionAR's plain block)")
    params = [p.detach() for p in params]
    lag, A1, D, H, M = widths(x, params, num_heads)
    out = torch.empty((x.shape[0], A1), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    shape = launch_shape(x.shape[0], x.element_size(), sm_count(x.device.index), lag, A1, D,
                         H, M)
    return launch(x, params, num_heads, out, shape)
