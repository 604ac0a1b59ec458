"""Embedded autoregressive functions as ``nn.Module``s (port of
bear_tpu/models/ar_funcs.py).

An AR function maps one-hot k-mers [..., lag, A+1] to transition
probabilities [..., A+1] (``forward``, the JAX ``ARFunc.apply``) or the same
from integer codes [..., lag] (``apply_codes``). Parameters keep the JAX
package's list order and shapes — the checkpoint contract
``[h_signed] + ar`` (bear_tpu/models/bear_net.py:78-90) — so a model
directory written by bear_tpu loads here unchanged.

Each module holds its parameters for scoring (``load_params``,
``params_list``), and both ``forward`` and ``apply_codes`` also take an
explicit ``params`` list: training and evaluation pass theirs, as
bear_tpu's pure ``apply(params, x)`` does, and leave the module's own
unchanged. ``init(generator)`` draws a fresh list (bear_tpu's
``ARFunc.init``) on the CPU.

Mixed precision (``compute_dtype``, e.g. ``torch.bfloat16``): the
parameters stay in their own (master) type and are cast to the compute type
once at the start of each forward, so gradients flow back through the cast
to the master parameters; layer-norm statistics stay in at least float32,
and the logits are cast back to the master type before the softmax, so the
probabilities come out in the master type (bear_tpu's ``_cast_params``).
``StopAR`` has nothing to compute and ignores it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bear_tpu_torch.ops import attention_forward, cnn_forward
from bear_tpu_torch.utils.profiling import span

# Rows that AttentionAR's block has evaluated (callers reset it).
attention_rows = 0


def flat_one_hot(codes: torch.Tensor, alphabet_size_1: int, dtype) -> torch.Tensor:
    """[..., lag] int codes -> flat [..., lag * A1] one-hot where slot
    k = position * A1 + letter."""
    letters = torch.arange(alphabet_size_1, dtype=codes.dtype, device=codes.device)
    oh = codes[..., None] == letters
    return oh.reshape(tuple(codes.shape[:-1]) + (-1,)).to(dtype)


def _l2_normalize(x: torch.Tensor, dim) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True), min=1e-24))


def _normalize_layer(layer: torch.Tensor) -> torch.Tensor:
    """Scale-free layer normalisation over the last axis (reference
    ar_funcs.py:5-20): population variance, statistics in at least
    float32, result in the activation's type."""
    x = layer.to(torch.promote_types(layer.dtype, torch.float32))
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return ((x - mean) / torch.sqrt(var + 1e-5)).to(layer.dtype)


def _elu(x: torch.Tensor) -> torch.Tensor:
    """elu with alpha 1, written as jax.nn.elu is (expm1 of the clamped
    input, so small negative inputs keep their relative precision)."""
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0)))


def _kernel_takes(x: torch.Tensor, live: Sequence[torch.Tensor], compute_dtype) -> bool:
    """Whether an AR function's inference kernel may run (``CNNAR.forward``:
    ops/cnn_forward.py; ``AttentionAR._block``: ops/attention_forward.py): a
    CUDA input, float32 or float64 parameters computed in their own type, and
    nothing for autograd to record (grad mode off, or neither the input nor a
    parameter requires grad)."""
    if (x.device.type != "cuda" or compute_dtype is not None
            or live[0].dtype not in (torch.float32, torch.float64)):
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or any(p.requires_grad for p in live)))


@contextlib.contextmanager
def _full_fp32_matmul():
    """float32 matmuls in full float32 (no TF32, which keeps ~3 digits).
    PyTorch's default already is False; it is set here so that a caller's
    own TF32 opt-in cannot round the AR logits."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _ARModule(nn.Module):
    """Parameters in checkpoint order (``PARAM_NAMES``), held as
    attributes, with the load/list/init side shared by every AR function."""

    PARAM_NAMES: tuple = ()
    compute_dtype: Optional[torch.dtype] = None

    def _compute(self, params: Optional[Sequence[torch.Tensor]]):
        """(live parameters cast to the compute type, the master type)."""
        live = self._live(params)
        out_dt = live[0].dtype
        if self.compute_dtype is not None:
            live = [p.to(self.compute_dtype) for p in live]
        return live, out_dt

    def _set_params(self, params: Sequence[torch.Tensor], device) -> None:
        for name, p in zip(self.PARAM_NAMES, params):
            setattr(self, name, nn.Parameter(p.to(device)))

    def _live(self, params: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        if params is not None:
            return list(params)
        return [getattr(self, n) for n in self.PARAM_NAMES]

    def load_params(self, ar_params: Sequence) -> None:
        """Load the ``ar`` part of a checkpoint list (numpy arrays or
        tensors) into the module's own parameters."""
        if len(ar_params) != len(self.PARAM_NAMES):
            raise ValueError(f"{self.name} AR takes {len(self.PARAM_NAMES)} "
                             f"parameter arrays, got {len(ar_params)}")
        with torch.no_grad():
            for name, p in zip(self.PARAM_NAMES, ar_params):
                if not isinstance(p, torch.Tensor):
                    p = torch.from_numpy(np.array(p))  # own copy: may be read-only
                getattr(self, name).copy_(p)

    def params_list(self) -> List[torch.Tensor]:
        """Parameters in checkpoint order."""
        return [getattr(self, n).detach() for n in self.PARAM_NAMES]


class LinearAR(_ARModule):
    """Linear AR function: softmax of a per-position linear map, one
    parameter ``mat`` [lag, A+1, A+1] (reference ar_funcs.py:23-46; init
    0.05 * l2-normalised normal over the input-letter axis, drawn on the
    CPU from ``generator`` and then moved to ``device``)."""

    name = "linear"
    PARAM_NAMES = ("mat",)

    def __init__(self, lag: int, alphabet_size: int, *, dtype=torch.float32,
                 compute_dtype=None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self._set_params(self.init(generator), device)

    def init(self, generator: torch.Generator | None = None) -> List[torch.Tensor]:
        mat = torch.randn((self.lag, self.A1, self.A1), generator=generator,
                          dtype=self.dtype)
        return [0.05 * _l2_normalize(mat, 1)]

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]."""
        (mat,), out_dt = self._compute(params)
        with _full_fp32_matmul():
            logits = torch.einsum("...jk,jkl->...l", kmers_oh.to(mat.dtype), mat)
        return torch.softmax(logits.to(out_dt), dim=-1)

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1]."""
        (mat,), out_dt = self._compute(params)
        oh = flat_one_hot(codes, self.A1, mat.dtype)
        with _full_fp32_matmul():
            logits = oh @ mat.reshape(self.lag * self.A1, self.A1)
        return torch.softmax(logits.to(out_dt), dim=-1)


class CNNAR(_ARModule):
    """CNN AR function (reference ar_funcs.py:49-99): a VALID convolution
    over the lag axis, two normalised dense layers with elu, a softmax head.
    Parameters, in checkpoint order: filters [fw, A+1, nf], intercept0
    [conv_len, nf], weights1 [conv_len, nf, w1], intercept1 [w1], weights2
    [w1, A+1], intercept2 [A+1], scale0 [conv_len, nf], scale1 [w1].

    Both paths compute the convolution as matmuls (no cuDNN, whose float32
    convolutions may use TF32): ``forward`` over sliding windows of the
    one-hot input, ``apply_codes`` as one flat matmul of the flat one-hot
    with banded filters, as bear_tpu's ``apply_codes`` does.

    ``forward`` under inference on a card (``_kernel_takes``: CUDA,
    float32 or float64 without ``compute_dtype``, nothing for autograd to
    record) is one launch of the hand-written kernel ``csrc/cnn_forward.cu``
    (``ops.cnn_forward``), the same function in the same precision with no
    intermediate in device memory; everywhere else it runs the ATen path,
    ``_forward_plain``, which autograd, the CPU and mixed precision need."""

    name = "cnn"
    PARAM_NAMES = ("filters", "intercept0", "weights1", "intercept1",
                   "weights2", "intercept2", "scale0", "scale1")

    def __init__(self, lag: int, alphabet_size: int, filter_width=8, num_filters=30,
                 kmer_layer1_width=16, *, dtype=torch.float32, compute_dtype=None,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        self.fw = int(filter_width)
        self.nf = int(num_filters)
        self.w1 = int(kmer_layer1_width)
        self.conv_len = lag - self.fw + 1
        if self.conv_len < 1:
            raise ValueError(
                f"filter_width {self.fw} exceeds lag {lag}: the VALID conv "
                f"needs filter_width <= lag (reference ar_funcs.py:60)"
            )
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self._set_params(self.init(generator), device)

    def init(self, generator: torch.Generator | None = None) -> List[torch.Tensor]:
        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=self.dtype)

        filters = _l2_normalize(normal(self.fw, self.A1, self.nf), (0, 1))
        weights1 = _l2_normalize(normal(self.conv_len, self.nf, self.w1), 0)
        weights2 = 0.05 * _l2_normalize(normal(self.w1, self.A1), 0)
        ones = dict(dtype=self.dtype)
        return [
            filters,
            torch.ones((self.conv_len, self.nf), **ones),
            weights1,
            torch.ones((self.w1,), **ones),
            weights2,
            torch.zeros((self.A1,), **ones),
            torch.ones((self.conv_len, self.nf), **ones),
            torch.ones((self.w1,), **ones),
        ]

    def _head(self, params, conv, lead, out_dt):
        (_, intercept0, weights1, intercept1, weights2, intercept2,
         scale0, scale1) = params
        nn0 = scale0 * _normalize_layer(conv) + intercept0
        with _full_fp32_matmul():
            hidden = torch.tensordot(_elu(nn0), weights1, dims=([-2, -1], [0, 1]))
            nn1 = scale1 * _normalize_layer(hidden) + intercept1
            nn2 = _elu(nn1) @ weights2 + intercept2
        return torch.softmax(nn2.to(out_dt), dim=-1).reshape(lead + (self.A1,))

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]: the
        kernel where ``_kernel_takes``, else ``_forward_plain``."""
        live = self._live(params)
        if _kernel_takes(kmers_oh, live, self.compute_dtype):
            lead = tuple(kmers_oh.shape[:-2])
            x = kmers_oh.to(live[0].dtype).reshape(-1, self.lag, self.A1)
            return cnn_forward.cnn_probs(x, live).reshape(lead + (self.A1,))
        return self._forward_plain(kmers_oh, params)

    def _forward_plain(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """The ATen forward: the windows' conv as one batched product, then
        ``_head``."""
        params, out_dt = self._compute(params)
        filters = params[0]
        lead = tuple(kmers_oh.shape[:-2])
        x = kmers_oh.to(filters.dtype).reshape(-1, self.lag, self.A1)
        windows = x.unfold(1, self.fw, 1)  # [N, conv_len, A1, fw]
        with _full_fp32_matmul():
            conv = torch.einsum("njiw,wio->njo", windows, filters)
        return self._head(params, conv, lead, out_dt)

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1]."""
        params, out_dt = self._compute(params)
        filters = params[0]
        lead = tuple(codes.shape[:-1])
        A1, fw, lag = self.A1, self.fw, self.lag
        oh = flat_one_hot(codes.reshape(-1, lag), A1, filters.dtype)
        # The VALID conv as ONE flat matmul: the filters banded into
        # [lag*A1, conv_len*nf] (output j reads one-hot slots j*A1 ..
        # (j+fw)*A1); pad/stack keeps it scatter-free and differentiable.
        f2 = filters.reshape(fw * A1, self.nf)
        wconv = torch.stack(
            [torch.nn.functional.pad(f2, (0, 0, j * A1, (lag - fw - j) * A1))
             for j in range(self.conv_len)],
            dim=1,
        ).reshape(lag * A1, self.conv_len * self.nf)
        with _full_fp32_matmul():
            conv = (oh @ wconv).reshape(-1, self.conv_len, self.nf)
        return self._head(params, conv, lead, out_dt)


class StopAR(_ARModule):
    """Constant stop-predicting AR function, the ``g`` of the reference
    model (reference ar_funcs.py:102-127); no parameters."""

    name = "stop"

    def __init__(self, lag: int, alphabet_size: int, *, dtype=torch.float32,
                 compute_dtype=None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        self.dtype = dtype
        stop = torch.zeros(self.A1, dtype=dtype)
        stop[-1] = 1.0
        self.register_buffer("stop", stop.to(device))

    def init(self, generator: torch.Generator | None = None) -> List[torch.Tensor]:
        return []

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        return self.stop.expand(tuple(kmers_oh.shape[:-2]) + (self.A1,))

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        return self.stop.expand(tuple(codes.shape[:-1]) + (self.A1,))


class AttentionAR(_ARModule):
    """Single-block self-attention AR function (reference ar_funcs.py:
    246-321, a bear_tpu extension): the one-hot context embedded with a
    learned positional encoding, one multi-head self-attention + MLP block
    with pre-normalisation and residuals, and the transition logits read
    from the last position. Parameters, in checkpoint order: embed [A+1, D],
    pos [lag, D], wqkv [3, D, D], wo [D, D], w1 [D, M], b1 [M], w2 [M, D],
    b2 [D], w_out [D, A+1], b_out [A+1] (D = d_model, M = mlp_width).

    The block follows bear_tpu's order of operations: the scores are q . k
    scaled by 1/sqrt(d_head) afterwards, a softmax over the keys, then the
    context; gelu is the tanh approximation (``jax.nn.gelu``'s default).
    Only the last position's output is read, so only its query, its
    attention row and its MLP are computed: every other position's would be
    thrown away, and each of these is a per-position operation.

    The block under inference on a card (``_takes_attention_kernel``) is
    one launch of the hand-written kernel ``csrc/attention_forward.cu``, the
    same function in the same precision with no intermediate in device
    memory; everywhere else it runs the ATen block, ``_block_plain``, which
    autograd, the CPU, mixed precision and widths past shared memory need."""

    name = "attention"
    PARAM_NAMES = ("embed", "pos", "wqkv", "wo", "w1", "b1", "w2", "b2", "w_out", "b_out")

    def __init__(self, lag: int, alphabet_size: int, d_model=64, num_heads=4, mlp_width=128,
                 *, dtype=torch.float32, compute_dtype=None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        self.d_model = int(d_model)
        self.num_heads = int(num_heads)
        self.mlp_width = int(mlp_width)
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of num_heads "
                             f"{self.num_heads}")
        self.d_head = self.d_model // self.num_heads
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self._set_params(self.init(generator), device)

    def init(self, generator: torch.Generator | None = None) -> List[torch.Tensor]:
        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=self.dtype)

        D, M, A1 = self.d_model, self.mlp_width, self.A1
        scale = 1.0 / math.sqrt(D)
        zeros = dict(dtype=self.dtype)
        return [
            0.05 * _l2_normalize(normal(A1, D), 0),
            torch.zeros((self.lag, D), **zeros),
            scale * normal(3, D, D),
            scale * normal(D, D),
            scale * normal(D, M),
            torch.zeros((M,), **zeros),
            0.05 * _l2_normalize(normal(M, D), 0),
            torch.zeros((D,), **zeros),
            0.05 * _l2_normalize(normal(D, A1), 0),
            torch.zeros((A1,), **zeros),
        ]

    def _takes_attention_kernel(self, x: torch.Tensor, live: Sequence[torch.Tensor]) -> bool:
        """Whether ``_block`` launches the kernel: ``_kernel_takes``, and
        widths whose block of one warp fits shared memory
        (``ops.attention_forward.fits``; any head width, head count, lag,
        alphabet and MLP width short of that). Widths past shared memory run
        the ATen block; nothing else routes a qualifying call there."""
        return (_kernel_takes(x, live, self.compute_dtype)
                and attention_forward.fits(live[0].element_size(), self.lag, self.A1,
                                           self.d_model, self.num_heads, self.mlp_width))

    def _block(self, params, oh, lead, out_dt):
        """Probabilities from the one-hot context [n, lag, A+1], under the
        span ``bear.ar.attention``, by the kernel where
        ``_takes_attention_kernel``, else ``_block_plain``; adds n to
        ``attention_rows``."""
        global attention_rows
        attention_rows += oh.shape[0]
        with span("bear.ar.attention"):
            if self._takes_attention_kernel(oh, params):
                probs = attention_forward.attention_probs(oh.contiguous(), params,
                                                          self.num_heads)
                return probs.reshape(lead + (self.A1,))
            return self._block_plain(params, oh, lead, out_dt)

    def _block_plain(self, params, oh, lead, out_dt):
        """The ATen block: probabilities from the one-hot context [n, lag,
        A+1]."""
        embed, pos, wqkv, wo, w1, b1, w2, b2, w_out, b_out = params
        n, H, dh = oh.shape[0], self.num_heads, self.d_head
        with _full_fp32_matmul():
            x = oh @ embed + pos
            h = _normalize_layer(x)
            q = (h[:, -1] @ wqkv[0]).reshape(n, H, dh)
            k = (h @ wqkv[1]).reshape(n, self.lag, H, dh)
            v = (h @ wqkv[2]).reshape(n, self.lag, H, dh)
            att = torch.softmax(torch.einsum("nhd,nkhd->nhk", q, k) * (1.0 / math.sqrt(dh)),
                                dim=-1)
            ctx = torch.einsum("nhk,nkhd->nhd", att, v).reshape(n, self.d_model)
            x = x[:, -1] + ctx @ wo
            y = _normalize_layer(x)
            x = x + torch.nn.functional.gelu(y @ w1 + b1, approximate="tanh") @ w2 + b2
            logits = x @ w_out + b_out
            return torch.softmax(logits.to(out_dt), dim=-1).reshape(lead + (self.A1,))

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]."""
        params, out_dt = self._compute(params)
        lead = tuple(kmers_oh.shape[:-2])
        oh = kmers_oh.to(params[0].dtype).reshape(-1, self.lag, self.A1)
        return self._block(params, oh, lead, out_dt)

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1].

        bear_tpu embeds the flat one-hot with one matmul by kron(I_lag,
        embed); here each position's one-hot [A+1] meets embed itself. The
        two are exactly equal: each embedded value is one product by 1.0
        plus zeros, i.e. the row of embed that the code picks."""
        params, out_dt = self._compute(params)
        lead = tuple(codes.shape[:-1])
        oh = flat_one_hot(codes.reshape(-1, self.lag), self.A1, params[0].dtype)
        return self._block(params, oh.reshape(-1, self.lag, self.A1), lead, out_dt)


_AR_FUNCS = {"linear": LinearAR, "cnn": CNNAR, "stop": StopAR, "attention": AttentionAR}


def get_ar_func(name: str, lag: int, alphabet_size: int, af_kwargs=None, *,
                dtype=torch.float32, compute_dtype=None, device="cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """AR function by config name (reference train_bear_net.py:103).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the AR network in that
    type while its parameters and output stay in ``dtype`` (module
    docstring)."""
    if name not in _AR_FUNCS:
        raise ValueError(f"unknown AR function {name!r}")
    if af_kwargs and name not in ("cnn", "attention"):
        raise ValueError(f"{name} AR takes no af_kwargs, got {af_kwargs}")
    return _AR_FUNCS[name](lag, alphabet_size, **(af_kwargs or {}), dtype=dtype,
                           compute_dtype=compute_dtype, device=device, generator=generator)
