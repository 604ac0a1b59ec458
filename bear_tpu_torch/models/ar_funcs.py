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

``linear``, ``cnn`` and ``stop`` are ported; ``attention`` is not yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn


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
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        self.dtype = dtype
        self._set_params(self.init(generator), device)

    def init(self, generator: torch.Generator | None = None) -> List[torch.Tensor]:
        mat = torch.randn((self.lag, self.A1, self.A1), generator=generator,
                          dtype=self.dtype)
        return [0.05 * _l2_normalize(mat, 1)]

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]."""
        (mat,) = self._live(params)
        with _full_fp32_matmul():
            logits = torch.einsum("...jk,jkl->...l", kmers_oh.to(mat.dtype), mat)
        return torch.softmax(logits, dim=-1)

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1]."""
        (mat,) = self._live(params)
        oh = flat_one_hot(codes, self.A1, mat.dtype)
        with _full_fp32_matmul():
            logits = oh @ mat.reshape(self.lag * self.A1, self.A1)
        return torch.softmax(logits, dim=-1)


class CNNAR(_ARModule):
    """CNN AR function (reference ar_funcs.py:49-99): a VALID convolution
    over the lag axis, two normalised dense layers with elu, a softmax head.
    Parameters, in checkpoint order: filters [fw, A+1, nf], intercept0
    [conv_len, nf], weights1 [conv_len, nf, w1], intercept1 [w1], weights2
    [w1, A+1], intercept2 [A+1], scale0 [conv_len, nf], scale1 [w1].

    Both paths compute the convolution as matmuls (no cuDNN, whose float32
    convolutions may use TF32): ``forward`` over sliding windows of the
    one-hot input, ``apply_codes`` as one flat matmul of the flat one-hot
    with banded filters, as bear_tpu's ``apply_codes`` does."""

    name = "cnn"
    PARAM_NAMES = ("filters", "intercept0", "weights1", "intercept1",
                   "weights2", "intercept2", "scale0", "scale1")

    def __init__(self, lag: int, alphabet_size: int, filter_width=8, num_filters=30,
                 kmer_layer1_width=16, *, dtype=torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
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

    def _head(self, params, conv, lead):
        (_, intercept0, weights1, intercept1, weights2, intercept2,
         scale0, scale1) = params
        nn0 = scale0 * _normalize_layer(conv) + intercept0
        with _full_fp32_matmul():
            hidden = torch.tensordot(_elu(nn0), weights1, dims=([-2, -1], [0, 1]))
            nn1 = scale1 * _normalize_layer(hidden) + intercept1
            nn2 = _elu(nn1) @ weights2 + intercept2
        return torch.softmax(nn2, dim=-1).reshape(lead + (self.A1,))

    def forward(self, kmers_oh: torch.Tensor, params=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]."""
        params = self._live(params)
        filters = params[0]
        lead = tuple(kmers_oh.shape[:-2])
        x = kmers_oh.to(filters.dtype).reshape(-1, self.lag, self.A1)
        windows = x.unfold(1, self.fw, 1)  # [N, conv_len, A1, fw]
        with _full_fp32_matmul():
            conv = torch.einsum("njiw,wio->njo", windows, filters)
        return self._head(params, conv, lead)

    def apply_codes(self, codes: torch.Tensor, params=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1]."""
        params = self._live(params)
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
        return self._head(params, conv, lead)


class StopAR(_ARModule):
    """Constant stop-predicting AR function, the ``g`` of the reference
    model (reference ar_funcs.py:102-127); no parameters."""

    name = "stop"

    def __init__(self, lag: int, alphabet_size: int, *, dtype=torch.float32,
                 device="cuda", generator: torch.Generator | None = None):
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


_AR_FUNCS = {"linear": LinearAR, "cnn": CNNAR, "stop": StopAR}


def get_ar_func(name: str, lag: int, alphabet_size: int, af_kwargs=None, *,
                dtype=torch.float32, device="cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """AR function by config name (reference train_bear_net.py:103)."""
    if name == "attention":
        raise NotImplementedError(
            "AR function 'attention' is not ported to PyTorch yet; see "
            "ROADMAP.md Queue 1 (AR functions)"
        )
    if name not in _AR_FUNCS:
        raise ValueError(f"unknown AR function {name!r}")
    if af_kwargs and name != "cnn":
        raise ValueError(f"{name} AR takes no af_kwargs, got {af_kwargs}")
    return _AR_FUNCS[name](lag, alphabet_size, **(af_kwargs or {}), dtype=dtype,
                           device=device, generator=generator)
