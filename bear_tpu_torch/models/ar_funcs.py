"""Embedded autoregressive functions as ``nn.Module``s (port of
bear_tpu/models/ar_funcs.py).

An AR function maps one-hot k-mers [..., lag, A+1] to transition
probabilities [..., A+1] (``forward``, the JAX ``ARFunc.apply``) or the same
from integer codes [..., lag] (``apply_codes``). Parameters keep the JAX
package's list order and shapes — the checkpoint contract
``[h_signed] + ar`` (bear_tpu/models/bear_net.py:78-90) — so a model
directory written by bear_tpu loads here unchanged.

Only ``linear`` is ported; ``cnn``, ``stop`` and ``attention`` follow with
the training slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch
from torch import nn


def flat_one_hot(codes: torch.Tensor, alphabet_size_1: int, dtype) -> torch.Tensor:
    """[..., lag] int codes -> flat [..., lag * A1] one-hot where slot
    k = position * A1 + letter."""
    lag = codes.shape[-1]
    A1 = alphabet_size_1
    dev = codes.device
    pos_of_k = torch.arange(lag, device=dev).repeat_interleave(A1)
    letter_of_k = torch.arange(A1, device=dev).repeat(lag)
    return (codes.long()[..., pos_of_k] == letter_of_k).to(dtype)


def _l2_normalize(x: torch.Tensor, dim) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True), min=1e-24))


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


class LinearAR(nn.Module):
    """Linear AR function: softmax of a per-position linear map, one
    parameter ``mat`` [lag, A+1, A+1] (reference ar_funcs.py:23-46; init
    0.05 * l2-normalised normal over the input-letter axis, drawn on the
    CPU from ``generator`` and then moved to ``device``)."""

    name = "linear"

    def __init__(self, lag: int, alphabet_size: int, *, dtype=torch.float32,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.lag = lag
        self.A1 = alphabet_size + 1
        mat = torch.randn((lag, self.A1, self.A1), generator=generator,
                          dtype=dtype)
        self.mat = nn.Parameter((0.05 * _l2_normalize(mat, 1)).to(device))

    def forward(self, kmers_oh: torch.Tensor) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] -> probabilities [..., A+1]."""
        with _full_fp32_matmul():
            logits = torch.einsum("...jk,jkl->...l",
                                  kmers_oh.to(self.mat.dtype), self.mat)
        return torch.softmax(logits, dim=-1)

    def apply_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """Integer k-mer codes [..., lag] -> probabilities [..., A+1]."""
        oh = flat_one_hot(codes, self.A1, self.mat.dtype)
        with _full_fp32_matmul():
            logits = oh @ self.mat.reshape(self.lag * self.A1, self.A1)
        return torch.softmax(logits, dim=-1)

    def load_params(self, ar_params: Sequence) -> None:
        """Load the ``ar`` part of a checkpoint list ([mat])."""
        (mat,) = ar_params
        if not isinstance(mat, torch.Tensor):
            mat = torch.from_numpy(np.array(mat))  # own copy: may be read-only
        with torch.no_grad():
            self.mat.copy_(mat)

    def params_list(self) -> List[torch.Tensor]:
        """Parameters in checkpoint order."""
        return [self.mat.detach()]


_NOT_PORTED = ("cnn", "stop", "attention")


def get_ar_func(name: str, lag: int, alphabet_size: int, af_kwargs=None, *,
                dtype=torch.float32, device="cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """AR function by config name (reference train_bear_net.py:103)."""
    if name == "linear":
        if af_kwargs:
            raise ValueError(f"linear AR takes no af_kwargs, got {af_kwargs}")
        return LinearAR(lag, alphabet_size, dtype=dtype, device=device,
                        generator=generator)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"AR function {name!r} is not ported to PyTorch yet; see "
            "ROADMAP.md Queue 1 (AR functions)"
        )
    raise ValueError(f"unknown AR function {name!r}")
