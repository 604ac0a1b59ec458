"""The attention AR function in plain PyTorch: one pre-normalised
transformer block over a k-mer's positions (bear_tpu's extension of BEAR,
Amin, Weinstein and Marks, NeurIPS 2021; bear_tpu/models/ar_funcs.py,
``make_ar_func_attention``).

Parameters are a list in checkpoint order, ``[embed [A1, D], pos [lag, D],
wqkv [3, D, D], wo [D, D], w1 [D, M], b1 [M], w2 [M, D], b2 [D], w_out [D,
A1], b_out [A1]]``, D the model width, M the MLP's. For a one-hot context
x0 [lag, A1]:

    x = x0 embed + pos
    h = norm(x)                       (population variance, eps 1e-5)
    q, k, v = h wqkv[0], h wqkv[1], h wqkv[2], split into heads of D / H
    att = softmax over the keys of (q . k) / sqrt(D / H), per head
    x = x + concat_heads(att v) wo
    x = x + gelu_tanh(norm(x) w1 + b1) w2 + b2
    probabilities = softmax(x[last] w_out + b_out)

One departure from the program, which computes only what the last
position's output needs: here every position's query, attention row, MLP
and head are computed, and the last position's probabilities are read.
The other positions' outputs are thrown away; the last one's value is the
same mathematics.

The float type is the parameters'. Matrix products run in full float32
(TF32 off, through ``model.matmul_precision``) unless ``tf32`` asks for
the precision below it.
"""

from __future__ import annotations

import math

import torch

from bench_gpu.reference.model import matmul_precision


def layer_norm(x):
    """Scale-free normalisation over the last axis, population variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


def gelu_tanh(x):
    """gelu's tanh approximation, 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention_probs(oh: torch.Tensor, ar, num_heads: int, tf32: bool = False) -> torch.Tensor:
    """One-hot contexts [N, lag, A1] -> probabilities [N, A1]."""
    with matmul_precision(tf32):
        return _probs(oh, ar, num_heads)


def _probs(oh, ar, num_heads):
    embed, pos, wqkv, wo, w1, b1, w2, b2, w_out, b_out = ar
    n, lag = oh.shape[0], oh.shape[1]
    D = embed.shape[1]
    dh = D // num_heads
    x = torch.matmul(oh.to(embed.dtype), embed) + pos
    h = layer_norm(x)

    def heads(w):  # [N, lag, D] -> [N, H, lag, dh]
        return torch.matmul(h, w).reshape(n, lag, num_heads, dh).transpose(1, 2)

    q, k, v = heads(wqkv[0]), heads(wqkv[1]), heads(wqkv[2])
    att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    ctx = torch.matmul(att, v).transpose(1, 2).reshape(n, lag, D)
    x = x + torch.matmul(ctx, wo)
    x = x + torch.matmul(gelu_tanh(torch.matmul(layer_norm(x), w1) + b1), w2) + b2
    logits = torch.matmul(x, w_out) + b_out
    return torch.softmax(logits, dim=-1)[:, -1]
