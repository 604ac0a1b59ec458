"""Seeded weights of an attention configuration, made on the device.

One ``torch.Generator`` on the run's device, seeded with the run's seed,
draws every normal in one call, split into the leaves in checkpoint order
(``reference.attention``): wqkv, wo and w1 are normals over sqrt(D), as
the AR function's initialisation draws them; embed, w2 and w_out 0.05 x
normals l2-normalised over their first axis, as it does too; pos, b1, b2
and b_out, which the initialisation sets to zero, 0.05 x normals, so that
a fault that drops one of them shows. h_signed = 0 (h = 1). The list is
``[h_signed] + ar`` in the configuration's type.
"""

from __future__ import annotations

import math

import torch

from bench_gpu.weights import _l2


def ar_shapes(config):
    """The AR leaves' shapes, in checkpoint order."""
    m = config["model"]
    lag, A1 = config["lag"], config["alphabet_size"] + 1
    D, M = m["d_model"], m["mlp_width"]
    return [(A1, D), (lag, D), (3, D, D), (D, D), (D, M), (M,), (M, D), (D,), (D, A1), (A1,)]


def make_params(config, seed: int, device, dtype=torch.float32):
    """``[h_signed] + ar`` drawn from ``seed`` on ``device``."""
    shapes = ar_shapes(config)
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    embed, pos, wqkv, wo, w1, b1, w2, b2, w_out, b_out = (
        t.reshape(s) for t, s in zip(torch.split(flat, sizes), shapes))
    scale = 1.0 / math.sqrt(config["model"]["d_model"])
    ar = [0.05 * _l2(embed, 0), 0.05 * pos, scale * wqkv, scale * wo, scale * w1, 0.05 * b1,
          0.05 * _l2(w2, 0), 0.05 * b2, 0.05 * _l2(w_out, 0), 0.05 * b_out]
    return [torch.zeros((), dtype=dtype, device=device)] + ar
