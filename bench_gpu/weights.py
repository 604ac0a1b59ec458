"""Seeded starting weights of a configuration, made on the device.

One ``torch.Generator`` on the run's device, seeded with the run's seed,
draws every normal in one call; the leaves take the AR function's
initialisation (l2-normalised normals; ones for scales and the first two
intercepts, zeros for the head's) and h_signed = 0 (h = 1). The list is in
checkpoint order, ``[h_signed] + ar``, in the configuration's type.
"""

from __future__ import annotations

import math

import torch


def ar_shapes(config):
    """The AR leaves' shapes, in checkpoint order."""
    m = config["model"]
    lag, A1 = config["lag"], config["alphabet_size"] + 1
    if m["ar_func"] == "linear":
        return [(lag, A1, A1)]
    fw, nf, w1 = m["filter_width"], m["num_filters"], m["kmer_layer1_width"]
    cl = lag - fw + 1
    return [(fw, A1, nf), (cl, nf), (cl, nf, w1), (w1,), (w1, A1), (A1,), (cl, nf), (w1,)]


def _l2(x, dims):
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dims, keepdim=True), min=1e-24))


def make_params(config, seed: int, device, dtype=torch.float32):
    """``[h_signed] + ar`` drawn from ``seed`` on ``device``."""
    shapes = ar_shapes(config)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    if config["model"]["ar_func"] == "linear":
        drawn = [shapes[0]]
    else:
        drawn = [shapes[0], shapes[2], shapes[4]]
    flat = torch.randn(sum(math.prod(s) for s in drawn), generator=gen, dtype=dtype,
                       device=device)
    normals = [t.reshape(s) for t, s in zip(torch.split(flat, [math.prod(s) for s in drawn]),
                                           drawn)]
    h_signed = torch.zeros((), dtype=dtype, device=device)
    if config["model"]["ar_func"] == "linear":
        return [h_signed, 0.05 * _l2(normals[0], 1)]
    filters, weights1, weights2 = normals
    ones = dict(dtype=dtype, device=device)
    return [h_signed, _l2(filters, (0, 1)), torch.ones(shapes[1], **ones), _l2(weights1, 0),
            torch.ones(shapes[3], **ones), 0.05 * _l2(weights2, 0),
            torch.zeros(shapes[5], **ones), torch.ones(shapes[6], **ones),
            torch.ones(shapes[7], **ones)]
