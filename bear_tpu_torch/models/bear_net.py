"""BEAR parameters (port of the checkpoint contract of
bear_tpu/models/bear_net.py:78-90).

Parameters are ``{"h_signed": scalar tensor, "ar": [tensors]}``; the
checkpoint list is ``[h_signed] + ar`` (reference bear_net.py:99), h = exp
(h_signed). Training and evaluation follow with the training slice.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def params_to_list(params) -> List[np.ndarray]:
    """Flatten to the checkpoint order [h_signed] + ar, as numpy arrays."""
    return [params["h_signed"].detach().cpu().numpy()] + [
        p.detach().cpu().numpy() for p in params["ar"]
    ]


def params_from_list(lst, device="cuda", dtype=torch.float32):
    """Inverse of params_to_list: a ``[h_signed] + ar`` list of numpy arrays
    (bear_tpu's ``params_to_list``, or a results.pickle) -> tensors on
    ``device`` (copies: the arrays may be read-only)."""
    return {
        "h_signed": torch.tensor(np.asarray(lst[0]), dtype=dtype, device=device),
        "ar": [torch.tensor(np.asarray(p), dtype=dtype, device=device)
               for p in lst[1:]],
    }
