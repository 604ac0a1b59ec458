"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    none is available. There is no silent CPU path: a caller that wants the
    plain PyTorch versions passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
