"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import functools

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


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (the kernels' launch
    shapes are sized by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
