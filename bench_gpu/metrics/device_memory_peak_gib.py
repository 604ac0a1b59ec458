"""Peak device memory of the run, set-up and window together, in GiB: the
high-water mark of torch's allocator on the run's card, read once the
window has closed. Nothing on the CPU."""

import torch


def read(run):
    if run.device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(run.device) / 2**30
