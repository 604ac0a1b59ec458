"""Host time of filling one chunk's pinned staging buffers (their growth,
the copy of the codes and the packing of the row meta), the mean of the
traced window's ``bear.count.stage`` spans, in ms. None off the card,
where a chunk is not staged."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "bear.count.stage")
