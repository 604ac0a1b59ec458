"""Host time spent waiting, before one chunk is staged, for the copies
that last read its staging buffers, the mean of the traced window's
``bear.count.stage_wait`` spans, in ms. None off the card, where a chunk
is not staged."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "bear.count.stage_wait")
