"""Host time of the encoding of one scoring call's reads
(``BearServer._encode_ragged``), the mean of the traced window's
``bear.score.encode`` spans, in ms."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "bear.score.encode")
