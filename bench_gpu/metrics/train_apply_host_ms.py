"""Host time of one optimizer apply (``bear_net._apply``: the forward and
backward of its batches and Adam's step, as the host enqueues them), the
mean of the traced window's ``bear.train.apply`` spans, in ms."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "bear.train.apply")
