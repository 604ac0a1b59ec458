"""Host time of one ``TransitionCounter.add_chunk`` call (staging, the
uploads and the launch), the mean of the traced window's
``bear.count.add_chunk`` spans, in ms: the program's own span, inside the
benchmark's span that ``count_feed_ms_per_chunk`` reads."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "bear.count.add_chunk")
