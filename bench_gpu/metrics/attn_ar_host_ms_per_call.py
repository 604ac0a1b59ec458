"""Host time of the attention AR in one scoring call: the traced window's
``bear.ar.attention`` spans (one an AR slice) summed, over its
``bear.score.call`` spans, in ms. None where the program records no such
span."""

from bench_gpu.metrics import _spans


def read(run):
    recs = _spans.records(run)
    calls = len(_spans.durations_ms(recs, "bear.score.call"))
    blocks = _spans.durations_ms(recs, "bear.ar.attention")
    if not calls or not blocks:
        return None
    return sum(blocks) / calls
