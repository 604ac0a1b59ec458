"""Host time a scoring call spends where the host reads the card (the
mask's ``nonzero`` and the copy of the result to the host): the traced
window's ``bear.score.mask`` and ``bear.score.copy_out`` spans summed,
over its ``bear.score.call`` spans, in ms."""

from bench_gpu.metrics import _spans


def read(run):
    recs = _spans.records(run)
    calls = len(_spans.durations_ms(recs, "bear.score.call"))
    if not calls:
        return None
    waits = (_spans.durations_ms(recs, "bear.score.mask")
             + _spans.durations_ms(recs, "bear.score.copy_out"))
    return sum(waits) / calls
