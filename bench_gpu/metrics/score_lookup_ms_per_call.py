"""Host time a scoring call spends in its sparse map's lookup: the traced
window's ``bear.score.lookup`` spans (one an AR slice) summed, over its
``bear.score.call`` spans, in ms. None where the program recorded no such
span (a dense table, or a program without the sparse form)."""

from bench_gpu.metrics import _spans


def read(run):
    recs = _spans.records(run)
    calls = len(_spans.durations_ms(recs, "bear.score.call"))
    lookups = _spans.durations_ms(recs, "bear.score.lookup")
    if not calls or not lookups:
        return None
    return sum(lookups) / calls
