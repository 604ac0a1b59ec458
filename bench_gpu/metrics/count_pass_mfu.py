"""A counting pass's share of the card's peak: the least time of the
traced window's count_chunk launches (their bytes at 3.35 TB/s, the bound
of counting, whose operations are few) over the window's time, in %."""

from bench_gpu.metrics import _work


def read(run):
    if run.trace is None:
        return None
    d = run.driver
    nbytes = run.work["passes"] * _work.count_chunk_bytes(d.launch_rows, d.read_len,
                                                         d.sector_count())
    return 100.0 * nbytes / _work.HBM_BYTES_PER_S / run.window_s
