"""count_chunk's share of its roofline: the least time of the traced
window's launches, (B L + 16 B + 2 x 32 S) bytes at 3.35 TB/s with S the
distinct 32-byte table sectors each chunk's keys touch, over the device
time of ``count_chunk_kernel`` in the profile, in %."""

from bench_gpu.metrics import _work


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_seconds("count_chunk_kernel")
    if kernel_s <= 0:
        return None
    d = run.driver
    nbytes = run.work["passes"] * _work.count_chunk_bytes(d.launch_rows, d.read_len,
                                                         d.sector_count())
    return 100.0 * nbytes / _work.HBM_BYTES_PER_S / kernel_s
