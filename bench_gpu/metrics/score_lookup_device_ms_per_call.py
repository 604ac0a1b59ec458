"""Device time of the sparse map's binary search a scoring call: the
traced window's device seconds of ATen's ``searchsorted`` kernel, over the
window's calls, in ms. None untraced, and where no such kernel ran (a
dense table's gather searches nothing)."""

KERNEL = "searchsorted"


def read(run):
    if run.trace is None or not run.latencies:
        return None
    kernel_s = run.trace.kernel_seconds(KERNEL)
    if kernel_s <= 0:
        return None
    return 1e3 * kernel_s / len(run.latencies)
