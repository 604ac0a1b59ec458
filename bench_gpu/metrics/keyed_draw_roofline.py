"""keyed_draw's share of its roofline: the least time of the traced
window's draws (the larger of their operations, counted by
``_work.keyed_draw_ops``, at 67 TFLOP/s and their bytes at 3.35 TB/s) over
the device time of ``keyed_draw_kernel`` in the profile, in %."""

from bench_gpu.metrics import _work


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_seconds("keyed_draw_kernel")
    if kernel_s <= 0:
        return None
    p = run.params
    S, n_seq = p["mc_samples"], p["seqs_per_call"]
    calls = len(run.latencies)
    E = run.work["windows"] / calls
    A1 = run.config["alphabet_size"] + 1
    least, _ = _work.least_seconds(_work.keyed_draw_ops(S, E, A1),
                                   _work.keyed_draw_bytes(S, E, A1, n_seq, 4))
    return 100.0 * calls * least / kernel_s
