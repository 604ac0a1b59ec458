"""The attention scoring calls' share of the card's float32 peak: the
attention AR's model FLOPs (``_work_attention.attention_forward_flops``, a
row) over every window (transition) scored in the traced window, over the
window's time and 67 TFLOP/s, in %."""

from bench_gpu.metrics import _work, _work_attention


def read(run):
    if run.trace is None:
        return None
    flops = _work_attention.attention_forward_flops(run.config) * run.work["windows"]
    return 100.0 * flops / run.window_s / _work.FP32_FLOPS
