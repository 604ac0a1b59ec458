"""The training step's share of the card's float32 peak: the CNN's model
FLOPs (forward, and backward at twice the forward) over the real rows of
every apply of the traced window, over the window's time and 67 TFLOP/s,
in %."""

from bench_gpu.metrics import _work


def read(run):
    if run.trace is None or run.config["model"]["ar_func"] != "cnn":
        return None
    flops = 3 * _work.cnn_forward_flops(run.config) * run.work["rows"]
    return 100.0 * flops / run.window_s / _work.FP32_FLOPS
