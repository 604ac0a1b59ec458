"""The attention AR kernel's share of its roofline: the attention block's
model FLOPs over every window scored in the traced window
(``_work_attention.attention_forward_flops`` a row, the multiply-adds the
kernel makes, two FLOPs each) at 67 TFLOP/s, over the device time of
``attention_forward_kernel`` in the profile, in %. FLOPs bound it: a row's
bytes (its one-hot context in, its probabilities out) take a fiftieth of
that time at 3.35 TB/s. None where the kernel did not run."""

from bench_gpu.metrics import _work, _work_attention


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_seconds("attention_forward_kernel")
    if kernel_s <= 0:
        return None
    flops = _work_attention.attention_forward_flops(run.config) * run.work["windows"]
    return 100.0 * flops / _work.FP32_FLOPS / kernel_s
