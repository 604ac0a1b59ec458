"""AR functions, BEAR training and evaluation, and the training CLI."""

from bear_tpu_torch.models.ar_funcs import CNNAR, LinearAR, StopAR, get_ar_func

__all__ = ["CNNAR", "LinearAR", "StopAR", "get_ar_func"]
