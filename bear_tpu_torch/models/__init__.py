"""AR functions and BEAR parameters."""

from bear_tpu_torch.models.ar_funcs import LinearAR, get_ar_func

__all__ = ["LinearAR", "get_ar_func"]
