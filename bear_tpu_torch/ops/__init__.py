"""Alphabets, codecs and probability constants."""

from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops.distributions import EPSILON

__all__ = ["alphabets", "EPSILON"]
