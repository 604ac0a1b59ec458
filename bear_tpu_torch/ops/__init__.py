"""Alphabets, codecs and the probability core."""

from bear_tpu_torch.ops import alphabets, distributions
from bear_tpu_torch.ops.distributions import EPSILON

__all__ = ["alphabets", "distributions", "EPSILON"]
