"""Alphabets, codecs, the probability core and the keyed sampler."""

from bear_tpu_torch.ops import alphabets, distributions, keyed_random, loggamma
from bear_tpu_torch.ops.distributions import EPSILON

__all__ = ["alphabets", "distributions", "keyed_random", "loggamma", "EPSILON"]
