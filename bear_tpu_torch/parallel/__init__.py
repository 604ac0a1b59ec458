"""Counting with the count table split by context rows (port of
bear_tpu/parallel; one card: more than one raises)."""

# The counting package first: its multipass and sparse counters subclass
# KmerShardedTransitionCounter, so importing this package first must not
# reach them while parallel.counting is half defined.
import bear_tpu_torch.counting  # noqa: F401
from bear_tpu_torch.parallel.counting import KmerShardedTransitionCounter

__all__ = ["KmerShardedTransitionCounter"]
