"""Model loading and MAP sequence scoring."""

from bear_tpu_torch.inference.scoring import load_bear
from bear_tpu_torch.inference.serving import BearServer

__all__ = ["BearServer", "load_bear"]
