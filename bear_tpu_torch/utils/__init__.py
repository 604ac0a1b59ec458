"""Model directories, run configs, metrics, profiling and device resolution."""

from bear_tpu_torch.utils.metrics import MetricsWriter, save_loss_curve
from bear_tpu_torch.utils.profiling import StageTimer, trace
