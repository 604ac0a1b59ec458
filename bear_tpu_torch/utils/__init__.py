"""Model directories, run configs, metrics, profiling and device resolution."""

from bear_tpu_torch.utils.checkpoint import load_params_list, load_results, save_results
from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path
from bear_tpu_torch.utils.metrics import MetricsWriter, save_loss_curve
from bear_tpu_torch.utils.profiling import StageTimer, trace

__all__ = ["MetricsWriter", "RunConfig", "StageTimer", "bundled_ysd1_path",
           "load_params_list", "load_results", "save_results", "save_loss_curve", "trace"]
