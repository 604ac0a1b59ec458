"""Scalar metrics writer and loss curve (port of bear_tpu/utils/metrics.py).

Scalars go to a JSONL file. bear_tpu's optional TensorBoard tee is not
ported.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Append-only scalars.jsonl writer with the ``scalar(tag, value, step)``
    interface of bear_net.train."""

    def __init__(self, out_folder: str, filename: str = "scalars.jsonl"):
        os.makedirs(out_folder, exist_ok=True)
        self.path = os.path.join(out_folder, filename)
        self._fh = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int):
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step), "time": time.time()}) + "\n")

    def close(self):
        # Idempotent: the CLI closes after training and again in a finally.
        self._fh.close()


def save_loss_curve(losses, out_folder: str, filename: str = "loss.png"):
    """Loss-curve png (reference train_bear_net.py:128-134); returns None
    without writing when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.figure(figsize=[10, 10])
    plt.xlabel("steps", fontsize=30)
    plt.ylabel("loss", fontsize=30)
    plt.plot(losses)
    plt.tight_layout()
    path = os.path.join(out_folder, filename)
    plt.savefig(path, dpi=200)
    plt.close()
    return path
