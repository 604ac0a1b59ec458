"""Scalar metrics writer and loss curve (port of bear_tpu/utils/metrics.py).

Scalars always go to a JSONL file. TensorBoard event files are written
beside it, under ``tb/``, when asked for: ``tensorboard=True``, or the
environment's ``BEAR_TPU_TENSORBOARD=1`` (torch's ``SummaryWriter``,
imported only then; where it does not import, the JSONL file is still
written).
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Append-only scalars.jsonl writer with the ``scalar(tag, value, step)``
    interface of bear_net.train; optionally teed to TensorBoard."""

    def __init__(self, out_folder: str, filename: str = "scalars.jsonl",
                 tensorboard: bool | None = None):
        os.makedirs(out_folder, exist_ok=True)
        self.path = os.path.join(out_folder, filename)
        self._fh = open(self.path, "a")
        if tensorboard is None:
            tensorboard = os.environ.get("BEAR_TPU_TENSORBOARD", "") == "1"
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is absent: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(out_folder, "tb"))

    def scalar(self, tag: str, value: float, step: int):
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step), "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        self._fh.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        # Idempotent: the CLIs close after training and again in a finally.
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None


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
