"""95th percentile of the latency of every scoring call of the window
(linear interpolation between order statistics), in ms."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
