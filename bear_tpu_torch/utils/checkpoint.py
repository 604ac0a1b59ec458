"""Checkpoint read side (port of bear_tpu/utils/checkpoint.py).

A model directory holds ``config.cfg`` + ``results.pickle`` with the
reference's ``{'params': [...]}`` schema, the params as plain numpy arrays
in the order ``[h_signed] + ar``. Directories written by bear_tpu's
trainers load here unchanged.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np


def load_results(path_or_dir: str) -> dict:
    """Load a results.pickle (path to the file or its directory). Unpickling
    runs code: load only model directories this project wrote."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "results.pickle")
    with open(path, "rb") as fh:
        return pickle.load(fh)


def load_params_list(path_or_dir: str) -> List[np.ndarray]:
    results = load_results(path_or_dir)
    return [np.asarray(p) for p in results["params"]]
