"""Model directories (port of bear_tpu/utils/checkpoint.py, without the
mid-run train state).

A model directory holds ``config.cfg`` + ``results.pickle`` with the
reference's ``{'params': [...]}`` schema, the params as plain numpy arrays
in the order ``[h_signed] + ar``. Directories of the two packages are
interchangeable for their params:

- the port writes its optimizer state beside them under
  ``torch_opt_state`` (plain numpy, see ``bear_net.optimizer_state``);
- bear_tpu writes its optax state under ``opt_state``, which cannot be
  rebuilt without optax. When the port loads such a pickle, the classes of
  jax, optax and bear_tpu are replaced by inert stand-ins (nothing of them
  is imported), so the params load and that optimizer state is not used.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import List, Optional

import numpy as np

# Packages the port never imports, not even to unpickle their classes.
_FOREIGN = ("jax", "jaxlib", "optax", "bear_tpu")


class ForeignObject:
    """Stands in for an unpickled object of a class of a foreign package;
    keeps the arguments and state it was built from."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if any(module == f or module.startswith(f + ".") for f in _FOREIGN):
            return type(name, (ForeignObject,), {"__module__": module})
        return super().find_class(module, name)


def save_results(out_folder: str, params_list: List[np.ndarray],
                 extra: Optional[dict] = None) -> str:
    """Write results.pickle with the reference's {'params': [...]} schema,
    plus ``extra`` keys, by atomic replace."""
    payload = {"params": [np.asarray(p) for p in params_list]}
    if extra:
        payload.update(extra)
    path = os.path.join(out_folder, "results.pickle")
    # A crash mid-dump must not destroy the previous file (open('wb')
    # truncates at once); the temporary name is unique per process.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            pickle.dump(payload, fh)
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
    return path


def load_results(path_or_dir: str) -> dict:
    """Load a results.pickle (path to the file or its directory). Unpickling
    runs code: load only model directories this project wrote."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "results.pickle")
    with open(path, "rb") as fh:
        return _Unpickler(fh).load()


def load_params_list(path_or_dir: str) -> List[np.ndarray]:
    results = load_results(path_or_dir)
    return [np.asarray(p) for p in results["params"]]
