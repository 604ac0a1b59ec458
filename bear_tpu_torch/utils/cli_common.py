"""Shared scaffolding of the config-driven training CLI (port of
bear_tpu/utils/cli_common.py): restart loading and results writing."""

from __future__ import annotations

import json
import os

import numpy as np


def load_restart(run):
    """(params_restart, opt_state_restart) from the run's restart config.
    The optimizer state is the port's own (``torch_opt_state``); a
    bear_tpu directory's optax state is not used."""
    if not run.restart:
        return None, None
    from bear_tpu_torch.utils.checkpoint import load_results

    results_prev = load_results(run.restart_path)
    params = [np.asarray(p) for p in results_prev["params"]]
    return params, results_prev.get("torch_opt_state")


def write_eval_results(config, out_folder, prefix, out):
    """Write the 9 evaluation metrics into the config's [results] section
    (the reference's key schema, train_bear_net.py:162-195)."""
    (ll_ear, ll_ar, ll_van, perp_ear, perp_ar, perp_van, acc_ear, acc_ar, acc_van) = out
    res = config["results"]
    res[f"{prefix}perplex_BEAR"] = str(float(perp_ear))
    res[f"{prefix}perplex_AR"] = str(float(perp_ar))
    res[f"{prefix}perplex_BMM"] = json.dumps(np.asarray(perp_van).tolist())
    res[f"{prefix}loglikelihood_BEAR"] = str(float(ll_ear))
    res[f"{prefix}loglikelihood_AR"] = str(float(ll_ar))
    res[f"{prefix}loglikelihood_BMM"] = json.dumps(np.asarray(ll_van).tolist())
    res[f"{prefix}accuracy_BEAR"] = str(float(acc_ear))
    res[f"{prefix}accuracy_AR"] = str(float(acc_ar))
    res[f"{prefix}accuracy_BMM"] = json.dumps(np.asarray(acc_van).tolist())
    write_config(config, out_folder)


def write_config(config, out_folder):
    with open(os.path.join(out_folder, "config.cfg"), "w") as cw:
        config.write(cw)
