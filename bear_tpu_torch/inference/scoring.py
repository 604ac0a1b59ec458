"""Model loading for scoring (port of ``load_bear``,
bear_tpu/inference/scoring.py:412-472)."""

from __future__ import annotations

import configparser
import json
import os

import numpy as np
import torch

from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops.distributions import EPSILON
from bear_tpu_torch.utils.checkpoint import load_params_list
from bear_tpu_torch.utils.device import resolve_device


def load_bear(path: str, double_softmax: bool = True, device="cuda"):
    """Load a trained model directory (config.cfg + results.pickle) into a
    scoring-ready ``ar_apply`` (reference get_var_probs.py:59-82).

    double_softmax reproduces the reference's load-time quirk
    (get_var_probs.py:79-82): scoring uses softmax(ar_func(.)) + EPSILON
    even though ar_func already returns probabilities. Pass False for the
    mathematically intended probabilities.

    Returns (lag, alphabet_name, h, ar_apply, info); ar_apply maps one-hot
    contexts [..., lag, A+1] on ``device`` to probabilities [..., A+1].
    """
    dev = resolve_device(device)
    config = configparser.ConfigParser()
    config.read(os.path.join(path, "config.cfg"))
    lag = int(config["hyperp"]["lag"])
    alphabet_name = config["data"]["alphabet"]
    A = alphabets.alphabet_size(alphabet_name)
    dtype = torch.float64 if config["general"]["precision"] == "float64" else torch.float32
    name = config["model"]["ar_func_name"]
    ar = get_ar_func(name, lag, A, json.loads(config["model"]["af_kwargs"]),
                     dtype=dtype, device=dev)
    params_list = load_params_list(path)
    expected = 1 + len(ar.params_list())
    if len(params_list) != expected:
        raise ValueError(
            f"checkpoint at {path!r} holds {len(params_list)} parameter "
            f"arrays but ar_func {name!r} expects {expected} ([h_signed] + "
            "net params); reference-guided (train_bear_ref) model dirs carry "
            "[tau, nu] + net params and cannot be scored via load_bear"
        )
    params = bear_net.params_from_list(params_list, device=dev, dtype=dtype)
    ar.load_params(params["ar"])
    h = float(np.exp(params["h_signed"].cpu().numpy()))
    ar.requires_grad_(False)

    def ar_apply(oh):
        probs = ar(oh)
        if double_softmax:
            probs = torch.softmax(probs, dim=-1)
        return probs + EPSILON

    info = {
        "config": config,
        "params": params,
        "files_path": config["data"]["files_path"],
        "start_token": config["data"]["start_token"],
        "sparse": config["data"]["sparse"] == "True",
        "num_ds": int(config["data"]["num_ds"]),
    }
    return lag, alphabet_name, h, ar_apply, info
