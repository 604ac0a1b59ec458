"""Config-driven training and evaluation of BEAR and AR models (port of the
in-memory path of bear_tpu/models/train_bear_net.py).

    python -m bear_tpu_torch.models.train_bear_net config.cfg [--device cpu]

Reads the reference's INI config (see bear_tpu_torch/utils/config.py),
trains by empirical Bayes (BEAR) or maximum likelihood (AR) on the card,
evaluates held-out and train-as-test metrics, and writes them into the out
folder's config.cfg [results] section, beside results.pickle (the
reference's output contract, train_bear_net.py:141-198).
"""

from __future__ import annotations

import argparse
import configparser
import os

import numpy as np

from bear_tpu_torch.data import count_kmers, load_files
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils.checkpoint import save_results
from bear_tpu_torch.utils.cli_common import load_restart, write_config, write_eval_results
from bear_tpu_torch.utils.config import RunConfig
from bear_tpu_torch.utils.device import resolve_device
from bear_tpu_torch.utils.metrics import MetricsWriter, save_loss_curve


def main(config: configparser.ConfigParser, device="cuda"):
    """Run training + evaluation from a parsed config on ``device``.

    Returns 1, or (1, ll_van, perp_van) when train_test is enabled (the
    reference's contract, train_bear_net.py:198-200)."""
    run = RunConfig.from_configparser(config)
    dev = resolve_device(device)
    out_folder = run.resolve_out_folder()
    writer = MetricsWriter(out_folder)
    try:
        return _main(config, run, out_folder, dev, writer)
    finally:
        writer.close()


def _main(config, run, out_folder, dev, writer):
    dtype = run.dtype()
    files = run.resolve_files()
    num_kmers = count_kmers(files, header=run.sparse)
    batch_size = run.resolve_batch_size(num_kmers)
    epochs = run.resolve_epochs(num_kmers, batch_size)
    ds = load_files(files, run.alphabet, run.num_ds, sparse=run.sparse)
    print("data_loaded")

    # Record the result location in the config (reference
    # train_bear_net.py:90-95).
    config["results"]["out_folder"] = out_folder
    config["results"]["file"] = os.path.join(out_folder, "results.pickle")
    write_config(config, out_folder)

    ds_loc = run.train_column
    ar_func = get_ar_func(run.ar_func_name, run.lag, alphabets.alphabet_size(run.alphabet),
                          run.af_kwargs, dtype=dtype, device=dev)
    params_restart, opt_state_restart = load_restart(run)

    if run.train:
        result = bear_net.train(
            ds.codes, ds.counts[:, ds_loc], num_kmers=num_kmers, ar_func=ar_func,
            batch_size=batch_size, epochs=epochs, learning_rate=run.learning_rate,
            optimizer_name=run.optimizer_name, train_ar=run.train_ar,
            acc_steps=run.accumulation_steps, params_restart=params_restart,
            opt_state_restart=opt_state_restart, seed=run.seed, dtype=dtype,
            shuffle=run.shuffle, writer=writer, device=dev,
        )
        writer.close()
        params, opt_state = result.params, result.opt_state
        save_loss_curve(result.elbos, out_folder)
    else:
        if not run.restart:
            raise ValueError("train=False requires restart=True")
        params = bear_net.params_from_list(params_restart, device=dev, dtype=dtype)
        opt_state = opt_state_restart

    params_list = bear_net.params_to_list(params)
    h = float(np.exp(params_list[0]))
    config["results"]["h"] = str(h)
    write_config(config, out_folder)
    save_results(out_folder, params_list, extra={"torch_opt_state": opt_state})

    van_reg = np.array(run.van_reg)

    def _evaluate(train_loc, test_loc):
        return bear_net.evaluation(
            ds.codes, ds.counts, train_loc, test_loc, run.alphabet, h, ar_func,
            params["ar"], van_reg, dtype=dtype, seed=run.seed, device=dev,
        )

    if run.test:
        write_eval_results(config, out_folder, "heldout_", _evaluate(ds_loc, run.test_column))

    if run.train_test:
        # The training data under prior-only conditioning (reference
        # train_bear_net.py:174-198; ds_loc_train=-1).
        out = _evaluate(-1, ds_loc)
        write_eval_results(config, out_folder, "", out)
        return 1, np.asarray(out[2]), np.asarray(out[5])
    return 1


def cli():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("configPath")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args()

    _, config = RunConfig.read(args.configPath)
    main(config, device=args.device)


if __name__ == "__main__":
    cli()
