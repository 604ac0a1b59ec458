"""Config-driven training and evaluation of reference-guided BEAR/AR models
(port of bear_tpu/models/train_bear_ref.py).

    python -m bear_tpu_torch.models.train_bear_ref config.cfg [--device cpu]

The same config files as the training CLI, plus ``[data]
reference_column``: trains the mixture of ``[model] ar_func_name``'s net
with the Jukes-Cantor-smoothed reference column, then writes ``h``,
``error_rate`` and ``stop_rate`` and the evaluation metrics into the out
folder's config.cfg [results] section, beside results.pickle (whose
parameters are ``[h_signed, tau_signed, net_weight_signed] + net``). With
``[train] streaming = True`` training and evaluation read one count file at
a time, as the training CLI does.
"""

from __future__ import annotations

import argparse
import configparser
import os

import numpy as np

from bear_tpu_torch.data import count_kmers, load_files, load_files_cached
from bear_tpu_torch.models import bear_net, bear_ref
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils.checkpoint import clear_train_state, save_results
from bear_tpu_torch.utils.cli_common import load_restart, write_config, write_eval_results
from bear_tpu_torch.utils.config import RunConfig
from bear_tpu_torch.utils.device import resolve_device
from bear_tpu_torch.utils.metrics import MetricsWriter, save_loss_curve


def main(config: configparser.ConfigParser, device="cuda"):
    """Run reference-guided training + evaluation from a parsed config on
    ``device``. Returns 1, or (1, ll_van, perp_van) when train_test is
    enabled (the reference's contract)."""
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
    ds = None if run.streaming else load_files(files, run.alphabet, run.num_ds,
                                               sparse=run.sparse)
    print("data_loaded")
    shard_cache = os.path.join(out_folder, "shard_cache") if run.cache else None

    def load_shard(f):
        return load_files_cached([f], run.alphabet, run.num_ds, sparse=run.sparse,
                                 cache_dir=shard_cache)

    def eval_shards():
        for f in files:
            d = load_shard(f)
            yield d.codes, d.counts

    config["results"]["out_folder"] = out_folder
    config["results"]["file"] = os.path.join(out_folder, "results.pickle")
    write_config(config, out_folder)

    ds_loc, ds_loc_ref = run.train_column, run.reference_column
    A = alphabets.alphabet_size(run.alphabet)
    ar_func = bear_ref.make_ref_ar(run.ar_func_name, run.lag, A, run.af_kwargs, dtype=dtype,
                                   device=dev)
    params_restart, opt_state_restart = load_restart(run)
    ckpt = (dict(checkpoint_dir=out_folder, checkpoint_every=run.checkpoint_every)
            if run.checkpoint_every > 0 else {})
    kw = dict(alphabet=run.alphabet, lag=run.lag, dtype=dtype, batch_size=batch_size,
              epochs=epochs, learning_rate=run.learning_rate,
              optimizer_name=run.optimizer_name, train_ar=run.train_ar,
              acc_steps=run.accumulation_steps, params_restart=params_restart,
              opt_state_restart=opt_state_restart, seed=run.seed, shuffle=run.shuffle,
              writer=writer, device=dev, **ckpt)

    if run.train and run.streaming:
        def shards(epoch=0):
            order = list(range(len(files)))
            if run.shuffle:
                np.random.default_rng([run.seed, epoch]).shuffle(order)
            for fi in order:
                d = load_shard(files[fi])
                yield d.codes, d.counts[:, ds_loc], d.counts[:, ds_loc_ref]

        result = bear_ref.train_streaming(shards, num_kmers, run.ar_func_name, run.af_kwargs,
                                          **kw)
    elif run.train:
        result = bear_ref.train(ds.codes, ds.counts[:, ds_loc], ds.counts[:, ds_loc_ref],
                                num_kmers, run.ar_func_name, run.af_kwargs, **kw)
    else:
        if not run.restart:
            raise ValueError("train=False requires restart=True")
        result = None
        params = bear_net.params_from_list(params_restart, device=dev, dtype=dtype)
        opt_state = opt_state_restart
    if result is not None:
        writer.close()
        params, opt_state = result.params, result.opt_state
        save_loss_curve(result.elbos, out_folder)

    params_list = bear_net.params_to_list(params)
    h = float(np.exp(params_list[0]))
    config["results"]["h"] = str(h)
    config["results"]["error_rate"] = str(bear_ref.error_rate(params))
    config["results"]["stop_rate"] = str(bear_ref.stop_rate_inverse(params))
    write_config(config, out_folder)
    save_results(out_folder, params_list, extra={"torch_opt_state": opt_state})
    if run.checkpoint_every > 0:
        clear_train_state(out_folder)

    van_reg = np.array(run.van_reg)

    def _evaluate(train_loc, test_loc):
        if run.streaming:
            return bear_ref.evaluation_streaming(
                eval_shards, train_loc, test_loc, ds_loc_ref, run.alphabet, h, ar_func,
                params["ar"], van_reg, dtype=dtype, seed=run.seed, device=dev)
        return bear_ref.evaluation(
            ds.codes, ds.counts, train_loc, test_loc, ds_loc_ref, run.alphabet, h, ar_func,
            params["ar"], van_reg, dtype=dtype, seed=run.seed, device=dev)

    if run.test:
        write_eval_results(config, out_folder, "heldout_", _evaluate(ds_loc, run.test_column))

    if run.train_test:
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
