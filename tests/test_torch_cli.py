"""The port's training CLI (bear_tpu_torch.models.train_bear_net) against
bear_tpu's, on the CPU in float64, and the model directories of the two
packages read by each other.

Both CLIs run bear_test.cfg (epochs = 50) from the same bear_tpu-initialised
results.pickle (params only). Tolerances: every [results] value rtol 1e-8,
except the train-as-test BMM accuracy: in prior mode all five letters tie,
each package draws its pick with its own generator, and the value is held
to be one letter's share of the transitions; results.pickle params rtol
1e-8.

The slow test runs the published YSD1 protocol (bear_lin_bear.cfg: linear
BEAR, lag 5, 10,000 applies) on the port in float64.
"""

import configparser
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.inference import scoring as jscoring
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.models import train_bear_net as jcli
from bear_tpu.utils import checkpoint as jckpt
from bear_tpu.utils import config as jconfig
from bear_tpu_torch.counting import summarize
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.inference.scoring import load_bear
from bear_tpu_torch.models import train_bear_net
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "bear_tpu", "models", "config_files")


def _config(name, out_folder, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, name))
    cfg["general"]["out_folder"] = str(out_folder) + "*"
    for key, value in overrides.items():
        section, option = key.split("__")
        cfg[section][option] = str(value)
    return cfg


def _init_dir(tmp_path, seed=7):
    jar = jget_ar_func("linear", 5, 4, dtype=jnp.float64)
    params = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    d = tmp_path / "init"
    d.mkdir()
    jckpt.save_results(str(d), params)
    return d


@pytest.mark.parametrize("train_ar", [True, False])
def test_cli_results_match_bear_tpu(tmp_path, train_ar):
    init = _init_dir(tmp_path)
    kw = dict(train__epochs=50, train__train_ar=train_ar, train__restart=True,
              train__restart_path=init)
    jcfg = _config("bear_test.cfg", tmp_path / "jax", **kw)
    pcfg = _config("bear_test.cfg", tmp_path / "port", **kw)
    jret = jcli.main(jcfg)
    pret = train_bear_net.main(pcfg, device="cpu")
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-8)
    np.testing.assert_allclose(pret[2], jret[2], rtol=1e-8)

    want = configparser.ConfigParser()
    want.read(tmp_path / "jax" / "config.cfg")
    got = configparser.ConfigParser()
    got.read(tmp_path / "port" / "config.cfg")
    ysd1 = load_dense(bundled_ysd1_path(), "dna", 3).counts[:, 0]
    letter_shares = ysd1.sum(0) / ysd1.sum()
    keys = set(want["results"]) - {"out_folder", "file"}
    assert keys == set(got["results"]) - {"out_folder", "file"} and len(keys) == 19
    for key in sorted(keys):
        g = np.asarray(json.loads(got["results"][key]))
        w = np.asarray(json.loads(want["results"][key]))
        if key == "accuracy_bmm":
            # Prior mode: all five letters tie, so each prior picks one
            # letter for the whole batch, and its accuracy is that letter's
            # share of the transitions.
            assert g.shape == w.shape == (3,)
            assert all(np.isclose(letter_shares, x, rtol=1e-12).any() for x in g)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, err_msg=key)
    if train_ar:
        assert float(got["results"]["h"]) == 1.0

    jres = jckpt.load_results(str(tmp_path / "jax"))
    pres = checkpoint.load_results(str(tmp_path / "port"))
    for g, w in zip(pres["params"], jres["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-8)
    assert pres["torch_opt_state"]["name"] == "adam"
    assert pres["torch_opt_state"]["step"] == 50
    assert os.path.exists(tmp_path / "port" / "scalars.jsonl")


def test_model_dirs_load_in_both_packages(tmp_path):
    init = _init_dir(tmp_path, seed=8)
    kw = dict(train__epochs=3, train__train_ar=False, train__restart=True,
              train__restart_path=init)
    jcli.main(_config("bear_test.cfg", tmp_path / "jax", **kw))
    train_bear_net.main(_config("bear_test.cfg", tmp_path / "port", **kw), device="cpu")
    codes = np.random.default_rng(0).integers(0, 5, size=(40, 5)).astype(np.int8)
    oh = np.asarray(alphabets.one_hot(codes, 5, torch.float64))
    for writer in ("jax", "port"):
        d = str(tmp_path / writer)
        lag, alph, h, ar_apply, _ = load_bear(d, device="cpu")
        jlag, jalph, jh, jar_apply, _ = jscoring.load_bear(d)
        assert (lag, alph) == (jlag, jalph) == (5, "dna")
        assert h == pytest.approx(jh, rel=1e-15)
        np.testing.assert_allclose(ar_apply(torch.tensor(oh)).numpy(),
                                   np.asarray(jar_apply(jnp.asarray(oh))), rtol=1e-12)
    # A bear_tpu directory carries optax state: the port reads its params
    # without importing optax, and starts its own optimizer state afresh.
    raw = checkpoint.load_results(str(tmp_path / "jax"))
    assert isinstance(raw["opt_state"], (tuple, list))
    assert type(raw["opt_state"][0]).__module__.startswith("optax")
    assert isinstance(raw["opt_state"][0], checkpoint.ForeignObject)


def test_eval_only_restart_and_refusals(tmp_path):
    init = _init_dir(tmp_path, seed=9)
    cfg = _config("bear_test.cfg", tmp_path / "eval", train__train="False",
                  train__restart=True, train__restart_path=init)
    jcfg = _config("bear_test.cfg", tmp_path / "jeval", train__train="False",
                   train__restart=True, train__restart_path=init)
    got = train_bear_net.main(cfg, device="cpu")
    want = jcli.main(jcfg)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-10)
    # data_parallel is ported: the config reads it as bear_tpu's does, and
    # the eval-only run over a data-parallel mesh gives the same results
    dp_cfg = _config("bear_test.cfg", tmp_path, train__data_parallel="True")
    assert RunConfig.from_configparser(dp_cfg).data_parallel
    assert jconfig.RunConfig.from_configparser(dp_cfg).data_parallel
    dp = train_bear_net.main(_config("bear_test.cfg", tmp_path / "dp", train__train="False",
                                     train__restart=True, train__restart_path=init,
                                     train__data_parallel="True"), device="cpu")
    np.testing.assert_allclose(dp[2], want[2], rtol=1e-10)
    # compute_precision is ported: the config reads it as bear_tpu's does.
    bf16 = RunConfig.from_configparser(_config("bear_test.cfg", tmp_path,
                                               model__compute_precision="bfloat16"))
    assert bf16.compute_precision == "bfloat16" and bf16.compute_dtype() == torch.bfloat16
    run = RunConfig.from_configparser(_config(
        "bear_test.cfg", tmp_path, train__streaming="True", train__checkpoint_every="10",
        train__cache="False"))
    assert run.streaming and run.checkpoint_every == 10 and not run.cache
    reads = tmp_path / "reads.fa"
    reads.write_text(">r\nACGTACGT\n")
    (tmp_path / "in.csv").write_text(f"{reads},0,fa\n")
    parser = summarize.build_parser()
    # ported: they count (--kmer-shards on a mesh of the CPU)
    for extra in (["--kmer-shards", "2"], ["--passes", "2"], ["-l", "16"]):
        args = parser.parse_args([str(tmp_path / "in.csv"), str(tmp_path / "run"), *extra,
                                  "--device", "cpu"])
        assert summarize.main(args) == (1, None)
    assert len((tmp_path / "run_lag_16_file_0.tsv").read_text().splitlines()) == 9
    # The shipped attention config trains in the port's CLI as in bear_tpu's
    # (the same BMM column; tests/test_torch_attention.py holds the rest).
    attn_kw = dict(data__files_path="TEST", train__epochs=2,
                   model__af_kwargs='{"d_model": 8, "num_heads": 2, "mlp_width": 8}')
    got = train_bear_net.main(_config("bear_attn_bear.cfg", tmp_path / "attn", **attn_kw),
                              device="cpu")
    want = jcli.main(_config("bear_attn_bear.cfg", tmp_path / "jattn", **attn_kw))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bear_net.main(_config("bear_test.cfg", tmp_path / "card"))


def test_chip_smoke_runs_the_published_ysd1_protocol():
    """chip_smoke.py's YSD1 config holds bear_lin_bear.cfg's values, bar
    the precision (float32 on the card) and where data and output live."""
    want = configparser.ConfigParser()
    want.read(os.path.join(CONFIGS, "bear_lin_bear.cfg"))
    got = chip_smoke.ysd1_config("/nowhere")
    moved = {("general", "precision"), ("general", "out_folder"),
             ("data", "files_path"), ("data", "start_token")}
    for section in want.sections():
        for key, value in want[section].items():
            if (section, key) not in moved:
                assert got[section][key] == value, (section, key)
    assert got["general"]["precision"] == "float32"
    assert got["data"]["files_path"] == "TEST"
    run = RunConfig.from_configparser(got)
    assert run.resolve_epochs(1365, run.resolve_batch_size(1365)) == 10_000


@pytest.mark.slow
def test_ysd1_published_protocol_float64(tmp_path):
    cfg = chip_smoke.ysd1_config(str(tmp_path) + "*")
    cfg["general"]["precision"] = "float64"
    train_bear_net.main(cfg, device="cpu")
    res = configparser.ConfigParser()
    res.read(tmp_path / "config.cfg")
    r = res["results"]
    assert abs(float(r["h"]) / 0.04326 - 1) < 0.005
    bmm = json.loads(r["heldout_perplex_BMM"])
    assert abs(bmm[1] - 3.7907) < 1e-4  # van_reg 1.0
    assert abs(float(r["heldout_perplex_BEAR"]) - 3.79) < 0.005
