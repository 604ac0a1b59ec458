"""The port's on-disk workflow end to end on the CPU, the mirror of
tests/test_full_workflow.py::test_summarize_then_train: read files ->
summarize CLI -> count TSV shards -> the streaming training CLI (shard
cache, mid-run checkpoints) -> results -> scoring from the model
directory. The streaming CLI's [results] are held against bear_tpu's CLI
on the same shards from the same initial parameters, in float64, at rtol
1e-8, but for the BMM accuracies: small integer counts tie, and each
package breaks ties with its own generator."""

import configparser
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.models import train_bear_net as jcli
from bear_tpu.utils import checkpoint as jckpt
from bear_tpu_torch.counting import summarize
from bear_tpu_torch.inference import get_bear_probs_seqs
from bear_tpu_torch.models import bear_net, train_bear_net
from bear_tpu_torch.utils import checkpoint

LAG = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(tmp_path):
    rng = np.random.default_rng(11)
    rows = []
    for fi, group in enumerate((0, 0, 0, 1)):
        with open(tmp_path / f"reads_{fi}.fq", "w") as fh:
            for si in range(40):
                seq = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 60))))
                fh.write(f"@r{fi}_{si}\n{seq}\n+\n{'F' * len(seq)}\n")
        rows.append(f"{tmp_path}/reads_{fi}.fq,{group},fq\n")
    (tmp_path / "infiles.csv").write_text("".join(rows))
    return str(tmp_path / "infiles.csv")


def _config(counts_dir, out_folder, init_dir):
    cfg = configparser.ConfigParser()
    cfg.read_dict({
        "general": {"out_folder": str(out_folder) + "*", "seed": "3",
                    "precision": "float64"},
        "data": {"files_path": str(counts_dir), "start_token": f"run_lag_{LAG}",
                 "sparse": "False", "num_ds": "2", "alphabet": "dna", "train_column": "0",
                 "test_column": "1", "reference_column": "0"},
        "hyperp": {"lag": str(LAG)},
        "train": {"train": "True", "epochs": "3", "batch_size": "40",
                  "optimizer_name": "Adam", "learning_rate": "0.01", "train_ar": "False",
                  "accumulation_steps": "2", "cache": "True", "restart": "True",
                  "restart_path": str(init_dir), "streaming": "True", "shuffle": "True",
                  "checkpoint_every": "2"},
        "test": {"test": "True", "train_test": "True", "van_reg": "[0.1, 1.0]"},
        "model": {"ar_func_name": "linear", "af_kwargs": "{}"},
        "results": {},
    })
    return cfg


def test_summarize_then_streaming_train_then_score(tmp_path):
    csv = _reads(tmp_path)
    counts_dir = tmp_path / "counts"
    counts_dir.mkdir()
    report = {}
    summarize.main(summarize.build_parser().parse_args(
        [csv, str(counts_dir / "run"), "-l", str(LAG), "-mf", "0.00002", "--shuffle",
         "--device", "cpu"]), report)
    shards = sorted(f for f in os.listdir(counts_dir) if f.startswith(f"run_lag_{LAG}_"))
    assert len(shards) >= 2
    assert set(report["forward"]["stats"]["parser"].values()) == {"native"}

    jar = jget_ar_func("linear", LAG, 4, dtype=jnp.float64)
    init = tmp_path / "init"
    init.mkdir()
    jckpt.save_results(str(init), jbn.params_to_list(
        jbn.init_params(jax.random.key(2), jar, dtype=jnp.float64)))

    jret = jcli.main(_config(counts_dir, tmp_path / "jax", init))
    port_dir = tmp_path / "port"
    pret = train_bear_net.main(_config(counts_dir, port_dir, init), device="cpu")
    assert pret[0] == jret[0] == 1
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-8)
    np.testing.assert_allclose(pret[2], jret[2], rtol=1e-8)

    want = configparser.ConfigParser()
    want.read(tmp_path / "jax" / "config.cfg")
    got = configparser.ConfigParser()
    got.read(port_dir / "config.cfg")
    keys = set(want["results"]) - {"out_folder", "file"}
    assert keys == set(got["results"]) - {"out_folder", "file"} and len(keys) == 19
    for key in sorted(keys):
        g = np.asarray(json.loads(got["results"][key]))
        w = np.asarray(json.loads(want["results"][key]))
        if key.endswith("accuracy_bmm"):
            assert g.shape == w.shape == (2,) and np.all((g > 0) & (g < 1))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, err_msg=key)

    # The durable result is written, the mid-run state cleared, the cache kept.
    assert os.path.exists(port_dir / "results.pickle")
    assert not os.path.exists(port_dir / checkpoint.TRAIN_STATE_FILE)
    cached = os.listdir(port_dir / "shard_cache")
    assert len(cached) == len(shards) and all(c.endswith(".npz") for c in cached)
    res = checkpoint.load_results(str(port_dir))
    jres = jckpt.load_results(str(tmp_path / "jax"))
    for g, w in zip(res["params"], jres["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-8)
    n_applies = res["torch_opt_state"]["step"]
    assert n_applies > 4

    scores = get_bear_probs_seqs(str(port_dir), ["ACGTACGT", "TTGACCA"], 0, mc_samples=8,
                                 device="cpu")
    assert scores.shape[0] == 2 and np.isfinite(scores).all()


def test_streaming_cli_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """A streaming CLI run killed after a checkpoint, rerun into the same
    out folder, writes the [results] of a run never killed."""
    csv = _reads(tmp_path)
    counts_dir = tmp_path / "counts"
    counts_dir.mkdir()
    summarize.main(summarize.build_parser().parse_args(
        [csv, str(counts_dir / "run"), "-l", str(LAG), "-mf", "0.00002", "--device",
         "cpu"]))
    jar = jget_ar_func("linear", LAG, 4, dtype=jnp.float64)
    init = tmp_path / "init"
    init.mkdir()
    jckpt.save_results(str(init), jbn.params_to_list(
        jbn.init_params(jax.random.key(4), jar, dtype=jnp.float64)))
    train_bear_net.main(_config(counts_dir, tmp_path / "whole", init), device="cpu")
    real = bear_net._save_state

    class Killed(Exception):
        pass

    def dies_after_the_first_save(*args):
        real(*args)
        raise Killed

    monkeypatch.setattr(bear_net, "_save_state", dies_after_the_first_save)
    out = tmp_path / "resumed"
    with pytest.raises(Killed):
        train_bear_net.main(_config(counts_dir, out, init), device="cpu")
    assert os.path.exists(out / checkpoint.TRAIN_STATE_FILE)
    monkeypatch.setattr(bear_net, "_save_state", real)
    train_bear_net.main(_config(counts_dir, out, init), device="cpu")
    a, b = configparser.ConfigParser(), configparser.ConfigParser()
    a.read(tmp_path / "whole" / "config.cfg")
    b.read(out / "config.cfg")
    for key in set(a["results"]) - {"out_folder", "file"}:
        assert a["results"][key] == b["results"][key], key
    assert not os.path.exists(out / checkpoint.TRAIN_STATE_FILE)


def test_entry_points_run_as_modules(tmp_path):
    """The two CLIs through ``python -m`` with ``--device cpu``."""
    csv = _reads(tmp_path)
    counts_dir = tmp_path / "counts"
    counts_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = [sys.executable, "-m", "bear_tpu_torch.counting.summarize", csv,
           str(counts_dir / "run"), "-l", str(LAG), "--shuffle", "--device", "cpu"]
    out = subprocess.run(run, capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "conservation verified" in out.stdout
    check = [sys.executable, "-m", "bear_tpu_torch.counting.check_summarize", csv,
             str(counts_dir / "run"), "-l", str(LAG)]
    out = subprocess.run(check, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.startswith("OK:"), out.stderr
    init = tmp_path / "init"
    init.mkdir()
    jckpt.save_results(str(init), jbn.params_to_list(jbn.init_params(
        jax.random.key(1), jget_ar_func("linear", LAG, 4, dtype=jnp.float64),
        dtype=jnp.float64)))
    cfg = _config(counts_dir, tmp_path / "model", init)
    with open(tmp_path / "streamed.cfg", "w") as fh:
        cfg.write(fh)
    train = [sys.executable, "-m", "bear_tpu_torch.models.train_bear_net",
             str(tmp_path / "streamed.cfg"), "--device", "cpu"]
    out = subprocess.run(train, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    res = configparser.ConfigParser()
    res.read(tmp_path / "model" / "config.cfg")
    assert np.isfinite(float(res["results"]["heldout_perplex_BEAR"]))
    assert (tmp_path / "model" / "shard_cache").is_dir()
