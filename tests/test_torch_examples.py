"""The port's three example programs (examples/torch_*.py) on the CPU,
against bear_tpu.

- torch_genome_lag13 at a small size in-process: its on-device handoff
  equals bear_tpu's TransitionCounter.to_dataset on the identical reads
  exactly, and bear_tpu's evaluation of the example's trained CNN (its h
  and parameters carried across as numpy) gives the example's perplexities
  and accuracies at rtol 1e-5 (float32 sums in both). The two trainings
  start from different draws, so trained outputs are compared, never two
  trainings.
- torch_multihost_counting over two gloo processes: exit 0, the --bench
  line's keys (tests/test_multihost.py's), and every rank's merged per-lag
  totals equal bear_tpu's one-process count of the same files.
- torch_multihost_train over two gloo processes (slow, as bear_tpu's): exit
  0, the ranks' h bit-equal, and its k-mer count equal to bear_tpu's count
  of the same files.

The multi-process runs retry once: the coordinator port is probed free and
then released, so a concurrently started group can take it first.
"""

import ast
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.torch_genome_lag13 as genome
import examples.torch_multihost_counting as mh_count
from bear_tpu.counting import ReadChunk as JReadChunk
from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting.summarize import iter_chunks as jiter_chunks
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(sys.platform != "linux", reason="process tests, linux only")


@pytest.fixture
def two_threads(monkeypatch):
    # Worker processes inherit the environment: torch reads the cap at start.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _bear_tpu_count(csv, lags):
    """bear_tpu's one-process count of a FILE,GROUP,TYPE csv."""
    entries = jfastx.read_input_csv(csv)
    n_groups = max(g for _, g, _ in entries) + 1
    counter = JCounter(lags=lags, n_groups=n_groups)
    for chunk in jiter_chunks(entries, max(lags)):
        counter.add_chunk(chunk)
    return counter


def _run(script, args):
    """The example as a program, retried once on a failed first run."""
    for _ in range(2):
        out = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                             capture_output=True, text=True, timeout=600)
        if out.returncode == 0:
            break
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _rank_lines(stdout, nproc, what):
    found = dict(re.findall(rf"^\[rank (\d+)\] OK {what}=(.*)$", stdout, re.M))
    assert sorted(found) == [str(r) for r in range(nproc)], stdout
    return [found[str(r)] for r in range(nproc)]


def _bench(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("BENCH ")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0][len("BENCH "):])


def test_genome_lag13_against_bear_tpu():
    lag = 6
    got = genome.main(["--genome-mb", "0.02", "--coverage", "2", "--lag", str(lag),
                       "--epochs", "2", "--batch-size", "4096", "--device", "cpu"])

    # bear_tpu's counter on the identical reads.
    reads, groups = genome.synth_reads(0.02, 2.0, 150)
    n, L = reads.shape
    counter = JCounter(lags=[lag], n_groups=2)
    counter.add_chunk(JReadChunk(reads, np.full(n, L, np.int32), np.zeros(n, np.int32),
                                 np.ones(n, bool), groups))
    ds = counter.to_dataset(lag)
    assert got["rows"] == len(ds.codes) > 1000
    assert got["transitions"] == n * (L + 1) == int(ds.counts.sum())
    np.testing.assert_array_equal(got["codes"], ds.codes)
    np.testing.assert_array_equal(got["counts"], ds.counts)

    # bear_tpu's evaluation of the example's trained model.
    assert np.isfinite(got["elbos"]).all() and got["h"] > 0
    jar = jget_ar_func("cnn", lag, 4, {"filter_width": min(8, lag), "num_filters": 96,
                                       "kmer_layer1_width": 64}, dtype=jnp.float32)
    want = jbn.evaluation(ds.codes, ds.counts, 0, 1, "dna", got["h"], jar,
                          [jnp.asarray(p) for p in got["params"]],
                          np.array([0.1, 1.0, 10.0]), dtype=jnp.float32)
    ev = got["evaluation"]
    for i in (3, 4, 5, 6, 7):  # perplexities BEAR, AR, BMM; accuracies BEAR, AR
        np.testing.assert_allclose(ev[i], np.asarray(want[i]), rtol=1e-5)


def test_multihost_counting_example(two_threads):
    for _ in range(2):
        rc = mh_count.main(["--nproc", "2", "--lag", "2", "--reads-per-file", "50",
                            "--read-len", "30", "--device", "cpu"])
        if rc == 0:
            break
    assert rc == 0


def test_multihost_counting_bench_json(two_threads, tmp_path):
    out = _run("torch_multihost_counting.py",
               ["--nproc", "2", "--lag", "2", "--bench", "--reads-per-file", "60",
                "--read-len", "30", "--device", "cpu", "--workdir", str(tmp_path)])
    rec = _bench(out)
    assert rec["bench"] == "multihost_counting"
    assert rec["hosts"] == 2 and rec["device"] == "cpu" and rec["lags"] == "1..2"
    assert len(rec["per_host_transitions_per_sec"]) == 2
    assert all(x > 0 for x in rec["per_host_transitions_per_sec"])
    assert rec["aggregate_transitions_per_sec"] > 0
    assert rec["per_host_bases"] == [2 * 60 * 30] * 2
    # 4 files x 60 reads x (30 bases + 1 stop) transitions per lag
    assert rec["global_transitions_per_lag"] == 4 * 60 * 31

    want = _bear_tpu_count(str(tmp_path / "inputs.csv"), [1, 2])
    want_totals = {l: int(t.sum()) for l, t in want.tables.items()}
    assert want_totals == {1: 4 * 60 * 31, 2: 4 * 60 * 31}
    for totals in _rank_lines(out, 2, "totals"):
        assert ast.literal_eval(totals) == want_totals


@pytest.mark.slow
@pytest.mark.parametrize("streaming", [False, True])
def test_multihost_train_example(two_threads, tmp_path, streaming):
    out = _run("torch_multihost_train.py",
               ["--nproc", "2", "--lag", "3", "--reads-per-file", "200", "--read-len", "50",
                "--epochs", "8", "--device", "cpu", "--bench", "--workdir", str(tmp_path)]
               + (["--streaming"] if streaming else []))
    rec = _bench(out)
    assert rec["bench"] == "multihost_train" and rec["streaming"] is streaming
    assert rec["hosts"] == 2 and rec["devices"] == 4 and rec["device"] == "cpu"
    hs = [float(h) for h in _rank_lines(out, 2, "h")]
    assert hs[0] == hs[1] == rec["h"] and np.isfinite(rec["bear_perplexity"])
    want = _bear_tpu_count(str(tmp_path / "inputs.csv"), [3]).to_dataset(3)
    assert rec["kmers"] == len(want.codes)
