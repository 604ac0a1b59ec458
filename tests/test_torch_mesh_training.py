"""The port's data parallelism over a mesh (``mesh=`` of bear_tpu_torch's
training, evaluation, likelihood, vBEAR, reference-guided model and serving,
and ``[train] data_parallel`` of both CLIs) against bear_tpu's, on the CPU.

bear_tpu runs on conftest's 8 virtual CPU devices; the port on a CPU
``Mesh`` of the same shape (the one CPU device named 8 times). Both start
from the same parameters (bear_tpu's init, carried by ``params_restart``).
Each case holds the port's mesh run against its own run without a mesh at
bear_tpu's tolerance for the same invariance (rtol 1e-9 for training and
evaluation, 1e-12 for streamed == in-memory, 1e-12 for the likelihood and
for row-split serving), and against bear_tpu's mesh run at the port's
usual tolerances (trajectories rtol 1e-8, log-likelihoods rtol 1e-10).
Accuracies equal exactly between the port's mesh and unsplit runs: the
tie-break noise of a batch is drawn once and sliced.
"""

import configparser
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.counting import TransitionCounter as JCounter, chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.data import bmm_likelihood as jbmm_likelihood
from bear_tpu.inference.serving import BearServer as JServer
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import bear_ref as jref
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.models import make_ar_func_linear
from bear_tpu.models import train_bear_net as jcli
from bear_tpu.models import train_bear_ref as jcli_ref
from bear_tpu.models.vbear import train_variational_h as jtrain_vh
from bear_tpu.parallel import data_parallel_mesh as jmesh
from bear_tpu.utils import checkpoint as jckpt
from bear_tpu_torch.counting.engine import table_rows
from bear_tpu_torch.data import bmm_likelihood, load_dense
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models import bear_net, bear_ref, train_bear_net, train_bear_ref, vbear
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.parallel import Mesh
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import RunConfig, bundled_ysd1_path

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "bear_tpu", "models", "config_files")
CPU8 = Mesh(["cpu"] * 8, ("data",))


def _toy(n, lag=3, num_ds=2, seed=0, lam=5.0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, lag)).astype(np.int8)
    counts = rng.poisson(lam, size=(n, num_ds, 5)).astype(np.float64)
    return codes, counts


def _linear(lag, seed=0):
    jar = jget_ar_func("linear", lag, 4, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    return jar, get_ar_func("linear", lag, 4, dtype=torch.float64, device="cpu"), p0


def _same_params(a, b, rtol, atol=0.0):
    for x, y in zip(a.params_list, b.params_list):
        np.testing.assert_allclose(x, np.asarray(y), rtol=rtol, atol=atol)


# --- training and evaluation (tests/test_bear_net.py) ----------------------


def test_shard_invariance_training():
    # tests/test_bear_net.py::test_shard_invariance_training; batch 30 pads
    # to 32 on the mesh (4 steps an epoch against 5 without it).
    codes, counts = _toy(128)
    jar, ar, p0 = _linear(3)
    kw = dict(num_kmers=128, batch_size=30, epochs=3, learning_rate=0.01, params_restart=p0)
    one = bear_net.train(codes, counts[:, 0], ar_func=ar, dtype=torch.float64, device="cpu",
                         **kw)
    eight = bear_net.train(codes, counts[:, 0], ar_func=ar, dtype=torch.float64,
                           device="cpu", mesh=CPU8, **kw)
    want = jbn.train(codes, counts[:, 0], ar_func=jar, dtype=jnp.float64, mesh=jmesh(8), **kw)
    assert len(one.losses) == 15 and len(eight.losses) == len(want.losses) == 12
    np.testing.assert_allclose(eight.losses, np.asarray(want.losses), rtol=1e-8)
    _same_params(eight, want, rtol=1e-7, atol=1e-10)
    # the same batches without padding: 8 entries == 1 entry
    kw["batch_size"] = 32
    one = bear_net.train(codes, counts[:, 0], ar_func=ar, dtype=torch.float64, device="cpu",
                         **kw)
    eight = bear_net.train(codes, counts[:, 0], ar_func=ar, dtype=torch.float64,
                           device="cpu", mesh=CPU8, **kw)
    np.testing.assert_allclose(one.losses, eight.losses, rtol=1e-9)
    _same_params(one, eight, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("train_loc", [0, -1])
def test_shard_invariance_evaluation(train_loc):
    codes, counts = _toy(60)
    jar, ar, p0 = _linear(3)
    kw = dict(batch_size=16)
    one = bear_net.evaluation(codes, counts, train_loc, 1, "dna", 0.5, ar, p0[1:], [1.0, 3.0],
                              dtype=torch.float64, device="cpu", **kw)
    eight = bear_net.evaluation(codes, counts, train_loc, 1, "dna", 0.5, ar, p0[1:],
                                [1.0, 3.0], dtype=torch.float64, device="cpu", mesh=CPU8, **kw)
    want = jbn.evaluation(codes, counts, train_loc, 1, "dna", 0.5, jar, p0[1:], [1.0, 3.0],
                          dtype=jnp.float64, mesh=jmesh(8), **kw)
    for a, b in zip(one[:6], eight[:6]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    for a, b in zip(one[6:], eight[6:]):  # the same tie-break draws
        np.testing.assert_array_equal(a, b)
    for a, b in zip(eight[:6], want[:6]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10)
    # the continuous BEAR and AR readings have no ties
    assert float(eight[6]) == float(want[6]) and float(eight[7]) == float(want[7])
    # h_scan forwards the mesh
    got = bear_net.h_scan(codes, counts, train_loc, 1, "dna", [0.1, 0.5], ar, p0[1:],
                          batch_size=16, dtype=torch.float64, device="cpu", mesh=CPU8)
    ref = jbn.h_scan(codes, counts, train_loc, 1, "dna", [0.1, 0.5], jar, p0[1:],
                     batch_size=16, dtype=jnp.float64, mesh=jmesh(8))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10)


def test_train_streaming_mesh_acc_matches_concat():
    # tests/test_bear_net.py:420: accumulation groups span shard boundaries.
    rng = np.random.default_rng(11)
    lag, bsz, n = 4, 16, 96
    codes = rng.integers(0, 4, (n, lag)).astype(np.int8)
    counts = rng.poisson(5.0, (n, 5)).astype(np.float64)
    jar, ar, p0 = _linear(lag, seed=3)
    kw = dict(num_kmers=n, batch_size=bsz, epochs=2, learning_rate=0.02, acc_steps=2,
              params_restart=p0)

    def shards():
        for s0 in range(0, n, 48):
            yield codes[s0:s0 + 48], counts[s0:s0 + 48]

    port = dict(ar_func=ar, dtype=torch.float64, device="cpu", **kw)
    concat = bear_net.train(codes, counts, mesh=CPU8, **port)
    streamed = bear_net.train_streaming(shards, mesh=CPU8, block_steps=2, **port)
    assert len(streamed.losses) == len(concat.losses) == 6
    np.testing.assert_allclose(concat.losses, streamed.losses, rtol=1e-12)
    _same_params(concat, streamed, rtol=1e-12, atol=1e-15)
    want = jbn.train_streaming(shards, ar_func=jar, dtype=jnp.float64, mesh=jmesh(8),
                               block_steps=2, **kw)
    np.testing.assert_allclose(streamed.losses, np.asarray(want.losses), rtol=1e-8)
    _same_params(streamed, want, rtol=1e-7, atol=1e-10)
    # without a mesh, streamed == concat bit for bit, and == the mesh runs
    concat1 = bear_net.train(codes, counts, **port)
    streamed1 = bear_net.train_streaming(shards, block_steps=2, **port)
    np.testing.assert_array_equal(concat1.losses, streamed1.losses)
    np.testing.assert_allclose(concat1.losses, streamed.losses, rtol=1e-9)


def test_train_streaming_full_composition_resume(tmp_path, monkeypatch):
    # tests/test_bear_net.py:633: streaming + 8-entry mesh + acc_steps +
    # shuffle + checkpoints, killed after the second write and resumed:
    # the resumed run lands bit for bit on the uninterrupted trajectory.
    rng = np.random.default_rng(21)
    lag, bsz, n = 3, 16, 192
    codes = rng.integers(0, 4, (n, lag)).astype(np.int8)
    counts = rng.poisson(4.0, (n, 5)).astype(np.float64)
    jar, ar, p0 = _linear(lag, seed=5)

    def shards(epoch):
        order = [0, 1, 2] if epoch % 2 == 0 else [2, 0, 1]
        for i in order:
            yield codes[i * 64:(i + 1) * 64], counts[i * 64:(i + 1) * 64]

    kw = dict(num_kmers=n, batch_size=bsz, epochs=2, learning_rate=0.02, seed=5,
              acc_steps=2, shuffle=True, block_steps=2, params_restart=p0)
    port = dict(ar_func=ar, dtype=torch.float64, device="cpu", mesh=CPU8, **kw)
    plain = bear_net.train_streaming(shards, **port)
    assert len(plain.losses) == 12
    want = jbn.train_streaming(shards, ar_func=jar, dtype=jnp.float64, mesh=jmesh(8), **kw)
    np.testing.assert_allclose(plain.losses, np.asarray(want.losses), rtol=1e-8)

    d = tmp_path / "ck"
    d.mkdir()
    writes = []
    real = bear_net._save_state

    def killing_save(checkpoint_dir, params, optimizer, applies_done):
        real(checkpoint_dir, params, optimizer, applies_done)
        writes.append(applies_done)
        if len(writes) == 2:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(bear_net, "_save_state", killing_save)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        bear_net.train_streaming(shards, checkpoint_dir=str(d), **port)
    monkeypatch.setattr(bear_net, "_save_state", real)
    killed_at = checkpoint.load_train_state(str(d))["applies_done"]
    assert 0 < killed_at < 12
    resumed = bear_net.train_streaming(shards, checkpoint_dir=str(d), **port)
    np.testing.assert_array_equal(plain.losses[killed_at:], resumed.losses)
    _same_params(plain, resumed, rtol=0)


def test_evaluation_streaming_mesh_matches_single_device():
    # tests/test_bear_net.py:703
    codes, counts = _toy(96, lag=4, seed=17)
    jar, ar, p0 = _linear(4)
    van = [0.1, 1.0]
    kw = dict(batch_size=16, seed=3, block_steps=2)

    def shards():
        yield codes[:32], counts[:32]
        yield codes[32:], counts[32:]

    port = dict(dtype=torch.float64, device="cpu", **kw)
    one = bear_net.evaluation_streaming(shards, 0, 1, "dna", 0.2, ar, p0[1:], van, **port)
    eight = bear_net.evaluation_streaming(shards, 0, 1, "dna", 0.2, ar, p0[1:], van,
                                          mesh=CPU8, **port)
    memory = bear_net.evaluation(codes, counts, 0, 1, "dna", 0.2, ar, p0[1:], van,
                                 batch_size=16, seed=3, dtype=torch.float64, device="cpu",
                                 mesh=CPU8)
    want = jbn.evaluation_streaming(shards, 0, 1, "dna", 0.2, jar, p0[1:], van,
                                    dtype=jnp.float64, mesh=jmesh(8), **kw)
    for i in range(9):
        np.testing.assert_allclose(np.asarray(one[i]), np.asarray(eight[i]), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(memory[i]), np.asarray(eight[i]), rtol=1e-9)
    for i in range(6):
        np.testing.assert_allclose(np.asarray(eight[i]), np.asarray(want[i]), rtol=1e-10)
    # streamed h_scan forwards the mesh too
    got = bear_net.h_scan_streaming(shards, 0, 1, "dna", [0.1, 0.2], ar, p0[1:],
                                    mesh=CPU8, **port)
    ref = jbn.h_scan_streaming(shards, 0, 1, "dna", [0.1, 0.2], jar, p0[1:],
                               dtype=jnp.float64, mesh=jmesh(8), **kw)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-10)


def test_mesh_device_rules():
    # The mesh's devices decide: device= naming another device raises, and
    # so does a card the machine does not have (no fall-back to the CPU).
    codes, counts = _toy(16)
    _, ar, p0 = _linear(3)
    kw = dict(num_kmers=16, ar_func=ar, batch_size=8, params_restart=p0,
              dtype=torch.float64)
    with pytest.raises(ValueError, match="mesh's device"):
        bear_net.train(codes, counts[:, 0], mesh=CPU8, device="meta", **kw)
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        bear_net.train(codes, counts[:, 0], mesh=Mesh([f"cuda:{n}"], ("data",)),
                       device="cuda", **kw)


# --- likelihood, vBEAR, the reference-guided model -------------------------


def test_bmm_likelihood_mesh_matches_single_device():
    # tests/test_data.py::test_bmm_likelihood_mesh_matches_single_device
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    alpha = np.array([0.1, 1.0, 10.0])
    one = bmm_likelihood(ds.counts, alpha, batch_size=400, device="cpu")
    eight = bmm_likelihood(ds.counts, alpha, batch_size=399, mesh=CPU8, device="cpu")
    np.testing.assert_allclose(eight, one, rtol=1e-12, atol=0)
    whole = bmm_likelihood(ds.counts, alpha, mesh=CPU8, device="cpu")
    want = np.asarray(jbmm_likelihood(ds.counts, alpha, mesh=jmesh(8)))
    np.testing.assert_allclose(whole, one, rtol=1e-12)
    np.testing.assert_allclose(whole, want, rtol=1e-12)


class _Uniform(torch.nn.Module):
    """f = 1 / 5 everywhere (tests/test_vbear.py's _uniform_ar)."""

    def init(self, generator=None):
        return []

    def apply_codes(self, codes, params=None):
        return torch.full(tuple(codes.shape[:-1]) + (5,), 0.2, dtype=torch.float64,
                          device=codes.device)


def test_vbear_shard_invariance():
    # tests/test_vbear.py::test_vbear_shard_invariance: one draw per apply,
    # so a mesh changes no draw; only the reduction order differs.
    rng = np.random.default_rng(3)
    n, A1 = 256, 5
    p = rng.dirichlet(np.full(A1, 0.4), size=n)
    counts = np.stack([rng.multinomial(25, pi) for pi in p]).astype(np.float64)
    codes = rng.integers(0, 4, (n, 3)).astype(np.int8)
    kw = dict(num_kmers=n, batch_size=64, epochs=40, learning_rate=0.05, seed=5)
    single = vbear.train_variational_h(codes, counts, ar_func=_Uniform(),
                                       dtype=torch.float64, device="cpu", **kw)
    sharded = vbear.train_variational_h(codes, counts, ar_func=_Uniform(),
                                        dtype=torch.float64, device="cpu", mesh=CPU8, **kw)
    np.testing.assert_allclose(sharded.h_posterior, single.h_posterior, rtol=1e-8)
    np.testing.assert_allclose(sharded.losses, single.losses, rtol=1e-8)
    # bear_tpu draws from its own generator: the same posterior, in
    # distribution (tests/test_torch_vbear.py's comparison)
    juni = jref.ARFunc(init=lambda key: [],
                       apply=lambda params, oh: jnp.full(oh.shape[:-2] + (A1,), 0.2, oh.dtype),
                       name="uniform")
    want = jtrain_vh(codes, counts, ar_func=juni, dtype=jnp.float64, mesh=jmesh(8), **kw)
    (mu, sigma), (jmu, jsigma) = sharded.h_posterior, want.h_posterior
    assert abs(mu - jmu) < 3 * max(sigma, jsigma)
    # a linear AR through the mesh: its parameters move to each entry
    jar, ar, p0 = _linear(3)
    lin = dict(kw, epochs=5)
    a = vbear.train_variational_h(codes, counts, ar_func=ar, dtype=torch.float64,
                                  device="cpu", **lin)
    b = vbear.train_variational_h(codes, counts, ar_func=ar, dtype=torch.float64,
                                  device="cpu", mesh=CPU8, **lin)
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-9)


def test_bear_ref_mesh_matches_bear_tpu():
    # bear_ref's train / train_streaming / evaluation with mesh= in **kwargs
    codes, counts = _toy(120, lag=4, num_ds=3, seed=9)
    jar = jref.make_ref_ar_func(4, 4, make_ar_func_linear, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(2), jar, dtype=jnp.float64))
    kw = dict(batch_size=40, epochs=4, learning_rate=0.02, params_restart=p0)
    want = jref.train(codes, counts[:, 0], counts[:, 2], 120, make_ar_func_linear,
                      dtype=jnp.float64, mesh=jmesh(8), **kw)
    got = bear_ref.train(codes, counts[:, 0], counts[:, 2], 120, "linear",
                         dtype=torch.float64, device="cpu", mesh=CPU8, **kw)
    one = bear_ref.train(codes, counts[:, 0], counts[:, 2], 120, "linear",
                         dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=1e-8)
    np.testing.assert_allclose(got.losses, one.losses, rtol=1e-9)

    def shards():
        yield codes[:80], counts[:80, 0], counts[:80, 2]
        yield codes[80:], counts[80:, 0], counts[80:, 2]

    streamed = bear_ref.train_streaming(shards, 120, "linear", lag=4, dtype=torch.float64,
                                        device="cpu", mesh=CPU8, **kw)
    np.testing.assert_allclose(streamed.losses, got.losses, rtol=1e-12)
    ar = bear_ref.make_ref_ar("linear", 4, 4, dtype=torch.float64, device="cpu")
    params = got.params_list
    ev = bear_ref.evaluation(codes, counts, 0, 1, 2, "dna", got.h, ar, params[1:], [1.0],
                             batch_size=32, dtype=torch.float64, device="cpu", mesh=CPU8)
    ev1 = bear_ref.evaluation(codes, counts, 0, 1, 2, "dna", got.h, ar, params[1:], [1.0],
                              batch_size=32, dtype=torch.float64, device="cpu")
    jev = jref.evaluation(codes, counts, 0, 1, 2, "dna", got.h, jar, params[1:], [1.0],
                          batch_size=32, dtype=jnp.float64, mesh=jmesh(8))
    for i in range(6):
        np.testing.assert_allclose(ev[i], ev1[i], rtol=1e-9)
        np.testing.assert_allclose(ev[i], np.asarray(jev[i]), rtol=1e-10)


# --- row-split serving (tests/test_serving.py) ------------------------------


LAG = 3


def _counter_table():
    tc = JCounter(lags=[LAG], n_groups=1)
    seqs = ["TTTAT", "TTCTT", "TTTTT", "TTTTT"]
    for chunk in jchunk_reads(iter([(jfastx.encode_seq(s), 0) for s in seqs]), LAG):
        tc.add_chunk(chunk)
    return tc.tables[LAG][0]


@pytest.mark.parametrize("n_slices", [8, 3])
def test_sharded_table_serving_matches_dense(n_slices):
    # tests/test_serving.py::test_sharded_table_serving_matches_dense: MAP
    # of the row-split table == the dense table's exactly, and == bear_tpu's
    # row-split server; BMM and BEAR readings.
    mesh = Mesh(["cpu"] * n_slices, ("kmer",))
    table = _counter_table()
    seqs = ["TTTAT", "TTCAT", "TTTTTTTTTT", "A"]
    dense = BearServer(table, LAG, van=1.0, dtype=torch.float64, device="cpu")
    shard = BearServer(table, LAG, van=1.0, dtype=torch.float64, device="cpu", mesh=mesh)
    np.testing.assert_array_equal(dense.score(seqs), shard.score(seqs))
    want = JServer(table, LAG, van=1.0, dtype=jnp.float64, mesh=jmesh(8, axis_name="kmer"))
    np.testing.assert_allclose(shard.score(seqs), np.asarray(want.score(seqs, mode="map")),
                               rtol=1e-10)
    key = kr.key(7)
    np.testing.assert_array_equal(dense.score(seqs, mode="sample", key=key),
                                  shard.score(seqs, mode="sample", key=key))

    def ar_apply(oh):
        return torch.full(tuple(oh.shape[:-2]) + (5,), 0.2, dtype=oh.dtype)

    def jar_apply(oh):
        return jnp.full(oh.shape[:-2] + (5,), 0.2, dtype=oh.dtype)

    dense_b = BearServer(table, LAG, h=0.5, ar_apply=ar_apply, dtype=torch.float64,
                         device="cpu")
    shard_b = BearServer(table, LAG, h=0.5, ar_apply=ar_apply, dtype=torch.float64,
                         device="cpu", mesh=mesh)
    want_b = JServer(table, LAG, h=0.5, ar_apply=jar_apply, dtype=jnp.float64,
                     mesh=jmesh(8, axis_name="kmer"))
    np.testing.assert_array_equal(dense_b.score(seqs), shard_b.score(seqs))
    np.testing.assert_allclose(shard_b.score(seqs), np.asarray(want_b.score(seqs)),
                               rtol=1e-10)
    # float32: the gather is exact, so the bits are the dense table's
    d32 = BearServer(table, LAG, h=0.5, ar_apply=ar_apply, device="cpu")
    s32 = BearServer(table, LAG, h=0.5, ar_apply=ar_apply, device="cpu", mesh=mesh)
    np.testing.assert_array_equal(d32.score(seqs), s32.score(seqs))


def test_sharded_table_sampled_modes_match_dense():
    # tests/test_serving.py::test_sharded_table_sampled_modes_match_dense:
    # draws are keyed on the global table row, the same either way.
    rng = np.random.default_rng(0)
    table = rng.poisson(0.4, (table_rows(LAG), 5)).astype(np.float64)
    dense = BearServer(table, LAG, van=0.5, dtype=torch.float64, device="cpu")
    shard = BearServer(table, LAG, van=0.5, dtype=torch.float64, device="cpu",
                       mesh=Mesh(["cpu"] * 8, ("kmer",)))
    codes = rng.integers(0, 4, (16, 40)).astype(np.int8)
    lengths = np.full(16, 40, np.int32)
    key = kr.key(1)
    np.testing.assert_array_equal(dense.log_prob_sampled(codes, lengths, key).numpy(),
                                  shard.log_prob_sampled(codes, lengths, key).numpy())
    wt = "".join("ACGT"[c] for c in codes[0])
    variants = [f"{wt[3]}3{'C' if wt[3] == 'A' else 'A'}", f"{wt[10:12]}10AA"]
    for mode in ("map", "sample"):
        np.testing.assert_array_equal(
            dense.delta_scores_snv(wt, [3, 10], ["A", "C"], mode=mode, key=key,
                                   mc_samples=3),
            shard.delta_scores_snv(wt, [3, 10], ["A", "C"], mode=mode, key=key,
                                   mc_samples=3))
        np.testing.assert_array_equal(
            dense.delta_scores_variants(wt, variants, mode=mode, key=key),
            shard.delta_scores_variants(wt, variants, mode=mode, key=key))


def test_from_model_dir_row_split(tmp_path):
    # from_model_dir(mesh=) builds the same table (bear_test.cfg's YSD1
    # counts), row-split
    jar = jget_ar_func("linear", 5, 4, dtype=jnp.float64)
    params = jbn.params_to_list(jbn.init_params(jax.random.key(1), jar, dtype=jnp.float64))
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, "bear_test.cfg"))
    cfg["results"] = {"h": "0.2"}
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)
    jckpt.save_results(str(tmp_path), params)
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(1, 30, 50)]
    kw = dict(dtype=torch.float64, device="cpu")
    dense = BearServer.from_model_dir(str(tmp_path), **kw)
    shard = BearServer.from_model_dir(str(tmp_path), mesh=Mesh(["cpu"] * 4, ("kmer",)), **kw)
    np.testing.assert_array_equal(dense.score(seqs), shard.score(seqs))


# --- the CLIs with [train] data_parallel = True -----------------------------


def _config(name, out, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, name))
    cfg["general"]["out_folder"] = str(out) + "*"
    for key, value in overrides.items():
        section, option = key.split("__")
        cfg[section][option] = str(value)
    return cfg


def _init_dir(tmp_path, jar, seed):
    params = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    d = tmp_path / "init"
    d.mkdir()
    jckpt.save_results(str(d), params)
    return d


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("mesh", [None, "cpu8"])
def test_cli_data_parallel_matches_bear_tpu(tmp_path, streaming, mesh):
    # data_parallel = True: bear_tpu over conftest's 8 devices; the port over
    # every local device (one CPU entry) or an explicit 8-entry mesh. The
    # batch is a multiple of 8, so both geometries give the same batches.
    init = _init_dir(tmp_path, jget_ar_func("linear", 5, 4, dtype=jnp.float64), 7)
    kw = dict(train__epochs=30, train__train_ar=False, train__restart=True,
              train__restart_path=init, train__data_parallel=True,
              train__streaming=streaming, train__batch_size=504)
    jret = jcli.main(_config("bear_test.cfg", tmp_path / "jax", **kw))
    pcfg = _config("bear_test.cfg", tmp_path / "port", **kw)
    assert RunConfig.from_configparser(pcfg).data_parallel
    pret = train_bear_net.main(pcfg, mesh=CPU8 if mesh else None, device="cpu")
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-8)
    np.testing.assert_allclose(pret[2], jret[2], rtol=1e-8)
    for key in ("h", "heldout_perplex_BEAR", "heldout_perplex_AR", "heldout_perplex_BMM"):
        np.testing.assert_allclose(json.loads(pcfg["results"][key]),
                                   json.loads(_results(tmp_path / "jax")[key]), rtol=1e-8)


def _results(out):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(str(out), "config.cfg"))
    return cfg["results"]


def test_ref_cli_data_parallel_matches_bear_tpu(tmp_path):
    jar = jref.make_ref_ar_func(5, 4, make_ar_func_linear, dtype=jnp.float64)
    init = _init_dir(tmp_path, jar, 11)
    kw = dict(train__epochs=20, train__train_ar=False, train__restart=True,
              train__restart_path=init, train__data_parallel=True)
    jret = jcli_ref.main(_config("bear_test.cfg", tmp_path / "jax", **kw))
    pcfg = _config("bear_test.cfg", tmp_path / "port", **kw)
    pret = train_bear_ref.main(pcfg, mesh=CPU8, device="cpu")
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-8)
    np.testing.assert_allclose(pret[2], jret[2], rtol=1e-8)
    want = _results(tmp_path / "jax")
    for key in ("h", "error_rate", "heldout_perplex_BEAR"):
        np.testing.assert_allclose(float(pcfg["results"][key]), float(want[key]), rtol=1e-8)
