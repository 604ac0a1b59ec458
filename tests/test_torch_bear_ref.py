"""The port's reference-guided BEAR (bear_tpu_torch.models.bear_ref and
train_bear_ref, and the reference counts in bear_net) against bear_tpu's,
on numpy-seeded inputs and the YSD1 fixture, on the CPU in float64.

Both packages start from the same parameters (bear_tpu's init, carried by
``params_restart`` or a results.pickle). Tolerances: counts_to_probs and
the mixture's forward and gradients rtol 1e-12; training ELBOs rtol 1e-8
and parameters rtol 1e-7; the streamed run equals the in-memory one
exactly; evaluation log-likelihoods and perplexities rtol 1e-10,
accuracies exactly where no row has tied maxima; the CLI's [results] rtol
1e-8.
"""

import configparser
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.inference import scoring as jscoring
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import bear_ref as jref
from bear_tpu.models import train_bear_ref as jcli
from bear_tpu.models.ar_funcs import make_ar_func_cnn, make_ar_func_linear, make_ar_func_stop
from bear_tpu.ops import alphabets as jalphabets
from bear_tpu.parallel import data_parallel_mesh as jdata_parallel_mesh
from bear_tpu.utils import checkpoint as jckpt
from bear_tpu_torch.data import bmm_likelihood, load_dense
from bear_tpu_torch.inference.scoring import load_bear
from bear_tpu_torch.models import bear_net, bear_ref, train_bear_ref
from bear_tpu_torch.models.ar_funcs import StopAR
from bear_tpu_torch.ops.distributions import EPSILON
from bear_tpu_torch.parallel import Mesh
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "bear_tpu", "models", "config_files")
LAG = 4
CNN_KW = {"filter_width": 2, "num_filters": 6, "kmer_layer1_width": 4}
NETS = {"linear": (make_ar_func_linear, {}), "stop": (make_ar_func_stop, {}),
        "cnn": (make_ar_func_cnn, CNN_KW)}
VAN = [0.1, 1.0, 10.0]


def _data(seed=0, n=90):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, LAG)).astype(np.int8)
    counts = rng.poisson(5.0, (n, 3, 5)).astype(np.float64)
    counts[:, 2] += rng.poisson(20.0, (n, 5)) * (rng.random((n, 1)) < 0.8)
    return codes, counts


def _models(name, seed=1):
    factory, kw = NETS[name]
    jar = jref.make_ref_ar_func(LAG, 4, factory, kw, dtype=jnp.float64)
    p0 = [np.asarray(-1.2)] + [np.asarray(p) for p in jar.init(jax.random.key(seed))]
    ar = bear_ref.make_ref_ar(name, LAG, 4, kw, dtype=torch.float64, device="cpu")
    return jar, ar, p0


def test_counts_to_probs_matches_bear_tpu_and_keeps_the_float32_floor():
    rng = np.random.default_rng(2)
    raw = rng.poisson(3.0, (40, 5)).astype(np.float64)
    raw[:5] = 0.0  # rows of nothing but the epsilon
    for tau in (0.0, 1 / 30, 0.7, 50.0):
        got = bear_ref.counts_to_probs(bear_ref.prepare_ref_counts(raw, 4, torch.float64),
                                       tau, 4)
        want = jref.counts_to_probs(jref.prepare_ref_counts(raw, 4, jnp.float64), tau, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-300)
        assert (got[:, 4] == 0).all()
    # zero-padded batch rows: finite, uniform over the residues, finite gradients
    for dtype in (torch.float32, torch.float64):
        zero = torch.zeros((3, 5), dtype=dtype, requires_grad=True)
        tau = torch.tensor(1 / 30, dtype=dtype, requires_grad=True)
        out = bear_ref.counts_to_probs(zero, tau, 4)
        assert torch.isfinite(out).all() and (out >= 0).all()
        np.testing.assert_allclose(out[:, :4].detach().numpy(),
                                   0.25 * (1 - np.exp(-1 / 30)), rtol=1e-6)
        out.sum().backward()
        assert torch.isfinite(zero.grad).all() and torch.isfinite(tau.grad).all()
    src = inspect.getsource(bear_ref.counts_to_probs)
    assert "finfo(torch.float32).tiny" in src and "ref_counts.dtype).tiny" not in src
    prepared = bear_ref.prepare_ref_counts(raw[:3], 4, torch.float32)
    assert prepared.dtype == torch.float32 and (prepared[:, 4] == 0).all()
    np.testing.assert_array_equal(
        prepared.numpy(), np.asarray(jref.prepare_ref_counts(raw[:3], 4, jnp.float32)))


@pytest.mark.parametrize("name", list(NETS))
def test_mixture_forward_and_gradients_match_bear_tpu(name):
    jar, ar, p0 = _models(name)
    codes, counts = _data(3, n=50)
    ref = counts[:, 2]
    ref[:4] = 0.0
    jprep = jref.prepare_ref_counts(ref, 4, jnp.float64)
    prep = bear_ref.prepare_ref_counts(ref, 4, torch.float64)
    w = np.random.default_rng(4).random((50, 5))
    oh = np.asarray(jalphabets.one_hot(codes, 5, jnp.float64))
    assert len(p0) - 1 == len(ar.params_list()) == 2 + len(ar.net.params_list())

    def jloss(params):
        return jnp.sum(jnp.log(jar.apply(params, jnp.asarray(oh), jprep)) * w)

    jparams = [jnp.asarray(p) for p in p0[1:]]
    want_probs = np.asarray(jar.apply(jparams, jnp.asarray(oh), jprep))
    want_grads = jax.grad(jloss)(jparams)
    for route in ("forward", "apply_codes"):
        params = [torch.tensor(p, requires_grad=True) for p in p0[1:]]
        if route == "forward":
            probs = ar(torch.tensor(oh), params, prep)
        else:
            probs = ar.apply_codes(torch.from_numpy(codes), params, prep)
        np.testing.assert_allclose(probs.detach().numpy(), want_probs, rtol=1e-12)
        (torch.log(probs) * torch.from_numpy(w)).sum().backward()
        for p, g in zip(params, want_grads):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-12, atol=1e-14)
    # the module's own parameters, loaded from a checkpoint list
    ar.load_params(p0[1:])
    np.testing.assert_allclose(ar.apply_codes(torch.from_numpy(codes), ref_counts=prep)
                               .detach().numpy(), want_probs, rtol=1e-12)
    with pytest.raises(ValueError, match="reference counts"):
        ar.apply_codes(torch.from_numpy(codes))


# (net, train_ar, batch, epochs, acc_steps, shuffle): padded last batches
TRAIN_CASES = {
    "linear_bear": ("linear", False, 32, 12, 1, False),
    "stop_ar": ("stop", True, 40, 10, 1, True),
    "cnn_bear_acc2": ("cnn", False, 25, 8, 2, True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_bear_tpu(case):
    name, train_ar, batch, epochs, acc, shuffle = TRAIN_CASES[case]
    factory, kw = NETS[name]
    _, _, p0 = _models(name)
    codes, counts = _data(5)
    common = dict(batch_size=batch, epochs=epochs, learning_rate=0.02, train_ar=train_ar,
                  acc_steps=acc, shuffle=shuffle, seed=6, params_restart=p0)
    want = jref.train(codes, counts[:, 0], counts[:, 2], len(codes), factory, kw,
                      dtype=jnp.float64, **common)
    got = bear_ref.train(codes, counts[:, 0], counts[:, 2], len(codes), name, kw,
                         dtype=torch.float64, device="cpu", **common)
    assert len(got.losses) == len(want.losses) > 10
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-8)
    for g, w in zip(got.params_list, want.params_list):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-10)
    assert 0 < bear_ref.error_rate(got.params) < 1 and bear_ref.stop_rate_inverse(got.params) > 1
    assert bear_ref.error_rate(got.params) == pytest.approx(jref.error_rate(want.params),
                                                            rel=1e-7)
    assert bear_ref.stop_rate_inverse(got.params) == pytest.approx(
        jref.stop_rate_inverse(want.params), rel=1e-7)


def test_train_streaming_equals_in_memory_and_bear_tpu():
    codes, counts = _data(7, n=96)
    _, _, p0 = _models("linear")
    kw = dict(batch_size=16, epochs=3, learning_rate=0.02, seed=5, params_restart=p0)
    memory = bear_ref.train(codes, counts[:, 0], counts[:, 2], 96, "linear",
                            dtype=torch.float64, device="cpu", **kw)

    def shards():
        for s0 in range(0, 96, 32):
            yield codes[s0:s0 + 32], counts[s0:s0 + 32, 0], counts[s0:s0 + 32, 2]

    streamed = bear_ref.train_streaming(shards, 96, "linear", lag=LAG, dtype=torch.float64,
                                        device="cpu", block_steps=3, **kw)
    np.testing.assert_array_equal(streamed.losses, memory.losses)
    for a, b in zip(streamed.params_list, memory.params_list):
        np.testing.assert_array_equal(a, b)
    want = jref.train_streaming(shards, 96, make_ar_func_linear, {}, lag=LAG,
                                dtype=jnp.float64, block_steps=3, **kw)
    np.testing.assert_allclose(streamed.losses, want.losses, rtol=1e-8)
    # a bear_net stream must not mix shards with and without reference counts
    ar = bear_ref.make_ref_ar("linear", LAG, 4, dtype=torch.float64, device="cpu")
    mixed = lambda: iter([(codes[:32], counts[:32, 0], counts[:32, 2]),  # noqa: E731
                          (codes[32:], counts[32:, 0])])
    with pytest.raises(ValueError, match="agree"):
        bear_net.train_streaming(mixed, 96, ar, batch_size=16, dtype=torch.float64,
                                 device="cpu")


@pytest.fixture(scope="module")
def trained():
    codes, counts = _data(8, n=120)
    jar, ar, p0 = _models("cnn")
    res = jref.train(codes, counts[:, 0], counts[:, 2], 120, make_ar_func_cnn, CNN_KW,
                     batch_size=40, epochs=5, learning_rate=0.02, params_restart=p0,
                     dtype=jnp.float64)
    return codes, counts, jar, ar, res


def _no_ties(x):
    top = x.max(-1, keepdims=True)
    return not bool(((x == top).sum(-1) > 1).any())


@pytest.mark.parametrize("train_loc", [0, -1])
def test_evaluation_and_streaming_match_bear_tpu(trained, train_loc):
    codes, counts, jar, ar, res = trained
    ar_params = res.params_list[1:]
    kw = dict(batch_size=32, seed=3)
    want = jref.evaluation(codes, counts, train_loc, 1, 2, "dna", res.h, jar,
                           res.params["ar"], VAN, dtype=jnp.float64, **kw)
    got = bear_ref.evaluation(codes, counts, train_loc, 1, 2, "dna", res.h, ar, ar_params,
                              VAN, dtype=torch.float64, device="cpu", **kw)

    def shards():  # batch-aligned
        yield codes[:64], counts[:64]
        yield codes[64:], counts[64:]

    streamed = bear_ref.evaluation_streaming(shards, train_loc, 1, 2, "dna", res.h, ar,
                                             ar_params, VAN, dtype=torch.float64,
                                             device="cpu", block_steps=2, **kw)
    jstreamed = jref.evaluation_streaming(shards, train_loc, 1, 2, "dna", res.h, jar,
                                          res.params["ar"], VAN, dtype=jnp.float64,
                                          block_steps=2, **kw)
    assert len(got) == len(streamed) == 9
    for g, s, w, js in zip(got[:6], streamed[:6], want[:6], jstreamed[:6]):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10)
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-10)
        np.testing.assert_allclose(s, g, rtol=1e-12)
    # BEAR and AR readings are continuous in the trained CNN: no ties
    for i in (6, 7):
        assert float(got[i]) == float(want[i]) == float(streamed[i])
    if train_loc >= 0 and _no_ties(counts[:, 0]):
        np.testing.assert_array_equal(got[8], np.asarray(want[8]))


def test_padded_batches_stay_finite():
    codes, counts = _data(1, n=10)  # batch 16 > 10 rows: padded rows
    res = bear_ref.train(codes, counts[:, 0], counts[:, 2], 10, StopAR, batch_size=16,
                         epochs=2, learning_rate=0.01, train_ar=True, dtype=torch.float64,
                         device="cpu")
    assert np.isfinite(res.losses).all()
    assert all(np.isfinite(p).all() for p in res.params_list)
    ar = bear_ref.make_ref_ar(StopAR, LAG, 4, dtype=torch.float64, device="cpu")
    out = bear_ref.evaluation(codes, counts, 0, 1, 2, "dna", 1.0, ar, res.params["ar"], [1.0],
                              batch_size=16, dtype=torch.float64, device="cpu")
    assert all(np.isfinite(np.asarray(o)).all() for o in out)


def _config(out, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, "bear_test.cfg"))
    cfg["general"]["out_folder"] = str(out) + "*"
    for key, value in overrides.items():
        section, option = key.split("__")
        cfg[section][option] = str(value)
    return cfg


def _init_dir(tmp_path):
    jar = jref.make_ref_ar_func(5, 4, make_ar_func_linear, dtype=jnp.float64)
    params = jbn.params_to_list(jbn.init_params(jax.random.key(11), jar, dtype=jnp.float64))
    d = tmp_path / "init"
    d.mkdir()
    jckpt.save_results(str(d), params)
    return d


@pytest.mark.parametrize("streaming", [False, True])
def test_cli_results_match_bear_tpu(tmp_path, streaming):
    init = _init_dir(tmp_path)
    kw = dict(train__epochs=30, train__train_ar=False, train__restart=True,
              train__restart_path=init, train__streaming=streaming)
    jcfg = _config(tmp_path / "jax", **kw)
    pcfg = _config(tmp_path / "port", **kw)
    jret = jcli.main(jcfg)
    pret = train_bear_ref.main(pcfg, device="cpu")
    assert pret[0] == jret[0] == 1
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-8)
    want, got = jcfg["results"], pcfg["results"]
    ysd1 = load_dense(bundled_ysd1_path(), "dna", 3).counts[:, 0]
    shares = ysd1.sum(0) / ysd1.sum()
    keys = set(want) - {"out_folder", "file"}
    assert keys == set(got) - {"out_folder", "file"} and len(keys) == 21
    assert {"h", "error_rate", "stop_rate"} <= keys
    for key in sorted(keys):
        g, w = np.asarray(json.loads(got[key])), np.asarray(json.loads(want[key]))
        if key == "accuracy_bmm":  # prior mode: every letter ties
            assert all(np.isclose(shares, x, rtol=1e-12).any() for x in g)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, err_msg=key)
    jres = jckpt.load_results(str(tmp_path / "jax"))
    pres = checkpoint.load_results(str(tmp_path / "port"))
    assert len(pres["params"]) == len(jres["params"]) == 4  # h, tau, nu, linear mat
    for g, w in zip(pres["params"], jres["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-8)
    # the reference's BMM check (tests/test_bear_ref.py:116-122)
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    calc = np.asarray(bmm_likelihood(ds.counts, np.array(VAN) + EPSILON, device="cpu"))
    np.testing.assert_allclose(calc[0], pret[1], rtol=1e-6)
    np.testing.assert_allclose(np.exp(-calc[0] / ds.counts[:, 0].sum()), pret[2], rtol=1e-6)


def test_reference_checkpoints_carry_across_and_load_bear_refuses(tmp_path):
    init = _init_dir(tmp_path)
    train_bear_ref.main(_config(tmp_path / "port", train__epochs=3, train__restart=True,
                                train__restart_path=init), device="cpu")
    with pytest.raises(ValueError, match="bear_ref|reference-guided"):
        load_bear(str(tmp_path / "port"), device="cpu")
    with pytest.raises(ValueError, match="bear_ref"):
        jscoring.load_bear(str(tmp_path / "port"))
    # bear_tpu's checkpoint list loads into the port's module and computes the same
    lst = checkpoint.load_params_list(str(init))
    jar = jref.make_ref_ar_func(5, 4, make_ar_func_linear, dtype=jnp.float64)
    ar = bear_ref.make_ref_ar("linear", 5, 4, dtype=torch.float64, device="cpu")
    ar.load_params(lst[1:])
    params = bear_net.params_from_list(lst, device="cpu", dtype=torch.float64)
    codes, counts = _data(9, n=30)
    codes = np.concatenate([codes, codes[:, :1]], axis=1)
    prep = bear_ref.prepare_ref_counts(counts[:, 2], 4, torch.float64)
    want = np.asarray(jar.apply([jnp.asarray(p) for p in lst[1:]],
                                jalphabets.one_hot(codes, 5, jnp.float64),
                                jref.prepare_ref_counts(counts[:, 2], 4, jnp.float64)))
    for got in (ar.apply_codes(torch.from_numpy(codes), ref_counts=prep),
                ar.apply_codes(torch.from_numpy(codes), params["ar"], prep)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)


def test_refusals():
    codes, counts = _data(2, n=20)
    # compute_dtype is ported: the inner net computes in bfloat16, the mixture
    # and the parameters stay in float32, as in bear_tpu.
    res = bear_ref.train(codes, counts[:, 0], counts[:, 2], 20, "linear", batch_size=8,
                         compute_dtype=torch.bfloat16, dtype=torch.float32, device="cpu")
    assert np.isfinite(res.losses).all()
    assert all(p.dtype == torch.float32 for p in res.params["ar"])
    # mesh= is ported: 4 CPU entries against bear_tpu's 4 virtual devices
    jar = jref.make_ref_ar_func(codes.shape[1], 4, make_ar_func_linear, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(1), jar, dtype=jnp.float64))
    got = bear_ref.train(codes, counts[:, 0], counts[:, 2], 20, "linear", batch_size=8,
                         epochs=3, params_restart=p0, mesh=Mesh(["cpu"] * 4, ("data",)),
                         dtype=torch.float64, device="cpu")
    want = jref.train(codes, counts[:, 0], counts[:, 2], 20, make_ar_func_linear, batch_size=8,
                      epochs=3, params_restart=p0, mesh=jdata_parallel_mesh(4),
                      dtype=jnp.float64)
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=1e-8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bear_ref.train(codes, counts[:, 0], counts[:, 2], 20, "linear", batch_size=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bear_ref.main(_config("/nonexistent"))
