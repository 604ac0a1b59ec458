"""The port's training and evaluation (bear_tpu_torch.models.bear_net)
against bear_tpu's, on the YSD1 fixture, on the CPU in float64.

Both packages start from the same parameters (bear_tpu's init, carried by
``params_restart``) and see the same batches. Tolerances: ~100-apply ELBO
trajectories rtol 1e-8; final parameters rtol 1e-7, atol 1e-10 (Adam's
update is the same in exact arithmetic; optax and torch associate it
differently); evaluation and h_scan log-likelihoods and perplexities rtol
1e-10; accuracies exactly equal where no row has tied maxima.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)
LAG = 5
CNN_KW = {"num_filters": 30, "filter_width": 3, "kmer_layer1_width": 16}
VAN = [0.1, 1.0, 10.0]


@pytest.fixture(scope="module")
def ysd1():
    return load_dense(bundled_ysd1_path(), "dna", 3)


def _models(name, seed=3):
    kw = CNN_KW if name == "cnn" else {}
    jar = jget_ar_func(name, LAG, 4, kw, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    p0[0] = np.asarray(np.log(0.2))  # start off h = 1 so h moves
    ar = get_ar_func(name, LAG, 4, kw, dtype=torch.float64, device="cpu")
    return jar, ar, p0


# (AR, train_ar, batch, epochs, acc_steps, shuffle, optimizer): ~100 applies
CASES = {
    "linear_bear": ("linear", False, 500, 34, 1, False, "Adam"),
    "linear_ar": ("linear", True, 500, 34, 1, False, "Adam"),
    "cnn_bear": ("cnn", False, 500, 34, 1, False, "Adam"),
    "acc_steps_2": ("linear", False, 300, 40, 2, False, "Adam"),
    "shuffle_epochs": ("linear", False, 400, 25, 1, True, "Adam"),
    "sgd": ("linear", False, 700, 50, 1, False, "SGD"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_bear_tpu(ysd1, case):
    name, train_ar, batch, epochs, acc, shuffle, opt = CASES[case]
    jar, ar, p0 = _models(name)
    lr = 1e-6 if opt == "SGD" else 0.01
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=batch, epochs=epochs,
              learning_rate=lr, train_ar=train_ar, acc_steps=acc, shuffle=shuffle,
              optimizer_name=opt, params_restart=p0, seed=10)
    want = jbn.train(ysd1.codes, ysd1.counts[:, 0], ar_func=jar, dtype=jnp.float64, **kw)
    got = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, dtype=torch.float64,
                         device="cpu", **kw)
    assert 90 <= len(got.elbos) == len(want.elbos) <= 110
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-8)
    for g, w in zip(got.params_list, jbn.params_to_list(want.params)):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-10)
    assert got.h == pytest.approx(want.h, rel=1e-7)
    if train_ar:
        assert got.h == 0.2  # the AR likelihood leaves h where it was
    else:
        assert abs(np.log(got.h / 0.2)) > 0.05
    np.testing.assert_array_equal(got.elbos, -got.losses)


def test_restart_with_optimizer_state_continues_exactly(ysd1):
    jar, ar, p0 = _models("linear")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=500, learning_rate=0.01,
              dtype=torch.float64, device="cpu")
    whole = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=4,
                           params_restart=p0, **kw)
    first = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=2,
                           params_restart=p0, **kw)
    assert first.opt_state["name"] == "adam" and first.opt_state["step"] == 6
    second = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=2,
                            params_restart=first.params_list,
                            opt_state_restart=first.opt_state, **kw)
    np.testing.assert_array_equal(np.concatenate([first.elbos, second.elbos]), whole.elbos)
    for a, b in zip(second.params_list, whole.params_list):
        np.testing.assert_array_equal(a, b)


def test_fresh_init_is_seeded(ysd1):
    _, ar, _ = _models("cnn")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=700, epochs=1, dtype=torch.float64,
              device="cpu", seed=4)
    a = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, **kw)
    b = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, **kw)
    np.testing.assert_array_equal(a.elbos, b.elbos)
    init = bear_net.init_params(torch.Generator().manual_seed(4), ar)
    assert float(init["h_signed"]) == 0.0 and len(init["ar"]) == 8


@pytest.fixture(scope="module")
def trained(ysd1):
    """name -> (bear_tpu AR, port AR, bear_tpu TrainResult), trained once."""
    out = {}
    for name in ("linear", "cnn"):
        jar, ar, p0 = _models(name)
        out[name] = (jar, ar, jbn.train(
            ysd1.codes, ysd1.counts[:, 0], ysd1.num_kmers, jar, batch_size=700,
            epochs=20, learning_rate=0.01, params_restart=p0, dtype=jnp.float64))
    return out


@pytest.mark.parametrize("name", ["linear", "cnn"])
@pytest.mark.parametrize("train_loc", [0, -1])
def test_evaluation_matches_bear_tpu(ysd1, trained, name, train_loc):
    jar, ar, res = trained[name]
    ar_params = jbn.params_to_list(res.params)[1:]
    want = jbn.evaluation(ysd1.codes, ysd1.counts, train_loc, 1, "dna", res.h, jar,
                          res.params["ar"], VAN, batch_size=500, dtype=jnp.float64)
    got = bear_net.evaluation(ysd1.codes, ysd1.counts, train_loc, 1, "dna", res.h, ar,
                              ar_params, VAN, batch_size=500, dtype=torch.float64,
                              device="cpu")
    assert len(got) == 9
    for g, w in zip(got[:6], want[:6]):  # log-likelihoods, perplexities
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10)
    # BEAR and AR readings have no tied maxima (continuous AR output).
    assert float(got[6]) == float(want[6]) and float(got[7]) == float(want[7])
    if train_loc >= 0:
        # No YSD1 training row has tied maxima, so the BMM picks agree too.
        assert not _has_ties(ysd1.counts[:, 0])
        np.testing.assert_array_equal(got[8], np.asarray(want[8]))
    else:
        # Prior mode: every letter ties, so each batch of 500 picks one letter
        # for all its rows (a uniform draw): the accuracy is a sum of one
        # letter's count per batch over all counts.
        test = ysd1.counts[:, 1]
        per_batch = [test[i:i + 500].sum(0) for i in range(0, len(test), 500)]
        picks = {sum(c) / test.sum() for c in itertools.product(*per_batch)}
        assert all(any(np.isclose(x, p, rtol=1e-12) for p in picks) for x in got[8])


def _has_ties(counts):
    top = counts.max(-1, keepdims=True)
    return bool(((counts == top).sum(-1) > 1).any())


def test_h_scan_matches_bear_tpu(ysd1, trained):
    jar, ar, res = trained["linear"]
    hs = np.array([0.01, 0.03, 0.1, 0.3])
    ar_params = jbn.params_to_list(res.params)[1:]
    for train_loc in (0, -1):
        want = jbn.h_scan(ysd1.codes, ysd1.counts, train_loc, 1, "dna", hs, jar,
                          res.params["ar"], dtype=jnp.float64)
        got = bear_net.h_scan(ysd1.codes, ysd1.counts, train_loc, 1, "dna", hs, ar,
                              ar_params, dtype=torch.float64, device="cpu")
        assert got[0].shape == (4,)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_evaluation_float32_sums_in_float64(ysd1, trained):
    _, ar, res = trained["linear"]
    out = bear_net.evaluation(ysd1.codes, ysd1.counts, 0, 1, "dna", res.h, ar,
                              jbn.params_to_list(res.params)[1:], VAN, batch_size=100,
                              dtype=torch.float32, device="cpu")
    assert all(np.asarray(o).dtype == np.float64 for o in out)
    ref = bear_net.evaluation(ysd1.codes, ysd1.counts, 0, 1, "dna", res.h, ar,
                              jbn.params_to_list(res.params)[1:], VAN,
                              dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(out[5], ref[5], rtol=1e-5)


def test_arguments_not_ported_raise(ysd1):
    _, ar, p0 = _models("linear")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=700, device="cpu")
    c, n = ysd1.codes, ysd1.counts[:, 0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bear_net.train(c, n, ar_func=ar, mesh=object(), **kw)
    # Reference counts are ported (bear_ref): a plain AR module takes none,
    # and a stream must not mix shards with and without them.
    with pytest.raises(TypeError):
        bear_net.train(c, n, ar_func=ar, ref_counts=n, **kw)
    with pytest.raises(ValueError, match="agree"):
        bear_net.train_streaming(lambda: iter([(c, n), (c, n, n)]), ar_func=ar, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bear_net.train_streaming(lambda: iter([(c, n)]), ar_func=ar, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bear_net.evaluation(c, ysd1.counts, 0, 1, "dna", 0.1, ar, p0[1:], VAN,
                            device="cpu", mesh=object())
    for name in ("adamw", "rmsprop"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bear_net.train(c, n, ar_func=ar, optimizer_name=name, **kw)
    with pytest.raises(ValueError, match="unknown optimizer"):
        bear_net.train(c, n, ar_func=ar, optimizer_name="bogus", **kw)
    with pytest.raises(ValueError, match="acc_steps"):
        bear_net.train(c, n, ar_func=ar, acc_steps=5, **kw)
    with pytest.raises(ValueError, match="empty dataset"):
        bear_net.train(c[:0], n[:0], ar_func=ar, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bear_net.train(c, n, num_kmers=ysd1.num_kmers, ar_func=ar, batch_size=700)
