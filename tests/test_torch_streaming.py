"""The port's shard-streamed training and evaluation
(bear_tpu_torch.models.bear_net.train_streaming / evaluation_streaming /
h_scan_streaming) against bear_tpu's, on the YSD1 fixture cut into ragged
shards, on the CPU in float64; and the mid-run train state: a run killed
after a checkpoint and resumed ends bit-identical to one never killed.

Tolerances: ELBOs and parameters rtol 1e-10 (atol 1e-13 for parameters
near 0) against bear_tpu; log-likelihoods and perplexities rtol 1e-10
against bear_tpu and 1e-12 against the port's in-memory evaluation;
accuracies exactly where no row has tied maxima (BEAR and AR always; BMM
when conditioned on the training column, which has no ties).
"""

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
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)
LAG = 5
CUTS = (400, 713)  # ragged shards of 400, 313 and 652 rows
VAN = [0.1, 1.0, 10.0]


@pytest.fixture(scope="module")
def ysd1():
    return load_dense(bundled_ysd1_path(), "dna", 3)


def _shards(ds, column=0, order_by_epoch=False):
    """A shards callable over the fixture cut at CUTS; with order_by_epoch
    it takes the epoch and reverses the shard order on odd epochs."""
    codes = np.split(ds.codes, CUTS)
    counts = np.split(ds.counts if column is None else ds.counts[:, column], CUTS)
    pairs = list(zip(codes, counts))
    if order_by_epoch:
        return lambda epoch: iter(pairs[::-1] if epoch % 2 else pairs)
    return lambda: iter(pairs)


def _models(name, seed=3):
    kw = {"num_filters": 12, "filter_width": 3, "kmer_layer1_width": 8} if name == "cnn" else {}
    jar = jget_ar_func(name, LAG, 4, kw, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    p0[0] = np.asarray(np.log(0.2))
    return jar, get_ar_func(name, LAG, 4, kw, dtype=torch.float64, device="cpu"), p0


# (AR, batch, epochs, acc_steps, shuffle, epoch-aware shard order)
CASES = {
    "ragged": ("linear", 128, 2, 1, False, False),
    "acc_steps_3_across_shards": ("linear", 100, 2, 3, False, False),
    "shuffle": ("linear", 150, 3, 1, True, False),
    "epoch_aware_order": ("linear", 128, 3, 2, True, True),
    "cnn": ("cnn", 256, 2, 1, True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_streaming_matches_bear_tpu(ysd1, case):
    name, batch, epochs, acc, shuffle, by_epoch = CASES[case]
    jar, ar, p0 = _models(name)
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=batch, epochs=epochs, learning_rate=0.01,
              acc_steps=acc, shuffle=shuffle, params_restart=p0, seed=11)
    shards = _shards(ysd1, order_by_epoch=by_epoch)
    want = jbn.train_streaming(shards, ar_func=jar, dtype=jnp.float64, block_steps=8, **kw)
    got = bear_net.train_streaming(shards, ar_func=ar, dtype=torch.float64, device="cpu", **kw)
    batches = sum(-(-n // batch) for n in (400, 313, 652))
    assert len(got.elbos) == len(want.elbos) == batches * epochs // acc
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-10)
    for g, w in zip(got.params_list, jbn.params_to_list(want.params)):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13)
    assert got.opt_state["step"] == len(got.elbos)


def test_streaming_equals_in_memory_training_on_aligned_shards(ysd1):
    _, ar, p0 = _models("linear")
    n = 1300  # shards of whole batches: the same batches as the in-memory run
    codes, counts = ysd1.codes[:n], ysd1.counts[:n, 0]
    kw = dict(num_kmers=n, batch_size=100, epochs=2, learning_rate=0.01,
              params_restart=p0, dtype=torch.float64, device="cpu")
    streamed = bear_net.train_streaming(
        lambda: iter([(codes[:500], counts[:500]), (codes[500:], counts[500:])]),
        ar_func=ar, **kw)
    whole = bear_net.train(codes, counts, ar_func=ar, **kw)
    np.testing.assert_array_equal(streamed.elbos, whole.elbos)
    for a, b in zip(streamed.params_list, whole.params_list):
        np.testing.assert_array_equal(a, b)


class _Killed(Exception):
    pass


def _dies_after(shards, k):
    """shards, but the k-th shard yielded (over all epochs) raises instead."""
    seen = [0]

    def gen(epoch):
        for shard in shards(epoch):
            seen[0] += 1
            if seen[0] == k:
                raise _Killed
            yield shard

    return gen


def test_streaming_resume_is_bit_identical(ysd1, tmp_path):
    _, ar, p0 = _models("linear")
    shards = _shards(ysd1, order_by_epoch=True)
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=100, epochs=3, learning_rate=0.01,
              acc_steps=2, shuffle=True, seed=4, params_restart=p0, dtype=torch.float64,
              device="cpu", block_steps=4, checkpoint_every=3)
    whole = bear_net.train_streaming(shards, ar_func=ar, **kw)
    with pytest.raises(_Killed):
        bear_net.train_streaming(_dies_after(shards, 5), ar_func=ar,
                                 checkpoint_dir=str(tmp_path), **kw)
    state = checkpoint.load_train_state(str(tmp_path))
    assert state["applies_done"] % 4 == 0 and 0 < state["applies_done"] < len(whole.elbos)
    resumed = bear_net.train_streaming(shards, ar_func=ar, checkpoint_dir=str(tmp_path), **kw)
    assert len(resumed.elbos) == len(whole.elbos) - state["applies_done"]
    np.testing.assert_array_equal(resumed.elbos, whole.elbos[state["applies_done"]:])
    for a, b in zip(resumed.params_list, whole.params_list):
        np.testing.assert_array_equal(a, b)
    for key in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(resumed.opt_state[key], whole.opt_state[key]):
            np.testing.assert_array_equal(a, b)
    assert resumed.opt_state["step"] == whole.opt_state["step"] == len(whole.elbos)
    assert checkpoint.load_train_state(str(tmp_path))["applies_done"] == len(whole.elbos)


def test_train_checkpoint_resume_is_bit_identical(ysd1, tmp_path, monkeypatch):
    _, ar, p0 = _models("cnn")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=300, epochs=4, learning_rate=0.01,
              acc_steps=2, shuffle=True, params_restart=p0, dtype=torch.float64,
              device="cpu")
    whole = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, **kw)
    real = bear_net._save_state
    saves = []

    def dies_after_the_second_save(*args):
        real(*args)
        saves.append(args[-1])
        if len(saves) == 2:
            raise _Killed

    monkeypatch.setattr(bear_net, "_save_state", dies_after_the_second_save)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    with pytest.raises(_Killed):
        bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, **ck, **kw)
    assert saves == [3, 6]
    monkeypatch.setattr(bear_net, "_save_state", real)
    resumed = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, **ck, **kw)
    np.testing.assert_array_equal(resumed.elbos, whole.elbos[6:])
    for a, b in zip(resumed.params_list, whole.params_list):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(resumed.opt_state["exp_avg_sq"], whole.opt_state["exp_avg_sq"]):
        np.testing.assert_array_equal(a, b)
    state = checkpoint.load_train_state(str(tmp_path))
    assert state["applies_done"] == len(whole.elbos) == 10
    checkpoint.clear_train_state(str(tmp_path))
    assert checkpoint.load_train_state(str(tmp_path)) is None
    checkpoint.clear_train_state(str(tmp_path))  # a second clear is a no-op


def test_foreign_train_state_refused(tmp_path):
    checkpoint.save_train_state(str(tmp_path), {"params": [], "opt_state": (),
                                                "applies_done": 3})
    with pytest.raises(ValueError, match="torch_opt_state"):
        checkpoint.load_train_state(str(tmp_path))


@pytest.fixture(scope="module")
def trained(ysd1):
    jar, ar, p0 = _models("linear")
    res = jbn.train(ysd1.codes, ysd1.counts[:, 0], ysd1.num_kmers, jar, batch_size=700,
                    epochs=20, learning_rate=0.01, params_restart=p0, dtype=jnp.float64)
    return jar, ar, res


@pytest.mark.parametrize("train_loc", [0, -1])
def test_evaluation_streaming_matches_bear_tpu_and_in_memory(ysd1, trained, train_loc):
    jar, ar, res = trained
    ar_params = jbn.params_to_list(res.params)[1:]
    shards = _shards(ysd1, column=None)
    want = jbn.evaluation_streaming(shards, train_loc, 1, "dna", res.h, jar,
                                    res.params["ar"], VAN, batch_size=128,
                                    dtype=jnp.float64, block_steps=2)
    got = bear_net.evaluation_streaming(shards, train_loc, 1, "dna", res.h, ar, ar_params,
                                        VAN, batch_size=128, dtype=torch.float64,
                                        block_steps=2, device="cpu")
    memory = bear_net.evaluation(ysd1.codes, ysd1.counts, train_loc, 1, "dna", res.h, ar,
                                 ar_params, VAN, batch_size=128, dtype=torch.float64,
                                 device="cpu")
    assert len(got) == 9 and all(np.asarray(g).dtype == np.float64 for g in got)
    for g, w, m in zip(got[:6], want[:6], memory[:6]):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10)
        np.testing.assert_allclose(g, m, rtol=1e-12)
    for i in (6, 7) if train_loc < 0 else (6, 7, 8):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        np.testing.assert_array_equal(got[i], memory[i])


def test_streamed_ties_follow_the_global_batch_index(ysd1, trained):
    """Prior mode ties every letter of the BMM reading: shards that cut at
    whole batches draw the in-memory run's tie-breaks exactly."""
    _, ar, res = trained
    ar_params = jbn.params_to_list(res.params)[1:]
    n = 1280
    codes, counts = ysd1.codes[:n], ysd1.counts[:n]
    shards = lambda: iter([(codes[:512], counts[:512]), (codes[512:], counts[512:])])  # noqa: E731
    kw = dict(batch_size=128, dtype=torch.float64, device="cpu", seed=5)
    got = bear_net.evaluation_streaming(shards, -1, 0, "dna", res.h, ar, ar_params, VAN,
                                        **kw)
    memory = bear_net.evaluation(codes, counts, -1, 0, "dna", res.h, ar, ar_params, VAN, **kw)
    np.testing.assert_array_equal(got[8], memory[8])
    np.testing.assert_allclose(got[5], memory[5], rtol=1e-12)


def test_h_scan_streaming_matches_bear_tpu(ysd1, trained):
    jar, ar, res = trained
    ar_params = jbn.params_to_list(res.params)[1:]
    hs = np.array([0.01, 0.03, 0.1, 0.3])
    shards = _shards(ysd1, column=None)
    for train_loc in (0, -1):
        want = jbn.h_scan_streaming(shards, train_loc, 1, "dna", hs, jar, res.params["ar"],
                                    dtype=jnp.float64, batch_size=256)
        got = bear_net.h_scan_streaming(shards, train_loc, 1, "dna", hs, ar, ar_params,
                                        dtype=torch.float64, batch_size=256, device="cpu")
        memory = bear_net.h_scan(ysd1.codes, ysd1.counts, train_loc, 1, "dna", hs, ar,
                                 ar_params, dtype=torch.float64, device="cpu")
        assert got[0].shape == (4,)
        for i in (0, 1):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-10)
            np.testing.assert_allclose(got[i], memory[i], rtol=1e-12)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_streaming_refusals(ysd1):
    _, ar, p0 = _models("linear")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=100, device="cpu")
    # Shards carrying reference counts are ported (bear_ref); a stream must
    # not mix shards with and without them.
    three = lambda: iter([(ysd1.codes, ysd1.counts[:, 0]),  # noqa: E731
                          (ysd1.codes, ysd1.counts[:, 0], ysd1.counts[:, 1])])
    with pytest.raises(ValueError, match="agree"):
        bear_net.train_streaming(three, ar_func=ar, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bear_net.train_streaming(_shards(ysd1), ar_func=ar, mesh=object(), **kw)
    with pytest.raises(ValueError, match="agree"):
        bear_net.evaluation_streaming(
            lambda: iter([(ysd1.codes, ysd1.counts), (ysd1.codes, ysd1.counts,
                                                      ysd1.counts[:, 0])]), 0, 1, "dna",
            0.1, ar, p0[1:], VAN, device="cpu")
    with pytest.raises(ValueError, match="no shards"):
        bear_net.train_streaming(lambda: iter([]), ar_func=ar, **kw)
    with pytest.raises(ValueError, match="acc_steps"):
        bear_net.train_streaming(_shards(ysd1), ar_func=ar, acc_steps=100, **kw)
    with pytest.raises(ValueError, match="no shards"):
        bear_net.evaluation_streaming(lambda: iter([]), 0, 1, "dna", 0.1, ar, p0[1:], VAN,
                                      device="cpu")
    ragged_lag = lambda: iter([(ysd1.codes, ysd1.counts[:, 0]),  # noqa: E731
                               (ysd1.codes[:, 1:], ysd1.counts[:, 0])])
    with pytest.raises(ValueError, match="shard lag"):
        bear_net.train_streaming(ragged_lag, ar_func=ar, **kw)
