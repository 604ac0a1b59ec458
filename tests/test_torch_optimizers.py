"""The port's optax update rules (bear_tpu_torch.models.optimizers) against
bear_tpu's optax optimizers, on the YSD1 fixture, on the CPU in float64.

bear_tpu builds each with ``factory(lr, eps=1e-7)`` where the factory takes
eps (bear_tpu/models/bear_net.py:105-117). Both packages start from the
same parameters (bear_tpu's init, carried by ``params_restart``) and see the
same batches. Tolerances: 5 applies' losses and parameters rtol 1e-10 (the
same update in another association); a resumed run equals the
uninterrupted one exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.models import bear_net, optimizers
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)
NAMES = ["adamw", "adamax", "rmsprop", "adagrad", "nadam", "adadelta", "lion"]
CNN_KW = {"num_filters": 6, "filter_width": 3, "kmer_layer1_width": 4}


@pytest.fixture(scope="module")
def ysd1():
    return load_dense(bundled_ysd1_path(), "dna", 3)


def _models(name, seed=3):
    kw = CNN_KW if name == "cnn" else {}
    jar = jget_ar_func(name, 5, 4, kw, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(seed), jar, dtype=jnp.float64))
    p0[0] = np.asarray(np.log(0.2))  # start off h = 1 so h moves
    ar = get_ar_func(name, 5, 4, kw, dtype=torch.float64, device="cpu")
    return jar, ar, p0


@pytest.mark.parametrize("ar_name", ["linear", "cnn"])
@pytest.mark.parametrize("name", NAMES)
def test_five_applies_match_optax(ysd1, name, ar_name):
    jar, ar, p0 = _models(ar_name)
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=300, epochs=1, learning_rate=0.01,
              optimizer_name=name, params_restart=p0, seed=1)
    want = jbn.train(ysd1.codes, ysd1.counts[:, 0], ar_func=jar, dtype=jnp.float64, **kw)
    got = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, dtype=torch.float64,
                         device="cpu", **kw)
    assert len(got.elbos) == len(want.elbos) == 5
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-10)
    moved = 0
    for g, w, p in zip(got.params_list, jbn.params_to_list(want.params), p0):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-15)
        moved += not np.array_equal(g, p)
    assert moved == len(p0)  # every parameter moved, h_signed included
    assert got.opt_state["name"] == name and got.opt_state["step"] == 5


@pytest.mark.parametrize("name", NAMES)
def test_opt_state_restart_continues_exactly(ysd1, tmp_path, name):
    _, ar, p0 = _models("linear")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=500, learning_rate=0.01,
              optimizer_name=name, dtype=torch.float64, device="cpu")
    whole = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=4,
                           params_restart=p0, **kw)
    first = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=2,
                           params_restart=p0, **kw)
    assert first.opt_state["step"] == 6
    # The state is plain numpy: it goes through a results.pickle unchanged.
    checkpoint.save_results(str(tmp_path), first.params_list,
                            extra={"torch_opt_state": first.opt_state})
    saved = checkpoint.load_results(str(tmp_path))
    second = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=2,
                            params_restart=saved["params"],
                            opt_state_restart=saved["torch_opt_state"], **kw)
    np.testing.assert_array_equal(np.concatenate([first.elbos, second.elbos]), whole.elbos)
    for a, b in zip(second.params_list, whole.params_list):
        np.testing.assert_array_equal(a, b)
    for key in optimizers.OPTAX_RULES[name].STATE:
        for a, b in zip(second.opt_state[key], whole.opt_state[key]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="optimizer state"):
        bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, epochs=1,
                       params_restart=p0, opt_state_restart={**first.opt_state,
                                                             "name": "adam"}, **kw)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_dir_resume_is_bit_identical(ysd1, tmp_path, monkeypatch, name):
    _, ar, p0 = _models("cnn")
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=300, epochs=2, learning_rate=0.01,
              optimizer_name=name, params_restart=p0, dtype=torch.float64, device="cpu")
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
    assert resumed.opt_state["step"] == whole.opt_state["step"] == 10
    for key in optimizers.OPTAX_RULES[name].STATE:
        for a, b in zip(resumed.opt_state[key], whole.opt_state[key]):
            np.testing.assert_array_equal(a, b)


def test_a_parameter_without_gradient_is_refused():
    p = torch.zeros(3, requires_grad=True)
    opt = bear_net.make_optimizer("Lion", 0.1, [p])
    assert isinstance(opt, optimizers.Lion)
    with pytest.raises(ValueError, match="no gradient"):
        opt.step()
    p.grad = torch.zeros(3)
    opt.step()  # a zero gradient still moves the state: lion's count
    assert opt.count == 1
