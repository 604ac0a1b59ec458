"""Mixed precision in the port (``compute_dtype``, ``[model]
compute_precision``) against bear_tpu's, on the CPU.

bfloat16 keeps ~2-3 significant digits, so the bfloat16 outputs are held to
float32's and to bear_tpu's bfloat16 outputs within atol 0.03 (probabilities
of O(0.2); tests/test_ar_funcs.py's tolerance), the sum of the
probabilities to 1 within 1e-5 (a float32 softmax), and a bfloat16 training
run's last loss to float32's within 1% (tests/test_ar_funcs.py:244).
"""

import configparser
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import bear_net as jbn
from bear_tpu.models import bear_ref as jbear_ref
from bear_tpu.models import train_bear_net as jcli
from bear_tpu.models import train_bear_ref as jref_cli
from bear_tpu.models.ar_funcs import AR_FUNCS as JAR_FUNCS
from bear_tpu.utils.config import RunConfig as JRunConfig
from bear_tpu_torch.models import bear_net, bear_ref, train_bear_net, train_bear_ref
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils.config import RunConfig

torch.set_num_threads(2)
KWARGS = {"linear": {}, "cnn": {"filter_width": 3, "num_filters": 8},
          "attention": {"d_model": 16, "num_heads": 2, "mlp_width": 32}}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "bear_tpu", "models", "config_files")


@pytest.mark.parametrize("name", list(KWARGS))
def test_bfloat16_compute_close_to_float32_and_bear_tpu(name):
    """Mirror of tests/test_ar_funcs.py::test_compute_dtype_bfloat16_close_to_
    full_precision, with bear_tpu's bfloat16 outputs beside float32's."""
    rng = np.random.default_rng(7)
    lag, A = 7, 4
    codes = rng.integers(0, A, (64, lag)).astype(np.int8)
    jar16 = JAR_FUNCS[name](lag, A, **KWARGS[name], dtype=jnp.float32,
                            compute_dtype=jnp.bfloat16)
    params = [np.asarray(p) for p in jar16.init(jax.random.key(1))]
    if name == "attention":
        params[1] = (0.3 * rng.normal(size=params[1].shape)).astype(np.float32)
    want16 = np.asarray(jax.jit(jar16.apply_codes)([jnp.asarray(p) for p in params], codes))
    ar32 = get_ar_func(name, lag, A, KWARGS[name], dtype=torch.float32, device="cpu")
    ar16 = get_ar_func(name, lag, A, KWARGS[name], dtype=torch.float32,
                       compute_dtype=torch.bfloat16, device="cpu")
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    tc = torch.from_numpy(codes)
    p32 = ar32.apply_codes(tc, tp).detach().numpy()
    p16t = ar16.apply_codes(tc, tp)
    assert p16t.dtype == torch.float32
    p16 = p16t.detach().numpy()
    np.testing.assert_allclose(p16.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(p16, p32, atol=0.03)
    np.testing.assert_allclose(p16, want16, atol=0.03)
    # The one-hot and codes paths agree under mixed precision too.
    oh = alphabets.one_hot(tc, A + 1, torch.float32)
    np.testing.assert_allclose(ar16(oh, tp).detach().numpy(), p16, atol=0.02)
    # Gradients reach the master parameters in their own type.
    torch.log(p16t + 1e-7).sum().backward()
    for p in tp:
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("name", list(KWARGS))
def test_bfloat16_compute_trains(name):
    """Mirror of tests/test_ar_funcs.py::test_compute_dtype_trains: a short
    bfloat16 run moves the loss as the float32 run does, and ends within 1%
    of it and of bear_tpu's bfloat16 run from the same start."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, (128, 6)).astype(np.int8)
    counts = rng.poisson(4.0, (128, 5)).astype(np.float32)
    jar = JAR_FUNCS[name](6, 4, **KWARGS[name], compute_dtype=jnp.bfloat16)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(3), jar))
    kw = dict(num_kmers=128, batch_size=64, epochs=30, learning_rate=0.01, params_restart=p0)
    want16 = jbn.train(codes, counts, ar_func=jar, **kw)

    def run(compute_dtype):
        ar = get_ar_func(name, 6, 4, KWARGS[name], compute_dtype=compute_dtype, device="cpu")
        return bear_net.train(codes, counts, ar_func=ar, device="cpu", **kw)

    r32, r16 = run(None), run(torch.bfloat16)
    assert np.isfinite(r16.losses).all() and r16.losses[-1] < r16.losses[0]
    assert all(p.dtype == torch.float32 for p in r16.params["ar"])
    np.testing.assert_allclose(r16.losses[-1], r32.losses[-1], rtol=1e-2)
    np.testing.assert_allclose(r16.losses[-1], want16.losses[-1], rtol=1e-2)


def test_ref_train_bfloat16_compute():
    """Mirror of tests/test_bear_ref.py::test_ref_train_bfloat16_compute:
    mixed precision reaches the inner net of the reference-guided mixture."""
    rng = np.random.default_rng(4)
    n = 96
    codes = rng.integers(0, 4, (n, 6)).astype(np.int8)
    counts = rng.poisson(8.0, (n, 5)).astype(np.float32)
    ref_col = counts + rng.poisson(1.0, (n, 5))
    jar = jbear_ref.make_ref_ar_func(6, 4, JAR_FUNCS["cnn"], KWARGS["cnn"],
                                     compute_dtype=jnp.bfloat16)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(2), jar))
    kw = dict(batch_size=48, epochs=25, learning_rate=0.02, params_restart=p0)
    want16 = jbear_ref.train(codes, counts, ref_col, n, JAR_FUNCS["cnn"], KWARGS["cnn"],
                             compute_dtype=jnp.bfloat16, **kw)

    def run(cd):
        return bear_ref.train(codes, counts, ref_col, n, "cnn", KWARGS["cnn"],
                              dtype=torch.float32, compute_dtype=cd, device="cpu", **kw)

    r32, r16 = run(None), run(torch.bfloat16)
    assert np.isfinite(r16.losses).all() and r16.losses[-1] < r16.losses[0]
    np.testing.assert_allclose(r16.losses[-1], r32.losses[-1], rtol=1e-2)
    np.testing.assert_allclose(r16.losses[-1], want16.losses[-1], rtol=1e-2)
    ar = bear_ref.make_ref_ar("cnn", 6, 4, KWARGS["cnn"], compute_dtype=torch.bfloat16,
                              device="cpu")
    assert ar.net.compute_dtype == torch.bfloat16


def _config(name, out_folder, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, name))
    cfg["general"]["out_folder"] = str(out_folder) + "*"
    for key, value in overrides.items():
        section, option = key.split("__")
        cfg[section][option] = str(value)
    return cfg


@pytest.mark.parametrize("cli", ["train_bear_net", "train_bear_ref"])
def test_cli_bfloat16_compute(tmp_path, cli):
    """Mirror of tests/test_run_cli.py::test_run_net_bfloat16_compute, for
    both training CLIs: finite results, and the BMM column (which does not
    depend on the AR network) equal to bear_tpu's."""
    kw = dict(general__precision="float32", model__compute_precision="bfloat16",
              train__epochs=30)
    port, jax_cli = {"train_bear_net": (train_bear_net, jcli),
                     "train_bear_ref": (train_bear_ref, jref_cli)}[cli]
    cfg = _config("bear_test.cfg", tmp_path / "port", **kw)
    ret = port.main(cfg, device="cpu")
    assert ret[0] == 1
    assert np.isfinite(float(cfg["results"]["h"]))
    assert np.isfinite(float(cfg["results"]["heldout_perplex_BEAR"]))
    jret = jax_cli.main(_config("bear_test.cfg", tmp_path / "jax", **kw))
    np.testing.assert_allclose(ret[1], jret[1], rtol=1e-4)
    np.testing.assert_allclose(ret[2], jret[2], rtol=1e-4)


@pytest.mark.parametrize("value,want", [("", None), ("none", None),
                                        ("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32), ("float16", ValueError)])
def test_compute_precision_values(tmp_path, value, want):
    cfg = _config("bear_test.cfg", tmp_path, model__compute_precision=value)
    run = RunConfig.from_configparser(cfg)
    jrun = JRunConfig.from_configparser(cfg)
    if want is ValueError:
        with pytest.raises(ValueError) as got:
            run.compute_dtype()
        with pytest.raises(ValueError) as jgot:
            jrun.compute_dtype()
        assert str(got.value) == str(jgot.value)
    else:
        assert run.compute_dtype() == want
        assert (jrun.compute_dtype() is None) == (want is None)
