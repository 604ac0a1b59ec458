"""The port's attention AR function (bear_tpu_torch.models.ar_funcs.AttentionAR)
against bear_tpu's, on the CPU in float64, from the same parameters
(bear_tpu's init carried as numpy, with a nonzero positional encoding).

Tolerances: values rtol 1e-10 (the frameworks sum the same products in
another order); gradients rtol 1e-9; ``apply_codes`` against ``forward`` of
the one-hot rtol 1e-12 (the same embedding, gathered by a one-hot product);
5 training applies rtol 1e-10; MAP scores from a model directory rtol 1e-10;
the training CLI's [results] on bear_attn_bear.cfg rtol 1e-10.
"""

import configparser
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.data import load_dense as jload_dense
from bear_tpu.inference import scoring as jscoring
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.models import train_bear_net as jcli
from bear_tpu.ops import alphabets as jalph
from bear_tpu.utils import checkpoint as jckpt
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.inference import scoring
from bear_tpu_torch.inference.scoring import load_bear
from bear_tpu_torch.models import bear_net, train_bear_net
from bear_tpu_torch.models.ar_funcs import AttentionAR, get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils import checkpoint
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)
KW = {"d_model": 16, "num_heads": 2, "mlp_width": 32}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "bear_tpu", "models", "config_files")


def _setup(seed, lag, A, n=64, kw=KW):
    """bear_tpu's attention AR and its parameters (pos drawn nonzero), the
    port's, and seeded codes [n, lag] over all A+1 symbols."""
    jar = jget_ar_func("attention", lag, A, kw, dtype=jnp.float64)
    params = [np.asarray(p) for p in jar.init(jax.random.key(seed))]
    rng = np.random.default_rng(seed)
    params[1] = 0.5 * rng.normal(size=params[1].shape)
    codes = rng.integers(0, A + 1, size=(n, lag)).astype(np.int8)
    ar = get_ar_func("attention", lag, A, kw, dtype=torch.float64, device="cpu")
    return jar, params, codes, ar


@pytest.mark.parametrize("A", [4, 20])
def test_attention_init_shapes_match_bear_tpu(A):
    jar, params, _, ar = _setup(0, 5, A)
    fresh = ar.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in fresh] == [p.shape for p in params]
    assert [tuple(p.shape) for p in ar.params_list()] == [p.shape for p in params]
    # bear_tpu's init: l2-normalised columns scaled by 0.05, zero pos and
    # biases, wqkv/wo/w1 of scale 1/sqrt(d_model).
    for i in (0, 6, 8):
        np.testing.assert_allclose((fresh[i] ** 2).sum(dim=0).numpy(), 0.05 ** 2, rtol=1e-12)
    for i in (1, 5, 7, 9):
        assert not fresh[i].any()
    assert abs(float(fresh[2].std()) * np.sqrt(KW["d_model"]) - 1) < 0.2
    with pytest.raises(ValueError, match="num_heads"):
        AttentionAR(5, 4, d_model=10, num_heads=4, device="cpu")


@pytest.mark.parametrize("lag", [1, 5, 13])
@pytest.mark.parametrize("A", [4, 20])
def test_attention_values_match(lag, A):
    jar, params, codes, ar = _setup(lag + A, lag, A)
    oh = np.asarray(jalph.one_hot(codes, A + 1, jnp.float64))
    jp = [jnp.asarray(p) for p in params]
    want = np.asarray(jax.jit(jar.apply)(jp, oh))
    want_codes = np.asarray(jax.jit(jar.apply_codes)(jp, codes))
    tp = [torch.tensor(p) for p in params]
    got = ar(torch.tensor(oh), tp)
    got_codes = ar.apply_codes(torch.tensor(codes), tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), want_codes, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), got.numpy(), rtol=1e-12)
    # Leading axes and the module's own parameters, once loaded.
    ar.load_params(params)
    lead = ar.apply_codes(torch.tensor(codes).reshape(4, -1, lag)).detach()
    assert lead.shape == (4, len(codes) // 4, A + 1)
    np.testing.assert_allclose(lead.reshape(-1, A + 1).numpy(), want_codes, rtol=1e-10)


@pytest.mark.parametrize("path", ["forward", "apply_codes"])
def test_attention_gradients_match(path):
    jar, params, codes, ar = _setup(2, 7, 4)
    w = np.random.default_rng(3).normal(size=(len(codes), 5))
    oh = np.asarray(jalph.one_hot(codes, 5, jnp.float64))
    if path == "forward":
        jf = lambda p: jnp.sum(jnp.log(jar.apply(p, oh)) * w)  # noqa: E731
        x, fn = torch.tensor(oh), ar.forward
    else:
        jf = lambda p: jnp.sum(jnp.log(jar.apply_codes(p, codes)) * w)  # noqa: E731
        x, fn = torch.tensor(codes), ar.apply_codes
    want = jax.jit(jax.grad(jf))([jnp.asarray(p) for p in params])
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    (torch.log(fn(x, tp)) * torch.tensor(w)).sum().backward()
    for g, wg in zip(tp, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wg), rtol=1e-9, atol=1e-14)


def test_attention_position_sensitivity():
    """Mirror of tests/test_ar_funcs.py::test_attention_position_sensitivity:
    with a nonzero positional encoding the block tells apart contexts with
    the same letters and the same last letter; at the zero init it cannot."""
    jar, params, _, ar = _setup(1, 4, 4, kw={"d_model": 32, "num_heads": 2})
    a = alphabets.one_hot_kmers(np.array(["ACGT"]), "dna", torch.float64)
    b = alphabets.one_hot_kmers(np.array(["CAGT"]), "dna", torch.float64)
    tp = [torch.tensor(p) for p in params]
    assert not np.allclose(ar(a, tp).numpy(), ar(b, tp).numpy())
    np.testing.assert_allclose(
        ar(a, tp).numpy(), np.asarray(jar.apply([jnp.asarray(p) for p in params],
                                                jnp.asarray(a.numpy()))), rtol=1e-10)
    tp[1] = torch.zeros_like(tp[1])
    np.testing.assert_allclose(ar(a, tp).numpy(), ar(b, tp).numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def ysd1():
    return load_dense(bundled_ysd1_path(), "dna", 3)


@pytest.mark.parametrize("train_ar", [False, True])
def test_attention_training_matches_bear_tpu(ysd1, train_ar):
    jar = jget_ar_func("attention", 5, 4, KW, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(3), jar, dtype=jnp.float64))
    p0[0] = np.asarray(np.log(0.2))
    kw = dict(num_kmers=ysd1.num_kmers, batch_size=300, epochs=1, learning_rate=0.01,
              train_ar=train_ar, params_restart=p0, seed=1)
    want = jbn.train(ysd1.codes, ysd1.counts[:, 0], ar_func=jar, dtype=jnp.float64, **kw)
    ar = get_ar_func("attention", 5, 4, KW, dtype=torch.float64, device="cpu")
    got = bear_net.train(ysd1.codes, ysd1.counts[:, 0], ar_func=ar, dtype=torch.float64,
                         device="cpu", **kw)
    assert len(got.elbos) == len(want.elbos) == 5
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-10)
    for g, w in zip(got.params_list, jbn.params_to_list(want.params)):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-15)


def _attention_dir(tmp_path, lag=5, seed=4):
    """A model directory (bear_attn_bear.cfg, float64) holding bear_tpu's
    attention parameters with a nonzero pos, and those parameters."""
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, "bear_attn_bear.cfg"))
    cfg["hyperp"]["lag"] = str(lag)
    cfg["model"]["af_kwargs"] = json.dumps(KW)
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)
    jar = jget_ar_func("attention", lag, 4, KW, dtype=jnp.float64)
    params = [np.asarray(p) for p in jar.init(jax.random.key(seed))]
    params[1] = 0.3 * np.random.default_rng(seed).normal(size=params[1].shape)
    jckpt.save_results(str(tmp_path), [np.asarray(-1.7)] + params)
    return str(tmp_path), params


@pytest.mark.parametrize("double_softmax", [True, False])
def test_attention_model_dir_loads_and_scores(tmp_path, double_softmax):
    path, _ = _attention_dir(tmp_path)
    jl = jscoring.load_bear(path, double_softmax=double_softmax)
    pl = load_bear(path, double_softmax=double_softmax, device="cpu")
    assert pl[:3] == jl[:3]
    codes = np.random.default_rng(5).integers(0, 5, size=(80, 5)).astype(np.int8)
    oh = np.asarray(jalph.one_hot(codes, 5, jnp.float64))
    np.testing.assert_allclose(pl[3](torch.tensor(oh)).numpy(),
                               np.asarray(jl[3](jnp.asarray(oh))), rtol=1e-10)
    # MAP scores of whole sequences through the score path.
    seqs = ["ACGTACGTTTGACA", "TTTAT", "GATTACAGATTACA", "CCGTAG"]
    want = jscoring.get_bear_probs_seqs(path, seqs, 0, lag=5, alphabet_name="dna",
                                        data=jload_dense(bundled_ysd1_path(), "dna", 3),
                                        vans=[1.0], get_map=True)
    got = scoring.get_bear_probs_seqs(path, seqs, 0, lag=5, alphabet_name="dna",
                                      data=load_dense(bundled_ysd1_path(), "dna", 3),
                                      vans=[1.0], get_map=True, device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10)


def _config(out_folder, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(CONFIGS, "bear_attn_bear.cfg"))
    cfg["general"]["out_folder"] = str(out_folder) + "*"
    cfg["data"]["files_path"] = "TEST"
    for key, value in overrides.items():
        section, option = key.split("__")
        cfg[section][option] = str(value)
    return cfg


def test_attention_cli_matches_bear_tpu(tmp_path):
    """bear_attn_bear.cfg (its widths: d_model 64, 4 heads, mlp 128) through
    both training CLIs for 5 applies from the same bear_tpu-initialised
    parameters, then the written model directory scored by the port."""
    jar = jget_ar_func("attention", 5, 4, {"d_model": 64, "num_heads": 4, "mlp_width": 128},
                       dtype=jnp.float64)
    init = tmp_path / "init"
    init.mkdir()
    jckpt.save_results(str(init), jbn.params_to_list(
        jbn.init_params(jax.random.key(10), jar, dtype=jnp.float64)))
    kw = dict(train__epochs=5, train__restart=True, train__restart_path=init)
    jret = jcli.main(_config(tmp_path / "jax", **kw))
    pret = train_bear_net.main(_config(tmp_path / "port", **kw), device="cpu")
    np.testing.assert_allclose(pret[1], jret[1], rtol=1e-10)
    np.testing.assert_allclose(pret[2], jret[2], rtol=1e-10)
    want, got = configparser.ConfigParser(), configparser.ConfigParser()
    want.read(tmp_path / "jax" / "config.cfg")
    got.read(tmp_path / "port" / "config.cfg")
    keys = set(want["results"]) - {"out_folder", "file", "accuracy_bmm"}
    assert keys == set(got["results"]) - {"out_folder", "file", "accuracy_bmm"}
    assert len(keys) == 18
    for key in sorted(keys):
        np.testing.assert_allclose(np.asarray(json.loads(got["results"][key])),
                                   np.asarray(json.loads(want["results"][key])),
                                   rtol=1e-10, err_msg=key)
    pres = checkpoint.load_results(str(tmp_path / "port"))
    for g, w in zip(pres["params"], jckpt.load_results(str(tmp_path / "jax"))["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-15)
    assert pres["torch_opt_state"]["step"] == 5
    lag, _, h, ar_apply, _ = load_bear(str(tmp_path / "port"), device="cpu")
    assert lag == 5 and h == pytest.approx(float(got["results"]["h"]), rel=1e-15)
    probs = ar_apply(alphabets.one_hot_kmers(np.array(["ACGTA", "TTTAT"]), "dna",
                                             torch.float64))
    assert probs.shape == (2, 5) and torch.isfinite(probs).all()
