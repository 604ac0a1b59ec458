"""The port's CNN and stop AR functions against bear_tpu's, on the CPU in
float64, from the same parameters (bear_tpu's init, carried as numpy).

Tolerances: values and gradients rtol 1e-10 (the frameworks sum the same
products in another order); ``apply_codes`` against ``forward`` of the
one-hot rtol 1e-12 (the same sums, banded or windowed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.ops import alphabets as jalph
from bear_tpu_torch.models.ar_funcs import CNNAR, StopAR, get_ar_func
from bear_tpu_torch.ops import alphabets

torch.set_num_threads(2)
LAG = 9
KW = {"filter_width": 4, "num_filters": 12, "kmer_layer1_width": 10}


def _setup(seed, n=200, alphabet="dna", kw=KW, lag=LAG):
    A = alphabets.alphabet_size(alphabet)
    jar = jget_ar_func("cnn", lag, A, kw, dtype=jnp.float64)
    params = [np.asarray(p) for p in jar.init(jax.random.key(seed))]
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, A + 1, size=(n, lag)).astype(np.int8)
    ar = get_ar_func("cnn", lag, A, kw, dtype=torch.float64, device="cpu")
    return jar, params, codes, ar, A


def _tparams(params):
    return [torch.tensor(p, requires_grad=True) for p in params]


@pytest.mark.parametrize("seed,alphabet", [(0, "dna"), (1, "prot")])
def test_cnn_values_match(seed, alphabet):
    jar, params, codes, ar, A = _setup(seed, alphabet=alphabet)
    oh = np.asarray(jalph.one_hot(codes, A + 1, jnp.float64))
    want = np.asarray(jax.jit(jar.apply)(params, oh))
    want_codes = np.asarray(jax.jit(jar.apply_codes)(params, codes))
    tp = [torch.tensor(p) for p in params]
    got = ar(torch.tensor(oh), tp)
    got_codes = ar.apply_codes(torch.tensor(codes), tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), want_codes, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), got.numpy(), rtol=1e-12)
    # The module's own parameters, once loaded, give the same.
    ar.load_params(params)
    np.testing.assert_allclose(ar.apply_codes(torch.tensor(codes)).detach().numpy(),
                               want_codes, rtol=1e-10)
    assert [tuple(p.shape) for p in ar.params_list()] == [p.shape for p in params]


@pytest.mark.parametrize("path", ["forward", "apply_codes"])
def test_cnn_gradients_match(path):
    jar, params, codes, ar, A = _setup(2)
    w = np.random.default_rng(3).normal(size=(len(codes), A + 1))
    oh = np.asarray(jalph.one_hot(codes, A + 1, jnp.float64))
    if path == "forward":
        jf = lambda p: jnp.sum(jnp.log(jar.apply(p, oh)) * w)  # noqa: E731
        x = torch.tensor(oh)
        fn = ar.forward
    else:
        jf = lambda p: jnp.sum(jnp.log(jar.apply_codes(p, codes)) * w)  # noqa: E731
        x = torch.tensor(codes)
        fn = ar.apply_codes
    want = jax.jit(jax.grad(jf))([jnp.asarray(p) for p in params])
    tp = _tparams(params)
    (torch.log(fn(x, tp)) * torch.tensor(w)).sum().backward()
    for g, wg in zip(tp, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wg), rtol=1e-10, atol=1e-14)


def test_cnn_lead_shape_and_refusals():
    jar, params, codes, ar, A = _setup(4, n=24)
    tp = [torch.tensor(p) for p in params]
    got = ar.apply_codes(torch.tensor(codes).reshape(2, 12, LAG), tp)
    want = np.asarray(jax.jit(jar.apply_codes)(params, codes.reshape(2, 12, LAG)))
    assert got.shape == (2, 12, A + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    with pytest.raises(ValueError, match="filter_width"):
        CNNAR(3, 4, filter_width=4, device="cpu")
    with pytest.raises(ValueError, match="parameter arrays"):
        ar.load_params(params[:-1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_ar_func("attention", LAG, 4, device="cpu")
    with pytest.raises(ValueError, match="af_kwargs"):
        get_ar_func("stop", LAG, 4, {"num_filters": 3}, device="cpu")


def test_cnn_init_shapes_match_bear_tpu():
    jar, params, _, ar, _ = _setup(5)
    fresh = ar.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in fresh] == [p.shape for p in params]
    # The normalisations of bear_tpu's init hold for the port's draw too.
    np.testing.assert_allclose((fresh[0] ** 2).sum(dim=(0, 1)).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((fresh[2] ** 2).sum(dim=0).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((fresh[4] ** 2).sum(dim=0).numpy(), 0.05 ** 2, rtol=1e-12)
    for got, want in zip(fresh[1:2] + fresh[3:4] + fresh[5:], params[1:2] + params[3:4] + params[5:]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_stop_matches():
    jar = jget_ar_func("stop", LAG, 4, dtype=jnp.float64)
    ar = get_ar_func("stop", LAG, 4, dtype=torch.float64, device="cpu")
    assert isinstance(ar, StopAR) and ar.params_list() == [] and ar.init() == []
    codes = np.random.default_rng(6).integers(0, 5, size=(7, LAG)).astype(np.int8)
    oh = np.asarray(jalph.one_hot(codes, 5, jnp.float64))
    np.testing.assert_array_equal(ar.apply_codes(torch.tensor(codes)).numpy(),
                                  np.asarray(jar.apply_codes([], codes)))
    np.testing.assert_array_equal(ar(torch.tensor(oh)).numpy(), np.asarray(jar.apply([], oh)))
