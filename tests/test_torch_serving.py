"""The port's AR function, model loading and MAP serving
(bear_tpu_torch.models / .inference) against bear_tpu's, on the CPU.

Parameters are initialised by bear_tpu (JAX) and carried across through the
checkpoint list ``[h_signed] + ar``, never initialised twice. Tolerances:
float64 scores rtol 1e-10 (the two frameworks sum the same terms in another
order); float32 rtol 1e-5 (float32 rounding over a few dozen log terms).
"""

import configparser
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.counting import TransitionCounter as JCounter, chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.inference import scoring as jscoring
from bear_tpu.inference import serving as jserving
from bear_tpu.models import bear_net as jbear_net
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.utils.checkpoint import save_results
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.scoring import load_bear
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import CNNAR, LinearAR, StopAR, flat_one_hot, get_ar_func
from bear_tpu_torch.ops import alphabets

torch.set_num_threads(2)
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _rand_seqs(rng, n, lo, hi, letters="ACGT"):
    return ["".join(rng.choice(list(letters), size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _table(seqs, lag, alphabet="dna"):
    tc = JCounter(lags=[lag], n_groups=1, alphabet=alphabet)
    enc = [(jfastx.encode_seq(s, alphabet), 0) for s in seqs]
    for chunk in jchunk_reads(iter(enc), lag):
        tc.add_chunk(chunk)
    return tc.tables[lag][0]


def _jax_linear(lag, A, dtype, seed=0):
    ar = jget_ar_func("linear", lag, A, dtype=dtype)
    return ar, ar.init(jax.random.key(seed))


def _port_linear(params, lag, A, dtype):
    ar = LinearAR(lag, A, dtype=dtype, device="cpu")
    ar.load_params([np.asarray(p) for p in params])
    return ar


def _codes(rng, n, lag, A):
    """Random '['-padded context codes [n, lag] (pad code A leads)."""
    codes = rng.integers(0, A, size=(n, lag))
    n_pad = rng.integers(0, lag + 1, size=n)
    codes[np.arange(lag)[None, :] < n_pad[:, None]] = A
    return codes.astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lag,A", [(5, 4), (2, 20)])
def test_linear_ar_matches_bear_tpu(dtype, lag, A):
    jar, params = _jax_linear(lag, A, JDT[dtype])
    ar = _port_linear(params, lag, A, dtype)
    codes = _codes(np.random.default_rng(0), 64, lag, A)
    oh = alphabets.one_hot(torch.from_numpy(codes), A + 1, dtype)
    tol = dict(rtol=1e-12, atol=0) if dtype == torch.float64 else dict(rtol=1e-6, atol=1e-7)
    want = np.asarray(jar.apply(params, jnp.asarray(oh.numpy())))
    with torch.no_grad():
        np.testing.assert_allclose(ar(oh).numpy(), want, **tol)
        np.testing.assert_allclose(ar.apply_codes(torch.from_numpy(codes)).numpy(),
                                   np.asarray(jar.apply_codes(params, jnp.asarray(codes))),
                                   **tol)
    assert ar(oh).dtype == dtype


def test_flat_one_hot_and_init_shape():
    codes = _codes(np.random.default_rng(1), 20, 6, 4)
    from bear_tpu.models.ar_funcs import flat_one_hot as jflat

    np.testing.assert_array_equal(
        flat_one_hot(torch.from_numpy(codes), 5, torch.float32).numpy(),
        np.asarray(jflat(jnp.asarray(codes), 5, jnp.float32)))
    g = torch.Generator().manual_seed(3)
    ar = LinearAR(6, 4, device="cpu", generator=g)
    assert ar.mat.shape == (6, 5, 5)
    # init: 0.05 * unit-norm columns over the input-letter axis
    np.testing.assert_allclose(ar.mat.detach().norm(dim=1).numpy(), 0.05, rtol=1e-5)


def test_get_ar_func_names():
    assert isinstance(get_ar_func("linear", 3, 4, {}, device="cpu"), LinearAR)
    assert isinstance(get_ar_func("cnn", 3, 4, {"filter_width": 2}, device="cpu"), CNNAR)
    assert isinstance(get_ar_func("stop", 3, 4, device="cpu"), StopAR)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_ar_func("attention", 3, 4, device="cpu")
    with pytest.raises(ValueError):
        get_ar_func("transformer", 3, 4, device="cpu")


def test_params_round_trip_from_bear_tpu():
    jar, ar_params = _jax_linear(4, 4, jnp.float64, seed=2)
    lst = jbear_net.params_to_list({"h_signed": jnp.asarray(-1.5, jnp.float64),
                                    "ar": ar_params})
    params = bear_net.params_from_list(lst, device="cpu", dtype=torch.float64)
    assert float(params["h_signed"]) == -1.5
    back = bear_net.params_to_list(params)
    assert len(back) == len(lst)
    for a, b in zip(back, lst):
        np.testing.assert_array_equal(a, b)


def test_row_math_matches_bear_tpu():
    rng = np.random.default_rng(2)
    lag, A = 4, 4
    codes = rng.integers(0, A, size=(7, 30)).astype(np.int8)
    lengths = rng.integers(0, 31, size=7).astype(np.int32)
    got = serving._context_rows_and_next(torch.from_numpy(codes),
                                         torch.from_numpy(lengths), lag, A)
    want = jserving._context_rows_and_next(jnp.asarray(codes), jnp.asarray(lengths), lag, A)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows = got[0]
    np.testing.assert_array_equal(
        serving._rows_to_onehot_contexts(rows, lag, torch.float32, A).numpy(),
        np.asarray(jserving._rows_to_onehot_contexts(jnp.asarray(rows.numpy()), lag,
                                                     jnp.float32, A)))
    ctx = np.array(["[[AC", "ACGT", "[[[[", "[TTG"])
    np.testing.assert_array_equal(serving.contexts_to_rows(ctx, lag),
                                  jserving.contexts_to_rows(ctx, lag))


def _servers(table, lag, dtype, kind, alphabet="dna"):
    A = alphabets.alphabet_size(alphabet)
    if kind == "van":
        kw_j = kw_p = dict(van=0.7)
    else:
        jar, params = _jax_linear(lag, A, JDT[dtype])
        ar = _port_linear(params, lag, A, dtype)
        kw_j = dict(h=0.05, ar_apply=jax.jit(lambda oh: jar.apply(params, oh)))
        kw_p = dict(h=0.05, ar_apply=ar)
    return (jserving.BearServer(table, lag, dtype=JDT[dtype], alphabet=alphabet, **kw_j),
            BearServer(table, lag, dtype=dtype, alphabet=alphabet, device="cpu", **kw_p))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["van", "linear_bear"])
def test_map_scores_match_bear_tpu(dtype, kind):
    rng = np.random.default_rng(3)
    lag = 4
    table = _table(_rand_seqs(rng, 60, 10, 80), lag)
    jserver, server = _servers(table, lag, dtype, kind)
    seqs = _rand_seqs(rng, 20, 0, 100) + ["", "A", "ACG", "TTTTTTTT"]
    got = server.score(seqs, mode="map")
    want = np.asarray(jserver.score(seqs, mode="map"))
    assert got.shape == (len(seqs),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    np.testing.assert_allclose(server.score(seqs, pad_to=128), got, rtol=RTOL[dtype])


def test_map_scores_protein_match_bear_tpu():
    rng = np.random.default_rng(4)
    letters = alphabets.residues("prot")
    table = _table(_rand_seqs(rng, 40, 5, 60, letters), 2, "prot")
    jserver, server = _servers(table, 2, torch.float64, "linear_bear", "prot")
    seqs = _rand_seqs(rng, 12, 0, 50, letters)
    np.testing.assert_allclose(server.score(seqs), np.asarray(jserver.score(seqs)),
                               rtol=1e-10)


def test_encode_ragged_matches_bear_tpu():
    rng = np.random.default_rng(5)
    seqs = _rand_seqs(rng, 9, 0, 20)
    lens = np.array([len(s) for s in seqs])
    table = np.zeros((serving.table_rows(2), 5))
    jserver = jserving.BearServer(table, 2, van=1.0)
    server = BearServer(table, 2, van=1.0, device="cpu")
    np.testing.assert_array_equal(server._encode_ragged(seqs, lens, 24),
                                  jserver._encode_ragged(seqs, lens, 24))
    np.testing.assert_array_equal(
        server._encode_ragged([s.encode() for s in seqs], lens, 24),
        jserver._encode_ragged(seqs, lens, 24))


def test_server_rejects_bad_arguments():
    table = np.zeros((serving.table_rows(2), 5))
    with pytest.raises(ValueError, match="exactly one"):
        BearServer(table, 2, van=1.0, ar_apply=lambda oh: oh, h=1.0, device="cpu")
    with pytest.raises(ValueError, match="table rows"):
        BearServer(table, 3, van=1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BearServer(table, 2, van=1.0, device="cpu").score(["ACGT"], mode="sample")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BearServer(table, 2, van=1.0)


def _model_dir(tmp_path, lag, precision, h_signed, ar_params, ar_name="linear"):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bear_tpu", "models", "config_files", "bear_lin_bear.cfg"))
    cfg["hyperp"]["lag"] = str(lag)
    cfg["general"]["precision"] = precision
    cfg["model"]["ar_func_name"] = ar_name
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)
    dt = np.float64 if precision == "float64" else np.float32
    save_results(str(tmp_path), [np.asarray(h_signed, dt)] + [np.asarray(p, dt) for p in ar_params])
    return str(tmp_path)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("double_softmax", [True, False])
def test_load_bear_matches_bear_tpu(tmp_path, precision, double_softmax):
    lag = 4
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    _, ar_params = _jax_linear(lag, 4, jdt, seed=7)
    path = _model_dir(tmp_path, lag, precision, -2.3, ar_params)
    jl = jscoring.load_bear(path, double_softmax=double_softmax)
    pl = load_bear(path, double_softmax=double_softmax, device="cpu")
    assert pl[:3] == jl[:3]  # lag, alphabet, h
    assert pl[4]["num_ds"] == jl[4]["num_ds"]
    rng = np.random.default_rng(8)
    table = _table(_rand_seqs(rng, 40, 10, 60), lag)
    dtype = torch.float64 if precision == "float64" else torch.float32
    jserver = jserving.BearServer(table, lag, h=jl[2], ar_apply=jl[3], dtype=jdt)
    server = BearServer(table, lag, h=pl[2], ar_apply=pl[3], dtype=dtype, device="cpu")
    seqs = _rand_seqs(rng, 16, 0, 70)
    np.testing.assert_allclose(server.score(seqs), np.asarray(jserver.score(seqs)),
                               rtol=RTOL[dtype])


def test_load_bear_rejects_wrong_param_count(tmp_path):
    _, ar_params = _jax_linear(3, 4, jnp.float64)
    path = _model_dir(tmp_path, 3, "float64", 0.0, list(ar_params) + [np.zeros(2)])
    with pytest.raises(ValueError, match="parameter"):
        load_bear(path, device="cpu")
    path2 = _model_dir(tmp_path, 3, "float64", 0.0, ar_params, ar_name="stop")
    with pytest.raises(ValueError, match="parameter"):
        load_bear(path2, device="cpu")
    path3 = _model_dir(tmp_path, 3, "float64", 0.0, ar_params, ar_name="attention")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_bear(path3, device="cpu")
