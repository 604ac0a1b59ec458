"""The port's posterior-sampled serving and Δ-scores
(bear_tpu_torch.inference.serving) against bear_tpu's, on the CPU.

The two packages draw from different generators (Philox here, threefry in
JAX), so sampled outputs are held to the analytic Dirichlet marginal and to
bear_tpu's draws by a two-sample KS test (fixed seeds, p > 1e-3), and to
the stateless-draw properties exactly. MAP Δ-scores equal bear_tpu's
float64 get_bear_probs at rtol 1e-10 (the two sum the same terms in another
order); bear_tpu's BearServer returns float32, held at rtol 1e-6.
"""

import configparser
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st
from scipy.special import digamma, polygamma

from bear_tpu.counting import TransitionCounter as JCounter, chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.data import load_sparse as jload_sparse
from bear_tpu.inference import scoring as jscoring
from bear_tpu.inference import serving as jserving
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.utils.checkpoint import save_results
from bear_tpu.utils.config import bundled_sparse_path
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.serving import BearServer, table_from_dataset
from bear_tpu_torch.models.ar_funcs import LinearAR
from bear_tpu_torch.ops import keyed_random as kr

torch.set_num_threads(2)
TOY_SEQS = ["TTTAT", "TTCTT", "TTTTT", "TTTTT"]
LAG = 3
WT = "TTTATTCTTAG"
VARS = ["T0A", "G10C", "TA2CG", "T5ACT", "TTC4G", "T8", "A3A", "0AC", "5G", "11TT"]


def _toy_counter():
    tc = JCounter(lags=[LAG], n_groups=1)
    for chunk in jchunk_reads(iter([(jfastx.encode_seq(s), 0) for s in TOY_SEQS]), LAG):
        tc.add_chunk(chunk)
    return tc


def _linear(lag, seed=0):
    jar = jget_ar_func("linear", lag, 4, dtype=jnp.float64)
    params = jar.init(jax.random.key(seed))
    ar = LinearAR(lag, 4, dtype=torch.float64, device="cpu")
    ar.load_params([np.asarray(p) for p in params])
    return jax.jit(lambda oh: jar.apply(params, oh)), ar


def _servers(kind, table=None, lag=LAG):
    table = _toy_counter().tables[LAG][0] if table is None else table
    if kind == "van":
        kw_j = kw_p = dict(van=0.7)
    else:
        j_apply, ar = _linear(lag)
        kw_j, kw_p = dict(h=0.3, ar_apply=j_apply), dict(h=0.3, ar_apply=ar)
    return (jserving.BearServer(table, lag, dtype=jnp.float64, **kw_j),
            BearServer(table, lag, dtype=torch.float64, device="cpu", **kw_p))


def _snv_grid(wt):
    pos, alt = [], []
    for p, ref in enumerate(wt):
        for a in "ACGT":
            if a != ref:
                pos.append(p)
                alt.append(a)
    return pos, alt


def test_sampled_picked_matches_analytic_marginal():
    # log p_k of a Dirichlet(c) draw: E = psi(c_k) - psi(C),
    # Var = psi1(c_k) - psi1(C), C = sum(c).
    N = 200_000
    conc = torch.tensor([0.05, 2.0, 0.3, 7.0, 1e-3], dtype=torch.float64)
    keys = kr.fold_in(kr.key(11), torch.arange(N))
    C = float(conc.sum())
    for k in range(5):
        lp = serving._sampled_logp_picked(keys, conc, torch.full((N,), k)).numpy()
        assert np.isfinite(lp).all()
        mean = digamma(float(conc[k])) - digamma(C)
        var = float(polygamma(1, float(conc[k])) - polygamma(1, C))
        assert abs(lp.mean() - mean) < 4 * np.sqrt(var / N), (k, lp.mean(), mean)
        assert abs(lp.var() / var - 1) < 0.05, (k, lp.var(), var)


def test_sampled_scores_ks_against_bear_tpu():
    jserver, server = _servers("linear_bear")
    S = 1500
    seqs = ["TTTAT", "TTCATTG", "ACGTTTTT"]
    got = server.score(seqs, mode="sample", key=kr.key(0), mc_samples=S)
    want = np.asarray(jserver.score(seqs, mode="sample", key=jax.random.key(0), mc_samples=S))
    assert got.shape == want.shape == (3, S) and got.dtype == np.float64
    for g, w in zip(got, want):
        assert st.ks_2samp(g, w).pvalue > 1e-3
    pos, alt = [1, 4, 9], ["G", "C", "A"]
    got = server.delta_scores_snv(WT, pos, alt, mode="sample", key=kr.key(1), mc_samples=S)
    want = jserver.delta_scores_snv(WT, pos, alt, mode="sample", key=jax.random.key(1),
                                    mc_samples=S)
    for g, w in zip(got, want):
        assert st.ks_2samp(g, w).pvalue > 1e-3
    vars_ = ["TA2CG", "T5ACT", "TTC4G"]
    got = server.delta_scores_variants(WT, vars_, mode="sample", key=kr.key(2), mc_samples=S)
    want = jserver.delta_scores_variants(WT, vars_, mode="sample", key=jax.random.key(2),
                                         mc_samples=S)
    for g, w in zip(got, want):
        assert st.ks_2samp(g, w).pvalue > 1e-3


def test_same_key_identical_and_chunking_invariant(monkeypatch):
    _, server = _servers("van")
    seqs = ["TTTAT", "TTCATTG", "ACGTTTTTAC", ""]
    pos, alt = _snv_grid(WT)
    key = kr.key(5)
    runs = []
    for _ in range(2):
        runs.append((server.score(seqs, mode="sample", key=key, mc_samples=4),
                     server.delta_scores_snv(WT, pos, alt, mode="sample", key=key, mc_samples=4),
                     server.delta_scores_variants(WT, VARS, mode="sample", key=key,
                                                  mc_samples=4)))
    # one element per draw slice, and small variant batches
    monkeypatch.setattr(serving, "SAMPLE_BUDGET_BYTES", 1)
    runs.append((server.score(seqs, mode="sample", key=key, mc_samples=4),
                 server.delta_scores_snv(WT, pos, alt, mode="sample", key=key,
                                         mc_samples=4, batch=5),
                 server.delta_scores_variants(WT, VARS, mode="sample", key=key,
                                              mc_samples=4, batch=3)))
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            np.testing.assert_array_equal(a, b)
    other = server.score(seqs, mode="sample", key=kr.key(6), mc_samples=4)
    assert not np.array_equal(other[:3], runs[0][0][:3])


@pytest.mark.parametrize("kind", ["van", "linear_bear"])
def test_identity_variants_are_exact_zeros_when_sampled(kind):
    _, server = _servers(kind)
    same = server.delta_scores_snv(WT, [0, 3, 5, 10], [WT[0], WT[3], WT[5], WT[10]],
                                   mode="sample", key=kr.key(1), mc_samples=5)
    np.testing.assert_array_equal(same, np.zeros((4, 5)))
    z = server.delta_scores_variants(WT, ["T0T", "A3A", "TTC4TTC"], mode="sample",
                                     key=kr.key(1), mc_samples=5)
    np.testing.assert_array_equal(z, np.zeros((3, 5)))


def test_repeated_context_shares_its_draw():
    # Lag 3: "T"*n has n-3 transitions TTT->T, all one draw of row TTT
    # within a sequence, so each extra T adds the same log-prob.
    _, server = _servers("linear_bear")
    key = kr.key(9)
    s = [float(server.score(["T" * n], mode="sample", key=key)[0]) for n in (6, 7, 8, 9)]
    steps = np.diff(s)
    np.testing.assert_allclose(steps, steps[0], rtol=1e-12)
    # the draw is the row's: recompute it from the keys
    rows, nxt, _ = serving._context_rows_and_next(torch.zeros(1, 6, dtype=torch.int8) + 3,
                                                  torch.tensor([6]), LAG, 4)
    row = rows[0, 5:6]
    seq_key = kr.fold_in(kr._as_keys(key), 0)
    with torch.no_grad():
        conc = server._concentrations(row, server._table[row])
        x = serving._sampled_logp_picked(kr.fold_in(seq_key, row), conc, torch.tensor([3]))
    np.testing.assert_allclose(steps[0], float(x[0]), rtol=1e-12)


def test_reductions_equal_the_draws_statistics():
    _, server = _servers("linear_bear")
    key = kr.key(7)
    S, qs = 33, (0.1, 0.5, 0.9)
    seqs = ["TTTATT", "TTCT", "TA"]
    pos, alt = [1, 4, 7, 9], ["G", "C", "A", "C"]
    calls = [
        lambda **kw: server.score(seqs, mode="sample", key=key, mc_samples=S, **kw),
        lambda **kw: server.delta_scores_snv(WT, pos, alt, mode="sample", key=key,
                                             mc_samples=S, **kw),
        lambda **kw: server.delta_scores_variants(WT, VARS, mode="sample", key=key,
                                                  mc_samples=S, **kw),
    ]
    for call in calls:
        full = call()
        ms = call(reduce="mean_std")
        np.testing.assert_allclose(ms[:, 0], full.mean(-1), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ms[:, 1], full.std(-1, ddof=1), rtol=1e-10, atol=1e-12)
        qt = call(reduce="quantiles", quantiles=qs)
        np.testing.assert_allclose(qt, np.quantile(full, qs, axis=-1).T, rtol=1e-12,
                                   atol=1e-12)
    one = server.delta_scores_snv(WT, pos, alt, mode="sample", key=key, reduce="mean_std")
    np.testing.assert_array_equal(one[:, 1], np.zeros(4))
    np.testing.assert_array_equal(
        one[:, 0], server.delta_scores_snv(WT, pos, alt, mode="sample", key=key))


def test_sample_axis_prefix_consistency():
    _, server = _servers("van")
    key = kr.key(7)
    pos, alt = [1, 4, 6], ["G", "A", "C"]
    s5 = server.delta_scores_snv(WT, pos, alt, mode="sample", key=key, mc_samples=5)
    s3 = server.delta_scores_snv(WT, pos, alt, mode="sample", key=key, mc_samples=3)
    np.testing.assert_array_equal(s5[:, :3], s3)
    np.testing.assert_array_equal(
        s5[:, 0], server.delta_scores_snv(WT, pos, alt, mode="sample", key=key))
    v5 = server.delta_scores_variants(WT, VARS, mode="sample", key=key, mc_samples=5)
    v3 = server.delta_scores_variants(WT, VARS, mode="sample", key=key, mc_samples=3)
    np.testing.assert_array_equal(v5[:, :3], v3)
    q5 = server.score(["TTTAT", "TTCTT"], mode="sample", key=key, mc_samples=5)
    q3 = server.score(["TTTAT", "TTCTT"], mode="sample", key=key, mc_samples=3)
    np.testing.assert_array_equal(q5[:, :3], q3)
    # mc_samples == 1 scores under the key itself; SNVs and variants on
    # pure SNVs see the same draws (keyed on the table row)
    np.testing.assert_array_equal(
        server.score(["TTTAT"], mode="sample", key=key),
        server.log_prob_sampled(np.array([[3, 3, 3, 0, 3]], np.int8), [5], key).numpy())
    snv_vars = [f"{WT[p]}{p}{a}" for p, a in zip(pos, alt)]
    np.testing.assert_allclose(
        server.delta_scores_variants(WT, snv_vars, mode="sample", key=key, mc_samples=3),
        s3, rtol=1e-12, atol=1e-12)


def test_empty_and_reduced_shapes_match_bear_tpu():
    jserver, server = _servers("van")
    jk, pk = jax.random.key(0), kr.key(0)
    qs = (0.2, 0.5, 0.8)
    cases = [(dict(), (0,)), (dict(mode="sample"), (0,)),
             (dict(mode="sample", mc_samples=5), (0, 5)),
             (dict(mode="sample", mc_samples=5, reduce="mean_std"), (0, 2)),
             (dict(mode="sample", mc_samples=5, reduce="quantiles", quantiles=qs), (0, 3))]
    for kw, empty in cases:
        jkw = dict(kw, key=jk) if "mode" in kw else kw
        pkw = dict(kw, key=pk) if "mode" in kw else kw
        got = server.delta_scores_variants(WT, [], **pkw)
        assert got.shape == jserver.delta_scores_variants(WT, [], **jkw).shape == empty
        assert got.dtype == np.float64
        # non-empty: the same trailing shape, one row per variant/sequence
        full = (3,) + empty[1:]
        assert server.delta_scores_variants(WT, VARS[:3], **pkw).shape == full
        assert server.delta_scores_snv(WT, [1, 2, 3], ["A", "C", "G"], **pkw).shape == full
        assert server.score(["TTA", "T", "AC"], **pkw).shape == full


def test_contract_errors():
    _, server = _servers("van")
    with pytest.raises(ValueError, match="requires key"):
        server.delta_scores_snv(WT, [1], ["A"], mode="sample")
    with pytest.raises(ValueError, match="requires key"):
        server.delta_scores_variants(WT, ["T0A"], mode="sample")
    with pytest.raises(ValueError, match="unknown mode"):
        server.delta_scores_variants(WT, ["T0A"], mode="nope")
    with pytest.raises(ValueError, match="unknown mode"):
        server.delta_scores_snv(WT, [1], ["A"], mode="nope")
    with pytest.raises(ValueError, match="requires mode"):
        server.delta_scores_snv(WT, [1], ["A"], reduce="mean_std")
    with pytest.raises(ValueError, match="requires mode"):
        server.score(["TTA"], reduce="quantiles")
    with pytest.raises(ValueError, match="unknown reduce"):
        server.score(["TTA"], mode="sample", mc_samples=2, reduce="median")
    with pytest.raises(ValueError, match="outside"):
        server.delta_scores_snv(WT, [len(WT)], ["A"])
    with pytest.raises(ValueError, match="outside"):
        server.delta_scores_variants(WT, ["A11C"])
    with pytest.raises(AssertionError, match="does not match"):
        server.delta_scores_variants(WT, ["C0A"])


@pytest.mark.parametrize("kind", ["van", "linear_bear"])
def test_map_deltas_match_bear_tpu_servers(kind):
    jserver, server = _servers(kind)
    pos, alt = _snv_grid(WT)
    got = server.delta_scores_snv(WT, pos, alt)
    assert got.dtype == np.float64 and got.shape == (len(pos),)
    np.testing.assert_allclose(got, jserver.delta_scores_snv(WT, pos, alt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(server.delta_scores_snv(WT, pos, alt, batch=4), got,
                               rtol=1e-12, atol=1e-12)
    gv = server.delta_scores_variants(WT, VARS)
    np.testing.assert_allclose(gv, jserver.delta_scores_variants(WT, VARS), rtol=1e-6,
                               atol=1e-6)
    assert gv[VARS.index("A3A")] == 0.0
    snv_vars = [f"{WT[p]}{p}{a}" for p, a in zip(pos, alt)]
    np.testing.assert_allclose(server.delta_scores_variants(WT, snv_vars), got,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(server.delta_scores_variants("TA", ["T0A", "A1G", "1GG", "2C"]),
                               jserver.delta_scores_variants("TA", ["T0A", "A1G", "1GG", "2C"]),
                               rtol=1e-6, atol=1e-6)


def test_map_deltas_match_get_bear_probs_on_the_fixture():
    # The bundled sparse toy counts (lag 3), through the dataset path.
    ds = jload_sparse(bundled_sparse_path(), "dna", 1)
    table = table_from_dataset(ds, LAG)
    np.testing.assert_array_equal(table, jserving.table_from_dataset(ds, LAG))
    van = 0.7
    server = BearServer(table, LAG, van=van, dtype=torch.float64, device="cpu")
    pos, alt = _snv_grid(WT)
    snv_vars = [f"{WT[p]}{p}{a}" for p, a in zip(pos, alt)]
    for got, vars_ in ((server.delta_scores_snv(WT, pos, alt), snv_vars),
                       (server.delta_scores_variants(WT, VARS), VARS)):
        want = jscoring.get_bear_probs(None, WT, vars_, 0, vans=[van], get_map=True,
                                       data=ds, lag=LAG, alphabet_name="dna")[:, 0]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _model_dir(tmp_path, lag=5, seed=4):
    """A bear_tpu linear BEAR model directory on the bundled YSD1 counts."""
    jar = jget_ar_func("linear", lag, 4, dtype=jnp.float64)
    params = jar.init(jax.random.key(seed))
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bear_tpu", "models", "config_files", "bear_lin_bear.cfg"))
    cfg["hyperp"]["lag"] = str(lag)
    cfg["data"]["files_path"] = "TEST"
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)
    save_results(str(tmp_path), [np.asarray(-2.3)] + [np.asarray(p) for p in params])
    return str(tmp_path)


def test_map_deltas_from_a_model_dir_match_get_bear_probs(tmp_path):
    path = _model_dir(tmp_path)
    server = BearServer.from_model_dir(path, dtype=torch.float64, device="cpu")
    assert server.lag == 5
    rng = np.random.default_rng(0)
    wt = "".join(rng.choice(list("ACGT"), 40))
    pos, alt = _snv_grid(wt)
    snv_vars = [f"{wt[p]}{p}{a}" for p, a in zip(pos, alt)]
    vars_ = [f"{wt[3:5]}3G", f"{wt[10]}10{wt[10]}AC", f"{wt[20:24]}20", "0TT", "40G",
             f"{wt[39]}39", f"{wt[0:3]}0CCCCC"]
    for got, vs in ((server.delta_scores_snv(wt, pos, alt), snv_vars),
                    (server.delta_scores_variants(wt, vars_), vars_)):
        want = jscoring.get_bear_probs(path, wt, vs, 0, get_map=True)[:, 1]  # BEAR
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_table_from_dataset_round_trip():
    tc = _toy_counter()
    ds = tc.to_dataset(LAG)
    np.testing.assert_array_equal(table_from_dataset(ds, LAG), tc.tables[LAG][0])
    with pytest.raises(ValueError, match="lag"):
        table_from_dataset(ds, LAG + 1)
