"""The port's posterior-predictive scoring (bear_tpu_torch.inference.scoring)
against bear_tpu's, on the CPU: counters, get_pdf, get_bear_probs and
get_bear_probs_seqs, on a model directory written by bear_tpu and on one
written by the port.

MAP and marginal scores in float64 agree at rtol 1e-10 (the same terms in
another order); Monte Carlo means, from different generators, within 4
standard errors of bear_tpu's.
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
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.ops import alphabets as jalphabets
from bear_tpu.utils.checkpoint import save_results as jsave_results
from bear_tpu_torch.counting import engine, fastx
from bear_tpu_torch.inference import scoring
from bear_tpu_torch.models.ar_funcs import LinearAR
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils.checkpoint import save_results

torch.set_num_threads(2)
TOY_SEQS = ["TTTAT", "TTCTT", "TTTTT", "TTTTT"]
LAG = 3
VANS = [0.1, 1.0, 10.0]
TOL = dict(rtol=1e-10, atol=1e-12)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counters(reverse=False, seqs=TOY_SEQS, lag=LAG):
    jtc = JCounter(lags=[lag], n_groups=1, reverse=reverse)
    for chunk in jchunk_reads(iter([(jfastx.encode_seq(s), 0) for s in seqs]), lag):
        jtc.add_chunk(chunk)
    tc = engine.TransitionCounter(lags=[lag], n_groups=1, reverse=reverse, device="cpu")
    for chunk in engine.chunk_reads(iter([(fastx.encode_seq(s), 0) for s in seqs]), lag):
        tc.add_chunk(chunk)
    return jtc, tc


def _config(tmp_path, lag):
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(REPO, "bear_tpu", "models", "config_files", "bear_lin_bear.cfg"))
    cfg["hyperp"]["lag"] = str(lag)
    cfg["data"]["files_path"] = "TEST"
    with open(tmp_path / "config.cfg", "w") as fh:
        cfg.write(fh)


def _model_dir(tmp_path, writer, lag=5):
    """A linear BEAR model directory on the bundled YSD1 counts, its
    parameters drawn and written by bear_tpu or by the port."""
    _config(tmp_path, lag)
    if writer == "bear_tpu":
        params = jget_ar_func("linear", lag, 4, dtype=jnp.float64).init(jax.random.key(4))
        jsave_results(str(tmp_path), [np.asarray(-2.3)] + [np.asarray(p) for p in params])
    else:
        ar = LinearAR(lag, 4, dtype=torch.float64, device="cpu",
                      generator=torch.Generator().manual_seed(4))
        save_results(str(tmp_path), [np.asarray(-1.7)] + [p.detach().numpy()
                                                          for p in ar.params_list()])
    return str(tmp_path)


def test_table_counter_matches_bear_tpu():
    for reverse in (False, True):
        jtc, tc = _counters(reverse)
        kmers = np.array(["TTT", "TTA", "[[T", "AT", "", "[AT", "AAA", "CGT"])
        for no_end in (False, True):
            got = scoring.TableCounter(tc, LAG, no_end=no_end)(kmers)
            want = jscoring.TableCounter(jtc, LAG, no_end=no_end)(kmers)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(scoring.TableCounter(tc, LAG).rows(kmers),
                                      jscoring.TableCounter(jtc, LAG).rows(kmers))
    # the reference's toy expectations (test_var_prob.py:8-18)
    _, tc = _counters()
    np.testing.assert_array_equal(scoring.TableCounter(tc, LAG)(np.array(["TTT", "TTA", "[[T"])),
                                  [[1, 0, 0, 4, 2], [0, 0, 0, 1, 0], [0, 0, 0, 4, 0]])

    class Sharded:
        def counts_for_rows(self, lag, rows):
            raise AssertionError

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scoring.TableCounter(Sharded(), LAG)


def test_dataset_counter_and_helpers_match_bear_tpu():
    jtc, _ = _counters()
    ds = jtc.to_dataset(LAG)
    kmers = np.array(["TTT", "GGG", "[[T", "TTA"])
    np.testing.assert_array_equal(scoring.DatasetCounter(ds)(kmers),
                                  jscoring.DatasetCounter(ds)(kmers))
    for v in ("A12T", "AAG23CC", "T5", "0AC", "GT123CA"):
        assert scoring.parse_var(v) == jscoring.parse_var(v)
    padded = "[[[TTTATTCTTAG]"
    for v in ("T0A", "TA2CG", "T5ACT", "TTC4G", "11TT", "0AC"):
        assert (scoring._variant_windows(padded, scoring.parse_var(v), LAG)
                == jscoring._variant_windows(padded, jscoring.parse_var(v), LAG))
    with pytest.raises(AssertionError, match="does not match"):
        scoring._variant_windows(padded, ("C", "A", 0), LAG)
    for kw in (dict(vans=[0.1, 1.0]), dict(vans=[1.0], get_map=True), dict(vans=[], n_h=2)):
        assert scoring.model_column_names(**kw) == jscoring.model_column_names(**kw)
    for a in ("dna", "prot"):
        np.testing.assert_array_equal(alphabets.output_letters(a), jalphabets.output_letters(a))
        syms = np.array(list(alphabets.residues(a)) + ["]"])
        np.testing.assert_array_equal(alphabets.encode_output_symbols(syms, a),
                                      jalphabets.encode_output_symbols(syms, a))
    with pytest.raises(ValueError):
        alphabets.encode_output_symbols(np.array(["["]), "dna")
    ctx = np.array(["[[AC", "ACGT", "[TTG"])
    np.testing.assert_array_equal(
        alphabets.one_hot_kmers(ctx, "dna", torch.float64).numpy(),
        np.asarray(jalphabets.one_hot_kmers(ctx, "dna", np.float64)))


@pytest.mark.parametrize("writer", ["bear_tpu", "port"])
def test_get_pdf_map_and_marginal_match_bear_tpu(tmp_path, writer):
    path = _model_dir(tmp_path, writer)
    jl = jscoring.load_bear(path)
    pl = scoring.load_bear(path, device="cpu")
    assert pl[:3] == jl[:3]
    ds = scoring.load_bear_dataset(pl[4])
    jds = jscoring.load_bear_dataset(jl[4])
    np.testing.assert_array_equal(ds.counts, jds.counts)
    kmers, counts = ds.kmers[:300], ds.counts[:300]
    args = ([jl[2], 0.5], )
    got = scoring.get_pdf(kmers, counts, *args, pl[3], 1, VANS, 0, "dna", get_map=True,
                          device="cpu")
    want = jscoring.get_pdf(kmers, counts, *args, jl[3], 1, VANS, 0, "dna", get_map=True)
    assert got.log_probs.shape == want.log_probs.shape == (300, 5, 6, 1)
    np.testing.assert_allclose(got.log_probs, want.log_probs, **TOL)
    gm = scoring.get_pdf(kmers, counts, *args, pl[3], 1, VANS, 0, "dna", get_marg=True,
                         device="cpu")
    wm = jscoring.get_pdf(kmers, counts, *args, jl[3], 1, VANS, 0, "dna", get_marg=True)
    np.testing.assert_allclose(gm.concs, wm.concs, **TOL)
    ks, cs = list(kmers[:40]), counts[:40, 1]
    np.testing.assert_allclose(gm(ks, cs), wm(ks, cs), **TOL)
    # sampled: normalised log-Dirichlet draws of the right shape
    gs = scoring.get_pdf(kmers, counts, *args, pl[3], 7, VANS, 0, "dna", device="cpu")
    assert gs.log_probs.shape == (300, 5, 5, 7)
    np.testing.assert_allclose(np.exp(gs.log_probs).sum(1), 1.0, rtol=1e-12)
    with pytest.raises(ValueError, match="marg or map"):
        scoring.get_pdf(kmers, counts, None, None, 1, VANS, 0, "dna", get_map=True,
                        get_marg=True, device="cpu")


@pytest.mark.parametrize("writer", ["bear_tpu", "port"])
def test_get_bear_probs_match_bear_tpu(tmp_path, writer):
    path = _model_dir(tmp_path, writer)
    rng = np.random.default_rng(1)
    wt = "".join(rng.choice(list("ACGT"), 30))
    vars_ = [f"{wt[2]}2A" if wt[2] != "A" else "A2C", f"{wt[5:7]}5GG", f"{wt[9]}9TTT",
             f"{wt[12:15]}12", "0C", "30AG", f"{wt[29]}29{wt[29]}"]
    kw = dict(vans=VANS, get_map=True)
    got = scoring.get_bear_probs(path, wt, vars_, 0, device="cpu", **kw)
    want = jscoring.get_bear_probs(path, wt, vars_, 0, **kw)
    assert got.shape == want.shape == (len(vars_), 5)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[-1] == 0.0)

    seqs = ["".join(rng.choice(list("ACGT"), int(n))) for n in (8, 20, 45)]
    for kw in (dict(get_map=True), dict(get_marg=True)):
        got = scoring.get_bear_probs_seqs(path, seqs, 0, vans=VANS, device="cpu", **kw)
        want = jscoring.get_bear_probs_seqs(path, seqs, 0, vans=VANS, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)

    # Monte Carlo: per-model means within 4 standard errors of bear_tpu's
    S = 400
    for call, jcall, arg in ((scoring.get_bear_probs, jscoring.get_bear_probs, (wt, vars_[:4])),
                             (scoring.get_bear_probs_seqs, jscoring.get_bear_probs_seqs,
                              (seqs,))):
        g = call(path, *arg, 0, mc_samples=S, vans=[1.0], seed=3, device="cpu")
        w = jcall(path, *arg, 0, mc_samples=S, vans=[1.0], seed=3)
        assert g.shape == w.shape == (len(arg[-1]), 2, S)
        se = np.sqrt((g.var(-1) + w.var(-1)) / S)
        assert np.all(np.abs(g.mean(-1) - w.mean(-1)) <= 4 * se + 1e-9)


@pytest.mark.parametrize("branch", ["counter", "data"])
def test_bmm_scores_match_bear_tpu_on_the_toy_counts(branch):
    jtc, tc = _counters()
    if branch == "counter":
        kw, jkw = dict(counter=scoring.TableCounter(tc, LAG)), dict(
            counter=jscoring.TableCounter(jtc, LAG))
    else:
        kw = jkw = dict(data=jtc.to_dataset(LAG))
    common = dict(vans=VANS, lag=LAG, alphabet_name="dna")
    vars_ = np.array(["A3T", "T2C"])
    np.testing.assert_allclose(
        scoring.get_bear_probs(None, "TTTAT", vars_, 0, get_map=True, device="cpu", **common, **kw),
        jscoring.get_bear_probs(None, "TTTAT", vars_, 0, get_map=True, **common, **jkw), **TOL)
    seqs = ["TTTAT", "TTCAT", "TTTTTTTTTT", "TTAAT"]
    for mode in (dict(get_map=True), dict(get_marg=True)):
        np.testing.assert_allclose(
            scoring.get_bear_probs_seqs(None, seqs, 0, device="cpu", **mode, **common, **kw),
            jscoring.get_bear_probs_seqs(None, seqs, 0, **mode, **common, **jkw), **TOL)
    with pytest.raises(ValueError, match="single-column"):
        scoring.get_bear_probs(None, "TTTAT", vars_, 1, device="cpu", **common,
                               counter=scoring.TableCounter(tc, LAG))
    with pytest.raises(ValueError, match="shorter than the lag"):
        scoring.get_bear_probs_seqs(None, ["TT"], 0, device="cpu", **common, **kw)
    with pytest.raises(ValueError, match="without a model directory"):
        scoring.get_bear_probs_seqs(None, ["TTTT"], 0, vans=VANS, device="cpu", **kw)
