"""The port's assembly (bear_tpu_torch.inference.assemble and assemble_cli)
against bear_tpu's, on the CPU.

The packages draw from different generators (the port's Philox, JAX's
threefry), so sequences agree letter for letter only where the table leaves
one choice: the cyclic cases of tests/test_assemble.py, and the CLI's FASTA
on a cyclic read set, byte for byte. Elsewhere they are held by
distribution: the first letter of 4,096 replicas of one seed, MAP and
sampled, against the probabilities of the table and against bear_tpu's own
frequencies (chi-square, p > 1e-3).
"""

import configparser
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.inference import assemble_cli as jcli
from bear_tpu.inference import assemble_no_ends as jassemble
from bear_tpu.inference import scoring as jscoring
from bear_tpu.models.ar_funcs import make_ar_func_cnn, make_ar_func_linear
from bear_tpu.ops import alphabets as jalphabets
from bear_tpu.utils.checkpoint import save_results as jsave_results
from bear_tpu_torch.counting import engine, fastx
from bear_tpu_torch.inference import assemble, assemble_cli, assemble_no_ends
from bear_tpu_torch.models.ar_funcs import CNNAR, LinearAR
from bear_tpu_torch.ops import keyed_random as kr

torch.set_num_threads(2)
N_REP = 4096
P_MIN = 1e-3
CNN_KW = {"filter_width": 2, "num_filters": 6, "kmer_layer1_width": 4}


def _tables(seqs, lag, reverse=False):
    """(bear_tpu's table, the port's resident table) of the same reads."""
    jtc = JCounter(lags=[lag], n_groups=1, reverse=reverse)
    for chunk in jchunk_reads(iter([(jfastx.encode_seq(s), 0) for s in seqs]), lag):
        jtc.add_chunk(chunk)
    tc = engine.TransitionCounter(lags=[lag], n_groups=1, reverse=reverse, device="cpu")
    for chunk in engine.chunk_reads(iter([(fastx.encode_seq(s), 0) for s in seqs]), lag):
        tc.add_chunk(chunk)
    table = tc.table(lag)[0]
    np.testing.assert_array_equal(table.numpy(), jtc.tables[lag][0])
    return jtc.tables[lag][0], table


def _gen(*args, **kw):
    return assemble_no_ends(*args, device="cpu", **kw)


@pytest.mark.parametrize("get_map", [False, True])
def test_cyclic_table_is_sequence_identical(get_map):
    # tests/test_assemble.py:24: a pure ACG repeat continues the cycle.
    jtable, table = _tables(["ACG" * 30], 3)
    kw = dict(lag=3, van=1e-6, get_map=get_map)
    got, ent = _gen(["ACG"], [[0, 12]], 3, counter_table=table, **kw)
    want, jent = jassemble(["ACG"], [[0, 12]], 3, counter_table=jtable, **kw)
    assert got.shape == (1, 3)
    np.testing.assert_array_equal(got, want)
    assert all(s == ("ACG" * 5)[:15] for s in got[0])
    np.testing.assert_array_equal(ent[0], jent[0])
    np.testing.assert_allclose(ent[0], 0.0, atol=1e-12)
    # BEAR mode whose AR term is negligible follows the same cycle
    bear, _ = _gen(["ACG"], [[0, 12]], 3, counter_table=table, lag=3, h=1e7,
                   ar_apply=lambda oh: torch.full(oh.shape[:-2] + (5,), 0.2,
                                                  dtype=oh.dtype))
    np.testing.assert_array_equal(bear, want)


def test_reverse_complement_left_flank_is_sequence_identical():
    # tests/test_assemble.py:42: the left flank extends the reverse complement.
    jtable, table = _tables(["ACG" * 30], 3, reverse=True)
    got, _ = _gen(["CGA"], [[6, 6]], 2, lag=3, counter_table=table, van=1e-6)
    want, _ = jassemble(["CGA"], [[6, 6]], 2, lag=3, counter_table=jtable, van=1e-6)
    np.testing.assert_array_equal(got, want)
    assert all(len(s) == 15 and s in ("ACGACGACGACGACG", "CGACGACGACGACGA", "GACGACGACGACGAC")
               for s in got[0])


def test_cli_fasta_is_byte_identical_on_a_cyclic_read_set(tmp_path):
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{'ACG' * (20 + i)}\n" for i in range(4)))
    (tmp_path / "in.csv").write_text(f"{reads},0,fa\n")
    seeds = tmp_path / "seeds.fa"
    seeds.write_text(">s0\nACGACG\n>s1\nGACGAC\n")
    argv = [str(seeds), "--counts-csv", str(tmp_path / "in.csv"), "--van", "1e-6",
            "--lag", "3", "--left", "7", "--right", "11", "--num", "3"]
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert assemble_cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = (tmp_path / "port" / "seqs.fa").read_bytes()
    assert got == (tmp_path / "jax" / "seqs.fa").read_bytes()
    assert got.count(b">") == 6
    assert os.path.exists(tmp_path / "port" / "entropy.png")


def test_seed_determinism_and_variation():
    rng = np.random.default_rng(0)
    _, table = _tables(["".join(rng.choice(list("ACGT"), 200)) for _ in range(3)], 2)
    kw = dict(lag=2, counter_table=table, van=1.0)
    g1, _ = _gen(["AC"], [[0, 20]], 4, seed=7, **kw)
    g2, _ = _gen(["AC"], [[0, 20]], 4, seed=7, **kw)
    g3, _ = _gen(["AC"], [[0, 20]], 4, seed=8, **kw)
    np.testing.assert_array_equal(g1, g2)
    assert np.any(g1 != g3)
    assert len(set(g1[0])) > 1  # replicas draw their own models
    # a sequence's letters do not depend on the batch size (here: the first
    # batch's sequences, whose batch key is the same)
    g4, _ = _gen(["AC"], [[0, 20]], 4, seed=7, batch_size=2, **kw)
    assert list(g4[0][:2]) == list(g1[0][:2])


def _first_letter_probs(table, seed_str, lag, van):
    row = (4**lag - 1) // 3 + int("".join("0123"["ACGT".index(c)] for c in seed_str[-lag:]), 4)
    conc = van + np.asarray(table[row], np.float64)[:4]
    return conc / conc.sum()


@pytest.mark.parametrize("get_map", [True, False])
def test_first_letter_frequencies_follow_the_table_and_bear_tpu(get_map):
    rng = np.random.default_rng(5)
    jtable, table = _tables(["".join(rng.choice(list("ACGT"), 60)) for _ in range(4)], 2)
    seed_str, van = "CA", 0.7
    p = _first_letter_probs(jtable, seed_str, 2, van)
    assert p.min() > 0.02
    kw = dict(lag=2, van=van, get_map=get_map, seed=11)
    got, _ = _gen([seed_str], [[0, 1]], N_REP, counter_table=table, **kw)
    want, _ = jassemble([seed_str], [[0, 1]], N_REP, counter_table=jtable, **kw)
    f_got = np.array([sum(s[-1] == b for s in got[0]) for b in "ACGT"])
    f_want = np.array([sum(s[-1] == b for s in want[0]) for b in "ACGT"])
    assert f_got.sum() == f_want.sum() == N_REP
    assert stats.chisquare(f_got, N_REP * p).pvalue > P_MIN
    assert stats.chisquare(f_want, N_REP * p).pvalue > P_MIN
    assert stats.chi2_contingency(np.stack([f_got, f_want])).pvalue > P_MIN


def _chi2_p(observed, probs):
    """Chi-square p of letter counts against probabilities, the cells too
    rare for the approximation (expected < 5) pooled into one."""
    observed, expected = np.asarray(observed, np.float64), np.asarray(probs) * np.sum(observed)
    rare = expected < 5
    if rare.any():
        observed = np.append(observed[~rare], observed[rare].sum())
        expected = np.append(expected[~rare], expected[rare].sum())
    return stats.chisquare(observed, expected).pvalue


def _same_p(a, b):
    """Chi-square p that two count vectors share one distribution."""
    keep = (np.asarray(a) + np.asarray(b)) > 0
    return stats.chi2_contingency(np.stack([a[keep], b[keep]])).pvalue


def _windows(lag):
    """Every context [4**lag, lag], oldest letter first, row c of code c."""
    return np.array([[(c >> 2 * (lag - 1 - j)) & 3 for j in range(lag)]
                     for c in range(4**lag)])


def _ar_table(jar_apply, lag):
    """bear_tpu's AR probabilities [4**lag, 5] of every context."""
    return np.asarray(jar_apply(jalphabets.one_hot(_windows(lag), 5, jnp.float64)), np.float64)


def _code(s):
    return int("".join(str("ACGT".index(c)) for c in s), 4)


def _map_marginals(table, ar_tab, h, seed_str, lag, steps):
    """Exact letter marginals [steps, 4] and the joint of the first two
    letters [4, 4] of a MAP extension whose step probabilities are
    ``ar(window) / h + counts`` over the four residues, by enumerating every
    path."""
    offset0 = (4**lag - 1) // 3
    marg, joint = np.zeros((steps, 4)), np.zeros((4, 4))

    def walk(prefix, prob, path):
        t = len(path)
        if t == steps:
            return
        code = _code(prefix[-lag:])
        conc = ar_tab[code, :4] / h + np.asarray(table[offset0 + code], np.float64)[:4]
        for b, p in enumerate(conc / conc.sum()):
            marg[t, b] += prob * p
            if t == 1:
                joint[path[0], b] += prob * p
            walk(prefix + "ACGT"[b], prob * p, path + [b])

    walk(seed_str, 1.0, [])
    return marg, joint


def _letter_counts(group, start, steps):
    """Counts [steps, 4] of each letter at positions start.. of the
    generated strings, and the joint [16] of the first two."""
    arr = np.array([[("ACGT".index(c)) for c in s[start:start + steps]] for s in group])
    per = np.stack([np.bincount(arr[:, t], minlength=4) for t in range(steps)])
    return per, np.bincount(arr[:, 0] * 4 + arr[:, 1], minlength=16)


def _ar_pair(net, lag, dtype=torch.float64):
    """(bear_tpu's apply, the port's module) of one set of window-dependent
    parameters: bear_tpu's init, scaled up so that the AR term decides."""
    if net == "linear":
        jar = make_ar_func_linear(lag, 4, dtype=jnp.float64)
        params = [np.random.default_rng(0).normal(0.0, 1.5, (lag, 5, 5))]
        ar = LinearAR(lag, 4, dtype=dtype, device="cpu")
    else:
        jar = make_ar_func_cnn(lag, 4, dtype=jnp.float64, **CNN_KW)
        params = [np.asarray(p) for p in jar.init(jax.random.key(1))]
        for i, scale in ((0, 10.0), (2, 5.0), (4, 20.0)):  # filters, weights1, weights2
            params[i] = params[i] * scale
        ar = CNNAR(lag, 4, dtype=dtype, device="cpu", **CNN_KW)
    ar.load_params(params)
    ar.requires_grad_(False)
    jparams = [jnp.asarray(p) for p in params]
    return (lambda oh: jar.apply(jparams, oh)), ar


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("get_map", [True, False])
def test_bear_mode_peaked_ar_is_sequence_identical(get_map, dtype):
    # An AR whose next letter is the one after the window's oldest letter
    # (s_t = s_{t-3} + 1 mod 4), at h = 1e-12: ar / h outweighs every count
    # by more than any Gumbel gap, so the rollout is deterministic and both
    # packages must write the rule's sequences, flanks included.
    lag = 3
    rng = np.random.default_rng(8)
    jtable, table = _tables(["".join(rng.choice(list("ACGT"), 60)) for _ in range(4)], lag,
                            reverse=True)
    mat = np.zeros((lag, 5, 5))
    mat[0, np.arange(4), (np.arange(4) + 1) % 4] = 100.0
    mat[0, :, 4] = -100.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ar = LinearAR(lag, 4, dtype=tdt, device="cpu")
    ar.load_params([mat.astype(dtype)])
    jar = make_ar_func_linear(lag, 4, dtype=jdt)
    jmat = [jnp.asarray(mat, jdt)]
    seeds, lengths = ["GATTACA", "CCGTA"], [[5, 12], [7, 3]]
    kw = dict(lag=lag, h=1e-12, get_map=get_map, seed=4)
    got, _ = _gen(seeds, lengths, 3, counter_table=table, ar_apply=ar, dtype=tdt, **kw)
    want, _ = jassemble(seeds, lengths, 3, counter_table=jtable,
                        ar_apply=lambda oh: jar.apply(jmat, oh), dtype=jdt, **kw)

    def rule(s, n):
        for _ in range(n):
            s += "ACGT"[("ACGT".index(s[-lag]) + 1) % 4]
        return s

    for seed_s, (left, right), g, w in zip(seeds, lengths, got, want):
        oracle = assemble._revcomp(rule(assemble._revcomp(seed_s), left)) + rule(seed_s, right)[
            len(seed_s):]
        assert list(g) == [oracle] * 3
        assert list(w) == [oracle] * 3


@pytest.mark.parametrize("get_map", [True, False])
@pytest.mark.parametrize("net", ["linear", "cnn"])
def test_bear_mode_frequencies_follow_the_model_and_bear_tpu(net, get_map):
    # A window-dependent AR at h = 0.25, where ar / h and the counts are of a
    # size: the letters of 4,096 replicas of one seed, position by position,
    # against bear_tpu's (both modes) and against the exact MAP marginals
    # (MAP; sampled mode's first letter, whose marginal is the same).
    lag, h, steps, seed_str = 3, 0.25, 4, "GATTC"
    rng = np.random.default_rng(6)
    jtable, table = _tables(["".join(rng.choice(list("ACGT"), 40)) for _ in range(2)], lag,
                            reverse=True)
    japply, ar = _ar_pair(net, lag)
    ar_tab = _ar_table(japply, lag)
    got_tab = ar(torch.from_numpy(np.eye(5)[_windows(lag)])).numpy()
    np.testing.assert_allclose(got_tab, ar_tab, rtol=1e-12)
    kw = dict(lag=lag, h=h, get_map=get_map, seed=13, batch_size=N_REP, dtype=torch.float64)
    got, _ = _gen([seed_str], [[0, steps]], N_REP, counter_table=table, ar_apply=ar, **kw)
    kw["dtype"] = jnp.float64
    want, _ = jassemble([seed_str], [[0, steps]], N_REP, counter_table=jtable,
                        ar_apply=japply, **kw)
    (f_got, j_got), (f_want, j_want) = (_letter_counts(g[0], len(seed_str), steps)
                                        for g in (got, want))
    marg, joint = _map_marginals(jtable, ar_tab, h, seed_str, lag, steps)
    for t in range(steps):
        assert _same_p(f_got[t], f_want[t]) > P_MIN, t
    assert _same_p(j_got, j_want) > P_MIN
    checked = range(steps) if get_map else range(1)
    for t in checked:
        assert _chi2_p(f_got[t], marg[t]) > P_MIN, t
        assert _chi2_p(f_want[t], marg[t]) > P_MIN, t
    if get_map:
        assert _chi2_p(j_got, joint.ravel()) > P_MIN
        assert _chi2_p(j_want, joint.ravel()) > P_MIN
    if net == "linear":
        # the comparison has the power to see the faults it is for: the
        # window read newest first, or the AR term not divided by h
        reversed_tab = ar_tab[[_code("".join("ACGT"[c] for c in w[::-1]))
                               for w in _windows(lag)]]
        for wrong_tab, wrong_h in ((reversed_tab, h), (ar_tab, 1.0)):
            wrong, wrong_joint = _map_marginals(jtable, wrong_tab, wrong_h, seed_str, lag, steps)
            assert _chi2_p(f_got[0], wrong[0]) < 1e-6
            if get_map:
                assert _chi2_p(j_got, wrong_joint.ravel()) < 1e-6


@pytest.mark.parametrize("get_map", [True, False])
def test_cli_model_dir_frequencies_match_bear_tpu(tmp_path, get_map):
    # The --model-dir route as both CLIs run it: a linear BEAR model
    # directory (load_bear's double softmax + EPSILON, h = 0.05), reads
    # counted with reverse=True, 2,048 replicas of one seed. Letters
    # position by position against bear_tpu's CLI, and against the exact
    # MAP marginals from bear_tpu's own load_bear.
    lag, steps, n, seed_str = 3, 3, 2048, "GATTC"
    rng = np.random.default_rng(9)
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(3)]
    (tmp_path / "reads.fa").write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    (tmp_path / "in.csv").write_text(f"{tmp_path / 'reads.fa'},0,fa\n")
    (tmp_path / "seeds.fa").write_text(f">s0\n{seed_str}\n")
    model = tmp_path / "model"
    model.mkdir()
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bear_tpu", "models", "config_files", "bear_lin_bear.cfg"))
    cfg["hyperp"]["lag"] = str(lag)
    with open(model / "config.cfg", "w") as fh:
        cfg.write(fh)
    mat = np.random.default_rng(10).normal(0.0, 3.0, (lag, 5, 5))
    jsave_results(str(model), [np.asarray(np.log(0.05)), mat])
    argv = [str(tmp_path / "seeds.fa"), "--counts-csv", str(tmp_path / "in.csv"),
            "--model-dir", str(model), "--right", str(steps), "--num", str(n), "--seed", "5",
            "--batch-size", str(n)] + (["--map"] if get_map else [])
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert assemble_cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got, want = ([s for _, s in fastx.iter_fasta(str(tmp_path / d / "seqs.fa"))]
                 for d in ("port", "jax"))
    assert len(got) == len(want) == n
    (f_got, j_got), (f_want, j_want) = (_letter_counts(g, len(seed_str), steps)
                                        for g in (got, want))
    for t in range(steps):
        assert _same_p(f_got[t], f_want[t]) > P_MIN, t
    assert _same_p(j_got, j_want) > P_MIN
    jlag, _, h, japply, _ = jscoring.load_bear(str(model))
    assert jlag == lag and abs(h - 0.05) < 1e-12
    jtable, _ = _tables(reads, lag, reverse=True)
    marg, joint = _map_marginals(jtable, _ar_table(japply, lag), h, seed_str, lag, steps)
    assert _chi2_p(f_got[0], marg[0]) > P_MIN
    if get_map:
        for t in range(1, steps):
            assert _chi2_p(f_got[t], marg[t]) > P_MIN, t
        assert _chi2_p(j_got, joint.ravel()) > P_MIN


def test_a_revisited_context_reuses_its_draw(monkeypatch):
    rng = np.random.default_rng(2)
    _, table = _tables(["".join(rng.choice(list("ACGT"), 300)) for _ in range(2)], 1)
    seen = []
    real = assemble.log_dirichlet_draw_keyed

    def spy(keys, conc, n_iter):
        out = real(keys, conc, n_iter=n_iter)
        seen.append((keys.clone(), conc.clone(), out.clone()))
        return out

    monkeypatch.setattr(assemble, "log_dirichlet_draw_keyed", spy)
    gen, _ = _gen(["A", "C"], [[0, 40], [0, 40]], 3, lag=1, counter_table=table, van=0.5,
                  dtype=torch.float64)
    assert len(seen) == 40 and all(s[0].shape == (6,) for s in seen)
    keys = torch.stack([k for k, _, _ in seen])  # [step, sequence]
    draws = torch.stack([o for _, _, o in seen])
    rows = np.array([[1 + "ACGT".index(s[t]) for t in range(40)]
                     for s in gen.reshape(-1)])  # the context row of step t
    for b in range(6):
        by_row = {}
        for t in range(40):
            r = rows[b, t]
            if r in by_row:  # revisit: the same key and the same draw
                assert keys[t, b] == keys[by_row[r], b]
                assert torch.equal(draws[t, b], draws[by_row[r], b])
            by_row[r] = t
        assert len(by_row) > 1
    # distinct sequences draw from distinct keys for the same row
    assert len({int(k) for k in keys[0]}) == 6
    # the stop concentration is 0 and its log draw -inf, never NaN
    assert all((c[:, -1] == 0).all() and torch.isneginf(o[:, -1]).all() for _, c, o in seen)


def test_entropy_matches_a_numpy_oracle():
    rng = np.random.default_rng(3)
    _, table = _tables(["".join(rng.choice(list("ACGT"), 200)) for _ in range(3)], 3)
    gen, ent = _gen(["ACGTA", "TTGCA"], [[4, 9], [0, 5]], 16, lag=3, counter_table=table,
                    van=0.3, seed=2)
    for group, e in zip(gen, ent):
        L = len(group[0])
        assert all(len(s) == L for s in group) and e.shape == (L,)
        want = np.zeros(L)
        for i in range(L):
            freq = np.array([sum(s[i] == b for s in group) for b in "ACGT[]"]) / len(group)
            want[i] = -sum(f * np.log(f) for f in freq if f > 0)
        np.testing.assert_allclose(e, want, rtol=1e-12, atol=1e-15)
    # the seeds themselves are fixed sites: zero entropy
    np.testing.assert_allclose(ent[0][4:9], 0.0, atol=1e-15)


def test_save_outputs_and_bear_mode(tmp_path):
    rng = np.random.default_rng(1)
    _, table = _tables(["".join(rng.choice(list("ACGT"), 300))], 3)

    def ar_apply(oh):
        return torch.full(oh.shape[:-2] + (5,), 0.2, dtype=oh.dtype)

    gen, _ = _gen(["ACGT", "TTTT"], [[3, 5], [2, 2]], 2, lag=3, counter_table=table, h=0.5,
                  ar_apply=ar_apply, save_folder=str(tmp_path))
    assert gen.shape == (2, 2)
    assert all(len(s) == 12 for s in gen[0]) and all(len(s) == 8 for s in gen[1])
    fa = list(fastx.iter_fasta(str(tmp_path / "seqs.fa")))
    assert [name for name, _ in fa] == ["seq0_rep0", "seq0_rep1", "seq1_rep0", "seq1_rep1"]
    assert [s for _, s in fa] == list(gen.reshape(-1))
    assert os.path.exists(tmp_path / "entropy.png")
    gen_map, _ = _gen(["ACGT"], [[0, 8]], 3, lag=3, counter_table=table, h=0.5,
                      ar_apply=ar_apply, get_map=True)
    assert all(len(s) == 12 and set(s) <= set("ACGT") for s in gen_map[0])


def test_refusals():
    _, table = _tables(["ACGTTGCA" * 4], 2)
    with pytest.raises(ValueError, match="exactly one"):
        _gen(["ACG"], [[0, 2]], 1, lag=2, counter_table=table)
    with pytest.raises(ValueError, match="requires h"):
        _gen(["ACG"], [[0, 2]], 1, lag=2, counter_table=table, ar_apply=lambda oh: oh)
    with pytest.raises(ValueError, match="at least lag"):
        _gen(["A"], [[0, 2]], 1, lag=2, counter_table=table, van=1.0)
    with pytest.raises(ValueError, match="rows"):
        _gen(["ACG"], [[0, 2]], 1, lag=3, counter_table=table, van=1.0)

    class SparseTableIndex:  # an empty sparse table: prior-only generation
        rows = np.zeros(0, np.int64)
        counts = np.zeros((0, 5), np.int64)

    empty, _ = _gen(["ACG"], [[2, 4]], 3, lag=2, counter_table=SparseTableIndex(), van=1.0)
    zeros, _ = _gen(["ACG"], [[2, 4]], 3, lag=2, counter_table=np.zeros((21, 5), np.int64),
                    van=1.0)
    np.testing.assert_array_equal(empty, zeros)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            assemble_no_ends(["ACG"], [[0, 2]], 1, lag=2, counter_table=table, van=1.0)
    with pytest.raises(SystemExit, match="exactly one"):
        assemble_cli.main(["s.fa", "--counts-csv", "x.csv", "--out", "o"])
    with pytest.raises(SystemExit, match="requires --lag"):
        assemble_cli.main(["s.fa", "--counts-csv", "x.csv", "--van", "1", "--out", "o"])


def test_keys_follow_bear_tpus_layout():
    # batch key fold_in(key(seed), direction * 1_000_003 + start); sequence
    # keys fold_in(batch key, i); Gumbel keys fold_in(batch key, 2_000_003 + t)
    bk = kr.fold_in(kr.key(3), assemble.DIRECTION_STRIDE + 8)
    g = assemble._gumbel(bk, range(2, 5), 6, torch.float64, "cpu")
    assert g.shape == (3, 6, 4)
    (w,) = kr.stream_words(kr.fold_in(bk, assemble.GUMBEL_STEP + 3), torch.arange(6),
                           [(kr.EXPONENTIAL, 4)])
    assert torch.equal(g[1], -torch.log(kr.exponential(w, torch.float64)))


@pytest.mark.slow
def test_cli_model_dir_route(tmp_path):
    # tests/test_assemble.py:121: a trained model directory (the port's
    # training CLI on bear_test.cfg) extends seeds under its BEAR posterior.
    import configparser

    from bear_tpu_torch.models import train_bear_net

    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bear_tpu", "models", "config_files", "bear_test.cfg"))
    cfg["general"]["out_folder"] = str(tmp_path / "model") + "*"
    train_bear_net.main(cfg, device="cpu")
    reads = tmp_path / "reads.fa"
    reads.write_text(">r0\nACGTACGTACGTACGT\n>r1\nTTGACCGTAACGGTCA\n")
    (tmp_path / "in.csv").write_text(f"{reads},0,fa\n")
    seeds = tmp_path / "seeds.fa"
    seeds.write_text(">s0\nACGTACG\n")
    base = [str(seeds), "--counts-csv", str(tmp_path / "in.csv"), "--model-dir",
            str(tmp_path / "model"), "--device", "cpu"]
    assert assemble_cli.main(base + ["--right", "10", "--num", "2",
                                     "--out", str(tmp_path / "gen")]) == 0
    gen = list(fastx.iter_fasta(str(tmp_path / "gen" / "seqs.fa")))
    assert len(gen) == 2 and all(s.startswith("ACGTACG") and len(s) == 17 for _, s in gen)
    with pytest.raises(SystemExit, match="model lag"):
        assemble_cli.main(base + ["--lag", "2", "--out", str(tmp_path / "x")])
    # bear_tpu's CLI reads the port's model directory too
    assert jcli.main([str(seeds), "--counts-csv", str(tmp_path / "in.csv"), "--model-dir",
                      str(tmp_path / "model"), "--right", "10", "--out",
                      str(tmp_path / "jgen")]) == 0


def _sparse_counters(chunk_rows, lag):
    """(the port's dense counter, its sparse counter, bear_tpu's sparse
    counter) over the same reverse-counted rows."""
    from bear_tpu.counting.engine import ReadChunk as JChunk
    from bear_tpu.counting.sparse import SparseTransitionCounter as JSparse
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter

    dense = (engine.TransitionCounter([lag], reverse=True, device="cpu") if lag <= 8 else None)
    sp = SparseTransitionCounter([lag], reverse=True, device="cpu")
    jsp = JSparse([lag], reverse=True)
    for c in (dense, sp):
        if c is not None:
            c.add_chunk(engine.ReadChunk(*chunk_rows))
    jsp.add_chunk(JChunk(*chunk_rows))
    return dense, sp, jsp


@pytest.mark.parametrize("get_map", [False, True])
def test_sparse_index_generates_the_dense_tables_sequences(get_map):
    # tests/test_assemble.py:162: the same keys and counts through a
    # SparseTableIndex and the dense table give the same sequences.
    from bear_tpu_torch.inference.scoring import SparseTableIndex

    rng = np.random.default_rng(31)
    lag, B, L = 8, 200, 60
    rows = (rng.integers(0, 4, (B, L)).astype(np.int8), np.full(B, L, np.int32),
            np.zeros(B, np.int32), np.ones(B, bool), np.zeros(B, np.int32))
    dense, sp, _ = _sparse_counters(rows, lag)
    index = SparseTableIndex(sp, lag)
    kw = dict(lag=lag, van=0.3, get_map=get_map, seed=7)
    seeds, lengths = ["ACGTACGT", "TTTTGGGG", "CCCCCCCCA"], np.full((3, 2), 40)
    gen_d, ent_d = _gen(seeds, lengths, 4, counter_table=dense.table(lag)[0], **kw)
    gen_s, ent_s = _gen(seeds, lengths, 4, counter_table=index, **kw)
    np.testing.assert_array_equal(gen_d, gen_s)
    for a, b in zip(ent_d, ent_s):
        np.testing.assert_array_equal(a, b)
    # BEAR mode as well
    ar = LinearAR(lag, 4, dtype=torch.float64, device="cpu",
                  generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        bd, _ = _gen(seeds, lengths, 2, counter_table=dense.table(lag)[0], h=0.3, ar_apply=ar,
                     lag=lag, get_map=get_map, seed=8)
        bs, _ = _gen(seeds, lengths, 2, counter_table=index, h=0.3, ar_apply=ar, lag=lag,
                     get_map=get_map, seed=8)
    np.testing.assert_array_equal(bd, bs)


def test_lag17_sparse_map_rollout_is_bear_tpus():
    # tests/test_assemble.py:197: a read set where every lag-17 context of
    # the genome has one continuation; MAP generation seeded inside it
    # follows the genome on both strands, as bear_tpu's does.
    from bear_tpu.inference.scoring import SparseTableIndex as JIndex
    from bear_tpu_torch.inference.scoring import SparseTableIndex

    rng = np.random.default_rng(32)
    lag = 17
    genome = "".join(rng.choice(list("ACGT"), 400))
    starts = rng.integers(0, len(genome) - 80, 40)
    codes = np.array([["ACGT".index(c) for c in genome[s : s + 80]] for s in starts], np.int8)
    rows = (codes, np.full(40, 80, np.int32), np.zeros(40, np.int32), np.ones(40, bool),
            np.zeros(40, np.int32))
    _, sp, jsp = _sparse_counters(rows, lag)
    index, jindex = SparseTableIndex(sp, lag), JIndex(jsp, lag)
    assert index.rows.dtype == np.int64 and index.rows.max() > np.iinfo(np.int32).max
    np.testing.assert_array_equal(index.rows, jindex.rows)
    s0 = int(starts[0])
    seeds = [genome[s0 : s0 + lag + 3], genome[s0 + 5 : s0 + lag + 9]]
    lengths = np.array([[0, 20], [6, 12]])
    kw = dict(lag=lag, van=1e-9, get_map=True, seed=3)
    got, got_ent = _gen(seeds, lengths, 2, counter_table=index, **kw)
    want, want_ent = jassemble(seeds, lengths, 2, counter_table=jindex, **kw)
    np.testing.assert_array_equal(got, want)
    assert all(g == genome[s0 : s0 + lag + 23] for g in got[0])
    for a, b in zip(got_ent, want_ent):
        np.testing.assert_allclose(a, b, atol=1e-12)
    sampled, _ = _gen(seeds, lengths, 3, counter_table=index, lag=lag, van=0.5, seed=4)
    assert all(len(g) == len(s) + sum(n) and set(g) <= set("ACGT")
               for s, n, row in zip(seeds, lengths, sampled) for g in row)
