"""The whole slice — reads -> TransitionCounter -> count table -> BearServer
MAP scores — through both packages on a seeded small genome at lag 5, on
the CPU.

The reads come from chip_smoke.py's own generator and chunker (the
examples/genome_lag13.py workload at a small size), so this is also a
rehearsal of the chip run's main path with the plain PyTorch versions.
Tolerances: counts bit-equal; float64 scores rtol 1e-10; float32 port scores
within chip_smoke.py's stated GPU-vs-float64 tolerance.
"""

import configparser
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.inference import scoring as jscoring
from bear_tpu.inference import serving as jserving
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.utils.checkpoint import save_results
from bear_tpu_torch.counting.engine import TransitionCounter
from bear_tpu_torch.inference import BearServer, load_bear
from bear_tpu_torch.models.ar_funcs import LinearAR

torch.set_num_threads(2)
LAG = 5
H = 0.05


@pytest.fixture(scope="module")
def counted():
    reads, groups = chip_smoke.make_reads(genome_mb=0.03, coverage=4,
                                          read_len=60, seed=3)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=512))
    ref = JCounter(lags=[LAG], n_groups=2, method="scatter")
    port = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chunks:
        ref.add_chunk(c)
        port.add_chunk(c)
    seqs = chip_smoke.decode_reads(reads[np.flatnonzero(groups == 1)[:300]])
    return reads, ref, port, seqs


def test_slice_counts_bit_equal(counted):
    reads, ref, port, _ = counted
    expected = len(reads) * (reads.shape[1] + 1)
    assert port.validate(expected) == ref.validate(expected)
    np.testing.assert_array_equal(port.tables[LAG], ref.tables[LAG])
    assert len(port.nonzero_rows(LAG)) > 1000


@pytest.mark.parametrize("route", ["direct", "load_bear"])
def test_slice_scores_match_bear_tpu(counted, route, tmp_path):
    _, ref, port, seqs = counted
    jar = jget_ar_func("linear", LAG, 4, dtype=jnp.float64)
    params = jar.init(jax.random.key(11))
    if route == "direct":
        ar = LinearAR(LAG, 4, dtype=torch.float64, device="cpu")
        ar.load_params([np.asarray(params[0])])
        h, ar_apply = H, ar
        jh, jar_apply = H, jax.jit(lambda oh: jar.apply(params, oh))
    else:
        cfg = configparser.ConfigParser()
        cfg.read(os.path.join(os.path.dirname(chip_smoke.__file__), "bear_tpu",
                              "models", "config_files", "bear_lin_bear.cfg"))
        cfg["hyperp"]["lag"] = str(LAG)
        with open(tmp_path / "config.cfg", "w") as fh:
            cfg.write(fh)
        save_results(str(tmp_path), [np.log(H)] + [np.asarray(p) for p in params])
        _, _, h, ar_apply, _ = load_bear(str(tmp_path), device="cpu")
        _, _, jh, jar_apply, _ = jscoring.load_bear(str(tmp_path))
        assert h == jh
    server = BearServer(port.tables[LAG][0], LAG, h=h, ar_apply=ar_apply,
                        dtype=torch.float64, device="cpu")
    jserver = jserving.BearServer(ref.tables[LAG][0], LAG, h=jh,
                                  ar_apply=jar_apply, dtype=jnp.float64)
    got = server.score(seqs)
    want = np.asarray(jserver.score(seqs))
    assert got.shape == (len(seqs),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_slice_float32_within_chip_tolerance(counted):
    _, ref, port, seqs = counted
    jar = jget_ar_func("linear", LAG, 4, dtype=jnp.float64)
    params = jar.init(jax.random.key(12))
    ar32 = LinearAR(LAG, 4, device="cpu")
    ar32.load_params([np.asarray(params[0])])
    got = BearServer(port.tables[LAG][0], LAG, h=H, ar_apply=ar32,
                     device="cpu").score(seqs)
    want = np.asarray(jserving.BearServer(
        ref.tables[LAG][0], LAG, h=H, ar_apply=jax.jit(lambda oh: jar.apply(params, oh)),
        dtype=jnp.float64).score(seqs))
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= chip_smoke.SCORE_ATOL
            + chip_smoke.SCORE_RTOL * np.abs(want)).all()


def test_make_reads_full_size_counts():
    # The chip run's workload size, from the generator's own arithmetic
    # (no genome is built): 4.6 Mb at coverage 10 in 150 bp reads.
    n_reads = int(int(chip_smoke.GENOME_MB * 1e6) * chip_smoke.COVERAGE
                  / chip_smoke.READ_LEN)
    assert n_reads == 306_666
    assert n_reads * (chip_smoke.READ_LEN + 1) == 46_306_566


def test_chip_smoke_train_phase_rehearsal(tmp_path):
    # chip_smoke.py's phase 4c on the CPU at a small size: count -> handoff
    # -> CNN training (first ELBOs vs float64) -> evaluation -> model dir ->
    # load_bear -> BearServer (vs float64); its own checks raise on a fault.
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    launches, codes, counts, ar, p0, n_rows = chip_smoke.lag13_train_phase(
        chunks, reads, groups, str(tmp_path / "cnn"), device="cpu", lag=LAG,
        cnn_kw={"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6},
        batch=1024, epochs=2, n_score=100)
    assert launches == 0  # the plain version runs on the CPU: no kernel
    assert codes.shape == (n_rows, LAG) and counts.shape == (n_rows, 2, 5)
    assert len(p0) == 9 and ar.name == "cnn"
    assert (tmp_path / "cnn" / "results.pickle").exists()


def test_chip_smoke_sampled_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4d on the CPU at a small size: sampled serving,
    # the SNV scan, arbitrary variants and the score CLI, with 4c's model
    # and a YSD1 model; its own checks raise on a fault.
    from bear_tpu_torch.models import train_bear_net

    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    chip_smoke.lag13_train_phase(
        chunks, reads, groups, str(tmp_path / "cnn"), device="cpu", lag=LAG,
        cnn_kw={"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6},
        batch=1024, epochs=1, n_score=50)
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chunks:
        counter.add_chunk(c)
    cfg = chip_smoke.ysd1_config(str(tmp_path / "ysd1") + "*")
    cfg["train"]["epochs"] = "3"
    cfg["test"].update(test="False", train_test="False")
    train_bear_net.main(cfg, device="cpu")
    seqs = chip_smoke.decode_reads(reads[np.flatnonzero(groups == 1)[:40]])
    wt = chip_smoke.genome_prefix(300, genome_mb=0.05, seed=4)
    capsys.readouterr()
    chip_smoke.sampled_phase(counter.tables[LAG][0], LAG, str(tmp_path / "cnn"),
                             str(tmp_path / "ysd1"), seqs, wt, "CPU", device="cpu", mc=5,
                             n_variants=100, sampled_check=(8, 30, 20), map_check=(100, 50),
                             cli_wt_bp=40)
    out = capsys.readouterr().out
    for part in ("(C) 40 reads", "(D) 900 SNVs", "(E) 100 variants", "reduce='mean_std' =="):
        assert part in out
    assert out.count("[cli] score_cli") == 3


def test_chip_smoke_protein_phase_rehearsal(capsys):
    # chip_smoke.py's 4d (Cp) on the CPU at a small size: the protein cell's
    # proteome, CNN widths and table (at lag 3), one MC-5 call of 32
    # proteins; its own checks raise on a fault. The CPU runs the plain
    # forward: no launch.
    rec = chip_smoke.protein_phase("CPU", device="cpu", mc=5, lag=3, families=40, seqs=32)
    assert rec == {"launches": 0, "narrow_launches": 0}
    assert "(Cp) 32 proteins, MC-5" in capsys.readouterr().out


def test_chip_smoke_variant_generators():
    wt = chip_smoke.genome_prefix(1000, genome_mb=0.05, seed=4)
    assert set(wt) <= set("ACGT") and len(wt) == 1000
    pos, alts = chip_smoke.snv_grid(wt)
    assert len(pos) == 3000 and all(wt[p] != a for p, a in zip(pos, alts))
    variants = chip_smoke.make_variants(wt, 2000)
    assert variants == chip_smoke.make_variants(wt, 2000)
    from bear_tpu_torch.inference.scoring import parse_var

    kinds = np.zeros(4)
    for v in variants:
        ref, alt, p = parse_var(v)
        assert wt[p : p + len(ref)] == ref and p + len(ref) <= len(wt)
        if len(ref) == len(alt) == 1:
            kinds[0] += ref != alt
        elif len(ref) == len(alt):
            kinds[1] += 2 <= len(ref) <= 3
        elif not ref:
            kinds[2] += 1 <= len(alt) <= 5
        else:
            kinds[3] += not alt and 1 <= len(ref) <= 5
    assert kinds.sum() == 2000
    np.testing.assert_allclose(kinds / 2000, [0.4, 0.2, 0.2, 0.2], atol=0.03)


def test_chip_smoke_on_disk_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4e on the CPU at a small size: FASTQ files ->
    # summarize CLI -> lag-5 shards (held against a TransitionCounter's
    # rows and counts) -> streaming training CLI (first ELBOs vs float64,
    # streamed vs in-memory perplexities, cache, cleared state) -> score
    # CLI; its own checks raise on a fault.
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chip_smoke.read_chunks(reads, groups, rows=1024):
        counter.add_chunk(c)
    rows = counter.nonzero_rows(LAG)
    run = chip_smoke.summarize_phase(reads, groups, rows, counter.row_counts(LAG, rows),
                                     str(tmp_path / "disk"), device="cpu", lag=LAG)
    assert run["launches"] == 0 and run["chunks"] == 4  # 3,333 reads, 1,024 a chunk
    assert [g for _, g, _ in run["files"]] == [0, 0, 0, 1]
    assert run["files"][1][0].endswith(".fq.gz")
    applies = chip_smoke.streaming_train_phase(
        run["prefix"], run["shards"], reads, groups, str(tmp_path / "stream"),
        device="cpu", lag=LAG, cnn_kw={"filter_width": 3, "num_filters": 8,
                                       "kmer_layer1_width": 6},
        batch=256, epochs=2, n_cli=20)
    assert applies > 5
    out = capsys.readouterr().out
    for part in ("[summarize] -l 5:", "both groups' counts == phase 4's exactly",
                 "[stream] first 5 ELBOs", "(0/1 cache hits)", "score_cli seqs"):
        assert part in out, part


def test_chip_smoke_stream_config_is_the_streaming_cli_config():
    cfg = chip_smoke.stream_config("/out*", "/counts/run")
    from bear_tpu_torch.utils.config import RunConfig

    run = RunConfig.from_configparser(cfg)
    assert run.streaming and run.shuffle and run.cache and run.checkpoint_every == 32
    assert (run.lag, run.num_ds, run.train_column, run.test_column) == (13, 2, 0, 1)
    assert run.start_token == "run_lag_13_file_" and run.files_path == "/counts"
    assert run.ar_func_name == "cnn" and run.af_kwargs == chip_smoke.CNN_KW
    assert (run.batch_size_raw, run.epochs_raw, run.learning_rate) == (32768, "3", 0.005)
    assert run.test and run.train_test and run.precision == "float32"


def test_chip_smoke_other_models_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4f on the CPU at a small size, on 4e's outputs:
    # (H) the reference-guided CNN BEAR with the template as group 2 and the
    # reference-guided CLI on YSD1, (I) vBEAR, (J) lag selection by all four
    # routes, (K) the assembly CLI sampled and MAP with the streamed model,
    # and the float64 rollout check; their own checks raise on a fault.
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chunks:
        counter.add_chunk(c)
    rows = counter.nonzero_rows(LAG)
    run = chip_smoke.summarize_phase(reads, groups, rows, counter.row_counts(LAG, rows),
                                     str(tmp_path / "disk"), device="cpu", lag=LAG)
    cnn_kw = {"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6}
    chip_smoke.streaming_train_phase(run["prefix"], run["shards"], reads, groups,
                                     str(tmp_path / "stream"), device="cpu", lag=LAG,
                                     cnn_kw=cnn_kw, batch=512, epochs=1, n_cli=4)
    assert chip_smoke.reference_phase(reads, chunks, str(tmp_path / "ref"), device="cpu",
                                      lag=LAG, genome_mb=0.05, cnn_kw=cnn_kw, batch=256,
                                      epochs=2) == 0
    chip_smoke.vbear_phase(device="cpu", applies=100, gate=False)
    launches, table = chip_smoke.lag_select_phase(run["csv"], run["prefix"], device="cpu",
                                                  lag=LAG)
    assert launches == {"lag_select": 0, "lag_select_cli": 0} and table.lags == (1, 2, 3, 4, 5)
    assert chip_smoke.assembly_phase(reads, groups, run["csv"], str(tmp_path / "stream"),
                                     str(tmp_path / "asm"), device="cpu", lag=LAG,
                                     genome_mb=0.05, n_seeds=4, num=3, flank=20,
                                     check_cfg=(2, 2, 4, 10)) == {
                                         "assemble_cli": 0, "assemble": 0}
    out = capsys.readouterr().out
    for part in ("[ref] first 5 ELBOs vs CPU float64", "[ref] train_bear_ref.main on YSD1",
                 "[vbear] YSD1 linear", "the four routes agree", "assemble_cli sampled",
                 "assemble_cli map", "BMM float64 cpu vs CPU", "BEAR float64 cpu vs CPU",
                 "4 of 4 sequences identical", "the same 12 sequences"):
        assert part in out, part


def test_chip_smoke_reference_template_is_the_genome_unmutated():
    genome = chip_smoke.synth_genome(np.random.default_rng(chip_smoke.SEED), 250_000)
    ref = chip_smoke.reference_template(genome_mb=0.25)
    assert ref.shape == genome.shape and ref.dtype == np.int8
    np.testing.assert_array_equal(ref[:100_000], ref[100_000:200_000])
    assert 0.005 < np.mean(ref != genome) < 0.015  # the ~1% substitutions


def test_chip_smoke_beyond_dense_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4g on the CPU at a small size, on 4e's outputs
    # at lag 5: (L) summarize -l 7 in 3 row-range passes, (M) summarize -l 17
    # (sparse-first) and linear-BEAR applies, (N) select_lag over it against
    # (J)'s dense sweep and the CLI's --passes route, (O) lag-17 scoring and
    # sparse-table assembly; their own checks raise on a fault.
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chip_smoke.read_chunks(reads, groups, rows=1024):
        counter.add_chunk(c)
    rows = counter.nonzero_rows(LAG)
    run = chip_smoke.summarize_phase(reads, groups, rows, counter.row_counts(LAG, rows),
                                     str(tmp_path / "disk"), device="cpu", lag=LAG)
    ref_rows = chip_smoke.distinct_rows(reads, 17, "cpu")
    assert ref_rows[LAG] == len(rows) and ref_rows[1] == 5
    work = str(tmp_path / "beyond")
    lags = dict(dense_lag=LAG, device="cpu")
    p_run = chip_smoke.passes_phase(run, ref_rows, work, lag=7, passes=3, **lags)
    assert p_run["launches"] == 0 and p_run["passes"] == 3
    sparse_counter, model_dir = chip_smoke.sparse_phase(
        run, p_run, ref_rows, work, passes_lag=7, lag=17, applies=12, batch=256,
        check_chunks=2, **lags)
    _, dense = chip_smoke.lag_select_phase(run["csv"], run["prefix"], device="cpu", lag=LAG)
    assert chip_smoke.sparse_lag_phase(sparse_counter, dense, run["csv"], 3, p_run["chunks"],
                                       passes_lag=7, **lags) == 0
    chip_smoke.sparse_generation_phase(sparse_counter, model_dir, reads, groups, lag=17, genome_mb=0.05, n_seeds=4, num=3, flank=20,
                                       check_cfg=(2, 2, 4, 10), n_score=40, **lags)
    out = capsys.readouterr().out
    for part in ("summarize -l 7 --passes 3", "shards byte-identical to 4e's",
                 "-> SparseTransitionCounter", "of lags 6..7 == (L)'s", "the same keys and counts",
                 "first 5 ELBOs vs CPU", "select_lag over the sparse counter",
                 "assembly at lag 17 from a SparseTableIndex", "4 of 4 sequences identical",
                 "give the same 4 sequences"):
        assert part in out, part


def test_chip_smoke_mesh_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4i on the CPU at a small size, on 4e's and (M)'s
    # outputs: (S) rows over 2 replicas of the lag-5 table, (T) lags 1..7
    # over 3 row ranges against 4e's shards and --passes 3 (and the int32
    # reckoning at lags 1..14, which allocates nothing), (U) lags 1..17 sparse-first over 2 replicas
    # against (M)'s shards, (V) two gloo processes; their own checks raise
    # on a fault.
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chunks:
        counter.add_chunk(c)
    rows = counter.nonzero_rows(LAG)
    counts = counter.row_counts(LAG, rows)
    run = chip_smoke.summarize_phase(reads, groups, rows, counts, str(tmp_path / "disk"),
                                     device="cpu", lag=LAG)
    ref_rows = chip_smoke.distinct_rows(reads, 17, "cpu")
    work = str(tmp_path / "beyond")
    m_prefix = os.path.join(work, "sparse", "run")
    mf = chip_smoke.mf_for(sum(ref_rows.values()), run["n_bins"])
    chip_smoke.summarize_run(run["csv"], m_prefix, ["-l", "17", "-mf", mf], "cpu")
    assert chip_smoke.data_sharded_phase(chunks, rows, counts, device="cpu", lag=LAG) == 0
    launches = chip_smoke.row_split_phase(run, ref_rows, work, device="cpu", dense_lag=LAG,
                                          lag=7)
    assert launches == {"row_split": 0, "row_split_passes": 0}
    mesh_counter = chip_smoke.sparse_mesh_phase(run, ref_rows, m_prefix, work, device="cpu",
                                                lag=17)
    assert chip_smoke.two_process_phase(
        run, rows, counts, mesh_counter, work, device="cpu",
        reads_kw=dict(genome_mb=0.05, coverage=4, read_len=60, seed=4), rows=1024, lag=LAG,
        sparse_lag=17, timeout=300, threads=2) == 0
    out = capsys.readouterr().out
    for part in ("(S) chunk 0", "each replica's table == count_chunk_plain",
                 "tables == phase 4's exactly", "2 slices refused", "== summarize -l 7 --passes 3",
                 "needs that many devices; have", "shards == (M)'s, byte for byte",
                 "rank 0: ", "rank 1: ", "host MemAvailable", "both merges' results equal",
                 "every rank's merged tables == phase 4's"):
        assert part in out, part


def test_chip_smoke_data_parallel_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4j on the CPU at a small size, on 4c's and 4e's
    # outputs: (W) training and evaluation over a 2-entry CPU mesh, (X) the
    # CLIs and vBEAR over it, (Y) row-split serving and the likelihood, (Z)
    # two gloo processes training over a mesh that spans them (inside
    # (V)'s children); their own checks raise on a fault.
    from bear_tpu_torch.counting import summarize
    from bear_tpu_torch.counting.fastx import read_input_csv
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter

    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=4)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    cnn_kw = {"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6}
    b_rec, s_rec, z_rec = {}, {}, {}
    chip_smoke.lag13_train_phase(chunks, reads, groups, str(tmp_path / "cnn"), device="cpu",
                                 lag=LAG, cnn_kw=cnn_kw, batch=256, epochs=2, n_score=100,
                                 record=b_rec)
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chunks:
        counter.add_chunk(c)
    rows = counter.nonzero_rows(LAG)
    counts = counter.row_counts(LAG, rows)
    run = chip_smoke.summarize_phase(reads, groups, rows, counts, str(tmp_path / "disk"),
                                     device="cpu", lag=LAG)
    chip_smoke.streaming_train_phase(run["prefix"], run["shards"], reads, groups,
                                     str(tmp_path / "stream"), device="cpu", lag=LAG,
                                     cnn_kw=cnn_kw, batch=256, epochs=1, n_cli=4, record=s_rec)
    work = tmp_path / "work"
    work.mkdir()
    launches, w_out = chip_smoke.mesh_train_phase(
        chunks, b_rec, s_rec, run["shards"], str(work), device="cpu", lag=LAG,
        cnn_kw=cnn_kw, batch=256, epochs=2, stream_applies=4, stream_every=2)
    assert launches == 0  # the plain version runs on the CPU: no kernel
    chip_smoke.mesh_cli_phase(str(tmp_path / "dp"), device="cpu", epochs=50, gate=False,
                              check_applies=20, vbear_applies=50)
    chip_smoke.split_serving_phase(b_rec, s_rec, w_out, str(tmp_path / "split"), device="cpu",
                                   lag=LAG, cnn_kw=cnn_kw, n_check=40, snv_bp=60,
                                   genome_mb=0.05)
    sparse = SparseTransitionCounter(range(1, 18), n_groups=2, device="cpu")
    for chunk in summarize.iter_chunks(read_input_csv(run["csv"]), 17):
        sparse.add_chunk(chunk)
    sparse.flush()
    assert chip_smoke.two_process_phase(
        run, rows, counts, sparse, str(work), device="cpu",
        reads_kw=dict(genome_mb=0.05, coverage=4, read_len=60, seed=4), rows=1024, lag=LAG,
        sparse_lag=17, timeout=300, threads=2, z=dict(cnn_kw=cnn_kw, batch=256, applies=4),
        record=z_rec) == 0
    chip_smoke.z_against_w(z_rec, w_out, k=4)
    out = capsys.readouterr().out
    for part in ("(W) count -> serve's chunks counted again", "(W) 4c's protocol over the mesh",
                 "evaluation(mesh=) float64", "resumed after completion: no apply run",
                 "evaluation_streaming(mesh=) float64", "(X) train_bear_net.main",
                 "(X) train_bear_ref.main", "(X) vBEAR over the mesh",
                 "float32 scores bit-equal to 4c's", "float64 row-split == unsplit",
                 "bmm_likelihood(mesh=", "every rank's ELBOs, parameters and metrics bit-equal",
                 "(Z) first 4 ELBOs over two processes"):
        assert part in out, part


def test_chip_smoke_options_phase_rehearsal(tmp_path, capsys):
    # chip_smoke.py's phase 4h on the CPU at a small size: (P) the attention
    # CLI on YSD1 with its checks against float64, (Q) the optimizers, (R)
    # bfloat16 against float32 on a small handoff, and the trace; their own
    # checks raise on a fault.
    chip_smoke.attention_phase(str(tmp_path / "attn"), device="cpu", epochs=8)
    ran = chip_smoke.optimizer_phase(device="cpu", check_applies=4)
    assert ran == {name: 4 for name in ["adam"] + chip_smoke.OPTAX_NAMES}
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, read_len=60, seed=6)
    counter = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for c in chip_smoke.read_chunks(reads, groups, rows=1024):
        counter.add_chunk(c)
    codes, counts = counter.to_device_dataset(LAG)
    chip_smoke.bf16_phase(codes, counts, codes.shape[0], str(tmp_path / "trace"),
                          device="cpu", lag=LAG,
                          cnn_kw={"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6},
                          attn_kw={"d_model": 16, "num_heads": 2, "mlp_width": 32}, batch=1024,
                          epochs=2, trace_applies=2)
    out = capsys.readouterr().out
    for part in ("[attn] first 5 ELBOs vs CPU float64", "held-out perplexity BEAR",
                 "[optim] lion: 4 float64 applies", "[optim] YSD1 linear BEAR, float32",
                 "cnn: last ELBO bfloat16 vs float32", "attention: last ELBO bfloat16",
                 "utils.profiling.trace over 2 bfloat16 attention applies"):
        assert part in out, part
    assert (tmp_path / "trace" / "trace.json").exists()


def test_chip_smoke_attention_config_is_bear_attn_bear_cfg():
    """chip_smoke.py's (P) config holds bear_attn_bear.cfg's values, bar the
    out folder, the files (the port's bundled YSD1) and float32."""
    import configparser

    shipped = configparser.ConfigParser()
    shipped.read(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "bear_tpu", "models", "config_files", "bear_attn_bear.cfg"))
    ours = chip_smoke.attn_config("out*")
    for section in ("hyperp", "train", "test"):
        for key in ours[section]:
            assert ours[section][key] == shipped[section][key], (section, key)
    assert ours["model"]["ar_func_name"] == shipped["model"]["ar_func_name"]
    assert json.loads(ours["model"]["af_kwargs"]) == json.loads(shipped["model"]["af_kwargs"])
    assert ours["general"]["seed"] == shipped["general"]["seed"]
    assert ours["general"]["precision"] == "float32"


def test_chip_smoke_examples_phase_rehearsal(tmp_path, capsys, monkeypatch):
    # chip_smoke.py's phase 4k on the CPU at a small size: (AA) the genome
    # example in-process against 4c's rows and BMM perplexities on the same
    # reads (the example draws them from seed 0), (AB) and (AC) the
    # multi-process examples over two gloo processes each; their own checks
    # raise on a fault.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the examples' worker processes
    size = dict(genome_mb=0.05, coverage=4, read_len=60)
    reads, groups = chip_smoke.make_reads(**size)
    chunks = list(chip_smoke.read_chunks(reads, groups, rows=1024))
    b_rec = {}
    chip_smoke.lag13_train_phase(chunks, reads, groups, str(tmp_path / "cnn"), device="cpu",
                                 lag=LAG,
                                 cnn_kw={"filter_width": 3, "num_filters": 8,
                                         "kmer_layer1_width": 6},
                                 batch=1024, epochs=1, n_score=50, record=b_rec)
    argv = ["--genome-mb", "0.05", "--coverage", "4", "--read-len", "60", "--lag", str(LAG),
            "--epochs", "1", "--batch-size", "1024", "--device", "cpu"]
    assert chip_smoke.genome_example_phase(
        b_rec, argv=argv, device="cpu", want_rows=b_rec["rows"],
        want_transitions=len(reads) * 61) == 0  # the plain version: no kernel
    recs = chip_smoke.multihost_examples_phase(
        str(tmp_path), extra=["--device", "cpu", "--lag", "2", "--reads-per-file", "60",
                              "--read-len", "30"],
        want_transitions=4 * 60 * 31)
    assert [r["device"] for r in recs] == ["cpu"] * 3
    out = capsys.readouterr().out
    for part in (f"(AA) torch_genome_lag13.main({argv}):", "(== 4c's)",
                 "(AB) torch_multihost_counting --nproc 2 --bench:",
                 "(AC) torch_multihost_train --nproc 2 --bench:",
                 "(AC) torch_multihost_train --nproc 2 --bench --streaming:",
                 "h identical on all 2 ranks"):
        assert part in out, part
