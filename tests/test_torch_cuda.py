"""The port's CUDA path against its plain PyTorch path, on a card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor bear_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu_torch.counting import count_chunk, engine, fastx
from bear_tpu_torch.counting.count_chunk import count_chunk_update
from bear_tpu_torch.counting.window_hist import window_update, window_update_plain
from bear_tpu_torch.inference import serving
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models.ar_funcs import LinearAR
from bear_tpu_torch.ops import keyed_draw
from bear_tpu_torch.ops import keyed_random as kr
from bench_gpu import proteome

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_kernel_equals_plain_on_edge_cases(cuda):
    for name, base, keys in chip_smoke.hist_edge_cases(cuda):
        before = window_update.launches
        a = window_update(base.clone(), keys)
        b = window_update_plain(base.clone(), keys)
        torch.cuda.synchronize()
        assert torch.equal(a, b), name
        assert window_update.launches == before + (keys.numel() > 0)


def _chunks(rng):
    reads = []
    for i in range(200):
        s = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(0, 300))))
        reads.append((fastx.encode_seq(s, ambig=True), i % 2))
    pieces = list(engine.split_ambiguous(reads))
    return list(engine.chunk_reads(iter(pieces), 7, batch_size=64))


@pytest.mark.parametrize("reverse", [False, True])
def test_counter_on_card_equals_cpu(cuda, reverse):
    chunks = _chunks(np.random.default_rng(int(reverse)))
    gpu = engine.TransitionCounter(lags=(1, 4, 7), n_groups=2, reverse=reverse)
    cpu = engine.TransitionCounter(lags=(1, 4, 7), n_groups=2, reverse=reverse,
                                   device="cpu")
    gpu.FLUSH_EVERY = 20_000  # exercise mid-stream flushes on the card
    before = count_chunk_update.launches
    for c in chunks:
        gpu.add_chunk(c)
        cpu.add_chunk(c)
    # Through the fused kernel: one launch per chunk, two with reverse.
    assert count_chunk_update.launches == before + len(chunks) * (1 + reverse)
    for l in (1, 4, 7):
        np.testing.assert_array_equal(gpu.tables[l], cpu.tables[l])


def test_add_chunk_on_card_records_its_staging_spans(cuda):
    """Under a profiler, each chunk's add_chunk on the card is one root span
    over its staging (wait, fill, upload) and its launch."""
    from torch.profiler import ProfilerActivity, profile

    from bear_tpu_torch.utils import profiling

    chunks = _chunks(np.random.default_rng(3))
    gpu = engine.TransitionCounter(lags=(1, 4, 7), n_groups=2)
    cpu = engine.TransitionCounter(lags=(1, 4, 7), n_groups=2, device="cpu")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for c in chunks:
            gpu.add_chunk(c)
        gpu.sync()
    recs = profiling.recorded()
    profiling.clear()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["bear.count.add_chunk"] * len(chunks)
    feed = ["bear.count.stage_wait", "bear.count.stage", "bear.count.upload",
            "bear.count.launch"]
    for k, i in enumerate(roots):
        children = [r.name for r in recs if r.parent == i]
        assert children == (["bear.count.table_alloc"] if k == 0 else []) + feed, children
        assert all(r.root == i and r.end_ns is not None for r in recs if r.parent == i)
    for c in chunks:
        cpu.add_chunk(c)
    for l in (1, 4, 7):
        np.testing.assert_array_equal(gpu.tables[l], cpu.tables[l])


@pytest.mark.parametrize("case", chip_smoke.COUNT_CASES)
def test_count_chunk_equals_plain_on_edge_cases(cuda, case):
    lags, n_groups, A, passes = chip_smoke.count_case(case)
    before = count_chunk_update.launches
    a, b = chip_smoke.count_chunk_vs_plain(cuda, lags, n_groups, A, passes)
    assert count_chunk_update.launches == before + len(passes)
    assert int(a.sum()) > 0
    assert torch.equal(a, b)


def test_count_chunk_rejects_unaligned_codes_on_card(cuda):
    lags, n_groups = (2,), 1
    _, total = count_chunk.lag_offsets(lags, n_groups)
    table = torch.zeros(total, dtype=torch.int32, device=cuda)
    codes = torch.zeros(4 * 16 + 1, dtype=torch.int8, device=cuda)[1:].view(4, 16)
    meta = torch.from_numpy(count_chunk.pack_meta(
        np.full(4, 16), np.zeros(4), np.ones(4, bool), np.zeros(4))).to(cuda)
    before = count_chunk_update.launches
    with pytest.raises(ValueError, match="aligned"):
        count_chunk_update(table, codes, meta, lags, n_groups, 4)
    assert count_chunk_update.launches == before


def test_server_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, size=(500, 90)).astype(np.int8)
    groups = np.zeros(500, np.int32)
    tc = engine.TransitionCounter(lags=[6], device="cpu")
    for c in chip_smoke.read_chunks(reads, groups, rows=128):
        tc.add_chunk(c)
    seqs = chip_smoke.decode_reads(reads[:64])
    ar = LinearAR(6, 4, dtype=torch.float64, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    want = BearServer(tc.tables[6][0], 6, h=0.1, ar_apply=ar,
                      dtype=torch.float64, device="cpu").score(seqs)
    got = BearServer(tc.tables[6][0], 6, h=0.1, ar_apply=ar.to(cuda),
                     dtype=torch.float64).score(seqs)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_ragged_score_encode_on_card_syncs_nothing_and_equals_the_host_encode(cuda):
    """score()'s encode of 2,048 ragged proteins (the protein cell's batch:
    its configuration's length law, padded to 1,024) lays the codes into
    the matrix on the card without a host sync, equal to _encode_ragged."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "bench_gpu", "configs", "proteome_lag6_cnn.json")) as fh:
        p = json.load(fh)["proteome"]
    residues, lengths, _ = proteome.synth_proteome(
        3800000011, 2048, 1, p["median_len"], p["len_sigma"], p["min_len"], p["max_len"],
        p["substitution_rate"], p["held_out"])
    strs = proteome.strings(residues, lengths)
    lens = lengths.astype(np.int32)
    L = -(-int(lens.max()) // 64) * 64
    server = BearServer(np.zeros((engine.table_rows(1, 20), 21)), 1, van=1.0, alphabet="prot")
    server._encode_score(strs, lens, L)  # the first launches and allocations
    torch.cuda.synchronize()
    before = serving.ragged_device_pads
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes, got_lens = server._encode_score(strs, lens, L)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert serving.ragged_device_pads == before + 1
    assert codes.device.type == "cuda" and codes.dtype == torch.int8 and codes.shape == (2048, L)
    np.testing.assert_array_equal(codes.cpu().numpy(), server._encode_ragged(strs, lens, L))
    np.testing.assert_array_equal(got_lens.cpu().numpy(), lens)


def test_lag20_sparse_server_on_card_equals_cpu_and_its_lookup_syncs_nothing(cuda):
    """A lag-20 server over the sparse map of seeded reads scores on the card
    as on the CPU in float64 (MAP, MC-41, sampled SNV Δ); its lookup, the
    binary search on the card, runs without a host sync."""
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    lag = 20
    rng = np.random.default_rng(20)
    template = rng.integers(0, 4, size=400).astype(np.int8)
    starts = rng.integers(0, 300, size=600)
    reads = template[starts[:, None] + np.arange(100)[None, :]]
    sc = SparseTransitionCounter([lag], n_groups=1, device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(600, np.int32), rows=128):
        sc.add_chunk(c)
    widths = {"filter_width": 8, "num_filters": 96, "kmer_layer1_width": 64}
    ar = get_ar_func("cnn", lag, 4, widths, dtype=torch.float64, device="cpu")
    ar.requires_grad_(False)
    seqs = chip_smoke.decode_reads(reads[:64]) + ["ACGT" * 30]
    wt = seqs[0]
    pos = np.repeat(np.arange(len(wt)), 3)
    alt = np.array([a for c in wt for a in "ACGT" if a != c])
    kw = dict(mode="sample", key=kr.key(20), mc_samples=41, reduce="mean_std")
    servers = [BearServer(sc, lag, h=0.05, ar_apply=a, dtype=torch.float64, device=d)
               for a, d in ((ar, "cpu"), (copy.deepcopy(ar).to(cuda), cuda))]
    for call in (lambda s: s.score(seqs), lambda s: s.score(seqs, **kw),
                 lambda s: s.delta_scores_snv(wt, pos, alt, **kw)):
        np.testing.assert_allclose(call(servers[1]), call(servers[0]), rtol=1e-12, atol=1e-12)
    rows = serving._context_rows_and_next(
        torch.as_tensor(reads[:64], device=cuda), torch.full((64,), 100, device=cuda), lag)[0]
    servers[1]._gather(rows)  # the first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = servers[1]._gather(rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(got.cpu().numpy(), servers[0]._gather(rows.cpu()).numpy())


def test_philox_words_on_card_equal_cpu(cuda):
    keys = kr.fold_in(kr.key(12), torch.arange(100_000))
    streams = [(kr.NORMAL, 16), (kr.EXPONENTIAL, 15), (kr.BOOST, 5)]
    cpu = kr.stream_words(keys, 0, streams)
    gpu = kr.stream_words(keys.to(cuda), 0, streams)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    assert torch.equal(kr.fold_in(kr.key(12), torch.arange(100_000, device=cuda)).cpu(), keys)


def test_sampled_float64_on_card_equals_cpu(cuda):
    # The integer streams are identical; float64 transcendentals may differ
    # in the last bits, which can flip a Marsaglia-Tsang accept test that
    # lands on its boundary (expected in ~0 of these values).
    rng = np.random.default_rng(3)
    reads = rng.integers(0, 4, size=(300, 60)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[5], device="cpu")
    for c in chip_smoke.read_chunks(reads, np.zeros(300, np.int32), rows=128):
        tc.add_chunk(c)
    def ar():  # nn.Module.to moves in place: one module per device
        return LinearAR(5, 4, dtype=torch.float64, device="cpu",
                        generator=torch.Generator().manual_seed(0))

    kw = dict(h=0.2, dtype=torch.float64)
    cpu = BearServer(tc.tables[5][0], 5, ar_apply=ar(), device="cpu", **kw)
    gpu = BearServer(tc.tables[5][0], 5, ar_apply=ar().to(cuda), **kw)
    seqs = chip_smoke.decode_reads(reads[:32])
    wt = seqs[0]
    calls = [
        lambda s: s.score(seqs, mode="sample", key=kr.key(1), mc_samples=7),
        lambda s: s.delta_scores_snv(wt, list(range(60)), ["A"] * 60, mode="sample",
                                     key=kr.key(2), mc_samples=7),
        lambda s: s.delta_scores_variants(wt, ["0AC", wt[3:6] + "3", wt[10] + "10GG"],
                                          mode="sample", key=kr.key(3), mc_samples=7),
    ]
    for call in calls:
        np.testing.assert_allclose(call(gpu), call(cpu), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("A1,F,dtype,mode", chip_smoke.KEYED_DRAW_CASES)
def test_keyed_draw_equals_plain(cuda, A1, F, dtype, mode):
    # float64 at rtol 1e-12, float32 at 2e-6 of the operands' scale, -inf
    # and NaN where the plain version has them, at most SAMPLED_FLIPS of the
    # lanes beyond (chip_smoke.keyed_draw_vs_plain).
    before = keyed_draw.launches
    stats = chip_smoke.keyed_draw_vs_plain(chip_smoke.keyed_draw_inputs(A1, dtype, cuda), F, mode)
    assert keyed_draw.launches == before + 1
    assert stats["same_special"], stats
    assert stats["beyond"] <= chip_smoke.SAMPLED_FLIPS * stats["lanes"], stats


# Launch edges of the kernel: (samples, elements, groups), no E a multiple
# of 128. launch_shape gives 11 samples of 100,000 elements tiles of 6 (the
# last 5). Forced (tile, grid_y) besides: a sample a thread; tiles of 3
# over 2 rows of blocks and tiles of 2 over 1 (the grid-stride loop); one
# tile of all S.
EDGE_SHAPES = [(11, 100_000, 7), (5, 1037, 3)]


@pytest.mark.parametrize("A1", [5, 21])  # the compile-time row and the runtime one
@pytest.mark.parametrize("mode", ["picked", "full"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_keyed_draw_equals_plain_at_launch_edges(cuda, A1, mode, shape):
    inputs = chip_smoke.keyed_draw_inputs(A1, "float32", cuda, shape=shape, seed=A1)
    base, group, rows, conc, nxt = inputs
    S, E = shape[:2]
    chosen = keyed_draw.launch_shape(S, E, keyed_draw.sm_count(cuda.index))
    assert chosen.grid_x * keyed_draw.THREADS >= E and chosen.grid_y * chosen.tile >= S
    stats = chip_smoke.keyed_draw_vs_plain(inputs, 3, mode)
    assert stats["same_special"] and stats["beyond"] <= chip_smoke.SAMPLED_FLIPS * stats["lanes"]
    want = (keyed_draw.keyed_draw_picked(base, group, rows, conc, nxt, 3) if mode == "picked"
            else keyed_draw.keyed_draw_full(base, group, rows, conc, 3))
    for tile, grid_y in ((1, S), (3, 2), (S, 1), (2, 1)):
        out = torch.full_like(want, 7.0)
        keyed_draw.launch(base, group, rows, conc, 3, nxt if mode == "picked" else None, out,
                          chosen._replace(tile=tile, grid_y=grid_y))
        assert torch.equal(out, want), (tile, grid_y)  # every (s, e) once, the same bits


def test_keyed_draw_equals_plain_at_the_assembly_step(cuda):
    # (K)'s draw: one sample of 1,024 sequences, sequence b under group b,
    # four proposals, the whole row; float32 full mode bit-equal to plain.
    shape, _, F, mode = chip_smoke.KEYED_DRAW_FORMS["K_step"]
    inputs = chip_smoke.keyed_draw_form("K_step", cuda)
    assert keyed_draw.launch_shape(shape[0], shape[1], keyed_draw.sm_count(cuda.index)).tile == 1
    stats = chip_smoke.keyed_draw_vs_plain(inputs, F, mode)
    assert stats["same_special"] and stats["beyond"] == 0, stats


@pytest.mark.parametrize("A1", [5, 21])
def test_keyed_draw_nan_on_bad_indices_in_every_tile(cuda, A1):
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(A1, "float32", cuda,
                                                                shape=(11, 100_000, 7))
    bad = torch.tensor([0, 5, 99_999], device=cuda)
    group[bad[:2]] = torch.tensor([-1, 7], device=cuda)
    nxt[bad[2]] = A1
    got = keyed_draw.keyed_draw_picked(base, group, rows, conc, nxt, 3)
    keep = torch.ones(100_000, dtype=torch.bool, device=cuda)
    keep[bad] = False
    assert got[:, bad].isnan().all() and not got[:, keep].isnan().any()
    full = keyed_draw.keyed_draw_full(base, group, rows, conc, 3)
    keep[bad[2]] = True  # nxt is not read in full mode
    assert full[:, bad[:2]].isnan().all() and not full[:, keep].isnan().any()


def test_keyed_draw_marks_bad_indices_and_skips_empty_launches(cuda):
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float64", cuda)
    group[:3] = torch.tensor([-1, base.shape[1], 0])
    nxt[2] = 5
    got = keyed_draw.keyed_draw_picked(base, group, rows, conc, nxt, 3)
    assert got[:, :3].isnan().all() and not got[:, 3:].isnan().any()
    full = keyed_draw.keyed_draw_full(base, group, rows, conc, 3)
    assert full[:, :2].isnan().all() and not full[:, 2:].isnan().any()
    before = keyed_draw.launches
    empty = keyed_draw.keyed_draw_picked(base, group[:0], rows[:0], conc[:0], nxt[:0], 3)
    assert empty.shape == (base.shape[0], 0) and keyed_draw.launches == before
    with pytest.raises(ValueError, match="one device"):
        keyed_draw.keyed_draw_full(base.cpu(), group, rows, conc, 3)


def test_sampled_serving_draws_in_one_launch_per_call(cuda, monkeypatch):
    # The kernel keeps no temporaries in device memory, so the draw is not
    # sliced by SAMPLE_BUDGET_BYTES on the card; assembly launches once a step.
    from bear_tpu_torch.inference import serving
    from bear_tpu_torch.inference.assemble import assemble_no_ends

    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, size=(300, 60)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[5], device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(300, np.int32), rows=128):
        tc.add_chunk(c)
    server = BearServer(tc.table(5)[0], 5, van=0.3)
    seqs = chip_smoke.decode_reads(reads[:32])
    monkeypatch.setattr(serving, "SAMPLE_BUDGET_BYTES", 1)
    before = keyed_draw.launches
    server.score(seqs, mode="sample", key=kr.key(1), mc_samples=7)
    server.delta_scores_snv(seqs[0], [1, 2, 3], ["A", "C", "G"], mode="sample", key=kr.key(2),
                            mc_samples=7)
    assert keyed_draw.launches == before + 2
    assemble_no_ends(seqs[:2], [[3, 4]] * 2, 3, lag=5, counter_table=tc.table(5)[0], van=0.3)
    assert keyed_draw.launches == before + 2 + 3 + 4


@pytest.mark.parametrize("reverse", [False, True])
def test_summarize_on_card_writes_the_cpu_bytes(cuda, tmp_path, reverse):
    from bear_tpu_torch.counting import summarize

    rng = np.random.default_rng(3)
    rows = []
    for fi, group in enumerate((0, 1, 0)):
        with open(tmp_path / f"r{fi}.fq", "w") as fh:
            for i in range(300):
                s = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(0, 200))))
                fh.write(f"@r{i}\n{s}\n+\n{'F' * len(s)}\n")
        rows.append(f"r{fi}.fq,{group},fq\n")
    (tmp_path / "in.csv").write_text("".join(rows))
    out = {}
    for device in ("cuda", "cpu"):
        (tmp_path / device).mkdir()
        argv = [str(tmp_path / "in.csv"), str(tmp_path / device / "run"), "-l", "6",
                "--shuffle", "-mf", "0.0002", "--device", device] + (["-r"] if reverse else [])
        before = count_chunk_update.launches
        report = {}
        summarize.main(summarize.build_parser().parse_args(argv), report)
        launches = count_chunk_update.launches - before
        chunks = sum(r["stats"]["chunks"] for r in report.values())
        assert launches == (chunks if device == "cuda" else 0)
        out[device] = {f: (tmp_path / device / f).read_bytes()
                       for f in sorted(os.listdir(tmp_path / device))}
    assert len(out["cuda"]) >= 6 * 2 and out["cuda"] == out["cpu"]


@pytest.mark.parametrize("get_map", [False, True])
def test_assembly_float64_on_card_equals_cpu(cuda, get_map):
    # The keys and Gumbel words are the same integers on both devices; the
    # float64 draws may differ in the last bits, which could flip a pick
    # only at a Gumbel near-tie (expected in none of these sequences).
    from bear_tpu_torch.inference.assemble import assemble_no_ends

    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, size=(2000, 80)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[6], device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(2000, np.int32), rows=512):
        tc.add_chunk(c)
    table = tc.table(6)[0]
    assert table.is_cuda and table.dtype == torch.int32
    seeds = chip_smoke.decode_reads(reads[:6, :20])
    kw = dict(lag=6, van=0.4, seed=9, get_map=get_map, dtype=torch.float64)
    gpu, gpu_ent = assemble_no_ends(seeds, [[40, 60]] * 6, 5, counter_table=table, **kw)
    cpu, cpu_ent = assemble_no_ends(seeds, [[40, 60]] * 6, 5, counter_table=table.cpu(),
                                    device="cpu", **kw)
    np.testing.assert_array_equal(gpu, cpu)
    for a, b in zip(gpu_ent, cpu_ent):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("get_map", [False, True])
def test_bear_assembly_float64_on_card_equals_cpu(cuda, get_map):
    # BEAR mode: a window-dependent linear AR whose ar / h is of the counts'
    # size, the same parameters on both devices.
    from bear_tpu_torch.inference.assemble import assemble_no_ends

    rng = np.random.default_rng(6)
    reads = rng.integers(0, 4, size=(2000, 80)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[6], device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(2000, np.int32), rows=512):
        tc.add_chunk(c)
    table = tc.table(6)[0]
    cpu_ar = LinearAR(6, 4, dtype=torch.float64, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    cpu_ar.load_params([40.0 * p for p in cpu_ar.params_list()])
    gpu_ar = LinearAR(6, 4, dtype=torch.float64, device=cuda)
    gpu_ar.load_params(cpu_ar.params_list())
    seeds = chip_smoke.decode_reads(reads[:6, :20])
    kw = dict(lag=6, h=0.1, seed=9, get_map=get_map, dtype=torch.float64)
    with torch.no_grad():
        gpu, _ = assemble_no_ends(seeds, [[40, 60]] * 6, 5, counter_table=table, ar_apply=gpu_ar,
                                  **kw)
        cpu, _ = assemble_no_ends(seeds, [[40, 60]] * 6, 5, counter_table=table.cpu(),
                                  ar_apply=cpu_ar, device="cpu", **kw)
    np.testing.assert_array_equal(gpu, cpu)


def test_select_lag_on_card_equals_cpu(cuda):
    from bear_tpu_torch.models.lag_selection import select_lag

    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, size=(3000, 100)).astype(np.int8)
    reads[::3, 50:] = reads[::3, :50]  # some repeated structure
    groups = (np.arange(3000) % 2).astype(np.int32)
    gpu = engine.TransitionCounter(lags=range(1, 10), n_groups=2, device=cuda)
    cpu = engine.TransitionCounter(lags=range(1, 10), n_groups=2, device="cpu")
    for c in chip_smoke.read_chunks(reads, groups, rows=1024):
        gpu.add_chunk(c)
        cpu.add_chunk(c)
    for group in (0, 1):
        got = select_lag(gpu, group=group, batch_size=1000)
        want = select_lag(cpu, group=group)
        np.testing.assert_allclose(got.log_marginals, want.log_marginals, rtol=1e-12)
        assert got.best == want.best


@pytest.mark.parametrize("case", [n for n, _ in chip_smoke.SHARD_CASES] + ["poly_t_lag15"])
def test_count_chunk_row_range_equals_plain(cuda, case):
    lags, n_groups, A, inputs, passes, pass_ids = chip_smoke.shard_case(case)
    totals = []
    for d in pass_ids:
        before = count_chunk_update.launches
        a, b = chip_smoke.shard_vs_plain(cuda, lags, n_groups, A, inputs, passes, d)
        assert count_chunk_update.launches == before + len(inputs)
        assert torch.equal(a, b)
        totals.append(int(a.sum()))
        del a, b
    # The poly-T chunk's rows lie in the first pass and the last: each counts.
    assert all(totals) if case == "poly_t_lag15" else sum(totals) > 0, totals


def _wide_chunk(alphabet, max_lag, seed=0):
    """(codes, meta, A) of summarize's chunk shape: the first chunk
    chunks_from_packed makes of 1,100 reads of 150 residues in two groups
    (1,024 rows of 192). DNA reads carry a few ambiguous bases, so some rows
    are pieces that are not fresh."""
    from bear_tpu_torch.counting.count_chunk import pack_meta

    A = 4 if alphabet == "dna" else 20
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, A, size=(1100, 150)).astype(np.int8)
    if alphabet == "dna":
        reads[rng.random(reads.shape) < 0.002] = 4
    offsets = np.arange(len(reads) + 1, dtype=np.int64) * reads.shape[1]
    chunk = next(iter(engine.chunks_from_packed(
        reads.reshape(-1), offsets, rng.integers(0, 2, len(reads)), max_lag,
        ambig_code=4 if alphabet == "dna" else None, native=False)))
    assert chunk.codes.shape[0] == 1024
    meta = pack_meta(chunk.lengths, chunk.skip, chunk.stopped, chunk.groups, chunk.fresh)
    return np.ascontiguousarray(chunk.codes, np.int8), meta, A


def _on_card(cuda, codes, meta):
    return torch.from_numpy(codes).to(cuda), torch.from_numpy(meta).to(cuda)


def _equal_to_plain(cuda, total, launch, plain):
    a = torch.zeros(total, dtype=torch.int32, device=cuda)
    b = torch.zeros(total, dtype=torch.int32, device=cuda)
    launch(a)
    plain(b)
    torch.cuda.synchronize()
    same, n = torch.equal(a, b), int(a.sum(dtype=torch.int64))
    del a, b
    torch.cuda.empty_cache()
    return same, n


@pytest.mark.parametrize("alphabet", ["dna", "prot"])
def test_count_chunk_summarize_chunk_equals_plain(cuda, alphabet):
    # Summarize's 1,024 x 192 chunk in one launch over lags 1..13 (protein:
    # 1..5, the dense table's int32 limit for two groups).
    lags = tuple(range(1, 14 if alphabet == "dna" else 6))
    codes, meta, A = _wide_chunk(alphabet, max(lags))
    c, m = _on_card(cuda, codes, meta)
    _, total = count_chunk.lag_offsets(lags, 2, A)
    before = count_chunk_update.launches
    same, n = _equal_to_plain(
        cuda, total, lambda t: count_chunk_update(t, c, m, lags, 2, A),
        lambda t: count_chunk.count_chunk_plain(t, c, m, lags, 2, A))
    assert count_chunk_update.launches == before + 1
    assert same and n > len(lags) * 1000 * 100


@pytest.mark.parametrize("alphabet", ["dna", "prot"])
def test_count_chunk_row_range_every_pass_equals_plain(cuda, alphabet):
    # The row-range form in each of 9 passes: DNA over lags 1..15 (phase
    # 4g's layout), protein over lags 1..6.
    from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter

    lags = tuple(range(1, 16 if alphabet == "dna" else 7))
    codes, meta, A = _wide_chunk(alphabet, max(lags), seed=1)
    c, m = _on_card(cuda, codes, meta)
    layout = MultiPassTransitionCounter(lags, n_groups=2, passes=9, alphabet=alphabet,
                                        device=cuda)
    per_pass = []
    for d in range(9):
        shard = (d, layout._per_lag)
        same, n = _equal_to_plain(
            cuda, layout.table_size,
            lambda t: count_chunk_update(t, c, m, lags, 2, A, shard=shard),
            lambda t: count_chunk.count_chunk_plain(t, c, m, lags, 2, A, shard=shard))
        assert same, f"pass {d}"
        per_pass.append(n)
    # Each transition lands in exactly one pass's row range.
    length, skip, _, flags = meta.astype(np.int64).T[:, :, None]
    j = np.arange(codes.shape[1] + 1)[None, :]
    live = (j >= skip) & ((j < length) | ((j == length) & (flags & 1 != 0)))
    assert sum(per_pass) == sum(int((live & ((flags & 2 != 0) | (j >= l))).sum()) for l in lags)
    assert all(n > 0 for n in per_pass)


@pytest.mark.parametrize("key_math", ["mask", "mod"])
@pytest.mark.parametrize("shape", ["chosen", "runs_of_8", "split"])
def test_count_chunk_every_launch_shape_equals_plain(cuda, shape, key_math):
    # One kernel, any launch shape the launcher takes and either key math
    # for DNA (the remainder is protein's): the same counts as plain.
    lags = tuple(range(1, 14))
    codes, meta, A = _wide_chunk("dna", max(lags), seed=2)
    c, m = _on_card(cuda, codes, meta)
    B, L = codes.shape
    lt = count_chunk.lag_table(lags, 2, A)
    if key_math == "mod":
        lt = count_chunk.LagTable.from_buffer_copy(lt)
        lt.a_shift = 0
    sms = count_chunk.sm_count(cuda.index)
    pick = {"chosen": count_chunk.launch_shape(B, L, len(lags), sms),
            "runs_of_8": count_chunk.LaunchShape(count_chunk.tile_positions(L), 8, 1, 5),
            "split": count_chunk.LaunchShape(count_chunk.tile_positions(L, 1, 8), 1, 8, 7)}
    _, total = count_chunk.lag_offsets(lags, 2, A)
    same, _ = _equal_to_plain(
        cuda, total, lambda t: count_chunk.launch(t, c, m, lt, 0, pick[shape]),
        lambda t: count_chunk.count_chunk_plain(t, c, m, lags, 2, A))
    assert same


def test_count_chunk_launcher_refuses_a_bad_shape(cuda):
    lags = (1, 2)
    codes, meta, A = _wide_chunk("dna", 2)
    c, m = _on_card(cuda, codes, meta)
    _, total = count_chunk.lag_offsets(lags, 2, A)
    table = torch.zeros(total, dtype=torch.int32, device=cuda)
    lt = count_chunk.lag_table(lags, 2, A)
    for bad in [count_chunk.LaunchShape(256, 4, 4, 8),     # more groups than lags
                count_chunk.LaunchShape(2048, 4, 1, 8),    # tile beyond its threads' runs
                count_chunk.LaunchShape(64, 3, 3, 8),      # groups not 1, 2, 4 or 8
                count_chunk.LaunchShape(64, 9, 1, 8),      # run beyond 8
                count_chunk.LaunchShape(64, 2, 1, 0)]:     # no block
        with pytest.raises(RuntimeError, match="launch failed"):
            count_chunk.launch(table, c, m, lt, 0, bad)
    torch.cuda.synchronize()
    assert int(table.sum()) == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_multipass_and_sparse_counters_on_card_equal_cpu(cuda, reverse):
    from bear_tpu_torch.counting.multipass import count_multipass
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter

    chunks = _chunks(np.random.default_rng(10 + reverse))
    kw = dict(n_groups=2, passes=3)
    if reverse:  # the reverse complement through chunk_passes' second pass
        chunks = [c for c in chunks if not np.any(c.skip)]
    before = count_chunk_update.launches
    on_card = count_multipass(lambda: iter(chunks), (1, 4, 7), **kw)
    assert count_chunk_update.launches == before + 3 * len(chunks)
    on_cpu = count_multipass(lambda: iter(chunks), (1, 4, 7), device="cpu", **kw)
    sparse = {}
    for device in (cuda, "cpu"):
        sparse[device] = SparseTransitionCounter((3, 16, 20), n_groups=2, reverse=reverse,
                                                 device=device, device_buffer=1 << 18)
        for c in chunks:
            sparse[device].add_chunk(c)
    assert count_chunk_update.launches == before + 3 * len(chunks)
    for a, b, lags in ((on_card, on_cpu, (1, 4, 7)), (sparse[cuda], sparse["cpu"], (3, 16, 20))):
        for l in lags:
            ka, va = a._consolidated(l)
            kb, vb = b._consolidated(l)
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("path", ["forward", "apply_codes"])
def test_attention_float64_on_card_equals_cpu(cuda, path):
    """The attention AR's values and gradients in float64 on the card against
    the CPU, from the same parameters (a nonzero positional encoding)."""
    from bear_tpu_torch.models.ar_funcs import AttentionAR

    rng = np.random.default_rng(3)
    ar = AttentionAR(13, 4, dtype=torch.float64, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    params = ar.init(torch.Generator().manual_seed(2))
    params[1] = torch.from_numpy(0.3 * rng.normal(size=tuple(params[1].shape)))
    codes = torch.from_numpy(rng.integers(0, 5, size=(512, 13)).astype(np.int8))
    x = codes if path == "apply_codes" else torch.nn.functional.one_hot(
        codes.long(), 5).double()
    w = torch.from_numpy(rng.normal(size=(512, 5)))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tp = [p.to(dev).requires_grad_(True) for p in params]
        probs = getattr(ar, path)(x.to(dev), tp)
        (torch.log(probs) * w.to(dev)).sum().backward()
        out[dev.type] = (probs.detach().cpu(), [p.grad.cpu() for p in tp])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-10, atol=0)
    for g, h in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, h, rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("name", ["linear", "cnn", "attention"])
def test_bfloat16_compute_on_card(cuda, name):
    """bfloat16 compute on the card: float32 probabilities that sum to 1,
    within 0.03 of the float32 forward on the card."""
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    kw = {"linear": {}, "cnn": {"filter_width": 8, "num_filters": 96,
                                "kmer_layer1_width": 64}, "attention": {}}[name]
    ar32 = get_ar_func(name, 13, 4, kw, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    ar16 = get_ar_func(name, 13, 4, kw, compute_dtype=torch.bfloat16, device=cuda)
    params = ar32.params_list()
    codes = torch.from_numpy(np.random.default_rng(4).integers(0, 5, size=(4096, 13))
                             .astype(np.int8)).to(cuda)
    p32 = ar32.apply_codes(codes, params)
    p16 = ar16.apply_codes(codes, params)
    assert p16.dtype == torch.float32 and p16.is_cuda
    torch.testing.assert_close(p16.sum(-1), torch.ones(4096, device=cuda), rtol=0, atol=1e-5)
    assert float((p16 - p32).abs().max()) <= 0.03


def _mesh_chunks(seed):
    """Chunks with ambiguous pieces (fresh flags) and a row count no mesh
    size here divides, so the data split pads."""
    rng = np.random.default_rng(seed)
    reads = [(fastx.encode_seq("".join(rng.choice(list("ACGTN"), size=int(n))), ambig=True),
              i % 2) for i, n in enumerate(rng.integers(0, 200, 301))]
    return list(engine.chunk_reads(engine.split_ambiguous(iter(reads)), 17, batch_size=61))


@pytest.mark.parametrize("layout", ["every_card", "cuda0_repeated"])
def test_mesh_counters_on_card_equal_cpu(cuda, layout):
    # The data- and row-split counters and the sparse counter's mesh= on
    # the card: the same counts as on a CPU mesh of the same size, one
    # count_chunk launch per device per chunk, and every slice on its card.
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.parallel import (KmerShardedTransitionCounter, Mesh,
                                         ShardedTransitionCounter, data_parallel_mesh)

    mesh = {"every_card": lambda a: data_parallel_mesh(axis_name=a),
            "cuda0_repeated": lambda a: Mesh([cuda] * 3, (a,))}[layout]
    D = mesh("data").size
    cpu = lambda a: Mesh(["cpu"] * D, (a,))  # noqa: E731
    chunks = _mesh_chunks(D)
    lags = (1, 4, 7)
    data = [ShardedTransitionCounter(m("data"), lags, n_groups=2) for m in (mesh, cpu)]
    rows = [KmerShardedTransitionCounter(lags, n_groups=2, mesh=m("kmer")) for m in (mesh, cpu)]
    sparse = [SparseTransitionCounter([17], n_groups=2, mesh=m("data"), device_buffer=4096)
              for m in (mesh, cpu)]
    before = count_chunk_update.launches
    for c in chunks:
        for tc in data + rows + sparse:
            tc.add_chunk(c)
    assert count_chunk_update.launches == before + 2 * D * len(chunks)
    assert [p.device for p in data[0].partial_tables()] == list(mesh("data").devices)
    for l in lags:
        np.testing.assert_array_equal(data[0].tables[l], data[1].tables[l])
        rows_l = rows[1].nonzero_rows(l)
        np.testing.assert_array_equal(rows[0].nonzero_rows(l), rows_l)
        np.testing.assert_array_equal(rows[0].counts_for_rows(l, rows_l),
                                      data[1].tables[l][:, rows_l, :].transpose(1, 0, 2))
    for a, b in zip(sparse[0]._consolidated(17), sparse[1]._consolidated(17)):
        np.testing.assert_array_equal(a, b)


def test_mesh_refuses_more_cards_than_exist(cuda, tmp_path):
    from bear_tpu_torch.counting import summarize
    from bear_tpu_torch.parallel import data_parallel_mesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, have {n}"):
        data_parallel_mesh(n + 1)
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGT\n")
    csv = tmp_path / "in.csv"
    csv.write_text(f"{fa},0,fa\n")
    with pytest.raises(ValueError, match=f"needs that many devices; have {n}"):
        summarize.run_counting(str(csv), [3], kmer_shards=n + 1)


@pytest.mark.parametrize("layout", ["every_card", "cuda0_repeated"])
def test_mesh_training_on_card_equals_cpu(cuda, layout):
    # Data-parallel training and evaluation over a mesh of the cards (or
    # cuda:0 named twice) in float64: the same ELBOs, parameters and
    # metrics as the CPU run without a mesh, to reassociation.
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.parallel import Mesh, data_parallel_mesh

    mesh = {"every_card": lambda: data_parallel_mesh(),
            "cuda0_repeated": lambda: Mesh([cuda] * 2, ("data",))}[layout]()
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (300, 6)).astype(np.int8)
    counts = rng.poisson(4.0, (300, 2, 5)).astype(np.float64)
    kw = dict(num_kmers=300, batch_size=64, epochs=4, learning_rate=0.02, seed=3,
              acc_steps=2, dtype=torch.float64)
    want = bear_net.train(codes, counts[:, 0], ar_func=get_ar_func(
        "cnn", 6, 4, {"num_filters": 8, "filter_width": 3, "kmer_layer1_width": 8},
        dtype=torch.float64, device="cpu"), device="cpu", **kw)
    ar = get_ar_func("cnn", 6, 4, {"num_filters": 8, "filter_width": 3, "kmer_layer1_width": 8},
                     dtype=torch.float64, device=mesh.devices.flat[0])
    got = bear_net.train(codes, counts[:, 0], ar_func=ar, mesh=mesh, **kw)
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-9)
    for a, b in zip(got.params_list, want.params_list):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    ev = bear_net.evaluation(codes, counts, 0, 1, "dna", got.h, ar, got.params_list[1:],
                             [1.0], batch_size=64, dtype=torch.float64, mesh=mesh)
    ev1 = bear_net.evaluation(codes, counts, 0, 1, "dna", got.h, ar, got.params_list[1:],
                              [1.0], batch_size=64, dtype=torch.float64)
    for a, b in zip(ev[:6], ev1[:6]):
        np.testing.assert_allclose(a, b, rtol=1e-9)


@pytest.mark.parametrize("layout", ["every_card", "cuda0_repeated"])
def test_row_split_serving_on_card_equals_dense(cuda, layout):
    # The table row-split over the cards (or cuda:0 named three times):
    # MAP and sampled scores bit-equal to the dense table's on the card.
    from bear_tpu_torch.parallel import Mesh, data_parallel_mesh

    mesh = {"every_card": lambda: data_parallel_mesh(axis_name="kmer"),
            "cuda0_repeated": lambda: Mesh([cuda] * 3, ("kmer",))}[layout]()
    rng = np.random.default_rng(6)
    table = rng.poisson(0.5, (engine.table_rows(5), 5)).astype(np.int32)
    seqs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(5, 90, 40)]
    ar = LinearAR(5, 4, generator=torch.Generator().manual_seed(0), device=cuda)
    for dtype in (torch.float32, torch.float64):
        dense = BearServer(table, 5, h=0.1, ar_apply=ar, dtype=dtype)
        split = BearServer(table, 5, h=0.1, ar_apply=ar, dtype=dtype, mesh=mesh)
        np.testing.assert_array_equal(dense.score(seqs), split.score(seqs))
        key = kr.key(2)
        np.testing.assert_array_equal(dense.score(seqs, mode="sample", key=key, mc_samples=3),
                                      split.score(seqs, mode="sample", key=key, mc_samples=3))


@pytest.mark.parametrize("what", ["bmm_likelihood", "data_split"])
def test_no_mesh_on_card_names_cuda0(cuda, what):
    # device="cuda" without an index over cuda:0 tensors, with no mesh: the
    # split resolves the card to cuda:0, so the tensors' device is its key
    # (tests/test_torch_mesh_training.py's bmm_likelihood tolerance).
    from bear_tpu_torch.data import bmm_likelihood, load_dense
    from bear_tpu_torch.parallel.mesh import DataSplit
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    counts = torch.from_numpy(load_dense(bundled_ysd1_path(), "dna", 3).counts)
    if what == "bmm_likelihood":
        alpha = np.array([0.1, 1.0, 10.0])
        got = bmm_likelihood(counts.to(cuda), alpha, batch_size=400, device="cuda")
        want = bmm_likelihood(counts, alpha, batch_size=400, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-12)
        return
    split = DataSplit(None, "cuda")
    assert split.master == cuda and split.n == 1 and not split.spans
    x = counts.to(cuda)
    parts = split.split(x)
    assert [p.device for p in parts] == [cuda] and parts[0].data_ptr() == x.data_ptr()
    total = split.sum([torch.lgamma(p + 1.0).sum(dim=0) for p in parts])
    cpu = DataSplit(None, "cpu")
    want = cpu.sum([torch.lgamma(p + 1.0).sum(dim=0) for p in cpu.split(counts)])
    assert total.device == cuda and split.allreduce([total])[0] is total
    np.testing.assert_allclose(total.cpu().numpy(), want.numpy(), rtol=1e-12)


# The CNN kernel (csrc/cnn_forward.cu) against CNNAR's plain forward, at the
# lag-13 CNN of the benchmark, at a small one and at a wide one (two blocks
# of filters and two of hidden units), on one-hot and on dense random
# inputs; chip_smoke.cnn_forward_vs_plain holds float32 at CNN_F32_ATOL on
# the probabilities and float64 at rtol 1e-12. The narrow instance (one
# block of 32 filters and 16 hidden units): the small CNN, the protein
# cell's (lag 6, A1 21, bear_cnn_bear.cfg's widths), YSD1's at those widths
# (lag 5, DNA) and its edge (32 filters, 16 hidden units); one filter or one
# hidden unit past it takes the padded instance. Values: (lag, alphabet
# size, widths).
CNN_CASES = {"lag13": (13, 4, {"filter_width": 8, "num_filters": 96, "kmer_layer1_width": 64}),
             "small": (5, 4, {"filter_width": 3, "num_filters": 8, "kmer_layer1_width": 6}),
             "wide": (13, 4, {"filter_width": 8, "num_filters": 128, "kmer_layer1_width": 96}),
             "protein": (6, 20, {"filter_width": 3, "num_filters": 30, "kmer_layer1_width": 16}),
             "ysd1": (5, 4, {"filter_width": 3, "num_filters": 30, "kmer_layer1_width": 16}),
             "narrow_edge": (6, 20, {"filter_width": 3, "num_filters": 32,
                                     "kmer_layer1_width": 16}),
             "past_filters": (6, 20, {"filter_width": 3, "num_filters": 33,
                                      "kmer_layer1_width": 16}),
             "past_hidden": (6, 20, {"filter_width": 3, "num_filters": 32,
                                     "kmer_layer1_width": 17})}
NARROW_CASES = {"small", "protein", "ysd1", "narrow_edge"}


def _cnn_inputs(cuda, case, dtype, n, dense, seed=0):
    """A CNN of the case's widths with every parameter away from its init
    (scales 1, intercepts 0), and n seeded k-mers on the card."""
    from bear_tpu_torch.models.ar_funcs import get_ar_func

    lag, A, kw = CNN_CASES[case]
    g = torch.Generator().manual_seed(seed)
    ar = get_ar_func("cnn", lag, A, kw, dtype=dtype, device=cuda, generator=g)
    params = [(p + 0.3 * torch.randn(p.shape, generator=g, dtype=dtype).to(cuda)).detach()
              for p in ar.params_list()]
    if dense:
        x = torch.randn((n, lag, A + 1), generator=g, dtype=dtype)
    else:
        x = torch.nn.functional.one_hot(torch.randint(0, A + 1, (n, lag), generator=g),
                                        A + 1).to(dtype)
    return ar, params, x.to(cuda)


@pytest.mark.parametrize("n", [1, 33, 1024, (1 << 18) + 7])
@pytest.mark.parametrize("dense", [False, True], ids=["one_hot", "dense"])
@pytest.mark.parametrize("case", list(CNN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_cnn_forward_equals_plain(cuda, n, dense, case, dtype):
    from bear_tpu_torch.ops import cnn_forward

    ar, params, x = _cnn_inputs(cuda, case, dtype, n, dense)
    nf, w1 = params[0].shape[2], params[2].shape[2]
    assert cnn_forward.is_narrow(nf, w1) == (case in NARROW_CASES)
    before, narrow_before = cnn_forward.launches, cnn_forward.narrow_launches
    with torch.no_grad():
        got = ar(x, params)
        want = ar._forward_plain(x, params)
    assert cnn_forward.launches == before + 1
    assert cnn_forward.narrow_launches == narrow_before + (case in NARROW_CASES)
    assert got.dtype == dtype and got.shape == (n, x.shape[2])
    stats = chip_smoke.cnn_forward_vs_plain(x, params)
    assert stats["held"], stats
    if dtype == torch.float32:  # as close to float64 as the plain forward is
        assert stats["kernel_err64"] <= 2 * stats["plain_err64"] + 1e-7, stats
    # Every tile computes a row alike: the same bits.
    for shape in cnn_forward.TILES[x.element_size()]:
        with torch.no_grad():
            other = cnn_forward.launch(x, params, torch.empty_like(want), shape)
        torch.testing.assert_close(other, got, rtol=0, atol=0)


def test_cnn_forward_shared_memory_mirror_and_refusals(cuda):
    """ops.cnn_forward.smem_bytes against the launcher's own layout at the
    edge of shared memory: 288 filters (three blocks) fit the 64-row float
    tile and launch, 289 (four) are refused there and launch in 16-row
    tiles, both equal to the plain forward; a tile the launcher lacks is
    refused."""
    from bear_tpu_torch.models.ar_funcs import CNNAR
    from bear_tpu_torch.ops import cnn_forward

    g = torch.Generator().manual_seed(5)
    x = torch.nn.functional.one_hot(torch.randint(0, 5, (300, 13), generator=g), 5).float()
    x = x.to(cuda)
    large, small = cnn_forward.TILES[4]
    for nf, fits in ((288, True), (289, False)):
        ar = CNNAR(13, 4, 8, nf, 64, device=cuda, generator=g)
        params = [(p + 0.3 * torch.randn(p.shape, generator=g).to(cuda)).detach()
                  for p in ar.params_list()]
        assert (cnn_forward.smem_bytes(large.rows, 4, 13, 5, 8, nf, 64)
                <= cnn_forward.SMEM_MAX) == fits
        with torch.no_grad():
            want = ar._forward_plain(x, params)
            for shape in (large, small):
                out = torch.empty_like(want)
                if shape == large and not fits:
                    with pytest.raises(RuntimeError, match="launch failed"):
                        cnn_forward.launch(x, params, out, shape)
                    continue
                cnn_forward.launch(x, params, out, shape)
                assert float((out - want).abs().max()) <= chip_smoke.CNN_F32_ATOL
    ar, params, x = _cnn_inputs(cuda, "small", torch.float32, 40, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        cnn_forward.launch(x, params, torch.empty((40, 5), device=cuda),
                           cnn_forward.LaunchShape(48, 128))  # no such tile


def test_cnn_forward_nan_and_inf_propagate_as_in_plain(cuda):
    # A non-finite input reaches only its own row, as in the plain forward.
    ar, params, x = _cnn_inputs(cuda, "lag13", torch.float32, 200, True)
    x[3, 0, 0], x[70, 12, 4], x[150, 5, 2] = float("nan"), float("inf"), -float("inf")
    with torch.no_grad():
        got, want = ar(x, params), ar._forward_plain(x, params)
    torch.testing.assert_close(got.isnan(), want.isnan(), rtol=0, atol=0)
    finite = want.isfinite().all(-1)
    assert int(finite.sum()) >= 197
    assert float((got[finite] - want[finite]).abs().max()) <= chip_smoke.CNN_F32_ATOL


def test_cnn_forward_nan_and_inf_propagate_at_narrow_widths(cuda):
    # The narrow instance as the padded one: a non-finite input reaches only
    # its own row, as in the plain forward.
    from bear_tpu_torch.ops import cnn_forward

    ar, params, x = _cnn_inputs(cuda, "protein", torch.float32, 200, True)
    x[3, 0, 0], x[70, 5, 20], x[150, 2, 7] = float("nan"), float("inf"), -float("inf")
    before = cnn_forward.narrow_launches
    with torch.no_grad():
        got, want = ar(x, params), ar._forward_plain(x, params)
    assert cnn_forward.narrow_launches == before + 1
    torch.testing.assert_close(got.isnan(), want.isnan(), rtol=0, atol=0)
    finite = want.isfinite().all(-1)
    assert int(finite.sum()) >= 197
    assert float((got[finite] - want[finite]).abs().max()) <= chip_smoke.CNN_F32_ATOL


def test_cnn_forward_keeps_aten_under_grad_and_compute_dtype(cuda):
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.ops import cnn_forward

    ar, params, x = _cnn_inputs(cuda, "small", torch.float32, 300, False)
    before = cnn_forward.launches
    live = [p.clone().requires_grad_(True) for p in params]
    out = ar(x, live)
    out.log().sum().backward()
    assert cnn_forward.launches == before and all(p.grad is not None for p in live)
    ar16 = get_ar_func("cnn", 5, 4, CNN_CASES["small"][2], compute_dtype=torch.bfloat16,
                       device=cuda)
    with torch.no_grad():
        ar16(x, params)
    assert cnn_forward.launches == before


def test_sampled_serving_launches_the_cnn_kernel_per_ar_slice(cuda, monkeypatch):
    """BearServer.score at MC-41, reduced to mean and std: one launch per AR
    slice, and the scores within the benchmark check's limits of those with
    the kernel off (the ATen forward)."""
    import json

    from bear_tpu_torch.inference import serving
    from bear_tpu_torch.models import ar_funcs
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.ops import cnn_forward
    from bench_gpu.traffic.score import readings

    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, size=(4096, 60)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[9], device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(4096, np.int32), rows=1024):
        tc.add_chunk(c)
    ar = get_ar_func("cnn", 9, 4, {"filter_width": 4, "num_filters": 96,
                                   "kmer_layer1_width": 64},
                     device=cuda, generator=torch.Generator().manual_seed(1))
    ar.requires_grad_(False)
    server = BearServer(tc.table(9)[0], 9, h=0.05, ar_apply=lambda oh: ar(oh) + 1e-7)
    seqs = chip_smoke.decode_reads(reads)
    monkeypatch.setattr(serving, "AR_SLICE_ROWS", 1 << 16)
    slices = -(-len(seqs) * 61 // (1 << 16))
    kw = dict(mode="sample", key=kr.key(3), mc_samples=41, reduce="mean_std")
    before = cnn_forward.launches
    got = server.score(seqs, **kw)
    assert cnn_forward.launches == before + slices == before + 4
    monkeypatch.setattr(ar_funcs, "_kernel_takes", lambda *a: False)
    want = server.score(seqs, **kw)
    assert cnn_forward.launches == before + slices
    with open(os.path.join(os.path.dirname(chip_smoke.__file__), "bench_gpu", "cells",
                           "genome13_score_mc41.json")) as f:
        cell = json.load(f)
    got_r = readings([got], [want], cell["params"]["share_over"])
    assert all(got_r[k] <= v for k, v in cell["limits"].items()), got_r


# The attention kernel (csrc/attention_forward.cu) against AttentionAR's plain
# block under no_grad, through forward and apply_codes, at the benchmark's
# widths and at a second (lag 5, A1 21, D 24, 3 heads, M 40), every leaf
# non-zero; chip_smoke.attention_forward_vs_plain holds float64 at rtol 1e-12
# and float32 at ATTN_F32_ATOL and within twice the plain block's own gap to
# float64. Row counts: one, around a block's 16 rows and a warp's 2, a 2^18
# slice and genome13_attn_score_mc41's 94,208-row tail.
ATTN_CASES = {"published": (13, 4, chip_smoke.ATTN_KW),
              "second": (5, 20, {"d_model": 24, "num_heads": 3, "mlp_width": 40}),
              # heads wider than a team of 16 lanes: one head of 128 columns
              # (two column blocks in float; double's wk and wv overflow
              # shared memory), one of 64 (two blocks in double, a whole team
              # in float)
              "head128": (13, 4, {"d_model": 128, "num_heads": 1, "mlp_width": 64}),
              "head64": (13, 4, {"d_model": 64, "num_heads": 1, "mlp_width": 96})}


def _attention_inputs(cuda, case, dtype, n):
    lag, A, kw = ATTN_CASES[case]
    ar, params = chip_smoke.attention_case(cuda, dtype, lag=lag, A=A, kw=kw)
    g = torch.Generator().manual_seed(n)
    codes = torch.randint(0, A + 1, (n, lag), generator=g, dtype=torch.int8).to(cuda)
    oh = torch.nn.functional.one_hot(codes.long(), A + 1).to(dtype)
    return ar, params, codes, oh


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1 << 18, 94_208])
@pytest.mark.parametrize("path", ["forward", "apply_codes"])
@pytest.mark.parametrize("case", ["published", "second"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_attention_forward_equals_plain(cuda, n, path, case, dtype):
    _hold_attention_forward(cuda, n, path, case, dtype)


@pytest.mark.parametrize("n", [1, 65, 1 << 18, 94_208])
@pytest.mark.parametrize("path", ["forward", "apply_codes"])
@pytest.mark.parametrize("dtype,case", [(torch.float32, "head128"), (torch.float64, "head64"),
                                        (torch.float32, "head64")],
                         ids=["float32-head128", "float64-head64", "float32-head64"])
def test_attention_forward_wide_heads_equal_plain(cuda, n, path, dtype, case):
    """Heads past a team's 16 lanes take the kernel (the instance whose
    heads span column blocks) and equal the plain block as any other."""
    from bear_tpu_torch.ops import attention_forward

    lag, A, kw = ATTN_CASES[case]
    width = kw["d_model"] // kw["num_heads"]
    itemsize = torch.tensor([], dtype=dtype).element_size()
    assert attention_forward.head_lanes(kw["d_model"], kw["num_heads"], itemsize) == 16
    assert (width > 16 * 16 // itemsize) is (case == "head128" or dtype == torch.float64)
    _hold_attention_forward(cuda, n, path, case, dtype)


def _hold_attention_forward(cuda, n, path, case, dtype):
    """One launch through ``path`` under no_grad, held against the plain
    block; every launch shape that fits shared memory gives the same bits."""
    from bear_tpu_torch.ops import attention_forward

    ar, params, codes, oh = _attention_inputs(cuda, case, dtype, n)
    before = attention_forward.launches
    with torch.no_grad():
        got = ar(oh, params) if path == "forward" else ar.apply_codes(codes, params)
    assert attention_forward.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, oh.shape[-1])
    stats = chip_smoke.attention_forward_vs_plain(ar, oh, params)
    assert stats["held"], stats
    # Every launch shape the kernel takes computes a row alike: the same bits.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widths = (ar.lag, ar.A1, ar.d_model, ar.num_heads, ar.mlp_width)
    itemsize = oh.element_size()
    for resident in (False, True):
        for warps in (8, 4, 1):
            if attention_forward.smem_bytes(warps, itemsize, *widths, resident) \
                    > attention_forward.SMEM_MAX:
                continue
            shape = attention_forward.LaunchShape(warps, min(sms, n), resident)
            with torch.no_grad():
                other = attention_forward.launch(oh, params, ar.num_heads,
                                                 torch.empty_like(got), shape)
            torch.testing.assert_close(other, got, rtol=0, atol=0)


def test_attention_forward_shared_memory_mirror_and_refusals(cuda):
    """ops.attention_forward.smem_bytes against the launcher's own layout at
    the edge of shared memory: at the longest lag whose block of 8 warps
    fits, 8 warps launch, and one position more they are refused while 4
    launch, both equal to the plain block; the same edge with the weights
    resident; a shape the launcher lacks is refused."""
    from bear_tpu_torch.ops import attention_forward

    for resident in (False, True):
        def smem(warps, lag):
            return attention_forward.smem_bytes(warps, 4, lag, 5, 64, 4, 128, resident)

        lag = max(l for l in range(1, 200) if smem(8, l) <= attention_forward.SMEM_MAX)
        for L, fits in ((lag, True), (lag + 1, False)):
            ar, params = chip_smoke.attention_case(cuda, torch.float32, lag=L)
            x = chip_smoke.attention_contexts(300, L, 5, torch.float32, cuda)
            with torch.no_grad():
                want = ar._block_plain(params, x, (300,), torch.float32)
                for warps in (8, 4):
                    out = torch.empty_like(want)
                    shape = attention_forward.LaunchShape(warps, 19, resident)
                    if warps == 8 and not fits:
                        with pytest.raises(RuntimeError, match="launch failed"):
                            attention_forward.launch(x, params, 4, out, shape)
                        continue
                    attention_forward.launch(x, params, 4, out, shape)
                    assert float((out - want).abs().max()) <= chip_smoke.ATTN_F32_ATOL
    ar, params, _, oh = _attention_inputs(cuda, "second", torch.float32, 40)
    with pytest.raises(RuntimeError, match="launch failed"):
        attention_forward.launch(oh, params, 3, torch.empty((40, 21), device=cuda),
                                 attention_forward.LaunchShape(9, 1, False))  # 288 threads


def test_attention_forward_nan_and_inf_propagate_as_in_plain(cuda):
    # A non-finite input reaches only its own row, as in the plain block.
    ar, params, _, oh = _attention_inputs(cuda, "published", torch.float32, 200)
    oh[3, 0, 0], oh[70, 12, 4], oh[150, 5, 2] = float("nan"), float("inf"), -float("inf")
    with torch.no_grad():
        got, want = ar(oh, params), ar._block_plain(params, oh, (200,), torch.float32)
    torch.testing.assert_close(got.isnan(), want.isnan(), rtol=0, atol=0)
    finite = want.isfinite().all(-1)
    assert int(finite.sum()) >= 197
    assert float((got[finite] - want[finite]).abs().max()) <= chip_smoke.ATTN_F32_ATOL


def test_attention_forward_keeps_aten_under_grad_and_compute_dtype(cuda):
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.ops import attention_forward

    ar, params, codes, oh = _attention_inputs(cuda, "published", torch.float32, 300)
    before = attention_forward.launches
    live = [p.clone().requires_grad_(True) for p in params]
    ar(oh, live).log().sum().backward()
    ar.apply_codes(codes, live).log().sum().backward()
    assert attention_forward.launches == before and all(p.grad is not None for p in live)
    ar16 = get_ar_func("attention", 13, 4, chip_smoke.ATTN_KW, compute_dtype=torch.bfloat16,
                       device=cuda)
    with torch.no_grad():
        ar16(oh, params)
    assert attention_forward.launches == before


def test_sampled_serving_launches_the_attention_kernel_per_ar_slice(cuda, monkeypatch):
    """BearServer.score at MC-41 with the attention AR, reduced to mean and
    std: one launch per AR slice. Its MAP scores with the kernel lie no
    farther from a float64 server's than twice those of the ATen block (the
    kernel's own rule against float64), + 1e-7 relative. (Sampled scores are
    not compared here: on these short random reads two float32 roundings of
    the AR, ATen's against float64's, flip accept tests in 0.12% of the
    reads, past the benchmark cell's 0.1%.)"""
    from bear_tpu_torch.inference import serving
    from bear_tpu_torch.models import ar_funcs
    from bear_tpu_torch.ops import attention_forward

    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, size=(4096, 60)).astype(np.int8)
    tc = engine.TransitionCounter(lags=[9], device=cuda)
    for c in chip_smoke.read_chunks(reads, np.zeros(4096, np.int32), rows=1024):
        tc.add_chunk(c)
    _, params = chip_smoke.attention_case(cuda, torch.float32, lag=9)
    servers = {}
    for dtype in (torch.float32, torch.float64):  # the same weights in both types
        ar, _ = chip_smoke.attention_case(cuda, dtype, lag=9)
        ar.load_params([p.to(dtype) for p in params])
        ar.requires_grad_(False)
        servers[dtype] = BearServer(tc.table(9)[0], 9, h=0.05, dtype=dtype,
                                    ar_apply=lambda oh, ar=ar: ar(oh) + 1e-7)
    server = servers[torch.float32]
    seqs = chip_smoke.decode_reads(reads)
    monkeypatch.setattr(serving, "AR_SLICE_ROWS", 1 << 16)
    slices = -(-len(seqs) * 61 // (1 << 16))
    before = attention_forward.launches
    got = server.score(seqs, mode="sample", key=kr.key(3), mc_samples=41, reduce="mean_std")
    assert attention_forward.launches == before + slices == before + 4
    assert got.shape == (len(seqs), 2) and np.isfinite(got).all()
    truth = servers[torch.float64].score(seqs, mode="map")
    kernel = server.score(seqs, mode="map")
    monkeypatch.setattr(ar_funcs.AttentionAR, "_takes_attention_kernel", lambda *a: False)
    launches = attention_forward.launches
    plain = server.score(seqs, mode="map")
    assert attention_forward.launches == launches
    gap = {k: float(np.max(np.abs(np.asarray(v, np.float64) - truth) / np.abs(truth)))
           for k, v in (("kernel", kernel), ("plain", plain))}
    assert gap["kernel"] <= 2 * gap["plain"] + 1e-7, gap
