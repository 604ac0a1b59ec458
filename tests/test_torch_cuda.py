"""The port's CUDA path against its plain PyTorch path, on a card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor bear_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu_torch.counting import count_chunk, engine, fastx
from bear_tpu_torch.counting.count_chunk import count_chunk_update
from bear_tpu_torch.counting.window_hist import window_update, window_update_plain
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models.ar_funcs import LinearAR
from bear_tpu_torch.ops import keyed_random as kr

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
    total = 0
    for d in pass_ids:
        before = count_chunk_update.launches
        a, b = chip_smoke.shard_vs_plain(cuda, lags, n_groups, A, inputs, passes, d)
        assert count_chunk_update.launches == before + len(inputs)
        assert torch.equal(a, b)
        total += int(a.sum())
        del a, b
    assert total > 0


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
