"""The plain reference against the port at small sizes on the CPU: the
counts and the training handoff, one training apply, and the keyed draws
and sampled scores from the same keys."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_gpu import genome, harness, tiny_cells, weights
from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler


@pytest.fixture(scope="module")
def reads():
    return genome.genome_traffic(2**31 + 7, tiny_cells.config("genome13_count"))


def _counter(reads, lag):
    from bear_tpu_torch.counting import ReadChunk, TransitionCounter

    counter = TransitionCounter(lags=[lag], n_groups=2, device="cpu")
    for arrays in genome.chunk_arrays(*reads, 64):
        counter.add_chunk(ReadChunk(*arrays))
    return counter


@pytest.mark.parametrize("lag", [1, 4, 6])
def test_counts_and_handoff_equal_the_counter(reads, lag):
    from bench_gpu.traffic.count import mismatches

    counter = _counter(reads, lag)
    keys, n = ref_counts.count_keys(torch.as_tensor(reads[0]), torch.as_tensor(reads[1]), lag, 2)
    assert mismatches(counter.table(lag).reshape(-1), keys, n) == 0
    assert int(n.sum()) == reads[0].shape[0] * (reads[0].shape[1] + 1)
    codes, table = ref_counts.handoff(keys, n, lag, 2)
    got_codes, got_counts = counter.to_device_dataset(lag, dtype=torch.float64)
    assert torch.equal(got_codes.to(torch.int64), codes)
    assert torch.equal(got_counts.to(torch.int64), table)


def test_decode_inverts_the_row_math():
    lag = 5
    rows = torch.randint(0, ref_counts.n_rows(lag), (2000,))
    codes = ref_counts.decode(rows, lag)
    m = (codes != 4).sum(dim=1)
    assert torch.all((codes != 4) == (torch.arange(lag) >= lag - m[:, None]))  # '[' lead
    value = torch.zeros_like(rows)
    for p in range(lag):
        value = torch.where(codes[:, p] != 4, value * 4 + codes[:, p], value)
    offsets = torch.tensor([ref_counts.row_offset(k) for k in range(lag + 1)])
    assert torch.equal(offsets[m] + value, rows)


def test_count_file_parse_equals_the_loader():
    from bear_tpu_torch.data.loaders import load_dense

    cfg = tiny_cells.config("ysd1_train")
    path = f"{harness.BENCH}/{cfg['count_file']}"
    codes, counts = ref_counts.parse_count_tsv(path, cfg["num_ds"])
    ds = load_dense(path, "dna", cfg["num_ds"], native=False)
    assert np.array_equal(codes.numpy(), ds.codes.astype(np.int64))
    assert np.array_equal(counts.numpy(), ds.counts.astype(np.int64))


@pytest.mark.parametrize("cell", ["genome13_train", "ysd1_train"])
def test_one_training_apply_equals_the_port_in_float64(reads, cell):
    from bear_tpu_torch.models import bear_net, get_ar_func

    cfg = tiny_cells.config(cell)
    m = cfg["model"]
    if "genome" in cfg:
        keys, n = ref_counts.count_keys(torch.as_tensor(reads[0]), torch.as_tensor(reads[1]),
                                        cfg["lag"], 2)
        codes, table = ref_counts.handoff(keys, n, cfg["lag"], 2)
    else:
        codes, table = ref_counts.parse_count_tsv(f"{harness.BENCH}/{cfg['count_file']}", 3)
    counts = table[:, 0].to(torch.float64)
    B = min(m["batch_size"], codes.shape[0])
    params0 = [p.double() for p in weights.make_params(cfg, 99, "cpu")]
    kwargs = {k: m[k] for k in ("filter_width", "num_filters", "kmer_layer1_width") if k in m}
    ar = get_ar_func(m["ar_func"], cfg["lag"], 4, kwargs, dtype=torch.float64, device="cpu")
    res = bear_net.train(codes[:B], counts[:B], num_kmers=codes.shape[0], ar_func=ar,
                         batch_size=B, epochs=1, learning_rate=m["learning_rate"],
                         params_restart=params0, dtype=torch.float64, device="cpu")
    losses, grad, (params,) = ref_model.train_steps(
        params0, m["ar_func"], [(codes[:B], counts[:B])], codes.shape[0], m["learning_rate"],
        torch.float64)
    assert np.allclose(res.losses[0], losses[0], rtol=1e-12)
    for g, a in zip(grad, res.opt_state["exp_avg"]):
        assert np.allclose(g.numpy() * 0.1, a, rtol=1e-9, atol=1e-14)
    for p, q in zip(params, res.params_list):
        assert np.allclose(p.numpy(), q, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_draws_equal_the_port_bit_for_bit(dtype):
    from bear_tpu_torch.ops import keyed_random as kr
    from bear_tpu_torch.ops.keyed_draw import keyed_draw_plain

    key = ref_sampler.as_key(2**40 + 12345)
    base = kr.fold_in(kr.key(key), torch.arange(6))[:, None]
    base = kr.fold_in(base, torch.arange(4)[None, :])  # [S, G]
    gen = torch.Generator().manual_seed(3)
    E = 300
    group = torch.randint(0, 4, (E,), generator=gen)
    rows = torch.randint(0, 10**8, (E,), generator=gen)
    conc = (torch.rand(E, 5, generator=gen, dtype=torch.float64) * 400).to(dtype)
    conc[:20] *= 1e-6  # tiny concentrations: the boost carries the draw
    conc[0, 3] = 0.0
    nxt = torch.randint(0, 5, (E,), generator=gen)
    want = keyed_draw_plain(base, group, rows, conc, 3, nxt)
    keys = ref_sampler.fold_in(base[:, group], rows[None, :])
    got = ref_sampler.picked_logp(keys, conc[None].expand(6, -1, -1), nxt[None].expand(6, -1), 3)
    assert torch.equal(got, want)


def test_sampled_scores_equal_the_server():
    """The scoring driver's check on the CPU: the program's mean and
    standard deviation against the reference's, every read of a call."""
    from bench_gpu.traffic import score

    cell = "genome13_score_mc41"
    run = harness.Run(cell, tiny_cells.config(cell), tiny_cells.spec(cell)["params"], 2**33 + 5,
                      torch.device("cpu"))
    driver = score.setup(run)
    driver.step()
    got, want = driver.outputs[0], driver.reference_scores(0)
    assert np.allclose(got, want, rtol=2e-6, atol=1e-5)
    assert max(driver.check().values()) < 1e-5
