"""Count -> train handoff of the port (decode_rows, to_dataset,
to_device_dataset) against bear_tpu's, on the test_torch_slice.py genome
(lag 5, 2 groups), on the CPU; then count -> train -> evaluate through both
packages.

Tolerances: codes and counts exactly equal; the 5-apply trajectory and
the evaluation rtol 1e-8 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import engine as jengine
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu_torch.counting.engine import TransitionCounter, decode_rows
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func

torch.set_num_threads(2)
LAG = 5


@pytest.fixture(scope="module")
def chunks():
    reads, groups = chip_smoke.make_reads(genome_mb=0.03, coverage=4, read_len=60, seed=3)
    return list(chip_smoke.read_chunks(reads, groups, rows=512))


def _count(chunks, flush_after=None):
    ref = JCounter(lags=[LAG], n_groups=2, method="scatter")
    port = TransitionCounter(lags=[LAG], n_groups=2, device="cpu")
    for i, c in enumerate(chunks):
        ref.add_chunk(c)
        port.add_chunk(c)
        if i == flush_after:
            ref.flush()
            port.flush()
    return ref, port


@pytest.mark.parametrize("lag,A", [(5, 4), (3, 20), (1, 4)])
def test_decode_rows_matches(lag, A):
    rows_total = (A ** (lag + 1) - 1) // (A - 1)
    rows = np.unique(np.concatenate([
        np.arange(min(rows_total, 500)),
        np.random.default_rng(lag).integers(0, rows_total, 2000),
        [rows_total - 1]])).astype(np.int32)
    got = decode_rows(torch.from_numpy(rows), lag, A)
    want = np.asarray(jengine.decode_rows(jnp.asarray(rows), lag, A))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flush_after", [None, 3], ids=["resident", "after_flush"])
def test_handoff_equals_bear_tpu(chunks, flush_after):
    ref, port = _count(chunks, flush_after)
    got_codes, got_counts = port.to_device_dataset(LAG, dtype=torch.float64)
    want_codes, want_counts = ref.to_device_dataset(LAG, dtype=jnp.float64)
    assert got_codes.dtype == torch.int8 and got_counts.dtype == torch.float64
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    # The host route gives the same rows, codes and counts.
    got_ds, want_ds = port.to_dataset(LAG), ref.to_dataset(LAG)
    np.testing.assert_array_equal(got_ds.kmers, want_ds.kmers)
    np.testing.assert_array_equal(got_ds.codes, want_ds.codes)
    np.testing.assert_array_equal(got_ds.counts, want_ds.counts)
    np.testing.assert_array_equal(got_ds.codes, got_codes.numpy())
    np.testing.assert_array_equal(got_ds.counts, got_counts.numpy())
    # Conservation per group, as validate() counts it.
    totals = got_counts.sum(dim=(0, 2)).numpy()
    per_group = port.tables[LAG].sum(axis=(1, 2))
    np.testing.assert_array_equal(totals, per_group)
    assert totals.sum() == port.validate()[LAG]


def test_resident_handoff_reads_the_device_table(chunks):
    _, port = _count(chunks)
    assert not port._host_dirty
    codes, counts = port.to_device_dataset(LAG)
    assert not port._host_dirty and port._since_flush > 0  # nothing flushed
    port.validate()
    assert port._host_dirty
    codes2, counts2 = port.to_device_dataset(LAG)
    np.testing.assert_array_equal(codes.numpy(), codes2.numpy())
    np.testing.assert_array_equal(counts.numpy(), counts2.numpy())


@pytest.mark.parametrize("flush", [False, True], ids=["resident", "after_flush"])
def test_float32_refuses_inexact_counts(flush):
    port = TransitionCounter(lags=[2], n_groups=1, device="cpu")
    n = (1 << 24) // 998 + 1  # 1,000-base reads of one letter: 998 A -> A each
    reads = np.zeros((n, 1000), np.int8)
    for c in chip_smoke.read_chunks(reads, np.zeros(n, np.int32), rows=1 << 14):
        port.add_chunk(c)
    if flush:
        port.flush()
    with pytest.raises(ValueError, match="exact integer range"):
        port.to_device_dataset(2, dtype=torch.float32)
    codes, counts = port.to_device_dataset(2, dtype=torch.float64)
    assert counts.max() > (1 << 24)
    with pytest.raises(ValueError, match="base-4"):
        port.to_device_dataset(2, alphabet="prot")


def test_count_train_evaluate_matches_bear_tpu(chunks):
    ref, port = _count(chunks)
    codes, counts = port.to_device_dataset(LAG, dtype=torch.float64)
    jcodes, jcounts = ref.to_device_dataset(LAG, dtype=jnp.float64)
    n = codes.shape[0]
    jar = jget_ar_func("linear", LAG, 4, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(5), jar, dtype=jnp.float64))
    ar = get_ar_func("linear", LAG, 4, dtype=torch.float64, device="cpu")
    kw = dict(num_kmers=n, batch_size=-(-n // 5), epochs=1, learning_rate=0.01, params_restart=p0)
    want = jbn.train(jcodes, jcounts[:, 0], ar_func=jar, dtype=jnp.float64, **kw)
    got = bear_net.train(codes, counts[:, 0], ar_func=ar, dtype=torch.float64,
                         device="cpu", **kw)
    assert len(got.elbos) == 5
    np.testing.assert_allclose(got.elbos, want.elbos, rtol=1e-8)
    want_ev = jbn.evaluation(jcodes, jcounts, 0, 1, "dna", want.h, jar, want.params["ar"],
                             [1.0], dtype=jnp.float64)
    got_ev = bear_net.evaluation(codes, counts, 0, 1, "dna", got.h, ar, got.params["ar"],
                                 [1.0], dtype=torch.float64, device="cpu")
    for g, w in zip(got_ev[:6], want_ev[:6]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8)
