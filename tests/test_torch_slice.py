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
