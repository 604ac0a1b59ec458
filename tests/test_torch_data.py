"""The port's data layer (bear_tpu_torch.data) against bear_tpu's, on the
CPU: loaders exactly equal (bear_tpu's NumPy paths, ``native=False``), the
fixture copies byte-identical, bmm_likelihood rtol 1e-12 in float64."""

import filecmp
import os

import numpy as np
import pytest
import torch

from bear_tpu import data as jdata
from bear_tpu.utils import config as jconfig
from bear_tpu_torch import data
from bear_tpu_torch.utils import config

torch.set_num_threads(2)
FIXTURES = ["ysd1_lag_5_file_0_preshuf.tsv", "ex_seqs_kmap_for_var_pred.csv"]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_copies_byte_identical(name):
    ours = os.path.join(os.path.dirname(config.bundled_ysd1_path()), name)
    theirs = os.path.join(os.path.dirname(jconfig.bundled_ysd1_path()), name)
    assert filecmp.cmp(ours, theirs, shallow=False)


def _equal(a, b):
    np.testing.assert_array_equal(a.kmers, b.kmers)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.codes.dtype == b.codes.dtype and a.counts.dtype == b.counts.dtype
    assert a.alphabet == b.alphabet and a.num_kmers == b.num_kmers


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_load_dense_ysd1_equal(dtype):
    path = config.bundled_ysd1_path()
    got = data.load_dense(path, "dna", 3, dtype=dtype)
    _equal(got, jdata.load_dense(path, "dna", 3, dtype=dtype, native=False))
    assert got.counts.shape == (1365, 3, 5) and got.lag == 5 and got.num_ds == 3


def test_load_sparse_fixture_equal():
    path = config.bundled_sparse_path()
    got = data.load_sparse(path, "dna", 1)
    _equal(got, jdata.load_sparse(path, "dna", 1))


def test_load_dense_per_line_fallback_equal(tmp_path):
    # Ragged contexts and a CRLF line take the per-line parse in both.
    path = tmp_path / "ragged.tsv"
    path.write_bytes(b"ACG\t[[1,2,3,4,5],[0,0,1,0,2]]\n"
                     b"CG\t[[7,0,0,1,0],[1,1,1,1,1]]\r\n"
                     b"\n"
                     b"TTA\t[[0,0,0,0,9],[2,0,0,0,0]]\n")
    got = data.load_dense(str(path), "dna", 2)
    _equal(got, jdata.load_dense(str(path), "dna", 2, native=False))
    assert got.kmers.tolist() == ["ACG", "[CG", "TTA"]


def test_load_files_discover_and_count(tmp_path):
    src = config.bundled_ysd1_path()
    for i in range(2):
        (tmp_path / f"part_{i}.tsv").write_bytes(open(src, "rb").read())
    (tmp_path / "other.tsv").write_text("x")
    files = data.discover_files(str(tmp_path), "part_")
    assert files == jdata.discover_files(str(tmp_path), "part_")
    assert data.count_kmers(files) == jdata.count_kmers(files) == 2730
    _equal(data.load_files(files, "dna", 3), jdata.load_files(files, "dna", 3))
    with pytest.raises(ValueError, match="no count files"):
        data.load_files([], "dna", 3)


@pytest.mark.parametrize("batch_size", [1 << 16, 100])
def test_bmm_likelihood(batch_size):
    ds = data.load_dense(config.bundled_ysd1_path(), "dna", 3)
    alpha = [0.1, 1.0, 10.0]
    got = data.bmm_likelihood(ds.counts, alpha, batch_size=batch_size, device="cpu")
    want = jdata.bmm_likelihood(ds.counts, alpha, batch_size=batch_size)
    assert got.shape == (3, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bmm_likelihood_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.bmm_likelihood(np.zeros((2, 1, 5)), [1.0])
