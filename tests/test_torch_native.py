"""The port's native host library (csrc/fastx.cpp through
bear_tpu_torch.counting.native) against bear_tpu's build of the same C ABI
and against the NumPy paths, exactly; the native TSV route of load_dense
and load_files_cached against bear_tpu's; and the host build itself."""

import ctypes
import gzip
import os

import numpy as np
import pytest
import torch

from bear_tpu.counting import _native_build as jnative_build
from bear_tpu.data import loaders as jloaders
from bear_tpu_torch import _build
from bear_tpu_torch.counting import engine, fastx, native
from bear_tpu_torch.data import loaders
from bear_tpu_torch.utils.config import bundled_ysd1_path

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    # bear_tpu builds its library in place at first use; a private build
    # cannot race another test process's first build of the same file.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BEAR_TPU_CACHE", str(tmp_path_factory.mktemp("bear_tpu_native")))
        so = jnative_build.build()
    assert so is not None
    return native.load(), jnative_build.NativeFastx(ctypes.CDLL(so))


def _reads(rng, n=60):
    seqs = ["".join(rng.choice(list("ACGTNacgtn"), size=int(rng.integers(0, 90))))
            for _ in range(n)]
    seqs[2] = ""
    return seqs


def _write_reads(tmp, kind, seqs, gz=False, crlf=False):
    nl = "\r\n" if crlf else "\n"
    if kind == "fq":
        text = "".join(f"@r{i} d{nl}{s}{nl}+{nl}{'I' * len(s)}{nl}" for i, s in enumerate(seqs))
    else:
        text = "".join(f">r{i} d{nl}" + "".join(s[j:j + 25] + nl for j in range(0, len(s), 25))
                       for i, s in enumerate(seqs))
    path = tmp / f"reads_{kind}{'_crlf' if crlf else ''}.{kind}{'.gz' if gz else ''}"
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as fh:
        fh.write(text.encode())
    return str(path)


@pytest.mark.parametrize("kind", ["fa", "fq"])
@pytest.mark.parametrize("variant", ["plain", "gzip", "crlf"])
@pytest.mark.parametrize("ambig", [False, True])
def test_parse_equals_bear_tpu_and_numpy(libs, tmp_path, kind, variant, ambig):
    lib, jlib = libs
    seqs = _reads(np.random.default_rng(len(kind) + len(variant)))
    path = _write_reads(tmp_path, kind, seqs, gz=variant == "gzip", crlf=variant == "crlf")
    codes, offsets = lib.parse(path, kind, ambig=ambig)
    jcodes, joffsets = jlib.parse(path, kind, ambig=ambig)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(offsets, joffsets)
    want = [fastx.encode_seq(s, ambig=ambig) for _, s in fastx.iter_seqs(path, kind)]
    assert len(offsets) == len(want) + 1 == len(seqs) + 1
    for i, w in enumerate(want):
        np.testing.assert_array_equal(codes[offsets[i]:offsets[i + 1]], w)
    streamed = list(fastx.stream_encoded([(path, 3, kind)], ambig=ambig))
    python = list(fastx.stream_encoded([(path, 3, kind)], ambig=ambig, native=False))
    assert [g for _, g in streamed] == [3] * len(seqs)
    for (a, _), (b, _) in zip(streamed, python):
        np.testing.assert_array_equal(a, b)


def test_parse_errors(libs, tmp_path):
    lib, _ = libs
    with pytest.raises(FileNotFoundError):
        lib.parse(str(tmp_path / "missing.fq"), "fq")
    path = _write_reads(tmp_path, "fq", _reads(np.random.default_rng(1), 400), gz=True)
    data = open(path, "rb").read()
    cut = tmp_path / "cut.fq.gz"
    cut.write_bytes(data[: len(data) // 2])
    if lib.supports_gzip:
        with pytest.raises(OSError, match="truncated or corrupt"):
            lib.parse(str(cut), "fq")
    with pytest.raises(EOFError):  # the Python route refuses it too
        list(fastx.stream_encoded([(str(cut), 0, "fq")], native=False))
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    codes, offsets = lib.parse(str(empty), "fa")
    assert codes.size == 0 and offsets.tolist() == [0]


def test_routes_follow_alphabet_and_gzip(libs, tmp_path):
    lib, _ = libs
    plain = _write_reads(tmp_path, "fa", ["ACGT"])
    gz = _write_reads(tmp_path, "fq", ["ACGT"], gz=True)
    assert fastx.native_reads(plain) and not fastx.native_reads(plain, "prot")
    assert not fastx.native_reads(plain, native=False)
    assert fastx.native_reads(gz) == lib.supports_gzip


@pytest.mark.parametrize("rc", [False, True])
def test_fill_chunks_equals_bear_tpu(libs, rc):
    lib, jlib = libs
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=5000).astype(np.int8)
    lens = rng.integers(0, 120, size=40).astype(np.int32)
    starts = rng.integers(120, 4800, size=40).astype(np.int64)
    flags = np.full(40, rc, np.uint8)
    got = np.zeros((48, 128), np.int8)
    want = np.zeros((48, 128), np.int8)
    lib.fill_chunks(codes, starts, lens, flags, got)
    jlib.fill_chunks(codes, starts, lens, flags, want)
    np.testing.assert_array_equal(got, want)
    assert got[40:].sum() == 0
    with pytest.raises(ValueError, match="outside the code buffer"):
        lib.fill_chunks(codes, np.array([4990]), np.array([20]), np.array([0]), got)
    with pytest.raises(ValueError, match="chunk width"):
        lib.fill_chunks(codes, np.array([0]), np.array([200]), np.array([0]), got)


def _count_tsv(tmp, name, rows, header=False, gz=False, crlf=False, ragged=False):
    rng = np.random.default_rng(len(name))
    kmers = engine.rows_to_contexts(rng.choice(1364, size=rows, replace=False), 5)
    counts = rng.integers(0, 10**6, size=(rows, 2, 5))
    if ragged:
        kmers = np.array([k.lstrip("[") or "A" for k in kmers])
    lines = [f"{k}\t[[{','.join(map(str, c[0]))}],[{','.join(map(str, c[1]))}]]"
             for k, c in zip(kmers, counts)]
    nl = "\r\n" if crlf else "\n"
    text = ("kmer\tcounts" + nl if header else "") + nl.join(lines) + nl
    path = tmp / name
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as fh:
        fh.write(text.encode())
    return str(path)


@pytest.mark.parametrize("case", ["plain", "header", "crlf", "gzip", "ragged", "empty"])
def test_parse_tsv_and_load_dense_equal_bear_tpu(libs, tmp_path, case):
    lib, jlib = libs
    path = _count_tsv(tmp_path, f"{case}.tsv" + (".gz" if case == "gzip" else ""),
                      0 if case == "empty" else 300, header=case == "header",
                      gz=case == "gzip", crlf=case == "crlf", ragged=case == "ragged")
    header = case == "header"
    got, want = lib.parse_tsv(path, header, 2, 5), jlib.parse_tsv(path, header, 2, 5)
    if case == "ragged" or (case == "gzip" and not lib.supports_gzip):
        assert got is None and (case != "ragged" or want is None)
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if case == "gzip":
        return  # the NumPy loader reads plain text only, as bear_tpu's
    jds = jloaders.load_dense(path, "dna", 2, header=header, native=False)
    for nat in (True, False):
        ds = loaders.load_dense(path, "dna", 2, header=header, native=nat)
        np.testing.assert_array_equal(ds.kmers, jds.kmers)
        np.testing.assert_array_equal(ds.codes, jds.codes)
        np.testing.assert_array_equal(ds.counts, jds.counts)
        assert ds.counts.dtype == np.float64


def test_load_dense_native_on_the_ysd1_fixture():
    a = loaders.load_dense(bundled_ysd1_path(), "dna", 3)
    b = loaders.load_dense(bundled_ysd1_path(), "dna", 3, native=False)
    c = jloaders.load_dense(bundled_ysd1_path(), "dna", 3, dtype=np.float32)
    np.testing.assert_array_equal(a.kmers, b.kmers)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(
        loaders.load_dense(bundled_ysd1_path(), "dna", 3, dtype=np.float32).counts,
        c.counts)


@pytest.mark.parametrize("rows", [0, 1, 257])
def test_format_tsv_equals_bear_tpu(libs, rows):
    lib, jlib = libs
    rng = np.random.default_rng(rows)
    kmers = engine.rows_to_contexts(rng.integers(0, 5461, size=rows), 6).astype("S6")
    counts = rng.integers(0, 2**40, size=(rows, 3, 5))
    counts[: rows // 3] = 0
    assert lib.format_tsv(kmers, counts) == jlib.format_tsv(kmers, counts)
    if rows:
        with pytest.raises(ValueError, match="nonnegative"):
            lib.format_tsv(kmers, -counts - 1)


def test_load_files_cached_hits_misses_and_reparses(tmp_path):
    files = [_count_tsv(tmp_path, f"s{i}.tsv", 50 + 10 * i) for i in range(3)]
    cache, jcache = tmp_path / "cache", tmp_path / "jcache"
    want = jloaders.load_files_cached(files, "dna", 2, cache_dir=str(jcache))
    first = loaders.load_files_cached(files, "dna", 2, cache_dir=str(cache))
    names = sorted(os.listdir(cache))
    assert names == sorted(os.listdir(jcache)) and len(names) == 3  # the same keys
    for ds in (first, loaders.load_files_cached(files, "dna", 2, cache_dir=str(cache))):
        np.testing.assert_array_equal(ds.kmers, want.kmers)
        np.testing.assert_array_equal(ds.codes, want.codes)
        np.testing.assert_array_equal(ds.counts, want.counts)
    # Either package reads the other's entries.
    cross = jloaders.load_files_cached(files, "dna", 2, cache_dir=str(cache))
    np.testing.assert_array_equal(cross.counts, want.counts)

    # Touching a source (new mtime) misses and reparses into a new entry.
    _count_tsv(tmp_path, "s1.tsv", 80)
    st = os.stat(files[1])
    os.utime(files[1], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    touched = loaders.load_files_cached(files, "dna", 2, cache_dir=str(cache))
    assert len(os.listdir(cache)) == 4 and touched.num_kmers == 50 + 80 + 70

    # A corrupt entry is parsed again and rewritten.
    entry = next(cache / n for n in os.listdir(cache) if n.startswith("s2.tsv"))
    entry.write_bytes(entry.read_bytes()[:40])
    again = loaders.load_files_cached(files, "dna", 2, cache_dir=str(cache))
    np.testing.assert_array_equal(again.counts, touched.counts)
    with np.load(entry) as z:
        assert z["counts"].shape == (70, 2, 5)
    assert not [n for n in os.listdir(cache) if n.endswith(".tmp")]
    assert loaders.load_files_cached(files, "dna", 2).num_kmers == touched.num_kmers


def test_host_build_digest_and_failure(tmp_path, monkeypatch):
    so = _build.host_library_path("fastx")
    assert so.parent == _build.BUILD_DIR and so.name.startswith("libfastx-")
    assert native.load() is native.load()
    assert so.exists()
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.build_host("broken")
    assert not list((tmp_path / "build").glob("*.tmp"))
