"""ctypes wrapper of the native host library ``csrc/fastx.cpp`` (port of
bear_tpu/counting/_native_build.py's ``NativeFastx``).

The library parses FASTA/FASTQ files into int8 base codes, fills padded
read chunks, and parses and formats dense count TSVs. It is built with g++
at first use (``_build.build_host``); a failed build raises with the
compiler's output. Gzip input is read natively only when the library links
zlib (``supports_gzip``); the callers route other gzip files through
Python's ``gzip``, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from bear_tpu_torch import _build

SOURCE = "fastx"
_ERR_OPEN, _ERR_READ = 1, 2  # bear_fastx_last_error codes (3: TSV format)


class NativeFastx:
    """Typed entry points of one loaded library."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
        lib.bear_fastx_parse2.restype = c_p
        lib.bear_fastx_parse2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.bear_fastx_num_seqs.restype = c_i64
        lib.bear_fastx_num_seqs.argtypes = [c_p]
        lib.bear_fastx_total_bases.restype = c_i64
        lib.bear_fastx_total_bases.argtypes = [c_p]
        lib.bear_fastx_codes.restype = ctypes.POINTER(ctypes.c_int8)
        lib.bear_fastx_codes.argtypes = [c_p]
        lib.bear_fastx_offsets.restype = ctypes.POINTER(c_i64)
        lib.bear_fastx_offsets.argtypes = [c_p]
        lib.bear_fastx_free.restype = None
        lib.bear_fastx_free.argtypes = [c_p]
        lib.bear_fastx_last_error.restype = ctypes.c_int
        lib.bear_fastx_last_error.argtypes = []
        lib.bear_fastx_supports_gzip.restype = ctypes.c_int
        lib.bear_fastx_supports_gzip.argtypes = []
        lib.bear_format_tsv.restype = c_i64
        lib.bear_format_tsv.argtypes = [
            ctypes.c_char_p,             # kmers (fixed-width bytes)
            c_i64,                       # kmer_len
            ctypes.POINTER(c_i64),       # counts [n, G, C]
            c_i64, c_i64, c_i64,         # n_rows, n_groups, n_cols
            ctypes.c_char_p,             # out buffer
        ]
        lib.bear_tsv_parse.restype = c_p
        lib.bear_tsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, c_i64, c_i64]
        lib.bear_tsv_num_rows.restype = c_i64
        lib.bear_tsv_num_rows.argtypes = [c_p]
        lib.bear_tsv_kmer_len.restype = c_i64
        lib.bear_tsv_kmer_len.argtypes = [c_p]
        lib.bear_tsv_kmers.restype = ctypes.POINTER(ctypes.c_char)
        lib.bear_tsv_kmers.argtypes = [c_p]
        lib.bear_tsv_counts.restype = ctypes.POINTER(ctypes.c_double)
        lib.bear_tsv_counts.argtypes = [c_p]
        lib.bear_tsv_free.restype = None
        lib.bear_tsv_free.argtypes = [c_p]
        lib.bear_fill_chunks.restype = None
        lib.bear_fill_chunks.argtypes = [
            ctypes.POINTER(ctypes.c_int8),   # codes
            ctypes.POINTER(c_i64),           # starts
            ctypes.POINTER(ctypes.c_int32),  # lens
            ctypes.POINTER(ctypes.c_uint8),  # rc flags
            c_i64,                           # n_rows
            c_i64,                           # row_stride (L)
            ctypes.POINTER(ctypes.c_int8),   # out [B, L] zeroed
        ]
        self.supports_gzip = bool(lib.bear_fastx_supports_gzip())

    def parse(self, path: str, file_type: str, ambig: bool = False):
        """Parse a whole file -> (codes int8 [total], offsets int64 [n+1]).
        ambig=True encodes unknown bases as 4 (the ambiguity marker)
        instead of 0 (A)."""
        handle = self.lib.bear_fastx_parse2(path.encode(), 1 if file_type == "fq" else 0,
                                            1 if ambig else 0)
        if not handle:
            if self.lib.bear_fastx_last_error() == _ERR_READ:
                raise OSError(f"read/decode error in {path!r} (truncated or corrupt "
                              "input, e.g. an incomplete .gz)")
            raise FileNotFoundError(path)
        try:
            n = self.lib.bear_fastx_num_seqs(handle)
            total = self.lib.bear_fastx_total_bases(handle)
            if total == 0:  # empty or header-only file: the data pointer may be NULL
                codes = np.zeros(0, dtype=np.int8)
            else:
                codes = np.ctypeslib.as_array(self.lib.bear_fastx_codes(handle),
                                              shape=(total,)).copy()
            offsets = np.ctypeslib.as_array(self.lib.bear_fastx_offsets(handle),
                                            shape=(n + 1,)).copy()
        finally:
            self.lib.bear_fastx_free(handle)
        return codes, offsets

    def fill_chunks(self, codes: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                    rc: np.ndarray, out: np.ndarray) -> None:
        """out[b, :lens[b]] = codes[starts[b] ...] (rc rows walk backward
        emitting complements). ``out`` must be a zeroed C-contiguous int8
        [B, L]; only its first len(starts) rows are filled."""
        codes = np.ascontiguousarray(codes, np.int8)
        starts = np.ascontiguousarray(starts, np.int64)
        lens = np.ascontiguousarray(lens, np.int32)
        rc = np.ascontiguousarray(rc, np.uint8)
        if out.dtype != np.int8 or not out.flags.c_contiguous or out.ndim != 2:
            raise ValueError("fill_chunks needs a C-contiguous int8 [B, L] output")
        n = len(starts)
        if not (len(lens) == len(rc) == n <= out.shape[0]):
            raise ValueError("fill_chunks: starts, lens and rc must have one entry per row")
        if n and (lens.max() > out.shape[1] or lens.min() < 0):
            raise ValueError("fill_chunks: a row length exceeds the chunk width")
        if n:
            fwd = rc == 0
            lo = np.where(fwd, starts, starts - lens + 1)
            hi = np.where(fwd, starts + lens, starts + 1)
            live = lens > 0
            if live.any() and (lo[live].min() < 0 or hi[live].max() > len(codes)):
                raise ValueError("fill_chunks: a row reads outside the code buffer")
        i8 = ctypes.POINTER(ctypes.c_int8)
        self.lib.bear_fill_chunks(
            codes.ctypes.data_as(i8), starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, out.shape[1],
            out.ctypes.data_as(i8))

    def parse_tsv(self, path: str, header: bool, n_groups: int, n_cols: int):
        """Parse a dense count TSV. Returns (kmers 'S{lag}' [n], counts
        float64 [n, n_groups, n_cols]), or None when the file does not fit
        the regular dense format (the caller's tolerant parser takes it)."""
        handle = self.lib.bear_tsv_parse(path.encode(), 1 if header else 0, n_groups, n_cols)
        if not handle:
            if self.lib.bear_fastx_last_error() == _ERR_OPEN:
                raise FileNotFoundError(path)
            return None  # read error or irregular format
        try:
            n = self.lib.bear_tsv_num_rows(handle)
            lag = self.lib.bear_tsv_kmer_len(handle)
            if n == 0:
                return (np.zeros(0, dtype="S1"),
                        np.zeros((0, n_groups, n_cols), np.float64))
            if lag == 0:  # zero-width contexts: the tolerant parser's case
                return None
            kmers = np.ctypeslib.as_array(
                ctypes.cast(self.lib.bear_tsv_kmers(handle), ctypes.POINTER(ctypes.c_uint8)),
                shape=(n * lag,)).copy().view(f"S{lag}")
            counts = np.ctypeslib.as_array(self.lib.bear_tsv_counts(handle),
                                           shape=(n, n_groups, n_cols)).copy()
        finally:
            self.lib.bear_tsv_free(handle)
        return kmers, counts

    def format_tsv(self, kmers_bytes: np.ndarray, counts: np.ndarray) -> bytes:
        """Count-TSV lines ``kmer\\t[[...],[...]]\\n`` for an [n] 'S{lag}'
        array of contexts and an [n, G, C] array of nonnegative counts."""
        n = len(kmers_bytes)
        if n == 0:
            return b""
        kmers_bytes = np.ascontiguousarray(kmers_bytes)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        if counts.ndim != 3 or counts.shape[0] != n:
            raise ValueError(f"format_tsv: counts {counts.shape} do not match {n} contexts")
        if counts.min() < 0:
            raise ValueError("format_tsv formats nonnegative counts only")
        kmer_len = kmers_bytes.dtype.itemsize
        _, G, C = counts.shape
        out = np.empty(n * (kmer_len + 3 + G * (C * 21 + 3)), dtype=np.uint8)
        written = self.lib.bear_format_tsv(
            kmers_bytes.ctypes.data_as(ctypes.c_char_p), kmer_len,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, G, C,
            out.ctypes.data_as(ctypes.c_char_p))
        return out[:written].tobytes()

    def stream_encoded(self, path: str, file_type: str, group: int, ambig: bool = False):
        """(code_array, group) of each read of one file."""
        codes, offsets = self.parse(path, file_type, ambig=ambig)
        for i in range(len(offsets) - 1):
            yield codes[offsets[i] : offsets[i + 1]], group


_lock = threading.Lock()


@functools.cache
def _load() -> NativeFastx:
    return NativeFastx(ctypes.CDLL(str(_build.build_host(SOURCE))))


def load() -> NativeFastx:
    """The native library, built at first use; raises if it cannot build."""
    with _lock:  # one build per process, even from the parse prefetch thread
        return _load()
