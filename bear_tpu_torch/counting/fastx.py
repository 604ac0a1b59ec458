"""Streaming FASTA/FASTQ parsing and base encoding on the host (port of
bear_tpu/counting/fastx.py).

Reads stream directly into int8 residue codes with no intermediate files:
DNA through the native parser (``csrc/fastx.cpp``, :mod:`.native`), other
alphabets and gzip files the library cannot inflate through the Python
readers and a NumPy lookup table, which give the same codes.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterable, Iterator, Tuple

import numpy as np

from bear_tpu_torch.ops import alphabets as _alpha

_ENCODE_TABLES: dict = {}


def _encode_table(alphabet: str, ambig: bool = False) -> np.ndarray:
    """Residue -> code lookup for any supported alphabet (either case).
    Unknown letters map to residue 0 by default, mirroring the reference's
    N handling (summarize.py:69-70); with ambig=True they map to the
    alphabet-size code so split_ambiguous can drop the windows crossing
    them."""
    tab = _ENCODE_TABLES.get((alphabet, ambig))
    if tab is None:
        res = _alpha.residues(alphabet)
        tab = np.full(256, len(res) if ambig else 0, dtype=np.int8)
        for j, c in enumerate(res):
            tab[ord(c)] = j
            tab[ord(c.lower())] = j
        _ENCODE_TABLES[(alphabet, ambig)] = tab
    return tab


def encode_seq(seq: str, alphabet: str = "dna", ambig: bool = False) -> np.ndarray:
    """ASCII sequence -> int8 residue codes. ambig=True marks unknown
    letters with the alphabet-size code instead of folding them to 0."""
    buf = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _encode_table(alphabet, ambig)[buf]


def is_gzip(path: str) -> bool:
    """True for gzip inputs, detected by magic bytes (suffix-independent)."""
    try:
        with open(path, "rb") as fh:
            return fh.read(2) == b"\x1f\x8b"
    except OSError:
        return False


def _open_text(path: str):
    """Open a possibly-gzipped text file for reading."""
    if is_gzip(path):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    name, parts = None, []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")  # CRLF-safe: '\r' would encode as 'A'
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split(" ")[0], []
            else:
                parts.append(line)
        if name is not None:
            yield name, "".join(parts)


def iter_fastq(path: str) -> Iterator[Tuple[str, str]]:
    with _open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            if not header.strip():  # tolerate blank lines between records
                continue
            seq = fh.readline().rstrip("\r\n")
            fh.readline()  # '+'
            fh.readline()  # quality
            yield header[1:].rstrip("\r\n").split(" ")[0], seq


def iter_seqs(path: str, file_type: str) -> Iterator[Tuple[str, str]]:
    if file_type == "fa":
        return iter_fasta(path)
    if file_type == "fq":
        return iter_fastq(path)
    raise ValueError(f"unknown file type {file_type!r} (expected 'fa' or 'fq')")


def read_input_csv(path: str) -> list[tuple[str, int, str]]:
    """Parse the reference's input CSV: rows FILE,GROUP,TYPE
    (summarize.py:12-18). Relative paths resolve against the CSV's
    directory."""
    entries = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            f, group, ftype = [part.strip() for part in line.split(",")]
            if ftype not in ("fa", "fq"):
                raise ValueError(
                    f"unknown file type {ftype!r} for {f!r} (expected 'fa' or 'fq')"
                )
            if not os.path.isabs(f):
                f = os.path.join(base, f)
            g = int(group)
            if g < 0:
                raise ValueError(
                    f"negative group id {g} for {f!r}: group ids must be >= 0"
                )
            entries.append((f, g, ftype))
    return entries


def _native():
    """The native host library (built at first use; raises if it cannot
    build)."""
    from bear_tpu_torch.counting import native

    return native.load()


def native_reads(path: str, alphabet: str = "dna", native: bool = True) -> bool:
    """Whether the native parser takes this file: DNA only (it encodes
    ACGT), and gzip only when the library links zlib."""
    return bool(native) and alphabet == "dna" and (
        not is_gzip(path) or _native().supports_gzip)


def stream_encoded(
    entries: Iterable[tuple[str, int, str]], alphabet: str = "dna",
    ambig: bool = False, native: bool = True,
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream (code_array, group) over all input files: through the native
    parser where :func:`native_reads` allows it, else through the Python
    readers and the NumPy encoder (the same codes). ``native=False`` takes
    the Python route for every file."""
    for path, group, ftype in entries:
        if native_reads(path, alphabet, native):
            yield from _native().stream_encoded(path, ftype, group, ambig=ambig)
        else:
            for _, seq in iter_seqs(path, ftype):
                yield encode_seq(seq, alphabet, ambig=ambig), group
