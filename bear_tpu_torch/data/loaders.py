"""Host-side loaders for k-mer transition-count datasets (port of the NumPy
paths of bear_tpu/data/loaders.py).

Dense (the output of summarize): rows ``kmer\\t[[c00,...],[c10,...],...]``
with one inner list per dataset group, counts ordered A,C,G,T,$.

Sparse: ``kmer; [[ds,letter],...]; [vals...]`` with a header row.

``load_dense`` parses with the vectorised NumPy path (fixed-offset row
split + one ``fromstring`` pass) and falls back to a per-line parse for
irregular rows. bear_tpu's C++ one-pass parser and ``load_files_cached``
are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from bear_tpu_torch.ops import alphabets

# Bytes rewritten to spaces before the one-pass numeric parse: NUL padding,
# CR and the list punctuation (a 256-entry lookup, not np.isin, which sorts).
_STRIP_TO_SPACE = np.zeros(256, dtype=bool)
_STRIP_TO_SPACE[[0, 13, ord("["), ord("]"), ord(",")]] = True


@dataclass
class CountDataset:
    """An in-memory transition-count dataset.

    kmers : [num_kmers] k-mer strings (contexts; may contain '[').
    codes : [num_kmers, lag] int8 integer-coded k-mers.
    counts : [num_kmers, num_ds, alphabet_size+1] float counts, columns
        A,...,stop.
    alphabet : alphabet name.
    """

    kmers: np.ndarray
    codes: np.ndarray
    counts: np.ndarray
    alphabet: str

    @property
    def num_kmers(self) -> int:
        return len(self.kmers)

    @property
    def lag(self) -> int:
        return self.codes.shape[-1]

    @property
    def num_ds(self) -> int:
        return self.counts.shape[1]

    def concat(self, other: "CountDataset") -> "CountDataset":
        if self.alphabet != other.alphabet:
            raise ValueError(f"alphabets differ: {self.alphabet!r} and {other.alphabet!r}")
        return CountDataset(
            kmers=np.concatenate([self.kmers, other.kmers]),
            codes=np.concatenate([self.codes, other.codes]),
            counts=np.concatenate([self.counts, other.counts]),
            alphabet=self.alphabet,
        )


def load_dense(file: str, alphabet: str, num_ds: int, dtype=np.float64,
               header: bool = False) -> CountDataset:
    """Load a dense count TSV: the vectorised NumPy parse, or a tolerant
    per-line parse that '['-pads ragged contexts when rows are irregular."""
    A1 = alphabets.alphabet_size(alphabet) + 1
    with open(file, "rb") as fh:
        data = fh.read()
    lines = np.array(data.split(b"\n"))
    if header and len(lines):
        lines = lines[1:]
    lines = lines[(lines != b"") & (lines != b"\r")]  # blank incl. CRLF-blank
    if len(lines) == 0:
        return CountDataset(
            kmers=np.array([], dtype=str), codes=np.zeros((0, 0), np.int8),
            counts=np.zeros((0, num_ds, A1), dtype=dtype), alphabet=alphabet,
        )
    try:
        lag = lines[0].index(b"\t")
    except ValueError:
        lag = -1
    W = lines.dtype.itemsize
    m8 = lines.view(np.uint8).reshape(len(lines), W)
    if lag + 1 < W and (m8[:, lag] == ord("\t")).all():
        kmers_b = lines.astype(f"S{lag}")
        tail = m8[:, lag + 1 :].copy()
        tail[_STRIP_TO_SPACE[tail]] = ord(" ")
        # Per-row field count: a short row must not take fields of the next
        # one (a field starts at a non-space after a space).
        nonspace = tail != ord(" ")
        prev = np.zeros_like(nonspace)
        prev[:, 1:] = nonspace[:, :-1]
        fields_per_row = (nonspace & ~prev).sum(axis=1)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # np.fromstring deprecation
                flat = np.fromstring(tail.tobytes().decode("ascii"), dtype=dtype, sep=" ")
        except ValueError:  # text-mode fromstring removed: use the fallback
            flat = np.zeros(0, dtype=dtype)
        if flat.size == len(lines) * num_ds * A1 and (fields_per_row == num_ds * A1).all():
            kmers = np.char.decode(kmers_b, "ascii")
            return CountDataset(
                kmers=kmers, codes=alphabets.encode_kmers(kmers, alphabet),
                counts=flat.reshape(len(lines), num_ds, A1), alphabet=alphabet,
            )
    # Irregular rows (e.g. varying context length): per line, shorter
    # contexts '['-padded to the longest.
    kmers = []
    rows = []
    for raw in lines:
        kmer, mat = raw.decode("ascii").split("\t")
        kmers.append(kmer)
        rows.append(mat.replace("[", "").replace("]", "").split(","))
    maxlen = max(len(k) for k in kmers)
    kmers = np.array(["[" * (maxlen - len(k)) + k for k in kmers])
    counts = np.array(rows, dtype=dtype).reshape(len(kmers), num_ds, A1)
    return CountDataset(kmers=kmers, codes=alphabets.encode_kmers(kmers, alphabet),
                        counts=counts, alphabet=alphabet)


def load_sparse(file: str, alphabet: str, num_ds: int, dtype=np.float64,
                header: bool = True) -> CountDataset:
    """Load a sparse count file: ``kmer; [[ds,letter],...]; [vals...]``."""
    A1 = alphabets.alphabet_size(alphabet) + 1
    kmers = []
    all_pos = []
    all_val = []
    with open(file, "r") as fh:
        for i, line in enumerate(fh):
            if header and i == 0:
                continue
            line = line.strip()
            if not line:
                continue
            kmer, pos_str, val_str = [part.strip() for part in line.split(";")]
            kmers.append(kmer)
            all_pos.append(np.array(json.loads(pos_str), dtype=np.int64).reshape(-1, 2))
            all_val.append(np.array(json.loads(val_str), dtype=dtype))
    kmers = np.array(kmers)
    counts = np.zeros((len(kmers), num_ds, A1), dtype=dtype)
    for i, (pos, val) in enumerate(zip(all_pos, all_val)):
        counts[i, pos[:, 0], pos[:, 1]] += val
    return CountDataset(kmers=kmers, codes=alphabets.encode_kmers(kmers, alphabet),
                        counts=counts, alphabet=alphabet)


def load_files(files: Sequence[str], alphabet: str, num_ds: int,
               sparse: bool = False, dtype=np.float64) -> CountDataset:
    """Load and concatenate count files, in order."""
    if not files:
        raise ValueError(
            "no count files to load — check files_path/start_token "
            "(discover_files matched nothing)"
        )
    loader = load_sparse if sparse else load_dense
    parts = [loader(f, alphabet, num_ds, dtype=dtype) for f in files]
    ds = parts[0]
    for part in parts[1:]:
        ds = ds.concat(part)
    return ds


def discover_files(files_path: str, start_token: str) -> list[str]:
    """Count files in ``files_path`` whose name starts with ``start_token``,
    sorted."""
    return sorted(
        os.path.join(files_path, f)
        for f in os.listdir(files_path)
        if f.startswith(start_token)
    )


def count_kmers(files: Sequence[str], header: bool = False) -> int:
    """Total number of k-mer rows (newlines, less one header per file)."""
    total = 0
    for f in files:
        with open(f, "rb") as fh:
            n = sum(buf.count(b"\n") for buf in iter(lambda: fh.read(1 << 20), b""))
        total += n - (1 if header else 0)
    return total
