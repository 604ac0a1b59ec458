"""Host-side loaders for k-mer transition-count datasets (port of the NumPy
paths of bear_tpu/data/loaders.py).

Dense (the output of summarize): rows ``kmer\\t[[c00,...],[c10,...],...]``
with one inner list per dataset group, counts ordered A,C,G,T,$.

Sparse: ``kmer; [[ds,letter],...]; [vals...]`` with a header row.

``load_dense`` parses with the C++ one-pass parser of the native host
library (``csrc/fastx.cpp``; it also reads .tsv.gz where the library links
zlib), or with ``native=False`` the vectorised NumPy path (fixed-offset row
split + one ``fromstring`` pass); irregular rows take a per-line parse.
``load_files_cached`` keeps each parsed shard as an ``.npz`` so a streamed
run's later epochs skip the parse.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import warnings
import zipfile
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
               header: bool = False, native: bool = True) -> CountDataset:
    """Load a dense count TSV: with the native one-pass parser (``native``,
    the default; raises if the library cannot build) or the vectorised
    NumPy parse, and a tolerant per-line parse that '['-pads ragged
    contexts when rows are irregular. All three give the same dataset."""
    A1 = alphabets.alphabet_size(alphabet) + 1
    if native:
        from bear_tpu_torch.counting.native import load as load_native

        parsed = load_native().parse_tsv(file, header, num_ds, A1)
        if parsed is not None:
            kmers_b, counts64 = parsed
            return CountDataset(kmers=np.char.decode(kmers_b, "ascii"),
                                codes=alphabets.encode_kmers(kmers_b, alphabet),
                                counts=counts64.astype(dtype, copy=False),
                                alphabet=alphabet)
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


def load_dense_counts(file: str, alphabet: str, num_ds: int, dtype=np.float64,
                      header: bool = False) -> np.ndarray:
    """The counts [n, num_ds, A+1] of a dense count TSV alone: the native
    parser's, without the k-mer strings and codes that :func:`load_dense`
    also builds (files the native parser does not take go through
    ``load_dense``'s NumPy parse)."""
    from bear_tpu_torch.counting.native import load as load_native

    parsed = load_native().parse_tsv(file, header, num_ds,
                                     alphabets.alphabet_size(alphabet) + 1)
    if parsed is not None:
        return parsed[1].astype(dtype, copy=False)
    return load_dense(file, alphabet, num_ds, dtype, header, native=False).counts


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


def load_files_cached(files: Sequence[str], alphabet: str, num_ds: int,
                      sparse: bool = False, dtype=np.float64,
                      cache_dir: str | None = None) -> CountDataset:
    """``load_files`` with an on-disk cache of parsed shards (bear_tpu's
    ``load_files_cached``: the same key and ``.npz`` contents).

    A streamed run reads every shard every epoch; the first read parses and
    writes ``{cache_dir}/{basename}.{key}.npz`` (kmers, codes, counts),
    later ones load it. The key hashes the source's path, size and mtime
    and the parse parameters, so a changed shard is parsed again, as is an
    entry that fails to load. Writes go to a per-process temporary file and
    are renamed into place. ``cache_dir=None`` is plain ``load_files``."""
    if cache_dir is None:
        return load_files(files, alphabet, num_ds, sparse=sparse, dtype=dtype)
    if not files:
        raise ValueError("no count files to load")
    os.makedirs(cache_dir, exist_ok=True)
    loader = load_sparse if sparse else load_dense
    parts = []
    for f in files:
        st = os.stat(f)
        tag = hashlib.sha1(
            f"{os.path.abspath(f)}|{st.st_size}|{st.st_mtime_ns}|{alphabet}|"
            f"{num_ds}|{np.dtype(dtype).name}|{sparse}".encode()).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"{os.path.basename(f)}.{tag}.npz")
        if os.path.exists(cpath):
            try:
                with np.load(cpath, allow_pickle=False) as z:
                    parts.append(CountDataset(kmers=z["kmers"], codes=z["codes"],
                                              counts=z["counts"], alphabet=alphabet))
                continue
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # a truncated or corrupt entry: parse again
        ds = loader(f, alphabet, num_ds, dtype=dtype)
        tmp = f"{cpath}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, kmers=ds.kmers, codes=ds.codes, counts=ds.counts)
            os.replace(tmp, cpath)
        except OSError:
            pass  # the cache is best-effort: the parsed data is in hand
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
        parts.append(ds)
    out = parts[0]
    for part in parts[1:]:
        out = out.concat(part)
    return out


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
