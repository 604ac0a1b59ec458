"""Alphabets and k-mer integer codecs (port of bear_tpu/ops/alphabets.py).

Conventions (matching the reference's column order exactly):

- *Input* (context) alphabet: the ``alphabet_size`` residues followed by the
  start symbol ``[`` in the LAST column (reference core.py:142-147).
- *Output* (transition) alphabet: the residues followed by the stop symbol
  ``]``/``$`` in the last column (counts are ordered ``A,C,G,T,$``).

Integer codes: residue i -> i, ``[`` -> alphabet_size (input side), ``]``
-> alphabet_size (output side). The codecs are host numpy; only
:func:`one_hot` and :func:`one_hot_kmers` build tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_RESIDUES = {
    "dna": "ACGT",
    "rna": "ACGU",
    "prot": "ARNDCEQGHILKMFPSTWYV",
}

START = "["
STOP = "]"


def residues(alphabet: str) -> str:
    return _RESIDUES[alphabet]


def alphabet_size(alphabet: str) -> int:
    """Number of residues; inputs/outputs both have ``alphabet_size + 1``
    columns."""
    return len(_RESIDUES[alphabet])


def input_letters(alphabet: str) -> np.ndarray:
    """Residues + '[' (start) — the one-hot input column order."""
    return np.array(list(_RESIDUES[alphabet]) + [START])


def output_letters(alphabet: str) -> np.ndarray:
    """Residues + ']' (stop) — the transition-count column order."""
    return np.array(list(_RESIDUES[alphabet]) + [STOP])


def _lookup_table(alphabet: str, last: str) -> np.ndarray:
    """256-entry byte -> code table; unknown bytes map to -1."""
    table = np.full(256, -1, dtype=np.int8)
    for i, ch in enumerate(_RESIDUES[alphabet]):
        table[ord(ch)] = i
    table[ord(last)] = len(_RESIDUES[alphabet])
    return table


_INPUT_TABLES = {a: _lookup_table(a, START) for a in _RESIDUES}
_OUTPUT_TABLES = {a: _lookup_table(a, STOP) for a in _RESIDUES}
# The input tables as ``bytes.translate`` tables (-1 stored as 0xFF), and
# the same with NUL -> 0 for NUL-padded joins.
_INPUT_BYTES = {a: t.tobytes() for a, t in _INPUT_TABLES.items()}
_PADDED_INPUT_BYTES = {a: b"\0" + t[1:] for a, t in _INPUT_BYTES.items()}


def encode_kmers(kmers, alphabet: str) -> np.ndarray:
    """Encode equal-length k-mer strings into int8 codes [len(kmers), lag]:
    residues 0..A-1, '[' -> A."""
    arr = np.asarray(kmers)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "ascii")
    flat = arr.ravel()
    if flat.size == 0:
        return np.zeros(arr.shape + (0,), dtype=np.int8)
    # Fixed-width byte view over the FULL itemsize; ragged inputs show up as
    # NUL padding and are rejected (left-pad short contexts with '[').
    byte_view = flat.view(np.uint8).reshape(flat.size, -1)
    lag = byte_view.shape[1]
    if np.any(byte_view == 0):
        bad = flat[np.any(byte_view == 0, axis=-1)][0]
        raise ValueError(
            f"k-mers must all have the same length; {bad!r} is shorter — "
            "left-pad short contexts with '['"
        )
    codes = _INPUT_TABLES[alphabet][byte_view]
    if np.any(codes < 0):
        bad = flat[np.any(codes < 0, axis=-1)][0]
        raise ValueError(f"k-mer {bad!r} contains letters outside alphabet {alphabet!r}")
    return codes.reshape(arr.shape + (lag,))


def translate_ascii(raw: bytes, alphabet: str, nul_pads: bool = False) -> bytes:
    """ASCII bytes -> the bytes of their int8 input codes ('[' carries the
    input-side code A), one ``bytes.translate``; with ``nul_pads`` NUL -> 0.
    A letter outside the alphabet raises ValueError naming the first."""
    codes = raw.translate((_PADDED_INPUT_BYTES if nul_pads else _INPUT_BYTES)[alphabet])
    bad = codes.find(0xFF)
    if bad >= 0:
        raise ValueError(f"letter {chr(raw[bad])!r} outside alphabet {alphabet!r}")
    return codes


def encode_string(s: str, alphabet: str) -> np.ndarray:
    """Encode ONE string (typically a join of many pieces) to a writable
    int8 code array via one byte translate."""
    return np.frombuffer(bytearray(translate_ascii(s.encode("ascii"), alphabet)), np.int8)


def encode_output_symbols(symbols, alphabet: str) -> np.ndarray:
    """Encode transition symbols (residues or ']') to 0..A codes."""
    arr = np.asarray(symbols)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "ascii")
    flat = arr.ravel()
    byte_view = flat.view(np.uint8).reshape(flat.size, -1)[:, 0]
    codes = _OUTPUT_TABLES[alphabet][byte_view]
    if np.any(codes < 0):
        raise ValueError("symbol outside alphabet")
    return codes.reshape(arr.shape)


def decode_kmers(codes: np.ndarray, alphabet: str) -> np.ndarray:
    """Inverse of :func:`encode_kmers`: int codes -> k-mer strings."""
    letters = input_letters(alphabet)
    codes = np.asarray(codes)
    joined = letters[codes.reshape(-1, codes.shape[-1])]
    out = np.array(["".join(row) for row in joined])
    return out.reshape(codes.shape[:-1])


def one_hot(codes, num_classes: int, dtype) -> torch.Tensor:
    """One-hot encode integer codes: [..., lag] -> [..., lag, num_classes],
    on the device of ``codes``."""
    codes = torch.as_tensor(codes)
    classes = torch.arange(num_classes, dtype=codes.dtype, device=codes.device)
    return (codes[..., None] == classes).to(dtype)


def one_hot_kmers(kmers, alphabet: str, dtype=torch.float32, device=None) -> torch.Tensor:
    """String k-mers -> one-hot [n, lag, alphabet_size+1] on ``device``
    (host encode, one-hot where the codes land)."""
    codes = torch.from_numpy(encode_kmers(kmers, alphabet)).to(device)
    return one_hot(codes, alphabet_size(alphabet) + 1, dtype)
