"""Counter-based random numbers for stateless posterior sampling (the
port's counterpart of the ``jax.random`` calls bear_tpu's sampler makes).

bear_tpu's sampled scores are a pure function of (sample key, [sequence,]
table row): a context repeated within a sequence reuses one draw, windows
that wild type and mutant share draw the same (their Δ cancels exactly),
and results do not depend on batching. A stateful ``torch.Generator``
cannot give that; a counter-based generator can.

The generator is Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel
random numbers: as easy as 1, 2, 3", SC'11; the generator cuRAND uses),
written with int64 tensor ops holding uint32 words, so the CPU and the card
give the same bits.

- A key is a 64-bit integer: an int64 tensor (two's complement) or a Python
  int. :func:`key` makes one from a seed, :func:`fold_in` derives keys from
  a key and integer data (vectorised over both).
- A Philox block maps a 128-bit counter and the key to four 32-bit words.
  The counter carries (index low word, index high word, stream, block):
  the index is a flat element index (or 0 where the key already names the
  element), the stream one of ``FOLD``, ``NORMAL``, ``EXPONENTIAL``,
  ``BOOST``, and the block numbers the stream's words four at a time.
- Words become uniforms in (0, 1), never 0 or 1 (:func:`uniform`), then
  standard normals by Box-Muller (:func:`normal`) and exponentials as
  ``-log u`` (:func:`exponential`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
ROUNDS = 10

# Counter word 2: the stream a block belongs to, so that key derivation and
# the three kinds of draw never share a counter under one key.
FOLD, NORMAL, EXPONENTIAL, BOOST = 0, 1, 2, 3


def _int64(x: int) -> int:
    """A Python int as its 64-bit two's complement value."""
    return ((int(x) + (1 << 63)) % (1 << 64)) - (1 << 63)


def key(seed: int) -> torch.Tensor:
    """The key of an integer seed: a 0-dim int64 tensor on the CPU (it
    combines with tensors on any device)."""
    return torch.tensor(_int64(seed), dtype=torch.int64)


def _device(*xs) -> torch.device:
    """The device of the first tensor among xs that is not on the CPU (a
    0-dim CPU key combines with data on any device), else the CPU."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    return torch.device("cpu")


def _as_keys(keys, device=None) -> torch.Tensor:
    if isinstance(keys, int):
        keys = _int64(keys)
    return torch.as_tensor(keys, dtype=torch.int64, device=device)


def split_key(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (low, high) uint32 words, held in int64."""
    return keys & MASK, (keys >> 32) & MASK


def join_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(low, high) uint32 words -> int64 keys, without overflow: the high
    word is read as signed before it is scaled."""
    return lo + ((hi ^ 0x80000000) - 0x80000000) * (1 << 32)


def philox4x32(counter: Sequence, key_words: Sequence, rounds: int = ROUNDS):
    """Philox4x32 on broadcastable int64 tensors (or ints) holding uint32
    words: counter (c0, c1, c2, c3), key (k0, k1) -> four output words.

    A product of two uint32 is below 2^64, so int64 multiplication keeps
    its low 64 bits exactly (it wraps); the high word is the product
    shifted down 32 and masked, the low word the product masked. Low words
    enter the next round only through XORs, so they are masked once, at
    the end."""
    c0, c1, c2, c3 = counter
    k0, k1 = key_words
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) ^ c1 ^ k0) & MASK, p1,
                          ((p0 >> 32) ^ c3 ^ k1) & MASK, p0)
    return c0, c1 & MASK, c2, c3 & MASK


def fold_in(keys, data) -> torch.Tensor:
    """Keys derived from ``keys`` and integer ``data`` (broadcast together):
    the first two words of the Philox block with counter (data, FOLD, 0)
    under each key. The role of ``jax.random.fold_in``, vectorised."""
    dev = _device(keys, data)
    data = torch.as_tensor(data, dtype=torch.int64, device=dev)
    keys = _as_keys(keys, dev)
    k0, k1 = split_key(keys)
    w0, w1, _, _ = philox4x32((data & MASK, (data >> 32) & MASK, FOLD, 0), (k0, k1))
    return join_words(w0, w1)


def stream_words(keys, index, streams: Sequence[Tuple[int, int]]):
    """Random uint32 words (in int64) for every key, from one batched Philox
    pass: ``streams`` is a list of (stream id, word count); returns one
    [..., count] tensor per stream, ``...`` the broadcast shape of ``keys``
    and ``index``. Word j of a stream is lane j % 4 of the block with
    counter (index, stream, j // 4)."""
    dev = _device(keys, index)
    keys = _as_keys(keys, dev)
    if isinstance(index, int):  # stays a Python int: no copy to the device
        lo, hi = index & MASK, (index >> 32) & MASK
    else:
        keys, index = torch.broadcast_tensors(
            keys, torch.as_tensor(index, dtype=torch.int64, device=dev))
        lo, hi = (index & MASK)[..., None], ((index >> 32) & MASK)[..., None]
    # Counter words 2 and 3 of every block, built on the device from an
    # arange (a host list would be a copy that waits for the device).
    j = torch.arange(sum(-(-n // 4) for _, n in streams), dtype=torch.int64, device=dev)
    c2, c3, at = torch.zeros_like(j), j.clone(), 0
    for sid, n in streams:
        inside = (j >= at) & (j < at - (-n // 4))
        c2 += inside * sid
        c3 -= inside * at
        at -= -n // 4
    k0, k1 = split_key(keys[..., None])
    words = torch.stack(philox4x32((lo, hi, c2, c3), (k0, k1)), dim=-1).flatten(-2)
    out, at = [], 0
    for _, n in streams:
        out.append(words[..., at : at + n])
        at += 4 * -(-n // 4)
    return out


def uniform(words: torch.Tensor, dtype) -> torch.Tensor:
    """Uniforms in (0, 1), never 0 or 1: float64 keeps all 32 bits,
    (w + 1/2) 2^-32; float32 keeps the top 23, (w' + 1/2) 2^-23, whose
    largest value 1 - 2^-24 is still below 1 in float32."""
    if dtype == torch.float64:
        return (words.to(torch.float64) + 0.5) * 2.0**-32
    if dtype != torch.float32:
        raise ValueError(f"uniform draws are float32 or float64, not {dtype}")
    return ((words >> 9).to(torch.float32) + 0.5) * 2.0**-23


def normal(words: torch.Tensor, dtype) -> torch.Tensor:
    """Standard normals by Box-Muller, two from each pair of words:
    [..., 2m] words -> [..., 2m] normals (cosine, sine interleaved)."""
    u = uniform(words, dtype)
    r = torch.sqrt(-2.0 * torch.log(u[..., 0::2]))
    theta = (2.0 * math.pi) * u[..., 1::2]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).flatten(-2)


def exponential(words: torch.Tensor, dtype) -> torch.Tensor:
    """Standard exponentials, -log u."""
    return -torch.log(uniform(words, dtype))
