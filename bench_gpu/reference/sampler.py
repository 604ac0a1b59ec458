"""Plain posterior-sampled scoring: keyed Philox4x32-10 words, Dirichlet
draws by the boosted Marsaglia-Tsang method with fixed proposals, and the
sampled log-probability of each sequence (a frozen copy of the sampler's
definition; Salmon et al., SC'11, for the generator; Marsaglia and Tsang,
ACM TOMS 2000, for the Gamma draws).

Keys are 64-bit integers held in int64 tensors; a Philox block maps the
counter (c0, c1, c2, c3) and the key's two 32-bit words to four words.

- ``fold_in(key, data)``: the first two words of the block with counter
  (data low, data high, 0, 0), as a key.
- A draw under key k takes its words from the blocks with counter
  (0, 0, stream, block): stream 1 the normals (Box-Muller over pairs of
  words, proposal-major then category), stream 2 the accept-test
  exponentials, stream 3 the boost exponentials; word i is lane i % 4 of
  block i // 4.
- A word w is the uniform (w + 1/2) 2^-32 in float64 and
  ((w >> 9) + 1/2) 2^-23 in float32.
- log Gamma(c) = log Gamma(c + 1) + log(U) / c; Gamma(c + 1) by the first
  of F Marsaglia-Tsang proposals that is accepted, the clamped last
  proposal when none is. Zero concentrations draw -inf.

Sequence b of a call with key K, sample s, scores its transition at context
row r under fold_in(fold_in(fold_in(K, s), b), r); its sampled log-prob is
the sum over transitions of log(draw[next] / sum(draw)).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
NORMAL, EXPONENTIAL, BOOST = 1, 2, 3


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 over int64 tensors holding uint32 words."""
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
        p0 = c0 * M0  # below 2^64: int64 keeps the low 64 bits
        p1 = c2 * M1
        hi0 = (p0 >> 32) & MASK
        hi1 = (p1 >> 32) & MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, p1 & MASK, hi0 ^ c3 ^ k1, p0 & MASK
    return c0, c1, c2, c3


def key_words(key):
    return key & MASK, (key >> 32) & MASK


def join(lo, hi):
    """Two uint32 words -> the int64 key with that bit pattern."""
    return lo + ((hi ^ 0x80000000) - 0x80000000) * (1 << 32)


def as_key(seed: int) -> int:
    """An integer as a 64-bit two's complement key."""
    return ((int(seed) + (1 << 63)) % (1 << 64)) - (1 << 63)


def fold_in(key, data):
    key = torch.as_tensor(key, dtype=torch.int64)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    k0, k1 = key_words(key)
    w0, w1, _, _ = philox(data & MASK, (data >> 32) & MASK, torch.zeros_like(data),
                          torch.zeros_like(data), k0, k1)
    return join(w0, w1)


def words(keys, stream: int, n: int):
    """The first n words of ``stream`` under each key: [..., n]."""
    k0, k1 = key_words(keys[..., None])
    block = torch.arange(-(-n // 4), dtype=torch.int64, device=keys.device)
    zero = torch.zeros_like(block)
    w = torch.stack(philox(zero, zero, zero + stream, block, k0, k1), dim=-1)
    return w.flatten(-2)[..., :n]


def uniform(w, dtype):
    if dtype == torch.float64:
        return (w.to(torch.float64) + 0.5) * 2.0 ** -32
    return ((w >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def log_dirichlet(keys, conc, n_prop: int):
    """Unnormalised log-Dirichlet draws [..., A] under keys [...] from
    concentrations [..., A]."""
    A, F, dt = conc.shape[-1], n_prop, conc.dtype
    n_norm = F * A + (F * A) % 2
    u = uniform(words(keys, NORMAL, n_norm), dt)
    radius = torch.sqrt(-2.0 * torch.log(u[..., 0::2]))
    angle = (2.0 * math.pi) * u[..., 1::2]
    x = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)
    x = x.flatten(-2)[..., :F * A].unflatten(-1, (F, A))
    e = -torch.log(uniform(words(keys, EXPONENTIAL, F * A), dt)).unflatten(-1, (F, A))
    boost = -torch.log(uniform(words(keys, BOOST, A), dt))
    c = torch.clamp_min(conc, 1e-30)
    d = (c + (1.0 - 1.0 / 3.0))[..., None, :]
    t = 1.0 + (1.0 / torch.sqrt(9.0 * d)) * x
    v = t * t * t
    vs = torch.where(v > 0, v, torch.ones_like(v))
    ok = (v > 0) & (-e < 0.5 * x * x + d - d * vs + d * torch.log(vs))
    first = ok & (torch.cumsum(ok.to(torch.int32), dim=-2) == 1)
    chosen = torch.where(ok.any(dim=-2), (vs * first).sum(dim=-2),
                         torch.clamp_min(v[..., -1, :], 1e-3))
    lg = torch.log(d[..., 0, :]) + torch.log(chosen) - boost / c
    return torch.where(conc > 0, lg, -torch.inf)


def picked_logp(keys, conc, nxt, n_prop: int):
    lg = log_dirichlet(keys, conc, n_prop)
    return lg.gather(-1, nxt[..., None])[..., 0] - torch.logsumexp(lg, dim=-1)


def sampled_scores(call_key: int, n_samples: int, seq_index, rows, nxt, conc, n_seqs: int,
                   n_prop: int, block: int = 1 << 15):
    """[n_seqs, n_samples] sampled log-probs, float64: transition e of
    sequence seq_index[e] at context row rows[e] with next symbol nxt[e]
    and concentrations conc[e], drawn in conc's type and summed per
    sequence in float64."""
    dev = conc.device
    sample_keys = fold_in(torch.tensor(as_key(call_key), device=dev),
                          torch.arange(n_samples, device=dev))
    out = torch.zeros((n_seqs, n_samples), dtype=torch.float64, device=dev)
    for s in range(0, rows.numel(), block):
        sl = slice(s, s + block)
        seq_keys = fold_in(sample_keys[None, :], seq_index[sl, None])
        keys = fold_in(seq_keys, rows[sl, None])
        lp = picked_logp(keys, conc[sl, None, :].expand(-1, n_samples, -1),
                         nxt[sl, None].expand(-1, n_samples), n_prop)
        out.index_add_(0, seq_index[sl], lp.to(torch.float64))
    return out
