"""The proteome traffic: a synthetic proteome of protein families, made from
the run's seed.

Each family is a random template over the 20 residues, its length drawn
log-normal (median ``median_len``, sigma ``len_sigma``) and clipped to
``min_len``..``max_len``; each member is the template with a share of its
positions substituted by a residue drawn uniformly over the 20 (real
proteomes hold families of homologues, which is what BEAR exploits). The
members are shuffled, and a share of them is held out as group 1.
Everything is drawn from one numpy generator in a fixed order: the template
lengths, the templates, the substitution sites, the substitutes, the
proteins' order, then the groups.

Proteins are held ragged: their int8 residue codes 0..19 concatenated, and
their lengths.
"""

from __future__ import annotations

import numpy as np

LETTERS = b"ARNDCEQGHILKMFPSTWYV"  # code i is LETTERS[i] (BEAR's prot alphabet)


def starts(lengths) -> np.ndarray:
    """Offset of each sequence's first residue in the concatenation."""
    lengths = np.asarray(lengths, np.int64)
    return np.cumsum(lengths) - lengths


def _gather(flat, lengths, first):
    """The sequences of ``lengths`` [n] that start at ``first`` [n] in
    ``flat``, concatenated."""
    idx = np.repeat(first - starts(lengths), lengths) + np.arange(int(lengths.sum()))
    return flat[idx]


def synth_proteome(seed, families, members, median_len, len_sigma, min_len, max_len,
                   substitution_rate, held_out):
    """(residues [sum(lengths)] int8 codes 0..19, lengths [n] int64, groups
    [n] int32: 0 = train, 1 = held out) of ``families * members`` proteins
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    A = len(LETTERS)
    t_len = np.clip(np.rint(median_len * np.exp(len_sigma * rng.standard_normal(families))),
                    min_len, max_len).astype(np.int64)
    templates = rng.integers(0, A, int(t_len.sum()), dtype=np.int8)
    lengths = np.repeat(t_len, members)
    residues = _gather(templates, lengths, np.repeat(starts(t_len), members))
    sites = np.flatnonzero(rng.random(residues.size) < substitution_rate)
    residues[sites] = rng.integers(0, A, sites.size, dtype=np.int8)
    order = rng.permutation(lengths.size)
    residues = _gather(residues, lengths[order], starts(lengths)[order])
    lengths = lengths[order]
    groups = (rng.random(lengths.size) < held_out).astype(np.int32)
    return residues, lengths, groups


def proteome_traffic(seed, config):
    """The proteins of a proteome configuration (its ``proteome`` group of
    keys)."""
    if config["alphabet_size"] != len(LETTERS):
        raise ValueError(f"a proteome has {len(LETTERS)} residues, the configuration "
                         f"{config['alphabet_size']}")
    p = config["proteome"]
    return synth_proteome(seed, p["families"], p["members"], p["median_len"], p["len_sigma"],
                          p["min_len"], p["max_len"], p["substitution_rate"], p["held_out"])


def select(residues, lengths, which):
    """(residues, lengths) of the proteins ``which`` (indices, in order)."""
    which = np.asarray(which)
    return _gather(residues, lengths[which], starts(lengths)[which]), lengths[which]


def sequences(residues, lengths):
    """Each protein's codes, a view of ``residues``, in order."""
    return np.split(residues, np.cumsum(lengths)[:-1]) if len(lengths) else []


def strings(residues, lengths) -> list:
    """Each protein as a string of its one-letter residues."""
    text = np.frombuffer(LETTERS, np.uint8)[residues].tobytes().decode("ascii")
    at = starts(lengths).tolist()
    return [text[s:s + n] for s, n in zip(at, np.asarray(lengths).tolist())]
