"""Sequence generation (assembly) from a BEAR posterior (port of
bear_tpu/inference/assemble.py).

Seeds are extended letter by letter, right on the seed and left on its
reverse complement, for a batch of sequences at once on the device:

- the transition counts of a sequence's context are a gather from the
  dense count table at row ``offset0 + ctx`` (the table stays where it is,
  int32 on the card when it comes from the counter), or, from a sparse
  table (a ``SparseTableIndex``: sorted nonzero rows and their counts, lags
  up to 30), the binary search on the device that serving shares
  (:func:`bear_tpu_torch.inference.scoring.sparse_gather`), where absent
  rows count zero;
- concentrations are ``ar_apply(one_hot(window)) / h + counts`` (BEAR) or
  ``van + counts`` (BMM), the stop column set to 0 (no ends), no epsilon;
- MAP mode takes ``log(max(conc, 1e-30) / sum(conc[:4]))``; sampled mode a
  Dirichlet draw keyed by ``fold_in(fold_in(key, sequence), row)``, so a
  sequence that revisits a context reuses its draw while sequences stay
  independent (the reference's per-sequence sampled model, stateless): on
  the card one launch of the keyed-draw kernel per step
  (:func:`bear_tpu_torch.ops.keyed_draw.keyed_draw_full`), on the CPU its
  plain version, ``log_dirichlet_draw_keyed`` of the folded keys;
- the next letter is the Gumbel-max over the four residues, with a Gumbel
  key per step.

The host loop runs ``max(lengths)`` steps per batch; a sequence stops
moving once it has its length. Keys come from the port's Philox generator
(:mod:`bear_tpu_torch.ops.keyed_random`), so sampled sequences match
bear_tpu's in distribution and deterministic tables give the same
sequences. Rows and context codes are int64 (4^30 < 2^63) and
``fold_in`` takes int64 data, so the same-row-same-draw contract holds at
every lag without bear_tpu's two-fold split of rows beyond 32 bits.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from bear_tpu_torch.counting.count_chunk import table_rows
from bear_tpu_torch.inference.scoring import sparse_gather
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops.keyed_draw import keyed_draw_full
from bear_tpu_torch.ops.loggamma import log_dirichlet_draw_keyed
from bear_tpu_torch.utils.device import resolve_device

_RC = str.maketrans("ACGT", "TGCA")
GUMBEL_STEP = 2_000_003  # step t's Gumbel key: fold_in(batch key, GUMBEL_STEP + t)
DIRECTION_STRIDE = 1_000_003  # batch key: fold_in(key, direction * stride + start)
DRAW_ITERS = 4  # Marsaglia-Tsang proposals per draw, as bear_tpu's assembly
GUMBEL_BLOCK = 256  # steps whose Gumbel noise is drawn in one pass


def _revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


def _gumbel(batch_key, steps: range, B: int, dtype, dev) -> torch.Tensor:
    """Gumbel noise [len(steps), B, 4]: step t's under
    ``fold_in(batch_key, GUMBEL_STEP + t)``, counter index the sequence."""
    keys = kr.fold_in(batch_key, torch.arange(steps.start, steps.stop, device=dev)
                      + GUMBEL_STEP)
    (words,) = kr.stream_words(keys[:, None], torch.arange(B, device=dev)[None, :],
                               [(kr.EXPONENTIAL, 4)])
    return -torch.log(kr.exponential(words, dtype))


def _keyed_draw(seq_keys, seq_index, rows, conc):
    """Unnormalised log-Dirichlet draws [B, 5], sequence b's under
    ``fold_in(seq_keys[b], rows[b])``: the kernel on the card (base keys
    [1, B], group b), its plain version on the CPU, looked up in this
    module (tests/test_torch_assemble.py replaces it to watch the draws)."""
    if conc.device.type == "cpu":
        return log_dirichlet_draw_keyed(kr.fold_in(seq_keys, rows), conc, n_iter=DRAW_ITERS)
    return keyed_draw_full(seq_keys[None], seq_index, rows, conc, DRAW_ITERS)[0]


def _rollout(table, seed_codes, lengths, batch_key, h, van, *, lag, ar_apply, get_map,
             max_steps, dtype):
    """Generate ``max_steps`` letters for a batch of sequences.

    table : [rows(lag), A+1] transition counts on the device, or a
        (sorted int64 rows [n], counts [n, A+1]) pair of a sparse table.
    seed_codes : [B, lag] int64 codes of the seeds' last lag residues.
    lengths : [B] letters to generate per sequence (the rest is padding).
    Returns [B, max_steps] int64 letters 0..3 on the device."""
    if isinstance(table, tuple):
        gather = functools.partial(sparse_gather, *table)
        dev = table[0].device
    else:
        gather = table.__getitem__
        dev = table.device
    B = seed_codes.shape[0]
    offset0 = (4**lag - 1) // 3
    pow4 = 4 ** torch.arange(lag - 1, -1, -1, dtype=torch.int64, device=dev)
    ctx = (seed_codes * pow4).sum(dim=-1)
    window = seed_codes
    seq_index = torch.arange(B, device=dev)
    seq_keys = kr.fold_in(batch_key, seq_index)
    no_stop = torch.ones(5, dtype=dtype, device=dev)
    no_stop[-1] = 0.0
    out = torch.empty((B, max_steps), dtype=torch.int64, device=dev)
    for t0 in range(0, max_steps, GUMBEL_BLOCK):
        steps = range(t0, min(t0 + GUMBEL_BLOCK, max_steps))
        gumbel = _gumbel(batch_key, steps, B, dtype, dev)
        for t in steps:
            rows = offset0 + ctx
            counts = gather(rows).to(dtype)
            if ar_apply is not None:
                conc = ar_apply(alphabets.one_hot(window, 5, dtype)).to(dtype) / h + counts
            else:
                conc = van + counts
            conc = conc * no_stop  # no ends: the stop column is 0
            if get_map:
                log_probs = torch.log(torch.clamp_min(conc, 1e-30)
                                      / conc[:, :-1].sum(dim=-1, keepdim=True))
            else:
                lg = _keyed_draw(seq_keys, seq_index, rows, conc)
                log_probs = lg - torch.logsumexp(lg, dim=-1, keepdim=True)
            letters = torch.argmax(gumbel[t - t0] + log_probs[:, :4], dim=-1)
            active = t < lengths
            ctx = torch.where(active, (ctx * 4 + letters) % (4**lag), ctx)
            window = torch.where(active[:, None],
                                 torch.cat([window[:, 1:], letters[:, None]], dim=1), window)
            out[:, t] = letters
    return out


def assemble_no_ends(seeds, lengths_to_gen, num_to_gen: int, *, lag: int, counter_table,
                     h: Optional[float] = None, ar_apply=None, van: Optional[float] = None,
                     get_map: bool = False, alphabet_name: str = "dna",
                     batch_size: int = 1024, seed: int = 0,
                     save_folder: Optional[str] = None, dtype=torch.float32, device="cuda"):
    """Generate sequences by extending seeds in both directions (reference
    assemble.py:21-184, minus the KMC plumbing).

    seeds : seed sequences, each at least ``lag`` long.
    lengths_to_gen : [len(seeds), 2] letters to generate (left, right).
    num_to_gen : generated samples per seed.
    counter_table : [table_rows(lag), A+1] transition counts, a tensor (kept
        on its device when that is ``device``; e.g. a group of
        ``TransitionCounter(...).table(lag)``) or a numpy array (uploaded);
        or a sparse table, any object with sorted int64 ``.rows`` and
        aligned ``.counts`` [n, A+1] (``scoring.SparseTableIndex``; lags up
        to 30), both uploaded. The reference counts with reverse=True.
    h, ar_apply : a BEAR model (ar_apply: one-hot [B, lag, A+1] on
        ``device`` -> probabilities); or van : a BMM prior.
    get_map : extend with the MAP model rather than sampled AR models.
    dtype, device : where and in what type the rollout runs; "cuda"
        (default) raises without a card.

    Returns (gen_seqs [len(seeds), num_to_gen] strings, per-seed site-wise
    entropy arrays).
    """
    if (van is None) == (ar_apply is None):
        raise ValueError("specify exactly one of van / ar_apply+h")
    if ar_apply is not None and h is None:
        raise ValueError("ar_apply requires h (concentrations are ar_probs / h)")
    dev = resolve_device(device)
    seeds = [str(s) for s in seeds]
    for s in seeds:
        if len(s) < lag:
            raise ValueError("seeds must be at least lag long")
    lengths_to_gen = np.asarray(lengths_to_gen).reshape(len(seeds), 2)
    if hasattr(counter_table, "rows") and hasattr(counter_table, "counts"):
        table = (torch.as_tensor(np.asarray(counter_table.rows, np.int64)).to(dev),
                 torch.as_tensor(np.asarray(counter_table.counts)).to(dev))
    else:
        table = (counter_table if isinstance(counter_table, torch.Tensor)
                 else torch.from_numpy(np.asarray(counter_table))).to(dev)
        if table.shape[0] != table_rows(lag):
            raise ValueError(f"counter_table has {table.shape[0]} rows, lag {lag} needs "
                             f"{table_rows(lag)}")

    fwd_seqs = np.repeat(np.array(seeds), num_to_gen)
    lengths_rep = np.repeat(lengths_to_gen, num_to_gen, axis=0)  # [B, 2]
    rev_seqs = np.array([_revcomp(s) for s in fwd_seqs])
    lut = np.frombuffer("".join(alphabets.input_letters(alphabet_name)[:4]).encode(),
                        np.uint8)
    key = kr.key(seed)
    flanks = []
    for direction, (seqs_all, lens_all) in enumerate(
            [(rev_seqs, lengths_rep[:, 0]), (fwd_seqs, lengths_rep[:, 1])]):
        parts = []
        for start in range(0, len(seqs_all), batch_size):
            sub = seqs_all[start : start + batch_size]
            sub_lens = lens_all[start : start + batch_size]
            max_steps = int(np.max(sub_lens)) if len(sub_lens) else 0
            if max_steps == 0:
                parts += [""] * len(sub)
                continue
            seed_codes = alphabets.encode_kmers(np.array([s[-lag:] for s in sub]), "dna")
            letters = _rollout(
                table, torch.from_numpy(seed_codes.astype(np.int64)).to(dev),
                torch.from_numpy(sub_lens.astype(np.int64)).to(dev),
                kr.fold_in(key, direction * DIRECTION_STRIDE + start),
                0.0 if h is None else float(h), 0.0 if van is None else float(van),
                lag=lag, ar_apply=ar_apply, get_map=get_map, max_steps=max_steps,
                dtype=dtype)
            rows = lut[letters.cpu().numpy()]
            parts += [rows[i, : int(n)].tobytes().decode("ascii")
                      for i, n in enumerate(sub_lens)]
        flanks.append(parts)

    gen = [_revcomp(left) + seed_s + right
           for left, right, seed_s in zip(flanks[0], flanks[1], fwd_seqs)]
    gen_seqs = np.array(gen).reshape(-1, num_to_gen)
    sw_ent = _site_entropy(gen_seqs, alphabet_name)
    if save_folder is not None:
        _save_outputs(gen_seqs, sw_ent, lengths_to_gen, save_folder, alphabet_name)
    return gen_seqs, sw_ent


def _site_entropy(gen_seqs, alphabet_name: str = "dna"):
    """Site-wise entropy of each seed's generated ensemble (reference
    assemble.py:152-155), from byte comparisons on the host."""
    from scipy.special import xlogy

    letter_bytes = [ord(c) for c in alphabets.input_letters(alphabet_name)]
    out = []
    for group in gen_seqs:
        arr = np.array([np.frombuffer(s.encode("ascii"), np.uint8) for s in group])
        probs = np.stack([(arr == b).mean(axis=0) for b in letter_bytes], axis=-1)
        out.append(-np.sum(xlogy(probs, probs), axis=-1))
    return out


def _save_outputs(gen_seqs, sw_ent, lengths_to_gen, save_folder, alphabet_name):
    """``seqs.fa`` and, where matplotlib imports, ``entropy.png`` (reference
    assemble.py:157-183)."""
    os.makedirs(save_folder, exist_ok=True)
    with open(os.path.join(save_folder, "seqs.fa"), "w") as fh:
        for i, seqs in enumerate(gen_seqs):
            for j, s in enumerate(seqs):
                fh.write(f">seq{i}_rep{j}\n{s}\n")
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        return
    A = alphabets.alphabet_size(alphabet_name)
    plt.figure(figsize=[10, 5])
    plt.xlabel("position", fontsize=15)
    plt.ylabel("entropy", fontsize=15)
    xlim = [0, 0]
    for ent, l2g in zip(sw_ent, np.asarray(lengths_to_gen)):
        xs = np.arange(len(ent)) - l2g[0]
        xlim = [min(xlim[0], xs.min()), max(xlim[1], xs.max())]
        plt.plot(xs, ent, color="blue", linewidth=1, alpha=0.1)
    plt.plot(xlim, np.log(A) * np.ones(2), color="black", linewidth=2)
    plt.xlim(xlim)
    plt.ylim([0, plt.ylim()[1]])
    plt.savefig(os.path.join(save_folder, "entropy.png"), dpi=200)
    plt.close()
