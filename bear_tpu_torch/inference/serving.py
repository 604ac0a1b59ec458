"""Batch sequence scoring over a device-resident count table (port of the
MAP path of bear_tpu/inference/serving.py).

    rolling '['-padded context rows (the counting engine's index math)
    -> gather transition counts from the table on the device
    -> concentrations = ar(context)/h + counts   (or counts + van, BMM)
    -> MAP log-prob sum per sequence

Scores include the start-pad contexts and the stop transition, matching
the reference's get_bear_probs_seqs padding (get_var_probs.py:573-574).
The sampled and Monte Carlo modes, SNV and variant Δ-scores and ``mesh=``
follow in later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bear_tpu_torch.counting.engine import pad_offset, table_rows
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.utils.device import resolve_device


def _context_rows_and_next(codes: torch.Tensor, lengths: torch.Tensor,
                           lag: int, A: int = 4):
    """Context-row/next-symbol extraction for '['-padded, '$'-terminated
    sequences: codes [B, L] (0..A-1), lengths [B].

    Returns rows [B, L+1], nxt [B, L+1], mask [B, L+1] — one entry per
    transition position j=0..len (j==len is the stop)."""
    B, L = codes.shape
    P = L + 1
    dev = codes.device
    j = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    codes_ext = torch.nn.functional.pad(codes.to(torch.int32), (lag, 1))

    code_acc = torch.zeros((B, P), dtype=torch.int32, device=dev)
    pow_a = 1
    for i in range(1, lag + 1):
        code_acc += codes_ext[:, lag - i : lag - i + P] * pow_a
        pow_a *= A
    row_off = torch.as_tensor(pad_offset(lag, np.maximum(0, lag - np.arange(P)), A),
                              dtype=torch.int32, device=dev)[None, :]
    rows = row_off + code_acc

    nxt = torch.where(j < lengths, codes_ext[:, lag : lag + P], A)
    mask = j <= lengths  # includes the stop transition
    return rows, nxt, mask


def _rows_from_codes(codes: np.ndarray, lag: int, A: int) -> np.ndarray:
    """Context codes [.., lag] ('[' coded as A) -> table rows (host)."""
    codes = codes.astype(np.int64)
    is_pad = codes == A
    n_pad = is_pad.sum(axis=-1)
    pow_a = A ** np.arange(lag - 1, -1, -1, dtype=np.int64)
    code = np.where(is_pad, 0, codes) @ pow_a
    return pad_offset(lag, n_pad, A) + code


def contexts_to_rows(contexts, lag: int, alphabet: str = "dna") -> np.ndarray:
    """Context strings (may contain leading '[') -> table rows."""
    codes = alphabets.encode_kmers(np.asarray(contexts), alphabet)
    return _rows_from_codes(codes, lag, alphabets.alphabet_size(alphabet))


def _rows_to_onehot_contexts(rows: torch.Tensor, lag: int, dtype, A: int = 4):
    """Inverse of the row index on the device: [..] rows -> one-hot
    [.., lag, A+1] '['-padded contexts (integer-exact suffix-length
    decode)."""
    # suffix length m: number of boundaries (A^k - 1)/(A-1) <= row, k = 1..lag
    m = torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)
    for k in range(1, lag + 1):
        m += (rows >= (A**k - 1) // (A - 1)).to(torch.int32)
    offsets = torch.as_tensor([(A**k - 1) // (A - 1) for k in range(lag + 1)],
                              dtype=torch.int32, device=rows.device)
    rem = rows - offsets[m]
    digs = []
    for _ in range(lag):
        digs.append(rem % A)
        rem = rem // A
    digits = torch.stack(digs[::-1], dim=-1)  # leftmost..rightmost residues
    pos = torch.arange(lag, dtype=torch.int32, device=rows.device)
    is_pad = pos < (lag - m)[..., None]
    classes = torch.where(is_pad, A, digits)
    return alphabets.one_hot(classes, A + 1, dtype)


class BearServer:
    """Batch MAP scorer over a count table held on ``device``.

    Parameters
    ----------
    table : [table_rows(lag), A+1] transition counts (train column), a
        numpy array or tensor.
    lag : model lag.
    h : BEAR concentration (with ``ar_apply``).
    ar_apply : (one-hot [.., lag, A+1] on ``device``) -> probs [.., A+1],
        e.g. from load_bear; None with ``van`` for the BMM.
    van : BMM symmetric prior (used when ar_apply is None).
    dtype : float type of the table and the scores.
    device : "cuda" (default) or "cpu".

    No epsilon is added here: load_bear's ar_apply already carries
    +EPSILON, so scores match the reference's get_bear_probs_seqs.
    """

    def __init__(self, table, lag: int, *, h: Optional[float] = None,
                 ar_apply=None, van: Optional[float] = None,
                 dtype=torch.float32, alphabet: str = "dna", device="cuda"):
        if (ar_apply is None) == (van is None):
            raise ValueError("specify exactly one of ar_apply / van")
        if ar_apply is not None and h is None:
            raise ValueError("ar_apply needs h")
        A = alphabets.alphabet_size(alphabet)
        if np.shape(table)[0] != table_rows(lag, A):
            raise ValueError(
                f"table rows {np.shape(table)[0]} != rows(lag={lag}, A={A})"
            )
        dev = resolve_device(device)
        # Counts move to the device in their own type first, then convert
        # there (no full-size host float copy).
        self._table = torch.as_tensor(table).to(dev).to(dtype)
        self._A = A
        self._dtype = dtype
        self._h = h
        self._ar_apply = ar_apply
        self._van = van
        self.device = dev
        self.lag = lag
        self.alphabet = alphabet

    def _concentrations(self, rows, counts):
        if self._ar_apply is None:
            return counts + self._van
        oh = _rows_to_onehot_contexts(rows, self.lag, self._dtype, self._A)
        return self._ar_apply(oh) / self._h + counts

    @torch.no_grad()
    def log_prob_map(self, codes, lengths) -> torch.Tensor:
        """MAP per-sequence log-probabilities [B] for padded codes [B, L]
        and lengths [B]."""
        codes = torch.as_tensor(codes, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        rows, nxt, mask = _context_rows_and_next(codes, lengths, self.lag, self._A)
        conc = self._concentrations(rows, self._table[rows])
        logp = torch.log(conc / conc.sum(dim=-1, keepdim=True))
        picked = logp.gather(-1, nxt[..., None].long())[..., 0]
        return torch.where(mask, picked, 0.0).sum(dim=-1)

    def _encode_ragged(self, strs, lens, maxlen):
        """Encode variable-length strings into a padded (0-filled)
        [N, maxlen] code matrix via ONE host join + byte-LUT gather."""
        lens = np.asarray(lens)
        out = np.zeros((len(strs), maxlen), np.int32)
        if len(strs) == 0 or maxlen == 0:
            return out
        try:
            joined = "".join(strs)
        except TypeError:  # bytes elements
            joined = "".join(
                s.decode("ascii") if isinstance(s, bytes) else s
                for s in strs)
        flat = alphabets.encode_string(joined, self.alphabet)
        # Boolean-mask assignment walks rows in order, matching the join.
        mask = np.arange(maxlen)[None, :] < lens[:, None]
        out[mask] = flat
        return out

    def score(self, seqs, mode: str = "map", pad_to: Optional[int] = None):
        """List of strings -> [B] numpy scores. Pads to ``pad_to`` (or the
        max length rounded up to 64)."""
        if mode != "map":
            raise NotImplementedError(
                f"score mode {mode!r} is not ported yet (needs ops/loggamma); "
                "see ROADMAP.md"
            )
        seqs = list(seqs)
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        maxlen = int(lengths.max()) if len(seqs) else 0
        L = pad_to or (-(-max(maxlen, 1) // 64) * 64)
        codes = self._encode_ragged(seqs, lengths, L).astype(np.int8)
        return self.log_prob_map(codes, lengths).cpu().numpy()
