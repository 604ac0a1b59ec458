"""Batch scoring over a count table on the device (port of
bear_tpu/inference/serving.py): sequences, SNVs and arbitrary variants,
MAP or posterior-sampled.

    rolling '['-padded context rows (the counting engine's index math)
    -> gather transition counts from the table on the device
    -> concentrations = ar(context)/h + counts   (or counts + van, BMM)
    -> MAP log-prob, or a Dirichlet draw of each context's transition
       distribution, keyed on (sample, [sequence,] table row)

Scores include the start-pad contexts and the stop transition, matching
the reference's get_bear_probs_seqs padding (get_var_probs.py:573-574).

Sampled draws are stateless (:mod:`bear_tpu_torch.ops.keyed_random`): the
draw of a row is a function of its key alone, so a context repeated within
a sequence reuses one draw, wild type and mutant share the draws of their
shared windows (Δ contributions cancel exactly), and results do not depend
on batching. Rows, gathers and concentrations are computed once per call;
only the draw carries the sample axis (:mod:`bear_tpu_torch.ops.keyed_draw`:
one kernel launch on the card, whose words and floats stay in registers; on
the CPU the plain version, in slices of elements that keep its temporaries
within ``SAMPLE_BUDGET_BYTES``).

``mesh=`` splits the table's rows over a mesh axis (serving a table too
large for one device): each slice is built on its own device from the
host table, one at a time, and gathers the query rows it owns, zeros
elsewhere; the sum over the slices (and over the processes of a spanning
mesh) is then an exact gather. Everything after the gather is as without
a mesh, so the draws stay keyed on the global table row.

Past the dense tables (DNA lag 16-30, protein lag 8-13: more rows than
int32 holds) the table is a sparse map, its sorted int64 nonzero rows and
their counts on the device, looked up by a binary search on the device
(:func:`bear_tpu_torch.inference.scoring.sparse_gather`); absent rows count
zero. The row arithmetic is int64 exactly at those lags and int32 below,
and the draws stay keyed on the row, so a row draws the same whether the
table is dense or sparse.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bear_tpu_torch.counting.engine import pad_offset, table_rows
from bear_tpu_torch.inference.scoring import (
    SparseTable,
    SparseTableIndex,
    load_bear,
    load_bear_dataset,
    parse_var,
    sparse_gather,
)
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops.keyed_draw import keyed_draw_picked, logp_picked
from bear_tpu_torch.ops.loggamma import _pairs
from bear_tpu_torch.parallel import multihost
from bear_tpu_torch.parallel.mesh import DataSplit, check_device
from bear_tpu_torch.utils.profiling import span

# Marsaglia-Tsang proposals per lane in the serving samplers (bear_tpu's
# setting): acceptance is >= 95% per proposal and a lane that accepts none
# falls back to the Wilson-Hilferty cube, so 3 keeps that ~1e-4 of lanes
# near the distribution.
SAMPLE_PROPOSALS = 3
# Memory the plain draw's temporaries may take in one slice of elements.
SAMPLE_BUDGET_BYTES = 4 << 30
# Rows per AR call when the sampled and Δ paths form concentrations: the
# lag-13 CNN of examples/genome_lag13.py holds ~10 KB of activations per
# row (chip_smoke.py's peak memory on an H100, PERF.md), so a slice stays
# near 2.7 GB.
AR_SLICE_ROWS = 1 << 18
# Calls of BearServer._encode_ragged whose strings all had one length
# (callers reset it).
uniform_encodes = 0
# Calls of BearServer.score whose strings differed in length, their codes
# laid into the padded matrix on the device (callers reset it).
ragged_device_pads = 0
# Positions of the sampled calls' padded [B, maxlen + 1] transition
# matrices, maxlen the width of the call's code matrix, masked in or not:
# what the row math runs over (callers reset it).
padded_positions = 0
# score() and Δ calls served from a sparse map (callers reset it).
sparse_lookups = 0
_INT32_MAX = int(np.iinfo(np.int32).max)


def row_dtype(lag: int, A: int = 4) -> torch.dtype:
    """Type of the table rows at ``lag``: int64 where the rows outnumber
    int32 (DNA lag >= 16, protein lag >= 8), else int32."""
    return torch.int64 if table_rows(lag, A) > _INT32_MAX else torch.int32


def _draw_bytes(A1: int, itemsize: int, F: int = SAMPLE_PROPOSALS,
                device_type: str = "cpu") -> int:
    """Peak temporary bytes of one (sample, element) draw. The kernel on
    the card keeps none in device memory; the plain version's are estimated
    from its tensors: ~9 live int64 Philox states per counter block while
    the rounds run, then ~16 float temporaries per proposal lane in the
    accept test."""
    if device_type == "cuda":
        return 0
    blocks = -(-_pairs(F * A1) // 4) + -(-F * A1 // 4) + -(-A1 // 4)
    return 80 * blocks + 16 * F * A1 * itemsize


def _sampled_logp_picked(keys, conc, nxt):
    """Posterior-sampled log-prob of the chosen category under one
    Dirichlet draw per key, with the serving samplers' proposals
    (:func:`bear_tpu_torch.ops.keyed_draw.logp_picked`)."""
    return logp_picked(keys, conc, nxt, SAMPLE_PROPOSALS)


def _map_picked(conc, nxt):
    """MAP log-prob of the chosen category, log(conc_k / sum conc)."""
    logp = torch.log(conc / conc.sum(dim=-1, keepdim=True))
    return logp.gather(-1, nxt[..., None].long())[..., 0]


def _context_rows_and_next(codes: torch.Tensor, lengths: torch.Tensor,
                           lag: int, A: int = 4):
    """Context-row/next-symbol extraction for '['-padded, '$'-terminated
    sequences: codes [B, L] (0..A-1), lengths [B].

    Returns rows [B, L+1], nxt [B, L+1], mask [B, L+1] — one entry per
    transition position j=0..len (j==len is the stop)."""
    with span("bear.score.rows"):
        B, L = codes.shape
        P = L + 1
        dev = codes.device
        rt = row_dtype(lag, A)
        j = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
        lengths = lengths.to(torch.int32)[:, None]
        codes_ext = torch.nn.functional.pad(codes.to(torch.int32), (lag, 1))
        digits = codes_ext if rt == torch.int32 else codes_ext.to(rt)

        code_acc = torch.zeros((B, P), dtype=rt, device=dev)
        pow_a = 1
        for i in range(1, lag + 1):
            code_acc += digits[:, lag - i : lag - i + P] * pow_a
            pow_a *= A
        row_off = torch.as_tensor(pad_offset(lag, np.maximum(0, lag - np.arange(P)), A),
                                  dtype=rt, device=dev)[None, :]
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


def table_from_dataset(dataset, lag: int, train_col: int = 0) -> np.ndarray:
    """Dense ``[table_rows(lag), A+1]`` transition table from one column of
    an in-memory CountDataset (a trained model directory's count files, via
    load_bear_dataset). Duplicate k-mer rows accumulate."""
    if dataset.lag != lag:
        raise ValueError(f"dataset lag {dataset.lag} != model lag {lag}")
    A = alphabets.alphabet_size(dataset.alphabet)
    rows = _rows_from_codes(dataset.codes, lag, A)
    table = np.zeros((table_rows(lag, A), A + 1), dataset.counts.dtype)
    np.add.at(table, rows, dataset.counts[:, train_col, :])
    return table


def sparse_table_from_dataset(dataset, lag: int, train_col: int = 0) -> SparseTable:
    """The sparse form of :func:`table_from_dataset`, for lags past the
    dense table: the dataset's distinct rows, sorted, and their counts in
    column ``train_col``. Duplicate k-mer rows accumulate."""
    if dataset.lag != lag:
        raise ValueError(f"dataset lag {dataset.lag} != model lag {lag}")
    A = alphabets.alphabet_size(dataset.alphabet)
    rows, inverse = np.unique(_rows_from_codes(dataset.codes, lag, A), return_inverse=True)
    counts = np.zeros((len(rows), A + 1), dataset.counts.dtype)
    np.add.at(counts, inverse.reshape(-1), dataset.counts[:, train_col, :])
    return SparseTable(rows, counts)


def _rows_to_onehot_contexts(rows: torch.Tensor, lag: int, dtype, A: int = 4):
    """Inverse of the row index on the device: [..] rows -> one-hot
    [.., lag, A+1] '['-padded contexts (integer-exact suffix-length
    decode)."""
    # suffix length m: number of boundaries (A^k - 1)/(A-1) <= row, k = 1..lag
    m = torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)
    for k in range(1, lag + 1):
        m += (rows >= (A**k - 1) // (A - 1)).to(torch.int32)
    offsets = torch.as_tensor([(A**k - 1) // (A - 1) for k in range(lag + 1)],
                              dtype=row_dtype(lag, A), device=rows.device)
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


def _reduce_width(reduce: str, quantiles) -> int:
    """Output columns of a reduction over the sample axis."""
    if reduce == "mean_std":
        return 2
    if reduce == "quantiles":
        return len(quantiles)
    raise ValueError(f"unknown reduce {reduce!r}")


def _reduce(d: torch.Tensor, reduce: str, quantiles) -> torch.Tensor:
    """[n, S] draws -> [n, 2] (mean, std with ddof = min(1, S-1): S = 1
    has no spread and reports 0) or [n, len(quantiles)] (linear
    interpolation, jnp.quantile's and torch.quantile's default)."""
    with span("bear.score.reduce"):
        if reduce == "mean_std":
            ddof = min(1, d.shape[-1] - 1)
            return torch.stack([d.mean(dim=-1), d.std(dim=-1, correction=ddof)], dim=-1)
        if reduce == "quantiles":
            q = torch.as_tensor(quantiles, dtype=d.dtype, device=d.device)
            return torch.quantile(d, q, dim=-1).T
    raise ValueError(f"unknown reduce {reduce!r}")


def _copy_out(t: torch.Tensor) -> np.ndarray:
    """A call's result on the host, where the host waits for the call's
    work on the device."""
    with span("bear.score.copy_out"):
        return t.cpu().numpy()


def _join_ascii(strs) -> bytes:
    """The strings joined into one ASCII byte string: all-str or all-bytes
    input joins as it is, mixed input after decoding its bytes; a
    non-ASCII letter raises UnicodeError."""
    try:
        return "".join(strs).encode("ascii")
    except TypeError:  # bytes elements
        pass
    try:
        joined = b"".join(strs)
    except TypeError:  # str and bytes mixed
        return "".join(s.decode("ascii") if isinstance(s, bytes) else s
                       for s in strs).encode("ascii")
    if not joined.isascii():
        joined.decode("ascii")  # raises as decoding each element does
    return joined


def _row_slices(table, mesh, axis: str, dtype):
    """(slices, rows per slice, whether the mesh spans processes) of a
    row-split table: slice i holds rows [i * local, (i + 1) * local) on the
    device at position i of ``axis`` (zero rows past the table's end), as
    (first row, tensor) for this process's positions. Each slice is built
    from a view of ``table`` on its own device, one at a time: there is
    never a padded copy of the whole table."""
    n = mesh.shape[axis]
    total = int(np.shape(table)[0])
    local = -(-total // n)
    me = multihost.process_index()
    slices = []
    for i, (dev, owner) in enumerate(zip(mesh.along(axis), mesh.owners(axis))):
        if owner != me:
            continue
        dev = check_device(dev)
        lo = i * local
        part = torch.as_tensor(table[min(lo, total):min(lo + local, total)]).to(dev).to(dtype)
        if part.shape[0] < local:
            part = torch.cat([part, part.new_zeros((local - part.shape[0],)
                                                   + tuple(part.shape[1:]))])
        slices.append((lo, part))
    return slices, local, mesh.spans_processes


def _pad_windows(win, width: int):
    """(rows, nxt, mask) [n, W] -> [n, width], padded with masked zeros."""
    pad = width - win[0].shape[1]
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in win)


class BearServer:
    """Batch scorer over a count table held on ``device``.

    Parameters
    ----------
    table : [table_rows(lag), A+1] transition counts (train column), a
        numpy array or tensor; or a sparse table, any object with sorted
        int64 ``.rows`` and aligned ``.counts`` [n, A+1] (a
        :class:`SparseTable` or ``SparseTableIndex``), or a counter with a
        sparse accumulator (``counts_for_rows``; its group 0), the form of
        the lags past the dense table. The sparse map holds the rows with a
        count, on ``device`` in ``dtype``.
    lag : model lag.
    h : BEAR concentration (with ``ar_apply``).
    ar_apply : (one-hot [.., lag, A+1] on ``device``) -> probs [.., A+1],
        e.g. from load_bear; None with ``van`` for the BMM.
    van : BMM symmetric prior (used when ar_apply is None).
    dtype : float type of the table, the draws and the scores.
    device : "cuda" (default) or "cpu".
    mesh / mesh_axis : optional :class:`bear_tpu_torch.parallel.Mesh`: the
        table's rows split over ``mesh_axis`` into ``ceil(rows / n)``-row
        slices (the last zero-padded), one per position of the axis; the
        queries, the AR and the scores stay on this process's first entry
        (the mesh's devices decide). Every process of a spanning mesh makes
        the same calls.

    No epsilon is added here: load_bear's ar_apply already carries
    +EPSILON, so scores match the reference's get_bear_probs_seqs.
    """

    def __init__(self, table, lag: int, *, h: Optional[float] = None,
                 ar_apply=None, van: Optional[float] = None,
                 dtype=torch.float32, alphabet: str = "dna", device="cuda",
                 mesh=None, mesh_axis: str = "kmer"):
        if (ar_apply is None) == (van is None):
            raise ValueError("specify exactly one of ar_apply / van")
        if ar_apply is not None and h is None:
            raise ValueError("ar_apply needs h")
        A = alphabets.alphabet_size(alphabet)
        if hasattr(table, "counts_for_rows"):
            table = SparseTableIndex(table, lag, 0)
        dev = DataSplit(mesh, device).master
        self._sparse = None
        if hasattr(table, "rows") and hasattr(table, "counts"):
            if mesh is not None:
                raise ValueError("a sparse table is served from one device; mesh= splits "
                                 "only a dense table")
            counts = np.asarray(table.counts)
            if counts.ndim != 2 or counts.shape[1] != A + 1:
                raise ValueError(f"sparse counts {counts.shape} are not [n, {A + 1}]")
            keep = counts.any(axis=1)
            self._sparse = (torch.as_tensor(np.asarray(table.rows, np.int64)[keep]).to(dev),
                            torch.as_tensor(counts[keep]).to(dev).to(dtype))
            self._table = self._slices = None
        elif np.shape(table)[0] != table_rows(lag, A):
            raise ValueError(
                f"table rows {np.shape(table)[0]} != rows(lag={lag}, A={A})"
            )
        elif mesh is None:
            # Counts move to the device in their own type first, then convert
            # there (no full-size host float copy).
            self._table = torch.as_tensor(table).to(dev).to(dtype)
            self._slices = None
        else:
            self._table = None
            self._slices, self._local, self._spans = _row_slices(
                table, mesh, mesh_axis, dtype)
        self._A = A
        self._dtype = dtype
        self._h = h
        self._ar_apply = ar_apply
        self._van = van
        self.device = dev
        self.lag = lag
        self.alphabet = alphabet

    @classmethod
    def from_model_dir(cls, path: str, *, train_col: int = 0,
                       double_softmax: bool = True, dtype=torch.float32,
                       device="cuda", mesh=None, mesh_axis: str = "kmer"):
        """A server from a trained model directory (config.cfg +
        results.pickle): the fitted (h, ar_func) via load_bear, the training
        counts via load_bear_dataset, densified from the ``train_col``
        column into a table on the device, or row-split over ``mesh_axis``
        of ``mesh`` (the reference's load-model-then-scan-counts set-up,
        get_var_probs.py:59-82 + 429-451). Past the dense table the counts
        become the sparse map (:func:`sparse_table_from_dataset`)."""
        dev = DataSplit(mesh, device).master
        lag, alphabet_name, h, ar_apply, info = load_bear(
            path, double_softmax=double_softmax, device=dev)
        dense = row_dtype(lag, alphabets.alphabet_size(alphabet_name)) == torch.int32
        table = (table_from_dataset if dense else sparse_table_from_dataset)(
            load_bear_dataset(info), lag, train_col=train_col)
        return cls(table, lag, h=h, ar_apply=ar_apply, dtype=dtype,
                   alphabet=alphabet_name, device=dev, mesh=mesh, mesh_axis=mesh_axis)

    def _concentrations(self, rows, counts):
        if self._ar_apply is None:
            return counts + self._van
        oh = _rows_to_onehot_contexts(rows, self.lag, self._dtype, self._A)
        return self._ar_apply(oh) / self._h + counts

    def _gather(self, rows):
        """The table's rows ``rows`` [...] -> [..., A1] on the device. Row
        split: each slice gathers the rows it owns and zeros elsewhere, so
        exactly one slice contributes each row and the sum is exact. Sparse
        map: a binary search on the device, absent rows zero."""
        if self._sparse is not None:
            with span("bear.score.lookup"):
                return sparse_gather(*self._sparse, rows)
        if self._slices is None:
            return self._table[rows]
        out = None
        for lo, tbl in self._slices:
            r = rows.to(tbl.device)
            mine = ((r >= lo) & (r < lo + self._local))[..., None]
            part = torch.where(mine, tbl[(r - lo).clamp(0, self._local - 1)], 0.0)
            part = part.to(self.device)
            out = part if out is None else out + part
        if out is None:  # this process owns no slice
            out = torch.zeros(tuple(rows.shape) + (self._A + 1,), dtype=self._dtype,
                              device=self.device)
        if self._spans:
            multihost.allreduce_sum_(out)
        return out

    def _row_concentrations(self, rows):
        """Concentrations [E, A1] of E table rows, the AR evaluated in
        slices of AR_SLICE_ROWS rows."""
        with span("bear.score.concentrations"):
            return torch.cat([self._concentrations(r, self._gather(r))
                              for r in torch.split(rows, AR_SLICE_ROWS)])

    def _count_sparse_call(self):
        global sparse_lookups
        if self._sparse is not None:
            sparse_lookups += 1

    def _sample_keys(self, key, mc_samples: int) -> torch.Tensor:
        """[S] sample keys fold_in(key, s)."""
        s = torch.arange(mc_samples, dtype=torch.int64, device=self.device)
        return kr.fold_in(kr._as_keys(key, self.device), s)

    def _draw_picked(self, base_keys, group, rows, nxt, conc):
        """Sampled log-prob of the chosen symbol of E elements: element e
        draws under fold_in(base_keys[:, group[e]], rows[e]). base_keys
        [S, G], group/rows/nxt [E], conc [E, A1] -> [S, E], by
        ``keyed_draw_picked``: on the card in one launch, on the CPU in
        slices of elements within SAMPLE_BUDGET_BYTES."""
        S, E = base_keys.shape[0], rows.shape[0]
        per = S * _draw_bytes(conc.shape[-1], conc.element_size(),
                              device_type=conc.device.type)
        with span("bear.score.draw"):
            if per == 0:
                return keyed_draw_picked(base_keys, group, rows, conc, nxt, SAMPLE_PROPOSALS)
            out = torch.empty((S, E), dtype=conc.dtype, device=conc.device)
            step = max(1, SAMPLE_BUDGET_BYTES // per)
            for s in range(0, E, step):
                sl = slice(s, s + step)
                out[:, sl] = keyed_draw_picked(base_keys, group[sl], rows[sl], conc[sl],
                                               nxt[sl], SAMPLE_PROPOSALS)
            return out

    def _window_logp(self, rows, nxt, keys):
        """Log-prob of the chosen symbol of E windows: [1, E] MAP (keys
        None) or [S, E] sampled, each draw keyed on (sample key, row)."""
        conc = self._row_concentrations(rows)
        if keys is None:
            return _map_picked(conc, nxt)[None]
        return self._draw_picked(keys[:, None], torch.zeros_like(rows), rows, nxt, conc)

    def _delta(self, mt, wt, keys):
        """Δ log-prob, mutant minus wild type, from their windows (rows,
        nxt, mask) [n, W_mt] and [n, W_wt]: [n] MAP, or [n, S] sampled.
        Only masked-in windows are scored, in one call; both sides are
        summed over one padded width, so identical windows cancel to an
        exact 0."""
        width = max(mt[0].shape[1], wt[0].shape[1])
        (rm, nm, mm), (rw, nw, mw) = _pad_windows(mt, width), _pad_windows(wt, width)
        lp = self._window_logp(torch.cat([rm[mm], rw[mw]]),
                               torch.cat([nm[mm], nw[mw]]), keys)
        k = int(mm.sum())
        a = lp.new_zeros((lp.shape[0],) + tuple(mm.shape))
        b = torch.zeros_like(a)
        a[:, mm] = lp[:, :k]
        b[:, mw] = lp[:, k:]
        d = (a - b).sum(dim=-1)
        return d[0] if keys is None else d.T

    @torch.no_grad()
    def log_prob_map(self, codes, lengths) -> torch.Tensor:
        """MAP per-sequence log-probabilities [B] for padded codes [B, L]
        and lengths [B]."""
        codes = torch.as_tensor(codes, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        rows, nxt, mask = _context_rows_and_next(codes, lengths, self.lag, self._A)
        with span("bear.score.concentrations"):
            conc = self._concentrations(rows, self._gather(rows))
        picked = _map_picked(conc, nxt)
        return torch.where(mask, picked, 0.0).sum(dim=-1)

    @torch.no_grad()
    def log_prob_sampled_multi(self, codes, lengths, keys) -> torch.Tensor:
        """Posterior-sampled log-probabilities [B, S] for [S] sample keys.
        Sequence b of sample s scores under its own sampled model, keyed
        fold_in(keys[s], b) (b the index in this call); a row repeated
        within a sequence reuses one draw. Rows, gathers and concentrations
        run once, for the masked-in transitions only."""
        global padded_positions
        codes = torch.as_tensor(codes, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        keys = kr._as_keys(keys, self.device).reshape(-1)
        rows, nxt, mask = _context_rows_and_next(codes, lengths, self.lag, self._A)
        padded_positions += mask.numel()
        with span("bear.score.mask"):  # the host waits for the mask's count
            b_idx, p_idx = mask.nonzero(as_tuple=True)
        rv, nv = rows[b_idx, p_idx], nxt[b_idx, p_idx]
        conc = self._row_concentrations(rv)
        seq = torch.arange(codes.shape[0], dtype=torch.int64, device=self.device)
        seq_keys = kr.fold_in(keys[:, None], seq[None, :])  # [S, B]
        picked = self._draw_picked(seq_keys, b_idx, rv, nv, conc)
        with span("bear.score.assemble"):
            full = picked.new_zeros((keys.shape[0],) + tuple(mask.shape))
            full[:, b_idx, p_idx] = picked
            return full.sum(dim=-1).T

    def log_prob_sampled(self, codes, lengths, key) -> torch.Tensor:
        """Posterior-sampled per-sequence log-probabilities [B] under one
        key (the draws of ``log_prob_sampled_multi`` with keys [key])."""
        return self.log_prob_sampled_multi(codes, lengths,
                                           kr._as_keys(key, self.device)[None])[:, 0]

    def _encode_ragged(self, strs, lens, maxlen):
        """Encode variable-length strings into a padded (0-filled) int8
        [N, maxlen] code matrix via ONE host join + byte translate. Strings
        of one length (a sequencing run's reads) are joined as they are and
        written as an [N, n] block; ragged ones are NUL-padded to maxlen in
        the join, NUL translating to 0."""
        global uniform_encodes
        with span("bear.score.encode"):
            lens = np.asarray(lens)
            N = len(strs)
            if N == 0 or maxlen == 0:
                return np.zeros((N, maxlen), np.int8)
            n = int(lens.max())
            if n > maxlen:
                raise ValueError(f"a string of {n} letters is longer than {maxlen}")
            if n == int(lens.min()):
                uniform_encodes += 1
                codes = alphabets.translate_ascii(_join_ascii(strs), self.alphabet)
                out = np.zeros((N, maxlen), np.int8)
                out[:, :n] = np.frombuffer(codes, np.int8).reshape(N, n)
                return out
            raw = _join_ascii([s.ljust(maxlen, b"\0" if isinstance(s, bytes) else "\0")
                               for s in strs])
            nuls = np.count_nonzero(np.frombuffer(raw, np.uint8) == 0)
            if nuls != N * maxlen - int(lens.sum()):
                # A NUL inside a string: raises naming the first bad letter.
                alphabets.translate_ascii(_join_ascii(strs), self.alphabet)
            codes = alphabets.translate_ascii(raw, self.alphabet, nul_pads=True)
            return np.frombuffer(bytearray(codes), np.int8).reshape(N, maxlen)

    def _encode_score(self, strs, lens, maxlen):
        """(codes, lengths) of a score call: the int8 [N, maxlen] code
        matrix, 0 past each string, and the [N] int32 lengths. Strings of
        one length (and an empty call) take ``_encode_ragged`` on the host.
        Ragged ones are joined and translated as they are, and their codes
        and lengths copied to the device, where the codes are laid row by
        row into the zeroed matrix; the host waits for none of it."""
        global ragged_device_pads
        lens = np.asarray(lens, np.int32)
        if len(strs) == 0 or lens.max() == lens.min():
            return self._encode_ragged(strs, lens, maxlen), lens
        with span("bear.score.encode"):
            ragged_device_pads += 1
            n = int(lens.max())
            if n > maxlen:
                raise ValueError(f"a string of {n} letters is longer than {maxlen}")
            # A bytearray: torch reads it without a copy, and its translate
            # is a plain table loop (bytes.translate also tracks whether any
            # byte changed, ~3x slower).
            flat = alphabets.translate_ascii(bytearray(_join_ascii(strs)), self.alphabet)
            flat = torch.frombuffer(flat, dtype=torch.int8).to(self.device, non_blocking=True)
            lengths = torch.from_numpy(lens).to(self.device, non_blocking=True)
            codes = torch.zeros((len(strs), maxlen), dtype=torch.int8, device=self.device)
            codes.masked_scatter_(torch.arange(maxlen, device=self.device) < lengths[:, None],
                                  flat)
            return codes, lengths

    def _sample_plan(self, mode, key, mc_samples, reduce, quantiles):
        """(sample keys or None, output width or None) of a Δ-score call,
        after checking the mode/reduce contract."""
        if reduce != "none" and mode != "sample":
            raise ValueError('reduce= requires mode="sample"')
        if mode == "map":
            return None, None
        if mode != "sample":
            raise ValueError(f"unknown mode {mode!r}")
        if key is None:
            raise ValueError('mode="sample" requires key=')
        width = mc_samples if reduce == "none" else _reduce_width(reduce, quantiles)
        return self._sample_keys(key, mc_samples), width

    def _finish(self, d, keys, reduce, quantiles):
        """A chunk's Δ [n] or [n, S] -> its output rows."""
        if keys is None or reduce == "none":
            return d
        return _reduce(d, reduce, quantiles)

    def _wt_transitions(self, wt_codes: np.ndarray):
        """The wild type's per-transition (rows, nxt) [L+1] on the device."""
        L = wt_codes.shape[0]
        rows, nxt, _ = _context_rows_and_next(
            torch.as_tensor(wt_codes[None, :], device=self.device),
            torch.tensor([L], dtype=torch.int32, device=self.device), self.lag, self._A)
        return rows[0], nxt[0]

    @torch.no_grad()
    def delta_scores_snv(self, wt_seq: str, positions, alt_bases,
                         batch: int = 1 << 17, mode: str = "map",
                         key=None, mc_samples: int = 1,
                         reduce: str = "none",
                         quantiles=(0.05, 0.5, 0.95)):
        """Δ log-prob (mutant − wild type) for a batch of substitutions on
        the device.

        A substitution at position p touches exactly the transitions t in
        [p, p+lag]: at t == p the next symbol changes; at t > p the context
        row shifts by (alt - ref) * A^(t-p-1). Only those 2(lag+1) windows
        are gathered per variant (the reference's Δ-window scoring,
        get_var_probs.py:293-334, 343-454).

        mode : "map" (equals ``get_bear_probs(..., get_map=True)``) or
            "sample" (each touched window scored under a posterior
            Dirichlet draw keyed on (sample, row); requires ``key``).
        mc_samples : with mode="sample", draws per variant; sample s uses
            key fold_in(key, s).
        reduce : with mode="sample": "none" returns the draws, "mean_std"
            [V, 2] (mean, ddof-1 std), "quantiles" [V, len(quantiles)].

        Returns [V] scores in the server's float type (or [V, mc_samples]
        when mc_samples > 1 / [V, 2] / [V, len(quantiles)]).
        """
        codes = alphabets.encode_kmers(np.array([wt_seq]), self.alphabet)[0]
        L = codes.shape[0]
        pos = np.asarray(positions, dtype=np.int64)
        if pos.ndim != 1:
            raise ValueError("positions must be 1-D")
        if (pos < 0).any() or (pos >= L).any():
            raise ValueError("SNV position outside the wild-type sequence")
        alt = np.asarray(alt_bases)
        if alt.dtype.kind in "US":
            alt = alphabets.encode_kmers(alt, self.alphabet)[:, 0]
        alt = alt.astype(np.int64)
        ref = codes[pos].astype(np.int64)
        keys, width = self._sample_plan(mode, key, mc_samples, reduce, quantiles)
        if keys is not None:
            # Window buffers and draws grow with the sample axis.
            batch = min(batch, max((1 << 21) // mc_samples, 1))
        self._count_sparse_call()
        rows1, nxt1 = self._wt_transitions(codes)
        lag, A, dev = self.lag, self._A, self.device
        rt = row_dtype(lag, A)
        i = torch.arange(lag + 1, dtype=torch.int64, device=dev)[None, :]
        pow_a = torch.as_tensor([1] + [A**k for k in range(lag)], dtype=rt,
                                device=dev)[None, :]
        V = len(pos)
        out = torch.empty((V,) if keys is None else (V, width), dtype=self._dtype,
                          device=dev)
        for s in range(0, V, batch):
            e = min(s + batch, V)
            p = torch.as_tensor(pos[s:e], device=dev)[:, None]
            a = torch.as_tensor(alt[s:e], dtype=rt, device=dev)[:, None]
            r = torch.as_tensor(ref[s:e], dtype=rt, device=dev)[:, None]
            t = p + i
            valid = t <= L  # t == L is the stop
            tc = torch.clamp(t, max=L)
            r_wt, n_wt = rows1[tc], nxt1[tc]
            r_mt = torch.where(i >= 1, r_wt + (a - r) * pow_a, r_wt)
            n_mt = torch.where(i == 0, a, n_wt)
            d = self._delta((r_mt, n_mt, valid), (r_wt, n_wt, valid), keys)
            out[s:e] = self._finish(d, keys, reduce, quantiles)
        out = _copy_out(out)
        if keys is None or reduce != "none":
            return out
        return out[..., 0] if mc_samples == 1 else out

    def _mt_windows(self, C: torch.Tensor, n_mt: torch.Tensor):
        """Mutant covering windows from the [V, Q] local char-code matrix
        (left lag context | variant letters | right context): window i
        covers chars C[:, i:i+lag] with next symbol C[:, i+lag]; '['-pads
        (code A) give digit 0 and count toward the prefix-block offset (the
        Horner form of _rows_from_codes' math)."""
        lag, A = self.lag, self._A
        rt = row_dtype(lag, A)
        W_mt = C.shape[1] - lag
        C32 = C.to(torch.int32)
        code = torch.zeros((C.shape[0], W_mt), dtype=rt, device=C.device)
        npad = torch.zeros((C.shape[0], W_mt), dtype=torch.int32, device=C.device)
        for k in range(lag):
            ch = C32[:, k : k + W_mt]
            is_pad = ch == A
            npad += is_pad.to(torch.int32)
            code = code * A + torch.where(is_pad, 0, ch)
        offsets = torch.as_tensor([pad_offset(lag, n, A) for n in range(lag + 1)],
                                  dtype=rt, device=C.device)
        rows_mt = offsets[npad] + code
        nxt_mt = C32[:, lag:]
        m_mt = torch.arange(W_mt, device=C.device)[None, :] < n_mt[:, None]
        return rows_mt, nxt_mt, m_mt

    @torch.no_grad()
    def delta_scores_variants(self, wt_seq: str, variants, *,
                              batch: int = 1 << 18, mode: str = "map",
                              key=None, mc_samples: int = 1,
                              reduce: str = "none",
                              quantiles=(0.05, 0.5, 0.95)):
        """Δ log-prob (mutant − wild type) for arbitrary variants — multi-
        base substitutions, insertions, deletions in the reference's
        'AAG23CC' syntax (get_var_probs.py:336-341) or (wt, mt, pos)
        triples — on the device.

        Covering-window semantics of get_bear_probs (reference
        get_var_probs.py:293-334): the wild-type windows of a variant are
        transitions pos..pos+n_wt-1 of the wild type; the host builds only
        an int8 char matrix of each mutant's local sequence, whose window
        rows, next symbols and masks are derived on the device. Modes,
        ``reduce`` and the returned shapes as in :meth:`delta_scores_snv`;
        the shapes hold for an empty variant list too.
        """
        lag = self.lag
        A = self._A
        wt_codes = alphabets.encode_kmers(np.array([wt_seq]), self.alphabet)[0].astype(np.int32)
        L = len(wt_codes)
        if isinstance(variants, np.ndarray):
            variants = variants.tolist()
        else:
            variants = list(variants)
        parsed = [parse_var(v) if isinstance(v, str) else v for v in variants]
        V = len(parsed)
        if reduce != "none" and mode != "sample":
            raise ValueError('reduce= requires mode="sample"')
        if V == 0:
            if mode == "sample" and reduce != "none":
                return np.zeros((0, _reduce_width(reduce, quantiles)), self._np_dtype())
            if mode == "sample" and mc_samples != 1:
                return np.zeros((0, mc_samples), self._np_dtype())
            return np.zeros((0,), self._np_dtype())
        self._count_sparse_call()

        # '['-padded + '$'-terminated char codes; both out-of-alphabet
        # symbols carry code A ('[' only in context prefixes, '$' only as a
        # final next symbol).
        padded_enc = np.concatenate([
            np.full(lag, A, np.int32), wt_codes, np.full(1, A, np.int32)])
        len_padded = L + lag + 1

        wt_aas, mt_aas, pos_t = zip(*parsed)
        pos = np.fromiter(pos_t, np.int64, V)
        lw = np.fromiter(map(len, wt_aas), np.int64, V)
        lm = np.fromiter(map(len, mt_aas), np.int64, V)
        if (pos < 0).any() or (pos + lw > L).any():
            raise ValueError("variant outside the wild-type sequence")
        max_lw, max_lm = int(max(lw.max(), 1)), int(max(lm.max(), 1))
        wt_var = self._encode_ragged(wt_aas, lw, max_lw)
        mt_var = self._encode_ragged(mt_aas, lm, max_lm)

        # The wild-type letters must match (reference get_var_probs.py:309).
        span = np.arange(max_lw)[None, :]
        in_wt = span < lw[:, None]
        ref_at = wt_codes[np.clip(pos[:, None] + span, 0, L - 1)]
        mism = in_wt & (ref_at != wt_var)
        if mism.any():
            bad = int(np.nonzero(mism.any(1))[0][0])
            raise AssertionError(
                f"variant {parsed[bad]} does not match wild-type sequence "
                f"at position {int(pos[bad])}"
            )

        p_pad = pos + lag
        right_len = np.clip(len_padded - (p_pad + lw), 0, lag)
        n_wt = lw + right_len  # wild-type covering windows
        n_mt = lm + right_len  # mutant covering windows
        W_wt = int(n_wt.max())

        # Mutant local char matrix C[v, q]: left context (lag), variant
        # letters (lm), right context (truncated at '$'), as int8.
        Q = 2 * lag + max_lm
        q = np.arange(Q)[None, :]
        is_left = q < lag
        is_mid = (q >= lag) & (q < lag + lm[:, None])
        idx_l = np.clip(p_pad[:, None] - lag + q, 0, len_padded - 1)
        idx_r = np.clip(p_pad[:, None] + lw[:, None] + (q - lag - lm[:, None]),
                        0, len_padded - 1)
        C = np.where(
            is_left, padded_enc[idx_l],
            np.where(is_mid,
                     mt_var[np.arange(V)[:, None], np.clip(q - lag, 0, max_lm - 1)],
                     padded_enc[idx_r])).astype(np.int8)

        keys, width = self._sample_plan(mode, key, mc_samples, reduce, quantiles)
        if keys is not None:
            # Arbitrary-variant windows are ~2x the SNV count: half its budget.
            batch = min(batch, max((1 << 20) // mc_samples, 1))
        rows1, nxt1 = self._wt_transitions(wt_codes)
        dev = self.device
        i_wt = torch.arange(W_wt, device=dev)[None, :]
        out = torch.empty((V,) if keys is None else (V, width), dtype=self._dtype,
                          device=dev)
        for s in range(0, V, batch):
            e = min(s + batch, V)
            p = torch.as_tensor(pos[s:e], device=dev)[:, None]
            nw = torch.as_tensor(n_wt[s:e], device=dev)
            tc = torch.clamp(p + i_wt, 0, L)
            wt = (rows1[tc], nxt1[tc], i_wt < nw[:, None])
            mt = self._mt_windows(torch.as_tensor(C[s:e], device=dev),
                                  torch.as_tensor(n_mt[s:e], device=dev))
            out[s:e] = self._finish(self._delta(mt, wt, keys), keys, reduce, quantiles)
        out = _copy_out(out)
        if keys is None or reduce != "none":
            return out
        return out[..., 0] if mc_samples == 1 else out

    def _np_dtype(self):
        return np.float64 if self._dtype == torch.float64 else np.float32

    @torch.no_grad()
    def score(self, seqs, mode: str = "map", key=None,
              pad_to: Optional[int] = None, mc_samples: int = 1,
              reduce: str = "none", quantiles=(0.05, 0.5, 0.95)):
        """List of strings -> [B] numpy scores. Pads to ``pad_to`` (or the
        max length rounded up to 64). mode="sample" scores each sequence
        under posterior draws: with mc_samples == 1 under ``key`` itself
        (default key(0)), else [B, mc_samples] under fold_in(key, s).
        ``reduce``/``quantiles`` as in :meth:`delta_scores_snv`: [B, 2]
        ("mean_std") or [B, len(quantiles)]."""
        with span("bear.score.call"):
            if reduce != "none" and mode != "sample":
                raise ValueError('reduce= requires mode="sample"')
            if mode not in ("map", "sample"):
                raise ValueError(f"unknown mode {mode!r}")
            seqs = list(seqs)
            lengths = np.fromiter(map(len, seqs), np.int32, len(seqs))
            maxlen = int(lengths.max()) if len(seqs) else 0
            L = pad_to or (-(-max(maxlen, 1) // 64) * 64)
            codes, lengths = self._encode_score(seqs, lengths, L)
            self._count_sparse_call()
            if mode == "map":
                return _copy_out(self.log_prob_map(codes, lengths))
            base = key if key is not None else kr.key(0)
            if reduce == "none" and mc_samples == 1:
                return _copy_out(self.log_prob_sampled(codes, lengths, base))
            d = self.log_prob_sampled_multi(codes, lengths, self._sample_keys(base, mc_samples))
            if reduce != "none":
                d = _reduce(d, reduce, quantiles)
            return _copy_out(d)
