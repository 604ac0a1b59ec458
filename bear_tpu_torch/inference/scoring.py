"""Posterior-predictive scoring of variants and sequences (port of
bear_tpu/inference/scoring.py, the reference's get_var_probs.py).

k-mer counts come from a count table (TableCounter: a k-mer's counts are
table[row(context)]) or an in-memory dataset (DatasetCounter); transition
log-probabilities (get_pdf) are MAP point estimates, exact marginals, or
Monte Carlo Dirichlet draws from the keyed sampler, on the device in
float64.

Model stacking order matches the reference (get_var_probs.py:136-153):
[raw AR (MAP mode only)] + [BEAR at each h] + [BMM at each van].
A counter with a sparse host accumulator (``counts_for_rows``: multi-pass
and sparse-first counting, lags 14-30) is read through a
:class:`SparseTableIndex`; on the device a sparse table is looked up by
:func:`sparse_gather`.
"""

from __future__ import annotations

import configparser
import json
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops.distributions import EPSILON
from bear_tpu_torch.ops.loggamma import sample_dirichlet_log
from bear_tpu_torch.utils.checkpoint import load_params_list
from bear_tpu_torch.utils.device import resolve_device

STOP = "]"


# --- counters: kmer strings -> transition counts --------------------------


class SparseTable(NamedTuple):
    """A sparse count table of one group: sorted int64 ``rows`` [n] and
    aligned ``counts`` [n, A+1]."""

    rows: np.ndarray
    counts: np.ndarray


def sparse_gather(rows_sorted: torch.Tensor, counts: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """[..., A+1] counts of the table rows ``rows`` [...] in a sparse table
    on the device (sorted int64 rows [n], aligned counts [n, A+1]), by a
    binary search there, with no host sync; absent rows, and every row of
    an empty table, count zero."""
    n = rows_sorted.numel()
    if n == 0:
        return counts.new_zeros(tuple(rows.shape) + (counts.shape[1],))
    rows = rows.to(torch.int64)
    slot = torch.searchsorted(rows_sorted, rows).clamp_max(n - 1)
    hit = rows_sorted[slot] == rows
    return torch.where(hit[..., None], counts[slot], 0)


class SparseTableIndex:
    """Row -> counts index over a sparse-backed counter's nonzero rows
    (bear_tpu's, scoring.py:32-88): built once from one consolidation of
    the accumulator, then each query is a binary search and a gather, the
    random access behind TableCounter's sparse backend and sparse-table
    assembly (the py_kmc_api role at lags 14-30).

    Queries stay live: each ``gather`` checks whether the counter merged
    new counts since the index was built (an identity probe on its
    consolidated key array, no work while the counter is idle) and
    rebuilds if so. The ``rows`` / ``counts`` arrays are a snapshot of the
    last (re)build.

    rows : sorted [n] int64 nonzero table rows.
    counts : [n, A+1] int64 counts aligned with ``rows`` (one group).
    """

    def __init__(self, counter, lag: int, group: int = 0):
        self.lag = lag
        self._counter = counter
        self._group = group
        self._build()

    def _build(self):
        self.rows = np.asarray(self._counter.nonzero_rows(self.lag), np.int64)
        self.counts = np.ascontiguousarray(
            self._counter.counts_for_rows(self.lag, self.rows)[:, self._group, :])
        # The counter's consolidation returns the SAME key array until new
        # counts merge: an `is` check detects any counting since the build.
        self._keys_probe = self._counter._consolidated(self.lag)[0]

    def gather(self, rows) -> np.ndarray:
        """[len(rows), A+1] counts; rows absent from the table count zero
        (prior-only scoring, the DatasetCounter convention)."""
        if self._counter._consolidated(self.lag)[0] is not self._keys_probe:
            self._build()
        rows = np.asarray(rows, np.int64)
        out = np.zeros((len(rows), self.counts.shape[1]), self.counts.dtype)
        if len(self.rows) == 0 or len(rows) == 0:
            return out
        pos = np.minimum(np.searchsorted(self.rows, rows), len(self.rows) - 1)
        hit = self.rows[pos] == rows
        out[hit] = self.counts[pos[hit]]
        return out


class TableCounter:
    """Transition counts of context strings from a counter's table (the
    reference's KMC random-access queries, get_var_probs.py:210-289, as
    gathers): a TransitionCounter's dense host table, or for a counter
    with a sparse accumulator (``counts_for_rows``: multi-pass and sparse
    counting) a :class:`SparseTableIndex` — the dense table is never built.

    For reverse-strand inclusion, count over {s} and {revcomp(s)}
    (TransitionCounter(reverse=True)). no_end=True zeroes the stop column
    (assembly mode; ends of assemblies are unreliable,
    get_var_probs.py:212-213). Any alphabet works (the row codec is
    base-A)."""

    def __init__(self, counter, lag: int, group: int = 0, no_end: bool = False):
        self._alphabet = getattr(counter, "alphabet", "dna")
        self._A = getattr(counter, "A", 4)
        if hasattr(counter, "counts_for_rows"):
            self._index = SparseTableIndex(counter, lag, group)
            self._width = counter.A1
            self._gather = self._index.gather
        else:
            table = counter.tables[lag][group]
            self._width = table.shape[-1]
            self._gather = table.__getitem__
        self._lag = lag
        self._no_end = no_end

    def rows(self, kmers) -> np.ndarray:
        """Context strings (shorter ones are '['-padded) -> table rows."""
        kmers = np.asarray(kmers).astype(str)
        flat = np.array(
            ["[" * (self._lag - len(k)) + k if len(k) < self._lag else k
             for k in kmers.reshape(-1)]
        )
        A = self._A
        codes = alphabets.encode_kmers(flat, self._alphabet)  # '[' -> A
        is_pad = codes == A
        n_pad = is_pad.sum(axis=-1)
        pow_a = A ** np.arange(self._lag - 1, -1, -1, dtype=np.int64)
        digits = np.where(is_pad, 0, codes.astype(np.int64))
        # The suffix occupies the LAST (lag - n_pad) positions, so its
        # base-A value is the dot with descending powers ('[' digits are 0).
        code = (digits * pow_a[None, :]).sum(axis=-1)
        row = (A ** (self._lag - n_pad) - 1) // (A - 1) + code
        return row.reshape(kmers.shape)

    def __call__(self, kmers) -> np.ndarray:
        kmers = np.asarray(kmers)
        rows = self.rows(kmers).reshape(-1)
        out = self._gather(rows).astype(np.float64)
        if self._no_end:
            out[:, -1] = 0.0
        return out.reshape(kmers.shape + (self._width,))


class DatasetCounter:
    """Transition counts looked up in an in-memory CountDataset (the
    reference's batch-scan branch, get_var_probs.py:429-451). Unseen k-mers
    return zeros (prior-only scoring, get_var_probs.py:444-451)."""

    def __init__(self, dataset):
        kmers = np.asarray(dataset.kmers)
        self._order = np.argsort(kmers)
        self._sorted = kmers[self._order]
        self._counts = dataset.counts

    def __call__(self, kmers) -> np.ndarray:
        kmers = np.asarray(kmers)
        flat = kmers.reshape(-1)
        num_ds, A1 = self._counts.shape[1:]
        out = np.zeros((flat.size, num_ds, A1), dtype=self._counts.dtype)
        if len(self._sorted) and flat.size:
            pos = np.searchsorted(self._sorted, flat)
            pos_c = np.minimum(pos, len(self._sorted) - 1)
            hit = self._sorted[pos_c] == flat
            out[hit] = self._counts[self._order[pos_c[hit]]]
        return out.reshape(kmers.shape + (num_ds, A1))


# --- pdf ------------------------------------------------------------------


@dataclass
class Pdf:
    """Transition log-probabilities for a set of k-mers.

    log_probs : [num_kmers, A+1, num_models, mc_samples]
    kmers : the context strings, indexable by (k+1)-mer via lookup.
    """

    kmers: np.ndarray
    log_probs: np.ndarray
    alphabet_name: str

    def __post_init__(self):
        kmers = np.asarray(self.kmers)
        self._order = np.argsort(kmers)
        self._sorted = kmers[self._order]
        letters = alphabets.output_letters(self.alphabet_name)
        self._letter_order = np.argsort(letters)
        self._letters_sorted = letters[self._letter_order]

    def __contains__(self, kmer: str) -> bool:
        if not len(self._sorted):
            return False
        pos = min(int(np.searchsorted(self._sorted, kmer)), len(self._sorted) - 1)
        return bool(self._sorted[pos] == kmer)

    def _split(self, kp1mers):
        """(context, next-letter) split of fixed-width strings."""
        arr = np.asarray(kp1mers)
        W = arr.dtype.itemsize // 4  # U-width
        grid = arr.view("U1").reshape(len(arr), W)
        ctx = np.ascontiguousarray(grid[:, : W - 1]).view(f"U{W - 1}")[:, 0]
        return ctx, grid[:, W - 1]

    def lookup(self, kp1mers: Sequence[str]) -> np.ndarray:
        """[len(kp1mers), num_models, mc_samples] log-probs of transitions
        (sorted lookup). Raises KeyError on a context or letter outside the
        pdf."""
        if len(kp1mers) == 0:
            return np.zeros(self.log_probs.shape[2:])[None][:0]
        if not len(self._sorted):
            raise KeyError(str(np.asarray(kp1mers).reshape(-1)[0]))
        ctx, nxt = self._split(kp1mers)
        pos = np.minimum(np.searchsorted(self._sorted, ctx), len(self._sorted) - 1)
        miss = self._sorted[pos] != ctx
        if miss.any():
            raise KeyError(str(ctx[miss][0]))
        rows = self._order[pos]
        lpos = np.minimum(np.searchsorted(self._letters_sorted, nxt),
                          len(self._letters_sorted) - 1)
        lmiss = self._letters_sorted[lpos] != nxt
        if lmiss.any():
            raise KeyError(str(nxt[lmiss][0]))
        cols = self._letter_order[lpos]
        return self.log_probs[rows, cols]

    def __call__(self, kp1mers: Sequence[str]) -> np.ndarray:
        """Summed [num_models, mc_samples] contribution (the reference's
        summed prob_func, get_var_probs.py:84-89)."""
        if len(kp1mers) == 0:
            return np.zeros(self.log_probs.shape[2:])
        return self.lookup(kp1mers).sum(axis=0)

    def to_dataframe(self):
        """pandas DataFrame indexed by (k+1)-mer with one column per model
        (``model{m}``), or per model and sample (``model{m}_sample{s}``) when
        there is more than one sample: the reference get_pdf's return
        structure (get_var_probs.py:183-194). pandas is imported here only,
        so nothing else of scoring needs it."""
        import pandas as pd

        letters = alphabets.output_letters(self.alphabet_name)
        idx = [k + ch for k in self.kmers for ch in letters]
        n_models, n_samples = self.log_probs.shape[2:]
        vals = self.log_probs.reshape(len(idx), n_models * n_samples)
        if n_samples > 1:
            cols = [f"model{m}_sample{s}" for m in range(n_models) for s in range(n_samples)]
        else:
            cols = [f"model{m}" for m in range(n_models)]
        return pd.DataFrame(vals, index=idx, columns=cols)


@dataclass
class MargPdf:
    """Exact marginal-likelihood scorer: (kmers, transition count vectors)
    -> per-model log marginal (reference get_var_probs.py:156-170)."""

    kmers: np.ndarray
    concs: np.ndarray  # [num_models, num_kmers, A+1]

    def __post_init__(self):
        self._index = {k: i for i, k in enumerate(self.kmers)}

    def __contains__(self, kmer: str) -> bool:
        return kmer in self._index

    def __call__(self, kmers: Sequence[str], counts: np.ndarray) -> np.ndarray:
        from scipy.special import gammaln

        rows = np.array([self._index[k] for k in kmers])
        concs = self.concs[:, rows, :]  # [M, n, A+1]
        counts = np.asarray(counts, dtype=np.float64)[None]
        lp = (gammaln(concs.sum(-1)) - gammaln(concs).sum(-1)
              - gammaln((concs + counts).sum(-1)) + gammaln(concs + counts).sum(-1))
        return lp.sum(axis=-1)  # [num_models]


def get_pdf(kmers, counts, h, ar_apply: Optional[Callable], mc_samples: int,
            vans, train_col: int, alphabet_name: str, get_map: bool = False,
            get_marg: bool = False, key=None, dtype=torch.float64, device="cuda"):
    """Transition log-probabilities for all (k+1)-mer transitions
    (reference get_var_probs.py:91-194).

    kmers : context strings; counts : [n, num_ds, A+1] (train_col selects
    the column); h : BEAR h values (or None without an AR model);
    ar_apply : one-hot on ``device`` -> probs (load_bear's), or None for
    BMM only; vans : BMM symmetric priors; get_map : MAP point estimates
    (prepends a raw-AR model); get_marg : exact marginal scorer; key :
    sampler key (default key(0)).

    The AR model and the Monte Carlo draws run on ``device`` in ``dtype``.
    Returns Pdf (MC/MAP) or MargPdf (get_marg).
    """
    if get_marg and get_map:
        raise ValueError("pick marg or map")
    dev = resolve_device(device)
    A1 = alphabets.alphabet_size(alphabet_name) + 1
    kmers = np.asarray(kmers).astype(str)
    counts = np.asarray(counts, dtype=np.float64)
    counts_train = counts[:, train_col, :]
    vans = np.asarray(list(vans), dtype=np.float64)
    if get_map or get_marg:
        mc_samples = 1

    model_concs = []
    ar_vals = None
    if ar_apply is not None:
        h = np.atleast_1d(np.asarray(h, dtype=np.float64))
        with torch.no_grad():
            oh = alphabets.one_hot_kmers(kmers, alphabet_name, dtype, dev)
            ar_vals = ar_apply(oh).to(torch.float64).cpu().numpy()
        model_concs.append(ar_vals[None] / h[:, None, None])
    if len(vans) > 0:
        model_concs.append(vans[:, None, None] * np.ones((1, len(kmers), A1)))
    alpha = np.concatenate(model_concs, axis=0)
    concs = alpha + counts_train[None]

    if get_marg:
        return MargPdf(kmers=kmers, concs=concs)

    if get_map:
        if ar_vals is not None:
            concs = np.concatenate([ar_vals[None], concs], axis=0)
        log_probs = np.log(concs / concs.sum(-1, keepdims=True))
        log_probs = log_probs[..., None]  # mc axis
    else:
        key = kr.key(0) if key is None else key
        draws = sample_dirichlet_log(
            key, torch.as_tensor(concs, dtype=dtype, device=dev), size=(mc_samples,))
        log_probs = np.moveaxis(draws.cpu().numpy(), 0, -1)  # [M, n, A+1, S]

    # -> [num_kmers, A+1, num_models, mc_samples]
    log_probs = np.moveaxis(log_probs, 0, 2)
    return Pdf(kmers=kmers, log_probs=log_probs, alphabet_name=alphabet_name)


# --- model loading --------------------------------------------------------


def model_column_names(vans, get_map: bool = False, n_h: int = 1):
    """Names of the stacked model columns in get_pdf/get_bear_probs
    outputs, in stacking order (get_var_probs.py:136-153): raw AR first
    when get_map, then one BEAR column per h, then one BMM column per van."""
    names = ["AR"] if get_map else []
    names += ["BEAR"] if n_h == 1 else [f"BEAR(h{i})" for i in range(n_h)]
    names += [f"BMM(van={v})" for v in vans]
    return names


def load_bear(path: str, double_softmax: bool = True, device="cuda"):
    """Load a trained model directory (config.cfg + results.pickle) into a
    scoring-ready ``ar_apply`` (reference get_var_probs.py:59-82).

    double_softmax reproduces the reference's load-time quirk
    (get_var_probs.py:79-82): scoring uses softmax(ar_func(.)) + EPSILON
    even though ar_func already returns probabilities. Pass False for the
    mathematically intended probabilities.

    Returns (lag, alphabet_name, h, ar_apply, info); ar_apply maps one-hot
    contexts [..., lag, A+1] on ``device`` to probabilities [..., A+1].
    """
    dev = resolve_device(device)
    config = configparser.ConfigParser()
    config.read(os.path.join(path, "config.cfg"))
    lag = int(config["hyperp"]["lag"])
    alphabet_name = config["data"]["alphabet"]
    A = alphabets.alphabet_size(alphabet_name)
    dtype = torch.float64 if config["general"]["precision"] == "float64" else torch.float32
    name = config["model"]["ar_func_name"]
    ar = get_ar_func(name, lag, A, json.loads(config["model"]["af_kwargs"]),
                     dtype=dtype, device=dev)
    params_list = load_params_list(path)
    expected = 1 + len(ar.params_list())
    if len(params_list) != expected:
        raise ValueError(
            f"checkpoint at {path!r} holds {len(params_list)} parameter "
            f"arrays but ar_func {name!r} expects {expected} ([h_signed] + "
            "net params); reference-guided (train_bear_ref) model dirs carry "
            "[tau, nu] + net params and cannot be scored via load_bear"
        )
    params = bear_net.params_from_list(params_list, device=dev, dtype=dtype)
    ar.load_params(params["ar"])
    h = float(np.exp(params["h_signed"].cpu().numpy()))
    ar.requires_grad_(False)

    def ar_apply(oh):
        probs = ar(oh)
        if double_softmax:
            probs = torch.softmax(probs, dim=-1)
        return probs + EPSILON

    info = {
        "config": config,
        "params": params,
        "files_path": config["data"]["files_path"],
        "start_token": config["data"]["start_token"],
        "sparse": config["data"]["sparse"] == "True",
        "num_ds": int(config["data"]["num_ds"]),
    }
    return lag, alphabet_name, h, ar_apply, info


def load_bear_dataset(info):
    """The count dataset a trained model was fit on (reference
    get_var_probs.py:35-57)."""
    from bear_tpu_torch.data import discover_files, load_files
    from bear_tpu_torch.utils.config import bundled_ysd1_path

    if info["files_path"] == "TEST":
        files = [bundled_ysd1_path()]
    else:
        files = discover_files(info["files_path"], info["start_token"])
    return load_files(files, info["config"]["data"]["alphabet"], info["num_ds"],
                      sparse=info["sparse"])


# --- variant scoring ------------------------------------------------------


def parse_var(var: str):
    """'AAG23CC' -> ('AAG', 'CC', 23); insertions and deletions too
    (reference get_var_probs.py:336-341)."""
    is_int = [ch.isnumeric() for ch in var]
    pos_num = int(np.min(np.argwhere(is_int)))
    len_num = int(np.sum(is_int))
    return var[:pos_num], var[pos_num + len_num :], int(var[pos_num : pos_num + len_num])


def _variant_windows(wt_seq: str, var, lag: int):
    """Wild-type and mutant (k+1)-mer windows around a variant of the
    padded wild type (reference get_var_probs.py:293-334)."""
    wt_aa, mt_aa, pos = var
    pos = pos + lag
    if wt_aa != wt_seq[pos : pos + len(wt_aa)]:
        raise AssertionError(
            f"variant {var} does not match wild-type sequence at position {pos - lag}")
    wt_win = wt_seq[pos - lag : pos + lag + len(wt_aa)]
    mt_win = wt_seq[pos - lag : pos] + mt_aa + wt_seq[pos + len(wt_aa) : pos + lag + len(wt_aa)]
    wt_kmers = [wt_win[i : i + lag + 1] for i in range(len(wt_win) - lag)]
    mt_kmers = [mt_win[i : i + lag + 1] for i in range(len(mt_win) - lag)]
    return wt_kmers, mt_kmers


def _load_model(bear_path, lag, alphabet_name, h, vans, data, counter, device):
    """(lag, alphabet, h, ar_apply, data) of a scoring call: from a model
    directory (its own counts unless ``data``/``counter`` is given), or
    BMM-only from ``lag``, ``alphabet_name`` and ``data``/``counter``."""
    ar_apply = None
    if bear_path is not None:
        lag, alphabet_name, h_bear, ar_apply, info = load_bear(bear_path, device=device)
        if data is None and counter is None:
            data = load_bear_dataset(info)
        if h is None:
            h = np.array([h_bear])
    elif lag is None or alphabet_name is None or (data is None and counter is None) \
            or len(vans) == 0:
        raise ValueError("without a model directory, give lag, alphabet_name, "
                         "data or counter, and at least one van")
    return lag, alphabet_name, h, ar_apply, data


def _counts(all_kmers, data, counter, train_col):
    """Counts of the k-mers and the column to train on: a single-column
    counter (e.g. TableCounter) admits only train_col 0 (the reference
    asserted train_col == 0 on its KMC path, get_var_probs.py:398-399)."""
    if counter is None:
        return DatasetCounter(data)(all_kmers), train_col
    counts = np.asarray(counter(all_kmers))
    if counts.ndim == 2:
        if train_col != 0:
            raise ValueError("train_col must be 0 for a single-column counter")
        return counts[:, None, :], 0
    return counts, train_col


def get_bear_probs(bear_path: Optional[str], wt_seq: str, vars_, train_col: int,
                   mc_samples: int = 41, vans=(0.1, 1, 10), get_map: bool = False,
                   lag: Optional[int] = None, alphabet_name: Optional[str] = None,
                   h=None, data=None, counter: Optional[Callable] = None,
                   seed: int = 0, device="cuda"):
    """Score variants against a wild-type sequence by the Δ log-probability
    of their covering (k+1)-mers (reference get_var_probs.py:343-454).

    counter : optional callable kmers -> [n, A+1] counts (e.g.
        TableCounter); otherwise ``data`` (a CountDataset) is queried, or
        the model directory's own counts.

    Returns scores [num_variants, num_models, mc_samples] (mc axis dropped
    when get_map).
    """
    lag, alphabet_name, h, ar_apply, data = _load_model(
        bear_path, lag, alphabet_name, h, vans, data, counter, device)

    wt_seq = lag * "[" + wt_seq + STOP
    vars_parsed = [parse_var(v) for v in np.asarray(vars_)]

    all_kmers = []
    for var in vars_parsed:
        wt_k, mt_k = _variant_windows(wt_seq, var, lag)
        all_kmers += [k[:-1] for k in wt_k] + [k[:-1] for k in mt_k]
    all_kmers = np.array(sorted(set(all_kmers)))
    counts, train_col_eff = _counts(all_kmers, data, counter, train_col)

    pdf = get_pdf(all_kmers, counts, h, ar_apply, mc_samples, vans, train_col_eff,
                  alphabet_name, get_map, key=kr.key(seed), device=device)

    num_models = pdf.log_probs.shape[2]
    eff_samples = 1 if get_map else mc_samples
    scores = np.zeros((len(vars_parsed), num_models, eff_samples))
    for i, var in enumerate(vars_parsed):
        wt_k, mt_k = _variant_windows(wt_seq, var, lag)
        scores[i] += pdf(mt_k) - pdf(wt_k)
    if get_map:
        scores = scores[..., 0]
    return scores


# --- whole-sequence scoring ----------------------------------------------


def _seq_kmers(seq: str, lag: int):
    return [seq[i : i + lag] for i in range(len(seq) - lag)]


def get_bear_probs_seqs(bear_path: Optional[str], seqs, train_col: int,
                        mc_samples: int = 41, vans=(0.1, 1, 10),
                        get_map: bool = False, get_marg: bool = False,
                        lag: Optional[int] = None, alphabet_name: Optional[str] = None,
                        h=None, data=None, counter: Optional[Callable] = None,
                        no_ends: bool = False, seed: int = 0, device="cuda"):
    """Score whole sequences under the BEAR posterior predictive and the
    BMMs (reference get_var_probs.py:510-631).

    Returns scores [num_seqs, num_models, mc_samples] (mc axis dropped for
    get_map/get_marg).
    """
    lag, alphabet_name, h, ar_apply, data = _load_model(
        bear_path, lag, alphabet_name, h, vans, data, counter, device)

    if not no_ends:
        seqs = [lag * "[" + s + STOP for s in seqs]
    for s in seqs:
        if len(s.replace("[", "").replace(STOP, "")) < lag:
            raise ValueError("sequences shorter than the lag cannot be scored")

    all_kmers = np.array(sorted(set(k for s in seqs for k in _seq_kmers(s, lag))))
    counts, train_col_eff = _counts(all_kmers, data, counter, train_col)

    pdf = get_pdf(all_kmers, counts, h, ar_apply, mc_samples, vans, train_col_eff,
                  alphabet_name, get_map, get_marg, key=kr.key(seed), device=device)

    out_letters = alphabets.output_letters(alphabet_name)
    if get_marg:
        num_models = pdf.concs.shape[0]
        scores = np.zeros((len(seqs), num_models, 1))
        for i, seq in enumerate(seqs):
            # per-kmer transition-count vectors of this sequence; an
            # out-of-alphabet next letter adds an all-zero vector, like the
            # reference's alphabet == seq[l+lag] comparison
            kmer_counts = {}
            for l in range(len(seq) - lag):
                k = seq[l : l + lag]
                vec = kmer_counts.setdefault(k, np.zeros(len(out_letters)))
                vec += (out_letters == seq[l + lag]).astype(vec.dtype)
            ks = list(kmer_counts)
            scores[i, :, 0] = pdf(ks, np.stack([kmer_counts[k] for k in ks]))
        return scores[..., 0]

    num_models = pdf.log_probs.shape[2]
    eff_samples = 1 if get_map else mc_samples
    scores = np.zeros((len(seqs), num_models, eff_samples))
    # One lookup over every sequence's windows, summed per sequence with
    # reduceat (reference get_var_probs.py:458-484).
    kp1_all = [seq[l : l + lag + 1] for seq in seqs for l in range(len(seq) - lag)]
    if kp1_all:
        n_win = np.array([len(s) - lag for s in seqs])
        vals = pdf.lookup(kp1_all)
        offsets = np.concatenate([[0], np.cumsum(n_win)[:-1]])
        nz = n_win > 0
        scores[nz] = np.add.reduceat(vals, offsets[nz], axis=0)
    if get_map:
        scores = scores[..., 0]
    return scores
