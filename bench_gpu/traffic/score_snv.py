"""SNV-scan traffic: closed-loop calls of ``BearServer.delta_scores_snv``
over every single-letter substitution of a stretch of the genome, with
posterior sampling, as the score CLI's ``snv --all --sample --std`` makes
them.

Set-up is ``score.py``'s (the genome's reads counted into the resident
table, the server with the configuration's CNN at the seeded weights). The
wild type is the genome's first ``params["seqs_per_call"] / 3`` letters;
call i scores its every substitution (each position, each of the three
other letters) under key ``seed * 2^20 + i`` with ``params["mc_samples"]``
samples, reduced to each SNV's mean and standard deviation of Δ, mutant
less wild type. A call's sequences are its SNVs; its windows are those the
AR evaluates, each SNV's covering windows of the mutant and of the wild
type.

The check scores the checked calls' SNVs again with the plain reference
(``reference.sparse``): each window's context read letter by letter from
the wild type or the mutant, the counts looked up in the map of the
training reads' contexts, the CNN at the seeded weights in float32 with
TF32 off, the keyed draws, Δ summed in float64. It compares the 75th
percentile over those SNVs of the gap of a SNV's mean over the median |mean|
(Δ may be near 0, so a relative gap would not do) and of the gap of its
standard deviation over the median one, and the share of the SNVs whose
mean's gap is over ``params["share_over"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_gpu import genome, harness
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sparse as ref_sparse

score = harness.load_module("traffic", "score")


def setup(run):
    return ScoreSnv(run)


def wild_type(seed: int, config, n: int) -> np.ndarray:
    """The first ``n`` letters of the run's genome (int8 codes): the
    genome's generator draws the genome first."""
    g = config["genome"]
    rng = np.random.default_rng(seed)
    return genome.synth_genome(rng, int(g["genome_mb"] * 1e6), g["template_len"],
                               g["mutation_rate"])[:n]


class ScoreSnv(score.Score):
    def __init__(self, run):
        super().__init__(run)
        cfg, p = run.config, run.params
        lag = cfg["lag"]
        self.wt = wild_type(run.seed, cfg, p["seqs_per_call"] // 3)
        L = len(self.wt)
        self.wt_str = score.ALPHABET[self.wt].tobytes().decode("ascii")
        self.pos = np.repeat(np.arange(L), 3)
        self.alt = ((self.wt[:, None].astype(np.int64) + np.arange(1, 4)) % 4).reshape(-1)
        self.windows = 2 * int(np.minimum(lag + 1, L - self.pos + 1).sum())
        self.batches = self.strings = None  # the held-out reads go unscored

    def _score(self, i):
        p = self.run.params
        return self.server.delta_scores_snv(
            self.wt_str, self.pos, self.alt, mode="sample",
            key=self.kr.key(score.call_key(self.run.seed, i)), mc_samples=p["mc_samples"],
            reduce="mean_std")

    def step(self):
        self.outputs.append(self._score(self.calls))
        self.calls += 1
        self.run.work["seqs"] += len(self.pos)
        self.run.work["windows"] += self.windows

    def reference_scores(self, i, tf32=False):
        """[SNVs, 2] mean and standard deviation of call i's Δ, by the plain
        reference."""
        cfg, p, dev = self.run.config, self.run.params, self.run.device
        lag, A = cfg["lag"], cfg["alphabet_size"]
        if not hasattr(self, "_windows"):
            self._map = ref_sparse.count_map(
                torch.as_tensor(self.reads[self.groups == 0], device=dev), lag, A)
            self._windows = ref_sparse.snv_windows(torch.as_tensor(self.wt, device=dev),
                                                   torch.as_tensor(self.pos, device=dev),
                                                   torch.as_tensor(self.alt, device=dev), lag, A)
            self._conc = {}
        rw, nw, rm, nm, valid = self._windows
        if tf32 not in self._conc:
            probs = lambda oh: ref_model.cnn_probs(oh, self.params0[1:])  # noqa: E731
            self._conc[tf32] = [
                ref_sparse.concentrations(r.reshape(-1), *self._map, probs, lag, A,
                                          cfg["model"]["serve_h"], tf32=tf32
                                          ).reshape(r.shape + (A + 1,))
                for r in (rw, rm)]
        cw, cm = self._conc[tf32]
        d = ref_sparse.snv_deltas(score.call_key(self.run.seed, i), p["mc_samples"], rw, nw, cw,
                                  rm, nm, cm, valid, p["proposals"])
        return torch.stack([d.mean(dim=1), d.std(dim=1, correction=1)], dim=1).cpu().numpy()

    def check(self):
        got = [self.outputs[i] for i in self.checked_calls()]
        want = [self.reference_scores(i) for i in self.checked_calls()]
        return readings(got, want, self.run.params["share_over"])


def gaps(got, want):
    """Per SNV: the gap of its mean over the median |mean|, and the gap of
    its standard deviation over the median one."""
    got, want = np.concatenate(got), np.concatenate(want)
    return (np.abs(got[:, 0] - want[:, 0]) / np.median(np.abs(want[:, 0])),
            np.abs(got[:, 1] - want[:, 1]) / np.median(want[:, 1]))


def readings(got, want, share_over):
    """``score.readings``' numbers over the SNVs, with ``gaps``' scales."""
    mean_gap, std_gap = gaps(got, want)
    return {"mean_gap_q75": float(np.quantile(mean_gap, 0.75)),
            "std_gap_q75": float(np.quantile(std_gap, 0.75)),
            "mean_gap_share": float(np.mean(mean_gap > share_over))}
