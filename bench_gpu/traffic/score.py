"""Scoring traffic: closed-loop calls of ``BearServer.score`` with
posterior sampling, back to back as the score CLI makes them.

Set-up counts the genome's training reads into the resident table and
builds a ``BearServer`` over it with the configuration's CNN at the seeded
weights (the AR's probabilities plus 1e-7 over h, plus the counts). Call i
scores the next ``params["seqs_per_call"]`` held-out reads, cycling over
whole batches of them, under key ``seed * 2^20 + i`` with
``params["mc_samples"]`` samples, reduced to each read's mean and standard
deviation.

The check draws ``params["checked_calls"]`` of the window's calls from the
seed and scores their reads again with the plain reference: the context
rows, the counts worked out again from the reads, the CNN at the seeded
weights in float32 with TF32 off, and the keyed draws in the
configuration's type. It compares the 75th percentile over those reads of
the relative gap of a read's mean and of the gap of its standard
deviation over the median one, and the share of those reads whose mean's
relative gap is over ``params["share_over"]`` (a fault confined to a few
of a call's reads shows there).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_gpu import genome, weights
from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler

ALPHABET = np.frombuffer(b"ACGT", dtype="S1")


def setup(run):
    return Score(run)


def call_key(seed: int, i: int) -> int:
    return ref_sampler.as_key(seed * (1 << 20) + i)


class Score:
    def __init__(self, run):
        from bear_tpu_torch.counting import ReadChunk, TransitionCounter
        from bear_tpu_torch.inference.serving import BearServer
        from bear_tpu_torch.models import get_ar_func
        from bear_tpu_torch.ops import keyed_random

        self.run, self.kr = run, keyed_random
        cfg, p, dev = run.config, run.params, run.device
        self.reads, self.groups = genome.genome_traffic(run.seed, cfg)
        run.mark("reads")
        counter = TransitionCounter(lags=[cfg["lag"]], n_groups=cfg["n_groups"], device=dev)
        for arrays in genome.chunk_arrays(self.reads, self.groups, cfg["genome"]["chunk_rows"]):
            counter.add_chunk(ReadChunk(*arrays))
        m = cfg["model"]
        self.ar = get_ar_func("cnn", cfg["lag"], cfg["alphabet_size"],
                              {k: m[k] for k in ("filter_width", "num_filters",
                                                 "kmer_layer1_width")},
                              dtype=torch.float32, device=dev)
        self.params0 = weights.make_params(cfg, run.seed, dev)
        self.ar.load_params(self.params0[1:])
        self.ar.requires_grad_(False)
        ar = self.ar
        self.server = BearServer(counter.table(cfg["lag"])[cfg["train_column"]], cfg["lag"],
                                 h=m["serve_h"], ar_apply=lambda oh: ar(oh) + ref_model.EPSILON,
                                 dtype=torch.float32, device=dev)
        del counter
        run.mark("count and server")
        held = self.reads[self.groups == 1]
        n = p["seqs_per_call"]
        self.batches = [held[i * n:(i + 1) * n] for i in range(len(held) // n)]
        self.strings = [ALPHABET[b].view(f"S{b.shape[1]}")[:, 0].astype(str).tolist()
                        for b in self.batches]
        self.calls, self.outputs = 0, []

    def _score(self, i):
        p = self.run.params
        return self.server.score(self.strings[i % len(self.strings)], mode="sample",
                                 key=self.kr.key(call_key(self.run.seed, i)),
                                 mc_samples=p["mc_samples"], reduce="mean_std")

    def warmup(self):
        for i in range(2):
            self._score(-1 - i)

    def step(self):
        out = self._score(self.calls)
        self.outputs.append(out)
        self.calls += 1
        n, L = self.batches[0].shape
        self.run.work["seqs"] += n
        self.run.work["windows"] += n * (L + 1)

    def release(self):
        self.server = None
        self.ar = None

    def checked_calls(self):
        rng = np.random.default_rng(self.run.seed)
        k = min(self.run.params["checked_calls"], self.calls)
        return sorted(rng.choice(self.calls, size=k, replace=False).tolist())

    def reference_scores(self, i, tf32=False):
        """[seqs, 2] mean and standard deviation of call i's reads, by the
        plain reference."""
        cfg, p, dev = self.run.config, self.run.params, self.run.device
        lag, A = cfg["lag"], cfg["alphabet_size"]
        if not hasattr(self, "_keys"):
            train = self.groups == 0
            self._keys, self._n = ref_counts.count_keys(
                torch.as_tensor(self.reads[train], device=dev),
                torch.zeros(int(train.sum()), dtype=torch.int32, device=dev), lag, 1, A)
        batch = torch.as_tensor(self.batches[i % len(self.batches)], device=dev)
        rows, nxt = ref_counts.transition_rows(batch, lag, A)
        rows, nxt = rows.reshape(-1), nxt.reshape(-1)
        seq = torch.arange(batch.shape[0], device=dev).repeat_interleave(batch.shape[1] + 1)
        counts = torch.zeros((rows.numel(), A + 1), dtype=torch.float32, device=dev)
        for c in range(A + 1):
            want = rows * (A + 1) + c
            at = torch.searchsorted(self._keys, want).clamp(max=self._keys.numel() - 1)
            counts[:, c] = torch.where(self._keys[at] == want, self._n[at], 0).float()
        conc = torch.empty_like(counts)
        h = cfg["model"]["serve_h"]
        with ref_model.matmul_precision(tf32), torch.no_grad():
            for s in range(0, rows.numel(), 1 << 18):
                sl = slice(s, s + (1 << 18))
                oh = ref_model.one_hot(ref_counts.decode(rows[sl], lag, A), A + 1,
                                       torch.float32)
                probs = ref_model.cnn_probs(oh, self.params0[1:])
                conc[sl] = (probs + ref_model.EPSILON) / h + counts[sl]
        d = ref_sampler.sampled_scores(call_key(self.run.seed, i), p["mc_samples"], seq, rows,
                                       nxt, conc, batch.shape[0], p["proposals"])
        return torch.stack([d.mean(dim=1), d.std(dim=1, correction=1)], dim=1).cpu().numpy()

    def check(self):
        got = [self.outputs[i] for i in self.checked_calls()]
        want = [self.reference_scores(i) for i in self.checked_calls()]
        return readings(got, want, self.run.params["share_over"])


def gaps(got, want):
    """Per read: the relative gap of its mean, and the gap of its standard
    deviation over the median one."""
    got, want = np.concatenate(got), np.concatenate(want)
    return (np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0]),
            np.abs(got[:, 1] - want[:, 1]) / np.median(want[:, 1]))


def readings(got, want, share_over):
    """The numbers compared: the 75th percentile over the checked reads of
    each gap, and the share of the reads whose mean's gap is over
    ``share_over``. (The widest gap is not compared: it swings with the
    sampler's accept tests, which a last-bit difference in a small
    concentration can flip from one proposal to the next.)"""
    mean_gap, std_gap = gaps(got, want)
    return {"mean_gap_q75": float(np.quantile(mean_gap, 0.75)),
            "std_gap_q75": float(np.quantile(std_gap, 0.75)),
            "mean_gap_share": float(np.mean(mean_gap > share_over))}
