"""MAP scoring traffic: closed-loop calls of ``BearServer.score`` in its
default mode, back to back as the score CLI makes them, over ``score.py``'s
set-up (the table, the CNN at the seeded weights, the held-out batches).
Call i scores the next ``params["seqs_per_call"]`` held-out reads, cycling
over whole batches of them: each read's MAP log-probability, the sum over
its transitions of log(conc[next] / sum(conc)).

The check draws ``params["checked_calls"]`` of the window's calls from the
seed and scores their reads again with the plain reference: the context
rows, the counts worked out again from the reads and the CNN at the seeded
weights, in float32 with TF32 off, each read's sum taken in float64. It
compares the 75th percentile and the largest, over those reads, of the
relative gap of a read's log-probability (no draw can flip here, so the
largest gap is steady).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_gpu import harness
from bench_gpu.reference import model as ref_model
from bench_gpu.traffic import _heldout

score = harness.load_module("traffic", "score")


def setup(run):
    return ScoreMap(run)


class ScoreMap(score.Score):
    def _score(self, i):
        return self.server.score(self.strings[i % len(self.strings)], mode="map")

    def reference_scores(self, i, tf32=False):
        """[seqs] MAP log-probabilities of call i's reads, by the plain
        reference."""
        batch, seq, rows, nxt, conc = _heldout.concentrations(
            self, i, lambda oh: ref_model.cnn_probs(oh, self.params0[1:]), tf32)
        logp = torch.log(conc / conc.sum(dim=-1, keepdim=True)).gather(-1, nxt[:, None])[:, 0]
        out = torch.zeros(batch.shape[0], dtype=torch.float64, device=logp.device)
        return out.index_add_(0, seq, logp.double()).cpu().numpy()

    def check(self):
        idx = self.checked_calls()
        return readings([self.outputs[i] for i in idx], [self.reference_scores(i) for i in idx])


def gaps(got, want):
    """Per read, the relative gap of its log-probability."""
    got, want = np.concatenate(got).astype(np.float64), np.concatenate(want)
    return np.abs(got - want) / np.abs(want)


def readings(got, want):
    """The numbers compared: the 75th percentile and the largest, over the
    checked reads, of the relative gap."""
    gap = gaps(got, want)
    return {"logp_gap_q75": float(np.quantile(gap, 0.75)), "logp_gap_max": float(gap.max())}
