"""Protein scoring traffic: closed-loop calls of ``BearServer.score`` with
posterior sampling over held-out proteins as they come, ragged, back to
back as the score CLI makes them on a proteome's FASTA.

Set-up draws the proteome (``bench_gpu/proteome.py``), counts its training
proteins into the resident table (``TransitionCounter`` over the protein
alphabet, one group, fed by ``engine.chunk_reads``) and builds a
``BearServer`` over it with the configuration's CNN at the seeded weights
(the AR's probabilities plus 1e-7 over h, plus the counts). Call i scores
the next ``params["seqs_per_call"]`` held-out proteins, neither bucketed
nor sorted, cycling over whole batches of them, under key
``seed * 2^20 + i`` with ``params["mc_samples"]`` samples, reduced to each
protein's mean and standard deviation. A call's windows are its real
transitions, each protein's length plus its stop. The warm-up scores every
batch once (so every padded width and call size the window meets), then
resets the program's ``padded_positions`` counter, where it has one, so
that it counts the window's calls.

The check is ``score.py``'s numbers over the checked calls' proteins, the
plain reference being ``reference.ragged``: the transitions of the ragged
proteins, the counts worked out again from the training proteins, the CNN
at the seeded weights in float32 with TF32 off, and the keyed draws.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_gpu import harness, proteome, weights
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import ragged

score = harness.load_module("traffic", "score")


def setup(run):
    return ScoreProtein(run)


class ScoreProtein(score.Score):
    def __init__(self, run):  # the base's set-up reads a genome: this one a proteome
        from bear_tpu_torch.counting import TransitionCounter, chunk_reads
        from bear_tpu_torch.inference.serving import BearServer
        from bear_tpu_torch.models import get_ar_func
        from bear_tpu_torch.ops import keyed_random

        self.run, self.kr = run, keyed_random
        cfg, p, dev = run.config, run.params, run.device
        lag = cfg["lag"]
        self.residues, self.lengths, self.groups = proteome.proteome_traffic(run.seed, cfg)
        run.mark("proteome")
        train = np.flatnonzero(self.groups == 0)
        counter = TransitionCounter(lags=[lag], n_groups=cfg["n_groups"],
                                    alphabet=cfg["alphabet"], device=dev)
        codes = proteome.sequences(self.residues, self.lengths)
        for chunk in chunk_reads(((codes[k], 0) for k in train), lag,
                                 batch_size=cfg["proteome"]["chunk_rows"]):
            counter.add_chunk(chunk)
        m = cfg["model"]
        self.ar = get_ar_func("cnn", lag, cfg["alphabet_size"],
                              {k: m[k] for k in ("num_filters", "filter_width",
                                                 "kmer_layer1_width")},
                              dtype=torch.float32, device=dev)
        self.params0 = weights.make_params(cfg, run.seed, dev)
        self.ar.load_params(self.params0[1:])
        self.ar.requires_grad_(False)
        ar = self.ar
        self.server = BearServer(counter.table(lag)[cfg["train_column"]], lag, h=m["serve_h"],
                                 ar_apply=lambda oh: ar(oh) + ref_model.EPSILON,
                                 dtype=torch.float32, alphabet=cfg["alphabet"], device=dev)
        del counter
        run.mark("count and server")
        held = np.flatnonzero(self.groups == 1)
        n = p["seqs_per_call"]
        self.batches = [held[i * n:(i + 1) * n] for i in range(len(held) // n)]
        self.strings = [proteome.strings(*proteome.select(self.residues, self.lengths, b))
                        for b in self.batches]
        self.transitions = [int((self.lengths[b] + 1).sum()) for b in self.batches]
        self.calls, self.outputs = 0, []

    def warmup(self):
        for b in range(len(self.batches)):
            self._call(b, -1 - b)
        from bear_tpu_torch.inference import serving

        if hasattr(serving, "padded_positions"):
            serving.padded_positions = 0

    def _call(self, batch, i):
        """Batch ``batch`` scored under call i's key."""
        p = self.run.params
        return self.server.score(self.strings[batch], mode="sample",
                                 key=self.kr.key(score.call_key(self.run.seed, i)),
                                 mc_samples=p["mc_samples"], reduce="mean_std")

    def _score(self, i):
        return self._call(i % len(self.batches), i)

    def step(self):
        out = self._score(self.calls)
        self.outputs.append(out)
        b = self.calls % len(self.batches)
        self.calls += 1
        self.run.work["seqs"] += len(self.batches[b])
        self.run.work["windows"] += self.transitions[b]

    def reference_scores(self, i, tf32=False):
        """[seqs, 2] mean and standard deviation of call i's proteins, by the
        plain reference."""
        cfg, p, dev = self.run.config, self.run.params, self.run.device
        lag, A = cfg["lag"], cfg["alphabet_size"]
        if not hasattr(self, "_keys"):
            res, lens = proteome.select(self.residues, self.lengths,
                                        np.flatnonzero(self.groups == 0))
            self._keys, self._n = ragged.count_keys(torch.as_tensor(res, device=dev),
                                                    torch.as_tensor(lens, device=dev), lag, A)
        b = self.batches[i % len(self.batches)]
        res, lens = proteome.select(self.residues, self.lengths, b)
        seq, rows, nxt = ragged.transitions(torch.as_tensor(res, device=dev),
                                            torch.as_tensor(lens, device=dev), lag, A)
        conc = ragged.concentrations(rows, self._keys, self._n,
                                     lambda oh: ref_model.cnn_probs(oh, self.params0[1:]),
                                     lag, A, cfg["model"]["serve_h"], tf32=tf32)
        return ragged.sampled_mean_std(score.call_key(self.run.seed, i), p["mc_samples"], seq,
                                       rows, nxt, conc, len(b), p["proposals"]).cpu().numpy()
