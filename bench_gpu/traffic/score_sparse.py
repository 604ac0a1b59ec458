"""Scoring traffic over a sparse count map: ``score.py``'s closed-loop calls
of ``BearServer.score`` with posterior sampling, at a lag past every dense
table.

Set-up counts the genome's reads with ``SparseTransitionCounter`` (every
group, as a deployment counts its reads once) and builds a ``BearServer``
over the map of the training group (``SparseTableIndex``: the counted rows
and their counts), with the configuration's CNN at the seeded weights (the
AR's probabilities plus 1e-7 over h, plus the counts). A program whose
server takes only a dense table refuses it there, and the run fails before
its window. The calls are ``score.py``'s: the next
``params["seqs_per_call"]`` held-out reads under key ``seed * 2^20 + i``,
``params["mc_samples"]`` samples, each read's mean and standard deviation.
The warm-up resets the program's ``sparse_lookups`` counter, where it has
one, so that it counts the window's calls.

The check is ``score.py``'s numbers over the checked calls' reads, the
plain reference being ``reference.sparse``: int64 context rows, the counts
looked up in the sorted map of the training reads' contexts (a miss counts
zero), the CNN at the seeded weights in float32 with TF32 off, and the
keyed draws.
"""

from __future__ import annotations

import torch

from bench_gpu import genome, harness, weights
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import ragged
from bench_gpu.reference import sparse as ref_sparse

score = harness.load_module("traffic", "score")


def setup(run):
    return ScoreSparse(run)


class ScoreSparse(score.Score):
    def __init__(self, run):  # the base's set-up counts into a dense table: this one a map
        from bear_tpu_torch.counting import ReadChunk
        from bear_tpu_torch.counting.sparse import SparseTransitionCounter
        from bear_tpu_torch.inference.scoring import SparseTableIndex
        from bear_tpu_torch.inference.serving import BearServer
        from bear_tpu_torch.models import get_ar_func
        from bear_tpu_torch.ops import keyed_random

        self.run, self.kr = run, keyed_random
        cfg, p, dev = run.config, run.params, run.device
        lag = cfg["lag"]
        self.reads, self.groups = genome.genome_traffic(run.seed, cfg)
        run.mark("reads")
        counter = SparseTransitionCounter([lag], n_groups=cfg["n_groups"], device=dev)
        for arrays in genome.chunk_arrays(self.reads, self.groups, cfg["genome"]["chunk_rows"]):
            counter.add_chunk(ReadChunk(*arrays))
        table = SparseTableIndex(counter, lag, cfg["train_column"])
        del counter
        run.mark("sparse count")
        m = cfg["model"]
        self.ar = get_ar_func("cnn", lag, cfg["alphabet_size"],
                              {k: m[k] for k in ("filter_width", "num_filters",
                                                 "kmer_layer1_width")},
                              dtype=torch.float32, device=dev)
        self.params0 = weights.make_params(cfg, run.seed, dev)
        self.ar.load_params(self.params0[1:])
        self.ar.requires_grad_(False)
        ar = self.ar
        self.server = BearServer(table, lag, h=m["serve_h"],
                                 ar_apply=lambda oh: ar(oh) + ref_model.EPSILON,
                                 dtype=torch.float32, device=dev)
        del table
        run.mark("server")
        held = self.reads[self.groups == 1]
        n = p["seqs_per_call"]
        self.batches = [held[i * n:(i + 1) * n] for i in range(len(held) // n)]
        self.strings = [score.ALPHABET[b].view(f"S{b.shape[1]}")[:, 0].astype(str).tolist()
                        for b in self.batches]
        self.calls, self.outputs = 0, []

    def warmup(self):
        super().warmup()
        from bear_tpu_torch.inference import serving

        if hasattr(serving, "sparse_lookups"):
            serving.sparse_lookups = 0

    def reference_scores(self, i, tf32=False):
        """[seqs, 2] mean and standard deviation of call i's reads, by the
        plain reference."""
        cfg, p, dev = self.run.config, self.run.params, self.run.device
        lag, A = cfg["lag"], cfg["alphabet_size"]
        if not hasattr(self, "_map"):
            self._map = ref_sparse.count_map(
                torch.as_tensor(self.reads[self.groups == 0], device=dev), lag, A)
        batch = torch.as_tensor(self.batches[i % len(self.batches)], device=dev)
        rows, nxt = ref_sparse.context_rows(batch, lag, A)
        rows, nxt = rows.reshape(-1), nxt.reshape(-1)
        seq = torch.arange(batch.shape[0], device=dev).repeat_interleave(batch.shape[1] + 1)
        conc = ref_sparse.concentrations(rows, *self._map,
                                         lambda oh: ref_model.cnn_probs(oh, self.params0[1:]),
                                         lag, A, cfg["model"]["serve_h"], tf32=tf32)
        return ragged.sampled_mean_std(score.call_key(self.run.seed, i), p["mc_samples"], seq,
                                       rows, nxt, conc, batch.shape[0],
                                       p["proposals"]).cpu().numpy()
