"""Scoring traffic with the attention AR: the calls of ``score.py`` (its
parameters, keys, reads and check), with the configuration's attention AR
at the seeded weights of ``weights_attention`` in the CNN's place.

Set-up counts the genome's training reads into the resident table and
builds a ``BearServer`` over it with the attention AR from ``get_ar_func``
(the AR's probabilities plus 1e-7 over h, plus the counts). The warm-up's
last act resets the program's ``attention_rows`` counter, where it has
one, so that it counts the window's rows.

The check is ``score.py``'s: the plain reference scores the checked calls'
reads again, with ``reference.attention`` at the seeded weights in float32
with TF32 off in place of the CNN.
"""

from __future__ import annotations

import torch

from bench_gpu import genome, harness, weights_attention
from bench_gpu.reference import attention as ref_attention
from bench_gpu.reference import model as ref_model
from bench_gpu.reference import sampler as ref_sampler
from bench_gpu.traffic import _heldout

score = harness.load_module("traffic", "score")


def setup(run):
    return ScoreAttention(run)


class ScoreAttention(score.Score):
    def __init__(self, run):  # the base's set-up builds the CNN: this one builds its own
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
        self.ar = get_ar_func("attention", cfg["lag"], cfg["alphabet_size"],
                              {k: m[k] for k in ("d_model", "num_heads", "mlp_width")},
                              dtype=torch.float32, device=dev)
        self.params0 = weights_attention.make_params(cfg, run.seed, dev)
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
        self.strings = [score.ALPHABET[b].view(f"S{b.shape[1]}")[:, 0].astype(str).tolist()
                        for b in self.batches]
        self.calls, self.outputs = 0, []

    def warmup(self):
        super().warmup()
        from bear_tpu_torch.models import ar_funcs

        if hasattr(ar_funcs, "attention_rows"):
            ar_funcs.attention_rows = 0

    def reference_scores(self, i, tf32=False):
        """[seqs, 2] mean and standard deviation of call i's reads, by the
        plain reference."""
        heads = self.run.config["model"]["num_heads"]
        batch, seq, rows, nxt, conc = _heldout.concentrations(
            self, i, lambda oh: ref_attention.attention_probs(oh, self.params0[1:], heads, tf32),
            tf32)
        p = self.run.params
        d = ref_sampler.sampled_scores(score.call_key(self.run.seed, i), p["mc_samples"], seq,
                                       rows, nxt, conc, batch.shape[0], p["proposals"])
        return torch.stack([d.mean(dim=1), d.std(dim=1, correction=1)], dim=1).cpu().numpy()
