"""Training traffic: closed-loop calls of ``bear_net.train`` that continue
one training run.

Set-up makes the training set (a genome configuration: its reads counted
by ``TransitionCounter`` and handed off on the device; a count-file
configuration: its file loaded), the starting weights from the seed, and
then drives the run's first three optimizer applies, each as one call of
``bear_net.train`` on its own batch of rows (the whole set where one batch
holds it). The warm-up is the first call of the window's form, from that
state; the window continues from there. Each such call is
``params["epochs_per_call"]`` epochs over the whole set in the
configuration's batches (the last one partial), taking the previous
call's parameters and optimizer state.

The check follows the three applies and then that first call of the
window's form with the plain reference in float64, from the same weights
and rows (worked out again from the reads or the file), and compares, as
the gap between the program's norm and the reference's over the larger of
the reference's norm and the median leaf's:

- ``loss_gap``, ``grad_gap``, ``change_gap``: each of the three applies'
  losses, each leaf's gradient at the first apply (from the optimizer's
  first moment, which is (1 - beta1) g after one step) and each leaf's
  change after the three;
- ``call_loss_gap``, ``call_change_gap``: each apply's loss in the call
  (every stacked batch, the partial one and each epoch's wrap included)
  and each leaf's change from the start to the end of the call.

Leaves whose reference gradient at the first apply is under a thousandth
of the median leaf's are left out of the changes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_gpu import genome, weights
from bench_gpu.reference import counts as ref_counts
from bench_gpu.reference import model as ref_model

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BETA1 = 0.9


def setup(run):
    return Train(run)


def count_handoff(run, reads, groups):
    """The program's training set of a genome configuration: the reads
    counted on the device, then handed off there."""
    from bear_tpu_torch.counting import ReadChunk, TransitionCounter

    cfg = run.config
    counter = TransitionCounter(lags=[cfg["lag"]], n_groups=cfg["n_groups"], device=run.device)
    for arrays in genome.chunk_arrays(reads, groups, cfg["genome"]["chunk_rows"]):
        counter.add_chunk(ReadChunk(*arrays))
    return counter.to_device_dataset(cfg["lag"])


class Train:
    def __init__(self, run):
        from bear_tpu_torch.data.loaders import load_dense
        from bear_tpu_torch.models import bear_net, get_ar_func

        self.run, self.bear_net = run, bear_net
        cfg, dev = run.config, run.device
        self.col = cfg["train_column"]
        if "genome" in cfg:
            self.reads, self.groups = genome.genome_traffic(run.seed, cfg)
            run.mark("reads")
            codes, counts = count_handoff(run, self.reads, self.groups)
            run.mark("count and handoff")
        else:
            ds = load_dense(os.path.join(BENCH, cfg["count_file"]), cfg["alphabet"],
                            cfg["num_ds"], native=False)
            codes = torch.as_tensor(ds.codes).to(dev)
            counts = torch.as_tensor(ds.counts).to(device=dev, dtype=torch.float32)
        self.codes, self.counts = codes, counts[:, self.col].contiguous()
        self.N = int(codes.shape[0])
        m = cfg["model"]
        kwargs = {k: m[k] for k in ("filter_width", "num_filters", "kmer_layer1_width")
                  if k in m}
        self.ar = get_ar_func(m["ar_func"], cfg["lag"], cfg["alphabet_size"], kwargs,
                              dtype=torch.float32, device=dev)
        self.params0 = weights.make_params(cfg, run.seed, dev)
        self.B = m["batch_size"]
        self.steps = -(-self.N // self.B)
        self.epochs = run.params["epochs_per_call"]
        state = ([p.clone() for p in self.params0], None)
        self.losses = []
        for k in range(3):
            sl = self.batch(k)
            res = self.call(self.codes[sl], self.counts[sl], 1, state)
            self.losses.append(float(res.losses[0]))
            if k == 0:
                self.first_grad = [torch.as_tensor(np.asarray(a)) / (1 - BETA1)
                                   for a in res.opt_state["exp_avg"]]
            state = self.state_of(res)
        self.params3 = [t.detach().cpu() for t in state[0]]
        run.mark("first three applies")
        self.state = state

    def batch(self, k):
        """The rows of apply k of the first three."""
        return slice(k * self.B, (k + 1) * self.B) if self.N >= 3 * self.B else slice(0, self.N)

    def call_batches(self):
        """The rows of each apply of a call of the window's form: batch
        a % steps of the set, the last batch of an epoch partial."""
        return [slice((a % self.steps) * self.B, (a % self.steps + 1) * self.B)
                for a in range(self.steps * self.epochs)]

    @staticmethod
    def state_of(res):
        return [res.params["h_signed"]] + list(res.params["ar"]), res.opt_state

    def call(self, codes, counts, epochs, state):
        return self.bear_net.train(
            codes, counts, num_kmers=self.N, ar_func=self.ar, batch_size=self.B,
            epochs=epochs, learning_rate=self.run.config["model"]["learning_rate"],
            train_ar=False, params_restart=state[0], opt_state_restart=state[1],
            dtype=torch.float32, device=self.run.device)

    def warmup(self):
        """The first call of the window's form, which the check follows."""
        res = self.call(self.codes, self.counts, self.epochs, self.state)
        self.state = self.state_of(res)
        self.call_losses = np.asarray(res.losses, dtype=np.float64)
        self.params_call = [t.detach().cpu() for t in self.state[0]]

    def step(self):
        res = self.call(self.codes, self.counts, self.epochs, self.state)
        self.state = self.state_of(res)
        self.run.work["applies"] += self.steps * self.epochs
        self.run.work["rows"] += self.N * self.epochs

    def release(self):
        self.codes = self.counts = self.state = None
        self.ar = None

    def reference_rows(self, dev):
        """The training set's codes and train-column counts, worked out
        again from the configuration's inputs."""
        cfg = self.run.config
        if "genome" in cfg:
            keys, n = ref_counts.count_keys(torch.as_tensor(self.reads, device=dev),
                                            torch.as_tensor(self.groups, device=dev),
                                            cfg["lag"], cfg["n_groups"])
            codes, table = ref_counts.handoff(keys, n, cfg["lag"], cfg["n_groups"])
        else:
            codes, table = ref_counts.parse_count_tsv(os.path.join(BENCH, cfg["count_file"]),
                                                      cfg["num_ds"])
            codes, table = codes.to(dev), table.to(dev)
        if codes.shape[0] != self.N:
            raise RuntimeError(f"the reference has {codes.shape[0]} rows, the program {self.N}")
        return codes, table[:, self.col]

    def reference(self, dtype=torch.float64, tf32=False, half=False):
        """The reference's (losses, first gradient, [parameters after the
        three applies, after the call]); with ``half``, each batch's first
        half of its rows, the mean taken over them (a fault's readings)."""
        codes, counts = self.reference_rows(self.run.device)
        slices = [self.batch(k) for k in range(3)] + self.call_batches()
        batches = [(codes[sl], counts[sl]) for sl in slices]
        if half:
            batches = [(c[: c.shape[0] // 2], n[: n.shape[0] // 2]) for c, n in batches]
        with ref_model.matmul_precision(tf32):
            return ref_model.train_steps(self.params0, self.run.config["model"]["ar_func"],
                                         batches, self.N,
                                         self.run.config["model"]["learning_rate"], dtype,
                                         marks=(3, len(batches)))

    def got(self):
        return (self.losses + list(self.call_losses), self.first_grad,
                [self.params3, self.params_call])

    def check(self):
        return readings(self.got(), self.reference(), self.params0)


def _norms(leaves):
    return np.array([float(torch.linalg.vector_norm(t.detach().double().cpu()))
                     for t in leaves])


def _gap(got, want, keep=None):
    """Worst leaf of |norm got - norm want| / max(norm want, median norm
    want) over the leaves ``keep`` selects."""
    keep = np.ones(len(want), bool) if keep is None else keep
    scale = np.maximum(want, np.median(want[keep]))
    return float(np.max(np.abs(got - want)[keep] / scale[keep]))


def readings(got, want, params0):
    """The numbers compared (module docstring), from the program's and the
    reference's (losses of every apply, first gradient, [parameters after
    the three applies, after the call])."""
    (l_got, g_got, p_got), (l_want, g_want, p_want) = got, want
    loss = np.abs(np.asarray(l_got) - np.asarray(l_want)) / np.abs(np.asarray(l_want))
    gn_want = _norms(g_want)
    moved = gn_want >= 1e-3 * np.median(gn_want)
    start = [p.detach().double().cpu() for p in params0]

    def change_gap(a, b):
        return _gap(_norms([x.double().cpu() - s for x, s in zip(a, start)]),
                    _norms([y.double().cpu() - s for y, s in zip(b, start)]), moved)

    return {
        "loss_gap": float(loss[:3].max()),
        "grad_gap": _gap(_norms(g_got), gn_want),
        "change_gap": change_gap(p_got[0], p_want[0]),
        "call_loss_gap": float(loss[3:].max()),
        "call_change_gap": change_gap(p_got[1], p_want[1]),
    }
