"""BEAR / AR training, evaluation and h-scan, in memory and streamed over
shards (port of bear_tpu/models/bear_net.py).

The model is ``{"h_signed": scalar tensor, "ar": [tensors]}``; the
checkpoint list is ``[h_signed] + ar`` (reference bear_net.py:99),
h = exp(h_signed).

Semantics kept from bear_tpu:
- loss = -(num_kmers / actual_batch_size) * sum of the batch's log-probs
  (reference bear_net.py:187-191); the partial last batch uses its actual
  (unpadded) size, and zero-padded rows add exactly 0.
- Batches are stacked once ([steps, B, ...], zero-row padding); apply a
  takes batches ``(a * acc_steps + k) % steps_per_epoch`` for k <
  acc_steps, so epochs wrap, and a trailing group of fewer than acc_steps
  batches is dropped (``total_steps // acc_steps`` applies).
- Adam takes eps=1e-7 (tf.keras's default, as bear_tpu's optax Adam).
- Evaluation sums its metrics across batches in float64 whatever the
  compute type. Exact ties of the most likely transition are broken by a
  generator seeded from (seed, global batch index), so a streamed
  evaluation whose batches line up with the in-memory one draws the same.
- Streaming (``train_streaming``): accumulation groups span shard
  boundaries, a trailing partial group is dropped, the in-shard
  permutation of epoch e at stream position p is
  ``default_rng([seed, e, p])``, and checkpoints count optimizer applies
  (rounded up to whole ``block_steps`` blocks), so they fall where
  bear_tpu's do. A resume fast-forwards past the applies already done.
- Reference counts (``ref_counts``, or a third element of every shard):
  the prepared reference column of the reference-guided model
  (:mod:`bear_tpu_torch.models.bear_ref`), stacked and permuted with the
  same batches as the codes and counts and given to the AR module as its
  third input.

- A mesh (``mesh=``, :class:`bear_tpu_torch.parallel.Mesh`): the batch
  rows pad to a multiple of the mesh's size (bear_tpu's ``pad_multiple``,
  so the step count, the per-step sizes and the ELBO scale of the whole
  global batch follow it) and entry i of the flat mesh takes the i-th
  contiguous slice of every batch. One master set of parameters and one
  optimizer live on this process's first entry; each entry computes its
  slice's loss with the parameters moved there by a differentiable
  ``.to``, and one backward over the entries' summed losses accumulates
  every entry's gradient into the master. On a mesh that spans processes
  the gradients and the loss are summed over the gloo group in one
  collective per apply, so every rank takes the same step and the ranks
  stay bit-identical; only process 0 writes checkpoints, and a resume
  whose state differs across processes raises. Evaluation sums each
  entry's float64 metrics in mesh order, then over the processes; its
  tie-break draws are made for the whole batch and sliced, so a mesh
  changes no draw.

The step loop never waits for the device: ELBOs stay on the device until
the run ends (or a checkpoint is written). Optimizers: Adam (eps 1e-7) and
SGD are ``torch.optim``'s; ``adamw``, ``adamax``, ``rmsprop``, ``adagrad``,
``nadam``, ``adadelta`` and ``lion`` are optax's rules
(:mod:`bear_tpu_torch.models.optimizers`).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from bear_tpu_torch.models.optimizers import OPTAX_RULES, OptaxRule
from bear_tpu_torch.ops.distributions import (
    EPSILON,
    dirichlet_multinomial_perm_logpmf,
    gumbel_noise,
    ml_output,
    multinomial_perm_logpmf,
)
from bear_tpu_torch.parallel import multihost
from bear_tpu_torch.parallel.mesh import DataSplit
from bear_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from bear_tpu_torch.utils.profiling import span


# --- model core -----------------------------------------------------------


def bear_log_prob(counts, ar_probs, h, condition=None):
    """BEAR marginal likelihood of transition counts: concentrations
    ar_probs / h + condition + eps (reference bear_net.py:43); condition
    None is the prior, a count tensor the posterior predictive."""
    conc = ar_probs / h + EPSILON
    if condition is not None:
        conc = conc + condition
    return dirichlet_multinomial_perm_logpmf(counts, conc)


def ar_log_prob(counts, ar_probs):
    """Point-AR likelihood: multinomial with probs ar + eps (reference
    bear_net.py:68)."""
    return multinomial_perm_logpmf(counts, ar_probs + EPSILON)


def init_params(generator: torch.Generator | None, ar_func, dtype=torch.float32):
    """h_signed = log h, init 0 (reference bear_net.py:73-100), and a fresh
    draw of the AR parameters from ``generator`` (on the CPU)."""
    return {"h_signed": torch.zeros((), dtype=dtype),
            "ar": [p.to(dtype) for p in ar_func.init(generator)]}


def params_to_list(params) -> List[np.ndarray]:
    """Flatten to the checkpoint order [h_signed] + ar, as numpy arrays."""
    return [np.asarray(_host(params["h_signed"]))] + [
        np.asarray(_host(p)) for p in params["ar"]
    ]


def params_from_list(lst, device="cuda", dtype=torch.float32):
    """Inverse of params_to_list: a ``[h_signed] + ar`` list of numpy arrays
    or tensors (bear_tpu's ``params_to_list``, or a results.pickle) ->
    tensors on ``device`` (copies: the arrays may be read-only)."""
    return {"h_signed": _tensor(lst[0], device, dtype),
            "ar": [_tensor(p, device, dtype) for p in lst[1:]]}


def _tensor(p, device, dtype) -> torch.Tensor:
    """A copy of an array or tensor as a tensor on ``device``."""
    if isinstance(p, torch.Tensor):
        return p.detach().to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(p), dtype=dtype, device=device)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def make_optimizer(optimizer_name: str, learning_rate: float, params):
    """Optimizer by (Keras-style) name over ``params``: Adam with eps=1e-7
    (tf.keras's default, as bear_tpu's optax Adam), plain SGD, or one of
    optax's rules that bear_tpu offers (``OPTAX_RULES``)."""
    name = optimizer_name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, eps=1e-7)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name in OPTAX_RULES:
        return OPTAX_RULES[name](params, learning_rate)
    raise ValueError(f"unknown optimizer {optimizer_name!r}")


def optimizer_state(opt) -> dict:
    """The port's optimizer state as plain numpy (picklable without torch
    or optax): ``{"name", "step", "exp_avg", "exp_avg_sq"}`` for Adam,
    ``{"name"}`` for SGD, ``OptaxRule.state_arrays`` for the others; the
    per-parameter arrays in checkpoint order."""
    params = opt.param_groups[0]["params"]
    if isinstance(opt, OptaxRule):
        return opt.state_arrays()
    if isinstance(opt, torch.optim.SGD):
        return {"name": "sgd"}
    states = [opt.state[p] for p in params]
    return {
        "name": "adam",
        "step": int(states[0]["step"]) if states and states[0] else 0,
        "exp_avg": [_host(s["exp_avg"]) for s in states],
        "exp_avg_sq": [_host(s["exp_avg_sq"]) for s in states],
    }


def _load_optimizer_state(opt, state: dict) -> None:
    """Inverse of :func:`optimizer_state`, into a fresh optimizer."""
    if isinstance(opt, OptaxRule):
        opt.load_state_arrays(state)
        return
    params = opt.param_groups[0]["params"]
    name = "sgd" if isinstance(opt, torch.optim.SGD) else "adam"
    if state.get("name") != name:
        raise ValueError(f"optimizer state is {state.get('name')!r}, the optimizer {name!r}")
    if name == "sgd" or state["step"] == 0:
        return
    for p, m, v in zip(params, state["exp_avg"], state["exp_avg_sq"]):
        opt.state[p] = {
            "step": torch.tensor(float(state["step"]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.array(m)).to(p.device, p.dtype),
            "exp_avg_sq": torch.as_tensor(np.array(v)).to(p.device, p.dtype),
        }


# --- training -------------------------------------------------------------


@dataclass
class TrainResult:
    params: dict  # {"h_signed", "ar"}: tensors on the training device
    losses: np.ndarray  # positive loss (-ELBO) at each optimizer apply
    opt_state: Optional[dict] = None  # optimizer_state(); pass back as
    # opt_state_restart to resume exactly

    @property
    def elbos(self) -> np.ndarray:
        """ELBO estimates per apply — the reference's loss_save contract
        (bear_net.py:307), what its loss.png plots."""
        return -self.losses

    @property
    def h(self) -> float:
        return float(np.exp(_host(self.params["h_signed"])))

    @property
    def params_list(self) -> List[np.ndarray]:
        return params_to_list(self.params)


def _stack_geometry(n: int, batch_size, pad_multiple: int = 1):
    """(batch size rounded up to a multiple of ``pad_multiple``, step
    count) shared by every stacked array."""
    bsz = -(-int(batch_size) // pad_multiple) * pad_multiple
    return bsz, max(1, -(-n // bsz))


def _stack_one(arr: torch.Tensor, batch_size, pad_multiple: int = 1) -> torch.Tensor:
    """Zero-pad ONE tensor's rows and stack it to [n_steps, B, ...] on its
    own device (the single home of the batch geometry)."""
    n = arr.shape[0]
    bsz, n_steps = _stack_geometry(n, batch_size, pad_multiple)
    out = torch.zeros((n_steps * bsz,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[:n] = arr
    return out.reshape((n_steps, bsz) + tuple(arr.shape[1:]))


def _stack_batches(codes: torch.Tensor, counts: torch.Tensor, batch_size,
                   pad_multiple: int = 1):
    """Stacked codes and counts [n_steps, B, ...] (zero-count rows add
    exactly 0 likelihood and gradient; B is ``batch_size`` rounded up to a
    multiple of ``pad_multiple``, the mesh's size) and each step's actual
    batch size, a host float array."""
    n = codes.shape[0]
    if n == 0:
        raise ValueError(
            "empty dataset: no k-mer rows to train/evaluate on (the ELBO "
            "scale num_kmers/batch would divide by zero)"
        )
    bsz, n_steps = _stack_geometry(n, batch_size, pad_multiple)
    sizes = np.minimum(np.full(n_steps, bsz), n - bsz * np.arange(n_steps))
    return (_stack_one(codes, batch_size, pad_multiple),
            _stack_one(counts, batch_size, pad_multiple),
            sizes.astype(np.float64))


def _to_device(codes, counts, dtype, dev):
    """(codes, counts) as tensors on ``dev``, counts in ``dtype``: device
    tensors (the counting engine's handoff) stay where they are."""
    codes = torch.as_tensor(codes).to(dev)
    counts = torch.as_tensor(counts).to(device=dev, dtype=dtype)
    return codes, counts


def _check_resume_consistent(applies_done: int) -> None:
    """Every process must resume from the same checkpoint: a directory
    local to each host, written only by process 0, would silently fork the
    ranks' trajectories (bear_tpu/models/bear_net.py:289-305)."""
    if multihost.process_count() == 1:
        return
    seen = multihost.allgather_i64([applies_done]).reshape(-1)
    if not np.all(seen == seen[0]):
        raise RuntimeError(
            f"checkpoint resume state differs across processes (applies_done per rank: "
            f"{seen.tolist()}); checkpoint_dir must be a path every process can read — use "
            "a shared filesystem or replicate the checkpoint to every host")


def _start(ar_func, params_restart, opt_state_restart, seed, dtype, dev,
           optimizer_name, learning_rate, checkpoint_dir):
    """(params, leaves, optimizer, applies_done) of a run: the mid-run state
    in ``checkpoint_dir`` when there is one, else ``params_restart`` /
    ``opt_state_restart``, else a fresh init seeded by ``seed``. With a
    checkpoint directory, every process must have found the same state."""
    applies_done = 0
    state = load_train_state(checkpoint_dir) if checkpoint_dir is not None else None
    if state is not None:
        params_restart = state["params"]
        opt_state_restart = state["torch_opt_state"]
        applies_done = int(state["applies_done"])
    if checkpoint_dir is not None:
        _check_resume_consistent(applies_done)
    if params_restart is None:
        init = init_params(torch.Generator().manual_seed(seed), ar_func)
        params_restart = [init["h_signed"]] + init["ar"]
    params = params_from_list(params_restart, device=dev, dtype=dtype)
    leaves = [params["h_signed"]] + params["ar"]
    for p in leaves:
        p.requires_grad_(True)
        # Every parameter holds a gradient from the start, so each apply
        # updates every optimizer state (as optax does, a zero gradient
        # included) and accumulation adds into zeros.
        p.grad = torch.zeros_like(p)
    optimizer = make_optimizer(optimizer_name, learning_rate, leaves)
    if opt_state_restart is not None:
        _load_optimizer_state(optimizer, opt_state_restart)
    return params, leaves, optimizer, applies_done


def _ar_probs(ar_func, codes_b, ar_params, ref_b):
    """The AR module's probabilities of a batch; the reference-guided
    module takes the batch's reference counts as its third input."""
    if ref_b is None:
        return ar_func.apply_codes(codes_b, ar_params)
    return ar_func.apply_codes(codes_b, ar_params, ref_b)


def _batch_loss(params, ar_func, train_ar, codes_b, counts_b, scale, ref_b=None):
    """-scale * the batch's summed log-likelihood (scale = num_kmers /
    actual batch size: the unbiased ELBO, reference bear_net.py:187-191)."""
    ar_probs = _ar_probs(ar_func, codes_b, params["ar"], ref_b)
    if train_ar:
        ll = ar_log_prob(counts_b, ar_probs)
    else:
        ll = bear_log_prob(counts_b, ar_probs, torch.exp(params["h_signed"]))
    return -scale * ll.sum()


def _on(params, dev):
    """The parameters on ``dev`` by a differentiable move (the same tensors
    where they already are), so an entry's gradient reaches the master."""
    return {"h_signed": params["h_signed"].to(dev), "ar": [p.to(dev) for p in params["ar"]]}


def _mesh_loss(split, params, ar_func, train_ar, codes_b, counts_b, scale, ref_b=None):
    """The batch's loss summed over this process's entries in mesh order,
    each entry on its slice of the rows with the parameters moved to it;
    ``scale`` is the whole global batch's."""
    return split.sum([
        _batch_loss(_on(params, d), ar_func, train_ar, c, n, scale, r)
        for (_, d), c, n, r in zip(split.entries, split.split(codes_b), split.split(counts_b),
                                   split.split(ref_b))])


def _grad_sync(split, leaves):
    """On a mesh that spans processes, the hook that sums the gradients and
    the loss of an apply over the gloo group, in one collective; None
    otherwise."""
    if not split.spans:
        return None

    def sync(loss_sum):
        *grads, loss = split.allreduce([p.grad for p in leaves] + [loss_sum.reshape(1)])
        for p, g in zip(leaves, grads):
            p.grad.copy_(g)
        return loss.reshape(())

    return sync


def _apply(optimizer, losses, sync=None):
    """One optimizer apply over a group of batch losses (zero-argument
    callables), gradients summed (and, with ``sync``, summed over the
    processes); returns the summed loss, on the device."""
    with span("bear.train.apply"):
        optimizer.zero_grad(set_to_none=False)
        loss_sum = 0.0
        for loss_of in losses:
            with span("bear.train.forward"):
                loss = loss_of()
            with span("bear.train.backward"):
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        if sync is not None:
            loss_sum = sync(loss_sum)
        optimizer.step()
        return loss_sum


def _save_state(checkpoint_dir, params, optimizer, applies_done):
    """Write the mid-run state; in a group of processes only process 0
    writes (the ranks hold the same state)."""
    if multihost.process_index() != 0:
        return
    save_train_state(checkpoint_dir, {
        "params": params_to_list(params),
        "torch_opt_state": optimizer_state(optimizer),
        "applies_done": int(applies_done),
    })


def _finish(leaves, params, optimizer, elbos, writer, start_apply, acc_steps,
            checkpoint_dir=None):
    """Release the parameters from autograd, report the ELBOs and wrap the
    run's result. In a group of processes with a checkpoint directory, no
    rank returns before process 0 has written the last state."""
    if checkpoint_dir is not None and multihost.process_count() > 1:
        torch.distributed.barrier()
    if writer is not None:
        for i, e in enumerate(elbos):
            writer.scalar("elbo", float(e), step=(start_apply + i + 1) * acc_steps)
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return TrainResult(params=params, losses=-elbos, opt_state=optimizer_state(optimizer))


def train(
    codes,
    counts,
    num_kmers,
    ar_func,
    *,
    alphabet: str = "dna",
    batch_size: int,
    epochs: int = 1,
    learning_rate: float = 0.01,
    optimizer_name: str = "Adam",
    train_ar: bool = False,
    acc_steps: int = 1,
    params_restart: Optional[list] = None,
    seed: int = 0,
    dtype=torch.float32,
    writer=None,
    opt_state_restart: Optional[dict] = None,
    shuffle: bool = False,
    device="cuda",
    mesh=None,
    ref_counts=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
) -> TrainResult:
    """Train a BEAR (empirical-Bayes h) or AR (max-likelihood) model.

    codes : [N, lag] int8 integer-coded k-mers (numpy or a tensor).
    counts : [N, alphabet_size+1] transition counts of the training column.
    num_kmers : total k-mer count for the unbiased ELBO scale
        (reference bear_net.py:190).
    train_ar : train the point AR likelihood instead of the BEAR marginal
        (reference bear_net.py:182-186).
    params_restart : a ``[h_signed] + ar`` list to start from; otherwise a
        fresh init from ``torch.Generator().manual_seed(seed)``.
    opt_state_restart : an ``optimizer_state`` dict of an earlier run.
    shuffle : permute the k-mer order once before batching, with
        ``np.random.default_rng(seed)`` (the same order as bear_tpu).
    writer : optional object with ``scalar(tag, value, step)``, given each
        apply's ELBO after training.
    device : where training runs; "cuda" (default) raises without a card.
    mesh : optional :class:`bear_tpu_torch.parallel.Mesh` for data
        parallelism (see the module's docstring); its devices decide where
        training runs. Every process of a spanning mesh passes the same
        whole dataset.
    ref_counts : optional [N, alphabet_size+1] prepared reference counts
        (``bear_ref.prepare_ref_counts``), for an AR module that takes them
        as its third input (``bear_ref.RefAR``).
    checkpoint_dir : resume from its ``train_state.pickle`` when there is
        one (the ELBOs returned are those of the applies run now); with
        ``checkpoint_every > 0`` also write that state every
        ``checkpoint_every`` applies and after the last. Each apply is a
        function of its index, so a resumed run ends on a bit-identical
        trajectory. Only process 0 writes.
    """
    with span("bear.train.call"):
        split = DataSplit(mesh, device)
        dev = split.master
        with span("bear.train.prepare"):
            params, leaves, optimizer, applies_done = _start(
                ar_func, params_restart, opt_state_restart, seed, dtype, dev, optimizer_name,
                learning_rate, checkpoint_dir)
            codes, counts = _to_device(codes, counts, dtype, dev)
            ref = _ref_to_device(ref_counts, dtype, dev)
            if shuffle:
                perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(codes)),
                                       device=dev)
                codes, counts, ref = codes[perm], counts[perm], _at(ref, perm)
            codes_s, counts_s, sizes = _stack_batches(codes, counts, batch_size, split.n)
            ref_s = None if ref is None else _stack_one(ref, batch_size, split.n)
        steps_per_epoch = codes_s.shape[0]
        total_steps = steps_per_epoch * int(epochs)
        acc_steps = int(acc_steps)
        n_apply = total_steps // acc_steps
        if n_apply == 0:
            raise ValueError("fewer total steps than acc_steps; nothing to train")
        scales = [float(num_kmers) / float(s) for s in sizes]
        every = int(checkpoint_every) if checkpoint_dir is not None else 0

        def loss_of(idx):
            return lambda: _mesh_loss(split, params, ar_func, train_ar, codes_s[idx],
                                      counts_s[idx], scales[idx], _at(ref_s, idx))

        sync = _grad_sync(split, leaves)
        start_apply = applies_done
        elbos = torch.empty(max(0, n_apply - start_apply), dtype=dtype, device=dev)
        for a in range(start_apply, n_apply):
            loss_sum = _apply(optimizer, [loss_of((a * acc_steps + k) % steps_per_epoch)
                                          for k in range(acc_steps)], sync)
            # ELBO estimate at each apply (reference bear_net.py:303-307).
            elbos[a - start_apply] = -loss_sum / acc_steps
            done = a + 1
            if every > 0 and ((done - start_apply) % every == 0 or done == n_apply):
                _save_state(checkpoint_dir, params, optimizer, done)
        with span("bear.train.finish"):
            return _finish(leaves, params, optimizer, elbos.cpu().numpy(), writer,
                           start_apply, acc_steps, checkpoint_dir if every > 0 else None)


def _shards_takes_epoch(shards) -> bool:
    """Whether a shards callable accepts an epoch argument (the hook for a
    per-epoch shard order)."""
    try:
        return len(inspect.signature(shards).parameters) >= 1
    except (TypeError, ValueError):
        return False


def _ref_to_device(ref, dtype, dev):
    """Reference counts as a ``dtype`` tensor on ``dev``, or None."""
    return None if ref is None else torch.as_tensor(ref).to(device=dev, dtype=dtype)


def _at(x, i):
    """x[i], or None where there is no tensor (no reference counts, no
    training column)."""
    return None if x is None else x[i]


class _RefAgreement:
    """Every shard of one stream carries reference counts, or none does."""

    def __init__(self):
        self.with_ref = None

    def split(self, shard):
        """(codes, counts, ref or None) of a two- or three-element shard."""
        ref = shard[2] if len(shard) > 2 else None
        if self.with_ref is None:
            self.with_ref = ref is not None
        elif self.with_ref != (ref is not None):
            raise ValueError("all shards must agree on carrying reference counts")
        return shard[0], shard[1], ref


def train_streaming(
    shards,
    num_kmers,
    ar_func,
    *,
    alphabet: str = "dna",
    batch_size: int,
    epochs: int = 1,
    learning_rate: float = 0.01,
    optimizer_name: str = "Adam",
    train_ar: bool = False,
    params_restart: Optional[list] = None,
    opt_state_restart: Optional[dict] = None,
    seed: int = 0,
    dtype=torch.float32,
    writer=None,
    block_steps: int = 64,
    mesh=None,
    acc_steps: int = 1,
    shuffle: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    device="cuda",
) -> TrainResult:
    """Shard-streamed training: host and device memory bounded by one shard
    (bear_tpu's ``train_streaming``, apply for apply).

    shards : callable returning an iterable of (codes [n, lag], counts
        [n, A+1]) pairs, or (codes, counts, prepared reference counts [n,
        A+1]) triples, numpy or tensors; called once per epoch, with the
        epoch number when it takes an argument (the hook for a per-epoch
        shard order). Each shard's last batch may be partial: batches never
        span shards, while accumulation groups of ``acc_steps`` batches do;
        a trailing partial group is dropped.
    num_kmers : the k-mer count over ALL shards (the ELBO scale).
    shuffle : permute the rows within each shard, epoch e at stream position
        p by ``np.random.default_rng([seed, e, p])``.
    block_steps : the unit of the checkpoint cadence: bear_tpu runs applies
        in jitted blocks of this many, and checkpoints every
        ceil(checkpoint_every / block_steps) blocks.
    checkpoint_dir : write ``train_state.pickle`` there every
        ``checkpoint_every`` applies (rounded up to whole blocks) and at the
        end, and resume from it: the stream is fast-forwarded past the
        applies already done (their shards are read, not computed on), so
        the run ends on a bit-identical trajectory.
    device : where training runs; "cuda" (default) raises without a card.
    mesh : as in :func:`train`: the batch rounds up to a mesh multiple and
        each batch's rows split over the entries; every process streams the
        same shards, only process 0 writes checkpoints.
    """
    with span("bear.train.call"):
        split = DataSplit(mesh, device)
        dev = split.master
        ck_blocks = max(1, -(-int(checkpoint_every) // int(block_steps)))
        with span("bear.train.prepare"):
            params, leaves, optimizer, applies_done = _start(
                ar_func, params_restart, opt_state_restart, seed, dtype, dev, optimizer_name,
                learning_rate, checkpoint_dir)
        acc_steps, K, bsz = int(acc_steps), int(block_steps), split.pad(batch_size)
        takes_epoch = _shards_takes_epoch(shards)
        agree = _RefAgreement()
        lag_w = None

        def batch_stream():
            """(codes, counts, scale, ref or None) of every batch, over epochs
            and shards."""
            nonlocal lag_w
            pos = 0  # position in the stream: the in-shard shuffle's seed index
            for epoch in range(int(epochs)):
                for shard in (shards(epoch) if takes_epoch else shards()):
                    codes, counts, ref = agree.split(shard)
                    with span("bear.train.prepare"):
                        codes, counts = _to_device(codes, counts, dtype, dev)
                        ref = _ref_to_device(ref, dtype, dev)
                        if shuffle:  # the permutation gathers on the device
                            rng = np.random.default_rng([seed, epoch, pos])
                            perm = torch.as_tensor(rng.permutation(len(codes)), device=dev)
                            codes, counts, ref = codes[perm], counts[perm], _at(ref, perm)
                        codes_s, counts_s, sizes = _stack_batches(codes, counts, bsz)
                        ref_s = None if ref is None else _stack_one(ref, bsz)
                    pos += 1
                    if lag_w is None:
                        lag_w = codes_s.shape[2]
                    elif codes_s.shape[2] != lag_w:
                        raise ValueError(f"shard lag {codes_s.shape[2]} != first shard's {lag_w}")
                    for t in range(codes_s.shape[0]):
                        yield (codes_s[t], counts_s[t], float(num_kmers) / float(sizes[t]),
                               _at(ref_s, t))

        def save():
            if checkpoint_dir is not None:
                _save_state(checkpoint_dir, params, optimizer, applies_done)

        sync = _grad_sync(split, leaves)
        start_apply = applies_done
        elbos = []
        applies_seen = 0  # groups taken from the stream, the skipped ones included
        n_in_block = blocks_done = 0
        pending = []
        for batch in batch_stream():
            pending.append(batch)
            if len(pending) < acc_steps:
                continue
            group, pending = pending, []
            applies_seen += 1
            if applies_seen <= applies_done:
                continue  # resume: applied before the interruption
            loss_sum = _apply(optimizer, [
                (lambda c=c, n=n, sc=sc, r=r: _mesh_loss(split, params, ar_func, train_ar, c, n,
                                                         sc, r))
                for c, n, sc, r in group], sync)
            elbos.append(-loss_sum / acc_steps)
            applies_done += 1
            n_in_block += 1
            if n_in_block == K:
                n_in_block, blocks_done = 0, blocks_done + 1
                if blocks_done % ck_blocks == 0:
                    save()
        if n_in_block:
            blocks_done += 1
            if blocks_done % ck_blocks == 0:
                save()
        if lag_w is None:
            raise ValueError("shards() yielded no shards")
        if applies_seen == 0:
            raise ValueError("fewer total batches than acc_steps; nothing to train")
        save()
        with span("bear.train.finish"):
            elbos = torch.stack(elbos) if elbos else torch.zeros(0, dtype=dtype)
            return _finish(leaves, params, optimizer, elbos.cpu().numpy(), writer, start_apply,
                           acc_steps, checkpoint_dir)


# --- evaluation -----------------------------------------------------------


def _tie_noise(generator, h_shape, B: int, A1: int, V: int, use_train: bool, dev):
    """The Gumbel noise that breaks exact ties of a batch's three readings,
    drawn in their order from ``generator``: BEAR [*h_shape, B, A1], AR [B,
    A1], BMM [B, V, A1] (or [V, A1] without training counts, where the BMM
    reading does not depend on the row)."""
    return (gumbel_noise(tuple(h_shape) + (B, A1), generator, dev),
            gumbel_noise((B, A1), generator, dev),
            gumbel_noise((B, V, A1) if use_train else (V, A1), generator, dev))


def _evaluation_step(counts_test, ar_probs, h, van_reg, noise, counts_train=None):
    """Per-batch metrics of the three readings — BEAR posterior predictive,
    point AR, and vanilla BMM over a vector of priors (reference
    bear_net.py:323-371). ``h`` is a scalar or a vector [H] (h_scan);
    ``noise`` the readings' tie-break noise (:func:`_tie_noise`).

    Returns sums: (ll_ear, ll_arm, ll_van[V], correct_ear, correct_arm,
    correct_van[V], total_len).
    """
    dtype = counts_test.dtype
    A1 = counts_test.shape[-1]
    h_b = h.reshape(tuple(h.shape) + (1, 1))  # broadcast against [B, A1]

    if counts_train is not None:
        van_condition = counts_train[:, None, :] + van_reg[:, None]
    else:
        van_condition = van_reg[:, None] * torch.ones((1, A1), dtype=dtype,
                                                      device=counts_test.device)

    conc_ear = ar_probs / h_b + EPSILON
    if counts_train is not None:
        conc_ear = conc_ear + counts_train
    ll_ear = dirichlet_multinomial_perm_logpmf(counts_test, conc_ear).sum(dim=-1)

    probs_arm = ar_probs + EPSILON
    ll_arm = multinomial_perm_logpmf(counts_test, probs_arm).sum()

    conc_van = van_condition + EPSILON
    ll_van = dirichlet_multinomial_perm_logpmf(counts_test[:, None, :], conc_van).sum(dim=0)

    rng_idx = torch.arange(A1, dtype=dtype, device=counts_test.device)
    g_ear, g_arm, g_van = noise
    oh_ear = (ml_output(conc_ear, gumbel=g_ear)[..., None] == rng_idx).to(dtype)
    oh_arm = (ml_output(probs_arm, gumbel=g_arm)[..., None] == rng_idx).to(dtype)
    oh_van = (ml_output(conc_van, gumbel=g_van)[..., None] == rng_idx).to(dtype)

    correct_ear = (counts_test * oh_ear).sum(dim=-1).sum(dim=-1)
    correct_arm = (counts_test * oh_arm).sum()
    correct_van = (counts_test[:, None, :] * oh_van).sum(dim=0).sum(dim=-1)
    total_len = counts_test.sum()
    return ll_ear, ll_arm, ll_van, correct_ear, correct_arm, correct_van, total_len


class _Evaluator:
    """The per-batch metrics of one evaluation, in float64 whatever the
    compute type; the tie-break generator is reseeded from (seed, global
    batch index) before each batch. On a mesh each entry computes its
    slice of the batch's rows (with its slice of the batch's tie-break
    noise) and the metrics are summed over the entries in mesh order."""

    def __init__(self, ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                 seed, split):
        self.loc_train, self.loc_test = ds_loc_train, ds_loc_test
        self.use_train = ds_loc_train >= 0
        self.ar_func, self.dtype, self.seed, self.split = ar_func, dtype, seed, split
        self.dev = dev = split.master
        van_reg = torch.as_tensor(np.asarray(van_reg), dtype=dtype, device=dev)
        h = torch.as_tensor(np.asarray(h), dtype=dtype, device=dev)
        ar_params = [_tensor(p, dev, dtype) for p in ar_params]
        self.h_shape, self.n_van = tuple(h.shape), van_reg.shape[0]
        # (h, van_reg, AR parameters) on each entry's device
        self.on = {d: (h.to(d), van_reg.to(d), [p.to(d) for p in ar_params])
                   for _, d in split.entries}
        self.generator = torch.Generator(device=dev)

    def stacks(self, codes, counts, batch_size, ref=None):
        """(codes, test counts, train counts or None, reference counts or
        None) stacked to [steps, B, ...] on the device, B a multiple of the
        mesh's size."""
        n = self.split.n
        codes, counts = _to_device(codes, counts, self.dtype, self.dev)
        codes_s, test_s, _ = _stack_batches(codes, counts[:, self.loc_test, :], batch_size, n)
        train_s = (_stack_one(counts[:, self.loc_train, :], batch_size, n)
                   if self.use_train else None)
        ref = _ref_to_device(ref, self.dtype, self.dev)
        ref_s = None if ref is None else _stack_one(ref, batch_size, n)
        return codes_s, test_s, train_s, ref_s

    def batch(self, codes_b, test_b, train_b, step, ref_b=None):
        state = np.random.SeedSequence([self.seed, step]).generate_state(2, np.uint32)
        self.generator.manual_seed((int(state[0]) << 31) | (int(state[1]) >> 1))
        split = self.split
        g_ear, g_arm, g_van = _tie_noise(self.generator, self.h_shape, test_b.shape[0],
                                         test_b.shape[-1], self.n_van, self.use_train, self.dev)
        van_noise = (split.split(g_van) if self.use_train
                     else [g_van.to(d) for _, d in split.entries])
        outs = []
        for (_, d), c, t, tr, r, ge, ga, gv in zip(
                split.entries, split.split(codes_b), split.split(test_b), split.split(train_b),
                split.split(ref_b), split.split(g_ear, len(self.h_shape)), split.split(g_arm),
                van_noise):
            h, van_reg, ar_params = self.on[d]
            ar_probs = _ar_probs(self.ar_func, c, ar_params, r)
            out = _evaluation_step(t, ar_probs, h, van_reg, (ge, ga, gv), counts_train=tr)
            outs.append([o.to(torch.float64) for o in out])
        return [split.sum(list(parts)) for parts in zip(*outs)]


def _metrics(ll_ear, ll_arm, ll_van, c_ear, c_arm, c_van, total, exp):
    """The reference's 9-tuple from the summed metrics."""
    return (ll_ear, ll_arm, ll_van, exp(-ll_ear / total), exp(-ll_arm / total),
            exp(-ll_van / total), c_ear / total, c_arm / total, c_van / total)


@torch.no_grad()
def evaluation(
    codes,
    counts,
    ds_loc_train,
    ds_loc_test,
    alphabet,
    h,
    ar_func,
    ar_params,
    van_reg,
    *,
    batch_size: int = 1 << 14,
    dtype=torch.float32,
    seed: int = 0,
    device="cuda",
    mesh=None,
    ref_counts=None,
):
    """Evaluate a trained BEAR/AR/BMM model (reference bear_net.py:387-463).

    ds_loc_train = -1 disables conditioning on training counts (prior mode).
    mesh : as in :func:`train`; each entry computes its rows' readings, the
    float64 sums are added over the entries, then over the processes.

    Returns the reference's 9-tuple of numpy values:
    (ll_ear, ll_arm, ll_van, perp_ear, perp_arm, perp_van,
     acc_ear, acc_arm, acc_van), van entries vectors over van_reg.

    Each batch is computed in ``dtype``; the sums across batches are
    float64 tensors on the device, copied to the host once at the end.
    Exact ties of the most likely transition are broken with a
    ``torch.Generator`` on the device seeded from (``seed``, batch index)
    (the draws differ from bear_tpu's, so tied rows may count differently).
    ``ref_counts``: prepared reference counts [N, A+1] for a
    reference-guided AR module, as in :func:`train`.
    """
    split = DataSplit(mesh, device)
    ev = _Evaluator(ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                    seed, split)
    codes_s, test_s, train_s, ref_s = ev.stacks(codes, counts, batch_size, ref_counts)
    sums = None
    for step in range(codes_s.shape[0]):
        out = ev.batch(codes_s[step], test_s[step], _at(train_s, step), step,
                       _at(ref_s, step))
        sums = out if sums is None else [s + o for s, o in zip(sums, out)]
    sums = split.allreduce(sums)
    return tuple(m.cpu().numpy() for m in _metrics(*sums, exp=torch.exp))


@torch.no_grad()
def evaluation_streaming(
    shards,
    ds_loc_train,
    ds_loc_test,
    alphabet,
    h,
    ar_func,
    ar_params,
    van_reg,
    *,
    batch_size: int = 1 << 14,
    dtype=torch.float32,
    seed: int = 0,
    block_steps: int = 32,
    device="cuda",
    mesh=None,
):
    """Shard-streamed evaluation, memory bounded by one shard (bear_tpu's
    ``evaluation_streaming``): the same contract and 9-tuple as
    :func:`evaluation`. ``shards`` is a callable returning an iterable of
    (codes, counts [n, num_ds, A+1]) pairs, or triples whose third element
    is the shard's prepared reference counts, consumed once. Batches never
    span shards; the tie-break draws are keyed by the global batch index.
    The metrics of each block of ``block_steps`` batches are summed in
    float64 on the device, and the blocks in float64 on the host. ``mesh``
    as in :func:`evaluation`."""
    split = DataSplit(mesh, device)
    ev = _Evaluator(ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                    seed, split)
    K = int(block_steps)
    agree = _RefAgreement()
    totals = None
    lag_w = None
    step = 0
    for shard in shards():
        codes, counts, ref = agree.split(shard)
        codes_s, test_s, train_s, ref_s = ev.stacks(codes, counts, batch_size, ref)
        if lag_w is None:
            lag_w = codes_s.shape[2]
        elif codes_s.shape[2] != lag_w:
            raise ValueError(f"shard lag {codes_s.shape[2]} != first shard's {lag_w}")
        steps = codes_s.shape[0]
        for s0 in range(0, steps, K):
            block = None
            for t in range(s0, min(s0 + K, steps)):
                out = ev.batch(codes_s[t], test_s[t], _at(train_s, t), step + t,
                               _at(ref_s, t))
                block = out if block is None else [b + o for b, o in zip(block, out)]
            block = [b.cpu().numpy() for b in block]
            totals = block if totals is None else [a + b for a, b in zip(totals, block)]
        step += steps
    if totals is None:
        raise ValueError("shards() yielded no shards")
    if split.spans:
        totals = [t.numpy() for t in split.allreduce([torch.from_numpy(np.asarray(t))
                                                       for t in totals])]
    return _metrics(*totals, exp=np.exp)


def h_scan(codes, counts, ds_loc_train, ds_loc_test, alphabet, h_values,
           ar_func, ar_params, **kwargs):
    """Evaluate BEAR at a vector of h at once (reference
    bear_net.py:465-531). Returns (ll_ear[H], perp_ear[H], acc_ear[H])."""
    out = evaluation(codes, counts, ds_loc_train, ds_loc_test, alphabet,
                     np.asarray(h_values), ar_func, ar_params, van_reg=np.ones(1),
                     **kwargs)
    ll_ear, _, _, perp_ear, _, _, acc_ear, _, _ = out
    return ll_ear, perp_ear, acc_ear


def h_scan_streaming(shards, ds_loc_train, ds_loc_test, alphabet, h_values,
                     ar_func, ar_params, **kwargs):
    """Shard-streamed :func:`h_scan` (reference bear_net.py:1291-1319);
    ``shards`` as in :func:`evaluation_streaming`."""
    out = evaluation_streaming(shards, ds_loc_train, ds_loc_test, alphabet,
                               np.asarray(h_values), ar_func, ar_params,
                               van_reg=np.ones(1), **kwargs)
    ll_ear, _, _, perp_ear, _, _, acc_ear, _, _ = out
    return ll_ear, perp_ear, acc_ear
