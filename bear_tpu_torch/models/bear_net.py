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

The step loop never waits for the device: ELBOs stay on the device until
the run ends (or a checkpoint is written). Not ported yet: ``mesh`` and
optimizers other than Adam and SGD (ROADMAP.md).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from bear_tpu_torch.ops.distributions import (
    EPSILON,
    dirichlet_multinomial_perm_logpmf,
    ml_output,
    multinomial_perm_logpmf,
)
from bear_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from bear_tpu_torch.utils.device import resolve_device


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


_OPTIMIZERS_NOT_PORTED = ("adamw", "adamax", "rmsprop", "adagrad", "nadam",
                          "adadelta", "lion")


def make_optimizer(optimizer_name: str, learning_rate: float, params):
    """Optimizer by (Keras-style) name over ``params``: Adam with eps=1e-7
    (tf.keras's default, as bear_tpu's optax Adam) or plain SGD."""
    name = optimizer_name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, eps=1e-7)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name in _OPTIMIZERS_NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {optimizer_name!r} is not ported yet (Adam and SGD "
            "are); see ROADMAP.md Queue 1"
        )
    raise ValueError(f"unknown optimizer {optimizer_name!r}")


def optimizer_state(opt) -> dict:
    """The port's optimizer state as plain numpy (picklable without torch
    or optax): ``{"name", "step", "exp_avg", "exp_avg_sq"}`` for Adam,
    ``{"name"}`` for SGD, moments in checkpoint order."""
    params = opt.param_groups[0]["params"]
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


def _stack_geometry(n: int, batch_size):
    """(batch size, step count) shared by every stacked array."""
    bsz = int(batch_size)
    return bsz, max(1, -(-n // bsz))


def _stack_one(arr: torch.Tensor, batch_size) -> torch.Tensor:
    """Zero-pad ONE tensor's rows and stack it to [n_steps, B, ...] on its
    own device (the single home of the batch geometry)."""
    n = arr.shape[0]
    bsz, n_steps = _stack_geometry(n, batch_size)
    out = torch.zeros((n_steps * bsz,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[:n] = arr
    return out.reshape((n_steps, bsz) + tuple(arr.shape[1:]))


def _stack_batches(codes: torch.Tensor, counts: torch.Tensor, batch_size):
    """Stacked codes and counts [n_steps, B, ...] (zero-count rows add
    exactly 0 likelihood and gradient) and each step's actual batch size,
    a host float array."""
    n = codes.shape[0]
    if n == 0:
        raise ValueError(
            "empty dataset: no k-mer rows to train/evaluate on (the ELBO "
            "scale num_kmers/batch would divide by zero)"
        )
    bsz, n_steps = _stack_geometry(n, batch_size)
    sizes = np.minimum(np.full(n_steps, bsz), n - bsz * np.arange(n_steps))
    return (_stack_one(codes, batch_size),
            _stack_one(counts, batch_size),
            sizes.astype(np.float64))


def _to_device(codes, counts, dtype, dev):
    """(codes, counts) as tensors on ``dev``, counts in ``dtype``: device
    tensors (the counting engine's handoff) stay where they are."""
    codes = torch.as_tensor(codes).to(dev)
    counts = torch.as_tensor(counts).to(device=dev, dtype=dtype)
    return codes, counts


def _not_ported(**args):
    for name, value in args.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported to PyTorch yet; see ROADMAP.md Queue 1"
            )


def _start(ar_func, params_restart, opt_state_restart, seed, dtype, dev,
           optimizer_name, learning_rate, checkpoint_dir):
    """(params, leaves, optimizer, applies_done) of a run: the mid-run state
    in ``checkpoint_dir`` when there is one, else ``params_restart`` /
    ``opt_state_restart``, else a fresh init seeded by ``seed``."""
    applies_done = 0
    state = load_train_state(checkpoint_dir) if checkpoint_dir is not None else None
    if state is not None:
        params_restart = state["params"]
        opt_state_restart = state["torch_opt_state"]
        applies_done = int(state["applies_done"])
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


def _apply(optimizer, losses):
    """One optimizer apply over a group of batch losses (zero-argument
    callables), gradients summed; returns the summed loss, on the device."""
    optimizer.zero_grad(set_to_none=False)
    loss_sum = 0.0
    for loss_of in losses:
        loss = loss_of()
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    optimizer.step()
    return loss_sum


def _save_state(checkpoint_dir, params, optimizer, applies_done):
    save_train_state(checkpoint_dir, {
        "params": params_to_list(params),
        "torch_opt_state": optimizer_state(optimizer),
        "applies_done": int(applies_done),
    })


def _finish(leaves, params, optimizer, elbos, writer, start_apply, acc_steps):
    """Release the parameters from autograd, report the ELBOs and wrap the
    run's result."""
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
    ref_counts : optional [N, alphabet_size+1] prepared reference counts
        (``bear_ref.prepare_ref_counts``), for an AR module that takes them
        as its third input (``bear_ref.RefAR``).
    checkpoint_dir : resume from its ``train_state.pickle`` when there is
        one (the ELBOs returned are those of the applies run now); with
        ``checkpoint_every > 0`` also write that state every
        ``checkpoint_every`` applies and after the last. Each apply is a
        function of its index, so a resumed run ends on a bit-identical
        trajectory.
    """
    _not_ported(mesh=mesh)
    dev = resolve_device(device)
    params, leaves, optimizer, applies_done = _start(
        ar_func, params_restart, opt_state_restart, seed, dtype, dev, optimizer_name,
        learning_rate, checkpoint_dir)

    codes, counts = _to_device(codes, counts, dtype, dev)
    ref = _ref_to_device(ref_counts, dtype, dev)
    if shuffle:
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(codes)),
                               device=dev)
        codes, counts, ref = codes[perm], counts[perm], _at(ref, perm)
    codes_s, counts_s, sizes = _stack_batches(codes, counts, batch_size)
    ref_s = None if ref is None else _stack_one(ref, batch_size)
    steps_per_epoch = codes_s.shape[0]
    total_steps = steps_per_epoch * int(epochs)
    acc_steps = int(acc_steps)
    n_apply = total_steps // acc_steps
    if n_apply == 0:
        raise ValueError("fewer total steps than acc_steps; nothing to train")
    scales = [float(num_kmers) / float(s) for s in sizes]
    every = int(checkpoint_every) if checkpoint_dir is not None else 0

    def loss_of(idx):
        return lambda: _batch_loss(params, ar_func, train_ar, codes_s[idx], counts_s[idx],
                                   scales[idx], _at(ref_s, idx))

    start_apply = applies_done
    elbos = torch.empty(max(0, n_apply - start_apply), dtype=dtype, device=dev)
    for a in range(start_apply, n_apply):
        loss_sum = _apply(optimizer, [loss_of((a * acc_steps + k) % steps_per_epoch)
                                      for k in range(acc_steps)])
        # ELBO estimate at each apply (reference bear_net.py:303-307).
        elbos[a - start_apply] = -loss_sum / acc_steps
        done = a + 1
        if every > 0 and ((done - start_apply) % every == 0 or done == n_apply):
            _save_state(checkpoint_dir, params, optimizer, done)
    return _finish(leaves, params, optimizer, elbos.cpu().numpy(), writer, start_apply,
                   acc_steps)


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
    """
    _not_ported(mesh=mesh)
    dev = resolve_device(device)
    ck_blocks = max(1, -(-int(checkpoint_every) // int(block_steps)))
    params, leaves, optimizer, applies_done = _start(
        ar_func, params_restart, opt_state_restart, seed, dtype, dev, optimizer_name,
        learning_rate, checkpoint_dir)
    acc_steps, K, bsz = int(acc_steps), int(block_steps), int(batch_size)
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
                codes, counts = _to_device(codes, counts, dtype, dev)
                ref = _ref_to_device(ref, dtype, dev)
                if shuffle:  # the permutation gathers on the device
                    perm = np.random.default_rng([seed, epoch, pos]).permutation(len(codes))
                    perm = torch.as_tensor(perm, device=dev)
                    codes, counts, ref = codes[perm], counts[perm], _at(ref, perm)
                pos += 1
                codes_s, counts_s, sizes = _stack_batches(codes, counts, bsz)
                ref_s = None if ref is None else _stack_one(ref, bsz)
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
            (lambda c=c, n=n, sc=sc, r=r: _batch_loss(params, ar_func, train_ar, c, n, sc, r))
            for c, n, sc, r in group])
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
    elbos = torch.stack(elbos) if elbos else torch.zeros(0, dtype=dtype)
    elbos = elbos.cpu().numpy()
    return _finish(leaves, params, optimizer, elbos, writer, start_apply, acc_steps)


# --- evaluation -----------------------------------------------------------


def _evaluation_step(counts_test, ar_probs, h, van_reg, generator,
                     counts_train=None):
    """Per-batch metrics of the three readings — BEAR posterior predictive,
    point AR, and vanilla BMM over a vector of priors (reference
    bear_net.py:323-371). ``h`` is a scalar or a vector [H] (h_scan).

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
    oh_ear = (ml_output(conc_ear, generator)[..., None] == rng_idx).to(dtype)
    oh_arm = (ml_output(probs_arm, generator)[..., None] == rng_idx).to(dtype)
    oh_van = (ml_output(conc_van, generator)[..., None] == rng_idx).to(dtype)

    correct_ear = (counts_test * oh_ear).sum(dim=-1).sum(dim=-1)
    correct_arm = (counts_test * oh_arm).sum()
    correct_van = (counts_test[:, None, :] * oh_van).sum(dim=0).sum(dim=-1)
    total_len = counts_test.sum()
    return ll_ear, ll_arm, ll_van, correct_ear, correct_arm, correct_van, total_len


class _Evaluator:
    """The per-batch metrics of one evaluation, in float64 whatever the
    compute type; the tie-break generator is reseeded from (seed, global
    batch index) before each batch."""

    def __init__(self, ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                 seed, dev):
        self.loc_train, self.loc_test = ds_loc_train, ds_loc_test
        self.use_train = ds_loc_train >= 0
        self.ar_func, self.dtype, self.seed, self.dev = ar_func, dtype, seed, dev
        self.van_reg = torch.as_tensor(np.asarray(van_reg), dtype=dtype, device=dev)
        self.h = torch.as_tensor(np.asarray(h), dtype=dtype, device=dev)
        self.ar_params = [_tensor(p, dev, dtype) for p in ar_params]
        self.generator = torch.Generator(device=dev)

    def stacks(self, codes, counts, batch_size, ref=None):
        """(codes, test counts, train counts or None, reference counts or
        None) stacked to [steps, B, ...] on the device."""
        codes, counts = _to_device(codes, counts, self.dtype, self.dev)
        codes_s, test_s, _ = _stack_batches(codes, counts[:, self.loc_test, :], batch_size)
        train_s = (_stack_one(counts[:, self.loc_train, :], batch_size)
                   if self.use_train else None)
        ref = _ref_to_device(ref, self.dtype, self.dev)
        ref_s = None if ref is None else _stack_one(ref, batch_size)
        return codes_s, test_s, train_s, ref_s

    def batch(self, codes_b, test_b, train_b, step, ref_b=None):
        state = np.random.SeedSequence([self.seed, step]).generate_state(2, np.uint32)
        self.generator.manual_seed((int(state[0]) << 31) | (int(state[1]) >> 1))
        ar_probs = _ar_probs(self.ar_func, codes_b, self.ar_params, ref_b)
        out = _evaluation_step(test_b, ar_probs, self.h, self.van_reg, self.generator,
                               counts_train=train_b)
        return [o.to(torch.float64) for o in out]


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
    _not_ported(mesh=mesh)
    dev = resolve_device(device)
    ev = _Evaluator(ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                    seed, dev)
    codes_s, test_s, train_s, ref_s = ev.stacks(codes, counts, batch_size, ref_counts)
    sums = None
    for step in range(codes_s.shape[0]):
        out = ev.batch(codes_s[step], test_s[step], _at(train_s, step), step,
                       _at(ref_s, step))
        sums = out if sums is None else [s + o for s, o in zip(sums, out)]
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
    float64 on the device, and the blocks in float64 on the host."""
    _not_ported(mesh=mesh)
    dev = resolve_device(device)
    ev = _Evaluator(ds_loc_train, ds_loc_test, h, ar_func, ar_params, van_reg, dtype,
                    seed, dev)
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
