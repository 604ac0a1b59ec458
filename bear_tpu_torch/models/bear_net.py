"""BEAR / AR training, evaluation and h-scan (port of
bear_tpu/models/bear_net.py, in-memory paths).

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
  compute type.

The step loop never waits for the device: ELBOs are written into a device
tensor and copied to the host once, after the last apply. Not ported yet:
``mesh``, ``ref_counts``, ``checkpoint_dir`` (mid-run train state), the
streaming variants and optimizers other than Adam and SGD (ROADMAP.md).
"""

from __future__ import annotations

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
    """
    _not_ported(mesh=mesh, ref_counts=ref_counts, checkpoint_dir=checkpoint_dir)
    dev = resolve_device(device)
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

    codes, counts = _to_device(codes, counts, dtype, dev)
    if shuffle:
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(codes)),
                               device=dev)
        codes, counts = codes[perm], counts[perm]
    codes_s, counts_s, sizes = _stack_batches(codes, counts, batch_size)
    steps_per_epoch = codes_s.shape[0]
    total_steps = steps_per_epoch * int(epochs)
    acc_steps = int(acc_steps)
    n_apply = total_steps // acc_steps
    if n_apply == 0:
        raise ValueError("fewer total steps than acc_steps; nothing to train")
    scales = [float(num_kmers) / float(s) for s in sizes]

    def loss_of(idx):
        ar_probs = ar_func.apply_codes(codes_s[idx], params["ar"])
        if train_ar:
            ll = ar_log_prob(counts_s[idx], ar_probs)
        else:
            ll = bear_log_prob(counts_s[idx], ar_probs, torch.exp(params["h_signed"]))
        return -scales[idx] * ll.sum()

    elbos = torch.empty(n_apply, dtype=dtype, device=dev)
    for a in range(n_apply):
        optimizer.zero_grad(set_to_none=False)
        loss_sum = 0.0
        for k in range(acc_steps):
            loss = loss_of((a * acc_steps + k) % steps_per_epoch)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        optimizer.step()
        # ELBO estimate at each apply (reference bear_net.py:303-307).
        elbos[a] = -loss_sum / acc_steps
    elbos = elbos.cpu().numpy()
    if writer is not None:
        for i, e in enumerate(elbos):
            writer.scalar("elbo", float(e), step=(i + 1) * acc_steps)
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return TrainResult(params=params, losses=-elbos, opt_state=optimizer_state(optimizer))


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
    ``torch.Generator`` on the device seeded by ``seed`` (the draws differ
    from bear_tpu's, so tied rows may count differently).
    """
    _not_ported(mesh=mesh, ref_counts=ref_counts)
    dev = resolve_device(device)
    use_train = ds_loc_train >= 0
    codes, counts = _to_device(codes, counts, dtype, dev)
    counts_test = counts[:, ds_loc_test, :]
    codes_s, test_s, _ = _stack_batches(codes, counts_test, batch_size)
    train_s = _stack_one(counts[:, ds_loc_train, :], batch_size) if use_train else None
    van_reg = torch.as_tensor(np.asarray(van_reg), dtype=dtype, device=dev)
    h_arr = torch.as_tensor(np.asarray(h), dtype=dtype, device=dev)
    ar_params = [_tensor(p, dev, dtype) for p in ar_params]
    generator = torch.Generator(device=dev).manual_seed(seed)

    sums = None
    for step in range(codes_s.shape[0]):
        ar_probs = ar_func.apply_codes(codes_s[step], ar_params)
        out = _evaluation_step(test_s[step], ar_probs, h_arr, van_reg, generator,
                               counts_train=train_s[step] if use_train else None)
        out = [o.to(torch.float64) for o in out]
        sums = out if sums is None else [s + o for s, o in zip(sums, out)]
    ll_ear, ll_arm, ll_van, c_ear, c_arm, c_van, total = sums
    metrics = (ll_ear, ll_arm, ll_van,
               torch.exp(-ll_ear / total), torch.exp(-ll_arm / total),
               torch.exp(-ll_van / total),
               c_ear / total, c_arm / total, c_van / total)
    return tuple(m.cpu().numpy() for m in metrics)


def h_scan(codes, counts, ds_loc_train, ds_loc_test, alphabet, h_values,
           ar_func, ar_params, **kwargs):
    """Evaluate BEAR at a vector of h at once (reference
    bear_net.py:465-531). Returns (ll_ear[H], perp_ear[H], acc_ear[H])."""
    out = evaluation(codes, counts, ds_loc_train, ds_loc_test, alphabet,
                     np.asarray(h_values), ar_func, ar_params, van_reg=np.ones(1),
                     **kwargs)
    ll_ear, _, _, perp_ear, _, _, acc_ear, _, _ = out
    return ll_ear, perp_ear, acc_ear
