"""Plain BEAR models: the embedded AR functions, the Dirichlet-multinomial
likelihood and Adam, in plain PyTorch (the model of Amin, Weinstein and
Marks, NeurIPS 2021, as the reference repository's ar_funcs.py and
bear_net.py define it).

Parameters are lists in checkpoint order: ``[h_signed] + ar``, h =
exp(h_signed).

- linear AR: ``[mat [lag, A1, A1]]``, probabilities softmax(sum_j
  mat[j, code_j]).
- CNN AR: ``[filters [fw, A1, nf], intercept0 [conv_len, nf], weights1
  [conv_len, nf, w1], intercept1 [w1], weights2 [w1, A1], intercept2 [A1],
  scale0 [conv_len, nf], scale1 [w1]]``: a VALID convolution over the lag
  axis of the one-hot context, a scale-free layer normalisation (population
  variance, 1e-5) with scale and intercept and an elu, a dense layer over
  all conv outputs, normalised likewise, and a dense softmax head.

The caller decides the float type and whether matrix products may use
TF32 (:func:`matmul_precision`).
"""

from __future__ import annotations

import contextlib

import torch

EPSILON = 1e-7  # added to the AR probabilities in the BEAR concentrations
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-7


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matrix products and convolutions in full float32 (False) or TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def one_hot(codes: torch.Tensor, A1: int, dtype) -> torch.Tensor:
    """[..., lag] codes -> [..., lag, A1]."""
    return torch.nn.functional.one_hot(codes.to(torch.int64), A1).to(dtype)


def _layer_norm(x):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0)))


def cnn_probs(oh: torch.Tensor, ar) -> torch.Tensor:
    """One-hot contexts [N, lag, A1] -> probabilities [N, A1]."""
    filters, intercept0, weights1, intercept1, weights2, intercept2, scale0, scale1 = ar
    fw = filters.shape[0]
    conv_len = oh.shape[1] - fw + 1
    conv = sum(torch.matmul(oh[:, w:w + conv_len, :], filters[w]) for w in range(fw))
    nn0 = scale0 * _layer_norm(conv) + intercept0
    hidden = torch.matmul(_elu(nn0).reshape(oh.shape[0], -1),
                          weights1.reshape(-1, weights1.shape[-1]))
    nn1 = scale1 * _layer_norm(hidden) + intercept1
    return torch.softmax(torch.matmul(_elu(nn1), weights2) + intercept2, dim=-1)


def linear_probs(oh: torch.Tensor, ar) -> torch.Tensor:
    (mat,) = ar
    logits = torch.matmul(oh.reshape(oh.shape[0], -1), mat.reshape(-1, mat.shape[-1]))
    return torch.softmax(logits, dim=-1)


AR_PROBS = {"cnn": cnn_probs, "linear": linear_probs}


def dm_loglik(counts, conc):
    """Ordered Dirichlet-multinomial log-likelihood per row."""
    per = (torch.lgamma(conc + counts) - torch.lgamma(conc)).sum(dim=-1)
    tot_c, tot_n = conc.sum(dim=-1), counts.sum(dim=-1)
    return per - (torch.lgamma(tot_c + tot_n) - torch.lgamma(tot_c))


def bear_loss(params, ar_name, codes, counts, num_kmers):
    """-(num_kmers / rows) * the batch's summed BEAR log-likelihood."""
    h_signed, ar = params[0], params[1:]
    oh = one_hot(codes, counts.shape[-1], h_signed.dtype)
    probs = AR_PROBS[ar_name](oh, ar)
    ll = dm_loglik(counts, probs / torch.exp(h_signed) + EPSILON)
    return -(num_kmers / codes.shape[0]) * ll.sum()


def train_steps(params0, ar_name, batches, num_kmers, lr, dtype, marks=None):
    """Adam (bias-corrected, eps 1e-7) from ``params0`` over ``batches``, a
    list of (codes, counts): each step's loss, the first step's gradient
    and, for each step that ``marks`` counts (the last where it is None),
    the parameters after it, all in ``dtype``."""
    params = [p.detach().to(dtype).clone().requires_grad_(True) for p in params0]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = ADAM_BETAS
    marks = [len(batches)] if marks is None else list(marks)
    losses, first_grad, kept = [], None, []
    for t, (codes, counts) in enumerate(batches, start=1):
        loss = bear_loss(params, ar_name, codes, counts.to(dtype), num_kmers)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi / (1 - b2 ** t)).sqrt() + ADAM_EPS
                p.sub_(lr / (1 - b1 ** t) * mi / denom)
        if t in marks:
            kept.append([p.detach().clone() for p in params])
    return losses, first_grad, kept
