"""Loop-free log-gamma sampling, stable for tiny concentrations (port of
bear_tpu/ops/loggamma.py, as PyTorch ops over the keyed generator of
:mod:`bear_tpu_torch.ops.keyed_random`).

Two ideas compose:

1. the boost identity

    G ~ Gamma(c+1), U ~ Uniform(0,1)  =>  G * U^{1/c} ~ Gamma(c)
    log Gamma(c)  =d=  log G + log(U) / c

   exact for every c > 0: ``log G`` never underflows (c+1 >= 1) and
   ``log(U)/c`` stays in log space, where a plain ``log(gamma(c))``
   underflows to -inf for c ~ 1e-4; and

2. fixed-proposal Marsaglia-Tsang for the boosted Gamma(c+1): with shape
   >= 1 each proposal accepts with probability >= 0.95, so ``n_iter``
   proposals computed in one vectorised pass (first acceptance selected
   with a survival mask) replace a rejection loop. The 0.05^n_iter
   residual falls back to the clamped last proposal cube (the
   Wilson-Hilferty approximation, the proposal distribution itself).

The layouts are torch's plain ones: the proposal axis first, the caller's
shape after it.
"""

from __future__ import annotations

import torch

from bear_tpu_torch.ops import keyed_random as kr


def _mt_boosted_log_gamma_t(x, neg_log_u, safe_conc_t):
    """Marsaglia-Tsang core: log Gamma(safe_conc + 1) draws from pre-drawn
    standard normals ``x`` and exponentials ``neg_log_u``, both [F, ...]
    with the proposal axis first (``...`` broadcasts with safe_conc_t).
    The first accepted proposal is selected with a cumprod survival mask;
    a lane that accepts none takes the clamped last proposal cube."""
    d = safe_conc_t + (1.0 - 1.0 / 3.0)
    cc = 1.0 / torch.sqrt(9.0 * d)
    t = 1.0 + cc * x
    v = t * t * t
    pos = v > 0
    vs = torch.where(pos, v, torch.ones((), dtype=v.dtype, device=v.device))
    ok = (pos & (-neg_log_u < 0.5 * x * x + d - d * vs + d * torch.log(vs))).to(x.dtype)
    not_prior = torch.cumprod(1.0 - ok, dim=0)
    prior_none = torch.cat([torch.ones_like(not_prior[:1]), not_prior[:-1]], dim=0)
    v_sel = torch.sum(vs * (ok * prior_none), dim=0)
    v_fb = torch.clamp_min(v[-1], 1e-3)
    v_fin = v_sel + not_prior[-1] * v_fb
    return torch.log(d) + torch.log(v_fin)


def _pairs(n: int) -> int:
    """Words for n Box-Muller normals (two per pair of words)."""
    return n + (n % 2)


def log_gamma(key, concs, size=(), dtype=None, n_iter: int = 4):
    """Samples of log(Gamma(conc, 1)), shape ``size + concs.shape``, in the
    type of ``concs`` (or ``dtype``), on its device.

    Element e of the flat result draws from the blocks with counter index
    e under ``key``: F normals, F exponentials and one boost exponential,
    F = ``n_iter`` fixed Marsaglia-Tsang proposals."""
    concs = torch.as_tensor(concs, dtype=dtype)
    if not concs.is_floating_point():
        concs = concs.to(torch.get_default_dtype())
    shape = tuple(size) + tuple(concs.shape)
    F = int(n_iter)
    total = 1
    for s in shape:
        total *= s
    idx = torch.arange(total, dtype=torch.int64, device=concs.device)
    wn, we, wb = kr.stream_words(key, idx, [(kr.NORMAL, _pairs(F)),
                                            (kr.EXPONENTIAL, F), (kr.BOOST, 1)])
    x = kr.normal(wn, concs.dtype)[:, :F].T
    neg_log_u = kr.exponential(we, concs.dtype).T
    boost_e = kr.exponential(wb, concs.dtype)[:, 0]
    safe = torch.broadcast_to(concs, shape).reshape(total)
    log_g1 = _mt_boosted_log_gamma_t(x, neg_log_u, safe)
    return (log_g1 - boost_e / safe).reshape(shape)


def log_dirichlet_draw(key, conc, n_iter: int = 4):
    """log of an unnormalised Dirichlet draw for one concentration vector:
    log Gamma(c_b) per bucket, zero concentrations -> -inf (excluded
    categories). logsumexp over the last axis normalises it."""
    conc = torch.as_tensor(conc)
    lg = log_gamma(key, torch.clamp_min(conc, 1e-30), n_iter=n_iter)
    return torch.where(conc > 0, lg, -torch.inf)


def sample_dirichlet_log(key, concs, size=()):
    """log of Dirichlet(concs) draws, shape ``size + concs.shape``,
    normalised over the last axis with logsumexp (the reference normalises
    this way at get_var_probs.py:174-175)."""
    lg = log_gamma(key, concs, size=size)
    return lg - torch.logsumexp(lg, dim=-1, keepdim=True)


def fold_in_many(key, data) -> torch.Tensor:
    """One derived key per element of ``data``: the row-keyed derivation
    behind stateless sampling."""
    return kr.fold_in(key, data)


def log_dirichlet_draw_keyed(keys, conc, n_iter: int = 6):
    """Unnormalised log-Dirichlet draws, one per key: ``keys`` [...]
    (int64) and ``conc`` [..., A] broadcast together; returns [..., A],
    zero concentrations -> -inf. Same key and concentrations, same draw
    (derive keys from table rows with :func:`fold_in_many`).

    Each key draws from its own blocks (counter index 0): F*A normals
    (proposal-major, then category), F*A exponentials and A boost
    exponentials, F = ``n_iter``."""
    conc = torch.as_tensor(conc)
    keys = kr._as_keys(keys, conc.device)
    A = conc.shape[-1]
    F = int(n_iter)
    lead = torch.broadcast_shapes(keys.shape, conc.shape[:-1])
    keys = keys.expand(lead)
    wn, we, wb = kr.stream_words(keys, 0, [(kr.NORMAL, _pairs(F * A)),
                                           (kr.EXPONENTIAL, F * A), (kr.BOOST, A)])
    dtype = conc.dtype
    x = kr.normal(wn, dtype)[..., : F * A].unflatten(-1, (F, A)).movedim(-2, 0)
    neg_log_u = kr.exponential(we, dtype).unflatten(-1, (F, A)).movedim(-2, 0)
    boost_e = kr.exponential(wb, dtype)
    del wn, we, wb  # the words' memory goes before the accept test's
    safe = torch.clamp_min(conc, 1e-30)
    lg = _mt_boosted_log_gamma_t(x, neg_log_u, safe) - boost_e / safe
    return torch.where(conc > 0, lg, -torch.inf)


def log_dirichlet_draw_keyed_t(keys, conc_t, n_iter: int = 6):
    """:func:`log_dirichlet_draw_keyed` with categories first: ``conc_t``
    [A, N] -> [A, N]."""
    return log_dirichlet_draw_keyed(keys, torch.as_tensor(conc_t).T, n_iter=n_iter).T


def log_gamma_pdf(conc, xs):
    """Density of log(Gamma(conc, 1)) at xs:
    f(y) = exp(conc*y - e^y - lgamma(conc)) (reference log_gamma.py:14-15)."""
    conc = torch.as_tensor(conc, dtype=torch.float64)
    xs = torch.as_tensor(xs, dtype=torch.float64)
    return torch.exp(conc * xs - torch.exp(xs) - torch.lgamma(conc))
