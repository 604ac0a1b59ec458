"""Keyed Dirichlet draws of table rows, the sampler behind posterior-sampled
serving, Δ-scores and sampled assembly (port of what bear_tpu runs as
jitted XLA: bear_tpu/ops/loggamma.py:144-209 ``log_dirichlet_draw_keyed``
and bear_tpu/inference/serving.py:41-60 ``_sampled_logp_picked``).

For sample s and element e the draw is keyed on
``fold_in(base_keys[s, group[e]], rows[e])`` and made from the element's
concentrations ``conc[e]`` [A1] with ``n_iter`` Marsaglia-Tsang proposals
(:func:`bear_tpu_torch.ops.loggamma.log_dirichlet_draw_keyed`). Two modes:

- :func:`keyed_draw_picked`: ``lg[nxt[e]] - logsumexp(lg)``, the sampled
  log-prob of the chosen category, [S, E];
- :func:`keyed_draw_full`: the unnormalised row ``lg``, [S, E, A1].

The tensors' device decides what runs. On CUDA tensors the hand-written
kernel ``csrc/keyed_draw.cu`` is launched (built with nvcc at first use; a
refused launch raises); on CPU tensors the plain PyTorch version
:func:`keyed_draw_plain` runs, the composition of ``fold_in``,
``log_dirichlet_draw_keyed`` and the pick that the port used before the
kernel, so CPU results are unchanged bit for bit. The module's
``launches`` counts kernel launches (callers reset it).

Group ids must lie in [0, G) and ``nxt`` in [0, A1): the plain version
raises on others, the kernel writes NaN for that element.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bear_tpu_torch import _build
from bear_tpu_torch.ops.loggamma import fold_in_many, log_dirichlet_draw_keyed

SOURCE = "keyed_draw"
MAX_A1 = 32  # mirrors of csrc/keyed_draw.cu
MAX_F = 64
launches = 0  # kernel launches of both modes


def logp_picked(keys, conc, nxt, n_iter: int):
    """Posterior-sampled log-prob of the chosen category: one Dirichlet
    draw per key (keys [...], conc [..., A1] and nxt [...] broadcast).
    Same key and concentrations, same draw; a zero concentration that is
    picked scores -inf."""
    lg = log_dirichlet_draw_keyed(keys, conc, n_iter=n_iter)
    lse = torch.logsumexp(lg, dim=-1)
    idx = nxt.long().expand(lg.shape[:-1])[..., None]
    return lg.gather(-1, idx)[..., 0] - lse


def keyed_draw_plain(base_keys, group, rows, conc, n_iter: int, nxt=None):
    """Plain PyTorch version of the kernel: base_keys int64 [S, G], group
    and rows [E] integers, conc [E, A1], nxt [E] or None -> [S, E] (picked)
    or [S, E, A1] (full)."""
    keys = fold_in_many(base_keys[:, group], rows)
    if nxt is None:
        return log_dirichlet_draw_keyed(keys, conc, n_iter=n_iter)
    return logp_picked(keys, conc, nxt, n_iter)


def _check(base_keys, group, rows, conc, nxt, n_iter) -> None:
    if base_keys.dtype != torch.int64 or base_keys.dim() != 2:
        raise TypeError(f"keyed_draw needs int64 base keys [S, G], got {base_keys.dtype} "
                        f"{tuple(base_keys.shape)}")
    if conc.dtype not in (torch.float32, torch.float64) or conc.dim() != 2:
        raise TypeError(f"keyed_draw needs float32 or float64 concentrations [E, A1], got "
                        f"{conc.dtype} {tuple(conc.shape)}")
    E, A1 = conc.shape
    for name, t in (("group", group), ("rows", rows), ("nxt", nxt)):
        if t is None:
            continue
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool or t.shape != (E,):
            raise TypeError(f"keyed_draw needs integer {name} [{E}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    devices = {t.device for t in (base_keys, group, rows, conc, nxt) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"keyed_draw needs its tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    if not (1 <= A1 <= MAX_A1 and 1 <= int(n_iter) <= MAX_F):
        raise ValueError(f"keyed_draw takes 1..{MAX_A1} categories and 1..{MAX_F} proposals, "
                         f"got {A1} and {n_iter}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.keyed_draw_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _draw(base_keys, group, rows, conc, n_iter, nxt):
    global launches
    _check(base_keys, group, rows, conc, nxt, n_iter)
    dev = conc.device
    if dev.type == "cpu":
        return keyed_draw_plain(base_keys, group, rows, conc, n_iter, nxt)
    if dev.type != "cuda":
        raise ValueError(f"keyed_draw has no path for device {dev}")
    S, G = base_keys.shape
    E, A1 = conc.shape
    out = torch.empty((S, E) if nxt is not None else (S, E, A1), dtype=conc.dtype, device=dev)
    if out.numel() == 0:
        return out
    base_keys = base_keys.contiguous()
    group = group.to(torch.int64).contiguous()
    rows = rows.to(torch.int64).contiguous()
    conc = conc.contiguous()
    if nxt is not None:
        nxt = nxt.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().keyed_draw_launch(
            base_keys.data_ptr(), G, group.data_ptr(), rows.data_ptr(), conc.data_ptr(),
            None if nxt is None else nxt.data_ptr(), out.data_ptr(), S, E, A1, int(n_iter),
            conc.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"keyed_draw kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def keyed_draw_picked(base_keys, group, rows, conc, nxt, n_iter: int) -> torch.Tensor:
    """[S, E] sampled log-probs of the chosen categories ``nxt`` (module
    docstring). CUDA tensors launch the kernel; CPU tensors run
    :func:`keyed_draw_plain`."""
    return _draw(base_keys, group, rows, conc, n_iter, nxt)


def keyed_draw_full(base_keys, group, rows, conc, n_iter: int) -> torch.Tensor:
    """[S, E, A1] unnormalised log-Dirichlet draws (zero concentrations ->
    -inf; module docstring). CUDA tensors launch the kernel; CPU tensors run
    :func:`keyed_draw_plain`."""
    return _draw(base_keys, group, rows, conc, n_iter, None)

