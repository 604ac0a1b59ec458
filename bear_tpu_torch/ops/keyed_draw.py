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
refused launch raises) in the shape :func:`launch_shape` picks: a thread
per element and tile of samples; on CPU tensors the plain PyTorch version
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
from typing import NamedTuple

import torch

from bear_tpu_torch import _build
from bear_tpu_torch.ops.loggamma import fold_in_many, log_dirichlet_draw_keyed
from bear_tpu_torch.utils.device import sm_count

SOURCE = "keyed_draw"
MAX_A1 = 32  # mirrors of csrc/keyed_draw.cu
MAX_F = 64
THREADS = 128  # elements a block
MAX_GRID_Y = 65535
MAX_TILE = 16  # samples a thread draws with its element's constants, as a rule
BLOCKS_PER_SM = 8  # blocks a launch keeps before it tiles samples
launches = 0  # kernel launches of both modes


class LaunchShape(NamedTuple):
    """How one launch divides its [S, E] draws: block x takes THREADS
    elements, block y the sample tiles y, y + grid_y, ... of ``tile``
    samples each; a thread draws its element's samples of the tile."""

    tile: int
    grid_x: int
    grid_y: int


@functools.lru_cache(maxsize=256)
def launch_shape(S: int, E: int, sms: int) -> LaunchShape:
    """The launch shape of S samples of E elements on a card of ``sms``
    SMs. The tile is the most samples (at most MAX_TILE) that still leave
    BLOCKS_PER_SM blocks per SM, at least one; the sample tiles are then
    evened out (41 samples: 3 tiles of 14). Beyond MAX_GRID_Y tiles, the
    tile grows instead. S = 1 (assembly's step) is one sample a thread."""
    grid_x = -(-E // THREADS)
    tile = max(1, min(MAX_TILE, grid_x * S // (BLOCKS_PER_SM * sms)))
    grid_y = min(-(-S // tile), MAX_GRID_Y)
    return LaunchShape(-(-S // grid_y), grid_x, grid_y)


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built library's launcher."""
    fn = lib.keyed_draw_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE))


def launch(base_keys, group, rows, conc, n_iter, nxt, out, shape: LaunchShape,
           lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """One kernel launch into ``out`` on the tensors' card, in launch shape
    ``shape``, on the current stream; raises if the launcher refuses or the
    launch fails. :func:`keyed_draw_picked` and :func:`keyed_draw_full`
    check and lay out the arguments and pick the shape; a caller may pass
    another shape, or ``lib`` a timing-only build of the same source
    (keyed_draw_timing.py)."""
    global launches
    S, G = base_keys.shape
    E, A1 = conc.shape
    with torch.cuda.device(conc.device):
        stream = torch.cuda.current_stream(conc.device).cuda_stream
        rc = (lib or _library()).keyed_draw_launch(
            base_keys.data_ptr(), G, group.data_ptr(), rows.data_ptr(), conc.data_ptr(),
            None if nxt is None else nxt.data_ptr(), out.data_ptr(), S, E, A1, int(n_iter),
            conc.element_size(), shape.tile, shape.grid_x, shape.grid_y, stream)
    if rc != 0:
        raise RuntimeError(f"keyed_draw kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def _draw(base_keys, group, rows, conc, n_iter, nxt):
    _check(base_keys, group, rows, conc, nxt, n_iter)
    dev = conc.device
    if dev.type == "cpu":
        return keyed_draw_plain(base_keys, group, rows, conc, n_iter, nxt)
    if dev.type != "cuda":
        raise ValueError(f"keyed_draw has no path for device {dev}")
    S = base_keys.shape[0]
    E, A1 = conc.shape
    out = torch.empty((S, E) if nxt is not None else (S, E, A1), dtype=conc.dtype, device=dev)
    if out.numel() == 0:
        return out
    if nxt is not None:
        nxt = nxt.to(torch.int32).contiguous()
    return launch(base_keys.contiguous(), group.to(torch.int64).contiguous(),
                  rows.to(torch.int64).contiguous(), conc.contiguous(), n_iter, nxt, out,
                  launch_shape(S, E, sm_count(dev.index)))


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

