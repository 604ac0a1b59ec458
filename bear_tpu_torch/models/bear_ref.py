"""Reference-guided BEAR: the embedded AR function mixes a learned net with
Jukes-Cantor-smoothed reference-genome transition counts (port of
bear_tpu/models/bear_ref.py).

- ``counts_to_probs``: l1-normalise the reference counts, apply
  Jukes-Cantor smoothing ``e^{-tau} * norm + (1 - e^{-tau}) / |B|`` on the
  residues, zero stop probability.
- ``RefAR``: the mixture ``f = (nu * g(kmers) + JC(ref)) / (nu + 1)`` as an
  ``nn.Module`` around a ``LinearAR``/``CNNAR``/``StopAR`` ``g``, with
  learnable ``tau_signed`` (init log(1/30)) and ``net_weight_signed``
  (init -log 100); parameters in checkpoint order
  ``[tau_signed, net_weight_signed] + g's``. Its ``forward`` and
  ``apply_codes`` take the batch's prepared reference counts as their
  third input.
- Training and evaluation are ``bear_net``'s, given the prepared reference
  column (``ref_counts``, or a third element of every shard): the stop
  column stripped and an epsilon added (``prepare_ref_counts``).

Derived diagnostics: error rate = 1 - e^{-tau}; stop rate = (1 + nu) / nu.
``compute_dtype`` (mixed precision of ``g``) is not ported yet and raises
(ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import alphabets
from bear_tpu_torch.ops.distributions import EPSILON
from bear_tpu_torch.utils.device import resolve_device


def counts_to_probs(ref_counts: torch.Tensor, tau, alphabet_size: int) -> torch.Tensor:
    """Jukes-Cantor smoothing of prepared reference counts [..., A+1].

    All-zero rows (zero-padded batch slots) give finite values, uniform
    over the residues, and finite gradients, because the normalising total
    is floored; their counts are zero, so they add nothing to a
    likelihood."""
    total = ref_counts.abs().sum(dim=-1, keepdim=True)
    # The floor is float32's tiny, not the dtype's own (bear_tpu's choice,
    # where float64 may be emulated with float32's exponent range): real rows
    # carry >= 4 * EPSILON, so any floor below ~1e-8 is inert.
    tiny = torch.finfo(torch.float32).tiny
    norm = ref_counts / torch.clamp_min(total, tiny)
    base = torch.zeros(alphabet_size + 1, dtype=ref_counts.dtype, device=ref_counts.device)
    base[:alphabet_size] = 1.0 / alphabet_size
    return base + torch.exp(-torch.as_tensor(tau, dtype=ref_counts.dtype,
                                             device=ref_counts.device)) * (norm - base)


def prepare_ref_counts(ref_column, alphabet_size: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """``(ref + eps) * not_stop``: the stop column stripped and an epsilon
    added on the residues, as a ``dtype`` tensor on ``device`` (default:
    where ``ref_column`` lies)."""
    ref = torch.as_tensor(ref_column)
    ref = ref.to(device=ref.device if device is None else device, dtype=dtype)
    not_stop = torch.ones(alphabet_size + 1, dtype=dtype, device=ref.device)
    not_stop[alphabet_size] = 0.0
    return (ref + EPSILON) * not_stop


SIGNED_INIT = (math.log(1 / 30), -math.log(100))  # tau_signed, net_weight_signed


class RefAR(nn.Module):
    """The reference-guided AR function around an AR module ``net`` (the
    ``g`` of the mixture). Parameters in checkpoint order:
    ``[tau_signed, net_weight_signed] + net's``."""

    def __init__(self, net: nn.Module, alphabet_size: int, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.net = net
        self.lag = net.lag
        self.A = int(alphabet_size)
        self.A1 = self.A + 1
        self.dtype = dtype
        self.name = f"ref[{net.name}]"
        self.tau_signed, self.net_weight_signed = (
            nn.Parameter(torch.tensor(v, dtype=dtype, device=device)) for v in SIGNED_INIT)

    def init(self, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """[log(1/30), -log(100)] + a fresh draw of the net's parameters."""
        return [torch.tensor(v, dtype=self.dtype) for v in SIGNED_INIT] + \
            self.net.init(generator)

    def _live(self, params):
        if params is not None:
            return list(params)
        return [self.tau_signed, self.net_weight_signed] + list(self.net._live(None))

    def load_params(self, ar_params: Sequence) -> None:
        """Load the ``ar`` part of a checkpoint list ([tau_signed,
        net_weight_signed] + net params)."""
        if len(ar_params) < 2:
            raise ValueError(f"{self.name} takes [tau_signed, net_weight_signed] + net "
                             f"params, got {len(ar_params)} arrays")
        with torch.no_grad():
            for mine, p in zip((self.tau_signed, self.net_weight_signed), ar_params[:2]):
                mine.copy_(torch.as_tensor(np.array(p)))
        self.net.load_params(ar_params[2:])

    def params_list(self) -> List[torch.Tensor]:
        return [self.tau_signed.detach(), self.net_weight_signed.detach()] + \
            self.net.params_list()

    def _mix(self, params, g, ref_counts):
        # The signed exponents are clamped to +-40 before exp: an overflow of
        # tau or nu would make the mixture inf/inf = NaN; converged values sit
        # near log(1/30) and -log(100), where the clamp is inert.
        if ref_counts is None:
            raise ValueError(f"{self.name} needs the batch's reference counts")
        tau = torch.exp(torch.clamp(params[0], -40.0, 40.0))
        nw = torch.exp(torch.clamp(params[1], -40.0, 40.0))
        return (nw * g + counts_to_probs(ref_counts, tau, self.A)) / (nw + 1.0)

    def forward(self, kmers_oh: torch.Tensor, params=None, ref_counts=None) -> torch.Tensor:
        """One-hot k-mers [..., lag, A+1] and reference counts [..., A+1] ->
        probabilities [..., A+1]."""
        params = self._live(params)
        return self._mix(params, self.net(kmers_oh, params[2:]), ref_counts)

    def apply_codes(self, codes: torch.Tensor, params=None, ref_counts=None) -> torch.Tensor:
        """Integer k-mer codes [..., lag] and reference counts [..., A+1] ->
        probabilities [..., A+1]."""
        params = self._live(params)
        return self._mix(params, self.net.apply_codes(codes, params[2:]), ref_counts)


def _refuse_compute_dtype(compute_dtype):
    if compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype (mixed precision of the inner net) is not ported to PyTorch "
            "yet; see ROADMAP.md Queue 1 item 4")


def make_ref_ar(net_func, lag: int, alphabet_size: int, af_kwargs=None, *,
                dtype=torch.float32, compute_dtype=None, device="cuda",
                generator: Optional[torch.Generator] = None) -> RefAR:
    """A :class:`RefAR` around the net named ``net_func`` ("linear", "cnn",
    "stop"), or built by ``net_func(lag, alphabet_size, **af_kwargs,
    dtype=, device=, generator=)`` (an AR class such as ``StopAR``)."""
    _refuse_compute_dtype(compute_dtype)
    if isinstance(net_func, str):
        net = get_ar_func(net_func, lag, alphabet_size, af_kwargs, dtype=dtype,
                          device=device, generator=generator)
    else:
        net = net_func(lag, alphabet_size, **(af_kwargs or {}), dtype=dtype, device=device,
                       generator=generator)
    return RefAR(net, alphabet_size, dtype=dtype, device=device)


def train(codes, counts, ref_column, num_kmers, net_func, af_kwargs=None, *,
          alphabet: str = "dna", lag: Optional[int] = None, dtype=torch.float32,
          compute_dtype=None, device="cuda", **kwargs) -> bear_net.TrainResult:
    """Train a reference-guided BEAR/AR model: ``bear_net.train`` with the
    prepared ``ref_column`` ([N, A+1] raw reference counts) and a
    :class:`RefAR` around ``net_func``'s net. Other keywords as
    ``bear_net.train``."""
    dev = resolve_device(device)
    A = alphabets.alphabet_size(alphabet)
    lag = lag if lag is not None else codes.shape[-1]
    ar = make_ref_ar(net_func, lag, A, af_kwargs, dtype=dtype, compute_dtype=compute_dtype,
                     device=dev)
    ref = prepare_ref_counts(ref_column, A, dtype, dev)
    return bear_net.train(codes, counts, num_kmers, ar, alphabet=alphabet, dtype=dtype,
                          ref_counts=ref, device=dev, **kwargs)


def train_streaming(shards, num_kmers, net_func, af_kwargs=None, *, alphabet: str = "dna",
                    lag: int, dtype=torch.float32, compute_dtype=None, device="cuda",
                    **kwargs) -> bear_net.TrainResult:
    """Shard-streamed reference-guided training (memory bounded by one
    shard; see ``bear_net.train_streaming``). ``shards`` yields (codes,
    counts, raw reference column) triples; the column is prepared per
    shard here."""
    dev = resolve_device(device)
    A = alphabets.alphabet_size(alphabet)
    ar = make_ref_ar(net_func, lag, A, af_kwargs, dtype=dtype, compute_dtype=compute_dtype,
                     device=dev)
    takes_epoch = bear_net._shards_takes_epoch(shards)

    def prepared(epoch=0):
        for codes, counts, ref_col in (shards(epoch) if takes_epoch else shards()):
            yield codes, counts, prepare_ref_counts(ref_col, A, dtype, dev)

    return bear_net.train_streaming(prepared, num_kmers, ar, alphabet=alphabet, dtype=dtype,
                                    device=dev, **kwargs)


def evaluation(codes, counts, ds_loc_train, ds_loc_test, ds_loc_ref, alphabet, h, ar_func,
               ar_params, van_reg, **kwargs):
    """Evaluate a reference-guided model (``bear_net.evaluation`` with
    column ``ds_loc_ref`` of ``counts`` prepared as the reference)."""
    A = alphabets.alphabet_size(alphabet)
    dtype = kwargs.get("dtype", torch.float32)
    ref = prepare_ref_counts(counts[:, ds_loc_ref, :], A, dtype)
    return bear_net.evaluation(codes, counts, ds_loc_train, ds_loc_test, alphabet, h,
                               ar_func, ar_params, van_reg, ref_counts=ref, **kwargs)


def evaluation_streaming(shards, ds_loc_train, ds_loc_test, ds_loc_ref, alphabet, h,
                         ar_func, ar_params, van_reg, **kwargs):
    """Shard-streamed reference-guided evaluation, memory bounded by one
    shard. ``shards`` yields (codes, counts [n, num_ds, A+1]) pairs; column
    ``ds_loc_ref`` is prepared per shard here."""
    A = alphabets.alphabet_size(alphabet)
    dtype = kwargs.get("dtype", torch.float32)

    def prepared():
        for codes, counts in shards():
            yield codes, counts, prepare_ref_counts(counts[:, ds_loc_ref, :], A, dtype)

    return bear_net.evaluation_streaming(prepared, ds_loc_train, ds_loc_test, alphabet, h,
                                         ar_func, ar_params, van_reg, **kwargs)


def _scalar(x) -> float:
    return float(np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x))


def error_rate(params) -> float:
    """1 - e^{-tau} (reference train_bear_ref.py:144-145)."""
    return float(1.0 - np.exp(-np.exp(_scalar(params["ar"][0]))))


def stop_rate_inverse(params) -> float:
    """(1 + nu) / nu: with g the stop net the expected stop probability is
    nu / (1 + nu) per step, so this estimates the read length (reference
    train_bear_ref.py:146-147)."""
    nu = np.exp(_scalar(params["ar"][1]))
    return float((1.0 + nu) / nu)
