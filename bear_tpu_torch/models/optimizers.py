"""optax's update rules as ``torch.optim.Optimizer``s (the optimizers that
bear_tpu builds with optax, bear_tpu/models/bear_net.py:93-117).

bear_tpu calls each optax factory as ``factory(lr, eps=1e-7)`` where it
takes ``eps``, else ``factory(lr)``, and keeps every other default of optax
0.2.6. Those defaults are not ``torch.optim``'s, nor are the rules of
rmsprop, adagrad and nadam, and torch has no lion; so all seven are written
out here, with one state format (t counts applies from 1; g is the
gradient, p the parameter, every update is then applied as
``p - lr * u``):

- ``adamw``: Adam (b1 0.9, b2 0.999, eps 1e-7 outside the root), then
  ``u + 1e-4 * p`` on every parameter (optax's ``mask=None``).
- ``nadam``: optax's Nesterov Adam, ``m_hat = b1 * m / (1 - b1^(t+1)) +
  (1 - b1) * g / (1 - b1^t)`` (``scale_by_adam(nesterov=True)``), not
  ``torch.optim.NAdam``'s momentum-decay schedule.
- ``adamax``: ``nu = max(|g| + eps, b2 * nu)``; only ``m`` is
  bias-corrected; ``u = m_hat / nu``.
- ``rmsprop``: decay 0.9, ``nu`` from 0, ``u = g * rsqrt(nu + eps)`` (eps
  inside the root; torch's alpha is 0.99 with eps outside).
- ``adagrad``: the sum of squares starts at 0.1, ``u = where(s > 0,
  rsqrt(s + eps), 0) * g`` (torch starts at 0 with eps outside the root).
- ``adadelta``: rho 0.9, eps 1e-7, ``u = sqrt(e_x + eps) / sqrt(e_g + eps) *
  g`` with ``e_x`` updated from ``u`` afterwards; ``lr`` multiplies ``u``.
- ``lion``: b1 0.9, b2 0.99, ``u = sign((1 - b1) * g + b1 * m) + 1e-3 * p``
  (weight decay on every parameter), ``m`` updated after the sign.

Every state moves at every apply, a zero gradient included, as optax's do:
each parameter must hold a gradient (``bear_net`` starts them at zeros).
The state is initialised when the optimizer is made and round-trips through
``state_arrays`` / ``load_state_arrays`` as plain numpy, for checkpoints.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

EPS = 1e-7  # bear_tpu's eps=1e-7, where the factory takes one


class OptaxRule(torch.optim.Optimizer):
    """One optax update rule over a single group of parameters.

    ``STATE`` names the per-parameter state tensors and ``INIT`` their
    initial values (0 where not given); ``count`` is optax's apply counter
    (t), kept on the host."""

    NAME = ""
    STATE: tuple = ()
    INIT: Dict[str, float] = {}

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=float(lr)))
        self.count = 0
        for p in self._params():
            self.state[p] = {n: torch.full_like(p, self.INIT.get(n, 0.0)) for n in self.STATE}

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def _update(self, g, p, s, t):
        """The update u of one parameter at apply t; moves its state ``s``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{self.NAME} takes no closure")
        if any(p.grad is None for p in self._params()):
            raise ValueError(f"{self.NAME}: a parameter has no gradient; optax moves every "
                             "state at every apply, so each needs one")
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                u = self._update(p.grad, p, self.state[p], self.count)
                p.sub_(group["lr"] * u)

    def state_arrays(self) -> dict:
        """``{"name", "step", <state name>: [numpy arrays in parameter
        order]}``."""
        params = self._params()
        out = {"name": self.NAME, "step": self.count}
        for n in self.STATE:
            out[n] = [self.state[p][n].detach().cpu().numpy() for p in params]
        return out

    def load_state_arrays(self, state: dict) -> None:
        """Inverse of :meth:`state_arrays`."""
        if state.get("name") != self.NAME:
            raise ValueError(f"optimizer state is {state.get('name')!r}, the optimizer "
                             f"{self.NAME!r}")
        self.count = int(state["step"])
        for n in self.STATE:
            for p, a in zip(self._params(), state[n]):
                self.state[p][n].copy_(torch.as_tensor(np.array(a)))


def _bias_correction(moment, decay, t):
    return moment / (1.0 - decay ** t)


class AdamW(OptaxRule):
    NAME = "adamw"
    STATE = ("mu", "nu")
    B1, B2, WEIGHT_DECAY = 0.9, 0.999, 1e-4

    def _adam(self, g, s, t, nesterov=False):
        b1, b2 = self.B1, self.B2
        s["mu"].mul_(b1).add_((1.0 - b1) * g)
        s["nu"].mul_(b2).add_((1.0 - b2) * (g * g))
        if nesterov:
            m_hat = b1 * _bias_correction(s["mu"], b1, t + 1) + (1.0 - b1) * \
                _bias_correction(g, b1, t)
        else:
            m_hat = _bias_correction(s["mu"], b1, t)
        return m_hat / (torch.sqrt(_bias_correction(s["nu"], b2, t)) + EPS)

    def _update(self, g, p, s, t):
        return self._adam(g, s, t) + self.WEIGHT_DECAY * p


class NAdam(AdamW):
    NAME = "nadam"

    def _update(self, g, p, s, t):
        return self._adam(g, s, t, nesterov=True)


class Adamax(OptaxRule):
    NAME = "adamax"
    STATE = ("mu", "nu")
    B1, B2 = 0.9, 0.999

    def _update(self, g, p, s, t):
        s["mu"].mul_(self.B1).add_((1.0 - self.B1) * g)
        torch.maximum(g.abs() + EPS, self.B2 * s["nu"], out=s["nu"])
        return _bias_correction(s["mu"], self.B1, t) / s["nu"]


class RMSprop(OptaxRule):
    NAME = "rmsprop"
    STATE = ("nu",)
    DECAY = 0.9

    def _update(self, g, p, s, t):
        s["nu"].mul_(self.DECAY).add_((1.0 - self.DECAY) * (g * g))
        return torch.rsqrt(s["nu"] + EPS) * g


class Adagrad(OptaxRule):
    NAME = "adagrad"
    STATE = ("sum_of_squares",)
    INIT = {"sum_of_squares": 0.1}

    def _update(self, g, p, s, t):
        s2 = s["sum_of_squares"]
        s2.add_(g * g)
        return torch.where(s2 > 0, torch.rsqrt(s2 + EPS), 0.0) * g


class Adadelta(OptaxRule):
    NAME = "adadelta"
    STATE = ("e_g", "e_x")
    RHO = 0.9

    def _update(self, g, p, s, t):
        rho = self.RHO
        s["e_g"].mul_(rho).add_((1.0 - rho) * (g * g))
        u = torch.sqrt(s["e_x"] + EPS) / torch.sqrt(s["e_g"] + EPS) * g
        s["e_x"].mul_(rho).add_((1.0 - rho) * (u * u))
        return u


class Lion(OptaxRule):
    NAME = "lion"
    STATE = ("mu",)
    B1, B2, WEIGHT_DECAY = 0.9, 0.99, 1e-3

    def _update(self, g, p, s, t):
        u = torch.sign((1.0 - self.B1) * g + self.B1 * s["mu"])
        s["mu"].mul_(self.B2).add_((1.0 - self.B2) * g)
        return u + self.WEIGHT_DECAY * p


OPTAX_RULES = {cls.NAME: cls for cls in (AdamW, NAdam, Adamax, RMSprop, Adagrad, Adadelta,
                                         Lion)}
