"""Server-side dense optimizers, written by hand to optax's numerics.

Counterpart of ``ps_tpu/optim/__init__.py``, which returns optax
transformations. ``torch.optim`` orders its arithmetic differently (Adam
folds the bias correction into the step size), so these follow optax
0.2.6 expression by expression instead:

- sgd: ``scale_by_learning_rate`` (``u = -lr * g``), then
  ``apply_updates`` (``p + u``);
- adam: ``scale_by_adam`` — ``mu = (1-b1)*g + b1*mu``,
  ``nu = (1-b2)*g**2 + b2*nu``, an int32 ``count`` incremented first, bias
  correction ``m / (1 - b**count)``, ``u = mu_hat / (sqrt(nu_hat + eps_root)
  + eps)`` — then ``-lr * u``, then ``p + u``.

An optimizer works on ``{key: tensor}`` dicts and updates parameters and
state in place (``step_``); in-place update is what JAX's buffer donation
bought the reference. ``momentum`` and ``lamb`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import torch

__all__ = ["Optimizer", "make_optimizer", "sgd", "adam"]

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``step_(params, grads, state)`` applies
    one update to ``params`` and ``state`` in place. ``params`` and
    ``grads`` are ``{key: tensor}`` dicts with the same keys."""

    name: str
    init: Callable[[Dict[str, torch.Tensor]], Any]
    step_: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Any],
                    None]


def sgd(learning_rate: float = 0.01) -> Optimizer:
    """Plain SGD — the reference server's default apply rule."""

    def init(params):
        return ()

    @torch.no_grad()
    def step_(params, grads, state):
        for k, p in params.items():
            p.add_(-learning_rate * grads[k])

    return Optimizer("sgd", init, step_)


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Optimizer:
    def init(params):
        some = next(iter(params.values()), None)
        device = some.device if some is not None else None
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def step_(params, grads, state):
        count = state["count"]
        count.add_((count < _INT32_MAX).to(torch.int32))  # safe_increment
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        for k, p in params.items():
            g = grads[k]
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = mu / bc1.to(mu.dtype)
            nu_hat = nu / bc2.to(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
            p.add_(-learning_rate * u)

    return Optimizer("adam", init, step_)


_REGISTRY = {"sgd": sgd, "adam": adam}


def make_optimizer(opt: Union[str, Optimizer], **kwargs) -> Optimizer:
    """Resolve an optimizer name or pass an :class:`Optimizer` through."""
    if isinstance(opt, str):
        try:
            return _REGISTRY[opt.lower()](**kwargs)
        except KeyError:
            raise ValueError(
                f"unknown optimizer {opt!r}; known: {sorted(_REGISTRY)}"
            ) from None
    if isinstance(opt, Optimizer):
        if kwargs:
            raise ValueError(
                "kwargs are only valid with a string optimizer name")
        return opt
    raise TypeError(f"optimizer must be a name or Optimizer, got {type(opt)}")
