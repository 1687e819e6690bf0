"""Server-side dense optimizers, written by hand to optax's numerics.

Counterpart of ``ps_tpu/optim/__init__.py``, which returns optax
transformations. ``torch.optim`` orders its arithmetic differently (Adam
folds the bias correction into the step size), so these follow optax
0.2.6 expression by expression instead:

- sgd: ``scale_by_learning_rate`` (``u = -lr * g``), then
  ``apply_updates`` (``p + u``), taken with a float rate as one fused
  multiply-add (``p.add_(g, alpha=-lr)``), which is how XLA compiles the
  reference's jitted apply on the CPU: the two agree bitwise there;
- momentum: ``optax.sgd(lr, momentum, nesterov)`` — ``trace`` (``t = g +
  decay * t``; with nesterov ``u = g + decay * t``, else ``u = t``), then
  ``-lr * u``, then ``p + u``, each step a handful of ``torch._foreach_*``
  calls over all tensors at once;
- adam: ``scale_by_adam`` — ``mu = (1-b1)*g + b1*mu``,
  ``nu = (1-b2)*g**2 + b2*nu``, an int32 ``count`` incremented first, bias
  correction ``m / (1 - b**count)``, ``u = mu_hat / (sqrt(nu_hat + eps_root)
  + eps)`` — then ``-lr * u``, then ``p + u``;
- lamb: ``optax.lamb``'s chain — ``scale_by_adam`` (eps 1e-6, eps_root 0),
  ``add_decayed_weights`` (``u + wd * p`` on every tensor, biases and
  LayerNorm parameters included), ``scale_by_trust_ratio`` (``u *
  ‖p‖ / ‖u‖`` per parameter tensor, exactly 1 where either norm is 0),
  then ``-lr * u``, then ``p + u``. On the card the keys whose tensors
  are contiguous f32 go to one fused multi-tensor kernel
  (``ops/lamb_apply.py``, two launches a step) with the same arithmetic;
  every other key, every CPU tensor included, keeps the loop over the
  keys. ``FUSED_TENSORS`` and ``LOOP_TENSORS`` (``ps_lamb_*_tensors_total``
  in ``obs``'s registry) count the tensors each route steps.

Each takes a float learning rate or a schedule ``count -> lr``, as the
reference takes an ``optax.Schedule``. A schedule is called with optax's
``scale_by_schedule`` count, an int32 tensor on the parameters' device
kept in the state (``{"rule": <the rule's state>, "schedule_count":
count}``), before that count is incremented, so the first step uses
``lr(0)``; it returns a float or a 0-d tensor.

An optimizer works on ``{key: tensor}`` dicts and updates parameters and
state in place (``step_``); in-place update is what JAX's buffer donation
bought the reference.

Under ZeRO-1 a rank steps only the slices it owns, and LAMB's trust ratio
needs the norms of whole tensors. The server passes them in as
:class:`ShardNorms`: what the rank holds of each sliced key's parameter
(the whole of it, so ``‖p‖`` is local, unless a 'model' or 'pipe' axis
slices it too: then its partial ``Σp²`` is summed over those axes), the
axes each key's stepped slice is cut on, and a sum over one axis. LAMB
defers each sliced key's trust step to it, and the server's ``finish()``
after the step reduces every deferred partial in one flat all-reduce an
axis, however many ``step_`` calls deferred them (the async engine steps
key by key). The other rules are elementwise and ignore it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from ps_tpu_torch.obs.metrics import default_registry
from ps_tpu_torch.ops import lamb_apply
from ps_tpu_torch.optim.dc import delay_compensate
from ps_tpu_torch.parallel.mesh import AXES

__all__ = ["Optimizer", "ShardNorms", "make_optimizer", "sgd", "momentum",
           "adam", "lamb", "delay_compensate"]

_INT32_MAX = 2**31 - 1

#: a float, or a schedule ``count -> lr`` (optax's ``Schedule``)
LearningRate = Union[float, Callable[[torch.Tensor], Any]]

#: tensors LAMB stepped by each route: the fused kernel
#: (``ops/lamb_apply.py``) or the loop over the keys
FUSED_TENSORS = default_registry().counter(
    "ps_lamb_fused_tensors_total",
    "tensors LAMB stepped in the fused multi-tensor kernel")
LOOP_TENSORS = default_registry().counter(
    "ps_lamb_loop_tensors_total",
    "tensors LAMB stepped one key at a time by the loop")


@dataclasses.dataclass(frozen=True)
class ShardNorms:
    """How a rank that steps slices sees whole tensors' norms: ``whole``
    maps each key whose ``params`` entry is a slice to what the rank holds
    of the parameter (before the step), ``p_axes`` to the mesh axes that
    held tensor is itself a slice on (none: it is the whole parameter),
    ``u_axes`` to the axes the stepped slice is cut on ('data' where a key
    is not named), and ``all_reduce(flat, axis)`` sums a flat f32 tensor
    over one axis's ranks in place and returns it, the same on every
    rank.

    A rule ``defer``s a step that waits for partial sums' totals; the
    server calls ``finish()`` once after its ``step_`` calls, which sums
    every deferred partial in one ``all_reduce`` an axis (in the order
    'data', 'model', 'seq', 'pipe') and runs the deferred steps in
    order."""

    whole: Dict[str, torch.Tensor]
    all_reduce: Callable[[torch.Tensor, str], torch.Tensor]
    p_axes: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    u_axes: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    _pending: List[tuple] = dataclasses.field(default_factory=list)

    def defer(self, sums: List[Tuple[torch.Tensor, Tuple[str, ...]]],
              step: Callable[..., None]) -> None:
        """Queue ``step(*totals)``: each of ``sums`` is a partial and the
        axes its total sums it over."""
        self._pending.append((sums, step))

    @torch.no_grad()
    def finish(self) -> None:
        pending = list(self._pending)
        self._pending.clear()
        if not pending:
            return
        entries = [(i, j, axes) for i, (sums, _) in enumerate(pending)
                   for j, (_, axes) in enumerate(sums)]
        totals = {(i, j): sums[j][0] for i, (sums, _) in enumerate(pending)
                  for j in range(len(sums))}
        for axis in AXES:
            ids = [(i, j) for i, j, axes in entries if axis in axes]
            if not ids:
                continue
            summed = self.all_reduce(torch.stack([totals[x] for x in ids]),
                                     axis)
            for x, total in zip(ids, summed):
                totals[x] = total
        for i, (sums, step) in enumerate(pending):
            step(*(totals[(i, j)] for j in range(len(sums))))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``step_(params, grads, state,
    norms=None)`` applies one update to ``params`` and ``state`` in place.
    ``params`` and ``grads`` are ``{key: tensor}`` dicts with the same
    keys; ``norms`` (:class:`ShardNorms`) is given where some ``params``
    are ZeRO-1 slices."""

    name: str
    init: Callable[[Dict[str, torch.Tensor]], Any]
    step_: Callable[..., None]


def _zero_count(params):
    some = next(iter(params.values()), None)
    device = some.device if some is not None else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _safe_increment_(count):
    """optax's ``safe_increment``, in place: +1 up to the int32 maximum."""
    count.add_((count < _INT32_MAX).to(torch.int32))


def _with_rate(name: str, init, step_, learning_rate: LearningRate
               ) -> Optimizer:
    """The :class:`Optimizer` of a rule ``step_(params, grads, state, lr,
    norms)``: a float ``learning_rate`` is passed as it is; a schedule is
    evaluated at its own count, before the count is incremented (optax's
    ``scale_by_schedule``), and passed as a 0-d f32 tensor."""
    if not callable(learning_rate):
        return Optimizer(name, init, lambda p, g, s, norms=None: step_(
            p, g, s, learning_rate, norms))

    def init_scheduled(params):
        return {"rule": init(params), "schedule_count": _zero_count(params)}

    @torch.no_grad()
    def step_scheduled(params, grads, state, norms=None):
        count = state["schedule_count"]
        lr = torch.as_tensor(learning_rate(count), dtype=torch.float32,
                             device=count.device)
        step_(params, grads, state["rule"], lr, norms)
        _safe_increment_(count)

    return Optimizer(name, init_scheduled, step_scheduled)


def sgd(learning_rate: LearningRate = 0.01) -> Optimizer:
    """Plain SGD — the reference server's default apply rule."""

    def init(params):
        return ()

    @torch.no_grad()
    def step_(params, grads, state, lr, norms):
        for k, p in params.items():
            if isinstance(lr, torch.Tensor):
                p.add_(-lr * grads[k])
            else:
                p.add_(grads[k], alpha=-lr)  # one rounding, as XLA's

    return _with_rate("sgd", init, step_, learning_rate)


def momentum(learning_rate: LearningRate = 0.01, momentum: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    """SGD with momentum (optax's trace form) — the reference server's
    rule for ResNet. The state is one f32 trace a parameter."""

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step_(params, grads, state, lr, norms):
        keys = list(params)
        traces = [state[k] for k in keys]
        torch._foreach_mul_(traces, momentum)
        torch._foreach_add_(traces, [grads[k] for k in keys])
        updates = traces
        if nesterov:
            updates = torch._foreach_mul(traces, momentum)
            torch._foreach_add_(updates, [grads[k] for k in keys])
        torch._foreach_add_([params[k] for k in keys],
                            torch._foreach_mul(updates, -lr))

    return _with_rate("momentum", init, step_, learning_rate)


def _adam_init(params):
    return {
        "count": _zero_count(params),
        "mu": {k: torch.zeros_like(p) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
    }


def _scale_by_adam_(grads, state, b1, b2, eps, eps_root):
    """optax's ``scale_by_adam``: advance ``state`` in place and yield
    ``(key, u)`` for every gradient."""
    count = state["count"]
    _safe_increment_(count)
    bc1 = 1 - b1 ** count
    bc2 = 1 - b2 ** count
    for k, g in grads.items():
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * (g * g))
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        yield k, mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)


def adam(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Optimizer:
    @torch.no_grad()
    def step_(params, grads, state, lr, norms):
        for k, u in _scale_by_adam_(grads, state, b1, b2, eps, eps_root):
            params[k].add_(-lr * u)

    return _with_rate("adam", _adam_init, step_, learning_rate)


def lamb(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0) -> Optimizer:
    """LAMB, the reference's server-side optimizer for BERT. The trust
    ratio is per parameter tensor, so each key is one tensor of its own.
    A key that is a slice (in ``norms.whole``) takes ``‖p‖`` of the
    whole parameter (the held tensor's, or the root of its ``Σp²`` summed
    over ``norms.p_axes``) and ``‖u‖`` as the root of its slices' ``Σu²``
    summed over ``norms.u_axes``: its trust step is deferred to
    ``norms.finish()``, which sums every such key's partials in one flat
    all-reduce an axis."""

    def trust_step_(p, u, p_norm, u_norm, lr):
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones((), dtype=p.dtype, device=p.device),
                            p_norm / u_norm)
        p.add_(-lr * (u * ratio))

    @torch.no_grad()
    def step_(params, grads, state, lr, norms):
        whole = norms.whole if norms is not None else {}
        fused = _fused_keys(params, grads, state, whole)
        loop = grads
        if fused:
            taken = set(fused)
            loop = {k: g for k, g in grads.items() if k not in taken}
        FUSED_TENSORS.inc(len(fused))
        LOOP_TENSORS.inc(len(loop))
        # the loop counts the step first (scale_by_adam), unless the kernel
        # takes every key
        looped = (_scale_by_adam_(loop, state, b1, b2, eps, 0.0)
                  if loop or not fused else ())
        for k, u in looped:
            p = params[k]
            u = u + weight_decay * p
            if k in whole:
                u_sum = ((u * u).sum(), norms.u_axes.get(k, ("data",)))
                p_axes = norms.p_axes.get(k, ())
                if not p_axes:
                    p_norm = torch.linalg.vector_norm(whole[k])
                    norms.defer([u_sum],
                                lambda u_tot, p=p, u=u, p_norm=p_norm:
                                trust_step_(p, u, p_norm, u_tot.sqrt(), lr))
                    continue
                p_sum = ((whole[k] * whole[k]).sum(), p_axes)
                norms.defer([p_sum, u_sum],
                            lambda p_tot, u_tot, p=p, u=u:
                            trust_step_(p, u, p_tot.sqrt(), u_tot.sqrt(),
                                        lr))
                continue
            trust_step_(p, u, torch.linalg.vector_norm(p),
                        torch.linalg.vector_norm(u), lr)
        if fused:
            lamb_apply.lamb_apply_(
                [params[k] for k in fused], [grads[k] for k in fused],
                [state["mu"][k] for k in fused],
                [state["nu"][k] for k in fused], state["count"], lr, b1, b2,
                eps, weight_decay, increment=not loop, checked=True)

    return _with_rate("lamb", _adam_init, step_, learning_rate)


def _fused_keys(params, grads, state, whole) -> List[str]:
    """The keys of a LAMB step that the fused kernel takes
    (:func:`~ps_tpu_torch.ops.lamb_apply.takes`, with the step count on
    their device); a key in ``whole`` waits for its norms across ranks
    and stays on the loop."""
    mu, nu, device = state["mu"], state["nu"], state["count"].device
    return [k for k, g in grads.items()
            if k not in whole
            and lamb_apply.takes(params[k], g, mu[k], nu[k])
            and params[k].device == device]


_REGISTRY = {"sgd": sgd, "momentum": momentum, "adam": adam,
             "lamb": lamb}


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
