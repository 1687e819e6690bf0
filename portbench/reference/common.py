"""What the plain references of every configuration share: the precision
their products run in, the optimizers, and the per-leaf readings that the
benchmark compares.

Plain PyTorch, float32 by default, with TF32 off. Imports nothing of the
system under test (``ps_tpu_torch``) and nothing of JAX.

``Precision("fp8")`` is the control: every product (matrix products and
convolutions) rounds its two operands to float8 e4m3 with one scale a
tensor (its largest magnitude mapped to 448) and, in the backward, the
incoming gradient to e5m2 the same way, then multiplies in float32. That
is the step below the configurations' bfloat16 that a later change could
be tempted by, and the comparison must fail it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List

import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                       57344.0)}


def quantize(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to float8 ``kind`` under one scale for the whole
    tensor, returned in float32."""
    dtype, fmax = _FP8[kind]
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` (both 2-D, or both 3-D batches of the same size) with the
    operands in e4m3 and the output gradient in e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, "e4m3"), quantize(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, "e5m2")
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


class _Fp8Conv(torch.autograd.Function):
    """A bias-free ``conv2d`` with the operands in e4m3 and the output
    gradient in e5m2."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = quantize(x, "e4m3"), quantize(w, "e4m3")
        ctx.save_for_backward(qx, qw)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(qx, qw, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = quantize(g, "e5m2")
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, ctx.stride,
                                        ctx.padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, ctx.stride,
                                         ctx.padding)
        return gx, gw, None, None


class Precision:
    """The precision of the reference's products: 'float32' (TF32 off) or
    'fp8' (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 or fp8")
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)

    def conv(self, x, w, stride: int, padding) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Conv.apply(x, w, stride, padding)
        return F.conv2d(x, w, None, stride, padding)


@contextlib.contextmanager
def full_float32():
    """Products in full float32 inside (no TF32 on the card); the flags are
    put back on the way out."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def truncated_normal(total: int, generator: torch.Generator,
                     device) -> torch.Tensor:
    """``total`` draws of a unit normal truncated to [-2, 2], by its
    inverse CDF, in one call on ``device``."""
    edge = math.erf(math.sqrt(2.0))
    t = torch.empty(total, device=device).uniform_(-edge, edge,
                                                   generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0))


def split_flat(flat: torch.Tensor, shapes: Dict[str, tuple]
               ) -> Dict[str, torch.Tensor]:
    """Views of consecutive pieces of ``flat``, one per shape, in order."""
    out, off = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        out[key] = flat[off:off + n].view(shape)
        off += n
    return out


# -- the optimizers, as optax writes them ---------------------------------------


class Lamb:
    """optax.lamb: scale_by_adam (eps_root 0), add_decayed_weights on every
    tensor, scale_by_trust_ratio (1 where either norm is 0), -lr."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.wd = weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            u = u + self.wd * p
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            p.sub_(self.lr * ratio * u)


class Momentum:
    """optax.sgd with momentum (trace form, no Nesterov): ``t = g + m·t``,
    ``p -= lr·t``."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float,
                 momentum: float = 0.9):
        self.lr, self.m = learning_rate, momentum
        self.trace = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        for k, p in params.items():
            self.trace[k] = grads[k] + self.m * self.trace[k]
            p.sub_(self.lr * self.trace[k])


def make_optimizer(spec: dict, params):
    """The optimizer a configuration's ``optimizer`` entry names."""
    kw = {k: v for k, v in spec.items() if k != "name"}
    if spec["name"] == "lamb":
        return Lamb(params, **kw)
    if spec["name"] == "momentum":
        return Momentum(params, **kw)
    raise ValueError(f"the reference has no optimizer {spec['name']!r}")


# -- readings ----------------------------------------------------------------------


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of every leaf, in float64 on the host (one copy)."""
    keys = list(tensors)
    if not keys:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                         for k in keys]).cpu().tolist()
    return dict(zip(keys, norms))


def train_readings(loss_fn, params: Dict[str, torch.Tensor],
                   state: Dict[str, torch.Tensor], batches: Iterable,
                   optimizer: dict, precision: Precision) -> dict:
    """Steps of plain training from ``params`` and ``state`` (copied, never
    changed), one a batch: ``loss_fn(params, state, batch, precision) ->
    (loss, new_state)``. Returns the readings the benchmark compares: each
    step's loss, every leaf's first gradient norm, and every leaf's change
    norm after the last step (parameters, and the state under its own
    keys)."""
    p = {k: v.detach().float().clone() for k, v in params.items()}
    s = {k: v.detach().float().clone() for k, v in state.items()}
    opt = make_optimizer(optimizer, p)
    losses: List[torch.Tensor] = []
    first = None
    with full_float32():
        for batch in batches:
            leaves = {k: v.requires_grad_() for k, v in p.items()}
            loss, s = loss_fn(leaves, s, batch, precision)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            for v in leaves.values():
                v.requires_grad_(False)
            s = {k: v.detach() for k, v in s.items()}
            if first is None:
                first = leaf_norms(grads)
            losses.append(loss.detach())
            opt.step(p, grads)
            del grads, loss
    change = leaf_norms({k: p[k] - params[k].float() for k in p})
    state_change = leaf_norms({k: s[k] - state[k].float() for k in s})
    return {"losses": torch.stack(losses).double().cpu().tolist(),
            "grad_norms": first, "change_norms": change,
            "state_change_norms": state_change}
