"""Per-row optimizers for sparse embedding tables.

Counterpart of ``ps_tpu/optim/rowwise.py``, with its numerics kept cast by
cast. These are *lazy* row-wise rules: a row's state advances only when
the row is touched.

- sgd / adagrad: identical to the dense update with zero grads on
  untouched rows.
- adam: lazy adam — untouched rows' moments do not decay and their
  timestep does not advance.

The one update rule per optimizer is the dense-rows form
``apply_rows(rows, state, gsum, cnt)`` over any slab of rows (a gathered
batch or a whole table) with the matching state slices, the
duplicate-summed f32 gradient ``gsum`` and the int32 duplicate count
``cnt`` (0 = untouched or filler). The full-table ``apply`` is derived
from it. ``apply_rows`` is pure (it returns new tensors); the fused apply
(ps_tpu_torch/ops/sparse_apply.py) scatters its result back in place.

Each optimizer also names its rule (``kind``) and hyper-parameters
(``hyper``), which the CUDA kernel needs to run the same rule on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RowwiseOptimizer:
    """init(rows) -> state; the row-update rule in two views of one math.

    ``apply_rows(rows, state, gsum, cnt) -> (rows, state)`` — rows [B, D],
    state restricted to those rows, gsum [B, D] f32, cnt [B] int32.
    ``apply(rows, state, gsum, touched)`` is the full-table view with a
    bool mask, derived from ``apply_rows``.
    """

    init: Callable[[torch.Tensor], Any]
    apply_rows: Callable[..., Tuple[torch.Tensor, Any]]
    #: per-row optimizer-state f32 scalars per table row (adagrad 1;
    #: adam 2D+1, its int32 timestep counted as one 4-byte scalar)
    state_scalars_per_row: Callable[[int], int] = lambda dim: 0
    kind: str = "custom"
    hyper: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def apply(self) -> Callable[..., Tuple[torch.Tensor, Any]]:
        rows_fn = self.apply_rows

        def apply(rows, state, gsum, touched):
            return rows_fn(rows, state, gsum, touched.to(torch.int32))

        return apply


def sgd(learning_rate: float = 0.01) -> RowwiseOptimizer:
    def init(rows):
        return ()

    def apply_rows(rows, state, gsum, cnt):
        del cnt  # zero grad already leaves untouched rows unchanged
        # JAX gives the Python scalar the table's dtype (weak typing):
        # round lr the same way, so a bf16 table sees the same product
        lr = torch.tensor(learning_rate, dtype=rows.dtype).item()
        return rows - lr * gsum.to(rows.dtype), state

    return RowwiseOptimizer(init, apply_rows, kind="sgd",
                            hyper={"lr": learning_rate})


def adagrad(learning_rate: float = 0.01, eps: float = 1e-8) -> RowwiseOptimizer:
    """Row-wise Adagrad: one accumulator scalar per row (mean of grad² over
    the embedding dim)."""

    def init(rows):
        return torch.zeros((rows.shape[0],), dtype=torch.float32,
                           device=rows.device)

    def apply_rows(rows, acc, gsum, cnt):
        del cnt
        g = gsum.to(torch.float32)
        acc = acc + (g * g).mean(dim=-1)
        step = learning_rate * g / torch.sqrt(acc + eps)[:, None]
        return rows - step.to(rows.dtype), acc

    return RowwiseOptimizer(init, apply_rows,
                            state_scalars_per_row=lambda dim: 1,
                            kind="adagrad",
                            hyper={"lr": learning_rate, "eps": eps})


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> RowwiseOptimizer:
    """Lazy Adam: moments and per-row timestep advance only on touched rows."""

    def init(rows):
        zeros = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
        return {"m": zeros, "v": zeros.clone(),
                "t": torch.zeros((rows.shape[0],), dtype=torch.int32,
                                 device=rows.device)}

    def apply_rows(rows, state, gsum, cnt):
        g = gsum.to(torch.float32)
        touched = cnt > 0  # a row's step advances once however many
        # duplicates its gsum merged — cnt is provenance, not a multiplier
        mask = touched[:, None]
        t = state["t"] + touched.to(torch.int32)
        m = torch.where(mask, b1 * state["m"] + (1 - b1) * g, state["m"])
        v = torch.where(mask, b2 * state["v"] + (1 - b2) * g * g, state["v"])
        # bias correction with per-row t (t >= 1 wherever touched)
        t_safe = torch.clamp(t, min=1)[:, None].to(torch.float32)
        mhat = m / (1 - b1 ** t_safe)
        vhat = v / (1 - b2 ** t_safe)
        step = torch.where(
            mask, learning_rate * mhat / (torch.sqrt(vhat) + eps), 0.0)
        return rows - step.to(rows.dtype), {"m": m, "v": v, "t": t}

    return RowwiseOptimizer(init, apply_rows,
                            state_scalars_per_row=lambda dim: 2 * dim + 1,
                            kind="adam",
                            hyper={"lr": learning_rate, "b1": b1, "b2": b2,
                                   "eps": eps})


_REGISTRY = {"sgd": sgd, "adagrad": adagrad, "adam": adam}


def make_rowwise(opt, **kwargs) -> RowwiseOptimizer:
    if isinstance(opt, RowwiseOptimizer):
        if kwargs:
            raise ValueError("kwargs only valid with a string optimizer name")
        return opt
    try:
        return _REGISTRY[opt.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown rowwise optimizer {opt!r}; known: {sorted(_REGISTRY)}"
        ) from None
