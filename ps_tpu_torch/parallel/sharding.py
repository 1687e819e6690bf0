"""Placement policy: which slice of each parameter a rank owns.

Counterpart of ``ps_tpu/parallel/sharding.py`` for the 'data' axis. The
reference range-partitions keys across servers by sharding each
parameter over the mesh's data axis, its optimizer state identically
(ZeRO-1), tensors that do not split evenly staying replicated. Here:

- 'replicated': every rank holds the whole tensor and its whole state;
- 'sharded' (ZeRO-1): every rank still holds the whole parameter (the
  forward needs it), but owns one slice of it along :func:`shard_dim`
  and keeps the optimizer state of that slice only. Rank r owns exactly
  the slice device r owns in the reference (``_pick_dim``: the largest
  dimension divisible by k, ties toward the leading one), which is what
  checkpoints and the elastic restore rely on.

Scalars and tensors with no dimension divisible by k stay replicated. At
one rank nothing is sharded. ``partition_rules`` (the 'model' axis) are
ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def pick_dim(shape, n: int, taken=None) -> Optional[int]:
    """Largest dim divisible by n (ties toward the leading dim), skipping
    dims in ``taken``. None if no dim qualifies."""
    order = sorted(range(len(shape)), key=lambda i: (-shape[i], i))
    for i in order:
        if taken is not None and i in taken:
            continue
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def param_sharding(shape, placement: str, k: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is sharded on over k ranks, or
    None where it stays whole on every rank."""
    if placement not in ("replicated", "sharded"):
        raise ValueError(f"unknown placement {placement!r}")
    if placement == "replicated" or k <= 1 or not len(shape):
        return None
    return pick_dim(tuple(shape), k)


def shard(t: torch.Tensor, dim: Optional[int], rank: int,
          k: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // k
    return t.narrow(dim, rank * n, n)


def sharded_opt_init(opt_init: Callable, params: Dict[str, torch.Tensor],
                     dims: Dict[str, Optional[int]], rank: int, k: int
                     ) -> Tuple[Any, List[Optional[int]]]:
    """The optimizer state of this rank's slices, and for each state leaf
    (in ``checkpoint.flatten_leaves`` order) the dimension it is sharded
    on, or None: the leaves shaped like a sharded parameter's slice are
    its moments, sharded as it is; scalars (adam's ``count``) and the
    state of whole tensors are replicated."""
    from ps_tpu_torch.checkpoint import flatten_leaves

    state = opt_init({key: shard(p, dims[key], rank, k)
                      for key, p in params.items()})
    if all(d is None for d in dims.values()):
        return state, [None] * len(flatten_leaves(state))
    full = opt_init({key: torch.empty(p.shape, dtype=p.dtype, device="meta")
                     for key, p in params.items()})
    state_dims = []
    for got, want in zip(flatten_leaves(state).values(),
                         flatten_leaves(full).values()):
        diff = [i for i, (a, b) in enumerate(zip(got.shape, want.shape))
                if a != b]
        state_dims.append(diff[0] if diff else None)
    return state, state_dims
