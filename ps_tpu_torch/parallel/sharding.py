"""Placement policy: which slice of each parameter a rank holds and owns.

Counterpart of ``ps_tpu/parallel/sharding.py``. A leaf's placement is a
spec, one mesh axis or None a dimension (the reference's
``PartitionSpec``), chosen as the reference chooses it
(:func:`param_spec`):

- explicit ``partition_rules`` ``[(key regex, spec)]`` first, first
  match wins; a rule whose rank differs from the leaf's is skipped (an
  optimizer scalar under a matrix's rule), and a rule naming an axis the
  mesh lacks or a dimension the axis does not divide raises;
- else the heuristic: on a 'model' axis larger than 1 the largest
  dimension it divides; under 'sharded' (ZeRO-1) the largest remaining
  dimension the 'data' axis divides (ties toward the leading one). The
  two never share a dimension; a leaf no dimension of which divides
  stays whole.

What a rank keeps of a leaf follows from its spec:

- over 'model' and 'pipe' (the *slice* axes) a rank of the sync server
  *holds* only its slice of the leaf: its index's block of every such
  dimension. A leaf an explicit rule put there reaches the forward as
  that slice (the Megatron and GPipe forwards are written for it); a
  leaf the heuristic put there is all-gathered before the forward;
- over 'data' and 'seq' (the *batch* axes, which split the activations)
  a rank holds the whole dimension, which the forward needs, and *owns*
  its index's block: it steps that block and keeps its optimizer state
  (ZeRO-1), then the stepped blocks are all-gathered.

Rank r holds and owns exactly the block device r holds in the
reference, which is what checkpoints and the elastic restore rely on.
At one rank nothing is sliced.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ps_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                        SEQ_AXIS)

#: [(key regex, per-dim spec)]: spec entries are mesh axis names or None,
#: e.g. [("attn/out/kernel$", ("model", None))] for a row-parallel kernel
PartitionRules = Sequence[Tuple[Any, Tuple[Optional[str], ...]]]
Spec = Tuple[Optional[str], ...]

SLICE_AXES = (MODEL_AXIS, PIPE_AXIS)
BATCH_AXES = (DATA_AXIS, SEQ_AXIS)


def check_rules(rules) -> Optional[List[Tuple[Any, Spec]]]:
    """The rules as ``[(pattern, spec tuple)]``. A spec must be a sequence
    of axis names or None a dimension: a bare string like ``"model"``
    would become per-character junk that never matches a rank, so it is
    refused (explicit placement fails loudly)."""
    if rules is None:
        return None
    checked = []
    for p, s in rules:
        if isinstance(s, str) or not all(
                e is None or isinstance(e, str) for e in s):
            raise ValueError(
                f"partition rule {p!r}: spec must be a tuple of axis names "
                f"/ None per dim, e.g. (None, 'model') — got {s!r}")
        checked.append((p, tuple(s)))
    return checked


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


def rule_spec(mesh_shape: Dict[str, int], shape, key: str,
              rules: PartitionRules) -> Optional[Spec]:
    """The spec the first fitting rule gives ``key``, or None when no rule
    fits (the reference's ``_rule_sharding``). An axis of size 1 is
    dropped from the spec. Patterns may be strings or compiled
    regexes."""
    ndim = len(shape)
    for pattern, spec in rules:
        hit = (pattern.search(key) if hasattr(pattern, "search")
               else re.search(pattern, key))
        if not hit or len(spec) != ndim:
            continue
        out = []
        for i, ax in enumerate(spec):
            if ax is None:
                out.append(None)
                continue
            if ax not in mesh_shape:
                raise ValueError(
                    f"partition rule {pattern!r} names axis {ax!r}, not in "
                    f"mesh axes {tuple(mesh_shape)}")
            n = mesh_shape[ax]
            if n > 1 and shape[i] % n != 0:
                raise ValueError(
                    f"partition rule {pattern!r}: dim {i} of {key!r} (size "
                    f"{shape[i]}) is not divisible by axis {ax!r} (size {n})")
            out.append(ax if n > 1 else None)
        return tuple(out)
    return None


def param_spec(mesh_shape: Dict[str, int], shape, placement: str,
               key: Optional[str] = None,
               rules: Optional[PartitionRules] = None
               ) -> Tuple[Spec, bool]:
    """``(spec, ruled)`` of a leaf of ``shape`` (the reference's
    ``param_sharding``): ``ruled`` says an explicit rule placed it. At one
    rank on 'data' (or without it) ZeRO cuts nothing."""
    if placement not in ("replicated", "sharded"):
        raise ValueError(f"unknown placement {placement!r}")
    ndim = len(shape)
    if not ndim:
        return (), False
    if rules and key is not None:
        ruled = rule_spec(mesh_shape, shape, key, rules)
        if ruled is not None:
            return ruled, True
    spec: List[Optional[str]] = [None] * ndim
    taken = set()
    m = mesh_shape.get(MODEL_AXIS, 1)
    if m > 1:
        i = pick_dim(tuple(shape), m)
        if i is not None:
            spec[i] = MODEL_AXIS
            taken.add(i)
    k = mesh_shape.get(DATA_AXIS, 1)
    if placement == "sharded" and k > 1:
        i = pick_dim(tuple(shape), k, taken)
        if i is not None:
            spec[i] = DATA_AXIS
    return tuple(spec), False


def shard(t: torch.Tensor, dim: Optional[int], rank: int,
          k: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // k
    return t.narrow(dim, rank * n, n)


def block(t: torch.Tensor, spec: Spec, mesh, axes=None) -> torch.Tensor:
    """The block of ``t`` (laid out by ``spec``) that ``mesh``'s rank has,
    along the dims of the ``axes`` given (every axis of the spec by
    default): a view."""
    for d, ax in enumerate(spec):
        if ax is not None and (axes is None or ax in axes):
            t = shard(t, d, mesh.axis_index(ax), mesh.axis_size(ax))
    return t


def sharded_opt_init(opt_init: Callable, params: Dict[str, torch.Tensor],
                     specs: Dict[str, Spec], mesh, axes=None
                     ) -> Tuple[Any, List[Spec]]:
    """The optimizer state of the blocks a rank owns of ``params`` (along
    the ``axes`` given of each leaf's spec: the axes ``params`` are still
    whole on), and for each state leaf (in ``checkpoint.flatten_leaves``
    order) its spec: a leaf keyed by a parameter's key and shaped like
    its owned block is its moment, laid out as the parameter (its rule
    carries to it, as the reference's path names carry it); scalars
    (adam's ``count``) and anything else are whole."""
    from ps_tpu_torch.checkpoint import _leaf_paths

    owned = {key: block(p, specs[key], mesh, axes)
             for key, p in params.items()}
    state = opt_init(owned)
    state_specs = []
    for path, leaf in _leaf_paths(state):
        key = path[-1] if path else None
        spec = specs.get(key) if isinstance(key, str) else None
        if spec is not None and tuple(leaf.shape) == tuple(owned[key].shape):
            state_specs.append(spec)
        else:
            state_specs.append((None,) * leaf.dim())
    return state, state_specs
