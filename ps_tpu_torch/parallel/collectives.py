"""Byte-accounted collectives over a :class:`~ps_tpu_torch.parallel.mesh.Mesh`.

Counterpart of ``ps_tpu/parallel/collectives.py``: the same analytic
per-device byte algebra from the textbook ring costs for a tensor of N
bytes over a k-rank axis,

- all-reduce:     2 · N · (k-1) / k
- reduce-scatter:     N · (k-1) / k
- all-gather:         N · (k-1) / k
- all-to-all:         N · (k-1) / k

and, beside it, thin wrappers over ``torch.distributed``'s
``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_into_tensor`` and
``all_to_all_single``. Where the reference reads which collectives a step
ran off its compiled HLO (``tests/test_hlo_collectives.py``), each
wrapper here appends a :class:`Call` (op, the full tensor's shape and
bytes, the ring bytes) to ``mesh.calls``, so a test can assert what a step
ran. The reduce-scatter, all-gather and all-to-all split along dim 0 in
k equal parts; a caller sharded on another dimension moves it to the
front first (:mod:`ps_tpu_torch.parallel.sharding`).

A mesh without a process group (one process) runs no collective and
records none: each wrapper returns its input. With a group, every
wrapper calls the op, at world size 1 too, where it moves 0 bytes.

NCCL takes CUDA tensors, gloo CPU tensors and, in the torch builds
probed (2.13 on the CPU; 2.11+cu128 on an H100, all four ops on CUDA
tensors across two ranks), CUDA tensors too, staging them through host
memory inside the op. So no op is staged here by hand, and a group never
changes its backend on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Call:
    """One collective run over a mesh: ``op``, the full tensor's ``shape``
    and ``nbytes`` (all-reduce's tensor, reduce-scatter's input,
    all-gather's output, all-to-all's input) and the per-rank
    ``ring_bytes`` of the algebra above."""

    op: str
    shape: tuple
    nbytes: int
    ring_bytes: int


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(np.shape(x))) * np.dtype(x.dtype).itemsize


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total payload bytes of a tree of tensors or arrays."""
    return sum(_leaf_bytes(x) for x in _leaves(tree))


def allreduce_bytes(tree: Any, axis_size: int) -> int:
    """Per-device bytes of an all-reduce of this tree over axis_size."""
    if axis_size <= 1:
        return 0
    return int(2 * tree_bytes(tree) * (axis_size - 1) / axis_size)


def reduce_scatter_bytes(tree: Any, axis_size: int) -> int:
    if axis_size <= 1:
        return 0
    return int(tree_bytes(tree) * (axis_size - 1) / axis_size)


def all_gather_bytes(tree: Any, axis_size: int) -> int:
    if axis_size <= 1:
        return 0
    return int(tree_bytes(tree) * (axis_size - 1) / axis_size)


def all_to_all_bytes(tree: Any, axis_size: int) -> int:
    if axis_size <= 1:
        return 0
    return int(tree_bytes(tree) * (axis_size - 1) / axis_size)


_RING = {"all_reduce": allreduce_bytes,
         "reduce_scatter": reduce_scatter_bytes,
         "all_gather": all_gather_bytes, "all_to_all": all_to_all_bytes}


def _record(mesh, op: str, full: torch.Tensor) -> None:
    mesh.calls.append(Call(op, tuple(full.shape), _leaf_bytes(full),
                           _RING[op](full, mesh.size)))


def _split_dim0(t: torch.Tensor, k: int, op: str) -> int:
    if t.dim() == 0 or t.shape[0] % k:
        raise ValueError(f"{op}: dim 0 of shape {tuple(t.shape)} does not "
                         f"split into {k} equal parts")
    return t.shape[0] // k


def all_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the mesh in place ('sum' or 'max'); returns it."""
    if mesh.group is None:
        return t
    import torch.distributed as dist

    _record(mesh, "all_reduce", t)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=mesh.group)
    return t


def reduce_scatter(full: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``full`` [k·n, ...], this rank's part
    [n, ...] (rank r gets rows r·n to (r+1)·n)."""
    if mesh.group is None:
        return full
    import torch.distributed as dist

    n = _split_dim0(full, mesh.size, "reduce_scatter")
    full = full.contiguous()
    out = full.new_empty((n,) + tuple(full.shape[1:]))
    _record(mesh, "reduce_scatter", full)
    dist.reduce_scatter_tensor(out, full, group=mesh.group)
    return out


def all_gather(part: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``part`` [n, ...] in rank order: [k·n, ...]."""
    if mesh.group is None:
        return part
    import torch.distributed as dist

    part = part.contiguous()
    out = part.new_empty((mesh.size * part.shape[0],)
                         + tuple(part.shape[1:]))
    _record(mesh, "all_gather", out)
    dist.all_gather_into_tensor(out, part, group=mesh.group)
    return out


def all_to_all(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` [k·n, ...] cut into k parts along dim 0; part j goes to rank
    j, and the result holds, in rank order, the part every rank sent
    here."""
    if mesh.group is None:
        return t
    import torch.distributed as dist

    _split_dim0(t, mesh.size, "all_to_all")
    t = t.contiguous()
    out = torch.empty_like(t)
    _record(mesh, "all_to_all", t)
    dist.all_to_all_single(out, t, group=mesh.group)
    return out
