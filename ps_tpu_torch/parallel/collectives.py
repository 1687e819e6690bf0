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

Every wrapper runs over one axis of the mesh (``axis=``, 'data' by
default: the servers' worker and server set), over that axis's group,
and records the axis with its call. Beside the four reductions:
``ppermute`` (each rank sends to a neighbour on the axis and receives
from another, by ``batch_isend_irecv``; the reference's
``lax.ppermute``), ``broadcast`` from one index of the axis, and
``all_to_all`` with a split and a concat dimension (``lax.all_to_all``
with ``tiled=True``: Ulysses's sequence-heads swap). Where a collective
sits inside a model, an autograd Function carries its backward:
:func:`ppermute_grad` (the reverse permute), Megatron's ``f``
(:func:`copy_to_axis`: identity forward, all-reduce backward) and ``g``
(:func:`reduce_from_axis`: the reverse), the activation gather
(:func:`gather_from_axis`, whose backward keeps this rank's slice) and
its reverse (:func:`split_to_axis`), and :func:`all_to_all_grad` (the
reverse swap).

A mesh without a process group (one process) runs no collective and
records none: each wrapper returns its input. With a group, every
wrapper calls the op, at world size 1 too, where it moves 0 bytes.

NCCL takes CUDA tensors, gloo CPU tensors and, in the torch builds
probed (2.13 on the CPU; 2.11+cu128 on an H100, all four reductions on
CUDA tensors across two ranks), CUDA tensors too for the reductions,
staging them through host memory inside the op. Its point-to-point
sends take CPU tensors only, so ``ppermute`` over a gloo group copies a
CUDA tensor to host memory, sends and receives there, and copies the
result back to the card: the compute stays on the card, and a group
never changes its backend on its own.
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
    all-gather's output, all-to-all's, ppermute's and broadcast's
    input), the per-rank ``ring_bytes`` of the algebra above (ppermute
    and broadcast: the tensor once) and the mesh ``axis`` it ran over."""

    op: str
    shape: tuple
    nbytes: int
    ring_bytes: int
    axis: str = "data"


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


def _once_bytes(tree: Any, axis_size: int) -> int:
    return tree_bytes(tree) if axis_size > 1 else 0


_RING = {"all_reduce": allreduce_bytes,
         "reduce_scatter": reduce_scatter_bytes,
         "all_gather": all_gather_bytes, "all_to_all": all_to_all_bytes,
         "ppermute": _once_bytes, "p2p": _once_bytes,
         "broadcast": _once_bytes}


def _record(mesh, op: str, full: torch.Tensor, axis: str) -> None:
    mesh.calls.append(Call(op, tuple(full.shape), _leaf_bytes(full),
                           _RING[op](full, mesh.axis_size(axis)), axis))


def _group(mesh, axis: str):
    """``axis``'s group, None where the mesh has no such axis or no process
    group (then no collective runs)."""
    return mesh.groups.get(axis) if axis in mesh.shape else None


def _split(t: torch.Tensor, dim: int, k: int, op: str) -> int:
    if t.dim() == 0 or t.shape[dim] % k:
        raise ValueError(f"{op}: dim {dim} of shape {tuple(t.shape)} does "
                         f"not split into {k} equal parts")
    return t.shape[dim] // k


def all_reduce(t: torch.Tensor, mesh, op: str = "sum",
               axis: str = "data") -> torch.Tensor:
    """Reduce ``t`` over the mesh's ``axis`` in place ('sum' or 'max');
    returns it."""
    group = _group(mesh, axis)
    if group is None:
        return t
    import torch.distributed as dist

    _record(mesh, "all_reduce", t, axis)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def reduce_scatter(full: torch.Tensor, mesh,
                   axis: str = "data") -> torch.Tensor:
    """The sum over the ranks of ``axis`` of ``full`` [k·n, ...], this
    rank's part [n, ...] (index r gets rows r·n to (r+1)·n)."""
    group = _group(mesh, axis)
    if group is None:
        return full
    import torch.distributed as dist

    n = _split(full, 0, mesh.axis_size(axis), "reduce_scatter")
    full = full.contiguous()
    out = full.new_empty((n,) + tuple(full.shape[1:]))
    _record(mesh, "reduce_scatter", full, axis)
    dist.reduce_scatter_tensor(out, full, group=group)
    return out


def all_gather(part: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every ``axis`` rank's ``part`` [n, ...] in index order: [k·n, ...]."""
    group = _group(mesh, axis)
    if group is None:
        return part
    import torch.distributed as dist

    part = part.contiguous()
    out = part.new_empty((mesh.axis_size(axis) * part.shape[0],)
                         + tuple(part.shape[1:]))
    _record(mesh, "all_gather", out, axis)
    dist.all_gather_into_tensor(out, part, group=group)
    return out


def all_to_all(t: torch.Tensor, mesh, split_dim: int = 0,
               concat_dim: int = 0, axis: str = "data") -> torch.Tensor:
    """``t`` cut into k equal parts along ``split_dim``; part j goes to
    index j of ``axis``, and the parts every rank sent here are joined in
    index order along ``concat_dim`` (``lax.all_to_all(..., tiled=True)``;
    the default dims are a plain exchange of dim-0 blocks)."""
    group = _group(mesh, axis)
    if group is None:
        return t
    import torch.distributed as dist

    k = mesh.axis_size(axis)
    _split(t, split_dim, k, "all_to_all")
    if split_dim == 0:
        send = t.contiguous()
    else:
        send = torch.stack(t.chunk(k, dim=split_dim)).contiguous()
    out = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    _record(mesh, "all_to_all", t, axis)
    dist.all_to_all_single(out, send, group=group)
    if split_dim == 0:
        out = out.view(t.shape) if concat_dim == 0 else out.view(
            (k, -1) + tuple(t.shape[1:]))
        if concat_dim == 0:
            return out
    else:
        out = out.view((k,) + tuple(send.shape[1:]))
    return torch.cat(out.unbind(0), dim=concat_dim)


def p2p(mesh, axis: str, sends=(), recvs=(), op: str = "p2p") -> None:
    """Sends of ``(tensor, index)`` to, and receives of ``(tensor, index)``
    from, ranks of ``axis``, all issued together (``batch_isend_irecv``)
    and waited for; each receive fills its tensor. Gloo's sends take CPU
    tensors only, so over gloo a CUDA tensor is sent from, and received
    into, host memory (the module docstring says why). Each send is
    recorded as ``op``."""
    import torch.distributed as dist

    group = _group(mesh, axis)
    staged = mesh.backend == "gloo"

    def host(t):
        return t.cpu() if staged and t.device.type != "cpu" else t

    ops, back = [], []
    for t, index in sends:
        _record(mesh, op, t, axis)
        ops.append(dist.P2POp(dist.isend, host(t).contiguous(),
                              mesh.peer(axis, index), group))
    for t, index in recvs:
        buf = host(t)
        if buf is not t:
            back.append((buf, t))
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis, index),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, t in back:
        t.copy_(buf)


def ppermute(t: torch.Tensor, mesh, perm, axis: str) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: ``perm`` lists ``(src, dst)`` index
    pairs; this rank sends ``t`` to each dst its index is the src of and
    returns what its src sent (zeros where no pair names this rank as a
    dst), by :func:`p2p`."""
    me = mesh.axis_index(axis)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: index {me} receives from {srcs}")
    if mesh.axis_size(axis) == 1 or _group(mesh, axis) is None:
        return t.clone() if srcs else torch.zeros_like(t)
    recv = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
    p2p(mesh, axis, [(t, d) for d in dsts], [(recv, s) for s in srcs],
        op="ppermute")
    return recv


def broadcast(t: torch.Tensor, mesh, src: int, axis: str) -> torch.Tensor:
    """``t`` of index ``src`` of ``axis`` on every rank of the axis, in
    place; returns it (as it is on an axis of one rank)."""
    if mesh.axis_size(axis) == 1 or _group(mesh, axis) is None:
        return t
    group = _group(mesh, axis)
    import torch.distributed as dist

    _record(mesh, "broadcast", t, axis)
    dist.broadcast(t, mesh.peer(axis, src), group=group)
    return t


# -- the differentiable collectives of a model's forward ---------------------------


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, perm, axis):
        ctx.args = (mesh, [(d, s) for s, d in perm], axis)
        return ppermute(t, mesh, perm, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, inverse, axis = ctx.args
        return ppermute(g.contiguous(), mesh, inverse, axis), None, None, None


def ppermute_grad(t: torch.Tensor, mesh, perm, axis: str) -> torch.Tensor:
    """:func:`ppermute` whose backward is the reverse permute."""
    return _PPermute.apply(t, mesh, perm, axis)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce(g.contiguous().clone(), mesh, axis=axis), None, None


def copy_to_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's ``f``: identity forward, the gradient all-reduced over
    ``axis`` backward (enters a region whose ranks each use ``t`` for
    their slice of the work)."""
    return _CopyToAxis.apply(t, mesh, axis)


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.contiguous().clone(), mesh, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's ``g``: the partial sums all-reduced over ``axis``
    forward, identity backward (leaves a row-parallel region)."""
    return _ReduceFromAxis.apply(t, mesh, axis)


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(t.movedim(dim, 0), mesh, axis=axis).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        k, r = mesh.axis_size(axis), mesh.axis_index(axis)
        n = g.shape[dim] // k
        return g.narrow(dim, r * n, n), None, None, None


def gather_from_axis(t: torch.Tensor, mesh, axis: str,
                     dim: int) -> torch.Tensor:
    """Every ``axis`` rank's ``t`` joined along ``dim`` forward; this
    rank's slice of the gradient backward. For an activation the ranks of
    the axis go on to use alike, so their gradients of the whole are the
    same and each keeps its own slice's."""
    return _GatherFromAxis.apply(t, mesh, axis, dim)


class _SplitToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        k, r = mesh.axis_size(axis), mesh.axis_index(axis)
        n = t.shape[dim] // k
        return t.narrow(dim, r * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (all_gather(g.movedim(dim, 0), mesh, axis=axis).movedim(0, dim),
                None, None, None)


def split_to_axis(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` forward; every rank's slice
    gradient joined backward. For an activation the ranks of the axis
    hold alike and each feeds its slice to a row-parallel layer: the
    whole's gradient is the join of the slices'."""
    return _SplitToAxis.apply(t, mesh, axis, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, split_dim, concat_dim, axis):
        ctx.args = (mesh, split_dim, concat_dim, axis)
        return all_to_all(t, mesh, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, split_dim, concat_dim, axis = ctx.args
        return (all_to_all(g, mesh, concat_dim, split_dim, axis), None, None,
                None, None)


def all_to_all_grad(t: torch.Tensor, mesh, split_dim: int, concat_dim: int,
                    axis: str) -> torch.Tensor:
    """:func:`all_to_all` whose backward is the reverse swap."""
    return _AllToAll.apply(t, mesh, split_dim, concat_dim, axis)
