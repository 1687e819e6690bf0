"""Pipeline parallelism: GPipe over a 'pipe' mesh axis.

Counterpart of ``ps_tpu/parallel/pipeline.py``. Every stage's parameters
are stacked along a leading stage dimension (:func:`stack_stage_params`)
and placed ``('pipe', ...)`` (:func:`pipeline_partition_rules`), so each
'pipe' rank holds its stage, ``[1, ...]``. :func:`make_pipeline_fn` runs
the GPipe schedule on every rank of the axis: ``M`` microbatches drain in
``M + S - 1`` ticks; at tick t stage s applies itself to microbatch
``t - s`` (stage 0 reads it from the input, the others receive it from
stage ``s - 1``) and sends its activation to stage ``s + 1``. The last
stage's outputs are broadcast to every pipe rank (the reference's
``psum`` of the masked outputs), so the loss after the trunk is the same
on each.

The schedule is one autograd Function: its backward runs the ticks in
reverse, each stage receiving its output's gradient from the next stage
(the last from the loss), taking the gradient of its stage's graph and
sending its input's gradient back; stage 0's input gradient is then
broadcast over the axis, which is the reference's transpose of an input
replicated over 'pipe' (the other stages never read it). Where the
reference's SPMD program runs every stage at every tick, a stage here
computes only its ``M`` real ticks; the outputs and gradients are the
same.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import PIPE_AXIS

def stack_stage_params(stage_params: Sequence[Any]) -> Any:
    """Stack S per-stage parameter trees (identical structure) along a new
    leading stage dimension: the tree a store registers and places
    ``('pipe', ...)``."""
    flats = [keymod.flatten_with_keys(p) for p in stage_params]
    (first, treedef) = flats[0]
    keys = list(first)
    return keymod.unflatten(
        treedef, {k: torch.stack([torch.as_tensor(f[k]) for f, _ in flats])
                  for k in keys}, keys)


def pipeline_partition_rules(max_rank: int = 4, pattern: str = ".*"):
    """Rules placing every stacked-stage leaf's LEADING dim on 'pipe' (one
    rule a rank; rank-mismatched rules are skipped by the matcher)."""
    return [(pattern, ("pipe",) + (None,) * r) for r in range(max_rank)]


def microbatch(batch: Any, microbatches: int) -> Any:
    """[B, ...] -> [M, B/M, ...] on every leaf of a tensor or a tree."""

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(
                f"batch {b} not divisible by microbatches={microbatches}")
        return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))

    if isinstance(batch, torch.Tensor):
        return split(batch)
    kv, treedef = keymod.flatten_with_keys(batch)
    return keymod.unflatten(treedef, {k: split(v) for k, v in kv.items()},
                            list(kv))


class _GPipe(torch.autograd.Function):
    """The schedule on one pipe rank: ``(x, *stage leaves) -> outputs``."""

    @staticmethod
    def forward(ctx, x, stage_fn, treedef, keys, mesh, axis, microbatches,
                *leaves):
        S, s = mesh.axis_size(axis), mesh.axis_index(axis)
        M = microbatches
        # a graph a microbatch, built here and walked in backward
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        stage = keymod.unflatten(treedef, dict(zip(keys, params)), keys)
        inputs, outputs = [], []
        out = torch.zeros_like(x)
        for t in range(M + S - 1):
            i = t - s
            if not 0 <= i < M:
                continue
            if s == 0:
                inp = x[i].detach()
            else:
                inp = x.new_empty(x.shape[1:])
                collectives.p2p(mesh, axis, recvs=[(inp, s - 1)])
            inp.requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(stage, inp)
            inputs.append(inp)
            outputs.append(y)
            if s < S - 1:
                collectives.p2p(mesh, axis, sends=[(y.detach(), s + 1)])
            else:
                out[i] = y.detach()
        collectives.broadcast(out, mesh, S - 1, axis)
        ctx.graph = (inputs, outputs, params)
        ctx.args = (mesh, axis, M, x.shape)
        return out

    @staticmethod
    def backward(ctx, g_out):
        inputs, outputs, params = ctx.graph
        mesh, axis, M, x_shape = ctx.args
        S, s = mesh.axis_size(axis), mesh.axis_index(axis)
        grads = [torch.zeros_like(p) for p in params]
        g_x = g_out.new_zeros(x_shape)
        wanted = [p for p in params if p.requires_grad]
        for t in reversed(range(M + S - 1)):
            i = t - s
            if not 0 <= i < M:
                continue
            if s == S - 1:
                g_y = g_out[i]
            else:
                g_y = outputs[i].new_empty(outputs[i].shape)
                collectives.p2p(mesh, axis, recvs=[(g_y, s + 1)])
            got = torch.autograd.grad(outputs[i], [inputs[i]] + wanted, g_y,
                                      allow_unused=True)
            g_in, g_params = got[0], iter(got[1:])
            for j, p in enumerate(params):
                if p.requires_grad:
                    g = next(g_params)
                    if g is not None:
                        grads[j] += g
            if s > 0:
                collectives.p2p(mesh, axis, sends=[(g_in, s - 1)])
            else:
                g_x[i] = g_in
        collectives.broadcast(g_x, mesh, 0, axis)
        ctx.graph = None
        return (g_x, None, None, None, None, None, None, *grads)


def make_pipeline_fn(stage_fn: Callable, mesh, *, microbatches: int,
                     axis: str = PIPE_AXIS) -> Callable:
    """Build ``fn(stacked_params, x) -> outputs``: ``stacked_params`` are
    this rank's stage of the stacked leaves (``[1, ...]``, as a store
    placing them by :func:`pipeline_partition_rules` hands them to the
    forward), ``x`` the microbatches ``[M, mb, ...]`` of this rank's
    batch (every stage gets them; stage 0 reads them), and the outputs
    ``[M, mb, ...]`` the last stage's, on every pipe rank.
    ``stage_fn(one_stage_params, activations) -> activations`` is the
    repeated block. Differentiable in ``x`` and the params. Without a
    'pipe' axis (one rank on it, or no mesh) the stacked stages, however
    many, run in turn on each microbatch."""

    def fn(stacked_params, x):
        if x.shape[0] != microbatches:
            raise ValueError(
                f"x carries {x.shape[0]} microbatches but this pipeline was "
                f"built with microbatches={microbatches} — a clamped "
                f"schedule would silently duplicate data")
        kv, treedef = keymod.flatten_with_keys(stacked_params)
        keys = list(kv)
        if mesh is None or mesh.axis_size(axis) == 1:
            stages = next(iter(kv.values())).shape[0]
            outs = []
            for i in range(microbatches):
                y = x[i]
                for s in range(stages):
                    y = stage_fn(keymod.unflatten(
                        treedef, {k: kv[k][s] for k in keys}, keys), y)
                outs.append(y)
            return torch.stack(outs)
        for k, v in kv.items():
            if v.shape[0] != 1:
                raise ValueError(
                    f"{k}: a pipe rank takes its one stage ([1, ...]), got "
                    f"{tuple(v.shape)}; place the stacked leaves with "
                    f"pipeline_partition_rules on a 'pipe' axis of "
                    f"{v.shape[0]}")
        leaves = [kv[k][0] for k in keys]
        return _GPipe.apply(x, stage_fn, treedef, keys, mesh, axis,
                            microbatches, *leaves)

    return fn
