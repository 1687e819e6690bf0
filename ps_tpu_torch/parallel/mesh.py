"""The mesh: the ranks of one process group laid out on named axes.

Counterpart of ``ps_tpu/parallel/mesh.py``. In the reference the mesh's
'data' axis is both the worker set (each device takes a slice of the
global batch) and the server set (each device owns a shard of the
parameters, their optimizer state and the embedding rows); 'model'
splits tensors (Megatron tensor parallelism), 'seq' splits the sequence
of the activations (ring and Ulysses attention) and 'pipe' holds one
pipeline stage a slice (GPipe). Here the axes are the ranks of a
``torch.distributed`` process group, one device a rank: rank r sits at
``np.unravel_index(r, shape)`` in the dict's axis order, which is the
reference's device order on the CPU (``np.asarray(devices)
.reshape(shape)``), so rank r owns what device r owns there and a
checkpoint's slices land where the reference's do.

A :class:`Mesh` holds the axis sizes, this rank's index on every axis,
one sub-group a axis (the ranks that differ from this one on that axis
alone), the whole group and the record of the collectives run over it
(:mod:`ps_tpu_torch.parallel.collectives`). ``size``, ``rank`` and
``group`` are the 'data' axis's: the worker and server set of the
servers. Without a process group the mesh is one rank and no collective
runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS)


class Mesh:
    """``shape`` (``{axis: size}``), this process's ``coords`` (its index
    on each axis), ``groups`` (one sub-group an axis; None without a
    process group), the ``world`` group of every rank and ``calls``,
    every collective run over the mesh in order. ``rank``, ``size`` and
    ``group`` are the 'data' axis's."""

    def __init__(self, shape: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None, world=None,
                 world_rank: int = 0):
        self.shape = dict(shape)
        self.shape.setdefault(DATA_AXIS, 1)
        self.coords = {axis: (coords or {}).get(axis, 0)
                       for axis in self.shape}
        self.groups = dict(groups or {})
        self.world = world
        self.world_rank = world_rank
        self.calls: List = []

    @property
    def rank(self) -> int:
        """This rank's index on the data axis."""
        return self.coords[DATA_AXIS]

    @property
    def group(self):
        """The data axis's group (None: one process, no collective)."""
        return self.groups.get(DATA_AXIS)

    @property
    def size(self) -> int:
        """Ranks on the data axis: the worker and the server count."""
        return self.shape[DATA_AXIS]

    @property
    def world_size(self) -> int:
        """Ranks on the whole mesh."""
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        """Ranks on ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def axis_group(self, axis: str):
        """The group of the ranks that differ from this one on ``axis``
        alone (None without a process group)."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no {axis!r} axis")
        return self.groups.get(axis)

    def peer(self, axis: str, index: int) -> int:
        """The global rank (``torch.distributed``'s numbering, what a send
        names) of the rank at this one's coordinates with ``axis`` set to
        ``index``."""
        coords = [self.coords[a] if a != axis else index for a in self.shape]
        r = int(np.ravel_multi_index(coords, tuple(self.shape.values())))
        import torch.distributed as dist

        if self.world is None or self.world is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.world, r)

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ('nccl' or 'gloo'), None without a group."""
        if self.world is None:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.world)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"backend={self.backend})")


def _axis_groups(shape: Dict[str, int], world_rank: int, group, dist):
    """Every axis's sub-groups, built by every rank in the same order (one
    ``new_group`` for every line of every axis; a line that spans the
    whole group is that group); returns this rank's group an axis."""
    names = list(shape)
    dims = tuple(shape.values())
    grid = np.arange(math.prod(dims)).reshape(dims)
    world = math.prod(dims)
    mine = {}
    for i, axis in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
        for line in lines:
            ranks = [int(r) for r in line]
            if len(ranks) == world:
                g = group
            else:
                if group is not dist.group.WORLD:
                    ranks = [dist.get_global_rank(group, r) for r in ranks]
                g = dist.new_group(ranks)
            if world_rank in line:
                mine[axis] = g
    return mine


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              group=None) -> Mesh:
    """A :class:`Mesh` over ``group`` (the default group when
    ``torch.distributed`` is initialized; else one rank). Default shape:
    every rank on one 'data' axis. The axes are 'data', 'model', 'seq'
    and 'pipe' in any order (the dict's order lays the ranks out), and
    the shape must cover exactly the group's ranks: a larger mesh has no
    devices to run on, and a smaller one would leave ranks outside both
    the worker and the server set. Every rank must make the call (the
    axis groups are built collectively)."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if mesh_shape is None:
        mesh_shape = {DATA_AXIS: world}
    shape = {str(k): int(v) for k, v in mesh_shape.items()}
    if any(s < 1 for s in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {mesh_shape}")
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are unknown; a mesh "
                         f"has the axes {AXES}")
    shape.setdefault(DATA_AXIS, 1)
    needed = math.prod(shape.values())
    if needed != world:
        raise ValueError(
            f"mesh shape {mesh_shape} needs {needed} devices (one a rank), "
            f"and the process group has {world} rank(s)")
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(
        rank, tuple(shape.values())))))
    if group is None:
        return Mesh(shape, coords=coords)
    groups = _axis_groups(shape, rank, group, dist)
    return Mesh(shape, coords=coords, groups=groups, world=group,
                world_rank=rank)


def parse_mesh(spec: str) -> Dict[str, int]:
    """Parse a CLI mesh string like ``"data=2,seq=4"`` into the ``{axis:
    size}`` dict :func:`make_mesh` takes (the reference's one spelling)."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"bad mesh component {part!r}; want axis=size")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    return out
