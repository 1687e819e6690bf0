"""The mesh: the ranks of one process group on one 'data' axis.

Counterpart of ``ps_tpu/parallel/mesh.py``. In the reference the mesh's
'data' axis is both the worker set (each device takes a slice of the
global batch) and the server set (each device owns a shard of the
parameters, their optimizer state and the embedding rows). Here that
axis is the k ranks of a ``torch.distributed`` process group, one device
a rank. A :class:`Mesh` holds the axis sizes, this rank's index, the
group and the record of the collectives run over it
(:mod:`ps_tpu_torch.parallel.collectives`).

Without a process group the mesh is one rank and no collective runs. A
'model' axis larger than 1 (tensor parallelism) is ROADMAP Queue 1
item 7 and raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """``shape`` (``{axis: size}``), this process's ``rank`` on the data
    axis, the process ``group`` (None: one process, no collective) and
    ``calls``, every collective run over the group in order."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, group=None):
        self.shape = dict(shape)
        self.rank = rank
        self.group = group
        self.calls: List = []

    @property
    def size(self) -> int:
        """Ranks on the data axis: the worker and the server count."""
        return self.shape[DATA_AXIS]

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ('nccl' or 'gloo'), None without a group."""
        if self.group is None:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              group=None) -> Mesh:
    """A :class:`Mesh` over ``group`` (the default group when
    ``torch.distributed`` is initialized; else one rank). Default shape:
    every rank on one 'data' axis. The shape must cover exactly the
    group's ranks: a larger mesh has no devices to run on, and a smaller
    one would leave ranks outside both the worker and the server set."""
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
    unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not ported; the "
                         f"mesh has a '{DATA_AXIS}' axis (and a "
                         f"'{MODEL_AXIS}' axis of size 1)")
    if shape.get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            f"a '{MODEL_AXIS}' axis of size {shape[MODEL_AXIS]} (tensor "
            f"parallelism) is not ported yet (ROADMAP Queue 1 item 7)")
    shape.setdefault(DATA_AXIS, 1)
    needed = math.prod(shape.values())
    if needed != world:
        raise ValueError(
            f"mesh shape {mesh_shape} needs {needed} devices (one a rank), "
            f"and the process group has {world} rank(s)")
    return Mesh(shape, rank, group)


def parse_mesh(spec: str) -> Dict[str, int]:
    """Parse a CLI mesh string like ``"data=2"`` into the ``{axis: size}``
    dict :func:`make_mesh` takes (the reference's one spelling)."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"bad mesh component {part!r}; want axis=size")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    return out

