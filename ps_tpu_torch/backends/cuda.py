"""The 'cuda' backend: a parameter server on one device or across the
ranks of a ``torch.distributed`` process group.

Counterpart of ``ps_tpu/backends/tpu.py``:

- ``CudaServer`` (``TpuServer``): the parameter dict ``{key: tensor}``
  and one whole-tree optimizer state. Each rank takes the gradient of its
  slice of the global batch; the server reduces the gradients over the
  ranks and applies them. 'replicated': one all-reduce of every gradient
  (a flat buffer a dtype), the mean over ranks, and the whole apply on
  every rank. 'sharded' (ZeRO-1): each leaf that
  :mod:`~ps_tpu_torch.parallel.sharding` shards is reduce-scattered, so
  a rank receives the mean gradient of the slice it owns, steps that
  slice and its slice of the optimizer state, and all-gathers the
  parameter; the rest is all-reduced and applied whole. ``make_step``
  updates the server's tensors in place (in place replaces the
  reference's donation). The per-key protocol stages pushes until the
  whole tree is there and then runs ``update_tree``, which, like
  ``push_pull``, applies out of place, so a tensor a caller pulled keeps
  its values, as the reference's undonated apply keeps them.
  ``collective_bytes`` follows the reference's ``_account_update``.
- ``AsyncCudaServer`` (``AsyncTpuServer``): mode='async', the local
  backend's async semantics (stale apply with the DC-ASGD correction,
  tree-granularity versions, per-worker staging of per-key pushes) with
  one optimizer state a key, out of place, behind one lock so host
  threads can drive workers concurrently in one process. Across ranks a
  logical worker's push is this rank's gradient and the server applies
  its mean over the ranks, placed as the sync server places it: each
  rank corrects and steps the slices it owns, against the same slices of
  the pusher's stale snapshot, and all-gathers them ('sharded'), or the
  whole tree ('replicated'). Versions, staleness and apply counts are
  the same on every rank; host threads are refused there, since each
  rank's lock would order the pushes differently and the collectives
  would pair different pushes.
- Under 'sharded' (or rules) LAMB takes its trust ratio's norms of
  whole tensors (``optim.ShardNorms``): ``‖p‖`` of the whole parameter,
  which a rank holds unless a 'model' or 'pipe' axis slices it (then its
  ``Σp²`` is summed over those axes), and ``‖u‖`` from the blocks'
  ``Σu²`` summed over every axis the leaf is cut on, in one all-reduce of
  a flat tensor an axis a step (a push on the async server, which keeps
  one state a key and defers every sliced key's trust step to the end of
  the tree). Those all-reduces are recorded in ``mesh.calls``;
  ``collective_bytes`` does not count them, as the reference's XLA
  inserts them uncounted.
- ``CudaBackend`` (``TpuBackend``): ``init(backend='cuda')``. With a
  ``coordinator_uri`` it joins a process group of ``num_processes`` ranks
  (NCCL on CUDA devices, gloo on the CPU or when ``dist_backend`` names
  it) and builds the mesh over it.

Both servers checkpoint (``ps_tpu_torch/checkpoint.py``): engine
``cuda_sync`` saves the params, the whole-tree state, ``apply_count`` and
``collective_bytes``, each rank its own slices; engine ``cuda_async``
also the stale snapshots and the version vector. Each refuses to save
mid-step and holds its lock across a save or a restore.

With ``Config.heartbeat_peers()`` set and more than one process, the
backend also runs the heartbeat failure detector of ``control/`` on this
rank's port: ``check_health()`` raises ``WorkerFailureError`` naming a
dead rank, and ``shutdown(abort=True)`` is the exit after it.

Placement over a mesh of several axes ('data', 'model', 'seq', 'pipe';
:mod:`~ps_tpu_torch.parallel.sharding`): both servers take the
reference's ``partition_rules`` and its heuristic. The sync server holds
only a rank's 'model' and 'pipe' slices of a leaf: a leaf a rule placed
there reaches the forward as that slice (Megatron and GPipe forwards),
one the heuristic placed there is all-gathered before the forward, and
``pull``/``peek`` return whole tensors. Gradients are summed over 'seq'
and meaned over 'data', never reduced over 'model' or 'pipe'. The async
server holds every leaf whole and steps its blocks under the spec.

The async server's elastic hooks (``elastic/``, the live key-range
moves of ``backends/remote_async.py``): ``export_keys`` copies whole
rows off the card (parameter, the key's optimizer state under the
reference's leaf paths, every worker's stale snapshot, the apply count),
``adopt_key`` installs one on the engine's device as ``register_tree``
places a key, ``evict_keys`` drops rows (their staged per-key pushes
too), and ``push_subtree`` applies a subset of the keys, what a replay
straddling a move owes. Across ranks a row's parameter and stale
snapshots are whole on every rank; ``export_keys`` all-gathers the owned
blocks of its optimizer state (every rank makes the call), and
``adopt_key`` keeps this rank's blocks of the whole leaves a row
carries.

Served across ranks (``backends/op_stream.py``): rank 0's van service
sends every engine call to the other ranks first, so every rank makes
the same calls in one order from its own thread (rank 0's service
threads under the engine lock), and a push is the global gradient the
worker sent: each rank steps its owned blocks of it, with no mean over
the ranks.
"""

from __future__ import annotations

import collections
import datetime
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ps_tpu_torch.backends.common import (
    AGG_WORKER_BASE,
    AsyncStagingMixin,
    backend_device,
    device_copy,
    make_dc_apply_tree,
    stage_to_host,
)
from ps_tpu_torch.checkpoint import (CheckpointMixin, flatten_leaves,
                                     keep_worker, state_from_reference,
                                     state_to_reference, unflatten_like)
from ps_tpu_torch.config import Config
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.ops.sparse_apply import resolve_tier
from ps_tpu_torch.optim import ShardNorms
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import (AXES, DATA_AXIS, SEQ_AXIS, Mesh,
                                        make_mesh)
from ps_tpu_torch.parallel.sharding import (BATCH_AXES, SLICE_AXES, block,
                                            param_spec, sharded_opt_init)

# a rendezvous or a collective that does not complete fails after this
# many seconds instead of hanging
GROUP_TIMEOUT_S = 600


def _data_dims(specs) -> List[Optional[int]]:
    """Each spec's 'data' dimension, or None."""
    return [spec.index(DATA_AXIS) if DATA_AXIS in spec else None
            for spec in specs]


class _RankApplyMixin:
    """The apply across the ranks of ``self.mesh`` that both servers share.

    ``self._specs`` maps each key to its spec (:mod:`~ps_tpu_torch.
    parallel.sharding`), ``self._ruled`` says which an explicit rule gave,
    ``self._whole`` holds each key's whole shape (meta tensors) and
    ``self._params`` what the rank holds: the block of each leaf along the
    engine's ``_held_axes`` (the sync server's 'model' and 'pipe'; none
    on the async server, whose pulls are whole). A rank steps the block
    it owns along the rest of the spec's axes. ``self._dims`` keeps each
    key's 'data' dimension (ZeRO-1), or None."""

    _held_axes: tuple = ()

    @property
    def _owned_axes(self) -> tuple:
        return tuple(a for a in AXES if a not in self._held_axes)

    def _place(self, key: str, v, rules) -> torch.Tensor:
        """Choose ``key``'s spec and return the block of ``v`` this rank
        holds (a tensor of its own on the engine's device)."""
        t = device_copy(v, self.device)
        spec, ruled = param_spec(self.mesh.shape, tuple(t.shape),
                                 self.placement, key, rules)
        self._specs[key], self._ruled[key] = spec, ruled
        self._whole[key] = torch.empty(t.shape, dtype=t.dtype, device="meta")
        self._dims[key] = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        held = block(t, spec, self.mesh, self._held_axes)
        return t if held is t else held.clone()

    def _to_held(self, key: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient of ``key`` as the block this rank holds: a whole
        tensor's block (the forward used the leaf whole) or the held block
        as it is (the forward used that slice)."""
        held = tuple(self._params[key].shape)
        if tuple(g.shape) == held:
            return g
        if tuple(g.shape) == tuple(self._whole[key].shape):
            return block(g, self._specs[key], self.mesh, self._held_axes)
        raise ValueError(f"gradient of {key!r} has shape {tuple(g.shape)}; "
                         f"this rank holds {held} of "
                         f"{tuple(self._whole[key].shape)}")

    def _reduce(self, grads_kv: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """This rank's gradients -> what it steps: summed over 'seq' (its
        ranks hold partial gradients of the same parameters), then meaned
        over 'data'; a leaf cut on such an axis is reduce-scattered there
        (moved to the front), so the rank receives the block it owns, and
        the rest is all-reduced (one flat buffer a dtype). Over 'model'
        and 'pipe' nothing is reduced: a leaf sliced there has its
        block's own gradient on each rank, and a leaf whole there the
        same gradient on each."""
        mesh = self.mesh
        grads = {key: self._to_held(key, g) for key, g in grads_kv.items()}
        if mesh.world is None:
            return grads
        for axis in (SEQ_AXIS, DATA_AXIS):
            if axis not in mesh.shape or (axis != DATA_AXIS
                                          and mesh.shape[axis] == 1):
                continue
            k = mesh.axis_size(axis)
            mean = axis == DATA_AXIS and k > 1
            whole: Dict[torch.dtype, List[str]] = {}
            for key, g in grads.items():
                spec = self._specs[key]
                if axis not in spec:
                    whole.setdefault(g.dtype, []).append(key)
                    continue
                d = spec.index(axis)
                part = collectives.reduce_scatter(g.movedim(d, 0), mesh,
                                                  axis=axis)
                if mean:
                    part.div_(k)
                grads[key] = part.movedim(0, d)
            for keys in whole.values():
                flat = torch.cat([grads[key].reshape(-1) for key in keys])
                collectives.all_reduce(flat, mesh, axis=axis)
                if mean:
                    flat.div_(k)
                sizes = [grads[key].numel() for key in keys]
                for key, part in zip(keys, flat.split(sizes)):
                    grads[key] = part.view(grads[key].shape)
        rest = tuple(a for a in self._owned_axes if a not in BATCH_AXES)
        return {key: block(g, self._specs[key], mesh, rest)
                for key, g in grads.items()}

    def _owned(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a held tensor of ``key`` (a view)."""
        return block(t, self._specs[key], self.mesh, self._owned_axes)

    def _norms(self, params: Dict[str, torch.Tensor]
               ) -> Optional[ShardNorms]:
        """What LAMB needs to step blocks of ``params`` (held tensors):
        None where nothing is cut."""
        whole, p_axes, u_axes = {}, {}, {}
        for key, p in params.items():
            cut = tuple(a for a in AXES if a in self._specs[key])
            if cut:
                whole[key] = p
                p_axes[key] = tuple(a for a in cut if a in self._held_axes)
                u_axes[key] = cut
        if not whole:
            return None
        return ShardNorms(whole, self._norm_all_reduce, p_axes, u_axes)

    def _norm_all_reduce(self, flat: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over one axis's ranks of the cut leaves' partial
        ``Σu²`` (and ``Σp²``)."""
        return collectives.all_reduce(flat, self.mesh, axis=axis)

    def _gather(self, key: str, owned: torch.Tensor) -> torch.Tensor:
        """Every rank's stepped block of ``key``, joined into what this
        rank holds (a fresh tensor; ``owned`` itself where ``key`` is not
        cut)."""
        return self._join(key, owned, self._owned_axes)

    def _join(self, key: str, t: torch.Tensor, axes) -> torch.Tensor:
        for d, ax in enumerate(self._specs[key]):
            if ax is not None and ax in axes:
                t = collectives.all_gather(t.movedim(d, 0), self.mesh,
                                           axis=ax).movedim(0, d)
        return t

    def _join_many(self, held: Dict[str, torch.Tensor], axes
                   ) -> Dict[str, torch.Tensor]:
        """:meth:`_join` of several keys at once: over each of ``axes``,
        one all-gather of a flat buffer a dtype holding every key cut
        there (fresh tensors; the inputs where the mesh has no process
        group)."""
        out = dict(held)
        mesh = self.mesh
        if mesh.world is None:
            return out
        for ax in axes:
            k = mesh.axis_size(ax)
            by_dtype: Dict[torch.dtype, List[str]] = {}
            for key, t in out.items():
                if ax in self._specs[key]:
                    by_dtype.setdefault(t.dtype, []).append(key)
            for keys in by_dtype.values():
                dims = [self._specs[key].index(ax) for key in keys]
                moved = [out[key].movedim(d, 0) for key, d in zip(keys, dims)]
                flat = torch.cat([m.reshape(-1) for m in moved])
                full = collectives.all_gather(flat, mesh, axis=ax).view(k, -1)
                off = 0
                for key, d, m in zip(keys, dims, moved):
                    part = full[:, off:off + m.numel()]
                    out[key] = part.reshape((k * m.shape[0],)
                                            + tuple(m.shape[1:])).movedim(0, d)
                    off += m.numel()
        return out

    def _whole_of(self, key: str, held: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``key`` from this rank's held block (a
        collective over the held axes; ``held`` itself where none)."""
        return self._join(key, held, self._held_axes)

    def peek(self, key: str) -> torch.Tensor:
        """The whole current value of ``key`` (every rank must make the
        call where the leaf is held in slices)."""
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        return self._whole_of(key, self._params[key])


class CudaServer(_RankApplyMixin, CheckpointMixin):
    """Parameter/optimizer-state store with PS semantics over a mesh.

    ``apply_count`` counts whole-tree applies (``update_tree`` and every
    fused step), as the reference's does; ``collective_bytes`` adds each
    apply's analytic per-rank bytes (0 at one rank)."""

    mode = "sync"
    engine_name = "cuda_sync"
    _held_axes = SLICE_AXES

    def __init__(self, optimizer, device: torch.device,
                 aggregate: str = "mean", mesh: Optional[Mesh] = None,
                 placement: str = "replicated", partition_rules=None):
        if aggregate not in ("mean", "sum"):
            raise ValueError("aggregate must be 'mean' or 'sum'")
        self._opt = optimizer
        self.device = device
        self.aggregate = aggregate
        self.mesh = mesh if mesh is not None else Mesh({"data": 1})
        self.placement = placement
        self.partition_rules = partition_rules
        self.num_workers = self.mesh.size
        self._params: Dict[str, torch.Tensor] = {}
        self._state = None
        self._specs: Dict[str, tuple] = {}
        self._ruled: Dict[str, bool] = {}
        self._whole: Dict[str, torch.Tensor] = {}
        self._dims: Dict[str, Optional[int]] = {}
        self._state_specs: List[tuple] = []
        self._state_dims: List[Optional[int]] = []
        self._staged: Dict[str, torch.Tensor] = {}
        # (the held dict it was made from, the forward's tree): tree()
        self._fwd = None
        self.apply_count = 0
        self.collective_bytes = 0

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        """Register the parameters: each rank keeps the block it holds of
        each (its 'model' and 'pipe' slices) and the optimizer state of
        the block it owns. Every rank registers the same whole values (the
        reference asserts as much across processes)."""
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        self._params = {key: self._place(key, v, self.partition_rules)
                        for key, v in kv.items()}
        self._state, self._state_specs = sharded_opt_init(
            self._opt.init, self._params, self._specs, self.mesh,
            BATCH_AXES)
        self._state_dims = _data_dims(self._state_specs)
        return keymod.unflatten(treedef, self.tree(), key_order)

    def keys(self):
        return list(self._params)

    @property
    def grad_scale(self) -> float:
        """Aggregation factor on incoming global-mean grads: 1 for 'mean',
        num_workers for 'sum'."""
        return float(self.num_workers) if self.aggregate == "sum" else 1.0

    # -- the apply across ranks -----------------------------------------------

    def _apply_(self, params: Dict[str, torch.Tensor],
                grads_kv: Dict[str, torch.Tensor]) -> None:
        """Reduce this rank's ``grads_kv`` over the ranks and step
        ``params`` (the held tensors) in place: each rank steps the blocks
        it owns, then the blocks cut over 'data' or 'seq' are
        all-gathered."""
        grads = self._reduce(grads_kv)
        scale = self.grad_scale
        if scale != 1.0:
            grads = {key: g * scale for key, g in grads.items()}
        owned = {key: self._owned(key, p) for key, p in params.items()}
        norms = self._norms(params)
        self._opt.step_(owned, grads, self._state, norms)
        if norms is not None:
            norms.finish()
        for key, spec in self._specs.items():
            if any(a in spec for a in self._owned_axes):
                params[key].copy_(self._gather(key, owned[key]))
        self.apply_count += 1
        self._account_update()

    def _account_update(self):
        # the reference's count: the whole tree's bytes over the data axis
        k = self.num_workers
        if self.placement == "replicated":
            # grads were all-reduced across the data axis
            self.collective_bytes += collectives.allreduce_bytes(
                self._whole, k)
        else:
            # reduce-scatter grads to owners + all-gather params
            self.collective_bytes += collectives.reduce_scatter_bytes(
                self._whole, k)
            self.collective_bytes += collectives.all_gather_bytes(
                self._whole, k)

    def update_tree(self, grads_kv: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One server step on this rank's grads (their mean over the ranks
        is applied); returns the new params, whole. Out of place: tensors
        pulled before keep their values."""
        grads_kv = {k: torch.as_tensor(g, device=self.device)
                    for k, g in grads_kv.items()}
        params = {k: p.clone() for k, p in self._params.items()}
        self._apply_(params, grads_kv)
        self._params = params
        return {k: self._whole_of(k, p) for k, p in self._params.items()}

    def step_(self, grads_kv: Dict[str, torch.Tensor]) -> None:
        """The fused step's apply: this rank's grads (of the tensors
        :meth:`tree` gave) reduced over the ranks and applied to the
        server's own tensors in place; the whole leaves :meth:`tree`
        gathered are gathered again into the same tensors, so every tree
        it gave holds the new values."""
        self._apply_(self._params, grads_kv)
        if self._fwd is not None and self._fwd[0] is self._params:
            fwd = self._fwd[1]
            for key, t in self._gathered().items():
                fwd[key].copy_(t)

    def _gathered(self) -> Dict[str, torch.Tensor]:
        """The whole of each leaf the heuristic sliced over a held axis
        (one all-gather a dtype and axis)."""
        cut = {k: p for k, p in self._params.items() if not self._ruled[k]
               and any(a in self._specs[k] for a in self._held_axes)}
        return self._join_many(cut, self._held_axes)

    def tree(self) -> Dict[str, torch.Tensor]:
        """The parameters the forward takes: the server's own tensors (the
        fused steps read and update them in place), the block this rank
        holds of a leaf an explicit rule sliced over 'model' or 'pipe',
        and, all-gathered there, the whole of a leaf the heuristic sliced
        (every rank must make the first call; :meth:`step_` keeps these
        current, so later calls run no collective)."""
        if self._fwd is None or self._fwd[0] is not self._params:
            self._fwd = (self._params, {**self._params, **self._gathered()})
        return dict(self._fwd[1])

    # -- per-key protocol (stages, applies at full-tree granularity) --------

    def push(self, key: str, grad: Any, worker: int = 0) -> None:
        del worker  # SPMD: each rank pushes its own gradient
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        if key in self._staged:
            raise RuntimeError(f"key {key!r} already staged this step")
        self._staged[key] = grad
        if len(self._staged) == len(self._params):
            staged, self._staged = self._staged, {}
            self.update_tree(staged)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        del worker
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        if self._staged:
            missing = sorted(set(self._params) - set(self._staged))
            shown = ", ".join(missing[:3]) + (", ..." if len(missing) > 3
                                              else "")
            raise RuntimeError(
                f"pull({key!r}) would block: the cuda backend applies at "
                f"full-tree granularity and keys [{shown}] have not been "
                f"pushed this step")
        return self.peek(key)

    def optimizer_state(self, key: str):
        """Per-key view into the whole-tree state: every dict carrying
        exactly the full key set (a param-shaped field: mu, nu, traces) is
        narrowed to ``key``; a field that merely holds a same-named entry
        is left as it is."""
        full_keys = set(self._params)

        def narrow(node):
            if isinstance(node, dict):
                if set(node) == full_keys:
                    return node[key]
                return {k: narrow(v) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(narrow(v) for v in node)
            return node

        return narrow(self._state)

    # -- checkpoint hooks (CheckpointMixin) ---------------------------------

    def _check_checkpointable(self):
        if self._staged:
            raise RuntimeError(
                f"cannot checkpoint mid-step: keys {sorted(self._staged)} "
                f"are staged but unapplied")

    def _checkpoint_meta(self):
        return {"apply_count": self.apply_count,
                "collective_bytes": self.collective_bytes}

    def _load_checkpoint_meta(self, meta, elastic=False):
        self._staged = {}
        self.apply_count = int(meta["apply_count"])
        self.collective_bytes = int(meta["collective_bytes"])

    # no _validate_checkpoint_meta: nothing topology-bound to refuse


class AsyncCudaServer(_RankApplyMixin, AsyncStagingMixin,
                      CheckpointMixin):
    """Parameter server with ASYNC (stale, delay-compensated) apply on one
    device or across the ranks of a mesh — the reference's workload
    config 5.

    Every whole-tree push applies at once with the DC-ASGD correction
    against the pusher's last-pulled snapshot of each key; per-key pushes
    stage and commit as one tree. ``version`` advances once a whole-model
    apply; ``staleness(w)`` is the versions since worker w's last pull.
    Applies and pulls serialize on one lock, so host threads can drive
    workers concurrently in one process; they share the device's default
    stream. Across ranks every rank makes the same calls in the same
    order from one thread (a push there is a collective), or, served
    (``backends/op_stream.py``), in the order rank 0's service threads
    take the lock, and a pull returns whole tensors, bitwise the same on
    every rank.
    """

    mode = "async"
    engine_name = "cuda_async"

    def __init__(self, optimizer, device: torch.device, num_workers: int,
                 dc_lambda: float = 0.04, mesh: Optional[Mesh] = None,
                 placement: str = "replicated", partition_rules=None):
        self._opt = optimizer
        self.device = device
        self.num_workers = num_workers
        self.dc_lambda = dc_lambda
        self.mesh = mesh if mesh is not None else Mesh({"data": 1})
        self.placement = placement
        self.partition_rules = partition_rules
        self._params: Dict[str, torch.Tensor] = {}
        self._state: Dict[str, Any] = {}
        self._specs: Dict[str, tuple] = {}
        self._ruled: Dict[str, bool] = {}
        self._whole: Dict[str, torch.Tensor] = {}
        self._dims: Dict[str, Optional[int]] = {}
        self._state_specs: List[tuple] = []
        self._state_dims: List[Optional[int]] = []
        self._key_state_specs: Dict[str, List[tuple]] = {}
        self._thread: Optional[int] = None  # the one thread across ranks
        # the op stream of a service across ranks (backends/op_stream.py):
        # set, every push is the global gradient, whole on every rank
        self._ops = None
        self._stale: Dict[tuple, torch.Tensor] = {}
        self._staged_async: Dict[int, Dict[str, Any]] = {}
        self._worker_version: Dict[int, int] = {}
        self._applies = 0  # per-key applies, at any granularity
        self._version = 0  # whole-model versions
        self.apply_count: Dict[str, int] = {}
        self.staleness_hist = collections.Counter()  # τ -> tree pushes
        self.collective_bytes = 0  # the reference's analytic bytes
        self._lock = threading.RLock()
        self._dc_apply = make_dc_apply_tree(optimizer)

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        """Register the parameters, whole on every rank (pulls are whole),
        and one optimizer state a key, of the block this rank owns under
        its spec ('sharded', or a rule's axes). Every rank registers the
        same values."""
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        self._params = {key: self._place(key, v, self.partition_rules)
                        for key, v in kv.items()}
        for key, v in self._params.items():
            self._state[key], self._key_state_specs[key] = sharded_opt_init(
                self._opt.init, {key: v}, {key: self._specs[key]},
                self.mesh)
            self.apply_count[key] = 0
        self._index_state_specs()
        return keymod.unflatten(treedef, self._params, key_order)

    def _index_state_specs(self) -> None:
        # in checkpoint.flatten_leaves order: the keys sorted
        self._state_specs = [spec for key in sorted(self._key_state_specs)
                             for spec in self._key_state_specs[key]]
        self._state_dims = _data_dims(self._state_specs)

    def keys(self):
        return list(self._params)

    def _check_thread(self) -> None:
        """Across ranks every push and pull comes from one thread: each
        rank's lock would order concurrent threads' calls its own way, and
        the collectives of a push would pair different pushes. A served
        engine is exempt: its op stream fixes one order (rank 0's service
        threads call under the engine lock, which also broadcasts each
        call, and every other rank runs the stream from one thread)."""
        if self.mesh.size == 1 or self._ops is not None:
            return
        me = threading.get_ident()
        if self._thread is None:
            self._thread = me
        elif self._thread != me:
            raise RuntimeError(
                "the async server across ranks is driven from one thread: "
                "host threads driving workers concurrently would order "
                "their pushes differently on each rank, and a push's "
                "collectives would pair different pushes across the ranks "
                "(threads are a one-process feature)")

    def _apply_dc_tree(self, params, states, grads, stales, lam):
        """The DC apply of a (partial) tree, out of place: this rank's
        gradients reduced to their mean over the ranks (served: the
        worker's gradient as it came, the same on every rank); each rank
        corrects and steps the slices it owns against the same slices of
        the stale snapshots, then the sharded leaves are all-gathered (one
        device: the whole tree here)."""
        if self.mesh.world is None:
            return self._dc_apply(params, states, grads, stales, lam)
        if self._ops is not None:
            grads = {key: self._owned(key, g) for key, g in grads.items()}
        else:
            grads = self._reduce(grads)
        owned, states = self._dc_apply(
            {key: self._owned(key, p) for key, p in params.items()},
            states, grads,
            {key: self._owned(key, v) for key, v in stales.items()}, lam,
            self._norms(params))
        return ({key: self._gather(key, t).contiguous()
                 for key, t in owned.items()}, states)

    def _check_worker(self, worker: int) -> None:
        # ids at or past AGG_WORKER_BASE are aggregator identities: legal
        # pushers with their own staleness slots, outside num_workers
        if worker >= AGG_WORKER_BASE:
            return
        if not (0 <= worker < self.num_workers):
            raise ValueError(
                f"worker {worker} out of range [0, {self.num_workers})")

    def push(self, key: str, grad: Any, worker: int = 0) -> None:
        """Per-key push: stages per worker and commits the whole tree as
        one apply when this worker's last key arrives."""
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        self._check_worker(worker)
        self._check_thread()
        with self._lock:
            self._stage_async_push(key, grad, worker)

    def push_tree(self, grads_kv: Dict[str, Any], worker: int = 0) -> None:
        """Whole-tree async push: one DC apply of every key."""
        if set(grads_kv) != set(self._params):
            raise ValueError("gradient keys do not match registered keys")
        self._check_worker(worker)
        self._check_thread()
        with self._lock:
            self._commit_tree(grads_kv, worker)

    def push_subtree(self, grads_kv: Dict[str, Any], worker: int = 0) -> None:
        """One DC apply of a subset of the keys: a push replayed across a
        key-range move owes an apply only to the keys whose dedup token
        missed it, and keys are independent under per-key optimizers, so
        this is exactly the replay of those keys."""
        missing = [k for k in grads_kv if k not in self._params]
        if missing:
            raise KeyError(f"unregistered keys {missing[:3]}")
        self._check_worker(worker)
        self._check_thread()
        with self._lock:
            self._commit_tree(grads_kv, worker)

    def _commit_tree_accounting(self, grads_kv) -> None:
        # the reference's count: an all-reduce of the pushed keys' bytes
        self._applies += len(grads_kv)
        self.collective_bytes += collectives.allreduce_bytes(
            {key: self._params[key] for key in grads_kv}, self.mesh.size)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        self._check_thread()
        with self._lock:
            return self._pull_async(worker, [key])[key]

    def pull_tree(self, worker: int = 0) -> Dict[str, torch.Tensor]:
        """Atomic whole-tree pull: the snapshot and the version record come
        from one server state."""
        self._check_thread()
        with self._lock:
            return self._pull_async(worker, self._params)

    def optimizer_state(self, key: str):
        return self._state[key]

    # -- elastic membership: live key moves (elastic/) ----------------------
    # A move carries whole rows: the parameter, the key's optimizer state,
    # every worker's stale snapshot of it and its apply count. Keys are
    # independent under per-key optimizers, so a key's history moves
    # between engines bit for bit.

    def _whole_state(self, k: str):
        """Key ``k``'s optimizer state with every leaf whole: a leaf cut
        across the ranks (a moment, laid out as its parameter) is
        all-gathered from the owned blocks, so every rank must make the
        call; one rank's state as it is."""
        if self.mesh.world is None:
            return self._state[k]
        flat = flatten_leaves(self._state[k])
        whole = {i: self._gather(k, v) if any(spec) else v
                 for (i, v), spec in zip(flat.items(),
                                         self._key_state_specs[k])}
        return unflatten_like(self._state[k], whole)

    def export_keys(self, keys) -> Dict[str, dict]:
        """The rows of ``keys`` (the caller holds the lock), in host
        memory of their own: the copies off the card are waited for
        before this returns, so every later apply is free to run. The
        state travels flat under the reference's leaf paths (``"0/trace"``,
        ...), so a reference engine adopts a port row and the reverse.
        Across ranks every rank calls it with the same keys in the same
        order (the state's blocks are all-gathered, key by key)."""
        flat: Dict[str, Any] = {}
        for k in keys:
            if k not in self._params:
                raise KeyError(f"unregistered key {k!r}")
            flat[f"{k}\0param"] = self._params[k]
            for p, v in state_to_reference(self._opt.name, k,
                                           self._whole_state(k)).items():
                flat[f"{k}\0s:{p}"] = v
            for (w, kk), v in self._stale.items():
                if kk == k:
                    flat[f"{k}\0w:{w}"] = v
        host = stage_to_host(flat, copy=True)
        out = {k: {"param": None, "state": {}, "stale": {},
                   "apply_count": int(self.apply_count.get(k, 0))}
               for k in keys}
        for name, a in host.items():
            k, _, field = name.partition("\0")
            if field == "param":
                out[k]["param"] = a
            elif field.startswith("s:"):
                out[k]["state"][field[2:]] = a
            else:
                out[k]["stale"][int(field[2:])] = a
        return out

    def adopt_key(self, k: str, param, state_kv, stale,
                  apply_count: int = 0) -> None:
        """Install one moved row (the caller holds the lock): the parameter
        placed on the engine's device as :meth:`register_tree` places a
        key, the optimizer state rebuilt from the donor's leaves over a
        fresh init of it (across ranks: this rank's blocks of the whole
        leaves), the stale snapshots seeded so the DC correction goes on
        where the donor left it."""
        if k in self._params:
            raise KeyError(f"key {k!r} already registered")
        p = self._place(k, torch.from_numpy(np.asarray(param)),
                        self.partition_rules)
        state, specs = sharded_opt_init(self._opt.init, {k: p},
                                        {k: self._specs[k]}, self.mesh)
        try:
            whole = self._opt.init({k: p})  # the leaves as the row has them
            state_from_reference(self._opt.name, k, whole, state_kv)
        except ValueError:
            for d in (self._specs, self._ruled, self._whole, self._dims):
                d.pop(k, None)
            raise
        for dst, src, spec in zip(flatten_leaves(state).values(),
                                  flatten_leaves(whole).values(), specs):
            dst.copy_(block(src, spec, self.mesh))
        self._params[k] = p
        self._state[k] = state
        self._key_state_specs[k] = specs
        self._index_state_specs()
        for w, v in stale.items():
            self._stale[(int(w), k)] = device_copy(
                torch.from_numpy(np.asarray(v)), self.device)
        self.apply_count[k] = int(apply_count)

    def evict_keys(self, keys) -> None:
        """Drop moved-away keys (the caller holds the lock): parameters,
        state, stale snapshots, apply counts, and any staged per-key push
        of them (a staged partial tree must not commit a key this engine
        no longer holds)."""
        gone = set(keys)
        for k in gone:
            if k not in self._params:
                raise KeyError(f"unregistered key {k!r}")
        for k in gone:
            del self._params[k]
            del self._state[k]
            self.apply_count.pop(k, None)
            for d in (self._specs, self._ruled, self._whole, self._dims,
                      self._key_state_specs):
                d.pop(k, None)
        self._index_state_specs()
        for wk in [wk for wk in self._stale if wk[1] in gone]:
            del self._stale[wk]
        for staged in self._staged_async.values():
            for k in gone & set(staged):
                del staged[k]

    # -- checkpoint hooks (CheckpointMixin) ---------------------------------
    # async mode checkpoints the server-side state, every worker's stale
    # snapshot and the per-worker version vector

    def _check_checkpointable(self):
        self._check_staged_async()

    def _checkpoint_meta(self):
        return {
            "applies": self._applies,
            "version": self._version,
            "staleness_hist": {str(t): n
                               for t, n in self.staleness_hist.items()},
            "num_workers": self.num_workers,
            "worker_version": {str(w): v
                               for w, v in self._worker_version.items()},
            "apply_count": dict(self.apply_count),
            "collective_bytes": self.collective_bytes,
        }

    def _validate_checkpoint_meta(self, meta, elastic=False):
        if meta["num_workers"] != self.num_workers and not elastic:
            raise ValueError(
                f"checkpoint was written with num_workers="
                f"{meta['num_workers']} but this store runs num_workers="
                f"{self.num_workers} — staleness semantics would differ "
                f"(restore(elastic=True) remaps: surviving workers keep "
                f"their versions, removed workers' state is dropped, new "
                f"workers join fresh)")

    def _load_checkpoint_meta(self, meta, elastic=False):
        self._worker_version = {
            int(w): int(v) for w, v in meta["worker_version"].items()
            if keep_worker(int(w), self.num_workers, elastic)}
        self._applies = int(meta["applies"])
        self._version = int(meta["version"])
        self.staleness_hist = collections.Counter(
            {int(t): int(n) for t, n in meta["staleness_hist"].items()})
        self.apply_count = {k: int(v) for k, v in meta["apply_count"].items()}
        self.collective_bytes = int(meta["collective_bytes"])


class CudaBackend:
    """Backend for ``ps_tpu_torch.init(backend='cuda')``.

    One process: everything on one device, ``cuda:0`` unless the config
    names another (or the CPU). With ``coordinator_uri`` (``host:port``)
    this process is rank ``process_id`` of ``num_processes``: it joins the
    process group there (``init_method='tcp://host:port'``), on device
    ``cuda:<local rank>`` (``LOCAL_RANK``, else ``process_id``) unless the
    config names one, and the mesh spans the group. The group's backend
    is ``Config.dist_backend``: 'auto' takes NCCL for a CUDA device and
    gloo for the CPU; 'gloo' or 'nccl' by name. Ranks that share one card
    need gloo (NCCL refuses two ranks on a device), and it is never
    chosen for them: they ask for it."""

    def __init__(self, config: Config):
        self.config = config
        self._owns_group = False
        self.failure_detector = None
        if config.coordinator_uri is not None or config.num_processes > 1:
            self.device = self._rank_device(config)
            self._join_group(config)
        else:
            self.device = backend_device(config)
        try:
            self._start_failure_detector(config)
            self.mesh = make_mesh(config.mesh_shape)
        except Exception:
            # a failed init leaves no beat thread running (peers would see
            # a rank alive that never joined) and no process group
            if self.failure_detector is not None:
                self.failure_detector.close()
                self.failure_detector = None
            self.shutdown(abort=True)
            raise
        self.num_workers = self.mesh.size

    def _start_failure_detector(self, config: Config) -> None:
        """With ``heartbeat_peers()`` set and several processes: monitor
        this rank's port, beat every peer, and wait until every peer's
        first beat has arrived."""
        all_peers = config.heartbeat_peers()
        if all_peers is None or config.num_processes <= 1:
            return
        from ps_tpu_torch.control import FailureDetector

        peers = {i: hp for i, hp in all_peers.items()
                 if i != config.process_id}
        self.failure_detector = FailureDetector(
            node_id=config.process_id, peers=peers,
            port=all_peers[config.process_id][1],
            bind=config.resolved_heartbeat_bind(),
            interval_ms=config.heartbeat_interval_ms,
            timeout_ms=config.heartbeat_timeout_ms)
        self.failure_detector.wait_for_peers()

    @staticmethod
    def _rank_device(config: Config) -> torch.device:
        device = torch.device(config.device)
        if device.type != "cuda" or device.index is not None:
            return backend_device(config)
        local = int(os.environ.get("LOCAL_RANK", config.process_id))
        if not torch.cuda.is_available():
            return backend_device(config)  # raises: no GPU
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {config.process_id} would run on cuda:{local}, and "
                f"this host has {torch.cuda.device_count()} GPU(s); name "
                f"the device (device='cuda:0') for ranks that share one, "
                f"with dist_backend='gloo'")
        return torch.device("cuda", local)

    def _join_group(self, config: Config) -> None:
        import torch.distributed as dist

        if config.coordinator_uri is None:
            raise ValueError(
                f"num_processes={config.num_processes} needs a "
                f"coordinator_uri (host:port) to meet the other ranks at")
        backend = config.dist_backend
        if backend == "auto":
            backend = "nccl" if self.device.type == "cuda" else "gloo"
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"dist_backend must be 'auto', 'nccl' or "
                             f"'gloo', got {config.dist_backend!r}")
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("dist_backend='nccl' needs a CUDA device")
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized "
                               "outside ps_tpu_torch")
        kwargs = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"tcp://{config.coordinator_uri}",
            world_size=config.num_processes, rank=config.process_id,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
            **kwargs)
        self._owns_group = True

    def check_health(self) -> None:
        """Raise ``WorkerFailureError`` if a peer process stopped beating
        (a no-op when the failure detector is off)."""
        if self.failure_detector is not None:
            self.failure_detector.check()

    def fused_apply_tier(self) -> str:
        """The concrete sparse fused-apply tier for this rank's device:
        ``Config.fused_apply`` with 'auto' resolved against it."""
        return resolve_tier(self.config.fused_apply, self.device)

    def create_server(self, optimizer, mode: Optional[str] = None,
                      aggregate: str = "mean", placement: str = "replicated",
                      partition_rules=None):
        if (mode or self.config.mode) == "async":
            return AsyncCudaServer(optimizer, self.device,
                                   num_workers=self.config.num_workers,
                                   dc_lambda=self.config.dc_lambda,
                                   mesh=self.mesh, placement=placement,
                                   partition_rules=partition_rules)
        return CudaServer(optimizer, self.device, aggregate=aggregate,
                          mesh=self.mesh, placement=placement,
                          partition_rules=partition_rules)

    def shutdown(self, abort: bool = False) -> None:
        """Leave the process group this backend joined. ``abort=True`` is
        the post-failure path: the group is aborted without the barrier
        (with a peer dead, a barrier would hang every survivor). The
        failure detector says goodbye first, so fellow survivors see this
        exit as a leave, not a death."""
        if self.failure_detector is not None:
            self.failure_detector.close(goodbye=True)
            self.failure_detector = None
        if not self._owns_group:
            return
        import torch.distributed as dist

        self._owns_group = False
        if abort:
            dist.distributed_c10d._abort_process_group()
            return
        dist.barrier()
        dist.destroy_process_group()
