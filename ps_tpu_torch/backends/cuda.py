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
  threads can drive workers concurrently. One process only.
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

Not ported yet: the async server across ranks (ROADMAP Queue 1 item 4),
the async server's elastic hooks (item 6) and ``partition_rules`` (item
7).
"""

from __future__ import annotations

import collections
import datetime
import os
import threading
from typing import Any, Dict, List, Optional

import torch

from ps_tpu_torch.backends.common import (
    AGG_WORKER_BASE,
    AsyncStagingMixin,
    PeekMixin,
    backend_device,
    device_copy,
    make_dc_apply_tree,
)
from ps_tpu_torch.checkpoint import CheckpointMixin
from ps_tpu_torch.config import Config
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.ops.sparse_apply import resolve_tier
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import Mesh, make_mesh
from ps_tpu_torch.parallel.sharding import (param_sharding, shard,
                                            sharded_opt_init)

# a rendezvous or a collective that does not complete fails after this
# many seconds instead of hanging
GROUP_TIMEOUT_S = 600


class CudaServer(PeekMixin, CheckpointMixin):
    """Parameter/optimizer-state store with PS semantics over a mesh.

    ``apply_count`` counts whole-tree applies (``update_tree`` and every
    fused step), as the reference's does; ``collective_bytes`` adds each
    apply's analytic per-rank bytes (0 at one rank)."""

    mode = "sync"
    engine_name = "cuda_sync"

    def __init__(self, optimizer, device: torch.device,
                 aggregate: str = "mean", mesh: Optional[Mesh] = None,
                 placement: str = "replicated"):
        if aggregate not in ("mean", "sum"):
            raise ValueError("aggregate must be 'mean' or 'sum'")
        self._opt = optimizer
        self.device = device
        self.aggregate = aggregate
        self.mesh = mesh if mesh is not None else Mesh({"data": 1})
        self.placement = placement
        self.num_workers = self.mesh.size
        self._params: Dict[str, torch.Tensor] = {}
        self._state = None
        self._dims: Dict[str, Optional[int]] = {}
        self._state_dims: List[Optional[int]] = []
        self._staged: Dict[str, torch.Tensor] = {}
        self.apply_count = 0
        self.collective_bytes = 0

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        """Register the parameters. Every rank registers the same values
        (the reference asserts as much across processes)."""
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        k = self.mesh.size
        self._params = {key: device_copy(v, self.device)
                        for key, v in kv.items()}
        self._dims = {key: param_sharding(p.shape, self.placement, k)
                      for key, p in self._params.items()}
        if self._opt.name == "lamb" and any(
                d is not None for d in self._dims.values()):
            raise NotImplementedError(
                "lamb's trust ratio needs whole-tensor norms, which a "
                "shard-local apply does not see; use placement='replicated' "
                "across ranks (sharded lamb is not ported yet)")
        self._state, self._state_dims = sharded_opt_init(
            self._opt.init, self._params, self._dims, self.mesh.rank, k)
        return keymod.unflatten(treedef, self._params, key_order)

    def keys(self):
        return list(self._params)

    @property
    def grad_scale(self) -> float:
        """Aggregation factor on incoming global-mean grads: 1 for 'mean',
        num_workers for 'sum'."""
        return float(self.num_workers) if self.aggregate == "sum" else 1.0

    # -- the apply across ranks -----------------------------------------------

    def _reduce(self, grads_kv: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """This rank's gradients -> their mean over the ranks: each sharded
        leaf's for the slice this rank owns only (a reduce-scatter along
        its shard dimension, moved to the front), the rest whole (one
        all-reduce a dtype over a flat buffer)."""
        mesh, k = self.mesh, self.mesh.size
        if mesh.group is None:
            return dict(grads_kv)
        out: Dict[str, torch.Tensor] = {}
        whole: Dict[torch.dtype, List[str]] = {}
        for key, g in grads_kv.items():
            d = self._dims[key]
            if d is None:
                whole.setdefault(g.dtype, []).append(key)
                continue
            part = collectives.reduce_scatter(g.movedim(d, 0), mesh)
            if k > 1:
                part.div_(k)
            out[key] = part.movedim(0, d)
        for keys in whole.values():
            flat = torch.cat([grads_kv[key].reshape(-1) for key in keys])
            collectives.all_reduce(flat, mesh)
            if k > 1:
                flat.div_(k)
            sizes = [grads_kv[key].numel() for key in keys]
            for key, part in zip(keys, flat.split(sizes)):
                out[key] = part.view(grads_kv[key].shape)
        return out

    def _apply_(self, params: Dict[str, torch.Tensor],
                grads_kv: Dict[str, torch.Tensor]) -> None:
        """Reduce this rank's ``grads_kv`` over the ranks and step
        ``params`` (whole tensors on every rank) in place: each rank steps
        the slices it owns, then the sharded leaves are all-gathered."""
        grads = self._reduce(grads_kv)
        scale = self.grad_scale
        if scale != 1.0:
            grads = {key: g * scale for key, g in grads.items()}
        mesh, k, r = self.mesh, self.mesh.size, self.mesh.rank
        owned = {key: shard(p, self._dims[key], r, k)
                 for key, p in params.items()}
        self._opt.step_(owned, grads, self._state)
        for key, d in self._dims.items():
            if d is not None:
                full = collectives.all_gather(owned[key].movedim(d, 0), mesh)
                params[key].copy_(full.movedim(0, d))
        self.apply_count += 1
        self._account_update()

    def _account_update(self):
        k = self.num_workers
        if self.placement == "replicated":
            # grads were all-reduced across the data axis
            self.collective_bytes += collectives.allreduce_bytes(
                self._params, k)
        else:
            # reduce-scatter grads to owners + all-gather params
            self.collective_bytes += collectives.reduce_scatter_bytes(
                self._params, k)
            self.collective_bytes += collectives.all_gather_bytes(
                self._params, k)

    def update_tree(self, grads_kv: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One server step on this rank's grads (their mean over the ranks
        is applied); returns the new params. Out of place: tensors pulled
        before keep their values."""
        grads_kv = {k: torch.as_tensor(g, device=self.device)
                    for k, g in grads_kv.items()}
        params = {k: p.clone() for k, p in self._params.items()}
        self._apply_(params, grads_kv)
        self._params = params
        return dict(self._params)

    def step_(self, grads_kv: Dict[str, torch.Tensor]) -> None:
        """The fused step's apply: this rank's grads reduced over the
        ranks and applied to the server's own tensors in place."""
        self._apply_(self._params, grads_kv)

    def tree(self) -> Dict[str, torch.Tensor]:
        """The server's own parameter tensors (the fused steps read and
        update them in place)."""
        return dict(self._params)

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
        return self._params[key]

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

    def _load_checkpoint_meta(self, meta):
        self._staged = {}
        self.apply_count = int(meta["apply_count"])
        self.collective_bytes = int(meta["collective_bytes"])

    # no _validate_checkpoint_meta: nothing topology-bound to refuse


class AsyncCudaServer(PeekMixin, AsyncStagingMixin, CheckpointMixin):
    """Parameter server with ASYNC (stale, delay-compensated) apply on one
    device — the reference's workload config 5.

    Every whole-tree push applies at once with the DC-ASGD correction
    against the pusher's last-pulled snapshot of each key; per-key pushes
    stage and commit as one tree. ``version`` advances once a whole-model
    apply; ``staleness(w)`` is the versions since worker w's last pull.
    Applies and pulls serialize on one lock, so host threads can drive
    workers concurrently; they share the device's default stream.
    """

    mode = "async"
    engine_name = "cuda_async"

    def __init__(self, optimizer, device: torch.device, num_workers: int,
                 dc_lambda: float = 0.04):
        self._opt = optimizer
        self.device = device
        self.num_workers = num_workers
        self.dc_lambda = dc_lambda
        self._params: Dict[str, torch.Tensor] = {}
        self._state: Dict[str, Any] = {}
        self._stale: Dict[tuple, torch.Tensor] = {}
        self._staged_async: Dict[int, Dict[str, Any]] = {}
        self._worker_version: Dict[int, int] = {}
        self._applies = 0  # per-key applies, at any granularity
        self._version = 0  # whole-model versions
        self.apply_count: Dict[str, int] = {}
        self.staleness_hist = collections.Counter()  # τ -> tree pushes
        self.collective_bytes = 0  # one device runs no collective
        self._lock = threading.RLock()
        self._apply_dc_tree = make_dc_apply_tree(optimizer)

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        self._params = {k: device_copy(v, self.device) for k, v in kv.items()}
        for k, v in self._params.items():
            self._state[k] = self._opt.init({k: v})
            self.apply_count[k] = 0
        return keymod.unflatten(treedef, self._params, key_order)

    def keys(self):
        return list(self._params)

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
        with self._lock:
            self._stage_async_push(key, grad, worker)

    def push_tree(self, grads_kv: Dict[str, Any], worker: int = 0) -> None:
        """Whole-tree async push: one DC apply of every key."""
        if set(grads_kv) != set(self._params):
            raise ValueError("gradient keys do not match registered keys")
        self._check_worker(worker)
        with self._lock:
            self._commit_tree(grads_kv, worker)

    def _commit_tree_accounting(self, grads_kv) -> None:
        self._applies += len(grads_kv)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        with self._lock:
            return self._pull_async(worker, [key])[key]

    def pull_tree(self, worker: int = 0) -> Dict[str, torch.Tensor]:
        """Atomic whole-tree pull: the snapshot and the version record come
        from one server state."""
        with self._lock:
            return self._pull_async(worker, self._params)

    def optimizer_state(self, key: str):
        return self._state[key]

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

    def _validate_checkpoint_meta(self, meta):
        if meta["num_workers"] != self.num_workers:
            raise ValueError(
                f"checkpoint was written with num_workers="
                f"{meta['num_workers']} but this store runs num_workers="
                f"{self.num_workers} — staleness semantics would differ")

    def _load_checkpoint_meta(self, meta):
        self._worker_version = {int(w): int(v)
                                for w, v in meta["worker_version"].items()}
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
        if partition_rules:
            raise NotImplementedError(
                "partition_rules (tensor parallelism) are not ported yet")
        if (mode or self.config.mode) == "async":
            if self.mesh.size > 1:
                raise NotImplementedError(
                    "the async server across ranks is not ported yet "
                    "(ROADMAP Queue 1 item 4); run mode='async' in one "
                    "process")
            return AsyncCudaServer(optimizer, self.device,
                                   num_workers=self.config.num_workers,
                                   dc_lambda=self.config.dc_lambda)
        return CudaServer(optimizer, self.device, aggregate=aggregate,
                          mesh=self.mesh, placement=placement)

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
