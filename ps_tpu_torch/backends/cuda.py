"""The 'cuda' backend: a parameter server on one device.

Counterpart of ``ps_tpu/backends/tpu.py`` at one device:

- ``CudaServer`` (``TpuServer``): the parameter dict ``{key: tensor}``
  and one whole-tree optimizer state on the device. ``make_step`` updates
  both in place (in place replaces the reference's donation). The per-key
  protocol stages pushes until the whole tree is there and then runs
  ``update_tree``, which like ``push_pull`` applies out of place, so a
  tensor a caller pulled keeps its values, as the reference's undonated
  apply keeps them.
- ``AsyncCudaServer`` (``AsyncTpuServer``): mode='async', the local
  backend's async semantics (stale apply with the DC-ASGD correction,
  tree-granularity versions, per-worker staging of per-key pushes) with
  one optimizer state a key, out of place, behind one lock so host
  threads can drive workers concurrently.

Both servers checkpoint (``ps_tpu_torch/checkpoint.py``): engine
``cuda_sync`` saves the params, the whole-tree state, ``apply_count`` and
``collective_bytes``; engine ``cuda_async`` also the stale snapshots and
the version vector. Each refuses to save mid-step and holds its lock
across a save or a restore.

At one device 'replicated' and 'sharded' (ZeRO-1) placement are the same
thing, as on a one-device mesh, and no collective moves a byte. Placement
across GPUs, the failure detector, and the async server's elastic hooks
are not ported yet.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

import torch

from ps_tpu_torch.backends.common import (
    AGG_WORKER_BASE,
    AsyncStagingMixin,
    PeekMixin,
    apply_out_of_place,
    backend_device,
    device_copy,
    make_dc_apply_tree,
)
from ps_tpu_torch.checkpoint import CheckpointMixin
from ps_tpu_torch.config import Config
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.ops.sparse_apply import resolve_tier


class CudaServer(PeekMixin, CheckpointMixin):
    """Parameter/optimizer-state store with PS semantics on one device.

    ``apply_count`` counts whole-tree applies (``update_tree`` and every
    fused step's ``set_tree_and_state``), as the reference's does;
    ``collective_bytes`` stays 0: one device runs no collective."""

    mode = "sync"
    engine_name = "cuda_sync"

    def __init__(self, optimizer, device: torch.device,
                 aggregate: str = "mean"):
        if aggregate not in ("mean", "sum"):
            raise ValueError("aggregate must be 'mean' or 'sum'")
        self._opt = optimizer
        self.device = device
        self.aggregate = aggregate
        self.num_workers = 1
        self._params: Dict[str, torch.Tensor] = {}
        self._state = None
        self._staged: Dict[str, torch.Tensor] = {}
        self.apply_count = 0
        self.collective_bytes = 0

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        self._params = {k: device_copy(v, self.device) for k, v in kv.items()}
        self._state = self._opt.init(self._params)
        return keymod.unflatten(treedef, self._params, key_order)

    def keys(self):
        return list(self._params)

    @property
    def grad_scale(self) -> float:
        """Aggregation factor on incoming global-mean grads: 1 for 'mean',
        num_workers for 'sum' (so 1 either way at one device)."""
        return float(self.num_workers) if self.aggregate == "sum" else 1.0

    def update_tree(self, grads_kv: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One server step on the global grads; returns the new params. Out
        of place: tensors pulled before keep their values."""
        scale = self.grad_scale
        grads_kv = {k: torch.as_tensor(g, device=self.device)
                    for k, g in grads_kv.items()}
        if scale != 1.0:
            grads_kv = {k: g * scale for k, g in grads_kv.items()}
        self._params = apply_out_of_place(self._opt, self._params, grads_kv,
                                          self._state)
        self.apply_count += 1
        return dict(self._params)

    # -- per-key protocol (stages, applies at full-tree granularity) --------

    def push(self, key: str, grad: Any, worker: int = 0) -> None:
        del worker  # one device: the worker set is the one device
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

    # -- internals for the fused train step ---------------------------------

    def get_tree_and_state(self):
        return dict(self._params), self._state

    def set_tree_and_state(self, params, state):
        self._params, self._state = dict(params), state
        self.apply_count += 1

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
    """Backend for ``ps_tpu_torch.init(backend='cuda')``: everything on one
    device, ``cuda:0`` unless the config names the CPU."""

    def __init__(self, config: Config):
        self.config = config
        device = backend_device(config)
        if config.num_processes > 1 or config.coordinator_uri is not None:
            raise NotImplementedError(
                "multi-process runs are not ported yet (one device only)")
        if config.mesh_shape and any(v != 1 for v in config.mesh_shape.values()):
            raise NotImplementedError(
                f"mesh_shape {config.mesh_shape}: more than one device is "
                f"not ported yet")
        self.device = device
        self.num_workers = 1

    def fused_apply_tier(self) -> str:
        """The concrete sparse fused-apply tier for this backend's device:
        ``Config.fused_apply`` with 'auto' resolved against it."""
        return resolve_tier(self.config.fused_apply, self.device)

    def create_server(self, optimizer, mode: Optional[str] = None,
                      aggregate: str = "mean", placement: str = "replicated",
                      partition_rules=None):
        del placement  # 'replicated' and 'sharded' coincide at one device
        if partition_rules:
            raise NotImplementedError(
                "partition_rules (tensor parallelism) are not ported yet")
        if (mode or self.config.mode) == "async":
            return AsyncCudaServer(optimizer, self.device,
                                   num_workers=self.config.num_workers,
                                   dc_lambda=self.config.dc_lambda)
        return CudaServer(optimizer, self.device, aggregate=aggregate)
