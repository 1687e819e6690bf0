"""The single-process local parameter server.

Counterpart of ``ps_tpu/backends/local.py`` (the reference's config 1,
"single-process local PS"): the whole push/aggregate/apply/pull protocol
in one process, with no network. The server's tensors live on
``Config.device``, ``cuda:0`` unless the caller asks for the CPU.

- **Per-key optimizer state.** Each key has its own state,
  ``opt.init({key: value})``, as the reference server keeps one a key.
  For per-tensor optimizers this is the same arithmetic as a whole-tree
  update.
- **Sync aggregation.** A key's update fires on the last of the
  ``num_workers`` pushes of a step: the gradients summed in worker order,
  then divided by ``num_workers`` for 'mean'. A pull that would see a
  half-aggregated key raises ("would block"); a second push of a key by
  one worker in a step raises.
- **Async apply** (mode='async'): a whole-tree push applies at once with
  the DC-ASGD correction against the pusher's last pull; per-key pushes
  stage per worker and commit as one tree (``AsyncStagingMixin``).
- Every apply is out of place (``backends/common.py``): tensors a worker
  pulled keep their values.

- **Checkpoints** (engine ``local``, ``ps_tpu_torch/checkpoint.py``): the
  params, the per-key states (schedule counts included), the async stale
  snapshots, ``apply_count`` and the version vector; refused while a sync
  push is pending or an async push is staged, and taken under the lock.
  ``restore(elastic=True)`` remaps an async checkpoint of another
  ``num_workers`` as the reference does (``checkpoint.keep_worker``).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

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
from ps_tpu_torch.checkpoint import CheckpointMixin, keep_worker
from ps_tpu_torch.config import Config
from ps_tpu_torch.ops.sparse_apply import resolve_tier
from ps_tpu_torch.optim import Optimizer


class LocalServer(PeekMixin, AsyncStagingMixin, CheckpointMixin):
    """In-memory server for one KVStore: params + per-key optimizer state."""

    engine_name = "local"

    def __init__(self, optimizer: Optimizer, num_workers: int,
                 device: torch.device, mode: str = "sync",
                 aggregate: str = "mean", dc_lambda: float = 0.04):
        if aggregate not in ("mean", "sum"):
            raise ValueError("aggregate must be 'mean' or 'sum'")
        self._opt = optimizer
        self.num_workers = num_workers
        self.device = device
        self.mode = mode
        self.aggregate = aggregate
        self.dc_lambda = dc_lambda
        self._params: Dict[str, torch.Tensor] = {}
        self._state: Dict[str, Any] = {}
        # sync aggregation buffers: key -> {worker: grad}
        self._pending: Dict[str, Dict[int, torch.Tensor]] = {}
        # async: (worker, key) -> the tensor that worker last pulled
        self._stale: Dict[tuple, torch.Tensor] = {}
        self.apply_count: Dict[str, int] = {}
        self._version = 0  # async: whole-tree versions
        self._staged_async: Dict[int, Dict[str, Any]] = {}
        self._worker_version: Dict[int, int] = {}
        self.staleness_hist = collections.Counter()
        # serializes applies and pulls, like the reference server's loop
        self._lock = threading.RLock()
        self._apply_dc_tree = make_dc_apply_tree(optimizer)

    # -- registration -------------------------------------------------------

    def register(self, key: str, value: Any) -> None:
        if key in self._params:
            raise ValueError(f"key {key!r} already registered")
        param = device_copy(value, self.device)
        self._params[key] = param
        self._state[key] = self._opt.init({key: param})
        self.apply_count[key] = 0

    def keys(self):
        return list(self._params)

    # -- push/pull ----------------------------------------------------------

    def push(self, key: str, grad: Any, worker: int = 0) -> None:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        if not (0 <= worker < self.num_workers):
            raise ValueError(
                f"worker {worker} out of range [0, {self.num_workers})")
        grad = torch.as_tensor(grad, device=self.device)
        with self._lock:
            if self.mode == "async":
                self._stage_async_push(key, grad, worker)
                return
            slot = self._pending.setdefault(key, {})
            if worker in slot:
                raise RuntimeError(
                    f"worker {worker} pushed key {key!r} twice before "
                    f"aggregation fired")
            slot[worker] = grad
            if len(slot) == self.num_workers:
                agg = slot[0]
                for w in range(1, self.num_workers):
                    agg = agg + slot[w]
                if self.aggregate == "mean" and self.num_workers > 1:
                    agg = agg / self.num_workers
                self._params.update(apply_out_of_place(
                    self._opt, {key: self._params[key]}, {key: agg},
                    self._state[key]))
                self.apply_count[key] += 1
                del self._pending[key]

    def push_tree(self, grads_kv: Dict[str, Any], worker: int = 0) -> None:
        """Whole-tree push. Async: one DC apply of every key. Sync: the
        per-key protocol in a loop (aggregation fires per key)."""
        if self.mode != "async":
            for k, g in grads_kv.items():
                self.push(k, g, worker=worker)
            return
        if set(grads_kv) != set(self._params):
            raise ValueError("gradient keys do not match registered keys")
        # aggregator identities are legal pushers outside [0, num_workers)
        if worker < AGG_WORKER_BASE and not (0 <= worker < self.num_workers):
            raise ValueError(
                f"worker {worker} out of range [0, {self.num_workers})")
        with self._lock:
            self._commit_tree(grads_kv, worker)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        with self._lock:
            if self.mode == "sync" and key in self._pending:
                got = sorted(self._pending[key])
                raise RuntimeError(
                    f"pull({key!r}) would block: only workers {got} of "
                    f"{self.num_workers} have pushed this step")
            if self.mode == "async":
                return self._pull_async(worker, [key])[key]
            return self._params[key]

    def pull_tree(self, worker: int = 0) -> Dict[str, torch.Tensor]:
        """Atomic whole-tree pull (async: one consistent snapshot and stale
        record; sync: the per-key blocked-pull checks under one lock)."""
        with self._lock:
            if self.mode == "async":
                return self._pull_async(worker, self._params)
            return {k: self.pull(k, worker=worker) for k in self._params}

    def optimizer_state(self, key: str):
        return self._state[key]

    # -- checkpoint hooks (CheckpointMixin) ---------------------------------

    def _check_checkpointable(self):
        if self._pending:
            raise RuntimeError(
                f"cannot checkpoint mid-step: keys {sorted(self._pending)} "
                f"have pending sync pushes")
        self._check_staged_async()

    def _checkpoint_meta(self):
        return {
            "mode": self.mode,
            "num_workers": self.num_workers,
            "aggregate": self.aggregate,
            "apply_count": dict(self.apply_count),
            "version": self._version,
            "worker_version": {str(w): v
                               for w, v in self._worker_version.items()},
            "staleness_hist": {str(t): n
                               for t, n in self.staleness_hist.items()},
        }

    def _validate_checkpoint_meta(self, meta, elastic=False):
        # mode and aggregate are different math; num_workers is topology,
        # which an elastic restore remaps
        fields = ("mode", "aggregate") if elastic else (
            "mode", "num_workers", "aggregate")
        for field in fields:
            if meta[field] != getattr(self, field):
                raise ValueError(
                    f"checkpoint was written with {field}={meta[field]!r} but "
                    f"this store runs {field}={getattr(self, field)!r} — "
                    f"resume semantics would differ")

    def _load_checkpoint_meta(self, meta, elastic=False):
        self._pending = {}
        self.apply_count = {k: int(v) for k, v in meta["apply_count"].items()}
        self._version = int(meta["version"])
        self._worker_version = {
            int(w): int(v) for w, v in meta["worker_version"].items()
            if keep_worker(int(w), self.num_workers, elastic)}
        self.staleness_hist = collections.Counter(
            {int(t): int(n) for t, n in meta["staleness_hist"].items()})


class LocalBackend:
    """Backend for ``ps_tpu_torch.init(backend='local')``."""

    def __init__(self, config: Config):
        self.config = config
        self.device = backend_device(config)
        self.num_workers = config.num_workers

    def fused_apply_tier(self) -> str:
        """``Config.fused_apply`` with 'auto' resolved against the device."""
        return resolve_tier(self.config.fused_apply, self.device)

    def create_server(self, optimizer: Optimizer, mode: Optional[str] = None,
                      aggregate: str = "mean") -> LocalServer:
        return LocalServer(optimizer, num_workers=self.num_workers,
                           device=self.device, mode=mode or self.config.mode,
                           aggregate=aggregate,
                           dc_lambda=self.config.dc_lambda)
