"""What the port's parameter servers share.

Counterpart of the engine half of ``ps_tpu/backends/common.py``: the
async whole-tree DC apply (``make_dc_apply_tree``), the side-effect-free
read (``PeekMixin``), the per-worker staging of per-key async pushes
(``AsyncStagingMixin``) and the worker-id floor of aggregator identities
(``AGG_WORKER_BASE``), plus the one place a backend picks its device.
The transport, bucket and failover parts of the reference's file belong
to the van plane and are not ported yet.

Every apply here is out of place: it clones the parameter, updates the
clone and puts it in the server's dict, so a tensor a worker pulled (and
the async stale snapshot, which is that same tensor) keeps its values, as
a JAX array does. Optimizer state is the server's own and is updated in
place.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ps_tpu_torch.optim import Optimizer, delay_compensate

#: Worker-id floor for aggregator identities: an aggregator pushes its
#: group's merged gradient under a synthetic worker id past this base, so
#: its DC staleness bookkeeping never collides with a real worker's slot
#: (real ids live in [0, num_workers); the engines admit ids at or past
#: this base explicitly).
AGG_WORKER_BASE = 1 << 20


def backend_device(config) -> torch.device:
    """The one device a backend places everything on: ``config.device``,
    ``cuda:0`` for a bare 'cuda'. Raises when that is a GPU and torch
    finds none; the CPU is used only when the caller names it."""
    device = torch.device(config.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend {config.backend!r} needs an NVIDIA GPU and torch "
                f"finds none; pass device='cpu' to run on the CPU on purpose")
        if device.index is None:
            device = torch.device("cuda", 0)
    return device


def device_copy(value, device) -> torch.Tensor:
    """A fresh copy of a tensor or array on ``device``: a registered value
    never shares memory with the caller's."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.tensor(np.asarray(value), device=device)


def apply_out_of_place(opt: Optimizer, params: Dict[str, torch.Tensor],
                       grads: Dict[str, torch.Tensor], state
                       ) -> Dict[str, torch.Tensor]:
    """One optimizer step on clones of ``params``; returns the new tensors
    and advances ``state`` in place. The given tensors keep their values."""
    new = {k: p.clone() for k, p in params.items()}
    opt.step_(new, grads, state)
    return new


def make_dc_apply_tree(opt: Optimizer):
    """The async whole-tree apply: ``fn(params, states, grads, stales, lam)
    -> (params, states)`` over ``{key: ...}`` dicts with one optimizer
    state a key. Key by key: the DC correction against that key's stale
    snapshot, then the optimizer step on the key's own state. The
    reference jits this loop into one XLA program; here it runs eagerly."""

    def apply_dc_tree(params, states, grads, stales, lam):
        grads = delay_compensate(grads, params, stales, lam)
        new_p = {}
        for k in params:
            new_p.update(apply_out_of_place(opt, {k: params[k]},
                                            {k: grads[k]}, states[k]))
        return new_p, {k: states[k] for k in params}

    return apply_dc_tree


class PeekMixin:
    """Side-effect-free key read for introspection (``KVStore.params()``):
    never records an async pull snapshot or checks aggregation state."""

    def peek(self, key: str) -> torch.Tensor:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        return self._params[key]


class AsyncStagingMixin:
    """Per-key async pushes stage per worker and commit as one tree apply
    when that worker's tree completes, so the version bump and the
    staleness sample go to the worker that completed a tree, never to
    whichever worker pushed last under interleaving.

    Liveness: a worker that pushes only some keys commits that partial
    tree when it pulls (the pull ends its push phase in the PS cycle).
    Keys are independent under per-tensor optimizers, so a partial commit
    is the same arithmetic as per-key applies.

    The mixin also keeps the async version bookkeeping both engines share:
    ``version``, ``staleness`` and the pull that records a worker's stale
    snapshot (``_pull_async``).

    Engine contract: ``self._staged_async``/``self._params``/
    ``self._state``/``self._stale``/``self._worker_version`` dicts,
    ``self._apply_dc_tree``, ``self.dc_lambda``, ``self.apply_count``,
    ``self.staleness_hist``, ``self._version`` and ``self.device`` exist,
    and the caller holds the engine lock. Engines may override
    ``_commit_tree_accounting``.
    """

    @property
    def version(self) -> int:
        """Server version in whole-model steps."""
        return self._version

    def staleness(self, worker: int) -> int:
        """Whole-model versions since this worker's last pull (the τ of
        the DC-ASGD correction)."""
        return self._version - self._worker_version.get(worker, 0)

    def _pull_async(self, worker, keys) -> Dict[str, torch.Tensor]:
        """An async pull of ``keys``: commit the worker's staged pushes (a
        pull ends its push phase), then record what it got as its stale
        snapshot and the version it saw — lock held."""
        self._flush_staged(worker)
        out = {k: self._params[k] for k in keys}
        for k, v in out.items():
            self._stale[(worker, k)] = v
        self._worker_version[worker] = self._version
        return out

    def _stage_async_push(self, key, grad, worker) -> None:
        staged = self._staged_async.setdefault(worker, {})
        if key in staged:
            raise RuntimeError(
                f"worker {worker} pushed key {key!r} twice before committing "
                f"— per-key async pushes commit when the full tree is pushed "
                f"or at this worker's next pull (partial tree)")
        staged[key] = grad
        if len(staged) == len(self._params):
            del self._staged_async[worker]
            self._commit_tree(staged, worker)

    def _flush_staged(self, worker) -> None:
        """Commit this worker's staged partial tree, if any (at the top of
        every async pull, lock held)."""
        staged = self._staged_async.pop(worker, None)
        if staged:
            self._commit_tree(staged, worker)

    def _commit_tree(self, grads_kv, worker) -> None:
        """One DC apply of a (possibly partial) tree — lock held."""
        grads_kv = {k: torch.as_tensor(g, device=self.device)
                    for k, g in grads_kv.items()}
        sub_p = {k: self._params[k] for k in grads_kv}
        sub_s = {k: self._state[k] for k in grads_kv}
        stales = {k: self._stale.get((worker, k), self._params[k])
                  for k in grads_kv}
        new_p, new_s = self._apply_dc_tree(sub_p, sub_s, grads_kv, stales,
                                           self.dc_lambda)
        self._params.update(new_p)
        self._state.update(new_s)
        for k in grads_kv:
            self.apply_count[k] += 1
        self.staleness_hist[self.staleness(worker)] += 1
        self._version += 1
        self._commit_tree_accounting(grads_kv)

    def _commit_tree_accounting(self, grads_kv) -> None:
        """Engine hook: extra counters per committed tree (default none)."""

    def _check_staged_async(self) -> None:
        """Guard for a whole-state read (a checkpoint): staged but
        uncommitted grads would be lost."""
        pending = {w: sorted(kv) for w, kv in self._staged_async.items()
                   if kv}
        if pending:
            raise RuntimeError(
                f"cannot checkpoint mid-push: workers {sorted(pending)} have "
                f"staged but uncommitted per-key async pushes")
