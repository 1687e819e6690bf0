"""KVStore — the user-facing worker API over parameter keys.

Counterpart of ``ps_tpu/kv/store.py``'s whole-tree surface on the 'cuda'
backend: ``init``, ``keys``, ``params``, ``push_pull``, the fused
``make_step`` and ``shard_batch``, with the byte counters behind the
push/pull GB/s metric and ``collective_bytes`` (0: one device runs no
collective). The step runs eagerly and updates the server's
parameters and optimizer state in place, which is what the reference's
donated XLA program bought it; tensors returned by ``params()`` or a step
are the server's own and change with the next step. Per-key push/pull and
the local backend are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from ps_tpu_torch.api import current_context
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.optim import Optimizer, make_optimizer


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def to_device(batch: Any, device, non_blocking: bool = False) -> Any:
    """Place a host batch (an array or tensor, or a dict, tuple or list of
    them) on ``device`` with ``.to(device)``. With ``non_blocking`` on a
    CUDA device each host array is first copied into pinned memory, so the
    copy to the card does not block the host."""
    device = torch.device(device)
    if isinstance(batch, dict):
        return {k: to_device(v, device, non_blocking)
                for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device, non_blocking) for v in batch)
    t = torch.as_tensor(batch)
    if not (non_blocking and device.type == "cuda"):
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class KVStore:
    """A named parameter store with PS push/pull semantics.

    Args:
      optimizer: 'sgd' | 'momentum' | 'adam' | 'lamb' or an
        :class:`~ps_tpu_torch.optim.Optimizer` — the server-side update rule.
      mode: 'sync' | None (inherit from Config); async is not ported yet.
      aggregate: 'mean' (default) or 'sum'.
      placement: 'replicated' or 'sharded' — the same at one device.
      **opt_kwargs: forwarded to the named optimizer (e.g. learning_rate).
    """

    def __init__(self, optimizer: Union[str, Optimizer] = "sgd",
                 mode: Optional[str] = None, aggregate: str = "mean",
                 placement: str = "replicated", partition_rules=None,
                 **opt_kwargs):
        ctx = current_context()
        self._ctx = ctx
        self._opt = make_optimizer(optimizer, **opt_kwargs)
        if placement not in ("replicated", "sharded"):
            raise ValueError("placement must be 'replicated' or 'sharded'")
        self.placement = placement
        self._engine = ctx.backend.create_server(
            self._opt, mode=mode, aggregate=aggregate, placement=placement,
            partition_rules=partition_rules)
        self._treedef = None
        self._key_order: List[str] = []
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.step = 0

    def init(self, params: Any) -> Any:
        """Register a nested dict of tensors (or arrays) with the server;
        returns the params as the server placed them."""
        if self._treedef is not None:
            raise RuntimeError("KVStore.init already called")
        kv, treedef = keymod.flatten_with_keys(params)
        self._treedef = treedef
        self._key_order = list(kv)
        return self._engine.register_tree(kv, treedef, self._key_order)

    def keys(self) -> List[str]:
        return list(self._key_order)

    def _require_init(self) -> None:
        if self._treedef is None:
            raise RuntimeError("KVStore.init(params) must be called first")

    def push_pull(self, grads: Any, worker: int = 0) -> Any:
        """Fused push + apply + pull for a whole gradient tree."""
        del worker
        self._require_init()
        kv, _ = keymod.flatten_with_keys(grads)
        if set(kv) != set(self._key_order):
            raise ValueError(
                "gradient tree structure does not match registered params")
        nbytes = sum(_nbytes(v) for v in kv.values())
        self.bytes_pushed += nbytes
        self.bytes_pulled += nbytes
        out = self._engine.update_tree(kv)
        self.step += 1
        return keymod.unflatten(self._treedef, out, self._key_order)

    def make_step(self, loss_fn, has_aux: bool = False):
        """Build ``run(batch, *extra) -> (loss, params)`` (or ``(loss,
        params, aux)``): gradient of ``loss_fn(params, batch, *extra)``,
        then the server apply, in place. ``loss_fn`` returns a scalar loss
        meaned over the global batch (or ``(loss, aux)`` with has_aux)."""
        self._require_init()
        engine = self._engine
        treedef, key_order = self._treedef, self._key_order
        opt = self._opt
        grad_scale = engine.grad_scale

        def run(batch, *extra):
            params_kv, state = engine.get_tree_and_state()
            leaves = {k: params_kv[k].detach().requires_grad_()
                      for k in key_order}
            out = loss_fn(keymod.unflatten(treedef, leaves, key_order),
                          batch, *extra)
            loss, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(loss, [leaves[k] for k in key_order])
            with torch.no_grad():
                gkv = {k: g * grad_scale if grad_scale != 1.0 else g
                       for k, g in zip(key_order, grads)}
                opt.step_(params_kv, gkv, state)
            engine.set_tree_and_state(params_kv, state)
            nbytes = sum(_nbytes(v) for v in params_kv.values())
            self.bytes_pushed += nbytes
            self.bytes_pulled += nbytes
            self.step += 1
            params = keymod.unflatten(treedef, params_kv, key_order)
            if has_aux:
                return loss.detach(), params, aux
            return loss.detach(), params

        return run

    def shard_batch(self, batch: Any) -> Any:
        """Place a host batch (a dict, tuple or list of arrays or tensors,
        e.g. ``(images, labels)``) on the device (:func:`to_device`)."""
        return to_device(batch, self._ctx.device)

    def params(self) -> Any:
        """Current server-side parameter tree — introspection only."""
        self._require_init()
        kv = {k: self._engine.pull(k) for k in self._key_order}
        return keymod.unflatten(self._treedef, kv, self._key_order)

    @property
    def collective_bytes(self) -> int:
        """Bytes the server's collectives have moved per device (the
        reference's analytic ICI traffic): 0, since one device runs no
        collective."""
        return 0
