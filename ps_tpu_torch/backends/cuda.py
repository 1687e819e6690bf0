"""The 'cuda' backend: a parameter server on one device.

Counterpart of ``ps_tpu/backends/tpu.py`` (``TpuServer`` and
``TpuBackend``) at one device. The server holds the parameter dict
``{key: tensor}`` and one whole-tree optimizer state on the device, and
updates both in place (in-place replaces the reference's donation). At
one device 'replicated' and 'sharded' (ZeRO-1) placement are the same
thing, as on a one-device mesh, and no collective moves a byte. Placement
across GPUs, async mode and the failure detector are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ps_tpu_torch.config import Config
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.ops.sparse_apply import resolve_tier


class CudaServer:
    """Parameter/optimizer-state store with PS semantics on one device."""

    def __init__(self, optimizer, device: torch.device,
                 aggregate: str = "mean", mode: str = "sync"):
        if mode != "sync":
            raise NotImplementedError("async mode is not ported yet")
        if aggregate not in ("mean", "sum"):
            raise ValueError("aggregate must be 'mean' or 'sum'")
        self._opt = optimizer
        self.device = device
        self.aggregate = aggregate
        self.num_workers = 1
        self._params: Dict[str, torch.Tensor] = {}
        self._state = None

    def register_tree(self, kv: Dict[str, Any], treedef, key_order: List[str]):
        if self._params:
            raise RuntimeError("server already holds a registered tree")
        # fresh buffers: the server updates them in place every step
        self._params = {k: torch.as_tensor(v).detach().to(self.device,
                                                          copy=True)
                        for k, v in kv.items()}
        self._state = self._opt.init(self._params)
        return keymod.unflatten(treedef, self._params, key_order)

    @property
    def grad_scale(self) -> float:
        """Aggregation factor on incoming global-mean grads: 1 for 'mean',
        num_workers for 'sum' (so 1 either way at one device)."""
        return float(self.num_workers) if self.aggregate == "sum" else 1.0

    def update_tree(self, grads_kv: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """One server step: apply the global grads in place; returns the
        new params (the server's own tensors)."""
        scale = self.grad_scale
        if scale != 1.0:
            grads_kv = {k: g * scale for k, g in grads_kv.items()}
        self._opt.step_(self._params, grads_kv, self._state)
        return dict(self._params)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        del worker
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        return self._params[key]

    # -- internals for the fused train step ---------------------------------

    def get_tree_and_state(self):
        return dict(self._params), self._state

    def set_tree_and_state(self, params, state):
        self._params, self._state = dict(params), state


class CudaBackend:
    """Backend for ``ps_tpu_torch.init(backend='cuda')``: everything on one
    device, ``cuda:0`` unless the config names the CPU."""

    def __init__(self, config: Config):
        self.config = config
        device = torch.device(config.device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'cuda' needs an NVIDIA GPU and torch finds "
                    "none; pass device='cpu' to run on the CPU on purpose")
            if device.index is None:
                device = torch.device("cuda", 0)
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
        return CudaServer(optimizer, self.device, aggregate=aggregate,
                          mode=mode or self.config.mode)
