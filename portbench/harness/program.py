"""The system under test, as the harness holds it: one training step of
``ps_tpu_torch`` built once (the store, its model and optimizer state),
driven through the ``run`` closure of ``KVStore.make_step``, and read
back after its first steps for the comparison with the reference.

A system module (``portbench/systems/<system>.py``) builds the store and
says how a batch is passed; this module reads what every such step
shares: the first gradient as the optimizer got it, worked out from its
state after one step, the parameters, and the state the step threads
(BatchNorm's running statistics).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}``."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def flatten(tree) -> Dict[str, torch.Tensor]:
    """``{"a": {"b": v}}`` -> ``{"a/b": v}``, keys sorted."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v

    walk(tree, "")
    return out


class Program:
    """One built step of the system under test.

    ``store`` is its ``KVStore``; ``call(batch, aux) -> (loss, aux)`` runs
    one step through ``make_step``'s closure, with ``aux`` the state the
    step threads (None where there is none) and ``loss`` left on the
    device."""

    def __init__(self, store, call: Callable, aux, optimizer: dict):
        self.store = store
        self._call = call
        self.aux = aux
        self.optimizer = optimizer

    @property
    def engine(self):
        """The store's server engine, whose ``step_`` the fused step
        calls."""
        return self.store._engine

    def step(self, batch) -> torch.Tensor:
        loss, self.aux = self._call(batch, self.aux)
        return loss

    def first_grad_norms(self) -> Dict[str, float]:
        """Every leaf's gradient norm as the optimizer got it at the first
        step, from its state after that step: LAMB's and Adam's first
        moment is ``(1 - b1)·g``, momentum's trace is ``g``."""
        name = self.optimizer["name"]
        keys = self.store.keys()
        if name in ("lamb", "adam"):
            scale = 1.0 / (1.0 - self.optimizer.get("b1", 0.9))
            tensors = [self.store.optimizer_state(k)["mu"] for k in keys]
        elif name == "momentum":
            scale = 1.0
            tensors = [self.store.optimizer_state(k) for k in keys]
        else:
            raise ValueError(f"no first gradient in {name!r}'s state")
        norms = torch.stack([torch.linalg.vector_norm(t.double())
                             for t in tensors]) * scale
        return dict(zip(keys, norms.cpu().tolist()))

    def params(self) -> Dict[str, torch.Tensor]:
        """The server's current parameters, by key."""
        return flatten(self.store.params())

    def state(self) -> Dict[str, torch.Tensor]:
        """The state the step threads, by key (empty where none)."""
        return flatten(self.aux) if isinstance(self.aux, dict) else {}

    def close(self) -> None:
        import ps_tpu_torch as ps

        self.store = self._call = self.aux = None
        ps.shutdown()
