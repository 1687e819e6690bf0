"""2-layer MLP — the reference's MNIST model (workload config 1, "dense
push/pull: 2-layer MLP on MNIST").

Counterpart of ``ps_tpu/models/mlp.py``: flatten, ``dense1``, ReLU,
``dense2``, over 784 → hidden → 10. Functional, as flax's module is:
:meth:`MLP.init` returns the nested params ``{"dense1": {"kernel": [in,
out], "bias": [out]}, "dense2": {...}}`` (flax's layout and keys, so a
KVStore registers the reference's key strings in its order) and
:meth:`MLP.apply` the logits. The products are plain ``x @ kernel +
bias``: the reference runs them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.models.draws import lecun_normal


class MLP:
    """784 → hidden → 10 classifier over images ``[B, 28, 28, 1]`` (any
    trailing shape of ``in_features`` elements)."""

    def __init__(self, hidden: int = 256, num_classes: int = 10,
                 in_features: int = 28 * 28):
        self.hidden = hidden
        self.num_classes = num_classes
        self.in_features = in_features

    def shapes(self) -> Dict[str, tuple]:
        """``{param key: shape}`` in flax's layout."""
        return {"dense1/kernel": (self.in_features, self.hidden),
                "dense1/bias": (self.hidden,),
                "dense2/kernel": (self.hidden, self.num_classes),
                "dense2/bias": (self.num_classes,)}

    def init(self, generator: torch.Generator = None, device=None):
        """Params drawn as flax draws them: lecun_normal kernels (a unit
        normal truncated to [-2, 2] by its inverse CDF, variance 1/fan_in),
        zero biases. Drawn on the CPU in key order, so a generator's seed
        gives the same weights on any device."""
        flat = {}
        for key, shape in sorted(self.shapes().items()):
            if key.endswith("kernel"):
                flat[key] = lecun_normal(shape, shape[0], generator)
            else:
                flat[key] = torch.zeros(shape)
        return _nest({k: t.to(device) for k, t in flat.items()})

    def params_from_jax(self, params, device=None):
        """The reference's params (nested as flax's init gives them, or
        ``{key: array}``, numpy) as the port's nested tensors; the layouts
        are the same. A key or shape that does not fit raises."""
        flat, _ = keymod.flatten_with_keys(params)
        own = self.shapes()
        if set(flat) != set(own):
            raise ValueError(f"keys {sorted(set(flat) ^ set(own))} do not "
                             f"match the model's params")
        out = {}
        for key, arr in flat.items():
            t = torch.tensor(np.asarray(arr, np.float32))
            if tuple(t.shape) != own[key]:
                raise ValueError(f"{key}: shape {tuple(t.shape)} does not fit "
                                 f"{own[key]}")
            out[key] = t.to(device)
        return _nest(out)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, num_classes]``."""
        x = x.reshape(x.shape[0], -1)
        x = x @ params["dense1"]["kernel"] + params["dense1"]["bias"]
        x = torch.relu(x)
        return x @ params["dense2"]["kernel"] + params["dense2"]["bias"]


def _nest(flat: Dict[str, torch.Tensor]):
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        layer, leaf = key.split("/")
        out.setdefault(layer, {})[leaf] = t
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels: the mean over the
    batch of ``-log_softmax(logits)`` taken at each label."""
    logp = torch.take_along_dim(torch.log_softmax(logits, dim=-1),
                                labels.long()[:, None], dim=-1).squeeze(-1)
    return -logp.mean()


def make_loss_fn(model: MLP):
    """``loss_fn(params, (images, labels))`` for the PS steps."""

    def loss_fn(params, batch):
        images, labels = batch
        return cross_entropy_loss(model.apply(params, images), labels)

    return loss_fn
