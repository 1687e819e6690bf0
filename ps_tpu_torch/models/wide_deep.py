"""Wide-&-Deep for Criteo-style CTR — the reference's workload config 4.

Counterpart of ``ps_tpu/models/wide_deep.py``. The module holds only the
dense parameters (wide linear + deep MLP); the embedding tables live in
``SparseEmbedding`` stores and their gathered rows come in as inputs. All
26 categorical features share one row space via per-feature id offsets,
so one table serves the deep side (dim D) and one the wide side (dim 1).

Layer names are flax's (``wide_dense``, ``mlp_i``, ``deep_out``), and the
deep input is concatenated in the same order, ``[dense ; deep_rows]``, so
:meth:`WideDeep.params_from_jax` carries the reference's weights across:
a flax ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight``
``[out, in]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

# flax's lecun_normal draws a unit normal truncated to [-2, 2], rescaled by
# this constant (its standard deviation) so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    num_dense: int = 13
    num_sparse: int = 26
    per_feature_vocab: int = 100_000
    embed_dim: int = 16
    mlp: Sequence[int] = (256, 128, 64)

    @property
    def total_rows(self) -> int:
        return self.num_sparse * self.per_feature_vocab

    def global_ids(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """Map per-feature ids [B, F] into the shared row space."""
        offsets = torch.arange(self.num_sparse, dtype=sparse_ids.dtype,
                               device=sparse_ids.device) * self.per_feature_vocab
        return sparse_ids + offsets[None, :]


class WideDeep(nn.Module):
    """Dense half of Wide-&-Deep: ``(dense, deep_rows, wide_rows) -> logit``.

    deep_rows: [B, F, D] gathered deep-embedding rows.
    wide_rows: [B, F, 1] gathered wide (per-id weight) rows.

    Weights start as flax's ``Dense`` defaults (lecun-normal kernels, zero
    biases), drawn from ``generator``.
    """

    def __init__(self, cfg: WideDeepConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.wide_dense = nn.Linear(cfg.num_dense, 1)
        width = cfg.num_dense + cfg.num_sparse * cfg.embed_dim
        self._mlp = []
        for i, out in enumerate(cfg.mlp):
            layer = nn.Linear(width, out)
            setattr(self, f"mlp_{i}", layer)
            self._mlp.append(layer)
            width = out
        self.deep_out = nn.Linear(width, 1)
        with torch.no_grad():
            for layer in self.modules():
                if isinstance(layer, nn.Linear):
                    std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                          b=2 * std, generator=generator)
                    layer.bias.zero_()

    def forward(self, dense, deep_rows, wide_rows):
        # wide: linear over dense features + sum of per-id weights
        wide = self.wide_dense(dense) + wide_rows.sum(dim=1)
        # deep: MLP over [dense ; flattened embeddings]
        x = torch.cat([dense, deep_rows.reshape(deep_rows.shape[0], -1)],
                      dim=-1)
        for layer in self._mlp:
            x = torch.relu(layer(x))
        deep = self.deep_out(x)
        return (wide + deep)[..., 0]

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters as ``{layer: {'bias', 'weight'}}``, the nested
        dict a KVStore registers (keys ``'mlp_0/weight'``, ...)."""
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in self.named_parameters():
            layer, leaf = name.split(".")
            tree.setdefault(layer, {})[leaf] = p
        return tree

    @torch.no_grad()
    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the reference's parameters, given as ``{key: array}`` in
        ``ps_tpu.kv.keys.flatten_with_keys`` keys (``'mlp_0/kernel'``,
        ``'mlp_0/bias'``, ...). Kernels ``[in, out]`` are transposed."""
        layers = dict(self.named_children())
        want = {f"{n}/{leaf}" for n in layers for leaf in ("kernel", "bias")}
        if set(flat) != want:
            raise ValueError(f"keys {sorted(set(flat) ^ want)} do not match "
                             f"the module's layers")
        for key, arr in flat.items():
            name, leaf = key.split("/")
            src = torch.tensor(np.asarray(arr, np.float32))
            dst = layers[name].weight if leaf == "kernel" else layers[name].bias
            if leaf == "kernel":
                src = src.T
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(src)


def bce_loss(logits, labels):
    """Mean sigmoid binary cross-entropy (labels in {0,1})."""
    logits = logits.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def make_wide_deep_loss_fn(model: WideDeep):
    """Composite-step loss closure for ``make_composite_step``:
    ``loss_fn(dense_params, rows, batch)`` with rows = {'deep', 'wide'} and
    dense_params the nested dict of :meth:`WideDeep.param_tree`."""

    def loss_fn(params, rows, batch):
        flat = {f"{layer}.{leaf}": p
                for layer, leaves in params.items()
                for leaf, p in leaves.items()}
        logits = torch.func.functional_call(
            model, flat, (batch["dense"], rows["deep"], rows["wide"]))
        return bce_loss(logits, batch["label"])

    return loss_fn


def make_ids_fn(cfg: WideDeepConfig):
    def ids_fn(batch):
        gids = cfg.global_ids(batch["sparse"])
        return {"deep": gids, "wide": gids}

    return ids_fn
