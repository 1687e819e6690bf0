"""Sparse KV: row-indexed push/pull on an embedding table on one device.

Counterpart of ``ps_tpu/kv/sparse.py`` at one device. Workers send
(row_ids, row_grads); the server segment-sums duplicate rows and applies a
lazy row-wise optimizer to the touched rows only; pulls gather rows back.
At one device the reference's row exchange (``gather`` or ``a2a``) is the
identity (its ``k == 1`` branch), so there is none here and nothing is
ever dropped. The exchange across GPUs, ``export_rows`` / ``adopt_rows``
and save/restore are not ported yet.

The table and its optimizer state are updated in place by every apply;
that is what the reference's buffer donation bought it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ps_tpu_torch.api import current_context
from ps_tpu_torch.ops.sparse_apply import fused_sparse_apply, resolve_tier
from ps_tpu_torch.optim.rowwise import make_rowwise


class SparseEmbedding:
    """An embedding table with PS sparse push/pull semantics.

    Args:
      num_rows: vocabulary size.
      dim: embedding dimension.
      optimizer: 'sgd' | 'adagrad' | 'adam' (lazy, per-row state) or a
        RowwiseOptimizer.
      dtype: table dtype (f32 default; bf16 halves pull bytes).
      fused_apply: the apply tier ('cuda' | 'torch' | 'auto'); None
        inherits the backend's resolution of ``Config.fused_apply``.
    """

    def __init__(self, num_rows: int, dim: int, optimizer="adagrad",
                 dtype=torch.float32, fused_apply: Optional[str] = None,
                 **opt_kwargs):
        ctx = current_context()
        self.device = ctx.device
        self.num_rows = num_rows
        self.dim = dim
        self.dtype = dtype
        self._opt = make_rowwise(optimizer, **opt_kwargs)
        if fused_apply is None:
            fused_apply = ctx.backend.fused_apply_tier()
        self.fused_tier = resolve_tier(fused_apply, self.device)
        if self.fused_tier == "off":
            raise NotImplementedError(
                "fused_apply 'off' (the masked full-table apply) is not "
                "ported yet; use 'auto'")
        self._table: Optional[torch.Tensor] = None
        self._state: Any = None

        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.push_count = 0
        self.rows_pushed = 0
        # per-row change stamps: row i's last-touching push, in push_count
        # units (the reference's conditional read path keys off them)
        self.row_version = np.zeros((num_rows,), np.int64)

    @property
    def dropped_rows(self) -> int:
        """Pushed updates lost to a2a bucket overflow: always 0 at one
        device, where the exchange is the identity."""
        return 0

    def init(self, rng_or_table, scale: float = 0.01) -> torch.Tensor:
        """Create (or adopt) the table and its per-row optimizer state on
        the device. ``rng_or_table`` is a ``[num_rows, dim]`` numpy array
        or tensor, or a ``torch.Generator`` for ``scale * N(0, 1)`` rows
        (drawn on the generator's device). Returns the placed table."""
        if self._table is not None:
            raise RuntimeError("SparseEmbedding.init already called")
        if isinstance(rng_or_table, torch.Generator):
            table = torch.randn((self.num_rows, self.dim),
                                generator=rng_or_table,
                                device=rng_or_table.device,
                                dtype=torch.float32).mul_(scale)
        else:
            table = torch.as_tensor(rng_or_table)
            if tuple(table.shape) != (self.num_rows, self.dim):
                raise ValueError(f"table shape {tuple(table.shape)} != "
                                 f"({self.num_rows}, {self.dim})")
        # a fresh buffer: the table is updated in place from now on
        self._table = table.to(self.device, self.dtype, copy=True)
        self._state = self._opt.init(self._table)
        return self._table

    # -- functional pieces (the composite step calls these) ------------------

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """rows = table[ids], shape ``ids.shape + (dim,)``. Valid ids are
        the caller's contract."""
        flat = ids.reshape(-1).to(torch.int64)
        return table.index_select(0, flat).reshape(*ids.shape, self.dim)

    def apply(self, table: torch.Tensor, state: Any, ids: torch.Tensor,
              row_grads: torch.Tensor) -> Tuple[torch.Tensor, Any, int]:
        """Apply summed row grads to ``table`` and ``state`` in place.

        ``ids``: [N] int32 (duplicates allowed); ``row_grads``: [N, D]
        grads w.r.t. the gathered rows. Ids outside the table are filler,
        as the reference's owner-shard mask makes them. On the card the
        kernels' grouping pass sets them aside and never reads their
        grads, so nothing is masked or copied here; on the CPU they are
        masked as the reference masks them. Returns ``(table, state,
        dropped)`` with ``dropped`` always 0 here."""
        ids = ids.reshape(-1).to(torch.int32)
        if table.device.type == "cuda":
            g = row_grads.reshape(-1, self.dim).to(torch.float32).contiguous()
            table, state = fused_sparse_apply(table, state, ids, g, self._opt,
                                              self.fused_tier)
            return table, state, 0
        ok = (ids >= 0) & (ids < self.num_rows)
        ids_m = torch.where(ok, ids, -1)
        g = torch.where(ok[:, None], row_grads.reshape(-1, self.dim), 0.0
                        ).to(torch.float32)
        table, state = fused_sparse_apply(table, state, ids_m, g, self._opt,
                                          self.fused_tier)
        return table, state, 0

    # -- eager PS API ----------------------------------------------------------

    @property
    def table(self) -> torch.Tensor:
        if self._table is None:
            raise RuntimeError("SparseEmbedding.init not called")
        return self._table

    def state(self):
        return self._state

    def pull(self, ids) -> torch.Tensor:
        """Gather current rows for ids (the sparse pull). ``ids``: a list,
        an array or a tensor on any device."""
        ids = torch.as_tensor(ids).to(self.device, torch.int32)
        rows = self.lookup(self.table, ids)
        self.bytes_pulled += rows.numel() * rows.element_size()
        return rows

    def push(self, ids, row_grads) -> None:
        """Send (ids, row_grads); the server applies them at once. ``ids``
        may lie on the device already; only ``row_version`` reads them on
        the host."""
        ids = torch.as_tensor(ids).reshape(-1).to(self.device, torch.int32)
        row_grads = torch.as_tensor(row_grads).to(self.device)
        if tuple(row_grads.shape) != (ids.shape[0], self.dim):
            raise ValueError(f"row_grads shape {tuple(row_grads.shape)} != "
                             f"({ids.shape[0]}, {self.dim})")
        self.apply(self.table, self._state, ids, row_grads)
        self.bytes_pushed += row_grads.numel() * row_grads.element_size()
        self.push_count += 1
        host_ids = ids.cpu().numpy()
        touched = host_ids[(host_ids >= 0) & (host_ids < self.num_rows)]
        self.row_version[touched] = self.push_count
        self.rows_pushed += ids.shape[0]  # no collective bytes at one device
