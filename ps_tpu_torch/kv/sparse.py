"""Sparse KV: row-indexed push/pull on an embedding table on one device.

Counterpart of ``ps_tpu/kv/sparse.py`` at one device. Workers send
(row_ids, row_grads); the server segment-sums duplicate rows and applies a
lazy row-wise optimizer to the touched rows only; pulls gather rows back.
At one device the reference's row exchange (``gather`` or ``a2a``) is the
identity (its ``k == 1`` branch), so there is none here and nothing is
ever dropped. The exchange across GPUs is not ported yet.

The table and its optimizer state are updated in place by every apply;
that is what the reference's buffer donation bought it. A row moves with
its optimizer state (``export_rows`` / ``adopt_rows``), and ``save`` /
``restore`` checkpoint both (``ps_tpu_torch/checkpoint.py``, engine
``sparse``). Whatever a restore or ``adopt_state`` installs is checked
first to be what the CUDA kernel takes: contiguous, on the table's
device, in the table's and the state's dtypes.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch.api import current_context
from ps_tpu_torch.ops.sparse_apply import fused_sparse_apply, resolve_tier
from ps_tpu_torch.ops.sparse_apply import state_leaves as _leaves
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
        self.collective_bytes = 0  # one device runs no collective
        self._dropped_base = 0  # drops carried over by a restore
        # per-row change stamps: row i's last-touching push, in push_count
        # units (the reference's conditional read path keys off them)
        self.row_version = np.zeros((num_rows,), np.int64)

    @property
    def dropped_rows(self) -> int:
        """Pushed updates lost to a2a bucket overflow. One device adds
        none (its exchange is the identity); a restore carries over what
        the checkpoint counted."""
        return self._dropped_base

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

    # -- row movement ------------------------------------------------------------

    def _check_installable(self, table: torch.Tensor, state: Any) -> None:
        """Refuse a table or state the apply kernel could not take: each
        tensor must have the live one's shape and dtype and lie contiguous
        on ``self.device`` (the kernel writes through raw pointers)."""
        live = [self.table] + _leaves(self._state)
        got = [table] + _leaves(state)
        if len(got) != len(live):
            raise ValueError(f"{len(got) - 1} optimizer-state leaves, this "
                             f"table's optimizer has {len(live) - 1}")
        for i, (g, want) in enumerate(zip(got, live)):
            what = "table" if i == 0 else f"optimizer-state leaf {i - 1}"
            ckpt.check_like(what, g, want)
            if g.device != self.device or not g.is_contiguous():
                raise ValueError(f"{what} must be contiguous on "
                                 f"{self.device}, got one on {g.device}")

    def export_rows(self, slots) -> Tuple[np.ndarray, list]:
        """Copy ``slots``' rows and their per-row optimizer state out to
        host memory (a row never travels without its state). Returns
        ``(rows [n, D], state_leaves)`` as numpy, the leaves in tree order
        (dict keys sorted: ``[m, t, v]`` for adam), each sliced to
        ``slots``. A bf16 table's rows come out as f32 (numpy holds no
        bf16); the widening is exact."""
        idx = torch.as_tensor(slots).reshape(-1).to(self.device, torch.int64)
        rows = self.table.index_select(0, idx)
        if rows.dtype == torch.bfloat16:
            rows = rows.float()
        leaves = [leaf.index_select(0, idx).cpu().numpy()
                  for leaf in _leaves(self._state)]
        return rows.cpu().numpy(), leaves

    def adopt_rows(self, slots, rows, state_leaves) -> None:
        """Write host rows and their per-row optimizer state into
        ``slots``, in place: the inverse of :meth:`export_rows`. Costs
        O(moved rows), not a table pass."""
        idx = torch.as_tensor(slots).reshape(-1).to(self.device, torch.int64)
        live = _leaves(self._state)
        if len(state_leaves) != len(live):
            raise ValueError(f"{len(state_leaves)} optimizer-state "
                             f"leaves, this table's optimizer has {len(live)}")
        self.table.index_copy_(0, idx, torch.as_tensor(rows).to(
            self.device, self.dtype))
        for leaf, v in zip(live, state_leaves):
            leaf.index_copy_(0, idx, torch.as_tensor(v).to(self.device,
                                                          leaf.dtype))

    def adopt_state(self, table: torch.Tensor, state: Any) -> None:
        """Adopt an externally restored (table, state) pair, after checking
        that the kernel can take it."""
        if self._table is None:
            raise RuntimeError("SparseEmbedding.init must precede adopt_state")
        self._check_installable(table, state)
        self._table, self._state = table, state

    # -- checkpoint/resume -----------------------------------------------------

    def _dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    def save(self, path: str) -> None:
        """Checkpoint the table and its per-row optimizer state."""
        arrays = {
            "table": ckpt.to_cpu(self.table),
            "opt": {i: ckpt.to_cpu(t)
                    for i, t in ckpt.flatten_leaves(self._state).items()},
        }
        meta = {
            "engine": "sparse",
            "num_rows": self.num_rows,
            "dim": self.dim,
            "dtype": self._dtype_name(),
            "opt_structure": ckpt.opt_fingerprint(self._opt.kind,
                                                  self._state),
            "push_count": self.push_count,
            "bytes_pushed": self.bytes_pushed,
            "bytes_pulled": self.bytes_pulled,
            "collective_bytes": self.collective_bytes,
            "rows_pushed": self.rows_pushed,
            "dropped_rows": self.dropped_rows,
        }
        ckpt.save(path, arrays, meta)

    def restore(self, path: str) -> torch.Tensor:
        """Restore a checkpoint written by :meth:`save`. Call after
        ``init`` (same num_rows, dim, dtype and optimizer). Every check
        runs first, the kernel's included, so a refused restore changes
        nothing. Returns the restored table."""
        if self._table is None:
            raise RuntimeError(
                "SparseEmbedding.init must be called before restore")
        meta = ckpt.read_meta(path)
        if meta.get("engine") != "sparse":
            raise ValueError(
                f"checkpoint was written by engine {meta.get('engine')!r}, "
                f"not a sparse table")
        if (meta["num_rows"], meta["dim"]) != (self.num_rows, self.dim):
            raise ValueError(
                f"checkpoint table is ({meta['num_rows']}, {meta['dim']}), "
                f"this embedding is ({self.num_rows}, {self.dim})")
        if meta["dtype"] != self._dtype_name():
            raise ValueError(
                f"checkpoint table dtype is {meta['dtype']}, this embedding "
                f"is {self._dtype_name()} — restore would silently cast")
        live_structure = ckpt.opt_fingerprint(self._opt.kind, self._state)
        if meta.get("opt_structure", live_structure) != live_structure:
            raise ValueError(
                f"checkpoint optimizer state does not match this table's "
                f"optimizer (saved {meta['opt_structure']!r}, live "
                f"{live_structure!r})")
        arrays = ckpt.restore(path, meta)
        table = ckpt.place(arrays["table"], self.device)
        state = ckpt.unflatten_like(
            self._state, {i: ckpt.place(t, self.device)
                          for i, t in arrays.get("opt", {}).items()})
        self._check_installable(table, state)
        self._table, self._state = table, state
        self.push_count = int(meta["push_count"])
        # change stamps are not checkpointed: every row is marked changed
        # at the restored version, so a conditional reader's delta can only
        # widen to "everything", never miss a row
        self.row_version[:] = self.push_count
        self.bytes_pushed = int(meta["bytes_pushed"])
        self.bytes_pulled = int(meta["bytes_pulled"])
        self.collective_bytes = int(meta["collective_bytes"])
        self.rows_pushed = int(meta["rows_pushed"])
        self._dropped_base = int(meta["dropped_rows"])
        return self._table
