"""Sparse KV: row-indexed push/pull on row-sharded embedding tables.

Counterpart of ``ps_tpu/kv/sparse.py``. Workers send (row_ids,
row_grads); the owner of each row segment-sums its duplicates and applies
a lazy row-wise optimizer to the touched rows only; pulls gather rows
back.

Across k ranks the table is row-range-sharded: ``padded_rows =
ceil(num_rows/k)·k``, and rank r owns rows ``[r·rps, (r+1)·rps)`` with
``rps = padded_rows/k`` (the pad rows are unreachable by valid ids), with
their optimizer state. Each rank passes its own ids. Exchanges for a
push:

- ``'gather'`` (lossless): all-gather the ids and the row gradients;
  each rank keeps the ids it owns (the rest become the -1 filler) and
  runs the sparse apply on its shard. Per-rank bytes ≈
  N·(D+1)·4·(k-1)/k for N ids over all ranks.
- ``'a2a'``: duplicates merge on each rank first, then each rank routes
  its unique rows into per-destination buckets of capacity
  ``C = ceil(N_local/k · capacity_factor)`` and ``all_to_all`` sends each
  bucket to its owner. Rows that overflow a bucket are dropped and
  counted in raw updates (:attr:`SparseEmbedding.dropped_rows`, summed
  over ranks); ``capacity_factor = k`` is lossless.

A lookup or pull (the reference gets it from GSPMD's partitioned
``jnp.take``) all-gathers the ids; each owner gathers the rows it holds
(zeros for the rest), and a reduce-scatter sums them back to the rank
that asked: every row is one owner's value plus zeros, so it arrives
exactly. Without a process group (one process) there is no exchange: the
reference's ``k == 1`` branch is the identity.

On the card the kernels' grouping pass sets ids outside the shard aside
(they are filler), so nothing is masked or copied for them; on the CPU
they are masked as the reference masks them. The table and its optimizer
state are updated in place by every apply, which is what the reference's
buffer donation bought it. A row moves with its optimizer state
(``export_rows`` / ``adopt_rows``, across ranks too: the tiered store's
demotions and promotions), and ``save`` / ``restore`` checkpoint both
(``ps_tpu_torch/checkpoint.py``, engine ``sparse``), each rank its rows; ``restore(elastic=True)`` re-pads and re-shards a
checkpoint written by another number of ranks. Whatever a restore or
``adopt_state`` installs is checked first to be what the CUDA kernel
takes: contiguous, on the table's device, in the table's and the state's
dtypes.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch.api import current_context
from ps_tpu_torch.ops.sparse_apply import fused_sparse_apply, resolve_tier
from ps_tpu_torch.ops.sparse_apply import state_leaves as _leaves
from ps_tpu_torch.optim.rowwise import make_rowwise
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import Mesh


class SparseEmbedding:
    """A row-sharded embedding table with PS sparse push/pull semantics.

    Args:
      num_rows: vocabulary size (padded internally to a multiple of the
        rank count).
      dim: embedding dimension.
      optimizer: 'sgd' | 'adagrad' | 'adam' (lazy, per-row state) or a
        RowwiseOptimizer.
      exchange: 'gather' (lossless) | 'a2a' (capacity-bounded all-to-all).
      capacity_factor: 'a2a' only — the per-destination bucket capacity
        multiple.
      dtype: table dtype (f32 default; bf16 halves pull bytes).
      fused_apply: the apply tier ('cuda' | 'torch' | 'off' | 'auto');
        None inherits the backend's resolution of ``Config.fused_apply``.
        'off' is the masked full-table apply, O(table) a push.
    """

    def __init__(self, num_rows: int, dim: int, optimizer="adagrad",
                 exchange: str = "gather", capacity_factor: float = 2.0,
                 dtype=torch.float32, fused_apply: Optional[str] = None,
                 **opt_kwargs):
        if exchange not in ("gather", "a2a"):
            raise ValueError("exchange must be 'gather' or 'a2a'")
        ctx = current_context()
        self.device = ctx.device
        self.mesh = ctx.mesh if ctx.mesh is not None else Mesh({"data": 1})
        self.k = self.mesh.size
        self.num_rows = num_rows
        self.padded_rows = int(math.ceil(num_rows / self.k) * self.k)
        self.rows_per_shard = self.padded_rows // self.k
        self.dim = dim
        self.dtype = dtype
        self.exchange = exchange
        self.capacity_factor = capacity_factor
        self._opt = make_rowwise(optimizer, **opt_kwargs)
        if fused_apply is None:
            fused_apply = ctx.backend.fused_apply_tier()
        self.fused_tier = resolve_tier(fused_apply, self.device)
        self._table: Optional[torch.Tensor] = None
        self._state: Any = None

        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.push_count = 0
        self.rows_pushed = 0
        self.collective_bytes = 0
        # dropped updates: an int, or a device count the host has not read
        self._dropped: Any = 0
        # per-row change stamps: row i's last-touching push, in push_count
        # units (the reference's conditional read path keys off them)
        self.row_version = np.zeros((num_rows,), np.int64)

    def record_dropped(self, dropped) -> None:
        """Add a (possibly device-resident) dropped-update count without
        waiting for the device."""
        if isinstance(dropped, torch.Tensor):
            dropped = dropped.to(torch.int64).sum()
        self._dropped = self._dropped + dropped

    @property
    def dropped_rows(self) -> int:
        """Raw pushed updates lost to a2a bucket overflow, over all ranks
        (0 under gather), in the units of :attr:`rows_pushed`: a dropped
        merged row counts every duplicate it carried. Reading it waits for
        the device's count."""
        return int(self._dropped)

    @property
    def dropped_fraction(self) -> float:
        """dropped_rows / rows_pushed (0.0 before any push)."""
        n = self.rows_pushed
        return (self.dropped_rows / n) if n else 0.0

    def _own(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a ``[padded_rows, ...]`` tensor."""
        rps = self.rows_per_shard
        return full[self.mesh.rank * rps:(self.mesh.rank + 1) * rps]

    def _pad(self, full: torch.Tensor) -> torch.Tensor:
        """``[num_rows, ...]`` -> ``[padded_rows, ...]``, zero rows after."""
        pad = self.padded_rows - full.shape[0]
        if not pad:
            return full
        return torch.cat([full, full.new_zeros((pad,) + full.shape[1:])])

    def init(self, rng_or_table, scale: float = 0.01) -> torch.Tensor:
        """Create (or adopt) the table and its per-row optimizer state on
        the device, this rank's rows of them. ``rng_or_table`` is a
        ``[num_rows, dim]`` numpy array or tensor, or a
        ``torch.Generator`` for ``scale * N(0, 1)`` rows (all ``num_rows``
        drawn on the generator's device, so every rank count gets the
        same table). Returns this rank's placed rows."""
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
        self._table = self._own(self._pad(table)).to(self.device, self.dtype,
                                                     copy=True)
        self._state = self._opt.init(self._table)
        return self._table

    # -- functional pieces (the composite step calls these) ------------------

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """rows = table[ids], shape ``ids.shape + (dim,)``, for this rank's
        ``ids`` (global row ids) from whichever rank owns each. Valid ids
        are the caller's contract."""
        flat = ids.reshape(-1).to(torch.int64)
        if self.mesh.group is None:
            return table.index_select(0, flat).reshape(*ids.shape, self.dim)
        local = (collectives.all_gather(flat, self.mesh)
                 - self.mesh.rank * self.rows_per_shard)
        ok = (local >= 0) & (local < self.rows_per_shard)
        rows = table.index_select(0, torch.where(ok, local, 0))
        rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
        return collectives.reduce_scatter(rows, self.mesh).reshape(
            *ids.shape, self.dim)

    def apply(self, table: torch.Tensor, state: Any, ids: torch.Tensor,
              row_grads: torch.Tensor) -> Tuple[torch.Tensor, Any, Any]:
        """Apply summed row grads to this rank's ``table`` shard and
        ``state`` in place.

        ``ids``: [N] global row ids of this rank's push (duplicates and
        the -1 filler allowed; every rank passes the same N); ``row_grads``:
        [N, D] grads w.r.t. the gathered rows. The exchange brings each row
        to its owner; ids this rank does not own are filler, as the
        reference's owner-shard mask makes them. On the card the kernels'
        grouping pass sets them aside and never reads their grads, so
        nothing is masked or copied; on the CPU they are masked as the
        reference masks them. Returns ``(table, state, dropped)``:
        ``dropped`` is the raw updates the a2a exchange dropped, summed
        over ranks (a device tensor), or 0."""
        ids = ids.reshape(-1).to(torch.int32)
        row_grads = row_grads.reshape(-1, self.dim)
        dropped = 0
        if self.mesh.group is not None:
            if self.exchange == "gather" or self.k == 1:
                ids = collectives.all_gather(ids, self.mesh)
                row_grads = collectives.all_gather(row_grads, self.mesh)
            else:
                ids, row_grads, dropped = _a2a_route(
                    ids, row_grads, self.mesh, self.rows_per_shard,
                    self.capacity_factor)
                dropped = collectives.all_reduce(dropped, self.mesh)
            local = ids - self.mesh.rank * self.rows_per_shard
            ids = torch.where((local >= 0) & (local < self.rows_per_shard),
                              local, -1)
        if table.device.type == "cuda":
            g = row_grads.to(torch.float32).contiguous()
            table, state = fused_sparse_apply(table, state, ids, g, self._opt,
                                              self.fused_tier)
            return table, state, dropped
        ok = (ids >= 0) & (ids < self.rows_per_shard)
        ids_m = torch.where(ok, ids, -1)
        g = torch.where(ok[:, None], row_grads, 0.0).to(torch.float32)
        table, state = fused_sparse_apply(table, state, ids_m, g, self._opt,
                                          self.fused_tier)
        return table, state, dropped

    def _account_push(self, n_ids: int) -> None:
        """Counters of a push of ``n_ids`` ids over all ranks: each routed
        row is an int32 id and ``dim`` f32 grads (the reference's
        formula)."""
        self.rows_pushed += n_ids
        row_bytes = 4 * (self.dim + 1)
        if self.k <= 1:
            return
        if self.exchange == "gather":
            payload = n_ids * row_bytes
        else:
            cap = int(math.ceil(n_ids / self.k / self.k
                                * self.capacity_factor))
            payload = self.k * cap * row_bytes
        self.collective_bytes += int(payload * (self.k - 1) / self.k)

    # -- eager PS API ----------------------------------------------------------

    @property
    def table(self) -> torch.Tensor:
        if self._table is None:
            raise RuntimeError("SparseEmbedding.init not called")
        return self._table

    def state(self):
        return self._state

    def full_table(self) -> torch.Tensor:
        """The whole ``[num_rows, dim]`` table, every rank's rows gathered
        (introspection and tests; one rank's is its own)."""
        full = collectives.all_gather(self.table, self.mesh)
        return full[:self.num_rows]

    def pull(self, ids) -> torch.Tensor:
        """Gather current rows for this rank's ids (the sparse pull).
        ``ids``: a list, an array or a tensor on any device."""
        ids = torch.as_tensor(ids).to(self.device, torch.int32)
        rows = self.lookup(self.table, ids)
        self.bytes_pulled += rows.numel() * rows.element_size()
        return rows

    def push(self, ids, row_grads) -> None:
        """Send this rank's (ids, row_grads); the owners apply them at
        once. Across ranks the id lists are padded with the -1 filler to
        the longest rank's length (the exchange moves equal parts).
        ``ids`` may lie on the device already; ``row_version`` reads the
        ids of every rank's push on the host."""
        ids = torch.as_tensor(ids).reshape(-1).to(self.device, torch.int32)
        row_grads = torch.as_tensor(row_grads).to(self.device)
        if tuple(row_grads.shape) != (ids.shape[0], self.dim):
            raise ValueError(f"row_grads shape {tuple(row_grads.shape)} != "
                             f"({ids.shape[0]}, {self.dim})")
        self.bytes_pushed += row_grads.numel() * row_grads.element_size()
        if self.mesh.group is not None:
            n = torch.tensor([ids.shape[0]], dtype=torch.int64,
                             device=self.device)
            pad = int(collectives.all_reduce(n, self.mesh, op="max")) - int(
                ids.shape[0])
            if pad:
                ids = torch.cat([ids, ids.new_full((pad,), -1)])
                row_grads = torch.cat(
                    [row_grads, row_grads.new_zeros((pad, self.dim))])
        _, _, dropped = self.apply(self.table, self._state, ids, row_grads)
        self.record_dropped(dropped)
        self.push_count += 1
        all_ids = collectives.all_gather(ids, self.mesh)
        host_ids = all_ids.cpu().numpy()
        touched = host_ids[(host_ids >= 0) & (host_ids < self.num_rows)]
        self.row_version[touched] = self.push_count
        self._account_push(int(ids.shape[0]) * self.k)

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

    def _owned(self, slots) -> Tuple[torch.Tensor, torch.Tensor]:
        """``slots`` (global rows) as this rank's local rows, and which of
        them this rank owns (every one on one rank)."""
        idx = torch.as_tensor(slots).reshape(-1).to(self.device, torch.int64)
        if self.k == 1:
            return idx, torch.ones_like(idx, dtype=torch.bool)
        local = idx - self.mesh.rank * self.rows_per_shard
        return local, (local >= 0) & (local < self.rows_per_shard)

    def _gather_owned(self, t: torch.Tensor, local: torch.Tensor,
                      mine: torch.Tensor) -> torch.Tensor:
        """Rows ``local`` of this rank's ``t``, each from the rank that owns
        it: every rank gathers the rows it owns (zeros for the rest), one
        all-gather brings every rank's, and each row is taken from its
        owner's block, bit for bit."""
        rows = t.index_select(0, torch.where(mine, local, 0))
        if self.k == 1:
            return rows
        rows = torch.where(mine.reshape((-1,) + (1,) * (rows.dim() - 1)),
                           rows, torch.zeros_like(rows))
        n = rows.shape[0]
        every = collectives.all_gather(rows, self.mesh)
        glob = local + self.mesh.rank * self.rows_per_shard
        owner = torch.div(glob, self.rows_per_shard, rounding_mode="floor")
        return every.index_select(0, owner * n + torch.arange(
            n, device=owner.device))

    def export_rows(self, slots) -> Tuple[np.ndarray, list]:
        """Copy ``slots``' rows and their per-row optimizer state out to
        host memory (a row never travels without its state). Returns
        ``(rows [n, D], state_leaves)`` as numpy, the leaves in tree order
        (dict keys sorted: ``[m, t, v]`` for adam), each sliced to
        ``slots``. A bf16 table's rows come out as f32 (numpy holds no
        bf16); the widening is exact. Across ranks ``slots`` are global
        rows and every rank passes the same ones: each rank takes the rows
        it owns, and one all-gather a tensor gives every rank all of them
        (the reference's global ``jnp.take`` on a sharded array)."""
        local, mine = self._owned(slots)
        rows = self._gather_owned(self.table, local, mine)
        if rows.dtype == torch.bfloat16:
            rows = rows.float()
        leaves = [self._gather_owned(leaf, local, mine).cpu().numpy()
                  for leaf in _leaves(self._state)]
        return rows.cpu().numpy(), leaves

    def adopt_rows(self, slots, rows, state_leaves) -> None:
        """Write host rows and their per-row optimizer state into
        ``slots``, in place: the inverse of :meth:`export_rows`. Costs
        O(moved rows), not a table pass. Across ranks every rank passes the
        same global slots and rows, and writes the ones it owns."""
        local, mine = self._owned(slots)
        live = _leaves(self._state)
        if len(state_leaves) != len(live):
            raise ValueError(f"{len(state_leaves)} optimizer-state "
                             f"leaves, this table's optimizer has {len(live)}")
        keep = None if self.k == 1 else torch.nonzero(mine).reshape(-1)

        def write(dst, src):
            src = torch.as_tensor(src).to(self.device, dst.dtype)
            if keep is None:
                dst.index_copy_(0, local, src)
            else:
                dst.index_copy_(0, local[keep], src.index_select(0, keep))

        write(self.table, rows)
        for leaf, v in zip(live, state_leaves):
            write(leaf, v)

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
        """Checkpoint the table and its per-row optimizer state; across
        ranks each rank writes the rows it owns."""
        opt = ckpt.flatten_leaves(self._state)
        arrays = {
            "table": ckpt.to_cpu(self.table),
            "opt": {i: ckpt.to_cpu(t) for i, t in opt.items()},
        }
        meta = {
            "padded_rows": self.padded_rows,
            "shard_dims": ({"table": 0, **{f"opt/{i}": 0 for i in opt}}
                           if self.k > 1 else {}),
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
        ckpt.save(path, arrays, meta, mesh=self.mesh)

    def restore(self, path: str, elastic: bool = False) -> torch.Tensor:
        """Restore a checkpoint written by :meth:`save`. Call after
        ``init`` (same num_rows, dim, dtype and optimizer). Every check
        runs first, the kernel's included, so a refused restore changes
        nothing. A checkpoint written by another number of ranks is
        refused unless ``elastic=True``: then the saved rows are joined,
        cut to ``num_rows``, padded for this rank count and this rank's
        taken, with their state. Returns this rank's restored rows."""
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
        saved_world = int(meta.get("world_size", 1))
        if saved_world != self.k and not elastic:
            raise ValueError(
                f"checkpoint was written by {saved_world} rank(s) and this "
                f"job runs {self.k}; restore(elastic=True) re-shards its "
                f"rows")
        arrays = ckpt.restore(path, meta)

        def mine(t):  # whole saved rows -> this rank's, re-padded
            return ckpt.place(self._own(self._pad(t[:self.num_rows])),
                              self.device)

        table = mine(arrays["table"])
        state = ckpt.unflatten_like(
            self._state, {i: mine(t)
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
        self._dropped = int(meta["dropped_rows"])
        return self._table


def _dedupe_rows(ids: torch.Tensor, grads: torch.Tensor):
    """One rank's pre-exchange dedupe (the reference's ``_dedupe_rows``):
    each id's grads summed in f32, in arrival order, into its first
    position in sorted order; the other duplicates become filler (-1, a
    zero grad). Returns ``(ids_u, grads_u, counts_u)``: ``counts_u`` is
    the number of raw pushed rows each unique row carries (0 on filler),
    so overflow reports lost updates in the units of ``rows_pushed``."""
    n = ids.shape[0]
    if n == 0:
        return ids, grads, torch.zeros((0,), dtype=torch.int32,
                                       device=ids.device)
    order = torch.argsort(ids, stable=True)
    ids_s, grads_s = ids[order], grads[order]
    uniq, counts = torch.unique_consecutive(ids_s, return_counts=True)
    sums = torch.segment_reduce(grads_s.float(), "sum", lengths=counts)
    first = torch.cumsum(counts, 0) - counts  # each id's first sorted slot
    ids_u = torch.full_like(ids_s, -1)
    ids_u[first] = uniq
    grads_u = torch.zeros_like(grads_s)
    grads_u[first] = sums.to(grads.dtype)
    counts_u = torch.zeros((n,), dtype=torch.int32, device=ids.device)
    counts_u[first] = counts.to(torch.int32)
    return ids_u, grads_u, counts_u


def _a2a_route(ids: torch.Tensor, grads: torch.Tensor, mesh,
               rows_per_shard: int, capacity_factor: float):
    """Route this rank's (ids, grads) into capacity-bounded per-owner
    buckets and exchange them with ``all_to_all`` (the reference's
    ``_a2a_route``). Duplicates merge first (:func:`_dedupe_rows`); rows
    that overflow their bucket are dropped (their slots stay id -1, grad
    0). Returns the ids and grads this rank received, ``[k·C]`` and
    ``[k·C, D]``, and the raw updates this rank dropped, a ``[1]`` int32
    tensor."""
    k = mesh.size
    ids, grads, counts = _dedupe_rows(ids, grads)
    n = ids.shape[0]
    cap = int(math.ceil(n / k * capacity_factor))
    # filler (-1: push padding and merged duplicates) goes to overflow
    # destination k, whose slots are cut off, so it never takes a bucket
    dest = torch.where(ids < 0, k, torch.clamp(ids // rows_per_shard, 0,
                                               k - 1)).to(torch.int64)
    order = torch.argsort(dest, stable=True)
    ids_s, grads_s, dest_s = ids[order], grads[order], dest[order]
    counts_s = counts[order]
    pos = (torch.arange(n, device=ids.device)
           - torch.searchsorted(dest_s, dest_s, side="left"))
    keep = pos < cap
    dropped = torch.where((~keep) & (dest_s < k), counts_s, 0).sum(
        dtype=torch.int32).reshape(1)
    # a kept row's slot in the [k, cap] buckets; the rest write one spare
    # slot past the end, cut off below
    slot = torch.where(keep & (dest_s < k), dest_s * cap + pos, k * cap)
    bucket_ids = ids.new_full((k * cap + 1,), -1)
    bucket_grads = grads.new_zeros((k * cap + 1,) + tuple(grads.shape[1:]))
    bucket_ids[slot] = ids_s
    bucket_grads[slot] = grads_s
    bucket_ids, bucket_grads = bucket_ids[:-1], bucket_grads[:-1]
    # rank d receives every rank's bucket for destination d
    return (collectives.all_to_all(bucket_ids, mesh),
            collectives.all_to_all(bucket_grads, mesh), dropped)
