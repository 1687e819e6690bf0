"""Tiered embedding storage: a device hot set over a host-DRAM arena.

Counterpart of ``ps_tpu/kv/tiered.py``, with its names and contracts.
Production embedding tables are far larger than device memory while the
touches are Zipf-skewed, so a small hot set takes almost every push: the
hot rows and their per-row optimizer state live on the device, the rest
in a host arena, and rows move between the tiers by observed frequency.

- **device tier**: a :class:`~ps_tpu_torch.kv.sparse.SparseEmbedding` of
  ``device_rows`` SLOTS on the table's device (the card unless the caller
  asked for the CPU). A push's hot ids are slot-mapped and go through its
  push unchanged, so on the card through the grouping and apply kernels
  (``ops/csrc/sparse_group.cu``, ``sparse_apply.cu``). The hot half keeps
  the push's full batch shape, the cold positions set to the -1 filler:
  the grouping pass groups each hot row's duplicates in arrival order as
  an untiered push does, so a stream confined to the hot set leaves the
  device tier bitwise an untiered table's.
- **host tier**: an arena ``[num_rows, D]`` and same-length per-row
  optimizer-state leaves, CPU tensors (pinned when the hot tier is on the
  card), in the table's dtype, bf16 included. Cold ids are deduped on the
  host (:func:`~ps_tpu_torch.ops.sparse_apply.segment_sum_np`, duplicates
  summed in arrival order), gathered into a batch-sized pinned slab that
  reaches the device in one copy, applied there by the optimizer's one
  dense-rows rule (``RowwiseOptimizer.apply_rows``, torch ops: the
  reference jits the same function, which reaches no Pallas kernel), and
  scattered back.
- **row directory** (numpy): id -> tier, slot, touch count, CLOCK ref
  bit and last touch in ms; ``slot_to_id``, the CLOCK ``hand`` and
  ``dir_gen``. It alone says where a row lives.
- **admission and eviction**: a cold row whose touch count reaches
  ``admit_freq`` promotes; slots free by a CLOCK second-chance sweep, and
  idle hot rows demote after ``evict_ttl_ms`` (0: off). A demotion carries
  the row and its state back to the arena (``export_rows``), a promotion
  up (``adopt_rows``): churn never loses a row.
- **replica determinism**: only the primary plans moves (the one reader of
  the wall clock) and records them (:meth:`TieredTable.pop_moves`); the
  service ships the log on the replication stream and a backup replays it
  with ``push(..., moves=...)``, so the directories stay bitwise equal.
- **checkpoint**: :meth:`TieredTable.save` writes both tiers and every
  directory array as one ``ckpt.save`` commit (engine ``tiered``), under
  the service's lock during the coordinated pause.
- **prefetch**: :meth:`TieredTable.prefetch` gathers the cold slab of an
  upcoming push on a background thread; a staged slab is generation-
  tagged and dropped, never served, if an apply or a demotion lands first.

Across k ranks the hot tier is row-sharded as any ``SparseEmbedding`` of
the context's mesh, while the directory and the arena are replicated:
every rank all-gathers the push's ids before the touch accounting, so
the directory sees the global batch as one process would; rank 0 alone
plans and broadcasts its move log, which every rank applies; the cold
ids and grads are gathered, so each rank's arena applies the same global
cold update once; the hot ids go through the hot tier's exchange.

Hits, misses, promotions and evictions are local ints (what the
service's STATS reads) and the registry's ``ps_embed_hot_hits_total``,
``ps_embed_misses_total``, ``ps_embed_promotions_total`` and
``ps_embed_evictions_total`` (one family shared by every table).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch import obs
from ps_tpu_torch.config import env_flag, env_int
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.ops.sparse_apply import segment_sum_np, state_leaves
from ps_tpu_torch.parallel import collectives

#: one CLOCK sweep visits each slot at most twice (a clearing pass and an
#: evicting one) before it force-evicts, so the hand never spins forever
_CLOCK_MAX_SWEEPS = 2

#: a move-log op's kind as the int the rank-0 broadcast carries
_KIND_CODES = {"r": 0, "d": 1, "p": 2}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}

#: the directory arrays a checkpoint holds, by name, with their dtypes
_DIRECTORY = (("dir_tier", "tier", np.uint8), ("dir_slot", "slot", np.int32),
              ("dir_freq", "freq", np.int64), ("dir_ref", "ref", np.uint8),
              ("dir_last_ms", "last_ms", np.int64),
              ("slot_to_id", "slot_to_id", np.int32))


def tiered_embedding(num_rows: int, dim: int, optimizer="adagrad",
                     device_rows: Optional[int] = None,
                     admit_freq: Optional[int] = None,
                     evict_ttl_ms: Optional[int] = None,
                     prefetch: Optional[bool] = None, **kwargs):
    """The right table for ``num_rows`` under the device budget: a plain
    :class:`SparseEmbedding` when the budget is 0 (unlimited) or the table
    fits, else a :class:`TieredTable`. ``None`` knobs come from
    ``PS_EMBED_DEVICE_ROWS`` / ``PS_EMBED_ADMIT_FREQ`` /
    ``PS_EMBED_EVICT_TTL_MS`` / ``PS_EMBED_PREFETCH``."""
    if device_rows is None:
        device_rows = env_int("PS_EMBED_DEVICE_ROWS", 0, lo=0)
    if device_rows <= 0 or device_rows >= num_rows:
        return SparseEmbedding(num_rows, dim, optimizer, **kwargs)
    if admit_freq is None:
        admit_freq = env_int("PS_EMBED_ADMIT_FREQ", 2, lo=1)
    if evict_ttl_ms is None:
        evict_ttl_ms = env_int("PS_EMBED_EVICT_TTL_MS", 0, lo=0)
    if prefetch is None:
        prefetch = env_flag("PS_EMBED_PREFETCH", False)
    return TieredTable(num_rows, dim, optimizer, device_rows=device_rows,
                       admit_freq=admit_freq, evict_ttl_ms=evict_ttl_ms,
                       prefetch=prefetch, **kwargs)


def _host_ids(ids) -> np.ndarray:
    """Any id container as a flat int32 numpy array on the host."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int32).reshape(-1)


def _index(ids: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(ids, np.int64))


class TieredTable:
    """A device-budgeted embedding table: hot slots on the device, the
    rest in a host arena, split a push and a read by the row directory.

    Where the serving layer touches it, it is a :class:`SparseEmbedding`
    (``init``/``push``/``pull``/``save``/``restore``, ``table``, the
    counters, ``row_version`` over logical ids), plus the tier surface:
    ``push(..., moves=...)`` for a backup's replay, :meth:`pop_moves`,
    :meth:`prefetch`, :meth:`tier_stats`, :meth:`drain_cold_gather`.

    Args:
      num_rows: logical vocabulary (the arena's rows).
      dim: embedding dimension.
      optimizer: as ``SparseEmbedding``; one rule governs both tiers.
      device_rows: the hot-slot budget, in (0, num_rows)
        (:func:`tiered_embedding` handles the other budgets).
      admit_freq: the touch count at which a cold row promotes.
      evict_ttl_ms: demote hot rows idle this long (0: off; CLOCK still
        evicts under slot pressure).
      prefetch: stage cold gathers on a background thread.
      dtype, fused_apply: the hot tier's (its exchange across ranks is
        the lossless 'gather').
    """

    def __init__(self, num_rows: int, dim: int, optimizer="adagrad",
                 device_rows: int = 0, admit_freq: int = 2,
                 evict_ttl_ms: int = 0, prefetch: bool = False,
                 dtype=torch.float32, fused_apply: Optional[str] = None,
                 **opt_kwargs):
        if not 0 < device_rows < num_rows:
            raise ValueError(
                f"device_rows {device_rows} outside (0, {num_rows}): use "
                f"tiered_embedding(), which returns a plain SparseEmbedding "
                f"for the other budgets")
        if admit_freq < 1:
            raise ValueError("admit_freq must be >= 1")
        if evict_ttl_ms < 0:
            raise ValueError("evict_ttl_ms must be >= 0 (0 = TTL off)")
        # the hot tier is a SparseEmbedding over slots: the bitwise hot
        # path rests on changing nothing in it
        self.hot = SparseEmbedding(device_rows, dim, optimizer, dtype=dtype,
                                   fused_apply=fused_apply, **opt_kwargs)
        self.device = self.hot.device
        self.mesh = self.hot.mesh
        self.k = self.hot.k
        self.num_rows = num_rows
        self.device_rows = device_rows
        self.dim = dim
        self.dtype = dtype
        self.admit_freq = admit_freq
        self.evict_ttl_ms = evict_ttl_ms
        self.prefetch_enabled = bool(prefetch)
        self._opt = self.hot._opt
        self.fused_tier = self.hot.fused_tier
        self._pinned = self.device.type == "cuda"

        # the row directory
        self.tier = np.zeros((num_rows,), np.uint8)  # 0 cold, 1 hot
        self.slot = np.full((num_rows,), -1, np.int32)
        self.freq = np.zeros((num_rows,), np.int64)
        self.ref = np.zeros((num_rows,), np.uint8)  # the CLOCK bit
        self.last_ms = np.zeros((num_rows,), np.int64)
        self.slot_to_id = np.full((device_rows,), -1, np.int32)
        self.hand = 0
        #: bumped by every tier move (STATS; prefetch staleness)
        self.dir_gen = 0

        # the host tier: row i's arena row and state are the authority
        # only while tier[i] == 0
        self.arena: Optional[torch.Tensor] = None
        self.cold_state: list = []
        self._state_like = None  # the optimizer's state structure
        #: bumped by every cold scatter and restore: validates staged slabs
        self._cold_gen = 0
        self._stage_lock = threading.Lock()
        self._staged: Optional[tuple] = None
        self._prefetch_pool = None

        # local counters, which STATS reads, and the registry's families
        # (same-name instruments of several tables merge at render)
        self.hot_hits = 0
        self.misses = 0
        self.promotions = 0
        self.evictions = 0
        self.prefetch_hits = 0
        reg = obs.default_registry()
        self._c_hits = reg.counter(
            "ps_embed_hot_hits_total",
            "tiered embedding ids served from the device hot set")
        self._c_miss = reg.counter(
            "ps_embed_misses_total",
            "tiered embedding ids that went to the host cold arena")
        self._c_promo = reg.counter(
            "ps_embed_promotions_total",
            "tiered embedding rows promoted cold -> hot (state moved)")
        self._c_evict = reg.counter(
            "ps_embed_evictions_total",
            "tiered embedding rows demoted hot -> cold (state moved)")
        self._cold_gather_s: list = []
        self.last_moves: dict = {"ops": [], "hand": 0}

        # SparseEmbedding's accounting (the service seeds its versions and
        # rows from these)
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.collective_bytes = 0
        self.push_count = 0
        self.rows_pushed = 0
        self.dropped_rows = 0
        # per-row change stamps over LOGICAL ids, in push_count units, for
        # the conditional read path: a tier move is a change (the bytes'
        # home moved), so moved rows are stamped with the push's own. Not
        # checkpointed: a restore stamps every row at push_count
        self.row_version = np.zeros((num_rows,), np.int64)

    # -- placement -----------------------------------------------------------

    def _host(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pinned)

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pinned)
        return out.copy_(t)

    def init(self, rng_or_table, scale: float = 0.01) -> torch.Tensor:
        """Create (or adopt) the whole logical table: ids
        ``0..device_rows-1`` hot in slot order, every row in the arena
        too (a hot row's arena copy is stale until it demotes).
        ``rng_or_table`` is a ``[num_rows, dim]`` array or tensor, or a
        ``torch.Generator`` for ``scale * N(0, 1)`` rows drawn as
        ``SparseEmbedding.init`` draws them. Returns the hot tier's
        placed rows."""
        if self.arena is not None:
            raise RuntimeError("TieredTable.init already called")
        if isinstance(rng_or_table, torch.Generator):
            full = torch.randn((self.num_rows, self.dim),
                               generator=rng_or_table,
                               device=rng_or_table.device,
                               dtype=torch.float32).mul_(scale)
        else:
            full = torch.as_tensor(rng_or_table)
            if tuple(full.shape) != (self.num_rows, self.dim):
                raise ValueError(f"table shape {tuple(full.shape)} != "
                                 f"({self.num_rows}, {self.dim})")
        self.arena = self._host_copy(full.to("cpu", self.dtype))
        # one zero leaf a leaf of the rule's state (fresh state is what an
        # untiered init holds)
        self._state_like = self._opt.init(
            torch.zeros((1, self.dim), dtype=self.dtype))
        self.cold_state = [
            self._host((self.num_rows,) + tuple(leaf.shape[1:]), leaf.dtype)
            for leaf in state_leaves(self._state_like)]
        hot_ids = np.arange(self.device_rows, dtype=np.int32)
        self.tier[hot_ids] = 1
        self.slot[hot_ids] = hot_ids
        self.slot_to_id[:] = hot_ids
        return self.hot.init(full[:self.device_rows])

    @property
    def table(self) -> torch.Tensor:
        """The hot tier's device table."""
        return self.hot.table

    def state(self):
        return self.hot.state()

    # -- push: split by the directory, one rule on both tiers ----------------

    def push(self, ids, row_grads, moves: Optional[dict] = None) -> None:
        """Apply one push across both tiers.

        ``moves=None`` (a primary) plans this push's admissions and
        evictions and records them for :meth:`pop_moves`; a dict (a
        backup) replays exactly those moves, so the wall clock is read
        once. ``ids`` may be any container; ``row_grads`` [N, D] numpy or
        a tensor on any device. Across ranks each rank passes its own part
        of the push."""
        if self.arena is None:
            raise RuntimeError("TieredTable.init not called")
        ids = _host_ids(ids)
        grads = torch.as_tensor(row_grads)
        if tuple(grads.shape) != (ids.shape[0], self.dim):
            raise ValueError(f"row_grads shape {tuple(grads.shape)} != "
                             f"({ids.shape[0]}, {self.dim})")
        self.bytes_pushed += grads.numel() * grads.element_size()
        now_ms = int(time.time() * 1000)
        if self.k > 1:
            ids, grads, all_ids = self._global_batch(ids, grads)
        else:
            all_ids = ids
        uids, ucnt = np.unique(all_ids, return_counts=True)
        real = uids >= 0
        uids, ucnt = uids[real], ucnt[real]
        # touch accounting, the same on primary and backup: the count
        # advances by duplicates, a hot touch sets its CLOCK bit
        self.freq[uids] += ucnt
        self.ref[uids[self.tier[uids] == 1]] = 1
        if moves is None:
            if self.k == 1 or self.mesh.rank == 0:
                moves = self._plan_moves(uids, now_ms)
            if self.k > 1:
                moves = self._broadcast_moves(moves)
        self._apply_moves(moves)
        self.last_moves = moves
        self.last_ms[uids] = now_ms

        # split by the post-move directory; the decisions are the global
        # batch's, so every rank takes the same branches
        gvalid = all_ids >= 0
        ghot = gvalid & (self.tier[np.clip(all_ids, 0, None)] == 1)
        gcold = gvalid & ~ghot
        n_hot, n_cold = int(ghot.sum()), int(gcold.sum())
        if n_hot:
            # the raw stream, slot-mapped, at the full batch shape
            hot_mask = (ids >= 0) & (self.tier[np.clip(ids, 0, None)] == 1)
            self.hot.push(np.where(hot_mask,
                                   self.slot[np.clip(ids, 0, None)],
                                   np.int32(-1)), grads)
        if n_cold:
            if self.k > 1:
                grads = collectives.all_gather(
                    grads.to(self.device, torch.float32), self.mesh)
            host = grads.detach().to("cpu", torch.float32).numpy()
            self._push_cold(all_ids[gcold], host[gcold])
        self.hot_hits += n_hot
        self.misses += n_cold
        self._c_hits.inc(int(n_hot))
        self._c_miss.inc(int(n_cold))
        self.push_count += 1
        # change stamps: the push's rows and every moved row ("d"/"p";
        # a ref clear changes no bytes)
        self.row_version[uids] = self.push_count
        moved = [op[1] for op in (moves.get("ops") or []) if op[0] != "r"]
        if moved:
            self.row_version[np.asarray(moved, np.int64)] = self.push_count
        self.rows_pushed += int(gvalid.sum())

    def _global_batch(self, ids: np.ndarray, grads: torch.Tensor):
        """This rank's push padded with the -1 filler to the longest
        rank's, and the global batch's ids (every rank's, in rank order)
        on the host."""
        n = torch.tensor([ids.shape[0]], dtype=torch.int64,
                         device=self.device)
        pad = int(collectives.all_reduce(n, self.mesh, op="max")) - int(
            ids.shape[0])
        if pad:
            ids = np.concatenate([ids, np.full((pad,), -1, np.int32)])
            grads = torch.cat([grads, grads.new_zeros((pad, self.dim))])
        every = collectives.all_gather(
            torch.from_numpy(ids).to(self.device), self.mesh)
        return ids, grads, every.cpu().numpy()

    def _push_cold(self, ids: np.ndarray, grads: np.ndarray) -> None:
        """Dedupe, gather (or take the staged slab), ``apply_rows`` on the
        device, scatter back: batch-sized end to end. The reference pads
        slabs to a power of two only so that XLA compiles one executable
        a size; the math is the same without it."""
        t0 = time.perf_counter()
        uids, gsum, cnt = segment_sum_np(ids, grads)
        staged = self._take_staged(uids)
        idx = _index(uids)
        if staged is not None:
            rows, leaves = staged
            self.prefetch_hits += 1
        else:
            rows, leaves = self._gather(idx)
        dev = self.device
        state = ckpt.unflatten_like(self._state_like, {
            f"{i:05d}": leaf.to(dev, non_blocking=True)
            for i, leaf in enumerate(leaves)})
        new_rows, new_state = self._opt.apply_rows(
            rows.to(dev, non_blocking=True), state,
            torch.from_numpy(gsum).to(dev, non_blocking=True),
            torch.from_numpy(cnt).to(dev, non_blocking=True))
        self.arena.index_copy_(0, idx, new_rows.to("cpu", self.dtype))
        for dst, leaf in zip(self.cold_state, state_leaves(new_state)):
            dst.index_copy_(0, idx, leaf.to("cpu", dst.dtype))
        self._cold_gen += 1
        self._cold_gather_s.append(time.perf_counter() - t0)

    def _gather(self, idx: torch.Tensor):
        """Arena rows and state of ``idx`` into fresh (pinned) slabs."""
        rows = self._host((idx.numel(), self.dim), self.dtype)
        torch.index_select(self.arena, 0, idx, out=rows)
        leaves = []
        for s in self.cold_state:
            out = self._host((idx.numel(),) + tuple(s.shape[1:]), s.dtype)
            leaves.append(torch.index_select(s, 0, idx, out=out))
        return rows, leaves

    # -- admission and eviction ---------------------------------------------

    def _plan_moves(self, uids: np.ndarray, now_ms: int) -> dict:
        """This push's tier moves (the primary's rank 0 only: the one
        reader of the wall clock), as the replayable log ``{"ops": [[kind,
        id, slot], ...], "hand": int}``, kind ``"r"`` (CLOCK ref clear),
        ``"d"`` (demote) or ``"p"`` (promote), applied in order."""
        ops: list = []
        free: list = []
        touched = set(uids.tolist())
        if self.evict_ttl_ms:
            # TTL: demote hot rows idle past the horizon (never one this
            # push touches)
            resident = self.slot_to_id[self.slot_to_id >= 0]
            idle = resident[(now_ms - self.last_ms[resident])
                            >= self.evict_ttl_ms]
            for i in idle.tolist():
                if i in touched:
                    continue
                ops.append(["d", int(i), int(self.slot[i])])
                free.append(int(self.slot[i]))
        cand = uids[(self.tier[uids] == 0)
                    & (self.freq[uids] >= self.admit_freq)]
        hand = self.hand
        promoted: set = set()
        demoted = {op[1] for op in ops}
        for i in cand.tolist():
            if free:
                s = free.pop()
            else:
                s, hand, clock_ops = self._clock_scan(hand, promoted, demoted)
                if s is None:
                    break  # every slot pinned by this push: admit later
                ops.extend(clock_ops)
                ops.append(["d", int(self.slot_to_id[s]), int(s)])
                demoted.add(int(self.slot_to_id[s]))
            ops.append(["p", int(i), int(s)])
            promoted.add(int(i))
        return {"ops": ops, "hand": int(hand)}

    def _clock_scan(self, hand: int, promoted: set, demoted: set):
        """Second-chance sweep from ``hand``: clear ref bits (recorded as
        ``"r"`` ops, so a backup's bits track these) until an unreferenced
        victim slot turns up, skipping rows this plan already moved; after
        the bounded sweeps the current candidate is force-evicted."""
        n = self.device_rows
        clock_ops: list = []
        for step in range(_CLOCK_MAX_SWEEPS * n):
            s = hand
            hand = (hand + 1) % n
            rid = int(self.slot_to_id[s])
            if rid < 0 or rid in promoted or rid in demoted:
                continue
            if self.ref[rid] and step < n:
                clock_ops.append(["r", rid, s])
                self.ref[rid] = 0  # cleared at plan time; replayed by ops
                continue
            return s, hand, clock_ops
        return None, hand, clock_ops

    def _broadcast_moves(self, moves: Optional[dict]) -> dict:
        """Rank 0's move log on every rank of the axis (host tensors over
        gloo, device ones over NCCL)."""
        dev = "cpu" if self.mesh.backend == "gloo" else self.device
        head = torch.zeros((2,), dtype=torch.int64, device=dev)
        if self.mesh.rank == 0:
            head[0], head[1] = len(moves["ops"]), int(moves["hand"])
        collectives.broadcast(head, self.mesh, 0, "data")
        n, hand = (int(x) for x in head.cpu())
        body = torch.zeros((n, 3), dtype=torch.int64, device=dev)
        if self.mesh.rank == 0 and n:
            body.copy_(torch.tensor([[_KIND_CODES[k], r, s]
                                     for k, r, s in moves["ops"]],
                                    dtype=torch.int64))
        if n:
            collectives.broadcast(body, self.mesh, 0, "data")
        return {"ops": [[_KIND_NAMES[k], r, s]
                        for k, r, s in body.cpu().tolist()], "hand": hand}

    def _apply_moves(self, moves: dict) -> None:
        """Replay one move log against the directory and both tiers: ref
        clears, then the demotions as one batch (device -> arena, state
        included), then the promotions (arena -> device). The plan orders
        its ops so that a promotion's slot is free when it lands."""
        ops = moves.get("ops") or []
        if not ops:
            return
        for kind, rid, _s in ops:
            if kind == "r":
                self.ref[rid] = 0
        dem = [(rid, s) for kind, rid, s in ops if kind == "d"]
        if dem:
            d_ids = np.asarray([r for r, _ in dem], np.int32)
            d_slots = np.asarray([s for _, s in dem], np.int32)
            rows, leaves = self.hot.export_rows(d_slots)
            idx = _index(d_ids)
            self.arena.index_copy_(0, idx,
                                   torch.from_numpy(rows).to(self.dtype))
            for dst, leaf in zip(self.cold_state, leaves):
                dst.index_copy_(0, idx, torch.from_numpy(leaf).to(dst.dtype))
            self.tier[d_ids] = 0
            self.slot[d_ids] = -1
            self.slot_to_id[d_slots] = -1
            self.ref[d_ids] = 0
            self.evictions += len(dem)
            self._c_evict.inc(len(dem))
        pro = [(rid, s) for kind, rid, s in ops if kind == "p"]
        if pro:
            p_ids = np.asarray([r for r, _ in pro], np.int32)
            p_slots = np.asarray([s for _, s in pro], np.int32)
            rows, leaves = self._gather(_index(p_ids))
            self.hot.adopt_rows(p_slots, rows, leaves)
            self.tier[p_ids] = 1
            self.slot[p_ids] = p_slots
            self.slot_to_id[p_slots] = p_ids
            self.ref[p_ids] = 1
            self.promotions += len(pro)
            self._c_promo.inc(len(pro))
        if moves.get("hand") is not None:
            self.hand = int(moves["hand"])
        self.dir_gen += 1
        # a demotion writes arena rows, so a slab staged with one of them
        # is stale; promotions only read the arena (_take_staged subsets
        # the now-hot ids away)
        if dem:
            with self._stage_lock:
                if self._staged is not None and np.intersect1d(
                        self._staged[1], d_ids).size:
                    self._staged = None

    def pop_moves(self) -> dict:
        """This push's move log, then cleared: what the service ships to a
        backup so that placement replicates."""
        mv, self.last_moves = self.last_moves, {"ops": [], "hand": None}
        return mv

    # -- read: split gather, the directory untouched -------------------------

    def pull(self, ids) -> torch.Tensor:
        """Current rows of ``ids`` (valid ids) across both tiers, in id
        order, as a CPU tensor: the cold rows never visit the device. The
        directory and the tables do not change (reads stay cacheable);
        only counters move. Across ranks every rank passes as many ids."""
        if self.arena is None:
            raise RuntimeError("TieredTable.init not called")
        ids = _host_ids(ids)
        out = torch.empty((ids.shape[0], self.dim), dtype=self.dtype)
        hot_mask = self.tier[ids] == 1
        n_hot = int(np.count_nonzero(hot_mask))
        if self.k > 1:  # the hot tier's lookup is collective: every rank
            rows = self.hot.pull(np.where(hot_mask, self.slot[ids], 0)).cpu()
            out[torch.from_numpy(hot_mask)] = rows[torch.from_numpy(hot_mask)]
        elif n_hot:
            out[torch.from_numpy(hot_mask)] = self.hot.pull(
                self.slot[ids[hot_mask]]).cpu()
        if n_hot < ids.shape[0]:
            out[torch.from_numpy(~hot_mask)] = self.arena.index_select(
                0, _index(ids[~hot_mask]))
        self.hot_hits += n_hot
        self.misses += ids.shape[0] - n_hot
        self._c_hits.inc(int(n_hot))
        self._c_miss.inc(int(ids.shape[0] - n_hot))
        self.bytes_pulled += out.numel() * out.element_size()
        return out

    # -- prefetch: the arena gather beside the previous apply ----------------

    def prefetch(self, ids) -> None:
        """Stage the cold slab of an upcoming push of ``ids`` on a
        background thread. A slab is tagged with the cold generation: an
        apply or demotion landing first discards it. No-op unless
        ``prefetch`` is on."""
        if not self.prefetch_enabled or self.arena is None:
            return
        ids = _host_ids(ids)
        cold = ids[(ids >= 0) & (self.tier[np.clip(ids, 0, None)] == 0)]
        if cold.size == 0:
            return
        uids = np.unique(cold)
        if self._prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ps-embed-prefetch")
        self._prefetch_pool.submit(self._stage, uids)

    def _stage(self, uids: np.ndarray) -> None:
        gen = self._cold_gen
        rows, leaves = self._gather(_index(uids))
        if gen != self._cold_gen:
            return  # an apply raced the gather: the slab may be torn
        with self._stage_lock:
            self._staged = (gen, uids, rows, leaves)

    def _take_staged(self, uids: np.ndarray):
        with self._stage_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return None
        gen, s_uids, rows, leaves = staged
        if gen != self._cold_gen:
            return None
        if np.array_equal(s_uids, uids):
            return rows, leaves
        # ids promoted between the staging and the push left the cold
        # set: serve the rest (both are sorted and unique)
        pos = np.searchsorted(s_uids, uids)
        if np.any(pos >= s_uids.size) or not np.array_equal(
                s_uids[np.minimum(pos, s_uids.size - 1)], uids):
            return None
        pos = _index(pos)
        return rows[pos], [v[pos] for v in leaves]

    # -- observability -------------------------------------------------------

    def tier_stats(self) -> dict:
        """The STATS ``tier`` entry of this table."""
        total = self.hot_hits + self.misses
        return {
            "device_rows": self.device_rows,  # pslint: disable=PSL203 -- a STATS tier field for operators and the tests; no service reads it back
            "total_rows": self.num_rows,  # pslint: disable=PSL203 -- a STATS tier field for operators and the tests; no service reads it back
            "hot_rows": int(np.count_nonzero(self.slot_to_id >= 0)),  # pslint: disable=PSL203 -- a STATS tier field for operators and the tests; no service reads it back
            "hot_hits": self.hot_hits,
            "misses": self.misses,
            "hit_rate": round(self.hot_hits / total, 4) if total else None,
            "promotions": self.promotions,
            "evictions": self.evictions,
            "prefetch_hits": self.prefetch_hits,  # pslint: disable=PSL203 -- a STATS tier field for operators and the tests; no service reads it back
            "dir_gen": self.dir_gen,  # pslint: disable=PSL203 -- a STATS tier field for operators and the tests; no service reads it back
        }

    def drain_cold_gather(self) -> list:
        """The cold passes' latencies (seconds) since the last drain, then
        cleared: the service feeds them to ``cold_gather_s``."""
        out, self._cold_gather_s = self._cold_gather_s, []
        return out

    # -- checkpoint: both tiers, one commit -----------------------------------

    def _dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    def save(self, path: str) -> None:
        """Checkpoint both tiers and the directory as one atomic commit
        (``ckpt.save``): the hot table and its state, the arena and its
        state, every directory array. A promotion is on both sides of the
        snapshot or on neither. Across ranks each rank writes its hot
        rows; the replicated host tier and directory are rank 0's."""
        hot_opt = ckpt.flatten_leaves(self.hot.state())
        arrays = {"hot_table": ckpt.to_cpu(self.hot.table),
                  "hot_opt": {i: ckpt.to_cpu(t) for i, t in hot_opt.items()}}
        if self.mesh.rank == 0:
            arrays["arena"] = self.arena
            arrays["cold_opt"] = {f"{i:05d}": leaf
                                  for i, leaf in enumerate(self.cold_state)}
            for key, attr, _dt in _DIRECTORY:
                arrays[key] = torch.from_numpy(getattr(self, attr))
        meta = {
            "engine": "tiered",
            "num_rows": self.num_rows,
            "dim": self.dim,
            "dtype": self._dtype_name(),
            "device_rows": self.device_rows,
            "padded_rows": self.hot.padded_rows,
            "shard_dims": ({"hot_table": 0,
                            **{f"hot_opt/{i}": 0 for i in hot_opt}}
                           if self.k > 1 else {}),
            "opt_structure": ckpt.opt_fingerprint(self._opt.kind,
                                                  self.hot.state()),
            "hand": self.hand,
            "dir_gen": self.dir_gen,
            "push_count": self.push_count,
            "rows_pushed": self.rows_pushed,
            "bytes_pushed": self.bytes_pushed,
            "bytes_pulled": self.bytes_pulled,
            "collective_bytes": self.collective_bytes,
            "hot_hits": self.hot_hits,
            "misses": self.misses,
            "promotions": self.promotions,
            "evictions": self.evictions,
        }
        ckpt.save(path, arrays, meta, mesh=self.mesh)

    def restore(self, path: str) -> torch.Tensor:
        """Restore a :meth:`save` snapshot, after ``init`` with the same
        geometry, dtype, optimizer and rank count: the exact directory and
        both tiers. Every check runs first, so a refused restore changes
        nothing. Returns the restored hot rows."""
        if self.arena is None:
            raise RuntimeError("TieredTable.init must precede restore")
        meta = ckpt.read_meta(path)
        if meta.get("engine") != "tiered":
            raise ValueError(
                f"checkpoint was written by engine {meta.get('engine')!r}, "
                f"not a tiered table")
        if (meta["num_rows"], meta["dim"], meta["device_rows"]) != \
                (self.num_rows, self.dim, self.device_rows):
            raise ValueError(
                f"checkpoint geometry ({meta['num_rows']}, {meta['dim']}, "
                f"budget {meta['device_rows']}) != this table "
                f"({self.num_rows}, {self.dim}, {self.device_rows})")
        if meta["dtype"] != self._dtype_name():
            raise ValueError(f"checkpoint dtype {meta['dtype']} != "
                             f"{self._dtype_name()}: restore would cast")
        live = ckpt.opt_fingerprint(self._opt.kind, self.hot.state())
        if meta.get("opt_structure", live) != live:
            raise ValueError(
                f"checkpoint optimizer state does not match this table's "
                f"optimizer (saved {meta['opt_structure']!r}, live {live!r})")
        if int(meta.get("world_size", 1)) != self.k:
            raise ValueError(f"checkpoint was written by "
                             f"{meta.get('world_size', 1)} rank(s), this "
                             f"table runs on {self.k}")
        arrays = ckpt.restore(path, meta)
        hot = self.hot

        def mine(t):  # whole saved slots -> this rank's, placed
            return ckpt.place(hot._own(hot._pad(t[:self.device_rows])),
                              self.device)

        table = mine(arrays["hot_table"])
        state = ckpt.unflatten_like(hot.state(), {
            i: mine(t) for i, t in arrays.get("hot_opt", {}).items()})
        hot._check_installable(table, state)
        cold = arrays.get("cold_opt", {})
        if len(cold) != len(self.cold_state):
            raise ValueError(f"checkpoint holds {len(cold)} cold state "
                             f"leaves, this optimizer has "
                             f"{len(self.cold_state)}")
        ckpt.check_like("arena", arrays["arena"], self.arena)
        for i, live_leaf in enumerate(self.cold_state):
            ckpt.check_like(f"cold state leaf {i}", cold[f"{i:05d}"],
                            live_leaf)
        for key, attr, dt in _DIRECTORY:
            got = arrays[key]
            if tuple(got.shape) != getattr(self, attr).shape or \
                    got.numpy().dtype != dt:
                raise ValueError(f"checkpoint {key} is {tuple(got.shape)} "
                                 f"{got.dtype}, this directory's is "
                                 f"{getattr(self, attr).shape} {dt}")
        # every check passed: install
        hot._table, hot._state = table, state
        self.arena = self._host_copy(arrays["arena"])
        self.cold_state = [self._host_copy(cold[f"{i:05d}"])
                           for i in range(len(self.cold_state))]
        for key, attr, dt in _DIRECTORY:
            setattr(self, attr, arrays[key].numpy().astype(dt, copy=True))
        self.hand = int(meta["hand"])
        self.dir_gen = int(meta["dir_gen"])
        self.push_count = int(meta["push_count"])
        # change stamps are not saved: every row changed at the restored
        # version (deltas widen, never lose a row)
        self.row_version[:] = self.push_count
        for name in ("rows_pushed", "bytes_pushed", "bytes_pulled",
                     "collective_bytes", "hot_hits", "misses", "promotions",
                     "evictions"):
            setattr(self, name, int(meta[name]))
        self._cold_gen += 1  # staged slabs predate the restore
        self._staged = None
        # the hot tier's counters resume too, so a service seeding its
        # versions from push_count agrees either way
        hot.push_count = self.push_count
        hot.rows_pushed = self.rows_pushed
        return hot.table

    # -- the conservation audit ------------------------------------------------

    def row_sum(self) -> float:
        """The f64 sum over every logical row wherever it lives (a hot
        row's device copy, a cold row's arena one): churn moves rows but
        must never lose or double-count one."""
        hot_ids = self.slot_to_id[self.slot_to_id >= 0]
        hot_rows = self.hot.pull(self.slot[hot_ids]).double().sum()
        cold = torch.from_numpy(self.tier == 0)
        return float(hot_rows.cpu() + self.arena[cold].double().sum())
