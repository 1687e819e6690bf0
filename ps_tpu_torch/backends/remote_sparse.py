"""Cross-process sparse PS: embedding tables served over the van.

Counterpart of ``ps_tpu/backends/remote_sparse.py``, the reference's
classic async deployment: Wide-&-Deep with range-sharded tables on server
processes, and workers that push and pull rows.

- Each SERVER process owns a contiguous row range of every table
  (:func:`row_range`) as a one-process :class:`~ps_tpu_torch.kv.sparse.
  SparseEmbedding` on its device, with its per-row optimizer state, and
  serves ROW_PULL / ROW_PUSH / ROW_PUSH_PULL / ROW_BUCKET_PUSH frames
  (:class:`SparsePSService`). One service owns several named tables
  (Wide-&-Deep's "deep" [V, D] and "wide" [V, 1]), so a worker's cycle is
  one round trip a server. Every applied push goes through
  ``SparseEmbedding.push``: on the card, the grouping pass and the apply
  kernel (``ops/csrc/sparse_group.cu``, ``sparse_apply.cu``).
- Each WORKER process runs :class:`RemoteSparseWorker`: it routes global
  ids to their owners by range, fans the per-server requests out
  concurrently and scatters the pulled rows back into id order. Pushes
  apply at once on the server (async semantics; a per-table version
  counts the applies). A dead server surfaces as a typed
  :class:`ServerFailureError` naming its index, unless its replica set
  (``"p0:a|b0:c,p1:d|b1:e"``) has a member to fail over to.
- Replication (``replica/``): a ``backup=True`` server follows its
  primary's stream of committed row pushes (global ids and the host grads
  that were applied) through its own tables, so each replicated push runs
  the grouping and apply kernels in the backup's process too, and refuses
  workers until promoted.

Tensors cross the van as numpy views of host memory. A pushed gradient
(or id) on the card is copied to pinned host memory and waited for before
the send (``stage_to_host``); the server copies a push's rows onto its
table's device, waited for, before the frame's receive buffer goes back
to its pool (``stage_to_device``). Pulled rows come back as tensors on
the device of the ids that asked for them; numpy or list ids get CPU
tensors. The frames are the reference's: a port worker drives a reference
server and a reference worker a port server.

Parity: each server records its apply order; replaying that (worker,
cycle) push sequence, routed by the same range split, through a
one-process ``SparseEmbedding`` of the server's local size gives the
same table bitwise.

The van's transport options are the reference's: a server may serve
through the native epoll loop, where native push admission acks a
replayed ``ROW_PUSH`` without an upcall (``native_loop=True``); a worker
may move its frames through the same-host shared-memory lane
(``shm=True``); and a worker's row grads may travel int8- or
cast16-compressed (``compress=``; the int32 ids always raw, topk
refused: row pushes are sparse already), decoded by the server before
they are staged to the table's device. Every such push still ends in the
sparse-apply kernels.

The read path: a ``READ`` of ``{"<table>/ids": ...}`` is a
side-effect-free row fetch whose reply (worker id 0) is a pure function
of committed state, stamped with the table versions and each table's
birth (``obs/freshness.py``), so the native loop can cache it; the entry
is tagged with the (table, row) pairs it covers, and an apply drops only
the entries it intersects. A conditional READ (``{"conds": {table: v},
"cond": sum}``) gets only the rows whose per-row change stamp
(``SparseEmbedding.row_version``) moved past ``v`` (a delta), or a
NOT_MODIFIED stamp when no requested table moved. A backup answers READs
too. :meth:`RemoteSparseWorker.read_rows` revalidates the rows it holds
for an id-set with conditional READs and spreads reads over each shard's
replica set within a staleness bound.

A served table may be a :class:`~ps_tpu_torch.kv.tiered.TieredTable`
(a device hot set over a host arena). Its pushes reach it as host arrays
of their own memory (it splits them by its directory and stages the hot
half itself), its cold slab is prefetched before the apply lock, and
after the apply its move log (``tier_moves``) is harvested: the moved
rows join the read-cache invalidation, the log rides the replicated
push's meta and a backup replays it verbatim, and the cold passes'
latencies go to ``cold_gather_s``. STATS reports each tiered table's
``tier_stats()``; its reads gather the cold rows on the host.

Observability (``obs/``): a worker op is a span whose context rides its
row-push and pull frames under ``"tc"``, the server's apply (lock wait
and the device sync included) is a ``server_apply`` child of its serve
span, the rows it lands count into ``ps_sparse_rows_applied_total``, and
a re-dial is a ``reconnect`` flight event.

Elastic membership (``elastic/``): a server given ``coordinator=`` joins
the coordinator's table with one ``<table>@<lo>:<hi>`` key a table it
serves (membership, liveness, load and telemetry reports); a worker
given ``coordinator=`` finds the servers covering its tables there. A
sparse range never moves live (that would resize serving tables): the
coordinator refuses such a move, and a member leaves by stopping. A
replacement that registers a departed member's exact ranges takes its
slot, and the workers re-discover the fleet on their next op (a
``table_reroute`` flight event) without a restart.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ps_tpu_torch.backends.common import (
    DRAIN_TO_TIMEOUT_S,
    BucketedTransportMixin,
    BucketPlan,
    ServerFailureError,
    parse_replica_uri,
    payload_nbytes,
    request_payload,
    stage_to_device,
    stage_to_host,
)
from ps_tpu_torch.backends.remote_async import (
    CheckpointRoundError,
    CheckpointRoundsMixin,
    PendingCycle,
)
from ps_tpu_torch.compress import decode_tree, resolve_spec
from ps_tpu_torch.backends.van_service import (
    VanService,
    log_tail,
    make_history_log,
    resolve_ckpt_dir,
)
from ps_tpu_torch import obs
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs import freshness

__all__ = [
    "SparsePSService", "RemoteSparseWorker", "ServerFailureError",
    "serve_sparse", "connect_sparse", "row_range", "dedupe_rows_np",
]


def row_range(shard: int, num_shards: int, total_rows: int) -> Tuple[int, int]:
    """The contiguous global row range ``[lo, hi)`` that server ``shard``
    of ``num_shards`` owns in a ``total_rows``-row table: an even ceil
    split, the last shard taking what remains (fewer rows, or none)."""
    if not (0 <= shard < num_shards):
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    per = math.ceil(total_rows / num_shards)
    lo = min(shard * per, total_rows)
    return lo, min(lo + per, total_rows)


#: per-key read-cache invalidation: a cached READ entry is tagged with one
#: u64 a (table, global row id) it covers, and a row apply drops only the
#: entries it intersects. Past these caps the tags are left off: an
#: untagged entry drops on any invalidation, an untagged apply drops
#: everything (no tag arithmetic for huge batches under the apply lock)
READ_TAG_CAP = 128
APPLY_TAG_CAP = 512


def _table_hash(name: str) -> int:
    """A stable 64-bit seed a table name (tags never leave the process)."""
    import hashlib

    return int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")


def _row_tags(table_hash: int, ids: np.ndarray) -> set:
    """One mix-hashed u64 tag a (table, global row id)."""
    mask = (1 << 64) - 1
    return {(table_hash ^ ((int(i) + 0x9E3779B97F4A7C15)
                          * 0xBF58476D1CE4E5B9)) & mask
            for i in np.asarray(ids).ravel().tolist()}


def dedupe_rows_np(ids: np.ndarray, grads: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The worker's pre-push merge: each unique id's grads summed in f32,
    rounded once back to the wire dtype, ids ascending. Host numpy, so a
    port worker's payload equals a reference worker's byte for byte."""
    if ids.size == 0:
        return ids, grads
    uniq, inv = np.unique(ids, return_inverse=True)
    summed = np.zeros((uniq.size, grads.shape[1]), np.float32)
    np.add.at(summed, inv, grads.astype(np.float32))
    return uniq.astype(ids.dtype), summed.astype(grads.dtype)


def _host(x) -> np.ndarray:
    """A tensor's or an array's values as a numpy array on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class SparsePSService(VanService):
    """Serve named :class:`SparseEmbedding` tables to remote workers.

    Accepting, serving and draining live in :class:`VanService`; this
    class is the protocol: HELLO, ROW_PULL, ROW_PUSH, ROW_PUSH_PULL,
    ROW_BUCKET_PUSH, STATS and CHECKPOINT over the tables.

    Args:
      tables: ``{name: initialized one-process SparseEmbedding}`` (or
        ``TieredTable``); in sharded mode each holds only this server's
        :func:`row_range` rows of the table's global size. A bf16 table is
        refused (the wire has no bfloat16).
      port/bind: as :class:`~ps_tpu_torch.backends.remote_async.
        AsyncPSService` (loopback by default: the endpoint is
        unauthenticated).
      shard/num_shards: this server's place in an N-server row partition
        (None = one server owns every row).
      total_rows: sharded mode only, ``{name: global rows}``: each local
        table's ``num_rows`` is checked against its slice, so a
        mis-sliced topology fails here, and workers check coverage at
        connect time.
      ckpt_root: confine CHECKPOINT saves under this server-side root.
      record_full_history: keep every apply-log entry (replay parity); by
        default the log is a ring of ``history`` entries.
      coordinator: ``"host:port"`` of an elastic-membership coordinator:
        the service registers its row ranges there as
        ``advertise_host:port`` once it listens (a backup does not).

    The pull and read paths gather the requested rows into a fresh
    tensor under the lock, on the serve thread's stream, so the gather is
    ordered before any later in-place apply; its copy off the card is
    waited for before the reply frame is encoded, outside the lock.
    """

    def __init__(self, tables: Dict[str, Any], port: int = 0,
                 bind: str = "127.0.0.1", shard: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 total_rows: Optional[Dict[str, int]] = None,
                 ckpt_root: Optional[str] = None,
                 writev: Optional[bool] = None,
                 shm: Optional[bool] = None,
                 backup: bool = False,
                 record_full_history: bool = False,
                 history: int = 4096,
                 coordinator=None,
                 advertise_host: str = "127.0.0.1",
                 native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None):
        if not tables:
            raise ValueError("no tables to serve")
        if (shard is None) != (num_shards is None):
            raise ValueError("pass shard and num_shards together")
        self.shard, self.num_shards = shard, num_shards
        self._tables = dict(tables)
        self._meta: Dict[str, dict] = {}
        for name, emb in self._tables.items():
            if emb.dtype == torch.bfloat16:
                raise TypeError(
                    f"table {name!r} is bfloat16: its rows cannot travel "
                    f"the van (numpy has no bfloat16, and the reference's "
                    f"frame names such a leaf '<V2'); serve float32")
            if num_shards is None:
                lo, hi = 0, emb.num_rows
                total = emb.num_rows
            else:
                if total_rows is None or name not in total_rows:
                    raise ValueError(
                        f"sharded mode needs total_rows[{name!r}]")
                total = int(total_rows[name])
                lo, hi = row_range(shard, num_shards, total)
                if emb.num_rows != hi - lo:
                    raise ValueError(
                        f"table {name!r} holds {emb.num_rows} rows but "
                        f"shard {shard}/{num_shards} of {total} owns "
                        f"[{lo}, {hi}) = {hi - lo} rows — init it with "
                        f"row_range(shard, num_shards, total)")
            self._meta[name] = {
                "total_rows": total, "lo": lo, "hi": hi, "dim": emb.dim,
                "dtype": _numpy_dtype(emb.dtype).str,
            }
        self._devices = sorted({emb.device for emb in self._tables.values()
                                if emb.device.type == "cuda"}, key=str)
        # one lock: a multi-table push applies atomically, and a pull never
        # sees half of one
        self._lock = threading.Lock()
        self._draining = False
        # checkpoint pause: pushes block (not refuse) while a coordinated
        # snapshot is in flight, but for those a drain_to round admits
        self._paused = False
        self._pause_cond = threading.Condition(self._lock)
        self._ckpt_root = ckpt_root
        # seeded from the tables' own (possibly restored) counters, so a
        # server restarted from a checkpoint resumes its version stream
        self.versions: Dict[str, int] = {
            n: int(emb.push_count) for n, emb in self._tables.items()}
        self.rows_applied: Dict[str, int] = {
            n: int(emb.rows_pushed) for n, emb in self._tables.items()}
        # a birth stamp a table: when its current version committed. It
        # rides READ replies as committed state; a never-applied table has
        # none, so two services over the same state encode the same replies
        self._births: Dict[str, dict] = {}
        #: each table's apply tier ('cuda', 'torch' or 'off')
        self.fused_tiers: Dict[str, str] = {
            n: emb.fused_tier for n, emb in self._tables.items()}
        self._rows_counter = obs.default_registry().counter(
            "ps_sparse_rows_applied_total",
            "raw sparse row updates applied (server side)")
        # exactly-once and the checkpoint's drain round: worker -> (nonce,
        # cycle seq, fanout) of its last applied push. A sparse cycle
        # routes to a subset of the shards, so the seq and the fanout make
        # the shards' reports comparable
        self._applied_pseq: Dict[int, tuple] = {}
        self._drain_targets: Dict[int, tuple] = {}
        self._log_lock = threading.Lock()
        self._table_hashes: Dict[str, int] = {}
        # worker id per applied push message
        self.apply_log = make_history_log(record_full_history, history)
        # elastic membership: the shard joins the coordinator's table; its
        # ranges never move live (a move would resize serving tables)
        self._coordinator = coordinator
        self._coord_member = None
        super().__init__(port=port, bind=bind, writev=writev, shm=shm,
                         backup=backup, native_loop=native_loop,
                         loop_threads=loop_threads)
        if coordinator is not None and not backup:
            self._join_coordinator(advertise_host)

    def _join_coordinator(self, advertise_host: str) -> None:
        """Register one ``<table>@<lo>:<hi>`` key a table with its bytes
        (unique across the row partition, so the coordinator's ownership
        check holds), and report the push rate and this service's own
        telemetry on the coordinator's cadence."""
        from ps_tpu_torch.config import env_flag
        from ps_tpu_torch.elastic.member import CoordinatorMember
        from ps_tpu_torch.obs.collector import collect_telemetry

        key_bytes = {
            f"{name}@{m['lo']}:{m['hi']}":
                (m["hi"] - m["lo"]) * m["dim"] * np.dtype(m["dtype"]).itemsize
            for name, m in self._meta.items()}
        last = {"t": time.monotonic(), "applies": self.apply_log.total}

        def report_extra() -> dict:
            now = time.monotonic()
            applies = self.apply_log.total
            dt = max(now - last["t"], 1e-6)
            push_qps = (applies - last["applies"]) / dt
            last.update(t=now, applies=applies)
            return {"keys": len(self._meta),
                    "nbytes": sum(key_bytes.values()),
                    "push_qps": round(push_qps, 2),
                    "pull_qps": None}  # a read advances no counter

        telemetry = None
        if env_flag("PS_TELEMETRY", True):
            def telemetry() -> dict:
                return collect_telemetry(self.transport, counters={
                    "ps_applies_total": lambda: self.apply_log.total,
                })

        self._coord_member = CoordinatorMember(
            self._coordinator, f"{advertise_host}:{self.port}",
            key_bytes, kind="sparse", report=report_extra,
            telemetry=telemetry)
        self.table_epoch = self._coord_member.table.epoch

    def stop(self, grace: float = 10.0) -> None:
        m = self._coord_member
        if m is not None:
            m.close(goodbye=True)  # a clean leave: 'left', never 'dead'
        super().stop(grace=grace)

    def kill(self) -> None:
        m = self._coord_member
        if m is not None:
            m.close(goodbye=False)  # as a SIGKILL: the beats just stop
        super().kill()

    # -- server internals -----------------------------------------------------

    def _hello_extra(self) -> dict:
        return {
            "tables": self._meta,
            "shard": self.shard,
            "num_shards": self.num_shards,
            "versions": dict(self.versions),
            "epoch": self.epoch,
            "role": self.role,
        }

    def _split(self, tensors: Dict[str, np.ndarray]
               ) -> Dict[str, Dict[str, np.ndarray]]:
        """``{"deep/ids": x}`` frames -> ``{"deep": {"ids": x}}``."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for k, v in tensors.items():
            name, _, field = k.partition("/")
            if name not in self._tables:
                raise KeyError(f"unknown table {name!r}")
            out.setdefault(name, {})[field] = v
        return out

    def _localize(self, name: str, ids: np.ndarray) -> np.ndarray:
        m = self._meta[name]
        ids = np.asarray(ids, np.int32)
        if ids.size and (ids.min() < m["lo"] or ids.max() >= m["hi"]):
            raise IndexError(
                f"ids outside this server's {name!r} range "
                f"[{m['lo']}, {m['hi']})")
        return ids - m["lo"]

    def _sync_tables(self) -> None:
        for dev in self._devices:
            torch.cuda.synchronize(dev)

    def _apply_push(self, worker: int,
                    per_table: Dict[str, Dict[str, np.ndarray]],
                    extra: Optional[dict] = None
                    ) -> Tuple[Optional[int], bool]:
        """Apply one multi-table push; returns ``(replication_seq,
        dedup)``. ``extra``'s ``pseq``/``pnonce``/``pfan`` are the
        worker's cycle token: a seq at or below the last applied one (same
        nonce) is a replay, acked without an apply."""
        extra = extra or {}
        pseq = extra.get("pseq")
        pnonce = extra.get("pnonce")
        pfan = extra.get("pfan")
        todo = []
        # the replicated entry: the global ids and the host grads that are
        # applied, in memory of its own (the frame they view goes back to
        # its pool, or the native loop, once the reply is sent)
        wire = {} if self._replicating() else None
        for name, t in per_table.items():
            if "ids" not in t or "grads" not in t:
                raise KeyError(f"push for {name!r} needs ids + grads")
            want = (np.asarray(t["ids"]).size, self._meta[name]["dim"])
            if tuple(np.shape(t["grads"])) != want:
                # checked for every table first: a push applies whole
                raise ValueError(f"push for {name!r}: grads of shape "
                                 f"{tuple(np.shape(t['grads']))}, want {want}")
            todo.append((name,) + self._stage_push(name, t))
            if wire is not None:
                wire[f"{name}/ids"] = np.array(t["ids"], np.int32)
                wire[f"{name}/grads"] = np.array(t["grads"])
        if not todo:
            return None, False  # push_pull with no rows for this server
        # a tiered table stages its cold slab's arena gather now, beside
        # whatever apply holds the lock; its generation tag drops the slab
        # if that apply moves rows first
        for name, ids, _g in todo:
            pf = getattr(self._tables[name], "prefetch", None)
            if pf is not None:
                pf(ids)
        t_apply = time.perf_counter()
        # the apply, lock wait and device sync included, is a child of the
        # serve span when the request is traced; dedup replays record none
        with obs.tracer().child("server_apply", cat="server"), self._lock:
            while (self._paused and not self._draining
                   and not self._admit_while_paused(worker)):
                self._pause_wait_begin()
                try:
                    self._pause_cond.wait()  # a checkpoint snapshot
                finally:
                    self._pause_wait_end()
            if self._draining:
                raise RuntimeError("server is draining; push refused")
            # the replay check runs after any pause park: the wait
            # releases the lock, so the ledger may have moved meanwhile. A
            # native admission stamp proves the loop saw this frame
            # strictly fresh at a generation no apply superseded
            if pseq is not None and not self._admit_fresh_hint():
                last = self._applied_pseq.get(worker)
                if (last is not None and last[0] == pnonce
                        and int(pseq) <= last[1]):
                    self.transport.record_dedup_hit()
                    return None, True
            t_rows = time.perf_counter()
            rows = 0
            for name, ids, grads in todo:
                self._tables[name].push(ids, grads)
                self.versions[name] += 1
                self.rows_applied[name] += len(ids)
                rows += len(ids)
            # wait for the applies inside the timed window, so that
            # sparse_apply_s times the apply and not its enqueue (a later
            # request on this lock would wait for the same work)
            self._sync_tables()
            self.transport.record_sparse_apply(
                rows, time.perf_counter() - t_rows)
            self._rows_counter.inc(rows)
            # a tiered table's move log, for the replication stream (tier
            # placement is replicated state)
            tier_moves = self._pop_tier_moves(todo)
            # per key: only cached id-sets this push touched drop, and the
            # rows a tier move touched beyond them; the generation rises
            # for everyone, so an in-flight publish of a pre-apply
            # snapshot is refused either way
            self._invalidate_reads(tags=self._move_tags(
                self._tags_for(per_table, APPLY_TAG_CAP), tier_moves))
            # one birth for every table of the push (they committed
            # together under this lock)
            stamp = freshness.birth_record()
            for name, _ids, _g in todo:
                self._births[name] = stamp
            apply_s = time.perf_counter() - t_apply
            if pseq is not None:
                self._applied_pseq[worker] = (pnonce, int(pseq),
                                              list(pfan or []))
            self._admit_publish(worker)
            self._pause_cond.notify_all()  # a drain_to waiter may watch
            with self._log_lock:
                self.apply_log.append(worker)
            # appended under the table lock: log order is apply order
            if wire is None and self._replicating():
                # a session attached while this push was staged
                wire = {}
                for name, ids, grads in todo:
                    wire[f"{name}/ids"] = (_host(ids)
                                           + self._meta[name]["lo"]
                                           ).astype(np.int32)
                    wire[f"{name}/grads"] = _host(grads)
            rseq = self._replicate("push", worker, wire, {  # pslint: disable=PSL101 -- deliberate backpressure: a full ack window MUST stall commits under the apply lock (that IS the bounded-lag contract), and stall_timeout degrades a corpse instead of wedging
                "pseq": pseq, "pnonce": pnonce, "pfan": pfan,
                "tier_moves": tier_moves or None, "birth": stamp["birth"]})
        self.transport.record_apply(apply_s)
        self.transport.record_fresh_lag(time.perf_counter() - t_apply)
        return rseq, False

    def _stage_push(self, name: str, t: Dict[str, np.ndarray]):
        """A push's (local ids, grads) out of the receive buffer, which
        goes back to its pool once the reply is sent: onto the table's
        device, waited for; a tiered table's as host arrays of their own
        (it splits them by its directory and stages the hot half)."""
        emb = self._tables[name]
        ids = self._localize(name, t["ids"])
        if hasattr(emb, "pop_moves"):
            return ids, np.array(t["grads"])
        on = stage_to_device({"ids": ids, "grads": t["grads"]}, emb.device,
                             stats=self.transport)
        return on["ids"], on["grads"]

    def _pop_tier_moves(self, todo) -> Dict[str, dict]:
        """Harvest the tiered tables' move logs of this push, and drain
        their cold passes' latencies into ``cold_gather_s``. Empty logs
        stay off the wire: a backup replays an empty log for an absent
        entry and never plans moves itself."""
        tier_moves: Dict[str, dict] = {}
        for name, *_ in todo:
            emb = self._tables[name]
            pop = getattr(emb, "pop_moves", None)
            if pop is None:
                continue
            mv = pop()
            if mv.get("ops"):
                tier_moves[name] = mv
            for secs in emb.drain_cold_gather():
                self.transport.record_cold_gather(secs)
        return tier_moves

    def _move_tags(self, tags, tier_moves: Dict[str, dict]):
        """Apply tags joined by the tags of the rows a tier move touched
        (TTL and CLOCK victims lie outside the push's id-set, and a cached
        read of them must drop too). None (already untagged) stays None;
        past the cap the union degrades the same way."""
        if tags is None or not tier_moves:
            return tags
        out = set(tags)
        for name, mv in tier_moves.items():
            moved = np.asarray([rid for kind, rid, _s in mv["ops"]
                                if kind != "r"], np.int64)
            if moved.size:
                out |= _row_tags(self._tbl_hash(name),
                                 moved + self._meta[name]["lo"])
            if len(out) > APPLY_TAG_CAP:
                return None
        return sorted(out)

    def _admit_while_paused(self, worker: int) -> bool:
        """Under pause, admit exactly the pushes a drain_to round waits
        on: this worker's applied cycle seq still lags its cross-shard
        target (same incarnation)."""
        tgt = self._drain_targets.get(worker)
        if tgt is None:
            return False
        nonce, seq = tgt
        rec = self._applied_pseq.get(worker)
        if rec is None:
            return True  # the targeted cycle's message is still in flight
        return rec[0] == nonce and rec[1] < seq

    # -- the zero-upcall push plane (VanService's admission hooks) ------------

    def _service_lock(self):
        return self._lock

    def _admit_kind(self):
        # flat ROW_PUSH only: ROW_PUSH_PULL replies with rows (no template
        # can pre-encode them) and bucketed row pushes stage
        return tv.ROW_PUSH

    def _admit_entry(self, worker: int):
        """The worker's last applied cycle as a ledger row: lo == hi ==
        its seq, so a replay at or below it is settled and anything above
        strictly fresh (the pump's replay test)."""
        rec = self._applied_pseq.get(worker)
        if rec is None or not isinstance(rec[0], str):
            return None
        return rec[0], int(rec[1]), int(rec[1])

    def _admit_ack_bytes(self):
        # byte for byte the pump's pure-replay ack (the loop patches the
        # worker id): the current table versions, dedup set
        return self._push_reply(0, True)

    def _rows_payload(self, worker: int,
                      per_table: Dict[str, Dict[str, np.ndarray]]):
        rows = {}
        with self._lock:
            for name, t in per_table.items():
                ids = self._localize(name, t["ids"])
                rows[f"{name}/rows"] = self._tables[name].pull(ids)
            versions = dict(self.versions)
        # outside the lock: each gather is a fresh tensor no apply writes,
        # queued on this thread's stream ahead of any apply that takes the
        # lock after it; the copy off the card is waited for here
        out = stage_to_host(rows, stats=self.transport)
        if self.writev:
            return tv.encode_parts(tv.OK, worker, out,
                                   extra={"versions": versions})
        return tv.encode(tv.OK, worker, out, extra={"versions": versions})

    def _read_rows_payload(self, per_table, extra=None) -> bytes:
        """One READ: a side-effect-free row fetch whose reply (worker id 0)
        the native cache serves to byte-identical requests until an apply
        touches its rows. The publish generation is taken under the lock
        with the rows.

        A conditional request (``extra["conds"]``: table -> the caller's
        version) ships, a table, only the rows whose ``row_version`` passed
        that version (``<table>/dids`` global ids, ``<table>/drows``), and
        when no requested table moved, a NOT_MODIFIED stamp. A table
        without a cond is served whole."""
        conds = None
        if isinstance(extra, dict) and isinstance(extra.get("conds"), dict):
            conds = extra["conds"]
        rows = {}
        delta_rows = 0
        with self._lock:
            versions = dict(self.versions)
            gen = self._read_gen_snapshot()
            # each requested table's birth, taken with the rows:
            # [wall, monotonic, stamper token]
            births = {}
            for name in per_table:
                b = self._births.get(name)
                if b is not None:
                    births[name] = [b["birth"], b["bmono"], b["bpid"]]
            for name, t in per_table.items():
                v = conds.get(name) if conds is not None else None
                if v is None:
                    ids = self._localize(name, t["ids"])
                    rows[f"{name}/rows"] = self._tables[name].pull(ids)
                    continue
                v = int(v)
                if int(versions[name]) <= v:
                    continue  # unchanged: nothing to ship
                emb = self._tables[name]
                uids = np.unique(np.asarray(t["ids"], np.int64))
                uids = uids[uids >= 0]
                lids = self._localize(name, uids)
                changed = emb.row_version[lids] > v
                uids, lids = uids[changed], lids[changed]
                if uids.size == 0:
                    continue  # the table moved, the requested rows did not
                rows[f"{name}/dids"] = uids.astype(np.int64)
                rows[f"{name}/drows"] = emb.pull(lids)
                delta_rows += int(uids.size)
        # outside the lock: each gather is a fresh tensor queued ahead of
        # any later apply; the copy off the card is waited for here
        out = stage_to_host(rows, stats=self.transport)
        vsum = self._vsum(versions)
        # the serve-side age judges the oldest requested table
        oldest = (min((freshness.from_extra({"births": births}, table=n)
                       for n in births),
                      key=lambda b: b["birth"]) if births else None)
        tags = self._tags_for(per_table, READ_TAG_CAP)
        if conds is not None and not out:
            # no requested table moved for this caller: a stamp (births
            # included, so a revalidation refreshes the age)
            reply = tv.encode(tv.NOT_MODIFIED, 0, None,
                              extra={"versions": versions,
                                     "version": vsum, "births": births})  # pslint: disable=PSL203 -- read on the worker by obs/freshness.from_extra (extra.get("births")), a module that never names the van, so this rule does not scan it
            self.transport.record_read_not_modified()
        elif conds is not None:
            reply = tv.encode(tv.OK, 0, out,
                              extra={"versions": versions,
                                     "version": vsum, "delta": 1,
                                     "births": births})
            if delta_rows:
                self.transport.record_read_delta_rows(delta_rows)
        else:
            reply = tv.encode(tv.OK, 0, out, extra={"versions": versions,
                                                    "version": vsum,
                                                    "births": births})
        self._note_read_snapshot(gen, vsum, tags=tags)
        self.transport.record_read_served()
        self._note_serve_age(oldest)
        return reply

    def _tbl_hash(self, name: str) -> int:
        h = self._table_hashes.get(name)
        if h is None:
            h = self._table_hashes[name] = _table_hash(name)
        return h

    def _tags_for(self, per_table, cap: int):
        """The invalidation tags of a request's or an apply's global
        id-sets, or None past ``cap`` (untagged: the conservative
        behavior). The id count is checked before any hashing."""
        if sum(int(np.asarray(t["ids"]).size)
               for t in per_table.values()) > cap:
            return None
        tags: set = set()
        for name, t in per_table.items():
            tags |= _row_tags(self._tbl_hash(name), t["ids"])
        return sorted(tags) if tags else None

    @staticmethod
    def _vsum(versions) -> int:
        return int(sum(int(v) for v in versions.values()))

    def _read_version(self):
        # without the lock: this runs on the loop's one pump thread
        # (REPLICA_STATE, the stats tick) and must not queue behind an
        # apply or a checkpoint save. The table set is fixed and versions
        # only grow, so an unlocked sum is a monotone probe
        return self._vsum(self.versions)

    def _push_reply(self, worker: int, dedup: bool, **extra):
        return tv.encode(tv.OK, worker, None, extra={
            "versions": dict(self.versions), **extra, "dedup": dedup})

    def _stats(self, worker: int):
        with self._log_lock:
            log = log_tail(self.apply_log)  # a bounded tail, the true total
            log_total = self.apply_log.total
        out = {
            "versions": dict(self.versions),
            "rows_applied": dict(self.rows_applied),
            "fused": {"tiers": dict(self.fused_tiers),
                      "rows_applied": sum(self.rows_applied.values())},
            "tier": {n: emb.tier_stats()
                     for n, emb in self._tables.items()
                     if hasattr(emb, "tier_stats")},
            "apply_log": log,
            "apply_log_total": log_total,
            "stale_epochs": self.transport.stale_epochs,
            "stale_epoch_buckets": self.transport.stale_epoch_buckets,
            "metrics": self.transport.metrics_snapshot(),
        }
        out.update(self.replica_state())
        return tv.encode(tv.OK, worker, None, extra=out)

    def _handle(self, kind: int, worker: int, tensors, extra):
        if kind == tv.HELLO:
            return tv.encode(tv.OK, worker, None, extra=self._hello_extra())
        if kind == tv.ROW_PULL:
            return self._rows_payload(worker, self._split(tensors))
        if kind == tv.READ:
            return self._read_rows_payload(self._split(tensors), extra)
        if kind in (tv.ROW_PUSH, tv.ROW_PUSH_PULL):
            # codec-packed grads decoded before they are staged to the
            # table's device (the ids always travel raw)
            tensors = decode_tree(dict(tensors), extra.get("enc"),
                                  stats=self.transport)
        if kind == tv.ROW_PUSH:
            rseq, dedup = self._apply_push(worker, self._split(tensors),
                                           extra=extra)
            self._await_replication(rseq)
            return self._push_reply(worker, dedup)
        if kind == tv.ROW_PUSH_PULL:
            per = self._split(tensors)
            push = {n: t for n, t in per.items() if "grads" in t}
            pull = {n: {"ids": t["pull_ids"]}
                    for n, t in per.items() if "pull_ids" in t}
            rseq, _ = self._apply_push(worker, push, extra=extra)
            self._await_replication(rseq)
            return self._rows_payload(worker, pull)
        if kind == tv.ROW_BUCKET_PUSH:
            # one fusion bucket of a multi-bucket row push: staged until its
            # epoch completes, then the whole multi-table push applies at
            # once (a torn push is never observable)
            tree = self._stage_bucket_push(
                worker, int(extra["bucket"]), int(extra["nbuckets"]),
                int(extra["epoch"]), tensors["raw"], extra["slices"],
                nonce=extra.get("nonce"))
            if tree is None:
                return tv.encode(tv.OK, worker, None,
                                 extra={"staged": int(extra["bucket"])})
            tree = decode_tree(tree, extra.get("enc"), stats=self.transport)
            rseq, dedup = self._apply_push(worker, self._split(tree),
                                           extra=extra)
            self._await_replication(rseq)
            return self._push_reply(worker, dedup, committed=True)
        if kind == tv.STATS:
            return self._stats(worker)
        if kind == tv.CHECKPOINT:
            return self._checkpoint(worker, extra)
        return tv.encode(tv.ERR, worker, None,
                         extra={"error": f"bad kind {kind}"})

    def _checkpoint(self, worker: int, extra: dict):
        """The coordinated, cross-shard-atomic checkpoint, driven by
        :meth:`RemoteSparseWorker.checkpoint_all`: 'pause' blocks new
        applies and reports each worker's last applied (nonce, cycle seq,
        fanout); 'drain_to' admits exactly the in-flight sub-pushes that
        bring every shard of a cycle's fanout to the cross-shard max, so a
        cycle is saved on all the shards it addressed or on none; 'save'
        writes every owned table under ``<dir>[/shard<i>]/<table>``
        (``SparseEmbedding.save`` or ``TieredTable.save``, both tiers in
        one commit, under the lock); 'resume' releases the
        applies. 'pause' hands out a token every later phase presents;
        ``phase='resume', force=True`` is the operator's override when a
        coordinator died holding it. A restarted server inits its
        range-sliced tables, restores each, and its versions resume from
        the restored push counts."""
        phase = extra.get("phase", "save")
        if phase == "pause":
            with self._lock:
                token = self._ckpt_issue_token()
                if token is None:
                    return tv.encode(tv.ERR, worker, None,
                                     extra={"error": self._ckpt_busy_error()})
                self._paused = True
                # paused: every push must reach the pump and park there
                self._admit_drop()
                applied = {str(w): [nonce, seq, fan]
                           for w, (nonce, seq, fan)
                           in self._applied_pseq.items()}
            return tv.encode(tv.OK, worker, None, extra={
                "versions": dict(self.versions), "token": token,
                "applied_pseq": applied})
        if phase == "resume" and extra.get("force"):
            with self._lock:
                self._paused = False
                self._ckpt_clear_token()
                # the pause is over: every cached READ drops and admission
                # reseeds
                self._invalidate_reads()
                self._admit_sync(locked=True)
                self._pause_cond.notify_all()
            return tv.encode(tv.OK, worker, None, extra={
                "versions": dict(self.versions), "forced": True})
        err = self._ckpt_token_error(phase, extra)
        if err is not None:
            return tv.encode(tv.ERR, worker, None, extra={"error": err})
        if phase == "drain_to":
            # a worker that reconnected mid-round (another nonce) counts
            # as satisfied: its old incarnation's messages cannot arrive
            targets = {int(w): (t[0], int(t[1]))
                       for w, t in extra.get("targets", {}).items()}
            deadline = time.monotonic() + float(
                extra.get("timeout", DRAIN_TO_TIMEOUT_S))

            def lagging(w, nonce, seq):
                rec = self._applied_pseq.get(w)
                if rec is None:
                    return True  # the targeted cycle is still in flight
                if rec[0] != nonce:
                    return False  # a new incarnation: the old one is dead
                return rec[1] < seq

            with self._lock:
                self._drain_targets = targets
                self._pause_cond.notify_all()
                while any(lagging(w, n, s) for w, (n, s) in targets.items()):
                    left = deadline - time.monotonic()
                    if left <= 0 or self._draining:
                        self._drain_targets = {}
                        return tv.encode(tv.ERR, worker, None, extra={
                            "error": ("drain_to aborted: server draining"
                                      if self._draining else
                                      "drain_to timed out: a worker's "
                                      "in-flight push never arrived")})
                    self._pause_cond.wait(left)
                self._drain_targets = {}
            return tv.encode(tv.OK, worker, None,
                             extra={"versions": dict(self.versions)})
        if phase == "resume":
            with self._lock:
                self._paused = False
                self._ckpt_clear_token()
                # the pause is over: every cached READ drops and admission
                # reseeds
                self._invalidate_reads()
                self._admit_sync(locked=True)
                self._pause_cond.notify_all()
            return tv.encode(tv.OK, worker, None,
                             extra={"versions": dict(self.versions)})
        base = resolve_ckpt_dir(self._ckpt_root, extra["dir"])
        root = (base if self.num_shards is None
                else os.path.join(base, f"shard{self.shard}"))
        with self._lock:
            for name, emb in self._tables.items():
                emb.save(os.path.join(root, name))
            versions = dict(self.versions)
        return tv.encode(tv.OK, worker, None,
                         extra={"versions": versions, "path": root})

    def _set_draining(self) -> None:
        with self._lock:
            self._draining = True
            self._pause_cond.notify_all()  # paused pushes wake into refusal
        self._invalidate_reads()
        self._admit_drop()  # the pump's draining refusal is the only answer

    # -- shard replication (replica/) -------------------------------------------

    def _replica_hello_extra(self) -> dict:
        return {
            "kind": "sparse",
            "tables": self._meta,
            "shard": self.shard,
            "num_shards": self.num_shards,
            "versions": dict(self.versions),
            "start_seq": 0,
        }

    def _replica_validate(self, extra: dict) -> Optional[str]:
        if extra.get("kind") != "sparse":
            return (f"replication stream kind {extra.get('kind')!r} does "
                    f"not match this sparse service")
        if extra.get("tables") != self._meta:
            return "primary and backup disagree on table metadata"
        if (extra.get("shard"), extra.get("num_shards")) \
                != (self.shard, self.num_shards):
            return (f"primary is shard {extra.get('shard')}/"
                    f"{extra.get('num_shards')}, backup is shard "
                    f"{self.shard}/{self.num_shards}")
        if {n: int(v) for n, v in (extra.get("versions") or {}).items()} \
                != self.versions:
            return (f"state-point mismatch: primary versions "
                    f"{extra.get('versions')}, backup {self.versions} — "
                    f"start the pair from the same initial tables or a "
                    f"common checkpoint")
        return None

    def _replica_apply(self, op: str, worker: int, tensors, extra) -> None:
        """One replicated row push through this backup's tables, with the
        table lock held by the dispatcher (so never through
        :meth:`_apply_push`): each table's rows go to its device and
        through ``SparseEmbedding.push``, the grouping and apply kernels
        on the card, waited for inside the timed window as the primary's
        apply is. A tiered table replays the primary's move log
        (``tier_moves``; an absent entry is an empty log) and never plans
        moves of its own, so its directory stays bitwise the primary's."""
        if op != "push":
            raise ValueError(f"unknown replica op {op!r}")
        tree = decode_tree(dict(tensors), extra.get("enc"),
                           stats=self.transport)
        split = self._split(tree)
        moves = extra.get("tier_moves") or {}
        todo = [(name,) + self._stage_push(name, t)
                for name, t in split.items()]
        t_rows = time.perf_counter()
        rows = 0
        for name, ids, grads in todo:
            emb = self._tables[name]
            if hasattr(emb, "pop_moves"):
                emb.push(ids, grads,
                         moves=moves.get(name) or {"ops": [], "hand": None})
            else:
                emb.push(ids, grads)
            self.versions[name] += 1
            self.rows_applied[name] += len(ids)
            rows += len(ids)
        self._sync_tables()
        self.transport.record_sparse_apply(rows,
                                           time.perf_counter() - t_rows)
        self._rows_counter.inc(rows)
        # a backup replicates nowhere further: its logs are dropped, its
        # cold passes timed
        self._pop_tier_moves(todo)
        # per key, as the primary's apply: a backup's cached reads of
        # id-sets this push did not touch stay valid, the replayed moves'
        # rows joining the tags
        self._invalidate_reads(tags=self._move_tags(
            self._tags_for(split, APPLY_TAG_CAP), moves))
        # the primary's birth for the touched tables (a foreign stamp: the
        # wall clock only), so replica reads report the age since the
        # primary's apply
        b = extra.get("birth")
        stamp = (freshness.foreign_record(float(b)) if b is not None
                 else freshness.birth_record())
        for name in split:
            self._births[name] = stamp
        if extra.get("pseq") is not None:
            self._applied_pseq[worker] = (extra.get("pnonce"),
                                          int(extra["pseq"]),
                                          list(extra.get("pfan") or []))
        with self._log_lock:
            self.apply_log.append(worker)


def serve_sparse(tables: Dict[str, Any], port: int = 0,
                 bind: str = "127.0.0.1", shard: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 total_rows: Optional[Dict[str, int]] = None,
                 ckpt_root: Optional[str] = None,
                 backup: bool = False,
                 native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None,
                 shm: Optional[bool] = None) -> SparsePSService:
    """Expose initialized sparse tables to remote worker processes.

    One server: each table holds its full row space, no shard arguments.
    Server ``s`` of ``N`` (the range-sharded topology): each table is
    made with ``hi - lo`` rows for ``lo, hi = row_range(s, N, total)``
    and ``total_rows={name: total}`` is passed. The tables live on the
    device ``ps_tpu_torch.init`` chose; workers join with
    :func:`connect_sparse`. ``native_loop`` (env ``PS_VAN_NATIVE_LOOP``)
    serves through the native epoll loop on ``loop_threads`` threads;
    ``shm`` (env ``PS_SHM``, on by default here) accepts the workers'
    shared-memory lane offers.

    ``backup=True`` starts the service as a backup: it follows a primary's
    replication stream, applying every replicated row push through its own
    tables (the sparse-apply kernels on its device), and refuses workers
    until promoted, but for READs, which it answers from its replicated
    tables. The primary calls ``svc.attach_backup(host, port, ack=...)``
    before admitting workers; both start from the same initial tables."""
    return SparsePSService(tables, port=port, bind=bind, shard=shard,
                           num_shards=num_shards, total_rows=total_rows,
                           ckpt_root=ckpt_root, shm=shm, backup=backup,
                           native_loop=native_loop,
                           loop_threads=loop_threads)


def connect_sparse(uri: Optional[str], worker: int,
                   tables: Dict[str, Tuple[int, int]],
                   bucket_bytes: Optional[int] = None,
                   pool_size: Optional[int] = None,
                   compress=None, writev: Optional[bool] = None,
                   shm: Optional[bool] = None,
                   shm_bytes: Optional[int] = None,
                   failover_timeout: Optional[float] = None,
                   coordinator=None,
                   read_staleness: Optional[int] = None
                   ) -> "RemoteSparseWorker":
    """Join a cross-process sparse PS as worker ``worker``.

    ``uri`` is ``host:port`` or a comma-separated list naming every server
    of the row partition; ``tables`` is ``{name: (total_rows, dim)}``,
    checked against what the servers advertise (coverage must be exact
    and disjoint). ``bucket_bytes`` enables the bucketed transport and
    :meth:`RemoteSparseWorker.push_async`.

    Ids and grads may be numpy arrays, lists or tensors on any device;
    pulled rows come back as tensors on the device of the ids that asked
    for them (the CPU for numpy or list ids).

    ``compress`` ('cast16' or 'int8', or a spec dict; topk is refused:
    row pushes are sparse already) encodes the row grads of each push
    that pass the policy's size floor (``min_bytes``, 64 KiB by default);
    the ids travel raw. ``shm`` (env ``PS_SHM``) offers every connection
    the same-host shared-memory lane of ``shm_bytes`` a direction.

    Replica sets: ``"p0:a|b0:c,p1:d|b1:e"`` lists each shard's members,
    the primary first; a failed primary's shard is retried against the set
    for up to ``failover_timeout`` seconds (env ``PS_FAILOVER_TIMEOUT_MS``),
    and the cycle token makes a replayed push apply exactly once.
    :meth:`RemoteSparseWorker.read_rows` rotates its reads over each set;
    a replica's reply more than ``read_staleness`` versions (env
    ``PS_READ_STALENESS``, 0) behind the newest this worker knows of its
    shard is refused and the read goes on toward the primary.

    Elastic membership: ``coordinator="host:port"`` (env
    ``PS_COORD_URI``) in place of ``uri``: the worker finds the servers in
    the coordinator's shard table (polling until the registered members
    cover every row of every table), and a member lost with no replica
    sends it back there: a replacement that took the slot over is dialed
    without a restart. The table bootstraps the topology; each server's
    HELLO still proves it."""
    if coordinator is not None:
        addrs, replica_sets = _sparse_topology_from_coordinator(
            coordinator, worker, tables)
    elif uri is None:
        raise ValueError("connect_sparse needs a server uri or a "
                         "coordinator address")
    else:
        addrs, replica_sets = parse_replica_uri(uri)
    return RemoteSparseWorker(addrs, worker, tables,
                              bucket_bytes=bucket_bytes, pool_size=pool_size,
                              compress=compress, writev=writev, shm=shm,
                              shm_bytes=shm_bytes, replica_sets=replica_sets,
                              failover_timeout=failover_timeout,
                              read_staleness=read_staleness,
                              coordinator=coordinator)


def _sparse_topology_from_coordinator(coordinator, worker: int,
                                      tables: Dict[str, Tuple[int, int]],
                                      timeout: float = 30.0):
    """Poll the coordinator until its sparse members cover every row of
    every table of ``tables`` (a member registers one
    ``<table>@<lo>:<hi>`` key a range), then their URIs in dial order."""
    from ps_tpu_torch.elastic.member import fetch_view

    want = {name: int(total) for name, (total, _d) in tables.items()}
    deadline = time.monotonic() + timeout
    while True:
        table = fetch_view(coordinator)["table"]
        owners = _sparse_owner_shards(table, want)
        if owners:
            return parse_replica_uri(
                ",".join(table["shards"][s] for s in owners))
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"coordinator's members never covered the row partition "
                f"of {sorted(want)} within {timeout}s "
                f"({len(table['shards'])} member(s) registered)")
        time.sleep(0.05)


def _sparse_owner_shards(table: dict,
                         want: Dict[str, int]) -> Optional[List[int]]:
    """The shards serving every row of ``want``'s tables in row order
    (the order the worker's ``row_range`` and the servers' HELLO checks
    expect), or None while a row is uncovered. Keys that are not this
    fleet's ``<table>@<lo>:<hi>`` (a dense member's, on a shared
    coordinator) are skipped."""
    spans: Dict[str, List[Tuple[int, int, int]]] = {}
    for k, s in table["assign"].items():
        name, _, rng = k.partition("@")
        if name not in want or ":" not in rng:
            continue
        lo, hi = rng.split(":")
        spans.setdefault(name, []).append((int(lo), int(hi), int(s)))
    for name, total in want.items():
        pos = 0
        for lo, hi, _s in sorted(spans.get(name, [])):
            if lo > pos:
                return None  # a hole (an overlap is HELLO's to refuse)
            pos = max(pos, hi)
        if pos < total:
            return None
    # the dial order is the row order of the first table: every table is
    # split over the same members alike (HELLO checks it again)
    first = sorted(want)[0]
    owners: List[int] = []
    for _lo, _hi, s in sorted(spans.get(first, [])):
        if s not in owners:
            owners.append(s)
    return owners


class RemoteSparseWorker(BucketedTransportMixin, CheckpointRoundsMixin):
    """A worker node of the cross-process sparse PS.

    Routes global row ids to their owner servers by range, fans the
    per-server requests out concurrently (one round trip a server a
    cycle) and reassembles pulled rows in id order. ``versions()`` sums
    each table's per-server apply counters.

    Transport: ``bucket_bytes=None`` (default) sends each cycle as one
    frame a server; with it set, row pushes travel as fusion buckets
    striped over ``pool_size`` connections a server, and
    :meth:`push_async`/:meth:`flush` give non-blocking pushes. A dead
    server raises :class:`ServerFailureError` naming it, unless its
    replica set has a member to fail over to; every operation retries
    whole after a failover.

    Reads (:meth:`read_rows`) go over READ frames: the worker keeps the
    rows of the last read of each server's id-set and revalidates them
    with a conditional READ (``PS_READ_CONDITIONAL``, on), merging the
    delta or keeping them on NOT_MODIFIED. With a replica set they rotate
    over its members on channels of their own, held to
    ``read_staleness``."""

    _failure_noun = "sparse PS server"

    def __init__(self, addrs: Sequence[Tuple[str, int]], worker: int,
                 tables: Dict[str, Tuple[int, int]],
                 bucket_bytes: Optional[int] = None,
                 pool_size: Optional[int] = None,
                 compress=None, writev: Optional[bool] = None,
                 shm: Optional[bool] = None,
                 shm_bytes: Optional[int] = None,
                 replica_sets=None,
                 failover_timeout: Optional[float] = None,
                 read_staleness: Optional[int] = None,
                 coordinator=None):
        # kept, so a changed membership sends the worker back to the
        # coordinator instead of failing the job
        self._coord = coordinator
        self._init_multi(list(addrs), worker, tables,
                         bucket_bytes=bucket_bytes, pool_size=pool_size,
                         compress=compress, writev=writev, shm=shm,
                         shm_bytes=shm_bytes, replica_sets=replica_sets,
                         failover_timeout=failover_timeout,
                         read_staleness=read_staleness)

    def _init_multi(self, addrs: List[Tuple[str, int]], worker: int,
                    tables: Dict[str, Tuple[int, int]],
                    bucket_bytes: Optional[int] = None,
                    pool_size: Optional[int] = None,
                    compress=None, writev: Optional[bool] = None,
                    shm: Optional[bool] = None,
                    shm_bytes: Optional[int] = None,
                    replica_sets=None,
                    failover_timeout: Optional[float] = None,
                    read_staleness: Optional[int] = None) -> None:
        """A fresh dial and validation: ``__init__``'s body, which
        :meth:`reconnect` reruns (a failed re-dial leaves the identity
        fields for a clean retry)."""
        from ps_tpu_torch.config import env_flag, env_float
        self.worker = worker
        self._addrs = [tuple(a) for a in addrs]
        self._spec = {n: (int(v), int(d)) for n, (v, d) in tables.items()}
        n = len(self._addrs)
        self._chs: List[tv.Channel] = []
        # per table: sorted [(lo, hi, server index)]
        self._ranges: Dict[str, List[Tuple[int, int, int]]] = {
            name: [] for name in self._spec}
        self._dtype: Dict[str, np.dtype] = {}
        self._versions: Dict[str, List[int]] = {
            name: [0] * n for name in self._spec}
        # wire bytes: request payloads out, reply frames in
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.collective_bytes = 0  # no collective on the van path
        self._bytes_lock = threading.Lock()
        # the read path: the rows of the last read of each server's id-set,
        # revalidated by the next read of the same id-set; the bound in
        # seconds served ages are judged against
        self.read_conditional = env_flag("PS_READ_CONDITIONAL", True)
        self.freshness_slo = env_float("PS_FRESHNESS_SLO", 0.5, lo=1e-3)
        self._read_snaps: Dict[int, dict] = {}
        self._read_lock = threading.Lock()
        spec = resolve_spec(compress)
        if spec is not None and spec.get("codec") == "topk":
            raise ValueError(
                "topk is not a sparse-push codec: row pushes already "
                "sparsify, and per-table error-feedback residuals would "
                "mix different row sets across steps — use cast16 or int8")
        self._init_transport(bucket_bytes, pool_size, compress=spec,
                             writev=writev, shm=shm, shm_bytes=shm_bytes)
        self._init_failover(replica_sets, failover_timeout)
        self._init_read_rotation(read_staleness)
        try:
            self._connect_and_validate()
        except Exception:
            for ch in self._chs:
                ch.close()
            raise
        self._pool = None
        if n > 1:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=n)
        if self.bucket_bytes is not None:
            try:
                self._open_pumps(range(n))
            except Exception:
                self._close_transport()
                for ch in self._chs:
                    ch.close()
                raise

    def _connect_and_validate(self) -> None:
        n = len(self._addrs)
        for i in range(n):
            ch, extra = self._hello_any(i)
            host, port = self._addrs[i]
            self._chs.append(ch)
            ns = extra.get("num_shards")
            if ns is not None and int(ns) != n:
                raise ValueError(
                    f"server {i} ({host}:{port}) is shard {extra['shard']}/"
                    f"{ns} but this worker dialed {n} server(s)")
            meta = extra["tables"]
            if sorted(meta) != sorted(self._spec):
                raise ValueError(
                    f"server {i} serves tables {sorted(meta)}, worker "
                    f"expects {sorted(self._spec)}")
            for name, m in meta.items():
                total, dim = self._spec[name]
                if int(m["total_rows"]) != total or int(m["dim"]) != dim:
                    raise ValueError(
                        f"table {name!r}: server {i} says "
                        f"({m['total_rows']}, {m['dim']}), worker expects "
                        f"({total}, {dim})")
                dt = np.dtype(m["dtype"])
                if self._dtype.setdefault(name, dt) != dt:
                    raise ValueError(f"table {name!r}: servers disagree "
                                     f"on dtype")
                self._ranges[name].append((int(m["lo"]), int(m["hi"]), i))
            # seeded from the server's counters (nonzero after a restart
            # from a checkpoint)
            for name, v in extra.get("versions", {}).items():
                self._versions[name][i] = int(v)
            # validated: offer the same-host shm lane (TCP on a refusal)
            self._chs[i] = self._maybe_upgrade(ch)
        for name, ranges in self._ranges.items():
            ranges.sort()
            total = self._spec[name][0]
            pos, prev = 0, None
            for lo, hi, i in ranges:
                if hi <= lo:
                    continue
                if lo < pos:
                    raise ValueError(
                        f"table {name!r}: rows [{lo}, {min(hi, pos)}) "
                        f"claimed by both server {prev} and server {i} "
                        f"(overlapping partition)")
                if lo != pos:
                    raise ValueError(
                        f"table {name!r}: rows [{pos}, {lo}) owned by no "
                        f"server (partition has a hole)")
                pos, prev = hi, i
            if pos != total:
                raise ValueError(
                    f"table {name!r}: rows [{pos}, {total}) owned by no "
                    f"server")

    def versions(self) -> Dict[str, int]:
        """Per-table applies summed over the servers."""
        return {n: sum(v) for n, v in self._versions.items()}

    def _validate_failover_hello(self, i: int, extra: dict) -> Optional[str]:
        """A promoted replica must advertise exactly the row ranges the
        worker validated for this shard at connect time."""
        meta = extra.get("tables") or {}
        if sorted(meta) != sorted(self._spec):
            return (f"replica of server {i} serves tables {sorted(meta)}, "
                    f"worker expects {sorted(self._spec)}")
        for name, m in meta.items():
            want = next(((lo, hi) for lo, hi, s in self._ranges[name]
                         if s == i), None)
            got = (int(m["lo"]), int(m["hi"]))
            if want is not None and got != want:
                return (f"replica of server {i} owns {name!r} rows "
                        f"{got}, worker validated {want}")
            total, dim = self._spec[name]
            if int(m["total_rows"]) != total or int(m["dim"]) != dim:
                return (f"replica of server {i} disagrees on {name!r} "
                        f"shape")
            if np.dtype(m["dtype"]) != self._dtype.get(name):
                return f"replica of server {i} disagrees on {name!r} dtype"
        return None

    # -- protocol -------------------------------------------------------------

    def _request(self, i: int, payload):
        try:
            reply = request_payload(self._chs[i], payload)
        except tv.VanError as e:
            host, port = self._addrs[i]
            raise ServerFailureError(
                f"sparse PS server {i} ({host}:{port}) failed mid-job: {e}",
                server=i) from e
        with self._bytes_lock:
            self.bytes_pushed += payload_nbytes(payload)
            self.bytes_pulled += len(reply)
        return reply

    def _fanout(self, payloads: Dict[int, Any]) -> Dict[int, memoryview]:
        """One concurrent round. Every future is waited for before an
        error propagates: a request still running would otherwise drive a
        channel that a later call drives too."""
        if self._pool is None or len(payloads) == 1:
            return {i: self._request(i, p) for i, p in payloads.items()}
        import concurrent.futures

        futs = {i: self._pool.submit(self._request, i, p)
                for i, p in payloads.items()}
        concurrent.futures.wait(futs.values())
        return {i: f.result() for i, f in futs.items()}

    def _route(self, name: str, ids: np.ndarray) -> Dict[int, np.ndarray]:
        """``{server: positions into ids}`` for the table's range split."""
        out: Dict[int, np.ndarray] = {}
        for lo, hi, i in self._ranges[name]:
            pos = np.nonzero((ids >= lo) & (ids < hi))[0]
            if pos.size:
                out[i] = pos
        covered = sum(p.size for p in out.values())
        if covered != ids.size:
            bad = ids[(ids < 0) | (ids >= self._spec[name][0])]
            raise IndexError(
                f"table {name!r}: ids out of range, e.g. {bad[:3]}")
        return out

    def _check(self, i: int, msg):
        kind, _, tensors, extra = tv.decode(msg)
        if kind != tv.OK:
            raise self._reply_error(i, extra)
        for name, v in extra.get("versions", {}).items():
            self._versions[name][i] = int(v)
        return tensors

    def _host_ids(self, requests: Dict[str, Any]):
        """``{table: ids}`` of any kind -> ``{table: [N] int32 numpy}`` (a
        CUDA tensor through pinned memory) and ``{table: device}`` the
        pulled rows go back to."""
        devices = {n: (ids.device if isinstance(ids, torch.Tensor)
                       else torch.device("cpu"))
                   for n, ids in requests.items()}
        host = stage_to_host(dict(requests), stats=self.transport)
        return ({n: np.asarray(v, np.int32).reshape(-1)
                 for n, v in host.items()}, devices)

    def _on_devices(self, rows: Dict[str, np.ndarray], devices
                    ) -> Dict[str, torch.Tensor]:
        """Assembled host rows -> tensors on each request's device (the
        copies onto the card waited for)."""
        out: Dict[str, torch.Tensor] = {}
        for dev in set(devices.values()):
            mine = {n: r for n, r in rows.items() if devices[n] == dev}
            if dev.type == "cuda":
                out.update(stage_to_device(mine, dev, stats=self.transport))
            else:  # the assembled rows are this call's own arrays
                out.update({n: torch.from_numpy(r) for n, r in mine.items()})
        return out

    def pull(self, requests: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``{table: global ids [N]} -> {table: rows [N, dim]}``: one
        concurrent round over the owners, rows in id order, on the ids'
        device."""
        if self._pending_cycles:
            self.flush()  # a pull must not overtake an in-flight push
        with self._op("pull") as sp:
            ids, devices = self._host_ids(requests)
            reqs, routes = self._build_pull(ids)
            extra = self._tc_extra(None, sp)

            def once():
                msgs = self._fanout({
                    i: tv.encode(tv.ROW_PULL, self.worker, t, extra=extra)
                    for i, t in reqs.items()})
                return self._merge_rows(ids, routes, msgs)

            return self._on_devices(self._with_failover(once), devices)

    def read_rows(self, requests: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A side-effect-free row read: :meth:`pull` over READ frames (no
        pull event at the server, worker id 0), so byte-identical hot
        id-sets are answered from a server's native read cache, and a
        backup may answer within ``read_staleness``. It does not wait for
        in-flight pushes: it sees what is committed when it lands.

        With ``PS_READ_CONDITIONAL`` (on) a read of an id-set this worker
        read last time from that server is conditional: it names the
        versions of the rows in hand, an unchanged server answers
        NOT_MODIFIED and a changed one ships only the rows whose change
        stamp moved, merged into the held rows. Rows come back on the
        ids' device, as :meth:`pull`'s do."""
        with self._op("read"):
            ids, devices = self._host_ids(requests)
            reqs, routes = self._build_pull(ids)

            def once():
                payloads, snaps = {}, {}
                for i, t in reqs.items():
                    snap = None
                    if self.read_conditional:
                        with self._read_lock:
                            cand = self._read_snaps.get(i)
                        if cand is not None and cand["sig"] == \
                                self._read_sig(t):
                            snap = cand
                    if snap is not None:
                        # "cond" last: the native loop finds the version
                        # floor by its last occurrence in the request's tail
                        conds = {n: int(v) for n, v in snap["conds"].items()}
                        payloads[i] = tv.encode(
                            tv.READ, 0, t,
                            extra={"conds": conds,
                                   "cond": int(sum(conds.values()))})
                    else:
                        payloads[i] = tv.encode(tv.READ, 0, t)
                    snaps[i] = snap
                got = self._read_fanout(payloads, snaps)
                tensors = {i: self._revalidate(i, reqs[i], snaps[i], *r)
                           for i, r in got.items()}
                return self._assemble_rows(ids, routes, tensors)

            return self._on_devices(self._with_failover(once), devices)

    def _read_fanout(self, payloads: Dict[int, Any], snaps: Dict[int, Any]
                     ) -> Dict[int, tuple]:
        """One concurrent round of READs: ``{server: (kind, tensors, extra,
        tier)}``. A server without replicas is read on its channel; a
        replica set is read by :meth:`_read_replicas`."""
        def one(i):
            if len(self._replica_sets[i]) <= 1:
                kind, _, tensors, extra = tv.decode(
                    self._request(i, payloads[i]))
                return kind, tensors, extra, "wire"
            return self._read_replicas(i, payloads[i], snaps[i])

        if self._pool is None or len(payloads) == 1:
            return {i: one(i) for i in payloads}
        import concurrent.futures

        futs = {i: self._pool.submit(one, i) for i in payloads}
        concurrent.futures.wait(futs.values())
        return {i: f.result() for i, f in futs.items()}

    def _read_known(self, i: int) -> int:
        """The newest version this worker has seen of server ``i``: its
        table versions summed, as a READ reply's ``version``."""
        return sum(v[i] for v in self._versions.values())

    def _read_replicas(self, i: int, payload, snap) -> tuple:
        """One READ of server ``i`` over its replica set
        (:meth:`_read_rotate`). A replica's NOT_MODIFIED is judged at the
        replica's own version: one that never saw the held rows' version
        cannot vouch for them."""
        def judge(reply, kind, extra):
            with self._bytes_lock:
                self.bytes_pushed += payload_nbytes(payload)
                self.bytes_pulled += len(reply)
            if kind == tv.OK or (kind == tv.NOT_MODIFIED and snap is not None):
                return int(extra["version"])
            return None

        kind, tensors, extra, _, replica = self._read_rotate(i, payload,
                                                             judge)
        return kind, tensors, extra, "replica" if replica else "wire"

    def _note_rows_age(self, extra: dict, req, tier: str) -> None:
        """One age sample a table this reply served (``now - birth`` from
        the reply's per-table stamps). No clock offset rides the sparse
        worker, so an age across processes is a wall-clock difference,
        tagged so, and clamped when negative."""
        for key in req:
            b = freshness.from_extra(extra, table=key[: -len("/ids")])
            if b is None:
                continue
            age, src, clamped = freshness.age_of(b)
            self.transport.record_read_age(age, src=src, tier=tier,
                                           bound=self.freshness_slo,
                                           clamped=clamped)

    @staticmethod
    def _read_sig(req: Dict[str, np.ndarray]) -> tuple:
        """The identity of one server's id-set: held rows revalidate only
        the exact request they were read for."""
        return tuple(sorted(
            (k, np.asarray(v).tobytes()) for k, v in req.items()))

    def _revalidate(self, i: int, req, snap, kind, tensors, extra,
                    tier: str = "wire") -> Dict[str, np.ndarray]:
        """One server's READ reply -> its rows (arrays of their own):
        NOT_MODIFIED keeps the held rows, a delta is merged into a copy of
        them (a reader of the old rows never sees a torn merge), a full
        reply replaces them. The rows are held for the next read of the
        same id-set. Versions only move forward: a replica may answer
        behind what this worker knows."""
        if kind == tv.NOT_MODIFIED and snap is not None:
            for name, v in (extra.get("versions") or {}).items():
                self._versions[name][i] = max(self._versions[name][i], int(v))
            # the stamp's births describe the rows held: a revalidation
            # refreshes their age
            self._note_rows_age(extra, req, "nm")
            return snap["tensors"]
        if kind != tv.OK:
            raise self._reply_error(i, extra)
        versions = extra.get("versions") or {}
        for name, v in versions.items():
            self._versions[name][i] = max(self._versions[name][i], int(v))
        self._note_rows_age(extra, req, tier)
        out: Dict[str, np.ndarray] = {}
        if extra.get("delta") and snap is not None:
            for key in req:
                name = key[: -len("/ids")]
                rk, dk = f"{name}/rows", f"{name}/dids"
                if dk in tensors:
                    ids = np.asarray(req[key], np.int64)
                    dids = np.asarray(tensors[dk])  # unique, ascending
                    drows = np.asarray(tensors[f"{name}/drows"])
                    rows = np.array(snap["tensors"][rk])
                    pos = np.nonzero(np.isin(ids, dids))[0]
                    rows[pos] = drows[np.searchsorted(dids, ids[pos])]
                    out[rk] = rows
                elif rk in tensors:
                    out[rk] = np.array(tensors[rk])
                else:  # the table did not move since its cond
                    out[rk] = snap["tensors"][rk]
        else:
            out = {k: np.array(v) for k, v in tensors.items()}
        if self.read_conditional:
            conds = {}
            for key in req:
                name = key[: -len("/ids")]
                v = versions.get(name)
                if v is None or f"{name}/rows" not in out:
                    conds = None
                    break
                conds[name] = int(v)
            if conds is not None:
                with self._read_lock:
                    self._read_snaps[i] = {
                        "sig": self._read_sig(req),
                        "conds": conds, "tensors": out,
                    }
        return out

    def _build_pull(self, ids: Dict[str, np.ndarray]):
        reqs: Dict[int, Dict[str, np.ndarray]] = {}
        routes: Dict[str, Dict[int, np.ndarray]] = {}
        for name, x in ids.items():
            routes[name] = self._route(name, x)
            for i, pos in routes[name].items():
                reqs.setdefault(i, {})[f"{name}/ids"] = x[pos]
        return reqs, routes

    def _merge_rows(self, ids, routes, msgs) -> Dict[str, np.ndarray]:
        tensors = {i: self._check(i, m) for i, m in msgs.items()}
        return self._assemble_rows(ids, routes, tensors)

    def _assemble_rows(self, ids, routes, tensors) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for name, per_server in routes.items():
            rows = np.zeros((ids[name].shape[0], self._spec[name][1]),
                            self._dtype[name])
            for i, pos in per_server.items():
                rows[pos] = np.asarray(tensors[i][f"{name}/rows"])
            out[name] = rows
        return out

    def _build_push(self, pushes: Dict[str, Tuple[Any, Any]], dedupe: bool
                    ) -> Dict[int, Dict[str, np.ndarray]]:
        """Per-server ``{"<table>/ids", "<table>/grads"}`` payloads: the
        ids and grads on the host (CUDA tensors through pinned memory),
        the optional worker-side dedupe, then the range routing. The
        payload never aliases the caller's arrays."""
        flat = {}
        for name, (ids, grads) in pushes.items():
            flat[f"{name}/ids"], flat[f"{name}/grads"] = ids, grads
        host = stage_to_host(flat, stats=self.transport)
        reqs: Dict[int, Dict[str, np.ndarray]] = {}
        for name in pushes:
            ids = np.asarray(host[f"{name}/ids"], np.int32).reshape(-1)
            grads = np.asarray(host[f"{name}/grads"]).reshape(
                ids.shape[0], self._spec[name][1])
            if dedupe:
                ids, grads = dedupe_rows_np(ids, grads)
            for i, pos in self._route(name, ids).items():
                reqs.setdefault(i, {})[f"{name}/ids"] = ids[pos]
                reqs[i][f"{name}/grads"] = grads[pos]
        return reqs

    def push(self, pushes: Dict[str, Tuple[Any, Any]],
             dedupe: bool = True) -> None:
        """``{table: (global ids [N], row grads [N, dim])}``: the owners
        apply at once (async semantics). ``dedupe`` merges duplicate rows
        here first, shrinking the payload (the servers sum duplicates
        either way). With ``bucket_bytes`` each server's payload travels
        as fusion buckets; the server applies it as one unit either
        way."""
        with self._op("push") as sp:
            tc = sp.wire()
            reqs = self._build_push(pushes, dedupe)
            pseq, pfan = self._next_push_seq(), sorted(reqs)
            if self.bucket_bytes is not None:
                self.flush()  # keep per-worker push order == epoch order
                self._with_failover(lambda: self._push_buckets_sync(
                    reqs, pseq=pseq, pfan=pfan, tc=tc))
                return

            def once():
                msgs = self._fanout({
                    i: self._encode_serial_push(tv.ROW_PUSH, t, pseq=pseq,
                                                pfan=pfan, tc=tc)
                    for i, t in reqs.items()})
                for i, m in msgs.items():
                    self._check(i, m)

            self._with_failover(once)

    def _encode_serial_push(self, kind: int, t: Dict[str, np.ndarray],
                            pseq: Optional[int] = None,
                            pfan: Optional[List[int]] = None, tc=None):
        """One serial row-push frame, its grads compressed by the policy,
        tagged with the (nonce, cycle seq, fanout) token (the dedup key,
        and what the checkpoint's drain round compares across shards) and
        the op's trace context when sampled. Zero-copy parts with
        ``writev``."""
        t, enc = self._encode_push_tree(t)
        extra = {}
        if enc:
            extra["enc"] = enc
        if pseq is not None:
            extra.update({"pseq": pseq, "pnonce": self._transport_nonce,
                          "pfan": pfan})
        if tc is not None:
            extra[obs.WIRE_KEY] = tc
        extra = extra or None
        if self.writev:
            return tv.encode_parts(kind, self.worker, t, extra)
        return tv.encode(kind, self.worker, t, extra)

    # -- bucketed, non-blocking push -------------------------------------------

    def _push_buckets_sync(self, reqs: Dict[int, Dict[str, np.ndarray]],
                           pseq: Optional[int] = None,
                           pfan: Optional[List[int]] = None,
                           tc=None) -> None:
        """Stripe each server's payload over the pool as byte-sliced
        fusion buckets, every bucket tagged with the push's cycle token
        (and trace context when sampled); the completing bucket's reply
        carries the committed versions."""
        self._push_epoch += 1
        epoch = self._push_epoch
        futs: List[Tuple[int, Any]] = []
        for i, t in reqs.items():
            # the codec pass first (grads compress; the int32 ids pass the
            # policy's dtype gate untouched)
            t, enc = self._encode_push_tree(t)
            t = {k: np.ascontiguousarray(v) for k, v in t.items()}
            plan = BucketPlan.from_arrays(t, self.bucket_bytes)
            pumps = self._pumps[i]
            enc_bucket = plan.bucket_encoder(self.writev)
            for b in range(plan.nbuckets):
                extra = {"epoch": epoch, "nonce": self._transport_nonce,
                         "pseq": pseq, "pnonce": self._transport_nonce,
                         "pfan": pfan, "enc": enc}
                if tc is not None:
                    extra[obs.WIRE_KEY] = tc
                payload = enc_bucket(tv.ROW_BUCKET_PUSH, self.worker, t, b,
                                     extra=extra)
                futs.append((i, pumps[b % len(pumps)].submit(
                    payload, priority=self._bucket_submit_priority(b))))
        for i, fut in futs:
            reply = self._bucket_reply(i, fut)
            try:
                self._check(i, reply)
            finally:
                self._release_frame(reply)  # even when _check raises

    def push_async(self, pushes: Dict[str, Tuple[Any, Any]],
                   dedupe: bool = True) -> PendingCycle:
        """Non-blocking :meth:`push`: the payloads are built now (the
        caller may change its arrays afterwards), then a background sender
        drains the buckets while the caller computes. :meth:`flush` (or
        ``handle.wait()``) restores synchronous semantics; per-worker push
        order is kept either way."""
        if self.bucket_bytes is None:
            raise RuntimeError(
                "push_async needs the bucketed transport — construct the "
                "worker with bucket_bytes=... (e.g. 4 << 20)")
        reqs = self._build_push(pushes, dedupe)
        pseq, pfan = self._next_push_seq(), sorted(reqs)
        pending = PendingCycle(self.transport)
        self._track_pending(pending)

        def run():
            t0 = time.perf_counter()
            try:
                with self._op("cycle", pseq=pseq) as sp:
                    tc = sp.wire()
                    self._with_failover(lambda: self._push_buckets_sync(
                        reqs, pseq=pseq, pfan=pfan, tc=tc))
            except BaseException as e:
                pending._fail(e)
            else:
                pending._resolve(None)
            finally:
                self.transport.record_cycle(time.perf_counter() - t0)

        self._bg_executor().submit(run)
        return pending

    def push_pull(self, pushes: Dict[str, Tuple[Any, Any]],
                  requests: Dict[str, Any],
                  dedupe: bool = True) -> Dict[str, torch.Tensor]:
        """Push this cycle's row grads and pull the next cycle's rows in
        one round trip a server (the sparse async cycle); the rows are
        the ones after this push."""
        if self._pending_cycles:
            self.flush()  # a cycle must not overtake an in-flight push
        with self._op("push_pull") as sp:
            tc = sp.wire()
            reqs = self._build_push(pushes, dedupe)
            # the cycle's fanout is the servers receiving grads: a
            # pull-only message must not count toward the drain round
            pseq, pfan = self._next_push_seq(), sorted(reqs)
            ids, devices = self._host_ids(requests)
            pull_reqs, routes = self._build_pull(ids)
            for i, t in pull_reqs.items():
                for name_ids, v in t.items():
                    name = name_ids.split("/")[0]
                    reqs.setdefault(i, {})[f"{name}/pull_ids"] = v
            def once():
                msgs = self._fanout({
                    i: self._encode_serial_push(tv.ROW_PUSH_PULL, t,
                                                pseq=pseq, pfan=pfan, tc=tc)
                    for i, t in reqs.items()})
                return self._merge_rows(ids, routes, msgs)

            return self._on_devices(self._with_failover(once), devices)

    # -- checkpoint, reconnect, stats -------------------------------------------

    def checkpoint_all(self, path: str) -> Dict[str, int]:
        """A coordinated, cross-shard-atomic checkpoint, keyed by cycle
        seq: **pause** (every server blocks new applies and reports each
        worker's last applied (nonce, seq, fanout)), **drain_to** (every
        shard in the newest cycle's fanout admits the in-flight sub-pushes
        needed to reach it), **save** (each server writes its tables under
        ``path``, ``path/shard<i>/<table>`` when partitioned), **resume**.
        A push is on every shard it addressed, or on none. Returns the
        per-table versions summed over the servers at the snapshot. A
        failed round still resumes the servers it paused. Restart: each
        server inits its range-sliced tables, restores each from its shard
        directory and serves again; workers :meth:`reconnect`."""
        tokens: Dict[int, dict] = {}
        try:
            try:
                paused = self._checkpoint_round({"dir": path,
                                                 "phase": "pause"})
            except CheckpointRoundError as e:
                tokens = self._ckpt_tokens(e.oks)
                raise
            tokens = self._ckpt_tokens(paused)
            drain = self._drain_targets_from_pause(paused)
            if drain:
                per_server = {
                    i: dict(tokens.get(i, {}), targets=drain.get(i, {}))
                    for i in range(len(self._chs))}
                self._checkpoint_round({"dir": path, "phase": "drain_to",
                                        "timeout": DRAIN_TO_TIMEOUT_S},
                                       per_server=per_server)
            saves = self._checkpoint_round({"dir": path, "phase": "save"},
                                           per_server=tokens)
        except BaseException:
            try:
                self._checkpoint_round({"dir": path, "phase": "resume"},
                                       per_server=tokens)
            except Exception:
                pass  # the original failure names the culprit
            raise
        self._checkpoint_round({"dir": path, "phase": "resume"},
                               per_server=tokens)
        totals: Dict[str, int] = {n: 0 for n in self._spec}
        for extra in saves.values():
            for n, v in extra["versions"].items():
                totals[n] += int(v)
        return totals

    def _drain_targets_from_pause(self, paused: Dict[int, dict]
                                  ) -> Dict[int, Dict[int, list]]:
        """The cross-shard max by cycle seq: from each shard's report of
        per-worker (nonce, seq, fanout), each worker's newest applied
        cycle, and per shard ``{worker: [nonce, seq]}`` for the shards in
        that cycle's fanout that still lag it (empty: no drain round). A
        worker whose nonce differs across shards reconnected mid-round and
        is skipped: its in-flight cycle died with the old connections."""
        per_shard: Dict[int, dict] = {
            i: extra.get("applied_pseq", {}) for i, extra in paused.items()}
        nonces: Dict[int, str] = {}
        best: Dict[int, tuple] = {}  # worker -> (seq, fanout)
        skip = set()
        for table in per_shard.values():
            for w_s, rec in table.items():
                w, nonce, seq = int(w_s), rec[0], int(rec[1])
                if w in nonces and nonces[w] != nonce:
                    skip.add(w)
                    continue
                nonces[w] = nonce
                if w not in best or seq > best[w][0]:
                    best[w] = (seq, [int(x) for x in (rec[2] or [])])
        targets: Dict[int, Dict[int, list]] = {}
        for i in per_shard:
            t: Dict[int, list] = {}
            for w, (seq, fan) in best.items():
                if w in skip or i not in fan:
                    continue
                rec = per_shard[i].get(str(w))
                applied = (int(rec[1]) if rec is not None
                           and rec[0] == nonces[w] else 0)
                if applied < seq:
                    t[w] = [nonces[w], seq]
            if t:
                targets[i] = t
        return targets

    def reconnect(self, addrs: Optional[Sequence[Tuple[str, int]]] = None
                  ) -> None:
        """Dial every server again (at new addresses when given: restarted
        servers come back on new ports) and revalidate the row partition.
        The wire counters, the transport stats and the push epoch stream
        survive, a failed re-dial included (retry it)."""
        try:
            self.flush()  # land (or fail fast) in-flight background pushes
        except Exception:
            pass  # a dead server is why we reconnect
        obs.record_event("reconnect", worker=self.worker,
                         servers=len(self._addrs),
                         new_addrs=addrs is not None)
        saved = self._saved_transport_state()
        self._close_transport()
        self._close_read_channels()
        for ch in self._chs:
            ch.close()  # dead or stale; no SHUTDOWN owed
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        try:
            self._init_multi(
                list(addrs) if addrs is not None else self._addrs,
                self.worker, dict(self._spec),
                bucket_bytes=self.bucket_bytes, pool_size=self.pool_size,
                compress=self.compress, writev=self.writev, shm=self.shm,
                shm_bytes=self.shm_bytes,
                replica_sets=None if addrs is not None
                else self._replica_sets,
                failover_timeout=self.failover_timeout,
                read_staleness=self.read_staleness)
        finally:
            self._restore_transport_state(saved)

    def _on_table_moved(self, err, deadline: float) -> None:
        """Find the fleet in the coordinator's table again and re-dial.
        Sparse ranges never move live, so this runs when membership
        changed: a dead member whose slot a replacement took over
        (through :meth:`_on_server_lost`). It polls within the failover
        deadline (the replacement may still be registering); the re-dial
        checks the whole row partition again.

        The re-dial keeps the dedup nonce and the push seq, as the dense
        worker's table re-route does: the op that failed replays right
        after this under its original token, so a surviving shard that
        applied its part acks the replay unapplied (the reference's sparse
        worker re-dials as a new incarnation here, and such a push would
        apply twice there)."""
        if self._coord is None:
            super()._on_table_moved(err, deadline)  # raises
        nonce, push_seq = self._transport_nonce, self._push_seq
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise err
            try:
                addrs, replica_sets = _sparse_topology_from_coordinator(
                    self._coord, self.worker, dict(self._spec),
                    timeout=min(budget, 30.0))
                self.reconnect(addrs)
            except (tv.VanError, OSError, TimeoutError,
                    ServerFailureError, RuntimeError):
                # the table may still name the dead member
                time.sleep(0.2)
                continue
            finally:
                self._transport_nonce, self._push_seq = nonce, push_seq
            self._replica_sets = replica_sets
            self.transport.record_table_reroute()
            obs.record_event("table_reroute", worker=self.worker,
                             shards=len(addrs), fleet="sparse")
            return

    def _on_server_lost(self, err, deadline: float) -> None:
        """A member died with no replica to cycle to: with a coordinator a
        replacement may hold its rows already (find it and re-dial);
        without one the death surfaces."""
        if self._coord is None:
            raise err
        self._on_table_moved(err, deadline)

    def stats(self) -> dict:
        """One server: its STATS dict. Several: ``{"servers": [...],
        "versions": per-table totals}``."""
        msgs = self._fanout({i: tv.encode(tv.STATS, self.worker, None)
                             for i in range(len(self._chs))})
        extras = {i: tv.decode(m)[3] for i, m in msgs.items()}
        if len(self._chs) == 1:
            return extras[0]
        return {"servers": [extras.get(i) for i in range(len(self._chs))],
                "versions": self.versions()}

    def close(self) -> None:
        try:
            if self._pending_cycles:
                self.flush()  # land in-flight pushes before the goodbyes
        except Exception:
            pass  # a dead server must not block the teardown
        self._close_read_channels()
        self._close_transport()  # pool channels hang up without a goodbye
        for ch in self._chs:
            try:
                ch.request(tv.encode(tv.SHUTDOWN, self.worker, None))
            except tv.VanError:
                pass
            ch.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
