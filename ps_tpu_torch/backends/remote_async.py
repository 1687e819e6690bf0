"""Cross-process async PS: N server processes, workers elsewhere.

Counterpart of ``ps_tpu/backends/remote_async.py``: the reference's async
deployment shape, with the server and each worker in separate,
unsynchronized processes that exchange tensors over the native van's TCP
layer.

- Each SERVER process owns the key range :func:`~ps_tpu_torch.kv.keys.
  shard_for_key` assigns it (all keys with one server) as an async
  ``KVStore`` (``AsyncCudaServer``: parameters and per-key state on its
  device, DC-ASGD applies, a tree-granularity version over its range) and
  serves it (:class:`AsyncPSService`). :func:`shard_tree` carves the owned
  subtree out of the full model.
- Each WORKER process runs :class:`RemoteAsyncWorker`: pull the params
  from every owner, take gradients on its own device, push each owner its
  subtree; one concurrent ``PUSH_PULL`` round a cycle. Staleness is real
  and tracked per server. A dead server surfaces as a typed
  :class:`ServerFailureError`.
- Replication (``replica/``): a server made with ``backup=True`` follows
  its primary's stream of committed pushes and pulls (the DC apply depends
  on what each worker last pulled) through its own ``AsyncCudaServer``
  and refuses workers until promoted; the primary calls
  ``svc.attach_backup(host, port, ack=...)`` before admitting workers. A
  worker given ``"p0:a|b0:c,..."`` replica sets re-routes a failed shard
  to the next member, waits out the promotion, and replays its in-flight
  push, which its (nonce, seq) token makes apply exactly once.
  ``RESEED`` (a primary told to seed a spare) ships the whole state point
  in one ``REPLICA_SEED`` frame and attaches the spare as its backup.

Tensors cross the van as numpy views of host memory. A CUDA tensor is
first copied to pinned host memory and the copy waited for before the
send (``stage_to_host``); a received tensor for the card is copied there
and waited for before its frame's buffer is reused (``stage_to_device``).
The frames are the reference's, so a port worker talks to a reference
server and a reference worker to a port server.

Parity: each server records its apply order (``event_log``); replaying
that (worker, grads) sequence through a one-process ``AsyncCudaServer``
per key range gives bitwise the same parameters.

The van's transport options are the reference's: the server may serve
through the native epoll loop with native push admission
(``native_loop=True``), a worker may move its frames through the
same-host shared-memory lane (``shm=True``), and a worker's pushes, and
its bucketed pulls on request, may travel codec-compressed
(``compress='cast16'|'int8'|'topk'``, ``compress/``), decoded by the
server before the apply.

A store across ranks (``AsyncCudaServer`` over a mesh of k processes)
is served by every rank calling :func:`serve_async`: rank 0 runs the
service, and each call it makes of the engine goes first to the other
ranks as one op of its op stream (``backends/op_stream.py``), which they
run in the same order, so PUSH, PULL, READ, CHECKPOINT, the key moves and
the re-seeds all serve a multi-rank engine. Workers see one
``host:port``.

The read path: a ``READ`` is a side-effect-free pull (no event-log record,
no replication entry, no DC snapshot) whose reply is a pure function of
committed state, stamped with the version and the birth of the last
apply (``obs/freshness.py``), so the native loop can cache it; a
``READ`` carrying ``{"cond": v}`` at the current version gets a
NOT_MODIFIED stamp instead. A backup answers READs too. The worker's
:meth:`RemoteAsyncWorker.read_all` spreads reads over each shard's
replica set within a staleness bound of ``read_staleness`` versions,
coalesces concurrent reads of a shard into one fetch, and with
``pull_cache=True`` keeps the last snapshot until its version watcher
sees the shard move, then revalidates it with a conditional READ.

Two-level aggregation (``backends/aggregator.py``): a worker given
``aggregator=`` dials its host group's aggregator instead of the shards
and degrades to the flat path if it dies; a server records a merged
push's ``members`` tokens beside the aggregator's own, replicates them,
and acks a merged push whose members all settled on their own as a
replay (a partial overlap is refused).

Observability (``obs/``): each worker op is a span (sampled at
``trace_sample``) whose context rides every frame of the op under
``"tc"``, and the server's apply is a ``server_apply`` child of its serve
span (naming a merged push's ``members_tc``); a cycle's caller wait is a
``flush_wait`` span. Re-seeds, aggregator degrades and failovers are
flight events.

Elastic membership (``elastic/``): a server given ``coordinator=``
registers its key range with the coordinator's shard table, reports its
load and telemetry, and moves key ranges to another shard live on the
coordinator's ``MIGRATE_OUT``: a snapshot of the rows (parameter,
optimizer state under the reference's leaf paths, every worker's stale
snapshot, the apply count) streamed to the recipient, the rows that
commits touch re-streamed while traffic flows, then a bounded
stop-and-copy cutover under the engine lock that carries the moved keys'
dedup tokens, so a replayed pre-move push is acked at the recipient
unapplied. A push for keys that moved away is refused ``moved`` with the
table epoch; a worker given ``coordinator=`` fetches the table then and
re-routes (a ``table_reroute`` flight event), and a replay owed only
some of its keys applies (and replicates as ``push_sub``) exactly those.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ps_tpu_torch.backends.common import (
    DEFAULT_BUCKET_BYTES,
    DRAIN_TO_TIMEOUT_S,
    BucketAssembler,
    BucketedTransportMixin,
    BucketPlan,
    ServerFailureError,
    TableMovedError,
    parse_replica_uri,
    payload_nbytes,
    request_payload,
    stage_to_device,
    stage_to_host,
)
from ps_tpu_torch.compress import CompressPolicy, GradCompressor, decode_tree
from ps_tpu_torch.backends.op_stream import OpStream, RankLostError
from ps_tpu_torch.backends.van_service import (
    StaleTableError,
    VanService,
    log_tail,
    make_history_log,
    resolve_ckpt_dir,
)
from ps_tpu_torch import obs
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.obs import freshness
from ps_tpu_torch.utils.metrics import TransportStats

__all__ = [
    "AsyncPSService", "RemoteAsyncWorker", "ServerFailureError",
    "serve_async", "connect_async", "shard_tree", "PendingCycle",
    "CheckpointRoundError", "TableMovedError",
]


def shard_tree(params_like, shard: int, num_shards: int) -> Dict[str, Any]:
    """The flat ``{key: leaf}`` subtree that server ``shard`` of
    ``num_shards`` owns under the ``shard_for_key`` hash partition (a flat
    dict of key strings flattens to the same keys, so a server passes it
    straight to ``KVStore.init``)."""
    kv, _ = keymod.flatten_with_keys(params_like)
    return {k: v for k, v in kv.items()
            if keymod.shard_for_key(k, num_shards) == shard}


class AsyncPSService(VanService):
    """Serve an async KVStore to remote workers over the tensor van: HELLO,
    PULL, PUSH, PUSH_PULL, STATS, SHUTDOWN, BUCKET_PUSH, BUCKET_PULL and
    CHECKPOINT over the async engine.

    Args:
      store: an initialized async-mode KVStore (the server engine).
      port: TCP port (0 = ephemeral; read :attr:`port`).
      bind: listen address; loopback by default (the endpoint is
        unauthenticated: "0.0.0.0" is an explicit opt-in).
      shard/num_shards: this server's place in an N-server key partition
        (None = one server). The store's keys are checked against
        ``shard_for_key`` here and advertised in the HELLO reply, so a
        misconfigured topology fails at connect time.
      ckpt_root: confine CHECKPOINT saves under this server-side root.
      record_full_history: keep every event-log entry (replay parity);
        by default the logs are rings of ``history`` entries.
      coordinator: ``"host:port"`` of an elastic-membership coordinator
        (in place of ``shard``/``num_shards``): the service registers
        its keys there as ``advertise_host:port`` once it listens (a
        backup joins only through its primary's replica set), and its
        key range may then move.
      ops: rank 0's :class:`~ps_tpu_torch.backends.op_stream.OpStream`
        for a store across ranks (required there; ``OpStream.over(store)``
        on every rank makes it, as :func:`serve_async` does).

    The pull and read paths lean on the engine's out-of-place applies: a
    snapshot taken under the engine lock is a set of tensors no later
    apply writes into, so it is copied off the card and sent outside the
    lock while other workers apply. An in-place apply would tear them.
    """

    def __init__(self, store, port: int = 0, bind: str = "127.0.0.1",
                 shard: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 ckpt_root: Optional[str] = None,
                 writev: Optional[bool] = None,
                 shm: Optional[bool] = None,
                 backup: bool = False,
                 record_full_history: bool = False,
                 history: int = 4096,
                 coordinator=None,
                 advertise_host: str = "127.0.0.1",
                 native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None,
                 ops=None):
        engine = store._engine
        if getattr(engine, "mode", "sync") != "async":
            raise ValueError("AsyncPSService requires an async-mode KVStore")
        mesh = getattr(engine, "mesh", None)
        if (mesh is not None and mesh.world_size > 1
                and (ops is None or not ops.leader)):
            raise ValueError(
                "a store across ranks is served by serve_async(store, ...) "
                "on every rank: rank 0 serves, the others follow its op "
                "stream")
        # the op stream of a store across ranks: every engine call below
        # is sent to the other ranks first (_op), under the engine lock
        self._ops = ops
        if ops is not None:
            ops.on_failure = self._rank_lost
        if (shard is None) != (num_shards is None):
            raise ValueError("pass shard and num_shards together")
        if coordinator is not None and num_shards is not None:
            raise ValueError(
                "pass either shard/num_shards (static hash topology) or "
                "coordinator (elastic membership), not both — under a "
                "coordinator the shard table owns the assignment")
        self.shard, self.num_shards = shard, num_shards
        self._store = store
        self._engine = engine
        self._device = torch.device(engine.device)
        # the birth stamp of the servable version (obs/freshness.py),
        # stamped under the engine lock at every apply and carried by every
        # READ reply as committed state (never a serve-time clock, which
        # would break the byte-deterministic replies the native cache
        # serves). Never-applied state has none: two services over the
        # same state encode the same replies
        self._birth: Optional[dict] = None
        self._key_order = list(store._key_order)
        if num_shards is not None:
            misplaced = [k for k in self._key_order
                         if keymod.shard_for_key(k, num_shards) != shard]
            if misplaced:
                raise ValueError(
                    f"store holds keys not owned by shard {shard}/"
                    f"{num_shards}: {misplaced[:3]} — init the server's "
                    f"store with shard_tree(params, shard, num_shards)")
        # set under the engine lock by _set_draining(), checked under it by
        # the push path: no push is applied after stop() returns
        self._draining = False
        # checkpoint pause: pushes block (not refuse), but for the ones a
        # drain_to round admits (see _checkpoint)
        self._paused = False
        self._pause_cond = threading.Condition(engine._lock)
        self._ckpt_root = ckpt_root
        # bucketed pull snapshots: worker -> one pulled tree awaiting its
        # remaining bucket requests
        self._pull_cache: Dict[int, dict] = {}
        self._applied: Dict[int, int] = {}   # per-worker applied pushes
        self._drain_targets: Dict[int, int] = {}
        # exactly-once under replay: worker -> {key: (nonce, seq)} of the
        # last applied dedup-tagged push, per key as the reference keeps it
        self._applied_pseq: Dict[int, Dict[str, tuple]] = {}
        self._log_lock = threading.Lock()
        # worker id per committed tree, and the ordered (op, worker)
        # history: "pull" records matter, the DC apply depends on what
        # each worker last pulled; replaying it reproduces the params
        self.apply_log = make_history_log(record_full_history, history)
        self.event_log = make_history_log(record_full_history, history)
        # elastic membership: ``_elastic`` turns a push's key mismatch
        # from a KeyError into the retryable 'moved' refusal (set by a
        # coordinator, or by this shard's first committed move);
        # ``_migrating`` is the double-write set of an outbound move,
        # ``_moved_keys`` what left (and at which table epoch),
        # ``_migrate_in`` an inbound move's staged rows until its commit;
        # the last commit of either side is kept so a re-asked
        # MIGRATE_OUT or MIGRATE_COMMIT (its reply lost) acks again.
        # ``elastic_log`` records each change of the served key set and
        # each partial apply at its place in the event log (``at``), so a
        # replay can follow every key across shards
        self._elastic = coordinator is not None
        self._coordinator = coordinator
        self._coord_member = None
        self._migrating: frozenset = frozenset()
        self._migrate_session = None
        self._moved_keys: Dict[str, int] = {}
        self._migrate_in: Optional[dict] = None
        self._migrate_committed: Optional[dict] = None
        self._migrate_out_done: Optional[dict] = None
        self.elastic_log = make_history_log(record_full_history, history)
        #: each committed outbound move: the reply's numbers, the target,
        #: and its lock holds: ``snapshot_s`` (the export and queueing of
        #: every row, of which ``copy_s`` is the copy off the card) and
        #: ``cutover_s`` (the residual drain, the commit round trip and
        #: the eviction)
        self.migrations: List[dict] = []
        super().__init__(port=port, bind=bind, writev=writev, shm=shm,
                         backup=backup, native_loop=native_loop,
                         loop_threads=loop_threads)
        if coordinator is not None and not backup:
            # after the listener is up: the advertised URI needs the port
            self._join_coordinator(advertise_host)

    def _join_coordinator(self, advertise_host: str) -> None:
        """Register with the coordinator: this service's URI and each
        key's bytes, and a reporter sending the load (keys, bytes, push
        and pull rates, replication health) and this service's own
        telemetry on the coordinator's cadence."""
        from ps_tpu_torch.config import env_flag
        from ps_tpu_torch.elastic.member import CoordinatorMember
        from ps_tpu_torch.obs.collector import collect_telemetry

        key_bytes = {k: int(self._engine._params[k].nbytes)
                     for k in self._key_order}
        last = {"t": time.monotonic(), "req": self._req_counter.value,
                "applies": self.apply_log.total}

        def report_extra() -> dict:
            # rates from the counters the service keeps: applies a second
            # is the push rate, the other requests the pull rate
            now = time.monotonic()
            req, applies = self._req_counter.value, self.apply_log.total
            dt = max(now - last["t"], 1e-6)
            push_qps = (applies - last["applies"]) / dt
            pull_qps = max(req - last["req"] - (applies - last["applies"]),
                           0) / dt
            last.update(t=now, req=req, applies=applies)
            # under the engine lock: a cutover changes the params dict
            with self._engine._lock:
                nkeys = len(self._key_order)
                nbytes = sum(int(v.nbytes)
                             for v in self._engine._params.values())
            out = {"keys": nkeys, "nbytes": nbytes,
                   "push_qps": round(push_qps, 2),
                   "pull_qps": round(pull_qps, 2)}
            s = self._backup_session
            if s is not None or self.promote_reason is not None:
                out["repl"] = {
                    "attached": bool(s is not None and not s.degraded),
                    "degraded": bool(s is not None and s.degraded),
                    "promoted": self.promote_reason is not None,
                }
            return out

        telemetry = None
        if env_flag("PS_TELEMETRY", True):
            def telemetry() -> dict:
                return collect_telemetry(self.transport, counters={
                    "ps_applies_total": lambda: self.apply_log.total,
                })

        self._coord_member = CoordinatorMember(
            self._coordinator, f"{advertise_host}:{self.port}",
            key_bytes, kind="dense", report=report_extra,
            telemetry=telemetry)
        self.table_epoch = self._coord_member.table.epoch

    # -- server internals -----------------------------------------------------

    def _snapshot(self, worker: int):
        """One atomic pull under the engine lock: the tensors, the version
        and the event-log record mirror the engine's true order. Pulls
        replicate too (the DC apply depends on what each worker last
        pulled); with sync ack the backup's ack is waited for here,
        outside the lock, before the reply."""
        with self._engine._lock:
            with self._ranked("pull", worker=worker):
                kv = self._engine.pull_tree(worker=worker)
            version = self._engine.version
            key_order = list(self._key_order)
            with self._log_lock:
                self.event_log.append(["pull", worker])
            if self._migrating:
                # the pull moved this worker's stale snapshots of the moving
                # keys, part of their rows: stream the rows again, or the
                # recipient's DC correction would run against older
                # snapshots (the reference streams rows on commits only)
                self._publish_migrating(self._migrating)
            rseq = self._replicate("pull", worker)
        self._await_replication(rseq)
        return kv, version, key_order

    def _params_payload(self, worker: int):
        kv, version, _ = self._snapshot(worker)
        # outside the lock: the snapshot's tensors are never written again
        # (out-of-place applies), so the copy off the card and the encode
        # run while other workers apply
        host = stage_to_host(kv, stats=self.transport)
        if self.writev:
            return tv.encode_parts(tv.OK, worker, host,
                                   extra={"version": version})
        return tv.encode(tv.OK, worker, host, extra={"version": version})

    def _read_payload(self) -> bytes:
        """One READ: a version-stamped snapshot of this shard's whole
        subtree. Unlike PULL it records no event, replicates nothing and
        takes no DC snapshot, so the reply (worker id 0, a contiguous
        encode) is a pure function of committed state and the native loop
        can answer repeats from its cache. The publish generation is taken
        under the engine lock with the snapshot; the applies are out of
        place, so the copy off the card and the encode run outside it.
        Across ranks the async engine's parameters are whole on every rank
        (its ``_held_axes`` are empty), so rank 0 answers from its own
        tensors and sends no op to the other ranks."""
        with self._engine._lock:
            kv = {k: self._engine._params[k] for k in self._key_order}
            version = self._engine.version
            birth = dict(self._birth) if self._birth is not None else None
            gen = self._read_gen_snapshot()
        host = stage_to_host(kv, stats=self.transport)
        reply = tv.encode(tv.OK, 0, host, extra={"version": version,
                                                 **(birth or {})})
        self._note_read_snapshot(gen, version)
        self.transport.record_read_served()
        self._note_serve_age(birth)
        return reply

    def _read_cond_reply(self, extra) -> bytes:
        """A READ, conditional when ``extra["cond"]`` names the caller's
        version: a target at or below it is answered with a NOT_MODIFIED
        stamp (the birth included, so a revalidated snapshot reports its
        true age); anything else is :meth:`_read_payload`. Deterministic
        like the full reply (worker id 0): the native cache serves it as a
        version-floor entry."""
        cond = None
        if isinstance(extra, dict) and extra.get("cond") is not None:
            cond = int(extra["cond"])
        if cond is not None:
            with self._engine._lock:
                version = self._engine.version
                birth = dict(self._birth) if self._birth is not None else None
                gen = self._read_gen_snapshot()
            if version <= cond:
                reply = tv.encode(tv.NOT_MODIFIED, 0, None,
                                  extra={"version": version, **(birth or {})})
                self._note_read_snapshot(gen, version)
                self.transport.record_read_served()
                self.transport.record_read_not_modified()
                self._note_serve_age(birth)
                return reply
        return self._read_payload()

    def _read_version(self):
        return self._engine.version

    def _apply_push(self, worker: int, grads: Dict[str, np.ndarray],
                    extra: Optional[dict] = None
                    ) -> Tuple[Optional[int], bool]:
        """Apply one whole-tree push; returns ``(replication_seq,
        dedup)``, the seq for :meth:`_await_replication`.

        ``extra``'s ``pseq``/``pnonce`` are the worker's dedup token: a
        (nonce, seq) at or below the last applied one is a replay and is
        acked without applying. An aggregator's merged push also carries
        ``members``, each constituent's own ``{worker: [nonce, seq]}``
        token: recorded with the apply, so a member that degraded to the
        flat path and replays a push its dead aggregator already forwarded
        is acked; checked before it, so a merged push whose members all
        settled on their own is a replay, and one whose members partly
        settled is refused. ``members_tc`` (the members' trace contexts)
        is named on the apply's span, so any one member's trace finds the
        shared commit."""
        extra = extra or {}
        members = extra.get("members") or None
        pseq = extra.get("pseq")
        pnonce = extra.get("pnonce")
        # the replicated entry carries the host bytes that are applied, in
        # memory of its own: the frame they view goes back to its pool (or
        # the native loop) once the reply is sent, before the sender
        # thread encodes the entry
        wire = ({k: np.array(v) for k, v in grads.items()}
                if self._replicating() else None)
        host = grads  # what the op stream carries across ranks
        # onto the engine's device before the lock (a CUDA copy is waited
        # for); this also copies out of the receive buffer
        grads = stage_to_device(grads, self._device, stats=self.transport)
        t_apply = time.perf_counter()
        # the apply, lock wait included, is a child of the serve span when
        # the request is traced (the breakdown's server_apply phase)
        apply_span = obs.tracer().child("server_apply", cat="server")
        if extra.get("members_tc"):
            apply_span.set(members_tc=extra["members_tc"])
        with apply_span, self._engine._lock:
            while (self._paused and not self._draining
                   and not self._admit_while_paused(worker)):
                self._pause_wait_begin()
                try:
                    self._pause_cond.wait()  # a checkpoint snapshot
                finally:
                    self._pause_wait_end()
            if self._draining:
                raise RuntimeError("server is draining; push refused")
            # every check runs after any pause park: the wait releases the
            # lock, so the ledger may have moved meanwhile. A native
            # admission stamp proves the loop saw this frame strictly fresh
            # at a generation no apply has superseded: the scan is skipped
            fresh = grads
            if pseq is not None and not self._admit_fresh_hint():
                fresh = self._dedup_fresh(worker, pnonce, int(pseq), grads)
                if not fresh:
                    self.transport.record_dedup_hit()
                    return None, True
            if members:
                # a merged push against its members' own flat replays (the
                # group degraded mid-round and raced its dead aggregator's
                # in-flight push): first writer wins a member
                if self._check_members(members, fresh) == "dedup":
                    self.transport.record_dedup_hit()
                    return None, True
            # under the lock, after the park: a cutover changes the key
            # range under this same lock, so the check and the apply see
            # one table
            self._check_push_keys(grads)
            partial = len(fresh) != len(grads)
            with self._ranked("push_sub" if partial else "push",
                              worker=worker,
                              grads={k: host[k] for k in fresh}):
                if partial:
                    # a replay straddling a range move: this shard's own
                    # keys applied this (nonce, seq) already, the adopted
                    # keys are still owed it. Apply exactly those
                    self.transport.record_dedup_hit()
                    self._engine.push_subtree(fresh, worker=worker)
                else:
                    self._engine.push_tree(fresh, worker=worker)
            # cached READ replies now describe a superseded version: drop
            # them and refuse any in-flight publish of the pre-apply
            # snapshot (the admission mirror's generation moves too)
            self._invalidate_reads()
            self._birth = freshness.birth_record()
            apply_s = time.perf_counter() - t_apply
            self._applied[worker] = self._applied.get(worker, 0) + 1
            if pseq is not None:
                toks = self._applied_pseq.setdefault(worker, {})
                for k in fresh:
                    toks[k] = (pnonce, int(pseq))
            # a merged push's members' tokens beside the aggregator's own
            # (different worker ids: neither evicts the other), so the
            # ledger holds exactly once across the handoff either way
            self._record_members(members, fresh)
            # republish the settled ledger rows this apply advanced (the
            # pusher's and every member's) and the fresh ack template to
            # native admission at the post-apply generation
            self._admit_publish(worker, *[int(w) for w in members or {}])
            self._pause_cond.notify_all()  # a drain_to waiter may watch
            with self._log_lock:
                if partial:
                    self.elastic_log.append({
                        "op": "push_sub", "worker": worker,
                        "keys": sorted(fresh), "at": self.event_log.total})
                self.apply_log.append(worker)
                self.event_log.append(["push", worker])
            # double-write: a commit touching keys mid-migration streams
            # their new rows, so the recipient converges on the live state
            if self._migrating:
                self._publish_migrating(self._migrating.intersection(fresh))
            # appended under the engine lock: log order is engine order.
            # ``wire`` is None when the session degraded since the check
            # above, and then _replicate appends nothing either
            if wire is None and self._replicating():
                # a session attached while this push was staged
                wire = {k: v.cpu().numpy() for k, v in fresh.items()}
            elif wire is not None and partial:
                wire = {k: wire[k] for k in fresh}
            # a straddling replay's partial apply is its own op: the
            # backup mirrors the subset, it must not refuse a torn tree
            rseq = self._replicate("push_sub" if partial else "push",
                                   worker, wire, {
                "pseq": pseq, "pnonce": pnonce, "members": members,
                "birth": self._birth["birth"]})
        # the apply (lock wait included), and the push-to-servable lag: the
        # lock is released and the floor raised, a READ serves the new
        # version from here on
        self.transport.record_apply(apply_s)
        self.transport.record_fresh_lag(time.perf_counter() - t_apply)
        return rseq, False

    @staticmethod
    def _token_settled(cur, nonce, seq: int) -> bool:
        """The ledger's one predicate, shared by the dedup scan, the
        members' check and their recording: a recorded token at or past
        (nonce, seq) means that push already carries the key. Same-nonce
        comparison only: a new nonce is a new incarnation whose seqs
        restart."""
        return cur is not None and cur[0] == nonce and int(seq) <= cur[1]

    def _record_members(self, members, fresh) -> None:
        """Record a merged push's members' (worker, nonce, seq) tokens for
        every key it applied (lock held). ``members`` is the aggregator's
        ``{worker_str: [nonce, seq]}`` map, None on ordinary pushes. The
        ledger only advances: a member that already applied a later flat
        push keeps its token, or a seq the engine holds would dedup no
        more."""
        for w_str, t in (members or {}).items():
            toks = self._applied_pseq.setdefault(int(w_str), {})
            for k in fresh:
                if self._token_settled(toks.get(k), t[0], t[1]):
                    continue
                toks[k] = (t[0], int(t[1]))

    def _check_members(self, members, fresh) -> str:
        """Classify a merged push against its members' recorded tokens
        (lock held): "apply" when no member's push is in the engine yet,
        "dedup" when every member's is, on every key (the merged push is
        a replay of settled state). A partial overlap raises: a summed
        tree cannot be applied in part, and the remaining members' flat
        replays settle the round exactly once."""
        stale = total = 0
        for w_str, t in members.items():
            toks = self._applied_pseq.get(int(w_str)) or {}
            for k in fresh:
                total += 1
                if self._token_settled(toks.get(k), t[0], t[1]):
                    stale += 1
        if stale == 0:
            return "apply"
        if stale == total:
            return "dedup"
        raise RuntimeError(
            "merged push refused: some of its constituent pushes were "
            "already applied individually (the group degraded mid-round "
            "and replayed flat) — a summed tree cannot be partially "
            "applied; the remaining members' flat replays settle the "
            "round exactly-once")

    def _dedup_fresh(self, worker: int, pnonce, pseq: int, grads):
        """The keys still owed an apply (lock held): a key whose last
        applied token is at or past (pnonce, pseq) already carries this
        push."""
        toks = self._applied_pseq.get(worker)
        if not toks:
            return grads
        return {k: v for k, v in grads.items()
                if not self._token_settled(toks.get(k), pnonce, pseq)}

    def _check_push_keys(self, grads) -> None:
        """The key range (lock held). On an elastic service a mismatch
        means the worker's table is stale, keys moved under it: the
        retryable 'moved' refusal (re-fetch and re-route), never a
        KeyError that ends the job."""
        if sorted(grads) == sorted(self._key_order):
            return
        if self._elastic:
            wrong = sorted(set(grads) ^ set(self._key_order))
            moved = [k for k in wrong if k in self._moved_keys]
            raise StaleTableError(
                f"push keys do not match this shard's key range (table "
                f"epoch {self.table_epoch}): "
                + (f"{moved[:3]} moved to another shard"
                   if moved else f"{wrong[:3]} differ"))
        raise KeyError("push keys do not match the registered tree")

    def _publish_migrating(self, touched) -> None:
        """Stream the just-committed rows of keys still moving to the
        recipient (lock held: row order is engine order)."""
        from ps_tpu_torch.elastic.migrate import encode_row

        s = self._migrate_session
        if not touched or s is None or s.degraded:
            return  # a degraded stream aborts the move
        rows = self._export(sorted(touched))
        for k in sorted(rows):
            r = rows[k]
            tensors, meta = encode_row(k, r["param"], r["state"],
                                       r["stale"], r["apply_count"])
            # a full window stalls commits of the moving keys (bounded
            # catch-up); the stall timeout degrades, then aborts, a stuck
            # recipient
            s.publish_row(k, tensors, meta)

    def _admit_while_paused(self, worker: int) -> bool:
        """Under pause, admit exactly the pushes a drain_to round asked
        for: this worker still lags its cross-shard target."""
        return (self._applied.get(worker, 0)
                < self._drain_targets.get(worker, 0))

    def _push_reply(self, worker: int, dedup: bool, **extra):
        return tv.encode(tv.OK, worker, None, extra={
            "version": self._engine.version, **extra, "dedup": dedup})

    def _decode_push(self, tensors, extra) -> Dict[str, np.ndarray]:
        """Unpack a push's codec-packed keys (``extra["enc"]``) before the
        apply; the decoded arrays are the codec's own (raw keys stay views
        of the frame, copied to the device before the frame is released)."""
        enc = (extra or {}).get("enc")
        if not enc:
            return tensors
        return decode_tree(dict(tensors), enc, stats=self.transport)

    # -- the zero-upcall push plane (VanService's admission hooks) ------------

    def _service_lock(self):
        return self._engine._lock

    def _admit_kind(self):
        # whole-tree PUSH only: PUSH_PULL replies with params (no template
        # can pre-encode them) and bucket frames are staged
        return tv.PUSH

    def _admit_entry(self, worker: int):
        """This worker's per-key tokens folded to one (nonce, lo, hi) row:
        publishable only when every served key carries a token under one
        nonce (lo the least seq, hi the greatest). A partial or mixed map
        gives None and the worker's frames go to the pump."""
        toks = self._applied_pseq.get(worker)
        order = self._key_order
        if not toks or not order:
            return None
        nonce = None
        lo = hi = 0
        for k in order:
            t = toks.get(k)
            if t is None or not isinstance(t[0], str):
                return None
            if nonce is None:
                nonce, lo, hi = t[0], int(t[1]), int(t[1])
            elif t[0] != nonce:
                return None
            else:
                lo = min(lo, int(t[1]))
                hi = max(hi, int(t[1]))
        return nonce, lo, hi

    def _admit_ack_bytes(self):
        # byte for byte the pump's pure-replay ack (the loop patches the
        # worker id): the current version, dedup set
        return self._push_reply(0, True)

    # -- bucketed transport (server half) -------------------------------------

    def _bucket_push(self, worker: int, tensors, extra):
        """One bucket of a multi-bucket push: incomplete epochs only stage
        (ack); the completing bucket applies the whole assembled tree at
        once, so a torn push is never observable."""
        tree = self._stage_bucket_push(
            worker, int(extra["bucket"]), int(extra["nbuckets"]),
            int(extra["epoch"]), tensors["raw"], extra["slices"],
            nonce=extra.get("nonce"))
        if tree is None:
            return tv.encode(tv.OK, worker, None,
                             extra={"staged": int(extra["bucket"])})
        # codec-packed keys (the same list on every bucket of the epoch)
        # are decoded after the assembly, before the apply
        tree = decode_tree(tree, extra.get("enc"), stats=self.transport)
        rseq, dedup = self._apply_push(worker, tree, extra=extra)
        self._await_replication(rseq)
        return self._push_reply(worker, dedup, committed=True)

    def _bucket_pull(self, worker: int, extra):
        """Bucketed pull: bucket 0 takes one atomic snapshot (as a serial
        PULL, event-log record included) and replies with the front
        slices; buckets 1..n-1 read the cached snapshot, each encoded on
        the serve thread that asks."""
        epoch, b = int(extra["epoch"]), int(extra["bucket"])
        if b == 0:
            bb = int(extra.get("bucket_bytes") or DEFAULT_BUCKET_BYTES)
            kv, version, key_order = self._snapshot(worker)
            host = stage_to_host(kv, stats=self.transport)
            # the return path's compression, asked for per request: the
            # worker names the spec, the server applies the per-key policy
            # and names the packed keys in every bucket's header
            enc: List[str] = []
            spec = extra.get("compress")
            if spec:
                # fresh quantization noise per (worker, pull epoch): a
                # fixed seed would replay one draw every pull, a bias
                spec = dict(spec)
                spec["seed"] = ((int(spec.get("seed", 0)) * 1000003
                                 + worker * 9176 + epoch) & 0x7FFFFFFF)
                comp = GradCompressor(CompressPolicy.from_spec(spec),
                                      stats=self.transport)
                host, enc = comp.encode_tree(host)
                host = {k: np.ascontiguousarray(v) for k, v in host.items()}
            plan = BucketPlan.from_arrays(host, bb, order=key_order)
            with self._stage_lock:
                if plan.nbuckets > 1:
                    self._pull_cache[worker] = {
                        "epoch": epoch, "host": host, "plan": plan,
                        "version": version, "enc": enc,
                        "left": set(range(1, plan.nbuckets)),
                    }
                else:
                    self._pull_cache.pop(worker, None)
            return plan.bucket_encoder(self.writev)(
                tv.OK, worker, host, 0,
                extra={"epoch": epoch, "version": version, "enc": enc})
        with self._stage_lock:
            entry = self._pull_cache.get(worker)
            if (entry is None or entry["epoch"] != epoch
                    or b not in entry["left"]):
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": f"no cached pull snapshot for worker {worker} "
                             f"epoch {epoch} bucket {b}"})
            entry["left"].discard(b)
            if not entry["left"]:
                self._pull_cache.pop(worker, None)
        return entry["plan"].bucket_encoder(self.writev)(
            tv.OK, worker, entry["host"], b,
            extra={"epoch": epoch, "version": entry["version"],
                   "enc": entry["enc"]})

    def _stats(self, worker: int):
        with self._log_lock:
            log = log_tail(self.apply_log)
            log_total = self.apply_log.total
        out = {
            "version": self._engine.version,
            "staleness_hist": {str(t): n for t, n in
                               self._engine.staleness_hist.items()},
            "apply_log": log,
            "apply_log_total": log_total,
            "worker_version": {str(w): v for w, v in
                               self._engine._worker_version.items()},
            "stale_epochs": self.transport.stale_epochs,
            "stale_epoch_buckets": self.transport.stale_epoch_buckets,
            "metrics": self.transport.metrics_snapshot(),
        }
        out.update(self.replica_state())
        if self._elastic:
            out["table_epoch"] = self.table_epoch
            out["keys_moved"] = len(self._moved_keys)
        return tv.encode(tv.OK, worker, None, extra=out)

    def _handle(self, kind: int, worker: int, tensors, extra):
        if kind == tv.HELLO:
            return tv.encode(tv.OK, worker, None, extra={
                "keys": self._key_order,
                "version": self._engine.version,
                "num_workers": self._engine.num_workers,
                "shard": self.shard,
                "num_shards": self.num_shards,
                "epoch": self.epoch,
                "role": self.role,
                "table_epoch": self.table_epoch,
            })
        if kind == tv.PULL:
            return self._params_payload(worker)
        if kind == tv.READ:
            return self._read_cond_reply(extra)
        if kind == tv.PUSH:
            rseq, dedup = self._apply_push(
                worker, self._decode_push(tensors, extra), extra=extra)
            self._await_replication(rseq)
            return self._push_reply(worker, dedup)
        if kind == tv.PUSH_PULL:
            self._apply_push(worker, self._decode_push(tensors, extra),
                             extra=extra)
            # no separate ack wait: the pull's record is a later entry,
            # and the reply waits on it (acks are in order)
            return self._params_payload(worker)
        if kind == tv.BUCKET_PUSH:
            return self._bucket_push(worker, tensors, extra)
        if kind == tv.BUCKET_PULL:
            return self._bucket_pull(worker, extra)
        if kind == tv.STATS:
            return self._stats(worker)
        if kind == tv.CHECKPOINT:
            return self._checkpoint(worker, extra)
        if kind == tv.MIGRATE_OUT:
            return self._migrate_out(worker, extra)
        if kind == tv.MIGRATE_BEGIN:
            return self._migrate_begin(worker, extra)
        if kind == tv.MIGRATE_ROW:
            return self._migrate_row(worker, tensors, extra)
        if kind == tv.MIGRATE_COMMIT:
            return self._migrate_commit(worker, extra)
        if kind == tv.MIGRATE_ABORT:
            return self._migrate_abort(worker)
        if kind == tv.RESEED:
            return self._reseed_backup(worker, extra)
        return tv.encode(tv.ERR, worker, None,
                         extra={"error": f"bad kind {kind}"})

    def _checkpoint(self, worker: int, extra: dict):
        """The coordinated, cross-shard-atomic checkpoint, driven by
        :meth:`RemoteAsyncWorker.checkpoint_all`: 'pause' blocks new
        applies and reports the per-worker applied counts, 'drain_to'
        admits exactly the pushes needed to reach the cross-shard targets,
        'save' writes this shard (``<dir>/shard<i>`` when partitioned)
        through ``KVStore.save`` under the engine lock, 'resume' releases
        the applies. 'pause' hands out a token that every later phase must
        present; ``phase='resume', force=True`` is the operator's override
        when a coordinator died holding it."""
        import os

        phase = extra.get("phase", "save")
        if phase == "pause":
            with self._engine._lock:
                token = self._ckpt_issue_token()
                if token is None:
                    return tv.encode(tv.ERR, worker, None,
                                     extra={"error": self._ckpt_busy_error()})
                self._paused = True
                # paused: every push must reach the pump and park there,
                # so native admission is dropped until the resume
                self._admit_drop()
                applied = {str(w): n for w, n in self._applied.items()}
            return tv.encode(tv.OK, worker, None, extra={
                "version": self._engine.version, "applied": applied,
                "token": token})
        if phase == "resume" and extra.get("force"):
            with self._engine._lock:
                self._paused = False
                self._ckpt_clear_token()
                # the pause is over: every cached READ drops and admission
                # reseeds
                self._invalidate_reads()
                self._admit_sync(locked=True)
                self._pause_cond.notify_all()
            return tv.encode(tv.OK, worker, None, extra={
                "version": self._engine.version, "forced": True})
        err = self._ckpt_token_error(phase, extra)
        if err is not None:
            return tv.encode(tv.ERR, worker, None, extra={"error": err})
        if phase == "drain_to":
            targets = {int(w): int(n) for w, n in extra["targets"].items()}
            deadline = time.monotonic() + float(
                extra.get("timeout", DRAIN_TO_TIMEOUT_S))
            with self._engine._lock:
                self._drain_targets = targets
                self._pause_cond.notify_all()
                while any(self._applied.get(w, 0) < n
                          for w, n in targets.items()):
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
                             extra={"version": self._engine.version})
        if phase == "resume":
            with self._engine._lock:
                self._paused = False
                self._ckpt_clear_token()
                # the pause is over: every cached READ drops and admission
                # reseeds
                self._invalidate_reads()
                self._admit_sync(locked=True)
                self._pause_cond.notify_all()
            return tv.encode(tv.OK, worker, None,
                             extra={"version": self._engine.version})
        base = resolve_ckpt_dir(self._ckpt_root, extra["dir"])
        path = (base if self.num_shards is None
                else os.path.join(base, f"shard{self.shard}"))
        with self._engine._lock:
            with self._ranked("save", path=path):
                self._store.save(path)
            version = self._engine.version
        return tv.encode(tv.OK, worker, None,
                         extra={"version": version, "path": path})

    # -- elastic membership: live key-range moves (elastic/) -----------------

    def _migrate_out(self, worker: int, extra: dict):
        """DONOR: stream ``extra["keys"]`` to the shard at
        ``extra["target"]`` and cut over (the coordinator's MIGRATE_OUT;
        this serve thread drives the whole move while the others serve).

        (1) The rows are exported and queued under the engine lock,
        atomically with arming the double-write set, so row order is
        engine order from the first row; (2) the catch-up runs outside
        the lock, traffic flows and every commit touching a moving key
        re-streams it; (3) a bounded stop-and-copy: under the lock the
        residual window drains, MIGRATE_COMMIT installs the rows at the
        recipient (with the moved keys' dedup tokens), the keys are
        evicted here, and the lock is released. A failure before the
        commit aborts with this shard intact. A re-asked move that
        already committed here acks with its receipt."""
        from ps_tpu_torch.elastic.migrate import (MigrationError,
                                                  MigrationSession,
                                                  encode_row)

        keys = sorted(str(k) for k in extra["keys"])
        target = str(extra["target"])
        new_epoch = int(extra["table_epoch"])
        # the receipt holds only while the keys are still gone: once a
        # later rebalance brought them back, the same request is a new move
        done = self._migrate_out_done
        if (done is not None and done["keys"] == keys
                and done["target"] == target
                and not any(k in self._key_order for k in keys)):
            return tv.encode(tv.OK, worker, None, extra=done["reply"])
        if not keys:
            raise ValueError("MIGRATE_OUT with no keys")
        repl = self._backup_session
        if repl is not None and not repl.degraded:
            raise RuntimeError(
                "this shard is replicating to a backup — a live key "
                "migration would drift the replica stream's key range; "
                "detach the backup, move, then re-seed and re-attach it")
        host, port = parse_replica_uri(target)[0][0]
        engine = self._engine
        t0 = time.monotonic()
        begin = {"kind": "dense", "keys": keys,
                 "num_workers": engine.num_workers,
                 "table_epoch": new_epoch}
        # a window the whole snapshot fits, so queueing it never blocks
        # under the lock: backpressure is for the double-write phase
        session = MigrationSession(host, port, begin, stats=self.transport,
                                   window=max(64, 2 * len(keys)))
        committed = False
        timing = {}
        try:
            t1 = time.monotonic()
            with engine._lock:
                if self._migrating:
                    raise RuntimeError(
                        "a migration is already in flight at this shard")
                missing = [k for k in keys if k not in self._key_order]
                if missing:
                    raise KeyError(
                        f"donor does not own {missing[:3]} — the "
                        f"coordinator's table is ahead of this shard")
                t2 = time.monotonic()
                rows = self._export(keys)  # off the card, waited for
                timing["copy_s"] = time.monotonic() - t2
                for k in keys:
                    r = rows[k]
                    tensors, meta = encode_row(k, r["param"], r["state"],
                                               r["stale"], r["apply_count"])
                    session.publish_row(k, tensors, meta)
                self._migrating = frozenset(keys)
                self._migrate_session = session
            timing["snapshot_s"] = time.monotonic() - t1
            if not session.wait_drained():
                raise MigrationError(
                    f"recipient never caught up: {session.log.death_reason}")
            # the stop-and-copy: the lock held across the residual drain
            # and one commit round trip makes the cutover atomic (no push
            # lands between the last row and the ownership change)
            t3 = time.monotonic()
            with engine._lock:
                if not session.wait_drained():
                    raise MigrationError(
                        "recipient stalled during the cutover freeze")
                session.quiesce()
                gone = set(keys)
                # the moved keys' dedup tokens travel with them (the
                # recipient acks a replayed pre-move push unapplied); the
                # remaining keys keep theirs here
                tokens = {}
                for w, toks in self._applied_pseq.items():
                    moved = {k: [t[0], t[1]] for k, t in toks.items()
                             if k in gone}
                    if moved:
                        tokens[str(w)] = moved
                applied = {str(w): n for w, n in self._applied.items()}
                session.commit({"table_epoch": new_epoch, "tokens": tokens,
                                "applied": applied, "keys": keys})
                with self._ranked("evict", keys=keys):
                    engine.evict_keys(keys)
                self._invalidate_reads()  # the served subtree shrank
                self._birth = freshness.birth_record()
                # only now does this shard refuse the moved range as
                # 'moved': an aborted move leaves a static deployment's
                # KeyError untouched
                self._elastic = True
                for toks in self._applied_pseq.values():
                    for k in gone.intersection(toks):
                        del toks[k]
                self._key_order = [k for k in self._key_order
                                   if k not in gone]
                now_moved = dict(self._moved_keys)
                now_moved.update({k: new_epoch for k in keys})
                self._moved_keys = now_moved
                self.table_epoch = max(self.table_epoch, new_epoch)
                with self._log_lock:
                    self.elastic_log.append({
                        "op": "migrate_out", "keys": keys,
                        "table_epoch": new_epoch,
                        "at": self.event_log.total})
                # the key range and its token folds changed shape
                self._admit_sync(locked=True)
                committed = True
            timing["cutover_s"] = time.monotonic() - t3
        finally:
            with engine._lock:
                self._migrating = frozenset()
                self._migrate_session = None
            if committed:
                session.close()
            else:
                session.abort()
        dt = time.monotonic() - t0
        logging.getLogger(__name__).info(
            "migrated %d key(s) to %s in %.2fs (%d row(s), %.1f MB, "
            "table epoch %d)", len(keys), target, dt, session.rows_sent,
            session.bytes_sent / 1e6, new_epoch)
        reply = {"keys": keys, "rows": session.rows_sent,
                 "bytes": session.bytes_sent, "seconds": round(dt, 4),
                 "table_epoch": new_epoch}
        self._migrate_out_done = {"keys": keys, "target": target,
                                  "reply": reply}
        self.migrations.append(dict(reply, target=target, **timing))
        return tv.encode(tv.OK, worker, None, extra=reply)

    def _migrate_begin(self, worker: int, extra: dict):
        """RECIPIENT: open the intake, the declared range checked and
        staged; the rows reach the engine only at MIGRATE_COMMIT."""
        def refuse(error):
            return tv.encode(tv.ERR, worker, None, extra={"error": error})

        if extra.get("kind") != "dense":
            return refuse(f"migration stream kind {extra.get('kind')!r} "
                          f"does not match this dense service")
        repl = self._backup_session
        if repl is not None and not repl.degraded:
            return refuse("this shard is replicating to a backup — "
                          "adopting keys would drift the replica stream's "
                          "key range")
        keys = set(str(k) for k in extra.get("keys") or [])
        if not keys:
            return refuse("MIGRATE_BEGIN with no keys")
        nw = extra.get("num_workers")
        if nw is not None and int(nw) != self._engine.num_workers:
            return refuse(f"donor says num_workers={nw}, this service "
                          f"runs {self._engine.num_workers}")
        overlap = keys & set(self._key_order)
        if overlap:
            return refuse(f"this shard already owns {sorted(overlap)[:3]}")
        with self._stage_lock:
            if self._migrate_in is not None:
                return refuse("a migration intake is already staged here")
            self._migrate_in = {"keys": keys, "rows": {}, "seq": 0}
        return tv.encode(tv.OK, worker, None, extra={"applied_seq": 0})

    def _migrate_row(self, worker: int, tensors, extra):
        """RECIPIENT: stage one sequenced row (a later row of a key
        supersedes the earlier: the donor's double-write catch-up)."""
        from ps_tpu_torch.elastic.migrate import decode_row

        seq = int(extra["seq"])
        # the copy out of the frame runs outside _stage_lock: this shard
        # serves meanwhile, and every bucketed push stages under that lock
        row = decode_row(tensors, extra)
        with self._stage_lock:
            stage = self._migrate_in
            if stage is None:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "MIGRATE_ROW before MIGRATE_BEGIN"})
            if seq != stage["seq"] + 1:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": f"migration gap: expected seq "
                             f"{stage['seq'] + 1}, got {seq}"})
            if row["key"] not in stage["keys"]:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": f"row for {row['key']!r} outside the "
                             f"declared range"})
            stage["rows"][row["key"]] = row
            stage["seq"] = seq
        return tv.encode(tv.OK, worker, None, extra={"applied_seq": seq})

    def _migrate_commit(self, worker: int, extra: dict):
        """RECIPIENT: the cutover under one engine-lock hold: every staged
        row installed, the served range extended, the donor's dedup
        tokens merged (a push the donor applied and the worker replays
        here is acked unapplied). A re-asked commit of the range that
        just committed acks again (its first reply was lost)."""
        with self._stage_lock:
            stage = self._migrate_in
        if stage is None:
            asked = sorted(str(k) for k in (extra.get("keys") or []))
            done = self._migrate_committed
            if asked and done is not None and asked == done["keys"]:
                return tv.encode(tv.OK, worker, None, extra={
                    "keys": done["keys"],
                    "table_epoch": done["table_epoch"]})
            return tv.encode(tv.ERR, worker, None, extra={
                "error": "MIGRATE_COMMIT without a staged intake"})
        missing = sorted(stage["keys"] - set(stage["rows"]))
        if missing:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": f"commit refused: keys never streamed "
                         f"{missing[:3]}"})
        new_epoch = int(extra.get("table_epoch", 0))
        adopted = sorted(stage["rows"])
        with self._engine._lock:
            for k in adopted:
                r = stage["rows"][k]
                self._adopt(k, r)
            self._key_order = sorted(self._key_order + adopted)
            for w_str, toks in (extra.get("tokens") or {}).items():
                mine = self._applied_pseq.setdefault(int(w_str), {})
                for k, t in toks.items():
                    # the donor owned the key: its token is the key's
                    # whole apply history
                    mine[k] = (t[0], int(t[1]))
            for w_str, n in (extra.get("applied") or {}).items():
                w = int(w_str)
                self._applied[w] = max(self._applied.get(w, 0), int(n))
            self.table_epoch = max(self.table_epoch, new_epoch)
            self._invalidate_reads()  # the served subtree grew
            self._birth = freshness.birth_record()
            self._elastic = True
            with self._log_lock:
                self.elastic_log.append({
                    "op": "adopt", "keys": adopted,
                    "table_epoch": self.table_epoch,
                    "at": self.event_log.total})
            # the key range grew and tokens merged: re-fold the ledger
            self._admit_sync(locked=True)
        with self._stage_lock:
            self._migrate_in = None
            self._migrate_committed = {"keys": adopted,
                                       "table_epoch": self.table_epoch}
        logging.getLogger(__name__).info(
            "adopted %d migrated key(s) (table epoch %d); now serving "
            "%d key(s)", len(adopted), self.table_epoch,
            len(self._key_order))
        return tv.encode(tv.OK, worker, None, extra={
            "keys": adopted, "table_epoch": self.table_epoch})

    def _migrate_abort(self, worker: int):
        """RECIPIENT: drop the staged range (nothing of it reached the
        engine; the donor keeps serving)."""
        with self._stage_lock:
            self._migrate_in = None
        return tv.encode(tv.OK, worker, None)

    def stop(self, grace: float = 10.0) -> None:
        m = self._coord_member
        if m is not None:
            m.close(goodbye=True)  # a clean leave: 'left', never 'dead'
        super().stop(grace=grace)
        if self._ops is not None:
            self._ops.close()  # the op "stop": releases the other ranks

    def kill(self) -> None:
        m = self._coord_member
        if m is not None:
            m.close(goodbye=False)  # as a SIGKILL: the beats just stop
        super().kill()

    def _rank_lost(self, err: BaseException) -> None:
        """A rank of this server across ranks failed (its op broadcast
        raised, or the heartbeat detector declared it dead): stop serving
        at once, as this process's own death would, so workers see
        ``ServerFailureError`` or fail over to a backup instead of
        waiting on a collective that cannot complete."""
        obs.record_event("rank_lost", error=repr(err))
        logging.getLogger(__name__).error(
            "a rank of this server across ranks failed (%r): stopping the "
            "service", err)
        self.kill()

    # -- the engine calls a store across ranks sends as ops (op_stream.py) ----

    @contextlib.contextmanager
    def _ranked(self, op: str, **args):
        """Send ``op`` to the other ranks (engine lock held), then run
        rank 0's same engine call in the block; on one rank just the
        block. Once the op went out, a RuntimeError of the call is a
        collective a dead rank left unpaired (the engine's own refusals
        come before any op): the stream fails, the service stops, and
        the request is refused as not serving."""
        ops = self._ops
        if ops is None:
            yield
            return
        ops.send(op, **args)
        try:
            yield
        except RankLostError:
            raise
        except RuntimeError as e:
            ops.fail(e)
            raise RankLostError(f"a rank of this server across ranks "
                                f"failed in the {op!r} op: {e!r}") from e

    def _export(self, keys: List[str]) -> Dict[str, dict]:
        """``export_keys`` as the op ``export`` (every rank joins its
        all-gathers of the owned state blocks; rank 0 keeps the rows)."""
        with self._ranked("export", keys=keys):
            return self._engine.export_keys(keys)

    def _adopt(self, k: str, r: dict) -> None:
        """``adopt_key`` of one row as the op ``adopt`` (it carries the
        row: every rank places its blocks)."""
        with self._ranked("adopt", key=k, param=r["param"], state=r["state"],
                          stale=r["stale"], apply_count=r["apply_count"]):
            self._engine.adopt_key(k, r["param"], r["state"], r["stale"],
                                   r["apply_count"])

    def _set_draining(self) -> None:
        with self._engine._lock:
            self._draining = True
            self._pause_cond.notify_all()  # paused pushes wake into refusal
        self._invalidate_reads()
        self._admit_drop()  # the pump's draining refusal is the only answer

    # -- shard replication (replica/) -------------------------------------------

    def _replica_hello_extra(self) -> dict:
        return {
            "kind": "dense",
            "keys": self._key_order,
            "shard": self.shard,
            "num_shards": self.num_shards,
            "version": self._engine.version,
            "start_seq": 0,
        }

    def _replica_validate(self, extra: dict) -> Optional[str]:
        if extra.get("kind") != "dense":
            return (f"replication stream kind {extra.get('kind')!r} does "
                    f"not match this dense service")
        if sorted(extra.get("keys") or []) != sorted(self._key_order):
            return "primary and backup disagree on the key range"
        if (extra.get("shard"), extra.get("num_shards")) \
                != (self.shard, self.num_shards):
            return (f"primary is shard {extra.get('shard')}/"
                    f"{extra.get('num_shards')}, backup is shard "
                    f"{self.shard}/{self.num_shards}")
        if int(extra.get("version", -1)) != self._engine.version:
            return (f"state-point mismatch: primary at version "
                    f"{extra.get('version')}, backup at "
                    f"{self._engine.version} — a deltas-only stream cannot "
                    f"catch up past missed commits; start the pair from the "
                    f"same initial params or a common checkpoint")
        return None

    def _replica_apply(self, op: str, worker: int, tensors, extra) -> None:
        """One replicated event through this backup's engine, with the
        engine lock held by the dispatcher (so never through
        :meth:`_apply_push`). The push's gradients go to the engine's
        device as the primary's did, copied out of the request frame."""
        if op == "pull":
            with self._ranked("pull", worker=worker):
                self._engine.pull_tree(worker=worker)
            with self._log_lock:
                self.event_log.append(["pull", worker])
            return
        if op not in ("push", "push_sub"):
            raise ValueError(f"unknown replica op {op!r}")
        tree = decode_tree(dict(tensors), extra.get("enc"),
                           stats=self.transport)
        on_device = stage_to_device(tree, self._device, stats=self.transport)
        if op == "push_sub":
            # the primary's partial apply (a replay straddling a range
            # move owed only its adopted keys): mirror exactly that subset
            missing = [k for k in tree if k not in self._key_order]
            if missing:
                raise KeyError(f"replica push_sub keys outside the tree: "
                               f"{missing[:3]}")
            with self._ranked("push_sub", worker=worker, grads=tree):
                self._engine.push_subtree(on_device, worker=worker)
        else:
            if sorted(tree) != sorted(self._key_order):
                raise KeyError("replica push keys do not match the tree")
            with self._ranked("push", worker=worker, grads=tree):
                self._engine.push_tree(on_device, worker=worker)
        # a backup serves READs: its cached replies go stale on every
        # replicated apply. It installs the primary's birth (a foreign
        # stamp: the wall clock crosses processes, the monotonic one does
        # not), so its reads report the age since the primary's apply
        self._invalidate_reads()
        b = extra.get("birth")
        self._birth = (freshness.foreign_record(float(b)) if b is not None
                       else freshness.birth_record())
        self._applied[worker] = self._applied.get(worker, 0) + 1
        if extra.get("pseq") is not None:
            toks = self._applied_pseq.setdefault(worker, {})
            for k in tree:
                toks[k] = (extra.get("pnonce"), int(extra["pseq"]))
        # a merged push's members' tokens ride the entry: a promoted backup
        # suppresses a degraded member's replay as its primary would have
        self._record_members(extra.get("members"), tree)
        with self._log_lock:
            self.apply_log.append(worker)
            self.event_log.append([op, worker])

    def _reseed_backup(self, worker: int, extra: dict):
        """RESEED (an operator or coordinator to this primary): restore
        redundancy after a failover or a backup's death used the pair up.
        Applies are quiesced for the whole of it (the engine lock is
        re-entrant): the export, the one-frame ``REPLICA_SEED`` install at
        the spare and the attach are one hold, so the spare receives the
        exact state point the new stream continues from. Ships every row
        (param, optimizer state, stale snapshots, apply count), the
        engine's meta and the per-key exactly-once ledger, in the
        reference's frame layout, the optimizer state under the
        reference's leaf paths (as a key move ships it), so the spare may
        be a service of either package."""
        from ps_tpu_torch.elastic.migrate import encode_row

        spare = str(extra.get("spare") or "")
        if ":" not in spare:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": "reseed needs spare \"host:port\""})
        if self.role != "primary":
            return tv.encode(tv.ERR, worker, None, extra={
                "error": f"only a primary re-seeds (role={self.role})"})
        shost, sport = spare.rsplit(":", 1)
        t0 = time.monotonic()
        eng = self._engine
        with eng._lock:
            old = self._backup_session
            if old is not None and not old.degraded:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "a live backup session is already attached"})
            tensors: Dict[str, np.ndarray] = {}
            rows = []
            exported = self._export(list(self._key_order))
            for i, k in enumerate(self._key_order):
                r = exported[k]
                t, e = encode_row(k, r["param"], r["state"], r["stale"],
                                  r["apply_count"])
                for name, v in t.items():
                    tensors[f"{i}/{name}"] = np.asarray(v)
                rows.append(e)
            frame = tv.encode(tv.REPLICA_SEED, 0, tensors, extra={
                "kind": "dense",
                "keys": self._key_order,
                "shard": self.shard, "num_shards": self.num_shards,
                "rows": rows,
                "meta": eng._checkpoint_meta(),
                "applied": {str(w): int(n) for w, n in self._applied.items()},
                "tokens": {str(w): {k: [tk[0], int(tk[1])]
                                    for k, tk in toks.items()}
                           for w, toks in self._applied_pseq.items()},
            })
            nbytes = len(frame)
            # applies stay frozen while the seed ships: the spare installs
            # the exact state point the stream continues from (a dead spare
            # fails the connect, not the primary)
            ch = tv.Channel.connect(shost, int(sport))
            try:
                k2, _, _, rep_ = tv.decode(ch.request(frame))
            finally:
                ch.close()
            if k2 != tv.OK:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": f"spare refused seed: {rep_.get('error')}"})
            self.attach_backup(shost, int(sport),
                               ack=str(extra.get("ack", "sync")))
        dt = time.monotonic() - t0
        obs.record_event("reseed", spare=spare, keys=len(rows),
                         bytes=nbytes, seconds=round(dt, 4))
        logging.getLogger(__name__).warning(
            "re-seeded backup at %s: %d key(s), %.1f MB in %.2fs "
            "(redundancy restored)", spare, len(rows), nbytes / 1e6, dt)
        return tv.encode(tv.OK, worker, None, extra={
            "keys": len(rows), "bytes": nbytes, "seconds": round(dt, 4)})

    def _replica_seed(self, worker: int, tensors, extra) -> Optional[str]:
        """REPLICA_SEED (a re-seeding primary to this empty backup):
        install the shipped state point whole (rows, the engine's meta and
        the exactly-once ledger), so the REPLICA_HELLO that follows
        validates against an exact copy. Whatever the spare booted with is
        a placeholder: its keys are evicted and the seed's adopted, with
        the seed's key range and shard. A seed is refused once a stream is
        attached: a seed is how a spare becomes a backup, never a way to
        rewrite a live one."""
        from ps_tpu_torch.elastic.migrate import decode_row

        if extra.get("kind") != "dense":
            return (f"seed kind {extra.get('kind')!r} does not match "
                    f"this dense service")
        eng = self._engine
        meta = dict(extra.get("meta") or {})
        if int(meta.get("num_workers", eng.num_workers)) != eng.num_workers:
            return (f"seed is for num_workers={meta.get('num_workers')}, "
                    f"this spare runs {eng.num_workers} — staleness "
                    f"semantics would differ")
        per: Dict[int, dict] = {}
        for name, v in (tensors or {}).items():
            i, _, rest = name.partition("/")
            per.setdefault(int(i), {})[rest] = v
        rows = list(extra.get("rows") or [])
        with eng._lock:
            if self.role != "backup":
                return f"only a backup accepts a seed (role={self.role})"
            if self._replica_attached:
                return ("seed refused: a replication stream is already "
                        "attached")
            booted = sorted(eng._params)
            if booted:
                with self._ranked("evict", keys=booted):
                    eng.evict_keys(booted)
            keys = []
            for i, re_ in enumerate(rows):
                row = decode_row(per.get(i, {}), re_)
                self._adopt(row["key"], row)
                keys.append(row["key"])
            self._key_order = sorted(keys)
            self.shard = extra.get("shard")
            self.num_shards = extra.get("num_shards")
            with self._ranked("meta", meta=meta):
                eng._load_checkpoint_meta(meta)
            self._applied = {int(w): int(n) for w, n
                             in (extra.get("applied") or {}).items()}
            self._applied_pseq = {
                int(w): {k: (tk[0], int(tk[1])) for k, tk in toks.items()}
                for w, toks in (extra.get("tokens") or {}).items()}
            self._invalidate_reads()
            self._birth = freshness.birth_record()
            self._admit_sync(locked=True)
        obs.record_event("replica_seeded", keys=len(keys),
                         version=eng.version)
        logging.getLogger(__name__).info(
            "seeded as backup: %d key(s) at version %d", len(keys),
            eng.version)
        return None


def serve_async(store, port: int = 0, bind: str = "127.0.0.1",
                shard: Optional[int] = None,
                num_shards: Optional[int] = None,
                ckpt_root: Optional[str] = None,
                backup: bool = False,
                native_loop: Optional[bool] = None,
                loop_threads: Optional[int] = None,
                shm: Optional[bool] = None) -> AsyncPSService:
    """Expose an initialized async KVStore to remote worker processes.

    Each server process calls this after ``store.init(...)``; workers join
    with :func:`connect_async`. Returns the running service (``.port``,
    ``.stop()``). One server: ``store.init(params)``. Server ``s`` of
    ``N``: ``store.init(shard_tree(params, s, N))`` and
    ``serve_async(store, shard=s, num_shards=N)``.

    ``native_loop`` (env ``PS_VAN_NATIVE_LOOP``) serves through the native
    epoll loop on ``loop_threads`` native threads (env
    ``PS_VAN_LOOP_THREADS``); ``shm`` (env ``PS_SHM``, on by default here)
    accepts the workers' shared-memory lane offers.

    ``backup=True`` starts the service as a backup: it refuses worker
    traffic and follows a primary's replication stream until promoted
    (:class:`~ps_tpu_torch.replica.PromotionWatch`, or ``svc.promote()``).
    The primary calls ``svc.attach_backup(host, port, ack="sync"|"async",
    window=...)`` before admitting workers; both start from the same
    initial params (or a common checkpoint). Parameters and optimizer
    state stay on the engine's device in both processes.

    A store across ranks (its mesh spans k processes of one group) is
    served by every rank calling this with the same arguments: rank 0
    gets the service, which sends each engine call to the other ranks as
    an op of its stream (``backends/op_stream.py``); ranks 1..k-1 get
    their follower (an ``OpStream`` running on a thread), whose
    ``join()`` or ``stop()`` returns at rank 0's ``stop()``. Workers see
    rank 0's ``host:port``."""
    ops = OpStream.over(store)
    if ops is not None and not ops.leader:
        return ops.start()
    return AsyncPSService(store, port=port, bind=bind, shard=shard,
                          num_shards=num_shards, ckpt_root=ckpt_root,
                          shm=shm, backup=backup, native_loop=native_loop,
                          loop_threads=loop_threads, ops=ops)


def connect_async(uri: Optional[str], worker: int, params_like,
                  bucket_bytes: Optional[int] = None,
                  pool_size: Optional[int] = None,
                  compress=None, writev: Optional[bool] = None,
                  shm: Optional[bool] = None,
                  shm_bytes: Optional[int] = None,
                  failover_timeout: Optional[float] = None,
                  coordinator=None,
                  aggregator: Optional[str] = None,
                  read_staleness: Optional[int] = None,
                  pull_cache: Optional[bool] = None) -> "RemoteAsyncWorker":
    """Join a cross-process async job as worker ``worker``.

    ``uri`` is ``host:port`` of the :func:`serve_async` process, or
    ``h0:p0,h1:p1,...`` naming every server of an N-server partition;
    ``params_like`` has the model's parameter structure (it validates the
    partition and rebuilds pulled params). Pulled params are placed on
    the device of ``params_like``'s first tensor, else on ``cuda:0``
    (which raises without a GPU: build ``params_like`` on the CPU to run
    there).

    ``bucket_bytes`` switches to the bucketed, pipelined transport (fusion
    buckets striped over ``pool_size`` connections a server; enables
    :meth:`RemoteAsyncWorker.push_pull_async`). None keeps the serial
    transport, one frame a server a cycle.

    ``compress`` picks a gradient codec for the pushes (``compress/``): a
    name ('cast16', 'int8', 'topk') or a spec such as ``{"codec": "int8",
    "min_bytes": 65536, "pull": True}``; ``pull`` also compresses the
    bucketed pulls' return path (topk refused there: its residuals live
    at the sender). int8's seed defaults to the worker id. ``shm`` (env
    ``PS_SHM``) offers every connection the same-host shared-memory lane,
    rings of ``shm_bytes`` (env ``PS_SHM_BYTES``, 16 MiB) a direction; a
    refused offer keeps TCP.

    Replica sets: each shard's entry may list its replicas separated by
    ``|``, the primary first: ``"h0:p0|b0:q0,h1:p1|b1:q1"``. When a
    primary dies the worker retries against the set, waiting out the
    backup's promotion for up to ``failover_timeout`` seconds (env
    ``PS_FAILOVER_TIMEOUT_MS``, 10 s), and its (nonce, seq)-tagged pushes
    apply exactly once at the new primary.

    The read path (:meth:`RemoteAsyncWorker.read_all`): ``read_staleness``
    (env ``PS_READ_STALENESS``, 0) is how many versions a replica's reply
    may trail the newest version this worker knows of its primary; reads
    rotate over each shard's replica set and a reply past the bound falls
    back toward the primary. ``pull_cache`` (env ``PS_PULL_CACHE``, off)
    keeps each shard's last read until a version watcher (REPLICA_STATE
    at ``PS_HEARTBEAT_INTERVAL_MS``) or a reply shows it moved past the
    bound; the next read then revalidates with a conditional READ
    (``PS_READ_CONDITIONAL``, on) or refetches.

    Two-level aggregation: ``aggregator="host:port"`` routes this worker's
    whole data plane through its host group's
    :class:`~ps_tpu_torch.backends.aggregator.AggregatorService`: the
    group's pushes pre-reduce there and go upstream once a round, its
    pulls and READs share one upstream fetch a round. ``uri`` still names
    the shards: if the aggregator dies, the worker degrades to the flat
    worker-to-shard path without a restart, keeping its dedup identity, so
    a replay of a push the aggregator already forwarded is acked unapplied.

    Elastic membership: ``coordinator="host:port"`` (env
    ``PS_COORD_URI``) in place of ``uri``: the worker fetches the shard
    table from the coordinator (waiting until the registered servers
    cover this model's keys), dials the shards it names, and fetches it
    again and re-routes whenever a rebalance moves keys under it, with
    no restart and no global pause. The same poll names the aggregator
    registered for this host (``socket.gethostname()``): the worker
    dials it unless ``aggregator`` is given, after a short probe
    (``PS_AGG_PROBE_MAX_WAIT_MS``, 200 ms) that sends it to the flat path
    when the entry is stale.
    """
    table = None
    discovered = False
    if coordinator is not None:
        from ps_tpu_torch.elastic import member

        want, _ = keymod.flatten_with_keys(params_like)
        view: dict = {}
        table = member.fetch_table(coordinator, cover=want, view_out=view)
        addrs, replica_sets = table.addrs(), table.replica_sets()
        if aggregator is None:
            import socket

            # the coordinator's grouping: workers of a host share the
            # aggregator registered under its name (none: flat). The map
            # came with the table's poll
            aggregator = (view.get("aggregators") or {}).get(
                socket.gethostname())
            discovered = aggregator is not None
    elif uri is None:
        raise ValueError("connect_async needs a server uri or a "
                         "coordinator address")
    else:
        addrs, replica_sets = parse_replica_uri(uri)

    def dial(agg):
        return RemoteAsyncWorker.connect_many(
            addrs, worker, params_like, bucket_bytes=bucket_bytes,
            pool_size=pool_size, compress=compress, writev=writev, shm=shm,
            shm_bytes=shm_bytes, replica_sets=replica_sets,
            failover_timeout=failover_timeout, coordinator=coordinator,
            table=table, aggregator=agg, read_staleness=read_staleness,
            pull_cache=pull_cache)

    if discovered:
        # the table keeps a crashed aggregator's entry until a replacement
        # registers (an aggregator owns no keys): a new worker of that
        # host joins flat instead of failing its connect. The probe's
        # short budget keeps a stale entry from stalling every join; the
        # second except covers an aggregator dying between probe and dial
        from ps_tpu_torch.config import env_float

        ahost, aport = str(aggregator).rsplit(":", 1)
        probe_wait = env_float("PS_AGG_PROBE_MAX_WAIT_MS", 200.0,
                               lo=0.0) / 1e3
        try:
            probe = tv.Channel.connect(ahost, int(aport), timeout_ms=1000,
                                       retries=2, max_wait_s=probe_wait)
            probe.close()
        except (tv.VanError, OSError) as e:
            logging.getLogger(__name__).warning(
                "discovered aggregator %s is not answering (%s) — "
                "joining flat", aggregator, e)
            return dial(None)
        try:
            return dial(aggregator)
        except (ServerFailureError, tv.VanError, OSError) as e:
            logging.getLogger(__name__).warning(
                "discovered aggregator %s is not serving (%s) — "
                "joining flat", aggregator, e)
            return dial(None)
    return dial(aggregator)


class CheckpointRoundError(RuntimeError):
    """A checkpoint phase was refused by at least one server; ``oks`` holds
    the extras of the servers that accepted it (a failed pause still hands
    over the tokens needed to resume them)."""

    def __init__(self, message: str, oks: Dict[int, dict]):
        super().__init__(message)
        self.oks = oks


class CheckpointRoundsMixin:
    """One phase of the coordinated checkpoint, fanned to every server.
    ``per_server`` merges server-specific fields (the pause tokens) into
    that server's payload."""

    def _checkpoint_round(self, payload_extra: dict,
                          per_server: Optional[Dict[int, dict]] = None
                          ) -> Dict[int, dict]:
        payloads = {}
        for i in range(len(self._chs)):
            extra = dict(payload_extra)
            if per_server and i in per_server:
                extra.update(per_server[i])
            payloads[i] = tv.encode(tv.CHECKPOINT, self.worker, None,
                                    extra=extra)
        msgs = self._fanout(payloads)
        out, errs = {}, {}
        for i, msg in msgs.items():
            kind, _, _, extra = tv.decode(msg)
            if kind != tv.OK:
                errs[i] = extra.get("error")
            else:
                out[i] = extra
        if errs:
            i, err = sorted(errs.items())[0]
            raise CheckpointRoundError(
                f"server {i} checkpoint {payload_extra.get('phase')} "
                f"failed: {err}", out)
        return out

    def _ckpt_tokens(self, paused: Dict[int, dict]) -> Dict[int, dict]:
        return {i: {"token": x["token"]} for i, x in paused.items()
                if "token" in x}

    def checkpoint_resume_force(self) -> None:
        """Operator recovery: force-resume every server after a coordinator
        died between pause and resume. Never while a checkpoint saves."""
        self._checkpoint_round({"phase": "resume", "force": True})


class PendingCycle:
    """Handle of one background push-then-pull cycle
    (:meth:`RemoteAsyncWorker.push_pull_async`); :meth:`wait` blocks until
    the fresh params are in and returns them."""

    def __init__(self, stats: Optional[TransportStats] = None):
        self._evt = threading.Event()
        self._params = None
        self._exc: Optional[BaseException] = None
        self._observed = False  # failure delivered via wait() at least once
        self._stats = stats

    def _resolve(self, params) -> None:
        self._params = params
        self._evt.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._evt.set()

    def done(self) -> bool:
        return self._evt.is_set()

    def wait(self, timeout: Optional[float] = None):
        t0 = time.perf_counter()
        # a child of the caller's open span, if it traces one
        with obs.tracer().child("flush_wait", cat="worker"):
            done = self._evt.wait(timeout)
        if not done:
            raise TimeoutError("transport cycle still in flight")
        if self._stats is not None:
            self._stats.record_blocked(time.perf_counter() - t0)
        if self._exc is not None:
            self._observed = True  # surfaced once; flush() won't re-raise
            raise self._exc
        return self._params


def _worker_device(params_like) -> torch.device:
    kv, _ = keymod.flatten_with_keys(params_like)
    leaf = next((v for v in kv.values() if isinstance(v, torch.Tensor)),
                None)
    device = leaf.device if leaf is not None else torch.device("cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a remote async worker places its params on cuda:0 and "
                "torch finds no GPU; build params_like on the CPU to run "
                "there on purpose")
        if device.index is None:
            device = torch.device("cuda", 0)
    return device


class RemoteAsyncWorker(BucketedTransportMixin, CheckpointRoundsMixin):
    """A worker node of the cross-process async PS.

    Takes gradients on its own device against the params it last pulled,
    and exchanges per-owner subtrees with every server in one concurrent
    round a cycle. ``version`` sums the per-server versions (``versions``).
    A failed server connection raises :class:`ServerFailureError` naming
    the server, unless its replica set has a member to fail over to.

    Transport: with ``bucket_bytes=None`` one frame a server a cycle; with
    ``bucket_bytes`` the payloads are cut into fusion buckets
    (:class:`~ps_tpu_torch.backends.common.BucketPlan`) striped over
    ``pool_size`` connections a server, :meth:`push_pull_async` runs a
    whole cycle in the background, and :meth:`flush` restores serial
    semantics. Either way each server applies whole trees and records the
    same event order, so the math is the same.

    Reads (:meth:`read_all`) run on channels of their own, one per
    replica-set member, so they may be called from threads beside the
    training loop.
    """

    _failure_noun = "async PS server"

    def __init__(self, host: str, port: int, worker: int, params_like,
                 bucket_bytes: Optional[int] = None,
                 pool_size: Optional[int] = None, compress=None,
                 writev: Optional[bool] = None, shm: Optional[bool] = None,
                 shm_bytes: Optional[int] = None,
                 read_staleness: Optional[int] = None,
                 pull_cache: Optional[bool] = None):
        self._init_multi([(host, int(port))], worker, params_like,
                         bucket_bytes=bucket_bytes, pool_size=pool_size,
                         compress=compress, writev=writev, shm=shm,
                         shm_bytes=shm_bytes, read_staleness=read_staleness,
                         pull_cache=pull_cache)

    @classmethod
    def connect_many(cls, addrs: Sequence[Tuple[str, int]], worker: int,
                     params_like, bucket_bytes: Optional[int] = None,
                     pool_size: Optional[int] = None, compress=None,
                     writev: Optional[bool] = None,
                     shm: Optional[bool] = None,
                     shm_bytes: Optional[int] = None,
                     replica_sets=None,
                     failover_timeout: Optional[float] = None,
                     coordinator=None, table=None,
                     aggregator: Optional[str] = None,
                     agg_role: bool = False,
                     read_staleness: Optional[int] = None,
                     pull_cache: Optional[bool] = None
                     ) -> "RemoteAsyncWorker":
        self = cls.__new__(cls)
        self._init_multi(list(addrs), worker, params_like,
                         bucket_bytes=bucket_bytes, pool_size=pool_size,
                         compress=compress, writev=writev, shm=shm,
                         shm_bytes=shm_bytes, replica_sets=replica_sets,
                         failover_timeout=failover_timeout,
                         coordinator=coordinator, table=table,
                         aggregator=aggregator, agg_role=agg_role,
                         read_staleness=read_staleness,
                         pull_cache=pull_cache)
        return self

    def _init_multi(self, addrs: List[Tuple[str, int]], worker: int,
                    params_like, bucket_bytes=None, pool_size=None,
                    compress=None, writev=None, shm=None,
                    shm_bytes=None, replica_sets=None,
                    failover_timeout=None, coordinator=None, table=None,
                    aggregator=None, agg_role=False,
                    read_staleness=None, pull_cache=None) -> None:
        self.worker = worker
        # two-level aggregation: with an aggregator this worker dials only
        # it (one "shard" advertising the whole tree) and remembers the
        # flat shard topology, so the aggregator's death degrades it to the
        # flat path (_degrade_to_flat). ``agg_role`` marks the aggregator's
        # own upstream client, whose id lies at or past AGG_WORKER_BASE
        self._agg_fallback = None
        self._agg_uri = aggregator
        if aggregator is not None:
            self._agg_fallback = {"addrs": [tuple(a) for a in addrs],
                                  "replica_sets": replica_sets,
                                  "table": table}
            ahost, aport = str(aggregator).rsplit(":", 1)
            addrs = [(ahost, int(aport))]
            replica_sets = None
            table = None  # the aggregator routes now
        self._agg_role = bool(agg_role)
        # elastic membership: with a coordinator the shard table gives the
        # addresses and replica sets, and a 'moved' refusal fetches a newer
        # table (_on_table_moved) instead of failing the job
        self._coord = coordinator
        self._table = table
        # reconnect() reruns this on a live worker: retire the old
        # telemetry reporter before starting another
        old_rep = getattr(self, "_tel_reporter", None)
        if old_rep is not None:
            old_rep.close()
        self._tel_reporter = None
        self.device = _worker_device(params_like)
        kv, self._treedef = keymod.flatten_with_keys(params_like)
        # empty placeholders on the worker's device, not the tensors:
        # reconnect() needs keys, structure and device only
        self._kv_like = {k: torch.empty(0, device=self.device) for k in kv}
        self._key_order = sorted(kv)
        self._addrs = [tuple(a) for a in addrs]
        n = len(addrs)
        self._chs: List[tv.Channel] = []
        self._owner: Dict[str, int] = {}  # key -> index into addrs
        self.versions: List[int] = [0] * n
        self.num_workers: Optional[int] = None
        # wire bytes: request payloads out, reply frames in
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.collective_bytes = 0  # no collective on the van path
        self._bytes_lock = threading.Lock()  # _fanout runs _request in threads
        self._init_transport(bucket_bytes, pool_size, compress=compress,
                             writev=writev, shm=shm, shm_bytes=shm_bytes)
        # each shard's replica set and the promotion-wait budget (singleton
        # sets: no failover)
        self._init_failover(replica_sets, failover_timeout)
        self._init_read_path(read_staleness, pull_cache)
        if self.compress and self.compress.get("pull") \
                and self.compress.get("codec") == "topk":
            raise ValueError(
                "topk cannot compress the pull return path: its error-"
                "feedback residuals live at the sender, and a server has "
                "no per-worker residual state — dropped params mass would "
                "be lost forever. Use cast16/int8 for pull compression.")
        try:
            self._connect_and_validate(kv)
        except Exception:
            for ch in self._chs:
                ch.close()
            raise
        self._params = None
        # servers that own at least one key: the only ones worth a trip
        self._active = sorted(set(self._owner.values()))
        self._pool = None
        if len(self._active) > 1:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=len(self._active))
        if self.bucket_bytes is not None:
            try:
                self._open_pumps(self._active)
            except Exception:
                self._close_transport()
                for ch in self._chs:
                    ch.close()
                raise
        if coordinator is not None:
            # the worker's op, flush and wire histograms are the step
            # breakdown's worker phases: they go to the coordinator too
            # (telemetry only, no registration); a failure here leaves the
            # data plane alone
            from ps_tpu_torch.config import env_flag

            if env_flag("PS_TELEMETRY", True):
                try:
                    from ps_tpu_torch.elastic.member import TelemetryReporter
                    from ps_tpu_torch.obs.collector import collect_telemetry

                    self._tel_reporter = TelemetryReporter(
                        coordinator, f"worker:{worker}",
                        # self.transport at call time: a re-dial restores it
                        lambda: collect_telemetry(self.transport))
                except Exception:
                    logging.getLogger(__name__).debug(
                        "worker telemetry reporter failed to start",
                        exc_info=True)

    def _connect_and_validate(self, kv) -> None:
        n = len(self._addrs)
        for i in range(n):
            ch, extra = self._hello_any(i)
            host, port = self._addrs[i]
            self._chs.append(ch)
            skeys = sorted(extra["keys"])
            ns = extra.get("num_shards")
            if ns is not None:
                if int(ns) != n:
                    raise ValueError(
                        f"server {i} ({host}:{port}) is shard "
                        f"{extra['shard']}/{ns} but this worker dialed "
                        f"{n} server(s)")
                expected = sorted(
                    k for k in self._key_order
                    if keymod.shard_for_key(k, n) == int(extra["shard"]))
                if skeys != expected:
                    raise ValueError(
                        f"server {i} key range does not match the "
                        f"shard_for_key assignment for shard "
                        f"{extra['shard']}")
            for k in skeys:
                if k not in kv:
                    raise ValueError(
                        f"server {i} owns key {k!r} absent from this "
                        f"worker's params structure")
                if k in self._owner:
                    raise ValueError(f"key {k!r} claimed by servers "
                                     f"{self._owner[k]} and {i}")
                self._owner[k] = i
            self.versions[i] = int(extra["version"])
            # the job's worker count is the servers' truth, and they agree
            nw = int(extra["num_workers"])
            if self.num_workers is None:
                self.num_workers = nw
            elif nw != self.num_workers:
                raise ValueError(
                    f"servers disagree on num_workers ({self.num_workers} "
                    f"vs {nw} at server {i})")
            # the topology checked out: offer this (serial and control)
            # channel the same-host shm lane; a refusal keeps TCP
            self._chs[i] = self._maybe_upgrade(ch)
        missing = [k for k in self._key_order if k not in self._owner]
        if missing:
            raise ValueError(f"no server owns keys {missing[:3]}"
                             f"{'...' if len(missing) > 3 else ''}")
        if not self._agg_role and not (0 <= self.worker < self.num_workers):
            raise ValueError(f"worker id {self.worker} out of range for a "
                             f"{self.num_workers}-worker job")

    @property
    def version(self) -> int:
        """Whole-subtree applies summed over the servers."""
        return sum(self.versions)

    def _validate_failover_hello(self, i: int, extra: dict) -> Optional[str]:
        """A promoted replica must advertise exactly the key range the
        worker validated for this shard at connect time."""
        expected = sorted(k for k, o in self._owner.items() if o == i)
        if sorted(extra.get("keys") or []) != expected:
            return (f"replica of server {i} advertises a different key "
                    f"range than the shard the worker validated")
        nw = extra.get("num_workers")
        if nw is not None and self.num_workers is not None \
                and int(nw) != self.num_workers:
            return (f"replica of server {i} says num_workers={nw}, "
                    f"job runs {self.num_workers}")
        return None

    # -- two-level aggregation: the degrade to the flat path ------------------

    # -- elastic membership: the table's re-route --------------------------------

    def _on_table_moved(self, err, deadline: float) -> None:
        """A shard refused 'moved' (or a pull came back short): fetch a
        shard table newer than the one this worker routes by and rebuild
        the transport on it, within the failover deadline. It converges:
        every committed move publishes a higher epoch."""
        from ps_tpu_torch.elastic import member

        if self._coord is None:
            super()._on_table_moved(err, deadline)  # raises
        min_epoch = self._table.epoch if self._table is not None else None
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise TableMovedError(
                    f"shard table never converged before the failover "
                    f"deadline: {err}",
                    table_epoch=getattr(err, "table_epoch", 0)) from err
            try:
                table = member.fetch_table(self._coord, cover=self._key_order,
                                           min_epoch=min_epoch,
                                           timeout=min(budget, 10.0))
            except TimeoutError:
                # the coordinator's publish may lag the refusal: poll on;
                # the deadline above is the only way out
                continue
            try:
                self._adopt_table(table)
                return
            except (ValueError, tv.VanError, ServerFailureError):
                # the table raced a shard's own cutover (its HELLO
                # disagrees for a moment): wait for the shards to settle
                min_epoch = table.epoch - 1
                time.sleep(0.05)

    def _adopt_table(self, table) -> None:
        """Rebuild the whole transport (channels, owners, replica sets,
        pumps) on a new shard table, keeping the transport's identity as
        :meth:`reconnect` does, and the dedup nonce and push seq too: a
        re-route is not a new incarnation, the op that was refused replays
        with its original token right after this."""
        old_epoch = self._table.epoch if self._table is not None else None
        obs.record_event("table_reroute", worker=self.worker,
                         old_epoch=old_epoch, epoch=table.epoch,
                         shards=len(table.shards))
        self.transport.record_table_reroute()
        saved = self._saved_transport_state()
        nonce, push_seq = self._transport_nonce, self._push_seq
        self._close_transport()
        for ch in self._chs:
            ch.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        try:
            self._init_multi(
                table.addrs(), self.worker,
                keymod.unflatten(self._treedef, self._kv_like,
                                 self._key_order),
                bucket_bytes=self.bucket_bytes, pool_size=self.pool_size,
                compress=self.compress, writev=self.writev, shm=self.shm,
                shm_bytes=self.shm_bytes,
                replica_sets=table.replica_sets(),
                failover_timeout=self.failover_timeout,
                coordinator=self._coord, table=table,
                agg_role=self._agg_role,
                read_staleness=self.read_staleness,
                pull_cache=self.pull_cache)
        finally:
            self._restore_transport_state(saved)
            self._transport_nonce, self._push_seq = nonce, push_seq
        logging.getLogger(__name__).warning(
            "worker %d re-routed to shard table epoch %d (%d shard(s))",
            self.worker, table.epoch, len(table.shards))

    def _on_server_lost(self, err: ServerFailureError,
                        deadline: float) -> None:
        """A shard failed with no replica to cycle to. When that shard is
        this worker's aggregator, degrade to the flat topology remembered
        at connect time; the op that failed is then retried under its
        original (nonce, seq) token, which a shard that applied its merged
        form recorded as this member's, so it is acked, not applied
        again. A worker with a coordinator polls its table and adopts it
        until the slot serves again (the member recovered, or a
        replacement took its slot over) within the failover deadline,
        keeping its nonce and push seq; any other loss raises."""
        if self._agg_fallback is not None:
            self._degrade_to_flat(err)
            return
        if self._coord is None:
            raise err
        from ps_tpu_torch.elastic import member

        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise err
            # back off first: a refusing member is usually mid-promotion,
            # and the rebuild below is a full re-dial
            time.sleep(min(0.25, budget))
            try:
                table = member.fetch_table(self._coord, cover=self._key_order,
                                           timeout=min(budget, 10.0))
                self._adopt_table(table)
                return
            except (TimeoutError, ValueError, tv.VanError,
                    ServerFailureError):
                continue

    def _degrade_to_flat(self, cause: BaseException) -> None:
        """Rebuild the whole transport against the remembered shards,
        keeping the transport's identity: the counters, the epoch streams,
        the codec's residuals and above all the dedup nonce and the push
        seq (a degrade is not a new incarnation: the failed op replays
        with its original token right after this)."""
        fb = self._agg_fallback
        obs.record_event("agg_degrade", worker=self.worker,
                         shards=len(fb["addrs"]), cause=repr(cause))
        self.transport.record_agg_degrade()
        saved = self._saved_transport_state()
        nonce, push_seq = self._transport_nonce, self._push_seq
        self._close_transport()
        for ch in self._chs:
            ch.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        try:
            self._init_multi(
                fb["addrs"], self.worker,
                keymod.unflatten(self._treedef, self._kv_like,
                                 self._key_order),
                bucket_bytes=self.bucket_bytes, pool_size=self.pool_size,
                compress=self.compress, writev=self.writev, shm=self.shm,
                shm_bytes=self.shm_bytes, replica_sets=fb["replica_sets"],
                failover_timeout=self.failover_timeout,
                coordinator=self._coord, table=fb["table"],
                read_staleness=self.read_staleness,
                pull_cache=self.pull_cache)
        finally:
            self._restore_transport_state(saved)
            self._transport_nonce, self._push_seq = nonce, push_seq
        logging.getLogger(__name__).warning(
            "worker %d: aggregator lost (%s) — degraded to the flat "
            "worker→shard path (%d shard(s))", self.worker, cause,
            len(self._addrs))

    # -- protocol -------------------------------------------------------------

    def _request(self, i: int, payload):
        try:
            reply = request_payload(self._chs[i], payload)
        except tv.VanError as e:
            host, port = self._addrs[i]
            raise ServerFailureError(
                f"async PS server {i} ({host}:{port}) failed mid-job: {e}",
                server=i) from e
        with self._bytes_lock:
            self.bytes_pushed += payload_nbytes(payload)
            self.bytes_pulled += len(reply)
        return reply

    def _fanout(self, payloads: Dict[int, Any]) -> Dict[int, memoryview]:
        """One concurrent round, each server its request. Every future is
        waited for before an error propagates: a still-running request
        would otherwise drive a channel that a later call drives too."""
        if self._pool is None or len(payloads) == 1:
            return {i: self._request(i, p) for i, p in payloads.items()}
        import concurrent.futures

        futs = {i: self._pool.submit(self._request, i, p)
                for i, p in payloads.items()}
        concurrent.futures.wait(futs.values())
        return {i: f.result() for i, f in futs.items()}

    def _merge_params(self, msgs: Dict[int, memoryview]) -> Any:
        host: Dict[str, np.ndarray] = {}
        for i, msg in msgs.items():
            kind, _, tensors, extra = tv.decode(msg)
            if kind != tv.OK:
                raise self._reply_error(i, extra)
            self.versions[i] = int(extra["version"])
            host.update(tensors)
        return self._merge_host_params(host)

    def _merge_host_params(self, host: Dict[str, np.ndarray]) -> Any:
        missing = [k for k in self._key_order if k not in host]
        if missing:
            # a pull over every dialed shard came back short: on a worker
            # with a coordinator, keys moved to a shard it does not dial
            # yet (re-fetch the table and pull again: reads are idempotent)
            if self._coord is not None:
                raise TableMovedError(
                    f"pull returned no value for {missing[:3]} — the shard "
                    f"table moved during the pull")
            raise RuntimeError(f"pull returned no value for {missing[:3]}")
        kv = stage_to_device(host, self.device, stats=self.transport)
        self._params = keymod.unflatten(self._treedef, kv, self._key_order)
        return self._params

    def _host_grads(self, grads, copy: bool = False
                    ) -> Dict[str, np.ndarray]:
        """Flatten one gradient tree to host arrays once per logical push
        (a CUDA tree through pinned memory, the copies waited for)."""
        kv, _ = keymod.flatten_with_keys(grads)
        return stage_to_host(kv, stats=self.transport, copy=copy)

    def _split_kv(self, kv: Dict[str, np.ndarray]
                  ) -> Dict[int, Dict[str, np.ndarray]]:
        out: Dict[int, Dict[str, np.ndarray]] = {i: {} for i in self._active}
        for k, v in kv.items():
            out[self._owner[k]][k] = v
        return out

    def pull_all(self) -> Any:
        """Fetch the current params (each server records this worker's
        snapshot of its subtree)."""
        with self._op("pull") as sp:
            if self.bucket_bytes is not None:
                self.flush()
                return self._with_failover(
                    lambda: self._merge_host_params(
                        self._pull_buckets(tc=sp.wire())))
            extra = self._tc_extra(None, sp)
            return self._with_failover(
                lambda: self._merge_params(self._fanout({
                    i: tv.encode(tv.PULL, self.worker, None, extra=extra)
                    for i in self._active})))

    def push_all(self, grads, members: Optional[dict] = None,
                 members_tc: Optional[dict] = None) -> None:
        """Push a gradient tree; each owner applies its subtree at once
        with the DC-ASGD correction against this worker's last pull. The
        push carries this worker's (nonce, seq) dedup token, assigned once
        and reused by any failover retry, so a shard that already applied
        it (directly, or through its dead primary's stream) acks it
        without applying again. ``members`` (an aggregator's merged push
        only) carries the members' own tokens, so the shards' ledger
        covers a degraded member's flat replay too; ``members_tc`` their
        trace contexts, which the shards name on their apply spans."""
        kv = self._host_grads(grads)
        pseq = self._next_push_seq()
        with self._op("push") as sp:
            tc = sp.wire()
            if self.bucket_bytes is not None:
                self.flush()
                self._with_failover(lambda: self._push_buckets_sync(
                    self._split_kv(kv), pseq=pseq, tc=tc, members=members,
                    members_tc=members_tc))
                return

            def once():
                msgs = self._fanout({
                    i: self._encode_serial_push(tv.PUSH, sub, pseq=pseq,
                                                tc=tc, members=members,
                                                members_tc=members_tc)
                    for i, sub in self._split_kv(kv).items()})
                for i, msg in msgs.items():
                    kind, _, _, extra = tv.decode(msg)
                    if kind != tv.OK:
                        raise self._reply_error(i, extra)
                    self.versions[i] = int(extra["version"])

            self._with_failover(once)

    def push_pull(self, grads, members: Optional[dict] = None,
                  members_tc: Optional[dict] = None) -> Any:
        """push_all + pull_all in one round trip a server, all servers in
        flight together (the async cycle). ``members`` and ``members_tc``
        as in :meth:`push_all`."""
        kv = self._host_grads(grads)
        pseq = self._next_push_seq()
        with self._op("push_pull") as sp:
            tc = sp.wire()
            if self.bucket_bytes is not None:
                self.flush()  # a cycle racing a serial call would reorder

                def once_bucketed():
                    self._push_buckets_sync(self._split_kv(kv), pseq=pseq,
                                            tc=tc, members=members,
                                            members_tc=members_tc)
                    return self._merge_host_params(self._pull_buckets(tc=tc))

                return self._with_failover(once_bucketed)
            return self._with_failover(
                lambda: self._merge_params(self._fanout({
                    i: self._encode_serial_push(tv.PUSH_PULL, sub, pseq=pseq,
                                                tc=tc, members=members,
                                                members_tc=members_tc)
                    for i, sub in self._split_kv(kv).items()})))

    # -- bucketed, pipelined transport (worker half) --------------------------

    def _encode_serial_push(self, kind: int, sub: Dict[str, np.ndarray],
                            pseq: Optional[int] = None, tc=None,
                            members: Optional[dict] = None,
                            members_tc: Optional[dict] = None):
        """One serial push frame, compressed by the policy (the packed keys
        in ``extra["enc"]``), with the (nonce, seq) dedup token, for a
        merged push the members' tokens (and their trace contexts when
        given), and the op's trace context ``tc`` when sampled; zero copy
        parts with ``writev``."""
        sub, enc = self._encode_push_tree(sub)
        extra = {}
        if enc:
            extra["enc"] = enc
        if pseq is not None:
            extra["pseq"] = pseq
            extra["pnonce"] = self._transport_nonce
        if members:
            extra["members"] = members
        if members_tc:
            extra["members_tc"] = members_tc
        if tc is not None:
            extra[obs.WIRE_KEY] = tc
        extra = extra or None
        if self.writev:
            return tv.encode_parts(kind, self.worker, sub, extra)
        return tv.encode(kind, self.worker, sub, extra)

    def _require_bucketed(self) -> None:
        if self.bucket_bytes is None:
            raise RuntimeError(
                "this worker uses the serial transport — connect with "
                "bucket_bytes=... (e.g. 4 << 20) to enable the bucketed/"
                "pipelined path")

    def _push_buckets_sync(self, by_owner: Dict[int, Dict[str, np.ndarray]],
                           pseq: Optional[int] = None, tc=None,
                           members: Optional[dict] = None,
                           members_tc: Optional[dict] = None) -> None:
        """Cut each owner's subtree into buckets, stripe them over the
        pool, wait for every ack and adopt the committed versions. The
        server sees one whole-tree apply, as for a serial PUSH; every
        bucket carries the merged push's ``members`` when given and the
        op's trace context ``tc`` when sampled."""
        self._push_epoch += 1
        epoch = self._push_epoch
        futs: List[Tuple[int, Any]] = []
        for i, sub in by_owner.items():
            # the codec pass first: what buckets is each key's wire form
            sub, enc = self._encode_push_tree(sub)
            sub = {k: np.ascontiguousarray(v) for k, v in sub.items()}
            plan = BucketPlan.from_arrays(sub, self.bucket_bytes)
            pumps = self._pumps[i]
            enc_bucket = plan.bucket_encoder(self.writev)
            for b in range(plan.nbuckets):
                extra = {"epoch": epoch, "nonce": self._transport_nonce,
                         "pseq": pseq, "pnonce": self._transport_nonce,
                         "enc": enc}
                if members:
                    extra["members"] = members
                if members_tc:
                    extra["members_tc"] = members_tc
                if tc is not None:
                    extra[obs.WIRE_KEY] = tc
                payload = enc_bucket(tv.BUCKET_PUSH, self.worker, sub, b,
                                     extra=extra)
                futs.append((i, pumps[b % len(pumps)].submit(
                    payload, priority=self._bucket_submit_priority(b))))
        for i, fut in futs:
            reply = self._bucket_reply(i, fut)
            kind, _, _, extra = tv.decode(reply)
            self._release_frame(reply)  # extra is json-owned; frame done
            if kind != tv.OK:
                raise self._reply_error(i, extra)
            if extra.get("committed"):
                self.versions[i] = int(extra["version"])

    def _pull_buckets(self, tc=None) -> Dict[str, np.ndarray]:
        """Bucketed pull: bucket 0 snapshots each server's subtree and names
        the bucket count; the rest stream over the pool, front of the
        model first. Each reply is copied into its assembler and its
        buffer returned to the pool before the next borrow; keys the
        server packed (``pull`` compression) are decoded last. Every
        bucket carries the op's trace context ``tc`` when sampled."""
        self._pull_epoch += 1
        epoch = self._pull_epoch

        def _extra(b: int, **kw) -> dict:
            out = {"epoch": epoch, "bucket": b, **kw}
            if tc is not None:
                out[obs.WIRE_KEY] = tc
            return out

        first = {
            i: self._pumps[i][0].submit(tv.encode(
                tv.BUCKET_PULL, self.worker, None,
                extra=_extra(0, bucket_bytes=self.bucket_bytes,
                             compress=self._pull_compress_spec())))
            for i in self._active}
        kv: Dict[str, np.ndarray] = {}
        enc_keys: List[str] = []
        rest: List[Tuple[int, Any]] = []
        assemblers: Dict[int, BucketAssembler] = {}
        for i, fut in first.items():
            reply = self._bucket_reply(i, fut)
            kind, _, tensors, extra = tv.decode(reply)
            if kind != tv.OK:
                self._release_frame(reply)
                raise self._reply_error(i, extra)
            self.versions[i] = int(extra["version"])
            enc_keys.extend(extra.get("enc") or [])
            n = int(extra["nbuckets"])
            asm = BucketAssembler(epoch, n)
            done = asm.add(0, tensors["raw"], extra["slices"], epoch)
            self._release_frame(reply)  # the assembler copied it out
            if done:
                kv.update(asm.finish())
                continue
            assemblers[i] = asm
            pumps = self._pumps[i]
            for b in range(1, n):
                payload = tv.encode(tv.BUCKET_PULL, self.worker, None,
                                    extra=_extra(b))
                rest.append((i, pumps[b % len(pumps)].submit(
                    payload, priority=self._bucket_submit_priority(b))))
        for i, fut in rest:
            reply = self._bucket_reply(i, fut)
            kind, _, tensors, extra = tv.decode(reply)
            if kind != tv.OK:
                self._release_frame(reply)
                raise self._reply_error(i, extra)
            done = assemblers[i].add(int(extra["bucket"]), tensors["raw"],
                                     extra["slices"], epoch)
            self._release_frame(reply)
            if done:
                kv.update(assemblers[i].finish())
        return decode_tree(kv, enc_keys, stats=self.transport)

    def push_pull_async(self, grads) -> PendingCycle:
        """Start one whole transport cycle (bucketed push, then pull) in the
        background and return at once; the :class:`PendingCycle` resolves
        to the fresh params. Cycles serialize per worker, so waiting
        before the next gradient gives the serial step's params exactly."""
        self._require_bucketed()
        kv = self._host_grads(grads, copy=True)  # the caller may reuse grads
        pseq = self._next_push_seq()  # assigned now: the cycle reuses it
        pending = PendingCycle(self.transport)
        self._track_pending(pending)
        self._bg_executor().submit(self._run_cycle, kv, pseq, pending)
        return pending

    def _run_cycle(self, kv, pseq: int, pending: PendingCycle) -> None:
        t0 = time.perf_counter()
        try:
            with self._op("cycle", pseq=pseq) as sp:
                tc = sp.wire()

                def once():
                    self._push_buckets_sync(self._split_kv(kv), pseq=pseq,
                                            tc=tc)
                    return self._merge_host_params(self._pull_buckets(tc=tc))

                params = self._with_failover(once)
        except BaseException as e:
            pending._fail(e)
        else:
            pending._resolve(params)
        finally:
            self.transport.record_cycle(time.perf_counter() - t0)

    def stats(self) -> dict:
        """One server: its stats dict. Several: ``{"servers": [...],
        "version": total}``."""
        msgs = self._fanout({
            i: tv.encode(tv.STATS, self.worker, None) for i in self._active})
        extras = {i: tv.decode(msg)[3] for i, msg in msgs.items()}
        if len(self._chs) == 1:
            return extras[self._active[0]]
        return {"servers": [extras.get(i) for i in range(len(self._chs))],
                "version": sum(int(e.get("version", 0))
                               for e in extras.values())}

    def checkpoint_all(self, path: str) -> List[int]:
        """A coordinated, cross-shard-atomic checkpoint: **pause** (every
        server blocks new applies and reports its per-worker applied
        counts), **drain_to** (each server admits exactly the pushes in
        flight to it that reach the cross-shard maxima), **save** (each
        server writes ``path``, ``path/shard<i>`` when partitioned),
        **resume**. The saved state is a point every shard agrees on.
        Returns the per-server versions of the snapshot. A failed round
        still resumes the servers it paused."""
        tokens: Dict[int, dict] = {}
        try:
            try:
                paused = self._checkpoint_round({"dir": path,
                                                 "phase": "pause"})
            except CheckpointRoundError as e:
                tokens = self._ckpt_tokens(e.oks)
                raise
            tokens = self._ckpt_tokens(paused)
            targets: Dict[str, int] = {}
            for extra in paused.values():
                for w, n in extra.get("applied", {}).items():
                    targets[w] = max(targets.get(w, 0), int(n))
            lagging = any(
                int(extra.get("applied", {}).get(w, 0)) < n
                for extra in paused.values() for w, n in targets.items())
            if lagging:
                self._checkpoint_round({"dir": path, "phase": "drain_to",
                                        "targets": targets,
                                        "timeout": DRAIN_TO_TIMEOUT_S},
                                       per_server=tokens)
            saves = self._checkpoint_round({"dir": path, "phase": "save"},
                                           per_server=tokens)
        except BaseException:
            # resume the healthy servers, then surface the original failure
            try:
                self._checkpoint_round({"dir": path, "phase": "resume"},
                                       per_server=tokens)
            except Exception:
                pass
            raise
        self._checkpoint_round({"dir": path, "phase": "resume"},
                               per_server=tokens)
        return [int(saves[i]["version"]) for i in range(len(self._chs))]

    def reconnect(self, addrs: Optional[Sequence[Tuple[str, int]]] = None
                  ) -> None:
        """Dial every server again (at new addresses when given: restarted
        servers come back on new ports) and revalidate the partition. The
        wire counters, transport stats and epoch streams survive. A plain
        re-dial of an aggregated worker dials its aggregator again, the
        flat fallback kept; new addresses always mean the flat topology."""
        try:
            self.flush()
        except Exception:
            pass  # a dead server is why we reconnect
        obs.record_event("reconnect", worker=self.worker,
                         servers=len(self._addrs),
                         new_addrs=addrs is not None)
        saved = self._saved_transport_state()
        self._close_transport()
        for ch in self._chs:
            ch.close()  # dead or stale; no SHUTDOWN owed
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        fb = self._agg_fallback if addrs is None else None
        try:
            self._init_multi(
                list(addrs) if addrs is not None
                else (fb["addrs"] if fb is not None else self._addrs),
                self.worker,
                keymod.unflatten(self._treedef, self._kv_like,
                                 self._key_order),
                bucket_bytes=self.bucket_bytes, pool_size=self.pool_size,
                compress=self.compress, writev=self.writev, shm=self.shm,
                shm_bytes=self.shm_bytes,
                replica_sets=(None if addrs is not None
                              else fb["replica_sets"] if fb is not None
                              else self._replica_sets),
                failover_timeout=self.failover_timeout,
                coordinator=self._coord,
                table=(None if addrs is not None
                       else fb["table"] if fb is not None else self._table),
                aggregator=None if addrs is not None else self._agg_uri,
                agg_role=self._agg_role,
                read_staleness=self.read_staleness,
                pull_cache=self.pull_cache)
        finally:
            # the compressor too: topk's residuals are unsent gradient
            # mass and survive the re-dial
            self._restore_transport_state(saved)

    # -- the read path ------------------------------------------------------------

    def _init_read_path(self, read_staleness, pull_cache) -> None:
        """The worker's half of the read path: read channels spread over
        each shard's replica set (a staleness bound, the primary as the
        fallback), a snapshot cache invalidated by observed version bumps,
        and concurrent reads of a shard coalesced into one fetch."""
        from ps_tpu_torch.config import env_flag, env_float

        self._close_read_path()  # reconnect() runs _init_multi again
        # the staleness bound in seconds served ages are judged against,
        # and one ClockSync per shard toward its primary (where births are
        # stamped), fed by the version watcher's REPLICA_STATE round trips
        self.freshness_slo = env_float("PS_FRESHNESS_SLO", 0.5, lo=1e-3)
        self._read_clock: Dict[int, Any] = {}
        # a replica reply trailing the newest known version of its shard by
        # more than read_staleness is refused, and the read goes on toward
        # the primary
        self._init_read_rotation(read_staleness)
        # repeat reads at an unchanged version cost no round trip; version
        # bumps ride every reply this worker decodes and the watcher's
        # REPLICA_STATE polls
        self.pull_cache = (env_flag("PS_PULL_CACHE", False)
                           if pull_cache is None else bool(pull_cache))
        # a held snapshot is revalidated with a conditional READ: an
        # unchanged target answers NOT_MODIFIED, a stamp instead of the tree
        self.read_conditional = env_flag("PS_READ_CONDITIONAL", True)
        self._read_cv = threading.Condition()
        # in-flight fetch records, one a shard: waiters read the result out
        # of the record, so with the cache off a snapshot dies with its
        # last reader
        self._read_fetching: Dict[int, dict] = {}
        self._read_snaps: Dict[int, dict] = {}  # pull_cache only
        self._read_pool = None  # the fan-out executor, made on first use
        self._watch_chs: Dict[int, tv.Channel] = {}
        self._read_watch = None
        self._read_watch_stop = threading.Event()

    def _close_read_path(self) -> None:
        stop = getattr(self, "_read_watch_stop", None)
        if stop is not None:
            stop.set()
        pool = getattr(self, "_read_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._read_pool = None
        watch = getattr(self, "_read_watch", None)
        if watch is not None:
            # joined before its channels close: a watcher mid-iteration
            # could otherwise dial and store a channel after the sweep
            watch.join(timeout=5)
        self._close_read_channels()
        for ch in list(getattr(self, "_watch_chs", {}).values()):
            ch.close()
        self._watch_chs = {}
        self._read_watch = None

    def read_all(self) -> Any:
        """A side-effect-free read of the current params, the serving
        pull: unlike :meth:`pull_all` the server records no pull (no DC
        snapshot, no replication entry), a backup within
        ``read_staleness`` versions may answer, the native loop answers
        repeats from its cache, and concurrent callers share one fetch a
        shard. The params :meth:`pull_all` returned are not touched. The
        tree's tensors lie on this worker's device."""
        return self.read_all_versioned()[0]

    def read_all_versioned(self) -> Tuple[Any, int]:
        """:meth:`read_all` and the summed versions of the bytes as they
        were served, which may trail :attr:`version` (the newest versions
        this worker has seen) when a replica answered within the bound."""
        tree, version, _ = self.read_all_stamped()
        return tree, version

    def read_all_stamped(self) -> Tuple[Any, int, Optional[dict]]:
        """:meth:`read_all_versioned` and the oldest birth record among
        the served shard snapshots (None when none carried one): a
        re-publisher stamps merged bytes with their oldest part's age."""
        with self._op("read"):
            kv: Dict[str, Any] = {}
            version = 0
            births: List[dict] = []
            if len(self._active) > 1:
                import concurrent.futures

                pool = self._read_executor()
                futs = {i: pool.submit(self._read_shard, i)
                        for i in self._active}
                concurrent.futures.wait(futs.values())
                snaps = [f.result() for f in futs.values()]
            else:
                snaps = [self._read_shard(i) for i in self._active]
            for snap in snaps:
                kv.update(snap["kv"])
                version += int(snap["version"])
                if snap.get("b") is not None:
                    births.append(snap["b"])
            missing = [k for k in self._key_order if k not in kv]
            if missing:
                raise RuntimeError(f"read returned no value for "
                                   f"{missing[:3]}")
            tree = keymod.unflatten(
                self._treedef,
                stage_to_device(kv, self.device, stats=self.transport),
                self._key_order)
            birth = (min(births, key=lambda b: b["birth"])
                     if births else None)
            return tree, version, birth

    def _read_executor(self):
        if self._read_pool is None:
            import concurrent.futures

            self._read_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=len(self._active),
                thread_name_prefix="ps-read")
        return self._read_pool

    def _read_fresh_enough(self, version: int, i: int) -> bool:
        return self.versions[i] - int(version) <= self.read_staleness

    def _note_read_age(self, i: int, snap: dict, tier: str) -> None:
        """One serve's data age: ``now - birth``, resolved with shard
        ``i``'s ClockSync offset when the birth came from another process
        (the source rides the sample; a negative age is clamped)."""
        b = snap.get("b")
        if b is None:
            return  # a server that stamps no birth
        cs = self._read_clock.get(i)
        off = cs.offset_us if cs is not None else None
        age, src, clamped = freshness.age_of(b, off)
        self.transport.record_read_age(age, src=src, tier=tier,
                                       bound=self.freshness_slo,
                                       clamped=clamped)

    def _read_shard(self, i: int) -> dict:
        """One shard's snapshot: the cached one while its version is
        within the bound of the newest known, else one coalesced fetch. A
        waiter sharing another caller's fetch holds its result to the same
        bound: an ack seen while the fetch was in flight makes it stale for
        this reader, who then fetches again."""
        self._ensure_version_watch()
        while True:
            with self._read_cv:
                snap = self._read_snaps.get(i)
                if (snap is not None and self.pull_cache
                        and self._read_fresh_enough(snap["version"], i)):
                    self.transport.record_read_cache(True)
                    self._note_read_age(i, snap, "cache")
                    return snap
                rec = self._read_fetching.get(i)
                if rec is not None:
                    self._read_cv.wait(0.05)
                    got = rec.get("snap") if rec.get("done") else None
                    if got is not None \
                            and self._read_fresh_enough(got["version"], i):
                        self.transport.record_read_coalesced()
                        self._note_read_age(i, got, "cache")
                        return got
                    continue
                rec = {"done": False, "snap": None}
                self._read_fetching[i] = rec
                break
        try:
            snap = self._read_fetch(i)
            with self._read_cv:
                rec["snap"] = snap
                if self.pull_cache:
                    self._read_snaps[i] = snap
            self._note_read_age(i, snap, snap.get("tier") or "wire")
            return snap
        finally:
            with self._read_cv:
                rec["done"] = True
                self._read_fetching.pop(i, None)
                self._read_cv.notify_all()

    def _read_fetch(self, i: int) -> dict:
        """One wire READ for shard ``i`` over its replica set: members in
        rotating order, a non-primary whose reply is past the staleness
        bound refused (a fallback) and the rotation going on. The primary
        always qualifies, so a healthy shard never fails the bound."""
        self.transport.record_read_cache(False)
        # with a snapshot in hand, say which version it is: an unchanged
        # target answers NOT_MODIFIED and the bytes are kept
        snap0 = None
        if self.pull_cache and self.read_conditional:
            with self._read_cv:
                snap0 = self._read_snaps.get(i)
        if snap0 is not None:
            payload = tv.encode(tv.READ, 0, None,
                                extra={"cond": int(snap0["version"])})
        else:
            payload = tv.encode(tv.READ, 0, None)
        def judge(reply, kind, extra):
            if kind == tv.NOT_MODIFIED and snap0 is not None:
                # the held bytes are at the snapshot's version, at or above
                # the stamp: that is what the bound judges
                return max(int(extra["version"]), int(snap0["version"]))
            return int(extra["version"]) if kind == tv.OK else None

        kind, tensors, extra, version, replica = self._read_rotate(
            i, payload, judge)
        if version > self.versions[i]:
            self.versions[i] = version
        if kind == tv.NOT_MODIFIED:
            # the stamp's birth describes the bytes held: a revalidation
            # refreshes their age
            birth = freshness.from_extra(extra) or snap0.get("b")
            return {"version": version, "kv": snap0["kv"], "b": birth,
                    "tier": "nm"}
        # copies of our own: the reply frame dies with this scope
        return {"version": version,
                "kv": {k: np.array(v) for k, v in tensors.items()},
                "b": freshness.from_extra(extra),
                "tier": "replica" if replica else "wire"}

    def _read_known(self, i: int) -> int:
        return self.versions[i]

    def _ensure_version_watch(self) -> None:
        """Start the version watcher once, on the first read, when the
        cache is on: it polls each shard's REPLICA_STATE on the heartbeat
        cadence, so a pure reader learns of version bumps without a
        pull."""
        if not self.pull_cache or self._read_watch is not None:
            return
        with self._read_cv:
            if self._read_watch is not None:
                return
            # the watcher binds its own stop event and channel dict: a
            # reconnect installs fresh ones, which an old watcher never
            # writes into
            t = threading.Thread(
                target=self._version_watch,
                args=(self._read_watch_stop, self._watch_chs),
                daemon=True, name="ps-read-watch")
            self._read_watch = t
        t.start()

    def _version_watch(self, stop, chs) -> None:
        from ps_tpu_torch.config import env_int
        from ps_tpu_torch.obs.clock import ClockSync

        interval = env_int("PS_HEARTBEAT_INTERVAL_MS", 100, lo=1) / 1e3
        payload = tv.encode(tv.REPLICA_STATE, 0, None)
        # a re-dial cooldown a shard: a dead shard must not hold up the
        # others' probes behind its connect timeout every round
        bad: Dict[int, float] = {}
        while not stop.wait(interval):
            for i in list(self._active):
                if stop.is_set():
                    return
                ch = chs.get(i)
                if ch is None and bad.get(i, 0.0) > time.monotonic():
                    continue
                try:
                    if ch is None:
                        host, port = self._addrs[i]
                        ch = tv.Channel.connect(host, port,
                                                timeout_ms=2000, retries=1,
                                                max_wait_s=0.2)
                        chs[i] = ch
                    t0 = time.time()
                    reply = ch.request(payload)
                    t1 = time.time()
                    kind, _, _, extra = tv.decode(reply)
                    v = extra.get("version")
                    if kind == tv.OK and v is not None \
                            and int(v) > self.versions[i]:
                        self.versions[i] = int(v)
                    if kind == tv.OK and extra.get("now") is not None:
                        # each poll is also a clock probe toward the shard's
                        # primary (the reply carries its "now")
                        cs = self._read_clock.get(i)
                        if cs is None:
                            cs = self._read_clock[i] = ClockSync()
                        cs.observe(t0, t1, float(extra["now"]))
                    bad.pop(i, None)
                except (tv.VanError, OSError, IndexError):
                    if ch is not None:
                        ch.close()
                    chs.pop(i, None)
                    bad[i] = time.monotonic() + 2.0

    def make_async_step(self, loss_fn, has_aux: bool = False,
                        overlap: bool = False):
        """``run(batch, *extra) -> loss``: the gradient against the last
        pulled (stale) params on this worker's device, then one push_pull.

        With ``overlap=True`` (bucketed transport) the cycle runs in the
        background: ``run`` returns once the gradient is staged, and the
        next call waits for the fresh params before computing, so every
        gradient is taken at the serial step's params. Call :meth:`flush`
        after the loop (``close()`` does) to land the last push."""
        from ps_tpu_torch.kv.store import value_and_grad

        if overlap:
            self._require_bucketed()
        pending: List[PendingCycle] = []

        def run(batch, *extra):
            if pending:
                params = pending.pop().wait()
            elif self._params is not None:
                params = self._params
            else:
                params = self.pull_all()
            loss, grads, aux = value_and_grad(loss_fn, params, batch, *extra,
                                              has_aux=has_aux)
            if overlap:
                pending.append(self.push_pull_async(grads))
            else:
                self.push_pull(grads)
            return (loss, aux) if has_aux else loss

        return run

    def close(self) -> None:
        if self._tel_reporter is not None:
            self._tel_reporter.close()
            self._tel_reporter = None
        try:
            if self._pending_cycles:
                self.flush()  # land in-flight cycles before the goodbyes
        except Exception:
            pass  # a dead server must not block the teardown
        self._close_read_path()
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
