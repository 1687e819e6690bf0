"""Shared serve/accept/drain machinery for van-backed PS services.

Counterpart of ``ps_tpu/backends/van_service.py``. A service is a TCP
listener and a request -> reply loop over framed tensor messages, served
one of two ways:

- thread per connection (the default): one serve thread a worker
  connection;
- the native epoll loop (``native_loop=True`` or ``PS_VAN_NATIVE_LOOP=1``,
  ``control/native_loop.py``): accept, frame reads and reply writes run on
  ``loop_threads`` native threads without the GIL, and one Python pump
  thread dispatches batches of complete frames through the same
  :meth:`VanService._dispatch`, so replies and refusals are the same
  bytes. Requests that may park (a push during a checkpoint pause, the
  checkpoint phases) go to threads of their own. Where the loop cannot
  start (not Linux, or the native start fails) the service logs it and
  serves thread per connection; :attr:`VanService.native_loop` says which.

On the loop, native push admission (``PS_PUSH_NATIVE_ADMIT``, on by
default) classifies whole-tree pushes (dense ``PUSH``, sparse
``ROW_PUSH``) inside the loop threads against a mirror of the service's
dedup ledger: a pure replay is acked with the bytes the pump would send,
a fresh push is stamped so the apply may skip its dedup scan. Every apply
invalidates the mirror at a generation the pump's publish then re-arms,
so a native ack never carries a superseded version.

A worker's ``SHM_SETUP`` offer (``control/shm_lane.py``) is accepted
unless ``shm=False`` or ``PS_SHM=0``: the connection's requests then
arrive in a shared-memory ring, decoded in place; on the native loop the
connection is first detached to a serve thread of its own (epoll cannot
wait on ring cursors).

The concrete service (``AsyncPSService`` in ``remote_async.py``,
``SparsePSService`` in ``remote_sparse.py``) provides the protocol
(:meth:`VanService._handle`), the commit gate
(:meth:`VanService._set_draining`), its apply lock
(:meth:`VanService._service_lock`) and admission's ledger hooks.

Replication (``replica/``): a service made with ``backup=True`` applies a
primary's REPLICA_APPEND stream through its own engine and answers worker
traffic with the typed, retryable ``backup: True`` refusal (on the loop,
native admission answers push frames with the same bytes) until
:meth:`VanService.promote`. A primary streams each committed apply to its
backup after :meth:`VanService.attach_backup`; with sync ack the reply
waits for the backup's ack, so on the loop every commit kind is punted to
a thread of its own while a session is attached (the pump never waits on
a backup's round trip). A zombie primary whose backup promoted is fenced
by the backup's refusal and refuses workers from then on.

The read path: a READ is side-effect free (no event-log record, no
replication entry, no DC snapshot) and its reply is a pure function of
committed state (worker id 0, a contiguous encode, the version and the
birth stamp of the applies), so on the loop the pump publishes each READ
reply it sends into the loop's native read cache under the exact request
bytes; the next identical READ is answered inside the loop threads with
those bytes, without an upcall. A conditional READ (``"cond"``, the
caller's version, last in the extra) whose target has not moved is
answered NOT_MODIFIED, published as a version-floor entry that serves
every conditional READ at or above it. Every committed change calls
:meth:`VanService._invalidate_reads`, which raises the generation the
handlers capture under the apply lock with their snapshot, so a publish
an apply overtook is refused at the native floor; the sparse service
names the rows it touched (per-key tags) and only intersecting entries
drop. ``PS_NATIVE_READ_CACHE_BYTES`` bounds the cache (64 MiB; 0 turns
it off, and an entry over the budget is never cached). A backup answers
READs from its replicated state; the version in the reply lets the
worker hold replica reads to its staleness bound.

The drain contract: ``stop()`` first stops admitting connections, then
waits (bounded by ``grace``) for every request whose frame has arrived to
finish its reply (on the loop: the pump's count plus the loop's pending
frames and unflushed reply tails), and only then sets the draining flag
(refusing any straggler commit under the subclass's apply lock) and
severs the remaining connections. Workers that need a clean end send
``SHUTDOWN`` first (``worker.close()`` does), counted in
:attr:`VanService.goodbyes`, so a server can :meth:`wait_for_goodbyes`
before stopping.

Observability (``obs/``): every frame counts into
``ps_server_requests_total``; a frame whose ``extra`` carries a trace
context (``"tc"``) is served inside a span named for its kind and
parented to the sender's span, and a replicated commit hands the open
span's context to the backup in its REPLICA_APPEND, so the chain worker
-> primary -> backup is one trace; the sync ack wait is its own
``replica_ack_wait`` span. Promotion, self-fencing and stale epochs are
flight events. On the loop, the pump syncs its counters into gauges and
drains the loop's slow-frame ring into ``slow_frame`` events, each with
a span of its own when the frame carried a trace. ``PS_METRICS_PORT``
starts the process's /metrics endpoint.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ps_tpu_torch import obs
from ps_tpu_torch.backends.common import BucketAssembler, send_payload
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs import freshness
from ps_tpu_torch.utils.metrics import TransportStats


class NotServingError(RuntimeError):
    """Raised inside a handler when this service must refuse the request
    retryably; the serve loop answers an ERR carrying ``backup: True``,
    which the worker maps to :class:`ServerFailureError`."""


class StaleTableError(RuntimeError):
    """Raised inside a handler when the request's key range is not (or no
    longer) served here because the shard table moved (``elastic/``).
    Apart from :class:`NotServingError` because the remedy differs: the
    server is healthy, so the worker re-fetches the table and re-splits
    instead of cycling the replica set. The serve loop answers an ERR
    carrying ``moved: True`` and this service's ``table_epoch``, which the
    worker maps to :class:`~ps_tpu_torch.backends.common.TableMovedError`."""


class RingLog:
    """Fixed-size tail of an append-only log, plus the total count: a
    server of 10^6 applies must not hold O(applies) memory.
    ``record_full_history=True`` takes :class:`FullLog` instead, for the
    replay-parity checks that need every entry."""

    def __init__(self, maxlen: int = 4096):
        self._d = collections.deque(maxlen=int(maxlen))
        self.total = 0

    def append(self, x) -> None:
        self._d.append(x)
        self.total += 1

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __repr__(self) -> str:
        return (f"RingLog(tail={len(self._d)}/{self._d.maxlen}, "
                f"total={self.total})")


class FullLog(list):
    """Unbounded history: a plain (json-serializable) list with the same
    ``total`` as :class:`RingLog`."""

    @property
    def total(self) -> int:
        return len(self)


def make_history_log(record_full_history: bool, maxlen: int = 4096):
    return FullLog() if record_full_history else RingLog(maxlen)


#: how many trailing log entries a STATS reply ships
STATS_LOG_TAIL = 4096


def log_tail(log, n: int = STATS_LOG_TAIL) -> list:
    """The last ``n`` entries of a RingLog/FullLog as a json-ready list."""
    entries = list(log)
    return entries[-n:] if len(entries) > n else entries


def resolve_ckpt_dir(root: Optional[str], client_dir: str) -> str:
    """A client-supplied CHECKPOINT dir under the service's ``ckpt_root``.

    With no root the client names any server-host path (loopback binds
    only). With a root the path must be relative and may not escape it:
    absolute paths and ``..`` are refused."""
    if root is None:
        return client_dir
    if os.path.isabs(client_dir):
        raise ValueError(
            f"absolute checkpoint path {client_dir!r} refused: this server "
            f"confines checkpoints under ckpt_root={root!r} — pass a "
            f"relative path")
    norm = os.path.normpath(client_dir)
    if norm == ".." or norm.startswith(".." + os.sep):
        raise ValueError(
            f"checkpoint path {client_dir!r} escapes ckpt_root={root!r}")
    return os.path.join(root, norm)


class _DaemonPool:
    """A small pool of reusable daemon threads for the native loop's
    punted requests: a worker is spawned per submit only while none is
    idle (up to ``max_workers``), extra tasks queue. Daemon threads, so a
    task parked forever (a pause nothing resumes after ``kill()``) never
    blocks exit."""

    def __init__(self, max_workers: int = 32, name: str = "pool"):
        import queue

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._max = int(max_workers)
        self._name = name
        self._lock = threading.Lock()
        self._nthreads = 0
        self._idle = 0

    def submit(self, fn, *args) -> None:
        # spawn before queuing: if Thread.start() raises, the task is not
        # left queued for a worker to run later
        with self._lock:
            if self._idle == 0 and self._nthreads < self._max:
                threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._name}-{self._nthreads}",
                ).start()
                self._nthreads += 1
        self._q.put((fn, args))

    def _run(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            fn, args = self._q.get()
            with self._lock:
                self._idle -= 1
            try:
                fn(*args)
            except Exception:
                logging.getLogger(__name__).exception(
                    "punted van request failed")


class VanService:
    """One listener over the tensor van, served thread per connection or
    by the native loop.

    Subclasses call ``VanService.__init__`` last in their ``__init__`` (it
    starts accepting at once), implement ``_handle(kind, worker, tensors,
    extra)`` returning the encoded reply (raise to send ERR),
    ``_set_draining()`` (under the apply lock, set the flag the commit
    path checks so no push lands after ``stop()`` returns) and
    ``_service_lock()``; native admission also takes ``_admit_kind``,
    ``_admit_entry`` and ``_admit_ack_bytes``.
    """

    #: kinds of the replication plane (replica/), handled here
    _REPLICA_KINDS = frozenset({tv.REPLICA_HELLO, tv.REPLICA_APPEND,
                                tv.REPLICA_PROMOTE, tv.REPLICA_STATE,
                                tv.REPLICA_SEED})
    #: data-plane kinds that can park in their handler waiting for a later
    #: request of this service (a checkpoint pause): the one pump thread
    #: must never park, so the loop punts them while a pause may be live
    _COMMIT_KINDS = frozenset({tv.PUSH, tv.PUSH_PULL, tv.BUCKET_PUSH,
                               tv.ROW_PUSH, tv.ROW_PUSH_PULL,
                               tv.ROW_BUCKET_PUSH})
    #: kinds whose reply waits for a sync replica ack while a live backup
    #: session is attached (not once it degraded or was fenced: then
    #: nothing waits): the commits and the pulls (a pull's record
    #: replicates too). The reference punts the commit kinds only; a pull
    #: waiting inline would hold the pump for the backup's round trip
    _REPLICATED_KINDS = _COMMIT_KINDS | frozenset({tv.PULL, tv.BUCKET_PULL})
    #: kinds whose handlers run multi-request protocols (the checkpoint
    #: phases park between the coordinator's requests; an outbound key
    #: move or a rebalance runs for the whole move; a RESEED ships the
    #: state and attaches a backup): always punted
    _PUNT_KINDS = frozenset({tv.CHECKPOINT, tv.MIGRATE_OUT,
                             tv.COORD_REBALANCE, tv.RESEED})
    #: subclass hook: kinds whose handlers can park waiting for another
    #: member's later request of this same service (the aggregator's group
    #: barrier: a push waits for its group's other pushes). The loop
    #: always gives them a fresh thread, never the punt pool: with more
    #: members than pool threads, the push that completes the round would
    #: queue behind the parked ones and deadlock the barrier it releases
    _BARRIER_KINDS: frozenset = frozenset()

    def __init__(self, port: int = 0, bind: str = "127.0.0.1",
                 writev: Optional[bool] = None, shm: Optional[bool] = None,
                 backup: bool = False, native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None):
        from ps_tpu_torch.config import env_flag, env_float, env_int, env_str
        from ps_tpu_torch.control import native_loop as nlmod

        # vectored replies: live snapshot views go to the kernel as iovecs
        self.writev = (env_flag("PS_WRITEV", True)
                       if writev is None else bool(writev))
        # a worker's shm offer is accepted unless the server is told not
        # to (workers offer only on PS_SHM=1; PS_SHM=0 turns both off)
        self._shm_accept = (env_flag("PS_SHM", True)
                            if shm is None else bool(shm))
        # bucket replies carry their index into the loop's priority drain
        self._bucket_priority = env_flag("PS_BUCKET_PRIORITY", True)
        self._listener = tv.Listener(port=port, bind=bind)
        self._stop = threading.Event()
        self._chan_lock = threading.Lock()
        self._conns: List[threading.Thread] = []
        self._channels: List[tv.Channel] = []
        # requests whose frame arrived but whose reply is not fully sent:
        # what stop() waits out before severing anything
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        # of those, the ones parked on a checkpoint pause (not executing):
        # stop()'s drain discounts them
        self._pause_blocked = 0
        # multi-bucket push staging: one epoch in flight per worker; only a
        # complete epoch reaches the subclass's apply
        self._stage_lock = threading.Lock()
        self._push_stage: Dict[int, BucketAssembler] = {}
        self.transport = TransportStats()
        # the staleness bound (seconds) served ages are judged against
        self._fresh_slo = env_float("PS_FRESHNESS_SLO", 0.5, lo=1e-3)
        # a request frame is dead once its reply is sent, so the serve
        # loop borrows its receive buffer and returns it per request
        self._recv_pool = tv.RecvBufferPool(stats=self.transport)
        # checkpoint ownership token (issued at pause, checked by every
        # later phase, cleared at resume); under the subclass's apply lock
        self._ckpt_token: Optional[int] = None
        self._ckpt_seq = 0
        # replication: a backup applies REPLICA_APPEND events and refuses
        # worker traffic until promoted; a primary may attach_backup() a
        # session. The epoch is the shard's fencing token: promotion bumps
        # it, and workers refuse to re-route to a lower epoch (a zombie).
        # The table epoch is the shard table's (elastic/): set at
        # registration with a coordinator and raised by each committed
        # key move; a 'moved' refusal carries it
        self.role = "backup" if backup else "primary"
        self.epoch = 0
        self.table_epoch = 0
        self._primary_epoch = 0        # backup: learned at REPLICA_HELLO
        self._replica_applied_seq = 0  # backup: the last applied seq
        self._replica_attached = False
        self._backup_session = None    # primary: a BackupSession or None
        self.promote_reason: Optional[str] = None
        self.promotion_s: Optional[float] = None  # promote()'s duration
        self.goodbyes = 0  # workers that sent SHUTDOWN (clean departures)
        self._goodbye_cond = threading.Condition()
        # the chaos hook (ps_tpu_torch/chaos): when set, every dispatched
        # frame is offered to it first, and a reply it returns stands in
        # for the handler's (a blackhole's refusal); None serves as usual.
        # Only a fault harness sets it
        self.chaos = None
        # every frame served (several services in one process merge by
        # name), and the opt-in /metrics endpoint (a no-op unless
        # PS_METRICS_PORT is set; one a process)
        self._req_counter = obs.default_registry().counter(
            "ps_server_requests_total", "frames served (all kinds)")
        obs.start_metrics_server()
        # the generation both native mirrors key on: every committed change
        # bumps it (_invalidate_reads); a READ handler captures it under the
        # apply lock with its snapshot, and the pump publishes the reply at
        # that generation, so a publish an apply overtook is refused at the
        # native floor
        self._read_gen = 0
        self._read_gen_lock = threading.Lock()
        # per dispatching thread: the frame's native admission stamp, and
        # the (generation, version, tags) a READ handler's reply serializes
        self._read_pub = threading.local()
        self._native_read_cache = False
        self._read_pub_version = 0  # version of the last published READ
        want_loop = (env_flag("PS_VAN_NATIVE_LOOP", False)
                     if native_loop is None else bool(native_loop))
        if loop_threads is None:
            loop_threads = env_int("PS_VAN_LOOP_THREADS", 1, lo=1, hi=64)
        if not (1 <= loop_threads <= 64):
            logging.getLogger(__name__).warning(
                "van loop_threads %d outside [1, 64]; clamping", loop_threads)
            loop_threads = min(max(loop_threads, 1), 64)
        self._nloop = None
        self._pump_thread = None
        self._accept_thread = None
        # punted requests that can block commit kinds (a CHECKPOINT whose
        # pause flag is not visible yet): raised by the pump before the
        # blocker's thread starts, so the punt decision never races it
        self._loop_blockers = 0
        # kill() sets this so the pump drops queued frames unapplied
        self._pump_abort = False
        # of _pause_blocked, the parks on loop-punted threads (each holds
        # one claimed loop body): the native drain's discount
        self._loop_pause_parked = 0
        if want_loop:
            if not nlmod.available():
                logging.getLogger(__name__).warning(
                    "native_loop requested but the native event loop is "
                    "unavailable on this platform; serving thread per "
                    "connection")
            else:
                try:
                    self._nloop = nlmod.NativeEventLoop(
                        self._listener, threads=loop_threads)
                except OSError as e:
                    logging.getLogger(__name__).warning(
                        "native event loop failed to start (%s); serving "
                        "thread per connection", e)
        self._native_admit = False
        self._nl_stats = False
        if self._nloop is not None:
            # the native read cache's byte budget; 0 turns it off and every
            # READ goes to the pump
            cache_bytes = env_int("PS_NATIVE_READ_CACHE_BYTES", 64 << 20,
                                  lo=0)
            if cache_bytes:
                self._nloop.cache_config(tv.READ, cache_bytes)
                self._native_read_cache = True
            mode = (env_str("PS_PUSH_NATIVE_ADMIT", "auto")
                    or "auto").strip().lower()
            if mode not in ("off", "on", "auto"):
                logging.getLogger(__name__).warning(
                    "PS_PUSH_NATIVE_ADMIT=%r not in off|on|auto; keeping "
                    "'auto'", mode)
                mode = "auto"
            kind = self._admit_kind()
            if mode != "off" and kind is not None:
                self._nloop.admit_config(kind)
                self._native_admit = True
                self._admit_sync()  # a restored ledger starts published
            self._nl_stats = env_flag("PS_NL_STATS", True)
            slow_ms = env_float("PS_NL_SLOW_FRAME_MS", 250.0, lo=0.0,
                                strict=False)
            self._nloop.telemetry_config(
                self._nl_stats, int(slow_ms * 1e6) if self._nl_stats else 0)
            reg = obs.default_registry()
            self._loop_conn_gauge = reg.gauge(
                "ps_van_live_connections",
                "connections registered in the native event loop")
            self._loop_iter_gauge = reg.gauge(
                "ps_van_loop_iterations_total",
                "cumulative native-loop epoll iterations")
            self._loop_req_gauge = reg.gauge(
                "ps_van_loop_requests_total",
                "cumulative frames read by the native loop")
            self._read_hits_gauge = reg.gauge(
                "ps_pull_native_hits_total",
                "READ frames answered by the native read cache with "
                "zero upcalls")
            self._read_miss_gauge = reg.gauge(
                "ps_pull_native_misses_total",
                "cacheable READ frames that fell through to the pump")
            self._read_lag_gauge = reg.gauge(
                "ps_pull_cache_version_lag",
                "engine versions the cached READ snapshot trails by "
                "(0 = fresh or empty)")
            self._padm_acks_gauge = reg.gauge(
                "ps_push_native_acks_total",
                "push replays acked by the native admission ledger with "
                "zero upcalls")
            self._padm_ref_gauge = reg.gauge(
                "ps_push_native_refusals_total",
                "push frames refused natively (backup/fenced role) with "
                "zero upcalls")
            self._pump_thread = threading.Thread(target=self._loop_pump,
                                                 daemon=True)
            self._pump_thread.start()
        else:
            self._accept_thread = threading.Thread(target=self._accept_loop,
                                                   daemon=True)
            self._accept_thread.start()

    @property
    def native_loop(self) -> bool:
        """True when this service serves through the native epoll loop."""
        return self._nloop is not None

    @property
    def port(self) -> int:
        return self._listener.port

    def admit_stats(self) -> dict:
        """Native push admission's counters (acks, refusals, fresh,
        punts, ledger entries, floor, armed templates); zeros off the
        loop."""
        if self._nloop is None:
            return {"acks": 0, "refusals": 0, "fresh": 0, "punts": 0,
                    "entries": 0, "floor": 0, "ack_armed": False,  # pslint: disable=PSL203 -- admit_stats() field for operators and the tests: whether the loop holds an armed ack template; not a wire header
                    "refusal_armed": False}  # pslint: disable=PSL203 -- admit_stats() field for operators and the tests: whether the loop holds an armed refusal template; not a wire header
        return self._nloop.admit_stats()

    # -- provided by the concrete service --------------------------------------

    def _handle(self, kind: int, worker: int, tensors, extra):
        raise NotImplementedError

    def _set_draining(self) -> None:
        raise NotImplementedError

    def _service_lock(self):
        """The apply lock (dense: the engine's; sparse: the tables')."""
        raise NotImplementedError

    def _replica_hello_extra(self) -> dict:
        """Primary: the attach-time topology and state point (called
        under the apply lock by :meth:`attach_backup`)."""
        raise NotImplementedError

    def _replica_validate(self, extra: dict) -> Optional[str]:
        """Backup: refuse a mismatched stream (an error string) or accept
        it (None). Checks topology and the state point: a backup that did
        not start from the primary's exact state would diverge silently."""
        raise NotImplementedError

    def _replica_apply(self, op: str, worker: int, tensors, extra) -> None:
        """Backup: apply one replicated event through the local engine,
        with :meth:`_service_lock` held (stream order is engine order)."""
        raise NotImplementedError

    def _replica_seed(self, worker: int, tensors, extra) -> Optional[str]:
        """Backup: install the whole state point a re-seeding primary
        shipped (RESEED -> REPLICA_SEED). An error string refuses it; the
        base refuses (only the dense service opts in)."""
        return "this service does not support re-seed"

    def replica_state(self) -> dict:
        """Role, epoch and the replication stream's state, and the native
        loop's counters when it serves (REPLICA_STATE, and merged into the
        STATS reply)."""
        out = {"role": self.role, "epoch": self.epoch, "now": time.time()}
        s = self._backup_session
        if s is not None:
            out["repl"] = s.state()
        if self._replica_attached:
            out["replica_applied_seq"] = self._replica_applied_seq
        if self.promote_reason is not None:
            out["promote_reason"] = self.promote_reason
            out["promotion_s"] = self.promotion_s
        out["dedup_hits"] = self.transport.dedup_hits
        v = self._read_version()
        if v is not None:
            # the version probe the worker's read cache rides (its version
            # watcher polls REPLICA_STATE)
            out["version"] = v
        t = self.transport
        if t.reads_served or t.read_native_hits:
            out["read"] = {
                "served": t.reads_served,
                "native_hits": t.read_native_hits,
                "native_misses": t.read_native_misses,
                "entries": t.read_cache_entries,
                "nm": t.read_not_modified,
                "delta_rows": t.read_delta_rows,
                "native_cond_hits": t.read_native_cond_hits,
            }
        f = t.fresh_snapshot()
        if f is not None:
            out["fresh"] = f
        if self._nloop is not None:
            loop = {"conns": t.loop_conns, "requests": t.loop_requests,
                    "pushes": t.loop_pushes,
                    "slow_frames": t.nl_slow_frames}
            s = t.hist["nl_read_hit_s"].summary()
            if s:
                loop["nlp99_us"] = round(s["p99"] * 1e6, 1)
            s = t.hist["nl_queue_wait_s"].summary()
            if s:
                loop["qw99_us"] = round(s["p99"] * 1e6, 1)
            classified = (t.push_native_acks + t.push_native_refusals
                          + t.push_native_fresh + t.push_native_punts)
            if classified:
                loop["padm"] = {
                    "acks": t.push_native_acks,
                    "refusals": t.push_native_refusals,
                    "fresh": t.push_native_fresh,
                    "punts": t.push_native_punts,
                    "share": round((t.push_native_acks
                                    + t.push_native_refusals)
                                   / classified, 4)}
            out["loop"] = loop
        return out

    # -- hooks of the apply paths ----------------------------------------------

    def _replicating(self) -> bool:
        """Whether a commit now would be streamed (a live session): the
        apply paths copy a push's host bytes for the log only then."""
        s = self._backup_session
        return s is not None and not s.degraded

    def _replicate(self, op: str, worker: int, tensors=None,
                   meta: Optional[dict] = None) -> Optional[int]:
        """Primary commit hook, under the apply lock: append one committed
        event to the stream. ``tensors`` must own their memory (the sender
        encodes them after the request's frame went back to its pool).
        None = unreplicated (no session, or it degraded)."""
        s = self._backup_session
        if s is None or s.degraded:
            return None
        meta = dict(meta or {})
        # the open span (a traced commit's apply) goes with the entry, so
        # the backup's serve span parents to it: one trace end to end
        ctx = obs.tracer().current()
        if ctx is not None:
            meta[obs.WIRE_KEY] = [ctx.trace_id, ctx.span_id]
        return s.publish(op, worker, tensors, meta)

    def _await_replication(self, seq: Optional[int]) -> None:
        """Sync-ack gate, outside the apply lock and before the reply:
        wait until the backup acked ``seq``. A no-op for async ack, for
        unreplicated commits and for a degraded session, except one that
        degraded because the backup promoted: then this zombie's commit
        never reached the real primary, so the reply is a retryable
        refusal, and the worker replays the push at the promoted backup
        (its dedup token makes that exactly once)."""
        s = self._backup_session
        if s is None:
            return
        if seq is not None and s.ack_mode == "sync":
            # a child of the serve span; NOOP on an untraced request
            with obs.tracer().child("replica_ack_wait", cat="server"):
                s.wait_acked(seq)
        # checked for every commit, unreplicated ones after the degrade
        # too: once fenced, no reply may say a commit stuck at this zombie
        if s.fenced:
            raise NotServingError(
                "fenced mid-commit: this shard's backup promoted — retry "
                "at the new primary")

    def promote(self, reason: str = "request") -> int:
        """The backup -> primary transition (idempotent): under the apply
        lock, so no replicated apply is mid-way and no worker push is
        admitted across the flip, bump the epoch past the primary's and
        start serving. With sync ack everything the primary acknowledged
        to a worker is already in this engine, so there is nothing to
        rebuild."""
        t0 = time.perf_counter()
        with self._service_lock():
            if self.role == "primary":
                return self.epoch
            self.role = "primary"
            self.epoch = self._primary_epoch + 1
            self.promote_reason = reason
        self._invalidate_reads()
        # reseed native admission from the replicated ledger: the promoted
        # backup suppresses the replays its dead primary would have, and
        # stops answering the backup refusal
        self._admit_sync()
        self.promotion_s = time.perf_counter() - t0
        obs.record_event("promotion", reason=reason, epoch=self.epoch,
                         promotion_s=round(self.promotion_s, 6))
        logging.getLogger(__name__).warning(
            "backup promoted to primary (reason=%s, epoch %d) in %.1fms",
            reason, self.epoch, self.promotion_s * 1e3)
        return self.epoch

    def attach_backup(self, host: str, port: int, ack: str = "sync",
                      window: int = 256, compress=None,
                      stall_timeout: float = 30.0):
        """Primary: attach a warm backup and stream every commit to it.
        Attach before admitting workers (or from a quiesced state): the
        handshake checks that both replicas stand at the same state point
        and raises :class:`~ps_tpu_torch.replica.ReplicationError`
        otherwise, since a deltas-only stream cannot catch a backup up.

        ``ack="sync"``: push and pull replies wait for the backup's ack;
        a promotion is bitwise what the workers saw. ``ack="async"``:
        replies return at once and the backup trails by at most
        ``window`` commits (``repl.lag`` in STATS). ``compress`` runs the
        stream through a stateless gradient codec."""
        from ps_tpu_torch.replica.session import BackupSession

        if self.role != "primary":
            raise RuntimeError("only a primary can attach a backup")
        with self._service_lock():
            old = self._backup_session
            if old is not None and not old.degraded:
                raise RuntimeError("a live backup session is already "
                                   "attached")
            if old is not None:
                old.close()  # degraded: replaceable without a restart
            hello = self._replica_hello_extra()
            hello.update({"epoch": self.epoch, "ack": ack})
            # the dial and HELLO are atomic with the state point the lock
            # holds still (connect_timeout_ms bounds them)
            session = BackupSession(host, port, hello, ack=ack,  # pslint: disable=PSL101 -- attach-time only (before worker traffic, or quiesced): the dial+HELLO must be atomic with the state-point snapshot the lock protects, and connect_timeout_ms bounds it
                                    window=window, compress=compress,
                                    stats=self.transport,
                                    stall_timeout=stall_timeout)
            session.on_fenced = self._fence
            self._backup_session = session
        return session

    def _fence(self, peer_epoch: int) -> None:
        """Self-fencing: our backup promoted past us (it refused the
        stream as a primary of ``peer_epoch``). This service is a zombie
        and stops serving workers, so history cannot fork; the retryable
        refusal sends connected workers to the real primary through their
        replica sets."""
        with self._service_lock():
            if self.role != "primary":
                return
            self.role = "fenced"
        self._invalidate_reads()
        self._admit_sync()  # native admission answers the fenced refusal
        obs.record_event("self_fence", peer_epoch=int(peer_epoch),
                         epoch=self.epoch)
        logging.getLogger(__name__).error(
            "FENCED: this shard's backup promoted to primary (epoch %d) "
            "while we were still serving — refusing all worker traffic "
            "from now on (workers re-route via their replica sets)",
            peer_epoch)

    # -- the read path ----------------------------------------------------------

    def _read_version(self):
        """Subclass hook: the version a READ reply is stamped with (dense:
        the engine's; sparse: the sum of the table versions). None = this
        service serves no READ."""
        return None

    def set_read_cache_bytes(self, n: int) -> None:
        """Set the native read cache's byte budget while serving, as
        ``PS_NATIVE_READ_CACHE_BYTES`` does at startup: 0 turns the cache
        off and drops what it holds (every READ goes to the pump), any
        other budget turns it on. Turning it on raises the publish floor
        past every READ snapshot taken while it was off, when no apply
        invalidated. Raises off the native loop, which has no cache."""
        if self._nloop is None:
            raise RuntimeError("the native read cache runs in the native "
                               "loop: serve with native_loop=True")
        n = int(n)
        if n < 0:
            raise ValueError(f"a read cache budget of {n} bytes")
        if n:
            self._nloop.cache_config(tv.READ, n)
            self._native_read_cache = True
            self._invalidate_reads()
        else:
            self._native_read_cache = False
            self._nloop.cache_config(tv.READ, 0)

    def _read_gen_snapshot(self) -> int:
        """The current publish generation. A READ handler calls this under
        its apply lock, with the snapshot it serializes, and hands the pair
        to :meth:`_note_read_snapshot`."""
        with self._read_gen_lock:
            return self._read_gen

    def _invalidate_reads(self, tags=None) -> None:
        """Invalidation on apply: call after every committed change a
        cached READ reply could observe (applies, replicated applies,
        promotion, fencing, drain, a seed). It raises the generation, so
        an in-flight publish of a pre-apply snapshot is refused at the
        native floor, and drops cached READ replies: all of them, or with
        ``tags`` (the sparse service's per-(table, row) hashes) only the
        entries whose tags intersect, so hot id-sets the apply did not
        touch keep serving. The admission mirror rides the same
        generation: its version-stamped replay-ack template drops (the
        post-apply :meth:`_admit_publish` re-arms it), so a classification
        made before the apply never acks a replay after it. A no-op when
        both native mirrors are off."""
        if not (self._native_read_cache or self._native_admit):
            return
        with self._read_gen_lock:
            self._read_gen += 1
            gen = self._read_gen
        nloop = self._nloop
        if nloop is not None:
            if self._native_read_cache:
                nloop.cache_invalidate(gen, tags=tags)
            if self._native_admit:
                nloop.admit_invalidate(gen)

    def _note_serve_age(self, birth: Optional[dict],
                        tier: Optional[str] = None) -> None:
        """Record one serve's data age (``now - birth``) from the birth
        record a READ handler just encoded; the tier is ``pump`` on a
        primary (a native hit re-serves the same stamped bytes) and
        ``replica`` on a backup."""
        if birth is None:
            return
        age, src, clamped = freshness.age_of(birth)
        self.transport.record_read_age(
            age, src=src,
            tier=tier or ("pump" if self.role == "primary" else "replica"),
            bound=self._fresh_slo, clamped=clamped)

    def _note_read_snapshot(self, gen: int, version: int,
                            tags=None) -> None:
        """A READ handler records the generation and version its reply
        serializes, and the tags of the rows it covers; the pump publishes
        the reply at exactly that generation, with those tags. Thread-local:
        handlers run on the pump or on serve threads."""
        self._read_pub.gen = gen
        self._read_pub.version = int(version)
        self._read_pub.tags = tags

    # -- the zero-upcall push plane --------------------------------------------

    def _admit_kind(self) -> Optional[int]:
        """Subclass hook: the one wire kind native admission may classify
        (dense: PUSH; sparse: ROW_PUSH); None = never."""
        return None

    def _admit_entry(self, worker: int) -> Optional[tuple]:
        """Subclass hook: this worker's settled ledger row as ``(nonce,
        lo, hi)``: a replay at or below ``lo`` is fully applied (ackable),
        one above ``hi`` strictly fresh, between punts. None = not
        publishable; the worker's frames then go to the pump."""
        return None

    def _admit_entries(self):
        """Every publishable ledger row (for a full reseed)."""
        out = []
        for w in list(getattr(self, "_applied_pseq", None) or ()):
            ent = self._admit_entry(int(w))
            if ent is not None:
                out.append((int(w), ent[0], int(ent[1]), int(ent[2])))
        return out

    def _admit_ack_bytes(self) -> Optional[bytes]:
        """Subclass hook: the encoded replay ack (worker id 0; the loop
        patches the requester's in), byte for byte what the pump would
        send for a pure dedup replay now."""
        return None

    def _role_refusal(self, worker: int) -> bytes:
        """The typed, retryable refusal of worker traffic on a backup or
        a fenced zombie: the pump's reply, and (worker id 0, patched by
        the loop) native admission's template, the same bytes."""
        return tv.encode(tv.ERR, worker, None, extra={
            "error": (f"shard backup is not serving worker traffic "
                      f"(role={self.role}, epoch {self.epoch}) — "
                      f"retry after promotion"),
            "backup": True, "epoch": self.epoch})

    def _admit_refusal_bytes(self) -> Optional[bytes]:
        """The role refusal the loop answers push frames with while this
        service does not serve workers; None on a serving primary."""
        if self.role == "primary":
            return None
        return self._role_refusal(0)

    def _admit_sync(self, locked: bool = False) -> None:
        """Reseed the admission mirror whole (startup, promotion, fencing,
        checkpoint resume): drop everything at a fresh generation, then
        arm the role refusal on a non-primary, or republish the settled
        ledger, under the apply lock unless the caller holds it."""
        if not self._native_admit or self._nloop is None:
            return
        if not locked:
            with self._service_lock():
                return self._admit_sync(locked=True)
        nloop = self._nloop
        with self._read_gen_lock:
            self._read_gen += 1
            gen = self._read_gen
        nloop.admit_reset(gen)
        refusal = self._admit_refusal_bytes()
        if refusal is not None:
            nloop.admit_set_refusal(refusal)
            return
        nloop.admit_set_refusal(b"")
        if getattr(self, "_paused", False) or getattr(self, "_draining",
                                                      False):
            return  # paused or draining: every push must reach the pump
        for w, nonce, lo, hi in self._admit_entries():
            nloop.admit_put(w, nonce, lo, hi, gen)
        ack = self._admit_ack_bytes()
        if ack is not None:
            nloop.admit_set_ack(ack, gen)

    def _admit_drop(self) -> None:
        """Suspend admission (checkpoint pause, drain): drop the mirror at
        a fresh generation, so every push goes to the pump until
        :meth:`_admit_sync` reseeds it."""
        if not self._native_admit or self._nloop is None:
            return
        with self._read_gen_lock:
            self._read_gen += 1
            gen = self._read_gen
        self._nloop.admit_reset(gen)

    def _admit_publish(self, *workers) -> None:
        """After an apply (apply lock held, after its
        :meth:`_invalidate_reads`): publish the named workers' ledger rows
        and the fresh ack template at the post-apply generation."""
        if (not self._native_admit or self._nloop is None
                or self.role != "primary"
                or getattr(self, "_paused", False)
                or getattr(self, "_draining", False)):
            return
        nloop = self._nloop
        with self._read_gen_lock:
            gen = self._read_gen
        for w in workers:
            if w is None:
                continue
            ent = self._admit_entry(int(w))
            if ent is not None:
                nloop.admit_put(int(w), ent[0], int(ent[1]), int(ent[2]),
                                gen)
        ack = self._admit_ack_bytes()
        if ack is not None:
            nloop.admit_set_ack(ack, gen)

    def _admit_fresh_hint(self) -> bool:
        """Consume this thread's admission stamp (apply lock held): True
        iff the loop classified the frame strictly fresh and no apply or
        reseed landed since, which proves the dedup scan would find
        nothing. Anything else is False: the full scan."""
        gen = getattr(self._read_pub, "admit", 0)
        if not gen:
            return False
        self._read_pub.admit = 0
        with self._read_gen_lock:
            return gen - 1 == self._read_gen

    # -- dispatch --------------------------------------------------------------

    def _dispatch(self, kind: int, worker: int, tensors, extra):
        """Route one request: the replication kinds are handled here;
        worker kinds reach the subclass only on a serving primary, and a
        backup or a fenced zombie refuses them with the typed, retryable
        reply (the worker's failover loop keys on ``backup``). STATS is
        always answered, and a backup answers READs from its replicated
        state (the reply's version lets the worker hold it to its
        staleness bound); a fenced zombie refuses them too.

        The chaos hook, when one is set, sees every frame first (both
        serve paths reach here), so an injected fault answers with the
        frames a broken shard would send and the worker's own refusal
        and retry paths do the rest.

        A frame carrying a trace context is served inside a span named
        for its kind, parented to the sender's span (the worker's op, or
        the primary's apply for a replica append); an untraced frame costs
        one dict lookup."""
        hook = self.chaos
        if hook is not None:
            reply = hook(self, kind, worker, extra)
            if reply is not None:
                return reply
        ctx = obs.from_wire(extra)
        if ctx is not None:
            with obs.tracer().span(tv.kind_name(kind), cat="server",
                                   parent=ctx).set(worker=worker,
                                                   role=self.role):
                return self._dispatch_traced(kind, worker, tensors, extra)
        return self._dispatch_traced(kind, worker, tensors, extra)

    def _dispatch_traced(self, kind: int, worker: int, tensors, extra):
        if kind in self._REPLICA_KINDS:
            return self._handle_replica(kind, worker, tensors, extra)
        if self.role != "primary" and kind != tv.STATS:
            if kind == tv.READ and self.role == "backup":
                return self._handle(kind, worker, tensors, extra)
            return self._role_refusal(worker)
        return self._handle(kind, worker, tensors, extra)

    def _handle_replica(self, kind: int, worker: int, tensors, extra):
        if kind == tv.REPLICA_STATE:
            return tv.encode(tv.OK, worker, None, extra=self.replica_state())
        if kind == tv.REPLICA_PROMOTE:
            if self.role != "backup":
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": f"cannot promote a {self.role} service"})
            epoch = self.promote(reason=str(extra.get("reason", "request")))  # pslint: disable=PSL203 -- REPLICA_PROMOTE is an operator/test-sent frame; in-tree promotion goes through PromotionWatch.promote(), so no in-tree encoder produces "reason"
            return tv.encode(tv.OK, worker, None,
                             extra={"epoch": epoch, "role": self.role})
        if self.role != "backup":
            # a zombie primary still appending after this backup promoted:
            # refuse with the fencing signal, so it stops serving instead
            # of forking history
            return tv.encode(tv.ERR, worker, None, extra={
                "error": (f"replication stream refused: this service is "
                          f"{self.role} (epoch {self.epoch}), not a backup"),
                "fenced": True, "epoch": self.epoch})
        if kind == tv.REPLICA_SEED:
            # the whole state point onto an empty spare, so the
            # REPLICA_HELLO that follows validates against an exact copy
            err = self._replica_seed(worker, tensors, extra)
            if err is not None:
                return tv.encode(tv.ERR, worker, None, extra={"error": err})
            return tv.encode(tv.OK, worker, None,
                             extra={"epoch": self.epoch})
        if kind == tv.REPLICA_HELLO:
            err = self._replica_validate(extra)
            if err is not None:
                return tv.encode(tv.ERR, worker, None, extra={"error": err})
            with self._service_lock():
                self._primary_epoch = int(extra.get("epoch", 0))
                self._replica_applied_seq = int(extra.get("start_seq", 0))
                self._replica_attached = True
            return tv.encode(tv.OK, worker, None, extra={
                "applied_seq": self._replica_applied_seq,
                "epoch": self.epoch})
        # REPLICA_APPEND
        seq = int(extra["seq"])
        with self._service_lock():
            if self.role != "backup":
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "promoted mid-append: stream refused"})
            if not self._replica_attached:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "REPLICA_APPEND before REPLICA_HELLO"})
            if seq != self._replica_applied_seq + 1:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": (f"replication gap: expected seq "
                              f"{self._replica_applied_seq + 1}, got {seq}")})
            self._replica_apply(str(extra["op"]),
                                int(extra.get("w", worker)), tensors, extra)
            self._replica_applied_seq = seq
        return tv.encode(tv.OK, worker, None, extra={"applied_seq": seq})

    def _dispatch_reply_payload(self, kind: int, worker: int, tensors,
                                extra):
        """Dispatch, mapping a raised error to an ERR reply: NotServing ->
        the retryable refusal, StaleTable -> the 'moved' refusal (re-route
        by the table), anything else -> a plain ERR. Both serve paths go
        through here, so their replies are the same bytes."""
        try:
            return self._dispatch(kind, worker, tensors, extra)
        except NotServingError as e:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": str(e), "backup": True, "epoch": self.epoch})
        except StaleTableError as e:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": str(e), "moved": True,
                "table_epoch": self.table_epoch})
        except Exception as e:
            return tv.encode(tv.ERR, worker, None, extra={"error": repr(e)})

    def _stage_bucket_push(self, worker: int, bucket: int, nbuckets: int,
                           epoch: int, raw, slices,
                           nonce: Optional[str] = None) -> Optional[dict]:
        """Stage one bucket of worker's multi-bucket push; returns the
        assembled ``{key: array}`` tree when this bucket completes the
        epoch, else None (reply with a plain ack).

        One epoch is in flight per worker, so a bucket of another (epoch,
        nonce) pair means the worker moved on (abandoned a push, or
        restarted): the incomplete epoch is dropped whole, never half
        applied and never merged, and counted as stale. A malformed bucket
        (duplicate, bad range) also drops the staged epoch."""
        stale = None
        try:
            with self._stage_lock:
                asm = self._push_stage.get(worker)
                if asm is not None and (asm.epoch != epoch
                                        or getattr(asm, "nonce",
                                                   None) != nonce):
                    stale = (asm.epoch, len(asm._seen), asm.nbuckets)
                    asm = None
                if asm is None:
                    asm = BucketAssembler(epoch, nbuckets)
                    asm.nonce = nonce
                    self._push_stage[worker] = asm
                try:
                    complete = asm.add(bucket, raw, slices, epoch)
                except Exception:
                    self._push_stage.pop(worker, None)
                    raise
                if complete:
                    del self._push_stage[worker]
        finally:
            # outside the stage lock, and even when the superseding
            # epoch's first bucket was malformed
            if stale is not None:
                old_epoch, staged, nb = stale
                self.transport.record_stale_epoch(staged)
                obs.record_event("stale_epoch", worker=worker,
                                 epoch=old_epoch, superseded_by=epoch,
                                 buckets=staged)
                logging.getLogger(__name__).warning(
                    "worker %d abandoned push epoch %d (%d/%d buckets); "
                    "superseded by epoch %d", worker, old_epoch, staged,
                    nb, epoch)
        return asm.finish() if complete else None

    # -- checkpoint ownership tokens ------------------------------------------

    def _ckpt_issue_token(self) -> Optional[int]:
        """Issue the pause token (apply lock held); None when a checkpoint
        is already outstanding."""
        if self._ckpt_token is not None:
            return None
        self._ckpt_seq += 1
        self._ckpt_token = self._ckpt_seq
        return self._ckpt_token

    def _ckpt_busy_error(self) -> str:
        return (f"checkpoint already in progress (token {self._ckpt_token} "
                f"outstanding) — serialize checkpoint coordinators")

    def _ckpt_token_error(self, phase: str, extra: dict) -> Optional[str]:
        """The error when the phase's token is not the outstanding one."""
        token = extra.get("token")
        token = None if token is None else int(token)
        if token != self._ckpt_token:
            return (f"checkpoint {phase} with invalid token {token!r} "
                    f"(outstanding: {self._ckpt_token!r})")
        return None

    def _ckpt_clear_token(self) -> None:
        self._ckpt_token = None

    def _pause_wait_begin(self) -> None:
        """Call just before parking a serve thread on a checkpoint pause
        (stop() discounts it). A park on a loop-punted thread also holds
        one claimed loop body, which the native drain discounts."""
        with self._inflight_cond:
            self._pause_blocked += 1
            if getattr(threading.current_thread(), "_ps_loop_req", False):
                self._loop_pause_parked += 1
            self._inflight_cond.notify_all()

    def _pause_wait_end(self) -> None:
        with self._inflight_cond:
            self._pause_blocked -= 1
            if getattr(threading.current_thread(), "_ps_loop_req", False):
                self._loop_pause_parked -= 1
            self._inflight_cond.notify_all()

    # -- thread per connection -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            ch = self._listener.accept(timeout_ms=200)
            if ch is None:
                continue
            ch.stats = self.transport
            ch.pool = self._recv_pool
            with self._chan_lock:
                # prune finished serve threads (ident None = not started)
                self._conns = [t for t in self._conns
                               if t.ident is None or t.is_alive()]
                if self._stop.is_set():
                    ch.close()  # raced stop(): admit nothing new
                    return
                self._channels.append(ch)
                t = threading.Thread(target=self._serve, args=(ch,),
                                     daemon=True)
                self._conns.append(t)
            t.start()

    def _try_shm_upgrade(self, ch: tv.Channel, worker: int, extra: dict):
        """Attach the worker's offered ring segments; returns ``(lane or
        None, reply frame)``. Any failure is an ERR reply and the
        connection stays plain TCP."""
        from ps_tpu_torch.control import shm_lane

        if not self._shm_accept:
            return None, tv.encode(tv.ERR, worker, None, extra={
                "error": "shm lane disabled on this server (PS_SHM=0)"})
        try:
            lane = shm_lane.accept_upgrade(ch, extra, stats=self.transport)
        except Exception as e:
            return None, tv.encode(tv.ERR, worker, None,
                                   extra={"error": repr(e)})
        return lane, tv.encode(tv.OK, worker, None, extra={"shm": True})

    def _serve(self, ch: tv.Channel, lane=None) -> None:
        # ``conn`` is the data plane: the TCP channel until a successful
        # SHM_SETUP, the shm lane after (its recv hands out ring frames in
        # place and watches the TCP side for spills and peer death; stop()
        # severs through the TCP channel). ``lane`` is set already when
        # the native loop detached an upgrading connection to this thread
        conn = lane if lane is not None else ch
        try:
            while not self._stop.is_set():
                try:
                    msg = (conn.recv() if lane is None
                           else lane.recv(stop=self._stop.is_set))
                except tv.VanError:
                    return  # worker hung up (or stop() severed an idle conn)
                with self._inflight_cond:
                    self._inflight += 1
                try:
                    kind, worker, tensors, extra = tv.decode(msg)
                    self._req_counter.inc()
                    goodbye = kind == tv.SHUTDOWN
                    new_lane = None
                    if goodbye:
                        reply = tv.encode(tv.OK, worker, None)
                    elif kind == tv.SHM_SETUP and lane is None:
                        new_lane, reply = self._try_shm_upgrade(ch, worker,
                                                                extra)
                    else:
                        reply = self._dispatch_reply_payload(
                            kind, worker, tensors, extra)
                    try:
                        send_payload(conn, reply)
                    except tv.VanError:
                        if new_lane is not None:
                            new_lane.close()  # attached, never adopted
                        return  # worker vanished mid-reply
                    finally:
                        # only now is the request frame dead: a reply may
                        # hold views of it until sent (a ring frame is
                        # consumed at the lane's next recv)
                        tensors = None
                        self._recv_pool.ret(msg)
                        msg = None
                    if new_lane is not None:
                        conn = lane = new_lane  # the data plane switches
                finally:
                    with self._inflight_cond:
                        self._inflight -= 1
                        self._inflight_cond.notify_all()
                if goodbye:
                    with self._goodbye_cond:
                        self.goodbyes += 1
                        self._goodbye_cond.notify_all()
                    return
        finally:
            if lane is not None:
                lane.close()  # closes the TCP channel too
            else:
                ch.close()
            with self._chan_lock:
                try:
                    self._channels.remove(ch)
                except ValueError:
                    pass  # stop()'s snapshot may hold it
                try:
                    self._conns.remove(threading.current_thread())
                except ValueError:
                    pass

    # -- the native loop's pump ------------------------------------------------

    def _loop_pump(self) -> None:
        """The one Python thread of the native serve path: take batches of
        complete requests from the loop, dispatch each through
        :meth:`_dispatch_reply_payload`, reply through the loop's writer.
        Exits when the loop reports it stopped (poll() -> None). A failure
        serving one request never ends the pump: it logs, frees the body
        and goes on."""
        nloop = self._nloop
        last_sync = 0.0
        while True:
            try:
                batch = nloop.poll(timeout_ms=100)
            except Exception:
                logging.getLogger(__name__).exception(
                    "native-loop poll failed; pump exiting")
                return
            # the counters' sync sweeps every connection's lock natively:
            # on idle ticks, or at most about once a second under load
            now = time.monotonic()
            if not batch or now - last_sync >= 1.0:
                last_sync = now
                self._sync_loop_stats(nloop)
            if batch is None:
                return
            if not batch:
                continue
            if self._pump_abort:
                # kill(): drop read-ahead frames unserved, as a SIGKILL
                for _, _, ptr, _ in batch:
                    nloop.free(ptr)
                continue
            self.transport.record_upcall(len(batch))
            with self._inflight_cond:
                self._inflight += len(batch)
            for cid, view, ptr, admit_gen in batch:
                try:
                    self._loop_serve_one(cid, view, ptr, admit_gen)
                except Exception:
                    logging.getLogger(__name__).exception(
                        "native-loop request failed; connection %d "
                        "continues", cid)
                    nloop.free(ptr)  # idempotent
                finally:
                    with self._inflight_cond:
                        self._inflight -= 1
                        self._inflight_cond.notify_all()

    def _sync_loop_stats(self, nloop) -> None:
        """Fold the loop's own counters into :attr:`transport` and the
        registry's gauges."""
        st = nloop.stats()
        self.transport.set_loop_stats(st["requests"], st["conns"],
                                      st["iters"])
        self._loop_conn_gauge.set(st["conns"])
        self._loop_iter_gauge.set(st["iters"])
        self._loop_req_gauge.set(st["requests"])
        if self._native_read_cache:
            cs = nloop.cache_stats()
            self.transport.set_read_cache_stats(  # pslint: disable=PSL203 -- a read-cache counter handed to TransportStats by keyword (conditional NOT_MODIFIED hits); not a wire header
                cs["hits"], cs["misses"], cs["entries"], cs["bytes"],
                cond_hits=cs["cond_hits"])
            self._read_hits_gauge.set(cs["hits"])
            self._read_miss_gauge.set(cs["misses"])
            v = self._read_version()
            # versions the cached snapshot trails the engine by (0 when
            # empty: nothing stale is served)
            self._read_lag_gauge.set(
                max(0, int(v) - self._read_pub_version)
                if v is not None and cs["entries"] else 0)
        if self._native_admit:
            a = nloop.admit_stats()
            self.transport.set_admit_stats(a["acks"], a["refusals"],
                                           a["fresh"], a["punts"])
            self._padm_acks_gauge.set(a["acks"])
            self._padm_ref_gauge.set(a["refusals"])
        if self._nl_stats:
            self._sync_nl_telemetry(nloop)

    def _sync_nl_telemetry(self, nloop) -> None:
        """The in-loop histograms land whole in their ``TransportStats``
        histograms (the native stripes own the counting), the slow-frame
        count in its gauge, and the loop's slow-frame ring drains into
        ``slow_frame`` flight events, each with a span rebuilt from the
        loop's stamps when the frame carried a trace (the zero-upcall path
        cannot open spans itself)."""
        self.transport.set_nl_hists(nloop.hist_snapshots())
        nl = nloop.stats_snapshot()
        self.transport.set_nl_slow_frames(nl["slow_frames"],
                                          nl["tail_backlog_bytes"])
        for fr in nloop.slow_drain():
            total_ns = fr["read_ns"] + fr["wait_ns"] + fr["serve_ns"]
            obs.record_event(
                "slow_frame", conn=fr["conn"],
                wire_kind=tv.kind_name(fr["kind"]), size=fr["size"],
                read_ms=round(fr["read_ns"] / 1e6, 3),
                wait_ms=round(fr["wait_ns"] / 1e6, 3),
                serve_ms=round(fr["serve_ns"] / 1e6, 3),
                total_ms=round(total_ns / 1e6, 3),
                trace_id=fr["trace_id"] or None)
            if fr["trace_id"]:
                obs.tracer().record_external(
                    "slow_frame", "server", fr["trace_id"],
                    fr["span_id"] or None,
                    ts_us=time.time() * 1e6
                    - (fr["age_ns"] + total_ns) / 1e3,
                    dur_us=total_ns / 1e3,
                    conn=fr["conn"], wire_kind=tv.kind_name(fr["kind"]),
                    size=fr["size"],
                    read_us=round(fr["read_ns"] / 1e3, 1),
                    wait_us=round(fr["wait_ns"] / 1e3, 1),
                    serve_us=round(fr["serve_ns"] / 1e3, 1))

    def _punt_pool(self) -> _DaemonPool:
        """The pool for punted requests that cannot park (threads spawn on
        demand and are reused; only the pump calls this)."""
        pool = getattr(self, "_punt_executor", None)
        if pool is None:
            pool = _DaemonPool(max_workers=32, name="van-punt")
            self._punt_executor = pool
        return pool

    def _loop_close_conn(self, cid: int) -> None:
        """Drop one loop connection (a malformed frame: the framing is
        gone, as the threaded path poisons its channel)."""
        fd = self._nloop.detach(cid)
        if fd >= 0:
            os.close(fd)

    def _loop_serve_one(self, cid: int, msg, ptr: int,
                        admit_gen: int = 0) -> None:
        nloop = self._nloop
        if self._pump_abort:  # kill() landed mid-batch: drop, don't apply
            nloop.free(ptr)
            return
        try:
            kind, worker, tensors, extra = tv.decode(msg)
        except Exception:
            nloop.free(ptr)
            self._loop_close_conn(cid)
            return
        self._req_counter.inc()
        # a READ here missed the native cache: its exact request bytes are
        # the key its reply is published under (a copy: the frame is freed
        # after the reply)
        raw = (bytes(msg) if kind == tv.READ and self._native_read_cache
               else None)
        if kind == tv.SHUTDOWN:
            nloop.reply(cid, tv.encode(tv.OK, worker, None),
                        close_after=True)
            tensors = None
            nloop.free(ptr)
            with self._goodbye_cond:
                self.goodbyes += 1
                self._goodbye_cond.notify_all()
            return
        if kind == tv.SHM_SETUP:
            self._loop_shm_upgrade(cid, worker, extra, ptr)
            return
        barrier = kind in self._BARRIER_KINDS
        if kind in self._PUNT_KINDS or barrier or (
                kind in self._COMMIT_KINDS
                and (getattr(self, "_paused", False)
                     or self._loop_blockers > 0)) or (
                kind in self._REPLICATED_KINDS and self._replicating()):
            # a request that may park must not park the pump: a thread of
            # its own (a commit or a pull waits for a sync replica ack or a
            # full ack window; a commit for a checkpoint pause; a barrier
            # kind for the other members of its round).
            # ``_loop_blockers`` closes the pause race: a punted CHECKPOINT
            # sets ``_paused`` on its own thread, so the count is raised
            # here, before that thread starts, and held until its reply
            # went out; every commit seen meanwhile punts too
            blocker = kind in self._PUNT_KINDS
            with self._inflight_cond:
                self._inflight += 1  # the punted task's share
                if blocker:
                    self._loop_blockers += 1
            try:
                if blocker or barrier or getattr(self, "_paused", False) \
                        or self._loop_blockers > 0:
                    # fresh threads while parking is possible: a resume must
                    # never queue behind pool workers parked on its pause,
                    # nor a round's last push behind its parked members
                    threading.Thread(
                        target=self._loop_dispatch_reply,
                        args=(cid, kind, worker, tensors, extra, ptr, True,
                              blocker, raw, admit_gen),
                        daemon=True).start()
                else:
                    self._punt_pool().submit(
                        self._loop_dispatch_reply, cid, kind, worker,
                        tensors, extra, ptr, True, False, raw, admit_gen)
            except Exception as e:  # thread exhaustion: refuse, don't die
                with self._inflight_cond:
                    self._inflight -= 1
                    if blocker:
                        self._loop_blockers -= 1
                    self._inflight_cond.notify_all()
                nloop.reply(cid, tv.encode(tv.ERR, worker, None,
                                           extra={"error": repr(e)}))
                tensors = None
                nloop.free(ptr)
            return
        self._loop_dispatch_reply(cid, kind, worker, tensors, extra, ptr,
                                  False, raw=raw, admit_gen=admit_gen)

    def _reply_priority(self, kind: int, extra) -> int:
        """The loop's writev priority of this reply: a bucket frame's
        index (front of the model drains first), else 0. Only tails across
        connections reorder; a connection's replies keep their order."""
        if not self._bucket_priority:
            return 0
        if kind in (tv.BUCKET_PULL, tv.BUCKET_PUSH, tv.ROW_BUCKET_PUSH):
            try:
                return int((extra or {}).get("bucket") or 0)
            except (TypeError, ValueError):
                return 0
        return 0

    def _loop_dispatch_reply(self, cid: int, kind: int, worker: int,
                             tensors, extra, ptr: int, punted: bool,
                             blocker: bool = False, raw=None,
                             admit_gen: int = 0) -> None:
        nloop = self._nloop
        prio = self._reply_priority(kind, extra)
        # this thread serves a loop request for the dispatch: a pause park
        # inside it counts toward the native drain's discount (reset in
        # the finally: pool and pump threads are reused)
        this = threading.current_thread()
        this._ps_loop_req = True
        # the frame's admission stamp rides a thread-local to the apply;
        # set every time, so a previous request's stamp never leaks
        self._read_pub.admit = int(admit_gen)
        if kind in self._COMMIT_KINDS:
            self.transport.record_loop_push()
        try:
            if raw is not None:
                # pump and pool threads are reused: never publish under a
                # previous request's generation or tags
                self._read_pub.gen = None
                self._read_pub.tags = None
            reply = self._dispatch_reply_payload(kind, worker, tensors,
                                                 extra)
            if raw is not None and isinstance(reply, (bytes, bytearray)):
                self._publish_read(raw, reply)
            try:
                nloop.reply(cid, reply, priority=prio)  # False = gone
            finally:
                # only now is the body dead: the reply may alias it, and
                # every copy out of it to the card was waited for in the
                # handler (stage_to_device), so free cannot race a DMA
                tensors = None
                nloop.free(ptr)
        finally:
            this._ps_loop_req = False
            if punted:
                with self._inflight_cond:
                    self._inflight -= 1
                    if blocker:
                        self._loop_blockers -= 1
                    self._inflight_cond.notify_all()

    def _publish_read(self, raw: bytes, reply) -> None:
        """Publish on miss: the READ reply the pump is about to send
        becomes the native cache's entry for the request bytes ``raw``, at
        the generation its handler captured, so a hit is bitwise this
        reply. Three shapes: a NOT_MODIFIED reply is published as a
        version-floor entry (the loop cuts the request's cond digits out of
        the key, so a conditional READ at any version at or above the
        stamp shares it); any other reply to a conditional request depends
        on the caller's version and is not published; an unconditional
        reply is published under its exact bytes. A put the floor refuses
        (an apply overtook it) or the budget refuses (an entry larger than
        the cache) is counted by the loop (``rejects``)."""
        gen = getattr(self._read_pub, "gen", None)
        if gen is None:
            return  # an ERR reply, or no snapshot was taken
        tags = getattr(self._read_pub, "tags", None)
        version = int(getattr(self._read_pub, "version", 0))
        if len(reply) >= 1 and reply[0] == tv.NOT_MODIFIED:
            if self._nloop.cache_put_cond(raw, reply, gen, tags=tags,
                                          vfloor=version):
                self._read_pub_version = version
        elif b'"cond":' not in raw[-4096:]:
            if self._nloop.cache_put(raw, reply, gen, tags=tags):
                self._read_pub_version = version

    def _loop_shm_upgrade(self, cid: int, worker: int, extra: dict,
                          ptr: int) -> None:
        """SHM_SETUP on the loop: detach the connection's fd and serve it
        from a thread of its own (the ring wait is GIL-free native code,
        and epoll cannot wait on ring cursors). A refused upgrade keeps
        the connection on that thread too, over TCP."""
        from ps_tpu_torch.control import native_loop as nlmod

        nloop = self._nloop
        nloop.free(ptr)  # SHM_SETUP carries no tensors; extra is decoded
        fd = nloop.detach(cid)
        if fd < 0:
            return  # the connection died under the request
        ch = nlmod.adopt_channel(fd)
        ch.stats = self.transport
        ch.pool = self._recv_pool
        lane, reply = self._try_shm_upgrade(ch, worker, extra)
        try:
            send_payload(ch, reply)
        except tv.VanError:
            (lane if lane is not None else ch).close()
            return
        with self._chan_lock:
            self._conns = [t for t in self._conns
                           if t.ident is None or t.is_alive()]
            if self._stop.is_set():
                (lane if lane is not None else ch).close()
                return
            self._channels.append(ch)
            t = threading.Thread(target=self._serve, args=(ch, lane),
                                 daemon=True)
            self._conns.append(t)
        t.start()

    # -- lifecycle -------------------------------------------------------------

    def wait_for_goodbyes(self, n: int, timeout: Optional[float] = None
                          ) -> bool:
        """Block until ``n`` workers have sent SHUTDOWN; False on timeout.
        A worker's close() says goodbye only after every push of it was
        applied and replied, so ``goodbyes == num_workers`` means nothing
        is outstanding."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._goodbye_cond:
            while self.goodbyes < n:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._goodbye_cond.wait(left)
        return True

    def kill(self) -> None:
        """Abrupt death, as a SIGKILL would leave it (drills): sever the
        listener and every connection now; no drain, no draining flag, and
        on the loop the queued frames are dropped unapplied."""
        self._stop.set()
        if self._nloop is not None:
            self._pump_abort = True
            self._nloop.stop_accept()
            self._nloop.shutdown_conns()
            self._nloop.begin_stop()
            self._pump_thread.join(timeout=5)
            if not self._pump_thread.is_alive():
                self._nloop.close()  # a pump stuck mid-apply keeps it
        else:
            self._accept_thread.join(timeout=5)
        self._listener.close()
        s = self._backup_session
        if s is not None:
            s.close()
        with self._chan_lock:
            chans = list(self._channels)
        for ch in chans:
            ch.shutdown()  # serve threads wake with VanError and close

    def stop(self, grace: float = 10.0) -> None:
        """Graceful drain, then sever: no push is applied after this
        returns, and no reply in flight when it was called is torn.

        Requests parked on a checkpoint pause do not count toward the
        drain wait (they finish only once the draining flag wakes them
        into refusal); they get a short window for their ERR replies."""
        self._stop.set()
        if self._nloop is not None:
            self._stop_native(grace)
            return
        # join before closing: the accept thread may be inside tv_accept
        self._accept_thread.join(timeout=5)
        self._listener.close()
        deadline = time.monotonic() + grace
        while True:
            with self._inflight_cond:
                while (self._inflight - self._pause_blocked > 0
                       and time.monotonic() < deadline):
                    self._inflight_cond.wait(deadline - time.monotonic())
                drained = self._inflight - self._pause_blocked == 0
            if not drained:
                logging.getLogger(__name__).warning(
                    "request(s) still in flight after %.1fs drain grace; "
                    "severing anyway", grace)
                break
            # a serve thread whose recv just returned may not have marked
            # itself in flight yet: only a zero that holds proceeds
            time.sleep(0.05)
            with self._inflight_cond:
                if self._inflight - self._pause_blocked == 0:
                    break
            if time.monotonic() >= deadline:
                break
        self._set_draining()
        self._sever_serve_threads(deadline)
        self._close_backup_session()

    def _close_backup_session(self) -> None:
        s = self._backup_session
        if s is not None:
            s.close()  # after the drain: every acked commit replicated

    def _sever_serve_threads(self, deadline: float, extra_alive=()) -> None:
        """After the draining flag: a short window for pause-parked
        requests' ERR replies, then sever every serve thread's channel and
        join the threads."""
        with self._inflight_cond:
            end = min(deadline, time.monotonic() + 2.0)
            while self._inflight > 0 and time.monotonic() < end:
                self._inflight_cond.wait(max(end - time.monotonic(), 0.01))
        with self._chan_lock:
            chans = list(self._channels)
            conns = list(self._conns)
        for ch in chans:
            ch.shutdown()  # each serve thread closes its own channel
        for t in conns:
            t.join(timeout=5)
        stragglers = [t for t in list(conns) + list(extra_alive)
                      if t.is_alive()]
        if stragglers:
            logging.getLogger(__name__).warning(
                "%d serve thread(s) outlived the drain join; their pushes "
                "are refused by the draining flag", len(stragglers))

    def _stop_native(self, grace: float) -> None:
        """stop() on the native loop: the same contract, where "in flight"
        is the pump's count plus the loop's pending frames (read but not
        handed out, claimed and awaiting their reply, unflushed tails), so
        a reply the loop has not finished writing is never torn."""
        nloop = self._nloop
        nloop.stop_accept()  # freeze the connection set
        deadline = time.monotonic() + grace

        def quiet() -> bool:
            with self._inflight_cond:
                infl = self._inflight - self._pause_blocked
                parked = self._loop_pause_parked
            # a pause-parked loop request holds one claimed body until its
            # reply: discounted from the loop's pending count too
            return infl <= 0 and nloop.pending() - parked <= 0

        drained = False
        while time.monotonic() < deadline:
            if quiet():
                # a frame the loop just completed may not be counted yet
                time.sleep(0.05)
                if quiet():
                    drained = True
                    break
            else:
                time.sleep(0.02)
        if not drained:
            logging.getLogger(__name__).warning(
                "request(s) still in flight after %.1fs drain grace; "
                "severing anyway", grace)
        self._set_draining()
        with self._inflight_cond:
            end = min(deadline, time.monotonic() + 2.0)
            while self._inflight > 0 and time.monotonic() < end:
                self._inflight_cond.wait(max(end - time.monotonic(), 0.01))
        end = min(deadline, time.monotonic() + 0.5)
        while nloop.pending() > 0 and time.monotonic() < end:
            time.sleep(0.02)
        nloop.shutdown_conns()  # idle peers see EOF now
        nloop.begin_stop()
        self._pump_thread.join(timeout=5)
        # shm-detached connections are classic serve threads
        self._sever_serve_threads(deadline,
                                  extra_alive=[self._pump_thread])
        if not self._pump_thread.is_alive():
            nloop.close()  # punted threads' reply/free no-op after close
        self._listener.close()
        self._close_backup_session()
