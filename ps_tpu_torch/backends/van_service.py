"""Shared serve/accept/drain machinery for van-backed PS services.

Counterpart of ``ps_tpu/backends/van_service.py``, thread-per-connection
as the reference serves by default: a TCP listener, one serve thread per
worker connection, a request -> reply loop over framed tensor messages,
and a stop that never tears a reply off the wire. The concrete service
(``AsyncPSService`` in ``remote_async.py``) provides the protocol
(:meth:`VanService._handle`) and the commit gate
(:meth:`VanService._set_draining`); ``SparsePSService`` in
``remote_sparse.py`` also calls the apply-path hooks of native admission,
the read cache and replication, which stay inert here.

The drain contract: ``stop()`` first stops admitting connections (accept
thread joined, listener closed), then waits (bounded by ``grace``) for
every request whose frame has arrived to finish its reply, and only then
sets the draining flag (refusing any straggler commit under the
subclass's apply lock) and severs the remaining channels, which are idle
in ``recv`` by then. A request whose processing has begun completes: its
push is applied and its whole reply reaches the worker. Workers that need
a clean end send ``SHUTDOWN`` first (``worker.close()`` does), counted in
:attr:`VanService.goodbyes`, so a server can :meth:`wait_for_goodbyes`
before stopping.

Not ported yet (ROADMAP Queue 1 item 5), each refused loudly: the native
epoll serve loop (``native_loop=True`` or ``PS_VAN_NATIVE_LOOP=1``), the
shared-memory lane (``shm=True`` raises; a worker's ``SHM_SETUP`` offer is
answered ERR, so the connection stays TCP, as a refusing reference server
keeps it) and the replica/backup/promotion paths (``backup=True`` raises;
replication kinds are answered ERR).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ps_tpu_torch.backends.common import BucketAssembler, send_payload
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.utils.metrics import TransportStats


class NotServingError(RuntimeError):
    """Raised inside a handler when this service must refuse the request
    retryably; the serve loop answers an ERR carrying ``backup: True``,
    which the worker maps to :class:`ServerFailureError`."""


class RingLog:
    """Fixed-size tail of an append-only log, plus the total count: a
    server of 10^6 applies must not hold O(applies) memory.
    ``record_full_history=True`` takes :class:`FullLog` instead, for the
    replay-parity checks that need every entry."""

    def __init__(self, maxlen: int = 4096):
        import collections

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
    """A small pool of reusable daemon threads: a worker is spawned per
    submit only while none is idle (up to ``max_workers``), extra tasks
    queue. The reference's native serve loop hands blocking requests to
    it; daemon threads, so a task parked forever never blocks exit."""

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
    """One listener and one serve thread per connection over the tensor van.

    Subclasses call ``VanService.__init__`` last in their ``__init__`` (it
    starts accepting at once), implement ``_handle(kind, worker, tensors,
    extra)`` returning the encoded reply (raise to send ERR), and
    ``_set_draining()``: under the apply lock, set the flag the commit
    path checks so no push lands after ``stop()`` returns.
    """

    #: kinds of the replication plane (replica/, not ported yet)
    _REPLICA_KINDS = frozenset({tv.REPLICA_HELLO, tv.REPLICA_APPEND,
                                tv.REPLICA_PROMOTE, tv.REPLICA_STATE,
                                tv.REPLICA_SEED})

    def __init__(self, port: int = 0, bind: str = "127.0.0.1",
                 writev: Optional[bool] = None, shm: Optional[bool] = None,
                 backup: bool = False, native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None):
        from ps_tpu_torch.config import env_flag

        if native_loop if native_loop is not None else env_flag(
                "PS_VAN_NATIVE_LOOP", False):
            raise NotImplementedError(
                "native_loop: the native epoll serve loop "
                "(control/native_loop.py) is not ported yet (ROADMAP Queue "
                "1 item 5.1); serve thread-per-connection (the default)")
        if backup:
            raise NotImplementedError(
                "backup=True: shard replication (replica/) is not ported "
                "yet (ROADMAP Queue 1 item 5.6)")
        if shm:
            raise NotImplementedError(
                "shm=True: the shared-memory lane (control/shm_lane.py) is "
                "not ported yet (ROADMAP Queue 1 item 5.2); a worker's offer "
                "is refused and it stays on TCP")
        del loop_threads  # sizes the native loop only
        # vectored replies: live snapshot views go to the kernel as iovecs
        self.writev = (env_flag("PS_WRITEV", True)
                       if writev is None else bool(writev))
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
        # a request frame is dead once its reply is sent, so the serve
        # loop borrows its receive buffer and returns it per request
        self._recv_pool = tv.RecvBufferPool(stats=self.transport)
        # checkpoint ownership token (issued at pause, checked by every
        # later phase, cleared at resume); under the subclass's apply lock
        self._ckpt_token: Optional[int] = None
        self._ckpt_seq = 0
        # what the HELLO reply advertises: a primary at shard-table epoch
        # 0 of a static topology (replication and elastic membership are
        # not ported)
        self.role = "primary"
        self.epoch = 0
        self.table_epoch = 0
        self.goodbyes = 0  # workers that sent SHUTDOWN (clean departures)
        self._goodbye_cond = threading.Condition()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._listener.port

    # -- provided by the concrete service --------------------------------------

    def _handle(self, kind: int, worker: int, tensors, extra):
        raise NotImplementedError

    def _set_draining(self) -> None:
        raise NotImplementedError

    def replica_state(self) -> dict:
        """Role and epoch (merged into the STATS reply)."""
        return {"role": self.role, "epoch": self.epoch, "now": time.time(),
                "dedup_hits": self.transport.dedup_hits}

    # -- hooks of the sparse service's apply path, inert until their
    # features are ported (each refused at construction meanwhile) ----------

    def _admit_fresh_hint(self) -> bool:
        """Native admission's freshness stamp (ROADMAP Queue 1 item 5.1)."""
        return False

    def _admit_publish(self, worker: int) -> None:
        """Republish a worker's ledger row to native admission (item 5.1)."""

    def _invalidate_reads(self, tags=None) -> None:
        """Drop the cached READ replies an apply made stale (item 5.8)."""

    def _replicate(self, op: str, worker: int, tensors, extra) -> None:
        """Stream a committed apply to the backups (item 5.6)."""

    def _await_replication(self, seq) -> None:
        """Wait for the backups' ack of a replicated apply (item 5.6)."""

    def _dispatch(self, kind: int, worker: int, tensors, extra):
        if kind in self._REPLICA_KINDS:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": (f"{tv.kind_name(kind)}: shard replication "
                          f"(replica/) is not ported yet (ROADMAP Queue 1 "
                          f"item 5.6)")})
        return self._handle(kind, worker, tensors, extra)

    def _dispatch_reply_payload(self, kind: int, worker: int, tensors,
                                extra):
        """Dispatch, mapping a raised error to an ERR reply: NotServing ->
        the retryable refusal, anything else -> a plain ERR."""
        try:
            return self._dispatch(kind, worker, tensors, extra)
        except NotServingError as e:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": str(e), "backup": True, "epoch": self.epoch})
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
        (stop() discounts it)."""
        with self._inflight_cond:
            self._pause_blocked += 1
            self._inflight_cond.notify_all()

    def _pause_wait_end(self) -> None:
        with self._inflight_cond:
            self._pause_blocked -= 1
            self._inflight_cond.notify_all()

    # -- accept / serve --------------------------------------------------------

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

    def _serve(self, ch: tv.Channel) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = ch.recv()
                except tv.VanError:
                    return  # worker hung up (or stop() severed an idle conn)
                with self._inflight_cond:
                    self._inflight += 1
                try:
                    kind, worker, tensors, extra = tv.decode(msg)
                    goodbye = kind == tv.SHUTDOWN
                    if goodbye:
                        reply = tv.encode(tv.OK, worker, None)
                    elif kind == tv.SHM_SETUP:
                        # the worker falls back to TCP on this refusal
                        reply = tv.encode(tv.ERR, worker, None, extra={
                            "error": ("shm lane not available on this "
                                      "server (control/shm_lane.py is not "
                                      "ported; ROADMAP Queue 1 item 5.2)")})
                    else:
                        reply = self._dispatch_reply_payload(
                            kind, worker, tensors, extra)
                    try:
                        send_payload(ch, reply)
                    except tv.VanError:
                        return  # worker vanished mid-reply
                    finally:
                        # only now is the request frame dead: a reply may
                        # hold views of it until sent
                        tensors = None
                        self._recv_pool.ret(msg)
                        msg = None
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
        listener and every connection now; no drain, no draining flag."""
        self._stop.set()
        self._accept_thread.join(timeout=5)
        self._listener.close()
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
        stragglers = [t for t in conns if t.is_alive()]
        if stragglers:
            logging.getLogger(__name__).warning(
                "%d serve thread(s) outlived the drain join; their pushes "
                "are refused by the draining flag", len(stragglers))
