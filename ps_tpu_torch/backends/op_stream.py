"""The op stream of a dense async server across ranks.

A served async engine across k ranks (``AsyncCudaServer`` over a mesh of
k processes) is k processes of one ``torch.distributed`` group. Rank 0
runs the :class:`~ps_tpu_torch.backends.remote_async.AsyncPSService`:
the listener, the native loop, replication, the dedup tokens, the event
log, the coordinator link. Ranks 1..k-1 follow. Every call of rank 0's
service that changes engine state or runs a collective goes first from
rank 0 to every follower as one op of this stream, broadcast under the
engine-lock hold that then runs it, so every rank makes the same engine
calls in rank 0's engine-lock order and the collectives of an apply pair
the same pushes. This is how the port's k processes stand in for the
reference's one controller of a mesh.

The ops (:data:`OPS`), each named beside the service call that emits it
in ``backends/remote_async.py``:

- ``push`` / ``push_sub``: a decoded gradient tree (host arrays) and the
  pusher, for ``push_tree`` / ``push_subtree``. A served push is the
  global gradient: every rank steps its owned blocks of it, no mean over
  the ranks (``AsyncCudaServer._apply_dc_tree``);
- ``pull``: ``pull_tree(worker)`` sets each rank's stale snapshots and
  the worker's version, which the DC correction of its blocks reads;
- ``export``: ``export_keys``: every rank joins the all-gathers of the
  owned optimizer-state blocks into whole leaves; rank 0 keeps the rows;
- ``adopt`` (the row) and ``evict``: every rank places, or drops, its
  blocks;
- ``meta``: a seed's engine counters (``_load_checkpoint_meta``);
- ``save``: ``KVStore.save`` across ranks (its barriers, one file a
  rank);
- ``noop``: keeps an idle follower's receive inside the group's timeout;
- ``stop``: releases the followers.

A READ needs no op: the async engine's parameters are whole on every
rank, so rank 0 answers from its own tensors. Native push admission acks
replays in the loop with no engine call, so it needs none either, and
the dedup ledger stays on rank 0.

The stream runs on a gloo group of its own, apart from the engine's
collectives, and carries host buffers (one pickled op: a length, then
the bytes); a follower stages a push's arrays onto its device as rank 0
does (``stage_to_device``). Gloo's sends take CPU tensors only, so two
ranks sharing one card (NCCL refuses them) carry the stream as well.

A rank's death does not hang the service: rank 0's next broadcast to a
dead follower raises, and with the backend's heartbeat detector on, the
``WorkerFailureError`` it declares stops the stream as well. Either way
the service stops serving at once (``AsyncPSService._rank_lost``), so
workers see ``ServerFailureError``, or fail over to a backup; a request
that raced it is refused as not serving (:class:`RankLostError`). A
follower whose rank 0 died sees its receive raise.
"""

from __future__ import annotations

import collections
import datetime
import io
import logging
import pickle
import threading
import time
from typing import Callable, Optional

import torch

from ps_tpu_torch.backends.common import stage_to_device
from ps_tpu_torch.backends.van_service import NotServingError

#: the ops rank 0 sends, in the order the module docstring names them
OPS = ("push", "push_sub", "pull", "export", "adopt", "evict", "meta",
       "save", "noop", "stop")


class RankLostError(NotServingError):
    """A rank of a server across ranks failed: its service stops serving
    (a worker's request that raced the stop is refused as not serving,
    the retryable failure a dead server raises)."""


class OpStream:
    """Rank 0's op broadcasts, or a follower's loop over them, for one
    async store across ranks. Every rank constructs it at once (the group
    is made collectively); ``leader`` is rank 0's.

    Rank 0: :meth:`send` under the engine lock, :meth:`close` at its
    service's stop. A follower: :meth:`follow` (blocking) or :meth:`start`
    (a thread), then :meth:`join` (or :meth:`stop`), which return at rank
    0's ``stop`` and raise where the stream failed.

    ``ops`` and ``bytes`` count what the stream carried (the length words
    included), ``by_op`` and ``bytes_by_op`` the same by op name, on every
    rank."""

    def __init__(self, store):
        import torch.distributed as dist

        from ps_tpu_torch.backends.cuda import GROUP_TIMEOUT_S

        engine = store._engine
        mesh = engine.mesh
        self._store = store
        self._engine = engine
        ranks = dist.get_process_group_ranks(mesh.world)
        self._src = ranks[0]
        self._group = dist.new_group(
            ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        self.rank = mesh.world_rank
        self.world = len(ranks)
        self.leader = self.rank == 0
        self.ops = 0
        self.bytes = 0
        self.by_op: collections.Counter = collections.Counter()
        self.bytes_by_op: collections.Counter = collections.Counter()
        #: called once with the error when the stream fails on rank 0
        self.on_failure: Optional[Callable[[BaseException], None]] = None
        self._error: Optional[BaseException] = None
        self._fail_lock = threading.Lock()
        self._closed = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last = time.monotonic()
        # an idle follower waits in a receive bounded by the group's
        # timeout: rank 0 sends a noop a quarter of it after its last op
        self._keepalive_s = GROUP_TIMEOUT_S / 4
        # served until rank 0's stop: the engine takes global gradients
        engine._ops = self
        if self.leader:
            threading.Thread(target=self._keepalive, daemon=True,
                             name="ps-op-keepalive").start()
            backend = getattr(getattr(store, "_ctx", None), "backend", None)
            if getattr(backend, "failure_detector", None) is not None:
                threading.Thread(target=self._watch_health, args=(backend,),
                                 daemon=True, name="ps-op-health").start()

    @classmethod
    def over(cls, store) -> Optional["OpStream"]:
        """The stream of ``store`` when its engine spans several ranks
        (every rank must call it), else None."""
        mesh = getattr(store._engine, "mesh", None)
        if mesh is None or mesh.world is None or mesh.world_size == 1:
            return None
        return cls(store)

    # -- rank 0 ----------------------------------------------------------------

    def send(self, op: str, **args) -> None:
        """Broadcast one op to every follower (rank 0, engine lock held,
        right before rank 0 runs the same call). Raises
        :class:`RankLostError` once the stream failed."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        if self._error is not None:
            raise RankLostError(f"a rank of this server across ranks "
                                f"failed: {self._error!r}")
        buf = io.BytesIO()
        pickle.dump((op, args), buf, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self._broadcast(buf.getbuffer())
        except Exception as e:
            self.fail(e)
            raise RankLostError(f"a rank of this server across ranks "
                                f"failed: the {op!r} op's broadcast raised "
                                f"{e!r}") from e
        self._count(op, buf.getbuffer().nbytes)
        self._last = time.monotonic()

    def _broadcast(self, payload) -> None:
        import torch.distributed as dist

        n = torch.tensor([payload.nbytes], dtype=torch.int64)
        dist.broadcast(n, self._src, group=self._group)
        dist.broadcast(torch.frombuffer(payload, dtype=torch.uint8),
                       self._src, group=self._group)

    def _count(self, op: str, nbytes: int) -> None:
        self.ops += 1
        self.bytes += nbytes + 8
        self.by_op[op] += 1
        self.bytes_by_op[op] += nbytes + 8

    def fail(self, err: BaseException) -> None:
        """Mark the stream failed (rank 0): every later :meth:`send`
        refuses, and ``on_failure`` runs once, on a thread of its own."""
        with self._fail_lock:
            if self._error is not None:
                return
            self._error = err
        self._closed.set()
        cb = self.on_failure
        if cb is not None:
            threading.Thread(target=cb, args=(err,), daemon=True,
                             name="ps-op-failure").start()

    def close(self) -> None:
        """Release the followers (rank 0, after its service drained); the
        engine takes its ranks' own gradients again."""
        if not self.leader or self._closed.is_set():
            return
        with self._engine._lock:
            self._closed.set()
            if self._error is None:
                try:
                    self.send("stop")  # pslint: disable=PSL101 -- the stop is the stream's last op, ordered after every engine call by the engine lock; a dead follower fails the broadcast (RankLostError, caught here), and the gloo group's timeout bounds the hold
                except RankLostError:
                    pass  # a dead follower needs no release
                self._engine._ops = None

    def _keepalive(self) -> None:
        while not self._closed.wait(min(self._keepalive_s, 30.0)):
            if time.monotonic() - self._last < self._keepalive_s:
                continue
            with self._engine._lock:
                if self._closed.is_set():
                    return
                try:
                    self.send("noop")  # pslint: disable=PSL101 -- the keepalive noop is ordered between engine calls by the engine lock; a dead follower fails the broadcast (RankLostError ends the keepalive), and the gloo group's timeout bounds the hold
                except RankLostError:
                    return

    def _watch_health(self, backend) -> None:
        """Poll the backend's heartbeat detector at its beat interval: a
        rank it declares dead fails the stream."""
        from ps_tpu_torch.control.heartbeat import WorkerFailureError

        every = max(int(backend.config.heartbeat_interval_ms), 10) / 1e3
        while not self._closed.wait(every):
            try:
                backend.check_health()
            except WorkerFailureError as e:
                logging.getLogger(__name__).error(
                    "server across ranks: %s", e)
                self.fail(e)
                return

    # -- a follower ------------------------------------------------------------

    def _recv(self):
        import torch.distributed as dist

        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, self._src, group=self._group)
        buf = torch.empty(int(n.item()), dtype=torch.uint8)
        dist.broadcast(buf, self._src, group=self._group)
        op, args = pickle.loads(buf.numpy())
        return op, args, buf.numel()

    def follow(self) -> None:
        """Run rank 0's ops on this rank until its ``stop`` (a follower).
        An op that raises here raised on rank 0 too (the same call on the
        same state), where it became the request's ERR reply: it is
        logged and the loop goes on. A failed receive (rank 0 died)
        raises :class:`RankLostError`."""
        if self.leader:
            raise RuntimeError("rank 0 serves; only ranks 1..k-1 follow")
        log = logging.getLogger(__name__)
        while True:
            try:
                op, args, nbytes = self._recv()
            except Exception as e:
                raise RankLostError(f"rank {self.rank}: the op stream from "
                                    f"rank 0 failed: {e!r}") from e
            self._count(op, nbytes)
            if op == "stop":
                self._engine._ops = None
                return
            if op == "noop":
                continue
            try:
                with self._engine._lock:
                    self._run(op, args)
            except Exception as e:
                log.warning("rank %d: op %r raised %r (as it did on rank 0)",
                            self.rank, op, e, exc_info=True)

    def _run(self, op: str, a: dict) -> None:
        eng = self._engine
        if op in ("push", "push_sub"):
            grads = stage_to_device(a["grads"], eng.device)
            if op == "push":
                eng.push_tree(grads, worker=a["worker"])
            else:
                eng.push_subtree(grads, worker=a["worker"])
        elif op == "pull":
            eng.pull_tree(worker=a["worker"])
        elif op == "export":
            eng.export_keys(a["keys"])
        elif op == "adopt":
            eng.adopt_key(a["key"], a["param"], a["state"], a["stale"],
                          a["apply_count"])
        elif op == "evict":
            eng.evict_keys(a["keys"])
        elif op == "meta":
            eng._load_checkpoint_meta(a["meta"])
        elif op == "save":
            self._store.save(a["path"])
        else:
            raise ValueError(f"unknown op {op!r}")

    def start(self) -> "OpStream":
        """:meth:`follow` on a thread of its own; returns self."""
        self._thread = threading.Thread(target=self._follow_thread,
                                        daemon=True, name="ps-op-follower")
        self._thread.start()
        return self

    def _follow_thread(self) -> None:
        try:
            self.follow()
        except BaseException as e:  # re-raised by join()
            self._error = e
        finally:
            self._done.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for rank 0's ``stop`` (a started follower); False on
        timeout. Raises what ended the loop otherwise."""
        if not self._done.wait(timeout):
            return False
        if self._error is not None:
            raise self._error
        return True

    #: a follower's stop ends with rank 0's: the same wait
    stop = join
