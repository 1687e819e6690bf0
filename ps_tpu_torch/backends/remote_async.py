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

Tensors cross the van as numpy views of host memory. A CUDA tensor is
first copied to pinned host memory and the copy waited for before the
send (``stage_to_host``); a received tensor for the card is copied there
and waited for before its frame's buffer is reused (``stage_to_device``).
The frames are the reference's, so a port worker talks to a reference
server and a reference worker to a port server.

Parity: each server records its apply order (``event_log``); replaying
that (worker, grads) sequence through a one-process ``AsyncCudaServer``
per key range gives bitwise the same parameters.

Not ported yet, each raising with its ROADMAP item: gradient compression
(``compress/``), elastic membership (``coordinator=``, the ``MIGRATE_*``
kinds; item 6), the aggregator, replica sets and backups, the read path
(``READ``, ``read_staleness``, ``pull_cache``), the shared-memory lane and
the native serve loop (item 5 all), and the reference's trace spans and
metrics endpoint (``obs/``, item 6). Extra keys in an incoming frame, such
as a trace context, are ignored.
"""

from __future__ import annotations

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
    parse_replica_uri,
    payload_nbytes,
    request_payload,
    stage_to_device,
    stage_to_host,
)
from ps_tpu_torch.backends.van_service import (
    VanService,
    log_tail,
    make_history_log,
    resolve_ckpt_dir,
)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.utils.metrics import TransportStats

__all__ = [
    "AsyncPSService", "RemoteAsyncWorker", "ServerFailureError",
    "serve_async", "connect_async", "shard_tree", "PendingCycle",
    "CheckpointRoundError",
]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


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

    The pull path leans on the engine's out-of-place applies: a snapshot
    taken under the engine lock is a set of tensors no later apply writes
    into, so it is copied off the card and sent outside the lock while
    other workers apply. An in-place apply would tear such pulls.
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
                 loop_threads: Optional[int] = None):
        engine = store._engine
        if getattr(engine, "mode", "sync") != "async":
            raise ValueError("AsyncPSService requires an async-mode KVStore")
        if coordinator is not None:
            raise _not_ported("coordinator= (elastic membership, elastic/)",
                              "6")
        if (shard is None) != (num_shards is None):
            raise ValueError("pass shard and num_shards together")
        del advertise_host  # only an elastic member advertises itself
        self.shard, self.num_shards = shard, num_shards
        self._store = store
        self._engine = engine
        self._device = torch.device(engine.device)
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
        super().__init__(port=port, bind=bind, writev=writev, shm=shm,
                         backup=backup, native_loop=native_loop,
                         loop_threads=loop_threads)

    # -- server internals -----------------------------------------------------

    def _snapshot(self, worker: int):
        """One atomic pull under the engine lock: the tensors, the version
        and the event-log record mirror the engine's true order."""
        with self._engine._lock:
            kv = self._engine.pull_tree(worker=worker)
            version = self._engine.version
            key_order = list(self._key_order)
            with self._log_lock:
                self.event_log.append(["pull", worker])
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

    def _apply_push(self, worker: int, grads: Dict[str, np.ndarray],
                    extra: Optional[dict] = None) -> bool:
        """Apply one whole-tree push; returns whether it was a dedup replay.

        ``extra``'s ``pseq``/``pnonce`` are the worker's dedup token: a
        (nonce, seq) at or below the last applied one is a replay and is
        acked without applying."""
        extra = extra or {}
        if extra.get("enc"):
            raise _not_ported("a codec-packed push (compress/)", "5")
        if extra.get("members"):
            raise _not_ported("a merged push (the aggregator)", "5")
        pseq = extra.get("pseq")
        pnonce = extra.get("pnonce")
        # onto the engine's device before the lock (a CUDA copy is waited
        # for); this also copies out of the receive buffer
        grads = stage_to_device(grads, self._device, stats=self.transport)
        with self._engine._lock:
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
            # lock, so the ledger may have moved meanwhile
            fresh = grads
            if pseq is not None:
                fresh = self._dedup_fresh(worker, pnonce, int(pseq), grads)
                if not fresh:
                    self.transport.record_dedup_hit()
                    return True
            self._check_push_keys(grads)
            if len(fresh) != len(grads):
                # only a replay straddling a key-range move leaves part of
                # a tree owed, and ranges move only under elastic membership
                raise _not_ported("a partial replay across a key-range move "
                                  "(elastic/)", "6")
            self._engine.push_tree(fresh, worker=worker)
            self._applied[worker] = self._applied.get(worker, 0) + 1
            if pseq is not None:
                toks = self._applied_pseq.setdefault(worker, {})
                for k in fresh:
                    toks[k] = (pnonce, int(pseq))
            self._pause_cond.notify_all()  # a drain_to waiter may watch
            with self._log_lock:
                self.apply_log.append(worker)
                self.event_log.append(["push", worker])
        return False

    def _dedup_fresh(self, worker: int, pnonce, pseq: int, grads):
        """The keys still owed an apply (lock held): a key whose last
        applied token is at or past (pnonce, pseq) already carries this
        push. Same-nonce comparison only: a new nonce is a new worker
        incarnation whose seqs restart."""
        toks = self._applied_pseq.get(worker)
        if not toks:
            return grads
        return {k: v for k, v in grads.items()
                if not (toks.get(k) is not None and toks[k][0] == pnonce
                        and pseq <= toks[k][1])}

    def _check_push_keys(self, grads) -> None:
        if sorted(grads) != sorted(self._key_order):
            raise KeyError("push keys do not match the registered tree")

    def _admit_while_paused(self, worker: int) -> bool:
        """Under pause, admit exactly the pushes a drain_to round asked
        for: this worker still lags its cross-shard target."""
        return (self._applied.get(worker, 0)
                < self._drain_targets.get(worker, 0))

    def _push_reply(self, worker: int, dedup: bool, **extra):
        return tv.encode(tv.OK, worker, None, extra={
            "version": self._engine.version, **extra, "dedup": dedup})

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
        dedup = self._apply_push(worker, tree, extra=extra)
        return self._push_reply(worker, dedup, committed=True)

    def _bucket_pull(self, worker: int, extra):
        """Bucketed pull: bucket 0 takes one atomic snapshot (as a serial
        PULL, event-log record included) and replies with the front
        slices; buckets 1..n-1 read the cached snapshot, each encoded on
        the serve thread that asks."""
        epoch, b = int(extra["epoch"]), int(extra["bucket"])
        if b == 0:
            if extra.get("compress"):
                raise _not_ported("a compressed pull (compress/)", "5")
            bb = int(extra.get("bucket_bytes") or DEFAULT_BUCKET_BYTES)
            kv, version, key_order = self._snapshot(worker)
            host = stage_to_host(kv, stats=self.transport)
            plan = BucketPlan.from_arrays(host, bb, order=key_order)
            with self._stage_lock:
                if plan.nbuckets > 1:
                    self._pull_cache[worker] = {
                        "epoch": epoch, "host": host, "plan": plan,
                        "version": version,
                        "left": set(range(1, plan.nbuckets)),
                    }
                else:
                    self._pull_cache.pop(worker, None)
            return plan.bucket_encoder(self.writev)(
                tv.OK, worker, host, 0,
                extra={"epoch": epoch, "version": version, "enc": []})
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
            extra={"epoch": epoch, "version": entry["version"], "enc": []})

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
        if kind == tv.PUSH:
            dedup = self._apply_push(worker, tensors, extra=extra)
            return self._push_reply(worker, dedup)
        if kind == tv.PUSH_PULL:
            self._apply_push(worker, tensors, extra=extra)
            return self._params_payload(worker)
        if kind == tv.BUCKET_PUSH:
            return self._bucket_push(worker, tensors, extra)
        if kind == tv.BUCKET_PULL:
            return self._bucket_pull(worker, extra)
        if kind == tv.STATS:
            return self._stats(worker)
        if kind == tv.CHECKPOINT:
            return self._checkpoint(worker, extra)
        if kind in (tv.READ, tv.NOT_MODIFIED):
            raise _not_ported("the read path (READ)", "5")
        if kind in (tv.MIGRATE_OUT, tv.MIGRATE_BEGIN, tv.MIGRATE_ROW,
                    tv.MIGRATE_COMMIT, tv.MIGRATE_ABORT):
            raise _not_ported(f"{tv.kind_name(kind)} (elastic/)", "6")
        if kind == tv.RESEED:
            raise _not_ported("RESEED (replica/)", "5")
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
                applied = {str(w): n for w, n in self._applied.items()}
            return tv.encode(tv.OK, worker, None, extra={
                "version": self._engine.version, "applied": applied,
                "token": token})
        if phase == "resume" and extra.get("force"):
            with self._engine._lock:
                self._paused = False
                self._ckpt_clear_token()
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
                self._pause_cond.notify_all()
            return tv.encode(tv.OK, worker, None,
                             extra={"version": self._engine.version})
        base = resolve_ckpt_dir(self._ckpt_root, extra["dir"])
        path = (base if self.num_shards is None
                else os.path.join(base, f"shard{self.shard}"))
        with self._engine._lock:
            self._store.save(path)
            version = self._engine.version
        return tv.encode(tv.OK, worker, None,
                         extra={"version": version, "path": path})

    def _set_draining(self) -> None:
        with self._engine._lock:
            self._draining = True
            self._pause_cond.notify_all()  # paused pushes wake into refusal


def serve_async(store, port: int = 0, bind: str = "127.0.0.1",
                shard: Optional[int] = None,
                num_shards: Optional[int] = None,
                ckpt_root: Optional[str] = None,
                backup: bool = False,
                native_loop: Optional[bool] = None,
                loop_threads: Optional[int] = None) -> AsyncPSService:
    """Expose an initialized async KVStore to remote worker processes.

    Each server process calls this after ``store.init(...)``; workers join
    with :func:`connect_async`. Returns the running service (``.port``,
    ``.stop()``). One server: ``store.init(params)``. Server ``s`` of
    ``N``: ``store.init(shard_tree(params, s, N))`` and
    ``serve_async(store, shard=s, num_shards=N)``."""
    return AsyncPSService(store, port=port, bind=bind, shard=shard,
                          num_shards=num_shards, ckpt_root=ckpt_root,
                          backup=backup, native_loop=native_loop,
                          loop_threads=loop_threads)


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

    Not ported yet (each raises, naming its ROADMAP item): ``compress``
    other than None/'none', ``shm=True``, ``coordinator``, ``aggregator``,
    ``read_staleness``/``pull_cache`` and ``|`` replica sets in ``uri``.
    """
    if coordinator is not None:
        raise _not_ported("coordinator= (elastic membership, elastic/)", "6")
    if aggregator is not None:
        raise _not_ported("aggregator= (backends/aggregator.py)", "5")
    if read_staleness or pull_cache:
        raise _not_ported("the read path (read_staleness, pull_cache)", "5")
    if uri is None:
        raise ValueError("connect_async needs a server uri")
    del shm_bytes, failover_timeout  # no shm lane, no replica set to ride
    addrs, _ = parse_replica_uri(uri)
    return RemoteAsyncWorker.connect_many(
        addrs, worker, params_like, bucket_bytes=bucket_bytes,
        pool_size=pool_size, compress=compress, writev=writev, shm=shm)


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
        if not self._evt.wait(timeout):
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


class _Op:
    """Times one logical transport op into ``TransportStats.record_op``."""

    __slots__ = ("_stats", "_name", "_t0")

    def __init__(self, stats: TransportStats, name: str):
        self._stats, self._name = stats, name

    def __enter__(self):
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._stats.record_op(self._name, time.perf_counter() - self._t0)
        return False


class RemoteAsyncWorker(BucketedTransportMixin, CheckpointRoundsMixin):
    """A worker node of the cross-process async PS.

    Takes gradients on its own device against the params it last pulled,
    and exchanges per-owner subtrees with every server in one concurrent
    round a cycle. ``version`` sums the per-server versions (``versions``).
    A failed server connection raises :class:`ServerFailureError` naming
    the server.

    Transport: with ``bucket_bytes=None`` one frame a server a cycle; with
    ``bucket_bytes`` the payloads are cut into fusion buckets
    (:class:`~ps_tpu_torch.backends.common.BucketPlan`) striped over
    ``pool_size`` connections a server, :meth:`push_pull_async` runs a
    whole cycle in the background, and :meth:`flush` restores serial
    semantics. Either way each server applies whole trees and records the
    same event order, so the math is the same.
    """

    _failure_noun = "async PS server"

    def __init__(self, host: str, port: int, worker: int, params_like,
                 bucket_bytes: Optional[int] = None,
                 pool_size: Optional[int] = None, compress=None,
                 writev: Optional[bool] = None, shm: Optional[bool] = None):
        self._init_multi([(host, int(port))], worker, params_like,
                         bucket_bytes=bucket_bytes, pool_size=pool_size,
                         compress=compress, writev=writev, shm=shm)

    @classmethod
    def connect_many(cls, addrs: Sequence[Tuple[str, int]], worker: int,
                     params_like, bucket_bytes: Optional[int] = None,
                     pool_size: Optional[int] = None, compress=None,
                     writev: Optional[bool] = None,
                     shm: Optional[bool] = None) -> "RemoteAsyncWorker":
        self = cls.__new__(cls)
        self._init_multi(list(addrs), worker, params_like,
                         bucket_bytes=bucket_bytes, pool_size=pool_size,
                         compress=compress, writev=writev, shm=shm)
        return self

    def _init_multi(self, addrs: List[Tuple[str, int]], worker: int,
                    params_like, bucket_bytes=None, pool_size=None,
                    compress=None, writev=None, shm=None) -> None:
        self.worker = worker
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
                             writev=writev, shm=shm)
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
        missing = [k for k in self._key_order if k not in self._owner]
        if missing:
            raise ValueError(f"no server owns keys {missing[:3]}"
                             f"{'...' if len(missing) > 3 else ''}")
        if not (0 <= self.worker < self.num_workers):
            raise ValueError(f"worker id {self.worker} out of range for a "
                             f"{self.num_workers}-worker job")

    @property
    def version(self) -> int:
        """Whole-subtree applies summed over the servers."""
        return sum(self.versions)

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
        with _Op(self.transport, "pull"):
            if self.bucket_bytes is not None:
                self.flush()
                return self._merge_host_params(self._pull_buckets())
            return self._merge_params(self._fanout({
                i: tv.encode(tv.PULL, self.worker, None)
                for i in self._active}))

    def push_all(self, grads) -> None:
        """Push a gradient tree; each owner applies its subtree at once
        with the DC-ASGD correction against this worker's last pull. The
        push carries this worker's (nonce, seq) dedup token."""
        kv = self._host_grads(grads)
        pseq = self._next_push_seq()
        with _Op(self.transport, "push"):
            if self.bucket_bytes is not None:
                self.flush()
                self._push_buckets_sync(self._split_kv(kv), pseq=pseq)
                return
            msgs = self._fanout({
                i: self._encode_serial_push(tv.PUSH, sub, pseq=pseq)
                for i, sub in self._split_kv(kv).items()})
            for i, msg in msgs.items():
                kind, _, _, extra = tv.decode(msg)
                if kind != tv.OK:
                    raise self._reply_error(i, extra)
                self.versions[i] = int(extra["version"])

    def push_pull(self, grads) -> Any:
        """push_all + pull_all in one round trip a server, all servers in
        flight together (the async cycle)."""
        kv = self._host_grads(grads)
        pseq = self._next_push_seq()
        with _Op(self.transport, "push_pull"):
            if self.bucket_bytes is not None:
                self.flush()  # a cycle racing a serial call would reorder
                self._push_buckets_sync(self._split_kv(kv), pseq=pseq)
                return self._merge_host_params(self._pull_buckets())
            return self._merge_params(self._fanout({
                i: self._encode_serial_push(tv.PUSH_PULL, sub, pseq=pseq)
                for i, sub in self._split_kv(kv).items()}))

    # -- bucketed, pipelined transport (worker half) --------------------------

    def _encode_serial_push(self, kind: int, sub: Dict[str, np.ndarray],
                            pseq: Optional[int] = None):
        """One serial push frame with the (nonce, seq) dedup token; zero
        copy parts with ``writev``."""
        extra = None
        if pseq is not None:
            extra = {"pseq": pseq, "pnonce": self._transport_nonce}
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
                           pseq: Optional[int] = None) -> None:
        """Cut each owner's subtree into buckets, stripe them over the
        pool, wait for every ack and adopt the committed versions. The
        server sees one whole-tree apply, as for a serial PUSH."""
        self._push_epoch += 1
        epoch = self._push_epoch
        futs: List[Tuple[int, Any]] = []
        for i, sub in by_owner.items():
            sub = {k: np.ascontiguousarray(v) for k, v in sub.items()}
            plan = BucketPlan.from_arrays(sub, self.bucket_bytes)
            pumps = self._pumps[i]
            enc_bucket = plan.bucket_encoder(self.writev)
            for b in range(plan.nbuckets):
                extra = {"epoch": epoch, "nonce": self._transport_nonce,
                         "pseq": pseq, "pnonce": self._transport_nonce,
                         "enc": []}
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

    def _pull_buckets(self) -> Dict[str, np.ndarray]:
        """Bucketed pull: bucket 0 snapshots each server's subtree and names
        the bucket count; the rest stream over the pool, front of the
        model first. Each reply is copied into its assembler and its
        buffer returned to the pool before the next borrow."""
        self._pull_epoch += 1
        epoch = self._pull_epoch
        first = {
            i: self._pumps[i][0].submit(tv.encode(
                tv.BUCKET_PULL, self.worker, None,
                extra={"epoch": epoch, "bucket": 0,
                       "bucket_bytes": self.bucket_bytes,
                       "compress": None}))
            for i in self._active}
        kv: Dict[str, np.ndarray] = {}
        rest: List[Tuple[int, Any]] = []
        assemblers: Dict[int, BucketAssembler] = {}
        for i, fut in first.items():
            reply = self._bucket_reply(i, fut)
            kind, _, tensors, extra = tv.decode(reply)
            if kind != tv.OK:
                self._release_frame(reply)
                raise self._reply_error(i, extra)
            self.versions[i] = int(extra["version"])
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
                                    extra={"epoch": epoch, "bucket": b})
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
        return kv

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
            with _Op(self.transport, "cycle"):
                self._push_buckets_sync(self._split_kv(kv), pseq=pseq)
                params = self._merge_host_params(self._pull_buckets())
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
        wire counters, transport stats and epoch streams survive."""
        try:
            self.flush()
        except Exception:
            pass  # a dead server is why we reconnect
        saved = self._saved_transport_state()
        self._close_transport()
        for ch in self._chs:
            ch.close()  # dead or stale; no SHUTDOWN owed
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        try:
            self._init_multi(
                list(addrs) if addrs is not None else self._addrs,
                self.worker,
                keymod.unflatten(self._treedef, self._kv_like,
                                 self._key_order),
                bucket_bytes=self.bucket_bytes, pool_size=self.pool_size,
                writev=self.writev)
        finally:
            self._restore_transport_state(saved)

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
        try:
            if self._pending_cycles:
                self.flush()  # land in-flight cycles before the goodbyes
        except Exception:
            pass  # a dead server must not block the teardown
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
