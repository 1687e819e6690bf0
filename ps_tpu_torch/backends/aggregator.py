"""Two-level aggregation: the per-host aggregator.

Counterpart of ``ps_tpu/backends/aggregator.py``. Gradients reduce within
a host first and cross the slow path between hosts once a host: the host
group's workers dial :class:`AggregatorService` instead of the shards
(``connect_async(..., aggregator="host:port")``). To its group it looks
like one shard owning the whole tree; upstream it is one
:class:`~ps_tpu_torch.backends.remote_async.RemoteAsyncWorker` under a
synthetic identity (:data:`~ps_tpu_torch.backends.common.AGG_WORKER_BASE`
plus the group index):

- **push pre-reduction**: member pushes stage into the current round.
  Once ``group_size`` distinct members staged (or the flush timeout
  passed: a dead member must not wedge its group), the round's trees are
  summed in ascending member order and forwarded as ONE upstream
  ``push_pull``. Upstream bytes a step fall by the realized fan-in.
- **pull coalescing**: the merged flush's returned snapshot answers the
  whole group's pulls and READs for that round; a pull with no flush in
  between makes ONE upstream ``read_all_stamped``, shared by every
  concurrent reader.
- **exactly once across the handoff**: the merged push travels under the
  aggregator's own (nonce, seq) token and carries each member's own
  token in ``members``; the shard records both. If the aggregator dies,
  its members degrade to the flat path, and a member's flat replay of a
  push its dead aggregator already forwarded is acked unapplied.

Under plain SGD the sum-then-apply is exactly the members' applies in
sequence; under DC-ASGD the group shares one staleness term (the apply is
corrected against the aggregator's last pull).

The round state and the group's snapshot live in host memory: the
aggregator takes no device and launches no kernel; the shards apply on
theirs. A round with a traced member is merged inside an ``agg_merge``
span parented to the first traced member's serve span; the upstream
push parents to it and carries the members' trace contexts as
``members_tc``, so the chain worker -> aggregator -> shard is one trace.
With ``coordinator=`` the aggregator takes its upstream shards from the
coordinator's table (its client re-routes when keys move) and registers
itself there as the aggregator of ``host`` (``socket.gethostname()`` by
default) at ``advertise_host:port``: a worker of that host given only
the coordinator finds it in the table and dials it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ps_tpu_torch import obs
from ps_tpu_torch.backends.common import (
    AGG_WORKER_BASE,
    DEFAULT_BUCKET_BYTES,
    BucketPlan,
    parse_replica_uri,
)
from ps_tpu_torch.backends.van_service import VanService
from ps_tpu_torch.compress import decode_tree
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.obs import freshness

__all__ = ["AggregatorService", "serve_aggregator"]


class AggregatorService(VanService):
    """Pre-reduce a host group's pushes into one upstream push a round.

    Args:
      uri: the upstream shards, ``h0:p0,h1:p1,...`` (``|`` replica sets).
      params_like: the model's parameter structure (what the upstream
        client validates the partition against; only keys and structure
        are used).
      group_size: the local fan-in, how many same-host workers share this
        aggregator (None = ``PS_AGG_GROUP_SIZE``, default 1). A round is
        forwarded as soon as this many distinct members staged.
      flush_timeout_ms: how long an incomplete round waits for its other
        members before it is flushed partial (None =
        ``PS_AGG_FLUSH_TIMEOUT_MS``, default 2000).
      group: this aggregator's group index (its upstream identity is
        ``AGG_WORKER_BASE + group``).
      bucket_bytes/pool_size/compress/writev/shm/shm_bytes/
        failover_timeout: the upstream client's transport options; the
        member-facing side takes the same bucketed frames and shm offers
        any van service does.
      native_loop/loop_threads: serve the group from the native loop.
    """

    #: member pushes, pulls and reads park on the group's round (a push
    #: waits for the round's other members): on the native loop each gets
    #: a fresh thread, never the pump and never the punt pool
    _BARRIER_KINDS = frozenset({tv.PUSH, tv.PUSH_PULL, tv.BUCKET_PUSH,
                                tv.PULL, tv.BUCKET_PULL, tv.READ})

    def __init__(self, uri: Optional[str], params_like,
                 group_size: Optional[int] = None,
                 flush_timeout_ms: Optional[float] = None,
                 group: int = 0,
                 port: int = 0, bind: str = "127.0.0.1",
                 bucket_bytes: Optional[int] = None,
                 pool_size: Optional[int] = None,
                 compress=None, writev: Optional[bool] = None,
                 shm: Optional[bool] = None,
                 shm_bytes: Optional[int] = None,
                 failover_timeout: Optional[float] = None,
                 coordinator=None, host: Optional[str] = None,
                 advertise_host: str = "127.0.0.1",
                 native_loop: Optional[bool] = None,
                 loop_threads: Optional[int] = None):
        from ps_tpu_torch.backends.remote_async import RemoteAsyncWorker
        from ps_tpu_torch.config import env_float, env_int

        if group_size is None:
            group_size = env_int("PS_AGG_GROUP_SIZE", 1, lo=1)
        self.group_size = max(int(group_size), 1)
        if flush_timeout_ms is None:
            flush_timeout_ms = env_float("PS_AGG_FLUSH_TIMEOUT_MS", 2000.0,
                                         lo=1.0)
        self._flush_timeout = float(flush_timeout_ms) / 1e3
        self.group = int(group)
        # the upstream client's params land in host memory: its structure
        # is params_like's with empty CPU placeholders for leaves
        kv, treedef = keymod.flatten_with_keys(params_like)
        table = None
        if coordinator is not None:
            from ps_tpu_torch.elastic.member import fetch_table

            table = fetch_table(coordinator, cover=list(kv))
            addrs, replica_sets = table.addrs(), table.replica_sets()
        elif uri is None:
            raise ValueError("AggregatorService needs an upstream uri or "
                             "a coordinator address")
        else:
            addrs, replica_sets = parse_replica_uri(uri)
        host_like = keymod.unflatten(
            treedef, {k: torch.empty(0) for k in kv}, list(kv))
        # ONE upstream worker a group, outside the real id space, so merged
        # pushes get their own dedup and staleness slots
        self._client = RemoteAsyncWorker.connect_many(
            addrs, AGG_WORKER_BASE + self.group, host_like,
            bucket_bytes=bucket_bytes, pool_size=pool_size,
            compress=compress, writev=writev, shm=shm, shm_bytes=shm_bytes,
            replica_sets=replica_sets, failover_timeout=failover_timeout,
            coordinator=coordinator, table=table, agg_role=True)
        self._key_order = list(self._client._key_order)
        # a member push's key set is checked every round: sort once
        self._sorted_keys = sorted(self._key_order)
        # the round state, all under _rcv: the current round fills until
        # group_size members staged (or its deadline passed), then the
        # flusher thread forwards it and installs a fresh one
        self._rcv = threading.Condition()
        self._rounds_done = 0
        self._round = self._new_round()
        self._draining = False
        self._stopped = False
        # the coalesced snapshot (one upstream fetch a round), under _pcv;
        # its "round" names the flush count it reflects
        self._pcv = threading.Condition()
        self._pull_snap: Optional[dict] = None
        self._pull_fetching = False
        # THE upstream lock: the flusher's merged push_pull and the members'
        # fetches share one client, whose channels take one driving thread
        self._ulock = threading.Lock()
        # member-facing bucketed pulls: worker -> snapshot and plan (under
        # _stage_lock)
        self._pull_cache: Dict[int, dict] = {}
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True, name="ps-agg-flush")
        super().__init__(port=port, bind=bind, writev=writev, shm=shm,
                         native_loop=native_loop, loop_threads=loop_threads)
        self.role = "aggregator"
        self._flusher.start()
        self._coord = coordinator
        self.host = host
        if coordinator is not None:
            import socket

            self.host = host or socket.gethostname()
            self._register(coordinator,
                           f"{advertise_host}:{self.port}")

    def _register(self, coordinator, uri: str) -> None:
        """Join the coordinator's table as this host's aggregator: the
        workers of ``self.host`` find ``uri`` in the table reply and dial
        it instead of the shards."""
        from ps_tpu_torch.elastic.member import parse_coord

        chost, cport = parse_coord(coordinator)
        ch = tv.Channel.connect(chost, cport)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.COORD_HELLO, 0, None,
                extra={"role": "aggregator", "uri": uri,
                       "host": self.host})))
            if kind != tv.OK:
                raise RuntimeError(f"aggregator registration refused: "
                                   f"{extra.get('error')}")
        finally:
            ch.close()
        logging.getLogger(__name__).info(
            "aggregator for host %s registered at %s (group %d, fan-in %d)",
            self.host, uri, self.group, self.group_size)

    # -- rounds ----------------------------------------------------------------

    def _new_round(self) -> dict:
        return {
            "id": self._rounds_done,
            "state": "filling",          # -> flush -> flushing -> done
            "members": {},               # worker -> grad tree (host arrays)
            "tokens": {},                # worker -> (pnonce, pseq)
            "tcs": {},                   # worker -> its serve span's context
            "deadline": None,
            "kv": None,                  # the post-flush params snapshot
            "version": None,
            "error": None,
        }

    def _flush_loop(self) -> None:
        """The flusher: waits for the current round to fill (or time out),
        swaps in a fresh round and forwards the merged push, the upstream
        I/O outside the round lock, so the next round stages meanwhile."""
        while True:
            with self._rcv:
                while True:
                    if self._stopped:
                        return
                    r = self._round
                    if self._draining:
                        # stop() already woke this round's parked members
                        # into refusal: their gradients must not go upstream
                        # behind those failed replies (a member retrying
                        # under a new seq would apply twice)
                        if r["state"] != "done":
                            r["state"] = "done"
                            r["error"] = RuntimeError(
                                "aggregator is draining; push refused")
                            self._rcv.notify_all()
                        self._rcv.wait(0.05)
                        continue
                    if r["state"] == "flush":
                        break
                    if (r["members"] and r["deadline"] is not None
                            and time.monotonic() >= r["deadline"]):
                        # a partial flush: a member died or lags, and its
                        # group pays latency once a round, never a wedge
                        break
                    self._rcv.wait(0.05)
                r["state"] = "flushing"
                self._round = self._new_round()
                self._rcv.notify_all()  # stagers may start the next round
            self._do_flush(r)

    def _do_flush(self, r: dict) -> None:
        t0 = time.perf_counter()
        try:
            # a round with a traced member is merged in a span parented to
            # the first traced member's serve span (the lowest worker id);
            # open across the upstream push_pull, it parents the upstream
            # op and through it the shard's spans
            tcs = r.get("tcs") or {}
            if tcs:
                mspan = obs.tracer().span("agg_merge", cat="aggregator",
                                          parent=tcs[min(tcs)])
            else:
                mspan = obs.NOOP
            with mspan as sp:
                if sp:
                    sp.set(group=self.group, members=sorted(r["tokens"]),
                           member_traces={str(w): c.trace_id
                                          for w, c in tcs.items()})
                order = sorted(r["members"])  # deterministic merge order
                merged: Dict[str, np.ndarray] = {}
                for w in order:
                    tree = r["members"][w]
                    if not merged:
                        # an accumulator of its own (member trees may view
                        # request frames that die with their reply)
                        merged = {k: np.array(v) for k, v in tree.items()}
                    else:
                        for k, v in tree.items():
                            merged[k] += v
                r["members"] = None  # release the members' frame views
                members = {str(w): [t[0], int(t[1])]
                           for w, t in r["tokens"].items()
                           if t is not None and t[1] is not None}
                # each member's trace context beside its dedup token: the
                # shard's apply span names them, so any one member's trace
                # finds the shared commit
                members_tc = {str(w): [c.trace_id, c.span_id]
                              for w, c in tcs.items()}
                # ONE upstream round trip: apply the merged tree and bring
                # the post-apply snapshot back, which answers the group's
                # pulls
                with self._ulock:
                    params = self._client.push_pull(
                        merged, members=members or None,
                        members_tc=members_tc or None)
                    version = self._client.version
                kv, _ = keymod.flatten_with_keys(params)
                r["kv"] = {k: np.ascontiguousarray(np.asarray(v))
                           for k, v in kv.items()}
                r["version"] = version
                # the round's snapshot is born here, now: the merged apply
                # just committed upstream and these bytes are its
                # post-apply state
                r["b"] = freshness.birth_record()
        except BaseException as e:  # surfaced at every parked member
            r["error"] = e
        if r["error"] is None:
            self.transport.record_agg_round(len(r["tokens"]))
            # the snapshot is published before the round-done transition:
            # only this thread writes _rounds_done, so a puller racing the
            # gap sees a snapshot ahead of its round, not a reason to fetch
            with self._pcv:
                self._pull_snap = {"round": self._rounds_done + 1,
                                   "kv": r["kv"],
                                   "version": r["version"],
                                   "b": r["b"]}
                self._pcv.notify_all()
        with self._rcv:
            self._rounds_done += 1
            ordinal = self._rounds_done
            r["state"] = "done"
            self._rcv.notify_all()
        if r["error"] is None:
            # the committed round supersedes every cached member READ
            self._invalidate_reads()
        logging.getLogger(__name__).debug(
            "aggregator group %d flushed round %d (%d member(s), %.1fms)%s",
            self.group, ordinal, len(r["tokens"]),
            (time.perf_counter() - t0) * 1e3,
            f" FAILED: {r['error']!r}" if r["error"] else "")

    def _agg_push(self, worker: int, tree: Dict[str, np.ndarray],
                  extra: dict) -> dict:
        """Stage one member's push into the current round and park until
        the merged upstream flush commits; returns the finished round."""
        if sorted(tree) != self._sorted_keys:
            raise KeyError("push keys do not match the registered tree")
        t0 = time.perf_counter()
        token = (extra.get("pnonce"), extra.get("pseq"))
        # the serve span _dispatch opened is current on this thread: the
        # flusher's merge span parents to it
        ctx = obs.tracer().current()
        with self._rcv:
            while True:
                if self._draining:
                    raise RuntimeError("aggregator is draining; push refused")
                r = self._round
                if r["state"] == "filling" and worker not in r["members"]:
                    break
                if r["state"] == "filling":
                    # this member is a round ahead of its group: force the
                    # staged round out, so one member's pushes never fall
                    # into one merged apply
                    r["state"] = "flush"
                    self._rcv.notify_all()
                self._rcv.wait(0.05)
            r["members"][worker] = tree
            r["tokens"][worker] = token
            if ctx is not None:
                r["tcs"][worker] = ctx
            if r["deadline"] is None:
                r["deadline"] = time.monotonic() + self._flush_timeout
            if len(r["members"]) >= self.group_size:
                r["state"] = "flush"
                self._rcv.notify_all()
            # park until the flusher commits the round upstream, counted as
            # a checkpoint-pause park so stop()'s drain never spends its
            # grace on barrier waiters (they wake into refusal)
            self._pause_wait_begin()
            try:
                while r["state"] != "done":
                    if self._draining:
                        raise RuntimeError(
                            "aggregator is draining; push refused")
                    self._rcv.wait(0.1)
            finally:
                self._pause_wait_end()
        if r["error"] is not None:
            raise RuntimeError(f"merged upstream push failed: {r['error']!r}")
        self.transport.record_agg_hold(time.perf_counter() - t0)
        return r

    # -- coalesced pulls -------------------------------------------------------

    def _coalesced_pull(self) -> dict:
        """The group's snapshot for the current round: the last merged
        flush's when fresh, else ONE upstream fetch that concurrent readers
        wait on. The fetch is a ``read_all_stamped``, not a pull: it needs
        no ``_ulock`` (the client's reads run on channels of their own) and
        leaves the upstream DC snapshot pinned to the last flush."""
        while True:
            with self._rcv:
                rid = self._rounds_done
            with self._pcv:
                snap = self._pull_snap
                if snap is not None and snap["round"] >= rid:
                    return snap
                if self._pull_fetching:
                    self._pcv.wait(0.1)
                    continue
                self._pull_fetching = True
            try:
                # the version as served, with its bytes (the client's known
                # version may run ahead of them), and the oldest shard's
                # birth, so the group's ages keep the upstream hop
                params, version, birth = self._client.read_all_stamped()
                with self._pcv:
                    prev = self._pull_snap
                if prev is not None \
                        and int(prev["version"]) == int(version):
                    # upstream unchanged since the held snapshot: re-stamp
                    # the round and keep the bytes; the birth refreshes
                    snap = {"round": rid, "kv": prev["kv"],
                            "version": int(version),
                            "b": birth if birth is not None
                            else prev.get("b")}
                else:
                    kv, _ = keymod.flatten_with_keys(params)
                    snap = {"round": rid,
                            "kv": {k: np.ascontiguousarray(np.asarray(v))
                                   for k, v in kv.items()},
                            "version": version, "b": birth}
            except BaseException:
                with self._pcv:
                    self._pull_fetching = False
                    self._pcv.notify_all()
                raise
            with self._pcv:
                self._pull_fetching = False
                cur = self._pull_snap
                if cur is None or cur["round"] <= snap["round"]:
                    self._pull_snap = snap
                self._pcv.notify_all()
                return self._pull_snap

    def _read_payload(self, extra=None) -> bytes:
        """A member READ serves the group's coalesced snapshot and is
        published to the native read cache at the generation taken before
        the fetch (a round committing mid-read refuses the stale publish).
        A READ conditional on a version at or past the snapshot's gets a
        NOT_MODIFIED stamp instead of the tree."""
        gen = self._read_gen_snapshot()
        snap = self._coalesced_pull()
        birth = snap.get("b")
        bext = dict(birth) if birth is not None else {}
        cond = None
        if isinstance(extra, dict) and extra.get("cond") is not None:
            cond = int(extra["cond"])
        if cond is not None and int(snap["version"]) <= cond:
            reply = tv.encode(tv.NOT_MODIFIED, 0, None,
                              extra={"version": int(snap["version"]),
                                     **bext})
            self._note_read_snapshot(gen, int(snap["version"]))
            self.transport.record_read_served()
            self.transport.record_read_not_modified()
            self._note_serve_age(birth, tier="agg")
            return reply
        reply = tv.encode(tv.OK, 0, snap["kv"],
                          extra={"version": snap["version"], **bext})
        self._note_read_snapshot(gen, int(snap["version"]))
        self.transport.record_read_served()
        self._note_serve_age(birth, tier="agg")
        return reply

    def _read_version(self):
        return self._client.version

    def _params_reply(self, worker: int, snap: dict):
        if self.writev:
            return tv.encode_parts(tv.OK, worker, snap["kv"],
                                   extra={"version": snap["version"]})
        return tv.encode(tv.OK, worker, snap["kv"],
                         extra={"version": snap["version"]})

    # -- protocol --------------------------------------------------------------

    def _dispatch_traced(self, kind: int, worker: int, tensors, extra):
        # no primary/backup gate: an aggregator serves its group directly
        # (REPLICA_STATE still answers: a member's version watcher and
        # clock probes ride it)
        if kind == tv.REPLICA_STATE:
            return tv.encode(tv.OK, worker, None, extra=self.replica_state())
        return self._handle(kind, worker, tensors, extra)

    def _handle(self, kind: int, worker: int, tensors, extra):
        if kind == tv.HELLO:
            return tv.encode(tv.OK, worker, None, extra={
                "keys": self._key_order,
                "version": self._client.version,
                "num_workers": self._client.num_workers,
                "shard": None,
                "num_shards": None,
                "epoch": self.epoch,
                "role": self.role,
                "table_epoch": self.table_epoch,
            })
        if kind == tv.PULL:
            return self._params_reply(worker, self._coalesced_pull())
        if kind == tv.READ:
            return self._read_payload(extra)
        if kind == tv.PUSH:
            r = self._agg_push(worker, self._decode_member_push(tensors,
                                                                extra), extra)
            return tv.encode(tv.OK, worker, None,
                             extra={"version": r["version"]})
        if kind == tv.PUSH_PULL:
            r = self._agg_push(worker, self._decode_member_push(tensors,
                                                                extra), extra)
            return self._params_reply(
                worker, {"kv": r["kv"], "version": r["version"]})
        if kind == tv.BUCKET_PUSH:
            return self._bucket_push(worker, tensors, extra)
        if kind == tv.BUCKET_PULL:
            return self._bucket_pull(worker, extra)
        if kind == tv.STATS:
            out = {
                "version": self._client.version,
                "rounds": self._rounds_done,
                "group_size": self.group_size,
                "metrics": self.transport.metrics_snapshot(),
                "upstream": {
                    "bytes_pushed": self._client.bytes_pushed,
                    "bytes_pulled": self._client.bytes_pulled,
                },
            }
            out.update(self.replica_state())
            return tv.encode(tv.OK, worker, None, extra=out)
        return tv.encode(tv.ERR, worker, None,
                         extra={"error": f"bad kind {kind} (aggregators "
                                         f"serve the data plane only)"})

    def _decode_member_push(self, tensors, extra) -> Dict[str, np.ndarray]:
        # no defensive copy: the serving thread parks in _agg_push until
        # the flush is done and the request frame is released only after
        # the reply; _do_flush reads the views once into its own memory
        return decode_tree(dict(tensors), extra.get("enc"),
                           stats=self.transport)

    def _bucket_push(self, worker: int, tensors, extra):
        """A member's bucket: an incomplete epoch only stages (a plain
        ack); the completing bucket joins the round and parks for the
        merged commit, so the member sees the shard protocol's replies."""
        tree = self._stage_bucket_push(
            worker, int(extra["bucket"]), int(extra["nbuckets"]),
            int(extra["epoch"]), tensors["raw"], extra["slices"],
            nonce=extra.get("nonce"))
        if tree is None:
            return tv.encode(tv.OK, worker, None,
                             extra={"staged": int(extra["bucket"])})  # pslint: disable=PSL203 -- debug-visibility ack field, same contract as AsyncPSService._bucket_push: names the staged bucket for packet-level triage
        tree = decode_tree(tree, extra.get("enc"), stats=self.transport)
        r = self._agg_push(worker, tree, extra)
        return tv.encode(tv.OK, worker, None, extra={
            "version": r["version"], "committed": True})

    def _bucket_pull(self, worker: int, extra):
        """A bucketed pull over the coalesced snapshot: bucket 0 binds the
        member's epoch to the group's snapshot, buckets 1..n-1 slice the
        cached copy."""
        epoch, b = int(extra["epoch"]), int(extra["bucket"])
        if b == 0:
            bb = int(extra.get("bucket_bytes") or DEFAULT_BUCKET_BYTES)
            snap = self._coalesced_pull()
            plan = BucketPlan.from_arrays(snap["kv"], bb,
                                          order=self._key_order)
            with self._stage_lock:
                if plan.nbuckets > 1:
                    self._pull_cache[worker] = {
                        "epoch": epoch, "host": snap["kv"], "plan": plan,
                        "version": snap["version"],
                        "left": set(range(1, plan.nbuckets)),
                    }
                else:
                    self._pull_cache.pop(worker, None)
            return plan.bucket_encoder(self.writev)(
                tv.OK, worker, snap["kv"], 0,
                extra={"epoch": epoch, "version": snap["version"],
                       "enc": []})
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

    # -- lifecycle -------------------------------------------------------------

    def _set_draining(self) -> None:
        with self._rcv:
            self._draining = True
            self._rcv.notify_all()  # barrier waiters wake into refusal

    def stop(self, grace: float = 10.0) -> None:
        super().stop(grace=grace)
        with self._rcv:
            self._stopped = True
            self._rcv.notify_all()
        self._flusher.join(timeout=5)
        try:
            self._client.close()
        except Exception:
            pass  # a dead upstream must not block the local teardown

    def kill(self) -> None:
        """Abrupt death for the drills: sever the group's connections now.
        In-flight rounds die unacked, the window the members' tokens cover
        when they degrade to the flat path and replay."""
        super().kill()
        with self._rcv:
            self._stopped = True
            self._draining = True
            self._rcv.notify_all()
        self._flusher.join(timeout=5)
        try:
            self._client.close()
        except Exception:
            pass


def serve_aggregator(uri: Optional[str], params_like,
                     group_size: Optional[int] = None,
                     **kw) -> AggregatorService:
    """Start a host group's aggregator: one a host, ``group_size`` the
    host's worker count (``PS_AGG_GROUP_SIZE``), ``uri`` the shards.
    Returns the running service (``.port``, ``.stop()``)."""
    return AggregatorService(uri, params_like, group_size=group_size, **kw)
