"""Primary side of replication: one channel and sender thread a backup.

Counterpart of ``ps_tpu/replica/session.py``. Made by
:meth:`ps_tpu_torch.backends.van_service.VanService.attach_backup`: the
session dials the backup's van port, attaches the stream with a
REPLICA_HELLO (topology and state point, so a backup that did not start
from the primary's exact state is refused), then drains the
:class:`~ps_tpu_torch.replica.log.ReplicationLog` in order, one
REPLICA_APPEND request an entry, the ack reply opening the window. The
frames are the reference's byte for byte, so a port primary streams to a
reference backup and the other way round.

Entries ride the van's frames as zero-copy parts, optionally through a
stateless gradient codec (topk is refused: its error-feedback residuals
would hold back gradient mass the backup then never receives). A lossy
codec trades stream bytes for a promotion that is no longer bitwise.

Failure policy: a dead or refusing backup degrades the session: the log
is drained, every sync waiter and blocked appender wakes, and the primary
goes on unreplicated (``degraded`` in the STATS reply) rather than
stalling the job behind a dead peer.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.replica.log import ReplicationError, ReplicationLog

_ACK_MODES = ("sync", "async")


class BackupSession:
    """Ship one shard's committed events to its warm backup, in order."""

    def __init__(self, host: str, port: int, hello_extra: dict,
                 ack: str = "sync", window: int = 256,
                 compress=None, stats=None,
                 connect_timeout_ms: int = 10_000,
                 stall_timeout: float = 30.0):
        from ps_tpu_torch.compress import (CompressPolicy, GradCompressor,
                                           resolve_spec)

        if ack not in _ACK_MODES:
            raise ValueError(f"replica_ack must be one of {_ACK_MODES}, "
                             f"not {ack!r}")
        self.ack_mode = ack
        self.addr = (host, int(port))
        self.stats = stats  # TransportStats: entries, bytes, lag, ack waits
        # a backup that hangs produces no VanError: this bounds every wait
        # that could otherwise wedge the shard before it degrades
        self.stall_timeout = float(stall_timeout)
        # set by the owning service: called with the peer's epoch when the
        # backup reports it has promoted (this primary is a zombie and
        # must stop serving); ``fenced`` is what sync-ack waiters consult
        # to refuse their replies retryably
        self.on_fenced = None
        self.fenced = False
        self.log = ReplicationLog(window=window, stall_timeout=stall_timeout)
        spec = resolve_spec(compress)
        if spec is not None and spec.get("codec") == "topk":
            raise ValueError(
                "topk cannot compress the replication stream: its error-"
                "feedback residuals would withhold gradient mass the backup "
                "then never receives — the promoted state would be wrong "
                "forever. Use cast16/int8 (and prefer none when bitwise "
                "promotion parity matters).")
        policy = CompressPolicy.from_spec(spec)
        self._compressor = (GradCompressor(policy, stats=stats)
                            if policy is not None else None)
        self._ch = tv.Channel.connect(host, port,
                                      timeout_ms=connect_timeout_ms)
        kind, _, _, extra = tv.decode(self._ch.request(
            tv.encode(tv.REPLICA_HELLO, 0, None, extra=hello_extra)))
        if kind != tv.OK:
            self._ch.close()
            raise ReplicationError(
                f"backup {host}:{port} refused the replication stream: "
                f"{extra.get('error')}")
        self.backup_epoch = int(extra.get("epoch", 0))
        self._closed = False
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ps-replica-send")
        self._t.start()

    # -- the primary's side ----------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self.log.dead

    @property
    def lag(self) -> int:
        return self.log.lag

    @property
    def acked_seq(self) -> int:
        return self.log.acked_seq

    def publish(self, op: str, worker: int, tensors: Optional[Dict],
                meta: dict) -> int:
        """Append one committed event (under the service's apply lock:
        log order must be engine order). Blocks while the ack window is
        full; returns the entry's seq for :meth:`wait_acked`. ``meta``
        travels verbatim (JSON): the dedup token and anything the backup
        must replay rather than derive. ``tensors`` must own their memory:
        the sender encodes them after the request's frame is gone."""
        return self.log.append(op, worker, tensors, meta)

    def wait_acked(self, seq: int, timeout: Optional[float] = None) -> bool:
        """Sync-ack gate for serve threads (outside the apply lock),
        bounded by ``stall_timeout``: a backup that stops acking without
        dying degrades the session instead of blocking worker replies
        forever. False means the commit is unreplicated."""
        t0 = time.perf_counter()
        ok = self.log.wait_acked(seq, self.stall_timeout
                                 if timeout is None else timeout)
        if self.stats is not None:
            self.stats.record_repl_ack_wait(time.perf_counter() - t0)
        if not ok and not self.log.dead:
            self._degrade(f"no ack for seq {seq} within "
                          f"{self.stall_timeout:.0f}s — backup stalled")
        return ok

    def state(self) -> dict:
        return {
            "ack": self.ack_mode,
            "acked_seq": self.acked_seq,
            "lag": self.lag,
            "degraded": self.degraded,
            "backup": f"{self.addr[0]}:{self.addr[1]}",
        }

    # -- the sender thread -----------------------------------------------------

    def _encode_entry(self, seq, op, worker, tensors, meta):
        extra = dict(meta)
        extra.update({"seq": seq, "op": op, "w": worker})
        if tensors and self._compressor is not None:
            tensors, enc = self._compressor.encode_tree(dict(tensors))
            if enc:
                extra["enc"] = enc
        return tv.encode_parts(tv.REPLICA_APPEND, worker,
                               tensors or None, extra)

    def _loop(self) -> None:
        while not self._closed and not self.log.dead:
            entry = self.log.take(timeout=0.2)
            if entry is None:
                continue
            seq, op, worker, tensors, meta = entry
            try:
                header, chunks = self._encode_entry(seq, op, worker,
                                                    tensors, meta)
                reply = self._ch.request_parts(header, chunks)
                kind, _, _, extra = tv.decode(reply)
            except tv.VanError as e:
                self._degrade(f"backup connection failed: {e}")
                return
            except Exception as e:  # noqa: BLE001 — a sender that dies
                # silently leaves sync waiters blocked: any failure degrades
                self._degrade(f"replication sender failed: {e!r}")
                return
            if kind != tv.OK:
                if extra.get("fenced"):
                    # the backup promoted and refuses our stream: this
                    # primary is a zombie and must stop serving workers
                    # instead of forking history
                    self.fenced = True
                    cb = self.on_fenced
                    if cb is not None:
                        try:
                            cb(int(extra.get("epoch", 0)))
                        except Exception:  # noqa: BLE001
                            logging.getLogger(__name__).exception(
                                "fencing callback failed")
                self._degrade(f"backup refused seq {seq}: "
                              f"{extra.get('error')}")
                return
            self.log.ack(int(extra.get("applied_seq", seq)))
            if self.stats is not None:
                nbytes = len(header) + sum(len(c) for c in chunks)
                self.stats.record_repl_entry(nbytes)
                self.stats.set_repl_lag(self.log.lag)

    def _degrade(self, why: str) -> None:
        if not self.log.dead:
            from ps_tpu_torch import obs

            obs.record_event("repl_degraded",
                             backup=f"{self.addr[0]}:{self.addr[1]}",
                             fenced=self.fenced, why=why)
            logging.getLogger(__name__).warning(
                "replication to %s:%d degraded — primary continues "
                "UNREPLICATED: %s", *self.addr, why)
        self.log.mark_dead(why)
        # wake a sender blocked in a native recv against a hung backup
        self._ch.close()
        if self.stats is not None:
            self.stats.set_repl_degraded()

    def close(self) -> None:
        """Stop the sender and hang up (the backup keeps what it
        applied)."""
        self._closed = True
        self.log.mark_dead("session closed")  # wake the sender and waiters
        self._t.join(timeout=5)
        self._ch.close()
