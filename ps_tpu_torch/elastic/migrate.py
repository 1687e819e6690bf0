"""Live key-range moves: the donor's row stream to the recipient.

Counterpart of ``ps_tpu/elastic/migrate.py``, the same frames. A
rebalance moves keys from one serving shard to another without pausing
the job: the donor exports the moving rows under its apply lock and
streams them over one van channel as sequenced entries with per-entry
acks (``replica/log.py``'s :class:`ReplicationLog`), and keeps writing
twice while traffic goes on: a commit touching a moving key streams its
new row, a later row supersedes an earlier, and the recipient converges
on the donor's live state. A row is the whole unit of ownership: the
parameter, the key's optimizer state, every worker's stale snapshot and
the apply count.

The cutover is a bounded stop-and-copy: the donor holds its apply lock,
drains the residual window, sends ``MIGRATE_COMMIT`` (the recipient
installs the staged rows and serves them), evicts the keys and releases
the lock. A failure before the commit aborts: the donor keeps every key,
the recipient drops the staged range, the table epoch stays.

The commit carries the donor's (nonce, seq) dedup tokens of the moved
keys, so a push the donor applied and the worker replays at the
recipient is acked there without applying again.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

import numpy as np

from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.replica.log import ReplicationLog

__all__ = ["MigrationError", "MigrationSession", "encode_row", "decode_row"]


class MigrationError(RuntimeError):
    """The stream could not attach, broke mid-move, or the commit was
    refused: the move aborts and the donor keeps its keys."""


def encode_row(key: str, param, state_kv: Dict[str, object],
               stale: Dict[int, object], apply_count: int):
    """One row's wire form, ``(tensors, extra)``: the tensor names carry
    their group (``param``, ``s:<state leaf>``, ``w:<worker>``) so the flat
    frame holds all three; ``extra["state_keys"]`` keeps the state's
    flatten order."""
    tensors = {"param": param}
    for sk, v in state_kv.items():
        tensors[f"s:{sk}"] = v
    for w, v in stale.items():
        tensors[f"w:{w}"] = v
    extra = {"key": key, "state_keys": list(state_kv),
             "apply_count": int(apply_count)}
    return tensors, extra


def decode_row(tensors, extra) -> dict:
    """The inverse of :func:`encode_row`; the arrays are copied out of the
    frame (a staged row outlives the request buffer)."""
    param = None
    state: Dict[str, object] = {}
    stale: Dict[int, object] = {}
    for name, v in tensors.items():
        if name == "param":
            param = np.array(v)
        elif name.startswith("s:"):
            state[name[2:]] = np.array(v)
        elif name.startswith("w:"):
            stale[int(name[2:])] = np.array(v)
    return {"key": str(extra["key"]), "param": param, "state": state,
            "state_keys": list(extra.get("state_keys") or []),
            "stale": stale, "apply_count": int(extra.get("apply_count", 0))}


class MigrationSession:
    """The donor's side of one move: a channel, a sender thread and the
    sequenced row log. A dead, refusing or stalled recipient degrades the
    session and wakes every waiter, as a replica session's backup does,
    so a move can only abort, never wedge the donor's apply path."""

    def __init__(self, host: str, port: int, begin_extra: dict,
                 stats=None, window: int = 64,
                 connect_timeout_ms: int = 10_000,
                 stall_timeout: float = 30.0):
        self.addr = (host, int(port))
        self.stats = stats
        self.stall_timeout = float(stall_timeout)
        self.log = ReplicationLog(window=window, stall_timeout=stall_timeout)
        self.rows_sent = 0
        self.bytes_sent = 0
        self._ch = tv.Channel.connect(host, port,
                                      timeout_ms=connect_timeout_ms)
        kind, _, _, extra = tv.decode(self._ch.request(
            tv.encode(tv.MIGRATE_BEGIN, 0, None, extra=begin_extra)))
        if kind != tv.OK:
            self._ch.close()
            raise MigrationError(
                f"recipient {host}:{port} refused the migration stream: "
                f"{extra.get('error')}")
        self._closed = False
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ps-migrate-send")
        self._t.start()

    @property
    def degraded(self) -> bool:
        return self.log.dead

    @property
    def lag(self) -> int:
        return self.log.lag

    def publish_row(self, key: str, tensors: Dict, meta: dict) -> int:
        """Append one row (under the donor's apply lock: row order is
        engine order). Blocks while the ack window is full; returns the
        entry's seq."""
        return self.log.append("row", 0, tensors, dict(meta, key=key))

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Wait until every published row is acked (False on a degrade or
        a timeout: the caller aborts the move)."""
        with self.log._cond:
            target = self.log.next_seq - 1
        if target <= 0:
            return not self.log.dead
        return self.log.wait_acked(target, self.stall_timeout
                                   if timeout is None else timeout)

    def quiesce(self) -> None:
        """Stop the sender (after :meth:`wait_drained`): the channel has
        one driving thread again, the caller's, for the commit or abort."""
        self._closed = True
        self.log.mark_dead("quiesced for commit")
        self._t.join(timeout=10)

    def commit(self, extra: dict) -> dict:
        """The cutover request (after :meth:`quiesce`, the donor's apply
        lock held so no commit races the change of ownership); returns the
        recipient's reply, raises on a refusal.

        A broken connection here is ambiguous: the recipient may have
        installed the rows and only the reply died, and an abort would
        leave both shards owning the range. So the request is asked once
        more on a fresh channel; the recipient acks a re-asked commit of
        the range it just committed (``extra`` names the keys)."""
        frame = tv.encode(tv.MIGRATE_COMMIT, 0, None, extra=extra)
        try:
            kind, _, _, rx = tv.decode(self._ch.request(frame))
        except (tv.VanError, OSError) as e:
            try:
                ch2 = tv.Channel.connect(*self.addr, timeout_ms=10_000)
                try:
                    kind, _, _, rx = tv.decode(ch2.request(frame))
                finally:
                    ch2.close()
            except (tv.VanError, OSError) as e2:
                raise MigrationError(
                    f"migration commit to {self.addr[0]}:{self.addr[1]} "
                    f"died and the re-ask failed too ({e2!r}); original: "
                    f"{e!r}") from e2
        if kind != tv.OK:
            raise MigrationError(
                f"recipient {self.addr[0]}:{self.addr[1]} refused the "
                f"migration commit: {rx.get('error')}")
        return rx

    def abort(self) -> None:
        """Tell the recipient to drop the staged range, as far as it can
        still hear (its death is usually why the move aborts)."""
        self._closed = True
        self.log.mark_dead("migration aborted")
        self._t.join(timeout=10)
        try:
            self._ch.request(tv.encode(tv.MIGRATE_ABORT, 0, None))
        except (tv.VanError, OSError):
            pass
        self._ch.close()

    def close(self) -> None:
        self._closed = True
        self.log.mark_dead("session closed")
        self._t.join(timeout=10)
        self._ch.close()

    def _loop(self) -> None:
        while not self._closed and not self.log.dead:
            entry = self.log.take(timeout=0.2)
            if entry is None:
                continue
            seq, _op, _w, tensors, meta = entry
            try:
                header, chunks = tv.encode_parts(
                    tv.MIGRATE_ROW, 0, tensors, dict(meta, seq=seq))
                reply = self._ch.request_parts(header, chunks)
                kind, _, _, extra = tv.decode(reply)
            except tv.VanError as e:
                self._degrade(f"recipient connection failed: {e}")
                return
            except Exception as e:  # noqa: BLE001 — a silent sender death
                # would leave wait_drained blocked until the stall timeout
                self._degrade(f"migration sender failed: {e!r}")
                return
            if kind != tv.OK:
                self._degrade(f"recipient refused row seq {seq}: "
                              f"{extra.get('error')}")
                return
            self.log.ack(int(extra.get("applied_seq", seq)))
            self.rows_sent += 1
            self.bytes_sent += len(header) + sum(len(c) for c in chunks)

    def _degrade(self, why: str) -> None:
        if not self.log.dead:
            logging.getLogger(__name__).warning(
                "migration to %s:%d degraded — the move will abort: %s",
                *self.addr, why)
        self.log.mark_dead(why)
        self._ch.close()
