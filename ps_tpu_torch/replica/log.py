"""Sequenced log of one shard's committed updates.

Counterpart of ``ps_tpu/replica/log.py``. Replaying a server's ordered
(push, pull) events through a fresh engine started from the same state
reproduces its parameters bitwise, so that event stream is the
replication unit. The primary appends one entry per committed event under
its apply lock, so log order is engine order, and a
:class:`~ps_tpu_torch.replica.session.BackupSession` ships the entries to
the backup in sequence.

Both replicas start from one state point: the same initial parameters or
tables, or a common checkpoint. The REPLICA_HELLO check refuses a backup
at any other point instead of letting it diverge silently. The deltas are
this log.

The ack window bounds memory and the backup's lag: :meth:`append` blocks
once ``window`` entries are committed but unacked. With sync ack the push
handler also waits on :meth:`wait_acked` before replying, so a worker
never sees a commit the backup lacks; with async ack the window is the
lag bound.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Tuple


class ReplicationError(RuntimeError):
    """The replication stream could not attach or broke mid-stream."""


class ReplicationLog:
    """Bounded FIFO of committed but unacked events, with seq assignment.

    Thread contract: :meth:`append` runs under the service's apply lock
    (order = engine order); :meth:`take` and :meth:`ack` run on the
    session's sender thread; :meth:`wait_acked` on serve threads outside
    the apply lock. :meth:`mark_dead` (the backup is gone) wakes every
    waiter, so a dead backup degrades the primary to unreplicated instead
    of wedging it.
    """

    def __init__(self, window: int = 256, stall_timeout: float = 30.0):
        self.window = max(int(window), 1)
        #: how long a full-window append may block before the log declares
        #: the backup stalled and dies. A stalled backup (stopped, packets
        #: dropped: no reset, so no VanError) must degrade the primary as
        #: a dead one does: append blocks under the apply lock, and an
        #: unbounded wait would wedge the whole shard
        self.stall_timeout = float(stall_timeout)
        self._cond = threading.Condition()
        self._entries: collections.deque = collections.deque()
        self.next_seq = 1      # the seq the next append receives
        self.acked_seq = 0     # the highest seq the backup acked
        self.dead = False
        self.death_reason: Optional[str] = None

    @property
    def lag(self) -> int:
        """Commits the backup has not acked yet."""
        with self._cond:
            return self.next_seq - 1 - self.acked_seq

    def append(self, op: str, worker: int, tensors: Optional[Dict],
               meta: dict) -> int:
        """Append one committed event and return its seq. Blocks while the
        ack window is full, but never past ``stall_timeout``: a window
        full that long means the backup hung, and the log dies (the
        primary degrades) instead of wedging the shard."""
        deadline = time.monotonic() + self.stall_timeout
        with self._cond:
            while (not self.dead
                   and self.next_seq - 1 - self.acked_seq >= self.window):
                left = deadline - time.monotonic()
                if left <= 0:
                    self._die(f"ack window full for {self.stall_timeout:.0f}s"
                              " — backup stalled")
                    break
                self._cond.wait(left)
            seq = self.next_seq
            self.next_seq += 1
            if not self.dead:
                self._entries.append((seq, op, worker, tensors, meta))
                self._cond.notify_all()
            return seq

    def take(self, timeout: Optional[float] = None
             ) -> Optional[Tuple[int, str, int, Optional[Dict], dict]]:
        """Sender side: the oldest unsent entry (it stays queued until
        :meth:`ack` removes it; one request is in flight at a time). None
        on timeout or death."""
        with self._cond:
            if not self._entries:
                self._cond.wait(timeout)
            if self.dead or not self._entries:
                return None
            return self._entries[0]

    def ack(self, seq: int) -> None:
        """The backup acked everything up to ``seq``: drop it, open the
        window, wake blocked appenders and sync waiters."""
        with self._cond:
            while self._entries and self._entries[0][0] <= seq:
                self._entries.popleft()
            if seq > self.acked_seq:
                self.acked_seq = seq
            self._cond.notify_all()

    def wait_acked(self, seq: int, timeout: Optional[float] = None) -> bool:
        """Sync-ack gate: block until the backup acked ``seq`` (True) or
        the session died or the wait timed out (False: the caller goes on
        unreplicated)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.acked_seq < seq and not self.dead:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
            return self.acked_seq >= seq

    def mark_dead(self, reason: Optional[str] = None) -> None:
        """The backup is unreachable: wake every appender and sync waiter;
        the primary degrades to unreplicated, loudly, never wedged."""
        with self._cond:
            self._die(reason)

    def _die(self, reason: Optional[str]) -> None:
        # the caller holds self._cond
        if not self.dead:
            self.dead = True
            self.death_reason = reason
        self._entries.clear()
        self._cond.notify_all()
