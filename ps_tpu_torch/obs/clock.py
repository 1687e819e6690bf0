"""Cross-process clock alignment.

Counterpart of ``ps_tpu/obs/clock.py``. A birth stamp made in another
process is a wall-clock time of that process, so a reader needs its
clock's offset against it. The offset rides the van: an NTP-style probe
over ``REPLICA_STATE``, the cheapest round trip every service (primary,
backup, sparse) answers, whose reply carries the server's ``now``. For
each probe ``offset = t_server - (t_send + t_recv)/2``, and the probe
with the smallest round trip wins (its midpoint assumption has the least
room to be wrong, NTP's min-RTT filter).

- Ties: on coarse clocks many probes report the same minimum RTT; when
  several tie within ``tie_us`` of the minimum, the offset is the median
  of the tied probes' offsets.
- Drift: give the sync a ``ttl_s`` and call :meth:`ensure_fresh` where
  the channel is at hand; it re-probes only when the estimate is older.

The dense worker's version watcher feeds one :class:`ClockSync` per
shard with :meth:`ClockSync.observe` from the replies it already gets.
A tracer's ``clock_offset_us`` takes the offset too, so several
processes' Chrome exports merge onto one timeline (``obs/trace.py``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

__all__ = ["ClockSync"]


class ClockSync:
    """Min-RTT NTP-style offset estimator over a van channel.

    Args:
      ttl_s: estimate lifetime for :meth:`ensure_fresh` (None = never
        auto-re-probe — the one-shot connect-time behavior).
      tie_us: RTT band above the minimum within which probes count as
        tied; the applied offset is the median over the tie set.
    """

    def __init__(self, ttl_s: Optional[float] = None,
                 tie_us: float = 50.0):
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.tie_us = float(tie_us)
        self.offset_us: Optional[float] = None  # add to local ts → server ts
        self.rtt_us: Optional[float] = None     # best probe's round trip
        self.probes = 0
        self.reprobes = 0                       # TTL-triggered re-probes
        self.probed_at: Optional[float] = None  # monotonic stamp
        self._samples: List[Tuple[float, float]] = []  # (rtt_us, offset_us)
        #: sample-set cap for long-lived piggyback feeds (a version
        #: watcher observing every heartbeat tick): keeping only the
        #: newest window bounds memory AND lets the estimate track
        #: drift — an hour-old min-RTT sample must eventually age out
        self.max_samples = 256

    def observe(self, t_send: float, t_recv: float,
                t_server: float) -> None:
        """Feed one request/reply timing triple (seconds, ``time.time()``
        bases). Piggyback path: any reply that carries a server ``now``
        can refine the estimate without a dedicated probe."""
        rtt = max(t_recv - t_send, 0.0) * 1e6
        off = (t_server - (t_send + t_recv) / 2.0) * 1e6
        self.probes += 1
        self._samples.append((rtt, off))
        if len(self._samples) > self.max_samples:
            del self._samples[:-self.max_samples]
        self._refresh()

    def _refresh(self) -> None:
        """Re-derive (rtt_us, offset_us) from the sample set: min-RTT
        winner, except that ties within ``tie_us`` of the minimum vote by
        median — the degenerate all-min-RTT case (coarse clocks) must not
        apply one arbitrary probe's jitter as THE offset."""
        if not self._samples:
            return
        best_rtt = min(r for r, _ in self._samples)
        tied = sorted(o for r, o in self._samples
                      if r <= best_rtt + self.tie_us)
        self.rtt_us = best_rtt
        mid = len(tied) // 2
        self.offset_us = (tied[mid] if len(tied) % 2
                          else (tied[mid - 1] + tied[mid]) / 2.0)

    def probe(self, ch, worker: int = 0, n: int = 8) -> float:
        """``n`` REPLICA_STATE round trips on ``ch``; returns the offset
        estimate in µs (also kept in :attr:`offset_us`). Each call starts
        a FRESH sample set — a re-probe must not let a pre-drift sample
        keep winning on an old, now-wrong low RTT."""
        from ps_tpu_torch.control import tensor_van as tv

        self._samples = []
        for _ in range(max(int(n), 1)):
            t0 = time.time()
            reply = ch.request(tv.encode(tv.REPLICA_STATE, worker, None))
            t1 = time.time()
            kind, _, _, extra = tv.decode(reply)
            if kind != tv.OK or "now" not in extra:
                raise RuntimeError(
                    "clock probe failed: peer's REPLICA_STATE reply "
                    "carries no 'now' (pre-observability server?)")
            self.observe(t0, t1, float(extra["now"]))
        self.probed_at = time.monotonic()
        return self.offset_us

    def fresh(self) -> bool:
        """True while the estimate is younger than ``ttl_s`` (always True
        with no TTL configured, False before the first probe)."""
        if self.probed_at is None:
            return False
        if self.ttl_s is None:
            return True
        return (time.monotonic() - self.probed_at) < self.ttl_s

    def ensure_fresh(self, ch, worker: int = 0, n: int = 8
                     ) -> Optional[float]:
        """Re-probe on ``ch`` iff the estimate is missing or aged past the
        TTL; returns the (possibly refreshed) offset."""
        if not self.fresh():
            if self.probed_at is not None:
                self.reprobes += 1
            self.probe(ch, worker=worker, n=n)
        return self.offset_us
