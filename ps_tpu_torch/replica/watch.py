"""Heartbeat-driven promotion: the backup's watch over its primary.

Counterpart of ``ps_tpu/replica/watch.py``. The primary process beats the
backup's watch port with a
:class:`~ps_tpu_torch.control.heartbeat.HeartbeatClient` from a C++
thread (a pause of the primary's Python cannot fake its death); the
backup runs this watch, which polls its
:class:`~ps_tpu_torch.control.heartbeat.HeartbeatServer` and promotes the
local backup service once the primary is gone, keeping the two causes
apart:

- ``left`` (goodbye received): a planned handoff; promotion is immediate,
  ``promote_reason == "goodbye"``;
- ``dead`` (seen, then silent past the horizon): a failure; promotion
  fires after the death horizon, ``promote_reason == "timeout"``.

A primary that never beat is neither (not started yet and already dead
look the same); :meth:`PromotionWatch.wait_for_primary` is the rendezvous
for drills that must not race the first beat. The poll runs on a Python
thread, so a long GIL hold in the backup delays the promotion, never
hastens it: the horizon is measured by the native receiver.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ps_tpu_torch.control.heartbeat import HeartbeatServer


class PromotionWatch:
    """Poll a heartbeat monitor; promote ``service`` when the primary dies.

    Args:
      service: the backup-role service (``promote(reason)`` is called on
        it once, from the watch thread).
      primary_id: the heartbeat node id the primary beats with.
      port/bind/timeout_ms: the local monitor (0 = a port the kernel
        picks: read :attr:`port` and point the primary's client at it).
        ``timeout_ms`` is the death horizon, the floor of the kill to
        promotion latency on the timeout path.
      poll_s: the poll cadence.
      on_promote: optional ``(reason, promote_s)`` callback.
    """

    def __init__(self, service, primary_id: int, port: int = 0,
                 bind: str = "127.0.0.1", timeout_ms: int = 1000,
                 poll_s: float = 0.02, on_promote=None):
        self.service = service
        self.primary_id = int(primary_id)
        self.server = HeartbeatServer(port=port, timeout_ms=timeout_ms,
                                      bind=bind)
        self.poll_s = float(poll_s)
        self.promoted_reason: Optional[str] = None
        #: the primary's last beat's age when the watch saw it gone (ms,
        #: from the native receiver), and the promotion's own seconds
        self.detect_age_ms: Optional[int] = None
        self.promote_s: Optional[float] = None
        self._on_promote = on_promote
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ps-promotion-watch")
        self._t.start()

    @property
    def port(self) -> int:
        return self.server.port

    def wait_for_primary(self, timeout_s: float = 30.0) -> None:
        """Block until the primary's first beat arrived (so a drill's kill
        cannot race the detector's warm-up)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.server.seq(self.primary_id) > 0:
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"primary (node {self.primary_id}) never heartbeat the watch "
            f"within {timeout_s}s")

    def _loop(self) -> None:
        while not self._stop.is_set():
            state = self.server.state(self.primary_id)
            if state in ("left", "dead"):
                reason = "goodbye" if state == "left" else "timeout"
                from ps_tpu_torch import obs

                obs.record_event("promotion_watch_fired",
                                 primary_id=self.primary_id, reason=reason)
                self.detect_age_ms = self.server.age_ms(self.primary_id)
                t0 = time.monotonic()
                self.service.promote(reason=reason)
                self.promote_s = time.monotonic() - t0
                self.promoted_reason = reason
                logging.getLogger(__name__).warning(
                    "promotion watch: primary node %d %s (last beat %s ms "
                    "ago); promoted in %.1f ms", self.primary_id, state,
                    self.detect_age_ms, self.promote_s * 1e3)
                if self._on_promote is not None:
                    try:
                        self._on_promote(reason, self.promote_s)
                    except Exception:  # noqa: BLE001
                        logging.getLogger(__name__).exception(
                            "promotion observer failed")
                return
            time.sleep(self.poll_s)

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
