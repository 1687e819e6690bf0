"""The flight recorder: a bounded ring of typed events, dumped as JSONL.

Counterpart of ``ps_tpu/obs/flight.py``. Every layer that meets a fault
records it (failover, replication degrade, stale epoch, shm spill,
reconnect, self-fence, promotion, peer death, slow frame); the ring is
written out when it matters: an unhandled
:class:`~ps_tpu_torch.control.tensor_van.VanError` escaping a thread or
the main program, a ``SIGUSR2`` sent to a live process, or an explicit
:meth:`FlightRecorder.dump`. The ring holds the last ``flight_events``
(``PS_FLIGHT_EVENTS``, 4096) events with wall and monotonic stamps.

Each kind also counts into the registry as ``ps_event_<kind>_total``, so
a rash of one kind shows on /metrics before anyone reads a dump.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import List, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded typed-event ring + crash/signal dump hooks."""

    def __init__(self, capacity: int = 4096, dir: Optional[str] = None,
                 service: str = "ps"):
        import collections

        self.capacity = int(capacity)
        self.dir = dir
        self.service = service
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total = 0
        self._installed = False
        self._dumped_paths: List[str] = []
        self._counters: dict = {}  # kind -> registry Counter

    # -- recording -------------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """One typed event. Cheap enough for every failover-path call
        site; never raises (a black box that can crash the plane is worse
        than none)."""
        try:
            evt = {
                "t": round(time.time(), 6),
                "mono": round(time.monotonic(), 6),
                "kind": str(kind),
                **fields,
            }
            with self._lock:
                self._ring.append(evt)
                self.total += 1
                c = self._counters.get(kind)
                if c is None:
                    from ps_tpu_torch.obs.metrics import default_registry

                    c = self._counters[kind] = default_registry().counter(
                        f"ps_event_{kind}_total",
                        f"flight-recorder '{kind}' events")
            c.inc()
        except Exception:
            pass

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- dumping ---------------------------------------------------------------

    def dump(self, reason: str, path: Optional[str] = None,
             empty_ok: bool = False) -> Optional[str]:
        """Write the ring as JSONL (header line first); returns the path,
        or None when the write failed (a crashing process must not crash
        harder in its black box) — or when the ring is empty, unless
        ``empty_ok`` (an operator's SIGUSR2 poke should always produce
        the file; crash-path dumps with nothing to say stay silent)."""
        events = self.events()
        if not events and not empty_ok:
            return None
        try:
            if path is None:
                from ps_tpu_torch.config import env_str

                base = (self.dir or env_str("PS_FLIGHT_DIR")
                        or env_str("PS_TRACE_DIR") or ".")
                os.makedirs(base, exist_ok=True)
                path = os.path.join(
                    base,
                    f"flight-{self.service}-{os.getpid()}-"
                    f"{int(time.time() * 1e3)}.jsonl",
                )
            with open(path, "w") as f:
                f.write(json.dumps({
                    "flight_dump": reason, "pid": os.getpid(),
                    "service": self.service, "t": round(time.time(), 6),
                    "events": len(events), "events_total": self.total,
                }) + "\n")
                for evt in events:
                    f.write(json.dumps(evt) + "\n")
            self._dumped_paths.append(path)
            print(f"flight recorder: {len(events)} event(s) dumped to "
                  f"{path} ({reason})", file=sys.stderr)
            return path
        except Exception:
            return None

    # -- hooks -----------------------------------------------------------------

    def install(self) -> None:
        """Arm the automatic dump triggers (idempotent):

        - ``sys.excepthook`` / ``threading.excepthook``: dump when an
          unhandled :class:`VanError` (connection-plane death) escapes —
          exactly the moment an operator wants the last N events; other
          exception types pass through untouched (pytest and friends own
          those);
        - ``SIGUSR2``: dump a LIVE process on demand (main thread only —
          signal registration elsewhere raises, and a worker thread
          installing hooks should still get the excepthooks).
        """
        if self._installed:
            return
        self._installed = True

        def _is_van_error(exc) -> bool:
            try:
                from ps_tpu_torch.control.tensor_van import VanError

                return isinstance(exc, VanError)
            except Exception:
                return False

        prev_sys = sys.excepthook

        def _sys_hook(exc_type, exc, tb):
            if _is_van_error(exc):
                self.dump(f"unhandled {exc_type.__name__}: {exc}")
            prev_sys(exc_type, exc, tb)

        sys.excepthook = _sys_hook

        prev_thread = threading.excepthook

        def _thread_hook(args):
            if _is_van_error(args.exc_value):
                self.dump(
                    f"unhandled {args.exc_type.__name__} in thread "
                    f"{getattr(args.thread, 'name', '?')}: {args.exc_value}"
                )
            prev_thread(args)

        threading.excepthook = _thread_hook

        try:
            import signal

            def _usr2(signum, frame):
                self.dump("SIGUSR2", empty_ok=True)

            signal.signal(signal.SIGUSR2, _usr2)
        except (ValueError, OSError, AttributeError):
            pass  # not the main thread / platform without SIGUSR2
