"""Scheduled fault injection for the port's fleets (README "Autopilot &
chaos").

The counterpart of the reference's ``chaos/inject.py``, with its
semantics: the same plan for the same seed, the same refusal bytes.

Fault classes and where each one bites:

==================  ========================================================
fault               mechanism
==================  ========================================================
``blackhole``       :class:`ChaosHook` answers every data-plane frame with
                    the typed retry-able refusal a non-serving backup emits
                    (``{"backup": True}``) — workers park and retry, exactly
                    as they would against a mid-promotion shard.
``slow_apply``      the noisy-neighbor grinder: a thread pulses the target
                    service's apply lock, holding it for ``hold_s`` each
                    beat — every concurrent push's apply latency (lock wait
                    included, by design of ``ps_server_apply_seconds``)
                    balloons, which is EXACTLY the straggler detector's
                    signal. Models a thermally-throttled / contended host.
``sigstop``         ``SIGSTOP``/``SIGCONT`` on a subprocess member: the
                    whole process (heartbeats, reports, serve threads)
                    freezes mid-flight and later resumes — pushes park in
                    the kernel's accept queue and complete late, burning
                    the fleet SLO window.
``sigkill``         ``SIGKILL`` on a subprocess primary: real process
                    death; the backup's PromotionWatch and the autopilot's
                    re-seed rule own the recovery.
``reconnect_storm`` client-driven: the harness flags hammer workers to
                    re-dial their servers between cycles for the storm
                    window (a restarted worker fleet re-connecting).
``agg_death``       kill an aggregator service mid-round; its workers must
                    degrade to the remembered flat topology.
==================  ========================================================

Every injection records a ``chaos_inject`` flight event and a row in the
injector's ledger (``chip_smoke.py`` phase 26 reports from it).
Schedules are deterministic under ``PS_CHAOS_SEED``: the injector's only
randomness source is one ``random.Random(seed)``, so two runs with the
same seed plan the same faults at the same offsets in the same order.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import List, Optional

from ps_tpu_torch import obs
from ps_tpu_torch.control import tensor_van as tv

__all__ = ["ChaosHook", "ChaosInjector", "DATA_KINDS"]

#: the data-plane kinds a blackhole swallows — control traffic (HELLO,
#: STATS, replication, coordinator, checkpoint, migration) stays up, the
#: way a wedged engine or a filled accept queue starves workers first
DATA_KINDS = frozenset({
    tv.PUSH, tv.PULL, tv.PUSH_PULL, tv.READ,
    tv.BUCKET_PUSH, tv.BUCKET_PULL,
    tv.ROW_PULL, tv.ROW_PUSH, tv.ROW_PUSH_PULL, tv.ROW_BUCKET_PUSH,
})


class ChaosHook:
    """The per-service fault interceptor (``svc.chaos`` slot).

    Armed faults are deadline-based: :meth:`blackhole` refuses data
    frames until its window elapses, then the hook is inert again (one
    monotonic compare per frame). The refusal is byte-shaped like the
    backup's "not serving, retry after promotion" reply, so the
    worker-side failover loop — not some chaos-aware special case —
    does the waiting.
    """

    def __init__(self, svc):
        self.svc = svc
        self.refused = 0  # frames answered with the blackhole refusal
        self._black_until = 0.0
        svc.chaos = self

    def blackhole(self, duration_s: float) -> None:
        """Refuse all data-plane frames for ``duration_s`` seconds."""
        self._black_until = time.monotonic() + float(duration_s)
        obs.record_event("chaos_inject", fault="blackhole",
                         target=getattr(self.svc, "port", None),
                         duration_s=round(float(duration_s), 3))

    def clear(self) -> None:
        self._black_until = 0.0

    @property
    def active(self) -> bool:
        return time.monotonic() < self._black_until

    def __call__(self, svc, kind: int, worker: int, extra):
        if kind not in DATA_KINDS:
            return None
        if time.monotonic() < self._black_until:
            self.refused += 1
            return tv.encode(tv.ERR, worker, None, extra={
                "error": "chaos: connection blackholed — retry",
                "backup": True, "epoch": svc.epoch,
            })
        return None


class ChaosInjector:
    """Deterministic fault scheduler + the injection ledger.

    Args:
      seed: the plan/jitter seed. None reads ``PS_CHAOS_SEED``
        (``Config.chaos_seed``, default 0) — the knob CI pins so a
        failing soak replays bit-identically.
    """

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            from ps_tpu_torch.config import env_int

            seed = env_int("PS_CHAOS_SEED", 0)
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.injections: List[dict] = []  # the ledger the soak reports
        self._grinders: List[threading.Thread] = []

    # -- the plan ------------------------------------------------------------

    def plan(self, classes: List[str], horizon_s: float,
             spacing_s: float = 0.0) -> List[dict]:
        """A deterministic drill schedule: every class once, in seeded
        order, at seeded offsets spread over ``horizon_s`` (plus a fixed
        ``spacing_s`` floor between drills). Same seed + same inputs →
        the same schedule, which is what makes a chaos failure a
        REPRODUCIBLE bug report instead of weather."""
        order = list(classes)
        self.rng.shuffle(order)
        n = max(len(order), 1)
        slot = max(float(horizon_s) / n, 1e-6)
        out = []
        for i, cls in enumerate(order):
            jitter = self.rng.uniform(0.0, slot * 0.25)
            out.append({"at_s": round(i * (slot + float(spacing_s))
                                      + jitter, 3),
                        "fault": cls})
        return out

    def _record(self, fault: str, **detail) -> dict:
        row = {"t": time.monotonic(), "fault": fault, **detail}
        self.injections.append(row)
        obs.record_event("chaos_inject", fault=fault, **detail)
        return row

    def mark(self, fault: str, **detail) -> dict:
        """Ledger a fault the harness inflicts by its own means (e.g. a
        dying-call wrapper killing an aggregator mid-round) so the
        report still carries one row per injection."""
        return self._record(fault, **detail)

    # -- process-level faults (subprocess targets) ---------------------------

    def sigstop(self, pid: int) -> None:
        self._record("sigstop", pid=int(pid))
        os.kill(int(pid), signal.SIGSTOP)

    def sigcont(self, pid: int) -> None:
        self._record("sigcont", pid=int(pid))
        os.kill(int(pid), signal.SIGCONT)

    def sigkill(self, pid: int) -> None:
        self._record("sigkill", pid=int(pid))
        os.kill(int(pid), signal.SIGKILL)

    # -- in-process faults ---------------------------------------------------

    def blackhole(self, hook: ChaosHook, duration_s: float) -> None:
        self._record("blackhole", target=getattr(hook.svc, "port", None),
                     duration_s=round(float(duration_s), 3))
        hook.blackhole(duration_s)

    def noisy_neighbor(self, svc, duration_s: float,
                       hold_s: float = 0.04, idle_s: float = 0.01
                       ) -> threading.Thread:
        """The slow-apply fault: pulse the service's apply lock from a
        grinder thread, holding ``hold_s`` per beat for ``duration_s``.
        Every push racing a hold waits under ``ps_server_apply_seconds``
        (lock wait IS apply-path latency there, by design), so the
        target's window mean stands out to the straggler detector the
        same way a genuinely slow host's would."""
        self._record("slow_apply", target=getattr(svc, "port", None),
                     duration_s=round(float(duration_s), 3),
                     hold_s=hold_s)
        lock = svc._service_lock()
        deadline = time.monotonic() + float(duration_s)

        def grind():
            while time.monotonic() < deadline:
                with lock:
                    time.sleep(hold_s)  # pslint: disable=PSL101 -- the fault IS blocking under the apply lock: the grinder simulates a contended/throttled host precisely by making real applies wait out its hold
                time.sleep(idle_s)

        t = threading.Thread(target=grind, daemon=True, name="ps-chaos-grind")
        t.start()
        self._grinders.append(t)
        return t

    def reconnect_storm(self, flag: dict, duration_s: float,
                        target: Optional[str] = None) -> None:
        """Arm the client-driven storm: hammer loops that honor ``flag``
        re-dial their servers between cycles until the window closes
        (``flag["until"]``, monotonic). The injector only sets the flag
        — the churn itself must come from real workers re-connecting,
        or the service-side accept path isn't actually exercised."""
        self._record("reconnect_storm", target=target,
                     duration_s=round(float(duration_s), 3))
        flag["until"] = time.monotonic() + float(duration_s)

    def join(self, timeout_s: float = 30.0) -> None:
        """Wait out any grinder still holding its window."""
        deadline = time.monotonic() + float(timeout_s)
        for t in self._grinders:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        self._grinders = [t for t in self._grinders if t.is_alive()]
