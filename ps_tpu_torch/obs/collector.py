"""Delta-encoded telemetry snapshots: the member's side of fleet telemetry.

Counterpart of ``ps_tpu/obs/collector.py``, the same payloads. A member
sends its metric state to the coordinator with each load report
(``elastic/member.py``) as a delta against the last snapshot it sent:

- a counter as its increment (``{"k": "c", "d": n}``), left out at 0;
- a gauge as its value (``{"k": "g", "v": x}``);
- a histogram as the raw buckets that moved (``{"k": "h", "dc":
  {bucket: dcount}, "dn", "ds", "mx", "mn"}``): raw buckets, never
  percentiles, so the coordinator merges them without loss
  (``obs/tsdb.py``).

Every payload carries a ``seq``. A decoder that sees a gap (the
coordinator restarted, a report was lost) answers ``telemetry_resync``
and the encoder's next payload is a full snapshot (``"full": True``,
absolute values) that rebuilds the baseline; a metric that first appears
mid-stream travels in full form once.

:func:`collect_telemetry` is the usual source: one endpoint's
:class:`~ps_tpu_torch.utils.metrics.TransportStats` (its histograms carry
their Prometheus names) and the caller's counters and gauges, not the
process registry, so several services in one process each report their
own numbers.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ps_tpu_torch.obs.metrics import state_add

__all__ = ["collect_telemetry", "DeltaEncoder", "DeltaDecoder"]

#: the TransportStats counters shipped fleet-wide, with their wire names
_STATS_COUNTERS = (
    ("stale_epochs", "ps_stale_epochs_total"),
    ("dedup_hits", "ps_dedup_hits_total"),
    ("failovers", "ps_failovers_total"),
    ("table_reroutes", "ps_table_reroutes_total"),
    # the native serve loop: epoll iterations, frames it read, and its
    # batched upcalls (their window rates are the loop's throughput)
    ("loop_iters", "ps_van_loop_iterations_total"),
    ("loop_requests", "ps_van_loop_requests_total"),
    ("loop_upcalls", "ps_van_loop_upcalls_total"),
    # frames the loop's slow-frame watchdog captured
    ("nl_slow_frames", "ps_nl_slow_frames_total"),
    # negative cross-process ages clamped to zero (clock skew)
    ("fresh_clock_clamped", "ps_freshness_clock_clamped_total"),
)

#: the TransportStats gauges (values, not cumulative) shipped fleet-wide
_STATS_GAUGES = (
    ("loop_conns", "ps_van_live_connections"),
    ("nl_tail_backlog_bytes", "ps_nl_tail_backlog_bytes"),
)


def collect_telemetry(transport,
                      counters: Optional[Dict[str, Callable]] = None,
                      gauges: Optional[Dict[str, Callable]] = None) -> dict:
    """One endpoint's cumulative telemetry: every histogram of
    ``transport`` that recorded (raw buckets), its counters, and the
    caller's extras (``{name: zero-argument callable}``)."""
    out: dict = {}
    for h in transport.hist.values():
        if h.total > 0:
            out[h.name] = {"k": "hist", **h.state()}
    for attr, name in _STATS_COUNTERS:
        v = getattr(transport, attr, 0)
        if v:
            out[name] = {"k": "counter", "v": int(v)}
    # the gauges go whenever the native loop runs here, zero included:
    # "every worker left" must overwrite the last fan-in
    if getattr(transport, "loop_iters", 0):
        for attr, name in _STATS_GAUGES:
            out[name] = {"k": "gauge",
                         "v": float(getattr(transport, attr, 0))}
    for name, fn in (counters or {}).items():
        out[name] = {"k": "counter", "v": int(fn())}
    for name, fn in (gauges or {}).items():
        out[name] = {"k": "gauge", "v": float(fn())}
    return out


def _entry_delta(kind: str, now: dict, prev: Optional[dict]):
    """One metric's wire entry, or None when it did not move."""
    if kind == "gauge":
        if prev is not None and prev.get("v") == now.get("v"):
            return None
        return {"k": "g", "v": now["v"]}
    if kind == "counter":
        if prev is None:
            return {"k": "c", "v": int(now["v"])}
        d = int(now["v"]) - int(prev["v"])
        return {"k": "c", "d": d} if d else None
    if prev is None:
        return {"k": "h", "lo": now["lo"], "hi": now["hi"],
                "c": list(now["c"]), "n": now["n"], "s": now["s"],
                "mx": now["mx"], "mn": now["mn"]}
    dn = now["n"] - prev["n"]
    if dn == 0:
        return None
    dc = {i: a - b for i, (a, b) in enumerate(zip(now["c"], prev["c"]))
          if a != b}
    return {"k": "h", "dc": dc, "dn": dn, "ds": now["s"] - prev["s"],
            "mx": now["mx"], "mn": now["mn"]}


class DeltaEncoder:
    """The member's side: successive cumulative states into wire deltas.

    ``collect`` returns the current cumulative state (what
    :func:`collect_telemetry` returns). The baseline moves each time a
    snapshot is built; :meth:`force_full` makes the next one absolute.
    """

    def __init__(self, collect: Callable[[], dict]):
        self._collect = collect
        self._lock = threading.Lock()
        self._prev: Optional[dict] = None
        self.seq = 0

    def force_full(self) -> None:
        """Send absolute values next time (the decoder lost its
        baseline)."""
        with self._lock:
            self._prev = None

    def snapshot(self) -> Optional[dict]:
        """The next payload, or None when nothing moved (the report then
        goes without telemetry)."""
        state = self._collect()
        with self._lock:
            full = self._prev is None
            self.seq += 1
            payload: dict = {"seq": self.seq, "m": {}}
            if full:
                payload["full"] = True
            for name, entry in state.items():
                kind = entry.get("k", "hist")
                prev = None if full else (self._prev or {}).get(name)
                wire = _entry_delta(kind, entry, prev)
                if wire is not None:
                    payload["m"][name] = wire
            self._prev = state
            if not payload["m"] and not full:
                self.seq -= 1  # silence spends no seq
                return None
            return payload


class DeltaDecoder:
    """The coordinator's side: one member's cumulative state rebuilt from
    its deltas. :meth:`ingest` returns ``{metric: {"k": kind, ...}}`` for
    :meth:`~ps_tpu_torch.obs.tsdb.FleetTSDB.ingest`, or None when the
    stream needs a resync (a seq gap, a delta with no baseline)."""

    def __init__(self):
        self._cum: dict = {}
        self._seq: Optional[int] = None

    def ingest(self, payload: dict) -> Optional[dict]:
        try:
            seq = int(payload["seq"])
            entries = payload.get("m") or {}
            full = bool(payload.get("full"))
        except (KeyError, TypeError, ValueError):
            return None
        if full:
            self._cum = {}
        elif self._seq is None or seq != self._seq + 1:
            self._seq = None
            return None  # a gap: deltas against a baseline not held
        self._seq = seq
        for name, wire in entries.items():
            k = wire.get("k")
            if k == "g":
                self._cum[name] = {"k": "gauge", "v": float(wire["v"])}
            elif k == "c":
                if "v" in wire:
                    self._cum[name] = {"k": "counter", "v": int(wire["v"])}
                else:
                    cur = self._cum.get(name)
                    if cur is None:
                        self._seq = None
                        return None  # a delta of a metric never baselined
                    cur["v"] = int(cur["v"]) + int(wire["d"])
            elif k == "h":
                if "c" in wire:  # full form: absolute buckets
                    self._cum[name] = {
                        "k": "hist", "lo": wire["lo"], "hi": wire["hi"],
                        "c": list(wire["c"]), "n": wire["n"],
                        "s": wire["s"], "mx": wire["mx"],
                        "mn": wire.get("mn"),
                    }
                else:
                    cur = self._cum.get(name)
                    if cur is None or cur.get("k") != "hist":
                        self._seq = None
                        return None
                    counts = list(cur["c"])
                    # json makes int keys strings: take both
                    for i, d in (wire.get("dc") or {}).items():
                        counts[int(i)] += int(d)
                    self._cum[name] = state_add(None, {
                        "lo": cur["lo"], "hi": cur["hi"], "c": counts,
                        "n": cur["n"] + int(wire["dn"]),
                        "s": cur["s"] + float(wire["ds"]),
                        "mx": float(wire["mx"]), "mn": wire.get("mn"),
                    })
                    self._cum[name]["k"] = "hist"
        # a copy: the rings must not alias a dict the next delta changes
        return {name: dict(entry) for name, entry in self._cum.items()}
