"""Bounded in-memory time series of fleet telemetry.

Counterpart of ``ps_tpu/obs/tsdb.py``, the same code: the coordinator
(``elastic/``) lands here what its members report with their loads
(delta-encoded, rebuilt by :class:`~ps_tpu_torch.obs.collector.
DeltaDecoder`): one bounded ring of cumulative samples a (member,
metric), and the windowed reads the rest of the fleet view makes of them:

- one member's window (:meth:`FleetTSDB.window`): a counter's delta and
  rate, a gauge's latest value, a histogram's raw log2-bucket delta;
- the fleet's window (:meth:`FleetTSDB.fleet_window`,
  :meth:`FleetTSDB.quantile`): the members' raw bucket deltas summed
  with :func:`~ps_tpu_torch.obs.metrics.state_add`, which is the
  histogram of every sample pooled, so the fleet p99 is the p99 of all
  the members' samples and never an average of their percentiles;
- Prometheus text (:meth:`FleetTSDB.render_prometheus`) for the
  coordinator's /metrics: each metric's merged cumulative histogram
  (``ps_fleet_<metric>_bucket``) and a windowed p50/p99/p999 gauge a
  (member, metric).

Memory is bounded: ``ring`` samples a series, and a member's series go
with its goodbye or death (:meth:`FleetTSDB.drop_member`). Every stamp
is the coordinator's own monotonic clock at ingest, so a window across
members never depends on the members' clocks.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from ps_tpu_torch.obs.metrics import Histogram, state_add, state_sub

__all__ = ["FleetTSDB"]

#: the quantile gauges rendered a (member, metric)
_QUANTS = (("p50", 0.50), ("p99", 0.99), ("p999", 0.999))


def _hist(st: dict) -> Histogram:
    return Histogram.from_state("m", st)


class FleetTSDB:
    """Rings of cumulative samples a (member, metric), and windows.

    A sample is ``(t, payload)``: a number for a counter or a gauge, a raw
    histogram state for a histogram. Reports ingest from serve threads
    while queries run from other requests and the /metrics scrape, so
    every access takes the one lock.
    """

    def __init__(self, window_s: float = 30.0, ring: int = 256):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if ring < 2:
            raise ValueError("ring must hold at least 2 samples "
                             "(a window needs a baseline)")
        self.window_s = float(window_s)
        self.ring = int(ring)
        self._lock = threading.Lock()
        # (member, metric) -> deque[(t, payload)]; one kind a metric name
        self._series: Dict[Tuple[str, str], collections.deque] = {}
        self._kinds: Dict[str, str] = {}
        self._members: Dict[str, float] = {}  # member -> last ingest t

    def ingest(self, member: str, state: dict,
               t: Optional[float] = None) -> None:
        """Land one member's cumulative state (``{metric: {"k": kind,
        ...}}``, what a ``DeltaDecoder`` rebuilds from the wire)."""
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            self._members[str(member)] = t
            for name, entry in state.items():
                kind = entry.get("k", "counter")
                prev = self._kinds.setdefault(name, kind)
                if prev != kind:
                    continue  # a name keeps its first kind
                key = (str(member), str(name))
                ring = self._series.get(key)
                if ring is None:
                    ring = self._series[key] = collections.deque(
                        maxlen=self.ring)
                if kind == "hist":
                    ring.append((t, {k: v for k, v in entry.items()
                                     if k != "k"}))
                else:
                    ring.append((t, float(entry.get("v", 0))))

    def drop_member(self, member: str) -> None:
        """Forget a departed member's series."""
        with self._lock:
            self._members.pop(str(member), None)
            for key in [k for k in self._series if k[0] == str(member)]:
                del self._series[key]

    def prune_stale(self, max_age_s: Optional[float] = None) -> List[str]:
        """Drop the members whose last ingest is older than ``max_age_s``
        (ten windows by default: restarted workers report under new ids);
        returns them, so the caller can drop their decoders too."""
        age = 10.0 * self.window_s if max_age_s is None else max_age_s
        now = time.monotonic()
        with self._lock:
            gone = [m for m, t in self._members.items() if now - t > age]
        for m in gone:
            self.drop_member(m)
        return gone

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def metrics(self) -> List[str]:
        with self._lock:
            return sorted(self._kinds)

    def kind(self, metric: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(metric)

    def _window_pair(self, key, now: float, window_s: float):
        """(baseline, latest) of a window ending now: the baseline is the
        newest sample at or before the window's start, else the oldest (a
        short history reads as 'since first seen')."""
        ring = self._series.get(key)
        if not ring:
            return None
        t1, latest = ring[-1]
        if now - t1 > 3 * window_s:
            return None  # quiet for three windows: stale beyond use
        base = None
        for t0, payload in ring:
            if t0 <= now - window_s:
                base = (t0, payload)
            else:
                break
        if base is None:
            base = ring[0]
        return base, (t1, latest)

    def window(self, member: str, metric: str,
               window_s: Optional[float] = None) -> Optional[dict]:
        """One member's ``metric`` over the last ``window_s``: a counter's
        ``{"delta", "rate", "value"}``, a gauge's ``{"value"}``, a
        histogram's raw bucket delta (``state``) with its ``summary``."""
        now = time.monotonic()
        w = self.window_s if window_s is None else float(window_s)
        with self._lock:
            kind = self._kinds.get(metric)
            pair = self._window_pair((str(member), str(metric)), now, w)
        if kind is None or pair is None:
            return None
        (t0, base), (t1, latest) = pair
        dt = max(t1 - t0, 1e-9)
        if kind == "gauge":
            return {"k": "gauge", "value": latest}
        if kind == "counter":
            # one sample moves nothing: a long-lived member's first report
            # after a coordinator restart carries its lifetime total
            delta = (latest - base) if t1 > t0 else 0.0
            return {"k": "counter", "value": latest, "delta": delta,
                    "rate": (delta / dt) if t1 > t0 else 0.0}
        # a histogram's one sample is still a distribution (its lifetime)
        st = state_sub(latest, base) if t1 > t0 else latest
        out = {"k": "hist", "state": st}
        if st["n"] > 0:
            out["summary"] = _hist(st).summary()
        return out

    def fleet_window(self, metric: str,
                     window_s: Optional[float] = None) -> Optional[dict]:
        """Every member's window merged: summed counter deltas, or the
        merged raw-bucket state with its summary (the fleet's own
        distribution over the window). ``per_member`` carries each
        member's window, computed on the way."""
        with self._lock:
            members = sorted(self._members)
        kind = self.kind(metric)
        if kind is None:
            return None
        merged = None
        per_member: Dict[str, dict] = {}
        for m in members:
            win = self.window(m, metric, window_s)
            if win is None:
                continue
            per_member[m] = win
            if kind == "hist":
                if win["state"]["n"] > 0:
                    merged = state_add(merged, win["state"])
            elif kind == "counter":
                merged = (merged or 0.0) + win["delta"]
        if not per_member:
            return None
        out = {"k": kind, "members": sorted(per_member),
               "per_member": per_member}
        if kind == "hist" and merged is not None:
            out["state"] = merged
            out["summary"] = _hist(merged).summary()
        elif kind == "counter":
            out["delta"] = merged or 0.0
        elif kind == "gauge":
            out["values"] = {m: w["value"] for m, w in per_member.items()}
        return out

    def quantile(self, metric: str, q: float,
                 window_s: Optional[float] = None) -> Optional[float]:
        """The fleet's ``q``-quantile of ``metric`` over the window, from
        the merged raw buckets; None when no member reported it."""
        win = self.fleet_window(metric, window_s)
        if not win or win.get("k") != "hist" or "state" not in win:
            return None
        return _hist(win["state"]).quantile(q)

    def member_mean(self, member: str, metric: str,
                    window_s: Optional[float] = None
                    ) -> Optional[Tuple[float, int]]:
        """``(window mean, window count)`` of one member's histogram: what
        the straggler score compares across members."""
        win = self.window(member, metric, window_s)
        if not win or win.get("k") != "hist":
            return None
        st = win["state"]
        if st["n"] <= 0:
            return None
        return st["s"] / st["n"], int(st["n"])

    def render_prometheus(self) -> str:
        """Fleet series for the coordinator's /metrics (a registry
        exporter): each histogram's merged cumulative buckets, and a
        windowed quantile gauge a (member, metric)."""
        import math

        lines: List[str] = []
        with self._lock:
            members = sorted(self._members)
            metrics = sorted(self._kinds.items())
            latest = {key: ring[-1][1]
                      for key, ring in self._series.items() if ring}
        for name, kind in metrics:
            fleet = "ps_fleet_" + (name[3:] if name.startswith("ps_")
                                   else name)
            if kind == "hist":
                merged = None
                for m in members:
                    st = latest.get((m, name))
                    if st is not None and st["n"] > 0:
                        merged = state_add(merged, st)
                if merged is None:
                    continue
                lines.append(f"# TYPE {fleet} histogram")
                h = _hist(merged)
                for ub, cum in h.buckets():
                    le = "+Inf" if math.isinf(ub) else repr(float(ub))
                    lines.append(f'{fleet}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{fleet}_sum {repr(float(h.sum))}")
                lines.append(f"{fleet}_count {h.total}")
                qname = fleet[:-len("_seconds")] if fleet.endswith(
                    "_seconds") else fleet
                lines.append(f"# TYPE {qname}_quantile_seconds gauge")
                for m in members:
                    win = self.window(m, name)
                    if not win or "summary" not in win:
                        continue
                    for label, q in _QUANTS:
                        v = win["summary"][label]
                        lines.append(
                            f'{qname}_quantile_seconds{{member="{m}",'
                            f'q="{label}"}} {repr(float(v))}')
            else:
                any_line = False
                for m in members:
                    v = latest.get((m, name))
                    if v is None:
                        continue
                    if not any_line:
                        kind_s = "gauge" if kind == "gauge" else "counter"
                        lines.append(f"# TYPE {fleet} {kind_s}")
                        any_line = True
                    lines.append(f'{fleet}{{member="{m}"}} '
                                 f'{repr(float(v))}')
        return "\n".join(lines)
