"""Windowed straggler detection over per-member latency means.

Counterpart of ``ps_tpu/obs/straggler.py``. A fleet can be balanced in
bytes and still hold one member that answers ten times slower. The
detector scores each member's window mean of a latency metric (the
server's apply by default) with a leave-one-out z: member i against the
mean and deviation of the other members' means, with the divisor floored
at a share of their mean, so one outlier stands out at any fleet size of
three or more and a tight fast fleet raises nothing.

A suspect fires once at onset (it clears below half the threshold): a
``straggler_suspect`` flight event, ``ps_straggler_suspects_total`` and a
hint. The detector never acts. Its source is anything with ``members()``
and ``member_mean(member, metric)``: the coordinator's time series store
(:class:`~ps_tpu_torch.obs.tsdb.FleetTSDB`, what the coordinator runs
it on) or a :class:`~ps_tpu_torch.obs.slo.RegistryWindow` in a process
without a coordinator.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["StragglerDetector"]


def _mean_std(xs: List[float]) -> Tuple[float, float]:
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / len(xs)
    return m, var ** 0.5


class StragglerDetector:
    """Leave-one-out z-score over per-member window means.

    Args:
      tsdb: a window source: ``members()`` and ``member_mean(m, metric)``.
      metrics: latency histogram metrics scanned per evaluation (first
        one a member reports is used for that member set).
      z: suspicion threshold on the leave-one-out score
        (``Config.telemetry_straggler_z`` / PS_TELEMETRY_STRAGGLER_Z).
      min_members: fewest members WITH window data before any score is
        computed (z over 2 members is a coin flip).
      min_count: fewest window samples a member needs to be scored — a
        member that served 1 request is noise, not a straggler.
      rel_floor: stddev floor as a fraction of the others' mean.
    """

    METRICS = ("ps_server_apply_seconds", "ps_push_pull_seconds",
               "ps_push_seconds")

    def __init__(self, tsdb, metrics: Tuple[str, ...] = METRICS,
                 z: float = 3.0, min_members: int = 3,
                 min_count: int = 3, rel_floor: float = 0.25):
        self.tsdb = tsdb
        self.metrics = tuple(metrics)
        self.z = float(z)
        self.min_members = int(min_members)
        self.min_count = int(min_count)
        self.rel_floor = float(rel_floor)
        self._lock = threading.Lock()
        self._eval_lock = threading.Lock()  # one evaluation at a time:
        # reports arrive on concurrent serve threads, and interleaved
        # passes would double-fire the same onset
        self._suspected: Dict[str, dict] = {}  # member -> live suspicion
        self.evaluations = 0
        from ps_tpu_torch.obs.metrics import default_registry

        reg = default_registry()
        self._m_suspects = reg.counter(
            "ps_straggler_suspects_total",
            "straggler onsets flagged by the windowed z-score")
        self._m_current = reg.gauge(
            "ps_straggler_members", "members currently under suspicion")

    def evaluate(self, shards: Optional[Dict[str, int]] = None
                 ) -> List[dict]:
        """One detection pass; returns the CURRENT suspect list.

        ``shards`` maps member uri -> shard index (the coordinator's
        membership) — scoring is restricted to those members so worker
        reporters never skew a server comparison; None scores every
        member the tsdb knows."""
        from ps_tpu_torch import obs

        with self._eval_lock:
            return self._evaluate(shards, obs)

    def _evaluate(self, shards, obs) -> List[dict]:
        self.evaluations += 1
        members = (sorted(shards) if shards is not None
                   else self.tsdb.members())
        suspects_now = {}
        for metric in self.metrics:
            means: Dict[str, float] = {}
            counts: Dict[str, int] = {}
            for m in members:
                mc = self.tsdb.member_mean(m, metric)
                if mc is not None and mc[1] >= self.min_count:
                    means[m], counts[m] = mc
            if len(means) < self.min_members:
                continue
            for m, x in means.items():
                others = [v for k, v in means.items() if k != m]
                mean_o, std_o = _mean_std(others)
                floor = max(std_o, self.rel_floor * mean_o, 1e-7)
                score = (x - mean_o) / floor
                if score >= self.z and m not in suspects_now:
                    suspects_now[m] = {
                        "uri": m,
                        "shard": (shards or {}).get(m),
                        "metric": metric,
                        "z": round(score, 2),
                        "mean_ms": round(x * 1e3, 3),
                        "others_mean_ms": round(mean_o * 1e3, 3),
                        "window_count": counts[m],
                    }
                elif m in self._suspected and score >= self.z / 2.0:
                    # hysteresis: an existing suspect stays suspected
                    # until it drops below half the threshold
                    if m not in suspects_now:
                        suspects_now[m] = dict(
                            self._suspected[m], z=round(score, 2))
        with self._lock:
            onsets = [s for m, s in suspects_now.items()
                      if m not in self._suspected]
            self._suspected = suspects_now
            self._m_current.set(len(suspects_now))
        for s in onsets:
            self._m_suspects.inc()
            obs.record_event("straggler_suspect", **s)
        return sorted(suspects_now.values(), key=lambda s: -s["z"])

    def suspects(self) -> List[dict]:
        with self._lock:
            return sorted(self._suspected.values(), key=lambda s: -s["z"])

    def hints(self) -> List[dict]:
        """Rebalance hints for the coordinator's view: what an operator
        (or a future auto-policy) should consider doing about each
        suspect — surfaced NEXT TO the byte-skew trigger, acted on by
        neither automatically."""
        out = []
        for s in self.suspects():
            shard = s.get("shard")
            out.append({
                "kind": "straggler",
                "uri": s["uri"], "shard": shard,
                "metric": s["metric"], "z": s["z"],
                "action": (f"shard {shard} is ~{s['z']}x-sigma slower on "
                           f"{s['metric']} than its peers — consider "
                           f"draining it or moving keys off it"
                           if shard is not None else
                           f"member {s['uri']} is a latency outlier on "
                           f"{s['metric']}"),
            })
        return out
