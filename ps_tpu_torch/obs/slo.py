"""Declarative SLO rules and their evaluator.

Counterpart of ``ps_tpu/obs/slo.py``. A rule is one line of intent,
"push p99 < 10ms over 30s", parsed into a :class:`SloRule`; the
evaluator holds each rule's quantile over its window against the
threshold. The quantiles come from any source with ``quantile(metric,
q, window_s)``: the coordinator's time series store (item 6.2), or a
:class:`RegistryWindow` over one process's registry, which needs no
coordinator.

Rule syntax (``Config.slo_rules`` / ``PS_SLO_RULES``, ``;``-separated)::

    <metric> <quantile> < <threshold> over <window>
    push p99 < 10ms over 30s; apply p999 < 50ms over 60s

``metric`` is a short alias (push, pull, push_pull, cycle, bucket,
apply, ack, flush, read, freshness, staleness) or a histogram's full
name (``ps_push_seconds``); the quantile is ``pNN...``; thresholds take
us/ms/s. A transition into breach records a ``slo_breach`` flight event
(``slo_recover`` on the way back), and every evaluation in breach counts
into ``ps_slo_breach_total``.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["SloRule", "parse_rules", "SloEvaluator", "RegistryWindow",
           "METRIC_ALIASES"]

METRIC_ALIASES: Dict[str, str] = {
    "push": "ps_push_seconds",
    "pull": "ps_pull_seconds",
    "push_pull": "ps_push_pull_seconds",
    "cycle": "ps_cycle_seconds",
    "bucket": "ps_bucket_seconds",
    "apply": "ps_server_apply_seconds",
    "ack": "ps_replica_ack_wait_seconds",
    "flush": "ps_blocked_seconds",
    # freshness plane (README "Online serving & freshness"): the serving
    # latency a reader feels, the push->servable lag on the primary, and
    # the data age at serve time — "freshness p99 < 500ms over 30s" is
    # the canonical online-serving objective
    "read": "ps_read_seconds",
    "freshness": "ps_freshness_lag_seconds",
    "staleness": "ps_read_staleness_seconds",
}

_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0}

_RULE_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z0-9_]+)\s+p(?P<q>\d+)\s*<=?\s*"
    r"(?P<thr>\d+(?:\.\d+)?)\s*(?P<unit>us|ms|s)\s+"
    r"over\s+(?P<win>\d+(?:\.\d+)?)\s*(?P<wunit>ms|s|m)\s*$")


class SloRule:
    """One parsed objective: ``metric``'s fleet ``q``-quantile over the
    last ``window_s`` seconds must stay under ``threshold_s``."""

    __slots__ = ("text", "metric", "q", "qlabel", "threshold_s",
                 "window_s")

    def __init__(self, text: str, metric: str, q: float,
                 threshold_s: float, window_s: float,
                 qlabel: Optional[str] = None):
        self.text = text
        self.metric = metric
        self.q = q
        # "p99"-style label: the digits after the decimal point
        self.qlabel = qlabel or ("p" + f"{q:.10f}".split(".")[1].rstrip("0"))
        self.threshold_s = threshold_s
        self.window_s = window_s

    def __repr__(self) -> str:
        return f"SloRule({self.text!r})"


def parse_rule(text: str) -> SloRule:
    m = _RULE_RE.match(text)
    if m is None:
        raise ValueError(
            f"unparseable SLO rule {text!r} — expected "
            f"'<metric> p99 < 10ms over 30s' "
            f"(metric: {sorted(METRIC_ALIASES)} or a ps_*_seconds name)")
    metric = METRIC_ALIASES.get(m["metric"], m["metric"])
    if not metric.startswith("ps_"):
        raise ValueError(
            f"unknown SLO metric {m['metric']!r} — use one of "
            f"{sorted(METRIC_ALIASES)} or a full ps_* histogram name")
    digits = m["q"]
    q = int(digits) / (10 ** len(digits))  # p99 -> 0.99, p999 -> 0.999
    if not (0.0 < q < 1.0):
        raise ValueError(f"quantile p{digits} outside (0, 1) in {text!r}")
    thr = float(m["thr"]) * _UNITS[m["unit"]]
    wunit = {"ms": 1e-3, "s": 1.0, "m": 60.0}[m["wunit"]]
    win = float(m["win"]) * wunit
    if win <= 0 or thr <= 0:
        raise ValueError(f"threshold/window must be positive in {text!r}")
    return SloRule(text.strip(), metric, q, thr, win,
                   qlabel="p" + digits)


def parse_rules(spec: Optional[str]) -> List[SloRule]:
    """``;``-separated rule list → rules (empty for None/blank)."""
    if not spec or not spec.strip():
        return []
    return [parse_rule(part) for part in spec.split(";") if part.strip()]


class SloEvaluator:
    """Evaluate a rule set against a window source (``tsdb``: anything
    with ``quantile(metric, q, window_s)``); latch breach state."""

    def __init__(self, tsdb, rules: List[SloRule]):
        self.tsdb = tsdb
        self.rules = list(rules)
        self._lock = threading.Lock()
        self._breached: Dict[str, dict] = {}  # rule text -> live breach
        from ps_tpu_torch.obs.metrics import default_registry

        self._m_breach = default_registry().counter(
            "ps_slo_breach_total",
            "SLO evaluations that found a rule in breach")

    def evaluate(self) -> List[dict]:
        """One pass; returns per-rule state dicts (value may be None when
        no member has window data for the metric — not a breach: absence
        of traffic is not a latency violation)."""
        from ps_tpu_torch import obs

        out = []
        for rule in self.rules:
            value = self.tsdb.quantile(rule.metric, rule.q, rule.window_s)
            breached = value is not None and value > rule.threshold_s
            state = {
                "rule": rule.text, "metric": rule.metric,
                "q": rule.qlabel, "window_s": rule.window_s,
                "threshold_ms": round(rule.threshold_s * 1e3, 3),
                "value_ms": (None if value is None
                             else round(value * 1e3, 3)),
                "breached": breached,
            }
            with self._lock:
                was = rule.text in self._breached
                if breached:
                    self._breached[rule.text] = state
                else:
                    self._breached.pop(rule.text, None)
            if breached:
                self._m_breach.inc()
                if not was:
                    obs.record_event("slo_breach", rule=rule.text,
                                     value_ms=state["value_ms"],
                                     threshold_ms=state["threshold_ms"])
            elif was and value is not None:
                obs.record_event("slo_recover", rule=rule.text,
                                 value_ms=state["value_ms"],
                                 threshold_ms=state["threshold_ms"])
            out.append(state)
        return out

    def breached(self) -> List[dict]:
        with self._lock:
            return list(self._breached.values())


class RegistryWindow:
    """Windowed histogram quantiles and per-member means without a
    coordinator: the window source :class:`SloEvaluator` and
    :class:`~ps_tpu_torch.obs.straggler.StragglerDetector` read.

    Each :meth:`sample` takes one member's cumulative histograms (a
    ``TransportStats.hist`` dict, raw states, or a whole registry through
    :meth:`sample_registry`) at one instant; a window is the raw-bucket
    difference between the newest sample and the newest one at or before
    the window's start (else the oldest), as the coordinator's time series
    store computes it, so the quantiles are of exactly the window's
    samples and the merge across members is lossless."""

    def __init__(self, window_s: float = 30.0, ring: int = 256):
        self.window_s = float(window_s)
        self._ring = int(ring)
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[Tuple[float, dict]]] = {}

    def sample(self, member: str, hists: dict,
               now: Optional[float] = None) -> None:
        """One cumulative snapshot of ``member``'s histograms (``{metric:
        Histogram or state}``, keyed by the Prometheus name)."""
        from ps_tpu_torch.obs.metrics import Histogram

        states = {}
        for name, h in hists.items():
            st = h.state() if isinstance(h, Histogram) else dict(h)
            states[h.name if isinstance(h, Histogram) else name] = st
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            ring = self._series.setdefault(
                str(member), collections.deque(maxlen=self._ring))
            ring.append((t, states))

    def sample_registry(self, member: str = "local", registry=None,
                        now: Optional[float] = None) -> None:
        """Sample every histogram of ``registry`` (default: the process
        registry), same-name instruments merged."""
        from ps_tpu_torch.obs.metrics import _merge_hists, default_registry

        reg = registry if registry is not None else default_registry()
        self.sample(member, {name: _merge_hists(insts).state()
                             for name, kind, _, insts in reg._merged()
                             if kind == "histogram"}, now=now)

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def window(self, member: str, metric: str,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[dict]:
        """``member``'s raw-bucket state of ``metric`` over the window
        (its lifetime state while only one sample exists); None when the
        member never reported the metric, or went quiet for more than
        three windows (stale beyond use, as in the coordinator's store)."""
        from ps_tpu_torch.obs.metrics import state_sub

        w = self.window_s if window_s is None else float(window_s)
        with self._lock:
            ring = list(self._series.get(str(member), ()))
        ring = [(t, st[metric]) for t, st in ring if metric in st]
        if not ring:
            return None
        t1, latest = ring[-1]
        t = (time.monotonic() if now is None else float(now))
        if t - t1 > 3 * w:
            return None
        base = ring[0]
        for t0, st in ring:
            if t0 <= t - w:
                base = (t0, st)
            else:
                break
        return state_sub(latest, base[1]) if t1 > base[0] else latest

    def quantile(self, metric: str, q: float,
                 window_s: Optional[float] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """The ``q``-quantile of every member's window merged; None when
        no member has a sample of ``metric`` in it."""
        from ps_tpu_torch.obs.metrics import Histogram, state_add

        merged = None
        for m in self.members():
            st = self.window(m, metric, window_s, now)
            if st is not None and st["n"] > 0:
                merged = state_add(merged, st)
        if merged is None:
            return None
        return Histogram.from_state(metric, merged).quantile(q)

    def member_mean(self, member: str, metric: str,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None
                    ) -> Optional[Tuple[float, int]]:
        """``(window mean, window count)`` of ``metric`` for one member."""
        st = self.window(member, metric, window_s, now)
        if st is None or st["n"] <= 0:
            return None
        return st["s"] / st["n"], int(st["n"])
