"""Counters, gauges and log2-bucket latency histograms.

Counterpart of ``ps_tpu/obs/metrics.py``, the same code: the histogram's
geometry, its raw state and Prometheus text are the reference's byte for
byte, so a scrape, a STATS reply's quantiles and a raw-bucket merge read
alike from either package.

- :class:`Histogram`: geometric buckets (log2, 4 sub-buckets an octave),
  so a p50/p99/p999 estimate is within one sub-bucket (2^(1/4), ~19%) of
  the sample quantile at any magnitude, with an O(1) record and no lock.
  The native serve loop's in-loop histograms use the same geometry and
  land here whole (``TransportStats.set_nl_hists``);
- :class:`Counter` / :class:`Gauge`: plain slots the GIL keeps whole (a
  lost increment under contention is acceptable for a metric, a lock on
  the hot path is not);
- :class:`MetricsRegistry`: names instruments and renders them as a dict
  (the STATS reply) or as Prometheus text (``obs/http.py``). Registering
  one name twice merges at render time, so several ``TransportStats`` in
  one process sum into one series.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "state_sub", "state_add"]

_NAME_OK = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _sanitize(name: str) -> str:
    return "".join(c if c in _NAME_OK else "_" for c in name)


class Counter:
    """Monotonic event count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _sanitize(name)
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (lag, role-as-number, ring occupancy)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _sanitize(name)
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log2-bucket histogram with quantile estimates.

    Bucket ``k`` (k >= 1) covers ``(lo * 2^((k-1)/SUB), lo * 2^(k/SUB)]``;
    bucket 0 is the underflow bin (< ``lo``), the last bucket overflow
    (> ``hi``). Quantiles interpolate geometrically inside the crossing
    bucket, so the estimate is within one sub-bucket ratio (2^(1/4) ≈
    1.19x) of the true sample quantile (``tests/test_torch_obs.py`` holds
    it to that against numpy). ``record`` is a handful of bytecodes and never
    takes a lock; racing increments can lose a count, never corrupt.
    """

    kind = "histogram"
    SUB = 4  # sub-buckets per octave: resolution 2^(1/4)

    def __init__(self, name: str, help: str = "", lo: float = 1e-6,
                 hi: float = 3600.0):
        self.name = _sanitize(name)
        self.help = help
        self.lo = float(lo)
        self.hi = float(hi)
        self._nb = int(math.ceil(math.log2(hi / lo) * self.SUB))
        # [underflow] [1 .. _nb geometric] [overflow]
        self.counts = [0] * (self._nb + 2)
        self.total = 0
        self.sum = 0.0
        self.vmax = 0.0
        self.vmin = math.inf

    def record(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        if v > self.vmax:
            self.vmax = v
        if v < self.vmin:
            self.vmin = v
        if v < self.lo:
            self.counts[0] += 1
            return
        k = int(math.log2(v / self.lo) * self.SUB) + 1
        if k > self._nb:
            k = self._nb + 1
        self.counts[k] += 1

    def _upper(self, k: int) -> float:
        """Upper bound of bucket k (inf for the overflow bucket)."""
        if k <= 0:
            return self.lo
        if k > self._nb:
            return math.inf
        return self.lo * 2.0 ** (k / self.SUB)

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile of everything recorded (0 when empty)."""
        counts = list(self.counts)  # one snapshot; racing records tolerated
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for k, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if k == 0:
                    return min(self.lo, self.vmax)
                if k > self._nb:
                    return self.vmax
                lo_k = self.lo * 2.0 ** ((k - 1) / self.SUB)
                hi_k = self.lo * 2.0 ** (k / self.SUB)
                frac = (rank - cum) / c
                est = lo_k * (hi_k / lo_k) ** frac
                # never report outside the observed range
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def summary(self) -> Optional[dict]:
        """``{count, mean, p50, p99, p999, max}`` — None when empty (so
        STATS frames and StepLogger lines skip silent instruments)."""
        if self.total == 0:
            return None
        return {
            "count": self.total,
            "mean": round(self.sum / self.total, 6),
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
            "p999": round(self.quantile(0.999), 6),
            "max": round(self.vmax, 6),
        }

    def buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs — the Prometheus shape."""
        out = []
        cum = 0
        for k, c in enumerate(self.counts):
            cum += c
            out.append((self._upper(k), cum))
        return out

    # -- raw-state export (the fleet-telemetry wire form) ----------------------
    #
    # Raw log2 buckets are LOSSLESSLY mergeable: summing two histograms'
    # count arrays (same geometry) is exactly the histogram of the union
    # of their samples, so a coordinator that merges members' raw states
    # computes TRUE fleet quantiles — never the average of per-member
    # percentiles, which has no statistical meaning at the tail.

    def state(self) -> dict:
        """Json-ready cumulative state: geometry + raw bucket counts +
        the moment sums the quantile clamp needs. ``mn`` is None while
        empty (math.inf does not survive json)."""
        return {
            "lo": self.lo, "hi": self.hi, "c": list(self.counts),
            "n": self.total, "s": self.sum, "mx": self.vmax,
            "mn": None if math.isinf(self.vmin) else self.vmin,
        }

    @classmethod
    def from_state(cls, name: str, st: dict) -> "Histogram":
        """Rebuild a histogram from :meth:`state` (or a merged/delta state
        of the same geometry) so quantile/summary logic never forks."""
        h = cls(name, lo=float(st["lo"]), hi=float(st["hi"]))
        counts = list(st["c"])
        if len(counts) != len(h.counts):
            raise ValueError(
                f"histogram state for {name!r} carries {len(counts)} "
                f"buckets but geometry lo={st['lo']} hi={st['hi']} "
                f"implies {len(h.counts)} — mixed geometries don't merge")
        h.counts = counts
        h.total = int(st["n"])
        h.sum = float(st["s"])
        h.vmax = float(st.get("mx", 0.0))
        mn = st.get("mn")
        h.vmin = math.inf if mn is None else float(mn)
        return h


def _check_geometry(a: dict, b: dict) -> None:
    if (a["lo"], a["hi"]) != (b["lo"], b["hi"]) \
            or len(a["c"]) != len(b["c"]):
        raise ValueError(
            f"histogram states have differing geometries "
            f"({a['lo']}/{a['hi']} vs {b['lo']}/{b['hi']}) — "
            f"raw-bucket merge would misbucket")


def state_sub(now: dict, base: dict) -> dict:
    """``now − base`` for two cumulative histogram states of the same
    instrument: the raw-bucket delta of a time window. ``mx``/``mn`` stay
    the cumulative observed range (the window's own extrema are unknowable
    from cumulative counts) — quantile clamps are merely a hair looser."""
    _check_geometry(now, base)
    return {
        "lo": now["lo"], "hi": now["hi"],
        "c": [a - b for a, b in zip(now["c"], base["c"])],
        "n": now["n"] - base["n"], "s": now["s"] - base["s"],
        "mx": now["mx"], "mn": now["mn"],
    }


def state_add(a: Optional[dict], b: dict) -> dict:
    """Merge two raw histogram states (summed buckets — the lossless
    cross-member merge fleet quantiles are computed from). ``a`` may be
    None (the fold's seed)."""
    if a is None:
        return {"lo": b["lo"], "hi": b["hi"], "c": list(b["c"]),
                "n": b["n"], "s": b["s"], "mx": b["mx"], "mn": b["mn"]}
    _check_geometry(a, b)
    mn = [x for x in (a.get("mn"), b.get("mn")) if x is not None]
    return {
        "lo": a["lo"], "hi": a["hi"],
        "c": [x + y for x, y in zip(a["c"], b["c"])],
        "n": a["n"] + b["n"], "s": a["s"] + b["s"],
        "mx": max(a["mx"], b["mx"]), "mn": min(mn) if mn else None,
    }


class MetricsRegistry:
    """Name → instruments, rendered as Prometheus text or a dict snapshot.

    Thread-safe for registration; rendering reads live counters (racing
    updates show up in the next scrape). Instruments are held by WEAK
    reference: the owner (a ``TransportStats``, a service) keeps its
    instruments alive, and when it is garbage-collected its series drop
    out of the next render — a long-lived process that churns workers
    (elastic relaunch loops, notebooks) never accumulates dead
    instruments or serves hours-old samples in its merged totals."""

    def __init__(self):
        import weakref

        self._weakref = weakref
        self._lock = threading.Lock()
        self._by_name: "Dict[str, List]" = {}  # name -> [weakref.ref]
        self._order: List[str] = []
        # extra Prometheus text appended at render time (the coordinator's
        # fleet-labeled series, item 6.2). Held weakly:
        # a garbage-collected owner's series drop out of the next scrape.
        self._exporters: List = []  # weakref.WeakMethod / weakref.ref

    def register(self, inst) -> None:
        with self._lock:
            if inst.name not in self._by_name:
                self._by_name[inst.name] = []
                self._order.append(inst.name)
            self._by_name[inst.name].append(self._weakref.ref(inst))

    def counter(self, name: str, help: str = "") -> Counter:
        c = Counter(name, help)
        self.register(c)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = Gauge(name, help)
        self.register(g)
        return g

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        h = Histogram(name, help, **kw)
        self.register(h)
        return h

    def _merged(self):
        """(name, kind, help, instruments) per name, registration order —
        live instruments only (dead weakrefs are pruned here). Same-name
        instruments must agree on kind; a mismatch is a programming error
        surfaced loudly at render time."""
        with self._lock:
            items = []
            for n in self._order:
                refs = self._by_name[n]
                live = []
                for r in refs:
                    inst = r()
                    if inst is not None:
                        live.append(inst)
                if len(live) != len(refs):
                    self._by_name[n] = [self._weakref.ref(i) for i in live]
                if live:
                    items.append((n, live))
        out = []
        for name, insts in items:
            kinds = {i.kind for i in insts}
            if len(kinds) != 1:
                raise TypeError(
                    f"metric {name!r} registered as {sorted(kinds)} — "
                    f"one name, one kind")
            out.append((name, insts[0].kind, insts[0].help, insts))
        return out

    def snapshot(self) -> dict:
        """Dict form for the STATS frame / ``ps_top --once`` JSON."""
        out: dict = {}
        for name, kind, _, insts in self._merged():
            if kind == "counter":
                out[name] = sum(i.value for i in insts)
            elif kind == "gauge":
                out[name] = insts[-1].value  # last registration wins
            else:
                merged = _merge_hists(insts)
                s = merged.summary()
                if s is not None:
                    out[name] = s
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        for name, kind, help_, insts in self._merged():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            if kind == "counter":
                lines.append(f"{name} {sum(i.value for i in insts)}")
            elif kind == "gauge":
                lines.append(f"{name} {_fmt(insts[-1].value)}")
            else:
                h = _merge_hists(insts)
                for ub, cum in h.buckets():
                    le = "+Inf" if math.isinf(ub) else _fmt(ub)
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {_fmt(h.sum)}")
                lines.append(f"{name}_count {h.total}")
        for text in self._render_exporters():
            if text:
                lines.append(text.rstrip("\n"))
        return "\n".join(lines) + "\n"

    def add_exporter(self, fn) -> None:
        """Register a callable returning extra Prometheus text lines,
        appended after the registry's own series on every render. Bound
        methods are held via WeakMethod so a dead owner's series vanish;
        :meth:`remove_exporter` drops one deterministically."""
        ref = (self._weakref.WeakMethod(fn)
               if hasattr(fn, "__self__") else self._weakref.ref(fn))
        with self._lock:
            self._exporters.append(ref)

    def remove_exporter(self, fn) -> None:
        with self._lock:
            self._exporters = [r for r in self._exporters
                               if r() is not None and r() != fn
                               and r() is not fn]

    def _render_exporters(self) -> List[str]:
        with self._lock:
            refs = list(self._exporters)
        out, live = [], []
        for r in refs:
            fn = r()
            if fn is None:
                continue
            live.append(r)
            try:
                out.append(fn())
            except Exception as e:  # one bad exporter must not 500 the
                # whole scrape: the failure shows up as a comment line
                out.append(f"# exporter error: {e!r}")
        if len(live) != len(refs):
            with self._lock:
                self._exporters = [r for r in self._exporters
                                   if r() is not None]
        return out


def _fmt(v: float) -> str:
    return repr(float(v))


def _merge_hists(insts: List[Histogram]) -> Histogram:
    """Sum several same-name histograms into one (identical geometry is
    enforced by name-keyed construction paths; differing geometries merge
    by value re-record of bounds, which we refuse instead)."""
    first = insts[0]
    if len(insts) == 1:
        return first
    out = Histogram(first.name, first.help, lo=first.lo, hi=first.hi)
    for h in insts:
        if (h.lo, h.hi) != (first.lo, first.hi):
            raise ValueError(
                f"histogram {first.name!r} registered with differing "
                f"bounds — merge would misbucket")
        for k, c in enumerate(h.counts):
            out.counts[k] += c
        out.total += h.total
        out.sum += h.sum
        out.vmax = max(out.vmax, h.vmax)
        out.vmin = min(out.vmin, h.vmin)
    return out


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The per-process registry the /metrics endpoint serves and every
    TransportStats registers its histograms into."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry()
    return _default
