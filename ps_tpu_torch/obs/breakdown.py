"""Where a step's time goes: the per-phase table and the span chains.

Counterpart of ``ps_tpu/obs/breakdown.py``. A worker's push is a chain:
the client's encode and split, a flush wait, the wire rounds, the
server's apply, the sync replica ack. Each link lands in a latency
histogram of the process that pays it (``utils/metrics.TransportStats``).

- :func:`breakdown` builds one table from per-metric histogram summaries
  (a registry snapshot, a STATS reply, a fleet window): per phase its
  count, mean, p99, total seconds and share of the step. Derived rows:
  ``wire`` (the bucket round less the server apply inside it) and
  ``client`` (the step less everything attributed).
- :class:`TraceBreakdown` decomposes sampled traces (a tracer's ring or
  merged Chrome events): each worker-op root against its flush-wait,
  server, server-apply, ack-wait and aggregator spans, into one
  ``ps_step_breakdown_<phase>_seconds`` histogram a phase.

Attribution is conservative: overlapped rounds can sum past the root, so
the remainder row is clamped at zero and shares are of the step total.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ps_tpu_torch.obs.metrics import Histogram

__all__ = ["PHASES", "breakdown", "TraceBreakdown"]

#: phase -> the metric names that measure it (first present wins).
#: ``total`` is the step envelope: the overlapped cycle when the
#: pipelined transport runs, else the synchronous push_pull/push op.
PHASES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("total", ("ps_cycle_seconds", "ps_push_pull_seconds",
               "ps_push_seconds", "ps_pull_seconds")),
    ("flush_wait", ("ps_blocked_seconds",)),
    ("wire_round", ("ps_bucket_seconds",)),
    ("server_apply", ("ps_server_apply_seconds",)),
    ("ack_wait", ("ps_replica_ack_wait_seconds",)),
    # two-tier aggregation (backends/aggregator.py): how long member
    # pushes sat at their host aggregator before the merged upstream
    # flush committed. Reported as its own row (share of the step total)
    # but NOT folded into the derived client/wire math — the worker's
    # wire round already contains it, like server_apply.
    ("agg_hold", ("ps_agg_hold_seconds",)),
    # the native zero-upcall serve path (README "Native observability"):
    # READ-hit service time measured INSIDE the epoll loop — the only
    # latency truth for frames no Python code ever touches. Its own row,
    # never folded into the derived math: reads are serving traffic, not
    # part of the push/pull step envelope.
    ("native_serve", ("ps_nl_read_hit_seconds",)),
)


def breakdown(summary_of: Callable[[str], Optional[dict]]) -> dict:
    """The per-phase table from per-metric histogram summaries.

    ``summary_of(metric)`` returns ``{count, mean, p50, p99, p999, max}``
    (plus optionally ``sum``) or None — e.g. ``lambda m:
    (tsdb.fleet_window(m) or {}).get("summary")`` for the fleet view.
    Returns ``{phase: {metric, count, mean_ms, p99_ms, seconds,
    share}}`` — empty when no phase metric has data."""
    out: Dict[str, dict] = {}
    for phase, metrics in PHASES:
        for m in metrics:
            s = summary_of(m)
            if s and s.get("count"):
                seconds = s.get("sum")
                if seconds is None:
                    seconds = s["mean"] * s["count"]
                out[phase] = {
                    "metric": m, "count": int(s["count"]),
                    "mean_ms": round(s["mean"] * 1e3, 3),
                    "p99_ms": round(s["p99"] * 1e3, 3),
                    "seconds": round(seconds, 4),
                }
                break
    total_s = out.get("total", {}).get("seconds")
    # derived rows: the bucket round CONTAINS the server's apply (the
    # reply waits on it), so wire = round - apply at the mean level; the
    # step total minus every attributed phase is worker-side client work
    wr, ap = out.get("wire_round"), out.get("server_apply")
    if wr:
        wire_s = wr["seconds"] - (ap["seconds"] if ap else 0.0)
        out["wire"] = {
            "metric": "derived: wire_round - server_apply",
            "count": wr["count"],
            "mean_ms": round(max(wire_s, 0.0) / wr["count"] * 1e3, 3),
            "seconds": round(max(wire_s, 0.0), 4),
        }
    if total_s:
        # the wire round already CONTAINS the server apply; without a
        # bucketed transport (no wire_round metric) the apply itself is
        # the attributable server time inside the op envelope
        inner = ("flush_wait", "ack_wait",
                 "wire_round" if "wire_round" in out else "server_apply")
        attributed = sum(out[p]["seconds"] for p in inner if p in out)
        out["client"] = {
            "metric": "derived: total - attributed phases",
            "count": out["total"]["count"],
            "seconds": round(max(total_s - attributed, 0.0), 4),
        }
        for phase, row in out.items():
            if phase != "total":
                row["share"] = round(
                    min(row["seconds"] / total_s, 1.0), 4)
    return out


def _normalize(span) -> Optional[dict]:
    """One span as ``{name, cat, trace_id, parent, dur_us}`` from either
    a live :class:`~ps_tpu_torch.obs.trace.Span` or a Chrome trace event."""
    if isinstance(span, dict):
        if span.get("ph") != "X":
            return None
        args = span.get("args") or {}
        return {"name": span.get("name"), "cat": span.get("cat"),
                "trace_id": args.get("trace_id"),
                "parent": args.get("parent_id"),
                "dur_us": float(span.get("dur", 0.0))}
    return {"name": span.name, "cat": span.cat,
            "trace_id": span.trace_id, "parent": span.parent_id,
            "dur_us": float(span.dur_us)}


class TraceBreakdown:
    """Span-chain decomposition into a per-phase histogram family.

    Feed spans from any mix of processes (the cross-process chain rides
    the ``tc`` wire header, so a worker op and ITS server spans share a
    trace_id); each complete trace records one sample per phase into
    ``ps_step_breakdown_<phase>_seconds`` histograms — quantiles of the
    per-STEP phase costs, not of individual waits."""

    #: phases a trace is decomposed into (server = all cat="server"
    #: dispatch spans; agg = cat="aggregator" merge spans — the two-tier
    #: hop's own work inside a worker→aggregator→shard chain; wire = root
    #: minus server minus flush_wait, clamped — overlapped pump rounds
    #: can exceed the envelope)
    TRACE_PHASES = ("total", "flush_wait", "server", "server_apply",
                    "ack_wait", "agg", "wire")

    def __init__(self):
        self.hist: Dict[str, Histogram] = {
            p: Histogram(f"ps_step_breakdown_{p}_seconds",
                         f"per-step critical path: {p}")
            for p in self.TRACE_PHASES
        }
        self.steps = 0

    def feed(self, spans: Iterable) -> int:
        """Decompose every complete trace in ``spans``; returns how many
        steps (worker-op roots) were recorded."""
        by_trace: Dict[str, List[dict]] = {}
        for s in spans:
            n = _normalize(s)
            if n and n.get("trace_id"):
                by_trace.setdefault(n["trace_id"], []).append(n)
        fed = 0
        for tid, ss in by_trace.items():
            roots = [s for s in ss
                     if s["parent"] is None and s["cat"] == "worker"]
            if not roots:
                continue
            total = sum(s["dur_us"] for s in roots) / 1e6
            phase_s = {
                "flush_wait": sum(s["dur_us"] for s in ss
                                  if s["name"] == "flush_wait") / 1e6,
                "server": sum(s["dur_us"] for s in ss
                              if s["cat"] == "server"
                              and s["name"] not in ("server_apply",
                                                    "replica_ack_wait")
                              ) / 1e6,
                "server_apply": sum(s["dur_us"] for s in ss
                                    if s["name"] == "server_apply") / 1e6,
                "ack_wait": sum(s["dur_us"] for s in ss
                                if s["name"] == "replica_ack_wait") / 1e6,
                "agg": sum(s["dur_us"] for s in ss
                           if s["cat"] == "aggregator") / 1e6,
            }
            phase_s["wire"] = max(
                total - phase_s["server"] - phase_s["flush_wait"], 0.0)
            self.hist["total"].record(total)
            for p, v in phase_s.items():
                self.hist[p].record(v)
            fed += 1
        self.steps += fed
        return fed

    def summary(self) -> dict:
        """``{phase: histogram summary + share}`` (share of total sum)."""
        total = self.hist["total"].sum
        out = {}
        for p, h in self.hist.items():
            s = h.summary()
            if s is None:
                continue
            if p != "total" and total > 0:
                s["share"] = round(min(h.sum / total, 1.0), 4)
            out[p] = s
        return out
