"""Observability of the van plane: counterpart of ``ps_tpu/obs/``.

- **Tracing** (:mod:`~ps_tpu_torch.obs.trace`): a ``TraceContext`` in a
  frame's ``extra`` (``"tc"``) follows one worker push from the worker's
  op through the primary's serve span and apply to the backup's serve
  span; spans land in a bounded ring a process and export as Chrome trace
  JSON, merged across processes after :class:`ClockSync` offsets. Off by
  default (``trace_sample`` / ``PS_TRACE_SAMPLE`` = 0): the unsampled
  path is a no-op singleton and one dict lookup a hop.
- **Metrics** (:mod:`~ps_tpu_torch.obs.metrics`): counters, gauges and
  log2-bucket latency histograms that ``TransportStats`` feeds; read by
  the STATS reply (``tools/ps_top.py``) and served as Prometheus text on
  the opt-in ``/metrics`` endpoint (``metrics_port`` /
  ``PS_METRICS_PORT``).
- **Flight recorder** (:mod:`~ps_tpu_torch.obs.flight`): a bounded ring
  of typed events dumped as JSONL on an unhandled ``VanError``, on
  ``SIGUSR2`` or on demand.
- **Analysis** without a coordinator: the per-phase :func:`breakdown`
  and :class:`TraceBreakdown`, :class:`StragglerDetector` and
  :class:`SloEvaluator` over a :class:`RegistryWindow`.
- ``freshness`` (birth stamps and data ages) and ``clock`` (cross-process
  clock offsets).

The reference's fleet telemetry (``collector``, ``tsdb``) is ROADMAP item
6.2. This module owns the process singletons: :func:`tracer` and
:func:`flight` configure themselves from the environment on first use,
and :func:`configure` overrides them (what ``Config.apply_obs`` does).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ps_tpu_torch.obs import clock, freshness  # noqa: F401
from ps_tpu_torch.obs import trace as trace  # noqa: F401
from ps_tpu_torch.obs.breakdown import PHASES, TraceBreakdown, breakdown
from ps_tpu_torch.obs.clock import ClockSync
from ps_tpu_torch.obs.flight import FlightRecorder
from ps_tpu_torch.obs.http import (
    MetricsServer,
    start_metrics_server,
    stop_metrics_server,
)
from ps_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from ps_tpu_torch.obs.slo import (
    RegistryWindow,
    SloEvaluator,
    SloRule,
    parse_rules,
)
from ps_tpu_torch.obs.straggler import StragglerDetector
from ps_tpu_torch.obs.trace import (
    NOOP,
    WIRE_KEY,
    Span,
    TraceContext,
    Tracer,
    from_wire,
    merge_chrome,
)

__all__ = [
    "TraceContext", "Tracer", "Span", "NOOP", "WIRE_KEY", "from_wire",
    "merge_chrome", "tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "MetricsServer", "start_metrics_server", "stop_metrics_server",
    "FlightRecorder", "flight", "record_event",
    "ClockSync", "configure", "clock", "freshness",
    "StragglerDetector", "SloEvaluator", "SloRule", "parse_rules",
    "RegistryWindow", "breakdown", "TraceBreakdown", "PHASES",
]

_lock = threading.Lock()
_tracer: Optional[Tracer] = None
_flight: Optional[FlightRecorder] = None


def tracer() -> Tracer:
    """The process tracer (made on first use; ``PS_TRACE_SAMPLE`` seeds
    its sample rate, 0 = off)."""
    global _tracer
    if _tracer is None:
        with _lock:
            if _tracer is None:
                from ps_tpu_torch.config import env_float

                # strict=False: a malformed PS_TRACE_SAMPLE must never take
                # a service down with its observability
                sample = env_float("PS_TRACE_SAMPLE", 0.0, lo=0.0,
                                   hi=1.0, strict=False)
                _tracer = Tracer(service=f"pid{os.getpid()}", sample=sample)
    return _tracer


def flight() -> FlightRecorder:
    """The process flight recorder (made on first use with its dump hooks
    armed; ``PS_FLIGHT_EVENTS`` sizes the ring)."""
    global _flight
    if _flight is None:
        with _lock:
            if _flight is None:
                from ps_tpu_torch.config import env_int

                cap = env_int("PS_FLIGHT_EVENTS", 4096, lo=1, strict=False)
                fr = FlightRecorder(capacity=cap,
                                    service=f"pid{os.getpid()}")
                fr.install()
                _flight = fr
    return _flight


def record_event(kind: str, **fields) -> None:
    """Record one typed event into the process flight recorder: the call
    every fault-path site makes (never raises)."""
    flight().record(kind, **fields)


def configure(sample: Optional[float] = None,
              trace_dir: Optional[str] = None,
              flight_events: Optional[int] = None,
              metrics_port: Optional[int] = None,
              service: Optional[str] = None) -> None:
    """Override the env-seeded defaults (what a launcher does with its
    :class:`~ps_tpu_torch.config.Config` knobs). Only the arguments given
    change; ``metrics_port`` starts the /metrics endpoint at once."""
    t = tracer()
    f = flight()
    if sample is not None:
        t.sample = float(sample)
    if service is not None:
        t.service = service
        f.service = service
    if trace_dir is not None:
        os.environ["PS_TRACE_DIR"] = trace_dir
        f.dir = trace_dir
    if flight_events is not None:
        import collections

        with f._lock:
            f.capacity = int(flight_events)
            f._ring = collections.deque(f._ring, maxlen=f.capacity)
    if metrics_port is not None:
        start_metrics_server(metrics_port)
