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
- **Fleet telemetry** (:mod:`~ps_tpu_torch.obs.collector`,
  :mod:`~ps_tpu_torch.obs.tsdb`): members send delta-encoded snapshots
  (raw log2 buckets, which merge without loss) with their coordinator
  reports; the coordinator's :class:`FleetTSDB` answers the fleet's
  window quantiles and breakdown (``COORD_TELEMETRY``, ``ps_top
  --fleet``, ``ps_doctor``) and feeds the straggler and SLO signals.
- **Analysis**: the per-phase :func:`breakdown` and
  :class:`TraceBreakdown`, :class:`StragglerDetector` and
  :class:`SloEvaluator` over the coordinator's :class:`FleetTSDB`, or
  over a :class:`RegistryWindow` in a process without a coordinator.
- ``freshness`` (birth stamps and data ages) and ``clock`` (cross-process
  clock offsets).
- **Step spans**: the same tracer times the fused training step of
  ``KVStore.make_step`` on the cuda backend, category ``"step"``: the
  root ``step`` (sampled by ``trace_sample``), its ``forward`` and
  ``backward`` (``value_and_grad``), and ``apply`` (``CudaServer``'s
  server apply) with ``apply.reduce``, ``apply.optimizer`` and
  ``apply.gather``; ``embed_bwd`` (BERT's embedding backward) and
  ``flash_bwd`` (the flash-attention backward) run on autograd's device
  thread and parent to ``step`` through the tracer's held context. On
  the card ``step`` and ``apply`` also carry ``device_ms`` between CUDA
  events (:meth:`Tracer.resolve_device`, after a synchronize). Spans are
  stamped on the wall clock that ``torch.profiler`` stamps its events
  on, so ``utils/profiling.trace`` (the trainers' ``--profile-dir``)
  turns them on for its traced block and writes them into its
  ``trace.json`` beside the kernels: Perfetto shows forward, backward
  and apply over the device's rows. ``configure(capacity=n)`` sizes the
  ring (a window of n spans: ~22 a BERT step); ``tracer().dropped``
  counts what it lost.

This module owns the process singletons: :func:`tracer` and
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
from ps_tpu_torch.obs.collector import (
    DeltaDecoder,
    DeltaEncoder,
    collect_telemetry,
)
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
from ps_tpu_torch.obs.tsdb import FleetTSDB
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
    "FleetTSDB", "DeltaEncoder", "DeltaDecoder", "collect_telemetry",
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
              service: Optional[str] = None,
              capacity: Optional[int] = None) -> None:
    """Override the env-seeded defaults (what a launcher does with its
    :class:`~ps_tpu_torch.config.Config` knobs). Only the arguments given
    change; ``metrics_port`` starts the /metrics endpoint at once;
    ``capacity`` is the number of spans the tracer's ring holds."""
    t = tracer()
    f = flight()
    if sample is not None:
        t.sample = float(sample)
    if capacity is not None:
        t.resize(capacity)
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
