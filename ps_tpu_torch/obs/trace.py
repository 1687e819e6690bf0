"""Distributed tracing of the van plane.

Counterpart of ``ps_tpu/obs/trace.py``, the same code and the same wire:
a :class:`TraceContext` ``(trace_id, span_id)`` travels in a frame's
``extra`` under ``"tc"`` (:data:`WIRE_KEY`) as ``[trace_id, span_id]``,
so each hop (the worker's op, the primary's serve span and its apply,
the backup's serve span) parents its span to the hop before it, across
processes and across the two packages. An untraced frame carries no
``tc`` and its bytes are the reference's.

Spans land in a bounded ring a process; :meth:`Tracer.export_chrome`
writes Chrome trace events (Perfetto opens them) shifted by
``clock_offset_us`` (estimated by :class:`~ps_tpu_torch.obs.clock.
ClockSync`), and :func:`merge_chrome` concatenates several processes'
exports into one timeline. A span reads the host's clocks only and never
synchronizes the card: a span that ends after a blocking point (the
server's apply, which copies its reply off the card) ends there.

Sampling is decided once, at the root span (the worker's op):
``trace_sample`` (``PS_TRACE_SAMPLE``, default 0) gates roots, and every
later hop follows the header, so an unsampled op costs one dict lookup a
hop.

The same tracer times the fused training step in one process (category
``"step"``): the root ``step`` *holds* its context on the tracer while
it is open (``span(..., hold=True)``), so a span on a thread with no
open span of its own, autograd's device thread running a backward,
parents to it (``child(..., held=True)``). A sampled span on the card
records a CUDA event at its entry and its exit (:meth:`Span.time_device`),
never synchronized inside the step; :meth:`Tracer.resolve_device` turns
the pairs the card has passed into ``device_ms`` once the caller has
synchronized. Stamps are ``time.time()``, the wall clock the profiler's
host and device events are stamped on, so the spans and a
``torch.profiler`` trace share one timeline with no offset.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

__all__ = [
    "TraceContext", "Span", "Tracer", "NOOP", "WIRE_KEY",
    "merge_chrome",
]

#: the van-frame ``extra`` key a propagated context rides under:
#: ``extra["tc"] == [trace_id, parent_span_id]``
WIRE_KEY = "tc"


class TraceContext(NamedTuple):
    """What a hop needs to parent its span to the hop before it."""

    trace_id: str
    span_id: str


def from_wire(extra: Optional[dict]) -> Optional[TraceContext]:
    """The propagated context of a received frame, or None (unsampled)."""
    tc = (extra or {}).get(WIRE_KEY)
    if not tc:
        return None
    try:
        return TraceContext(str(tc[0]), str(tc[1]))
    except (IndexError, TypeError):
        return None


class _NoopSpan:
    """The unsampled span: every method a real span has, all free.

    A singleton, so ``tracer.span(...)`` on the off path allocates
    nothing and the call sites need no ``if sampled`` branches."""

    __slots__ = ()

    def ctx(self) -> Optional[TraceContext]:
        return None

    def wire(self) -> Optional[list]:
        return None

    def set(self, **args) -> "_NoopSpan":
        return self

    def time_device(self, device) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False


NOOP = _NoopSpan()


class Span:
    """One timed unit of work, parented into a trace.

    Use as a context manager; the span records its start and its end on
    the wall clock (``time.time()`` µs, which a clock offset aligns
    across processes) and lands in its tracer's ring on exit. One clock
    for both ends: the reference times the duration on the monotonic
    clock, so a process descheduled between its two reads at the start
    shifts the span's end off its true place; here an interval is the
    one clock's, whatever the scheduler does (a step of the wall clock
    inside a span clamps its duration at zero).

    A span made with ``hold=True`` holds its context on the tracer while
    it is open (:attr:`Tracer.held`)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "args", "ts_us", "dur_us", "_t0", "_tracer", "_tid",
                 "_hold", "_outer", "_events")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: str, span_id: str, parent_id: Optional[str],
                 hold: bool = False):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.args: dict = {}
        self.ts_us = 0.0
        self.dur_us = 0.0
        self._t0 = 0.0
        self._tracer = tracer
        self._tid = 0
        self._hold = hold
        self._outer: Optional[TraceContext] = None
        self._events = None  # [device, entry event, exit event], or None

    def ctx(self) -> TraceContext:
        """The context downstream hops parent to."""
        return TraceContext(self.trace_id, self.span_id)

    def wire(self) -> list:
        """The ``extra[WIRE_KEY]`` value that propagates this span."""
        return [self.trace_id, self.span_id]

    def set(self, **args) -> "Span":
        """Attach key=value annotations (worker id, byte counts, ...)."""
        self.args.update(args)
        return self

    def time_device(self, device) -> "Span":
        """On a CUDA ``device``: record a CUDA event on its current stream
        now and another as the span exits, so the card's time between
        them can be read after the caller synchronizes
        (:meth:`Tracer.resolve_device`). Nothing on another device."""
        if getattr(device, "type", None) == "cuda":
            self._events = [device, _record_event(device), None]
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.time()
        self.ts_us = self._t0 * 1e6
        self._tid = threading.get_ident()
        self._tracer._push_current(self)
        if self._hold:
            self._outer = self._tracer.held
            self._tracer.held = self.ctx()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if self._events is not None:  # raises after a fault on the card
                self._events[2] = _record_event(self._events[0])
        finally:
            self.dur_us = max(time.time() - self._t0, 0.0) * 1e6
            if exc_type is not None:
                self.args.setdefault("error", repr(exc))
            if self._hold:
                self._tracer.held = self._outer
            self._tracer._pop_current(self)
            self._tracer._record(self)

    def __bool__(self) -> bool:
        return True


def _new_id() -> str:
    return os.urandom(8).hex()


def _record_event(device):
    import torch

    e = torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


class Tracer:
    """Per-process span factory + bounded ring + exporter.

    ``sample`` gates ROOT spans only (a span created with an explicit
    ``parent`` context is always recorded — the root already paid for the
    trace). ``clock_offset_us`` is added to every exported timestamp so
    several processes' dumps merge onto one timeline (estimated by
    :class:`~ps_tpu_torch.obs.clock.ClockSync` against a reference server).
    ``held`` is the context of the open span made with ``hold=True`` (the
    fused step's), None when there is none: one slot a process, so it
    assumes one sampled step at a time in the process."""

    def __init__(self, service: str = "ps", capacity: int = 8192,
                 sample: float = 0.0):
        import collections

        self.service = service
        self.sample = float(sample)
        self.clock_offset_us = 0.0
        self.pid = os.getpid()
        self._ring = collections.deque(maxlen=int(capacity))
        self._tls = threading.local()
        self.dropped = 0  # roots not sampled are NOT drops; ring evictions are
        self._total = 0
        self.held: Optional[TraceContext] = None

    # -- span creation ---------------------------------------------------------

    def span(self, name: str, cat: str = "ps",
             parent: Optional[TraceContext] = None, hold: bool = False):
        """A new span: child of ``parent`` when given, else a root that is
        sampled with probability ``sample`` (NOOP otherwise). With
        ``hold`` it is :attr:`held` while open."""
        if parent is None:
            if self.sample <= 0.0:
                return NOOP
            if self.sample < 1.0:
                import random

                if random.random() >= self.sample:
                    return NOOP
            return Span(self, name, cat, _new_id(), _new_id(), None, hold)
        return Span(self, name, cat, parent.trace_id, _new_id(),
                    parent.span_id, hold)

    def child(self, name: str, cat: str = "ps", held: bool = False):
        """A span under the CURRENT thread's open span — NOOP when no
        traced work is in progress (never a fresh sampling decision, so
        internal waits can't spawn orphan root traces). With ``held``,
        under :attr:`held` instead, whatever thread calls: the fused
        step's backward spans, which autograd's device thread records."""
        cur = self.held if held else self.current()
        return self.span(name, cat, parent=cur) if cur is not None else NOOP

    def current(self) -> Optional[TraceContext]:
        """The innermost open span's context on this thread, if any."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1].ctx() if stack else None

    def _push_current(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop_current(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:  # exited out of order: still remove
            stack.remove(span)

    def _record(self, span: Span) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(span)
        self._total += 1

    def record_external(self, name: str, cat: str, trace_id: str,
                        parent_id: Optional[str], ts_us: float,
                        dur_us: float, **args) -> "Span":
        """Record a span whose timing happened OUTSIDE Python — e.g. the
        native event loop's slow-frame capture, whose per-stage stamps
        were taken with no interpreter anywhere near the work. The span
        joins the given trace (always recorded: the propagated context
        means the root already paid the sampling decision) with explicit
        wall-clock start and duration instead of the context-manager
        timing."""
        sp = Span(self, name, cat, str(trace_id), _new_id(),
                  None if parent_id is None else str(parent_id))
        sp.ts_us = float(ts_us)
        sp.dur_us = max(float(dur_us), 0.0)
        sp._tid = threading.get_ident()
        sp.args.update(args)
        self._record(sp)
        return sp

    # -- introspection / export ------------------------------------------------

    def spans(self) -> List[Span]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    @property
    def capacity(self) -> int:
        """The number of spans the ring holds."""
        return self._ring.maxlen

    def resize(self, capacity: int) -> None:
        """Hold up to ``capacity`` spans, keeping the newest; the spans
        that no longer fit count in :attr:`dropped`."""
        import collections

        capacity = int(capacity)
        self.dropped += max(len(self._ring) - capacity, 0)
        self._ring = collections.deque(self._ring, maxlen=capacity)

    def resolve_device(self) -> int:
        """Set ``args["device_ms"]`` of each span in the ring whose two
        CUDA events (:meth:`Span.time_device`) the card has passed: the
        card's time between them. Returns how many were still pending
        (call after a synchronize, when none are)."""
        pending = 0
        for s in list(self._ring):
            ev = s._events
            if ev is None or ev[2] is None:
                continue
            if not (ev[1].query() and ev[2].query()):
                pending += 1
                continue
            s.args["device_ms"] = ev[1].elapsed_time(ev[2])
            s._events = None
        return pending

    def chrome_events(self) -> List[dict]:
        """Chrome-trace ``X`` events (+ a process_name metadata record),
        timestamps shifted by ``clock_offset_us``."""
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
            "args": {"name": self.service},
        }]
        for s in self.spans():
            events.append({
                "ph": "X", "name": s.name, "cat": s.cat,
                "pid": self.pid, "tid": s._tid,
                "ts": s.ts_us + self.clock_offset_us,
                "dur": max(s.dur_us, 0.001),
                "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                         "parent_id": s.parent_id, **s.args},
            })
        return events

    def export_chrome(self, path: Optional[str] = None) -> str:
        """Write the ring as Perfetto-openable JSON; returns the path
        (default: ``<trace_dir>/trace-<service>-<pid>.json``)."""
        if path is None:
            from ps_tpu_torch.config import env_str

            base = env_str("PS_TRACE_DIR", ".")
            path = os.path.join(base, f"trace-{self.service}-{self.pid}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events()}, f)
        return path


def merge_chrome(sources, path: str) -> str:
    """Concatenate several Chrome-trace exports (file paths, event lists,
    or ``{"traceEvents": ...}`` dicts) into one file — the whole-cluster
    timeline. Each process's export should already carry its clock offset
    (applied at export time); this is a pure concatenation."""
    events: List[dict] = []
    for src in sources:
        if isinstance(src, str):
            with open(src) as f:
                src = json.load(f)
        if isinstance(src, dict):
            src = src.get("traceEvents", [])
        events.extend(src)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path
