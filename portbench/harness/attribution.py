"""The traced window's device work attributed to the program's own spans.

With its step spans on (``ps_tpu_torch.obs``, category ``"step"``), the
program stamps ``step`` and, inside it, ``forward``, ``backward``,
``apply`` (with ``apply.reduce``, ``apply.optimizer``, ``apply.gather``),
``embed_bwd`` and ``flash_bwd`` (these two on autograd's device thread,
parented to ``step``) on the wall clock, ``time.time()``. The profiler
stamps its events on that clock too, so no offset is applied.

From the profiler this module keeps what :func:`trace.read` does not:
each device event's correlation id, the runtime calls that launch work
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``, by the same id), and the runtime calls that make the
host wait for the card (``trace._WAITS``) with their host start. A kernel
is attributed to the innermost program span that holds its launch's host
start: the latest-starting one, across threads, so a launch from
autograd's thread inside ``flash_bwd`` goes to ``flash_bwd``, not to
``backward``. A launch in no span goes to ``outside``; a kernel whose
launch the trace lacks, to ``unlaunched``.

The readings a traced run takes from this (each None where the program
recorded no step span, or its tracer dropped spans):

- ``apply_host_ms``: the median step's ``apply`` span, host time;
- ``fwd_bwd_host_ms``: the median step's ``forward`` + ``backward``;
- ``apply_launches_per_step``: kernels attributed to ``apply`` or its
  children, over the window's steps;
- ``host_waits_per_step``: host waits whose start lies in a ``step``,
  over the window's steps.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import statistics
from typing import Dict, List, Optional, Tuple

from portbench.harness import trace as tracing

CATEGORY = "step"
OUTSIDE = "outside"
UNLAUNCHED = "unlaunched"
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
             "cudaMemsetAsync")


@dataclasses.dataclass
class ProgramSpan:
    name: str
    span_id: str
    parent_id: Optional[str]
    start: int                  # ns, wall clock
    end: int
    device_ms: Optional[float] = None


@dataclasses.dataclass
class Launch:
    start: int                  # ns, the host's call
    thread: int                 # the profiler's thread id
    call: str                   # the runtime call
    end: int = 0


@dataclasses.dataclass
class DeviceEvents:
    """What the profiler recorded beyond :class:`trace.Timeline`, inside
    the window: kernels with their correlation ids, launches by id, and
    the host's waits for the card."""

    kernels: List[Tuple[int, int, str, int]]   # device start, end, name, id
    launches: Dict[int, Launch]
    waits: List[Launch]


def program_spans(tracer) -> Tuple[List[ProgramSpan], int]:
    """The tracer's step spans (their device times resolved by the caller)
    and the number of spans its ring dropped."""
    out = []
    for s in tracer.spans():
        if s.cat != CATEGORY:
            continue
        start = int(s.ts_us * 1000)
        out.append(ProgramSpan(s.name, s.span_id, s.parent_id, start,
                               start + int(s.dur_us * 1000),
                               s.args.get("device_ms")))
    return out, tracer.dropped


def read_device(prof, window: Tuple[int, int]) -> DeviceEvents:
    """The profiler's (stopped) events: kernels inside ``window`` as
    :meth:`trace.Timeline.kernels` counts them, with correlation ids; the
    launches; the waits that began inside ``window``."""
    from torch.autograd import DeviceType

    w0, w1 = window
    kernels, launches, waits = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            activity = getattr(e, "activity_type", None)
            if activity is not None and \
                    activity() not in tracing._DEVICE_ACTIVITIES:
                continue
            s, t = tracing._ns(e, "start"), tracing._ns(e, "end")
            if t > w0 and s < w1 and not name.startswith(tracing._COPIES):
                kernels.append((s, t, name, _correlation(e)))
        elif name.startswith(_LAUNCHES):
            launches[_correlation(e)] = Launch(
                tracing._ns(e, "start"), e.start_thread_id(), name,
                tracing._ns(e, "end"))
        elif name in tracing._WAITS:
            t = tracing._ns(e, "start")
            if w0 <= t < w1:
                waits.append(Launch(t, e.start_thread_id(), name))
    return DeviceEvents(sorted(kernels), launches, sorted(
        waits, key=lambda w: w.start))


def _correlation(e) -> int:
    return int(e.correlation_id())


class Attribution:
    """The innermost program span of any host time, and the device work
    and waits by that span."""

    def __init__(self, spans: List[ProgramSpan], window: Tuple[int, int],
                 device: DeviceEvents):
        w0, w1 = window
        self.window = window
        self.device = device
        self.spans = sorted(spans, key=lambda s: s.start)
        self.steps = [s for s in self.spans if s.name == "step"
                      and s.parent_id is None and s.start < w1
                      and s.end > w0]
        self._step_starts = [s.start for s in self.steps]
        self._starts = [s.start for s in self.spans]
        self._by_id = {s.span_id: s for s in self.spans}

    def step_of(self, t: int) -> Optional[ProgramSpan]:
        i = bisect.bisect_right(self._step_starts, t) - 1
        if i >= 0 and t < self.steps[i].end:
            return self.steps[i]
        return None

    def innermost(self, t: int) -> Optional[ProgramSpan]:
        """The latest-starting span, on any thread, that holds ``t``
        (looking no further back than the step that holds it)."""
        step = self.step_of(t)
        if step is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.spans[i].start >= step.start:
            s = self.spans[i]
            if s.start <= t < s.end:
                return s
            i -= 1
        return step

    def within(self, span: ProgramSpan, name: str) -> bool:
        """Whether ``span`` is ``name`` or lies under a span so named."""
        while span is not None:
            if span.name == name:
                return True
            span = self._by_id.get(span.parent_id)
        return False

    def name_at(self, t: int) -> str:
        s = self.innermost(t)
        return s.name if s is not None else OUTSIDE

    @functools.cached_property
    def kernels(self) -> List[tuple]:
        """Each kernel with its launch and innermost span (None outside
        every span); the launch is None where the trace lacks it."""
        out = []
        for k in self.device.kernels:
            launch = self.device.launches.get(k[3])
            span = None if launch is None else self.innermost(launch.start)
            out.append((k, launch, span))
        return out

    def table(self, idle_gaps: List[Tuple[int, int]]) -> Dict[str, dict]:
        """By span name, a step: host ms (the spans' summed durations),
        kernels launched and host waits while it was innermost, and the
        idle seconds (over the window) of the gaps that began then."""
        n = max(len(self.steps), 1)
        rows: Dict[str, dict] = collections.defaultdict(
            lambda: {"host_ms": 0.0, "kernels": 0.0, "waits": 0.0,
                     "idle_s": 0.0})
        for s in self.spans:
            if self.step_of(s.start) is not None:
                rows[s.name]["host_ms"] += (s.end - s.start) / 1e6 / n
        for _, launch, span in self.kernels:
            name = UNLAUNCHED if launch is None else (
                span.name if span is not None else OUTSIDE)
            rows[name]["kernels"] += 1 / n
        for w in self.device.waits:
            rows[self.name_at(w.start)]["waits"] += 1 / n
        for s, e in idle_gaps:
            rows[self.name_at(s)]["idle_s"] += (e - s) / 1e9
        return dict(rows)

    def waits_named(self) -> Dict[str, float]:
        """Host waits a step by innermost span and call, with the call that
        came before the wait on its thread and the last kernel launched
        there (what it waits for)."""
        device = self.device
        by_thread: Dict[int, list] = collections.defaultdict(list)
        names = {}
        for k in device.kernels:
            names[k[3]] = tracing.short_name(k[2], 60)
        for corr, launch in device.launches.items():
            by_thread[launch.thread].append((launch.start, corr, launch))
        for v in by_thread.values():
            v.sort(key=lambda x: x[0])
        n = max(len(self.steps), 1)
        out: Dict[str, float] = collections.Counter()
        for w in device.waits:
            mine = by_thread.get(w.thread, [])
            i = bisect.bisect_left(mine, (w.start,)) - 1
            j = i
            while j >= 0 and mine[j][1] not in names:
                j -= 1
            call = mine[i][2].call if i >= 0 else "nothing"
            kernel = names[mine[j][1]] if j >= 0 else "none"
            out[f"{self.name_at(w.start)}: {w.call} after {call}, last "
                f"kernel {kernel}"] += 1 / n
        return dict(out)

    def checks(self, n_kernels: int) -> dict:
        """That every kernel is counted once, and the order of the clocks
        (no offset applied): each kernel starts on the card no earlier
        than its launch (the count and the largest violation in µs), and
        each step's launches lie inside it: the least margin, in µs,
        between a step's start and its first launch and between its last
        launch and its end."""
        pairs = self.kernels
        late_device = [(launch.start - k[0]) / 1e3 for k, launch, span in
                       pairs if launch is not None and k[0] < launch.start]
        first: Dict[str, int] = {}
        last: Dict[str, int] = {}
        for _, launch, _ in pairs:
            step = None if launch is None else self.step_of(launch.start)
            if step is not None:
                first[step.span_id] = min(first.get(step.span_id, launch.start),
                                          launch.start)
                last[step.span_id] = max(last.get(step.span_id, 0),
                                         launch.start)
        steps = {s.span_id: s for s in self.steps}
        attributed = sum(1 for _, launch, span in pairs if span is not None)
        return {"kernels": len(pairs), "trace_kernels": n_kernels,
                "attributed": attributed,
                "outside": sum(1 for _, launch, span in pairs
                               if launch is not None and span is None),
                "unlaunched": sum(1 for _, launch, _ in pairs
                                  if launch is None),
                "device_before_launch": len(late_device),
                "device_before_launch_max_us": max(late_device, default=0.0),
                "step_to_first_launch_us": min(
                    ((t - steps[k].start) / 1e3 for k, t in first.items()),
                    default=None),
                "last_launch_to_step_end_us": min(
                    ((steps[k].end - t) / 1e3 for k, t in last.items()),
                    default=None)}


def _step_children(att: Attribution, name: str) -> Dict[str, List[int]]:
    """Each step's spans called ``name`` (its children, on any thread)."""
    out: Dict[str, List[int]] = collections.defaultdict(list)
    steps = {s.span_id for s in att.steps}
    for s in att.spans:
        if s.name == name:
            parent = att._by_id.get(s.parent_id)
            while parent is not None and parent.span_id not in steps:
                parent = att._by_id.get(parent.parent_id)
            if parent is not None:
                out[parent.span_id].append(s.end - s.start)
    return out


def _usable(att: Attribution, dropped: int) -> bool:
    return bool(att.steps) and dropped == 0


def apply_host_ms(att: Attribution, dropped: int) -> Optional[float]:
    applies = _step_children(att, "apply")
    if not _usable(att, dropped) or not applies:
        return None
    return statistics.median(sum(v) / 1e6 for v in applies.values())


def fwd_bwd_host_ms(att: Attribution, dropped: int) -> Optional[float]:
    fwd, bwd = _step_children(att, "forward"), _step_children(att, "backward")
    if not _usable(att, dropped) or not fwd:
        return None
    return statistics.median((sum(fwd[k]) + sum(bwd.get(k, ()))) / 1e6
                             for k in fwd)


def apply_launches_per_step(att: Attribution,
                            dropped: int) -> Optional[float]:
    if not _usable(att, dropped):
        return None
    n = sum(1 for _, _, span in att.kernels
            if span is not None and att.within(span, "apply"))
    return n / len(att.steps)


def host_waits_per_step(att: Attribution, dropped: int) -> Optional[float]:
    if not _usable(att, dropped):
        return None
    n = sum(1 for w in att.device.waits if att.step_of(w.start) is not None)
    return n / len(att.steps)


def device_ms(att: Attribution, name: str) -> Optional[float]:
    """The median over steps of the CUDA-event time of the spans called
    ``name`` (``step`` or ``apply``), where the program recorded it."""
    values = [s.device_ms for s in att.spans if s.name == name
              and s.device_ms is not None and att.step_of(s.start)]
    return statistics.median(values) if values else None
