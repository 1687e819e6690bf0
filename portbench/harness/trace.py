"""The traced run: ``torch.profiler`` over the window, tracing the card
only, read back as device intervals, beside the benchmark's own host
spans.

The profiler records the card's activity (CUPTI), not the host's
operators: recording every operator would slow the host, which paces the
host-bound cells, and so inflate the idle share it is there to measure.
The harness stamps its own host spans with the host's monotonic clock
from its own files: ``window`` around the whole window, ``step`` around
each call of the step, and ``server_apply`` around the server's apply
(the wrapper on the store's engine). The two clocks are aligned at the
synchronize that closes the window: the profiler's record of that
``cudaDeviceSynchronize`` call, or where the trace has no such record,
the end of the last device activity, which that synchronize waited for.
That synchronize is of the stream the step runs on
(``cudaStreamSynchronize``), apart from the ``cudaDeviceSynchronize``
with which the profiler itself stops.
Device activity is every kernel, copy and fill on the card; the device's
busy time is the union of those intervals inside the window, and an idle
gap is labelled by the span the host was in when it began:

- ``fwd_bwd``: inside a step, before its apply was dispatched;
- ``server_apply``: inside the apply's dispatch;
- ``step_tail``: inside a step, after its apply returned;
- ``between_steps``: in the window, outside any step.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

_DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
_COPIES = ("Memcpy", "Memset")
_SYNC = "cudaStreamSynchronize"
# runtime calls that make the host wait for the card
_WAITS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "cudaMemcpy"}


def start():
    """A started profiler of the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                   with_stack=False, profile_memory=False)
    prof.start()
    return prof


class Spans:
    """The benchmark's host spans, stamped with ``time.perf_counter_ns``."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[int, int]]] = \
            collections.defaultdict(list)
        self.close_sync: Tuple[int, int] = (0, 0)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans[name].append((t, time.perf_counter_ns()))


@dataclasses.dataclass
class Timeline:
    window: Tuple[int, int]                      # ns, the window's span
    device: List[Tuple[int, int, str]]           # ns, inside the window
    spans: Dict[str, List[Tuple[int, int]]]      # host spans by name
    aligned_by: str = ""
    host_waits: int = 0          # the host's waits for the card inside

    def edges(self) -> Tuple[float, float]:
        """Seconds from the window's start to the first device activity,
        and from the last one to the window's end: both small where the
        clocks are aligned (the window opens and closes on an idle
        card)."""
        if not self.device:
            return float("nan"), float("nan")
        first = min(s for s, _, _ in self.device)
        last = max(e for _, e, _ in self.device)
        return (first - self.window[0]) / 1e9, (self.window[1] - last) / 1e9

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> List[Tuple[int, int, str]]:
        """The device intervals that are kernels (not copies or fills)."""
        return [d for d in self.device if not d[2].startswith(_COPIES)]

    @functools.cached_property
    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity, merged, inside the window."""
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def label(self, t: int) -> str:
        """What the host was doing at ``t``, by the benchmark's spans."""
        applies = self.spans.get("server_apply", [])
        steps = self.spans.get("step", [])
        i = bisect.bisect_right(applies, (t, float("inf"))) - 1
        if i >= 0 and applies[i][0] <= t < applies[i][1]:
            return "server_apply"
        j = bisect.bisect_right(steps, (t, float("inf"))) - 1
        if j >= 0 and steps[j][0] <= t < steps[j][1]:
            k = bisect.bisect_right(applies, (t, float("inf")))
            later = k < len(applies) and applies[k][0] < steps[j][1]
            return "fwd_bwd" if later else "step_tail"
        return "between_steps"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the idle
        time by what the host was doing, each in seconds."""
        ops: Dict[str, int] = collections.Counter()
        for s, e, name in self.device:
            ops[short_name(name)] += e - s
        idle: Dict[str, int] = collections.Counter()
        for s, e in self.idle_gaps():
            idle[self.label(s)] += e - s
        return {"device_ops": [[n, v / 1e9] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v / 1e9]
                              for n, v in idle.most_common(top)]}

    def longest_gaps(self, n: int = 5) -> List[Tuple[str, float, float]]:
        """The ``n`` longest idle gaps: what the host was doing, the
        seconds, and when the gap began, in seconds into the window."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return [(self.label(s), (e - s) / 1e9, (s - self.window[0]) / 1e9)
                for s, e in gaps]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and argument list, cut to
    ``limit`` characters."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:limit]


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def read(prof, host: Spans) -> Optional[Timeline]:
    """Stop ``prof`` and read its device events, with ``host``'s spans
    moved onto the profiler's clock; None where the host recorded no
    window."""
    prof.stop()
    from torch.autograd import DeviceType

    device, syncs, waits = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            activity = getattr(e, "activity_type", None)
            if activity is not None and activity() not in _DEVICE_ACTIVITIES:
                continue
            device.append((_ns(e, "start"), _ns(e, "end"), name))
        elif name in _WAITS:
            waits.append(_ns(e, "start"))
            if name == _SYNC:
                syncs.append(_ns(e, "start"))
    windows = host.spans.get("window")
    if not windows or not device:
        return None
    before, after = host.close_sync
    if syncs:
        offset, by = max(syncs) - before, _SYNC
    else:
        offset, by = max(e for _, e, _ in device) - after, "last device end"
    spans = {k: sorted((s + offset, e + offset) for s, e in v)
             for k, v in host.spans.items()}
    w0, w1 = spans["window"][0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    # the waits inside the window before the synchronizes that close it
    n_waits = sum(1 for t in waits if w0 <= t < before + offset)
    return Timeline((w0, w1), inside, spans, by, n_waits)
