"""Profile a block of training steps (the trainers' ``--profile-dir``).

Counterpart of ``trace`` in ``ps_tpu/utils/profiling.py``: where the
reference wraps ``jax.profiler.trace``, this wraps a device-side
``torch.profiler``, and on the way out writes ``trace.json`` and prints the
kernels that take the most device time, the device time a step by kernel
family and the device's busy share. The fused step's spans
(:mod:`ps_tpu_torch.obs`: ``step``, ``forward``, ``backward``, ``apply``
and their children) are on for the recorded steps and written into the
same ``trace.json``, on the profiler's clock, so Perfetto shows them
over the device's rows.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Iterator, Optional

import torch

from ps_tpu_torch import obs


@contextlib.contextmanager
def trace(profile_dir: Optional[str], device, steps: int
          ) -> Iterator[Callable[[], None]]:
    """Trace ``steps`` steps to ``profile_dir`` (nothing when it is None).

    Yields ``mark()``, to be called once at the end of every step: it
    synchronizes the device and advances the profiler's schedule, which
    skips step 0, warms up on step 1 and records from step 2 to the end of
    the block, where the trace is collected (seconds of host time, so
    that a caller's clock read inside the block leaves it out). The traced
    wall time is the host's clock from the end of step 1 to the end of the
    last step. The process tracer samples every step from step 2 on, its
    ring grown to hold them, and is set back after the block.
    """
    device = torch.device(device)
    if not profile_dir:
        yield lambda: None
        return
    if steps < 3:
        raise ValueError("profiling needs >= 3 steps (step 0 is warm-up)")
    # on the card only device activity is recorded: recording every CPU op
    # as well slows eager steps of thousands of launches several times over
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU],
        schedule=torch.profiler.schedule(wait=1, warmup=1, active=steps - 1))
    prof.start()
    marks = []
    tracer = obs.tracer()
    sample, capacity = tracer.sample, tracer.capacity
    since_us = []  # when the spans came on

    def mark():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append(time.perf_counter())
        prof.step()
        if len(marks) == 2:  # the profiler records from here
            obs.configure(sample=1.0, capacity=max(capacity, 64 * steps))
            since_us.append(time.time() * 1e6)

    try:
        yield mark
    finally:
        prof.stop()
        obs.configure(sample=sample)
        spans = _step_spans(tracer, since_us[0]) if since_us else []
        obs.configure(capacity=capacity)
    _report(prof, profile_dir, marks[-1] - marks[1], len(marks) - 2, spans)


def _step_spans(tracer, since_us: float):
    """The tracer's spans that began at ``since_us`` or later, as Chrome
    trace events on this process's clock (no cross-process offset), their
    device times resolved."""
    tracer.resolve_device()
    events = ({**e, "ts": e["ts"] - tracer.clock_offset_us}
              for e in tracer.chrome_events() if e["ph"] == "X")
    return [e for e in events if e["ts"] >= since_us]


def _write_trace(prof, path: str, spans) -> None:
    """The profiler's Chrome trace with ``spans`` added: its events are
    stamped on the wall clock in µs after ``baseTimeNanoseconds``, the
    spans on the same clock from the epoch."""
    prof.export_chrome_trace(path)
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    doc["traceEvents"].extend({**e, "ts": e["ts"] - base_us}
                              for e in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


def _report(prof, out_dir, traced_s, steps, spans=()):
    """Write the trace with ``spans``; print the kernels (and copies) that
    take the most device time, the device's busy share of the traced
    steps' wall time (one stream: device events do not overlap, so their
    times add), the device time a step and its split by kernel family."""
    os.makedirs(out_dir, exist_ok=True)
    _write_trace(prof, os.path.join(out_dir, "trace.json"), spans)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]  # a step's span
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in device)
    for e in device[:30]:
        print(f"{e.self_device_time_total / 1e3:12.3f} ms "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f}% "
              f"{e.count:7d}x  {e.key[:110]}")
    print(f"profile: device busy {busy_us / 1e3:.3f} ms of "
          f"{traced_s * 1e3:.3f} ms traced "
          f"({busy_us / 1e4 / max(traced_s, 1e-9):.1f}% busy)")
    print(f"profile: {busy_us / 1e3 / steps:.4f} ms device time and "
          f"{traced_s * 1e3 / steps:.4f} ms wall time a step over "
          f"{steps} traced steps")
    by_family = {}
    for e in device:
        family = _family(e.key)
        by_family[family] = by_family.get(family, 0) + e.self_device_time_total
    for family, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"profile: family {family}: {us / 1e3 / steps:.4f} ms a step "
              f"({100 * us / max(busy_us, 1):.1f}%)")


# kernel families by name, first match wins: PyTorch's pooling kernels,
# cuDNN's convolution kernels (and its layout and padding helpers),
# products (CUTLASS's and cuBLAS's nvjet kernels, which cuDNN also calls
# for 1x1 convolutions), PyTorch's batch-norm kernels, reductions (means
# and sums), multi-tensor (foreach) kernels, copies and casts, and the
# other elementwise kernels
_FAMILIES = (
    ("pooling", ("pool",)),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "implicit", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("batch_norm", ("batch_norm",)),
    ("reduction", ("reduce_kernel",)),
    ("foreach", ("multi_tensor_apply",)),
    ("copy", ("copy_kernel", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)


def _family(name: str) -> str:
    lowered = name.lower()
    for family, marks in _FAMILIES:
        if any(m.lower() in lowered for m in marks):
            return family
    return "other"
