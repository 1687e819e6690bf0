"""A device-side ``torch.profiler`` trace of a trainer's steps, and a
table of the kernels that take the most device time (the trainers'
``--profile-dir``)."""

from __future__ import annotations

import os

import torch


def start_profiler(out_dir, device, steps):
    """A started ``torch.profiler`` that skips step 0, warms up on step 1
    and records the rest, or None without ``out_dir``. On the card it
    records device activity only: recording every CPU op as well slows
    eager steps of thousands of launches several times over."""
    if not out_dir:
        return None
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU],
        schedule=torch.profiler.schedule(wait=1, warmup=1, active=steps - 2))
    prof.start()
    return prof


def report_profile(prof, out_dir, traced_s, steps=None):
    """Write the trace; print the kernels (and copies) that take the most
    device time and the device's busy share of the traced steps' wall
    time (one stream: device events do not overlap, so their times add);
    with ``steps``, the traced steps' count, also the device time a step."""
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
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
    if steps:
        print(f"profile: {busy_us / 1e3 / steps:.4f} ms device time and "
              f"{traced_s * 1e3 / steps:.4f} ms wall time a step over "
              f"{steps} traced steps")
