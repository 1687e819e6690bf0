"""The benchmark's command: one run of one cell, its result as the last line
of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics
of ``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, each
taken by its reader ``portbench/metrics/<name>.py`` (a reader that finds
nothing returns None, and the metric is left out). Set-up's parts and the
numbers compared with the reference, each beside its limit, go to
standard error, the numbers last; the numbers are also the result's last
key, ``checks``.

It exits with another code than 0, and prints no result, where torch
finds no card or fewer than the cell asks for, where the system under
test is not in this checkout, and where JAX or the JAX package is loaded
in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

from portbench.harness import check, measure, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ps_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def loaded_forbidden():
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` (linear between order statistics,
    numpy's default), for q in (0, 1)."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(run, setup_s: float) -> dict:
    """Every end-to-end metric this harness knows, by name.
    ``images_per_s`` is ``samples_per_s`` where the samples are images."""
    samples = run.steps * run.cell.traffic["batch"]
    known = {"samples_per_s": samples / run.window_s,
             "step_ms_p90": quantile(run.step_ms, 0.9),
             "peak_mem_gib": run.memory_peak / 2**30,
             "setup_s": setup_s}
    if run.cell.traffic["inputs"] == "images":
        known["images_per_s"] = known["samples_per_s"]
    return known


def result(cell, out: dict, traced: bool, correct: bool, checks: dict,
           card: str, count: int) -> dict:
    run = out["run"]
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        known = end_to_end(run, out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": known[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card, "count": count,
              "memory_peak_bytes": run.memory_peak}
    line = {"correct": correct, "attempted": run.steps,
            "failed": run.nonfinite, "metrics": metrics, "device": device}
    if traced and run.timeline is not None:
        device["busy_s"] = run.timeline.busy_s()
        device["window_s"] = run.timeline.window_s
        line["breakdown"] = run.timeline.breakdown()
    line["checks"] = checks
    return line


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    chips = {w["name"]: w for w in spec.benchmark()["workloads"]}[
        args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        measure.log(f"portbench: the cell {args.workload} needs {chips} "
                    f"card(s); torch finds "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    imports_s = time.perf_counter() - t0
    t = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    card = torch.cuda.get_device_name(0)
    cuda_init_s = time.perf_counter() - t
    out = measure.measure(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t0, card)
    run = out["run"]
    found = loaded_forbidden()
    if found:
        measure.log(f"portbench: JAX or the JAX package is loaded: {found}")
        return 3
    correct, checks = check.judge(out["gaps"], cell.limits)
    measure.log(f"setup: imports {imports_s:.3f} s (from process start)")
    measure.log(f"setup: cuda init {cuda_init_s:.3f} s")
    for name, secs in out["setup_parts"].items():
        measure.log(f"setup: {name} {secs:.3f} s")
    measure.log(f"setup: total {out['setup_s']:.3f} s (from process start)")
    samples = run.steps * cell.traffic["batch"]
    measure.log(f"window: {run.steps} steps, {samples} samples in "
                f"{run.window_s:.4f} s = {samples / run.window_s:.3f} "
                f"samples/s{' (traced)' if args.trace else ''}; step ms "
                f"median {statistics.median(run.step_ms):.3f}; "
                f"{run.nonfinite} losses not finite; card {card}")
    if run.timeline is not None:
        measure.log(f"trace: busy {run.timeline.busy_s():.4f} s of "
                    f"{run.timeline.window_s:.4f} s; longest idle gaps "
                    f"{run.timeline.longest_gaps()}")
    line = result(cell, out, bool(args.trace), correct, checks, card, chips)
    for name, c in checks.items():
        measure.log(f"check {name}: {c['value']} limit {c['limit']} "
                    f"(worst at {c['worst_at']})")
    print(json.dumps(line), flush=True)
    return 0
