"""Run one cell traced, as ``run.py --trace 1`` does, with the program's
own step spans on for the window, and attribute the device trace to them.

    python3 portbench/trace_steps.py --workload bert_base.seq128 \\
        --seed 7 --seconds 51 [--out steps.jsonl]

The window, its profiler and the cell's per-layer metrics are the
benchmark's own (``harness/measure.py``). For the window the program's
tracer samples every step, its ring sized to hold them; once the window
has closed, the profiler's events are read again with their correlation
ids and attributed to the program's spans
(``harness/attribution.py``). Standard error gets, a step by program
span, the host ms, kernels launched, host waits and idle seconds, and the
host waits named by span and call; standard output one JSON line: the
cell's per-layer metrics, the four readings of the program's spans, the
table, the checks of the attribution and of the clocks, and the program's
CUDA-event times beside the benchmark's own. ``--out`` writes the line
to a file as well.

The benchmark's command does not turn the program's spans on. In its
traced run that would take two edits to ``harness/measure.py``
(configure the tracer around the window and hand its spans to ``Run``)
and one to ``harness/trace.py`` (keep the correlation ids, the launches
and the waits): what :func:`program_spans_on` hooks in from outside.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# spans the program's tracer holds for the window: ~22 a BERT step, some
# 7,700 in a 51 s seq128 window; a reading is None if the ring drops any
CAPACITY = 1 << 17


@contextlib.contextmanager
def program_spans_on(captured: dict):
    """Around ``measure.measure(..., traced=True)``: the program's tracer
    samples every step from the profiler's start to its read, and
    ``captured`` receives the program's spans, the ring's drops and the
    profiler's events beyond the timeline."""
    from ps_tpu_torch import obs

    from portbench.harness import attribution
    from portbench.harness import trace as tracing

    start, read = tracing.start, tracing.read
    tracer = obs.tracer()
    sample, size = tracer.sample, tracer.capacity

    def start_traced():
        tracer.clear()
        obs.configure(sample=1.0, capacity=CAPACITY)
        return start()

    def read_traced(prof, host):
        obs.configure(sample=sample)
        timeline = read(prof, host)
        # read after the window's closing synchronize: every event passed
        captured["pending"] = tracer.resolve_device()
        captured["spans"], captured["dropped"] = \
            attribution.program_spans(tracer)
        if timeline is not None:
            captured["device"] = attribution.read_device(prof,
                                                         timeline.window)
        return timeline

    tracing.start, tracing.read = start_traced, read_traced
    try:
        yield
    finally:
        tracing.start, tracing.read = start, read
        tracer.clear()
        obs.configure(sample=sample, capacity=size)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/trace_steps.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import attribution, check, measure, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        measure.log("trace_steps: torch finds no card")
        return 2
    torch.cuda.init()
    card = torch.cuda.get_device_name(0)
    captured: dict = {}
    with program_spans_on(captured):
        out = measure.measure(cell, args.seed, args.seconds, True,
                              torch.device("cuda", 0), t0, card)
    run = out["run"]
    correct, _ = check.judge(out["gaps"], cell.limits)
    per_layer = {m["name"]: spec.metric_reader(m["name"])(run)
                 for m in cell.per_layer}
    line = {"workload": cell.name, "seed": args.seed, "card": card,
            "correct": correct, "steps": run.steps,
            "samples_per_s": run.steps * cell.traffic["batch"]
            / run.window_s, "per_layer": per_layer}
    tl = run.timeline
    if tl is None or "device" not in captured:
        measure.log("trace_steps: the profiler recorded no window")
        print(json.dumps(line), flush=True)
        return 1
    att = attribution.Attribution(captured["spans"], tl.window,
                                  captured["device"])
    dropped = captured["dropped"]
    line["program"] = {
        "apply_host_ms": attribution.apply_host_ms(att, dropped),
        "fwd_bwd_host_ms": attribution.fwd_bwd_host_ms(att, dropped),
        "apply_launches_per_step":
            attribution.apply_launches_per_step(att, dropped),
        "host_waits_per_step": attribution.host_waits_per_step(att, dropped),
        "steps": len(att.steps), "spans": len(att.spans),
        "dropped": dropped, "pending_device_events": captured["pending"]}
    step_ms = attribution.device_ms(att, "step")
    apply_ms = attribution.device_ms(att, "apply")
    line["cuda_events"] = {
        "program_apply_ms": apply_ms,
        "server_apply_ms": per_layer.get("server_apply_ms"),
        "program_step_less_apply_ms": None if step_ms is None
        or apply_ms is None else step_ms - apply_ms,
        "fwd_bwd_ms": per_layer.get("fwd_bwd_ms")}
    line["checks"] = att.checks(len(tl.kernels()))
    line["table"] = att.table(tl.idle_gaps())
    line["waits"] = att.waits_named()
    measure.log(f"trace_steps: {len(att.steps)} program steps of "
                f"{run.steps}; {dropped} spans dropped; "
                f"{line['samples_per_s']:.3f} samples/s traced; card {card}")
    measure.log("span: host ms, kernels, host waits a step; idle s "
                "(window)")
    for name, row in sorted(line["table"].items(),
                            key=lambda kv: -kv[1]["kernels"]):
        measure.log(f"span {name}: {row['host_ms']:.3f} ms, "
                    f"{row['kernels']:.2f}, {row['waits']:.3f}; "
                    f"{row['idle_s']:.4f} s")
    for what, n in sorted(line["waits"].items(), key=lambda kv: -kv[1]):
        measure.log(f"wait {n:.3f} a step: {what}")
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    T0 = time.perf_counter()
    sys.path[:0] = [ROOT]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.exit(main(sys.argv[1:], T0))
