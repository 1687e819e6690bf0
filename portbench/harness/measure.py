"""One run of a cell: set-up, the checked first steps, the closed-loop
window, the trace, and the comparison with the reference.

Set-up builds the system's step once, from weights and a pool of batches
made on the card from the seed, and drives it through its first three
steps with the window's own call, on three different batches; their
readings are kept for the comparison. Two more steps warm the rest up.
The window then dispatches steps back to back, cycling through the pool:
no host synchronize inside it, every loss left on the card, a CUDA event
recorded after each step. It starts and ends at a synchronize; its wall
time is taken on the host. Once it has closed and the peak memory is
read, the program is freed and the reference replays the first three
steps from the same weights and batches.

With ``trace`` the window runs under the profiler, and the store's
engine's ``step_`` is wrapped from here with CUDA events and a host
span, which the per-layer metrics read.
"""

from __future__ import annotations

import gc
import sys
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import check, inputs
from portbench.harness import trace as tracing
from portbench.reference.common import leaf_norms

CHECKED_STEPS = 3
WARM_STEPS = 2
#: faults that tests and calibration plant under the timed path
FAULTS = ("state_unchanged", "half_batch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def data_seed(seed: int) -> int:
    """The pool's seed, apart from the weights' (``seed`` itself)."""
    return (seed * 0x9E3779B1 + 0x7F4A7C15) % 2**63


class SetupClock:
    """The parts of set-up, each timed on the host."""

    def __init__(self):
        self.parts: Dict[str, float] = {}

    def part(self, name: str, fn: Callable, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t
        return out


class Marks:
    """Stamps on the device's timeline: CUDA events on the card, the host
    clock on the CPU (whose ops run as they are called)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


class Run:
    """What a run measured; the per-layer readers take what they need."""

    def __init__(self, cell, card: str):
        self.cell, self.card = cell, card
        self.steps = 0
        self.window_s = 0.0
        self.step_ms: List[float] = []
        self.fwd_bwd_ms: List[float] = []
        self.apply_ms: List[float] = []
        self.timeline: Optional[tracing.Timeline] = None
        self.memory_peak = 0
        self.nonfinite = 0

    @property
    def step_flops(self) -> int:
        return self.cell.system.step_flops(self.cell.config,
                                           self.cell.traffic)


def _wrap_apply(engine, marks: Marks, stamps: list, span) -> None:
    """Record a stamp at the entry and the exit of ``engine.step_`` (the
    server's apply that ``make_step``'s closure calls), inside the host
    span ``server_apply``."""
    apply = engine.step_

    def step_(grads):
        t_in = marks.mark()
        with span("server_apply"):
            apply(grads)
        stamps.append((t_in, marks.mark()))

    engine.step_ = step_


def program_readings(cell, device, seed: int, fault: Optional[str],
                     clock: SetupClock):
    """Build the program's step and drive it through its checked steps.
    Returns the program, the pool, the step's feed and the readings."""
    cfg = cell.config
    gw = torch.Generator(device).manual_seed(seed)
    params0, state0 = clock.part("weights", cell.reference.init_params,
                                 cfg, gw, device)
    gd = torch.Generator(device).manual_seed(data_seed(seed))
    pool = clock.part("batch pool", inputs.make_pool, cfg, cell.traffic, gd,
                      device)
    prog = clock.part("program", cell.system.build, cfg, params0, state0,
                      device)
    feed = inputs.first_half if fault == "half_batch" else (lambda b: b)
    if fault == "state_unchanged":
        prog.engine.step_ = lambda grads: None

    def checked():
        losses, first = [], None
        for i in range(CHECKED_STEPS):
            losses.append(prog.step(feed(pool[i % len(pool)])))
            if i == 0:
                first = prog.first_grad_norms()
        params = prog.params()
        state = prog.state()
        return {"losses": torch.stack(losses).double().cpu().tolist(),
                "grad_norms": first,
                "change_norms": leaf_norms({k: params[k] - params0[k]
                                            for k in params}),
                "state_change_norms": leaf_norms(
                    {k: state[k] - state0[k] for k in state})}

    readings = clock.part("checked steps", checked)
    del params0, state0
    return prog, pool, feed, readings


def measure(cell, seed: int, seconds: float, traced: bool,
            device: torch.device, t0: float, card: str,
            fault: Optional[str] = None) -> dict:
    """One run: returns the measured :class:`Run`, the gaps and the
    set-up's parts."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    clock = SetupClock()
    marks = Marks(device)
    if device.type == "cuda":
        for name in cell.system.kernels(cell.config):
            clock.part(f"kernel library ({_library_state(name)})",
                       _build, name)
    prog, pool, feed, prog_readings = program_readings(cell, device, seed,
                                                       fault, clock)
    n_pool = len(pool)

    def warm():
        for i in range(CHECKED_STEPS, CHECKED_STEPS + WARM_STEPS):
            prog.step(feed(pool[i % n_pool]))
        marks.sync()

    clock.part("warm-up", warm)
    run = Run(cell, card)
    stamps: list = []
    span = tracing.Spans() if traced else (lambda name: nullcontext())
    if traced:
        _wrap_apply(prog.engine, marks, stamps, span)
        prof = clock.part("profiler start", tracing.start)
    gc.collect()
    if marks.cuda:
        torch.cuda.reset_peak_memory_stats()
    marks.sync()
    setup_s = time.perf_counter() - t0
    losses, ends = [], []
    i = CHECKED_STEPS + WARM_STEPS
    with span("window"):
        start = time.perf_counter()
        first = marks.mark()
        deadline = start + seconds
        while True:
            with span("step"):
                loss = prog.step(feed(pool[i % n_pool]))
            ends.append(marks.mark())
            losses.append(loss)
            i += 1
            if time.perf_counter() >= deadline:
                break
        before = time.perf_counter_ns()
        if traced:  # the stream's synchronize is the clocks' marker
            torch.cuda.current_stream().synchronize()
        after = time.perf_counter_ns()
        marks.sync()
        end = time.perf_counter()
    if traced:
        span.close_sync = (before, after)
        t = time.perf_counter()
        run.timeline = tracing.read(prof, span)
        if run.timeline is not None:
            log(f"trace: read in {time.perf_counter() - t:.3f} s, clocks "
                f"aligned by {run.timeline.aligned_by}; first device "
                f"activity, last: {run.timeline.edges()} s from the "
                f"window's edges; {run.timeline.host_waits} host waits "
                f"for the card inside the window")
    run.window_s = end - start
    run.steps = len(ends)
    run.step_ms = [marks.ms(a, b) for a, b in zip([first] + ends[:-1], ends)]
    if stamps:
        prev = [first] + ends[:-1]
        run.fwd_bwd_ms = [marks.ms(p, a) for p, (a, _) in zip(prev, stamps)]
        run.apply_ms = [marks.ms(a, b) for a, b in stamps]
    if marks.cuda:
        run.memory_peak = torch.cuda.max_memory_allocated()
    run.nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    del losses, ends, stamps
    prog.close()
    del prog
    gc.collect()
    if marks.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gw = torch.Generator(device).manual_seed(seed)
    params, state = cell.reference.init_params(cell.config, gw, device)
    ref = cell.reference.readings(cell.config, params, state,
                                  pool[:CHECKED_STEPS])
    found = check.gaps(prog_readings, ref)
    log(f"reference: {CHECKED_STEPS} steps in {time.perf_counter() - t:.3f}"
        f" s; losses {ref['losses']} (program {prog_readings['losses']})")
    return {"run": run, "gaps": found, "setup_s": setup_s,
            "setup_parts": clock.parts}


def _library_state(name: str) -> str:
    from ps_tpu_torch.ops import _build

    return "cached" if _build._library_path(name).exists() else "built"


def _build(name: str) -> None:
    from ps_tpu_torch.ops import _build

    _build.load(name)
