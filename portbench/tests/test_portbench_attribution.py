"""CPU tests of the attribution of a traced window to the program's own
spans (``portbench/harness/attribution.py``) on synthetic timelines, and
of the hook that turns the program's spans on around the benchmark's
traced run (``portbench/trace_steps.py``).

    python -m pytest portbench/tests -q
"""

import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import trace_steps  # noqa: E402
from portbench.harness import attribution as att_mod  # noqa: E402
from portbench.harness import spec, trace  # noqa: E402
from portbench.harness.attribution import (  # noqa: E402
    Attribution,
    DeviceEvents,
    Launch,
    ProgramSpan,
)

US = 1_000
MS = 1_000_000
MAIN, AUTOGRAD = 1, 2
EXISTING = ("kernels_per_step", "fwd_bwd_ms", "server_apply_ms",
            "flash_fwd_roofline_pct", "mfu_pct", "device_idle_pct")


def _step(i: int, t0: int):
    """One step's spans from ``t0``, 10 ms long: forward 0-3, backward
    3-6 with ``flash_bwd`` 4-5 and ``embed_bwd`` 5.5-5.9 (autograd's
    thread), apply 6-9 with its three parts."""
    sid = f"s{i}"

    def sp(name, a, b, parent=sid, device_ms=None):
        return ProgramSpan(name, f"{name}{i}", parent, t0 + a, t0 + b,
                           device_ms)

    return [ProgramSpan("step", sid, None, t0, t0 + 10 * MS, 9.0),
            sp("forward", 0, 3 * MS), sp("backward", 3 * MS, 6 * MS),
            sp("flash_bwd", 4 * MS, 5 * MS),
            sp("embed_bwd", 5500 * US, 5900 * US),
            sp("apply", 6 * MS, 9 * MS, device_ms=2.0 + i),
            sp("apply.reduce", 6 * MS, 6100 * US, parent=f"apply{i}"),
            sp("apply.optimizer", 6100 * US, 8 * MS, parent=f"apply{i}"),
            sp("apply.gather", 8 * MS, 9 * MS, parent=f"apply{i}")]


# (host start in a step, thread, device start after it): what each
# step launches, by the span it launches from
_LAUNCHED = [(1 * MS, MAIN, "fwd"),                 # forward
             (4500 * US, MAIN, "bwd_main"),         # backward, main thread
             (4600 * US, AUTOGRAD, "flash"),        # flash_bwd, other thread
             (5700 * US, AUTOGRAD, "embed"),        # embed_bwd
             (6050 * US, MAIN, "reduce"),           # apply.reduce
             (7 * MS, MAIN, "lamb1"), (7500 * US, MAIN, "lamb2"),
             (8500 * US, MAIN, "gather"),           # apply.gather
             (9500 * US, MAIN, "tail")]             # step, after apply


def _synthetic(steps=2, window=(0, 30 * MS)):
    spans, kernels, launches, waits = [], [], {}, []
    corr = 0
    for i in range(steps):
        t0 = i * 12 * MS
        spans += _step(i, t0)
        for at, thread, name in _LAUNCHED:
            corr += 1
            launches[corr] = Launch(t0 + at, thread, "cudaLaunchKernel")
            kernels.append((t0 + at + 50 * US, t0 + at + 60 * US,
                            f"void k_{name}(float*)", corr))
        waits.append(Launch(t0 + 5800 * US, AUTOGRAD,
                            "cudaStreamSynchronize"))  # in embed_bwd
    # a launch between the steps, and a kernel whose launch is missing
    corr += 1
    launches[corr] = Launch(11 * MS, MAIN, "cudaLaunchKernel")
    kernels.append((11 * MS + 10 * US, 11 * MS + 20 * US, "between", corr))
    kernels.append((25 * MS, 25 * MS + 10 * US, "orphan", 999))
    waits.append(Launch(26 * MS, MAIN, "cudaDeviceSynchronize"))
    device = DeviceEvents(sorted(kernels), launches, waits)
    return Attribution(spans, window, device)


def test_innermost_span_across_two_threads_and_outside():
    att = _synthetic()
    # autograd's launch inside flash_bwd, while backward is open on main
    assert att.name_at(4600 * US) == "flash_bwd"
    assert att.name_at(4500 * US) == "flash_bwd"  # any thread's time
    assert att.name_at(3500 * US) == "backward"
    assert att.name_at(6050 * US) == "apply.reduce"
    assert att.name_at(9500 * US) == "step"
    assert att.name_at(11 * MS) == att_mod.OUTSIDE
    assert att.name_at(12 * MS + 7 * MS) == "apply.optimizer"
    assert att.innermost(40 * MS) is None
    assert att.within(att.innermost(7 * MS), "apply")
    assert not att.within(att.innermost(1 * MS), "apply")


def test_every_kernel_is_counted_once():
    att = _synthetic()
    c = att.checks(n_kernels=2 * len(_LAUNCHED) + 2)
    assert c["kernels"] == c["trace_kernels"] == 20
    assert c["attributed"] + c["outside"] + c["unlaunched"] == 20
    assert (c["attributed"], c["outside"], c["unlaunched"]) == (18, 1, 1)
    assert c["device_before_launch"] == 0
    # the steps' first launches 1 ms after their starts, last 0.5 before
    assert c["step_to_first_launch_us"] == 1000.0
    assert c["last_launch_to_step_end_us"] == 500.0
    table = att.table(idle_gaps=[])
    assert math.isclose(sum(r["kernels"] for r in table.values()), 10.0)
    assert table["flash_bwd"]["kernels"] == 2  # bwd_main's and flash's
    assert table["apply.optimizer"]["kernels"] == 2
    assert table[att_mod.OUTSIDE]["kernels"] == 0.5
    assert table[att_mod.UNLAUNCHED]["kernels"] == 0.5


def test_the_clocks_order_is_checked():
    att = _synthetic()
    k = att.device.kernels[0]
    launch = att.device.launches[k[3]]
    launch.start = k[0] + 5 * US  # the card before its launch
    c = att.checks(n_kernels=20)
    assert c["device_before_launch"] == 1
    assert math.isclose(c["device_before_launch_max_us"], 5.0)


def test_readers_of_the_program_spans():
    att = _synthetic()
    assert att_mod.apply_host_ms(att, 0) == 3.0
    assert att_mod.fwd_bwd_host_ms(att, 0) == 6.0
    # reduce, lamb1, lamb2, gather a step
    assert att_mod.apply_launches_per_step(att, 0) == 4.0
    # the wait in embed_bwd counts; the one between the steps does not
    assert att_mod.host_waits_per_step(att, 0) == 1.0
    assert att_mod.device_ms(att, "apply") == 2.5
    assert att_mod.device_ms(att, "step") == 9.0
    assert att_mod.device_ms(att, "forward") is None
    named = att.waits_named()
    assert named == {
        "embed_bwd: cudaStreamSynchronize after cudaLaunchKernel, last "
        "kernel k_embed": 1.0,
        "outside: cudaDeviceSynchronize after cudaLaunchKernel, last "
        "kernel k_tail": 0.5}
    table = att.table(idle_gaps=[(5600 * US, 5650 * US),
                                 (11 * MS, 11500 * US)])
    assert math.isclose(table["embed_bwd"]["idle_s"], 50e-6)
    assert math.isclose(table[att_mod.OUTSIDE]["idle_s"], 500e-6)
    assert math.isclose(table["apply"]["host_ms"], 3.0)
    assert table["embed_bwd"]["waits"] == 1.0


@pytest.mark.parametrize("case", ["no spans", "dropped", "other window"])
def test_readers_refuse_without_spans_or_with_drops(case):
    att = _synthetic()
    dropped = 0
    if case == "no spans":
        att = Attribution([], (0, 30 * MS), att.device)
    elif case == "dropped":
        dropped = 3
    else:
        att = Attribution(att.spans, (40 * MS, 50 * MS), att.device)
    for read in (att_mod.apply_host_ms, att_mod.fwd_bwd_host_ms,
                 att_mod.apply_launches_per_step,
                 att_mod.host_waits_per_step):
        assert read(att, dropped) is None


def test_waits_name_the_copy_and_the_kernel_before_them():
    att = _synthetic()
    t = 5750 * US  # a copy back after k_embed, on autograd's thread
    att.device.launches[500] = Launch(t, AUTOGRAD, "cudaMemcpyAsync", t)
    assert "embed_bwd: cudaStreamSynchronize after cudaMemcpyAsync, last " \
        "kernel k_embed" in att.waits_named()


class _Run:
    def __init__(self, cell, timeline):
        self.cell, self.timeline = cell, timeline
        self.card = "NVIDIA H100 80GB HBM3"
        self.steps, self.window_s = 2, 0.03
        self.step_ms = [10.0, 12.0]
        self.fwd_bwd_ms, self.apply_ms = [6.0, 6.0], [3.0, 3.0]
        self.memory_peak = 2**30
        self.nonfinite = 0

    @property
    def step_flops(self):
        return self.cell.system.step_flops(self.cell.config,
                                           self.cell.traffic)


def test_the_existing_readers_are_untouched_by_the_attribution():
    """The six per-layer readers read the same values before and after
    the program's spans are attributed over the same timeline, and the
    attribution counts the kernels ``kernels_per_step`` counts."""
    att = _synthetic()
    device = [(s, e, n) for s, e, n, _ in att.device.kernels]
    device.append((20 * MS, 21 * MS, "Memcpy DtoH (Device -> Pinned)"))
    tl = trace.Timeline((0, 30 * MS), device,
                        {"window": [(0, 30 * MS)],
                         "step": [(0, 10 * MS), (12 * MS, 22 * MS)]})
    cell = spec.load_cell("bert_base.seq512")
    run = _Run(cell, tl)
    before = {n: spec.metric_reader(n)(run) for n in EXISTING}
    gaps = tl.idle_gaps()
    att.table(gaps)
    c = att.checks(len(tl.kernels()))
    after = {n: spec.metric_reader(n)(run) for n in EXISTING}
    assert before == after and before["kernels_per_step"] == 10.0
    assert c["kernels"] == len(tl.kernels()) == 20
    assert tl.idle_gaps() == gaps


def test_the_hook_turns_the_program_spans_on_around_a_traced_run(
        monkeypatch):
    """On the CPU, without a card (the profiler records the CPU's
    operators there): the hook samples the program's steps between the
    profiler's start and its read, hands their spans over, and sets the
    tracer and the harness back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def start_cpu():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        return prof

    monkeypatch.setattr(trace, "start", start_cpu)

    import ps_tpu_torch
    from ps_tpu_torch import obs
    from ps_tpu_torch.models import resnet

    tracer = obs.tracer()
    sample, capacity = tracer.sample, tracer.capacity
    start, read = trace.start, trace.read
    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        model = resnet.ResNet(stage_sizes=(1,), block_cls=resnet.BasicBlock,
                              num_filters=4, num_classes=10,
                              dtype=torch.float32, small_inputs=True)
        params, state = model.init(torch.Generator().manual_seed(0),
                                   in_channels=1)
        store = ps_tpu_torch.KVStore(optimizer="momentum",
                                     learning_rate=0.1, momentum=0.9)
        store.init(params)
        step = store.make_step(resnet.make_loss_fn(model), has_aux=True)
        batch = (torch.randn(4, 16, 16, 1), torch.randint(0, 10, (4,)))
        step(batch, state)  # before the profiler: not sampled
        captured = {}
        with trace_steps.program_spans_on(captured):
            assert trace.start is not start
            prof = trace.start()
            assert tracer.sample == 1.0 and tracer.capacity == trace_steps.CAPACITY
            host = trace.Spans()
            with host("window"):
                for _ in range(2):
                    step(batch, state)
            assert trace.read(prof, host) is None  # no device events here
            assert tracer.sample == sample
            step(batch, state)  # after the read: not sampled
        assert (trace.start, trace.read) == (start, read)
        assert tracer.capacity == capacity and tracer.spans() == []
        spans, dropped = captured["spans"], captured["dropped"]
        assert dropped == 0 and "device" not in captured
        assert [s.name for s in spans].count("step") == 2
        assert {s.name for s in spans} == {
            "step", "forward", "backward", "apply", "apply.reduce",
            "apply.optimizer", "apply.gather"}
    finally:
        tracer.sample = sample
        ps_tpu_torch.shutdown()
