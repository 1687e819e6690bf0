"""The fused step's spans (``ps_tpu_torch.obs``, category ``"step"``) on
the CPU: their tree and order in one step of a tiny BERT (flash attention
on its CPU path) and of a tiny ResNet, the backward's spans parented
across threads through the tracer's held context, the off path, the
ring's bound, the spans' clock against ``torch.profiler``'s, and the
trainers' ``--profile-dir`` trace holding both.
"""

import importlib
import json
import threading

import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch import obs
from ps_tpu_torch.data.synthetic import mlm_batches
from ps_tpu_torch.models import bert, resnet
from ps_tpu_torch.obs import trace as trace_mod
from ps_tpu_torch.utils import profiling

# the module itself: ps_tpu_torch.ops exports the function under its name
fa_mod = importlib.import_module("ps_tpu_torch.ops.flash_attention")
APPLY_PARTS = ["apply.reduce", "apply.optimizer", "apply.gather"]


@pytest.fixture(autouse=True)
def _fresh():
    """A fresh store, and the process tracer off and empty around each
    test, as a process starts. One intra-op thread: the steps are tiny,
    and the suite's timing-sensitive drills run beside this file."""
    tracer = obs.tracer()
    sample, capacity = tracer.sample, tracer.capacity
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ps_tpu_torch.shutdown()
    tracer.clear()
    yield tracer
    ps_tpu_torch.shutdown()
    torch.set_num_threads(threads)
    tracer.sample = sample
    tracer.resize(capacity)
    tracer.held = None
    tracer.clear()


def _bert_step():
    """A tiny BERT's fused LAMB step with flash attention (its CPU path)
    on one batch."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    model = bert.BertMLM(bert.BertConfig.tiny(attn="flash", max_len=128),
                         generator=torch.Generator().manual_seed(0))
    store = ps_tpu_torch.KVStore(optimizer="lamb", learning_rate=1e-3)
    store.init(model.param_tree())
    batch = store.shard_batch(next(mlm_batches(2, 128, vocab_size=512,
                                               seed=1)))
    run = store.make_step(bert.make_mlm_loss_fn(model))
    return lambda: run(batch)


def _resnet_step():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                          num_filters=8, num_classes=10, dtype=torch.float32,
                          small_inputs=True)
    params, state = model.init(torch.Generator().manual_seed(0),
                               in_channels=1)
    store = ps_tpu_torch.KVStore(optimizer="momentum", learning_rate=0.1,
                                 momentum=0.9)
    store.init(params)
    run = store.make_step(resnet.make_loss_fn(model), has_aux=True)
    g = torch.Generator().manual_seed(1)
    batch = store.shard_batch((torch.randn(8, 28, 28, 1, generator=g),
                               torch.randint(0, 10, (8,), generator=g)))
    return lambda: run(batch, state)


BUILD = {"bert": _bert_step, "resnet": _resnet_step}
# the backward's spans a step records, by name: BERT's token and type
# tables (the positions are a slice of theirs) and one flash attention a
# layer (2 in the tiny model)
BACKWARD = {"bert": {"embed_bwd": 2, "flash_bwd": 2}, "resnet": {}}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(inner, outer) -> bool:
    return (outer.ts_us <= inner.ts_us
            and inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us)


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_fused_step_records_the_span_tree_in_order(model, _fresh):
    step = BUILD[model]()
    obs.configure(sample=1.0)
    step()
    spans = _fresh.spans()
    names = _by_name(spans)
    assert sorted(names) == sorted(["step", "forward", "backward", "apply",
                                    *APPLY_PARTS, *BACKWARD[model]])
    (root,) = names.pop("step")
    assert root.parent_id is None and root.cat == "step"
    assert all(s.cat == "step" and s.trace_id == root.trace_id
               and _inside(s, root) for s in spans)
    (fwd,), (bwd,), (apply,) = names["forward"], names["backward"], \
        names["apply"]
    for s in (fwd, bwd, apply):
        assert s.parent_id == root.span_id
    assert fwd.ts_us + fwd.dur_us <= bwd.ts_us
    assert bwd.ts_us + bwd.dur_us <= apply.ts_us
    parts = [names[n][0] for n in APPLY_PARTS]
    for a, b in zip(parts, parts[1:]):
        assert a.ts_us + a.dur_us <= b.ts_us
    for p in parts:
        assert p.parent_id == apply.span_id and _inside(p, apply)
    for name, count in BACKWARD[model].items():
        assert len(names[name]) == count
        for s in names[name]:
            assert s.parent_id == root.span_id and _inside(s, bwd)
    # the step's context is held only while it is open; nothing dropped
    assert _fresh.held is None and _fresh.dropped == 0
    # no device here: no CUDA events, nothing to resolve
    assert _fresh.resolve_device() == 0
    assert not any("device_ms" in s.args for s in spans)


def _embed_backward():
    ids = torch.randint(0, 16, (4, 8))
    table = torch.randn(16, 8, requires_grad=True)
    out = bert._EmbedLookup.apply(ids, table)
    torch.autograd.grad(out.sum(), [table])


def _flash_backward():
    q, k, v = (torch.randn(2, 16, 2, 8, requires_grad=True)
               for _ in range(3))
    out = fa_mod.flash_attention(q, k, v, block_q=8, block_k=8)
    torch.autograd.grad(out.sum(), [q, k, v])


@pytest.mark.parametrize("name,backward", [("embed_bwd", _embed_backward),
                                           ("flash_bwd", _flash_backward)])
def test_backward_spans_on_another_thread_parent_to_the_step(
        name, backward, _fresh):
    """As autograd's device thread runs them on the card: a thread with no
    open span of its own parents them to the open step; with no step open
    they record nothing."""
    errors = []

    def on_thread():
        try:
            backward()
        except Exception as e:  # surfaced below
            errors.append(e)

    def run_on_thread():
        t = threading.Thread(target=on_thread)
        t.start()
        t.join()

    _fresh.sample = 1.0
    with _fresh.span("step", "step", hold=True) as root:
        run_on_thread()
    run_on_thread()  # no step open
    assert not errors
    (span,) = [s for s in _fresh.spans() if s.name == name]
    assert span.parent_id == root.span_id
    assert span.trace_id == root.trace_id
    assert span._tid != root._tid and _inside(span, root)
    assert _fresh.held is None


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_sample_zero_makes_no_span(model, _fresh, monkeypatch):
    step = BUILD[model]()
    made = []

    class Counted(trace_mod.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a[1])
            super().__init__(*a, **kw)

    monkeypatch.setattr(trace_mod, "Span", Counted)
    assert _fresh.sample == 0.0
    for _ in range(2):
        step()
    assert made == [] and _fresh.spans() == [] and _fresh.dropped == 0
    assert _fresh.held is None
    # the same step sampled makes them through the same class
    _fresh.sample = 1.0
    step()
    assert "step" in made and len(made) == len(_fresh.spans())


def test_the_ring_counts_what_it_drops_and_configure_sizes_it(_fresh):
    step = _resnet_step()
    obs.configure(sample=1.0, capacity=10)
    assert _fresh.capacity == 10
    for _ in range(3):  # 7 spans a step
        step()
    assert len(_fresh.spans()) == 10 and _fresh.dropped == 11
    assert _fresh.spans()[-1].name == "step"  # the newest kept
    _fresh.clear()
    obs.configure(capacity=64)
    for _ in range(3):
        step()
    assert len(_fresh.spans()) == 21 and _fresh.dropped == 0
    _fresh.resize(7)  # keeps the newest: the last step whole
    assert [s.name for s in _fresh.spans()].count("step") == 1
    assert _fresh.spans()[-1].name == "step"
    assert _fresh.dropped == 14  # what the smaller ring let go counts


def test_a_failed_exit_event_still_closes_the_held_span(_fresh,
                                                        monkeypatch):
    """A CUDA event that cannot be recorded at a span's exit (the card
    faulted inside the step) leaves no held context or open span behind:
    a later backward span is NOOP, not a child of the dead step."""
    def fault(device):
        raise RuntimeError("CUDA error: an illegal memory access")

    _fresh.sample = 1.0
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with _fresh.span("step", "step", hold=True) as step:
            step._events = ["cuda:0", None, None]  # as time_device leaves it
            monkeypatch.setattr(trace_mod, "_record_event", fault)
    assert _fresh.held is None and _fresh.current() is None
    assert [s.name for s in _fresh.spans()] == ["step"]
    assert _fresh.child("embed_bwd", "step", held=True) is obs.NOOP


def _op_events(prof):
    """The profiler's CPU operator events: (name, start µs, end µs)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("aten::"):
            out.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out


def test_spans_share_the_profilers_clock(_fresh):
    """The spans' ``time.time()`` stamps and a CPU capture of the same
    step, with no offset applied: every operator of the step falls inside
    the step span, and the embedding backward's and the optimizer's
    operators inside their spans."""
    step = _bert_step()
    step()  # warm
    _fresh.sample = 1.0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = _by_name(_fresh.spans())
    (root,) = spans["step"]
    ops = _op_events(prof)
    assert len(ops) > 100
    lo, hi = root.ts_us, root.ts_us + root.dur_us
    assert all(lo <= s and e <= hi for _, s, e in ops)

    def within(name, span_names):
        hits = [(s, e) for n, s, e in ops if n == name]
        assert hits, name
        for s, e in hits:
            assert any(sp.ts_us <= s and e <= sp.ts_us + sp.dur_us
                       for n in span_names for sp in spans[n]), (name, s)

    within("aten::segment_reduce", ["embed_bwd"])
    within("aten::unique_consecutive", ["embed_bwd"])
    within("aten::embedding", ["forward"])
    within("aten::linalg_vector_norm", ["apply.optimizer"])  # LAMB's


def test_profile_dir_trace_holds_the_spans_beside_the_ops(tmp_path, capsys,
                                                          _fresh):
    """``utils.profiling.trace`` (the trainers' ``--profile-dir``) turns
    the step spans on for the recorded steps and writes them into its
    ``trace.json`` on the profiler's clock; the tracer is set back after
    the block."""
    step = _bert_step()
    capacity = _fresh.capacity
    with profiling.trace(str(tmp_path), "cpu", 4) as mark:
        for _ in range(4):
            step()
            mark()
    assert "a step over 2 traced steps" in capsys.readouterr().out
    assert _fresh.sample == 0.0 and _fresh.capacity == capacity
    doc = json.load(open(tmp_path / "trace.json"))
    events = doc["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    steps = [e for e in events if e.get("cat") == "step"
             and e["name"] == "step"]
    assert ops and len(steps) == 2  # steps 2 and 3 recorded
    names = {e["name"] for e in events if e.get("cat") == "step"}
    assert {"forward", "backward", "apply", "embed_bwd",
            "flash_bwd"} <= names
    # one clock: every recorded operator lies in a recorded step's span
    for e in ops:
        assert any(sp["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= sp["ts"] + sp["dur"] for sp in steps), e["name"]


def test_time_device_is_free_off_the_card(_fresh):
    _fresh.sample = 1.0
    with _fresh.span("step", "step") as sp:
        assert sp.time_device(torch.device("cpu")) is sp
    assert sp._events is None
    assert obs.NOOP.time_device(torch.device("cuda")) is obs.NOOP
    assert not _fresh.child("x", "step", held=True)  # nothing held


@pytest.mark.cuda
def test_step_and_apply_carry_device_ms_on_the_card(_fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the card")
    ps_tpu_torch.init(backend="cuda", device="cuda")
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                          num_filters=8, num_classes=10, dtype=torch.float32,
                          small_inputs=True)
    params, state = model.init(torch.Generator().manual_seed(0),
                               in_channels=1)
    store = ps_tpu_torch.KVStore(optimizer="momentum", learning_rate=0.1,
                                 momentum=0.9)
    store.init(params)
    run = store.make_step(resnet.make_loss_fn(model), has_aux=True)
    batch = (torch.randn(8, 28, 28, 1, device="cuda"),
             torch.randint(0, 10, (8,), device="cuda"))
    state = torch.utils._pytree.tree_map(lambda t: t.cuda(), state)
    _fresh.sample = 1.0
    for _ in range(3):
        _, _, state = run(store.shard_batch(batch), state)
    torch.cuda.synchronize()
    assert _fresh.resolve_device() == 0
    spans = _by_name(_fresh.spans())
    assert len(spans["step"]) == len(spans["apply"]) == 3
    for s, a in zip(spans["step"], spans["apply"]):
        assert 0 < a.args["device_ms"] < s.args["device_ms"]
    assert not any("device_ms" in s.args for s in spans["forward"])
