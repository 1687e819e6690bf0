"""The port's observability units (``ps_tpu_torch/obs/``, ROADMAP item
6.1) against the reference's ``ps_tpu/obs/`` on the same numpy-seeded
inputs, on the CPU.

- ``Histogram``: the raw state equal, the quantiles equal to 1e-12; the
  reference's own checks (numpy quantiles within a sub-bucket, range
  edges, a sanitized name).
- ``MetricsRegistry``: two registries filled alike render byte-identical
  Prometheus text and equal snapshots; ``TransportStats`` fed alike gives
  equal latency quantiles, and its histograms ride the process registry.
- ``Tracer``: the off path is the NOOP; parentage and the ring bound; the
  Chrome export of the same span tree has the same names, categories,
  parentage and argument keys; ``merge_chrome`` keeps both processes.
- ``FlightRecorder``: the ring, the JSONL dump (the same fields as the
  reference's), the empty dump; ``StepLogger.event`` mirrors into it and
  its ``tensorboard=`` degrades without the package.
- ``Meter`` equal to the reference's on the same event stream.
- The ``Config`` obs knobs from the environment and their validation
  errors, as the reference reads and raises them.

Every comparison is exact unless it names a tolerance.
"""

import io
import json
import sys
import time

import numpy as np
import pytest

from ps_tpu_torch import obs
from ps_tpu_torch.config import Config
from ps_tpu_torch.obs.flight import FlightRecorder
from ps_tpu_torch.obs.metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
    state_add,
    state_sub,
)
from ps_tpu_torch.obs.trace import Tracer, merge_chrome
from ps_tpu_torch.utils.metrics import Meter, TransportStats
from ps_tpu_torch.utils.step_log import StepLogger

QTOL = 1e-12


def _samples(seed, n=5000, sigma=1.5):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(mean=-7, sigma=sigma, size=n)
    # the edges too: an underflow, an overflow and an exact bucket bound
    return np.concatenate([xs, [1e-9, 7200.0, 1e-6 * 2.0 ** 0.25]])


# -- histograms ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_state_and_quantiles_equal_the_reference(seed):
    from ps_tpu.obs.metrics import Histogram as RefHistogram

    xs = _samples(seed)
    h, r = Histogram("t_seconds"), RefHistogram("t_seconds")
    for x in xs:
        h.record(float(x))
        r.record(float(x))
    assert h.state() == r.state()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert h.quantile(q) == pytest.approx(r.quantile(q), rel=QTOL,
                                              abs=QTOL)
    assert h.summary() == r.summary()
    assert h.buckets() == r.buckets()
    back = Histogram.from_state("t_seconds", r.state())
    assert back.state() == h.state()


def test_histogram_state_merge_and_window_equal_the_reference():
    from ps_tpu.obs import metrics as ref

    a, b = Histogram("x"), Histogram("x")
    for x in _samples(3, 800):
        a.record(float(x))
    base = a.state()
    for x in _samples(4, 900):
        a.record(float(x))
        b.record(float(x) * 3)
    assert state_sub(a.state(), base) == ref.state_sub(a.state(), base)
    assert state_add(None, b.state()) == ref.state_add(None, b.state())
    assert state_add(a.state(), b.state()) == \
        ref.state_add(a.state(), b.state())
    with pytest.raises(ValueError, match="geometr"):
        state_add(a.state(), Histogram("y", hi=10.0).state())


@pytest.mark.parametrize("sigma", [0.5, 1.5])
def test_histogram_quantiles_match_numpy(sigma):
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-7, sigma=sigma, size=30_000)
    h = Histogram("t_seconds")
    for x in xs:
        h.record(x)
    for q in (0.5, 0.9, 0.99, 0.999):
        est, true = h.quantile(q), float(np.quantile(xs, q))
        assert true / 1.25 <= est <= true * 1.25, (q, est, true)
    assert h.summary()["count"] == len(xs)


def test_histogram_range_edges_and_sanitized_names():
    h = Histogram("t", lo=1e-6, hi=10.0)
    h.record(1e-9)
    h.record(100.0)
    assert h.total == 2 and h.counts[0] == 1 and h.counts[-1] == 1
    assert h.quantile(0.999) == pytest.approx(100.0)
    c = Counter("bad name-with.chars")
    assert c.name == "bad_name_with_chars"


def _fill(reg_cls, seed):
    reg = reg_cls()
    rng = np.random.default_rng(seed)
    c1 = reg.counter("ps_things_total", "things")
    c2 = reg.counter("ps_things_total")
    c1.inc(3)
    c2.inc(int(rng.integers(1, 9)))
    h1 = reg.histogram("ps_lat_seconds", "lat")
    h2 = reg.histogram("ps_lat_seconds")
    for x in rng.lognormal(-6, 1.0, 200):
        h1.record(float(x))
    for x in rng.lognormal(-4, 0.5, 50):
        h2.record(float(x))
    g = reg.gauge("ps_lag", "lag")
    g.set(float(rng.integers(0, 100)))
    reg.histogram("ps_silent_seconds", "never recorded")
    return reg, (c1, c2, h1, h2, g)


@pytest.mark.parametrize("seed", [0, 5])
def test_prometheus_text_is_byte_identical_to_the_reference(seed):
    from ps_tpu.obs.metrics import MetricsRegistry as RefRegistry

    port, keep_p = _fill(MetricsRegistry, seed)
    ref, keep_r = _fill(RefRegistry, seed)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert "ps_things_total" in text and '+Inf"} 250' in text


def test_transport_stats_quantiles_equal_the_reference():
    from ps_tpu.utils.metrics import TransportStats as RefStats

    port, ref = TransportStats(), RefStats()
    for t in (port, ref):
        r = np.random.default_rng(11)
        for _ in range(40):
            t.record_op("push", float(r.lognormal(-5, 1)))
            t.record_apply(float(r.lognormal(-7, 1)))
            t.record_repl_ack_wait(float(r.lognormal(-6, 1)))
            t.record_sparse_apply(3, float(r.lognormal(-8, 1)))
            t.record_bucket(1024, float(r.lognormal(-6, 0.5)))
            t.record_blocked(float(r.lognormal(-9, 0.5)))
            t.record_upcall(int(r.integers(1, 5)))
            t.record_read_age(float(r.lognormal(-3, 1)), bound=0.05)
            t.record_fresh_lag(float(r.lognormal(-8, 1)))
            t.record_read_gap(int(r.integers(0, 4)))
            t.record_cold_gather(float(r.lognormal(-6, 1)))
            t.record_agg_hold(float(r.lognormal(-4, 1)))
        t.record_failover(0.6)
    assert port.latency_quantiles() == ref.latency_quantiles()
    assert port.fresh_snapshot() == ref.fresh_snapshot()
    assert [k for k, _, _ in TransportStats.HIST_NAMES] == \
        [k for k, _, _ in RefStats.HIST_NAMES]
    assert port.metrics_snapshot()["lat"] == ref.metrics_snapshot()["lat"]
    # the histograms ride the process registry under the reference's names
    snap = obs.default_registry().snapshot()
    assert snap["ps_server_apply_seconds"]["count"] >= 40
    assert "ps_embed_cold_gather_seconds" in snap


def test_transport_stats_listener_sees_every_sample():
    t = TransportStats()
    got = []
    t.listener = lambda k, v: got.append((k, v))
    t.record_op("push", 0.5)
    t.record_op("nohist", 0.1)  # no histogram: ignored, as the reference
    t.record_apply(0.25)
    assert got == [("push_s", 0.5), ("apply_s", 0.25)]
    assert t.hist["push_s"].total == 1


def test_meter_equals_the_reference():
    from ps_tpu.utils.metrics import Meter as RefMeter

    m, r = Meter(window=8), RefMeter(window=8)
    assert m.rate() == r.rate() == 0.0
    rng = np.random.default_rng(2)
    t = 0.0
    for _ in range(20):
        t += float(rng.uniform(0.01, 0.2))
        n = float(rng.integers(1, 10))
        m.update(n, t=t)
        r.update(n, t=t)
        assert m.rate() == r.rate()
    m.reset()
    assert m.rate() == 0.0


# -- tracing ------------------------------------------------------------------


def test_tracer_off_path_is_noop_and_free():
    t = Tracer(sample=0.0)
    sp = t.span("push")
    assert not sp and sp.wire() is None and sp.ctx() is None
    assert sp is obs.NOOP
    with sp:
        assert t.current() is None
        assert not t.child("inner")
    assert t.spans() == []
    assert obs.from_wire({"x": 1}) is None
    assert obs.from_wire({"tc": ["a", "b"]}) == obs.TraceContext("a", "b")


def test_tracer_parentage_and_ring_bound():
    t = Tracer(sample=1.0, capacity=4)
    with t.span("root") as root:
        with t.child("inner") as inner:
            assert inner.parent_id == root.span_id
            assert inner.trace_id == root.trace_id
    follow = t.span("srv", parent=root.ctx())
    with follow:
        pass
    assert follow.parent_id == root.span_id
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    assert len(t.spans()) == 4 and t.dropped > 0


def _span_tree(tracer_cls):
    """The same span tree in a tracer of either package: a worker op, a
    server span parented across the wire, its apply child and a slow
    frame recorded from external stamps."""
    w = tracer_cls(service="w0", sample=1.0)
    s = tracer_cls(service="srv", sample=1.0)
    s.clock_offset_us = 250.0
    with w.span("push", cat="worker") as op:
        op.set(worker=0, pseq=1)
        with s.span("push", cat="server",
                    parent=op.ctx()).set(worker=0, role="primary") as sv:
            with s.child("server_apply", cat="server"):
                time.sleep(0.001)
            with s.child("replica_ack_wait", cat="server"):
                pass
    s.record_external("slow_frame", "server", sv.trace_id, sv.span_id,
                      ts_us=time.time() * 1e6, dur_us=12.5, conn=3,
                      wire_kind="PUSH", size=8, read_us=1.0, wait_us=2.0,
                      serve_us=3.0)
    return w, s


def _shape(events):
    """Names, categories, parentage (by name) and argument keys."""
    xs = [e for e in events if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e["name"] for e in xs}
    return sorted((e["name"], e["cat"],
                   by_id.get(e["args"]["parent_id"]),
                   tuple(sorted(e["args"]))) for e in xs)


def test_chrome_export_matches_the_reference(tmp_path):
    from ps_tpu.obs.trace import Tracer as RefTracer
    from ps_tpu.obs.trace import merge_chrome as ref_merge

    pw, ps_ = _span_tree(Tracer)
    rw, rs = _span_tree(RefTracer)
    port_events = pw.chrome_events() + ps_.chrome_events()
    ref_events = rw.chrome_events() + rs.chrome_events()
    assert _shape(port_events) == _shape(ref_events)
    assert len(_shape(port_events)) == 5
    # one trace across both tracers, the offset applied at export
    xs = [e for e in port_events if e["ph"] == "X"]
    assert len({e["args"]["trace_id"] for e in xs}) == 1
    raw = {s.span_id: s.ts_us for s in ps_.spans()}
    for e in ps_.chrome_events():
        if e["ph"] == "X":
            assert e["ts"] == raw[e["args"]["span_id"]] + 250.0
    p1 = pw.export_chrome(str(tmp_path / "w0.json"))
    p2 = ps_.export_chrome(str(tmp_path / "srv.json"))
    merged = json.load(open(merge_chrome([p1, p2],
                                         str(tmp_path / "all.json"))))
    r1 = rw.export_chrome(str(tmp_path / "rw0.json"))
    r2 = rs.export_chrome(str(tmp_path / "rsrv.json"))
    rmerged = json.load(open(ref_merge([r1, r2], str(tmp_path / "r.json"))))
    assert _shape(merged["traceEvents"]) == _shape(rmerged["traceEvents"])
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"w0", "srv"}


def test_tracer_sampling_rate_roots_only():
    t = Tracer(sample=0.5)
    import random

    random.seed(0)
    roots = [t.span("op") for _ in range(400)]
    kept = sum(1 for r in roots if r)
    assert 120 < kept < 280
    # a child of a propagated context is always recorded
    assert t.span("srv", parent=obs.TraceContext("t", "s"))


# -- flight recorder ----------------------------------------------------------


def test_flight_ring_and_dump_fields_match_the_reference(tmp_path):
    from ps_tpu.obs.flight import FlightRecorder as RefRecorder

    paths, recorders = [], []
    for cls, sub in ((FlightRecorder, "port"), (RefRecorder, "ref")):
        d = tmp_path / sub
        fr = cls(capacity=4, dir=str(d), service="t")
        recorders.append(fr)  # the registry holds its counters weakly
        for i in range(9):
            fr.record("failover", shard=i, addr="h:1", epoch=1,
                      seconds=0.5, cause="VanError()")
        assert fr.total == 9 and len(fr.events()) == 4
        assert fr.events()[-1]["shard"] == 8
        paths.append(fr.dump("unit test"))
    port = [json.loads(x) for x in open(paths[0])]
    ref = [json.loads(x) for x in open(paths[1])]
    assert [sorted(x) for x in port] == [sorted(x) for x in ref]
    assert port[0]["flight_dump"] == "unit test"
    assert port[0]["events"] == 4 and port[0]["events_total"] == 9
    assert [x["kind"] for x in port[1:]] == ["failover"] * 4
    # the per-kind counter family
    assert obs.default_registry().snapshot()["ps_event_failover_total"] >= 9


def test_flight_empty_dump_is_none(tmp_path):
    fr = FlightRecorder(dir=str(tmp_path))
    assert fr.dump("nothing") is None
    assert fr.dump("poke", empty_ok=True) is not None


def test_steplogger_event_mirrors_into_the_flight_recorder(tmp_path):
    fr = obs.flight()
    before = fr.total
    buf = io.StringIO()
    with StepLogger(every=1, jsonl=str(tmp_path / "run.jsonl"),
                    stream=buf) as log:
        log.event("failover", shard=2, seconds=0.5)
    assert fr.total == before + 1
    evt = fr.events()[-1]
    assert evt["kind"] == "failover" and evt["shard"] == 2
    rec = json.loads(open(tmp_path / "run.jsonl").read().splitlines()[-1])
    assert rec == {"event": "failover", "shard": 2, "seconds": 0.5}
    assert buf.getvalue() == "event failover  shard 2  seconds 0.5000\n"


def test_steplogger_tensorboard_writes_or_degrades(tmp_path, capsys):
    """``tensorboard=`` writes scalars where the package imports and says
    "tensorboard disabled" on stderr where it does not; the console and
    JSONL records are the same either way."""
    buf = io.StringIO()
    log = StepLogger(every=1, jsonl=str(tmp_path / "r.jsonl"),
                     tensorboard=str(tmp_path / "tb"), stream=buf)
    wrote = log._tb is not None
    try:
        assert log.wants(3)
        log.log(1, loss=0.5, steps=1)
    finally:
        log.close()
    if wrote:
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    else:
        assert "tensorboard disabled" in capsys.readouterr().err
    assert buf.getvalue().startswith("step      1  loss 0.5000")
    assert json.loads(open(tmp_path / "r.jsonl").read()) == \
        {"step": 1, "loss": 0.5, "steps": 1}


def test_steplogger_without_tensorboard_says_so(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = StepLogger(every=5, tensorboard=str(tmp_path / "tb"),
                     stream=io.StringIO())
    assert log._tb is None
    assert "StepLogger: tensorboard disabled" in capsys.readouterr().err
    log.log(5, loss=1.0)  # carries on
    log.close()


# -- config --------------------------------------------------------------------


def test_config_obs_knobs_from_env_match_the_reference(monkeypatch):
    from ps_tpu.config import Config as RefConfig

    env = {"PS_TRACE_SAMPLE": "0.25", "PS_TRACE_DIR": "/tmp/traces",
           "PS_METRICS_PORT": "9091", "PS_FLIGHT_EVENTS": "128",
           "PS_SLO_RULES": "push p99 < 10ms over 30s"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, ref = Config.from_env(), RefConfig.from_env()
    for f in ("trace_sample", "trace_dir", "metrics_port", "flight_events",
              "slo_rules"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.trace_sample == 0.25 and cfg.metrics_port == 9091
    monkeypatch.setenv("PS_METRICS_PORT", "")
    assert Config.from_env().metrics_port is None


@pytest.mark.parametrize("kwargs", [
    {"trace_sample": 1.5}, {"trace_sample": -0.1}, {"metrics_port": -1},
    {"flight_events": 0}, {"slo_rules": "push p99 < 10ms"},
    {"slo_rules": "warp p99 < 1ms over 5s"},
    {"slo_rules": "push p99 < 0ms over 5s"},
])
def test_config_obs_knob_validation_matches_the_reference(kwargs):
    from ps_tpu.config import Config as RefConfig

    with pytest.raises(ValueError) as ref:
        RefConfig(**kwargs)
    with pytest.raises(ValueError) as port:
        Config(**kwargs)
    assert str(port.value) == str(ref.value)


def test_config_apply_obs_configures_the_singletons(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_TRACE_DIR", ".")  # restored after the test
    t, f = obs.tracer(), obs.flight()
    old = (t.sample, f.dir, f.capacity)
    try:
        Config(trace_sample=0.5, trace_dir=str(tmp_path),
               flight_events=64).apply_obs()
        assert t.sample == 0.5 and f.dir == str(tmp_path)
        assert f.capacity == 64 and f._ring.maxlen == 64
    finally:
        obs.configure(sample=old[0], flight_events=old[2])
        f.dir = old[1]
