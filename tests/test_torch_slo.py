"""SLO rules, the straggler detector and the step breakdown of the port
(``ps_tpu_torch/obs/slo.py``, ``straggler.py``, ``breakdown.py``) against
the reference's on the same numpy-seeded inputs, on the CPU, without a
coordinator.

- ``parse_rules`` gives the reference's rules on the rule strings of
  ``tests/test_fleet_telemetry.py``, ``tests/test_obs.py`` and
  ``tests/test_freshness.py``, and the same errors on the bad ones.
- ``RegistryWindow`` (the port's window source over per-member histogram
  samples) answers the window quantiles and per-member means that the
  reference's coordinator store (``FleetTSDB``) answers on the same
  cumulative samples, exactly.
- ``SloEvaluator``: one seeded latency series, fed to the port's
  evaluator through a ``RegistryWindow`` and to the reference's through a
  ``FleetTSDB``, gives the same breach and recover sequence, states and
  flight events.
- ``StragglerDetector``: the same suspects, scores and hints from the
  same per-member series, a control fleet quiet.
- ``breakdown`` gives the reference's dict on the same summaries, and
  ``TraceBreakdown`` the same per-phase summaries on the same spans.
- Phase 24 (a)-(c) of ``chip_smoke.py``, on the CPU at the harness's
  small shape: traced ``sparse-server``/``sparse-worker`` processes whose
  push traces each resolve as one tree (merged on one clock, children
  inside their parents), /metrics counts equal to STATS at the pause,
  the tables bitwise a replay, the failover's flight events in each
  process's dump; and the aggregator's chain in one trace.
"""

import importlib.util
import os
import time

import numpy as np
import pytest

from ps_tpu_torch import obs
from ps_tpu_torch.obs.breakdown import TraceBreakdown, breakdown
from ps_tpu_torch.obs.metrics import Histogram
from ps_tpu_torch.obs.slo import (
    RegistryWindow,
    SloEvaluator,
    parse_rule,
    parse_rules,
)
from ps_tpu_torch.obs.straggler import StragglerDetector

RULES = [
    # tests/test_fleet_telemetry.py
    "push p99 < 10ms over 30s", "apply p999 <= 50us over 2m",
    "ps_custom_seconds p50 < 1s over 500ms",
    "push p99 < 10ms over 30s; pull p50 < 1ms over 5s",
    "apply p99 < 5ms over 10s; push p99 < 1s over 10s",
    # tests/test_freshness.py
    "freshness p99 < 500ms over 30s", "staleness p95 < 500ms over 30s",
    "read p99 < 25ms over 30s",
    "read p99 < 25ms over 30s; freshness p99 < 500ms over 30s",
    "freshness p99 < 5ms over 10s",
    # the remaining aliases, and blank specs
    "cycle p90 < 2ms over 1m; bucket p50 < 100us over 5s; "
    "ack p99 < 3ms over 10s; flush p999 < 1s over 30s; "
    "push_pull p99 < 20ms over 15s",
    None, "  ",
]
BAD = ["push faster please", "warp p99 < 1ms over 5s",
       "push p99 < 0ms over 5s", "push p0 < 1ms over 5s",
       "push p99 < 10ms"]


def _rule_tuple(r):
    return (r.text, r.metric, r.q, r.qlabel, r.threshold_s, r.window_s)


@pytest.mark.parametrize("spec", RULES)
def test_parse_rules_equals_the_reference(spec):
    from ps_tpu.obs.slo import parse_rules as ref_parse

    assert [_rule_tuple(r) for r in parse_rules(spec)] == \
        [_rule_tuple(r) for r in ref_parse(spec)]


@pytest.mark.parametrize("spec", BAD)
def test_bad_rules_raise_as_the_reference(spec):
    from ps_tpu.obs.slo import parse_rule as ref_parse

    with pytest.raises(ValueError) as ref:
        ref_parse(spec)
    with pytest.raises(ValueError) as port:
        parse_rule(spec)
    assert str(port.value) == str(ref.value)


# -- the window source -------------------------------------------------------


def _series(seed, members=3, rounds=6, n=40):
    """Per member, per round, a batch of latencies (seconds)."""
    rng = np.random.default_rng(seed)
    return [[rng.lognormal(-7 + 0.3 * m, 0.5, n) for m in range(members)]
            for _ in range(rounds)]


def _feed(series, metric, window, tsdb, t0, dt=1.0):
    """Record each round into cumulative histograms and sample both
    window sources with the same states at the same instants."""
    hists = {}
    for k, batch in enumerate(series):
        t = t0 + k * dt
        for m, xs in enumerate(batch):
            h = hists.setdefault(m, Histogram(metric))
            for x in xs:
                h.record(float(x))
            window.sample(f"m{m}", {metric: h}, now=t)
            tsdb.ingest(f"m{m}", {metric: {"k": "hist", **h.state()}}, t=t)
        yield t


def test_registry_window_equals_the_coordinator_store():
    from ps_tpu.obs.tsdb import FleetTSDB

    metric = "ps_server_apply_seconds"
    now = time.monotonic()
    win, db = RegistryWindow(window_s=2.5), FleetTSDB(window_s=2.5, ring=64)
    rounds = list(_feed(_series(0), metric, win, db, now - 5.0))
    assert rounds[-1] == pytest.approx(now)
    assert win.members() == db.members()
    for q in (0.5, 0.9, 0.99):
        assert win.quantile(metric, q, 2.5) == db.quantile(metric, q, 2.5)
        assert win.quantile(metric, q, 100.0) == \
            db.quantile(metric, q, 100.0)
    for m in win.members():
        assert win.member_mean(m, metric) == db.member_mean(m, metric)
    assert win.quantile("ps_push_seconds", 0.99) is None
    assert win.member_mean("m9", metric) is None


def test_registry_window_samples_the_process_registry():
    reg = obs.MetricsRegistry()
    h = reg.histogram("ps_push_seconds")
    win = RegistryWindow(window_s=10.0)
    for x in (0.001, 0.002):
        h.record(x)
    win.sample_registry("w0", registry=reg, now=0.0)
    for x in (0.5,) * 10:
        h.record(x)
    win.sample_registry("w0", registry=reg, now=20.0)
    # the window holds the ten slow pushes only (its quantile within one
    # sub-bucket: the window keeps the lifetime's extrema for its clamp)
    assert win.member_mean("w0", "ps_push_seconds", now=20.0) == \
        pytest.approx((0.5, 10))
    assert 0.5 / 2 ** 0.25 <= win.quantile("ps_push_seconds", 0.5,
                                           now=20.0) <= 0.5
    assert win.quantile("ps_push_seconds", 0.5, now=100.0) is None


# -- SLO evaluation -------------------------------------------------------------


def _slo_run(evaluator_cls, source_cls, recorder):
    """The same breach-and-recover series through one package: a window
    of slow pushes breaches, a flood of fast ones recovers."""
    metric = "ps_push_seconds"
    now = time.monotonic()
    src = source_cls(window_s=30.0) if source_cls is RegistryWindow \
        else source_cls(window_s=30.0, ring=16)
    ev = evaluator_cls(src, parse_rules(
        "push p99 < 5ms over 10s; apply p99 < 1s over 10s") if
        evaluator_cls is SloEvaluator else _ref_rules())
    rng = np.random.default_rng(4)
    h = Histogram(metric)
    phases = [rng.lognormal(np.log(0.02), 0.2, 60),     # slow: breach
              rng.lognormal(np.log(0.02), 0.2, 10),     # still burning
              rng.lognormal(np.log(0.0005), 0.2, 9000)]  # flood: recover
    out = []
    n0 = len(recorder().events())
    for k, xs in enumerate(phases):
        for x in xs:
            h.record(float(x))
        t = now - 2.0 + k
        if source_cls is RegistryWindow:
            src.sample("w0", {metric: h}, now=t)
        else:
            src.ingest("w0", {metric: {"k": "hist", **h.state()}}, t=t)
        out.append(ev.evaluate())
    events = [{k: v for k, v in e.items() if k not in ("t", "mono")}
              for e in recorder().events()[n0:]
              if e["kind"] in ("slo_breach", "slo_recover")]
    return out, events, ev.breached(), ev._m_breach.value


def _ref_rules():
    from ps_tpu.obs.slo import parse_rules as ref_parse

    return ref_parse("push p99 < 5ms over 10s; apply p99 < 1s over 10s")


def test_slo_evaluator_breaches_and_recovers_as_the_reference():
    import ps_tpu.obs as ref_obs
    from ps_tpu.obs.slo import SloEvaluator as RefEvaluator
    from ps_tpu.obs.tsdb import FleetTSDB

    port = _slo_run(SloEvaluator, RegistryWindow, obs.flight)
    ref = _slo_run(RefEvaluator, FleetTSDB, ref_obs.flight)
    assert port == ref
    states, events, breached, burned = port
    assert [s[0]["breached"] for s in states] == [True, True, False]
    assert all(s[1]["value_ms"] is None for s in states)  # no apply data
    assert [e["kind"] for e in events] == ["slo_breach", "slo_recover"]
    assert breached == []
    assert burned == 2  # ps_slo_breach_total: two evaluations in breach


# -- stragglers -----------------------------------------------------------------


def _straggler_run(detector_cls, source, means_by_round):
    metric = "ps_server_apply_seconds"
    det = detector_cls(source, z=3.0, min_members=3, min_count=3)
    now = time.monotonic()
    hists, out = {}, []
    for k, means in enumerate(means_by_round):
        t = now - len(means_by_round) * 0.5 + k * 0.5
        for m, mean in enumerate(means):
            h = hists.setdefault(m, Histogram(metric))
            for x in np.random.default_rng(k * 10 + m).normal(
                    mean, mean * 0.05, 20):
                h.record(float(x))
            if isinstance(source, RegistryWindow):
                source.sample(f"m{m}", {metric: h}, now=t)
            else:
                source.ingest(f"m{m}", {metric: {"k": "hist", **h.state()}},
                              t=t)
        out.append(det.evaluate({f"m{i}": i for i in range(len(means))}))
    return out, det.hints()


@pytest.mark.parametrize("rounds", [
    [(0.0010, 0.0012, 0.0011)] * 4,                     # control: quiet
    [(0.0010, 0.0012, 0.0011)] * 2 + [(0.001, 0.022, 0.001)] * 2,
    [(0.001, 0.001, 0.001, 0.001, 0.03)] * 3 + [(0.001,) * 5] * 3,
])
def test_straggler_detector_names_the_reference_suspects(rounds):
    from ps_tpu.obs.straggler import StragglerDetector as RefDetector
    from ps_tpu.obs.tsdb import FleetTSDB

    port = _straggler_run(StragglerDetector, RegistryWindow(window_s=1.0),
                          rounds)
    ref = _straggler_run(RefDetector, FleetTSDB(window_s=1.0, ring=32),
                         rounds)
    assert port == ref
    slow = [i for i, m in enumerate(rounds[-1]) if m > 0.005]
    assert [s["uri"] for s in port[0][-1]] == [f"m{i}" for i in slow]


# -- the breakdown ----------------------------------------------------------------


def _summaries(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m, mean in (("ps_cycle_seconds", 0.010), ("ps_blocked_seconds",
                                                   0.002),
                    ("ps_bucket_seconds", 0.0015),
                    ("ps_server_apply_seconds", 0.003),
                    ("ps_replica_ack_wait_seconds", 0.0007),
                    ("ps_agg_hold_seconds", 0.004),
                    ("ps_nl_read_hit_seconds", 0.00002)):
        h = Histogram(m)
        for x in rng.lognormal(np.log(mean), 0.4, int(rng.integers(50,
                                                                   400))):
            h.record(float(x))
        out[m] = dict(h.summary(), sum=h.sum)
    return out


@pytest.mark.parametrize("drop", [(), ("ps_cycle_seconds",),
                                  ("ps_bucket_seconds",),
                                  ("ps_cycle_seconds", "ps_push_pull_seconds",
                                   "ps_push_seconds", "ps_pull_seconds")])
def test_breakdown_equals_the_reference(drop):
    from ps_tpu.obs.breakdown import breakdown as ref_breakdown

    sums = {k: v for k, v in _summaries(1).items() if k not in drop}
    if "ps_cycle_seconds" in drop and len(drop) == 1:
        sums["ps_push_seconds"] = dict(sums["ps_bucket_seconds"])
    got = breakdown(lambda m: sums.get(m))
    assert got == ref_breakdown(lambda m: sums.get(m))
    if "total" in got:
        assert all(0.0 <= r["share"] <= 1.0 for p, r in got.items()
                   if p != "total")
    assert breakdown(lambda m: None) == {}


def test_trace_breakdown_equals_the_reference():
    from ps_tpu.obs.breakdown import TraceBreakdown as RefBreakdown

    rng = np.random.default_rng(3)

    def ev(name, cat, tid, dur_us, parent=None):
        return {"ph": "X", "name": name, "cat": cat, "dur": dur_us,
                "args": {"trace_id": tid, "parent_id": parent,
                         "span_id": f"{tid}-{name}"}}

    events = []
    for k in range(12):
        tid = f"t{k}"
        d = rng.uniform(0.5, 2.0, 6) * 1000
        events += [
            ev("push", "worker", tid, 10 * d[0]),
            ev("flush_wait", "worker", tid, d[1], parent=f"{tid}-push"),
            ev("row_push", "server", tid, 3 * d[2], parent=f"{tid}-push"),
            ev("server_apply", "server", tid, 2 * d[3],
               parent=f"{tid}-row_push"),
            ev("replica_ack_wait", "server", tid, d[4],
               parent=f"{tid}-row_push"),
            ev("agg_merge", "aggregator", tid, d[5],
               parent=f"{tid}-push"),
        ]
    events.append(ev("orphan", "server", "tx", 5.0))  # no worker root
    port, ref = TraceBreakdown(), RefBreakdown()
    assert port.feed(events) == ref.feed(events) == 12
    assert port.summary() == ref.summary()
    assert set(port.summary()) == set(TraceBreakdown.TRACE_PHASES)
    # live spans feed the same way
    t = obs.Tracer(sample=1.0)
    with t.span("push", cat="worker"):
        with t.child("server_apply", cat="server"):
            pass
    assert TraceBreakdown().feed(t.spans()) == 1


# -- the card's phase 24 at the small shape --------------------------------------


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_24_sparse_processes_trace_scrape_and_fail_over(tmp_path):
    import ps_tpu_torch

    cs = _chip_smoke()
    harness = cs._van_harness()
    # an earlier death in this process's ring is not the drill's
    obs.record_event("peer_dead", node=0, dead=[1])
    a = cs._obs_sparse(harness, str(tmp_path), device="cpu", shape="small")
    assert a["roots"] == cs.SPARSE_WORKERS * cs.OBS_TRACED
    assert a["serves"] >= a["roots"] and a["margin_us"] >= 0
    assert a["processes"] == 2 * cs.SPARSE_SHARDS + cs.SPARSE_WORKERS
    assert a["breakdown"]["server_apply"]["count"] == a["roots"]
    path = a["path"]
    assert path["op"]["share"] == 1.0
    assert sum(path[k]["share"] for k in (
        "client_wire", "serve_pre_apply", "server_apply",
        "replica_ack_wait", "serve_rest")) == pytest.approx(1.0, abs=1e-3)
    for m in a["scrape"]:
        assert m["ps_server_apply_seconds_count"] > 0
    f = a["flight"]
    assert 0 < f["watch"] <= f["promotion"] <= min(f["failovers"])
    assert f["peer_dead"] > 0
    assert not ps_tpu_torch.is_initialized()


def test_phase_24_aggregator_chain_on_the_cpu():
    cs = _chip_smoke()
    c = cs._obs_agg(cs._van_harness(), device="cpu")
    assert c["chain"][0] == "server_apply" and "agg_merge" in c["chain"]
    assert c["agg"]["count"] >= 2
