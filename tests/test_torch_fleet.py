"""The port's fleet telemetry (``ps_tpu_torch/obs/collector.py``,
``obs/tsdb.py`` and the coordinator's telemetry path) against the
reference's ``ps_tpu/obs``.

- The same inputs, made from a seed with numpy, through both packages:
  the raw histogram states, their merge and the fleet quantiles; the
  delta encoder's payloads (a metric that appears mid-stream, silence, a
  seq gap that forces a resync) and the decoder's rebuilt state;
  ``collect_telemetry`` of each package's ``TransportStats``; the time
  series' windows, rates, ring bound and pruning; its Prometheus text
  (byte for byte); the straggler detector and the SLO evaluator over it;
  the ``Config`` telemetry knobs from the environment.
- A port coordinator and a reference coordinator fed the same reports
  (COORD_REPORT frames with the same telemetry payloads) answer
  COORD_TELEMETRY with the same fleet quantiles, counters and members.
- The reference's drills on port services: a slowed member of three is
  named the straggler (and a quiet control names none), a dead
  coordinator leaves the data plane and local observability serving, a
  sparse member ships its apply histogram.

Tolerance: exact (equal values, equal bytes) everywhere but the drills,
which hold the reference's own gates.
"""

import json
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch import obs
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.config import Config
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.elastic import Coordinator, fetch_telemetry
from ps_tpu_torch.obs.collector import (DeltaDecoder, DeltaEncoder,
                                        collect_telemetry)
from ps_tpu_torch.obs.metrics import Histogram, state_add, state_sub
from ps_tpu_torch.obs.slo import SloEvaluator, parse_rules
from ps_tpu_torch.obs.straggler import StragglerDetector
from ps_tpu_torch.obs.tsdb import FleetTSDB
from ps_tpu_torch.utils.metrics import TransportStats


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


@pytest.fixture
def port_async():
    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                      num_workers=1, dc_lambda=0.0)


def _ref():
    """The reference's modules under the names the port uses."""
    from ps_tpu.obs import collector, metrics, slo, straggler, tsdb

    return {"Histogram": metrics.Histogram, "state_add": metrics.state_add,
            "state_sub": metrics.state_sub, "FleetTSDB": tsdb.FleetTSDB,
            "DeltaEncoder": collector.DeltaEncoder,
            "DeltaDecoder": collector.DeltaDecoder,
            "collect_telemetry": collector.collect_telemetry,
            "SloEvaluator": slo.SloEvaluator,
            "parse_rules": slo.parse_rules,
            "StragglerDetector": straggler.StragglerDetector}


PORT = {"Histogram": Histogram, "state_add": state_add,
        "state_sub": state_sub, "FleetTSDB": FleetTSDB,
        "DeltaEncoder": DeltaEncoder, "DeltaDecoder": DeltaDecoder,
        "collect_telemetry": collect_telemetry,
        "SloEvaluator": SloEvaluator, "parse_rules": parse_rules,
        "StragglerDetector": StragglerDetector}


def _both():
    return [("reference", _ref()), ("port", PORT)]


def _samples(seed, n=3000):
    rng = np.random.default_rng(seed)
    return [rng.lognormal(-7 + i, 0.8, n) for i in range(3)]


def _wire(payload):
    return json.loads(json.dumps(payload))


# -- raw-bucket states ----------------------------------------------------------


def test_hist_states_merge_and_fleet_quantiles_equal_the_reference():
    """Each member's raw state, their merge, the merged quantiles and the
    state difference are the reference's, value for value; the fleet p50
    is the pooled samples' (within the log2 bound), never the average of
    the members' p50s."""
    out = {}
    for name, m in _both():
        merged, states, p50s = None, [], []
        for xs in _samples(3):
            h = m["Histogram"]("ps_op_seconds")
            for x in xs:
                h.record(float(x))
            h.record(1e-9)   # underflow
            h.record(7200.0)  # overflow
            states.append(h.state())
            p50s.append(h.quantile(0.5))
            merged = m["state_add"](merged, h.state())
        hm = m["Histogram"].from_state("ps_op_seconds", merged)
        out[name] = (states, merged,
                     [hm.quantile(q) for q in (0.5, 0.9, 0.99, 0.999)],
                     m["state_sub"](merged, states[0]), p50s)
    assert _wire(out["port"][:4]) == _wire(out["reference"][:4])
    allx = np.concatenate(_samples(3))
    est = out["port"][2][0]
    true = float(np.quantile(allx, 0.5))
    assert true / 1.25 <= est <= true * 1.25
    assert abs(np.mean(out["port"][4]) - est) > 0.25 * est


# -- the delta wire -------------------------------------------------------------


class _FakeTransport:
    """The face ``collect_telemetry`` reads, in either package."""

    def __init__(self, hist_cls):
        self.hist = {"op_s": hist_cls("ps_op_seconds")}
        self.stale_epochs = 0
        self.dedup_hits = 0
        self.failovers = 0
        self.table_reroutes = 0


def _delta_script(m):
    """The reference's delta cases as one script: every payload and every
    rebuilt state, in order."""
    rng = np.random.default_rng(7)
    t = _FakeTransport(m["Histogram"])
    enc = m["DeltaEncoder"](lambda: m["collect_telemetry"](t))
    dec = m["DeltaDecoder"]()
    trail = []

    def step(lost=False):
        p = enc.snapshot()
        p = None if p is None else _wire(p)
        trail.append(("payload", p))
        if p is not None and not lost:
            trail.append(("state", dec.ingest(p)))

    t.hist["op_s"].record(float(rng.uniform(1e-4, 1e-1)))
    step()
    step()                       # nothing moved: no payload
    t.stale_epochs = 4           # a counter appears mid-stream
    t.hist["op_s"].record(0.02)
    step()
    t.hist["op_s"].record(0.02)  # one bucket moved
    step()
    t.table_reroutes = 2
    step(lost=True)              # lost on the wire
    t.hist["op_s"].record(0.5)
    step()                       # a gap: the decoder asks for a resync
    enc.force_full()
    t.hist["op_s"].record(0.001)
    step()
    dec2 = m["DeltaDecoder"]()   # a delta with no baseline resyncs too
    t.dedup_hits = 1
    p = _wire(enc.snapshot())
    trail.append(("payload", p))
    trail.append(("state", dec2.ingest(p)))
    return trail


def test_delta_payloads_and_rebuilt_states_equal_the_reference():
    ref, port = _delta_script(_ref()), _delta_script(PORT)
    assert port == ref
    states = [s for k, s in port if k == "state"]
    assert states[-2] is None or states[-1] is None  # the resync asks
    assert [s for k, s in port if k == "payload"][1] is None  # silence


def test_collect_telemetry_scopes_to_one_transport_as_the_reference():
    from ps_tpu.utils.metrics import TransportStats as RefStats

    got = {}
    for name, cls, m in (("reference", RefStats, _ref()),
                         ("port", TransportStats, PORT)):
        a, b = cls(), cls()
        a.record_apply(0.5)
        b.record_apply(0.001)
        a.record_table_reroute()
        got[name] = (m["collect_telemetry"](a), m["collect_telemetry"](b),
                     m["collect_telemetry"](
                         a, counters={"ps_applies_total": lambda: 7},
                         gauges={"ps_x": lambda: 1.5}))
    assert _wire(got["port"]) == _wire(got["reference"])
    sa, sb, extra = got["port"]
    assert sa["ps_server_apply_seconds"]["n"] == 1
    assert sb["ps_server_apply_seconds"]["s"] == pytest.approx(0.001)
    assert sa["ps_table_reroutes_total"] == {"k": "counter", "v": 1}
    assert extra["ps_applies_total"] == {"k": "counter", "v": 7}


# -- the time series ------------------------------------------------------------


def _hist_state(m, samples, name="ps_op_seconds"):
    h = m["Histogram"](name)
    for s in samples:
        h.record(float(s))
    return {"k": "hist", **h.state()}


def _tsdb_script(m, now):
    rng = np.random.default_rng(11)
    db = m["FleetTSDB"](window_s=10.0, ring=4)
    for i, v in enumerate((10, 20, 40, 80, 160, 320)):
        db.ingest("m0", {"c": {"k": "counter", "v": v}}, t=now - 5 + i)
    db.ingest("mr", {"c2": {"k": "counter", "v": 50_000}}, t=now)
    xs = rng.lognormal(-6, 1.0, 400)
    db.ingest("m0", {"h": _hist_state(m, xs[:200])}, t=now - 3)
    db.ingest("m0", {"h": _hist_state(m, xs)}, t=now)
    db.ingest("m2", {"h": _hist_state(m, rng.lognormal(-4, 0.5, 300))},
              t=now - 1)
    db.ingest("m2", {"g": {"k": "gauge", "v": 3.0}}, t=now)
    db.ingest("m1", {"h": _hist_state(m, [0.5])}, t=now - 100)
    out = {
        "ring": len(db._series[("m0", "c")]),
        "w_counter": db.window("m0", "c", window_s=2.5),
        "w_single": db.window("mr", "c2", window_s=2.5),
        "w_hist": db.window("m0", "h", window_s=10.0),
        "w_stale": db.window("m1", "h", window_s=10.0),
        "fleet_h": db.fleet_window("h", window_s=10.0),
        "fleet_g": db.fleet_window("g"),
        "q": [db.quantile("h", q, window_s=10.0)
              for q in (0.25, 0.5, 0.99)],
        "mean": db.member_mean("m2", "h", window_s=10.0),
        "members": db.members(), "metrics": db.metrics(),
        "prom": db.render_prometheus(),
    }
    db.drop_member("m0")
    out["after_drop"] = (db.members(), ("m0", "h") in db._series)
    return out


def test_tsdb_windows_rates_quantiles_and_prometheus_equal_the_reference():
    """Both stores fed the same cumulative samples at the same instants:
    every window (counter delta and rate, a single sample's zero delta, a
    histogram's raw delta and summary, a member quiet for three windows),
    the fleet merge, its quantiles, a member's mean, the ring bound, the
    pruning and the Prometheus text, byte for byte."""
    now = time.monotonic()
    ref, port = _tsdb_script(_ref(), now), _tsdb_script(PORT, now)
    assert port["prom"] == ref["prom"]
    assert _wire(port) == _wire(ref)
    assert port["ring"] == 4 and port["w_stale"] is None
    assert port["w_single"]["delta"] == 0.0
    assert port["w_hist"]["state"]["n"] == 200
    assert 'member="m2"' in port["prom"] and 'q="p99"' in port["prom"]
    assert port["after_drop"] == (["m1", "m2", "mr"], False)


def _seed_members(m, db, means, t, n=20, prev=None):
    prev = prev or {}
    for i, mean in enumerate(means):
        h = prev.get(i)
        if h is None:
            h = prev[i] = m["Histogram"]("ps_server_apply_seconds")
        for _ in range(n):
            h.record(mean)
        db.ingest(f"m{i}", {"ps_server_apply_seconds":
                            {"k": "hist", **h.state()}}, t=t)
    return prev


def _signals_script(m, now):
    """The straggler detector and the SLO evaluator over a FleetTSDB, the
    reference's cases in one script."""
    db = m["FleetTSDB"](window_s=10.0, ring=32)
    det = m["StragglerDetector"](db, z=3.0, min_members=3, min_count=3)
    shards = {f"m{i}": i for i in range(3)}
    trail = []
    prev = _seed_members(m, db, (0.0010, 0.0012, 0.0011), now - 2)
    for k in range(4):
        prev = _seed_members(m, db, (0.0010, 0.0012, 0.0011),
                             now - 1.5 + k * 0.5, prev=prev)
        trail.append(det.evaluate(shards))
    prev = _seed_members(m, db, (0.001, 0.022, 0.001), now, prev=prev)
    trail.append(det.evaluate(shards))
    trail.append(det.evaluate(shards))
    trail.append([{k: v for k, v in h.items() if k != "t"}
                  for h in det.hints()])
    db2 = m["FleetTSDB"](window_s=30.0, ring=8)
    ev = m["SloEvaluator"](db2, m["parse_rules"](
        "apply p99 < 5ms over 10s; push p99 < 1s over 10s"))
    db2.ingest("m0", {"ps_server_apply_seconds": _hist_state(
        m, [0.050] * 50, "ps_server_apply_seconds")}, t=now)
    trail.append(ev.evaluate())
    trail.append(ev.evaluate())
    db2.ingest("m0", {"ps_server_apply_seconds": _hist_state(
        m, [0.050] * 50 + [0.0001] * 10_000, "ps_server_apply_seconds")},
        t=now + 0.5)
    trail.append(ev.evaluate())
    trail.append(ev.breached())
    return trail


def test_straggler_and_slo_over_the_tsdb_equal_the_reference():
    """The detector and the evaluator take the coordinator's FleetTSDB
    (not only a RegistryWindow): a quiet control names no suspect over
    four windows, a member twenty times slower is named once, its hint
    says so; an SLO breach, its persistence and its recovery; each the
    reference's, value for value."""
    now = time.monotonic()
    ref, port = _signals_script(_ref(), now), _signals_script(PORT, now)
    assert _wire(port) == _wire(ref)
    assert port[:4] == [[], [], [], []]
    assert [s["uri"] for s in port[4]] == ["m1"]
    assert port[6][0]["shard"] == 1
    breach = {s["rule"]: s for s in port[7]}["apply p99 < 5ms over 10s"]
    assert breach["breached"]
    assert port[-1] == []


def test_config_telemetry_knobs_and_errors_equal_the_reference(monkeypatch):
    from ps_tpu.config import Config as RefConfig

    for cls in (Config, RefConfig):
        with pytest.raises(ValueError, match="unparseable"):
            cls(slo_rules="nonsense here")
        for kw, match in (({"telemetry_ring": 1}, "telemetry_ring"),
                          ({"telemetry_window_s": 0}, "telemetry_window_s"),
                          ({"telemetry_straggler_z": 0}, "straggler_z")):
            with pytest.raises(ValueError, match=match):
                cls(**kw)
    monkeypatch.setenv("PS_TELEMETRY", "0")
    monkeypatch.setenv("PS_TELEMETRY_WINDOW_S", "12.5")
    monkeypatch.setenv("PS_TELEMETRY_RING", "64")
    monkeypatch.setenv("PS_TELEMETRY_STRAGGLER_Z", "4.5")
    monkeypatch.setenv("PS_SLO_RULES", "push p99 < 10ms over 30s")
    fields = ("telemetry", "telemetry_window_s", "telemetry_ring",
              "telemetry_straggler_z", "slo_rules")
    port, ref = Config.from_env(), RefConfig.from_env()
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields] == \
        [False, 12.5, 64, 4.5, "push p99 < 10ms over 30s"]
    monkeypatch.setenv("PS_SLO_RULES", "")
    assert Config.from_env().slo_rules is None


# -- the coordinator's telemetry ------------------------------------------------


def test_coordinator_telemetry_reply_equals_the_reference():
    """The same COORD_REPORT frames (delta-encoded telemetry of three
    members, one with a resync in the middle) into a port and a reference
    coordinator: the replies to each report and the COORD_TELEMETRY fleet
    quantiles, counters, per-member summaries and breakdown are equal."""
    from ps_tpu.elastic import Coordinator as RefCoordinator

    rng = np.random.default_rng(21)
    hists = [[Histogram("ps_server_apply_seconds"),
              Histogram("ps_push_pull_seconds")] for _ in range(3)]
    rounds = []  # four rounds of reports; member 1 loses one
    encs = [DeltaEncoder(lambda i=i: {
        h.name: {"k": "hist", **h.state()} for h in hists[i]
        if h.total}) for i in range(3)]
    for r in range(4):
        frame = []
        for i in range(3):
            for h in hists[i]:
                for x in rng.lognormal(-7 + i, 0.5, 50):
                    h.record(float(x))
            p = encs[i].snapshot()
            if (r, i) == (1, 1):
                continue  # a lost report: the next delta leaves a gap
            frame.append({"uri": f"127.0.0.1:{9100 + i}",
                          "telemetry": _wire(p)})
            if (r, i) == (2, 1):
                encs[i].force_full()  # the member's answer to the resync
        rounds.append(frame)
    replies = {}
    for name, cls in (("reference", RefCoordinator), ("port", Coordinator)):
        coord = cls(bind="127.0.0.1", telemetry_window_s=60.0)
        ch = tv.Channel.connect("127.0.0.1", coord.port)
        try:
            got = []
            for frame in rounds:
                for extra in frame:
                    _, _, _, rx = tv.decode(ch.request(tv.encode(
                        tv.COORD_REPORT, 0, None, extra=extra)))
                    got.append(rx)
            tel = fetch_telemetry(f"127.0.0.1:{coord.port}")
            got.append({k: tel[k] for k in ("members", "fleet", "counters",
                                            "per_member", "breakdown",
                                            "stragglers", "window_s")})
            replies[name] = got
        finally:
            ch.close()
            coord.stop()
    assert replies["port"] == replies["reference"]
    assert any(r.get("telemetry_resync") for r in replies["port"][:-1])
    assert replies["port"][-1]["fleet"]["ps_server_apply_seconds"][
        "count"] > 0


def _fleet(coord_addr, params, nshards=3):
    keys = sorted(params)
    per = len(keys) // nshards
    svcs = []
    for s in range(nshards):
        st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1,
                                  mode="async")
        st.init({k: params[k] for k in keys[s * per:(s + 1) * per]})
        svcs.append(AsyncPSService(st, bind="127.0.0.1",
                                   coordinator=coord_addr))
    return svcs


def _straggler_events():
    return [e for e in obs.flight().events()
            if e["kind"] == "straggler_suspect"]


def test_straggler_drill_localizes_slowed_member(port_async):
    """The reference's drill on port shards: three members, one's apply
    slowed 25 ms: its suspect event, hint and counter name it; the
    control phase before names none; COORD_TELEMETRY serves the fleet
    quantiles and the breakdown, and /metrics the fleet series until the
    coordinator stops."""
    coord = Coordinator(port=0, report_ms=100, telemetry_window_s=2.0)
    caddr = f"127.0.0.1:{coord.port}"
    params = {f"p{i}/w": torch.full((64, 8), 0.5) for i in range(6)}
    svcs = _fleet(caddr, params)
    w = connect_async(None, 0, params, coordinator=caddr)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
        events0 = len(_straggler_events())
        evals0 = coord.straggler.evaluations
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.0:
            w.push_pull(grads)
        time.sleep(0.3)
        assert coord.straggler.evaluations - evals0 >= 2
        assert len(_straggler_events()) == events0
        assert coord.straggler.suspects() == []
        slow = svcs[1]
        orig = slow._engine.push_tree

        def crawling(*a, **kw):
            time.sleep(0.025)
            return orig(*a, **kw)

        slow._engine.push_tree = crawling
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.5:
            w.push_pull(grads)
        time.sleep(0.3)
        suspects = coord.straggler.suspects()
        assert len(suspects) == 1, suspects
        assert suspects[0]["uri"] == f"127.0.0.1:{slow.port}"
        assert suspects[0]["metric"] == "ps_server_apply_seconds"
        new = _straggler_events()[events0:]
        assert new and new[-1]["uri"] == f"127.0.0.1:{slow.port}"
        hints = [h for h in coord.hints() if h["kind"] == "straggler"]
        assert hints and hints[0]["shard"] == 1
        tel = fetch_telemetry(caddr)
        assert f"127.0.0.1:{slow.port}" in tel["members"]
        assert tel["fleet"]["ps_server_apply_seconds"]["count"] > 0
        assert tel["breakdown"]["total"]["count"] > 0
        assert tel["stragglers"][0]["shard"] == 1
        assert "ps_fleet_server_apply_seconds_bucket" in \
            obs.default_registry().render_prometheus()
    finally:
        w.close()
        for s in svcs:
            s.stop()
        coord.stop()
    assert "ps_fleet_server_apply_seconds_bucket" not in \
        obs.default_registry().render_prometheus()


def test_dead_coordinator_degrades_to_local_observability(port_async):
    """A coordinator that dies mid-run leaves pushes landing and the
    members' own histograms recording; the reporters go quiet."""
    coord = Coordinator(port=0, report_ms=100)
    caddr = f"127.0.0.1:{coord.port}"
    params = {f"p{i}/w": torch.full((16, 4), 0.5) for i in range(3)}
    svcs = _fleet(caddr, params, nshards=3)
    w = connect_async(None, 0, params, coordinator=caddr)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
        w.push_pull(grads)
        coord.kill()
        time.sleep(0.35)
        before = svcs[0].transport.hist["apply_s"].total
        for _ in range(5):
            w.push_pull(grads)
        assert svcs[0].transport.hist["apply_s"].total > before
        assert svcs[0].transport.latency_quantiles()["apply_s"]["count"] > 0
        assert w.version == 3 * 6
    finally:
        w.close()
        for s in svcs:
            s.stop()


def test_sparse_member_ships_telemetry():
    """A sparse shard's apply histogram reaches the coordinator's time
    series under its uri."""
    from ps_tpu_torch.backends.remote_sparse import (SparsePSService,
                                                     connect_sparse)
    from ps_tpu_torch.kv.sparse import SparseEmbedding

    ps_tpu_torch.init(backend="cuda", device="cpu")
    coord = Coordinator(port=0, report_ms=100, telemetry_window_s=5.0)
    caddr = f"127.0.0.1:{coord.port}"
    emb = SparseEmbedding(32, 4, optimizer="sgd", learning_rate=0.1)
    emb.init(np.random.default_rng(5).normal(0, 0.01, (32, 4))
             .astype(np.float32))
    svc = SparsePSService({"t": emb}, bind="127.0.0.1", coordinator=caddr)
    try:
        wk = connect_sparse(None, 0, {"t": (32, 4)}, coordinator=caddr)
        try:
            ids = np.arange(8, dtype=np.int32)
            grads = np.full((8, 4), 0.01, np.float32)
            t0 = time.monotonic()
            while time.monotonic() - t0 < 0.5:
                wk.push({"t": (ids, grads)})
            time.sleep(0.3)
            uri = f"127.0.0.1:{svc.port}"
            assert uri in coord.tsdb.members()
            win = coord.tsdb.window(uri, "ps_server_apply_seconds")
            assert win is not None and win["state"]["n"] > 0
        finally:
            wk.close()
    finally:
        svc.stop()
        coord.stop()
