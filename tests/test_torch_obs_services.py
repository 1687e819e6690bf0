"""The port's observability hooks on live services, in one process on the
CPU (ROADMAP item 6.1), against the reference's services and tools.

- Traces cross the two packages both ways: a traced port worker's push
  into the reference's ``AsyncPSService`` and a traced reference worker's
  into a port primary/backup pair give one trace, the server span parented
  to the other side's worker span, the apply, the backup's replica append
  and the sync ack wait in it. The sparse PS's chain (worker -> primary
  -> ``server_apply`` -> backup) and the two-level chain (worker ->
  aggregator's ``agg_merge`` -> shard's ``server_apply``) resolve the
  same way, and ``TraceBreakdown`` takes them apart.
- An untraced port frame is byte-identical to the reference's for the
  same op; a traced one differs by its ``"tc"`` only.
- Flight events: the failover path records ``failover`` and
  ``promotion``, a dead backup ``repl_degraded``; an unhandled port
  ``VanError`` in a thread dumps the ring, other exceptions do not; the
  slow-frame drill links a ``slow_frame`` event and its span to the
  frame's trace (waiting on the events, never on the loop's counter).
- ``/metrics`` on a live port service parses as Prometheus text with the
  pushes counted; ``tools/ps_top.py --once --json`` against a port pair
  gives the keys it gives against a reference pair.

The coordinator's fleet telemetry is tested in
``tests/test_torch_fleet.py``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ps_tpu_torch
from ps_tpu_torch import obs
from ps_tpu_torch.backends.aggregator import AggregatorService
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.backends.remote_sparse import SparsePSService, connect_sparse
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs.breakdown import TraceBreakdown
from ps_tpu_torch.obs.flight import FlightRecorder
from ps_tpu_torch.obs.http import MetricsServer
from tests import test_torch_van_harness as harness
from tests.test_torch_aggregation import FAN_IN, _group_rounds, _job
from tests.test_torch_aggregation import _params as _agg_params
from tests.test_torch_aggregation import _Recorder
from tests.test_torch_replica import (
    SPEC,
    _grads,
    _jnp,
    _params,
    _port_init,
    _port_store,
    _ref_init,
    _ref_store,
    _sparse_push,
    _t,
    _uri,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    import ps_tpu

    for pkg in (ps_tpu_torch, ps_tpu):
        if pkg.is_initialized():
            pkg.shutdown()
    yield
    for pkg in (ps_tpu_torch, ps_tpu):
        if pkg.is_initialized():
            pkg.shutdown()


@pytest.fixture
def traced():
    """Both packages' process tracers sampling every root for one test,
    emptied before and after (other tests keep the off path)."""
    import ps_tpu.obs as ref_obs

    tracers = (obs.tracer(), ref_obs.tracer())
    old = [t.sample for t in tracers]
    for t in tracers:
        t.clear()
        t.sample = 1.0
    yield tracers
    for t, s in zip(tracers, old):
        t.sample = s
        t.clear()


def _by_id(spans):
    return {s.span_id: s for s in spans}


def _chain(span, by_id):
    """The names from ``span`` up to its root."""
    out = []
    while span is not None:
        out.append(span.name)
        span = by_id.get(span.parent_id)
    return out


# -- traces across the packages -------------------------------------------------


def test_port_worker_traced_into_reference_service(traced):
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    port_t, ref_t = traced
    params = _params()
    _ref_init()
    svc = RefService(_ref_store(params))
    _port_init()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _t(params))
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
    finally:
        w.close()
        svc.stop()
    wk = [s for s in port_t.spans()
          if s.cat == "worker" and s.name == "push_pull"]
    assert len(wk) == 1
    srv = [s for s in ref_t.spans() if s.cat == "server"
           and s.name == "push_pull" and s.parent_id == wk[0].span_id]
    assert len(srv) == 1 and srv[0].trace_id == wk[0].trace_id
    applies = [s for s in ref_t.spans() if s.name == "server_apply"
               and s.parent_id == srv[0].span_id]
    assert len(applies) == 1


def test_reference_worker_traced_into_port_pair(traced):
    """The reference's worker, a port primary and its sync backup: one
    trace, worker -> serve span -> server_apply -> the backup's
    replica_append, and the primary's replica_ack_wait under its serve
    span (the reference's ``test_trace_roundtrip_through_push_pull_
    replica`` with the port on the server side)."""
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    port_t, ref_t = traced
    params = _params()
    _port_init()
    prim = AsyncPSService(_port_store(params))
    back = AsyncPSService(_port_store(params), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    _ref_init()
    w = ref_connect(_uri(prim, back), 0, _jnp(params), failover_timeout=10.0)
    try:
        w.pull_all()
        w.push_pull(_jnp(_grads(params)))
    finally:
        w.close()
        back.stop()
        prim.stop()
    wk = [s for s in ref_t.spans()
          if s.cat == "worker" and s.name == "push_pull"]
    assert len(wk) == 1
    spans = port_t.spans()
    srv = [s for s in spans if s.cat == "server" and s.name == "push_pull"
           and s.parent_id == wk[0].span_id]
    assert len(srv) == 1 and srv[0].args["role"] == "primary"
    applies = [s for s in spans if s.name == "server_apply"
               and s.parent_id == srv[0].span_id]
    assert len(applies) == 1
    chain = {srv[0].span_id, applies[0].span_id}
    appends = [s for s in spans if s.name == "replica_append"
               and s.parent_id in chain]
    assert len(appends) >= 2  # the push record and the pull record
    assert all(s.args["role"] == "backup" for s in appends)
    acks = [s for s in spans if s.name == "replica_ack_wait"
            and s.parent_id == srv[0].span_id]
    assert acks
    assert {s.trace_id for s in srv + applies + appends + acks} == \
        {wk[0].trace_id}
    pulls = [s for s in ref_t.spans() if s.name == "pull"]
    assert pulls and pulls[0].trace_id != wk[0].trace_id


@pytest.mark.parametrize("bucket_bytes", [None, 256])
def test_sparse_push_resolves_one_tree_across_primary_and_backup(
        traced, bucket_bytes):
    port_t, _ = traced
    ps_tpu_torch.init(backend="cuda", device="cpu")
    prim = SparsePSService(harness.sparse_tables("small", 0, 1))
    back = SparsePSService(harness.sparse_tables("small", 0, 1), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = connect_sparse(_uri(prim, back), 0, SPEC, bucket_bytes=bucket_bytes,
                       failover_timeout=10.0)
    try:
        for c in range(3):
            w.push(_sparse_push(c))
    finally:
        w.close()
        back.stop()
        prim.stop()
    spans = port_t.spans()
    by_id = _by_id(spans)
    roots = [s for s in spans if s.cat == "worker" and s.name == "push"]
    assert len(roots) == 3
    serve = "row_push" if bucket_bytes is None else "row_bucket_push"
    for root in roots:
        tree = [s for s in spans if s.trace_id == root.trace_id]
        apply_ = [s for s in tree if s.name == "server_apply"]
        assert len(apply_) == 1
        assert _chain(apply_[0], by_id) == ["server_apply", serve, "push"]
        app = [s for s in tree if s.name == "replica_append"]
        assert len(app) == 1 and app[0].parent_id == apply_[0].span_id
        ack = [s for s in tree if s.name == "replica_ack_wait"]
        assert len(ack) == 1
        assert by_id[ack[0].parent_id].name == serve
        # every span of the trace reaches the worker's root
        assert all(_chain(s, by_id)[-1] == "push" for s in tree)
    tb = TraceBreakdown()
    assert tb.feed(spans) == 3
    s = tb.summary()
    assert s["server_apply"]["count"] == 3 and s["ack_wait"]["count"] == 3


def test_trace_chain_worker_aggregator_shard_resolves(traced):
    """A traced member push threads one trace through every hop: the
    member's op -> the aggregator's serve span -> ``agg_merge`` (naming
    every member's trace) -> the upstream op -> the shard's serve span ->
    ``server_apply``, which names the members' contexts; the breakdown
    has an ``agg`` phase."""
    port_t, _ = traced
    store, svc, uri = _job()
    agg = AggregatorService(uri, _agg_params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _agg_params(),
                        aggregator=f"127.0.0.1:{agg.port}")
          for w in range(FAN_IN)]
    try:
        _group_rounds(ws, range(1))
    finally:
        for w in ws:
            w.close()
        agg.stop()
        svc.stop()
    spans = port_t.spans()
    by_id = _by_id(spans)
    applies = [s for s in spans if s.name == "server_apply"]
    assert len(applies) == 1
    mtc = applies[0].args.get("members_tc")
    assert mtc and len(mtc) == FAN_IN
    cats, cur = [], applies[0]
    while cur is not None:
        cats.append(cur.cat)
        cur = by_id.get(cur.parent_id)
    assert "aggregator" in cats and cats[-1] == "worker", cats
    merge = [s for s in spans if s.name == "agg_merge"]
    assert len(merge) == 1 and merge[0].trace_id == applies[0].trace_id
    assert sorted(merge[0].args["member_traces"]) == \
        [str(w) for w in range(FAN_IN)]
    tb = TraceBreakdown()
    assert tb.feed(spans) >= 1
    assert tb.summary()["agg"]["count"] >= 1


# -- the bytes ----------------------------------------------------------------


def _captured(connect, params, grads, kinds, sampled, bucket_bytes=None):
    """Drive one worker (either package's) through a recording proxy in
    front of a port service: pull, push_pull, push; returns its data
    frames of ``kinds``."""
    _port_init()
    svc = AsyncPSService(_port_store(_params()))
    rec = _Recorder(svc.port)
    try:
        w = connect(f"127.0.0.1:{rec.port}", 0, params,
                    bucket_bytes=bucket_bytes,
                    pool_size=1 if bucket_bytes else None)
        w._transport_nonce = "nonce"
        for t in sampled:
            t.sample = 1.0
        try:
            w.pull_all()
            w.push_pull(grads)
            w.push_all(grads)
        finally:
            for t in sampled:
                t.sample = 0.0
            w.close()
        return [f for f in rec.frames if f[0] in kinds]
    finally:
        rec.close()
        svc.stop()
        ps_tpu_torch.shutdown()


@pytest.mark.parametrize("bucket_bytes", [None, 64])
def test_untraced_frames_are_the_reference_bytes_and_traced_add_tc(
        bucket_bytes):
    """The port's and the reference's workers, same tree and nonce: the
    untraced PULL, PUSH_PULL and PUSH frames (bucketed: every bucket) are
    byte for byte the reference's; traced, each carries ``"tc"`` as
    ``[trace_id, span_id]`` and is otherwise the reference's frame."""
    import ps_tpu.obs as ref_obs
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    params, grads = _params(), _grads(_params())
    kinds = ({tv.PULL, tv.PUSH_PULL, tv.PUSH} if bucket_bytes is None
             else {tv.BUCKET_PUSH, tv.BUCKET_PULL})
    frames = {}
    for traced_run in (False, True):
        _ref_init()
        ref = _captured(ref_connect, _jnp(params), _jnp(grads), kinds,
                        [ref_obs.tracer()] if traced_run else [],
                        bucket_bytes)
        import ps_tpu

        ps_tpu.shutdown()
        port = _captured(connect_async, _t(params), _t(grads), kinds,
                         [obs.tracer()] if traced_run else [], bucket_bytes)
        frames[traced_run] = (port, ref)
    port, ref = frames[False]
    assert len(port) == len(ref) >= 3
    assert port == ref
    for f in port:
        assert obs.WIRE_KEY not in tv.decode(memoryview(f))[3]
    port, ref = frames[True]
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        kp, wp, tp, ep = tv.decode(memoryview(p))
        kr, wr, tr, er = tv.decode(memoryview(r))
        assert (kp, wp) == (kr, wr)
        assert list(ep) == list(er)  # the same keys, in the same order
        tc = ep.pop(obs.WIRE_KEY)
        assert isinstance(tc, list) and len(tc) == 2
        er.pop(obs.WIRE_KEY)
        assert ep == er
        assert sorted(tp or {}) == sorted(tr or {})
        for k in tp or {}:
            np.testing.assert_array_equal(np.asarray(tp[k]),
                                          np.asarray(tr[k]))
    obs.tracer().clear()
    ref_obs.tracer().clear()


# -- flight events --------------------------------------------------------------


def test_failover_paths_record_flight_events():
    """Kill, promote, re-route: the worker's ``failover`` and the
    backup's ``promotion`` are in the ring, in that order of cause."""
    params = _params()
    _port_init()
    fr = obs.flight()
    n0 = len(fr.events())
    prim = AsyncPSService(_port_store(params))
    back = AsyncPSService(_port_store(params), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    baddr = f"127.0.0.1:{back.port}"
    w = connect_async(_uri(prim, back), 0, _t(params), failover_timeout=10.0)
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
        prim.kill()
        back.promote(reason="drill")
        w.push_pull(_t(_grads(params)))
    finally:
        w.close()
        back.stop()
    events = fr.events()[n0:]
    kinds = [e["kind"] for e in events]
    assert "promotion" in kinds and "failover" in kinds
    promo = next(e for e in events if e["kind"] == "promotion")
    assert promo["reason"] == "drill" and promo["epoch"] == 1
    fo = next(e for e in events if e["kind"] == "failover")
    assert fo["shard"] == 0 and fo["epoch"] == 1
    assert fo["addr"] == baddr


def test_dead_backup_degrade_records_flight_event():
    params = _params()
    _port_init()
    fr = obs.flight()
    n0 = len(fr.events())
    prim = AsyncPSService(_port_store(params))
    back = AsyncPSService(_port_store(params), backup=True)
    sess = prim.attach_backup("127.0.0.1", back.port, ack="sync")
    baddr = f"127.0.0.1:{back.port}"
    w = connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
        back.kill()  # the backup dies: the primary degrades, never wedges
        deadline = time.monotonic() + 10
        while not sess.degraded and time.monotonic() < deadline:
            w.push_pull(_t(_grads(params)))
        assert sess.degraded
    finally:
        w.close()
        prim.stop()
        back.stop()
    evt = [e for e in fr.events()[n0:] if e["kind"] == "repl_degraded"]
    assert len(evt) == 1 and evt[0]["backup"] == baddr
    assert evt[0]["fenced"] is False


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_unhandled_port_vanerror_in_thread_dumps_the_ring(tmp_path):
    fr = FlightRecorder(capacity=16, dir=str(tmp_path), service="boom")
    old_sys, old_thread = sys.excepthook, threading.excepthook
    proc = obs.flight()  # the process recorder's hooks fire too
    old_dir, proc.dir = proc.dir, str(tmp_path)
    try:
        fr.install()
        fr.record("stale_epoch", worker=1)
        done = threading.Event()
        inner = threading.excepthook

        def hook(args):
            inner(args)
            done.set()

        threading.excepthook = hook

        def die():
            raise tv.VanError("pump thread lost its peer")

        t = threading.Thread(target=die, name="doomed")
        t.start()
        t.join(5)
        assert done.wait(5)
        dumps = sorted(tmp_path.glob("flight-boom-*.jsonl"))
        assert dumps, "no flight dump after an unhandled VanError"
        lines = [json.loads(x) for x in open(dumps[-1])]
        assert "VanError" in lines[0]["flight_dump"]
        assert "doomed" in lines[0]["flight_dump"]
        assert lines[1]["kind"] == "stale_epoch"
    finally:
        sys.excepthook, threading.excepthook = old_sys, old_thread
        proc.dir = old_dir


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_other_exceptions_do_not_dump(tmp_path):
    """Neither a plain error nor the reference's own ``VanError`` (another
    class) makes the port's recorder dump."""
    from ps_tpu.control.tensor_van import VanError as RefVanError

    fr = FlightRecorder(capacity=4, dir=str(tmp_path), service="quiet")
    old_sys, old_thread = sys.excepthook, threading.excepthook
    try:
        fr.install()
        fr.record("reconnect")

        def ref_die():
            raise RefVanError("another package's error")

        for fn in (lambda: 1 / 0, ref_die):
            t = threading.Thread(target=fn)
            t.start()
            t.join(5)
        assert not list(tmp_path.glob("flight-quiet-*.jsonl"))
    finally:
        sys.excepthook, threading.excepthook = old_sys, old_thread


def test_slow_frame_drill_links_the_event_to_its_trace(monkeypatch):
    """A PUSH that sleeps on the pump makes the next traced READ's queue
    wait cross a 5 ms bar: the ``slow_frame`` event names the connection
    and kind with its stage timings and the READ's trace id, and its span
    parents to the READ's context. The test waits on the two surfaces the
    pump writes, never on the loop thread's counter."""
    monkeypatch.setenv("PS_NL_SLOW_FRAME_MS", "5")
    params = _params()
    _port_init()
    svc = AsyncPSService(_port_store(params), native_loop=True)
    assert svc.native_loop
    orig = svc._handle

    def slow_handle(kind, worker, tensors, extra):
        if kind == tv.PUSH:
            time.sleep(0.08)
        return orig(kind, worker, tensors, extra)

    svc._handle = slow_handle
    tid, sid = "f" * 16, "0" * 16
    try:
        ch1 = tv.Channel.connect("127.0.0.1", svc.port)
        ch2 = tv.Channel.connect("127.0.0.1", svc.port)
        try:
            ch1.send(tv.encode(tv.PUSH, 0, _grads(params)))
            time.sleep(0.01)
            ch2.send(tv.encode(tv.READ, 0, None,
                               extra={obs.WIRE_KEY: [tid, sid]}))
            ch1.recv()
            ch2.recv()
        finally:
            ch1.close()
            ch2.close()

        def drilled():
            return [e for e in obs.flight().events()
                    if e["kind"] == "slow_frame"
                    and e.get("trace_id") == tid]

        def respanned():
            return [s for s in obs.tracer().spans()
                    if s.name == "slow_frame" and s.trace_id == tid]

        deadline = time.monotonic() + 10
        while not (drilled() and respanned()) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert drilled() and respanned(), obs.flight().events()[-5:]
        evt = drilled()[0]
        assert evt["wire_kind"] == "read"
        assert evt["conn"] > 0 and evt["size"] > 0
        assert evt["wait_ms"] > 5.0
        span = respanned()[0]
        assert span.parent_id == sid and span.dur_us >= 5_000
        assert span.args["wire_kind"] == "read"
    finally:
        svc.stop()


# -- /metrics and ps_top ------------------------------------------------------------


def _parse_prometheus(text):
    out = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name, val = line.rsplit(" ", 1)
        out[name.strip()] = float(val)
    return out


def test_metrics_endpoint_on_a_live_port_service_parses(request):
    params = _params()
    _port_init()
    srv = MetricsServer(port=0)  # private server, the process registry
    request.addfinalizer(srv.close)
    svc = AsyncPSService(_port_store(params))
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _t(params))
    try:
        w.pull_all()
        before = svc.transport.hist["apply_s"].total
        for _ in range(3):
            w.push_pull(_t(_grads(params)))
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5)
        assert resp.headers["Content-Type"].startswith("text/plain")
        samples = _parse_prometheus(resp.read().decode())
        assert samples["ps_server_requests_total"] >= 4
        assert samples["ps_push_pull_seconds_count"] >= 3
        assert svc.transport.hist["apply_s"].total - before == 3
        assert samples["ps_server_apply_seconds_count"] >= 3
        buckets = [v for k, v in samples.items()
                   if k.startswith("ps_push_pull_seconds_bucket")]
        assert buckets and max(buckets) == \
            samples["ps_push_pull_seconds_count"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=5)
    finally:
        w.close()
        svc.stop()


def test_metrics_server_env_gate(monkeypatch):
    from ps_tpu_torch.obs import http as obs_http

    monkeypatch.setattr(obs_http, "_server", None)
    monkeypatch.delenv("PS_METRICS_PORT", raising=False)
    assert obs_http.start_metrics_server() is None
    monkeypatch.setenv("PS_METRICS_PORT", "0")
    srv = obs_http.start_metrics_server()
    try:
        assert srv is not None and srv.port > 0
        assert obs_http.start_metrics_server(0) is srv
    finally:
        srv.close()
        monkeypatch.setattr(obs_http, "_server", None)


def _ps_top(uri):
    out = subprocess.run(
        [sys.executable, "tools/ps_top.py", "--servers", uri, "--once",
         "--json"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _pair_rows(init, store, service, connect, conv):
    params = _params()
    init()
    prim = service(store(params))
    back = service(store(params), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    uri = _uri(prim, back)
    w = connect(uri, 0, conv(params), failover_timeout=10.0)
    try:
        w.pull_all()
        w.push_pull(conv(_grads(params)))
        return _ps_top(uri)
    finally:
        w.close()
        back.stop()
        prim.stop()


def test_ps_top_once_json_reads_a_port_pair_as_a_reference_pair():
    import ps_tpu
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    port = _pair_rows(_port_init, _port_store, AsyncPSService,
                      connect_async, _t)
    ps_tpu_torch.shutdown()
    ref = _pair_rows(_ref_init, _ref_store, RefService, ref_connect, _jnp)
    ps_tpu.shutdown()
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert p["role"] == r["role"]
        assert sorted(p) == sorted(r), (set(p) ^ set(r))
        # the port's metrics keep its own summary keys beside the
        # reference's; the latency families are the reference's
        assert set(r["metrics"]) <= set(p["metrics"])
        lat_p, lat_r = p["metrics"].get("lat", {}), r["metrics"].get("lat",
                                                                     {})
        assert sorted(lat_p) == sorted(lat_r)
        for k, q in lat_p.items():
            assert sorted(q) == sorted(lat_r[k])
    primary = next(x for x in port if x["role"] == "primary")
    assert primary["apply_log_total"] >= 1
    assert primary["metrics"]["lat"]["apply_s"]["count"] == 1
    # the table renderer takes the port's rows
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "ps_top", os.path.join(ROOT, "tools", "ps_top.py"))
    ps_top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps_top)
    buf = io.StringIO()
    ps_top.print_table(port, stream=buf)
    assert "primary" in buf.getvalue() and "backup" in buf.getvalue()


def test_no_trace_spans_without_sampling():
    """The suite default: nothing sampled, nothing recorded, frames carry
    no ``tc``."""
    assert obs.tracer().sample == 0.0
    obs.tracer().clear()
    params = _params()
    _port_init()
    svc = AsyncPSService(_port_store(params))
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _t(params))
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
        assert obs.tracer().spans() == []
    finally:
        w.close()
        svc.stop()
