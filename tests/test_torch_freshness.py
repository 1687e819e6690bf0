"""The port's freshness plane (``ps_tpu_torch/obs/``), against the
reference's ``ps_tpu/obs/freshness.py`` and ``clock.py``.

- Stamps and ages: ``age_of`` resolves mono, then sync, then wall, never
  trusts a foreign monotonic clock and clamps a negative age; the port's
  functions give the reference's answers on the same records.
- ``ClockSync``: the min-RTT filter and the median of ties equal the
  reference's on the same samples; a probe over a port service's
  REPLICA_STATE works, and the dense worker's version watcher feeds one.
- Every serving tier ages its serves: the pump (and the native hit that
  re-serves the same stamped bytes), the worker's cache, a replica (its
  birth the primary's, installed from the stream as a foreign record),
  a NOT_MODIFIED revalidation (which refreshes the age); a refused
  replica read records its version gap.
"""

import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.config import Config
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs import ClockSync, freshness
from ps_tpu_torch.utils.metrics import TransportStats


@pytest.fixture(autouse=True)
def _port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=2,
                      dc_lambda=0.0, device="cpu")
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _params():
    return {"a/w": torch.zeros(16, 8), "b/w": torch.ones(32)}


def _grad(x: float):
    return {"a/w": torch.full((16, 8), x), "b/w": torch.full((32,), x)}


def _svc(**kw):
    st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.5,
                              mode="async")
    st.init(_params())
    return AsyncPSService(st, **kw)


def _raw_read(port, payload=None):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        return bytes(ch.request(payload or tv.encode(tv.READ, 0, None)))
    finally:
        ch.close()


# -- stamps and ages -----------------------------------------------------------


def test_age_of_prefers_mono_then_sync_then_wall():
    own = freshness.birth_record()
    age, src, clamped = freshness.age_of(own)
    assert src == "mono" and not clamped and 0.0 <= age < 5.0
    # a foreign stamp (empty token) never uses this process's monotonic
    # clock
    foreign = freshness.foreign_record(time.time() - 1.0)
    age, src, clamped = freshness.age_of(foreign)
    assert src == "wall" and not clamped
    assert age == pytest.approx(1.0, abs=0.5)
    # with a ClockSync offset, the local wall clock is projected into the
    # stamper's: +2 s of offset adds 2 s of age
    age, src, clamped = freshness.age_of(foreign, offset_us=2e6)
    assert src == "sync" and not clamped
    assert age == pytest.approx(3.0, abs=0.5)
    # another process's monotonic stamp: the token differs, so wall
    twin = dict(freshness.birth_record())
    twin["bpid"] = "deadbeef.cafe"
    assert freshness.age_of(twin)[1] == "wall"
    # a skewed member's future birth clamps to zero, flagged
    future = freshness.foreign_record(time.time() + 60.0)
    age, src, clamped = freshness.age_of(future)
    assert age == 0.0 and clamped and src == "wall"


def test_from_extra_dense_and_sparse_forms():
    assert freshness.from_extra({}) is None
    assert freshness.from_extra({"version": 3}) is None
    rec = freshness.birth_record()
    assert freshness.from_extra(dict(rec)) == rec
    extra = {"births": {"emb": [rec["birth"], rec["bmono"], rec["bpid"]],
                        "deep": [123.5]}}
    assert freshness.from_extra(extra, table="emb") == rec
    assert freshness.from_extra(extra, table="deep") == \
        {"birth": 123.5, "bmono": None, "bpid": ""}
    assert freshness.from_extra(extra, table="wide") is None
    assert freshness.from_extra(
        {"births": {"e": [1.0, None, None]}}, table="e") == \
        {"birth": 1.0, "bmono": None, "bpid": ""}


def test_stamps_and_ages_equal_the_references():
    """The port's functions on the reference's records (and the other
    way round) give the same records, sources and clamps; ages agree to
    the time between the two calls."""
    from ps_tpu.obs import freshness as ref

    now = time.time()
    assert freshness.foreign_record(now) == ref.foreign_record(now)
    assert freshness.birth_record(now, 7.0)["birth"] == \
        ref.birth_record(now, 7.0)["birth"]
    recs = [ref.foreign_record(now - 2.0), ref.foreign_record(now + 30.0),
            dict(ref.birth_record(), bpid="someone.else"),
            {"birth": now - 0.5, "bmono": None, "bpid": ""}]
    for rec in recs:
        for off in (None, 0.0, 1.5e6, -4e6):
            a, s, c = freshness.age_of(rec, off)
            ra, rs, rc = ref.age_of(rec, off)
            assert (s, c) == (rs, rc)
            assert a == pytest.approx(ra, abs=0.05)
    for extra, table in (({"birth": now, "bmono": 3.0, "bpid": "x"}, None),
                         ({"births": {"t": [now, None, ""]}}, "t"),
                         ({"births": {"t": [now]}}, "t"),
                         ({"version": 1}, None)):
        assert freshness.from_extra(extra, table) == \
            ref.from_extra(extra, table)


def test_record_read_age_tiers_share_and_clamp_counter():
    t = TransportStats()
    assert t.fresh_snapshot() is None  # no samples: no STATS dict
    t.record_read_age(0.010, src="mono", tier="cache", bound=0.5)
    t.record_read_age(0.020, src="wall", tier="wire", bound=0.5)
    t.record_read_age(0.900, src="sync", tier="replica", bound=0.5)
    t.record_read_age(0.0, src="wall", tier="wire", bound=0.5,
                      clamped=True)
    f = t.fresh_snapshot()
    assert f["aged"] == 4 and f["within"] == 3
    assert f["fresh_share"] == pytest.approx(0.75)
    assert f["clamped"] == 1
    assert f["src"] == {"mono": 1, "wall": 2, "sync": 1}
    assert f["tiers"]["wire"]["n"] == 2
    assert f["tiers"]["replica"]["max_ms"] == pytest.approx(900.0)
    t.record_fresh_lag(0.004)
    assert t.fresh_snapshot()["lag_p99_ms"] == pytest.approx(4.0)
    assert t.latency_quantiles()["read_age_s"]["count"] == 4


# -- ClockSync -----------------------------------------------------------------


def test_clock_sync_min_rtt_and_tie_median_equal_the_references():
    from ps_tpu.obs.clock import ClockSync as RefClockSync

    rng = np.random.default_rng(3)
    ours, ref = ClockSync(), RefClockSync()
    for _ in range(300):  # past max_samples: the window slides alike
        t0 = float(rng.uniform(0, 100))
        rtt = float(rng.choice([20e-6, 30e-6, 500e-6]))
        srv = t0 + rtt / 2 + float(rng.normal(0, 1e-5)) + 0.25
        ours.observe(t0, t0 + rtt, srv)
        ref.observe(t0, t0 + rtt, srv)
        assert (ours.offset_us, ours.rtt_us) == (ref.offset_us, ref.rtt_us)
    assert ours.offset_us == pytest.approx(0.25e6, abs=100.0)
    assert not ours.fresh()  # never probed
    ttl = ClockSync(ttl_s=0.0)
    ttl.probed_at = time.monotonic()
    assert not ttl.fresh()


def test_clock_sync_probes_a_port_service():
    svc = _svc()
    try:
        ch = tv.Channel.connect("127.0.0.1", svc.port)
        try:
            cs = ClockSync(ttl_s=60.0)
            off = cs.probe(ch, n=4)
            assert cs.probes == 4 and cs.fresh()
            assert abs(off) < 50_000  # one host: tens of microseconds
            assert cs.ensure_fresh(ch) == off and cs.reprobes == 0
        finally:
            ch.close()
    finally:
        svc.stop()


# -- births ride the replies ---------------------------------------------------


def test_read_reply_carries_birth_and_native_hit_reserves_it():
    svc = _svc(native_loop=True)
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    try:
        kind, _, _, extra = tv.decode(memoryview(_raw_read(svc.port)))
        assert kind == tv.OK and freshness.from_extra(extra) is None
        w.push_all(_grad(0.5))
        miss = _raw_read(svc.port)   # the pump; publishes, ages the serve
        hit = _raw_read(svc.port)    # the loop; echoes the publish
        assert hit == miss           # the stamp kept the reply deterministic
        kind, _, _, extra = tv.decode(memoryview(miss))
        assert kind == tv.OK
        b = freshness.from_extra(extra)
        assert b is not None and b["bpid"] == freshness.PROC_TOKEN
        assert 0.0 <= time.time() - b["birth"] < 30.0
        f = svc.transport.fresh_snapshot()
        assert f and f["tiers"].get("pump", {}).get("n", 0) >= 1
        assert f["lag_p99_ms"] is not None  # the apply recorded its lag
        st = w.stats()
        assert st["fresh"]["aged"] >= 1 and st["read"]["served"] >= 2
    finally:
        w.close()
        svc.stop()


def test_three_tier_age_drill():
    """Ages served from (a) the worker's cache, (b) a NOT_MODIFIED
    revalidation (which must record the grown age of the held bytes) and
    (c) a replica, whose birth is the primary's, installed from the
    stream as a foreign record and so resolved through sync or wall, never
    mono. The reference's fourth tier, the aggregator, is held in
    ``tests/test_torch_aggregation.py``."""
    prim = _svc()
    back = _svc(backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}"
    wcache = connect_async(uri, 0, _params(), pull_cache=True,
                           read_staleness=0)
    wspread = connect_async(uri, 1, _params(), read_staleness=10_000)
    try:
        wcache.push_all(_grad(0.5))
        assert back._birth == freshness.foreign_record(
            prim._birth["birth"])
        for _ in range(3):
            wcache.read_all()
        fc = wcache.transport.fresh_snapshot()
        assert fc["tiers"].get("cache", {}).get("n", 0) >= 1, fc
        time.sleep(0.25)
        wcache.versions[0] += 1  # a lag signal, the server unchanged
        wcache.read_all()
        fc = wcache.transport.fresh_snapshot()
        nm = fc["tiers"].get("nm", {})
        assert nm.get("n", 0) >= 1, fc
        assert nm["max_ms"] >= 200.0  # the sleep aged the held bytes
        for _ in range(6):
            wspread.read_all()
        assert wspread.transport.reads_replica >= 2
        fs = wspread.transport.fresh_snapshot()
        assert fs["tiers"].get("replica", {}).get("n", 0) >= 1, fs
        assert fs["src"].get("sync", 0) + fs["src"].get("wall", 0) >= 1
        assert fs["src"].get("mono", 0) >= 1  # the primary's serves
        fb = back.transport.fresh_snapshot()
        assert fb and fb["tiers"].get("replica", {}).get("n", 0) >= 1
        for f in (fc, fs, fb):
            assert f.get("clamped", 0) == 0, f
        # the cache's version watcher polls REPLICA_STATE and feeds a
        # ClockSync toward the primary from the same round trips
        deadline = time.monotonic() + 5.0
        while 0 not in wcache._read_clock and time.monotonic() < deadline:
            time.sleep(0.05)
        assert wcache._read_clock[0].probes >= 1
    finally:
        wcache.close()
        wspread.close()
        prim.stop()
        back.stop()


def test_frozen_backup_refusal_records_version_gap():
    """A backup frozen at version 0 against a primary at 4, bound 1:
    every read falls back and each refused gap (4 versions) is recorded
    under ``read_gap_v``."""
    prim = _svc()
    stale = _svc(backup=True)  # no stream ever attaches
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{stale.port}"
    w = connect_async(uri, 0, _params(), read_staleness=1)
    try:
        for _ in range(4):
            w.push_all(_grad(0.25))
        for _ in range(6):
            w.read_all()
        assert w.transport.reads_replica == 0
        assert w.transport.read_fallbacks >= 3
        gap = w.transport.latency_quantiles()["read_gap_v"]
        assert gap["count"] == w.transport.read_fallbacks
        assert gap["p50"] == gap["max"] == 4.0
    finally:
        w.close()
        prim.stop()
        stale.stop()


def test_freshness_slo_knob_four_way(monkeypatch):
    monkeypatch.setenv("PS_FRESHNESS_SLO", "0.25")
    assert Config.from_env().freshness_slo == pytest.approx(0.25)
    with pytest.raises(ValueError):
        Config(freshness_slo=0.0)
    with pytest.raises(ValueError):
        Config(freshness_slo=-1.0)
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    try:
        assert svc._fresh_slo == pytest.approx(0.25)
        assert w.freshness_slo == pytest.approx(0.25)
    finally:
        w.close()
        svc.stop()
