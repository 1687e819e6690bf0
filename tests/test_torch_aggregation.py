"""The port's two-level aggregation (``ps_tpu_torch/backends/aggregator.py``,
the shards' member-token ledger, the workers' ``aggregator=`` route and
their degrade to the flat path), against the reference's.

- Bytes: for the same member group, tokens, integer gradients and birth
  stamp (both packages' ``freshness.birth_record`` patched to one fixed
  stamp), the port aggregator's upstream merged ``push_pull`` frame,
  captured at a recording proxy in front of the shard, and its replies to
  the members (the PUSH ack, the PUSH_PULL params, READ, NOT_MODIFIED,
  the bucketed acks with ``committed``) are byte-equal to the reference
  aggregator's, on thread per connection and on the native loop.
- Interop: port workers through a reference aggregator into a port shard,
  and reference workers through a port aggregator into a reference shard,
  both land the closed form.
- Behaviour: every case of the reference's ``tests/test_aggregation.py``
  against port services (merged rounds exact at both bucket sizes, bytes
  divided by the fan-in, both kill windows, an in-flight merged push
  after the flat replays, the partial overlap refused with the ledger
  monotone, a parked merged push after a checkpoint pause, a draining
  aggregator never forwarding, the partial flush on a member timeout, a
  concurrent reader never tearing the upstream stream, serving from the
  native loop at a fan-in above its threads, and the priority scheduling
  cases), the aggregator cases of ``tests/test_read_path.py`` and part
  (d) of ``tests/test_freshness.py``, and a replicated upstream whose
  backup is bitwise its primary and dedups the members' replays after its
  promotion. Two reference cases need the coordinator's membership
  table (item 6.2) and are not run: ``test_stale_discovered_aggregator_
  falls_back_to_flat`` and ``test_coordinator_assigns_host_group``; the
  trace chain case (``test_trace_chain_worker_aggregator_shard_
  resolves``) is in ``tests/test_torch_obs_services.py``.

Tolerance: bitwise everywhere. The gradients are small integers and the
sgd learning rate a power of two, so every sum is exact in float32 and any
lost, doubled or torn push moves the final weights.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.aggregator import AggregatorService
from ps_tpu_torch.backends.common import (AGG_WORKER_BASE, BucketPlan,
                                          ChannelPump)
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.backends.van_service import VanService
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs import freshness

FAN_IN = 2
LR = 0.5  # a power of two: every partial update is exact in float32
FIXED_BIRTH = {"birth": 1700000000.25, "bmono": 12.5, "bpid": "fixed.0"}
LOOP = pytest.mark.parametrize("native_loop", [False, True],
                               ids=["threads", "loop"])


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _params():
    return {"a": torch.zeros(32, 16), "b": torch.ones(64)}


def _grad(w: int, s: int):
    return {"a": torch.full((32, 16), float(3 * w + s + 1)),
            "b": torch.full((64,), float(2 * (w + 1) + s))}


def _grad_np(w: int, s: int):
    return {k: v.numpy() for k, v in _grad(w, s).items()}


def _job(num_workers=FAN_IN, **svc_kw):
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=num_workers,
                      dc_lambda=0.0, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=LR,
                                 mode="async")
    store.init(_params())
    svc = AsyncPSService(store, **svc_kw)
    return store, svc, f"127.0.0.1:{svc.port}"


def _expected(steps_by_worker):
    """The exact final tree after every (worker, step) gradient applied
    once."""
    tot_a = sum(3 * w + s + 1 for w, steps in steps_by_worker.items()
                for s in steps)
    tot_b = sum(2 * (w + 1) + s for w, steps in steps_by_worker.items()
                for s in steps)
    return 0.0 - LR * tot_a, 1.0 - LR * tot_b


def _group_rounds(workers, steps, grads=_grad):
    """Drive the group in lockstep: every member one push_pull a step (the
    aggregator's round barrier aligns them)."""
    errs = []

    def loop(i):
        try:
            for s in steps:
                workers[i].push_pull(grads(i, s))
        except BaseException as e:  # surfaced by the caller
            errs.append(e)

    ts = [threading.Thread(target=loop, args=(i,))
          for i in range(len(workers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "group round wedged"
    if errs:
        raise errs[0]


def _assert_params_exact(params, steps_by_worker):
    exp_a, exp_b = _expected(steps_by_worker)
    a, b = np.asarray(params["a"]), np.asarray(params["b"])
    assert np.all(a == np.float32(exp_a)), (a[0, 0], exp_a)
    assert np.all(b == np.float32(exp_b)), (b[0], exp_b)


def _assert_exact(store, steps_by_worker):
    _assert_params_exact({k: v.numpy() for k, v
                          in store._engine._params.items()}, steps_by_worker)


def _close(ws):
    for w in ws:
        w.close()


def _agg_uri(agg):
    return f"127.0.0.1:{agg.port}"


# -- merged parity and the byte reduction -----------------------------------


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 12])
def test_aggregated_rounds_are_exact_and_merged(bucket_bytes):
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN,
                            bucket_bytes=bucket_bytes)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg),
                        bucket_bytes=bucket_bytes) for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, range(3))
        # every (worker, step) gradient applied exactly once, merged
        _assert_exact(store, {w: range(3) for w in range(FAN_IN)})
        # the shard saw one apply a round, from the aggregator's identity
        assert store._engine.version == 3
        assert svc.apply_log.total == 3
        assert set(svc._applied) == {AGG_WORKER_BASE + 0}
        s = agg.transport.summary()
        assert s["agg_rounds"] == 3 and s["agg_fan_in"] == FAN_IN
        assert agg.transport.hist["agg_hold_s"].total == 3 * FAN_IN
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


def test_cross_host_bytes_divide_by_fan_in():
    store, svc, uri = _job(num_workers=2 * FAN_IN)
    rounds = 3
    flat = [connect_async(uri, w, _params()) for w in range(FAN_IN)]
    for w in flat:
        w.pull_all()
    b0 = sum(w.bytes_pushed + w.bytes_pulled for w in flat)
    _group_rounds(flat, range(rounds))
    flat_bytes = sum(w.bytes_pushed + w.bytes_pulled for w in flat) - b0
    _close(flat)
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, FAN_IN + w, _params(), aggregator=_agg_uri(agg))
          for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        b0 = agg._client.bytes_pushed + agg._client.bytes_pulled
        _group_rounds(ws, range(rounds))
        cross = agg._client.bytes_pushed + agg._client.bytes_pulled - b0
        # upstream bytes = flat / fan-in, plus only header overhead (the
        # json meta and the members' token map)
        assert cross <= flat_bytes / FAN_IN + 16 * 1024 * rounds, \
            (cross, flat_bytes)
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


# -- the failure paths --------------------------------------------------------


def _kill_drill(kill_when):
    """One aggregated round, then the aggregator dies at ``kill_when``
    ('after_forward': between the merged upstream commit and the members'
    acks; 'before_forward': the merge never went upstream); the degraded
    continuation lands every push exactly once, bitwise."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg),
                        failover_timeout=10.0) for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, [0])
        nonces = [w._transport_nonce for w in ws]
        orig = agg._client.push_pull

        def dying(*a, **kw):
            if kill_when == "after_forward":
                out = orig(*a, **kw)  # the merged push commits upstream
                # sever the members before any ack goes out (the base
                # class's kill: the flusher must not join itself)
                VanService.kill(agg)
                return out
            VanService.kill(agg)
            raise RuntimeError("aggregator died before the forward")

        agg._client.push_pull = dying
        _group_rounds(ws, [1])  # the members degrade mid-step and replay
        _group_rounds(ws, [2])  # and run one more step flat
        for w, nonce in zip(ws, nonces):
            assert w._agg_fallback is None  # degraded: the flat topology
            assert w.transport.summary().get("agg_degrades") == 1
            assert w._transport_nonce == nonce and w._push_seq == 3
        _assert_exact(store, {w: range(3) for w in range(FAN_IN)})
        if kill_when == "after_forward":
            # the replays were acked through the members' tokens
            assert svc.transport.dedup_hits >= FAN_IN
    finally:
        _close(ws)
        agg.kill()
        svc.stop()


def test_aggregator_killed_after_merged_commit_dedups_replays():
    _kill_drill("after_forward")


def test_aggregator_killed_before_forward_replays_apply():
    _kill_drill("before_forward")


def test_inflight_merged_push_after_flat_replays_is_pure_replay():
    """The aggregator dies with the merged push in flight, every member
    degrades and replays flat first, and only then does the stale merged
    push reach the shard: a replay of settled state, acked, never
    applied."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg),
                        failover_timeout=10.0) for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, [0])
        orig = agg._client.push_pull
        applied_before_merge = []
        merged_done = threading.Event()

        def delayed(*a, **kw):
            VanService.kill(agg)
            deadline = time.monotonic() + 20
            while (svc.apply_log.total < 1 + FAN_IN
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            applied_before_merge.append(svc.apply_log.total)
            try:
                return orig(*a, **kw)  # the stale merged push lands last
            finally:
                merged_done.set()

        agg._client.push_pull = delayed
        _group_rounds(ws, [1])
        _group_rounds(ws, [2])
        assert merged_done.wait(30), "merged push never went upstream"
        assert applied_before_merge[0] >= 1 + FAN_IN
        # one merged round 0, then the members' flat applies of 1 and 2
        assert svc.apply_log.total == 1 + 2 * FAN_IN
        _assert_exact(store, {w: range(3) for w in range(FAN_IN)})
    finally:
        _close(ws)
        agg.kill()
        svc.stop()


def test_partial_constituent_overlap_is_refused_and_ledger_monotone():
    """A merged push whose members partly settled cannot be subtracted
    from a sum: refused loudly. A fully settled one is a replay and never
    moves the ledger backward (the later flat seq still dedups)."""
    store, svc, uri = _job()
    w0 = connect_async(uri, 0, _params())
    try:
        w0.pull_all()
        w0.push_all(_grad(0, 0))  # worker 0's seq 1 applies flat
        v1 = store._engine.version
        ch = tv.Channel.connect("127.0.0.1", svc.port)
        kv0 = _grad_np(0, 0)
        merged = {k: 2.0 * v for k, v in kv0.items()}
        n0 = w0._transport_nonce
        kind, _, _, e = tv.decode(ch.request(tv.encode(
            tv.PUSH, AGG_WORKER_BASE, merged, extra={
                "pseq": 1, "pnonce": "aggnonce",
                "members": {"0": [n0, 1], "1": ["othernonce", 1]}})))
        assert kind == tv.ERR and "merged push refused" in e["error"]
        assert store._engine.version == v1  # nothing applied
        w0.push_all(_grad(0, 1))  # seq 2 applies
        v2 = store._engine.version
        kind, _, _, e = tv.decode(ch.request(tv.encode(
            tv.PUSH, AGG_WORKER_BASE, dict(kv0), extra={
                "pseq": 2, "pnonce": "aggnonce",
                "members": {"0": [n0, 1]}})))
        assert kind == tv.OK and e.get("dedup")
        assert store._engine.version == v2
        # worker 0's token did not move back: its seq-2 replay dedups
        kind, _, _, e = tv.decode(ch.request(tv.encode(
            tv.PUSH, 0, _grad_np(0, 1), extra={"pseq": 2, "pnonce": n0})))
        assert kind == tv.OK and e.get("dedup")
        assert store._engine.version == v2
        ch.close()
    finally:
        w0.close()
        svc.stop()


def test_parked_merged_push_revalidates_after_checkpoint_pause():
    """The pause park releases the engine lock, and a member's flat
    replay may settle a constituent meanwhile: the ledger checks run after
    the park, so the woken merged push is refused, not applied."""
    store, svc, uri = _job()
    w0 = connect_async(uri, 0, _params())
    try:
        w0.pull_all()
        with svc._engine._lock:
            svc._paused = True
        merged_reply = []

        def send_merged():
            ch = tv.Channel.connect("127.0.0.1", svc.port)
            kind, _, _, e = tv.decode(ch.request(tv.encode(
                tv.PUSH, AGG_WORKER_BASE, _grad_np(0, 0), extra={
                    "pseq": 1, "pnonce": "aggnonce",
                    "members": {"0": [w0._transport_nonce, 1],
                                "1": ["othernonce", 1]}})))
            merged_reply.append((kind, e))
            ch.close()

        t = threading.Thread(target=send_merged)
        t.start()
        deadline = time.monotonic() + 10
        while svc._pause_blocked < 1:  # the merged push is parked
            assert time.monotonic() < deadline
            time.sleep(0.02)
        # admit only worker 0's flat push through the pause
        with svc._engine._lock:
            svc._drain_targets = {0: 1}
            svc._pause_cond.notify_all()
        w0.push_all(_grad(0, 0))
        with svc._engine._lock:
            svc._drain_targets = {}
            svc._paused = False
            svc._pause_cond.notify_all()
        t.join(timeout=20)
        assert not t.is_alive()
        kind, e = merged_reply[0]
        assert kind == tv.ERR and "merged push refused" in e["error"]
        _assert_exact(store, {0: [0]})  # applied exactly once, flat
    finally:
        w0.close()
        svc.stop()


def test_draining_aggregator_never_forwards_refused_round():
    """stop() wakes barrier-parked members into refusal; their staged
    gradients never go upstream behind those failed replies."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN,
                            flush_timeout_ms=60_000)
    w0 = connect_async(uri, 0, _params(), aggregator=_agg_uri(agg))
    errs = []

    def push():
        try:
            w0.push_pull(_grad(0, 0))  # parks: the partner never comes
        except BaseException as e:
            errs.append(e)

    t = threading.Thread(target=push)
    try:
        w0.pull_all()
        t.start()
        deadline = time.monotonic() + 10
        while not agg._round["members"]:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        agg.stop(grace=2.0)
        t.join(timeout=20)
        assert not t.is_alive()
        assert errs, "the parked push was not refused"
        time.sleep(0.2)
        assert store._engine.version == 0, \
            "a refused round's gradients were forwarded upstream"
    finally:
        t.join(timeout=5)
        w0.close()
        svc.stop()


def test_partial_flush_on_member_timeout():
    """A dead member costs its group latency, never a wedge: the round
    flushes partial at the timeout and the live member's push lands
    once."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN,
                            flush_timeout_ms=200)
    w0 = connect_async(uri, 0, _params(), aggregator=_agg_uri(agg))
    try:
        w0.pull_all()
        t0 = time.monotonic()
        w0.push_pull(_grad(0, 0))  # the partner never shows up
        assert time.monotonic() - t0 < 5.0
        _assert_exact(store, {0: [0]})
        assert agg.transport.summary()["agg_fan_in"] == 1.0
    finally:
        w0.close()
        agg.stop()
        svc.stop()


def test_concurrent_reader_never_tears_the_upstream_stream():
    """A member pulling while the group's rounds flush: the flusher and
    the coalesced fetches share one upstream client, whose framed stream
    the upstream lock serializes."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg))
          for w in range(FAN_IN)]
    reader = connect_async(uri, 0, _params(), aggregator=_agg_uri(agg))
    stop = threading.Event()
    reader_errs = []

    def read_loop():
        try:
            while not stop.is_set():
                reader.pull_all()
        except BaseException as e:
            reader_errs.append(e)

    t = threading.Thread(target=read_loop)
    try:
        for w in ws:
            w.pull_all()
        reader.pull_all()
        t.start()
        _group_rounds(ws, range(4))
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not reader_errs, reader_errs[0]
        _assert_exact(store, {w: range(4) for w in range(FAN_IN)})
    finally:
        stop.set()
        t.join(timeout=5)
        reader.close()
        _close(ws)
        agg.stop()
        svc.stop()


def test_aggregator_serves_from_native_loop():
    """A group of three on a loop of one thread: every member push parks
    on the round's barrier on a fresh thread of its own, so the round's
    last push is never queued behind the parked ones."""
    from ps_tpu_torch.control import native_loop as nlmod

    if not nlmod.available():
        pytest.skip("native event loop unavailable on this platform")
    fan_in = 3
    store, svc, uri = _job(num_workers=fan_in)
    agg = AggregatorService(uri, _params(), group_size=fan_in,
                            native_loop=True, loop_threads=1)
    assert agg.native_loop
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg))
          for w in range(fan_in)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, range(2))
        _assert_exact(store, {w: range(2) for w in range(fan_in)})
        assert agg.transport.summary()["agg_fan_in"] == fan_in
        assert agg.transport.loop_pushes >= 2 * fan_in
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


# -- priority scheduling ------------------------------------------------------


def test_priority_vs_fifo_bitwise_parity(monkeypatch):
    """The scheduler reorders bytes, never math: one push stream through
    priority on and priority off lands bit-identical server state."""
    finals = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("PS_BUCKET_PRIORITY", flag)
        store, svc, uri = _job(num_workers=1)
        w = connect_async(uri, 0, _params(), bucket_bytes=1 << 10,
                          pool_size=2)
        try:
            w.pull_all()
            for s in range(3):
                w.push_pull(_grad(0, s))
            finals[flag] = {k: v.numpy().copy()
                            for k, v in store._engine._params.items()}
        finally:
            w.close()
            svc.stop()
            ps_tpu_torch.shutdown()
    for k in finals["1"]:
        assert np.array_equal(finals["1"][k], finals["0"][k]), k


class _BlockingFakeChannel:
    """Records request order; the first request parks until released, so
    later submits pile up in the queue and the drain order shows."""

    def __init__(self):
        self.order = []
        self.release = threading.Event()
        self._first = True

    def request(self, payload):
        if self._first:
            self._first = False
            self.release.wait(10)
        self.order.append(bytes(payload))
        return memoryview(b"ok")

    def close(self):
        pass


def test_channel_pump_drains_by_priority_with_fifo_ties():
    ch = _BlockingFakeChannel()
    pump = ChannelPump(ch)
    futs = [pump.submit(b"head")]
    time.sleep(0.05)
    futs.append(pump.submit(b"b3", priority=3))
    futs.append(pump.submit(b"b2", priority=2))
    futs.append(pump.submit(b"b0-first", priority=0))
    futs.append(pump.submit(b"b0-second", priority=0))
    futs.append(pump.submit(b"b1", priority=1))
    ch.release.set()
    for f in futs:
        f.result(timeout=10)
    assert ch.order == [b"head", b"b0-first", b"b0-second", b"b1", b"b2",
                        b"b3"]
    pump.close()


def test_channel_pump_priority_off_is_fifo():
    ch = _BlockingFakeChannel()
    pump = ChannelPump(ch)
    futs = [pump.submit(b"head")]
    time.sleep(0.05)
    for name in (b"x", b"y", b"z"):
        futs.append(pump.submit(name))
    ch.release.set()
    for f in futs:
        f.result(timeout=10)
    assert ch.order == [b"head", b"x", b"y", b"z"]
    pump.close()


# -- member reads (tests/test_read_path.py, tests/test_freshness.py) ---------


def _raw_read(port, payload=None):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        return bytes(ch.request(payload or tv.encode(tv.READ, 0, None)))
    finally:
        ch.close()


def test_aggregator_conditional_read_not_modified():
    """A member revalidating at the coalesced snapshot's version gets the
    NOT_MODIFIED handshake, not the tree."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    try:
        kind, _, _, extra = tv.decode(memoryview(_raw_read(agg.port)))
        assert kind == tv.OK
        v = int(extra["version"])
        nm = _raw_read(agg.port, tv.encode(tv.READ, 0, None,
                                           extra={"cond": v}))
        kind, _, tensors, extra = tv.decode(memoryview(nm))
        assert kind == tv.NOT_MODIFIED and not tensors
        assert int(extra["version"]) == v
        assert agg.transport.read_not_modified >= 1
    finally:
        agg.stop()
        svc.stop()


@LOOP
def test_aggregator_serves_member_reads(native_loop):
    """Repeated member READs are the same bytes; on the native loop the
    repeat is a native cache hit, bitwise the pump miss that published
    it."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN,
                            native_loop=native_loop)
    try:
        r1 = _raw_read(agg.port)
        r2 = _raw_read(agg.port)
        assert r1 == r2
        kind, _, tensors, extra = tv.decode(memoryview(r1))
        assert kind == tv.OK and sorted(tensors) == sorted(_params())
        for k, v in _params().items():
            np.testing.assert_array_equal(tensors[k], v.numpy())
        if native_loop:
            deadline = time.monotonic() + 3
            while (agg._nloop.cache_stats()["hits"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            cs = agg._nloop.cache_stats()
            assert cs["hits"] >= 1 and cs["puts"] >= 1, cs
    finally:
        agg.stop()
        svc.stop()


def test_aggregator_read_ages_under_tier_agg():
    """Part (d) of the freshness drill: the coalesced snapshot carries the
    upstream birth, member READs age under tier "agg", none clamped."""
    store, svc, uri = _job()
    w = connect_async(uri, 0, _params())
    agg = AggregatorService(uri, _params(), group_size=2)
    try:
        w.pull_all()
        w.push_all(_grad(0, 0))  # the shard stamps a birth
        kind, _, _, extra = tv.decode(memoryview(_raw_read(agg.port)))
        assert kind == tv.OK and freshness.from_extra(extra) is not None
        fa = agg.transport.fresh_snapshot()
        assert fa and fa["tiers"].get("agg", {}).get("n", 0) >= 1, fa
        assert fa.get("clamped", 0) == 0, fa
    finally:
        w.close()
        agg.stop()
        svc.stop()


def test_member_read_all_goes_through_the_aggregator():
    """A member's read_all is served by its aggregator: bitwise the
    shard's params, one upstream fetch for the group's reads of a
    round."""
    store, svc, uri = _job()
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg))
          for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, [0])
        before = svc.transport.reads_served
        for w in ws:
            tree, version = w.read_all_versioned()
            assert version == store._engine.version == 1
            for k, v in store._engine._params.items():
                np.testing.assert_array_equal(tree[k].numpy(), v.numpy())
        # served from the round's flush snapshot: no upstream READ
        assert svc.transport.reads_served == before
        assert agg.transport.reads_served == FAN_IN
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


# -- a replicated upstream ----------------------------------------------------


def test_replicated_upstream_backup_bitwise_and_replays_dedup():
    """The merged pushes replicate with their members: the backup is
    bitwise its primary, and after the primary and the aggregator die
    (the merged round committed, no member acked) the members degrade to
    the flat path, fail over to the promoted backup, and their replays
    dedup there."""
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=FAN_IN,
                      dc_lambda=0.0, device="cpu")
    stores, svcs = [], []
    for backup in (False, True):
        st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=LR,
                                  mode="async")
        st.init(_params())
        stores.append(st)
        svcs.append(AsyncPSService(st, backup=backup))
    prim, back = svcs
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}"
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg),
                        failover_timeout=10.0) for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, range(2))
        for k in stores[0]._engine._params:
            assert torch.equal(stores[0]._engine._params[k],
                               stores[1]._engine._params[k]), k
        orig = agg._client.push_pull

        def dying(*a, **kw):
            out = orig(*a, **kw)  # committed at the primary and its backup
            prim.kill()
            back.promote(reason="test")
            VanService.kill(agg)
            return out

        agg._client.push_pull = dying
        _group_rounds(ws, [2])  # degrade, fail over, replay
        _group_rounds(ws, [3])
        assert back.role == "primary"
        assert back.transport.dedup_hits >= FAN_IN
        _assert_exact(stores[1], {w: range(4) for w in range(FAN_IN)})
    finally:
        _close(ws)
        agg.kill()
        back.stop()
        prim.stop()


# -- interop ------------------------------------------------------------------


@pytest.fixture
def ref_async():
    import ps_tpu

    ps_tpu.init(backend="tpu", mode="async", num_workers=FAN_IN,
                dc_lambda=0.0)
    yield ps_tpu
    ps_tpu.shutdown()


def _ref_params():
    import jax.numpy as jnp

    return {"a": jnp.zeros((32, 16), jnp.float32),
            "b": jnp.ones((64,), jnp.float32)}


def _ref_grad(w, s):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in _grad_np(w, s).items()}


def test_port_workers_through_reference_aggregator_into_port_shard():
    from ps_tpu.backends.aggregator import AggregatorService as RefAgg

    store, svc, uri = _job()
    agg = RefAgg(uri, _ref_params(), group_size=FAN_IN)
    ws = [connect_async(uri, w, _params(), aggregator=_agg_uri(agg))
          for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, range(3))
        _assert_exact(store, {w: range(3) for w in range(FAN_IN)})
        assert set(svc._applied) == {AGG_WORKER_BASE}
        assert svc.apply_log.total == 3
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


def test_reference_workers_through_port_aggregator_into_reference_shard(
        ref_async):
    from ps_tpu.backends.remote_async import connect_async as ref_connect
    from ps_tpu.backends.remote_async import serve_async as ref_serve

    ps = ref_async
    store = ps.KVStore(optimizer="sgd", learning_rate=LR, mode="async")
    store.init(_ref_params())
    svc = ref_serve(store, bind="127.0.0.1")
    uri = f"127.0.0.1:{svc.port}"
    agg = AggregatorService(uri, _params(), group_size=FAN_IN)
    ws = [ref_connect(uri, w, _ref_params(), aggregator=_agg_uri(agg))
          for w in range(FAN_IN)]
    try:
        for w in ws:
            w.pull_all()
        _group_rounds(ws, range(3), grads=_ref_grad)
        _assert_params_exact(store._engine._params,
                             {w: range(3) for w in range(FAN_IN)})
        assert set(svc._applied) == {AGG_WORKER_BASE}
        assert svc.apply_log.total == 3
    finally:
        _close(ws)
        agg.stop()
        svc.stop()


# -- bytes --------------------------------------------------------------------


class _Recorder:
    """A recording proxy in front of a shard: every request frame that
    reaches it is kept, then forwarded on a connection of its own."""

    def __init__(self, upstream_port: int):
        self.frames = []
        self._up = upstream_port
        self._lis = tv.Listener(port=0, bind="127.0.0.1")
        self.port = self._lis.port
        self._stop = threading.Event()
        self._chs = []
        self._t = threading.Thread(target=self._accept, daemon=True)
        self._t.start()

    def _accept(self):
        while not self._stop.is_set():
            ch = self._lis.accept(timeout_ms=100)
            if ch is not None:
                self._chs.append(ch)
                threading.Thread(target=self._serve, args=(ch,),
                                 daemon=True).start()

    def _serve(self, ch):
        up = tv.Channel.connect("127.0.0.1", self._up)
        try:
            while True:
                msg = bytes(ch.recv())
                self.frames.append(msg)
                ch.send(bytes(up.request(msg)))
        except tv.VanError:
            pass
        finally:
            up.close()
            ch.close()

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)
        for ch in self._chs:
            ch.shutdown()
        self._lis.close()


def _member_round(agg, frames_by_member):
    """Send each member's frames in order on a channel of its own, the
    members staggered (member w+1 starts once w staged in the round), so
    the members' token map is built in one order; returns each member's
    replies."""
    replies = {w: [] for w in frames_by_member}

    def run(w, frames):
        ch = tv.Channel.connect("127.0.0.1", agg.port)
        try:
            for f in frames:
                replies[w].append(bytes(ch.request(f)))
        finally:
            ch.close()

    ts = []
    order = sorted(frames_by_member)
    for w in order:
        t = threading.Thread(target=run, args=(w, frames_by_member[w]))
        t.start()
        ts.append(t)
        if w == order[-1]:
            break  # the last member completes the round
        deadline = time.monotonic() + 10
        while w not in agg._round["members"]:
            assert time.monotonic() < deadline, "member never staged"
            time.sleep(0.005)
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    return replies


def _bucket_frames(w, s, seq):
    sub = _grad_np(w, s)
    plan = BucketPlan.from_arrays(sub, 1024)
    assert plan.nbuckets > 1
    extra = {"epoch": seq, "nonce": f"n{w}", "pseq": seq,
             "pnonce": f"n{w}", "enc": []}
    return [plan.encode_bucket(tv.BUCKET_PUSH, w, sub, b, extra=dict(extra))
            for b in range(plan.nbuckets)]


def _byte_run(make_agg, upstream_port):
    """One drive of an aggregator over a fresh shard behind a recorder:
    a PUSH_PULL round, a PUSH round, a bucketed round, then a READ and a
    READ conditional on its version."""
    rec = _Recorder(upstream_port)
    agg = make_agg(f"127.0.0.1:{rec.port}")
    agg._client._transport_nonce = "aggnonce"
    try:
        out = []
        out.append(_member_round(agg, {w: [tv.encode(
            tv.PUSH_PULL, w, _grad_np(w, 0),
            extra={"pseq": 1, "pnonce": f"n{w}"})] for w in range(FAN_IN)}))
        out.append(_member_round(agg, {w: [tv.encode(
            tv.PUSH, w, _grad_np(w, 1),
            extra={"pseq": 2, "pnonce": f"n{w}"})] for w in range(FAN_IN)}))
        out.append(_member_round(agg, {w: _bucket_frames(w, 2, 3)
                                       for w in range(FAN_IN)}))
        read = _raw_read(agg.port)
        v = int(tv.decode(memoryview(read))[3]["version"])
        nm = _raw_read(agg.port, tv.encode(tv.READ, 0, None,
                                           extra={"cond": v}))
        merged = [f for f in rec.frames
                  if f[0] in (tv.PUSH_PULL, tv.PUSH)
                  and tv.decode(memoryview(f))[1] == AGG_WORKER_BASE]
        return out, read, nm, merged
    finally:
        agg.stop()
        rec.close()


@LOOP
def test_member_replies_and_merged_frames_are_the_reference_bytes(
        native_loop, ref_async, monkeypatch):
    from ps_tpu.backends.aggregator import AggregatorService as RefAgg
    from ps_tpu.obs import freshness as ref_freshness

    def stamp(wall=None, mono=None):
        return dict(FIXED_BIRTH)

    monkeypatch.setattr(ref_freshness, "birth_record", stamp)
    monkeypatch.setattr(freshness, "birth_record", stamp)
    runs = {}
    for name, make in (
            ("port", lambda u: AggregatorService(
                u, _params(), group_size=FAN_IN, native_loop=native_loop)),
            ("ref", lambda u: RefAgg(
                u, _ref_params(), group_size=FAN_IN,
                native_loop=native_loop))):
        # a port shard of its own for each: only the aggregator differs
        ps_tpu_torch.init(backend="cuda", mode="async", num_workers=FAN_IN,
                          dc_lambda=0.0, device="cpu")
        store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=LR,
                                     mode="async")
        store.init(_params())
        svc = AsyncPSService(store)
        try:
            runs[name] = _byte_run(make, svc.port)
            _assert_exact(store, {w: range(3) for w in range(FAN_IN)})
        finally:
            svc.stop()
            ps_tpu_torch.shutdown()
    port, ref = runs["port"], runs["ref"]
    rounds, read, nm, merged = port
    assert len(merged) == 3 and len(ref[3]) == 3
    for got, want in zip(merged, ref[3]):
        assert got == want
    ex = tv.decode(memoryview(merged[0]))[3]
    assert ex["members"] == {"0": ["n0", 1], "1": ["n1", 1]}
    assert "members_tc" not in ex
    for r_port, r_ref in zip(rounds, ref[0]):
        assert r_port == r_ref
    # the bucketed round: staged acks, then the committed one
    last = tv.decode(memoryview(rounds[2][0][-1]))
    assert last[0] == tv.OK and last[3]["committed"] is True
    assert read == ref[1] and nm == ref[2]
    assert nm[0] == tv.NOT_MODIFIED
    assert tv.decode(memoryview(read))[3]["birth"] == FIXED_BIRTH["birth"]


# -- processes (the van harness's agg-server and worker roles) ----------------


def test_agg_server_process_group_on_the_loop(tmp_path):
    """An ``agg-server`` process on the native loop and three ``worker``
    processes given ``aggregator=`` over the shm lane, in lockstep rounds
    against a shard in this process: the shard's params are bitwise the
    closed form, one merged apply a round from the aggregator's identity,
    the realized fan-in is 3, and the aggregator launched no kernel and
    never initialized CUDA (what phase 22 (a) of ``chip_smoke.py`` holds
    on the card at the trainer's width)."""
    import json

    from tests import test_torch_van_harness as harness

    hidden, fan_in, cycles, lr = 8, 3, 4, 0.5
    params0 = harness.agg_tree(hidden)
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=fan_in,
                      dc_lambda=0.0, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=lr,
                                 mode="async")
    store.init({k: torch.from_numpy(v) for k, v in params0.items()})
    svc = AsyncPSService(store, record_full_history=True)
    out = str(tmp_path)
    procs = [harness.spawn("agg-server", out, f"127.0.0.1:{svc.port}",
                           fan_in, json.dumps({"hidden": hidden}))]
    member = json.dumps({"aggregator": "@", "hidden": hidden, "shm": True})
    procs += [harness.spawn("worker", svc.port, out, w, cycles, fan_in,
                            member)
              for w in range(fan_in)]
    try:
        outs = harness.finish(procs[1:], wall_s=120, fail_fast=True)
        for p, o in zip(procs[1:], outs):
            assert p.returncode == 0, o
        open(tmp_path / "agg_done", "w").close()
        outs = harness.finish(procs[:1], wall_s=60)
        assert procs[0].returncode == 0, outs[0]
        want = harness.agg_expected(
            params0, {w: range(cycles) for w in range(fan_in)}, lr)
        for k, v in store._engine._params.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        assert svc.apply_log.total == cycles
        assert set(svc._applied) == {AGG_WORKER_BASE}
        info = json.loads((tmp_path / "agg.json").read_text())
        assert info["rounds"] == cycles
        assert info["summary"]["agg_fan_in"] == fan_in
        assert len(info["hold_s"]) == cycles * fan_in
        assert not any(v for k, v in info["launches"].items()
                       if k != "by_rule") and not info["launches"]["by_rule"]
        assert info["cuda_initialized"] is False
        assert info["loop_pushes"] == 0  # every member rode the rings
        for w in range(fan_in):
            rec = json.loads((tmp_path / f"worker{w}.json").read_text())
            assert rec["aggregated"] and rec["agg_degrades"] == 0
            assert rec["lane"] == "shm"
            assert rec["versions"] == list(range(1, cycles + 1))
    finally:
        harness.kill_all(procs)
        svc.stop()
