"""The port's native epoll serve loop (``ps_tpu_torch/control/
native_loop.py``, ``VanService(native_loop=True)``) and its native push
admission, against thread-per-connection serving and the reference.

- Echo and a frame far past the socket buffers round trip through the
  loop; the refusals are byte-identical to the threaded path's and to the
  reference's for the same errors.
- The dense and the sparse services land the same parameters and tables
  bitwise on the loop as thread per connection, serial and bucketed,
  raw and codec-compressed; the reference's sparse service over the
  ``_RefTable`` shim (its own apply hits R1) gives a port worker on its
  loop the tables it gives it thread per connection.
- The drain contract: stop() mid-burst loses no acked push; a checkpoint
  pause parks pushes off the pump, which still serves STATS, and the
  resume lands them; stop() discounts a pause-parked push; kill() drops
  the queued frames unapplied; a goodbye is counted.
- An shm offer detaches the connection to a serve thread of its own and
  its frames ride the rings (dense and sparse).
- Native push admission: a replayed dense PUSH is acked inside the loop
  with the bytes of the port's pump ack and of the reference's native
  ack, the version unmoved; the sparse native ack equals the port's pump
  ack and the reference's (over the shim); a fresh push after it still
  applies once; ``PS_PUSH_NATIVE_ADMIT`` arms it or not.
- The read cache's calls raise naming item 5.8; loop_threads clamps;
  the slow-frame watchdog counts its frames and leaves them in its ring.

Every comparison is exact (tolerance 0).
"""

import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.backends.remote_sparse import (SparsePSService,
                                                 connect_sparse)
from ps_tpu_torch.backends.van_service import NotServingError, VanService
from ps_tpu_torch.control import native_loop as nl
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.ops.sparse_apply import state_leaves
from tests import test_torch_van_harness as harness

SHAPE = "small"
SPEC = harness.sparse_spec(SHAPE)
TOTALS = {n: v for n, (v, _) in SPEC.items()}


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def test_loop_is_available_here():
    assert nl.available()


class Echo(VanService):
    def __init__(self, **kw):
        self._lock = threading.Lock()
        super().__init__(**kw)

    def _handle(self, kind, worker, tensors, extra):
        return tv.encode_parts(tv.OK, worker, dict(tensors), extra)

    def _set_draining(self):
        pass

    def _service_lock(self):
        return self._lock


class Refuser(Echo):
    def _handle(self, kind, worker, tensors, extra):
        if extra.get("mode") == "fenced":
            raise NotServingError("fenced mid-commit: retry at the new "
                                  "primary")
        raise ValueError("boom")


def _request(port, payload):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        return bytes(ch.request(payload))
    finally:
        ch.close()


def test_echo_and_a_big_frame_round_trip():
    svc = Echo(native_loop=True)
    assert svc.native_loop
    try:
        x = np.arange(1000, dtype=np.float32)
        kind, w, t, e = tv.decode(memoryview(_request(
            svc.port, tv.encode(tv.PUSH, 3, {"x": x}, {"tag": 7}))))
        assert kind == tv.OK and w == 3 and e["tag"] == 7
        assert t["x"].tobytes() == x.tobytes()
        big = np.random.default_rng(0).normal(size=(6 << 20) // 8)
        kind, _, t, _ = tv.decode(memoryview(_request(
            svc.port, tv.encode(tv.PUSH, 0, {"b": big}))))
        assert kind == tv.OK and t["b"].tobytes() == big.tobytes()
    finally:
        svc.stop()


def test_refusals_byte_identical_to_threaded_and_reference():
    from ps_tpu.backends.van_service import NotServingError as RefNotServing
    from ps_tpu.backends.van_service import VanService as RefVanService

    class RefRefuser(RefVanService):
        def _handle(self, kind, worker, tensors, extra):
            if extra.get("mode") == "fenced":
                raise RefNotServing("fenced mid-commit: retry at the new "
                                    "primary")
            raise ValueError("boom")

        def _set_draining(self):
            pass

    frames = [tv.encode(tv.PUSH, 5, None, {"mode": "fenced"}),
              tv.encode(tv.PUSH, 5, None, {"mode": "crash"})]

    def collect(svc):
        try:
            return [_request(svc.port, f) for f in frames]
        finally:
            svc.stop()

    native = collect(Refuser(native_loop=True))
    assert native == collect(Refuser(native_loop=False))
    assert native == collect(RefRefuser(native_loop=False))
    kind, _, _, extra = tv.decode(memoryview(native[0]))
    assert kind == tv.ERR and extra["backup"] is True


def _dense_tree():
    rng = np.random.default_rng(1)
    return ({"w": rng.normal(size=(32, 16)).astype(np.float32),
             "b": rng.normal(size=(16,)).astype(np.float32)},
            [{"w": rng.normal(size=(32, 16)).astype(np.float32) * 1e-2,
              "b": rng.normal(size=(16,)).astype(np.float32) * 1e-2}
             for _ in range(6)])


def _dense_run(native, bucket_bytes=None, compress=None, shm=None):
    tree, grads = _dense_tree()
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.05,
                                 mode="async")
    store.init({k: torch.from_numpy(v) for k, v in tree.items()})
    svc = AsyncPSService(store, native_loop=native)
    assert svc.native_loop == native
    try:
        w = connect_async(f"127.0.0.1:{svc.port}", 0,
                          {k: torch.from_numpy(v) for k, v in tree.items()},
                          bucket_bytes=bucket_bytes, compress=compress,
                          shm=shm)
        w.pull_all()
        for g in grads:
            w.push_pull({k: torch.from_numpy(v) for k, v in g.items()})
        w.close()
        return ({k: v.numpy().copy()
                 for k, v in store._engine._params.items()}, svc)
    finally:
        svc.stop()
        ps_tpu_torch.shutdown()


@pytest.mark.parametrize("compress", [None, {"codec": "int8",
                                             "min_bytes": 256}],
                         ids=["raw", "int8"])
@pytest.mark.parametrize("bucket_bytes", [None, 512],
                         ids=["serial", "bucketed"])
def test_dense_service_bitwise_equal_to_threaded(bucket_bytes, compress):
    (a, svc), (b, _) = (_dense_run(True, bucket_bytes, compress),
                        _dense_run(False, bucket_bytes, compress))
    assert svc.transport.loop_upcalls >= 1
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _sparse_services(native, tables=None, **kw):
    return [SparsePSService(tables[s] if tables else
                            harness.sparse_tables(SHAPE, s, 2),
                            shard=s, num_shards=2, total_rows=TOTALS,
                            native_loop=native, **kw) for s in range(2)]


def _sparse_cycles(w, cycles=6, worker=0):
    ids = harness.sparse_ids(SHAPE, worker, cycles)
    pulled = []
    for c in range(cycles):
        pushes = {n: (ids[c], harness.sparse_grads(SHAPE, worker, c, n,
                                                   ids[c].size))
                  for n in SPEC}
        req = {n: ids[c] for n in SPEC}
        if c % 2 == 0:
            pulled.append(w.pull(req))
            w.push(pushes)
        else:
            pulled.append(w.push_pull(pushes, req))
    return pulled


def _port_state(svcs):
    return [{n: [emb.table.clone()] + [x.clone() for x in
                                       state_leaves(emb.state())]
             for n, emb in s._tables.items()} for s in svcs]


@pytest.mark.parametrize("compress", [None, {"codec": "cast16",
                                             "min_bytes": 64}],
                         ids=["raw", "cast16"])
@pytest.mark.parametrize("bucket_bytes", [None, 256],
                         ids=["serial", "bucketed"])
def test_sparse_service_bitwise_equal_to_threaded(bucket_bytes, compress):
    ps_tpu_torch.init(backend="cuda", device="cpu")
    states = []
    for native in (True, False):
        svcs = _sparse_services(native)
        try:
            w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs),
                               0, SPEC, bucket_bytes=bucket_bytes,
                               compress=compress)
            _sparse_cycles(w)
            w.close()
            assert all(s.native_loop == native for s in svcs)
            states.append(_port_state(svcs))
        finally:
            for s in svcs:
                s.stop()
    for x, y in zip(*states):
        for n in x:
            assert all(torch.equal(a, b) for a, b in zip(x[n], y[n])), n


def test_reference_sparse_service_on_its_loop_serves_a_port_worker():
    """The reference's SparsePSService over the _RefTable shim (its own
    sparse apply hits R1), native loop against thread per connection: a
    port worker leaves the same tables and pulls the same rows."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from tests.test_torch_remote_sparse import _ref_tables

    runs = []
    for native in (True, False):
        svcs = [RefService(_ref_tables(s, 2), shard=s, num_shards=2,
                           total_rows=TOTALS, native_loop=native)
                for s in range(2)]
        try:
            assert all(s.native_loop == native for s in svcs)
            w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs),
                               0, SPEC)
            pulled = _sparse_cycles(w)
            w.close()
            runs.append((pulled, [{n: np.asarray(s._tables[n].table).copy()
                                   for n in SPEC} for s in svcs]))
        finally:
            for s in svcs:
                s.stop()
    for a, b in zip(runs[0][0], runs[1][0]):
        for n in SPEC:
            assert a[n].numpy().tobytes() == b[n].numpy().tobytes()
    for a, b in zip(runs[0][1], runs[1][1]):
        for n in SPEC:
            assert a[n].tobytes() == b[n].tobytes()


def _async_store(num_workers, shape=(64, 8), seed=2):
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=num_workers,
                      device="cpu")
    rng = np.random.default_rng(seed)
    tree = {"w": torch.from_numpy(rng.normal(size=shape).astype(np.float32))}
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.01,
                                 mode="async")
    store.init(tree)
    return store, tree


def test_stop_mid_burst_loses_no_acked_push():
    store, tree = _async_store(4)
    svc = AsyncPSService(store, native_loop=True)
    grads = {"w": torch.full((64, 8), 1e-3)}
    acked = [0] * 4

    def worker(i):
        w = connect_async(f"127.0.0.1:{svc.port}", i, tree)
        w.pull_all()
        try:
            while True:
                w.push_all(grads)
                acked[i] += 1
        except Exception:
            pass  # the typed sever once stop() lands

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 60
    while sum(acked) < 12 and time.monotonic() < deadline:
        time.sleep(0.02)
    svc.stop()
    for t in ts:
        t.join(timeout=30)
    assert sum(acked) >= 12, "the burst never got going"
    assert svc.apply_log.total >= sum(acked)


def test_checkpoint_pause_never_wedges_the_pump():
    store, tree = _async_store(1, (16, 8), 4)
    svc = AsyncPSService(store, native_loop=True)
    try:
        w = connect_async(f"127.0.0.1:{svc.port}", 0, tree)
        w.pull_all()
        grads = {"w": torch.full((16, 8), 1e-3)}
        w.push_all(grads)
        coord = tv.Channel.connect("127.0.0.1", svc.port)
        kind, _, _, extra = tv.decode(coord.request(
            tv.encode(tv.CHECKPOINT, 9, None, extra={"phase": "pause"})))
        assert kind == tv.OK
        done = []
        pusher = threading.Thread(
            target=lambda: (w.push_all(grads), done.append(1)), daemon=True)
        pusher.start()
        time.sleep(0.3)
        assert not done, "a push landed during the pause"
        kind, _, _, st = tv.decode(memoryview(_request(
            svc.port, tv.encode(tv.STATS, 9, None))))
        assert kind == tv.OK and "loop" in st, "the pump wedged"
        kind, _, _, _ = tv.decode(coord.request(tv.encode(
            tv.CHECKPOINT, 9, None,
            extra={"phase": "resume", "token": extra["token"]})))
        assert kind == tv.OK
        pusher.join(timeout=30)
        assert done, "the paused push never landed"
        assert svc._engine.version == 2
        coord.close()
        w.close()
    finally:
        svc.stop()


def test_stop_discounts_pause_parked_requests():
    store, tree = _async_store(1, (8, 4), 5)
    svc = AsyncPSService(store, native_loop=True)
    w = connect_async(f"127.0.0.1:{svc.port}", 0, tree)
    w.pull_all()
    grads = {"w": torch.full((8, 4), 1e-3)}
    w.push_all(grads)
    coord = tv.Channel.connect("127.0.0.1", svc.port)
    kind, _, _, _ = tv.decode(coord.request(
        tv.encode(tv.CHECKPOINT, 9, None, extra={"phase": "pause"})))
    assert kind == tv.OK

    def push():
        try:
            w.push_all(grads)
        except Exception:
            pass  # refused by the draining flag

    pusher = threading.Thread(target=push, daemon=True)
    pusher.start()
    deadline = time.monotonic() + 10
    while svc._pause_blocked < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert svc._pause_blocked >= 1 and svc._loop_pause_parked >= 1
    t0 = time.monotonic()
    svc.stop(grace=8.0)
    assert time.monotonic() - t0 < 6.0, "stop() waited out a parked push"
    pusher.join(timeout=10)
    assert svc._engine.version == 1  # the parked push was refused
    coord.close()
    w.close()


def test_kill_drops_queued_requests():
    handled = []

    class SlowEcho(Echo):
        def _handle(self, kind, worker, tensors, extra):
            handled.append(worker)
            time.sleep(0.3)
            return super()._handle(kind, worker, tensors, extra)

    svc = SlowEcho(native_loop=True)
    chs = [tv.Channel.connect("127.0.0.1", svc.port) for _ in range(6)]
    for i, ch in enumerate(chs):
        ch.send(tv.encode(tv.PUSH, i, {"x": np.zeros(16, np.float32)}))
    deadline = time.monotonic() + 10
    while not handled and time.monotonic() < deadline:
        time.sleep(0.01)
    assert handled, "the pump never started"
    svc.kill()
    svc._pump_thread.join(timeout=10)
    assert not svc._pump_thread.is_alive()
    assert len(handled) <= 3, f"kill() applied {len(handled)}/6 frames"
    for ch in chs:
        ch.close()


def test_goodbye_is_counted_and_kill_severs():
    svc = Echo(native_loop=True)
    ch = tv.Channel.connect("127.0.0.1", svc.port)
    kind, _, _, _ = tv.decode(ch.request(tv.encode(tv.SHUTDOWN, 0, None)))
    assert kind == tv.OK and svc.wait_for_goodbyes(1, timeout=10)
    ch.close()
    ch2 = tv.Channel.connect("127.0.0.1", svc.port)
    svc.kill()
    with pytest.raises(tv.VanError):
        for _ in range(10):
            ch2.request(tv.encode(tv.PUSH, 0, None))
            time.sleep(0.1)
    ch2.close()


def test_shm_upgrade_detaches_to_a_thread_and_carries_the_frames():
    (a, svc), (b, _) = (_dense_run(True, shm=True), _dense_run(False))
    assert svc.transport.shm_frames > 0, "no frame rode the rings"
    assert svc.transport.shm_spill_frames == 0
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    ps_tpu_torch.init(backend="cuda", device="cpu")
    svcs = _sparse_services(True)
    try:
        w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs), 0,
                           SPEC, shm=True)
        assert all(ch.lane == "shm" for ch in w._chs)
        _sparse_cycles(w, 2)
        assert all(s.transport.shm_frames > 0 and len(s._conns) >= 1
                   for s in svcs)
        w.close()
    finally:
        for s in svcs:
            s.stop()


# -- native push admission ----------------------------------------------------


def _acks(stats, want):
    """The native ack count once it reached ``want`` (or after 5 s): the
    loop counts an ack just after writing its bytes, so the requester may
    read the counter a moment before it moves."""
    deadline = time.monotonic() + 5
    while stats()["acks"] < want and time.monotonic() < deadline:
        time.sleep(0.01)
    return stats()["acks"]


def _dense_admission_replies(monkeypatch, mode):
    """One PUSH with its token, then its replay, against a port service
    on the loop with admission ``mode``: (replies, service)."""
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", mode)
    store, _ = _async_store(1, (4, 3), 0)
    svc = AsyncPSService(store, native_loop=True)
    first = tv.encode(tv.PUSH, 0, {"w": np.full((4, 3), 0.1, np.float32)},
                      extra={"pseq": 1, "pnonce": "inc"})
    out = [_request(svc.port, first)]
    base = svc.admit_stats()
    out.append(_request(svc.port, bytes(first)))
    return out, svc, base


def test_dense_replay_ack_bytes_are_the_pumps_and_the_references(
        monkeypatch):
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    native, svc, base = _dense_admission_replies(monkeypatch, "on")
    try:
        assert svc._native_admit
        assert _acks(svc.admit_stats, base["acks"] + 1) == base["acks"] + 1
        assert svc._engine.version == 1  # the replay never applied
        kind, _, _, extra = tv.decode(memoryview(native[1]))
        assert kind == tv.OK and extra == {"version": 1, "dedup": True}
        fresh = tv.encode(tv.PUSH, 0, {"w": np.full((4, 3), 0.1,
                                                    np.float32)},
                          extra={"pseq": 2, "pnonce": "inc"})
        kind, _, _, extra = tv.decode(memoryview(_request(svc.port, fresh)))
        assert kind == tv.OK and extra["dedup"] is False
        assert svc._engine.version == 2
        assert svc.admit_stats()["fresh"] >= 1
    finally:
        svc.stop()
        ps_tpu_torch.shutdown()
    pump, svc, _ = _dense_admission_replies(monkeypatch, "off")
    try:
        assert not svc._native_admit
        assert svc.admit_stats()["acks"] == 0
    finally:
        svc.stop()
        ps_tpu_torch.shutdown()
    assert native == pump
    # the reference's native ack for the same push and replay
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", "on")
    ps_tpu.init(backend="tpu", mode="async", num_workers=1, dc_lambda=0.0)
    try:
        st = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.01,
                            mode="async")
        st.init({"w": jnp.zeros((4, 3))})
        ref = RefService(st, native_loop=True)
        try:
            first = tv.encode(tv.PUSH, 0, {"w": np.full((4, 3), 0.1,
                                                        np.float32)},
                              extra={"pseq": 1, "pnonce": "inc"})
            got = [_request(ref.port, first), _request(ref.port, first)]
            assert _acks(ref._nloop.admit_stats, 1) == 1
        finally:
            ref.stop()
    finally:
        ps_tpu.shutdown()
    assert got == native


def test_sparse_native_ack_equals_the_pump_ack_and_the_references(
        monkeypatch):
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from tests.test_torch_remote_sparse import _ref_tables

    ids = np.array([1, 5, 9], np.int32)
    first = tv.encode(tv.ROW_PUSH, 0, {
        "deep/ids": ids, "deep/grads": np.full((3, SPEC["deep"][1]), 0.25,
                                               np.float32)},
        extra={"pseq": 3, "pnonce": "inc"})
    replies = {}
    ps_tpu_torch.init(backend="cuda", device="cpu")
    for mode in ("auto", "off"):
        monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", mode)
        svc = SparsePSService(harness.sparse_tables(SHAPE, 0, 1),
                              native_loop=True)
        try:
            assert svc._native_admit == (mode == "auto")
            replies[mode] = [_request(svc.port, first),
                             _request(svc.port, first)]
            assert svc.versions == {"deep": 1, "wide": 0}
            want = 1 if mode == "auto" else 0
            assert _acks(svc.admit_stats, want) == want
        finally:
            svc.stop()
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", "on")
    ref = RefService(_ref_tables(0, 1), native_loop=True)
    try:
        replies["ref"] = [_request(ref.port, first),
                          _request(ref.port, first)]
        assert _acks(ref._nloop.admit_stats, 1) == 1
    finally:
        ref.stop()
    assert replies["auto"] == replies["off"] == replies["ref"]
    kind, _, _, extra = tv.decode(memoryview(replies["auto"][1]))
    assert kind == tv.OK and extra == {"versions": {"deep": 1, "wide": 0},
                                       "dedup": True}


def test_admission_is_dropped_at_a_pause_and_reseeded_at_the_resume():
    store, tree = _async_store(1, (4, 3), 0)
    svc = AsyncPSService(store, native_loop=True)
    try:
        push = tv.encode(tv.PUSH, 0, {"w": np.full((4, 3), 0.1, np.float32)},
                         extra={"pseq": 1, "pnonce": "inc"})
        _request(svc.port, push)
        assert svc.admit_stats()["entries"] == 1
        coord = tv.Channel.connect("127.0.0.1", svc.port)
        _, _, _, extra = tv.decode(coord.request(
            tv.encode(tv.CHECKPOINT, 9, None, extra={"phase": "pause"})))
        assert svc.admit_stats()["entries"] == 0  # every push to the pump
        tv.decode(coord.request(tv.encode(
            tv.CHECKPOINT, 9, None,
            extra={"phase": "resume", "token": extra["token"]})))
        assert svc.admit_stats()["entries"] == 1
        acks = svc.admit_stats()["acks"]
        _request(svc.port, push)  # the replay, acked natively again
        assert _acks(svc.admit_stats, acks + 1) == acks + 1
        assert svc._engine.version == 1
        coord.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("mode,armed", [("off", False), ("on", True),
                                        ("auto", True), ("bogus", True)])
def test_push_admit_knob(monkeypatch, mode, armed):
    """A service reads the knob itself: an unknown token warns and keeps
    'auto' (Config refuses it at init, so it is set after)."""
    store, _ = _async_store(1, (2, 2), 0)
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", mode)
    svc = AsyncPSService(store, native_loop=True)
    try:
        assert svc._native_admit is armed
    finally:
        svc.stop()
    ps_tpu_torch.shutdown()
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", "on")
    store, _ = _async_store(1, (2, 2), 0)
    svc = AsyncPSService(store, native_loop=False)  # no loop: never armed
    assert svc._native_admit is False and svc.admit_stats()["acks"] == 0
    svc.stop()


def test_native_loop_knob_and_loop_threads_clamp(monkeypatch):
    monkeypatch.setenv("PS_VAN_NATIVE_LOOP", "1")
    svc = Echo(loop_threads=99)
    try:
        assert svc.native_loop and svc._nloop.threads == 64
    finally:
        svc.stop()
    monkeypatch.setenv("PS_VAN_LOOP_THREADS", "3")
    svc = Echo()
    try:
        assert svc._nloop.threads == 3
        for i in range(6):  # connections spread over the loop's threads
            tv.decode(memoryview(_request(svc.port, tv.encode(
                tv.PUSH, i, {"x": np.ones(3, np.float32)}))))
    finally:
        svc.stop()
    monkeypatch.setenv("PS_VAN_NATIVE_LOOP", "0")
    svc = Echo()
    assert not svc.native_loop
    svc.stop()


def test_stats_carry_the_loops_counters_and_histograms():
    svc = Echo(native_loop=True)
    try:
        for i in range(4):
            _request(svc.port, tv.encode(tv.PUSH, i,
                                         {"x": np.zeros(4, np.float32)}))
        deadline = time.monotonic() + 5
        while ((svc.transport.loop_requests < 4
                or svc.transport.hist["nl_queue_wait_s"].total < 4)
               and time.monotonic() < deadline):
            time.sleep(0.05)  # the pump syncs on its next idle tick
        st = svc.replica_state()
        assert st["loop"]["requests"] >= 4
        assert st["loop"]["pushes"] == 4  # each PUSH dispatched by the pump
        assert svc.transport.loop_upcalls >= 1
        assert svc.transport.hist["nl_queue_wait_s"].total >= 4
        assert svc.transport.hist["nl_queue_wait_s"].summary()["p99"] >= 0
    finally:
        svc.stop()


def test_slow_frames_are_counted_and_left_in_the_loops_ring(monkeypatch):
    """A 1 ns threshold makes every pump-bound frame slow: the STATS
    reply counts them, and the loop's ring still holds them (nothing
    drains it until item 6's flight events) for ``slow_drain``."""
    monkeypatch.setenv("PS_NL_SLOW_FRAME_MS", "0.000001")
    svc = Echo(native_loop=True)
    try:
        for i in range(3):
            _request(svc.port, tv.encode(tv.PUSH, i,
                                         {"x": np.zeros(4, np.float32)}))
        deadline = time.monotonic() + 5
        while (svc.transport.nl_slow_frames < 3
               and time.monotonic() < deadline):
            time.sleep(0.05)  # the pump syncs on its next idle tick
        assert svc.replica_state()["loop"]["slow_frames"] >= 3
        frames = svc._nloop.slow_drain()
        assert len(frames) >= 3
        assert {f["kind"] for f in frames} == {tv.PUSH}
        assert svc._nloop.slow_drain() == []  # drained once
    finally:
        svc.stop()


def test_read_cache_calls_name_item_5_8():
    """The read cache's calls (item 5.8, once refused) are bound: a
    service on the loop configures the default budget at startup, a put
    at the current generation is taken and one below the floor an
    invalidation raised is refused, a conditional put keys on the
    request with its cond digits cut out, and the stats carry nine
    counters."""
    from ps_tpu_torch.utils.metrics import NL_HIST_KEYS

    svc = Echo(native_loop=True)
    try:
        assert svc._native_read_cache
        nloop = svc._nloop
        key = tv.encode(tv.READ, 0, None)
        assert nloop.cache_put(key, b"reply", 1)
        nloop.cache_invalidate(2)
        assert not nloop.cache_put(key, b"stale", 1)  # under the floor
        cond = tv.encode(tv.READ, 0, None, extra={"cond": 5})
        assert nloop.cache_put_cond(cond, bytes([tv.NOT_MODIFIED]), 2,
                                    vfloor=5)
        cs = nloop.cache_stats()
        assert set(cs) == {"hits", "misses", "puts", "rejects",
                           "invalidations", "entries", "bytes", "floor",
                           "cond_hits"}
        assert cs["puts"] == 2 and cs["rejects"] == 1 and cs["floor"] == 2
        assert cs["entries"] == 1 and cs["invalidations"] == 1
        assert set(NL_HIST_KEYS) <= {k for _, k in nl.NL_HISTS}
    finally:
        svc.stop()


# -- processes: every option at once -------------------------------------------

TRAINER = "ps_tpu_torch.examples.train_mnist_async"


@pytest.mark.parametrize("codec", ["raw", "int8", "cast16"])
def test_sparse_processes_on_the_loop_over_rings_replay_bitwise(tmp_path,
                                                                codec):
    """Two ``serve_sparse`` processes on the native loop, worker 0 over
    TCP (its frames stay on the loop: decoded, staged and freed by the
    pump, its flat pushes classified by native admission) and worker 1
    over the shm lane (detached to a serve thread), both with
    codec-compressed grads (256-byte floor, so a deep payload is encoded
    and a wide one is not): the apply logs replayed, each worker's grads
    through its codec, give the servers' tables and state bitwise, and
    every pulled row set equals the replay's."""
    import json

    spec = (None if codec == "raw"
            else {"codec": codec, "min_bytes": 256})
    srv = json.dumps({"native_loop": True})
    opts = [{"shm": False, "compress": spec}, {"shm": True, "compress": spec}]
    procs = [harness.spawn("sparse-server", tmp_path, 2, 6, s, 2, "cpu",
                           SHAPE, srv) for s in range(2)]
    procs += [harness.spawn("sparse-worker", "@2", tmp_path, w, 6, "cpu",
                            SHAPE, 2, 1, json.dumps(opts[w]))
              for w in range(2)]
    outs = harness.finish(procs, wall_s=180, fail_fast=True)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{o}"
    infos = [json.loads((tmp_path / f"sparse_server{s}.json").read_text())
             for s in range(2)]
    finals = [dict(np.load(tmp_path / f"sparse_tables{s}.npz"))
              for s in range(2)]
    records = [json.loads((tmp_path / f"sparse_worker{w}.json").read_text())
               for w in range(2)]
    pulls = {w: (dict(np.load(tmp_path / f"sparse_pulls{w}.npz")),
                 records[w]) for w in range(2)}
    harness.check_loop_carried(infos, opts, SHAPE, 6)
    for info in infos:
        assert info["shm_frames"] > 0 and info["shm_spills"] == 0
    assert records[0]["lane"] == "tcp"
    assert records[1]["lane"] == "shm" and records[1]["shm_frames"] > 0
    for r in records:
        if spec:
            assert r["encoded_keys"]["deep/grads"][0] > 0
            assert r["encoded_keys"]["wide/grads"][0] == 0
            assert r["codec_bytes"][1] < r["codec_bytes"][0]
    compress = ({w: r["compress"] for w, r in enumerate(records)}
                if spec else None)
    ps_tpu_torch.init(backend="cuda", device="cpu")
    tables, checked = harness.sparse_replay(infos, SHAPE, 2, 6, pulls=pulls,
                                            compress=compress)
    assert checked > 0
    for s, final in enumerate(finals):
        for n, emb in tables[s].items():
            leaves = [emb.table] + state_leaves(emb.state())
            saved = [final[n]] + [final[f"{n}/state{i}"]
                                  for i in range(len(leaves) - 1)]
            for x, y in zip(leaves, saved):
                assert x.numpy().tobytes() == y.tobytes(), (s, n)


def test_trainer_processes_with_every_option_replay_bitwise(tmp_path,
                                                            monkeypatch):
    """The MNIST trainer's ``--role server`` on the native loop
    (``PS_VAN_NATIVE_LOOP=1``) and three ``--role worker`` processes,
    bucketed: workers 0 and 2 over TCP (their frames stay on the loop),
    worker 1 over the shm lane (``PS_SHM=1``); 0 and 1 push
    topk-compressed gradients, 2 cast16 with its pulls cast16 too
    (``PS_COMPRESS_PULL=1``). The event log replayed with every codec
    (topk's residuals, the pulls' casts) gives the server's parameters
    bitwise."""
    import json

    common = ["--device", "cpu", "--batch-size", "16", "--dump", tmp_path]
    monkeypatch.setenv("PS_VAN_NATIVE_LOOP", "1")
    server = harness.spawn("--role", "server", "--port", 0,
                           "--num-workers", 3, *common, module=TRAINER)
    try:
        port = harness.trainer_port(server)
    except RuntimeError:
        harness.kill_all([server])
        raise
    workers = []
    for w, codec in enumerate(["topk", "topk", "cast16"]):
        monkeypatch.setenv("PS_SHM", "1" if w == 1 else "0")
        if codec == "cast16":
            monkeypatch.setenv("PS_COMPRESS_PULL", "1")
        workers.append(harness.spawn(
            "--role", "worker", "--server", f"127.0.0.1:{port}",
            "--worker-id", w, "--steps", 6, "--bucket-bytes", 16384,
            "--compress", codec, "--compress-topk", "0.05", *common,
            module=TRAINER))
    procs = [server] + workers
    outs = harness.finish(procs, wall_s=180)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{o}"
    info = json.loads((tmp_path / "server.json").read_text())
    final = torch.load(tmp_path / "server_params.pt")
    records = [json.loads((tmp_path / f"worker{w}.json").read_text())
               for w in range(3)]
    assert info["native_loop"] and info["version"] == 18
    # at least one bucket frame a push of each TCP worker reached the pump
    assert info["loop_pushes"] >= 2 * 6
    assert info["shm_frames"] > 0
    assert info["codec_bytes"][0] > info["codec_bytes"][1] > 0
    for w, r in enumerate(records):
        assert r["lane"] == ("shm" if w == 1 else "tcp")
        assert r["shm_spills"] == 0
        assert r["summary"]["compress_ratio"] > 1.5
    assert records[2]["compress"]["pull"] is True
    with harness.one_thread():
        got = harness.replay(
            [info["event_log"]], 3, "cpu", batch_size=16,
            compress={w: r["compress"] for w, r in enumerate(records)})
    for k in final:
        assert torch.equal(final[k], got[k]), k
