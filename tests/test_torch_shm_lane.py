"""The port's same-host shared-memory lane (``ps_tpu_torch/control/
shm_lane.py``) against the reference's (``ps_tpu/control/shm_lane.py``).

- Rings interoperate: frames the port's ``ShmRing`` writes are read by
  the reference's from the same segment, and the reverse, byte for byte,
  over sizes that wrap the ring many times (the wrap sentinel and a
  remainder under 8 bytes included).
- Faults: a frame larger than half the ring spills to TCP and is counted;
  a peer that dies raises ``VanError`` (``ServerFailureError`` at a
  worker) within bounded time; an offer with another host's boot id is
  refused and the worker stays on TCP with the same results; a server
  with the lane turned off refuses too; segments are unlinked at close.
- Services: a port worker with ``shm=True`` against the reference's
  ``serve_async``, and a reference worker against the port's, over rings,
  serial and bucketed: the server's parameters are bitwise those of the
  same run over TCP. The sparse worker over rings against the port's
  ``serve_sparse`` replays bitwise through the port's tables.

Every comparison is exact (tolerance 0).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.common import ServerFailureError
from ps_tpu_torch.backends.remote_async import connect_async, serve_async
from ps_tpu_torch.control import shm_lane
from ps_tpu_torch.control import tensor_van as tv
from tests import test_torch_van_harness as harness

RING = 1 << 16  # the smallest ring the lane takes


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _ref_lane():
    from ps_tpu.control import shm_lane as ref

    return ref


def _frames(seed, n=400):
    rng = np.random.default_rng(seed)
    sizes = rng.choice([0, 1, 7, 8, 9, 100, 4095, 4096, 9000, 30000], n)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_rings_interoperate_both_ways(writer):
    """One segment; the writer package's ShmRing produces, the other's
    consumes, in place: every frame arrives whole and in order across
    many wraps."""
    ref = _ref_lane()
    mine, theirs = (shm_lane, ref) if writer == "port" else (ref, shm_lane)
    seg = mine._create(mine._DATA + RING)
    peer = theirs._attach(seg.name)
    try:
        tx, rx = mine.ShmRing(seg.buf), theirs.ShmRing(peer.buf)
        assert tx.cap == rx.cap == RING
        wraps = 0
        for frame in _frames(1 if writer == "port" else 2):
            before = tx._tail % tx.cap
            assert tx.try_send([frame], len(frame))  # drained each time
            if (tx._tail % tx.cap) < before:
                wraps += 1
            view, advance = rx.try_peek()
            assert bytes(view) == frame
            rx.consume(advance)
            assert rx.try_peek() is None
        assert wraps > 20
    finally:
        for s in (peer, seg):
            s.close()
        seg.unlink()


def test_wrap_sentinel_and_short_remainder_are_the_references():
    """A frame that does not fit the contiguous rest leaves the
    sentinel (2**64-1) at the old position and starts at offset 0; a
    rest under 8 bytes is skipped without one. The reference's consumer
    follows both."""
    ref = _ref_lane()
    seg = shm_lane._create(shm_lane._DATA + RING)
    peer = ref._attach(seg.name)
    try:
        tx, rx = shm_lane.ShmRing(seg.buf), ref.ShmRing(peer.buf)
        top = tx.max_frame()

        def through(frame):
            assert tx.try_send([frame], len(frame))
            view, adv = rx.try_peek()
            assert bytes(view) == frame
            rx.consume(adv)

        through(b"a" * (top - 100))
        through(b"b" * top)
        pos = tx._tail % tx.cap
        assert tx.cap - pos == 100  # a 200-byte frame cannot fit the rest
        through(b"c" * 200)
        assert shm_lane._U64.unpack_from(tx._data, pos)[0] == shm_lane._WRAP
        assert tx._tail % tx.cap == 208
        # leave a remainder of 4 bytes: no room for a sentinel
        through(b"d" * top)
        rest = tx.cap - tx._tail % tx.cap
        through(b"e" * (rest - 8 - 4))
        assert tx.cap - tx._tail % tx.cap == 4
        through(b"tail")
        assert tx._tail % tx.cap == 12
        # a full ring refuses until the consumer moves
        assert tx.try_send([b"f" * top], top)
        assert not tx.try_send([b"g" * top], top)
    finally:
        peer.close()
        seg.close()
        seg.unlink()


def _job(params, num_workers=1, **svc_kw):
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=num_workers,
                      dc_lambda=harness.DC_LAMBDA, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=harness.LR,
                                 mode="async")
    store.init({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    svc = serve_async(store, **svc_kw)
    return store, svc, f"127.0.0.1:{svc.port}"


def _finish(store, svc):
    out = {k: v.numpy().copy() for k, v in store._engine._params.items()}
    svc.stop()
    ps_tpu_torch.shutdown()
    return out


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_oversize_frame_spills_to_tcp_and_is_counted():
    params = {"w": np.ones((256, 256), np.float32)}  # 256 KiB frames
    store, svc, uri = _job(params)
    try:
        w = connect_async(uri, 0, _t(params), shm=True, shm_bytes=1 << 17)
        assert isinstance(w._chs[0], shm_lane.ShmChannel)
        p = w.push_pull({"w": torch.full((256, 256), 0.1)})
        assert w.transport.shm_spill_frames > 0
        assert w.transport.lane() == "shm+tcp"
        assert svc.transport.shm_spill_frames > 0  # the reply spilled too
        want = np.float32(1) - np.float32(harness.LR) * np.float32(0.1)
        assert (p["w"].numpy() == want).all()
        w.close()
    finally:
        _finish(store, svc)


def test_peer_death_raises_typed_failure_in_bounded_time():
    params = {"w": np.ones((64, 64), np.float32)}
    store, svc, uri = _job(params)
    w = connect_async(uri, 0, _t(params), shm=True, shm_bytes=1 << 18)
    try:
        assert isinstance(w._chs[0], shm_lane.ShmChannel)
        w.push_pull({"w": torch.full((64, 64), 0.1)})
        svc.kill()
        t0 = time.monotonic()
        with pytest.raises(ServerFailureError):
            for _ in range(4):
                w.push_pull({"w": torch.full((64, 64), 0.1)})
        assert time.monotonic() - t0 < 30.0
        # the lane's own recv raises the van's typed error
        with pytest.raises(tv.VanError):
            w._chs[0].recv()
    finally:
        try:
            w.close()
        except Exception:
            pass
        _finish(store, svc)


@pytest.mark.parametrize("why", ["boot-id", "server-off"])
def test_refused_upgrade_keeps_tcp_with_the_same_result(monkeypatch, why):
    params = {"w": np.ones((32, 32), np.float32)}
    g = {"w": torch.full((32, 32), 0.1)}
    finals = []
    for shm in (False, True):
        if why == "boot-id":
            monkeypatch.setenv("PS_SHM_BOOT_ID", "another-host")
        store, svc, uri = _job(params, **({"shm": False}
                                          if why == "server-off" else {}))
        try:
            w = connect_async(uri, 0, _t(params), shm=shm)
            assert isinstance(w._chs[0], tv.Channel)  # not upgraded
            assert w.transport.lane() == "tcp"
            w.push_pull(g)
            w.close()
        finally:
            finals.append(_finish(store, svc))
    assert finals[0]["w"].tobytes() == finals[1]["w"].tobytes()


def test_segments_are_unlinked_at_close():
    params = {"w": np.ones((16, 16), np.float32)}
    store, svc, uri = _job(params)
    try:
        w = connect_async(uri, 0, _t(params), bucket_bytes=1 << 12,
                          shm=True, shm_bytes=1 << 17)
        lanes = [w._chs[0]] + [p._ch for p in w._pumps[0]]
        assert all(ch.lane == "shm" for ch in lanes)
        names = [seg.name for ch in lanes for seg in ch._segs]
        assert len(names) == 2 * len(lanes)
        assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
        w.pull_all()
        w.close()
        assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    finally:
        _finish(store, svc)


def _run_port_server(params, seq, worker_pkg, shm, bucket_bytes):
    """(the server's ring frames, its final parameters)."""
    store, svc, uri = _job(params)
    try:
        _drive(worker_pkg, uri, params, seq, shm, bucket_bytes)
        frames = svc.transport.shm_frames
    finally:
        final = _finish(store, svc)
    return frames, final


def _drive(pkg, uri, params, seq, shm, bucket_bytes):
    if pkg == "port":
        w = connect_async(uri, 0, _t(params), bucket_bytes=bucket_bytes,
                          shm=shm, shm_bytes=1 << 18)
        conv = _t
    else:
        import jax.numpy as jnp

        from ps_tpu.backends.remote_async import connect_async as ref_connect

        w = ref_connect(uri, 0, {k: jnp.asarray(v) for k, v in
                                 params.items()},
                        bucket_bytes=bucket_bytes, shm=shm,
                        shm_bytes=1 << 18)

        def conv(g):
            return {k: jnp.asarray(v) for k, v in g.items()}
    assert (w._chs[0].lane == "shm") == shm
    w.pull_all()
    for g in seq:
        w.push_pull(conv(g))
    if shm:
        assert w.transport.shm_frames > 0
        assert w.transport.shm_spill_frames == 0
    w.close()


def _run_ref_server(params, seq, worker_pkg, shm, bucket_bytes):
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import serve_async as ref_serve

    ps_tpu.init(backend="tpu", mode="async", num_workers=1,
                dc_lambda=harness.DC_LAMBDA)
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=harness.LR,
                               mode="async")
        store.init({k: jnp.asarray(v) for k, v in params.items()})
        svc = ref_serve(store)
        try:
            _drive(worker_pkg, f"127.0.0.1:{svc.port}", params, seq, shm,
                   bucket_bytes)
            frames = svc.transport.shm_frames
        finally:
            svc.stop()
        return frames, {k: np.asarray(v).copy()
                        for k, v in store._engine._params.items()}
    finally:
        ps_tpu.shutdown()


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 12],
                         ids=["serial", "bucketed"])
@pytest.mark.parametrize("server", ["port", "ref"])
def test_workers_over_rings_interoperate_and_equal_tcp(server, bucket_bytes):
    """The other package's worker over rings against this server, then
    the same over TCP: the server reaches the same parameters bitwise,
    and its lane counted the frames."""
    params = harness.model_params()
    seq = [harness.make_grads(params, 0, c) for c in range(4)]
    run = _run_port_server if server == "port" else _run_ref_server
    worker = "ref" if server == "port" else "port"
    frames, over_rings = run(params, seq, worker, True, bucket_bytes)
    assert frames > 0
    _, over_tcp = run(params, seq, worker, False, bucket_bytes)
    for k, v in over_tcp.items():
        assert over_rings[k].tobytes() == v.tobytes(), k


def test_sparse_worker_over_rings_replays_bitwise():
    """Two sparse shards served in this process, one worker over rings,
    6 cycles of the harness's small shape (pull + push, push_pull): the
    shards' tables and state equal the replay's bitwise."""
    from ps_tpu_torch.backends.remote_sparse import (SparsePSService,
                                                     connect_sparse)
    from ps_tpu_torch.ops.sparse_apply import state_leaves

    ps_tpu_torch.init(backend="cuda", device="cpu")
    totals = {n: v for n, (v, _) in harness.sparse_spec("small").items()}
    svcs = [SparsePSService(harness.sparse_tables("small", s, 2), shard=s,
                            num_shards=2, total_rows=totals,
                            record_full_history=True) for s in range(2)]
    try:
        w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs), 0,
                           harness.sparse_spec("small"), shm=True)
        assert all(ch.lane == "shm" for ch in w._chs)
        ids = harness.sparse_ids("small", 0, 6)
        for c in range(6):
            pushes = {n: (ids[c], harness.sparse_grads("small", 0, c, n,
                                                       ids[c].size))
                      for n in harness.SPARSE_TABLES}
            req = {n: ids[c] for n in harness.SPARSE_TABLES}
            if c % 2 == 0:
                w.pull(req)
                w.push(pushes)
            else:
                w.push_pull(pushes, req)
        assert w.transport.shm_frames > 0
        w.close()
        infos = [{"apply_log": list(s.apply_log), "versions": s.versions}
                 for s in svcs]
        replayed, _ = harness.sparse_replay(infos, "small", 1, 6)
        for s, svc in enumerate(svcs):
            assert svc.transport.shm_frames > 0
            for n, emb in svc._tables.items():
                got = [emb.table] + state_leaves(emb.state())
                want = [replayed[s][n].table] + state_leaves(
                    replayed[s][n].state())
                assert all(torch.equal(a, b) for a, b in zip(got, want)), n
    finally:
        for s in svcs:
            s.stop()


def test_server_lane_holds_a_ring_frame_until_the_next_recv():
    """The server's lane hands a request out in place and gives its bytes
    back to the worker only at the next recv: a reply built from views of
    the request (an echo) is sent before the ring can reuse them."""
    lst = tv.Listener(bind="127.0.0.1")
    got = {}

    def serve():
        ch = lst.accept(timeout_ms=10_000)
        kind, worker, _, extra = tv.decode(ch.recv())
        lane = shm_lane.accept_upgrade(ch, extra)
        ch.send(tv.encode(tv.OK, worker, None, extra={"shm": True}))
        for _ in range(3):
            msg = lane.recv()
            kind, worker, tensors, extra = tv.decode(msg)
            got.setdefault("pending", []).append(lane._pending_advance > 0)
            lane.send_parts(*tv.encode_parts(tv.OK, worker, tensors, extra))
        lane.close()

    t = threading.Thread(target=serve)
    t.start()
    try:
        ch = tv.Channel.connect("127.0.0.1", lst.port)
        up = shm_lane.try_upgrade(ch, 3, shm_bytes=RING)
        assert isinstance(up, shm_lane.ShmChannel)
        for i in range(3):
            tree = {"x": np.full(5000, i, np.float32)}
            reply = up.request(tv.encode(tv.PUSH, 3, tree, {"i": i}))
            assert bytes(reply) == bytes(tv.encode(tv.OK, 3, tree, {"i": i}))
        up.close()
    finally:
        t.join(timeout=10)
        lst.close()
    assert got["pending"] == [True, True, True]
