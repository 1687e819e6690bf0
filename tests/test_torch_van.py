"""The port's van plane against the reference's: the native van, the
frames, the channel, the buckets and the failure detector.

- ``ps_tpu_torch/native/van.cpp`` is the reference's file, byte for byte.
- Frames of the same seeded numpy trees (mixed dtypes, odd sizes,
  scalars, empty tensors) from ``encode``, ``encode_parts`` and
  ``encode_chunks_parts`` are byte-identical to
  ``ps_tpu.control.tensor_van``'s, a CPU tensor's frame is its numpy
  array's, and ``decode`` round-trips them; bucket frames likewise.
- ``Channel.connect`` resolves the host again on every attempt and caps
  its backoff at 2 s; the receive pool borrows, returns and counts hits
  (the reference's ``test_zero_copy_transport.py`` cases).
- ``BucketPlan``/``BucketAssembler``: the cases of ``test_bucket_plan.py``.
- The heartbeat and the detector: the cases of ``test_failure.py``
  (alive then dead, beat counts, two detectors, the peer wait's timeout,
  a clean leave, a forged goodbye, both binds), and the kill drill: three
  gloo ranks with heartbeats on, rank 2 dies hard after a step, and the
  other two get ``WorkerFailureError([2])`` from ``check_health()``.
"""

import json
import socket
import struct
import time

import numpy as np
import pytest
import torch

from ps_tpu_torch.backends.common import BucketAssembler, BucketPlan
from ps_tpu_torch.control import (
    FailureDetector,
    HeartbeatClient,
    HeartbeatServer,
    WorkerFailureError,
)
from ps_tpu_torch.control import tensor_van as tv
from tests import test_torch_van_harness as harness


def _wait_until(cond, timeout=5.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def test_native_van_is_the_references_file():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    port = (root / "ps_tpu_torch/native/van.cpp").read_bytes()
    assert port == (root / "ps_tpu/native/van.cpp").read_bytes()


def test_native_van_builds_into_the_checkouts_build_dir():
    from ps_tpu_torch import native

    native.load("van")
    lib = native.library_path("van")
    assert lib.exists()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "ps_tpu_torch")


# -- frames ---------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a/f32": rng.normal(0, 1, (13, 7)).astype(np.float32),
        "b/f16": rng.normal(0, 1, (9, 11)).astype(np.float16),
        "c/i32": rng.integers(-5, 5, (17,)).astype(np.int32),
        "d/f64": rng.normal(0, 1, (3, 5, 2)).astype(np.float64),
        "e/u8": rng.integers(0, 255, (101,)).astype(np.uint8),
        "f/scalar": np.asarray(np.float32(rng.normal())),
        "g/empty": np.zeros((0, 5), np.float32),
        "h/i64": rng.integers(-9, 9, (2, 3)).astype(np.int64),
    }


TREES = [
    ("mixed", _tree(0)),
    ("mixed-2", _tree(1)),
    ("single", {"w": np.arange(10, dtype=np.float32)}),
    ("empty-tree", {}),
    ("none", None),
]
EXTRAS = [None, {"version": 3, "pseq": 7, "pnonce": "abc"}]


@pytest.mark.parametrize("extra", EXTRAS, ids=["no-extra", "extra"])
@pytest.mark.parametrize("name,tree", TREES, ids=[t[0] for t in TREES])
def test_frames_are_the_references_bytes(name, tree, extra):
    from ps_tpu.control import tensor_van as ref

    want = bytes(ref.encode(ref.PUSH_PULL, 5, tree, extra))
    assert bytes(tv.encode(tv.PUSH_PULL, 5, tree, extra)) == want
    assert bytes(tv.assemble(*tv.encode_parts(tv.PUSH_PULL, 5, tree,
                                              extra))) == want
    if tree:
        tensors = {k: torch.from_numpy(v) for k, v in tree.items()}
        assert bytes(tv.encode(tv.PUSH_PULL, 5, tensors, extra)) == want
    kind, worker, got, ex = tv.decode(memoryview(want))
    assert (kind, worker, ex) == (tv.PUSH_PULL, 5, extra or {})
    assert sorted(got) == sorted(tree or {})
    for k, v in (tree or {}).items():
        # both packages frame a 0-d array as shape [1] (ascontiguousarray)
        v = np.ascontiguousarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("bucket_bytes", [1, 37, 1000, 1 << 20])
def test_bucket_frames_are_the_references_bytes(bucket_bytes):
    from ps_tpu.backends.common import BucketPlan as RefPlan
    from ps_tpu.control import tensor_van as ref

    arrays = {k: v for k, v in _tree(2).items()}
    plan = BucketPlan.from_arrays(arrays, bucket_bytes)
    rplan = RefPlan.from_arrays(arrays, bucket_bytes)
    assert plan.buckets == rplan.buckets
    for b in range(plan.nbuckets):
        want = bytes(rplan.encode_bucket(ref.BUCKET_PUSH, 1, arrays, b,
                                         extra={"epoch": 4}))
        assert bytes(plan.encode_bucket(tv.BUCKET_PUSH, 1, arrays, b,
                                        extra={"epoch": 4})) == want
        assert bytes(tv.assemble(*plan.encode_bucket_parts(
            tv.BUCKET_PUSH, 1, arrays, b, extra={"epoch": 4}))) == want
        chunks = [memoryview(bytes(range(7))), memoryview(b"xyz")]
        assert bytes(tv.assemble(*tv.encode_chunks_parts(
            tv.BUCKET_PULL, 2, chunks, {"bucket": b}))) == bytes(
            ref.encode_chunks(ref.BUCKET_PULL, 2, chunks, {"bucket": b}))


def test_kinds_are_the_references():
    from ps_tpu.control import tensor_van as ref

    assert tv.KIND_NAMES == ref.KIND_NAMES
    for name in ("HELLO", "PULL", "PUSH", "PUSH_PULL", "STATS", "SHUTDOWN",
                 "OK", "ERR", "CHECKPOINT", "BUCKET_PUSH", "BUCKET_PULL",
                 "SHM_SETUP", "READ", "REPLICA_SEED"):
        assert getattr(tv, name) == getattr(ref, name)
    assert tv.kind_name(99) == ref.kind_name(99) == "kind99"


def test_cuda_and_bf16_tensors_are_refused():
    with pytest.raises(TypeError, match="bfloat16"):
        tv.encode(tv.PUSH, 0, {"w": torch.ones(3, dtype=torch.bfloat16)})
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="stage it"):
            tv.encode(tv.PUSH, 0, {"w": torch.ones(3, device="cuda")})


def test_channel_round_trip_over_loopback():
    tree = _tree(3)
    with tv.Listener(bind="127.0.0.1") as lst:
        import threading

        def echo():
            ch = lst.accept(timeout_ms=10_000)
            kind, worker, tensors, extra = tv.decode(ch.recv())
            ch.send_parts(*tv.encode_parts(tv.OK, worker, tensors, extra))
            ch.close()

        t = threading.Thread(target=echo)
        t.start()
        ch = tv.Channel.connect("127.0.0.1", lst.port)
        reply = ch.request(tv.encode(tv.PUSH, 9, tree, {"k": 1}))
        t.join(timeout=10)
        assert bytes(reply) == bytes(tv.encode(tv.OK, 9, tree, {"k": 1}))
        with pytest.raises(tv.VanError):
            ch.recv()  # the peer closed
        with pytest.raises(tv.VanError, match="closed"):
            ch.send(b"x")


# -- channel satellites (test_zero_copy_transport.py) -----------------------


def test_connect_re_resolves_every_attempt(monkeypatch):
    calls = []
    real = socket.gethostbyname
    monkeypatch.setattr(socket, "gethostbyname",
                        lambda h: (calls.append(h), real(h))[1])
    t0 = time.monotonic()
    with pytest.raises(tv.VanError):
        tv.Channel.connect("127.0.0.1", 1, timeout_ms=200, retries=4,
                           retry_delay_s=0.05)
    dt = time.monotonic() - t0
    assert len(calls) == 4  # one resolution per attempt
    assert 0.05 < dt < 5.0


def test_connect_backoff_caps_at_two_seconds(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    with pytest.raises(tv.VanError):
        tv.Channel.connect("127.0.0.1", 1, timeout_ms=50, retries=10,
                           retry_delay_s=0.1)
    assert len(sleeps) == 9  # no sleep before the first attempt
    assert max(sleeps) <= 2.0 * 1.5 + 1e-9  # 0.5x..1.5x of a 2 s cap
    assert sleeps[0] < sleeps[-1]


def test_recv_buffer_pool_borrow_return_and_hit_rate():
    from ps_tpu_torch.utils.metrics import TransportStats

    stats = TransportStats()
    pool = tv.RecvBufferPool(min_bytes=1 << 10, max_per_class=2, stats=stats)
    assert pool.borrow(16) is None          # under the floor: no pooling
    b1 = pool.borrow(1 << 12)
    assert len(b1) == 1 << 12
    pool.ret(b1)
    b2 = pool.borrow(3000)                  # same power-of-two class
    assert b2 is b1                         # reused, not reallocated
    pool.ret(memoryview(b2)[:3000])         # returned as recv's view
    assert stats.pool_hits == 1 and stats.pool_misses == 1
    pool.ret(b2)                            # a second return is ignored
    pool.ret(bytearray(8))                  # so is a foreign buffer
    b3, b4, b5 = (pool.borrow(1 << 12), pool.borrow(1 << 12),
                  pool.borrow(1 << 12))
    for b in (b3, b4, b5):
        pool.ret(b)  # the class holds 2: the third return is dropped
    assert len(pool._free[12]) == 2
    assert stats.summary()["recv_pool_hit_rate"] == round(
        stats.pool_hits / (stats.pool_hits + stats.pool_misses), 4)


# -- BucketPlan / BucketAssembler (test_bucket_plan.py) ---------------------


def _round_trip(arrays, bucket_bytes):
    plan = BucketPlan.from_arrays(arrays, bucket_bytes)
    asm = BucketAssembler(epoch=7, nbuckets=plan.nbuckets)
    done = False
    for b in range(plan.nbuckets):
        frame = plan.encode_bucket(tv.BUCKET_PUSH, 3, arrays, b,
                                   extra={"epoch": 7})
        kind, worker, tensors, extra = tv.decode(memoryview(bytes(frame)))
        assert kind == tv.BUCKET_PUSH and worker == 3
        assert extra["epoch"] == 7 and extra["nbuckets"] == plan.nbuckets
        done = asm.add(extra["bucket"], tensors["raw"], extra["slices"],
                       extra["epoch"])
    assert done
    out = asm.finish()
    assert sorted(out) == sorted(arrays)
    for k, v in arrays.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    return plan


@pytest.mark.parametrize("bucket_bytes", [1, 37, 128, 1000, 1 << 20])
def test_round_trip_dtype_mix_and_odd_sizes(bucket_bytes):
    _round_trip({k: v for k, v in _tree(0).items()
                 if k not in ("f/scalar", "g/empty")}, bucket_bytes)


def test_large_tensor_splits_across_buckets():
    plan = _round_trip({"big/w": np.arange(10_000, dtype=np.float32)}, 1024)
    assert plan.nbuckets == int(np.ceil(40_000 / 1024))
    for bucket in plan.buckets[:-1]:  # every bucket but the last is full
        assert sum(hi - lo for _, _, _, lo, hi in bucket) == 1024


def test_small_tensors_fuse_into_one_bucket():
    plan = _round_trip({f"k{i:02d}": np.full((4,), i, np.float32)
                        for i in range(10)}, 1 << 20)
    assert plan.nbuckets == 1 and len(plan.buckets[0]) == 10


def test_zero_size_and_scalar_tensors():
    _round_trip({"empty": np.zeros((0, 5), np.float32),
                 "scalar": np.asarray(np.float32(3.5)).reshape(()),
                 "one": np.ones((1,), np.int32)}, 8)


def test_transport_order_is_sorted_keys():
    plan = BucketPlan.from_arrays({"z/last": np.zeros(4, np.float32),
                                   "a/first": np.ones(4, np.float32)},
                                  1 << 20)
    assert plan.buckets[0][0][0] == "a/first"  # front of the model first


def _first_bucket(arrays, bucket_bytes, epoch):
    plan = BucketPlan.from_arrays(arrays, bucket_bytes)
    frame = plan.encode_bucket(tv.BUCKET_PUSH, 0, arrays, 0,
                               extra={"epoch": epoch})
    _, _, tensors, extra = tv.decode(memoryview(bytes(frame)))
    return plan, tensors, extra


def test_epoch_mismatch_refused():
    arrays = {"w": np.arange(100, dtype=np.float32)}
    plan, tensors, extra = _first_bucket(arrays, 64, epoch=2)
    assert plan.nbuckets > 1
    asm = BucketAssembler(epoch=1, nbuckets=plan.nbuckets)
    with pytest.raises(RuntimeError, match="torn"):
        asm.add(extra["bucket"], tensors["raw"], extra["slices"],
                extra["epoch"])


def test_duplicate_bucket_refused():
    plan, tensors, extra = _first_bucket(
        {"w": np.arange(64, dtype=np.float32)}, 64, epoch=0)
    asm = BucketAssembler(epoch=0, nbuckets=plan.nbuckets)
    asm.add(0, tensors["raw"], extra["slices"], 0)
    with pytest.raises(RuntimeError, match="duplicate"):
        asm.add(0, tensors["raw"], extra["slices"], 0)


def test_incomplete_epoch_cannot_finish():
    plan, tensors, extra = _first_bucket(
        {"w": np.arange(100, dtype=np.float32)}, 64, epoch=0)
    assert plan.nbuckets > 1
    asm = BucketAssembler(epoch=0, nbuckets=plan.nbuckets)
    assert not asm.add(0, tensors["raw"], extra["slices"], 0)
    with pytest.raises(RuntimeError, match="incomplete"):
        asm.finish()


def test_total_bytes_and_coverage():
    rng = np.random.default_rng(1)
    arrays = {f"t{i}": rng.normal(0, 1, (i + 1, 3)).astype(np.float32)
              for i in range(5)}
    plan = BucketPlan.from_arrays(arrays, 40)
    covered = {}
    for bucket in plan.buckets:
        for key, _, _, lo, hi in bucket:
            covered[key] = covered.get(key, 0) + (hi - lo)
    for k, v in arrays.items():
        assert covered[k] == v.nbytes, k
    assert plan.total_bytes == sum(v.nbytes for v in arrays.values())


# -- heartbeat and failure detector (test_failure.py) ----------------------


def _udp_port():
    return harness.free_port(socket.SOCK_DGRAM)


def test_heartbeat_alive_then_dead():
    with HeartbeatServer(timeout_ms=300) as srv:
        c1 = HeartbeatClient("127.0.0.1", srv.port, node_id=1, interval_ms=40)
        c2 = HeartbeatClient("127.0.0.1", srv.port, node_id=2, interval_ms=40)
        assert _wait_until(lambda: srv.alive() == [1, 2])
        assert srv.dead() == []
        assert srv.seq(1) > 0 and srv.seq(2) > 0
        assert srv.state(1) == "alive" and srv.state(9) == "unseen"
        c1.close()  # node 1 stops beating: death, from the monitor's view
        assert _wait_until(lambda: srv.dead() == [1], timeout=2.0)
        assert srv.alive() == [2] and srv.state(1) == "dead"
        assert srv.age_ms(1) >= 300 and srv.age_ms(9) is None
        c2.close()


def test_heartbeat_seq_monotonic():
    with HeartbeatServer(timeout_ms=500) as srv:
        with HeartbeatClient("127.0.0.1", srv.port, node_id=7,
                             interval_ms=20):
            assert _wait_until(lambda: srv.seq(7) >= 3, timeout=2.0)
            a = srv.seq(7)
            assert _wait_until(lambda: srv.seq(7) > a, timeout=2.0)
    with pytest.raises(RuntimeError, match="closed"):
        srv.seq(7)


def _pair():
    pa, pb = _udp_port(), _udp_port()
    a = FailureDetector(0, peers={1: ("127.0.0.1", pb)}, port=pa,
                        interval_ms=40, timeout_ms=300)
    b = FailureDetector(1, peers={0: ("127.0.0.1", pa)}, port=pb,
                        interval_ms=40, timeout_ms=300)
    a.wait_for_peers(timeout_s=5)
    b.wait_for_peers(timeout_s=5)
    return a, b


def test_failure_detector_pairwise():
    a, b = _pair()
    a.check()
    b.check()
    b.close()  # b dies
    assert _wait_until(lambda: bool(a.server.dead()), timeout=2.0)
    with pytest.raises(WorkerFailureError) as ei:
        a.check()
    assert ei.value.dead == [1] and "[1]" in str(ei.value)
    a.close()


def test_detector_wait_for_peers_timeout():
    d = FailureDetector(0, peers={9: ("127.0.0.1", _udp_port())}, port=0,
                        interval_ms=50, timeout_ms=300)
    with pytest.raises(TimeoutError, match="9"):
        d.wait_for_peers(timeout_s=0.3)
    d.close()


def test_clean_leave_is_not_death():
    a, b = _pair()
    b.close(goodbye=True)  # a clean leave
    assert _wait_until(lambda: a.left() == [1], timeout=2.0)
    time.sleep(0.5)  # past the horizon: silence after a goodbye is clean
    a.check()
    assert a.server.dead() == [] and a.left() == [1]
    a.close()


def test_forged_goodbye_is_ignored():
    """A goodbye counts only from the source address the node beats from."""
    with HeartbeatServer(timeout_ms=400, bind="127.0.0.1") as srv:
        c = HeartbeatClient("127.0.0.1", srv.port, node_id=5, interval_ms=40)
        assert _wait_until(lambda: srv.alive() == [5])
        forged = struct.pack("<IIQ", 0x50534742, 5, 2**64 - 1)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for _ in range(3):
                s.sendto(forged, ("127.0.0.1", srv.port))
        time.sleep(0.2)
        assert srv.left() == [] and srv.alive() == [5]
        c.close()  # a silent stop is still a death
        assert _wait_until(lambda: srv.dead() == [5], timeout=2.0)


@pytest.mark.parametrize("bind", ["0.0.0.0", "127.0.0.1"])
def test_bind_loopback_and_any(bind):
    with HeartbeatServer(timeout_ms=300, bind=bind) as srv:
        with HeartbeatClient("127.0.0.1", srv.port, node_id=3,
                             interval_ms=30):
            assert _wait_until(lambda: srv.alive() == [3])


def test_check_health_is_quiet_without_peers():
    import ps_tpu_torch as ps

    ctx = ps.init(backend="cuda", device="cpu")
    try:
        assert ctx.backend.failure_detector is None
        ctx.backend.check_health()
    finally:
        ps.shutdown()


def test_kill_drill_survivors_name_the_dead_rank(tmp_path):
    """Three gloo ranks with heartbeats on; rank 2 dies hard after a step;
    ranks 0 and 1 get WorkerFailureError([2]) from check_health(), well
    under 120 s, and leave through shutdown(abort=True)."""
    k, victim = 3, 2
    port, hb = harness.free_port(), _udp_port()
    while hb + k > 65535:
        hb = _udp_port()
    t0 = time.monotonic()
    procs = [harness.spawn("drill", r, k, port, hb, victim, tmp_path)
             for r in range(k)]
    outs = harness.finish(procs, wall_s=120)
    assert time.monotonic() - t0 < 120
    assert procs[victim].returncode == 17, outs[victim]
    for r in (0, 1):
        assert procs[r].returncode == 0, outs[r]
        got = json.loads((tmp_path / f"drill{r}.json").read_text())
        assert got["dead"] == [victim], got
        assert "[2]" in got["message"]
