"""Shard replication and live failover in the port (``ps_tpu_torch/
replica/``, ROADMAP item 5.6), against the reference's
``tests/test_replica.py``, with services as objects in one process on the
CPU.

- The ``ReplicationLog``'s sequencing, window, death and stall, the same
  trace as the reference's log; the bounded history logs.
- A backup follows its primary bitwise and refuses worker traffic with the
  typed, retryable reply until promoted; then the worker re-routes
  (epoch 1, one failover). The reference's pair on the same numpy inputs
  ends at the same parameters, bitwise (sgd, dc_lambda 0).
- The attach refuses a state-point mismatch with the reference's message;
  (nonce, seq) dedup applies a replayed push once, at the primary and at
  a promoted backup; async ack's lag stays within the window; a dead
  backup degrades its primary (sync pushes complete) and a new backup
  attaches, from a checkpoint or through RESEED; a zombie primary is
  fenced and the worker's commit survives at the real primary, once;
  the bucketed transport fails over exactly once; the MNIST loss curve
  of a killed run is bitwise the unkilled run's.
- ``PromotionWatch``: a goodbye promotes at once, silence after the
  horizon; the reference's watch reads the port's beats the same way.
- The sparse PS: a backup's tables follow its primary's bitwise and a
  worker rides a promotion; the reference's service over the
  ``_RefTable`` shim (its ``SparseEmbedding.push`` fails on this jax,
  ROADMAP R1) runs the same pushes: sgd bitwise, adagrad within rtol
  1e-6 / atol 1e-7. The sparse checkpoint's drain round is cross-shard
  atomic under a concurrent pusher.
- Interop: a port primary streams to a reference backup and a reference
  primary to a port backup, dense and sparse; the REPLICA_HELLO and
  REPLICA_APPEND frames equal the reference's byte for byte; a backup on
  the native loop refuses a push with the threaded path's bytes.

Every comparison is bitwise unless it says otherwise.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.backends.remote_sparse import (
    SparsePSService,
    connect_sparse,
    row_range,
)
from ps_tpu_torch.backends.van_service import FullLog, RingLog
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.replica import (
    BackupSession,
    PromotionWatch,
    ReplicationError,
    ReplicationLog,
)
from tests import test_torch_van_harness as harness
from tests.test_torch_remote_sparse import _RefTable

RTOL, ATOL = 1e-6, 1e-7  # adagrad, the torch tier against jax's
SHAPE = "small"
SPEC = harness.sparse_spec(SHAPE)
TOTALS = {n: v for n, (v, _) in SPEC.items()}


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


def _params(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {f"p{i}/w": rng.normal(0, 1, (4, 3)).astype(np.float32)
            for i in range(n)}


def _grads(params, value=0.1):
    return {k: np.full(v.shape, value, np.float32) for k, v in params.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _port_init():
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      dc_lambda=0.0, device="cpu")


def _ref_init():
    import ps_tpu

    ps_tpu.init(backend="tpu", mode="async", num_workers=1, dc_lambda=0.0)


def _port_store(params, lr=0.1):
    st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=lr,
                              mode="async")
    st.init(_t(params))
    return st


def _ref_store(params, lr=0.1):
    import jax.numpy as jnp
    import ps_tpu

    st = ps_tpu.KVStore(optimizer="sgd", learning_rate=lr, mode="async")
    st.init({k: jnp.asarray(v) for k, v in params.items()})
    return st


def _port_pair(params, ack="sync", **kw):
    """A port primary, its attached backup, the session."""
    prim = AsyncPSService(_port_store(params), **kw)
    back = AsyncPSService(_port_store(params), backup=True, **kw)
    return prim, back, prim.attach_backup("127.0.0.1", back.port, ack=ack)


def _params_of(svc):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in svc._engine._params.items()}


def _assert_same(a, b, what=""):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _uri(*svcs):
    return "|".join(f"127.0.0.1:{s.port}" for s in svcs)


# -- the replication log ------------------------------------------------------


def _log_trace(cls):
    log = cls(window=8)
    trace = [log.append("push", 0, None, {}), log.append("pull", 1, None, {}),
             log.lag]
    seq, op, w, _, _ = log.take(timeout=0.1)
    trace.append((seq, op, w))
    log.ack(1)
    trace += [log.lag, log.acked_seq, log.take(timeout=0.1)[0]]
    log.ack(2)
    trace.append(log.wait_acked(2, timeout=0.1))
    return trace


def test_replication_log_sequences_and_acks():
    from ps_tpu.replica import ReplicationLog as RefLog

    trace = _log_trace(ReplicationLog)
    assert trace == [1, 2, 2, (1, "push", 0), 1, 1, 2, True]
    assert trace == _log_trace(RefLog)


def test_replication_log_window_blocks_and_death_wakes():
    log = ReplicationLog(window=2)
    log.append("push", 0, None, {})
    log.append("push", 0, None, {})
    blocked = threading.Event()
    seqs = []

    def appender():
        blocked.set()
        seqs.append(log.append("push", 0, None, {}))  # the window is full

    t = threading.Thread(target=appender)
    t.start()
    blocked.wait(1)
    time.sleep(0.05)
    assert not seqs, "an append slipped past a full window"
    log.ack(1)  # the window opens
    t.join(timeout=2)
    assert seqs == [3]
    # death wakes a sync waiter with False
    t2 = threading.Thread(target=log.mark_dead)
    t2.start()
    assert log.wait_acked(3, timeout=2) is False
    t2.join()


def test_replication_log_full_window_stall_dies_not_wedges():
    """A backup that stops acking without dying must not block appends
    (under the apply lock) forever: the bounded wait expires and the log
    dies, as the reference's does, with its reason."""
    from ps_tpu.replica import ReplicationLog as RefLog

    reasons = []
    for cls in (ReplicationLog, RefLog):
        log = cls(window=2, stall_timeout=0.2)
        log.append("push", 0, None, {})
        log.append("push", 0, None, {})
        t0 = time.monotonic()
        assert log.append("push", 0, None, {}) == 3  # nobody acks
        assert 0.15 <= time.monotonic() - t0 < 5.0
        assert log.dead and "stalled" in log.death_reason
        reasons.append(log.death_reason)
    assert reasons[0] == reasons[1]


def test_ring_log_bounded_with_total():
    from ps_tpu.backends.van_service import FullLog as RefFull
    from ps_tpu.backends.van_service import RingLog as RefRing

    for ring, full in ((RingLog, FullLog), (RefRing, RefFull)):
        log = ring(maxlen=8)
        for i in range(100):
            log.append(i)
        assert len(log) == 8 and log.total == 100
        assert list(log) == list(range(92, 100))
        f = full()
        f.append(1)
        assert f.total == 1 and list(f) == [1]


def _ref_api():
    """The reference's service, worker and error classes."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_async import connect_async as ref_connect
    from ps_tpu.replica import ReplicationError as RefError

    return RefService, ref_connect, RefError


def _jnp(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def _sides():
    """(init, store, service, connect, tree conversion, error class) of
    the port and of the reference."""
    RefService, ref_connect, RefError = _ref_api()
    return [(_port_init, _port_store, AsyncPSService, connect_async, _t,
             ReplicationError),
            (_ref_init, _ref_store, RefService, ref_connect, _jnp, RefError)]


def _shutdown_all():
    import ps_tpu

    for pkg in (ps_tpu_torch, ps_tpu):
        if pkg.is_initialized():
            pkg.shutdown()


def test_service_logs_are_rings_and_stats_ships_tail():
    """A history of 8 keeps the last 8 applies and the true total, in the
    STATS reply as in the reference's; full history on request."""
    params = _params()
    stats = []
    for init, store, Service, connect, conv, _ in _sides():
        init()
        svc = Service(store(params), history=8)
        w = connect(f"127.0.0.1:{svc.port}", 0, conv(params))
        try:
            w.pull_all()
            for _ in range(12):
                w.push_all(conv(_grads(params)))
            assert type(svc.apply_log).__name__ == "RingLog"
            assert len(svc.apply_log) == 8 and svc.apply_log.total == 12
            st = w.stats()
            stats.append((st["apply_log_total"], st["apply_log"]))
            svc2 = Service(store(params), record_full_history=True)
            assert type(svc2.apply_log).__name__ == "FullLog"
            svc2.stop()
        finally:
            w.close()
            svc.stop()
            _shutdown_all()
    assert stats[0] == stats[1] == (12, [0] * 8)


# -- replication: follow, gate, dedup ------------------------------------------


def _ref_follow(params, cycles):
    """The reference's pair and worker: the same pushes, its final
    primary and backup params."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    import ps_tpu

    _ref_init()
    prim = RefService(_ref_store(params))
    back = RefService(_ref_store(params), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = ref_connect(_uri(prim, back), 0, _jnp(params), failover_timeout=10.0)
    w.pull_all()
    for _ in range(cycles):
        w.push_pull(_jnp(_grads(params)))
    out = (_params_of(prim), _params_of(back))
    w.close()
    prim.stop()
    back.stop()
    ps_tpu.shutdown()
    return out


def test_backup_follows_primary_bitwise_and_serves_after_promotion():
    params = _params()
    ref_prim, ref_back = _ref_follow(params, 3)
    _port_init()
    prim, back, sess = _port_pair(params, ack="sync")
    w = connect_async(_uri(prim, back), 0, _t(params), failover_timeout=10.0)
    try:
        w.pull_all()
        for _ in range(3):
            w.push_pull(_t(_grads(params)))
        # sync ack: every acknowledged commit is on the backup already
        assert sess.lag == 0
        assert prim._engine.version == back._engine.version == 3
        _assert_same(_params_of(prim), _params_of(back), "backup")
        _assert_same(_params_of(prim), ref_prim, "reference primary")
        _assert_same(_params_of(back), ref_back, "reference backup")
        assert back.replica_state()["replica_applied_seq"] == 7  # 4 pulls
        # a backup refuses worker traffic with the typed, retryable reply
        with tv.Channel.connect("127.0.0.1", back.port) as ch:
            kind, _, _, extra = tv.decode(
                ch.request(tv.encode(tv.HELLO, 9, None)))
        assert kind == tv.ERR and extra["backup"] is True
        # kill, promote: the worker re-routes and goes on
        prim.kill()
        back.promote(reason="test")
        assert back.epoch == 1 and back.promote_reason == "test"
        w.push_pull(_t(_grads(params)))
        assert back._engine.version == 4
        assert w._epochs[0] == 1 and w.transport.failovers == 1
        st = w.stats()
        assert st["role"] == "primary" and st["epoch"] == 1
    finally:
        w.close()
        back.stop()


def test_attach_refuses_state_point_mismatch():
    """A primary past its backup's state point is refused, with the
    reference's message."""
    params = _params()
    errors = []
    for init, store, Service, connect, conv, err_cls in _sides():
        init()
        prim = Service(store(params))
        back = Service(store(params), backup=True)
        w = connect(f"127.0.0.1:{prim.port}", 0, conv(params))
        try:
            w.pull_all()
            w.push_all(conv(_grads(params)))
            # the primary moved past the backup's state: no catching up
            with pytest.raises(err_cls, match="state-point mismatch") as e:
                prim.attach_backup("127.0.0.1", back.port)
            errors.append(str(e.value).split(": ", 1)[1])
        finally:
            w.close()
            prim.stop()
            back.stop()
            _shutdown_all()
    assert errors[0] == errors[1]


def _replays(port):
    """The reference test's dedup script: the replies' (kind, dedup) and
    the versions after each frame."""
    sub = _grads(_params())
    frames = [tv.encode(tv.PUSH, 0, sub, extra={"pseq": s, "pnonce": n})
              for s, n in ((7, "abc"), (7, "abc"), (8, "abc"), (1, "xyz"))]
    out = []
    with tv.Channel.connect("127.0.0.1", port) as ch:
        for f in frames:
            kind, _, _, extra = tv.decode(ch.request(bytes(f)))
            out.append((kind, extra["dedup"], extra["version"]))
    return out


def test_dedup_replay_applies_exactly_once():
    """The same (nonce, seq) push twice: applied once, acked twice; a newer
    seq applies, a new nonce restarts the stream; the replies equal the
    reference service's."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    import ps_tpu

    params = _params()
    _ref_init()
    ref = RefService(_ref_store(params))
    want = _replays(ref.port)
    ref.stop()
    ps_tpu.shutdown()
    _port_init()
    svc = AsyncPSService(_port_store(params))
    try:
        got = _replays(svc.port)
        assert got == want == [(tv.OK, False, 1), (tv.OK, True, 1),
                               (tv.OK, False, 2), (tv.OK, False, 3)]
        assert svc.transport.dedup_hits == 1
    finally:
        svc.stop()


def test_dedup_survives_promotion():
    """A push applied at the primary and replicated, whose reply died with
    it, replayed at the promoted backup: suppressed there."""
    params = _params()
    _port_init()
    prim, back, _ = _port_pair(params, ack="sync")
    try:
        payload = tv.encode(tv.PUSH, 0, _grads(params),
                            extra={"pseq": 3, "pnonce": "inc1"})
        with tv.Channel.connect("127.0.0.1", prim.port) as ch:
            assert tv.decode(ch.request(bytes(payload)))[0] == tv.OK
        assert back._engine.version == 1  # replicated (sync ack)
        prim.kill()
        back.promote(reason="test")
        with tv.Channel.connect("127.0.0.1", back.port) as ch:
            kind, _, _, extra = tv.decode(ch.request(bytes(payload)))
        assert kind == tv.OK and extra["dedup"] is True
        assert back._engine.version == 1  # exactly once
        assert back.transport.dedup_hits == 1
    finally:
        back.stop()


def test_async_ack_lag_bounded_by_window(monkeypatch):
    params = _params(n=2)
    _port_init()
    prim = AsyncPSService(_port_store(params))
    back = AsyncPSService(_port_store(params), backup=True)
    orig = back._replica_apply

    def slow_apply(op, worker, tensors, extra):  # a slow backup
        time.sleep(0.02)
        orig(op, worker, tensors, extra)

    monkeypatch.setattr(back, "_replica_apply", slow_apply)
    window = 4
    sess = prim.attach_backup("127.0.0.1", back.port, ack="async",
                              window=window)
    w = connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))
    try:
        w.pull_all()
        worst = 0
        for _ in range(16):
            w.push_all(_t(_grads(params)))
            worst = max(worst, sess.lag)
        assert 0 < worst <= window, worst
        deadline = time.monotonic() + 10
        while sess.lag > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sess.lag == 0
        assert back._engine.version == prim._engine.version == 16
        _assert_same(_params_of(prim), _params_of(back), "drained backup")
        assert prim.transport.repl_entries == 17  # one pull, 16 pushes
    finally:
        w.close()
        prim.stop()
        back.stop()


def test_dead_backup_degrades_primary_not_wedges(tmp_path):
    params = _params(n=2)
    _port_init()
    prim, back, sess = _port_pair(params, ack="sync")
    w = connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))
    try:
        w.pull_all()
        w.push_all(_t(_grads(params)))
        back.kill()  # the backup dies mid-job
        for _ in range(3):  # sync pushes complete, degraded, not hung
            w.push_all(_t(_grads(params)))
        assert prim._engine.version == 4
        assert sess.degraded
        assert w.stats()["repl"]["degraded"] is True
        # a new backup from a checkpoint of the live state replaces the
        # dead session
        ck = str(tmp_path / "reseed")
        prim._store.save(ck)
        st2 = _port_store(params)
        st2.restore(ck)
        back2 = AsyncPSService(st2, backup=True)
        sess2 = prim.attach_backup("127.0.0.1", back2.port)
        w.push_all(_t(_grads(params)))
        assert sess2.lag == 0
        assert back2._engine.version == prim._engine.version == 5
        _assert_same(_params_of(prim), _params_of(back2), "re-attached")
        back2.stop()
    finally:
        w.close()
        prim.stop()
        back.stop()


def test_reseed_restores_redundancy_bitwise():
    """RESEED: the primary ships its whole state point (rows, optimizer
    state, stale snapshots, counters, the dedup ledger) to an empty spare
    in one REPLICA_SEED frame and attaches it; the spare then follows
    bitwise, and promoted it suppresses a replay of the last push."""
    params = _params(n=3)
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      dc_lambda=0.04, device="cpu")
    prim = AsyncPSService(_port_store(params))
    spare = AsyncPSService(_port_store(_params(n=3, seed=5)), backup=True)
    w = connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))
    try:
        w.pull_all()
        for c in range(3):
            w.push_pull(_t(_grads(params, 0.1 * (c + 1))))
        with tv.Channel.connect("127.0.0.1", prim.port) as ch:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.RESEED, 0, None,
                extra={"spare": f"127.0.0.1:{spare.port}"})))
        assert kind == tv.OK and extra["keys"] == 3, extra
        assert spare._engine.version == prim._engine.version == 3
        _assert_same(_params_of(prim), _params_of(spare), "seeded")
        for c in range(2):
            w.push_pull(_t(_grads(params, 0.05)))
        _assert_same(_params_of(prim), _params_of(spare), "followed")
        assert spare._engine.staleness_hist == prim._engine.staleness_hist
        # a second spare is refused while the session lives
        with tv.Channel.connect("127.0.0.1", prim.port) as ch:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.RESEED, 0, None,
                extra={"spare": f"127.0.0.1:{spare.port}"})))
        assert kind == tv.ERR and "already attached" in extra["error"]
        last = w._push_seq
        prim.kill()
        spare.promote(reason="test")
        payload = tv.encode(tv.PUSH, 0, _grads(params),
                            extra={"pseq": last,
                                   "pnonce": w._transport_nonce})
        with tv.Channel.connect("127.0.0.1", spare.port) as ch:
            kind, _, _, extra = tv.decode(ch.request(bytes(payload)))
        assert kind == tv.OK and extra["dedup"] is True
    finally:
        for ch in w._chs:
            ch.close()
        spare.stop()


def test_zombie_primary_fenced_and_commit_survives():
    """The backup promotes while the old primary still serves: the zombie's
    next commit is refused by its own backup, it fences itself, the reply
    becomes a retryable refusal and the worker replays at the real
    primary, where the commit lands once."""
    params = _params()
    _port_init()
    prim, back, sess = _port_pair(params, ack="sync")
    w = connect_async(_uri(prim, back), 0, _t(params), failover_timeout=10.0)
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
        w.push_pull(_t(_grads(params)))
        back.promote(reason="partition-drill")
        w.push_pull(_t(_grads(params)))
        assert prim.role == "fenced"
        assert sess.fenced and sess.degraded
        assert w._epochs[0] == 1 and w.transport.failovers >= 1
        assert back._engine.version == 3
        w.push_pull(_t(_grads(params)))
        assert back._engine.version == 4
        # the zombie refuses workers from now on, with the backup's reply
        with tv.Channel.connect("127.0.0.1", prim.port) as ch:
            kind, _, _, extra = tv.decode(
                ch.request(tv.encode(tv.HELLO, 9, None)))
        assert kind == tv.ERR and extra["backup"] is True
        assert "role=fenced" in extra["error"]
    finally:
        w.close()
        prim.stop()
        back.stop()


def test_bucketed_transport_failover_exactly_once():
    params = _params(n=6, seed=3)
    _port_init()
    prim, back, _ = _port_pair(params, ack="sync")
    w = connect_async(_uri(prim, back), 0, _t(params), bucket_bytes=1 << 10,
                      pool_size=2, failover_timeout=10.0)
    try:
        w.pull_all()
        for _ in range(3):
            w.push_pull(_t(_grads(params, 0.01)))
        prim.kill()
        back.promote(reason="test")
        for _ in range(3):
            w.push_pull(_t(_grads(params, 0.01)))
        # 3 pushes before the kill, 3 after, each applied once
        assert back._engine.version == 6
        assert w.transport.failovers >= 1
    finally:
        w.close()
        back.stop()


def test_mnist_failover_loss_curve_bitwise_vs_unkilled():
    """The primary killed mid-training: with sync ack the loss curve after
    the failover is bitwise the unkilled run's (the trainer's MLP at
    hidden 32, sgd 0.1, dc_lambda 0). The reference's test holds its own
    model the same way; the two models' draws differ, so the curves are
    each held to their own unkilled run."""
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv.store import value_and_grad

    steps, bs, kill_at = 10, 32, 5
    _port_init()
    params0, loss_fn = build(0, "cpu")
    flat = {k: v.detach().numpy()
            for k, v in ps_tpu_torch.kv.keys.flatten_with_keys(
                params0)[0].items()}

    def run(kill):
        prim = AsyncPSService(_port_store(flat))
        back = AsyncPSService(_port_store(flat), backup=True)
        prim.attach_backup("127.0.0.1", back.port, ack="sync")
        w = connect_async(_uri(prim, back), 0, params0,
                          failover_timeout=10.0)
        losses = []
        try:
            p = w.pull_all()
            for step, (images, labels) in enumerate(
                    mnist_batches(bs, steps=steps)):
                if kill and step == kill_at:
                    prim.kill()
                    back.promote(reason="drill")
                loss, grads, _ = value_and_grad(
                    loss_fn, p, (torch.from_numpy(images),
                                 torch.from_numpy(labels)))
                losses.append(float(loss))
                p = w.push_pull(grads)
            assert w.transport.failovers == int(kill)
        finally:
            w.close()
            if not kill:
                prim.kill()
            back.stop()
        return losses, {k: v.detach().numpy().copy() for k, v in
                        ps_tpu_torch.kv.keys.flatten_with_keys(p)[0].items()}

    with harness.one_thread():
        ref, ref_p = run(kill=False)
        drill, drill_p = run(kill=True)
    np.testing.assert_array_equal(np.array(drill), np.array(ref))
    _assert_same(drill_p, ref_p, "final params")
    assert drill[-1] < drill[0], "the model did not learn"


# -- PromotionWatch: goodbye against timeout -----------------------------------


class _FakeService:
    def __init__(self):
        self.reason = None
        self.promoted = threading.Event()

    def promote(self, reason):
        self.reason = reason
        self.promoted.set()
        return 1


def _watch_case(watch_cls, goodbye, timeout_ms):
    from ps_tpu_torch.control.heartbeat import HeartbeatClient

    svc = _FakeService()
    watch = watch_cls(svc, primary_id=1, timeout_ms=timeout_ms)
    hb = HeartbeatClient("127.0.0.1", watch.port, node_id=1, interval_ms=50)
    watch.wait_for_primary()
    t0 = time.monotonic()
    hb.close(goodbye=goodbye)
    assert svc.promoted.wait(5), "never promoted"
    dt = time.monotonic() - t0
    watch.close()
    return svc.reason, dt


def test_promotion_watch_goodbye_vs_timeout():
    """A goodbye promotes at once ('goodbye'), silence only after the
    horizon ('timeout'); the reference's watch reads the port's beats the
    same way (one van.cpp, the same datagrams)."""
    from ps_tpu.replica import PromotionWatch as RefWatch

    for cls in (PromotionWatch, RefWatch):
        reason, dt = _watch_case(cls, goodbye=True, timeout_ms=2000)
        assert reason == "goodbye" and dt < 1.5, (cls, dt)
        reason, dt = _watch_case(cls, goodbye=False, timeout_ms=400)
        assert reason == "timeout" and dt >= 0.3, (cls, dt)


def test_promotion_watch_promotes_a_service_and_reports_timing():
    """The watch over a real backup service: the promotion's cause, the
    primary's last beat's age at detection and the promotion's time."""
    from ps_tpu_torch.control.heartbeat import HeartbeatClient

    params = _params(n=2)
    _port_init()
    back = AsyncPSService(_port_store(params), backup=True)
    watch = PromotionWatch(back, primary_id=1, timeout_ms=300)
    hb = HeartbeatClient("127.0.0.1", watch.port, node_id=1, interval_ms=20)
    try:
        watch.wait_for_primary()
        hb.close(goodbye=False)
        deadline = time.monotonic() + 5
        while back.role == "backup" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (back.role, back.promote_reason, back.epoch) == (
            "primary", "timeout", 1)
        assert watch.promoted_reason == "timeout"
        assert watch.detect_age_ms >= 300 and watch.promote_s >= 0
        assert back.replica_state()["promote_reason"] == "timeout"
    finally:
        watch.close()
        back.stop()


# -- the sparse PS ---------------------------------------------------------------


def _sparse_push(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (total, dim) in SPEC.items():
        ids = rng.integers(0, total, 16).astype(np.int32)
        out[name] = (ids, rng.normal(0, 0.1, (16, dim)).astype(np.float32))
    return out


def _ref_sparse_tables():
    out = {}
    for name in SPEC:
        out[name] = _RefTable(harness.sparse_table(SHAPE, name),
                              harness.SPARSE_TABLES[name][0])
    return out


def _tables_of(svc):
    return {n: np.asarray(t.table.numpy() if isinstance(t.table, torch.Tensor)
                          else t.table) for n, t in svc._tables.items()}


def _hold_to_reference(got, want, what):
    """sgd ('wide') bitwise, adagrad ('deep') within RTOL/ATOL."""
    for n in SPEC:
        if harness.SPARSE_TABLES[n][0] == "sgd":
            np.testing.assert_array_equal(got[n], want[n],
                                          err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} {n}")


def test_sparse_replication_failover_bitwise():
    """Port pair: the backup's tables equal the primary's bitwise, the
    worker rides a kill and a promotion, its push lands once. The
    reference's pair over the _RefTable shim runs the same pushes."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_connect

    import ps_tpu

    ps_tpu.init(backend="tpu")
    rprim = RefService(_ref_sparse_tables())
    rback = RefService(_ref_sparse_tables(), backup=True)
    rprim.attach_backup("127.0.0.1", rback.port, ack="sync")
    rw = ref_connect(_uri(rprim, rback), 0, SPEC, failover_timeout=10.0)
    for c in range(3):
        rw.push(_sparse_push(c))
    ref_tables = _tables_of(rback)
    rw.close()
    rprim.stop()
    rback.stop()
    ps_tpu.shutdown()

    ps_tpu_torch.init(backend="cuda", device="cpu")
    prim = SparsePSService(harness.sparse_tables(SHAPE, 0, 1))
    back = SparsePSService(harness.sparse_tables(SHAPE, 0, 1), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = connect_sparse(_uri(prim, back), 0, SPEC, failover_timeout=10.0)
    try:
        for c in range(3):
            w.push(_sparse_push(c))
        assert back.versions == prim.versions == {"deep": 3, "wide": 3}
        _assert_same(_tables_of(prim), _tables_of(back), "backup")
        for name in SPEC:  # the row state too
            for x, y in zip(prim._tables[name].state().values()
                            if isinstance(prim._tables[name].state(), dict)
                            else [prim._tables[name].state()],
                            back._tables[name].state().values()
                            if isinstance(back._tables[name].state(), dict)
                            else [back._tables[name].state()]):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), name
        _hold_to_reference(_tables_of(back), ref_tables, "reference pair")
        prim.kill()
        back.promote(reason="test")
        w.push(_sparse_push(99))
        rows = w.pull({n: np.arange(4, dtype=np.int32) for n in SPEC})
        assert all(bool(torch.isfinite(r).all()) for r in rows.values())
        assert back.versions["deep"] == 4
        assert w.transport.failovers >= 1
    finally:
        w.close()
        back.stop()


def test_sparse_checkpoint_cross_shard_atomic_under_pushes(tmp_path):
    """Every cycle here routes rows to both shards, so a cross-shard-atomic
    snapshot holds equal push counts on the two; a torn one (n, n+1).
    Checkpoints under a concurrent pusher are all untorn."""
    from ps_tpu_torch.kv.sparse import SparseEmbedding

    ps_tpu_torch.init(backend="cuda", device="cpu")
    nshards = 2
    svcs = [SparsePSService(harness.sparse_tables(SHAPE, s, nshards),
                            shard=s, num_shards=nshards, total_rows=TOTALS)
            for s in range(nshards)]
    uri = ",".join(f"127.0.0.1:{s.port}" for s in svcs)
    pusher = connect_sparse(uri, 0, SPEC)
    ckpter = connect_sparse(uri, 1, SPEC)
    stop = threading.Event()

    def push_loop():
        c = 0
        while not stop.is_set():
            out = {}
            for name, (total, dim) in SPEC.items():
                rng = np.random.default_rng([c, dim])
                out[name] = (np.arange(total, dtype=np.int32),
                             rng.normal(0, 0.01, (total, dim)).astype(
                                 np.float32))
            pusher.push(out)
            c += 1

    t = threading.Thread(target=push_loop)
    t.start()
    try:
        for i in range(4):
            ck = str(tmp_path / f"ck{i}")
            ckpter.checkpoint_all(ck)
            for name, (total, dim) in SPEC.items():
                counts = []
                for s in range(nshards):
                    lo, hi = row_range(s, nshards, total)
                    emb = SparseEmbedding(hi - lo, dim,
                                          optimizer=harness.SPARSE_TABLES[
                                              name][0],
                                          learning_rate=harness.SPARSE_LR)
                    emb.init(np.zeros((hi - lo, dim), np.float32))
                    emb.restore(f"{ck}/shard{s}/{name}")
                    counts.append(emb.push_count)
                assert counts[0] == counts[1], (i, name, counts)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    pusher.close()
    ckpter.close()
    for s in svcs:
        s.stop()


# -- interop with the reference ------------------------------------------------


def test_port_primary_streams_to_reference_backup():
    """Dense: a port primary's stream applied by the reference's backup
    (its engine): the same parameters; promoted, it serves a port worker
    that re-routes to it."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    params = _params()
    _ref_init()
    back = RefService(_ref_store(params), backup=True)
    _port_init()
    prim = AsyncPSService(_port_store(params))
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = connect_async(_uri(prim, back), 0, _t(params), failover_timeout=10.0)
    try:
        w.pull_all()
        for c in range(3):
            w.push_pull(_t(_grads(params, 0.1 * (c + 1))))
        assert back._engine.version == 3
        _assert_same(_params_of(prim), _params_of(back), "reference backup")
        prim.kill()
        back.promote(reason="test")
        w.push_pull(_t(_grads(params)))
        assert back._engine.version == 4 and w._epochs[0] == 1
    finally:
        w.close()
        back.stop()


def test_reference_primary_streams_to_port_backup():
    """Dense: the reference primary's stream applied by the port's backup:
    the same parameters; promoted, it serves the reference's worker."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    params = _params()
    _port_init()
    back = AsyncPSService(_port_store(params), backup=True)
    _ref_init()
    prim = RefService(_ref_store(params))
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = ref_connect(_uri(prim, back), 0, _jnp(params), failover_timeout=10.0)
    try:
        w.pull_all()
        for c in range(3):
            w.push_pull(_jnp(_grads(params, 0.1 * (c + 1))))
        assert back._engine.version == 3
        _assert_same(_params_of(prim), _params_of(back), "port backup")
        prim.kill()
        back.promote(reason="test")
        w.push_pull(_jnp(_grads(params)))
        assert back._engine.version == 4 and w._epochs[0] == 1
    finally:
        w.close()
        back.stop()


@pytest.mark.parametrize("port_primary", [True, False],
                         ids=["port-to-reference", "reference-to-port"])
def test_sparse_streams_between_port_and_reference(port_primary):
    """Sparse: each side's backup applies the other's stream (the
    reference's over the _RefTable shim): sgd bitwise, adagrad within
    RTOL/ATOL of the primary's tables."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService

    import ps_tpu

    ps_tpu.init(backend="tpu")
    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = SparsePSService(harness.sparse_tables(SHAPE, 0, 1),
                           backup=not port_primary)
    ref = RefService(_ref_sparse_tables(), backup=port_primary)
    prim, back = (port, ref) if port_primary else (ref, port)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = connect_sparse(f"127.0.0.1:{prim.port}", 0, SPEC)
    try:
        for c in range(4):
            w.push(_sparse_push(c))
        assert {n: int(v) for n, v in back.versions.items()} == \
            {"deep": 4, "wide": 4}
        _hold_to_reference(_tables_of(back), _tables_of(prim), "backup")
    finally:
        w.close()
        prim.stop()
        back.stop()


def _fake_session(compressor=None):
    return types.SimpleNamespace(_compressor=compressor)


@pytest.mark.parametrize("codec", [None, "cast16"])
def test_replica_frames_equal_the_references(codec):
    """REPLICA_HELLO (dense and sparse, from equal services) and
    REPLICA_APPEND (a push, a pull and a sparse push entry) encode to the
    reference's bytes, raw and through a stateless codec."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_sparse import SparsePSService as RefSparse
    from ps_tpu.compress import CompressPolicy as RefPolicy
    from ps_tpu.compress import GradCompressor as RefCompressor
    from ps_tpu.control import tensor_van as ref_tv
    from ps_tpu.replica.session import BackupSession as RefSession

    from ps_tpu_torch.compress import CompressPolicy, GradCompressor

    params = _params()
    _ref_init()
    _port_init()
    pairs = [(AsyncPSService(_port_store(params)),
              RefService(_ref_store(params)))]
    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    pairs.append((SparsePSService(harness.sparse_tables(SHAPE, 0, 1)),
                  RefSparse(_ref_sparse_tables())))
    try:
        for port, ref in pairs:
            a = port._replica_hello_extra()
            b = ref._replica_hello_extra()
            for h in (a, b):
                h.update({"epoch": 0, "ack": "sync"})
            assert bytes(tv.encode(tv.REPLICA_HELLO, 0, None, extra=a)) == \
                bytes(ref_tv.encode(ref_tv.REPLICA_HELLO, 0, None, extra=b))
    finally:
        for pair in pairs:
            for s in pair:
                s.stop()
    spec = {"codec": codec, "min_bytes": 0} if codec else None
    port_s = _fake_session(GradCompressor(CompressPolicy.from_spec(spec))
                           if spec else None)
    ref_s = _fake_session(RefCompressor(RefPolicy.from_spec(spec))
                          if spec else None)
    sparse = _sparse_push(5)
    entries = [
        (1, "pull", 0, None, {}),
        (2, "push", 0, _grads(params, 0.3),
         {"pseq": 4, "pnonce": "n1", "members": None, "birth": 12.5}),
        (3, "push", 2, {f"{n}/{f}": x for n, (i, g) in sparse.items()
                        for f, x in (("ids", i), ("grads", g))},
         {"pseq": 1, "pnonce": "n2", "pfan": [0], "tier_moves": None,
          "birth": 13.25}),
    ]
    for entry in entries:
        hp, cp = BackupSession._encode_entry(port_s, *entry)
        hr, cr = RefSession._encode_entry(ref_s, *entry)
        assert bytes(hp) == bytes(hr), entry[:3]
        assert [bytes(c) for c in cp] == [bytes(c) for c in cr], entry[:3]


def test_native_loop_backup_refuses_push_with_threaded_bytes():
    """A backup on the native loop answers a push frame natively (native
    admission's role refusal) with the threaded backup's bytes, which are
    the reference's; promoted, the loop serves the push."""
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    params = _params()
    # worker 5's push: the loop patches the requester's id into its
    # template (worker 0's), so the bytes are the pump's
    frame = bytes(tv.encode(tv.PUSH, 5, _grads(params),
                            extra={"pseq": 1, "pnonce": "n"}))
    mine = bytes(tv.encode(tv.PUSH, 0, _grads(params),
                           extra={"pseq": 1, "pnonce": "n"}))
    replies = {}
    _ref_init()
    ref = RefService(_ref_store(params), backup=True)
    with tv.Channel.connect("127.0.0.1", ref.port) as ch:
        replies["reference"] = bytes(ch.request(frame))
    ref.stop()
    _port_init()
    for loop in (False, True):
        svc = AsyncPSService(_port_store(params), backup=True,
                             native_loop=loop)
        try:
            assert svc.native_loop == loop
            with tv.Channel.connect("127.0.0.1", svc.port) as ch:
                replies[loop] = bytes(ch.request(frame))
                if loop:
                    # the loop counts a native refusal after it wrote the
                    # reply: wait for the count, not just the bytes
                    deadline = time.monotonic() + 10
                    while (svc.admit_stats()["refusals"] < 1
                           and time.monotonic() < deadline):
                        time.sleep(0.001)
                    assert svc.admit_stats()["refusals"] == 1
                    svc.promote(reason="test")
                    kind, _, _, extra = tv.decode(ch.request(mine))
                    assert kind == tv.OK and extra["version"] == 1
                    assert svc.admit_stats()["refusal_armed"] is False
        finally:
            svc.stop()
    assert replies[True] == replies[False] == replies["reference"]
    kind, worker, _, extra = tv.decode(replies[True])
    assert (kind, worker, extra["backup"]) == (tv.ERR, 5, True)


def test_sync_ack_on_the_loop_is_punted_off_the_pump():
    """A primary on the native loop with a sync-ack backup: each commit
    waits for the backup's ack on a thread of its own (the pump never
    waits on the backup), and the backup follows bitwise."""
    params = _params(n=3)
    _port_init()
    prim, back, sess = _port_pair(params, ack="sync", native_loop=True)
    assert prim.native_loop and back.native_loop
    ws = [connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))]
    try:
        ws[0].pull_all()
        for _ in range(5):
            ws[0].push_pull(_t(_grads(params)))
        assert sess.lag == 0 and back._engine.version == 5
        _assert_same(_params_of(prim), _params_of(back), "loop backup")
        assert prim.transport.repl_entries == 11  # 6 pulls, 5 pushes
    finally:
        for w in ws:
            w.close()
        prim.stop()
        back.stop()


def test_degraded_primary_on_the_loop_stops_punting(monkeypatch):
    """The loop punts a commit or a pull to a thread only while a live
    session may make it wait: once the backup died and the session
    degraded, nothing waits, and the pump serves them inline again."""
    params = _params(n=2)
    _port_init()
    prim, back, sess = _port_pair(params, ack="sync", native_loop=True)
    punts = []
    pool = prim._punt_pool

    def counted():
        punts.append(1)
        return pool()

    monkeypatch.setattr(prim, "_punt_pool", counted)
    w = connect_async(f"127.0.0.1:{prim.port}", 0, _t(params))
    try:
        w.pull_all()
        w.push_pull(_t(_grads(params)))
        assert len(punts) == 2  # live: the pull and the push_pull
        back.kill()
        w.push_all(_t(_grads(params)))  # the send that finds it dead
        assert sess.degraded
        before = len(punts)
        for _ in range(3):
            w.push_pull(_t(_grads(params)))
        w.pull_all()
        assert len(punts) == before  # degraded: inline on the pump
        assert prim._engine.version == 5
    finally:
        w.close()
        prim.stop()
        back.stop()


@pytest.mark.parametrize("lane", ["loop", "shm"])
def test_replicated_entries_outlive_loop_bodies_and_ring_frames(
        lane, monkeypatch):
    """With async ack and a slow backup the sender encodes an entry well
    after the push's reply went out, when its native-loop body is freed
    or its ring frame consumed and overwritten (64 KiB rings, every push
    a new draw of all 96 rows, so a ring wraps every ~16 pushes): the
    entry holds copies of the applied bytes, so the backup still ends
    bitwise the primary (sparse, two workers pushing at once)."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    prim = SparsePSService(harness.sparse_tables(SHAPE, 0, 1),
                           native_loop=lane == "loop")
    back = SparsePSService(harness.sparse_tables(SHAPE, 0, 1), backup=True)
    orig = back._replica_apply

    def slow_apply(op, worker, tensors, extra):
        time.sleep(0.005)
        orig(op, worker, tensors, extra)

    monkeypatch.setattr(back, "_replica_apply", slow_apply)
    sess = prim.attach_backup("127.0.0.1", back.port, ack="async",
                              window=64)
    ws = [connect_sparse(f"127.0.0.1:{prim.port}", w, SPEC,
                         shm=lane == "shm", shm_bytes=1 << 16)
          for w in range(2)]
    pushes = 40
    try:
        if lane == "shm":
            assert all(w._chs[0].lane == "shm" for w in ws)

        def drive(w):
            for c in range(pushes):
                rng = np.random.default_rng([w.worker, c])
                w.push({n: (rng.permutation(total).astype(np.int32),
                            rng.normal(0, 0.1, (total, dim)).astype(
                                np.float32))
                        for n, (total, dim) in SPEC.items()})

        threads = [threading.Thread(target=drive, args=(w,)) for w in ws]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        deadline = time.monotonic() + 30
        while sess.lag > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sess.lag == 0 and not sess.degraded
        n = 2 * pushes
        assert back.versions == prim.versions == {"deep": n, "wide": n}
        _assert_same(_tables_of(prim), _tables_of(back), "backup")
        if lane == "loop":
            assert prim.transport.loop_pushes == n
        else:
            assert prim.transport.shm_frames > 0
            assert prim.transport.shm_spill_frames == 0
    finally:
        for w in ws:
            w.close()
        prim.stop()
        back.stop()
