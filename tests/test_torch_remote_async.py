"""Cross-process async DC-ASGD in the port (config 5 across processes),
against the reference.

- Processes (``tests/test_torch_van_harness.py``, port only, each killed
  after a wall-clock limit): a server and 3 workers, 8 cycles each, with
  real staleness. Replaying the server's event log through the port's
  ``AsyncCudaServer`` on the CPU gives its final parameters bitwise;
  through the reference's threaded ``AsyncTpuServer``, within rtol 1e-6 /
  atol 1e-7. Killing a server process raises ``ServerFailureError``
  naming it at the worker.
- In process: the two-server partition is disjoint and complete, its
  replay is bitwise per shard, and a misconfigured topology or a
  misplaced key fails loudly; the coordinated ``checkpoint_all`` round
  trip and its cross-shard atomicity under concurrent pushes; ``stop()``
  drains an in-flight reply, ``wait_for_goodbyes`` times out False, an
  idle client survives a slow cadence; bucketed equals serial bitwise, a
  torn bucketed push is never observable, an abandoned epoch is
  superseded, not merged, and the overlapped MNIST step gives the serial
  losses.
- Interop, in one process: a port worker against the reference's
  ``serve_async`` and a reference worker against the port's, each within
  rtol 1e-6 / atol 1e-7 of the reference alone; a reference worker's shm
  offer is refused and it trains over TCP.
- Every deferred option raises, naming its ROADMAP item.
"""

import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.common import (AGG_WORKER_BASE, BucketPlan,
                                          ServerFailureError)
from ps_tpu_torch.backends.remote_async import (
    AsyncPSService,
    RemoteAsyncWorker,
    connect_async,
    shard_tree,
)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv import keys as keymod
from tests import test_torch_van_harness as harness

NWORKERS, CYCLES = 3, 8
RTOL, ATOL = 1e-6, 1e-7  # the bound tests/test_torch_async.py holds


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _flat(tree):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)
            for k, v in keymod.flatten_with_keys(tree)[0].items()}


def _job(params, num_workers=1, lr=0.05, dc_lambda=0.04, shards=None,
         **svc_kw):
    """A port job on the CPU: one service, or one per shard."""
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=num_workers,
                      dc_lambda=dc_lambda, device="cpu")
    svcs = []
    for s in range(shards or 1):
        store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=lr,
                                     mode="async")
        if shards:
            store.init(shard_tree(params, s, shards))
            svcs.append(AsyncPSService(store, shard=s, num_shards=shards,
                                       **svc_kw))
        else:
            store.init(params)
            svcs.append(AsyncPSService(store, **svc_kw))
    uri = ",".join(f"127.0.0.1:{s.port}" for s in svcs)
    return svcs, uri


def _stop(svcs):
    for s in svcs:
        s.stop()
    ps_tpu_torch.shutdown()


# -- processes ------------------------------------------------------------


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_remote_async")
    server = harness.spawn("server", out, NWORKERS, CYCLES)
    port = harness.server_port(server, out)
    workers = [harness.spawn("worker", port, out, w, CYCLES, NWORKERS)
               for w in range(NWORKERS)]
    procs = [server] + workers
    outs = harness.finish(procs, wall_s=180)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{o}"
    info = json.loads((out / "server.json").read_text())
    final = dict(np.load(out / "server_params.npz"))
    return out, info, final


def test_three_processes_drive_one_server(mp_run):
    out, info, _ = mp_run
    assert len(info["apply_log"]) == NWORKERS * CYCLES
    assert sorted(set(info["apply_log"])) == list(range(NWORKERS))
    assert info["version"] == NWORKERS * CYCLES
    for w in range(NWORKERS):
        r = json.loads((out / f"worker{w}.json").read_text())
        assert len(r["versions"]) == CYCLES
        assert r["versions"][-1] <= NWORKERS * CYCLES


def test_cross_process_staleness_is_real(mp_run):
    _, info, _ = mp_run
    hist = {int(t): n for t, n in info["staleness_hist"].items()}
    assert sum(hist.values()) == NWORKERS * CYCLES
    assert sum(n for t, n in hist.items() if t > 0) > 0, hist


def _replay(engine, params, event_log, owned=None):
    pushes = {}
    for op, w in event_log:
        if op == "pull":
            engine.pull_tree(worker=w)
        else:
            c = pushes.get(w, 0)
            grads = harness.make_grads(params, w, c)
            engine.push_tree({k: v for k, v in grads.items()
                              if owned is None or k in owned}, worker=w)
            pushes[w] = c + 1
    return engine.pull_tree(worker=0)


def test_replay_through_the_port_engine_is_bitwise(mp_run):
    _, info, final = mp_run
    params = harness.model_params()
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=NWORKERS,
                      dc_lambda=harness.DC_LAMBDA, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd",
                                 learning_rate=harness.LR, mode="async")
    store.init(_t(params))
    with harness.one_thread():  # as the server applied
        got = _replay(store._engine, params, info["event_log"])
    assert sorted(got) == sorted(final)
    for k in final:
        np.testing.assert_array_equal(final[k], got[k].numpy(), err_msg=k)
    hist = {int(t): n for t, n in info["staleness_hist"].items()}
    assert dict(store._engine.staleness_hist) == hist


def test_replay_through_the_reference_engine(mp_run):
    import jax.numpy as jnp

    import ps_tpu

    _, info, final = mp_run
    params = harness.model_params()
    ps_tpu.init(backend="tpu", mode="async", num_workers=NWORKERS,
                dc_lambda=harness.DC_LAMBDA)
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=harness.LR,
                               mode="async")
        store.init({k: jnp.asarray(v) for k, v in params.items()})
        got = _replay(store._engine, params, info["event_log"])
        for k in final:
            np.testing.assert_allclose(final[k], np.asarray(got[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    finally:
        ps_tpu.shutdown()


def test_kill_one_server_raises_typed_error(tmp_path):
    """SIGKILL one server of a 2-server partition mid-job: the worker's
    next cycle raises ServerFailureError naming it, not a hang."""
    params = harness.model_params()
    servers = [harness.spawn("server", tmp_path, 1, 10_000, s, 2)
               for s in range(2)]
    try:
        ports = [harness.server_port(p, tmp_path, s)
                 for s, p in enumerate(servers)]
        w = connect_async(",".join(f"127.0.0.1:{p}" for p in ports), 0,
                          _t(params))
        w.pull_all()
        w.push_pull(_t(harness.make_grads(params, 0, 0)))
        assert w.versions == [1, 1]
        servers[0].send_signal(signal.SIGKILL)
        servers[0].wait(timeout=10)
        with pytest.raises(ServerFailureError, match=r"server 0") as ei:
            for c in range(1, 20):  # the first push may land in a buffer
                w.push_pull(_t(harness.make_grads(params, 0, c)))
                time.sleep(0.05)
        assert ei.value.server == 0
        for ch in w._chs:
            ch.close()
    finally:
        harness.kill_all(servers)


TRAINER = "ps_tpu_torch.examples.train_mnist_async"


@pytest.mark.parametrize("shards", [None, 2], ids=["one-server", "2-shards"])
def test_trainer_roles_across_processes_replay_bitwise(tmp_path, shards):
    """``--role server`` and two ``--role worker`` processes of the MNIST
    trainer on the CPU; replaying the servers' event logs, with the MNIST
    gradients recomputed from what each worker pulled, gives their final
    parameters bitwise, and so does a witness replay in lockstep on the
    same device (its gradients equal, bit for bit)."""
    common = ["--device", "cpu", "--batch-size", "16", "--dump", tmp_path]
    servers = [harness.spawn(
        "--role", "server", "--port", 0, "--num-workers", 2, *common,
        *(["--shard", s, "--num-shards", shards] if shards else []),
        module=TRAINER) for s in range(shards or 1)]
    try:
        ports = [harness.trainer_port(p) for p in servers]
    except RuntimeError:
        harness.kill_all(servers)
        raise
    uri = ",".join(f"127.0.0.1:{p}" for p in ports)
    workers = [harness.spawn("--role", "worker", "--server", uri,
                             "--worker-id", w, "--steps", 6, *common,
                             module=TRAINER) for w in range(2)]
    procs = servers + workers
    outs = harness.finish(procs, wall_s=180)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{o}"
    sfx = [""] if not shards else [str(s) for s in range(shards)]
    infos = [json.loads((tmp_path / f"server{x}.json").read_text())
             for x in sfx]
    final = {}
    for x in sfx:
        final.update(torch.load(tmp_path / f"server_params{x}.pt"))
    for info in infos:
        assert info["version"] == 12
        assert sum(info["staleness_hist"].values()) == 12
    logs = [i["event_log"] for i in infos]
    with harness.one_thread():  # as the workers took their gradients
        got = harness.replay(logs, 2, "cpu", batch_size=16)
        again, witnessed, grad_err = harness.replay(
            logs, 2, "cpu", witness="cpu", batch_size=16)
    assert sorted(got) == sorted(final) == sorted(witnessed)
    assert grad_err["witness"] == grad_err["relative"] == 0.0
    assert 0.0 < grad_err["smallest"] <= 1.0 <= grad_err["largest"]
    for k in final:
        assert torch.equal(final[k], got[k]), k
        assert torch.equal(final[k], again[k]), k
        assert torch.equal(final[k], witnessed[k]), k
    for w in range(2):
        r = json.loads((tmp_path / f"worker{w}.json").read_text())
        assert len(r["losses"]) == 6 and np.all(np.isfinite(r["losses"]))


# -- the two-server partition ----------------------------------------------


def _mlp_params():
    return _t(harness.model_params())


def test_key_partition_is_disjoint_complete_and_replays_per_shard():
    params = harness.model_params()
    svcs, uri = _job(_t(params), num_workers=2, shards=2,
                     record_full_history=True)
    try:
        ws = [connect_async(uri, w, _t(params)) for w in range(2)]
        for w in ws:
            w.pull_all()
        for c in range(3):
            for i, w in enumerate(ws):
                w.push_pull(_t(harness.make_grads(params, i, c)))
        assert [w.versions for w in ws][-1] == [6, 6]
        seen = {}
        for s, svc in enumerate(svcs):
            assert svc._key_order, f"shard {s} owns no keys"
            for k in svc._key_order:
                assert k not in seen and keymod.shard_for_key(k, 2) == s
                seen[k] = s
        assert sorted(seen) == sorted(params)
        merged = {}
        for w in ws:
            merged.update(_flat(w._params))
        finals = [{k: v.numpy().copy() for k, v in
                   svc._engine._params.items()} for svc in svcs]
        logs = [list(svc.event_log) for svc in svcs]
        for w in ws:
            w.close()
    finally:
        _stop(svcs)
    for s in range(2):
        owned = shard_tree(params, s, 2)
        ps_tpu_torch.init(backend="cuda", mode="async", num_workers=2,
                          dc_lambda=harness.DC_LAMBDA, device="cpu")
        store = ps_tpu_torch.KVStore(optimizer="sgd",
                                     learning_rate=harness.LR, mode="async")
        store.init(_t(owned))
        got = _replay(store._engine, params, logs[s], owned=owned)
        for k in owned:
            np.testing.assert_array_equal(finals[s][k], got[k].numpy())
        ps_tpu_torch.shutdown()


def test_misconfigured_topology_fails_loudly():
    params = _mlp_params()
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.05,
                                 mode="async")
    store.init(shard_tree(params, 0, 2))
    svc = AsyncPSService(store, shard=0, num_shards=2)
    whole = ps_tpu_torch.KVStore(optimizer="sgd", mode="async")
    whole.init(params)
    one = AsyncPSService(whole)
    try:
        with pytest.raises(ValueError, match="dialed 1 server"):
            connect_async(f"127.0.0.1:{svc.port}", 0, params)
        with pytest.raises(ValueError, match="out of range"):
            connect_async(f"127.0.0.1:{one.port}", 1, params)
        with pytest.raises(ValueError, match="absent from this worker"):
            connect_async(f"127.0.0.1:{one.port}", 0,
                          shard_tree(params, 0, 2))
    finally:
        one.stop()
        _stop([svc])


def test_service_rejects_misplaced_keys():
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", mode="async")
    store.init(_mlp_params())  # the full tree, claiming shard 0 of 2
    with pytest.raises(ValueError, match="not owned by shard"):
        AsyncPSService(store, shard=0, num_shards=2)
    sync = ps_tpu_torch.KVStore(optimizer="sgd", mode="sync")
    sync.init(_mlp_params())
    with pytest.raises(ValueError, match="async-mode"):
        AsyncPSService(sync)


# -- checkpoints ------------------------------------------------------------


def _small_params(seed):
    rng = np.random.default_rng(seed)
    return {f"p{i}/w": torch.tensor(rng.normal(0, 1, (4, 3)),
                                    dtype=torch.float32) for i in range(6)}


def test_coordinated_checkpoint_restart_roundtrip(tmp_path):
    """checkpoint_all across a 2-shard partition; the servers train past
    it, stop, restart from their shard checkpoints on new ports; the
    worker reconnects and sees the checkpoint's params and versions."""
    params = _small_params(7)
    grads = {k: torch.full_like(v, 0.1) for k, v in params.items()}
    svcs, uri = _job(params, lr=0.1, shards=2)
    w = connect_async(uri, 0, params)
    w.pull_all()
    w.push_pull(grads)
    ck = str(tmp_path / "ck")
    versions = w.checkpoint_all(ck)
    assert sum(versions) == w.version == 2
    ref = _flat(w._params)
    w.push_pull(grads)  # past the checkpoint
    for s in svcs:
        s.stop()
    svcs2 = []
    for s in range(2):
        st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1,
                                  mode="async")
        st.init(shard_tree(params, s, 2))
        st.restore(f"{ck}/shard{s}")
        svcs2.append(AsyncPSService(st, shard=s, num_shards=2))
    try:
        w.reconnect([("127.0.0.1", s.port) for s in svcs2])
        assert w.versions == versions
        pulled = _flat(w.pull_all())
        for k, v in ref.items():
            np.testing.assert_array_equal(v, pulled[k], err_msg=k)
        w.push_pull(grads)
        assert w.version == sum(versions) + 2
        w.close()
    finally:
        _stop(svcs2)


def test_checkpoint_is_cross_shard_atomic_under_concurrent_pushes(tmp_path):
    """Each push_pull applies one subtree on each shard, so an atomic
    snapshot has equal shard versions; hammer checkpoints while another
    worker pushes, and no snapshot may be torn."""
    params = _small_params(3)
    svcs, uri = _job(params, num_workers=2, lr=0.01, dc_lambda=0.0,
                     shards=2)
    pusher = connect_async(uri, 0, params)
    ckpter = connect_async(uri, 1, params)
    grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
    stop = threading.Event()

    def push_loop():
        pusher.pull_all()
        while not stop.is_set():
            pusher.push_pull(grads)

    t = threading.Thread(target=push_loop)
    t.start()
    try:
        for i in range(4):
            versions = ckpter.checkpoint_all(str(tmp_path / f"ck{i}"))
            assert versions[0] == versions[1], (i, versions)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    pusher.close()
    ckpter.close()
    _stop(svcs)


def test_force_resume_after_a_lost_coordinator():
    """A coordinator that paused the servers and died leaves its token
    outstanding: pushes block and a second pause is refused until
    checkpoint_resume_force releases every server."""
    params = _small_params(9)
    svcs, uri = _job(params, shards=2)
    for s in svcs:  # a coordinator pauses and dies holding the token
        with tv.Channel.connect("127.0.0.1", s.port) as ch:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.CHECKPOINT, 0, None, extra={"phase": "pause"})))
            assert kind == tv.OK and extra["token"] == 1
    w = connect_async(uri, 0, params)
    w.pull_all()
    with pytest.raises(Exception, match="already in progress"):
        w.checkpoint_all("unused")
    done = threading.Event()
    t = threading.Thread(target=lambda: (w.push_pull(
        {k: torch.ones_like(v) for k, v in params.items()}), done.set()))
    t.start()
    assert not done.wait(0.5)  # the push is parked by the pause
    w2 = connect_async(uri, 0, params)
    w2.checkpoint_resume_force()
    t.join(timeout=30)
    assert done.is_set() and w.versions == [1, 1]
    w2.close()
    w.close()
    _stop(svcs)


# -- the service's lifecycle -------------------------------------------------


def test_stop_drains_inflight_reply():
    """A request received before stop() completes: its push applies and
    its whole reply reaches the worker, even with stop() called mid-apply."""
    params = {"w": torch.zeros(256, 256)}
    (svc,), _ = _job(params, lr=0.1)
    w = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
    w.pull_all()
    eng = svc._engine
    orig_push = eng.push_tree
    in_apply, release = threading.Event(), threading.Event()

    def slow_push(grads, worker=0):
        in_apply.set()
        release.wait(timeout=30)  # held open while stop() runs
        return orig_push(grads, worker=worker)

    eng.push_tree = slow_push
    result = {}

    def do_push_pull():
        try:
            result["params"] = w.push_pull({"w": torch.ones(256, 256)})
        except Exception as e:  # noqa: BLE001 — recorded for the assert
            result["error"] = e

    pusher = threading.Thread(target=do_push_pull)
    pusher.start()
    assert in_apply.wait(timeout=30)
    stopper = threading.Thread(target=svc.stop)
    stopper.start()
    time.sleep(0.3)  # stop() reaches its drain wait
    assert pusher.is_alive(), "reply torn while the apply was in flight"
    release.set()
    pusher.join(timeout=30)
    stopper.join(timeout=30)
    assert not pusher.is_alive() and not stopper.is_alive()
    assert "error" not in result, repr(result.get("error"))
    assert eng.version == 1
    np.testing.assert_array_equal(result["params"]["w"].numpy(),
                                  eng.pull_tree(worker=0)["w"].numpy())
    w.close()
    ps_tpu_torch.shutdown()


def test_wait_for_goodbyes_times_out_false():
    params = {"w": torch.zeros(4, 4)}
    (svc,), _ = _job(params, num_workers=2)
    w0 = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
    w0.pull_all()
    assert svc.wait_for_goodbyes(1, timeout=0.2) is False
    w0.close()
    assert svc.wait_for_goodbyes(1, timeout=10) is True
    assert svc.goodbyes == 1
    assert svc.wait_for_goodbyes(2, timeout=0.2) is False
    _stop([svc])


def test_idle_client_survives_slow_cadence():
    """A worker idle for over a second between requests keeps its
    connection; after stop() a push is refused and the version frozen."""
    params = {"w": torch.zeros(64, 64)}
    (svc,), _ = _job(params, lr=0.1)
    w = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
    w.pull_all()
    for _ in range(2):
        time.sleep(1.1)
        w.push_pull({"w": torch.ones(64, 64)})
    assert w.version == 2
    svc.stop()
    with pytest.raises(Exception):
        w.push_pull({"w": torch.ones(64, 64)})
    assert svc._engine.version == 2
    w.close()
    ps_tpu_torch.shutdown()


def test_local_backend_async_store_is_served():
    """An async store of the local backend serves as the cuda backend's
    does: the same two cycles give bitwise the same params."""
    params = _layers(n=3)
    grads = [{k: torch.full_like(v, 0.01 * (c + 1)) for k, v in
              params.items()} for c in range(2)]
    finals = []
    for backend in ("cuda", "local"):
        ps_tpu_torch.init(backend=backend, mode="async", num_workers=1,
                          dc_lambda=0.04, device="cpu")
        store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.05,
                                     mode="async")
        store.init(params)
        svc = AsyncPSService(store)
        w = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
        w.pull_all()
        for g in grads:
            out = w.push_pull(g)
        finals.append(_flat(out))
        w.close()
        _stop([svc])
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)


# -- the bucketed transport ---------------------------------------------------


def _layers(seed=0, n=6, shape=(32, 17)):
    rng = np.random.default_rng(seed)
    return {f"layer{i}/w": torch.tensor(rng.normal(0, 1, shape),
                                        dtype=torch.float32)
            for i in range(n)}


@pytest.mark.parametrize("shards", [None, 2], ids=["one-server", "2-shards"])
def test_bucketed_push_pull_matches_serial_bit_for_bit(shards):
    params = _layers(seed=3 if shards else 0)
    grads_seq = [{k: torch.full_like(v, 0.01 * (s + 1))
                  for k, v in params.items()} for s in range(4)]
    finals = []
    for bucket_bytes in (None, 1 << 11):
        svcs, uri = _job(params, shards=shards)
        w = connect_async(uri, 0, params, bucket_bytes=bucket_bytes,
                          pool_size=3)
        w.pull_all()
        for g in grads_seq:
            w.push_pull(g)
        assert w.versions == [4] * (shards or 1)
        finals.append(_flat(w._params))
        if bucket_bytes:
            assert w.transport.buckets > 0
        w.close()
        _stop(svcs)
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)


def test_torn_push_is_never_observable():
    params = _layers(seed=5, n=4, shape=(64, 16))
    (svc,), _ = _job(params)
    w = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
    before = _flat(w.pull_all())
    host = {k: np.full(v.shape, 0.5, np.float32) for k, v in params.items()}
    plan = BucketPlan.from_arrays(host, 1 << 10)
    assert plan.nbuckets >= 3
    ch = tv.Channel.connect("127.0.0.1", svc.port)
    for b in range(plan.nbuckets - 1):  # everything but the last bucket
        kind, _, _, extra = tv.decode(ch.request(plan.encode_bucket(
            tv.BUCKET_PUSH, 0, host, b, extra={"epoch": 1})))
        assert kind == tv.OK and "committed" not in extra
    assert svc._engine.version == 0
    mid = _flat(w.pull_all())
    for k in before:
        np.testing.assert_array_equal(before[k], mid[k], err_msg=k)
    kind, _, _, extra = tv.decode(ch.request(plan.encode_bucket(
        tv.BUCKET_PUSH, 0, host, plan.nbuckets - 1, extra={"epoch": 1})))
    assert kind == tv.OK and extra.get("committed")
    assert int(extra["version"]) == 1
    after = _flat(w.pull_all())
    assert any(not np.array_equal(before[k], after[k]) for k in before)
    ch.close()
    w.close()
    _stop([svc])


def test_abandoned_epoch_superseded_not_merged():
    params = _layers(seed=6, n=3, shape=(64, 8))
    (svc,), _ = _job(params)
    w = RemoteAsyncWorker("127.0.0.1", svc.port, 0, params)
    w.pull_all()
    poison = {k: np.full(v.shape, 99.0, np.float32)
              for k, v in params.items()}
    real = {k: np.full(v.shape, 0.25, np.float32) for k, v in params.items()}
    plan = BucketPlan.from_arrays(poison, 1 << 9)
    assert plan.nbuckets >= 2
    ch = tv.Channel.connect("127.0.0.1", svc.port)
    kind, _, _, _ = tv.decode(ch.request(plan.encode_bucket(
        tv.BUCKET_PUSH, 0, poison, 0, extra={"epoch": 1})))
    assert kind == tv.OK
    plan2 = BucketPlan.from_arrays(real, 1 << 9)
    for b in range(plan2.nbuckets):
        kind, _, _, extra = tv.decode(ch.request(plan2.encode_bucket(
            tv.BUCKET_PUSH, 0, real, b, extra={"epoch": 2})))
        assert kind == tv.OK
    assert extra.get("committed") and int(extra["version"]) == 1
    assert svc.transport.stale_epochs == 1
    # the replay: one apply of exactly `real` on the initial params
    ref = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.05,
                               mode="async")
    ref.init(params)
    ref._engine.pull_tree(worker=0)
    ref._engine.push_tree(_t(real), worker=0)
    want = {k: v.numpy() for k, v in ref._engine.pull_tree(worker=0).items()}
    got = _flat(w.pull_all())
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    ch.close()
    w.close()
    _stop([svc])


def test_overlapped_mnist_step_gives_the_serial_losses():
    """make_async_step(overlap=True) takes every gradient at the serial
    step's params: loss for loss, and the same final params."""
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build

    runs = []
    for overlap in (False, True):
        params, loss_fn = build(0, "cpu")
        svcs, uri = _job(params, lr=0.1)
        w = connect_async(uri, 0, params, bucket_bytes=1 << 14, pool_size=2)
        run = w.make_async_step(loss_fn, overlap=overlap)
        stream = mnist_batches(16, seed=0, worker=0, num_workers=1)
        losses = [float(run(tuple(torch.as_tensor(x) for x in next(stream))))
                  for _ in range(5)]
        w.flush()
        if overlap:
            s = w.transport.summary()
            assert s["transport_buckets"] > 0 and "overlap_efficiency" in s
        runs.append((losses, _flat(svcs[0]._engine._params)))
        w.close()
        _stop(svcs)
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


def test_stats_reply_carries_the_references_fields():
    params = _layers(n=2)
    (svc,), _ = _job(params)
    w = connect_async(f"127.0.0.1:{svc.port}", 0, params,
                      bucket_bytes=1 << 10)
    w.pull_all()
    w.push_pull({k: torch.ones_like(v) for k, v in params.items()})
    st = w.stats()
    for key in ("version", "staleness_hist", "apply_log", "apply_log_total",
                "worker_version", "stale_epochs", "stale_epoch_buckets",
                "metrics", "role", "epoch"):
        assert key in st, key
    assert st["version"] == 1 and st["apply_log"] == [0]
    assert st["metrics"]["transport_buckets"] == 0  # the server sends none
    assert "pull_s" in w.transport.metrics_snapshot()["lat"]
    w.close()
    _stop([svc])


# -- interop with the reference ----------------------------------------------


def _ref_alone(params, grads_seq):
    """Reference server + reference worker, one worker."""
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import connect_async as ref_connect
    from ps_tpu.backends.remote_async import serve_async as ref_serve

    ps_tpu.init(backend="tpu", mode="async", num_workers=1,
                dc_lambda=harness.DC_LAMBDA)
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=harness.LR,
                               mode="async")
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        store.init(jparams)
        svc = ref_serve(store)
        w = ref_connect(f"127.0.0.1:{svc.port}", 0, jparams)
        w.pull_all()
        for g in grads_seq:
            out = w.push_pull({k: jnp.asarray(v) for k, v in g.items()})
        w.close()
        svc.stop()
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        ps_tpu.shutdown()


def _grads_seq(params, n=4):
    return [harness.make_grads(params, 0, c) for c in range(n)]


def test_port_worker_against_reference_server():
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import serve_async as ref_serve

    params = harness.model_params()
    seq = _grads_seq(params)
    want = _ref_alone(params, seq)
    ps_tpu.init(backend="tpu", mode="async", num_workers=1,
                dc_lambda=harness.DC_LAMBDA)
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=harness.LR,
                               mode="async")
        store.init({k: jnp.asarray(v) for k, v in params.items()})
        svc = ref_serve(store)
        for bucket_bytes in (None, 1 << 12):
            w = connect_async(f"127.0.0.1:{svc.port}", 0, _t(params),
                              bucket_bytes=bucket_bytes)
            if bucket_bytes is None:
                w.pull_all()
                for g in seq:
                    out = _flat(w.push_pull(_t(g)))
                for k in want:
                    np.testing.assert_allclose(out[k], want[k], rtol=RTOL,
                                               atol=ATOL, err_msg=k)
            else:  # the bucketed frames, too (the server keeps training)
                w.pull_all()
                w.push_pull(_t(seq[0]))
                assert w.version == len(seq) + 1
            w.close()
        svc.stop()
    finally:
        ps_tpu.shutdown()


@pytest.mark.parametrize("bucket_bytes,shm", [(None, False), (1 << 12, True)],
                         ids=["serial", "bucketed-shm-offer"])
def test_reference_worker_against_port_server(bucket_bytes, shm):
    import jax.numpy as jnp

    from ps_tpu.backends.remote_async import connect_async as ref_connect

    params = harness.model_params()
    seq = _grads_seq(params)
    want = _ref_alone(params, seq)
    (svc,), uri = _job(_t(params))
    try:
        w = ref_connect(uri, 0, {k: jnp.asarray(v) for k, v in
                                 params.items()},
                        bucket_bytes=bucket_bytes, shm=shm)
        if shm:  # the port's server accepted the offer: rings, not TCP
            assert all(getattr(ch, "lane", "tcp") == "shm" for ch in w._chs)
            assert all(p._ch.lane == "shm" for ps_ in w._pumps.values()
                       for p in ps_)
        w.pull_all()
        for g in seq:
            out = w.push_pull({k: jnp.asarray(v) for k, v in g.items()})
        stats = w.stats()
        w.close()
        assert stats["version"] == len(seq)
        for k in want:
            np.testing.assert_allclose(np.asarray(out[k]), want[k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    finally:
        _stop([svc])


# -- what is not ported yet --------------------------------------------------


#: options a later item ported: they must now be accepted and in effect
#: (``match`` None), where they used to raise naming their item
@pytest.mark.parametrize("kwargs,match", [
    ({"compress": "int8"}, None),
    ({"shm": True}, None),
    ({"coordinator": "{coord}"}, None),
    ({"aggregator": "{agg}"}, None),
    ({"read_staleness": 2}, None),
    ({"pull_cache": True}, None),
    ({"uri": "{uri}|127.0.0.1:1"}, None),
], ids=["compress", "shm", "coordinator", "aggregator", "read_staleness",
        "pull_cache", "replica-set"])
def test_deferred_worker_options_raise(kwargs, match):
    from ps_tpu_torch.elastic import Coordinator

    params = {"w": torch.zeros(2)}
    coord = Coordinator() if "coordinator" in kwargs else None
    ca = f"127.0.0.1:{coord.port}" if coord is not None else None
    (svc,), uri = _job(params, coordinator=ca)
    agg = None
    try:
        kw = dict(kwargs)
        if match is None:
            # items 5.2 (shm), 5.3 (compress), 5.5 (aggregator), 5.6
            # (replicas), 5.8 (reads), 6.2 (a coordinator's table)
            if "coordinator" in kw:
                kw["coordinator"], kw["uri"] = ca, None
            if "aggregator" in kw:
                from ps_tpu_torch.backends.aggregator import AggregatorService

                agg = AggregatorService(uri, params, group_size=1)
                kw["aggregator"] = f"127.0.0.1:{agg.port}"
            u = kw.pop("uri", uri)
            w = connect_async(u and u.format(uri=uri), 0, params, **kw)
            if "coordinator" in kw:
                assert w._table.epoch == 1
                assert w._addrs == [("127.0.0.1", svc.port)]
            elif "aggregator" in kw:
                assert w._addrs == [("127.0.0.1", agg.port)]
                assert w._agg_fallback["addrs"] == [("127.0.0.1", svc.port)]
            elif "shm" in kw:
                assert w._chs[0].lane == "shm"
            elif "compress" in kw:
                assert w.compress == {"codec": "int8", "seed": 0}
            elif "read_staleness" in kw:
                assert w.read_staleness == 2 and not w.pull_cache
            elif "pull_cache" in kw:
                assert w.pull_cache and w.read_staleness == 0
            else:  # the primary first, its backup after it
                assert w._replica_sets == [[("127.0.0.1", svc.port),
                                            ("127.0.0.1", 1)]]
            w.push_pull({"w": torch.ones(2)})
            assert w.version == 1
            if agg is not None:  # one merged round, from the group's id
                assert agg.transport.agg_rounds == 1
                assert set(svc._applied) == {AGG_WORKER_BASE}
            if "read_staleness" in kw or "pull_cache" in kw:
                # the read sees the push; the cache answers the repeat
                read = w.read_all()
                np.testing.assert_array_equal(
                    read["w"].numpy(), w.pull_all()["w"].numpy())
                w.read_all()
                assert w.transport.read_cache_hits == (
                    1 if "pull_cache" in kw else 0)
            w.close()
            return
        with pytest.raises(NotImplementedError, match=match):
            connect_async(kw.pop("uri", uri), 0, params, **kw)
    finally:
        if agg is not None:
            agg.stop()
        _stop([svc])
        if coord is not None:
            coord.stop()


@pytest.mark.parametrize("kwargs,match", [
    ({"backup": True}, None),
    ({"native_loop": True}, None),
    ({"shm": True}, None),
    ({"coordinator": "{coord}"}, None),
], ids=["backup", "native_loop", "shm", "coordinator"])
def test_deferred_server_options_raise(kwargs, match):
    """What stays deferred raises naming its item; what items 5.1 (the
    native loop), 5.2 (accepting shm offers), 5.6 (a backup) and 6.2 (a
    coordinator's table) ported is in effect."""
    from ps_tpu_torch.elastic import Coordinator

    ps_tpu_torch.init(backend="cuda", mode="async", device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd", mode="async")
    store.init({"w": torch.zeros(2)})
    if match is None:
        coord = Coordinator() if "coordinator" in kwargs else None
        if coord is not None:
            kwargs = {"coordinator": f"127.0.0.1:{coord.port}"}
        svc = AsyncPSService(store, **kwargs)
        try:
            if "backup" in kwargs:
                assert svc.role == "backup" and svc.epoch == 0
            elif "native_loop" in kwargs:
                assert svc.native_loop
            elif coord is not None:
                assert coord.table().keys_of(0) == ["w"]
                assert svc.table_epoch == 1 and svc._elastic
            else:
                assert svc._shm_accept and not svc.native_loop
        finally:
            svc.stop()
            if coord is not None:
                coord.stop()
        return
    with pytest.raises(NotImplementedError, match=match):
        AsyncPSService(store, **kwargs)


@pytest.mark.parametrize("kind,match", [
    (tv.READ, None),
    (tv.MIGRATE_OUT, "KeyError.*keys"),
    (tv.REPLICA_STATE, None),
    (tv.RESEED, "reseed needs spare"),
], ids=["read", "migrate", "replica", "reseed"])
def test_deferred_kinds_are_answered_err(kind, match):
    """The kinds of items 5.6, 5.8 and 6.2, each once answered ERR naming
    its item, are served: REPLICA_STATE reports the role, a RESEED
    without a spare and a MIGRATE_OUT without its keys are refused for
    that, a READ gets the params at their version."""
    import re

    params = {"w": torch.zeros(2)}
    (svc,), _ = _job(params)
    try:
        with tv.Channel.connect("127.0.0.1", svc.port) as ch:
            got, _, _, extra = tv.decode(ch.request(tv.encode(kind, 0, None)))
        if kind == tv.READ:
            assert got == tv.OK and extra["version"] == 0, extra
        elif match is None:
            assert got == tv.OK and extra["role"] == "primary", extra
        else:
            assert got == tv.ERR and re.search(match, extra["error"]), extra
    finally:
        _stop([svc])


@pytest.mark.parametrize("flags", [["--compress", "int8"], ["--backup"],
                                   ["--replicate-to", "h:1"]],
                         ids=["compress", "backup", "replicate-to"])
def test_deferred_trainer_flags_raise(flags):
    """Flags a later item ported parse into their options: ``--compress``
    (item 5.3) into the worker's codec flags, the replication flags (item
    5.6) into the server's, which refuses a backup that would also
    replicate."""
    from ps_tpu_torch.examples import train_mnist_async

    if flags[0] == "--compress":
        args = train_mnist_async.parse_args(
            ["--device", "cpu", "--role", "worker", *flags,
             "--compress-topk", "0.05", "--compress-min-bytes", "4096"])
        assert (args.compress, args.compress_topk,
                args.compress_min_bytes) == ("int8", 0.05, 4096)
        return
    args = train_mnist_async.parse_args(
        ["--device", "cpu", "--role", "server", *flags,
         "--replica-ack", "async", "--replica-window", "8"])
    assert (args.backup, args.replicate_to) == (
        flags == ["--backup"], flags[1] if len(flags) > 1 else None)
    assert (args.replica_ack, args.replica_window) == ("async", 8)
    with pytest.raises(SystemExit, match="belong to the primary"):
        train_mnist_async.parse_args(["--role", "server", "--backup",
                                      "--beat", "h:1"])


def test_bf16_push_is_refused_with_a_typed_error():
    params = {"w": torch.zeros(4)}
    (svc,), uri = _job(params)
    try:
        w = connect_async(uri, 0, params)
        w.pull_all()
        with pytest.raises(TypeError, match="bfloat16"):
            w.push_pull({"w": torch.zeros(4, dtype=torch.bfloat16)})
        w.close()
    finally:
        _stop([svc])
