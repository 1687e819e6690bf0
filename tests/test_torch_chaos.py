"""The port's chaos harness (``ps_tpu_torch/chaos``) against the
reference's (``ps_tpu/chaos``), and the self-heal loops it drives on the
CPU.

- The pure parts equal the reference's: the seeded plans, the ledger
  rows of ``mark``, ``DATA_KINDS`` as kind numbers, the hook's refusal
  bytes, ``make_tree`` and ``parse_keys``.
- Every service of the port (dense, sparse, aggregator, a backup) offers
  each frame to its ``chaos`` slot first.
- A blackholed shard parks a coordinator-joined worker, which resumes
  when the hole closes with every push applied exactly once.
- The in-process re-seed loop: the primary dies, the watch promotes the
  backup, the policy re-seeds a registered spare, and the spare holds
  the survivor's params and ledger bitwise.
- Subprocess members (``python -m ps_tpu_torch.chaos.member --device
  cpu``): a shard frozen past the heartbeat timeout by SIGSTOP comes
  back in the coordinator's table, and a primary's SIGKILL ends in a
  re-seeded spare bitwise the survivor.
- The noisy neighbor raises its target's ``ps_server_apply_seconds``
  window mean over an untouched shard's.
- On the native loop, the hole refuses what reaches ``_dispatch`` (a
  fresh PUSH, PULL, PUSH_PULL) while the loop still answers a cached
  READ and a replay's ack itself, in both packages alike.
"""

import contextlib
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.chaos import ChaosHook, ChaosInjector
from ps_tpu_torch.chaos import member as port_member
from ps_tpu_torch.chaos.inject import DATA_KINDS
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.elastic import Coordinator
from ps_tpu_torch.elastic.member import CoordinatorMember, register_spare

CLASSES = (["blackhole", "sigstop", "slow_apply", "reconnect_storm"],
           ["slow_apply", "sigstop", "blackhole", "reconnect_storm",
            "underload", "agg_death", "sigkill"])


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def _init(num_workers=1):
    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                      num_workers=num_workers, dc_lambda=0.0)


def _store(params, lr=0.5):
    st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=lr,
                              mode="async")
    st.init({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return st


def _like(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _full(tree, value):
    return {k: torch.full(tuple(v.shape), value, dtype=torch.float32)
            for k, v in tree.items()}


def _params(svc, k):
    return svc._engine._params[k].cpu().numpy()


# -- the pure parts against the reference -------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 41])
@pytest.mark.parametrize("classes", CLASSES, ids=["four", "seven"])
def test_plan_equals_the_references(seed, classes):
    from ps_tpu.chaos import ChaosInjector as RefInjector

    for horizon, spacing in ((30.0, 2.0), (12.5, 0.0)):
        got = ChaosInjector(seed=seed).plan(classes, horizon, spacing)
        assert got == RefInjector(seed=seed).plan(classes, horizon, spacing)
        assert sorted(r["fault"] for r in got) == sorted(classes)
        assert all(got[i]["at_s"] < got[i + 1]["at_s"]
                   for i in range(len(got) - 1))
    # a second plan from the same injector continues one random stream
    a, b = ChaosInjector(seed=seed), RefInjector(seed=seed)
    a.plan(classes, 30.0)
    b.plan(classes, 30.0)
    assert a.plan(classes, 9.0) == b.plan(classes, 9.0)


def test_seed_none_reads_ps_chaos_seed(monkeypatch):
    from ps_tpu.chaos import ChaosInjector as RefInjector

    monkeypatch.setenv("PS_CHAOS_SEED", "41")
    assert ChaosInjector().seed == RefInjector().seed == 41
    assert ChaosInjector().plan(CLASSES[0], 30.0) == \
        RefInjector(seed=41).plan(CLASSES[0], 30.0)


def test_mark_ledger_rows_equal_the_references():
    from ps_tpu.chaos import ChaosInjector as RefInjector

    rows = []
    for inj in (ChaosInjector(seed=0), RefInjector(seed=0)):
        inj.mark("agg_death", target=1234)
        inj.mark("sigkill", pid=99, note="x")
        assert all(isinstance(r["t"], float) for r in inj.injections)
        rows.append([{k: v for k, v in r.items() if k != "t"}
                     for r in inj.injections])
    assert rows[0] == rows[1] == [
        {"fault": "agg_death", "target": 1234},
        {"fault": "sigkill", "pid": 99, "note": "x"}]


def test_data_kinds_equal_the_references():
    from ps_tpu.chaos.inject import DATA_KINDS as REF_KINDS

    assert sorted(DATA_KINDS) == sorted(REF_KINDS)
    assert len(DATA_KINDS) == 10


def test_hook_refusal_bytes_equal_the_references():
    from ps_tpu.chaos import ChaosHook as RefHook

    class FakeSvc:
        port = 1234
        epoch = 3

    port_svc, ref_svc = FakeSvc(), FakeSvc()
    hook, ref = ChaosHook(port_svc), RefHook(ref_svc)
    assert port_svc.chaos is hook and ref_svc.chaos is ref
    assert hook(port_svc, tv.PUSH, 0, {}) is None  # inert
    hook.blackhole(30.0)
    ref.blackhole(30.0)
    assert hook.active
    for kind in (tv.STATS, tv.COORD_TABLE, tv.HELLO, tv.REPLICA_APPEND):
        assert hook(port_svc, kind, 0, {}) is None
    for kind in sorted(DATA_KINDS):
        got = hook(port_svc, kind, 2, {})
        assert bytes(got) == bytes(ref(ref_svc, kind, 2, {}))
        k, w, _, extra = tv.decode(memoryview(got))
        assert k == tv.ERR and w == 2
        assert extra["backup"] is True and extra["epoch"] == 3
        assert "blackhole" in extra["error"]
    assert hook.refused == ref.refused == len(DATA_KINDS)
    hook.clear()
    assert not hook.active and hook(port_svc, tv.PUSH, 0, {}) is None


def test_make_tree_and_parse_keys_bitwise_the_references():
    from ps_tpu.chaos.member import make_tree, parse_keys

    for arg in ("k1:512,k0:256,bare", "k00:16384,k01:16384,k02:16384"):
        spec = port_member.parse_keys(arg)
        assert spec == parse_keys(arg)
        for seed in (7, 21):
            got, want = port_member.make_tree(spec, seed), make_tree(spec,
                                                                     seed)
            assert list(got) == list(want) == sorted(spec)
            for k in got:
                assert got[k].dtype == np.float32
                assert got[k].tobytes() == want[k].tobytes()
    assert port_member.parse_keys("bare") == {"bare": 256}


# -- the hook slot on every service -------------------------------------------


def _sparse_service():
    from ps_tpu_torch.backends.remote_sparse import SparsePSService
    from ps_tpu_torch.kv.sparse import SparseEmbedding

    emb = SparseEmbedding(16, 4, optimizer="sgd", learning_rate=0.5)
    emb.init(np.zeros((16, 4), np.float32))
    return SparsePSService({"t": emb}, bind="127.0.0.1")


@pytest.mark.parametrize("which", ["dense", "sparse", "aggregator",
                                   "backup"])
def test_every_service_offers_frames_to_its_hook_first(which):
    from ps_tpu_torch.backends.aggregator import AggregatorService

    _init()
    tree = {"p": np.zeros((8,), np.float32)}
    up = svc = None
    try:
        if which == "sparse":
            svc = _sparse_service()
            probe = tv.encode(tv.ROW_PULL, 0, {"t": np.arange(4)})
        elif which == "aggregator":
            up = AsyncPSService(_store(tree), bind="127.0.0.1")
            svc = AggregatorService(f"127.0.0.1:{up.port}", _like(tree),
                                    group_size=1)
            probe = tv.encode(tv.PULL, 0, None)
        else:
            svc = AsyncPSService(_store(tree), bind="127.0.0.1",
                                 backup=(which == "backup"))
            probe = tv.encode(tv.READ if which == "backup" else tv.PULL,
                              0, None)
        hook = ChaosHook(svc)
        ch = tv.Channel.connect("127.0.0.1", svc.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(probe))
            assert kind != tv.ERR or "blackhole" not in extra.get("error",
                                                                  "")
            hook.blackhole(30.0)
            kind, _, _, extra = tv.decode(ch.request(probe))
            assert kind == tv.ERR and extra["backup"] is True
            assert "blackhole" in extra["error"]
            assert extra["epoch"] == svc.epoch
            kind, _, _, _ = tv.decode(ch.request(tv.encode(tv.STATS, 0,
                                                           None)))
            assert kind == tv.OK  # the control plane stays up
        finally:
            ch.close()
        assert hook.refused == 1
    finally:
        for s in (svc, up):
            if s is not None:
                s.stop()


# -- blackhole end to end: park, retry, exactly once --------------------------


def test_blackhole_parks_worker_and_heals_exactly_once():
    """A coordinator-connected worker facing a whole single-member replica
    set that refuses with the retryable backup shape parks, re-polling the
    table, and resumes against the same epoch when the hole closes: 10
    applies a key."""
    _init()
    coord = svc = w = None
    try:
        tree = port_member.make_tree({"p0": 256, "p1": 256}, seed=5)
        st = _store(tree)
        coord = Coordinator(bind="127.0.0.1", telemetry_window_s=2.0)
        ca = f"127.0.0.1:{coord.port}"
        svc = AsyncPSService(st, bind="127.0.0.1", coordinator=ca)
        hook = ChaosHook(svc)
        w = connect_async(None, 0, _like(tree), coordinator=ca,
                          failover_timeout=20.0)
        w.pull_all()
        grads = _full(tree, 2.0)
        for _ in range(5):
            w.push_pull(grads)
        hook.blackhole(1.0)
        t0 = time.monotonic()
        w.push_pull(grads)  # parks inside the failover budget, retries
        waited = time.monotonic() - t0
        assert waited >= 0.5, f"push sailed through the hole ({waited:.2f}s)"
        assert hook.refused > 0
        for _ in range(4):
            w.push_pull(grads)
        for k in tree:
            assert st._engine.apply_count[k] == 10, k
    finally:
        for s in (w, svc, coord):
            if s is not None:
                (s.close if s is w else s.stop)()


# -- the autopilot's re-seed in one process -----------------------------------


def test_policy_reseeds_spare_after_primary_death(monkeypatch):
    """The primary dies as SIGKILL leaves it, the PromotionWatch promotes
    the backup, the member's report shows the backup used up, and the
    policy re-seeds the registered spare with no operator call: the spare
    mirrors the survivor's params and ledger bitwise. The re-seed first
    probes the dead primary, whose dial retries for
    ``PS_CONNECT_MAX_WAIT_MS``: 3 s here, not the default 15."""
    monkeypatch.setenv("PS_CONNECT_MAX_WAIT_MS", "3000")
    from ps_tpu_torch.control.heartbeat import HeartbeatClient
    from ps_tpu_torch.replica.watch import PromotionWatch

    _init()
    coord = primary = b0 = spare = watch = hb = member = w = None
    try:
        tree = port_member.make_tree({"p0": 512, "p1": 512}, seed=21)
        coord = Coordinator(bind="127.0.0.1", report_ms=100,
                            hb_timeout_ms=5000, telemetry_window_s=2.0,
                            policy="on", policy_cooldown_s=1.0,
                            policy_burn_windows=2)
        ca = f"127.0.0.1:{coord.port}"
        primary = AsyncPSService(_store(tree), bind="127.0.0.1")
        b0 = AsyncPSService(_store(tree), bind="127.0.0.1", backup=True)
        primary.attach_backup("127.0.0.1", b0.port, ack="sync")
        watch = PromotionWatch(b0, primary_id=1, timeout_ms=400)
        hb = HeartbeatClient("127.0.0.1", watch.port, node_id=1,
                             interval_ms=50)
        watch.wait_for_primary()
        spare = AsyncPSService(
            _store(port_member.make_tree({"ph": 64}, 3)), bind="127.0.0.1",
            backup=True)
        register_spare(ca, f"127.0.0.1:{spare.port}")
        pair = f"127.0.0.1:{primary.port}|127.0.0.1:{b0.port}"
        key_bytes = {k: int(v.nbytes) for k, v in tree.items()}

        def report():
            s = b0._backup_session  # the survivor's downstream view
            return {"keys": len(tree), "nbytes": sum(key_bytes.values()),
                    "push_qps": 5.0,
                    "repl": {"attached": bool(s is not None
                                              and not s.degraded),
                             "degraded": bool(s is not None
                                              and s.degraded),
                             "promoted": b0.promote_reason is not None}}

        member = CoordinatorMember(ca, pair, key_bytes, report=report,
                                   report_ms=100)
        w = connect_async(pair, 0, _like(tree), failover_timeout=20.0)
        w.pull_all()
        grads = _full(tree, 1.0)
        for _ in range(6):
            w.push_pull(grads)
        assert all(b0._engine.apply_count[k] == 6 for k in tree)

        primary.kill()           # engine state dies as SIGKILL leaves it
        hb.close(goodbye=False)  # beats just stop: the watch times out
        _wait(lambda: b0.promote_reason is not None, 10.0, "promotion")
        assert watch.promoted_reason == "timeout"
        for _ in range(4):       # the worker fails over inside the set
            w.push_pull(grads)

        def reseeded():
            return any(e["rule"] == "replica_reseed"
                       and e["outcome"] == "ok"
                       for e in coord.policy.audit())

        _wait(reseeded, 20.0, "policy replica_reseed ok")
        [entry] = [e for e in coord.policy.audit()
                   if e["rule"] == "replica_reseed"]
        assert entry["detail"]["spare"] == f"127.0.0.1:{spare.port}"
        assert any(u.endswith(f"|127.0.0.1:{spare.port}")
                   for u in coord.table().shards)
        s = b0._backup_session
        assert s is not None and not s.degraded
        assert set(spare._engine._params) == set(tree)
        for _ in range(3):       # live replication after the re-seed
            w.push_pull(grads)
        for k in tree:
            assert b0._engine.apply_count[k] == 13, k
            _wait(lambda: spare._engine.apply_count.get(k) == 13, 5.0,
                  f"spare ledger catch-up for {k}")
            assert _params(b0, k).tobytes() == _params(spare, k).tobytes()
    finally:
        for closer in (
            lambda: w.close(),
            lambda: member.close(goodbye=True),
            lambda: hb.close(),
            lambda: watch.close(),
            lambda: spare.stop(),
            lambda: b0.stop(),
            lambda: primary.stop(),
            lambda: coord.stop(),
        ):
            try:
                closer()
            except Exception:
                pass


# -- subprocess members -------------------------------------------------------


def _finish(out_dir, procs):
    with open(os.path.join(out_dir, "done"), "w") as f:
        f.write("done\n")
    for proc, log in procs:
        try:
            proc.wait(timeout=20)
        except Exception:
            proc.kill()
            proc.wait()
        log.close()


def test_member_without_a_card_refuses_to_start(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present: the member would start on it")
    out = subprocess.run(
        [sys.executable, "-m", "ps_tpu_torch.chaos.member", "shard",
         "--out", str(tmp_path), "--name", "s", "--coord", "127.0.0.1:1",
         "--keys", "k0:16"], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode != 0
    assert "--device cpu" in out.stderr and "no CUDA device" in out.stderr
    assert not (tmp_path / "s.port").exists()


def test_subprocess_shard_survives_sigstop_in_the_table(tmp_path):
    """SIGSTOP freezes a member past the heartbeat timeout: the coordinator
    sees it dead, keeps it in the table (a dead member is a failover,
    never a move's donor), and after SIGCONT the parked push completes,
    the member beats again and every push is applied once."""
    _init()
    coord = w = None
    procs = []
    inj = ChaosInjector(seed=3)
    try:
        coord = Coordinator(bind="127.0.0.1", report_ms=100,
                            hb_timeout_ms=1500, telemetry_window_s=2.0)
        ca = f"127.0.0.1:{coord.port}"
        spec = "k0:256,k1:256"
        tree = port_member.make_tree(port_member.parse_keys(spec), 7)
        proc, pid, port, log = port_member.spawn(
            "shard", "s0", str(tmp_path), ca, spec, 7, device="cpu",
            num_workers=1)
        procs.append((proc, log))
        _wait(lambda: len(coord.table().shards) == 1, 30.0, "registration")
        w = connect_async(None, 0, _like(tree), coordinator=ca,
                          failover_timeout=30.0)
        w.pull_all()
        grads = _full(tree, 0.25)
        for _ in range(3):
            w.push_pull(grads)
        inj.sigstop(pid)
        done = threading.Event()
        th = threading.Thread(target=lambda: (w.push_pull(grads),
                                              done.set()))
        th.start()
        _wait(lambda: coord._members_view()[0]["hb_state"] == "dead", 10.0,
              "the heartbeat timeout")
        assert not done.is_set(), "a push was served by a frozen process"
        assert coord.table().shards == [f"127.0.0.1:{port}"]
        inj.sigcont(pid)
        th.join(timeout=30)
        assert done.is_set(), "the parked push never completed"
        _wait(lambda: coord._members_view()[0]["hb_state"] == "alive",
              10.0, "the member's beats after SIGCONT")
        for _ in range(2):
            w.push_pull(grads)
        got = w.pull_all()
        # exactly once: bitwise the same six pushes on an unfrozen shard
        twin = AsyncPSService(_store(tree, lr=0.01), bind="127.0.0.1")
        w2 = connect_async(f"127.0.0.1:{twin.port}", 0, _like(tree))
        try:
            w2.pull_all()
            for _ in range(6):
                w2.push_pull(grads)
            want = w2.pull_all()
        finally:
            w2.close()
            twin.stop()
        for k in tree:
            assert np.asarray(got[k]).tobytes() == \
                np.asarray(want[k]).tobytes(), k
        assert [r["fault"] for r in inj.injections] == ["sigstop",
                                                        "sigcont"]
    finally:
        # a member left frozen by a failed check would hold the worker's
        # channel (and the close) forever: resume it first
        for proc, _ in procs:
            with contextlib.suppress(OSError):
                os.kill(proc.pid, signal.SIGCONT)
        _finish(str(tmp_path), procs)
        if w is not None:
            w.close()
        if coord is not None:
            coord.stop()


def test_subprocess_primary_sigkill_reseeds_the_spare(tmp_path,
                                                       monkeypatch):
    """The soak's pair drill at a small size: a subprocess primary, an
    in-process backup under a PromotionWatch, a registered spare. After
    SIGKILL the watch promotes, the policy's replica_reseed ends ok, the
    healed pair is published at the next epoch, and the survivor and the
    spare hold the same apply counts and params bitwise (the dead
    primary's dial gives up after 3 s, as above)."""
    monkeypatch.setenv("PS_CONNECT_MAX_WAIT_MS", "3000")
    from ps_tpu_torch.elastic.member import TelemetryReporter
    from ps_tpu_torch.obs.collector import collect_telemetry
    from ps_tpu_torch.replica.watch import PromotionWatch

    _init()
    c2 = b0 = sp = watch = w = rep = None
    procs = []
    inj = ChaosInjector(seed=5)
    try:
        dims = {"p0": 512, "p1": 512}
        tree = port_member.make_tree(dims, seed=21)
        c2 = Coordinator(bind="127.0.0.1", report_ms=100,
                         hb_timeout_ms=1200, telemetry_window_s=2.0,
                         policy="on", policy_cooldown_s=1.0,
                         policy_burn_windows=2)
        c2a = f"127.0.0.1:{c2.port}"
        # the member's own learning rate, 0.01, in every store of the set
        b0 = AsyncPSService(_store(tree, lr=0.01), bind="127.0.0.1",
                            backup=True)
        watch = PromotionWatch(b0, primary_id=1, timeout_ms=1000)
        sp = AsyncPSService(_store(port_member.make_tree({"ph": 64}, 3),
                                   lr=0.01), bind="127.0.0.1", backup=True)
        register_spare(c2a, f"127.0.0.1:{sp.port}")
        proc, pid, port, log = port_member.spawn(
            "primary", "pair", str(tmp_path), c2a,
            ",".join(f"{k}:{d}" for k, d in dims.items()), 21,
            extra=("--backup", f"127.0.0.1:{b0.port}",
                   "--watch", f"127.0.0.1:{watch.port}",
                   "--watch-node", "1", "--report-ms", "100"),
            device="cpu", num_workers=1)
        procs.append((proc, log))
        watch.wait_for_primary(60.0)
        w = connect_async(f"127.0.0.1:{port}|127.0.0.1:{b0.port}", 0,
                          _like(tree), failover_timeout=30.0)
        w.pull_all()
        grads = _full(tree, 0.5)
        for _ in range(4):
            w.push_pull(grads)
        rep = TelemetryReporter(c2a, "chaos-pair-worker",
                                lambda: collect_telemetry(w.transport),
                                report_ms=100)
        # the worker's reports tick the pair coordinator's policy once the
        # dead pair stops reporting: traffic goes on through the drill
        pushes, errs, stop = [4], [], threading.Event()

        def hammer():
            try:
                while not stop.is_set():
                    w.push_pull(grads)
                    pushes[0] += 1
                    time.sleep(0.01)
            except BaseException as e:  # raised after the join
                errs.append(e)

        th = threading.Thread(target=hammer)
        th.start()
        try:
            time.sleep(0.5)
            at_kill, t_kill = pushes[0], time.monotonic()
            inj.sigkill(pid)
            proc.wait(timeout=10)

            def reseeded():
                return any(e["action"] == "reseed" and e["outcome"] == "ok"
                           and e.get("mono", 0.0) >= t_kill
                           for e in c2.policy.audit())

            _wait(reseeded, 30.0, "policy replica_reseed ok")
            time.sleep(0.3)  # pushes replicated to the spare
        finally:
            stop.set()
            th.join(timeout=60)
        assert not errs, errs
        assert pushes[0] > at_kill, "the worker never resumed"
        assert watch.promoted_reason == "timeout"
        assert b0.role == "primary"
        # the healed pair at the next table epoch
        assert c2.table().epoch >= 1
        assert c2.table().shards == [
            f"127.0.0.1:{b0.port}|127.0.0.1:{sp.port}"]
        for k in tree:  # exactly once on the promoted survivor
            assert b0._engine.apply_count[k] == pushes[0], k

        def mirrored():
            return all(
                sp._engine.apply_count.get(k) == b0._engine.apply_count[k]
                and _params(sp, k).tobytes() == _params(b0, k).tobytes()
                for k in tree if k in sp._engine._params)

        _wait(lambda: set(sp._engine._params) == set(tree) and mirrored(),
              10.0, "the spare mirroring the survivor")
    finally:
        for closer in (lambda: rep.close(), lambda: w.close(),
                       lambda: watch.close(), lambda: sp.stop(),
                       lambda: b0.stop(), lambda: c2.stop()):
            try:
                closer()
            except Exception:
                pass
        _finish(str(tmp_path), procs)


# -- the noisy neighbor -------------------------------------------------------


def test_noisy_neighbor_raises_the_targets_apply_window_mean():
    """The grinder holds shard 1's apply lock 0.05 s a beat: its window
    mean of ``ps_server_apply_seconds`` (the lock wait included) in the
    coordinator's time series stands well above shard 0's."""
    _init()
    coord = w = None
    svcs = []
    try:
        tree = port_member.make_tree({"a0": 256, "a1": 256, "b0": 256,
                                      "b1": 256}, seed=9)
        coord = Coordinator(bind="127.0.0.1", report_ms=100,
                            telemetry_window_s=2.0)
        ca = f"127.0.0.1:{coord.port}"
        for keys in (("a0", "a1"), ("b0", "b1")):
            svcs.append(AsyncPSService(_store({k: tree[k] for k in keys}),
                                       bind="127.0.0.1", coordinator=ca))
        _wait(lambda: len(coord.table().shards) == 2, 10.0, "registration")
        w = connect_async(None, 0, _like(tree), coordinator=ca)
        w.pull_all()
        grads = _full(tree, 1e-3)
        inj = ChaosInjector(seed=1)
        inj.noisy_neighbor(svcs[1], 2.0, hold_s=0.05)
        # a seeded pause of up to one grinder beat (0.05 s hold + 0.01 s
        # idle) after each push: back to back, a push released at a
        # hold's end re-pushes inside the 0.01 s gap and the next lands
        # at the next hold's start, so pushes lock to the grinder's phase
        # (a third of shard 1's waited, not five sixths), and shard 0's
        # applies race shard 1's in this one interpreter
        rng = np.random.default_rng(0)
        t_end = time.monotonic() + 2.0
        while time.monotonic() < t_end:
            w.push_pull(grads)
            time.sleep(rng.uniform(0.0, 0.06))
        inj.join()
        time.sleep(0.5)  # a report or two after the last push
        means = {}
        for i, s in enumerate(svcs):
            [name] = [m for m in coord.tsdb.members()
                      if m.endswith(f":{s.port}")]
            means[i] = coord.tsdb.member_mean(name, "ps_server_apply_seconds")
        assert means[0] is not None and means[1] is not None, means
        assert means[1][1] >= 3 and means[0][1] >= 3, means
        assert means[1][0] > 5.0 * means[0][0], means
        assert means[1][0] > 0.005, means
        assert inj.injections[0]["fault"] == "slow_apply"
    finally:
        if w is not None:
            w.close()
        for s in svcs:
            s.stop()
        if coord is not None:
            coord.stop()


# -- the hole on the native loop ----------------------------------------------


def _request(port, payload):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        return bytes(ch.request(payload))
    finally:
        ch.close()


def _native_hole(reference):
    """Against a dense service of one package on the native loop (push
    admission armed, the read cache on): what a blackhole refuses and
    what the loop answers itself. ``{frame: (kind, extra or None)}``, the
    refusals' bytes and the hook's count."""
    if reference:
        import jax.numpy as jnp

        import ps_tpu as ps
        from ps_tpu.backends.remote_async import AsyncPSService as Svc
        from ps_tpu.chaos import ChaosHook as Hook

        ps.init(backend="tpu", mode="async", num_workers=1, dc_lambda=0.0)
        st = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
        st.init({"w": jnp.zeros((4, 3))})
        shutdown = ps.shutdown
    else:
        Svc, Hook = AsyncPSService, ChaosHook
        _init()
        st = _store({"w": np.zeros((4, 3), np.float32)}, lr=0.01)
        shutdown = ps_tpu_torch.shutdown
    try:
        svc = Svc(st, native_loop=True)
        try:
            g = {"w": np.full((4, 3), 0.1, np.float32)}
            first = tv.encode(tv.PUSH, 0, g,
                              extra={"pseq": 1, "pnonce": "inc"})
            assert tv.decode(memoryview(_request(svc.port, first)))[0] \
                == tv.OK
            miss = _request(svc.port, tv.encode(tv.READ, 0, None))
            hit = _request(svc.port, tv.encode(tv.READ, 0, None))
            assert hit == miss
            deadline = time.monotonic() + 5
            while (svc._nloop.cache_stats()["hits"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            hits0 = svc._nloop.cache_stats()["hits"]
            assert hits0 >= 1
            hook = Hook(svc)
            hook.blackhole(30.0)
            frames = {
                "replay": bytes(first),
                "read": tv.encode(tv.READ, 0, None),
                "push": tv.encode(tv.PUSH, 0, g,
                                  extra={"pseq": 2, "pnonce": "inc"}),
                "pull": tv.encode(tv.PULL, 0, None),
                "push_pull": tv.encode(tv.PUSH_PULL, 0, g,
                                       extra={"pseq": 3, "pnonce": "inc"}),
            }
            out, refusals = {}, {}
            for name, payload in frames.items():
                reply = _request(svc.port, payload)
                kind, _, _, extra = tv.decode(memoryview(reply))
                if name == "read":
                    assert reply == miss  # the cached bytes, natively
                    extra = None
                if kind == tv.ERR:
                    refusals[name] = reply
                out[name] = (kind, extra)
            assert svc._engine.version == 1  # nothing got through
            return out, refusals, hook.refused
        finally:
            svc.stop()
    finally:
        shutdown()


def test_blackhole_on_the_native_loop_matches_the_reference(monkeypatch):
    monkeypatch.setenv("PS_PUSH_NATIVE_ADMIT", "on")
    port = _native_hole(reference=False)
    ref = _native_hole(reference=True)
    assert port == ref
    out, refusals, refused = port
    # the loop answers a replay's ack and a cached READ itself...
    assert out["replay"] == (tv.OK, {"version": 1, "dedup": True})
    assert out["read"] == (tv.OK, None)
    # ...and the frames that reach _dispatch meet the hole
    assert sorted(refusals) == ["pull", "push", "push_pull"]
    for name in refusals:
        kind, extra = out[name]
        assert kind == tv.ERR and extra["backup"] is True
    assert refused == 3


# -- RESEED onto a spare booted on placeholder params -------------------------


def _row_of(svc, k):
    """Key ``k``'s row as a move ships it, in either package: the param,
    the optimizer state under the reference's leaf paths, the apply count,
    as bytes."""
    with svc._engine._lock:
        r = svc._engine.export_keys([k])[k]
    return (np.asarray(r["param"]).tobytes(),
            {p: np.asarray(v).tobytes() for p, v in r["state"].items()},
            int(r["apply_count"]))


@pytest.mark.parametrize("port_primary", [True, False],
                         ids=["port-to-reference", "reference-to-port"])
def test_reseed_onto_a_placeholder_spare_across_packages(port_primary):
    """A spare boots on placeholder params (another key set, as the soak's
    does); RESEED ships the primary's rows under the reference's leaf
    paths, the spare evicts its placeholders and adopts the seed's keys,
    shard and ledger, then follows the stream: bitwise params, momentum
    and apply counts, in both directions between the packages."""
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import AsyncPSService as RefService
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    tree = port_member.make_tree({"w0": 48, "w1": 16}, seed=4)
    ph = port_member.make_tree({"ph": 64}, seed=3)
    ps_tpu.init(backend="tpu", mode="async", num_workers=1, dc_lambda=0.0)
    _init()

    def ref_store(params):
        st = ps_tpu.KVStore(optimizer="momentum", learning_rate=0.125,
                            mode="async")
        st.init({k: jnp.asarray(v) for k, v in params.items()})
        return st

    def port_store(params):
        st = ps_tpu_torch.KVStore(optimizer="momentum", learning_rate=0.125,
                                  mode="async")
        st.init(_like(params))
        return st

    prim = spare = w = None
    try:
        if port_primary:
            prim = AsyncPSService(port_store(tree))
            spare = RefService(ref_store(ph), backup=True)
            w = connect_async(f"127.0.0.1:{prim.port}", 0, _like(tree))
            grads = _full(tree, 0.5)
        else:
            prim = RefService(ref_store(tree))
            spare = AsyncPSService(port_store(ph), backup=True)
            w = ref_connect(f"127.0.0.1:{prim.port}", 0,
                            {k: jnp.asarray(v) for k, v in tree.items()})
            grads = {k: jnp.full(v.shape, 0.5, jnp.float32)
                     for k, v in tree.items()}
        w.pull_all()
        for _ in range(3):
            w.push_pull(grads)
        ch = tv.Channel.connect("127.0.0.1", prim.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.RESEED, 0, None,
                extra={"spare": f"127.0.0.1:{spare.port}"})))
        finally:
            ch.close()
        assert kind == tv.OK and extra["keys"] == 2, extra

        def same(what):
            assert sorted(spare._engine._params) == sorted(tree), what
            assert spare._key_order == sorted(tree), what
            for k in tree:
                got, want = _row_of(spare, k), _row_of(prim, k)
                assert got[1] and got == want, (what, k)

        same("seeded")
        for _ in range(2):  # the stream the seed's attach opened
            w.push_pull(grads)
        assert prim._engine.apply_count["w0"] == 5
        same("followed")
    finally:
        for closer in (lambda: w.close(), lambda: spare.stop(),
                       lambda: prim.stop()):
            try:
                closer()
            except Exception:
                pass
        ps_tpu.shutdown()
