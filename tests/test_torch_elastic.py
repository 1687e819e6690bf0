"""The port's elastic membership (``ps_tpu_torch/elastic/``) on port
services, held to the reference's ``tests/test_elastic.py``.

- The pure parts against the reference on the same inputs, made from a
  seed with numpy: ``ShardTable``'s wire dict and its validation error,
  ``plan_moves`` (drain first, then greedy, deterministic) and ``skew``,
  the ``Config`` elastic knobs from the environment and their errors.
- The heartbeat monitor's whole view (each peer's state and last-beat
  age, 'left' after a goodbye), which the coordinator's liveness reads.
- Every case of the reference's file on port shards and workers, in
  process on the CPU: joins, reports and liveness; the unique-ownership
  refusal; a worker joining through the coordinator; 2 -> 4 -> 2 under a
  concurrent pusher and a bucketed pusher racing repeated flips, each
  key's apply count equal to the pushes sent (exactly once); the MNIST
  MLP with momentum rebalanced mid-run, its losses bitwise an
  unrebalanced run's; a move carrying optimizer state and dedup tokens
  (a replayed pre-move push acked at the recipient, unapplied; the donor
  refusing 'moved' with the table epoch); an aborted move leaving table
  and donor intact and its flight events dumped; a join during a move on
  its own epoch; a re-asked MIGRATE_COMMIT and MIGRATE_OUT acked; a
  straddling replay replicated as a subtree; a refused MIGRATE_OUT
  keeping static semantics; a restart on the same URI with a fresh
  heartbeat identity; the table re-route timing out typed within its
  deadline; a static worker surfacing 'moved' hard.
- One case the reference lacks: a pull between a move's snapshot and its
  cutover reaches the recipient (the puller's stale snapshot, which the
  DC correction reads, is part of the moving rows).

Tolerance: exact (equal counts, bitwise parameters and losses).
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch import obs
from ps_tpu_torch.backends.common import TableMovedError
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.config import Config
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.control.heartbeat import HeartbeatClient, HeartbeatServer
from ps_tpu_torch.elastic import (Coordinator, ShardTable, fetch_table,
                                  fetch_view, plan_moves,
                                  request_rebalance, skew)


@pytest.fixture(autouse=True)
def port_async():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                      num_workers=1, dc_lambda=0.0)
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _params(n=8, seed=0, shape=(16, 8)):
    rng = np.random.default_rng(seed)
    return {f"p{i}/w": torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32)) for i in range(n)}


def _mkstore(params, lr=0.1, optimizer="sgd"):
    st = ps_tpu_torch.KVStore(optimizer=optimizer, learning_rate=lr,
                              mode="async")
    st.init(params)
    return st


def _subset(params, keys):
    return {k: params[k] for k in keys}


def _coord():
    coord = Coordinator(bind="127.0.0.1")
    return coord, f"127.0.0.1:{coord.port}"


def _applies(svcs, k):
    return sum(s._engine.apply_count.get(k, 0) for s in svcs
               if k in s._engine._params)


# -- the pure parts, against the reference ----------------------------------------


def test_shard_table_wire_roundtrip_and_validation():
    from ps_tpu.elastic import ShardTable as RefTable

    t = ShardTable(3, ["h0:1", "h1:2|h2:3"], {"a": 0, "b": 1, "c": 1})
    r = RefTable(3, ["h0:1", "h1:2|h2:3"], {"a": 0, "b": 1, "c": 1})
    assert t.to_wire() == r.to_wire()
    t2 = ShardTable.from_wire(json.loads(json.dumps(r.to_wire())))
    assert (t2.epoch, t2.shards, t2.assign) == (3, t.shards, t.assign)
    assert t.keys_of(1) == r.keys_of(1) == ["b", "c"]
    assert t.covers(["a", "b"]) and not t.covers(["a", "z"])
    assert t.addrs() == r.addrs() == [("h0", 1), ("h1", 2)]
    assert t.replica_sets() == r.replica_sets()
    assert t.owner_map() == r.owner_map() and repr(t) == repr(r)
    errs = []
    for cls in (ShardTable, RefTable):
        with pytest.raises(ValueError, match="only 1 shard") as e:
            cls(0, ["h0:1"], {"a": 1})
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_plan_moves_and_skew_equal_the_reference():
    """Seeded random fleets (sizes, assignments, drains, move budgets):
    the same moves as the reference's planner, drained keys first; the
    same skew, inf for an empty shard."""
    from ps_tpu.elastic import plan_moves as ref_plan
    from ps_tpu.elastic import skew as ref_skew

    rng = np.random.default_rng(4)
    for trial in range(40):
        nkeys = int(rng.integers(1, 30))
        nshards = int(rng.integers(1, 6))
        key_bytes = {f"k{i}": int(rng.integers(1, 10_000))
                     for i in range(nkeys)}
        assign = {k: int(rng.integers(0, nshards)) for k in key_bytes}
        targets = sorted(set(int(t) for t in rng.integers(
            0, nshards + 1, size=int(rng.integers(1, nshards + 2)))))
        budget = None if trial % 3 else int(rng.integers(0, 5))
        got = plan_moves(key_bytes, assign, targets, max_moves=budget)
        assert got == ref_plan(key_bytes, assign, targets,
                               max_moves=budget)
        drained = [k for k, s in assign.items() if s not in targets]
        moved = {k for _d, _r, ks in got for k in ks}
        assert set(drained) <= moved
        loads = {s: sum(b for k, b in key_bytes.items() if assign[k] == s)
                 for s in range(nshards)}
        assert skew(loads) == ref_skew(loads)
    assert skew({0: 100, 1: 0}) == float("inf") and skew({}) == 1.0
    with pytest.raises(ValueError, match="at least one target"):
        plan_moves({"a": 1}, {"a": 0}, [])


def test_config_elastic_knobs_and_env(monkeypatch):
    from ps_tpu.config import Config as RefConfig

    c = Config()
    assert c.coord_uri is None and c.rebalance_auto is False
    assert c.rebalance_max_skew == 2.0 and c.rebalance_report_ms == 1000
    monkeypatch.setenv("PS_COORD_URI", "10.0.0.1:7070")
    monkeypatch.setenv("PS_REBALANCE_AUTO", "1")
    monkeypatch.setenv("PS_REBALANCE_MAX_SKEW", "3.5")
    monkeypatch.setenv("PS_REBALANCE_REPORT_MS", "250")
    monkeypatch.setenv("PS_POLICY", "dry")
    monkeypatch.setenv("PS_POLICY_COOLDOWN_S", "7.5")
    monkeypatch.setenv("PS_POLICY_BURN_WINDOWS", "4")
    fields = ("coord_uri", "rebalance_auto", "rebalance_max_skew",
              "rebalance_report_ms", "policy", "policy_cooldown_s",
              "policy_burn_windows")
    port, ref = Config.from_env(), RefConfig.from_env()
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields] == \
        ["10.0.0.1:7070", True, 3.5, 250, "dry", 7.5, 4]
    monkeypatch.setenv("PS_COORD_URI", "")  # "": explicitly static
    assert Config.from_env().coord_uri is None
    for cls in (Config, RefConfig):
        with pytest.raises(ValueError, match="rebalance_max_skew"):
            cls(rebalance_max_skew=0.5)
        with pytest.raises(ValueError, match="rebalance_report_ms"):
            cls(rebalance_report_ms=0)


# -- the heartbeat monitor's view -----------------------------------------------


def test_heartbeat_state_view_exposes_last_beat_ages():
    srv = HeartbeatServer(port=0, timeout_ms=30_000)
    c1 = HeartbeatClient("127.0.0.1", srv.port, node_id=1, interval_ms=20)
    c2 = HeartbeatClient("127.0.0.1", srv.port, node_id=2, interval_ms=20)
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not {1, 2} <= set(srv.state()):
            time.sleep(0.02)
        view = srv.state()
        for n in (1, 2):
            assert view[n]["state"] == "alive" and view[n]["seq"] >= 1
            assert isinstance(view[n]["age_ms"], int)
            assert 0 <= view[n]["age_ms"] < 30_000
        assert srv.state(1) == "alive" and srv.state(99) == "unseen"
        assert srv.age_ms(99) is None
        c1.close(goodbye=True)
        deadline = time.monotonic() + 5
        while srv.state(1) != "left" and time.monotonic() < deadline:
            time.sleep(0.02)
        view = srv.state()
        assert view[1]["state"] == "left" and view[2]["state"] == "alive"
    finally:
        c2.close(goodbye=False)
        srv.close()


# -- membership -----------------------------------------------------------------


def test_coordinator_join_report_and_liveness_view():
    params = _params()
    keys = sorted(params)
    coord, ca = _coord()
    s0 = AsyncPSService(_mkstore(_subset(params, keys[:4])), coordinator=ca)
    s1 = AsyncPSService(_mkstore(_subset(params, keys[4:])), coordinator=ca)
    try:
        table = coord.table()
        assert table.epoch == 2 and len(table.shards) == 2
        assert table.keys_of(0) == keys[:4] and table.keys_of(1) == keys[4:]
        assert s0.table_epoch == 1 and s1.table_epoch == 2
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ms = fetch_view(ca)["members"]
            if all(m["report"].get("keys") is not None
                   and m["hb_state"] == "alive" for m in ms):
                break
            time.sleep(0.05)
        assert [m["shard"] for m in ms] == [0, 1]
        assert all(m["kind"] == "dense" and m["hb_state"] == "alive"
                   and isinstance(m["hb_age_ms"], int)
                   and m["report"]["keys"] == 4 and m["nbytes"] > 0
                   for m in ms)
        t = fetch_table(ca, cover=keys)
        assert t.covers(keys)
        with pytest.raises(TimeoutError):
            fetch_table(ca, min_epoch=t.epoch, timeout=0.3)
        s1.stop()  # a clean stop is a goodbye: 'left'
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            ms = fetch_view(ca)["members"]
            if ms[1]["hb_state"] == "left":
                break
            time.sleep(0.05)
        assert ms[1]["hb_state"] == "left"
    finally:
        s0.stop()
        s1.stop()
        coord.stop()


def test_join_refuses_already_claimed_keys():
    params = _params(n=4)
    coord, ca = _coord()
    s0 = AsyncPSService(_mkstore(params), coordinator=ca)
    try:
        with pytest.raises(RuntimeError, match="already assigned"):
            AsyncPSService(_mkstore(params), coordinator=ca)
        assert len(coord.table().shards) == 1
        with pytest.raises(ValueError, match="not both"):
            AsyncPSService(_mkstore(params), shard=0, num_shards=1,
                           coordinator=ca)
    finally:
        s0.stop()
        coord.stop()


def test_worker_joins_via_coordinator_and_trains():
    params = _params()
    keys = sorted(params)
    coord, ca = _coord()
    s0 = AsyncPSService(_mkstore(_subset(params, keys[:4])), coordinator=ca)
    s1 = AsyncPSService(_mkstore(_subset(params, keys[4:])), coordinator=ca)
    w = connect_async(None, 0, params, coordinator=ca)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
        for _ in range(3):
            w.push_pull(grads)
        assert s0._engine.version == 3 and s1._engine.version == 3
        assert w._table.epoch == 2 and w._tel_reporter is not None
        with pytest.raises(ValueError, match="server uri or a"):
            connect_async(None, 0, params)
    finally:
        w.close()
        s0.stop()
        s1.stop()
        coord.stop()


# -- live moves -----------------------------------------------------------------


def _hammer(w, grads, stop, pushed, errs):
    try:
        while not stop.is_set():
            w.push_pull(grads)
            pushed[0] += 1
    except BaseException as e:  # surfaced by the caller
        errs.append(e)


def test_live_split_and_drain_under_traffic_exactly_once():
    """2 shards grow to 4 and shrink back to 2 under a pusher: every
    key's apply count over the fleet equals the pushes, the flight log
    and the ps_event_* counters narrate the moves."""
    params = _params(n=8)
    keys = sorted(params)
    fr = obs.flight()
    n0 = fr.total
    coord, ca = _coord()
    svcs = [AsyncPSService(_mkstore(_subset(params, keys[:4])),
                           coordinator=ca),
            AsyncPSService(_mkstore(_subset(params, keys[4:])),
                           coordinator=ca)]
    w = connect_async(None, 0, params, coordinator=ca, failover_timeout=30.0)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
        stop, pushed, errs = threading.Event(), [0], []
        t = threading.Thread(target=_hammer,
                             args=(w, grads, stop, pushed, errs))
        t.start()
        try:
            time.sleep(0.2)
            svcs += [AsyncPSService(_mkstore({}), coordinator=ca)
                     for _ in range(2)]
            out = request_rebalance(ca, targets=[0, 1, 2, 3])
            assert out["moves"]
            split_epoch = out["epoch"]
            time.sleep(0.3)
            out = request_rebalance(ca, drain=[2, 3])
            assert out["epoch"] > split_epoch
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not errs, f"pusher died during the drill: {errs[0]!r}"
        assert pushed[0] > 0
        for k in keys:
            assert _applies(svcs, k) == pushed[0], k
        table = coord.table()
        assert len(table.shards) == 2 and sorted(table.assign) == keys
        assert w.transport.table_reroutes >= 1
        kinds = [e["kind"] for e in fr.events()[-(fr.total - n0):]]
        assert {"rebalance_start", "rebalance_commit",
                "table_reroute"} <= set(kinds)
        text = obs.default_registry().render_prometheus()
        assert "ps_event_rebalance_commit_total" in text
        assert "ps_rebalance_moves_total" in text
        assert coord.moves_done >= 2
        assert all(m["snapshot_s"] >= m["copy_s"] >= 0
                   for s in svcs for m in s.migrations)
    finally:
        w.close()
        for s in svcs:
            s.stop()
        coord.stop()


def test_bucketed_pusher_races_table_flip_replays_exactly_once():
    """A multi-bucket pusher races repeated flips (2 -> 3 -> 2, twice): a
    push cut mid-stream by a cutover replays whole under its token, and
    per-key dedup applies only the owed keys, once each."""
    params = _params(n=8)
    keys = sorted(params)
    coord, ca = _coord()
    svcs = [AsyncPSService(_mkstore(_subset(params, keys[:4])),
                           coordinator=ca),
            AsyncPSService(_mkstore(_subset(params, keys[4:])),
                           coordinator=ca)]
    w = connect_async(None, 0, params, coordinator=ca, bucket_bytes=1 << 10,
                      pool_size=2, failover_timeout=30.0)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
        stop, pushed, errs = threading.Event(), [0], []
        t = threading.Thread(target=_hammer,
                             args=(w, grads, stop, pushed, errs))
        t.start()
        try:
            time.sleep(0.2)
            svcs.append(AsyncPSService(_mkstore({}), coordinator=ca))
            for _ in range(2):
                request_rebalance(ca, targets=[0, 1, 2])
                time.sleep(0.2)
                request_rebalance(ca, targets=[0, 1])
                time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not errs, f"pusher died during the flips: {errs[0]!r}"
        assert pushed[0] > 0 and w.transport.table_reroutes >= 1
        for k in keys:
            assert _applies(svcs, k) == pushed[0], k
    finally:
        w.close()
        for s in svcs:
            s.stop()
        coord.stop()


def test_rebalance_drill_mnist_loss_parity_with_momentum():
    """The MNIST MLP rebalanced 2 -> 4 -> 2 mid-run: the losses are
    bitwise an unrebalanced run's (momentum: the state travels with the
    row, a reset trace would show)."""
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.kv.store import value_and_grad

    params0, loss_fn = build(0, "cpu")
    kv, _ = keymod.flatten_with_keys(params0)
    keys = sorted(kv)
    steps, bs = 8, 32

    def run(rebalance):
        coord, ca = _coord()
        half = len(keys) // 2
        svcs = [AsyncPSService(_mkstore(_subset(kv, keys[:half]),
                                        optimizer="momentum"),
                               coordinator=ca),
                AsyncPSService(_mkstore(_subset(kv, keys[half:]),
                                        optimizer="momentum"),
                               coordinator=ca)]
        w = connect_async(None, 0, params0, coordinator=ca,
                          failover_timeout=30.0)
        losses = []
        try:
            p = w.pull_all()
            for step, batch in enumerate(mnist_batches(bs, steps=steps,
                                                       seed=1)):
                if rebalance and step == 3:
                    svcs += [AsyncPSService(_mkstore(
                        {}, optimizer="momentum"), coordinator=ca)
                        for _ in range(2)]
                    request_rebalance(ca, targets=[0, 1, 2, 3])
                if rebalance and step == 6:
                    request_rebalance(ca, drain=[2, 3])
                batch = tuple(torch.as_tensor(x) for x in batch)
                loss, g, _ = value_and_grad(loss_fn, p, batch)
                losses.append(float(loss))
                p = w.push_pull(g)
            if rebalance:
                assert w.transport.table_reroutes >= 1
        finally:
            w.close()
            for s in svcs:
                s.stop()
            coord.stop()
        return losses

    ref = run(False)
    assert run(True) == ref


def test_migration_moves_optimizer_state_and_dedup_tokens():
    """A move lands the rows bitwise (momentum state under its reference
    leaf path, apply counts); a replay of a pre-move push at the
    recipient is acked unapplied; a new push of the moved range at the
    donor is the typed 'moved' refusal with the table epoch; the worker
    rides it end to end."""
    params = _params(n=4)
    keys = sorted(params)
    coord, ca = _coord()
    donor = AsyncPSService(_mkstore(params, optimizer="momentum"),
                           coordinator=ca)
    recip = AsyncPSService(_mkstore({}, optimizer="momentum"),
                           coordinator=ca)
    w = connect_async(None, 0, params, coordinator=ca, failover_timeout=30.0)
    try:
        w.pull_all()
        grads = {k: torch.full_like(v, 0.1) for k, v in params.items()}
        w.push_all(grads)  # pseq 1, applied at the donor
        nonce = w._transport_nonce
        with donor._engine._lock:
            before = donor._engine.export_keys(keys[:2])
        moved = keys[:2]
        out = request_rebalance(ca, moves=[[0, 1, moved]])
        assert out["moved_bytes"] > 0
        with recip._engine._lock:
            after = recip._engine.export_keys(moved)
        for k in moved:
            np.testing.assert_array_equal(after[k]["param"],
                                          before[k]["param"])
            assert sorted(after[k]["state"]) == ["0/trace"]
            np.testing.assert_array_equal(after[k]["state"]["0/trace"],
                                          before[k]["state"]["0/trace"])
            np.testing.assert_array_equal(after[k]["stale"][0],
                                          before[k]["stale"][0])
            assert recip._engine.apply_count[k] == 1
        sub = {k: np.full(tuple(params[k].shape), 0.1, np.float32)
               for k in moved}
        ch = tv.Channel.connect("127.0.0.1", recip.port)
        ch2 = tv.Channel.connect("127.0.0.1", donor.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.PUSH, 0, sub, extra={"pseq": 1, "pnonce": nonce})))
            assert kind == tv.OK and extra["dedup"] is True
            assert all(recip._engine.apply_count[k] == 1 for k in moved)
            kind, _, _, extra = tv.decode(ch2.request(tv.encode(
                tv.PUSH, 0, sub, extra={"pseq": 2, "pnonce": nonce})))
            assert kind == tv.ERR and extra["moved"] is True
            assert extra["table_epoch"] >= out["epoch"]
            _, _, _, st = tv.decode(ch2.request(tv.encode(tv.STATS, 0,
                                                          None)))
            assert st["keys_moved"] == 2
            assert st["table_epoch"] >= out["epoch"]
        finally:
            ch.close()
            ch2.close()
        w.push_all(grads)
        for k in keys:
            assert _applies((donor, recip), k) == 2
    finally:
        w.close()
        donor.stop()
        recip.stop()
        coord.stop()


def test_aborted_move_leaves_donor_intact_and_dumps_events(tmp_path):
    params = _params(n=4)
    fr = obs.flight()
    coord, ca = _coord()
    s0 = AsyncPSService(_mkstore(params), coordinator=ca)
    w = connect_async(None, 0, params, coordinator=ca)
    try:
        w.pull_all()
        epoch0 = coord.table().epoch
        t0 = coord.table()
        with coord._tlock:
            coord._table = ShardTable(epoch0, t0.shards + ["127.0.0.1:9"],
                                      t0.assign)
            coord._members.append(type(coord._members[0])(
                "127.0.0.1:9", 999, "dense"))
        with pytest.raises(RuntimeError, match="refused the move"):
            coord.rebalance(moves=[[0, 1, sorted(params)[:2]]])
        assert coord.table().epoch == epoch0
        w.push_pull({k: torch.full_like(v, 0.1) for k, v in params.items()})
        assert s0._engine.version == 1
        kinds = [e["kind"] for e in fr.events()]
        assert {"rebalance_start", "rebalance_abort",
                "coord_elect"} <= set(kinds)
        text = obs.default_registry().render_prometheus()
        for name in ("ps_event_rebalance_abort_total",
                     "ps_event_coord_elect_total",
                     "ps_rebalance_aborts_total"):
            assert name in text
        path = fr.dump("abort drill", path=str(tmp_path / "flight.jsonl"))
        dumped = {json.loads(ln).get("kind")
                  for ln in open(path).read().splitlines() if ln}
        assert {"rebalance_start", "rebalance_abort"} <= dumped
    finally:
        w.close()
        s0.stop()
        coord.stop()


def test_concurrent_join_never_collides_with_move_epoch():
    params = _params(n=8, shape=(128, 128))
    keys = sorted(params)
    coord, ca = _coord()
    donor = AsyncPSService(_mkstore(params), coordinator=ca)
    recip = AsyncPSService(_mkstore({}), coordinator=ca)
    epochs, late, stop = [], [], threading.Event()

    def watch():
        while not stop.is_set():
            epochs.append(coord.table().epoch)
            time.sleep(0.002)

    def join_late():
        time.sleep(0.03)  # inside the move's streaming window
        late.append(AsyncPSService(_mkstore({}), coordinator=ca))

    tw, tj = threading.Thread(target=watch), threading.Thread(target=join_late)
    tw.start()
    tj.start()
    try:
        out = coord.rebalance(moves=[[0, 1, keys[:4]]])
    finally:
        tj.join(timeout=30)
        stop.set()
        tw.join(timeout=10)
    try:
        assert late
        assert all(b >= a for a, b in zip(epochs, epochs[1:])), epochs
        table = coord.table()
        assert out["epoch"] <= table.epoch <= out["epoch"] + 1
        assert len(table.shards) == 3 and table.keys_of(1) == keys[:4]
    finally:
        donor.stop()
        recip.stop()
        for s in late:
            s.stop()
        coord.stop()


def test_migrate_commit_reask_is_idempotent():
    params = _params(n=4)
    keys = sorted(params)
    coord, ca = _coord()
    donor = AsyncPSService(_mkstore(params), coordinator=ca)
    recip = AsyncPSService(_mkstore({}), coordinator=ca)
    try:
        moved = keys[:2]
        out = request_rebalance(ca, moves=[[0, 1, moved]])
        ch = tv.Channel.connect("127.0.0.1", recip.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.MIGRATE_COMMIT, 0, None,
                extra={"keys": moved, "table_epoch": out["epoch"]})))
            assert kind == tv.OK and extra["keys"] == moved
            assert all(recip._engine.apply_count.get(k, 0) == 0
                       for k in moved)
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.MIGRATE_COMMIT, 0, None,
                extra={"keys": keys[2:], "table_epoch": 99})))
            assert kind == tv.ERR and "staged intake" in extra["error"]
        finally:
            ch.close()
        ch = tv.Channel.connect("127.0.0.1", donor.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.MIGRATE_OUT, 0, None, extra={
                    "keys": moved, "target": f"127.0.0.1:{recip.port}",
                    "table_epoch": out["epoch"]})))
            assert kind == tv.OK and extra["keys"] == moved
            assert extra["rows"] >= len(moved)
            assert len(donor.migrations) == 1  # a receipt, not a re-run
        finally:
            ch.close()
    finally:
        donor.stop()
        recip.stop()
        coord.stop()


def test_straddling_replay_replicates_as_subtree():
    """A replay owed only some keys applies them (a partial apply in the
    elastic log) and replicates as push_sub: the backup mirrors the subset
    instead of degrading, bitwise."""
    params = _params(n=4)
    keys = sorted(params)
    prim = AsyncPSService(_mkstore(params))
    back = AsyncPSService(_mkstore(params), backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    w = connect_async(f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}", 0,
                      params)
    try:
        w.pull_all()
        w.push_all({k: torch.full_like(v, 0.1) for k, v in params.items()})
        nonce = w._transport_nonce
        with prim._engine._lock:
            for k in keys[:2]:
                del prim._applied_pseq[0][k]
        sub = {k: np.full(tuple(params[k].shape), 0.1, np.float32)
               for k in params}
        ch = tv.Channel.connect("127.0.0.1", prim.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.PUSH, 0, sub, extra={"pseq": 1, "pnonce": nonce})))
            assert kind == tv.OK
        finally:
            ch.close()
        for svc in (prim, back):
            assert all(svc._engine.apply_count[k] == 2 for k in keys[:2])
            assert all(svc._engine.apply_count[k] == 1 for k in keys[2:])
        sess = prim._backup_session
        assert sess is not None and not sess.degraded
        assert [(e["op"], e["keys"]) for e in prim.elastic_log] == \
            [("push_sub", keys[:2])]
        assert list(back.event_log)[-1] == ["push_sub", 0]
        for k in keys:
            assert torch.equal(prim._engine._params[k],
                               back._engine._params[k])
    finally:
        w.close()
        prim.stop()
        back.stop()


def test_refused_migrate_out_keeps_static_semantics():
    params = _params(n=4)
    keys = sorted(params)
    svc = AsyncPSService(_mkstore(params))
    other = AsyncPSService(_mkstore({}))
    try:
        ch = tv.Channel.connect("127.0.0.1", svc.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.MIGRATE_OUT, 0, None, extra={
                    "keys": ["nope/w"], "target": f"127.0.0.1:{other.port}",
                    "table_epoch": 1})))
            assert kind == tv.ERR and "does not own" in extra["error"]
            sub = {keys[0]: np.zeros(tuple(params[keys[0]].shape),
                                     np.float32)}
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.PUSH, 0, sub)))
            assert kind == tv.ERR and not extra.get("moved")
            assert "KeyError" in extra["error"]
        finally:
            ch.close()
    finally:
        svc.stop()
        other.stop()


def test_same_uri_restart_gets_fresh_heartbeat_identity():
    params = _params(n=4)
    coord, ca = _coord()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    s0 = AsyncPSService(_mkstore(params), port=port, coordinator=ca)
    node0 = s0._coord_member.node
    epoch0 = coord.table().epoch
    s0.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if fetch_view(ca)["members"][0]["hb_state"] == "left":
            break
        time.sleep(0.05)
    s0b = AsyncPSService(_mkstore(params), port=port, coordinator=ca)
    try:
        assert s0b._coord_member.node != node0
        assert coord.table().epoch == epoch0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            view = fetch_view(ca)["members"][0]
            if view["hb_state"] == "alive":
                break
            time.sleep(0.05)
        assert view["hb_state"] == "alive", view
        with pytest.raises(RuntimeError, match="already assigned"):
            AsyncPSService(_mkstore(params), coordinator=ca)
    finally:
        s0b.stop()
        coord.stop()


def test_table_reroute_timeout_stays_typed_within_deadline(monkeypatch):
    import ps_tpu_torch.elastic.member as member_mod

    params = _params(n=2)
    coord, ca = _coord()
    svc = AsyncPSService(_mkstore(params), coordinator=ca)
    w = connect_async(None, 0, params, coordinator=ca)
    try:
        calls = [0]

        def stalled(*a, **kw):
            calls[0] += 1
            time.sleep(0.05)
            raise TimeoutError("publish lagging")

        monkeypatch.setattr(member_mod, "fetch_table", stalled)
        err = TableMovedError("shard says moved", server=0, table_epoch=9)
        t0 = time.monotonic()
        with pytest.raises(TableMovedError, match="never converged"):
            w._on_table_moved(err, deadline=time.monotonic() + 1.0)
        dt = time.monotonic() - t0
        assert calls[0] >= 2 and 0.9 <= dt < 5.0, (calls, dt)
    finally:
        w.close()
        svc.stop()
        coord.stop()


def test_static_worker_surfaces_moved_refusal_hard():
    params = _params(n=2)
    svc = AsyncPSService(_mkstore(params))
    w = connect_async(f"127.0.0.1:{svc.port}", 0, params)
    try:
        err = TableMovedError("shard says moved", server=0, table_epoch=3)
        with pytest.raises(TableMovedError, match="no coordinator"):
            w._on_table_moved(err, deadline=time.monotonic() + 1)
        assert "PS_COORD_URI" in str(
            pytest.raises(TableMovedError, w._on_table_moved, err,
                          time.monotonic() + 1).value)
    finally:
        w.close()
        svc.stop()


def test_pull_during_a_move_streams_the_new_stale_snapshot(monkeypatch):
    """A pull between a move's snapshot and its cutover changes the
    puller's stale snapshot of the moving keys (the DC correction's
    baseline, part of their rows): the rows are streamed again, so the
    recipient holds the snapshot the donor held at the cutover and the
    next push is corrected against it (the reference streams rows on
    commits only, which its drill at λ = 0 cannot show)."""
    from ps_tpu_torch.elastic import migrate

    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                      num_workers=2, dc_lambda=0.04)
    params = _params(n=2)
    keys = sorted(params)
    coord, ca = _coord()
    donor = AsyncPSService(_mkstore(params, optimizer="momentum"),
                           coordinator=ca)
    recip = AsyncPSService(_mkstore({}, optimizer="momentum"),
                           coordinator=ca)
    ws = [connect_async(None, w, params, coordinator=ca,
                        failover_timeout=30.0) for w in range(2)]
    held, release = threading.Event(), threading.Event()
    orig = migrate.MigrationSession.wait_drained
    calls = []

    def wait_drained(self, timeout=None):
        calls.append(1)
        if len(calls) == 1:  # the catch-up, outside the donor's lock
            held.set()
            release.wait(10)
        return orig(self, timeout)

    monkeypatch.setattr(migrate.MigrationSession, "wait_drained",
                        wait_drained)
    try:
        for w in ws:
            w.pull_all()
        ws[1].push_all({k: torch.full_like(v, 0.5)
                        for k, v in params.items()})
        out = {}
        t = threading.Thread(target=lambda: out.update(
            request_rebalance(ca, moves=[[0, 1, keys[:1]]])))
        t.start()
        assert held.wait(10)
        ws[0].pull_all()  # worker 0's snapshot moves to the new params
        release.set()
        t.join(timeout=30)
        assert out["moves"]
        k = keys[0]
        eng = recip._engine
        assert torch.equal(eng._stale[(0, k)], eng._params[k])
        with donor._engine._lock:
            kept = donor._engine._stale[(0, keys[1])]
        assert torch.equal(kept, donor._engine._params[keys[1]])
    finally:
        release.set()
        for w in ws:
            w.close()
        donor.stop()
        recip.stop()
        coord.stop()
