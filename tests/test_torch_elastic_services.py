"""Elastic membership across the two packages, live services in process on
the CPU: the port's coordinator, shards, workers, aggregator and sparse
members against the reference's (``ps_tpu/elastic``, its services on
``backend="tpu"`` over the CPU).

- A reference coordinator drives port shards and a port coordinator
  drives reference shards: joins, a port worker and a reference worker
  training through the table, a split and a drain under traffic, every
  key's apply count equal to the pushes sent (exactly once).
- A key move from a port donor to a reference recipient, and the
  reverse, lands the rows bitwise: the parameter, the momentum state
  under the reference's leaf path (``0/trace``), every worker's stale
  snapshot and the apply count; the dedup tokens travel, so a replayed
  pre-move push is acked at the recipient unapplied.
- The reference's aggregator cases on port services: an aggregator
  registered for its host is found by the workers through the table
  (``test_coordinator_assigns_host_group``), and a stale entry sends a
  new worker to the flat path
  (``test_stale_discovered_aggregator_falls_back_to_flat``).
- Sparse members: port members join, workers find the row partition
  (also on a coordinator shared with a dense fleet), a range move is
  refused with the typed message, a replacement restored on another port
  takes the slot over and the worker re-discovers it. R1 blocks the
  reference's sparse tables on this jax, so the reference's sparse side
  runs over the ``_RefTable`` shim of ``tests/test_torch_remote_sparse.py``:
  reference members on a port coordinator and port members on a
  reference coordinator, each served to the other package's worker.
- The unchanged ``tools/ps_top.py --coord ... --once --json``,
  ``tools/ps_top.py --fleet --coord ...`` and ``tools/ps_doctor.py
  --coord ... --json`` against a port coordinator give the keys they give
  against a reference one.

Tolerance: exact; the sparse tables over the shim as
``test_torch_remote_sparse.py`` holds them (sgd bitwise, adagrad within
RTOL/ATOL).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.aggregator import AggregatorService
from ps_tpu_torch.backends.remote_async import AsyncPSService, connect_async
from ps_tpu_torch.backends.remote_sparse import (SparsePSService,
                                                 connect_sparse, row_range)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.elastic import (Coordinator, fetch_view,
                                  request_rebalance)
from tests import test_torch_remote_sparse as sparse_tests
from tests import test_torch_van_harness as harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _tree(n=6, seed=0, shape=(16, 8)):
    rng = np.random.default_rng(seed)
    return {f"p{i}/w": rng.normal(0, 1, shape).astype(np.float32)
            for i in range(n)}


class _Port:
    """The port's side: init, a store, a service, a worker."""
    name = "port"

    @staticmethod
    def init(num_workers=2):
        ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                          num_workers=num_workers, dc_lambda=0.0)

    @staticmethod
    def store(tree, optimizer="momentum"):
        st = ps_tpu_torch.KVStore(optimizer=optimizer, learning_rate=0.1,
                                  mode="async")
        st.init({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
        return st

    service, connect = AsyncPSService, connect_async
    Coordinator = Coordinator

    @staticmethod
    def like(tree):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}

    @staticmethod
    def host(v):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


class _Ref:
    """The reference's side."""
    name = "reference"

    @staticmethod
    def init(num_workers=2):
        import ps_tpu

        ps_tpu.init(backend="tpu", mode="async", num_workers=num_workers,
                    dc_lambda=0.0)

    @staticmethod
    def store(tree, optimizer="momentum"):
        import ps_tpu

        st = ps_tpu.KVStore(optimizer=optimizer, learning_rate=0.1,
                            mode="async")
        st.init({k: np.array(v) for k, v in tree.items()})
        return st

    @staticmethod
    def service(*a, **kw):
        from ps_tpu.backends.remote_async import AsyncPSService as S

        return S(*a, **kw)

    @staticmethod
    def connect(*a, **kw):
        from ps_tpu.backends.remote_async import connect_async as c

        return c(*a, **kw)

    @staticmethod
    def Coordinator(*a, **kw):
        from ps_tpu.elastic import Coordinator as C

        return C(*a, **kw)

    @staticmethod
    def like(tree):
        return {k: np.array(v) for k, v in tree.items()}

    @staticmethod
    def host(v):
        return np.asarray(v)


def _grads(tree, pkg, scale=0.01):
    return pkg.like({k: np.full(v.shape, scale, np.float32)
                     for k, v in tree.items()})


def _applies(svcs, k):
    return sum(int(s._engine.apply_count.get(k, 0)) for s in svcs
               if k in s._engine._params)


def _shutdown_ref():
    import ps_tpu

    if ps_tpu.is_initialized():
        ps_tpu.shutdown()


# -- a coordinator of one package driving shards of the other ---------------------


@pytest.mark.parametrize("coord_pkg,shard_pkg", [(_Ref, _Port), (_Port, _Ref)],
                         ids=["ref-coordinator-port-shards",
                              "port-coordinator-ref-shards"])
def test_coordinator_drives_the_other_packages_shards(coord_pkg, shard_pkg):
    """Shards join the other package's coordinator; a port worker and a
    reference worker train through the table; a split to three shards
    and a drain back to two run under both pushers; every key's apply
    count equals the pushes sent, and both workers re-routed."""
    _Port.init()
    _Ref.init()
    tree = _tree()
    keys = sorted(tree)
    coord = coord_pkg.Coordinator(bind="127.0.0.1")
    ca = f"127.0.0.1:{coord.port}"
    svcs = [shard_pkg.service(shard_pkg.store({k: tree[k] for k in ks}),
                              bind="127.0.0.1", coordinator=ca)
            for ks in (keys[:3], keys[3:])]
    workers = [(w, pkg, pkg.connect(None, w, pkg.like(tree), coordinator=ca,
                                    failover_timeout=30.0))
               for w, pkg in enumerate((_Port, _Ref))]
    try:
        for _, _, w in workers:
            w.pull_all()
        stop, errs, pushed = threading.Event(), [], [0, 0]

        def hammer(i, pkg, w):
            try:
                g = _grads(tree, pkg)
                while not stop.is_set():
                    w.push_pull(g)
                    pushed[i] += 1
            except BaseException as e:  # surfaced below
                errs.append(e)

        ts = [threading.Thread(target=hammer, args=x) for x in workers]
        for t in ts:
            t.start()
        try:
            time.sleep(0.2)
            svcs.append(shard_pkg.service(shard_pkg.store({}),
                                          bind="127.0.0.1", coordinator=ca))
            out = request_rebalance(ca, targets=[0, 1, 2])
            assert out["moves"]
            time.sleep(0.2)
            out2 = request_rebalance(ca, drain=[2])
            assert out2["epoch"] > out["epoch"]
            time.sleep(0.2)
        finally:
            stop.set()
            for t in ts:
                t.join(timeout=60)
        assert not errs, f"a pusher died: {errs[0]!r}"
        for k in keys:
            assert _applies(svcs, k) == sum(pushed), k
        assert all(w.transport.table_reroutes >= 1 for _, _, w in workers)
        table = coord.table()
        assert len(table.shards) == 2 and sorted(table.assign) == keys
    finally:
        for _, _, w in workers:
            w.close()
        for s in svcs:
            s.stop()
        coord.stop()
        _shutdown_ref()


def _rows(svc, keys, pkg):
    with svc._engine._lock:
        rows = svc._engine.export_keys(keys)
    return {k: {"param": pkg.host(r["param"]),
                "state": {p: pkg.host(v) for p, v in r["state"].items()},
                "stale": {int(w): pkg.host(v)
                          for w, v in r["stale"].items()},
                "apply_count": int(r["apply_count"])}
            for k, r in rows.items()}


@pytest.mark.parametrize("donor_pkg,recip_pkg", [(_Port, _Ref), (_Ref, _Port)],
                         ids=["port-to-ref", "ref-to-port"])
def test_move_between_packages_is_bitwise(donor_pkg, recip_pkg):
    """A move across the packages: the recipient's rows are the donor's
    at the cutover bit for bit (parameter, momentum state under the
    reference's leaf path, both workers' stale snapshots, the apply
    count); a replayed pre-move push is acked at the recipient unapplied;
    later pushes land exactly once."""
    _Port.init()
    _Ref.init()
    tree = _tree(n=4)
    keys = sorted(tree)
    coord = Coordinator(bind="127.0.0.1")
    ca = f"127.0.0.1:{coord.port}"
    donor = donor_pkg.service(donor_pkg.store(tree), bind="127.0.0.1",
                              coordinator=ca)
    recip = recip_pkg.service(recip_pkg.store({}), bind="127.0.0.1",
                              coordinator=ca)
    ws = [pkg.connect(None, w, pkg.like(tree), coordinator=ca,
                      failover_timeout=30.0)
          for w, pkg in enumerate((donor_pkg, recip_pkg))]
    try:
        for i, w in enumerate(ws):
            w.pull_all()
            w.push_pull(_grads(tree, (donor_pkg, recip_pkg)[i], 0.1))
        ws[0].push_all(_grads(tree, donor_pkg, 0.1))  # worker 0's pseq 2
        nonce = ws[0]._transport_nonce
        moved = keys[:2]
        before = _rows(donor, moved, donor_pkg)
        out = request_rebalance(ca, moves=[[0, 1, moved]])
        assert out["moved_bytes"] > 0
        after = _rows(recip, moved, recip_pkg)
        for k in moved:
            assert sorted(after[k]["state"]) == ["0/trace"]
            assert after[k]["apply_count"] == before[k]["apply_count"] == 3
            assert sorted(after[k]["stale"]) == [0, 1]
            for part in ("param",):
                np.testing.assert_array_equal(after[k][part],
                                              before[k][part])
            for p in before[k]["state"]:
                np.testing.assert_array_equal(after[k]["state"][p],
                                              before[k]["state"][p])
            for w_ in before[k]["stale"]:
                np.testing.assert_array_equal(after[k]["stale"][w_],
                                              before[k]["stale"][w_])
        sub = {k: np.full(tree[k].shape, 0.1, np.float32) for k in moved}
        ch = tv.Channel.connect("127.0.0.1", recip.port)
        try:
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.PUSH, 0, sub, extra={"pseq": 2, "pnonce": nonce})))
        finally:
            ch.close()
        assert kind == tv.OK and extra["dedup"] is True
        assert all(int(recip._engine.apply_count[k]) == 3 for k in moved)
        for i, w in enumerate(ws):
            w.push_pull(_grads(tree, (donor_pkg, recip_pkg)[i]))
        for k in keys:
            assert _applies((donor, recip), k) == 5, k
        assert ws[0].transport.table_reroutes >= 1
    finally:
        for w in ws:
            w.close()
        donor.stop()
        recip.stop()
        coord.stop()
        _shutdown_ref()


# -- the aggregator through the coordinator -----------------------------------------


def _agg_params():
    return {"a": torch.zeros(32, 16), "b": torch.ones(64)}


def test_coordinator_assigns_host_group():
    """The reference's ``test_aggregation`` case on port services: the
    aggregator registers for this host, workers given only the
    coordinator find it, and one merged round lands exactly."""
    from ps_tpu_torch.elastic.member import fetch_aggregators
    from tests.test_torch_aggregation import (FAN_IN, LR, _assert_exact,
                                              _group_rounds)

    _Port.init(num_workers=FAN_IN)
    coord = Coordinator(bind="127.0.0.1")
    curi = f"127.0.0.1:{coord.port}"
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=LR,
                                 mode="async")
    store.init(_agg_params())
    shard = AsyncPSService(store, coordinator=curi)
    agg = AggregatorService(None, _agg_params(), group_size=FAN_IN,
                            coordinator=curi)
    try:
        assert agg.host == socket.gethostname()
        assert fetch_aggregators(curi).get(socket.gethostname()) == \
            f"127.0.0.1:{agg.port}"
        ws = [connect_async(None, w, _agg_params(), coordinator=curi)
              for w in range(FAN_IN)]
        try:
            for w in ws:
                assert w._agg_fallback is not None
                assert w._addrs == [("127.0.0.1", agg.port)]
                w.pull_all()
            _group_rounds(ws, [0])
            _assert_exact(store, {w: [0] for w in range(FAN_IN)})
            assert agg.transport.summary()["agg_rounds"] == 1
        finally:
            for w in ws:
                w.close()
    finally:
        agg.stop()
        shard.stop()
        coord.stop()


def test_stale_discovered_aggregator_falls_back_to_flat(monkeypatch):
    """A dead aggregator's entry stays in the table; a new worker of its
    host probes it (``PS_AGG_PROBE_MAX_WAIT_MS``) and joins flat."""
    from tests.test_torch_aggregation import LR, _assert_exact, _grad

    monkeypatch.setenv("PS_AGG_PROBE_MAX_WAIT_MS", "50")
    _Port.init(num_workers=1)
    coord = Coordinator(bind="127.0.0.1")
    curi = f"127.0.0.1:{coord.port}"
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=LR,
                                 mode="async")
    store.init(_agg_params())
    shard = AsyncPSService(store, coordinator=curi)
    agg = AggregatorService(None, _agg_params(), group_size=1,
                            coordinator=curi)
    agg.kill()
    try:
        t0 = time.monotonic()
        w = connect_async(None, 0, _agg_params(), coordinator=curi,
                          failover_timeout=2.0)
        try:
            assert time.monotonic() - t0 < 10.0
            assert w._agg_fallback is None
            w.pull_all()
            w.push_pull(_grad(0, 0))
            _assert_exact(store, {0: [0]})
        finally:
            w.close()
    finally:
        shard.stop()
        coord.stop()


# -- sparse members ---------------------------------------------------------------


SHAPE = sparse_tests.SHAPE
SPEC = sparse_tests.SPEC
TOTALS = sparse_tests.TOTALS


def _sparse_port(shard, nshards, ca, **kw):
    return SparsePSService(harness.sparse_tables(SHAPE, shard, nshards),
                           shard=shard, num_shards=nshards,
                           total_rows=TOTALS, coordinator=ca, **kw)


def test_sparse_member_joins_and_worker_discovers_topology():
    """Port sparse members register one ``<table>@<lo>:<hi>`` key a
    range; a worker given the coordinator dials them; a range move is
    refused with the reference's typed message."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    coord = Coordinator(bind="127.0.0.1")
    ca = f"127.0.0.1:{coord.port}"
    svcs = [_sparse_port(s, 2, ca) for s in range(2)]
    w = connect_sparse(None, 0, SPEC, coordinator=ca)
    try:
        ids = np.arange(0, SPEC["deep"][0], 3, dtype=np.int32)
        rows = w.pull({"deep": ids})
        assert tuple(rows["deep"].shape) == (ids.size, SPEC["deep"][1])
        w.push({"deep": (ids, np.ones((ids.size, SPEC["deep"][1]),
                                      np.float32))})
        assert w.versions()["deep"] >= 1
        view = fetch_view(ca)
        assert [m["kind"] for m in view["members"]] == ["sparse", "sparse"]
        assert all("@" in k for k in view["table"]["assign"])
        assert sorted(view["table"]["assign"]) == sorted(
            f"{n}@{lo}:{hi}" for n, (rows_, _) in SPEC.items()
            for lo, hi in (row_range(s, 2, rows_) for s in range(2)))
        with pytest.raises(RuntimeError, match="sparse member"):
            request_rebalance(ca, moves=[[0, 1, list(
                view["table"]["assign"])[:1]]])
        with pytest.raises(ValueError, match="server uri or a"):
            connect_sparse(None, 0, SPEC)
    finally:
        w.close()
        for s in svcs:
            s.stop()
        coord.stop()


def test_sparse_worker_discovers_topology_on_shared_coordinator():
    """A coordinator shared with a dense member: the sparse worker dials
    only the sparse members; a default rebalance plans over the dense
    fleet only; a sparse member cannot be drained."""
    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async",
                      num_workers=1, dc_lambda=0.0)
    coord = Coordinator(bind="127.0.0.1")
    ca = f"127.0.0.1:{coord.port}"
    dense = AsyncPSService(_Port.store(_tree(n=2), "sgd"), coordinator=ca)
    svcs = [_sparse_port(s, 2, ca) for s in range(2)]
    w = connect_sparse(None, 0, SPEC, coordinator=ca)
    try:
        ids = np.arange(0, SPEC["deep"][0], 5, dtype=np.int32)
        assert tuple(w.pull({"deep": ids})["deep"].shape)[0] == ids.size
        assert len(w._addrs) == 2
        standby = AsyncPSService(_Port.store({}, "sgd"), coordinator=ca)
        try:
            out = request_rebalance(ca)
            assert out["moves"]
            assert all({d, r} <= {0, 3} for d, r, _n in out["moves"]), out
            t = coord.table()
            assert all(t.assign[k] in (1, 2) for k in t.assign if "@" in k)
            with pytest.raises(RuntimeError, match="leave by stopping"):
                request_rebalance(ca, drain=[1])
        finally:
            standby.stop()
    finally:
        w.close()
        dense.stop()
        for s in svcs:
            s.stop()
        coord.stop()


def test_sparse_member_replacement_takeover_and_rediscovery(tmp_path):
    """A member leaves; a replacement restored from its checkpoint
    registers the same ranges on another port and takes the slot over
    (one more table epoch); the worker's next push, finding the old
    address dead with no replica, re-discovers the fleet, re-dials and
    replays under its original token: applied once at each shard; the
    rows it then pulls are the replacement's, bitwise."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    coord = Coordinator(bind="127.0.0.1")
    ca = f"127.0.0.1:{coord.port}"
    svcs = [_sparse_port(s, 2, ca, ckpt_root=str(tmp_path))
            for s in range(2)]
    w = connect_sparse(None, 0, SPEC, coordinator=ca, failover_timeout=30.0)
    repl = None
    try:
        pushes, req = sparse_tests._cycle(0, 0)
        w.push(pushes)
        for name, emb in svcs[1]._tables.items():
            emb.save(str(tmp_path / f"s1-{name}"))
        old_epoch = coord.table().epoch
        svcs[1].stop()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if fetch_view(ca)["members"][1]["hb_state"] == "left":
                break
            time.sleep(0.05)
        tables = harness.sparse_tables(SHAPE, 1, 2)
        for name, emb in tables.items():
            emb.restore(str(tmp_path / f"s1-{name}"))
        repl = SparsePSService(tables, shard=1, num_shards=2,
                               total_rows=TOTALS, coordinator=ca)
        table = coord.table()
        assert table.epoch > old_epoch and len(table.shards) == 2
        assert table.shards[1].endswith(f":{repl.port}")
        # a push to both shards: shard 0 applies its part, the dead one
        # fails it; after the re-dial the replay keeps its token, so shard
        # 0 acks it unapplied and the replacement applies it, once each
        pushes, req = sparse_tests._cycle(0, 1)
        w.push(pushes)
        assert svcs[0].versions == {n: 2 for n in SPEC}
        assert repl.versions == {n: 2 for n in SPEC}
        assert w.transport.table_reroutes >= 1
        rows = w.pull(req)
        for name, ids in req.items():
            lo, hi = row_range(1, 2, SPEC[name][0])
            mine = (ids >= lo) & (ids < hi)
            np.testing.assert_array_equal(
                sparse_tests._np(rows[name])[mine],
                repl._tables[name].table.numpy()[ids[mine] - lo])
    finally:
        w.close()
        svcs[0].stop()
        if repl is not None:
            repl.stop()
        coord.stop()


@pytest.mark.parametrize("members", ["reference", "port"],
                         ids=["ref-members-port-coordinator",
                              "port-members-ref-coordinator"])
def test_sparse_members_across_packages_over_the_r1_shim(members):
    """Sparse members of one package register with the other package's
    coordinator; the other package's worker finds them there and drives
    them; the tables equal a port fleet's driven the same way (sgd
    bitwise, adagrad within RTOL/ATOL)."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_connect
    from ps_tpu.elastic import Coordinator as RefCoordinator

    ps_tpu_torch.init(backend="cuda", device="cpu")
    if members == "reference":
        coord = Coordinator(bind="127.0.0.1")
        ca = f"127.0.0.1:{coord.port}"
        svcs = [RefService(sparse_tests._ref_tables(s, 2), shard=s,
                           num_shards=2, total_rows=TOTALS, coordinator=ca)
                for s in range(2)]
        connect = connect_sparse
    else:
        coord = RefCoordinator(bind="127.0.0.1")
        ca = f"127.0.0.1:{coord.port}"
        svcs = [_sparse_port(s, 2, ca) for s in range(2)]
        connect = ref_connect
    try:
        w = connect(None, 0, SPEC, coordinator=ca)
        sparse_tests._drive(w)
        assert [m["kind"] for m in fetch_view(ca)["members"]] == \
            ["sparse", "sparse"]
        w.close()
        got = [{n: np.asarray(s._tables[n].table) for n in SPEC}
               for s in svcs]
    finally:
        for s in svcs:
            s.stop()
        coord.stop()
    twins = [SparsePSService(harness.sparse_tables(SHAPE, s, 2), shard=s,
                             num_shards=2, total_rows=TOTALS)
             for s in range(2)]
    try:
        w = connect_sparse(",".join(f"127.0.0.1:{t.port}" for t in twins),
                           0, SPEC)
        sparse_tests._drive(w)
        w.close()
        for s, t in enumerate(twins):
            sparse_tests._hold_to_reference(
                {n: t._tables[n].table.numpy() for n in SPEC}, got[s],
                f"shard {s}")
    finally:
        for t in twins:
            t.stop()


# -- the operators' tools --------------------------------------------------------


def _tools(*coords):
    """``ps_top --coord --once --json``, ``ps_top --fleet --coord --once
    --json`` and ``ps_doctor --coord --json`` against each coordinator, all
    started together; their parsed outputs, three a coordinator."""
    procs = []
    for ca in coords:
        for args in (("tools/ps_top.py", "--coord", ca, "--once", "--json"),
                     ("tools/ps_top.py", "--fleet", "--coord", ca,
                      "--once", "--json"),
                     ("tools/ps_doctor.py", "--coord", ca, "--json")):
            procs.append(subprocess.Popen(
                [sys.executable, *args], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, cwd=ROOT,
                env=dict(os.environ, JAX_PLATFORMS="cpu")))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out))
    return [outs[i:i + 3] for i in range(0, len(outs), 3)]


def _keys(x, depth=2):
    """The nested key structure of a json value, ``depth`` levels down."""
    if isinstance(x, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in sorted(x.items())}
    if isinstance(x, list) and x and depth:
        return [_keys(x[0], depth - 1)]
    return type(x).__name__


def _tool_fleet(pkg):
    """A coordinator, two shards and a worker of one package, 20 cycles
    pushed; returns (coordinator, services, worker)."""
    tree = _tree(n=4)
    keys = sorted(tree)
    # a window longer than the tools' start under load: their queries
    # still see the cycles' samples
    coord = pkg.Coordinator(bind="127.0.0.1", report_ms=100,
                            telemetry_window_s=120.0)
    ca = f"127.0.0.1:{coord.port}"
    svcs = [pkg.service(pkg.store({k: tree[k] for k in ks}, "sgd"),
                        bind="127.0.0.1", coordinator=ca)
            for ks in (keys[:2], keys[2:])]
    w = pkg.connect(None, 0, pkg.like(tree), coordinator=ca)
    w.pull_all()
    for _ in range(20):
        w.push_pull(_grads(tree, pkg))
    return coord, svcs, w


def test_tools_read_a_port_coordinator_as_a_reference_one():
    _Port.init(num_workers=1)
    _Ref.init(num_workers=1)
    fleets = [_tool_fleet(pkg) for pkg in (_Port, _Ref)]
    try:
        time.sleep(1.3)  # reports with telemetry from every member
        port, ref = _tools(*(f"127.0.0.1:{c.port}" for c, _, _ in fleets))
    finally:
        for coord, svcs, w in fleets:
            w.close()
            for s in svcs:
                s.stop()
            coord.stop()
        _shutdown_ref()
    top, fleet, doctor = port
    assert top["table"]["epoch"] == 2 and len(top["members"]) == 2
    assert top["members"][0]["kind"] == "dense"
    assert len(fleet["rows"]) == 2
    assert "ps_server_apply_seconds" in fleet["telemetry"]["fleet"]
    assert set(doctor) == set(ref[2])
    for got, want in zip(port, ref):
        assert _keys(got) == _keys(want)
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "ps_top", os.path.join(ROOT, "tools", "ps_top.py"))
    ps_top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps_top)
    buf = io.StringIO()
    ps_top.print_coord_view(top, stream=buf)
    assert "shard table epoch" in buf.getvalue()
