"""The cross-process sparse PS in the port (``backends/remote_sparse.py``),
against the reference (``tests/test_remote_sparse.py`` and the sparse
cases of ``test_bucketed_transport.py`` and
``test_transport_satellites.py``).

The reference's own ``SparsePSService`` cannot apply a push on this jax:
its ``SparseEmbedding.push`` reaches ``shard_map(check_rep=...)`` (ROADMAP
Queue 3, R1). So the reference side is held through its shard_map-free
parts: ``row_range``, ``dedupe_rows_np``, ``fused_sparse_apply`` on the
``'jax'`` tier with ``make_rowwise``, its numpy worker, and its service
driven over :class:`_RefTable`, a duck type of its ``SparseEmbedding``
that applies through the ``'jax'`` tier. Its framing, routing, dedup and
checkpoint logic then run as they are.

- The partition and the worker's dedupe equal the reference's bitwise.
- One server: remote pushes equal a port twin bitwise, and the
  reference's ``'jax'`` tier within rtol 1e-6 / atol 1e-7 (sgd bitwise).
- Processes (``tests/test_torch_van_harness.py``'s sparse roles, each
  killed after a wall-clock limit): two shard servers x two workers; the
  advertised partition, every expected push applied, each shard's replay
  bitwise and every pulled row set bitwise the replay's rows at the
  versions its reply carried; a killed server named by the worker.
- Refusals, the coordinated checkpoint, the transports (bucketed equals
  serial, a pull never overtakes ``push_async``, reconnect keeps the
  counters, ``ckpt_root`` confines saves, the pause token), interop with
  the reference both ways, and every deferred option raising with its
  ROADMAP item.
- The masked full-table ``'off'`` tier against a numpy oracle and the
  torch tier.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.common import ServerFailureError
from ps_tpu_torch.backends.remote_sparse import (
    RemoteSparseWorker,
    SparsePSService,
    connect_sparse,
    dedupe_rows_np,
    row_range,
    serve_sparse,
)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.ops import sparse_apply as ops
from ps_tpu_torch.optim import rowwise
from tests import test_torch_van_harness as harness

SHAPE = "small"
SPEC = harness.sparse_spec(SHAPE)
TOTALS = {n: v for n, (v, _) in SPEC.items()}
NSHARDS, NWORKERS, CYCLES = 2, 2, 5
RTOL, ATOL = 1e-6, 1e-7  # the reference's sparse-apply contract


@pytest.fixture(autouse=True)
def _port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _serve(shard=None, nshards=None, **kw):
    tables = kw.pop("tables", None) or harness.sparse_tables(
        SHAPE, shard or 0, nshards or 1)
    return serve_sparse(tables, shard=shard, num_shards=nshards,
                        total_rows=TOTALS if nshards else None, **kw)


def _uri(svcs):
    return ",".join(f"127.0.0.1:{s.port}" for s in svcs)


def _cycle(worker, c):
    """A worker's cycle-c pushes and ids (the harness's, at SHAPE)."""
    ids = harness.sparse_ids(SHAPE, worker, c + 1)[c]
    return ({n: (ids, harness.sparse_grads(SHAPE, worker, c, n, ids.size))
             for n in SPEC}, {n: ids for n in SPEC})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _RefTable:
    """A duck type of the reference's ``SparseEmbedding`` (one owner, one
    device) whose push runs ``ps_tpu.ops.sparse_apply.fused_sparse_apply``
    on the ``'jax'`` tier: what its ``SparsePSService`` needs, without the
    ``shard_map`` that R1 breaks."""

    def __init__(self, init, optimizer, lr=harness.SPARSE_LR):
        import jax.numpy as jnp
        from ps_tpu.optim.rowwise import make_rowwise

        self.num_rows, self.dim = init.shape
        self.dtype = np.float32
        self.push_count = self.rows_pushed = 0
        self.fused_tier = "jax"
        self._opt = make_rowwise(optimizer, learning_rate=lr)
        self.table = jnp.asarray(init)
        self._state = self._opt.init(self.table)

    def push(self, ids, grads):
        import jax.numpy as jnp
        from ps_tpu.ops.sparse_apply import fused_sparse_apply

        # padded with the -1 filler (which the tier drops) to a multiple
        # of 64 ids, so that jax compiles a handful of shapes, not one a
        # push
        n = np.asarray(ids).size
        pad = -n % 64
        ids = np.concatenate([np.asarray(ids, np.int32),
                              np.full(pad, -1, np.int32)])
        grads = np.concatenate([np.asarray(grads, np.float32),
                                np.zeros((pad, self.dim), np.float32)])
        self.table, self._state = fused_sparse_apply(
            self.table, self._state, jnp.asarray(ids), jnp.asarray(grads),
            self._opt, "jax")
        self.push_count += 1
        self.rows_pushed += n

    def pull(self, ids):
        import jax.numpy as jnp

        return jnp.take(self.table, jnp.asarray(ids, jnp.int32), axis=0)


def _ref_tables(shard=0, nshards=1):
    out = {}
    for name, (rows, _) in SPEC.items():
        lo, hi = row_range(shard, nshards, rows)
        out[name] = _RefTable(harness.sparse_table(SHAPE, name)[lo:hi],
                              harness.SPARSE_TABLES[name][0])
    return out


def _hold_to_reference(got, want, what):
    """``{name: table}`` against the reference's: sgd ('wide') bitwise,
    adagrad ('deep') within RTOL/ATOL."""
    for n in SPEC:
        if harness.SPARSE_TABLES[n][0] == "sgd":
            np.testing.assert_array_equal(got[n], want[n],
                                          err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {n}")


# -- the pure parts ------------------------------------------------------------


def test_row_range_and_dedupe_equal_the_references_bitwise():
    from ps_tpu.backends.remote_sparse import dedupe_rows_np as ref_dedupe
    from ps_tpu.backends.remote_sparse import row_range as ref_range

    rng = np.random.default_rng(0)
    for _ in range(200):
        total, n = int(rng.integers(0, 1000)), int(rng.integers(1, 9))
        spans = [row_range(s, n, total) for s in range(n)]
        assert spans == [ref_range(s, n, total) for s in range(n)]
        assert spans[0][0] == 0 and spans[-1][1] == total
    with pytest.raises(ValueError):
        row_range(2, 2, 10)
    for size, dtype in ((0, np.float32), (1, np.float32), (300, np.float32),
                        (64, np.float16)):
        ids = rng.integers(0, 40, size).astype(np.int32)
        grads = rng.normal(size=(size, 3)).astype(dtype)
        u, g = dedupe_rows_np(ids, grads)
        ru, rg = ref_dedupe(ids, grads)
        assert u.dtype == ru.dtype and g.dtype == rg.dtype == dtype
        np.testing.assert_array_equal(u, ru)
        assert g.tobytes() == rg.tobytes()


# -- in process: remote pushes equal local applies -------------------------------


def test_single_server_remote_equals_local():
    svc = _serve()
    twin = harness.sparse_tables(SHAPE, 0, 1)
    ref = _ref_tables()
    try:
        w = connect_sparse(_uri([svc]), 0, SPEC)
        for c in range(3):
            pushes, req = _cycle(0, c)
            rows = w.push_pull(pushes, req)
            for n, (ids, grads) in pushes.items():
                u, g = dedupe_rows_np(ids, grads)
                twin[n].push(u, g)
                ref[n].push(u, g)
        for n in SPEC:
            assert torch.equal(svc._tables[n].table, twin[n].table), n
            # the pulled rows are the rows after the cycle's push
            assert torch.equal(rows[n], twin[n].table[req[n]]), n
        _hold_to_reference({n: twin[n].table.numpy() for n in SPEC},
                           {n: np.asarray(ref[n].table) for n in SPEC},
                           "port vs the reference's 'jax' tier")
        assert w.versions() == {"deep": 3, "wide": 3}
        w.close()
    finally:
        svc.stop()


def test_service_rejects_missliced_table():
    tables = harness.sparse_tables(SHAPE, 0, 1)  # the whole tables
    with pytest.raises(ValueError, match="row_range"):
        SparsePSService(tables, shard=0, num_shards=2, total_rows=TOTALS)
    with pytest.raises(ValueError, match="total_rows"):
        SparsePSService(tables, shard=0, num_shards=2)
    with pytest.raises(ValueError, match="together"):
        SparsePSService(tables, shard=0)


def test_partition_hole_and_overlap_fail_at_connect():
    half = _serve(0, NSHARDS)
    whole = [_serve(), _serve()]
    try:
        with pytest.raises(ValueError, match="dialed 1 server"):
            connect_sparse(_uri([half]), 0, SPEC)
        with pytest.raises(ValueError, match="overlapping"):
            connect_sparse(_uri(whole), 0, SPEC)
        with pytest.raises(ValueError, match="worker expects"):
            connect_sparse(_uri(whole[:1]), 0, {"deep": (97, 8),
                                               "wide": (96, 1)})
    finally:
        for s in [half] + whole:
            s.stop()


def test_out_of_range_ids_rejected():
    svc = _serve()
    try:
        w = connect_sparse(_uri([svc]), 0, SPEC)
        with pytest.raises(IndexError, match="out of range"):
            w.pull({"deep": np.array([96], np.int32),
                    "wide": np.array([0], np.int32)})
        # a frame past this server's range is refused by the server too
        with pytest.raises(RuntimeError, match="outside"):
            w._check(0, w._request(0, tv.encode(
                tv.ROW_PULL, 0, {"deep/ids": np.array([500], np.int32)})))
        w.close()
    finally:
        svc.stop()


def test_sparse_coordinated_checkpoint_restart_roundtrip(tmp_path):
    svcs = [_serve(s, NSHARDS) for s in range(NSHARDS)]
    w = connect_sparse(_uri(svcs), 0, SPEC)
    everything = {n: np.arange(v, dtype=np.int32) for n, v in TOTALS.items()}
    w.push(_cycle(0, 0)[0])
    ck = str(tmp_path / "ck")
    versions = w.checkpoint_all(ck)
    assert versions == {"deep": 2, "wide": 2}  # one push on each shard
    ref = w.pull(everything)
    w.push(_cycle(0, 1)[0])  # diverge past the save
    for s in svcs:
        s.stop()

    def relaunch(s):
        tables = harness.sparse_tables(SHAPE, s, NSHARDS)
        for name, emb in tables.items():
            emb.restore(os.path.join(ck, f"shard{s}", name))
        return _serve(s, NSHARDS, tables=tables)

    svcs2 = [relaunch(s) for s in range(NSHARDS)]
    try:
        w.reconnect([("127.0.0.1", s.port) for s in svcs2])
        assert w.versions() == versions  # the streams resume, not reset
        pulled = w.pull(everything)
        for n in SPEC:
            assert torch.equal(ref[n], pulled[n]), n
        w.push(_cycle(0, 1)[0])
        assert w.versions() == {"deep": 4, "wide": 4}
        w.close()
    finally:
        for s in svcs2:
            s.stop()


def test_stopped_server_raises_typed_error():
    svc = _serve()
    w = connect_sparse(_uri([svc]), 0, SPEC)
    svc.stop()
    with pytest.raises(ServerFailureError, match="sparse PS server 0"):
        for c in range(20):  # a first push may land in a dead buffer
            w.push(_cycle(0, c)[0])
            time.sleep(0.05)
    for ch in w._chs:
        ch.close()


def test_stats_reply_carries_the_references_fields():
    svc = _serve()
    try:
        w = connect_sparse(_uri([svc]), 0, SPEC)
        w.push(_cycle(0, 0)[0])
        st = w.stats()
        for key in ("versions", "rows_applied", "fused", "tier", "apply_log",
                    "apply_log_total", "stale_epochs", "stale_epoch_buckets",
                    "metrics", "role", "epoch"):
            assert key in st, key
        assert st["fused"]["tiers"] == {"deep": "torch", "wide": "torch"}
        assert st["apply_log"] == [0] and st["apply_log_total"] == 1
        rows = sum(st["rows_applied"].values())
        assert st["fused"]["rows_applied"] == rows > 0
        assert st["metrics"]["sparse_rows_applied"] == rows
        for lat in ("apply_s", "sparse_apply_s", "fresh_lag_s"):
            assert st["metrics"]["lat"][lat]["count"] == 1, lat
        w.close()
    finally:
        svc.stop()


# -- OS processes: 2 range-sharded servers x 2 workers ---------------------------


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_remote_sparse")
    procs = [harness.spawn("sparse-server", out, NWORKERS, CYCLES, s,
                           NSHARDS, "cpu", SHAPE) for s in range(NSHARDS)]
    procs += [harness.spawn("sparse-worker", f"@{NSHARDS}", out, w, CYCLES,
                            "cpu", SHAPE, NWORKERS, 1)
              for w in range(NWORKERS)]
    outs = harness.finish(procs, wall_s=180, fail_fast=True)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{o}"
    infos = [json.loads((out / f"sparse_server{s}.json").read_text())
             for s in range(NSHARDS)]
    finals = [dict(np.load(out / f"sparse_tables{s}.npz"))
              for s in range(NSHARDS)]
    pulls = {w: (dict(np.load(out / f"sparse_pulls{w}.npz")),
                 json.loads((out / f"sparse_worker{w}.json").read_text()))
             for w in range(NWORKERS)}
    return infos, finals, pulls


def test_row_partition_advertised_correctly(mp_run):
    infos, _, _ = mp_run
    for s, info in enumerate(infos):
        for name, (v, d) in SPEC.items():
            m = info["meta"][name]
            lo, hi = row_range(s, NSHARDS, v)
            assert (m["lo"], m["hi"], m["total_rows"], m["dim"],
                    m["dtype"]) == (lo, hi, v, d, "<f4")


def test_every_expected_push_applied(mp_run):
    infos, _, pulls = mp_run
    for s, info in enumerate(infos):
        target = harness.expected_pushes(SHAPE, s, NSHARDS, NWORKERS, CYCLES)
        assert target > 0, f"degenerate test: shard {s} gets no pushes"
        assert len(info["apply_log"]) == target
        assert sorted(set(info["apply_log"])) == list(range(NWORKERS))
        assert info["tiers"] == {"deep": "torch", "wide": "torch"}
        assert info["launches"]["apply"] == 0  # no kernel on the CPU
    for w, (_, rec) in pulls.items():
        assert len(rec["cycle_s"]) == CYCLES
        assert rec["totals"]["deep"] > 0 and rec["totals"]["wide"] > 0


def test_replay_per_shard_tables_bit_identical(mp_run):
    """Each shard's apply log replayed through the port's one-process
    tables: byte-equal tables and optimizer state, and every pulled row
    set equal to the replay's rows at the versions its reply carried."""
    infos, finals, pulls = mp_run
    with harness.one_thread():
        tables, checked = harness.sparse_replay(infos, SHAPE, NWORKERS,
                                                CYCLES, pulls=pulls)
    assert checked >= NWORKERS * CYCLES * len(SPEC)
    for s, final in enumerate(finals):
        for name, emb in tables[s].items():
            np.testing.assert_array_equal(final[name], emb.table.numpy(),
                                          err_msg=f"shard {s} {name}")
            for i, leaf in enumerate(ops.state_leaves(emb.state())):
                np.testing.assert_array_equal(final[f"{name}/state{i}"],
                                              leaf.numpy())


def test_replay_through_the_references_jax_tier(mp_run):
    """The same logs through the reference's shard_map-free apply: sgd
    bitwise, adagrad within RTOL/ATOL."""
    infos, finals, _ = mp_run
    for s, info in enumerate(infos):
        ref = _ref_tables(s, NSHARDS)
        streams = {w: harness.routed_pushes(SHAPE, w, s, NSHARDS, CYCLES)
                   for w in range(NWORKERS)}
        for w in info["apply_log"]:
            for name, (ids, grads) in next(streams[w]).items():
                ref[name].push(ids, grads)
        _hold_to_reference(finals[s], {n: np.asarray(ref[n].table)
                                       for n in SPEC}, f"shard {s}")


def test_kill_one_sparse_server_raises_typed_error(tmp_path):
    """SIGKILL one server of the row partition mid-job: the worker's next
    push raises ServerFailureError naming it."""
    servers = [harness.spawn("sparse-server", tmp_path, NWORKERS, 10_000, s,
                             NSHARDS, "cpu", SHAPE) for s in range(NSHARDS)]
    try:
        ports = [harness.server_port(p, tmp_path, s)
                 for s, p in enumerate(servers)]
        w = connect_sparse(",".join(f"127.0.0.1:{p}" for p in ports), 0,
                           SPEC)
        w.push(_cycle(0, 0)[0])
        servers[0].send_signal(signal.SIGKILL)
        servers[0].wait(timeout=10)
        with pytest.raises(ServerFailureError, match="server 0") as e:
            for c in range(1, 20):
                w.push(_cycle(0, c)[0])
                time.sleep(0.05)
        assert e.value.server == 0
        for ch in w._chs:
            ch.close()
    finally:
        harness.kill_all(servers)


# -- transports (the sparse cases of the reference's transport suites) -----------


def _one_table(rows=64, dim=8, scale=0.01, lr=0.1, **kw):
    emb = SparseEmbedding(rows, dim, optimizer="sgd", learning_rate=lr)
    emb.init(np.random.default_rng(1).normal(0, 1, (rows, dim)).astype(
        np.float32) * np.float32(scale))
    return SparsePSService({"t": emb}, **kw)


def test_sparse_bucketed_push_matches_serial():
    ids = np.arange(0, 40, dtype=np.int32)
    grads = np.ones((40, 8), np.float32) * np.float32(0.1)
    finals = []
    for bucket_bytes in (None, 1 << 9):
        svc = _one_table()
        w = RemoteSparseWorker([("127.0.0.1", svc.port)], 0, {"t": (64, 8)},
                               bucket_bytes=bucket_bytes)
        w.push({"t": (ids, grads)})
        if bucket_bytes is not None:  # and the async form
            h = w.push_async({"t": (ids, grads)})
            w.flush()
            assert h.done()
            assert w.transport.buckets >= 2 * 2  # the push did split
        else:
            w.push({"t": (ids, grads)})
        assert w.versions() == {"t": 2}
        finals.append(w.pull({"t": np.arange(64, dtype=np.int32)})["t"])
        w.close()
        svc.stop()
    assert torch.equal(finals[0], finals[1])


def test_sparse_pause_token_protocol():
    svc = _one_table(rows=32, dim=4)

    def ckpt(ch, worker, **extra):
        kind, _, _, e = tv.decode(ch.request(tv.encode(tv.CHECKPOINT, worker,
                                                       None, extra=extra)))
        return kind, e

    with tv.Channel.connect("127.0.0.1", svc.port) as ch:
        kind, e1 = ckpt(ch, 0, phase="pause", dir="x")
        assert kind == tv.OK and "token" in e1
        kind, e2 = ckpt(ch, 1, phase="pause", dir="x")
        assert kind == tv.ERR and "already in progress" in e2["error"]
        kind, _ = ckpt(ch, 1, phase="resume", dir="x", token=12345)
        assert kind == tv.ERR and svc._paused
        kind, _ = ckpt(ch, 0, phase="resume", dir="x", token=e1["token"])
        assert kind == tv.OK and not svc._paused
    svc.stop()


def test_sparse_pull_does_not_overtake_push_async():
    svc = _one_table(rows=32, dim=4, scale=0.0, lr=1.0)  # rows start at 0
    w = RemoteSparseWorker([("127.0.0.1", svc.port)], 0, {"t": (32, 4)},
                           bucket_bytes=64, pool_size=2)
    ids = np.arange(16, dtype=np.int32)
    for _ in range(4):
        w.push_async({"t": (ids, np.ones((16, 4), np.float32))})
    rows = w.pull({"t": ids})["t"]  # a barrier: all 4 pushes applied first
    assert w.versions() == {"t": 4}
    assert torch.equal(rows, torch.full((16, 4), -4.0))
    w.close()
    svc.stop()


def test_sparse_reconnect_preserves_counters_and_is_retryable(monkeypatch):
    monkeypatch.setenv("PS_CONNECT_MAX_WAIT_MS", "300")  # the dead dial
    svc = _one_table(rows=32, dim=4)
    w = RemoteSparseWorker([("127.0.0.1", svc.port)], 0, {"t": (32, 4)})
    ids = np.arange(8, dtype=np.int32)
    w.push({"t": (ids, np.ones((8, 4), np.float32))})
    w.pull({"t": ids})
    pushed, pulled = w.bytes_pushed, w.bytes_pulled
    assert pushed > 0 and pulled > 0
    w.reconnect()
    assert (w.bytes_pushed, w.bytes_pulled) == (pushed, pulled)
    assert w.versions() == {"t": 1}  # re-seeded from the live server
    with pytest.raises(Exception):
        w.reconnect([("127.0.0.1", harness.free_port())])  # nothing listens
    w.reconnect([("127.0.0.1", svc.port)])
    assert (w.bytes_pushed, w.bytes_pulled) == (pushed, pulled)
    w.push({"t": (ids, np.ones((8, 4), np.float32))})
    assert w.versions() == {"t": 2}
    w.close()
    svc.stop()


def test_sparse_ckpt_root_confines_saves(tmp_path):
    root = str(tmp_path / "root")
    svc = _one_table(rows=16, dim=4, ckpt_root=root)
    w = RemoteSparseWorker([("127.0.0.1", svc.port)], 0, {"t": (16, 4)})
    w.checkpoint_all("runs/s1")
    assert os.path.isdir(os.path.join(root, "runs", "s1", "t"))
    for bad in ("/abs/elsewhere", "../outside"):
        with pytest.raises(RuntimeError):
            w.checkpoint_all(bad)
    assert not (tmp_path / "outside").exists()
    # the fleet is not wedged after the refusals
    w.push({"t": (np.arange(4, dtype=np.int32), np.ones((4, 4), np.float32))})
    assert w.versions() == {"t": 1}
    w.close()
    svc.stop()


# -- interop with the reference ----------------------------------------------------


def _drive(w, cycles=4):
    """Cycles of pull + push and push_pull (numpy in, whatever out)."""
    pulled = []
    for c in range(cycles):
        pushes, req = _cycle(0, c)
        if c % 2 == 0:
            pulled.append(w.pull(req))
            w.push(pushes)
        else:
            pulled.append(w.push_pull(pushes, req))
    return [{n: _np(r[n]) for n in r} for r in pulled]


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 9],
                         ids=["serial", "bucketed"])
def test_reference_worker_against_port_server(bucket_bytes):
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_connect

    runs = []
    for connect in (connect_sparse, ref_connect):
        svcs = [_serve(s, NSHARDS) for s in range(NSHARDS)]
        try:
            w = connect(_uri(svcs), 0, SPEC, bucket_bytes=bucket_bytes)
            pulled = _drive(w)
            assert w.versions() == {"deep": 8, "wide": 8}
            w.close()
            runs.append((pulled, [{n: s._tables[n].table.numpy().copy()
                                   for n in SPEC} for s in svcs]))
        finally:
            for s in svcs:
                s.stop()
    (port_pulls, port_tables), (ref_pulls, ref_tables) = runs
    for a, b in zip(port_pulls, ref_pulls):
        for n in SPEC:
            np.testing.assert_array_equal(a[n], b[n])
    for a, b in zip(port_tables, ref_tables):
        for n in SPEC:
            np.testing.assert_array_equal(a[n], b[n])


def test_port_worker_against_reference_service_over_the_r1_shim():
    """The reference's ``SparsePSService`` (its framing, routing, dedup and
    pull logic) over :class:`_RefTable`: a port worker and a reference
    worker leave equal tables and pull equal rows; the tables are within
    RTOL/ATOL of the port's own server (sgd bitwise)."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_connect

    runs = []
    for connect in (connect_sparse, ref_connect):
        svcs = [RefService(_ref_tables(s, NSHARDS), shard=s,
                           num_shards=NSHARDS, total_rows=TOTALS)
                for s in range(NSHARDS)]
        try:
            w = connect(_uri(svcs), 0, SPEC)
            pulled = _drive(w)
            w.close()
            runs.append((pulled, [{n: np.asarray(s._tables[n].table)
                                   for n in SPEC} for s in svcs]))
        finally:
            for s in svcs:
                s.stop()
    (port_pulls, ref_svc_tables), (ref_pulls, ref_ref_tables) = runs
    for a, b in zip(port_pulls, ref_pulls):
        for n in SPEC:
            np.testing.assert_array_equal(a[n], b[n])
    port_svcs = [_serve(s, NSHARDS) for s in range(NSHARDS)]
    try:
        w = connect_sparse(_uri(port_svcs), 0, SPEC)
        _drive(w)
        w.close()
        for s, svc in enumerate(port_svcs):
            for n in SPEC:
                np.testing.assert_array_equal(ref_svc_tables[s][n],
                                              ref_ref_tables[s][n])
            _hold_to_reference(
                {n: svc._tables[n].table.numpy() for n in SPEC},
                ref_svc_tables[s], f"shard {s}")
    finally:
        for s in port_svcs:
            s.stop()


def test_port_and_reference_workers_send_the_same_frames():
    """The payloads a port worker builds equal a reference worker's byte
    for byte: dedupe, routing, the cycle token and the framing (numpy and
    tensor inputs alike)."""
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_connect

    svcs = [_serve(s, NSHARDS) for s in range(NSHARDS)]
    try:
        port = connect_sparse(_uri(svcs), 3, SPEC, writev=False)
        ref = ref_connect(_uri(svcs), 3, SPEC, writev=False)
        port._transport_nonce = ref._transport_nonce
        for c in range(3):
            pushes, req = _cycle(1, c)
            as_tensors = {n: (torch.from_numpy(i), torch.from_numpy(g))
                          for n, (i, g) in pushes.items()}
            want = ref._build_push(pushes, True)
            for given in (pushes, as_tensors):
                got = port._build_push(given, True)
                assert sorted(got) == sorted(want)
                for i in want:
                    for kind in (tv.ROW_PUSH, tv.ROW_PUSH_PULL):
                        a = port._encode_serial_push(kind, got[i], pseq=c,
                                                     pfan=sorted(got))
                        b = ref._encode_serial_push(kind, want[i], pseq=c,
                                                    pfan=sorted(want))
                        assert bytes(a) == bytes(b), (c, i, kind)
            got, _ = port._build_pull(port._host_ids(req)[0])
            want, _ = ref._build_pull(req)
            for i in want:
                assert bytes(tv.encode(tv.ROW_PULL, 3, got[i])) == bytes(
                    tv.encode(tv.ROW_PULL, 3, want[i]))
        port.close()
        ref.close()
    finally:
        for s in svcs:
            s.stop()


# -- what is not ported yet --------------------------------------------------------


#: options a later item ported (``match`` None) must be accepted and in
#: effect, where they used to raise naming their item
@pytest.mark.parametrize("kwargs,match", [
    ({"compress": "int8"}, None),
    ({"shm": True}, None),
    ({"coordinator": "{coord}"}, None),
    ({"uri": "{uri}|127.0.0.1:1"}, None),
], ids=["compress", "shm", "coordinator", "replica-set"])
def test_deferred_worker_options_raise(kwargs, match):
    from ps_tpu_torch.elastic import Coordinator

    coord = Coordinator() if "coordinator" in kwargs else None
    ca = f"127.0.0.1:{coord.port}" if coord is not None else None
    svc = _serve() if coord is None else SparsePSService(
        harness.sparse_tables(SHAPE, 0, 1), coordinator=ca)
    try:
        kw = dict(kwargs)
        if match is None:
            # items 5.3 (compress), 5.2 (shm), 5.6 (replicas), 6.2 (the
            # coordinator's table)
            if coord is not None:
                kw["coordinator"], kw["uri"] = ca, None
            u = kw.pop("uri", "{uri}")
            w = connect_sparse(u and u.format(uri=_uri([svc])), 0, SPEC,
                               **kw)
            if coord is not None:
                assert w._addrs == [("127.0.0.1", svc.port)]
            elif "shm" in kw:
                assert w._chs[0].lane == "shm"
            elif "compress" in kw:
                assert w.compress == {"codec": "int8", "seed": 0}
            else:  # the primary first, its backup after it
                assert w._replica_sets == [[("127.0.0.1", svc.port),
                                            ("127.0.0.1", 1)]]
            ids = np.arange(3, dtype=np.int32)
            w.push({"deep": (ids, np.ones((3, SPEC["deep"][1]), np.float32))})
            assert w.versions()["deep"] == 1
            w.close()
            return
        with pytest.raises(NotImplementedError, match=match):
            connect_sparse(kw.pop("uri", _uri([svc])), 0, SPEC, **kw)
    finally:
        svc.stop()
        if coord is not None:
            coord.stop()


@pytest.mark.parametrize("case,match", [
    ("backup", None),
    ("native_loop", None),
    ("shm", None),
    ("coordinator", None),
    ("tiered", None),
    ("read_rows", None),
    ("READ", None),
], ids=["backup", "native_loop", "shm", "coordinator", "tiered",
        "read_rows", "READ"])
def test_deferred_options_raise_and_name_their_item(case, match):
    """The native loop (item 5.1), accepting shm offers (item 5.2), a
    backup (item 5.6), the read path (``read_rows`` and READ, item 5.8), a
    tiered table (item 5.7) and a coordinator (item 6.2), each once
    refused naming its item, are in effect: a tiered table is served,
    pushed, pulled and read; a service given a coordinator registers its
    row ranges."""
    if case == "coordinator":
        from ps_tpu_torch.elastic import Coordinator

        coord = Coordinator()
        svc = SparsePSService(harness.sparse_tables(SHAPE, 0, 1),
                              coordinator=f"127.0.0.1:{coord.port}")
        try:
            assert sorted(coord.table().assign) == sorted(
                f"{n}@0:{rows}" for n, (rows, _) in SPEC.items())
            assert svc.table_epoch == 1
        finally:
            svc.stop()
            coord.stop()
        return
    if case in ("read_rows", "READ"):
        svc = _serve()
        try:
            w = connect_sparse(_uri([svc]), 0, SPEC)
            ids = np.arange(3, dtype=np.int32)
            want = w.pull({"deep": ids})["deep"].numpy()
            if case == "read_rows":
                got = w.read_rows({"deep": ids})["deep"].numpy()
            else:
                kind, _, tensors, extra = tv.decode(w._chs[0].request(
                    tv.encode(tv.READ, 0, {"deep/ids": ids})))
                assert kind == tv.OK and extra["version"] == 0, extra
                got = np.array(tensors["deep/rows"])
            np.testing.assert_array_equal(got, want)
            w.close()
        finally:
            svc.stop()
        return
    if case == "tiered":
        from ps_tpu_torch.kv.tiered import TieredTable

        rows, dim = SPEC["deep"]
        emb = TieredTable(rows, dim, "adagrad", device_rows=rows // 4,
                          admit_freq=2, learning_rate=harness.SPARSE_LR)
        emb.init(harness.sparse_table(SHAPE, "deep"))
        twin = SparseEmbedding(rows, dim, "adagrad",
                               learning_rate=harness.SPARSE_LR)
        twin.init(harness.sparse_table(SHAPE, "deep"))
        svc = SparsePSService({"deep": emb})
        try:
            w = connect_sparse(_uri([svc]), 0, {"deep": SPEC["deep"]})
            for c in range(CYCLES):
                pushes, _ = _cycle(0, c)
                w.push({"deep": pushes["deep"]})
                twin.push(*dedupe_rows_np(*pushes["deep"]))
            ids = np.arange(rows, dtype=np.int32)
            np.testing.assert_array_equal(w.pull({"deep": ids})["deep"],
                                          twin.table.numpy())
            np.testing.assert_array_equal(
                w.read_rows({"deep": ids})["deep"], twin.table.numpy())
            assert emb.promotions > 0 and svc.versions["deep"] == CYCLES
            w.close()
        finally:
            svc.stop()
        return
    if match is None:
        svc = SparsePSService(harness.sparse_tables(SHAPE, 0, 1),
                              **{case: True})
        try:
            assert svc.native_loop == (case == "native_loop")
            assert svc._shm_accept
            assert svc.role == ("backup" if case == "backup" else "primary")
        finally:
            svc.stop()
        return


def test_bf16_table_is_refused_with_a_typed_error():
    emb = SparseEmbedding(8, 2, optimizer="sgd", dtype=torch.bfloat16)
    emb.init(np.zeros((8, 2), np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        SparsePSService({"t": emb})


def test_fused_tier_off_is_served():
    """``PS_FUSED_APPLY=off`` reaches the masked full-table tier, and a
    server of 'off' tables leaves what one of torch-tier tables does
    (sgd bitwise, adagrad within RTOL/ATOL)."""
    finals = {}
    for tier in ("off", "torch"):
        os.environ["PS_FUSED_APPLY"] = tier
        try:
            ps_tpu_torch.shutdown()
            ps_tpu_torch.init(backend="cuda", device="cpu")
            svc = _serve()
        finally:
            del os.environ["PS_FUSED_APPLY"]
        try:
            assert svc.fused_tiers == {"deep": tier, "wide": tier}
            w = connect_sparse(_uri([svc]), 0, SPEC)
            _drive(w)
            w.close()
            finals[tier] = {n: svc._tables[n].table.numpy().copy()
                            for n in SPEC}
        finally:
            svc.stop()
    np.testing.assert_array_equal(finals["off"]["wide"],
                                  finals["torch"]["wide"])
    np.testing.assert_allclose(finals["off"]["deep"], finals["torch"]["deep"],
                               rtol=RTOL, atol=ATOL)


# -- the masked full-table 'off' tier -------------------------------------------------


def _off_pushes(rows, dim, n=5):
    """Pushes with hot duplicates, -1 filler and ids past the table."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        ids = rng.integers(-3, rows + 3, 120).astype(np.int32)
        ids[rng.permutation(120)[:40]] = 7  # a hot row
        out.append((ids, rng.normal(size=(120, dim)).astype(np.float32)))
    return out


def _numpy_masked(rule, table, state, ids, grads, lr=0.1, eps=1e-8,
                  b1=0.9, b2=0.999):
    """The reference's masked full-table rule in numpy, on
    ``segment_sum_np``'s sums."""
    rows = table.shape[0]
    keep = (ids >= 0) & (ids < rows)
    uids, gsum_u, _ = ops.segment_sum_np(ids[keep], grads[keep])
    gsum = np.zeros(table.shape, np.float32)
    gsum[uids] = gsum_u
    touched = np.zeros(rows, bool)
    touched[uids] = True
    lr32 = np.float32(lr)
    if rule == "sgd":
        return table - lr32 * gsum, state
    if rule == "adagrad":
        acc = state + (gsum * gsum).mean(axis=-1)
        step = lr32 * gsum / np.sqrt(acc + np.float32(eps))[:, None]
        return table - step, acc
    m, t, v = state
    t = t + touched.astype(np.int32)
    mask = touched[:, None]
    m = np.where(mask, np.float32(b1) * m + np.float32(1 - b1) * gsum, m)
    v = np.where(mask, np.float32(b2) * v + np.float32(1 - b2) * gsum * gsum,
                 v)
    ts = np.maximum(t, 1)[:, None].astype(np.float32)
    mhat = m / (1 - np.float32(b1) ** ts)
    vhat = v / (1 - np.float32(b2) ** ts)
    step = np.where(mask, lr32 * mhat / (np.sqrt(vhat) + np.float32(eps)),
                    0).astype(np.float32)
    return table - step, (m, t, v)


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adam"])
def test_off_tier_equals_a_numpy_oracle(rule):
    rows, dim = 50, 6
    opt = rowwise.make_rowwise(rule, learning_rate=0.1)
    table0 = np.random.default_rng(2).normal(size=(rows, dim)).astype(
        np.float32)
    table = torch.from_numpy(table0.copy())
    state = opt.init(table)
    want = table0.copy()
    want_state = {"sgd": (), "adagrad": np.zeros(rows, np.float32),
                  "adam": (np.zeros((rows, dim), np.float32),
                           np.zeros(rows, np.int32),
                           np.zeros((rows, dim), np.float32))}[rule]
    for ids, grads in _off_pushes(rows, dim):
        ops.fused_sparse_apply(table, state, torch.from_numpy(ids),
                               torch.from_numpy(grads), opt, "off")
        want, want_state = _numpy_masked(rule, want, want_state, ids, grads)
    if rule == "sgd":
        np.testing.assert_array_equal(table.numpy(), want)
    else:
        np.testing.assert_allclose(table.numpy(), want, rtol=RTOL, atol=ATOL)
        leaves = ops.state_leaves(state)
        wants = [want_state] if rule == "adagrad" else list(want_state)
        for got, w in zip(leaves, wants):
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adam"])
def test_off_tier_equals_the_torch_tier(rule):
    rows, dim = 50, 6
    tables = {}
    for tier in ("off", "torch"):
        emb = SparseEmbedding(rows, dim, optimizer=rule, learning_rate=0.1,
                              fused_apply=tier)
        emb.init(np.random.default_rng(2).normal(size=(rows, dim)).astype(
            np.float32))
        for ids, grads in _off_pushes(rows, dim):
            emb.push(ids, grads)
        tables[tier] = emb
    off, plain = tables["off"], tables["torch"]
    if rule == "sgd":
        assert torch.equal(off.table, plain.table)
    np.testing.assert_allclose(off.table.numpy(), plain.table.numpy(),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(ops.state_leaves(off.state()),
                    ops.state_leaves(plain.state())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(off.row_version, plain.row_version)
