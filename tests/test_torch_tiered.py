"""Tiered embedding storage in the port (``kv/tiered.py``) against the
reference's ``ps_tpu/kv/tiered.py``, with counterparts of the cases of
``tests/test_tiered.py`` and the service seams.

The reference's own hot tier cannot push on this jax: its
``SparseEmbedding.push`` reaches ``shard_map(check_rep=...)`` (ROADMAP
Queue 3, R1). So each reference table here gets its ``hot`` swapped,
before ``init``, for :class:`_RefHot`, a table shim whose push runs
``ps_tpu.ops.sparse_apply.fused_sparse_apply`` on the ``'jax'`` tier; the
reference's directory, planning, cold path, checkpoint and service code
then run as they are. Nothing in ``ps_tpu`` changes.

- With TTL off planning reads no clock, so the port's move logs must
  equal the reference's, push by push; with TTL on the reference's logs
  are replayed into the port (``moves=``). The directory arrays and the
  CLOCK hand equal the reference's.
- Rows: every port table against an untiered port table of the same
  stream (the oracle: hot rows bitwise, the rest within rtol 1e-6 / atol
  1e-7, adam 1e-5 / 1e-6 as the reference's own test), and against the
  reference's rows within the same tolerances.
- The service: a backup's directory and tiers bitwise its primary's
  through replication, prefetch before the apply lock, STATS ``tier``,
  the moved rows' tags in the read invalidation, the conditional read
  delta after tier moves, a push parked mid-pause; the checkpoint round
  trip and ``from_reference`` on a reference ``tiered`` checkpoint, both
  bitwise; two gloo ranks against one process, bitwise.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.kv.tiered import TieredTable as RefTiered
from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch.backends.remote_sparse import (
    SparsePSService,
    connect_sparse,
)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.kv.tiered import TieredTable, tiered_embedding

V, D, BUDGET = 96, 4, 24
RTOL, ATOL = 1e-6, 1e-7  # the reference's mixed-stream tolerance
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6  # its state-travels tolerance
DIRECTORY = ("tier", "slot", "freq", "ref", "slot_to_id")


@pytest.fixture(autouse=True)
def _port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _table0(rows=V):
    return np.random.default_rng(0).normal(size=(rows, D)).astype(np.float32)


def _stream(n_push, batch=16, lo=0, hi=V, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(lo, hi, size=batch).astype(np.int32),
             rng.normal(size=(batch, D)).astype(np.float32) * 0.1)
            for _ in range(n_push)]


class _RefHot:
    """The reference's hot tier without its ``shard_map``: one [rows, D]
    jax table whose push is ``fused_sparse_apply`` on the ``'jax'`` tier
    (the -1 filler dropped), with what ``ps_tpu.kv.tiered`` calls."""

    def __init__(self, rows, opt):
        self.num_rows, self.dim = rows, D
        self._opt = opt
        self.push_count = self.rows_pushed = 0
        self.fused_tier = "jax"

    def init(self, table):
        self.table = jnp.asarray(table)
        self._state = self._opt.init(self.table)
        return self.table

    def state(self):
        return self._state

    def push(self, ids, grads):
        from ps_tpu.ops.sparse_apply import fused_sparse_apply

        self.table, self._state = fused_sparse_apply(
            self.table, self._state, jnp.asarray(ids, jnp.int32),
            jnp.asarray(grads, jnp.float32), self._opt, "jax")
        self.push_count += 1
        self.rows_pushed += int(np.asarray(ids).size)

    def pull(self, slots):
        return jnp.take(self.table, jnp.asarray(slots, jnp.int32), axis=0)

    def export_rows(self, slots):
        slots = jnp.asarray(slots, jnp.int32)
        return (np.asarray(jnp.take(self.table, slots, axis=0)),
                [np.asarray(jnp.take(leaf, slots, axis=0))
                 for leaf in jax.tree_util.tree_leaves(self._state)])

    def adopt_rows(self, slots, rows, leaves):
        slots = jnp.asarray(slots, jnp.int32)
        self.table = self.table.at[slots].set(jnp.asarray(rows))
        flat, treedef = jax.tree_util.tree_flatten(self._state)
        self._state = jax.tree_util.tree_unflatten(treedef, [
            leaf.at[slots].set(jnp.asarray(v, leaf.dtype))
            for leaf, v in zip(flat, leaves)])

    def adopt_state(self, table, state):
        self.table, self._state = table, state


def _ref(optimizer="adagrad", budget=BUDGET, table=None, **kw):
    if not ps_tpu.is_initialized():
        ps_tpu.init(backend="tpu")
    t = RefTiered(V, D, optimizer=optimizer, device_rows=budget, **kw)
    t.hot = _RefHot(budget, t._opt)
    t.init(_table0() if table is None else table)
    return t


def _make(optimizer="adagrad", budget=BUDGET, **kw):
    t = TieredTable(V, D, optimizer, device_rows=budget, **kw)
    t.init(_table0())
    return t


def _untiered(optimizer="adagrad", rows=V, **kw):
    emb = SparseEmbedding(rows, D, optimizer, **kw)
    emb.init(_table0(rows))
    return emb


def _all_rows(t):
    return np.asarray(t.pull(np.arange(V, dtype=np.int32)))


def _same_directory(port, ref, what=""):
    for attr in DIRECTORY:
        np.testing.assert_array_equal(getattr(port, attr),
                                      getattr(ref, attr),
                                      err_msg=f"{what} {attr}")
    assert port.hand == ref.hand, what


def _against_oracle(t, u, rtol=RTOL, atol=ATOL):
    """Every row of ``t`` against the untiered ``u``: hot rows bitwise."""
    got, exp = _all_rows(t), u.table.numpy()[:V]
    hot = t.slot_to_id[t.slot_to_id >= 0]
    np.testing.assert_array_equal(got[hot], exp[hot])
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol)


def _run_both(port, ref, stream):
    """The same stream through both tables; every push's move logs
    equal."""
    for i, (ids, grads) in enumerate(stream):
        port.push(ids, grads)
        ref.push(ids, grads)
        assert port.pop_moves() == ref.pop_moves(), f"push {i}"


# -- factory and knobs --------------------------------------------------------


def test_factory_degenerate_budgets_stay_untiered():
    from ps_tpu.kv.tiered import tiered_embedding as ref_factory

    if not ps_tpu.is_initialized():
        ps_tpu.init(backend="tpu")
    for budget in (0, V, V + 7, BUDGET):
        got = tiered_embedding(V, D, device_rows=budget)
        want = ref_factory(V, D, device_rows=budget)
        assert type(got).__name__ == type(want).__name__, budget
        assert isinstance(got, TieredTable) == (budget == BUDGET)
    assert got.device_rows == BUDGET


def test_factory_resolves_env_knobs(monkeypatch):
    monkeypatch.setenv("PS_EMBED_DEVICE_ROWS", str(BUDGET))
    monkeypatch.setenv("PS_EMBED_ADMIT_FREQ", "5")
    monkeypatch.setenv("PS_EMBED_EVICT_TTL_MS", "1234")
    monkeypatch.setenv("PS_EMBED_PREFETCH", "1")
    t = tiered_embedding(V, D)
    assert isinstance(t, TieredTable)
    assert (t.device_rows, t.admit_freq, t.evict_ttl_ms,
            t.prefetch_enabled) == (BUDGET, 5, 1234, True)
    monkeypatch.setenv("PS_EMBED_DEVICE_ROWS", "0")
    assert isinstance(tiered_embedding(V, D), SparseEmbedding)


def test_config_carries_tier_knobs(monkeypatch):
    from ps_tpu.config import Config as RefConfig
    from ps_tpu_torch.config import Config

    monkeypatch.setenv("PS_EMBED_DEVICE_ROWS", "512")
    monkeypatch.setenv("PS_EMBED_ADMIT_FREQ", "3")
    monkeypatch.setenv("PS_EMBED_EVICT_TTL_MS", "9000")
    monkeypatch.setenv("PS_EMBED_PREFETCH", "true")
    knobs = ("embed_device_rows", "embed_admit_freq", "embed_evict_ttl_ms",
             "embed_prefetch")
    cfg, ref = Config.from_env(), RefConfig.from_env()
    assert [getattr(cfg, k) for k in knobs] == [512, 3, 9000, True]
    assert [getattr(ref, k) for k in knobs] == [getattr(cfg, k)
                                                for k in knobs]
    for bad in ({"embed_device_rows": -1}, {"embed_admit_freq": 0},
                {"embed_evict_ttl_ms": -5}):
        with pytest.raises(ValueError):
            Config(**bad)


def test_bad_budgets_and_knobs_are_refused():
    for kw in ({"device_rows": 0}, {"device_rows": V},
               {"device_rows": BUDGET, "admit_freq": 0},
               {"device_rows": BUDGET, "evict_ttl_ms": -1}):
        with pytest.raises(ValueError):
            TieredTable(V, D, **kw)
    t = _make()
    with pytest.raises(RuntimeError, match="already"):
        t.init(_table0())
    with pytest.raises(ValueError, match="shape"):
        t.push(np.arange(3), np.zeros((2, D), np.float32))


# -- core contracts -----------------------------------------------------------


def test_all_hot_stream_bitwise_parity():
    """A stream confined to the resident hot set: the device tier is
    bitwise an untiered table of the budget's rows, and the reference's
    hot tier within the apply tolerance."""
    t = _make(admit_freq=1 << 30)
    u = _untiered(rows=BUDGET)
    ref = _ref(admit_freq=1 << 30)
    for ids, grads in _stream(12, hi=BUDGET):
        t.push(ids, grads)
        u.push(ids, grads)
        ref.push(ids, grads)
    np.testing.assert_array_equal(t.hot.table.numpy(), u.table.numpy())
    np.testing.assert_allclose(t.hot.table.numpy(), np.asarray(ref.hot.table),
                               rtol=RTOL, atol=ATOL)
    assert t.promotions == t.evictions == 0


def test_mixed_stream_matches_untiered_oracle():
    """Hot and cold ids with churn: the move logs and the directory are
    the reference's, every row the untiered oracle's (hot rows bitwise)
    and the reference's within tolerance."""
    t, ref, u = _make(admit_freq=2), _ref(admit_freq=2), _untiered()
    stream = _stream(20)
    _run_both(t, ref, stream)
    for ids, grads in stream:
        u.push(ids, grads)
    assert t.promotions > 0 and t.evictions > 0  # churn ran
    _same_directory(t, ref)
    _against_oracle(t, u)
    np.testing.assert_allclose(_all_rows(t), _all_rows(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(t.row_version, ref.row_version)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_state_travels_with_row_both_directions(optimizer):
    """Per-row optimizer state rides every promotion and demotion: a cold
    id hammered until it promotes, then pushed out by other admissions,
    ends where the untiered oracle and the reference put it."""
    t = _make(optimizer, admit_freq=2, learning_rate=0.1)
    ref = _ref(optimizer, admit_freq=2, learning_rate=0.1)
    u = _untiered(optimizer, learning_rate=0.1)
    hot_id = np.int32(BUDGET + 1)
    stream = []
    for step, (ids, grads) in enumerate(_stream(24)):
        if step % 2:
            ids = ids.copy()
            ids[0] = hot_id
        stream.append((ids, grads))
    _run_both(t, ref, stream)
    for ids, grads in stream:
        u.push(ids, grads)
    _same_directory(t, ref)
    _against_oracle(t, u, ADAM_RTOL, ADAM_ATOL)
    # the reference's jitted cold rule may contract into FMAs: tolerance,
    # sgd included
    np.testing.assert_allclose(_all_rows(t), _all_rows(ref),
                               rtol=ADAM_RTOL, atol=ADAM_ATOL)
    # the cold state too, leaf by leaf, for the rows that live there
    cold = t.tier == 0
    for mine, theirs in zip(t.cold_state, ref.cold_state):
        np.testing.assert_allclose(mine.numpy()[cold], theirs[cold],
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)


def test_row_sum_conservation_under_ttl_churn():
    """TTL demotion and CLOCK eviction lose no row: the reference's TTL
    move logs (it read the clock) replayed into the port give its
    directory, and the port's f64 row sum tracks the untiered oracle."""
    ref = _ref(admit_freq=1, evict_ttl_ms=1)
    t = _make(admit_freq=1, evict_ttl_ms=1)
    u = _untiered()
    for ids, grads in _stream(16):
        ref.push(ids, grads)
        t.push(ids, grads, moves=ref.pop_moves())
        u.push(ids, grads)
        time.sleep(0.002)  # past the TTL horizon
    assert t.evictions > 0 and t.evictions == ref.evictions
    _same_directory(t, ref)
    want = float(u.table.numpy()[:V].astype(np.float64).sum())
    assert np.isclose(t.row_sum(), want, rtol=1e-9, atol=1e-6)
    assert np.isclose(t.row_sum(), ref.row_sum(), rtol=1e-6, atol=1e-6)
    _against_oracle(t, u)


def test_pull_splits_without_directory_mutation():
    t, ref = _make(), _ref()
    before = [getattr(t, a).copy() for a in DIRECTORY]
    ids = np.array([0, BUDGET + 3, 5, V - 1, 0], np.int32)
    rows = t.pull(ids)
    assert rows.device.type == "cpu"  # cold rows never visit the device
    np.testing.assert_array_equal(rows.numpy(), _table0()[ids])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref.pull(ids)))
    for a, b in zip(before, [getattr(t, a) for a in DIRECTORY]):
        np.testing.assert_array_equal(a, b)  # a read changes nothing
    assert (t.hot_hits, t.misses) == (ref.hot_hits, ref.misses) == (3, 2)


def test_prefetch_staged_slab_matches_inline_path():
    """A staged slab consumed by the next push gives the inline gather's
    table bitwise, and a slab a demotion made stale is dropped."""
    t, u = _make(prefetch=True), _make(prefetch=False)
    for ids, grads in _stream(10):
        t.prefetch(ids)
        t._prefetch_pool.shutdown(wait=True)  # the gather is done
        t._prefetch_pool = None
        t.push(ids, grads)
        u.push(ids, grads)
    np.testing.assert_array_equal(_all_rows(t), _all_rows(u))
    assert t.prefetch_hits > 0
    # a slab holding a row that a demotion then rewrites is never served
    cold = np.flatnonzero(t.tier == 0)[:3].astype(np.int32)
    t._stage(np.unique(cold))
    victim = int(t.slot_to_id[0])
    t._apply_moves({"ops": [["d", victim, 0], ["p", int(cold[0]), 0]],
                    "hand": t.hand})
    assert t._staged is None or not np.isin(victim, t._staged[1])


def test_tier_stats_shape():
    t, ref = _make(), _ref()
    _run_both(t, ref, _stream(6))
    st = t.tier_stats()
    want = ref.tier_stats()
    assert st == {**want, "prefetch_hits": 0}
    assert st["device_rows"] == BUDGET and st["total_rows"] == V
    assert st["hot_rows"] == BUDGET and 0.0 <= st["hit_rate"] <= 1.0
    assert len(t.drain_cold_gather()) > 0
    assert t.drain_cold_gather() == []  # drained


def test_bf16_arena_holds_rows_exactly():
    """A bf16 table's rows travel between the tiers unchanged: the arena
    holds bf16, as the reference's numpy arena does through ml_dtypes."""
    t = _make(admit_freq=2, dtype=torch.bfloat16)
    u = _untiered(dtype=torch.bfloat16)
    assert t.arena.dtype == torch.bfloat16
    for ids, grads in _stream(20):
        t.push(ids, grads)
        u.push(ids, grads)
    assert t.promotions > 0 and t.evictions > 0
    got = t.pull(np.arange(V, dtype=np.int32)).float().numpy()
    exp = u.table.float().numpy()[:V]
    hot = t.slot_to_id[t.slot_to_id >= 0]
    np.testing.assert_array_equal(got[hot], exp[hot])
    np.testing.assert_array_equal(got, exp)


# -- seam 1: replication --------------------------------------------------------


def test_move_log_replay_reproduces_directory_bitwise():
    """A backup replaying the primary's logs (never planning) ends with
    its directory, hot table and arena bitwise."""
    prim, back = _make(admit_freq=2), _make(admit_freq=2)
    for ids, grads in _stream(20):
        prim.push(ids, grads)
        back.push(ids, grads, moves=prim.pop_moves())
    assert prim.promotions > 0
    _same_directory(back, prim)
    assert torch.equal(prim.hot.table, back.hot.table)
    assert torch.equal(prim.arena, back.arena)
    for a, b in zip(prim.cold_state, back.cold_state):
        assert torch.equal(a, b)


def _pair(**kw):
    prim = SparsePSService({"emb": _make(**kw)})
    back = SparsePSService({"emb": _make(**kw)}, backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    return prim, back


def _same_tables(a, b, what):
    _same_directory(a, b, what)
    assert torch.equal(a.hot.table, b.hot.table), what
    assert torch.equal(a.arena, b.arena), what
    for x, y in zip(a.cold_state + [a.hot.state()],
                    b.cold_state + [b.hot.state()]):
        assert torch.equal(x, y), what


def test_failover_drill_backup_directory_matches_primary():
    """Through the services: the primary ships each push's move log on
    the replication stream and the backup replays it; the backup's
    directory and both tiers are bitwise the primary's, the logs the
    reference table's on the same stream; killed, the promoted backup
    serves on."""
    prim, back = _pair(admit_freq=2)
    ref = _ref(admit_freq=2)
    shipped = []
    publish = prim._backup_session.publish

    def record(op, worker, tensors, meta):
        shipped.append(meta.get("tier_moves"))
        return publish(op, worker, tensors, meta)

    prim._backup_session.publish = record
    w = connect_sparse(f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}", 0,
                       {"emb": (V, D)}, failover_timeout=10.0)
    try:
        stream = _stream(15)
        for ids, grads in stream:
            w.push({"emb": (ids, grads)})
            ref.push(*_dedupe(ids, grads))
            assert (shipped[-1] or {}).get("emb", {"ops": []})["ops"] == \
                ref.pop_moves()["ops"]
        pt, bt = prim._tables["emb"], back._tables["emb"]
        assert pt.promotions > 0 and any(shipped)
        _same_tables(pt, bt, "backup")
        _same_directory(pt, ref, "reference")
        assert back.versions == prim.versions
        prim.kill()
        back.promote(reason="test")
        for ids, grads in _stream(3, seed=5):
            w.push({"emb": (ids, grads)})
        assert back.versions["emb"] == 18
        got = w.pull({"emb": np.arange(V, dtype=np.int32)})["emb"].numpy()
        np.testing.assert_array_equal(got, _all_rows(bt))
    finally:
        w.close()
        prim.stop()
        back.stop()


def _dedupe(ids, grads):
    from ps_tpu_torch.backends.remote_sparse import dedupe_rows_np

    return dedupe_rows_np(ids, grads)


# -- seam 2: checkpoint ---------------------------------------------------------


def test_save_restore_reproduces_directory_and_both_arenas(tmp_path):
    t = _make(admit_freq=2)
    for ids, grads in _stream(14):
        t.push(ids, grads)
    assert t.promotions > 0
    t.save(str(tmp_path / "ck"))
    rows = _all_rows(t)
    t2 = _make(admit_freq=2)  # fresh placement, then the restore
    t2.restore(str(tmp_path / "ck"))
    _same_tables(t, t2, "restored")
    np.testing.assert_array_equal(t.last_ms, t2.last_ms)
    assert (t2.dir_gen, t2.push_count) == (t.dir_gen, t.push_count)
    assert (t2.hot.push_count, t2.rows_pushed) == (t.push_count,
                                                   t.rows_pushed)
    assert (t2.row_version == t.push_count).all()
    np.testing.assert_array_equal(rows, _all_rows(t2))
    # the restored table trains on as the original does
    ids, grads = _stream(1, seed=9)[0]
    t.push(ids, grads)
    t2.push(ids, grads, moves=t.pop_moves())
    np.testing.assert_array_equal(_all_rows(t), _all_rows(t2))


def test_restore_rejects_mismatched_geometry(tmp_path):
    t = _make()
    t.save(str(tmp_path / "ck"))
    other = TieredTable(V, D, "adagrad", device_rows=BUDGET * 2)
    other.init(_table0())
    with pytest.raises(ValueError, match="geometry"):
        other.restore(str(tmp_path / "ck"))
    bf16 = TieredTable(V, D, "adagrad", device_rows=BUDGET,
                       dtype=torch.bfloat16)
    bf16.init(_table0())
    with pytest.raises(ValueError, match="dtype"):
        bf16.restore(str(tmp_path / "ck"))
    adam = _make("adam")
    before = (adam.hot.table.clone(), adam.arena.clone(), adam.tier.copy())
    with pytest.raises(ValueError, match="optimizer"):
        adam.restore(str(tmp_path / "ck"))
    # a refused restore changed nothing
    assert torch.equal(before[0], adam.hot.table)
    assert torch.equal(before[1], adam.arena)
    np.testing.assert_array_equal(before[2], adam.tier)
    u = _untiered()
    u.save(str(tmp_path / "ck2"))
    with pytest.raises(ValueError, match="engine"):
        t.restore(str(tmp_path / "ck2"))


def test_push_mid_pause_parks_promotion_never_splits_snapshot(tmp_path):
    """A push whose admission would promote lands under the coordinated
    pause: it parks until resume, the snapshot holds the pre-push
    directory and tiers, and the promotion lands wholly after."""
    t = _make(admit_freq=1)  # a cold id's first touch promotes
    svc = SparsePSService({"emb": t})
    try:
        warm = _stream(3)
        for i, (ids, grads) in enumerate(warm):
            svc._apply_push(0, {"emb": {"ids": ids, "grads": grads}},
                            extra={"pseq": i + 1, "pnonce": "n0",
                                   "pfan": [0]})
        kind, _, _, ex = tv.decode(svc._checkpoint(0, {"phase": "pause"}))
        assert kind == tv.OK
        token = ex["token"]
        pre = {a: getattr(t, a).copy() for a in DIRECTORY}
        pre_gen, pre_arena = t.dir_gen, t.arena.clone()
        cold_id = int(np.flatnonzero(t.tier == 0)[0])
        applied = threading.Event()

        def late_push():
            svc._apply_push(
                0, {"emb": {"ids": np.array([cold_id], np.int32),
                            "grads": np.ones((1, D), np.float32)}},
                extra={"pseq": len(warm) + 1, "pnonce": "n0", "pfan": [0]})
            applied.set()

        th = threading.Thread(target=late_push, daemon=True)
        th.start()
        assert not applied.wait(0.4)  # parked on the pause
        assert t.dir_gen == pre_gen  # nothing of the promotion leaked in
        kind, _, _, _ = tv.decode(svc._checkpoint(0, {
            "phase": "save", "token": token, "dir": str(tmp_path / "ck")}))
        assert kind == tv.OK
        kind, _, _, _ = tv.decode(svc._checkpoint(0, {
            "phase": "resume", "token": token}))
        assert kind == tv.OK
        assert applied.wait(10.0)
        th.join(10.0)
        assert t.tier[cold_id] == 1  # the promotion, after the resume
        t2 = _make(admit_freq=1)
        t2.restore(str(tmp_path / "ck" / "emb"))
        for a, v in pre.items():
            np.testing.assert_array_equal(v, getattr(t2, a), err_msg=a)
        assert t2.tier[cold_id] == 0 and torch.equal(t2.arena, pre_arena)
    finally:
        svc.stop()


def test_from_reference_tiered_checkpoint_restores_bitwise(tmp_path):
    """A checkpoint the reference's ``TieredTable.save`` wrote (its
    directory, both tiers and adam's three leaves a tier), converted by
    ``from_reference``, restores into the port bitwise; the restored
    table then follows the reference's moves."""
    import ps_tpu.checkpoint as ref_ckpt

    ref = _ref("adam", admit_freq=2, learning_rate=0.1)
    for ids, grads in _stream(14):
        ref.push(ids, grads)
    assert ref.promotions > 0
    ref.save(str(tmp_path / "ref"))
    meta = ref_ckpt.read_meta(str(tmp_path / "ref"))
    abstract = {
        "hot_table": ref_ckpt.abstract_like(ref.hot.table),
        "hot_opt": ref_ckpt.abstract_like(
            ref_ckpt.flatten_leaves(ref.hot.state())),
        "arena": ref_ckpt.abstract_like(ref.arena),
        "cold_opt": {f"{i:05d}": ref_ckpt.abstract_like(leaf)
                     for i, leaf in enumerate(ref.cold_state)},
        **{k: ref_ckpt.abstract_like(getattr(ref, a)) for k, a in (
            ("dir_tier", "tier"), ("dir_slot", "slot"),
            ("dir_freq", "freq"), ("dir_ref", "ref"),
            ("dir_last_ms", "last_ms"), ("slot_to_id", "slot_to_id"))}}
    arrays = jax.tree_util.tree_map(np.asarray, ref_ckpt.restore(
        str(tmp_path / "ref"), abstract, meta))
    out_meta = ckpt.from_reference(arrays, meta, str(tmp_path / "port"))
    assert out_meta["engine"] == "tiered"
    t = _make("adam", admit_freq=2, learning_rate=0.1)
    t.restore(str(tmp_path / "port"))
    _same_directory(t, ref)
    np.testing.assert_array_equal(t.last_ms, ref.last_ms)
    assert (t.dir_gen, t.push_count, t.promotions) == (
        ref.dir_gen, ref.push_count, ref.promotions)
    np.testing.assert_array_equal(t.hot.table.numpy(),
                                  np.asarray(ref.hot.table))
    np.testing.assert_array_equal(t.arena.numpy(), ref.arena)
    ref_hot = jax.tree_util.tree_leaves(ref.hot.state())
    for mine, theirs in zip(ckpt.flatten_leaves(t.hot.state()).values(),
                            ref_hot):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for mine, theirs in zip(t.cold_state, ref.cold_state):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    # both go on from the same state with the reference's moves
    for ids, grads in _stream(4, seed=9):
        ref.push(ids, grads)
        t.push(ids, grads, moves=ref.pop_moves())
    _same_directory(t, ref)
    np.testing.assert_allclose(_all_rows(t), _all_rows(ref),
                               rtol=ADAM_RTOL, atol=ADAM_ATOL)


# -- the service surface ---------------------------------------------------------


def _push_all(svc, stream):
    for i, (ids, grads) in enumerate(stream):
        svc._apply_push(0, {"emb": {"ids": ids, "grads": grads}},
                        extra={"pseq": i + 1, "pnonce": "n0", "pfan": [0]})


def test_service_stats_and_invalidation_carry_tier_state():
    t = _make(admit_freq=2)
    svc = SparsePSService({"emb": t})
    try:
        _push_all(svc, _stream(10))
        kind, _, _, ex = tv.decode(svc._handle(tv.STATS, 0, {}, {}))
        assert kind == tv.OK
        st = ex["tier"]["emb"]
        assert st == t.tier_stats() and st["promotions"] > 0
        assert st["device_rows"] == BUDGET and st["hit_rate"] is not None
        # the cold passes' latencies, drained after every apply
        assert svc.transport.latency_quantiles()["cold_gather_s"][
            "count"] == 10
        assert t.drain_cold_gather() == []
        # move logs harvested a push, not left to pile up
        assert t.last_moves == {"ops": [], "hand": None}
    finally:
        svc.stop()


def test_service_serves_a_tiered_table_as_its_oracle():
    """Over the wire, two shards: a worker's pushes and pulls on tiered
    shards equal an untiered table's bitwise on the CPU, and each shard's
    pushes reach it as host arrays of their own."""
    totals = {"emb": V}
    tables = [TieredTable(V // 2, D, "adagrad", device_rows=BUDGET // 2,
                          admit_freq=2) for _ in range(2)]
    for s, t in enumerate(tables):
        t.init(_table0()[s * V // 2:(s + 1) * V // 2])
    seen = []
    push = tables[0].push

    def spy(ids, grads, moves=None):
        seen.append((type(ids), type(grads)))
        return push(ids, grads, moves=moves)

    tables[0].push = spy
    svcs = [SparsePSService({"emb": t}, shard=s, num_shards=2,
                            total_rows=totals) for s, t in enumerate(tables)]
    u = _untiered()
    w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs), 0,
                       {"emb": (V, D)})
    try:
        for c, (ids, grads) in enumerate(_stream(12)):
            if c % 2:
                got = w.push_pull({"emb": (ids, grads)}, {"emb": ids})
            else:
                got = w.pull({"emb": ids})
                w.push({"emb": (ids, grads)})
            assert got["emb"].shape == (ids.size, D)
            u.push(*_dedupe(ids, grads))
        full = w.pull({"emb": np.arange(V, dtype=np.int32)})["emb"].numpy()
        np.testing.assert_array_equal(full, u.table.numpy())
        assert sum(t.promotions for t in tables) > 0
        assert seen and all(k == (np.ndarray, np.ndarray) for k in seen)
    finally:
        w.close()
        for s in svcs:
            s.stop()


def test_service_prefetches_before_the_apply_lock():
    t = _make(admit_freq=2, prefetch=True)
    svc = SparsePSService({"emb": t})
    held = []
    prefetch = t.prefetch

    def spy(ids):
        held.append(svc._lock.locked())
        prefetch(ids)

    t.prefetch = spy
    try:
        stream = _stream(6)
        _push_all(svc, stream)
        assert held == [False] * 6  # each before the lock was taken
        u = _make(admit_freq=2)
        for ids, grads in stream:
            u.push(ids, grads)
        np.testing.assert_array_equal(_all_rows(t), _all_rows(u))
    finally:
        svc.stop()


def test_service_invalidation_carries_moved_rows():
    """A CLOCK victim lies outside the push's id-set: its tag joins the
    apply's, so a cached read of it drops."""
    from ps_tpu_torch.backends.remote_sparse import _row_tags, _table_hash

    t = _make(admit_freq=1)
    svc = SparsePSService({"emb": t})
    tags = []
    svc._invalidate_reads = lambda tags_=None, **kw: tags.append(
        kw.get("tags", tags_))
    try:
        ids = np.array([BUDGET + 5], np.int32)  # cold: promotes, evicts
        _push_all(svc, [(ids, np.ones((1, D), np.float32))])
        assert (t.promotions, t.evictions) == (1, 1)
        # the CLOCK victim: the first slot's row (its ref bit never set)
        assert t.tier[0] == 0 and t.tier[BUDGET + 5] == 1
        want = _row_tags(_table_hash("emb"), np.array([BUDGET + 5, 0]))
        assert set(tags[-1]) == want
    finally:
        svc.stop()


def test_tiered_conditional_delta_after_tier_moves():
    """A tier move is a change: after pushes that promote and evict rows
    of a held read, the conditional read's merged rows are bitwise a full
    pull (the contract of the reference's test_read_path)."""
    t = TieredTable(64, 8, "adagrad", device_rows=8, admit_freq=1)
    t.init(np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32))
    svc = SparsePSService({"emb": t})
    w = connect_sparse(f"127.0.0.1:{svc.port}", 0, {"emb": (64, 8)})
    try:
        ids = np.arange(0, 16, dtype=np.int32)
        r1 = w.read_rows({"emb": ids})["emb"].numpy()
        rng = np.random.default_rng(7)
        for _ in range(6):
            bids = rng.integers(0, 64, size=12).astype(np.int32)
            w.push({"emb": (bids, rng.normal(size=(12, 8)).astype(
                np.float32) * 0.1)})
        assert t.promotions + t.evictions > 0
        r2 = w.read_rows({"emb": ids})["emb"].numpy()
        assert svc.transport.read_delta_rows > 0  # a delta, not a full read
        full = w.pull({"emb": ids})["emb"].numpy()
        np.testing.assert_array_equal(r2, full)
        assert not np.array_equal(r2, r1)
    finally:
        w.close()
        svc.stop()


# -- across ranks ------------------------------------------------------------------


def _global_push(ids, grads, k):
    """The one-process push of what k ranks push: each rank's slice
    padded as ``tests/test_torch_ranks_harness.py`` pads it."""
    pad = (-len(ids)) % k
    return (np.concatenate([ids, np.full(pad, -1, np.int32)]),
            np.concatenate([grads, np.zeros((pad, D), np.float32)]))


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_two_ranks_match_one_process(optimizer, tmp_path):
    """Two gloo ranks, each pushing its half of every push: rank 0's move
    logs, the replicated directory and arena, the gathered hot tier and
    the row sum equal one process's on the whole pushes, bitwise; the
    ranks' pulls too; a 2-rank save restores into 2 ranks bitwise."""
    k = 2
    stream = _stream(12, batch=15)
    pull_ids = np.arange(0, V, 3, dtype=np.int32)[:30]
    kw = dict(num_rows=V, dim=D, budget=BUDGET, optimizer=optimizer,
              opt_kw={"learning_rate": 0.1}, table=_table0(),
              pushes=stream, admit_freq=2, pull_ids=pull_ids,
              path=str(tmp_path / "ck"))
    res = torch_ranks.run_ranks(k, [("tiered_pushes", kw)], tmp_path)
    one = TieredTable(V, D, optimizer, device_rows=BUDGET, admit_freq=2,
                      learning_rate=0.1)
    one.init(_table0())
    logs = []
    for ids, grads in stream:
        one.push(*_global_push(ids, grads, k))
        logs.append(one.pop_moves())
    assert one.promotions > 0 and one.evictions > 0
    want_hot, want_state = one.hot.export_rows(np.arange(BUDGET))
    for r in range(k):
        got = res[r][0]
        assert got["logs"] == logs, r
        assert {"all_gather", "broadcast", "all_reduce"} <= set(got["ops"])
        for a in DIRECTORY:
            np.testing.assert_array_equal(got["dir"][a], getattr(one, a))
        assert (got["hand"], got["dir_gen"]) == (one.hand, one.dir_gen)
        np.testing.assert_array_equal(got["hot"], want_hot)
        for a, b in zip(got["hot_state"], want_state):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["arena"], one.arena.numpy())
        for a, b in zip(got["cold_state"], one.cold_state):
            np.testing.assert_array_equal(a, b.numpy())
        assert got["row_sum"] == one.row_sum()
        np.testing.assert_array_equal(got["row_version"], one.row_version)
        assert got["counters"] == [one.hot_hits, one.misses, one.promotions,
                                   one.evictions, one.push_count,
                                   one.rows_pushed]
        rest = got["restored"]
        for a in DIRECTORY:
            np.testing.assert_array_equal(rest["dir"][a], got["dir"][a])
        np.testing.assert_array_equal(rest["hot"], got["hot"])
        np.testing.assert_array_equal(rest["arena"], got["arena"])
    pulled = np.concatenate([res[r][0]["pulled"] for r in range(k)])
    np.testing.assert_array_equal(pulled, _all_rows(one)[pull_ids])
