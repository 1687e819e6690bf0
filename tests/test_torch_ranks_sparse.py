"""Row-sharded sparse tables across k gloo ranks on the CPU, against the
reference (``tests/test_sparse.py``).

The reference's own ``SparseEmbedding.apply`` fails on this jax (its
``shard_map(check_rep=...)``, ROADMAP Queue 3 R1), so the exchanges are
held to the reference's shard_map-free parts: a k-rank ``gather`` push
equals one reference ``fused_sparse_apply`` (jax tier) over the whole
table with every rank's ids and grads concatenated (rtol 1e-6); the
port's ``_a2a_route`` on each rank equals the reference's ``_a2a_route``
on that device, run inside a ``shard_map`` this file writes (ids, grads
and dropped counts exactly); byte counts equal the reference's
``_account_push`` formula. The W&D composite step across ranks equals
the one-process port within ``tests/test_sparse.py:220-225``'s
tolerances (loss rtol 1e-5, tables and parameters 1e-4 / 1e-6).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import criteo_batches
from ps_tpu.kv import sparse as ref_sparse
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models import wide_deep as ref_wd
from ps_tpu.ops.sparse_apply import fused_sparse_apply as ref_apply
from ps_tpu.optim.rowwise import make_rowwise as ref_rowwise
from ps_tpu.parallel.mesh import make_mesh as ref_make_mesh

try:
    from jax import shard_map
except ImportError:  # older jax keeps it in experimental
    from jax.experimental.shard_map import shard_map

K = 4
V, D = 96, 4
RULES = {"sgd": {"learning_rate": 1.0}, "adagrad": {"learning_rate": 0.1},
         "adam": {"learning_rate": 0.1}}


def _table0(rows=V):
    return np.random.default_rng(0).normal(size=(rows, D)).astype(np.float32)


def _push(seed, n=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, n).astype(np.int32) * 8  # duplicates, spread
    grads = rng.normal(size=(n, D)).astype(np.float32)
    return ids, grads


def _sparse_case(optimizer, pushes, **kw):
    return ("sparse_pushes", dict(num_rows=kw.pop("num_rows", V), dim=D,
                                  optimizer=optimizer,
                                  opt_kw=RULES[optimizer],
                                  table=kw.pop("table", _table0()),
                                  pushes=pushes, **kw))


OVERFLOW_IDS = np.random.default_rng(5).integers(0, V, 32).astype(np.int32)
OVERFLOW_GRADS = np.random.default_rng(6).normal(
    size=(32, D)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pushes = [_push(1), _push(2)]
    cases = [_sparse_case(rule, pushes, pull_ids=np.arange(0, 96, 3,
                                                           dtype=np.int32))
             for rule in RULES]
    cases += [
        _sparse_case("adagrad", pushes, exchange="a2a",
                     capacity_factor=float(K)),
        _sparse_case("sgd", [(np.zeros(16, np.int32),
                              np.ones((16, D), np.float32))],
                     exchange="a2a", capacity_factor=1.0),
        ("a2a_route", dict(ids=OVERFLOW_IDS, grads=OVERFLOW_GRADS,
                           rows_per_shard=V // K, capacity_factor=0.5)),
        _sparse_case("sgd", [(np.asarray([0, 1, 1, 1] * K, np.int32),
                              np.ones((4 * K, D), np.float32))],
                     exchange="a2a", capacity_factor=1.0),
        _sparse_case("sgd", [(np.full(8, 96, np.int32),
                              np.ones((8, D), np.float32))],
                     num_rows=97, table=np.zeros((97, D), np.float32)),
        _sparse_case("adam", [(np.array([4, 4, 11, 60, 4, 4, 11, 60],
                                        np.int32),
                               np.ones((8, D), np.float32))] * 2),
        _sparse_case("adagrad", [(np.arange(6, dtype=np.int32),
                                  np.ones((6, D), np.float32))]),
    ]
    return torch_ranks.run_ranks(K, cases, tmp_path_factory.mktemp("sparse"))


def _case(ranks, i):
    return [r[i] for r in ranks]


def _ref_bytes(n_ids, exchange, capacity_factor=2.0, k=K, dim=D):
    """The reference's own ``_account_push`` arithmetic."""
    stub = types.SimpleNamespace(k=k, dim=dim, exchange=exchange,
                                 capacity_factor=capacity_factor,
                                 rows_pushed=0, collective_bytes=0)
    ref_sparse.SparseEmbedding._account_push(stub, n_ids)
    return stub.collective_bytes


def _ref_pushes(rule, pushes, table=None):
    opt = ref_rowwise(rule, **RULES[rule])
    t = jnp.asarray(_table0() if table is None else table)
    s = opt.init(t)
    for ids, grads in pushes:
        t, s = ref_apply(t, s, jnp.asarray(ids), jnp.asarray(grads), opt,
                         "jax")
    return np.asarray(t)


@pytest.mark.parametrize("case,rule", [(0, "sgd"), (1, "adagrad"),
                                       (2, "adam")])
def test_gather_push_equals_one_reference_apply(ranks, case, rule):
    want = _ref_pushes(rule, [_push(1), _push(2)])
    for r in _case(ranks, case):
        np.testing.assert_allclose(r["table"], want, rtol=1e-6, atol=1e-7)
        assert r["dropped"] == 0 and r["rows_pushed"] == 80
        assert r["collective_bytes"] == 2 * _ref_bytes(40, "gather")
        assert r["local_rows"] == V // K


def test_pull_returns_current_rows_from_their_owners(ranks):
    want = _ref_pushes("sgd", [_push(1), _push(2)])
    pull_ids = np.arange(0, 96, 3)
    for rank, r in enumerate(_case(ranks, 0)):
        mine = pull_ids[rank * 8:(rank + 1) * 8]
        np.testing.assert_array_equal(r["pulled"], want[mine])


def test_a2a_lossless_matches_gather(ranks):
    gather = _case(ranks, 1)[0]["table"]
    for r in _case(ranks, 3):
        np.testing.assert_allclose(r["table"], gather, rtol=1e-6)
        assert r["dropped"] == 0
        assert r["collective_bytes"] == 2 * _ref_bytes(40, "a2a", float(K))


def test_a2a_duplicates_merge_before_routing(ranks):
    """Four pushes of row 0 a rank merge into one routed row: lossless at
    capacity factor 1."""
    for r in _case(ranks, 4):
        assert r["dropped"] == 0
        np.testing.assert_allclose(r["table"][0], _table0()[0] - 16.0,
                                   rtol=1e-6)


def test_a2a_overflow_drops_what_the_reference_drops(ranks):
    """Capacity factor 0.5: each rank's buckets, the rows they receive and
    the raw updates they drop equal the reference's ``_a2a_route`` on the
    same device, exactly."""
    mesh = ref_make_mesh({"data": K})
    rps, cf = V // K, 0.5

    def route(ids, grads):
        rid, rg, dropped = ref_sparse._a2a_route(ids, grads, K, "data", rps,
                                                 cf)
        return rid, rg, dropped.reshape(1)

    fn = jax.jit(shard_map(route, mesh=mesh,
                           in_specs=(P("data"), P("data", None)),
                           out_specs=(P("data"), P("data", None),
                                      P("data"))))
    rid, rg, dropped = (np.asarray(x) for x in fn(
        jnp.asarray(OVERFLOW_IDS), jnp.asarray(OVERFLOW_GRADS)))
    got = _case(ranks, 5)
    n = rid.shape[0] // K
    assert sum(r["dropped"] for r in got) == int(dropped.sum()) > 0
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["ids"], rid[rank * n:(rank + 1) * n])
        np.testing.assert_array_equal(r["grads"],
                                      rg[rank * n:(rank + 1) * n])
        assert r["dropped"] == int(dropped[rank])


def test_a2a_dropped_counts_raw_updates(ranks):
    """Each rank: id 0 once, id 1 three times; capacity 1 keeps id 0 and
    drops the merged id-1 row, 3 raw updates a rank, summed over ranks."""
    for r in _case(ranks, 6):
        assert r["dropped"] == 3 * K and r["rows_pushed"] == 4 * K
        np.testing.assert_allclose(_table0()[0] - r["table"][0],
                                   np.full(D, float(K)), rtol=1e-6)
        np.testing.assert_allclose(r["table"][1], _table0()[1], rtol=1e-6)


def test_padded_rows_reachable_boundary(ranks):
    """97 rows over 4 ranks pad to 100: the last real row lives on rank 3
    and takes its updates."""
    for r in _case(ranks, 7):
        assert r["padded_rows"] == 100 and r["local_rows"] == 25
        np.testing.assert_allclose(r["table"][96], -8.0 * np.ones(D))
        assert r["table"].shape == (97, D)


def test_lazy_adam_freezes_untouched_rows(ranks):
    ids = np.array([4, 4, 11, 60])
    for r in _case(ranks, 8):
        untouched = np.setdiff1d(np.arange(V), ids)
        np.testing.assert_array_equal(r["table"][untouched],
                                      _table0()[untouched])
        for row, mult in [(4, 4.0), (11, 2.0), (60, 2.0)]:
            m = v = 0.0
            x = _table0()[row].astype(np.float64)
            for t in (1, 2):
                m = 0.9 * m + 0.1 * mult
                v = 0.999 * v + 0.001 * mult * mult
                x = x - 0.1 * (m / (1 - 0.9 ** t)) / (
                    np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
            np.testing.assert_allclose(r["table"][row], x, rtol=1e-5,
                                       atol=1e-5)


def test_push_pads_uneven_id_lists_with_filler(ranks):
    """6 ids over 4 ranks: 2, 2, 2 and 0 before padding to 2 each with -1;
    the filler touches no row and stamps no row_version."""
    want = _ref_pushes("adagrad", [(np.arange(6, dtype=np.int32),
                                    np.ones((6, D), np.float32))])
    for r in _case(ranks, 9):
        np.testing.assert_allclose(r["table"], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["row_version"][:6], 1)
        assert not r["row_version"][6:].any()
        assert r["rows_pushed"] == 8


# -- the Wide-&-Deep composite step across ranks --------------------------------

VOCAB, EMB, MLP = 50, 8, (32, 16)


def _wd_inputs(steps, seed, batch=16):
    cfg = ref_wd.WideDeepConfig(per_feature_vocab=VOCAB, embed_dim=EMB,
                                mlp=MLP)
    model = ref_wd.WideDeep(cfg)
    rows_shape = (batch, cfg.num_sparse, EMB)
    dense0 = next(criteo_batches(batch, vocab_size=VOCAB, seed=7))["dense"]
    params = model.init(jax.random.key(0), jnp.asarray(dense0),
                        jnp.zeros(rows_shape),
                        jnp.zeros(rows_shape[:2] + (1,)))["params"]
    flat, _ = ref_flatten(params)
    rng = np.random.default_rng(1)
    deep = (0.01 * rng.normal(size=(cfg.total_rows, EMB))).astype(np.float32)
    wide = (0.01 * rng.normal(size=(cfg.total_rows, 1))).astype(np.float32)
    batches = list(criteo_batches(batch, vocab_size=VOCAB, seed=seed,
                                  steps=steps))
    return dict(params={k: np.asarray(v) for k, v in flat.items()},
                deep_table=deep, wide_table=wide, batches=batches)


def _one_process(inputs, **kw):
    """The same composite step in this process, one rank."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        return torch_ranks.case_widedeep_steps(0, 1, **inputs, **kw)
    finally:
        ps_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def wd_ranks(tmp_path_factory):
    parity = _wd_inputs(3, seed=3)
    train = _wd_inputs(25, seed=0)
    cases = [("widedeep_steps", dict(parity, exchange="gather")),
             ("widedeep_steps", dict(parity, exchange="a2a",
                                     capacity_factor=2.0)),
             ("widedeep_steps", dict(train, exchange="a2a",
                                     capacity_factor=2.0))]
    return torch_ranks.run_ranks(2, cases, tmp_path_factory.mktemp("wd"))


@pytest.mark.parametrize("case", [0, 1], ids=["gather", "a2a"])
def test_widedeep_composite_shard_parity(wd_ranks, case):
    """The composite step on 2 ranks == in one process
    (tests/test_sparse.py:220-225's tolerances)."""
    one = _one_process(_wd_inputs(3, seed=3))
    for r in _case(wd_ranks, case):
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for name in ("deep", "wide"):
            np.testing.assert_allclose(r[name], one[name], rtol=1e-4,
                                       atol=1e-6)
        for key, want in one["params"].items():
            np.testing.assert_allclose(r["params"][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
        assert r["dropped"] == 0
        n_ids = 16 * 26  # the global batch's ids a step
        assert r["rows_pushed"] == 3 * n_ids
        assert r["sparse_collective_bytes"] == 3 * _ref_bytes(
            n_ids, ("gather", "a2a")[case], 2.0, k=2, dim=EMB)
        assert r["collective_bytes"] > 0 == one["collective_bytes"]


def test_widedeep_composite_training_decreases_loss(wd_ranks):
    for r in _case(wd_ranks, 2):
        losses = r["losses"]
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses
    assert _case(wd_ranks, 2)[0]["losses"] == _case(wd_ranks, 2)[1]["losses"]
