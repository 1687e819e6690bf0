"""The async DC-ASGD server (config 5) across k gloo ranks on the CPU,
against the reference's ``AsyncTpuServer`` on its k-device mesh
(``tests/test_async_tpu.py``, and the async cases of
``tests/test_checkpoint.py``).

A logical worker's push is this rank's gradient; the server applies its
mean over the ranks, so a push of the same global gradient on every rank
is that gradient, which is how the reference's one controller pushes it.
Under 'replicated' every rank applies the whole tree; under 'sharded'
each rank corrects and steps the slices it owns, against the same slices
of the pusher's stale snapshot, and all-gathers them. Held at k = 2 and 4
under both placements, each group running every case in order:

- the protocol, the DC math and ``make_async_step`` against the
  reference's mesh (rtol 1e-6 / atol 1e-7, the reference's own bound),
  versions, ``worker_version``, ``staleness_hist`` and ``apply_count``
  exactly, every rank's parameters bitwise equal;
- ``collective_bytes`` equal to the reference's (the all-reduce bytes of
  the pushed keys) and ``mesh.calls`` what the port ran;
- sharded LAMB on the async engine against the reference's;
- the mode guards, and host threads refused on every rank;
- the checkpoint at 2 ranks: saved and restored at 2 ranks bitwise, the
  strict restore into another worker count refused, the elastic remap 3
  -> 2 and 3 -> 4 workers against the reference's on its 2-device mesh,
  and a 2-rank save restored with ``elastic=True`` into one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models.mlp import MLP, cross_entropy_loss

KS = (2, 4)
PLACEMENTS = ("replicated", "sharded")
LAM, LR, HIDDEN = 0.04, 0.1, 16
TOL = {"rtol": 1e-6, "atol": 1e-7}
TRAIN_HIDDEN, TRAIN_STEPS, TRAIN_BATCH = 64, 40, 64
LAMB = {"learning_rate": 1e-3, "weight_decay": 0.01}


def _np_flat(tree):
    flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, tree))
    return {k: np.asarray(v) for k, v in flat.items()}


def _params(hidden=HIDDEN):
    model = MLP(hidden=hidden)
    return model, jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), params)


def _train_batches():
    streams = [mnist_batches(TRAIN_BATCH, seed=0, worker=w, num_workers=2,
                             steps=TRAIN_STEPS) for w in range(2)]
    return [[next(s) for s in streams] for _ in range(TRAIN_STEPS)]


def _cases():
    _, params = _params()
    _, big = _params(TRAIN_HIDDEN)
    grads = [_grads_like(params, s) for s in (1, 2, 3)]
    dc = [_grads_like(params, s) for s in (10, 11)]
    cases = []
    for placement in PLACEMENTS:
        common = dict(params=params, placement=placement, hidden=HIDDEN)
        cases += [
            ("async_protocol", dict(common, grads=grads)),
            ("async_dc_math", dict(common, grads=dc)),
            ("async_versions", dict(common, grad=_grads_like(params, 4))),
            ("async_trains", dict(common, params=big, hidden=TRAIN_HIDDEN,
                                  batches=_train_batches())),
            ("async_protocol", dict(common, grads=grads, optimizer="lamb",
                                    opt_kw=LAMB)),
        ]
    cases += [("async_guards", dict(params=params, hidden=HIDDEN)),
              ("async_threads", dict(params=params, hidden=HIDDEN,
                                     grad=grads[0]))]
    return cases


CASE = {(name, p): 5 * i + j for i, p in enumerate(PLACEMENTS)
        for j, name in enumerate(("protocol", "dc_math", "versions",
                                  "trains", "lamb"))}
GUARDS, THREADS = 10, 11

ASYNC_INIT = {"mode": "async", "num_workers": 3, "dc_lambda": LAM}


@pytest.fixture(scope="module", params=KS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    return k, torch_ranks.run_ranks(k, _cases(),
                                    tmp_path_factory.mktemp(f"async{k}"),
                                    init=ASYNC_INIT)


def _case(out, name, placement=None):
    i = {"guards": GUARDS, "threads": THREADS}.get(name)
    return [r[CASE[(name, placement)] if i is None else i] for r in out]


def _ref_store(k, placement, num_workers=3, optimizer="sgd", opt_kw=None,
               hidden=HIDDEN):
    ps_tpu.init(backend="tpu", mode="async", num_workers=num_workers,
                dc_lambda=LAM, mesh_shape={"data": k})
    store = ps_tpu.KVStore(optimizer=optimizer, mode="async",
                           placement=placement,
                           **(opt_kw or {"learning_rate": LR}))
    store.init(_params(hidden)[1])
    return store


def _ref_counters(store):
    eng = store._engine
    return {"version": eng.version, "staleness_hist": dict(
        eng.staleness_hist), "apply_count": dict(eng.apply_count),
        "worker_version": dict(eng._worker_version),
        "collective_bytes": store.collective_bytes}


def _ref_protocol(k, placement, optimizer="sgd", opt_kw=None):
    _, params = _params()
    g0, g1a, g1b = (jax.tree_util.tree_map(jnp.asarray,
                                           _grads_like(params, s))
                    for s in (1, 2, 3))
    store = _ref_store(k, placement, optimizer=optimizer, opt_kw=opt_kw)
    try:
        store.pull_all(worker=0)
        store.push_all(g1a, worker=1)
        store.push_all(g1b, worker=1)
        store.push_all(g0, worker=0)
        return _np_flat(store.pull_all(worker=0)), _ref_counters(store)
    finally:
        ps_tpu.shutdown()


def _same_counters(r, want):
    for key, v in want.items():
        assert r[key] == v, (key, r[key], v)


def _bitwise_across_ranks(results, part="params"):
    for r in results[1:]:
        for key, v in results[0][part].items():
            np.testing.assert_array_equal(r[part][key], v, err_msg=key)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_protocol_matches_reference_mesh(ranks, placement):
    k, out = ranks
    want, counters = _ref_protocol(k, placement)
    got = _case(out, "protocol", placement)
    for r in got:
        for key, w in want.items():
            np.testing.assert_allclose(r["params"][key], w, err_msg=key,
                                       **TOL)
        _same_counters(r, counters)
        assert r["applies"] == 3 * len(want)
    _bitwise_across_ranks(got)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_collectives_run_and_counted(ranks, placement):
    """``collective_bytes`` is the reference's count (an all-reduce of the
    pushed keys, 3 pushes); ``mesh.calls`` is what the port ran: one flat
    all-reduce a push ('replicated'), or a reduce-scatter and an
    all-gather a sliced key and one all-reduce of the whole keys."""
    k, out = ranks
    _, counters = _ref_protocol(k, placement)
    _, params = _params()
    sizes = {key: v.size for key, v in _np_flat(params).items()}
    for r in _case(out, "protocol", placement):
        assert r["collective_bytes"] == counters["collective_bytes"] > 0
        ops = [(op, shape) for op, shape, _, _ in r["calls"]]
        sliced = [key for key, d in r["dims"].items() if d is not None]
        if placement == "replicated":
            assert not sliced
            assert ops == [("all_reduce", (sum(sizes.values()),))] * 3
            continue
        assert sliced
        whole = sum(n for key, n in sizes.items() if key not in sliced)
        per_push = sorted(
            [("reduce_scatter", key) for key in sliced]
            + [("all_gather", key) for key in sliced]
            + ([("all_reduce", whole)] if whole else []))
        assert len(ops) == 3 * len(per_push)
        assert sorted(op for op, _ in ops) == sorted(
            op for op, _ in per_push * 3)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_dc_correction_math(ranks, placement):
    """One stale push applies g + λ·g⊙g⊙(w_now − w_stale) (float64
    oracle, the reference test's bounds)."""
    _, params = _params()
    g0 = _np_flat(_grads_like(params, 11))
    for r in _case(ranks[1], "dc_math", placement):
        for key, g in g0.items():
            wn, ws = r["w_now"][key], r["w_stale"][key]
            want = wn - LR * (g + LAM * g * g * (wn - ws))
            np.testing.assert_allclose(r["got"][key], want, rtol=1e-5,
                                       atol=2e-6, err_msg=key)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_version_and_staleness(ranks, placement):
    for r in _case(ranks[1], "versions", placement):
        assert r["seen"] == [0, 2, 2, 0]


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_make_async_step_trains_as_the_reference(ranks, placement):
    """``test_make_async_step_trains``: 2 workers round-robin, each rank on
    its slice of a worker's global batch; the losses returned are the
    global batch's. The reference's criteria (staleness 1, the loss falls
    by 1.0) and its run on its mesh: versions and staleness exactly,
    losses and parameters within 1e-5 (80 cycles of gradients meaned over
    another number of slices)."""
    k, out = ranks
    model, _ = _params(TRAIN_HIDDEN)
    store = _ref_store(k, placement, num_workers=3, hidden=TRAIN_HIDDEN)
    try:
        def loss_fn(p, batch):
            images, labels = batch
            return cross_entropy_loss(model.apply({"params": p}, images),
                                      labels)

        run = store.make_async_step(loss_fn)
        losses = [float(run((jnp.asarray(i), jnp.asarray(l)), worker=w))
                  for step in _train_batches()
                  for w, (i, l) in enumerate(step)]
        want, counters = _np_flat(store.params()), _ref_counters(store)
    finally:
        ps_tpu.shutdown()
    got = _case(out, "trains", placement)
    for r in got:
        assert r["staleness"] == 1
        assert np.mean(r["losses"][-6:]) < np.mean(r["losses"][:6]) - 1.0
        _same_counters(r, counters)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        for key, w in want.items():
            np.testing.assert_allclose(r["params"][key], w, rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    _bitwise_across_ranks(got)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_lamb_on_the_async_engine_matches_reference(ranks, placement):
    """Sharded LAMB serves the async engine too: its trust ratio's norms
    reduce over the ranks' slices."""
    k, out = ranks
    want, counters = _ref_protocol(k, placement, "lamb", LAMB)
    got = _case(out, "lamb", placement)
    for r in got:
        for key, w in want.items():
            np.testing.assert_allclose(r["params"][key], w, rtol=2e-4,
                                       atol=1e-5, err_msg=key)
        _same_counters(r, counters)
        sliced = sum(d is not None for d in r["dims"].values())
        norms = [c for c in r["calls"] if c[0] == "all_reduce"
                 and c[1] == (sliced,)]
        # one flat norm all-reduce a push, of every sliced key's Σu²
        assert norms == [("all_reduce", (sliced,), 4 * sliced,
                          2 * 4 * sliced * (k - 1) // k)] * (
                              3 if placement == "sharded" else 0)
    _bitwise_across_ranks(got)


def test_mode_guards_across_ranks(ranks):
    for r in _case(ranks[1], "guards"):
        assert "make_async_step" in r["async"]
        assert "mode='async'" in r["sync"]


def test_host_threads_across_ranks_are_refused(ranks):
    """A second host thread's pull raises at once on every rank, naming
    why; the first thread's push then runs on every rank."""
    for r in _case(ranks[1], "threads"):
        assert not r["alive"]
        assert len(r["errors"]) == 1 and "one thread" in r["errors"][0]
        assert "pair different pushes" in r["errors"][0]
        assert r["version"] == 1


# -- the async checkpoint across ranks -----------------------------------------


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    """At 2 ranks, 'sharded': 3 workers save and go on; the same restored
    at 2 ranks; a strict restore into 2 workers refused and an elastic one
    (3 -> 2); an elastic restore into 4 workers (3 -> 4)."""
    tmp = tmp_path_factory.mktemp("async_ckpt")
    _, params = _params()
    path = str(tmp / "ckpt")
    common = dict(params=params, placement="sharded", hidden=HIDDEN,
                  path=path, grads=[_grads_like(params, s)
                                    for s in range(1, 7)])
    first = torch_ranks.run_ranks(2, [("async_ckpt", dict(common, save=True))],
                                  tmp, init=ASYNC_INIT)
    runs = {"first": first}
    for name, nw, modes in (("same", 3, ("strict",)),
                            ("shrunk", 2, ("strict", "elastic")),
                            ("grown", 4, ("elastic",))):
        runs[name] = torch_ranks.run_ranks(
            2, [("async_ckpt", dict(common, restore=m)) for m in modes], tmp,
            init=dict(ASYNC_INIT, num_workers=nw))
    return runs, path, common


def _ref_remap(num_workers, tmp_path):
    """The reference's remap on its 2-device mesh ('sharded'): the same
    pushes, a save, an elastic restore into ``num_workers`` workers and
    the same continuation as the harness's ``async_ckpt``."""
    _, params = _params()
    grads = [jax.tree_util.tree_map(jnp.asarray, _grads_like(params, s))
             for s in range(1, 7)]
    path = str(tmp_path / f"ref{num_workers}")
    store = _ref_store(2, "sharded")
    try:
        for w in range(3):
            store.pull_all(worker=w)
            store.push_all(grads[w], worker=w)
        store.save(path)
    finally:
        ps_tpu.shutdown()
    store = _ref_store(2, "sharded", num_workers=num_workers)
    try:
        store.restore(path, elastic=True)
        versions = dict(store._engine._worker_version)
        store.push_all(grads[3], worker=1)
        store.push_all(grads[4], worker=0)
        if num_workers > 3:
            store.pull_all(worker=3)
            store.push_all(grads[5], worker=3)
        return versions, _np_flat(store.params()), _ref_counters(store)
    finally:
        ps_tpu.shutdown()


def test_async_checkpoint_round_trips_bitwise_at_two_ranks(ckpt_runs):
    runs, _, _ = ckpt_runs
    first = [r[0] for r in runs["first"]]
    for r in (x[0] for x in runs["same"]):
        for key, v in first[0]["saved"].items():
            np.testing.assert_array_equal(r["restored"][key], v)
        for key, v in first[0]["params"].items():
            np.testing.assert_array_equal(r["params"][key], v)
        for key in ("version", "staleness_hist", "apply_count",
                    "worker_version", "collective_bytes"):
            assert r[key] == first[0][key], key
    _bitwise_across_ranks(first)


@pytest.mark.parametrize("name,num_workers", [("shrunk", 2), ("grown", 4)])
def test_elastic_worker_remap_across_ranks(ckpt_runs, tmp_path, name,
                                           num_workers):
    runs, _, _ = ckpt_runs
    versions, want, counters = _ref_remap(num_workers, tmp_path)
    got = [r[-1] for r in runs[name]]
    if name == "shrunk":
        for r in runs[name]:
            assert "num_workers" in r[0]["refused"]
    for r in got:
        assert r["restored_versions"] == versions
        assert set(r["restored_stale"]) <= set(range(num_workers))
        assert set(r["restored_cache"]) <= set(range(num_workers))
        assert "out of range" in r["out_of_range"]
        if num_workers > 3:
            assert r["new_worker_staleness"] == 0
        for key, w in want.items():
            np.testing.assert_allclose(r["params"][key], w, err_msg=key,
                                       **TOL)
        _same_counters(r, counters)
    _bitwise_across_ranks(got)


def test_two_rank_async_save_restores_elastic_into_one_process(ckpt_runs):
    runs, path, common = ckpt_runs
    first = runs["first"][0][0]
    ps_tpu_torch.init(backend="cuda", device="cpu", **ASYNC_INIT)
    try:
        out = torch_ranks.case_async_ckpt(0, 1, **dict(common,
                                                       restore="elastic"))
    finally:
        ps_tpu_torch.shutdown()
    for key, v in first["saved"].items():
        np.testing.assert_array_equal(out["restored"][key], v)
    for key, v in first["params"].items():
        np.testing.assert_allclose(out["params"][key], v, **TOL)
    assert out["restored_versions"] == first["worker_version"]
    for key in ("version", "staleness_hist", "apply_count"):
        assert out[key] == first[key], key
