"""Checkpoint and resume in the port (``ps_tpu_torch.checkpoint``), on the CPU.

Each one-device case of ``tests/test_checkpoint.py`` has its counterpart
here, at the reference's small size (the MLP at hidden 16, tables 64 × 8):

- resume is bitwise against an uninterrupted run on every engine (local,
  cuda sync, cuda async, local async, sparse sgd/adagrad/adam, bf16);
- a save mid-step, a restore into another tree, engine, optimizer, shape,
  dtype or worker count are refused, and a refused restore leaves the
  engine untouched;
- a resave is crash-safe (a crash between the arrays and the meta leaves
  the previous checkpoint whole) and keeps two generations;
- ``export_rows`` / ``adopt_rows`` / ``adopt_state`` round-trip and refuse
  what the kernel could not take.

Against the reference: the port's resumed run equals the reference's
resumed run from the same numpy init and inputs (sgd bitwise; adam, lamb,
schedules and the DC-ASGD interleaving within rtol 1e-6, atol 1e-7, the
suites' own bounds; the async MLP within 1e-5, as
``tests/test_torch_async.py``), and the cross-framework drill: the
reference trains and saves, the test reads that checkpoint with
``ps_tpu.checkpoint``, ``from_reference`` writes a port checkpoint, and the
port restores it and takes k steps that equal the reference's own k
resumed steps, within the same bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.models.mlp import MLP as RefMLP
from ps_tpu.models.mlp import cross_entropy_loss as ref_xent
from ps_tpu.ops.sparse_apply import fused_sparse_apply as ref_fused_apply
from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch.data.synthetic import mnist_batches
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.models.mlp import MLP, make_loss_fn

ROWS, DIM = 64, 8
TOL = {"rtol": 1e-6, "atol": 1e-7}


@pytest.fixture(autouse=True)
def _fresh():
    ps_tpu_torch.shutdown()
    ps_tpu.shutdown()
    yield
    ps_tpu_torch.shutdown()
    ps_tpu.shutdown()


def _ref_params():
    model = RefMLP(hidden=16)
    params = model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), params)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _equal(a, b):
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(a), _np(b))


def _close(a, b, **tol):
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(x, y, **tol), _np(a), _np(b))


def _port_schedule(count):
    """optax.linear_schedule(0.1, 0.02, transition_steps=3) of the count."""
    frac = 1 - torch.clip(count, 0, 3) / 3
    return (0.1 - 0.02) * frac + 0.02


OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "adam": ("adam", {"learning_rate": 1e-3}),
    "lamb": ("lamb", {"learning_rate": 1e-3, "weight_decay": 0.01}),
    "momentum": ("momentum", {"learning_rate": 0.05, "momentum": 0.9}),
    "adam_schedule": ("adam", {"learning_rate": _port_schedule}),
    "sgd_schedule": ("sgd", {"learning_rate": _port_schedule}),
}
REF_OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "adam": ("adam", {"learning_rate": 1e-3}),
    "lamb": ("lamb", {"learning_rate": 1e-3, "weight_decay": 0.01}),
    "momentum": ("momentum", {"learning_rate": 0.05, "momentum": 0.9}),
    "adam_schedule": ("adam", {"learning_rate": optax.linear_schedule(
        0.1, 0.02, transition_steps=3)}),
    "sgd_schedule": ("sgd", {"learning_rate": optax.linear_schedule(
        0.1, 0.02, transition_steps=3)}),
}


def _port_store(backend, opt="sgd", mode="sync", num_workers=1, params=None):
    ps_tpu_torch.init(backend=backend, device="cpu", mode=mode,
                      num_workers=num_workers, dc_lambda=0.04)
    name, kw = OPTIMIZERS[opt]
    store = ps_tpu_torch.KVStore(optimizer=name, mode=mode, **kw)
    store.init(_ref_params()[1] if params is None else params)
    return store


# -- dense sync ----------------------------------------------------------------


@pytest.mark.parametrize("backend,opt", [
    ("local", "adam"), ("cuda", "adam"), ("local", "adam_schedule"),
    ("cuda", "adam_schedule"), ("cuda", "lamb"), ("local", "momentum"),
])
def test_dense_sync_resume_bit_identical(tmp_path, backend, opt):
    """make_step: 6 steps against 3, save, a fresh context, restore, 3."""
    path = str(tmp_path / "ckpt")
    model = MLP(hidden=16)
    params = model.init(torch.Generator().manual_seed(0))
    loss_fn = make_loss_fn(model)
    batches = list(mnist_batches(16, seed=0, steps=6))

    def fresh():
        store = _port_store(backend, opt, params=params)
        return store, store.make_step(loss_fn)

    store, run = fresh()
    for b in batches:
        _, ref = run(store.shard_batch(b))
    ref = _np(ref)
    ref_state = {k: _np(store.optimizer_state(k)) for k in store.keys()}
    ps_tpu_torch.shutdown()

    store, run = fresh()
    for b in batches[:3]:
        run(store.shard_batch(b))
    store.save(path)
    assert store.step == 3
    ps_tpu_torch.shutdown()

    store, run = fresh()  # the step is built before the restore
    restored = store.restore(path)
    assert store.step == 3
    assert all(t.is_contiguous() and t.device.type == "cpu"
               for t in keymod.flatten_with_keys(restored)[0].values())
    for b in batches[3:]:
        _, resumed = run(store.shard_batch(b))
    _equal(ref, resumed)
    for k in store.keys():
        _equal(ref_state[k], store.optimizer_state(k))
    if opt.endswith("schedule"):  # the count comes back as an int32 0-d
        count = store._engine.optimizer_state(store.keys()[0])
        count = count["schedule_count"]
        assert count.dtype == torch.int32 and count.dim() == 0
        assert int(count) == 6
    apply_count = store._engine.apply_count
    assert apply_count == 6 if backend == "cuda" else set(
        apply_count.values()) == {6}


@pytest.mark.parametrize("backend,opt", [
    ("local", "sgd"), ("cuda", "sgd"), ("local", "adam"), ("cuda", "lamb"),
    ("local", "sgd_schedule"),
])
def test_dense_resume_matches_reference_resume(tmp_path, backend, opt):
    """Both frameworks: 2 pushes, save, restore into a fresh store, 2 more
    pushes, from the same numpy params and gradients."""
    _, params = _ref_params()
    grads = [_grads_like(params, s) for s in range(4)]
    ref_backend = {"local": "local", "cuda": "tpu"}[backend]
    ref_kw = {"mesh_shape": {"data": 1}} if ref_backend == "tpu" else {}

    def ref_store():
        ps_tpu.init(backend=ref_backend, **ref_kw)
        name, kw = REF_OPTIMIZERS[opt]
        store = ps_tpu.KVStore(optimizer=name, **kw)
        store.init(params)
        return store

    store = ref_store()
    for g in grads[:2]:
        store.push_pull(jax.tree_util.tree_map(jnp.asarray, g))
    store.save(str(tmp_path / "ref"))
    ps_tpu.shutdown()
    store = ref_store()
    store.restore(str(tmp_path / "ref"))
    for g in grads[2:]:
        want = store.push_pull(jax.tree_util.tree_map(jnp.asarray, g))
    ps_tpu.shutdown()

    store = _port_store(backend, opt)
    for g in grads[:2]:
        store.push_pull(_t(g))
    store.save(str(tmp_path / "port"))
    ps_tpu_torch.shutdown()
    store = _port_store(backend, opt)
    store.restore(str(tmp_path / "port"))
    for g in grads[2:]:
        got = store.push_pull(_t(g))
    if opt == "sgd":
        _equal(got, want)
    else:
        _close(got, want, **TOL)


def test_mid_step_save_refused(tmp_path):
    _, params = _ref_params()
    g = _grads_like(params, 0)
    cases = [
        # local sync: worker 1 has not pushed yet
        (dict(backend="local", num_workers=2),
         lambda s: s.push_all(_t(g), worker=0)),
        # cuda sync: one key staged of the whole tree
        (dict(backend="cuda"),
         lambda s: s.push("dense1/bias", torch.as_tensor(g["dense1"]["bias"]))),
        # async on either engine: one key staged by worker 0
        (dict(backend="local", mode="async", num_workers=2),
         lambda s: s.push("dense1/bias", torch.as_tensor(g["dense1"]["bias"]))),
        (dict(backend="cuda", mode="async", num_workers=2),
         lambda s: s.push("dense1/bias", torch.as_tensor(g["dense1"]["bias"]))),
    ]
    for kw, partial in cases:
        store = _port_store(**kw)
        partial(store)
        with pytest.raises(RuntimeError, match="mid-"):
            store.save(str(tmp_path / "ckpt"))
        assert not os.path.exists(tmp_path / "ckpt" / "meta.json")
        ps_tpu_torch.shutdown()


@pytest.mark.parametrize("what,match", [
    ("tree", "keys"), ("shape", "shape"), ("engine", "engine"),
    ("optimizer", "optimizer"), ("mode", "mode"),
])
def test_restore_refuses_mismatch(tmp_path, what, match):
    path = str(tmp_path / "ckpt")
    _, params = _ref_params()
    saver = {"engine": dict(backend="cuda"), "mode": dict(backend="local"),
             "optimizer": dict(backend="cuda", opt="adam")}.get(
        what, dict(backend="local"))
    store = _port_store(**saver)
    store.push_pull(_t(_grads_like(params, 0)))
    store.save(path)
    ps_tpu_torch.shutdown()
    other = {"tree": dict(backend="local", params={"only": np.zeros(3)}),
             "shape": dict(backend="local", params=jax.tree_util.tree_map(
                 lambda x: np.zeros(x.shape[::-1], np.float32), params)),
             "engine": dict(backend="cuda", mode="async", num_workers=1),
             "optimizer": dict(backend="cuda", opt="lamb"),
             "mode": dict(backend="local", mode="async")}[what]
    store = _port_store(**other)
    before = _np(store.params())
    with pytest.raises(ValueError, match=match):
        store.restore(path)
    _equal(before, store.params())


def test_refused_restore_leaves_engine_untouched(tmp_path):
    """The worker-count check runs before any change: a store that catches
    the refusal goes on with its own state and counters."""
    path = str(tmp_path / "ckpt")
    _, params = _ref_params()
    store = _port_store("cuda", mode="async", num_workers=3)
    store.push_all(_t(_grads_like(params, 0)), worker=0)
    store.save(path)
    ps_tpu_torch.shutdown()

    store = _port_store("cuda", mode="async", num_workers=2)
    store.pull_all(worker=0)
    store.push_all(_t(_grads_like(params, 1)), worker=1)
    before = _np(store.params())
    eng = store._engine
    counters = (eng.version, eng._applies, dict(eng.staleness_hist),
                dict(eng._worker_version), set(eng._stale))
    with pytest.raises(ValueError, match="num_workers"):
        store.restore(path)
    _equal(before, store.params())
    assert counters == (eng.version, eng._applies, dict(eng.staleness_hist),
                        dict(eng._worker_version), set(eng._stale))
    store.push_all(_t(_grads_like(params, 2)), worker=0)  # still trains
    assert eng.version == 2


def test_resave_is_crash_safe_and_gcs_old_arrays(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt")
    _, params = _ref_params()
    store = _port_store("local")
    store.save(path)
    first = ckpt.read_meta(path)["arrays_dir"]
    store.push_all(_t(_grads_like(params, 0)))
    store.save(path)
    meta = ckpt.read_meta(path)
    assert meta["arrays_dir"] != first
    dirs = sorted(d for d in os.listdir(path) if d.startswith("arrays-"))
    assert dirs == sorted([first, meta["arrays_dir"]])
    saved = _np(store.params())

    # a crash between the arrays write and the meta replace: the new arrays
    # are on disk, the committed checkpoint is still the previous one
    store.push_all(_t(_grads_like(params, 1)))
    real_replace = os.replace

    def crash(src, dst):
        if os.path.basename(dst) == "meta.json":
            raise OSError("simulated crash before the commit")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", crash)
    with pytest.raises(OSError, match="simulated crash"):
        store.save(path)
    monkeypatch.setattr(ckpt.os, "replace", real_replace)
    assert ckpt.read_meta(path) == meta
    orphan = f"arrays-{meta['generation'] + 1:08d}"
    assert orphan in os.listdir(path)
    ps_tpu_torch.shutdown()
    fresh = _port_store("local")
    _equal(saved, fresh.restore(path))
    ps_tpu_torch.shutdown()

    # the next save rewrites that generation and GCs the oldest
    store = _port_store("local")
    store.restore(path)
    store.push_all(_t(_grads_like(params, 2)))
    store.save(path)
    meta3 = ckpt.read_meta(path)
    assert meta3["generation"] == meta["generation"] + 1
    assert meta3["arrays_dir"] == orphan
    dirs = sorted(d for d in os.listdir(path) if d.startswith("arrays-"))
    assert dirs == sorted([meta["arrays_dir"], meta3["arrays_dir"]])
    assert not os.path.exists(os.path.join(path, "meta.json.tmp"))


# -- async ---------------------------------------------------------------------


def _phase1(store, params, arr):
    store.pull_all(worker=0)                      # w0 snapshots v0
    store.push_all(arr(_grads_like(params, 1)), worker=1)
    store.push_all(arr(_grads_like(params, 2)), worker=1)


def _phase2(store, params, arr):
    # w0 pushes stale by 2: the DC correction uses its phase-1 snapshot
    store.push_all(arr(_grads_like(params, 3)), worker=0)
    store.push_all(arr(_grads_like(params, 4)), worker=1)
    return _np(store.pull_all(worker=0))


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_async_resume_bit_identical(tmp_path, backend):
    path = str(tmp_path / "ckpt")
    _, params = _ref_params()
    store = _port_store(backend, mode="async", num_workers=2)
    _phase1(store, params, _t)
    ref_staleness = store.staleness(0)
    ref = _phase2(store, params, _t)
    ref_hist = store.staleness_histogram
    ps_tpu_torch.shutdown()

    store = _port_store(backend, mode="async", num_workers=2)
    _phase1(store, params, _t)
    store.save(path)
    ps_tpu_torch.shutdown()

    store = _port_store(backend, mode="async", num_workers=2)
    store.restore(path)
    assert store.staleness(0) == ref_staleness == 2
    _equal(ref, _phase2(store, params, _t))
    assert store.staleness_histogram == ref_hist


def test_async_resume_matches_reference_resume(tmp_path):
    """The DC-ASGD interleaving resumed in both frameworks."""
    _, params = _ref_params()

    def ref_store():
        ps_tpu.init(backend="tpu", mode="async", num_workers=2,
                    mesh_shape={"data": 1}, dc_lambda=0.04)
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1,
                               mode="async")
        store.init(params)
        return store

    store = ref_store()
    _phase1(store, params, lambda g: jax.tree_util.tree_map(jnp.asarray, g))
    store.save(str(tmp_path / "ref"))
    ps_tpu.shutdown()
    store = ref_store()
    store.restore(str(tmp_path / "ref"))
    want = _phase2(store, params,
                   lambda g: jax.tree_util.tree_map(jnp.asarray, g))
    ps_tpu.shutdown()

    store = _port_store("cuda", mode="async", num_workers=2)
    _phase1(store, params, _t)
    store.save(str(tmp_path / "port"))
    ps_tpu_torch.shutdown()
    store = _port_store("cuda", mode="async", num_workers=2)
    store.restore(str(tmp_path / "port"))
    _close(_phase2(store, params, _t), want, **TOL)


def _remap_drill(path, params, start, arr, step):
    """``tests/test_checkpoint.py::test_elastic_async_worker_remap``'s drill
    on one framework: ``start(num_workers)`` makes a store; 3 workers pull
    and push, save; a strict restore into 2 workers is refused; elastic
    3 -> 2 and 3 -> 4. Returns what each stage left, as numpy."""
    out = {}
    store = start(3)
    for w in range(3):
        store.pull_all(worker=w)
        store.push_all(arr(_grads_like(params, w)), worker=w)
    store.save(path)
    out["saved"] = _np(store.params())
    step()

    store = start(2)
    with pytest.raises(ValueError, match="num_workers"):
        store.restore(path)
    out["shrunk"] = _np(store.restore(path, elastic=True))
    eng = store._engine
    out["shrunk_versions"] = dict(eng._worker_version)
    out["shrunk_stale"] = sorted(eng._stale)
    out["shrunk_cache"] = sorted(store._async_params)
    store.push_all(arr(_grads_like(params, 7)), worker=1)
    out["shrunk_after"] = _np(store.params())
    out["shrunk_version"] = eng.version
    with pytest.raises(ValueError, match="worker"):
        store.push_all(arr(_grads_like(params, 8)), worker=2)
    step()

    store = start(4)
    out["grown"] = _np(store.restore(path, elastic=True))
    eng = store._engine
    out["grown_versions"] = dict(eng._worker_version)
    store.pull_all(worker=3)
    out["grown_staleness"] = store.staleness(3)
    store.push_all(arr(_grads_like(params, 9)), worker=3)
    store.push_all(arr(_grads_like(params, 10)), worker=0)  # stale by 1
    out["grown_after"] = _np(store.params())
    out["grown_hist"] = dict(store.staleness_histogram)
    step()
    return out


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_elastic_async_worker_remap(tmp_path, backend):
    """An async checkpoint of 3 workers restored into 2 and into 4 with
    ``elastic=True`` (the strict restore refused): the surviving workers
    keep their versions and stale snapshots, the dropped worker's state is
    gone and its id invalid, a new worker joins fresh; the resumed runs
    equal the reference's resumed runs (its local backend, or its mesh
    engine for 'cuda')."""
    _, params = _ref_params()

    def ref_start(nw):
        kw = dict(mesh_shape={"data": 1}) if backend == "cuda" else {}
        ps_tpu.init(backend="tpu" if backend == "cuda" else "local",
                    mode="async", num_workers=nw, dc_lambda=0.04, **kw)
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1,
                               mode="async")
        store.init(params)
        return store

    want = _remap_drill(str(tmp_path / "ref"), params, ref_start,
                        lambda g: jax.tree_util.tree_map(jnp.asarray, g),
                        ps_tpu.shutdown)
    got = _remap_drill(str(tmp_path / "port"), params,
                       lambda nw: _port_store(backend, mode="async",
                                              num_workers=nw),
                       _t, ps_tpu_torch.shutdown)
    assert got["shrunk_versions"] == want["shrunk_versions"] == {0: 0, 1: 1}
    assert {w for w, _ in got["shrunk_stale"]} == {0, 1}
    assert set(got["shrunk_cache"]) <= {0, 1}
    assert got["grown_versions"] == want["grown_versions"]
    assert set(got["grown_versions"]) == {0, 1, 2}
    assert got["grown_staleness"] == want["grown_staleness"] == 0
    assert got["shrunk_version"] == want["shrunk_version"] == 4
    assert got["grown_hist"] == want["grown_hist"]
    for stage in ("saved", "shrunk", "grown"):
        _equal(got[stage], got["saved"])
        _equal(want[stage], want["saved"])
    _close(got["saved"], want["saved"], **TOL)
    for stage in ("shrunk_after", "grown_after"):
        _close(got[stage], want[stage], **TOL)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_make_async_step_resume_keeps_cache_aliases(tmp_path, backend):
    """Resume mid-async-training through the worker cycle: each restored
    worker's cached pull is the very tensor restored as its stale snapshot
    (saved once), and the resumed run equals the uninterrupted one."""
    path = str(tmp_path / "ckpt")
    model = MLP(hidden=16)
    loss_fn = make_loss_fn(model)
    params = model.init(torch.Generator().manual_seed(0))
    batches = list(mnist_batches(16, seed=0, steps=8))

    def fresh():
        store = _port_store(backend, mode="async", num_workers=2,
                            params=params)
        return store, store.make_async_step(loss_fn)

    def drive(store, run, bs, start):
        for i, b in enumerate(bs, start):
            run(store.shard_batch(b), worker=i % 2)

    store, run = fresh()
    drive(store, run, batches, 0)
    ref = _np(store.params())
    ps_tpu_torch.shutdown()

    store, run = fresh()
    drive(store, run, batches[:4], 0)
    store.save(path)
    meta = ckpt.read_meta(path)
    n_keys = len(store.keys())
    assert meta["store"]["cache_keys"] == []
    assert len(meta["store"]["cache_stale_aliases"]) == 2 * n_keys
    assert len(ckpt.restore(path)["stale"]) == 2 * n_keys  # saved once
    ps_tpu_torch.shutdown()

    store, run = fresh()
    store.restore(path)
    eng = store._engine
    for w in (0, 1):
        cached = keymod.flatten_with_keys(store._async_params[w])[0]
        assert all(cached[k] is eng._stale[(w, k)] for k in store.keys())
    assert store.staleness(0) == 1 and store.staleness(1) == 0
    drive(store, run, batches[4:], 4)
    _equal(ref, store.params())


def test_async_make_async_step_drill_from_reference(tmp_path):
    """The cross-framework drill on the async engine: the reference runs 4
    make_async_step cycles and saves (stale snapshots and cached pulls);
    the port restores the converted checkpoint, and 4 more cycles on both
    sides agree within the async MLP's bound."""
    ref_model, params = _ref_params()
    batches = [(b[0], b[1]) for b in mnist_batches(16, seed=0, steps=8)]

    def ref_loss(p, batch):
        images, labels = batch
        return ref_xent(ref_model.apply({"params": p}, images), labels)

    def ref_store():
        ps_tpu.init(backend="tpu", mode="async", num_workers=2,
                    mesh_shape={"data": 1}, dc_lambda=0.04)
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1,
                               mode="async")
        store.init(params)
        return store, store.make_async_step(ref_loss)

    store, run = ref_store()
    for i, b in enumerate(batches[:4]):
        run(b, worker=i % 2)
    store.save(str(tmp_path / "ref"))
    arrays, meta = _read_reference(store, str(tmp_path / "ref"))
    ps_tpu.shutdown()
    assert meta["engine"] == "tpu_async" and meta["store"][
        "cache_stale_aliases"]
    store, run = ref_store()
    store.restore(str(tmp_path / "ref"))
    for i, b in enumerate(batches[4:], 4):
        run(b, worker=i % 2)
    want = _np(store.params())
    ps_tpu.shutdown()

    port_meta = ckpt.from_reference(arrays, meta, str(tmp_path / "port"))
    assert port_meta["engine"] == "cuda_async"
    model = MLP(hidden=16)
    store = _port_store("cuda", mode="async", num_workers=2)
    store.restore(str(tmp_path / "port"))
    eng = store._engine
    assert all(store._async_params[w] is not None for w in (0, 1))
    cached = keymod.flatten_with_keys(store._async_params[0])[0]
    assert all(cached[k] is eng._stale[(0, k)] for k in store.keys())
    run = store.make_async_step(make_loss_fn(model))
    for i, b in enumerate(batches[4:], 4):
        run(store.shard_batch(b), worker=i % 2)
    _close(store.params(), want, rtol=1e-5, atol=1e-5)
    assert eng.version == 8


# -- the cross-framework drill (dense) -------------------------------------------


def _read_reference(store, path):
    """The reference's checkpoint as numpy, read with ps_tpu.checkpoint the
    way its own KVStore.restore reads it."""
    meta = ps_tpu.checkpoint.read_meta(path)
    abstract = store._engine.abstract_state_dict(meta)
    abstract["worker_cache"] = {
        s: abstract["params"][ps_tpu.checkpoint.decode_stale_key(s)[1]]
        for s in meta["store"]["cache_keys"]}
    arrays = ps_tpu.checkpoint.restore(path, abstract, meta)
    return jax.tree_util.tree_map(np.asarray, arrays), meta


@pytest.mark.parametrize("backend,opt", [
    ("tpu", "adam"), ("tpu", "sgd"), ("tpu", "momentum"),
    ("tpu", "lamb"), ("local", "sgd_schedule"), ("local", "adam_schedule"),
])
def test_drill_reference_checkpoint_resumes_in_port(tmp_path, backend, opt):
    """The reference takes 3 steps and saves; from_reference converts what
    ps_tpu.checkpoint reads; the port restores it and takes 3 steps, which
    equal the reference's own 3 resumed steps."""
    _, params = _ref_params()
    grads = [_grads_like(params, s) for s in range(6)]
    ref_kw = {"mesh_shape": {"data": 1}} if backend == "tpu" else {}

    def ref_store():
        ps_tpu.init(backend=backend, **ref_kw)
        name, kw = REF_OPTIMIZERS[opt]
        store = ps_tpu.KVStore(optimizer=name, **kw)
        store.init(params)
        return store

    store = ref_store()
    for g in grads[:3]:
        store.push_pull(jax.tree_util.tree_map(jnp.asarray, g))
    store.save(str(tmp_path / "ref"))
    arrays, meta = _read_reference(store, str(tmp_path / "ref"))
    ps_tpu.shutdown()
    store = ref_store()
    store.restore(str(tmp_path / "ref"))
    for g in grads[3:]:
        want = store.push_pull(jax.tree_util.tree_map(jnp.asarray, g))
    want_state = {k: jax.tree_util.tree_leaves(store.optimizer_state(k))
                  for k in store.keys()}
    ps_tpu.shutdown()

    port_meta = ckpt.from_reference(arrays, meta, str(tmp_path / "port"))
    assert port_meta["engine"] == {"tpu": "cuda_sync",
                                   "local": "local"}[backend]
    store = _port_store({"tpu": "cuda", "local": "local"}[backend], opt)
    store.restore(str(tmp_path / "port"))
    assert store.step == 3
    for g in grads[3:]:
        got = store.push_pull(_t(g))
    if opt == "sgd":
        _equal(got, want)
    else:
        _close(got, want, **TOL)
    for k in store.keys():  # the optimizer state too, leaf for leaf
        got_leaves = list(ckpt.flatten_leaves(
            store.optimizer_state(k)).values())
        w = sorted(want_state[k], key=np.size)
        g = sorted(got_leaves, key=lambda t: t.numel())
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_from_reference_refuses_what_it_cannot_map(tmp_path):
    _, params = _ref_params()
    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})
    store = ps_tpu.KVStore(optimizer=optax.rmsprop(1e-3))
    store.init(params)
    store.save(str(tmp_path / "ref"))
    arrays, meta = _read_reference(store, str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="ScaleByRmsState"):
        ckpt.from_reference(arrays, meta, str(tmp_path / "port"))
    with pytest.raises(ValueError, match="no port engine"):
        ckpt.from_reference(arrays, dict(meta, engine="remote"),
                            str(tmp_path / "port"))
    assert not os.path.exists(tmp_path / "port" / "meta.json")


# -- sparse tables ---------------------------------------------------------------


SPARSE_OPTS = {"sgd": {"learning_rate": 0.05},
               "adagrad": {"learning_rate": 0.05},
               "adam": {"learning_rate": 0.1}}


def _pushes(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, ROWS, size=24).astype(np.int32),
             rng.normal(0, 0.1, size=(24, DIM)).astype(np.float32))
            for _ in range(n)]


def _table():
    return np.random.default_rng(7).normal(0, 0.01, (ROWS, DIM)).astype(
        np.float32)


def _port_emb(kind, num_rows=ROWS, dim=DIM, dtype=torch.float32):
    if not ps_tpu_torch.is_initialized():
        ps_tpu_torch.init(backend="cuda", device="cpu")
    emb = ps_tpu_torch.SparseEmbedding(num_rows, dim, optimizer=kind,
                                       dtype=dtype, **SPARSE_OPTS[kind])
    emb.init(np.random.default_rng(7).normal(0, 0.01, (num_rows, dim))
             .astype(np.float32))
    return emb


def _leaves_np(emb):
    return [t.float().numpy() for t in
            [emb.table] + list(ckpt.flatten_leaves(emb.state()).values())]


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_resume_bit_identical(tmp_path, kind, dtype):
    path = str(tmp_path / "ckpt")
    pushes = _pushes()
    emb = _port_emb(kind, dtype=dtype)
    for ids, g in pushes:
        emb.push(ids, g)
    ref = _leaves_np(emb)
    ps_tpu_torch.shutdown()

    emb = _port_emb(kind, dtype=dtype)
    for ids, g in pushes[:3]:
        emb.push(ids, g)
    emb.save(path)
    assert emb.push_count == 3
    ps_tpu_torch.shutdown()

    emb = _port_emb(kind, dtype=dtype)
    restored = emb.restore(path)
    assert restored.dtype == dtype and restored.is_contiguous()
    assert emb.push_count == 3 and emb.rows_pushed == 3 * 24
    assert np.all(emb.row_version == 3)
    for ids, g in pushes[3:]:
        emb.push(ids, g)
    for a, b in zip(ref, _leaves_np(emb)):
        np.testing.assert_array_equal(a, b)
    if kind == "adam":  # the per-row step advanced only on touched rows
        t = emb.state()["t"]
        assert t.dtype == torch.int32 and int(t.max()) > 0
        assert int(t.min()) < int(t.max())


@pytest.mark.parametrize("what,match", [
    ("shape", "checkpoint table"), ("dtype", "silently cast"),
    ("optimizer", "optimizer"), ("engine", "not a sparse table"),
])
def test_sparse_restore_refusals(tmp_path, what, match):
    path = str(tmp_path / "ckpt")
    if what == "engine":
        store = _port_store("local")
        store.save(path)
    else:
        _port_emb("adagrad").save(path)
    other = {"shape": lambda: _port_emb("adagrad", num_rows=32),
             "dtype": lambda: _port_emb("adagrad", dtype=torch.bfloat16),
             "optimizer": lambda: _port_emb("sgd"),
             "engine": lambda: _port_emb("adagrad")}[what]()
    before = _leaves_np(other)
    with pytest.raises(ValueError, match=match):
        other.restore(path)
    for a, b in zip(before, _leaves_np(other)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_sparse_drill_reference_checkpoint_resumes_in_port(tmp_path, kind):
    """The reference's table after 3 applies (its shard_map-free jax tier,
    adopted into a reference SparseEmbedding and saved by it), converted by
    from_reference, restored by the port, then 3 more pushes on each side:
    sgd bitwise, adagrad and adam within rtol 1e-6, atol 1e-7."""
    pushes = _pushes()
    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})

    def ref_emb():
        emb = ps_tpu.SparseEmbedding(ROWS, DIM, optimizer=kind,
                                     **SPARSE_OPTS[kind])
        emb.init(_table())
        return emb

    def ref_apply(emb, pushes):
        table, state = emb.table, emb.state()
        for ids, g in pushes:
            table, state = ref_fused_apply(table, state, jnp.asarray(ids),
                                           jnp.asarray(g), emb._opt, "jax")
        emb.adopt_state(table, state)

    emb = ref_emb()
    ref_apply(emb, pushes[:3])
    emb.save(str(tmp_path / "ref"))
    meta = ps_tpu.checkpoint.read_meta(str(tmp_path / "ref"))
    abstract = {"table": ps_tpu.checkpoint.abstract_like(emb.table),
                "opt": ps_tpu.checkpoint.abstract_like(
                    ps_tpu.checkpoint.flatten_leaves(emb.state()))}
    arrays = jax.tree_util.tree_map(np.asarray, ps_tpu.checkpoint.restore(
        str(tmp_path / "ref"), abstract, meta))
    emb = ref_emb()
    emb.restore(str(tmp_path / "ref"))
    ref_apply(emb, pushes[3:])
    want = [np.asarray(emb.table)] + [
        np.asarray(x).astype(np.float32)
        for x in jax.tree_util.tree_leaves(emb.state())]
    ps_tpu.shutdown()

    ckpt.from_reference(arrays, meta, str(tmp_path / "port"))
    port = _port_emb(kind)
    port.restore(str(tmp_path / "port"))
    for ids, g in pushes[3:]:
        port.push(ids, g)
    got = _leaves_np(port)
    for a, b in zip(got, want):
        if kind == "sgd":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_export_adopt_rows_round_trip(kind):
    src = _port_emb(kind)
    for ids, g in _pushes(3):
        src.push(ids, g)
    slots = np.array([3, 17, 40, 63])
    rows, leaves = src.export_rows(slots)
    assert rows.shape == (4, DIM) and isinstance(rows, np.ndarray)
    assert len(leaves) == len(ckpt.flatten_leaves(src.state()))
    dst = _port_emb(kind)
    table = dst.table
    dst.adopt_rows([0, 1, 2, 5], rows, leaves)
    assert dst.table is table  # in place: the live table stays the same
    rows2, leaves2 = dst.export_rows([0, 1, 2, 5])
    np.testing.assert_array_equal(rows, rows2)
    for a, b in zip(leaves, leaves2):
        np.testing.assert_array_equal(a, b)
    untouched, _ = dst.export_rows([4])
    np.testing.assert_array_equal(untouched, _table()[[4]])


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_export_adopt_rows_round_trip_across_two_ranks(kind, tmp_path):
    """Across two gloo ranks ``export_rows`` gives every rank the rows of
    global slots that span both ranks' shards, each from its owner
    (all-gathers on the mesh), and ``adopt_rows`` writes each rank the
    slots it owns: both equal one process, bitwise."""
    import test_torch_ranks_harness as torch_ranks

    pushes = _pushes(3)
    export = np.array([3, 17, 40, 63, 33, 3])
    adopt = np.array([0, 1, 35, 36, 62, 50])
    res = torch_ranks.run_ranks(2, [("export_adopt", dict(
        num_rows=ROWS, dim=DIM, optimizer=kind, opt_kw=SPARSE_OPTS[kind],
        table=_table(), pushes=pushes, export=export, adopt=adopt))],
        tmp_path)
    one = _port_emb(kind)
    for ids, g in pushes:
        one.push(ids, g)
    rows, leaves = one.export_rows(export)
    one.adopt_rows(adopt, rows, leaves)
    for r in range(2):
        got = res[r][0]
        np.testing.assert_array_equal(got["rows"], rows)
        for a, b in zip(got["leaves"], leaves):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["again"], rows)
        np.testing.assert_array_equal(got["table"], one.table.numpy())
        assert "all_gather" in got["ops"]


def test_adopt_state_refuses_what_the_kernel_cannot_take():
    emb = _port_emb("adam")
    table, state = emb.table.clone(), {k: v.clone()
                                       for k, v in emb.state().items()}
    with pytest.raises(ValueError, match="contiguous"):
        emb.adopt_state(table.t().contiguous().t(), state)
    with pytest.raises(ValueError, match="cast"):
        emb.adopt_state(table, dict(state, t=state["t"].long()))
    with pytest.raises(ValueError, match="shape"):
        emb.adopt_state(table[:32], state)
    emb.adopt_state(table, state)
    assert emb.table is table


def test_sparse_row_moves_keep_bf16():
    emb = _port_emb("adagrad", dtype=torch.bfloat16)
    rows, leaves = emb.export_rows([1, 2])
    assert rows.dtype == np.float32
    emb.adopt_rows([5, 6], rows, leaves)
    assert emb.table.dtype == torch.bfloat16
    assert torch.equal(emb.table[5:7], emb.table[1:3])


# -- helpers ----------------------------------------------------------------------


def test_flat_leaves_round_trip_keeps_order_and_structure():
    state = {"rule": {"count": torch.zeros((), dtype=torch.int32),
                      "mu": {"b": torch.ones(2), "a": torch.zeros(3)}},
             "schedule_count": torch.tensor(4, dtype=torch.int32),
             "empty": (), "none": None}
    flat = ckpt.flatten_leaves(state)
    assert [tuple(t.shape) for t in flat.values()] == [(), (3,), (2,), ()]
    back = ckpt.unflatten_like(state, flat)
    assert list(back) == list(state) and list(back["rule"]["mu"]) == ["b", "a"]
    assert back["empty"] == () and back["none"] is None
    assert ckpt.opt_fingerprint("adam", state) != ckpt.opt_fingerprint(
        "lamb", state)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.unflatten_like(state, dict(list(flat.items())[:2]))


def test_stale_keys_and_keep_worker():
    s = ckpt.encode_stale_key(3, "dense1/kernel")
    assert ckpt.decode_stale_key(s) == (3, "dense1/kernel")
    assert ckpt.keep_worker(5, 2, elastic=False)
    assert not ckpt.keep_worker(5, 2, elastic=True)
    assert ckpt.keep_worker(1, 2, elastic=True)
