"""Async DC-ASGD in one process (config 5): the port's two async engines,
the local backend's ``LocalServer(mode='async')`` and the cuda backend's
``AsyncCudaServer`` (both on device='cpu'), against the reference's local
spec.

- The fixed interleaving of ``tests/test_async_tpu.py`` within rtol 1e-6,
  atol 1e-7; the DC formula against float64 numpy within rtol 1e-5, atol
  2e-6; versions, staleness and the staleness histogram exactly.
- ``tests/test_async_stress.py``'s engine cases: the whole-tree push equal
  to the per-key sequence, per-key pushes committing as one apply (the
  apply function counted), a partial tree committing at the pull, four
  host threads keeping every invariant exact, and round-robin
  ``make_async_step`` deterministic and within 1e-5 of the reference's
  (its MLP's products round differently in XLA).
- A tensor a worker pulled keeps its values after later applies, so the
  stale snapshot really is stale and the DC term is not zero.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.models.mlp import MLP as RefMLP
from ps_tpu.models.mlp import cross_entropy_loss as ref_xent
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.models.mlp import MLP, make_loss_fn

LAM = 0.04
LR = 0.1
ENGINES = ["local", "cuda"]


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _params(hidden=16):
    model = RefMLP(hidden=hidden)
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


def _port_store(backend, num_workers, optimizer="sgd", **kw):
    ps_tpu_torch.init(backend=backend, device="cpu", mode="async",
                      num_workers=num_workers, dc_lambda=LAM)
    kw.setdefault("learning_rate", LR)
    store = ps_tpu_torch.KVStore(optimizer=optimizer, mode="async", **kw)
    store.init(_params()[1])
    return store


def _interleaving(ps, arr, store, params):
    g0, g1a, g1b = (jax.tree_util.tree_map(arr, _grads_like(params, s))
                    for s in (1, 2, 3))
    store.pull_all(worker=0)          # w0 snapshots v0
    store.push_all(g1a, worker=1)     # w1 advances the server twice
    store.push_all(g1b, worker=1)
    store.push_all(g0, worker=0)      # w0 pushes stale-by-2
    return _np(store.pull_all(worker=0))


@pytest.mark.parametrize("backend", ENGINES)
def test_interleaving_matches_reference_local_spec(backend):
    _, params = _params()
    ps_tpu.init(backend="local", mode="async", num_workers=2, dc_lambda=LAM)
    ref = ps_tpu.KVStore(optimizer="sgd", learning_rate=LR, mode="async")
    ref.init(params)
    want = _interleaving(ps_tpu, jnp.asarray, ref, params)
    ps_tpu.shutdown()
    store = _port_store(backend, 2)
    got = _interleaving(ps_tpu_torch, torch.as_tensor, store, params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7),
        got, want)
    assert store._engine.version == 3
    assert store.staleness_histogram == {0: 1, 1: 1, 2: 1}


@pytest.mark.parametrize("backend", ENGINES)
def test_dc_correction_math(backend):
    """One stale push applies g + λ·g⊙g⊙(w_now − w_stale)."""
    _, params = _params()
    store = _port_store(backend, 2)
    pulled = store.pull_all(worker=0)
    w_stale = _np(pulled)
    g1, g0 = _grads_like(params, 10), _grads_like(params, 11)
    store.push_all(jax.tree_util.tree_map(torch.as_tensor, g1), worker=1)
    w_now = _np(store.params())
    store.push_all(jax.tree_util.tree_map(torch.as_tensor, g0), worker=0)
    got = _np(store.params())

    def expect(wn, ws, g):
        wn, ws, g = (x.astype(np.float64) for x in (wn, ws, g))
        return wn - LR * (g + LAM * g * g * (wn - ws))

    want = jax.tree_util.tree_map(expect, w_now, w_stale, g0)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6),
        got, want)
    # the snapshot held since the first pull kept its values
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(pulled), w_stale)
    assert any(np.any(a != b) for a, b in zip(
        jax.tree_util.tree_leaves(w_now), jax.tree_util.tree_leaves(w_stale)))


@pytest.mark.parametrize("backend", ENGINES)
def test_version_and_staleness(backend):
    _, params = _params()
    store = _port_store(backend, 3)
    store.pull_all(worker=0)
    assert store.staleness(0) == 0
    g = jax.tree_util.tree_map(torch.as_tensor, _grads_like(params, 4))
    store.push_all(g, worker=1)
    store.push_all(g, worker=2)
    assert store._engine.version == 2
    assert store.staleness(0) == 2
    store.pull_all(worker=0)
    assert store.staleness(0) == 0
    with pytest.raises(ValueError, match="out of range"):
        store.push_all(g, worker=3)


@pytest.mark.parametrize("backend", ENGINES)
def test_staleness_histogram_counts_pushes(backend):
    _, params = _params()
    store = _port_store(backend, 2)
    store.pull_all(worker=0)
    for w, seed in ((1, 1), (1, 2), (0, 3)):
        store.push_all(jax.tree_util.tree_map(
            torch.as_tensor, _grads_like(params, seed)), worker=w)
    hist = store.staleness_histogram
    assert sum(hist.values()) == 3 and hist[2] == 1  # w0's stale-by-2 push


@pytest.mark.parametrize("backend", ENGINES)
def test_whole_tree_push_equals_per_key_pushes(backend):
    _, params = _params()
    gs = [_grads_like(params, s) for s in range(3)]

    def run(per_key):
        store = _port_store(backend, 2, optimizer="adam", learning_rate=1e-3)
        store.pull_all(worker=0)
        for i, g in enumerate(gs):
            kv, _ = keymod.flatten_with_keys(
                jax.tree_util.tree_map(torch.as_tensor, g))
            if per_key:
                for k in store.keys():
                    store.push(k, kv[k], worker=i % 2)
            else:
                store.push_all(kv, worker=i % 2)
        out, version = _np(store.params()), store._engine.version
        ps_tpu_torch.shutdown()
        return out, version

    (fused, v_fused), (perkey, v_perkey) = run(False), run(True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, fused, perkey)
    assert v_fused == v_perkey == 3


@pytest.mark.parametrize("backend", ENGINES)
def test_per_key_pushes_commit_as_one_apply(backend):
    _, params = _params()
    store = _port_store(backend, 2)
    eng = store._engine
    calls = {"n": 0}
    orig = eng._apply_dc_tree

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    eng._apply_dc_tree = counting
    kv0, _ = keymod.flatten_with_keys(_grads_like(params, 0))
    kv1, _ = keymod.flatten_with_keys(_grads_like(params, 1))
    keys = store.keys()
    for k in keys[:-1]:  # two workers' per-key pushes, interleaved
        eng.push(k, kv0[k], worker=0)
        eng.push(k, kv1[k], worker=1)
    assert calls["n"] == 0 and eng.version == 0  # staged, nothing applied
    with pytest.raises(RuntimeError, match="staged"):
        eng._check_staged_async()
    with pytest.raises(RuntimeError, match="twice"):
        eng.push(keys[0], kv0[keys[0]], worker=0)
    eng.push(keys[-1], kv0[keys[-1]], worker=0)  # completes worker 0's tree
    assert calls["n"] == 1 and eng.version == 1
    eng.push(keys[-1], kv1[keys[-1]], worker=1)  # completes worker 1's tree
    assert calls["n"] == 2 and eng.version == 2
    assert eng._staged_async == {}
    eng._check_staged_async()


@pytest.mark.parametrize("backend", ENGINES)
def test_partial_tree_commits_on_pull(backend):
    _, params = _params()
    store = _port_store(backend, 1)
    eng = store._engine
    kv, _ = keymod.flatten_with_keys(_grads_like(params, 0))
    k0 = store.keys()[0]
    before = eng.peek(k0).clone()
    eng.push(k0, kv[k0])            # a subset: staged, not applied
    assert torch.equal(before, eng.peek(k0)) and eng.version == 0
    got = eng.pull(k0)              # the pull commits the partial tree
    assert eng.version == 1 and not torch.allclose(before, got)
    assert all(eng.apply_count[k] == 0 for k in store.keys() if k != k0)


def _mlp_loss():
    return make_loss_fn(MLP(hidden=8)), _params(hidden=8)


@pytest.mark.parametrize("backend", ENGINES)
def test_threaded_stress_invariants(backend):
    """4 host threads drive 4 async workers at once, with a short switch
    interval; the server lock keeps every count exact."""
    num_workers, cycles = 4, 12
    loss_fn, (_, params) = _mlp_loss()
    ps_tpu_torch.init(backend=backend, device="cpu", mode="async",
                      num_workers=num_workers)
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.05,
                                 mode="async")
    store.init(params)
    run = store.make_async_step(loss_fn)
    errors = []

    def worker(w):
        try:
            for batch in mnist_batches(16, seed=w, worker=w,
                                       num_workers=num_workers, steps=cycles):
                run(store.shard_batch(batch), worker=w)
        except Exception as e:  # surfaced by the assert below
            errors.append((w, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    eng = store._engine
    total = num_workers * cycles
    assert eng.version == total
    if hasattr(eng, "_applies"):
        assert eng._applies == total * len(store.keys())
    assert all(c == total for c in eng.apply_count.values())
    assert sum(store.staleness_histogram.values()) == total
    for leaf in jax.tree_util.tree_leaves(store.params()):
        assert bool(torch.isfinite(leaf).all())


def _round_robin(ps, arr, loss_fn, params, backend):
    ps.init(backend=backend, mode="async", num_workers=2,
            **({"device": "cpu"} if ps is ps_tpu_torch else {}))
    store = ps.KVStore(optimizer="sgd", learning_rate=0.05, mode="async")
    store.init(params)
    run = store.make_async_step(loss_fn)
    streams = [mnist_batches(16, seed=w, worker=w, num_workers=2, steps=6)
               for w in range(2)]
    losses = []
    for _ in range(6):
        for w, s in enumerate(streams):
            images, labels = next(s)
            losses.append(float(run((arr(images), arr(labels)), worker=w)))
    out = _np(store.params())
    ps.shutdown()
    return losses, out


@pytest.mark.parametrize("backend", ENGINES)
def test_sequential_async_is_deterministic_and_matches_reference(backend):
    ref_model, params = _params(hidden=8)

    def ref_loss(p, batch):
        images, labels = batch
        return ref_xent(ref_model.apply({"params": p}, images), labels)

    want_losses, want = _round_robin(ps_tpu, jnp.asarray, ref_loss, params,
                                     "local")
    loss_fn = make_loss_fn(MLP(hidden=8))
    port_params = MLP(hidden=8).params_from_jax(params)
    a = _round_robin(ps_tpu_torch, torch.as_tensor, loss_fn, port_params,
                     backend)
    b = _round_robin(ps_tpu_torch, torch.as_tensor, loss_fn, port_params,
                     backend)
    assert a[0] == b[0]
    jax.tree_util.tree_map(np.testing.assert_array_equal, a[1], b[1])
    np.testing.assert_allclose(a[0], want_losses, rtol=1e-5)
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5),
        a[1], want)


@pytest.mark.parametrize("backend", ENGINES)
def test_make_async_step_trains(backend):
    ps_tpu_torch.init(backend=backend, device="cpu", mode="async",
                      num_workers=2)
    model = MLP(hidden=64)
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1,
                                 mode="async")
    store.init(model.init(torch.Generator().manual_seed(0)))
    run = store.make_async_step(make_loss_fn(model))
    streams = [mnist_batches(64, seed=0, worker=w, num_workers=2, steps=40)
               for w in range(2)]
    losses = []
    for _ in range(40):
        for w, stream in enumerate(streams):
            losses.append(float(run(store.shard_batch(next(stream)),
                                    worker=w)))
    # with 2 round-robin workers, each cycle is stale by one version
    assert store.staleness(0) == 1
    assert np.mean(losses[-6:]) < np.mean(losses[:6]) - 1.0, losses


@pytest.mark.parametrize("backend", ENGINES)
def test_mode_guards(backend):
    _, params = _params()
    store = _port_store(backend, 2)
    with pytest.raises(RuntimeError, match="make_async_step"):
        store.make_step(lambda p, b: 0.0)
    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend=backend, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd")
    store.init(params)
    with pytest.raises(RuntimeError, match="mode='async'"):
        store.make_async_step(lambda p, b: 0.0)
    assert store.staleness(0) == 0 and store.staleness_histogram == {}


def test_trainer_runs_on_the_cpu(capsys):
    from ps_tpu_torch.examples import train_mnist_async

    out = train_mnist_async.main(["--device", "cpu", "--steps", "12"])
    text = capsys.readouterr().out
    assert "step      0  loss" in text and "staleness" in text
    assert "done: version 12, staleness histogram {0: 3, 2: 9}" in text
    assert out["version"] == 12 and len(out["losses"]) == 12
    assert not ps_tpu_torch.is_initialized()
    # the cross-process roles run now (tests/test_torch_remote_async.py,
    # tests/test_torch_replica_failover.py); the replication flags belong
    # to the server role, and a worker given one is refused
    with pytest.raises(SystemExit, match="belong to --role server"):
        train_mnist_async.main(["--device", "cpu", "--role", "worker",
                                "--backup"])
