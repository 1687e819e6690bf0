"""The port's local backend against the reference's ``LocalServer``.

Each case of ``tests/test_local_kv.py`` runs the same script through
``ps_tpu`` (backend 'local', JAX on the CPU) and ``ps_tpu_torch``
(backend 'local', device='cpu') on the same numpy inputs. sgd is held
bitwise: the port takes ``p + (-lr)·g`` as one fused multiply-add, as XLA
compiles the reference's jitted apply. Per-key momentum, adam and lamb,
and the learning-rate schedules, are held to rtol 1e-6 (the reference's
Adam floor); ``make_step`` over the MLP with 2 workers, whose matrix
products round differently in XLA and PyTorch, to rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.models.mlp import MLP as RefMLP
from ps_tpu.models.mlp import cross_entropy_loss as ref_xent
from ps_tpu_torch.models.mlp import MLP, make_loss_fn


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)


def _both(script, **init_kw):
    """``script(ps, arr)`` through the reference (``arr = jnp.asarray``)
    and the port (``arr = torch.as_tensor``, device='cpu'); returns both
    results with every array as numpy."""
    ps_tpu.init(backend="local", **init_kw)
    try:
        ref = _np(script(ps_tpu, jnp.asarray))
    finally:
        ps_tpu.shutdown()
    ps_tpu_torch.init(backend="local", device="cpu", **init_kw)
    try:
        port = _np(script(ps_tpu_torch, torch.as_tensor))
    finally:
        ps_tpu_torch.shutdown()
    return ref, port


def _equal(ref, port):
    jax.tree_util.tree_map(np.testing.assert_array_equal, port, ref)


def _make_store(ps, arr, **kw):
    store = ps.KVStore(optimizer="sgd", learning_rate=0.5, **kw)
    store.init({"w": arr(np.ones(4, np.float32)),
                "b": arr(np.zeros((2, 2), np.float32))})
    return store


# -- the reference's 13 cases -------------------------------------------------


def test_init_registers_keys():
    ref, port = _both(lambda ps, arr: _make_store(ps, arr).keys())
    assert port == ref == ["b", "w"]


def test_push_pull_applies_sgd():
    def script(ps, arr):
        store = _make_store(ps, arr)
        store.push("w", arr(np.full((4,), 2.0, np.float32)))
        return store.pull("w")

    ref, port = _both(script)
    _equal(ref, port)
    np.testing.assert_array_equal(port, np.zeros(4))  # 1 - 0.5*2


def test_pull_without_push_returns_current():
    ref, port = _both(lambda ps, arr: _make_store(ps, arr).pull("w"))
    _equal(ref, port)
    np.testing.assert_array_equal(port, np.ones(4))


@pytest.mark.parametrize("call", ["push", "pull"])
def test_unregistered_key_raises(call):
    def script(ps, arr):
        store = _make_store(ps, arr)
        with pytest.raises(KeyError):
            if call == "push":
                store.push("nope", arr(np.zeros(1, np.float32)))
            else:
                store.pull("nope")
        return True

    assert _both(script) == (True, True)


def test_sync_aggregation_waits_for_all_workers():
    def script(ps, arr):
        store = _make_store(ps, arr)
        store.push("w", arr(np.full((4,), 1.0, np.float32)), worker=0)
        with pytest.raises(RuntimeError, match="would block"):
            store.pull("w")
        store.push("w", arr(np.full((4,), 3.0, np.float32)), worker=1)
        return store.pull("w")

    ref, port = _both(script, num_workers=2)
    _equal(ref, port)
    np.testing.assert_array_equal(port, np.zeros(4))  # mean 2: 1 - 0.5*2


def test_double_push_same_worker_raises():
    def script(ps, arr):
        store = _make_store(ps, arr)
        store.push("w", arr(np.ones(4, np.float32)), worker=0)
        with pytest.raises(RuntimeError, match="twice"):
            store.push("w", arr(np.ones(4, np.float32)), worker=0)
        with pytest.raises(ValueError, match="out of range"):
            store.push("w", arr(np.ones(4, np.float32)), worker=2)
        return True

    assert _both(script, num_workers=2) == (True, True)


def test_sum_aggregation():
    def script(ps, arr):
        store = ps.KVStore(optimizer="sgd", learning_rate=1.0,
                           aggregate="sum")
        store.init({"w": arr(np.zeros(3, np.float32))})
        store.push("w", arr(np.ones(3, np.float32)), worker=0)
        store.push("w", arr(np.ones(3, np.float32)), worker=1)
        return store.pull("w")

    ref, port = _both(script, num_workers=2)
    _equal(ref, port)
    np.testing.assert_array_equal(port, -2.0 * np.ones(3))


def test_push_pull_fused_tree():
    def script(ps, arr):
        store = _make_store(ps, arr)
        params = store.push_pull({"w": arr(np.ones(4, np.float32)),
                                  "b": arr(np.ones((2, 2), np.float32))})
        return params, store.step

    ref, port = _both(script)
    _equal(ref, port)
    np.testing.assert_array_equal(port[0]["w"], 0.5 * np.ones(4))
    assert port[1] == 1


def test_mismatched_tree_raises():
    def script(ps, arr):
        store = _make_store(ps, arr)
        with pytest.raises(ValueError, match="structure"):
            store.push_all({"w": arr(np.ones(4, np.float32))})
        return True

    assert _both(script) == (True, True)


def test_byte_accounting():
    def script(ps, arr):
        store = _make_store(ps, arr)
        store.push("w", arr(np.ones(4, np.float32)))
        store.pull("w")
        store.push_all({"w": arr(np.ones(4, np.float32)),
                        "b": arr(np.ones((2, 2), np.float32))})
        store.pull_all()
        return store.bytes_pushed, store.bytes_pulled

    ref, port = _both(script)
    assert port == ref == (48, 48)


def test_init_twice_raises():
    ps_tpu_torch.init(backend="local", device="cpu")
    with pytest.raises(RuntimeError, match="already initialized"):
        ps_tpu_torch.init(backend="local", device="cpu")
    ps_tpu.init(backend="local")
    with pytest.raises(RuntimeError, match="already initialized"):
        ps_tpu.init(backend="local")


def test_requires_init():
    for ps in (ps_tpu, ps_tpu_torch):
        with pytest.raises(RuntimeError, match="not initialized"):
            ps.KVStore()


def test_nested_pytree_keys():
    def script(ps, arr):
        store = ps.KVStore(optimizer="sgd", learning_rate=1.0)
        store.init({"layer1": {"kernel": arr(np.ones((2, 3), np.float32)),
                               "bias": arr(np.zeros(3, np.float32))},
                    "layer2": {"kernel": arr(np.ones((3, 1), np.float32))}})
        return store.keys(), store.params()

    ref, port = _both(script)
    assert port[0] == ref[0] == ["layer1/bias", "layer1/kernel",
                                 "layer2/kernel"]
    assert (jax.tree_util.tree_structure(port[1])
            == jax.tree_util.tree_structure(ref[1]))
    _equal(ref[1], port[1])


# -- optimizers over random gradients -----------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)},
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _protocol(optimizer, aggregate="mean", steps=3, nw=3, **opt_kw):
    def script(ps, arr):
        store = ps.KVStore(optimizer=optimizer, aggregate=aggregate,
                           **opt_kw)
        store.init(jax.tree_util.tree_map(arr, _tree(0)))
        for step in range(steps):
            for w in range(nw):
                g = jax.tree_util.tree_map(arr, _tree(10 * step + w + 1))
                store.push_all(g, worker=w)
            out = store.pull_all()
        states = {k: store.optimizer_state(k) for k in store.keys()}
        return out, states

    return _both(script, num_workers=nw)


@pytest.mark.parametrize("aggregate", ["mean", "sum"])
def test_sgd_on_random_gradients_is_bitwise(aggregate):
    ref, port = _protocol("sgd", aggregate, learning_rate=0.05)
    _equal(ref[0], port[0])


@pytest.mark.parametrize("optimizer,kw", [
    ("momentum", {"learning_rate": 0.05, "momentum": 0.9}),
    ("momentum", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True}),
    ("adam", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "weight_decay": 0.01}),
])
def test_per_key_optimizers_match(optimizer, kw):
    ref, port = _protocol(optimizer, **kw)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7),
        port[0], ref[0])
    for k in ref[1]:  # each key's own state: same leaves, same values
        want = jax.tree_util.tree_leaves(ref[1][k])
        got = jax.tree_util.tree_leaves(port[1][k])
        assert len(got) == len(want), k
        for g, w in zip(sorted(got, key=np.size), sorted(want, key=np.size)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam", "lamb"])
def test_per_key_states_carry_the_schedule(optimizer):
    """A learning-rate schedule on the local server: each key's state
    carries its own count, as optax's per-key ``scale_by_schedule`` does."""
    ref_sched = optax.linear_schedule(0.1, 0.01, transition_steps=4)

    def port_sched(count):
        frac = 1 - torch.clip(count, 0, 4) / 4
        return (0.1 - 0.01) * frac + 0.01

    def script(ps, arr):
        sched = ref_sched if ps is ps_tpu else port_sched
        store = ps.KVStore(optimizer=optimizer, learning_rate=sched)
        store.init(jax.tree_util.tree_map(arr, _tree(0)))
        for step in range(5):
            store.push_all(jax.tree_util.tree_map(arr, _tree(step + 1)))
        return store.pull_all()

    ref, port = _both(script)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7),
        port, ref)


# -- make_step, the pulled tensors, and the refusals --------------------------


def _mlp(hidden=16):
    model = RefMLP(hidden=hidden)
    params = model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_make_step_with_two_workers_matches_reference():
    ref_model, params = _mlp()
    batches = [next(mnist_batches(16, seed=s)) for s in range(3)]

    def ref_loss(p, batch):
        images, labels = batch
        return ref_xent(ref_model.apply({"params": p}, images), labels)

    ps_tpu.init(backend="local", num_workers=2)
    ref = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-3)
    ref.init(params)
    run = ref.make_step(ref_loss)
    ref_losses = [float(run((jnp.asarray(b[0]), jnp.asarray(b[1])))[0])
                  for b in batches]
    want = _np(ref.params())
    ps_tpu.shutdown()

    ps_tpu_torch.init(backend="local", device="cpu", num_workers=2)
    model = MLP(hidden=16)
    port = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-3)
    port.init(model.params_from_jax(params))
    assert port.keys() == ref.keys() and port.num_workers == 2
    run = port.make_step(make_loss_fn(model))
    losses = []
    for b in batches:
        loss, new = run(port.shard_batch(b))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = _np(new)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6),
        got, want)
    assert port.step == 3


def test_make_step_rejects_an_indivisible_batch():
    _, params = _mlp()
    ps_tpu_torch.init(backend="local", device="cpu", num_workers=3)
    model = MLP(hidden=16)
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(model.params_from_jax(params))
    run = store.make_step(make_loss_fn(model))
    batch = store.shard_batch(next(mnist_batches(16, seed=0)))  # 16 % 3
    with pytest.raises(ValueError, match="divisible"):
        run(batch)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_pulled_tensors_keep_their_values(backend):
    """A tensor returned by pull/pull_all/push_pull is not changed by a
    later apply (the reference's arrays are immutable)."""
    ps_tpu_torch.init(backend=backend, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=0.1)
    store.init(_tree(0))
    g = jax.tree_util.tree_map(torch.as_tensor, _tree(1))
    held = [store.pull("b"), store.pull_all()["a"]["kernel"],
            store.push_pull(g)["b"]]
    before = [t.clone() for t in held]
    for k in store.keys():  # the per-key protocol
        store.push(k, {"a/bias": g["a"]["bias"], "a/kernel": g["a"]["kernel"],
                       "b": g["b"]}[k])
    store.push_pull(g)
    for t, b in zip(held, before):
        assert torch.equal(t, b)
    assert not torch.equal(store.pull("b"), before[2])


def test_local_store_refuses_partition_rules():
    ps_tpu_torch.init(backend="local", device="cpu")
    with pytest.raises(ValueError, match="partition_rules"):
        ps_tpu_torch.KVStore(partition_rules=[("w", (None, "model"))])
