"""The port's dense KVStore against the reference's, at one device.

``make_step`` (gradient, then the server's adam apply, in place) and
``push_pull`` run on the same numpy inputs through ``ps_tpu`` (the 'tpu'
backend on a one-device CPU mesh) and ``ps_tpu_torch`` (device='cpu').
Losses and parameters agree within rtol 1e-5, atol 1e-7: the matrix
products of XLA and PyTorch round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _params():
    rng = np.random.default_rng(0)
    return {"dense": {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                      "bias": np.zeros((3,), np.float32)},
            "scale": np.ones((3,), np.float32)}


def _batches():
    rng = np.random.default_rng(1)
    return [{"x": rng.normal(size=(8, 6)).astype(np.float32),
             "y": rng.normal(size=(8, 3)).astype(np.float32)}
            for _ in range(STEPS)]


def _ref_loss(params, batch):
    pred = (batch["x"] @ params["dense"]["kernel"]
            + params["dense"]["bias"]) * params["scale"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _port_loss(params, batch):
    pred = (batch["x"] @ params["dense"]["kernel"]
            + params["dense"]["bias"]) * params["scale"]
    return torch.mean((pred - batch["y"]) ** 2)


def _flat(tree):
    return {"/".join(k): v for k, v in
            [(("dense", "bias"), tree["dense"]["bias"]),
             (("dense", "kernel"), tree["dense"]["kernel"]),
             (("scale",), tree["scale"])]}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_make_step_matches_reference(optimizer):
    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})
    ref = ps_tpu.KVStore(optimizer=optimizer, learning_rate=1e-2)
    ref.init(_params())
    ref_run = ref.make_step(_ref_loss)
    ref_losses = []
    for b in _batches():
        loss, ref_params = ref_run({k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(loss))
    ref_params = jax.tree_util.tree_map(np.asarray, ref_params)

    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = ps_tpu_torch.KVStore(optimizer=optimizer, learning_rate=1e-2,
                                placement="sharded")
    port.init(_params())
    assert port.keys() == ref.keys()
    run = port.make_step(_port_loss)
    losses = []
    for b in _batches():
        loss, params = run(port.shard_batch(b))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got, want = _flat(params), _flat(ref_params)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=1e-5, atol=1e-7)
    assert port.step == STEPS and port.bytes_pushed == STEPS * 4 * (18 + 3 + 3)
    peek = _flat(port.params())
    for k in peek:
        assert peek[k] is got[k]  # the server's own tensors, updated in place


def test_push_pull_matches_reference():
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), _params())
        for _ in range(STEPS)]
    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})
    ref = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-2)
    ref.init(_params())
    for g in grads:
        want = ref.push_pull(jax.tree_util.tree_map(jnp.asarray, g))
    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-2)
    port.init(_params())
    for g in grads:
        got = port.push_pull(jax.tree_util.tree_map(torch.as_tensor, g))
    for k, w in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[k].numpy(), np.asarray(w),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="does not match"):
        port.push_pull({"scale": torch.zeros(3)})


@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", {"learning_rate": 1e-2}),
    ("momentum", {"learning_rate": 1e-2, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "weight_decay": 0.1}),
])
def test_make_step_steps_a_key_the_loss_does_not_reach(optimizer, kw):
    """jax.value_and_grad gives a zero gradient for a parameter the loss
    does not read, and optax still steps it (momentum and adam decay their
    state; lamb's weight decay moves the parameter)."""
    def params():
        p = _params()
        p["unused"] = np.full((2,), 0.5, np.float32)
        return p

    def ref_loss(p, batch):
        return _ref_loss({"dense": p["dense"], "scale": p["scale"]}, batch)

    def port_loss(p, batch):
        return _port_loss({"dense": p["dense"], "scale": p["scale"]}, batch)

    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})
    ref = ps_tpu.KVStore(optimizer=optimizer, **kw)
    ref.init(params())
    run = ref.make_step(ref_loss)
    for b in _batches():
        _, want = run({k: jnp.asarray(v) for k, v in b.items()})
    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = ps_tpu_torch.KVStore(optimizer=optimizer, **kw)
    port.init(params())
    run = port.make_step(port_loss)
    for b in _batches():
        _, got = run(port.shard_batch(b))
    for k in ("unused", "scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7)


def test_store_rejects_what_is_not_ported():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="placement"):
        ps_tpu_torch.KVStore(placement="zero3")
    assert ps_tpu_torch.KVStore(mode="async")._engine.mode == "async"
    # partition_rules are ported: a rule naming an axis the mesh lacks
    # raises at init, as the reference's, and a bare-string spec at once
    ruled = ps_tpu_torch.KVStore(partition_rules=[("w", (None, "model"))])
    with pytest.raises(ValueError, match="not in mesh axes"):
        ruled.init({"w": torch.zeros(2, 4)})
    with pytest.raises(ValueError, match="tuple of"):
        ps_tpu_torch.KVStore(partition_rules=[("w", "model")])
    store = ps_tpu_torch.KVStore()
    with pytest.raises(RuntimeError, match="init"):
        store.make_step(_port_loss)


def test_apply_count_counts_every_tree_apply_as_the_reference():
    """F4: the sync server counts whole-tree applies as the reference's
    TpuServer does: one a fused step (set_tree_and_state) and one a
    completed per-key push (update_tree); collective_bytes stays 0."""
    k, m = 3, 2
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), _params())
        for _ in range(m)]

    def drive(ps, store, run, batches, arr):
        for b in batches:
            run(b)
        for g in grads:
            kv = {"dense/bias": g["dense"]["bias"],
                  "dense/kernel": g["dense"]["kernel"], "scale": g["scale"]}
            for key, v in kv.items():
                store.push(key, arr(v))
        return store._engine.apply_count

    ps_tpu.init(backend="tpu", mesh_shape={"data": 1})
    ref = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-2)
    ref.init(_params())
    want = drive(ps_tpu, ref, ref.make_step(_ref_loss),
                 [{n: jnp.asarray(v) for n, v in b.items()}
                  for b in _batches()], jnp.asarray)
    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-2)
    port.init(_params())
    got = drive(ps_tpu_torch, port, port.make_step(_port_loss),
                [port.shard_batch(b) for b in _batches()], torch.as_tensor)
    assert want == got == k + m
    assert port._engine.collective_bytes == 0
