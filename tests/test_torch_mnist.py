"""The MNIST slice of the port (config 1) against the reference.

- ``mnist_batches``: byte-identical to the reference's, worker slices too.
- The MLP: keys and shapes as flax's, flax's init distribution, and the
  forward and the loss after ``params_from_jax`` within rtol 1e-5 of flax.
- ``tests/test_mnist_parity.py``'s two cases through the port's local
  backend against the reference's losses and parameters, rtol 1e-5,
  atol 1e-6 (XLA's and PyTorch's matrix products round differently).
- The trainer on the CPU, with a falling loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.data.synthetic import mnist_batches as ref_mnist_batches
from ps_tpu.models.mlp import MLP as RefMLP
from ps_tpu.models.mlp import cross_entropy_loss as ref_xent
from ps_tpu_torch.data.synthetic import mnist_batches
from ps_tpu_torch.examples import train_mnist_mlp
from ps_tpu_torch.kv.store import value_and_grad
from ps_tpu_torch.models.mlp import MLP, cross_entropy_loss, make_loss_fn


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


@pytest.mark.parametrize("kw", [
    {}, {"seed": 3}, {"worker": 1, "num_workers": 2},
    {"worker": 2, "num_workers": 3, "seed": 5},
])
def test_mnist_batches_are_byte_identical(kw):
    got = list(mnist_batches(8, steps=3, **kw))
    want = list(ref_mnist_batches(8, steps=3, **kw))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        assert gi.tobytes() == wi.tobytes() and gl.tobytes() == wl.tobytes()
    with pytest.raises(ValueError, match="out of range"):
        next(mnist_batches(8, worker=2, num_workers=2))


def _flax(hidden=32, seed=0):
    model = RefMLP(hidden=hidden)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 1)))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def test_init_matches_flax_layout_and_distribution():
    _, ref = _flax(hidden=256)
    params = MLP().init(torch.Generator().manual_seed(0))
    flat = {f"{a}/{b}": v for a, d in params.items() for b, v in d.items()}
    want = {f"{a}/{b}": v for a, d in ref.items() for b, v in d.items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: v.shape for k, v in want.items()}
    k1 = flat["dense1/kernel"].numpy()
    assert abs(k1.std() * np.sqrt(784) - 1) < 0.02  # variance 1/fan_in
    assert np.abs(k1).max() <= 2 / np.sqrt(784) / 0.8796256 + 1e-6
    assert not flat["dense2/bias"].any()
    again = MLP().init(torch.Generator().manual_seed(0))
    assert torch.equal(again["dense1"]["kernel"], flat["dense1/kernel"])


def test_forward_and_loss_match_flax():
    ref_model, ref_params = _flax()
    images, labels = next(ref_mnist_batches(16, seed=2))
    want = np.asarray(ref_model.apply({"params": ref_params}, images))
    model = MLP(hidden=32)
    params = model.params_from_jax(ref_params)
    got = model.apply(params, torch.as_tensor(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(cross_entropy_loss(got, torch.as_tensor(labels))),
        float(ref_xent(jnp.asarray(want), jnp.asarray(labels))), rtol=1e-6)
    with pytest.raises(ValueError, match="do not match"):
        model.params_from_jax({"dense1": ref_params["dense1"]})
    with pytest.raises(ValueError, match="does not fit"):
        MLP(hidden=16).params_from_jax(ref_params)


def _ref_grad_fn(model):
    @jax.jit
    def grad_fn(params, images, labels):
        def loss_fn(p):
            return ref_xent(model.apply({"params": p}, images), labels)
        return jax.value_and_grad(loss_fn)(params)

    return grad_fn


def _close(got, want):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6),
        jax.tree_util.tree_map(lambda t: t.numpy(), got), want)


def test_single_worker_matches_reference():
    """tests/test_mnist_parity.py's first case: 10 steps of push_pull."""
    ref_model, params0 = _flax()
    grad_fn = _ref_grad_fn(ref_model)
    steps, bs = 10, 32

    ps_tpu.init(backend="local")
    store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(params0)
    params = store.pull_all()
    ref_losses = []
    for images, labels in ref_mnist_batches(bs, steps=steps):
        loss, grads = grad_fn(params, jnp.asarray(images), jnp.asarray(labels))
        ref_losses.append(float(loss))
        params = store.push_pull(grads)
    want = jax.tree_util.tree_map(np.asarray, params)
    ps_tpu.shutdown()

    ps_tpu_torch.init(backend="local", device="cpu")
    model = MLP(hidden=32)
    loss_fn = make_loss_fn(model)
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(model.params_from_jax(params0))
    params = store.pull_all()
    losses = []
    for batch in mnist_batches(bs, steps=steps):
        loss, grads, _ = value_and_grad(loss_fn, params,
                                        store.shard_batch(batch))
        losses.append(float(loss))
        params = store.push_pull(grads)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6)
    _close(params, want)
    assert losses[-1] < losses[0]


def test_two_worker_sync_matches_reference():
    """tests/test_mnist_parity.py's second case: two workers each push the
    gradient of their shard, then one pull a step."""
    ref_model, params0 = _flax()
    grad_fn = _ref_grad_fn(ref_model)
    steps, bs = 6, 16

    ps_tpu.init(backend="local", num_workers=2)
    store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(params0)
    params = store.pull_all()
    for (im0, lb0), (im1, lb1) in zip(
            ref_mnist_batches(bs, steps=steps, worker=0, num_workers=2),
            ref_mnist_batches(bs, steps=steps, worker=1, num_workers=2)):
        _, g0 = grad_fn(params, jnp.asarray(im0), jnp.asarray(lb0))
        _, g1 = grad_fn(params, jnp.asarray(im1), jnp.asarray(lb1))
        store.push_all(g0, worker=0)
        store.push_all(g1, worker=1)
        params = store.pull_all()
    want = jax.tree_util.tree_map(np.asarray, params)
    ps_tpu.shutdown()

    ps_tpu_torch.init(backend="local", device="cpu", num_workers=2)
    model = MLP(hidden=32)
    loss_fn = make_loss_fn(model)
    store = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(model.params_from_jax(params0))
    params = store.pull_all()
    for b0, b1 in zip(mnist_batches(bs, steps=steps, worker=0, num_workers=2),
                      mnist_batches(bs, steps=steps, worker=1, num_workers=2)):
        _, g0, _ = value_and_grad(loss_fn, params, store.shard_batch(b0))
        _, g1, _ = value_and_grad(loss_fn, params, store.shard_batch(b1))
        store.push_all(g0, worker=0)
        store.push_all(g1, worker=1)
        params = store.pull_all()
    _close(params, want)


def test_trainer_runs_on_the_cpu(capsys):
    out = train_mnist_mlp.main(["--device", "cpu", "--steps", "21",
                                "--num-workers", "2", "--hidden", "32",
                                "--batch-size", "32"])
    text = capsys.readouterr().out
    assert "step    0  loss" in text and "step   20  loss" in text
    assert "done: 21 steps" in text and "GB/s" in text
    assert out["last_loss"] < out["first_loss"] - 0.5
    # 21 steps x 2 pushes and 21 + 1 pulls of 784*32 + 32 + 32*10 + 10 floats
    assert out["push_pull_gb"] == pytest.approx(
        (42 + 22) * 4 * (784 * 32 + 32 + 320 + 10) / 1e9)
    assert not ps_tpu_torch.is_initialized()
    with pytest.raises(SystemExit, match="num-workers 1"):
        train_mnist_mlp.main(["--device", "cpu", "--backend", "cuda",
                              "--num-workers", "2"])
