"""The port's optimizers against the reference's, on the same numpy inputs.

- Row-wise rules (``apply_rows`` and the derived ``apply``) against
  ``ps_tpu.optim.rowwise``: sgd bitwise in f32; adagrad and adam within
  rtol 1e-6, atol 1e-7 (mean over D and ``pow`` may round differently).
- Dense sgd and adam against optax (through ``ps_tpu.optim``) over 5
  steps, within rtol 1e-6.
- momentum, with and without nesterov, against ``optax.sgd(lr, momentum,
  nesterov)`` over 5 steps, bitwise in f32 (the same f32 operations in the
  same order).
- lamb against ``optax.lamb`` over 3 steps on a tree that holds a zero
  tensor (its trust ratio is exactly 1 at step 1), within rtol 1e-6.
- each of the four with a learning-rate schedule against optax's
  ``linear_schedule`` over 5 steps, within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ps_tpu.optim import make_optimizer as ref_make_optimizer
from ps_tpu.optim import rowwise as ref_rowwise
from ps_tpu_torch.optim import Optimizer, make_optimizer
from ps_tpu_torch.optim import rowwise

R, D = 12, 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(R, D)).astype(np.float32)
    gsum = rng.normal(size=(R, D)).astype(np.float32)
    cnt = rng.integers(0, 3, size=R).astype(np.int32)  # 0 = untouched
    gsum[cnt == 0] = 0.0
    return rows, gsum, cnt


def _leaves_np(state):
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


@pytest.mark.parametrize("view", ["apply_rows", "apply"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_rowwise_matches_reference(optimizer, view):
    kw = {"learning_rate": 0.05}
    ref = ref_rowwise.make_rowwise(optimizer, **kw)
    port = rowwise.make_rowwise(optimizer, **kw)
    rows, _, _ = _inputs(0)
    ref_rows, ref_state = jnp.asarray(rows), ref.init(jnp.asarray(rows))
    port_rows = torch.as_tensor(rows)
    port_state = port.init(port_rows)
    for step in range(3):  # state carries over
        _, gsum, cnt = _inputs(step + 1)
        arg = cnt if view == "apply_rows" else cnt > 0
        ref_rows, ref_state = getattr(ref, view)(
            ref_rows, ref_state, jnp.asarray(gsum), jnp.asarray(arg))
        port_rows, port_state = getattr(port, view)(
            port_rows, port_state, torch.as_tensor(gsum), torch.as_tensor(arg))
    got, want = port_rows.numpy(), np.asarray(ref_rows)
    if optimizer == "sgd":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ref_leaves = jax.tree_util.tree_leaves(ref_state)
    port_leaves = _leaves_np(port_state)
    assert len(ref_leaves) == len(port_leaves)
    for g, w in zip(port_leaves, ref_leaves):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_rowwise_state_size_and_kernel_description(optimizer):
    port = rowwise.make_rowwise(optimizer, learning_rate=0.3)
    ref = ref_rowwise.make_rowwise(optimizer, learning_rate=0.3)
    for dim in (1, 16):
        assert port.state_scalars_per_row(dim) == ref.state_scalars_per_row(dim)
    assert port.kind == optimizer and port.hyper["lr"] == 0.3


def _dense_params(seed):
    rng = np.random.default_rng(seed)
    return {"a/kernel": rng.normal(size=(4, 3)).astype(np.float32),
            "a/bias": rng.normal(size=(3,)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 1e-2}),
    ("adam", {"learning_rate": 3e-3, "b1": 0.8, "b2": 0.99, "eps": 1e-6}),
])
def test_dense_optimizer_matches_optax(name, kw):
    ref = ref_make_optimizer(name, **kw)
    port = make_optimizer(name, **kw)
    p0 = _dense_params(0)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref.init(ref_p)
    port_p = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    port_s = port.init(port_p)
    for step in range(5):
        grads = _dense_params(step + 1)
        updates, ref_s = ref.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        port.step_(port_p, {k: torch.as_tensor(v) for k, v in grads.items()},
                   port_s)
    for k in p0:
        np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-6)
    if name == "adam":
        assert int(port_s["count"]) == 5
        assert port_s["count"].dtype == torch.int32


@pytest.mark.parametrize("kw", [
    {"learning_rate": 0.1, "momentum": 0.9},
    {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True},
    {"learning_rate": 0.03, "momentum": 0.5, "nesterov": True},
])
def test_momentum_is_bitwise_with_optax(kw):
    ref = ref_make_optimizer("momentum", **kw)
    port = make_optimizer("momentum", **kw)
    p0 = _dense_params(0)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref.init(ref_p)
    port_p = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    port_s = port.init(port_p)
    for step in range(5):
        grads = _dense_params(step + 1)
        updates, ref_s = ref.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        port.step_(port_p, {k: torch.as_tensor(v) for k, v in grads.items()},
                   port_s)
        for k in p0:
            np.testing.assert_array_equal(port_p[k].numpy(),
                                          np.asarray(ref_p[k]), err_msg=k)
    trace = jax.tree_util.tree_leaves(ref_s)
    assert len(trace) == len(port_s)
    for k, want in zip(sorted(port_s), trace):
        np.testing.assert_array_equal(port_s[k].numpy(), np.asarray(want))
    assert port.name == "momentum"


@pytest.mark.parametrize("kw", [
    {"learning_rate": 1e-3, "weight_decay": 0.01},
    {"learning_rate": 1e-2, "b1": 0.8, "b2": 0.99, "eps": 1e-5},
])
def test_lamb_matches_optax(kw):
    ref = optax.lamb(**kw)
    port = make_optimizer("lamb", **kw)
    p0 = _dense_params(0)
    p0["zero/bias"] = np.zeros((6,), np.float32)  # flax starts biases at 0
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref.init(ref_p)
    port_p = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    port_s = port.init(port_p)
    for step in range(3):
        grads = _dense_params(step + 1)
        grads["zero/bias"] = np.random.default_rng(step).normal(
            size=(6,)).astype(np.float32)
        updates, ref_s = ref.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        port.step_(port_p, {k: torch.as_tensor(v) for k, v in grads.items()},
                   port_s)
        np.testing.assert_allclose(port_p["zero/bias"].numpy(),
                                   np.asarray(ref_p["zero/bias"]), rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-6)
    assert port.name == "lamb" and int(port_s["count"]) == 3


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}),
    ("momentum", {"momentum": 0.9}),
    ("adam", {}),
    ("lamb", {"weight_decay": 0.01}),
])
def test_learning_rate_schedule_matches_optax(name, kw):
    """A schedule ``count -> lr``: optax.linear_schedule in the reference,
    the same linear function of the port's int32 count tensor here. Step 0
    uses lr(0); the rate reaches its end value after 3 steps."""
    ref_sched = optax.linear_schedule(0.1, 0.02, transition_steps=3)
    seen = []

    def port_sched(count):
        seen.append(int(count))
        frac = 1 - torch.clip(count, 0, 3) / 3
        return (0.1 - 0.02) * frac + 0.02

    ref = ref_make_optimizer(name, learning_rate=ref_sched, **kw)
    port = make_optimizer(name, learning_rate=port_sched, **kw)
    p0 = _dense_params(0)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref.init(ref_p)
    port_p = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    port_s = port.init(port_p)
    for step in range(5):
        grads = _dense_params(step + 1)
        updates, ref_s = ref.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        port.step_(port_p, {k: torch.as_tensor(v) for k, v in grads.items()},
                   port_s)
        for k in p0:
            np.testing.assert_allclose(port_p[k].numpy(),
                                       np.asarray(ref_p[k]), rtol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert seen == [0, 1, 2, 3, 4]
    count = port_s["schedule_count"]
    assert int(count) == 5 and count.dtype == torch.int32


def test_make_optimizer_resolves_and_rejects():
    opt = make_optimizer("ADAM", learning_rate=0.1)
    assert isinstance(opt, Optimizer) and opt.name == "adam"
    assert make_optimizer(opt) is opt
    assert make_optimizer("Momentum", learning_rate=0.1).name == "momentum"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("rmsprop")
    with pytest.raises(ValueError, match="kwargs"):
        make_optimizer(opt, learning_rate=0.2)
    with pytest.raises(TypeError):
        make_optimizer(3)
    with pytest.raises(ValueError, match="unknown rowwise optimizer"):
        rowwise.make_rowwise("lamb")
