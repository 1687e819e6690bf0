"""The cuda backend across k gloo ranks on the CPU, against the reference's
k-device mesh (``tests/test_tpu_backend.py`` and the data-axis cases of
``tests/test_hlo_collectives.py``).

Four ranks (``tests/test_torch_ranks_harness.py``) run every case of one process
group; the reference runs in this process on the first four of the eight
virtual CPU devices (``mesh_shape={'data': 4}``). Inputs come from the
reference's seeded generators as numpy. Tolerances are the reference's:
losses rtol 1e-5 / atol 1e-6, parameters 1e-4 / 1e-6 after 5 adam steps
(the reductions sum in another order), byte counts exact. Where the
reference reads its compiled HLO for the collectives a step runs, the
port's ranks report the collectives they recorded
(``ps_tpu_torch.parallel.collectives``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models.mlp import MLP, cross_entropy_loss

K = 4
HIDDEN = 32
ADAM = {"learning_rate": 0.01}
W1, W2 = (256, 256), (256, 128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(hidden=HIDDEN):
    model = MLP(hidden=hidden)
    return model, _np_tree(model.init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])


def _loss_fn(model):
    def loss_fn(params, batch):
        images, labels = batch
        return cross_entropy_loss(model.apply({"params": params}, images),
                                  labels)
    return loss_fn


def _batches(bs, steps):
    return list(mnist_batches(bs, steps=steps))


def _ref_steps(placement, optimizer, opt_kw, batches, aggregate="mean"):
    """The reference's KVStore step on its K-device mesh."""
    model, params = _params()
    ps_tpu.init(backend="tpu", mesh_shape={"data": K})
    try:
        store = ps_tpu.KVStore(optimizer=optimizer, placement=placement,
                               aggregate=aggregate, **opt_kw)
        store.init(params)
        run = store.make_step(_loss_fn(model))
        losses = []
        for images, labels in batches:
            loss, out = run(store.shard_batch((jnp.asarray(images),
                                               jnp.asarray(labels))))
            losses.append(float(loss))
        state = store._engine._state
        specs = {k: tuple(v.sharding.spec)
                 for k, v in store._engine._params.items()}
        mesh_devices = list(store._engine.mesh.devices.flat)
        return dict(losses=losses, params=_np_tree(out), state=state,
                    specs=specs, devices=mesh_devices,
                    collective_bytes=store.collective_bytes)
    finally:
        ps_tpu.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of this file in one group of K ranks."""
    _, params = _params()
    steps5 = _batches(64, 5)
    cases = [
        ("dense_steps", dict(params=params, batches=steps5, optimizer="adam",
                             opt_kw=ADAM, placement="replicated",
                             hidden=HIDDEN)),
        ("dense_steps", dict(params=params, batches=steps5, optimizer="adam",
                             opt_kw=ADAM, placement="sharded",
                             hidden=HIDDEN)),
        ("dense_steps", dict(params=params, batches=_batches(32, 4),
                             optimizer="sgd", opt_kw={"learning_rate": 0.1},
                             placement="replicated", hidden=HIDDEN)),
        ("dense_steps", dict(params=params, batches=_batches(32, 2),
                             optimizer="sgd", opt_kw={"learning_rate": 0.1},
                             placement="sharded", hidden=HIDDEN,
                             aggregate="sum")),
        ("per_key", {}),
        ("byte_accounting", {}),
        ("collectives_recorded", dict(placement="replicated")),
        ("collectives_recorded", dict(placement="sharded")),
    ]
    return torch_ranks.run_ranks(K, cases,
                                 tmp_path_factory.mktemp("backend"))


def _case(ranks, i):
    return [r[i] for r in ranks]


def test_mesh_spans_the_ranks(ranks):
    for r in _case(ranks, 0):
        assert r["num_workers"] == K


def test_mesh_shape_device_mismatch():
    # one process is one rank: a mesh of 16 has no devices to run on
    with pytest.raises(ValueError, match="devices"):
        ps_tpu_torch.init(device="cpu", mesh_shape={"data": 16})
    assert not ps_tpu_torch.is_initialized()


def test_mesh_smaller_than_the_ranks_raises(tmp_path):
    """The reference allows a mesh smaller than its devices; here every
    rank of the group is a worker and a server, so a smaller mesh would
    leave ranks outside both: it raises on every rank."""
    out = torch_ranks.run_ranks(2, [], tmp_path,
                                init={"mesh_shape": {"data": 1}})
    for r in out:
        assert "needs 1 devices" in r[0]["init_error"]


def test_model_axis_raises_naming_item_7():
    """The 'model' axis (item 7) is ported: a mesh with one is refused only
    where it has no ranks to run on, here one process for two ranks, and
    an unknown axis is refused by name."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        ps_tpu_torch.init(device="cpu", mesh_shape={"data": 1, "model": 2})
    assert not ps_tpu_torch.is_initialized()
    with pytest.raises(ValueError, match="unknown"):
        ps_tpu_torch.init(device="cpu", mesh_shape={"tensor": 1})
    assert not ps_tpu_torch.is_initialized()


@pytest.mark.parametrize("placement,case", [("replicated", 0),
                                            ("sharded", 1)])
def test_fused_step_matches_manual_allreduce(ranks, placement, case):
    """K ranks ≡ the reference's step on its K-device mesh ≡ a plain
    single-device optax program on the global batch."""
    model, params0 = _params()
    batches = _batches(64, 5)
    ref = _ref_steps(placement, "adam", ADAM, batches)
    opt = optax.adam(0.01)
    state, params = opt.init(params0), params0
    manual_losses = []
    for images, labels in batches:
        loss, grads = jax.value_and_grad(_loss_fn(model))(
            params, (jnp.asarray(images), jnp.asarray(labels)))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        manual_losses.append(float(loss))
    want_params, _ = ref_flatten(_np_tree(params))
    ref_params, _ = ref_flatten(ref["params"])
    for r in _case(ranks, case):
        for losses in (ref["losses"], manual_losses):
            np.testing.assert_allclose(r["losses"], losses, rtol=1e-5,
                                       atol=1e-6)
        for want in (want_params, ref_params):
            for key, w in want.items():
                np.testing.assert_allclose(r["params"][key], w, rtol=1e-4,
                                           atol=1e-6, err_msg=key)


def test_sharded_placement_actually_shards(ranks):
    """Each rank owns exactly the slice device r owns in the reference:
    the same dimension of every leaf, and its adam moments equal that
    device's shard of the reference's. The (10,) bias does not divide by
    4 and stays whole."""
    ref = _ref_steps("sharded", "adam", ADAM, _batches(64, 5))
    out = _case(ranks, 1)
    for key, spec in ref["specs"].items():
        want = spec.index("data") if "data" in spec else None
        assert out[0]["dims"][key] == want, (key, spec)
    assert out[0]["dims"]["dense2/bias"] is None
    mu = ref["state"][0].mu["dense1/kernel"]
    # the port's adam state: count, mu/<4 keys sorted>, nu/<4 keys sorted>
    leaf = "00002"  # mu/dense1/kernel
    assert out[0]["state_dims"][2] == 0
    for rank, r in enumerate(out):
        shard = next(s for s in mu.addressable_shards
                     if s.device == ref["devices"][rank])
        rows = (784 // K) * rank
        assert shard.index[0] == slice(rows, rows + 784 // K)
        assert r["state"][leaf].shape == (784 // K, HIDDEN)
        np.testing.assert_allclose(r["state"][leaf], np.asarray(shard.data),
                                   rtol=1e-4, atol=1e-6)
    # the replicated placement keeps whole moments on every rank
    assert _case(ranks, 0)[0]["state"][leaf].shape == (784, HIDDEN)


def test_per_key_protocol_across_ranks(ranks):
    for rank, r in enumerate(_case(ranks, 4)):
        assert r["blocked"]
        np.testing.assert_allclose(r["w"], np.zeros(8))
        np.testing.assert_allclose(r["b"], -0.5 * np.ones(8))
        # every rank pushed its rank number: the mean 1.5 is applied
        np.testing.assert_allclose(r["mean"], -np.full(4, (K - 1) / 2))


def test_matches_local_backend_trajectory(ranks):
    """Same data, same optimizer: K ranks ≡ the reference's local PS."""
    model, params = _params()
    ps_tpu.init(backend="local")
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1)
        store.init(params)
        run = store.make_step(_loss_fn(model))
        local = [float(run((jnp.asarray(i), jnp.asarray(l)))[0])
                 for i, l in _batches(32, 4)]
    finally:
        ps_tpu.shutdown()
    for r in _case(ranks, 2):
        np.testing.assert_allclose(r["losses"], local, rtol=1e-5, atol=1e-6)


def test_aggregate_sum_scales_by_the_world_size(ranks):
    ref = _ref_steps("sharded", "sgd", {"learning_rate": 0.1},
                     _batches(32, 2), aggregate="sum")
    ref_params, _ = ref_flatten(ref["params"])
    for r in _case(ranks, 3):
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-6)
        for key, w in ref_params.items():
            np.testing.assert_allclose(r["params"][key], w, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_collective_byte_accounting(ranks):
    """The reference's analytic bytes, exactly: 2·256·3/4 for the push of
    one 8x8 f32 tensor over 4 ranks, and the same totals as the
    reference's after the adam runs of both placements."""
    ps_tpu.init(backend="tpu", mesh_shape={"data": K})
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1)
        store.init({"w": jnp.ones((8, 8), jnp.float32)})
        store.push_pull({"w": jnp.ones((8, 8), jnp.float32)})
        want = store._engine.collective_bytes
    finally:
        ps_tpu.shutdown()
    assert want == 384
    for r in _case(ranks, 5):
        assert r["collective_bytes"] == want
    for placement, case in (("replicated", 0), ("sharded", 1)):
        ref = _ref_steps(placement, "adam", ADAM, _batches(64, 5))
        for r in _case(ranks, case):
            assert r["collective_bytes"] == ref["collective_bytes"] > 0


# -- the collectives a step runs (test_hlo_collectives, 'data' axis) ------------


def _ops(calls):
    return [(op, shape) for op, shape, _, _ in calls]


def test_replicated_is_one_full_allreduce_no_gather(ranks):
    for r in _case(ranks, 6):
        ops = _ops(r["calls"])
        # the two gradients ride one flat all-reduce, then the loss's
        n = int(np.prod(W1)) + int(np.prod(W2))
        assert ops == [("all_reduce", (n,)), ("all_reduce", ())], ops
        assert r["dims"] == {"w1": None, "w2": None}
        assert r["state_shapes"]["00000"] == W1  # whole traces


def test_sharded_scatters_largest_grad_and_gathers_params(ranks):
    for r in _case(ranks, 7):
        ops = _ops(r["calls"])
        assert ("reduce_scatter", W1) in ops and ("reduce_scatter", W2) in ops
        assert ("all_gather", W1) in ops and ("all_gather", W2) in ops
        assert not any(op == "all_reduce" and int(np.prod(shape)) >= 32768
                       for op, shape in ops), ops
        # the momentum traces are shard-shaped (dim 0 / 4)
        assert r["state_shapes"]["00000"] == (W1[0] // K, W1[1])


def test_sharded_largest_param_never_pays_double_traffic(ranks):
    """The largest parameter's gradient is reduce-scattered, never
    all-reduced whole, and its value gathered once: per rank its bytes are
    one reduce-scatter's and one all-gather's, as the reference's
    accounting counts them."""
    for r in _case(ranks, 7):
        w1 = [(op, ring) for op, shape, _, ring in r["calls"]
              if shape == W1]
        nbytes = int(np.prod(W1)) * 4
        assert sorted(w1) == [("all_gather", nbytes * (K - 1) // K),
                              ("reduce_scatter", nbytes * (K - 1) // K)]


# -- the byte algebra and the placement policy, against the reference's ---------

SHAPES = [(784, 32), (32,), (10,), (32, 10), (256, 256), (3, 5, 7), (),
          (1, 13), (64, 3, 3, 3), (1000, 2048)]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_byte_algebra_equals_the_reference(k):
    import torch

    from ps_tpu.parallel import collectives as ref
    from ps_tpu_torch.parallel import collectives as port

    tree = {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(SHAPES)}
    ttree = {key: torch.zeros(v.shape) for key, v in tree.items()}
    for name in ("allreduce_bytes", "reduce_scatter_bytes",
                 "all_gather_bytes", "all_to_all_bytes"):
        want = getattr(ref, name)(tree, k)
        assert getattr(port, name)(tree, k) == want
        assert getattr(port, name)(ttree, k) == want
    assert port.tree_bytes(ttree) == ref.tree_bytes(tree)


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_every_leaf_is_sharded_on_the_reference_dimension(k):
    """``param_spec`` puts 'data' on the dimension the reference's
    ``_pick_dim`` picks for every shape (nowhere where it keeps the leaf
    whole), so rank r owns the slice device r owns."""
    from ps_tpu.parallel.sharding import _pick_dim
    from ps_tpu_torch.parallel.sharding import param_spec

    for shape in SHAPES:
        want = _pick_dim(shape, k) if shape else None
        spec, _ = param_spec({"data": k}, shape, "sharded")
        got = spec.index("data") if "data" in spec else None
        assert got == want, (shape, k)
        spec, _ = param_spec({"data": k}, shape, "replicated")
        assert "data" not in spec
