"""Tensor parallelism over the 'model' axis, the port against the
reference (``tests/test_model_axis.py``).

Placement: the port's spec of every leaf (explicit ``partition_rules``,
first match wins, and the heuristic: 'model' takes the largest divisible
dim, ZeRO the next) equals the reference's ``param_sharding`` spec on
the same mesh shape, the optimizer moments follow their parameter's
rule, and bad rules fail as the reference's fail. Numerics: the block
trained by ``make_step`` on ``{data: 2, model: 2}`` gloo ranks (the
heuristic, whose leaves the store all-gathers for a whole forward, and
the Megatron rules, whose slices a Megatron forward takes) equals the
reference's pure-dp run on 8 devices and its dp×tp run on ``{data: 4,
model: 2}``, within ``test_tp_times_dp_matches_pure_dp``'s bounds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.parallel.sharding import param_sharding as ref_param_sharding
from ps_tpu_torch.parallel.sharding import param_spec, rule_spec

D, FF = 32, 128
K = 4
MESH = {"data": 2, "model": 2}
TOL = {"rtol": 1e-5, "atol": 1e-7}  # test_tp_times_dp_matches_pure_dp's

# tests/test_model_axis.py's Megatron rules
RULES = [
    (r"attn/qkv/kernel$", (None, "model")),
    (r"attn/qkv/bias$", ("model",)),
    (r"attn/out/kernel$", ("model", None)),
    (r"mlp/in/kernel$", (None, "model")),
    (r"mlp/in/bias$", ("model",)),
    (r"mlp/out/kernel$", ("model", None)),
    (r"(attn/out|mlp/out)/bias$", (None,)),
]


def _block_params(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.normal(0, 0.05, shape).astype(np.float32)

    return {
        "attn": {"qkv": {"kernel": t(D, 3 * D), "bias": t(3 * D)},
                 "out": {"kernel": t(D, D), "bias": t(D)}},
        "mlp": {"in": {"kernel": t(D, FF), "bias": t(FF)},
                "out": {"kernel": t(FF, D), "bias": t(D)}},
    }


def _batches(n, gb=16, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (gb, D)).astype(np.float32),
             rng.normal(0, 1, (gb, D)).astype(np.float32)) for _ in range(n)]


def _ref_loss(params, batch):
    x, y = batch
    a = x @ params["attn"]["qkv"]["kernel"] + params["attn"]["qkv"]["bias"]
    a = jnp.tanh(a[:, :D])
    a = a @ params["attn"]["out"]["kernel"] + params["attn"]["out"]["bias"]
    h = jnp.tanh(a @ params["mlp"]["in"]["kernel"] + params["mlp"]["in"]["bias"])
    out = h @ params["mlp"]["out"]["kernel"] + params["mlp"]["out"]["bias"]
    return jnp.mean((out - y) ** 2)


def _ref_train(mesh_shape, rules):
    ps_tpu.init(backend="tpu", mesh_shape=mesh_shape)
    try:
        kw = {"partition_rules": rules} if rules else {}
        store = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-3,
                               placement="sharded", **kw)
        store.init(jax.tree_util.tree_map(jnp.asarray, _block_params()))
        run = store.make_step(_ref_loss)
        losses, out = [], None
        for b in _batches(4):
            loss, out = run(store.shard_batch(tuple(map(jnp.asarray, b))))
            losses.append(float(loss))
        flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, out))
        return losses, {k: np.asarray(v) for k, v in flat.items()}
    finally:
        ps_tpu.shutdown()


def _spec(sharding, ndim):
    """A reference NamedSharding's spec padded to the leaf's rank."""
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case of this file in one group of 4 ranks on
    ``{data: 2, model: 2}``."""
    cases = [
        ("block_steps", dict(params=_block_params(), batches=_batches(4))),
        ("block_steps", dict(params=_block_params(), batches=_batches(4),
                             rules=RULES)),
        ("block_steps", dict(params=_block_params(), batches=_batches(1),
                             rules=RULES, placement="replicated")),
        ("block_async", dict(params=_block_params(), batches=_batches(4),
                             rules=RULES)),
    ]
    return torch_ranks.run_ranks(K, cases, tmp_path_factory.mktemp("tp"),
                                 init={"mesh_shape": MESH})


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
@pytest.mark.parametrize("rules", [None, RULES], ids=["heuristic", "rules"])
def test_placement_equals_the_references(placement, rules):
    """Every leaf's spec, by rules and by the heuristic, is the
    reference's ``param_sharding`` spec on the same mesh shape."""
    ps_tpu.init(backend="tpu", mesh_shape={"data": 4, "model": 2})
    try:
        mesh = ps_tpu.current_context().mesh
        flat, _ = ref_flatten(_block_params())
        for key, leaf in flat.items():
            want = ref_param_sharding(mesh, jnp.asarray(leaf), placement,
                                      key=key, rules=rules)
            got, ruled = param_spec({"data": 4, "model": 2}, leaf.shape,
                                    placement, key, rules)
            assert got == _spec(want, leaf.ndim), key
            assert ruled == bool(rules), key
    finally:
        ps_tpu.shutdown()


def test_rules_place_megatron_style_and_moments_follow(ranks):
    """``test_partition_rules_place_megatron_style`` on the ranks: the
    column- and row-parallel kernels, the post-reduction bias whole, and
    the adam moments on their parameter's rule (``attn/out/bias``: the
    rule says whole where the heuristic would cut it); the count whole."""
    for r in ranks:
        spec, state = r[2]["specs"], r[2]["state_specs"]
        assert spec["attn/qkv/kernel"] == (None, "model")
        assert spec["attn/qkv/bias"] == ("model",)
        assert spec["attn/out/kernel"] == ("model", None)
        assert spec["attn/out/bias"] == (None,)
        assert spec["mlp/in/kernel"] == (None, "model")
        assert spec["mlp/out/kernel"] == ("model", None)
        assert state["mu/attn/qkv/kernel"] == (None, "model")
        assert state["mu/mlp/out/kernel"] == ("model", None)
        assert state["mu/attn/out/bias"] == (None,)
        assert state["nu/attn/qkv/bias"] == ("model",)
        assert state["count"] == ()


def test_heuristic_matches_megatron_for_standard_shapes(ranks):
    for r in ranks:
        spec = r[0]["specs"]
        assert spec["attn/qkv/kernel"] == ("data", "model")
        assert spec["mlp/in/kernel"] == ("data", "model")
        assert spec["mlp/out/kernel"] == ("model", "data")


@pytest.mark.parametrize("case,rules", [(0, None), (1, RULES)],
                         ids=["heuristic", "rules"])
def test_tp_times_dp_matches_pure_dp(ranks, case, rules):
    """dp×tp on the gloo ranks == the reference's pure dp (8 devices) and
    its dp×tp (4×2), step for step at the same global batch; every rank
    ends with the same whole parameters."""
    dp_losses, dp_params = _ref_train({"data": 8}, None)
    tp_losses, tp_params = _ref_train({"data": 4, "model": 2}, rules)
    for r in ranks:
        got = r[case]
        for losses in (dp_losses, tp_losses):
            np.testing.assert_allclose(got["losses"], losses, **TOL)
        for want in (dp_params, tp_params):
            for key, w in want.items():
                np.testing.assert_allclose(got["params"][key], w, **TOL,
                                           err_msg=key)
    for key in ranks[0][case]["params"]:
        for r in ranks[1:]:
            assert np.array_equal(r[case]["params"][key],
                                  ranks[0][case]["params"][key]), key


def test_ranks_sit_in_the_references_device_order(ranks):
    """Rank r is at ``np.unravel_index(r, shape)``: the reference's CPU
    device order."""
    for r, out in enumerate(ranks):
        want = dict(zip(MESH, map(int, np.unravel_index(r, (2, 2)))))
        assert out[0]["coords"] == want


def test_bad_rules_fail_loudly():
    """An unknown axis and an indivisible dim raise; a rule of another
    rank is skipped; a compiled regex works like a string; a bare-string
    spec is refused at construction (``test_bad_rules_fail_loudly``,
    ``test_bare_string_spec_rejected``)."""
    shape = {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="not in"):
        rule_spec(shape, (D, 3 * D), "qkv/kernel",
                  [(r"qkv/kernel$", (None, "tensor"))])
    with pytest.raises(ValueError, match="divisible"):
        rule_spec(shape, (5, 7), "w", [("w", ("model", None))])
    assert rule_spec(shape, (), "w", [("w", ("model", None))]) is None
    got = rule_spec(shape, (4, 8), "blk/kernel",
                    [(re.compile(r"kernel$"), (None, "model"))])
    assert got == (None, "model")
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        with pytest.raises(ValueError, match="tuple of"):
            ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1,
                                 partition_rules=[(r"kernel$", "model")])
        store = ps_tpu_torch.KVStore(
            optimizer="sgd", learning_rate=0.1,
            partition_rules=[(r"qkv/kernel$", (None, "tensor"))])
        with pytest.raises(ValueError, match="not in"):
            store.init(torch_ranks._tree_t(_block_params()))
    finally:
        ps_tpu_torch.shutdown()


def test_replicated_rules_hold_slices_and_step_them(ranks):
    """Under 'replicated' a rule still slices over 'model': each rank
    holds and steps its slice (one step against the reference's)."""
    ps_tpu.init(backend="tpu", mesh_shape={"data": 4, "model": 2})
    try:
        store = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-3,
                               placement="replicated", partition_rules=RULES)
        store.init(jax.tree_util.tree_map(jnp.asarray, _block_params()))
        run = store.make_step(_ref_loss)
        loss, out = run(store.shard_batch(tuple(map(jnp.asarray,
                                                    _batches(1)[0]))))
        want, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, out))
    finally:
        ps_tpu.shutdown()
    for r in ranks:
        got = r[2]
        assert got["specs"]["mlp/in/kernel"] == (None, "model")
        np.testing.assert_allclose(got["losses"], [float(loss)], **TOL)
        for key, w in want.items():
            np.testing.assert_allclose(got["params"][key], np.asarray(w),
                                       **TOL, err_msg=key)


def test_async_server_takes_the_rules(ranks):
    """The async DC-ASGD server under the rules on ``{data: 2, model:
    2}`` (pulls whole, each rank stepping its blocks) == the same cycles
    on one process."""
    import ps_tpu_torch.kv.keys as keys

    ps_tpu_torch.init(backend="cuda", device="cpu", mode="async")
    try:
        store = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-3)
        store.init(torch_ranks._tree_t(_block_params()))
        run = store.make_async_step(torch_ranks._block_loss)
        import torch

        losses = [float(run(tuple(torch.as_tensor(x) for x in b)))
                  for b in _batches(4)]
        want, _ = keys.flatten_with_keys(store.params())
    finally:
        ps_tpu_torch.shutdown()
    for r in ranks:
        got = r[3]
        assert got["version"] == 4
        assert got["specs"]["attn/qkv/kernel"] == (None, "model")
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        for key, w in want.items():
            np.testing.assert_allclose(got["params"][key], w.numpy(), **TOL,
                                       err_msg=key)
