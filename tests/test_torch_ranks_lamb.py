"""Sharded LAMB (ZeRO-1, config 3's default placement) across k gloo ranks
on the CPU, against the reference's k-device mesh
(``tests/test_bert.py``'s ``test_lamb_ps_step_matches_plain_optax`` and
``test_bert_lamb_training_decreases_loss``).

Each rank steps the slices it owns; the trust ratio takes ``‖p‖`` of the
whole parameter (every rank holds it) and ``‖u‖`` from the slices' ``Σu²``
summed over the ranks in one all-reduce a step. BERT-tiny's step equals
the reference's sharded step on its k-device mesh and a plain
``optax.lamb`` step within ``test_bert``'s bounds (loss rtol 1e-5;
parameters rtol 2e-4 / atol 1e-5, set there for exactly this reordering
of the norms' sums), at k = 2 and 4. Every rank's parameters are bitwise
equal after each step; ``collective_bytes`` equals the reference's (the
reduce-scatter and the all-gather: the norm all-reduce is uncounted
there, as XLA inserts it) and ``mesh.calls`` holds the one norm
all-reduce. A control whose trust ratio takes each rank's shard-local
``‖u‖`` falls outside the bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import ps_tpu
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mlm_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models import bert as ref_bert

KS = (2, 4)
LOSS_RTOL = 1e-5
PARAMS_TOL = {"rtol": 2e-4, "atol": 1e-5}
DECREASE_STEPS = 15


def _np_flat(tree):
    flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, tree))
    return {k: np.asarray(v) for k, v in flat.items()}


def _inputs():
    """``tests/test_bert.py``'s tiny model, batch and params."""
    cfg = ref_bert.BertConfig.tiny()
    model = ref_bert.BertMLM(cfg)
    batch = next(mlm_batches(16, 32, vocab_size=cfg.vocab_size, seed=5))
    params = model.init(jax.random.key(0),
                        jnp.asarray(batch["input_ids"][:2]),
                        jnp.asarray(batch["attention_mask"][:2]))["params"]
    return model, batch, params


@pytest.fixture(scope="module", params=KS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    """Every case of this file in one group of k ranks: one sharded step,
    the same step replicated, the shard-local-norm control, and the
    reference's 15 steps at lr 1e-2."""
    k = request.param
    model, batch, params = _inputs()
    flat = _np_flat(params)
    decrease = list(mlm_batches(16, 32, vocab_size=model.cfg.vocab_size,
                                seed=0, steps=DECREASE_STEPS))
    cases = [
        ("bert_step", dict(params=flat, batches=[batch],
                           placement="sharded")),
        ("bert_step", dict(params=flat, batches=[batch],
                           placement="replicated")),
        ("bert_step", dict(params=flat, batches=[batch], placement="sharded",
                           local_norms=True)),
        ("bert_step", dict(params=flat, batches=decrease,
                           placement="sharded", learning_rate=1e-2,
                           weight_decay=0.0)),
    ]
    return k, torch_ranks.run_ranks(k, cases,
                                    tmp_path_factory.mktemp(f"lamb{k}"))


@functools.lru_cache(maxsize=None)
def _reference(k):
    """The reference's sharded LAMB step on its k-device mesh and a plain
    optax.lamb step on the global batch."""
    model, batch, params0 = _inputs()
    batch = {key: jnp.asarray(v) for key, v in batch.items()}
    loss_fn = ref_bert.make_mlm_loss_fn(model)
    opt = optax.lamb(1e-3, weight_decay=0.01)
    plain_loss, grads = jax.value_and_grad(loss_fn)(params0, batch)
    updates, _ = opt.update(grads, opt.init(params0), params0)
    plain = optax.apply_updates(params0, updates)
    ps_tpu.init(backend="tpu", mesh_shape={"data": k})
    try:
        store = ps_tpu.KVStore(optimizer="lamb", learning_rate=1e-3,
                               weight_decay=0.01, placement="sharded")
        store.init(params0)
        loss, out = store.make_step(loss_fn)(store.shard_batch(batch))
        mesh = {"loss": float(loss), "params": _np_flat(out),
                "collective_bytes": store.collective_bytes}
    finally:
        ps_tpu.shutdown()
    return mesh, {"loss": float(plain_loss), "params": _np_flat(plain)}


def test_sharded_lamb_step_matches_reference_mesh_and_plain_optax(ranks):
    k, out = ranks
    for want in _reference(k):
        for r in (x[0] for x in out):
            np.testing.assert_allclose(r["loss"], want["loss"],
                                       rtol=LOSS_RTOL)
            assert set(r["params"]) == set(want["params"])
            for key, w in want["params"].items():
                np.testing.assert_allclose(r["params"][key], w,
                                           err_msg=key, **PARAMS_TOL)


def test_every_rank_holds_bitwise_equal_params(ranks):
    _, out = ranks
    for case in (0, 3):
        first = out[0][case]["params"]
        assert any(d is not None for d in out[0][case]["dims"].values())
        for r in out[1:]:
            for key, v in first.items():
                np.testing.assert_array_equal(r[case]["params"][key], v,
                                              err_msg=key)


def test_one_norm_all_reduce_a_step_recorded_with_its_bytes(ranks):
    k, out = ranks
    for r in out:
        dims = r[0]["dims"]
        sliced = sum(d is not None for d in dims.values())
        norm = [c for c in r[0]["calls"]
                if c[0] == "all_reduce" and c[1] == (sliced,)]
        assert norm == [("all_reduce", (sliced,), 4 * sliced,
                         2 * 4 * sliced * (k - 1) // k)], r[0]["calls"]
        # replicated: every tensor whole, no norm reduction
        assert not any(c[1] == (sliced,) for c in r[1]["calls"])
        assert all(d is None for d in r[1]["dims"].values())


def test_collective_bytes_equal_the_references(ranks):
    k, out = ranks
    mesh, _ = _reference(k)
    for r in out:
        assert r[0]["collective_bytes"] == mesh["collective_bytes"] > 0


def test_shard_local_norm_control_fails_the_bounds(ranks):
    """The control's trust ratio takes each rank's own ``‖u‖``: some
    parameter lands outside test_bert's bounds, so the bounds see it."""
    k, out = ranks
    mesh, _ = _reference(k)
    control = out[0][2]["params"]
    outside = [key for key, w in mesh["params"].items()
               if not np.allclose(control[key], w, **PARAMS_TOL)]
    assert outside, "the shard-local-norm control passes the bounds"


def test_sharded_lamb_training_decreases_loss(ranks):
    _, out = ranks
    for r in out:
        losses = r[3]["losses"]
        assert len(losses) == DECREASE_STEPS
        assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2, losses
