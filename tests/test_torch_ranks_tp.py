"""Megatron BERT over a 'model' axis with sharded LAMB, the port against
the reference (``tests/test_bert.py``'s
``test_bert_tensor_parallel_lamb_matches_pure_dp``), and the checkpoint
under partition rules.

BERT-tiny with LAMB 'sharded' and ``bert_partition_rules`` on ``{data:
2, model: 2}`` gloo ranks: Q/K/V column-parallel over the heads,
``attention/out`` and ``output`` row-parallel, ``intermediate``
column-parallel, everything else all-gathered for the forward. Its three
steps equal the reference's pure-dp run on ``{data: 4}`` within that
test's bounds (loss rtol 2e-5 / atol 1e-6; params rtol 2e-4 / atol
2e-5): the trust ratio's ``‖p‖`` of a 'model'-sliced leaf sums its
slices' ``Σp²`` over 'model', and ``‖u‖`` its owned blocks' ``Σu²`` over
'data' and 'model', one flat all-reduce an axis a step. A control whose
norms stay each rank's own falls outside the bounds. A store under the
rules saves one file a rank and resumes bitwise on the same mesh; on a
mesh of another layout it is refused unless ``elastic=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ps_tpu
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mlm_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models import bert as ref_bert

K = 4
MESH = {"data": 2, "model": 2}
STEPS = 3
LOSS_TOL = {"rtol": 2e-5, "atol": 1e-6}
PARAMS_TOL = {"rtol": 2e-4, "atol": 2e-5}


def _inputs():
    """``tests/test_bert.py``'s ``_tiny_model_and_batch``."""
    cfg = ref_bert.BertConfig.tiny()
    model = ref_bert.BertMLM(cfg)
    batch = next(mlm_batches(16, 32, vocab_size=cfg.vocab_size, seed=5))
    params = model.init(jax.random.key(0),
                        jnp.asarray(batch["input_ids"][:2]),
                        jnp.asarray(batch["attention_mask"][:2]))["params"]
    flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, params))
    return model, params, {k: np.asarray(v) for k, v in flat.items()}, batch


@pytest.fixture(scope="module")
def ref_dp():
    """The reference's pure-dp run: LAMB 'sharded' on ``{data: 4}``."""
    model, params, _, batch = _inputs()
    ps_tpu.init(backend="tpu", mesh_shape={"data": 4})
    try:
        store = ps_tpu.KVStore(optimizer="lamb", learning_rate=1e-3,
                               weight_decay=0.01, placement="sharded")
        store.init(params)
        run = store.make_step(ref_bert.make_mlm_loss_fn(model))
        losses = []
        for _ in range(STEPS):
            loss, out = run(store.shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}))
            losses.append(float(loss))
        flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, out))
        return losses, {k: np.asarray(v) for k, v in flat.items()}
    finally:
        ps_tpu.shutdown()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ckpt") / "ckpt"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ckpt_dir):
    """One group of 4 ranks on ``{data: 2, model: 2}``: the tensor-parallel
    run, the shard-local-norm control, and the checkpoint drill (its save
    left at ``ckpt_dir``)."""
    _, _, flat, batch = _inputs()
    cases = [
        ("bert_tp", dict(params=flat, batch=batch, steps=STEPS)),
        ("bert_tp", dict(params=flat, batch=batch, steps=STEPS,
                         local_norms=True)),
        ("bert_tp_ckpt", dict(params=flat, batch=batch, path=str(ckpt_dir))),
    ]
    return torch_ranks.run_ranks(K, cases, tmp_path_factory.mktemp("tp"),
                                 init={"mesh_shape": MESH})


def test_bert_tensor_parallel_lamb_matches_pure_dp(ranks, ref_dp):
    dp_losses, dp_params = ref_dp
    for r in ranks:
        got = r[0]
        np.testing.assert_allclose(got["losses"], dp_losses, **LOSS_TOL)
        for key, w in dp_params.items():
            np.testing.assert_allclose(got["params"][key], w, **PARAMS_TOL,
                                       err_msg=key)
        spec = got["specs"]
        assert spec["layer_0/attention/query/kernel"] == (None, "model",
                                                          None)
        assert spec["layer_0/attention/out/kernel"] == ("model", None, None)
        assert spec["layer_0/intermediate/kernel"] == (None, "model")
        assert spec["layer_0/output/kernel"] == ("model", None)
        assert spec["layer_0/output/bias"] == (None,)
        # a rank holds its 2 of the 4 heads, and half the FFN
        assert got["held"]["layer_0/attention/query/kernel"] == (64, 2, 16)
        assert got["held"]["layer_0/intermediate/kernel"] == (64, 64)
        assert got["held"]["token_embed/embedding"] == (256, 64)
        # the norms: one flat all-reduce an axis a step, of the leaves cut
        # on it: Σu² over 'data'; Σu² and Σp² over 'model' (the (1,)
        # all-reduce is the loss's masked-token count)
        norms = [c for c in got["norm_reduces"] if c[1] != (1,)]
        cut = {a: sum(a in s for s in spec.values()) for a in MESH}
        assert norms == [("data", (cut["data"],)),
                         ("model", (2 * cut["model"],))] * STEPS, norms
    for key in ranks[0][0]["params"]:
        for r in ranks[1:]:
            assert np.array_equal(r[0]["params"][key],
                                  ranks[0][0]["params"][key]), key


def test_returned_params_hold_the_step(ranks):
    """The params tree ``run`` returns holds every leaf after the step: a
    rule's 'model' slice and the whole of the leaves the forward gathers
    (the embeddings, the LayerNorms) equal ``store.params()``, bitwise."""
    for r in ranks:
        got = r[0]
        assert set(got["returned"]) == set(got["returned_want"])
        for key, want in got["returned_want"].items():
            assert np.array_equal(got["returned"][key], want), key


def test_shard_local_norm_control_fails_the_bounds(ranks, ref_dp):
    """Each rank's own ``‖p‖`` and ``‖u‖`` of its slices (the norm
    all-reduces taken out) lands outside the params bound."""
    _, dp_params = ref_dp
    got = ranks[0][1]["params"]
    worst = max(float(np.max(np.abs(got[k] - w) / (PARAMS_TOL["atol"]
                                                   + PARAMS_TOL["rtol"]
                                                   * np.abs(w))))
                for k, w in dp_params.items())
    assert worst > 10, worst


def test_checkpoint_under_rules_resumes_bitwise(ranks):
    """One file a rank; the restored params and LAMB state are the saved
    ones bitwise, and the resumed step equals the uninterrupted one."""
    for r in ranks:
        got = r[2]
        assert got["files"] == [f"arrays.{i:05d}.pt" for i in range(K)]
        assert got["meta"]["mesh_shape"] == MESH
        assert got["meta"]["shard_specs"][
            "params/layer_0/attention/query/kernel"] == [None, "model", None]
        assert got["loss"] == got["want_loss"]
        for key in got["saved_params"]:
            assert np.array_equal(got["restored_params"][key],
                                  got["saved_params"][key]), key
            assert np.array_equal(got["params"][key],
                                  got["want_params"][key]), key
        for i in got["saved_state"]:
            assert np.array_equal(got["restored_state"][i],
                                  got["saved_state"][i]), i


def test_checkpoint_on_another_mesh_is_refused_unless_elastic(
        ranks, ckpt_dir, tmp_path):
    """The same 4 ranks laid out ``{model: 2, data: 2}`` hold other blocks:
    a strict restore of the drill's save is refused, naming both meshes;
    ``elastic=True`` reads it into the new layout, its whole params the
    saved ones."""
    _, _, flat, batch = _inputs()
    other = torch_ranks.run_ranks(
        K, [("bert_tp_ckpt", dict(params=flat, batch=batch,
                                  path=str(ckpt_dir), restore=mode))
            for mode in ("strict", "elastic")],
        tmp_path, init={"mesh_shape": {"model": 2, "data": 2}})
    saved = ranks[0][2]["saved_params"]
    for r in other:
        assert "written on mesh {'data': 2, 'model': 2}" in r[0]["refused"]
        assert "elastic=True" in r[0]["refused"]
        for key, w in saved.items():
            assert np.array_equal(r[1]["restored"][key], w), key
