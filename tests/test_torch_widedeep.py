"""The slice as a whole: the port's Wide-&-Deep composite step against the
reference's, on the CPU.

The reference's ``make_composite_step`` cannot run on this jax (its
``SparseEmbedding.apply`` passes ``shard_map(check_rep=...)``, which jax
0.9 rejects; ROADMAP R1), so the reference step is built from its
shard_map-free pieces, which is what that step computes at one device:
``jax.value_and_grad`` of ``make_wide_deep_loss_fn`` against the params and
the gathered rows, the ``ps_tpu.optim`` adam update + ``optax.apply_updates``,
and one ``fused_sparse_apply(..., tier='jax')`` per table.

Config: the reference's own small one (tests/test_sparse.py) — 26 features
× 50 rows, D = 8, MLP (32, 16), batch 16, dense adam lr 1e-2, deep adagrad
lr 0.05, wide sgd lr 0.05. Losses match within rtol 1e-5 each step; tables
and dense params after 3 steps within rtol 1e-4, atol 1e-6 — the
reference's own shard-parity tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu_torch
from ps_tpu.data.synthetic import criteo_batches as ref_criteo_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten_with_keys
from ps_tpu.models import wide_deep as ref_wd
from ps_tpu.ops.sparse_apply import fused_sparse_apply as ref_fused_apply
from ps_tpu.optim import make_optimizer as ref_make_optimizer
from ps_tpu.optim.rowwise import make_rowwise as ref_make_rowwise
from ps_tpu_torch.data.synthetic import criteo_batches
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.models import wide_deep as wd
from ps_tpu_torch.ops import sparse_apply as ops
from ps_tpu_torch.train import make_composite_step

VOCAB, DIM, MLP, BATCH = 50, 8, (32, 16), 16


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _ref_params(cfg):
    model = ref_wd.WideDeep(cfg)
    batch0 = next(ref_criteo_batches(BATCH, vocab_size=VOCAB, seed=7))
    rows_shape = (BATCH, cfg.num_sparse, cfg.embed_dim)
    params = model.init(
        jax.random.key(0), jnp.asarray(batch0["dense"]),
        jnp.zeros(rows_shape), jnp.zeros(rows_shape[:2] + (1,)),
    )["params"]
    return model, params


def _tables(total_rows):
    rng = np.random.default_rng(1)
    deep = (0.01 * rng.normal(size=(total_rows, DIM))).astype(np.float32)
    wide = (0.01 * rng.normal(size=(total_rows, 1))).astype(np.float32)
    return deep, wide


def _reference_run(steps, seed):
    cfg = ref_wd.WideDeepConfig(per_feature_vocab=VOCAB, embed_dim=DIM, mlp=MLP)
    model, params = _ref_params(cfg)
    deep_t, wide_t = map(jnp.asarray, _tables(cfg.total_rows))
    dense_opt = ref_make_optimizer("adam", learning_rate=1e-2)
    deep_opt = ref_make_rowwise("adagrad", learning_rate=0.05)
    wide_opt = ref_make_rowwise("sgd", learning_rate=0.05)
    state = dense_opt.init(params)
    deep_s, wide_s = deep_opt.init(deep_t), wide_opt.init(wide_t)
    grad_fn = jax.value_and_grad(ref_wd.make_wide_deep_loss_fn(model),
                                 argnums=(0, 1))
    losses = []
    for batch in ref_criteo_batches(BATCH, vocab_size=VOCAB, seed=seed,
                                    steps=steps):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        gids = cfg.global_ids(batch["sparse"])
        rows = {"deep": deep_t[gids], "wide": wide_t[gids]}
        loss, (gp, grows) = grad_fn(params, rows, batch)
        updates, state = dense_opt.update(gp, state, params)
        params = optax.apply_updates(params, updates)
        flat = gids.reshape(-1)
        deep_t, deep_s = ref_fused_apply(
            deep_t, deep_s, flat, grows["deep"].reshape(-1, DIM), deep_opt,
            "jax")
        wide_t, wide_s = ref_fused_apply(
            wide_t, wide_s, flat, grows["wide"].reshape(-1, 1), wide_opt,
            "jax")
        losses.append(float(loss))
    return losses, np.asarray(deep_t), np.asarray(wide_t), params


def _port_setup(deep_table=None, wide_table=None, params_from=None):
    ps_tpu_torch.init(backend="cuda", device="cpu")
    cfg = wd.WideDeepConfig(per_feature_vocab=VOCAB, embed_dim=DIM, mlp=MLP)
    model = wd.WideDeep(cfg, generator=torch.Generator().manual_seed(0))
    if params_from is not None:
        flat, _ = ref_flatten_with_keys(params_from)
        model.params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    dense = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-2,
                                 placement="sharded")
    dense.init(model.param_tree())
    deep = SparseEmbedding(cfg.total_rows, DIM, optimizer="adagrad",
                           learning_rate=0.05)
    wide = SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                           learning_rate=0.05)
    if deep_table is None:
        deep.init(torch.Generator().manual_seed(1), scale=0.01)
        wide.init(torch.Generator().manual_seed(2), scale=0.01)
    else:
        deep.init(deep_table)
        wide.init(wide_table)
    run = make_composite_step(dense, {"deep": deep, "wide": wide},
                              wd.make_wide_deep_loss_fn(model),
                              wd.make_ids_fn(cfg))
    return cfg, dense, deep, wide, run


def test_composite_step_matches_reference():
    steps, seed = 3, 3
    ref_losses, ref_deep, ref_wide, ref_params = _reference_run(steps, seed)
    cfg = ref_wd.WideDeepConfig(per_feature_vocab=VOCAB, embed_dim=DIM, mlp=MLP)
    _, params0 = _ref_params(cfg)
    deep_np, wide_np = _tables(cfg.total_rows)
    _, dense, deep, wide, run = _port_setup(deep_np, wide_np, params0)
    assert deep.fused_tier == "torch"
    losses = []
    for batch in criteo_batches(BATCH, vocab_size=VOCAB, seed=seed,
                                steps=steps):
        loss, params = run(dense.shard_batch(batch))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(deep.table.numpy(), ref_deep, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(wide.table.numpy(), ref_wide, rtol=1e-4,
                               atol=1e-6)
    flat_ref, _ = ref_flatten_with_keys(ref_params)
    for key, want in flat_ref.items():
        layer, leaf = key.split("/")
        got = params[layer]["weight" if leaf == "kernel" else "bias"]
        got = got.detach().numpy()
        np.testing.assert_allclose(got.T if leaf == "kernel" else got,
                                   np.asarray(want), rtol=1e-4, atol=1e-6)
    assert dense.step == steps and deep.push_count == steps
    assert deep.rows_pushed == steps * BATCH * cfg.num_sparse
    assert deep.bytes_pushed == steps * BATCH * cfg.num_sparse * DIM * 4
    assert deep.dropped_rows == 0


def test_composite_training_decreases_loss():
    cfg, dense, deep, wide, run = _port_setup()
    losses = []
    for batch in criteo_batches(BATCH, vocab_size=VOCAB, seed=0, steps=25):
        loss, _ = run(dense.shard_batch(batch))
        losses.append(float(loss))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses
    assert deep.push_count == 25 and deep.bytes_pushed > 0
    assert dense.bytes_pushed > 0


def test_eager_push_pull_matches_reference_apply():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    rng = np.random.default_rng(5)
    table = rng.normal(size=(40, 4)).astype(np.float32)
    emb = SparseEmbedding(40, 4, optimizer="adam", learning_rate=0.1)
    emb.init(table)
    opt = ref_make_rowwise("adam", learning_rate=0.1)
    ref_t, ref_s = jnp.asarray(table), opt.init(jnp.asarray(table))
    for step in range(3):
        ids = rng.integers(-1, 45, size=12).astype(np.int32)  # filler, OOB
        grads = rng.normal(size=(12, 4)).astype(np.float32)
        emb.push(ids, grads)
        masked = np.where((ids >= 0) & (ids < 40), ids, -1)
        g = np.where(masked[:, None] >= 0, grads, 0.0).astype(np.float32)
        ref_t, ref_s = ref_fused_apply(ref_t, ref_s, jnp.asarray(masked),
                                       jnp.asarray(g), opt, "jax")
        touched = ids[(ids >= 0) & (ids < 40)]
        assert np.all(emb.row_version[touched] == step + 1)
    np.testing.assert_allclose(emb.table.numpy(), np.asarray(ref_t),
                               rtol=1e-6, atol=1e-7)
    rows = emb.pull([3, 3, 17])
    np.testing.assert_array_equal(rows.numpy(), emb.table.numpy()[[3, 3, 17]])
    assert emb.push_count == 3 and emb.rows_pushed == 36
    assert emb.bytes_pushed == 3 * 12 * 4 * 4 and emb.bytes_pulled == 3 * 4 * 4
    assert emb.dropped_rows == 0 and ops.LAUNCHES_BY_RULE["adam"] == 0


def test_eager_push_pull_take_tensor_ids():
    """Ids given as tensors (int64 or int32) go the same way as arrays."""
    ps_tpu_torch.init(backend="cuda", device="cpu")
    rng = np.random.default_rng(6)
    table = rng.normal(size=(40, 4)).astype(np.float32)
    ids = np.array([3, -1, 3, 17, 44, 0], np.int64)
    grads = rng.normal(size=(6, 4)).astype(np.float32)
    a, b = (SparseEmbedding(40, 4, optimizer="sgd", learning_rate=0.1)
            for _ in range(2))
    a.init(table)
    b.init(table)
    a.push(ids, grads)
    b.push(torch.as_tensor(ids), torch.as_tensor(grads))
    np.testing.assert_array_equal(a.table.numpy(), b.table.numpy())
    np.testing.assert_array_equal(a.row_version, b.row_version)
    assert b.row_version[[0, 3, 17]].tolist() == [1, 1, 1]
    rows = b.pull(torch.tensor([17, 3], dtype=torch.int32))
    np.testing.assert_array_equal(rows.numpy(), a.pull([17, 3]).numpy())


def test_generator_init_and_bf16_table():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    emb = SparseEmbedding(30, 6, optimizer="adagrad", dtype=torch.bfloat16)
    t = emb.init(torch.Generator().manual_seed(4), scale=0.5)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (30, 6)
    assert emb.state().dtype == torch.float32 and tuple(emb.state().shape) == (30,)
    with pytest.raises(RuntimeError, match="already"):
        emb.init(torch.Generator())
    with pytest.raises(ValueError, match="table shape"):
        SparseEmbedding(30, 5).init(np.zeros((30, 6), np.float32))
    # the masked full-table tier is ported: 'off' constructs and applies
    off = SparseEmbedding(30, 5, fused_apply="off")
    assert off.fused_tier == "off"


def test_trainer_reads_file_dataset(tmp_path):
    """F9: ``--data DIR`` trains on a column-npy dataset. The port's
    ``file_batches`` with the trainer's arguments (``shuffle=True``,
    ``seed``, the three fields) yields the reference's arrays bitwise, and
    the trainer's logged losses are those of the port's composite step
    driven in this process over that stream with the same seed (the
    reference's own W&D trainer is red under R1, so the two runs compared
    are the port's)."""
    import json

    from ps_tpu.data.files import file_batches as ref_file_batches
    from ps_tpu_torch.data.files import file_batches, write_dataset
    from ps_tpu_torch.examples import train_widedeep

    vocab, dim, batch_size, steps, seed = 20, 4, 8, 12, 5
    rows = next(criteo_batches(40, vocab_size=vocab, seed=11, steps=1))
    data = str(tmp_path / "ds")
    write_dataset(data, rows)
    fields = ("dense", "sparse", "label")
    got = list(file_batches(data, batch_size, steps=steps, shuffle=True,
                            seed=seed, fields=fields))
    want = list(ref_file_batches(data, batch_size, steps=steps, shuffle=True,
                                 seed=seed, fields=fields))
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(fields)
        for k in fields:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])

    log = tmp_path / "losses.jsonl"
    train_widedeep.main([
        "--device", "cpu", "--data", data, "--jsonl", str(log),
        "--steps", str(steps), "--batch-size", str(batch_size),
        "--vocab", str(vocab), "--embed-dim", str(dim),
        "--seed", str(seed)])
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in logged] == [0, 10, steps - 1]

    # the trainer's own construction, driven by hand over the same stream
    ps_tpu_torch.init(backend="cuda", device="cpu")
    cfg = wd.WideDeepConfig(per_feature_vocab=vocab, embed_dim=dim)
    model = wd.WideDeep(cfg, generator=torch.Generator().manual_seed(seed))
    dense = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=1e-3,
                                 placement="sharded")
    dense.init(model.param_tree())
    deep = SparseEmbedding(cfg.total_rows, dim, optimizer="adagrad",
                           learning_rate=0.05)
    deep.init(torch.Generator("cpu").manual_seed(seed + 1), scale=0.01)
    wide = SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                           learning_rate=0.05)
    wide.init(torch.Generator("cpu").manual_seed(seed + 2), scale=0.01)
    run = make_composite_step(dense, {"deep": deep, "wide": wide},
                              wd.make_wide_deep_loss_fn(model),
                              wd.make_ids_fn(cfg))
    losses = [float(run(dense.shard_batch(b))[0])
              for b in file_batches(data, batch_size, steps=steps,
                                    shuffle=True, seed=seed, fields=fields)]
    assert all(np.isfinite(losses))
    assert [r["loss"] for r in logged] == [losses[r["step"]] for r in logged]
