"""The BERT-MLM slice: the port's model, loss, data and LAMB step against
the reference's, on the CPU.

Inputs and weights are made once, by the reference (``jax.random.key(0)``
and ``mlm_batches``), and carried into the port with
``BertMLM.params_from_jax``. Tolerances are the reference's own: logits of
``attn='full'`` and ``'flash'`` within rtol/atol 2e-4
(tests/test_flash_attention.py's model-level bound), one LAMB step within
loss rtol 1e-5 and params rtol 2e-4, atol 1e-5 (tests/test_bert.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.data.synthetic import mlm_batches as ref_mlm_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten_with_keys
from ps_tpu.models import bert as ref_bert
from ps_tpu_torch.data.synthetic import mlm_batches
from ps_tpu_torch.examples import train_bert_mlm
from ps_tpu_torch.models import bert

# the module itself: ps_tpu_torch.ops exports the function under its name
fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _ref(batch_size=16, seq_len=32, **cfg_kw):
    cfg = ref_bert.BertConfig.tiny(**cfg_kw)
    model = ref_bert.BertMLM(cfg)
    batch = next(ref_mlm_batches(batch_size, seq_len,
                                 vocab_size=cfg.vocab_size, seed=5))
    params = model.init(jax.random.key(0),
                        jnp.asarray(batch["input_ids"][:2]),
                        jnp.asarray(batch["attention_mask"][:2]))["params"]
    return model, params, batch


def _port(params, **cfg_kw):
    model = bert.BertMLM(bert.BertConfig.tiny(**cfg_kw),
                         generator=torch.Generator().manual_seed(0))
    flat, _ = ref_flatten_with_keys(params)
    model.params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    return model


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_logits_match_reference(attn):
    model, params, batch = _ref(batch_size=2, seq_len=128, max_len=128,
                                attn=attn)
    mask = batch["attention_mask"].copy()
    mask[:, 100:] = 0  # trailing padding, the BERT convention
    want = model.apply({"params": params}, jnp.asarray(batch["input_ids"]),
                       jnp.asarray(mask))
    port = _port(params, max_len=128, attn=attn)
    before = fa.LAUNCHES
    got = port(torch.as_tensor(batch["input_ids"]), torch.as_tensor(mask))
    assert fa.LAUNCHES == before  # CPU tensors run the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 128, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_keys_shapes_and_init_follow_flax():
    _, params, _ = _ref()
    ref_flat, _ = ref_flatten_with_keys(params)
    model = bert.BertMLM(bert.BertConfig.tiny(),
                         generator=torch.Generator().manual_seed(1))
    flat, _ = ps_tpu_torch.kv.keys.flatten_with_keys(model.param_tree())
    assert list(flat) == list(ref_flat)
    for key, want in ref_flat.items():
        got = flat[key].detach().numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, key
        if want.std() == 0:  # biases, mlm_bias, LayerNorm: zeros and ones
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:  # the same distribution: std within sampling noise, same tails
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.2,
                                       err_msg=key)
            if key.endswith("kernel"):  # truncated at 2 std of the raw normal
                assert np.abs(got).max() <= np.abs(want).max() * 1.01, key
    with pytest.raises(ValueError, match="do not match"):
        model.params_from_jax({"mlm_bias": np.zeros(512, np.float32)})
    bad = {k: np.asarray(v) for k, v in ref_flat.items()}
    bad["mlm_bias"] = np.zeros(511, np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        model.params_from_jax(bad)


def test_forward_rejects_too_long_sequences():
    model = bert.BertMLM(bert.BertConfig.tiny())
    ids = torch.zeros((1, 65), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        model(ids, torch.ones_like(ids))


def test_mlm_loss_masks_ignore_index():
    # 2 positions, only the first counts
    logits = torch.tensor([[[2.0, 0.0, 0.0], [0.0, 5.0, 0.0]]])
    labels = torch.tensor([[0, -100]])
    expected = -torch.log_softmax(logits[0, 0], -1)[0]
    np.testing.assert_allclose(float(bert.mlm_loss(logits, labels)),
                               float(expected), rtol=1e-6)
    # all-ignored: finite zero loss, no NaN from the 0/0 guard
    assert float(bert.mlm_loss(logits, torch.tensor([[-100, -100]]))) == 0.0
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 16, 50)).astype(np.float32)
    labels = np.where(rng.random((2, 16)) < 0.3, rng.integers(0, 50, (2, 16)),
                      -100).astype(np.int32)
    np.testing.assert_allclose(
        float(bert.mlm_loss(torch.as_tensor(logits), torch.as_tensor(labels))),
        float(ref_bert.mlm_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


def test_attention_mask_blocks_padding():
    _, params, batch = _ref(batch_size=2, seq_len=16)
    model = _port(params)
    ids = torch.as_tensor(batch["input_ids"])
    mask = torch.as_tensor(batch["attention_mask"])
    with torch.no_grad():
        full = model(ids, mask)
        half_mask = mask.clone()
        half_mask[:, 8:] = 0
        half = model(ids, half_mask)
        assert not np.allclose(full[:, :8], half[:, :8])
        corrupted = ids.clone()
        corrupted[:, 8:] = 7
        half2 = model(corrupted, half_mask)
    np.testing.assert_allclose(half[:, :8], half2[:, :8], atol=1e-5)


def test_bert_base_param_count():
    """BERT-base with tied MLM decoder is ~110M params (shapes only)."""
    model = bert.BertMLM(bert.BertConfig.base(), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert 108e6 < n < 112e6, n


def test_lamb_step_matches_reference():
    model, params0, batch = _ref()
    ps_tpu.init(backend="tpu")
    try:
        store = ps_tpu.KVStore(optimizer="lamb", learning_rate=1e-3,
                               weight_decay=0.01, placement="sharded")
        store.init(params0)
        run = store.make_step(ref_bert.make_mlm_loss_fn(model))
        ref_loss, ref_params = run(store.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}))
        ref_flat, _ = ref_flatten_with_keys(ref_params)
        ref_flat = {k: np.asarray(v) for k, v in ref_flat.items()}
        ref_loss = float(ref_loss)
    finally:
        ps_tpu.shutdown()

    ps_tpu_torch.init(backend="cuda", device="cpu")
    port = _port(params0)
    store = ps_tpu_torch.KVStore(optimizer="lamb", learning_rate=1e-3,
                                 weight_decay=0.01, placement="sharded")
    store.init(port.param_tree())
    assert store.keys() == list(ref_flat)
    loss, new_params = store.make_step(bert.make_mlm_loss_fn(port))(
        store.shard_batch(batch))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    flat, _ = ps_tpu_torch.kv.keys.flatten_with_keys(new_params)
    for key, want in ref_flat.items():
        np.testing.assert_allclose(flat[key].detach().numpy(), want,
                                   rtol=2e-4, atol=1e-5, err_msg=key)


def test_lamb_training_decreases_loss():
    _, params, _ = _ref()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    model = _port(params)
    store = ps_tpu_torch.KVStore(optimizer="lamb", learning_rate=1e-2,
                                 placement="sharded")
    store.init(model.param_tree())
    run = store.make_step(bert.make_mlm_loss_fn(model))
    losses = []
    for batch in mlm_batches(16, 32, vocab_size=512, seed=0, steps=15):
        loss, _ = run(store.shard_batch(batch))
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2, losses


def test_mlm_batches_byte_identical():
    for kw in ({"vocab_size": 512, "seed": 3}, {"seed": 0}):
        got = list(mlm_batches(4, 64, steps=3, **kw))
        want = list(ref_mlm_batches(4, 64, steps=3, **kw))
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                assert g[k].tobytes() == w[k].tobytes()
    with pytest.raises(ValueError, match="too small"):
        next(mlm_batches(1, 4, vocab_size=100))


def test_trainer_runs_tiny_on_cpu(capsys):
    seq_s = train_bert_mlm.main(["--size", "tiny", "--device", "cpu",
                                 "--steps", "3", "--batch-size", "4",
                                 "--seq-len", "32", "--dtype", "float32"])
    out = capsys.readouterr().out
    assert seq_s > 0 and "seq/s" in out.splitlines()[-1]
    # --model-axis is ported (Megatron over a 'model' axis); one process
    # has no second rank for it, as the reference's one device has none
    with pytest.raises(SystemExit, match="must divide the device count"):
        train_bert_mlm.main(["--size", "tiny", "--device", "cpu",
                             "--model-axis", "2"])


@pytest.mark.parametrize("num_rows,ids_kind", [(2, "zeros"), (2, "mixed"),
                                               (512, "random")])
def test_embedding_backward_is_fixed_order_and_equals_f_embedding(
        num_rows, ids_kind):
    """F5: ``Embed``'s forward is ``F.embedding``'s, bitwise; its gradient
    (ids stably sorted, each id's rows summed in that order) equals
    ``F.embedding``'s within f32 round-off: per element, recursive
    summation of n terms errs by at most n·2^-24·Σ|terms|."""
    rng = np.random.default_rng(0)
    ids = {"zeros": np.zeros((16, 32), np.int64),
           "mixed": rng.integers(0, 2, (16, 32)),
           "random": rng.integers(0, num_rows, (16, 32))}[ids_kind]
    ids = torch.tensor(ids)
    table = torch.tensor(rng.normal(size=(num_rows, 24)).astype(np.float32),
                         requires_grad=True)
    gy = torch.tensor(rng.normal(size=(16, 32, 24)).astype(np.float32))
    out = bert._EmbedLookup.apply(ids, table)
    want = torch.nn.functional.embedding(ids, table)
    assert torch.equal(out, want)
    (got_g,) = torch.autograd.grad(out, table, gy)
    (want_g,) = torch.autograd.grad(want, table, gy)
    counts = np.bincount(ids.reshape(-1).numpy(), minlength=num_rows)
    abs_sum = torch.zeros_like(want_g).index_add_(
        0, ids.reshape(-1), gy.reshape(-1, 24).abs()).numpy()
    bound = counts[:, None] * 2.0 ** -24 * abs_sum
    assert np.all(np.abs(got_g.numpy() - want_g.numpy()) <= bound)
    (again,) = torch.autograd.grad(bert._EmbedLookup.apply(ids, table),
                                   table, gy)
    assert torch.equal(again, got_g)
