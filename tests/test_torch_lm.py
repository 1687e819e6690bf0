"""The long-context causal LM, the port against the reference
(``tests/test_lm.py``).

The same numpy seed draws the same tree (and ``params_from_jax`` carries
the reference's), whose loss equals the reference's; the LM learns in
one process; on gloo ranks, 'ring' on ``{data: 2, seq: 2}`` and
'ulysses' with ``lm_partition_rules`` on ``{data: 1, model: 2, seq: 2}``
train step for step as the reference's pure-dp 'full' does, within its
2e-4, every layer's kernels placed by the Megatron rules. The causal
flash wrapper on the CPU (the plain version of the kernel) equals the
reference's kernel in Pallas interpret mode, alone and as the LM's
``attn='flash'``, and refuses a head width the kernel is not built for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models import lm as ref_lm
from ps_tpu.ops.flash_attention import flash_attention as ref_flash
from ps_tpu_torch.models import lm

VOCAB, D, HEADS, LAYERS, T, B = 64, 32, 4, 2, 32, 8
LM_TOL = {"rtol": 2e-4, "atol": 2e-4}
FLASH_TOL = {"rtol": 2e-5, "atol": 2e-5}


def _ref_train(mesh_shape, attn, steps=6):
    """``tests/test_lm.py``'s ``_train``."""
    ps_tpu.init(backend="tpu", mesh_shape=mesh_shape)
    try:
        ctx = ps_tpu.current_context()
        store = ps_tpu.KVStore(optimizer="adam", learning_rate=3e-3,
                               placement="sharded")
        store.init(ref_lm.init_params(np.random.default_rng(0), vocab=VOCAB,
                                      d_model=D, n_heads=HEADS,
                                      n_layers=LAYERS, max_len=T + 1))
        run = store.make_step(ref_lm.make_loss_fn(
            n_heads=HEADS, attn_fn=ref_lm.make_attn_fn(attn, mesh=ctx.mesh)))
        sh = NamedSharding(ctx.mesh, P("data", None))
        return [float(run({k: jax.device_put(jnp.asarray(v), sh)
                           for k, v in b.items()})[0])
                for b in ref_lm.lm_batches(B, T, vocab=VOCAB, seed=1,
                                           steps=steps)]
    finally:
        ps_tpu.shutdown()


def test_init_and_params_from_jax_equal_the_reference():
    rng_params = ref_lm.init_params(np.random.default_rng(0), vocab=VOCAB,
                                    d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                    max_len=T + 1)
    flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, rng_params))
    carried = lm.params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    drawn = lm.init_params(np.random.default_rng(0), vocab=VOCAB, d_model=D,
                           n_heads=HEADS, n_layers=LAYERS, max_len=T + 1)
    got, _ = ps_tpu_torch.kv.keys.flatten_with_keys(drawn)
    assert set(got) == set(flat)
    for key, w in flat.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key
        assert np.array_equal(ps_tpu_torch.kv.keys.flatten_with_keys(
            carried)[0][key].numpy(), np.asarray(w)), key
    batch = next(ref_lm.lm_batches(B, T, vocab=VOCAB, seed=1))
    want = float(ref_lm.make_loss_fn(n_heads=HEADS)(
        rng_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    port = float(lm.make_loss_fn(n_heads=HEADS)(
        carried, {k: torch.as_tensor(v) for k, v in batch.items()}))
    np.testing.assert_allclose(port, want, rtol=1e-6)


def test_lm_learns():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        store = ps_tpu_torch.KVStore(optimizer="adam", learning_rate=3e-3,
                                     placement="sharded")
        store.init(lm.init_params(np.random.default_rng(0), vocab=VOCAB,
                                  d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                  max_len=T + 1))
        run = store.make_step(lm.make_loss_fn(n_heads=HEADS))
        losses = [float(run(store.shard_batch(b))[0])
                  for b in lm.lm_batches(B, T, vocab=VOCAB, seed=1,
                                         steps=20)]
    finally:
        ps_tpu_torch.shutdown()
    assert losses[-1] < losses[0] - 0.3, losses


@pytest.mark.parametrize("mesh,attn,rules", [
    ({"data": 2, "seq": 2}, "ring", False),
    ({"data": 1, "model": 2, "seq": 2}, "ulysses", True),
], ids=["dp_sp_ring", "dp_tp_sp_ulysses"])
def test_parallelism_is_invisible(tmp_path, mesh, attn, rules):
    """Sequence (and tensor) parallel training == the reference's pure-dp
    full attention, step for step at the same global batch."""
    ref = _ref_train({"data": 8}, "full")
    ranks = torch_ranks.run_ranks(
        4, [("lm_steps", dict(attn=attn, rules=rules))], tmp_path,
        init={"mesh_shape": mesh})
    for r in ranks:
        got = r[0]
        np.testing.assert_allclose(got["losses"], ref, **LM_TOL)
        op = {"ring": "ppermute", "ulysses": "all_to_all"}[attn]
        assert (op, "seq") in got["calls"]
        if rules:  # test_lm_rules_place_every_layer
            spec = got["specs"]
            for i in range(LAYERS):
                assert spec[f"layer{i}/attn/qkv/kernel"] == (None, "model")
                assert spec[f"layer{i}/attn/out/kernel"] == ("model", None)
                assert spec[f"layer{i}/mlp/in/kernel"] == (None, "model")
                assert spec[f"layer{i}/mlp/out/kernel"] == ("model", None)
            assert ("all_reduce", "model") in got["calls"]


@pytest.mark.parametrize("d", [16, 32, 64])
def test_causal_flash_plain_path_matches_reference_kernel(d):
    """``flash_attention(causal=True)`` on CPU tensors (the plain version
    of the CUDA kernel) against the reference's Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.normal(0, 1, (2, 128, 4, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(ref_flash(*map(jnp.asarray, (q, k, v)), causal=True))
    fn = lm.make_attn_fn("flash")
    got = fn(*(torch.tensor(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


def test_lm_with_flash_matches_reference_flash():
    """The LM's ``attn='flash'`` (head width 16, seq 128): loss and its
    gradient's norm against the reference's LM with its flash kernel."""
    params = ref_lm.init_params(np.random.default_rng(2), vocab=VOCAB,
                                d_model=64, n_heads=4, n_layers=2,
                                max_len=129)
    batch = next(ref_lm.lm_batches(2, 128, vocab=VOCAB, seed=3))
    ref_loss = ref_lm.make_loss_fn(n_heads=4,
                                   attn_fn=ref_lm.make_attn_fn("flash"))
    want, want_g = jax.value_and_grad(ref_loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    flat, _ = ref_flatten(jax.tree_util.tree_map(np.asarray, params))
    port = lm.params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    got, got_g, _ = ps_tpu_torch.kv.store.value_and_grad(
        lm.make_loss_fn(n_heads=4, attn_fn=lm.make_attn_fn("flash")), port,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    want_flat, _ = ref_flatten(want_g)
    got_flat, _ = ps_tpu_torch.kv.keys.flatten_with_keys(got_g)
    for key, w in want_flat.items():
        np.testing.assert_allclose(got_flat[key].numpy(), np.asarray(w),
                                   rtol=5e-4, atol=5e-4, err_msg=key)


def test_flash_refuses_a_width_the_kernel_lacks():
    fn = lm.make_attn_fn("flash")
    q = torch.zeros(1, 128, 4, 8)
    with pytest.raises(ValueError, match="head widths"):
        fn(q, q, q)


def test_attention_within_a_block_is_refused_on_a_seq_axis():
    """On a 'seq' axis larger than 1, where a rank holds its block of each
    sequence, 'full' and 'flash' would attend within the block: the LM
    refuses them in ``make_attn_fn``, ``make_loss_fn`` and ``apply``,
    and a pipelined loss refuses the axis; ring and ulysses are taken."""
    from ps_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 1, "seq": 2}, coords={"seq": 1})
    for attn in ("full", "flash"):
        with pytest.raises(ValueError, match="needs ring or ulysses"):
            lm.make_attn_fn(attn, mesh=mesh)
    with pytest.raises(ValueError, match="needs ring or ulysses"):
        lm.make_loss_fn(n_heads=HEADS, mesh=mesh)
    params = lm.init_params(np.random.default_rng(0), vocab=VOCAB, d_model=D,
                            n_heads=HEADS, n_layers=1, max_len=T + 1)
    with pytest.raises(ValueError, match="needs ring or ulysses"):
        lm.apply(params, torch.zeros(1, T // 2, dtype=torch.int64),
                 n_heads=HEADS, mesh=mesh)
    with pytest.raises(ValueError, match="does not compose"):
        lm.make_pipelined_loss_fn(n_heads=HEADS, num_stages=1,
                                  microbatches=1, mesh=mesh)
    for attn in ("ring", "ulysses"):
        assert lm.make_attn_fn(attn, mesh=mesh).attn == attn
        lm.make_loss_fn(n_heads=HEADS, mesh=mesh,
                        attn_fn=lm.make_attn_fn(attn, mesh=mesh))


TRAINER = ["--device", "cpu", "--steps", "4", "--seq-len", "32",
           "--batch-size", "8", "--vocab", "64", "--d-model", "32",
           "--n-heads", "4"]


def test_trainer_one_process_and_refusals(capsys):
    from ps_tpu_torch.examples import train_longctx_lm

    final = train_longctx_lm.main(TRAINER + ["--mesh", "data=1",
                                             "--attn", "full"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("done:") and np.isfinite(final)
    for argv, match in [
            (["--mesh", "seq=2"], "'data' axis"),
            (["--mesh", "data=1", "--attn", "ring"], "seq axis > 1"),
            (["--mesh", "data=1,pipe=2", "--attn", "full"], "BOTH"),
            (["--mesh", "data=1,pipe=2,model=2", "--attn", "full",
              "--microbatches", "2"], "do not compose"),
            (["--mesh", "data=1,seq=2", "--attn", "full"], "ring or "
                                                           "ulysses"),
            (["--mesh", "data=2,seq=2", "--attn", "ulysses",
              "--n-heads", "2"], "needs 4 ranks")]:
        with pytest.raises(SystemExit, match=match):
            train_longctx_lm.main(TRAINER + argv)
    assert not ps_tpu_torch.is_initialized()


def test_trainer_across_seq_ranks_equals_one_process(tmp_path):
    """The trainer on 2 gloo ranks, ``--mesh data=1,seq=2 --attn ring``,
    ends at one process's 'full' loss (within the reference's 2e-4)."""
    from ps_tpu_torch.examples import train_longctx_lm

    one = train_longctx_lm.main(TRAINER + ["--mesh", "data=1",
                                           "--attn", "full"])
    ranks = torch_ranks.run_ranks(
        2, [("longctx_trainer", dict(port=torch_ranks.free_port(),
                                     argv=TRAINER + ["--mesh", "data=1,seq=2",
                                                     "--attn", "ring"]))],
        tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r[0], one, **LM_TOL)


def test_sliced_kernels_need_the_mesh():
    """A Megatron slice without the mesh to reduce over raises, naming
    what to pass (LM block and BERT)."""
    from ps_tpu_torch.models import bert

    params = lm.init_params(np.random.default_rng(0), vocab=VOCAB,
                            d_model=D, n_heads=HEADS, n_layers=1)
    lp = params["layer0"]
    lp["attn"]["qkv"]["kernel"] = lp["attn"]["qkv"]["kernel"][:, :3 * D // 2]
    with pytest.raises(ValueError, match="mesh"):
        lm.block_apply(lp, torch.zeros(1, 4, D), n_heads=HEADS)
    model = bert.BertMLM(bert.BertConfig.tiny(),
                         generator=torch.Generator().manual_seed(0))
    attn = model.layer_0.attention
    with torch.no_grad():
        attn.query.kernel = torch.nn.Parameter(attn.query.kernel[:, :2])
    with pytest.raises(ValueError, match="mesh"):
        attn(torch.zeros(1, 4, 64), torch.ones(1, 4, dtype=torch.int32))
