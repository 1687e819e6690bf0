"""ResNet's cross-rank BatchNorm and BERT's data-parallel step across gloo
ranks on the CPU, against the reference (``tests/test_resnet.py``'s
``test_ps_step_matches_plain_optax``; ``tests/test_torch_bert.py``'s LAMB
step).

Two ranks each take half of the global batch; BatchNorm takes the global
batch's statistics, as the reference's GSPMD BatchNorm does, so one step
equals the reference's step on its 2-device mesh and a plain optax step
on the global batch (loss rtol 1e-5; parameters and ``batch_stats`` rtol
2e-4, atol 2e-5, the reference's bounds). At one rank the group's path
keeps today's numerics: parameters and ``batch_stats`` bitwise equal to
the one-process step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mlm_batches, mnist_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models import bert as ref_bert
from ps_tpu.models import resnet as ref_resnet

K = 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tiny():
    return ref_resnet.ResNet(stage_sizes=(1, 1),
                             block_cls=ref_resnet.BasicBlock, num_filters=8,
                             num_classes=10, dtype=jnp.float32,
                             small_inputs=True)


def _inputs():
    model = _tiny()
    images, labels = next(mnist_batches(32, seed=3))
    variables = model.init(jax.random.key(1), jnp.asarray(images[:2]),
                           train=False)
    return model, images, labels, _np_tree(variables["params"]), _np_tree(
        variables["batch_stats"])


def _bert_inputs():
    cfg = ref_bert.BertConfig.tiny()
    model = ref_bert.BertMLM(cfg)
    batch = next(mlm_batches(16, 32, vocab_size=cfg.vocab_size, seed=5))
    params = model.init(jax.random.key(0),
                        jnp.asarray(batch["input_ids"][:2]),
                        jnp.asarray(batch["attention_mask"][:2]))["params"]
    return model, batch, params


def _resnet_cases():
    _, images, labels, params, stats = _inputs()
    return [("resnet_step", dict(params=params, stats=stats, images=images,
                                 labels=labels, placement=placement))
            for placement in ("replicated", "sharded")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, batch, params = _bert_inputs()
    flat, _ = ref_flatten(params)
    cases = _resnet_cases() + [
        ("bert_step", dict(params={k: np.asarray(v) for k, v in flat.items()},
                           batches=[batch]))]
    return torch_ranks.run_ranks(K, cases, tmp_path_factory.mktemp("resnet"))


def _flat(tree):
    flat, _ = ref_flatten(tree)
    return {k: np.asarray(v) for k, v in flat.items()}


def _to_port_keys(flat):
    """The reference's flat ResNet keys and layouts -> the port's (conv
    kernels HWIO -> OIHW, the head's [in, out] -> [out, in])."""
    out = {}
    for k, v in flat.items():
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif k == "head/kernel":
            v = v.T
        out[k] = v
    return out


@pytest.mark.parametrize("placement,case", [("replicated", 0),
                                            ("sharded", 1)])
def test_resnet_step_across_ranks_matches_the_global_batch(ranks, placement,
                                                           case):
    model, images, labels, params0, state0 = _inputs()
    loss_fn = ref_resnet.make_loss_fn(model)
    batch = (jnp.asarray(images), jnp.asarray(labels))
    opt = optax.sgd(0.1, momentum=0.9)
    (plain_loss, plain_bn), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params0, batch, state0)
    updates, _ = opt.update(grads, opt.init(params0), params0)
    plain_params = optax.apply_updates(params0, updates)
    ps_tpu.init(backend="tpu", mesh_shape={"data": K})
    try:
        store = ps_tpu.KVStore(optimizer="momentum", learning_rate=0.1,
                               momentum=0.9, placement=placement)
        store.init(params0)
        ref_loss, ref_params, ref_bn = store.make_step(
            loss_fn, has_aux=True)(store.shard_batch(batch), state0)
    finally:
        ps_tpu.shutdown()
    for r in [x[case] for x in ranks]:
        for want_loss, want_params, want_bn in (
                (ref_loss, ref_params, ref_bn),
                (plain_loss, plain_params, plain_bn)):
            np.testing.assert_allclose(r["loss"], float(want_loss),
                                       rtol=1e-5)
            for got, want in ((r["params"], want_params),
                              (r["stats"], want_bn)):
                want = _to_port_keys(_flat(_np_tree(want)))
                assert set(got) == set(want)
                for k, w in want.items():
                    np.testing.assert_allclose(got[k], w, rtol=2e-4,
                                               atol=2e-5, err_msg=k)


def test_resnet_at_one_rank_is_bitwise_todays(tmp_path):
    """A group of one rank (gloo) takes local BatchNorm statistics and its
    server's all-reduce is the identity: parameters and batch_stats equal
    the one-process step's, bitwise."""
    cases = _resnet_cases()
    group = torch_ranks.run_ranks(1, cases, tmp_path)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same CPU sum orders
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        alone = [torch_ranks.CASES[name](0, 1, **kw) for name, kw in cases]
    finally:
        ps_tpu_torch.shutdown()
        torch.set_num_threads(threads)
    for got, want in zip(group, alone):
        assert got["loss"] == want["loss"]
        for part in ("params", "stats"):
            for k, w in want[part].items():
                np.testing.assert_array_equal(got[part][k], w, err_msg=k)


def test_resnet_outside_the_step_takes_local_statistics(ranks):
    """The model called on one rank outside the store's step (no mesh: an
    evaluation or a probe) runs no collective, so it cannot wait on the
    other ranks, and its training-mode BatchNorm takes its own batch's
    statistics: those of a one-process call on that rank's slice."""
    from ps_tpu_torch.models import resnet

    _, images, _, _, _ = _inputs()
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                          num_filters=8, num_classes=10, small_inputs=True,
                          dtype=torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same CPU sum orders
    try:
        got = []
        for rank, r in enumerate(x[0] for x in ranks):
            assert r["outside_calls"] == 0
            logits, stats = model.apply(
                resnet._nest({k: torch.as_tensor(v)
                              for k, v in r["params"].items()}),
                resnet._nest({k: torch.as_tensor(v)
                              for k, v in r["stats"].items()}),
                torch.as_tensor(torch_ranks._slice(images, rank, K)),
                train=True)
            np.testing.assert_allclose(r["outside_logits"], logits.numpy(),
                                       rtol=1e-6, atol=1e-7)
            want = torch_ranks._flat_np(stats)
            for k, w in want.items():
                np.testing.assert_allclose(r["outside_stats"][k], w,
                                           rtol=1e-6, atol=1e-7, err_msg=k)
            got.append(r["outside_stats"])
    finally:
        torch.set_num_threads(threads)
    # each rank saw its own half of the batch
    assert any(not np.allclose(got[0][k], got[1][k]) for k in got[0]
               if k.endswith("mean"))


def test_bert_lamb_step_across_ranks_matches_reference(ranks):
    """BERT-tiny's data-parallel LAMB step (placement 'replicated') on 2
    ranks equals the reference's step on its 2-device mesh
    (tests/test_torch_bert.py's bounds: loss rtol 1e-5, parameters rtol
    2e-4, atol 1e-5)."""
    model, batch, params0 = _bert_inputs()
    ps_tpu.init(backend="tpu", mesh_shape={"data": K})
    try:
        store = ps_tpu.KVStore(optimizer="lamb", learning_rate=1e-3,
                               weight_decay=0.01, placement="replicated")
        store.init(params0)
        ref_loss, ref_params = store.make_step(
            ref_bert.make_mlm_loss_fn(model))(store.shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}))
    finally:
        ps_tpu.shutdown()
    want = _flat(_np_tree(ref_params))
    for r in [x[2] for x in ranks]:
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(r["params"][k], w, rtol=2e-4,
                                       atol=1e-5, err_msg=k)
