"""The port's fused sparse apply against the reference's.

The same inputs, made with numpy from a seed, go through
``ps_tpu.ops.sparse_apply.fused_sparse_apply`` (its ``jax`` tier, and its
Pallas kernel in interpret mode) and ``ps_tpu_torch``'s plain version on
the CPU. Tolerances:

- sgd in f32 is bitwise: both sum duplicates in f32, from 0, in arrival
  order, then compute ``row - lr * gsum``;
- adagrad and adam in f32 are within rtol 1e-6, atol 1e-7: the mean over
  D and ``pow`` may round differently in XLA and PyTorch;
- bf16 tables are within one bf16 ulp: the two frameworks round the
  ``lr * g`` product at different places;
- the reference's Pallas tier (interpret mode) is itself off its ``jax``
  tier by up to 1.2e-7 (ROADMAP R2), so the port's table is held to it
  within 1.2e-7, relative and absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_tpu.config import Config as RefConfig
from ps_tpu.ops import sparse_apply as ref_ops
from ps_tpu.optim import rowwise as ref_rowwise
from ps_tpu_torch.config import Config
from ps_tpu_torch.ops import sparse_apply as ops
from ps_tpu_torch.optim import rowwise

V, D = 96, 8
LR = 0.1


def _table0():
    return np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)


def _distributions():
    """The id distributions of tests/test_sparse_apply.py, against V rows."""
    rng = np.random.default_rng(7)
    dup_heavy = np.array([3, 7, 3, 3, 7, 0, 95, 3] * 2, np.int32)
    all_rows = np.arange(V, dtype=np.int32)
    empty = np.zeros((0,), np.int32)
    single = np.array([42], np.int32)
    out = []
    for ids in (dup_heavy, all_rows, empty, single):
        grads = rng.normal(size=(ids.size, D)).astype(np.float32)
        out.append((ids, grads))
    return out


def _run_ref(optimizer, dtype, tier, pushes):
    opt = ref_rowwise.make_rowwise(optimizer, learning_rate=LR)
    table = jnp.asarray(_table0(), dtype)
    state = opt.init(table)
    for ids, grads in pushes:
        table, state = ref_ops.fused_sparse_apply(
            table, state, jnp.asarray(ids), jnp.asarray(grads), opt, tier)
    return (np.asarray(table.astype(jnp.float32)),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(state)])


def _run_port(optimizer, dtype, tier, pushes):
    opt = rowwise.make_rowwise(optimizer, learning_rate=LR)
    table = torch.as_tensor(_table0()).to(dtype)
    state = opt.init(table)
    for ids, grads in pushes:
        out = ops.fused_sparse_apply(table, state, torch.as_tensor(ids),
                                     torch.as_tensor(grads), opt, tier)
        assert out[0] is table  # in place, no copy
    return (table.to(torch.float32).numpy(),
            [x.numpy() for x in ops.state_leaves(state)])


def _assert_within_bf16_ulp(got, want):
    # a bf16 ulp is 2**16 f32 ulps: 7 mantissa bits where f32 has 23
    ulp = np.maximum(np.spacing(np.abs(want)), np.spacing(np.abs(got))) * 2**16
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_plain_version_matches_reference_jax_tier(optimizer, dtype):
    """The sweep, as one multi-push sequence so state carries over."""
    pushes = _distributions()
    want_t, want_s = _run_ref(optimizer, getattr(jnp, dtype), "jax", pushes)
    got_t, got_s = _run_port(optimizer, getattr(torch, dtype), "torch",
                             pushes)
    assert len(got_s) == len(want_s)
    if dtype == "bfloat16":
        _assert_within_bf16_ulp(got_t, want_t)
    elif optimizer == "sgd":
        np.testing.assert_array_equal(got_t, want_t)
    else:
        np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-7)
    for g, w in zip(got_s, want_s):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_plain_version_matches_reference_pallas_kernel(optimizer):
    pushes = _distributions()
    want_t, want_s = _run_ref(optimizer, jnp.float32, "pallas", pushes)
    got_t, got_s = _run_port(optimizer, torch.float32, "torch", pushes)
    np.testing.assert_allclose(got_t, want_t, rtol=1.2e-7, atol=1.2e-7)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_cuda_tier_on_cpu_tensors_is_the_plain_version():
    """On CPU tensors the kernel's wrapper runs its plain version, and
    launches nothing."""
    pushes = _distributions()
    before = ops.LAUNCHES
    got_t, got_s = _run_port("adagrad", torch.float32, "cuda", pushes)
    want_t, want_s = _run_port("adagrad", torch.float32, "torch", pushes)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s[0], want_s[0])
    assert ops.LAUNCHES == before


def test_sgd_sums_a_hot_id_in_arrival_order():
    """A hot id repeated 1,000 times: the row equals the host oracle
    ``row - f32(lr) * segment_sum_np(...)`` bitwise."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, V, size=1500).astype(np.int32)
    ids[rng.permutation(1500)[:1000]] = 5
    grads = rng.normal(size=(1500, D)).astype(np.float32)
    got_t, _ = _run_port("sgd", torch.float32, "torch", [(ids, grads)])
    uids, gsum, _ = ops.segment_sum_np(ids, grads)
    want = _table0()
    want[uids] = want[uids] - np.float32(LR) * gsum
    np.testing.assert_array_equal(got_t, want)


def test_batch_segment_sum_matches_reference():
    rng = np.random.default_rng(3)
    ids = np.array([5, -1, 2, 5, 5, 2, -1, 9, 5, 0], np.int32)
    grads = rng.normal(size=(ids.size, D)).astype(np.float32)
    want = ref_ops.batch_segment_sum(jnp.asarray(ids), jnp.asarray(grads))
    got = ops.batch_segment_sum(torch.as_tensor(ids), torch.as_tensor(grads))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_segment_sum_np_is_the_reference_copy():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 20, size=200).astype(np.int32)
    grads = rng.normal(size=(200, 3)).astype(np.float32)
    for g, w in zip(ops.segment_sum_np(ids, grads),
                    ref_ops.segment_sum_np(ids, grads)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_hbm_bytes_model_matches_reference(optimizer):
    for rows, dim, batch, nbytes in ((2_600_000, 16, 13_312, 4),
                                     (96, 8, 16, 2), (10, 1, 0, 4)):
        assert ops.hbm_bytes_model(
            rows, dim, batch, rowwise.make_rowwise(optimizer), nbytes
        ) == ref_ops.hbm_bytes_model(
            rows, dim, batch, ref_rowwise.make_rowwise(optimizer), nbytes)


def test_resolve_tier():
    assert ops.resolve_tier("auto", "cpu") == "torch"
    assert ops.resolve_tier(None, "cpu") == "torch"
    assert ops.resolve_tier("auto", torch.device("cuda")) == "cuda"
    assert ops.resolve_tier("cuda", "cuda:0") == "cuda"
    assert ops.resolve_tier("cuda", "cpu") == "cuda"
    assert ops.resolve_tier("torch", "cpu") == "torch"
    assert ops.resolve_tier("off", "cpu") == "off"
    with pytest.raises(ValueError, match="CPU only"):
        ops.resolve_tier("torch", torch.device("cuda"))
    with pytest.raises(ValueError, match="unknown fused-apply tier"):
        ops.resolve_tier("pallas", "cpu")


@pytest.mark.parametrize("value", ["auto", "off", "torch", "cuda", ""])
def test_fused_apply_knob_roundtrip(monkeypatch, value):
    monkeypatch.setenv("PS_FUSED_APPLY", value)
    assert Config.from_env().fused_apply == (value or "auto")


def test_fused_apply_knob_rejects_reference_only_tiers(monkeypatch):
    monkeypatch.setenv("PS_FUSED_APPLY", "pallas")
    assert RefConfig.from_env().fused_apply == "pallas"
    with pytest.raises(ValueError, match="unknown fused_apply tier"):
        Config.from_env()


def test_entry_point_rejects_off_and_unknown():
    opt = rowwise.make_rowwise("sgd")
    t = torch.zeros((4, D))
    ids = torch.zeros((2,), dtype=torch.int32)
    g = torch.zeros((2, D))
    with pytest.raises(ValueError, match="'off'"):
        ops.fused_sparse_apply(t, (), ids, g, opt, "off")
    with pytest.raises(ValueError, match="unknown fused-apply tier"):
        ops.fused_sparse_apply(t, (), ids, g, opt, "vulkan")


def test_kernel_wrapper_checks_what_it_takes():
    """The argument checks run before anything touches the card."""
    opt = rowwise.make_rowwise("adam")
    table = torch.zeros((6, 4))
    state = opt.init(table)
    rule, *_ = ops._kernel_args(opt, table, state)
    assert rule == 2
    with pytest.raises(ValueError, match="contiguous"):
        ops._kernel_args(opt, torch.zeros((4, 6)).T, state)
    with pytest.raises(ValueError, match="not f32 or bf16"):
        ops._kernel_args(opt, table.to(torch.float16), state)
    bad = dict(state, t=state["t"].to(torch.int64))
    with pytest.raises(ValueError, match="state leaf"):
        ops._kernel_args(opt, table, bad)
    with pytest.raises(ValueError, match="kind"):
        ops._kernel_args(rowwise.RowwiseOptimizer(lambda r: (),
                                                  lambda *a: a[:2]),
                         table, ())
