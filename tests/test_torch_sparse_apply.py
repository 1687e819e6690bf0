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
    """'off' is no longer refused: the entry point runs the masked
    full-table apply (tests/test_torch_remote_sparse.py holds it to a
    numpy oracle); an unknown tier still raises."""
    opt = rowwise.make_rowwise("sgd")
    t = torch.zeros((4, D))
    ids = torch.zeros((2,), dtype=torch.int32)
    g = torch.ones((2, D))
    ops.fused_sparse_apply(t, (), ids, g, opt, "off")
    assert torch.equal(t[0], torch.full((D,), -0.02)) and not t[1:].any()
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
    # the wrapper takes [N] int32 ids and [N, D] float32 grads
    ids = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="ids must be"):
        ops._apply_cuda(opt, table, state, ids.long(), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="grads"):
        ops._apply_cuda(opt, table, state, ids, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="grads"):
        ops._apply_cuda(opt, table, state, ids,
                        torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="state leaf"):
        ops._apply_cuda(opt, table, bad, ids, torch.zeros((3, 4)))


# -- the grouping pass's host-side plan and plain version -------------------------


@pytest.mark.parametrize("num_rows, bits", [
    (0, 1), (1, 1), (2, 2), (1_000, 10), (2_047, 11), (2_048, 12),
    (2_600_000, 22), (2**22, 23), (2**24 - 1, 24), (2**24, 25),
    (2**31 - 1, 31)])
def test_key_bits_hold_every_real_id_and_the_filler_key(num_rows, bits):
    """Real ids are below num_rows and filler becomes num_rows itself:
    key_bits is the fewest bits that hold num_rows."""
    assert ops.key_bits(num_rows) == bits
    assert num_rows < 2**bits


@pytest.mark.parametrize("n, num_rows, want", [
    (13_312, 2_600_000, ("cluster", 22, 2, 11, 1)),
    (1, 10, ("cluster", 4, 1, 4, 1)),
    (16_384, 2**24, ("cluster", 25, 3, 9, 1)),
    (16_385, 2_600_000, ("sorted", 22, 2, 11, 2)),
    (106_496, 2_600_000, ("sorted", 22, 2, 11, 2)),
    (1_703_936, 2**31 - 1, ("sorted", 31, 3, 11, 2))])
def test_plan_group_path_bits_and_launches(n, num_rows, want):
    plan = ops.plan_group(n, num_rows)
    got = (plan["path"], plan["key_bits"], plan["passes"],
           plan["digit_bits"], plan["launches"])
    assert got == want
    assert plan["digit_bits"] <= ops.DIGIT_BITS
    assert plan["passes"] * plan["digit_bits"] >= plan["key_bits"]


@pytest.mark.parametrize("n", [1, 13_312, 16_384, 16_385, 1_703_936])
def test_plan_group_scratch_holds_every_output(n):
    """The int32 scratch the wrapper allocates holds what the path writes:
    ids_s, perm, seg_start (n + 1), seg_id and meta; on the sorted path
    torch.sort's ids_s instead, plus 3 counts a segment block."""
    plan = ops.plan_group(n, 2_600_000)
    if plan["path"] == "cluster":
        assert plan["scratch_ints"] == 4 * n + 1 + ops.META
    else:
        blocks = -(-n // ops.SEG_TILE)
        assert plan["scratch_ints"] == 3 * n + 1 + ops.META + 3 * blocks
    assert ops.plan_group(n, 2_600_000, path="sorted")["path"] == "sorted"


def test_plan_group_rejects_what_no_path_takes():
    with pytest.raises(ValueError, match="at most"):
        ops.plan_group(ops.GROUP_BLOCK_MAX + 1, 100, path="cluster")
    with pytest.raises(ValueError, match="unknown grouping path"):
        ops.plan_group(10, 100, path="radix")
    with pytest.raises(ValueError, match="int32 id"):
        ops.plan_group(10, 2**31)
    with pytest.raises(ValueError, match="int32 positions"):
        ops.plan_group(2**31, 100)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_grouping_equals_a_numpy_oracle(seed):
    """The grouping pass's plain version (what the card's kernels are held
    to): stable order of the real ids, filler last, segments as
    np.unique's, on ids with -1 filler and ids past the table."""
    rng = np.random.default_rng(seed)
    num_rows = 50
    ids = rng.integers(-1, num_rows + 10, size=300).astype(np.int32)
    ids[rng.random(300) < 0.3] = 7
    g = ops.group_ids(torch.as_tensor(ids), num_rows)
    real = (ids >= 0) & (ids < num_rows)
    order = np.argsort(np.where(real, ids, num_rows), kind="stable")
    segs, n_real, lo = g.meta.tolist()
    assert (n_real, lo) == (int(real.sum()), 0)
    np.testing.assert_array_equal(g.perm.numpy(), order)
    np.testing.assert_array_equal(g.ids_s.numpy()[:n_real],
                                  ids[order][:n_real])
    assert np.all(g.ids_s.numpy()[n_real:] == num_rows)  # set aside
    uids, first = np.unique(ids[order][:n_real], return_index=True)
    assert segs == uids.size
    np.testing.assert_array_equal(g.seg_id.numpy()[:segs], uids)
    np.testing.assert_array_equal(g.seg_start.numpy()[:segs], first)
    assert g.seg_start[segs] == n_real
    for t in g:
        assert t.dtype == torch.int32


def test_group_ids_checks_what_it_takes():
    with pytest.raises(ValueError, match="int32"):
        ops.group_ids(torch.zeros((4,), dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="int32"):
        ops.group_ids(torch.zeros((2, 2), dtype=torch.int32), 10)


def test_launch_checks_the_grouping_output_and_grads():
    """The apply's wrapper checks a grouping pass's output and the grads
    before anything touches the card."""
    table = torch.zeros((6, 4))
    ids = torch.tensor([1, 3, 1, -1], dtype=torch.int32)
    group = ops.group_ids(ids, 6)
    grads = torch.zeros((4, 4))
    ops._check_launch_args(table, group, grads)
    with pytest.raises(ValueError, match="grads"):
        ops._check_launch_args(table, group, grads[:, :3])
    with pytest.raises(ValueError, match="grads"):
        ops._check_launch_args(table, group, grads.double())
    with pytest.raises(ValueError, match="perm"):
        ops._check_launch_args(table, group._replace(
            perm=group.perm.long()), grads)
    with pytest.raises(ValueError, match="seg_start"):
        ops._check_launch_args(table, group._replace(
            seg_start=group.seg_start[:-1]), grads)
    with pytest.raises(ValueError, match="meta"):
        ops._check_launch_args(table, group._replace(
            meta=group.meta[:2]), grads)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_launch_args(table, group, torch.zeros((4, 8))[:, ::2])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_embedding_apply_on_the_cpu_masks_filler_as_the_reference(optimizer):
    """SparseEmbedding.apply on the CPU with -1 and out-of-range ids: the
    same table and state as the reference's jax tier given the ids its
    owner-shard mask makes (filler -1, its grads zeroed)."""
    import ps_tpu_torch
    from ps_tpu_torch.kv.sparse import SparseEmbedding

    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        rng = np.random.default_rng(21)
        emb = SparseEmbedding(V, D, optimizer=optimizer, learning_rate=LR)
        emb.init(_table0())
        opt = ref_rowwise.make_rowwise(optimizer, learning_rate=LR)
        ref_t = jnp.asarray(_table0())
        ref_s = opt.init(ref_t)
        for _ in range(3):
            ids = rng.integers(-1, V + 20, size=40).astype(np.int32)
            ids[:5] = [-1, V, V + 7, 3, 3]
            grads = rng.normal(size=(40, D)).astype(np.float32)
            emb.apply(emb.table, emb.state(), torch.as_tensor(ids),
                      torch.as_tensor(grads))
            masked = np.where((ids >= 0) & (ids < V), ids, -1)
            g = np.where(masked[:, None] >= 0, grads, 0.0).astype(np.float32)
            ref_t, ref_s = ref_ops.fused_sparse_apply(
                ref_t, ref_s, jnp.asarray(masked), jnp.asarray(g), opt, "jax")
        got_t = emb.table.numpy()
        if optimizer == "sgd":
            np.testing.assert_array_equal(got_t, np.asarray(ref_t))
        else:
            np.testing.assert_allclose(got_t, np.asarray(ref_t), rtol=1e-6,
                                       atol=1e-7)
        for got, want in zip(ops.state_leaves(emb.state()),
                             jax.tree_util.tree_leaves(ref_s)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    finally:
        ps_tpu_torch.shutdown()
