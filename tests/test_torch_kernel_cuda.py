"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and ``nvcc``; elsewhere they skip (the ``cuda`` marker). Run them on the
card with ``python -m pytest tests/test_torch_kernel_cuda.py --noconftest``
(``tests/conftest.py`` imports jax); ``chip_smoke.py`` runs the same
checks at the main paths' shapes.

- Sparse apply: the sweep of tests/test_torch_sparse_apply.py carried to
  ``tier='cuda'``, and Zipf batches of the Wide-&-Deep slice at N =
  13,312 and 1,703,936 for 3 rules x f32/bf16 x D in {1, 16, 64}: the
  kernels and the plain version (``batch_segment_sum`` + ``_apply_torch``)
  run on the same CUDA tensors. f32 within rtol 1e-6, atol 1e-7 (the mean
  over D and ``pow`` may round differently); bf16 within one bf16 ulp; a
  hot id pushed 100,000 times, sgd f32, bitwise against a host oracle.
- ``SparseEmbedding.push``/``pull`` with ids already on the card against
  the same calls with host arrays.
- The grouping pass: on the real ids its sorted ids and permutation equal
  ``torch.sort(ids, stable=True)``'s bitwise and its segments
  ``unique_consecutive``'s, at N from 1 to 1,703,936, with filler, ids
  past the table, all-equal ids and ``num_rows`` up to 2**24.
- Flash attention: the kernel and ``_flash_fwd_torch`` on the same CUDA
  tensors, at every head width the kernel is built for and at a length
  that is no multiple of its 128-row tiles. The kernel sums keys in its own order, so f32 is held to
  rtol/atol 2e-5 (the reference's flash-vs-einsum bound) and bf16 to
  1.6e-2 (two bf16 ulps: ``p`` and the output are rounded to bf16 after
  sums taken in different orders); ``lse`` is f32 in both, 2e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from ps_tpu_torch.ops import sparse_apply as ops
from ps_tpu_torch.optim import rowwise

pytestmark = pytest.mark.cuda

V, D = 96, 8
LR = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _pushes():
    rng = np.random.default_rng(7)
    out = []
    for ids in (np.array([3, 7, 3, 3, 7, 0, 95, 3] * 2, np.int32),
                np.arange(V, dtype=np.int32), np.zeros((0,), np.int32),
                np.array([42], np.int32)):
        out.append((ids, rng.normal(size=(ids.size, D)).astype(np.float32)))
    return out


def _run(optimizer, dtype, device, plain):
    opt = rowwise.make_rowwise(optimizer, learning_rate=LR)
    table0 = np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)
    table = torch.as_tensor(table0).to(device, dtype)
    state = opt.init(table)
    for ids, grads in _pushes():
        ids = torch.as_tensor(ids).to(device)
        grads = torch.as_tensor(grads).to(device)
        if ids.numel() == 0:
            continue
        if plain:
            ops._apply_torch(opt, table, state,
                             *ops.batch_segment_sum(ids, grads))
        else:
            ops.fused_sparse_apply(table, state, ids, grads, opt, "cuda")
    torch.cuda.synchronize(device)
    return (table.float().cpu().numpy(),
            [x.cpu().numpy() for x in ops.state_leaves(state)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_kernel_matches_plain_version(cuda, optimizer, dtype):
    before = ops.LAUNCHES
    got_t, got_s = _run(optimizer, getattr(torch, dtype), cuda, plain=False)
    assert ops.LAUNCHES == before + 3  # the empty push launches nothing
    want_t, want_s = _run(optimizer, getattr(torch, dtype), cuda, plain=True)
    if dtype == "bfloat16":
        ulp = np.spacing(np.abs(want_t)) * 2**16
        assert np.all(np.abs(got_t - want_t) <= ulp)
    else:
        np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-7)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_kernel_is_deterministic_and_sums_in_arrival_order(cuda):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, V, size=1500).astype(np.int32)
    ids[rng.permutation(1500)[:1000]] = 5
    grads = rng.normal(size=(1500, D)).astype(np.float32)
    table0 = np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)
    opt = rowwise.make_rowwise("sgd", learning_rate=LR)
    outs = []
    for _ in range(2):
        table = torch.as_tensor(table0).to(cuda)
        ops.fused_sparse_apply(table, (), torch.as_tensor(ids).to(cuda),
                               torch.as_tensor(grads).to(cuda), opt, "cuda")
        outs.append(table.cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    uids, gsum, _ = ops.segment_sum_np(ids, grads)
    want = table0.copy()
    want[uids] = want[uids] - np.float32(LR) * gsum
    np.testing.assert_array_equal(outs[0], want)


def _zipf_ids(batch, num_rows, seed, filler=True):
    """Wide-&-Deep's ids for one batch (26 features, Zipf-1.2), with some
    turned into -1 filler and ids past the table."""
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig()
    sparse = next(criteo_batches(batch, vocab_size=cfg.per_feature_vocab,
                                 seed=seed))["sparse"]
    ids = cfg.global_ids(torch.as_tensor(sparse)).reshape(-1).numpy().copy()
    ids %= num_rows
    if filler:
        rng = np.random.default_rng(seed)
        ids[rng.random(ids.size) < 0.01] = -1
        ids[rng.random(ids.size) < 0.01] = num_rows + 5
    return ids.astype(np.int32)


def _group_ids_case(n, kind, num_rows, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full((n,), min(7, num_rows - 1), np.int32)
    if kind == "zipf" and n % 26 == 0:
        return _zipf_ids(n // 26, num_rows, seed)
    ids = rng.integers(0, num_rows, size=n).astype(np.int64)
    ids[rng.random(n) < 0.1] = -1
    ids[rng.random(n) < 0.1] = num_rows + rng.integers(0, 1000)
    ids[rng.random(n) < 0.3] = 3  # a hot id
    return ids.astype(np.int32)


def _check_group(group, ids, num_rows):
    """The grouping pass against torch.sort and unique_consecutive on the
    real ids: bitwise."""
    real = (ids >= 0) & (ids < num_rows)
    want_s, order = torch.sort(ids[real], stable=True)
    want_perm = torch.nonzero(real).reshape(-1)[order]
    segs, n_real, lo = (int(x) for x in group.meta.cpu())
    assert n_real == int(real.sum())
    assert ids.numel() - n_real == int((~real).sum())  # set aside
    assert torch.equal(group.ids_s[lo:lo + n_real], want_s)
    assert torch.equal(group.perm[lo:lo + n_real].long(), want_perm)
    vals, counts = torch.unique_consecutive(want_s, return_counts=True)
    assert segs == vals.numel()
    starts = lo + torch.cumsum(counts, 0) - counts
    assert torch.equal(group.seg_start[:segs].long(), starts)
    assert int(group.seg_start[segs]) == lo + n_real
    assert torch.equal(group.seg_id[:segs], vals)


@pytest.mark.parametrize("num_rows", [2_600_000, 2**24])
@pytest.mark.parametrize("kind", ["mixed", "equal", "zipf"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 13_312, 106_496, 1_703_936])
def test_grouping_pass_equals_torch_sort(cuda, n, kind, num_rows):
    ids = torch.as_tensor(_group_ids_case(n, kind, num_rows)).to(cuda)
    before = ops.GROUP_LAUNCHES
    group = ops.group_ids(ids, num_rows)
    torch.cuda.synchronize(cuda)
    plan = ops.plan_group(n, num_rows)
    assert ops.GROUP_LAUNCHES == before + plan["launches"]
    _check_group(group, ids, num_rows)


@pytest.mark.parametrize("n", [1, 33, 1_000, 13_312, 16_384])
def test_grouping_sorted_path_at_small_n(cuda, n):
    """The path above GROUP_BLOCK_MAX, forced at sizes the cluster path
    also takes: both give the same segments."""
    ids = torch.as_tensor(_group_ids_case(n, "mixed", 5_000)).to(cuda)
    sorted_path = ops.group_ids(ids, 5_000, path="sorted")
    block = ops.group_ids(ids, 5_000)
    torch.cuda.synchronize(cuda)
    _check_group(sorted_path, ids, 5_000)
    _check_group(block, ids, 5_000)


@pytest.mark.parametrize("dim", [1, 16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("batch", [512, 65_536])
def test_kernel_matches_plain_version_at_scale(cuda, batch, optimizer, dtype,
                                               dim):
    """Zipf batches of the Wide-&-Deep slice (N = 13,312 and 1,703,936)
    with filler and ids past the table, into 2.6M rows."""
    num_rows = 2_600_000
    dtype = getattr(torch, dtype)
    ids = torch.as_tensor(_zipf_ids(batch, num_rows, seed=1)).to(cuda)
    g = torch.Generator(cuda).manual_seed(3)
    opt = rowwise.make_rowwise(optimizer, learning_rate=0.05)
    table = (0.01 * torch.randn((num_rows, dim), generator=g, device=cuda)
             ).to(dtype)
    grads = torch.randn((ids.numel(), dim), generator=g, device=cuda)
    state = opt.init(table)
    pt, pst = table.clone(), ops._map_state(torch.Tensor.clone, state)
    ops.fused_sparse_apply(table, state, ids, grads, opt, "cuda")
    ops._apply_torch(opt, pt, pst, *ops.batch_segment_sum(ids, grads))
    torch.cuda.synchronize(cuda)
    got, want = table.float().cpu().numpy(), pt.float().cpu().numpy()
    if dtype == torch.bfloat16:
        ulp = np.spacing(np.abs(want)) * 2**16
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for a, b in zip(ops.state_leaves(state), ops.state_leaves(pst)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_hot_id_of_100000_duplicates_sums_in_arrival_order(cuda):
    """sgd f32: one id pushed 100,000 times among others (the grouping
    pass's torch.sort path, and segments of thousands of tiles) equals
    the host oracle row - f32(lr) * segment_sum_np(...) bitwise."""
    rng = np.random.default_rng(12)
    n = 120_000
    ids = rng.integers(0, V, size=n).astype(np.int32)
    ids[rng.permutation(n)[:100_000]] = 5
    ids[rng.permutation(n)[:500]] = -1
    grads = rng.normal(size=(n, D)).astype(np.float32)
    table0 = np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)
    opt = rowwise.make_rowwise("sgd", learning_rate=LR)
    table = torch.as_tensor(table0).to(cuda)
    ops.fused_sparse_apply(table, (), torch.as_tensor(ids).to(cuda),
                           torch.as_tensor(grads).to(cuda), opt, "cuda")
    uids, gsum, _ = ops.segment_sum_np(ids, grads)
    want = table0.copy()
    want[uids] = want[uids] - np.float32(LR) * gsum
    np.testing.assert_array_equal(table.cpu().numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    opt = rowwise.make_rowwise("sgd")
    table = torch.zeros((4, D), device=cuda)
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="grads"):
        ops.fused_sparse_apply(table, (), ids,
                               torch.zeros((2, D), dtype=torch.float64,
                                           device=cuda), opt, "cuda")
    with pytest.raises(ValueError, match="plain version"):
        ops.fused_sparse_apply(table, (), ids, torch.zeros((2, D), device=cuda),
                               opt, "torch")


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_sparse_push_and_pull_take_ids_on_the_card(cuda, optimizer):
    """SparseEmbedding.push/pull with ids (and grads) already on the card:
    the same table, row versions and rows as with host arrays."""
    import ps_tpu_torch

    ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda")
    try:
        rng = np.random.default_rng(13)
        table = rng.normal(size=(V, D)).astype(np.float32)
        ids = np.array([3, 7, 3, -1, V + 2, 0, 7, 7], np.int32)
        grads = rng.normal(size=(ids.size, D)).astype(np.float32)
        embs = [ps_tpu_torch.SparseEmbedding(V, D, optimizer=optimizer,
                                             learning_rate=LR)
                for _ in range(2)]
        for emb in embs:
            emb.init(table)
        embs[0].push(ids, grads)
        embs[1].push(torch.as_tensor(ids).to(cuda),
                     torch.as_tensor(grads).to(cuda))
        np.testing.assert_array_equal(embs[0].table.cpu().numpy(),
                                      embs[1].table.cpu().numpy())
        np.testing.assert_array_equal(embs[0].row_version,
                                      embs[1].row_version)
        assert embs[1].row_version[[0, 3, 7]].tolist() == [1, 1, 1]
        on_card = torch.as_tensor([7, 3, 3]).to(cuda)
        np.testing.assert_array_equal(embs[1].pull(on_card).cpu().numpy(),
                                      embs[0].pull([7, 3, 3]).cpu().numpy())
    finally:
        ps_tpu_torch.shutdown()


# -- flash attention -------------------------------------------------------------

fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")
FB, FS, FH = 2, 128, 4


def _flash_inputs(device, dtype, d, mask_kind, seed=0, seq=FS):
    rng = np.random.default_rng(seed)
    qkv = [torch.as_tensor(rng.normal(size=(FB * FH, seq, d)).astype(
        np.float32)).to(device, dtype) for _ in range(3)]
    mask = np.ones((FB, seq), np.int32)
    if mask_kind == "padding":
        mask = (rng.random((FB, seq)) < 0.7).astype(np.int32)
        mask[:, 0] = 1
    elif mask_kind == "row_masked":
        mask[1] = 0  # batch row 1 attends nothing
    elif mask_kind == "key0_masked":
        mask[:, 0] = 0  # with causal, query 0 attends nothing
    return qkv, torch.as_tensor(mask).to(device)


def _close(got, want, dtype):
    tol = 1.6e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("mask_kind",
                         ["ones", "padding", "row_masked", "key0_masked"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(cuda, dtype, d, causal, mask_kind):
    _check_flash_case(cuda, dtype, d, causal, mask_kind, FS)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_ragged_seq(cuda, dtype, causal):
    """A length that is no multiple of the kernel's tiles: the last query
    and key tiles run past the end of each head."""
    _check_flash_case(cuda, dtype, 64, causal, "padding", 200)


def _check_flash_case(cuda, dtype, d, causal, mask_kind, seq):
    dtype = getattr(torch, dtype)
    (q, k, v), mask = _flash_inputs(cuda, dtype, d, mask_kind, seq=seq)
    scale = d ** -0.5
    before = fa.LAUNCHES
    out, lse = fa._flash_fwd_cuda(q, k, v, mask, scale, causal, FH)
    torch.cuda.synchronize(cuda)
    assert fa.LAUNCHES == before + 1
    want_out, want_lse = fa._flash_fwd_torch(q, k, v, mask, scale, causal, FH)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_out, dtype)
    _close(lse, want_lse, torch.float32)
    dead = torch.isclose(want_lse, torch.tensor(-1e30, device=cuda))
    assert torch.equal(dead, lse == -1e30)  # rows that attend nothing
    assert torch.all(out[dead] == 0)
    again, _ = fa._flash_fwd_cuda(q, k, v, mask, scale, causal, FH)
    assert torch.equal(out, again)  # the same bits run to run


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_grads_through_the_kernel(cuda, dtype, causal):
    """The gradients through the autograd.Function (kernel forward) against
    the plain forward's through the same blockwise backward."""
    dtype = getattr(torch, dtype)
    (q, k, v), mask = _flash_inputs(cuda, dtype, 64, "padding", seed=1)
    scale = 64 ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa._Flash.apply(*leaves, mask, scale, causal, 128, FH)
    do = torch.randn_like(out, dtype=torch.float32).to(dtype)
    out.backward(do)
    p_out, p_lse = fa._flash_fwd_torch(q, k, v, mask, scale, causal, FH)
    want = fa._blockwise_bwd(q, k, v, mask, p_out, p_lse, do, scale=scale,
                             causal=causal, block_k=128, heads=FH)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype
        _close(leaf.grad, w, dtype)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    mask = torch.ones((FB, FS), dtype=torch.int32, device=cuda)
    for dtype, d, match in ((torch.float32, 8, "head_dim"),
                            (torch.float64, 16, "f32 or bf16")):
        q = torch.zeros((FB * FH, FS, d), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match=match):
            fa._flash_fwd_cuda(q, q, q, mask, 1.0, False, FH)
    q = torch.zeros((FB * FH, FS, 16), device=cuda)
    with pytest.raises(ValueError, match="mask"):
        fa._flash_fwd_cuda(q, q, q, mask.float(), 1.0, False, FH)
    flat = torch.zeros((FB * FH * FS * 16 + 1,), dtype=torch.bfloat16,
                       device=cuda)
    q = flat[1:].view(FB * FH, FS, 16)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="aligned"):
        fa._flash_fwd_cuda(q, q, q, mask, 1.0, False, FH)
