"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and ``nvcc``; elsewhere they skip (the ``cuda`` marker). Run them on the
card with ``python -m pytest tests/test_torch_kernel_cuda.py``;
``chip_smoke.py`` runs the same checks at the main paths' shapes.

- Sparse apply: the sweep of tests/test_torch_sparse_apply.py carried to
  ``tier='cuda'``: the kernel and the plain version (``batch_segment_sum``
  + ``_apply_torch``) run on the same CUDA tensors. f32 within rtol 1e-6,
  atol 1e-7 (the mean over D and ``pow`` may round differently); bf16
  within one bf16 ulp.
- Flash attention: the kernel and ``_flash_fwd_torch`` on the same CUDA
  tensors. The kernel sums keys in its own order, so f32 is held to
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


# -- flash attention -------------------------------------------------------------

fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")
FB, FS, FH = 2, 128, 4


def _flash_inputs(device, dtype, d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    qkv = [torch.as_tensor(rng.normal(size=(FB * FH, FS, d)).astype(
        np.float32)).to(device, dtype) for _ in range(3)]
    mask = np.ones((FB, FS), np.int32)
    if mask_kind == "padding":
        mask = (rng.random((FB, FS)) < 0.7).astype(np.int32)
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
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(cuda, dtype, d, causal, mask_kind):
    dtype = getattr(torch, dtype)
    (q, k, v), mask = _flash_inputs(cuda, dtype, d, mask_kind)
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
