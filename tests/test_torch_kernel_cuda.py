"""The CUDA sparse-apply kernel against its plain version, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and ``nvcc``; elsewhere they skip (the ``cuda`` marker). They carry the
sweep of tests/test_torch_sparse_apply.py to ``tier='cuda'``: the kernel
and the plain version (``batch_segment_sum`` + ``_apply_torch``) run on
the same CUDA tensors. f32 within rtol 1e-6, atol 1e-7 (the mean over D
and ``pow`` may round differently); bf16 within one bf16 ulp. Run them on
the card with ``python -m pytest tests/test_torch_kernel_cuda.py``;
``chip_smoke.py`` runs the same checks at the Wide-&-Deep shapes.
"""

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
