"""Fused sparse embedding update: gather → optimizer-apply → scatter, in
place, batch-sized.

Counterpart of ``ps_tpu/ops/sparse_apply.py``. One entry point,
:func:`fused_sparse_apply`, and two tiers (``Config.fused_apply``,
``PS_FUSED_APPLY``):

- ``cuda`` — the hand-written kernel (``csrc/sparse_apply.cu``): the
  wrapper sorts the pushed ids once, stably, on the device, and one launch
  sums each id's duplicate grads in arrival order and applies the row-wise
  rule to the row and its state in place. It replaces the reference's
  Pallas kernel and its ``batch_segment_sum``. On CPU tensors the wrapper
  runs the plain version instead, and only because the tensors lie on the
  CPU.
- ``torch`` — the plain version: :func:`batch_segment_sum` then
  :func:`_apply_torch`, mirroring the reference's ``jax`` tier. It takes
  CPU tensors only.

``off`` (the reference's masked full-table apply) is not ported yet.

In place replaces the reference's buffer donation: the table and the
state leaves passed in are updated and returned; nothing is copied.

Numerical contract (tests/test_torch_sparse_apply.py): the plain version
matches the reference's ``jax`` tier bitwise for sgd in f32 (duplicates
summed in f32, in arrival order, from 0) and to rounding otherwise; the
kernel matches the plain version on the card (chip_smoke.py).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Any, Optional, Tuple

import torch

TIERS = ("off", "torch", "cuda")

#: launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = 0
#: the same launches by optimizer rule ("sgd", "adagrad", "adam")
LAUNCHES_BY_RULE: collections.Counter = collections.Counter()

_RULES = {"sgd": 0, "adagrad": 1, "adam": 2}


def resolve_tier(requested: Optional[str], device) -> str:
    """Normalize a ``PS_FUSED_APPLY`` value to a concrete tier for
    ``device``: ``auto`` (or None) is ``cuda`` on a CUDA device and
    ``torch`` on the CPU. ``torch`` on a CUDA device raises: the plain
    version never stands in for the kernel on the card. Unknown values
    fail loudly."""
    device = torch.device(device)
    if requested is None or requested == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if requested not in TIERS:
        raise ValueError(
            f"unknown fused-apply tier {requested!r}; use "
            f"'off', 'torch', 'cuda' or 'auto'")
    if requested == "torch" and device.type == "cuda":
        raise ValueError(
            "fused-apply tier 'torch' is the plain version and runs on the "
            "CPU only; a CUDA device takes 'cuda' (or 'auto')")
    return requested


def batch_segment_sum(ids: torch.Tensor, grads: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch-sized dedupe + segment sum of a push's (ids, grads).

    ``ids`` [N] int32 with duplicates and -1 filler allowed; ``grads``
    [N, D]. Returns ``(uids, gsum, cnt)`` all length N: each unique real
    id survives at one slot (its first position in sorted order) with its
    duplicates' grads summed in f32, from 0, in arrival order (stable
    sort; ``segment_reduce`` walks each segment sequentially on the CPU
    and the card alike, with no atomics); duplicates and filler become
    ``uid=-1, gsum=0, cnt=0``.
    """
    n = ids.shape[0]
    if n == 0:
        return (ids, grads.to(torch.float32),
                torch.zeros((0,), dtype=torch.int32, device=ids.device))
    order = torch.sort(ids, stable=True).indices  # duplicates keep arrival order
    ids_s = ids[order]
    grads_s = grads[order].to(torch.float32)
    first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first, 0) - 1
    _, lengths = torch.unique_consecutive(ids_s, return_counts=True)
    summed = torch.segment_reduce(grads_s, "sum", lengths=lengths, axis=0,
                                  unsafe=True)
    real = first & (ids_s >= 0)
    uids = torch.where(real, ids_s, -1)
    gsum = torch.where(real[:, None], summed[seg], 0.0)
    cnt = torch.where(real, lengths[seg].to(torch.int32), 0)
    return uids, gsum, cnt


def segment_sum_np(ids, grads):
    """Host twin of :func:`batch_segment_sum` (copied from the reference):
    dedupe a push's (ids, grads) with numpy, duplicates summed in f32 in
    arrival order (``np.add.at`` accumulates sequentially). Returns compact
    ``(uids [U], gsum [U, D] f32, cnt [U])`` with filler (-1) ids dropped."""
    import numpy as np

    ids = np.asarray(ids, np.int32).reshape(-1)
    grads = np.asarray(grads).reshape(ids.shape[0], -1)
    real = ids >= 0
    ids, grads = ids[real], grads[real]
    if ids.size == 0:
        return (ids, np.zeros((0, grads.shape[1]), np.float32),
                np.zeros((0,), np.int32))
    uids, inv, cnt = np.unique(ids, return_inverse=True,
                               return_counts=True)
    gsum = np.zeros((uids.size, grads.shape[1]), np.float32)
    np.add.at(gsum, inv, grads.astype(np.float32))
    return uids, gsum, cnt.astype(np.int32)


def fused_sparse_apply(table: torch.Tensor, state: Any, ids: torch.Tensor,
                       grads: torch.Tensor, opt, tier: str
                       ) -> Tuple[torch.Tensor, Any]:
    """The entry point every sparse apply routes through. ``ids`` [N] int32
    are table rows with -1 filler, ``grads`` [N, D] f32 with filler rows
    zeroed. Updates ``table`` and ``state`` in place (only touched rows'
    bytes move) and returns them.

    On a CUDA table the ``cuda`` tier launches the kernel (or raises); on
    a CPU table both tiers run the plain version."""
    if tier == "off":
        raise ValueError("tier 'off' is the caller's own full-table path "
                         "— fused_sparse_apply never runs it")
    if tier not in TIERS:
        raise ValueError(f"unknown fused-apply tier {tier!r}")
    if ids.shape[0] == 0:  # empty push: nothing gathered, nothing written
        return table, state
    if table.device.type == "cuda":
        if tier != "cuda":
            raise ValueError(
                f"fused-apply tier {tier!r} on a CUDA table: the plain "
                f"version runs on CPU tensors only")
        return _apply_cuda(opt, table, state, ids, grads)
    uids, gsum, cnt = batch_segment_sum(ids, grads)
    return _apply_torch(opt, table, state, uids, gsum, cnt)


# -- state leaves --------------------------------------------------------------


def state_leaves(state) -> list:
    """The state's tensors in the reference's tree order (dict keys
    sorted): () for sgd, [acc] for adagrad, [m, t, v] for adam."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return list(state)


def _map_state(fn, state):
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: fn(v) for k, v in state.items()}
    return type(state)(fn(v) for v in state)


# -- plain version ---------------------------------------------------------------


def _apply_torch(opt, table, state, uids, gsum, cnt):
    """Batch-sized gather → apply_rows → scatter in plain PyTorch, in
    place. Filler slots (and ids past the table, which the reference's
    ``take``/``mode='drop'`` pair also ignores) gather row 0 and are not
    written back."""
    num_rows = table.shape[0]
    real = (uids >= 0) & (uids < num_rows)
    slot = torch.where(real, uids, 0).to(torch.int64)
    rows = table.index_select(0, slot)
    state_rows = _map_state(lambda leaf: leaf.index_select(0, slot), state)
    new_rows, new_state_rows = opt.apply_rows(rows, state_rows, gsum, cnt)
    dst = slot[real]
    table.index_copy_(0, dst, new_rows[real].to(table.dtype))
    for leaf, new in zip(state_leaves(state), state_leaves(new_state_rows)):
        leaf.index_copy_(0, dst, new[real].to(leaf.dtype))
    return table, state


# -- the kernel ------------------------------------------------------------------


def _kernel_args(opt, table, state):
    """Check what the kernel takes; return (rule, state pointers)."""
    rule = _RULES.get(getattr(opt, "kind", None))
    if rule is None:
        raise ValueError(
            f"the CUDA sparse apply runs sgd, adagrad and adam; got an "
            f"optimizer of kind {getattr(opt, 'kind', None)!r}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous [R, D] tensor")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table dtype {table.dtype} is not f32 or bf16")
    rows, dim = table.shape
    leaves = state_leaves(state)
    if opt.kind == "sgd":
        want = []
    elif opt.kind == "adagrad":
        want = [((rows,), torch.float32)]
    else:  # adam: m, t, v in tree order
        want = [((rows, dim), torch.float32), ((rows,), torch.int32),
                ((rows, dim), torch.float32)]
    if len(leaves) != len(want):
        raise ValueError(f"{opt.kind} state has {len(leaves)} leaves, "
                         f"the kernel takes {len(want)}")
    for leaf, (shape, dtype) in zip(leaves, want):
        if (tuple(leaf.shape) != shape or leaf.dtype != dtype
                or leaf.device != table.device or not leaf.is_contiguous()):
            raise ValueError(
                f"{opt.kind} state leaf {tuple(leaf.shape)} {leaf.dtype} on "
                f"{leaf.device}: the kernel takes contiguous {shape} {dtype} "
                f"on {table.device}")
    ptrs = [leaf.data_ptr() for leaf in leaves]
    if opt.kind == "adagrad":
        st_a, st_b, st_t = ptrs[0], None, None
    elif opt.kind == "adam":
        st_a, st_t, st_b = ptrs
    else:
        st_a = st_b = st_t = None
    return rule, st_a, st_b, st_t


def _lib():
    from ps_tpu_torch.ops import _build

    lib = _build.load("sparse_apply")
    if not getattr(lib, "_ps_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_sparse_apply.argtypes = [i, i, p, p, p, p, p, p, p, ll, ll, ll,
                                        f, f, f, f, f, f, i, p]
        lib.ps_sparse_apply.restype = i
        lib.ps_cuda_error_string.argtypes = [i]
        lib.ps_cuda_error_string.restype = ctypes.c_char_p
        lib._ps_typed = True
    return lib


def _launch(opt, table, state, ids_s, order, grads):
    """One launch of the kernel on sorted ids (``ids_s`` int32, ``order``
    the stable sort's int64 permutation) and the grads in arrival order.
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    rule, st_a, st_b, st_t = _kernel_args(opt, table, state)
    n = ids_s.shape[0]
    dim = table.shape[1]
    for name, t, dtype, shape in (("ids", ids_s, torch.int32, (n,)),
                                  ("order", order, torch.int64, (n,)),
                                  ("grads", grads, torch.float32, (n, dim))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != table.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: the "
                f"kernel takes contiguous {shape} {dtype} on {table.device}")
    hp = opt.hyper
    b1, b2 = hp.get("b1", 0.0), hp.get("b2", 0.0)
    lib = _lib()
    rc = lib.ps_sparse_apply(
        rule, int(table.dtype == torch.bfloat16), table.data_ptr(),
        st_a, st_b, st_t, ids_s.data_ptr(), order.data_ptr(),
        grads.data_ptr(), n, dim, table.shape[0], hp["lr"], b1, b2,
        1.0 - b1, 1.0 - b2, hp.get("eps", 0.0), table.device.index,
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_apply kernel launch failed: CUDA error "
                           f"{rc} ({lib.ps_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    LAUNCHES_BY_RULE[opt.kind] += 1
    return table, state


def _apply_cuda(opt, table, state, ids, grads):
    """The kernel's wrapper: one stable sort of the ids on the device, then
    one launch. No host sync, no allocation inside the kernel."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"ids must be [N] int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    ids_s, order = torch.sort(ids, stable=True)
    return _launch(opt, table, state, ids_s, order, grads)


# -- HBM traffic model -----------------------------------------------------------


def hbm_bytes_model(num_rows: int, dim: int, batch_rows: int, opt,
                    table_dtype_bytes: int = 4) -> dict:
    """Arithmetic HBM bytes per apply under the fused and the full-table
    designs (copied from the reference). ``batch_rows`` = unique touched
    rows. Both are lower-bound models (no padding/layout slack)."""
    state_row = opt.state_scalars_per_row(dim) * 4
    row = dim * table_dtype_bytes + state_row
    grad_row = (dim + 1) * 4  # summed grads + count per row
    fused = batch_rows * (2 * row + 2 * grad_row)
    full = (num_rows * (2 * row + 2 * grad_row)
            + batch_rows * grad_row)
    return {"fused_bytes_per_apply": int(fused),
            "full_table_bytes_per_apply": int(full),
            "ratio": round(full / max(fused, 1), 2)}
