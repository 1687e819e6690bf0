"""Fused sparse embedding update: gather → optimizer-apply → scatter, in
place, batch-sized.

Counterpart of ``ps_tpu/ops/sparse_apply.py``. One entry point,
:func:`fused_sparse_apply`, and two tiers (``Config.fused_apply``,
``PS_FUSED_APPLY``):

- ``cuda`` — two hand-written kernels: the grouping pass
  (``csrc/sparse_group.cu``, :func:`group_ids`) sorts the pushed ids
  stably and writes one entry per unique real id; the apply
  (``csrc/sparse_apply.cu``) sums each id's duplicate grads in arrival
  order and applies the row-wise rule to the row and its state in place.
  Two launches in all at up to :data:`GROUP_BLOCK_MAX` ids; above it the
  grouping pass sorts with ``torch.sort`` (a cluster's shared memory holds no
  more) and builds its segments in two launches. Together they replace the
  reference's Pallas kernel and its ``batch_segment_sum``. Ids outside
  ``[0, num_rows)`` are filler: their grads are never read. On CPU tensors
  the wrapper runs the plain version instead, and only because the tensors
  lie on the CPU.
- ``torch`` — the plain version: :func:`batch_segment_sum` then
  :func:`_apply_torch`, mirroring the reference's ``jax`` tier. It takes
  CPU tensors only.

- ``off`` — the reference's legacy masked full-table apply
  (``ps_tpu/kv/sparse.py:258-268``), in plain PyTorch on either device:
  a table-sized ``gsum``/``cnt`` with an overflow slot for the ids
  outside the table, then the optimizer's masked rule over the whole
  table (:func:`_apply_off`). The reference computes it in XLA, outside
  any Pallas kernel, so it has no kernel here either. Its cost is
  O(table), the fused tiers' O(batch).

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
from typing import Any, NamedTuple, Optional, Tuple

import torch

TIERS = ("off", "torch", "cuda")

#: launches of the apply kernel, counted where the wrapper launches it
LAUNCHES = 0
#: the same launches by optimizer rule ("sgd", "adagrad", "adam")
LAUNCHES_BY_RULE: collections.Counter = collections.Counter()
#: launches of the grouping pass's kernels (one per apply up to
#: GROUP_BLOCK_MAX ids, two above), counted where the wrapper launches them
GROUP_LAUNCHES = 0

_RULES = {"sgd": 0, "adagrad": 1, "adam": 2}

#: the most ids the grouping pass sorts in a cluster's shared memory
GROUP_BLOCK_MAX = 16_384
#: bits of a radix digit, at most (2,048 per-warp counters per pass)
DIGIT_BITS = 11
#: sorted ids per block of the grouping pass's segment kernels
SEG_TILE = 8_192
#: ints of the grouping pass's ``meta``: segments, real ids, first real slot
META = 3


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
    are table rows; ids outside ``[0, num_rows)`` (-1 filler, ids past the
    table) are never applied. ``grads`` [N, D] f32. Updates ``table`` and
    ``state`` in place (only touched rows' bytes move) and returns them.

    On a CUDA table the ``cuda`` tier launches the kernels (or raises) and
    never reads a filler id's grads; on a CPU table both fused tiers run
    the plain version. The ``off`` tier runs the masked full-table apply
    on either device."""
    if tier not in TIERS:
        raise ValueError(f"unknown fused-apply tier {tier!r}")
    if ids.shape[0] == 0:  # empty push: nothing gathered, nothing written
        return table, state
    if tier == "off":
        return _apply_off(opt, table, state, ids, grads)
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


# -- the masked full-table tier ('off') ------------------------------------------


def _table_sums(ids: torch.Tensor, grads: torch.Tensor, num_rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table-sized ``(gsum [num_rows + 1, D] f32, cnt [num_rows + 1]
    int32)`` of a push: row r's duplicates summed in f32, from 0, in
    arrival order (the reference's ``.at[slot].add`` on the CPU, and the
    kernel's order); ids outside ``[0, num_rows)`` land in the overflow
    slot ``num_rows``, which the caller cuts off. On the card an
    ``index_add_`` of colliding ids would sum in any order, so the
    duplicates are added one rank at a time: pass k adds every id's k-th
    occurrence, whose rows are distinct (one host read sizes the
    passes)."""
    n, dim = grads.shape
    ok = (ids >= 0) & (ids < num_rows)
    keys = torch.where(ok, ids, num_rows).to(torch.int64)
    keys_s, order = torch.sort(keys, stable=True)
    grads_s = grads[order].to(torch.float32)
    head = torch.ones((n,), dtype=torch.bool, device=ids.device)
    head[1:] = keys_s[1:] != keys_s[:-1]
    starts = torch.nonzero(head).reshape(-1)
    rank = (torch.arange(n, device=ids.device)
            - starts[torch.cumsum(head, 0) - 1])
    by_rank = torch.sort(rank, stable=True).indices
    sizes = torch.bincount(rank).tolist()
    gsum = torch.zeros((num_rows + 1, dim), dtype=torch.float32,
                       device=ids.device)
    lo = 0
    for size in sizes:
        sel = by_rank[lo:lo + size]
        gsum.index_add_(0, keys_s[sel], grads_s[sel])
        lo += size
    cnt = torch.zeros((num_rows + 1,), dtype=torch.int32, device=ids.device)
    cnt.index_add_(0, keys, torch.ones_like(keys, dtype=torch.int32))
    return gsum, cnt


def _apply_off(opt, table, state, ids, grads):
    """The reference's masked full-table apply, in place: the push's
    table-sized sums (:func:`_table_sums`), then ``opt.apply`` over every
    row with the touched mask ``cnt > 0`` (an untouched row sees a zero
    gradient and keeps its bits under sgd and adagrad, its state under
    lazy adam), copied back into ``table`` and ``state``."""
    num_rows = table.shape[0]
    gsum, cnt = _table_sums(ids.reshape(-1), grads.reshape(ids.numel(), -1),
                            num_rows)
    new_table, new_state = opt.apply(table, state, gsum[:-1], cnt[:-1] > 0)
    table.copy_(new_table)
    for leaf, new in zip(state_leaves(state), state_leaves(new_state)):
        leaf.copy_(new)
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


# -- the grouping pass ------------------------------------------------------------


class Group(NamedTuple):
    """What the grouping pass writes, all int32 on the ids' device.

    ``ids_s`` [N] the sorted ids, ``perm`` [N] the stable permutation
    (``ids_s[i]`` is ``ids[perm[i]]`` for a real id); the real ids occupy
    ``[lo, lo + n_real)`` of both. Segment ``s < U`` (one per unique real
    id, ascending) is ``ids_s[seg_start[s]:seg_start[s + 1]]`` with id
    ``seg_id[s]``. ``meta`` = ``[U, n_real, lo]``. Entries of
    ``seg_start`` past ``U`` and of ``seg_id`` past ``U - 1`` are scratch.
    """

    ids_s: torch.Tensor
    perm: torch.Tensor
    seg_start: torch.Tensor
    seg_id: torch.Tensor
    meta: torch.Tensor


def key_bits(num_rows: int) -> int:
    """Bits of the grouping pass's sort key: real ids are below
    ``num_rows`` and every filler id becomes ``num_rows`` itself, so
    ``num_rows.bit_length()`` bits hold them all (22 for 2,600,000)."""
    return max(1, int(num_rows).bit_length())


def plan_group(n: int, num_rows: int, path: Optional[str] = None) -> dict:
    """The grouping pass's plan for ``n`` ids into ``num_rows`` rows,
    computed on the host: the path (``cluster`` sorts in the shared
    memory of a cluster of 8 blocks, up to :data:`GROUP_BLOCK_MAX` ids; ``sorted`` takes
    ``torch.sort`` and builds the segments in two launches), the key bits,
    the radix passes and their digit bits (at most :data:`DIGIT_BITS`), the
    int32 scratch the wrapper allocates, and the launches."""
    if not 0 <= num_rows < 2**31:
        raise ValueError(f"num_rows {num_rows} does not fit an int32 id")
    if not 0 <= n < 2**31:
        raise ValueError(f"{n} ids do not fit int32 positions")
    if path is None:
        path = "cluster" if n <= GROUP_BLOCK_MAX else "sorted"
    if path not in ("cluster", "sorted"):
        raise ValueError(f"unknown grouping path {path!r}")
    if path == "cluster" and n > GROUP_BLOCK_MAX:
        raise ValueError(f"the cluster path sorts at most {GROUP_BLOCK_MAX} "
                         f"ids, got {n}")
    bits = key_bits(num_rows)
    passes = -(-bits // DIGIT_BITS)
    blocks = -(-n // SEG_TILE)
    # block: ids_s, perm, seg_start (n + 1), seg_id, meta; sorted: the same
    # but ids_s (torch.sort's), plus 3 counts per segment block
    scratch = (4 * n + 1 + META if path == "cluster"
               else 3 * n + 1 + META + 3 * blocks)
    return {"path": path, "key_bits": bits, "passes": passes,
            "digit_bits": -(-bits // passes), "scratch_ints": scratch,
            "launches": 1 if path == "cluster" else 2}


def group_ids(ids: torch.Tensor, num_rows: int,
              path: Optional[str] = None) -> Group:
    """The grouping pass: on CUDA ids, its kernels (``path`` forces one,
    for timing; None chooses by N), else its plain version."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"ids must be [N] int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if ids.device.type == "cuda":
        return _group_cuda(ids, num_rows, path)
    return _group_torch(ids, num_rows)


def _group_torch(ids: torch.Tensor, num_rows: int) -> Group:
    """The grouping pass's plain version: a stable ``torch.sort`` of the
    keys (filler as ``num_rows``, so it sorts last) and the segments by
    comparison with each predecessor; the cluster path's layout."""
    n = ids.shape[0]
    keys = torch.where((ids >= 0) & (ids < num_rows), ids,
                       torch.full_like(ids, num_rows))
    ids_s, order = torch.sort(keys, stable=True)
    real = ids_s < num_rows
    head = real.clone()
    head[1:] &= ids_s[1:] != ids_s[:-1]
    starts = torch.nonzero(head).reshape(-1).to(torch.int32)
    segs, n_real = starts.numel(), int(real.sum())
    seg_start = torch.zeros((n + 1,), dtype=torch.int32, device=ids.device)
    seg_start[:segs] = starts
    seg_start[segs] = n_real
    seg_id = torch.zeros((n,), dtype=torch.int32, device=ids.device)
    seg_id[:segs] = ids_s[starts.long()]
    meta = torch.tensor([segs, n_real, 0], dtype=torch.int32,
                        device=ids.device)
    return Group(ids_s, order.to(torch.int32), seg_start, seg_id, meta)


def _group_lib():
    from ps_tpu_torch.ops import _build

    lib = _build.load("sparse_group")
    if not getattr(lib, "_ps_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ps_sparse_group_cluster.argtypes = [p, ll, ll, i, i, p, p, p, p, p,
                                              i, p]
        lib.ps_sparse_group_cluster.restype = i
        lib.ps_sparse_group_sorted.argtypes = [p, p, ll, ll, p, p, p, p, p,
                                               i, p]
        lib.ps_sparse_group_sorted.restype = i
        lib.ps_empty_launch.argtypes = [i, p]
        lib.ps_empty_launch.restype = i
        lib.ps_group_error_string.argtypes = [i]
        lib.ps_group_error_string.restype = ctypes.c_char_p
        lib._ps_typed = True
    return lib


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.ps_group_error_string(rc).decode()})")


def _group_cuda(ids: torch.Tensor, num_rows: int,
                path: Optional[str] = None) -> Group:
    """The grouping pass's kernels on the current stream: no host sync;
    scratch from ``torch.empty``."""
    global GROUP_LAUNCHES
    n = ids.shape[0]
    plan = plan_group(n, num_rows, path)
    ids = ids.contiguous()
    scratch = torch.empty((plan["scratch_ints"],), dtype=torch.int32,
                          device=ids.device)
    lib = _group_lib()
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    dev = ids.device.index
    if plan["path"] == "cluster":
        ids_s, perm, seg_start, seg_id, meta = torch.split(
            scratch, [n, n, n + 1, n, META])
        rc = lib.ps_sparse_group_cluster(
            ids.data_ptr(), n, num_rows, plan["passes"], plan["digit_bits"],
            ids_s.data_ptr(), perm.data_ptr(), seg_start.data_ptr(),
            seg_id.data_ptr(), meta.data_ptr(), dev, stream)
        _check_rc(lib, rc, "sparse_group block")
    else:
        ids_s, order = torch.sort(ids, stable=True)
        perm, seg_start, seg_id, meta, counts = torch.split(
            scratch, [n, n + 1, n, META, plan["scratch_ints"] - 3 * n - 1
                      - META])
        rc = lib.ps_sparse_group_sorted(
            ids_s.data_ptr(), order.data_ptr(), n, num_rows, perm.data_ptr(),
            seg_start.data_ptr(), seg_id.data_ptr(), meta.data_ptr(),
            counts.data_ptr(), dev, stream)
        _check_rc(lib, rc, "sparse_group segments")
    GROUP_LAUNCHES += plan["launches"]
    return Group(ids_s, perm, seg_start, seg_id, meta)


def empty_launch(device) -> None:
    """Launch an empty kernel on the current stream: the floor one launch
    costs, timed beside the kernels. Counted nowhere."""
    device = torch.device(device)
    lib = _group_lib()
    _check_rc(lib, lib.ps_empty_launch(
        device.index, torch.cuda.current_stream(device).cuda_stream), "empty")


# -- the apply kernel --------------------------------------------------------------


def _lib():
    from ps_tpu_torch.ops import _build

    lib = _build.load("sparse_apply")
    if not getattr(lib, "_ps_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_sparse_apply.argtypes = [i, i, p, p, p, p, p, p, p, p, p, ll,
                                        ll, f, f, f, f, f, f, i, p]
        lib.ps_sparse_apply.restype = i
        lib.ps_cuda_error_string.argtypes = [i]
        lib.ps_cuda_error_string.restype = ctypes.c_char_p
        lib._ps_typed = True
    return lib


def _check_launch_args(table, group: Group, grads):
    """Check the apply kernel's inputs besides the table and state."""
    n = group.perm.shape[0]
    dim = table.shape[1]
    want = (("grads", grads, torch.float32, (n, dim)),
            ("perm", group.perm, torch.int32, (n,)),
            ("seg_start", group.seg_start, torch.int32, (n + 1,)),
            ("seg_id", group.seg_id, torch.int32, (n,)),
            ("meta", group.meta, torch.int32, (META,)))
    for name, t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != table.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: the "
                f"kernel takes contiguous {shape} {dtype} on {table.device}")


def _launch(opt, table, state, group: Group, grads):
    """One launch of the apply kernel on a grouping pass's output and the
    grads in arrival order. Launches on the current stream and does not
    synchronise."""
    global LAUNCHES
    rule, st_a, st_b, st_t = _kernel_args(opt, table, state)
    _check_launch_args(table, group, grads)
    hp = opt.hyper
    b1, b2 = hp.get("b1", 0.0), hp.get("b2", 0.0)
    lib = _lib()
    rc = lib.ps_sparse_apply(
        rule, int(table.dtype == torch.bfloat16), table.data_ptr(),
        st_a, st_b, st_t, grads.data_ptr(), group.perm.data_ptr(),
        group.seg_start.data_ptr(), group.seg_id.data_ptr(),
        group.meta.data_ptr(), group.perm.shape[0], table.shape[1], hp["lr"],
        b1, b2, 1.0 - b1, 1.0 - b2, hp.get("eps", 0.0), table.device.index,
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_apply kernel launch failed: CUDA error "
                           f"{rc} ({lib.ps_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    LAUNCHES_BY_RULE[opt.kind] += 1
    return table, state


def _apply_cuda(opt, table, state, ids, grads):
    """The kernels' wrapper: the grouping pass, then one launch of the
    apply. No host sync, no allocation inside a kernel."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"ids must be [N] int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    _kernel_args(opt, table, state)  # raise before launching anything
    if (grads.dtype != torch.float32 or grads.dim() != 2
            or grads.shape[0] != ids.shape[0]):
        raise ValueError(f"grads {tuple(grads.shape)} {grads.dtype}: the "
                         f"kernel takes [{ids.shape[0]}, D] float32")
    group = group_ids(ids, table.shape[0])
    return _launch(opt, table, state, group, grads)


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
