"""Fused multi-tensor LAMB step on the card: ``csrc/lamb_apply.cu``.

:func:`lamb_apply_` steps every tensor of one LAMB step in place in two
launches a group of up to :data:`MAX_TENSORS` tensors: the moments, then
the trust ratio and the parameters. It computes what ``optim.lamb``'s loop
over the keys computes (optax's chain in float32, expression by
expression) and is its fast route: ``optim.lamb`` sends a key here when
its parameter, gradient and moments are contiguous f32 tensors on one CUDA
device (:func:`takes`), and every other key, every CPU tensor included,
keeps the loop, which is this kernel's plain version.

The kernel walks a table of chunks (:func:`chunk_table`), built here once
for each list of tensor sizes and kept on the card; the tensors' addresses
go in the launch's parameters every call, since gradients move every step.
Nothing synchronizes the host: the table's first upload is an asynchronous
copy from pinned memory, and a scheduled rate is read on the card.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

#: values a block steps: a tensor larger than this is cut into chunks of it
CHUNK = 16_384
#: tensors one launch pair takes (the kernel's parameter table)
MAX_TENSORS = 256
#: chunk tables kept on the card, the most recently used
TABLES_KEPT = 64

#: launches of the kernels (two a group of tensors), counted where the
#: wrapper launches them
LAUNCHES = 0

_F32 = torch.float32

# (device, sizes) -> the table on the device, its chunks and segments
_tables: "collections.OrderedDict[tuple, Tuple[torch.Tensor, int, int]]" = \
    collections.OrderedDict()


def takes(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
          nu: torch.Tensor) -> bool:
    """Whether the kernel steps this key: its parameter, gradient and
    moments contiguous f32 of one shape, not empty, on one CUDA device.
    Asked of every key of every step, so written for the host's time."""
    if not (p.is_cuda and p.dtype is _F32 and p.is_contiguous()
            and p.numel() > 0):
        return False
    shape, device = p.shape, p.device
    for t in (g, mu, nu):
        if not (t.dtype is _F32 and t.is_contiguous() and t.shape == shape
                and t.device == device):
            return False
    return True


def chunk_table(numels: Sequence[int], chunk: int = CHUNK
                ) -> Tuple[np.ndarray, int, int]:
    """The kernel's work table for tensors of ``numels`` values, as one
    int64 array: ``chunk_first`` [chunks + 1], then ``seg_tensor``,
    ``seg_offset`` and ``seg_len`` [segments each], then ``tensor_seg``
    [tensors + 1]; and the counts of chunks and segments.

    Segments are runs of one tensor's values, in tensor order; chunk c
    holds segments ``chunk_first[c]`` to ``chunk_first[c + 1]``, at most
    ``chunk`` values, and tensor i segments ``tensor_seg[i]`` to
    ``tensor_seg[i + 1]``. A tensor is cut into chunks of ``chunk``
    values; what remains (a whole tensor smaller than ``chunk``) shares a
    chunk with the next such remainders while they fit. Offsets are
    multiples of ``chunk``, so a segment is 16-byte aligned wherever its
    tensor is."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4, got "
                         f"{chunk}")
    seg_tensor: List[int] = []
    seg_offset: List[int] = []
    seg_len: List[int] = []
    chunk_first = [0]
    tensor_seg = [0]
    fill = 0  # values in the open shared chunk
    for i, n in enumerate(numels):
        full, rest = divmod(int(n), chunk)
        if full and fill:
            chunk_first.append(len(seg_tensor))
            fill = 0
        for j in range(full):
            seg_tensor.append(i)
            seg_offset.append(j * chunk)
            seg_len.append(chunk)
            chunk_first.append(len(seg_tensor))
        if rest:
            if fill + rest > chunk:
                chunk_first.append(len(seg_tensor))
                fill = 0
            seg_tensor.append(i)
            seg_offset.append(full * chunk)
            seg_len.append(rest)
            fill += rest
        tensor_seg.append(len(seg_tensor))
    if fill:
        chunk_first.append(len(seg_tensor))
    table = np.concatenate([np.asarray(x, np.int64) for x in (
        chunk_first, seg_tensor, seg_offset, seg_len, tensor_seg)])
    return table, len(chunk_first) - 1, len(seg_tensor)


def _table(numels: Tuple[int, ...], device: torch.device
           ) -> Tuple[torch.Tensor, int, int]:
    """:func:`chunk_table` of ``numels`` on ``device``, made once and kept
    (the :data:`TABLES_KEPT` most recently used)."""
    key = (device, numels)
    hit = _tables.get(key)
    if hit is not None:
        _tables.move_to_end(key)
        return hit
    table, chunks, segments = chunk_table(numels)
    host = torch.from_numpy(table).pin_memory()
    entry = (host.to(device, non_blocking=True), chunks, segments)
    _tables[key] = entry
    if len(_tables) > TABLES_KEPT:
        _tables.popitem(last=False)
    return entry


def _lib():
    from ps_tpu_torch.ops import _build

    lib = _build.load("lamb_apply")
    if not getattr(lib, "_ps_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_lamb_apply.argtypes = [p, i, p, ll, ll, p, p, p, f, f, f, f, f,
                                      f, f, i, i, p]
        lib.ps_lamb_apply.restype = i
        lib.ps_cuda_error_string.argtypes = [i]
        lib.ps_cuda_error_string.restype = ctypes.c_char_p
        lib._ps_typed = True
    return lib


@torch.no_grad()
def lamb_apply_(params: List[torch.Tensor], grads: List[torch.Tensor],
                mus: List[torch.Tensor], nus: List[torch.Tensor],
                count: torch.Tensor, lr: Union[float, torch.Tensor],
                b1: float, b2: float, eps: float, weight_decay: float,
                increment: bool = True, checked: bool = False) -> None:
    """One LAMB step of every ``params[i]`` with ``grads[i]`` and its
    moments ``mus[i]``, ``nus[i]``, all in place, on the current stream
    (no sync). ``count`` is the int32 step count on the same device: the
    step increments it first, unless ``increment`` is False (another
    route counted this step already). ``lr`` is a float or a 0-d tensor.
    Every key must satisfy :func:`takes`, on one device: checked here
    unless ``checked`` says the caller chose the keys by it."""
    global LAUNCHES
    if not params:
        return
    device = params[0].device
    if not checked:
        for quad in zip(params, grads, mus, nus):
            if not takes(*quad) or quad[0].device != device:
                raise ValueError("the LAMB kernel takes contiguous f32 "
                                 "parameters, gradients and moments of one "
                                 "shape on one CUDA device")
    if (count.device != device or count.dtype != torch.int32
            or count.numel() != 1):
        raise ValueError(f"the step count must be one int32 on {device}, "
                         f"got {count.dtype} {tuple(count.shape)} on "
                         f"{count.device}")
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor):
        lr = lr.to(device=device, dtype=torch.float32)
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in range(0, len(params), MAX_TENSORS):
        group = slice(lo, lo + MAX_TENSORS)
        ps_, gs, ms, vs = params[group], grads[group], mus[group], nus[group]
        numels = tuple(p.numel() for p in ps_)
        table, chunks, segments = _table(numels, device)
        scratch = torch.empty(2 * segments + 1, dtype=torch.float32,
                              device=device)
        n = len(ps_)
        ptrs = np.array([t.data_ptr() for ts in (ps_, gs, ms, vs)
                         for t in ts], np.int64)
        rc = lib.ps_lamb_apply(
            ptrs.ctypes.data, n, table.data_ptr(), chunks, segments,
            scratch.data_ptr(), count.data_ptr(), lr_ptr, lr_value, b1,
            1 - b1, b2, 1 - b2, eps, weight_decay,
            int(increment and lo == 0), device.index, stream)
        if rc != 0:
            raise RuntimeError(
                f"lamb_apply kernel launch failed: CUDA error {rc} "
                f"({lib.ps_cuda_error_string(rc).decode()})")
        LAUNCHES += 2

