"""Flash attention: the forward as a hand-written CUDA kernel, the backward
blockwise in PyTorch.

Counterpart of ``ps_tpu/ops/flash_attention.py``. One entry point,
:func:`flash_attention`, in the reference's ``[B, S, h, d]`` layout:

- the forward on CUDA tensors is ``csrc/flash_attention.cu`` (it replaces
  the reference's Pallas ``_fwd_kernel``); on CPU tensors, and only
  because they lie on the CPU, it is the plain version
  :func:`_flash_fwd_torch`, the same online softmax over key blocks;
- the backward is the reference's ``_blockwise_bwd`` (plain JAX there, not
  a Pallas kernel) in torch ops, inside a ``torch.autograd.Function``:
  exact probabilities recomputed per key block from the saved
  log-sum-exp, in f32, never the whole ``[S, S]``.

Masked scores are exactly -1e30 and ``p`` is gated by ``s > -1e30 / 2``,
so a row whose every visible key is masked gives zeros forward and
backward and ``lse == -1e30`` (tests/test_torch_flash_attention.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64)  # the head widths the kernel is built for

#: launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = 0


# -- plain version ---------------------------------------------------------------


def _flash_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, scale: float, causal: bool,
                     heads: int, block_k: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``q, k, v`` [BH, S, d],
    ``mask`` [B, S] (1 = attend; row ``bh`` reads mask row ``bh //
    heads``). Returns ``out`` [BH, S, d] in the input's type and ``lse``
    [BH, S] f32. Online softmax over ``block_k`` keys at a time, with the
    reference's arithmetic: dots on the inputs' values in f32, scaled
    after; ``p`` rounded to V's type before P·V."""
    bh, seq, d = q.shape
    qf = q.float()
    mask_bh = mask.to(torch.int32).repeat_interleave(heads, 0)  # [BH, S]
    qpos = torch.arange(seq, device=q.device)[:, None]
    m = torch.full((bh, seq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bh, seq, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, seq, block_k):
        j1 = min(j0 + block_k, seq)
        s = torch.matmul(qf, k[:, j0:j1].float().transpose(1, 2)) * scale
        if causal:
            kpos = torch.arange(j0, j1, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        s = torch.where(mask_bh[:, None, j0:j1] > 0, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > _NEG_INF / 2, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, j0:j1].float())
        acc = acc * alpha + pv
        m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _blockwise_bwd(q, k, v, mask, o, lse, do, *, scale: float, causal: bool,
                   block_k: int, heads: int):
    """Exact flash backward, blockwise over keys, as the reference's
    ``_blockwise_bwd``: probabilities recomputed per key block from the
    saved ``lse``, in f32; grads cast back to the inputs' types."""
    bh, seq, d = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    # D_i = sum_d dO_i * O_i, the softmax-jacobian row term
    delta = torch.sum(dof * o.float(), dim=-1)[..., None]  # [BH, S, 1]
    qpos = torch.arange(seq, device=q.device)[:, None]
    mask_bh = mask.to(torch.int32).repeat_interleave(heads, 0)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j0 in range(0, seq, block_k):
        j1 = min(j0 + block_k, seq)
        kj, vj = kf[:, j0:j1], vf[:, j0:j1]
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale  # [BH, S, bk]
        if causal:
            kpos = torch.arange(j0, j1, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        s = torch.where(mask_bh[:, None, j0:j1] > 0, s, _NEG_INF)
        # the gate keeps masked entries at 0 even on fully masked rows,
        # where lse is -1e30 itself and exp(s - lse) would be 1
        p = torch.where(s > _NEG_INF / 2, torch.exp(s - lse[..., None]), 0.0)
        dv[:, j0:j1] = torch.matmul(p.transpose(1, 2), dof)
        dp = torch.matmul(dof, vj.transpose(1, 2))
        ds = p * (dp - delta) * scale
        dq = dq + torch.matmul(ds, kj)
        dk[:, j0:j1] = torch.matmul(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the kernel ------------------------------------------------------------------


def _lib():
    from ps_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_ps_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_flash_attention_fwd.argtypes = [i, i, p, p, p, p, p, p, ll, ll,
                                               ll, f, i, i, p]
        lib.ps_flash_attention_fwd.restype = i
        lib.ps_cuda_error_string.argtypes = [i]
        lib.ps_cuda_error_string.restype = ctypes.c_char_p
        lib._ps_typed = True
    return lib


def _flash_fwd_cuda(q, k, v, mask, scale: float, causal: bool, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: checks what the kernel takes, allocates ``out``
    and ``lse``, and launches once on the current stream (no sync)."""
    global LAUNCHES
    bh, seq, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention kernel takes f32 or bf16, got "
                         f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (tuple(t.shape) != (bh, seq, d) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: the kernel "
                f"takes contiguous {(bh, seq, d)} {q.dtype} on {q.device}")
    if (mask.dtype != torch.int32 or tuple(mask.shape) != (bh // heads, seq)
            or bh % heads or mask.device != q.device
            or not mask.is_contiguous()):
        raise ValueError(
            f"mask {tuple(mask.shape)} {mask.dtype} on {mask.device}: the "
            f"kernel takes contiguous ({bh // heads}, {seq}) int32 on "
            f"{q.device}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads q, k and v by TMA, which "
                         "takes 16-byte aligned tensors")
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.ps_flash_attention_fwd(
        int(q.dtype == torch.bfloat16), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), mask.data_ptr(), out.data_ptr(), lse.data_ptr(), bh,
        seq, heads, scale, int(causal), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc} ({lib.ps_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return out, lse


def _flash_fwd(q, k, v, mask, scale, causal, heads):
    """The forward on whatever device the tensors lie on: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, mask, scale, causal, heads)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA (kernel) or CPU "
                         f"(plain version) tensors, not {q.device}")
    return _flash_fwd_torch(q, k, v, mask, scale, causal, heads)


class _Flash(torch.autograd.Function):
    """[BH, S, d] flash attention with the blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, block_k, heads):
        out, lse = _flash_fwd(q, k, v, mask, scale, causal, heads)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (scale, causal, block_k, heads)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        scale, causal, block_k, heads = ctx.args
        dq, dk, dv = _blockwise_bwd(q, k, v, mask, out, lse, do, scale=scale,
                                    causal=causal, block_k=block_k,
                                    heads=heads)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: Optional[torch.Tensor] = None, causal: bool = False,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Fused flash attention. ``q/k/v``: [B, S, h, d] (the model-side
    layout of ps_tpu_torch/models/bert.py); ``mask``: optional [B, S] with
    1 = attend (BERT padding convention); ``causal`` composes with it.
    Returns [B, S, h, d].

    The sequence length must be divisible by ``block_q`` and ``block_k``,
    as in the reference (pad to 128). ``block_k`` is the backward's key
    block; the kernel tiles the keys its own way."""
    b, seq, h, d = q.shape
    if seq % block_q or seq % block_k:
        raise ValueError(
            f"seq len {seq} must be divisible by block_q={block_q} and "
            f"block_k={block_k} (pad the sequence)")
    if mask is None:
        mask = torch.ones((b, seq), dtype=torch.int32, device=q.device)
    mask = mask.to(torch.int32).contiguous()
    scale = d ** -0.5

    def pack(x):  # [B, S, h, d] -> [B*h, S, d]
        return x.transpose(1, 2).reshape(b * h, seq, d).contiguous()

    out = _Flash.apply(pack(q), pack(k), pack(v), mask, scale, causal,
                       block_k, h)
    return out.reshape(b, h, seq, d).transpose(1, 2)
