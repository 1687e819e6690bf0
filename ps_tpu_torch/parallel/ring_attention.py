"""Sequence (context) parallelism: ring attention and Ulysses attention.

Counterpart of ``ps_tpu/parallel/ring_attention.py``. The activations
are split along a 'seq' mesh axis: each rank holds its block of every
sequence, ``[B, T/s, H, D]`` (``KVStore.shard_batch`` cuts the tokens
that way), and these ops mix the blocks:

- :func:`ring_attention`: K/V blocks travel the ring, one neighbour hop
  a step (``ppermute`` over 'seq', ``size - 1`` hops), and the scores
  accumulate in an online softmax (the running max, denominator and
  numerator of flash attention); the causal mask is in global
  positions. Any head count.
- :func:`ulysses_attention`: two ``all_to_all``\\ s swap the split
  dimension from the sequence to the heads, each rank attends over the
  whole sequence for its ``H/s`` heads, and swaps back. Needs the heads
  to divide by the axis.

Both are plain torch ops, as the reference's are einsums and no Pallas
kernel, and both differentiate: the permute's backward is the reverse
permute, the all-to-all's the reverse swap. They take this rank's
blocks; the mesh's other axes ('data', 'model') are untouched.
"""

from __future__ import annotations

from typing import Optional

import torch

from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import SEQ_AXIS

_NEG = -1e30  # mask value: large-negative beats -inf (no NaN in exp paths)


def _block_scores(q, k, scale, causal, q_start, k_start):
    """[B, H, Tq, Tk] scores of one (q block, k block) pair, causally
    masked in GLOBAL positions when asked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_start + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_start + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG))
    return s


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, causal: bool = False, seq_axis: str = SEQ_AXIS,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over this rank's blocks ``[B, T_local, H, D]`` of
    sequences split along ``seq_axis``; returns this rank's block of the
    output. After i hops a rank holds the K/V block of index ``idx - i``,
    whose global offset positions the causal mask; the last block
    accumulates outside the loop, so no hop is paid for a block nobody
    reads. The running max is a constant of the softmax (the result does
    not depend on it), so no gradient flows through it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    size = mesh.axis_size(seq_axis)
    idx = mesh.axis_index(seq_axis)
    t_local = q.shape[1]
    perm = [(j, (j + 1) % size) for j in range(size)]
    b, _, h, _ = q.shape
    m = torch.full((b, h, t_local), _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)

    def accumulate(i, m, l, o, k_cur, v_cur):
        src = (idx - i) % size
        s = _block_scores(q, k_cur, scale, causal, idx * t_local,
                          src * t_local)
        m_new = torch.maximum(m, s.amax(dim=-1)).detach()
        alpha = torch.exp(m - m_new)  # rescale the old sums
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_cur)
        return m_new, l, o

    k_cur, v_cur = k, v
    for i in range(size - 1):
        m, l, o = accumulate(i, m, l, o, k_cur, v_cur)
        k_cur = collectives.ppermute_grad(k_cur, mesh, perm, seq_axis)
        v_cur = collectives.ppermute_grad(v_cur, mesh, perm, seq_axis)
    m, l, o = accumulate(size - 1, m, l, o, k_cur, v_cur)
    # a causal row sees at least its own key, so l > 0; guard anyway
    l = torch.clamp(l, min=1e-30)
    return o / l.transpose(1, 2)[..., None]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, causal: bool = False,
                      seq_axis: str = SEQ_AXIS,
                      scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism over this
    rank's blocks ``[B, T/s, H, D]``: swap the split dimension from the
    sequence to the heads, run full attention on the rank's ``H/s``
    heads, swap back. Raises when the heads do not divide by the axis."""
    size = mesh.axis_size(seq_axis)
    if q.shape[2] % size:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"'{seq_axis}' axis ({size}); use ring_attention otherwise")
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def seq_to_heads(x):  # [B, T/s, H, D] -> [B, T, H/s, D]
        return collectives.all_to_all_grad(x, mesh, 2, 1, seq_axis)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    s = _block_scores(qg, kg, scale, causal, 0, 0)
    og = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vg)
    # [B, T, H/s, D] -> [B, T/s, H, D]
    return collectives.all_to_all_grad(og, mesh, 1, 2, seq_axis)
