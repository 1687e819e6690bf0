"""flax's truncated lecun_normal draw, shared by the models that take it
by its inverse CDF (``mlp``, ``resnet``).

A unit normal truncated to [-2, 2] is ``√2·erfinv(u)`` for ``u`` uniform
on ``(-erf(√2), erf(√2))``. The ``erfinv_`` runs on one intra-op thread:
a process's first parallel elementwise op on the CPU now and then comes
out differently while torch's thread pool starts, and on one thread the
draw is a function of the seed alone, in every process (a server and the
replay of its run, or every rank of a group, draw the same weights).
"""

from __future__ import annotations

import math

import torch

# flax's lecun_normal draws a unit normal truncated to [-2, 2], rescaled by
# this constant (its standard deviation) so the variance is 1/fan_in
TRUNC_STD = 0.87962566103423978
_ERF_SQRT2 = math.erf(math.sqrt(2.0))  # 2·Φ(2) - 1


def serial_erfinv_(t: torch.Tensor) -> torch.Tensor:
    """``t.erfinv_()`` on one intra-op thread; the caller's thread count is
    left as it was."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return t.erfinv_()
    finally:
        torch.set_num_threads(threads)


def lecun_normal(shape, fan_in: int, generator=None) -> torch.Tensor:
    """A CPU f32 tensor of ``shape`` drawn as flax's ``lecun_normal`` draws
    it: a unit normal truncated to [-2, 2] by its inverse CDF, scaled to
    variance ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    return serial_erfinv_(torch.empty(shape).uniform_(
        -_ERF_SQRT2, _ERF_SQRT2, generator=generator
    )).mul_(math.sqrt(2.0) * std)
