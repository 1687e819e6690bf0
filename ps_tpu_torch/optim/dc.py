"""Delay compensation for the async (stale-gradient) parameter server.

Counterpart of ``ps_tpu/optim/dc.py``: the DC-ASGD rule (Zheng et al.,
2017) with a diagonal Gauss-Newton approximation of the Hessian,

    g_tilde = g + lambda * g ⊙ g ⊙ (w_now - w_stale)

where ``w_stale`` is the parameter value the worker computed ``g`` against
and ``w_now`` the server's current value. The expression is evaluated in
the reference's order, ``g + ((lambda * g) * g) * (w_now - w_stale)``.
"""

from __future__ import annotations

from typing import Dict

import torch


def delay_compensate(grads: Dict[str, torch.Tensor],
                     params_now: Dict[str, torch.Tensor],
                     params_stale: Dict[str, torch.Tensor],
                     dc_lambda: float) -> Dict[str, torch.Tensor]:
    """The DC-ASGD correction, key by key over ``{key: tensor}`` dicts.

    Args:
      grads: gradients computed at the stale parameters.
      params_now: the server's current parameters.
      params_stale: the parameters the worker used (the same keys).
      dc_lambda: compensation strength (0 disables it).

    Returns:
      The compensated gradients, as new tensors.
    """
    return {k: g + dc_lambda * g * g * (params_now[k] - params_stale[k])
            for k, g in grads.items()}
