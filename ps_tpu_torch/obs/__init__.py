"""Observability: the part of ``ps_tpu/obs/`` that the read path needs.

``freshness`` (version birth stamps and data ages) and ``clock``
(cross-process clock offsets) are ported. The rest of the reference's
``obs/`` (the metrics registry and its HTTP endpoint, trace spans, the
flight recorder, the straggler detector, SLOs and the time series store)
is ROADMAP Queue 1 item 6.
"""

from ps_tpu_torch.obs import clock, freshness
from ps_tpu_torch.obs.clock import ClockSync

__all__ = ["ClockSync", "clock", "freshness"]
