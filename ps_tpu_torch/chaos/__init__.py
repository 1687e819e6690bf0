"""Chaos fault injection: the harness that proves the autopilot closes.

A policy engine that has never met a real fault is a diagram, not a
subsystem. This package injects the fault classes the autopilot
(ps_tpu_torch/elastic/policy.py, README "Autopilot & chaos") claims to
absorb — process freezes (SIGSTOP), process death (SIGKILL), connection
blackholes, apply-path slowdowns, reconnect storms, aggregator death —
against real fleets, deterministically (``PS_CHAOS_SEED``), and measures
what the fleet does about each one WITHOUT an operator in the loop.

Two surfaces:

- :class:`ChaosHook` — a per-service dispatch interceptor (every
  ``VanService`` carries a ``chaos`` slot checked first in dispatch).
  Faults that live at the wire (blackhole refusals) answer with the
  same typed, retry-able frames a genuinely broken shard would emit,
  so drills exercise the worker's REAL park/retry machinery.
- :class:`ChaosInjector` — the scheduler: seeded fault plans, signal
  wrappers for subprocess targets, the noisy-neighbor lock grinder,
  and the injection ledger ``chip_smoke.py`` phase 26 reports from.

``python -m ps_tpu_torch.chaos.member shard|primary`` is the subprocess
fleet member the SIGSTOP and SIGKILL drills aim at.

Nothing here runs unless a harness wires it; the serving path's only
cost is one attribute read per dispatched frame.
"""

from ps_tpu_torch.chaos.inject import ChaosHook, ChaosInjector

__all__ = ["ChaosHook", "ChaosInjector"]
