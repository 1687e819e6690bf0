"""The policy engine: the coordinator's rules from fleet signals to actions.

Counterpart of ``ps_tpu/elastic/policy.py``, the same rules, brakes and
audit. The rules run over the coordinator's fleet view (the SLO states
and straggler suspects of ``obs/``, the byte skew and the stamped hints
of :meth:`~ps_tpu_torch.elastic.coordinator.Coordinator.hints`, the
members' reports) and turn a sustained signal into a planned action:

- ``hotspot_rebalance``: a breached SLO, a straggler suspect or byte skew
  past the bound plans a rebalance toward the healthy shards (the
  suspects' keys drain off them);
- ``replica_reseed``: a member whose backup a promotion used up (or whose
  stream degraded, or a dead pair) is re-seeded onto a registered spare
  (``RESEED`` / ``REPLICA_SEED``);
- ``shard_add``: an empty standby and a breached SLO spread the keys
  over every dense shard;
- ``shard_drain``: the fleet's push rate under the floor drains the
  shards past the minimum.

The brakes: a signal must hold ``burn_windows`` ticks before its rule
fires; a rule that fired re-arms only after ``burn_windows`` quiet ticks
(below ``recover_frac`` of its threshold: hovering between the two does
neither); an action class stays cooled down for ``cooldown_s``; one
action at a time, and none while anything else rebalances; ``mode="dry"``
decides, audits and cools down as ``"on"`` does but never acts.

Every decision lands in a bounded audit ring (``COORD_POLICY``, and in
``COORD_TELEMETRY`` replies), in flight events (``policy_fire``,
``policy_acted``, ``policy_suppressed``, ``policy_cooldown``) and in
``ps_policy_actions_total{action,outcome}`` /
``ps_policy_suppressed_total{reason}``, rendered by a registry exporter.
The engine owns no thread of its own but an action's and no socket: the
coordinator ticks it from its report path and gives it the actions to
run; with ``policy="off"`` no engine exists.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, List, Optional

from ps_tpu_torch import obs

__all__ = ["PolicyEngine", "PolicyRule", "HotspotRebalance",
           "ReplicaReseed", "ShardAdd", "ShardDrain"]

#: signal levels a rule reports per tick
QUIET, ELEVATED, FIRING = 0, 1, 2


class PolicyRule:
    """One rule: a signal with three levels and a plan.

    ``signal(view)`` gives QUIET (under the recover threshold), ELEVATED
    (between recover and fire: it neither builds a streak nor re-arms)
    or FIRING. ``plan(view)`` gives the action's detail for the engine's
    executor, or None with ``self.why`` set when there is nothing to do
    (no spare, no healthy target): a suppression, never an error."""

    name = "rule"
    action = "noop"

    def __init__(self):
        self.why: Optional[str] = None

    def signal(self, view: dict) -> int:
        raise NotImplementedError

    def plan(self, view: dict) -> Optional[dict]:
        raise NotImplementedError


def _dense(view: dict) -> List[dict]:
    return [m for m in view.get("members") or []
            if m.get("kind") != "sparse"]


class HotspotRebalance(PolicyRule):
    """A breached SLO, a straggler suspect or byte skew past the bound ->
    a rebalance toward the healthy shards. Suspects are left out of the
    targets (their keys drain off them); without suspects the plan levels
    every dense shard."""

    name = "hotspot_rebalance"
    action = "rebalance"

    def __init__(self, recover_frac: float = 0.8):
        super().__init__()
        self.recover_frac = float(recover_frac)

    def _suspects(self, view: dict) -> List[int]:
        return sorted({int(h["shard"]) for h in view.get("hints") or []
                       if h.get("kind") == "straggler"
                       and h.get("shard") is not None})

    def signal(self, view: dict) -> int:
        if self._suspects(view):
            return FIRING
        level = QUIET
        for s in view.get("slo") or []:
            thr, val = s.get("threshold_ms"), s.get("value_ms")
            if s.get("breached"):
                return FIRING
            if thr and val is not None and val >= self.recover_frac * thr:
                level = ELEVATED
        sk, mx = view.get("skew"), view.get("max_skew")
        # an infinite skew is an empty dense shard: a standby for
        # shard_add, not a hotspot (firing on it would keep this rule
        # disarmed for good after its own drain)
        if sk is not None and mx and math.isfinite(sk):
            if sk > mx:
                return FIRING
            if sk > self.recover_frac * mx:
                level = max(level, ELEVATED)
        return level

    def plan(self, view: dict) -> Optional[dict]:
        self.why = None
        dense = _dense(view)
        if len(dense) < 2:
            self.why = "single_shard"
            return None
        suspects = set(self._suspects(view))
        healthy = [m["shard"] for m in dense
                   if m["shard"] not in suspects
                   and m.get("hb_state") not in ("dead", "left")]
        if suspects and healthy:
            return {"targets": sorted(healthy),
                    "suspects": sorted(suspects)}
        if not suspects:
            # no suspect: level the dense shards
            return {"targets": sorted(m["shard"] for m in dense)}
        self.why = "no_healthy_target"
        return None


class ReplicaReseed(PolicyRule):
    """A member whose backup is used up (its survivor promoted with no
    stream attached, its stream degraded, or a dead pair) -> a registered
    spare is seeded and attached as its backup. The executor marks the
    members it handled, so one death fires once."""

    name = "replica_reseed"
    action = "reseed"

    def _candidates(self, view: dict) -> List[dict]:
        out = []
        for m in _dense(view):
            if m.get("handled"):
                continue
            repl = (m.get("report") or {}).get("repl") or {}
            consumed = bool(repl.get("promoted")) and not repl.get("attached")
            degraded = bool(repl.get("degraded"))
            dead_pair = (m.get("hb_state") == "dead"
                         and "|" in str(m.get("uri", "")))
            if consumed or degraded or dead_pair:
                out.append(m)
        return out

    def signal(self, view: dict) -> int:
        return FIRING if self._candidates(view) else QUIET

    def plan(self, view: dict) -> Optional[dict]:
        self.why = None
        cands = self._candidates(view)
        if not cands:
            self.why = "no_candidate"
            return None
        spares = list(view.get("spares") or [])
        if not spares:
            self.why = "no_spare"
            return None
        m = cands[0]
        return {"shard": m["shard"], "uri": m["uri"], "spare": spares[0]}


class ShardAdd(PolicyRule):
    """An empty standby and a breached SLO -> the keys spread over every
    dense shard, the standbys among them (a live split)."""

    name = "shard_add"
    action = "shard_add"

    def __init__(self, recover_frac: float = 0.8):
        super().__init__()
        self.recover_frac = float(recover_frac)

    def _standbys(self, view: dict) -> List[int]:
        return [m["shard"] for m in _dense(view)
                if not m.get("keys") and m.get("hb_state") != "dead"]

    def signal(self, view: dict) -> int:
        if not self._standbys(view):
            return QUIET
        level = QUIET
        for s in view.get("slo") or []:
            thr, val = s.get("threshold_ms"), s.get("value_ms")
            if s.get("breached"):
                return FIRING
            if thr and val is not None and val >= self.recover_frac * thr:
                level = ELEVATED
        return level

    def plan(self, view: dict) -> Optional[dict]:
        self.why = None
        if not self._standbys(view):
            self.why = "no_standby"
            return None
        return {"targets": sorted(m["shard"] for m in _dense(view))}


class ShardDrain(PolicyRule):
    """The fleet's push rate under ``qps_floor`` with more dense shards
    than ``min_shards`` -> the shards past the minimum drained and
    removed, the emptiest (then the latest) first."""

    name = "shard_drain"
    action = "shard_remove"

    def __init__(self, qps_floor: float = 1.0, min_shards: int = 2):
        super().__init__()
        self.qps_floor = float(qps_floor)
        self.min_shards = int(min_shards)

    def signal(self, view: dict) -> int:
        dense = _dense(view)
        if len(dense) <= self.min_shards:
            return QUIET
        qps = [float((m.get("report") or {}).get("push_qps") or 0.0)
               for m in dense]
        if not any((m.get("report") or {}).get("push_qps") is not None
                   for m in dense):
            return QUIET  # no load reported: never drain blind
        total = sum(qps)
        if total < self.qps_floor:
            return FIRING
        if total < 2.0 * self.qps_floor:
            return ELEVATED
        return QUIET

    def plan(self, view: dict) -> Optional[dict]:
        self.why = None
        dense = _dense(view)
        extra = len(dense) - self.min_shards
        if extra <= 0:
            self.why = "at_floor"
            return None
        # the emptiest first, ties to the latest joiners
        order = sorted(dense, key=lambda m: (int(m.get("nbytes") or 0),
                                             -int(m["shard"])))
        drain = sorted(m["shard"] for m in order[:extra])
        return {"drain": drain}


class _RuleState:
    __slots__ = ("streak", "quiet", "armed", "fired_total")

    def __init__(self):
        self.streak = 0       # FIRING ticks in a row
        self.quiet = 0        # QUIET ticks in a row (toward re-arming)
        self.armed = True
        self.fired_total = 0


class PolicyEngine:
    """The rules, their brakes and the audit.

    Args:
      mode: ``"dry"`` (decide and record, never act) or ``"on"`` (act
        through ``actions``); ``"off"`` is no engine at all.
      actions: ``{action class: callable(detail) -> result}``, what the
        coordinator gives it (rebalance, reseed, ...); a class without
        one behaves as dry.
      cooldown_s / burn_windows: the brakes (``PS_POLICY_COOLDOWN_S`` /
        ``PS_POLICY_BURN_WINDOWS``).
      tick_s: the least time between ticks: :meth:`maybe_tick` throttles
        itself, so the caller may call it on every report.
      rules: the rules, in place of the default four.

    Ticks come from the coordinator's serve threads, an action runs on a
    thread of its own, and the audit and the counters are read by
    requests and the /metrics exporter: every shared field is under the
    one lock.
    """

    def __init__(self, mode: str = "dry",
                 actions: Optional[Dict[str, Callable]] = None,
                 cooldown_s: float = 30.0, burn_windows: int = 3,
                 tick_s: float = 0.25,
                 rules: Optional[List[PolicyRule]] = None,
                 audit: int = 256):
        if mode not in ("dry", "on"):
            raise ValueError(f"policy mode {mode!r} is not dry/on "
                             f"(off = no engine)")
        self.mode = mode
        self.cooldown_s = float(cooldown_s)
        self.burn_windows = int(burn_windows)
        self.tick_s = float(tick_s)
        self.rules: List[PolicyRule] = rules if rules is not None else [
            ReplicaReseed(), HotspotRebalance(), ShardAdd(), ShardDrain(),
        ]
        self._actions = dict(actions or {})
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._cool: Dict[str, float] = {}      # action class -> its fire t
        self._inflight: Optional[str] = None   # the rule whose action runs
        self._last_tick = 0.0
        self._audit = collections.deque(maxlen=int(audit))
        self._last_action: Optional[dict] = None
        self.actions_total: Dict[tuple, int] = {}    # (action, outcome)
        self.suppressed_total: Dict[str, int] = {}   # reason
        self.ticks = 0

    def maybe_tick(self, view: dict, now: Optional[float] = None) -> None:
        """Tick when ``tick_s`` passed since the last tick (called on every
        report, the throttle makes it a clock)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if now - self._last_tick < self.tick_s:
                return
            self._last_tick = now
        self.tick(view, now=now)

    def tick(self, view: dict, now: Optional[float] = None) -> List[dict]:
        """One evaluation: every rule's streak and quiet counts move, and
        at most one eligible action goes through the brakes. Returns this
        tick's audit entries."""
        now = time.monotonic() if now is None else float(now)
        out: List[dict] = []
        fired_this_tick = False
        for rule in self.rules:
            st = self._state[rule.name]
            try:
                lvl = rule.signal(view)
            except Exception as e:  # audited; the report path goes on
                out.append(self._note(rule, "error", now,
                                      {"error": repr(e)}))
                continue
            with self._lock:
                if lvl >= FIRING:
                    st.streak += 1
                    st.quiet = 0
                elif lvl == ELEVATED:
                    st.streak = 0
                    st.quiet = 0
                else:
                    st.streak = 0
                    st.quiet += 1
                    if not st.armed and st.quiet >= self.burn_windows:
                        st.armed = True
                eligible = st.armed and st.streak >= self.burn_windows
            if not eligible:
                continue
            entry = self._try_fire(rule, st, view, now,
                                   concurrent=fired_this_tick)
            out.append(entry)
            if entry["outcome"] in ("dry", "started"):
                fired_this_tick = True
        with self._lock:
            self.ticks += 1
        return out

    def _try_fire(self, rule: PolicyRule, st: _RuleState, view: dict,
                  now: float, concurrent: bool) -> dict:
        with self._lock:
            inflight = self._inflight
        if concurrent or inflight is not None \
                or view.get("rebalancing"):
            reason = "inflight"
            self._count_suppressed(reason)
            obs.record_event("policy_suppressed", rule=rule.name,
                             action=rule.action, reason=reason)
            return self._note(rule, "suppressed", now, {"reason": reason})
        with self._lock:
            last = self._cool.get(rule.action)
            cooling = last is not None and now - last < self.cooldown_s
            remaining = (self.cooldown_s - (now - last)) if cooling else 0.0
        if cooling:
            self._count_suppressed("cooldown")
            obs.record_event("policy_cooldown", rule=rule.name,
                            action=rule.action,
                            remaining_s=round(remaining, 3))
            return self._note(rule, "suppressed", now,
                              {"reason": "cooldown",
                               "remaining_s": round(remaining, 3)})
        try:
            detail = rule.plan(view)
        except Exception as e:
            detail, rule.why = None, f"plan_error:{e!r}"
        if detail is None:
            reason = rule.why or "no_plan"
            self._count_suppressed(reason)
            obs.record_event("policy_suppressed", rule=rule.name,
                             action=rule.action, reason=reason)
            return self._note(rule, "suppressed", now, {"reason": reason})
        # the signal held and there is a plan: the rule fires
        obs.record_event("policy_fire", rule=rule.name, action=rule.action,
                         mode=self.mode, **{k: v for k, v in detail.items()
                                            if isinstance(v, (int, float,
                                                              str))})
        fn = self._actions.get(rule.action)
        with self._lock:
            st.armed = False
            st.streak = 0
            st.fired_total += 1
            self._cool[rule.action] = now
        if self.mode == "dry" or fn is None:
            self._count_action(rule.action, "dry")
            entry = self._note(rule, "dry", now, detail)
            with self._lock:
                self._last_action = entry
            return entry
        with self._lock:
            self._inflight = rule.name
        entry = self._note(rule, "started", now, detail)
        with self._lock:
            self._last_action = entry
        threading.Thread(target=self._run_action,
                         args=(rule, fn, detail, entry),
                         daemon=True, name="ps-coord-policy").start()
        return entry

    def _run_action(self, rule: PolicyRule, fn: Callable, detail: dict,
                    entry: dict) -> None:
        t0 = time.monotonic()
        try:
            result = fn(detail)
            outcome = "ok"
        except Exception as e:
            result, outcome = {"error": repr(e)}, "failed"
        dt = time.monotonic() - t0
        with self._lock:
            self._inflight = None
            entry["outcome"] = outcome
            entry["seconds"] = round(dt, 3)
            if isinstance(result, dict):
                entry["result"] = result
        self._count_action(rule.action, outcome)
        obs.record_event("policy_acted", rule=rule.name,
                         action=rule.action, outcome=outcome,
                         seconds=round(dt, 3))

    def _note(self, rule: PolicyRule, outcome: str, now: float,
              detail: dict) -> dict:
        entry = {"t": round(time.time(), 3), "mono": round(now, 3),
                 "rule": rule.name, "action": rule.action,
                 "mode": self.mode, "outcome": outcome,
                 "detail": dict(detail)}
        with self._lock:
            self._audit.append(entry)
        return entry

    def _count_action(self, action: str, outcome: str) -> None:
        with self._lock:
            key = (action, outcome)
            self.actions_total[key] = self.actions_total.get(key, 0) + 1

    def _count_suppressed(self, reason: str) -> None:
        with self._lock:
            self.suppressed_total[reason] = \
                self.suppressed_total.get(reason, 0) + 1

    def audit(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            events = list(self._audit)
        return events if n is None else events[-int(n):]

    def last_action(self) -> Optional[dict]:
        with self._lock:
            return dict(self._last_action) if self._last_action else None

    def state(self) -> dict:
        """The COORD_POLICY reply: the mode, the brakes, each rule's
        arming, each class's cooldown left and the counters."""
        now = time.monotonic()
        with self._lock:
            rules = {}
            for r in self.rules:
                st = self._state[r.name]
                rules[r.name] = {
                    "action": r.action, "armed": st.armed,
                    "streak": st.streak, "quiet": st.quiet,
                    "fired_total": st.fired_total,
                }
            cooldown = {
                a: round(max(0.0, self.cooldown_s - (now - t)), 3)
                for a, t in self._cool.items()
                if now - t < self.cooldown_s}
            return {
                "mode": self.mode,
                "cooldown_s": self.cooldown_s,
                "burn_windows": self.burn_windows,
                "ticks": self.ticks,
                "inflight": self._inflight,
                "rules": rules,
                "cooldown": cooldown,
                "actions_total": {f"{a}:{o}": n for (a, o), n
                                  in sorted(self.actions_total.items())},
                "suppressed_total": dict(self.suppressed_total),
                "last_action": (dict(self._last_action)
                                if self._last_action else None),
            }

    def render_prometheus(self) -> str:
        """``ps_policy_actions_total{action,outcome}`` and
        ``ps_policy_suppressed_total{reason}``: labelled series, rendered
        by a registry exporter as the fleet time series are (the registry
        has no labels)."""
        with self._lock:
            acts = sorted(self.actions_total.items())
            supp = sorted(self.suppressed_total.items())
        lines = ["# TYPE ps_policy_actions_total counter"]
        for (action, outcome), n in acts:
            lines.append(f'ps_policy_actions_total{{action="{action}",'
                         f'outcome="{outcome}"}} {n}')
        lines.append("# TYPE ps_policy_suppressed_total counter")
        for reason, n in supp:
            lines.append(f'ps_policy_suppressed_total{{reason="{reason}"}}'
                         f' {n}')
        return "\n".join(lines)
