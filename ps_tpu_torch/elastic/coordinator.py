"""The coordinator: the authoritative shard table and the rebalances.

Counterpart of ``ps_tpu/elastic/coordinator.py``, the same protocol. It
holds no device and never touches CUDA; it is never on the data path:
a dead coordinator stops rebalances and joins, not traffic.

- Membership: servers register at start (``COORD_HELLO``: their URI and
  the keys they booted with); the coordinator keeps the
  :class:`~ps_tpu_torch.elastic.table.ShardTable` and serves it to
  joining workers (``COORD_TABLE``). Liveness is the heartbeat monitor of
  ``control/``: every member beats this process's
  :class:`~ps_tpu_torch.control.heartbeat.HeartbeatServer`, and the
  membership view shows each one's state and last-beat age.
- Load: members report keys, bytes and rates (``COORD_REPORT``); the
  reports feed the skew check.
- Rebalance: on a request (``COORD_REBALANCE`` or :meth:`Coordinator.
  rebalance`), or by itself past ``max_skew`` with ``auto=True``, it
  plans moves (:func:`~ps_tpu_torch.elastic.table.plan_moves`) and drives
  each donor's live move (``MIGRATE_OUT``), one table epoch per move.
- Fleet telemetry: reports carry delta-encoded snapshots, rebuilt a
  member at a time into a :class:`~ps_tpu_torch.obs.tsdb.FleetTSDB`;
  the fleet's quantiles come from merged raw buckets, served on
  /metrics, on ``COORD_TELEMETRY`` (``ps_top --fleet``, ``ps_doctor``),
  and read on the report cadence by the straggler detector and the SLO
  rules (``slo_rules``).
- The policy engine (``policy="dry"``/``"on"``, ``PS_POLICY``, off by
  default; ``elastic/policy.py``) turns sustained signals into
  rebalances, re-seeds and shard adds and drains, audited on
  ``COORD_POLICY``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ps_tpu_torch import obs
from ps_tpu_torch.backends.van_service import VanService
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.control.heartbeat import HeartbeatServer
from ps_tpu_torch.elastic.table import ShardTable, plan_moves, skew

__all__ = ["Coordinator"]


class _Member:
    """One registered server: the URI workers dial, each key's bytes, the
    node id it beats the monitor with, and its last load report."""

    def __init__(self, uri: str, node: int, kind: str):
        self.uri = uri
        self.node = node
        self.kind = kind              # "dense" | "sparse"
        self.key_bytes: Dict[str, int] = {}
        self.report: dict = {}
        self.report_t: Optional[float] = None
        # when key_bytes was last refreshed (registration or report), on
        # this process's clock: the byte-skew hint carries it
        self.bytes_t: float = time.monotonic()

    @property
    def nbytes(self) -> int:
        return sum(self.key_bytes.values())


class Coordinator(VanService):
    """Serve the shard table and drive rebalances over the tensor van.

    Args:
      port/bind: the endpoint (0: an ephemeral port; loopback by default,
        as every unauthenticated endpoint here).
      hb_timeout_ms: the liveness view's death horizon.
      auto: rebalance by itself when the dense shards' byte skew passes
        ``max_skew`` (``Config.rebalance_auto``, ``PS_REBALANCE_AUTO``;
        off by default).
      max_skew: the largest byte load over the smallest tolerated
        (``Config.rebalance_max_skew``).
      report_ms: the load-report cadence given to members
        (``Config.rebalance_report_ms``).
      telemetry: land the members' delta-encoded snapshots and run the
        straggler and SLO signals (``Config.telemetry``, ``PS_TELEMETRY``;
        None reads the env, on by default); off keeps no fleet state.
      telemetry_window_s / telemetry_ring: the default query window and
        the samples kept a (member, metric).
      straggler_z: the straggler score's threshold.
      slo_rules: ``;``-separated rules (``PS_SLO_RULES``), such as
        ``"push p99 < 10ms over 30s"``.
      policy: ``"off"`` (default: no engine, the coordinator behaves as
        one without it), ``"dry"`` (decide and audit, never act) or
        ``"on"`` (``Config.policy``, ``PS_POLICY``).
      policy_cooldown_s / policy_burn_windows: the policy engine's brakes.
    """

    def __init__(self, port: int = 0, bind: str = "127.0.0.1",
                 hb_timeout_ms: int = 2000, auto: bool = False,
                 max_skew: float = 2.0, report_ms: int = 1000,
                 telemetry: Optional[bool] = None,
                 telemetry_window_s: Optional[float] = None,
                 telemetry_ring: Optional[int] = None,
                 straggler_z: Optional[float] = None,
                 slo_rules: Optional[str] = None,
                 policy: Optional[str] = None,
                 policy_cooldown_s: Optional[float] = None,
                 policy_burn_windows: Optional[int] = None):
        import os

        from ps_tpu_torch.config import Config, env_flag
        from ps_tpu_torch.obs.slo import SloEvaluator, parse_rules
        from ps_tpu_torch.obs.straggler import StragglerDetector
        from ps_tpu_torch.obs.tsdb import FleetTSDB

        self._tlock = threading.Lock()
        self._table = ShardTable(0, [], {})
        self._members: List[_Member] = []   # index == shard index
        # two-level aggregation: one aggregator URI a host, the grouping
        # workers of that host find in the table reply (no entry: flat).
        # Outside the shard table: an aggregator owns no keys and never
        # takes part in a rebalance
        self._aggregators: Dict[str, str] = {}
        self._next_node = 1
        self._rebalancing: Optional[dict] = None  # the move in progress
        self._draining = False
        self._dead_seen: set = set()
        self.auto = bool(auto)
        self.max_skew = float(max_skew)
        self.report_ms = int(report_ms)
        self.moves_done = 0
        self.hb = HeartbeatServer(port=0, timeout_ms=hb_timeout_ms,
                                  bind=bind)
        # fleet telemetry: the time series, a delta decoder a reporting
        # uri, and the straggler and SLO signals on the report cadence. A
        # knob left None reads its PS_* variable as Config.from_env does
        # (the same strict parse: a bad value raises here), its default
        # the Config field's
        fields = Config.__dataclass_fields__

        def _env(name: str, field: str, cast):
            v = os.environ.get(name)
            if v is None or not v.strip():
                return fields[field].default
            return cast(v)

        self.telemetry = (env_flag("PS_TELEMETRY",
                                   fields["telemetry"].default)
                          if telemetry is None else bool(telemetry))
        if telemetry_window_s is None:
            telemetry_window_s = _env("PS_TELEMETRY_WINDOW_S",
                                      "telemetry_window_s", float)
        if telemetry_ring is None:
            telemetry_ring = _env("PS_TELEMETRY_RING",
                                  "telemetry_ring", int)
        if straggler_z is None:
            straggler_z = _env("PS_TELEMETRY_STRAGGLER_Z",
                               "telemetry_straggler_z", float)
        if slo_rules is None:
            from ps_tpu_torch.config import env_str

            # the rules themselves are parsed (loudly) just below
            slo_rules = env_str("PS_SLO_RULES")
        self.tsdb = FleetTSDB(window_s=float(telemetry_window_s),
                              ring=int(telemetry_ring))
        self._decoders: Dict[str, object] = {}
        self.straggler = StragglerDetector(self.tsdb,
                                           z=float(straggler_z))
        self.slo = SloEvaluator(self.tsdb, parse_rules(slo_rules))
        self._eval_every_s = max(min(1.0, self.tsdb.window_s / 4.0), 0.05)
        self._last_eval = 0.0
        self._slo_states: list = []
        reg = obs.default_registry()
        if self.telemetry:
            # the fleet series join this process's /metrics (the registry
            # holds them weakly; stop() removes them)
            reg.add_exporter(self.tsdb.render_prometheus)
        self._m_moves = reg.counter("ps_rebalance_moves_total",
                                    "committed key-range moves")
        self._m_keys = reg.counter("ps_rebalance_keys_total",
                                   "keys moved by committed rebalances")
        self._m_bytes = reg.counter("ps_rebalance_bytes_total",
                                    "row bytes streamed by rebalances")
        self._m_aborts = reg.counter("ps_rebalance_aborts_total",
                                     "aborted key-range moves")
        # the policy engine (elastic/policy.py): "off", the default, makes
        # none; "dry" decides and audits without acting
        mode = (_env("PS_POLICY", "policy",
                     lambda v: v.strip().lower() or "off")
                if policy is None else str(policy).strip().lower())
        if mode not in ("off", "dry", "on"):
            raise ValueError(f"policy={mode!r} is not off/dry/on")
        if policy_cooldown_s is None:
            policy_cooldown_s = _env("PS_POLICY_COOLDOWN_S",
                                     "policy_cooldown_s", float)
        if policy_burn_windows is None:
            policy_burn_windows = _env("PS_POLICY_BURN_WINDOWS",
                                       "policy_burn_windows", int)
        self._spares: List[str] = []       # registered re-seed targets
        self._reseed_handled: set = set()  # member uris re-seeded already
        self.policy = None
        if mode != "off":
            from ps_tpu_torch.elastic.policy import PolicyEngine

            self.policy = PolicyEngine(
                mode=mode,
                actions={"rebalance": self._act_rebalance,
                         "reseed": self._act_reseed,
                         "shard_add": self._act_shard_add,
                         "shard_remove": self._act_shard_remove},
                cooldown_s=float(policy_cooldown_s),
                burn_windows=int(policy_burn_windows),
                tick_s=self._eval_every_s)
            # its labelled series join /metrics as the fleet's do
            reg.add_exporter(self.policy.render_prometheus)
        # one coordinator a cluster: taking the table is its election,
        # recorded so a later incident's flight log names the owner
        obs.record_event("coord_elect", hb_port=self.hb.port)
        super().__init__(port=port, bind=bind)
        self.role = "coordinator"  # after super(), for ps_top

    # -- dispatch --------------------------------------------------------------

    def _dispatch_traced(self, kind: int, worker: int, tensors,
                         extra) -> bytes:
        # no primary/backup gate: its own protocol, and REPLICA_STATE for
        # clock probes and ps_top
        if kind == tv.REPLICA_STATE:
            return tv.encode(tv.OK, worker, None, extra=self.replica_state())
        return self._handle(kind, worker, tensors, extra)

    def _handle(self, kind: int, worker: int, tensors, extra) -> bytes:
        if kind == tv.COORD_HELLO:
            return self._hello(worker, extra)
        elif kind == tv.COORD_TABLE:
            if (extra or {}).get("lean"):
                # the table alone (what every worker polls at a join or
                # a re-route) and the hosts' aggregators
                with self._tlock:
                    wire = self._table.to_wire()
                    aggs = dict(self._aggregators)
                return tv.encode(tv.OK, worker, None,
                                 extra={"table": wire,
                                        "aggregators": aggs})
            return tv.encode(tv.OK, worker, None, extra=self._table_reply())
        elif kind == tv.COORD_REPORT:
            return self._report(worker, extra)
        elif kind == tv.COORD_REBALANCE:
            if self._draining:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "coordinator is draining; rebalance refused"})
            try:
                out = self.rebalance(
                    moves=extra.get("moves"),
                    targets=extra.get("targets"),
                    drain=extra.get("drain"))
            except Exception as e:  # a refusal: a move that did not
                # commit left the table as it was
                return tv.encode(tv.ERR, worker, None,
                                 extra={"error": repr(e)})
            return tv.encode(tv.OK, worker, None, extra=out)
        elif kind == tv.COORD_TELEMETRY:
            return self._telemetry_reply(worker, extra or {})
        elif kind == tv.COORD_POLICY:
            # the policy engine's state and its last decisions
            if self.policy is None:
                return tv.encode(tv.OK, worker, None,
                                 extra={"mode": "off"})
            out = self.policy.state()
            out["actions"] = self.policy.audit(
                int((extra or {}).get("n", 32)))
            out["spares"] = list(self._spares)
            return tv.encode(tv.OK, worker, None, extra=out)
        elif kind == tv.STATS:
            out = {"role": self.role, "members": self._members_view(),
                   "table": self._table.to_wire(),
                   "moves_done": self.moves_done,
                   "hints": self.hints(), "slo": list(self._slo_states)}
            if self.policy is not None:
                out["policy"] = self.policy.state()
            return tv.encode(tv.OK, worker, None, extra=out)
        return tv.encode(tv.ERR, worker, None,
                         extra={"error": f"bad kind {kind}"})

    def _set_draining(self) -> None:
        self._draining = True

    def stop(self, grace: float = 10.0) -> None:
        super().stop(grace=grace)
        self.hb.close()
        # a stopped coordinator's series leave the scrape now, not at a
        # later garbage collection
        obs.default_registry().remove_exporter(self.tsdb.render_prometheus)
        if self.policy is not None:
            obs.default_registry().remove_exporter(
                self.policy.render_prometheus)

    def kill(self) -> None:
        super().kill()
        self.hb.close()
        obs.default_registry().remove_exporter(self.tsdb.render_prometheus)
        if self.policy is not None:
            obs.default_registry().remove_exporter(
                self.policy.render_prometheus)

    # -- membership ------------------------------------------------------------

    def _hello(self, worker: int, extra: dict) -> bytes:
        role = str(extra.get("role", "worker"))
        if role == "aggregator":
            # a host's aggregator: the last registration of a host wins
            # (a restarted one comes back on another port)
            host = str(extra.get("host") or "")
            uri = str(extra.get("uri") or "")
            if not host or not uri:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "aggregator registration needs host and uri"})
            with self._tlock:
                self._aggregators[host] = uri
            obs.record_event("coord_aggregator", host=host, uri=uri)
            logging.getLogger(__name__).info(
                "aggregator for host %s registered at %s", host, uri)
            return tv.encode(tv.OK, worker, None, extra=self._table_reply())
        if role == "spare":
            # an empty backup offered as a re-seed target: no table slot
            # until a used-up replica set is seeded onto it; once a uri
            uri = str(extra.get("uri") or "")
            if not uri:
                return tv.encode(tv.ERR, worker, None, extra={
                    "error": "spare registration needs uri"})
            with self._tlock:
                if uri not in self._spares:
                    self._spares.append(uri)
            obs.record_event("coord_spare", uri=uri)
            logging.getLogger(__name__).info(
                "spare registered at %s", uri)
            return tv.encode(tv.OK, worker, None,
                             extra={"spares": len(self._spares)})
        if role != "server":
            # a worker only reads the table
            return tv.encode(tv.OK, worker, None, extra=self._table_reply())
        uri = str(extra["uri"])
        key_bytes = {str(k): int(v)
                     for k, v in (extra.get("key_bytes") or {}).items()}
        # the monitor's view first: it has its own mutex
        try:
            gone = set(self.hb.dead()) | set(self.hb.left())
        except Exception:
            gone = set()
        with self._tlock:
            member = next((m for m in self._members if m.uri == uri), None)
            if member is None:
                # a member that boots with keys extends the table; keys
                # assigned already are refused (ownership is unique) but
                # for a replacement bringing a dead or departed member's
                # exact key set, which takes that slot over in place
                claimed = [k for k in key_bytes if k in self._table.assign]
                slot = None
                if claimed:
                    for i, m in enumerate(self._members):
                        if (m.node in gone and key_bytes
                                and set(self._table.keys_of(i))
                                == set(key_bytes)):
                            slot = i
                            break
                    if slot is None:
                        return tv.encode(tv.ERR, worker, None, extra={
                            "error": (f"keys already assigned elsewhere: "
                                      f"{sorted(claimed)[:3]} — a joining "
                                      f"server must boot empty (standby), "
                                      f"with unclaimed keys, or as a "
                                      f"replacement matching a dead/left "
                                      f"member's exact key set"),
                        })
                member = _Member(uri, self._next_node,
                                 str(extra.get("kind", "dense")))
                self._next_node += 1
                member.key_bytes = key_bytes
                if slot is not None:
                    old = self._members[slot]
                    self._members[slot] = member
                    shards = list(self._table.shards)
                    shards[slot] = uri
                    self._table = ShardTable(self._table.epoch + 1,
                                             shards, self._table.assign)
                    self._dead_seen.discard(old.node)
                    obs.record_event("coord_takeover", shard=slot,
                                     uri=uri, old_uri=old.uri,
                                     epoch=self._table.epoch)
                else:
                    self._members.append(member)
                    shard = len(self._members) - 1
                    assign = dict(self._table.assign)
                    assign.update({k: shard for k in key_bytes})
                    self._table = ShardTable(
                        self._table.epoch + 1,
                        self._table.shards + [uri], assign)
            else:
                shard = self._members.index(member)
                if key_bytes and (set(key_bytes)
                                  != set(self._table.keys_of(shard))):
                    return tv.encode(tv.ERR, worker, None, extra={
                        "error": (f"re-registration of {uri} does not "
                                  f"match shard {shard}'s assignment — "
                                  f"a member's key set only changes "
                                  f"through rebalance moves"),
                    })
                if member.node in gone:
                    # a process restarted on the same uri: its old node id
                    # stays 'left' or 'dead' at the monitor for good, so
                    # the new process gets a new one (else a live shard
                    # would read as left, its slot open to a takeover)
                    self._dead_seen.discard(member.node)
                    member.node = self._next_node
                    self._next_node += 1
                member.key_bytes = key_bytes or member.key_bytes
                if key_bytes:
                    member.bytes_t = time.monotonic()
            node = member.node
            table = self._table
        logging.getLogger(__name__).info(
            "member %s joined as shard %d (node %d, %d key(s), epoch %d)",
            uri, table.shards.index(uri), node, len(key_bytes), table.epoch,
        )
        return tv.encode(tv.OK, worker, None, extra={
            "table": table.to_wire(), "hb_port": self.hb.port,
            "node": node, "report_ms": self.report_ms,
        })

    def _report(self, worker: int, extra: dict) -> bytes:
        uri = str(extra.get("uri"))
        reply: dict = {}
        if self.telemetry and extra.get("telemetry") is not None:
            # telemetry of any reporter, member or not (a worker's
            # histograms are the breakdown's worker phases); an unknown
            # uri stays out of the membership views
            from ps_tpu_torch.obs.collector import DeltaDecoder

            dec = self._decoders.setdefault(uri, DeltaDecoder())
            cum = dec.ingest(extra["telemetry"])
            if cum is None:
                reply["telemetry_resync"] = True
            else:
                self.tsdb.ingest(uri, cum)
        with self._tlock:
            member = next((m for m in self._members if m.uri == uri), None)
            if member is not None:
                member.report = {
                    "keys": extra.get("keys"),
                    "nbytes": extra.get("nbytes"),
                    "push_qps": extra.get("push_qps"),
                    "pull_qps": extra.get("pull_qps"),
                    # replication health (the re-seed rule reads it)
                    "repl": extra.get("repl"),
                }
                member.report_t = time.monotonic()
                member.bytes_t = member.report_t
                if extra.get("nbytes") is not None:
                    total = int(extra["nbytes"])
                    if member.key_bytes and total:
                        # scale each key's size to the reported total
                        old = sum(member.key_bytes.values()) or 1
                        member.key_bytes = {
                            k: max(1, v * total // old)
                            for k, v in member.key_bytes.items()}
        self._note_dead_members()
        if self.telemetry:
            self._maybe_evaluate()
        if self.policy is not None:
            # the policy engine ticks on the reports (throttled); a
            # failing tick never fails a report
            try:
                self.policy.maybe_tick(self._policy_view())
            except Exception:
                logging.getLogger(__name__).warning(
                    "policy tick failed", exc_info=True)
        if self.auto and member is not None:
            self._maybe_auto_rebalance()
        reply["epoch"] = self._table.epoch
        return tv.encode(tv.OK, worker, None, extra=reply)

    def _members_view(self) -> List[dict]:
        """The membership rows ps_top renders: each member's heartbeat
        state and last-beat age beside its report."""
        hb = self.hb.state()  # {node: {"state", "age_ms", "seq"}}
        with self._tlock:
            out = []
            for i, m in enumerate(self._members):
                live = hb.get(m.node) or {}
                out.append({
                    "shard": i, "uri": m.uri, "kind": m.kind,
                    "node": m.node,
                    "hb_state": live.get("state", "unseen"),
                    "hb_age_ms": live.get("age_ms"),
                    "keys": len(m.key_bytes), "nbytes": m.nbytes,
                    "report": m.report,
                })
            return out

    def _table_reply(self) -> dict:
        with self._tlock:
            mig = dict(self._rebalancing) if self._rebalancing else None
            table = self._table
            aggs = dict(self._aggregators)
        # the members outside _tlock: _members_view takes it (and polls
        # the monitor)
        out = {"table": table.to_wire(),
               "members": self._members_view(),
               "migration": mig,
               "aggregators": aggs,
               "hints": self.hints()}
        if self.policy is not None:
            # the policy line of ps_top --coord
            out["policy"] = self.policy.state()
            with self._tlock:
                out["spares"] = list(self._spares)
        return out

    # -- fleet telemetry -------------------------------------------------------

    def _maybe_evaluate(self) -> None:
        """The straggler and SLO passes, at most once a quarter window
        (reports arrive from every member on every cadence)."""
        now = time.monotonic()
        with self._tlock:
            if now - self._last_eval < self._eval_every_s:
                return
            self._last_eval = now
            shards = {m.uri: i for i, m in enumerate(self._members)}
        try:
            self.straggler.evaluate(shards)
            self._slo_states = self.slo.evaluate()
            # reporters that came and went (restarted workers) must not
            # grow the series and decoders without bound
            for uri in self.tsdb.prune_stale():
                self._decoders.pop(uri, None)
        except Exception:
            logging.getLogger(__name__).warning(
                "telemetry signal evaluation failed", exc_info=True)

    def _telemetry_reply(self, worker: int, extra: dict) -> bytes:
        """COORD_TELEMETRY, the fleet view of ps_top --fleet and
        ps_doctor: the window's fleet quantiles from merged raw buckets,
        each member's window summaries, the step breakdown, straggler
        suspects, SLO states and rebalance hints."""
        from ps_tpu_torch.obs.breakdown import breakdown

        if not self.telemetry:
            return tv.encode(tv.ERR, worker, None, extra={
                "error": "fleet telemetry is off at this coordinator "
                         "(telemetry=False / PS_TELEMETRY=0)"})
        w = extra.get("window_s")
        w = None if w is None else float(w)
        fleet: Dict[str, dict] = {}
        counters: Dict[str, dict] = {}
        per_member: Dict[str, dict] = {}
        for metric in self.tsdb.metrics():
            win = self.tsdb.fleet_window(metric, w)
            if not win:
                continue
            if win["k"] == "hist" and "summary" in win:
                fleet[metric] = win["summary"]
            elif win["k"] == "counter":
                counters[metric] = {"delta": win["delta"]}
            # each member's window came with the fleet's
            for m, mw in win["per_member"].items():
                if mw.get("summary"):
                    per_member.setdefault(m, {})[metric] = mw["summary"]
        with self._tlock:
            shards = {m.uri: i for i, m in enumerate(self._members)}
        out = {
            "window_s": self.tsdb.window_s if w is None else w,
            "members": self.tsdb.members(),
            "shards": shards,
            "fleet": fleet,
            "counters": counters,
            "per_member": per_member,
            "breakdown": breakdown(lambda name: fleet.get(name)),
            "stragglers": self.straggler.suspects(),
            "slo": list(self._slo_states),
            "hints": self.hints(),
        }
        if self.policy is not None:
            # the policy engine's recent decisions and brakes
            p = self.policy.state()
            p["actions"] = self.policy.audit(16)
            out["policy"] = p
        return tv.encode(tv.OK, worker, None, extra=out)

    def hints(self, now: Optional[float] = None) -> List[dict]:
        """The rebalance hints: straggler suspects (slow members that
        bytes cannot show) beside the byte skew the automatic rebalance
        fires on.

        Each hint is stamped with when its inputs were computed (``t``,
        this process's monotonic clock) and the window they cover
        (``window_s``), and leaves the reply once the stamp is three
        windows old, so a reader tells a live hint from one whose
        telemetry stopped. ``now`` gives the clock."""
        now = time.monotonic() if now is None else float(now)
        out: List[dict] = []
        if self.telemetry:
            t = self._last_eval
            w = self.tsdb.window_s
            if now - t <= 3.0 * w:  # the time series' staleness rule
                for h in self.straggler.hints():
                    h["t"] = round(t, 3)
                    h["window_s"] = w
                    out.append(h)
        with self._tlock:
            dense = {i: m.nbytes for i, m in enumerate(self._members)
                     if m.kind != "sparse"}
            bytes_t = max((m.bytes_t for m in self._members
                           if m.kind != "sparse"), default=now)
        # the byte view's window: reports refresh it each report_ms, but
        # a fleet that only registered must keep its hint a while
        skew_w = max(3.0 * self.report_ms / 1000.0, self.tsdb.window_s)
        if len(dense) >= 2 and now - bytes_t <= 3.0 * skew_w:
            s = skew(dense)
            if s > self.max_skew:
                out.append({
                    "kind": "byte_skew", "skew": round(s, 2),
                    "max_skew": self.max_skew,
                    "t": round(bytes_t, 3), "window_s": skew_w,
                    "action": (f"byte skew {s:.2f} exceeds "
                               f"rebalance_max_skew={self.max_skew} — "
                               f"a rebalance would level the shards"
                               + ("" if self.auto else
                                  " (rebalance_auto is off: trigger one "
                                  "explicitly)")),
                })
        return out

    def _note_dead_members(self) -> None:
        """Record each member's death once, on report traffic (there is no
        poll thread). A dead member is its replica set's failover, never
        a move's donor: nothing streams off a dead process."""
        try:
            dead = set(self.hb.dead())
        except Exception:
            return
        with self._tlock:
            members = list(self._members)
        for i, m in enumerate(members):
            if m.node in dead and m.node not in self._dead_seen:
                self._dead_seen.add(m.node)
                obs.record_event("coord_member_dead", shard=i, uri=m.uri)
                logging.getLogger(__name__).warning(
                    "member %s (shard %d) stopped heartbeating", m.uri, i)

    # -- autopilot -------------------------------------------------------------

    def _policy_view(self) -> dict:
        """What the policy rules read, plain data: the members with their
        liveness and reports, the stamped hints, the SLO states, the dense
        byte skew, the spares and whether a move is running."""
        members = self._members_view()
        with self._tlock:
            spares = list(self._spares)
            rebal = self._rebalancing is not None
            handled = set(self._reseed_handled)
        for m in members:
            m["handled"] = m["uri"] in handled
        dense = {m["shard"]: m["nbytes"] for m in members
                 if m["kind"] != "sparse"}
        return {
            "now": time.monotonic(),
            "members": members,
            "spares": spares,
            "rebalancing": rebal,
            "hints": self.hints(),
            "slo": list(self._slo_states),
            "skew": skew(dense) if len(dense) >= 2 else None,
            "max_skew": self.max_skew,
        }

    # the policy engine's actions: the operator's own calls
    def _act_rebalance(self, detail: dict) -> dict:
        return self.rebalance(targets=detail.get("targets"))

    def _act_shard_add(self, detail: dict) -> dict:
        return self.rebalance(targets=detail.get("targets"))

    def _act_shard_remove(self, detail: dict) -> dict:
        return self.rebalance(drain=detail.get("drain"))

    def _act_reseed(self, detail: dict) -> dict:
        """Re-seed a used-up replica set onto a registered spare: find the
        pair's serving primary, have it ship its whole state point
        (``RESEED``, then ``REPLICA_SEED``), and publish the healed pair's
        URI at the next table epoch."""
        from ps_tpu_torch.backends.common import parse_replica_uri

        shard = int(detail["shard"])
        uri = str(detail["uri"])
        spare = str(detail["spare"])
        with self._tlock:
            if spare in self._spares:
                self._spares.remove(spare)
        _, sets = parse_replica_uri(uri)
        primary = None
        for host, port in sets[0]:
            try:
                ch = tv.Channel.connect(host, port)
                try:
                    _, _, _, st = tv.decode(ch.request(tv.encode(
                        tv.REPLICA_STATE, 0, None, extra={})))
                finally:
                    ch.close()
                if st.get("role") == "primary":
                    primary = (host, port)
                    break
            except (tv.VanError, OSError):
                continue
        if primary is None:
            with self._tlock:
                self._spares.insert(0, spare)  # not used
            raise RuntimeError(
                f"no live primary found in replica set {uri!r}")
        host, port = primary
        ch = tv.Channel.connect(host, port)
        try:
            kind, _, _, out = tv.decode(ch.request(tv.encode(
                tv.RESEED, 0, None, extra={"spare": spare})))
        finally:
            ch.close()
        if kind != tv.OK:
            with self._tlock:
                self._spares.insert(0, spare)
            raise RuntimeError(f"primary {host}:{port} refused re-seed: "
                               f"{out.get('error')}")
        new_uri = f"{host}:{port}|{spare}"
        with self._tlock:
            if shard < len(self._members) \
                    and self._members[shard].uri == uri:
                self._members[shard].uri = new_uri
                shards = list(self._table.shards)
                shards[shard] = new_uri
                self._table = ShardTable(self._table.epoch + 1,
                                         shards, self._table.assign)
            # both spellings are handled: the healed pair keeps the dead
            # primary's node, and the rule must not fire on it again
            self._reseed_handled.add(uri)
            self._reseed_handled.add(new_uri)
            epoch = self._table.epoch
        obs.record_event("coord_reseed", shard=shard, uri=new_uri,
                         old_uri=uri, spare=spare, epoch=epoch,
                         bytes=out.get("bytes"), keys=out.get("keys"))
        logging.getLogger(__name__).info(
            "re-seeded shard %d replica set onto %s (epoch %d)",
            shard, spare, epoch)
        return {"epoch": epoch, "uri": new_uri,
                "bytes": out.get("bytes"), "keys": out.get("keys")}

    # -- rebalance -------------------------------------------------------------

    def table(self) -> ShardTable:
        with self._tlock:
            return self._table

    def loads(self) -> Dict[int, int]:
        with self._tlock:
            return {i: m.nbytes for i, m in enumerate(self._members)}

    def _maybe_auto_rebalance(self) -> None:
        with self._tlock:
            if self._rebalancing is not None:
                return
            # the dense shards only: a sparse range never moves live
            dense = {i: m.nbytes for i, m in enumerate(self._members)
                     if m.kind != "sparse"}
            if len(dense) < 2:
                return
            if skew(dense) <= self.max_skew:
                return
        t = threading.Thread(target=self._auto_rebalance_safe,
                             daemon=True, name="ps-coord-rebalance")
        t.start()

    def _auto_rebalance_safe(self) -> None:
        try:
            self.rebalance()
        except Exception:
            logging.getLogger(__name__).warning(
                "auto rebalance failed", exc_info=True)

    def rebalance(self, moves=None, targets=None, drain=None) -> dict:
        """Plan and run one rebalance; returns its summary.

        ``moves``: ``[[donor, recipient, [keys]], ...]``; ``targets``: the
        shards that serve afterwards (every dense member not drained, by
        default); ``drain``: shards to empty and take out of the table.
        Each move commits one table epoch; a failed move aborts (its donor
        keeps its keys, the table stays) and ends the plan.
        """
        with self._tlock:
            if self._rebalancing is not None:
                raise RuntimeError("a rebalance is already in flight")
            table = self._table
            key_bytes: Dict[str, int] = {}
            for m in self._members:
                key_bytes.update(m.key_bytes)
            sparse = {i for i, m in enumerate(self._members)
                      if m.kind == "sparse"}
            if moves is None:
                drain_set = set(int(d) for d in (drain or []))
                if drain_set & sparse:
                    raise RuntimeError(
                        f"shard(s) {sorted(drain_set & sparse)} are "
                        f"sparse members — their row ranges do not "
                        f"live-migrate, so they leave by stopping "
                        f"(goodbye), not by a key drain")
                if targets is None:
                    targets = [i for i in range(len(self._members))
                               if i not in drain_set and i not in sparse]
                # the dense members only: a coordinator shared with a
                # sparse fleet holds range keys that never move
                plan_assign = {k: s for k, s in table.assign.items()
                               if s not in sparse}
                moves = plan_moves(
                    {k: v for k, v in key_bytes.items()
                     if k in plan_assign},
                    plan_assign, [int(t) for t in targets])
            moves = [(int(d), int(r), [str(k) for k in ks])
                     for d, r, ks in moves if ks]
            for d, r, _ks in moves:
                for side, name in ((d, "donor"), (r, "recipient")):
                    if (0 <= side < len(self._members)
                            and self._members[side].kind == "sparse"):
                        raise RuntimeError(
                            f"{name} shard {side} is a sparse member — "
                            f"row ranges do not live-migrate (a range "
                            f"move would resize serving tables); scale "
                            f"sparse fleets by checkpoint-restart")
            self._rebalancing = {"moves": len(moves), "done": 0,
                                 "keys": sum(len(ks) for _, _, ks in moves)}
        executed, bytes_moved = [], 0
        try:
            for d, r, keys in moves:
                bytes_moved += self._one_move(d, r, keys, key_bytes)
                executed.append([d, r, len(keys)])
                with self._tlock:
                    self._rebalancing["done"] += 1
            if drain:
                self._drop_members(sorted(set(int(x) for x in drain)))
        finally:
            with self._tlock:
                self._rebalancing = None
        with self._tlock:
            epoch = self._table.epoch
        return {"epoch": epoch, "moves": executed,
                "moved_bytes": bytes_moved}

    def _one_move(self, donor: int, recipient: int, keys: List[str],
                  key_bytes: Dict[str, int]) -> int:
        """One move, donor to recipient: MIGRATE_OUT to the donor, the new
        table at the next epoch once it committed. Returns the row bytes
        streamed."""
        from ps_tpu_torch.backends.common import parse_replica_uri

        with self._tlock:
            table = self._table
            if donor == recipient:
                raise ValueError("donor and recipient are the same shard")
            for k in keys:
                if table.assign.get(k) != donor:
                    raise ValueError(
                        f"key {k!r} is not owned by donor shard {donor}")
            donor_uri = table.shards[donor]
            target_uri = table.shards[recipient]
            # a provisional epoch for the shards' stamp: the committed one
            # is taken at the install below, so a join that commits while
            # this move streams never shares it (epochs only rise)
            stamp_epoch = table.epoch + 1
        obs.record_event("rebalance_start", donor=donor,
                         recipient=recipient, keys=len(keys),
                         epoch=stamp_epoch)
        host, port = parse_replica_uri(donor_uri)[0][0]
        t0 = time.monotonic()
        frame = tv.encode(tv.MIGRATE_OUT, 0, None, extra={
            "keys": keys, "target": target_uri,
            "table_epoch": stamp_epoch,
        })

        def ask():
            ch = tv.Channel.connect(host, port)
            try:
                return tv.decode(ch.request(frame))
            finally:
                ch.close()

        with obs.tracer().span("rebalance", cat="coord").set(
                donor=donor, recipient=recipient, keys=len(keys)):
            try:
                try:
                    kind, _, _, extra = ask()
                except (tv.VanError, OSError):
                    # ambiguous: the donor may have cut over and only the
                    # reply died, and an abort would route the moved keys
                    # to a shard that evicted them. Ask once more: the
                    # donor acks a move it committed and re-runs one that
                    # did not; a donor that is gone fails again and the
                    # abort stands (its replica set's failover's matter)
                    kind, _, _, extra = ask()
                if kind != tv.OK:
                    raise RuntimeError(
                        f"donor shard {donor} refused the move: "
                        f"{extra.get('error')}")
            except Exception as e:
                self._m_aborts.inc()
                obs.record_event("rebalance_abort", donor=donor,
                                 recipient=recipient, keys=len(keys),
                                 epoch=stamp_epoch, why=repr(e))
                raise
        # committed at both shards: the new table at the next epoch, taken
        # here under the lock, above whatever a join installed meanwhile
        with self._tlock:
            new_epoch = self._table.epoch + 1
            assign = dict(self._table.assign)
            for k in keys:
                assign[k] = recipient
            self._table = ShardTable(new_epoch, self._table.shards, assign)
            for k in keys:
                b = self._members[donor].key_bytes.pop(k, key_bytes.get(k, 0))
                self._members[recipient].key_bytes[k] = b
            self.moves_done += 1
        dt = time.monotonic() - t0
        rbytes = int(extra.get("bytes", 0))
        self._m_moves.inc()
        self._m_keys.inc(len(keys))
        self._m_bytes.inc(rbytes)
        obs.record_event("rebalance_commit", donor=donor,
                         recipient=recipient, keys=len(keys),
                         epoch=new_epoch, bytes=rbytes,
                         rows=int(extra.get("rows", 0)),
                         donor_seconds=extra.get("seconds"),
                         seconds=round(dt, 4))
        logging.getLogger(__name__).info(
            "rebalance committed: %d key(s) shard %d -> %d "
            "(epoch %d, %.1f MB in %.2fs)", len(keys), donor, recipient,
            new_epoch, rbytes / 1e6, dt,
        )
        return rbytes

    def _drop_members(self, drained: List[int]) -> None:
        """Take the emptied drained members out and renumber the table
        (one more epoch); a member that still owns keys is refused."""
        with self._tlock:
            table = self._table
            for d in drained:
                owned = table.keys_of(d)
                if owned:
                    raise RuntimeError(
                        f"shard {d} still owns {len(owned)} key(s) — "
                        f"drain moves them first")
            keep = [i for i in range(len(self._members)) if i not in drained]
            remap = {old: new for new, old in enumerate(keep)}
            dropped_uris = [self._members[i].uri for i in drained]
            self._members = [self._members[i] for i in keep]
            self._table = ShardTable(
                table.epoch + 1,
                [table.shards[i] for i in keep],
                {k: remap[s] for k, s in table.assign.items()},
            )
            epoch = self._table.epoch
        for uri in dropped_uris:
            # a drained member's series end here
            self.tsdb.drop_member(uri)
            self._decoders.pop(uri, None)
        obs.record_event("coord_drain", shards=drained, epoch=epoch)
