"""Elastic membership: counterpart of ``ps_tpu/elastic/``.

A coordinator owns the epoch-versioned shard table and moves key ranges
between serving shards live, so a fleet of two shards grows to four and
back under traffic with no worker restart and no global pause. Without a
coordinator (``Config.coord_uri`` / ``PS_COORD_URI`` unset) servers and
workers keep the static URI topology.

- :class:`~ps_tpu_torch.elastic.table.ShardTable`: the key-to-shard
  assignment, the fencing token workers re-route on;
- :class:`~ps_tpu_torch.elastic.coordinator.Coordinator`: membership,
  liveness (the heartbeat monitor), load reports, rebalances, fleet
  telemetry, the policy engine;
- :class:`~ps_tpu_torch.elastic.migrate.MigrationSession`: the donor's
  sequenced row stream (parameter, optimizer state and stale snapshots a
  key) with its catch-up and bounded stop-and-copy cutover;
- :mod:`~ps_tpu_torch.elastic.member`: the members', workers' and
  operators' round trips (:class:`CoordinatorMember`,
  :class:`TelemetryReporter`, :func:`fetch_table`,
  :func:`request_rebalance`, :func:`fetch_telemetry`, ...).
"""

from ps_tpu_torch.elastic.coordinator import Coordinator
from ps_tpu_torch.elastic.member import (
    CoordinatorMember,
    TelemetryReporter,
    fetch_table,
    fetch_telemetry,
    fetch_view,
    parse_coord,
    request_rebalance,
)
from ps_tpu_torch.elastic.migrate import MigrationError, MigrationSession
from ps_tpu_torch.elastic.table import ShardTable, plan_moves, skew

__all__ = [
    "Coordinator", "CoordinatorMember", "MigrationError",
    "MigrationSession", "ShardTable", "TelemetryReporter", "fetch_table",
    "fetch_telemetry", "fetch_view", "parse_coord", "plan_moves",
    "request_rebalance", "skew",
]
