"""Shard replication and live failover for the van's parameter servers.

Counterpart of ``ps_tpu/replica/``. Every shard may run as a
primary/backup pair:

- the PRIMARY serves workers and streams each committed event (push
  trees, pull records) through a :class:`ReplicationLog` to its backup
  over the van (:class:`BackupSession`). Sync ack holds the worker's
  reply until the backup acked (a promotion is then bitwise what the
  workers saw); async ack bounds the backup's lag by the session window;
- the BACKUP runs the same service class with ``backup=True``: it applies
  the stream through its own engine (parameters, tables and the
  sparse-apply kernels on its device) and refuses worker traffic until
  promoted;
- PROMOTION is triggered by the heartbeat (:class:`PromotionWatch`:
  goodbye is a planned handoff, silence past the horizon a failure),
  bumps the shard's epoch and starts the backup serving;
- WORKERS carry a replica set a shard (``"p0:a|b0:c,p1:d|b1:e"``): a dead
  primary's typed failure is retried against the next member, waiting out
  the promotion, and the (nonce, seq) dedup tokens make a replayed
  in-flight push apply exactly once at the new primary.
"""

from ps_tpu_torch.replica.log import ReplicationError, ReplicationLog
from ps_tpu_torch.replica.session import BackupSession
from ps_tpu_torch.replica.watch import PromotionWatch

__all__ = [
    "ReplicationLog", "ReplicationError", "BackupSession", "PromotionWatch",
]
