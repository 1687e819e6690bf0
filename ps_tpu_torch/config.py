"""Typed configuration for ps_tpu_torch.

The port's own copy of ``ps_tpu/config.py`` (that module is jax-free, but
importing it would run ``ps_tpu/__init__.py``, which imports jax): the
same fields, the same ``PS_*``/``DMLC_*`` spellings and the same
validation, so a launcher script drives either package unchanged. What
differs: the backend is 'cuda' (the counterpart of 'tpu'), a ``device``
field places everything (not an environment variable; only code asks for
the CPU) and ``fused_apply`` names the port's tiers.

The reference family configures node roles through environment variables
(``DMLC_ROLE`` / ``DMLC_PS_ROOT_URI`` style) plus per-trainer argparse flags
(SURVEY.md §3 row 17). ps_tpu keeps that spirit with one dataclass that can be
built from environment variables, so existing launcher scripts that export
role/coordinator env vars keep working.

Environment variables honored by :meth:`Config.from_env`:

- ``PS_BACKEND``           — 'local' or 'cuda' (default 'cuda')
- ``PS_NUM_WORKERS``       — logical worker count for sync aggregation
- ``PS_COORDINATOR_URI``   — where the ranks meet, ``host:port`` (cuda
  backend; rank 0 listens there)
- ``PS_NUM_PROCESSES``     — the world size (ranks)
- ``PS_PROCESS_ID``        — this process's rank
- ``PS_DIST_BACKEND``      — 'auto' (NCCL on CUDA, gloo on the CPU),
  'nccl' or 'gloo'
- ``PS_MODE``              — 'sync' or 'async' (delay-compensated)
- ``PS_DC_LAMBDA``         — DC-ASGD delay-compensation coefficient
  (async mode; default 0.04)
- ``PS_SEED``              — global PRNG seed
- ``PS_ROLE``              — cross-process PS deployments: 'server' or
  'worker' (unset = the SPMD single-controller topology)
- ``PS_SERVER_URIS``       — worker side: ``h0:p0,h1:p1,...`` naming every
  server of the partition (alias: ``PS_ASYNC_SERVER_URI``)
- ``PS_WORKER_ID``         — this worker's id in the cross-process job
- ``PS_SHARD`` / ``PS_NUM_SHARDS`` — server side: this server's index in /
  the size of the key (or row-range) partition
- ``PS_BUCKET_BYTES``       — bucketed van transport: fusion-bucket size in
  bytes (0/unset = serial one-frame-per-cycle transport)
- ``PS_TRANSPORT_POOL``     — connections per server for bucket striping
- ``PS_BUCKET_PRIORITY``    — '0' disables priority bucket scheduling
  (ByteScheduler-style: bucket flushes drain front-of-model first when a
  backlog forms, instead of FIFO) — default on; the drain order is
  deterministic either way and never changes the math
- ``PS_AGG_GROUP_SIZE``     — hierarchical two-level aggregation: how many
  same-host workers share one aggregator (the local fan-in cross-host
  bytes shrink by); 1 (default) = no aggregation, flat worker→shard
- ``PS_AGG_FLUSH_TIMEOUT_MS`` — aggregator side: how long an incomplete
  round waits for its remaining group members before flushing the
  partial merge upstream (default 2000 — a dead member degrades its
  group's latency, never wedges it)
- ``PS_COMPRESS``           — gradient codec for the van wire: 'none'
  (default), 'cast16', 'int8', or 'topk' (ps_tpu/compress)
- ``PS_COMPRESS_TOPK``      — kept fraction for the topk codec (default 0.01)
- ``PS_COMPRESS_MIN_BYTES`` — tensors under this many bytes always travel
  raw (default 65536 — protects optimizer-critical small tensors)
- ``PS_COMPRESS_PULL``      — '1' also compresses the pull return path on
  the bucketed transport (cast16/int8 only)
- ``PS_WRITEV``             — '0' disables vectored (scatter-gather) frame
  sends and restores the legacy staging-bytearray framing (default on)
- ``PS_SHM``                — '1' negotiates the same-host shared-memory
  ring lane per van connection (TCP fallback on any failure); '0' also
  makes servers refuse offers (job-wide off switch)
- ``PS_SHM_BYTES``          — ring capacity per direction for the shm lane
  (default 16 MiB — cache-resident)
- ``PS_VAN_NATIVE_LOOP``    — '1' serves van connections from the native
  epoll event loop (GIL-free accept/read/writev; one Python pump thread
  for engine applies — README "Native event loop"); default off =
  thread-per-connection, also the fallback on non-Linux platforms
- ``PS_VAN_LOOP_THREADS``   — native event-loop thread-pool size
  (default 1; connections are assigned round-robin)
- ``PS_NATIVE_READ_CACHE_BYTES`` — native read-cache budget for the
  zero-upcall READ serving path (README "Read path"); entries are
  published on READ misses and invalidated on every apply. 0 disables;
  default 64 MiB. Only meaningful with PS_VAN_NATIVE_LOOP=1
- ``PS_NL_STATS``             — '0' disarms the native event loop's own
  in-loop telemetry (the lock-free striped ``ps_nl_*`` histograms: frame
  read latency, ready-queue wait, native READ-hit serve time, tail-flush
  latency — README "Native observability"); default on, measured < 2%
  on the zero-upcall serve path it instruments
- ``PS_NL_SLOW_FRAME_MS``     — slow-frame watchdog threshold: any frame
  whose in-loop latency exceeds this records a bounded native ring entry
  (kind, size, conn, per-stage timings, propagated trace id) that the
  pump drains into a ``slow_frame`` flight event with a reconstructed
  span (default 250; 0 disarms; needs PS_NL_STATS on)
- ``PS_PUSH_NATIVE_ADMIT``  — zero-upcall push plane (README "Push
  path"): 'off' | 'on' | 'auto' (default auto = on wherever the native
  loop serves). The loop classifies steady-state push frames against a
  per-worker dedup-ledger mirror: pure replays acked and role refusals
  answered natively with the pump's exact bytes, fresh pushes
  admission-stamped so the apply skips the dedup scan. 'off' keeps the
  pump as the only admission path — the drop-in parity oracle
- ``PS_READ_STALENESS``     — worker side: how many VERSIONS a replica-
  served READ may trail the last-known primary version before the read
  falls back to the primary (default 0 = replicas serve only what is
  provably current)
- ``PS_PULL_CACHE``         — '1' turns on the worker-side parameter
  cache: repeat reads at an unchanged version cost no wire round trip;
  version bumps ride decoded replies plus a REPLICA_STATE probe on the
  heartbeat cadence (default off)
- ``PS_READ_CONDITIONAL``   — '0' disables version-predicated reads
  (default on): with it on, a reader holding a snapshot sends the
  version it knows, an unchanged target answers NOT_MODIFIED (stamp
  only), and a changed sparse target ships a row DELTA — only rows
  whose per-row version moved — instead of the full id-set
- ``PS_CONNECT_MAX_WAIT_MS`` — total sleep budget of one
  ``Channel.connect`` dial's retry backoff (default 15000); read-path
  failover tuning turns it down so a dead replica costs milliseconds
- ``PS_AGG_PROBE_MAX_WAIT_MS`` — sleep budget of the stale-aggregator
  liveness probe a discovering worker runs before dialing its host's
  registered aggregator (default 200)
- ``PS_FUSED_APPLY``        — sparse embedding fused apply tier:
  'off' = legacy masked full-table apply (either device), 'torch' = the
  plain PyTorch gather→apply→scatter (CPU tensors only), 'cuda' = the
  hand-written CUDA kernel (ps_tpu_torch/ops/csrc/sparse_apply.cu),
  'auto' (default) = cuda on a CUDA device, torch on the CPU
- ``PS_EMBED_DEVICE_ROWS``  — tiered embedding device budget (README
  "Tiered embedding storage"): tables with more rows than this keep a
  device-HBM hot set of this many slots and spill the rest to a
  host-DRAM arena; 0 (default) = unlimited = every table fully on
  device, today's behavior byte-for-byte
- ``PS_EMBED_ADMIT_FREQ``   — touch count at which a cold row promotes
  into the hot set (default 2)
- ``PS_EMBED_EVICT_TTL_MS`` — demote hot rows idle this many ms
  (default 0 = TTL off; CLOCK still evicts on slot pressure)
- ``PS_EMBED_PREFETCH``     — stage tiered cold-tier DRAM gathers on a
  background thread, overlapping them with the previous apply
  (default off)
- ``PS_CKPT_ROOT``          — server side: confine CHECKPOINT saves under
  this root (client paths relative-only, ``..`` refused)
- ``PS_REPLICAS``           — replica-set size per shard (1 = no
  replication; 2 = primary + warm backup — ps_tpu/replica)
- ``PS_REPLICA_ACK``        — 'sync' (push replies wait for the backup's
  ack; bitwise-identical promotion) or 'async' (bounded lag)
- ``PS_REPLICA_WINDOW``     — max commits the backup may trail before
  primaries block (the bounded ack window; default 256)
- ``PS_FAILOVER_TIMEOUT_MS`` — worker side: how long a shard's replica set
  is retried (promotion wait included) before the typed failure surfaces
- ``PS_COORD_URI``           — elastic membership (ps_tpu/elastic):
  ``host:port`` of the cluster coordinator; servers register with it and
  workers fetch the shard table from it instead of a static
  ``PS_SERVER_URIS`` list (unset = today's static topology)
- ``PS_REBALANCE_AUTO``      — '1' lets the coordinator rebalance on its
  own when byte skew across shards exceeds the threshold (default off —
  operators/benches trigger rebalances explicitly)
- ``PS_REBALANCE_MAX_SKEW``  — max/min byte-load ratio tolerated before an
  auto rebalance fires (default 2.0)
- ``PS_REBALANCE_REPORT_MS`` — load-report cadence the coordinator hands
  registering members (default 1000)
- ``PS_TELEMETRY``           — fleet telemetry (ps_tpu/obs, README "Fleet
  telemetry"): '0' stops members piggybacking delta-encoded metric
  snapshots on their coordinator reports AND stops the coordinator
  ingesting/evaluating them (default on; without a coordinator the knob
  is moot — telemetry only ever rides the COORD_REPORT cadence)
- ``PS_TELEMETRY_WINDOW_S``  — default query/signal window in seconds for
  fleet quantiles, straggler scoring, and the breakdown (default 30)
- ``PS_TELEMETRY_RING``      — coordinator-side samples retained per
  (member, metric) series (default 256 — ~4 min at the 1 s report cadence)
- ``PS_TELEMETRY_STRAGGLER_Z`` — leave-one-out z-score threshold before a
  member is flagged ``straggler_suspect`` (default 3.0)
- ``PS_SLO_RULES``           — ';'-separated SLO rules the coordinator
  evaluates over fleet telemetry, e.g. ``push p99 < 10ms over 30s``
  (unset = no rules; breaches fire ``slo_breach`` flight events and the
  ``ps_slo_breach_total`` counter)
- ``PS_FRESHNESS_SLO``       — the serving-freshness bound in SECONDS
  (default 0.5): every served read records its age (now − the version's
  birth at the primary's apply) into ``ps_read_staleness_seconds``, and
  the share of reads at or under this bound is the ``age%`` column in
  ps_top / the ``fresh_share`` STATS field
- ``PS_POLICY``              — the coordinator's autopilot policy engine
  (README "Autopilot & chaos"): ``off`` (default — today's behavior,
  byte-identical), ``dry`` (evaluate rules and record decisions without
  executing), ``on`` (execute planned elastic actions)
- ``PS_POLICY_COOLDOWN_S``   — per-action-class cooldown between policy
  actions (default 30; a flapping signal can never storm the fleet)
- ``PS_POLICY_BURN_WINDOWS`` — consecutive evaluation windows a signal
  must hold before a rule fires, and consecutive QUIET windows below the
  recover threshold before it re-arms (default 3)
- ``PS_CHAOS_SEED``          — deterministic seed for the chaos fault
  injector's schedule (ps_tpu_torch/chaos; default 0 — same seed, same
  faults)
- ``PS_TRACE_SAMPLE``        — distributed-tracing sample rate in [0, 1]
  (ps_tpu/obs: 0 = off, the default — the unsampled path costs nothing)
- ``PS_TRACE_DIR``           — directory for trace exports and flight-
  recorder dumps (default '.')
- ``PS_METRICS_PORT``        — opt-in Prometheus /metrics HTTP endpoint
  per process (0 = ephemeral port; unset = no endpoint)
- ``PS_FLIGHT_EVENTS``       — flight-recorder ring capacity (default
  4096 typed events)
- ``PS_HEARTBEAT_BASE_PORT`` — enable the UDP failure detector; process
  i's monitor binds base_port+i (single-host layout)
- ``PS_PEER_HOSTS``          — multi-host monitor addresses, entry i for
  process i (``host`` or ``host:port``, comma-separated)
- ``PS_HEARTBEAT_BIND``      — monitor listen address override
- ``PS_HEARTBEAT_INTERVAL_MS`` / ``PS_HEARTBEAT_TIMEOUT_MS`` — beat
  cadence and the silent-horizon declaring a peer dead
- ``DMLC_ROLE``, ``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER``,
  ``DMLC_PS_ROOT_URI``/``_PORT`` are accepted as aliases where the meaning
  is knowable, so reference-family launcher scripts keep working.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def env_flag(name: str, default: bool) -> bool:
    """The ONE parser for boolean PS_* env knobs (PS_WRITEV, PS_SHM, ...):
    every consumer — Config.from_env, the workers' transport init, the
    server's accept gate — resolves through here, so the accepted token
    set can never drift between them. Unset (or unrecognized) values keep
    ``default``; the worker-off/server-accept asymmetry of PS_SHM is
    expressed purely through each caller's default."""
    v = os.environ.get(name)
    if v is None:
        return default
    v = v.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default


def _env_number(name, default, lo, hi, cast, strict):
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        out = cast(v.strip())
    except ValueError:
        if strict:
            raise ValueError(
                f"{name}={v!r} is not a valid {cast.__name__}") from None
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not a valid %s; keeping default %r",
            name, v, cast.__name__, default)
        return default
    clamped = out
    if lo is not None:
        clamped = max(clamped, cast(lo))
    if hi is not None:
        clamped = min(clamped, cast(hi))
    if clamped != out:
        # the PR-9 lesson generalized: an env value that bypassed
        # Config's validation must not abort (or corrupt) a service —
        # clamp to the documented bound, loudly
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r outside [%s, %s]; clamping to %r",
            name, out, lo, hi, clamped)
    return clamped


def env_int(name: str, default: Optional[int], lo: Optional[int] = None,
            hi: Optional[int] = None, strict: bool = True) -> Optional[int]:
    """The validated reader for integer ``PS_*`` knobs consumed at the
    *service* level (not through :meth:`Config.from_env`): unset/blank
    keeps ``default``, an unparseable value raises naming the variable
    (or warns and keeps the default with ``strict=False`` — for
    observability paths that must never take a service down), and a
    value outside ``[lo, hi]`` is clamped with a warning instead of
    surfacing later as an opaque native failure. Every service-level
    mirror resolves through here/:func:`env_float`/:func:`env_str`/
    :func:`env_flag` — pslint PSL406 flags raw ``os.environ`` reads."""
    return _env_number(name, default, lo, hi, int, strict)


def env_float(name: str, default: Optional[float],
              lo: Optional[float] = None, hi: Optional[float] = None,
              strict: bool = True) -> Optional[float]:
    """Float twin of :func:`env_int` (see there for the contract)."""
    return _env_number(name, default, lo, hi, float, strict)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String twin of :func:`env_int`: unset or blank keeps ``default``
    (a blank path/rule-string is never a meaningful knob value here).
    Exists so every service-level env read goes through ONE greppable,
    PSL4xx-visible surface even when no further validation applies."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    return v


@dataclasses.dataclass
class Config:
    """Runtime configuration for :func:`ps_tpu.init`.

    Attributes:
      backend: 'cuda' (the counterpart of the reference's 'tpu': every
        table, parameter and optimizer state lives on ``device``) or
        'local' (the single-process local PS, ``backends/local.py``).
      device: where the 'cuda' backend places everything — 'cuda'
        (default, ``cuda:0``) or 'cpu', which only code can ask for (the
        tests do); there is no silent fall back to the CPU.
      num_workers: logical worker count for the local backend's sync
        aggregation semantics (server applies once all workers pushed).
        For the 'tpu' backend the worker count is the mesh's data-axis size.
      coordinator_uri: ``host:port`` where the ranks of a multi-process
        run meet (``init_method='tcp://host:port'``; rank 0 listens
        there). ``None`` means one process.
      num_processes / process_id: the world size and this process's rank
        in the ``torch.distributed`` process group.
      dist_backend: the process group's backend — 'auto' (NCCL on a CUDA
        device, gloo on the CPU), 'nccl', or 'gloo' (which ranks sharing
        one card must ask for).
      role: cross-process PS deployments — 'server' or 'worker' (None =
        the SPMD single-controller topology with no PS processes).
      server_uris: worker side — ``h0:p0,h1:p1,...`` naming every server
        of the partition (``|``-separated replica sets per shard).
      worker_id: this worker's id within the cross-process job.
      shard / num_shards: server side — this server's index in / the
        size of the key (or row-range) partition.
      ckpt_root: server side — confine CHECKPOINT saves under this root
        (client paths relative-only, ``..`` refused); None keeps the
        legacy client-names-the-path behavior (loopback binds only).
      mesh_shape: optional explicit mesh shape over the axes 'data',
        'model', 'seq' and 'pipe', e.g. ``{'data': 8}``, ``{'data': 4,
        'model': 2}`` or ``{'data': 2, 'seq': 4}``; rank r sits at
        ``np.unravel_index(r, shape)``. Default: all ranks on one 'data'
        axis.
      mode: 'sync' or 'async' (async = stale apply with delay compensation).
      dc_lambda: DC-ASGD delay-compensation coefficient (async mode).
      seed: global PRNG seed.
      bucket_bytes / transport_pool: bucketed van transport — fusion-bucket
        size (None = serial one-frame-per-cycle) and striped connections
        per server.
      bucket_priority: priority bucket scheduling (README "Two-tier
        aggregation & priority scheduling"): bucket flushes carry their
        bucket index as a priority — front-of-model buckets drain a
        backlog first (reverse of backprop completion order), so the
        tail layers' grads stop serializing in front of the bytes the
        next step's forward needs. Deterministic tie-break (enqueue
        order), numerics identical to FIFO by construction; off restores
        the pure FIFO drain for A/B comparison.
      agg_group_size: hierarchical two-level aggregation — how many
        same-host workers share one :class:`~ps_tpu_torch.backends.
        aggregator.AggregatorService` (the local fan-in cross-host bytes/step shrink
        by). 1 (default) keeps the flat worker→shard topology; launchers
        start one aggregator per host when > 1.
      agg_flush_timeout_ms: aggregator side — how long an incomplete
        round waits for its remaining group members before the partial
        merge flushes upstream (a dead member costs its group latency
        once per round, never a wedge).
      compress: gradient codec for the van wire ('cast16', 'int8', 'topk';
        None/'none' = raw float32). See ps_tpu/compress and the README's
        "Gradient compression" section.
      compress_topk: kept fraction for the topk codec (default 0.01).
      compress_min_bytes: tensors under this many bytes always travel raw
        (default 65536 — protects optimizer-critical small tensors).
      compress_pull: also compress the bucketed pull return path
        (cast16/int8 only; topk is refused — its error-feedback residuals
        live at the sender).
      writev: vectored frame sends (README "Transport lanes") — tensor
        bytes go to the kernel as scatter-gather iovecs of the live
        arrays instead of through a per-frame staging bytearray. On by
        default; turn off only to compare against the legacy framing
        (the wire bytes are identical either way).
      shm: negotiate the same-host shared-memory ring lane per van
        connection (worker and server must report the same boot id);
        falls back to TCP when negotiation fails, the segments cannot be
        created, or the peer dies. Off by default — explicit opt-in,
        like the bucketed transport.
      shm_bytes: ring capacity per direction for the shm lane (default
        16 MiB — small enough to stay cache-resident; frames over
        half a ring spill to TCP transparently).
      van_native_loop: serve van connections from the native epoll event
        loop (README "Native event loop"): accept, frame reads and
        scatter-gather reply writes run on a small pool of native
        threads with the GIL out of the hot path; Python handles only
        batched engine applies on one pump thread. Per-connection cost
        stays flat to 64+ workers vs the thread-per-connection default.
        Off by default (explicit opt-in, like shm); non-Linux platforms
        fall back to thread-per-connection regardless.
      van_loop_threads: native event-loop thread-pool size (default 1 —
        one loop thread saturates loopback; raise for many-NIC hosts).
        Connections are assigned round-robin at accept.
      native_read_cache_bytes: byte budget of the native read cache
        (README "Read path"): committed, version-stamped READ replies
        published by Python and answered inside the epoll loop with
        zero upcalls on byte-identical repeats; invalidated on every
        apply. 0 disables (every READ takes the pump); only meaningful
        with van_native_loop.
      nl_stats: the native event loop's own in-loop telemetry (README
        "Native observability"): lock-free per-loop-thread striped
        histograms — frame read latency, ready-queue wait, native
        READ-hit service time, EPOLLOUT tail-flush latency — synced into
        the ``ps_nl_*`` metric families on the pump's gauge tick, riding
        /metrics, STATS and fleet telemetry like every other surface.
        On by default; the off path is the pre-telemetry loop plus one
        relaxed load per frame.
      nl_slow_frame_ms: slow-frame watchdog threshold in milliseconds —
        a frame whose in-loop latency (read + queue wait, or read +
        native serve) exceeds it leaves a bounded native ring entry with
        per-stage timings and the request's propagated trace id; the
        pump turns each into a ``slow_frame`` flight event plus a
        reconstructed span, so one hiccup on the zero-upcall path is a
        traceable incident instead of a p999 mystery. 0 disarms the
        watchdog; needs nl_stats.
      read_staleness: worker side — the bounded-staleness contract of
        replica reads, in VERSIONS: a backup whose READ reply trails
        the worker's last-known primary version by more than this is
        refused and the read falls back toward the primary. 0 (default)
        = replicas only serve what is provably current.
      pull_cache: worker-side parameter cache for the read path: repeat
        reads at an unchanged version are served locally with no wire
        round trip; version bumps piggyback on every reply the worker
        decodes plus a REPLICA_STATE probe on the heartbeat cadence.
        Off by default (explicit opt-in, like shm).
      read_conditional: version-predicated serving (on by default):
        readers holding a snapshot revalidate it with a conditional
        READ — an unchanged target answers NOT_MODIFIED (stamp only)
        and a changed sparse target ships only the rows whose per-row
        version moved. Off = every refetch ships the full payload.
      push_native_admit: zero-upcall push plane (README "Push path"):
        'off' | 'on' | 'auto' (default auto = on wherever the native
        loop serves). The loop classifies steady-state push frames
        against a per-worker dedup-ledger mirror — replays acked and
        role refusals answered natively with the pump's exact bytes,
        fresh pushes admission-stamped; 'off' keeps every push on the
        pump (the parity oracle).
      fused_apply: sparse embedding fused apply tier
        (ps_tpu_torch/ops/sparse_apply.py): 'off' names the legacy
        masked full-table apply, plain torch on either device; 'torch' is the
        plain PyTorch gather→apply→scatter and takes CPU tensors only;
        'cuda' is the hand-written kernel (on CPU tensors its plain
        version); 'auto' (default) resolves by device — cuda on a CUDA
        device, torch on the CPU. Numerics are pinned to the reference's
        'jax' tier by tests/test_torch_sparse_apply.py.
      embed_device_rows: tiered embedding device budget (README "Tiered
        embedding storage"; ps_tpu/kv/tiered.py): a table with more
        rows than this fronts a device-HBM hot set of this many slots
        (rows + per-row optimizer state together) over a host-DRAM
        cold arena, split per push/read by the row directory. 0
        (default) = unlimited — every table stays fully on device,
        today's behavior byte-for-byte.
      embed_admit_freq: touch count at which a cold row promotes into
        the hot set (frequency admission; default 2).
      embed_evict_ttl_ms: demote hot rows idle this many milliseconds
        (0 = TTL off — CLOCK second-chance eviction still runs on slot
        pressure; eviction is a demotion, never a drop).
      embed_prefetch: stage the cold tier's DRAM gather on a background
        thread so it overlaps the previous apply (default off).
      connect_max_wait_ms: total sleep budget of one Channel.connect
        dial's retry backoff (the boot patience). Read-path failover
        tuning turns it down; 15 s default preserved.
      agg_probe_max_wait_ms: sleep budget of the stale-aggregator
        liveness probe run before dialing a discovered host aggregator
        (a dead registry entry must cost a join milliseconds).
      replicas: replica-set size per shard (ps_tpu/replica): 1 = classic
        unreplicated servers; 2 = primary + warm backup with live
        failover. Launchers size the server fleet with it; workers learn
        the actual sets from the ``|``-separated server URIs.
      replica_ack: 'sync' — a push/pull reply waits for the backup's ack,
        so promotion is bitwise-identical to everything workers observed;
        'async' — replies return immediately and the backup trails by at
        most ``replica_window`` commits (metrics-visible lag).
      replica_window: the bounded ack window: commits the backup may
        trail before the primary blocks new appends (memory AND lag
        bound).
      failover_timeout_ms: worker side — how long each shard's replica
        set is retried (covering detection + promotion) before a
        ServerFailureError surfaces.
      coord_uri: elastic membership (ps_tpu/elastic, README "Elastic
        membership") — ``host:port`` of the cluster coordinator. Servers
        register their key ranges with it; workers fetch the
        authoritative shard table from it (INSTEAD of ``server_uris``)
        and re-route live when a rebalance moves keys. ``None`` (default)
        keeps today's static URI topology — the subsystem is strictly
        additive. Distinct from ``coordinator_uri``, which is
        jax.distributed's rendezvous for multi-host SPMD.
      rebalance_auto: let the coordinator fire a rebalance on its own
        when the byte skew across serving shards exceeds
        ``rebalance_max_skew``. Off by default: drills, benches, and
        operators call the rebalance entry points explicitly.
      rebalance_max_skew: the max/min byte-load ratio across shards the
        auto-rebalancer tolerates before planning moves (default 2.0).
      rebalance_report_ms: cadence of the load reports (keys, bytes,
        push/pull QPS) each member streams to the coordinator — the
        skew signal's freshness (default 1000).
      telemetry: fleet telemetry (README "Fleet telemetry") — members
        piggyback delta-encoded metric snapshots (counters, gauges, RAW
        log2 histogram buckets) on their coordinator load reports, and
        the coordinator merges them into true fleet quantiles, the
        per-step breakdown, straggler detection, and SLO evaluation.
        On by default; costs nothing without a coordinator, and a dead
        coordinator degrades every member to local-only observability
        with the data plane untouched.
      telemetry_window_s: the default window (seconds) for fleet
        quantile queries, straggler scoring, and SLO burn windows.
      telemetry_ring: coordinator-side sample-ring bound per (member,
        metric) — the whole tsdb's memory ceiling.
      telemetry_straggler_z: leave-one-out z-score threshold on a
        member's window-mean latency before it is flagged a
        ``straggler_suspect`` (and a rebalance hint is published).
      slo_rules: ``;``-separated declarative SLO rules evaluated in the
        coordinator loop — ``"<metric> p99 < 10ms over 30s"`` with
        metric one of push/pull/push_pull/cycle/bucket/apply/ack/flush/
        read/freshness/staleness or a full ``ps_*`` histogram name.
        None = no rules.
      freshness_slo: the serving-freshness bound in seconds (README
        "Online serving & freshness", default 0.5) — every served read
        records ``now − birth`` into ``ps_read_staleness_seconds`` and
        counts against this bound; the in-bound share is ps_top's
        ``age%`` column.
      policy: the coordinator's autopilot policy engine (README
        "Autopilot & chaos") — ``off`` (default: no engine at all,
        today's behavior byte-identical), ``dry`` (rules evaluate and
        decisions are recorded/audited but never executed), ``on``
        (sustained signals execute planned elastic actions: rebalance
        toward the healthy set, replica re-seed, shard add/remove).
      policy_cooldown_s: seconds a policy action class stays cooled down
        after firing — the storm brake (default 30).
      policy_burn_windows: consecutive evaluation windows a signal must
        hold before its rule fires, and consecutive quiet windows below
        the (lower) recover threshold before the rule re-arms — the
        hysteresis pair (default 3).
      chaos_seed: deterministic seed for the chaos injector's fault
        schedule (ps_tpu_torch/chaos/inject.py) — identical seeds replay
        identical fault timelines (default 0).
      trace_sample: distributed-tracing sample rate in [0, 1] (README
        "Observability"; ps_tpu/obs). A sampled worker op propagates its
        trace context in the van frame headers, so the whole
        worker→primary→backup chain lands in per-process span rings and
        exports to one merged Perfetto timeline. 0 (default) = off; the
        unsampled hot path is a no-op singleton plus one dict lookup.
      trace_dir: where trace exports and flight-recorder dumps are
        written (default: the working directory).
      metrics_port: opt-in Prometheus-text /metrics HTTP endpoint for
        this process (0 = ephemeral port, read it off the server; None =
        no endpoint). Loopback-bound, like every other unauthenticated
        endpoint here.
      flight_events: flight-recorder ring capacity — the last N typed
        events (failover, degrade, stale epoch, shm spill, reconnect,
        self-fence, promotion, peer death) dumped as JSONL on unhandled
        VanError or SIGUSR2.
      heartbeat_base_port: enable the control-plane failure detector for
        multi-process runs. Without ``peer_hosts``, process i's monitor binds
        base_port+i on this host (single-host/localhost topology). With
        ``peer_hosts``, it is the default monitor port for entries that name
        no port. ``None`` disables the detector.
      peer_hosts: per-process monitor addresses for multi-HOST pods:
        comma-separated, entry i addresses process i, each ``host`` or
        ``host:port`` (port defaults to ``heartbeat_base_port`` — distinct
        hosts can share one port number). Example:
        ``PS_PEER_HOSTS=10.0.0.1:7777,10.0.0.2:7777``.
      heartbeat_bind: the monitor's listen address. Default (``None``)
        follows the topology: ``0.0.0.0`` when ``peer_hosts`` names remote
        machines, loopback for the single-host ``heartbeat_base_port``
        layout — the detector is never exposed off-host unless the config
        says the job spans hosts. Set explicitly to override either way.
      heartbeat_interval_ms / heartbeat_timeout_ms: beat cadence and the
        silent-horizon after which a peer is declared dead.
    """

    backend: str = "cuda"
    # no PS_* spelling on purpose: the CPU is reachable only from code
    device: str = "cuda"  # pslint: disable=PSL402 -- the CPU is reachable only from code (the comment above): a launcher runs on the card
    num_workers: int = 1
    coordinator_uri: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    # the process group's backend across ranks: 'auto' (NCCL on a CUDA
    # device, gloo on the CPU), 'nccl' or 'gloo' (ranks sharing one card)
    dist_backend: str = "auto"
    mesh_shape: Optional[dict] = None  # pslint: disable=PSL402 -- a structured {axis: size} dict, not env-spellable; launchers pass it programmatically
    mode: str = "sync"
    dc_lambda: float = 0.04
    seed: int = 0
    # cross-process PS topology (serve_async/connect_async and the sparse
    # twins) — the reference family's DMLC_ROLE-style node system. None =
    # the SPMD single-controller topology (no PS processes).
    role: Optional[str] = None          # 'server' | 'worker'
    server_uris: Optional[str] = None   # worker: "h0:p0,h1:p1,..."
    worker_id: int = 0                  # worker: id within the job
    shard: Optional[int] = None         # server: index in the partition
    num_shards: Optional[int] = None    # server: partition size
    # bucketed/pipelined van transport (backends/common.py BucketPlan):
    # None = serial one-frame-per-cycle transport; set (e.g. 4 << 20) to
    # slice push/pull payloads into fusion buckets striped over
    # transport_pool persistent connections per server, enabling
    # compute/comm overlap (push_pull_async / push_async + flush)
    bucket_bytes: Optional[int] = None
    transport_pool: int = 2
    # priority bucket scheduling (ByteScheduler-style, README "Two-tier
    # aggregation & priority scheduling"): pending bucket flushes drain
    # front-of-model first instead of FIFO; deterministic, math-neutral
    bucket_priority: bool = True
    # hierarchical two-level aggregation (backends/aggregator.py):
    # same-host workers pre-reduce through one per-host aggregator and
    # cross the host boundary once per group round (1 = flat topology),
    # with a bounded wait for stragglers before a partial flush
    agg_group_size: int = 1
    agg_flush_timeout_ms: float = 2000.0
    # gradient compression on the van wire (ps_tpu/compress): codec name
    # (None/'none' = raw float32), topk kept-fraction, the size floor under
    # which tensors always travel raw, and whether bucketed pulls compress
    # the return path too (cast16/int8 only — topk needs sender-side
    # error-feedback state a server doesn't have)
    compress: Optional[str] = None
    compress_topk: float = 0.01
    compress_min_bytes: int = 1 << 16
    compress_pull: bool = False
    # zero-copy transport lanes (README "Transport lanes"): vectored
    # scatter-gather sends (no staging copy; identical wire bytes) and the
    # same-host shared-memory ring lane (negotiated per connection at
    # connect time, TCP fallback on any failure)
    writev: bool = True
    shm: bool = False
    shm_bytes: int = 16 << 20
    # native epoll event-loop serve path (README "Native event loop"):
    # GIL-free accept/read/writev on van_loop_threads native threads, one
    # Python pump thread for applies. Off = thread-per-connection (also
    # the non-Linux fallback).
    van_native_loop: bool = False
    van_loop_threads: int = 1
    # high-QPS read path (README "Read path"): the native zero-upcall
    # read cache's byte budget (server), the replica-read staleness
    # bound in versions and the worker parameter cache (worker side)
    native_read_cache_bytes: int = 64 << 20
    read_staleness: int = 0
    pull_cache: bool = False
    # version-predicated serving: conditional READs, NOT_MODIFIED
    # handshakes and sparse row deltas (on by default — turning it off
    # restores unconditional full-payload reads everywhere)
    read_conditional: bool = True
    # zero-upcall push plane (README "Push path"): native push admission
    # in the epoll loop — replay acks + role refusals answered with zero
    # upcalls, fresh pushes admission-stamped for the pump's apply.
    # 'off' keeps the pump as the only admission path (the parity
    # oracle); 'on'/'auto' arm it wherever the native loop serves.
    push_native_admit: str = "auto"
    # in-loop native telemetry (README "Native observability"): the
    # epoll loop's own lock-free histograms + the slow-frame watchdog
    # threshold (ms; 0 disarms)
    nl_stats: bool = True
    nl_slow_frame_ms: float = 250.0
    # sparse fused apply (ps_tpu_torch/ops/sparse_apply.py): which tier
    # SparseEmbedding's scatter-apply routes through — 'off' (legacy
    # masked full-table, either device), 'torch' (plain version, CPU only),
    # 'cuda' (the hand-written kernel), 'auto' (by device)
    fused_apply: str = "auto"
    # tiered embedding storage (ps_tpu/kv/tiered.py, README "Tiered
    # embedding storage"): device-HBM hot-slot budget (0 = unlimited =
    # untiered), frequency-admission threshold, idle-TTL demotion
    # horizon (0 = off), and the background cold-gather prefetch stage
    embed_device_rows: int = 0
    embed_admit_freq: int = 2
    embed_evict_ttl_ms: int = 0
    embed_prefetch: bool = False
    # dial budgets (previously hardcoded): Channel.connect's total
    # retry-sleep budget and the discovered-aggregator liveness probe's
    connect_max_wait_ms: int = 15_000
    agg_probe_max_wait_ms: int = 200
    # server: confine CHECKPOINT saves under this root (client paths must
    # be relative, '..' escapes refused). None = legacy client-names-path.
    ckpt_root: Optional[str] = None
    # shard replication & live failover (ps_tpu/replica, README
    # "Replication & failover"): replica-set size per shard (1 = none),
    # the ack discipline ('sync' = push replies wait for the backup's ack,
    # promotion is bitwise-identical to what workers observed; 'async' =
    # replies return immediately, the backup trails by at most
    # replica_window commits), and the worker-side window for riding out
    # a promotion before the typed server failure surfaces
    replicas: int = 1
    replica_ack: str = "sync"
    replica_window: int = 256
    failover_timeout_ms: int = 10_000
    # elastic membership (ps_tpu/elastic, README "Elastic membership"):
    # the coordinator owning the versioned shard table (None = static
    # topology), plus the rebalance policy knobs the coordinator runs
    # with (auto-fire on byte skew, the tolerated max/min ratio, and the
    # member load-report cadence feeding the skew signal)
    coord_uri: Optional[str] = None
    rebalance_auto: bool = False
    rebalance_max_skew: float = 2.0
    rebalance_report_ms: int = 1000
    # fleet telemetry (ps_tpu/obs/tsdb.py, README "Fleet telemetry"):
    # delta-encoded metric snapshots on the report cadence, merged
    # coordinator-side into true fleet quantiles + straggler/SLO signals
    telemetry: bool = True
    telemetry_window_s: float = 30.0
    telemetry_ring: int = 256
    telemetry_straggler_z: float = 3.0
    slo_rules: Optional[str] = None
    # freshness plane (ps_tpu/obs/freshness.py, README "Online serving
    # & freshness"): the age bound a served read is judged against
    freshness_slo: float = 0.5
    # autopilot (ps_tpu_torch/elastic/policy.py, README "Autopilot &
    # chaos"): the coordinator-side rule engine closing the
    # telemetry→elastic loop, its storm brakes, and the chaos injector's
    # schedule seed (ps_tpu_torch/chaos)
    policy: str = "off"
    policy_cooldown_s: float = 30.0
    policy_burn_windows: int = 3
    chaos_seed: int = 0
    # observability (ps_tpu/obs, README "Observability"): trace sampling
    # (0 = off), trace/flight output dir, the opt-in /metrics endpoint,
    # and the flight-recorder ring size. apply_obs() pushes these into
    # the process-global obs singletons.
    trace_sample: float = 0.0
    trace_dir: Optional[str] = None
    metrics_port: Optional[int] = None
    flight_events: int = 4096
    heartbeat_base_port: Optional[int] = None
    peer_hosts: Optional[str] = None
    heartbeat_bind: Optional[str] = None
    heartbeat_interval_ms: int = 100
    heartbeat_timeout_ms: int = 1000

    def resolved_heartbeat_bind(self) -> str:
        """The monitor listen address: explicit setting, else 0.0.0.0 for
        multi-host ``peer_hosts`` topologies and loopback otherwise."""
        if self.heartbeat_bind is not None:
            return self.heartbeat_bind
        return "0.0.0.0" if self.peer_hosts else "127.0.0.1"

    def heartbeat_peers(self) -> Optional[dict]:
        """Resolve the full monitor address map ``{process_id: (host, port)}``
        (including this process's own entry) from ``peer_hosts`` /
        ``heartbeat_base_port``; ``None`` when the detector is disabled."""
        if self.heartbeat_base_port is None and not self.peer_hosts:
            return None
        if self.peer_hosts:
            entries = [e.strip() for e in self.peer_hosts.split(",") if e.strip()]
            if len(entries) != self.num_processes:
                raise ValueError(
                    f"peer_hosts names {len(entries)} processes but "
                    f"num_processes={self.num_processes}"
                )
            peers = {}
            for i, e in enumerate(entries):
                if ":" in e:
                    host, port = e.rsplit(":", 1)
                    peers[i] = (host, int(port))
                elif self.heartbeat_base_port is not None:
                    peers[i] = (e, self.heartbeat_base_port)
                else:
                    raise ValueError(
                        f"peer_hosts entry {e!r} has no port and "
                        "heartbeat_base_port is unset"
                    )
            return peers
        base = self.heartbeat_base_port
        return {i: ("127.0.0.1", base + i) for i in range(self.num_processes)}

    def __post_init__(self):
        if self.backend not in ("local", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}; use 'local' or 'cuda'")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}; use 'cuda' or 'cpu'")
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {self.mode!r}; use 'sync' or 'async'")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.dist_backend not in ("auto", "nccl", "gloo"):
            raise ValueError(f"unknown dist_backend {self.dist_backend!r}; "
                             f"use 'auto', 'nccl' or 'gloo'")
        if self.role not in (None, "server", "worker"):
            if self.role == "scheduler":
                raise ValueError(
                    "role 'scheduler' does not exist here: rendezvous is "
                    "jax.distributed's coordination service — point "
                    "coordinator_uri (PS_COORDINATOR_URI / "
                    "DMLC_PS_ROOT_URI+PORT) at the coordinator instead"
                )
            raise ValueError(
                f"unknown role {self.role!r}; use 'server' or 'worker' "
                "(unset = SPMD single-controller)"
            )
        if self.shard is not None and self.num_shards is None:
            raise ValueError("shard set but num_shards unset")
        if self.shard is not None and not (
                0 <= self.shard < self.num_shards):
            raise ValueError(
                f"shard {self.shard} out of range for {self.num_shards}"
            )
        if self.bucket_bytes is not None and self.bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1 (or None for the "
                             "serial transport)")
        if self.transport_pool < 1:
            raise ValueError("transport_pool must be >= 1")
        if self.agg_group_size < 1:
            raise ValueError("agg_group_size must be >= 1 (1 = no "
                             "aggregation, flat worker→shard)")
        if self.agg_flush_timeout_ms < 1:
            raise ValueError("agg_flush_timeout_ms must be >= 1")
        if self.compress not in (None, "none", "cast16", "int8", "topk"):
            raise ValueError(
                f"unknown compress codec {self.compress!r}; use 'none', "
                "'cast16', 'int8' or 'topk'"
            )
        if not (0.0 < self.compress_topk <= 1.0):
            raise ValueError(
                f"compress_topk {self.compress_topk} outside (0, 1]"
            )
        if self.compress_min_bytes < 0:
            raise ValueError("compress_min_bytes must be >= 0")
        if self.compress_pull and self.compress == "topk":
            raise ValueError(
                "compress_pull cannot use topk (error-feedback residuals "
                "live at the sender); use cast16 or int8"
            )
        if self.shm_bytes < (1 << 16):
            raise ValueError(
                f"shm_bytes {self.shm_bytes} too small: the ring needs at "
                f"least 64 KiB per direction to be worth negotiating"
            )
        if not (1 <= self.van_loop_threads <= 64):
            raise ValueError(
                f"van_loop_threads {self.van_loop_threads} outside [1, 64] "
                f"(the native loop's thread-pool bound)"
            )
        if self.native_read_cache_bytes < 0:
            raise ValueError("native_read_cache_bytes must be >= 0 "
                             "(0 disables the native read cache)")
        if self.nl_slow_frame_ms < 0:
            raise ValueError("nl_slow_frame_ms must be >= 0 "
                             "(0 disarms the slow-frame watchdog)")
        if self.read_staleness < 0:
            raise ValueError("read_staleness must be >= 0 versions")
        if self.push_native_admit not in ("off", "on", "auto"):
            raise ValueError(
                f"unknown push_native_admit mode "
                f"{self.push_native_admit!r}; use 'off', 'on' or 'auto'"
            )
        if self.fused_apply not in ("auto", "off", "torch", "cuda"):
            raise ValueError(
                f"unknown fused_apply tier {self.fused_apply!r}; use "
                "'off', 'torch', 'cuda' or 'auto'"
            )
        if self.embed_device_rows < 0:
            raise ValueError("embed_device_rows must be >= 0 (0 = "
                             "unlimited, no tiering)")
        if self.embed_admit_freq < 1:
            raise ValueError("embed_admit_freq must be >= 1")
        if self.embed_evict_ttl_ms < 0:
            raise ValueError("embed_evict_ttl_ms must be >= 0 (0 = "
                             "TTL off)")
        if self.connect_max_wait_ms < 0:
            raise ValueError("connect_max_wait_ms must be >= 0")
        if self.agg_probe_max_wait_ms < 0:
            raise ValueError("agg_probe_max_wait_ms must be >= 0")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1 (1 = no replication)")
        if self.replica_ack not in ("sync", "async"):
            raise ValueError(
                f"unknown replica_ack {self.replica_ack!r}; use 'sync' "
                "(bitwise promotion) or 'async' (bounded lag)"
            )
        if self.replica_window < 1:
            raise ValueError("replica_window must be >= 1")
        if self.failover_timeout_ms < 1:
            raise ValueError("failover_timeout_ms must be >= 1")
        if self.rebalance_max_skew < 1.0:
            raise ValueError(
                f"rebalance_max_skew {self.rebalance_max_skew} < 1: the "
                f"max/min byte ratio across shards is never below 1"
            )
        if self.rebalance_report_ms < 1:
            raise ValueError("rebalance_report_ms must be >= 1")
        if self.telemetry_window_s <= 0:
            raise ValueError("telemetry_window_s must be > 0")
        if self.telemetry_ring < 2:
            raise ValueError("telemetry_ring must be >= 2 (a window "
                             "needs a baseline sample)")
        if self.telemetry_straggler_z <= 0:
            raise ValueError("telemetry_straggler_z must be > 0")
        if self.slo_rules:
            from ps_tpu_torch.obs.slo import parse_rules

            parse_rules(self.slo_rules)  # a bad rule fails here, loudly
        if self.freshness_slo <= 0:
            raise ValueError("freshness_slo must be > 0 (seconds — the "
                             "age bound a served read is judged against)")
        if self.policy not in ("off", "dry", "on"):
            raise ValueError(
                f"policy {self.policy!r} is not one of off/dry/on")
        if self.policy_cooldown_s < 0:
            raise ValueError("policy_cooldown_s must be >= 0")
        if self.policy_burn_windows < 1:
            raise ValueError("policy_burn_windows must be >= 1 (a rule "
                             "fires on at least one sustained window)")
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError(
                f"trace_sample {self.trace_sample} outside [0, 1]")
        if self.metrics_port is not None and self.metrics_port < 0:
            raise ValueError("metrics_port must be >= 0 (0 = ephemeral) "
                             "or None (no endpoint)")
        if self.flight_events < 1:
            raise ValueError("flight_events must be >= 1")

    def apply_obs(self) -> None:
        """Push the observability knobs into the process-global obs
        singletons (the tracer's sample rate, the dump directory, the
        flight ring's size) and start the /metrics endpoint when
        ``metrics_port`` is set; a launcher calls this once after building
        the Config."""
        from ps_tpu_torch import obs

        obs.configure(sample=self.trace_sample, trace_dir=self.trace_dir,
                      flight_events=self.flight_events,
                      metrics_port=self.metrics_port)

    def compress_spec(self) -> Optional[dict]:
        """The normalized codec spec dict workers pass to
        ``connect_async``/``connect_sparse`` (None when compression is off).
        """
        if self.compress in (None, "none"):
            return None
        return {
            "codec": self.compress,
            "topk": self.compress_topk,
            "min_bytes": self.compress_min_bytes,
            "pull": self.compress_pull,
        }

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build a Config from PS_* (and DMLC_* alias) environment variables."""
        env = os.environ
        kwargs = {}
        if "PS_BACKEND" in env:
            kwargs["backend"] = env["PS_BACKEND"]
        if "PS_NUM_WORKERS" in env:
            kwargs["num_workers"] = int(env["PS_NUM_WORKERS"])
        elif "DMLC_NUM_WORKER" in env:
            kwargs["num_workers"] = int(env["DMLC_NUM_WORKER"])
        if "PS_COORDINATOR_URI" in env:
            kwargs["coordinator_uri"] = env["PS_COORDINATOR_URI"]
        elif "DMLC_PS_ROOT_URI" in env and "DMLC_PS_ROOT_PORT" in env:
            kwargs["coordinator_uri"] = (
                f"{env['DMLC_PS_ROOT_URI']}:{env['DMLC_PS_ROOT_PORT']}"
            )
        if "PS_NUM_PROCESSES" in env:
            kwargs["num_processes"] = int(env["PS_NUM_PROCESSES"])
        if "PS_PROCESS_ID" in env:
            kwargs["process_id"] = int(env["PS_PROCESS_ID"])
        if "PS_DIST_BACKEND" in env:  # pslint: disable=PSL404 -- the port's own knob, documented in this module's docstring: the README is shared with the reference, whose gate (PSL405) refuses a documented knob its code does not read
            kwargs["dist_backend"] = env["PS_DIST_BACKEND"]
        if "PS_MODE" in env:
            kwargs["mode"] = env["PS_MODE"]
        if "PS_DC_LAMBDA" in env:
            kwargs["dc_lambda"] = float(env["PS_DC_LAMBDA"])
        if "PS_SEED" in env:
            kwargs["seed"] = int(env["PS_SEED"])
        if "PS_ROLE" in env:
            kwargs["role"] = env["PS_ROLE"]
        elif "DMLC_ROLE" in env:
            kwargs["role"] = env["DMLC_ROLE"]
        if "PS_SERVER_URIS" in env:
            kwargs["server_uris"] = env["PS_SERVER_URIS"]
        elif "PS_ASYNC_SERVER_URI" in env:
            kwargs["server_uris"] = env["PS_ASYNC_SERVER_URI"]
        if "PS_WORKER_ID" in env:
            kwargs["worker_id"] = int(env["PS_WORKER_ID"])
        if "PS_SHARD" in env:
            kwargs["shard"] = int(env["PS_SHARD"])
        if "PS_NUM_SHARDS" in env:
            kwargs["num_shards"] = int(env["PS_NUM_SHARDS"])
        elif "DMLC_NUM_SERVER" in env and int(env["DMLC_NUM_SERVER"]) > 1:
            # the reference's N servers = our N-shard key partition; the
            # shard index still needs PS_SHARD (DMLC assigns it via the
            # scheduler, which has no equivalent here)
            kwargs["num_shards"] = int(env["DMLC_NUM_SERVER"])
        if "PS_BUCKET_BYTES" in env:
            # "0" / "" explicitly selects the serial transport
            bb = int(env["PS_BUCKET_BYTES"] or 0)
            kwargs["bucket_bytes"] = bb if bb > 0 else None
        if "PS_TRANSPORT_POOL" in env:
            kwargs["transport_pool"] = int(env["PS_TRANSPORT_POOL"])
        if "PS_BUCKET_PRIORITY" in env:
            kwargs["bucket_priority"] = env_flag("PS_BUCKET_PRIORITY", True)
        if "PS_AGG_GROUP_SIZE" in env:
            kwargs["agg_group_size"] = int(env["PS_AGG_GROUP_SIZE"])
        if "PS_AGG_FLUSH_TIMEOUT_MS" in env:
            # float, matching the service-level env_float read — the two
            # parsers of one knob must accept the same values
            kwargs["agg_flush_timeout_ms"] = float(
                env["PS_AGG_FLUSH_TIMEOUT_MS"])
        if "PS_COMPRESS" in env:
            # "" / "none" explicitly selects the raw wire
            kwargs["compress"] = env["PS_COMPRESS"] or None
            if kwargs["compress"] == "none":
                kwargs["compress"] = None
        if "PS_COMPRESS_TOPK" in env:
            kwargs["compress_topk"] = float(env["PS_COMPRESS_TOPK"])
        if "PS_COMPRESS_MIN_BYTES" in env:
            kwargs["compress_min_bytes"] = int(env["PS_COMPRESS_MIN_BYTES"])
        if "PS_COMPRESS_PULL" in env:
            kwargs["compress_pull"] = env_flag("PS_COMPRESS_PULL", False)
        if "PS_WRITEV" in env:
            kwargs["writev"] = env_flag("PS_WRITEV", True)
        if "PS_SHM" in env:
            kwargs["shm"] = env_flag("PS_SHM", False)
        if "PS_SHM_BYTES" in env:
            kwargs["shm_bytes"] = int(env["PS_SHM_BYTES"])
        if "PS_VAN_NATIVE_LOOP" in env:
            kwargs["van_native_loop"] = env_flag("PS_VAN_NATIVE_LOOP", False)
        if "PS_VAN_LOOP_THREADS" in env:
            kwargs["van_loop_threads"] = int(env["PS_VAN_LOOP_THREADS"])
        if "PS_NATIVE_READ_CACHE_BYTES" in env:
            # "0" explicitly disables the native read cache
            kwargs["native_read_cache_bytes"] = int(
                env["PS_NATIVE_READ_CACHE_BYTES"] or 0)
        if "PS_READ_STALENESS" in env:
            kwargs["read_staleness"] = int(env["PS_READ_STALENESS"])
        if "PS_NL_STATS" in env:
            kwargs["nl_stats"] = env_flag("PS_NL_STATS", True)
        if "PS_NL_SLOW_FRAME_MS" in env:
            # float, matching the service-level env_float read — the two
            # parsers of one knob must accept the same values
            kwargs["nl_slow_frame_ms"] = float(env["PS_NL_SLOW_FRAME_MS"])
        if "PS_PULL_CACHE" in env:
            kwargs["pull_cache"] = env_flag("PS_PULL_CACHE", False)
        if "PS_READ_CONDITIONAL" in env:
            kwargs["read_conditional"] = env_flag(
                "PS_READ_CONDITIONAL", True)
        if "PS_PUSH_NATIVE_ADMIT" in env:
            # "" explicitly selects the auto default
            kwargs["push_native_admit"] = (
                env["PS_PUSH_NATIVE_ADMIT"].strip().lower() or "auto")
        if "PS_FUSED_APPLY" in env:
            # "" explicitly selects the auto detection
            kwargs["fused_apply"] = env["PS_FUSED_APPLY"].strip() or "auto"
        if "PS_EMBED_DEVICE_ROWS" in env:
            kwargs["embed_device_rows"] = env_int(
                "PS_EMBED_DEVICE_ROWS", 0, lo=0)
        if "PS_EMBED_ADMIT_FREQ" in env:
            kwargs["embed_admit_freq"] = env_int(
                "PS_EMBED_ADMIT_FREQ", 2, lo=1)
        if "PS_EMBED_EVICT_TTL_MS" in env:
            kwargs["embed_evict_ttl_ms"] = env_int(
                "PS_EMBED_EVICT_TTL_MS", 0, lo=0)
        if "PS_EMBED_PREFETCH" in env:
            kwargs["embed_prefetch"] = env_flag("PS_EMBED_PREFETCH", False)
        if "PS_CONNECT_MAX_WAIT_MS" in env:
            kwargs["connect_max_wait_ms"] = int(env["PS_CONNECT_MAX_WAIT_MS"])
        if "PS_AGG_PROBE_MAX_WAIT_MS" in env:
            kwargs["agg_probe_max_wait_ms"] = int(
                env["PS_AGG_PROBE_MAX_WAIT_MS"])
        if "PS_CKPT_ROOT" in env:
            kwargs["ckpt_root"] = env["PS_CKPT_ROOT"] or None
        if "PS_REPLICAS" in env:
            kwargs["replicas"] = int(env["PS_REPLICAS"])
        if "PS_REPLICA_ACK" in env:
            kwargs["replica_ack"] = env["PS_REPLICA_ACK"]
        if "PS_REPLICA_WINDOW" in env:
            kwargs["replica_window"] = int(env["PS_REPLICA_WINDOW"])
        if "PS_FAILOVER_TIMEOUT_MS" in env:
            kwargs["failover_timeout_ms"] = int(env["PS_FAILOVER_TIMEOUT_MS"])
        if "PS_COORD_URI" in env:
            # "" explicitly selects the static topology
            kwargs["coord_uri"] = env["PS_COORD_URI"] or None
        if "PS_REBALANCE_AUTO" in env:
            kwargs["rebalance_auto"] = env_flag("PS_REBALANCE_AUTO", False)
        if "PS_REBALANCE_MAX_SKEW" in env:
            kwargs["rebalance_max_skew"] = float(env["PS_REBALANCE_MAX_SKEW"])
        if "PS_REBALANCE_REPORT_MS" in env:
            kwargs["rebalance_report_ms"] = int(env["PS_REBALANCE_REPORT_MS"])
        if "PS_TELEMETRY" in env:
            kwargs["telemetry"] = env_flag("PS_TELEMETRY", True)
        if "PS_TELEMETRY_WINDOW_S" in env:
            kwargs["telemetry_window_s"] = float(
                env["PS_TELEMETRY_WINDOW_S"])
        if "PS_TELEMETRY_RING" in env:
            kwargs["telemetry_ring"] = int(env["PS_TELEMETRY_RING"])
        if "PS_TELEMETRY_STRAGGLER_Z" in env:
            kwargs["telemetry_straggler_z"] = float(
                env["PS_TELEMETRY_STRAGGLER_Z"])
        if "PS_SLO_RULES" in env:
            # "" explicitly selects no rules
            kwargs["slo_rules"] = env["PS_SLO_RULES"] or None
        if "PS_FRESHNESS_SLO" in env:
            # float seconds, matching the service-level env_float reads
            kwargs["freshness_slo"] = env_float(
                "PS_FRESHNESS_SLO", 0.5, lo=1e-3)
        if "PS_POLICY" in env:
            # "" explicitly selects off; the mode set is validated in
            # __post_init__ (a typo'd mode fails loudly at config time)
            kwargs["policy"] = env["PS_POLICY"].strip().lower() or "off"
        if "PS_POLICY_COOLDOWN_S" in env:
            kwargs["policy_cooldown_s"] = float(env["PS_POLICY_COOLDOWN_S"])
        if "PS_POLICY_BURN_WINDOWS" in env:
            kwargs["policy_burn_windows"] = int(env["PS_POLICY_BURN_WINDOWS"])
        if "PS_CHAOS_SEED" in env:
            kwargs["chaos_seed"] = int(env["PS_CHAOS_SEED"] or 0)
        if "PS_TRACE_SAMPLE" in env:
            kwargs["trace_sample"] = float(env["PS_TRACE_SAMPLE"] or 0)
        if "PS_TRACE_DIR" in env:
            kwargs["trace_dir"] = env["PS_TRACE_DIR"] or None
        if "PS_METRICS_PORT" in env:
            # "" explicitly selects no endpoint
            kwargs["metrics_port"] = (int(env["PS_METRICS_PORT"])
                                      if env["PS_METRICS_PORT"].strip()
                                      else None)
        if "PS_FLIGHT_EVENTS" in env:
            kwargs["flight_events"] = int(env["PS_FLIGHT_EVENTS"])
        if "PS_HEARTBEAT_BASE_PORT" in env:
            kwargs["heartbeat_base_port"] = int(env["PS_HEARTBEAT_BASE_PORT"])
        if "PS_PEER_HOSTS" in env:
            kwargs["peer_hosts"] = env["PS_PEER_HOSTS"]
        if "PS_HEARTBEAT_BIND" in env:
            kwargs["heartbeat_bind"] = env["PS_HEARTBEAT_BIND"]
        if "PS_HEARTBEAT_INTERVAL_MS" in env:
            kwargs["heartbeat_interval_ms"] = int(env["PS_HEARTBEAT_INTERVAL_MS"])
        if "PS_HEARTBEAT_TIMEOUT_MS" in env:
            kwargs["heartbeat_timeout_ms"] = int(env["PS_HEARTBEAT_TIMEOUT_MS"])
        kwargs.update(overrides)
        return cls(**kwargs)
