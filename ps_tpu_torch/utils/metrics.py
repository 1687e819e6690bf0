"""One training run's throughput and byte metrics, the van transport's
counters and latency histograms, and a rate meter.

Counterpart of ``ps_tpu/utils/metrics.py``: ``Meter``, ``TrainMetrics``
and ``TransportStats`` with the codec, shared-memory lane, native serve
loop, replication, failover, read-path, two-level aggregation and
freshness counters. Every latency lands in a log2-bucket
:class:`~ps_tpu_torch.obs.metrics.Histogram` registered into the process
registry under the reference's name (``TransportStats.HIST_NAMES``), so
/metrics, the STATS reply's ``metrics.lat`` and ``tools/ps_top.py`` read
the port as they read the reference.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, Optional

from ps_tpu_torch.obs.metrics import Histogram, default_registry


class Meter:
    """Sliding-window rate meter: ``update(n)`` an event, ``rate()`` in
    n a second. The window bounds staleness and memory; the first sample
    opens the window, so an early rate is not inflated by an empty
    history."""

    def __init__(self, window: int = 64):
        self._events: Deque = collections.deque(maxlen=window)

    def update(self, n: float = 1.0, t: Optional[float] = None) -> None:
        self._events.append((time.monotonic() if t is None else t, float(n)))

    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        if dt <= 0:
            return 0.0
        # the first sample opens the window; its count predates it
        return sum(n for _, n in list(self._events)[1:]) / dt

    def reset(self) -> None:
        self._events.clear()


class TransportStats:
    """Accounting for the van transport, under the reference's names.

    The bucketed workers record one ``record_bucket`` per request/reply
    round (wire bytes both ways and its latency), one ``record_cycle`` per
    background push-then-pull cycle (its wall time) and one
    ``record_blocked`` per caller wait; the summary's
    ``overlap_efficiency`` is the share of transport time hidden under
    compute. Servers record stale epochs
    (an abandoned multi-bucket push dropped whole) and dedup hits (a
    replayed push acked without an apply); both sides record vectored
    sends and receive-pool hits. The port adds ``record_staging``: the
    bytes and seconds of the copies between the card and pinned host
    memory that every CUDA tensor crossing the van takes. A sparse server
    records each committed push's apply (``record_apply``, lock wait
    included), its row apply alone (``record_sparse_apply``, with the raw
    rows it landed) and its push-to-servable lag (``record_fresh_lag``),
    under the reference's ``apply_s``, ``sparse_apply_s`` and
    ``fresh_lag_s`` latency names; a tiered table's cold passes, drained
    after the push commits, go under ``cold_gather_s``
    (``record_cold_gather``, ``ps_embed_cold_gather_seconds``).

    The read path: a server counts the READs it answered in Python
    (``record_read_served``), its NOT_MODIFIED replies and delta rows,
    and the native read cache's counters (``set_read_cache_stats``); a
    worker its cache hits and wire reads, coalesced waiters, replica
    reads and staleness-bound fallbacks with their version gaps
    (``read_gap_v``). Both record each serve's data age
    (``record_read_age``, ``read_age_s``), which :meth:`fresh_snapshot`
    summarizes for STATS.

    Each latency is one histogram of :attr:`HIST_NAMES`, registered into
    the process registry (instances of one name merge there). A harness
    that wants the raw samples too sets :attr:`listener`, a callable
    given ``(key, value)`` at every record.
    """

    #: ``(key, Prometheus name, help)`` of every latency distribution, the
    #: reference's list: client ops, fusion-bucket rounds, caller waits,
    #: sync replica acks, failover re-routes, the server's apply and row
    #: apply, the native loop's upcall batches and in-loop histograms, the
    #: aggregator's hold, the tiered cold pass, and the freshness plane
    HIST_NAMES = (
        ("push_s", "ps_push_seconds", "client push op latency"),
        ("pull_s", "ps_pull_seconds", "client pull op latency"),
        ("read_s", "ps_read_seconds",
         "client read (side-effect-free pull) op latency"),
        ("push_pull_s", "ps_push_pull_seconds",
         "client push_pull cycle latency"),
        ("cycle_s", "ps_cycle_seconds",
         "background push->pull transport cycle (push_pull_async)"),
        ("bucket_s", "ps_bucket_seconds",
         "one fusion-bucket request/reply round"),
        ("blocked_s", "ps_blocked_seconds",
         "caller waits on the flush barrier / pending cycles"),
        ("repl_ack_wait_s", "ps_replica_ack_wait_seconds",
         "serve-thread waits on the sync replica ack"),
        ("failover_s", "ps_failover_seconds",
         "worker shard re-routes to a promoted replica"),
        ("apply_s", "ps_server_apply_seconds",
         "server engine apply of one committed push (lock held)"),
        ("sparse_apply_s", "ps_sparse_apply_seconds",
         "server sparse row apply (gather->apply->scatter), per push"),
        ("upcall_batch", "ps_van_upcall_batch",
         "requests handed to Python per native-loop upcall"),
        ("agg_hold_s", "ps_agg_hold_seconds",
         "member pushes held at the aggregator until the merged "
         "upstream flush commits"),
        ("nl_read_frame_s", "ps_nl_read_frame_seconds",
         "native loop frame read latency (first byte to frame complete)"),
        ("nl_queue_wait_s", "ps_nl_queue_wait_seconds",
         "native loop ready-queue wait (frame complete to pump claim)"),
        ("nl_read_hit_s", "ps_nl_read_hit_seconds",
         "native READ-hit service time (frame complete to reply "
         "written, zero upcalls)"),
        ("nl_flush_s", "ps_nl_flush_seconds",
         "native loop staged-tail EPOLLOUT flush latency (writev "
         "stall to drain complete)"),
        ("cold_gather_s", "ps_embed_cold_gather_seconds",
         "tiered embedding cold-tier gather->apply->scatter, per push"),
        ("read_age_s", "ps_read_staleness_seconds",
         "data age at serve time (now - version birth), any tier"),
        ("fresh_lag_s", "ps_freshness_lag_seconds",
         "push -> first-servable lag at the primary's apply"),
        ("read_gap_v", "ps_read_refused_version_gap",
         "version gap of replica reads refused by the staleness bound"),
    )

    def __init__(self, window: int = 256):
        reg = default_registry()
        self.hist: Dict[str, Histogram] = {}
        for key, prom, help_ in self.HIST_NAMES:
            h = Histogram(prom, help_)
            self.hist[key] = h
            reg.register(h)
        self.listener: Optional[Callable[[str, float], None]] = None
        self._lock = threading.Lock()
        self._bucket_window: Deque = collections.deque(maxlen=window)
        self.buckets = 0
        self.bucket_bytes = 0
        self.bucket_seconds = 0.0
        self.cycles = 0
        self.busy_s = 0.0      # wall time background transport was active
        self.blocked_s = 0.0   # time callers spent blocked on wait()/flush()
        self.stale_epochs = 0
        self.stale_epoch_buckets = 0
        self.vec_frames = 0
        self.vec_bytes_avoided = 0
        self.pool_hits = 0
        self.pool_misses = 0
        self.dedup_hits = 0
        self.staging_bytes = 0
        self.staging_s = 0.0
        self.sparse_rows_applied = 0
        # gradient codecs (compress/): payload bytes before and after, the
        # seconds spent coding, topk's latest residual norm
        self.codec_raw_bytes = 0
        self.codec_enc_bytes = 0
        self.codec_s = 0.0
        self.residual_norm = 0.0
        # the shared-memory lane: ring frames (either way) and their bytes,
        # frames too big for the ring that went over TCP, and the ring
        # waits' wakeups found spinning or after sleeping
        self.shm_frames = 0
        self.shm_frame_bytes = 0
        self.shm_spill_frames = 0
        self.spin_wakeups = 0
        self.sleep_wakeups = 0
        # the native serve loop: frames read, live connections and slow
        # frames (absolute values synced from its counters by the pump),
        # the pump's batched upcalls and the pushes it dispatched, and
        # native push admission's acks, refusals, fresh stamps and punts
        self.loop_requests = 0
        self.loop_conns = 0
        self.loop_upcalls = 0
        self.loop_pushes = 0
        self.nl_slow_frames = 0
        self.push_native_acks = 0
        self.push_native_refusals = 0
        self.push_native_fresh = 0
        self.push_native_punts = 0
        # shard replication (replica/): entries and bytes the backup acked,
        # time serve threads waited for sync acks, the backup's lag (a
        # gauge), whether the stream degraded (the primary goes on
        # unreplicated), and the worker side's failover re-routes
        self.repl_entries = 0
        self.repl_bytes = 0
        self.repl_ack_wait_s = 0.0
        self.repl_lag = 0
        self.repl_degraded = False
        self.failovers = 0
        self.failover_s = 0.0
        # the read path: READs answered in Python; the native cache's hits,
        # misses, version-floor hits, entries and bytes (absolute values
        # synced by the pump); the worker's cache hits, wire reads,
        # coalesced waiters, replica-served reads and staleness-bound
        # fallbacks; NOT_MODIFIED replies and delta rows served
        self.reads_served = 0
        self.read_native_hits = 0
        self.read_native_misses = 0
        self.read_native_cond_hits = 0
        self.read_cache_entries = 0
        self.read_cache_bytes = 0
        self.read_cache_hits = 0
        self.read_wire = 0
        self.read_coalesced = 0
        self.reads_replica = 0
        self.read_fallbacks = 0
        self.read_not_modified = 0
        self.read_delta_rows = 0
        # the freshness plane: serves that recorded an age, those within
        # the bound, negative ages clamped, the age sources and, per
        # serving tier, [count, max age]
        self.reads_aged = 0
        self.reads_fresh = 0
        self.fresh_clock_clamped = 0
        self.fresh_src: Dict[str, int] = {"mono": 0, "sync": 0, "wall": 0}
        self.fresh_tiers: Dict[str, list] = {}
        # two-level aggregation (backends/aggregator.py): merged upstream
        # flushes, the constituent pushes merged into them (their ratio is
        # the realized local fan-in), and worker-side aggregator-loss
        # degrades to the flat topology
        self.agg_rounds = 0
        self.agg_members = 0
        self.agg_degrades = 0
        # the read path's and the freshness plane's counter families
        self._c_read_nm = reg.counter(
            "ps_read_not_modified_total",
            "conditional READs answered NOT_MODIFIED (stamp only)")
        self._c_read_delta = reg.counter(
            "ps_read_delta_rows_total",
            "changed rows shipped as conditional-read deltas")
        self._c_fresh_clamped = reg.counter(
            "ps_freshness_clock_clamped_total",
            "negative cross-process data ages clamped to zero (skew)")

    def _observe(self, key: str, value: float) -> None:
        self.hist[key].record(value)
        fn = self.listener
        if fn is not None:
            fn(key, float(value))

    def record_op(self, name: str, seconds: float) -> None:
        """One client-side logical transport op (``push``/``pull``/
        ``push_pull``/``read``/``cycle``) end to end; a name without a
        histogram is ignored, as in the reference."""
        if name + "_s" in self.hist:
            self._observe(name + "_s", seconds)

    def latency_quantiles(self) -> Dict[str, dict]:
        """``{name: {count, mean, p50, p99, p999, max}}`` of every
        histogram that recorded at least once (the STATS reply's
        ``metrics.lat``, what ``ps_top`` renders)."""
        out: Dict[str, dict] = {}
        for k, h in self.hist.items():
            s = h.summary()
            if s is not None:
                out[k] = s
        return out

    def record_apply(self, seconds: float) -> None:
        """One server-side apply of a committed push, end to end (lock
        acquisition included: contention is apply-path latency)."""
        self.record_op("apply", seconds)

    def record_sparse_apply(self, rows: int, seconds: float) -> None:
        """One sparse row apply: ``rows`` raw row updates landed in
        ``seconds`` (the apply alone, lock wait excluded: that lives in
        ``apply_s``)."""
        self.record_op("sparse_apply", seconds)
        with self._lock:
            self.sparse_rows_applied += int(rows)

    def record_cold_gather(self, seconds: float) -> None:
        """One tiered table's cold pass (dedupe, arena gather, apply,
        scatter back), drained from the table after the push commits
        (``TieredTable.drain_cold_gather``)."""
        self._observe("cold_gather_s", seconds)

    def record_fresh_lag(self, seconds: float) -> None:
        """Server side: one apply's push-to-first-servable lag (from the
        push's arrival at the apply to the moment the lock is released
        and a pull sees it)."""
        self.record_op("fresh_lag", seconds)

    def record_repl_entry(self, nbytes: int) -> None:
        """One replication-log entry acked by the backup (wire bytes)."""
        with self._lock:
            self.repl_entries += 1
            self.repl_bytes += int(nbytes)

    def record_repl_ack_wait(self, seconds: float) -> None:
        """Time one serve thread spent blocked on a sync replica ack."""
        self.record_op("repl_ack_wait", seconds)
        with self._lock:
            self.repl_ack_wait_s += float(seconds)

    def set_repl_lag(self, lag: int) -> None:
        with self._lock:
            self.repl_lag = int(lag)

    def set_repl_degraded(self) -> None:
        with self._lock:
            self.repl_degraded = True

    def record_failover(self, seconds: float) -> None:
        """One worker-side shard re-route to a promoted replica."""
        self.record_op("failover", seconds)
        with self._lock:
            self.failovers += 1
            self.failover_s += float(seconds)

    def record_agg_round(self, members: int) -> None:
        """One merged upstream flush at an aggregator (``members``
        constituent pushes pre-reduced into it: the local fan-in the
        upstream bytes shrink by)."""
        with self._lock:
            self.agg_rounds += 1
            self.agg_members += int(members)

    def record_agg_hold(self, seconds: float) -> None:
        """How long one member's push was held at the aggregator, from its
        arrival to the merged upstream commit (``agg_hold_s``)."""
        self._observe("agg_hold_s", seconds)

    def record_agg_degrade(self) -> None:
        """One worker-side aggregator loss: a degrade to the flat
        topology."""
        with self._lock:
            self.agg_degrades += 1

    def record_vec_send(self, nbytes: int) -> None:
        """One vectored send: ``nbytes`` of tensor payload went to the
        kernel without a staging copy."""
        with self._lock:
            self.vec_frames += 1
            self.vec_bytes_avoided += int(nbytes)

    def record_shm_frame(self, nbytes: int) -> None:
        """One frame moved through a shared-memory ring (either way)."""
        with self._lock:
            self.shm_frames += 1
            self.shm_frame_bytes += int(nbytes)

    def record_shm_spill(self) -> None:
        """One frame too large for the ring traveled TCP instead."""
        with self._lock:
            self.shm_spill_frames += 1

    def record_wakeup(self, spun: bool) -> None:
        """One ring wait that found its frame spinning (``spun``) or only
        after backing off to sleep."""
        with self._lock:
            if spun:
                self.spin_wakeups += 1
            else:
                self.sleep_wakeups += 1

    def lane(self) -> str:
        """The data plane this endpoint's traffic used: "shm" (rings
        only), "shm+tcp" (a negotiated lane whose oversize frames spilled
        to TCP) or "tcp"."""
        with self._lock:
            if self.shm_spill_frames > 0:
                return "shm+tcp"
            return "shm" if self.shm_frames > 0 else "tcp"

    def record_codec(self, raw_bytes: int, enc_bytes: int,
                     seconds: float) -> None:
        """One codec pass over a tree (encode or decode side)."""
        with self._lock:
            self.codec_raw_bytes += int(raw_bytes)
            self.codec_enc_bytes += int(enc_bytes)
            self.codec_s += float(seconds)

    def record_residual_norm(self, norm: float) -> None:
        with self._lock:
            self.residual_norm = float(norm)

    def compress_ratio(self) -> Optional[float]:
        """Raw over encoded bytes of everything the codecs touched (None
        until a codec ran)."""
        with self._lock:
            if self.codec_enc_bytes <= 0:
                return None
            return self.codec_raw_bytes / self.codec_enc_bytes

    def record_upcall(self, batch: int) -> None:
        """One native-loop poll that handed ``batch`` requests to Python."""
        self._observe("upcall_batch", batch)
        with self._lock:
            self.loop_upcalls += 1

    def record_loop_push(self) -> None:
        """One push (a commit kind) the native loop's pump dispatched."""
        with self._lock:
            self.loop_pushes += 1

    def set_loop_stats(self, requests: int, conns: int) -> None:
        """The native loop's frame count and connection gauge."""
        with self._lock:
            self.loop_requests = int(requests)
            self.loop_conns = int(conns)

    def set_admit_stats(self, acks: int, refusals: int, fresh: int,
                        punts: int) -> None:
        """Native push admission's counters (absolute values)."""
        with self._lock:
            self.push_native_acks = int(acks)
            self.push_native_refusals = int(refusals)
            self.push_native_fresh = int(fresh)
            self.push_native_punts = int(punts)

    def set_nl_hists(self, states: Dict[str, dict]) -> None:
        """Overwrite the in-loop histograms with the loop's raw states; a
        state whose geometry differs from the registered histogram's is
        skipped rather than mis-bucketed."""
        for key, st in states.items():
            h = self.hist.get(key)
            if h is None or len(st["c"]) != len(h.counts) \
                    or (st["lo"], st["hi"]) != (h.lo, h.hi):
                continue
            h.counts = [int(c) for c in st["c"]]
            h.total = int(st["n"])
            h.sum = float(st["s"])
            h.vmax = float(st["mx"])
            mn = st.get("mn")
            h.vmin = float("inf") if mn is None else float(mn)

    def set_nl_slow_frames(self, slow_frames: int) -> None:
        """The loop's count of frames over its slow-frame threshold."""
        with self._lock:
            self.nl_slow_frames = int(slow_frames)

    # -- the read path -----------------------------------------------------------

    def record_read_served(self) -> None:
        """Server side: one READ answered in Python (the pump, a native
        cache miss, or a serve thread)."""
        with self._lock:
            self.reads_served += 1

    def set_read_cache_stats(self, hits: int, misses: int, entries: int,
                             nbytes: int, cond_hits: int = 0) -> None:
        """The native read cache's counters (absolute values: the native
        side owns the counting). ``cond_hits`` are the hits served from a
        version-floor (NOT_MODIFIED) entry."""
        with self._lock:
            self.read_native_hits = int(hits)
            self.read_native_misses = int(misses)
            self.read_cache_entries = int(entries)
            self.read_cache_bytes = int(nbytes)
            self.read_native_cond_hits = int(cond_hits)

    def record_read_cache(self, hit: bool) -> None:
        """Worker side: one read served from the local parameter cache
        (``hit``) or one that needed a wire fetch."""
        with self._lock:
            if hit:
                self.read_cache_hits += 1
            else:
                self.read_wire += 1

    def record_read_coalesced(self) -> None:
        """Worker side: one reader shared another caller's in-flight
        fetch instead of issuing its own."""
        with self._lock:
            self.read_coalesced += 1

    def record_read_route(self, replica: bool) -> None:
        """Worker side: one wire read served by a replica (``replica``)
        or by the primary."""
        with self._lock:
            if replica:
                self.reads_replica += 1

    def record_read_fallback(self) -> None:
        """Worker side: a replica's reply was past the staleness bound and
        the read went on toward the primary."""
        with self._lock:
            self.read_fallbacks += 1

    def record_read_gap(self, versions: int) -> None:
        """Worker side: how many versions a refused replica reply trailed
        the newest known one (``read_gap_v``)."""
        self._observe("read_gap_v", float(versions))

    def record_read_not_modified(self) -> None:
        """Server side: one conditional READ answered NOT_MODIFIED."""
        self._c_read_nm.inc()
        with self._lock:
            self.read_not_modified += 1

    def record_read_delta_rows(self, rows: int) -> None:
        """Server side: one conditional sparse READ shipped ``rows``
        changed rows instead of the whole requested id-set."""
        self._c_read_delta.inc(int(rows))
        with self._lock:
            self.read_delta_rows += int(rows)

    def record_read_age(self, seconds: float, src: str = "mono",
                        tier: str = "wire",
                        bound: Optional[float] = None,
                        clamped: bool = False) -> None:
        """One serve's data age (``now - version birth``, resolved by
        ``obs/freshness.age_of``): ``src`` is the clock it came from,
        ``tier`` the serving tier (cache, wire, replica, nm, pump, ...),
        ``bound`` the staleness bound in seconds this endpoint holds
        reads to, ``clamped`` marks a negative age clamped to zero."""
        self._observe("read_age_s", seconds)
        with self._lock:
            self.reads_aged += 1
            if bound is not None and seconds <= bound:
                self.reads_fresh += 1
            if src in self.fresh_src:
                self.fresh_src[src] += 1
            t = self.fresh_tiers.setdefault(tier, [0, 0.0])
            t[0] += 1
            if seconds > t[1]:
                t[1] = float(seconds)
            if clamped:
                self.fresh_clock_clamped += 1
        if clamped:
            self._c_fresh_clamped.inc()

    def fresh_snapshot(self) -> Optional[dict]:
        """The STATS reply's ``fresh`` dict (None until an age or a lag
        was recorded): age and lag quantiles in ms, the share within the
        bound, clamps, the source mix and each tier's count and largest
        age, under the reference's keys."""
        age = self.hist["read_age_s"]
        lag = self.hist["fresh_lag_s"]
        with self._lock:
            aged, within = self.reads_aged, self.reads_fresh
            clamped = self.fresh_clock_clamped
            src = {k: v for k, v in self.fresh_src.items() if v}
            tiers = {t: {"n": int(n), "max_ms": round(mx * 1e3, 3)}
                     for t, (n, mx) in self.fresh_tiers.items()}
        if aged == 0 and lag.total == 0:
            return None
        out: dict = {"aged": int(aged)}
        if age.total > 0:
            out["age_p50_ms"] = round(age.quantile(0.50) * 1e3, 3)
            out["age_p99_ms"] = round(age.quantile(0.99) * 1e3, 3)
        if aged > 0:
            out["within"] = int(within)
            out["fresh_share"] = round(within / aged, 4)
        if lag.total > 0:
            out["lag_p50_ms"] = round(lag.quantile(0.50) * 1e3, 3)
            out["lag_p99_ms"] = round(lag.quantile(0.99) * 1e3, 3)
        if clamped:
            out["clamped"] = int(clamped)
        if src:
            out["src"] = src
        if tiers:
            out["tiers"] = tiers
        return out

    def record_pool(self, hit: bool) -> None:
        """One receive-buffer-pool borrow (reused buffer or fresh one)."""
        with self._lock:
            if hit:
                self.pool_hits += 1
            else:
                self.pool_misses += 1

    def record_dedup_hit(self) -> None:
        """One replayed push acked by its (nonce, seq) token, unapplied."""
        with self._lock:
            self.dedup_hits += 1

    def record_stale_epoch(self, nbuckets: int) -> None:
        """One staged push epoch dropped as stale (``nbuckets`` buckets)."""
        with self._lock:
            self.stale_epochs += 1
            self.stale_epoch_buckets += int(nbuckets)

    def record_bucket(self, nbytes: int, seconds: float) -> None:
        self._observe("bucket_s", seconds)
        with self._lock:
            self.buckets += 1
            self.bucket_bytes += int(nbytes)
            self.bucket_seconds += float(seconds)
            self._bucket_window.append((int(nbytes), float(seconds)))

    def record_cycle(self, busy_s: float) -> None:
        with self._lock:
            self.cycles += 1
            self.busy_s += float(busy_s)

    def record_blocked(self, seconds: float) -> None:
        self._observe("blocked_s", seconds)
        with self._lock:
            self.blocked_s += float(seconds)

    def record_staging(self, nbytes: int, seconds: float) -> None:
        """One staged copy between the card and pinned host memory (a
        tree's tensors, either way), synchronized."""
        with self._lock:
            self.staging_bytes += int(nbytes)
            self.staging_s += float(seconds)

    def bucket_gbps(self) -> float:
        """Recent per-bucket wire rate (window average), GB/s."""
        with self._lock:
            b = sum(n for n, _ in self._bucket_window)
            t = sum(s for _, s in self._bucket_window)
        return b / t / 1e9 if t > 0 else 0.0

    def snapshot(self) -> tuple:
        with self._lock:
            return (self.buckets, self.bucket_bytes, self.bucket_seconds,
                    self.cycles, self.busy_s, self.blocked_s,
                    self.stale_epochs, self.stale_epoch_buckets,
                    self.vec_frames, self.vec_bytes_avoided,
                    self.pool_hits, self.pool_misses, self.dedup_hits,
                    self.staging_bytes, self.staging_s,
                    self.sparse_rows_applied,
                    self.codec_raw_bytes, self.codec_enc_bytes,
                    self.codec_s, self.shm_frames, self.shm_frame_bytes,
                    self.shm_spill_frames, self.spin_wakeups,
                    self.sleep_wakeups, self.agg_rounds, self.agg_members,
                    self.agg_degrades)

    def summary(self, since: Optional[tuple] = None) -> Dict[str, float]:
        """The interval since ``since`` (a :meth:`snapshot`), as the
        reference's summary names it; a counter shows once it moved."""
        now = self.snapshot()
        d = [a - b for a, b in zip(now, since or (0,) * len(now))]
        out: Dict[str, float] = {
            "transport_buckets": int(d[0]),
            "transport_busy_s": round(d[4], 4),
            "transport_blocked_s": round(d[5], 4),
        }
        if d[2] > 0:
            out["bucket_gbps"] = round(d[1] / d[2] / 1e9, 4)
        if d[4] > 0:
            out["overlap_efficiency"] = round(
                max(0.0, min(1.0, 1.0 - d[5] / d[4])), 4)
            out["transport_hidden_s"] = round(max(d[4] - d[5], 0.0), 4)
        if d[6] > 0:
            out["stale_epochs"] = int(d[6])
            out["stale_epoch_buckets"] = int(d[7])
        if d[9] > 0:
            out["staging_copy_bytes_avoided"] = int(d[9])
        if d[10] + d[11] > 0:
            out["recv_pool_hit_rate"] = round(d[10] / (d[10] + d[11]), 4)
        if d[12] > 0:
            out["dedup_hits"] = int(d[12])
        if d[13] > 0:
            out["device_staging_gb"] = round(d[13] / 1e9, 4)
            out["device_staging_s"] = round(d[14], 4)
        if d[15] > 0:
            out["sparse_rows_applied"] = int(d[15])
        if d[17] > 0:  # the codecs ran
            out["compress_ratio"] = round(d[16] / d[17], 4)
            out["codec_s"] = round(d[18], 4)
        if self.residual_norm > 0:
            out["residual_norm"] = round(self.residual_norm, 6)
        if d[19] > 0 or d[21] > 0:
            # the lane of this interval, not of the lifetime
            out["lane"] = "shm+tcp" if d[21] > 0 else "shm"
            out["shm_frames"] = int(d[19])
            out["shm_gb"] = round(d[20] / 1e9, 4)
            if d[21] > 0:
                out["shm_spill_frames"] = int(d[21])
            out["spin_wakeups"] = int(d[22])
            out["sleep_wakeups"] = int(d[23])
        if d[24] > 0:
            # two-level aggregation: rounds, and the realized local fan-in
            # (constituents a merged flush) the upstream bytes shrink by
            out["agg_rounds"] = int(d[24])
            out["agg_fan_in"] = round(d[25] / d[24], 3)
        if d[26] > 0:
            out["agg_degrades"] = int(d[26])
        return out

    def metrics_snapshot(self) -> dict:
        """What a remote poller gets in the STATS reply's ``metrics``: the
        recent bucket rate and the lifetime counters above."""
        out = {"bucket_gbps": round(self.bucket_gbps(), 4),
               **self.summary()}
        lat = self.latency_quantiles()
        if lat:
            out["lat"] = lat
        return out


class TrainMetrics:
    """Aggregates one training run's metrics against a KVStore's counters.

    Usage::

        m = TrainMetrics(store, batch_size=global_batch, num_chips=ndev)
        for batch in data:
            loss, params = run(batch)
            m.step(loss)
        print(m.summary())

    ``step()`` is cheap: it keeps the loss tensor and waits for nothing; the
    loss is converted (a device sync) only in ``summary()``. Time is the
    host's clock, so a caller on the card synchronizes before
    ``summary()``.
    """

    def __init__(self, store=None, batch_size: int = 0, num_chips: int = 1):
        self.store = store
        self.batch_size = batch_size
        self.num_chips = max(num_chips, 1)
        self.steps = 0
        self._timed_from = time.monotonic()
        self._last_loss = None
        self._snapshot_bytes()

    def _snapshot_bytes(self) -> None:
        self._bytes_from = (
            (self.store.bytes_pushed, self.store.bytes_pulled,
             self.store.collective_bytes)
            if self.store is not None else (0, 0, 0)
        )
        ts = getattr(self.store, "transport", None)
        self._transport_from = ts.snapshot() if ts is not None else None

    def mark_compiled(self) -> None:
        """Call after the warm-up step: resets the timed region so the
        warm-up (kernel builds, allocator growth, first launches) does not
        count in the rates."""
        self._timed_from = time.monotonic()
        self._snapshot_bytes()
        self.steps = 0

    def step(self, loss=None) -> None:
        self.steps += 1
        self._last_loss = loss

    def summary(self) -> Dict[str, float]:
        now = time.monotonic()
        dt = max(now - self._timed_from, 1e-9)
        out: Dict[str, float] = {
            "steps": self.steps,
            "wall_s": round(dt, 3),
            "steps_per_sec": round(self.steps / dt, 3),
        }
        if self._last_loss is not None:
            out["loss"] = float(self._last_loss)
        if self.batch_size:
            out["examples_per_sec"] = round(self.steps * self.batch_size / dt, 2)
            out["examples_per_sec_per_chip"] = round(
                self.steps * self.batch_size / dt / self.num_chips, 2
            )
        if self.store is not None:
            p0, q0, c0 = self._bytes_from
            out["push_gb"] = round((self.store.bytes_pushed - p0) / 1e9, 4)
            out["pull_gb"] = round((self.store.bytes_pulled - q0) / 1e9, 4)
            out["push_pull_gbps"] = round(
                (self.store.bytes_pushed - p0 + self.store.bytes_pulled - q0)
                / 1e9 / dt, 4
            )
            out["collective_gb_per_device"] = round(
                (self.store.collective_bytes - c0) / 1e9, 4
            )
            out["collective_gbps_per_device"] = round(
                (self.store.collective_bytes - c0) / 1e9 / dt, 4
            )
            ts = getattr(self.store, "transport", None)
            if ts is not None:
                # a remote worker: the bucket rate, the share of transport
                # hidden under compute and the staging copies
                out.update(ts.summary(since=self._transport_from))
        return out
