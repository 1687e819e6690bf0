"""One training run's throughput and byte metrics, and the van
transport's counters.

Counterpart of ``TrainMetrics`` and the part of ``TransportStats`` in
``ps_tpu/utils/metrics.py`` that the van's serial and bucketed paths and
the STATS reply record. The rest of that module (``Meter``, the log2
latency histograms, the serving, replication and aggregation counters)
belongs to the observability layer and is not ported yet (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional

import numpy as np


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
    ``fresh_lag_s`` latency names.
    """

    def __init__(self, window: int = 256):
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
        # the latest op latencies by name (push, pull, push_pull, cycle):
        # the reference keeps log2 histograms (obs/, not ported yet); a
        # bounded window of samples gives the same quantiles here
        self._op_samples: Dict[str, Deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=4096))

    def record_op(self, name: str, seconds: float) -> None:
        """One client-side logical transport op (``push``/``pull``/
        ``push_pull``/``cycle``) end to end."""
        with self._lock:
            self._op_samples[name].append(float(seconds))

    def op_samples(self, name: str) -> list:
        """The latest latencies (seconds) of op ``name``, oldest first."""
        with self._lock:
            return list(self._op_samples.get(name, ()))

    def latency_quantiles(self) -> Dict[str, dict]:
        """``{name + "_s": {count, mean, p50, p99, max}}`` (seconds) over
        each op's latest samples, as the reference names them."""
        with self._lock:
            samples = {k: list(v) for k, v in self._op_samples.items() if v}
        out = {}
        for name, xs in samples.items():
            a = np.asarray(xs)
            out[name + "_s"] = {
                "count": len(xs), "mean": float(a.mean()),
                "p50": float(np.quantile(a, 0.5)),
                "p99": float(np.quantile(a, 0.99)), "max": float(a.max())}
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

    def record_fresh_lag(self, seconds: float) -> None:
        """Server side: one apply's push-to-first-servable lag (from the
        push's arrival at the apply to the moment the lock is released
        and a pull sees it)."""
        self.record_op("fresh_lag", seconds)

    def record_vec_send(self, nbytes: int) -> None:
        """One vectored send: ``nbytes`` of tensor payload went to the
        kernel without a staging copy."""
        with self._lock:
            self.vec_frames += 1
            self.vec_bytes_avoided += int(nbytes)

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
                    self.sparse_rows_applied)

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
