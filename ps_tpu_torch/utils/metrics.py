"""One training run's throughput and byte metrics.

Counterpart of ``TrainMetrics`` in ``ps_tpu/utils/metrics.py``; the rest of
that module (meters, transport and serving statistics) is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict


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
        return out
