"""Structured per-step training log.

Counterpart of ``ps_tpu/utils/step_log.py``'s ``StepLogger``: fixed-format
console lines every ``every`` steps and an optional JSONL file with every
record. The reference's TensorBoard writer and its out-of-band events
(mirrored into the flight recorder, ``ps_tpu/obs``) are not ported.
"""

from __future__ import annotations

import json
import sys
from typing import IO, Optional


class StepLogger:
    """Prints aligned step lines every ``every`` steps and optionally appends
    every record to a JSONL file.

    Usage::

        log = StepLogger(every=10, jsonl="run.jsonl")
        ...
        log.log(step, loss=float(loss), **metrics.summary())
    """

    def __init__(self, every: int = 10, jsonl: Optional[str] = None,
                 stream: Optional[IO] = None):
        self.every = max(int(every), 1)
        self.stream = stream  # None: sys.stdout as it is at each line
        self._jsonl: Optional[IO] = open(jsonl, "a") if jsonl else None

    def wants(self, step: int) -> bool:
        """True when a record for this step would be printed or written —
        lets callers skip device syncs (e.g. ``float(loss)``) on steps that
        produce no output."""
        return self._jsonl is not None or step % self.every == 0

    def log(self, step: int, **fields) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **fields}) + "\n")
            self._jsonl.flush()
        if step % self.every == 0:
            parts = [f"step {step:6d}"]
            for k, v in fields.items():
                if isinstance(v, float):
                    parts.append(f"{k} {v:.4f}" if abs(v) < 1e4 else f"{k} {v:.3e}")
                elif isinstance(v, dict):
                    parts.append(f"{k} {json.dumps(v, separators=(',', ':'))}")
                else:
                    parts.append(f"{k} {v}")
            print("  ".join(parts), file=self.stream or sys.stdout)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
