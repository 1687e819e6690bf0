"""Structured per-step training log.

Counterpart of ``ps_tpu/utils/step_log.py``'s ``StepLogger``: fixed-format
console lines every ``every`` steps, an optional JSONL file with every
record, optional TensorBoard scalars (through
``torch.utils.tensorboard.SummaryWriter`` where the ``tensorboard``
package imports; without it the logger says so on stderr and goes on),
and out-of-band events mirrored into the process flight recorder.
"""

from __future__ import annotations

import json
import sys
from typing import IO, Optional


class StepLogger:
    """Prints aligned step lines every ``every`` steps and optionally appends
    every record to a JSONL file and/or a TensorBoard event file.

    Usage::

        log = StepLogger(every=10, jsonl="run.jsonl", tensorboard="tb/run1")
        ...
        log.log(step, loss=float(loss), **metrics.summary())
    """

    def __init__(self, every: int = 10, jsonl: Optional[str] = None,
                 tensorboard: Optional[str] = None,
                 stream: Optional[IO] = None):
        self.every = max(int(every), 1)
        self.stream = stream  # None: sys.stdout as it is at each line
        self._jsonl: Optional[IO] = open(jsonl, "a") if jsonl else None
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard)
            except Exception as e:  # noqa: BLE001 — degrade, don't crash
                print(f"StepLogger: tensorboard disabled ({e!r})",
                      file=sys.stderr)

    def wants(self, step: int) -> bool:
        """True when a record for this step would be printed or written —
        lets callers skip device syncs (e.g. ``float(loss)``) on steps that
        produce no output."""
        return (self._jsonl is not None or self._tb is not None
                or step % self.every == 0)

    def log(self, step: int, **fields) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **fields}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in fields.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._tb.add_scalar(k, v, global_step=step)
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

    def event(self, name: str, **fields) -> None:
        """An out-of-band run event (failover, promotion, degrade): always
        printed, whatever ``every`` says, appended to the JSONL file as
        ``{"event": name, ...}``, and mirrored into the process flight
        recorder, so the step log and the dump tell one story."""
        try:
            from ps_tpu_torch import obs

            obs.record_event(name, **fields)
        except Exception:
            pass  # the line must print even if obs is broken
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"event": name, **fields}) + "\n")
            self._jsonl.flush()
        parts = [f"event {name}"]
        for k, v in fields.items():
            parts.append(f"{k} {v:.4f}" if isinstance(v, float)
                         else f"{k} {v}")
        print("  ".join(parts), file=self.stream or sys.stdout)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
