"""Freshness plane: version birth stamps and cross-process age.

Counterpart of ``ps_tpu/obs/freshness.py``, the same stamps and ages.
A reader can be handed bytes committed elsewhere some time ago: a
replica's stream entry, the native read cache, a worker's cached
snapshot, a NOT_MODIFIED revalidation. To say how old they are, a birth
time is stamped once, at the primary's apply, and carried with the bytes
through each of those tiers, so that ``age = now - birth`` can be
recorded where they are served.

A birth record is a plain json-able dict (it rides the READ and
NOT_MODIFIED reply extras and the replication stream's meta)::

    {"birth": <wall seconds>, "bmono": <monotonic seconds>, "bpid": token}

Two clocks on purpose: the wall stamp crosses processes, the monotonic
stamp is exact but only meaningful inside the stamping process. ``bpid``
is a per-process random token (not a bare pid: pids recycle) that tells
a consumer which case it is in. :func:`age_of` resolves the age in this
order and tags the sample's source:

- ``mono``: same process as the stamper, a monotonic difference;
- ``sync``: another process, with a ClockSync offset in hand
  (``obs/clock.py``): the local wall clock is projected into the
  stamper's clock before the difference;
- ``wall``: another process, no offset: a plain wall difference, off by
  the clocks' skew.

A skewed member never reports a negative age: it is clamped to zero and
the clamp is reported.

READ replies stay byte-deterministic (the native cache serves cached
reply bytes verbatim), which is why the stamp works: birth is committed
state, stamped at apply time, never a ``time.time()`` taken at serve
time.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

__all__ = ["PROC_TOKEN", "birth_record", "foreign_record", "from_extra",
           "age_of"]

#: this process's stamp identity — random so a recycled pid (or a
#: fork twin) can never claim another process's monotonic clock
PROC_TOKEN = f"{os.getpid():x}.{os.urandom(4).hex()}"


def birth_record(wall: Optional[float] = None,
                 mono: Optional[float] = None) -> dict:
    """Stamp a version born HERE, NOW (call at the primary's apply,
    under the engine lock, right where the version increments)."""
    return {
        "birth": time.time() if wall is None else float(wall),
        "bmono": time.monotonic() if mono is None else float(mono),
        "bpid": PROC_TOKEN,
    }


def foreign_record(wall: float) -> dict:
    """A birth learned from ANOTHER process (a replica installing the
    primary's stamp from the stream meta): wall clock only — an empty
    token never matches :data:`PROC_TOKEN`, so readers fall to the
    sync/wall paths instead of trusting a monotonic clock that is not
    theirs."""
    return {"birth": float(wall), "bmono": None, "bpid": ""}


def from_extra(extra: dict, table: Optional[str] = None) -> Optional[dict]:
    """The birth record carried by a reply ``extra``, or None when the
    peer predates the freshness plane. Dense replies carry flat
    ``birth``/``bmono``/``bpid`` keys; sparse replies carry a per-table
    ``births`` map of ``[wall, mono, bpid]`` triples (mono/bpid absent
    on foreign stamps) — pass ``table`` to resolve those."""
    if table is not None:
        b = (extra.get("births") or {}).get(table)
        if b is None:
            return None
        bm = b[1] if len(b) > 1 else None
        return {"birth": float(b[0]),
                "bmono": None if bm is None else float(bm),
                "bpid": (b[2] if len(b) > 2 else "") or ""}
    if extra.get("birth") is None:
        return None
    bm = extra.get("bmono")
    return {"birth": float(extra["birth"]),
            "bmono": None if bm is None else float(bm),
            "bpid": extra.get("bpid") or ""}


def age_of(rec: dict, offset_us: Optional[float] = None
           ) -> Tuple[float, str, bool]:
    """``(age_seconds, source, clamped)`` for a birth record, resolved
    in the preference order the module docstring fixes. ``offset_us``
    is a ClockSync offset toward the STAMPING process (add to local
    wall → stamper wall)."""
    bmono = rec.get("bmono")
    if rec.get("bpid") == PROC_TOKEN and bmono is not None:
        age = time.monotonic() - float(bmono)
        src = "mono"
    elif offset_us is not None:
        age = (time.time() + float(offset_us) / 1e6) - float(rec["birth"])
        src = "sync"
    else:
        age = time.time() - float(rec["birth"])
        src = "wall"
    if age < 0.0:
        return 0.0, src, True
    return age, src, False
