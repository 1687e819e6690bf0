"""The members' side of the coordinator: join, beat, report, fetch.

Counterpart of ``ps_tpu/elastic/member.py``, the same frames. What a
server or a worker needs to take part in elastic membership, with the
coordinator never on its data path:

- :class:`CoordinatorMember`: a serving shard's registration, one
  ``COORD_HELLO`` (its URI and each key's bytes), a
  :class:`~ps_tpu_torch.control.heartbeat.HeartbeatClient` beating the
  coordinator's monitor from a native thread, and a reporter thread
  sending ``COORD_REPORT`` load frames on the coordinator's cadence
  (with delta-encoded telemetry when given a ``telemetry`` source,
  ``obs/collector.py``). ``close(goodbye=True)`` announces a clean leave:
  the membership view shows *left*, never *dead*.
- :class:`TelemetryReporter`: telemetry alone, for a process that
  reports without registering (a worker).
- :func:`fetch_table` (workers poll it until the table covers their keys,
  and again when a refusal says the assignment moved), :func:`fetch_view`,
  :func:`fetch_aggregators`, :func:`fetch_telemetry`,
  :func:`fetch_policy`, :func:`request_rebalance` and
  :func:`register_spare`: one round trip each.

A dead coordinator silences the reporters without touching the data
plane.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Union

from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.elastic.table import ShardTable

__all__ = ["CoordinatorMember", "TelemetryReporter", "fetch_table",
           "fetch_view", "fetch_telemetry", "fetch_aggregators",
           "request_rebalance", "register_spare", "fetch_policy",
           "parse_coord"]


def parse_coord(addr: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    """``"host:port"`` (or a ``(host, port)`` pair) -> ``(host, port)``."""
    if isinstance(addr, str):
        host, port = addr.rsplit(":", 1)
        return host, int(port)
    host, port = addr
    return str(host), int(port)


def _coord_request(addr, kind: int, extra: Optional[dict] = None,
                   timeout_ms: int = 5000) -> dict:
    host, port = parse_coord(addr)
    ch = tv.Channel.connect(host, port, timeout_ms=timeout_ms)
    try:
        k, _, _, out = tv.decode(ch.request(tv.encode(kind, 0, None,
                                                      extra=extra)))
    finally:
        ch.close()
    if k != tv.OK:
        raise RuntimeError(f"coordinator {host}:{port} refused "
                           f"{tv.kind_name(kind)}: {out.get('error')}")
    return out


def fetch_view(addr, timeout_ms: int = 5000) -> dict:
    """The coordinator's whole COORD_TABLE reply: the table, the
    membership and liveness rows, the move in progress (ps_top's view)."""
    return _coord_request(addr, tv.COORD_TABLE, timeout_ms=timeout_ms)


def fetch_aggregators(addr, timeout_ms: int = 5000) -> dict:
    """``{host: uri}`` of every registered host aggregator: a worker that
    finds its own host name there sends through that aggregator, else
    flat. Rides the same lean COORD_TABLE poll a join makes."""
    extra = _coord_request(addr, tv.COORD_TABLE, extra={"lean": True},
                           timeout_ms=timeout_ms)
    return dict(extra.get("aggregators") or {})


def fetch_table(addr, cover=None, min_epoch: Optional[int] = None,
                timeout: float = 30.0,
                view_out: Optional[dict] = None) -> ShardTable:
    """The current shard table, polled until it covers ``cover`` (keys: a
    joining worker waits for every server to register) and its epoch is
    past ``min_epoch`` (a re-routing worker waits for the move it was
    refused over to commit). ``view_out`` (a dict) receives the last
    reply's other fields, the aggregators' map among them."""
    deadline = time.monotonic() + timeout
    want = set(cover) if cover is not None else None
    while True:
        # the lean reply, the table only: every worker polls at once at a
        # join or a re-route, and the full view polls the monitor
        view = _coord_request(addr, tv.COORD_TABLE, extra={"lean": True})
        if view_out is not None:
            view_out.clear()
            view_out.update(view)
        table = ShardTable.from_wire(view["table"])
        ok = want is None or table.covers(want)
        if ok and (min_epoch is None or table.epoch > min_epoch):
            return table
        if time.monotonic() >= deadline:
            missing = sorted(want - set(table.assign))[:3] if want else []
            raise TimeoutError(
                f"coordinator table never became usable within {timeout}s "
                f"(epoch {table.epoch}, need > {min_epoch}; "
                f"missing keys {missing})")
        time.sleep(0.05)


def fetch_telemetry(addr, window_s: Optional[float] = None,
                    timeout_ms: int = 5000) -> dict:
    """One ``COORD_TELEMETRY`` round trip: the fleet's window quantiles
    from merged raw buckets, each member's window summaries, the step
    breakdown, straggler suspects, SLO states and rebalance hints."""
    extra: Dict[str, object] = {}
    if window_s is not None:
        extra["window_s"] = float(window_s)
    return _coord_request(addr, tv.COORD_TELEMETRY, extra=extra,
                          timeout_ms=timeout_ms)


def request_rebalance(addr, moves=None, targets=None, drain=None,
                      timeout_ms: int = 600_000) -> dict:
    """Ask the coordinator to rebalance (explicit ``moves``, a ``targets``
    member set, or a ``drain`` list); returns once the table committed."""
    extra: Dict[str, object] = {}
    if moves is not None:
        extra["moves"] = [[int(d), int(r), [str(k) for k in ks]]
                          for d, r, ks in moves]
    if targets is not None:
        extra["targets"] = [int(t) for t in targets]
    if drain is not None:
        extra["drain"] = [int(d) for d in drain]
    return _coord_request(addr, tv.COORD_REBALANCE, extra=extra,
                          timeout_ms=timeout_ms)


def register_spare(addr, uri: str, timeout_ms: int = 5000) -> dict:
    """Register an empty backup process as a re-seed target: the policy
    engine's ``replica_reseed`` heals a used-up replica set onto the first
    one. Once a uri; the spare serves nothing until seeded."""
    return _coord_request(addr, tv.COORD_HELLO,
                          extra={"role": "spare", "uri": str(uri)},
                          timeout_ms=timeout_ms)


def fetch_policy(addr, n: int = 32, timeout_ms: int = 5000) -> dict:
    """One ``COORD_POLICY`` round trip: the policy engine's mode, each
    rule's arming and streaks, the cooldowns left, the counters and the
    last ``n`` audit entries."""
    return _coord_request(addr, tv.COORD_POLICY, extra={"n": int(n)},
                          timeout_ms=timeout_ms)


class CoordinatorMember:
    """One serving shard's standing with the coordinator.

    ``telemetry`` returns the member's cumulative metric state
    (:func:`~ps_tpu_torch.obs.collector.collect_telemetry` of the
    service's own stats): each load report carries a delta of it, and a
    ``telemetry_resync`` in the reply makes the next one full. A failure
    of the telemetry degrades to plain load reports, never the member."""

    def __init__(self, coord: Union[str, Tuple[str, int]], uri: str,
                 key_bytes: Dict[str, int], kind: str = "dense",
                 report: Optional[Callable[[], dict]] = None,
                 report_ms: Optional[int] = None,
                 telemetry: Optional[Callable[[], dict]] = None):
        from ps_tpu_torch.control.heartbeat import HeartbeatClient

        self.coord = parse_coord(coord)
        self.uri = uri
        extra = _coord_request(self.coord, tv.COORD_HELLO, extra={
            "role": "server", "uri": uri, "kind": kind,
            "key_bytes": {k: int(v) for k, v in key_bytes.items()},
        })
        self.node = int(extra["node"])
        self.table = ShardTable.from_wire(extra["table"])
        self._report_fn = report
        self._report_ms = int(report_ms if report_ms is not None
                              else extra.get("report_ms", 1000))
        self._tel = None
        if telemetry is not None:
            from ps_tpu_torch.obs.collector import DeltaEncoder

            self._tel = DeltaEncoder(telemetry)
        self._hb = HeartbeatClient(self.coord[0], int(extra["hb_port"]),
                                   node_id=self.node)
        self._stop = threading.Event()
        self._t: Optional[threading.Thread] = None
        if report is not None or telemetry is not None:
            self._t = threading.Thread(target=self._report_loop,
                                       daemon=True, name="ps-coord-report")
            self._t.start()

    def _report_loop(self) -> None:
        while not self._stop.wait(self._report_ms / 1e3):
            try:
                extra = dict(self._report_fn() or {}) \
                    if self._report_fn is not None else {}
                extra["uri"] = self.uri
                if self._tel is not None:
                    try:
                        snap = self._tel.snapshot()
                        if snap is not None:
                            extra["telemetry"] = snap
                    except Exception:
                        logging.getLogger(__name__).debug(
                            "telemetry snapshot failed", exc_info=True)
                extra = _coord_request(self.coord, tv.COORD_REPORT,
                                       extra=extra)
                if self._tel is not None and extra.get("telemetry_resync"):
                    # the coordinator holds no baseline of our deltas
                    self._tel.force_full()
            except Exception:
                # a dead coordinator costs joins and rebalances, never the
                # serving shard's reporter thread
                logging.getLogger(__name__).debug(
                    "load report to coordinator failed", exc_info=True)

    def close(self, goodbye: bool = True) -> None:
        self._stop.set()
        if self._t is not None:
            self._t.join(timeout=5)
        self._hb.close(goodbye=goodbye)


class TelemetryReporter:
    """Telemetry without membership: a thread sending one process's
    delta-encoded snapshots as COORD_REPORT frames.

    A worker registers no key range and beats no monitor, but its op,
    flush and wire histograms are the worker phases of the fleet's step
    breakdown. The coordinator lands a report from an unknown URI in its
    time series and keeps it out of the server views (membership,
    straggler scores). Every failure is swallowed."""

    def __init__(self, coord: Union[str, Tuple[str, int]], uri: str,
                 collect: Callable[[], dict], kind: str = "worker",
                 report_ms: int = 1000):
        from ps_tpu_torch.obs.collector import DeltaEncoder

        self.coord = parse_coord(coord)
        self.uri = uri
        self.kind = kind
        self._tel = DeltaEncoder(collect)
        self._report_ms = int(report_ms)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ps-telemetry-report")
        self._t.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._report_ms / 1e3):
            try:
                snap = self._tel.snapshot()
                if snap is None:
                    continue  # nothing moved
                extra = _coord_request(self.coord, tv.COORD_REPORT, extra={
                    "uri": self.uri, "kind": self.kind, "telemetry": snap})
                if extra.get("telemetry_resync"):
                    self._tel.force_full()
            except Exception:
                logging.getLogger(__name__).debug(
                    "telemetry report failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)
