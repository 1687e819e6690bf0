"""Heartbeat liveness over the native control-plane van.

Counterpart of ``ps_tpu/control/heartbeat.py``, over the port's own copy
of ``van.cpp``. Every process runs a monitor (:class:`HeartbeatServer`)
and beats every peer (:class:`HeartbeatClient`), so each process detects
any peer's death locally; :class:`FailureDetector` bundles both for one
process of a multi-process run, and ``CudaBackend.check_health`` raises
its :class:`WorkerFailureError`. The beat and receive loops are C++
threads (UDP), so a Python pause (a long compile, a blocking collective)
cannot stop a process from beating; only real death does. Detection polls
from Python; each detected death lands in the flight recorder as a
``peer_dead`` event before the raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

from ps_tpu_torch.native import load


class WorkerFailureError(RuntimeError):
    """A peer process stopped heartbeating (dead or partitioned)."""

    def __init__(self, dead: List[int]):
        self.dead = sorted(dead)
        super().__init__(
            f"peer process(es) {self.dead} stopped heartbeating — "
            f"declared dead by the failure detector"
        )


def _lib():
    lib = load("van")
    lib.hb_server_start.restype = ctypes.c_void_p
    lib.hb_server_start.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.hb_server_port.restype = ctypes.c_int
    lib.hb_server_port.argtypes = [ctypes.c_void_p]
    lib.hb_server_poll.restype = ctypes.c_int
    lib.hb_server_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
    ]
    lib.hb_server_seq.restype = ctypes.c_uint64
    lib.hb_server_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.hb_server_age_ms.restype = ctypes.c_int64
    lib.hb_server_age_ms.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.hb_server_stop.argtypes = [ctypes.c_void_p]
    lib.hb_client_start.restype = ctypes.c_void_p
    lib.hb_client_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.hb_client_goodbye.argtypes = [ctypes.c_void_p]
    lib.hb_client_stop.argtypes = [ctypes.c_void_p]
    return lib


class HeartbeatServer:
    """Liveness monitor: tracks every node that has ever beaten this port.

    A node is *alive* while its beats arrive within ``timeout_ms``, *dead*
    once seen-then-silent longer than that, and *left* — permanently, never
    dead — once its goodbye arrives (clean membership change ≠ failure).

    ``bind`` is the listen address: "0.0.0.0" accepts beats from any host
    (pod deployments), "127.0.0.1" restricts to this host (tests).
    """

    def __init__(self, port: int = 0, timeout_ms: int = 1000,
                 bind: str = "0.0.0.0"):
        import socket

        self._lib = _lib()
        addr = socket.gethostbyname(bind)  # names ok; native side wants IPv4
        self._h = self._lib.hb_server_start(addr.encode(), port, timeout_ms)
        if not self._h:
            raise OSError(
                f"heartbeat server failed to bind {bind} ({addr}):{port}"
            )

    def _require(self):
        if not self._h:
            raise RuntimeError("heartbeat server is closed")
        return self._h

    @property
    def port(self) -> int:
        return self._lib.hb_server_port(self._require())

    def _poll(self, state: int) -> List[int]:
        cap = 1024
        buf = (ctypes.c_uint32 * cap)()
        n = self._lib.hb_server_poll(self._require(), state, buf, cap)
        return sorted(buf[i] for i in range(n))

    def alive(self) -> List[int]:
        return self._poll(0)

    def dead(self) -> List[int]:
        """Seen, then silent past the horizon, with no goodbye."""
        return self._poll(1)

    def left(self) -> List[int]:
        """Nodes that announced a clean leave (goodbye received)."""
        return self._poll(2)

    def seq(self, node_id: int) -> int:
        """Beats received from node_id (0 = never seen)."""
        return int(self._lib.hb_server_seq(self._require(), node_id))

    def age_ms(self, node_id: int) -> Optional[int]:
        """Milliseconds since this node's last beat (None = never seen):
        'alive' says a peer beat within the horizon, the age how fresh."""
        age = int(self._lib.hb_server_age_ms(self._require(), node_id))
        return None if age < 0 else age

    def state(self, node_id: Optional[int] = None):
        """One node's liveness, or the whole monitor's view.

        With ``node_id``: the liveness string — 'left' (clean goodbye —
        permanent), 'dead' (seen-then-silent past the horizon), 'alive',
        or 'unseen' (never beat — indistinguishable from
        not-started-yet).

        Without: ``{node: {"state", "age_ms", "seq"}}`` for every node
        that ever beat, with the per-peer last-beat ages."""
        if node_id is not None:
            if node_id in self.left():
                return "left"
            if node_id in self.dead():
                return "dead"
            if node_id in self.alive():
                return "alive"
            return "unseen"
        out: Dict[int, dict] = {}
        for st, nodes in (("alive", self.alive()), ("dead", self.dead()),
                          ("left", self.left())):
            for n in nodes:
                out[n] = {"state": st, "age_ms": self.age_ms(n),
                          "seq": self.seq(n)}
        return out

    def close(self) -> None:
        if self._h:
            self._lib.hb_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HeartbeatClient:
    """Beats ``node_id`` at ``host:port`` every ``interval_ms`` from a C++
    thread until closed."""

    def __init__(self, host: str, port: int, node_id: int,
                 interval_ms: int = 100):
        import socket

        self._lib = _lib()
        # the native side takes dotted-quad only; resolve names here so a
        # bad hostname is a loud error, never a silent localhost fallback
        addr = socket.gethostbyname(host)
        self._h = self._lib.hb_client_start(
            addr.encode(), port, node_id, interval_ms
        )
        if not self._h:
            raise OSError(f"heartbeat client to {host} ({addr}):{port} failed")

    def close(self, goodbye: bool = False) -> None:
        """Stop beating. ``goodbye=True`` first announces a clean leave so
        the peer marks this node *left* instead of eventually *dead*."""
        if self._h:
            if goodbye:
                self._lib.hb_client_goodbye(self._h)
            self._lib.hb_client_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FailureDetector:
    """Symmetric peer liveness for one process of a multi-process run.

    Args:
      node_id: this process's id.
      peers: ``{node_id: (host, port)}`` of every OTHER process's monitor.
      port: local monitor port (0 = ephemeral; see :attr:`server`).
      bind: local monitor listen address ("0.0.0.0" for multi-host pods,
        "127.0.0.1" to restrict to this host).
      interval_ms / timeout_ms: beat cadence and death horizon.

    Usage: construct everywhere, then call :meth:`check` between training
    steps — it raises :class:`WorkerFailureError` naming the dead peers
    instead of letting the next collective hang. A peer that closed with
    ``goodbye=True`` is *left*, not dead: :meth:`check` stays silent.
    """

    def __init__(self, node_id: int, peers: Dict[int, Tuple[str, int]],
                 port: int = 0, interval_ms: int = 100,
                 timeout_ms: int = 1000, bind: str = "0.0.0.0"):
        self.node_id = node_id
        self.expected = sorted(peers)
        self.server = HeartbeatServer(port=port, timeout_ms=timeout_ms,
                                      bind=bind)
        self._clients = [
            HeartbeatClient(host, p, node_id, interval_ms)
            for _, (host, p) in sorted(peers.items())
        ]

    def check(self) -> None:
        """Raise if any peer that ever beat us has gone silent (a clean
        goodbye-leave never raises)."""
        dead = self.server.dead()
        if dead:
            from ps_tpu_torch import obs

            # recorded before the raise: the dump must hold the first
            # detection even if the raise takes the process down
            obs.record_event("peer_dead", node=self.node_id,
                             dead=sorted(dead))
            raise WorkerFailureError(dead)

    def left(self) -> List[int]:
        """Peers that announced a clean leave."""
        return self.server.left()

    def wait_for_peers(self, timeout_s: float = 30.0) -> None:
        """Block until every expected peer's first beat arrives (rendezvous
        barrier for the control plane)."""
        import time

        deadline = time.monotonic() + timeout_s
        want = set(self.expected)
        while time.monotonic() < deadline:
            seen = set(self.server.alive()) | set(self.server.dead())
            if want <= seen:
                return
            time.sleep(0.02)
        missing = sorted(want - (set(self.server.alive()) | set(self.server.dead())))
        raise TimeoutError(
            f"peers {missing} never started heartbeating within {timeout_s}s"
        )

    def close(self, goodbye: bool = False) -> None:
        """``goodbye=True`` announces a clean leave to every peer before
        stopping (so survivors see *left*, not an eventual *dead*)."""
        for c in self._clients:
            c.close(goodbye=goodbye)
        self._clients = []
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
