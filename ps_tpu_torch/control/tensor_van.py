"""Framed tensor messages over the native TCP van.

Counterpart of ``ps_tpu/control/tensor_van.py``, over the port's own copy
of ``van.cpp`` (``ps_tpu_torch/native``). Async workers are separate OS
processes, so their gradient and parameter exchange with the server
process travels as framed byte messages over the van's TCP layer
(``tv_*``); this module does the encoding. A message is::

    [u8 kind][u32 worker_id][u64 meta_len][meta json][raw buffers...]

where the json carries each tensor's (name, numpy ``dtype.str``, shape) in
sorted-name order, followed by the concatenated raw row-major buffers. A
tensor is encoded through a numpy view of its host memory: a numpy array
as it is, a CPU ``torch.Tensor`` through ``.numpy()``. So the port's frame
of a tree is the reference's frame of the same values, byte for byte. A
CUDA tensor is refused here: the backends stage it through pinned host
memory first (``backends/common.py``). ``bfloat16`` is refused with a
``TypeError``: numpy has no such type, and the reference's frame of a bf16
leaf names it ``<V2``, which decodes as raw bytes, not as numbers.

``Channel`` and ``Listener`` are thin blocking wrappers over the C ABI;
ctypes releases the GIL during sends and receives, so a multi-MB push never
stalls other Python threads (a server serves each connection from its own
thread).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ps_tpu_torch.native import load

# message kinds (u8) — the reference's numbering: the wire is shared
HELLO = 0       # worker announces itself; server replies SERVER_INFO
PULL = 1        # -> params + version
PUSH = 2        # grads -> ack (applied with DC; version advances)
PUSH_PULL = 3   # grads -> params + version (one round trip per cycle)
STATS = 4       # -> json: version, staleness_hist, apply_log
SHUTDOWN = 5    # server drains and stops serving this connection
OK = 6
ERR = 7
ROW_PULL = 8        # sparse tables (remote_sparse.py)
ROW_PUSH = 9
ROW_PUSH_PULL = 10
CHECKPOINT = 11     # {"dir", "phase"} -> the coordinated checkpoint round
BUCKET_PUSH = 12    # one slice-bucket of a multi-bucket push; the bucket
#                     completing the epoch commits the WHOLE tree atomically
BUCKET_PULL = 13    # bucket 0 snapshots the tree server-side; buckets
#                     1..n-1 stream the remaining slices of that snapshot
ROW_BUCKET_PUSH = 14
SHM_SETUP = 15      # same-host shared-memory lane offer (shm_lane.py)
REPLICA_HELLO = 16  # shard replication (replica/): attach, then the stream
REPLICA_APPEND = 17
REPLICA_PROMOTE = 18
REPLICA_STATE = 19
COORD_HELLO = 20    # elastic membership (elastic/)
COORD_TABLE = 21
COORD_REPORT = 22
COORD_REBALANCE = 23
MIGRATE_OUT = 24
MIGRATE_BEGIN = 25
MIGRATE_ROW = 26
MIGRATE_COMMIT = 27
MIGRATE_ABORT = 28
COORD_TELEMETRY = 29
READ = 30           # the side-effect-free read path; {"cond": v} last
NOT_MODIFIED = 31   # a conditional READ's reply when v is current
NOT_MODIFIED = 31
COORD_POLICY = 32
RESEED = 33
REPLICA_SEED = 34

KIND_NAMES = {
    HELLO: "hello", PULL: "pull", PUSH: "push", PUSH_PULL: "push_pull",
    STATS: "stats", SHUTDOWN: "shutdown", OK: "ok", ERR: "err",
    ROW_PULL: "row_pull", ROW_PUSH: "row_push",
    ROW_PUSH_PULL: "row_push_pull", CHECKPOINT: "checkpoint",
    BUCKET_PUSH: "bucket_push", BUCKET_PULL: "bucket_pull",
    ROW_BUCKET_PUSH: "row_bucket_push", SHM_SETUP: "shm_setup",
    REPLICA_HELLO: "replica_hello", REPLICA_APPEND: "replica_append",
    REPLICA_PROMOTE: "replica_promote", REPLICA_STATE: "replica_state",
    COORD_HELLO: "coord_hello", COORD_TABLE: "coord_table",
    COORD_REPORT: "coord_report", COORD_REBALANCE: "coord_rebalance",
    MIGRATE_OUT: "migrate_out", MIGRATE_BEGIN: "migrate_begin",
    MIGRATE_ROW: "migrate_row", MIGRATE_COMMIT: "migrate_commit",
    MIGRATE_ABORT: "migrate_abort", COORD_TELEMETRY: "coord_telemetry",
    READ: "read", NOT_MODIFIED: "not_modified",
    COORD_POLICY: "coord_policy", RESEED: "reseed",
    REPLICA_SEED: "replica_seed",
}


def kind_name(kind: int) -> str:
    return KIND_NAMES.get(kind, f"kind{kind}")


_HDR = struct.Struct("<BIQ")  # kind, worker_id, meta_len


def _lib():
    lib = load("van")
    lib.tv_listen.restype = ctypes.c_void_p
    lib.tv_listen.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.tv_listener_port.restype = ctypes.c_int
    lib.tv_listener_port.argtypes = [ctypes.c_void_p]
    lib.tv_accept.restype = ctypes.c_void_p
    lib.tv_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tv_listener_close.argtypes = [ctypes.c_void_p]
    lib.tv_connect.restype = ctypes.c_void_p
    lib.tv_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.tv_send.restype = ctypes.c_int
    # c_void_p (not c_char_p), so bytearray frames go over by from_buffer
    lib.tv_send.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.tv_send_vec.restype = ctypes.c_int
    lib.tv_send_vec.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.tv_poll_readable.restype = ctypes.c_int
    lib.tv_poll_readable.argtypes = [ctypes.c_void_p, ctypes.c_int]
    # the shared-memory ring's primitives (control/shm_lane.py): GIL-free
    # copies, acquire/release cursors and the spin-then-sleep wait
    lib.tv_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_uint64]
    lib.tv_prefault.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_int]
    lib.tv_load_u64.restype = ctypes.c_uint64
    lib.tv_load_u64.argtypes = [ctypes.c_void_p]
    lib.tv_store_u64.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tv_wait_u64.restype = ctypes.c_int
    lib.tv_wait_u64.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_int, ctypes.c_int]
    lib.tv_recv_size.restype = ctypes.c_int64
    lib.tv_recv_size.argtypes = [ctypes.c_void_p]
    lib.tv_recv_into.restype = ctypes.c_int
    lib.tv_recv_into.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64]
    lib.tv_shutdown.argtypes = [ctypes.c_void_p]
    lib.tv_close.argtypes = [ctypes.c_void_p]
    return lib


# -- tensor-tree codec -------------------------------------------------------


def host_array(x) -> np.ndarray:
    """The contiguous numpy view (or copy, when ``x`` is not contiguous) a
    frame carries for one tensor: numpy as it is, a CPU tensor through
    ``.numpy()``. A CUDA tensor or a bf16 one is refused."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"a {x.device} tensor cannot go on the wire directly: stage "
                f"it to host memory first (backends.common.stage_to_host)")
        if x.dtype == torch.bfloat16:
            raise TypeError(
                "bfloat16 tensors cannot travel the van: numpy has no "
                "bfloat16, and the reference's frame names such a leaf "
                "'<V2', which decodes as raw bytes; cast to float32 first")
        return np.ascontiguousarray(x.detach().numpy())
    return np.ascontiguousarray(np.asarray(x))


def encode_parts(kind: int, worker: int, tensors: Optional[Dict[str, object]],
                 extra: Optional[dict] = None):
    """The zero-copy form of :func:`encode`: ``(header, chunks)``, the
    packed header + json meta (a bytearray) and byte ``memoryview``s of the
    live tensors in frame order. ``header + b"".join(chunks)`` is
    :func:`encode`'s frame; nothing is staged, and the views pin their
    sources for the send."""
    names = sorted(tensors) if tensors else []
    arrays = [host_array(tensors[n]) for n in names]
    meta = {
        "tensors": [
            {"name": n, "dtype": a.dtype.str, "shape": list(a.shape)}
            for n, a in zip(names, arrays)
        ],
        "extra": extra or {},
    }
    mj = json.dumps(meta).encode()
    header = bytearray(_HDR.size + len(mj))
    _HDR.pack_into(header, 0, kind, worker, len(mj))
    header[_HDR.size:] = mj
    # zero-size arrays cannot cast("B"); they add no bytes, only meta
    return header, [memoryview(a).cast("B") if a.nbytes else memoryview(b"")
                    for a in arrays]


def encode_chunks_parts(kind: int, worker: int, chunks,
                        extra: Optional[dict] = None):
    """Zero-copy twin of :func:`encode_chunks`: ``(header, chunks)`` with
    the caller's byte views passed through untouched."""
    total = sum(len(c) for c in chunks)
    meta = {
        "tensors": [{"name": "raw", "dtype": "|u1", "shape": [total]}],
        "extra": extra or {},
    }
    mj = json.dumps(meta).encode()
    header = bytearray(_HDR.size + len(mj))
    _HDR.pack_into(header, 0, kind, worker, len(mj))
    header[_HDR.size:] = mj
    return header, list(chunks)


def assemble(header, chunks) -> bytearray:
    """Stage ``(header, chunks)`` into one contiguous frame (each chunk
    copied once)."""
    buf = bytearray(len(header) + sum(len(c) for c in chunks))
    buf[:len(header)] = header
    off = len(header)
    for c in chunks:
        n = len(c)
        buf[off:off + n] = c
        off += n
    return buf


def encode(kind: int, worker: int, tensors: Optional[Dict[str, object]],
           extra: Optional[dict] = None) -> bytearray:
    """One message: header + json meta (with the optional ``extra`` json
    fields) + the concatenated raw buffers, keys in sorted order."""
    return assemble(*encode_parts(kind, worker, tensors, extra))


def encode_chunks(kind: int, worker: int, chunks,
                  extra: Optional[dict] = None) -> bytearray:
    """One message whose single tensor ``raw`` (uint8 ``[total]``) is the
    concatenation of ``chunks`` (the bucketed transport's frame)."""
    return assemble(*encode_chunks_parts(kind, worker, chunks, extra))


def decode(buf) -> Tuple[int, int, Dict[str, np.ndarray], dict]:
    """Inverse of :func:`encode`; the arrays are zero-copy views of
    ``buf``."""
    kind, worker, mlen = _HDR.unpack_from(buf, 0)
    off = _HDR.size
    meta = json.loads(bytes(buf[off:off + mlen]))
    off += mlen
    tensors = {}
    for t in meta["tensors"]:
        dt = np.dtype(t["dtype"])
        n = int(np.prod(t["shape"], dtype=np.int64)) * dt.itemsize
        tensors[t["name"]] = np.frombuffer(
            buf[off:off + n], dtype=dt).reshape(t["shape"])
        off += n
    return kind, worker, tensors, meta.get("extra", {})


# -- blocking channel / listener ---------------------------------------------


class VanError(ConnectionError):
    """The peer closed or the frame was invalid."""


class RecvBufferPool:
    """Size-bucketed borrow/return pool for receive frames.

    Owners whose frame lifetimes are explicit (the serve loop: a request is
    dead once its reply is sent; the bucket pumps: a reply is dead once it
    is copied out) borrow here instead of allocating a frame each time, and
    return the buffer when done. Buffers are allocated at the requested
    size and filed by next-power-of-two class; a borrow takes the first
    buffer of its class that fits. Frames under ``min_bytes`` or over
    ``max_bytes`` are not pooled (a plain allocation, not a miss).
    Thread-safe; a buffer returned twice, or one the pool never issued, is
    ignored. A copy to the card out of a borrowed buffer must have finished
    before the buffer goes back.
    """

    def __init__(self, min_bytes: int = 1 << 16, max_bytes: int = 64 << 20,
                 max_per_class: int = 8, stats=None):
        self.min_bytes = int(min_bytes)
        self.max_bytes = int(max_bytes)
        self.max_per_class = int(max_per_class)
        self.stats = stats  # TransportStats with record_pool(hit)
        self._lock = threading.Lock()
        self._free: Dict[int, list] = {}
        self._out: set = set()  # id() of buffers currently borrowed

    def borrow(self, n: int):
        """A bytearray of capacity >= n, or None (the caller allocates)."""
        if n < self.min_bytes or n > self.max_bytes:
            return None
        cls = max(n - 1, 1).bit_length()  # next power of two >= n
        buf = None
        with self._lock:
            free = self._free.get(cls)
            if free:
                for i, b in enumerate(free):
                    if len(b) >= n:
                        buf = b
                        del free[i]
                        break
            hit = buf is not None
            if buf is None:
                buf = bytearray(n)
            self._out.add(id(buf))
        if self.stats is not None:
            self.stats.record_pool(hit)
        return buf

    def ret(self, frame) -> None:
        """Return a borrowed buffer: the memoryview ``recv`` handed out (its
        ``.obj`` is the buffer) or the buffer itself; anything else is a
        no-op, so callers return every frame unconditionally."""
        buf = getattr(frame, "obj", frame)
        if not isinstance(buf, bytearray) \
                or not (self.min_bytes <= len(buf) <= self.max_bytes):
            return
        cls = max(len(buf) - 1, 1).bit_length()
        with self._lock:
            if id(buf) not in self._out:
                return
            self._out.discard(id(buf))
            free = self._free.setdefault(cls, [])
            if len(free) < self.max_per_class:
                free.append(buf)


class Channel:
    """One framed TCP connection (blocking; one driving thread at a time,
    except :meth:`shutdown`/:meth:`close`, which are safe from any thread).

    Native access is refcounted: close() severs the socket at once (waking
    a thread blocked in recv) but defers the ``tv_close`` free until the
    last thread inside a native call leaves, so no thread touches a freed
    connection."""

    #: a TransportStats, set by owners that account traffic
    stats = None
    #: a RecvBufferPool, set by owners with explicit frame lifetimes
    pool = None
    lane = "tcp"

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self._hlock = threading.Lock()
        self._users = 0       # threads inside a native call
        self._closed = False  # close() asked; the free waits for users

    @classmethod
    def connect(cls, host: str, port: int, timeout_ms: int = 10_000,
                retries: int = 50, retry_delay_s: float = 0.1,
                max_wait_s: Optional[float] = None) -> "Channel":
        """Dial host:port, retrying while the server comes up.

        The host name is resolved again on every attempt (a restarted
        server may come back at a new address), and the delay between
        attempts is jittered exponential backoff capped at 2 s.
        ``max_wait_s`` bounds the total time slept between attempts;
        ``None`` takes ``PS_CONNECT_MAX_WAIT_MS`` (15 s)."""
        import random
        import socket as pysocket
        import time

        if max_wait_s is None:
            from ps_tpu_torch.config import env_float

            max_wait_s = env_float("PS_CONNECT_MAX_WAIT_MS", 15_000.0,
                                   lo=0.0) / 1e3
        lib = _lib()
        delay = max(float(retry_delay_s), 1e-3)
        slept = 0.0  # only sleep counts against max_wait_s
        err: Optional[Exception] = None
        dials = 0
        for attempt in range(retries):
            if attempt:
                if slept >= max_wait_s:
                    break
                d = min(delay * (0.5 + random.random()),  # 0.5x..1.5x
                        max_wait_s - slept)
                time.sleep(d)
                slept += d
                delay = min(delay * 2, 2.0)
            dials += 1
            try:
                addr = pysocket.gethostbyname(host)
            except OSError as e:  # a transient DNS failure retries too
                err = e
                continue
            h = lib.tv_connect(addr.encode(), port, timeout_ms)
            if h:
                return cls(h, lib)
        raise VanError(f"could not connect to {host}:{port} "
                       f"after {dials} attempts"
                       + (f" (last resolve error: {err})" if err else ""))

    @contextlib.contextmanager
    def _native(self):
        """Pin the handle for a native call; the last user frees it if
        close() ran meanwhile."""
        with self._hlock:
            if self._closed or not self._h:
                raise VanError("channel is closed")
            self._users += 1
            h = self._h
        try:
            yield h
        finally:
            with self._hlock:
                self._users -= 1
                if self._closed and self._users == 0 and self._h:
                    self._lib.tv_close(self._h)
                    self._h = None

    def send(self, payload) -> None:
        """Send one frame (bytes or a bytearray)."""
        n = len(payload)
        if isinstance(payload, bytearray):
            payload = (ctypes.c_char * n).from_buffer(payload)
        with self._native() as h:
            ok = self._lib.tv_send(h, payload, n)
        if not ok:
            self.close()  # a half-sent frame leaves the stream unusable
            raise VanError("send failed: peer closed")

    def send_parts(self, header, chunks) -> None:
        """Send one frame gathered from ``header`` + ``chunks`` with no
        staging copy (``sendmsg`` scatter-gather); the same bytes on the
        wire as ``send(assemble(header, chunks))``."""
        views = [np.frombuffer(header, np.uint8)]
        views += [np.frombuffer(c, np.uint8) for c in chunks if len(c)]
        n = len(views)
        ptrs = (ctypes.c_void_p * n)(*(v.ctypes.data for v in views))
        lens = (ctypes.c_uint64 * n)(*(v.nbytes for v in views))
        with self._native() as h:
            ok = self._lib.tv_send_vec(h, ptrs, lens, n)
        del views  # pinned the sources for exactly the call
        if not ok:
            self.close()
            raise VanError("send failed: peer closed")
        if self.stats is not None:
            self.stats.record_vec_send(sum(len(c) for c in chunks))

    def poll_readable(self, timeout_ms: int = 0) -> bool:
        """True when ``recv`` would not block (data pending or EOF)."""
        with self._native() as h:
            return bool(self._lib.tv_poll_readable(h, int(timeout_ms)))

    def recv(self) -> memoryview:
        buf = None
        with self._native() as h:
            n = self._lib.tv_recv_size(h)
            if n >= 0:
                buf = (self.pool.borrow(n) if self.pool is not None
                       else None)
                if buf is None:
                    buf = bytearray(n)
                ok = (not n) or self._lib.tv_recv_into(
                    h, (ctypes.c_char * n).from_buffer(buf), n)
        if n < 0:
            # EOF or an insane length word: the framing is gone, so poison
            # the channel rather than misparse the next bytes
            self.close()
            raise VanError("recv failed: peer closed" if n == -1
                           else "recv failed: oversized frame")
        if not ok:
            if self.pool is not None:
                self.pool.ret(buf)
            self.close()
            raise VanError("recv failed mid-frame: peer closed")
        # a pooled buffer may exceed the frame; the slice's .obj is still
        # the buffer, so RecvBufferPool.ret(view) finds its way home
        return memoryview(buf)[:n]

    def request(self, payload) -> memoryview:
        self.send(payload)
        return self.recv()

    def request_parts(self, header, chunks) -> memoryview:
        self.send_parts(header, chunks)
        return self.recv()

    def shutdown(self) -> None:
        """Sever without freeing: a thread blocked in :meth:`recv` wakes
        with EOF and closes its own channel. Safe from any thread."""
        with self._hlock:
            if self._h and not self._closed:
                self._lib.tv_shutdown(self._h)

    def close(self) -> None:
        """Sever and free, safe from any thread: with another thread in a
        native call, the socket is shut down now and freed when it leaves."""
        with self._hlock:
            if self._closed or not self._h:
                self._closed = True
                return
            self._closed = True
            self._lib.tv_shutdown(self._h)
            if self._users == 0:
                self._lib.tv_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Listener:
    """The server side's accept handle."""

    def __init__(self, port: int = 0, bind: str = "0.0.0.0",
                 backlog: int = 64):
        import socket as pysocket

        self._lib = _lib()
        addr = pysocket.gethostbyname(bind)
        self._h = self._lib.tv_listen(addr.encode(), port, backlog)
        if not self._h:
            raise OSError(f"tensor van failed to listen on {bind}:{port}")

    @property
    def port(self) -> int:
        return self._lib.tv_listener_port(self._h)

    def accept(self, timeout_ms: int = -1) -> Optional[Channel]:
        h = self._lib.tv_accept(self._h, timeout_ms)
        return Channel(h, self._lib) if h else None

    def close(self) -> None:
        if self._h:
            self._lib.tv_listener_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
