"""Same-host shared-memory lane for the tensor van.

Counterpart of ``ps_tpu/control/shm_lane.py``. Worker and server processes
on one host still move every TCP frame through the kernel twice; this
lane replaces that data plane with two single-producer/single-consumer
rings in a pair of POSIX shared-memory segments: a frame is written once
into the ring by the sender and decoded in place by the receiver
(``tensor_van.decode`` takes a ``memoryview``), with no syscall on the hot
path.

Negotiation (:func:`try_upgrade`): after the TCP connect and HELLO, the
worker creates the two segments and sends a ``SHM_SETUP`` frame naming
them and its boot id. The server attaches and replies OK only when the
boot ids match (same kernel, so same host and same /dev/shm). Any failure
(another host, a segment refused, a server that refuses the lane) keeps
plain TCP, with the same semantics.

The TCP connection stays open under the lane: it carries liveness (a
dying peer's kernel closes the socket, and the wait loops watch for EOF,
so a peer death mid-frame raises the :class:`~ps_tpu_torch.control.
tensor_van.VanError` the TCP lane raises), frames larger than half the
ring (spilled to TCP) and the traffic before the upgrade.

Ring layout (one a direction; ``cap`` data bytes)::

    [0:8)    tail   - producer cursor, absolute u64 (monotonic)
    [8:16)   head   - consumer cursor, absolute u64
    [16:24)  closed - producer sets 1 on a clean close
    [64:64+cap) data

A frame in the ring is ``[u64 length][length bytes]`` and never wraps:
when the contiguous rest cannot hold it the producer writes a wrap
sentinel (length 2**64-1) and restarts at offset 0, so a consumer always
sees a contiguous frame it can decode in place.

The hot path runs outside the interpreter lock: frame bytes move through
the van's ``tv_memcpy`` (ctypes releases the GIL), cursors are published
and read through its release/acquire atomics, and a wait is its
``tv_wait_u64`` (a bounded spin that decays to short sleeps), with
spin-versus-sleep wakeups counted in ``TransportStats``.

A ring frame decoded in place belongs to the ring until it is consumed:
the server consumes a request at its next ``recv``, after the reply, and
everything the handler copied to the card from it was waited for before
the reply (``backends/common.py``'s ``stage_to_device``).
"""

from __future__ import annotations

import os
import struct
import uuid
from typing import Optional

import numpy as np

from ps_tpu_torch.control import tensor_van as tv

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_TAIL = 0
_HEAD = 8
_CLOSED = 16
_DATA = 64
_WRAP = (1 << 64) - 1

#: default ring capacity per direction (Config.shm_bytes): holds several
#: 4 MiB default fusion buckets (frames up to cap/2 ride the ring), yet
#: small enough that the ring's working set stays largely cache-resident —
#: measured on 2-core hosts, walking a 64 MiB ring costs ~3x the copy time
#: of a 16 MiB one (every frame lands in cold DRAM instead of LLC)
DEFAULT_SHM_BYTES = 16 << 20

# one native wait slice: tv_wait_u64 spins hot, then nanosleeps doubling
# to 2 ms, returning after at most ~this long so the Python loop can
# re-check closed flags and probe the TCP side for spills/peer death
_WAIT_SLICE_US = 5000
# ring copies below this size stay in Python (a memoryview slice store);
# above it the ~1 µs ctypes hop into the GIL-free tv_memcpy pays for
# itself many times over
_NATIVE_COPY_MIN = 4096


def boot_id() -> str:
    """This kernel's boot id — equal between two processes iff they share
    a kernel, which is exactly "same host, same /dev/shm"."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket

        return f"host:{socket.gethostname()}"


class _Segment:
    """POSIX shared-memory segment with exact lifecycle control.

    ``multiprocessing.shared_memory.SharedMemory`` is the obvious tool but
    (before 3.13) registers ATTACHES with the resource tracker too — the
    attaching server's exit would unlink segments the worker still owns —
    and its ``__del__`` retries ``mmap.close()`` loudly while decoded
    in-place views still pin the mapping. This wrapper talks to
    ``_posixshmem`` directly: only the CREATOR registers with the tracker
    (so a SIGKILLed worker's segments are still reaped), close never
    raises (a pinned mapping is simply left for the GC — the segment is
    already unlinked, so the memory goes with the last mapping), and
    attach adopts nothing."""

    def __init__(self, name: str, size: Optional[int] = None):
        import _posixshmem
        import mmap as _mmap

        self.name = name
        self._tracked = False
        create = size is not None
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self._mmap = _mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        self.buf = memoryview(self._mmap)
        # fault the whole mapping in NOW (GIL-free), while we are still in
        # negotiation: lazily-faulted ring pages would otherwise cost a
        # page fault per 4 KiB on the first pass around each ring — an
        # order of magnitude over the copy itself on virtualized kernels.
        # Creator zero-fills (allocates pages, zeroes the cursors in one
        # go); attacher rewrites a byte per page (write-maps the existing
        # pages — safe: no traffic flows until the OK reply).
        base = np.frombuffer(self._mmap, np.uint8).ctypes.data
        tv._lib().tv_prefault(base, len(self._mmap), 1 if create else 2)
        if create:
            try:
                from multiprocessing import resource_tracker

                resource_tracker.register("/" + name, "shared_memory")
                self._tracked = True
            except Exception:
                pass
        # keep the tracker's own unlink from racing a clean one: unlink()
        # below unregisters first

    def close(self) -> None:
        try:
            self.buf.release()
        except Exception:
            pass
        try:
            self._mmap.close()
        except Exception:
            pass  # in-place frame views still pin it; GC finishes the job

    def unlink(self) -> None:
        import _posixshmem

        if self._tracked:
            self._tracked = False
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister("/" + self.name, "shared_memory")
            except Exception:
                pass
        try:
            _posixshmem.shm_unlink("/" + self.name)
        except FileNotFoundError:
            pass  # tracker or peer beat us to it


def _create(size: int) -> _Segment:
    return _Segment(f"psvan-{uuid.uuid4().hex[:16]}", size=size)


def _attach(name: str) -> _Segment:
    return _Segment(name)


class ShmRing:
    """One SPSC byte ring over a shared-memory buffer. Each side is
    driven by one thread (the van's one-driving-thread-per-channel rule);
    the producer owns ``tail``/``closed``, the consumer owns ``head``.
    Cursor publishes are native release stores, cursor reads native
    acquire loads, bulk copies the native GIL-free memcpy."""

    def __init__(self, buf: memoryview):
        self.cap = len(buf) - _DATA
        if self.cap <= 0:
            raise ValueError("shm segment too small for a ring")
        self._buf = buf
        self._data = buf[_DATA:]
        self._lib = tv._lib()
        # numpy wraps the mapping zero-copy; .ctypes.data is the base
        # address the native cursor/copy primitives work on
        self._np = np.frombuffer(buf, np.uint8)
        base = self._np.ctypes.data
        self._tail_addr = base + _TAIL
        self._head_addr = base + _HEAD
        self._data_addr = base + _DATA
        # cursor caches: each side re-reads only the OTHER side's cursor
        self._tail = int(self._lib.tv_load_u64(self._tail_addr))
        self._head = int(self._lib.tv_load_u64(self._head_addr))

    # -- shared ---------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return _U32.unpack_from(self._buf, _CLOSED)[0] != 0

    def close(self) -> None:
        """Producer-side clean close: consumers drain, then see EOF."""
        _U32.pack_into(self._buf, _CLOSED, 1)

    def max_frame(self) -> int:
        """Largest frame accepted; bigger ones spill to TCP. Half the
        ring, so a frame never has to wait for a COMPLETELY empty ring."""
        return self.cap // 2 - 8

    def _copy_in(self, off: int, part) -> int:
        n = len(part)
        if n >= _NATIVE_COPY_MIN:
            src = np.frombuffer(part, np.uint8)
            self._lib.tv_memcpy(self._data_addr + off, src.ctypes.data, n)
        else:
            self._data[off:off + n] = part
        return n

    # -- producer -------------------------------------------------------------

    def try_send(self, parts, total: int) -> bool:
        """Copy ``parts`` (byte views summing to ``total``) into the ring
        as one frame; False when there is no room yet (caller waits on
        :meth:`wait_head`)."""
        cap = self.cap
        pos = self._tail % cap
        contig = cap - pos
        need = 8 + total
        skip = contig if contig < need else 0
        head = int(self._lib.tv_load_u64(self._head_addr))
        self._seen_head = head  # what a full-ring wait should wait past
        if cap - (self._tail - head) < skip + need:
            return False
        if skip:
            if contig >= 8:
                _U64.pack_into(self._data, pos, _WRAP)
            self._tail += skip
            pos = 0
        _U64.pack_into(self._data, pos, total)
        off = pos + 8
        for p in parts:
            off += self._copy_in(off, p)
        self._tail += need
        # release store: every byte above is visible before the cursor
        self._lib.tv_store_u64(self._tail_addr, self._tail)
        return True

    def wait_head(self, last_head: int, timeout_us: int = _WAIT_SLICE_US,
                  skip_spin: bool = False) -> int:
        """Producer-side block (native, GIL-free) until the consumer moves
        ``head`` past ``last_head``; 1 = spun, 2 = slept, 0 = timeout."""
        return self._lib.tv_wait_u64(self._head_addr, last_head, timeout_us,
                                     int(skip_spin))

    # -- consumer -------------------------------------------------------------

    def try_peek(self) -> Optional[tuple]:
        """``(frame_view, advance)`` for the next frame, decoded in place
        — the view aliases ring memory and stays valid until
        :meth:`consume`; None when the ring is empty."""
        cap = self.cap
        tail = int(self._lib.tv_load_u64(self._tail_addr))
        while True:
            if self._head == tail:
                return None
            pos = self._head % cap
            contig = cap - pos
            if contig < 8:
                self._head += contig
                self._lib.tv_store_u64(self._head_addr, self._head)
                continue
            n = _U64.unpack_from(self._data, pos)[0]
            if n == _WRAP:
                self._head += contig
                self._lib.tv_store_u64(self._head_addr, self._head)
                continue
            return self._data[pos + 8:pos + 8 + n], 8 + n

    def copy_out(self, view: memoryview, dst) -> None:
        """Copy a peeked frame out of the ring into ``dst`` (a writable
        buffer) through the GIL-free native memcpy."""
        n = len(view)
        if n >= _NATIVE_COPY_MIN:
            src = np.frombuffer(view, np.uint8)
            d = np.frombuffer(dst, np.uint8)
            self._lib.tv_memcpy(d.ctypes.data, src.ctypes.data, n)
        else:
            dst[:n] = view

    def wait_tail(self, last_tail: int, timeout_us: int = _WAIT_SLICE_US,
                  skip_spin: bool = False) -> int:
        """Consumer-side block (native, GIL-free) until the producer
        publishes past ``last_tail``; 1 = spun, 2 = slept, 0 = timeout."""
        return self._lib.tv_wait_u64(self._tail_addr, last_tail, timeout_us,
                                     int(skip_spin))

    def consume(self, advance: int) -> None:
        """Release the last peeked frame's bytes back to the producer."""
        self._head += advance
        self._lib.tv_store_u64(self._head_addr, self._head)


class _Endpoint:
    """Shared mechanics of both lane ends: one tx ring, one rx ring, the
    underlying TCP channel for liveness/spill, and the poll loops."""

    lane = "shm"

    def __init__(self, ch, tx: ShmRing, rx: ShmRing, stats=None):
        self._ch = ch
        self._tx = tx
        self._rx = rx
        self.stats = stats
        self.pool = None
        self._closed = False

    # -- send -----------------------------------------------------------------

    def _send_frame(self, parts, total: int, chunk_bytes: int = 0) -> None:
        """One frame into the tx ring (polling while full), spilled to TCP
        when it cannot fit a half-empty ring."""
        if self._closed:
            raise tv.VanError("channel is closed")
        if total > self._tx.max_frame():
            if self.stats is not None:
                self.stats.record_shm_spill()
            from ps_tpu_torch import obs

            obs.record_event("shm_spill", bytes=int(total),
                             max_frame=self._tx.max_frame())
            if len(parts) == 1:
                self._ch.send(parts[0])
            else:
                self._ch.send_parts(parts[0], parts[1:])
            return
        while not self._tx.try_send(parts, total):
            if self._closed or self._tx.closed:
                raise tv.VanError("shm lane closed mid-send")
            # ring full: wait (natively, GIL-free) for the consumer to
            # drain; each timeout slice re-checks liveness
            if self._tx.wait_head(self._tx._seen_head) == 0 \
                    and self._peer_dead():
                self.close()
                raise tv.VanError("send failed: peer closed")
        if self.stats is not None:
            self.stats.record_shm_frame(total)
            if chunk_bytes:
                # the ring write is the frame's one copy: no staging
                # bytearray
                self.stats.record_vec_send(chunk_bytes)

    def send(self, payload) -> None:
        self._send_frame([payload], len(payload))

    def send_parts(self, header, chunks) -> None:
        parts = [header] + [c for c in chunks if len(c)]
        chunk_bytes = sum(len(c) for c in chunks)
        self._send_frame(parts, len(header) + chunk_bytes, chunk_bytes)

    # -- receive --------------------------------------------------------------

    def _peer_dead(self) -> bool:
        """EOF/err pending on the TCP side with no spilled frame racing?
        Peek the socket: readable + nothing in flight means the peer's
        kernel closed it. A genuine spilled frame is ALSO 'readable' —
        the callers that can receive spills use _poll_recv instead; this
        probe is only consulted mid-send, where request/reply framing
        guarantees the peer owes us nothing."""
        try:
            return self._ch.poll_readable(0)
        except tv.VanError:
            return True

    def _poll_recv(self, stop=None):
        """Next frame from the rx ring (in place: ``(view, advance)``,
        consume later) or from TCP spill (``memoryview`` already copied
        out by Channel.recv, advance None). Raises VanError on peer death
        or ``stop()``. The wait itself is the native futex-free
        spin→sleep (GIL-free); between timeout slices this loop re-checks
        closed flags and probes the TCP side for spills and peer death."""
        slept = False
        misses = 0  # wait slices that timed out with nothing arriving
        while True:
            got = self._rx.try_peek()
            if got is not None:
                if self.stats is not None:
                    self.stats.record_wakeup(spun=not slept)
                    self.stats.record_shm_frame(len(got[0]))
                return got[0], got[1]
            if self._closed:
                raise tv.VanError("channel is closed")
            if self._rx.closed:
                raise tv.VanError("recv failed: peer closed shm lane")
            if stop is not None and stop():
                raise tv.VanError("recv aborted: local stop")
            # the TCP probe is a real syscall (tens of µs on virtualized
            # kernels): only pay it once the ring has stayed quiet for a
            # whole wait slice — spills and peer death are rare events a
            # few ms of discovery latency cannot hurt
            if misses and self._ch.poll_readable(0):
                # spilled oversize frame, or EOF (recv raises VanError)
                return self._ch.recv(), None
            st = self._rx.wait_tail(self._rx._head,
                                    skip_spin=misses > 0)
            if st != 1:
                slept = True
            misses = misses + 1 if st == 0 else 0

    # -- lifecycle ------------------------------------------------------------

    def shutdown(self) -> None:
        """Sever without freeing: the peer (and any thread blocked in a
        poll loop here) wakes with EOF. Safe from any thread."""
        self._tx.close()
        self._ch.shutdown()

    def close(self) -> None:
        self._closed = True
        try:
            self._tx.close()
        except Exception:
            pass  # the mapping may already be gone
        self._ch.close()


class ShmChannel(_Endpoint):
    """Worker-side upgraded channel: drop-in for
    :class:`~ps_tpu_torch.control.tensor_van.Channel` on the request/reply
    paths (``send``/``send_parts``/``recv``/``request``/
    ``request_parts``/``shutdown``/``close``).

    ``recv`` COPIES the reply out of the ring (into the receive-buffer
    pool when one is attached): replies flow through futures to consumers
    whose lifetimes the lane cannot see, so in-place views would be a
    use-after-consume hazard. The asymmetric win stands: the worker→server
    direction (gradient pushes — the hot, big direction) is written once
    and decoded in place server-side.
    """

    def __init__(self, ch, tx: ShmRing, rx: ShmRing, segs, stats=None):
        super().__init__(ch, tx, rx, stats)
        self._segs = segs  # owned segments: closed AND unlinked here

    def recv(self) -> memoryview:
        got, advance = self._poll_recv()
        if advance is None:
            return got  # TCP spill: Channel.recv already owns the bytes
        n = len(got)
        buf = self.pool.borrow(n) if self.pool is not None else None
        if buf is None:
            buf = bytearray(n)
        self._rx.copy_out(got, buf)  # GIL-free bulk copy
        self._rx.consume(advance)
        return memoryview(buf)[:n]

    def request(self, payload) -> memoryview:
        self.send(payload)
        return self.recv()

    def request_parts(self, header, chunks) -> memoryview:
        self.send_parts(header, chunks)
        return self.recv()

    def close(self) -> None:
        super().close()
        for seg in self._segs:
            try:
                seg.close()
            except Exception:
                pass
            try:
                seg.unlink()
            except Exception:
                pass  # already unlinked (double close is fine)
        self._segs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ServerShmLane(_Endpoint):
    """Server-side lane: the serve loop's view of an upgraded connection.

    ``recv`` hands out the request frame IN PLACE (zero copy — this is
    the lane's whole point for pushes) and defers the ring-space release
    to the NEXT ``recv`` call: the van's serve loop always finishes
    handling + replying before it asks for the next frame, so the frame's
    bytes are provably dead by then. The attached segments are closed but
    NOT unlinked on close — the worker owns them.
    """

    def __init__(self, ch, tx: ShmRing, rx: ShmRing, segs, stats=None):
        super().__init__(ch, tx, rx, stats)
        self._segs = segs  # attached (not owned): closed, never unlinked
        self._pending_advance = 0

    def recv(self, stop=None) -> memoryview:
        if self._pending_advance:
            self._rx.consume(self._pending_advance)
            self._pending_advance = 0
        got, advance = self._poll_recv(stop=stop)
        if advance is None:
            return got  # TCP spill (already copied out)
        self._pending_advance = advance
        return got

    def close(self) -> None:
        super().close()
        for seg in self._segs:
            try:
                seg.close()
            except Exception:
                pass
        self._segs = []


# -- negotiation --------------------------------------------------------------


def try_upgrade(ch, worker: int, shm_bytes: int = DEFAULT_SHM_BYTES,
                stats=None):
    """Offer the server a shared-memory lane over connected channel
    ``ch``; returns the upgraded :class:`ShmChannel` or — on ANY
    negotiation failure (cross-host boot id, segment creation refused,
    server predates the lane) — ``ch`` unchanged, so callers can call
    this unconditionally. Only a DEAD channel raises (VanError), exactly
    like any other request on it.

    ``PS_SHM_BOOT_ID`` overrides the advertised boot id (tests force a
    cross-host-shaped mismatch with it)."""
    size = _DATA + max(int(shm_bytes), 1 << 16)
    segs = []
    try:
        # _Segment's create-path prefault zero-fills the whole mapping,
        # cursors and flags included
        for _ in range(2):
            segs.append(_create(size))
    except Exception:
        for seg in segs:
            seg.close()
            seg.unlink()
        return ch
    c2s, s2c = segs
    from ps_tpu_torch.config import env_str

    bid = env_str("PS_SHM_BOOT_ID") or boot_id()
    try:
        reply = ch.request(tv.encode(tv.SHM_SETUP, worker, None, extra={
            "boot_id": bid, "c2s": c2s.name, "s2c": s2c.name,
            "bytes": size,
        }))
        kind, _, _, extra = tv.decode(reply)
    except BaseException:  # dead channel / garbage reply: don't leak segs
        for seg in segs:
            seg.close()
            seg.unlink()
        raise
    if kind != tv.OK or not extra.get("shm"):
        for seg in segs:
            seg.close()
            seg.unlink()
        return ch
    return ShmChannel(ch, tx=ShmRing(c2s.buf), rx=ShmRing(s2c.buf),
                      segs=segs, stats=stats)


def accept_upgrade(ch, extra: dict, stats=None) -> ServerShmLane:
    """Server half of the negotiation: validate the boot id and attach the
    worker's segments. Raises on any mismatch/failure — the caller turns
    that into an ERR reply and the connection stays plain TCP."""
    if extra.get("boot_id") != boot_id():
        raise ValueError(
            f"shm lane refused: peer boot id {extra.get('boot_id')!r} is "
            f"not this host's — cross-host connections ride TCP"
        )
    c2s = _attach(str(extra["c2s"]))
    try:
        s2c = _attach(str(extra["s2c"]))
    except Exception:
        c2s.close()
        raise
    # the offer names the segment size it created; the attach must see
    # exactly that (a truncated/raced segment would corrupt ring framing
    # at the first wrap)
    want = int(extra.get("bytes") or 0)
    if want and (len(c2s.buf) != want or len(s2c.buf) != want):
        c2s.close()
        s2c.close()
        raise ValueError(
            f"shm lane refused: segment size mismatch (offer says {want} "
            f"bytes, attached {len(c2s.buf)}/{len(s2c.buf)})"
        )
    try:
        return ServerShmLane(ch, tx=ShmRing(s2c.buf), rx=ShmRing(c2s.buf),
                             segs=[c2s, s2c], stats=stats)
    except Exception:  # e.g. a segment too small for a ring
        c2s.close()
        s2c.close()
        raise
