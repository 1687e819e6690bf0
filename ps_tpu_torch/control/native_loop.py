"""The Python side of the van's native epoll serve loop.

Counterpart of ``ps_tpu/control/native_loop.py``, over the port's copy of
``van.cpp`` (its ``nl_*`` ABI). The thread-per-connection serve path runs
one Python thread a worker connection; here accept, frame reads and
scatter-gather reply writes run on a small fixed pool of native threads
(default 1) without the GIL, and Python's part shrinks to one pump thread
that calls :meth:`NativeEventLoop.poll` (the GIL released for the wait:
ctypes releases it around every foreign call) and gets a batch of
complete request frames to decode and dispatch.

Ownership (as on the C side):

- a polled request's body belongs to Python until :meth:`free`: replies
  may alias the request's tensors, and a copy to the card out of it must
  have completed (not merely been queued) before the free, so free after
  the reply;
- :meth:`reply` keeps none of the caller's buffers: what the socket does
  not take at once is copied to a native tail and flushed on EPOLLOUT;
- :meth:`close` runs only after the pump thread left (poll returned
  None); ``begin_stop`` orders that.

The loop also mirrors the services' push ledger (native push admission:
a pure replay is acked, a role refusal answered, a fresh push stamped,
all inside the loop threads) and keeps its own latency histograms.
Its read cache (the ``cache_*`` calls) answers a READ whose exact request
bytes it holds with the reply the pump published for them, without an
upcall, until an apply invalidates the entry (by generation, or by the
sparse service's per-row tags); a NOT_MODIFIED entry answers every
conditional READ at or above its version floor.

Linux only (epoll); :func:`available` gates the services' fallback to
thread-per-connection serving.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

from ps_tpu_torch.native import load

#: max requests one poll() hands back: the upcall batch bound
MAX_BATCH = 64

#: in-loop histogram geometry: lo=1e-6 s, hi=3600 s, 4 sub-buckets per
#: octave, in lockstep with van.cpp's kNlHist* constants and with
#: obs/metrics.Histogram, so a native snapshot's raw buckets land there
#: unchanged
NL_HIST_LO = 1e-6
NL_HIST_HI = 3600.0
NL_HIST_BUCKETS = 129  # kNlHistNb + underflow + overflow

#: nl_hist_snapshot `which` index -> the TransportStats histogram key it
#: feeds (position-coupled with van.cpp's kNlHist* indices)
NL_HISTS = (
    (0, "nl_read_frame_s"),   # first byte -> frame complete
    (1, "nl_queue_wait_s"),   # frame complete -> claimed by the pump
    (2, "nl_read_hit_s"),     # frame complete -> native cache reply written
    (3, "nl_flush_s"),        # tail staged -> EPOLLOUT drain done
)

#: fixed per-entry layout of nl_slow_drain's out buffers
_SLOW_VALS = 7   # conn, kind, size, read_ns, wait_ns, serve_ns, age_ns
_SLOW_TID = 20   # NUL-terminated id slot (trace then span per entry)

_configured = None


def _lib():
    global _configured
    lib = load("van")
    if _configured is lib:
        return lib
    # every row mirrors a signature of van.cpp's extern "C" block
    lib.nl_start.restype = ctypes.c_void_p
    lib.nl_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nl_poll.restype = ctypes.c_int
    lib.nl_poll.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.nl_poll2.restype = ctypes.c_int
    lib.nl_poll2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
    ]
    lib.nl_reply_vec.restype = ctypes.c_int
    lib.nl_reply_vec.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.nl_body_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nl_detach.restype = ctypes.c_int
    lib.nl_detach.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nl_stop_accept.argtypes = [ctypes.c_void_p]
    lib.nl_shutdown_conns.argtypes = [ctypes.c_void_p]
    lib.nl_pending.restype = ctypes.c_uint64
    lib.nl_pending.argtypes = [ctypes.c_void_p]
    lib.nl_conn_count.restype = ctypes.c_int
    lib.nl_conn_count.argtypes = [ctypes.c_void_p]
    lib.nl_stats.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.nl_begin_stop.argtypes = [ctypes.c_void_p]
    lib.nl_stop.argtypes = [ctypes.c_void_p]
    lib.nl_cache_config.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_uint64]
    lib.nl_cache_put.restype = ctypes.c_int
    lib.nl_cache_put.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.nl_cache_invalidate.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nl_cache_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.nl_cache_put_tagged.restype = ctypes.c_int
    lib.nl_cache_put_tagged.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.nl_cache_invalidate_tags.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.nl_cache_put_cond.restype = ctypes.c_int
    lib.nl_cache_put_cond.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_uint64,
    ]
    lib.nl_admit_config.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nl_admit_put.restype = ctypes.c_int
    lib.nl_admit_put.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    lib.nl_admit_set_ack.restype = ctypes.c_int
    lib.nl_admit_set_ack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_uint64]
    lib.nl_admit_set_refusal.restype = ctypes.c_int
    lib.nl_admit_set_refusal.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64]
    lib.nl_admit_invalidate.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nl_admit_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nl_admit_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.nl_telemetry_config.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_uint64]
    lib.nl_hist_snapshot.restype = ctypes.c_int
    lib.nl_hist_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint64)]
    lib.nl_stats_snapshot.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.nl_slow_drain.restype = ctypes.c_int
    lib.nl_slow_drain.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.nl_hist_record.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint64]
    lib.tv_adopt_fd.restype = ctypes.c_void_p
    lib.tv_adopt_fd.argtypes = [ctypes.c_int]
    _configured = lib
    return lib


def available() -> bool:
    """True when the native event loop can run here: Linux (epoll) and a
    van build exposing the ``nl_*`` symbols."""
    if not sys.platform.startswith("linux"):
        return False
    try:
        return hasattr(_lib(), "nl_start")
    except Exception:
        return False


class NativeEventLoop:
    """One running ``nl_*`` loop over an existing van Listener.

    The listener stays owned by the caller and must outlive :meth:`close`
    (the loop only borrows its fd). All methods are safe from the pump
    thread; :meth:`close` additionally requires the pump to have exited.
    """

    def __init__(self, listener, threads: int = 1):
        self._lib = _lib()
        self._lock = threading.Lock()
        # liveness pin, mirroring the C side's per-conn pin: reply() must
        # NOT hold the handle lock across its native call (a multi-MB
        # reply tail memcpy would serialize every other caller behind
        # it); instead callers pin the handle, run lock-free, unpin —
        # and close() waits out the pins before freeing
        self._cv = threading.Condition(self._lock)
        self._users = 0
        self._closed = False
        h = self._lib.nl_start(listener._h, int(threads))
        if not h:
            raise OSError("native event loop failed to start")
        self._h = h
        self.threads = int(threads)
        self._ids = (ctypes.c_uint64 * MAX_BATCH)()
        self._ptrs = (ctypes.c_void_p * MAX_BATCH)()
        self._lens = (ctypes.c_uint64 * MAX_BATCH)()
        self._admits = (ctypes.c_uint64 * MAX_BATCH)()
        self._stats_out = (ctypes.c_uint64 * 6)()
        self._cache_out = (ctypes.c_uint64 * 9)()
        self._admit_out = (ctypes.c_uint64 * 8)()
        self._hist_out = (ctypes.c_uint64 * (4 + NL_HIST_BUCKETS))()
        self._nl_out = (ctypes.c_uint64 * 8)()
        self._slow_vals = (ctypes.c_uint64 * (_SLOW_VALS * MAX_BATCH))()
        self._slow_tids = ctypes.create_string_buffer(
            2 * _SLOW_TID * MAX_BATCH)
        # bodies currently claimed by Python (poll handed them out, free
        # not yet called): makes free() IDEMPOTENT — an error-path caller
        # can release unconditionally without risking a double free
        self._claimed = set()

    # -- pump side -----------------------------------------------------------

    def poll(self, timeout_ms: int = 100
             ) -> Optional[List[Tuple[int, memoryview, int, int]]]:
        """Wait (GIL released) for ready requests. Returns a list of
        ``(conn_id, frame_view, body_ptr, admit_gen)`` — possibly empty
        on timeout — or None once the loop is stopping and fully drained
        (the pump's exit signal). ``admit_gen`` is the native admission
        stamp: 0 for an unclassified frame, otherwise floor + 1 for a
        PUSH frame the owner thread proved fresh (trust it only while
        the engine's read generation still equals ``admit_gen - 1``).
        The frame view aliases native memory owned by the caller until
        :meth:`free`."""
        if self._closed:  # racing close(): the loop is gone
            return None
        n = self._lib.nl_poll2(self._h, self._ids, self._ptrs, self._lens,
                               self._admits, MAX_BATCH, int(timeout_ms))
        if n < 0:
            return None
        out = []
        with self._lock:
            for i in range(n):
                ptr, ln = self._ptrs[i], self._lens[i]
                if ln:
                    view = memoryview(
                        (ctypes.c_char * ln).from_address(ptr)).cast("B")
                else:
                    view = memoryview(b"")
                self._claimed.add(int(ptr))
                out.append((int(self._ids[i]), view, int(ptr),
                            int(self._admits[i])))
        return out

    def reply(self, conn_id: int, payload, close_after: bool = False,
              priority: int = 0) -> bool:
        """Send one reply frame — a contiguous bytes/bytearray or the
        zero-copy ``(header, chunks)`` parts form. The buffers are used
        only for the duration of the call (an unsent tail is copied
        native-side). ``priority`` tags any staged tail for the loop's
        priority writev drain (lower flushes first; bucket replies pass
        their bucket index so front-of-model bytes leave before the tail
        layers'). False = the connection is gone."""
        if isinstance(payload, tuple):
            header, chunks = payload
            views = [np.frombuffer(header, np.uint8)]
            views += [np.frombuffer(c, np.uint8) for c in chunks if len(c)]
        else:
            views = [np.frombuffer(payload, np.uint8)]
        n = len(views)
        ptrs = (ctypes.c_void_p * n)(*(v.ctypes.data for v in views))
        lens = (ctypes.c_uint64 * n)(*(v.nbytes for v in views))
        if not self._pin():
            return False
        try:
            ok = self._lib.nl_reply_vec(self._h, conn_id, ptrs, lens, n,
                                        1 if close_after else 0,
                                        int(priority))
        finally:
            self._unpin()
        del views  # pinned the sources for exactly the call's duration
        return bool(ok)

    def _pin(self) -> bool:
        with self._cv:
            if self._closed:
                return False
            self._users += 1
            return True

    def _unpin(self) -> None:
        with self._cv:
            self._users -= 1
            if self._users == 0:
                self._cv.notify_all()

    def free(self, body_ptr: int) -> None:
        """Release one request body (AFTER the reply — it may alias).
        Idempotent: a body already freed (or never claimed) is a no-op,
        so error paths can release unconditionally."""
        with self._lock:
            if self._closed or body_ptr not in self._claimed:
                return
            self._claimed.discard(body_ptr)
            self._lib.nl_body_free(self._h, body_ptr)

    def detach(self, conn_id: int) -> int:
        """Pull a connection out of the loop; returns its raw fd in
        blocking mode (-1 = connection already gone). The SHM_SETUP
        upgrade path adopts the fd into a classic Channel + serve
        thread."""
        if not self._pin():  # detach can wait on the owner thread — it
            return -1        # must not hold the handle lock meanwhile
        try:
            return int(self._lib.nl_detach(self._h, conn_id))
        finally:
            self._unpin()

    # -- native read cache (zero-upcall READ serving) ---------------------------

    def cache_config(self, kind: int, max_bytes: int) -> None:
        """Enable the native read cache: frames whose first body byte is
        ``kind`` (the wire kind — tv.READ) are answered inside the loop
        threads on an exact-byte match, with ``max_bytes`` bounding
        key+reply memory (0 disables)."""
        with self._lock:
            if not self._closed:
                self._lib.nl_cache_config(self._h, int(kind),
                                          int(max_bytes))

    def cache_put(self, key: bytes, reply, gen: int,
                  tags=None) -> bool:
        """Publish one reply frame for the request bytes ``key`` at
        publish generation ``gen`` (captured under the engine lock with
        the snapshot the reply serializes). ``tags`` optionally names the
        state slice the reply covers (u64s — the sparse service's
        per-(table, row) hashes) so :meth:`cache_invalidate` with tags
        can drop only intersecting entries; None publishes an untagged
        entry that every invalidation drops (the conservative default).
        False = refused: the cache is off, the entry is over budget, or —
        the invalidation race — an apply already raised the floor past
        ``gen``. Buffers are copied native-side; never retained."""
        kv = np.frombuffer(key, np.uint8)
        rv = np.frombuffer(reply, np.uint8)
        if not self._pin():
            return False
        try:
            if tags:
                arr = (ctypes.c_uint64 * len(tags))(*[int(t) for t in tags])
                ok = self._lib.nl_cache_put_tagged(
                    self._h, kv.ctypes.data, kv.nbytes, rv.ctypes.data,
                    rv.nbytes, int(gen), arr, len(tags))
            else:
                ok = self._lib.nl_cache_put(self._h, kv.ctypes.data,
                                            kv.nbytes, rv.ctypes.data,
                                            rv.nbytes, int(gen))
        finally:
            self._unpin()
        del kv, rv  # pinned the sources for exactly the call's duration
        return bool(ok)

    def cache_put_cond(self, key: bytes, reply, gen: int, tags=None,
                       vfloor: int = 0) -> bool:
        """Publish one conditional (NOT_MODIFIED) reply for the
        CONDITIONAL request bytes ``key``: the native side sniffs the
        request's ``"cond":`` token, excises its digits, and stores the
        spliced key with version floor ``vfloor`` (the server version the
        reply stamps) — any later conditional request whose sniffed known
        version >= ``vfloor`` is answered from this entry with zero
        upcalls, exactly the pump's unchanged-target comparison. Floor
        refusal, budget, eviction and ``tags`` semantics match
        :meth:`cache_put`."""
        kv = np.frombuffer(key, np.uint8)
        rv = np.frombuffer(reply, np.uint8)
        if not self._pin():
            return False
        try:
            arr, n = None, 0
            if tags:
                arr = (ctypes.c_uint64 * len(tags))(*[int(t) for t in tags])
                n = len(tags)
            ok = self._lib.nl_cache_put_cond(
                self._h, kv.ctypes.data, kv.nbytes, rv.ctypes.data,
                rv.nbytes, int(gen), arr, n, int(vfloor))
        finally:
            self._unpin()
        del kv, rv  # pinned the sources for exactly the call's duration
        return bool(ok)

    def cache_invalidate(self, gen: int, tags=None) -> None:
        """Invalidation-on-apply: raise the publish floor to ``gen`` and
        drop cached entries — every entry when ``tags`` is None, else
        only entries whose tag set intersects ``tags`` (untagged entries
        always drop: they claim nothing). Pin-based (not the handle
        lock): this runs on the engine apply path and must never queue
        behind a multi-MB reply."""
        if not self._pin():
            return
        try:
            if tags:
                arr = (ctypes.c_uint64 * len(tags))(*[int(t) for t in tags])
                self._lib.nl_cache_invalidate_tags(self._h, int(gen), arr,
                                                   len(tags))
            else:
                self._lib.nl_cache_invalidate(self._h, int(gen))
        finally:
            self._unpin()

    def cache_stats(self) -> dict:
        """Cumulative cache counters: hits (zero-upcall replies), misses
        (cacheable frames that took the pump path), puts, rejects,
        invalidations, live entries, bytes held, the invalidation floor,
        and cond_hits (the subset of hits served from a version-floor
        NOT_MODIFIED entry)."""
        with self._lock:
            if self._closed:
                return {"hits": 0, "misses": 0, "puts": 0, "rejects": 0,
                        "invalidations": 0, "entries": 0, "bytes": 0,
                        "floor": 0, "cond_hits": 0}
            self._lib.nl_cache_stats(self._h, self._cache_out)
            o = self._cache_out
            return {"hits": int(o[0]), "misses": int(o[1]),
                    "puts": int(o[2]), "rejects": int(o[3]),  # pslint: disable=PSL203 -- cache_stats() field for operators and the tests (entries put into the native read cache); not a wire header
                    "invalidations": int(o[4]), "entries": int(o[5]),
                    "bytes": int(o[6]), "floor": int(o[7]),
                    "cond_hits": int(o[8])}

    # -- native push admission (the zero-upcall push plane) -------------------

    def admit_config(self, kind: int) -> None:
        """Arm push admission: frames whose first body byte is ``kind``
        (the wire kind — tv.PUSH or tv.ROW_PUSH) are classified inside
        the loop threads against the ledger mirror (kind < 0 disables
        and clears the ledger and both reply templates)."""
        with self._lock:
            if not self._closed:
                self._lib.nl_admit_config(self._h, int(kind))

    def admit_put(self, worker: int, nonce: bytes, lo: int, hi: int,
                  gen: int) -> bool:
        """Publish one worker's ledger mirror entry: ``nonce`` its
        current push nonce, ``lo`` the settled dedup bound (every key
        the worker pushes settled at seq <= lo), ``hi`` the recorded
        bound, ``gen`` the publish generation captured under the engine
        lock. False = refused (admission off, an apply already raised
        the floor past ``gen``, or a malformed nonce/window). The nonce
        is copied native-side; never retained. A ``str`` nonce is
        UTF-8 encoded — the native sniffer matches the frame's raw JSON
        string bytes, and a nonce needing JSON escapes simply never
        matches (the frame punts to the pump, which is always safe)."""
        if isinstance(nonce, str):
            nonce = nonce.encode("utf-8")
        nv = np.frombuffer(nonce, np.uint8)
        if not self._pin():
            return False
        try:
            ok = self._lib.nl_admit_put(self._h, int(worker),
                                        nv.ctypes.data, nv.nbytes,
                                        int(lo), int(hi), int(gen))
        finally:
            self._unpin()
        del nv  # pinned the source for exactly the call's duration
        return bool(ok)

    def admit_set_ack(self, frame: bytes, gen: int) -> bool:
        """Publish the replay-ack template — the complete reply frame
        the pump would send for a full-dedup replay, captured under the
        engine lock with the version stamp the ledger covers (the worker
        id is patched per serve). ``b""`` clears. False = refused: an
        apply already raised the floor past ``gen``."""
        fv = np.frombuffer(frame, np.uint8)
        if not self._pin():
            return False
        try:
            ok = self._lib.nl_admit_set_ack(
                self._h, fv.ctypes.data if fv.nbytes else None, fv.nbytes,
                int(gen))
        finally:
            self._unpin()
        del fv  # pinned the source for exactly the call's duration
        return bool(ok)

    def admit_set_refusal(self, frame: bytes) -> bool:
        """Publish (or clear, ``b""``) the role-refusal template: the
        typed ERR every admissible PUSH frame gets while this shard must
        refuse pushes (backup role, fenced zombie)."""
        fv = np.frombuffer(frame, np.uint8)
        if not self._pin():
            return False
        try:
            ok = self._lib.nl_admit_set_refusal(
                self._h, fv.ctypes.data if fv.nbytes else None, fv.nbytes)
        finally:
            self._unpin()
        del fv  # pinned the source for exactly the call's duration
        return bool(ok)

    def admit_invalidate(self, gen: int) -> None:
        """Invalidation-on-apply (the push twin of
        :meth:`cache_invalidate`): raise the admission floor to ``gen``
        and drop the version-stamped ack template; the ledger persists
        (its bounds only ever advance, so stale entries punt — never
        mis-ack). Pin-based: runs on the engine apply path."""
        if not self._pin():
            return
        try:
            self._lib.nl_admit_invalidate(self._h, int(gen))
        finally:
            self._unpin()

    def admit_reset(self, gen: int) -> None:
        """Structural re-seed (promotion, fence, migrate, pause/resume):
        raise the floor and drop the ledger and BOTH templates; the
        caller republishes whatever the new role/state allows."""
        if not self._pin():
            return
        try:
            self._lib.nl_admit_reset(self._h, int(gen))
        finally:
            self._unpin()

    def admit_stats(self) -> dict:
        """Cumulative admission counters: acks (native replay OKs),
        refusals (native typed ERRs), fresh (stamped + queued), punts
        (admissible frames the pump classified), ledger entries, floor,
        and whether each template is armed."""
        with self._lock:
            if self._closed:
                return {"acks": 0, "refusals": 0, "fresh": 0, "punts": 0,
                        "entries": 0, "floor": 0, "ack_armed": False,
                        "refusal_armed": False}
            self._lib.nl_admit_stats(self._h, self._admit_out)
            o = self._admit_out
            return {"acks": int(o[0]), "refusals": int(o[1]),
                    "fresh": int(o[2]), "punts": int(o[3]),
                    "entries": int(o[4]), "floor": int(o[5]),
                    "ack_armed": bool(o[6]), "refusal_armed": bool(o[7])}

    # -- in-loop telemetry ----------------------------------------------------

    def telemetry_config(self, stats_on: bool, slow_frame_ns: int) -> None:
        """Arm/disarm the loop's own telemetry: ``stats_on`` gates every
        histogram stamp (off = the pre-telemetry hot path plus one
        relaxed load per frame), ``slow_frame_ns`` the slow-frame
        watchdog threshold (0 = off)."""
        with self._lock:
            if not self._closed:
                self._lib.nl_telemetry_config(
                    self._h, 1 if stats_on else 0, int(slow_frame_ns))

    def hist_snapshots(self) -> dict:
        """The in-loop histograms as raw-state dicts in
        :class:`~ps_tpu_torch.obs.metrics.Histogram`'s geometry, keyed
        by their ``TransportStats.hist`` name (``nl_read_hit_s``, ...).
        Stripes are summed natively; sums and extrema convert ns -> s
        here."""
        out = {}
        with self._lock:
            if self._closed:
                return out
            for which, key in NL_HISTS:
                nb = self._lib.nl_hist_snapshot(self._h, which,
                                                self._hist_out)
                if nb != NL_HIST_BUCKETS:
                    continue  # geometry drifted: skip rather than corrupt
                o = self._hist_out
                total = int(o[0])
                out[key] = {
                    "lo": NL_HIST_LO, "hi": NL_HIST_HI,
                    "c": [int(o[4 + b]) for b in range(nb)],
                    "n": total, "s": int(o[1]) / 1e9,
                    "mx": int(o[3]) / 1e9,
                    "mn": (int(o[2]) / 1e9 if total else None),
                }
        return out

    def stats_snapshot(self) -> dict:
        """The loop's non-histogram telemetry: staged-tail backlog/total
        bytes, tail drains, slow-frame counters, and the armed config."""
        with self._lock:
            if self._closed:
                return {"tail_backlog_bytes": 0, "tail_staged_bytes": 0,
                        "tail_flushes": 0, "slow_frames": 0,
                        "slow_dropped": 0, "stats_on": False,
                        "slow_frame_ns": 0}
            self._lib.nl_stats_snapshot(self._h, self._nl_out)
            o = self._nl_out
            return {"tail_backlog_bytes": int(o[0]),
                    "tail_staged_bytes": int(o[1]),
                    "tail_flushes": int(o[2]),
                    "slow_frames": int(o[3]),
                    "slow_dropped": int(o[4]),
                    "stats_on": bool(o[5]),
                    "slow_frame_ns": int(o[6])}

    def slow_drain(self) -> list:
        """Drain the slow-frame ring: one dict per over-threshold frame
        (conn, wire kind byte, size, per-stage ns, age since record, and
        the sniffed trace context — empty strings when untraced)."""
        out = []
        with self._lock:
            if self._closed:
                return out
            n = self._lib.nl_slow_drain(self._h, self._slow_vals,
                                        self._slow_tids, MAX_BATCH)
            for i in range(n):
                v = self._slow_vals[i * _SLOW_VALS:(i + 1) * _SLOW_VALS]
                base = i * 2 * _SLOW_TID
                raw = self._slow_tids.raw
                trace = raw[base:base + _SLOW_TID].split(b"\0", 1)[0]
                span = raw[base + _SLOW_TID:base + 2 * _SLOW_TID].split(
                    b"\0", 1)[0]
                out.append({
                    "conn": int(v[0]), "kind": int(v[1]),
                    "size": int(v[2]), "read_ns": int(v[3]),
                    "wait_ns": int(v[4]), "serve_ns": int(v[5]),
                    "age_ns": int(v[6]),
                    "trace_id": trace.decode("ascii", "replace"),
                    "span_id": span.decode("ascii", "replace"),
                })
        return out

    # -- lifecycle / introspection -------------------------------------------

    def stop_accept(self) -> None:
        with self._lock:
            if not self._closed:
                self._lib.nl_stop_accept(self._h)

    def shutdown_conns(self) -> None:
        with self._lock:
            if not self._closed:
                self._lib.nl_shutdown_conns(self._h)

    def begin_stop(self) -> None:
        """Signal shutdown: loop threads exit, poll() drains then returns
        None. Does not free — call :meth:`close` after the pump joined."""
        with self._lock:
            if not self._closed:
                self._lib.nl_begin_stop(self._h)

    def pending(self) -> int:
        """Requests not yet fully answered (ready + claimed by Python +
        unflushed reply tails) — what stop()'s drain waits out."""
        with self._lock:
            if self._closed:
                return 0
            return int(self._lib.nl_pending(self._h))

    def stats(self) -> dict:
        """Cumulative loop counters: epoll iterations, accepted
        connections, requests read, live connections, pending, claimed."""
        with self._lock:
            if self._closed:
                return {"iters": 0, "accepted": 0, "requests": 0,
                        "conns": 0, "pending": 0, "claimed": 0}
            self._lib.nl_stats(self._h, self._stats_out)
            o = self._stats_out
            return {"iters": int(o[0]), "accepted": int(o[1]),
                    "requests": int(o[2]), "conns": int(o[3]),
                    "pending": int(o[4]), "claimed": int(o[5])}

    def close(self) -> None:
        """Join the loop threads and free everything. The pump thread must
        have exited (poll returned None) before this runs; pinned callers
        (replies/detaches mid-call on punted threads) are waited out —
        their calls are bounded (non-blocking writes + memcpy)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True  # no NEW pin can be taken
            while self._users > 0:
                self._cv.wait()
            self._lib.nl_stop(self._h)
            self._h = None


def adopt_channel(fd: int):
    """Wrap a detached raw fd as a blocking :class:`tensor_van.Channel`."""
    from ps_tpu_torch.control import tensor_van as tv

    h = _lib().tv_adopt_fd(int(fd))
    return tv.Channel(h, tv._lib())
