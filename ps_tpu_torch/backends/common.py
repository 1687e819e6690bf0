"""What the port's parameter servers share.

Counterpart of the engine half of ``ps_tpu/backends/common.py``: the
async whole-tree DC apply (``make_dc_apply_tree``), the side-effect-free
read (``PeekMixin``), the per-worker staging of per-key async pushes
(``AsyncStagingMixin``) and the worker-id floor of aggregator identities
(``AGG_WORKER_BASE``), plus the one place a backend picks its device.

And the van half: the typed server failure, the uri parser, the payload
helpers, ``BucketPlan``/``BucketAssembler`` (fusion buckets and their
tear-proof reassembly), ``ChannelPump`` (one connection and its sender
thread) and ``BucketedTransportMixin`` (the worker side of the bucketed,
pipelined transport, with the gradient codecs and the same-host
shared-memory lane offer), plus the staging of tensors between the card
and pinned host memory (``stage_to_host``, ``stage_to_device``), which
every CUDA tensor crossing the van takes, and the worker half of
replication: ``parse_replica_uri`` (``|``-separated replica sets a
shard) and the failover loop of ``BucketedTransportMixin``
(``_with_failover``), which re-routes a failed shard to a serving member
and retries the whole operation.

Every apply here is out of place: it clones the parameter, updates the
clone and puts it in the server's dict, so a tensor a worker pulled (and
the async stale snapshot, which is that same tensor) keeps its values, as
a JAX array does. Optimizer state is the server's own and is updated in
place.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ps_tpu_torch import obs
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.optim import Optimizer, delay_compensate
from ps_tpu_torch.utils.metrics import TransportStats

#: Worker-id floor for aggregator identities: an aggregator pushes its
#: group's merged gradient under a synthetic worker id past this base, so
#: its DC staleness bookkeeping never collides with a real worker's slot
#: (real ids live in [0, num_workers); the engines admit ids at or past
#: this base explicitly).
AGG_WORKER_BASE = 1 << 20


def backend_device(config) -> torch.device:
    """The one device a backend places everything on: ``config.device``,
    ``cuda:0`` for a bare 'cuda'. Raises when that is a GPU and torch
    finds none; the CPU is used only when the caller names it."""
    device = torch.device(config.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend {config.backend!r} needs an NVIDIA GPU and torch "
                f"finds none; pass device='cpu' to run on the CPU on purpose")
        if device.index is None:
            device = torch.device("cuda", 0)
    return device


def device_copy(value, device) -> torch.Tensor:
    """A fresh copy of a tensor or array on ``device``: a registered value
    never shares memory with the caller's."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.tensor(np.asarray(value), device=device)


def apply_out_of_place(opt: Optimizer, params: Dict[str, torch.Tensor],
                       grads: Dict[str, torch.Tensor], state
                       ) -> Dict[str, torch.Tensor]:
    """One optimizer step on clones of ``params``; returns the new tensors
    and advances ``state`` in place. The given tensors keep their values."""
    new = {k: p.clone() for k, p in params.items()}
    opt.step_(new, grads, state)
    return new


def make_dc_apply_tree(opt: Optimizer):
    """The async whole-tree apply: ``fn(params, states, grads, stales, lam,
    norms=None) -> (params, states)`` over ``{key: ...}`` dicts with one
    optimizer state a key. Key by key: the DC correction against that
    key's stale snapshot, then the optimizer step on the key's own state.
    The correction is elementwise, so ``params``, ``grads`` and
    ``stales`` may be the slices a rank owns, with ``norms`` for the
    whole tensors' (:class:`~ps_tpu_torch.optim.ShardNorms`): their
    deferred steps finish after the last key, one norm all-reduce a tree.
    The reference jits this loop into one XLA program; here it runs
    eagerly."""

    def apply_dc_tree(params, states, grads, stales, lam, norms=None):
        grads = delay_compensate(grads, params, stales, lam)
        new_p = {k: p.clone() for k, p in params.items()}
        for k in params:
            opt.step_({k: new_p[k]}, {k: grads[k]}, states[k], norms)
        if norms is not None:
            norms.finish()
        return new_p, {k: states[k] for k in params}

    return apply_dc_tree


class PeekMixin:
    """Side-effect-free key read for introspection (``KVStore.params()``):
    never records an async pull snapshot or checks aggregation state."""

    def peek(self, key: str) -> torch.Tensor:
        if key not in self._params:
            raise KeyError(f"unregistered key {key!r}")
        return self._params[key]


class AsyncStagingMixin:
    """Per-key async pushes stage per worker and commit as one tree apply
    when that worker's tree completes, so the version bump and the
    staleness sample go to the worker that completed a tree, never to
    whichever worker pushed last under interleaving.

    Liveness: a worker that pushes only some keys commits that partial
    tree when it pulls (the pull ends its push phase in the PS cycle).
    Keys are independent under per-tensor optimizers, so a partial commit
    is the same arithmetic as per-key applies.

    The mixin also keeps the async version bookkeeping both engines share:
    ``version``, ``staleness`` and the pull that records a worker's stale
    snapshot (``_pull_async``).

    Engine contract: ``self._staged_async``/``self._params``/
    ``self._state``/``self._stale``/``self._worker_version`` dicts,
    ``self._apply_dc_tree``, ``self.dc_lambda``, ``self.apply_count``,
    ``self.staleness_hist``, ``self._version`` and ``self.device`` exist,
    and the caller holds the engine lock. Engines may override
    ``_commit_tree_accounting``.
    """

    @property
    def version(self) -> int:
        """Server version in whole-model steps."""
        return self._version

    def staleness(self, worker: int) -> int:
        """Whole-model versions since this worker's last pull (the τ of
        the DC-ASGD correction)."""
        return self._version - self._worker_version.get(worker, 0)

    def _pull_async(self, worker, keys) -> Dict[str, torch.Tensor]:
        """An async pull of ``keys``: commit the worker's staged pushes (a
        pull ends its push phase), then record what it got as its stale
        snapshot and the version it saw — lock held."""
        self._flush_staged(worker)
        out = {k: self._params[k] for k in keys}
        for k, v in out.items():
            self._stale[(worker, k)] = v
        self._worker_version[worker] = self._version
        return out

    def _stage_async_push(self, key, grad, worker) -> None:
        staged = self._staged_async.setdefault(worker, {})
        if key in staged:
            raise RuntimeError(
                f"worker {worker} pushed key {key!r} twice before committing "
                f"— per-key async pushes commit when the full tree is pushed "
                f"or at this worker's next pull (partial tree)")
        staged[key] = grad
        if len(staged) == len(self._params):
            del self._staged_async[worker]
            self._commit_tree(staged, worker)

    def _flush_staged(self, worker) -> None:
        """Commit this worker's staged partial tree, if any (at the top of
        every async pull, lock held)."""
        staged = self._staged_async.pop(worker, None)
        if staged:
            self._commit_tree(staged, worker)

    def _commit_tree(self, grads_kv, worker) -> None:
        """One DC apply of a (possibly partial) tree — lock held."""
        grads_kv = {k: torch.as_tensor(g, device=self.device)
                    for k, g in grads_kv.items()}
        sub_p = {k: self._params[k] for k in grads_kv}
        sub_s = {k: self._state[k] for k in grads_kv}
        stales = {k: self._stale.get((worker, k), self._params[k])
                  for k in grads_kv}
        new_p, new_s = self._apply_dc_tree(sub_p, sub_s, grads_kv, stales,
                                           self.dc_lambda)
        self._params.update(new_p)
        self._state.update(new_s)
        for k in grads_kv:
            self.apply_count[k] += 1
        self.staleness_hist[self.staleness(worker)] += 1
        self._version += 1
        self._commit_tree_accounting(grads_kv)

    def _commit_tree_accounting(self, grads_kv) -> None:
        """Engine hook: extra counters per committed tree (default none)."""

    def _check_staged_async(self) -> None:
        """Guard for a whole-state read (a checkpoint): staged but
        uncommitted grads would be lost."""
        pending = {w: sorted(kv) for w, kv in self._staged_async.items()
                   if kv}
        if pending:
            raise RuntimeError(
                f"cannot checkpoint mid-push: workers {sorted(pending)} have "
                f"staged but uncommitted per-key async pushes")


# -- the van half ------------------------------------------------------------


class ServerFailureError(RuntimeError):
    """A remote PS server died mid-job (its connection failed) or refused
    as not serving (an unpromoted backup, a fenced zombie).

    ``server`` (when known) is the failed server's index into the worker's
    address list: what the failover loop re-routes."""

    def __init__(self, message: str, server: Optional[int] = None):
        super().__init__(message)
        self.server = server


class TableMovedError(RuntimeError):
    """The shard table moved under this worker: a rebalance moved keys
    between shards (``elastic/``). Apart from
    :class:`ServerFailureError` because the remedy differs: the server is
    healthy and only the assignment changed, so the worker fetches the
    table from its coordinator and re-routes (every member of the shard's
    replica set would refuse alike). ``table_epoch`` is the refusing
    server's: the worker waits for a fetched table past its own before it
    retries, so a refusal that raced the coordinator's publish converges."""

    def __init__(self, message: str, server: Optional[int] = None,
                 table_epoch: int = 0):
        super().__init__(message)
        self.server = server
        self.table_epoch = int(table_epoch)


class BackupNotServing(Exception):
    """A replica answered HELLO but is an unpromoted backup: retryable
    (the failover loop waits out the promotion)."""


class ReplicaRejected(Exception):
    """A replica answered HELLO but failed validation (a stale epoch, a
    mismatched topology): skipped, the loop keeps cycling the set."""


def parse_replica_uri(uri: str):
    """``"h0:p0|b0:q0,h1:p1|b1:q1"`` -> ``(primaries, replica_sets)``.

    Commas separate shards; ``|`` separates the members of one shard's
    replica set, the preferred (primary) first. A plain ``host:port`` list
    parses to singleton sets: no failover."""
    primaries, sets = [], []
    for part in uri.split(","):
        cands = []
        for member in part.strip().split("|"):
            host, port = member.strip().rsplit(":", 1)
            cands.append((host, int(port)))
        primaries.append(cands[0])
        sets.append(cands)
    return primaries, sets


#: Default fusion-bucket size of the pipelined transport (~4 MiB: per-frame
#: overhead is noise, and many buckets of a tree are in flight at once).
DEFAULT_BUCKET_BYTES = 4 << 20

#: Default drain_to deadline of the coordinated checkpoint.
DRAIN_TO_TIMEOUT_S = 30.0

# one bucket slice: (key, dtype_str, shape, lo, hi) — byte range [lo, hi)
# within the key's contiguous row-major buffer
Slice = Tuple[str, str, list, int, int]


def _sync_device(device: torch.device) -> None:
    """Wait for the calling thread's current stream on ``device``."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()


def stage_to_host(tensors: Dict[str, object], stats: Optional[TransportStats]
                  = None, copy: bool = False) -> Dict[str, np.ndarray]:
    """``{key: tensor}`` -> ``{key: numpy array}`` that a frame can carry.

    A CUDA tensor is copied into a fresh pinned host tensor on the calling
    thread's current stream, and the copies are waited for (one event)
    before anything is returned, so no send can start on bytes still in
    flight from the card; ``stats`` records their bytes and seconds. A CPU
    tensor is a view (a copy with ``copy``: the caller may change it
    later), numpy arrays pass as they are."""
    out: Dict[str, np.ndarray] = {}
    staged, device, t0 = 0, None, time.perf_counter()
    for k, v in tensors.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            if v.dtype == torch.bfloat16:
                tv.host_array(v.detach().cpu())  # raises the typed error
            pinned = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            pinned.copy_(v.detach(), non_blocking=True)
            out[k] = pinned.numpy()
            staged += pinned.nbytes
            device = v.device
        elif isinstance(v, torch.Tensor):
            out[k] = tv.host_array(v.detach().clone() if copy else v)
        else:
            out[k] = np.array(v) if copy else tv.host_array(v)
    if device is not None:
        _sync_device(device)
        if stats is not None:
            stats.record_staging(staged, time.perf_counter() - t0)
    return out


def stage_to_device(arrays: Dict[str, np.ndarray], device: torch.device,
                    stats: Optional[TransportStats] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{key: numpy array}`` (views of a received frame) -> tensors on
    ``device`` that own their memory. On a CUDA device the copies are
    waited for before returning, so the frame's buffer may go back to its
    receive pool at once; on the CPU the arrays are copied out of it."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}
    t0 = time.perf_counter()
    out = {}
    for k, a in arrays.items():
        a = a if a.flags.writeable else np.array(a)
        out[k] = torch.from_numpy(a).to(device, non_blocking=True)
    _sync_device(device)
    if stats is not None:
        stats.record_staging(sum(a.nbytes for a in arrays.values()),
                             time.perf_counter() - t0)
    return out


def payload_nbytes(payload) -> int:
    """Wire size of a frame in either form: a contiguous bytes/bytearray,
    or the zero-copy ``(header, chunks)`` parts."""
    if isinstance(payload, tuple):
        header, chunks = payload
        return len(header) + sum(len(c) for c in chunks)
    return len(payload)


def send_payload(ch, payload) -> None:
    """Send either payload form on ``ch`` (vectored for parts)."""
    if isinstance(payload, tuple):
        ch.send_parts(*payload)
    else:
        ch.send(payload)


def request_payload(ch, payload):
    """``ch.request`` for either payload form; returns the reply frame."""
    if isinstance(payload, tuple):
        return ch.request_parts(*payload)
    return ch.request(payload)


class BucketPlan:
    """Slice a flat ``{key: array}`` payload into fixed-size fusion buckets.

    Keys are packed greedily in transport order (sorted: front of the
    model first). A tensor larger than ``bucket_bytes`` is split across
    consecutive buckets; small tensors fuse. Every bucket but the last
    holds exactly ``bucket_bytes`` payload bytes, so striping buckets
    round-robin over a connection pool balances it. A bucket's frame
    carries its ``(key, dtype, shape, lo, hi)`` slice table in
    ``extra["slices"]``, so the receiver reassembles it with
    :class:`BucketAssembler` with no plan agreed out of band.
    """

    def __init__(self, specs: Sequence[Tuple[str, str, list, int]],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        """``specs``: ``(key, dtype_str, shape, nbytes)`` in transport
        order."""
        self.bucket_bytes = max(int(bucket_bytes), 1)
        buckets: List[List[Slice]] = []
        cur: List[Slice] = []
        fill = 0
        for key, dt, shape, nbytes in specs:
            shape = list(shape)
            if nbytes == 0:
                cur.append((key, dt, shape, 0, 0))  # the key must appear
                continue
            off = 0
            while off < nbytes:
                if fill >= self.bucket_bytes:
                    buckets.append(cur)
                    cur, fill = [], 0
                take = min(nbytes - off, self.bucket_bytes - fill)
                cur.append((key, dt, shape, off, off + take))
                off += take
                fill += take
        buckets.append(cur)  # the last (empty for an empty payload)
        self.buckets = buckets
        self.total_bytes = sum(n for _, _, _, n in specs)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    order: Optional[Sequence[str]] = None) -> "BucketPlan":
        keys = list(order) if order is not None else sorted(arrays)
        specs = []
        for k in keys:
            a = np.asarray(arrays[k])
            specs.append((k, a.dtype.str, list(a.shape), a.nbytes))
        return cls(specs, bucket_bytes)

    @property
    def nbuckets(self) -> int:
        return len(self.buckets)

    def _bucket_chunks_meta(self, arrays, b: int, extra: Optional[dict]):
        chunks = []
        slices = self.buckets[b]
        for key, _, _, lo, hi in slices:
            a = np.ascontiguousarray(np.asarray(arrays[key]))
            chunks.append(memoryview(a.reshape(-1)).cast("B")[lo:hi])
        meta = {**(extra or {}),
                "bucket": b, "nbuckets": self.nbuckets,
                "slices": [[k, dt, shape, lo, hi]
                           for k, dt, shape, lo, hi in slices]}
        return chunks, meta

    def encode_bucket(self, kind: int, worker: int, arrays, b: int,
                      extra: Optional[dict] = None) -> bytearray:
        """Frame bucket ``b``: each slice's bytes copied once into it."""
        chunks, meta = self._bucket_chunks_meta(arrays, b, extra)
        return tv.encode_chunks(kind, worker, chunks, meta)

    def encode_bucket_parts(self, kind: int, worker: int, arrays, b: int,
                            extra: Optional[dict] = None):
        """Zero-copy form of :meth:`encode_bucket`: ``(header, chunks)``
        with the slice views unstaged (they pin their arrays until sent)."""
        chunks, meta = self._bucket_chunks_meta(arrays, b, extra)
        return tv.encode_chunks_parts(kind, worker, chunks, meta)

    def bucket_encoder(self, writev: bool):
        """Zero-copy parts when ``writev`` is on, the staged frame
        otherwise."""
        return self.encode_bucket_parts if writev else self.encode_bucket


class BucketAssembler:
    """Reassemble a multi-bucket payload; a torn epoch is never observable.

    Buckets may arrive in any order. A bucket of another epoch is refused
    (a straggler of an aborted push can never contaminate a later tree), a
    duplicate bucket is refused, and :meth:`finish` refuses any key whose
    bytes are incomplete. Only when all ``nbuckets`` buckets of one epoch
    have landed does :meth:`add` report completion; the caller applies the
    tree at once, so readers see whole pushes or nothing.
    """

    def __init__(self, epoch: int, nbuckets: int):
        self.epoch = int(epoch)
        self.nbuckets = int(nbuckets)
        self._seen: set = set()
        self._flat: Dict[str, np.ndarray] = {}    # key -> uint8 buffer
        self._meta: Dict[str, Tuple[str, list, int]] = {}
        self._filled: Dict[str, int] = {}

    def add(self, bucket: int, raw, slices, epoch: Optional[int] = None
            ) -> bool:
        """Stage one bucket; returns True when the epoch is complete."""
        if epoch is not None and int(epoch) != self.epoch:
            raise RuntimeError(
                f"bucket of epoch {epoch} offered to assembler of epoch "
                f"{self.epoch} — torn multi-bucket push refused")
        b = int(bucket)
        if not (0 <= b < self.nbuckets):
            raise RuntimeError(
                f"bucket {b} out of range 0..{self.nbuckets - 1}")
        if b in self._seen:
            raise RuntimeError(f"duplicate bucket {b} for epoch {self.epoch}")
        raw = (np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray)
               else raw.reshape(-1).view(np.uint8))
        off = 0
        for key, dt, shape, lo, hi in slices:
            if key not in self._flat:
                nbytes = (int(np.prod(shape, dtype=np.int64))
                          * np.dtype(dt).itemsize)
                self._flat[key] = np.empty(nbytes, np.uint8)
                self._meta[key] = (dt, list(shape), nbytes)
                self._filled[key] = 0
            n = hi - lo
            self._flat[key][lo:hi] = raw[off:off + n]
            self._filled[key] += n
            off += n
        self._seen.add(b)
        return len(self._seen) == self.nbuckets

    def finish(self) -> Dict[str, np.ndarray]:
        """The assembled ``{key: array}`` tree (the assembler's own
        buffers: safe to hold past the frames' lifetimes)."""
        if len(self._seen) != self.nbuckets:
            raise RuntimeError(
                f"epoch {self.epoch} incomplete: {len(self._seen)}/"
                f"{self.nbuckets} buckets")
        out = {}
        for key, (dt, shape, nbytes) in self._meta.items():
            if self._filled[key] != nbytes:
                raise RuntimeError(
                    f"key {key!r} torn: {self._filled[key]}/{nbytes} bytes "
                    f"in epoch {self.epoch}")
            out[key] = self._flat[key].view(np.dtype(dt)).reshape(shape)
        return out


class ChannelPump:
    """One persistent connection and its sender thread.

    Callers ``submit`` frames and get a Future for the reply at once; the
    pump thread drains its queue over its own channel (one driving thread
    a channel, as the van requires). The queue is ordered by a small
    integer priority (lower first), ties by submission, so equal
    priorities stay FIFO: bucket senders pass the bucket index, so a
    backlog drains front-of-model first."""

    def __init__(self, ch, on_io: Optional[Callable] = None):
        self._ch = ch
        self._on_io = on_io  # (bytes_out, bytes_in, seconds) per request
        self._cv = threading.Condition()
        self._heap: list = []   # (priority, seq, payload, fut)
        self._seq = 0
        self._closed = False
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def submit(self, payload, priority: int = 0):
        import concurrent.futures

        fut = concurrent.futures.Future()
        with self._cv:
            if self._closed:
                # fail fast rather than queue behind a dead thread
                fut.set_exception(tv.VanError("pump closed"))
                return fut
            self._seq += 1
            heapq.heappush(self._heap,
                           (int(priority), self._seq, payload, fut))
            self._cv.notify()
        return fut

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._closed:
                    self._cv.wait()
                if not self._heap:
                    return  # closed and drained
                _, _, payload, fut = heapq.heappop(self._heap)
            if not fut.set_running_or_notify_cancel():
                continue
            t0 = time.perf_counter()
            try:
                reply = request_payload(self._ch, payload)
            except BaseException as e:  # surfaced at the caller's wait
                fut.set_exception(e)
                continue
            dt = time.perf_counter() - t0
            if self._on_io is not None:
                try:
                    self._on_io(payload_nbytes(payload), len(reply), dt)
                except Exception:
                    pass  # accounting must never fail the transport
            fut.set_result(reply)

    def close(self) -> None:
        """Stop the thread (after the queue drains) and close the channel;
        requests that slipped in behind the close are failed."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._t.join(timeout=10)
        with self._cv:
            leftovers, self._heap = self._heap, []
        for _, _, _, fut in leftovers:
            fut.set_exception(tv.VanError("pump closed"))
        self._ch.close()


class _OpScope:
    """One logical transport op: its span (NOOP when unsampled) and its
    latency sample in ``TransportStats.record_op``; entering returns the
    span."""

    __slots__ = ("_transport", "_name", "_sp", "_t0")

    def __init__(self, transport, name: str, sp):
        self._transport = transport
        self._name = name
        self._sp = sp

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._sp.__enter__()
        return self._sp

    def __exit__(self, *exc):
        try:
            self._sp.__exit__(*exc)
        finally:
            self._transport.record_op(
                self._name, time.perf_counter() - self._t0)
        return False


class BucketedTransportMixin:
    """Worker-side plumbing of the bucketed, pipelined transport: the pump
    pool, byte and timing accounting, the background cycles and the flush
    barrier, and the transport options every connection of a worker
    shares: the codec policy (``compress``) and the shm lane offer
    (``shm``, ``shm_bytes``).

    Contract: the worker sets ``_addrs``, ``_bytes_lock``, ``worker`` and
    ``bytes_pushed``/``bytes_pulled``, calls :meth:`_init_transport` in its
    init and :meth:`_open_pumps` once its channels are validated.
    """

    _failure_noun = "PS server"

    def _init_transport(self, bucket_bytes: Optional[int],
                        pool_size: Optional[int], compress=None,
                        writev: Optional[bool] = None,
                        shm: Optional[bool] = None,
                        shm_bytes: Optional[int] = None,
                        bucket_priority: Optional[bool] = None) -> None:
        import uuid

        from ps_tpu_torch.compress import (CompressPolicy, GradCompressor,
                                           resolve_spec)
        from ps_tpu_torch.config import env_flag, env_int
        from ps_tpu_torch.control.shm_lane import DEFAULT_SHM_BYTES

        # <= 0 selects the serial transport (PS_BUCKET_BYTES=0 convention)
        self.bucket_bytes = (None if bucket_bytes is None
                             or int(bucket_bytes) <= 0 else int(bucket_bytes))
        # the lanes (None = the env defaults): writev sends frames as
        # scatter-gather iovecs of the live arrays; shm offers each
        # connection the same-host ring lane, keeping TCP on a refusal
        self.writev = (env_flag("PS_WRITEV", True)
                       if writev is None else bool(writev))
        self.shm = env_flag("PS_SHM", False) if shm is None else bool(shm)
        # a ring under 64 KiB would break the wrap sentinel's framing
        self.shm_bytes = (env_int("PS_SHM_BYTES", DEFAULT_SHM_BYTES,
                                  lo=1 << 16)
                          if shm_bytes is None else int(shm_bytes))
        self.bucket_priority = (env_flag("PS_BUCKET_PRIORITY", True)
                                if bucket_priority is None
                                else bool(bucket_priority))
        # incarnation nonce sent with every push: a reconnected worker's
        # epochs restart from zero, and the nonce keeps a staged epoch of
        # the old incarnation from completing with new buckets. (nonce,
        # push-seq) is also the dedup token: a server acks, unapplied, a
        # push whose seq it already applied for this nonce.
        self._transport_nonce = uuid.uuid4().hex[:12]
        self._push_seq = 0
        self.pool_size = (max(int(pool_size), 1) if pool_size is not None
                          else (2 if self.bucket_bytes is not None else 1))
        self.transport = TransportStats()
        # reusable receive buffers for pump replies (consumed, copied out,
        # then returned before the next borrow can alias them)
        self._recv_pool = tv.RecvBufferPool(stats=self.transport)
        self._push_epoch = 0
        self._pull_epoch = 0
        self._pumps: Dict[int, List[ChannelPump]] = {}
        self._bg_pool = None            # the background cycle thread
        self._pending_cycles: List = []  # unobserved background handles
        # gradient compression: the spec (or None) and the compressor,
        # which holds the per-key policy and topk's residuals, so it
        # survives a reconnect (_saved_transport_state)
        self.compress = resolve_spec(compress)
        if self.compress is not None and "seed" not in self.compress:
            # int8's stochastic rounding decorrelated across workers: one
            # shared seed would add their quantization errors coherently
            self.compress = dict(self.compress,
                                 seed=int(getattr(self, "worker", 0)))
        policy = CompressPolicy.from_spec(self.compress)
        self._compressor = (GradCompressor(policy, stats=self.transport)
                            if policy is not None else None)

    def _op(self, name: str, **args) -> _OpScope:
        """One logical op's envelope: a worker span (sampled at
        ``trace_sample``; the NOOP otherwise) and the op's latency sample,
        both end to end, failover retries included. An op issued while
        this thread serves a traced request (the aggregator's merged
        upstream push) parents to the open span instead of rooting a new
        trace, so the chain worker -> aggregator -> shard stays one trace.
        Use ``with self._op("push") as sp``; ``sp.wire()`` is the
        context to send (None unsampled)."""
        parent = obs.tracer().current()
        sp = obs.tracer().span(name, cat="worker", parent=parent)
        if sp:
            sp.set(worker=getattr(self, "worker", 0), **args)
        return _OpScope(self.transport, name, sp)

    @staticmethod
    def _tc_extra(extra: Optional[dict], sp) -> Optional[dict]:
        """``extra`` with the span's wire context merged in; unchanged
        (possibly None) when the op is unsampled, so an untraced frame is
        byte-identical to the reference's."""
        wire = sp.wire() if sp else None
        if wire is None:
            return extra
        out = dict(extra or {})
        out[obs.WIRE_KEY] = wire
        return out

    def _bucket_submit_priority(self, b: int) -> int:
        """Pump priority of bucket ``b``: its index when priority
        scheduling is on, else 0 (pure FIFO)."""
        return int(b) if self.bucket_priority else 0

    def _encode_push_tree(self, arrays: Dict[str, np.ndarray]
                          ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        """One server's push payload through the compression policy: the
        wire tree and the packed keys for the header."""
        if self._compressor is None:
            return arrays, []
        return self._compressor.encode_tree(arrays)

    def _pull_compress_spec(self) -> Optional[dict]:
        """The codec spec a bucketed pull asks the server to apply to its
        reply (None unless the spec says ``pull: true``)."""
        if not self.compress or not self.compress.get("pull"):
            return None
        return {k: v for k, v in self.compress.items() if k != "pull"}

    def _maybe_upgrade(self, ch):
        """Offer the server the shared-memory lane for ``ch`` when ``shm``
        is on; a refused offer keeps the TCP channel (same semantics)."""
        if not self.shm:
            return ch
        from ps_tpu_torch.control import shm_lane

        up = shm_lane.try_upgrade(ch, getattr(self, "worker", 0),
                                  self.shm_bytes, stats=self.transport)
        up.pool = getattr(ch, "pool", None)
        return up

    def _dial_transport_channel(self, host, port):
        """One data-plane connection: dialed, accounted, and upgraded to
        the shm lane when the offer is accepted."""
        ch = tv.Channel.connect(host, port)
        ch.stats = self.transport
        ch.pool = self._recv_pool
        try:
            return self._maybe_upgrade(ch)
        except tv.VanError:
            ch.close()
            raise

    def _open_pumps(self, indices) -> None:
        """Dial ``pool_size`` extra connections a server; the main channels
        stay free for control traffic (stats, checkpoints)."""
        for i in indices:
            host, port = self._addrs[i]
            # registered before filled, so a failed dial mid-pool leaves
            # the opened pumps reachable by _close_transport
            self._pumps[i] = pumps = []
            for _ in range(self.pool_size):
                pumps.append(ChannelPump(
                    self._dial_transport_channel(host, port),
                    on_io=self._on_pump_io))

    def _release_frame(self, frame) -> None:
        """Return a consumed reply frame's buffer to the receive pool."""
        self._recv_pool.ret(frame)

    def _on_pump_io(self, sent: int, received: int, seconds: float) -> None:
        with self._bytes_lock:
            self.bytes_pushed += sent
            self.bytes_pulled += received
        self.transport.record_bucket(sent + received, seconds)

    def _close_transport(self) -> None:
        """Tear down the pumps and the cycle thread; safe on a partial
        construction."""
        if getattr(self, "_bg_pool", None) is not None:
            self._bg_pool.shutdown(wait=False)
            self._bg_pool = None
        for pumps in getattr(self, "_pumps", {}).values():
            for p in pumps:
                p.close()
        self._pumps = {}

    def _bg_executor(self):
        """The one background thread that runs whole transport cycles, so
        cycles serialize per worker and the push/pull order the staleness
        bound rests on is the serial order."""
        if self._bg_pool is None:
            import concurrent.futures

            self._bg_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ps-transport")
        return self._bg_pool

    def _bucket_reply(self, i: int, fut):
        """Resolve one pump future; a dead channel raises the typed failure
        the serial path raises."""
        try:
            return fut.result()
        except tv.VanError as e:
            host, port = self._addrs[i]
            raise ServerFailureError(
                f"{self._failure_noun} {i} ({host}:{port}) failed "
                f"mid-job: {e}", server=i) from e

    def _next_push_seq(self) -> int:
        self._push_seq += 1
        return self._push_seq

    def _reply_error(self, i: int, extra: dict) -> BaseException:
        """The error of an ERR reply: a 'not serving' refusal (an
        unpromoted backup, a zombie fenced mid-commit) is the same
        retryable failure a dead connection raises, so the failover loop
        re-routes and replays; a 'moved' refusal (the shard table changed
        under a rebalance) takes the table's re-route; anything else is an
        application error."""
        host, port = self._addrs[i]
        if extra.get("moved"):
            return TableMovedError(
                f"{self._failure_noun} {i} ({host}:{port}) refused: "
                f"{extra.get('error')}", server=i,
                table_epoch=int(extra.get("table_epoch") or 0))
        if extra.get("backup"):
            return ServerFailureError(
                f"{self._failure_noun} {i} ({host}:{port}) is not "
                f"serving: {extra.get('error')}", server=i)
        return RuntimeError(f"server {i} error: {extra.get('error')}")

    # -- replica sets and live failover (the worker half of replica/) ----------

    def _init_failover(self, replica_sets, failover_timeout) -> None:
        """Record each shard's replica set (the preferred member first) and
        the budget for riding out a promotion. Call after ``_addrs`` is
        set, before dialing."""
        from ps_tpu_torch.config import env_float

        n = len(self._addrs)
        if replica_sets is None:
            replica_sets = [[tuple(a)] for a in self._addrs]
        if len(replica_sets) != n:
            raise ValueError(
                f"replica_sets names {len(replica_sets)} shards but the "
                f"worker dialed {n}")
        self._replica_sets = [[tuple(a) for a in s] for s in replica_sets]
        for i, s in enumerate(self._replica_sets):
            if tuple(self._addrs[i]) not in s:
                raise ValueError(
                    f"server {i}'s address {self._addrs[i]} is not in its "
                    f"replica set {s}")
        if failover_timeout is None:
            failover_timeout = env_float("PS_FAILOVER_TIMEOUT_MS",
                                         10_000.0, lo=0.0) / 1e3
        self.failover_timeout = float(failover_timeout)
        self._epochs = [0] * n  # shard epochs, learned from HELLO

    def _hello(self, ch) -> dict:
        """One HELLO round trip, its refusals typed for the failover
        loop."""
        kind, _, _, extra = tv.decode(
            ch.request(tv.encode(tv.HELLO, self.worker, None)))
        if kind != tv.OK:
            if extra.get("backup"):
                raise BackupNotServing(extra.get("error"))
            raise ReplicaRejected(f"HELLO refused: {extra.get('error')}")
        return extra

    def _validate_failover_hello(self, i: int, extra: dict) -> Optional[str]:
        """Subclass hook: check a promoted replica's HELLO against what the
        worker validated at connect time (an error string, or None)."""
        return None

    def _cycle_replica_set(self, i: int, deadline: float,
                           skip_current: bool = False, validate=None,
                           cause: Optional[BaseException] = None):
        """The replica-set dial loop, shared by the connect-time
        :meth:`_hello_any` and the mid-job :meth:`_failover`: cycle server
        ``i``'s members until one answers HELLO as a serving primary and
        passes ``validate`` (an unpromoted backup or a rejected member
        keeps the loop going), or the deadline passes. Returns ``(channel,
        hello_extra, addr)``; the channel is accounted, not pooled or
        upgraded."""
        cands = self._replica_sets[i]
        k = cands.index(tuple(self._addrs[i])) \
            if tuple(self._addrs[i]) in cands else 0
        if skip_current:
            k += 1
        last: Optional[BaseException] = cause
        while True:
            host, port = cands[k % len(cands)]
            k += 1
            try:
                ch = tv.Channel.connect(host, port, timeout_ms=2000,
                                        retries=2, max_wait_s=0.5)
                ch.stats = self.transport
                try:
                    extra = self._hello(ch)
                    if validate is not None:
                        err = validate(extra)
                        if err is not None:
                            raise ReplicaRejected(err)
                except BaseException:
                    ch.close()
                    raise
                return ch, extra, (host, port)
            except (BackupNotServing, ReplicaRejected, tv.VanError,
                    OSError) as e:
                last = e
            if time.monotonic() >= deadline:
                err = ServerFailureError(
                    f"no member of {self._failure_noun} {i}'s replica set "
                    f"{cands} is serving before the failover deadline: "
                    f"{last}", server=i)
                if cause is not None:
                    raise err from cause
                raise err
            time.sleep(0.05)

    def _hello_any(self, i: int):
        """Connect-time dial of server ``i``: its preferred address or, with
        a replica set, the first member that answers HELLO as a serving
        primary (an unpromoted backup keeps the loop cycling within the
        failover window, so a worker may join a shard mid-promotion).
        Returns ``(channel, hello_extra)``."""
        cands = getattr(self, "_replica_sets",
                        [[tuple(a)] for a in self._addrs])[i]
        if len(cands) == 1:
            host, port = cands[0]
            ch = tv.Channel.connect(host, port)
            ch.stats = self.transport
            try:
                return ch, self._hello(ch)
            except (BackupNotServing, ReplicaRejected) as e:
                ch.close()
                raise ServerFailureError(
                    f"{self._failure_noun} {i} ({host}:{port}) refused "
                    f"HELLO: {e}", server=i) from e
        deadline = time.monotonic() + self.failover_timeout
        ch, extra, addr = self._cycle_replica_set(i, deadline)
        self._addrs[i] = addr
        return ch, extra

    def _failover(self, i: int, cause: BaseException,
                  deadline: float) -> None:
        """Re-route shard ``i`` to a serving replica: tear down its dead
        transport, cycle the replica set (waiting out a promotion), refuse
        a lower epoch (a zombie old primary must not win the race),
        revalidate the topology and rebuild the pumps. Raises the typed
        failure when nothing serves before ``deadline``."""
        import logging

        t0 = time.monotonic()
        logging.getLogger(__name__).warning(
            "%s %d (%s:%d) failed; trying its replica set (%d member(s))",
            self._failure_noun, i, *self._addrs[i],
            len(self._replica_sets[i]))
        for p in self._pumps.pop(i, []):
            p.close()
        try:
            self._chs[i].close()
        except Exception:  # noqa: BLE001 — the channel is dead either way
            pass

        def validate(extra):
            epoch = int(extra.get("epoch") or 0)
            if epoch < self._epochs[i]:
                return (f"stale shard epoch {epoch} < {self._epochs[i]} "
                        f"(zombie old primary?)")
            return self._validate_failover_hello(i, extra)

        # from the next member: the preferred address just failed
        ch, extra, addr = self._cycle_replica_set(
            i, deadline, skip_current=True, validate=validate, cause=cause)
        try:
            ch = self._maybe_upgrade(ch)
        except tv.VanError as e:
            # the member died during the lane's negotiation (a refusal
            # keeps TCP): a dead candidate, the caller's loop goes on
            ch.close()
            raise ServerFailureError(
                f"{self._failure_noun} {i} died during lane negotiation: "
                f"{e}", server=i) from e
        self._chs[i] = ch
        self._addrs[i] = addr
        self._epochs[i] = int(extra.get("epoch") or 0)
        if self.bucket_bytes is not None:
            self._open_pumps([i])
        dt = time.monotonic() - t0
        self.transport.record_failover(dt)
        obs.record_event("failover", shard=i, addr=f"{addr[0]}:{addr[1]}",
                         epoch=self._epochs[i], seconds=round(dt, 4),
                         cause=repr(cause))
        logging.getLogger(__name__).warning(
            "%s %d re-routed to %s:%d (epoch %d) in %.2fs",
            self._failure_noun, i, *addr, self._epochs[i], dt)

    def _on_table_moved(self, err: TableMovedError,
                        deadline: float) -> None:
        """Hook: fetch the shard table and re-route (a worker with a
        coordinator overrides it). A worker without one cannot recover:
        the topology it was started with is wrong now."""
        raise TableMovedError(
            f"{err} — this worker has no coordinator configured "
            f"(connect with coordinator=... / PS_COORD_URI for elastic "
            f"membership), so it cannot re-fetch the shard table",
            server=err.server, table_epoch=err.table_epoch) from err

    def _on_server_lost(self, err: ServerFailureError,
                        deadline: float) -> None:
        """Hook: a shard failed with no replica left to cycle to, the last
        chance before the op surfaces the failure. A worker with a
        coordinator re-discovers the fleet here (a replacement may have
        taken the dead shard's slot over); the default raises it."""
        raise err

    # -- the read path's rotation over a replica set ---------------------------

    def _init_read_rotation(self, read_staleness) -> None:
        """The staleness bound of replica reads (versions; env
        ``PS_READ_STALENESS``, 0: a replica serves only what is provably
        current), the rotation counters, one a shard (``next()`` on one is
        atomic under the GIL, so concurrent readers never lose a step),
        the members' failure cooldowns and the read channels, one a
        (shard, member)."""
        from ps_tpu_torch.config import env_int

        self.read_staleness = (env_int("PS_READ_STALENESS", 0, lo=0)
                               if read_staleness is None
                               else max(int(read_staleness), 0))
        # one counter a shard: a counter shared by the shards of a read
        # steps once a shard, so with as many shards as members each shard
        # would start every read at the same member
        self._read_rr: Dict[int, object] = {}
        self._read_bad: Dict[tuple, float] = {}
        self._read_chs: Dict[tuple, tv.Channel] = {}

    def _read_order(self, i: int):
        """``(members, primary)``: shard ``i``'s replica set in this read's
        rotating order, without the members in a failure cooldown (the
        primary is always tried: it is the last resort)."""
        members = self._replica_sets[i]
        primary = tuple(self._addrs[i])
        start = next(self._read_rr.setdefault(i, itertools.count()))
        now = time.monotonic()
        order = [tuple(members[(start + j) % len(members)])
                 for j in range(len(members))]
        return [a for a in order
                if a == primary or self._read_bad.get(a, 0.0) <= now], primary

    def _read_request(self, i: int, addr, payload):
        """One READ round trip to member ``addr`` of shard ``i`` on its
        read channel; the reply frame. A failed dial or request drops the
        channel, sits the member out of the rotation for 2 s and raises;
        an answer ends its cooldown."""
        try:
            ch = self._read_chs.get((i, addr))
            if ch is None:
                # a short budget: a dead replica costs this read
                # milliseconds, not the dial's boot patience
                ch = tv.Channel.connect(addr[0], addr[1], timeout_ms=2000,
                                        retries=2, max_wait_s=0.5)
                ch.stats = self.transport
                self._read_chs[(i, addr)] = ch
            reply = ch.request(payload)
        except (tv.VanError, OSError):
            ch = self._read_chs.pop((i, addr), None)
            if ch is not None:
                ch.close()
            self._read_bad[addr] = time.monotonic() + 2.0
            raise
        self._read_bad.pop(addr, None)
        return reply

    def _read_known(self, i: int) -> int:
        """Subclass hook: the newest version this worker has seen of shard
        ``i``, what a replica's served version is judged against."""
        raise NotImplementedError

    def _read_rotate(self, i: int, payload, judge) -> tuple:
        """One READ of shard ``i`` over its replica set, members in
        rotating order. ``judge(reply, kind, extra)`` names the version the
        staleness bound judges a reply at, or None for a reply that serves
        nothing (its error goes on as the last). A non-primary more than
        ``read_staleness`` behind :meth:`_read_known` is refused (a
        fallback) and the rotation goes on; the primary always qualifies.
        Returns ``(kind, tensors, extra, version, replica)``."""
        order, primary = self._read_order(i)
        last: Optional[BaseException] = None
        for addr in order:
            try:
                reply = self._read_request(i, addr, payload)
            except (tv.VanError, OSError) as e:
                last = e
                continue
            kind, _, tensors, extra = tv.decode(reply)
            version = judge(reply, kind, extra)
            if version is None:
                last = RuntimeError(str(extra.get("error")))
                continue
            known = self._read_known(i)
            if addr != primary and known - version > self.read_staleness:
                self.transport.record_read_fallback()
                self.transport.record_read_gap(known - version)
                last = RuntimeError(
                    f"replica {addr} at version {version} exceeds the "
                    f"staleness bound ({known} known, "
                    f"{self.read_staleness} allowed)")
                continue
            self.transport.record_read_route(replica=addr != primary)
            return kind, tensors, extra, version, addr != primary
        raise ServerFailureError(
            f"read failed at every member of {self._failure_noun} {i}'s "
            f"replica set {self._replica_sets[i]}: {last}", server=i)

    def _close_read_channels(self) -> None:
        for ch in list(getattr(self, "_read_chs", {}).values()):
            ch.close()
        self._read_chs = {}

    def _with_failover(self, fn):
        """Run one transport operation; on a typed server failure, fail the
        shard over to a replica, or on a 'moved' refusal fetch the shard
        table and re-route, and retry the whole operation. Safe because
        operations are idempotent: pulls read, and every push carries its
        (nonce, seq) dedup token, so a shard that already applied it
        (directly, through its dead primary's replication stream, or
        through a moved key range's tokens) acks without applying again.
        The whole window, every re-route the retry trips over included,
        is bounded by ``failover_timeout``."""
        try:
            return fn()
        except (ServerFailureError, TableMovedError) as e:
            err = e
        deadline = time.monotonic() + self.failover_timeout
        while True:
            if isinstance(err, TableMovedError):
                # the shard is healthy, its assignment changed: fetch the
                # table and re-split, never cycle its replica set
                self._on_table_moved(err, deadline)
            else:
                i = getattr(err, "server", None)
                if i is None or len(self._replica_sets[i]) <= 1:
                    self._on_server_lost(err, deadline)
                else:
                    try:
                        self._failover(i, err, deadline)
                    except ServerFailureError as e:
                        # a candidate died mid-adoption: keep cycling within
                        # the same deadline; a deadline-expired failure
                        # raises
                        if time.monotonic() >= deadline:
                            raise
                        err = e
                        continue
            try:
                return fn()
            except (ServerFailureError, TableMovedError) as e:
                if time.monotonic() >= deadline:
                    raise
                err = e

    def _track_pending(self, pending) -> None:
        """Register a background handle for flush(); resolved ones (and
        failures already delivered through wait()) are pruned."""
        self._pending_cycles = [
            c for c in self._pending_cycles
            if not c.done() or (c._exc is not None
                                and not getattr(c, "_observed", False))
        ]
        self._pending_cycles.append(pending)

    def flush(self) -> None:
        """Barrier: wait until every background cycle has landed (pushes
        applied server-side and pulls merged), re-raising the first
        failure. After flush() the worker is where a serial caller would
        be."""
        cycles, self._pending_cycles = self._pending_cycles, []
        err = None
        for c in cycles:
            if getattr(c, "_observed", False):
                continue  # this failure was already delivered via wait()
            try:
                c.wait()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = err or e
        if err is not None:
            raise err

    def _saved_transport_state(self) -> tuple:
        """What must survive a reconnect: the wire counters, the transport
        stats, the push/pull epoch streams and the compressor (topk's
        residuals are unsent gradient mass)."""
        return (self.bytes_pushed, self.bytes_pulled, self.collective_bytes,
                self.transport, self._push_epoch, self._pull_epoch,
                self._compressor)

    def _restore_transport_state(self, saved: tuple) -> None:
        (self.bytes_pushed, self.bytes_pulled, self.collective_bytes,
         self.transport, self._push_epoch, self._pull_epoch,
         self._compressor) = saved
        if self._compressor is not None:
            self._compressor.stats = self.transport
        # the re-dial built its accounting against a new stats object
        self._recv_pool.stats = self.transport

        def repoint(ch):
            while ch is not None:
                if getattr(ch, "stats", None) is not None:
                    ch.stats = self.transport
                ch = getattr(ch, "_ch", None)  # an shm lane wraps its TCP

        for pumps in self._pumps.values():
            for p in pumps:
                repoint(p._ch)
        for ch in getattr(self, "_chs", []):
            repoint(ch)
