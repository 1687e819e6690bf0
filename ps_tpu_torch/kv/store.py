"""KVStore — the user-facing worker API over parameter keys.

Counterpart of ``ps_tpu/kv/store.py`` on whichever backend
:func:`ps_tpu_torch.init` selected:

- local backend: every call goes to an in-process ``LocalServer``
  (per-key push/pull, sync aggregation over logical workers, or async);
  ``make_step`` runs the explicit protocol, one gradient a worker on its
  slice of the global batch.
- cuda backend: ``make_step`` is the fused step (gradient, then the
  server's apply of the whole tree, in place, which is what the
  reference's donated XLA program bought it: tensors returned by
  ``params()`` or such a step are the server's own and change with the
  next step); per-key pushes stage until the whole tree is there; async
  mode is ``make_async_step`` over the DC-ASGD server.

``push``/``pull``/``push_all``/``pull_all``/``push_pull`` and the async
paths apply out of place: a tensor they returned keeps its values. Byte
counters for every push and pull feed the push/pull GB/s metric, and
``collective_bytes`` the server's analytic per-rank collective traffic.
``save`` and ``restore`` checkpoint the server state on any engine, each
rank writing its own slices (``ps_tpu_torch/checkpoint.py``), and
``restore(elastic=True)`` reads a checkpoint of another world size or,
in async mode, of another worker count.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ps_tpu_torch import checkpoint as ckpt
from ps_tpu_torch import obs
from ps_tpu_torch.api import current_context
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.optim import Optimizer, make_optimizer
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import SEQ_AXIS
from ps_tpu_torch.parallel.sharding import check_rules


def _nbytes(x) -> int:
    """Bytes of a tensor or numpy array (0 for anything else)."""
    return int(getattr(x, "nbytes", 0))


def to_device(batch: Any, device, non_blocking: bool = False) -> Any:
    """Place a host batch (an array or tensor, or a dict, tuple or list of
    them) on ``device`` with ``.to(device)``. With ``non_blocking`` on a
    CUDA device each host array is first copied into pinned memory, so the
    copy to the card does not block the host."""
    device = torch.device(device)
    if isinstance(batch, dict):
        return {k: to_device(v, device, non_blocking)
                for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device, non_blocking) for v in batch)
    t = torch.as_tensor(batch)
    if not (non_blocking and device.type == "cuda"):
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _batch_part(batch: Any, index: int, count: int, what: str) -> Any:
    """Part ``index`` of ``count`` equal parts (dim 0) of every array of a
    batch; an indivisible batch raises, naming ``what`` is counted."""

    def part(x):
        n = x.shape[0]
        if n % count:
            raise ValueError(f"global batch dim {n} not divisible by "
                             f"{what}={count}")
        m = n // count
        return x[index * m:(index + 1) * m]

    return _map_tree(part, batch)


def rank_slice(batch: Any, mesh) -> Any:
    """This rank's part of every array of a global host batch: what a rank
    passes to ``shard_batch`` when each rank draws the same global batch.
    Its equal slice of dim 0 by its 'data' index (every rank on the same
    data index gets the same rows) and, on a 'seq' axis, its equal slice
    of dim 1, the sequence, by its 'seq' index. The batch itself at one
    rank."""
    if mesh is None:
        return batch
    if mesh.size > 1:
        batch = _batch_part(batch, mesh.rank, mesh.size, "ranks")
    sp = mesh.axis_size(SEQ_AXIS)
    if sp > 1:
        def seq_part(x):
            if x.shape[1] % sp:
                raise ValueError(f"sequence dim {x.shape[1]} not divisible "
                                 f"by the '{SEQ_AXIS}' axis ({sp})")
            n = x.shape[1] // sp
            i = mesh.axis_index(SEQ_AXIS)
            return x[:, i * n:(i + 1) * n]

        batch = _map_tree(seq_part, batch)
    return batch


def global_mean(value: torch.Tensor, mesh) -> torch.Tensor:
    """The global value of a per-rank loss: summed over a 'seq' axis,
    whose ranks each hold a part of their sequences' mean (the loss of
    ``models/lm.py`` under sequence parallelism), then meaned over the
    'data' ranks (each a loss meaned over its slice of the batch): the
    global batch's mean where the slices are equal. Returned as it is
    without a process group."""
    if mesh.world is None:
        return value
    total = value.detach().clone()
    if mesh.axis_size(SEQ_AXIS) > 1:
        collectives.all_reduce(total, mesh, axis=SEQ_AXIS)
    collectives.all_reduce(total, mesh)
    return total / mesh.size if mesh.size > 1 else total


def _map_tree(fn, tree: Any) -> Any:
    """``fn`` over every leaf of a dict/tuple/list structure."""
    kv, treedef = keymod.flatten_with_keys(tree)
    return keymod.unflatten(treedef, {k: fn(v) for k, v in kv.items()},
                            list(kv))


def value_and_grad(loss_fn, params: Any, batch: Any, *extra,
                   has_aux: bool = False):
    """``(loss, grads, aux)`` of ``loss_fn(params, batch, *extra)`` at
    ``params`` (a structure of tensors), as ``jax.value_and_grad`` gives
    them: ``grads`` has the structure of ``params``, with zeros for a
    parameter the loss does not reach; ``aux`` is None without has_aux.
    Inside a traced step, the spans ``forward`` and ``backward``."""
    kv, treedef = keymod.flatten_with_keys(params)
    keys = list(kv)
    leaves = {k: v.detach().requires_grad_() for k, v in kv.items()}
    tr = obs.tracer()
    with tr.child("forward", "step"):
        out = loss_fn(keymod.unflatten(treedef, leaves, keys), batch, *extra)
    loss, aux = out if has_aux else (out, None)
    with tr.child("backward", "step"):
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    materialize_grads=True)
    return (loss.detach(), keymod.unflatten(treedef, dict(zip(keys, grads)),
                                            keys), aux)


class KVStore:
    """A named parameter store with PS push/pull semantics.

    Args:
      optimizer: 'sgd' | 'momentum' | 'adam' | 'lamb' or an
        :class:`~ps_tpu_torch.optim.Optimizer` — the server-side update rule.
      mode: 'sync' | 'async' | None (inherit from Config).
      aggregate: 'mean' (default) or 'sum'.
      placement: cuda backend only: 'replicated' or 'sharded' (ZeRO-1:
        each rank owns a slice of each parameter and its optimizer state;
        the same as 'replicated' at one rank).
      partition_rules: cuda backend only: ``[(key regex, spec)]``, a spec
        one mesh axis or None a dimension, first match wins
        (:mod:`~ps_tpu_torch.parallel.sharding`); the optimizer state
        follows its parameter's rule. A leaf a rule slices over 'model'
        or 'pipe' reaches ``make_step``'s loss function as this rank's
        slice, so the loss function is written for that placement (the
        Megatron forwards of ``models/bert.py`` and ``models/lm.py``, the
        GPipe trunk of ``parallel/pipeline.py``).
      **opt_kwargs: forwarded to the named optimizer (e.g. learning_rate).
    """

    def __init__(self, optimizer: Union[str, Optimizer] = "sgd",
                 mode: Optional[str] = None, aggregate: str = "mean",
                 placement: str = "replicated", partition_rules=None,
                 **opt_kwargs):
        ctx = current_context()
        self._ctx = ctx
        self._opt = make_optimizer(optimizer, **opt_kwargs)
        if placement not in ("replicated", "sharded"):
            raise ValueError("placement must be 'replicated' or 'sharded'")
        self.placement = placement
        partition_rules = check_rules(partition_rules)
        if ctx.config.backend == "local":
            if partition_rules:
                raise ValueError(
                    "partition_rules need the device backend (backend='cuda')")
            self._engine = ctx.backend.create_server(
                self._opt, mode=mode, aggregate=aggregate)
        else:
            self._engine = ctx.backend.create_server(
                self._opt, mode=mode, aggregate=aggregate,
                placement=placement, partition_rules=partition_rules)
        self._treedef = None
        self._key_order: List[str] = []
        self._async_params: Dict[int, Any] = {}
        self.bytes_pushed = 0
        self.bytes_pulled = 0
        self.step = 0

    # -- registration -------------------------------------------------------

    def init(self, params: Any) -> Any:
        """Register a nested dict of tensors (or arrays) with the server;
        returns the params as the server placed them."""
        if self._treedef is not None:
            raise RuntimeError("KVStore.init already called")
        kv, treedef = keymod.flatten_with_keys(params)
        self._treedef = treedef
        self._key_order = list(kv)
        if hasattr(self._engine, "register_tree"):
            return self._engine.register_tree(kv, treedef, self._key_order)
        for k, v in kv.items():
            self._engine.register(k, v)
        return self.params()

    def keys(self) -> List[str]:
        return list(self._key_order)

    # -- per-key protocol ---------------------------------------------------

    def push(self, key: str, grad: Any, worker: int = 0) -> None:
        """Send one key's gradient to the server (it stages or applies,
        by mode and backend)."""
        self.bytes_pushed += _nbytes(grad)
        self._engine.push(key, grad, worker=worker)

    def pull(self, key: str, worker: int = 0) -> torch.Tensor:
        """Fetch the current (post-apply) value of one key."""
        val = self._engine.pull(key, worker=worker)
        self.bytes_pulled += _nbytes(val)
        return val

    # -- whole-tree protocol ------------------------------------------------

    def _require_init(self) -> None:
        if self._treedef is None:
            raise RuntimeError("KVStore.init(params) must be called first")

    def push_all(self, grads: Any, worker: int = 0) -> None:
        """Push every key of a gradient tree (its structure must match
        init's): one ``push_tree`` where the engine has it, else the
        per-key protocol in key order."""
        self._require_init()
        kv, _ = keymod.flatten_with_keys(grads)
        if set(kv) != set(self._key_order):
            raise ValueError(
                "gradient tree structure does not match registered params")
        push_tree = getattr(self._engine, "push_tree", None)
        if push_tree is not None:
            self.bytes_pushed += sum(_nbytes(v) for v in kv.values())
            push_tree(kv, worker=worker)
            return
        for k in self._key_order:
            self.push(k, kv[k], worker=worker)

    def pull_all(self, worker: int = 0) -> Any:
        """Pull every key and rebuild the parameter tree (one atomic
        snapshot on engines with ``pull_tree``)."""
        self._require_init()
        pull_tree = getattr(self._engine, "pull_tree", None)
        if pull_tree is not None:
            kv = pull_tree(worker=worker)
            self.bytes_pulled += sum(_nbytes(v) for v in kv.values())
        else:
            kv = {k: self.pull(k, worker=worker) for k in self._key_order}
        return keymod.unflatten(self._treedef, kv, self._key_order)

    def push_pull(self, grads: Any, worker: int = 0) -> Any:
        """Fused push + apply + pull for a whole gradient tree: one
        ``update_tree`` on the cuda backend's sync server, else
        ``push_all`` then ``pull_all``. With several logical workers the
        sync barrier fires on the last worker's push, so earlier workers
        call ``push_all`` and ``pull_all`` follows the last push."""
        self._require_init()
        if hasattr(self._engine, "update_tree"):
            kv, _ = keymod.flatten_with_keys(grads)
            if set(kv) != set(self._key_order):
                raise ValueError(
                    "gradient tree structure does not match registered params")
            nbytes = sum(_nbytes(v) for v in kv.values())
            self.bytes_pushed += nbytes
            self.bytes_pulled += nbytes
            out = self._engine.update_tree(kv)
            self.step += 1
            return keymod.unflatten(self._treedef, out, self._key_order)
        self.push_all(grads, worker=worker)
        self.step += 1
        return self.pull_all(worker=worker)

    # -- train steps --------------------------------------------------------

    def make_step(self, loss_fn, has_aux: bool = False):
        """Build ``run(batch, *extra) -> (loss, params)`` (or ``(loss,
        params, aux)``). ``loss_fn(params, batch, *extra)`` returns a scalar
        loss meaned over the batch it is given (or ``(loss, aux)`` with
        has_aux).

        On the cuda backend: the gradient, then the server apply, in place.
        Across ranks each rank passes its local slice of the global batch
        (equal slices, as the reference's multi-process ``shard_batch``
        takes them); the server applies the mean gradient over the ranks,
        and the loss returned is the mean over the ranks, the global
        batch's. ``aux`` is this rank's as the loss function returned it
        (cross-rank BatchNorm statistics are already global). On a mesh
        with 'model', 'seq' or 'pipe' axes the loss function receives
        ``engine.tree()`` (a rule's 'model'/'pipe' leaves as this rank's
        slices, the rest whole) and runs the parallel forward; a 'seq'
        rank's loss is its part of the mean (the parts sum to it), so the
        gradients are summed over 'seq' and meaned over 'data'. The params
        returned are that tree, every leaf holding its value after the
        step (the step updates the tree's tensors in place);
        ``params()`` gives whole tensors.
        On the local backend: the explicit protocol. With ``num_workers >
        1`` the batch is the global batch, split into equal slices (an
        indivisible batch raises); each logical worker takes the gradient
        of its slice and pushes, the server aggregates on the last push,
        and the loss (and aux) are means over the workers. A parameter the
        loss does not reach gets a zero gradient, and the optimizer still
        steps it.

        On the cuda backend each call is a root span ``step`` of the
        process tracer (:mod:`~ps_tpu_torch.obs`, sampled by
        ``trace_sample``), timed on the card too, whose context the
        backward's spans on autograd's thread parent to."""
        self._require_init()
        engine = self._engine
        if getattr(engine, "mode", "sync") == "async":
            raise RuntimeError(
                "make_step is the sync fused path; in async mode use "
                "make_async_step (or push_all/pull_all directly)")
        if not hasattr(engine, "step_"):
            return self._make_local_step(loss_fn, has_aux)
        treedef, key_order = self._treedef, self._key_order

        def run(batch, *extra):
            with obs.tracer().span("step", "step", hold=True) as span:
                span.time_device(engine.device)
                return fused(batch, *extra)

        def fused(batch, *extra):
            params_kv = engine.tree()
            loss, grads, aux = value_and_grad(
                loss_fn, keymod.unflatten(treedef, params_kv, key_order),
                batch, *extra, has_aux=has_aux)
            gkv, _ = keymod.flatten_with_keys(grads)
            with torch.no_grad():
                engine.step_(gkv)
                loss = global_mean(loss, engine.mesh)
            nbytes = sum(_nbytes(v) for v in params_kv.values())
            self.bytes_pushed += nbytes
            self.bytes_pulled += nbytes
            self.step += 1
            params = keymod.unflatten(treedef, params_kv, key_order)
            if has_aux:
                return loss, params, aux
            return loss, params

        return run

    def _make_local_step(self, loss_fn, has_aux: bool):
        nw = self._engine.num_workers

        def run_local(batch, *extra):
            params = self.params()
            if nw == 1:
                loss, grads, aux = value_and_grad(loss_fn, params, batch,
                                                  *extra, has_aux=has_aux)
                new_params = self.push_pull(grads)
                return (loss, new_params, aux) if has_aux else (loss,
                                                                new_params)
            losses, auxes = [], []
            for w in range(nw):
                shard = _batch_part(batch, w, nw, "num_workers")
                loss, grads, aux = value_and_grad(loss_fn, params, shard,
                                                  *extra, has_aux=has_aux)
                losses.append(loss)
                auxes.append(aux)
                self.push_all(grads, worker=w)
            self.step += 1
            new_params = self.pull_all()
            loss = sum(losses) / nw
            if not has_aux:
                return loss, new_params
            flat = [keymod.flatten_with_keys(a) for a in auxes]
            treedef, keys = flat[0][1], list(flat[0][0])
            aux = keymod.unflatten(
                treedef, {k: sum(f[k] for f, _ in flat) / nw for k in keys},
                keys)
            return loss, new_params, aux

        return run_local

    def make_async_step(self, loss_fn, has_aux: bool = False):
        """Build the async worker cycle ``run(batch, *extra, worker=w)``:
        the gradient against the parameters this worker last pulled (stale
        by however many versions others pushed since), pushed (the server
        applies it at once with the DC-ASGD correction), then a pull of
        the current version for the worker's next cycle. Returns the loss
        (and aux with has_aux). Drive workers round-robin or, in one
        process, from host threads; ``staleness(w)`` reports each worker's
        τ. Across ranks every rank runs the same cycles in the same order,
        each on its slice of the logical worker's global batch (as
        ``make_step`` takes it): the server applies the mean gradient over
        the ranks, and the loss returned is the mean over the ranks, the
        global batch's."""
        self._require_init()
        if getattr(self._engine, "mode", "sync") != "async":
            raise RuntimeError(
                "make_async_step requires mode='async' "
                "(ps_tpu_torch.init(..., mode='async') or "
                "KVStore(mode='async'))")

        def run(batch, *extra, worker: int = 0):
            params = self._async_params.get(worker)
            if params is None:
                params = self.pull_all(worker=worker)
            loss, grads, aux = value_and_grad(loss_fn, params, batch, *extra,
                                              has_aux=has_aux)
            self.push_all(grads, worker=worker)
            self._async_params[worker] = self.pull_all(worker=worker)
            if self.mesh is not None:
                loss = global_mean(loss, self.mesh)
            self.step += 1
            return (loss, aux) if has_aux else loss

        return run

    def staleness(self, worker: int = 0) -> int:
        """Async mode: whole-model versions behind the server this worker's
        cached parameters are (0 in sync mode)."""
        fn = getattr(self._engine, "staleness", None)
        return fn(worker) if fn else 0

    @property
    def staleness_histogram(self) -> Dict[int, int]:
        """Async mode: ``{τ: count}`` of whole-tree pushes by the staleness
        they were applied at (empty in sync mode)."""
        hist = getattr(self._engine, "staleness_hist", None)
        return dict(hist) if hist else {}

    def shard_batch(self, batch: Any) -> Any:
        """Place a host batch (a dict, tuple or list of arrays or tensors,
        e.g. ``(images, labels)``) on this rank's device
        (:func:`to_device`). One process: the global batch. Across ranks:
        this rank's part of the global batch (:func:`rank_slice`: the
        same rows on every rank of a 'data' index, its part of the
        sequence on a 'seq' axis), as the reference's multi-process
        ``shard_batch`` takes it."""
        return to_device(batch, self._ctx.device)

    # -- checkpoint/resume --------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the full server state to ``path``: params, optimizer
        state and, in async mode, every worker's stale snapshot and cached
        pull and the version vector. Restore with :meth:`restore` after an
        identical ``init``. The engine's lock is held while the state is
        copied off the device, so host threads driving workers may run
        around it."""
        self._require_init()
        engine = self._engine
        with engine.checkpoint_lock():
            arrays, meta = engine.state_dict()
            # async workers' cached pulls, saved exactly (not inferred): a
            # worker that pulled manually without caching resumes
            # cache-less too. A cached leaf that is the very tensor recorded
            # as that worker's stale snapshot (pull_all does both) is saved
            # once, as a reference into the stale group.
            stale = getattr(engine, "_stale", {})
            cache, aliased = {}, []
            for w, params in self._async_params.items():
                kv, _ = keymod.flatten_with_keys(params)
                for k, v in kv.items():
                    s = ckpt.encode_stale_key(w, k)
                    if stale.get((w, k)) is v:
                        aliased.append(s)
                    else:
                        cache[s] = v
            mesh = getattr(engine, "mesh", None)
            # across ranks the cached pulls are whole and the same on every
            # rank: rank 0 writes them
            arrays["worker_cache"] = ({} if mesh is not None and mesh.rank
                                      else cache)
            arrays = {g: {n: ckpt.to_cpu(t) for n, t in group.items()}
                      for g, group in arrays.items()}
        meta["store"] = {
            "step": self.step,
            "bytes_pushed": self.bytes_pushed,
            "bytes_pulled": self.bytes_pulled,
            "key_order": self._key_order,
            "cache_keys": sorted(cache),
            "cache_stale_aliases": sorted(aliased),
        }
        ckpt.save(path, arrays, meta, mesh=getattr(engine, "mesh", None))

    def restore(self, path: str, elastic: bool = False) -> Any:
        """Restore a checkpoint written by :meth:`save` into this store.

        Call after ``init(params)`` with the same parameter structure and
        optimizer. Every check runs first, so a refused restore changes
        nothing; then every tensor is replaced by its saved value on the
        store's device (contiguous, in the saved dtype), and training
        resumes bit-identically. The engine object stays the same, so
        steps built by ``make_step``, ``make_async_step`` or
        ``make_composite_step`` before the restore keep working. A
        restored worker's cached pull is the very tensor restored as its
        stale snapshot, as it was when saved. Across ranks every rank
        calls it and takes its own slices. A checkpoint written by another
        number of ranks is refused unless ``elastic=True``, which reads
        each leaf whole and keeps the slice this rank owns under the live
        layout (the values are the saved ones, bitwise). An async
        checkpoint of another ``num_workers`` is refused unless
        ``elastic=True`` too, which keeps the surviving workers' versions,
        stale snapshots and cached pulls, drops the removed workers'
        (their bytes are never read) and lets new workers join fresh
        (their first pull sets their version). Returns the restored
        parameter tree."""
        self._require_init()
        meta = ckpt.read_meta(path)
        saved_order = meta["store"]["key_order"]
        if saved_order != self._key_order:
            diff = sorted(set(saved_order) ^ set(self._key_order))[:4]
            raise ValueError(
                f"checkpoint parameter keys do not match this store: saved "
                f"{len(saved_order)} keys, registered {len(self._key_order)}"
                + (f"; differing keys include {diff}" if diff
                   else "; same keys in a different order"))
        arrays = ckpt.restore(path, meta)
        cache = arrays.pop("worker_cache", {})
        st = meta["store"]
        aliases = st.get("cache_stale_aliases", [])
        if (sorted(cache) != sorted(st["cache_keys"])
                or not set(aliases) <= set(meta.get("stale_keys", []))):
            raise ValueError("checkpoint cached pulls do not match its meta")
        engine = self._engine
        nw = getattr(engine, "num_workers", None)
        by_worker: Dict[int, Dict[str, Any]] = {}
        for s, v in cache.items():
            w, k = ckpt.decode_stale_key(s)
            if k not in engine._params:
                raise ValueError(f"cached pull {s!r} of an unregistered key")
            ckpt.check_like(f"cached pull {s!r}", v, engine._params[k])
            # an elastic shrink never reads a dropped worker's bytes
            if ckpt.keep_worker(w, nw, elastic):
                by_worker.setdefault(w, {})[k] = v
        with engine.checkpoint_lock():
            engine.load_state_dict(arrays, meta, elastic=elastic)
            by_worker = {w: {k: ckpt.place(v, engine.device)
                             for k, v in kv.items()}
                         for w, kv in by_worker.items()}
            stale = getattr(engine, "_stale", {})
            for s in aliases:
                w, k = ckpt.decode_stale_key(s)
                if ckpt.keep_worker(w, nw, elastic):
                    by_worker.setdefault(w, {})[k] = stale[(w, k)]
            self._async_params = {
                w: keymod.unflatten(self._treedef, kv, self._key_order)
                for w, kv in by_worker.items()}
        self.step = int(st["step"])
        self.bytes_pushed = int(st["bytes_pushed"])
        self.bytes_pulled = int(st["bytes_pulled"])
        return self.params()

    # -- introspection ------------------------------------------------------

    def params(self) -> Any:
        """Current server-side parameter tree — introspection only: no byte
        accounting and no protocol side effects (an async worker's snapshot
        is recorded by ``pull``/``pull_all``, never by this)."""
        self._require_init()
        read = getattr(self._engine, "peek", None) or self._engine.pull
        kv = {k: read(k) for k in self._key_order}
        return keymod.unflatten(self._treedef, kv, self._key_order)

    def optimizer_state(self, key: str):
        return self._engine.optimizer_state(key)

    @property
    def mesh(self):
        """The ranks this store's step reduces over (None on the local
        backend): what a loss with cross-rank statistics needs."""
        return getattr(self._engine, "mesh", None)

    @property
    def collective_bytes(self) -> int:
        """Bytes the server's collectives have moved per rank: the
        reference's analytic ring traffic (0 at one rank and on the local
        server, which runs none)."""
        return getattr(self._engine, "collective_bytes", 0)

    @property
    def num_workers(self) -> int:
        return self._engine.num_workers
