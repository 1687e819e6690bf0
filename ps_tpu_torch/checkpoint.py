"""Checkpoint/resume for every engine of the port, in torch-native files.

Counterpart of ``ps_tpu/checkpoint.py``. A checkpoint holds
the server-side state, so a resumed run continues as if never
interrupted:

- **sync** (``local`` and ``cuda_sync``): the parameters and the
  optimizer state (one state a key on the local server, one whole-tree
  state on the cuda server), schedule counts included;
- **async** (``local`` in mode 'async' and ``cuda_async``): also every
  worker's stale snapshot and cached pull and the version vector, so the
  resumed run sees the staleness each worker would have seen;
- **sparse tables**: the table and its per-row optimizer state
  (``SparseEmbedding.save``/``restore``).

Layout under ``<path>/``: ``arrays-<gen:08d>/arrays.pt``, one
``torch.save`` of a flat ``{name: CPU tensor}`` dict (``params/<key>``,
``opt/<i:05d>``, ``stale/<w>::<key>``, ``worker_cache/<w>::<key>``, or
``table`` and ``opt/<i>`` for a sparse table), read back with
``torch.load(..., weights_only=True)``; bf16 round-trips, which numpy
cannot hold. Beside it a JSON sidecar ``meta.json`` names the arrays
directory. The meta write is the commit point: the arrays land, flushed
to disk, in a fresh generation-numbered directory; then ``meta.json.tmp``
is written, flushed and atomically renamed to ``meta.json``, and the
directory is flushed. A crash anywhere mid-save leaves the previous
checkpoint intact (old meta, old arrays). After the commit every arrays
directory but the new one and the one before it is deleted: a restore
that read the old meta just before the commit can still finish.
Single-writer: at most one job saves into a given path at a time.

Optimizer state is stored as a flat leaf list (:func:`flatten_leaves`);
its structure lives in the live engine, and ``meta["opt_structure"]``
fingerprints it (:func:`opt_fingerprint`) so a restore into another
optimizer is refused even where the leaf shapes agree.

Restore contract: call after registration (``KVStore.init(params)`` /
``SparseEmbedding.init(...)``) with the same keys, shapes and optimizer.
Every check runs before anything is changed, so a refused restore leaves
the engine as it was; the restored tensors then replace the engine's, on
its device, contiguous, in the saved dtype. Resume is bit-identical
(``tests/test_torch_checkpoint.py``; on the card, ``chip_smoke.py``).

A port checkpoint is not an orbax checkpoint. :func:`from_reference`
converts one of ``ps_tpu``'s, read on the JAX side into numpy, into a
port checkpoint; nothing converts the other way.

Across the k ranks of a process group (the reference's multi-process
jobs) every rank writes its own slices, ``arrays.<rank>.pt``, into the
same ``arrays-<gen>/``: of each sharded leaf (ZeRO-1 parameters and
their optimizer state, a sparse table's rows) the slice it owns, and the
whole leaves on rank 0 only. A barrier precedes the commit; rank 0 alone
writes ``meta.json`` (which records ``world_size`` and each sharded
array's dimension, ``shard_dims``), flushes the directory and collects
the garbage; a second barrier follows. A restore joins the slices and
places each rank's own; across a change of world size it is refused
unless ``restore(elastic=True)``, which re-slices the whole tensors for
the new layout (and re-pads a sparse table's rows). The reference's
orbax reshards a sync checkpoint on any restore; the port asks for the
flag.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_META_FILE = "meta.json"
_ARRAYS_PREFIX = "arrays-"
_ARRAYS_FILE = "arrays.pt"


# -- one checkpoint's files ----------------------------------------------------


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _last_commit(path: str):
    """(generation, arrays_dir) of the committed checkpoint, or (-1, None)."""
    try:
        meta = read_meta(path)
        return int(meta.get("generation", -1)), meta.get("arrays_dir")
    except (FileNotFoundError, json.JSONDecodeError, ValueError, KeyError):
        return -1, None


def _flatten_groups(arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{group: {name: t}}`` or ``{name: t}`` -> ``{"group/name": t}``.
    Group names hold no '/', so the first '/' splits them off again."""
    flat = {}
    for group, value in arrays.items():
        if "/" in group:
            raise ValueError(f"checkpoint group name {group!r} holds '/'")
        if isinstance(value, dict):
            for name, t in value.items():
                flat[f"{group}/{name}"] = t
        else:
            flat[group] = value
    for name, t in flat.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
            raise TypeError(f"checkpoint array {name!r} is not a CPU tensor")
    return flat


def _unflatten_groups(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        group, sep, rest = name.partition("/")
        if sep:
            out.setdefault(group, {})[rest] = t
        else:
            out[name] = t
    return out


def _rank_file(rank: int, world: int) -> str:
    return _ARRAYS_FILE if world == 1 else f"arrays.{rank:05d}.pt"


def _write(file: str, flat: Dict[str, torch.Tensor]) -> None:
    with open(file, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())


def _commit(path: str, arrays_dir: str, gen: int, prev_dir, meta) -> None:
    """Write ``meta.json`` (the commit point) and delete every arrays
    directory but the new one and the one before it."""
    meta = dict(meta)
    meta["arrays_dir"] = arrays_dir
    meta["generation"] = gen
    tmp = os.path.join(path, _META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, _META_FILE))  # commit point
    # make the rename durable before deleting superseded arrays: without
    # this a power loss could keep the deletion but not the new meta
    _fsync_dir(path)
    keep = {arrays_dir, prev_dir}
    for d in os.listdir(path):
        if d.startswith(_ARRAYS_PREFIX) and d not in keep:
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def save(path: str, arrays: Dict[str, Any], meta: Dict[str, Any],
         mesh=None) -> None:
    """Write one checkpoint: ``arrays`` (groups of CPU tensors, or CPU
    tensors) in one ``torch.save`` file, plus the JSON ``meta``. Crash-safe
    as the module docstring says.

    Across the k > 1 ranks of ``mesh`` every rank calls this with the same
    ``path``, its own slices in ``arrays`` and the same ``meta`` (whose
    ``shard_dims`` names every sliced array and its dimension): each rank
    writes ``arrays.<rank>.pt`` into the same ``arrays-<gen>/`` (the
    generation comes from the committed meta, the same everywhere); a
    barrier; rank 0 alone commits ``meta.json`` and collects the garbage;
    a barrier, so the commit is visible to every rank when ``save``
    returns."""
    path = os.path.abspath(path)
    world = 1 if mesh is None else mesh.size
    meta = dict(meta)
    meta["world_size"] = world
    flat = _flatten_groups(arrays)
    os.makedirs(path, exist_ok=True)
    gen, prev_dir = _last_commit(path)
    gen += 1
    arrays_dir = f"{_ARRAYS_PREFIX}{gen:08d}"
    full = os.path.join(path, arrays_dir)
    if world == 1:
        # clears a partial directory left by a crashed attempt at this
        # generation
        shutil.rmtree(full, ignore_errors=True)
        os.makedirs(full)
        _write(os.path.join(full, _ARRAYS_FILE), flat)
        _fsync_dir(full)
        _commit(path, arrays_dir, gen, prev_dir, meta)
        return
    import torch.distributed as dist

    rank = mesh.rank
    if rank == 0:
        shutil.rmtree(full, ignore_errors=True)
        os.makedirs(full)
    dist.barrier(group=mesh.group)
    _write(os.path.join(full, _rank_file(rank, world)), flat)
    dist.barrier(group=mesh.group)  # every rank's arrays are on disk
    if rank == 0:
        _fsync_dir(full)
        _commit(path, arrays_dir, gen, prev_dir, meta)
    dist.barrier(group=mesh.group)


def read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(os.path.abspath(path), _META_FILE)) as f:
        return json.load(f)


def restore(path: str, meta: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """The committed checkpoint's arrays as groups of whole CPU tensors,
    memory mapped from the file (copy them to where they belong). A
    checkpoint written by k > 1 ranks is read from every rank's file:
    each array named in ``meta['shard_dims']`` is its ranks' slices
    joined in rank order along its dimension, every other array rank
    0's."""
    if meta is None:
        meta = read_meta(path)
    folder = os.path.join(os.path.abspath(path), meta["arrays_dir"])
    world = int(meta.get("world_size", 1))

    def load(rank):
        return torch.load(os.path.join(folder, _rank_file(rank, world)),
                          map_location="cpu", weights_only=True, mmap=True)

    flat = load(0)
    if world > 1:
        dims = meta.get("shard_dims", {})
        parts = [flat] + [load(r) for r in range(1, world)]
        for name, d in dims.items():
            flat[name] = torch.cat([p[name] for p in parts], dim=d)
    return _unflatten_groups(flat)


def nbytes(path: str, meta: Optional[Dict[str, Any]] = None) -> int:
    """Size on disk of the committed checkpoint's arrays (every rank's
    file)."""
    if meta is None:
        meta = read_meta(path)
    folder = os.path.join(os.path.abspath(path), meta["arrays_dir"])
    world = int(meta.get("world_size", 1))
    return sum(os.path.getsize(os.path.join(folder, _rank_file(r, world)))
               for r in range(world))


def to_cpu(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy that later in-place updates of ``t`` do not
    reach (a slice's copy holds the slice alone)."""
    return t.detach().to("cpu", copy=True,
                         memory_format=torch.contiguous_format)


def place(t: torch.Tensor, device) -> torch.Tensor:
    """A fresh contiguous copy of a restored tensor on ``device``, in its
    own dtype: what the engines and the sparse kernel take."""
    return t.to(device=device, copy=True, memory_format=torch.contiguous_format)


# -- flat-leaf helpers ---------------------------------------------------------


def _leaf_paths(tree, path=()):
    """``(path, leaf)`` in the one storage order: dict keys sorted (as
    ``jax.tree_util`` orders a dict), tuples and lists in order, None an
    empty node, anything else a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def flatten_leaves(tree: Any) -> Dict[str, Any]:
    """State tree -> ``{"00000": leaf, ...}`` in :func:`_leaf_paths`
    order (the storage form; the structure lives in the engine)."""
    return {f"{i:05d}": leaf for i, (_, leaf) in enumerate(_leaf_paths(tree))}


def unflatten_like(live: Any, flat: Dict[str, Any]) -> Any:
    """Rebuild ``live``'s structure, dict order included, with the leaves
    of ``flat`` in :func:`flatten_leaves` order."""
    n = sum(1 for _ in _leaf_paths(live))
    if len(flat) != n:
        raise ValueError(f"checkpoint holds {len(flat)} optimizer-state "
                         f"leaves, this optimizer has {n}")
    leaves = iter(flat[f"{i:05d}"] for i in range(n))

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(leaves)

    return build(live)


def _structure(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in node) + ")"
    return "None" if node is None else "*"


def opt_fingerprint(name: str, state: Any) -> str:
    """The optimizer's name (``Optimizer.name`` or ``RowwiseOptimizer.kind``)
    and the nested key structure of its state. The name tells apart
    optimizers whose states have the same leaves (adam and lamb)."""
    return f"{name} {_structure(state)}"


def check_like(what: str, got: torch.Tensor, live: torch.Tensor) -> None:
    """Refuse a restored tensor whose shape or dtype differs from the live
    one it replaces."""
    if tuple(got.shape) != tuple(live.shape) or got.dtype != live.dtype:
        raise ValueError(
            f"checkpoint {what} is {tuple(got.shape)} {got.dtype}, this "
            f"store's is {tuple(live.shape)} {live.dtype} — restore would "
            f"change its shape or silently cast")


# -- stale-snapshot key encoding (async worker snapshots) ----------------------


def encode_stale_key(worker: int, key: str) -> str:
    return f"{worker}::{key}"


def decode_stale_key(s: str):
    w, key = s.split("::", 1)
    return int(w), key


def keep_worker(worker: int, num_workers, elastic: bool) -> bool:
    """The elastic remap policy of async workers, in one place: an elastic
    shrink drops all per-worker state (stale snapshots, cached pulls,
    version-vector entries) of workers >= the new worker count;
    everything else survives. The async server runs in one process, so
    its restores are not elastic yet."""
    return not (elastic and num_workers is not None and worker >= num_workers)


# -- shared engine checkpoint surface ------------------------------------------


class CheckpointMixin:
    """``state_dict``/``load_state_dict`` shared by the server engines:
    params, flat optimizer state and async stale snapshots, with engine
    hooks for the mode's counters. ``engine_name`` tags the checkpoint so
    a restore into the wrong mode or backend fails with a clear error.

    Engine contract: ``self._params``, ``self._state``, ``self._opt`` and
    ``self.device``; ``self._stale`` and ``self._staged_async`` where the
    engine runs async; ``self._lock`` where threads share it.
    """

    engine_name = "engine"

    # -- engine hooks ----------------------------------------------------------

    def _check_checkpointable(self) -> None:
        """Raise if mid-step state would be lost (pending/staged pushes)."""

    def _checkpoint_meta(self) -> Dict[str, Any]:
        """Engine-specific JSON-able counters (versions, apply counts)."""
        return {}

    def _validate_checkpoint_meta(self, meta: Dict[str, Any]) -> None:
        """Refuse a checkpoint whose semantics differ. Runs before any
        engine state is changed, so a refused restore leaves the engine as
        it was."""

    def _load_checkpoint_meta(self, meta: Dict[str, Any]) -> None:
        """Adopt the counters written by :meth:`_checkpoint_meta` (the meta
        already passed :meth:`_validate_checkpoint_meta`)."""

    # -- shared implementation ---------------------------------------------------

    def checkpoint_lock(self):
        """The engine's lock (applies and pulls serialize on it), or a
        no-op where the engine has none. Hold it across ``state_dict`` and
        the copies off the device, and across ``load_state_dict``."""
        lock = getattr(self, "_lock", None)
        return lock if lock is not None else contextlib.nullcontext()

    def _opt_structure(self) -> str:
        return opt_fingerprint(self._opt.name, self._state)

    def state_dict(self):
        """``(arrays, meta)``: the engine's own tensors (not copies, so a
        caller can compare identities; copy them off the device before
        releasing :meth:`checkpoint_lock`)."""
        self._check_checkpointable()
        stale = getattr(self, "_stale", None) or {}
        arrays = {
            "params": dict(self._params),
            "opt": flatten_leaves(self._state),
            "stale": {encode_stale_key(w, k): v
                      for (w, k), v in stale.items()},
        }
        meta = {
            "engine": self.engine_name,
            "stale_keys": sorted(arrays["stale"]),
            "opt_structure": self._opt_structure(),
        }
        meta.update(self._checkpoint_meta())
        mesh = getattr(self, "mesh", None)
        if mesh is not None and mesh.size > 1:
            self._keep_own_slices(arrays, meta, mesh)
        return arrays, meta

    def _keep_own_slices(self, arrays, meta, mesh) -> None:
        """Across ranks: keep in ``arrays`` the slices this rank owns of
        each sharded leaf, and the whole leaves on rank 0 only; name each
        sharded array and its dimension in ``meta['shard_dims']``."""
        from ps_tpu_torch.parallel.sharding import shard

        r, k = mesh.rank, mesh.size
        dims = {f"params/{key}": d for key, d in self._dims.items()}
        dims.update({f"opt/{i}": d for i, d in zip(arrays["opt"],
                                                   self._state_dims)})
        for group in ("params", "opt"):
            kept = {}
            for name, t in arrays[group].items():
                d = dims[f"{group}/{name}"]
                if d is not None:
                    # opt leaves are this rank's slices already
                    kept[name] = shard(t, d, r, k) if group == "params" else t
                elif r == 0:
                    kept[name] = t
            arrays[group] = kept
        meta["shard_dims"] = {n: d for n, d in dims.items() if d is not None}
        meta["placement"] = self.placement

    def load_state_dict(self, arrays, meta, elastic: bool = False) -> None:
        """Check ``arrays`` (whole CPU tensors, as :func:`restore` reads
        them) and ``meta`` against the live engine, then place this rank's
        slices of them on its device and adopt them. A checkpoint written
        by another number of ranks is refused unless ``elastic``, which
        reads it into this engine's layout."""
        if meta.get("engine") != self.engine_name:
            raise ValueError(
                f"checkpoint was written by engine {meta.get('engine')!r} but "
                f"this store runs {self.engine_name!r} — backend/mode mismatch")
        mesh = getattr(self, "mesh", None)
        world = mesh.size if mesh is not None else 1
        saved_world = int(meta.get("world_size", 1))
        if saved_world != world and not elastic:
            raise ValueError(
                f"checkpoint was written by {saved_world} rank(s) and this "
                f"job runs {world}; restore(elastic=True) reads it into "
                f"this job's layout")
        state_dims = getattr(self, "_state_dims", None) or [None] * len(
            flatten_leaves(self._state))
        r = mesh.rank if mesh is not None else 0
        params = arrays.get("params", {})
        if set(params) != set(self._params):
            raise ValueError("checkpoint keys do not match registered keys")
        live_structure = self._opt_structure()
        if meta.get("opt_structure", live_structure) != live_structure:
            raise ValueError(
                "checkpoint optimizer state does not match this store's "
                "optimizer — restore with the optimizer the checkpoint was "
                f"saved with (saved {meta['opt_structure']!r}, "
                f"live {live_structure!r})")
        for k, live in self._params.items():
            check_like(f"param {k!r}", params[k], live)
        live_opt = flatten_leaves(self._state)
        opt = arrays.get("opt", {})
        if set(opt) != set(live_opt):
            raise ValueError(f"checkpoint holds {len(opt)} optimizer-state "
                             f"leaves, this optimizer has {len(live_opt)}")
        for (i, live), d in zip(live_opt.items(), state_dims):
            whole = list(live.shape)
            if d is not None:
                whole[d] *= world
            check_like(f"optimizer-state leaf {i}", opt[i],
                       torch.empty(whole, dtype=live.dtype, device="meta"))
        stale = arrays.get("stale", {})
        if sorted(stale) != sorted(meta.get("stale_keys", [])):
            raise ValueError("checkpoint stale snapshots do not match its "
                             "meta's stale_keys")
        for s, v in stale.items():
            k = decode_stale_key(s)[1]
            if k not in self._params:
                raise ValueError(f"stale snapshot {s!r} of an unregistered "
                                 f"key")
            check_like(f"stale snapshot {s!r}", v, self._params[k])
        if stale and not hasattr(self, "_stale"):
            raise ValueError(f"engine {self.engine_name!r} keeps no stale "
                             f"snapshots")
        # every check, the engine's own included, happens before any
        # change: a refused restore leaves the engine untouched
        self._validate_checkpoint_meta(meta)
        new_params = {k: place(params[k], self.device) for k in self._params}
        new_state = unflatten_like(self._state, {
            i: place(opt[i] if d is None
                     else opt[i].narrow(d, r * opt[i].shape[d] // world,
                                        opt[i].shape[d] // world),
                     self.device)
            for i, d in zip(live_opt, state_dims)})
        new_stale = {decode_stale_key(s): place(v, self.device)
                     for s, v in stale.items()}
        self._params = new_params
        self._state = new_state
        if hasattr(self, "_staged_async"):
            # in-flight per-key pushes belong to the pre-restore timeline; a
            # later commit would splice stale grads into the restored params
            self._staged_async = {}
        if hasattr(self, "_stale"):
            self._stale = new_stale
        self._load_checkpoint_meta(meta)


# -- the carry function: ps_tpu's checkpoints into the port's ------------------

#: the reference's engine names -> the port's
_ENGINES = {"tpu_sync": "cuda_sync", "tpu_async": "cuda_async",
            "local": "local", "sparse": "sparse"}

#: optax's chain of named states (in ``optax`` order) -> the port's
#: optimizer and whether it runs a schedule
_OPTAX_CHAINS = {
    ("EmptyState", "EmptyState"): ("sgd", False),
    ("EmptyState", "ScaleByScheduleState"): ("sgd", True),
    ("TraceState", "EmptyState"): ("momentum", False),
    ("TraceState", "ScaleByScheduleState"): ("momentum", True),
    ("ScaleByAdamState", "EmptyState"): ("adam", False),
    ("ScaleByAdamState", "ScaleByScheduleState"): ("adam", True),
    ("ScaleByAdamState", "EmptyState", "EmptyState", "EmptyState"):
        ("lamb", False),
    ("ScaleByAdamState", "EmptyState", "EmptyState", "ScaleByScheduleState"):
        ("lamb", True),
}


def _from_numpy(a) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a``; bf16 (ml_dtypes, which torch
    cannot read) goes through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _optax_paths(name: str, scheduled: bool, keys: List[str]) -> List[tuple]:
    """The port's state paths, listed in the order optax flattens the
    same state (``jax.tree_util.tree_leaves``)."""
    if name == "sgd":
        rule: List[tuple] = []
    elif name == "momentum":
        rule = [(k,) for k in keys]
    else:  # adam, lamb: ScaleByAdamState(count, mu{keys}, nu{keys})
        rule = ([("count",)] + [("mu", k) for k in keys]
                + [("nu", k) for k in keys])
    if not scheduled:
        return rule
    return [("rule",) + p for p in rule] + [("schedule_count",)]


def _parse_reference_structure(structure: str, per_key: int):
    """``(optimizer, scheduled, key order)`` from the reference's
    ``opt_structure`` (the ``str`` of its state's treedef). ``per_key`` is
    the number of per-key states (0 for one whole-tree state). The key
    order is the order the keys first appear, which is the reference's
    own flattening order."""
    names = re.findall(r"namedtuple\[(\w+)\]", structure)
    if per_key:
        if not names or len(names) % per_key:
            raise ValueError(f"cannot map the reference optimizer state "
                             f"{structure!r}")
        chain = tuple(names[:len(names) // per_key])
        if tuple(names) != chain * per_key:
            raise ValueError(f"cannot map the reference optimizer state "
                             f"{structure!r}: keys hold different states")
    else:
        chain = tuple(names)
    if chain not in _OPTAX_CHAINS:
        raise ValueError(f"cannot map the reference optimizer state "
                         f"{structure!r} (optax chain {chain}) onto the port: "
                         f"it maps sgd, momentum, adam and lamb, each with or "
                         f"without a schedule")
    name, scheduled = _OPTAX_CHAINS[chain]
    order = list(dict.fromkeys(re.findall(r"'((?:[^'\\]|\\.)*)'\s*:",
                                          structure)))
    return name, scheduled, order


def _rowwise_kind(leaves: List[np.ndarray], num_rows: int, dim: int) -> str:
    """The row-wise optimizer whose state ``leaves`` are, in tree order
    (the reference's sparse meta names none)."""
    sig = [(tuple(np.shape(a)), np.asarray(a).dtype.name) for a in leaves]
    kinds = {
        "sgd": [],
        "adagrad": [((num_rows,), "float32")],
        "adam": [((num_rows, dim), "float32"), ((num_rows,), "int32"),
                 ((num_rows, dim), "float32")],
    }
    for kind, want in kinds.items():
        if sig == want:
            return kind
    raise ValueError(f"cannot map the reference sparse optimizer state "
                     f"{sig} onto a row-wise sgd, adagrad or adam")


def from_reference(arrays: Dict[str, Any], meta: Dict[str, Any],
                   path: str) -> Dict[str, Any]:
    """Write a port checkpoint at ``path`` from a ``ps_tpu`` checkpoint.

    ``arrays`` are the reference checkpoint's groups as numpy arrays
    (``params``, ``opt``, ``stale``, ``worker_cache``; or ``table`` and
    ``opt`` for a sparse table), as ``ps_tpu.checkpoint.restore`` returns
    them; ``meta`` is its ``meta.json``. Engines map ``tpu_sync`` ->
    ``cuda_sync``, ``tpu_async`` -> ``cuda_async``, ``local`` and
    ``sparse`` to themselves. Optax's flat state maps onto the port's for
    sgd (and its schedule count), momentum, adam and lamb; a sparse
    table's for the row-wise sgd, adagrad and adam. Anything else is
    refused and named. Returns the port meta written."""
    from ps_tpu_torch.optim import make_optimizer

    engine = _ENGINES.get(meta.get("engine"))
    if engine is None:
        raise ValueError(f"no port engine for the reference engine "
                         f"{meta.get('engine')!r}; known: {sorted(_ENGINES)}")
    out_meta = {k: v for k, v in meta.items()
                if k not in ("arrays_dir", "generation")}
    out_meta["engine"] = engine
    ref_opt = arrays.get("opt", {})
    ref_leaves = [ref_opt[f"{i:05d}"] for i in range(len(ref_opt))]
    if engine == "sparse":
        kind = _rowwise_kind(ref_leaves, int(meta["num_rows"]),
                             int(meta["dim"]))
        # the port's row-wise states are the reference's, leaf for leaf
        # (adam's dict {m, t, v} sorts the same in both)
        out = {"table": _from_numpy(arrays["table"]),
               "opt": {f"{i:05d}": _from_numpy(a)
                       for i, a in enumerate(ref_leaves)}}
        skeleton = {"adam": {"m": 0, "t": 0, "v": 0}, "adagrad": 0,
                    "sgd": ()}[kind]
        out_meta["opt_structure"] = opt_fingerprint(kind, skeleton)
        save(path, out, out_meta)
        return out_meta
    params = {k: _from_numpy(v) for k, v in arrays["params"].items()}
    per_key = engine != "cuda_sync"  # the sync cuda server: one whole state
    name, scheduled, order = _parse_reference_structure(
        meta["opt_structure"], len(params) if per_key else 0)
    if order and set(order) != set(params):
        raise ValueError("the reference optimizer state's keys do not match "
                         "its parameters")
    order = order or sorted(params)
    opt = make_optimizer(name, learning_rate=(lambda count: 0.0)
                         if scheduled else 0.0)
    meta_params = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                   for k, p in params.items()}
    if per_key:
        live = {k: opt.init({k: meta_params[k]}) for k in params}
        ref_paths = [(k,) + p for k in order
                     for p in _optax_paths(name, scheduled, [k])]
    else:
        live = opt.init(meta_params)
        ref_paths = _optax_paths(name, scheduled, order)
    port = list(_leaf_paths(live))
    if len(ref_leaves) != len(ref_paths) or len(port) != len(ref_paths):
        raise ValueError(
            f"the reference {name} state has {len(ref_leaves)} leaves; the "
            f"port's has {len(port)} ({meta['opt_structure']!r})")
    where = {p: i for i, p in enumerate(ref_paths)}
    out_opt = {}
    for i, (p, live_leaf) in enumerate(port):
        t = _from_numpy(ref_leaves[where[p]])
        check_like(f"optimizer-state leaf {'/'.join(map(str, p))}", t,
                    live_leaf)
        out_opt[f"{i:05d}"] = t
    out = {"params": params, "opt": out_opt,
           "stale": {s: _from_numpy(v)
                     for s, v in arrays.get("stale", {}).items()},
           "worker_cache": {s: _from_numpy(v) for s, v in
                            arrays.get("worker_cache", {}).items()}}
    out_meta["opt_structure"] = opt_fingerprint(name, live)
    save(path, out, out_meta)
    return out_meta


__all__ = ["save", "restore", "read_meta", "nbytes", "flatten_leaves",
           "unflatten_like", "opt_fingerprint", "encode_stale_key",
           "decode_stale_key", "keep_worker", "CheckpointMixin",
           "from_reference", "to_cpu", "place", "check_like"]
