"""Run the port across k gloo ranks on the CPU, one process a rank.

This module holds no test. The multi-rank tests
(``tests/test_torch_ranks_*.py``, ``tests/test_torch_multiprocess.py``)
call :func:`run_ranks`, which starts k processes of this file, each
joining one process group through ``ps_tpu_torch.init(coordinator_uri=...,
num_processes=k, process_id=r, dist_backend='gloo')``, and kills them
after ``wall_s`` seconds, so a hung rendezvous or collective fails
instead of hanging. Every rank runs the same list of cases in order
(several cases share one group) and returns one result a case; inputs and
results are numpy, through pickle files this harness writes and reads.
The case functions live here, apart from the test modules, so a rank
imports torch and the port and never jax.

    python tests/test_torch_ranks_harness.py <rank> <k> <port> <spec.pkl> <out.pkl>
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import traceback

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(k, cases, tmp_path, env=None, wall_s=240, init=None):
    """Run ``cases`` (``[(name, kwargs)]``) on k ranks; returns
    ``results[rank][i]``. With ``env`` the ranks take their topology from
    those ``PS_*`` variables instead of init arguments."""
    return start_ranks(k, cases, tmp_path, env=env, init=init).finish(wall_s)


class RankRun:
    """k rank processes started by :func:`start_ranks`; :meth:`finish`
    waits for them (killing any still running after ``wall_s``) and
    returns ``results[rank][i]``."""

    def __init__(self, procs, outs, k):
        self.procs, self.outs, self.k = procs, outs, k

    def finish(self, wall_s=240, expect_rc=None):
        """``expect_rc`` (``{rank: rc}``): ranks that are to end so (a
        rank killed by a drill); their results are None."""
        expect_rc = expect_rc or {}
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=wall_s)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        k = self.k
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != expect_rc.get(r, 0):
                raise AssertionError(f"rank {r} of {k} failed (rc "
                                     f"{p.returncode}):\n{log[-6000:]}")
        results = []
        for r, out in enumerate(self.outs):
            if r in expect_rc:
                results.append(None)
                continue
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results


def start_ranks(k, cases, tmp_path, env=None, init=None) -> RankRun:
    """Start k rank processes running ``cases`` (as :func:`run_ranks`,
    without waiting): a test drives them meanwhile, then calls
    ``finish()``."""
    port = free_port()
    spec_file = os.path.join(str(tmp_path), f"spec-{port}.pkl")
    with open(spec_file, "wb") as f:
        pickle.dump({"cases": cases, "init": init or {},
                     "from_env": env is not None}, f)
    base = {key: v for key, v in os.environ.items()
            if key not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    base["PYTHONPATH"] = _REPO + os.pathsep + base.get("PYTHONPATH", "")
    base["OMP_NUM_THREADS"] = "1"
    procs, outs = [], []
    for r in range(k):
        out = os.path.join(str(tmp_path), f"out-{port}-{r}.pkl")
        e = dict(base)
        if env is not None:
            e.update({key: v.format(rank=r, port=port, k=k)
                      for key, v in env.items()})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "test_torch_ranks_harness.py"), str(r),
             str(k), str(port), spec_file, out],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        outs.append(out)
    return RankRun(procs, outs, k)


# -- rank side ------------------------------------------------------------------


def _np(t):
    """A numpy copy (a CPU tensor's ``.numpy()`` would share its memory and
    follow later in-place steps)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype.is_floating_point else t).numpy().copy()


def _flat_np(tree):
    from ps_tpu_torch.kv import keys

    flat, _ = keys.flatten_with_keys(tree)
    return {key: _np(v) for key, v in flat.items()}


def _slice(x, rank, k):
    n = len(x) // k
    return x[rank * n:(rank + 1) * n]


def _state_np(engine):
    from ps_tpu_torch.checkpoint import flatten_leaves

    return {i: _np(v) for i, v in flatten_leaves(engine._state).items()}


def _calls(mesh):
    return [(c.op, c.shape, c.nbytes, c.ring_bytes) for c in mesh.calls]


def _mlp_store(params, optimizer, opt_kw, placement, hidden,
               aggregate="mean", mode=None):
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.mlp import MLP

    model = MLP(hidden=hidden)
    store = ps.KVStore(optimizer=optimizer, placement=placement,
                       aggregate=aggregate, mode=mode, **opt_kw)
    store.init(model.params_from_jax(params))
    return model, store


def case_dense_steps(rank, k, *, params, batches, optimizer, opt_kw,
                     placement, hidden, aggregate="mean"):
    """``make_step`` over an MLP, each rank on its slice of each global
    batch."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.mlp import make_loss_fn

    model, store = _mlp_store(params, optimizer, opt_kw, placement, hidden,
                              aggregate)
    mesh = ps.current_context().mesh
    mesh.calls.clear()
    run = store.make_step(make_loss_fn(model))
    losses = []
    for images, labels in batches:
        loss, out = run(store.shard_batch((_slice(images, rank, k),
                                           _slice(labels, rank, k))))
        losses.append(float(loss))
    eng = store._engine
    return {"losses": losses, "params": _flat_np(out),
            "collective_bytes": store.collective_bytes,
            "calls": _calls(mesh), "dims": dict(eng._dims),
            "state": _state_np(eng), "state_dims": list(eng._state_dims),
            "keys": store.keys(), "num_workers": store.num_workers,
            "apply_count": eng.apply_count}


def case_per_key(rank, k):
    """The reference's per-key protocol: push stages, a pull of a staged
    tree would block, the last push applies the mean over the ranks."""
    import torch

    import ps_tpu_torch as ps

    store = ps.KVStore(optimizer="sgd", learning_rate=0.5)
    store.init({"w": torch.ones(8), "b": torch.zeros(8)})
    store.push("w", torch.full((8,), 2.0))
    try:
        store.pull("w")
        blocked = False
    except RuntimeError as e:
        blocked = "would block" in str(e)
    store.push("b", torch.ones(8))
    out = {"blocked": blocked, "w": _np(store.pull("w")),
           "b": _np(store.pull("b"))}
    # a push of every rank's own values: the server applies their mean
    store2 = ps.KVStore(optimizer="sgd", learning_rate=1.0)
    store2.init({"w": torch.zeros(4)})
    out["mean"] = _np(store2.push_pull({"w": torch.full((4,), float(rank))})
                      ["w"])
    return out


def case_byte_accounting(rank, k):
    import torch

    import ps_tpu_torch as ps

    store = ps.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init({"w": torch.ones((8, 8))})
    store.push_pull({"w": torch.ones((8, 8))})
    return {"collective_bytes": store._engine.collective_bytes}


def case_collectives_recorded(rank, k, *, placement):
    """One momentum step of the two-matrix model of the reference's
    ``test_hlo_collectives``: which collectives it ran."""
    import torch

    import ps_tpu_torch as ps

    w1, w2 = (256, 256), (256, 128)
    store = ps.KVStore(optimizer="momentum", learning_rate=0.1,
                       momentum=0.9, placement=placement)
    store.init({"w1": torch.zeros(w1), "w2": torch.zeros(w2)})

    def loss_fn(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["w1"])
        return torch.mean((h @ p["w2"] - y) ** 2)

    run = store.make_step(loss_fn)
    mesh = ps.current_context().mesh
    mesh.calls.clear()
    run(store.shard_batch((torch.zeros((64 // k, w1[0])),
                           torch.zeros((64 // k, w2[1])))))
    eng = store._engine
    return {"calls": _calls(mesh), "dims": dict(eng._dims),
            "state_shapes": {i: v.shape for i, v in _state_np(eng).items()}}


def _sparse(num_rows, dim, optimizer, opt_kw, exchange="gather",
            capacity_factor=2.0, table=None):
    import ps_tpu_torch as ps

    emb = ps.SparseEmbedding(num_rows, dim, optimizer=optimizer,
                             exchange=exchange,
                             capacity_factor=capacity_factor, **opt_kw)
    emb.init(table)
    return emb


def _global_slice(ids, grads, rank, k, dim):
    """This rank's part of a global push, padded to a multiple of k with
    the -1 filler as the reference pads it before shard_map splits it."""
    pad = (-len(ids)) % k
    if pad:
        ids = np.concatenate([ids, np.full(pad, -1, ids.dtype)])
        grads = np.concatenate([grads, np.zeros((pad, dim), grads.dtype)])
    return _slice(ids, rank, k), _slice(grads, rank, k)


def case_sparse_pushes(rank, k, *, num_rows, dim, optimizer, opt_kw, table,
                       pushes, exchange="gather", capacity_factor=2.0,
                       pull_ids=None):
    emb = _sparse(num_rows, dim, optimizer, opt_kw, exchange,
                  capacity_factor, table)
    for ids, grads in pushes:
        emb.push(*_global_slice(ids, grads, rank, k, dim))
    out = {"table": _np(emb.full_table()), "dropped": emb.dropped_rows,
           "rows_pushed": emb.rows_pushed,
           "collective_bytes": emb.collective_bytes,
           "padded_rows": emb.padded_rows, "local_rows": emb.table.shape[0],
           "row_version": emb.row_version.copy()}
    if pull_ids is not None:
        out["pulled"] = _np(emb.pull(_slice(pull_ids, rank, k)))
    return out


def case_export_adopt(rank, k, *, num_rows, dim, optimizer, opt_kw, table,
                      pushes, export, adopt):
    """``export_rows`` of global slots that span the ranks, then
    ``adopt_rows`` of those rows into other slots, on a table pushed
    first (every rank passes the same slots)."""
    emb = _sparse(num_rows, dim, optimizer, opt_kw, table=table)
    for ids, grads in pushes:
        emb.push(*_global_slice(ids, grads, rank, k, dim))
    rows, leaves = emb.export_rows(export)
    emb.adopt_rows(adopt, rows, leaves)
    again, again_leaves = emb.export_rows(adopt)
    return {"rows": rows, "leaves": leaves, "again": again,
            "again_leaves": again_leaves, "table": _np(emb.full_table()),
            "ops": [c.op for c in emb.mesh.calls]}


def _tiered_result(t):
    from ps_tpu_torch.ops.sparse_apply import state_leaves

    slots = np.arange(t.device_rows)
    rows, leaves = t.hot.export_rows(slots)
    return {"hot": rows, "hot_state": leaves, "arena": _np(t.arena),
            "cold_state": [_np(s) for s in t.cold_state],
            "dir": {a: getattr(t, a).copy() for a in (
                "tier", "slot", "freq", "ref", "slot_to_id")},
            "hand": t.hand, "dir_gen": t.dir_gen, "row_sum": t.row_sum(),
            "row_version": t.row_version.copy(),
            "counters": [t.hot_hits, t.misses, t.promotions, t.evictions,
                         t.push_count, t.rows_pushed],
            "leaves": len(state_leaves(t.state()))}


def case_tiered_pushes(rank, k, *, num_rows, dim, budget, optimizer, opt_kw,
                       table, pushes, admit_freq, pull_ids=None, path=None):
    """A ``TieredTable`` across the ranks, each rank pushing its slice of
    each global push: the move logs, the directory, both tiers (the hot
    one gathered), the row sum and, with ``pull_ids``, this rank's pull.
    With ``path`` a save there restored into a fresh table must equal the
    saved one."""
    from ps_tpu_torch.kv.tiered import TieredTable

    t = TieredTable(num_rows, dim, optimizer, device_rows=budget,
                    admit_freq=admit_freq, **opt_kw)
    t.init(table)
    logs = []
    for ids, grads in pushes:
        t.push(*_global_slice(ids, grads, rank, k, dim))
        logs.append(t.pop_moves())
    out = _tiered_result(t)
    out["logs"] = logs
    out["ops"] = sorted({c.op for c in t.mesh.calls})
    if pull_ids is not None:
        out["pulled"] = _np(t.pull(_slice(pull_ids, rank, k)))
    if path is not None:
        t.save(path)
        t2 = TieredTable(num_rows, dim, optimizer, device_rows=budget,
                         admit_freq=admit_freq, **opt_kw)
        t2.init(table)
        t2.restore(path)
        out["restored"] = _tiered_result(t2)
    return out


def case_a2a_route(rank, k, *, ids, grads, rows_per_shard, capacity_factor):
    """The port's ``_a2a_route`` on this rank's slice."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.kv import sparse

    mesh = ps.current_context().mesh
    rid, rg, dropped = sparse._a2a_route(
        torch.as_tensor(_slice(ids, rank, k)),
        torch.as_tensor(_slice(grads, rank, k)), mesh, rows_per_shard,
        capacity_factor)
    return {"ids": _np(rid), "grads": _np(rg), "dropped": int(dropped)}


def _widedeep(params, deep_table, wide_table, exchange, capacity_factor,
              vocab, dim, mlp):
    import ps_tpu_torch as ps
    from ps_tpu_torch.models import wide_deep as wd

    cfg = wd.WideDeepConfig(per_feature_vocab=vocab, embed_dim=dim, mlp=mlp)
    model = wd.WideDeep(cfg)
    model.params_from_jax(params)
    dense = ps.KVStore(optimizer="adam", learning_rate=1e-2,
                       placement="sharded")
    dense.init(model.param_tree())
    deep = ps.SparseEmbedding(cfg.total_rows, dim, optimizer="adagrad",
                              learning_rate=0.05, exchange=exchange,
                              capacity_factor=capacity_factor)
    wide = ps.SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                              learning_rate=0.05, exchange=exchange,
                              capacity_factor=capacity_factor)
    deep.init(deep_table)
    wide.init(wide_table)
    run = ps.make_composite_step(dense, {"deep": deep, "wide": wide},
                                 wd.make_wide_deep_loss_fn(model),
                                 wd.make_ids_fn(cfg))
    return dense, deep, wide, run


def case_widedeep_steps(rank, k, *, params, deep_table, wide_table, batches,
                        exchange="gather", capacity_factor=2.0, vocab=50,
                        dim=8, mlp=(32, 16)):
    """The W&D composite step, each rank on its slice of each batch."""
    dense, deep, wide, run = _widedeep(params, deep_table, wide_table,
                                       exchange, capacity_factor, vocab, dim,
                                       mlp)
    losses = []
    for batch in batches:
        loss, out = run(dense.shard_batch(
            {key: _slice(v, rank, k) for key, v in batch.items()}))
        losses.append(float(loss))
    return {"losses": losses, "params": _flat_np(out),
            "deep": _np(deep.full_table()), "wide": _np(wide.full_table()),
            "dropped": deep.dropped_rows + wide.dropped_rows,
            "rows_pushed": deep.rows_pushed,
            "collective_bytes": dense.collective_bytes,
            "sparse_collective_bytes": deep.collective_bytes}


def case_resnet_step(rank, k, *, params, stats, images, labels, placement,
                     resnet50=False, label_smoothing=0.0):
    """One momentum step of the tiny ResNet (or of ResNet-50 in f32) on
    this rank's slice."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.models import resnet

    model = (resnet.ResNet50(dtype=torch.float32) if resnet50 else
             resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                           num_filters=8, num_classes=10, small_inputs=True,
                           dtype=torch.float32))
    p, s = model.params_from_jax(params, stats)
    store = ps.KVStore(optimizer="momentum", learning_rate=0.1,
                       momentum=0.9, placement=placement)
    store.init(p)
    run = store.make_step(resnet.make_loss_fn(model, label_smoothing,
                                              mesh=store.mesh),
                          has_aux=True)
    local = store.shard_batch((_slice(images, rank, k),
                               _slice(labels, rank, k)))
    loss, new_p, new_s = run(local, s)
    out = {"loss": float(loss), "params": _flat_np(new_p),
           "stats": _flat_np(new_s)}
    # the model called outside the step (an evaluation or a probe on one
    # rank): no collective, this rank's own statistics
    calls = len(store.mesh.calls)
    logits, outside = model.apply(new_p, new_s, local[0], train=True)
    out.update(outside_logits=_np(logits), outside_stats=_flat_np(outside),
               outside_calls=len(store.mesh.calls) - calls)
    return out


def case_bert_step(rank, k, *, params, batches, placement="replicated",
                   learning_rate=1e-3, weight_decay=0.01, local_norms=False):
    """LAMB steps of BERT-tiny, each on this rank's slice of a global
    batch. ``local_norms``: a control whose trust ratio takes each rank's
    shard-local ``‖u‖`` (the norm all-reduce taken out)."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.models import bert

    model = bert.BertMLM(bert.BertConfig.tiny(),
                         generator=torch.Generator().manual_seed(0))
    model.params_from_jax(params)
    store = ps.KVStore(optimizer="lamb", learning_rate=learning_rate,
                       weight_decay=weight_decay, placement=placement,
                       mode="sync")
    store.init(model.param_tree())
    if local_norms:
        store._engine._norm_all_reduce = lambda flat, axis: flat
    run = store.make_step(bert.make_mlm_loss_fn(model, mesh=store.mesh))
    store.mesh.calls.clear()
    losses = []
    for batch in batches:
        loss, out = run(store.shard_batch({key: _slice(v, rank, k)
                                           for key, v in batch.items()}))
        losses.append(float(loss))
    return {"loss": losses[0], "losses": losses, "params": _flat_np(out),
            "calls": _calls(store.mesh), "dims": dict(store._engine._dims),
            "collective_bytes": store.collective_bytes}


def _tree_t(tree):
    """A nested dict of numpy arrays as torch tensors."""
    import torch

    if isinstance(tree, dict):
        return {key: _tree_t(v) for key, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _async_result(store, **extra):
    eng = store._engine
    return {"version": eng.version, "applies": eng._applies,
            "staleness_hist": dict(eng.staleness_hist),
            "apply_count": dict(eng.apply_count),
            "worker_version": dict(eng._worker_version),
            "collective_bytes": store.collective_bytes,
            "calls": _calls(store.mesh), "dims": dict(eng._dims), **extra}


def case_async_protocol(rank, k, *, params, grads, placement, hidden,
                        optimizer="sgd", opt_kw=None):
    """``tests/test_async_tpu.py``'s fixed interleaving: w0 pulls, w1
    pushes twice, w0 pushes stale by 2, w0 pulls. Every rank pushes the
    same global gradient, so the server's mean over the ranks is it."""
    _, store = _mlp_store(params, optimizer, opt_kw or {"learning_rate": 0.1},
                          placement, hidden, mode="async")
    store.mesh.calls.clear()
    g0, g1a, g1b = (_tree_t(grads[i]) for i in range(3))
    store.pull_all(worker=0)
    store.push_all(g1a, worker=1)
    store.push_all(g1b, worker=1)
    store.push_all(g0, worker=0)
    out = _flat_np(store.pull_all(worker=0))
    return _async_result(store, params=out)


def case_async_dc_math(rank, k, *, params, grads, placement, hidden):
    """``test_dc_correction_math``: one push stale by one version."""
    _, store = _mlp_store(params, "sgd", {"learning_rate": 0.1}, placement,
                          hidden, mode="async")
    w_stale = _flat_np(store.pull_all(worker=0))
    store.push_all(_tree_t(grads[0]), worker=1)
    w_now = _flat_np(store.params())
    store.push_all(_tree_t(grads[1]), worker=0)
    return {"w_stale": w_stale, "w_now": w_now,
            "got": _flat_np(store.params())}


def case_async_versions(rank, k, *, params, grad, placement, hidden):
    """``test_version_and_staleness`` (3 workers)."""
    _, store = _mlp_store(params, "sgd", {"learning_rate": 0.1}, placement,
                          hidden, mode="async")
    store.pull_all(worker=0)
    seen = [store.staleness(0)]
    store.push_all(_tree_t(grad), worker=1)
    store.push_all(_tree_t(grad), worker=2)
    seen += [store._engine.version, store.staleness(0)]
    store.pull_all(worker=0)
    seen.append(store.staleness(0))
    return {"seen": seen}


def case_async_trains(rank, k, *, params, batches, placement, hidden):
    """``test_make_async_step_trains``: 2 workers round-robin, each cycle
    on this rank's slice of the worker's global batch."""
    from ps_tpu_torch.models.mlp import make_loss_fn

    model, store = _mlp_store(params, "sgd", {"learning_rate": 0.1},
                              placement, hidden, mode="async")
    run = store.make_async_step(make_loss_fn(model))
    losses = []
    for step_batches in batches:
        for w, (images, labels) in enumerate(step_batches):
            losses.append(float(run(store.shard_batch(
                (_slice(images, rank, k), _slice(labels, rank, k))),
                worker=w)))
    return _async_result(store, losses=losses, staleness=store.staleness(0),
                         params=_flat_np(store.params()))


def case_async_guards(rank, k, *, params, hidden):
    """``test_mode_guards``: make_step refuses the async store and
    make_async_step the sync one, on every rank, before any collective."""
    out = {}
    for mode, build in (("async", "make_step"), ("sync", "make_async_step")):
        _, store = _mlp_store(params, "sgd", {}, "replicated", hidden,
                              mode=mode)
        try:
            getattr(store, build)(lambda p, b: 0.0)
            out[mode] = ""
        except RuntimeError as e:
            out[mode] = str(e)
    return out


def case_async_threads(rank, k, *, params, grad, hidden):
    """Host threads driving workers across ranks are refused, at once and
    on every rank; the group goes on working from the first thread."""
    import threading

    _, store = _mlp_store(params, "sgd", {"learning_rate": 0.1},
                          "replicated", hidden, mode="async")
    store.pull_all(worker=0)
    errors = []

    def other():
        try:
            store.pull_all(worker=1)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    store.push_all(_tree_t(grad), worker=0)
    return {"errors": errors, "alive": t.is_alive(),
            "version": store._engine.version}


def case_async_ckpt(rank, k, *, params, grads, placement, hidden, path,
                    save=False, restore=None):
    """The async checkpoint across ranks. Without ``restore``: 3 workers
    each pull and push, then ``save`` or not, then worker 1 pushes and
    worker 0 pushes stale. With ``restore`` ('strict' or 'elastic'):
    restore ``path`` into this group's ``num_workers`` and make those two
    pushes; a worker the grown job adds (id 3) then pulls and pushes, and
    a push by an id past ``num_workers`` must raise on every rank."""
    _, store = _mlp_store(params, "sgd", {"learning_rate": 0.1}, placement,
                          hidden, mode="async")
    out = {}
    eng = store._engine
    if restore is None:
        for w in range(3):
            store.pull_all(worker=w)
            store.push_all(_tree_t(grads[w]), worker=w)
        if save:
            store.save(path)
            out["saved"] = _flat_np(store.params())
    else:
        try:
            out["restored"] = _flat_np(store.restore(
                path, elastic=restore == "elastic"))
        except ValueError as e:
            return {"refused": str(e)}
        out["restored_versions"] = dict(eng._worker_version)
        out["restored_stale"] = sorted({w for w, _ in eng._stale})
        out["restored_cache"] = sorted(store._async_params)
    store.push_all(_tree_t(grads[3]), worker=1)
    store.push_all(_tree_t(grads[4]), worker=0)
    if store.num_workers > 3:
        store.pull_all(worker=3)
        out["new_worker_staleness"] = store.staleness(3)
        store.push_all(_tree_t(grads[5]), worker=3)
    try:
        store.push_all(_tree_t(grads[5]), worker=store.num_workers)
        out["out_of_range"] = ""
    except ValueError as e:
        out["out_of_range"] = str(e)
    out.update(_async_result(store, params=_flat_np(store.params())))
    return out


def case_ckpt(rank, k, *, params, batches, path, steps, save=False,
              restore=None, hidden=16, table=None, crash=False):
    """The reference's elastic drill: ``restore`` ('strict' or 'elastic')
    a checkpoint first, or not; then take ``steps`` steps (resuming the
    batch stream at ``store.step``); then ``save`` or not. With ``table``
    a sparse adagrad table rides along, one push a step. ``crash`` saves
    once more with rank 0's commit taken out: the arrays of a new
    generation land, the meta is never written."""
    import ps_tpu_torch as ps
    from ps_tpu_torch import checkpoint as ckpt
    from ps_tpu_torch.models.mlp import make_loss_fn

    model, store = _mlp_store(params, "adam", {"learning_rate": 1e-3},
                              "sharded", hidden)
    emb = None
    if table is not None:
        emb = _sparse(table.shape[0], table.shape[1], "adagrad",
                      {"learning_rate": 0.1}, table=table)
    out = {}
    if restore is not None:
        try:
            out["restored"] = _flat_np(store.restore(
                path, elastic=restore == "elastic"))
            out["restored_state"] = _state_np(store._engine)
            if emb is not None:
                emb.restore(path + "-table", elastic=restore == "elastic")
                out["restored_table"] = _np(emb.full_table())
        except ValueError as e:
            return {"refused": str(e)}
    run = store.make_step(make_loss_fn(model))
    losses = []
    for images, labels in batches[store.step:store.step + steps]:
        loss, _ = run(store.shard_batch((_slice(images, rank, k),
                                         _slice(labels, rank, k))))
        losses.append(float(loss))
        if emb is not None:
            ids = (np.arange(len(images), dtype=np.int32) * 7) % table.shape[0]
            emb.push(_slice(ids, rank, k),
                     _slice(np.ones((len(images), table.shape[1]),
                                    np.float32) * 0.1, rank, k))
    out.update(losses=losses, params=_flat_np(store.params()),
               step=store.step, state=_state_np(store._engine),
               state_dims=list(store._engine._state_dims))
    if emb is not None:
        out["table"] = _np(emb.full_table())
    if save:
        store.save(path)
        if emb is not None:
            emb.save(path + "-table")
        out["saved"] = _flat_np(store.params())
        out["meta"] = ckpt.read_meta(path)
        out["meta_path"] = os.path.join(path, "meta.json")
        out["files"] = sorted(os.listdir(os.path.join(
            path, out["meta"]["arrays_dir"])))
    if crash:
        commit = ckpt._commit
        if rank == 0:
            ckpt._commit = lambda *args: None
        try:
            store.save(path)
        finally:
            ckpt._commit = commit
        out["after_crash_meta"] = ckpt.read_meta(path)
        out["dirs"] = sorted(d for d in os.listdir(path)
                             if d.startswith("arrays-"))
        out["after_crash"] = _flat_np(store.restore(path))
    return out


# -- the 'model', 'seq' and 'pipe' axes ------------------------------------------


def _specs(store):
    return {key: tuple(spec) for key, spec in store._engine._specs.items()}


def _state_specs(store):
    """``{state path: spec}`` of the engine's optimizer state."""
    from ps_tpu_torch.checkpoint import _leaf_paths

    paths = ["/".join(str(p) for p in path)
             for path, _ in _leaf_paths(store._engine._state)]
    return dict(zip(paths, (tuple(s) for s in store._engine._state_specs)))


def _block_loss(p, batch):
    """``tests/test_model_axis.py``'s block loss on whole tensors."""
    import torch

    x, y = batch
    d = p["attn"]["out"]["kernel"].shape[0]
    a = x @ p["attn"]["qkv"]["kernel"] + p["attn"]["qkv"]["bias"]
    a = torch.tanh(a[:, :d])
    a = a @ p["attn"]["out"]["kernel"] + p["attn"]["out"]["bias"]
    h = torch.tanh(a @ p["mlp"]["in"]["kernel"] + p["mlp"]["in"]["bias"])
    out = h @ p["mlp"]["out"]["kernel"] + p["mlp"]["out"]["bias"]
    return torch.mean((out - y) ** 2)


def _block_tp_loss(mesh):
    """The same loss written for the Megatron rules' slices: the column-
    parallel qkv's activations gathered over 'model' (its q columns lie on
    one rank), the row-parallel out-projections' partial sums reduced."""
    import torch

    from ps_tpu_torch.parallel import collectives as c

    m = "model"

    def loss(p, batch):
        x, y = batch
        d = p["attn"]["out"]["kernel"].shape[1]
        a = c.gather_from_axis(
            c.copy_to_axis(x, mesh, m) @ p["attn"]["qkv"]["kernel"]
            + p["attn"]["qkv"]["bias"], mesh, m, 1)
        a = torch.tanh(a[:, :d])
        a = c.reduce_from_axis(c.split_to_axis(a, mesh, m, 1)
                               @ p["attn"]["out"]["kernel"], mesh, m)
        a = a + p["attn"]["out"]["bias"]
        h = torch.tanh(c.copy_to_axis(a, mesh, m) @ p["mlp"]["in"]["kernel"]
                       + p["mlp"]["in"]["bias"])
        out = c.reduce_from_axis(h @ p["mlp"]["out"]["kernel"], mesh, m)
        return torch.mean((out + p["mlp"]["out"]["bias"] - y) ** 2)

    return loss


def case_block_steps(rank, k, *, params, batches, rules=None,
                     optimizer="adam", opt_kw=None, placement="sharded"):
    """``test_model_axis``'s block trained by ``make_step``: with rules the
    Megatron loss over this rank's slices, without them the whole loss
    over the leaves the store gathers. Returns the losses, the whole
    params, every leaf's spec and the optimizer state's specs."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice

    store = ps.KVStore(optimizer=optimizer, placement=placement,
                       partition_rules=rules,
                       **(opt_kw or {"learning_rate": 1e-3}))
    store.init(_tree_t(params))
    mesh = store.mesh
    run = store.make_step(_block_tp_loss(mesh) if rules else _block_loss)
    losses = []
    for b in batches:
        loss, _ = run(store.shard_batch(rank_slice(tuple(b), mesh)))
        losses.append(float(loss))
    return {"losses": losses, "params": _flat_np(store.params()),
            "specs": _specs(store), "state_specs": _state_specs(store),
            "coords": dict(mesh.coords)}


def case_block_async(rank, k, *, params, batches, rules=None,
                     placement="sharded"):
    """The block's async DC-ASGD cycles (one logical worker) under the
    rules: pulls are whole, each rank steps its blocks of every leaf and
    all-gathers them. Returns the losses, the whole params and the
    specs."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice

    store = ps.KVStore(optimizer="adam", learning_rate=1e-3, mode="async",
                       placement=placement, partition_rules=rules)
    store.init(_tree_t(params))
    run = store.make_async_step(_block_loss)
    losses = [float(run(store.shard_batch(rank_slice(tuple(b),
                                                     store.mesh))))
              for b in batches]
    return {"losses": losses, "params": _flat_np(store.params()),
            "specs": _specs(store), "version": store._engine.version}


def _bert_tp_store(params, rules, local_norms):
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.models import bert

    model = bert.BertMLM(bert.BertConfig.tiny(),
                         generator=torch.Generator().manual_seed(0))
    model.params_from_jax(params)
    store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                       weight_decay=0.01, placement="sharded",
                       partition_rules=bert.bert_partition_rules() if rules
                       else None)
    store.init(model.param_tree())
    if local_norms:  # the control: each rank's own norms of its slices
        store._engine._norm_all_reduce = lambda flat, axis: flat
    return model, store


def case_bert_tp(rank, k, *, params, batch, steps, rules=True,
                 local_norms=False):
    """BERT-tiny with LAMB 'sharded' and ``bert_partition_rules`` on this
    rank's data slice of ``batch``, ``steps`` times. ``returned`` is the
    last step's params tree as ``run`` returned it, ``returned_want`` the
    same leaves cut from ``store.params()`` (a rule's 'model' slice, the
    rest whole)."""
    import torch

    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models import bert
    from ps_tpu_torch.parallel.sharding import SLICE_AXES, block

    model, store = _bert_tp_store(params, rules, local_norms)
    run = store.make_step(bert.make_mlm_loss_fn(model, mesh=store.mesh))
    store.mesh.calls.clear()
    losses = []
    for _ in range(steps):
        loss, out = run(store.shard_batch(rank_slice(batch, store.mesh)))
        losses.append(float(loss))
    norm_reduces = [(c.axis, c.shape) for c in store.mesh.calls
                    if c.op == "all_reduce" and len(c.shape) == 1
                    and c.nbytes < 4096]
    engine = store._engine
    whole, _ = keys.flatten_with_keys(store.params())
    want = {key: _np(block(torch.as_tensor(w), engine._specs[key],
                           store.mesh, SLICE_AXES)
                     if engine._ruled[key] else torch.as_tensor(w))
            for key, w in whole.items()}
    return {"losses": losses, "params": _flat_np(store.params()),
            "specs": _specs(store), "norm_reduces": norm_reduces,
            "held": {key: tuple(t.shape)
                     for key, t in engine._params.items()},
            "returned": _flat_np(out), "returned_want": want}


def case_bert_tp_ckpt(rank, k, *, params, batch, path, restore=None):
    """Under ``bert_partition_rules``: two steps, a save, one more step;
    then a fresh store restores the save and takes the same step. With
    ``restore`` ('strict' or 'elastic') only restore the save at ``path``
    into this mesh's store instead."""
    import os

    from ps_tpu_torch import checkpoint as ckpt
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models import bert

    def fresh():
        model, store = _bert_tp_store(params, True, False)
        return store, store.make_step(bert.make_mlm_loss_fn(
            model, mesh=store.mesh))

    def step(store, run):
        return float(run(store.shard_batch(rank_slice(batch,
                                                      store.mesh)))[0])

    store, run = fresh()
    if restore is not None:
        try:
            store.restore(path, elastic=restore == "elastic")
        except ValueError as e:
            return {"refused": str(e)}
        return {"restored": _flat_np(store.params())}
    for _ in range(2):
        step(store, run)
    saved_state = _state_np(store._engine)
    saved_params = _flat_np(store.params())
    store.save(path)
    want = step(store, run)
    want_params = _flat_np(store.params())
    store, run = fresh()
    store.restore(path)
    out = {"restored_params": _flat_np(store.params()),
           "saved_params": saved_params,
           "restored_state": _state_np(store._engine),
           "saved_state": saved_state}
    out.update(loss=step(store, run), want_loss=want,
               params=_flat_np(store.params()), want_params=want_params)
    meta = ckpt.read_meta(path)
    out["meta"] = meta
    out["files"] = sorted(os.listdir(os.path.join(path, meta["arrays_dir"])))
    return out


def case_lm_steps(rank, k, *, attn="full", rules=False, steps=6, vocab=64,
                  d_model=32, n_heads=4, n_layers=2, seq_len=32, batch=8,
                  microbatches=0, lr=3e-3, optimizer="adam",
                  placement="sharded", init_seed=0, data_seed=1,
                  max_len=None):
    """``tests/test_lm.py``'s training run on this rank's part of each
    global batch (``lm_partition_rules`` with ``rules``; a GPipe trunk
    over 'pipe' with ``microbatches``)."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models import lm

    ctx = ps.current_context()
    mesh = ctx.mesh
    params = lm.init_params(np.random.default_rng(init_seed), vocab=vocab,
                            d_model=d_model, n_heads=n_heads,
                            n_layers=n_layers,
                            max_len=max_len or seq_len + 1)
    attn_fn = lm.make_attn_fn(attn, mesh=mesh)
    if microbatches:
        pp = mesh.axis_size("pipe")
        params = lm.split_pipeline_params(params, num_stages=pp)
        part = lm.pipeline_lm_partition_rules()
        loss_fn = lm.make_pipelined_loss_fn(
            n_heads=n_heads, num_stages=pp, microbatches=microbatches,
            mesh=mesh, attn_fn=attn_fn)
    else:
        part = lm.lm_partition_rules() if rules else None
        loss_fn = lm.make_loss_fn(n_heads=n_heads, attn_fn=attn_fn,
                                  mesh=mesh)
    store = ps.KVStore(optimizer=optimizer, learning_rate=lr,
                       placement=placement, partition_rules=part)
    store.init(params)
    run = store.make_step(loss_fn)
    losses = []
    for b in lm.lm_batches(batch, seq_len, vocab=vocab, seed=data_seed,
                           steps=steps):
        loss, _ = run(store.shard_batch(rank_slice(b, mesh)))
        losses.append(float(loss))
    return {"losses": losses, "specs": _specs(store),
            "calls": sorted({(c.op, c.axis) for c in mesh.calls})}


def case_seq_attention(rank, k, *, q, k_, v, op, causal):
    """Ring or Ulysses attention on this rank's block of global [B, T, H,
    D] q/k/v (its data slice of B, its seq slice of T), the output block
    and the gradients of ``sum(out ** 2)`` (summed over every rank's
    block) with respect to this rank's blocks."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.parallel.ring_attention import (ring_attention,
                                                      ulysses_attention)

    mesh = ps.current_context().mesh
    blocks = rank_slice({"q": q, "k": k_, "v": v}, mesh)
    qb, kb, vb = (torch.tensor(blocks[n], requires_grad=True)
                  for n in ("q", "k", "v"))
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[op]
    out = fn(qb, kb, vb, mesh, causal=causal)
    (out ** 2).sum().backward()
    return {"out": _np(out), "grads": [_np(t.grad) for t in (qb, kb, vb)],
            "calls": sorted({(c.op, c.axis) for c in mesh.calls})}


def case_longctx_trainer(rank, k, *, port, argv):
    """``train_longctx_lm`` as a launcher runs it: this rank's ``PS_*``
    variables, a process group of its own at ``port``; returns its final
    loss."""
    import os

    import ps_tpu_torch as ps
    from ps_tpu_torch.examples import train_longctx_lm

    ps.shutdown()
    os.environ.update({"PS_COORDINATOR_URI": f"127.0.0.1:{port}",
                       "PS_NUM_PROCESSES": str(k), "PS_PROCESS_ID": str(rank),
                       "PS_DIST_BACKEND": "gloo"})
    return train_longctx_lm.main(argv)


def _stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def case_pipeline(rank, k, *, stages, x, batches, microbatches):
    """``tests/test_pipeline.py``'s stack of stages over the 'pipe' axis:
    the pipelined forward of ``x``, sgd training through the pipeline on
    ``batches`` (pipeline_partition_rules, a store), and the adam
    moments' specs under the same rules."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.parallel import pipeline as pl

    mesh = ps.current_context().mesh
    stacked = pl.stack_stage_params([_tree_t(s) for s in stages])
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1,
                       placement="replicated",
                       partition_rules=pl.pipeline_partition_rules())
    store.init({"stack": stacked})
    fn = pl.make_pipeline_fn(_stage_fn, mesh, microbatches=microbatches)
    xs = torch.as_tensor(rank_slice(x, mesh))
    tree = store._engine.tree()
    with torch.no_grad():
        out = fn({"w": tree["stack/w"], "b": tree["stack/b"]},
                 pl.microbatch(xs, microbatches))
    b_local, dm = xs.shape

    def loss_fn(params, batch):
        xb, yb = batch
        h = fn(params["stack"], pl.microbatch(xb, microbatches))
        return torch.mean((h.reshape(b_local, dm) - yb) ** 2)

    run = store.make_step(loss_fn)
    losses = [float(run(store.shard_batch(rank_slice(tuple(b), mesh)))[0])
              for b in batches]
    held = {key: tuple(t.shape) for key, t in store._engine._params.items()}
    adam = ps.KVStore(optimizer="adam", learning_rate=1e-3,
                      placement="replicated",
                      partition_rules=pl.pipeline_partition_rules())
    adam.init({"stack": stacked})
    return {"out": _np(out.reshape(-1, dm)), "losses": losses,
            "specs": _specs(store), "held": held,
            "state_specs": _state_specs(adam)}


# -- a dense async store served across the ranks (backends/op_stream.py) -------


def _ctl_wait(path, timeout=120.0):
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)


def _ctl_write(path, text):
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def _served_store(params, optimizer, opt_kw, placement):
    import torch

    import ps_tpu_torch as ps

    store = ps.KVStore(optimizer=optimizer, placement=placement,
                       mode="async", **opt_kw)
    store.init({key: torch.from_numpy(np.array(v))
                for key, v in params.items()})
    return store


def _served_result(store, ops):
    """This rank's engine after the service: every counter, and the whole
    rows of every key (``export_keys``, a collective every rank makes)."""
    eng = store._engine
    keys = sorted(eng._params)
    rows = eng.export_keys(keys)
    return {"params": {key: np.array(r["param"]) for key, r in rows.items()},
            "state": {key: {p: np.array(v) for p, v in r["state"].items()}
                      for key, r in rows.items()},
            "stale": {key: {int(w): np.array(v)
                            for w, v in r["stale"].items()}
                      for key, r in rows.items()},
            "apply_count": {key: r["apply_count"] for key, r in rows.items()},
            "version": eng.version,
            "worker_version": dict(eng._worker_version),
            "staleness_hist": dict(eng.staleness_hist),
            "ops": ops.ops, "op_bytes": ops.bytes,
            "by_op": dict(ops.by_op), "bytes_by_op": dict(ops.bytes_by_op),
            "launches": _launches()}


def _launches():
    """This process's launch counts of every kernel of the port."""
    import importlib

    from ps_tpu_torch.ops import sparse_apply

    fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")
    return {"sparse_apply": sparse_apply.LAUNCHES,
            "sparse_group": sparse_apply.GROUP_LAUNCHES,
            "flash_attention/fwd": fa.LAUNCHES}


def case_served(rank, k, *, params, optimizer, opt_kw, placement, ctl, name,
                backup=False, native_loop=False, stamp=None, probe=False):
    """A store across the ranks served by ``serve_async``: rank 0 writes
    its port to ``<ctl>/<name>.port`` and serves until ``<name>.done``
    appears (the test drives it meanwhile), then stops; the other ranks
    follow its op stream. With ``stamp`` every birth record is that one
    (READ replies compare byte for byte); with ``probe`` rank 0 first
    tries ``AsyncPSService`` alone on the store (its refusal is in the
    result). Returns this rank's engine state, and on rank 0 the
    service's logs, its admission counts and its role."""
    from ps_tpu_torch.backends.remote_async import AsyncPSService, serve_async
    from ps_tpu_torch.obs import freshness

    if stamp is not None:
        freshness.birth_record = lambda wall=None, mono=None: dict(stamp)
    store = _served_store(params, optimizer, opt_kw, placement)
    out = {}
    if probe and rank == 0:
        try:
            AsyncPSService(store).stop()
            out["probe"] = ""
        except ValueError as e:
            out["probe"] = str(e)
    svc = serve_async(store, backup=backup, native_loop=native_loop)
    if rank == 0:
        _ctl_write(os.path.join(ctl, f"{name}.port"), str(svc.port))
        _ctl_wait(os.path.join(ctl, f"{name}.done"))
        out["admit"] = svc.admit_stats()  # the loop's, read before it ends
        svc.stop()
        out.update(event_log=list(svc.event_log), role=svc.role,
                   keys=list(svc._key_order), goodbyes=svc.goodbyes)
        ops = svc._ops
    else:
        if not svc.join(timeout=120):
            raise TimeoutError("rank 0 never stopped its op stream")
        ops = svc
    out.update(_served_result(store, ops))
    return out


def case_served_kill(rank, k, *, params, ctl, victim, placement="sharded",
                     sig="SIGKILL"):
    """A follower's death under a served store (heartbeats on): rank
    ``victim`` sends itself ``sig`` when ``<ctl>/kill`` appears (SIGSTOP:
    its sockets stay open, only the heartbeat detector can tell); rank 0
    serves until ``<ctl>/done`` and returns how its service ended (the
    group is then aborted, never joined)."""
    import signal

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import serve_async

    store = _served_store(params, "sgd", {"learning_rate": 0.1}, placement)
    svc = serve_async(store)
    if rank == victim:
        _ctl_wait(os.path.join(ctl, "kill"))
        os.kill(os.getpid(), getattr(signal, sig))
    if rank == 0:
        _ctl_write(os.path.join(ctl, "served.port"), str(svc.port))
    _ctl_wait(os.path.join(ctl, "done"))
    ops = svc._ops if rank == 0 else svc
    out = {"error": repr(ops._error), "ops": ops.ops,
           "killed": rank == 0 and svc._stop.is_set()}
    ps.shutdown(abort=True)
    return out


# -- the driver side of the served cases (this repo's tests, chip_smoke.py) ----


class Drive:
    """Frames to services over raw channels, every reply kept by tag (its
    kind, header, tensors and bytes); a reply that is not OK or
    NOT_MODIFIED raises."""

    def __init__(self):
        self.replies = {}
        self._chs = {}

    def req(self, tag, port, kind, worker, tensors=None, extra=None):
        from ps_tpu_torch.control import tensor_van as tv

        ch = self._chs.get(port)
        if ch is None:
            ch = self._chs[port] = tv.Channel.connect("127.0.0.1", port)
        raw = bytes(ch.request(tv.encode(kind, worker, tensors, extra)))
        k, _, t, e = tv.decode(raw)
        if k not in (tv.OK, tv.NOT_MODIFIED):
            raise AssertionError(f"{tag}: {e}")
        self.replies[tag] = {"kind": k, "extra": dict(e or {}), "raw": raw,
                             "tensors": {n: np.array(v)
                                         for n, v in (t or {}).items()}}
        return self.replies[tag]

    def close(self):
        for ch in self._chs.values():
            ch.close()


def like(tree, device="cpu"):
    """Numpy leaves as tensors of their own on ``device``."""
    import torch

    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def served_rows(engine, keys=None):
    """An engine's rows as numpy (either package's ``export_keys``, under
    its lock) and its counters."""
    with engine._lock:
        keys = sorted(engine._params) if keys is None else keys
        rows = engine.export_keys(keys)
    return {"params": {k: np.asarray(r["param"]) for k, r in rows.items()},
            "state": {k: {p: np.asarray(v) for p, v in r["state"].items()}
                      for k, r in rows.items()},
            "stale": {k: {int(w): np.asarray(v)
                          for w, v in r["stale"].items()}
                      for k, r in rows.items()},
            "apply_count": {k: int(r["apply_count"])
                            for k, r in rows.items()},
            "version": engine.version,
            "worker_version": {int(w): int(v) for w, v
                               in engine._worker_version.items()},
            "staleness_hist": {int(t): int(n) for t, n
                               in engine.staleness_hist.items()}}


def scenario_primary(port, b_port, c_port, ckpt, params, grads, moved,
                     bucket_bytes=256, device="cpu"):
    """A primary's frames (``grads``: 8 trees): pushes of two workers
    (serial, a replayed push, a bucketed ``push_pull`` of ``bucket_bytes``
    buckets), READ and NOT_MODIFIED, ``checkpoint_all`` into ``ckpt``, a
    live move of ``moved`` to the shard at ``b_port`` and back, a RESEED
    onto the spare at ``c_port``, a push it follows, and its promotion.
    Returns the replies, the bucketed pull and the checkpoint's
    versions."""
    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.control import tensor_van as tv

    d = Drive()
    try:
        d.req("hello", port, tv.HELLO, 0)
        d.req("pull0", port, tv.PULL, 0)
        d.req("pull1", port, tv.PULL, 1)
        d.req("push0", port, tv.PUSH, 0, grads[0], {"pseq": 1, "pnonce": "n0"})
        d.req("pushpull1", port, tv.PUSH_PULL, 1, grads[1],
              {"pseq": 1, "pnonce": "n1"})
        d.req("push0b", port, tv.PUSH, 0, grads[2], {"pseq": 2, "pnonce": "n0"})
        d.req("replay0b", port, tv.PUSH, 0, grads[2],
              {"pseq": 2, "pnonce": "n0"})
        w = connect_async(f"127.0.0.1:{port}", 1, like(params, device),
                          bucket_bytes=bucket_bytes, pool_size=2)
        try:
            pulled = w.push_pull(like(grads[3], device))
            bucketed = {k: v.cpu().numpy().copy() for k, v in pulled.items()}
        finally:
            w.close()
        v = d.req("read", port, tv.READ, 0)["extra"]["version"]
        d.req("read_nm", port, tv.READ, 0, None, {"cond": v})
        d.req("read_old", port, tv.READ, 0, None, {"cond": v - 1})
        w = connect_async(f"127.0.0.1:{port}", 0, like(params, device))
        try:
            ckpt_versions = w.checkpoint_all(ckpt)
        finally:
            w.close()
        d.req("read_ckpt", port, tv.READ, 0)
        d.req("pushpull0", port, tv.PUSH_PULL, 0, grads[4],
              {"pseq": 3, "pnonce": "n0"})
        d.req("move_out", port, tv.MIGRATE_OUT, 0, None, {
            "keys": list(moved), "target": f"127.0.0.1:{b_port}",
            "table_epoch": 1})
        rest = {k: g for k, g in grads[5].items() if k not in moved}
        d.req("push_rest", port, tv.PUSH, 0, rest, {"pseq": 4, "pnonce": "n0"})
        d.req("move_back", b_port, tv.MIGRATE_OUT, 0, None, {
            "keys": list(moved), "target": f"127.0.0.1:{port}",
            "table_epoch": 2})
        d.req("pushpull1b", port, tv.PUSH_PULL, 1, grads[6],
              {"pseq": 2, "pnonce": "n1"})
        d.req("reseed", port, tv.RESEED, 0, None,
              {"spare": f"127.0.0.1:{c_port}"})
        d.req("push_repl", port, tv.PUSH, 0, grads[7],
              {"pseq": 5, "pnonce": "n0"})
        d.req("pull_repl", port, tv.PULL, 1)
        d.req("promote_c", c_port, tv.REPLICA_PROMOTE, 0, None,
              {"reason": "test"})
        d.req("read_c", c_port, tv.READ, 0)
        d.req("read_final", port, tv.READ, 0)
    finally:
        d.close()
    return {"replies": d.replies, "bucketed": bucketed,
            "ckpt_versions": ckpt_versions}


#: the reply fields two runs of the same frames may differ in: a move's
#: and a re-seed's seconds (the run's clock), their frame bytes (a
#: re-seed ships the engine's meta, whose ``collective_bytes`` counts the
#: ranks) and a checkpoint's path
UNEQUAL = frozenset({"seconds", "bytes", "path"})


def same_reply(got, want, tag, tol=None):
    """Two replies to one frame: the kind, the header (:data:`UNEQUAL`
    aside) and the tensors, bitwise (and then the bytes, where the
    header has none of those fields) or within ``tol``
    (``{"rtol", "atol"}``)."""
    def strip(extra):
        return {k: v for k, v in extra.items() if k not in UNEQUAL}

    assert got["kind"] == want["kind"], tag
    assert strip(got["extra"]) == strip(want["extra"]), tag
    assert sorted(got["tensors"]) == sorted(want["tensors"]), tag
    for k, v in want["tensors"].items():
        _same_array(got["tensors"][k], v, f"{tag} {k}", tol)
    if tol is None and not UNEQUAL & set(want["extra"]):
        assert got["raw"] == want["raw"], tag


def same_rows(got, want, what, tol=None):
    """Two engines' rows (:func:`served_rows`), bitwise or within
    ``tol``; the counters exactly, where both carry them."""
    assert sorted(got["params"]) == sorted(want["params"]), what
    for k, v in want["params"].items():
        _same_array(got["params"][k], v, f"{what} param {k}", tol)
    for k, leaves in want["state"].items():
        assert sorted(got["state"][k]) == sorted(leaves), (what, k)
        for p, v in leaves.items():
            _same_array(got["state"][k][p], v, f"{what} state {k} {p}", tol)
    for k, per in want["stale"].items():
        assert sorted(got["stale"][k]) == sorted(per), (what, k)
        for w, v in per.items():
            _same_array(got["stale"][k][w], v, f"{what} stale {k} {w}", tol)
    for key in ("apply_count", "version", "worker_version",
                "staleness_hist"):
        if key in want and key in got:
            assert got[key] == want[key], (what, key, got[key], want[key])


def _same_array(got, want, what, tol):
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv) -> int:
    rank, k, port, spec_file, out_file = (int(argv[1]), int(argv[2]),
                                          int(argv[3]), argv[4], argv[5])
    import torch

    torch.set_num_threads(1)
    import ps_tpu_torch as ps

    with open(spec_file, "rb") as f:
        spec = pickle.load(f)
    try:
        if spec["from_env"]:
            ps.init(**{"device": "cpu", **spec["init"]})
        else:
            init = dict(backend="cuda", device="cpu",
                        coordinator_uri=f"127.0.0.1:{port}",
                        num_processes=k, process_id=rank,
                        dist_backend="gloo")
            init.update(spec["init"])
            ps.init(**init)
    except ValueError as e:  # a refused topology is a result, too
        with open(out_file, "wb") as f:
            pickle.dump([{"init_error": str(e)}], f)
        return 0
    try:
        results = [CASES[name](rank, k, **kw) for name, kw in spec["cases"]]
    except Exception:
        traceback.print_exc()
        ps.shutdown(abort=True)
        return 1
    with open(out_file, "wb") as f:
        pickle.dump(results, f)
    if ps.is_initialized():  # a drill's case may have aborted the group
        ps.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
