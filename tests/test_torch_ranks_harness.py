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
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=wall_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {k} failed (rc "
                                 f"{p.returncode}):\n{log[-6000:]}")
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


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
               aggregate="mean"):
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.mlp import MLP

    model = MLP(hidden=hidden)
    store = ps.KVStore(optimizer=optimizer, placement=placement,
                       aggregate=aggregate, **opt_kw)
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


def case_async_refused(rank, k):
    import ps_tpu_torch as ps

    try:
        ps.KVStore(optimizer="sgd", mode="async")
    except NotImplementedError as e:
        return {"error": str(e)}
    return {"error": ""}


def case_lamb_sharded_refused(rank, k):
    import torch

    import ps_tpu_torch as ps

    store = ps.KVStore(optimizer="lamb", placement="sharded")
    try:
        store.init({"w": torch.zeros((4 * k, 2))})
    except NotImplementedError as e:
        return {"error": str(e)}
    return {"error": ""}


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


def case_resnet_step(rank, k, *, params, stats, images, labels, placement):
    """One momentum step of the tiny ResNet on this rank's slice."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.models import resnet

    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                          num_filters=8, num_classes=10, small_inputs=True,
                          dtype=torch.float32)
    p, s = model.params_from_jax(params, stats)
    store = ps.KVStore(optimizer="momentum", learning_rate=0.1,
                       momentum=0.9, placement=placement)
    store.init(p)
    run = store.make_step(resnet.make_loss_fn(model, mesh=store.mesh),
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


def case_bert_step(rank, k, *, params, batch):
    """One LAMB step of BERT-tiny, replicated, on this rank's slice."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.models import bert

    model = bert.BertMLM(bert.BertConfig.tiny(),
                         generator=torch.Generator().manual_seed(0))
    model.params_from_jax(params)
    store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                       weight_decay=0.01, placement="replicated")
    store.init(model.param_tree())
    loss, out = store.make_step(bert.make_mlm_loss_fn(model,
                                                      mesh=store.mesh))(
        store.shard_batch({key: _slice(v, rank, k)
                           for key, v in batch.items()}))
    return {"loss": float(loss), "params": _flat_np(out)}


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
            ps.init(device="cpu", **spec["init"])
        else:
            init = dict(coordinator_uri=f"127.0.0.1:{port}",
                        num_processes=k, process_id=rank,
                        dist_backend="gloo")
            init.update(spec["init"])
            ps.init(backend="cuda", device="cpu", **init)
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
    ps.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
