"""Composite train step: dense KVStore + sparse embedding stores.

Counterpart of ``ps_tpu/train.py``. Each step gathers the embedding rows,
takes the gradient of the loss, applies the dense optimizer on the server
and pushes the row grads into each ``SparseEmbedding``, whose apply is a
grouping pass and one apply kernel per table on the card. Where the
reference compiles all of it into one donated XLA program, the port runs
it eagerly and updates parameters, tables and optimizer state in place.

Across ranks each rank passes its slice of the global batch: the dense
half goes through the server's reduction (``KVStore``), each table's
rows travel to and from their owners (``SparseEmbedding``'s exchange),
and every rank launches each table's kernels once a step on the rows it
owns. The loss returned is the global batch's.

Gradients w.r.t. embeddings are taken against the *gathered rows* (shape
[N, D]), made leaf tensors, never against the full table: that is the
sparse push payload, and the backward pass never builds a dense [V, D]
gradient.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.kv.store import KVStore, _nbytes, global_mean


def make_composite_step(
    dense_store: KVStore,
    emb_stores: Dict[str, SparseEmbedding],
    loss_fn: Callable,
    ids_fn: Callable,
    has_aux: bool = False,
):
    """Build ``run(batch, *extra)`` fusing dense + sparse PS updates.

    Args:
      dense_store: initialized KVStore (dense params).
      emb_stores: initialized SparseEmbedding stores by name.
      loss_fn: ``loss_fn(dense_params, rows, batch, *extra)`` where ``rows``
        is ``{name: table[ids]}`` with the shapes ``ids_fn`` produced;
        returns a scalar loss (or ``(loss, aux)`` with has_aux).
      ids_fn: ``ids_fn(batch) -> {name: int ids}`` (any shape; flattened
        for the push). Ids must be valid rows of the named table.

    Returns:
      ``run(batch, *extra) -> (loss, dense_params[, aux])``; the updated
      tables stay inside the stores (read via ``store.table``).
    """
    engine = dense_store._engine
    dense_store._require_init()
    treedef = dense_store._treedef
    key_order = list(dense_store._key_order)
    names = sorted(emb_stores)
    mesh = engine.mesh

    def run(batch, *extra):
        ids = ids_fn(batch)
        params_kv = engine.tree()
        leaves = {k: params_kv[k].detach().requires_grad_() for k in key_order}
        rows = {n: emb_stores[n].lookup(emb_stores[n].table, ids[n])
                .requires_grad_() for n in names}
        out = loss_fn(keymod.unflatten(treedef, leaves, key_order), rows,
                      batch, *extra)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(
            loss, [leaves[k] for k in key_order] + [rows[n] for n in names])
        gkv = dict(zip(key_order, grads[:len(key_order)]))
        grows = dict(zip(names, grads[len(key_order):]))
        with torch.no_grad():
            engine.step_(gkv)
            for n in names:
                store = emb_stores[n]
                g = grows[n].reshape(-1, store.dim)
                if mesh.size > 1:  # the global batch's mean, as the dense
                    g = g / mesh.size
                _, _, dropped = store.apply(store.table, store.state(),
                                            ids[n].reshape(-1), g)
                store.record_dropped(dropped)
            loss = global_mean(loss.detach(), mesh)
        nbytes = sum(_nbytes(v) for v in params_kv.values())
        dense_store.bytes_pushed += nbytes
        dense_store.bytes_pulled += nbytes
        dense_store.step += 1
        for n in names:
            store = emb_stores[n]
            n_ids = ids[n].numel() * store.k  # the global batch's ids
            row_bytes = n_ids * store.dim * store.table.element_size()
            store.bytes_pushed += row_bytes   # row grads out
            store.bytes_pulled += row_bytes   # gathered rows in
            store._account_push(n_ids)
            store.push_count += 1
        params = keymod.unflatten(treedef, params_kv, key_order)
        if has_aux:
            return loss, params, aux
        return loss, params

    return run
