"""Multi-process checkpoints and the elastic restore across gloo ranks on
the CPU (the elastic and multi-process cases of
``tests/test_checkpoint.py``).

The reference trains on an N-device mesh, saves, and resumes on an
M-device one: (8, 4) and (4, 8) there, (4, 2) and (2, 4) ranks here. A
restore onto another world size takes ``elastic=True`` (the port refuses
it otherwise) and is bitwise: parameters, every rank's slice of the adam
state under the new layout and a sparse table re-padded for the new rank
count. Continued steps equal an uninterrupted run within rtol 1e-6 /
atol 1e-7 (the reductions sum over another rank count). Also: a crash
between the arrays and the meta at 2 ranks leaves the previous
generation valid, and a checkpoint the reference wrote on a 4-device
mesh, converted by ``from_reference``, restores into 2 ranks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ps_tpu
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
from ps_tpu.models.mlp import MLP, cross_entropy_loss
from ps_tpu_torch import checkpoint as ckpt

TOL = {"rtol": 1e-6, "atol": 1e-7}
HIDDEN = 16
TABLE = np.random.default_rng(3).normal(size=(30, 4)).astype(np.float32)


def _model_params():
    model = MLP(hidden=HIDDEN)
    params = model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def _batches():
    return list(mnist_batches(16, seed=0, steps=4))


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The reference's drill both ways: (4, 2) and (2, 4) ranks."""
    return {(a, b): _drill(tmp_path_factory.mktemp(f"drill{a}{b}"), a, b)
            for a, b in ((4, 2), (2, 4))}


def _drill(tmp_path, from_k, to_k):
    _, params = _model_params()
    path = str(tmp_path / "ckpt")
    common = dict(params=params, batches=_batches(), path=path,
                  hidden=HIDDEN, table=TABLE)
    first = torch_ranks.run_ranks(from_k, [
        ("ckpt", dict(common, steps=4)),
        ("ckpt", dict(common, steps=2, save=True))], tmp_path)
    second = torch_ranks.run_ranks(to_k, [
        ("ckpt", dict(common, steps=2, restore="strict")),
        ("ckpt", dict(common, steps=2, restore="elastic"))], tmp_path)
    return first, second


def _whole(states, dims, leaf):
    """One state leaf over the ranks of a group, joined along its dim."""
    d = dims[int(leaf)]
    parts = [s[leaf] for s in states]
    return parts[0] if d is None else np.concatenate(parts, axis=d)


@pytest.mark.parametrize("from_k,to_k", [(4, 2), (2, 4)])
def test_elastic_restore_bit_identical(drills, from_k, to_k):
    first, second = drills[(from_k, to_k)]
    straight = first[0][0]
    saved = first[0][1]
    assert saved["meta"]["world_size"] == from_k
    for r in second:
        assert "elastic=True" in r[0]["refused"]  # strict across sizes
        resumed = r[1]
        for key, want in saved["saved"].items():
            np.testing.assert_array_equal(resumed["restored"][key], want)
        np.testing.assert_array_equal(resumed["restored_table"],
                                      saved["table"])
        assert resumed["step"] == 4
        for key, want in straight["params"].items():
            np.testing.assert_allclose(resumed["params"][key], want, **TOL)
        np.testing.assert_allclose(resumed["table"], straight["table"],
                                   **TOL)
    # the adam state: each new rank's slices are the saved state's
    dims_old = [x[1] for x in first]
    for leaf in dims_old[0]["state"]:
        whole = _whole([x["state"] for x in dims_old],
                       dims_old[0]["state_dims"], leaf)
        new = [x[1] for x in second]
        d = new[0]["state_dims"][int(leaf)]
        got = (new[0]["restored_state"][leaf] if d is None else
               np.concatenate([x["restored_state"][leaf] for x in new],
                              axis=d))
        np.testing.assert_array_equal(got, whole)


def test_multi_rank_save_writes_every_rank_into_one_generation(drills):
    first, _ = drills[(2, 4)]
    saved = first[0][1]
    assert saved["files"] == ["arrays.00000.pt", "arrays.00001.pt"]
    meta = saved["meta"]
    assert meta["world_size"] == 2 and meta["placement"] == "sharded"
    assert meta["shard_dims"]["params/dense1/kernel"] == 0
    path = os.path.dirname(saved["meta_path"])
    dirs = [d for d in os.listdir(path) if d.startswith("arrays-")]
    assert dirs == [meta["arrays_dir"]]
    table_meta = ckpt.read_meta(path + "-table")
    assert table_meta["padded_rows"] == 30 and table_meta["world_size"] == 2


def test_crash_between_arrays_and_meta_keeps_the_previous_generation(
        tmp_path):
    """Two ranks save twice; the second save's arrays land and rank 0
    never commits: the meta still names the first generation, and a
    restore reads it."""
    _, params = _model_params()
    path = str(tmp_path / "ckpt")
    out = torch_ranks.run_ranks(2, [("ckpt", dict(
        params=params, batches=_batches(), path=path, steps=2, save=True,
        crash=True))], tmp_path)
    for r in out:
        r = r[0]
        assert r["after_crash_meta"]["generation"] == r["meta"][
            "generation"] == 0
        assert r["dirs"] == ["arrays-00000000", "arrays-00000001"]
        for key, want in r["saved"].items():
            np.testing.assert_array_equal(r["after_crash"][key], want)


def _ref_loss(model):
    def loss_fn(p, batch):
        images, labels = batch
        return cross_entropy_loss(model.apply({"params": p}, images), labels)
    return loss_fn


def test_from_reference_of_a_4_device_checkpoint_restores_into_2_ranks(
        tmp_path):
    model, params = _model_params()
    batches = _batches()
    ref_path = str(tmp_path / "ref")

    def ref_store():
        ps_tpu.init(backend="tpu", mesh_shape={"data": 4})
        store = ps_tpu.KVStore(optimizer="adam", learning_rate=1e-3,
                               placement="sharded")
        store.init(params)
        return store, store.make_step(_ref_loss(model))

    def feed(store, run, bs):
        out = None
        for images, labels in bs:
            _, out = run(store.shard_batch((jnp.asarray(images),
                                            jnp.asarray(labels))))
        return out

    try:
        store, run = ref_store()
        feed(store, run, batches[:2])
        store.save(ref_path)
        meta = ps_tpu.checkpoint.read_meta(ref_path)
        abstract = store._engine.abstract_state_dict(meta)
        abstract["worker_cache"] = {}
        arrays = jax.tree_util.tree_map(
            np.asarray, ps_tpu.checkpoint.restore(ref_path, abstract, meta))
        saved, _ = ref_flatten(jax.tree_util.tree_map(np.asarray,
                                                      store.params()))
    finally:
        ps_tpu.shutdown()
    try:
        store, run = ref_store()
        store.restore(ref_path)
        want, _ = ref_flatten(feed(store, run, batches[2:]))
    finally:
        ps_tpu.shutdown()
    port = str(tmp_path / "port")
    port_meta = ckpt.from_reference(arrays, meta, port)
    assert port_meta["engine"] == "cuda_sync"
    out = torch_ranks.run_ranks(2, [("ckpt", dict(
        params=params, batches=batches, path=port, steps=2,
        restore="elastic", hidden=HIDDEN))], tmp_path)
    for r in out:
        r = r[0]
        for key, w in saved.items():
            np.testing.assert_array_equal(r["restored"][key], w)
        assert r["step"] == 4
        for key, w in want.items():
            np.testing.assert_allclose(r["params"][key], np.asarray(w),
                                       **TOL)
