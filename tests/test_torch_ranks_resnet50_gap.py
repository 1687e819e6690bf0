"""How far ResNet-50's f32 momentum step across two ranks lands from one
process's, in the reference and in the port, at one shape and seed.

The reference takes the step on its 1-device and on its 2-device mesh
(GSPMD BatchNorm over the global batch); the port in one process and on
2 gloo ranks (cross-rank BatchNorm, ``models/resnet.py``
``_BatchNormTrain``). Both from the same flax init, on the same global
batch, cut from the published 224² and batch 256 to 64² and batch 8 for
the CPU. Each gap is the relative 2-norm of the difference of the two
updates ``p1 - p0`` over the leaves the step moves, as ``chip_smoke.py``
phase 15 reads it on the card, plus the loss's relative difference and
the worst ``batch_stats`` leaf's relative 2-norm; and the port's one
process against the reference's one device. A cross-rank BatchNorm that
summed its statistics wrongly would move the update by orders of
magnitude more than the reference's own gap (phase 15's local-BatchNorm
control: ~1e-1).

This file holds no test: the measurement takes about 45 s on 8 CPU
cores (the reference compiles ResNet-50 twice), too long for the suite.
Collecting it imports nothing beyond the standard library and numpy: the
imports it needs run only when it is run as a script, from the
repository's root:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/test_torch_ranks_resnet50_gap.py
"""

import os
import sys
import tempfile

import numpy as np

SIZE, BATCH, K = 64, 8, 2


def _flat(tree):
    return {k: np.asarray(v) for k, v in ref_flatten(tree)[0].items()}


def _to_port(flat):
    """flax layouts -> the port's (HWIO -> OIHW, head [in, out] -> [out,
    in])."""
    return {k: (v.transpose(3, 2, 0, 1) if v.ndim == 4 else
                v.T if k == "head/kernel" else v) for k, v in flat.items()}


def _inputs():
    model = ref_resnet.ResNet50(dtype=jnp.float32)
    variables = jax.jit(lambda: model.init(
        jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False))()
    images, labels = next(imagenet_batches(BATCH, image_size=SIZE, seed=0))
    return model, _flat(variables["params"]), _flat(
        variables["batch_stats"]), variables, images, labels


def _reference(model, variables, images, labels, devices):
    ps_tpu.init(backend="tpu", mesh_shape={"data": devices})
    try:
        store = ps_tpu.KVStore(optimizer="momentum", learning_rate=0.1,
                               momentum=0.9, placement="sharded")
        store.init(variables["params"])
        loss, params, stats = store.make_step(
            ref_resnet.make_loss_fn(model, 0.1), has_aux=True)(
                store.shard_batch((jnp.asarray(images),
                                   jnp.asarray(labels))),
                variables["batch_stats"])
        return {"loss": float(loss), "params": _to_port(_flat(params)),
                "stats": _flat(stats)}
    finally:
        ps_tpu.shutdown()


def _gaps(two, one, start):
    moved = [k for k, v in one["params"].items() if np.any(v != start[k])]

    def update(run):
        return np.concatenate([(run["params"][k] - start[k]).ravel()
                               for k in moved])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    return {"update": rel(update(two), update(one)),
            "loss": abs(two["loss"] - one["loss"]) / abs(one["loss"]),
            "batch_stats": max(rel(two["stats"][k], v)
                               for k, v in one["stats"].items()),
            "moved": len(moved)}


def measure(tmp):
    model, params, stats, variables, images, labels = _inputs()
    ref = {d: _reference(model, variables, images, labels, d)
           for d in (1, K)}
    case = ("resnet_step", dict(params=params, stats=stats, images=images,
                                labels=labels, placement="sharded",
                                resnet50=True, label_smoothing=0.1))
    port = {1: torch_ranks.run_ranks(1, [case], tmp)[0][0],
            K: torch_ranks.run_ranks(K, [case], tmp)[0][0]}
    start = _to_port(params)
    return {"reference": _gaps(ref[K], ref[1], start),
            "port": _gaps(port[K], port[1], start),
            "port_vs_reference": _gaps(port[1], ref[1], start)}


if __name__ == "__main__":
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

    import jax
    import jax.numpy as jnp

    import ps_tpu
    import test_torch_ranks_harness as torch_ranks
    from ps_tpu.data.synthetic import imagenet_batches
    from ps_tpu.kv.keys import flatten_with_keys as ref_flatten
    from ps_tpu.models import resnet as ref_resnet

    with tempfile.TemporaryDirectory() as d:
        for name, g in measure(d).items():
            print(name, g)
