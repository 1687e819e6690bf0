"""Long-context causal LM over a dp×sp (×tp, or ×pp) mesh.

Counterpart of ``examples/train_longctx_lm.py``: a causal transformer
(``models/lm.py``) whose activations are split along a 'seq' mesh axis,
ring (or Ulysses) attention mixing the blocks, trained by the PS step
(the gradient, its reduction, Adam applied by the server, ZeRO-1
'sharded'). A 'model' axis adds Megatron tensor parallelism through
``lm_partition_rules``; a 'pipe' axis with ``--microbatches`` runs the
transformer trunk as a GPipe pipeline (embed and readout stay
data-parallel). It prints the loss every 5 steps and, last, a ``done:``
line with steps/s and the final loss.

One rank a process, ``prod(mesh)`` processes (``PS_COORDINATOR_URI``,
``PS_NUM_PROCESSES``, ``PS_PROCESS_ID``, ``PS_DIST_BACKEND``); ranks
sharing one card name ``--device cuda:0`` and ``PS_DIST_BACKEND=gloo``.
Two ranks on the CPU, one shell each (r = 0, 1):
    PS_COORDINATOR_URI=127.0.0.1:29500 PS_NUM_PROCESSES=2 PS_PROCESS_ID=r \\
        PS_DIST_BACKEND=gloo python -m ps_tpu_torch.examples.train_longctx_lm \\
        --device cpu --mesh data=1,seq=2 --attn ring --steps 6
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.prefetch import device_prefetch, threaded_source
from ps_tpu_torch.kv.store import rank_slice
from ps_tpu_torch.models import lm
from ps_tpu_torch.parallel.mesh import parse_mesh


def _refuse(args, mesh_shape):
    """The reference trainer's refusals (SystemExit), before any init."""
    if "data" not in mesh_shape:
        raise SystemExit("--mesh needs a 'data' axis (the PS worker/server "
                         "axis), e.g. data=1,seq=8 for pure sequence "
                         "parallelism")
    sp = mesh_shape.get("seq", 1)
    pp = mesh_shape.get("pipe", 1)
    if args.attn != "full" and sp <= 1:
        raise SystemExit("--attn ring/ulysses needs a seq axis > 1")
    try:
        lm.check_attn(args.attn, sp)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.seq_len % max(sp, 1):
        raise SystemExit("--seq-len must be divisible by the seq axis")
    if (pp > 1) != (args.microbatches > 0):
        raise SystemExit("pipelining needs BOTH a pipe mesh axis and "
                         "--microbatches > 0")
    if pp > 1 and args.attn != "full":
        raise SystemExit("--microbatches composes with full attention "
                         "(ring/ulysses shard the sequence axis the "
                         "pipeline microbatches would re-shard)")
    if pp > 1 and mesh_shape.get("model", 1) > 1:
        raise SystemExit("pipe + model axes do not compose yet: the GPipe "
                         "trunk runs whole stages, so TP would be silently "
                         "dropped — use one or the other")
    if args.microbatches > 0 and args.batch_size % args.microbatches:
        raise SystemExit("--batch-size must be divisible by --microbatches")
    if pp > 1 and args.n_layers % pp:
        raise SystemExit(f"--n-layers {args.n_layers} must divide into "
                         f"{pp} pipeline stages")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8, help="global batch")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="data=2,seq=4",
                    help="e.g. data=2,seq=4, data=2,model=2,seq=2, or "
                         "data=2,pipe=4 with --microbatches")
    ap.add_argument("--attn", default="ring",
                    choices=["full", "ring", "ulysses"])
    ap.add_argument("--microbatches", type=int, default=0,
                    help="> 0 with a 'pipe' mesh axis: GPipe the "
                         "transformer trunk over it (heterogeneous "
                         "stages: embed/readout stay data-parallel); "
                         "n-layers must divide by the pipe size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (or cuda:<i> for ranks sharing a card) or "
                         "cpu")
    args = ap.parse_args(argv)

    mesh_shape = parse_mesh(args.mesh)
    _refuse(args, mesh_shape)
    world = ps.Config.from_env(device=args.device).num_processes
    if math.prod(mesh_shape.values()) != world:
        raise SystemExit(f"--mesh {args.mesh} needs "
                         f"{math.prod(mesh_shape.values())} ranks; this run "
                         f"has {world} (PS_NUM_PROCESSES)")
    ctx = ps.init(backend="cuda", device=args.device, mesh_shape=mesh_shape)
    mesh, device = ctx.mesh, ctx.device
    if args.batch_size % mesh.size:
        raise SystemExit(f"--batch-size must be divisible by the data axis "
                         f"({mesh.size})")
    pp = mesh.axis_size("pipe")

    params = lm.init_params(
        np.random.default_rng(args.seed), vocab=args.vocab,
        d_model=args.d_model, n_heads=args.n_heads, n_layers=args.n_layers,
        max_len=args.seq_len + 1)
    nparams = sum(int(np.prod(x.shape))
                  for x in ps.kv.keys.flatten_with_keys(params)[0].values())
    print(f"causal LM: {nparams / 1e6:.2f}M params, mesh {mesh.shape} "
          f"(this rank at {mesh.coords}), attn={args.attn}, "
          f"T={args.seq_len}, device {device}")

    rules = lm.lm_partition_rules() if mesh.axis_size("model") > 1 else None
    attn_fn = lm.make_attn_fn(args.attn, mesh=mesh)
    if pp > 1:
        params = lm.split_pipeline_params(params, num_stages=pp)
        rules = lm.pipeline_lm_partition_rules()
        loss_fn = lm.make_pipelined_loss_fn(
            n_heads=args.n_heads, num_stages=pp,
            microbatches=args.microbatches, mesh=mesh, attn_fn=attn_fn)
    else:
        loss_fn = lm.make_loss_fn(n_heads=args.n_heads, attn_fn=attn_fn,
                                  mesh=mesh)
    store = ps.KVStore(optimizer="adam", learning_rate=args.lr,
                       placement="sharded", partition_rules=rules)
    store.init(params)
    run = store.make_step(loss_fn)

    # generation in a producer thread, each rank's part of every global
    # batch (its data rows, its block of the sequence), double-buffered
    # onto the device
    source = (rank_slice(b, mesh) for b in lm.lm_batches(
        args.batch_size, args.seq_len, vocab=args.vocab, seed=args.seed,
        steps=args.steps))
    stream = device_prefetch(threaded_source(source))
    t0, loss = None, None
    for step, placed in enumerate(stream):
        loss, _ = run(placed)
        if step == 0:  # warm-up: kernel build, allocator, first launches
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    rate = (args.steps - 1) / secs if args.steps > 1 else float("nan")
    final = float(loss)
    print(f"done: {rate:.2f} steps/s, final loss {final:.6f}")
    ps.shutdown()
    return final


if __name__ == "__main__":
    main()
