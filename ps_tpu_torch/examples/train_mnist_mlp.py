"""MNIST 2-layer MLP via the local parameter server — the reference's
workload config 1 ("dense push/pull: 2-layer MLP on MNIST, single-process
local PS").

Counterpart of ``examples/train_mnist_mlp.py``, with the same flags and
defaults, plus ``--device``: the full per-key push/aggregate/apply/pull
protocol in one process. Each step every logical worker takes the
gradient of its own batch against the same pulled parameters and pushes
it; the server applies once all pushes are in; then the parameters are
pulled. ``--backend cuda`` runs the same protocol on the one-device
server (async, or sync with one worker). It prints the loss every 20
steps and, last, steps/s and the push+pull bytes and rate.
``--profile-dir`` traces the steps after two warm-up steps with
``torch.profiler`` (each step synchronised) and prints the kernels that
take the most device time and the device's busy share.

Run (on the GPU; ``--device cpu`` runs on the CPU):
    python -m ps_tpu_torch.examples.train_mnist_mlp --steps 200 --num-workers 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.synthetic import mnist_batches
from ps_tpu_torch.kv.store import value_and_grad
from ps_tpu_torch.models.mlp import MLP, make_loss_fn
from ps_tpu_torch.utils import trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "lamb"])
    ap.add_argument("--mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--backend", default="local", choices=["local", "cuda"],
                    help="'cuda' runs the same protocol on the one-device "
                         "server (async, or sync with one logical worker)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler trace dir")
    args = ap.parse_args(argv)

    if args.backend == "cuda" and args.mode == "sync" and args.num_workers > 1:
        raise SystemExit(
            "on the cuda backend the sync worker set is the one device; "
            "use --num-workers 1 or --mode async")
    ctx = ps.init(backend=args.backend, num_workers=args.num_workers,
                  mode=args.mode, seed=args.seed, device=args.device)
    model = MLP(hidden=args.hidden)
    params = model.init(torch.Generator().manual_seed(args.seed),
                        device=ctx.device)
    store = ps.KVStore(optimizer=args.optimizer, learning_rate=args.lr,
                       mode=args.mode)
    store.init(params)
    loss_fn = make_loss_fn(model)
    streams = [
        mnist_batches(args.batch_size, seed=args.seed, worker=w,
                      num_workers=args.num_workers, steps=args.steps)
        for w in range(args.num_workers)
    ]

    t0 = time.time()
    params = store.pull_all()
    first = last = None
    with trace(args.profile_dir, ctx.device, args.steps) as mark:
        for step in range(args.steps):
            losses = []
            # PS flow: every worker computes grads against the same pulled
            # version and pushes; the server applies once all pushes arrive
            for w, stream in enumerate(streams):
                batch = store.shard_batch(next(stream))
                loss, grads, _ = value_and_grad(loss_fn, params, batch)
                losses.append(loss)
                store.push_all(grads, worker=w)
            params = store.pull_all()
            mark()
            if step % 20 == 0 or step == args.steps - 1:
                last = float(np.mean([float(x) for x in losses]))
                first = last if first is None else first
                print(f"step {step:4d}  loss {last:.4f}")
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        dt = max(time.time() - t0, 1e-9)
    gb = (store.bytes_pushed + store.bytes_pulled) / 1e9
    rate = (f"{args.steps/dt:.1f} steps/s, push+pull {gb:.3f} GB, "
            f"{gb/dt:.3f} GB/s" if args.steps else "no steps")
    print(f"done: {args.steps} steps in {dt:.1f}s  ({rate})")
    ps.shutdown()
    return {"first_loss": first, "last_loss": last,
            "steps_per_sec": args.steps / dt, "push_pull_gb": gb}


if __name__ == "__main__":
    main()
