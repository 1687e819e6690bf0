"""Async-SGD MNIST — the reference's workload config 5, in one process.

Counterpart of the single-process form of ``examples/train_mnist_async.py``:
the server applies every arriving gradient at once with the DC-ASGD
correction, and each worker computes against whatever (stale) parameters
it last pulled. The workers are driven round-robin from one host, so each
re-pulls only on its own turn and staleness accrues. It logs the loss,
the worker and its staleness every 10 cycles, and last the server's
version, the staleness histogram and the cycle rate. ``--profile-dir``
traces the cycles after two warm-up cycles with ``torch.profiler`` and
prints the kernels that take the most device time and the device's busy
share.

The reference's cross-process roles (``--role server|worker`` over the
native van) are not ported yet (ROADMAP Queue 1 item 5).

Run (on the GPU; ``--device cpu`` runs on the CPU):
    python -m ps_tpu_torch.examples.train_mnist_async --steps 60 --num-workers 3
"""

from __future__ import annotations

import argparse
import time

import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.synthetic import mnist_batches
from ps_tpu_torch.models.mlp import MLP, make_loss_fn
from ps_tpu_torch.utils import StepLogger, trace


def build(seed: int, device):
    """The reference trainer's model: the MLP at hidden 32, from ``seed``."""
    model = MLP(hidden=32)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    return params, make_loss_fn(model)


def main(argv=None):
    cfg = ps.Config.from_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default=cfg.role or "single",
                    choices=["single", "server", "worker"])
    ap.add_argument("--steps", type=int, default=60,
                    help="worker cycles, round-robin over the workers")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-workers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--dc-lambda", type=float, default=0.04)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler trace dir")
    args = ap.parse_args(argv)
    if args.role != "single":
        raise NotImplementedError(
            f"--role {args.role}: the cross-process async roles need the van "
            f"plane, which is not ported yet (ROADMAP Queue 1 item 5)")

    ctx = ps.init(backend="cuda", mode="async", num_workers=args.num_workers,
                  dc_lambda=args.dc_lambda, device=args.device)
    params, loss_fn = build(args.seed, ctx.device)
    store = ps.KVStore(optimizer="sgd", learning_rate=args.lr, mode="async")
    store.init(params)
    run = store.make_async_step(loss_fn)
    log = StepLogger(every=10)
    streams = [
        mnist_batches(args.batch_size, seed=args.seed, worker=w,
                      num_workers=args.num_workers)
        for w in range(args.num_workers)
    ]
    losses = []
    t0 = time.perf_counter()
    with trace(args.profile_dir, ctx.device, args.steps) as mark:
        for step in range(args.steps):
            w = step % args.num_workers
            loss = run(store.shard_batch(next(streams[w])), worker=w)
            mark()
            losses.append(loss)
            if log.wants(step):
                log.log(step, loss=float(loss), worker=w,
                        staleness=store.staleness(w))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        dt = max(time.perf_counter() - t0, 1e-9)
    hist = store.staleness_histogram
    version = store._engine.version
    print(f"done: version {version}, "
          f"staleness histogram {dict(sorted(hist.items()))}; "
          f"{args.steps} cycles in {dt:.2f}s ({args.steps / dt:.1f} cycles/s)")
    ps.shutdown()
    return {"losses": [float(x) for x in losses], "version": version,
            "staleness_histogram": hist, "cycles_per_sec": args.steps / dt}


if __name__ == "__main__":
    main()
