"""ResNet-50 / ImageNet, sync data-parallel — the reference's workload
config 2 and its headline benchmark.

Counterpart of ``examples/train_resnet50.py``, with the same flags and
defaults: ``KVStore(optimizer='momentum').make_step`` over
:class:`~ps_tpu_torch.models.resnet.ResNet` (v1.5, bf16 compute over f32
parameters) — the label-smoothed loss's gradient, then momentum SGD applied
by the server in place, with the BatchNorm statistics threaded through the
step as aux state. It takes its topology from the environment as the
reference's trainer does: one process, or k ranks (``PS_COORDINATOR_URI``,
``PS_NUM_PROCESSES``, ``PS_PROCESS_ID``), each drawing the same global
batches and training on its slice, with BatchNorm over the global batch
and ``placement='sharded'`` ZeRO-1 across the ranks (the same as
``'replicated'`` at one, where no collective moves a byte).

The input overlaps the steps: the generator (or the memory-mapped file read
of ``--data``) runs in a producer thread, and each batch is copied to the
card on a side stream from pinned memory while the step before it runs.
The output says how long the steps waited for their input. It prints the
loss every 10 steps and, last, images/s total and per chip and the
collective bytes. ``--profile-dir`` traces the steps after two warm-up
steps with ``torch.profiler`` (each step synchronised), writes
``trace.json`` there and prints the kernels that take the most device time
and the device's busy share.

Run (on the GPU; ``--device cpu`` runs on the CPU):
    python -m ps_tpu_torch.examples.train_resnet50 --steps 30
"""

from __future__ import annotations

import argparse
import math
import time

import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.prefetch import device_prefetch, threaded_source
from ps_tpu_torch.data.synthetic import imagenet_batches
from ps_tpu_torch.kv.store import rank_slice
from ps_tpu_torch.models.resnet import ResNet50, make_loss_fn
from ps_tpu_torch.utils import StepLogger, TrainMetrics, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=256, help="global batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--placement", default="sharded",
                    choices=["replicated", "sharded"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="column-npy dataset directory (fields images, "
                         "labels — see ps_tpu_torch.data.files."
                         "write_dataset); default: synthetic generator")
    ap.add_argument("--jsonl", default=None, help="append per-step records here")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler trace dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.steps < (3 if args.profile_dir else 2):
        raise SystemExit("--steps must be >= 2 (step 0 is warm-up), and "
                         ">= 3 with --profile-dir")
    ctx = ps.init(backend="cuda", device=args.device)
    device = ctx.device
    ndev = ctx.num_workers
    if args.batch_size % ndev:
        raise SystemExit(
            f"--batch-size must be divisible by the device count ({ndev})")

    model = ResNet50(dtype=getattr(torch, args.dtype))
    params, model_state = model.init(
        torch.Generator().manual_seed(args.seed), device=device)
    store = ps.KVStore(optimizer="momentum", learning_rate=args.lr,
                       momentum=args.momentum, placement=args.placement)
    store.init(params)
    nparams = sum(math.prod(s) for s in model.shapes()[0].values())
    print(f"ResNet-50: {nparams / 1e6:.1f}M params, {ndev} device(s) "
          f"({device}, rank {ctx.mesh.rank}), global batch {args.batch_size}, "
          f"{args.image_size}x{args.image_size}, {args.dtype}, momentum "
          f"placement={args.placement}")

    run = store.make_step(
        make_loss_fn(model, label_smoothing=args.label_smoothing,
                     mesh=store.mesh),
        has_aux=True)
    if args.data:
        from ps_tpu_torch.data.files import file_batches

        source = file_batches(args.data, args.batch_size, steps=args.steps,
                              shuffle=True, seed=args.seed,
                              as_tuple=("images", "labels"))
    else:
        source = imagenet_batches(args.batch_size, image_size=args.image_size,
                                  seed=args.seed, steps=args.steps)
    source = (rank_slice(b, ctx.mesh) for b in source)
    # the default placement: at one device shard_batch's, but from pinned
    # memory and without blocking the host
    stream = iter(device_prefetch(threaded_source(source)))

    metrics = TrainMetrics(store, batch_size=args.batch_size, num_chips=ndev)
    log = StepLogger(every=10, jsonl=args.jsonl)
    waited = 0.0  # host seconds the steps after warm-up waited for input
    with trace(args.profile_dir, device, args.steps) as mark:
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = next(stream)
            if step:
                waited += time.perf_counter() - t0
            loss, _, model_state = run(batch, model_state)
            mark()  # step 0's mark starts the profiler, before the clock
            if step == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                metrics.mark_compiled()  # exclude warm-up from rates
            else:
                metrics.step(loss)
            if log.wants(step):
                log.log(step, loss=float(loss))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        s = metrics.summary()
    log.close()
    ps.shutdown()
    print(f"input: the steps after warm-up waited {waited * 1e3:.1f} ms for "
          f"their batches ({100 * waited / max(s['wall_s'], 1e-9):.1f}% of "
          f"{s['wall_s'] * 1e3:.1f} ms)")
    print(f"done: {s['examples_per_sec']:.1f} imgs/s total, "
          f"{s['examples_per_sec_per_chip']:.1f} imgs/s/chip, "
          f"collective bytes {s['collective_gb_per_device']:.2f} GB "
          f"({s['collective_gbps_per_device']:.2f} GB/s/device)")
    return s


if __name__ == "__main__":
    main()
