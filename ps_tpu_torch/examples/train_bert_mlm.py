"""BERT MLM with server-side LAMB — the reference's workload config 3.

Counterpart of ``examples/train_bert_mlm.py``: ``KVStore(optimizer=
'lamb').make_step`` over ``BertMLM`` — the MLM loss's gradient, then LAMB
applied by the server in place — on one device or across the ranks of a
process group (``PS_COORDINATOR_URI``, ``PS_NUM_PROCESSES``,
``PS_PROCESS_ID``, ``PS_DIST_BACKEND``), each rank on its slice of the
same global batches, with LAMB ZeRO-1 sharded at the default
``--placement sharded`` (its trust ratio's norms reduced over the ranks).
``--model-axis m`` adds Megatron tensor parallelism: the mesh is
``{data: world/m, model: m}``, the store places the Megatron leaves by
``bert_partition_rules`` and each rank runs its ``h/m`` heads and its
slice of the feed-forward. ``--attn flash`` runs
the attention forward through the hand-written CUDA kernel on the card.
It prints the loss every 10 steps and, last, sequences and tokens per
second. ``--profile-dir`` traces the steps after two warm-up steps with
``torch.profiler`` (each step synchronised), writes ``trace.json`` there
and prints the ops that take the most device time and the device's busy
share of the traced steps.

Run (on the GPU; ``--device cpu`` runs the plain versions on the CPU):
    python -m ps_tpu_torch.examples.train_bert_mlm --attn flash --seq-len 512 --steps 20

Two ranks on the CPU, one shell each (r = 0, 1; add ``--model-axis 2``
for two tensor-parallel ranks):
    PS_COORDINATOR_URI=127.0.0.1:29500 PS_NUM_PROCESSES=2 PS_PROCESS_ID=r \
        PS_DIST_BACKEND=gloo python -m ps_tpu_torch.examples.train_bert_mlm \
        --device cpu --size tiny --steps 3 --seq-len 32 --batch-size 8 \
        --dtype float32
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.synthetic import mlm_batches
from ps_tpu_torch.kv.store import rank_slice
from ps_tpu_torch.models.bert import (BertConfig, BertMLM,
                                      bert_partition_rules, make_mlm_loss_fn)
from ps_tpu_torch.utils import trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32, help="global batch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--size", default="base", choices=["base", "tiny"])
    ap.add_argument("--placement", default="sharded",
                    choices=["replicated", "sharded"])
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel width: Megatron placement via "
                         "bert_partition_rules over a 'model' mesh axis")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--attn", default="full", choices=["full", "flash"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args(argv)

    if args.steps < (3 if args.profile_dir else 2):
        raise SystemExit("--steps must be >= 2 (step 0 is warm-up), and "
                         ">= 3 with --profile-dir")
    tp = args.model_axis
    world = ps.Config.from_env(device=args.device).num_processes
    if tp > 1:
        if world % tp:
            raise SystemExit(f"--model-axis {tp} must divide the device "
                             f"count ({world})")
        ctx = ps.init(backend="cuda", device=args.device,
                      mesh_shape={"data": world // tp, "model": tp})
    else:
        ctx = ps.init(backend="cuda", device=args.device)
    device = ctx.device
    if args.batch_size % ctx.num_workers:
        raise SystemExit(f"--batch-size must be divisible by the data-axis "
                         f"size ({ctx.num_workers})")

    dtype = getattr(torch, args.dtype)
    cfg = (BertConfig(dtype=dtype, attn=args.attn) if args.size == "base"
           else BertConfig.tiny(dtype=dtype, attn=args.attn))
    model = BertMLM(cfg, generator=torch.Generator().manual_seed(args.seed))
    store = ps.KVStore(optimizer="lamb", learning_rate=args.lr,
                       weight_decay=args.weight_decay,
                       placement=args.placement,
                       partition_rules=bert_partition_rules() if tp > 1
                       else None)
    store.init(model.param_tree())
    nparams = sum(p.numel() for p in model.parameters())
    print(f"BERT-{args.size} MLM: {nparams / 1e6:.1f}M params, device "
          f"{device} (mesh {ctx.mesh.shape} at {ctx.mesh.coords}), global "
          f"batch {args.batch_size} x seq {args.seq_len}, attn {args.attn}, "
          f"{args.dtype}, LAMB placement={args.placement}")

    run = store.make_step(make_mlm_loss_fn(model, mesh=store.mesh))
    log = open(args.jsonl, "w") if args.jsonl else None
    t0 = None
    with trace(args.profile_dir, device, args.steps) as mark:
        for step, batch in enumerate(mlm_batches(
                args.batch_size, args.seq_len, vocab_size=cfg.vocab_size,
                seed=args.seed, steps=args.steps)):
            loss, _ = run(store.shard_batch(rank_slice(batch, ctx.mesh)))
            mark()  # step 0's mark starts the profiler, before the clock
            if step == 0:  # warm-up: kernel build, allocator, first launches
                _sync(device)
                t0 = time.perf_counter()
            if step % 10 == 0 or step == args.steps - 1:
                value = float(loss)
                print(f"step {step:4d}  loss {value:.4f}")
                if log:
                    log.write(json.dumps({"step": step, "loss": value})
                              + "\n")
        _sync(device)
        secs = time.perf_counter() - t0
    seq_s = (args.steps - 1) * args.batch_size / secs
    print(f"done: {seq_s:.1f} seq/s, {seq_s * args.seq_len:.0f} tokens/s on "
          f"{device} ({secs / (args.steps - 1) * 1e3:.2f} ms/step after "
          f"warm-up)")
    if log:
        log.close()
    ps.shutdown()
    return seq_s


if __name__ == "__main__":
    main()
