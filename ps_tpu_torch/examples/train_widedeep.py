"""Wide-&-Deep on Criteo-like data — the sparse push/pull workload.

Counterpart of ``examples/train_widedeep.py``: the composite step
(ps_tpu_torch/train.py) — row gather, dense gradient and server-side
Adam, and each embedding table's sparse apply: a grouping pass and one
apply, hand-written kernels on the card. It prints the loss every 10
steps, the examples per second and, with ``--exchange a2a``, the rows the
capacity-bounded exchange dropped. ``--profile-dir`` traces the steps
after two warm-up steps with ``torch.profiler`` (each step synchronised),
writes ``trace.json`` there and prints the kernels that take the most
device time, the device time a step and the device's busy share of the
traced steps.

Run (on the GPU; ``--device cpu`` runs the plain versions on the CPU):
    python -m ps_tpu_torch.examples.train_widedeep --steps 30

``--data DIR`` reads a column-npy dataset (fields ``dense``, ``sparse``,
``label``; ``ps_tpu_torch.data.files.write_dataset``) instead of the
synthetic generator, reshuffled every epoch from ``--seed``.

As k processes, one a rank, from the reference's variables (each rank
draws the same global batches and trains on its slice; the tables are
row-sharded over the ranks):
    PS_COORDINATOR_URI=host:port PS_NUM_PROCESSES=k PS_PROCESS_ID=r \
        python -m ps_tpu_torch.examples.train_widedeep
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.files import file_batches
from ps_tpu_torch.data.synthetic import criteo_batches
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.kv.store import rank_slice
from ps_tpu_torch.models.wide_deep import (
    WideDeep, WideDeepConfig, make_ids_fn, make_wide_deep_loss_fn,
)
from ps_tpu_torch.train import make_composite_step
from ps_tpu_torch.utils import trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=512, help="global batch")
    ap.add_argument("--vocab", type=int, default=100_000, help="rows per feature")
    ap.add_argument("--embed-dim", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--embed-lr", type=float, default=0.05)
    ap.add_argument("--embed-optimizer", default="adagrad",
                    choices=["sgd", "adagrad", "adam"])
    ap.add_argument("--exchange", default="gather", choices=["gather", "a2a"])
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="column-npy dataset directory (fields dense, "
                         "sparse, label — see ps_tpu_torch.data.files."
                         "write_dataset); default: synthetic generator")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args(argv)

    if args.steps < (3 if args.profile_dir else 2):
        raise SystemExit("--steps must be >= 2 (step 0 is warm-up), and "
                         ">= 3 with --profile-dir")
    ctx = ps.init(backend="cuda", device=args.device)
    device = ctx.device

    cfg = WideDeepConfig(per_feature_vocab=args.vocab, embed_dim=args.embed_dim)
    model = WideDeep(cfg, generator=torch.Generator().manual_seed(args.seed))
    dense = ps.KVStore(optimizer="adam", learning_rate=args.lr,
                       placement="sharded")
    dense.init(model.param_tree())
    deep = SparseEmbedding(cfg.total_rows, cfg.embed_dim,
                           optimizer=args.embed_optimizer,
                           learning_rate=args.embed_lr,
                           exchange=args.exchange,
                           capacity_factor=args.capacity_factor)
    deep.init(torch.Generator(device).manual_seed(args.seed + 1), scale=0.01)
    wide = SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                           learning_rate=args.embed_lr,
                           exchange=args.exchange,
                           capacity_factor=args.capacity_factor)
    wide.init(torch.Generator(device).manual_seed(args.seed + 2), scale=0.01)

    ndense = sum(p.numel() for p in model.parameters())
    print(f"Wide&Deep: {ndense/1e6:.2f}M dense params + "
          f"{cfg.total_rows * (cfg.embed_dim + 1) / 1e6:.1f}M embedding "
          f"rows x dims, device {device}, rank {ctx.mesh.rank} of "
          f"{ctx.mesh.size}, global batch {args.batch_size}, "
          f"sparse apply tier {deep.fused_tier}, exchange={args.exchange}")

    run = make_composite_step(
        dense, {"deep": deep, "wide": wide},
        make_wide_deep_loss_fn(model), make_ids_fn(cfg),
    )
    log = open(args.jsonl, "w") if args.jsonl else None
    if args.data:
        stream = file_batches(args.data, args.batch_size, steps=args.steps,
                              shuffle=True, seed=args.seed,
                              fields=("dense", "sparse", "label"))
    else:
        stream = criteo_batches(args.batch_size,
                                vocab_size=cfg.per_feature_vocab,
                                seed=args.seed, steps=args.steps)
    t0 = None
    with trace(args.profile_dir, device, args.steps) as mark:
        for step, batch in enumerate(stream):
            loss, _ = run(dense.shard_batch(rank_slice(batch, ctx.mesh)))
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
    ex_s = (args.steps - 1) * args.batch_size / secs
    print(f"done: {ex_s:.1f} ex/s on {device} "
          f"({secs / (args.steps - 1) * 1e3:.2f} ms/step after warm-up), "
          f"sparse row traffic "
          f"{(deep.bytes_pushed + deep.bytes_pulled + wide.bytes_pushed + wide.bytes_pulled) / 1e9:.3f} GB "
          f"(+{(deep.collective_bytes + wide.collective_bytes) / 1e9:.3f} GB "
          f"a rank of collectives)")
    for name, emb in (("deep", deep), ("wide", wide)):
        if emb.exchange == "a2a":
            print(f"  {name}: a2a dropped {emb.dropped_rows} of "
                  f"{emb.rows_pushed} rows "
                  f"({100 * emb.dropped_fraction:.3f}%) — raise "
                  f"--capacity-factor if this is not ~0")
    if log:
        log.close()
    ps.shutdown()
    return ex_s


if __name__ == "__main__":
    main()
