"""Async-SGD MNIST — the reference's workload config 5, in one process or
in its real deployment shape across processes.

Counterpart of ``examples/train_mnist_async.py``: the server applies every
arriving gradient at once with the DC-ASGD correction, and each worker
computes against whatever (stale) parameters it last pulled.

Single process (``--role single``, the default): the workers are driven
round-robin from one host, so each re-pulls only on its own turn and
staleness accrues. It logs the loss, the worker and its staleness every 10
cycles, and last the server's version, the staleness histogram and the
cycle rate. ``--profile-dir`` traces the cycles after two warm-up cycles
with ``torch.profiler``. The single role also runs across the ranks of a
process group (``PS_COORDINATOR_URI``, ``PS_NUM_PROCESSES``,
``PS_PROCESS_ID``, ``PS_DIST_BACKEND``), as the reference's runs on its
mesh: every rank drives the same cycles, each on its slice of a worker's
batch, and the server applies the mean gradient over the ranks:

    PS_COORDINATOR_URI=127.0.0.1:29500 PS_NUM_PROCESSES=2 PS_PROCESS_ID=r \
        PS_DIST_BACKEND=gloo python -m ps_tpu_torch.examples.train_mnist_async \
        --device cpu

Across processes, over the native van's TCP layer (server first):

    python -m ps_tpu_torch.examples.train_mnist_async --role server \\
        --port 7077 --num-workers 2
    python -m ps_tpu_torch.examples.train_mnist_async --role worker \\
        --server localhost:7077 --worker-id 0 --steps 30
    python -m ps_tpu_torch.examples.train_mnist_async --role worker \\
        --server localhost:7077 --worker-id 1 --steps 30

A key partition over N servers: start server s with ``--shard s
--num-shards N`` and give every worker ``--server h0:p0,h1:p1``. Workers
take ``--bucket-bytes`` (the bucketed transport), ``--pool`` (its
connections a server), ``--overlap`` (each cycle in the background) and
``--compress cast16|int8|topk`` with ``--compress-topk`` and
``--compress-min-bytes`` (the gradient codecs; ``PS_COMPRESS_PULL=1``
also compresses the bucketed pulls). The van's lanes follow the
environment: ``PS_VAN_NATIVE_LOOP=1`` serves through the native epoll
loop, ``PS_SHM=1`` has a worker offer the same-host shared-memory lane.
The server holds its parameters on ``--device`` and each worker takes its
gradients there; a server stops once every worker said goodbye. With
``--dump DIR`` the server writes its full event log, staleness histogram
and final parameters (``server<shard>.json``, ``server_params<shard>.pt``)
and each worker its losses and cycle times (``worker<id>.json``): the
event log, with each worker's gradients recomputed from what it pulled,
replays the run through one-process servers.

Replication and live failover (``replica/``): run a second server with
``--backup --watch-port W``, start the primary with ``--replicate-to
backup:port --beat backup:W`` (``--replica-ack sync|async``,
``--replica-window N``), and give the workers the replica set
``--server primary:port|backup:port``. A backup follows the primary's
stream until the primary's heartbeats stop, promotes itself (it prints the
cause and the time), then serves the workers, who re-route to it and
replay their in-flight push exactly once:

    python -m ps_tpu_torch.examples.train_mnist_async --role server \
        --port 7078 --num-workers 1 --backup --watch-port 7079
    python -m ps_tpu_torch.examples.train_mnist_async --role server \
        --port 7077 --num-workers 1 --replicate-to localhost:7078 \
        --beat localhost:7079
    python -m ps_tpu_torch.examples.train_mnist_async --role worker \
        --server "localhost:7077|localhost:7078" --worker-id 0
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
import numpy as np
import torch

import ps_tpu_torch as ps
from ps_tpu_torch.data.synthetic import mnist_batches
from ps_tpu_torch.kv.store import rank_slice, to_device
from ps_tpu_torch.models.mlp import MLP, make_loss_fn
from ps_tpu_torch.utils import StepLogger, TrainMetrics, trace


def build(seed: int, device):
    """The reference trainer's model: the MLP at hidden 32, from ``seed``."""
    model = MLP(hidden=32)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    return params, make_loss_fn(model)


def parse_args(argv=None):
    # env-var topology (PS_ROLE / DMLC_ROLE style) is the flag default
    cfg = ps.Config.from_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default=cfg.role or "single",
                    choices=["single", "server", "worker"])
    ap.add_argument("--steps", type=int, default=60,
                    help="single: cycles round-robin over the workers; "
                         "worker: this node's cycles")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-workers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--dc-lambda", type=float, default=0.04)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-dir", default=None,
                    help="single: torch.profiler trace dir")
    ap.add_argument("--jsonl", default=None,
                    help="single: append the logged cycles' records here")
    ap.add_argument("--dump", default=None,
                    help="server/worker: write the run's record here")
    # cross-process wiring
    ap.add_argument("--port", type=int, default=0, help="server listen port")
    ap.add_argument("--bind", default="127.0.0.1",
                    help="server listen address (0.0.0.0 explicitly for a "
                         "multi-host job; the endpoint is unauthenticated)")
    ap.add_argument("--server", default=cfg.server_uris,
                    help="worker: host:port, comma-separated for an "
                         "N-server partition (or env PS_SERVER_URIS / "
                         "PS_ASYNC_SERVER_URI)")
    ap.add_argument("--worker-id", type=int, default=cfg.worker_id)
    ap.add_argument("--bucket-bytes", type=int,
                    default=cfg.bucket_bytes or 0,
                    help="worker: fusion-bucket size of the bucketed "
                         "transport (0 = serial; env PS_BUCKET_BYTES)")
    ap.add_argument("--pool", type=int, default=cfg.transport_pool,
                    help="worker: connections a server for the bucketed "
                         "transport (env PS_TRANSPORT_POOL)")
    ap.add_argument("--overlap", action="store_true",
                    help="worker: run each cycle in the background "
                         "(needs --bucket-bytes)")
    ap.add_argument("--compress", default=cfg.compress or "none",
                    choices=["none", "cast16", "int8", "topk"],
                    help="worker: gradient codec for the wire (env "
                         "PS_COMPRESS); topk keeps --compress-topk of each "
                         "tensor with error-feedback residuals")
    ap.add_argument("--compress-topk", type=float, default=cfg.compress_topk,
                    help="worker: kept fraction for --compress topk (env "
                         "PS_COMPRESS_TOPK)")
    ap.add_argument("--compress-min-bytes", type=int,
                    default=cfg.compress_min_bytes,
                    help="worker: tensors under this size travel raw (env "
                         "PS_COMPRESS_MIN_BYTES)")
    ap.add_argument("--shard", type=int, default=cfg.shard,
                    help="server: this server's index in the key partition")
    ap.add_argument("--num-shards", type=int, default=cfg.num_shards,
                    help="server: servers in the key partition")
    # replication: a second server with --backup --watch-port W; the
    # primary with --replicate-to backup:port --beat backup:W; workers on
    # the replica set "primary:port|backup:port"
    ap.add_argument("--backup", action="store_true",
                    help="server: start as a backup: follow a primary's "
                         "replication stream, refuse workers until "
                         "promoted")
    ap.add_argument("--watch-port", type=int, default=0,
                    help="backup: the UDP heartbeat port the primary beats "
                         "(--beat); the backup promotes itself when the "
                         "beats stop (0 = no promotion watch)")
    ap.add_argument("--replicate-to", default=None,
                    help="primary: host:port of this shard's backup, "
                         "attached before workers are admitted")
    ap.add_argument("--replica-ack", default=cfg.replica_ack,
                    choices=["sync", "async"],
                    help="primary: sync = replies wait for the backup's ack "
                         "(a bitwise promotion); async = a lag bounded by "
                         "--replica-window (env PS_REPLICA_ACK)")
    ap.add_argument("--replica-window", type=int, default=cfg.replica_window,
                    help="primary: commits the backup may trail (env "
                         "PS_REPLICA_WINDOW)")
    ap.add_argument("--beat", default=None,
                    help="primary: host:port of the backup's promotion "
                         "watch to heartbeat")
    args = ap.parse_args(argv)
    args.compress_pull = cfg.compress_pull
    if args.backup and (args.replicate_to or args.beat):
        raise SystemExit("--backup takes --watch-port; --replicate-to and "
                         "--beat belong to the primary")
    if (args.backup or args.watch_port or args.replicate_to or args.beat) \
            and args.role != "server":
        raise SystemExit("the replication flags belong to --role server")
    return args


def run_worker(args):
    uri = args.server
    if not uri:
        raise SystemExit("worker needs --server host:port "
                         "(or PS_SERVER_URIS / PS_ASYNC_SERVER_URI)")
    params, loss_fn = build(args.seed, args.device)
    compress = None
    if args.compress != "none":
        compress = {"codec": args.compress, "topk": args.compress_topk,
                    "min_bytes": args.compress_min_bytes,
                    "pull": args.compress_pull}
    w = ps.connect_async(uri, args.worker_id, params,
                         bucket_bytes=args.bucket_bytes or None,
                         pool_size=args.pool if args.bucket_bytes else None,
                         compress=compress)
    # every op's latency as it was recorded, for the --dump record (the
    # transport itself keeps histograms)
    samples = collections.defaultdict(list)
    w.transport.listener = lambda key, v: samples[key].append(v)
    device = w.device  # params' device; a bare "cuda" is cuda:0
    run = w.make_async_step(loss_fn, overlap=args.overlap)
    log = StepLogger(every=10)
    # the wire bytes on the van's sockets: the reference's push/pull GB/s
    # in its physical form
    metrics = TrainMetrics(w, batch_size=args.batch_size, num_chips=1)
    stream = mnist_batches(args.batch_size, seed=args.seed,
                           worker=args.worker_id, num_workers=w.num_workers)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    losses, cycle_s = [], []
    # the window after the first cycle (connect, first pull, warm-up), on
    # the host's monotonic clock, which every process of the host shares
    t_after_first = None
    for step in range(args.steps):
        batch = to_device(next(stream), device)
        sync()
        t0 = time.perf_counter()
        loss = run(batch)
        sync()
        cycle_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if step == 0:
            metrics.mark_compiled()
            t_after_first = time.monotonic()
        else:
            metrics.step(loss)
        if log.wants(step):
            log.log(step, loss=float(loss), version=w.version)
    if args.overlap:
        w.flush()  # land the last background cycle before reporting
    t_end = time.monotonic()
    s = metrics.summary()
    van = w.transport.latency_quantiles()
    van_name = "cycle_s" if args.overlap else "push_pull_s"
    med = float(np.median(cycle_s[1:] or cycle_s))
    print(f"worker {args.worker_id}: done at server version {w.version}; "
          f"wire push {s['push_gb']:.4f} GB / pull {s['pull_gb']:.4f} GB "
          f"({s['push_pull_gbps']:.3f} GB/s); median cycle "
          f"{med * 1e3:.3f} ms ({van_name} p50 "
          f"{van[van_name]['p50'] * 1e3:.3f} ms)", flush=True)
    if "overlap_efficiency" in s:
        print(f"worker {args.worker_id}: overlap efficiency "
              f"{s['overlap_efficiency']:.2f}", flush=True)
    if "compress_ratio" in s:
        extra = (f", residual norm {s['residual_norm']:.4f}"
                 if "residual_norm" in s else "")
        print(f"worker {args.worker_id}: compression "
              f"{s['compress_ratio']:.2f}x raw/wire "
              f"({s['codec_s']:.2f}s in codecs{extra})", flush=True)
    record = {
        "worker": args.worker_id, "losses": [float(x) for x in losses],
        "cycle_s": cycle_s, "window": [t_after_first, t_end],
        "van": van, "versions": list(w.versions),
        "van_s": samples[van_name],
        "staging_s": w.transport.staging_s,
        "staging_bytes": w.transport.staging_bytes,
        "bytes": [w.bytes_pushed, w.bytes_pulled],
        "compress": w.compress,
        "lane": w.transport.lane(),
        "shm_frames": w.transport.shm_frames,
        "shm_spills": w.transport.shm_spill_frames,
        "failovers": w.transport.failovers,
        "failover_s": samples["failover_s"],
        "epochs": list(w._epochs),
        "summary": s,
    }
    w.close()
    if args.dump:
        with open(os.path.join(args.dump, f"worker{args.worker_id}.json"),
                  "w") as f:
            json.dump(record, f)
    return record


def run_server(args):
    ctx = ps.init(backend="cuda", mode="async", num_workers=args.num_workers,
                  dc_lambda=args.dc_lambda, device=args.device)
    params, _ = build(args.seed, ctx.device)
    store = ps.KVStore(optimizer="sgd", learning_rate=args.lr, mode="async")
    if args.num_shards is not None:
        store.init(ps.shard_tree(params, args.shard, args.num_shards))
    else:
        store.init(params)
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    engine = store._engine
    svc = AsyncPSService(store, port=args.port, bind=args.bind,
                         shard=args.shard, num_shards=args.num_shards,
                         record_full_history=bool(args.dump),
                         backup=args.backup)
    shard_note = ("" if args.num_shards is None
                  else f", shard {args.shard}/{args.num_shards}")
    serving = "native loop" if svc.native_loop else "thread per connection"
    watch = hb = None
    if args.backup:
        from ps_tpu_torch.replica import PromotionWatch

        if args.watch_port:
            watch = PromotionWatch(svc, primary_id=1, port=args.watch_port,
                                   bind=args.bind)
        print(f"async PS BACKUP on port {svc.port}{shard_note} — following "
              f"the primary (params on {ctx.device}; {serving})"
              + (f", promotion watch on :{watch.port}" if watch else ""),
              flush=True)
        while svc.role == "backup":  # until promoted
            time.sleep(0.01)
        detect = ("" if watch is None else
                  f", the primary's last beat {watch.detect_age_ms} ms "
                  f"before")
        print(f"promoted to primary (reason={svc.promote_reason}, epoch "
              f"{svc.epoch}, {svc._replica_applied_seq} replicated events, "
              f"promotion {svc.promotion_s * 1e3:.3f} ms{detect}) — now "
              f"serving workers", flush=True)
    else:
        if args.replicate_to:
            host, port = args.replicate_to.rsplit(":", 1)
            svc.attach_backup(host, int(port), ack=args.replica_ack,
                              window=args.replica_window)
        if args.beat:
            from ps_tpu_torch.control.heartbeat import HeartbeatClient

            host, port = args.beat.rsplit(":", 1)
            hb = HeartbeatClient(host, int(port), node_id=1)
        print(f"async PS server on port {svc.port} ({args.num_workers} "
              f"workers expected{shard_note}; params on {ctx.device}; "
              f"{serving})"
              + (f", replicating to {args.replicate_to} "
                 f"[{args.replica_ack}, window {args.replica_window}]"
                 if args.replicate_to else ""), flush=True)
    # quiesce on goodbyes: a worker says goodbye only after its last reply
    # arrived, so stop() cannot race a reply
    svc.wait_for_goodbyes(args.num_workers)
    hist = dict(sorted(engine.staleness_hist.items()))
    print(f"served {svc.apply_log.total} pushes, final version "
          f"{engine.version}, staleness histogram {hist}", flush=True)
    if args.dump:
        suffix = "" if args.shard is None else str(args.shard)
        torch.save({k: v.detach().cpu() for k, v in engine._params.items()},
                   os.path.join(args.dump, f"server_params{suffix}.pt"))
        with open(os.path.join(args.dump, f"server{suffix}.json"), "w") as f:
            json.dump({"event_log": svc.event_log,
                       "apply_log": svc.apply_log,
                       "keys": svc._key_order,
                       "staleness_hist": {str(t): n
                                          for t, n in hist.items()},
                       "version": engine.version,
                       "staging_s": svc.transport.staging_s,
                       "staging_bytes": svc.transport.staging_bytes,
                       "native_loop": svc.native_loop,
                       "admit": svc.admit_stats(),
                       "loop_pushes": svc.transport.loop_pushes,
                       "shm_frames": svc.transport.shm_frames,
                       "codec_bytes": [svc.transport.codec_raw_bytes,
                                       svc.transport.codec_enc_bytes],
                       "replica": dict(
                           svc.replica_state(),
                           repl_entries=svc.transport.repl_entries,
                           repl_bytes=svc.transport.repl_bytes,
                           detect_age_ms=(watch.detect_age_ms
                                          if watch else None))},
                      f)
    if watch is not None:
        watch.close()
    if hb is not None:
        hb.close(goodbye=True)  # a planned leave: the backup sees 'left'
    svc.stop()
    ps.shutdown()
    return {"version": engine.version, "staleness_histogram": hist}


def run_single(args):
    ctx = ps.init(backend="cuda", mode="async", num_workers=args.num_workers,
                  dc_lambda=args.dc_lambda, device=args.device)
    if args.batch_size % ctx.mesh.size:
        raise SystemExit(f"--batch-size must be divisible by the rank count "
                         f"({ctx.mesh.size})")
    params, loss_fn = build(args.seed, ctx.device)
    store = ps.KVStore(optimizer="sgd", learning_rate=args.lr, mode="async")
    store.init(params)
    if ctx.mesh.size > 1:
        print(f"rank {ctx.mesh.rank} of {ctx.mesh.size}: each worker's "
              f"batch {args.batch_size} split over the ranks", flush=True)
    run = store.make_async_step(loss_fn)
    log = StepLogger(every=10, jsonl=args.jsonl)
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
            loss = run(store.shard_batch(rank_slice(next(streams[w]),
                                                    ctx.mesh)), worker=w)
            mark()
            losses.append(loss)
            if log.wants(step):
                log.log(step, loss=float(loss), worker=w,
                        staleness=store.staleness(w))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        dt = max(time.perf_counter() - t0, 1e-9)
    log.close()
    hist = store.staleness_histogram
    version = store._engine.version
    print(f"done: version {version}, "
          f"staleness histogram {dict(sorted(hist.items()))}; "
          f"{args.steps} cycles in {dt:.2f}s ({args.steps / dt:.1f} cycles/s)")
    ps.shutdown()
    return {"losses": [float(x) for x in losses], "version": version,
            "staleness_histogram": hist, "cycles_per_sec": args.steps / dt}


def main(argv=None):
    args = parse_args(argv)
    if args.role == "worker":
        return run_worker(args)
    if args.role == "server":
        return run_server(args)
    return run_single(args)


if __name__ == "__main__":
    main()
