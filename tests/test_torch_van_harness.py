"""Processes of the port's van plane on the CPU, for the van tests.

This module holds no test. ``tests/test_torch_remote_async.py`` and
``tests/test_torch_van.py`` start processes of this file, which import
torch and the port and never jax, and kill each one after a wall-clock
limit, so nothing hangs:

    python tests/test_torch_van_harness.py server <out> <nworkers> <cycles> [<shard> <nshards>]
    python tests/test_torch_van_harness.py worker <ports> <out> <worker> <cycles> [<nworkers> [<opts>]]
    python tests/test_torch_van_harness.py drill <rank> <k> <port> <hb_base> <victim> <out>
    python tests/test_torch_van_harness.py sparse-server <out> <nworkers> <cycles> <shard> <nshards> <device> <shape> [<opts>]
    python tests/test_torch_van_harness.py sparse-worker <ports> <out> <worker> <cycles> <device> <shape> <nworkers> <record> [<opts>]
    python tests/test_torch_van_harness.py replica-backup <out> <watch_port> <watch_timeout_ms> <device> [<opts>]
    python tests/test_torch_van_harness.py replica-primary <out> <watch_port> <ack> <window> <device> [<loop> [<opts>]]
    python tests/test_torch_van_harness.py replica-worker <out> <steps> <kill_at> <device>
    python tests/test_torch_van_harness.py read-server <out> <shard> <nshards> <device> <shape> <opts>
    python tests/test_torch_van_harness.py read-pusher <out> <cycles> <device> <shape>
    python tests/test_torch_van_harness.py read-reader <out> <reader> <shape>
    python tests/test_torch_van_harness.py agg-server <out> <uri> <group_size> <opts>

- server: an async KVStore on the CPU (sgd 0.05, dc_lambda 0.04) behind
  ``AsyncPSService`` with its full history, on a port the kernel picks
  (written to ``port<shard>``: a port chosen ahead and bound later could
  be taken meanwhile by another test's process); once every worker said
  goodbye it writes its event log, staleness histogram and final
  parameters (``server<shard>.json``, ``server_params<shard>.npz``).
- worker: pull, then ``cycles`` push_pulls of :func:`make_grads` (a
  deterministic function of worker and cycle, so a replay regenerates
  them), with jitter so the workers' pushes interleave and staleness is
  real; writes ``worker<id>.json``. Given ``nworkers``, it waits after
  its first pull until that many workers have pulled (a file barrier in
  ``out``), so the workers' cycles overlap however their processes
  started. ``opts`` (json, ``nworkers`` 0 for none) makes it a member of
  an aggregation group: ``aggregator`` (``host:port``, or ``"@"`` for the
  port an ``agg-server`` in ``out`` wrote), ``uri`` (the shards, replica
  sets allowed, instead of ``ports``), ``shm``, ``device`` and
  ``failover_timeout``; with ``hidden`` its tree is :func:`agg_tree`'s
  and its gradients :func:`agg_grads`' (``scale``), pushed without
  jitter, and its record also holds each cycle's end, its wire bytes and
  whether, how often and in which cycle it degraded to the flat path.
- drill: rank ``rank`` of ``k`` gloo ranks with heartbeats on; the victim
  rank dies hard (``os._exit(17)``) after one step, the others poll
  ``check_health()`` until it raises and write what it named.

- sparse-server / sparse-worker: the sparse PS
  (``backends/remote_sparse.py``), modelled on the reference's
  ``tests/mp_sparse_worker.py``: server ``shard`` of ``nshards`` owns its
  row range of a "deep" (adagrad) and a "wide" (sgd) table on ``device``,
  at ``shape`` "small" (the reference test's 96 rows) or "wd" (W&D's full
  width), and once every worker said goodbye dumps its tables, apply log,
  versions and kernel launch counts; a worker (``ports`` may be ``@n``:
  wait for n servers' port files) runs deterministic cycles of pull +
  push and push_pull with its ids and grads on ``device``. ``opts`` is a
  json object of the van's transport options: a server's
  ``{"native_loop": true}``, a worker's ``{"shm": true, "compress":
  spec}``. Phases 17 and 19 of ``chip_smoke.py`` run the same code on the
  card at "wd"; :func:`sparse_replay` replays a run, re-encoding each
  worker's grads through its codec when it compressed them.

- replica-backup / replica-primary / replica-worker: the failover drill
  of replication (``replica/``), modelled on the reference's
  ``tests/mp_replica_worker.py``: the MNIST trainer's MLP (hidden 32,
  sgd 0.1, dc_lambda 0, one worker) on a backup with a
  ``PromotionWatch`` on ``watch_port`` (its port in ``backup_port``),
  and on a primary that attaches it with ``ack`` and ``window`` and
  beats the watch every 50 ms (``primary.ready`` holds its port once
  attached); the worker trains ``steps`` steps over the replica set and,
  after step ``kill_at``, writes ``killpoint`` and waits for ``killed``
  (the parent's SIGKILL of the primary landed), so its next push meets
  the dead primary. The servers run until ``done`` appears; the backup
  then dumps its role, promotion and counters (``backup.json``, its
  params ``backup_params.npz``), the worker its losses, failovers and
  final params (``worker.json``, ``worker_params.npz``). The primary
  takes an optional ``loop`` (1: the native loop) after ``device``. An
  ``opts`` json after ``device`` (the primary's after ``loop``) serves
  :func:`agg_tree`'s MLP instead (``hidden``, ``lr``, ``num_workers``),
  as phase 22 (c) of ``chip_smoke.py`` does.

- read-server / read-pusher / read-reader: the read path's processes
  (phase 21 of ``chip_smoke.py``), over the sparse roles' tables: a
  server (``opts``: ``tag`` of its port file ``port<shard><tag>``,
  ``backup``, ``native_loop``, ``attach``: the tag of the backup it
  attaches with sync ack) runs the commands ``cmd<k>.json`` in order
  (``{"op": "snap"}``, or ``{"op": "cache", "bytes": n}``: the native
  read cache's budget, 0 off) and after each writes
  ``snap<k>_<shard><tag>.json`` (launches, applies, versions, read
  counters, the native cache's counters, and with ``"digests": true``
  its tables' digests), until ``exit`` appears; the
  pusher runs a sparse worker's cycles against the primaries from
  ``push_go`` until ``push_stop`` and writes ``pusher.json``; a reader
  reads its hot id-set (a Criteo-like batch of its own seed) with
  ``read_rows`` for each window ``go<k>.json`` (``{"mode": "layered" |
  "primary" | "final", "readers": R, "seconds": s}``) and writes
  ``read<k>_<reader>.json``, until ``exit``.

- agg-server: two-level aggregation (``backends/aggregator.py``): an
  ``AggregatorService`` of ``group_size`` members over the shards at
  ``uri`` (a ``server``'s or a ``replica-primary``'s), for
  :func:`agg_tree`'s structure at ``hidden``, on the native loop unless
  ``opts`` says ``"native_loop": false``; writes its port to
  ``agg_port`` and, once ``agg_done`` appears, dumps ``agg.json`` (rounds,
  the realized fan-in, every member push's hold, the upstream bytes, the
  member reads it served and their ages, the native read cache's
  counters, the kernel launch counts and whether CUDA was initialized:
  an aggregator launches no kernel). Its members are ``worker``
  processes given ``aggregator``.

Every process of this file computes on one intra-op thread, as the
replays of its runs do (:func:`one_thread`). :func:`replay` replays a run
of the MNIST trainer's ``--role server|worker`` processes from its
servers' event logs (each worker's gradients through its codec when it
compressed them); ``chip_smoke.py`` uses it too.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
SCRIPT = os.path.abspath(__file__)
LR, DC_LAMBDA = 0.05, 0.04


def free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(*args, module=None) -> subprocess.Popen:
    """One process of this file (or of ``python -m module``), without
    jax's environment, on one thread and at a lower priority (``nice``):
    the suite runs these beside other timing-sensitive tests."""
    import shutil

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    head = ["-m", module] if module else [SCRIPT]
    nice = [shutil.which("nice"), "-n", "10"] if shutil.which("nice") else []
    return subprocess.Popen([*nice, sys.executable, *head, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs, wall_s, fail_fast=False):
    """Wait for every process (killing all after ``wall_s`` seconds);
    returns their outputs. With ``fail_fast``, all are killed as soon as
    one exits non-zero (the others would wait on it), and the outputs
    are read as they come, so that no pipe fills meanwhile."""
    if fail_fast:
        return _finish_fast(procs, wall_s)
    outs = []
    try:
        deadline = time.monotonic() + wall_s
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        kill_all(procs)
    return outs


def _finish_fast(procs, wall_s):
    import threading

    outs = [""] * len(procs)

    def read(i, p):
        outs[i] = p.communicate()[0]

    readers = [threading.Thread(target=read, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + wall_s
    try:
        while (any(t.is_alive() for t in readers)
               and time.monotonic() < deadline
               and not any(p.poll() not in (None, 0) for p in procs)):
            time.sleep(0.05)
    finally:
        kill_all(procs)
        for t in readers:
            t.join(timeout=10)
    return outs


def kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def server_port(proc, out, shard="", timeout: float = 120.0) -> int:
    """The port a ``server`` process of this file listens on, once it
    does (its ``port<shard>`` file)."""
    path = os.path.join(out, f"port{shard}")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            kill_all([proc])
            raise RuntimeError(f"server never listened:\n"
                               f"{proc.stdout.read()}")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def trainer_port(proc, timeout: float = 120.0) -> int:
    """The port a ``--role server --port 0`` trainer process listens on,
    from the line it prints once it does."""
    import re
    import threading

    found = []

    def scan():
        for line in proc.stdout:
            m = re.search(r"async PS server on port (\d+)", line)
            if m:
                found.append(int(m.group(1)))
                return

    t = threading.Thread(target=scan, daemon=True)
    t.start()
    t.join(timeout)
    if not found:
        kill_all([proc])
        raise RuntimeError("the trainer's server never listened")
    return found[0]


@contextlib.contextmanager
def one_thread():
    """Compute on one intra-op thread inside the block, as the processes
    of this file do: a replay then takes the CPU sum orders of the run."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _codec_round_trip(tree, compressor):
    """``{key: array}`` through a compressor's encode and the decode: the
    tree the receiving side applies."""
    from ps_tpu_torch.compress import decode_tree

    wire, enc = compressor.encode_tree(tree)
    return decode_tree(dict(wire), enc)


def replay(event_logs, num_workers: int, device, witness=None,
           seed: int = 0, lr: float = 0.1, dc_lambda: float = 0.04,
           batch_size: int = 64, compress=None):
    """Replay a run of the MNIST trainer's ``--role server|worker``
    processes from its servers' event logs (one log a shard, in shard
    order) through one-process ``AsyncCudaServer`` engines on ``device``;
    returns the final ``{key: tensor}`` of every key.

    Each worker's gradient is recomputed from what it pulled: its c-th
    push takes the gradient of its c-th batch at the params of its last
    pull before that push on each shard, merged over the shards (after a
    failover a worker may pull twice before a push: its in-flight
    push_pull's push was deduplicated at the promoted backup, which
    recorded the pull again). Each log keeps its shard's order; a push
    waits until the worker's pulls it depends on were replayed on every
    shard, as in the run. On the run's device the result is the servers'
    final parameters bitwise.

    ``witness`` (another device) replays the logs there in lockstep, each
    gradient recomputed on the witness from the params pulled on
    ``device``, so that no rounding of the witness's own trajectory feeds
    back into its gradients. Returns ``(final, witness_final, grad_err)``
    then, over the pushes p with gradient trees g_p on ``device`` and m
    the median ``‖g_p‖₂``: ``grad_err["witness"]`` is the largest
    ``‖g_witness,p - g_p‖₂ / max(‖g_p‖₂, m)``; ``grad_err["relative"]``
    the largest ``‖g_witness,p - g_p‖₂ / ‖g_p‖₂``, which a push whose
    gradient nearly cancels (a near-uniform softmax) inflates while its
    terms keep their rounding, hence the floor m; ``grad_err["smallest"]``
    and ``grad_err["largest"]`` the least and the largest ``‖g_p‖₂ / m``;
    ``grad_err["worst"]`` the push that sets ``grad_err["witness"]``: its
    worker and cycle, each key's ``‖g_witness - g‖₂`` (``per_key``), the
    smallest ``|z|`` of its ReLU inputs ``z = x W1 + b1`` on ``device``
    (``relu_min_abs``) and how many of them the two devices put on
    opposite sides of zero (``relu_sign_flips``).

    ``compress`` (``{worker: spec}``, the spec that worker resolved, its
    seed included) replays the codecs: each push goes through the
    worker's own compressor (topk's residuals, int8's stream) shard by
    shard, and with ``pull`` each pull's tree through the server's codec
    for that worker and pull, so each gradient is taken at what the
    worker decoded. Not with ``witness``.
    """
    import torch

    from ps_tpu_torch.backends.cuda import AsyncCudaServer
    from ps_tpu_torch.compress import CompressPolicy, GradCompressor
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.kv.store import value_and_grad
    from ps_tpu_torch.optim import make_optimizer

    devices = [torch.device(device)] + (
        [torch.device(witness)] if witness is not None else [])
    params, loss_fn = build(seed, "cpu")
    flat, treedef = keymod.flatten_with_keys(params)
    order = list(flat)
    nshards = len(event_logs)
    owned = [[k for k in order if nshards == 1
              or keymod.shard_for_key(k, nshards) == s]
             for s in range(nshards)]
    engines = []  # [device][shard]
    for dev in devices:
        engines.append([])
        for s in range(nshards):
            eng = AsyncCudaServer(make_optimizer("sgd", learning_rate=lr),
                                  dev, num_workers, dc_lambda=dc_lambda)
            eng.register_tree({k: flat[k] for k in owned[s]}, None,
                              owned[s])
            engines[-1].append(eng)
    streams = {w: mnist_batches(batch_size, seed=seed, worker=w,
                                num_workers=num_workers)
               for w in range(num_workers)}
    compress = compress or {}
    if compress and witness is not None:
        raise ValueError("replay: compress does not take a witness")
    compressors = {w: GradCompressor(CompressPolicy.from_spec(spec))
                   for w, spec in compress.items()}

    def seen_by_worker(w, tree, epoch):
        """A pulled tree as worker ``w`` decoded it (its ``epoch``-th
        bucketed pull): the server's pull codec, seeded as it seeds it."""
        spec = compress.get(w)
        if not spec or not spec.get("pull"):
            return tree
        spec = {k: v for k, v in spec.items() if k != "pull"}
        spec["seed"] = ((int(spec.get("seed", 0)) * 1000003 + w * 9176
                         + epoch) & 0x7FFFFFFF)
        host = {k: v.cpu().numpy() for k, v in tree.items()}
        got = _codec_round_trip(host, GradCompressor(
            CompressPolicy.from_spec(spec)))
        return {k: torch.from_numpy(np.array(v)).to(tree[k].device)
                for k, v in got.items()}

    # (worker, shard) -> for its c-th push there, the index of its last
    # pull before it
    used = {}
    for s, log in enumerate(event_logs):
        npulls = {}
        for op, w in log:
            if op == "pull":
                npulls[w] = npulls.get(w, 0) + 1
            else:
                used.setdefault((w, s), []).append(npulls.get(w, 0) - 1)
    pulls = {}    # (worker, shard) -> trees pulled on ``device``
    pushes = {}   # (worker, shard) -> pushes replayed
    grads = {}    # (worker, cycle) -> one gradient a device
    diffs, norms = [], []  # a push's ‖g_witness - g‖₂ and ‖g‖₂
    which, per_key = [], []  # its (worker, cycle) and each key's difference
    cursors = [0] * nshards
    while any(c < len(log) for c, log in zip(cursors, event_logs)):
        moved = False
        for s, log in enumerate(event_logs):
            while cursors[s] < len(log):
                op, w = log[cursors[s]]
                if op == "pull":
                    trees = [e[s].pull_tree(worker=w) for e in engines]
                    n = len(pulls.get((w, s), []))
                    pulls.setdefault((w, s), []).append(
                        seen_by_worker(w, trees[0], n + 1))
                else:
                    c = pushes.get((w, s), 0)
                    if (w, c) not in grads:
                        if any(len(pulls.get((w, t), [])) <= used[(w, t)][c]
                               for t in range(nshards)):
                            break  # its pull on another shard comes first
                        kv = {}
                        for t in range(nshards):
                            kv.update(pulls[(w, t)][used[(w, t)][c]])
                        batch = next(streams[w])
                        gs = []
                        for dev in devices:
                            on = {k: v.to(dev) for k, v in kv.items()}
                            _, g, _ = value_and_grad(
                                loss_fn, keymod.unflatten(treedef, on, order),
                                tuple(torch.as_tensor(x).to(dev)
                                      for x in batch))
                            gs.append(keymod.flatten_with_keys(g)[0])
                        if w in compressors:  # each shard's subtree in turn
                            g = gs[0]
                            for t in range(nshards):
                                sub = {k: g[k].cpu().numpy()
                                       for k in g if k in owned[t]}
                                for k, v in _codec_round_trip(
                                        sub, compressors[w]).items():
                                    g[k] = torch.from_numpy(
                                        np.array(v)).to(g[k].device)
                        for g in gs[1:]:
                            per = {k: float((g[k].cpu().double()
                                             - v.cpu().double())
                                            .square().sum()) ** 0.5
                                   for k, v in gs[0].items()}
                            per_key.append(per)
                            which.append((w, c))
                            diffs.append(sum(x * x for x in per.values())
                                         ** 0.5)
                            norms.append(sum(float(
                                v.double().square().sum())
                                for v in gs[0].values()) ** 0.5)
                        grads[(w, c)] = gs
                    for e, g in zip(engines, grads[(w, c)]):
                        e[s].push_tree({k: g[k] for k in owned[s]},
                                       worker=w)
                    pushes[(w, s)] = c + 1
                cursors[s] += 1
                moved = True
        if not moved:
            raise RuntimeError("the event logs cannot be replayed: a push "
                               "waits on a pull no log holds")
    finals = [{k: e.peek(k) for e in per_dev for k in e.keys()}
              for per_dev in engines]
    if witness is None:
        return finals[0]
    diffs, norms = np.array(diffs), np.array(norms)
    median = float(np.median(norms))
    ratio = diffs / np.maximum(norms, median)
    i = int(ratio.argmax())
    w, c = which[i]
    kv = {}
    for t in range(nshards):
        kv.update(pulls[(w, t)][used[(w, t)][c]])
    stream = mnist_batches(batch_size, seed=seed, worker=w,
                           num_workers=num_workers)
    for _ in range(c + 1):
        x = next(stream)[0]
    zs = []
    for dev in devices:
        xd = torch.as_tensor(x).to(dev).reshape(len(x), -1)
        zs.append((xd @ kv["dense1/kernel"].to(dev)
                   + kv["dense1/bias"].to(dev)).cpu())
    return finals[0], finals[1], {
        "witness": float(ratio.max()),
        "relative": float((diffs / norms).max()),
        "smallest": float(norms.min()) / median,
        "largest": float(norms.max()) / median,
        "worst": {"worker": int(w), "cycle": int(c), "per_key": per_key[i],
                  "relu_min_abs": float(zs[0].abs().min()),
                  "relu_sign_flips": int(((zs[0] > 0) != (zs[1] > 0))
                                         .sum())}}


def model_params():
    """The MLP at hidden 16 from seed 0, as a flat ``{key: float32 array}``."""
    import torch

    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.mlp import MLP

    tree = MLP(hidden=16).init(torch.Generator().manual_seed(0))
    flat, _ = keys.flatten_with_keys(tree)
    return {k: v.numpy() for k, v in flat.items()}


def make_grads(params, worker: int, cycle: int):
    """A deterministic gradient tree for (worker, cycle), keys sorted."""
    rng = np.random.default_rng([worker, cycle])
    return {k: rng.normal(0, 0.1, params[k].shape).astype(np.float32)
            for k in sorted(params)}


def run_server(out, nworkers, cycles, shard=None, nshards=None):
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    params = {k: torch.from_numpy(v) for k, v in model_params().items()}
    if nshards is not None:
        params = ps.shard_tree(params, shard, nshards)
    ps.init(backend="cuda", mode="async", num_workers=nworkers,
            dc_lambda=DC_LAMBDA, device="cpu")
    store = ps.KVStore(optimizer="sgd", learning_rate=LR, mode="async")
    store.init(params)
    svc = AsyncPSService(store, shard=shard, num_shards=nshards,
                         record_full_history=True)
    suffix = "" if shard is None else str(shard)
    path = os.path.join(out, f"port{suffix}")
    with open(path + ".tmp", "w") as f:
        f.write(str(svc.port))
    os.replace(path + ".tmp", path)
    if not svc.wait_for_goodbyes(nworkers, timeout=120):
        raise TimeoutError(f"only {svc.goodbyes}/{nworkers} goodbyes")
    assert len(svc.apply_log) == nworkers * cycles, len(svc.apply_log)
    eng = store._engine
    np.savez(os.path.join(out, f"server_params{suffix}.npz"),
             **{k: v.numpy() for k, v in eng._params.items()})
    with open(os.path.join(out, f"server{suffix}.json"), "w") as f:
        json.dump({"event_log": svc.event_log, "apply_log": svc.apply_log,
                   "keys": svc._key_order, "version": eng.version,
                   "staleness_hist": {str(t): n for t, n in
                                      eng.staleness_hist.items()}}, f)
    svc.stop()
    ps.shutdown()


def run_worker(ports, out, worker, cycles, nworkers=None, opts=None):
    import torch

    import ps_tpu_torch as ps

    opts = opts or {}
    device = opts.get("device", "cpu")
    if "hidden" in opts:
        params = agg_tree(opts["hidden"])
    else:
        params = model_params()
    uri = opts.get("uri") or ",".join(f"127.0.0.1:{p}"
                                      for p in str(ports).split(","))
    agg = opts.get("aggregator")
    if agg == "@":
        path = os.path.join(out, "agg_port")
        _wait_file(path)
        with open(path) as f:
            agg = f"127.0.0.1:{f.read()}"
    w = ps.connect_async(uri, worker, {k: torch.from_numpy(v).to(device)
                                       for k, v in params.items()},
                         aggregator=agg, shm=opts.get("shm"),
                         failover_timeout=opts.get("failover_timeout"))
    versions, ends, nbytes = [], [], []
    w.pull_all()
    if nworkers:
        open(os.path.join(out, f"pulled{worker}"), "w").close()
        deadline = time.monotonic() + 60
        while not all(os.path.exists(os.path.join(out, f"pulled{i}"))
                      for i in range(nworkers)):
            if time.monotonic() > deadline:
                raise TimeoutError("the other workers never pulled")
            time.sleep(0.005)
    t0 = time.perf_counter()
    degraded_at = None
    for c in range(cycles):
        if "hidden" in opts:
            grads = agg_grads(params, worker, c, opts.get("scale", 1.0))
        else:
            time.sleep(0.003 * ((worker * 7 + c * 3) % 5))  # interleave
            grads = make_grads(params, worker, c)
        w.push_pull({k: torch.from_numpy(v).to(device)
                     for k, v in grads.items()})
        versions.append(w.version)
        ends.append(time.perf_counter() - t0)
        nbytes.append(w.bytes_pushed + w.bytes_pulled)
        if agg and degraded_at is None and w._agg_fallback is None:
            degraded_at = c
    with open(os.path.join(out, f"worker{worker}.json"), "w") as f:
        json.dump({"worker": worker, "versions": versions,
                   "per_server_versions": w.versions, "ends": ends,
                   "bytes": nbytes, "nonce": w._transport_nonce,
                   "push_seq": w._push_seq,
                   "aggregated": w._agg_fallback is not None,
                   "degraded_at": degraded_at,
                   "agg_degrades": w.transport.agg_degrades,
                   "lane": w.transport.lane()}, f)
    w.close()


def run_drill(rank, k, port, hb_base, victim, out):
    import torch
    import torch.distributed as dist

    import ps_tpu_torch as ps
    from ps_tpu_torch.control import WorkerFailureError

    ps.init(backend="cuda", device="cpu", coordinator_uri=f"127.0.0.1:{port}",
            num_processes=k, process_id=rank, dist_backend="gloo",
            heartbeat_base_port=hb_base, heartbeat_timeout_ms=2000,
            heartbeat_interval_ms=50)  # a long horizon: a loaded machine
    # must not starve a live rank's beats into a false death
    backend = ps.current_context().backend
    t = torch.ones(4)
    dist.all_reduce(t)  # one step together
    if rank == victim:
        os._exit(17)  # hard death mid-run, no goodbye
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 60:
            backend.check_health()
            time.sleep(0.1)
        result = {"dead": None}
    except WorkerFailureError as e:
        result = {"dead": e.dead, "seconds": time.monotonic() - t0,
                  "message": str(e)}
    ps.shutdown(abort=True)
    with open(os.path.join(out, f"drill{rank}.json"), "w") as f:
        json.dump(result, f)


# -- the replication drill's processes (replica/) -----------------------------


def keep_samples(transport) -> dict:
    """Keep every latency sample ``transport`` records, by its histogram
    key (``push_s``, ``apply_s``, ``failover_s``, ...). A process reports
    histograms; a role that hands its run's raw samples to the test (a
    median, a cycle's slice) keeps them here."""
    samples = collections.defaultdict(list)
    transport.listener = lambda key, v: samples[key].append(v)
    return samples


def obs_start(out, opts, name, clock_port=None):
    """A role's observability, when ``opts["obs"]`` is set: the process's
    tracer and flight recorder named ``name`` and writing under ``out``
    (sampling stays off: the role turns it on where it traces), a /metrics
    endpoint with ``opts["metrics"]`` (its port in ``metrics<name>``), and
    the clock offset to the server whose port file is ``clock_port``
    (probed in the background once the file appears; none: this process
    is the clock). Returns the clock record, or None without ``obs``."""
    import threading

    from ps_tpu_torch import obs

    if not opts.get("obs"):
        return None
    obs.configure(sample=0.0, trace_dir=out, service=name)
    if opts.get("metrics"):
        srv = obs.start_metrics_server(0)
        _write(os.path.join(out, f"metrics{name}"), srv.port)
    clock = {"offset_us": 0.0, "err_us": 0.0, "of": clock_port}
    if clock_port is not None:
        def probe():
            from ps_tpu_torch.control import tensor_van as tv

            path = os.path.join(out, clock_port)
            _wait_file(path, timeout=300)
            with open(path) as f:
                ch = tv.Channel.connect("127.0.0.1", int(f.read()))
            try:
                cs = obs.ClockSync()
                cs.probe(ch, n=16)
            finally:
                ch.close()
            # every probe the estimate keeps lies within the tie band of
            # the fastest round trip: half of that bounds its error
            clock.update(offset_us=cs.offset_us,
                         err_us=(cs.rtt_us + cs.tie_us) / 2.0)

        clock["thread"] = threading.Thread(target=probe, daemon=True)
        clock["thread"].start()
    return clock


def obs_export(out, name, clock, dump=True) -> None:
    """Write the tracer's ring, shifted onto the clock server's time, to
    ``trace-<name>.json`` with the offset and its error in
    ``clock-<name>.json``, and with ``dump`` the flight ring to
    ``flight-<name>.jsonl``."""
    from ps_tpu_torch import obs

    t = clock.get("thread")
    if t is not None:
        t.join(timeout=60)
    obs.tracer().clock_offset_us = clock["offset_us"]
    obs.tracer().export_chrome(os.path.join(out, f"trace-{name}.json"))
    _write(os.path.join(out, f"clock-{name}.json"), json.dumps(
        {k: v for k, v in clock.items() if k != "thread"}))
    if dump:
        obs.flight().dump("end of run",
                          path=os.path.join(out, f"flight-{name}.jsonl"),
                          empty_ok=True)


def _wait_file(path, timeout=120.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)


def _write(path, text) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(str(text))
    os.replace(path + ".tmp", path)


def _replica_store(device, opts=None):
    """The MNIST trainer's MLP from seed 0 in an async store (sgd 0.1,
    dc_lambda 0, one worker) on ``device``; with ``opts``, :func:`agg_tree`
    at ``hidden`` with ``lr`` and ``num_workers``."""
    import torch

    import ps_tpu_torch as ps
    from ps_tpu_torch.examples.train_mnist_async import build

    opts = opts or {}
    ctx = ps.init(backend="cuda", mode="async",
                  num_workers=opts.get("num_workers", 1), dc_lambda=0.0,
                  device=device)
    if "hidden" in opts:
        params = {k: torch.from_numpy(v).to(ctx.device)
                  for k, v in agg_tree(opts["hidden"]).items()}
    else:
        params, _ = build(0, ctx.device)
    store = ps.KVStore(optimizer="sgd", learning_rate=opts.get("lr", 0.1),
                       mode="async")
    store.init(params)
    return store


def run_replica_backup(out, watch_port, watch_timeout_ms, device,
                       opts=None):
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService
    from ps_tpu_torch.replica import PromotionWatch

    svc = AsyncPSService(_replica_store(device, opts), backup=True)
    watch = PromotionWatch(svc, primary_id=1, port=watch_port,
                           timeout_ms=watch_timeout_ms)
    _write(os.path.join(out, "backup_port"), svc.port)
    _wait_file(os.path.join(out, "done"), timeout=300)
    np.savez(os.path.join(out, "backup_params.npz"),
             **{k: v.cpu().numpy() for k, v in svc._engine._params.items()})
    with open(os.path.join(out, "backup.json"), "w") as f:
        json.dump({"role": svc.role, "epoch": svc.epoch,
                   "promote_reason": svc.promote_reason,
                   "promotion_s": svc.promotion_s,
                   "detect_age_ms": watch.detect_age_ms,
                   "version": svc._engine.version,
                   "replica_applied_seq": svc._replica_applied_seq,
                   "dedup_hits": svc.transport.dedup_hits}, f)
    watch.close()
    svc.stop()
    ps.shutdown()


def run_replica_primary(out, watch_port, ack, window, device, loop=False,
                        opts=None):
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService
    from ps_tpu_torch.control.heartbeat import HeartbeatClient

    svc = AsyncPSService(_replica_store(device, opts), native_loop=loop)
    path = os.path.join(out, "backup_port")
    _wait_file(path)
    with open(path) as f:
        back = int(f.read())
    svc.attach_backup("127.0.0.1", back, ack=ack, window=int(window))
    hb = HeartbeatClient("127.0.0.1", watch_port, node_id=1, interval_ms=50)
    _write(os.path.join(out, "primary.ready"), svc.port)
    # serves until killed (the drill) or until the run is over
    _wait_file(os.path.join(out, "done"), timeout=300)
    hb.close(goodbye=False)
    svc.stop()
    ps.shutdown()


def run_replica_worker(out, steps, kill_at, device):
    import torch

    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.kv.store import value_and_grad

    params, loss_fn = build(0, device)
    ready = os.path.join(out, "primary.ready")
    _wait_file(ready)
    with open(ready) as f, open(os.path.join(out, "backup_port")) as g:
        uri = f"127.0.0.1:{f.read()}|127.0.0.1:{g.read()}"
    w = connect_async(uri, 0, params, failover_timeout=30.0)
    samples = keep_samples(w.transport)
    losses = []
    p = w.pull_all()
    for step, (images, labels) in enumerate(mnist_batches(32, steps=steps)):
        batch = (torch.from_numpy(images).to(w.device),
                 torch.from_numpy(labels).to(w.device))
        loss, grads, _ = value_and_grad(loss_fn, p, batch)
        losses.append(float(loss))
        p = w.push_pull(grads)  # rides the failover once the kill landed
        if step == kill_at:
            # the parent's cue: the primary dies now, and the next push
            # meets it dead
            _write(os.path.join(out, "killpoint"), step)
            _wait_file(os.path.join(out, "killed"), timeout=60)
    flat, _ = keys.flatten_with_keys(p)
    np.savez(os.path.join(out, "worker_params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in flat.items()})
    with open(os.path.join(out, "worker.json"), "w") as f:
        json.dump({"losses": losses, "failovers": w.transport.failovers,
                   "failover_s": samples["failover_s"],
                   "epochs": w._epochs}, f)
    w.close()


# -- two-level aggregation's processes (backends/aggregator.py) -------------


def agg_tree(hidden: int, init: str = "int") -> dict:
    """The MNIST MLP's tree at ``hidden`` (784-hidden-10) as a flat
    ``{key: float32 array}``: with ``init="int"`` the i-th key (sorted) is
    all ``i % 2``, so that integer gradients and a power-of-two learning
    rate keep every sum exact (the closed form of :func:`agg_expected` is
    then bitwise); with ``"seed"`` the MLP's own initialization from seed
    0."""
    import torch

    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.mlp import MLP

    tree = MLP(hidden=hidden).init(torch.Generator().manual_seed(0))
    flat, _ = keys.flatten_with_keys(tree)
    if init == "seed":
        return {k: v.numpy() for k, v in flat.items()}
    return {k: np.full(tuple(v.shape), float(i % 2), np.float32)
            for i, (k, v) in enumerate(sorted(flat.items()))}


def agg_grads(params, worker: int, cycle: int, scale: float = 1.0) -> dict:
    """The integer gradient of (worker, cycle): the i-th key (sorted) all
    ``(3 * worker + cycle + 1 + i) * scale``."""
    return {k: np.full(params[k].shape, (3 * worker + cycle + 1 + i) * scale,
                       np.float32)
            for i, k in enumerate(sorted(params))}


def agg_merged(params, workers, cycle: int, scale: float = 1.0) -> dict:
    """The aggregator's merge of one round: the members' gradients summed
    in ascending member order into an accumulator of its own, as
    ``AggregatorService`` sums them."""
    merged = {}
    for w in sorted(workers):
        g = agg_grads(params, w, cycle, scale)
        if not merged:
            merged = {k: np.array(v) for k, v in g.items()}
        else:
            for k, v in g.items():
                merged[k] += v
    return merged


def agg_expected(params0, cycles_by_worker, lr: float) -> dict:
    """The closed form once every (worker, cycle) gradient of
    :func:`agg_grads` (scale 1) applied once under sgd: exact in float32
    for :func:`agg_tree`'s ``"int"`` init and a power-of-two ``lr``."""
    out = {}
    for i, k in enumerate(sorted(params0)):
        tot = sum(3 * w + c + 1 + i for w, cycles in cycles_by_worker.items()
                  for c in cycles)
        out[k] = (params0[k] - np.float32(lr * tot)).astype(np.float32)
    return out


def run_agg_server(out, uri, group_size, opts):
    """One host group's aggregator until ``agg_done`` appears (or a
    SIGKILL), then its dump (``agg.json``)."""
    import torch

    from ps_tpu_torch.backends.aggregator import AggregatorService
    from ps_tpu_torch.ops import flash_attention  # noqa: F401 (counters)

    fa = sys.modules["ps_tpu_torch.ops.flash_attention"]
    like = {k: torch.from_numpy(v)
            for k, v in agg_tree(opts.get("hidden", 256)).items()}
    agg = AggregatorService(uri, like, group_size=group_size,
                            native_loop=opts.get("native_loop", True),
                            loop_threads=1,
                            flush_timeout_ms=opts.get("flush_timeout_ms"))
    samples = keep_samples(agg.transport)
    _write(os.path.join(out, "agg_port"), agg.port)
    _wait_file(os.path.join(out, "agg_done"), timeout=600)
    t = agg.transport
    cache = agg._nloop.cache_stats() if agg.native_loop else None
    info = {"rounds": agg._rounds_done, "group_size": agg.group_size,
            "summary": t.summary(), "hold_s": samples["agg_hold_s"],
            "upstream": {"bytes_pushed": agg._client.bytes_pushed,
                         "bytes_pulled": agg._client.bytes_pulled},
            "reads_served": t.reads_served,
            "not_modified": t.read_not_modified,
            "fresh": t.fresh_snapshot(), "cache": cache,
            "loop_pushes": t.loop_pushes,
            "launches": dict(_launch_counts(),
                             flash=fa.LAUNCHES),
            "cuda_initialized": torch.cuda.is_initialized()}
    with open(os.path.join(out, "agg.json"), "w") as f:
        json.dump(info, f)
    agg.stop()


# -- the sparse PS's processes (backends/remote_sparse.py) ------------------

#: the sparse roles' sizes. "small" is the reference's test size
#: (tests/mp_sparse_worker.py): 96 rows, D 8 and 1, 24 uniform ids a
#: cycle. "wd" is Wide-&-Deep's full published width (WideDeepConfig()):
#: 26 x 100,000 rows, D 16 and 1, a cycle's ids the global ids of one
#: Criteo-like batch of 512 examples (13,312 ids, Zipf-skewed).
SPARSE_SHAPES = {
    "small": {"rows": 96, "deep": 8, "ids": 24},
    "wd": {"rows": 2_600_000, "deep": 16, "batch": 512, "vocab": 100_000,
           "features": 26},
}
#: name -> (optimizer, seed): the W&D trainer's tables and rules
SPARSE_TABLES = {"deep": ("adagrad", 11), "wide": ("sgd", 13)}
SPARSE_LR = 0.05


def sparse_spec(shape: str) -> dict:
    """The worker's ``{name: (total_rows, dim)}``."""
    sh = SPARSE_SHAPES[shape]
    return {"deep": (sh["rows"], sh["deep"]), "wide": (sh["rows"], 1)}


@functools.lru_cache(maxsize=4)
def sparse_table(shape: str, name: str) -> np.ndarray:
    """The whole initial table, drawn from its seed (servers slice it).
    Shared between calls: copy before changing it."""
    rows, dim = sparse_spec(shape)[name]
    rng = np.random.default_rng(SPARSE_TABLES[name][1])
    return rng.standard_normal((rows, dim), dtype=np.float32) * np.float32(
        0.01)


def sparse_ids(shape: str, worker: int, cycles: int) -> list:
    """A worker's global ids, one [N] int32 array a cycle (both tables
    take the same ids, as W&D's do)."""
    sh = SPARSE_SHAPES[shape]
    if shape == "small":
        return [np.random.default_rng([worker, c, 7]).integers(
            0, sh["rows"], sh["ids"]).astype(np.int32)
            for c in range(cycles)]
    from ps_tpu_torch.data.synthetic import criteo_batches

    offsets = np.arange(sh["features"], dtype=np.int32) * sh["vocab"]
    return [(b["sparse"] + offsets[None, :]).reshape(-1)
            for b in criteo_batches(sh["batch"], vocab_size=sh["vocab"],
                                    num_sparse=sh["features"], seed=worker,
                                    steps=cycles)]


def sparse_grads(shape: str, worker: int, cycle: int, name: str,
                 n: int) -> np.ndarray:
    """The row grads of one (worker, cycle, table), f32."""
    dim = sparse_spec(shape)[name][1]
    rng = np.random.default_rng([worker, cycle, SPARSE_TABLES[name][1]])
    return rng.standard_normal((n, dim), dtype=np.float32) * np.float32(0.1)


def routed_pushes(shape: str, worker: int, shard: int, nshards: int,
                  cycles: int, ids=None, compress=None):
    """The shard-local ``{name: (ids, grads)}`` that ``worker``'s cycles
    send ``shard``: the worker's payloads (dedupe, then the range split,
    order kept). A cycle with no row in the range sends no message and is
    skipped, as the worker skips it. With ``compress`` (the spec the
    worker resolved) the grads are what the server decodes."""
    if compress is not None:
        yield from _coded_pushes(shape, worker, nshards, cycles,
                                 json.dumps(compress, sort_keys=True))[shard]
        return
    ids = sparse_ids(shape, worker, cycles) if ids is None else ids
    for c in range(cycles):
        per = _routed(shape, worker, c, ids[c], shard, nshards)
        if per:
            yield per


def _routed(shape, worker, cycle, ids, shard, nshards) -> dict:
    """One cycle's ``{name: (shard-local ids, grads)}`` for ``shard``."""
    from ps_tpu_torch.backends.remote_sparse import dedupe_rows_np, row_range

    per = {}
    for name, (rows, _) in sparse_spec(shape).items():
        lo, hi = row_range(shard, nshards, rows)
        u, g = dedupe_rows_np(ids, sparse_grads(shape, worker, cycle, name,
                                                ids.size))
        keep = (u >= lo) & (u < hi)
        if keep.any():
            per[name] = (u[keep] - lo, g[keep])
    return per


@functools.lru_cache(maxsize=4)
def _coded_pushes(shape: str, worker: int, nshards: int, cycles: int,
                  spec_json: str):
    """Every shard's routed pushes of ``worker`` with the grads through
    the worker's one compressor, in the worker's order: cycle by cycle,
    shard by shard, each payload's keys in the order the worker builds
    them (a table's ids, then its grads)."""
    from ps_tpu_torch.compress import CompressPolicy, GradCompressor

    comp = GradCompressor(CompressPolicy.from_spec(json.loads(spec_json)))
    ids = sparse_ids(shape, worker, cycles)
    out = [[] for _ in range(nshards)]
    for c in range(cycles):
        for s in range(nshards):
            per = _routed(shape, worker, c, ids[c], s, nshards)
            if not per:
                continue
            payload = {}
            for name, (i, g) in per.items():
                payload[f"{name}/ids"], payload[f"{name}/grads"] = i, g
            got = _codec_round_trip(payload, comp)
            out[s].append({name: (i, got[f"{name}/grads"])
                           for name, (i, _) in per.items()})
    return out


def expected_pushes(shape: str, shard: int, nshards: int, nworkers: int,
                    cycles: int) -> int:
    """How many push messages reach ``shard``."""
    return sum(len(list(routed_pushes(shape, w, shard, nshards, cycles)))
               for w in range(nworkers))


def push_frames(shape: str, worker: int, shard: int, nshards: int,
                cycles: int) -> dict:
    """The serial push frames ``worker`` sends ``shard``, by kind: even
    cycles pull then push (``ROW_PUSH``), odd ones push_pull
    (``ROW_PUSH_PULL``); a cycle with no row in the range sends none."""
    ids = sparse_ids(shape, worker, cycles)
    out = {"ROW_PUSH": 0, "ROW_PUSH_PULL": 0}
    for c in range(cycles):
        if _routed(shape, worker, c, ids[c], shard, nshards):
            out["ROW_PUSH" if c % 2 == 0 else "ROW_PUSH_PULL"] += 1
    return out


def check_loop_carried(infos, opts, shape, cycles, what=""):
    """Each server on the native loop dispatched exactly the pushes of its
    TCP workers (``opts[w]`` without ``shm``: their connections stay on
    the loop; a ring worker's are detached to a thread), and native
    admission classified exactly their flat ``ROW_PUSH`` frames, some of
    them fresh. Raises AssertionError naming ``what``."""
    nshards = len(infos)
    for s, info in enumerate(infos):
        want = {"ROW_PUSH": 0, "ROW_PUSH_PULL": 0}
        for w, o in enumerate(opts):
            if not o.get("shm"):
                for k, n in push_frames(shape, w, s, nshards,
                                        cycles).items():
                    want[k] += n
        a = info["admit"]
        classified = a["acks"] + a["refusals"] + a["fresh"] + a["punts"]
        dispatched = (want["ROW_PUSH"] + want["ROW_PUSH_PULL"] - a["acks"]
                      - a["refusals"])
        if not (info["native_loop"] and info["loop_pushes"] == dispatched
                and classified == want["ROW_PUSH"]
                and (a["fresh"] > 0 or not want["ROW_PUSH"])):
            raise AssertionError(
                f"{what}: server {s} on the loop {info['native_loop']} "
                f"dispatched {info['loop_pushes']} pushes of the TCP "
                f"workers' {want}; admission {a}")


#: a tiered table's admission threshold in the sparse roles
TIERED_ADMIT_FREQ = 2


def sparse_tables(shape: str, shard: int, nshards: int, fused_apply=None,
                  tiered=None):
    """The port's tables of ``shard``'s row range, on the device
    ``ps_tpu_torch.init`` chose. With ``tiered`` (a divisor) each is a
    ``TieredTable`` whose device budget is its rows // ``tiered``."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_sparse import row_range
    from ps_tpu_torch.kv.tiered import TieredTable

    out = {}
    for name, (rows, dim) in sparse_spec(shape).items():
        lo, hi = row_range(shard, nshards, rows)
        if tiered:
            emb = TieredTable(hi - lo, dim, SPARSE_TABLES[name][0],
                              device_rows=(hi - lo) // int(tiered),
                              admit_freq=TIERED_ADMIT_FREQ,
                              learning_rate=SPARSE_LR,
                              fused_apply=fused_apply)
        else:
            emb = ps.SparseEmbedding(hi - lo, dim,
                                     optimizer=SPARSE_TABLES[name][0],
                                     learning_rate=SPARSE_LR,
                                     fused_apply=fused_apply)
        emb.init(sparse_table(shape, name)[lo:hi])
        out[name] = emb
    return out


def _read_ports(ports: str, out: str, suffix: str = "") -> str:
    """``"p0,p1"``, or ``"@n"``: wait for the port files of n servers
    (``port<s><suffix>``)."""
    if not ports.startswith("@"):
        return ports
    found = []
    for s in range(int(ports[1:])):
        path = os.path.join(out, f"port{s}{suffix}")
        _wait_file(path, timeout=300)
        with open(path) as f:
            found.append(f.read())
    return ",".join(found)


def table_digests(tables) -> dict:
    """SHA-256 of each table's rows and of each of its optimizer-state
    leaves, over the bytes on the host: equal digests are equal bits. A
    tiered table's are its hot tier's, then its arena, its cold state
    leaves and its directory (with the CLOCK hand)."""
    import hashlib

    from ps_tpu_torch.ops.sparse_apply import state_leaves

    def digest(x):
        if hasattr(x, "detach"):
            x = x.detach().cpu().contiguous().numpy()
        return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

    out = {}
    for name, emb in tables.items():
        for i, leaf in enumerate([emb.table] + state_leaves(emb.state())):
            out[f"{name}/{i}"] = digest(leaf)
        if hasattr(emb, "arena"):
            for i, leaf in enumerate([emb.arena] + emb.cold_state):
                out[f"{name}/cold{i}"] = digest(leaf)
            for a in ("tier", "slot", "freq", "ref", "slot_to_id"):
                out[f"{name}/{a}"] = digest(getattr(emb, a))
            out[f"{name}/hand"] = int(emb.hand)
    return out


def _launch_counts() -> dict:
    from ps_tpu_torch.ops import sparse_apply as ops

    return {"apply": ops.LAUNCHES, "group": ops.GROUP_LAUNCHES,
            "by_rule": dict(ops.LAUNCHES_BY_RULE)}


def run_sparse_server(out, nworkers, cycles, shard, nshards, device,
                      shape, opts=None):
    """Serve ``shard``'s row range of both tables until every worker said
    goodbye, then dump the tables and their optimizer state
    (``sparse_tables<shard>.npz``), the apply log, versions, rows, the
    sparse applies' times, the kernel launch counts and the transport's
    lane, loop, admission and codec counters
    (``sparse_server<shard>.json``). ``opts``: ``native_loop``; and for
    replication (``replica/``):

    - ``backup`` (with ``watch_port``, ``watch_timeout_ms``): a backup
      with a ``PromotionWatch``, its port in ``port<shard>b``; it serves
      until promoted and every worker said goodbye, or until ``done``
      appears, and dumps ``sparse_server<shard>b.json``;
    - ``replicate`` (with ``ack``, ``window``, ``watch_port``): a primary
      that waits for its backup's port, attaches it and beats its watch
      every 50 ms before it writes ``port<shard>`` (so workers dial an
      attached pair), sampling the backup's lag every 0.5 ms;
    - ``digests``: only the tables' digests are dumped, no npz;
    - ``tiered`` (a divisor): ``TieredTable`` tables (:func:`sparse_tables`),
      whose tier stats, row sums and cold passes' seconds join the dump
      (and their tier stats the snapshots);
    - ``obs`` (:func:`obs_start`; ``p<shard>`` or ``b<shard>``, its clock
      shard 0's primary): the traces export at ``snap`` and at the end,
      the flight ring dumps at the end; ``metrics``; ``detector_port``: a
      primary also beats that failure detector.

    Every server of a replicated run writes ``snap<shard><tag>.json`` (its
    tables' digests, launch counts, versions and applies) when ``snap``
    appears, and records each apply as (worker, cycle) (``applied``: the
    cycle is the worker's push seq less one)."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_sparse import SparsePSService
    from ps_tpu_torch.ops.sparse_apply import state_leaves

    opts = opts or {}
    backup = bool(opts.get("backup"))
    tag = "b" if backup else ""
    replicated = backup or bool(opts.get("replicate"))
    ps.init(backend="cuda", device=device)
    tables = sparse_tables(shape, shard, nshards, tiered=opts.get("tiered"))
    name = f"{tag or 'p'}{shard}"
    clock = obs_start(out, opts, name, clock_port=None
                      if (shard, backup) == (0, False) else "port0")
    svc = SparsePSService(
        tables, shard=shard, num_shards=nshards,
        total_rows={n: v for n, (v, _) in sparse_spec(shape).items()},
        record_full_history=True,
        native_loop=bool(opts.get("native_loop")), backup=backup)
    samples = keep_samples(svc.transport)
    applied = []
    if replicated:
        log_append = svc.apply_log.append

        def record(worker):  # under the service's lock, after the ledger
            applied.append([worker, svc._applied_pseq[worker][1] - 1])
            log_append(worker)

        svc.apply_log.append = record
    watch = hb = detector = None
    promoted_at = []
    lag = {"max": 0, "samples": 0}
    stop_sampling = threading.Event()
    if backup:
        from ps_tpu_torch.replica import PromotionWatch

        watch = PromotionWatch(
            svc, primary_id=1, port=int(opts["watch_port"]),
            timeout_ms=int(opts.get("watch_timeout_ms", 1000)),
            on_promote=lambda reason, s: promoted_at.append(
                time.monotonic()))
        path = os.path.join(out, f"port{shard}b")
    else:
        if opts.get("replicate"):
            from ps_tpu_torch.control.heartbeat import HeartbeatClient

            back = os.path.join(out, f"port{shard}b")
            _wait_file(back, timeout=300)
            with open(back) as f:
                sess = svc.attach_backup(
                    "127.0.0.1", int(f.read()), ack=opts.get("ack", "sync"),
                    window=int(opts.get("window", 256)))
            hb = HeartbeatClient("127.0.0.1", int(opts["watch_port"]),
                                 node_id=1, interval_ms=50)
            if opts.get("detector_port"):
                detector = HeartbeatClient(
                    "127.0.0.1", int(opts["detector_port"]),
                    node_id=10 + shard, interval_ms=50)

            def sample():
                while not stop_sampling.wait(0.0005):
                    lag["max"] = max(lag["max"], sess.lag)
                    lag["samples"] += 1

            threading.Thread(target=sample, daemon=True).start()
        path = os.path.join(out, f"port{shard}")
    if replicated:
        def snap():
            _wait_file(os.path.join(out, "snap"), timeout=600)
            with svc._service_lock():
                rec = {"digests": table_digests(tables),
                       "launches": _launch_counts(),
                       "versions": dict(svc.versions),
                       "applies": svc.apply_log.total,
                       "role": svc.role,
                       "replica_applied_seq": svc._replica_applied_seq,
                       "repl": svc.replica_state().get("repl"),
                       "tier": {n: t.tier_stats() for n, t in tables.items()
                                if hasattr(t, "tier_stats")}}
            if clock is not None:
                obs_export(out, name, clock, dump=False)
            _write(os.path.join(out, f"snap{shard}{tag}.json"),
                   json.dumps(rec))

        threading.Thread(target=snap, daemon=True).start()
    _write(path, svc.port)
    if backup:
        done = os.path.join(out, "done")
        deadline = time.monotonic() + 600
        while not os.path.exists(done) and not (
                svc.role == "primary" and svc.goodbyes >= nworkers):
            if time.monotonic() > deadline:
                raise TimeoutError("the backup was never released")
            time.sleep(0.01)
    elif not svc.wait_for_goodbyes(nworkers, timeout=300):
        raise TimeoutError(f"only {svc.goodbyes}/{nworkers} goodbyes "
                           f"({len(svc.apply_log)} pushes)")
    stop_sampling.set()
    target = expected_pushes(shape, shard, nshards, nworkers, cycles)
    if not replicated:
        assert len(svc.apply_log) == target, (len(svc.apply_log), target)
    info = {
        "apply_log": svc.apply_log, "versions": svc.versions,
        "rows_applied": svc.rows_applied, "meta": svc._meta,
        "tiers": svc.fused_tiers, "device": str(tables["deep"].device),
        "launches": _launch_counts(),
        "sparse_apply_s": samples["sparse_apply_s"],
        "apply_s": samples["apply_s"],
        "rows": svc.transport.sparse_rows_applied,
        "staging_s": svc.transport.staging_s,
        "native_loop": svc.native_loop, "admit": svc.admit_stats(),
        "upcalls": svc.transport.loop_upcalls,
        "loop_pushes": svc.transport.loop_pushes,
        "shm_frames": svc.transport.shm_frames,
        "shm_spills": svc.transport.shm_spill_frames,
        "codec_bytes": [svc.transport.codec_raw_bytes,
                        svc.transport.codec_enc_bytes]}
    if replicated:
        info.update({
            "expected": target, "applied": applied,
            "digests": table_digests(tables),
            "replica": svc.replica_state(),
            "promoted_at": promoted_at[0] if promoted_at else None,
            "detect_age_ms": watch.detect_age_ms if watch else None,
            "repl_entries": svc.transport.repl_entries,
            "repl_bytes": svc.transport.repl_bytes,
            "repl_ack_wait_s": samples["repl_ack_wait_s"],
            "lag": lag})
    if opts.get("tiered"):
        info["tier"] = {n: t.tier_stats() for n, t in tables.items()}
        info["row_sum"] = {n: t.row_sum() for n, t in tables.items()}
        info["cold_gather_s"] = samples["cold_gather_s"]
    if not opts.get("digests"):
        arrays = {}
        for name, emb in tables.items():
            arrays[name] = emb.table.cpu().numpy()
            for i, leaf in enumerate(state_leaves(emb.state())):
                arrays[f"{name}/state{i}"] = leaf.cpu().numpy()
        np.savez(os.path.join(out, f"sparse_tables{shard}{tag}.npz"),
                 **arrays)
    if clock is not None:
        obs_export(out, name, clock)
    with open(os.path.join(out, f"sparse_server{shard}{tag}.json"), "w") as f:
        json.dump(info, f)
    if detector is not None:
        detector.close(goodbye=True)
    if watch is not None:
        watch.close()
    if hb is not None:
        hb.close(goodbye=True)
    svc.stop()
    ps.shutdown()


def run_sparse_worker(ports, out, worker, cycles, device, shape,
                      nworkers=0, record=False, opts=None):
    """``cycles`` cycles against the sparse servers: even cycles pull then
    push, odd ones push_pull (the reference test's mix), ids and grads as
    tensors on ``device``; once connected it waits until ``nworkers``
    workers are (a file barrier), so their cycles overlap. Writes
    ``sparse_worker<id>.json`` (versions, cycle and op times, the shared
    window, the lane's and the codec's counters, which payload keys were
    encoded and their largest sizes) and, with ``record``, every pulled
    row set and the per-server versions its replies carried
    (``sparse_pulls<id>.npz``). ``opts``: ``shm``, ``compress``; and for
    replication: ``replicas`` (dial each shard's replica set
    ``port<s>|port<s>b``), ``pause_at`` (after that many cycles write
    ``paused<id>`` and wait for ``resume``), ``cue_at`` (after that many
    cycles write ``cue<id>`` and go on); ``obs`` (:func:`obs_start`, its
    clock shard 0's primary) with ``trace``, ``[first, end)``: the cycles
    sampled at 1.0, the trace and the flight ring written at the end as
    ``w<id>``."""
    import torch

    from ps_tpu_torch.backends.remote_sparse import connect_sparse

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    opts = opts or {}
    uri = ",".join(f"127.0.0.1:{p}"
                   for p in _read_ports(str(ports), out).split(","))
    if opts.get("replicas"):
        backups = _read_ports(str(ports), out, suffix="b").split(",")
        uri = ",".join(f"{p}|127.0.0.1:{b}"
                       for p, b in zip(uri.split(","), backups))
    from ps_tpu_torch import obs

    clock = obs_start(out, opts, f"w{worker}", clock_port="port0")
    traced = range(*opts.get("trace", (0, 0)))
    w = connect_sparse(uri, worker, sparse_spec(shape),
                       shm=bool(opts.get("shm")),
                       compress=opts.get("compress"),
                       failover_timeout=60.0 if opts.get("replicas")
                       else None)
    samples = keep_samples(w.transport)
    keys = {}  # payload key -> [times encoded, times raw, largest bytes]
    encode = w._encode_push_tree

    def encode_and_count(arrays):
        wire, enc = encode(arrays)
        for k, a in arrays.items():
            row = keys.setdefault(k, [0, 0, 0])
            row[0 if k in enc else 1] += 1
            row[2] = max(row[2], int(np.asarray(a).nbytes))
        return wire, enc

    w._encode_push_tree = encode_and_count
    if nworkers:
        open(os.path.join(out, f"sparse_ready{worker}"), "w").close()
        deadline = time.monotonic() + 300
        while not all(os.path.exists(os.path.join(out, f"sparse_ready{i}"))
                      for i in range(nworkers)):
            if time.monotonic() > deadline:
                raise TimeoutError("the other workers never connected")
            time.sleep(0.005)
    ids = sparse_ids(shape, worker, cycles)
    cycle_s, starts, versions, pulled = [], [], [], {}
    for c in range(cycles):
        idt = torch.from_numpy(ids[c]).to(dev)
        pushes = {n: (idt, torch.from_numpy(sparse_grads(
            shape, worker, c, n, ids[c].size)).to(dev))
            for n in SPARSE_TABLES}
        req = {n: idt for n in SPARSE_TABLES}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if shape == "small":
            time.sleep(0.003 * ((worker * 7 + c * 3) % 5))  # interleave
        if clock is not None:
            obs.tracer().sample = 1.0 if c in traced else 0.0
        t0 = time.perf_counter()
        if c % 2 == 0:
            rows = w.pull(req)
            seen = {n: list(v) for n, v in w._versions.items()}
            w.push(pushes)
        else:
            rows = w.push_pull(pushes, req)
            seen = {n: list(v) for n, v in w._versions.items()}
        cycle_s.append(time.perf_counter() - t0)
        starts.append(t0)
        if c + 1 == opts.get("cue_at"):
            _write(os.path.join(out, f"cue{worker}"), c)
        if c + 1 == opts.get("pause_at"):
            _write(os.path.join(out, f"paused{worker}"), c)
            _wait_file(os.path.join(out, "resume"), timeout=600)
        versions.append(seen)  # what the replies carrying the rows said
        for n, (_, dim) in sparse_spec(shape).items():
            r = rows[n]
            assert r.device == dev and tuple(r.shape) == (ids[c].size, dim)
            assert bool(torch.isfinite(r).all())
            if record:
                pulled[f"{c}/{n}"] = r.cpu().numpy()
    end = time.perf_counter()
    if record:
        np.savez(os.path.join(out, f"sparse_pulls{worker}.npz"), **pulled)
    with open(os.path.join(out, f"sparse_worker{worker}.json"), "w") as f:
        json.dump({
            "worker": worker, "versions": versions,
            "totals": w.versions(), "cycle_s": cycle_s,
            "window": [starts[1] if cycles > 1 else starts[0], end],
            "ops": {k: samples[k + "_s"]
                    for k in ("pull", "push", "push_pull")},
            "staging_s": w.transport.staging_s,
            "bytes": [w.bytes_pushed, w.bytes_pulled],
            "lane": w.transport.lane(), "shm_frames": w.transport.shm_frames,
            "shm_spills": w.transport.shm_spill_frames,
            "compress": w.compress, "encoded_keys": keys,
            "starts": starts, "failovers": w.transport.failovers,
            "failover_s": samples["failover_s"],
            "epochs": w._epochs,
            "codec_bytes": [w.transport.codec_raw_bytes,
                            w.transport.codec_enc_bytes]}, f)
    w.close()
    if clock is not None:
        obs.tracer().sample = 0.0
        obs_export(out, f"w{worker}", clock)


# -- the read path's processes (backends/remote_sparse.py's READ) ------------

#: a reader's hot id-set: one Criteo-like batch of this seed plus its index
READ_SEED = 1000


def read_hot_ids(shape: str, reader: int) -> np.ndarray:
    """Reader ``reader``'s hot id-set: the global ids of one batch drawn
    by the sparse roles' generator (13,312 Zipf-skewed ids at "wd")."""
    return sparse_ids(shape, READ_SEED + reader, 1)[0]


def _poll(path: str, stop: str = None, timeout: float = 600.0) -> bool:
    """Until ``path`` exists (True) or ``stop`` does (False)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if stop is not None and os.path.exists(stop):
            return False
        if time.monotonic() > deadline:
            raise TimeoutError(f"never appeared: {path}")
        time.sleep(0.002)
    return True


def _read_snap(svc, tables, digests=False) -> dict:
    """A read server's counters (and with ``digests`` its tables'), under
    its lock."""
    with svc._service_lock():
        t = svc.transport
        return {
            "role": svc.role, "launches": _launch_counts(),
            "applies": svc.apply_log.total, "versions": dict(svc.versions),
            "reads_served": t.reads_served,
            "not_modified": t.read_not_modified,
            "delta_rows": t.read_delta_rows,
            "cache": (svc._nloop.cache_stats() if svc._nloop is not None
                      else None),
            "native_read_cache": svc._native_read_cache,
            "digests": table_digests(tables) if digests else None}


def run_read_server(out, shard, nshards, device, shape, opts):
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_sparse import SparsePSService

    tag = opts.get("tag", "")
    ps.init(backend="cuda", device=device)
    tables = sparse_tables(shape, shard, nshards)
    svc = SparsePSService(
        tables, shard=shard, num_shards=nshards,
        total_rows={n: v for n, (v, _) in sparse_spec(shape).items()},
        native_loop=bool(opts.get("native_loop")),
        backup=bool(opts.get("backup")))
    if opts.get("attach"):
        back = os.path.join(out, f"port{shard}{opts['attach']}")
        _wait_file(back, timeout=300)
        with open(back) as f:
            svc.attach_backup("127.0.0.1", int(f.read()), ack="sync")
    _write(os.path.join(out, f"port{shard}{tag}"), svc.port)
    k, stop = 0, os.path.join(out, "exit")
    while _poll(os.path.join(out, f"cmd{k}.json"), stop):
        with open(os.path.join(out, f"cmd{k}.json")) as f:
            cmd = json.load(f)
        if cmd["op"] == "cache" and svc._nloop is not None:
            svc.set_read_cache_bytes(cmd["bytes"])
        _write(os.path.join(out, f"snap{k}_{shard}{tag}.json"),
               json.dumps(_read_snap(svc, tables, cmd.get("digests"))))
        k += 1
    svc.stop()
    ps.shutdown()


def run_read_pusher(out, cycles, device, shape):
    """Worker 0's cycles of the sparse roles (even: pull then push, odd:
    push_pull), on ``device``, against the primaries, round and round
    from ``push_go`` until ``push_stop``; ``pusher.json`` holds each
    cycle's start and length."""
    import torch

    from ps_tpu_torch.backends.remote_sparse import connect_sparse

    dev = torch.device(device)
    uri = ",".join(f"127.0.0.1:{p}"
                   for p in _read_ports("@2", out).split(","))
    w = connect_sparse(uri, 0, sparse_spec(shape))
    ids = sparse_ids(shape, 0, cycles)
    grads = [{n: sparse_grads(shape, 0, c, n, ids[c].size)
              for n in SPARSE_TABLES} for c in range(cycles)]
    _write(os.path.join(out, "pusher_ready"), 1)
    _poll(os.path.join(out, "push_go"))
    stop = os.path.join(out, "push_stop")
    starts, cycle_s, c = [], [], 0
    while not os.path.exists(stop):
        i = c % cycles
        idt = torch.from_numpy(ids[i]).to(dev)
        pushes = {n: (idt, torch.from_numpy(grads[i][n]).to(dev))
                  for n in SPARSE_TABLES}
        req = {n: idt for n in SPARSE_TABLES}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if c % 2 == 0:
            w.pull(req)
            w.push(pushes)
        else:
            w.push_pull(pushes, req)
        cycle_s.append(time.perf_counter() - t0)
        starts.append(t0)
        c += 1
    _write(os.path.join(out, "pusher.json"), json.dumps({
        "starts": starts, "cycle_s": cycle_s, "versions": w.versions()}))
    w.close()


def run_read_reader(out, reader, shape):
    """Reader ``reader``: ``read_rows`` of its hot id-set over the replica
    sets at bound 0 ("layered") or over the primaries alone ("primary"),
    for a window's seconds, recording each read's latency and wire bytes;
    "final" (the pusher stopped) reads once more conditionally and once
    with a full read (``read_conditional`` off), and holds the two equal
    bitwise and equal to a pull."""
    from ps_tpu_torch.backends.remote_sparse import connect_sparse

    ports = _read_ports("@2", out).split(",")
    backs = _read_ports("@2", out, suffix="b").split(",")
    spec = sparse_spec(shape)
    layered = connect_sparse(",".join(
        f"127.0.0.1:{p}|127.0.0.1:{b}" for p, b in zip(ports, backs)),
        100 + reader, spec, read_staleness=0)
    primary = connect_sparse(",".join(f"127.0.0.1:{p}" for p in ports),
                             100 + reader, spec)
    ids = read_hot_ids(shape, reader)
    req = {n: ids for n in spec}
    _write(os.path.join(out, f"reader_ready{reader}"), 1)
    k, stop = 0, os.path.join(out, "exit")
    while _poll(os.path.join(out, f"go{k}.json"), stop):
        with open(os.path.join(out, f"go{k}.json")) as f:
            go = json.load(f)
        rec = {"reader": reader, "mode": go["mode"]}
        if go["mode"] == "final":
            held = layered.read_rows(req)
            b0 = layered.bytes_pulled
            again = layered.read_rows(req)  # a warm read, nothing moved
            warm = layered.bytes_pulled - b0
            layered.read_conditional = False
            b0 = layered.bytes_pulled
            full = layered.read_rows(req)
            rec["bytes_full"] = layered.bytes_pulled - b0
            rec["bytes_warm"] = warm
            layered.read_conditional = True
            pulled = primary.pull(req)
            rec["equal"] = all(
                np.array_equal(held[n].numpy(), full[n].numpy())
                and np.array_equal(again[n].numpy(), full[n].numpy())
                and np.array_equal(full[n].numpy(), pulled[n].numpy())
                for n in spec)
        elif reader < int(go["readers"]):
            w = layered if go["mode"] == "layered" else primary
            t = w.transport
            before = (t.reads_replica, t.read_fallbacks)
            lat, nbytes = [], []
            end = time.perf_counter() + float(go["seconds"])
            while time.perf_counter() < end:
                b0 = w.bytes_pulled
                t0 = time.perf_counter()
                rows = w.read_rows(req)
                lat.append(time.perf_counter() - t0)
                nbytes.append(w.bytes_pulled - b0)
            assert all(tuple(rows[n].shape) == (ids.size, d)
                       for n, (_, d) in spec.items())
            rec.update({"lat": lat, "bytes": nbytes,
                        "replica": t.reads_replica - before[0],
                        "fallbacks": t.read_fallbacks - before[1]})
        _write(os.path.join(out, f"read{k}_{reader}.json"), json.dumps(rec))
        k += 1
    layered.close()
    primary.close()


def sparse_replay(infos, shape, nworkers, cycles, pulls=None,
                  fused_apply=None, compress=None, by_cycle=False,
                  tiered=None):
    """Replay each shard's apply log (``infos``, one server dump a shard,
    in shard order) through the port's one-process tables on the device
    ``ps_tpu_torch.init`` chose; returns ``(tables, checked)`` with
    ``tables[shard][name]`` the replayed ``SparseEmbedding``.

    ``pulls`` (``{worker: (sparse_pulls npz, sparse_worker json)}``) are
    held to the replay: each pulled row set's rows from shard s must equal,
    bitwise, the replayed table at the version shard s's reply carried.
    ``checked`` counts the (pull, shard, table) row sets held.

    ``compress`` (``{worker: spec}``, each worker's resolved spec) replays
    the grads the servers decoded from each worker's codec.

    ``by_cycle`` replays each dump's ``applied`` (worker, cycle) order
    instead of each worker's routed pushes in turn (a replicated run with
    async ack may lose pushes of the window: what was applied is replayed,
    and nothing need have applied all). ``tiered`` replays through
    tiered tables (:func:`sparse_tables`)."""
    import torch

    from ps_tpu_torch.backends.remote_sparse import row_range

    nshards = len(infos)
    ids = {w: sparse_ids(shape, w, cycles) for w in range(nworkers)}
    out, checked = [], 0
    for s, info in enumerate(infos):
        tables = sparse_tables(shape, s, nshards, fused_apply=fused_apply,
                               tiered=tiered)
        waiting = {}  # (name, version) -> [(worker, cycle)]
        for w, (_, rec) in (pulls or {}).items():
            for c, vs in enumerate(rec["versions"]):
                for name in tables:
                    waiting.setdefault((name, vs[name][s]), []).append((w, c))

        def positions(w, c, name):
            lo, hi = row_range(s, nshards, sparse_spec(shape)[name][0])
            return np.nonzero((ids[w][c] >= lo) & (ids[w][c] < hi))[0], lo

        def check(name, version):
            nonlocal checked
            table = tables[name].table
            for w, c in waiting.pop((name, version), ()):
                pos, lo = positions(w, c, name)
                if not pos.size:
                    continue
                got = torch.from_numpy(pulls[w][0][f"{c}/{name}"][pos])
                want = table.index_select(0, torch.from_numpy(
                    ids[w][c][pos] - lo).to(table.device).long())
                if not torch.equal(got.to(table.device), want):
                    raise AssertionError(
                        f"worker {w} cycle {c}: {name} rows of shard {s} "
                        f"differ from the replay at version {version}")
                checked += 1

        version = {name: 0 for name in tables}
        for name in tables:
            check(name, 0)
        streams = {w: routed_pushes(shape, w, s, nshards, cycles, ids[w],
                                    compress=(compress or {}).get(w))
                   for w in range(nworkers)}
        if by_cycle:
            pushes = (_routed(shape, w, c, ids[w][c], s, nshards)
                      for w, c in info["applied"])
        else:
            pushes = (next(streams[w]) for w in info["apply_log"])
        for per in pushes:
            for name, (i, g) in per.items():
                tables[name].push(i, g)
                version[name] += 1
                check(name, version[name])
        for w in range(nworkers):  # the log consumed every routed push
            assert by_cycle or next(streams[w], None) is None, (s, w)
        assert version == info["versions"], (s, version, info["versions"])
        # a pull at a version the replay never reached matters only when
        # the pull asked this shard for rows
        unreached = [(k, w, c) for k, wcs in waiting.items()
                     for w, c in wcs if positions(w, c, k[0])[0].size]
        assert not unreached, f"pulls at versions the replay never " \
                              f"reached: {unreached[:3]}"
        out.append(tables)
    return out, checked


def main(argv) -> int:
    import torch

    torch.set_num_threads(1)  # OMP_NUM_THREADS=1 too: see spawn()
    role = argv[1]
    if role == "sparse-server":
        out, nworkers, cycles, shard, nshards, device, shape = argv[2:9]
        opts = json.loads(argv[9]) if len(argv) > 9 else None
        run_sparse_server(out, int(nworkers), int(cycles), int(shard),
                          int(nshards), device, shape, opts)
    elif role == "sparse-worker":
        ports, out, worker, cycles, device, shape, nworkers, record = \
            argv[2:10]
        opts = json.loads(argv[10]) if len(argv) > 10 else None
        run_sparse_worker(ports, out, int(worker), int(cycles), device,
                          shape, int(nworkers), record == "1", opts)
    elif role == "replica-backup":
        out, watch_port, timeout_ms, device = argv[2:6]
        run_replica_backup(out, int(watch_port), int(timeout_ms), device,
                           json.loads(argv[6]) if len(argv) > 6 else None)
    elif role == "replica-primary":
        out, watch_port, ack, window, device = argv[2:7]
        run_replica_primary(out, int(watch_port), ack, int(window), device,
                            loop=len(argv) > 7 and argv[7] == "1",
                            opts=json.loads(argv[8]) if len(argv) > 8
                            else None)
    elif role == "agg-server":
        out, uri, group_size, opts = argv[2:6]
        run_agg_server(out, uri, int(group_size), json.loads(opts))
    elif role == "read-server":
        out, shard, nshards, device, shape, opts = argv[2:8]
        run_read_server(out, int(shard), int(nshards), device, shape,
                        json.loads(opts))
    elif role == "read-pusher":
        out, cycles, device, shape = argv[2:6]
        run_read_pusher(out, int(cycles), device, shape)
    elif role == "read-reader":
        out, reader, shape = argv[2:5]
        run_read_reader(out, int(reader), shape)
    elif role == "replica-worker":
        out, steps, kill_at, device = argv[2:6]
        run_replica_worker(out, int(steps), int(kill_at), device)
    elif role == "server":
        out, nworkers, cycles = argv[2:5]
        shard = int(argv[5]) if len(argv) > 5 else None
        nshards = int(argv[6]) if len(argv) > 6 else None
        run_server(out, int(nworkers), int(cycles), shard, nshards)
    elif role == "worker":
        ports, out, worker, cycles = argv[2:6]
        nworkers = int(argv[6]) if len(argv) > 6 else None
        opts = json.loads(argv[7]) if len(argv) > 7 else None
        run_worker(ports, out, int(worker), int(cycles), nworkers or None,
                   opts)
    else:
        rank, k, port, hb_base, victim, out = argv[2:8]
        run_drill(int(rank), int(k), int(port), int(hb_base), int(victim),
                  out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
