"""Processes of the port's van plane on the CPU, for the van tests.

This module holds no test. ``tests/test_torch_remote_async.py`` and
``tests/test_torch_van.py`` start processes of this file, which import
torch and the port and never jax, and kill each one after a wall-clock
limit, so nothing hangs:

    python tests/test_torch_van_harness.py server <out> <nworkers> <cycles> [<shard> <nshards>]
    python tests/test_torch_van_harness.py worker <ports> <out> <worker> <cycles> [<nworkers>]
    python tests/test_torch_van_harness.py drill <rank> <k> <port> <hb_base> <victim> <out>

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
  started.
- drill: rank ``rank`` of ``k`` gloo ranks with heartbeats on; the victim
  rank dies hard (``os._exit(17)``) after one step, the others poll
  ``check_health()`` until it raises and write what it named.

Every process of this file computes on one intra-op thread, as the
replays of its runs do (:func:`one_thread`). :func:`replay` replays a run
of the MNIST trainer's ``--role server|worker`` processes from its
servers' event logs; ``chip_smoke.py`` uses it too.
"""

from __future__ import annotations

import contextlib
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


def finish(procs, wall_s):
    """Wait for every process (killing all after ``wall_s`` seconds);
    returns their outputs."""
    outs = []
    try:
        deadline = time.monotonic() + wall_s
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        kill_all(procs)
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


def replay(event_logs, num_workers: int, device, witness=None,
           seed: int = 0, lr: float = 0.1, dc_lambda: float = 0.04,
           batch_size: int = 64):
    """Replay a run of the MNIST trainer's ``--role server|worker``
    processes from its servers' event logs (one log a shard, in shard
    order) through one-process ``AsyncCudaServer`` engines on ``device``;
    returns the final ``{key: tensor}`` of every key.

    Each worker's gradient is recomputed from what it pulled: its c-th
    push takes the gradient of its c-th batch at the params of its c-th
    pull, merged over the shards. Each log keeps its shard's order; a push
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
    and ``grad_err["largest"]`` the least and the largest ``‖g_p‖₂ / m``.
    """
    import torch

    from ps_tpu_torch.backends.cuda import AsyncCudaServer
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
    pulls = {}    # (worker, shard) -> trees pulled on ``device``
    pushes = {}   # (worker, shard) -> pushes replayed
    grads = {}    # (worker, cycle) -> one gradient a device
    diffs, norms = [], []  # a push's ‖g_witness - g‖₂ and ‖g‖₂
    cursors = [0] * nshards
    while any(c < len(log) for c, log in zip(cursors, event_logs)):
        moved = False
        for s, log in enumerate(event_logs):
            while cursors[s] < len(log):
                op, w = log[cursors[s]]
                if op == "pull":
                    trees = [e[s].pull_tree(worker=w) for e in engines]
                    pulls.setdefault((w, s), []).append(trees[0])
                else:
                    c = pushes.get((w, s), 0)
                    if (w, c) not in grads:
                        if any(len(pulls.get((w, t), [])) <= c
                               for t in range(nshards)):
                            break  # its pull on another shard comes first
                        kv = {}
                        for t in range(nshards):
                            kv.update(pulls[(w, t)][c])
                        batch = next(streams[w])
                        gs = []
                        for dev in devices:
                            on = {k: v.to(dev) for k, v in kv.items()}
                            _, g, _ = value_and_grad(
                                loss_fn, keymod.unflatten(treedef, on, order),
                                tuple(torch.as_tensor(x).to(dev)
                                      for x in batch))
                            gs.append(keymod.flatten_with_keys(g)[0])
                        for g in gs[1:]:
                            diffs.append(sum(float(
                                (g[k].cpu().double() - v.cpu().double())
                                .square().sum())
                                for k, v in gs[0].items()) ** 0.5)
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
    return finals[0], finals[1], {
        "witness": float((diffs / np.maximum(norms, median)).max()),
        "relative": float((diffs / norms).max()),
        "smallest": float(norms.min()) / median,
        "largest": float(norms.max()) / median}


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


def run_worker(ports, out, worker, cycles, nworkers=None):
    import torch

    import ps_tpu_torch as ps

    params = model_params()
    uri = ",".join(f"127.0.0.1:{p}" for p in str(ports).split(","))
    w = ps.connect_async(uri, worker, {k: torch.from_numpy(v)
                                       for k, v in params.items()})
    versions = []
    w.pull_all()
    if nworkers:
        open(os.path.join(out, f"pulled{worker}"), "w").close()
        deadline = time.monotonic() + 60
        while not all(os.path.exists(os.path.join(out, f"pulled{i}"))
                      for i in range(nworkers)):
            if time.monotonic() > deadline:
                raise TimeoutError("the other workers never pulled")
            time.sleep(0.005)
    for c in range(cycles):
        time.sleep(0.003 * ((worker * 7 + c * 3) % 5))  # interleave
        w.push_pull({k: torch.from_numpy(v) for k, v in
                     make_grads(params, worker, c).items()})
        versions.append(w.version)
    with open(os.path.join(out, f"worker{worker}.json"), "w") as f:
        json.dump({"worker": worker, "versions": versions,
                   "per_server_versions": w.versions}, f)
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


def main(argv) -> int:
    import torch

    torch.set_num_threads(1)  # OMP_NUM_THREADS=1 too: see spawn()
    role = argv[1]
    if role == "server":
        out, nworkers, cycles = argv[2:5]
        shard = int(argv[5]) if len(argv) > 5 else None
        nshards = int(argv[6]) if len(argv) > 6 else None
        run_server(out, int(nworkers), int(cycles), shard, nshards)
    elif role == "worker":
        ports, out, worker, cycles = argv[2:6]
        nworkers = int(argv[6]) if len(argv) > 6 else None
        run_worker(ports, out, int(worker), int(cycles), nworkers)
    else:
        rank, k, port, hb_base, victim, out = argv[2:8]
        run_drill(int(rank), int(k), int(port), int(hb_base), int(victim),
                  out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
