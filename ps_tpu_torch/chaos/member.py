"""Subprocess fleet members for the chaos soak (``chip_smoke.py`` phase 26).

SIGSTOP and SIGKILL only mean something against a REAL process — an
in-process service cannot be frozen mid-syscall or die without taking
the harness with it. This module is the ``python -m
ps_tpu_torch.chaos.member`` entry a soak spawns for exactly those
targets:

``shard``
    A plain elastic member: deterministic params, async KVStore,
    ``AsyncPSService(coordinator=...)`` registering and load-reporting
    like any production shard. The soak SIGSTOPs it to freeze
    heartbeats, reports, and serve threads at once.
``primary``
    One half of a replica pair: attaches replication to the soak
    process's backup, beats the backup's PromotionWatch, and registers
    with the coordinator under the PAIR uri (``primary|backup``) — the
    spelling the autopilot's re-seed rule keys on. The soak SIGKILLs
    it; promotion and the policy re-seed own everything after.

Both roles write ``<out>/<name>.port`` (``pid\\nport``) once serving and
exit when ``<out>/done`` appears (the unkilled path). Params come from
:func:`make_tree` — the soak builds byte-identical trees on its side, so
a replica pair starts from one state point by construction. The params
live on ``--device`` (``cuda`` by default; the CPU tests pass ``cpu``);
with no card and no ``--device cpu`` the member fails, it never falls
back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import numpy as np


def make_tree(spec: Dict[str, int], seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic flat params: ``{key: float32[dim]}`` from one seeded
    generator, keys consumed in sorted order — every process that calls
    this with the same spec/seed holds bitwise-identical arrays."""
    rng = np.random.default_rng(int(seed))
    return {k: rng.standard_normal((int(spec[k]),)).astype(np.float32)
            for k in sorted(spec)}


def parse_keys(arg: str) -> Dict[str, int]:
    """``"k0:4096,k1:1024"`` → ``{"k0": 4096, "k1": 1024}`` (dims, so a
    drill can stage byte skew for the leveling rebalance to undo)."""
    out: Dict[str, int] = {}
    for part in arg.split(","):
        name, _, dim = part.partition(":")
        out[name.strip()] = int(dim or 256)
    return out


def _write_port_file(path: str, port: int) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(f"{os.getpid()}\n{port}\n")
    os.rename(tmp, path)  # atomic: the soak never reads a torn file


def _wait_done(out_dir: str, timeout_s: float = 600.0) -> None:
    deadline = time.monotonic() + timeout_s
    done = os.path.join(out_dir, "done")
    while time.monotonic() < deadline and not os.path.exists(done):
        time.sleep(0.1)


def spawn(role: str, name: str, out_dir: str, coord: str, keys_spec: str,
          seed: int, extra=(), device: str = "cuda", num_workers: int = 2,
          timeout_s: float = 120.0):
    """Start ``python -m ps_tpu_torch.chaos.member role`` and wait for its
    port file: ``(proc, pid, port, log)``. Its output goes to
    ``<out_dir>/<name>.log``; a member that exits or never serves raises
    with the log's tail."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    log_path = os.path.join(out_dir, f"{name}.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ps_tpu_torch.chaos.member", role,
         "--out", out_dir, "--name", name, "--coord", coord,
         "--keys", keys_spec, "--seed", str(seed),
         "--num-workers", str(num_workers), "--device", device, *extra],
        stdout=log, stderr=log, env=env, cwd=root)
    path = os.path.join(out_dir, f"{name}.port")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        if os.path.exists(path):
            with open(path) as f:
                pid, port = (int(x) for x in f.read().split())
            return proc, pid, port, log
        time.sleep(0.1)
    log.close()
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    with open(log_path) as f:
        tail = f.read()[-2000:]
    raise RuntimeError(f"chaos member {name!r} never served: {tail}")


def _mkstore(params, num_workers: int, device: str):
    import torch

    import ps_tpu_torch as ps

    ps.init(backend="cuda", device=device, mode="async",
            num_workers=num_workers, dc_lambda=0.0)
    st = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    st.init({k: torch.from_numpy(v) for k, v in params.items()})
    return st


def run_shard(args) -> int:
    """SIGSTOP target: an ordinary coordinator-registered member."""
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    params = make_tree(parse_keys(args.keys), args.seed)
    svc = AsyncPSService(_mkstore(params, args.num_workers, args.device),
                         bind="127.0.0.1", coordinator=args.coord)
    _write_port_file(os.path.join(args.out, f"{args.name}.port"), svc.port)
    _wait_done(args.out)
    svc.stop()
    return 0


def run_primary(args) -> int:
    """SIGKILL target: replica-pair primary, registered under the pair
    uri so the coordinator (and its re-seed rule) see one replica SET."""
    from ps_tpu_torch.backends.remote_async import AsyncPSService
    from ps_tpu_torch.control.heartbeat import HeartbeatClient
    from ps_tpu_torch.elastic.member import CoordinatorMember

    params = make_tree(parse_keys(args.keys), args.seed)
    svc = AsyncPSService(_mkstore(params, args.num_workers, args.device),
                         bind="127.0.0.1")
    bhost, bport = args.backup.rsplit(":", 1)
    svc.attach_backup(bhost, int(bport), ack="sync")
    whost, wport = args.watch.rsplit(":", 1)
    hb = HeartbeatClient(whost, int(wport), node_id=args.watch_node,
                         interval_ms=50)
    pair_uri = f"127.0.0.1:{svc.port}|{args.backup}"
    key_bytes = {k: int(v.nbytes) for k, v in params.items()}

    def report() -> dict:
        s = svc._backup_session
        return {
            "keys": len(svc._key_order),
            "nbytes": sum(key_bytes.values()),
            "push_qps": 0.0,
            "repl": {"attached": bool(s is not None and not s.degraded),
                     "degraded": bool(s is not None and s.degraded),
                     "promoted": svc.promote_reason is not None},
        }

    member = CoordinatorMember(args.coord, pair_uri, key_bytes,
                               kind="dense", report=report,
                               report_ms=args.report_ms)
    _write_port_file(os.path.join(args.out, f"{args.name}.port"), svc.port)
    _wait_done(args.out)
    member.close()
    hb.close(goodbye=False)
    svc.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ps_tpu_torch.chaos.member")
    ap.add_argument("role", choices=["shard", "primary"])
    ap.add_argument("--out", required=True, help="handshake directory")
    ap.add_argument("--name", required=True, help="port-file stem")
    ap.add_argument("--coord", required=True, help="coordinator host:port")
    ap.add_argument("--keys", required=True, help="name:dim,name:dim,...")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--report-ms", type=int, default=200)
    ap.add_argument("--backup", default=None,
                    help="primary: backup host:port to attach")
    ap.add_argument("--watch", default=None,
                    help="primary: PromotionWatch host:port to beat")
    ap.add_argument("--watch-node", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the params live: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.role == "primary":
        if not (args.backup and args.watch):
            ap.error("primary needs --backup and --watch")
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            ap.error(f"--device {args.device}: no CUDA device here (pass "
                     f"--device cpu to run the member on the CPU)")
    if args.role == "primary":
        return run_primary(args)
    return run_shard(args)


if __name__ == "__main__":
    sys.exit(main())
