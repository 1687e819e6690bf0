"""Time the traffic of ``tests/test_torch_chaos.py::
test_noisy_neighbor_raises_the_targets_apply_window_mean`` (holds no test).

Drives the test's set-up (two dense shards and a coordinator in this
process, one worker, the grinder on shard 1 for 2 s) and records each
shard's per-push apply seconds (``record_apply``), the worker's
``push_pull`` durations and the grinder's holds, then prints one line a
run: the coordinator's window means the test asserts on, how many of
shard 1's applies waited out a hold (> 5 ms), and shard 0's tail.

    python tests/torch_noisy_neighbor_timing.py --runs 6            # back to back
    python tests/torch_noisy_neighbor_timing.py --runs 6 --jitter 0.06
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import test_torch_chaos as T  # noqa: E402

import ps_tpu_torch  # noqa: E402
from ps_tpu_torch.backends.remote_async import (  # noqa: E402
    AsyncPSService,
    connect_async,
)
from ps_tpu_torch.chaos import ChaosInjector  # noqa: E402
from ps_tpu_torch.elastic.coordinator import Coordinator  # noqa: E402


def run(jitter: float, seed: int) -> dict:
    T._init()
    tree = T.port_member.make_tree({"a0": 256, "a1": 256, "b0": 256,
                                    "b1": 256}, seed=9)
    coord = Coordinator(bind="127.0.0.1", report_ms=100,
                        telemetry_window_s=2.0)
    ca = f"127.0.0.1:{coord.port}"
    svcs, applies = [], {0: [], 1: []}
    for i, keys in enumerate((("a0", "a1"), ("b0", "b1"))):
        svc = AsyncPSService(T._store({k: tree[k] for k in keys}),
                             bind="127.0.0.1", coordinator=ca)
        record = svc.transport.record_apply

        def timed(sec, i=i, record=record):
            applies[i].append(sec)
            record(sec)

        svc.transport.record_apply = timed
        svcs.append(svc)
    T._wait(lambda: len(coord.table().shards) == 2, 10.0, "registration")
    w = connect_async(None, 0, T._like(tree), coordinator=ca)
    w.pull_all()
    grads = T._full(tree, 1e-3)
    lock, holds = svcs[1]._service_lock(), []

    class Timed:
        def __enter__(self):
            lock.acquire()
            self.t = time.monotonic()

        def __exit__(self, *exc):
            holds.append(time.monotonic() - self.t)
            lock.release()

    svcs[1]._service_lock = Timed
    inj = ChaosInjector(seed=1)
    inj.noisy_neighbor(svcs[1], 2.0, hold_s=0.05)
    rng = np.random.default_rng(seed)
    pushes = []
    t_end = time.monotonic() + 2.0
    while time.monotonic() < t_end:
        t0 = time.monotonic()
        w.push_pull(grads)
        pushes.append(time.monotonic() - t0)
        if jitter:
            time.sleep(rng.uniform(0.0, jitter))
    inj.join()
    time.sleep(0.5)
    means = {}
    for i, s in enumerate(svcs):
        [name] = [m for m in coord.tsdb.members()
                  if m.endswith(f":{s.port}")]
        means[i] = coord.tsdb.member_mean(name, "ps_server_apply_seconds")
    w.close()
    for s in svcs:
        s.stop()
    coord.stop()
    ps_tpu_torch.shutdown()
    return {"means": means, "applies": applies, "holds": holds,
            "pushes": pushes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="a uniform pause of up to this many seconds "
                         "after each push (0: back to back)")
    args = ap.parse_args()
    for k in range(args.runs):
        r = run(args.jitter, seed=k)
        a0, a1 = (np.array(r["applies"][i]) for i in (0, 1))
        m0, m1 = r["means"][0][0], r["means"][1][0]
        print(f"run {k}: passes={m1 > 5 * m0 and m1 > 0.005} "
              f"mean0={m0 * 1e3:.3f} ms mean1={m1 * 1e3:.3f} ms "
              f"pushes={len(r['pushes'])} "
              f"push_median={np.median(r['pushes']) * 1e3:.2f} ms "
              f"shard1_waited={int((a1 > 0.005).sum())}/{len(a1)} "
              f"shard0_over_3ms={int((a0 > 0.003).sum())}/{len(a0)} "
              f"shard0_max={a0.max() * 1e3:.2f} ms "
              f"holds={len(r['holds'])} "
              f"hold_median={np.median(r['holds']) * 1e3:.2f} ms",
              flush=True)


if __name__ == "__main__":
    main()
