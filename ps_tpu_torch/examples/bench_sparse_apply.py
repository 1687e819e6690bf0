"""Time the fused sparse apply on one GPU, at three batch sizes.

Builds one or more versions of the sparse apply's kernels (the package's
``csrc/sparse_group.cu`` and ``csrc/sparse_apply.cu`` by default;
``--variant NAME=PATH`` adds another ``sparse_apply.cu``, e.g. a parent
commit's unpacked with ``git archive``: if a ``sparse_group.cu`` lies
beside it, both build and run as the package's do, else PATH is taken as
the first design, which sorts with ``torch.sort`` and launches one kernel
on the sorted ids). For each case (the Wide-&-Deep tables, deep adagrad
D = 16 and wide sgd D = 1, at batch 512, 4,096 and 65,536: N = 13,312,
106,496 and 1,703,936 Zipf-1.2 ids from ``criteo_batches`` into 2.6M
rows) it checks every version against the plain version (f32 within
rtol 1e-6, atol 1e-7) and times the whole apply, the grouping pass,
``torch.sort`` on the same ids and an empty kernel: device time per call,
20 calls queued behind a sleep kernel, median of 5 (as ``chip_smoke.py``).
It prints one JSON line per case, with the byte bound and each version's
share of it, then the card's name and power limit.

Run (on the GPU):
    python -m ps_tpu_torch.examples.bench_sparse_apply
    python -m ps_tpu_torch.examples.bench_sparse_apply --variant parent=/tmp/parent/ps_tpu_torch/ops/csrc/sparse_apply.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ps_tpu_torch.data.synthetic import criteo_batches
from ps_tpu_torch.models.wide_deep import WideDeepConfig
from ps_tpu_torch.ops import _build
from ps_tpu_torch.ops import sparse_apply as ops
from ps_tpu_torch.optim import rowwise

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TABLES = (("deep", "adagrad", 16), ("wide", "sgd", 1))
BATCHES = (512, 4_096, 65_536)


def _device_ms(fn, iters=20, reps=5, warmup=5):
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # the card runs the calls back to back
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return float(np.median(per_call))


def _compile(jobs):
    """Compile every (out, src), one nvcc each, all at once."""
    procs = []
    for out, src in jobs:
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")


class _Version:
    """One build of the kernels and how to call it."""

    def __init__(self, name, apply_src):
        self.name = name
        src = Path(apply_src)
        out_dir = _build.BUILD_DIR / "bench" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        self.grouped = (src.parent / "sparse_group.cu").exists()
        self.jobs = [(out_dir / "libsparse_apply.so", src)]
        if self.grouped:
            self.jobs.append((out_dir / "libsparse_group.so",
                              src.parent / "sparse_group.cu"))

    def load(self):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        self.apply = ctypes.CDLL(str(self.jobs[0][0]))
        if self.grouped:
            self.group = ctypes.CDLL(str(self.jobs[1][0]))
            self.group.ps_sparse_group_cluster.argtypes = [
                p, ll, ll, i, i, p, p, p, p, p, i, p]
            self.group.ps_sparse_group_sorted.argtypes = [
                p, p, ll, ll, p, p, p, p, p, i, p]
            self.apply.ps_sparse_apply.argtypes = [
                i, i, p, p, p, p, p, p, p, p, p, ll, ll, f, f, f, f, f, f, i,
                p]
        else:  # the first design: sorted ids and the int64 order
            self.apply.ps_sparse_apply.argtypes = [  # pslint: disable=PSL601 -- binds a parent's first-design ps_sparse_apply (a --variant source with no sparse_group.cu beside it), which took 20 arguments; the repo's own source is bound above
                i, i, p, p, p, p, p, p, p, ll, ll, ll, f, f, f, f, f, f, i, p]

    def _group(self, ids, num_rows):
        n = ids.shape[0]
        plan = ops.plan_group(n, num_rows)
        scratch = torch.empty((plan["scratch_ints"],), dtype=torch.int32,
                              device=ids.device)
        stream = torch.cuda.current_stream().cuda_stream
        if plan["path"] == "cluster":
            ids_s, perm, seg_start, seg_id, meta = torch.split(
                scratch, [n, n, n + 1, n, ops.META])
            rc = self.group.ps_sparse_group_cluster(
                ids.data_ptr(), n, num_rows, plan["passes"],
                plan["digit_bits"], ids_s.data_ptr(), perm.data_ptr(),
                seg_start.data_ptr(), seg_id.data_ptr(), meta.data_ptr(), 0,
                stream)
        else:
            ids_s, order = torch.sort(ids, stable=True)
            perm, seg_start, seg_id, meta, counts = torch.split(
                scratch, [n, n + 1, n, ops.META,
                          plan["scratch_ints"] - 3 * n - 1 - ops.META])
            rc = self.group.ps_sparse_group_sorted(
                ids_s.data_ptr(), order.data_ptr(), n, num_rows,
                perm.data_ptr(), seg_start.data_ptr(), seg_id.data_ptr(),
                meta.data_ptr(), counts.data_ptr(), 0, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: grouping launch failed ({rc})")
        return perm, seg_start, seg_id, meta

    def run(self, opt, table, state, ids, grads, group_only=False):
        rule, st_a, st_b, st_t = ops._kernel_args(opt, table, state)
        hp = opt.hyper
        b1, b2 = hp.get("b1", 0.0), hp.get("b2", 0.0)
        hyper = (hp["lr"], b1, b2, 1.0 - b1, 1.0 - b2, hp.get("eps", 0.0))
        stream = torch.cuda.current_stream().cuda_stream
        n, dim = grads.shape
        if self.grouped:
            perm, seg_start, seg_id, meta = self._group(ids, table.shape[0])
            if group_only:
                return
            rc = self.apply.ps_sparse_apply(
                rule, 0, table.data_ptr(), st_a, st_b, st_t, grads.data_ptr(),
                perm.data_ptr(), seg_start.data_ptr(), seg_id.data_ptr(),
                meta.data_ptr(), n, dim, *hyper, 0, stream)
        else:
            ids_s, order = torch.sort(ids, stable=True)
            rc = self.apply.ps_sparse_apply(
                rule, 0, table.data_ptr(), st_a, st_b, st_t, ids_s.data_ptr(),
                order.data_ptr(), grads.data_ptr(), n, dim, table.shape[0],
                *hyper, 0, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: apply launch failed ({rc})")


def _ids(batch, cfg):
    data = next(criteo_batches(batch, vocab_size=cfg.per_feature_vocab,
                               seed=2))
    return cfg.global_ids(torch.as_tensor(data["sparse"])).reshape(-1).cuda()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of another sparse_apply.cu to build")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sparse_apply: no CUDA device", file=sys.stderr)
        return 2
    versions = [_Version("repo", _build.CSRC / "sparse_apply.cu")]
    for spec in args.variant:
        name, path = spec.split("=", 1)
        versions.append(_Version(name, path))
    t0 = time.perf_counter()
    _compile([job for v in versions for job in v.jobs])
    for v in versions:
        v.load()
    print(f"built {len(versions)} versions in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    dev = torch.device("cuda", 0)
    cfg = WideDeepConfig()
    # an empty kernel, queued the same way: the floor one launch costs
    empty_ms = _device_ms(lambda: ops.empty_launch(dev))
    for batch in map(int, args.batches.split(",")):
        ids = _ids(batch, cfg)
        n = ids.numel()
        uniq = int(torch.unique(ids).numel())
        torch_sort_ms = _device_ms(lambda: torch.sort(ids, stable=True))
        for table_name, rule, dim in TABLES:
            opt = rowwise.make_rowwise(rule, learning_rate=0.05)
            g = torch.Generator(dev).manual_seed(5)
            table0 = 0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                        device=dev)
            grads = 1e-3 * torch.randn((n, dim), generator=g, device=dev)
            state0 = opt.init(table0)
            pt, pst = table0.clone(), ops._map_state(torch.Tensor.clone,
                                                      state0)
            ops._apply_torch(opt, pt, pst, *ops.batch_segment_sum(ids, grads))
            state_bytes = opt.state_scalars_per_row(dim) * 4
            nbytes = n * 4 + n * dim * 4 + 2 * uniq * (dim * 4 + state_bytes)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"table": table_name, "rule": rule, "batch": batch,
                   "ids": n, "unique_ids": uniq, "dim": dim, "bytes": nbytes,
                   "bound_ms": bound_ms, "torch_sort_ms": torch_sort_ms,
                   "empty_launch_ms": empty_ms,
                   "path": ops.plan_group(n, cfg.total_rows)["path"]}
            for v in versions:
                table = table0.clone()
                state = ops._map_state(torch.Tensor.clone, state0)
                v.run(opt, table, state, ids, grads)
                torch.cuda.synchronize()
                ok = torch.allclose(table, pt, rtol=1e-6, atol=1e-7) and all(
                    torch.allclose(a, b, rtol=1e-6, atol=1e-7) for a, b in
                    zip(ops.state_leaves(state), ops.state_leaves(pst)))
                ms = _device_ms(lambda: v.run(opt, table, state, ids, grads))
                entry = {"ok": ok, "ms": ms, "bound_share": bound_ms / ms}
                if v.grouped:
                    entry["sort_ms"] = _device_ms(lambda: v.run(
                        opt, table, state, ids, grads, group_only=True))
                row[v.name] = entry
                del table, state
            print(json.dumps(row), flush=True)
            del table0, state0, pt, pst, grads
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
