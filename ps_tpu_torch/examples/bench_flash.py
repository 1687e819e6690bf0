"""Time the flash-attention forward kernel against SDPA on one GPU.

Builds one or more versions of ``ps_tpu_torch/ops/csrc/flash_attention.cu``
(the package's source by default; ``--variant NAME=PATH[:FLAG,...]`` adds
another source, e.g. a parent commit's unpacked with ``git archive``, or
the same source under ``-D`` flags), then for each case (shape, mask,
causal) in ``--dtype`` (bfloat16, the default, or float32) checks every
version against the plain version (``_flash_fwd_torch``: bf16 within
1.6e-2, f32 within 2e-5, lse within 2e-5; at S <= 2048) and against
itself (bitwise, run to run), and times it and
``scaled_dot_product_attention`` on the same tensors: device time per
call, 20 calls queued behind a sleep kernel, median of 5 (as
``chip_smoke.py``). Each case also prints its bound: the larger of its
bytes over the card's memory rate and its operations (the causal
triangle's pairs only) over the card's peak for the dtype (bf16 tensor
cores, or f32 outside them), from ``ps_tpu_torch/utils/chips.py``. Prints
one JSON line per case, then the card's name and power limit.

Run (on the GPU):
    python -m ps_tpu_torch.examples.bench_flash
    python -m ps_tpu_torch.examples.bench_flash --dtype float32 --cases main,causal,lm_causal --variant old=/tmp/parent/ps_tpu_torch/ops/csrc/flash_attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ps_tpu_torch.ops import _build
from ps_tpu_torch.utils import chips

fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")

# name, batch, seq, heads, head_dim, mask, causal
CASES = (("main", 32, 512, 12, 64, "ones", False),
         ("padding", 32, 512, 12, 64, "padding", False),
         ("causal", 32, 512, 12, 64, "ones", True),
         ("d32", 32, 512, 12, 32, "ones", False),
         ("d16", 32, 512, 12, 16, "ones", False),
         ("ragged", 2, 200, 4, 64, "padding", True),
         ("dead_row", 4, 384, 4, 64, "row_masked", False),
         ("s2048", 8, 2048, 12, 64, "ones", False),
         ("s8192", 2, 8192, 12, 64, "ones", False),
         # the causal LM's attention (chip_smoke.py phase 18 (c))
         ("lm_causal", 2, 2048, 8, 64, "ones", True))
# kernel against plain: out's bound by dtype (lse is f32 in both, 2e-5)
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-5}


def _device_ms(fn, iters=20, reps=5, warmup=10):
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


def _build_variants(variants):
    """Compile every (name, source, flags), one nvcc each, all at once."""
    out_dir = _build.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, flags in variants:
        out = out_dir / f"libflash-{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), src]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_flash_attention_fwd.argtypes = [i, i, p, p, p, p, p, p, ll, ll,
                                               ll, f, i, i, p]
        libs[name] = lib
    return libs


def _inputs(b, s, h, d, mask_kind, dtype, seed=5):
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn((b * h, s, d), generator=g, device=dev)
               .to(dtype) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    if mask_kind == "padding":
        mask = (torch.rand((b, s), generator=g, device=dev) < 0.7).to(
            torch.int32)
        mask[:, 0] = 1
    elif mask_kind == "row_masked":
        mask[-1] = 0
    return q, k, v, mask


def _run(lib, q, k, v, mask, causal, heads):
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    rc = lib.ps_flash_attention_fwd(
        int(q.dtype == torch.bfloat16), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), mask.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, s,
        heads, d ** -0.5, int(causal), 0,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out, lse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH[:FLAG,FLAG]: another source to build")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    variants = [("repo", str(_build.CSRC / "flash_attention.cu"), [])]
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        variants.append((name, path, [x for x in flags.split(",") if x]))
    t0 = time.perf_counter()
    libs = _build_variants(variants)
    print(f"built {len(libs)} versions in {time.perf_counter() - t0:.2f} s",
          flush=True)
    wanted = args.cases.split(",")
    card = torch.cuda.get_device_name(0)
    hbm = chips.peak_hbm_gbps(card) * 1e9
    peak = (chips.peak_bf16_tflops(card) if dtype == torch.bfloat16
            else chips.peak_f32_tflops(card)) * 1e12
    tol = TOL[dtype]
    for name, b, s, h, d, mask_kind, causal in CASES:
        if name not in wanted:
            continue
        q, k, v, mask = _inputs(b, s, h, d, mask_kind, dtype)
        # the score pairs the function needs: all, or the causal triangle
        flops = 4 * b * h * (s * (s + 1) // 2 if causal else s * s) * d
        nbytes = (4 * b * h * s * d * q.element_size() + b * h * s * 4
                  + b * s * 4)
        want = (fa._flash_fwd_torch(q, k, v, mask, d ** -0.5, causal, h)
                if s <= 2048 else None)
        qs, ks, vs = (t.reshape(b, h, s, d) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if causal:  # SDPA takes a causal flag or a mask; these cases pad none
            library = lambda: sdpa(qs, ks, vs, is_causal=True)  # noqa: E731
        else:
            keep = (mask > 0)[:, None, None, :]
            library = lambda: sdpa(qs, ks, vs, attn_mask=keep)  # noqa: E731
        row = {"case": name, "shape": [b * h, s, d], "dtype": args.dtype,
               "mask": mask_kind, "causal": causal, "flops": flops,
               "bytes": nbytes,
               "bound_ms": max(flops / peak, nbytes / hbm) * 1e3,
               "library_ms": _device_ms(library)}
        for vname, lib in libs.items():
            out, lse = _run(lib, q, k, v, mask, causal, h)
            again, _ = _run(lib, q, k, v, mask, causal, h)
            torch.cuda.synchronize()
            entry = {"deterministic": torch.equal(out, again)}
            if want is not None:
                entry["max_abs_err"] = float((out.float() - want[0].float())
                                             .abs().max())
                entry["ok"] = (
                    torch.allclose(out.float(), want[0].float(), rtol=tol,
                                   atol=tol)
                    and torch.allclose(lse, want[1], rtol=2e-5, atol=2e-5))
            ms = _device_ms(lambda: _run(lib, q, k, v, mask, causal, h))
            entry.update(ms=ms, tflops=flops / ms / 1e9)
            row[vname] = entry
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
