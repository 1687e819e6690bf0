#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ps_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the port, from ps_tpu_torch/ops/csrc/, one
   nvcc for each source, all started together; then the flash library's
   SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG), and its kernels'
   registers and shared memory are printed;
3. sparse apply vs its plain version on the card: the sweep (4 id
   distributions x sgd/adagrad/adam x f32/bf16) and one Zipf batch at the
   Wide-&-Deep shapes per rule, type and table width; determinism; the
   arrival order of a hot id's sum against a host oracle, bitwise;
4. the Wide-&-Deep path: the composite step, first at a small size
   against the same step on the CPU, then at the full published width
   (26 x 100,000 rows, D = 16, MLP 256/128/64, batch 512) for 50 steps
   through ps_tpu_torch.init(backend='cuda'), with the kernel launch
   counts read around it;
5. sparse-apply timings at that path's shapes with CUDA events: the
   kernel's device time (with and without the wrapper's sort), what a
   caller of the wrapper waits, and the plain version;
6. flash attention vs its plain version on the card: f32/bf16 x causal x
   4 masks (all ones, random padding, a fully masked batch row, key 0
   masked) at the tests' shape (B 2, S 128, h 4) with d 16 and 32, a
   ragged length (B 2, S 200, h 4, d 64) and BERT-base's (B 32, S 512,
   h 12, d 64); exact zeros and lse = -1e30 on rows that
   attend nothing; determinism; the gradients through the kernel against
   the plain forward's through the same backward;
7. the BERT path: a tiny BERT (flash, f32, seq 128, batch 16) for 3 LAMB
   steps on the card against the CPU; BERT-base in f32 with flash against
   full attention on two padded sequences of 512; then the main path,
   BERT-base MLM in bf16 with flash attention, seq 512, global batch 32,
   server-side LAMB, 20 steps through ps_tpu_torch.init(backend='cuda'),
   with the flash launch count read around it;
8. flash-attention timings at the main path's shape ([384, 512, 64]
   bf16): the kernel's device time, its TFLOP/s and share of the bound,
   what a caller waits, the plain version and
   scaled_dot_product_attention as the yardstick.

It prints one JSON line per timed kernel, then the kernels line, then
``{"ok": true, "device": {...}}`` as its last line. Without a GPU, or
without the rest of the repository beside it, it fails before printing
any result.
"""

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores, the same sheet
RTOL, ATOL = 1e-6, 1e-7    # f32; bf16 is held to one bf16 ulp
STEPS, BATCH = 50, 512
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: _device_ms's head start
SOURCE = "ps_tpu_torch/ops/csrc/sparse_apply.cu"
REPLACES = "ps_tpu/ops/sparse_apply.py:297"
# flash attention: the kernel sums keys in its own order, so f32 is held to
# the reference's flash-vs-einsum bound and bf16 to two bf16 ulps (p and
# the output are rounded to bf16 after sums taken in different orders)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
FLASH_SOURCE = "ps_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = "ps_tpu/ops/flash_attention.py:136"
BERT_STEPS, BERT_BATCH, BERT_SEQ = 20, 32, 512


def log(msg):
    print(msg, flush=True)


def _call_ms(fn, iters=100, warmup=10):
    """What a caller waits for one call: the median over ``iters`` calls of
    the time between CUDA events recorded around each, after ``warmup``
    calls. Where the card idles waiting for the host, that wait is in it."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _device_ms(fn, iters=20, reps=5, warmup=10):
    """Device time per call: ``iters`` calls queued behind a sleep kernel,
    so the card runs them back to back and never waits for the host;
    (end - start) / iters, the median of ``reps`` such runs. ``iters`` stays
    small enough that the launch queue never fills (a full queue blocks
    the host until the sleep ends). Raises if queueing took longer than
    the sleep lasted."""
    for _ in range(warmup):
        fn()
    before = torch.cuda.Event(enable_timing=True)
    after = torch.cuda.Event(enable_timing=True)
    before.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    after.record()
    torch.cuda.synchronize()
    sleep_ms = before.elapsed_time(after)
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms >= sleep_ms:
            raise AssertionError(f"queueing {iters} calls took {queued_ms:.1f} "
                                 f"ms, longer than the {sleep_ms:.1f} ms sleep")
        per_call.append(start.elapsed_time(end) / iters)
    return float(np.median(per_call))


def _bound_ms(ids, dim, opt, table_bytes):
    """Least time for one apply: each input read once (ids, grads), each
    touched row and its state read and written once, at the HBM rate."""
    n = ids.numel()
    u = int(torch.unique(ids[ids >= 0]).numel())
    state_bytes = opt.state_scalars_per_row(dim) * 4
    nbytes = n * 4 + n * dim * 4 + 2 * u * (dim * table_bytes + state_bytes)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, u


def _compare(got, want, dtype, what):
    """Max abs difference; raises beyond the stated tolerance."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if dtype == torch.bfloat16:
        ulp = np.spacing(np.abs(want)) * 2**16
        ok = bool(np.all(np.abs(got - want) <= ulp))
    else:
        ok = bool(np.allclose(got, want, rtol=RTOL, atol=ATOL))
    if not ok:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err}")
    return err


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(smi)


def phase_build():
    from ps_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    secs = time.perf_counter() - t0
    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log(f"build: {SOURCE} and {FLASH_SOURCE} with "
        f"{ver.strip().splitlines()[-1]} ({' '.join(_build.NVCC_FLAGS)}) in "
        f"{secs:.2f} s")
    # the flash kernel must run on Hopper's units: wgmma and TMA loads
    tools = os.path.dirname(_build.nvcc())
    lib = str(_build._library_path("flash_attention"))
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"flash SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG "
        f"instructions")
    if not all(counts.values()):
        raise AssertionError(f"flash library lacks wgmma or TMA: {counts}")
    usage = subprocess.run([os.path.join(tools, "cuobjdump"), "-res-usage",
                            lib], capture_output=True, text=True, check=True,
                           timeout=120).stdout.splitlines()
    for name, res in zip(usage, usage[1:]):
        if "flash_fwd" in name:
            kernel = name.split("Function ")[-1].rstrip(":")
            log(f"flash resources: {kernel}: {res.strip()}")


def _kernel_vs_plain(opt, table, state, ids, grads):
    """Run the kernel and the plain version on clones of the same CUDA
    tensors; return both results."""
    from ps_tpu_torch.ops import sparse_apply as ops

    clone = lambda s: ops._map_state(torch.Tensor.clone, s)  # noqa: E731
    kt, ks = table.clone(), clone(state)
    pt, pst = table.clone(), clone(state)
    ops.fused_sparse_apply(kt, ks, ids, grads, opt, "cuda")
    if ids.numel():
        ops._apply_torch(opt, pt, pst, *ops.batch_segment_sum(ids, grads))
    torch.cuda.synchronize()
    return (kt, ops.state_leaves(ks)), (pt, ops.state_leaves(pst))


def _slice_ids(seed):
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig()
    batch = next(criteo_batches(BATCH, vocab_size=cfg.per_feature_vocab,
                                seed=seed))
    gids = cfg.global_ids(torch.as_tensor(batch["sparse"]))
    return cfg, gids.reshape(-1).cuda()


def phase_kernel_vs_plain():
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    # the sweep: 4 id distributions pushed in sequence, state carried over
    v, d = 96, 8
    pushes = []
    for ids in (np.array([3, 7, 3, 3, 7, 0, 95, 3] * 2, np.int32),
                np.arange(v, dtype=np.int32), np.zeros((0,), np.int32),
                np.array([42], np.int32)):
        grads = rng.normal(size=(ids.size, d)).astype(np.float32)
        pushes.append((torch.as_tensor(ids).to(dev),
                       torch.as_tensor(grads).to(dev)))
    table0 = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32))
    cases = 0
    for rule in ("sgd", "adagrad", "adam"):
        for dtype in (torch.float32, torch.bfloat16):
            opt = rowwise.make_rowwise(rule, learning_rate=0.1)
            kt = table0.to(dev, dtype)
            ks = opt.init(kt)
            pt, pst = kt.clone(), ops._map_state(torch.Tensor.clone, ks)
            for ids, grads in pushes:
                ops.fused_sparse_apply(kt, ks, ids, grads, opt, "cuda")
                if ids.numel():
                    ops._apply_torch(opt, pt, pst,
                                     *ops.batch_segment_sum(ids, grads))
            torch.cuda.synchronize()
            _compare(kt, pt, dtype, f"sweep {rule} {dtype}")
            for a, b in zip(ops.state_leaves(ks), ops.state_leaves(pst)):
                _compare(a, b, torch.float32, f"sweep {rule} {dtype} state")
            cases += 1
    log(f"kernel vs plain: sweep of {cases} (rule, type) sequences over 4 id "
        f"distributions within rtol {RTOL} atol {ATOL} (bf16: 1 ulp)")

    # one Zipf-1.2 batch at the main path's shapes
    cfg, ids = _slice_ids(seed=1)
    errs = {}
    for rule in ("sgd", "adagrad", "adam"):
        for dtype in (torch.float32, torch.bfloat16):
            for dim in (cfg.embed_dim, 1):
                opt = rowwise.make_rowwise(rule, learning_rate=0.05)
                g = torch.Generator(dev).manual_seed(3)
                table = (0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                            device=dev)).to(dtype)
                state = opt.init(table)
                grads = torch.randn((ids.numel(), dim), generator=g, device=dev)
                (kt, ks), (pt, ps_) = _kernel_vs_plain(opt, table, state, ids,
                                                       grads)
                what = f"zipf {rule} {dtype} D={dim}"
                err = _compare(kt, pt, dtype, what)
                for a, b in zip(ks, ps_):
                    err = max(err, _compare(a, b, torch.float32, what))
                errs[(rule, dtype, dim)] = err
                del table, state, kt, ks, pt, ps_
    log(f"kernel vs plain: Zipf batch of {ids.numel()} ids into "
        f"{cfg.total_rows} rows, 3 rules x f32/bf16 x D in (16, 1): max abs "
        f"err {max(errs.values()):.3g}")

    # determinism: two kernel runs on the same inputs give the same bits
    opt = rowwise.make_rowwise("adam", learning_rate=0.05)
    g = torch.Generator(dev).manual_seed(4)
    table = torch.randn((cfg.total_rows, cfg.embed_dim), generator=g, device=dev)
    grads = torch.randn((ids.numel(), cfg.embed_dim), generator=g, device=dev)
    runs = []
    for _ in range(2):
        t, s = table.clone(), opt.init(table)
        ops.fused_sparse_apply(t, s, ids, grads, opt, "cuda")
        runs.append([t] + ops.state_leaves(s))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        if not torch.equal(a, b):
            raise AssertionError("two kernel runs on the same inputs differ")
    del table, runs
    log("kernel determinism: two adam runs at the slice shape are bitwise "
        "equal")

    # arrival order: a hot id 1,000 times, sgd f32, against the host oracle
    rng = np.random.default_rng(11)
    hot = rng.integers(0, v, size=1500).astype(np.int32)
    hot[rng.permutation(1500)[:1000]] = 5
    grads = rng.normal(size=(1500, d)).astype(np.float32)
    opt = rowwise.make_rowwise("sgd", learning_rate=0.1)
    table = table0.clone().to(dev)
    ops.fused_sparse_apply(table, (), torch.as_tensor(hot).to(dev),
                           torch.as_tensor(grads).to(dev), opt, "cuda")
    uids, gsum, _ = ops.segment_sum_np(hot, grads)
    want = table0.numpy().copy()
    want[uids] = want[uids] - np.float32(0.1) * gsum
    if not np.array_equal(table.cpu().numpy(), want):
        raise AssertionError("hot-id sgd row differs from the host oracle")
    log("arrival order: sgd f32 with a hot id x1000 equals "
        "row - f32(lr) * segment_sum_np(...) bitwise")
    return {"deep": errs[("adagrad", torch.float32, cfg.embed_dim)],
            "wide": errs[("sgd", torch.float32, 1)]}


def _widedeep(cfg, device, seed):
    """Build the composite step of the main path on ``device``."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.wide_deep import (
        WideDeep, make_ids_fn, make_wide_deep_loss_fn)

    ps.init(backend="cuda", device=device)
    model = WideDeep(cfg, generator=torch.Generator().manual_seed(seed))
    dense = ps.KVStore(optimizer="adam", learning_rate=1e-2,
                       placement="sharded")
    dense.init(model.param_tree())
    deep = ps.SparseEmbedding(cfg.total_rows, cfg.embed_dim,
                              optimizer="adagrad", learning_rate=0.05)
    wide = ps.SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                              learning_rate=0.05)
    g = torch.Generator().manual_seed(seed + 1)  # CPU: same tables anywhere
    deep.init(g, scale=0.01)
    wide.init(g, scale=0.01)
    run = ps.make_composite_step(dense, {"deep": deep, "wide": wide},
                                 make_wide_deep_loss_fn(model),
                                 make_ids_fn(cfg))
    return model, dense, deep, wide, run


def phase_small_path_vs_cpu():
    """The composite step at a small size on the card and on the CPU (whose
    plain version the tests hold to the JAX reference): 3 steps agree."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig(per_feature_vocab=50, embed_dim=8, mlp=(32, 16))
    out = {}
    for device in ("cpu", "cuda"):
        model, dense, deep, wide, run = _widedeep(cfg, device, seed=0)
        losses = []
        for batch in criteo_batches(16, vocab_size=50, seed=3, steps=3):
            loss, params = run(dense.shard_batch(batch))
            losses.append(float(loss))
        flat, _ = keys.flatten_with_keys(params)
        out[device] = (deep.fused_tier, losses, deep.table.cpu().numpy(),
                       wide.table.cpu().numpy(),
                       {k: v.detach().cpu().numpy() for k, v in flat.items()})
        ps.shutdown()
    cpu, gpu = out["cpu"], out["cuda"]
    if (cpu[0], gpu[0]) != ("torch", "cuda"):
        raise AssertionError(f"tiers {cpu[0]}, {gpu[0]}")
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=1e-5)
    np.testing.assert_allclose(gpu[2], cpu[2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gpu[3], cpu[3], rtol=1e-4, atol=1e-6)
    for k in cpu[4]:
        np.testing.assert_allclose(gpu[4][k], cpu[4][k], rtol=1e-4, atol=1e-6)
    log(f"small path: 3 composite steps on the card equal the CPU's "
        f"(losses {gpu[1]} vs {cpu[1]}; rtol 1e-5 loss, 1e-4/1e-6 state)")


def phase_main_path():
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.models.wide_deep import WideDeepConfig
    from ps_tpu_torch.ops import sparse_apply as ops

    cfg = WideDeepConfig()
    model, dense, deep, wide, run = _widedeep(cfg, "cuda", seed=0)
    if (deep.fused_tier, wide.fused_tier) != ("cuda", "cuda"):
        raise AssertionError(f"tiers {deep.fused_tier}, {wide.fused_tier}")
    batches = [dense.shard_batch(b) for b in criteo_batches(
        BATCH, vocab_size=cfg.per_feature_vocab, seed=0, steps=STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_RULE.clear()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, _ = run(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches, by_rule = ops.LAUNCHES, dict(ops.LAUNCHES_BY_RULE)
    losses = [float(x) for x in losses]
    if launches != 2 * STEPS or by_rule != {"adagrad": STEPS, "sgd": STEPS}:
        raise AssertionError(f"kernel launches {launches} {by_rule}, "
                             f"expected 2 per step over {STEPS} steps")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    for emb, dim in ((deep, cfg.embed_dim), (wide, 1)):
        if (tuple(emb.table.shape) != (cfg.total_rows, dim)
                or not bool(torch.isfinite(emb.table).all())):
            raise AssertionError("embedding table shape or values wrong")
    step_ms = float(np.median(times[1:])) * 1e3
    log(f"main path: Wide-&-Deep {cfg.num_sparse} x {cfg.per_feature_vocab} "
        f"rows, D={cfg.embed_dim}, MLP {tuple(cfg.mlp)}, batch {BATCH}, "
        f"{STEPS} steps, tier cuda, kernel launches {launches} ({by_rule}), "
        f"loss {np.mean(losses[:5]):.4f} (first 5) -> "
        f"{np.mean(losses[-5:]):.4f} (last 5)")
    log(f"main path: median step {step_ms:.3f} ms (host clock, synchronized), "
        f"{BATCH / step_ms * 1e3:.1f} examples/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ps.shutdown()
    return by_rule, step_ms


def phase_timings(errs, by_rule):
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    cfg, ids = _slice_ids(seed=2)
    dev = ids.device
    entries = []
    for table_name, rule, dim in (("deep", "adagrad", cfg.embed_dim),
                                  ("wide", "sgd", 1)):
        opt = rowwise.make_rowwise(rule, learning_rate=0.05)
        g = torch.Generator(dev).manual_seed(5)
        table = 0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                   device=dev)
        state = opt.init(table)
        grads = 1e-3 * torch.randn((ids.numel(), dim), generator=g, device=dev)
        ids_s, order = torch.sort(ids, stable=True)
        wrapper = lambda: ops.fused_sparse_apply(  # noqa: E731
            table, state, ids, grads, opt, "cuda")
        kernel_ms = _device_ms(wrapper)
        launch_ms = _device_ms(lambda: ops._launch(opt, table, state, ids_s,
                                                   order, grads))
        call_ms = _call_ms(wrapper)
        # the plain version waits for the card inside (unique_consecutive,
        # boolean masks), so only what its caller waits is measurable
        plain_ms = _call_ms(lambda: ops._apply_torch(
            opt, table, state, *ops.batch_segment_sum(ids, grads)), iters=50)
        bound_ms, nbytes, uniq = _bound_ms(ids, dim, opt, 4)
        log(json.dumps({
            "kernel": "sparse_apply", "table": table_name, "rule": rule,
            "shape": [cfg.total_rows, dim], "ids": ids.numel(),
            "unique_ids": uniq, "bytes": nbytes, "kernel_ms": kernel_ms,
            "launch_ms": launch_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "launches_per_step": 2,
            "library_ms": None}))
        entries.append({
            "name": f"sparse_apply/{table_name}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": by_rule[rule], "max_abs_err": errs[table_name],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None})
        del table, state
    return entries


def _flash():
    # the module itself: ps_tpu_torch.ops exports the function under its name
    return importlib.import_module("ps_tpu_torch.ops.flash_attention")


def _flash_case(b, s, h, d, dtype, mask_kind, seed):
    """q, k, v [b*h, s, d] on the card, N(0, 1), and a [b, s] int32 mask."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn((b * h, s, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    if mask_kind == "padding":
        mask = (torch.rand((b, s), generator=g, device=dev) < 0.7).to(
            torch.int32)
        mask[:, 0] = 1
    elif mask_kind == "row_masked":
        mask[-1] = 0  # the last batch row attends nothing
    elif mask_kind == "key0_masked":
        mask[:, 0] = 0  # with causal, query 0 attends nothing
    return q, k, v, mask


def _flash_compare(got, want, dtype, what):
    tol = FLASH_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel vs plain max abs err {err}")
    return err


def phase_flash_vs_plain():
    fa = _flash()
    errs, cases = {}, 0
    for b, s, h, d in ((2, 128, 4, 16), (2, 128, 4, 32), (2, 200, 4, 64),
                       (BERT_BATCH, BERT_SEQ, 12, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                for mask_kind in ("ones", "padding", "row_masked",
                                  "key0_masked"):
                    what = (f"flash {dtype} causal={causal} {mask_kind} "
                            f"[{b * h}, {s}, {d}]")
                    q, k, v, mask = _flash_case(b, s, h, d, dtype, mask_kind,
                                                seed=cases)
                    scale = d ** -0.5
                    out, lse = fa._flash_fwd_cuda(q, k, v, mask, scale,
                                                  causal, h)
                    again, lse2 = fa._flash_fwd_cuda(q, k, v, mask, scale,
                                                     causal, h)
                    p_out, p_lse = fa._flash_fwd_torch(q, k, v, mask, scale,
                                                       causal, h)
                    torch.cuda.synchronize()
                    if not (torch.equal(out, again) and torch.equal(lse, lse2)):
                        raise AssertionError(f"{what}: two runs differ")
                    err = _flash_compare(out, p_out, dtype, what)
                    _flash_compare(lse, p_lse, torch.float32, what + " lse")
                    dead = p_lse < -1e29
                    if (not torch.equal(dead, lse == -1e30)
                            or bool(out[dead].any())):
                        raise AssertionError(
                            f"{what}: rows that attend nothing are not "
                            f"exactly 0 with lse -1e30")
                    if mask_kind == "row_masked" and not bool(dead.any()):
                        raise AssertionError(f"{what}: no dead row")
                    # gradients through the kernel vs through the plain
                    # forward, both with the same blockwise backward
                    do = torch.randn_like(out, dtype=torch.float32).to(dtype)
                    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                    fa._Flash.apply(*leaves, mask, scale, causal, 128,
                                    h).backward(do)
                    want = fa._blockwise_bwd(q, k, v, mask, p_out, p_lse, do,
                                             scale=scale, causal=causal,
                                             block_k=128, heads=h)
                    for leaf, w, name in zip(leaves, want, "qkv"):
                        _flash_compare(leaf.grad, w, dtype,
                                       f"{what} d{name}")
                    errs[(b, dtype, causal, mask_kind)] = err
                    cases += 1
                    del q, k, v, out, again, p_out, leaves, want
    log(f"flash kernel vs plain: {cases} cases (f32/bf16 x causal x 4 masks "
        f"x 4 shapes), forward and gradients within rtol/atol "
        f"{FLASH_TOL[torch.float32]} (f32) / {FLASH_TOL[torch.bfloat16]} "
        f"(bf16), bitwise deterministic, exact zeros and lse -1e30 on dead "
        f"rows; max abs err f32 "
        f"{max(e for k, e in errs.items() if k[1] == torch.float32):.3g}, "
        f"bf16 {max(e for k, e in errs.items() if k[1] == torch.bfloat16):.3g}")
    return errs[(BERT_BATCH, torch.bfloat16, False, "ones")]


def _bert_run(model, device, batches, steps=None):
    """``steps`` LAMB steps of ``model`` through init + KVStore.make_step
    on ``device``; returns the losses, the step times and the params."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.bert import make_mlm_loss_fn

    ps.init(backend="cuda", device=device)
    store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                       weight_decay=0.01, placement="sharded")
    store.init(model.param_tree())
    run = store.make_step(make_mlm_loss_fn(model))
    batches = [store.shard_batch(b) for b in batches]
    losses, times, params = [], [], None
    for batch in batches:
        t0 = time.perf_counter()
        loss, params = run(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    losses = [float(x) for x in losses]
    ps.shutdown()
    return losses, times, params


def phase_bert_small_vs_cpu():
    """A tiny BERT with flash attention, 3 LAMB steps on the card and on
    the CPU (whose plain versions the tests hold to the JAX reference),
    from the same weights: they agree within the reference's LAMB-parity
    bounds (tests/test_bert.py)."""
    from ps_tpu_torch.data.synthetic import mlm_batches
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.bert import BertConfig, BertMLM

    fa = _flash()
    cfg = BertConfig.tiny(max_len=128, attn="flash")
    model = BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        before = fa.LAUNCHES
        losses, _, params = _bert_run(model, device, mlm_batches(
            16, 128, vocab_size=cfg.vocab_size, seed=3, steps=3))
        flat, _ = keys.flatten_with_keys(params)
        out[device] = (fa.LAUNCHES - before, losses,
                       {k: p.detach().cpu().numpy() for k, p in flat.items()})
    cpu, gpu = out["cpu"], out["cuda"]
    if (cpu[0], gpu[0]) != (0, 3 * cfg.num_layers):
        raise AssertionError(f"flash launches cpu {cpu[0]}, cuda {gpu[0]}")
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=1e-5)
    for k in cpu[2]:
        np.testing.assert_allclose(gpu[2][k], cpu[2][k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    log(f"small BERT: 3 LAMB steps (tiny, flash, f32, seq 128, batch 16) on "
        f"the card equal the CPU's (losses {gpu[1]} vs {cpu[1]}; rtol 1e-5 "
        f"loss, 2e-4/1e-5 params over {len(cpu[2])} tensors)")


def phase_bert_flash_vs_full():
    """BERT-base in f32, two sequences of 512 padded from position 400:
    flash logits equal full-attention logits on the unpadded positions
    within the reference's bound (tests/test_flash_attention.py)."""
    from ps_tpu_torch.models.bert import BertConfig, BertMLM

    dev = torch.device("cuda", 0)
    cfg = BertConfig(dtype=torch.float32, attn="flash")
    flash = BertMLM(cfg, generator=torch.Generator().manual_seed(1)).to(dev)
    full = BertMLM(BertConfig(dtype=torch.float32, attn="full"),
                   device="meta")
    full.load_state_dict(flash.state_dict(), assign=True)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1000, cfg.vocab_size, size=(2, 512))
                          .astype(np.int32)).to(dev)
    mask = torch.ones((2, 512), dtype=torch.int32, device=dev)
    mask[:, 400:] = 0
    with torch.no_grad():
        got = flash(ids, mask)[:, :400]
        want = full(ids, mask)[:, :400]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"BERT-base flash vs full: max abs err {err}")
    log(f"BERT-base f32, 2 x 512 padded from 400: flash logits equal full "
        f"attention's on the unpadded positions within rtol/atol 2e-4 (max "
        f"abs err {err:.3g})")
    del flash, full, got, want


def phase_bert_main_path():
    from ps_tpu_torch.data.synthetic import mlm_batches
    from ps_tpu_torch.models.bert import BertConfig, BertMLM

    fa = _flash()
    cfg = BertConfig(attn="flash")  # BERT-base, bf16 compute, f32 params
    model = BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    batches = list(mlm_batches(BERT_BATCH, BERT_SEQ, vocab_size=cfg.vocab_size,
                               seed=0, steps=BERT_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    losses, times, _ = _bert_run(model, "cuda", batches)
    launches = fa.LAUNCHES
    if launches != cfg.num_layers * BERT_STEPS:
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{cfg.num_layers} per step over {BERT_STEPS}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    step_ms = float(np.median(times[1:])) * 1e3
    nparams = sum(p.numel() for p in model.parameters())
    log(f"main path: BERT-base MLM ({nparams / 1e6:.1f}M params), bf16, "
        f"flash, seq {BERT_SEQ}, global batch {BERT_BATCH}, LAMB lr 1e-3 wd "
        f"0.01, {BERT_STEPS} steps, flash launches {launches}, loss "
        f"{np.mean(losses[:5]):.4f} (first 5) -> {np.mean(losses[-5:]):.4f} "
        f"(last 5); losses {[round(x, 4) for x in losses]}")
    log(f"main path: median step {step_ms:.3f} ms (host clock, synchronized),"
        f" {BERT_BATCH / step_ms * 1e3:.2f} seq/s, "
        f"{BERT_BATCH * BERT_SEQ / step_ms * 1e3:.0f} tokens/s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    return launches, step_ms


def phase_flash_timings(err, launches):
    fa = _flash()
    b, s, h, d = BERT_BATCH, BERT_SEQ, 12, 64
    q, k, v, mask = _flash_case(b, s, h, d, torch.bfloat16, "ones", seed=99)
    scale = d ** -0.5
    kernel = lambda: fa._flash_fwd_cuda(  # noqa: E731
        q, k, v, mask, scale, False, h)
    kernel_ms = _device_ms(kernel)
    call_ms = _call_ms(kernel)
    plain_ms = _call_ms(lambda: fa._flash_fwd_torch(
        q, k, v, mask, scale, False, h), iters=20, warmup=3)
    # the yardstick only: one PyTorch call for the same function on the
    # same [B, h, S, d] tensors and boolean mask; the port never calls it
    qs, ks, vs = (t.reshape(b, h, s, d) for t in (q, k, v))
    keep = (mask > 0)[:, None, None, :]
    library_ms = _device_ms(lambda: torch.nn.functional.
                            scaled_dot_product_attention(qs, ks, vs,
                                                         attn_mask=keep))
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4
    flops = 4 * b * h * s * s * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    log(json.dumps({
        "kernel": "flash_attention/fwd", "shape": [b * h, s, d],
        "dtype": "bfloat16", "mask": "all ones", "causal": False,
        "bytes": nbytes, "flops": flops, "kernel_ms": kernel_ms,
        "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
        "tflops": flops / kernel_ms / 1e9, "launches_per_step": 12}))
    return {"name": "flash_attention/fwd", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ps_tpu_torch")):
        print("chip_smoke: ps_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    phase_environment()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_small_path_vs_cpu()
    by_rule, _ = phase_main_path()
    entries = phase_timings(errs, by_rule)
    flash_err = phase_flash_vs_plain()
    phase_bert_small_vs_cpu()
    phase_bert_flash_vs_full()
    launches, _ = phase_bert_main_path()
    entries.append(phase_flash_timings(flash_err, launches))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
