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
   arrival order of a hot id's sum against a host oracle, bitwise; the
   grouping pass against torch.sort (sorted ids and permutation bitwise on
   the real ids, segments against unique_consecutive) at N = 13,312 and
   N = 1,703,936 (a batch of 65,536) with filler; the kernel against its
   plain version at N = 1,703,936 for the main path's rules (adagrad
   D = 16, sgd D = 1, f32);
4. the Wide-&-Deep path: the composite step, first at a small size
   against the same step on the CPU, then at the full published width
   (26 x 100,000 rows, D = 16, MLP 256/128/64, batch 512) for 50 steps
   through ps_tpu_torch.init(backend='cuda'), with the kernel launch
   counts read around it;
5. sparse-apply timings at that path's shapes with CUDA events: the
   device time of the whole apply (grouping pass + kernel), of the kernel
   alone and of the grouping pass alone, torch.sort on the same ids (the
   parent's sort, a yardstick the port never calls at this N), an empty
   kernel queued the same way, what a caller of the wrapper waits, and
   the plain version;
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
   scaled_dot_product_attention as the yardstick;
9. ResNet on the card against the CPU, with cuDNN's TF32 allowed as
   PyTorch allows it by default (the f32 model must turn it off itself): a
   tiny BasicBlock ResNet (stages (1, 1), 8 filters, small inputs, f32) on
   28² and a small Bottleneck one on 16², 3 momentum steps each from the
   same weights (loss rtol 1e-5; params and batch_stats rtol 2e-4, atol
   2e-5, the reference's bounds); then full-width ResNet-50 in f32 on
   2 x 224² images, eval and train mode (logits and batch_stats rtol/atol
   2e-4), which checks the stem's and the stride-2 layers' 'SAME' padding
   at the published size on the card; then every distinct convolution
   that model runs on 2 x 224² images, forward and backward (output, dgrad
   and wgrad from random f32 inputs), card against CPU within 1e-4
   (relative 2-norm), which the same run holds to fail with the model's
   TF32 guard (``_full_f32``) taken out: this shows the f32 backward is
   not TF32. The whole model's loss gradient, card against CPU with and
   without the guard, is printed as a reading, not held: ReLU masks and
   max-pool choices that round-off flips between the two devices move a
   few gradients by whole terms;
10. the ResNet path: ResNet-50 v1.5, 224², bf16 compute over f32
   parameters, global batch 256, momentum lr 0.1 / 0.9, label smoothing
   0.1, placement 'sharded', seed 0, 20 steps through
   ps_tpu_torch.init(backend='cuda'), each step's batch already on the
   card (cycled from 4 pre-generated batches); the median step, images/s,
   peak device memory and the step's analytic FLOPs and their share of
   the bf16 peak. This path runs no kernel of the port: the reference's
   ResNet reaches no Pallas kernel;
11. MNIST through the local parameter server (config 1): the MLP at hidden
   32, 2 workers x batch 32, 10 sgd steps through
   ps_tpu_torch.init(backend='local'), push_all and pull_all, on the card
   against the CPU (losses and params within 1e-5); then the full width,
   784-256-10, 2 workers x batch 128, sgd 0.1, 200 steps on cuda:0 with
   the batches already on the card: the loss must fall; the median step,
   steps/s and push+pull GB/s;
12. async DC-ASGD in one process (config 5): backend='cuda', mode='async',
   3 workers round-robin through make_async_step, the MLP at hidden 32,
   batch 64, dc_lambda 0.04, 60 cycles, on the card against the CPU
   (losses and params within 1e-5); then 4 host threads x 12 cycles, whose
   invariants are exact (version, apply counts, the staleness histogram's
   sum, finite parameters); cycles/s and the staleness histograms. Phases
   11 and 12 run no kernel of the port (the reference's MLP and server
   applies reach no Pallas kernel): the launch counts are set to 0 before
   each path and must read 0 after it;
13. checkpoint and resume on the card (ps_tpu_torch/checkpoint.py), each
   resumed run against an uninterrupted one, bitwise, and each
   uninterrupted run twice, which must repeat itself bitwise (BERT's only
   where PyTorch's deterministic algorithms are on, see (b)): (a) Wide-&-Deep at the full published width of phase 4, 20
   steps against 10, a save of the dense store and both tables, a fresh
   store and fresh tables, a restore and 10 more steps: dense params, both
   tables and every optimizer state equal, and the resumed half launches
   the grouping pass and the apply 2 + 2 times a step; (b) BERT-base as in
   phase 7, 4 LAMB steps against 2, save, a fresh store, restore, 2, 12
   flash launches a step: with PyTorch's default algorithms the
   uninterrupted run differs from itself (F.embedding's backward over
   the token-type ids is not deterministic on the card; one gradient
   taken twice names it), so that spread and the resumed run's distance
   are printed and the restored state is held to the saved one bitwise;
   with torch.use_deterministic_algorithms(True), which gives that op its
   deterministic kernel, params and LAMB state equal the uninterrupted
   run's and it repeats itself, bitwise; (c) config 1 (local,
   sync, 784-256-10, 2 workers x 128, 20 sgd steps against 10 + 10) and
   config 5 (cuda async, 3 workers round-robin through make_async_step,
   12 cycles against 6 + 6): params and counters equal, and each restored
   worker's cached pull is the very tensor restored as its stale
   snapshot. Each checkpoint's bytes on disk, save and restore (file to
   device) seconds and GB/s are printed, under a temporary directory. A
   checkpoint of ps_tpu converted by from_reference is restored by the
   CPU tests (tests/test_torch_checkpoint.py), which need jax to write
   one; this machine has none.

It prints one JSON line per timed kernel, then the kernels line, then
``{"ok": true, "device": {...}}`` as its last line. Without a GPU, or
without the rest of the repository beside it, it fails before printing
any result.
"""

import contextlib
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
GROUP_SOURCE = "ps_tpu_torch/ops/csrc/sparse_group.cu"
GROUP_REPLACES = "ps_tpu/ops/sparse_apply.py:80"  # batch_segment_sum's sort
BIG_BATCH = 65_536  # a production batch: 1,703,936 ids
# flash attention: the kernel sums keys in its own order, so f32 is held to
# the reference's flash-vs-einsum bound and bf16 to two bf16 ulps (p and
# the output are rounded to bf16 after sums taken in different orders)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
FLASH_SOURCE = "ps_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = "ps_tpu/ops/flash_attention.py:136"
BERT_STEPS, BERT_BATCH, BERT_SEQ = 20, 32, 512
RESNET_STEPS, RESNET_BATCH, RESNET_SIZE, RESNET_BATCHES = 20, 256, 224, 4
# f32 convolutions of ResNet-50, card against CPU: |got - want| / |want|
# (2-norms) of the output, dgrad and wgrad (TF32's 10-bit mantissa gives
# ~1e-3; f32 summed in another order ~1e-6)
RESNET_CONV_TOL = 1e-4
# config 1 (local PS) and config 5 (async DC-ASGD), the reference trainers'
# defaults; card against CPU within 1e-5 (rtol and atol)
MNIST_STEPS, MNIST_BATCH, MNIST_WORKERS, MNIST_HIDDEN = 200, 128, 2, 256
ASYNC_CYCLES, ASYNC_BATCH, ASYNC_WORKERS = 60, 64, 3
STRESS_THREADS, STRESS_CYCLES = 4, 12
MNIST_TOL = 1e-5
# phase 13: uninterrupted steps (the resumed runs save at half of them)
CKPT_WD_STEPS, CKPT_BERT_STEPS, CKPT_MNIST_STEPS, CKPT_ASYNC_CYCLES = (
    20, 4, 20, 12)


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
    smi = _card_line()
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
    log(f"build: {GROUP_SOURCE}, {SOURCE} and {FLASH_SOURCE} with "
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


def _slice_ids(seed, batch=BATCH, filler=False):
    """The ids of one Wide-&-Deep batch on the card; with ``filler``, 1%
    of them -1 and 1% past the table."""
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig()
    data = next(criteo_batches(batch, vocab_size=cfg.per_feature_vocab,
                               seed=seed))
    gids = cfg.global_ids(torch.as_tensor(data["sparse"])).reshape(-1)
    if filler:
        rng = np.random.default_rng(seed)
        gids[torch.as_tensor(rng.random(gids.numel()) < 0.01)] = -1
        gids[torch.as_tensor(rng.random(gids.numel()) < 0.01)] = (
            cfg.total_rows + 5)
    return cfg, gids.cuda()


def _check_group(group, ids, num_rows):
    """The grouping pass against torch.sort (stable) on the real ids:
    sorted ids and permutation bitwise, segments as unique_consecutive's,
    and as many ids set aside as lie outside [0, num_rows)."""
    real = (ids >= 0) & (ids < num_rows)
    want_s, order = torch.sort(ids[real], stable=True)
    want_perm = torch.nonzero(real).reshape(-1)[order]
    segs, n_real, lo = (int(x) for x in group.meta.cpu())
    vals, counts = torch.unique_consecutive(want_s, return_counts=True)
    starts = lo + torch.cumsum(counts, 0) - counts
    ok = (n_real == int(real.sum())
          and torch.equal(group.ids_s[lo:lo + n_real], want_s)
          and torch.equal(group.perm[lo:lo + n_real].long(), want_perm)
          and segs == vals.numel()
          and torch.equal(group.seg_start[:segs].long(), starts)
          and int(group.seg_start[segs]) == lo + n_real
          and torch.equal(group.seg_id[:segs], vals))
    if not ok:
        raise AssertionError(f"grouping pass differs from torch.sort at "
                             f"N = {ids.numel()}")
    return segs, ids.numel() - n_real


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

    # the grouping pass against torch.sort, at the main path's N and at a
    # production batch's (where it sorts with torch.sort itself)
    for batch in (BATCH, BIG_BATCH):
        _, fids = _slice_ids(seed=6, batch=batch, filler=True)
        plan = ops.plan_group(fids.numel(), cfg.total_rows)
        segs, aside = _check_group(ops.group_ids(fids, cfg.total_rows),
                                   fids, cfg.total_rows)
        log(f"grouping pass ({plan['path']} path, {plan['passes']} x "
            f"{plan['digit_bits']}-bit passes): N = {fids.numel()}, "
            f"{segs} segments, {aside} ids set aside; equals torch.sort "
            f"bitwise on the real ids")
        del fids

    # kernel vs plain at a production batch, the main path's two rules
    _, big = _slice_ids(seed=7, batch=BIG_BATCH, filler=True)
    for rule, dim in (("adagrad", cfg.embed_dim), ("sgd", 1)):
        opt = rowwise.make_rowwise(rule, learning_rate=0.05)
        g = torch.Generator(dev).manual_seed(8)
        table = 0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                   device=dev)
        grads = torch.randn((big.numel(), dim), generator=g, device=dev)
        (kt, ks), (pt, ps_) = _kernel_vs_plain(opt, table, opt.init(table),
                                               big, grads)
        what = f"N={big.numel()} {rule} f32 D={dim}"
        err = _compare(kt, pt, torch.float32, what)
        for a, b in zip(ks, ps_):
            err = max(err, _compare(a, b, torch.float32, what))
        log(f"kernel vs plain: {what}: max abs err {err:.3g}")
        del table, grads, kt, ks, pt, ps_
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
    ops.GROUP_LAUNCHES = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, _ = run(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches, by_rule = ops.LAUNCHES, dict(ops.LAUNCHES_BY_RULE)
    group_launches = ops.GROUP_LAUNCHES
    losses = [float(x) for x in losses]
    if launches != 2 * STEPS or by_rule != {"adagrad": STEPS, "sgd": STEPS}:
        raise AssertionError(f"kernel launches {launches} {by_rule}, "
                             f"expected 2 per step over {STEPS} steps")
    if group_launches != 2 * STEPS:  # one grouping pass a table a step
        raise AssertionError(f"grouping-pass launches {group_launches}, "
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
        f"grouping-pass launches {group_launches}, "
        f"loss {np.mean(losses[:5]):.4f} (first 5) -> "
        f"{np.mean(losses[-5:]):.4f} (last 5)")
    log(f"main path: median step {step_ms:.3f} ms (host clock, synchronized), "
        f"{BATCH / step_ms * 1e3:.1f} examples/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ps.shutdown()
    return by_rule, group_launches, step_ms


def phase_timings(errs, by_rule, group_launches):
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    cfg, ids = _slice_ids(seed=2)
    dev = ids.device
    n = ids.numel()
    empty_ms = _device_ms(lambda: ops.empty_launch(dev))
    sort_ms = _device_ms(lambda: ops.group_ids(ids, cfg.total_rows))
    torch_sort_ms = _device_ms(lambda: torch.sort(ids, stable=True))
    # the plain version syncs inside (nonzero, sum): a caller's time only
    group_plain_ms = _call_ms(lambda: ops._group_torch(ids, cfg.total_rows),
                              iters=50)
    group = ops.group_ids(ids, cfg.total_rows)
    segs = int(group.meta[0])
    # each id read once; sorted ids, permutation and segment table written
    group_bytes = 4 * n + 4 * 2 * n + 4 * (2 * segs + 1) + 4 * ops.META
    group_bound = group_bytes / HBM_BYTES_PER_S * 1e3
    log(json.dumps({
        "kernel": "sparse_group", "ids": n, "segments": segs,
        "path": ops.plan_group(n, cfg.total_rows)["path"],
        "bytes": group_bytes, "sort_ms": sort_ms,
        "torch_sort_ms": torch_sort_ms, "plain_ms": group_plain_ms,
        "empty_launch_ms": empty_ms, "bound_ms": group_bound,
        "bound_share": group_bound / sort_ms, "launches_per_step": 2}))
    entries = []
    for table_name, rule, dim in (("deep", "adagrad", cfg.embed_dim),
                                  ("wide", "sgd", 1)):
        opt = rowwise.make_rowwise(rule, learning_rate=0.05)
        g = torch.Generator(dev).manual_seed(5)
        table = 0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                   device=dev)
        state = opt.init(table)
        grads = 1e-3 * torch.randn((n, dim), generator=g, device=dev)
        wrapper = lambda: ops.fused_sparse_apply(  # noqa: E731
            table, state, ids, grads, opt, "cuda")
        kernel_ms = _device_ms(wrapper)
        launch_ms = _device_ms(lambda: ops._launch(opt, table, state, group,
                                                   grads))
        call_ms = _call_ms(wrapper)
        # the plain version waits for the card inside (unique_consecutive,
        # boolean masks), so only what its caller waits is measurable
        plain_ms = _call_ms(lambda: ops._apply_torch(
            opt, table, state, *ops.batch_segment_sum(ids, grads)), iters=50)
        bound_ms, nbytes, uniq = _bound_ms(ids, dim, opt, 4)
        log(json.dumps({
            "kernel": "sparse_apply", "table": table_name, "rule": rule,
            "shape": [cfg.total_rows, dim], "ids": n,
            "unique_ids": uniq, "bytes": nbytes, "kernel_ms": kernel_ms,
            "launch_ms": launch_ms, "sort_ms": sort_ms,
            "torch_sort_ms": torch_sort_ms, "empty_launch_ms": empty_ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / kernel_ms, "launches_per_step": 2,
            "library_ms": None}))
        entries.append({
            "name": f"sparse_apply/{table_name}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": by_rule[rule], "max_abs_err": errs[table_name],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None})
        del table, state
    # the grouping pass is checked bitwise against torch.sort (phase 3)
    entries.append({
        "name": "sparse_group", "route": "cuda", "source": GROUP_SOURCE,
        "replaces": GROUP_REPLACES, "launches": group_launches,
        "max_abs_err": 0.0, "ms": sort_ms, "plain_ms": group_plain_ms,
        "bound_ms": group_bound, "bound_by": "bytes",
        "library_ms": torch_sort_ms})
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


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _resnet_run(model, device, batches, steps, in_channels=3,
                label_smoothing=0.0):
    """``steps`` momentum steps (lr 0.1, 0.9, 'sharded') of ``model`` from
    its seed-0 init, through init + KVStore.make_step on ``device``,
    cycling ``batches``; returns the losses, the step times, the params and
    the batch_stats. On the card the peak memory count starts after the
    set-up."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.resnet import make_loss_fn

    ps.init(backend="cuda", device=device)
    params, stats = model.init(torch.Generator().manual_seed(0),
                               in_channels=in_channels, device=device)
    store = ps.KVStore(optimizer="momentum", learning_rate=0.1, momentum=0.9,
                       placement="sharded")
    store.init(params)
    run = store.make_step(make_loss_fn(model, label_smoothing), has_aux=True)
    batches = [store.shard_batch(b) for b in batches]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        loss, params, stats = run(batches[step % len(batches)], stats)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    losses = [float(x) for x in losses]
    ps.shutdown()
    return losses, times, params, stats


def _flat_np(tree):
    from ps_tpu_torch.kv import keys

    flat, _ = keys.flatten_with_keys(tree)
    return {k: v.detach().float().cpu().numpy() for k, v in flat.items()}


def _perturb_bn(params, stats, seed):
    """BatchNorm parameters and running statistics moved off the init (which
    zeroes each block's last BN scale, so a residual branch would add
    nothing): scales 1 + 0.1·N, the last 0.2·N, biases and running means
    0.1·N, running variances in [0.5, 1.5]; numpy, from ``seed``."""
    from ps_tpu_torch.kv import keys

    rng = np.random.default_rng(seed)
    for tree in (params, stats):
        for k, t in keys.flatten_with_keys(tree)[0].items():
            z = torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                dtype=torch.float32)
            if k.endswith("scale"):
                t.copy_(0.2 * z if "BatchNorm_2" in k else 1 + 0.1 * z)
            elif (k.endswith("bias") and k != "head/bias") or k.endswith("mean"):
                t.copy_(0.1 * z)
            elif k.endswith("var"):
                t.copy_(torch.as_tensor(rng.uniform(
                    0.5, 1.5, size=tuple(t.shape)), dtype=torch.float32))


@contextlib.contextmanager
def _without_tf32_guard():
    """The control: the model's TF32 guard taken out, so that cuDNN takes
    TF32 for f32 convolutions as PyTorch allows it by default."""
    from ps_tpu_torch.models import resnet

    guard = resnet._full_f32
    resnet._full_f32 = contextlib.nullcontext
    try:
        yield
    finally:
        resnet._full_f32 = guard


def _conv_configs(model, size):
    """Every distinct convolution ``model`` runs on 2 x size² images:
    ``(input shape, kernel shape, stride, padding)`` as its ``_Conv`` gets
    them (after any asymmetric 'SAME' pad), recorded from a CPU forward."""
    from ps_tpu_torch.models import resnet

    seen = {}
    conv = resnet._Conv.apply

    def record(x, w, stride, padding):
        seen[(tuple(x.shape), tuple(w.shape), stride, tuple(padding))] = None
        return conv(x, w, stride, padding)

    resnet._Conv.apply = record
    try:
        params, stats = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.apply(params, stats, torch.zeros(2, size, size, 3),
                        train=False)
    finally:
        del resnet._Conv.apply
    return list(seen)


def _conv_outputs(config, device, seed):
    """Output, dgrad and wgrad of one ``_Conv`` on ``device`` from numpy
    normals drawn from ``seed`` (channels_last, as the model lays them)."""
    from ps_tpu_torch.models import resnet

    x_shape, w_shape, stride, padding = config
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * np.float32(scale)).to(
            device, memory_format=torch.channels_last)

    x = draw(x_shape).requires_grad_()
    w = draw(w_shape, 1 / np.sqrt(np.prod(w_shape[1:]))).requires_grad_()
    y = resnet._Conv.apply(x, w, stride, padding)
    gx, gw = torch.autograd.grad(y, (x, w), draw(tuple(y.shape)))
    return [t.detach().cpu().numpy() for t in (y, gx, gw)]


def _rel_l2(got, want):
    return max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
               for g, w in zip(got, want))


def _resnet_grads(model, params, stats, images, labels, device, train):
    """``{key: numpy}``: the gradient of the label-smoothed (0.1) loss with
    respect to every parameter, computed on ``device``."""
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.resnet import cross_entropy_loss

    def on(tree, grad):
        return {k: on(v, grad) if isinstance(v, dict)
                else v.detach().to(device).requires_grad_(grad)
                for k, v in tree.items()}

    params = on(params, True)
    logits, _ = model.apply(params, on(stats, False), images.to(device),
                            train=train)
    loss = cross_entropy_loss(logits, labels.to(device), 0.1)
    flat, _ = keys.flatten_with_keys(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return {k: g.cpu().numpy() for k, g in zip(flat, grads)}


def _worst_rel(got, want):
    """The key whose gradient differs most, and that difference over the
    tensor's largest entry."""
    rel = {k: float(np.max(np.abs(got[k] - w))
                    / max(float(np.max(np.abs(w))), 1e-30))
           for k, w in want.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def phase_resnet_vs_cpu():
    from ps_tpu_torch.models import resnet

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        rng = np.random.default_rng(3)
        for name, block, size, channels in (
                ("BasicBlock", resnet.BasicBlock, 28, 1),
                ("Bottleneck", resnet.BottleneckBlock, 16, 3)):
            model = resnet.ResNet(stage_sizes=(1, 1), block_cls=block,
                                  num_filters=8, num_classes=10,
                                  dtype=torch.float32, small_inputs=True)
            batches = [(rng.normal(size=(32, size, size, channels)).astype(
                np.float32), rng.integers(0, 10, 32).astype(np.int32))
                for _ in range(3)]
            out = {d: _resnet_run(model, d, batches, 3, in_channels=channels)
                   for d in ("cpu", "cuda")}
            cpu, gpu = out["cpu"], out["cuda"]
            np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
            for i in (2, 3):
                want = _flat_np(cpu[i])
                for k, g in _flat_np(gpu[i]).items():
                    np.testing.assert_allclose(g, want[k], rtol=2e-4,
                                               atol=2e-5, err_msg=k)
            log(f"small ResNet ({name}, stages (1, 1), 8 filters, f32, "
                f"{size}²): 3 momentum steps on the card equal the CPU's "
                f"(losses {gpu[0]} vs {cpu[0]}; rtol 1e-5 loss, 2e-4/2e-5 "
                f"params and batch_stats)")

        model = resnet.ResNet50(dtype=torch.float32)
        params, stats = model.init(torch.Generator().manual_seed(1))
        _perturb_bn(params, stats, seed=2)
        images = torch.as_tensor(rng.normal(
            size=(2, RESNET_SIZE, RESNET_SIZE, 3)).astype(np.float32))
        on = lambda tree: {k: on(v) if isinstance(v, dict)  # noqa: E731
                           else v.cuda() for k, v in tree.items()}
        errs = []
        for train in (False, True):
            with torch.no_grad():
                want, want_s = model.apply(params, stats, images, train=train)
                got, got_s = model.apply(on(params), on(stats),
                                         images.cuda(), train=train)
            err = float((got.cpu() - want).abs().max())
            if not torch.allclose(got.cpu(), want, rtol=2e-4, atol=2e-4):
                raise AssertionError(f"ResNet-50 f32 train={train}: logits "
                                     f"max abs err {err}")
            want_s = _flat_np(want_s)
            for k, g in _flat_np(got_s).items():
                np.testing.assert_allclose(g, want_s[k], rtol=2e-4,
                                           atol=2e-4, err_msg=k)
            errs.append(err)
        log(f"ResNet-50 f32, 2 x {RESNET_SIZE}²: card equals CPU in eval "
            f"and train mode with cuDNN TF32 allowed globally (logits max "
            f"abs err {errs[0]:.3g} / {errs[1]:.3g}, rtol/atol 2e-4; "
            f"batch_stats 2e-4)")

        configs = _conv_configs(model, RESNET_SIZE)
        worst = {True: (0.0, None), False: (0.0, None)}
        for i, config in enumerate(configs):
            want = _conv_outputs(config, "cpu", seed=i)
            for guarded in (True, False):
                with (contextlib.nullcontext() if guarded
                      else _without_tf32_guard()):
                    err = _rel_l2(_conv_outputs(config, "cuda", seed=i), want)
                worst[guarded] = max(worst[guarded], (err, config))
        (err, config), (err_tf32, config_tf32) = worst[True], worst[False]
        if not err <= RESNET_CONV_TOL < err_tf32:
            raise AssertionError(
                f"ResNet-50's f32 convolutions, card vs CPU: {err:.3g} "
                f"({config}) with the TF32 guard, {err_tf32:.3g} "
                f"({config_tf32}) without it; the tolerance "
                f"{RESNET_CONV_TOL:g} must lie between")
        log(f"ResNet-50's {len(configs)} distinct f32 convolutions at 2 x "
            f"{RESNET_SIZE}², output, dgrad and wgrad: card equals CPU within "
            f"{err:.3g} (relative 2-norm; worst {config}; tolerance "
            f"{RESNET_CONV_TOL:g}); without the TF32 guard {err_tf32:.3g} "
            f"(worst {config_tf32}), so the guard keeps the backward f32")

        labels = torch.as_tensor(rng.integers(0, 1000, 2).astype(np.int32))
        args = (model, params, stats, images, labels)
        for train in (False, True):
            want = _resnet_grads(*args, "cpu", train)
            key, err = _worst_rel(_resnet_grads(*args, "cuda", train), want)
            with _without_tf32_guard():
                key_tf32, err_tf32 = _worst_rel(
                    _resnet_grads(*args, "cuda", train), want)
            log(f"reading, not held: ResNet-50 f32, 2 x {RESNET_SIZE}², "
                f"train={train}, the loss gradient of all {len(want)} "
                f"parameters, card vs CPU: largest difference over its "
                f"tensor's largest entry {err:.3g} ({key}) with the TF32 "
                f"guard, {err_tf32:.3g} ({key_tf32}) without it")
        del params, stats
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def phase_resnet_main_path():
    from ps_tpu_torch.data.synthetic import imagenet_batches
    from ps_tpu_torch.models.resnet import ResNet50

    model = ResNet50()  # bf16 compute, f32 params
    batches = list(imagenet_batches(RESNET_BATCH, image_size=RESNET_SIZE,
                                    seed=0, steps=RESNET_BATCHES))
    losses, times, params, stats = _resnet_run(
        model, "cuda", batches, RESNET_STEPS, label_smoothing=0.1)
    peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    flat = _flat_np(stats)
    moved = [k for k, v in flat.items()
             if not np.array_equal(v, np.zeros_like(v) if k.endswith("mean")
                                   else np.ones_like(v))]
    if len(moved) != len(flat) or not all(np.all(np.isfinite(v))
                                          for v in flat.values()):
        raise AssertionError(f"running statistics did not all move: "
                             f"{sorted(set(flat) - set(moved))[:5]}")
    if not all(np.all(np.isfinite(v)) for v in _flat_np(params).values()):
        raise AssertionError("non-finite parameters")
    step_ms = float(np.median(times[1:])) * 1e3
    flops = 3 * 2 * model.forward_macs(RESNET_SIZE) * RESNET_BATCH
    log(f"main path: ResNet-50 v1.5, {RESNET_SIZE}², bf16, global batch "
        f"{RESNET_BATCH}, momentum lr 0.1 / 0.9, label smoothing 0.1, "
        f"sharded, {RESNET_STEPS} steps over {RESNET_BATCHES} batches, loss "
        f"{np.mean(losses[:5]):.4f} (first 5) -> {np.mean(losses[-5:]):.4f} "
        f"(last 5); losses {[round(x, 4) for x in losses]}; "
        f"{len(moved)} running statistics moved")
    log(f"main path: median step {step_ms:.3f} ms (host clock, "
        f"synchronized, step 0 excluded; step 0 {times[0] * 1e3:.1f} ms), "
        f"{RESNET_BATCH / step_ms * 1e3:.1f} images/s, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"main path: {flops / 1e12:.3f} TFLOP a step (3 x 2 x "
        f"{model.forward_macs(RESNET_SIZE) / 1e9:.3f} G multiply-adds x "
        f"{RESNET_BATCH}, from the layer shapes), "
        f"{flops / step_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / (step_ms / 1e3) / BF16_FLOPS_PER_S:.1f}% of the "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; card "
        f"{_card_line()}")
    return step_ms


def _launch_counts(reset=False):
    """Every kernel wrapper's launch count; with ``reset``, set them to 0
    first."""
    from ps_tpu_torch.ops import sparse_apply as ops

    fa = _flash()
    if reset:
        ops.LAUNCHES = ops.GROUP_LAUNCHES = fa.LAUNCHES = 0
        ops.LAUNCHES_BY_RULE.clear()
    return {"sparse_apply": ops.LAUNCHES, "sparse_group": ops.GROUP_LAUNCHES,
            "flash_attention/fwd": fa.LAUNCHES}


def _no_launches(what):
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{what} launched kernels: {counts}")
    log(f"{what}: kernel launches {counts} (no kernel of the port is on "
        f"this path)")


def _close_to_cpu(gpu, cpu, what):
    """Losses and params, card against CPU, within MNIST_TOL."""
    (g_losses, g_params), (c_losses, c_params) = gpu, cpu
    np.testing.assert_allclose(g_losses, c_losses, rtol=MNIST_TOL,
                               atol=MNIST_TOL, err_msg=f"{what} losses")
    worst = 0.0
    for k in c_params:
        np.testing.assert_allclose(g_params[k], c_params[k], rtol=MNIST_TOL,
                                   atol=MNIST_TOL, err_msg=f"{what} {k}")
        worst = max(worst, float(np.max(np.abs(g_params[k] - c_params[k]))))
    return worst


def _mnist_sync(device, hidden, workers, batch, steps):
    """Config 1's protocol through init(backend='local') on ``device``: each
    step every worker takes the gradient of its batch against the pulled
    params and pushes it (push_all), then one pull_all. The batches are
    placed before the clock starts. Returns the per-step losses (mean over
    workers), the step times, the params and the bytes pushed + pulled."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.kv.store import value_and_grad
    from ps_tpu_torch.models.mlp import MLP, make_loss_fn

    ctx = ps.init(backend="local", num_workers=workers, device=device)
    model = MLP(hidden=hidden)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(model.init(torch.Generator().manual_seed(0),
                          device=ctx.device))
    loss_fn = make_loss_fn(model)
    streams = [mnist_batches(batch, seed=0, worker=w, num_workers=workers,
                             steps=steps) for w in range(workers)]
    batches = [[store.shard_batch(next(s)) for s in streams]
               for _ in range(steps)]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    params = store.pull_all()
    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        step_losses = []
        for w in range(workers):
            loss, grads, _ = value_and_grad(loss_fn, params, batches[step][w])
            step_losses.append(loss)
            store.push_all(grads, worker=w)
        params = store.pull_all()
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(torch.stack(step_losses).mean())
    losses = [float(x) for x in losses]
    nbytes = store.bytes_pushed + store.bytes_pulled
    ps.shutdown()
    return losses, times, _flat_np(params), nbytes


def phase_mnist_local():
    small = {}
    for device in ("cpu", "cuda"):
        losses, _, params, _ = _mnist_sync(device, 32, 2, 32, 10)
        small[device] = (losses, params)
    err = _close_to_cpu(small["cuda"], small["cpu"], "MNIST local, small")
    log(f"MNIST local PS, small (hidden 32, 2 workers x 32, 10 sgd steps): "
        f"the card equals the CPU within {MNIST_TOL} (losses "
        f"{[round(x, 5) for x in small['cuda'][0]]}; params max abs err "
        f"{err:.3g}); card {_card_line()}")
    _launch_counts(reset=True)
    losses, times, params, nbytes = _mnist_sync(
        "cuda", MNIST_HIDDEN, MNIST_WORKERS, MNIST_BATCH, MNIST_STEPS)
    _no_launches("MNIST local PS, full width")
    if not np.all(np.isfinite(losses)) or not all(
            np.all(np.isfinite(v)) for v in params.values()):
        raise AssertionError("non-finite loss or params")
    if not np.mean(losses[-10:]) < np.mean(losses[:10]) - 1.0:
        raise AssertionError(f"loss did not fall: {losses}")
    step_ms = float(np.median(times[1:])) * 1e3
    step_bytes = nbytes / MNIST_STEPS
    log(f"main path: MNIST MLP 784-{MNIST_HIDDEN}-10 through "
        f"init(backend='local') on cuda:0, {MNIST_WORKERS} workers x batch "
        f"{MNIST_BATCH}, sgd 0.1, {MNIST_STEPS} steps of push_all/pull_all, "
        f"loss {np.mean(losses[:10]):.4f} (first 10) -> "
        f"{np.mean(losses[-10:]):.4f} (last 10)")
    log(f"main path: median step {step_ms:.4f} ms (host clock, synchronized, "
        f"step 0 excluded; step 0 {times[0] * 1e3:.1f} ms), "
        f"{1e3 / step_ms:.1f} steps/s, push+pull {step_bytes / 1e6:.4f} MB "
        f"a step, {step_bytes / step_ms / 1e6:.4f} GB/s; card {_card_line()}")
    return step_ms


def _async_store(device, workers):
    import ps_tpu_torch as ps
    from ps_tpu_torch.examples.train_mnist_async import build

    ctx = ps.init(backend="cuda", mode="async", num_workers=workers,
                  dc_lambda=0.04, device=device)
    params, loss_fn = build(0, ctx.device)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1, mode="async")
    store.init(params)
    return store, store.make_async_step(loss_fn)


def _async_batches(store, workers, cycles):
    from ps_tpu_torch.data.synthetic import mnist_batches

    streams = [mnist_batches(ASYNC_BATCH, seed=0, worker=w,
                             num_workers=workers) for w in range(workers)]
    return [[store.shard_batch(next(s)) for _ in range(cycles)]
            for s in streams]


def _mnist_async(device):
    """Config 5's single-process trainer: round-robin make_async_step over
    ASYNC_WORKERS workers for ASYNC_CYCLES cycles, batches placed first.
    Returns the losses, the cycle times, the params and the histogram."""
    import ps_tpu_torch as ps

    store, run = _async_store(device, ASYNC_WORKERS)
    batches = _async_batches(store, ASYNC_WORKERS,
                             ASYNC_CYCLES // ASYNC_WORKERS)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    losses, times = [], []
    for step in range(ASYNC_CYCLES):
        w = step % ASYNC_WORKERS
        t0 = time.perf_counter()
        losses.append(run(batches[w][step // ASYNC_WORKERS], worker=w))
        sync()
        times.append(time.perf_counter() - t0)
    losses = [float(x) for x in losses]
    if store._engine.version != ASYNC_CYCLES:
        raise AssertionError(f"version {store._engine.version}")
    out = (losses, times, _flat_np(store.params()),
           dict(sorted(store.staleness_histogram.items())))
    ps.shutdown()
    return out


def _async_threads(device):
    """STRESS_THREADS host threads, one async worker each, STRESS_CYCLES
    cycles each, on ``device``. Returns the store's engine, its keys, its
    histogram, its params and the seconds the threads took."""
    import threading

    import ps_tpu_torch as ps

    store, run = _async_store(device, STRESS_THREADS)
    batches = _async_batches(store, STRESS_THREADS, STRESS_CYCLES)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    errors = []

    def worker(w):
        try:
            for batch in batches[w]:
                run(batch, worker=w)
        except Exception as e:  # reported below
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(STRESS_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    sync()
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"threaded async workers failed: {errors}")
    eng, keys = store._engine, store.keys()
    hist = dict(sorted(store.staleness_histogram.items()))
    params = _flat_np(store.params())
    ps.shutdown()
    return eng, keys, hist, params, secs


def phase_mnist_async():
    _launch_counts(reset=True)
    runs = {device: _mnist_async(device) for device in ("cpu", "cuda")}
    _no_launches("MNIST async, round-robin")
    err = _close_to_cpu(*((runs[d][0], runs[d][2]) for d in ("cuda", "cpu")),
                        "MNIST async")
    losses, times, _, hist = runs["cuda"]
    if hist != runs["cpu"][3]:
        raise AssertionError(f"staleness histograms {hist} vs "
                             f"{runs['cpu'][3]}")
    cycle_ms = float(np.median(times[ASYNC_WORKERS:])) * 1e3
    log(f"MNIST async DC-ASGD: backend 'cuda', mode 'async', {ASYNC_WORKERS} "
        f"workers round-robin, hidden 32, batch {ASYNC_BATCH}, dc_lambda 0.04, "
        f"{ASYNC_CYCLES} cycles: the card equals the CPU within {MNIST_TOL} "
        f"(params max abs err {err:.3g}); loss {np.mean(losses[:6]):.4f} "
        f"(first 6) -> {np.mean(losses[-6:]):.4f} (last 6); staleness "
        f"histogram {hist}; card {_card_line()}")
    log(f"MNIST async: median cycle {cycle_ms:.4f} ms (host clock, "
        f"synchronized, first round excluded), {1e3 / cycle_ms:.1f} cycles/s; "
        f"card {_card_line()}")
    _launch_counts(reset=True)
    eng, keys, hist, params, secs = _async_threads("cuda")
    _no_launches("MNIST async, threaded")
    total = STRESS_THREADS * STRESS_CYCLES
    counts = (eng.version, eng._applies, set(eng.apply_count.values()),
              sum(hist.values()))
    if counts != (total, total * len(keys), {total}, total):
        raise AssertionError(f"threaded async invariants: (version, applies, "
                             f"apply counts, histogram sum) = {counts}")
    if not all(np.all(np.isfinite(v)) for v in params.values()):
        raise AssertionError("threaded async: non-finite parameters")
    log(f"MNIST async, {STRESS_THREADS} host threads x {STRESS_CYCLES} "
        f"cycles on the card: version {eng.version}, {eng._applies} key "
        f"applies, every key applied {total} times, staleness histogram "
        f"{hist}; {total / secs:.1f} cycles/s over {secs * 1e3:.1f} ms; "
        f"card {_card_line()}")
    return cycle_ms


def _state_of(dense=None, tables=()):
    """Clones of everything a resume must bring back: a dense store's
    params and optimizer state, and each (name, SparseEmbedding)'s table
    and per-row state."""
    from ps_tpu_torch import checkpoint as ckpt
    from ps_tpu_torch.kv import keys

    out = {}
    if dense is not None:
        flat, _ = keys.flatten_with_keys(dense.params())
        out.update({f"param/{k}": v.detach().clone() for k, v in flat.items()})
        for i, t in ckpt.flatten_leaves(dense._engine._state).items():
            out[f"opt/{i}"] = t.clone()
    for name, emb in tables:
        out[f"{name}/table"] = emb.table.clone()
        for i, t in ckpt.flatten_leaves(emb.state()).items():
            out[f"{name}/opt/{i}"] = t.clone()
    return out


def _differs(got, want):
    """Names whose tensors are not bitwise equal, with their max abs
    difference."""
    out = {}
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            out[k] = float((g.double() - w.double()).abs().max())
    return out


def _hold_bitwise(what, resumed, first, second):
    """The resumed state equals the uninterrupted one bitwise, and the
    uninterrupted run equals itself; either failing raises, naming the
    tensors and how far apart they are."""
    again = _differs(second, first)
    if again:
        raise AssertionError(f"{what}: the uninterrupted run differs from "
                             f"itself on the card in {len(again)} tensors: "
                             f"{dict(list(again.items())[:6])}")
    diff = _differs(resumed, first)
    if diff:
        raise AssertionError(f"{what}: the resumed run differs from the "
                             f"uninterrupted one in {len(diff)} tensors: "
                             f"{dict(list(diff.items())[:6])}")
    log(f"{what}: resumed = uninterrupted, bitwise, over {len(first)} "
        f"tensors ({sum(t.numel() for t in first.values()):,} elements); "
        f"the uninterrupted run repeats itself bitwise")


def _timed(fn):
    """Seconds ``fn()`` takes on the host clock, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _save_breakdown(store, path):
    """Where one save's time goes, step by step as ``checkpoint.save``
    takes them: the copies off the card, ``torch.save`` into the page
    cache, and the ``fsync`` that makes the file durable."""
    from ps_tpu_torch import checkpoint as ckpt

    arrays, _ = store._engine.state_dict()
    flat = {}
    copy_s = _timed(lambda: flat.update(
        {f"{g}/{n}": ckpt.to_cpu(t) for g, group in arrays.items()
         for n, t in group.items()}))
    with open(path, "wb") as f:
        t0 = time.perf_counter()
        torch.save(flat, f)
        f.flush()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        fsync_s = time.perf_counter() - t0
    os.remove(path)
    return copy_s, write_s, fsync_s


def _report_checkpoint(what, path, save_s, restore_s):
    """Print one checkpoint's bytes on disk and its save and restore
    rates; return (bytes, save s, restore s)."""
    from ps_tpu_torch import checkpoint as ckpt

    nbytes = ckpt.nbytes(path)
    log(f"checkpoint {what}: {nbytes:,} bytes; save {save_s:.4f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s), restore file to device "
        f"{restore_s:.4f} s ({nbytes / restore_s / 1e9:.3f} GB/s); card "
        f"{_card_line()}")
    return nbytes, save_s, restore_s


def _resume_widedeep(tmp):
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import criteo_batches
    from ps_tpu_torch.models.wide_deep import WideDeepConfig
    from ps_tpu_torch.ops import sparse_apply as ops

    cfg = WideDeepConfig()
    half = CKPT_WD_STEPS // 2
    host = list(criteo_batches(BATCH, vocab_size=cfg.per_feature_vocab,
                               seed=1, steps=CKPT_WD_STEPS))

    def start():
        _, dense, deep, wide, run = _widedeep(cfg, "cuda", seed=0)
        return dense, deep, wide, run, [dense.shard_batch(b) for b in host]

    def state(dense, deep, wide):
        return _state_of(dense, (("deep", deep), ("wide", wide)))

    runs = []
    for _ in range(2):
        dense, deep, wide, run, batches = start()
        for b in batches:
            run(b)
        runs.append(state(dense, deep, wide))
        ps.shutdown()
    names = ("dense", "deep", "wide")
    paths = {n: os.path.join(tmp, f"wd_{n}") for n in names}
    dense, deep, wide, run, batches = start()
    for b in batches[:half]:
        run(b)
    save_s = {n: _timed(lambda o=o, n=n: o.save(paths[n]))
              for n, o in zip(names, (dense, deep, wide))}
    del dense, deep, wide, run, batches
    ps.shutdown()
    dense, deep, wide, run, batches = start()  # the step built before restore
    sizes = {}
    for n, o in zip(names, (dense, deep, wide)):
        restore_s = _timed(lambda o=o, n=n: o.restore(paths[n]))
        sizes[f"W&D {n}"] = _report_checkpoint(f"W&D {n}", paths[n],
                                               save_s[n], restore_s)
    _launch_counts(reset=True)
    for b in batches[half:]:
        run(b)
    torch.cuda.synchronize()
    counts, by_rule = _launch_counts(), dict(ops.LAUNCHES_BY_RULE)
    want = {"sparse_apply": 2 * half, "sparse_group": 2 * half,
            "flash_attention/fwd": 0}
    if counts != want or by_rule != {"adagrad": half, "sgd": half}:
        raise AssertionError(f"W&D resumed half: launches {counts} "
                             f"{by_rule}, expected {want}")
    _hold_bitwise(f"W&D resume ({CKPT_WD_STEPS} steps against {half} + "
                  f"save + restore + {half}; launches in the resumed half "
                  f"{counts})", state(dense, deep, wide), *runs)
    ps.shutdown()
    return sizes


def _bert_grads_twice(model, batch):
    """The BERT loss's gradient at ``model``'s weights on one batch, twice
    on the card: ``{name: max abs difference}`` of the gradients that
    differ between the two."""
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.kv.store import to_device, value_and_grad
    from ps_tpu_torch.models.bert import make_mlm_loss_fn

    flat, treedef = keys.flatten_with_keys(model.param_tree())
    params = keys.unflatten(treedef, {k: v.detach().cuda()
                                      for k, v in flat.items()}, list(flat))
    batch = to_device(batch, "cuda")
    grads = []
    for _ in range(2):
        _, g, _ = value_and_grad(make_mlm_loss_fn(model), params, batch)
        grads.append(keys.flatten_with_keys(g)[0])
    torch.cuda.synchronize()
    return _differs(*grads)


def _resume_bert(tmp):
    """BERT-base resume, first with PyTorch's default algorithms (whose
    one non-deterministic op on this path, F.embedding's backward over the
    token-type ids, makes the uninterrupted run differ from itself: the
    phase prints that spread and the resumed run's distance, and holds the
    restored state to the saved one bitwise), then with
    torch.use_deterministic_algorithms(True), which gives that op its
    deterministic kernel: there the resumed run must equal the
    uninterrupted one bitwise."""
    import warnings

    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import mlm_batches
    from ps_tpu_torch.models.bert import BertConfig, BertMLM, make_mlm_loss_fn

    cfg = BertConfig(attn="flash")
    model = BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    half = CKPT_BERT_STEPS // 2
    host = list(mlm_batches(BERT_BATCH, BERT_SEQ, vocab_size=cfg.vocab_size,
                            seed=1, steps=CKPT_BERT_STEPS))
    per_step = {"sparse_apply": 0, "sparse_group": 0,
                "flash_attention/fwd": cfg.num_layers}

    def start():
        ps.init(backend="cuda")
        store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                           weight_decay=0.01, placement="sharded")
        store.init(model.param_tree())
        return (store, store.make_step(make_mlm_loss_fn(model)),
                [store.shard_batch(b) for b in host])

    def steps(run, batches):
        _launch_counts(reset=True)
        for b in batches:
            run(b)
        torch.cuda.synchronize()
        counts = _launch_counts()
        want = {k: v * len(batches) for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"BERT: launches {counts}, expected {want}")
        return counts

    def uninterrupted():
        store, run, batches = start()
        steps(run, batches)
        out = _state_of(store)
        ps.shutdown()
        return out

    def resumed(path):
        store, run, batches = start()
        steps(run, batches[:half])
        saved = _state_of(store)
        parts = _save_breakdown(store, path + ".parts")
        save_s = _timed(lambda: store.save(path))
        del store, run, batches
        ps.shutdown()
        store, run, batches = start()  # the step built before the restore
        restore_s = _timed(lambda: store.restore(path))
        lost = _differs(_state_of(store), saved)
        if lost:
            raise AssertionError(f"BERT: the restored state differs from the "
                                 f"saved one: {dict(list(lost.items())[:6])}")
        counts = steps(run, batches[half:])
        out = _state_of(store)
        ps.shutdown()
        return out, save_s, restore_s, counts, parts

    what = (f"BERT-base resume (bf16, flash, {BERT_BATCH} x {BERT_SEQ}, LAMB; "
            f"{CKPT_BERT_STEPS} steps against {half} + save + restore + "
            f"{half})")
    grads = _bert_grads_twice(model, host[0])
    first, second = uninterrupted(), uninterrupted()
    spread = _differs(second, first)
    out, save_s, restore_s, counts, parts = resumed(os.path.join(tmp, "bert"))
    size = _report_checkpoint("BERT-base (params, LAMB mu, nu, count)",
                              os.path.join(tmp, "bert"), save_s, restore_s)
    log(f"checkpoint BERT-base, one save's parts: copies off the card "
        f"{parts[0]:.4f} s, torch.save into the page cache {parts[1]:.4f} s, "
        f"fsync {parts[2]:.4f} s; card {_card_line()}")
    dist = _differs(out, first)
    log(f"{what}, default algorithms: one gradient taken twice differs in "
        f"{grads or 'no tensor'}; the uninterrupted run differs from itself "
        f"in {len(spread)} of {len(first)} tensors (max abs "
        f"{max(spread.values(), default=0.0):.3g}); the resumed run differs "
        f"from it in {len(dist)} (max abs {max(dist.values(), default=0.0):.3g}"
        f"); the restored state equals the saved one bitwise; launches in the "
        f"resumed half {counts}")
    del first, second, out
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            first, second = uninterrupted(), uninterrupted()
            out, _, _, counts, _ = resumed(os.path.join(tmp, "bert_det"))
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:160] for w in caught
                     if "determinis" in str(w.message)})
    if nondet:
        raise AssertionError(f"BERT: ops without a deterministic version: "
                             f"{nondet}")
    _hold_bitwise(f"{what}, torch.use_deterministic_algorithms(True); "
                  f"launches in the resumed half {counts}", out, first,
                  second)
    return size


def _local_sync_store():
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.models.mlp import MLP, make_loss_fn

    ctx = ps.init(backend="local", num_workers=MNIST_WORKERS, device="cuda")
    model = MLP(hidden=MNIST_HIDDEN)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1)
    store.init(model.init(torch.Generator().manual_seed(0),
                          device=ctx.device))
    streams = [mnist_batches(MNIST_BATCH, seed=1, worker=w,
                             num_workers=MNIST_WORKERS,
                             steps=CKPT_MNIST_STEPS)
               for w in range(MNIST_WORKERS)]
    batches = [[store.shard_batch(next(s)) for s in streams]
               for _ in range(CKPT_MNIST_STEPS)]
    return store, make_loss_fn(model), batches


def _local_sync_steps(store, loss_fn, batches):
    """Config 1's protocol: every worker's gradient against the pulled
    params, push_all each, then one pull_all."""
    from ps_tpu_torch.kv.store import value_and_grad

    params = store.pull_all()
    for step in batches:
        for w, batch in enumerate(step):
            _, grads, _ = value_and_grad(loss_fn, params, batch)
            store.push_all(grads, worker=w)
        params = store.pull_all()


def _resume_small(tmp):
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv import keys

    half = CKPT_MNIST_STEPS // 2
    runs = []
    for _ in range(2):
        store, loss_fn, batches = _local_sync_store()
        _local_sync_steps(store, loss_fn, batches)
        runs.append(_state_of(store))
        ps.shutdown()
    path = os.path.join(tmp, "mnist_local")
    store, loss_fn, batches = _local_sync_store()
    _local_sync_steps(store, loss_fn, batches[:half])
    save_s = _timed(lambda: store.save(path))
    ps.shutdown()
    store, loss_fn, batches = _local_sync_store()
    sizes = {"config 1": _report_checkpoint(
        "config 1 (local PS)", path, save_s,
        _timed(lambda: store.restore(path)))}
    _local_sync_steps(store, loss_fn, batches[half:])
    if set(store._engine.apply_count.values()) != {CKPT_MNIST_STEPS}:
        raise AssertionError(f"config 1 apply counts "
                             f"{store._engine.apply_count}")
    _hold_bitwise(f"config 1 resume (local, sync, {MNIST_WORKERS} workers x "
                  f"{MNIST_BATCH}, 784-{MNIST_HIDDEN}-10, sgd; "
                  f"{CKPT_MNIST_STEPS} steps against {half} + save + restore "
                  f"+ {half})", _state_of(store), *runs)
    ps.shutdown()

    half = CKPT_ASYNC_CYCLES // 2
    rounds = CKPT_ASYNC_CYCLES // ASYNC_WORKERS

    def cycles(store, run, batches, lo, hi):
        for c in range(lo, hi):
            w = c % ASYNC_WORKERS
            run(batches[w][c // ASYNC_WORKERS], worker=w)

    def counters(store):
        eng = store._engine
        return (eng.version, eng._applies, dict(eng.staleness_hist),
                dict(eng._worker_version))

    runs, refs = [], []
    for _ in range(2):
        store, run = _async_store("cuda", ASYNC_WORKERS)
        cycles(store, run, _async_batches(store, ASYNC_WORKERS, rounds), 0,
               CKPT_ASYNC_CYCLES)
        runs.append(_state_of(store))
        refs.append(counters(store))
        ps.shutdown()
    path = os.path.join(tmp, "mnist_async")
    store, run = _async_store("cuda", ASYNC_WORKERS)
    cycles(store, run, _async_batches(store, ASYNC_WORKERS, rounds), 0, half)
    save_s = _timed(lambda: store.save(path))
    ps.shutdown()
    store, run = _async_store("cuda", ASYNC_WORKERS)  # built before restore
    sizes["config 5"] = _report_checkpoint(
        "config 5 (async, stale snapshots)", path, save_s,
        _timed(lambda: store.restore(path)))
    eng = store._engine
    for w in range(ASYNC_WORKERS):
        cached, _ = keys.flatten_with_keys(store._async_params[w])
        if not all(cached[k] is eng._stale[(w, k)] for k in store.keys()):
            raise AssertionError(f"config 5: worker {w}'s restored cached "
                                 f"pull is not its stale snapshot")
    cycles(store, run, _async_batches(store, ASYNC_WORKERS, rounds), half,
           CKPT_ASYNC_CYCLES)
    if counters(store) != refs[0] or refs[0] != refs[1]:
        raise AssertionError(f"config 5 counters {counters(store)} vs "
                             f"{refs}")
    _hold_bitwise(f"config 5 resume (cuda async, {ASYNC_WORKERS} workers "
                  f"round-robin, make_async_step; {CKPT_ASYNC_CYCLES} cycles "
                  f"against {half} + save + restore + {half}; each restored "
                  f"worker's cached pull is its stale snapshot; version, "
                  f"applies, staleness histogram {refs[0][2]} equal)",
                  _state_of(store), *runs)
    ps.shutdown()
    return sizes


def phase_checkpoint_resume():
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ps_ckpt_") as tmp:
        sizes = _resume_widedeep(tmp)
        sizes["BERT-base"] = _resume_bert(tmp)
        sizes.update(_resume_small(tmp))
    log(json.dumps({"checkpoints": {
        name: {"bytes": b, "save_s": s, "save_gbps": b / s / 1e9,
               "restore_s": r, "restore_gbps": b / r / 1e9}
        for name, (b, s, r) in sizes.items()}, "card": _card_line()}))


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
    by_rule, group_launches, _ = phase_main_path()
    entries = phase_timings(errs, by_rule, group_launches)
    flash_err = phase_flash_vs_plain()
    phase_bert_small_vs_cpu()
    phase_bert_flash_vs_full()
    launches, _ = phase_bert_main_path()
    entries.append(phase_flash_timings(flash_err, launches))
    phase_resnet_vs_cpu()
    phase_resnet_main_path()
    phase_mnist_local()
    phase_mnist_async()
    phase_checkpoint_resume()
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
