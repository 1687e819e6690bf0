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
   ragged length (B 2, S 200, h 4, d 64), BERT-base's (B 32, S 512,
   h 12, d 64) and a rank's of phase 15 (e) (B 16); exact zeros and
   lse = -1e30 on rows that
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
   uninterrupted run twice, which must repeat itself bitwise: (a)
   Wide-&-Deep at the full published width of phase 4, 20
   steps against 10, a save of the dense store and both tables, a fresh
   store and fresh tables, a restore and 10 more steps: dense params, both
   tables and every optimizer state equal, and the resumed half launches
   the grouping pass and the apply 2 + 2 times a step; (b) BERT-base as in
   phase 7, 4 LAMB steps against 2, save, a fresh store, restore, 2, 12
   flash launches a step, with PyTorch's default algorithms (one gradient
   taken twice must be the same bitwise: the embeddings' backward sums in
   a fixed order) and again with torch.use_deterministic_algorithms(True):
   params and LAMB state equal the uninterrupted run's, which repeats
   itself, bitwise, and the restored state the saved one; (c) config 1
   (local,
   sync, 784-256-10, 2 workers x 128, 20 sgd steps against 10 + 10) and
   config 5 (cuda async, 3 workers round-robin through make_async_step,
   12 cycles against 6 + 6): params and counters equal, and each restored
   worker's cached pull is the very tensor restored as its stale
   snapshot. Each checkpoint's bytes on disk, save and restore (file to
   device) seconds and GB/s are printed, under a temporary directory. A
   checkpoint of ps_tpu converted by from_reference is restored by the
   CPU tests (tests/test_torch_checkpoint.py), which need jax to write
   one; this machine has none.

14. NCCL at one rank: init(backend='cuda') through coordinator_uri with
   num_processes=1; the W&D composite step at full width (5 steps) and a
   small ResNet (Bottleneck, stages (1, 1, 1, 1), bf16, 224², batch 32, 2
   steps, cuDNN's deterministic algorithms for both runs), with placement
   'replicated' and 'sharded', equal the one-device path bitwise; the
   recorded collectives run and move 0 bytes; the async DC-ASGD server
   (config 5: the MLP 784-256-10, 3 workers round-robin, 60 cycles,
   'replicated' and 'sharded') equals the one-device path bitwise;
15. two ranks on the one card over gloo, asked for by name (NCCL refuses
   two ranks on a device), as two worker processes of this script: W&D
   at full width (global batch 512, 256 a rank) for 20 steps with the
   gather and the a2a exchange (capacity factor 2): losses within rtol
   1e-5 of one process, tables, row state and adam slices within rtol
   1e-4 / atol 1e-6, 2 + 2 sparse launches a rank a step on the grouping
   pass's cluster path (the dense parameters' deviation is printed); the
   same within rtol 1e-4 / atol 1e-6 for everything at the reference's
   shard-parity configuration (vocab 50, D 8, MLP (32, 16), batch 16, 3
   steps); the sparse kernels timed at a rank's shape; a 2-rank save of
   the W&D stores restored into one process with elastic=True, bitwise;
   ResNet-50 at 224², bf16, global batch 256 (128 a rank), sharded, 3
   steps with cross-rank BatchNorm, its first step's loss and
   batch_stats against one process on the global batch. Then a second
   pair of worker processes: (e) BERT-base MLM as phase 7 (flash, seq
   512, global batch 32 as 16 a rank, lr 1e-3, wd 0.01) with LAMB
   'sharded' across the two ranks, whose trust ratio reduces its norms
   over the ranks: 3 bf16 steps, losses finite, falling and within the
   bf16 loss gate of one process on the same global batches, 12 flash
   launches a rank a step; one f32 step, its applied update per tensor
   within TWO_BERT_UPDATE_GATES (relative 2-norm) of one process's and
   of 'replicated' on the same two ranks, and a control whose trust ratio
   takes each rank's shard-local norm at least 10x outside both gates;
   each rank's step ms and peak memory (phase 6 holds the flash kernel
   against its plain version at a rank's shape too); (f) config 5 across
   the two ranks: the MLP 784-256-10, 3 logical workers round-robin,
   batch 64 split over the ranks, 'replicated' and 'sharded': after 60
   cycles (phase 12's) against one process's async server on the same
   global batches, params within 1e-5, version, staleness histogram and
   apply counts exactly; after 180 cycles bitwise against a witness (one
   process pushing the mean of the two half batches' gradients), with
   one process on the whole batches for as long printed beside it; both
   ranks' params bitwise equal, collective_bytes the analytic value,
   cycles/s a rank, no kernel launched. Step times and collective bytes
   are printed; through host memory, they are a correctness run's, not
   a speed figure.
16. the van plane (config 5 across processes, over loopback TCP; no
   kernel of the port is on this path, and the launch counts must read 0
   around it): (a) one ``--role server`` process of
   ps_tpu_torch/examples/train_mnist_async.py (parameters on the card,
   full event log) and 3 ``--role worker`` processes (gradients on the
   card), MLP hidden 32, batch 64, lr 0.1, dc_lambda 0.04, 60 cycles a
   worker: the event log replayed through a one-process server, each
   gradient recomputed from what its worker pulled, equals the server's
   params bitwise on the card; a CPU witness in lockstep recomputes every
   gradient from the card's pulled params, within 1e-5 of the card's
   (the 2-norm difference over the gradient's norm, floored at the run's
   median), and ends within 1e-5 of the server's params
   (a CPU replay on its own trajectory, whose gradients feed back its own
   rounding, is printed); every loss finite; the loss of the initial and of the final params on
   a held-out batch and the staleness histogram are printed; (b) the
   same over a two-server key partition, replayed per shard; (c) one
   worker, serial against bucketed (16 KiB buckets, pool 2; bitwise the
   same params) and ``--overlap`` (the serial losses, loss for loss);
   (d) two ranks on the
   card over gloo with heartbeats on (timeout 500 ms): one dies hard and
   the other's ``check_health()`` names it within 2 s; a server process
   is killed and its worker raises ``ServerFailureError`` naming server 0;
   (b)-(d) run at once; pinned staging: 3 concurrent workers on the card
   (one serial, two bucketed), 200 pulls and push_pulls of a 7 MB tree,
   every pulled tree bitwise the event-log replay; (e) MNIST cycles/s
   (every cycle after each worker's first over the shared window from
   the first worker's second cycle to the last worker's end) and the
   median cycle split into compute and van time, from (a); a
   BERT-base-shaped f32 tree (442,939,392 bytes, tools/bench_van.py's
   shape) between a server and worker threads on the card: pull and
   push_pull GB/s with 1 and 3 workers and the staging copies' share of
   a cycle. Run it alone with ``python3 -c "import chip_smoke as c,
   tempfile; c.phase_van(tempfile.mkdtemp())"``.
17. the sparse PS across processes (config 4, Wide-&-Deep's published
   width): (a) two ``serve_sparse`` server processes, shard s of 2 of
   2,600,000 rows, each holding its 1,300,000 rows of the deep table
   ([*, 16], adagrad) and the wide one ([*, 1], sgd), lr 0.05, from a
   numpy seed, on the card, and three ``connect_sparse`` worker processes
   (``tests/test_torch_van_harness.py``'s sparse roles) x 60 cycles of
   one Criteo-like batch's 13,312 global ids, their ids and grads on the
   card, even cycles pull then push, odd ones push_pull: each apply log
   has its expected length; replayed through the port's tables on the
   card it gives the servers' tables and state bitwise, and every pulled
   row set equals, bitwise, the replay's rows at the versions its reply
   carried; replayed through the torch tier on the CPU it gives sgd
   bitwise and adagrad within rtol 1e-6 / atol 1e-7; each applied push
   launched 2 grouping (cluster path) + 2 apply kernels in its server;
   (b) one worker, serial against bucketed (16 KiB buckets, pool 2):
   bitwise the same tables, and a pull after ``push_async`` sees that
   push; (c) ``checkpoint_all`` mid-run over both shards, both servers
   restarted from it: the continued run equals the uninterrupted one
   bitwise; (d) a SIGKILLed server 0 raises ``ServerFailureError`` naming
   server 0; (e) the masked full-table 'off' tier against the kernels at
   phase 4's shape, 5 pushes: sgd bitwise, adagrad within rtol 1e-6 /
   atol 1e-7; (f) cycles/s over one shared window, the median pull, push
   and push_pull, each server's median sparse apply and rows/s, the
   staging share of a cycle, and both sparse kernels timed at a server
   shard's shape (the median routed push) against their bound. Run it
   alone with ``python3 -c "import chip_smoke as c, tempfile;
   c.phase_build(); c.phase_sparse_ps(tempfile.mkdtemp())"``.

18. the 'model', 'seq' and 'pipe' axes (item 7), two ranks sharing the card
   over gloo as in phase 15: (a) BERT-base MLM under the trainer's
   ``--model-axis 2`` (phase 7's configuration, ``{data: 1, model: 2}``,
   ``bert_partition_rules``, LAMB 'sharded'): each rank runs the flash
   kernel on its 6 of 12 heads, 12 launches a rank a step; 3 bf16 steps
   against one process within AXES_BF16_LOSS_GATE; one f32 step whose loss
   is held to one process's within 1e-5 and whose update, per tensor,
   within phase 15's one-process gate, with a control that skips the
   row-parallel all-reduce landing 10x outside both; the kernel held
   against its plain version at a rank's shape, [192, 512, 64] bf16, and
   timed beside SDPA; (b) the long-context LM at the reference trainer's
   defaults (vocab 256, d_model 64, 8 heads, 2 layers, seq 256, batch 8,
   adam 3e-3, 'sharded'), 6 steps: one process with 'full' on the card,
   then two ranks on ``{data: 1, seq: 2}`` with 'ring' and with
   'ulysses', and on ``{data: 1, pipe: 2}`` with 2 microbatches, each
   within the reference's 2e-4 of one process; the trainer itself
   (``python -m ps_tpu_torch.examples.train_longctx_lm --mesh
   data=1,seq=2 --attn ring``) on two processes, its final loss within
   2e-4; (c) the causal flash kernel through ``lm.make_attn_fn('flash')``
   at d_model 512, 8 heads, seq 2048 (head width 64), f32 and bf16,
   against its plain version, timed beside SDPA's causal call, and one
   LM training step with ``attn='flash'`` (2 launches) against 'full'.
   Run it alone with ``python3 -c "import chip_smoke as c, tempfile;
   c.phase_build(); c.phase_axes(tempfile.mkdtemp())"``.
19. the van's transport options on the card (ROADMAP items 5.1-5.3): (a)
   phase 17 (a)'s sparse PS (two ``serve_sparse`` processes of 1,300,000
   rows, deep adagrad and wide sgd; three ``connect_sparse`` processes x
   30 cycles of 13,312 ids) with the servers on the native epoll loop,
   run twice: every worker over TCP, so that every frame is decoded,
   staged onto the card and freed by the loop's pump (the pump must
   dispatch exactly the workers' pushes and native admission classify
   exactly their flat ROW_PUSH frames, some of them fresh), then every
   worker over the shm lane (each connection detached to a serve thread:
   the ring frames counted, none spilled to TCP); in both each apply log
   replays on the card to the servers' tables and state bitwise, every
   pulled row set equals the replay's at its versions, and each push
   launched 2 grouping + 2 apply kernels; (b) the servers on the loop,
   workers 0-1 over TCP and worker 2 over the rings, the row grads int8-
   (seeded by the worker id) and then cast16-compressed above
   compress_min_bytes (65,536): the checks of (a) for each lane, the
   decoded grads replayed bitwise (each worker's codec run again in its
   order), deep's grads encoded and wide's and the ids raw, the bytes
   pushed against (a)'s printed; (c) config 5 (phase 16 (a)'s MLP, 3
   worker processes x 60 cycles, bucketed as phase 16 (c)) with the
   server on the native loop in this process, workers 0 (topk) and 2
   (cast16 pushes and pulls) over TCP through the loop, worker 1 (topk)
   over the rings: the loop's pump dispatched a bucket frame at least
   for every TCP push, the event log replays on the card with every
   codec bitwise, and a replay of worker 0's last push with its own
   nonce is acked inside the loop (the native ack count rises, the
   version and the event log do not move); (d) times, printed and not
   held: sparse cycles/s and the median pull, push and push_pull of
   (a)'s two runs against phase 17 (f)'s thread per connection over
   TCP, config 5's cycles/s against phase 16 (e)'s, and the
   442,939,392-byte tree's pull and push_pull GB/s over bucketed (4 MiB)
   rings against TCP. Run it alone (it then runs phase 17 (a) over TCP
   for its comparison) with ``python3 -c "import chip_smoke as c,
   tempfile; c.phase_build(); c.phase_transport(tempfile.mkdtemp())"``.
20. replication and live failover on the card (ROADMAP item 5.6,
   ``ps_tpu_torch/replica/``): (a) phase 17 (a)'s sparse PS (W&D's width,
   two shards of 1,300,000 rows, deep adagrad and wide sgd, three
   ``connect_sparse`` processes x 40 cycles of 13,312 ids) with each
   shard a ``serve_sparse`` primary process and a ``backup=True`` process
   with a ``PromotionWatch`` (horizon 1,000 ms), both on the card,
   attached with sync ack, the workers dialling ``p0|b0,p1|b1``: after
   20 cycles the workers pause and each backup's tables and row state
   must equal its primary's bitwise (SHA-256 of every table and state
   leaf) and each backup must have launched 2 grouping + 2 apply kernels
   a replicated push in its own process; then primary 0 is SIGKILLed and
   the workers run the other 20 cycles: backup 0 promotes with reason
   ``timeout``, every worker finishes after its failover, every push is
   applied once (none twice, none acked lost), the promoted backup's log
   replays through the port's tables on the card to its tables bitwise,
   and backup 1 ends bitwise primary 1; then (a) again, unkilled, with
   every primary and backup on the native loop and worker 0 over the
   rings: each backup bitwise its primary at the pause (with the same
   launches) and at the end, having applied the same pushes in the same
   order, and each primary's pump dispatched exactly the TCP workers'
   pushes; (b) config 5 (phase 16 (a)'s MLP hidden 32, batch 64, lr
   0.1, dc_lambda 0.04) through ``train_mnist_async.py
   --replicate-to/--beat`` and ``--backup --watch-port``, the primary
   SIGKILLed once worker 0 logged cycle 30 of 60: with one worker the
   losses and the final params bitwise an unkilled run's; with three the
   promoted backup's event log replayed on the card bitwise its params
   (a CPU witness in lockstep as in phase 16); (c) (a) with async ack and a
   window of 8, primary 0 SIGKILLed mid-traffic (once worker 0 finished
   cycle 20): the backups' lag never past 8, the run goes on, the promoted
   tables bitwise the replay of what it applied, at most 8 pushes short of
   all of them, and their distance from the unkilled replay printed; (d)
   printed, not held: sparse cycles/s and the median push unreplicated
   (phase 17 (f), the same call) against sync ack, async ack and sync ack
   on the loop, the sync ack's wait, the stream's bytes a push, kill to
   promotion, the detection's age and the flip, the workers' failover
   times, beside the card's name and power limit. Run it alone with
   ``python3 -c "import chip_smoke as c, tempfile; c.phase_build();
   c.phase_replication(tempfile.mkdtemp())"`` (its (d) then prints 0 for
   the unreplicated numbers).
21. the read path on the card (ROADMAP item 5.8): (a) phase 20 (a)'s two
   shards of W&D's tables, each a ``serve_sparse`` primary on the native
   loop with the default 64 MiB read cache and a sync-ack backup process
   (shard 0 also a frozen backup, never attached), a pusher process
   running phase 17's cycles at its natural rate and 4 reader processes,
   each with its own hot id-set of 13,312 Zipf-skewed ids: a raw READ's
   native hit bitwise the pump miss that published it and its rows
   bitwise a ROW_PULL at that version; on a 60-id set (120 ids over the
   two tables, within the 128-id tag cap) a disjoint push leaves the entry serving (one more
   hit, no miss) and a push into it drops it, the next read the
   post-apply rows; then 3-s windows of 2 and 4 readers under the
   pusher's churn, layered (``read_rows`` over ``p|b`` at
   ``read_staleness=0``, the cache on) and primary-only (the primaries,
   the cache off), each server read in a window (the backups too,
   layered) serving NOT_MODIFIED replies and row deltas; with the
   pusher stopped every reader's held rows
   (after its NOT_MODIFIED and delta replies) bitwise a full read with
   ``read_conditional`` off and a pull; replica reads served at bound 0;
   the frozen backup at bound 1 serves no read, each read it is asked
   falls back; every primary and backup launched 2 grouping + 2 apply
   kernels a push, each backup bitwise its primary, and the reads launch
   none; (b) config 5's server (``replica-primary`` of the van harness)
   on the loop with a sync-ack backup: a native hit bitwise its pump
   miss, ``read_all`` bitwise ``pull_all`` at the same version, a
   ``pull_cache`` reader served from its cache until its version
   watcher sees a push, then refetching, and a READ conditional on the
   version it then holds answered NOT_MODIFIED by the primary (the
   repeat a native hit, bitwise) and the backup; the 442,939,392-byte
   tree's ``read_all`` bitwise its ``pull_all``; (c) printed, not held:
   each window's reads/s, native-hit rate, NOT_MODIFIED replies and
   delta rows served, ``read_rows`` p50/p99, bytes a read, the pusher's
   cycles/s
   beside phase 17's, a warm read's bytes against a full read's, the
   tree's read GB/s and what the cache budget did with it. Run it alone
   with ``python3 -c "import chip_smoke as c, tempfile; c.phase_build();
   c.phase_read_path(tempfile.mkdtemp())"`` (phase 17's numbers then
   print as 0).
22. two-level aggregation on the card (ROADMAP item 5.5,
   ``ps_tpu_torch/backends/aggregator.py``; no kernel of the port is on
   this path: the launch counts are set to 0 before it and must read 0
   after it): (a) config 5's async server in this process on the card,
   the MNIST MLP at 784-256-10, behind an ``agg-server`` process of the
   van harness on the native loop (group 3) and three ``worker``
   processes given ``aggregator=`` over the rings, 30 lockstep rounds:
   with sgd at lr 0.5, integer gradients and an integer init the
   server's params bitwise the closed form; with DC-ASGD (dc_lambda
   0.04, lr 0.1, the MLP's seeded init) within 1e-5 of a CPU replay of
   the same merged rounds through the server's event log; 30 merged
   rounds at a realized fan-in of 3.0, the upstream bytes a round at or
   under the members' (a flat worker's frames) / 3 + 16 KiB, and the
   aggregator launched no kernel and never initialized CUDA; (b) the
   reference's two kill windows in this process with the server on the
   card (the aggregator killed after the merged commit, before any
   member's ack, and before the forward): each member degrades to the
   flat path once, every push applies once, bitwise, and the
   post-commit replays dedup through the members' tokens; then (a)'s
   group with its agg-server SIGKILLed once 15 merged rounds committed:
   each member degrades once, bitwise the closed form; (c) (a)'s sgd
   leg over a primary and a sync-ack backup process (phase 20's replica
   roles at 784-256-10), the aggregator in this process: after round
   15's commit the backup's READ is bitwise its primary's, the primary
   is SIGKILLed and the aggregator killed before the members' acks, the
   backup promotes, the members' replays (over TCP) dedup there through
   the replicated members' tokens, and its params end bitwise the
   closed form; (d) at (a)'s aggregator: a member READ bitwise the
   upstream's at the same version, its repeat a native hit bitwise the
   miss, a READ conditional on that version NOT_MODIFIED, serve ages
   under tier ``agg`` with none clamped; (e) printed, not held: (a)'s
   rounds/s, (b)'s members aggregated against flat, the ``agg_hold``
   p50/p99, and the 442,939,392-byte tree at fan-in 2 for 3 rounds: the
   upstream bytes a round against flat and the rates, beside the card's
   name and power limit. Run it alone with ``python3 -c "import
   chip_smoke as c, tempfile; c.phase_aggregation(tempfile.mkdtemp())"``
   (it needs no kernel build).

23. tiered embedding storage on the card (ROADMAP item 5.7,
   ``ps_tpu_torch/kv/tiered.py``): (a) in this process, W&D's deep table
   (26 x 100,000 rows, D 16, adagrad, lr 0.05) as a ``TieredTable`` of
   650,000 slots on the card over a pinned host arena (the table 4x the
   budget, admit_freq 2), against an all-hot ``SparseEmbedding`` of every
   row: 8 pushes confined to the hot set bitwise an untiered table of the
   budget's rows; 16 warm-up and 60 timed pushes of 13,312 ids (512 x 26
   fields, each field's ids zipf(1.3) % 100,000 plus its offset, a fresh
   batch a push, a pull of a quarter every 4th timed push): the rows hot since
   init and never moved bitwise, every row within rtol 1e-6 / atol 1e-7,
   the row sum within 1e-9 of the sum of |rows|, one grouping and one
   apply launch a push; ``save``/``restore`` bitwise; a TTL leg
   (evict_ttl_ms 1, 6 pushes) held the same way; tiered and all-hot
   rows/s, the hit rate, promotions and evictions per 1k pushes, the cold
   pass's p50/p99 and the hot tier's bytes on the card against the
   all-hot table's; (b) phase 20's layout with each shard's two tables
   tiered at rows // 4 (325,000 slots), every server on the native loop
   and each primary with a sync-ack backup, three workers over TCP x 30
   cycles: at cycle 5 this process reads a 13,312-id set through
   ``read_rows`` and runs ``checkpoint_all`` while the workers go on; at
   the workers' pause at cycle 15 every backup's directory, hot table,
   arena and cold state are bitwise its primary's (SHA-256), its launches
   2 + 2 a replicated push, and the conditional ``read_rows`` after the
   tier moves bitwise a pull; then primary 0 is SIGKILLed: backup 0
   promotes, every push is applied once, the applied logs replayed
   through tiered tables on the card give the servers' tables bitwise and
   through all-hot ones their row sums, and the checkpoint restored into
   fresh services is bitwise the logs' first pushes; cycles/s beside phase
   17's and the tier stats are printed; (c) two gloo ranks on the card,
   the table cut to 4 fields (400,000 rows, 100,000 slots), each rank
   pushing its half of 6 pushes: rank 0's move logs, the directory, both
   tiers and the row sum bitwise one process on the whole pushes. The
   kernels line gives each sparse kernel's launches here
   (``launches_tiered``). Run it alone with ``python3 -c "import
   chip_smoke as c, tempfile; c.phase_build();
   c.phase_tiered(tempfile.mkdtemp())"``.

25. elastic membership on the card (ROADMAP item 6.2): (a) config 5's
   784-256-10 MLP (momentum, DC λ 0.04) on two shards under a
   coordinator (no device) with two standbys, 3 worker threads x 40
   cycles through a split 2 -> 4 and a drain back, each key applied once
   a push and the servers' logs replayed key by key bitwise, a CPU
   witness within MNIST_TOL; (b) the 442,939,392-byte tree split 2 -> 3
   under a bucketed worker, the moved rows bitwise, the bytes, rate,
   freezes and re-routes printed; (c) phase 17's sparse shards as
   members, shard 1 replaced from its save, 2 + 2 launches a push and the
   tables bitwise (``launches_elastic``); (d) the fleet p99 equal to the
   members' raw histograms merged, the policy engine acting once and
   dry. Run it alone with ``python3 -c "import chip_smoke as c,
   tempfile; c.phase_build(); c.phase_elastic(tempfile.mkdtemp())"``.

26. the autopilot chaos soak on the card (ROADMAP item 6.3,
   ``ps_tpu_torch/chaos``): three card-resident shards and a subprocess
   member (``python -m ps_tpu_torch.chaos.member``) under a policy-on
   coordinator (no device), two hammer workers pushing the 12 x 16,384
   f32 tree through drills A-E (a slow apply, SIGSTOP, a blackhole, a
   reconnect storm, underload), then an aggregator killed mid-round and
   a subprocess primary SIGKILLed under a watch with a registered spare.
   Every fault heals within the reference's bound with no operator call
   in the soak window, each key's applies equal the pushes and its
   parameter is bitwise that many applies on one engine, the re-seeded
   spare is bitwise the survivor, the injector's seeded plan is printed,
   and no kernel is launched. Run it alone with ``python3 -c "import
   chip_smoke as c, tempfile; c.phase_chaos(tempfile.mkdtemp())"``.

27. a dense async server across ranks on the card (ROADMAP item 6.4,
   ``backends/op_stream.py``): two gloo ranks of one async store share
   the card, rank 0 serving and sending every engine call to rank 1 as
   an op first. (a) config 5 through ``train_mnist_async --role server``
   launched as 2 ranks (its defaults; the native loop on), a serial and
   a bucketed worker: both ranks' params bitwise each other and the
   event log's one-process replay on the card, its cycles/s against the
   same run on one rank; (b) config 5's MLP at 784-256-10 through
   ``init``/``KVStore(optimizer="adam", placement="sharded")``/
   ``serve_async`` (the ranks harness's served case): pushes, READ and
   NOT_MODIFIED, ``checkpoint_all`` restored into one process, a live
   move of half the keys to a one-process shard and back, a RESEED onto
   a one-process spare and its promotion, every reply and every rank's
   rows bitwise the same frames on one rank. No kernel of the port is
   launched in any rank. Run it alone with ``python3 -c "import
   chip_smoke as c, tempfile; c.phase_served_ranks(tempfile.mkdtemp())"``
   (no kernel build needed).

Every phase's seconds, and the whole script's, are printed on one line
before the kernels line.

It prints one JSON line per timed kernel, then the kernels line, then
``{"ok": true, "device": {...}}`` as its last line. Without a GPU, or
without the rest of the repository beside it, it fails before printing
any result.
"""

import contextlib
import functools
import importlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
# phase 14: W&D steps through the NCCL group of world size 1
NCCL_WD_STEPS = 5
# phase 15: two ranks on the one card over gloo
TWO_WD_STEPS, TWO_CAPACITY, TWO_RESNET_STEPS = 20, 2.0, 3
TWO_PARITY_STEPS = 3  # the reference's shard-parity run length
# W&D at full width, two ranks against one process: adam's normalised
# step turns the last-bit differences of a gradient summed per rank into
# ~1e-6 where that gradient is near 0, so a handful of the dense params'
# 151,311 elements sit just outside the shard-parity rtol 1e-4 / atol
# 1e-6; at most TWO_DENSE_OUTSIDE of them may, and every element stays
# within TWO_DENSE_ATOL
TWO_DENSE_OUTSIDE, TWO_DENSE_ATOL = 8, 1e-5
TWO_RANKS_TIMEOUT_S = 600
# ResNet-50, step 1 of two ranks against one process on the global batch,
# in bf16 (the main path) and f32: gates on the loss's relative
# difference, the worst relative 2-norm of a batch_stats leaf (on each
# rank) and the relative 2-norm of the parameter update over the leaves
# the step moves. In bf16 the convolutions see batches of 128 instead of
# 256 and the BatchNorm sums run in another order, so roundings differ
# here and there; in f32 the update still differs by ~1e-3 of itself
# (summation orders, through 53 BatchNorm backwards). A control whose
# BatchNorm takes each rank's own statistics must fail the last two gates
TWO_RESNET_GATES = {torch.bfloat16: (1e-4, 1e-3, 2e-2),
                    torch.float32: (1e-5, 1e-4, 5e-3)}
# phase 15 (e): BERT-base MLM across the two ranks, LAMB sharded (ZeRO-1),
# phase 7's configuration; its bf16 losses are held to one process's on
# the same global batches by the bf16 loss gate above. The f32 step is
# gated on the applied update p1 - p0, per tensor, by relative 2-norm.
# Against 'replicated' on the same two ranks the gradients are the same
# bits (a sum of two), so only the norm's sum order differs (~1e-6).
# Against one process the gradients sum in another order, and adam's
# first step maps each element's g to g / (|g| + eps): an element whose
# gradient is round-off (the attention keys' directions the softmax
# cancels) comes out as ±1 of that round-off either way, which moves an
# attention key kernel's update by ~2e-3 of itself. A trust ratio off by
# a factor moves a whole tensor's update by that factor: the control,
# whose trust ratio takes each rank's shard-local ‖u‖ (off by ~√2), must
# land 10x outside both gates
TWO_BERT_STEPS = 3
TWO_BERT_UPDATE_GATES = {"one process": 1e-2, "replicated": 1e-4}
TWO_BERT_CONTROL_FACTOR = 10.0
# the attention's key bias adds q·b to every score of a query, which the
# softmax takes out: its gradient is 0 in exact arithmetic and round-off
# in f32, which adam's first step scales to ±1, so against one process
# its update is noise of the summation order (~1 relative): that gate
# skips these tensors and prints them
TWO_BERT_NOISE_ONLY = "attention/key/bias"
# phase 15 (f): config 5 across the two ranks (and phase 14 at one rank):
# the MLP 784-256-10, ASYNC_WORKERS logical workers round-robin for
# phase 12's ASYNC_CYCLES cycles (TWO_ASYNC_CYCLES a worker), batch
# ASYNC_BATCH split over the ranks; params within MNIST_TOL of one
# process, counters exactly. The ranks run on to TWO_ASYNC_WITNESS_CYCLES
# a worker, held bitwise against the witness: one process that pushes
# the mean of the two half batches' gradients, which is what the ranks'
# reduction computes (a sum of two is the same in either order), so
# where the ranks drift from one process on the whole batch, the drift
# is the two gradients' rounding, not the apply across the ranks
TWO_ASYNC_HIDDEN, TWO_ASYNC_CYCLES = 256, ASYNC_CYCLES // ASYNC_WORKERS
TWO_ASYNC_WITNESS_CYCLES = 3 * TWO_ASYNC_CYCLES


@functools.lru_cache(maxsize=None)
def _card_peaks(name=None):
    """(HBM bytes/s, dense bf16 FLOP/s) of the card named ``name`` (card 0
    by default), from ``ps_tpu_torch/utils/chips.py``'s tables: every
    bound this script prints divides by them. A card the tables lack
    raises, naming it, rather than borrowing another card's peaks."""
    from ps_tpu_torch.utils import chips

    name = name or torch.cuda.get_device_name(0)
    hbm, bf16 = chips.peak_hbm_gbps(name), chips.peak_bf16_tflops(name)
    if hbm is None or bf16 is None:
        raise RuntimeError(f"no peaks for the card {name!r} in "
                           f"ps_tpu_torch/utils/chips.py: add its row from "
                           f"its data sheet")
    return hbm * 1e9, bf16 * 1e12


@functools.lru_cache(maxsize=None)
def _card_f32_flops(name=None):
    """Dense FP32 FLOP/s (outside the tensor cores) of the card named
    ``name`` (card 0 by default), from ``ps_tpu_torch/utils/chips.py``:
    the f32 flash bounds divide by it. A card the table lacks raises."""
    from ps_tpu_torch.utils import chips

    name = name or torch.cuda.get_device_name(0)
    f32 = chips.peak_f32_tflops(name)
    if f32 is None:
        raise RuntimeError(f"no f32 peak for the card {name!r} in "
                           f"ps_tpu_torch/utils/chips.py: add its row from "
                           f"its data sheet")
    return f32 * 1e12


def log(msg):
    print(msg, flush=True)


#: each phase's seconds, by its number (main's clocks)
PHASE_SECONDS = {}


@contextlib.contextmanager
def _clock(n):
    """Time phase ``n`` (printed, and kept in :data:`PHASE_SECONDS`)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[n] = round(time.perf_counter() - t0, 1)
        log(f"phase {n}: {PHASE_SECONDS[n]} s")


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
    return nbytes / _card_peaks()[0] * 1e3, nbytes, u


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
    hbm, bf16 = _card_peaks()
    log(f"peaks (ps_tpu_torch/utils/chips.py): HBM {hbm / 1e9:.0f} GB/s, "
        f"dense bf16 {bf16 / 1e12:.0f} TFLOP/s")


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
    _abi_against_binaries(_build)


def _abi_against_binaries(_build):
    """Hold the static-analysis gate's C ABI model (ROADMAP item 6.5) to
    the built libraries: the ``ps_*`` exports PSL6 parses from each
    ``.cu`` are the library's defined dynamic symbols, and PSL5/PSL6 find
    nothing in the port's tree."""
    from ps_tpu_torch.analysis import RepoIndex, run_lint
    from ps_tpu_torch.analysis.abi import exports_by_library

    t0 = time.perf_counter()
    parsed = exports_by_library(RepoIndex([str(_build.CSRC)]))
    n_syms = 0
    for name in _build.KERNELS:
        nm = subprocess.run(
            ["nm", "-D", "--defined-only", str(_build._library_path(name))],
            capture_output=True, text=True, check=True, timeout=60).stdout
        built = {ln.split()[-1] for ln in nm.splitlines()
                 if ln.split() and ln.split()[-1].startswith("ps_")}
        want = {s for s in parsed.get(name, {}) if s.startswith("ps_")}
        if built != want:
            raise AssertionError(
                f"lib{name}: the ABI model parses {sorted(want)} from "
                f"{name}.cu, the library exports {sorted(built)}")
        n_syms += len(built)
    t1 = time.perf_counter()
    pkg = str(_build.CSRC.parents[1])
    findings = run_lint([pkg], rules=["PSL5", "PSL6"])
    if findings:
        raise AssertionError("PSL5/PSL6 findings in the port:\n"
                             + "\n".join(f.format() for f in findings))
    t2 = time.perf_counter()
    log(f"abi gate: {n_syms} ps_* exports of {len(_build.KERNELS)} kernel "
        f"libraries equal their nm -D symbols in {t1 - t0:.3f} s; PSL5+PSL6 "
        f"over {os.path.basename(pkg)}/: 0 findings in {t2 - t1:.3f} s")


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


def _widedeep(cfg, device, seed, placement="sharded", exchange="gather",
              capacity_factor=2.0, init=()):
    """Build the composite step of the main path on ``device``, first
    through ``ps_tpu_torch.init(backend='cuda', device=device, **init)``,
    or in the runtime that is up already when ``init`` is None."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.wide_deep import (
        WideDeep, make_ids_fn, make_wide_deep_loss_fn)

    if init is not None:
        ps.init(backend="cuda", device=device, **dict(init))
    model = WideDeep(cfg, generator=torch.Generator().manual_seed(seed))
    dense = ps.KVStore(optimizer="adam", learning_rate=1e-2,
                       placement=placement)
    dense.init(model.param_tree())
    deep = ps.SparseEmbedding(cfg.total_rows, cfg.embed_dim,
                              optimizer="adagrad", learning_rate=0.05,
                              exchange=exchange,
                              capacity_factor=capacity_factor)
    wide = ps.SparseEmbedding(cfg.total_rows, 1, optimizer="sgd",
                              learning_rate=0.05, exchange=exchange,
                              capacity_factor=capacity_factor)
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
    group_bound = group_bytes / _card_peaks()[0] * 1e3
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
    # the last two: BERT-base in one process and in a rank of phase 15 (e)
    for b, s, h, d in ((2, 128, 4, 16), (2, 128, 4, 32), (2, 200, 4, 64),
                       (BERT_BATCH, BERT_SEQ, 12, 64),
                       (BERT_BATCH // 2, BERT_SEQ, 12, 64)):
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
        f"x 5 shapes), forward and gradients within rtol/atol "
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
    bytes_ms = nbytes / _card_peaks()[0] * 1e3
    flops_ms = flops / _card_peaks()[1] * 1e3
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
                label_smoothing=0.0, placement="sharded", **init):
    """``steps`` momentum steps (lr 0.1, 0.9, ``placement``) of ``model``
    from its seed-0 init, through init (with ``init``'s arguments) +
    KVStore.make_step on ``device``, cycling ``batches``; returns the
    losses, the step times, the params and the batch_stats. On the card
    the peak memory count starts after the set-up."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.resnet import make_loss_fn

    ps.init(backend="cuda", device=device, **init)
    params, stats = model.init(torch.Generator().manual_seed(0),
                               in_channels=in_channels, device=device)
    store = ps.KVStore(optimizer="momentum", learning_rate=0.1, momentum=0.9,
                       placement=placement)
    store.init(params)
    run = store.make_step(make_loss_fn(model, label_smoothing,
                                       mesh=store.mesh), has_aux=True)
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
        f"{100 * flops / (step_ms / 1e3) / _card_peaks()[1]:.1f}% of the "
        f"{_card_peaks()[1] / 1e12:.0f} TFLOP/s bf16 peak; card "
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
    """BERT-base resume, first with PyTorch's default algorithms, then with
    torch.use_deterministic_algorithms(True): in both the uninterrupted run
    repeats itself and the resumed run equals it, bitwise, and the
    restored state equals the saved one bitwise. One gradient taken twice
    in the default mode must be the same bitwise: the embeddings' backward
    sums in a fixed order (models/bert.py, ``_EmbedLookup``), where
    F.embedding's CUDA backward over the all-zero token-type ids did not."""
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
    if grads:
        raise AssertionError(f"BERT: one gradient taken twice in the default "
                             f"mode differs in {grads}")
    first, second = uninterrupted(), uninterrupted()
    out, save_s, restore_s, counts, parts = resumed(os.path.join(tmp, "bert"))
    size = _report_checkpoint("BERT-base (params, LAMB mu, nu, count)",
                              os.path.join(tmp, "bert"), save_s, restore_s)
    log(f"checkpoint BERT-base, one save's parts: copies off the card "
        f"{parts[0]:.4f} s, torch.save into the page cache {parts[1]:.4f} s, "
        f"fsync {parts[2]:.4f} s; card {_card_line()}")
    _hold_bitwise(f"{what}, default algorithms (one gradient taken twice is "
                  f"the same bitwise); launches in the resumed half {counts}",
                  out, first, second)
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


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _group_init(world, rank, port, **kw):
    """``init`` arguments of rank ``rank`` of a ``world``-rank group meeting
    at ``127.0.0.1:port``."""
    return dict(coordinator_uri=f"127.0.0.1:{port}", num_processes=world,
                process_id=rank, **kw)


def _wd_state(dense, deep, wide, full=False):
    """The W&D state as CPU tensors: dense params and this rank's slices
    of the adam state, and each table and its row state (every rank's rows
    with ``full``)."""
    from ps_tpu_torch import checkpoint as ckpt
    from ps_tpu_torch.parallel import collectives

    out = {k: v.cpu() for k, v in _state_of(dense).items()}
    for name, emb in (("deep", deep), ("wide", wide)):
        leaves = {"table": emb.table,
                  **{f"opt/{i}": t for i, t in
                     ckpt.flatten_leaves(emb.state()).items()}}
        for key, t in leaves.items():
            if full:
                t = collectives.all_gather(t, emb.mesh)[:emb.num_rows]
            out[f"{name}/{key}"] = t.detach().cpu().clone()
    return out


def _mean_of_slices_step(store, loss_fn):
    """The witness's cycle, ``run(slices, worker=w)``: make_async_step's
    cycle in one process, as len(slices) ranks run it on those slices of
    the worker's batch. Each slice's gradient against the worker's cached
    pull, their mean pushed (summed in rank order, then divided, as the
    ranks' reduction does), the slices' mean loss returned."""
    import functools

    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.kv.store import value_and_grad

    cached = {}

    def mean(values):
        return functools.reduce(torch.add, values) / len(values)

    def run(slices, worker=0):
        params = cached.get(worker)
        if params is None:
            params = store.pull_all(worker=worker)
        outs = [value_and_grad(loss_fn, params, b) for b in slices]
        flat = [keys.flatten_with_keys(g) for _, g, _ in outs]
        kv, treedef = flat[0]
        store.push_all(keys.unflatten(
            treedef, {key: mean([f[0][key] for f in flat]) for key in kv},
            list(kv)), worker=worker)
        cached[worker] = store.pull_all(worker=worker)
        return mean([loss for loss, _, _ in outs])

    return run


def _async_counters_now(store):
    eng = store._engine
    return {"version": eng.version,
            "staleness_hist": dict(sorted(eng.staleness_hist.items())),
            "apply_count": dict(eng.apply_count),
            "collective_bytes": store.collective_bytes}


def _async_cycles(placement, cycles=TWO_ASYNC_CYCLES,
                  hidden=TWO_ASYNC_HIDDEN, snapshot=None, witness=None):
    """Config 5 in the runtime that is up (mode 'async', ASYNC_WORKERS
    workers): ``cycles`` make_async_step cycles a worker, round-robin, of
    the MLP 784-``hidden``-10 (sgd 0.1, ``placement``), each rank on its
    slice of the worker's batches, placed before the clock starts. Returns
    the losses, the cycle times, the params and the server's counters;
    with ``snapshot``, also the params and counters after that many
    cycles a worker (under "snapshot"). With ``witness`` (one process),
    each cycle is :func:`_mean_of_slices_step` over the batch's slices
    for ``witness`` ranks."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models.mlp import MLP, make_loss_fn
    from ps_tpu_torch.parallel.mesh import Mesh

    mesh = ps.current_context().mesh
    model = MLP(hidden=hidden)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1, mode="async",
                       placement=placement)
    store.init(model.init(torch.Generator().manual_seed(0), device="cuda"))
    streams = [mnist_batches(ASYNC_BATCH, seed=0, worker=w,
                             num_workers=ASYNC_WORKERS)
               for w in range(ASYNC_WORKERS)]
    if witness:
        run = _mean_of_slices_step(store, make_loss_fn(model))
        parts = [Mesh({"data": witness}, coords={"data": r})
                 for r in range(witness)]
        batches = [[[store.shard_batch(rank_slice(b, part)) for part in parts]
                    for b in (next(st) for _ in range(cycles))]
                   for st in streams]
    else:
        run = store.make_async_step(make_loss_fn(model))
        batches = [[store.shard_batch(rank_slice(next(st), mesh))
                    for _ in range(cycles)] for st in streams]
    torch.cuda.synchronize()
    mesh.calls.clear()
    losses, times, at = [], [], None
    for step in range(cycles * ASYNC_WORKERS):
        w = step % ASYNC_WORKERS
        t0 = time.perf_counter()
        losses.append(run(batches[w][step // ASYNC_WORKERS], worker=w))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if snapshot and step + 1 == snapshot * ASYNC_WORKERS:
            at = dict(_async_counters_now(store),
                      params=_flat_np(store.params()),
                      losses=[float(x) for x in losses])
    eng = store._engine
    return dict(_async_counters_now(store),
                losses=[float(x) for x in losses], times=times,
                params=_flat_np(store.params()), snapshot=at,
                calls=[(c.op, c.ring_bytes) for c in mesh.calls],
                param_bytes=sum(int(v.nbytes) for v in eng._params.values()),
                dims=dict(eng._dims))


def _async_counters(run):
    return (run["version"], run["staleness_hist"], run["apply_count"])


def phase_nccl_one_rank():
    """14: init(backend='cuda') through coordinator_uri with one process:
    an NCCL group of world size 1 on the card. The W&D composite step at
    full width and a small ResNet (Bottleneck, stages (1, 1, 1, 1), bf16,
    224², batch 32) with placement 'replicated' and 'sharded' equal the
    one-device path bitwise; every collective of the port runs (recorded)
    and moves 0 bytes."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import criteo_batches, imagenet_batches
    from ps_tpu_torch.models import resnet
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig()
    host = list(criteo_batches(BATCH, vocab_size=cfg.per_feature_vocab,
                               seed=2, steps=NCCL_WD_STEPS))
    images = list(imagenet_batches(32, image_size=RESNET_SIZE, seed=5,
                                   steps=2))
    model = resnet.ResNet(stage_sizes=(1, 1, 1, 1),
                          block_cls=resnet.BottleneckBlock)
    for placement in ("replicated", "sharded"):
        out = {}
        for path in ("one device", "nccl"):
            def init():  # a fresh port for each group
                return (_group_init(1, 0, _free_port()) if path == "nccl"
                        else {})

            _, dense, deep, wide, run = _widedeep(cfg, "cuda", seed=0,
                                                  placement=placement,
                                                  init=init())
            ctx = ps.current_context()
            ctx.mesh.calls.clear()
            _launch_counts(reset=True)
            losses = [float(run(dense.shard_batch(b))[0]) for b in host]
            torch.cuda.synchronize()
            counts = _launch_counts()
            calls = list(ctx.mesh.calls)
            out[path] = (losses, _wd_state(dense, deep, wide), counts, calls,
                         ctx.mesh.backend, dense.collective_bytes
                         + deep.collective_bytes + wide.collective_bytes)
            ps.shutdown()
            # cuDNN's backward algorithms may use atomics: both ResNet runs
            # take its deterministic ones, so bitwise compares the paths
            torch.backends.cudnn.deterministic = True
            try:
                r_losses, _, params, stats = _resnet_run(
                    model, "cuda", images, 2, placement=placement, **init())
            finally:
                torch.backends.cudnn.deterministic = False
            out[path] += ({**_flat_np(params), **{
                f"stats/{k}": v for k, v in _flat_np(stats).items()}},
                r_losses)
        one, nccl = out["one device"], out["nccl"]
        want = {"sparse_apply": 2 * NCCL_WD_STEPS,
                "sparse_group": 2 * NCCL_WD_STEPS, "flash_attention/fwd": 0}
        if nccl[4] != "nccl" or one[4] is not None:
            raise AssertionError(f"backends {one[4]}, {nccl[4]}")
        if nccl[2] != want or one[2] != want:
            raise AssertionError(f"W&D launches {one[2]}, {nccl[2]}")
        if one[0] != nccl[0]:
            raise AssertionError(f"W&D losses {one[0]} vs {nccl[0]}")
        diff = _differs(nccl[1], one[1])
        if diff:
            raise AssertionError(f"W&D {placement}: NCCL world 1 differs "
                                 f"from one device in {diff}")
        if one[7] != nccl[7] or any(not np.array_equal(nccl[6][k], v)
                                    for k, v in one[6].items()):
            raise AssertionError(f"ResNet {placement}: NCCL world 1 differs "
                                 f"from one device")
        ops = sorted({c.op for c in nccl[3]})
        if not nccl[3] or any(c.ring_bytes for c in nccl[3]) or nccl[5]:
            raise AssertionError(f"collectives at world 1: {nccl[3][:4]}, "
                                 f"{nccl[5]} bytes")
        log(f"NCCL world size 1, {placement}: W&D full width {NCCL_WD_STEPS} "
            f"steps (launches {nccl[2]}) and ResNet (Bottleneck (1, 1, 1, 1), "
            f"bf16, 224², batch 32, 2 steps) equal the one-device path "
            f"bitwise ({len(one[1])} + {len(one[6])} tensors; losses "
            f"{nccl[0][-1]:.6f}, {nccl[7][-1]:.6f}); {len(nccl[3])} recorded "
            f"collectives of the W&D run ({', '.join(ops)}) moved 0 bytes "
            f"(collective_bytes {nccl[5]}); card {_card_line()}")
    # config 5: the async server through the group of one rank
    for placement in ("replicated", "sharded"):
        out = {}
        for path in ("one device", "nccl"):
            init = _group_init(1, 0, _free_port()) if path == "nccl" else {}
            ps.init(backend="cuda", mode="async", num_workers=ASYNC_WORKERS,
                    dc_lambda=0.04, **init)
            _launch_counts(reset=True)
            out[path] = _async_cycles(placement)
            out[path]["backend"] = ps.current_context().mesh.backend
            ps.shutdown()
            _no_launches(f"async server, {path}, {placement}")
        one, nccl = out["one device"], out["nccl"]
        if (nccl["backend"], one["backend"]) != ("nccl", None):
            raise AssertionError(f"backends {one['backend']}, "
                                 f"{nccl['backend']}")
        diff = [k for k, v in one["params"].items()
                if not np.array_equal(nccl["params"][k], v)]
        if (diff or one["losses"] != nccl["losses"]
                or _async_counters(one) != _async_counters(nccl)):
            raise AssertionError(f"async {placement}: NCCL world 1 differs "
                                 f"from one device in {diff or 'losses'} "
                                 f"or counters {_async_counters(nccl)}")
        if not nccl["calls"] or any(b for _, b in nccl["calls"]) or nccl[
                "collective_bytes"]:
            raise AssertionError(f"async collectives at world 1: "
                                 f"{nccl['calls'][:4]}")
        log(f"NCCL world size 1, async DC-ASGD {placement} (MLP 784-"
            f"{TWO_ASYNC_HIDDEN}-10, {ASYNC_WORKERS} workers x "
            f"{TWO_ASYNC_CYCLES} cycles): equal to the one-device path bitwise ({len(one['params'])} "
            f"tensors, version {nccl['version']}, staleness histogram "
            f"{nccl['staleness_hist']}); {len(nccl['calls'])} recorded "
            f"collectives moved 0 bytes")


def _wd_runs():
    """Phase 15's W&D runs: ``{name: (config, global batch, steps,
    exchange)}``, the main path at full width with each exchange and the
    reference's shard-parity configuration (tests/test_sparse.py:184-225:
    vocab 50, D 8, MLP (32, 16), batch 16, 3 steps)."""
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    small = WideDeepConfig(per_feature_vocab=50, embed_dim=8, mlp=(32, 16))
    return {"gather": (WideDeepConfig(), BATCH, TWO_WD_STEPS, "gather"),
            "a2a": (WideDeepConfig(), BATCH, TWO_WD_STEPS, "a2a"),
            "small/gather": (small, 16, 3, "gather"),
            "small/a2a": (small, 16, 3, "a2a")}


def _wd_host(cfg, batch, steps):
    from ps_tpu_torch.data.synthetic import criteo_batches

    return list(criteo_batches(batch, vocab_size=cfg.per_feature_vocab,
                               seed=4, steps=steps))


def _two_ranks_worker(rank, port, outdir):
    """Phase 15's rank ``rank`` of 2, sharing the one card over gloo: the
    W&D runs of :func:`_wd_runs`, a multi-process save, and ResNet-50 at
    224²; results into ``outdir/rank<r>.pt``."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.data.synthetic import imagenet_batches
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models.resnet import ResNet50, make_loss_fn
    from ps_tpu_torch.ops import sparse_apply as ops

    ctx = ps.init(backend="cuda", device="cuda:0", **_group_init(
        2, rank, port, dist_backend="gloo"))
    mesh = ctx.mesh
    results = {"backend": mesh.backend, "size": mesh.size}

    def keep(state):  # the tables are the same on both ranks: rank 0's
        return {k: v for k, v in state.items()
                if rank == 0 or k.startswith("opt/")}

    for name, (cfg, batch, steps, exchange) in _wd_runs().items():
        _, dense, deep, wide, run = _widedeep(
            cfg, "cuda", seed=0, exchange=exchange,
            capacity_factor=TWO_CAPACITY, init=None)
        batches = [dense.shard_batch(rank_slice(b, mesh))
                   for b in _wd_host(cfg, batch, steps)]
        torch.cuda.synchronize()
        mesh.calls.clear()
        _launch_counts(reset=True)
        losses, times = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            loss, _ = run(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i + 1 == TWO_PARITY_STEPS:
                early = keep(_wd_state(dense, deep, wide, full=True))
        counts, by_rule = _launch_counts(), dict(ops.LAUNCHES_BY_RULE)
        n_local = batch // 2 * cfg.num_sparse
        n_after = 2 * (n_local if exchange == "gather" else
                       int(np.ceil(n_local / 2 * TWO_CAPACITY)))
        results[name] = {
            "losses": losses, "step_ms": float(np.median(times[1:])) * 1e3,
            "counts": counts, "by_rule": by_rule,
            "dropped": deep.dropped_rows + wide.dropped_rows,
            "rows_pushed": deep.rows_pushed + wide.rows_pushed,
            "dense_bytes": dense.collective_bytes,
            "sparse_bytes": deep.collective_bytes + wide.collective_bytes,
            "recorded_bytes": sum(c.ring_bytes for c in mesh.calls),
            "ids_after_exchange": n_after,
            "group_path": ops.plan_group(n_after,
                                         deep.rows_per_shard)["path"],
            "rows_per_shard": deep.rows_per_shard,
            "state": keep(_wd_state(dense, deep, wide, full=True)),
            "early": early,
            "state_dims": list(dense._engine._state_dims)}
        if name == "gather":
            for part, obj in (("dense", dense), ("deep", deep),
                              ("wide", wide)):
                obj.save(os.path.join(outdir, f"ckpt_{part}"))
        del dense, deep, wide, run, batches
    host = [rank_slice(b, mesh) for b in imagenet_batches(
        RESNET_BATCH, image_size=RESNET_SIZE, seed=0, steps=TWO_RESNET_STEPS)]
    # the main path with cross-rank BatchNorm, one step of it in f32, and
    # the controls: one step with BatchNorm taking this rank's statistics,
    # which the gates of phase_two_ranks must tell apart
    for name, dtype, cross, steps in (
            ("resnet", torch.bfloat16, True, TWO_RESNET_STEPS),
            ("resnet/local_bn", torch.bfloat16, False, 1),
            ("resnet_f32", torch.float32, True, 1),
            ("resnet_f32/local_bn", torch.float32, False, 1)):
        model = ResNet50(dtype=dtype)
        params, stats = model.init(torch.Generator().manual_seed(0),
                                   device="cuda")
        store = ps.KVStore(optimizer="momentum", learning_rate=0.1,
                           momentum=0.9, placement="sharded")
        store.init(params)
        step = store.make_step(make_loss_fn(
            model, 0.1, mesh=store.mesh if cross else None), has_aux=True)
        losses, times, first = [], [], {}
        for b in host[:steps]:
            b = store.shard_batch(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, stats = step(b, stats)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if not first:  # after step 1: the params are whole on each rank
                first = {"stats": _flat_np(stats),
                         "params": _flat_np(params) if rank == 0 else None}
        results[name] = {"losses": losses, **first,
                         "step_ms": float(np.median(times[1:] or times)) * 1e3,
                         "bytes": store.collective_bytes}
        del model, params, stats, store, step
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    ps.shutdown()


def _bert_two_ranks_runs():
    """Phase 15 (e)'s runs: ``{name: (dtype, placement, shard-local norms,
    steps)}``."""
    return {"bert": (torch.bfloat16, "sharded", False, TWO_BERT_STEPS),
            "bert_f32": (torch.float32, "sharded", False, 1),
            "bert_f32/replicated": (torch.float32, "replicated", False, 1),
            "bert_f32/local_norms": (torch.float32, "sharded", True, 1)}


def _bert_batches():
    from ps_tpu_torch.data.synthetic import mlm_batches
    from ps_tpu_torch.models.bert import BertConfig

    return list(mlm_batches(BERT_BATCH, BERT_SEQ,
                            vocab_size=BertConfig().vocab_size, seed=0,
                            steps=TWO_BERT_STEPS))


def _bert_update(model, params):
    """The applied update ``p1 - p0`` of each tensor, in f32 on the CPU:
    ``model`` still holds the initial weights (the store steps copies)."""
    from ps_tpu_torch.kv import keys

    start, _ = keys.flatten_with_keys(model.param_tree())
    flat, _ = keys.flatten_with_keys(params)
    return {k: v.detach().float().cpu() - start[k].detach().float().cpu()
            for k, v in flat.items()}


def _two_ranks_ea_worker(rank, port, outdir):
    """Phase 15's second pair of ranks sharing the one card over gloo:
    (e) BERT-base MLM with LAMB across the ranks and (f) config 5's async
    server across them; results into ``outdir/ea<r>.pt``."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models.bert import BertConfig, BertMLM, make_mlm_loss_fn

    ctx = ps.init(backend="cuda", device="cuda:0", mode="async",
                  num_workers=ASYNC_WORKERS, dc_lambda=0.04,
                  **_group_init(2, rank, port, dist_backend="gloo"))
    mesh = ctx.mesh
    fa = _flash()
    results = {"backend": mesh.backend}
    batches = [rank_slice(b, mesh) for b in _bert_batches()]
    for name, (dtype, placement, local, steps) in (
            _bert_two_ranks_runs().items()):
        model = BertMLM(BertConfig(dtype=dtype, attn="flash"),
                        generator=torch.Generator().manual_seed(0))
        store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                           weight_decay=0.01, placement=placement,
                           mode="sync")
        store.init(model.param_tree())
        if local:  # the control: each rank's own ‖u‖ of its slices
            store._engine._norm_all_reduce = lambda flat, axis: flat
        run = store.make_step(make_mlm_loss_fn(model, mesh=store.mesh))
        placed = [store.shard_batch(b) for b in batches[:steps]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.calls.clear()
        fa.LAUNCHES = 0
        losses, times = [], []
        for b in placed:
            t0 = time.perf_counter()
            loss, params = run(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        sliced = sum(d is not None for d in store._engine._dims.values())
        results[name] = {
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": fa.LAUNCHES, "sliced": sliced,
            "tensors": len(store._engine._dims),
            "norm_reduces": sum(c.op == "all_reduce" and c.shape == (sliced,)
                                for c in mesh.calls),
            "bytes": store.collective_bytes}
        if dtype == torch.float32:
            update = _bert_update(model, params)
            results[name]["update"] = update if rank == 0 else None
            # every rank's params are the same bits: rank 1 sends a digest
            results[name]["digest"] = {k: float(v.double().sum())
                                       for k, v in update.items()}
        del model, store, run, placed, params
        torch.cuda.empty_cache()
    for placement in ("replicated", "sharded"):
        _launch_counts(reset=True)
        results[f"async/{placement}"] = _async_cycles(
            placement, cycles=TWO_ASYNC_WITNESS_CYCLES,
            snapshot=TWO_ASYNC_CYCLES)
        results[f"async/{placement}"]["launches"] = _launch_counts()
    torch.save(results, os.path.join(outdir, f"ea{rank}.pt"))
    ps.shutdown()


def _one_process_wd(cfg, batch, steps):
    """The W&D run of one process on the card: losses, and the state
    after TWO_PARITY_STEPS steps and at the end."""
    import ps_tpu_torch as ps

    _, dense, deep, wide, run = _widedeep(cfg, "cuda", seed=0)
    losses, early = [], None
    for i, b in enumerate(_wd_host(cfg, batch, steps)):
        losses.append(float(run(dense.shard_batch(b))[0]))
        if i + 1 == TWO_PARITY_STEPS:
            early = _wd_state(dense, deep, wide)
    out = _wd_state(dense, deep, wide)
    ps.shutdown()
    return losses, early, out


def _wd_deviation(per, one, which="state"):
    """``{name: (max abs difference, elements outside rtol 1e-4 / atol
    1e-6)}`` of two ranks' W&D state against one process's: rank 0's
    tables and params, and each rank's adam slices against its slice of
    the one-process state."""
    out = {}
    for k, v in one.items():
        if k.startswith("opt/"):
            continue
        g = per[0][which][k]
        out[k] = (float((g.double() - v.double()).abs().max()),
                  int((~torch.isclose(g, v, rtol=1e-4, atol=1e-6)).sum()))
    opt = sorted((k, v) for k, v in one.items() if k.startswith("opt/"))
    for r, p in enumerate(per):
        for (k, v), d in zip(opt, p["state_dims"]):
            mine = v if d is None else v.narrow(d, r * v.shape[d] // 2,
                                                v.shape[d] // 2)
            g = p[which][k]
            out[f"{k}@{r}"] = (
                float((g.double() - mine.double()).abs().max()),
                int((~torch.isclose(g, mine, rtol=1e-4, atol=1e-6)).sum()))
    return out


def _two_ranks_resnet(ranks, name, dtype, batches, start):
    """Phase 15's ResNet-50 check in ``dtype``: step 1 of the two ranks'
    run ``name`` and of its local-BatchNorm control against one process
    on the global batch ``batches[0]`` from the parameters ``start``."""
    from ps_tpu_torch.models.resnet import ResNet50

    losses, _, params, stats = _resnet_run(ResNet50(dtype=dtype), "cuda",
                                           batches, 1, label_smoothing=0.1)
    stats, params = _flat_np(stats), _flat_np(params)
    # the leaves step 1 moves: a block's branch behind its last BatchNorm,
    # whose scale starts at 0, gets a zero gradient and stays put
    moved = [k for k, v in params.items() if np.any(v != start[k])]
    still = sorted(set(params) - set(moved))

    def update(p):
        return np.concatenate([(p[k] - start[k]).ravel() for k in moved])

    def deviation(run):
        r0 = run[0]
        return (abs(r0["losses"][0] - losses[0]) / abs(losses[0]),
                max(_rel_l2([r["stats"][k] for r in run], [v] * len(run))
                    for k, v in stats.items()),
                _rel_l2([update(r0["params"])], [update(params)]))

    gates = TWO_RESNET_GATES[dtype]
    held = deviation([r[name] for r in ranks])
    control = deviation([r[f"{name}/local_bn"] for r in ranks])
    readings = (f"loss {held[0]:.3g}, batch_stats {held[1]:.3g}, update "
                f"{held[2]:.3g} (gates {gates}); the control with BatchNorm "
                f"on each rank's statistics: loss {control[0]:.3g}, "
                f"batch_stats {control[1]:.3g}, update {control[2]:.3g}")
    if any(d > g for d, g in zip(held, gates)) or any(
            np.any(ranks[0][name]["params"][k] != start[k]) for k in still):
        raise AssertionError(f"ResNet-50 {dtype} two ranks vs one process: "
                             f"{readings}; {len(still)} leaves should stay "
                             f"put")
    if not all(d > g for d, g in zip(control[1:], gates[1:])):
        raise AssertionError(f"ResNet-50 {dtype}: the control passes a "
                             f"gate: {readings}")
    for r in ranks:
        if not np.all(np.isfinite(r[name]["losses"])):
            raise AssertionError(f"ResNet-50 two ranks: losses "
                                 f"{r[name]['losses']}")
    log(f"two ranks on one card (gloo), ResNet-50 v1.5, 224², "
        f"{str(dtype)[6:]}, global batch {RESNET_BATCH} ({RESNET_BATCH // 2} "
        f"a rank), sharded, cross-rank BatchNorm: step 1 against one "
        f"process on the global batch (loss "
        f"{ranks[0][name]['losses'][0]:.6f} vs {losses[0]:.6f}), relative: "
        f"{readings}; {len(moved)} parameter leaves moved, {len(still)} "
        f"stayed put as in one process; losses "
        f"{[round(x, 4) for x in ranks[0][name]['losses']]}")


def _bert_update_deviation(got, want, skip=None):
    """The worst relative 2-norm, over the tensors, of ``got``'s update
    against ``want``'s, and the tensor it is on; with ``skip``, the
    tensors whose name ends with it apart, their worst third."""
    worst, skipped = (0.0, ""), (0.0, "")
    for k, w in want.items():
        dev = float((got[k].double() - w.double()).norm()
                    / max(float(w.double().norm()), 1e-30))
        if skip is not None and k.endswith(skip):
            skipped = max(skipped, (dev, k))
        else:
            worst = max(worst, (dev, k))
    return worst + skipped


def _two_ranks_bert_async(tmp):
    """Phase 15 (e) and (f): a second pair of worker processes; their
    results against one process on the card. Returns each rank's flash
    launches over (e)'s bf16 run."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.bert import BertConfig, BertMLM

    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--two-ranks-ea-worker", str(r), str(port),
                               tmp])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=TWO_RANKS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"two-rank (e)/(f) workers exited {rcs}")
    ranks = [torch.load(os.path.join(tmp, f"ea{r}.pt"), weights_only=False)
             for r in range(2)]
    fa = _flash()
    batches = _bert_batches()
    # (e) one process on the same global batches: bf16 losses, f32 update
    one = {}
    for dtype, steps in ((torch.bfloat16, TWO_BERT_STEPS),
                         (torch.float32, 1)):
        model = BertMLM(BertConfig(dtype=dtype, attn="flash"),
                        generator=torch.Generator().manual_seed(0))
        losses, times, params = _bert_run(model, "cuda", batches[:steps])
        one[dtype] = (losses, _bert_update(model, params)
                      if dtype == torch.float32 else None, times)
        del model, params
        torch.cuda.empty_cache()
    per = [r["bert"] for r in ranks]
    loss_gate = TWO_RESNET_GATES[torch.bfloat16][0]
    rel = [abs(a - b) / abs(b) for a, b in zip(per[0]["losses"],
                                               one[torch.bfloat16][0])]
    want_launches = BertConfig().num_layers * TWO_BERT_STEPS
    for r in per:
        if not np.all(np.isfinite(r["losses"])) or not (
                r["losses"][-1] < r["losses"][0]):
            raise AssertionError(f"BERT two ranks: losses {r['losses']}")
        if r["launches"] != want_launches or r["norm_reduces"] != \
                TWO_BERT_STEPS or r["losses"] != per[0]["losses"]:
            raise AssertionError(
                f"BERT two ranks: flash launches {r['launches']} (want "
                f"{want_launches}), norm all-reduces {r['norm_reduces']} "
                f"(want {TWO_BERT_STEPS}), losses {r['losses']} vs rank 0")
    if max(rel) > loss_gate:
        raise AssertionError(f"BERT two ranks bf16 losses {per[0]['losses']} "
                             f"vs one process {one[torch.bfloat16][0]}: "
                             f"relative {rel} (gate {loss_gate})")
    upd = {name: ranks[0][name]["update"] for name in
           ("bert_f32", "bert_f32/replicated", "bert_f32/local_norms")}
    for name in upd:
        if ranks[1][name]["digest"] != ranks[0][name]["digest"]:
            raise AssertionError(f"{name}: the ranks' params differ")
    one_f32, rep = one[torch.float32][1], upd["bert_f32/replicated"]
    held = {"one process": _bert_update_deviation(
                upd["bert_f32"], one_f32, TWO_BERT_NOISE_ONLY),
            "replicated": _bert_update_deviation(upd["bert_f32"], rep)}
    control = {"one process": _bert_update_deviation(
                   upd["bert_f32/local_norms"], one_f32, TWO_BERT_NOISE_ONLY),
               "replicated": _bert_update_deviation(
                   upd["bert_f32/local_norms"], rep)}
    gates = TWO_BERT_UPDATE_GATES
    readings = "; ".join(
        f"against {what}: {held[what][0]:.3g} ({held[what][1]}), gate "
        f"{gates[what]} ({gates[what] / max(held[what][0], 1e-30):.1f}x "
        f"margin), the shard-local-norm control {control[what][0]:.3g} "
        f"({control[what][1]}, {control[what][0] / gates[what]:.1f}x the "
        f"gate)" for what in gates)
    readings = (f"worst per-tensor relative 2-norm of the f32 update "
                f"{readings}; the {TWO_BERT_NOISE_ONLY} tensors "
                f"(round-off only, not gated against one process): "
                f"{held['one process'][2]:.3g}, control "
                f"{control['one process'][2]:.3g}")
    if any(held[w][0] > gates[w] for w in gates):
        raise AssertionError(f"BERT two ranks: {readings}")
    if any(control[w][0] < TWO_BERT_CONTROL_FACTOR * gates[w]
           for w in gates):
        raise AssertionError(f"BERT two ranks: the control lands inside "
                             f"{TWO_BERT_CONTROL_FACTOR}x a gate: "
                             f"{readings}")
    r0 = per[0]
    log(f"two ranks on one card (gloo), BERT-base MLM, LAMB 'sharded' "
        f"({r0['sliced']} of {r0['tensors']} tensors sliced, one norm "
        f"all-reduce a step), flash, seq {BERT_SEQ}, global batch "
        f"{BERT_BATCH} ({BERT_BATCH // 2} a rank), bf16: {TWO_BERT_STEPS} "
        f"steps, losses {[round(x, 5) for x in r0['losses']]} vs one "
        f"process {[round(x, 5) for x in one[torch.bfloat16][0]]} (relative "
        f"{max(rel):.3g}, gate {loss_gate}); flash launches a rank "
        f"{[r['launches'] for r in per]} ({BertConfig().num_layers} a "
        f"step); {readings}; card {_card_line()}")
    log(f"two ranks (gloo, a correctness run through host memory, not a "
        f"speed figure), BERT-base bf16: step ms a rank "
        f"{[[round(t, 1) for t in r['step_ms']] for r in per]}, peak memory "
        f"a rank {[round(r['peak_gib'], 2) for r in per]} GiB; one process "
        f"{[round(t * 1e3, 1) for t in one[torch.bfloat16][2]]} ms; "
        f"collective bytes a rank {r0['bytes']:,} over {TWO_BERT_STEPS} "
        f"steps (analytic); card {_card_line()}")
    # the flash kernel at a rank's shape
    b, h, d = BERT_BATCH // 2, 12, 64
    q, k, v, mask = _flash_case(b, BERT_SEQ, h, d, torch.bfloat16, "ones",
                                seed=98)
    rank_ms = _device_ms(lambda: fa._flash_fwd_cuda(q, k, v, mask, d ** -0.5,
                                                    False, h))
    del q, k, v, mask
    # (f) config 5 across the two ranks: after TWO_ASYNC_CYCLES cycles a
    # worker against one process on the whole batches, and at the end
    # bitwise against the witness (one process pushing the mean of the
    # half batches' gradients); one process on the whole batches for as
    # long is printed beside it, not gated
    for placement in ("replicated", "sharded"):
        ps.init(backend="cuda", mode="async", num_workers=ASYNC_WORKERS,
                dc_lambda=0.04)
        want = _async_cycles(placement)
        long = _async_cycles(placement, cycles=TWO_ASYNC_WITNESS_CYCLES)
        witness = _async_cycles(placement, cycles=TWO_ASYNC_WITNESS_CYCLES,
                                witness=2)
        ps.shutdown()
        got = [r[f"async/{placement}"] for r in ranks]
        early = [r["snapshot"] for r in got]
        worst = 0.0
        for k, w in want["params"].items():
            np.testing.assert_allclose(early[0]["params"][k], w,
                                       rtol=MNIST_TOL, atol=MNIST_TOL,
                                       err_msg=f"async {placement} {k}")
            worst = max(worst, float(np.abs(early[0]["params"][k] - w).max()))
        np.testing.assert_allclose(early[0]["losses"], want["losses"],
                                   rtol=MNIST_TOL, atol=MNIST_TOL)
        for k, w in witness["params"].items():
            for r in got:
                if not np.array_equal(r["params"][k], w):
                    raise AssertionError(
                        f"async {placement}: the ranks' {k} after "
                        f"{TWO_ASYNC_WITNESS_CYCLES} cycles a worker differ "
                        f"from the witness's by max abs "
                        f"{float(np.abs(r['params'][k] - w).max()):.3g}")
        if got[0]["losses"] != witness["losses"]:
            raise AssertionError(f"async {placement}: the ranks' losses "
                                 f"differ from the witness's")
        drift = max(float(np.abs(got[0]["params"][k] - w).max())
                    for k, w in long["params"].items())
        for r in got:
            for run, what, cycles in (
                    (r["snapshot"], want, TWO_ASYNC_CYCLES),
                    (r, witness, TWO_ASYNC_WITNESS_CYCLES)):
                if _async_counters(run) != _async_counters(what):
                    raise AssertionError(
                        f"async {placement}: counters {_async_counters(run)}"
                        f" vs one process {_async_counters(what)}")
                # 2·N·(k-1)/k a push at k = 2
                analytic = cycles * ASYNC_WORKERS * want["param_bytes"]
                if run["collective_bytes"] != analytic:
                    raise AssertionError(
                        f"async {placement}: collective_bytes "
                        f"{run['collective_bytes']} vs {analytic}")
            if any(r["launches"].values()):
                raise AssertionError(f"async {placement}: launches "
                                     f"{r['launches']}")
        sliced = [k for k, dim in got[0]["dims"].items() if dim is not None]
        log(f"two ranks on one card (gloo), async DC-ASGD {placement} (MLP "
            f"784-{TWO_ASYNC_HIDDEN}-10, {ASYNC_WORKERS} workers round-robin, "
            f"batch {ASYNC_BATCH} as {ASYNC_BATCH // 2} a rank, "
            f"{len(sliced)} tensors sliced): after {TWO_ASYNC_CYCLES} cycles "
            f"a worker params within {MNIST_TOL} of one process (max abs "
            f"{worst:.3g}), version {early[0]['version']}, staleness "
            f"histogram {early[0]['staleness_hist']} and apply counts as one "
            f"process's; after {TWO_ASYNC_WITNESS_CYCLES} cycles a worker "
            f"params, losses and counters (version {got[0]['version']}) "
            f"bitwise the witness's (one process pushing the mean of the "
            f"two half batches' gradients), the ranks bitwise equal; one "
            f"process on the whole batches for as long: max abs {drift:.3g} "
            f"(not gated); collective_bytes {got[0]['collective_bytes']:,} "
            f"(analytic), {len(got[0]['calls'])} collectives recorded a "
            f"rank; no kernel launched")
        log(f"two ranks (gloo, a correctness run), async {placement}: median "
            f"cycle a rank "
            f"{[round(float(np.median(r['times'][ASYNC_WORKERS:])) * 1e3, 3) for r in got]}"
            f" ms, {[round(1e3 / (float(np.median(r['times'][ASYNC_WORKERS:])) * 1e3), 1) for r in got]}"
            f" cycles/s a rank; one process "
            f"{float(np.median(want['times'][ASYNC_WORKERS:])) * 1e3:.3f} ms; "
            f"card {_card_line()}")
    return {"launches": [r["launches"] for r in per],
            "steps": TWO_BERT_STEPS, "rank_shape": [b * h, BERT_SEQ, d],
            "rank_shape_ms": rank_ms}


def phase_two_ranks(tmp):
    """15: two ranks on the one card over gloo, asked for by name (NCCL
    refuses two ranks on one device); the times are a correctness run's,
    through host memory: no speed figure."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--two-ranks-worker", str(r), str(port), tmp])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=TWO_RANKS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"two-rank workers exited {rcs}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"backends {[r['backend'] for r in ranks]}")
    launches = {}
    for name, (cfg, batch, steps, exchange) in _wd_runs().items():
        one_losses, early, one = _one_process_wd(cfg, batch, steps)
        per = [r[name] for r in ranks]
        np.testing.assert_allclose(per[0]["losses"], one_losses, rtol=1e-5,
                                   err_msg=name)
        diff = _wd_deviation(per, one)
        if name.startswith("small/"):
            # the reference's own shard-parity test, on the card: tables,
            # row state, dense params and each rank's adam slices within
            # tests/test_sparse.py:220-225's rtol 1e-4 / atol 1e-6
            if any(n for _, n in diff.values()):
                raise AssertionError(f"{name}: outside rtol 1e-4 / atol "
                                     f"1e-6 of one process: {diff}")
            log(f"two ranks on one card (gloo), W&D at the reference's "
                f"shard-parity configuration ({exchange}; vocab 50, D 8, "
                f"MLP (32, 16), batch 16, 3 steps): losses rtol 1e-5 and "
                f"tables, row state, dense params and adam slices rtol 1e-4 "
                f"/ atol 1e-6 of one process (worst "
                f"{max(d for d, _ in diff.values()):.3g})")
            continue
        want = {"sparse_apply": 2 * steps, "sparse_group": 2 * steps,
                "flash_attention/fwd": 0}
        for r in per:
            if r["counts"] != want or r["by_rule"] != {"adagrad": steps,
                                                       "sgd": steps}:
                raise AssertionError(f"{name}: launches {r['counts']} "
                                     f"{r['by_rule']}, expected {want}")
            if r["group_path"] != "cluster":
                raise AssertionError(f"{name}: grouping path "
                                     f"{r['group_path']}")
            if not np.all(np.isfinite(r["losses"])) or not (
                    np.mean(r["losses"][-5:]) < np.mean(r["losses"][:5])):
                raise AssertionError(f"{name}: losses {r['losses']}")
        early_diff = _wd_deviation(per, early, "early")
        # the exchange's work, the tables and their row state, and the
        # adam slices stay within the shard-parity tolerance after every
        # step of the run; the dense params within TWO_DENSE_*
        held = {k: n for k, (_, n) in diff.items()
                if n and not k.startswith("param/")}
        if held:
            raise AssertionError(f"{name}: outside rtol 1e-4 / atol 1e-6 of "
                                 f"one process after {steps} steps: {held}")
        for after, d in ((TWO_PARITY_STEPS, early_diff), (steps, diff)):
            dense = [v for k, v in d.items() if k.startswith("param/")]
            worst = max(a for a, _ in dense)
            outside = sum(n for _, n in dense)
            if worst > TWO_DENSE_ATOL or outside > TWO_DENSE_OUTSIDE:
                raise AssertionError(
                    f"{name}: dense params after {after} steps: worst "
                    f"{worst:.3g} (bound {TWO_DENSE_ATOL}), {outside} "
                    f"elements outside rtol 1e-4 / atol 1e-6 (bound "
                    f"{TWO_DENSE_OUTSIDE})")
        launches[exchange] = {
            "sparse_apply/deep": [p["by_rule"]["adagrad"] for p in per],
            "sparse_apply/wide": [p["by_rule"]["sgd"] for p in per],
            "sparse_group": [p["counts"]["sparse_group"] for p in per]}

        def outside(d):
            return {k: n for k, (_, n) in d.items() if n} or 0

        log(f"two ranks on one card (gloo), W&D full width, {exchange} "
            f"(capacity factor {TWO_CAPACITY}): {steps} steps of global "
            f"batch {batch} ({batch // 2} a rank), losses rtol 1e-5 of one "
            f"process ({per[0]['losses'][-1]:.6f} vs {one_losses[-1]:.6f}), "
            f"tables, row state and adam slices within rtol 1e-4 / atol 1e-6 "
            f"after {steps} steps, dense params within atol "
            f"{TWO_DENSE_ATOL} with at most {TWO_DENSE_OUTSIDE} elements "
            f"outside it; all of it against one process: after "
            f"{TWO_PARITY_STEPS} steps worst "
            f"{max(d for d, _ in early_diff.values()):.3g}, elements outside "
            f"rtol 1e-4 / atol 1e-6 {outside(early_diff)}; after {steps} "
            f"worst {max(d for d, _ in diff.values()):.3g}, outside "
            f"{outside(diff)}; launches a rank {[p['counts'] for p in per]};"
            f" grouping pass path '{per[0]['group_path']}' at N = "
            f"{per[0]['ids_after_exchange']:,} over "
            f"{per[0]['rows_per_shard']:,} rows a shard; dropped_rows "
            f"{per[0]['dropped']} of {per[0]['rows_pushed']:,}")
        log(f"two ranks (gloo, a correctness run through host memory, not a "
            f"speed figure), W&D {exchange}: median step "
            f"{[round(p['step_ms'], 3) for p in per]} ms; collective bytes a "
            f"rank over {steps} steps: dense {per[0]['dense_bytes']:,}, "
            f"sparse {per[0]['sparse_bytes']:,} (analytic), recorded "
            f"{per[0]['recorded_bytes']:,}; card {_card_line()}")
    cfg = WideDeepConfig()
    # the kernels at a rank's shape: rank 0's rows of the tables and a
    # batch's ids after the gather exchange, about half of them filler
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    _, gids = _slice_ids(seed=2)
    rps = ranks[0]["gather"]["rows_per_shard"]
    local = torch.where(gids < rps, gids, -1).to(torch.int32)
    per_rank = {"ids": local.numel(),
                "ids_owned": int((local >= 0).sum()), "rows": rps}
    for table_name, rule, dim in (("deep", "adagrad", cfg.embed_dim),
                                  ("wide", "sgd", 1)):
        opt = rowwise.make_rowwise(rule, learning_rate=0.05)
        g = torch.Generator("cuda").manual_seed(5)
        table = 0.01 * torch.randn((rps, dim), generator=g, device="cuda")
        state = opt.init(table)
        grads = 1e-3 * torch.randn((local.numel(), dim), generator=g,
                                   device="cuda")
        per_rank[f"{table_name}_ms"] = _device_ms(
            lambda: ops.fused_sparse_apply(table, state, local, grads, opt,
                                           "cuda"))
        per_rank[f"{table_name}_bound_ms"] = _bound_ms(local, dim, opt, 4)[0]
        del table, state, grads
    per_rank["group_path"] = ops.plan_group(local.numel(), rps)["path"]
    log(json.dumps({"sparse_apply_per_rank": per_rank,
                    "card": _card_line()}))
    # the multi-process save, restored into one process
    _, dense, deep, wide, _ = _widedeep(cfg, "cuda", seed=0)
    for name, obj in (("dense", dense), ("deep", deep), ("wide", wide)):
        obj.restore(os.path.join(tmp, f"ckpt_{name}"), elastic=True)
    restored = _wd_state(dense, deep, wide)
    ps.shutdown()
    saved = ranks[0]["gather"]["state"]
    diff = _differs({k: v for k, v in restored.items()
                     if not k.startswith("opt/")},
                    {k: v for k, v in saved.items()
                     if not k.startswith("opt/")})
    for r, p in enumerate(ranks):
        for (k, v), d in zip(sorted((k, v) for k, v in restored.items()
                                    if k.startswith("opt/")),
                             p["gather"]["state_dims"]):
            mine = v if d is None else v.narrow(d, r * v.shape[d] // 2,
                                                v.shape[d] // 2)
            diff.update(_differs({k: mine}, {k: p["gather"]["state"][k]}))
    if diff:
        raise AssertionError(f"elastic restore 2 -> 1 differs: {diff}")
    log(f"multi-process save at 2 ranks, elastic restore into one process: "
        f"bitwise over {len(restored)} tensors")
    # ResNet-50 across the two ranks against one process on the global batch
    from ps_tpu_torch.data.synthetic import imagenet_batches
    from ps_tpu_torch.models.resnet import ResNet50

    batches = list(imagenet_batches(RESNET_BATCH, image_size=RESNET_SIZE,
                                    seed=0, steps=1))
    start = _flat_np(ResNet50().init(torch.Generator().manual_seed(0))[0])
    for name, dtype in (("resnet", torch.bfloat16),
                        ("resnet_f32", torch.float32)):
        _two_ranks_resnet(ranks, name, dtype, batches, start)
    res = [r["resnet"] for r in ranks]
    log(f"two ranks (gloo, a correctness run through host memory, not a "
        f"speed figure), ResNet-50: median step "
        f"{[round(r['step_ms'], 1) for r in res]} ms; collective bytes a "
        f"rank {res[0]['bytes']:,} over {TWO_RESNET_STEPS} steps (analytic); "
        f"card {_card_line()}")
    return launches, _two_ranks_bert_async(tmp)

# -- phase 16: the van plane on the card ------------------------------------

VAN_TRAINER = "ps_tpu_torch.examples.train_mnist_async"
VAN_TIMEOUT_S = 300
# (c): an MNIST MLP tree of 101,800 bytes in 16 KiB buckets (7 buckets)
VAN_BUCKET_BYTES, VAN_POOL = 16 << 10, 2
# (a), (b): a gradient tree recomputed on the CPU from the card's pulled
# params against the card's, ‖Δg‖₂ / max(‖g‖₂, the run's median ‖g‖₂)
VAN_GRAD_RTOL = 1e-5
# (d): the heartbeat horizon of the kill drill
VAN_HB_TIMEOUT_MS, VAN_HB_INTERVAL_MS = 500, 50
# the pinned-staging check: pulls + push_pulls under 3 concurrent workers
STAGING_ROUNDS, STAGING_WORKERS = 200, 3
BERT_LIKE_MB, BERT_LIKE_CYCLES = 440.0, 3


def _van_env():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    # servers and workers start together: a worker dials until its server
    # listens, for up to a minute
    env["PS_CONNECT_MAX_WAIT_MS"] = "60000"
    return here, env


def _spawn_trainer(*args, env_extra=None):
    here, env = _van_env()
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", VAN_TRAINER, *map(str, args)], cwd=here,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_listening(port, timeout=120.0):
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"no server came up on port {port}")


def _distinct_ports(n):
    """``n`` free TCP ports, all different: bound together, then released
    (the runs of phase 16 start at once, each told its ports)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _stop_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


class _VanRun:
    """One cross-process config-5 run: ``shards`` server processes
    (parameters on the card) and ``workers`` worker processes (gradients
    on the card) of the trainer, over loopback TCP, each dumping its
    record into ``out``. :meth:`start` launches the servers and the
    workers at once (a worker dials until its server listens);
    :meth:`finish` waits (all processes are killed at ``VAN_TIMEOUT_S``)
    and reads the dumps."""

    def __init__(self, out, workers, steps, shards=None, worker_args=()):
        self.out, self.workers, self.steps = out, workers, steps
        self.shards, self.worker_args = shards, list(worker_args)
        os.makedirs(out, exist_ok=True)
        self.procs = []

    def start(self, ports=None):
        ports = ports or _distinct_ports(self.shards or 1)
        try:
            for s, p in enumerate(ports):
                self.procs.append(_spawn_trainer(
                    "--role", "server", "--port", p, "--num-workers",
                    self.workers, "--dump", self.out,
                    *(["--shard", s, "--num-shards", self.shards]
                      if self.shards else [])))
            uri = ",".join(f"127.0.0.1:{p}" for p in ports)
            for w in range(self.workers):
                self.procs.append(_spawn_trainer(
                    "--role", "worker", "--server", uri, "--worker-id", w,
                    "--steps", self.steps, "--dump", self.out,
                    *self.worker_args))
        except BaseException:
            _stop_all(self.procs)
            raise
        self.t0 = time.perf_counter()
        return self

    def finish(self):
        outs = []
        try:
            deadline = time.monotonic() + VAN_TIMEOUT_S
            for p in self.procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            _stop_all(self.procs)
        self.wall_s = time.perf_counter() - self.t0
        for p, o in zip(self.procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(p.args[3:9])} exited "
                                     f"{p.returncode}:\n{o[-3000:]}")
        self.infos, self.final, self.records = _van_dumps(
            self.out, self.workers, self.shards)
        return self


def _van_dumps(out, workers, shards=None, server_out=None):
    """The dumps of a run of the trainer: (the servers' records, their
    final params merged, the workers' records). The servers dumped into
    ``server_out`` (default ``out``), the workers into ``out``."""
    server_out = server_out or out
    sfx = [""] if not shards else [str(s) for s in range(shards)]
    infos = [json.load(open(os.path.join(server_out, f"server{x}.json")))
             for x in sfx]
    final = {}
    for x in sfx:
        final.update(torch.load(
            os.path.join(server_out, f"server_params{x}.pt")))
    records = [json.load(open(os.path.join(out, f"worker{w}.json")))
               for w in range(workers)]
    return infos, final, records


def _van_harness():
    """``tests/test_torch_van_harness.py`` of this checkout, loaded by its
    path (another ``tests`` package on the path cannot shadow it): its
    :func:`replay` replays a run of the trainer's processes."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_van_harness.py")
    spec = importlib.util.spec_from_file_location("_van_harness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _van_replay_check(infos, final, records, workers, steps, what):
    """The servers' event logs replayed through one-process servers, every
    gradient recomputed from what its worker pulled: on the card, bitwise
    the servers' final parameters. A witness replays in lockstep on the
    CPU, its gradients recomputed there from the params pulled on the
    card: each gradient tree within VAN_GRAD_RTOL of the card's (its
    2-norm difference over its own norm, floored at the run's median
    norm: a gradient that nearly cancels keeps the rounding of its
    terms; the unfloored reading is printed beside the smallest and
    largest norms), and its final parameters within MNIST_TOL. A CPU
    replay on
    its own trajectory is printed, not held: its gradients feed back its
    own rounding through every stale apply."""
    harness = _van_harness()
    logs = [i["event_log"] for i in infos]
    total = workers * steps
    for info in infos:
        if info["version"] != total or sum(
                info["staleness_hist"].values()) != total:
            raise AssertionError(f"{what}: server version "
                                 f"{info['version']}, histogram "
                                 f"{info['staleness_hist']}; {total} pushes "
                                 f"were sent")
    on_card, witness, grad_err = harness.replay(logs, workers, "cuda",
                                                witness="cpu")
    free = harness.replay(logs, workers, "cpu")
    if sorted(on_card) != sorted(final):
        raise AssertionError(f"{what}: replayed keys differ")
    if grad_err["witness"] > VAN_GRAD_RTOL:
        # the failing push: each layer's gradient difference, and how close
        # its ReLU inputs come to zero on the card (a sign the two devices
        # read differently flips a whole unit's gradient)
        worst = grad_err["worst"]
        log(f"{what}: witness failure at worker {worst['worker']} cycle "
            f"{worst['cycle']}: per-layer |g_cpu - g_card| "
            f"{json.dumps(worst['per_key'])}; min |ReLU input| on the card "
            f"{worst['relu_min_abs']:.3g}, inputs on opposite sides of zero "
            f"{worst['relu_sign_flips']}")
        raise AssertionError(f"{what}: a gradient tree recomputed on the CPU "
                             f"is {grad_err['witness']:.3g} off the card's, "
                             f"past {VAN_GRAD_RTOL} ({grad_err})")
    worst, drift = 0.0, 0.0
    for k, v in final.items():
        if not torch.equal(on_card[k].cpu(), v):
            raise AssertionError(f"{what}: {k} replayed on the card is not "
                                 f"bitwise the servers' final value")
        np.testing.assert_allclose(witness[k].numpy(), v.numpy(),
                                   rtol=MNIST_TOL, atol=MNIST_TOL,
                                   err_msg=f"{what}: {k} on the CPU")
        worst = max(worst, float((witness[k] - v).abs().max()))
        drift = max(drift, float((free[k] - v).abs().max()))
    losses = [r["losses"] for r in records]
    if not all(np.all(np.isfinite(x)) for x in losses):
        raise AssertionError(f"{what}: non-finite loss")
    # printed, not held: at the trainer's defaults (lr 0.1, τ mostly 2)
    # async DC-ASGD does not reliably lower the loss within 60 cycles a
    # worker, in one process either
    first, last = _van_eval_losses(final)
    return {"grad_err": grad_err, "cpu_err": worst, "free_drift": drift,
            "loss": (first, last)}


def _van_grad_errs(checked):
    e = checked["grad_err"]
    w = e["worst"]
    return (f"{e['witness']:.3g} of the larger of the push's norm and the "
            f"median (bound {VAN_GRAD_RTOL}); {e['relative']:.3g} of the "
            f"push's own, norms {e['smallest']:.3g} to {e['largest']:.3g} "
            f"of the median; at its worst push (worker {w['worker']} cycle "
            f"{w['cycle']}) min |ReLU input| {w['relu_min_abs']:.3g}, "
            f"{w['relu_sign_flips']} on opposite sides of zero")


def _van_eval_losses(final):
    """The loss of the initial and of the final params of config 5 on one
    held-out batch of 1,024 examples, on the CPU."""
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv import keys

    params, loss_fn = build(0, "cpu")
    flat, treedef = keys.flatten_with_keys(params)
    trained = keys.unflatten(treedef, final, list(flat))
    batch = tuple(torch.as_tensor(x) for x in
                  next(mnist_batches(1024, seed=1)))
    with torch.no_grad():
        return (float(loss_fn(params, batch)),
                float(loss_fn(trained, batch)))


def _van_mnist_numbers(run):
    """(e) for MNIST: cycles/s, the median cycle and its compute and van
    parts, and the staging copies' share of the worker's cycles."""
    cycles, van, staging, busy = [], [], 0.0, 0.0
    for r in run.records:
        cycles += r["cycle_s"][1:]
        van += r["van_s"][-len(r["cycle_s"]) + 1:]
        staging += r["staging_s"]
        busy += sum(r["cycle_s"])
    cyc, v = float(np.median(cycles)), float(np.median(van))
    # every cycle after each worker's first (connect, first pull, the
    # allocators' warm-up) over one shared window on the host's monotonic
    # clock: from the first worker's second cycle to the last worker's end
    start = min(r["window"][0] for r in run.records)
    end = max(r["window"][1] for r in run.records)
    n = sum(len(r["cycle_s"]) - 1 for r in run.records)
    return {"median_cycle_ms": cyc * 1e3, "median_van_ms": v * 1e3,
            "median_compute_ms": (cyc - v) * 1e3, "cycles_per_s": n /
            (end - start), "window_s": end - start, "cycles": n,
            "staging_share": staging / busy}


def _van_heartbeat_worker(rank, port, hb_base, out):
    """(d), one of two ranks sharing the card over gloo with heartbeats on:
    rank 1 dies hard after one step; rank 0 polls check_health() and
    writes what it raised and how long after the step it took."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.control import WorkerFailureError

    ps.init(backend="cuda", device="cuda:0", dist_backend="gloo",
            heartbeat_base_port=hb_base,
            heartbeat_timeout_ms=VAN_HB_TIMEOUT_MS,
            heartbeat_interval_ms=VAN_HB_INTERVAL_MS,
            **_group_init(2, rank, port))
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    if rank == 1:
        os._exit(17)  # hard death, no goodbye
    backend = ps.current_context().backend
    t0 = time.monotonic()
    result = {"dead": None}
    try:
        while time.monotonic() - t0 < 60:
            backend.check_health()
            time.sleep(0.01)
    except WorkerFailureError as e:
        result = {"dead": e.dead, "seconds": time.monotonic() - t0,
                  "message": str(e)}
    ps.shutdown(abort=True)
    with open(os.path.join(out, "heartbeat.json"), "w") as f:
        json.dump(result, f)


def _start_heartbeat_drill(tmp, port):
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        hb_base = sock.getsockname()[1]
    hb_base = min(hb_base, 65000)
    _, env = _van_env()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--van-heartbeat-worker", str(r), str(port),
                              str(hb_base), tmp], env=env)
            for r in range(2)]


def _finish_heartbeat_drill(procs, tmp):
    try:
        rcs = [p.wait(timeout=VAN_TIMEOUT_S) for p in procs]
    finally:
        _stop_all(procs)
    if rcs != [0, 17]:
        raise AssertionError(f"heartbeat drill ranks exited {rcs}")
    got = json.load(open(os.path.join(tmp, "heartbeat.json")))
    if got["dead"] != [1] or got["seconds"] > 4 * VAN_HB_TIMEOUT_MS / 1e3:
        raise AssertionError(f"heartbeat drill: {got}")
    return got


def _start_doomed_server(port):
    return port, _spawn_trainer("--role", "server", "--port", port,
                                "--num-workers", 1)


def _van_kill_server(port, server):
    """(d): a worker on the card against a trainer server process; the
    server is killed, the worker's next cycle raises ServerFailureError
    naming server 0."""
    import signal

    import ps_tpu_torch as ps
    from ps_tpu_torch.examples.train_mnist_async import build
    from ps_tpu_torch.kv import keys

    try:
        _wait_listening(port)
        params, _ = build(0, "cuda")
        w = ps.connect_async(f"127.0.0.1:{port}", 0, params)
        w.pull_all()
        flat, treedef = keys.flatten_with_keys(params)
        grads = keys.unflatten(treedef, {k: torch.full_like(v, 1e-3)
                                         for k, v in flat.items()},
                               list(flat))
        w.push_pull(grads)
        server.send_signal(signal.SIGKILL)
        server.wait(timeout=30)
        try:
            for _ in range(20):  # a first push may land in a dead buffer
                w.push_pull(grads)
                time.sleep(0.05)
        except ps.ServerFailureError as e:
            if e.server != 0 or "server 0" not in str(e):
                raise AssertionError(f"kill server: {e!r}") from e
            message = str(e)
        else:
            raise AssertionError("a dead server raised no "
                                 "ServerFailureError")
        for ch in w._chs:
            ch.close()
    finally:
        _stop_all([server])
    return message


def _staging_grads(keys_shapes, worker, cycle):
    rng = np.random.default_rng([worker, cycle])
    return {k: torch.from_numpy(rng.normal(0, 1e-2, shape).astype(
        np.float32)).cuda() for k, shape in keys_shapes}


def _van_pinned_staging():
    """The two orderings of pinned staging, under three concurrent
    workers on the card (one serial, two bucketed): STAGING_ROUNDS pulls
    and push_pulls in all, every pulled tree kept and held bitwise against
    the server's event log replayed through a one-process server."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    rng = np.random.default_rng(5)
    shapes = [("a/w", (512, 1024)), ("b/w", (1024, 1024)), ("c/b", (777,)),
              ("d/w", (64, 3000))]
    params = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for k, s in shapes}

    def store_on_card():
        ps.init(backend="cuda", mode="async", num_workers=STAGING_WORKERS,
                dc_lambda=0.04)
        store = ps.KVStore(optimizer="sgd", learning_rate=0.05, mode="async")
        store.init({k: v.cuda() for k, v in params.items()})
        return store

    store = store_on_card()
    svc = AsyncPSService(store, record_full_history=True)
    uri = f"127.0.0.1:{svc.port}"
    per = STAGING_ROUNDS // STAGING_WORKERS
    pulled = {w: [] for w in range(STAGING_WORKERS)}
    errors = []

    def worker(w):
        try:
            c = ps.connect_async(uri, w, {k: v.cuda()
                                          for k, v in params.items()},
                                 bucket_bytes=None if w == 0 else 1 << 20)
            pulled[w].append(c.pull_all())
            for i in range(per):
                if i % 2:
                    pulled[w].append(c.pull_all())
                else:
                    pulled[w].append(c.push_pull(
                        _staging_grads(shapes, w, i // 2)))
            c.close()
        except Exception as e:  # reported below
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(STAGING_WORKERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=VAN_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"staging workers failed: {errors}")
    log_ = list(svc.event_log)
    staged_gb = svc.transport.staging_bytes / 1e9
    tree_mb = sum(v.nbytes for v in params.values()) / 1e6
    svc.stop()
    ps.shutdown()
    store = store_on_card()
    eng = store._engine
    seen = {w: 0 for w in range(STAGING_WORKERS)}
    pushes = {w: 0 for w in range(STAGING_WORKERS)}
    for op, w in log_:
        if op == "pull":
            want = eng.pull_tree(worker=w)
            got = pulled[w][seen[w]]
            seen[w] += 1
            for k in want:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(
                        f"pinned staging: worker {w}'s pull {seen[w] - 1} "
                        f"differs from the replay at {k}")
        else:
            eng.push_tree(_staging_grads(shapes, w, pushes[w]), worker=w)
            pushes[w] += 1
    ps.shutdown()
    if seen != {w: len(pulled[w]) for w in pulled}:
        raise AssertionError(f"pinned staging: pulls {seen} replayed")
    return sum(seen.values()), sum(pushes.values()), secs, staged_gb, tree_mb


def _bert_like_tree(target_mb):
    """tools/bench_van.py's tree: one [30522, 768] embedding, then
    [768, 3072] blocks until target_mb MB, f32 on the card."""
    tree = {"embed/word": torch.zeros(30522, 768, device="cuda")}
    total, i = tree["embed/word"].nbytes, 0
    while total < target_mb * 1e6:
        tree[f"layer{i // 4}/block{i % 4}"] = torch.zeros(768, 3072,
                                                         device="cuda")
        total += 768 * 3072 * 4
        i += 1
    return tree, total


def _van_bert_like():
    """(e): pull and push_pull GB/s of a BERT-base-shaped f32 tree between
    a server and workers on the card (threads of this process), with 1 and
    3 workers, and the share of a cycle the staging copies take."""
    import threading

    import ps_tpu_torch as ps

    ps.init(backend="cuda", mode="async", num_workers=3)
    tree, nbytes = _bert_like_tree(BERT_LIKE_MB)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    store.init(tree)
    svc = ps.serve_async(store)
    uri = f"127.0.0.1:{svc.port}"
    grads = {k: torch.full_like(v, 1e-3) for k, v in tree.items()}
    out = {"tree_bytes": nbytes, "tensors": len(tree)}
    w0 = ps.connect_async(uri, 0, tree)
    w0.pull_all()  # warm-up: pinned buffers, the allocators
    t0 = time.perf_counter()
    for _ in range(BERT_LIKE_CYCLES):
        w0.pull_all()
    out["pull_gbps_1"] = BERT_LIKE_CYCLES * nbytes / (
        time.perf_counter() - t0) / 1e9
    # one pull split: the server's copy off the card, the rest of the
    # round trip (encode, loopback TCP, the receive buffer), the worker's
    # copy onto the card
    from ps_tpu_torch.control import tensor_van as tv

    srv0 = svc.transport.staging_s
    t0 = time.perf_counter()
    msg = w0._request(0, tv.encode(tv.PULL, 0, None))
    t1 = time.perf_counter()
    w0._merge_params({0: msg})
    t2 = time.perf_counter()
    d2h = svc.transport.staging_s - srv0
    out["pull_split_ms"] = (d2h * 1e3, (t1 - t0 - d2h) * 1e3,
                            (t2 - t1) * 1e3)
    s0 = w0.transport.staging_s
    t0 = time.perf_counter()
    for _ in range(BERT_LIKE_CYCLES):
        w0.push_pull(grads)
    dt = time.perf_counter() - t0
    out["push_pull_gbps_1"] = 2 * BERT_LIKE_CYCLES * nbytes / dt / 1e9
    out["staging_share_1"] = (w0.transport.staging_s - s0) / dt
    ws = [w0] + [ps.connect_async(uri, w, tree) for w in (1, 2)]
    for w in ws[1:]:
        w.pull_all()
    before = [w.transport.staging_s for w in ws]
    errors = []

    def cycles(w):
        try:
            for _ in range(BERT_LIKE_CYCLES):
                w.push_pull(grads)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=cycles, args=(w,)) for w in ws]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=VAN_TIMEOUT_S)
    dt = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"BERT-like workers failed: {errors}")
    out["push_pull_gbps_3"] = 3 * 2 * BERT_LIKE_CYCLES * nbytes / dt / 1e9
    out["staging_share_3"] = sum(
        w.transport.staging_s - b for w, b in zip(ws, before)) / (3 * dt)
    out["server_staging_gb"] = svc.transport.staging_bytes / 1e9
    for w in ws:
        w.close()
    svc.stop()
    ps.shutdown()
    return out


def phase_van(tmp):
    """16: the van plane on the card (config 5 across processes)."""
    _launch_counts(reset=True)
    card = _card_line()
    # (a) one server, three workers, the reference trainer's defaults
    a = _VanRun(os.path.join(tmp, "a"), ASYNC_WORKERS, ASYNC_CYCLES).start()
    a.finish()
    ra = _van_replay_check(a.infos, a.final, a.records, a.workers, a.steps,
                           "van (a)")
    # printed, not held: the workers start when their processes do, so
    # how much their cycles overlap is up to the machine (the CPU tests
    # hold real staleness behind a start barrier)
    hist = a.infos[0]["staleness_hist"]
    log(f"van (a): config 5 across processes, one --role server process "
        f"(params on the card) and {ASYNC_WORKERS} --role worker processes, "
        f"MLP hidden 32, batch {ASYNC_BATCH}, lr 0.1, dc_lambda 0.04, "
        f"{ASYNC_CYCLES} cycles a worker: the event log replayed on the card "
        f"is bitwise the server's params; the CPU witness's gradient "
        f"trees, from the card's pulls, off the card's by at most "
        f"{_van_grad_errs(ra)}; its params within {MNIST_TOL} (max abs "
        f"err {ra['cpu_err']:.3g}); a CPU replay on its own trajectory "
        f"{ra['free_drift']:.3g} off (printed); staleness histogram {hist}; "
        f"loss on a held-out batch {ra['loss'][0]:.4f} -> "
        f"{ra['loss'][1]:.4f}; card {card}")
    m = _van_mnist_numbers(a)
    log(f"van (e) MNIST: {m['cycles_per_s']:.1f} cycles/s over "
        f"{ASYNC_WORKERS} workers ({m['cycles']} cycles after each worker's "
        f"first in a shared window of {m['window_s']:.4f} s); median cycle "
        f"{m['median_cycle_ms']:.4f} "
        f"ms = compute {m['median_compute_ms']:.4f} + van (push_pull) "
        f"{m['median_van_ms']:.4f} ms; staging copies "
        f"{100 * m['staging_share']:.2f}% of the workers' cycles; card "
        f"{card}")
    # (b), (c), (d): a two-server partition, one worker serial / bucketed
    # / overlapped, and the failures, all at once (their times are not
    # measurements)
    bucket = ["--bucket-bytes", VAN_BUCKET_BYTES, "--pool", VAN_POOL]
    runs = {
        "b": _VanRun(os.path.join(tmp, "b"), ASYNC_WORKERS, ASYNC_CYCLES,
                     shards=2),
        "serial": _VanRun(os.path.join(tmp, "serial"), 1, ASYNC_CYCLES),
        "bucketed": _VanRun(os.path.join(tmp, "bucketed"), 1, ASYNC_CYCLES,
                            worker_args=bucket),
        "overlap": _VanRun(os.path.join(tmp, "overlap"), 1, ASYNC_CYCLES,
                           worker_args=bucket + ["--overlap"]),
    }
    started, failure = [], None
    ports = _distinct_ports(7)
    drill = _start_heartbeat_drill(tmp, ports.pop())
    doomed = _start_doomed_server(ports.pop())
    try:
        for r in runs.values():
            started.append(r.start([ports.pop()
                                    for _ in range(r.shards or 1)]))
        msg = _van_kill_server(*doomed)
        hb = _finish_heartbeat_drill(drill, tmp)
    finally:
        _stop_all(drill + [doomed[1]])
        for r in started:  # finish (or kill) every run that started
            try:
                r.finish()
            except Exception as e:  # the first failure is raised below
                failure = failure or e
    if failure is not None:
        raise failure
    b = runs["b"]
    rb = _van_replay_check(b.infos, b.final, b.records, b.workers, b.steps,
                           "van (b)")
    keys = [set(i["keys"]) for i in b.infos]
    if keys[0] & keys[1] or sorted(keys[0] | keys[1]) != sorted(b.final):
        raise AssertionError(f"van (b): the partition is not disjoint and "
                             f"complete: {keys}")
    log(f"van (b): the same over a two-server key partition ({len(keys[0])} "
        f"+ {len(keys[1])} keys): replay per shard bitwise on the card, "
        f"the CPU witness's gradient trees off by at most "
        f"{_van_grad_errs(rb)}; its "
        f"params within {MNIST_TOL} (max abs err {rb['cpu_err']:.3g}; on "
        f"its own trajectory {rb['free_drift']:.3g}); "
        f"histograms {[i['staleness_hist'] for i in b.infos]}")
    ser, buc, ovl = runs["serial"], runs["bucketed"], runs["overlap"]
    for k, v in ser.final.items():
        if not torch.equal(buc.final[k], v):
            raise AssertionError(f"van (c): bucketed {k} is not bitwise the "
                                 f"serial one")
    if ovl.records[0]["losses"] != ser.records[0]["losses"]:
        raise AssertionError("van (c): the overlapped losses are not the "
                             "serial ones")
    nb = buc.records[0]["summary"]["transport_buckets"]
    if nb < 2 * (ASYNC_CYCLES - 1):
        raise AssertionError(f"van (c): {nb} buckets: the tree did not "
                             f"split")
    log(f"van (c): one worker, {ASYNC_CYCLES} cycles: bucketed "
        f"({VAN_BUCKET_BYTES} B buckets, pool {VAN_POOL}; {nb} bucket rounds "
        f"after cycle 0) gives bitwise the serial params; --overlap gives "
        f"the serial losses loss for loss (overlap efficiency "
        f"{ovl.records[0]['summary'].get('overlap_efficiency')})")
    log(f"van (d): a killed rank: check_health() raised "
        f"{hb['message']!r} {hb['seconds']:.3f} s after the last step "
        f"(heartbeat_timeout_ms {VAN_HB_TIMEOUT_MS}); a killed server: "
        f"{msg!r}")
    pulls, pushes, secs, gb, mb = _van_pinned_staging()
    log(f"van: pinned staging, {STAGING_WORKERS} concurrent workers on the "
        f"card (one serial, two bucketed): {pulls} pulled trees of "
        f"{mb:.2f} MB over {pushes} pushes, each bitwise the event-log "
        f"replay; {gb:.3f} GB staged by the server in {secs:.2f} s")
    bert = _van_bert_like()
    log(f"van (e) BERT-base-shaped tree ({bert['tree_bytes']:,} bytes f32, "
        f"{bert['tensors']} tensors, server and workers on the card): pull "
        f"{bert['pull_gbps_1']:.3f} GB/s, push_pull "
        f"{bert['push_pull_gbps_1']:.3f} GB/s with 1 worker (staging "
        f"{100 * bert['staging_share_1']:.1f}% of its cycle), push_pull "
        f"{bert['push_pull_gbps_3']:.3f} GB/s over 3 workers (staging "
        f"{100 * bert['staging_share_3']:.1f}%); one pull = the server's "
        f"copy off the card {bert['pull_split_ms'][0]:.1f} ms + encode, "
        f"TCP and receive {bert['pull_split_ms'][1]:.1f} ms + the worker's "
        f"copy onto the card {bert['pull_split_ms'][2]:.1f} ms; card {card}")
    _no_launches("van plane")
    return {"mnist": m, "bert_like": bert, "heartbeat_s": hb["seconds"]}


# phase 17: the sparse PS across processes at config 4's full width
SPARSE_SHARDS, SPARSE_WORKERS, SPARSE_CYCLES = 2, 3, 60
SPARSE_TIMEOUT_S = 300
# (b): one worker, serial against 16 KiB buckets over a pool of 2
SPARSE_BUCKET_BYTES, SPARSE_POOL, SPARSE_TRANSPORT_CYCLES = 16 << 10, 2, 8
SPARSE_CKPT_CYCLES = 6  # (c): cycles before and after the checkpoint
OFF_PUSHES = 5          # (e)


def _emb_leaves(emb):
    """A table's optimizer-state leaves in tree order."""
    from ps_tpu_torch.ops.sparse_apply import state_leaves

    return state_leaves(emb.state())


def _sparse_cycles(harness, w, worker, lo, hi):
    """Cycles ``lo..hi-1`` of ``worker`` at W&D's width (the harness's
    ids and grads), on the card: even cycles pull then push, odd ones
    push_pull."""
    ids = harness.sparse_ids("wd", worker, hi)
    for c in range(lo, hi):
        idt = torch.from_numpy(ids[c]).cuda()
        pushes = {n: (idt, torch.from_numpy(harness.sparse_grads(
            "wd", worker, c, n, ids[c].size)).cuda())
            for n in harness.SPARSE_TABLES}
        req = {n: idt for n in harness.SPARSE_TABLES}
        if c % 2 == 0:
            w.pull(req)
            w.push(pushes)
        else:
            w.push_pull(pushes, req)


def _sparse_services(harness, tables=None):
    """The two shard services in this process, tables on the card."""
    import ps_tpu_torch as ps

    totals = {n: v for n, (v, _) in harness.sparse_spec("wd").items()}
    return [ps.serve_sparse(
        tables[s] if tables else harness.sparse_tables("wd", s,
                                                       SPARSE_SHARDS),
        shard=s, num_shards=SPARSE_SHARDS, total_rows=totals)
        for s in range(SPARSE_SHARDS)]


def _sparse_state(svcs):
    """Every table and optimizer-state leaf of the services, cloned."""
    from ps_tpu_torch.ops.sparse_apply import state_leaves

    return [{n: [t.table.clone()] + [x.clone()
                                     for x in state_leaves(t.state())]
             for n, t in s._tables.items()} for s in svcs]


def _same_state(got, want, what):
    for s, (x, y) in enumerate(zip(got, want)):
        for n in x:
            if not all(torch.equal(p, q) for p, q in zip(x[n], y[n])):
                raise AssertionError(f"{what}: shard {s} table {n} differs")


def _sparse_uri(svcs):
    return ",".join(f"127.0.0.1:{s.port}" for s in svcs)


def _sparse_transports(harness):
    """(b): one worker, serial against bucketed: bitwise the same tables;
    then a push_async followed by a pull sees its own push. Returns the
    bucket rounds of the bucketed run."""
    import ps_tpu_torch as ps

    states, buckets = [], 0
    for bucket_bytes in (None, SPARSE_BUCKET_BYTES):
        svcs = _sparse_services(harness)
        try:
            w = ps.connect_sparse(
                _sparse_uri(svcs), 0, harness.sparse_spec("wd"),
                bucket_bytes=bucket_bytes,
                pool_size=SPARSE_POOL if bucket_bytes else None)
            _sparse_cycles(harness, w, 0, 0, SPARSE_TRANSPORT_CYCLES)
            states.append(_sparse_state(svcs))
            if bucket_bytes:
                buckets = w.transport.buckets
                ids = harness.sparse_ids("wd", 1, 1)[0]
                idt = torch.from_numpy(ids).cuda()
                before = w.versions()
                w.push_async({n: (idt, torch.from_numpy(
                    harness.sparse_grads("wd", 1, 0, n, ids.size)).cuda())
                    for n in harness.SPARSE_TABLES})
                rows = w.pull({n: idt for n in harness.SPARSE_TABLES})
                if w.versions() != {n: v + SPARSE_SHARDS
                                    for n, v in before.items()}:
                    raise AssertionError(
                        f"sparse (b): a pull after push_async saw versions "
                        f"{w.versions()}, from {before}")
                for n, r in rows.items():
                    for svc in svcs:
                        lo, hi = svc._meta[n]["lo"], svc._meta[n]["hi"]
                        pos = torch.nonzero((idt >= lo) & (idt < hi))
                        pos = pos.reshape(-1)
                        want = svc._tables[n].table[(idt[pos] - lo).long()]
                        if not torch.equal(r[pos], want):
                            raise AssertionError(
                                "sparse (b): a pull after push_async did "
                                "not see its own push")
            w.close()
        finally:
            for s in svcs:
                s.stop()
    _same_state(states[1], states[0], "sparse (b): bucketed against serial")
    if buckets < 2 * SPARSE_SHARDS * SPARSE_TRANSPORT_CYCLES:
        raise AssertionError(f"sparse (b): {buckets} bucket rounds: the "
                             f"pushes did not split")
    return buckets


def _sparse_checkpoint(harness, tmp):
    """(c): checkpoint_all mid-run over the two shards; both servers
    restart from it and the run that continues equals the uninterrupted
    one, bitwise. Returns the save's seconds."""
    import ps_tpu_torch as ps

    path = os.path.join(tmp, "ckpt")
    k = SPARSE_CKPT_CYCLES
    svcs = _sparse_services(harness)
    try:
        w = ps.connect_sparse(_sparse_uri(svcs), 0, harness.sparse_spec("wd"))
        _sparse_cycles(harness, w, 0, 0, k)
        t0 = time.perf_counter()
        versions = w.checkpoint_all(path)
        save_s = time.perf_counter() - t0
        _sparse_cycles(harness, w, 0, k, 2 * k)
        uninterrupted = _sparse_state(svcs)
    finally:
        for s in svcs:
            s.stop()
    tables = []
    for s in range(SPARSE_SHARDS):
        t = harness.sparse_tables("wd", s, SPARSE_SHARDS)
        for n, emb in t.items():
            emb.restore(os.path.join(path, f"shard{s}", n))
        tables.append(t)
    svcs = _sparse_services(harness, tables)
    try:
        w.reconnect([("127.0.0.1", s.port) for s in svcs])
        if w.versions() != versions:
            raise AssertionError(f"sparse (c): restarted servers at versions "
                                 f"{w.versions()}, saved {versions}")
        _sparse_cycles(harness, w, 0, k, 2 * k)
        _same_state(_sparse_state(svcs), uninterrupted,
                    "sparse (c): resumed against uninterrupted")
        w.close()
    finally:
        for s in svcs:
            s.stop()
    return save_s


def _sparse_kill(harness, servers, out):
    """(d): a SIGKILL of server 0 of two; the worker raises
    ServerFailureError naming server 0."""
    import signal

    import ps_tpu_torch as ps

    try:
        ports = [harness.server_port(p, out, s)
                 for s, p in enumerate(servers)]
        w = ps.connect_sparse(",".join(f"127.0.0.1:{p}" for p in ports), 0,
                              harness.sparse_spec("small"))
        ids = harness.sparse_ids("small", 0, 20)

        def push(c):
            w.push({n: (ids[c], harness.sparse_grads("small", 0, c, n,
                                                     ids[c].size))
                    for n in harness.SPARSE_TABLES})

        push(0)
        servers[0].send_signal(signal.SIGKILL)
        servers[0].wait(timeout=30)
        try:
            for c in range(1, 20):  # a first push may land in a dead buffer
                push(c)
                time.sleep(0.05)
        except ps.ServerFailureError as e:
            if e.server != 0 or "server 0" not in str(e):
                raise AssertionError(f"sparse (d): {e!r}") from e
            message = str(e)
        else:
            raise AssertionError("sparse (d): a dead server raised no "
                                 "ServerFailureError")
        for ch in w._chs:
            ch.close()
    finally:
        harness.kill_all(servers)
    return message


def _sparse_off_tier():
    """(e): the masked full-table tier against the kernels on the card at
    phase 4's shape, OFF_PUSHES pushes of a batch's ids each."""
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    cfg, _ = _slice_ids(seed=0)
    pushes = [_slice_ids(seed=20 + i)[1] for i in range(OFF_PUSHES)]
    errs, off_ms = {}, {}
    for name, rule, dim in (("deep", "adagrad", cfg.embed_dim),
                            ("wide", "sgd", 1)):
        opt = rowwise.make_rowwise(rule, learning_rate=0.05)
        g = torch.Generator("cuda").manual_seed(9)
        table = 0.01 * torch.randn((cfg.total_rows, dim), generator=g,
                                   device="cuda")
        grads = [torch.randn((ids.numel(), dim), generator=g, device="cuda")
                 for ids in pushes]
        runs = {}
        for tier in ("cuda", "off"):
            t, st = table.clone(), opt.init(table)
            for ids, gr in zip(pushes, grads):
                ops.fused_sparse_apply(t, st, ids, gr, opt, tier)
            runs[tier] = [t] + ops.state_leaves(st)
        torch.cuda.synchronize()
        if rule == "sgd" and not torch.equal(runs["off"][0], runs["cuda"][0]):
            raise AssertionError("sparse (e): the 'off' tier's sgd table is "
                                 "not bitwise the kernel's")
        errs[name] = max(_compare(a, b, torch.float32, f"off tier {name}")
                         for a, b in zip(runs["off"], runs["cuda"]))
        t, st = table.clone(), opt.init(table)
        # a caller's time: the tier reads its pass sizes on the host
        off_ms[name] = _call_ms(lambda: ops.fused_sparse_apply(
            t, st, pushes[0], grads[0], opt, "off"), iters=10, warmup=2)
        del table, grads, runs, t, st
    return errs, off_ms


def _sparse_shard_timings(harness, card):
    """(f): both sparse kernels at a server shard's shape: the routed push
    of median size over (a)'s pushes, into [1,300,000, D] tables."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_sparse import row_range
    from ps_tpu_torch.ops import sparse_apply as ops
    from ps_tpu_torch.optim import rowwise

    routed = []  # (size, shard-local ids)
    for w in range(SPARSE_WORKERS):
        for s in range(SPARSE_SHARDS):
            for per in harness.routed_pushes("wd", w, s, SPARSE_SHARDS,
                                             SPARSE_CYCLES):
                routed.append((per["deep"][0].size, per["deep"][0]))
    routed.sort(key=lambda x: x[0])
    n_med, local = routed[len(routed) // 2]
    rows = row_range(0, SPARSE_SHARDS, harness.sparse_spec("wd")["deep"][0])
    rows = rows[1] - rows[0]
    ids = torch.from_numpy(local).cuda()
    group_ms = _device_ms(lambda: ops.group_ids(ids, rows))
    group = ops.group_ids(ids, rows)
    segs = int(group.meta[0])
    group_bytes = 4 * n_med + 4 * 2 * n_med + 4 * (2 * segs + 1) + 4 * ops.META
    out = {"ids": n_med, "max_ids": routed[-1][0],
           "path": ops.plan_group(n_med, rows)["path"],
           "group": {"ms": group_ms,
                     "bound_ms": group_bytes / _card_peaks()[0] * 1e3,
                     "plain_ms": _call_ms(lambda: ops._group_torch(ids, rows),
                                          iters=50),
                     "library_ms": _device_ms(
                         lambda: torch.sort(ids, stable=True))}}
    log(json.dumps({"kernel": "sparse_group", "where": "sparse PS shard",
                    "ids": n_med, "segments": segs, "rows": rows,
                    **out["group"], "card": card}))
    ps.init(backend="cuda")
    for name in ("deep", "wide"):
        rule = harness.SPARSE_TABLES[name][0]
        dim = harness.sparse_spec("wd")[name][1]
        opt = rowwise.make_rowwise(rule, learning_rate=harness.SPARSE_LR)
        g = torch.Generator("cuda").manual_seed(5)
        table = 0.01 * torch.randn((rows, dim), generator=g, device="cuda")
        state = opt.init(table)
        grads = 1e-3 * torch.randn((n_med, dim), generator=g, device="cuda")
        emb = ps.SparseEmbedding(rows, dim, optimizer=rule,
                                 learning_rate=harness.SPARSE_LR)
        emb.init(table)
        bound_ms, nbytes, uniq = _bound_ms(ids, dim, opt, 4)
        out[name] = {
            "ms": _device_ms(lambda: ops.fused_sparse_apply(
                table, state, ids, grads, opt, "cuda")),
            "launch_ms": _device_ms(lambda: ops._launch(opt, table, state,
                                                        group, grads)),
            "plain_ms": _call_ms(lambda: ops._apply_torch(
                opt, table, state, *ops.batch_segment_sum(ids, grads)),
                iters=50),
            # what the service's apply waits: the table's push, its
            # row_version read of the ids on the host included
            "push_ms": _call_ms(lambda: emb.push(ids, grads), iters=50),
            "bound_ms": bound_ms, "bytes": nbytes, "unique_ids": uniq}
        log(json.dumps({"kernel": "sparse_apply", "where": "sparse PS shard",
                        "table": name, "rule": rule, "shape": [rows, dim],
                        "ids": n_med, **out[name], "card": card}))
        del table, state, grads, emb
    ps.shutdown()
    return out


def _sparse_numbers(infos, records):
    """(f) from (a): cycles/s over one shared window, the median round
    trips, each server's median sparse apply and rows/s, the staging
    share of the workers' cycles."""
    start = min(r["window"][0] for r in records)
    end = max(r["window"][1] for r in records)
    n = sum(len(r["cycle_s"]) - 1 for r in records)
    ops_ms = {k: float(np.median(sum((r["ops"][k] for r in records), [])))
              * 1e3 for k in ("pull", "push", "push_pull")}
    servers = [{"sparse_apply_ms": float(np.median(i["sparse_apply_s"])) * 1e3,
                "apply_ms": float(np.median(i["apply_s"])) * 1e3,
                "rows_per_s": i["rows"] / sum(i["sparse_apply_s"]),
                "pushes": len(i["apply_log"])} for i in infos]
    busy = sum(sum(r["cycle_s"]) for r in records)
    return {"cycles_per_s": n / (end - start), "cycles": n,
            "window_s": end - start, "ops_ms": ops_ms, "servers": servers,
            "median_cycle_ms": float(np.median(sum(
                (r["cycle_s"][1:] for r in records), []))) * 1e3,
            "staging_share": sum(r["staging_s"] for r in records) / busy}


def phase_sparse_ps(tmp):
    """17: the sparse PS across processes on the card (config 4)."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t_phase = time.perf_counter()
    # (a) two server processes, three worker processes
    a_out = os.path.join(tmp, "a")
    procs = _sparse_ps_spawn(harness, a_out, {}, [{}] * SPARSE_WORKERS,
                             SPARSE_CYCLES)
    infos, finals, records, pulls = _sparse_ps_read(harness, a_out, procs,
                                                    "sparse (a)")
    t_a = time.perf_counter() - t_phase
    # (d)'s servers boot while (a) is checked and (b)-(c) run
    d_out = os.path.join(tmp, "d")
    os.makedirs(d_out)
    doomed = [harness.spawn("sparse-server", d_out, 1, 10_000, s,
                            SPARSE_SHARDS, "cuda", "small")
              for s in range(SPARSE_SHARDS)]
    try:
        launches = _sparse_ps_launches(harness, infos, "sparse (a)",
                                       SPARSE_CYCLES)
        checked = _sparse_ps_replay_on_card(harness, infos, finals, pulls,
                                            "sparse (a)", SPARSE_CYCLES)
        del pulls
        ps.init(backend="cuda", device="cpu")
        cpu_tables, _ = harness.sparse_replay(infos, "wd", SPARSE_WORKERS,
                                              SPARSE_CYCLES)
        cpu_err = {"table": 0.0, "state": 0.0}
        for s, final in enumerate(finals):
            for name, emb in cpu_tables[s].items():
                leaves = [emb.table] + _emb_leaves(emb)
                saved = [final[name]] + [final[f"{name}/state{i}"]
                                         for i in range(len(leaves) - 1)]
                for k, (x, y) in enumerate(zip(leaves, saved)):
                    x = x.numpy()
                    if harness.SPARSE_TABLES[name][0] == "sgd":
                        if not np.array_equal(x, y):
                            raise AssertionError(
                                f"sparse (a): shard {s} {name} on the CPU "
                                f"is not bitwise the card's")
                    np.testing.assert_allclose(
                        x, y, rtol=RTOL, atol=ATOL,
                        err_msg=f"sparse (a): shard {s} {name} on the CPU")
                    what = "state" if k else "table"
                    cpu_err[what] = max(cpu_err[what],
                                        float(np.max(np.abs(x - y))))
        ps.shutdown()
        del cpu_tables, finals
        t_check = time.perf_counter() - t_phase - t_a
        m = _sparse_numbers(infos, records)
        log(f"sparse (a): {SPARSE_SHARDS} serve_sparse processes (shard s "
            f"of {SPARSE_SHARDS}, W&D's deep [1,300,000, 16] adagrad and "
            f"wide [1,300,000, 1] sgd, lr {harness.SPARSE_LR}, on the card) "
            f"and {SPARSE_WORKERS} connect_sparse processes x "
            f"{SPARSE_CYCLES} cycles of 13,312 ids (ids and grads on the "
            f"card): applies {[s['pushes'] for s in m['servers']]}, each "
            f"2 grouping (cluster path) + 2 apply launches; the logs "
            f"replayed on the card bitwise the servers' tables and state; "
            f"{checked} pulled row sets bitwise the replay at their "
            f"versions; the CPU's torch tier: sgd bitwise, adagrad max abs "
            f"err {cpu_err['table']:.3g} on the tables, "
            f"{cpu_err['state']:.3g} on the accumulators (rtol {RTOL}, "
            f"atol {ATOL}); run "
            f"{t_a:.1f} s, checks {t_check:.1f} s")
        # (b), (c) in this process, tables on the card
        ps.init(backend="cuda")
        buckets = _sparse_transports(harness)
        log(f"sparse (b): one worker, {SPARSE_TRANSPORT_CYCLES} cycles: "
            f"bucketed ({SPARSE_BUCKET_BYTES} B buckets, pool {SPARSE_POOL}, "
            f"{buckets} bucket rounds) gives bitwise the serial tables and "
            f"state; a pull after push_async saw its push")
        save_s = _sparse_checkpoint(harness, tmp)
        ps.shutdown()
        log(f"sparse (c): checkpoint_all after {SPARSE_CKPT_CYCLES} cycles "
            f"over both shards ({save_s:.3f} s), both servers restarted from "
            f"it, {SPARSE_CKPT_CYCLES} more cycles bitwise the "
            f"uninterrupted run's tables and state")
        message = _sparse_kill(harness, doomed, d_out)
        log(f"sparse (d): a SIGKILLed server 0: {message!r}")
    finally:
        harness.kill_all(doomed)
    off_err, off_ms = _sparse_off_tier()
    log(f"sparse (e): the 'off' tier on the card, {OFF_PUSHES} pushes of "
        f"13,312 ids into [2,600,000, 16] adagrad and [2,600,000, 1] sgd: "
        f"sgd bitwise the kernels', adagrad max abs err {off_err['deep']:.3g} "
        f"(rtol {RTOL}, atol {ATOL}); one push {off_ms['deep']:.4f} / "
        f"{off_ms['wide']:.4f} ms (a caller's time)")
    shard = _sparse_shard_timings(harness, card)
    log(f"sparse (f): {m['cycles_per_s']:.1f} cycles/s over "
        f"{SPARSE_WORKERS} workers ({m['cycles']} cycles after each "
        f"worker's first, shared window {m['window_s']:.4f} s); median "
        f"cycle {m['median_cycle_ms']:.4f} ms; median round trips pull "
        f"{m['ops_ms']['pull']:.4f}, push {m['ops_ms']['push']:.4f}, "
        f"push_pull {m['ops_ms']['push_pull']:.4f} ms; staging "
        f"{100 * m['staging_share']:.2f}% of the workers' cycles")
    for s, srv in enumerate(m["servers"]):
        log(f"sparse (f): server {s}: median sparse apply "
            f"{srv['sparse_apply_ms']:.4f} ms (both tables, synchronized), "
            f"{srv['rows_per_s']:.0f} rows/s; median apply with the lock "
            f"{srv['apply_ms']:.4f} ms")
    log(f"sparse (f): kernels at a shard's shape (median push "
        f"{shard['ids']} ids, largest {shard['max_ids']}, "
        f"{shard['path']} path): grouping {shard['group']['ms']:.5f} ms "
        f"(bound {shard['group']['bound_ms']:.6f}); deep "
        f"{shard['deep']['ms']:.5f} (bound {shard['deep']['bound_ms']:.6f}), "
        f"wide {shard['wide']['ms']:.5f} (bound "
        f"{shard['wide']['bound_ms']:.6f}); a table's push as the service "
        f"waits it {shard['deep']['push_ms']:.4f} / "
        f"{shard['wide']['push_ms']:.4f} ms; card {card}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "shard": shard, "numbers": m,
            "off_err": off_err}


# phase 18: the 'model', 'seq' and 'pipe' axes, two ranks sharing the card
# over gloo. (a) BERT-base under --model-axis 2, phase 7's configuration.
# Its f32 step is held to one process's: the loss by phase 15's f32 loss
# gate and the update per tensor by phase 15's one-process update gate;
# a control that skips the row-parallel all-reduce (each rank's partial
# sums taken for the whole) must land AXES_CONTROL_FACTOR outside the
# update gate. Its bf16 losses are two bf16 forwards that split the
# GEMMs differently (the heads over two ranks, the row-parallel products
# in bf16 halves, summed): each activation may round the other way (one bf16 ulp,
# 2^-8 of itself), so the mean loss is held to AXES_BF16_LOSS_GATE, a
# quarter of one bf16 rounding; the f32 step is the tight check. (b) the
# long-context LM at the reference trainer's defaults, each parallel
# run's losses within the reference's 2e-4 (tests/test_lm.py) of one
# process's 'full'. (c) the causal flash kernel at a head width it takes,
# through lm.make_attn_fn('flash')
AXES_TIMEOUT_S = 600
AXES_BERT_STEPS = 3
AXES_CONTROL_FACTOR = 10.0
AXES_BF16_LOSS_GATE = 1e-3
AXES_TP = 2
LM_CFG = dict(vocab=256, d_model=64, n_heads=8, n_layers=2)
LM_SEQ, LM_BATCH, LM_LR, LM_STEPS = 256, 8, 3e-3, 6
LM_TOL = 2e-4
# (mesh, attn, microbatches) of each two-rank LM run
LM_RUNS = {"ring": ({"data": 1, "seq": 2}, "ring", 0),
           "ulysses": ({"data": 1, "seq": 2}, "ulysses", 0),
           "pipe": ({"data": 1, "pipe": 2}, "full", 2)}
# (c): the causal kernel at d_model 512, 8 heads (head width 64), seq 2048
CAUSAL_B, CAUSAL_T, CAUSAL_H, CAUSAL_D = 2, 2048, 8, 64


@contextlib.contextmanager
def _no_row_reduce():
    """The control of phase 18 (a): Megatron's ``g`` (the row-parallel
    all-reduce over 'model') taken out, so each rank's forward takes its
    partial sums for the whole."""
    from ps_tpu_torch.parallel import collectives

    saved = collectives.reduce_from_axis
    collectives.reduce_from_axis = lambda t, mesh, axis: t
    try:
        yield
    finally:
        collectives.reduce_from_axis = saved


def _axes_bert_runs():
    """Phase 18 (a)'s runs: ``{name: (dtype, control, steps)}``."""
    return {"bert": (torch.bfloat16, False, AXES_BERT_STEPS),
            "bert_f32": (torch.float32, False, 1),
            "bert_f32/no_row_reduce": (torch.float32, True, 1)}


def _axes_bert_worker(rank, port, outdir):
    """Phase 18 (a) on one of two ranks: BERT-base MLM on ``{data: 1,
    model: 2}`` with bert_partition_rules and LAMB 'sharded', as the
    trainer's ``--model-axis 2`` runs it."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models.bert import (BertConfig, BertMLM,
                                          bert_partition_rules,
                                          make_mlm_loss_fn)

    ctx = ps.init(backend="cuda", device="cuda:0",
                  mesh_shape={"data": 1, "model": AXES_TP},
                  **_group_init(AXES_TP, rank, port, dist_backend="gloo"))
    mesh = ctx.mesh
    fa = _flash()
    results = {"backend": mesh.backend, "coords": dict(mesh.coords)}
    batches = [rank_slice(b, mesh) for b in _bert_batches()]
    for name, (dtype, control, steps) in _axes_bert_runs().items():
        model = BertMLM(BertConfig(dtype=dtype, attn="flash"),
                        generator=torch.Generator().manual_seed(0))
        store = ps.KVStore(optimizer="lamb", learning_rate=1e-3,
                           weight_decay=0.01, placement="sharded",
                           partition_rules=bert_partition_rules())
        store.init(model.param_tree())
        run = store.make_step(make_mlm_loss_fn(model, mesh=store.mesh))
        placed = [store.shard_batch(b) for b in batches[:steps]]
        held = sum(t.numel() for t in store._engine._params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.calls.clear()
        fa.LAUNCHES = 0
        losses, times = [], []
        with _no_row_reduce() if control else contextlib.nullcontext():
            for b in placed:
                t0 = time.perf_counter()
                loss, _ = run(b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(loss))
        launches = fa.LAUNCHES
        # the forward's whole leaves (embeddings, LayerNorms, the biases
        # no rule covers), gathered over 'model' after each step
        gathers = [c.nbytes for c in mesh.calls
                   if c.op == "all_gather" and c.axis == "model"]
        params = store.params()
        results[name] = {
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "held": held, "gathers": gathers,
            "whole": sum(p.numel() for p in model.parameters()),
            "row_reduces": sum(c.op == "all_reduce" and c.axis == "model"
                               and len(c.shape) == 3 for c in mesh.calls)}
        if dtype == torch.float32:
            update = _bert_update(model, params)
            results[name]["update"] = update if rank == 0 else None
            results[name]["digest"] = {k: float(v.double().sum())
                                       for k, v in update.items()}
        del model, store, run, placed, params
        torch.cuda.empty_cache()
    torch.save(results, os.path.join(outdir, f"axes_bert{rank}.pt"))
    ps.shutdown()


def _lm_losses(store, loss_fn, mesh, steps=LM_STEPS):
    """``steps`` steps of the LM through ``store.make_step`` on this rank's
    part of the reference trainer's batches; the losses and step times."""
    from ps_tpu_torch.kv.store import rank_slice
    from ps_tpu_torch.models import lm

    run = store.make_step(loss_fn)
    losses, times = [], []
    for b in lm.lm_batches(LM_BATCH, LM_SEQ, vocab=LM_CFG["vocab"], seed=0,
                           steps=steps):
        placed = store.shard_batch(rank_slice(b, mesh))
        t0 = time.perf_counter()
        loss, _ = run(placed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return losses, times


def _lm_store(mesh, attn, microbatches):
    import ps_tpu_torch as ps
    from ps_tpu_torch.models import lm

    params = lm.init_params(np.random.default_rng(0), **LM_CFG,
                            max_len=LM_SEQ + 1)
    attn_fn = lm.make_attn_fn(attn, mesh=mesh)
    rules = None
    if microbatches:
        pp = mesh.axis_size("pipe")
        params = lm.split_pipeline_params(params, num_stages=pp)
        rules = lm.pipeline_lm_partition_rules()
        loss_fn = lm.make_pipelined_loss_fn(
            n_heads=LM_CFG["n_heads"], num_stages=pp,
            microbatches=microbatches, mesh=mesh, attn_fn=attn_fn)
    else:
        loss_fn = lm.make_loss_fn(n_heads=LM_CFG["n_heads"], attn_fn=attn_fn,
                                  mesh=mesh)
    store = ps.KVStore(optimizer="adam", learning_rate=LM_LR,
                       placement="sharded", partition_rules=rules)
    store.init(params)
    return store, loss_fn


def _axes_lm_worker(rank, ports, outdir):
    """Phase 18 (b) on one of two ranks: the LM runs of LM_RUNS, each in a
    process group of its own (``ports``: one a run, comma-separated)."""
    import ps_tpu_torch as ps

    results = {}
    ports = [int(p) for p in ports.split(",")]
    for port, (name, (shape, attn, micro)) in zip(ports, LM_RUNS.items()):
        ctx = ps.init(backend="cuda", device="cuda:0", mesh_shape=shape,
                      **_group_init(2, rank, port, dist_backend="gloo"))
        store, loss_fn = _lm_store(ctx.mesh, attn, micro)
        losses, times = _lm_losses(store, loss_fn, ctx.mesh)
        results[name] = {"losses": losses, "step_ms": [t * 1e3
                                                       for t in times],
                         "ops": sorted({(c.op, c.axis)
                                        for c in ctx.mesh.calls})}
        ps.shutdown()
    torch.save(results, os.path.join(outdir, f"axes_lm{rank}.pt"))


def _run_pair(flag, port, tmp, extra_env=None, args=()):
    """Two processes of ``flag`` (this script's worker modes, or a module
    with ``args``), waited for, killed if they outlive AXES_TIMEOUT_S."""
    if flag.startswith("--"):
        cmds = [[sys.executable, os.path.abspath(__file__), flag, str(r),
                 str(port), tmp] for r in range(2)]
    else:
        cmds = [[sys.executable, "-m", flag, *args] for _ in range(2)]
    procs, outs = [], []
    here = os.path.dirname(os.path.abspath(__file__))
    for r, cmd in enumerate(cmds):
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        if extra_env:
            env.update({k: v.format(rank=r) for k, v in extra_env.items()})
        out = open(os.path.join(tmp, f"pair-{port}-{r}.log"), "w+")
        outs.append(out)
        procs.append(subprocess.Popen(cmd, env=env, stdout=out, cwd=here,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        rcs = [p.wait(timeout=AXES_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for out in outs:
        out.seek(0)
        logs.append(out.read())
        out.close()
    if rcs != [0, 0]:
        raise AssertionError(f"{flag} pair exited {rcs}:\n"
                             + "\n".join(l[-3000:] for l in logs))
    return logs


def _axes_bert(tmp, card):
    """Phase 18 (a): two tensor-parallel ranks against one process."""
    from ps_tpu_torch.models.bert import BertConfig, BertMLM

    _run_pair("--axes-bert-worker", _free_port(), tmp)
    ranks = [torch.load(os.path.join(tmp, f"axes_bert{r}.pt"),
                        weights_only=False) for r in range(2)]
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"backends {[r['backend'] for r in ranks]}")
    batches = _bert_batches()
    one = {}
    for dtype, steps in ((torch.bfloat16, AXES_BERT_STEPS),
                         (torch.float32, 1)):
        model = BertMLM(BertConfig(dtype=dtype, attn="flash"),
                        generator=torch.Generator().manual_seed(0))
        losses, times, params = _bert_run(model, "cuda", batches[:steps])
        one[dtype] = (losses, _bert_update(model, params)
                      if dtype == torch.float32 else None, times)
        del model, params
        torch.cuda.empty_cache()
    layers = BertConfig().num_layers
    per = [r["bert"] for r in ranks]
    loss_gate = AXES_BF16_LOSS_GATE
    rel = [abs(a - b) / abs(b) for a, b in zip(per[0]["losses"],
                                               one[torch.bfloat16][0])]
    f32_gate = TWO_RESNET_GATES[torch.float32][0]
    f32_rel = {name: abs(ranks[0][name]["losses"][0] - one[torch.float32][0][0])
               / abs(one[torch.float32][0][0])
               for name in ("bert_f32", "bert_f32/no_row_reduce")}
    if f32_rel["bert_f32"] > f32_gate or \
            f32_rel["bert_f32/no_row_reduce"] < AXES_CONTROL_FACTOR * f32_gate:
        raise AssertionError(f"BERT --model-axis 2 f32 loss against one "
                             f"process: relative {f32_rel} (gate {f32_gate}; "
                             f"the control must land "
                             f"{AXES_CONTROL_FACTOR}x outside)")
    for r in per:
        if r["launches"] != layers * AXES_BERT_STEPS or \
                r["losses"] != per[0]["losses"]:
            raise AssertionError(
                f"BERT --model-axis 2: flash launches {r['launches']} (want "
                f"{layers * AXES_BERT_STEPS}), losses {r['losses']} vs rank "
                f"0's {per[0]['losses']}")
        # g's all-reduce of the row-parallel sums forward and f's of the
        # column-parallel inputs' gradients backward: 2 + 2 a layer a step
        if r["row_reduces"] != 4 * layers * AXES_BERT_STEPS:
            raise AssertionError(f"BERT --model-axis 2: {r['row_reduces']} "
                                 f"activation all-reduces over 'model'")
        # one flat all-gather a step of every f32 leaf the heuristic cut
        if len(r["gathers"]) != AXES_BERT_STEPS:
            raise AssertionError(f"BERT --model-axis 2: {len(r['gathers'])} "
                                 f"all-gathers of the forward's whole "
                                 f"leaves over 'model' in "
                                 f"{AXES_BERT_STEPS} steps")
    if not np.all(np.isfinite(per[0]["losses"])) or max(rel) > loss_gate:
        raise AssertionError(f"BERT --model-axis 2 bf16 losses "
                             f"{per[0]['losses']} vs one process "
                             f"{one[torch.bfloat16][0]}: relative {rel} "
                             f"(gate {loss_gate})")
    # (the control's ranks each take their own partial sums: they differ)
    if ranks[1]["bert_f32"]["digest"] != ranks[0]["bert_f32"]["digest"]:
        raise AssertionError("bert_f32: the ranks' params differ")
    gate = TWO_BERT_UPDATE_GATES["one process"]
    held = _bert_update_deviation(ranks[0]["bert_f32"]["update"],
                                  one[torch.float32][1], TWO_BERT_NOISE_ONLY)
    control = _bert_update_deviation(
        ranks[0]["bert_f32/no_row_reduce"]["update"], one[torch.float32][1],
        TWO_BERT_NOISE_ONLY)
    readings = (f"f32 loss against one process: relative "
                f"{f32_rel['bert_f32']:.3g} (gate {f32_gate}; the control "
                f"{f32_rel['bert_f32/no_row_reduce']:.3g}); "
                f"f32 update against one process: worst per-tensor relative "
                f"2-norm {held[0]:.3g} ({held[1]}), gate {gate}; the control "
                f"without the row-parallel all-reduce {control[0]:.3g} "
                f"({control[1]}, {control[0] / gate:.1f}x the gate); the "
                f"{TWO_BERT_NOISE_ONLY} tensors (round-off only): "
                f"{held[2]:.3g}")
    if held[0] > gate:
        raise AssertionError(f"BERT --model-axis 2: {readings}")
    if control[0] < AXES_CONTROL_FACTOR * gate:
        raise AssertionError(f"BERT --model-axis 2: the control lands "
                             f"inside {AXES_CONTROL_FACTOR}x the gate: "
                             f"{readings}")
    r0 = per[0]
    log(f"phase 18 (a): BERT-base MLM, --model-axis 2 ({{data: 1, model: "
        f"2}}, two ranks on one card over gloo), bert_partition_rules, LAMB "
        f"'sharded', flash on each rank's 6 of 12 heads, seq {BERT_SEQ}, "
        f"global batch {BERT_BATCH}, bf16: {AXES_BERT_STEPS} steps, losses "
        f"{[round(x, 5) for x in r0['losses']]} vs one process "
        f"{[round(x, 5) for x in one[torch.bfloat16][0]]} (relative "
        f"{max(rel):.3g}, gate {loss_gate}); flash launches a rank "
        f"{[r['launches'] for r in per]} ({layers} a step); "
        f"{r0['row_reduces']} activation all-reduces over 'model' a rank "
        f"(2 forward, 2 backward a layer a step); "
        f"{len(r0['gathers'])} all-gathers over 'model' of the leaves the "
        f"forward takes whole ({r0['gathers'][0]:,} bytes each, one a "
        f"step); a rank holds "
        f"{r0['held']:,} of {r0['whole']:,} parameters; {readings}; card "
        f"{card}")
    log(f"phase 18 (a), a correctness run through host memory, not a speed "
        f"figure: step ms a rank {[[round(t, 1) for t in r['step_ms']] for r in per]}, "
        f"peak memory a rank {[round(r['peak_gib'], 2) for r in per]} GiB; "
        f"one process {[round(t * 1e3, 1) for t in one[torch.bfloat16][2]]} "
        f"ms; card {card}")
    return {"launches": [r["launches"] for r in per],
            "peak_gib": [r["peak_gib"] for r in per]}


def _flash_entry(q, k, v, mask, heads, causal, dtype):
    """Kernel against plain on ``q, k, v`` [BH, S, d] and their device
    times, beside scaled_dot_product_attention's on the same tensors."""
    fa = _flash()
    bh, s, d = q.shape
    b = bh // heads
    scale = d ** -0.5
    out, _ = fa._flash_fwd_cuda(q, k, v, mask, scale, causal, heads)
    want, _ = fa._flash_fwd_torch(q, k, v, mask, scale, causal, heads)
    err = _flash_compare(out, want, dtype, f"flash [{bh}, {s}, {d}] {dtype} "
                         f"causal={causal}")
    ms = _device_ms(lambda: fa._flash_fwd_cuda(q, k, v, mask, scale, causal,
                                               heads))
    plain_ms = _call_ms(lambda: fa._flash_fwd_torch(
        q, k, v, mask, scale, causal, heads), iters=5, warmup=1)
    qs, ks, vs = (t.reshape(b, heads, s, d) for t in (q, k, v))
    if causal:
        library_ms = _device_ms(lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    qs, ks, vs, is_causal=True))
    else:
        keep = (mask > 0)[:, None, None, :]
        library_ms = _device_ms(lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    qs, ks, vs, attn_mask=keep))
    size = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * s * d * size + bh * s * 4 + b * s * 4
    # the score pairs this run needs: all of them, or the causal triangle
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * pairs * d
    peak = (_card_peaks()[1] if dtype == torch.bfloat16
            else _card_f32_flops())
    bytes_ms = nbytes / _card_peaks()[0] * 1e3
    flops_ms = flops / peak * 1e3
    return {"shape": [bh, s, d], "dtype": str(dtype).split(".")[-1],
            "causal": causal, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def _axes_causal_flash(card):
    """Phase 18 (c): the causal kernel through lm.make_attn_fn('flash') at
    head width 64, and one LM step with attn='flash' (n_layers launches)
    against 'full'."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.models import lm

    fa = _flash()
    dev = torch.device("cuda", 0)
    fn = lm.make_attn_fn("flash")
    entries = {}
    g = torch.Generator(dev).manual_seed(18)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((CAUSAL_B, CAUSAL_T, CAUSAL_H, CAUSAL_D),
                               generator=g, device=dev).to(dtype)
                   for _ in range(3))
        fa.LAUNCHES = 0
        out = fn(q, k, v, causal=True)
        if fa.LAUNCHES != 1:
            raise AssertionError(f"make_attn_fn('flash'): {fa.LAUNCHES} "
                                 f"launches")

        def pack(x):
            return x.transpose(1, 2).reshape(CAUSAL_B * CAUSAL_H, CAUSAL_T,
                                             CAUSAL_D).contiguous()

        mask = torch.ones((CAUSAL_B, CAUSAL_T), dtype=torch.int32,
                          device=dev)
        got = pack(out)
        want, _ = fa._flash_fwd_torch(pack(q), pack(k), pack(v), mask,
                                      CAUSAL_D ** -0.5, True, CAUSAL_H)
        _flash_compare(got, want, dtype, "make_attn_fn('flash')")
        entries[str(dtype).split(".")[-1]] = _flash_entry(
            pack(q), pack(k), pack(v), mask, CAUSAL_H, True, dtype)
        del q, k, v, out, got, want
    # one LM training step with the causal kernel against 'full' (f32)
    cfg = dict(vocab=256, d_model=CAUSAL_H * CAUSAL_D, n_heads=CAUSAL_H,
               n_layers=2)
    losses = {}
    for attn in ("flash", "full"):
        ctx = ps.init(backend="cuda")
        params = lm.init_params(np.random.default_rng(0), **cfg,
                                max_len=CAUSAL_T + 1)
        store = ps.KVStore(optimizer="adam", learning_rate=LM_LR,
                           placement="sharded")
        store.init(params)
        run = store.make_step(lm.make_loss_fn(
            n_heads=CAUSAL_H, attn_fn=lm.make_attn_fn(attn)))
        batch = next(lm.lm_batches(CAUSAL_B, CAUSAL_T, vocab=cfg["vocab"],
                                   seed=0))
        placed = store.shard_batch(batch)
        fa.LAUNCHES = 0
        loss, _ = run(placed)
        losses[attn] = (float(loss), fa.LAUNCHES)
        ps.shutdown()
        del ctx, store, run, params
        torch.cuda.empty_cache()
    if losses["flash"][1] != cfg["n_layers"] or losses["full"][1] != 0:
        raise AssertionError(f"LM step flash launches {losses}")
    rel = abs(losses["flash"][0] - losses["full"][0]) / abs(
        losses["full"][0])
    if rel > FLASH_TOL[torch.float32]:
        raise AssertionError(f"LM step flash vs full: {losses} (relative "
                             f"{rel:.3g})")
    for name, e in entries.items():
        log(f"phase 18 (c): causal flash through lm.make_attn_fn('flash'), "
            f"{name} [{CAUSAL_B * CAUSAL_H}, {CAUSAL_T}, {CAUSAL_D}] (d_model "
            f"{CAUSAL_H * CAUSAL_D}, {CAUSAL_H} heads): kernel vs plain max "
            f"abs err {e['max_abs_err']:.3g}; kernel {e['ms']:.5f} ms, "
            f"scaled_dot_product_attention(is_causal=True) "
            f"{e['library_ms']:.5f} ms, plain {e['plain_ms']:.3f} ms, bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']}); card {card}")
    log(f"phase 18 (c): one LM training step (d_model "
        f"{cfg['d_model']}, {CAUSAL_H} heads, 2 layers, seq {CAUSAL_T}, "
        f"batch {CAUSAL_B}, f32) with attn='flash': {losses['flash'][1]} "
        f"launches, loss {losses['flash'][0]:.6f} vs 'full' "
        f"{losses['full'][0]:.6f} (relative {rel:.3g}, gate "
        f"{FLASH_TOL[torch.float32]})")
    return entries, losses["flash"][1]


def _axes_lm(tmp, card):
    """Phase 18 (b): the LM's two-rank runs and the trainer against one
    process's 'full'."""
    import ps_tpu_torch as ps

    ps.init(backend="cuda")
    store, loss_fn = _lm_store(ps.current_context().mesh, "full", 0)
    one, one_ms = _lm_losses(store, loss_fn, ps.current_context().mesh)
    ps.shutdown()
    del store
    _run_pair("--axes-lm-worker",
              ",".join(map(str, _distinct_ports(len(LM_RUNS)))), tmp)
    ranks = [torch.load(os.path.join(tmp, f"axes_lm{r}.pt"),
                        weights_only=False) for r in range(2)]
    worst = {}
    for name, (shape, attn, micro) in LM_RUNS.items():
        for r in ranks:
            np.testing.assert_allclose(r[name]["losses"], one, rtol=LM_TOL,
                                       atol=LM_TOL, err_msg=name)
        worst[name] = max(abs(a - b) / abs(b) for a, b in
                          zip(ranks[0][name]["losses"], one))
        want = {"ring": ("ppermute", "seq"), "ulysses": ("all_to_all", "seq"),
                "pipe": ("broadcast", "pipe")}[name]
        if want not in ranks[0][name]["ops"]:
            raise AssertionError(f"LM {name}: ran {ranks[0][name]['ops']}")
    # the trainer as a user runs it, two processes, the ring mesh
    port = _free_port()
    env = {"PS_COORDINATOR_URI": f"127.0.0.1:{port}", "PS_NUM_PROCESSES": "2",
           "PS_PROCESS_ID": "{rank}", "PS_DIST_BACKEND": "gloo"}
    logs = _run_pair("ps_tpu_torch.examples.train_longctx_lm", port, tmp,
                     env, ["--mesh", "data=1,seq=2", "--attn", "ring",
                           "--steps", str(LM_STEPS), "--device", "cuda:0"])
    finals = [float(next(line for line in l.splitlines()
                         if line.startswith("done:")).split()[-1])
              for l in logs]
    for final in finals:
        if abs(final - one[-1]) > LM_TOL * abs(one[-1]) + 5e-7:
            raise AssertionError(f"train_longctx_lm final losses {finals} vs "
                                 f"one process {one[-1]}")
    log(f"phase 18 (b): the LM at the reference trainer's defaults (vocab "
        f"{LM_CFG['vocab']}, d_model {LM_CFG['d_model']}, "
        f"{LM_CFG['n_heads']} heads, {LM_CFG['n_layers']} layers, seq "
        f"{LM_SEQ}, batch {LM_BATCH}, adam {LM_LR}, 'sharded'), {LM_STEPS} "
        f"steps on the card: one process 'full' losses "
        f"{[round(x, 6) for x in one]}; two ranks over gloo, worst relative "
        + ", ".join(f"{n} ({LM_RUNS[n][0]}, {LM_RUNS[n][1]}"
                    + (f", {LM_RUNS[n][2]} microbatches" if LM_RUNS[n][2]
                       else "") + f") {worst[n]:.3g}" for n in LM_RUNS)
        + f" (gate {LM_TOL}); python -m ps_tpu_torch.examples."
        f"train_longctx_lm --mesh data=1,seq=2 --attn ring on two processes: "
        f"final losses {finals} vs {one[-1]:.6f}; step ms a rank "
        + ", ".join(f"{n} {[round(t, 1) for t in ranks[0][n]['step_ms']]}"
                    for n in LM_RUNS)
        + f", one process {[round(t * 1e3, 1) for t in one_ms]} (through "
        f"host memory: not a speed figure); card {card}")


def phase_axes(tmp):
    """18: the 'model', 'seq' and 'pipe' axes on the card; returns the
    flash kernel's readings for the kernels line."""
    card = _card_line()
    t0 = time.perf_counter()
    a = _axes_bert(tmp, card)
    b, s, h, d = BERT_BATCH, BERT_SEQ, 12 // AXES_TP, 64
    q, k, v, mask = _flash_case(b, s, h, d, torch.bfloat16, "ones", seed=181)
    rank_entry = _flash_entry(q, k, v, mask, h, False, torch.bfloat16)
    del q, k, v, mask
    log(f"phase 18 (a): the flash kernel at a tensor-parallel rank's shape "
        f"[{b * h}, {s}, {d}] bf16 (6 of 12 heads): kernel vs plain max abs "
        f"err {rank_entry['max_abs_err']:.3g} (tol "
        f"{FLASH_TOL[torch.bfloat16]}), kernel {rank_entry['ms']:.5f} ms, "
        f"scaled_dot_product_attention {rank_entry['library_ms']:.5f} ms, "
        f"plain {rank_entry['plain_ms']:.3f} ms, bound "
        f"{rank_entry['bound_ms']:.5f} ms ({rank_entry['bound_by']}); card "
        f"{card}")
    _axes_lm(tmp, card)
    causal, lm_launches = _axes_causal_flash(card)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    rank_entry["launches_per_rank"] = a["launches"]
    for e in causal.values():
        e["launches_lm_step"] = lm_launches
    return {"tp_rank": rank_entry, "causal_lm": causal}


# phase 19: the van's transport options on the card. (a) phase 17 (a)'s
# sparse PS with the servers on the native loop, once with every worker
# over TCP (every frame decoded, staged and freed by the loop's pump, the
# flat pushes classified by native admission) and once with every worker
# over the shm lane (each connection detached to a serve thread); (b) the
# servers on the loop, workers 0-1 over TCP and worker 2 over the rings,
# their row grads int8- (seeded by the worker id) and then
# cast16-compressed above compress_min_bytes' 64 KiB default; (c) phase
# 16 (a)'s config 5 with the server on the native loop in this process,
# bucketed as phase 16 (c): workers 0 (topk) and 2 (cast16 pushes and
# pulls) over TCP through the loop, worker 1 (topk) over the rings; (d)
# times, printed and not held
TRANSPORT_CODECS = ("int8", "cast16")
TRANSPORT_WORKER_CODECS = ("topk", "topk", "cast16")
TRANSPORT_WORKER_SHM = (False, True, False)  # (c): worker 1 on the rings
TRANSPORT_BUCKET_BYTES = 4 << 20  # (d): the 0.44 GB tree's buckets
TRANSPORT_CYCLES = 16  # (a)-(b): a worker's cycles (phase 17: 60)


def _sparse_ps_spawn(harness, out, server_opts, worker_opts, cycles):
    """Phase 17 (a)'s processes, ``cycles`` a worker, with the given
    transport options (``worker_opts``: one dict a worker)."""
    os.makedirs(out)
    procs = [harness.spawn("sparse-server", out, SPARSE_WORKERS,
                           cycles, s, SPARSE_SHARDS, "cuda", "wd",
                           json.dumps(server_opts))
             for s in range(SPARSE_SHARDS)]
    procs += [harness.spawn("sparse-worker", f"@{SPARSE_SHARDS}", out, w,
                            cycles, "cuda", "wd", SPARSE_WORKERS, 1,
                            json.dumps(worker_opts[w]))
              for w in range(SPARSE_WORKERS)]
    return procs
def _sparse_ps_read(harness, out, procs, what):
    """Wait for a run's processes and read their dumps: (infos, finals,
    records, pulls)."""
    outs = harness.finish(procs, SPARSE_TIMEOUT_S, fail_fast=True)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: {' '.join(p.args[-10:])} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")
    infos = [json.load(open(os.path.join(out, f"sparse_server{s}.json")))
             for s in range(SPARSE_SHARDS)]
    finals = [dict(np.load(os.path.join(out, f"sparse_tables{s}.npz")))
              for s in range(SPARSE_SHARDS)]
    records = [json.load(open(os.path.join(out, f"sparse_worker{w}.json")))
               for w in range(SPARSE_WORKERS)]
    pulls = {w: (dict(np.load(os.path.join(out, f"sparse_pulls{w}.npz"))),
                 records[w]) for w in range(SPARSE_WORKERS)}
    return infos, finals, records, pulls


def _sparse_ps_launches(harness, infos, what, cycles):
    """Each shard applied its expected pushes (``cycles`` a worker) on the
    kernels' tier, each
    push 2 grouping (cluster path) + 2 apply launches; the launches by
    kernel over the shards."""
    launches = {"sparse_apply/deep": 0, "sparse_apply/wide": 0,
                "sparse_group": 0}
    for s, info in enumerate(infos):
        n = len(info["apply_log"])
        want = harness.expected_pushes("wd", s, SPARSE_SHARDS,
                                       SPARSE_WORKERS, cycles)
        if n != want or info["tiers"] != {"deep": "cuda", "wide": "cuda"}:
            raise AssertionError(f"{what}: shard {s} applied {n} of {want} "
                                 f"pushes, tiers {info['tiers']}")
        got = info["launches"]
        if (got["apply"], got["group"], got["by_rule"]) != (
                2 * n, 2 * n, {"adagrad": n, "sgd": n}):
            raise AssertionError(f"{what}: shard {s} launched {got} for {n} "
                                 f"pushes: expected 2 grouping (cluster "
                                 f"path) + 2 apply a push")
        launches["sparse_apply/deep"] += got["by_rule"]["adagrad"]
        launches["sparse_apply/wide"] += got["by_rule"]["sgd"]
        launches["sparse_group"] += got["group"]
    return launches


def _sparse_ps_replay_on_card(harness, infos, finals, pulls, what, cycles,
                              compress=None):
    """The apply logs replayed through the port's tables on the card (each
    worker's grads through its codec): the servers' tables and state
    bitwise, and every pulled row set the replay's at its versions.
    Returns the row sets held."""
    import ps_tpu_torch as ps

    ps.init(backend="cuda")
    try:
        tables, checked = harness.sparse_replay(
            infos, "wd", SPARSE_WORKERS, cycles, pulls=pulls,
            compress=compress)
        for s, final in enumerate(finals):
            for name, emb in tables[s].items():
                leaves = [emb.table] + _emb_leaves(emb)
                saved = [final[name]] + [final[f"{name}/state{i}"]
                                         for i in range(len(leaves) - 1)]
                if not all(np.array_equal(x.cpu().numpy(), y)
                           for x, y in zip(leaves, saved)):
                    raise AssertionError(f"{what}: shard {s} {name} "
                                         f"replayed on the card is not "
                                         f"bitwise the server's")
    finally:
        ps.shutdown()
    return checked


def _lanes_in_use(harness, infos, records, opts, what, cycles):
    """No fallback hid a path: the servers served on the native loop,
    which dispatched exactly the TCP workers' pushes (native admission
    classified their flat ones, some fresh); each ring worker's frames
    rode the rings, none spilled to TCP."""
    harness.check_loop_carried(infos, opts, "wd", cycles, what)
    rings = any(o.get("shm") for o in opts)
    for s, info in enumerate(infos):
        if rings and not (info["shm_frames"] > 0
                          and info["shm_spills"] == 0):
            raise AssertionError(f"{what}: server {s} {info['shm_frames']} "
                                 f"shm frames, {info['shm_spills']} spilled")
    for w, (r, o) in enumerate(zip(records, opts)):
        if (r["lane"] != ("shm" if o.get("shm") else "tcp")
                or (o.get("shm") and r["shm_frames"] == 0)
                or r["shm_spills"]):
            raise AssertionError(f"{what}: worker {w} lane {r['lane']}, "
                                 f"{r['shm_frames']} shm frames, "
                                 f"{r['shm_spills']} spilled")


def _transport_sparse(harness, tmp, card):
    """(a) and (b): returns the launches by kernel, (a)'s numbers on the
    loop over TCP and over the rings, and the bytes each run's workers
    pushed."""
    launches, pushed, numbers = {}, {}, {}
    tcp = [{"shm": False}] * SPARSE_WORKERS
    rings = [{"shm": True}] * SPARSE_WORKERS
    mixed = [{"shm": w == SPARSE_WORKERS - 1} for w in range(SPARSE_WORKERS)]
    runs = [("a-loop", tcp, None), ("a-rings", rings, None),
            *[(f"b-{c}", mixed, {"codec": c}) for c in TRANSPORT_CODECS]]
    started = {}
    # each (a) run alone, so that its times are not shared
    for batch in (runs[:1], runs[1:2], runs[2:]):
        for name, lanes, codec in batch:
            out = os.path.join(tmp, name)
            opts = [dict(o, compress=codec) for o in lanes]
            started[name] = (out, opts, _sparse_ps_spawn(
                harness, out, {"native_loop": True}, opts, TRANSPORT_CYCLES))
        for name, lanes, codec in batch:
            out, opts, procs = started[name]
            what = f"transport ({name})"
            t0 = time.perf_counter()
            infos, finals, records, pulls = _sparse_ps_read(harness, out,
                                                            procs, what)
            _lanes_in_use(harness, infos, records, opts, what,
                          TRANSPORT_CYCLES)
            got = _sparse_ps_launches(harness, infos, what, TRANSPORT_CYCLES)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            specs = ({w: r["compress"] for w, r in enumerate(records)}
                     if codec else None)
            checked = _sparse_ps_replay_on_card(harness, infos, finals,
                                                pulls, what, TRANSPORT_CYCLES,
                                                specs)
            pushed[name] = sum(r["bytes"][0] for r in records)
            keys = records[0]["encoded_keys"]
            if codec:
                ratio = sum(r["codec_bytes"][0] for r in records) / sum(
                    r["codec_bytes"][1] for r in records)
                if (keys["deep/grads"][0] == 0 or keys["wide/grads"][0]
                        or keys["deep/ids"][0]):
                    raise AssertionError(f"{what}: encoded keys {keys}")
            else:
                numbers[name] = _sparse_numbers(infos, records)
            lanes_said = ", ".join(
                f"worker {w} over {'the rings' if o['shm'] else 'TCP'}"
                for w, o in enumerate(opts))
            log(f"{what}: {SPARSE_SHARDS} serve_sparse processes on the "
                f"native loop, {SPARSE_WORKERS} connect_sparse processes "
                f"({lanes_said}) x {TRANSPORT_CYCLES} cycles at W&D's width"
                + (f", row grads {codec['codec']}" if codec else "")
                + f": applies {[len(i['apply_log']) for i in infos]}, each "
                f"2 grouping + 2 apply launches; the loop's pump dispatched "
                f"{[i['loop_pushes'] for i in infos]} pushes, exactly the "
                f"TCP workers'; native admission acks "
                f"{[i['admit']['acks'] for i in infos]}, fresh stamps "
                f"{[i['admit']['fresh'] for i in infos]}, punts "
                f"{[i['admit']['punts'] for i in infos]}; replayed on the "
                f"card bitwise the servers' tables and state, {checked} "
                f"pulled row sets bitwise the replay's; shm frames servers "
                f"{[i['shm_frames'] for i in infos]}, workers "
                f"{[r['shm_frames'] for r in records]}, none spilled; "
                f"checks {time.perf_counter() - t0:.1f} s")
            if codec:
                log(f"{what}: bytes pushed {pushed[name]:,} against "
                    f"(a)'s raw {pushed['a-loop']:,} "
                    f"({pushed[name] / pushed['a-loop']:.3f}x); "
                    f"codec ratio {ratio:.3f}x over what it encoded; "
                    f"encoded under compress_min_bytes 65,536 (encoded, "
                    f"raw, largest bytes) by worker 0: " + ", ".join(
                        f"{k} {v}" for k, v in sorted(keys.items())))
    return launches, numbers, pushed


def _transport_config5(harness, tmp):
    """(c): returns the worker records (for (d)) and what the loop and the
    native replay-ack probe saw."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService
    from ps_tpu_torch.control import tensor_van as tv
    from ps_tpu_torch.examples.train_mnist_async import build

    out = os.path.join(tmp, "c")
    os.makedirs(out)
    ps.init(backend="cuda", mode="async", num_workers=ASYNC_WORKERS,
            dc_lambda=0.04)
    params, _ = build(0, "cuda")
    store = ps.KVStore(optimizer="sgd", learning_rate=0.1, mode="async")
    store.init(params)
    svc = AsyncPSService(store, native_loop=True, record_full_history=True)
    procs = []
    try:
        if not svc.native_loop:
            raise AssertionError("transport (c): the server fell back to "
                                 "thread per connection")
        for w, codec in enumerate(TRANSPORT_WORKER_CODECS):
            env = {"PS_SHM": "1" if TRANSPORT_WORKER_SHM[w] else "0"}
            if codec == "cast16":
                env["PS_COMPRESS_PULL"] = "1"
            procs.append(_spawn_trainer(
                "--role", "worker", "--server", f"127.0.0.1:{svc.port}",
                "--worker-id", w, "--steps", ASYNC_CYCLES, "--dump", out,
                "--bucket-bytes", VAN_BUCKET_BYTES, "--pool", VAN_POOL,
                "--compress", codec, env_extra=env))
        outs = []
        deadline = time.monotonic() + VAN_TIMEOUT_S
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"transport (c): {' '.join(p.args[3:9])}"
                                     f" exited {p.returncode}:\n{o[-3000:]}")
        if not svc.wait_for_goodbyes(ASYNC_WORKERS, timeout=30):
            raise AssertionError("transport (c): a worker never said goodbye")
        records = [json.load(open(os.path.join(out, f"worker{w}.json")))
                   for w in range(ASYNC_WORKERS)]
        # a replay of worker 0's last push, its own (nonce, seq): acked
        # inside the loop, the version and the event log unmoved
        nonce, seq = next(iter(svc._applied_pseq[0].values()))
        version, events = svc._engine.version, len(svc.event_log)
        before = svc.admit_stats()
        with tv.Channel.connect("127.0.0.1", svc.port) as ch:
            zeros = {k: np.zeros(tuple(v.shape), np.float32)
                     for k, v in svc._engine._params.items()}
            kind, _, _, extra = tv.decode(ch.request(tv.encode(
                tv.PUSH, 0, zeros, extra={"pseq": seq, "pnonce": nonce})))
        # the loop counts an ack just after writing its bytes
        deadline = time.monotonic() + 5
        while (svc.admit_stats()["acks"] < before["acks"] + 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        after = svc.admit_stats()
        if (kind != tv.OK or not extra.get("dedup")
                or after["acks"] != before["acks"] + 1
                or svc._engine.version != version
                or len(svc.event_log) != events):
            raise AssertionError(f"transport (c): the replayed push was not "
                                 f"acked natively: {kind} {extra}, acks "
                                 f"{before['acks']} -> {after['acks']}, "
                                 f"version {version} -> "
                                 f"{svc._engine.version}")
        total = ASYNC_WORKERS * ASYNC_CYCLES
        # every push of a TCP worker reached the loop's pump as at least
        # one bucket frame (the ring worker's are served by its thread)
        loop_pushes = svc.transport.loop_pushes
        tcp_pushes = ASYNC_CYCLES * TRANSPORT_WORKER_SHM.count(False)
        if version != total or svc.transport.shm_frames == 0 \
                or svc.transport.shm_spill_frames \
                or loop_pushes < tcp_pushes:
            raise AssertionError(f"transport (c): version {version} of "
                                 f"{total}; shm frames "
                                 f"{svc.transport.shm_frames}, spilled "
                                 f"{svc.transport.shm_spill_frames}; the "
                                 f"loop dispatched {loop_pushes} push "
                                 f"frames for {tcp_pushes} TCP pushes")
        for w, r in enumerate(records):
            lane = "shm" if TRANSPORT_WORKER_SHM[w] else "tcp"
            if r["lane"] != lane or r["shm_spills"] or \
                    r["summary"].get("compress_ratio", 0) <= 1.0:
                raise AssertionError(f"transport (c): worker {w} lane "
                                     f"{r['lane']}, summary {r['summary']}")
            if not np.all(np.isfinite(r["losses"])):
                raise AssertionError(f"transport (c): worker {w} loss")
        final = {k: v.detach().clone() for k, v in
                 svc._engine._params.items()}
        log_ = list(svc.event_log)
        codec_bytes = (svc.transport.codec_raw_bytes,
                       svc.transport.codec_enc_bytes)
    finally:
        _stop_all(procs)
        svc.stop()
        ps.shutdown()
    replayed = harness.replay([log_], ASYNC_WORKERS, "cuda", compress={
        w: r["compress"] for w, r in enumerate(records)})
    for k, v in final.items():
        if not torch.equal(replayed[k], v):
            raise AssertionError(f"transport (c): {k} replayed on the card "
                                 f"is not bitwise the server's")
    return records, {"acks": after["acks"], "fresh": after["fresh"],
                     "punts": after["punts"], "codec_bytes": codec_bytes,
                     "loop_pushes": loop_pushes, "tcp_pushes": tcp_pushes}


def _transport_bert_like():
    """(d): the 442,939,392-byte tree between a server on the native loop
    and a worker of this process, bucketed (4 MiB buckets, pool 2), over
    TCP and over the shm lane: pull and push_pull GB/s, ring frames and
    spills."""
    import ps_tpu_torch as ps

    ps.init(backend="cuda", mode="async", num_workers=2)
    tree, nbytes = _bert_like_tree(BERT_LIKE_MB)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    store.init(tree)
    svc = ps.serve_async(store, native_loop=True)
    grads = {k: torch.full_like(v, 1e-3) for k, v in tree.items()}
    out = {"tree_bytes": nbytes}
    try:
        for w, lane in enumerate(("tcp", "shm")):
            wk = ps.connect_async(f"127.0.0.1:{svc.port}", w, tree,
                                  bucket_bytes=TRANSPORT_BUCKET_BYTES,
                                  pool_size=2, shm=lane == "shm")
            wk.pull_all()  # warm-up: pinned buffers, the allocators
            t0 = time.perf_counter()
            for _ in range(BERT_LIKE_CYCLES):
                wk.pull_all()
            pull = BERT_LIKE_CYCLES * nbytes / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(BERT_LIKE_CYCLES):
                wk.push_pull(grads)
            pp = 2 * BERT_LIKE_CYCLES * nbytes / (time.perf_counter() - t0)
            out[lane] = {"pull_gbps": pull / 1e9, "push_pull_gbps": pp / 1e9,
                         "frames": wk.transport.shm_frames,
                         "spills": wk.transport.shm_spill_frames}
            wk.close()
        if out["shm"]["frames"] == 0 or out["shm"]["spills"]:
            raise AssertionError(f"transport (d): the shm lane carried "
                                 f"{out['shm']['frames']} frames, spilled "
                                 f"{out['shm']['spills']}")
    finally:
        svc.stop()
        ps.shutdown()
    return out


def phase_transport(tmp, tcp_sparse=None, tcp_config5=None):
    """19: the van's transport options on the card. ``tcp_sparse`` and
    ``tcp_config5`` are phases 17 (f)'s and 16 (e)'s numbers (thread per
    connection over TCP, raw) from the same run; alone, phase 19 runs
    phase 17 (a) over TCP itself for its comparison."""
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t_phase = time.perf_counter()
    if tcp_sparse is None:
        out = os.path.join(tmp, "tcp")
        procs = _sparse_ps_spawn(harness, out, {}, [{}] * SPARSE_WORKERS,
                                 TRANSPORT_CYCLES)
        infos, _, records, _ = _sparse_ps_read(harness, out, procs,
                                               "transport (TCP)")
        tcp_sparse = _sparse_numbers(infos, records)
    launches, sparse, pushed = _transport_sparse(harness, tmp, card)
    records, probe = _transport_config5(harness, tmp)
    lanes_said = ", ".join(
        f"worker {w} ({c}) over {'the rings' if shm else 'TCP'}"
        for w, (c, shm) in enumerate(zip(TRANSPORT_WORKER_CODECS,
                                         TRANSPORT_WORKER_SHM)))
    log(f"transport (c): config 5, the server on the native loop in this "
        f"process, {ASYNC_WORKERS} worker processes ({lanes_said}; the "
        f"cast16 worker's pulls cast16 too) x {ASYNC_CYCLES} cycles, "
        f"bucketed ({VAN_BUCKET_BYTES} B, pool {VAN_POOL}): the loop's pump "
        f"dispatched {probe['loop_pushes']} bucket push frames for the "
        f"TCP workers' {probe['tcp_pushes']} pushes; the event log "
        f"replayed on the card with every codec is bitwise the server's "
        f"params; a replayed push of worker 0 was acked natively (acks "
        f"{probe['acks']}, fresh stamps {probe['fresh']}, punts "
        f"{probe['punts']}), the version unmoved; the server decoded "
        f"{probe['codec_bytes'][1]:,} wire bytes into "
        f"{probe['codec_bytes'][0]:,}; compression "
        f"{[round(r['summary']['compress_ratio'], 3) for r in records]}")
    import types

    c5 = _van_mnist_numbers(types.SimpleNamespace(records=records))
    bert = _transport_bert_like()
    tcp = tcp_sparse
    for name, said in (("a-loop", "on the native loop over TCP"),
                       ("a-rings", "over the rings (each connection "
                                   "detached from the loop to a thread)")):
        got = sparse[name]
        log(f"transport (d) sparse: {got['cycles_per_s']:.1f} cycles/s "
            f"{said} against {tcp['cycles_per_s']:.1f} thread per "
            f"connection over TCP; median pull {got['ops_ms']['pull']:.4f} "
            f"vs {tcp['ops_ms']['pull']:.4f} ms, push "
            f"{got['ops_ms']['push']:.4f} vs {tcp['ops_ms']['push']:.4f}, "
            f"push_pull {got['ops_ms']['push_pull']:.4f} vs "
            f"{tcp['ops_ms']['push_pull']:.4f} ms; card {card}")
    log(f"transport (d) config 5: {c5['cycles_per_s']:.1f} cycles/s with "
        f"every option (median cycle {c5['median_cycle_ms']:.4f} ms)"
        + (f" against {tcp_config5['cycles_per_s']:.1f} raw over TCP "
           f"thread per connection (median cycle "
           f"{tcp_config5['median_cycle_ms']:.4f} ms)" if tcp_config5
           else "") + f"; card {card}")
    log(f"transport (d) BERT-base-shaped tree ({bert['tree_bytes']:,} "
        f"bytes f32, bucketed {TRANSPORT_BUCKET_BYTES} B, pool 2, server on "
        f"the native loop): pull {bert['shm']['pull_gbps']:.3f} GB/s over "
        f"the shm lane (its connection's thread) against "
        f"{bert['tcp']['pull_gbps']:.3f} over TCP through the loop, "
        f"push_pull {bert['shm']['push_pull_gbps']:.3f} against "
        f"{bert['tcp']['push_pull_gbps']:.3f}; {bert['shm']['frames']} ring "
        f"frames, {bert['shm']['spills']} spilled; card {card}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "sparse": sparse, "tcp_sparse": tcp_sparse,
            "config5": c5, "bert_like": bert, "pushed": pushed}


# phase 20: replication and live failover on the card (replica/, item 5.6).
# (a) phase 17 (a)'s sparse PS with each shard a primary process and a
# backup=True process, attached with sync ack, the workers dialling the
# replica sets; (b) config 5 through the trainer's replication flags; (c)
# (a) with async ack and a window of REPL_WINDOW; (d) times, printed
REPL_CYCLES = 24            # (a), (c): a worker's cycles (phase 17: 60)
REPL_PAUSE_AT = 12          # (a): cycles before the pause, the checks, the kill
REPL_WATCH_MS = 1000        # the backups' death horizon (PromotionWatch)
REPL_WINDOW = 8             # (c): the async ack window
REPL_CONFIG5_STEPS, REPL_CONFIG5_KILL = 60, 30  # (b)


class _Lines:
    """A process's output read line by line on a thread of its own (its
    pipe never fills), with :meth:`wait_for` a line that matches."""

    def __init__(self, proc):
        import threading

        self.proc, self.lines = proc, []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def wait_for(self, pattern, timeout=VAN_TIMEOUT_S):
        import re

        deadline = time.monotonic() + timeout
        seen = 0
        while time.monotonic() < deadline:
            for line in self.lines[seen:]:
                if re.search(pattern, line):
                    return line
            seen = len(self.lines)
            if self.proc.poll() is not None and not self._t.is_alive():
                break
            time.sleep(0.002)
        raise AssertionError(f"{' '.join(self.proc.args[3:9])}: no line "
                             f"{pattern!r} (exit {self.proc.poll()}):\n"
                             f"{self.text()[-3000:]}")

    def finish(self, timeout=VAN_TIMEOUT_S):
        self.proc.wait(timeout=timeout)
        self._t.join(timeout=30)
        return self.text()

    def text(self):
        return "".join(self.lines)


def _wait_files(paths, procs, timeout=SPARSE_TIMEOUT_S):
    """Until every path exists; raises at once if a process died."""
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        for p in procs:
            if p.poll() not in (None, 0):
                out = p.communicate()[0] if p.stdout else ""
                raise AssertionError(f"{' '.join(p.args[-10:])} exited "
                                     f"{p.returncode}:\n{out[-3000:]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"never appeared: {paths}")
        time.sleep(0.005)


def _repl_spawn(harness, out, ack, window, worker_opts, loop=False):
    """Phase 17 (a)'s processes, each shard a primary and a backup: the
    backups first (each with its PromotionWatch), the primaries attach
    them and beat their watches, the workers dial the replica sets. With
    ``loop`` every server serves on the native loop and worker 0 dials
    over the rings (the others over TCP)."""
    os.makedirs(out)
    watch = [harness.free_port(harness.socket.SOCK_DGRAM)
             for _ in range(SPARSE_SHARDS)]
    spawn = lambda s, opts: harness.spawn(  # noqa: E731
        "sparse-server", out, SPARSE_WORKERS, REPL_CYCLES, s,
        SPARSE_SHARDS, "cuda", "wd",
        json.dumps(dict(opts, native_loop=loop, digests=True)))
    backups = [spawn(s, {"backup": True, "watch_port": watch[s],
                         "watch_timeout_ms": REPL_WATCH_MS})
               for s in range(SPARSE_SHARDS)]
    primaries = [spawn(s, {"replicate": True, "ack": ack, "window": window,
                           "watch_port": watch[s]})
                 for s in range(SPARSE_SHARDS)]
    workers = [harness.spawn("sparse-worker", f"@{SPARSE_SHARDS}", out, w,
                             REPL_CYCLES, "cuda", "wd",
                             SPARSE_WORKERS, 0,
                             json.dumps(dict(worker_opts, replicas=True,
                                             shm=loop and w == 0)))
               for w in range(SPARSE_WORKERS)]
    return backups, primaries, workers


def _repl_finish(harness, out, procs, killed, what):
    """Wait for the workers and the live servers; release the backups that
    were never promoted; read the dumps: (servers {name: info}, worker
    records)."""
    import signal

    backups, primaries, workers = procs
    alive = [p for p in primaries if p not in killed]
    outs = harness.finish(workers, SPARSE_TIMEOUT_S, fail_fast=True)
    for p, o in zip(workers, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: worker exited {p.returncode}:\n"
                                 f"{o[-3000:]}")
    with open(os.path.join(out, "done"), "w") as f:
        f.write("1")
    outs = harness.finish(alive + backups, SPARSE_TIMEOUT_S)
    for p, o in zip(alive + backups, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: {' '.join(p.args[-8:])} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")
    for p in killed:
        if p.returncode != -signal.SIGKILL:
            raise AssertionError(f"{what}: the killed primary exited "
                                 f"{p.returncode}")
    infos = {}
    for s in range(SPARSE_SHARDS):
        for tag in ("", "b"):
            path = os.path.join(out, f"sparse_server{s}{tag}.json")
            if os.path.exists(path):
                infos[f"{s}{tag}"] = json.load(open(path))
    records = [json.load(open(os.path.join(out, f"sparse_worker{w}.json")))
               for w in range(SPARSE_WORKERS)]
    return infos, records


def _repl_replay_digests(harness, infos, by_cycle=False):
    """The dumps' logs replayed through the port's tables on the card
    (``ps_tpu_torch.init`` made by the caller): each shard's digests."""
    tables, _ = harness.sparse_replay(infos, "wd", SPARSE_WORKERS,
                                      REPL_CYCLES, by_cycle=by_cycle)
    return [harness.table_digests(t) for t in tables], tables


def _repl_launch_check(snap, what):
    """A backup launched 2 grouping (cluster path) + 2 apply kernels for
    each replicated push, one of each rule."""
    n = snap["applies"]
    got = snap["launches"]
    if n == 0 or (got["apply"], got["group"], got["by_rule"]) != (
            2 * n, 2 * n, {"adagrad": n, "sgd": n}):
        raise AssertionError(f"{what}: a backup launched {got} for {n} "
                             f"replicated pushes")


def _repl_window_numbers(records, last_cycle, before=None):
    """Cycles/s, the median cycle and the median push over each worker's
    cycles 1..last_cycle-1 (or those that ended before ``before`` on the
    host's monotonic clock), over one shared window (phase 17 (f)'s
    method)."""
    cycles, pushes, start, end = [], [], None, None
    for r in records:
        for c in range(1, last_cycle):
            t0, dt = r["starts"][c], r["cycle_s"][c]
            if before is not None and t0 + dt > before:
                break
            cycles.append(dt)
            start = t0 if start is None else min(start, t0)
            end = t0 + dt if end is None else max(end, t0 + dt)
        # even cycles pull then push: the push samples are in cycle order
        pushes += r["ops"]["push"][1:last_cycle // 2]
    return {"cycles_per_s": len(cycles) / (end - start),
            "cycles": len(cycles),
            "median_cycle_ms": float(np.median(cycles)) * 1e3,
            "push_ms": float(np.median(pushes)) * 1e3}


def _repl_pause_check(out, everyone, what):
    """At the workers' pause (``pause_at``): every server's snapshot; each
    backup's tables and row state bitwise its primary's, and its kernel
    launches those of the pushes it applied. Returns the snapshots."""
    _wait_files([os.path.join(out, f"paused{w}")
                 for w in range(SPARSE_WORKERS)], everyone)
    with open(os.path.join(out, "snap"), "w") as f:
        f.write("1")
    snaps = [f"snap{s}{tag}.json" for s in range(SPARSE_SHARDS)
             for tag in ("", "b")]
    _wait_files([os.path.join(out, x) for x in snaps], everyone)
    snap = {x[4:-5]: json.load(open(os.path.join(out, x))) for x in snaps}
    for s in range(SPARSE_SHARDS):
        p, b = snap[str(s)], snap[f"{s}b"]
        if (b["role"], p["role"]) != ("backup", "primary") or \
                p["digests"] != b["digests"] or \
                p["versions"] != b["versions"] or \
                p["applies"] != b["applies"] or p["applies"] == 0:
            raise AssertionError(
                f"{what}: after {REPL_PAUSE_AT} cycles shard {s}'s backup "
                f"is not its primary bitwise: {p} against {b}")
        _repl_launch_check(b, f"{what}: shard {s}")
    return snap


def _repl_sparse_sync(harness, tmp):
    """(a): sync ack; the pause, the bitwise and launch checks, the kill,
    the failover; the promoted backup's log replayed bitwise."""
    import signal

    import ps_tpu_torch as ps

    out = os.path.join(tmp, "a")
    procs = _repl_spawn(harness, out, "sync", 256,
                        {"pause_at": REPL_PAUSE_AT})
    backups, primaries, workers = procs
    everyone = backups + primaries + workers
    try:
        snap = _repl_pause_check(out, everyone, "repl (a)")
        t_kill = time.perf_counter()
        primaries[0].send_signal(signal.SIGKILL)
        primaries[0].wait(timeout=30)
        with open(os.path.join(out, "resume"), "w") as f:
            f.write("1")
        infos, records = _repl_finish(harness, out, procs, [primaries[0]],
                                      "repl (a)")
    finally:
        harness.kill_all(everyone)
    b0, p1, b1 = infos["0b"], infos["1"], infos["1b"]
    rep = b0["replica"]
    if (rep["role"], rep.get("promote_reason"), rep["epoch"]) != (
            "primary", "timeout", 1):
        raise AssertionError(f"repl (a): backup 0 did not promote on the "
                             f"timeout: {rep}")
    for s, info in ((0, b0), (1, p1)):
        seen = [tuple(x) for x in info["applied"]]
        if len(seen) != info["expected"] or len(set(seen)) != len(seen):
            raise AssertionError(
                f"repl (a): shard {s} applied {len(seen)} pushes "
                f"({len(seen) - len(set(seen))} twice), {info['expected']} "
                f"were sent")
    if b1["digests"] != p1["digests"]:
        raise AssertionError("repl (a): shard 1's backup differs from its "
                             "primary at the end")
    if any(r["failovers"] < 1 or r["epochs"][0] != 1 for r in records):
        raise AssertionError(f"repl (a): workers' failovers "
                             f"{[r['failovers'] for r in records]}, epochs "
                             f"{[r['epochs'] for r in records]}")
    ps.init(backend="cuda")
    try:
        digests, _ = _repl_replay_digests(harness, [b0, p1])
    finally:
        ps.shutdown()
    for s, (got, info) in enumerate(zip(digests, (b0, p1))):
        if got != info["digests"]:
            raise AssertionError(f"repl (a): shard {s}'s log replayed on the "
                                 f"card is not bitwise its tables")
    return {"snap": snap, "b0": b0, "p1": p1, "records": records,
            "t_kill": t_kill,
            "numbers": _repl_window_numbers(records, REPL_PAUSE_AT)}


def _repl_sparse_loop(harness, tmp):
    """(a) on the native loop, not killed: every server on the loop,
    worker 0 over the rings. At the pause each backup is bitwise its
    primary; at the end too, having applied the same pushes in the same
    order, and promoted on its primary's goodbye if at all, never on the
    timeout; each primary's pump dispatched exactly the TCP workers'
    pushes (a commit waiting for the sync ack on a thread of its own)."""
    out = os.path.join(tmp, "a-loop")
    procs = _repl_spawn(harness, out, "sync", 256,
                        {"pause_at": REPL_PAUSE_AT}, loop=True)
    everyone = sum(procs, [])
    try:
        snap = _repl_pause_check(out, everyone, "repl (a), loop")
        with open(os.path.join(out, "resume"), "w") as f:
            f.write("1")
        infos, records = _repl_finish(harness, out, procs, [],
                                      "repl (a), loop")
    finally:
        harness.kill_all(everyone)
    harness.check_loop_carried(
        [infos[str(s)] for s in range(SPARSE_SHARDS)],
        [{"shm": w == 0} for w in range(SPARSE_WORKERS)], "wd",
        REPL_CYCLES, "repl (a), loop")
    for s in range(SPARSE_SHARDS):
        p, b = infos[str(s)], infos[f"{s}b"]
        seen = [tuple(x) for x in p["applied"]]
        if not (b["native_loop"] and b["upcalls"] > 0
                and b["replica"].get("promote_reason") in (None, "goodbye")
                and p["digests"] == b["digests"]
                and p["applied"] == b["applied"]
                and len(seen) == len(set(seen)) == p["expected"]):
            raise AssertionError(
                f"repl (a), loop: shard {s}'s backup (on the loop "
                f"{b['native_loop']}, {b['upcalls']} upcalls, "
                f"{b['replica']}) is not its primary bitwise at the end, or "
                f"the pushes differ: "
                f"{len(p['applied'])} / {len(b['applied'])} applied of "
                f"{p['expected']}")
    if records[0]["shm_frames"] == 0 or any(
            r["shm_frames"] for r in records[1:]):
        raise AssertionError(f"repl (a), loop: ring frames "
                             f"{[r['shm_frames'] for r in records]}")
    return {"snap": snap, "infos": infos, "records": records,
            "numbers": _repl_window_numbers(records, REPL_PAUSE_AT)}


def _repl_sparse_async(harness, tmp):
    """(c): async ack, window REPL_WINDOW, the kill mid-traffic (when
    worker 0 finished cycle REPL_PAUSE_AT): the lag within the window, the
    run goes on, the promoted tables are a bitwise replay of what it
    applied, at most the window's pushes short of all of them."""
    import signal

    import ps_tpu_torch as ps

    out = os.path.join(tmp, "c")
    procs = _repl_spawn(harness, out, "async", REPL_WINDOW,
                        {"cue_at": REPL_PAUSE_AT})
    backups, primaries, workers = procs
    everyone = backups + primaries + workers
    try:
        _wait_files([os.path.join(out, "cue0")], everyone)
        t_kill = time.perf_counter()
        primaries[0].send_signal(signal.SIGKILL)
        primaries[0].wait(timeout=30)
        infos, records = _repl_finish(harness, out, procs, [primaries[0]],
                                      "repl (c)")
    finally:
        harness.kill_all(everyone)
    b0, p1, b1 = infos["0b"], infos["1"], infos["1b"]
    if (b0["replica"]["role"], b0["replica"].get("promote_reason")) != (
            "primary", "timeout"):
        raise AssertionError(f"repl (c): backup 0: {b0['replica']}")
    lag = p1["lag"]
    if not 0 <= lag["max"] <= REPL_WINDOW or lag["samples"] == 0:
        raise AssertionError(f"repl (c): shard 1's backup lagged "
                             f"{lag['max']} commits (window {REPL_WINDOW})")
    seen = [tuple(x) for x in b0["applied"]]
    lost = b0["expected"] - len(seen)
    if len(set(seen)) != len(seen) or not 0 <= lost <= REPL_WINDOW:
        raise AssertionError(f"repl (c): the promoted backup applied "
                             f"{len(seen)} pushes ({len(seen) - len(set(seen))}"
                             f" twice) of {b0['expected']}")
    if b1["digests"] != p1["digests"] or \
            len(p1["applied"]) != p1["expected"]:
        raise AssertionError("repl (c): shard 1's backup differs from its "
                             "primary at the end")
    # the unkilled replay: what the promoted backup applied, then the pushes
    # of the window it never received
    sent = {(w, c) for w in range(SPARSE_WORKERS)
            for c in range(REPL_CYCLES)
            if harness._routed("wd", w, c,
                               harness.sparse_ids("wd", w, c + 1)[c],
                               0, SPARSE_SHARDS)}
    missing = sorted(sent - set(seen))
    ps.init(backend="cuda")
    try:
        digests, tables = _repl_replay_digests(harness, [b0, p1],
                                               by_cycle=True)
        if digests[0] != b0["digests"] or digests[1] != p1["digests"]:
            raise AssertionError("repl (c): the logs replayed on the card "
                                 "are not bitwise the tables")
        full, _ = harness.sparse_replay(
            [dict(b0, applied=list(b0["applied"]) + [list(m)
                                                     for m in missing],
                  versions={n: v + len(missing)
                            for n, v in b0["versions"].items()}), p1],
            "wd", SPARSE_WORKERS, REPL_CYCLES, by_cycle=True)
        diff = max(float((tables[0][n].table - full[0][n].table).abs().max())
                   for n in tables[0])
    finally:
        ps.shutdown()
    return {"lag": lag, "lost": lost, "missing": missing, "diff": diff,
            "b0": b0, "p1": p1, "records": records, "t_kill": t_kill,
            "numbers": _repl_window_numbers(records, REPL_CYCLES,
                                            before=t_kill)}


def _repl_config5_run(harness, out, workers, kill, steps=REPL_CONFIG5_STEPS):
    """One config-5 topology through the trainer: a --backup server with a
    watch, a primary replicating to it (sync ack) and beating the watch,
    ``workers`` workers on the replica set. With ``kill`` the primary is
    SIGKILLed once worker 0 logged cycle REPL_CONFIG5_KILL. Returns the
    surviving server's record and params, the workers' records, and the
    kill time."""
    import signal

    os.makedirs(out)
    for d in ("primary", "backup"):
        os.makedirs(os.path.join(out, d))
    pp, pb = _distinct_ports(2)
    watch = harness.free_port(harness.socket.SOCK_DGRAM)
    env = {"PYTHONUNBUFFERED": "1"}
    common = ["--num-workers", workers]
    backup = _Lines(_spawn_trainer(
        "--role", "server", "--port", pb, "--backup", "--watch-port", watch,
        "--dump", os.path.join(out, "backup"), *common, env_extra=env))
    procs = [backup.proc]
    t_kill = None
    try:
        backup.wait_for("BACKUP on port")
        primary = _Lines(_spawn_trainer(
            "--role", "server", "--port", pp, "--replicate-to",
            f"127.0.0.1:{pb}", "--beat", f"127.0.0.1:{watch}",
            "--dump", os.path.join(out, "primary"), *common, env_extra=env))
        procs.append(primary.proc)
        primary.wait_for("replicating to")  # attached: workers may come
        uri = f"127.0.0.1:{pp}|127.0.0.1:{pb}"
        ws = [_Lines(_spawn_trainer(
            "--role", "worker", "--server", uri, "--worker-id", w,
            "--steps", steps, "--dump", out, env_extra=env))
            for w in range(workers)]
        procs += [w.proc for w in ws]
        if kill:
            ws[0].wait_for(rf"^step\s+{REPL_CONFIG5_KILL}\s")
            t_kill = time.perf_counter()
            primary.proc.send_signal(signal.SIGKILL)
            primary.proc.wait(timeout=30)
        for w in ws:
            text = w.finish()
            if w.proc.returncode != 0:
                raise AssertionError(f"repl (b): a worker exited "
                                     f"{w.proc.returncode}:\n{text[-3000:]}")
        if kill:
            # a worker that finished before the kill said its goodbye to
            # the dead primary (goodbyes are not replicated): say it again
            # to the promoted backup, which waits for every worker's
            from ps_tpu_torch.control import tensor_van as tv

            for w in range(workers):
                rec = json.load(open(os.path.join(out, f"worker{w}.json")))
                if rec["failovers"] == 0:
                    with tv.Channel.connect("127.0.0.1", pb) as ch:
                        ch.request(tv.encode(tv.SHUTDOWN, w, None))
        survivor = backup if kill else primary
        text = survivor.finish()
        if survivor.proc.returncode != 0:
            raise AssertionError(f"repl (b): the server exited "
                                 f"{survivor.proc.returncode}:\n"
                                 f"{text[-3000:]}")
        promoted = (backup.wait_for("now serving workers") if kill
                    else None)
    finally:
        _stop_all(procs)
    infos, final, records = _van_dumps(
        out, workers, server_out=os.path.join(out, "backup" if kill
                                              else "primary"))
    return {"info": infos[0], "final": final, "records": records,
            "t_kill": t_kill, "promoted": promoted}


def _repl_config5(harness, tmp):
    """(b): one worker killed at cycle 30 of 60 against an unkilled run,
    bitwise (losses, the final params); three workers, the promoted
    backup's event log replayed bitwise."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(_repl_config5_run, harness,
                            os.path.join(tmp, name), n, kill)
                for name, n, kill in (("b1", 1, False), ("b1k", 1, True),
                                      ("b3k", 3, True))]
        ref, drill, three = [r.result() for r in runs]
    for run in (drill, three):
        rep = run["info"]["replica"]
        if (rep["role"], rep.get("promote_reason"), rep["epoch"]) != (
                "primary", "timeout", 1):
            raise AssertionError(f"repl (b): the backup did not promote on "
                                 f"the timeout: {rep}")
    r0, d0 = ref["records"][0], drill["records"][0]
    # the one worker fails over; of three, a worker done before the kill
    # never meets the dead primary, but one at least does
    if d0["failovers"] < 1 or not any(r["failovers"] >= 1
                                      for r in three["records"]):
        raise AssertionError("repl (b): no worker of a killed run failed "
                             "over")
    if r0["losses"] != d0["losses"]:
        raise AssertionError("repl (b): the killed run's losses are not "
                             "bitwise the unkilled run's")
    for k, v in ref["final"].items():
        if not torch.equal(drill["final"][k], v):
            raise AssertionError(f"repl (b): {k} after the failover is not "
                                 f"bitwise the unkilled run's")
    if drill["info"]["version"] != REPL_CONFIG5_STEPS:
        raise AssertionError(f"repl (b): the promoted backup's version "
                             f"{drill['info']['version']}")
    checked = _van_replay_check([three["info"]], three["final"],
                                three["records"], 3, REPL_CONFIG5_STEPS,
                                "repl (b), 3 workers")
    return {"drill": drill, "three": three, "checked": checked}


def phase_replication(tmp, unreplicated=None):
    """20: replication and live failover on the card."""
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t_phase = time.perf_counter()
    a = _repl_sparse_sync(harness, tmp)
    t_a = time.perf_counter() - t_phase
    b0 = a["b0"]
    log(f"repl (a): {SPARSE_SHARDS} shards x (a serve_sparse primary + a "
        f"backup=True process, sync ack, W&D's deep [1,300,000, 16] adagrad "
        f"and wide [1,300,000, 1] sgd on the card), {SPARSE_WORKERS} "
        f"connect_sparse workers on the replica sets x {REPL_CYCLES} "
        f"cycles: after {REPL_PAUSE_AT} cycles each backup's tables and row "
        f"state bitwise its primary's (SHA-256), replicated pushes "
        f"{[a['snap'][f'{s}b']['applies'] for s in range(SPARSE_SHARDS)]}, "
        f"each 2 grouping + 2 apply launches in the backup's process; "
        f"primary 0 SIGKILLed: backup 0 promoted (reason "
        f"{b0['replica']['promote_reason']}, epoch {b0['replica']['epoch']}"
        f"), every worker finished ({[r['failovers'] for r in a['records']]}"
        f" failovers), each push applied once ({b0['expected']} / "
        f"{a['p1']['expected']}), the promoted log replayed on the card "
        f"bitwise its tables; {t_a:.1f} s")
    t0 = time.perf_counter()
    lp = _repl_sparse_loop(harness, tmp)
    t_loop = time.perf_counter() - t0
    pumped = [lp["infos"][str(s)]["loop_pushes"] for s in range(SPARSE_SHARDS)]
    log(f"repl (a), loop: (a) unkilled with every primary and backup on the "
        f"native loop and worker 0 over the rings: after {REPL_PAUSE_AT} "
        f"cycles each backup bitwise its primary, replicated pushes "
        f"{[lp['snap'][f'{s}b']['applies'] for s in range(SPARSE_SHARDS)]}, "
        f"2 + 2 launches each; at the end each backup bitwise its primary "
        f"and the same pushes in the same order; the pumps dispatched "
        f"{pumped} pushes, exactly the TCP workers'; "
        f"{lp['records'][0]['shm_frames']} ring frames; {t_loop:.1f} s")
    t_a += t_loop
    b = _repl_config5(harness, tmp)
    t_b = time.perf_counter() - t_phase - t_a
    ch = b["checked"]
    log(f"repl (b): config 5 through train_mnist_async.py --replicate-to/"
        f"--beat and --backup --watch-port (MLP hidden 32, batch 64, lr 0.1,"
        f" dc_lambda 0.04, sync ack): one worker, the primary SIGKILLed "
        f"after cycle {REPL_CONFIG5_KILL} of {REPL_CONFIG5_STEPS}: losses "
        f"and final params bitwise an unkilled run's "
        f"({b['drill']['promoted'].strip()}); three workers killed the same "
        f"way: the promoted backup's event log replayed on the card bitwise "
        f"its params, the CPU witness's gradients {_van_grad_errs(ch)}; "
        f"{t_b:.1f} s")
    c = _repl_sparse_async(harness, tmp)
    t_c = time.perf_counter() - t_phase - t_a - t_b
    log(f"repl (c): (a) with ack='async', window {REPL_WINDOW}, primary 0 "
        f"SIGKILLed mid-traffic (worker 0 past cycle {REPL_PAUSE_AT}): "
        f"shard 1's backup lag at most {c['lag']['max']} ({c['lag']['samples']}"
        f" samples, bound {REPL_WINDOW}); the run went on; the promoted "
        f"backup applied {len(c['b0']['applied'])} of "
        f"{c['b0']['expected']} pushes, none twice: {c['lost']} lost in the "
        f"window (bound {REPL_WINDOW}), its tables bitwise the replay of "
        f"what it applied and {c['diff']:.6g} (max abs) from the unkilled "
        f"replay that adds the lost pushes; {t_c:.1f} s")
    # (d) printed, not held
    u = unreplicated or {}
    sa, sc, sl = a["numbers"], c["numbers"], lp["numbers"]
    p1a, p1c = a["p1"], c["p1"]

    def per_push(info):
        return info["repl_bytes"] / max(info["repl_entries"], 1)

    def kill_to_promote(run):
        return (run["b0"]["promoted_at"] - run["t_kill"]) * 1e3

    fo = sum((r["failover_s"] for r in a["records"] + c["records"]), [])
    fo5 = sum((r["failover_s"] for r in b["drill"]["records"]
               + b["three"]["records"]), [])
    wait = 1e3 * float(np.median(p1a["repl_ack_wait_s"]))
    log(f"repl (d): sparse cycles/s unreplicated {u.get('cycles_per_s', 0):.1f}"
        f" (phase 17), sync ack {sa['cycles_per_s']:.1f}, async ack "
        f"{sc['cycles_per_s']:.1f}, sync ack on the loop with a ring worker "
        f"{sl['cycles_per_s']:.1f}; median push unreplicated "
        f"{u.get('ops_ms', {}).get('push', 0):.4f} ms, sync "
        f"{sa['push_ms']:.4f}, async {sc['push_ms']:.4f}, loop "
        f"{sl['push_ms']:.4f}; median cycle sync {sa['median_cycle_ms']:.4f}"
        f", async {sc['median_cycle_ms']:.4f}, loop "
        f"{sl['median_cycle_ms']:.4f} ms; the sync ack's median wait "
        f"{wait:.4f} ms; stream bytes a push {per_push(p1a):.0f} (sync) / "
        f"{per_push(p1c):.0f} (async); kill to promotion "
        f"{kill_to_promote(a):.1f} / {kill_to_promote(c):.1f} ms (the last "
        f"beat {b0['detect_age_ms']} ms old at detection, horizon "
        f"{REPL_WATCH_MS}; the flip {b0['replica']['promotion_s'] * 1e3:.3f}"
        f" ms); workers' failover median {1e3 * float(np.median(fo)):.1f} ms"
        f", max {1e3 * max(fo):.1f} ms ({len(fo)} re-routes; config 5: "
        f"median {1e3 * float(np.median(fo5)):.1f} ms of {len(fo5)}); "
        f"card {card}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    launches = {"sparse_apply/deep": 0, "sparse_apply/wide": 0,
                "sparse_group": 0}
    for got in (snap[f"{s}b"]["launches"] for snap in (a["snap"], lp["snap"])
                for s in range(SPARSE_SHARDS)):
        launches["sparse_apply/deep"] += got["by_rule"]["adagrad"]
        launches["sparse_apply/wide"] += got["by_rule"]["sgd"]
        launches["sparse_group"] += got["group"]
    return {"launches": launches}


# phase 21: the read path on the card (item 5.8). (a) phase 20 (a)'s two
# shards, each a serve_sparse primary on the native loop (the default 64
# MiB read cache) and a sync-ack backup, shard 0 also a frozen backup; a
# pusher at its natural rate and READ_READERS readers of their own hot
# id-sets; (b) config 5's server on the loop with a sync-ack backup, and
# the 442,939,392-byte tree; (c) numbers, printed
READ_WINDOW_S = 3.0
READ_READERS = (2, 4)
# a hot set within READ_TAG_CAP (128 ids over every table of a request:
# 60 of each of the two) is tagged per key
READ_SMALL_IDS = 60
READ_FROZEN_READS = 10
READ_TREE_READS = 3
READ_CACHE_BYTES = 64 << 20  # PS_NATIVE_READ_CACHE_BYTES' default


class _ReadRun:
    """Phase 21 (a)'s processes and their command files: every server runs
    each ``cmd<k>.json`` and answers with ``snap<k>_<name>.json``; every
    reader each ``go<g>.json`` with ``read<g>_<r>.json``."""

    SERVERS = ("0b", "1b", "0f", "0", "1")

    def __init__(self, harness, out):
        os.makedirs(out)
        self.h, self.out, self.k, self.g = harness, out, 0, 0
        opts = {"0b": {"tag": "b", "backup": True},
                "1b": {"tag": "b", "backup": True},
                "0f": {"tag": "f", "backup": True},
                "0": {"native_loop": True, "attach": "b"},
                "1": {"native_loop": True, "attach": "b"}}
        self.servers = {n: harness.spawn(
            "read-server", out, n[0], SPARSE_SHARDS, "cuda", "wd",
            json.dumps(opts[n])) for n in self.SERVERS}
        self.pusher = harness.spawn("read-pusher", out, SPARSE_CYCLES,
                                    "cuda", "wd")
        self.readers = [harness.spawn("read-reader", out, r, "wd")
                        for r in range(max(READ_READERS))]
        self.procs = (list(self.servers.values()) + [self.pusher]
                      + self.readers)

    def path(self, name):
        return os.path.join(self.out, name)

    def ports(self):
        _wait_files([self.path(f"port{n}") for n in self.SERVERS]
                    + [self.path("pusher_ready")]
                    + [self.path(f"reader_ready{r}")
                       for r in range(len(self.readers))], self.procs)
        return {n: int(open(self.path(f"port{n}")).read())
                for n in self.SERVERS}

    def _send(self, name, body):
        with open(self.path(name + ".tmp"), "w") as f:
            json.dump(body, f)
        os.replace(self.path(name + ".tmp"), self.path(name))

    def cmd(self, op="snap", **kw):
        """One command to every server; their snapshots by name."""
        k, self.k = self.k, self.k + 1
        self._send(f"cmd{k}.json", dict(kw, op=op))
        got = [self.path(f"snap{k}_{n}.json") for n in self.SERVERS]
        _wait_files(got, self.procs)
        return {n: json.load(open(p)) for n, p in zip(self.SERVERS, got)}

    def window(self, mode, readers, seconds=READ_WINDOW_S):
        g, self.g = self.g, self.g + 1
        self._send(f"go{g}.json", {"mode": mode, "readers": readers,
                                   "seconds": seconds})
        got = [self.path(f"read{g}_{r}.json")
               for r in range(len(self.readers))]
        _wait_files(got, self.procs)
        return [json.load(open(p)) for p in got]

    def finish(self, failed=False):
        """Release every process and wait for it (kill them all when the
        phase failed); raises if one exited non-zero."""
        if failed:
            self.h.kill_all(self.procs)
            return
        for name in ("push_stop", "exit"):
            open(self.path(name), "w").close()
        outs = self.h.finish(self.procs, SPARSE_TIMEOUT_S)
        for p, o in zip(self.procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"read (a): {' '.join(p.args[-6:])} "
                                     f"exited {p.returncode}:\n{o[-3000:]}")


def _read_launch_check(snap, names, what):
    """Each server launched 2 grouping (cluster path) + 2 apply kernels a
    push it applied, one of each rule; the launches by kernel."""
    launches = {"sparse_apply/deep": 0, "sparse_apply/wide": 0,
                "sparse_group": 0}
    for n in names:
        a, got = snap[n]["applies"], snap[n]["launches"]
        if a == 0 or (got["apply"], got["group"], got["by_rule"]) != (
                2 * a, 2 * a, {"adagrad": a, "sgd": a}):
            raise AssertionError(f"{what}: server {n} launched {got} for {a} "
                                 f"pushes")
        launches["sparse_apply/deep"] += got["by_rule"]["adagrad"]
        launches["sparse_apply/wide"] += got["by_rule"]["sgd"]
        launches["sparse_group"] += got["group"]
    return launches


def _read_revalidations(before, after, names):
    """The NOT_MODIFIED replies and delta rows ``names`` served between
    two snapshots, summed."""
    return {k: sum(after[n][k] - before[n][k] for n in names)
            for k in ("not_modified", "delta_rows")}


def _read_rows_equal(a, b, spec, what):
    """Two ROW replies (READ or ROW_PULL) of one id-set: the same versions
    and the same rows, bitwise."""
    from ps_tpu_torch.control import tensor_van as tv

    _, _, ta, ea = tv.decode(memoryview(a))
    _, _, tb, eb = tv.decode(memoryview(b))
    if ea["versions"] != eb["versions"] or not all(
            np.array_equal(np.asarray(ta[f"{n}/rows"]),
                           np.asarray(tb[f"{n}/rows"])) for n in spec):
        raise AssertionError(f"{what}: the rows differ ({ea['versions']} "
                             f"against {eb['versions']})")


def _read_window_numbers(recs, before, after, pusher, span):
    """One window: reads/s over the readers, read_rows p50/p99, the
    median bytes a read, replica reads and fallbacks, the primaries' native
    hit rate, the NOT_MODIFIED replies and delta rows the primaries and
    the backups served, and the pusher's cycles inside the window."""
    lat = sum((r.get("lat", []) for r in recs), [])
    nbytes = sum((r.get("bytes", []) for r in recs), [])
    hits = misses = 0
    for n in ("0", "1"):
        b, a = before[n]["cache"], after[n]["cache"]
        hits += a["hits"] - b["hits"]
        misses += a["misses"] - b["misses"]
    t0, t1 = span
    cyc = [dt for s, dt in zip(pusher["starts"], pusher["cycle_s"])
           if s >= t0 and s + dt <= t1]
    return {"reads_per_s": len(lat) / READ_WINDOW_S, "reads": len(lat),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "bytes": float(np.median(nbytes)),
            "replica": sum(r.get("replica", 0) for r in recs),
            "fallbacks": sum(r.get("fallbacks", 0) for r in recs),
            "native_hits": hits, "native_misses": misses,
            "hit_rate": hits / max(hits + misses, 1),
            "primaries": _read_revalidations(before, after, ("0", "1")),
            "backups": _read_revalidations(before, after, ("0b", "1b")),
            "push_cycles_per_s": len(cyc) / (t1 - t0)}


def _read_sparse(harness, tmp):
    """(a): the sparse read path under churn; returns its launches and
    numbers."""
    from ps_tpu_torch.backends.remote_sparse import connect_sparse, row_range
    from ps_tpu_torch.control import tensor_van as tv

    run = _ReadRun(harness, os.path.join(tmp, "read"))
    failed = True
    try:
        ports = run.ports()
        spec = harness.sparse_spec("wd")

        def raw(name, payload):
            with tv.Channel.connect("127.0.0.1", ports[name]) as ch:
                return bytes(ch.request(payload))

        # a native hit is bitwise the pump miss that published it, and its
        # rows the primary's table rows (a ROW_PULL) at that version
        lo, hi = row_range(0, SPARSE_SHARDS, spec["deep"][0])
        hot = harness.read_hot_ids("wd", 0)
        hot0 = hot[(hot >= lo) & (hot < hi)]
        req = {f"{n}/ids": hot0 for n in spec}
        miss = raw("0", tv.encode(tv.READ, 0, req))
        if raw("0", tv.encode(tv.READ, 0, req)) != miss:
            raise AssertionError("read (a): a native hit differs from its "
                                 "pump miss")
        _read_rows_equal(miss, raw("0", tv.encode(tv.ROW_PULL, 0, req)),
                         spec, "read (a): a READ against a ROW_PULL")
        s0 = run.cmd()
        if s0["0"]["cache"]["hits"] < 1:
            raise AssertionError(f"read (a): no native hit: "
                                 f"{s0['0']['cache']}")
        # per-key invalidation, on a hot set within the tag cap: a push
        # disjoint from it leaves its entry serving, one that touches it
        # drops it and the next read is the post-apply rows
        small = np.unique(hot0)[:READ_SMALL_IDS].astype(np.int32)
        sreq = tv.encode(tv.READ, 0, {f"{n}/ids": small for n in spec})
        m = raw("0", sreq)
        if raw("0", sreq) != m:
            raise AssertionError("read (a): the small set's hit differs")
        a = run.cmd()["0"]["cache"]
        rng = np.random.default_rng(21)
        cw = connect_sparse(f"127.0.0.1:{ports['0']},127.0.0.1:{ports['1']}",
                            99, spec)

        def push(ids):
            cw.push({n: (ids, (rng.standard_normal((ids.size, d)) * 0.1)
                         .astype(np.float32)) for n, (_, d) in spec.items()})

        far = np.setdiff1d(np.arange(max(lo, hi - 1000), hi), hot0)[:64]
        push(far.astype(np.int32))
        if raw("0", sreq) != m:
            raise AssertionError("read (a): a disjoint push changed the "
                                 "small set's reply")
        b = run.cmd()["0"]["cache"]
        if not (b["hits"] == a["hits"] + 1 and b["misses"] == a["misses"]
                and b["invalidations"] > a["invalidations"]
                and b["floor"] > a["floor"]):
            raise AssertionError(f"read (a): a disjoint push dropped the "
                                 f"entry: {a} then {b}")
        push(small[:8])
        fresh = raw("0", sreq)
        if fresh == m:
            raise AssertionError("read (a): a push into the small set left "
                                 "its entry serving")
        _read_rows_equal(fresh, raw("0", tv.encode(tv.ROW_PULL, 0, {
            f"{n}/ids": small for n in spec})), spec,
            "read (a): the small set after the push")
        snap = run.cmd()
        if snap["0"]["cache"]["misses"] != b["misses"] + 1:
            raise AssertionError(f"read (a): {b} then {snap['0']['cache']}")
        _read_launch_check(snap, ("0", "0b"), "read (a), the two pushes")
        # the pusher alone, then the readers' windows under its churn:
        # layered (the replica sets at bound 0, the cache on) and
        # primary-only (the primaries, the cache off)
        open(run.path("push_go"), "w").close()
        t0 = time.perf_counter()
        time.sleep(READ_WINDOW_S)
        alone = (t0, time.perf_counter())
        spans, recs, snaps = {}, {}, {}
        for mode in ("layered", "primary"):
            if mode == "primary":
                run.cmd("cache", bytes=0)
            for r in READ_READERS:
                before = run.cmd()
                t0 = time.perf_counter()
                recs[(mode, r)] = run.window(mode, r)
                spans[(mode, r)] = (t0, time.perf_counter())
                snaps[(mode, r)] = (before, run.cmd())
                # the readers revalidated under churn: each server they
                # read (the backups too, layered) answered NOT_MODIFIED
                # and sent row deltas
                read = (("0", "1", "0b", "1b") if mode == "layered"
                        else ("0", "1"))
                for n in read:
                    got = _read_revalidations(before, snaps[(mode, r)][1],
                                              (n,))
                    if min(got.values()) < 1:
                        raise AssertionError(
                            f"read (a): {mode} R={r}: server {n} served "
                            f"{got['not_modified']} NOT_MODIFIED and "
                            f"{got['delta_rows']} delta rows")
        run.cmd("cache", bytes=READ_CACHE_BYTES)
        open(run.path("push_stop"), "w").close()
        _wait_files([run.path("pusher.json")], run.procs)
        pusher = json.load(open(run.path("pusher.json")))
        # the pusher stopped: every conditional reader's held rows are a
        # full read's, and a pull's, bitwise; a frozen backup at bound 1
        # serves nothing, every read it is asked falls back
        quiet = run.cmd()
        final = run.window("final", len(run.readers))
        if not all(r["equal"] for r in final):
            raise AssertionError(f"read (a): a reader's held rows differ "
                                 f"from a full read: "
                                 f"{[r['equal'] for r in final]}")
        fw = connect_sparse(f"127.0.0.1:{ports['0']}|127.0.0.1:"
                            f"{ports['0f']},127.0.0.1:{ports['1']}", 98, spec,
                            read_staleness=1)
        for _ in range(READ_FROZEN_READS):
            got = fw.read_rows({n: hot for n in spec})
            want = cw.pull({n: hot for n in spec})
            if not all(np.array_equal(got[n].numpy(), want[n].numpy())
                       for n in spec):
                raise AssertionError("read (a): a read past the frozen "
                                     "backup is not the primary's rows")
        frozen = {"replica": fw.transport.reads_replica,
                  "fallbacks": fw.transport.read_fallbacks}
        fw.close()
        cw.close()
        end = run.cmd(digests=True)
        if frozen != {"replica": 0, "fallbacks": READ_FROZEN_READS // 2} or \
                end["0f"]["reads_served"] != READ_FROZEN_READS // 2:
            raise AssertionError(f"read (a): the frozen backup at bound 1: "
                                 f"{frozen}, it served "
                                 f"{end['0f']['reads_served']} reads")
        for n in ("0", "1", "0b", "1b"):
            if end[n]["launches"] != quiet[n]["launches"]:
                raise AssertionError(f"read (a): reads launched kernels in "
                                     f"server {n}: {quiet[n]['launches']} "
                                     f"then {end[n]['launches']}")
            if end[n]["reads_served"] <= quiet[n]["reads_served"] \
                    and n in ("0", "1"):
                raise AssertionError(f"read (a): server {n} served no read")
        for s in ("0", "1"):
            if (end[s]["digests"], end[s]["applies"]) != (
                    end[s + "b"]["digests"], end[s + "b"]["applies"]):
                raise AssertionError(f"read (a): shard {s}'s backup is not "
                                     f"its primary bitwise")
        launches = _read_launch_check(end, ("0", "1", "0b", "1b"),
                                      "read (a), the churn")
        layered = [recs[("layered", r)] for r in READ_READERS]
        replica = sum(x.get("replica", 0) for rs in layered for x in rs)
        if replica == 0:
            raise AssertionError("read (a): no replica served a read at "
                                 "bound 0 with sync ack")
        failed = False
    finally:
        run.finish(failed)
    numbers = {k: _read_window_numbers(recs[k], *snaps[k], pusher, spans[k])
               for k in recs}
    t0, t1 = alone
    numbers["alone"] = {"push_cycles_per_s": sum(
        1 for s, dt in zip(pusher["starts"], pusher["cycle_s"])
        if s >= t0 and s + dt <= t1) / (t1 - t0)}
    numbers["bytes_full"] = float(np.median([r["bytes_full"] for r in final]))
    numbers["bytes_warm_nm"] = float(np.median([r["bytes_warm"]
                                                for r in final]))
    numbers["pushes"] = {n: end[n]["applies"] for n in ("0", "1")}
    return {"launches": launches, "numbers": numbers, "replica": replica,
            "frozen": frozen}


def _read_dense(harness, out, procs):
    """(b): config 5's server on the loop with a sync-ack backup."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.control import tensor_van as tv
    from ps_tpu_torch.examples.train_mnist_async import build

    _wait_files([os.path.join(out, "primary.ready"),
                 os.path.join(out, "backup_port")], procs)
    prim = int(open(os.path.join(out, "primary.ready")).read())
    back = int(open(os.path.join(out, "backup_port")).read())
    uri = f"127.0.0.1:{prim}|127.0.0.1:{back}"
    with tv.Channel.connect("127.0.0.1", prim) as ch:
        miss = bytes(ch.request(tv.encode(tv.READ, 0, None)))
        if bytes(ch.request(tv.encode(tv.READ, 0, None))) != miss:
            raise AssertionError("read (b): a native hit differs from its "
                                 "pump miss")
    from ps_tpu_torch.kv import keys as keymod

    params, _ = build(0, "cuda")
    flat, treedef = keymod.flatten_with_keys(params)
    grads = keymod.unflatten(treedef, {k: torch.full_like(v, 1e-3)
                                       for k, v in flat.items()}, list(flat))

    def leaves(tree):
        return keymod.flatten_with_keys(tree)[0]

    w = ps.connect_async(uri, 0, params)
    rc = ps.connect_async(uri, 0, params, pull_cache=True)
    try:
        for _ in range(3):
            w.push_all(grads)
        pulled = leaves(w.pull_all())
        read, version = w.read_all_versioned()
        read = leaves(read)
        if version != w.version or any(
                not torch.equal(read[k], pulled[k]) for k in pulled):
            raise AssertionError(f"read (b): read_all at version {version} "
                                 f"is not pull_all at {w.version} bitwise")
        first = [leaves(rc.read_all()) for _ in range(3)]
        if (rc.transport.read_wire, rc.transport.read_cache_hits) != (1, 2):
            raise AssertionError(f"read (b): the cache served "
                                 f"{rc.transport.read_cache_hits} of 3")
        v0 = rc.versions[0]
        w.push_all(grads)
        deadline = time.monotonic() + 10.0
        while rc.versions[0] <= v0 and time.monotonic() < deadline:
            time.sleep(0.02)
        # its snapshot is behind the server now: the conditional READ is
        # answered in full
        again, held = rc.read_all_versioned()
        again = leaves(again)
        pulled = leaves(w.pull_all())
        if rc.transport.read_wire != 2 or held != w.version or any(
                not (torch.equal(again[k], pulled[k])
                     and not torch.equal(first[0][k], pulled[k]))
                for k in pulled):
            raise AssertionError(f"read (b): the cache reader: "
                                 f"{rc.transport.read_wire} wire reads, "
                                 f"version {held} against {w.version}")
        # revalidating what it now holds: NOT_MODIFIED from the primary
        # (a native hit the second time, bitwise) and from the backup
        cond = tv.encode(tv.READ, 0, None, extra={"cond": held})
        for port in (prim, back):
            with tv.Channel.connect("127.0.0.1", port) as ch:
                nm = bytes(ch.request(cond))
                kind, _, _, extra = tv.decode(memoryview(nm))
                if (kind, extra.get("version")) != (tv.NOT_MODIFIED, held) \
                        or bytes(ch.request(cond)) != nm:
                    raise AssertionError(f"read (b): a READ at the held "
                                         f"version {held} from port {port}: "
                                         f"kind {kind}, {extra}")
    finally:
        w.close()
        rc.close()
        open(os.path.join(out, "done"), "w").close()
    outs = harness.finish(procs, VAN_TIMEOUT_S)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"read (b): {' '.join(p.args[-6:])} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")


def _read_tree():
    """(b): the 442,939,392-byte tree, read_all against pull_all from a
    server on the loop with the default cache budget."""
    import ps_tpu_torch as ps

    ps.init(backend="cuda", mode="async", num_workers=1)
    tree, nbytes = _bert_like_tree(BERT_LIKE_MB)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    store.init(tree)
    svc = ps.serve_async(store, native_loop=True)
    try:
        wk = ps.connect_async(f"127.0.0.1:{svc.port}", 0, tree)
        pulled = wk.pull_all()
        wk.read_all()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(READ_TREE_READS):
            read = wk.read_all()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if any(not torch.equal(read[k], pulled[k]) for k in pulled):
            raise AssertionError("read (b): the tree's read_all is not its "
                                 "pull_all bitwise")
        wk.close()
        cs = svc._nloop.cache_stats()
        if cs["entries"] or cs["rejects"] < READ_TREE_READS + 1:
            raise AssertionError(f"read (b): the cache took the tree: {cs}")
        return {"tree_bytes": nbytes,
                "read_gbps": READ_TREE_READS * nbytes / dt / 1e9,
                "cache": cs}
    finally:
        svc.stop()
        ps.shutdown()


def phase_read_path(tmp, pushed=None):
    """21: the read path on the card. ``pushed`` is phase 17's numbers,
    for the pusher's cycles/s beside them."""
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t_phase = time.perf_counter()
    dense_out = os.path.join(tmp, "dense")
    os.makedirs(dense_out)
    watch = harness.free_port(harness.socket.SOCK_DGRAM)
    dense = [harness.spawn("replica-backup", dense_out, watch, 60_000,
                           "cuda"),
             harness.spawn("replica-primary", dense_out, watch, "sync", 256,
                           "cuda", "1")]
    try:
        a = _read_sparse(harness, tmp)
        t_a = time.perf_counter() - t_phase
        _read_dense(harness, dense_out, dense)
    finally:
        harness.kill_all(dense)
    tree = _read_tree()
    t_b = time.perf_counter() - t_phase - t_a
    n = a["numbers"]
    log(f"read (a): {SPARSE_SHARDS} shards of W&D's deep [1,300,000, 16] "
        f"adagrad and wide [1,300,000, 1] sgd on the card, each a "
        f"serve_sparse primary on the native loop ({READ_CACHE_BYTES >> 20} "
        f"MiB read cache) with a sync-ack backup, a pusher running phase "
        f"17's cycles, {READ_READERS} readers of 13,312-id hot sets: a "
        f"native hit bitwise its pump miss and its rows bitwise a ROW_PULL "
        f"at that version; a {READ_SMALL_IDS}-id set kept serving across a "
        f"disjoint push and dropped on one into it, the next read the "
        f"post-apply rows; in every churn window each server read served "
        f"NOT_MODIFIED replies and row deltas, and with the pusher stopped "
        f"every conditional "
        f"reader's held rows bitwise a full read and a pull; "
        f"{a['replica']} replica reads at bound 0; a frozen backup at bound "
        f"1 served {a['frozen']['replica']} reads, {a['frozen']['fallbacks']}"
        f" fell back; the primaries applied {n['pushes']} pushes, each 2 "
        f"grouping + 2 apply launches in the primary and in its backup, and "
        f"the reads launched none; {t_a:.1f} s")
    log(f"read (b): config 5's server (MLP 784-32-10) on the loop with a "
        f"sync-ack backup: a native hit bitwise its pump miss, read_all "
        f"bitwise pull_all at the same version, a pull_cache reader served "
        f"from its cache until its watcher saw the push, then refetched; a "
        f"READ conditional on what it then held answered NOT_MODIFIED by the "
        f"primary and the backup; the {tree['tree_bytes']:,}-byte "
        f"tree's read_all bitwise its pull_all; {t_b:.1f} s")
    p17 = pushed or {}
    for (mode, r), x in sorted((k, v) for k, v in n.items()
                               if isinstance(k, tuple)):
        log(f"read (c): {mode} R={r}: {x['reads_per_s']:.1f} reads/s "
            f"({x['reads']} in {READ_WINDOW_S} s), read_rows p50 "
            f"{x['p50_ms']:.3f} ms p99 {x['p99_ms']:.3f} ms, median "
            f"{x['bytes']:.0f} bytes a read, native hits "
            f"{x['native_hits']} of {x['native_hits'] + x['native_misses']} "
            f"({x['hit_rate']:.4f}), {x['replica']} replica reads, "
            f"{x['fallbacks']} fallbacks; served NOT_MODIFIED / delta rows: "
            f"primaries {x['primaries']['not_modified']} / "
            f"{x['primaries']['delta_rows']}, backups "
            f"{x['backups']['not_modified']} / "
            f"{x['backups']['delta_rows']}; the pusher "
            f"{x['push_cycles_per_s']:.2f} cycles/s; card {card}")
    log(f"read (c): the pusher alone {n['alone']['push_cycles_per_s']:.2f} "
        f"cycles/s (phase 17 in this call: {SPARSE_WORKERS} workers "
        f"{p17.get('cycles_per_s', 0):.2f} cycles/s, median cycle "
        f"{p17.get('median_cycle_ms', 0):.3f} ms; 0 when phase 17 did not "
        f"run); a warm read's bytes with the pusher stopped "
        f"{n['bytes_warm_nm']:.0f} (NOT_MODIFIED) against a full read's "
        f"{n['bytes_full']:.0f} (PS_READ_CONDITIONAL=0); the "
        f"{tree['tree_bytes']:,}-byte tree read at {tree['read_gbps']:.3f} "
        f"GB/s, never cached ({tree['cache']['rejects']} puts over the "
        f"{READ_CACHE_BYTES:,}-byte budget refused, "
        f"{tree['cache']['entries']} entries); card {card}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": a["launches"], "numbers": n, "tree": tree}


AGG_HIDDEN = 256        # the MNIST MLP at 784-256-10 (phase 11's full width)
AGG_FAN_IN = 3          # (a)-(c): one aggregator, three member processes
AGG_ROUNDS = 16         # (a)-(c): lockstep rounds a member
AGG_LR = 0.5            # the sgd legs: a power of two, every sum exact
AGG_DC_LAMBDA = 0.04    # (a)'s DC-ASGD leg: the trainer's default
AGG_DC_LR, AGG_DC_SCALE = 0.1, 2.0 ** -8  # its lr and gradient scale
AGG_KILL_AT = 8         # (b), (c): the round after which the kill lands
AGG_BYTES_SLACK = 16 << 10  # (a): a merged round's header overhead, a round
AGG_TIMEOUT_S = 240
AGG_TREE_FAN_IN, AGG_TREE_ROUNDS = 2, 3  # (e): the 0.44 GB tree


def _agg_upstream(harness, dc_lambda=0.0, lr=AGG_LR, init="int",
                  device="cuda"):
    """Config 5's async server in this process on the card (or
    ``device``): the MLP at 784-256-10 from :func:`agg_tree` (``init``),
    sgd at ``lr``, its full event log kept."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    ps.init(backend="cuda", mode="async", num_workers=AGG_FAN_IN,
            dc_lambda=dc_lambda, device=device)
    params0 = harness.agg_tree(AGG_HIDDEN, init)
    store = ps.KVStore(optimizer="sgd", learning_rate=lr, mode="async")
    store.init({k: torch.from_numpy(v).to(device)
                for k, v in params0.items()})
    return params0, store, AsyncPSService(store, record_full_history=True)


def _agg_params(store):
    return {k: v.cpu().numpy() for k, v in store._engine._params.items()}


def _agg_exact(got, want, what):
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} is not bitwise the closed "
                                 f"form (max diff "
                                 f"{float(np.max(np.abs(got[k] - want[k])))})")


def _agg_group(harness, out, uri, member_opts, aggregator=None,
               on_version=None):
    """One aggregation group as processes: an ``agg-server`` on the native
    loop over ``uri`` (or the ``aggregator`` at ``host:port`` given) and
    AGG_FAN_IN ``worker`` processes on the card, over the shm lane unless
    ``member_opts`` says otherwise, AGG_ROUNDS lockstep rounds each.
    ``on_version`` is polled while the members run (the parent's cue for a
    kill). Returns (the agg-server process or None, the members'
    records); the agg-server still serves until ``agg_done``."""
    os.makedirs(out, exist_ok=True)
    procs = []
    opts = dict({"shm": True}, **member_opts, hidden=AGG_HIDDEN,
                device="cuda", failover_timeout=60.0,
                aggregator=aggregator or "@")
    if aggregator is None:
        procs.append(harness.spawn("agg-server", out, uri, AGG_FAN_IN,
                                   json.dumps({"hidden": AGG_HIDDEN})))
    # the members' file barrier after their first pull starts the rounds
    # together (a process's start is seconds, the flush timeout 2)
    members = [harness.spawn("worker", 0, out, w, AGG_ROUNDS, AGG_FAN_IN,
                             json.dumps(dict(opts, uri=uri)))
               for w in range(AGG_FAN_IN)]
    procs += members
    try:
        deadline = time.monotonic() + AGG_TIMEOUT_S
        while any(p.poll() is None for p in members):
            bad = [p for p in procs if p.poll() not in (None, 0)
                   and not getattr(p, "killed", False)]
            if bad or time.monotonic() > deadline:
                harness.kill_all(procs)
                raise AssertionError(
                    "aggregation group failed:\n" + "\n".join(
                        f"{' '.join(map(str, p.args[-6:]))}: exit "
                        f"{p.returncode}\n{p.stdout.read()[-3000:]}"
                        for p in (bad or procs)))
            if on_version is not None:
                on_version(procs[0])
            time.sleep(0.005)
    except BaseException:
        harness.kill_all(procs)
        raise
    records = [json.load(open(os.path.join(out, f"worker{w}.json")))
               for w in range(AGG_FAN_IN)]
    return (None if aggregator else procs[0]), records


def _agg_finish(harness, out, proc):
    """Release an agg-server and read its dump."""
    open(os.path.join(out, "agg_done"), "w").close()
    text = proc.communicate(timeout=AGG_TIMEOUT_S)[0]
    if proc.returncode != 0:
        raise AssertionError(f"agg-server exited {proc.returncode}:\n"
                             f"{text[-3000:]}")
    info = json.load(open(os.path.join(out, "agg.json")))
    if any(v for k, v in info["launches"].items() if k != "by_rule") \
            or info["launches"]["by_rule"] or info["cuda_initialized"]:
        raise AssertionError(f"the aggregator launched a kernel or touched "
                             f"the card: {info['launches']}, CUDA "
                             f"initialized {info['cuda_initialized']}")
    return info


def _agg_member_checks(records, what, degrades=0, lane="shm"):
    for r in records:
        if r["agg_degrades"] != degrades or r["push_seq"] != AGG_ROUNDS \
                or r["aggregated"] != (degrades == 0):
            raise AssertionError(
                f"{what}: member {r['worker']} degraded "
                f"{r['agg_degrades']} time(s) (want {degrades}), pushed "
                f"{r['push_seq']} of {AGG_ROUNDS}")
        if r["lane"] != lane:
            raise AssertionError(f"{what}: member {r['worker']} on lane "
                                 f"{r['lane']}, not {lane}")


def _raw_request(port, payload):
    from ps_tpu_torch.control import tensor_van as tv

    with tv.Channel.connect("127.0.0.1", port) as ch:
        return bytes(ch.request(payload))


def _agg_reads(agg_port, svc_port):
    """(d) at a live aggregator: a member READ bitwise the upstream's at
    the same version, its repeat (a native hit) bitwise it, and a READ
    conditional on that version answered NOT_MODIFIED."""
    from ps_tpu_torch.control import tensor_van as tv

    miss = _raw_request(agg_port, tv.encode(tv.READ, 0, None))
    hit = _raw_request(agg_port, tv.encode(tv.READ, 0, None))
    up = _raw_request(svc_port, tv.encode(tv.READ, 0, None))
    if hit != miss:
        raise AssertionError("(d): the repeated member READ is not bitwise "
                             "the pump miss that published it")
    k1, _, t1, e1 = tv.decode(memoryview(miss))
    k2, _, t2, e2 = tv.decode(memoryview(up))
    if (k1, k2) != (tv.OK, tv.OK) or int(e1["version"]) != int(
            e2["version"]) or sorted(t1) != sorted(t2) or any(
            not np.array_equal(t1[k], t2[k]) for k in t1):
        raise AssertionError(f"(d): the member READ (version "
                             f"{e1.get('version')}) is not bitwise the "
                             f"upstream's (version {e2.get('version')})")
    v = int(e1["version"])
    nm = _raw_request(agg_port, tv.encode(tv.READ, 0, None,
                                          extra={"cond": v}))
    kind, _, tensors, extra = tv.decode(memoryview(nm))
    if kind != tv.NOT_MODIFIED or tensors or int(extra["version"]) != v:
        raise AssertionError(f"(d): a READ conditional on version {v} got "
                             f"kind {kind}")
    return v


def _agg_sgd(harness, tmp):
    """(a)'s integer-exact sgd leg, and (d) at its aggregator."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.common import AGG_WORKER_BASE

    params0, store, svc = _agg_upstream(harness)
    out = os.path.join(tmp, "sgd")
    uri = f"127.0.0.1:{svc.port}"
    try:
        proc, records = _agg_group(harness, out, uri, {})
        try:
            with open(os.path.join(out, "agg_port")) as f:
                agg_port = int(f.read())
            version = _agg_reads(agg_port, svc.port)
        finally:
            info = _agg_finish(harness, out, proc)
        want = harness.agg_expected(
            params0, {w: range(AGG_ROUNDS) for w in range(AGG_FAN_IN)},
            AGG_LR)
        _agg_exact(_agg_params(store), want, "(a) sgd")
        if version != AGG_ROUNDS or store._engine.version != AGG_ROUNDS \
                or set(svc._applied) != {AGG_WORKER_BASE}:
            raise AssertionError(f"(a): version {store._engine.version}, "
                                 f"appliers {sorted(svc._applied)}")
    finally:
        svc.stop()
        ps.shutdown()
    _agg_member_checks(records, "(a) sgd")
    s = info["summary"]
    if info["rounds"] != AGG_ROUNDS or s.get("agg_rounds") != AGG_ROUNDS \
            or s.get("agg_fan_in") != float(AGG_FAN_IN):
        raise AssertionError(f"(a): {info['rounds']} rounds, summary {s}")
    # a member's cycle to the aggregator is a flat worker's cycle to a
    # one-shard server: the same frames, so flat = the members' bytes
    flat = sum(r["bytes"][-1] - r["bytes"][0] for r in records) / (
        AGG_ROUNDS - 1)
    up = info["upstream"]
    upstream = (up["bytes_pushed"] + up["bytes_pulled"]) / AGG_ROUNDS
    if upstream > flat / AGG_FAN_IN + AGG_BYTES_SLACK:
        raise AssertionError(f"(a): {upstream:.0f} upstream bytes a round "
                             f"against flat {flat:.0f} / {AGG_FAN_IN}")
    fresh = info["fresh"] or {}
    tiers = fresh.get("tiers", {})
    if tiers.get("agg", {}).get("n", 0) < 2 or fresh.get("clamped", 0) \
            or (info["cache"] or {}).get("hits", 0) < 1:
        raise AssertionError(f"(d): serve ages {fresh}, native cache "
                             f"{info['cache']}")
    hold = np.asarray(info["hold_s"]) * 1e3
    return {"flat_bytes": flat, "upstream_bytes": upstream,
            "hold_p50_ms": float(np.quantile(hold, 0.5)),
            "hold_p99_ms": float(np.quantile(hold, 0.99)),
            "rounds_per_s": float(np.mean([
                (AGG_ROUNDS - 1) / (r["ends"][-1] - r["ends"][0])
                for r in records])),
            "version": version, "cache": info["cache"], "fresh": fresh}


def _agg_dc(harness, tmp):
    """(a)'s DC-ASGD leg: the card's params within MNIST_TOL of a CPU
    replay of the same merged rounds through the server's event log."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.common import AGG_WORKER_BASE

    params0, store, svc = _agg_upstream(harness, AGG_DC_LAMBDA, AGG_DC_LR,
                                        "seed")
    out = os.path.join(tmp, "dc")
    try:
        proc, records = _agg_group(harness, out, f"127.0.0.1:{svc.port}",
                                   {"scale": AGG_DC_SCALE})
        info = _agg_finish(harness, out, proc)
        card = _agg_params(store)
        events = [tuple(e) for e in svc.event_log]
    finally:
        svc.stop()
        ps.shutdown()
    _agg_member_checks(records, "(a) DC-ASGD")
    if info["rounds"] != AGG_ROUNDS or {w for _, w in events} != {
            AGG_WORKER_BASE} or sum(op == "push" for op, _ in events) \
            != AGG_ROUNDS:
        raise AssertionError(f"(a) DC-ASGD: {info['rounds']} rounds, "
                             f"events {events[:6]}...")
    ps.init(backend="cuda", mode="async", num_workers=AGG_FAN_IN,
            dc_lambda=AGG_DC_LAMBDA, device="cpu")
    try:
        replay = ps.KVStore(optimizer="sgd", learning_rate=AGG_DC_LR,
                            mode="async")
        replay.init({k: torch.from_numpy(v) for k, v in params0.items()})
        eng, r = replay._engine, 0
        for op, w in events:
            if op == "pull":
                eng.pull_tree(worker=w)
            else:
                merged = harness.agg_merged(params0, range(AGG_FAN_IN), r,
                                            AGG_DC_SCALE)
                eng.push_tree({k: torch.from_numpy(v)
                               for k, v in merged.items()}, worker=w)
                r += 1
        cpu = {k: v.numpy() for k, v in eng._params.items()}
    finally:
        ps.shutdown()
    worst = 0.0
    for k in cpu:
        np.testing.assert_allclose(card[k], cpu[k], rtol=MNIST_TOL,
                                   atol=MNIST_TOL, err_msg=f"(a) DC {k}")
        worst = max(worst, float(np.max(np.abs(card[k] - cpu[k]))))
    return {"worst": worst}


def _agg_kill_windows(harness):
    """(b)'s two windows of the reference's kill drill in this process,
    the server on the card: the aggregator dies after the merged commit
    (before any member's ack) or before the forward; each member degrades
    once and every push applies once, bitwise, and the post-commit replays
    dedup by the members' tokens."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.aggregator import AggregatorService
    from ps_tpu_torch.backends.van_service import VanService

    out = {}
    for window in ("after_forward", "before_forward"):
        params0, store, svc = _agg_upstream(harness)
        uri = f"127.0.0.1:{svc.port}"
        like = {k: torch.from_numpy(v).cuda() for k, v in params0.items()}
        agg = AggregatorService(uri, like, group_size=AGG_FAN_IN)
        ws = [ps.connect_async(uri, w, like,
                               aggregator=f"127.0.0.1:{agg.port}",
                               failover_timeout=30.0)
              for w in range(AGG_FAN_IN)]
        try:
            for w in ws:
                w.pull_all()

            def rounds(steps):
                errs = []

                def loop(i):
                    try:
                        for s in steps:
                            ws[i].push_pull({
                                k: torch.from_numpy(v).cuda()
                                for k, v in harness.agg_grads(
                                    params0, i, s).items()})
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)

                ts = [threading.Thread(target=loop, args=(i,))
                      for i in range(AGG_FAN_IN)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=AGG_TIMEOUT_S)
                if errs or any(t.is_alive() for t in ts):
                    raise AssertionError(f"(b) {window}: {errs}")

            rounds([0])
            orig = agg._client.push_pull

            def dying(*a, _w=window, **kw):
                if _w == "after_forward":
                    got = orig(*a, **kw)
                    VanService.kill(agg)
                    return got
                VanService.kill(agg)
                raise RuntimeError("aggregator died before the forward")

            agg._client.push_pull = dying
            rounds([1])
            rounds([2])
            degrades = [w.transport.agg_degrades for w in ws]
            if degrades != [1] * AGG_FAN_IN or any(
                    w._agg_fallback is not None for w in ws):
                raise AssertionError(f"(b) {window}: degrades {degrades}")
            want = harness.agg_expected(
                params0, {w: range(3) for w in range(AGG_FAN_IN)}, AGG_LR)
            _agg_exact(_agg_params(store), want, f"(b) {window}")
            dedup = svc.transport.dedup_hits
            if window == "after_forward" and dedup < AGG_FAN_IN:
                raise AssertionError(f"(b): {dedup} dedup hits after a "
                                     f"post-commit kill")
            out[window] = {"dedup_hits": dedup,
                           "applies": svc.apply_log.total}
        finally:
            for w in ws:
                w.close()
            agg.kill()
            svc.stop()
            ps.shutdown()
    return out


def _agg_sigkill(harness, tmp):
    """(b): (a)'s group with its agg-server SIGKILLed once the shard
    committed AGG_KILL_AT merged rounds: each member degrades once and
    every push applies once, bitwise. The members' cycles before and
    after give aggregated against flat rounds/s (printed)."""
    import signal

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.common import AGG_WORKER_BASE

    params0, store, svc = _agg_upstream(harness)
    out = os.path.join(tmp, "kill")
    killed = {}

    def kill(proc):
        if not killed and store._engine.version >= AGG_KILL_AT:
            proc.killed = True
            proc.send_signal(signal.SIGKILL)
            killed["version"] = store._engine.version

    try:
        proc, records = _agg_group(harness, out, f"127.0.0.1:{svc.port}",
                                   {}, on_version=kill)
        proc.wait(timeout=30)
        if not killed:
            raise AssertionError("(b): the aggregator was never killed")
        want = harness.agg_expected(
            params0, {w: range(AGG_ROUNDS) for w in range(AGG_FAN_IN)},
            AGG_LR)
        _agg_exact(_agg_params(store), want, "(b) SIGKILL")
        merged = sum(1 for w in svc.apply_log if w == AGG_WORKER_BASE)
        flat = svc.apply_log.total - merged
        dedup = svc.transport.dedup_hits
    finally:
        svc.stop()
        ps.shutdown()
    _agg_member_checks(records, "(b) SIGKILL", degrades=1)
    # the members' cycles: aggregated before the one that degraded, flat
    # after it
    agg_rate, flat_rate = [], []
    for r in records:
        ends, d = r["ends"], r["degraded_at"]
        if d > 1:
            agg_rate.append((d - 1) / (ends[d - 1] - ends[0]))
        if len(ends) - d > 2:
            flat_rate.append((len(ends) - d - 2) / (ends[-1] - ends[d + 1]))
    return {"killed_at": killed["version"], "merged": merged, "flat": flat,
            "dedup_hits": dedup,
            "agg_rounds_per_s": float(np.mean(agg_rate)) if agg_rate else 0.0,
            "flat_rounds_per_s": float(np.mean(flat_rate))
            if flat_rate else 0.0}


def _agg_replicated(harness, tmp):
    """(c): (a)'s sgd leg over a replicated upstream: a primary and a
    sync-ack backup (phase 20's replica roles, the MLP at 784-256-10),
    the aggregator in this process; once round AGG_KILL_AT committed, the
    backup is read bitwise its primary, the primary is SIGKILLed and the
    aggregator killed before any member's ack: the members degrade, fail
    over to the promoted backup, and their replays dedup there through the
    members' tokens the merged pushes replicated."""
    import signal

    from ps_tpu_torch.backends.aggregator import AggregatorService
    from ps_tpu_torch.backends.van_service import VanService
    from ps_tpu_torch.control import tensor_van as tv

    out = os.path.join(tmp, "repl")
    os.makedirs(out)
    watch = harness.free_port(harness.socket.SOCK_DGRAM)
    opts = json.dumps({"hidden": AGG_HIDDEN, "lr": AGG_LR,
                       "num_workers": AGG_FAN_IN})
    servers = [harness.spawn("replica-backup", out, watch, REPL_WATCH_MS,
                             "cuda", opts),
               harness.spawn("replica-primary", out, watch, "sync", 256,
                             "cuda", "0", opts)]
    agg = None
    try:
        _wait_files([os.path.join(out, "primary.ready")], servers,
                    AGG_TIMEOUT_S)
        with open(os.path.join(out, "primary.ready")) as f:
            pport = int(f.read())
        with open(os.path.join(out, "backup_port")) as f:
            bport = int(f.read())
        uri = f"127.0.0.1:{pport}|127.0.0.1:{bport}"
        params0 = harness.agg_tree(AGG_HIDDEN)
        agg = AggregatorService(
            uri, {k: torch.from_numpy(v) for k, v in params0.items()},
            group_size=AGG_FAN_IN, failover_timeout=60.0)
        orig, seen = agg._client.push_pull, {}

        def dying(*a, **kw):
            got = orig(*a, **kw)
            if agg._client.version == AGG_KILL_AT and not seen:
                seen["members"] = len(kw.get("members") or {})
                # the round committed at the primary and, acked sync, at
                # the backup: both READ at one version, bitwise
                reads = [tv.decode(memoryview(_raw_request(
                    p, tv.encode(tv.READ, 0, None)))) for p in (pport,
                                                                bport)]
                seen["versions"] = [int(r[3]["version"]) for r in reads]
                seen["equal"] = all(np.array_equal(reads[0][2][k],
                                                   reads[1][2][k])
                                    for k in reads[0][2])
                servers[1].send_signal(signal.SIGKILL)
                VanService.kill(agg)
            return got

        agg._client.push_pull = dying
        # over TCP: a killed service's serve thread could still hand a
        # parked member its ack through the rings
        _, records = _agg_group(harness, out, uri, {"shm": False},
                                aggregator=f"127.0.0.1:{agg.port}")
        open(os.path.join(out, "done"), "w").close()
        text = servers[0].communicate(timeout=AGG_TIMEOUT_S)[0]
        if servers[0].returncode != 0:
            raise AssertionError(f"(c) backup exited "
                                 f"{servers[0].returncode}:\n{text[-3000:]}")
        info = json.load(open(os.path.join(out, "backup.json")))
        final = dict(np.load(os.path.join(out, "backup_params.npz")))
    finally:
        if agg is not None:
            agg.kill()
        harness.kill_all(servers)
    if seen.get("versions") != [AGG_KILL_AT] * 2 or not seen.get("equal") \
            or seen.get("members") != AGG_FAN_IN:
        raise AssertionError(f"(c): before the kill the backup was not "
                             f"bitwise its primary: {seen}")
    _agg_member_checks(records, "(c)", degrades=1, lane="tcp")
    want = harness.agg_expected(
        params0, {w: range(AGG_ROUNDS) for w in range(AGG_FAN_IN)}, AGG_LR)
    _agg_exact(final, want, "(c) the promoted backup")
    if info["role"] != "primary" or info["dedup_hits"] < AGG_FAN_IN:
        raise AssertionError(f"(c): the backup {info}")
    return {"dedup_hits": info["dedup_hits"],
            "promote_reason": info["promote_reason"],
            "promotion_s": info["promotion_s"],
            "version": info["version"]}


def _agg_tree_bytes():
    """(e): the 442,939,392-byte tree at fan-in AGG_TREE_FAN_IN for
    AGG_TREE_ROUNDS rounds, aggregated and flat, in this process with the
    server on the card: the upstream bytes a round against the flat
    workers' and the rates."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.aggregator import AggregatorService

    ps.init(backend="cuda", mode="async", num_workers=2 * AGG_TREE_FAN_IN,
            dc_lambda=0.0)
    tree, nbytes = _bert_like_tree(BERT_LIKE_MB)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    store.init(tree)
    svc = ps.serve_async(store)
    uri = f"127.0.0.1:{svc.port}"
    grads = {k: torch.full_like(v, 1e-3) for k, v in tree.items()}
    out = {"tree_bytes": nbytes}

    def drive(ws):
        errs = []

        def cycles(w):
            try:
                for _ in range(AGG_TREE_ROUNDS):
                    w.push_pull(grads)
            except Exception as e:  # noqa: BLE001 (reported below)
                errs.append(repr(e))

        ts = [threading.Thread(target=cycles, args=(w,)) for w in ws]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=AGG_TIMEOUT_S)
        if errs or any(t.is_alive() for t in ts):
            raise AssertionError(f"(e): {errs}")
        return time.perf_counter() - t0

    agg = None
    try:
        flat = [ps.connect_async(uri, w, tree) for w in range(AGG_TREE_FAN_IN)]
        for w in flat:
            w.pull_all()
        b0 = sum(w.bytes_pushed + w.bytes_pulled for w in flat)
        dt = drive(flat)
        out["flat_bytes"] = (sum(w.bytes_pushed + w.bytes_pulled
                                 for w in flat) - b0) / AGG_TREE_ROUNDS
        out["flat_gbps"] = out["flat_bytes"] * AGG_TREE_ROUNDS / dt / 1e9
        for w in flat:
            w.close()
        agg = AggregatorService(uri, tree, group_size=AGG_TREE_FAN_IN)
        ws = [ps.connect_async(uri, AGG_TREE_FAN_IN + w, tree,
                               aggregator=f"127.0.0.1:{agg.port}")
              for w in range(AGG_TREE_FAN_IN)]
        for w in ws:
            w.pull_all()
        b0 = agg._client.bytes_pushed + agg._client.bytes_pulled
        dt = drive(ws)
        up = agg._client.bytes_pushed + agg._client.bytes_pulled - b0
        out["upstream_bytes"] = up / AGG_TREE_ROUNDS
        out["upstream_gbps"] = up / dt / 1e9
        out["member_gbps"] = sum(
            w.bytes_pushed + w.bytes_pulled for w in ws) / dt / 1e9
        out["rounds"] = agg.transport.agg_rounds
        for w in ws:
            w.close()
    finally:
        if agg is not None:
            agg.stop()
        svc.stop()
        ps.shutdown()
    return out


def phase_aggregation(tmp):
    """22: two-level aggregation on the card (ROADMAP item 5.5)."""
    harness = _van_harness()
    card = _card_line()
    t0 = time.perf_counter()
    _launch_counts(reset=True)
    sgd = _agg_sgd(harness, tmp)
    t_a = time.perf_counter()
    dc = _agg_dc(harness, tmp)
    t_dc = time.perf_counter()
    windows = _agg_kill_windows(harness)
    sig = _agg_sigkill(harness, tmp)
    t_b = time.perf_counter()
    repl = _agg_replicated(harness, tmp)
    t_c = time.perf_counter()
    big = _agg_tree_bytes()
    _no_launches("phase 22 (two-level aggregation)")
    t_e = time.perf_counter()
    log(f"aggregation (a): the MLP at 784-256-10 on the card behind config "
        f"5's async server in this process, an agg-server process on the "
        f"native loop (group {AGG_FAN_IN}) and {AGG_FAN_IN} member processes "
        f"over the rings, {AGG_ROUNDS} lockstep rounds: sgd (lr {AGG_LR}, "
        f"integer gradients) bitwise the closed form, {AGG_ROUNDS} merged "
        f"rounds at fan-in {AGG_FAN_IN}.0, upstream "
        f"{sgd['upstream_bytes']:.0f} bytes a round against the members' "
        f"{sgd['flat_bytes']:.0f} (flat / {AGG_FAN_IN} = "
        f"{sgd['flat_bytes'] / AGG_FAN_IN:.0f}); DC-ASGD (dc_lambda "
        f"{AGG_DC_LAMBDA}, lr {AGG_DC_LR}) within {dc['worst']:.3e} of a "
        f"CPU replay of the merged rounds (gate {MNIST_TOL}); the aggregator "
        f"launched no kernel and never initialized CUDA; "
        f"{t_dc - t0:.1f} s")
    log(f"aggregation (b): in this process, the aggregator killed after the "
        f"merged commit ({windows['after_forward']['dedup_hits']} replays "
        f"deduplicated) and before the forward: each member degraded once, "
        f"every push applied once, bitwise; the agg-server process "
        f"SIGKILLed at version {sig['killed_at']}: {sig['merged']} merged "
        f"and {sig['flat']} flat applies, {sig['dedup_hits']} replays "
        f"deduplicated, each member degraded once, bitwise the closed form; "
        f"{t_b - t_dc:.1f} s")
    log(f"aggregation (c): a primary and a sync-ack backup process "
        f"upstream: the backup bitwise its primary at version "
        f"{AGG_KILL_AT}, the primary SIGKILLed with the aggregator after "
        f"that round's commit, the backup promoted ({repl['promote_reason']}"
        f", {repl['promotion_s'] * 1e3:.3f} ms) and deduplicated "
        f"{repl['dedup_hits']} member replays, each member degraded once, "
        f"its params bitwise the closed form; {t_c - t_b:.1f} s")
    log(f"aggregation (d): a member READ at version {sgd['version']} bitwise "
        f"the upstream's, its repeat a native hit bitwise the miss "
        f"({sgd['cache']['hits']} hits), a READ conditional on it "
        f"NOT_MODIFIED; serve ages under tier agg: "
        f"{sgd['fresh']['tiers']['agg']}, none clamped")
    log(f"aggregation (e): {sgd['rounds_per_s']:.2f} rounds/s aggregated in "
        f"(a); in (b)'s SIGKILL run the same members "
        f"{sig['agg_rounds_per_s']:.2f} cycles/s aggregated against "
        f"{sig['flat_rounds_per_s']:.2f} flat; agg_hold p50 "
        f"{sgd['hold_p50_ms']:.3f} ms p99 {sgd['hold_p99_ms']:.3f} ms; the "
        f"{big['tree_bytes']:,}-byte tree at fan-in {AGG_TREE_FAN_IN}, "
        f"{AGG_TREE_ROUNDS} rounds: upstream {big['upstream_bytes']:.0f} "
        f"bytes a round against flat {big['flat_bytes']:.0f} "
        f"({big['flat_bytes'] / big['upstream_bytes']:.3f}x), upstream "
        f"{big['upstream_gbps']:.3f} GB/s, members {big['member_gbps']:.3f} "
        f"GB/s, flat {big['flat_gbps']:.3f} GB/s; card {card}; "
        f"{t_e - t_c:.1f} s; phase {t_e - t0:.1f} s")
    return {"sgd": sgd, "dc": dc, "windows": windows, "sigkill": sig,
            "replicated": repl, "tree": big}


# phase 23: tiered embedding storage (ROADMAP item 5.7, kv/tiered.py). (a)
# in this process at Wide-&-Deep's full width, the table 4x its device
# budget (bench_tiered's acceptance shape); the all-hot oracle is an
# untiered table of every row on the same stream. A row resident on the
# card since init and never moved is updated by the kernels alone, so it
# is held bitwise; a row that went through the host tier was updated by
# the plain rule's torch ops on the card, which may round a mean of
# squares the other way, so every row is held to RTOL / ATOL. Row sums
# are held within TIERED_SUM_RTOL of the sum of |rows| (a lost update
# moves it by a step, ~1e-3). (b) phase 20's layout with tiered shards on
# the native loop; (c) two gloo ranks on the card at a cut depth.
TIERED_BUDGET = 650_000   # (a): a quarter of W&D's 2,600,000 rows
TIERED_ADMIT = 2
TIERED_ZIPF = 1.3         # bench_tiered's skew
TIERED_WARMUP, TIERED_PUSHES = 16, 60  # each push a fresh batch
TIERED_HOT_PUSHES = 8     # (a): the stream confined to the hot set
TIERED_TTL_PUSHES = 6     # (a): the TTL leg (evict_ttl_ms 1)
TIERED_BREAKDOWN = 8      # (a): pushes timed stage by stage, after the gates
TIERED_DIV = 4            # (b): a shard's budget, its rows // 4
TIERED_CYCLES, TIERED_KILL_AT, TIERED_CUE_AT = 30, 15, 5  # (b)
TIERED_RANK_FIELDS, TIERED_RANK_PUSHES = 4, 6  # (c): the cut depth
TIERED_SUM_RTOL = 1e-9
TIERED_LR = 0.05


def _tiered_stream(fields, vocab, pushes, dim, seed=0):
    """bench_tiered's W&D-shaped ids: a push is one batch of BATCH rows x
    ``fields`` fields, each field's ids zipf(1.3) % ``vocab`` plus its
    offset (13,312 ids at W&D's width), a fresh batch a push (so rare ids
    keep arriving cold); grads N(0, 0.01²)."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(fields, dtype=np.int64) * vocab
    ids = [((rng.zipf(TIERED_ZIPF, size=(BATCH, fields)) % vocab) + offsets)
           .astype(np.int32).reshape(-1) for _ in range(pushes)]
    grads = [rng.standard_normal((BATCH * fields, dim), dtype=np.float32)
             * np.float32(0.01) for _ in range(pushes)]
    return ids, grads


def _tiered_table(rows, dim, budget, full, **kw):
    from ps_tpu_torch.kv.tiered import TieredTable

    t = TieredTable(rows, dim, "adagrad", device_rows=budget,
                    learning_rate=TIERED_LR, **kw)
    t.init(full)
    return t


def _all_hot(rows, dim, full):
    import ps_tpu_torch as ps

    emb = ps.SparseEmbedding(rows, dim, "adagrad", learning_rate=TIERED_LR)
    emb.init(full)
    return emb


def _tiered_same(a, b, what):
    """Two tiered tables' directories and both tiers, bitwise."""
    for attr in ("tier", "slot", "freq", "ref", "last_ms", "slot_to_id"):
        if not np.array_equal(getattr(a, attr), getattr(b, attr)):
            raise AssertionError(f"{what}: directory {attr} differs")
    leaves = lambda t: ([t.hot.table] + _emb_leaves(t.hot)  # noqa: E731
                        + [t.arena] + t.cold_state)
    if a.hand != b.hand or not all(
            torch.equal(x, y) for x, y in zip(leaves(a), leaves(b))):
        raise AssertionError(f"{what}: the tiers or the hand differ")


def _tiered_rows_gate(t, oracle, still, what):
    """Every row of ``t`` against the all-hot ``oracle``: the rows in
    ``still`` (hot since init, never moved) bitwise, every row within
    RTOL / ATOL; the row sums within TIERED_SUM_RTOL. Returns (max abs
    err, row-sum difference)."""
    got = t.pull(np.arange(t.num_rows, dtype=np.int32)).numpy()
    want = oracle.table.cpu().numpy()[:t.num_rows]
    if not np.array_equal(got[still], want[still]):
        raise AssertionError(f"{what}: a row hot since init differs from "
                             f"the all-hot table")
    err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: rows differ from the all-hot table "
                             f"by up to {err} (rtol {RTOL}, atol {ATOL})")
    got_sum, want_sum = t.row_sum(), float(want.astype(np.float64).sum())
    scale = float(np.abs(want).astype(np.float64).sum())
    if abs(got_sum - want_sum) > TIERED_SUM_RTOL * scale:
        raise AssertionError(f"{what}: row sum {got_sum!r} against the "
                             f"all-hot {want_sum!r} (sum |x| {scale!r})")
    return err, got_sum - want_sum


def _tiered_one_process(tmp, fields=None, vocab=None, budget=TIERED_BUDGET,
                        device="cuda"):
    """(a): W&D's deep table (26 x 100,000 rows, D 16, adagrad) tiered at
    ``budget`` slots against all-hot, in this process on ``device``."""
    from ps_tpu_torch.kv.tiered import TieredTable
    from ps_tpu_torch.models.wide_deep import WideDeepConfig
    from ps_tpu_torch.ops import sparse_apply as ops

    cfg = WideDeepConfig()
    fields = fields or cfg.num_sparse
    vocab = vocab or cfg.per_feature_vocab
    rows, dim = fields * vocab, cfg.embed_dim
    full = np.random.default_rng(17).standard_normal(
        (rows, dim), dtype=np.float32) * np.float32(0.01)
    ids, grads = _tiered_stream(fields, vocab, TIERED_WARMUP + TIERED_PUSHES,
                                dim)
    grads = [torch.from_numpy(g).to(device) for g in grads]
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    # a stream confined to the hot set: bitwise an untiered budget table
    rng = np.random.default_rng(3)
    hot_t = _tiered_table(rows, dim, budget, full, admit_freq=1 << 30)
    hot_u = _all_hot(budget, dim, full[:budget])
    for i in range(TIERED_HOT_PUSHES):
        hid = rng.integers(0, budget, ids[0].size).astype(np.int32)
        hot_t.push(hid, grads[i])
        hot_u.push(hid, grads[i])
    if not (torch.equal(hot_t.hot.table, hot_u.table) and torch.equal(
            _emb_leaves(hot_t.hot)[0], _emb_leaves(hot_u)[0])) or \
            hot_t.promotions or hot_t.evictions:
        raise AssertionError("tiered (a): a stream confined to the hot set "
                             "is not bitwise the untiered budget table")
    del hot_t, hot_u

    def run(emb, moved=None):
        cold_s = []
        for i in range(TIERED_WARMUP + TIERED_PUSHES):
            if i == TIERED_WARMUP:
                sync()
                if moved is not None:
                    emb.drain_cold_gather()
                    stats0 = emb.tier_stats()
                t0 = time.perf_counter()
            emb.push(ids[i], grads[i])
            if moved is not None:
                moved.update(op[1] for op in emb.pop_moves()["ops"]
                             if op[0] != "r")
            if i >= TIERED_WARMUP and i % 4 == 3:  # the serving read leg
                emb.pull(ids[i][:ids[i].size // 4])
        sync()
        secs = time.perf_counter() - t0
        if moved is not None:
            cold_s = emb.drain_cold_gather()
            st = emb.tier_stats()
            stats = {k: st[k] - stats0[k] for k in (
                "hot_hits", "misses", "promotions", "evictions")}
            return secs, stats, cold_s
        return secs

    t = _tiered_table(rows, dim, budget, full, admit_freq=TIERED_ADMIT)
    moved = set()
    _launch_counts(reset=True)
    secs, stats, cold_s = run(t, moved)
    launches = {"group": ops.GROUP_LAUNCHES, "apply": ops.LAUNCHES}
    n = TIERED_WARMUP + TIERED_PUSHES
    if launches != {"group": n, "apply": n} or t.promotions == 0 \
            or t.evictions == 0:
        raise AssertionError(f"tiered (a): {launches} launches for {n} "
                             f"pushes, {t.promotions} promotions, "
                             f"{t.evictions} evictions")
    oracle = _all_hot(rows, dim, full)
    secs_hot = run(oracle)
    still = t.slot_to_id[t.slot_to_id >= 0]
    still = still[~np.isin(still, np.fromiter(moved, np.int64))]
    err, dsum = _tiered_rows_gate(t, oracle, still, "tiered (a) mixed")
    hot_bytes = sum(x.numel() * x.element_size()
                    for x in [t.hot.table] + _emb_leaves(t.hot))
    all_bytes = sum(x.numel() * x.element_size()
                    for x in [oracle.table] + _emb_leaves(oracle))
    # checkpoint: both tiers and the directory, restored bitwise
    t0 = time.perf_counter()
    t.save(os.path.join(tmp, "tiered_a"))
    back = _tiered_table(rows, dim, budget, full, admit_freq=TIERED_ADMIT)
    back.restore(os.path.join(tmp, "tiered_a"))
    _tiered_same(t, back, "tiered (a) save/restore")
    ckpt_s = time.perf_counter() - t0
    del back, oracle
    more_ids, more = _tiered_stream(fields, vocab, TIERED_BREAKDOWN, dim,
                                    seed=5)
    breakdown = _tiered_breakdown(
        t, more_ids, [torch.from_numpy(g).to(device) for g in more], sync)
    # TTL: idle hot rows demote after 1 ms; nothing lost
    ttl = _tiered_table(rows, dim, budget, full, admit_freq=TIERED_ADMIT,
                        evict_ttl_ms=1)
    ttl_oracle = _all_hot(rows, dim, full)
    for i in range(TIERED_TTL_PUSHES):
        ttl.push(ids[i], grads[i])
        ttl_oracle.push(ids[i], grads[i])
        time.sleep(0.002)
    ttl_evictions = ttl.evictions
    if not ttl_evictions:
        raise AssertionError("tiered (a) TTL: nothing demoted")
    ttl_err, ttl_dsum = _tiered_rows_gate(ttl, ttl_oracle, np.zeros(0, int),
                                          "tiered (a) TTL")
    del ttl, ttl_oracle
    total = stats["hot_hits"] + stats["misses"]
    return {
        "rows": rows, "budget": budget, "ids": int(ids[0].size),
        "tiered_rows_per_s": TIERED_PUSHES * ids[0].size / secs,
        "all_hot_rows_per_s": TIERED_PUSHES * ids[0].size / secs_hot,
        "hit_rate": stats["hot_hits"] / total,
        "promotions_per_1k": stats["promotions"] * 1000 / TIERED_PUSHES,
        "evictions_per_1k": stats["evictions"] * 1000 / TIERED_PUSHES,
        "cold_p50_ms": float(np.quantile(cold_s, 0.5)) * 1e3,
        "cold_p99_ms": float(np.quantile(cold_s, 0.99)) * 1e3,
        "cold_passes": len(cold_s), "hot_bytes": hot_bytes,
        "all_hot_bytes": all_bytes, "launches": launches,
        "still_hot": int(still.size), "err": err, "dsum": dsum,
        "ttl_err": ttl_err, "ttl_dsum": ttl_dsum,
        "ttl_evictions": ttl_evictions, "ckpt_s": ckpt_s,
        "moved": len(moved), "breakdown": breakdown}


def _tiered_breakdown(t, ids, grads, sync):
    """Where a tiered push's time goes: ms a push (host clock) in the
    plan, the moves, the hot tier's push, the cold pass and the rest,
    over fresh pushes ``ids``/``grads``, each stage timed by a wrapper on
    this table alone."""
    spent = {"plan": 0.0, "moves": 0.0, "hot push": 0.0, "cold pass": 0.0}
    owners = {"plan": (t, "_plan_moves"), "moves": (t, "_apply_moves"),
              "hot push": (t.hot, "push"), "cold pass": (t, "_push_cold")}

    def timed(stage, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[stage] += time.perf_counter() - t0
        return run

    for stage, (obj, name) in owners.items():
        setattr(obj, name, timed(stage, getattr(obj, name)))
    try:
        sync()
        t0 = time.perf_counter()
        for i, g in zip(ids, grads):
            t.push(i, g)
        sync()
        total = time.perf_counter() - t0
    finally:
        for obj, name in owners.values():
            delattr(obj, name)
    out = {k: v * 1e3 / len(ids) for k, v in spent.items()}
    out["rest"] = total * 1e3 / len(ids) - sum(out.values())
    out["push"] = total * 1e3 / len(ids)
    return out


def _tiered_prefix(harness, info, s, pushes, shape):
    """Shard ``s``'s first ``pushes`` applies (``info['applied']`` order)
    replayed through fresh tiered tables."""
    tables = harness.sparse_tables(shape, s, SPARSE_SHARDS, tiered=TIERED_DIV)
    ids = {}
    for w, c in info["applied"][:pushes]:
        if w not in ids:
            ids[w] = harness.sparse_ids(shape, w, TIERED_CYCLES)
        for name, (i, g) in harness._routed(shape, w, c, ids[w][c], s,
                                            SPARSE_SHARDS).items():
            tables[name].push(i, g)
    return tables


def _tiered_served(harness, tmp, device="cuda", shape="wd"):
    """(b): phase 20's layout, each shard a tiered primary on the native
    loop with a sync-ack backup; three workers over TCP; a reader process
    (this one) reads and checkpoints mid-traffic; primary 0 SIGKILLed at
    the workers' pause."""
    import signal

    import ps_tpu_torch as ps
    from ps_tpu_torch import checkpoint as ckpt

    out = os.path.join(tmp, "b")
    os.makedirs(out)
    watch = [harness.free_port(harness.socket.SOCK_DGRAM)
             for _ in range(SPARSE_SHARDS)]
    spec = harness.sparse_spec(shape)

    def server(s, opts):  # the reader says goodbye too: one more worker
        return harness.spawn(
            "sparse-server", out, SPARSE_WORKERS + 1, TIERED_CYCLES, s,
            SPARSE_SHARDS, device, shape,
            json.dumps(dict(opts, native_loop=True, digests=True,
                            tiered=TIERED_DIV)))

    backups = [server(s, {"backup": True, "watch_port": watch[s],
                          "watch_timeout_ms": REPL_WATCH_MS})
               for s in range(SPARSE_SHARDS)]
    primaries = [server(s, {"replicate": True, "ack": "sync", "window": 256,
                            "watch_port": watch[s]})
                 for s in range(SPARSE_SHARDS)]
    workers = [harness.spawn("sparse-worker", f"@{SPARSE_SHARDS}", out, w,
                             TIERED_CYCLES, device, shape, SPARSE_WORKERS, 0,
                             json.dumps({"replicas": True,
                                         "pause_at": TIERED_KILL_AT,
                                         "cue_at": TIERED_CUE_AT}))
               for w in range(SPARSE_WORKERS)]
    procs = (backups, primaries, workers)
    everyone = backups + primaries + workers
    ckdir = os.path.join(tmp, "b_ckpt")
    probe = harness.sparse_ids(shape, 7, 1)[0]
    ps.init(backend="cuda", device=device)
    try:
        _wait_files([os.path.join(out, f"cue{w}")
                     for w in range(SPARSE_WORKERS)], everyone)
        ports = [open(os.path.join(out, f"port{s}{t}")).read()
                 for s in range(SPARSE_SHARDS) for t in ("", "b")]
        uri = ",".join(f"127.0.0.1:{ports[2 * s]}|127.0.0.1:{ports[2 * s + 1]}"
                       for s in range(SPARSE_SHARDS))
        reader = ps.connect_sparse(uri, SPARSE_WORKERS, spec,
                                   failover_timeout=60.0)
        req = {n: probe for n in spec}
        first = {n: r.clone() for n, r in reader.read_rows(req).items()}
        t0 = time.perf_counter()
        saved = reader.checkpoint_all(ckdir)  # the workers run on
        ckpt_s = time.perf_counter() - t0
        snap = _repl_pause_check(out, everyone, "tiered (b)")
        again = reader.read_rows(req)  # conditional: a delta after moves
        pulled = reader.pull(req)
        for n in spec:
            if not torch.equal(again[n].cpu(), pulled[n].cpu()):
                raise AssertionError(f"tiered (b): the conditional read of "
                                     f"{n} after tier moves is not a pull")
            if torch.equal(again[n].cpu(), first[n].cpu()):
                raise AssertionError(f"tiered (b): {n} did not change")
        reader.close()
        moves = [snap[str(s)]["tier"][n]["promotions"]
                 for s in range(SPARSE_SHARDS) for n in spec]
        if min(moves) == 0:
            raise AssertionError(f"tiered (b): promotions {moves}")
        primaries[0].send_signal(signal.SIGKILL)
        primaries[0].wait(timeout=30)
        with open(os.path.join(out, "resume"), "w") as f:
            f.write("1")
        infos, records = _repl_finish(harness, out, procs, [primaries[0]],
                                      "tiered (b)")
    finally:
        harness.kill_all(everyone)
    b0, p1, b1 = infos["0b"], infos["1"], infos["1b"]
    rep = b0["replica"]
    if (rep["role"], rep.get("promote_reason"), rep["epoch"]) != (
            "primary", "timeout", 1):
        raise AssertionError(f"tiered (b): backup 0 did not promote: {rep}")
    for s, info in ((0, b0), (1, p1)):
        seen = [tuple(x) for x in info["applied"]]
        want = harness.expected_pushes(shape, s, SPARSE_SHARDS,
                                       SPARSE_WORKERS, TIERED_CYCLES)
        if len(seen) != want or len(set(seen)) != len(seen):
            twice = len(seen) - len(set(seen))
            raise AssertionError(f"tiered (b): shard {s} applied "
                                 f"{len(seen)} pushes ({twice} twice) of "
                                 f"{want}")
    if b1["digests"] != p1["digests"]:
        raise AssertionError("tiered (b): shard 1's backup differs from its "
                             "primary at the end")
    if any(r["failovers"] < 1 or r["epochs"][0] != 1 for r in records):
        raise AssertionError(f"tiered (b): failovers "
                             f"{[r['failovers'] for r in records]}")
    try:
        # the applied logs through tiered tables: the servers' bitwise
        tiered, _ = harness.sparse_replay([b0, p1], shape, SPARSE_WORKERS,
                                          TIERED_CYCLES, by_cycle=True,
                                          tiered=TIERED_DIV)
        for s, (tables, info) in enumerate(zip(tiered, (b0, p1))):
            if harness.table_digests(tables) != info["digests"]:
                raise AssertionError(f"tiered (b): shard {s}'s log replayed "
                                     f"through tiered tables differs")
        del tiered
        # ... and through all-hot ones: the row sums conserved
        hot, _ = harness.sparse_replay([b0, p1], shape, SPARSE_WORKERS,
                                       TIERED_CYCLES, by_cycle=True)
        dsum = {}
        for s, (tables, info) in enumerate(zip(hot, (b0, p1))):
            for n, emb in tables.items():
                x = emb.table.double()
                want, scale = float(x.sum()), float(x.abs().sum())
                d = info["row_sum"][n] - want
                dsum[f"{s}/{n}"] = d
                if abs(d) > TIERED_SUM_RTOL * scale:
                    raise AssertionError(
                        f"tiered (b): shard {s} {n} row sum "
                        f"{info['row_sum'][n]!r} against the all-hot "
                        f"replay's {want!r}")
        del hot
        # the checkpoint: restored into fresh services, bitwise the first
        # pushes of each shard's log
        totals = {n: v for n, (v, _) in spec.items()}
        svcs, held = [], []
        for s, info in enumerate((b0, p1)):
            v = ckpt.read_meta(os.path.join(ckdir, f"shard{s}", "deep"))[
                "push_count"]
            want = _tiered_prefix(harness, info, s, v, shape)
            tables = harness.sparse_tables(shape, s, SPARSE_SHARDS,
                                           tiered=TIERED_DIV)
            for n, emb in tables.items():
                emb.restore(os.path.join(ckdir, f"shard{s}", n))
            if harness.table_digests(tables) != harness.table_digests(want):
                raise AssertionError(f"tiered (b): shard {s}'s checkpoint "
                                     f"is not its first {v} pushes")
            held.append(want)
            svcs.append(ps.serve_sparse(tables, shard=s,
                                        num_shards=SPARSE_SHARDS,
                                        total_rows=totals))
        w = ps.connect_sparse(",".join(f"127.0.0.1:{x.port}" for x in svcs),
                              0, spec)
        try:
            got = w.pull(req)
            if w.versions() != saved:
                raise AssertionError(f"tiered (b): restored versions "
                                     f"{w.versions()}, saved {saved}")
            for n in spec:
                want = torch.empty((probe.size, spec[n][1]))
                for s in range(SPARSE_SHARDS):
                    m = _in_shard(probe, s, spec[n][0])
                    want[torch.from_numpy(m)] = held[s][n].pull(
                        probe[m] - _shard_lo(s, spec[n][0])).cpu()
                if not torch.equal(got[n].cpu(), want):
                    raise AssertionError(f"tiered (b): a pull of {n} from "
                                         f"the restored services differs")
            w.close()
        finally:
            for x in svcs:
                x.stop()
    finally:
        ps.shutdown()
    return {"snap": snap, "b0": b0, "p1": p1, "b1": b1, "records": records,
            "saved": saved, "ckpt_s": ckpt_s, "dsum": dsum,
            "numbers": _repl_window_numbers(records, TIERED_KILL_AT)}


def _shard_lo(s, rows):
    from ps_tpu_torch.backends.remote_sparse import row_range

    return row_range(s, SPARSE_SHARDS, rows)[0]


def _in_shard(ids, s, rows):
    from ps_tpu_torch.backends.remote_sparse import row_range

    lo, hi = row_range(s, SPARSE_SHARDS, rows)
    return (ids >= lo) & (ids < hi)


def _tiered_ranks_case():
    """(c)'s table and stream: W&D's deep table cut to
    TIERED_RANK_FIELDS fields (D 16), a quarter of it the budget."""
    from ps_tpu_torch.models.wide_deep import WideDeepConfig

    cfg = WideDeepConfig()
    rows, dim = TIERED_RANK_FIELDS * cfg.per_feature_vocab, cfg.embed_dim
    full = np.random.default_rng(19).standard_normal(
        (rows, dim), dtype=np.float32) * np.float32(0.01)
    ids, grads = _tiered_stream(TIERED_RANK_FIELDS, cfg.per_feature_vocab,
                                TIERED_RANK_PUSHES, dim, seed=1)
    return rows, dim, rows // 4, full, ids, grads


def _tiered_snapshot(t):
    """A tiered table's directory and both tiers (the hot one gathered
    over the ranks) as numpy, and its row sum."""
    rows, leaves = t.hot.export_rows(np.arange(t.device_rows))
    return {"hot": rows, "hot_state": leaves, "arena": t.arena.numpy().copy(),
            "cold": [x.numpy().copy() for x in t.cold_state],
            "dir": {a: getattr(t, a).copy() for a in (
                "tier", "slot", "freq", "ref", "slot_to_id")},
            "hand": t.hand, "row_sum": t.row_sum(),
            "promotions": t.promotions, "evictions": t.evictions}


def _tiered_ranks_worker(rank, port, outdir):
    """(c)'s rank ``rank`` of 2 on the one card over gloo: its half of
    every push; results into ``outdir/tiered_rank<r>.pkl``."""
    import pickle

    import ps_tpu_torch as ps

    ps.init(backend="cuda", device="cuda:0", **_group_init(
        2, rank, port, dist_backend="gloo"))
    rows, dim, budget, full, ids, grads = _tiered_ranks_case()
    t = _tiered_table(rows, dim, budget, full, admit_freq=TIERED_ADMIT)
    t.mesh.calls.clear()
    _launch_counts(reset=True)
    logs = []
    for i in range(TIERED_RANK_PUSHES):
        half = ids[i].size // 2
        part = slice(rank * half, (rank + 1) * half)
        t.push(ids[i][part], torch.from_numpy(grads[i][part]).cuda())
        logs.append(t.pop_moves())
    res = {"launches": _launch_counts(), "logs": logs,
           "ops": sorted({c.op for c in t.mesh.calls})}
    res.update(_tiered_snapshot(t))
    with open(os.path.join(outdir, f"tiered_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    ps.shutdown()


def _tiered_two_ranks(tmp):
    """(c): two gloo ranks on the card, each pushing its half of each of
    (a)'s pushes at the cut depth, against one process on the whole
    pushes: move logs, directory, both tiers and the row sum bitwise."""
    import pickle

    import ps_tpu_torch as ps

    _run_pair("--tiered-ranks-worker", _free_port(), tmp)
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"tiered_rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    rows, dim, budget, full, ids, grads = _tiered_ranks_case()
    ps.init(backend="cuda")
    try:
        t = _tiered_table(rows, dim, budget, full, admit_freq=TIERED_ADMIT)
        logs = []
        for i in range(TIERED_RANK_PUSHES):
            t.push(ids[i], torch.from_numpy(grads[i]).cuda())
            logs.append(t.pop_moves())
        want = _tiered_snapshot(t)
    finally:
        ps.shutdown()
    if not want["promotions"] or not want["evictions"]:
        raise AssertionError(f"tiered (c): no churn: {want['promotions']} "
                             f"promotions, {want['evictions']} evictions")
    for r, got in enumerate(res):
        same = (got["logs"] == logs and got["hand"] == want["hand"]
                and got["row_sum"] == want["row_sum"]
                and all(np.array_equal(got["dir"][a], want["dir"][a])
                        for a in want["dir"])
                and all(np.array_equal(x, y) for x, y in zip(
                    [got["hot"], got["arena"]] + got["hot_state"]
                    + got["cold"], [want["hot"], want["arena"]]
                    + want["hot_state"] + want["cold"])))
        if not same:
            raise AssertionError(f"tiered (c): rank {r} is not one process "
                                 f"bitwise")
        n = TIERED_RANK_PUSHES
        if (got["launches"]["sparse_group"], got["launches"]["sparse_apply"]) \
                != (n, n) or not {"all_gather", "all_reduce",
                                  "broadcast"} <= set(got["ops"]):
            raise AssertionError(f"tiered (c): rank {r} launched "
                                 f"{got['launches']}, ran {got['ops']}")
    return {"launches": res[0]["launches"], "ops": res[0]["ops"],
            "rows": rows, "budget": budget, "ids": int(ids[0].size),
            "promotions": want["promotions"], "evictions": want["evictions"]}


def _tiered_served_launches(infos):
    """Each live server of (b) launched 2 grouping + 2 apply kernels a
    push it applied (its hot tiers'); the launches by kernel."""
    out = {"sparse_apply/deep": 0, "sparse_apply/wide": 0, "sparse_group": 0}
    for name, info in infos.items():
        n = len(info["applied"])
        got = info["launches"]
        if n == 0 or (got["apply"], got["group"], got["by_rule"]) != (
                2 * n, 2 * n, {"adagrad": n, "sgd": n}):
            raise AssertionError(f"tiered (b): server {name} launched {got} "
                                 f"for {n} pushes")
        out["sparse_apply/deep"] += got["by_rule"]["adagrad"]
        out["sparse_apply/wide"] += got["by_rule"]["sgd"]
        out["sparse_group"] += got["group"]
    return out


def phase_tiered(tmp, untiered=None):
    """23: tiered embedding storage on the card (ROADMAP item 5.7)."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t0 = time.perf_counter()
    ps.init(backend="cuda")
    try:
        a = _tiered_one_process(tmp)
    finally:
        ps.shutdown()
    t_a = time.perf_counter()
    log(f"tiered (a): W&D's deep table [{a['rows']:,}, 16] adagrad lr "
        f"{TIERED_LR} as a TieredTable of {a['budget']:,} slots on the card "
        f"(admit_freq {TIERED_ADMIT}) against an all-hot SparseEmbedding: "
        f"{TIERED_HOT_PUSHES} pushes confined to the hot set bitwise an "
        f"untiered budget table; {TIERED_WARMUP} + {TIERED_PUSHES} pushes "
        f"of {a['ids']:,} ids (zipf {TIERED_ZIPF}, a fresh batch a push, a "
        f"pull of a quarter every 4th timed push): "
        f"{a['still_hot']:,} rows hot since init bitwise, every row within "
        f"rtol {RTOL} / atol {ATOL} (max abs err {a['err']:.3g}, "
        f"{a['moved']:,} rows moved), row sum - all-hot {a['dsum']:.3g}; "
        f"{a['launches']['group']} grouping + {a['launches']['apply']} "
        f"apply launches; save/restore bitwise ({a['ckpt_s']:.2f} s); TTL "
        f"1 ms, {TIERED_TTL_PUSHES} pushes: {a['ttl_evictions']:,} "
        f"demotions, max abs err {a['ttl_err']:.3g}, row sum - all-hot "
        f"{a['ttl_dsum']:.3g}; {t_a - t0:.1f} s")
    log(f"tiered (a): {a['tiered_rows_per_s']:.0f} rows/s tiered against "
        f"{a['all_hot_rows_per_s']:.0f} all-hot "
        f"({a['tiered_rows_per_s'] / a['all_hot_rows_per_s']:.4f}x); hit "
        f"rate {a['hit_rate']:.4f}; {a['promotions_per_1k']:.1f} promotions "
        f"and {a['evictions_per_1k']:.1f} evictions per 1k pushes; cold "
        f"pass p50 {a['cold_p50_ms']:.4f} ms, p99 {a['cold_p99_ms']:.4f} ms "
        f"({a['cold_passes']} passes); hot tier {a['hot_bytes']:,} bytes on "
        f"the card against {a['all_hot_bytes']:,} all-hot; a push's ms by "
        f"stage over {TIERED_BREAKDOWN} more (host clock): "
        f"{json.dumps(a['breakdown'])}; card {card}")
    b = _tiered_served(harness, tmp)
    t_b = time.perf_counter()
    served = _tiered_served_launches({k: b[k] for k in ("b0", "p1", "b1")})
    m = b["numbers"]
    rate = (untiered or {}).get("cycles_per_s", 0.0)
    tier = {f"{s}/{n}": b[k]["tier"][n] for s, k in ((0, "b0"), (1, "p1"))
            for n in ("deep", "wide")}
    log(f"tiered (b): {SPARSE_SHARDS} shards x (a tiered serve_sparse "
        f"primary on the native loop, budget rows // {TIERED_DIV} = 325,000 "
        f"slots a table, + a sync-ack backup), {SPARSE_WORKERS} workers x "
        f"{TIERED_CYCLES} cycles over TCP: at cycle {TIERED_KILL_AT} every "
        f"backup's directory, hot table, arena and cold state bitwise its "
        f"primary's; a conditional read_rows after tier moves bitwise a "
        f"pull; checkpoint_all at cycle {TIERED_CUE_AT} mid-traffic "
        f"({b['ckpt_s']:.3f} s) restored into fresh services bitwise the "
        f"logs' first pushes; primary 0 SIGKILLed, backup 0 promoted, each "
        f"push applied once, the logs replayed through tiered tables "
        f"bitwise the servers', row sums - all-hot replay {b['dsum']}; "
        f"launches {served}; {t_b - t_a:.1f} s")
    log(f"tiered (b): {m['cycles_per_s']:.2f} cycles/s before the kill "
        f"(median cycle {m['median_cycle_ms']:.3f} ms, push "
        f"{m['push_ms']:.3f} ms) against phase 17's untiered {rate:.2f}; "
        f"tier_stats {json.dumps(tier)}")
    c = _tiered_two_ranks(tmp)
    t_c = time.perf_counter()
    log(f"tiered (c): two gloo ranks on the card, [{c['rows']:,}, 16] at "
        f"{c['budget']:,} slots, {TIERED_RANK_PUSHES} pushes of "
        f"{c['ids']:,} ids split over the ranks ({c['promotions']} "
        f"promotions, {c['evictions']} evictions): move logs, directory, "
        f"both tiers and the row sum bitwise one process; a rank's launches "
        f"{c['launches']}, collectives {c['ops']}; {t_c - t_b:.1f} s; "
        f"phase {t_c - t0:.1f} s")
    launches = {
        "sparse_group": {"one_process": a["launches"]["group"],
                         "served": served["sparse_group"],
                         "two_ranks_rank": c["launches"]["sparse_group"]},
        "sparse_apply/deep": {"one_process": a["launches"]["apply"],
                              "served": served["sparse_apply/deep"],
                              "two_ranks_rank": c["launches"]["sparse_apply"]},
        "sparse_apply/wide": {"one_process": 0,
                              "served": served["sparse_apply/wide"],
                              "two_ranks_rank": 0}}
    return {"launches": launches, "a": a, "b": b, "c": c,
            "seconds": t_c - t0}


# -- phase 24: observability on the card (ROADMAP item 6.1) ------------------

# (a)-(b): phase 20's layout, every server on the native loop; a worker's
# cycles: OBS_UNTRACED at sample 0, OBS_TRACED at 1.0 (the pause after
# them: the traces exported, the counts scraped, primary 0 SIGKILLed),
# then OBS_AFTER through the failover
OBS_UNTRACED, OBS_TRACED, OBS_AFTER = 10, 20, 10
OBS_CYCLES = OBS_UNTRACED + OBS_TRACED + OBS_AFTER
OBS_CUE_AT = OBS_UNTRACED + OBS_TRACED // 2  # the mid-traffic scrape
OBS_PAUSE_AT = OBS_UNTRACED + OBS_TRACED
OBS_PUSH_OPS = ("push", "push_pull")
# (d): three workers against one shard, a push every OBS_STEP_S of
# compute, worker 2 slowed by OBS_SLOW_S a push for OBS_SLOW_FOR_S; the
# rule and the detector read 1 s windows, evaluated after OBS_WARM_S
OBS_SLO_RULE = "push p99 < 60ms over 1s"
OBS_STEP_S, OBS_SLOW_S = 0.005, 0.1
OBS_WARM_S, OBS_SLOW_FOR_S, OBS_RECOVER_S = 1.0, 2.0, 3.0
OBS_SAMPLE_EVERY_S = 0.1


def _obs_spawn(harness, out, device, shape, detector_port):
    """Phase 20 (a)'s processes with tracing: each shard a primary (on the
    loop, sync ack, /metrics) and its backup with a PromotionWatch; primary
    0 also beats this process's failure detector; the workers dial the
    replica sets over TCP and trace cycles [OBS_UNTRACED, OBS_PAUSE_AT)."""
    os.makedirs(out)
    watch = [harness.free_port(harness.socket.SOCK_DGRAM)
             for _ in range(SPARSE_SHARDS)]
    spawn = lambda s, opts: harness.spawn(  # noqa: E731
        "sparse-server", out, SPARSE_WORKERS, OBS_CYCLES, s, SPARSE_SHARDS,
        device, shape, json.dumps(dict(opts, native_loop=True, digests=True,
                                       obs=True)))
    backups = [spawn(s, {"backup": True, "watch_port": watch[s],
                         "watch_timeout_ms": REPL_WATCH_MS})
               for s in range(SPARSE_SHARDS)]
    primaries = [spawn(s, {"replicate": True, "ack": "sync", "window": 256,
                           "watch_port": watch[s], "metrics": True,
                           "detector_port": detector_port if s == 0
                           else None})
                 for s in range(SPARSE_SHARDS)]
    workers = [harness.spawn(
        "sparse-worker", f"@{SPARSE_SHARDS}", out, w, OBS_CYCLES, device,
        shape, SPARSE_WORKERS, 0, json.dumps({
            "replicas": True, "pause_at": OBS_PAUSE_AT,
            "cue_at": OBS_CUE_AT, "obs": True,
            "trace": [OBS_UNTRACED, OBS_PAUSE_AT]}))
        for w in range(SPARSE_WORKERS)]
    return backups, primaries, workers


def _prometheus(text):
    """``name{labels} -> value`` of every sample line; raises on a line
    that is not the exposition format."""
    out = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name, val = line.rsplit(" ", 1)
        if not name or " " in name.strip():
            raise AssertionError(f"not Prometheus text: {line!r}")
        out[name.strip()] = float(val)
    return out


def _obs_scrape(out, name):
    import urllib.request

    with open(os.path.join(out, f"metrics{name}")) as f:
        port = int(f.read())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        if not resp.headers["Content-Type"].startswith("text/plain"):
            raise AssertionError(f"/metrics of {name}: "
                                 f"{resp.headers['Content-Type']}")
        return _prometheus(resp.read().decode())


def _obs_stats(out, shard):
    from ps_tpu_torch.control import tensor_van as tv

    with open(os.path.join(out, f"port{shard}")) as f:
        ch = tv.Channel.connect("127.0.0.1", int(f.read()))
    try:
        return tv.decode(ch.request(tv.encode(tv.STATS, 0, None)))[3]
    finally:
        ch.close()


def _obs_spans(out):
    """Every process's Chrome export merged (each already on shard 0's
    primary's clock): the ``X`` events, and each process's clock error
    (µs) by pid."""
    from ps_tpu_torch.obs import merge_chrome

    names = [f[6:-5] for f in sorted(os.listdir(out))
             if f.startswith("trace-") and f.endswith(".json")]
    merged = merge_chrome([os.path.join(out, f"trace-{n}.json")
                           for n in names],
                          os.path.join(out, "trace-merged.json"))
    events = json.load(open(merged))["traceEvents"]
    err_by_name = {n: json.load(open(os.path.join(out, f"clock-{n}.json")))
                   ["err_us"] for n in names}
    err = {e["pid"]: err_by_name[e["args"]["name"]] for e in events
           if e["ph"] == "M"}
    return [e for e in events if e["ph"] == "X"], err, names


def _obs_trees(spans, err, workers, traced):
    """Every traced push a tree across the processes: the worker's op ->
    each shard's primary serve span -> exactly one ``server_apply`` with
    the backup's ``replica_append`` under it and the primary's
    ``replica_ack_wait`` beside it; every span of the trace reaches the
    root; each child lies inside its parent within the two processes'
    clock errors (a replica append, streamed while the apply's reply
    waits for its ack, inside its primary's serve span). Returns (roots,
    serve spans, the worst margin in µs, the push trees' events, each
    push's critical path: the slowest shard's serve span cut into the
    time before its apply, the apply, the ack wait and the rest, the
    worker's op beyond it (client and wire), and the backup's append)."""
    by_trace = {}
    for e in spans:
        by_trace.setdefault(e["args"]["trace_id"], []).append(e)
    roots = [e for e in spans if e["cat"] == "worker"
             and e["args"]["parent_id"] is None
             and e["name"] in OBS_PUSH_OPS]
    if len(roots) != workers * traced:
        raise AssertionError(f"obs (a): {len(roots)} traced push roots, "
                             f"{workers} x {traced} were sent")
    serves, margin, trees, paths = 0, float("inf"), [], []
    for root in roots:
        tree = by_trace[root["args"]["trace_id"]]
        trees += tree
        by_id = {e["args"]["span_id"]: e for e in tree}
        kids = {}
        for e in tree:
            kids.setdefault(e["args"]["parent_id"], []).append(e)

        def inside(child, parent):
            tol = (0.0 if child["pid"] == parent["pid"]
                   else err[child["pid"]] + err[parent["pid"]])
            return min(child["ts"] - parent["ts"],
                       (parent["ts"] + parent["dur"])
                       - (child["ts"] + child["dur"])) + tol

        for e in tree:
            hop, seen = e, 0
            while hop["args"]["parent_id"] is not None and seen < 16:
                hop, seen = by_id.get(hop["args"]["parent_id"]), seen + 1
                if hop is None:
                    raise AssertionError(f"obs (a): {e['name']} of "
                                         f"{root['name']}'s trace does not "
                                         f"reach its root")
            if hop is not root:
                raise AssertionError(f"obs (a): a second root in "
                                     f"{root['name']}'s trace")
        mine = [e for e in kids.get(root["args"]["span_id"], [])
                if e["cat"] == "server"]
        if not 1 <= len(mine) <= SPARSE_SHARDS or any(
                e["args"].get("role") != "primary" for e in mine):
            raise AssertionError(f"obs (a): {root['name']} has serve spans "
                                 f"{[(e['name'], e['args']) for e in mine]}")
        for serve in mine:
            serves += 1
            margin = min(margin, inside(serve, root))
            under = kids.get(serve["args"]["span_id"], [])
            applies = [e for e in under if e["name"] == "server_apply"]
            acks = [e for e in under if e["name"] == "replica_ack_wait"]
            if len(applies) != 1 or not acks:
                raise AssertionError(
                    f"obs (a): serve span {serve['name']} holds "
                    f"{[e['name'] for e in under]}")
            appends = [e for e in kids.get(applies[0]["args"]["span_id"], [])
                       if e["name"] == "replica_append"
                       and e["args"].get("role") == "backup"]
            if len(appends) != 1 or appends[0]["pid"] == serve["pid"]:
                raise AssertionError(f"obs (a): server_apply holds "
                                     f"{len(appends)} backup appends")
            for child in applies + acks:
                margin = min(margin, inside(child, serve))
            margin = min(margin, inside(appends[0], serve))
            serve["_path"] = (applies[0], acks, appends[0])
        slow = max(mine, key=lambda e: e["dur"])
        apply_, acks, append = slow.pop("_path")
        ack = sum(e["dur"] for e in acks)
        pre = apply_["ts"] - slow["ts"]
        paths.append({"op": root["dur"], "client_wire": root["dur"]
                      - slow["dur"], "serve_pre_apply": pre,
                      "server_apply": apply_["dur"], "replica_ack_wait": ack,
                      "serve_rest": slow["dur"] - pre - apply_["dur"] - ack,
                      "backup_append": append["dur"]})
        for e in mine:
            e.pop("_path", None)
    if margin < 0:
        raise AssertionError(f"obs (a): a child span lies {-margin:.1f} µs "
                             f"outside its parent past the clock error")
    return roots, serves, margin, trees, paths


def _obs_path_table(paths):
    """Each critical-path phase's mean (ms) and share of the op."""
    op = float(np.mean([p["op"] for p in paths]))
    return {k: {"mean_ms": round(float(np.mean([p[k] for p in paths]))
                                 / 1e3, 4),
                "share": round(float(np.mean([p[k] for p in paths])) / op,
                               4)}
            for k in paths[0]}


def _obs_segment(records, lo, hi):
    """Cycles/s of cycles [lo, hi) over the workers' shared window, and
    their median cycle."""
    cycles, start, end = [], None, None
    for r in records:
        for c in range(lo, hi):
            t0, dt = r["starts"][c], r["cycle_s"][c]
            cycles.append(dt)
            start = t0 if start is None else min(start, t0)
            end = t0 + dt if end is None else max(end, t0 + dt)
    return {"cycles_per_s": len(cycles) / (end - start),
            "median_cycle_ms": float(np.median(cycles)) * 1e3}


def _obs_launches(counts):
    """A server's launch counts by kernel entry: the grouping pass, and the
    apply by rule (adagrad: the deep table, sgd: the wide one)."""
    rule = counts["by_rule"]
    return {"sparse_group": counts["group"],
            "sparse_apply/deep": rule.get("adagrad", 0),
            "sparse_apply/wide": rule.get("sgd", 0)}


def _obs_flight(out, name):
    path = os.path.join(out, f"flight-{name}.jsonl")
    with open(path) as f:
        return [json.loads(x) for x in f][1:]


def _obs_sparse(harness, tmp, device="cuda", shape="wd"):
    """(a) and (b) as processes; returns the checked numbers."""
    import signal

    import ps_tpu_torch as ps
    from ps_tpu_torch import obs
    from ps_tpu_torch.control.heartbeat import (FailureDetector,
                                                WorkerFailureError)
    from ps_tpu_torch.obs import TraceBreakdown
    from ps_tpu_torch.ops import sparse_apply as ops

    out = os.path.join(tmp, "a")
    det = FailureDetector(node_id=0, peers={}, timeout_ms=REPL_WATCH_MS,
                          bind="127.0.0.1")
    procs = _obs_spawn(harness, out, device, shape, det.server.port)
    backups, primaries, workers = procs
    everyone = backups + primaries + workers
    try:
        _wait_files([os.path.join(out, f"cue{w}")
                     for w in range(SPARSE_WORKERS)], everyone)
        mid = [_obs_scrape(out, f"p{s}") for s in range(SPARSE_SHARDS)]
        _wait_files([os.path.join(out, f"paused{w}")
                     for w in range(SPARSE_WORKERS)], everyone)
        scraped = [_obs_scrape(out, f"p{s}") for s in range(SPARSE_SHARDS)]
        stats = [_obs_stats(out, s) for s in range(SPARSE_SHARDS)]
        with open(os.path.join(out, "snap"), "w") as f:
            f.write("1")
        _wait_files([os.path.join(out, f"snap{s}{t}.json")
                     for s in range(SPARSE_SHARDS) for t in ("", "b")],
                    everyone)
        t_kill = time.time()
        primaries[0].send_signal(signal.SIGKILL)
        primaries[0].wait(timeout=30)
        with open(os.path.join(out, "resume"), "w") as f:
            f.write("1")
        deadline = time.monotonic() + 30
        while True:
            try:
                det.check()
            except WorkerFailureError as e:
                dead = e.dead
                break
            if time.monotonic() > deadline:
                raise AssertionError("obs (b): the detector never saw "
                                     "primary 0 die")
            time.sleep(0.01)
        obs.flight().dump("phase 24 (b)",
                          path=os.path.join(out, "flight-detector.jsonl"))
        infos, records = _repl_finish(harness, out, procs, [primaries[0]],
                                      "obs (a)")
    finally:
        harness.kill_all(everyone)
        det.close()
    # /metrics: parsed mid-traffic, and at the pause each primary's apply
    # histogram counts exactly the pushes it served
    for s in range(SPARSE_SHARDS):
        if mid[s].get("ps_server_apply_seconds_count", 0) < 1:
            raise AssertionError(f"obs (a): primary {s}'s mid-traffic "
                                 f"scrape counts no apply")
        st, m = stats[s], scraped[s]
        want = (st["apply_log_total"], st["fused"]["rows_applied"])
        got = (m["ps_server_apply_seconds_count"],
               m["ps_sparse_rows_applied_total"])
        if got != want or st["metrics"]["lat"]["apply_s"]["count"] != \
                want[0] or m['ps_server_apply_seconds_bucket{le="+Inf"}'] \
                != want[0]:
            raise AssertionError(f"obs (a): primary {s}'s /metrics "
                                 f"{got} against STATS {want}")
    # the traces
    spans, err, names = _obs_spans(out)
    roots, serves, margin, trees, paths = _obs_trees(
        spans, err, SPARSE_WORKERS, OBS_TRACED)
    tb = TraceBreakdown()
    if tb.feed(trees) != len(roots):
        raise AssertionError("obs (a): the breakdown lost a push")
    # launches: the servers' (traced) against the same pushes replayed
    # untraced in this process, and the tables bitwise
    b0, p1, b1 = infos["0b"], infos["1"], infos["1b"]
    ps.init(backend="cuda", device=device)
    try:
        _launch_counts(reset=True)
        tables, _ = harness.sparse_replay([b0, p1], shape, SPARSE_WORKERS,
                                          OBS_CYCLES)
        replay = _obs_launches({"group": _launch_counts()["sparse_group"],
                                "by_rule": dict(ops.LAUNCHES_BY_RULE)})
        digests = [harness.table_digests(t) for t in tables]
    finally:
        ps.shutdown()
    served = {k: _obs_launches(b0["launches"])[k]
              + _obs_launches(p1["launches"])[k] for k in replay}
    if device == "cuda" and (replay != served
                             or b1["launches"] != p1["launches"]
                             or not served["sparse_group"]):
        raise AssertionError(f"obs (a): traced launches {served} (backup 1 "
                             f"{b1['launches']}, primary 1 "
                             f"{p1['launches']}) against {replay} untraced")
    if digests != [b0["digests"], p1["digests"]] or \
            b1["digests"] != p1["digests"]:
        raise AssertionError("obs (a): the replay is not bitwise the "
                             "servers' tables")
    # (b): each process's dump holds its event
    rep = b0["replica"]
    if (rep["role"], rep.get("promote_reason")) != ("primary", "timeout"):
        raise AssertionError(f"obs (b): backup 0 did not promote: {rep}")
    flights = {w: _obs_flight(out, f"w{w}") for w in range(SPARSE_WORKERS)}
    backup0 = _obs_flight(out, "b0")
    detector = _obs_flight(out, "detector")
    fo = {w: [e for e in ev if e["kind"] == "failover"]
          for w, ev in flights.items()}
    promo = [e for e in backup0 if e["kind"] == "promotion"]
    fired = [e for e in backup0 if e["kind"] == "promotion_watch_fired"]
    # this process's ring may hold an earlier phase's events
    died = [e for e in detector if e["kind"] == "peer_dead"
            and e["t"] >= t_kill]
    if not all(len(f) == 1 and f[0]["shard"] == 0 and f[0]["epoch"] == 1
               for f in fo.values()) or len(promo) != 1 or \
            len(fired) != 1 or len(died) != 1 or died[0]["dead"] != [10] \
            or dead != [10]:
        raise AssertionError(f"obs (b): failovers {fo}, promotion {promo}, "
                             f"watch {fired}, detector {died}")
    if not (t_kill <= fired[0]["t"] <= promo[0]["t"]
            <= min(f[0]["t"] for f in fo.values()) and t_kill
            <= died[0]["t"]):
        raise AssertionError(
            f"obs (b): out of order: kill {t_kill}, watch {fired[0]['t']}, "
            f"promotion {promo[0]['t']}, failovers "
            f"{[f[0]['t'] for f in fo.values()]}, detector {died[0]['t']}")
    return {
        "roots": len(roots), "serves": serves, "margin_us": margin,
        "err_us": max(err.values()), "processes": len(names),
        "breakdown": tb.summary(), "path": _obs_path_table(paths),
        "untraced": _obs_segment(records, 1, OBS_UNTRACED),
        "traced": _obs_segment(records, OBS_UNTRACED, OBS_PAUSE_AT),
        "scrape": [{k: m[k] for k in ("ps_server_apply_seconds_count",
                                      "ps_sparse_rows_applied_total",
                                      "ps_server_requests_total")}
                   for m in scraped],
        "launches": served, "replay_launches": replay,
        "flight": {"kill": t_kill, "watch": fired[0]["t"] - t_kill,
                   "promotion": promo[0]["t"] - t_kill,
                   "failovers": sorted(f[0]["t"] - t_kill
                                       for f in fo.values()),
                   "peer_dead": died[0]["t"] - t_kill}}


def _obs_agg(harness, device="cuda"):
    """(c): two member workers -> an aggregator -> a shard on the card, in
    this process, traced: the shard's apply and the aggregator's merge in
    one trace that reaches a member's op, the apply naming every member's
    trace context."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch import obs
    from ps_tpu_torch.backends.aggregator import AggregatorService
    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.obs import TraceBreakdown

    fan_in = 2
    params0, store, svc = _agg_upstream(harness, device=device)
    like = {k: torch.from_numpy(v) for k, v in params0.items()}
    agg = AggregatorService(f"127.0.0.1:{svc.port}", like,
                            group_size=fan_in)
    ws = [connect_async(f"127.0.0.1:{svc.port}", w, like,
                        aggregator=f"127.0.0.1:{agg.port}")
          for w in range(fan_in)]
    tracer = obs.tracer()
    tracer.clear()
    tracer.sample = 1.0
    errs = []

    def member(w):
        try:
            ws[w].pull_all()
            for c in range(2):
                ws[w].push_pull({k: torch.from_numpy(v) for k, v in
                                 harness.agg_grads(params0, w, c).items()})
        except BaseException as e:  # surfaced below
            errs.append(e)

    try:
        ts = [threading.Thread(target=member, args=(w,))
              for w in range(fan_in)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        if errs or any(t.is_alive() for t in ts):
            raise AssertionError(f"obs (c): a member failed: {errs}")
    finally:
        tracer.sample = 0.0
        for w in ws:
            w.close()
        agg.stop()
        svc.stop()
        ps.shutdown()
    spans = tracer.spans()
    tracer.clear()
    by_id = {s.span_id: s for s in spans}
    applies = [s for s in spans if s.name == "server_apply"]
    merges = [s for s in spans if s.name == "agg_merge"]
    if len(applies) != 2 or len(merges) != 2:
        raise AssertionError(f"obs (c): {len(applies)} applies, "
                             f"{len(merges)} merges for 2 rounds")
    chains = []
    for a in applies:
        chain, cur = [], a
        while cur is not None:
            chain.append((cur.cat, cur.name))
            cur = by_id.get(cur.parent_id)
        if ("aggregator", "agg_merge") not in chain or \
                chain[-1][0] != "worker" or \
                len(a.args.get("members_tc") or {}) != fan_in:
            raise AssertionError(f"obs (c): the apply's chain {chain}, "
                                 f"members_tc {a.args.get('members_tc')}")
        chains.append([n for _, n in chain])
    tb = TraceBreakdown()
    tb.feed(spans)
    return {"chain": chains[0], "agg": tb.summary().get("agg")}


def _obs_slo():
    """(d): three workers pushing to one dense shard on the card (the MNIST
    MLP at 784-256-10, OBS_STEP_S of compute between pushes), worker 2
    slowed by OBS_SLOW_S a push for OBS_SLOW_FOR_S; the process registry
    (SLO) and each worker's push histogram (straggler) sampled into 1 s
    windows every OBS_SAMPLE_EVERY_S and evaluated after OBS_WARM_S: the
    rule breaches while worker 2 is slow and every breach recovers, the
    detector names worker 2 alone and at the end nobody."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch import obs
    from ps_tpu_torch.backends.remote_async import AsyncPSService, \
        connect_async
    from ps_tpu_torch.models.mlp import MLP
    from ps_tpu_torch.kv import keys as keymod

    nw = 3
    ps.init(backend="cuda", mode="async", num_workers=nw, dc_lambda=0.0)
    tree = MLP(hidden=256).init(torch.Generator().manual_seed(0))
    flat, _ = keymod.flatten_with_keys(tree)
    store = ps.KVStore(optimizer="sgd", learning_rate=0.01, mode="async")
    store.init({k: v.cuda() for k, v in flat.items()})
    svc = AsyncPSService(store)
    ws = [connect_async(f"127.0.0.1:{svc.port}", w, dict(flat))
          for w in range(nw)]
    slow, stop = threading.Event(), threading.Event()
    fanout = ws[2]._fanout

    def slowed(msgs):
        if slow.is_set():
            time.sleep(OBS_SLOW_S)
        return fanout(msgs)

    ws[2]._fanout = slowed
    grads = {k: torch.full_like(v, 1e-3) for k, v in flat.items()}
    errs = []

    def loop(w):
        try:
            while not stop.is_set():
                time.sleep(OBS_STEP_S)
                ws[w].push_all(grads)
        except BaseException as e:  # surfaced below
            errs.append(e)

    reg_win = obs.RegistryWindow(window_s=1.0)
    member_win = obs.RegistryWindow(window_s=1.0)
    rule = obs.SloEvaluator(reg_win, obs.parse_rules(OBS_SLO_RULE))
    strag = obs.StragglerDetector(member_win, metrics=("ps_push_seconds",),
                                  z=3.0, min_members=nw, min_count=3)
    n0 = len(obs.flight().events())
    timeline = []
    ts = [threading.Thread(target=loop, args=(w,)) for w in range(nw)]
    for t in ts:
        t.start()
    try:
        t0 = time.monotonic()
        phases = ((OBS_WARM_S, False), (OBS_SLOW_FOR_S, True),
                  (OBS_RECOVER_S, False))
        for k, (dur, is_slow) in enumerate(phases):
            (slow.set if is_slow else slow.clear)()
            end = time.monotonic() + dur
            while time.monotonic() < end:
                time.sleep(OBS_SAMPLE_EVERY_S)
                reg_win.sample_registry("local")
                for w in range(nw):
                    member_win.sample(f"w{w}", {"ps_push_seconds":
                                                ws[w].transport.hist[
                                                    "push_s"]})
                if k == 0:
                    continue  # the windows fill past the connects first
                state = rule.evaluate()[0]
                suspects = [s["uri"] for s in strag.evaluate()]
                timeline.append((round(time.monotonic() - t0, 2), is_slow,
                                 state["breached"], state["value_ms"],
                                 suspects))
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=30)
        for w in ws:
            w.close()
        svc.stop()
        ps.shutdown()
    if errs:
        raise AssertionError(f"obs (d): a worker failed: {errs}")
    events = [e["kind"] for e in obs.flight().events()[n0:]
              if e["kind"] in ("slo_breach", "slo_recover",
                               "straggler_suspect")]
    breached = [x for x in timeline if x[2]]
    named = {s for x in timeline for s in x[4]}
    last = timeline[-1]
    if not breached or not breached[0][1] or last[2] \
            or named != {"w2"} or last[4] \
            or events.count("slo_breach") < 1 \
            or events.count("slo_breach") != events.count("slo_recover") \
            or events.count("straggler_suspect") < 1:
        raise AssertionError(f"obs (d): timeline {timeline}, events "
                             f"{events}")
    pushes = [ws[w].transport.hist["push_s"].summary() for w in range(nw)]
    return {"breach_at": breached[0][0], "recover_at": next(
                x[0] for x in timeline if x[0] > breached[-1][0]),
            "peak_ms": max(x[3] or 0 for x in timeline), "events": events,
            "push_p50_ms": [round(p["p50"] * 1e3, 3) for p in pushes],
            "samples": len(timeline)}


def phase_obs(tmp):
    """24: observability on the card (ROADMAP item 6.1)."""
    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t0 = time.perf_counter()
    a = _obs_sparse(harness, tmp)
    t_a = time.perf_counter()
    u, tr = a["untraced"], a["traced"]
    log(f"obs (a): {SPARSE_SHARDS} shards x (a serve_sparse primary on the "
        f"native loop at W&D's width + a sync-ack backup), "
        f"{SPARSE_WORKERS} workers x {OBS_TRACED} traced cycles of 13,312 "
        f"ids (after {OBS_UNTRACED} untraced): {a['roots']} push traces, "
        f"each one tree across {a['processes']} processes (worker op -> "
        f"{a['serves']} primary serve spans -> server_apply -> the backup's "
        f"replica_append, replica_ack_wait beside it); merged on shard 0's "
        f"clock every child inside its parent, worst margin "
        f"{a['margin_us']:.1f} us, clock error at most {a['err_us']:.1f} "
        f"us; /metrics parsed mid-traffic and at the pause each primary's "
        f"apply count and rows equal its STATS {a['scrape']}; launches "
        f"{a['launches']} traced = {a['replay_launches']} replayed "
        f"untraced, tables bitwise; {t_a - t0:.1f} s")
    log(f"obs (a): cycles/s at sample 1.0 {tr['cycles_per_s']:.2f} (median "
        f"cycle {tr['median_cycle_ms']:.3f} ms) against 0.0 "
        f"{u['cycles_per_s']:.2f} ({u['median_cycle_ms']:.3f} ms); "
        f"a push's critical path (mean ms, share of the worker's op): "
        f"{json.dumps(a['path'])}; TraceBreakdown (s): "
        f"{json.dumps(a['breakdown'])}; card {card}")
    f = a["flight"]
    log(f"obs (b): primary 0 SIGKILLed after cycle {OBS_PAUSE_AT}: backup 0's"
        f" dump holds promotion_watch_fired (+{f['watch']:.3f} s) and "
        f"promotion (+{f['promotion']:.3f} s), each worker's its failover "
        f"(+{', +'.join(f'{x:.3f}' for x in f['failovers'])} s), this "
        f"process's detector's peer_dead (+{f['peer_dead']:.3f} s)")
    c = _obs_agg(harness)
    t_c = time.perf_counter()
    log(f"obs (c): 2 members -> an aggregator -> a shard on the card, 2 "
        f"traced rounds: each shard apply's chain {' <- '.join(c['chain'])}"
        f", naming both members' traces; agg phase {json.dumps(c['agg'])}; "
        f"{t_c - t_a:.1f} s")
    d = _obs_slo()
    t_d = time.perf_counter()
    log(f"obs (d): '{OBS_SLO_RULE}' over the process registry and a "
        f"straggler detector over each worker's push histogram, worker 2 "
        f"slowed {OBS_SLOW_S * 1e3:.0f} ms a push for {OBS_SLOW_FOR_S} s: "
        f"breach at {d['breach_at']} s (p99 up to {d['peak_ms']} ms), "
        f"recovery at {d['recover_at']} s, suspects named w2 only; events "
        f"{d['events']}; push p50 by worker {d['push_p50_ms']} ms; "
        f"{t_d - t_c:.1f} s; phase {t_d - t0:.1f} s")
    return {"launches": a["launches"], "a": a, "c": c, "d": d,
            "seconds": t_d - t0}


# -- phase 25: elastic membership on the card ----------------------------------
# (a) config 5's MLP at 784-256-10 (momentum, lr 0.1, DC λ 0.04) on two
# card-resident AsyncPSService processes under a coordinator, two empty
# standbys joined beside them; three worker threads of this process on
# connect_async(coordinator=) x 40 cycles of batch 64; a split 2 -> 4 at
# cycle 10 and a drain back to 2 at cycle 25; the workers pause at cycle
# 30 for (d)'s telemetry window. (b) the 442,939,392-byte tree on two
# shards, one bucketed worker x 10 cycles, split to 3 at cycle 3. (c)
# phase 17's sparse shards under a coordinator, three worker processes x
# 20 cycles; shard 1 replaced at cycle 10 by a process restored from its
# save at the workers' pause. (d) (a)'s members' telemetry at two quiet
# points, and the policy engine on two skewed two-shard fleets (one
# acting, one dry).
EL_WORKERS, EL_CYCLES, EL_BATCH, EL_HIDDEN = 3, 40, 64, 256
EL_SPLIT_AT, EL_DRAIN_AT, EL_QUIET_AT = 10, 25, 30
EL_LR, EL_DC = 0.1, 0.04
EL_REPORT_MS = 100
# a quiet point lasts EL_QUIET_S (eight report cadences); the telemetry
# window starts at the end of the first
EL_QUIET_S = 0.8
EL_BERT_CYCLES, EL_BERT_SPLIT_AT = 10, 3
EL_BERT_BUCKET, EL_BERT_POOL = 4 << 20, 2
EL_SPARSE_CYCLES, EL_SPARSE_STOP_AT = 20, 10
EL_POLICY_KEYS, EL_POLICY_SHAPE = 8, (256, 1024)
EL_POLICY = dict(report_ms=50, telemetry_window_s=0.4, max_skew=2.0,
                 policy_burn_windows=3, policy_cooldown_s=60.0)
EL_TIMEOUT_S = 300


def _el_alive(procs):
    """Fail when one of ``procs`` died, with the end of its log."""
    for p in procs:
        if p.poll() is not None and p.returncode != 0:
            log_ = getattr(p, "log_path", None)
            tail = (open(log_).read()[-3000:] if log_ else
                    (p.communicate()[0] or "")[-3000:])
            raise AssertionError(f"{' '.join(map(str, p.args[-4:]))} "
                                 f"exited {p.returncode}:\n{tail}")


def _el_wait(path, timeout=EL_TIMEOUT_S, procs=()):
    """Wait for a file; fail at once when one of ``procs`` died."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        _el_alive(procs)
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)


def _el_write(path, text):
    with open(path + ".tmp", "w") as f:
        f.write(str(text))
    os.replace(path + ".tmp", path)


def _el_read(path):
    with open(path) as f:
        return f.read().strip()


def _el_spawn(flag, out, *args):
    """One internal role of this script, its output in ``out``'s
    ``log-<role>-<name>``."""
    here, env = _van_env()
    path = os.path.join(out, f"log{flag}-{args[0] if args else ''}")
    with open(path, "w") as f:
        p = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), flag, out,
             *map(str, args)], cwd=here, env=env, stdout=f,
            stderr=subprocess.STDOUT, text=True)
    p.log_path = path
    return p


def _el_tree(kind, device):
    """The trees of phase 25's servers and workers, made alike in every
    process: (a)'s MLP (lecun-normal kernels from seed 0), (b)'s
    BERT-base-shaped tree (normal draws from a generator on ``device``,
    one seed a key) and the policy fleets' blocks."""
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.models.mlp import MLP

    if kind == "mlp":
        flat, _ = keymod.flatten_with_keys(
            MLP(hidden=EL_HIDDEN).init(torch.Generator().manual_seed(0)))
        return {k: v.to(device) for k, v in flat.items()}
    if kind == "blocks":
        return {f"b{i}": torch.zeros(EL_POLICY_SHAPE, device=device)
                for i in range(EL_POLICY_KEYS)}
    out = {}
    for i, (k, shape) in enumerate(sorted(_el_bert_shapes().items())):
        g = torch.Generator(device=device).manual_seed(100 + i)
        out[k] = torch.empty(shape, device=device).normal_(0.0, 0.02,
                                                           generator=g)
    return out


def _el_bert_shapes():
    """:func:`_bert_like_tree`'s keys and shapes, allocated nowhere."""
    shapes = {"embed/word": (30522, 768)}
    total, i = 30522 * 768 * 4, 0
    while total < BERT_LIKE_MB * 1e6:
        shapes[f"layer{i // 4}/block{i % 4}"] = (768, 3072)
        total += 768 * 3072 * 4
        i += 1
    return shapes


def _el_bert_split(shapes):
    """(b)'s two initial key ranges: the largest key first onto the
    lighter shard."""
    size = {k: int(np.prod(v)) for k, v in shapes.items()}
    parts, load = ([], []), [0, 0]
    for k in sorted(size, key=lambda k: (-size[k], k)):
        s = 0 if load[0] <= load[1] else 1
        parts[s].append(k)
        load[s] += size[k]
    return [sorted(p) for p in parts]


def _el_bert_grads(tree, c):
    """(b)'s worker's cycle-``c`` gradients, a constant a key (the DC
    correction still varies them elementwise)."""
    return {k: torch.full_like(v, 1e-4 * (c + 1) * (1 + i % 5))
            for i, (k, v) in enumerate(sorted(tree.items()))}


def _el_row_digest(row):
    import hashlib

    h = hashlib.sha256()
    h.update(row["param"].cpu().numpy().tobytes())
    for p in sorted(row["state"]):
        h.update(p.encode())
        h.update(row["state"][p].cpu().numpy().tobytes())
    for w in sorted(row["stale"]):
        h.update(str(w).encode())
        h.update(row["stale"][w].cpu().numpy().tobytes())
    h.update(str(int(row["apply_count"])).encode())
    return h.hexdigest()


def _elastic_coords(out):
    """Internal role: the phase's coordinators in one process that holds
    no device. Writes ``coord-<name>`` (its ``host:port``) a coordinator,
    serves until ``coords-stop``, then dumps ``coords.json``: each one's
    moves, policy state and audit, and whether this process ever
    initialized CUDA."""
    from ps_tpu_torch.elastic import Coordinator

    specs = {"a": dict(report_ms=EL_REPORT_MS, telemetry_window_s=60.0),
             "b": dict(report_ms=EL_REPORT_MS),
             "c": dict(report_ms=EL_REPORT_MS),
             "act": dict(policy="on", **EL_POLICY),
             "dry": dict(policy="dry", **EL_POLICY)}
    coords = {name: Coordinator(**kw) for name, kw in specs.items()}
    for name, c in coords.items():
        _el_write(os.path.join(out, f"coord-{name}"), f"127.0.0.1:{c.port}")
    _el_wait(os.path.join(out, "coords-stop"), timeout=1200)
    dump = {"cuda_initialized": torch.cuda.is_initialized(),
            "moves": {n: c.moves_done for n, c in coords.items()},
            "epochs": {n: c.table().epoch for n, c in coords.items()}}
    for c in coords.values():
        c.stop()
    _el_write(os.path.join(out, "coords.json"), json.dumps(dump))


def _elastic_server(out, name, spec):
    """Internal role: one AsyncPSService on the card under coordinator
    ``spec["coord"]``, with the keys ``spec["keys"]`` of tree
    ``spec["tree"]``. Answers ``hist-<name>-<k>`` command files with its
    transport's raw histogram states; with ``clones`` keeps a copy on the
    card of every row it evicts or adopts (the move's check reads their
    digests). At ``stop`` it dumps ``server-<name>.json`` (event and
    elastic logs, moves, apply counts, its initial keys, the digests) and
    ``final-<name>.pt`` (its params)."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import AsyncPSService

    spec = json.loads(spec)
    ps.init(backend="cuda", mode="async", num_workers=spec["workers"],
            dc_lambda=spec["dc"])
    tree = _el_tree(spec["tree"], "cuda")
    store = ps.KVStore(optimizer=spec["opt"], learning_rate=spec["lr"],
                       mode="async")
    store.init({k: tree[k] for k in spec["keys"]})
    del tree
    coord_file = os.path.join(out, f"coord-{spec['coord']}")
    _el_wait(coord_file)
    svc = AsyncPSService(store, coordinator=_el_read(coord_file),
                         record_full_history=True)
    eng = svc._engine
    clones = {"evicted": {}, "adopted": {}}
    if spec.get("clones"):
        from ps_tpu_torch.checkpoint import state_to_reference

        def clone(k):
            return {"param": eng._params[k].clone(),
                    "state": {p: v.clone() for p, v in state_to_reference(
                        eng._opt.name, k, eng._state[k]).items()},
                    "stale": {w: v.clone() for (w, kk), v in
                              eng._stale.items() if kk == k},
                    "apply_count": int(eng.apply_count.get(k, 0))}

        evict, adopt = eng.evict_keys, eng.adopt_key

        def evict_keys(keys):
            for k in keys:
                clones["evicted"][k] = clone(k)
            evict(keys)

        def adopt_key(k, *a, **kw):
            adopt(k, *a, **kw)
            clones["adopted"][k] = clone(k)

        eng.evict_keys, eng.adopt_key = evict_keys, adopt_key
    _el_write(os.path.join(out, f"port-{name}"), svc.port)
    served = 0
    while not os.path.exists(os.path.join(out, f"stop-{name}")):
        cmd = os.path.join(out, f"hist-{name}-{served}")
        if os.path.exists(cmd):
            states = {h.name: h.state() for h in svc.transport.hist.values()}
            _el_write(os.path.join(out, f"hists-{name}-{served}.json"),
                      json.dumps(states))
            served += 1
        time.sleep(0.005)
    with eng._lock:
        final = ({k: v.cpu() for k, v in eng._params.items()}
                 if spec.get("final") else {})
        dump = {"event_log": list(svc.event_log),
                "elastic_log": list(svc.elastic_log),
                "migrations": svc.migrations, "keys0": spec["keys"],
                "keys": list(svc._key_order),
                "apply_count": dict(eng.apply_count),
                "version": eng.version, "port": svc.port,
                "table_epoch": svc.table_epoch,
                "hists": {h.name: h.state()
                          for h in svc.transport.hist.values()},
                "digests": {side: {k: _el_row_digest(r)
                                   for k, r in rows.items()}
                            for side, rows in clones.items()}}
    if spec.get("final"):
        torch.save(final, os.path.join(out, f"final-{name}.pt"))
    _el_write(os.path.join(out, f"server-{name}.json"), json.dumps(dump))
    svc.stop()
    ps.shutdown()


def _el_key_streams(dumps):
    """Each key's events in order over the servers that held it: the
    servers' event logs cut by their elastic logs (a key's period at a
    shard runs from its adoption, or the start, to its move out; the
    periods in the order of their table epochs), a partial push kept only
    for the keys it applied."""
    periods = {}
    for name, d in dumps.items():
        owned = {k: (0, 0) for k in d["keys0"]}
        subs = {}
        for e in sorted(d["elastic_log"], key=lambda e: e["at"]):
            if e["op"] == "push_sub":
                subs[e["at"]] = set(e["keys"])
            elif e["op"] == "adopt":
                for k in e["keys"]:
                    owned[k] = (e["table_epoch"], e["at"])
            else:  # migrate_out
                for k in e["keys"]:
                    epoch, start = owned.pop(k)
                    periods.setdefault(k, []).append(
                        (epoch, name, start, e["at"]))
        for k, (epoch, start) in owned.items():
            periods.setdefault(k, []).append(
                (epoch, name, start, len(d["event_log"])))
        d["_subs"] = subs
    streams = {}
    for k, spans in periods.items():
        ev = []
        for _epoch, name, start, end in sorted(spans):
            log_, subs = dumps[name]["event_log"], dumps[name]["_subs"]
            for i in range(start, end):
                op, w = log_[i]
                if op == "push" and i in subs and k not in subs[i]:
                    continue
                ev.append((op, int(w)))
        streams[k] = ev
    return streams


def _el_replay(streams, init, grads_of, device, opt, nworkers,
               pulled_of=None):
    """Each key's stream replayed through one unrebalanced
    ``AsyncCudaServer`` on ``device``: a pull records the worker's stale
    snapshot of the key, a push applies the key of the worker's c-th
    gradient (``grads_of(w, c)``). With ``pulled_of(w, c)`` (the params
    worker w took cycle c's gradient at) every push's preceding pull is
    held to it bitwise. Returns (params, pushes a (worker, key), pulls
    held)."""
    from ps_tpu_torch.backends.cuda import AsyncCudaServer
    from ps_tpu_torch.optim import make_optimizer

    eng = AsyncCudaServer(make_optimizer(opt, learning_rate=EL_LR),
                          torch.device(device), nworkers, dc_lambda=EL_DC)
    eng.register_tree({k: init[k] for k in streams}, None, sorted(streams))
    pushes, last, held = {}, {}, 0
    for k, ev in streams.items():
        for op, w in ev:
            if op == "pull":
                with eng._lock:
                    last[(w, k)] = eng._pull_async(w, [k])[k]
                continue
            c = pushes.get((w, k), 0)
            pushes[(w, k)] = c + 1
            if pulled_of is not None:
                want = pulled_of(w, c)[k]
                if not torch.equal(last[(w, k)], want.to(device)):
                    raise AssertionError(
                        f"worker {w} cycle {c}: {k} pulled before the push "
                        f"differs from the replay")
                held += 1
            eng.push_subtree({k: grads_of(w, c)[k].to(device)}, worker=w)
    return eng._params, pushes, held


def _el_finish_servers(out, names, procs):
    """Stop the named servers; their dumps and (where they saved them)
    their final params merged."""
    for n in names:
        _el_write(os.path.join(out, f"stop-{n}"), "")
    dumps, final = {}, {}
    for n in names:
        _el_wait(os.path.join(out, f"server-{n}.json"), procs=procs)
        dumps[n] = json.load(open(os.path.join(out, f"server-{n}.json")))
        path = os.path.join(out, f"final-{n}.pt")
        if os.path.exists(path):
            final.update(torch.load(path))
    return dumps, final


def _el_hists(out, names, k, procs):
    """Each named server's raw histogram states, asked for by command
    file ``k`` (a stopped server's from its dump: they move no more)."""
    states = {}
    stopped = {n for n in names
               if os.path.exists(os.path.join(out, f"stop-{n}"))}
    for n in set(names) - stopped:
        _el_write(os.path.join(out, f"hist-{n}-{k}"), "")
    for n in names:
        if n in stopped:
            path = os.path.join(out, f"server-{n}.json")
            _el_wait(path, procs=procs)
            states[n] = json.load(open(path))["hists"]
            continue
        path = os.path.join(out, f"hists-{n}-{k}.json")
        _el_wait(path, procs=procs)
        states[n] = json.load(open(path))
    return states


def _el_config5_ready(out, procs):
    """(a)'s fleet registered: the two shards and both standbys (their
    URIs, registered as spares too)."""
    from ps_tpu_torch.elastic import fetch_table
    from ps_tpu_torch.elastic.member import register_spare

    _el_wait(os.path.join(out, "coord-a"), procs=procs)
    ca = _el_read(os.path.join(out, "coord-a"))
    fetch_table(ca, cover=list(_el_tree("mlp", "cpu")),
                timeout=EL_TIMEOUT_S)
    standby_uris = []
    while len(standby_uris) < 2:
        _el_alive(procs)
        table = fetch_table(ca, timeout=EL_TIMEOUT_S)
        standby_uris = [u for i, u in enumerate(table.shards)
                        if not table.keys_of(i)]
        time.sleep(0.02)
    return ca, standby_uris, [register_spare(ca, u)["spares"]
                              for u in standby_uris]


def _el_config5(out, procs, server_names, ready):
    """(a), with (d)'s telemetry: three worker threads through the
    coordinator, the split and the drain driven from this thread, the
    quiet points; the gates; returns the numbers."""
    import threading

    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.elastic import (fetch_table, fetch_telemetry,
                                      request_rebalance)
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.kv.store import value_and_grad
    from ps_tpu_torch.models.mlp import MLP, make_loss_fn
    from ps_tpu_torch.obs.metrics import Histogram, state_add, state_sub

    ca, standby_uris, spares = ready
    loss_fn = make_loss_fn(MLP(hidden=EL_HIDDEN))
    init = _el_tree("mlp", "cpu")
    like = keymod.unflatten(_el_treedef(),
                            {k: v.cuda() for k, v in init.items()},
                            list(init))
    gate = {c: threading.Event() for c in (EL_SPLIT_AT, EL_DRAIN_AT,
                                           EL_QUIET_AT)}
    reached = {c: threading.Barrier(EL_WORKERS + 1)
               for c in (EL_SPLIT_AT, EL_DRAIN_AT, EL_QUIET_AT)}
    recs = [{"pulled": [], "grads": [], "losses": [], "epochs": [],
             "t": []} for _ in range(EL_WORKERS)]
    errors = []
    workers = {}

    def run(w):
        try:
            c = connect_async(None, w, like, coordinator=ca,
                              failover_timeout=60.0)
            workers[w] = c
            batches = mnist_batches(EL_BATCH, seed=0, worker=w,
                                    num_workers=EL_WORKERS)
            p = c.pull_all()
            for i in range(EL_CYCLES):
                if i in reached:
                    # the split and the drain run under traffic: the
                    # workers only meet here; at the quiet point they
                    # wait for the window's first still reading
                    reached[i].wait(timeout=EL_TIMEOUT_S)
                    if i == EL_QUIET_AT:
                        gate[i].wait(timeout=EL_TIMEOUT_S)
                images, labels = next(batches)
                batch = (torch.from_numpy(images).cuda(),
                         torch.from_numpy(labels).cuda())
                loss, g, _ = value_and_grad(loss_fn, p, batch)
                kv, _ = keymod.flatten_with_keys(p)
                gkv, _ = keymod.flatten_with_keys(g)
                recs[w]["pulled"].append(kv)
                recs[w]["grads"].append(gkv)
                recs[w]["losses"].append(loss)
                recs[w]["t"].append(time.monotonic())
                p = c.push_pull(g)
                recs[w]["epochs"].append(c._table.epoch)
        except BaseException as e:  # reported below
            errors.append((w, repr(e)))
            for b in reached.values():
                b.abort()

    threads = [threading.Thread(target=run, args=(w,))
               for w in range(EL_WORKERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    moves = {}
    seen_epochs = []
    try:
        reached[EL_SPLIT_AT].wait(timeout=EL_TIMEOUT_S)
        moves["split"] = request_rebalance(ca, targets=list(range(4)))
        seen_epochs.append(fetch_table(ca).epoch)
        reached[EL_DRAIN_AT].wait(timeout=EL_TIMEOUT_S)
        table = fetch_table(ca)
        drain = [table.shards.index(u) for u in standby_uris]
        moves["drain"] = request_rebalance(ca, drain=drain)
        seen_epochs.append(fetch_table(ca).epoch)
        # the drained standbys stop (their reports too): only a report of
        # theirs between the drain and the stop would leave them in the
        # fleet's window, by their lifetime (ROADMAP R7)
        for n in server_names:
            uri = f"127.0.0.1:{_el_read(os.path.join(out, f'port-{n}'))}"
            if uri in standby_uris:
                _el_write(os.path.join(out, f"stop-{n}"), "")
        reached[EL_QUIET_AT].wait(timeout=EL_TIMEOUT_S)
        time.sleep(EL_QUIET_S)
        hist_a = _el_hists(out, server_names, 0, procs)
        # the window starts here: the members' reports of their still
        # state had the quiet point to arrive
        t_base = time.monotonic()
        gate[EL_QUIET_AT].set()
    except threading.BrokenBarrierError:
        pass
    for t in threads:
        t.join(timeout=EL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"elastic (a): workers failed: {errors}")
    time.sleep(EL_QUIET_S)
    hist_b = _el_hists(out, server_names, 1, procs)
    reroutes = [workers[w].transport.table_reroutes
                for w in range(EL_WORKERS)]
    for c in workers.values():
        c.close()
    # -- the gates
    for w, r in enumerate(recs):
        if r["epochs"] != sorted(r["epochs"]):
            raise AssertionError(f"elastic (a): worker {w}'s table epochs "
                                 f"went back: {r['epochs']}")
    if min(reroutes) < 1:
        raise AssertionError(f"elastic (a): table reroutes {reroutes}")
    if seen_epochs != sorted(seen_epochs) or len(set(seen_epochs)) != 2:
        raise AssertionError(f"elastic (a): epochs {seen_epochs}")
    # (d): the fleet's p99 of the servers' push applies over the window
    # (cycles 30-39) against the members' raw histograms merged. A member
    # is read as the time series reads it: the serving shards by their
    # window (B - A); a drained standby, whose reports carry nothing new,
    # by its lifetime (B) when its one sample since it re-entered the
    # series is all there is, else not at all
    metric = "ps_server_apply_seconds"
    uris = {n: f"127.0.0.1:{_el_read(os.path.join(out, f'port-{n}'))}"
            for n in server_names}
    serving = set(fetch_table(ca).shards)

    def summary(st):
        return Histogram.from_state("m", st).summary() if st["n"] else None

    deadline = time.monotonic() + 5.0
    while True:
        window_s = time.monotonic() - t_base
        tel = fetch_telemetry(ca, window_s=window_s)
        merged, per_p99, bad, counted = None, [], [], {}
        for n in server_names:
            b = hist_b[n].get(metric)
            if b is None:
                continue
            a = hist_a[n].get(metric)
            d = state_sub(b, a) if a is not None else b
            seen = tel["per_member"].get(uris[n], {}).get(metric)
            if uris[n] in serving:
                st = d
                counted[n] = "window"
            elif seen is not None and seen == summary(b):
                st = b
                counted[n] = "lifetime"
            else:
                st = None
            if (summary(st) if st else None) != seen:
                bad.append((n, seen))
                continue
            if st is not None and st["n"]:
                merged = state_add(merged, st)
                per_p99.append(Histogram.from_state("m", st).quantile(0.99))
        want = summary(merged) if merged else None
        got = tel["fleet"].get(metric)
        if (not bad and got == want) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if bad or got != want:
        raise AssertionError(f"elastic (d): the fleet's window {got} is not "
                             f"the members' raw histograms merged {want} "
                             f"(members off: {bad})")
    return {"recs": recs, "moves": moves, "reroutes": reroutes,
            "counted": counted, "wall_s": wall,
            "fleet_p99_ms": want["p99"] * 1e3,
            "fleet_count": want["count"], "window_s": window_s,
            "mean_member_p99_ms": float(np.mean(per_p99)) * 1e3,
            "members": len(per_p99), "spares": spares,
            "loss_fn": loss_fn, "init": init}


def _el_config5_checks(out, procs, server_names, a):
    """(a)'s replay gates on the servers' dumps."""
    from ps_tpu_torch.data.synthetic import mnist_batches
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.kv.store import value_and_grad

    dumps, final = _el_finish_servers(out, server_names, procs)
    recs, init = a["recs"], a["init"]
    want = EL_WORKERS * EL_CYCLES
    for k in init:
        n = sum(int(d["apply_count"].get(k, 0)) for d in dumps.values()
                if k in d["keys"])
        if n != want:
            raise AssertionError(f"elastic (a): {k} applied {n} times, "
                                 f"{want} pushes were sent")
    streams = _el_key_streams(dumps)
    params, pushes, held = _el_replay(
        streams, {k: v.cuda() for k, v in init.items()},
        lambda w, c: recs[w]["grads"][c], "cuda", "momentum", EL_WORKERS,
        pulled_of=lambda w, c: recs[w]["pulled"][c])
    if set(pushes.values()) != {EL_CYCLES}:
        raise AssertionError(f"elastic (a): replayed pushes {pushes}")
    for k, v in final.items():
        if not torch.equal(params[k].cpu(), v):
            raise AssertionError(f"elastic (a): {k} replayed on one engine "
                                 f"is not bitwise the fleet's")
    # the CPU witness: each gradient recomputed on the CPU from the params
    # its worker pulled on the card, and the same streams replayed there
    norms, diffs, cpu_grads = [], [], {}
    for w in range(EL_WORKERS):
        batches = mnist_batches(EL_BATCH, seed=0, worker=w,
                                num_workers=EL_WORKERS)
        for c in range(EL_CYCLES):
            images, labels = next(batches)
            p_cpu = {k: v.cpu() for k, v in recs[w]["pulled"][c].items()}
            tree = keymod.unflatten(_el_treedef(), p_cpu, list(p_cpu))
            _, g, _ = value_and_grad(a["loss_fn"], tree,
                                     (torch.from_numpy(images),
                                      torch.from_numpy(labels)))
            g, _ = keymod.flatten_with_keys(g)
            cpu_grads[(w, c)] = g
            card = recs[w]["grads"][c]
            norms.append(float(torch.sqrt(sum(
                (card[k].double() ** 2).sum().cpu() for k in card))))
            diffs.append(float(torch.sqrt(sum(
                ((g[k].double() - card[k].double().cpu()) ** 2).sum()
                for k in card))))
    med = float(np.median(norms))
    grad_err = max(d / max(n, med) for d, n in zip(diffs, norms))
    if grad_err > VAN_GRAD_RTOL:
        raise AssertionError(f"elastic (a): a gradient recomputed on the CPU "
                             f"is {grad_err:.3g} off the card's")
    witness, _, _ = _el_replay(streams, init,
                               lambda w, c: cpu_grads[(w, c)], "cpu",
                               "momentum", EL_WORKERS)
    cpu_err = 0.0
    for k, v in final.items():
        np.testing.assert_allclose(witness[k].numpy(), v.numpy(),
                                   rtol=MNIST_TOL, atol=MNIST_TOL,
                                   err_msg=f"elastic (a): {k} on the CPU")
        cpu_err = max(cpu_err, float((witness[k] - v).abs().max()))
    losses = [float(x) for r in recs for x in r["losses"]]
    if not np.all(np.isfinite(losses)):
        raise AssertionError("elastic (a): a loss is not finite")
    moved = sum(m["rows"] for d in dumps.values() for m in d["migrations"])
    return {"held": held, "grad_err": grad_err, "cpu_err": cpu_err,
            "moves": sum(len(d["migrations"]) for d in dumps.values()),
            "rows": moved, "loss": (float(np.mean(losses[:EL_WORKERS])),
                                    float(np.mean(losses[-EL_WORKERS:])))}


def _el_treedef():
    from ps_tpu_torch.kv import keys as keymod
    from ps_tpu_torch.models.mlp import MLP

    return keymod.flatten_with_keys(
        MLP(hidden=EL_HIDDEN).init(torch.Generator()))[1]


def _el_bert(out, procs):
    """(b): one bucketed worker thread over the tree's two shards, the
    split to three at cycle 3 driven beside it; the moved rows' digests,
    a replay of the final pull, and the numbers."""
    import threading

    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.elastic import fetch_table, request_rebalance
    from ps_tpu_torch.kv import keys as keymod

    cb = _el_read(os.path.join(out, "coord-b"))
    tree = _el_tree("bert", "cuda")
    nbytes = sum(v.nbytes for v in tree.values())
    table = fetch_table(cb, cover=list(tree), timeout=EL_TIMEOUT_S)
    while len(table.shards) < 3:
        time.sleep(0.02)
        table = fetch_table(cb)
    w = connect_async(None, 0, tree, coordinator=cb,
                      bucket_bytes=EL_BERT_BUCKET, pool_size=EL_BERT_POOL,
                      failover_timeout=60.0)
    reroute_s = []
    on_moved = w._on_table_moved

    def timed(err, deadline):
        t0 = time.perf_counter()
        on_moved(err, deadline)
        reroute_s.append(time.perf_counter() - t0)

    w._on_table_moved = timed
    w.pull_all()
    move = {}
    mover = None

    def split():
        move["t0"] = time.monotonic()
        move["out"] = request_rebalance(cb, targets=[0, 1, 2])
        move["t1"] = time.monotonic()

    ends = []
    starts = []
    for c in range(EL_BERT_CYCLES):
        if c == EL_BERT_SPLIT_AT:
            mover = threading.Thread(target=split)
            mover.start()
        starts.append(time.monotonic())
        w.push_pull(_el_bert_grads(tree, c))
        torch.cuda.synchronize()
        ends.append(time.monotonic())
    mover.join(timeout=EL_TIMEOUT_S)
    if "out" not in move:
        raise AssertionError("elastic (b): the split never committed")
    final, _ = keymod.flatten_with_keys(w.pull_all())
    table = fetch_table(cb)
    w.close()
    names = ["b0", "b1", "b2"]
    dumps, _ = _el_finish_servers(out, names, procs)
    # the moved rows at the recipient bitwise the donor's at the cutover
    evicted = {k: v for n in names
               for k, v in dumps[n]["digests"]["evicted"].items()}
    adopted = {k: v for n in names
               for k, v in dumps[n]["digests"]["adopted"].items()}
    if not adopted or evicted != adopted:
        raise AssertionError(f"elastic (b): {len(adopted)} adopted rows, "
                             f"digests equal to the donors' "
                             f"{evicted == adopted}")
    streams = _el_key_streams(dumps)
    params, pushes, _ = _el_replay(
        streams, tree, lambda _w, c: _el_bert_grads(tree, c), "cuda",
        "momentum", 1)
    if set(pushes.values()) != {EL_BERT_CYCLES}:
        raise AssertionError(f"elastic (b): replayed pushes {pushes}")
    for k, v in final.items():
        if not torch.equal(params[k], v):
            raise AssertionError(f"elastic (b): the worker's final {k} is "
                                 f"not bitwise the replay's")
    migs = [m for n in names for m in dumps[n]["migrations"]]
    before = [e - s for s, e in zip(starts, ends) if e < move["t0"]][1:]
    during = [e - s for s, e in zip(starts, ends)
              if e > move["t0"] and s < move["t1"]]
    after = [e - s for s, e in zip(starts, ends) if s >= move["t1"]]
    return {
        "tree_bytes": nbytes, "moved_keys": len(adopted),
        "bytes": sum(m["bytes"] for m in migs),
        "gbps": sum(m["bytes"] for m in migs) / sum(
            m["seconds"] for m in migs) / 1e9,
        "move_s": move["t1"] - move["t0"],
        "snapshot_ms": max(m["snapshot_s"] for m in migs) * 1e3,
        "copy_ms": max(m["copy_s"] for m in migs) * 1e3,
        "cutover_ms": max(m["cutover_s"] for m in migs) * 1e3,
        "reroute_ms": [x * 1e3 for x in reroute_s],
        "cps": {"before": len(before) / sum(before) if before else 0.0,
                "during": len(during) / sum(during) if during else 0.0,
                "after": len(after) / sum(after) if after else 0.0},
        "moves": len(migs), "epoch": table.epoch}


def _el_sparse_run(out, procs, cc, old):
    """(c)'s orchestration: at the workers' pause shard 1 (process
    ``old``) saves and stops, its replacement (restored from the save)
    takes the slot once the process exited, the workers resume; a range
    move is refused with the typed message."""
    from ps_tpu_torch.elastic import fetch_view, request_rebalance

    for w in range(SPARSE_WORKERS):
        _el_wait(os.path.join(out, f"paused{w}"), procs=procs)
    view = fetch_view(cc)
    old_port = int(_el_read(os.path.join(out, "port1")))
    try:
        request_rebalance(cc, moves=[[0, 1, [k for k, s in
                                             view["table"]["assign"].items()
                                             if s == 0][:1]]])
        raise AssertionError("elastic (c): a sparse range move committed")
    except RuntimeError as e:
        if "sparse member" not in str(e):
            raise
        refusal = str(e)
    _el_write(os.path.join(out, "stop1"), "")
    # the replacement registers once shard 1's process ended (a stopping
    # service still serves its open connections) and the coordinator saw
    # it leave
    old.wait(timeout=EL_TIMEOUT_S)
    if old.returncode != 0:
        raise AssertionError(f"elastic (c): shard 1 exited {old.returncode}"
                             f":\n{old.communicate()[0][-3000:]}")
    old_uri = f"127.0.0.1:{old_port}"
    deadline = time.monotonic() + EL_TIMEOUT_S
    while not any(m["uri"] == old_uri and m["hb_state"] == "left"
                  for m in fetch_view(cc)["members"]):
        if time.monotonic() > deadline:
            raise TimeoutError("elastic (c): shard 1 never left")
        time.sleep(0.01)
    _el_write(os.path.join(out, "ckpt1", "go1"), "")
    while True:
        shards = fetch_view(cc)["table"]["shards"]
        if len(shards) == 2 and old_uri not in shards:
            break
        if time.monotonic() > deadline:
            raise TimeoutError("elastic (c): no replacement took the slot")
        time.sleep(0.02)
    _el_write(os.path.join(out, "resume"), "")
    return refusal


def _el_sparse_checks(out, rout, harness, procs):
    """(c)'s gates on the dumps: 2 + 2 launches a push applied at every
    server process, the logs (shard 1's old and new, joined) replayed on
    the card bitwise the tables, every pulled row set the replay's."""
    import ps_tpu_torch as ps

    outs = harness.finish(procs, SPARSE_TIMEOUT_S, fail_fast=True)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"elastic (c): {' '.join(p.args[-10:])} "
                                 f"exited {p.returncode}:\n{o[-3000:]}")
    info0 = json.load(open(os.path.join(out, "sparse_server0.json")))
    old1 = json.load(open(os.path.join(out, "sparse_server1.json")))
    new1 = json.load(open(os.path.join(rout, "sparse_server1.json")))
    launches = {"sparse_apply/deep": 0, "sparse_apply/wide": 0,
                "sparse_group": 0}
    for what, info in (("shard 0", info0), ("shard 1", old1),
                       ("its replacement", new1)):
        n = len(info["apply_log"])
        got = info["launches"]
        if (got["apply"], got["group"], got["by_rule"]) != (
                2 * n, 2 * n, {"adagrad": n, "sgd": n}) or not n:
            raise AssertionError(f"elastic (c): {what} launched {got} for "
                                 f"{n} pushes: expected 2 grouping + 2 "
                                 f"apply a push")
        launches["sparse_apply/deep"] += got["by_rule"]["adagrad"]
        launches["sparse_apply/wide"] += got["by_rule"]["sgd"]
        launches["sparse_group"] += got["group"]
    joined = dict(new1, apply_log=old1["apply_log"] + new1["apply_log"])
    finals = [dict(np.load(os.path.join(out, "sparse_tables0.npz"))),
              dict(np.load(os.path.join(rout, "sparse_tables1.npz")))]
    records = [json.load(open(os.path.join(out, f"sparse_worker{w}.json")))
               for w in range(SPARSE_WORKERS)]
    pulls = {w: (dict(np.load(os.path.join(out, f"sparse_pulls{w}.npz"))),
                 records[w]) for w in range(SPARSE_WORKERS)}
    ps.init(backend="cuda")
    try:
        tables, checked = harness.sparse_replay(
            [info0, joined], "wd", SPARSE_WORKERS, EL_SPARSE_CYCLES,
            pulls=pulls)
        for s, final in enumerate(finals):
            for name, emb in tables[s].items():
                leaves = [emb.table] + _emb_leaves(emb)
                saved = [final[name]] + [final[f"{name}/state{i}"]
                                         for i in range(len(leaves) - 1)]
                if not all(np.array_equal(x.cpu().numpy(), y)
                           for x, y in zip(leaves, saved)):
                    raise AssertionError(f"elastic (c): shard {s} {name} "
                                         f"replayed is not bitwise the "
                                         f"server's")
    finally:
        ps.shutdown()
    reroutes = [r["table_reroutes"] for r in records]
    if min(reroutes) < 1:
        raise AssertionError(f"elastic (c): worker re-routes {reroutes}")
    return {"launches": launches, "checked": checked, "reroutes": reroutes,
            "applied": [len(info0["apply_log"]), len(old1["apply_log"]),
                        len(new1["apply_log"])]}


def _el_policy(out, procs):
    """(d)'s policy fleets: the acting engine fires one hotspot rebalance
    after its burn windows and levels the fleet; skewed again inside the
    cooldown, it is suppressed; the dry engine records its plan and moves
    nothing."""
    from ps_tpu_torch.elastic import fetch_table, request_rebalance
    from ps_tpu_torch.elastic.member import fetch_policy

    got = {}
    for mode in ("act", "dry"):
        ca = _el_read(os.path.join(out, f"coord-{mode}"))
        keys = [f"b{i}" for i in range(EL_POLICY_KEYS)]
        fetch_table(ca, cover=keys, timeout=EL_TIMEOUT_S)
        outcome = "rebalance:ok" if mode == "act" else "rebalance:dry"
        deadline = time.monotonic() + 30
        while outcome not in fetch_policy(ca)["actions_total"]:
            if time.monotonic() > deadline:
                raise TimeoutError(f"elastic (d): the {mode} engine never "
                                   f"fired: {fetch_policy(ca)}")
            time.sleep(0.05)
        table = fetch_table(ca)
        if mode == "act":
            # skewed again inside the cooldown, once the level fleet's
            # quiet windows re-armed the rule: it burns again and is
            # suppressed
            deadline = time.monotonic() + 30
            while not fetch_policy(ca)["rules"]["hotspot_rebalance"][
                    "armed"]:
                if time.monotonic() > deadline:
                    raise TimeoutError("elastic (d): the rule never "
                                       "re-armed")
                time.sleep(0.05)
            request_rebalance(ca, moves=[[1, 0, table.keys_of(1)[:-1]]])
            deadline = time.monotonic() + 30
            while not fetch_policy(ca)["suppressed_total"].get("cooldown"):
                if time.monotonic() > deadline:
                    raise TimeoutError("elastic (d): no cooldown "
                                       "suppression")
                time.sleep(0.05)
        st = fetch_policy(ca, n=256)
        fires = [e for e in st["actions"]
                 if e["rule"] == "hotspot_rebalance"
                 and e["outcome"] in ("started", "ok", "dry", "failed")]
        got[mode] = {"actions_total": st["actions_total"],
                     "suppressed": st["suppressed_total"],
                     "fired": st["rules"]["hotspot_rebalance"]["fired_total"],
                     "fires": fires, "epoch": fetch_table(ca).epoch,
                     "shards": [len(table.keys_of(i)) for i in range(2)]}
    act, dry = got["act"], got["dry"]
    if act["actions_total"] != {"rebalance:ok": 1} or act["fired"] != 1 \
            or len(act["fires"]) != 1 or act["shards"] != [4, 4]:
        raise AssertionError(f"elastic (d): the acting engine {act}")
    if dry["actions_total"] != {"rebalance:dry": 1} or dry["fired"] != 1 \
            or dry["epoch"] != 2 or sorted(dry["shards"]) != [1, 7] \
            or dry["fires"][0]["detail"] != {"targets": [0, 1]}:
        raise AssertionError(f"elastic (d): the dry engine {dry}")
    return got


def phase_elastic(tmp):
    """25: elastic membership on the card (ROADMAP item 6.2)."""
    import threading

    from ps_tpu_torch.ops import _build

    _build.build(("sparse_group", "sparse_apply"))  # cached after phase 2
    harness = _van_harness()
    card = _card_line()
    t0 = time.perf_counter()
    out = os.path.join(tmp, "el")
    rout = os.path.join(out, "r")
    os.makedirs(rout)
    mlp_keys = sorted(_el_tree("mlp", "cpu"))
    base = {"workers": EL_WORKERS, "dc": EL_DC, "lr": EL_LR,
            "opt": "momentum"}
    half = len(mlp_keys) // 2
    # (a)'s fleet and (c)'s processes first; the others start while (a)
    # runs
    a_fleet = {"a0": dict(base, coord="a", tree="mlp", final=True,
                          keys=mlp_keys[:half]),
               "a1": dict(base, coord="a", tree="mlp", final=True,
                          keys=mlp_keys[half:]),
               "a2": dict(base, coord="a", tree="mlp", final=True, keys=[]),
               "a3": dict(base, coord="a", tree="mlp", final=True, keys=[])}
    servers = {}
    for i, ks in enumerate(_el_bert_split(_el_bert_shapes()) + [[]]):
        servers[f"b{i}"] = dict(base, workers=1, coord="b", tree="bert",
                                keys=ks, clones=True)
    pkeys = [f"b{i}" for i in range(EL_POLICY_KEYS)]
    for mode, tag in (("act", "p"), ("dry", "q")):
        servers[f"{tag}0"] = dict(base, coord=mode, tree="blocks",
                                  keys=pkeys[:-1], opt="sgd")
        servers[f"{tag}1"] = dict(base, coord=mode, tree="blocks",
                                  keys=pkeys[-1:], opt="sgd")
    # (c): two sparse shards (shard 1 saves and stops at stop1), the
    # replacement waiting for its save, three workers pausing at cycle
    # 10; the coordinator's address in a file
    ckpt = os.path.join(out, "ckpt1")
    os.makedirs(ckpt)
    sopts = {"coordinator": "coord-c"}
    shard_opts = [sopts, dict(sopts, stop_at="stop1", save=ckpt)]
    procs, sparse = [], []
    try:
        procs.append(_el_spawn("--elastic-coords", out))
        procs += [_el_spawn("--elastic-server", out, n, json.dumps(spec))
                  for n, spec in a_fleet.items()]
        sparse = [harness.spawn("sparse-server", out, SPARSE_WORKERS,
                                EL_SPARSE_CYCLES, s, SPARSE_SHARDS, "cuda",
                                "wd", json.dumps(shard_opts[s]))
                  for s in range(SPARSE_SHARDS)]
        sparse.append(harness.spawn(
            "sparse-server", rout, SPARSE_WORKERS, EL_SPARSE_CYCLES, 1,
            SPARSE_SHARDS, "cuda", "wd",
            json.dumps(dict(sopts, restore=ckpt, restore_at="go1"))))
        sparse += [harness.spawn(
            "sparse-worker", "@0", out, w, EL_SPARSE_CYCLES, "cuda", "wd",
            SPARSE_WORKERS, 1,
            json.dumps(dict(sopts, pause_at=EL_SPARSE_STOP_AT)))
            for w in range(SPARSE_WORKERS)]
        ready = _el_config5_ready(out, procs)
        t_ready = time.perf_counter()
        procs += [_el_spawn("--elastic-server", out, n, json.dumps(spec))
                  for n, spec in servers.items()]
        _el_wait(os.path.join(out, "coord-c"), procs=procs)
        _el_write(os.path.join(rout, "coord-c"),
                  _el_read(os.path.join(out, "coord-c")))
        cc = _el_read(os.path.join(out, "coord-c"))
        side = {}

        def background(name, fn, *args):
            try:
                side[name] = fn(*args)
            except BaseException as e:  # raised below
                side[name] = e

        bg = [threading.Thread(target=background, args=(
                  "c", _el_sparse_run, out, procs + sparse, cc, sparse[1])),
              threading.Thread(target=background, args=(
                  "d", _el_policy, out, procs))]
        for t in bg:
            t.start()
        a = _el_config5(out, procs, ["a0", "a1", "a2", "a3"], ready)
        t_a = time.perf_counter()
        for t in bg:
            t.join(timeout=EL_TIMEOUT_S)
        for name in ("c", "d"):
            if isinstance(side.get(name), BaseException):
                raise side[name]
        t_cd = time.perf_counter()
        a_chk = _el_config5_checks(out, procs, ["a0", "a1", "a2", "a3"], a)
        t_achk = time.perf_counter()
        c = _el_sparse_checks(out, rout, harness, sparse)
        t_c = time.perf_counter()
        b = _el_bert(out, procs)
        t_b = time.perf_counter()
        _el_finish_servers(out, ["p0", "p1", "q0", "q1"], procs)
        _el_write(os.path.join(out, "coords-stop"), "")
        _el_wait(os.path.join(out, "coords.json"), procs=procs)
        coords = json.load(open(os.path.join(out, "coords.json")))
        if coords["cuda_initialized"]:
            raise AssertionError("elastic: the coordinators' process "
                                 "initialized CUDA")
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs + sparse:
            if p.poll() is None:
                p.kill()
            p.wait()
    total = time.perf_counter() - t0
    m = a["moves"]
    log(f"elastic (a): a coordinator (no device) + 2 AsyncPSService "
        f"processes of the {EL_HIDDEN}-hidden MNIST MLP (momentum, lr "
        f"{EL_LR}, DC λ {EL_DC}, on the card) + 2 empty standbys "
        f"(register_spare: {a['spares']}); {EL_WORKERS} worker threads x "
        f"{EL_CYCLES} cycles on connect_async(coordinator=): split 2 -> 4 "
        f"at cycle {EL_SPLIT_AT} ({len(m['split']['moves'])} moves, epoch "
        f"{m['split']['epoch']}), drain back at {EL_DRAIN_AT} "
        f"({len(m['drain']['moves'])} moves, epoch {m['drain']['epoch']}); "
        f"{a_chk['moves']} committed moves, {a_chk['rows']} rows streamed; "
        f"every key applied {EL_WORKERS * EL_CYCLES} times; table reroutes "
        f"{a['reroutes']}, epochs monotonic; the servers' logs replayed "
        f"key by key on one engine on the card bitwise the fleet's params, "
        f"{a_chk['held']} pulls bitwise the replay's; CPU witness: "
        f"gradients {a_chk['grad_err']:.3g} (bound {VAN_GRAD_RTOL}), "
        f"params max abs {a_chk['cpu_err']:.3g} (tol {MNIST_TOL}); loss "
        f"{a_chk['loss'][0]:.4f} -> {a_chk['loss'][1]:.4f}; workers "
        f"{a['wall_s']:.1f} s")
    log(f"elastic (b): the {b['tree_bytes']:,}-byte tree (momentum) on 2 "
        f"shards, 1 bucketed worker x {EL_BERT_CYCLES} cycles, split to 3 "
        f"at cycle {EL_BERT_SPLIT_AT}: {b['moves']} moves, "
        f"{b['moved_keys']} rows bitwise at their recipients (param, state, "
        f"stale snapshot, apply count); the final pull bitwise a replay; "
        f"{b['bytes']:,} bytes streamed at {b['gbps']:.3f} GB/s, the move "
        f"{b['move_s']:.3f} s; largest snapshot freeze "
        f"{b['snapshot_ms']:.3f} ms (copy off the card "
        f"{b['copy_ms']:.3f} ms), largest cutover freeze "
        f"{b['cutover_ms']:.3f} ms; re-route "
        f"{', '.join(f'{x:.3f}' for x in b['reroute_ms'])} ms; cycles/s "
        f"before {b['cps']['before']:.3f}, during {b['cps']['during']:.3f},"
        f" after {b['cps']['after']:.3f}; card {card}")
    log(f"elastic (c): phase 17's 2 sparse shards under a coordinator, "
        f"{SPARSE_WORKERS} worker processes x {EL_SPARSE_CYCLES} cycles on "
        f"connect_sparse(coordinator=); a range move refused "
        f"({side['c'][:60]!r}); at the pause after cycle "
        f"{EL_SPARSE_STOP_AT} shard 1 saved and stopped, a replacement "
        f"restored from the save took its slot, workers re-routed "
        f"{c['reroutes']}; applies {c['applied']} (shard 0, shard 1, the "
        f"replacement), each 2 grouping + 2 apply launches; the joined logs "
        f"replayed bitwise the tables, {c['checked']} pulled row sets "
        f"bitwise the replay")
    d = side["d"]
    log(f"elastic (d): fleet push-apply p99 over the window of cycles "
        f"{EL_QUIET_AT}-{EL_CYCLES - 1} ({a['window_s']:.3f} s, "
        f"{a['fleet_count']} applies; members counted "
        f"{json.dumps(a['counted'])}) {a['fleet_p99_ms']:.4f} ms, equal to "
        f"the members' raw histograms merged (their p99s' mean "
        f"{a['mean_member_p99_ms']:.4f} ms); policy act: "
        f"{d['act']['actions_total']}, suppressed "
        f"{d['act']['suppressed']}, fleet back to {d['act']['shards']} keys;"
        f" dry: {d['dry']['actions_total']}, plan "
        f"{d['dry']['fires'][0]['detail']}, table epoch "
        f"{d['dry']['epoch']} (nothing moved); coordinators' process never "
        f"initialized CUDA; (a)'s fleet up {t_ready - t0:.1f} s, (a) "
        f"{t_a - t_ready:.1f} s, (c) and (d) after it {t_cd - t_a:.1f} s, "
        f"(a)'s replays {t_achk - t_cd:.1f} s, (c)'s {t_c - t_achk:.1f} s, "
        f"(b) {t_b - t_c:.1f} s; phase {total:.1f} s")
    return {"launches": c["launches"], "seconds": total, "a": a_chk,
            "b": b, "c": c}


# -- phase 26: the autopilot chaos soak on the card (ROADMAP item 6.3) -------
# The reference's soak (bench.py bench_chaos) with every shard's params on
# the card: three in-process shards and one subprocess member under a
# coordinator with telemetry, SLOs, the straggler detector and the policy
# engine on; two hammer workers push the whole tree while drills A-E
# inject their faults; then the aggregator's death and the SIGKILL pair.

CHAOS_KEYS = [f"k{i:02d}" for i in range(12)]
CHAOS_DIM = 16384   # 64 KiB a key: a move's window stays under a second
CHAOS_LR = 0.01
CHAOS_SEED = 7      # make_tree's seed for the soak's tree
CHAOS_PAIR_DIMS = {"p0": 8192, "p1": 8192}
CHAOS_AGG_LR = 0.5  # a power of two: integer partial sums stay exact
CHAOS_AGG_ROUNDS = 6
# every fault class's heal bound in seconds (the reference's BOUND_S), in
# the order the plan printed for the determinism gate takes them
CHAOS_BOUND_S = {"slow_apply": 20.0, "sigstop": 20.0, "blackhole": 8.0,
                 "reconnect_storm": 8.0, "underload": 30.0,
                 "agg_death": 10.0, "sigkill": 30.0}
CHAOS_PLAN = (30.0, 2.0)  # the printed plan's horizon and spacing (s)
# after the blackhole: a worker's report cadence (1 s), the SLO window (2 s)
# and a policy tick (0.5 s), from the hammers' first push past the hole
CHAOS_SETTLE_S = 3.5


def _chaos_wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"chaos: {what}")


def _chaos_wait_action(engine, t0, pred, timeout_s=25.0):
    """The first policy audit entry at or after ``t0`` matching ``pred``
    (entries change in place as their action ends, so a poll sees
    ``started`` become ``ok``), or None."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for e in engine.audit():
            if e.get("mono", 0.0) >= t0 and pred(e):
                return e
        time.sleep(0.05)
    return None


def _chaos_store(params, device, lr=CHAOS_LR):
    import ps_tpu_torch as ps

    st = ps.KVStore(optimizer="sgd", learning_rate=lr, mode="async")
    st.init({k: torch.from_numpy(np.array(v)).to(device)
             for k, v in params.items()})
    return st


def _chaos_pair_start(out_dir, device):
    """Boot the SIGKILL drill's pair early, so the subprocess's start
    overlaps the main soak: its own coordinator (policy on), a backup in
    this process under a PromotionWatch, a registered spare on
    placeholder params, and a subprocess primary on ``device`` attached to
    the backup and registered under the pair's uri."""
    from ps_tpu_torch.backends.remote_async import AsyncPSService
    from ps_tpu_torch.chaos import member
    from ps_tpu_torch.elastic import Coordinator
    from ps_tpu_torch.elastic.member import register_spare
    from ps_tpu_torch.replica.watch import PromotionWatch

    tree = member.make_tree(CHAOS_PAIR_DIMS, seed=21)
    c2 = Coordinator(bind="127.0.0.1", report_ms=200, hb_timeout_ms=1200,
                     telemetry_window_s=2.0, policy="on",
                     policy_cooldown_s=3.0, policy_burn_windows=2)
    c2a = f"127.0.0.1:{c2.port}"
    # the backup starts at the primary's state point by construction (the
    # same make_tree seed in both processes)
    b0 = AsyncPSService(_chaos_store(tree, device), bind="127.0.0.1",
                        backup=True)
    watch = PromotionWatch(b0, primary_id=1, timeout_ms=1000)
    # the spare's placeholder params are evicted by the seed
    sp = AsyncPSService(_chaos_store(member.make_tree({"ph": 64}, seed=3),
                                     device),
                        bind="127.0.0.1", backup=True)
    register_spare(c2a, f"127.0.0.1:{sp.port}")
    pair = {"c2": c2, "c2a": c2a, "b0": b0, "watch": watch, "sp": sp,
            "tree": tree, "proc": None, "log": None}
    try:
        pair["proc"], pair["pid"], pair["port"], pair["log"] = member.spawn(
            "primary", "pair", out_dir, c2a,
            ",".join(f"{k}:{d}" for k, d in CHAOS_PAIR_DIMS.items()), 21,
            extra=("--backup", f"127.0.0.1:{b0.port}",
                   "--watch", f"127.0.0.1:{watch.port}",
                   "--watch-node", "1", "--report-ms", "200"),
            device=device)
    except BaseException:
        _chaos_pair_stop(pair)
        raise
    return pair


def _chaos_pair_stop(pair):
    for name in ("watch", "b0", "sp", "c2"):
        with contextlib.suppress(Exception):
            (pair[name].close if name == "watch" else pair[name].stop)()
    if pair["proc"] is not None:
        if pair["proc"].poll() is None:
            pair["proc"].kill()
        pair["proc"].wait()
        pair["log"].close()


def _chaos_pair_drill(pair, inj, note, device):
    """SIGKILL the subprocess primary under a hammering worker: the watch
    promotes the backup, the worker rides the failover, the policy
    re-seeds the used-up pair onto the spare; then each key's applies on
    the survivor equal the pushes, and the spare holds the survivor's
    params and apply counts bitwise."""
    import threading

    from ps_tpu_torch.backends.remote_async import connect_async
    from ps_tpu_torch.elastic.member import TelemetryReporter
    from ps_tpu_torch.obs.collector import collect_telemetry

    c2, b0, sp, watch = pair["c2"], pair["b0"], pair["sp"], pair["watch"]
    tree = pair["tree"]
    watch.wait_for_primary(60.0)
    like = {k: torch.from_numpy(v).to(device) for k, v in tree.items()}
    w = connect_async(f"127.0.0.1:{pair['port']}|127.0.0.1:{b0.port}", 0,
                      like, failover_timeout=30.0)
    rep = None
    stop = threading.Event()
    t = None
    try:
        w.pull_all()
        grads = {k: torch.full(v.shape, 0.5, dtype=torch.float32,
                               device=device) for k, v in tree.items()}
        w.push_pull(grads)
        # the worker's reports tick the pair coordinator's policy once the
        # dead pair stops reporting
        rep = TelemetryReporter(pair["c2a"], "chaos-pair-worker",
                                lambda: collect_telemetry(w.transport),
                                report_ms=200)
        pushes, errs = [1], []

        def hammer():
            try:
                while not stop.is_set():
                    w.push_pull(grads)
                    pushes[0] += 1
                    time.sleep(0.01)
            except BaseException as e:  # raised after the join
                errs.append(e)

        t = threading.Thread(target=hammer)
        t.start()
        time.sleep(1.0)  # replicated traffic first
        at_kill = pushes[0]
        t_kill = time.monotonic()
        inj.sigkill(pair["pid"])
        entry = _chaos_wait_action(
            c2.policy, t_kill,
            lambda e: e["action"] == "reseed" and e["outcome"] == "ok",
            timeout_s=30.0)
        if entry is None:
            raise AssertionError(f"chaos: the re-seed never fired: "
                                 f"{c2.policy.audit()[-6:]}")
        time.sleep(0.5)  # traffic replicated to the spare
        stop.set()
        t.join(timeout=60)
        if errs:
            raise RuntimeError(f"chaos: the pair's worker died: "
                               f"{errs[0]!r}") from errs[0]
        if watch.promoted_reason != "timeout" or b0.role != "primary":
            raise AssertionError(f"chaos: promotion {watch.promoted_reason}"
                                 f", role {b0.role}")
        if pushes[0] <= at_kill:
            raise AssertionError("chaos: the worker never resumed after "
                                 "the kill")
        healed = [u for u in c2.table().shards
                  if u.endswith(f"|127.0.0.1:{sp.port}")]
        if not healed or c2.table().epoch < 1:
            raise AssertionError(f"chaos: the healed pair is not published "
                                 f"({c2.table().shards}, epoch "
                                 f"{c2.table().epoch})")
        _chaos_wait(lambda: set(sp._engine._params) == set(tree)
                    and b0._backup_session is not None
                    and not b0._backup_session.degraded,
                    10.0, "the spare never adopted the pair's state")
        for k in tree:
            got = int(b0._engine.apply_count.get(k, 0))
            if got != pushes[0]:
                raise AssertionError(f"chaos: pair key {k} applied {got}x "
                                     f"for {pushes[0]} pushes")

        def mirrored():
            return all(
                sp._engine.apply_count.get(k) == b0._engine.apply_count[k]
                and torch.equal(sp._engine._params[k].cpu(),
                                b0._engine._params[k].cpu())
                for k in tree)

        _chaos_wait(mirrored, 10.0,
                    "the spare never mirrored the survivor bitwise")
        if any(b0._engine._params[k].device.type != torch.device(
                device).type for k in tree):
            raise AssertionError("chaos: the survivor's params left the "
                                 "device")
        note("sigkill", entry["mono"] + entry.get("seconds", 0.0) - t_kill,
             "policy:replica_reseed")
        pair["proc"].wait(timeout=10)
        return {"pushes": pushes[0], "epoch": c2.table().epoch,
                "fire_s": entry["mono"] - t_kill,
                "action_s": entry.get("seconds", 0.0)}
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=30)
        if rep is not None:
            rep.close()
        w.close()


def _chaos_agg_drill(inj, note, device):
    """The aggregator dies in the ledger's hardest window: the merged
    round-2 push commits upstream, then the aggregator dies before any
    member's ack. The members degrade to the flat path and replay, the
    replays dedup by the members' tokens, and with integer gradients at a
    power-of-two rate the parameters end bitwise at the closed form."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.aggregator import AggregatorService
    from ps_tpu_torch.backends.remote_async import serve_async
    from ps_tpu_torch.backends.van_service import VanService

    params = {"a": np.zeros((32, 16), np.float32),
              "b": np.ones((64,), np.float32)}
    store = _chaos_store(params, device, lr=CHAOS_AGG_LR)
    svc = serve_async(store, bind="127.0.0.1")
    uri = f"127.0.0.1:{svc.port}"
    like = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    agg = AggregatorService(uri, like, group_size=2)
    ws = [ps.connect_async(uri, w, like, aggregator=f"127.0.0.1:{agg.port}",
                           failover_timeout=10.0) for w in range(2)]
    done_t = [[None] * CHAOS_AGG_ROUNDS for _ in range(2)]
    killed = [0.0]
    try:
        for w in ws:
            w.pull_all()

        def grad(w, s):
            return {"a": torch.full((32, 16), float(3 * w + s + 1),
                                    device=device),
                    "b": torch.full((64,), float(2 * (w + 1) + s),
                                    device=device)}

        def rounds(lo, hi):
            errs = []

            def loop(i):
                try:
                    for s in range(lo, hi):
                        ws[i].push_pull(grad(i, s))
                        done_t[i][s] = time.monotonic()
                except BaseException as e:  # raised below
                    errs.append(e)

            ts = [threading.Thread(target=loop, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            if any(t.is_alive() for t in ts):
                raise AssertionError("chaos: an aggregated round wedged")
            if errs:
                raise errs[0]

        rounds(0, 2)  # two clean aggregated rounds
        orig = agg._client.push_pull

        def dying(*a, **kw):
            out = orig(*a, **kw)  # the merged push commits upstream...
            killed[0] = time.monotonic()
            inj.mark("agg_death", target=agg.port)
            VanService.kill(agg)  # ...then death, before any member's ack
            return out

        agg._client.push_pull = dying
        rounds(2, CHAOS_AGG_ROUNDS)  # death in round 2; 3-5 run flat
        for i, w in enumerate(ws):
            if w._agg_fallback is not None or w.transport.agg_degrades != 1:
                raise AssertionError(
                    f"chaos: worker {i} still aggregated or degraded "
                    f"{w.transport.agg_degrades}x")
        dedup = svc.transport.dedup_hits
        if dedup < 2:
            raise AssertionError(f"chaos: {dedup} dedup hits after the "
                                 f"aggregator's post-commit death")
        tot_a = sum(3 * w + s + 1 for w in range(2)
                    for s in range(CHAOS_AGG_ROUNDS))
        tot_b = sum(2 * (w + 1) + s for w in range(2)
                    for s in range(CHAOS_AGG_ROUNDS))
        a = store._engine._params["a"].cpu().numpy()
        b = store._engine._params["b"].cpu().numpy()
        if not (np.all(a == np.float32(0.0 - CHAOS_AGG_LR * tot_a))
                and np.all(b == np.float32(1.0 - CHAOS_AGG_LR * tot_b))):
            raise AssertionError(
                f"chaos: the aggregator drill's params are not the closed "
                f"form: a {float(a[0, 0])} for {0.0 - CHAOS_AGG_LR * tot_a},"
                f" b {float(b[0])} for {1.0 - CHAOS_AGG_LR * tot_b}")
        heal = max(min(x for x in done_t[i][2:] if x is not None)
                   for i in range(2)) - killed[0]
        note("agg_death", heal, "non_action:flat_degrade_replay")
        return {"dedup_hits": dedup, "applies": svc.apply_log.total}
    finally:
        for w in ws:
            w.close()
        agg.kill()
        svc.stop()


def _chaos_replay(tree, grads, pushes, device):
    """Each key's parameter after ``pushes`` applies of its gradient on one
    engine on ``device`` (sgd, DC λ 0: the order of the pushes and their
    workers change nothing)."""
    st = _chaos_store(tree, device)
    g = {k: torch.from_numpy(v).to(device) for k, v in grads.items()}
    eng = st._engine
    for _ in range(pushes):
        eng.push_tree(g, worker=0)
    return {k: eng._params[k].cpu() for k in tree}


def phase_chaos(tmp, device="cuda"):
    """26: the autopilot chaos soak on the card (ROADMAP item 6.3)."""
    import threading

    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import (AsyncPSService,
                                                    connect_async)
    from ps_tpu_torch.chaos import ChaosHook, ChaosInjector, member
    from ps_tpu_torch.elastic import Coordinator, request_rebalance
    from ps_tpu_torch.elastic.policy import ShardDrain

    card = _card_line()
    t0 = time.perf_counter()
    _launch_counts(reset=True)
    heal = {}  # fault class -> [{"heal_s", "resolved_by"}]

    def note(fault, heal_s, resolved_by):
        heal.setdefault(fault, []).append(
            {"heal_s": float(heal_s), "resolved_by": resolved_by})
        log(f"chaos: {fault} healed in {heal_s:.3f} s via {resolved_by}")

    dim = CHAOS_DIM
    shard_keys = [CHAOS_KEYS[0:3], CHAOS_KEYS[3:6], CHAOS_KEYS[6:9],
                  CHAOS_KEYS[9:12]]
    tree = member.make_tree({k: dim for k in CHAOS_KEYS}, seed=CHAOS_SEED)
    inj = ChaosInjector()
    plan = ChaosInjector(inj.seed).plan(list(CHAOS_BOUND_S), *CHAOS_PLAN)
    log(f"chaos: PS_CHAOS_SEED {inj.seed}; plan(classes, {CHAOS_PLAN[0]}, "
        f"{CHAOS_PLAN[1]}) = {json.dumps(plan)} (the reference's injector "
        f"plans the same: tests/test_torch_chaos.py)")
    ps.init(backend="cuda", device=device, mode="async", num_workers=2,
            dc_lambda=0.0)
    out_dir = os.path.join(tmp, "chaos")
    os.makedirs(out_dir)
    coord = None
    svcs, ws, ths = [], [], []
    pair = None
    proc3 = log3 = None
    stop = threading.Event()
    try:
        coord = Coordinator(
            bind="127.0.0.1", report_ms=200, hb_timeout_ms=1500,
            max_skew=4.0, telemetry_window_s=2.0,
            slo_rules="push_pull p99 < 400ms over 2s",
            policy="on", policy_cooldown_s=3.0, policy_burn_windows=2)
        ca = f"127.0.0.1:{coord.port}"
        pol = coord.policy
        # the underload rule waits for its own drill: the quiet gaps
        # between drills must not read as underload
        drain_rule = next(r for r in pol.rules if isinstance(r, ShardDrain))
        drain_rule.qps_floor = 0.0
        svcs = [AsyncPSService(_chaos_store({k: tree[k]
                                             for k in shard_keys[i]},
                                            device),
                               bind="127.0.0.1", coordinator=ca)
                for i in range(3)]
        hole = ChaosHook(svcs[2])  # the blackhole drill's interceptor
        proc3, pid3, port3, log3 = member.spawn(
            "shard", "s3", out_dir, ca,
            ",".join(f"{k}:{dim}" for k in shard_keys[3]), CHAOS_SEED,
            device=device)
        pair = _chaos_pair_start(out_dir, device)
        _chaos_wait(lambda: len(coord.table().shards) == 4, 60.0,
                    "the subprocess shard never joined the table")
        t_boot = time.perf_counter()

        rng = np.random.default_rng(1)
        grads_np = {k: rng.normal(0, 1e-3, (dim,)).astype(np.float32)
                    for k in CHAOS_KEYS}
        grads = {k: torch.from_numpy(v).to(device)
                 for k, v in grads_np.items()}
        like = {k: torch.from_numpy(v).to(device) for k, v in tree.items()}
        ws = [connect_async(None, w, like, coordinator=ca,
                            failover_timeout=60.0) for w in range(2)]
        for w in ws:
            w.pull_all()
            w.push_pull(grads)  # counted below
        storm = {"until": 0.0}
        counts = [1, 1]
        samples = ([], [])
        reconnects = [0, 0]
        errs = []

        def hammer(i):
            last_rc = 0.0
            try:
                while not stop.is_set():
                    now = time.monotonic()
                    if storm["until"] > now and now - last_rc > 0.25:
                        ws[i].reconnect()  # the storm: re-dial mid-run
                        reconnects[i] += 1
                        last_rc = now
                    t_push = time.monotonic()
                    ws[i].push_pull(grads)
                    done = time.monotonic()
                    counts[i] += 1
                    samples[i].append((done, done - t_push))
                    time.sleep(0.01)
            except BaseException as e:  # raised after the join
                errs.append(e)

        def stop_hammers():
            stop.set()
            for t in ths:
                t.join(timeout=60)
            if errs:
                raise RuntimeError(f"chaos: a hammer died mid-soak: "
                                   f"{errs[0]!r}") from errs[0]

        ths = [threading.Thread(target=hammer, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        t_soak0 = time.monotonic()
        time.sleep(2.0)  # an undisturbed baseline

        # A: a noisy neighbor slows shard 1's applies; the straggler
        # detector suspects it and the autopilot drains it
        tA = time.monotonic()
        inj.noisy_neighbor(svcs[1], 4.0, hold_s=0.05)
        eA = _chaos_wait_action(
            pol, tA, lambda e: e["action"] == "rebalance"
            and e["outcome"] == "ok" and e["detail"].get("suspects"),
            timeout_s=25.0)
        if eA is None or 1 not in eA["detail"]["suspects"]:
            raise AssertionError(f"chaos: the straggler drain never fired "
                                 f"on shard 1: {pol.audit()[-8:]}")
        _chaos_wait(lambda: coord.loads().get(1, 0) == 0, 10.0,
                    "the suspect shard never drained")
        note("slow_apply", eA["mono"] + eA.get("seconds", 0.0) - tA,
             "policy:hotspot_rebalance[drain_suspect]")
        inj.join()
        # suspicion clears, the rule re-arms, the cooldown ends
        _chaos_wait(
            lambda: pol.state()["rules"]["hotspot_rebalance"]["armed"],
            20.0, "the hotspot rule never re-armed after the drain")
        time.sleep(1.0)

        # B: SIGSTOP the subprocess shard; the parked pushes complete late
        # after SIGCONT, burn the SLO window, and the autopilot levels the
        # fleet (which refills the shard drill A drained)
        tB = time.monotonic()
        inj.sigstop(pid3)
        time.sleep(2.5)
        inj.sigcont(pid3)
        eB = _chaos_wait_action(
            pol, tB, lambda e: e["action"] in ("rebalance", "shard_add")
            and e["outcome"] == "ok", timeout_s=30.0)
        if eB is None:
            raise AssertionError(f"chaos: the SLO-burn rebalance never "
                                 f"fired: {pol.audit()[-8:]}")
        _chaos_wait(lambda: coord.loads().get(1, 0) > 0, 10.0,
                    "the leveling never refilled the drained shard")
        note("sigstop", eB["mono"] + eB.get("seconds", 0.0) - tB,
             f"policy:{eB['rule']}")

        # C: blackhole shard 2 inside B's cooldown: the brakes hold (no
        # action), the workers ride the typed refusal
        def n_exec():
            return sum(1 for e in pol.audit()
                       if e["outcome"] in ("started", "ok", "failed", "dry"))

        exec0, sup0 = n_exec(), sum(pol.suppressed_total.values())
        tC = time.monotonic()
        inj.blackhole(hole, 1.0)
        time.sleep(2.4)
        if n_exec() != exec0:
            raise AssertionError(f"chaos: the brakes failed: an action "
                                 f"inside the cooldown window: "
                                 f"{pol.audit()[-3:]}")
        if hole.refused <= 0:
            raise AssertionError("chaos: the blackhole refused no frame")
        supC = sum(pol.suppressed_total.values()) - sup0
        _chaos_wait(lambda: any(
            x > tC + 1.0 for x, _ in
            list(samples[0])[-3:] + list(samples[1])[-3:]),
            10.0, "the hammers never resumed after the blackhole")
        tsC = [x for x, _ in list(samples[0]) + list(samples[1])
               if x > tC + 1.0]
        note("blackhole", min(tsC) - tC,
             "non_action:park_retry(cooldown_held)")

        # settle, as after A: the hole's parked pushes reach the SLO
        # window with the workers' next report (1 s) and stay in it 2 s,
        # past B's 3 s cooldown (the hotspot rule re-arms between B and C
        # when B's own residue clears first), so D starts once they have
        # left it and every rule reads quiet; an action C's residue draws
        # meanwhile is printed, not hidden
        t_settle = time.monotonic()
        t_clear = min(tsC) + CHAOS_SETTLE_S
        _chaos_wait(lambda: time.monotonic() >= t_clear and all(
            r["quiet"] >= 1 and r["streak"] == 0
            for r in pol.state()["rules"].values()),
            20.0, "the policy never read quiet after the blackhole")
        # D: a reconnect storm, both hammers re-dialing every 250 ms for
        # 1.2 s: dedup keeps the ledger whole and nothing acts
        exec0 = n_exec()
        tD = time.monotonic()
        settle = [{k: e[k] for k in ("rule", "outcome", "detail")}
                  for e in pol.audit() if t_settle <= e["mono"] < tD
                  and e["outcome"] in ("started", "ok", "failed", "dry")]
        inj.reconnect_storm(storm, 1.2, target="hammer-workers")
        time.sleep(2.4)
        if sum(reconnects) < 2:
            raise AssertionError("chaos: the storm never re-dialed")
        if n_exec() != exec0:
            raise AssertionError(f"chaos: the reconnect storm drew a "
                                 f"policy action: {pol.audit()[-3:]}")
        tsD = [x for x, _ in list(samples[0]) + list(samples[1])
               if x > tD + 1.2]
        if not tsD:
            raise AssertionError("chaos: the hammers never resumed after "
                                 "the storm")
        note("reconnect_storm", min(tsD) - (tD + 1.2),
             "non_action:dedup_reconnect_continuity")

        # E: sustained underload: the hammers stop, the drain rule sees
        # the fleet's rate under its floor and scales 4 -> 2 itself
        stop_hammers()
        tE = time.monotonic()
        drain_rule.qps_floor = 1.0  # an idle fleet is now real underload
        eE = _chaos_wait_action(
            pol, tE, lambda e: e["action"] == "shard_remove"
            and e["outcome"] == "ok", timeout_s=30.0)
        if eE is None:
            raise AssertionError(f"chaos: the underload drain never fired: "
                                 f"{pol.audit()[-8:]}")
        if len(coord.table().shards) != 2:
            raise AssertionError(f"chaos: {coord.table().shards} after the "
                                 f"underload drain")
        note("underload", eE["mono"] + eE.get("seconds", 0.0) - tE,
             "policy:shard_drain")
        t_soak1 = time.monotonic()
        actions = dict(pol.actions_total)
        suppressed = dict(pol.suppressed_total)
        t_main = time.perf_counter()

        agg = _chaos_agg_drill(inj, note, device)
        t_agg = time.perf_counter()
        pair_out = _chaos_pair_drill(pair, inj, note, device)
        t_pair = time.perf_counter()

        # the ledger across the main fleet, after the soak window: if the
        # subprocess shard still holds keys, an operator drain moves them
        # into this process's shards so their counts can be read
        audit_drain = False
        s3 = next((m for m in coord._members_view()
                   if m["uri"].endswith(f":{port3}")), None)
        if s3 is not None and coord.loads().get(s3["shard"], 0) > 0:
            request_rebalance(ca, drain=[s3["shard"]])
            audit_drain = True
        pushes = counts[0] + counts[1]
        final = {}
        for k in CHAOS_KEYS:
            held = [s for s in svcs if k in s._engine._params]
            total = sum(s._engine.apply_count.get(k, 0) for s in svcs
                        if k in s._engine._params)
            if total != pushes or len(held) != 1:
                raise AssertionError(f"chaos: key {k} applied {total}x for "
                                     f"{pushes} pushes on {len(held)} "
                                     f"shards")
            final[k] = held[0]._engine._params[k]
            if final[k].device.type != torch.device(device).type:
                raise AssertionError(f"chaos: key {k} left the device")
        # the subprocess shard made its keys from its own spec (the same
        # make_tree seed over its 3 keys, not the 12)
        init = dict(tree, **member.make_tree(
            {k: dim for k in shard_keys[3]}, seed=CHAOS_SEED))
        want = _chaos_replay(init, grads_np, pushes, device)
        for k in CHAOS_KEYS:
            if not torch.equal(final[k].cpu(), want[k]):
                raise AssertionError(
                    f"chaos: key {k} is not bitwise its replay (max diff "
                    f"{float((final[k].cpu() - want[k]).abs().max())})")
        t_replay = time.perf_counter()
        for fault, rows in heal.items():
            for r in rows:
                if r["heal_s"] > CHAOS_BOUND_S[fault]:
                    raise AssertionError(f"chaos: {fault} healed in "
                                         f"{r['heal_s']:.3f} s, over its "
                                         f"bound {CHAOS_BOUND_S[fault]} s")
        if sorted(heal) != sorted(CHAOS_BOUND_S):
            raise AssertionError(f"chaos: fault classes healed "
                                 f"{sorted(heal)}")
        if not any(o == "ok" for (_, o) in actions):
            raise AssertionError(f"chaos: no policy action ended ok: "
                                 f"{actions}")
        _no_launches("chaos (phase 26)")
    finally:
        stop.set()
        for t in ths:
            t.join(timeout=30)
        with open(os.path.join(out_dir, "done"), "w") as f:
            f.write("done\n")  # the subprocess members' exit cue
        for w in ws:
            with contextlib.suppress(Exception):
                w.close()
        for s in svcs:
            with contextlib.suppress(Exception):
                s.stop()
        if pair is not None:
            _chaos_pair_stop(pair)
        if coord is not None:
            with contextlib.suppress(Exception):
                coord.stop()
        if proc3 is not None:
            try:
                proc3.wait(timeout=10)
            except Exception:
                proc3.kill()
                proc3.wait()
            log3.close()
        ps.shutdown()
    allheal = [r["heal_s"] for rows in heal.values() for r in rows]
    p99 = float(np.percentile(allheal, 99))
    for fault in CHAOS_BOUND_S:
        hs = [r["heal_s"] for r in heal[fault]]
        log(f"chaos: {fault}: n {len(hs)}, heal p50 "
            f"{float(np.percentile(hs, 50)):.3f} s, p99 "
            f"{float(np.percentile(hs, 99)):.3f} s (bound "
            f"{CHAOS_BOUND_S[fault]} s), resolved by "
            f"{sorted({r['resolved_by'] for r in heal[fault]})}")
    total = time.perf_counter() - t0
    acted = {f"{a}:{o}": n for (a, o), n in sorted(actions.items())}
    log(f"chaos: chaos_self_heal_p99_s {p99:.3f} over {len(allheal)} heals;"
        f" soak window {t_soak1 - t_soak0:.1f} s, no operator call in it "
        f"(the post-soak audit drain: {audit_drain}); policy actions "
        f"{json.dumps(acted)}, suppressed {json.dumps(suppressed)} ({supC} during the "
        f"blackhole); between C and D (settling {tD - t_settle:.3f} s): "
        f"{json.dumps(settle)}; the hole refused {hole.refused} frames; "
        f"{sum(reconnects)} re-dials; {pushes} pushes of the "
        f"{len(CHAOS_KEYS)} x {dim} f32 tree, each key applied {pushes}x "
        f"across the fleet and bitwise its replay on one engine "
        f"({'on the card' if device == 'cuda' else device}); aggregator "
        f"drill: {agg['dedup_hits']} dedup hits, the closed form bitwise; "
        f"pair drill: {pair_out['pushes']} pushes, the re-seed fired "
        f"{pair_out['fire_s']:.3f} s after the kill and took "
        f"{pair_out['action_s']:.3f} s, survivor and re-seeded spare "
        f"bitwise, table epoch {pair_out['epoch']}; injections "
        f"{[r['fault'] for r in inj.injections]}; no kernel launched; boot "
        f"{t_boot - t0:.1f} s, soak {t_main - t_boot:.1f} s, aggregator "
        f"{t_agg - t_main:.1f} s, pair {t_pair - t_agg:.1f} s, audit and "
        f"replay {t_replay - t_pair:.1f} s; phase {total:.1f} s; card "
        f"{card}")
    return {"seconds": total, "heal": heal, "p99": p99, "pushes": pushes,
            "refused": hole.refused, "reconnects": sum(reconnects)}


# phase 27: a dense async server across ranks (ROADMAP item 6.4,
# backends/op_stream.py): two gloo ranks of one async store sharing the
# card, served on rank 0, which sends every engine call to rank 1 first.
# (a) config 5 through the trainer's --role server launched as 2 ranks
# (its own defaults: MLP hidden 32, sgd, lr 0.1, λ 0.04; 'replicated'),
# the native loop on, worker 0 serial and worker 1 bucketed, then the
# same run on one rank; (b) config 5's MLP at 784-256-10 served through
# the API (adam, 'sharded': each rank holds its blocks of the moments)
# by the ranks harness's served case, driven with the harness's
# scenario_primary and replayed the same way on one rank in this process
SERVED_WORKERS, SERVED_CYCLES = 2, 40
SERVED_HIDDEN = 256
SERVED_MOVED = ("dense1/kernel", "dense2/bias")  # (b): half the keys
SERVED_LR = 1e-3
SERVED_TIMEOUT_S = 240
SERVED_BIRTH = {"birth": 1700000000.5, "bmono": 123.25, "bpid": "served"}


def _served_trainer_main(out, argv):
    """A server process of phase 27 (a): the trainer's ``main(argv)``, then
    this process's kernel launch counts into ``<out>/launches-<rank>.json``
    (its rank from ``PS_PROCESS_ID``, 0 alone)."""
    from ps_tpu_torch.examples import train_mnist_async

    train_mnist_async.main(argv)
    rank = os.environ.get("PS_PROCESS_ID", "0")
    with open(os.path.join(out, f"launches-{rank}.json"), "w") as f:
        json.dump(_launch_counts(), f)


def _served_config5(out, ranks, device):
    """(a)'s run: the trainer's --role server as ``ranks`` processes
    (one group over gloo on ``device``, rank 0 serving on the native
    loop) and its two workers. Returns the servers' record, every rank's
    params and launch counts, and the workers' records."""
    here, env = _van_env()
    os.makedirs(out)
    port, group = _distinct_ports(2)
    procs = []
    try:
        for r in range(ranks):
            e = dict(env, PS_VAN_NATIVE_LOOP="1")
            if ranks > 1:
                e.update(PS_COORDINATOR_URI=f"127.0.0.1:{group}",
                         PS_NUM_PROCESSES=str(ranks), PS_PROCESS_ID=str(r),
                         PS_DIST_BACKEND="gloo", LOCAL_RANK="0")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--served-trainer", out, "--role", "server", "--port",
                 str(port), "--num-workers", str(SERVED_WORKERS), "--dump",
                 out, "--device", device], cwd=here, env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for w in range(SERVED_WORKERS):
            procs.append(_spawn_trainer(
                "--role", "worker", "--server", f"127.0.0.1:{port}",
                "--worker-id", w, "--steps", SERVED_CYCLES, "--dump", out,
                "--device", device,
                *(["--bucket-bytes", VAN_BUCKET_BYTES, "--pool", VAN_POOL]
                  if w == 1 else [])))
        deadline = time.monotonic() + SERVED_TIMEOUT_S
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        _stop_all(procs)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"served (a): {' '.join(p.args[2:8])} "
                                 f"exited {p.returncode}:\n{o[-3000:]}")
    infos, final, records = _van_dumps(out, SERVED_WORKERS)
    params = [final] + [torch.load(os.path.join(
        out, f"server_params.rank{r}.pt")) for r in range(1, ranks)]
    launches = [json.load(open(os.path.join(out, f"launches-{r}.json")))
                for r in range(ranks)]
    return infos[0], params, launches, records


def _served_api(tmp, device):
    """(b): the two ranks (the harness's served case on cuda:0) and the
    same frames against one rank in this process, each with its helpers
    (a one-process shard a move goes to and comes back from, a spare)
    here on the card."""
    import ps_tpu_torch as ps
    from ps_tpu_torch.backends.remote_async import serve_async
    from ps_tpu_torch.kv import keys
    from ps_tpu_torch.models.mlp import MLP
    from ps_tpu_torch.obs import freshness

    rh = _ranks_harness()
    tree = MLP(hidden=SERVED_HIDDEN).init(torch.Generator().manual_seed(0))
    params = {k: v.numpy().copy()
              for k, v in keys.flatten_with_keys(tree)[0].items()}
    rng = np.random.default_rng(27)
    grads = [{k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
              for k, v in params.items()} for _ in range(8)]
    opt = {"optimizer": "adam", "opt_kw": {"learning_rate": SERVED_LR},
           "placement": "sharded"}
    init = {"device": "cuda:0" if device == "cuda" else device,
            "mode": "async", "num_workers": 2, "dc_lambda": 0.04}
    ctl = os.path.join(tmp, "ctl")
    os.makedirs(ctl)
    run = rh.start_ranks(2, [("served", dict(
        opt, params=params, ctl=ctl, name="A", native_loop=True,
        stamp=SERVED_BIRTH))], tmp, init=init)
    orig = freshness.birth_record
    freshness.birth_record = lambda wall=None, mono=None: dict(SERVED_BIRTH)
    ps.init(backend="cuda", **init)
    try:
        def store(p):
            st = ps.KVStore(mode="async", placement="sharded",
                            optimizer="adam", learning_rate=SERVED_LR)
            st.init(rh.like(p, device))
            return st

        def drive(port, ckpt):
            b = serve_async(store({"y/ph": np.ones(3, np.float32)}))
            c = serve_async(store({"z/ph": np.zeros(4, np.float32)}),
                            backup=True)
            try:
                t0 = time.perf_counter()
                got = rh.scenario_primary(port, b.port, c.port, ckpt, params,
                                          grads, SERVED_MOVED,
                                          VAN_BUCKET_BYTES, device=device)
                got["seconds"] = time.perf_counter() - t0
                got["C"] = rh.served_rows(c._engine)
            finally:
                b.stop()
                c.stop()
            return got

        def restored(ckpt):
            st = store(params)
            st.restore(ckpt, elastic=True)
            return rh.served_rows(st._engine)

        port_file = os.path.join(ctl, "A.port")
        deadline = time.monotonic() + SERVED_TIMEOUT_S
        while not os.path.exists(port_file):
            if any(p.poll() is not None for p in run.procs):
                run.finish(wall_s=5)  # raises with the rank's output
            if time.monotonic() > deadline:
                raise TimeoutError("served (b): rank 0 never listened")
            time.sleep(0.05)
        try:
            two = drive(int(open(port_file).read()),
                        os.path.join(tmp, "ckpt-two"))
        finally:
            open(os.path.join(ctl, "A.done"), "w").close()
        ranks = [r[0] for r in run.finish(wall_s=SERVED_TIMEOUT_S)]
        two["restored"] = restored(os.path.join(tmp, "ckpt-two"))
        one_store = store(params)
        svc = serve_async(one_store, native_loop=True)
        try:
            one = drive(svc.port, os.path.join(tmp, "ckpt-one"))
        finally:
            svc.stop()
        one["final"] = rh.served_rows(one_store._engine)
        one["restored"] = restored(os.path.join(tmp, "ckpt-one"))
    finally:
        ps.shutdown()
        freshness.birth_record = orig
    for tag, reply in one["replies"].items():
        rh.same_reply(two["replies"][tag], reply, f"served (b) {tag}")
    for k, v in one["bucketed"].items():
        np.testing.assert_array_equal(two["bucketed"][k], v, err_msg=k)
    for r, got in enumerate(ranks):
        rh.same_rows(got, one["final"], f"served (b) rank {r}")
        if any(got["launches"].values()):
            raise AssertionError(f"served (b): rank {r} launched kernels: "
                                 f"{got['launches']}")
    rh.same_rows(two["C"], one["C"], "served (b) the re-seeded spare")
    rh.same_rows(two["restored"], one["restored"],
                 "served (b) the checkpoint restored into one process")
    for k, v in two["replies"]["read_ckpt"]["tensors"].items():
        np.testing.assert_array_equal(two["restored"]["params"][k], v,
                                      err_msg=f"served (b) checkpoint {k}")
    if ranks[1]["by_op"] != ranks[0]["by_op"]:
        raise AssertionError(f"served (b): rank 1 ran {ranks[1]['by_op']}, "
                             f"rank 0 sent {ranks[0]['by_op']}")
    events = [op for op, _ in ranks[0]["event_log"]]
    pushes = ranks[0]["by_op"].get("push", 0)
    if pushes != events.count("push") or \
            ranks[0]["by_op"]["pull"] != events.count("pull"):
        raise AssertionError(f"served (b): ops {ranks[0]['by_op']} against "
                             f"the event log's {len(events)} events")
    return {"two": two, "one": one, "ranks": ranks, "pushes": pushes}


def _ranks_harness():
    """``tests/test_torch_ranks_harness.py`` of this checkout, loaded by its
    path: its ``start_ranks`` runs cases on rank processes, and its served
    case and ``scenario_primary`` serve and drive a store across ranks."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_ranks_harness.py")
    spec = importlib.util.spec_from_file_location("_ranks_harness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_served_ranks(tmp, device="cuda"):
    """27: a dense async server across two gloo ranks sharing the card
    (item 6.4): (a) config 5 through the trainer's --role server as two
    ranks, both ranks bitwise each other and the event log's one-process
    replay on the card, against one rank's cycles/s; (b) through the API
    (adam, 'sharded'): pushes, READ and NOT_MODIFIED, checkpoint_all,
    a live move out and back, a RESEED and its promotion, each bitwise
    the same frames on one rank. No kernel of the port runs. (``device``
    'cpu' rehearses it without a card: its timings are the CPU's.)"""
    t_phase = time.perf_counter()
    _launch_counts(reset=True)
    card = _card_line()
    info, params, launches, records = _served_config5(
        os.path.join(tmp, "a2"), 2, device)
    total = SERVED_WORKERS * SERVED_CYCLES
    if info["version"] != total:
        raise AssertionError(f"served (a): version {info['version']}, "
                             f"{total} pushes sent")
    for k, v in params[0].items():
        if not torch.equal(params[1][k], v):
            raise AssertionError(f"served (a): {k} differs between the ranks")
    replayed = _van_harness().replay([info["event_log"]], SERVED_WORKERS,
                                     device)
    for k, v in params[0].items():
        if not torch.equal(replayed[k].cpu(), v):
            raise AssertionError(f"served (a): {k} is not bitwise the event "
                                 f"log's one-process replay")
    for r, counts in enumerate(launches):
        if any(counts.values()):
            raise AssertionError(f"served (a): rank {r} launched kernels: "
                                 f"{counts}")
    two = _van_mnist_numbers(types.SimpleNamespace(records=records))
    _, _, one_launches, one_records = _served_config5(
        os.path.join(tmp, "a1"), 1, device)
    one = _van_mnist_numbers(types.SimpleNamespace(records=one_records))
    if any(one_launches[0].values()):
        raise AssertionError(f"served (a): one rank launched kernels: "
                             f"{one_launches[0]}")
    st = info["op_stream"]
    per_push = st["bytes_by_op"]["push"] / st["by_op"]["push"]
    log(f"served (a): config 5 through train_mnist_async --role server as "
        f"2 gloo ranks on the card (MLP hidden 32, sgd, lr 0.1, λ 0.04, "
        f"'replicated', the native loop), worker 0 serial and worker 1 "
        f"bucketed ({VAN_BUCKET_BYTES} B), {SERVED_CYCLES} cycles each: "
        f"version {info['version']}, both ranks' params bitwise each other "
        f"and the event log's one-process replay on the card; "
        f"{two['cycles_per_s']:.1f} cycles/s (median cycle "
        f"{two['median_cycle_ms']:.3f} ms) against "
        f"{one['cycles_per_s']:.1f} (median {one['median_cycle_ms']:.3f} "
        f"ms) on one rank; the op stream {st['ops']} ops, {st['bytes']:,} "
        f"bytes, {per_push:.0f} bytes a push, "
        f"{st['ops'] / st['by_op']['push']:.2f} ops a push ({st['by_op']}); "
        f"no kernel launched in any rank; card {card}")
    b = _served_api(os.path.join(tmp, "b"), device)
    r0 = b["ranks"][0]
    reps = b["two"]["replies"]
    log(f"served (b): config 5's MLP 784-{SERVED_HIDDEN}-10 through "
        f"init/KVStore(adam, 'sharded')/serve_async on 2 gloo ranks on the "
        f"card, the native loop: pushes (serial, a replay, bucketed), READ "
        f"and NOT_MODIFIED, checkpoint_all (restored into one process "
        f"bitwise), a move of {list(SERVED_MOVED)} to a one-process shard "
        f"and back, a RESEED onto a one-process spare and its promotion: "
        f"every reply and both ranks' rows (params, adam moments, stale "
        f"snapshots, apply counts) bitwise the same frames on one rank; "
        f"the op stream {r0['ops']} ops, {r0['op_bytes']:,} bytes "
        f"({r0['by_op']}), "
        f"{r0['bytes_by_op']['push'] / r0['by_op']['push']:.0f} bytes a "
        f"push; move out {reps['move_out']['extra']['seconds']} s and back "
        f"{reps['move_back']['extra']['seconds']} s (one rank: "
        f"{b['one']['replies']['move_out']['extra']['seconds']} s, "
        f"{b['one']['replies']['move_back']['extra']['seconds']} s), "
        f"re-seed {reps['reseed']['extra']['seconds']} s (one rank "
        f"{b['one']['replies']['reseed']['extra']['seconds']} s); scenario "
        f"{b['two']['seconds']:.2f} s on 2 ranks, {b['one']['seconds']:.2f} "
        f"s on one; card {card}")
    _no_launches("phase 27 (a dense async server across ranks)")
    total_s = time.perf_counter() - t_phase
    log(f"served: phase {total_s:.1f} s; card {card}")
    return {"seconds": total_s, "cycles_per_s": [two["cycles_per_s"],
                                                 one["cycles_per_s"]]}


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--two-ranks-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _two_ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--two-ranks-ea-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _two_ranks_ea_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--axes-bert-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _axes_bert_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--axes-lm-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _axes_lm_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--tiered-ranks-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _tiered_ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--elastic-coords":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _elastic_coords(sys.argv[2])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--elastic-server":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _elastic_server(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--served-trainer":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _served_trainer_main(sys.argv[2], sys.argv[3:])
        return 0
    if len(sys.argv) == 6 and sys.argv[1] == "--van-heartbeat-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _van_heartbeat_worker(int(sys.argv[2]), int(sys.argv[3]),
                              int(sys.argv[4]), sys.argv[5])
        return 0
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
    t_script = time.perf_counter()
    with _clock(1):
        phase_environment()
    with _clock(2):
        phase_build()
    with _clock(3):
        errs = phase_kernel_vs_plain()
    with _clock(4):
        phase_small_path_vs_cpu()
        by_rule, group_launches, _ = phase_main_path()
    with _clock(5):
        entries = phase_timings(errs, by_rule, group_launches)
    with _clock(6):
        flash_err = phase_flash_vs_plain()
    with _clock(7):
        phase_bert_small_vs_cpu()
        phase_bert_flash_vs_full()
        launches, _ = phase_bert_main_path()
    with _clock(8):
        entries.append(phase_flash_timings(flash_err, launches))
    with _clock(9):
        phase_resnet_vs_cpu()
    with _clock(10):
        phase_resnet_main_path()
    with _clock(11):
        phase_mnist_local()
    with _clock(12):
        phase_mnist_async()
    with _clock(13):
        phase_checkpoint_resume()
    with _clock(14):
        phase_nccl_one_rank()
    import tempfile

    def run(n, prefix, fn, **kw):
        with _clock(n), tempfile.TemporaryDirectory(prefix=prefix) as tmp:
            return fn(tmp, **kw)

    launches, flash_two = run(15, "ps_ranks_", phase_two_ranks)
    van = run(16, "ps_van_", phase_van)
    sparse = run(17, "ps_sparse_", phase_sparse_ps)
    axes = run(18, "ps_axes_", phase_axes)
    transport = run(19, "ps_transport_", phase_transport,
                    tcp_sparse=sparse["numbers"], tcp_config5=van["mnist"])
    replication = run(20, "ps_replica_", phase_replication,
                      unreplicated=sparse["numbers"])
    read = run(21, "ps_read_", phase_read_path, pushed=sparse["numbers"])
    run(22, "ps_agg_", phase_aggregation)
    tiered = run(23, "ps_tiered_", phase_tiered, untiered=sparse["numbers"])
    observed = run(24, "ps_obs_", phase_obs)
    elastic = run(25, "ps_elastic_", phase_elastic)
    run(26, "ps_chaos_", phase_chaos)
    run(27, "ps_served_", phase_served_ranks)
    for e in entries:  # each rank's launches in phase 15's 20-step runs
        if e["name"] == "flash_attention/fwd":
            # each rank's launches over phase 15 (e)'s bf16 steps, and the
            # kernel's time at a rank's shape
            e["launches_per_rank_two_ranks"] = flash_two["launches"]
            e["two_ranks"] = {k: flash_two[k] for k in (
                "steps", "rank_shape", "rank_shape_ms")}
            # phase 18: a tensor-parallel rank's heads (a) and the causal
            # LM's head width 64 (c)
            e["tensor_parallel_rank"] = axes["tp_rank"]
            e["causal_lm"] = axes["causal_lm"]
        if e["name"].startswith("sparse"):
            e["launches_per_rank_two_ranks"] = {
                exchange: counts[e["name"]]
                for exchange, counts in launches.items()}
            # the servers' launches in phase 17 (a) and in phase 19 (a)-(b)
            # (the native loop over TCP and over the rings, int8 and cast16
            # row grads), and the
            # kernel's time at a server shard's shape
            e["launches_sparse_ps"] = sparse["launches"][e["name"]]
            e["launches_transport"] = transport["launches"][e["name"]]
            # phase 20 (a): the backups' launches for the replicated
            # pushes, in their own processes
            e["launches_replication_backups"] = \
                replication["launches"][e["name"]]
            # phase 21 (a): the primaries' and backups' launches for the
            # churn pushes the reads ran beside (the reads launch none)
            e["launches_read_path"] = read["launches"][e["name"]]
            # phase 23: the hot tiers' launches in (a) one process, (b)
            # the served shards (the live servers) and (c) a gloo rank
            e["launches_tiered"] = tiered["launches"][e["name"]]
            # phase 24 (a): the traced run's servers (backup 0, promoted,
            # and primary 1), equal to the same pushes replayed untraced
            e["launches_obs"] = observed["launches"][e["name"]]
            # phase 25 (c): the sparse members' launches (shard 0, shard 1
            # and its replacement) for the pushes they applied
            e["launches_elastic"] = elastic["launches"][e["name"]]
            part = sparse["shard"][e["name"].split("/")[-1]
                                   if "/" in e["name"] else "group"]
            e["sparse_ps_shard"] = {"ids": sparse["shard"]["ids"],
                                    "ms": part["ms"],
                                    "bound_ms": part["bound_ms"],
                                    "plain_ms": part["plain_ms"]}
    log(json.dumps({"phase_seconds": PHASE_SECONDS, "script_seconds": round(
        time.perf_counter() - t_script, 1), "card": _card_line()}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
