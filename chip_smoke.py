#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each (any failure raises and exits non-zero). The
multi-rank runs of one mesh within a phase share one spawn of the rank
processes (``spawn_batch``: phases 9, 10, 12-14, 16-18, 21, 23 and 25-27),
each run's launches and peak its own; run whole, the script keeps one
pool of rank processes a world size (``RankPool``, started beside the
build) and runs every such batch there as a fresh spawn would:

1. device  — the card's name and power limit; TF32 off for matmuls and
   convolutions, so every f32 product runs in full f32.
2. build   — compile every CUDA kernel of the port from csrc/ (one nvcc
   per source, all started together; the C++ host library of phase 20,
   ``native/``, with g++ beside them), timed, with ptxas's report and,
   per tensor-core kernel (``*_mma_kernel``: the flash and ring forward,
   dq and dk/dv, bf16 and f32 in split TF32), its registers and spill
   bytes: any spill fails the phase, and so does a fresh build that
   lacks one of ``MMA_KERNELS`` at a head dim of ``HEAD_DIMS`` (32, 64,
   128).
3. kernels — hold each kernel against its plain PyTorch version on the
   same CUDA tensors (``paged_agrees``: f32 at atol = rtol = 1e-5,
   bf16 each head's row within min(2e-2, 1/32 of its largest value)),
   over the serving slice's shape, MHA, MQA, a larger page and a long
   cache (n_pt 512, lanes at 4,096-8,191), and the position edge cases
   (0, P-1, P, the last position, a split boundary of the kernel's
   split-KV grid and one page past it, a lane parked on the scratch
   page). At the slice's shape (serve positions) and the long shape,
   f32 and bf16: kernel, plain version and library call timed with CUDA
   events (median of 20 after warm-up, L2 flushed before each), and the
   kernel's bound computed. Then the kernel at every split count S of
   ``SPLIT_COUNTS`` against the S the wrapper picks, at
   ``SPLIT_SHAPES``.
4. serve   — the port's ``serve`` at the full width of the repo's gqa4
   decode model (d_model 2048, 16 heads, 4 KV heads, 8 layers, d_ff
   8192, vocab 32768, rope, f32, random weights from --seed 0) over 16
   requests through ``--paged --paged-attention kernel``, in turns with
   ``--paged-attention gather`` (gather, kernel, kernel, gather); asserts
   every request completes and the kernel launched once per layer per
   decode step of the first kernel run; one decode step's logits through
   the kernel match the gather path on the same pool state (atol 1e-3),
   with a torch.profiler breakdown of that step; the greedy tokens match
   the gather run's wherever its top-2 logit gap exceeds 1e-3.

5. kernels (flash) — hold the flash forward, dq and dk/dv kernels (all
   on tensor cores: bf16, and f32 in split TF32) against their plain
   PyTorch versions on the same CUDA tensors: f32 at 2e-5 (forward) and
   5e-5 (gradients), bf16 at 3e-2 (the JAX package's tolerances), over
   the training slice's shape (B 8, T 2048, 16 heads of 128), GQA (4 KV
   heads), MQA, a 256 window, non-causal, a ragged T of 1000, Tq != Tk
   with offsets, head_dim 64 and 32, and the CLI defaults' shape (B 2,
   T 32, 4 heads of 32: less than one 64-row tile, phase 15's
   attention). At the slice's shape, in bf16
   and f32: each kernel, the plain version and the library call
   (``scaled_dot_product_attention``, forward, and its backward) timed as
   above, and each kernel's bound computed from the live (q, k) pairs
   (f32 also at the split-TF32 rate, 495 / 3 TFLOP/s, beside the CUDA
   cores' 67).
6. train   — the port's ``train`` at the flagship training configuration
   (d_model 2048, 16 heads, 8 layers, d_ff 8192 gelu, vocab 32768, bf16
   compute, f32 masters, adamw lr 1e-4, batch 8, seq 2048, 6 steps,
   random weights from seed 0) through ``run_train``; asserts finite
   losses and each flash counter at n_layers x steps; reports wall ms
   per step after step 1, tokens/s and MFU against the bf16 peak; then a
   torch.profiler window of 2 steps on the trained weights: device ms by
   kernel, the flash kernels' share, the device's idle share.
7. train parity — full width, the gqa4 variant (4 KV heads, rope),
   batch 2, seq 2048, from one set of weights, in f32 and in bf16 (the
   forward, dq and dk/dv on tensor cores, f32 in split TF32): step-0
   loss and grads through the kernels against
   ``attn_impl="local"`` from the weights and batch of each of
   ``PARITY_SEEDS``, then two steps of each from seed 0, at ``PARITY_TOL``
   (f32: loss within 1e-5 relative, every gradient leaf within 1e-3 of
   that leaf's largest value, step-1 loss within 1e-4; bf16: 2e-3, 3e-2
   and 5e-3, the reasons beside the table); the losses finite and each
   flash kernel launched once per layer per step. A control must fail the
   gradient limit: the same step-0 check with dk/dv missing one query
   head's share of its GQA group (``drop_query_head``).

8. sync kernels — hold the gradient sync's kernels against their plain
   PyTorch versions on the same CUDA tensors: the masked reduce (allclose
   at rtol 1e-6, the count exact) on the staging matrix that phase 9's
   f32 sync gives it (2 ranks x half the flattened bucket matrix, every
   rank valid, target 2), bench_suite's (8 x 3,276,800 f32, peer 3
   masked, target 8), zero contributors and a ragged width; the six int8
   kernels bitwise (values and scales) on the flagship's bucket matrix
   (ceil(params / 65,536) rows x 65,536 f32, per-row scales and
   512-column blocks; the in-kernel Philox against the plain Philox, and
   its seed read from device memory, as a captured chunk's table holds
   it, against the by-value seed; that launch timed at the main shape,
   ``pointer_seed_ms``) and on (5, 1000), (3, 1001) and blocks 128 and
   512. At the main shapes
   each kernel, its plain version and the one PyTorch call that computes
   the same function (where there is one) timed as above, and each
   kernel's byte bound computed. A quantize kernel is timed as its launch
   alone on precomputed scales; the scale pass (abs-max, outside the
   kernel as in the JAX package) and the whole wrapper are timed beside
   it. The masked reduce also on strided slabs, bitwise, as phase 19's
   chunk reduce reads them (``strided_reduce_cases``: rows of 195 and
   193 floats in chunks of 3, at offsets that are not 16-byte aligned;
   a row of 196 in chunks of 4, the float4 path; phase 19 (c)'s block
   in chunks of 65,536, timed).
18. transport (runs after phase 8) — the ``ipc`` rank transport that
   phases 9, 13, 16 and 17 ride (every payload device to device through
   CUDA IPC peer buffers, gloo only for the control plane), on spawned
   ranks at n = 2, 3 and 4 (a (2, 2) mesh): ``all_to_all``,
   ``all_gather``, ``exchange`` and ``ppermute`` in f32, bf16 and int8
   on the world and on both lines of the mesh, each pair one 64 MiB
   chunk and 12 bytes, every output bitwise its gloo twin's (the same
   process group's host wire, the same inputs); at two ranks also the
   f32 sync's all_to_all of 2.16 GB a rank (17 chunks a pair) against
   its twin; each collective timed (host clock from a drained stream to
   ``transport.wait``, median of 5 between barriers, the slowest rank's)
   with its GB/s, two byte bounds at the one card's 3.35 TB/s shared by
   every rank (the function's: each rank's input read and output written
   once, the kernels line's ``bound_ms``; the copies': push and pull each
   read and write a received byte, local blocks read and written once)
   and the copies, stretches and waits it enqueued; and the fault
   control: rank 1 skips an all_gather, and rank 0's ``transport.wait``
   must raise within its timeout, ``TRANSPORT_FAULT_TIMEOUT_S`` (5 s),
   plus the watchdog's poll, naming the counter it waits on. The cases
   and the rank side are ``tests/torch_transport_ranks.py``'s, shared
   with the card tests.
9. train, dp=2 — ``train --dp 2 --dist-backend ipc`` at the flagship
   configuration of phase 6, 3 steps each on the f32 (``none``), int8 and
   ef8 wires: two rank processes share the card, their wire device to
   device (phase 18). Each run has a gloo twin (host-memory wire; f32
   and int8 2 steps, ef8 all 3) whose losses, and for ef8 parameters and
   residual checksums, must be bitwise the ipc run's, and whose peak per
   rank must not be below the ipc run's. Asserts finite losses, parameters
   bitwise equal on both ranks (a checksum each), rank 0's flash and
   sync launch counts equal to what the schedule implies per step x
   steps (computed here); the f32 run's losses within 5e-5 relative of
   phase 6's first 3 steps (same seed-0 weights, same global batches:
   a sum that drops or repeats a rank's gradient moves step 1 and 2 far
   more), and the int8 and ef8 runs' within 0.05 of the f32 run's (the
   JAX tests' bound). Reports wall and sync ms per step, each rank's
   peak memory and transport buffers, and the twin's. Each ipc run's
   ranks trace their step-1 gradient sync with ``torch.profiler`` (the
   step the per-step means leave out): the window must hold the
   transport's kernels and no ``Memcpy`` DtoH / HtoD above 1 MB.
10. sync at four ranks — ``allreduce_gradients`` on 64 x 65,536 random
   bucket matrices, four gloo ranks on the card as a (dp 2, sp 2) mesh:
   every wire x schedule (f32, bf16, int8, ef8 x fused, windowed, swing;
   the world-spanning schedules ignore the mesh's shape), masked rounds,
   and the ef8 hierarchical schedule (the exact reduce-scatter over each
   sp line, ef8 over each dp line), unmasked and masked with masks that
   agree within each sp line and one row masked everywhere, from a
   seeded nonzero residual. Asserts every rank's output identical, each
   inside its wire's envelope of the exact sum, and the counts exact;
   for hierarchical also that it ran, that each rank's residual changed
   only in its own sp column shard and there only in valid rows, and
   that the row masked everywhere sums to exact zeros.

11. ring kernels — hold the ring-flash forward, dq and dk/dv kernels
   (one hop each, all on tensor cores: bf16, and f32 in split TF32)
   against their plain PyTorch versions on the same CUDA tensors,
   f32 at 2e-5 (the carry: m, l and acc / l, the output the unnormalised
   acc stands for) and 5e-5 (the gradient accumulators), bf16 at 3e-2:
   at the sequence-parallel slice's shape (B 8, T_local 1024, 16 heads
   of 128, 4 KV heads) as rank 1's diagonal hop and as its past hop,
   then MQA, non-causal, a ragged T_local of 1000, head_dim 64 and 32,
   rank 1's two hops of ``train --sp 2`` at the CLI's defaults (B 2,
   T_local 32, 4 heads of 32: less than one tile), and rank (i, 1)'s two
   hops of phase 17's hierarchical run (B 4, T_local 1024, 16 heads of
   128, MHA), each on a carry that already holds a hop and on nonzero
   f32 accumulators. At the slice's shape each kernel, its
   plain version and the library call (``scaled_dot_product_attention``
   forward and backward on the same q and K/V block: causal on the
   diagonal hop, unmasked on the past hop; it merges no carry and returns
   its gradients in the inputs' dtype) timed as above, each kernel's
   bound computed from the hop's live (q, k) pairs (f32 also at the
   split-TF32 rate, 495 / 3 TFLOP/s, beside the CUDA cores' 67).
12. ring at four ranks — four gloo ranks on the card (B 2, T 4 x 512,
   16 heads of 128, 4 KV heads; f32 and bf16): ``ring_flash_attention``
   forward and backward held against the one-rank ``flash_attention`` on
   the gathered sequence and against the plain ``ring_attention``, and
   the windowed-SP flash path (window 256) against the one-rank windowed
   flash; rank r launches each ring kernel r + 1 times per call.
13. train, sp=2 — the gqa4 model of phase 7 (d_model 2048, 16 heads, 4
   KV heads, rope, 8 layers, d_ff 8192, vocab 32768) in bf16, batch 8,
   seq 2048, 3 steps on one card through the flash kernels, then the
   same through ``train --sp 2 --dist-backend ipc`` (f32 wire; two rank
   processes share the card, each on 1024 positions of every row) and
   its gloo twin (2 steps, losses bitwise); then
   the same in f32, the CLI's default dtype (no ``--bf16``: the f32 flash
   and ring kernels in split TF32), at batch 4 for 2 steps, without a
   twin. Each run asserts finite losses within 1e-3 relative of its one-card
   run's (f32 reordering and bf16 rounding at other running maxima; a
   lost hop or a wrong offset moves the loss far more), the one-card
   run's flash kernels launched once per layer per step, parameters
   bitwise equal on both ranks, and on rank r the ring kernels launched
   8 (r + 1) times per step each, the flash kernels never,
   ``masked_reduce`` once per step. Reports wall, sync and
   attention-exchange ms per step, tokens/s and each rank's peak memory.

14. allreduce — the peer-memory ring and swing allreduce (kernel B8)
   across rank processes on the one card: gloo carries only the IPC
   handle exchange, the barriers and the plain versions' wire; the
   kernels' payloads go through peer memory on the device (three
   kernels a call, push / reduce / gather, with two stream waits on
   counters between them). A probe first (each rank writes its buffer,
   reads every peer's through the IPC mapping). At two ranks on the
   flagship's gradient as the sync sees it (8,257 x 65,536 f32 bucket
   matrix, flattened: 541,130,752 elements, 2.16 GB per rank) and at
   four ranks on 64M elements, each rank's input from a generator
   seeded by its rank: a loop of ``ALLREDUCE_LOOP`` (2) calls of each
   schedule, each call's input ``carry + sum / n``, each ended through
   ``ring.wait`` (a stall raises, never hangs); every call's sum bitwise
   its plain version's, bitwise equal on every rank (a checksum through
   the group), finite, and a sample of 65,536 columns within rtol = atol
   = 1e-5 of the f64 sum of every rank's input; each rank launched each
   kernel ``ALLREDUCE_LOOP`` times.
   Then, median of 5 calls on every rank with CUDA events between group
   barriers (the slowest rank's median is the collective's time): the
   kernels, and of 1 call the plain version (host wire) and
   ``torch.distributed.all_reduce`` on the gloo group (NCCL refuses two
   ranks on one device), seconds a call each; the same kernels on a 256 KB vector, whose
   time is the waits'; the byte bounds computed (the function's, the
   schedule's, and the parent's per-step schedules'); and a
   torch.profiler window over 3 calls on each rank splitting a call's
   span into its kernels' device time and the rest (context switches
   and waits no kernel overlapped), with the kernels that ran on the
   card a call (counted on the device: 3) and the stream waits enqueued
   a call (2).

15. train at the CLI's defaults — what ``python -m
   akka_allreduce_tpu_torch.cli train`` runs (``run_train`` on the
   parsed ``["train"]``: d_model 128, 4 heads, so head dim 32; 2 layers,
   f32, batch 2, seq 32, 20 steps, on the card), then ``train --sp 2
   --dist-backend gloo`` at the same defaults (two rank processes on
   the card). Asserts finite losses, the flash kernels launched 2 x 20
   times each on one card and, on rank r of sp=2, each ring kernel 2 (r +
   1) x 20 times and the flash kernels never; and the first two steps'
   losses within 1e-4 relative of the same command with ``--device cpu``
   (the plain versions) from the card run's weights (seed 0 on the
   card's generator, which draws other numbers than the CPU's).

16. train under deadlines — phase 9's flagship dp=2 run (on ipc) with
   ``--deadline-ms 50``: the f32 (``none``) wire at ``--max-lag`` 1, ef8
   at 1, then f32 at 0 (the pacer's window against lockstep; ef8 with a
   gloo twin of every step: losses, parameters and residuals bitwise),
   each for
   the fewest steps (at most 6) whose straggle draws, rebuilt here with
   numpy, give a clean step 1, a step that masks one rank and a step
   that masks both and falls back to an exact round
   (``choose_straggle``: 4 steps, ``--straggle-prob`` 0.3428). Asserts
   each round's ``n_masked``, ``fell_back`` and ``min_bucket_count``
   equal the draws' (``predicted_rounds``), finite losses, parameters
   bitwise equal on both ranks, rank 0's sync launches those of one
   exact sync a step and each flash kernel once per layer a step, and
   the f32 runs' first two losses bitwise phase 9's (step 1 is clean: a
   mask of ones multiplies by 1.0 and rescales by 2 / 2). Reports wall
   and sync ms per step and peak memory per rank beside phase 9's. Then
   one direct ``allreduce_gradients`` at the flagship's bucket matrix
   (8,257 x 65,536 f32 a rank) on two ipc ranks with rank 1's row
   masked: the f32 wire must give both ranks exactly 2 x rank 0's
   gradient with counts of 1, ef8 must leave rank 1's residual bitwise
   unchanged.

17. hierarchical and auto — the flagship's full width (d_model 2048, 16
   heads of 128, d_ff 8192 gelu, vocab 32768, bf16 compute, f32 masters,
   adamw lr 1e-4, batch 8, seq 2048, 3 steps) cut to 4 layers
   (339,757,056 params: four ranks' ef8 training state share the 80 GB),
   first on one card, then at ``--dp 2 --sp 2 --grad-quant ef8
   --grad-schedule hierarchical`` on four ipc ranks on the card (4
   sequences a dp line, 1,024 positions an sp rank) and its gloo twin
   (every step: losses, parameters and residuals bitwise; no ipc peak
   above the twin's). Asserts the bucket
   matrix ceil(params / 65,536) x 65,536 on every rank, step 1's loss
   within 1e-3 relative of the one-card run's and steps 2–3 within
   ``HIER_LOSS_ATOL`` (1.7e-3) of it, parameters bitwise equal on every
   rank, each rank's residual nonzero only in its own sp column shard,
   rank 0's sync launches one masked reduce, one RTN and one stochastic
   quantize and three dequantizes a step, rank (i, j) the ring kernels
   4 (j + 1) times a step each and the flash kernels never, and the
   one-card run the flash kernels 4 times a step. Two fault controls
   must land outside that bound at step 2: no update at step 1 (one
   card, ``--lr 0``) and one dp line's gradient dropped at step 1 (the
   four ranks under ``--deadline-ms`` with a straggle draw that masks
   that line, ``choose_line_drop``). Reports wall, sync and exchange ms
   per step and peak memory per rank. Then the autotuner at the CLI's
   defaults, on ipc:
   ``train --dp 2 --grad-schedule auto --plan-dir D`` twice (measured on
   the ranks: fused, windowed:4, swing; then reloaded, the sidecar's
   bytes unchanged), ``train --dp 2 --sp 2 --grad-quant ef8
   --grad-schedule auto`` (hierarchical its only arm and winner); every
   entry's note empty; each plan's table printed. Then the bench rows at
   four ipc ranks (``bench.py``: ``measure_device_goodput`` at 25M floats and
   ``measure_quantized_collectives`` over its four payloads; each set of
   rounds sized to 0.15 s on the slowest rank, at least 4 / 1 rounds, 3
   reps), one JSON line each with its rounds and its spread;
   a row with an error fails.

19. protocol — the source paper's protocol plane, ``emulate``'s code
   path (the command's flag checks and config, ``LocalCluster`` with its
   ``ThroughputSink``s, traced) on the card: the payloads, staging rows
   and outputs on the card, every chunk reduce one masked-reduce launch
   on a strided slab of the staging row. (a) the reference's own cluster
   (4 workers, 778 floats in chunks of 3, max lag 3, thresholds 1.0,
   100 rounds, ``--assert-multiple 4``): every flush exactly 4 x input
   with counts 4; (b) the same geometry at thresholds 0.75 with rank 1
   killed after registration: every round completes, every survivor's
   flush has ``data == arange * count``; each of (a) and (b) also runs
   on the CPU (the plain reduce) and every flush of every worker must be
   bitwise its CPU twin's; (c) two workers on phase 9's f32 gradient
   (541,130,752 floats, 2.16 GB) in chunks of 65,536 (the bucket
   width), max lag 1, 3 rounds: every flush exactly 2 x the tensor the
   source handed out, counts 2, with a torch.profiler window (CUDA) over
   round 1 (device ms against wall ms: the idle share); (d) ``--fuzz
   5`` at 3 workers, 15 floats, 5 rounds, ``--assert-multiple 3``: 0
   violations. Each part's line: rounds/s, the sink's MB/s, messages,
   row-1 launches (which must equal the tracer's ``reduce_fired`` plus,
   per ``catchup_force_complete``, the chunks of that worker's block),
   store copies and peak memory. The phase must end within
   ``PROTOCOL_SECONDS`` (120 s).
20. cluster — the protocol plane across processes: ``python -m
   akka_allreduce_tpu_torch.cli master`` and ``worker`` as OS processes
   on the one card, over the TCP wire (``protocol/tcp.py`` on the C++
   transport). A card worker keeps its payloads on the card (every
   received frame one copy into a staging row, every chunk reduce one
   masked-reduce launch), checks every flush (``--assert-honest``:
   ``data == arange * count``, and ``count == N`` at thresholds 1.0),
   traces, and reports its launches and peak GB at exit; its launches
   must equal its trace's ``reduce_fired`` plus the chunks of its
   force-completed rounds. First the per-message copies (encode a chunk
   view: the device-to-host copy; decode and store it: the host-to-
   device copy), host-timed at 3 and 65,536 floats, card against CPU.
   (a) the reference's cluster (phase 19 (a)'s shape, 50 rounds) with
   4 card workers; (b) 2 card workers and 2 C++ workers (``worker
   --native``), every sink exact; (c) the C++ master (``master
   --native``) with 2 card workers; (b), (c) and (e) at (a)'s shape for
   25 rounds (``CLUSTER_ROUNDS``); (d) 2 card workers on phase 19 (c)'s
   shape (541,130,752 floats, chunk 65,536, max lag 1, 2 rounds,
   ``--unreachable-after 120``), the frames and bytes a worker sends a
   round from the shapes; (e) (a)'s cluster at thresholds 0.75 with the
   worker that joins as rank 1 SIGKILLed after its round-10 checkpoint:
   every round completes, the master downs it once, every survivor's
   flush is honest; (f) ``emulate --engine native`` at (a)'s config, on
   the host. Each part's line: rounds/s (the Python master's trace
   clock, else the card workers'), MB/s, every process's exit code and
   lines, each card worker's report. The phase must end within
   ``CLUSTER_SECONDS`` (180 s).
21. A5 — the training paths of ROADMAP A5 part 1 at phase 6's flagship
   configuration (``TRAIN_ARGV``; each flash counter set to 0 just
   before each run and read just after). (a) ``train --optimizer`` lion,
   adafactor and sgd, 3 steps each: finite losses, each flash counter at
   n_layers x steps, wall ms a step, the optimizer state's GB (its
   ``state_dict()`` tensors) beside phase 6's adamw, the peak GB; then
   ``A5_UPDATE_STEPS`` updates of each family on the card against the
   same updates on the CPU (the flagship's width at ``A5_UPDATE_LAYERS``
   layers, the same weights, gradients and fresh state), each leaf within
   ``A5_UPDATE_TOL`` of its largest value. (b) ``train --ema-decay 0.99``
   for 3 steps with ``--ckpt-every 3`` (saves at step 0, the interval
   policy's, and at the last step, forced; each ~8.7 GB), keeping
   each step's post-update masters: the checkpoint's ``ema`` item
   bitwise the in-memory EMA, the EMA within ``A5_EMA_TOL`` of each
   leaf's largest value of its recurrence over the kept masters; then,
   as processes on the card, ``generate --use-ema`` (16 prompt ids from
   seed 0, 16 tokens) whose tokens must equal an in-process greedy
   decode from the EMA, ``eval --use-ema`` over a uint16 corpus of 16 x
   2,048 tokens from seed 0 whose ``ce_nats_per_token`` must be within
   ``A5_EVAL_RTOL`` (1e-4) of the cross-entropy computed in-process over
   the same windows, and the control: ``generate --use-ema`` on a
   checkpoint saved without EMA must exit 2. (c) phase 9's configuration
   at ``--grad-accum 2`` on the ipc ranks: the f32 wire deferred and
   overlapped and ef8 overlapped, 3 steps each: overlap's step-0 loss
   bitwise deferred's, steps 1-2 within ``A5_OVERLAP_LOSS_RTOL``; the
   sync kernels' launches at phase 9's per-sync counts x 2 syncs a step
   under overlap (x 1 deferred); sync ms a step for each; the fault
   control (``fold_dropped_train_rank``: the last in-flight result never
   folded) must land outside the loss bound; the four runs share one
   spawn of the two ranks (``spawn_batch``). (d) ``train
   --steps-per-dispatch 3`` for 6 steps: two replays of one CUDA graph
   of 3 steps, the losses bitwise the same step code run eagerly, step
   by step, on the same kind of state from the same weights and batches,
   within ``A5_GRAPH_LOSS_RTOL`` of phase
   6's; the flash launches the captured 8 x 3 a replay x 2 replays plus
   the warm-up step's 8; wall ms a step beside phase 6's, the capture's
   seconds, and a torch.profiler window of one replay (device ms, idle
   share). (e) the lion run's ``--metrics-file`` snapshot, parsed with
   the port's ``parse_prometheus_text``: ``train_steps_total`` 3,
   ``train_tokens_total`` 3 x 8 x 2,048, the host and device histograms
   3 samples each and the gap's 2 (the first dispatch has no previous
   one); its ``--xprof-dir --xprof-steps 2`` trace holds 16 launches
   of each flash kernel (8 layers x 2 steps). The phase must end within
   ``A5_SECONDS`` (150 s).
22. A6 — the serving of ROADMAP A6 part 1 at phase 4's gqa4 shape
   (``SERVE_ARGV``), each kernel-path run's paged-attention count set to
   0 just before it and read just after (n_layers x decode steps). (a)
   sampled serving (``A6_SAMPLE``: temperature 0.8, top-k 50, top-p
   0.95, f32) on the kernel path at decode steps 4 (the main path) and
   1, bitwise; on the gather path, held to the kernel's under the
   perturbed-score rule (``greedy_agree`` with the full forward's
   filtered logits plus the Gumbel noise of ``fold_in(key(rid), j)``;
   the gather stream must be those scores' argmax) and the fault
   control: the key index off by one must land outside the rule;
   threefry's bits on the card bitwise the CPU's; the pick's wall and
   device ms against argmax's. (b) bf16 serving: the gqa4 model in
   bf16, the kernel path (launches counted) against the gather path
   under ``greedy_agree`` at two bf16 ulps of the largest logit, and a
   decode step's profile. (c) int8 KV on the slot and paged gather
   engines: cache bytes against float (more than 3x less); one token
   stream's step logits on both caches within ``A6_INT8_BOUND`` (0.1,
   the JAX test's) and within that share of the logit scale; a serve
   run of each. (d) speculation, the target's first 4 of 8 layers
   drafting 4 tokens a block, slot and paged: greedy tokens against
   phase 4's greedy gather tokens under ``greedy_agree``; acceptance
   rate, target dispatches a token; every page of both pools returned;
   two sampled paged runs bitwise (``A6_SAMPLED_SPEC_REQUESTS``). (e)
   on the kernel path (launches counted), requests 0-3 with a deadline
   already past under the deadline policy: exactly those evicted, the
   rest run to their greedy tokens through the refilled lanes; slot
   prefill padded to ``A6_BUCKETS`` against phase 4's tokens. Every run
   reports ``decode_tokens_per_s`` and ``tpot_ms`` p50/p99 beside phase
   4's greedy f32 kernel run.

23. A5 across ranks — ``train --steps-per-dispatch`` at dp x sp > 1
   on the ipc transport (ROADMAP A5 part 2), each chunk one CUDA graph
   replay on every rank: the graph holds the gradient sync's transport
   calls (and at sp=2 the ring kernels and ``ppermute``); before each
   replay every rank drains, meets the others, rewinds its buffers'
   counters to the capture's values and meets them again
   (``RankGroup.replay_boundary``), and the chunk's rounding seeds are
   written for its steps. (a) phase 9's flagship at dp=2, ``--lr-schedule
   cosine``, 6 steps in chunks of ``A5R_SPD`` (two replays) on the f32,
   ef8 and int8 wires, each against the same command with its chunks run
   eagerly on the same kind of state (``eager_chunks``: phase 9's runs
   are 3 steps at a constant rate on the host count, so none matches):
   losses, both ranks' parameter checksums and the ef8 residuals
   bitwise; the sync kernels' launches at the per-sync counts x (steps
   + the warm-up step); what a replay enqueues on the transport (calls,
   stretches, copies, bytes, stream waits) equal to
   ``replay_transport_counts`` of the step's calls; (b) phase 13's gqa4
   model at ``A5R_SP_LAYERS`` layers, sp=2, bf16, two replays of
   ``A5R_SP_SPD`` steps, bitwise its eager run, each rank's ring launches
   a replay n_layers x (sp rank + 1) x steps; (c) the flagship's width at
   ``A5R_RESUME_LAYERS`` layers on ef8, saved at the chunk boundary
   after step 2, its later checkpoint dropped and the run resumed from
   it: the last 3 losses, the parameters and the residuals bitwise the
   uninterrupted run's; (d) the fault control: rank ``A5R_CONTROL_RANK``'s
   chunk seeds a step off on the ef8 run must land outside the bitwise
   check (rank 0's second replay there in a torch.profiler window: wall
   and device ms, idle share). Wall ms a step graphed and eager, each
   replay's boundary ms, capture seconds. The phase must end within
   ``A5R_SECONDS`` (120 s).
24. A6, part 2 (runs after phase 23, the rank pools closed) — the
   watchdog and faults, drain/restore across processes and the serve
   trace at phase 4's gqa4 shape on ``--paged --paged-attention
   kernel``. (a) ``cli serve --selfcheck --chaos 3`` in process at
   decode steps 1 and 4 (its tiny slot engine: a hang, a raise, a NaN
   lane and a preemption; see ``cli.run_chaos_selfcheck``) must say ok.
   (b) The gqa4 engine's fault-free run (the warm-up, no watchdog), then
   the same 16 requests on an armed engine (``A24_WATCHDOG_S``) under
   ``FaultPlan.chaos(3)``, its hang held until the run ends
   (``cli.held_hang_plan``), the drain restored into a fresh engine
   (``cli.serve_until_done``), row 13's count set to 0 just before:
   every rid ends once, one watchdog trip, retries + dead letters ==
   failed attempts, faults injected == survived, the pool at capacity
   right after the recovery and at the end, retried and untouched
   streams bitwise the fault-free run's and restored ones under
   ``greedy_agree``; row 13's launches n_layers x 4 x (dispatches + the
   abandoned one, which runs after the run) and no live engine's K/V
   touched by that late dispatch; the control, a restored stream less
   its last replayed token, must fail the comparison. (c) The watchdog's
   cost: the same requests served unarmed and armed
   (``A24_COST_WATCHDOG_S``, no faults) in turns, wall ms a decode step
   from the device timer and TPOT, tokens bitwise (b)'s; then on one
   engine of 8 long lanes, blocks of 4 dispatches with the watchdog off
   and on in turns (``a24_interleaved``: median wall ms a step each way)
   and a torch.profiler window of each (wall and device ms a step); the
   guard thread's round trip alone (``a24_handoff_us``). (d) Two ``cli serve`` children (``run_serve``, as
   ``cli serve`` runs it, ``SERVE_CHILD``) with ``--drain-dir`` and
   ``--preempt-poll`` at a metadata server on 127.0.0.1
   (``MetadataServer``): child 1's ``A24_CHILD_REQUESTS`` requests are
   drained by its ``A24_PREEMPT_AT_POLL``-th poll and persisted, child 2
   restores them and serves one fresh request: drained > 0,
   drain_persisted == drained, resumed == drained, the drain file gone
   after child 2, rids 0-7 finished once across the two, restored
   streams against (b)'s fault-free run as in (b), child 2's fresh
   request bitwise rid 0's. (e) Child 2's ``--trace-file``: one
   ``serve_step`` span a decode dispatch and one ``serve_prefill`` a
   prefill; its ``--metrics-file`` snapshot's ``serve_*`` counters the
   report's (and child 1's ``serve_drain_persisted_total`` its drained
   count). The phase must end within ``A24_SECONDS`` (100 s).
25. expert and tensor parallelism (ROADMAP A7 part 1; runs after phase
   23, before the rank pools close, on the world-2 pool's ``ipc``
   ranks). (a) At full width and depth 2, f32, one grad step on the ep=2
   mesh (every second layer MoE: 8 experts, top-2, capacity factor 4,
   which cannot bind; no load-balance term) and one on the tp=2 mesh
   (the dense flagship), their gradients gathered to the full layout,
   against the one-rank step on the full tree and batch: every leaf
   within ``A7_GRAD_TOL`` (1e-4) of that leaf's largest value,
   ``dispatch_fraction`` 1; the fault controls (rank 0's outgoing
   all_to_all blocks swapped; the step's first tp sum skipped on both
   ranks) must land outside. (b) ``train`` on the flagship's MoE variant
   (``A7_MOE_FLAGS``: every second layer 8 experts, top-2, capacity
   1.25) at ep=2, bf16, ``A7_STEPS`` steps; (c) the flagship at tp=2:
   finite losses, ``dispatch_fraction`` in (0, 1] and a positive aux
   loss on (b), every rank's launches of rows 1 and 10-12 those the
   path implies (``a7_expected_launches``), wall ms a step, tokens/s, peak
   GB a rank and the ep all_to_all's and tp sums' ms a step (CUDA events
   around each call, ``ExchangeTimer``). (d) ``serve`` on phase 4's gqa4
   model with every second layer MoE (capacity 4) through the gather
   path, then the paged kernel, row 13's count set to 0 between: every
   request completes, the kernel's launches n_layers x 4 x dispatches,
   greedy tokens within ``greedy_agree`` of the gather run, and the
   control (the first requests' streams from the experts rolled by
   one) outside it. (e) ``train --tp 2 --ckpt-dir`` at depth 2 (its
   final full tree gathered in memory), then ``cli generate
   --ckpt-dir`` as a one-rank process: its greedy tokens equal the
   in-memory model's, and the control's (wq's tp halves swapped)
   differ. The phase must end within ``A7_SECONDS`` (250 s).
26. pipeline parallelism (ROADMAP A7 part 2; runs after phase 25, on
   the world-2 pool's ``ipc`` ranks, a ``pp`` mesh of two stages). (a)
   ``A7PP_PARITY_MODEL`` (phase 25's widths, dense, depth 4), f32, one
   grad step at pp=2 with 2 microbatches under gpipe and under 1f1b,
   gathered to the full layout, against the one-rank step on the full
   tree and batch: every leaf within ``A7_GRAD_TOL`` of that leaf's
   largest value; the control (gpipe with the two stages' layers
   swapped) must land above ``A7PP_CONTROL_MIN``. (b) ``train --pp 2
   --microbatches 4`` on the flagship (bf16, 4 layers a stage),
   ``A7PP_STEPS`` steps; (c) the same under ``--pp-schedule 1f1b``:
   finite losses, every rank's launches of rows 1 and 10-12 those the
   path implies (``a7pp_expected_launches``: the flash kernels m x L/pp
   a step, 1f1b's forward twice that; the pp sum of the non-layer
   gradients once a step), wall ms a step, tokens/s, MFU, peak GB a rank
   and the transfers along pp in ms a step (CUDA events around each
   ``ppermute``, ``ExchangeTimer``, and the report's
   ``pp_transfer_ms``); then both schedules at ``A7PP_MEM_MICRO``
   microbatches, ``A7PP_MEM_STEPS`` steps: 1f1b's peak GB must be below
   gpipe's (the stats: 9 resident stage inputs against 3). The four runs
   share one batch of the ranks. (d) ``train --pp 2 --ckpt-dir`` at
   depth 2 (its final full tree gathered in memory), then ``cli
   generate --ckpt-dir`` as a one-rank process: its greedy tokens equal
   the in-memory model's, and the control's (the stages' layers
   swapped) differ. The phase must end within ``A7PP_SECONDS`` (100 s).
27. the parallel axes' compositions (ROADMAP A7 part 3; runs after
   phase 26, on the world-4 pool kept open since phase 17, closed after
   (a)'s four-rank meshes, and the world-2 pool's ``ipc`` ranks). (a)
   ``A7C_MASK_MODEL`` (phase 25's widths
   at depth 4), f32, TF32 off, at dp=2 x tp=2 and dp=2 x pp=2 (gpipe, 2
   microbatches) on four ranks and MoE (every second layer, capacity 4,
   no load-balance term) at ep=2 on two: two rounds of the dynamic-valid
   grad step through a ``DeadlineTrainer`` whose clock sees every data
   rank on time, then data rank 1 late, on the same parameters and
   tokens (two rows a data rank): the masked round's dense gradients,
   gathered, within ``A7_GRAD_TOL`` of each leaf's largest value of the
   one-rank step on data rank 0's rows alone (the masked reduce
   rescales by count), the unmasked round outside it (the control), the
   reports (0, 0) then (1, 1) masked / dropped on every rank, and at ep
   the expert gradients of both rounds bitwise. (b) ``train
   --steps-per-dispatch 3``, 6 steps (two replays), at full width: the
   flagship at tp=2, the MoE flagship (phase 25's, cut to
   ``A7C_MOE_LAYERS`` = 4 layers) at ep=2 on the f32 and ef8 wires, the
   flagship at pp=2 with 4 microbatches under gpipe
   and under 1f1b, each against the same command with its chunks run
   eagerly (``EagerChunks``): losses, every rank's parameter checksum
   and the ef8 residuals bitwise; every rank's launches a replay of
   rows 1, 5-7 and 10-12 those of ``a7c_per_step`` x 3; wall ms a step
   graphed and eager, capture seconds, each replay's boundary ms, and
   calls and stream waits a replay on each transport buffer. The
   control (``stale_keys_rank``: the ef8 run's chunk key table left at
   the first chunk's steps) must differ. (c) ``train`` on the MoE
   flagship at ep=2 under ``--deadline-ms 50`` for 6 steps at the
   straggle probability ``a7c_straggle`` picks (a clean step 1, a
   one-rank step, a fallback): the rounds the draws predict
   (``min_bucket_count`` 1: the expert sync at dp 1 is one rank's),
   rank 0's flash kernels once a layer a step and one masked reduce a
   step, wall ms a step beside phase 25's exact run; a torch.profiler
   window on rank 0 over steps 2-5 (``--xprof-dir``, each step's work in
   a ``train_step i`` range), split into each step's host span and the
   device time of the kernels it launched, by kind, and their means over
   the masked and the exact rounds (``a7c_profile``). The phase must end
   within ``A7C_SECONDS`` (120 s).
28. training across processes (ROADMAP A9 part 1; runs after phase 27,
   on the world-2 pool's ranks: as ``ipc`` ranks, and as the two
   processes of ``train --coordinator``, each rank calling the command's
   ``cli.run_train`` with its own ``--process-id``, joined through rank
   0's TCPStore). (a) ``A9_MODEL`` (``A7_PARITY_MODEL`` without
   experts: depth 2 at the flagship's widths, f32, TF32 off), batch 4 x
   512, 3 steps, ``--deadline-ms --max-lag 0 --dcn-bucket-elems
   1048576``: (a1) with a deadline no round misses, each step's loss
   within ``A9_LOSS_TOL`` (1e-5 relative) of the same command at ``--dp
   2`` on ``ipc`` ranks, no round masked, both processes' losses and
   parameter checksums equal; (a2) with ``--straggle-prob`` from
   ``a9_straggle`` (process 1 late in round 1: it sleeps 1.5 deadlines,
   the deadline ``A9_DEADLINE_FACTOR`` times (a1)'s publish on the
   master, at least 2 s, so that none of its buckets lands in time):
   round 1 masked on both processes, process 1's report of it
   ``valid_peers [True, False]`` (it applied the recorded update without
   its own contribution), the checksums equal (``--check-every 1``: the
   master compared the CRCs every round), and round 2's loss outside
   ``A9_LOSS_TOL`` of (a1)'s (the control). (b) the flagship as two
   such processes on the bf16 wire (``--bf16-grads``, one whole-vector
   bucket of 1.08 GB in the store's 6 MiB parts), 3 steps: each
   process's last round split into its grad step, flatten and D2H,
   encode, store set (MB/s), report to mask, fetch (MB/s), decode and
   mean, H2D and apply, and its resident memory, beside phase 9's
   exact dp=2 step; rows 10-12 8 launches a step in each process, row 1
   none. The phase must end within ``A9_SECONDS`` (200 s).

Then, on lines of their own: nvidia-smi's name and power limit, the
kernels JSON line (the transport's copy kernel among them, its launches
rank 0's in phases 9, 13, 16, 17, 21 and 23; the masked reduce's with phases
19's and 20's; the bf16 flash kernels' and the sync kernels' with phase
21's, ``a5_launches`` apart on the sync rows; the paged kernel's with
phase 22's and 24's, ``a6_launches`` and ``a24_launches`` apart; the
flash, ring, sync and transport
rows with phase 23's, ``a5r_launches`` apart on the sync rows, row 4's
``pointer_seed_ms`` its launch reading the seed from device memory; the
bf16 flash, masked reduce, paged and transport rows with phase 25's,
``a7_launches`` apart on the sync and paged rows; the bf16 flash, masked
reduce and transport rows with phase 26's, ``pp_launches`` apart on
rows 1 and 10-12; the bf16 flash, masked reduce, ef8 block and
transport rows with phase 27's, ``a7c_launches`` apart on rows 1, 5-7
and 10-12; the bf16 and f32 flash rows with phase 28's process 0's,
``a9_launches`` apart), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# dense, 700 W; "tf32x3": f32 work as three TF32 tensor-core products
# (split TF32) at the card's 495 TFLOP/s of TF32
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
DEVICE = "cuda"  # the training phases' device (a CPU rehearsal sets "cpu")
T_START = time.perf_counter()

SERVE_ARGV = [
    "serve", "--vocab", "32768", "--d-model", "2048", "--n-heads", "16",
    "--kv-heads", "4", "--n-layers", "8", "--d-ff", "8192", "--rope",
    "--max-seq", "512", "--paged", "--page-size", "16", "--slots", "8",
    "--requests", "16", "--prompt-len", "64:256", "--max-new-tokens", "64",
    "--decode-steps", "4", "--load", "closed", "--seed", "0",
    "--device", "cuda"]

# (B, H, h_kv, D, P, n_pt): the slice's decode shape first — 8 lanes of
# the gqa4 model, 16-position pages, max_seq 512 — then MHA, MQA, P=32,
# and the long cache: 8 lanes at positions 4,096-8,191 of 8,192 (n_pt 512)
KERNEL_SHAPES = [(8, 16, 4, 128, 16, 32), (8, 16, 16, 128, 16, 32),
                 (8, 16, 1, 128, 16, 32), (8, 16, 4, 128, 32, 16),
                 (8, 16, 4, 128, 16, 512)]
LONG_SHAPE = KERNEL_SHAPES[-1]
# where phase 3 times the kernel at each S of SPLIT_COUNTS: the serve
# shape, MHA, 64 and 128 lanes of the gqa4 model (serve positions), and
# the long cache
SPLIT_SHAPES = [KERNEL_SHAPES[0], KERNEL_SHAPES[1], (64, 16, 4, 128, 16, 32),
                (128, 16, 4, 128, 16, 32), LONG_SHAPE]
SPLIT_COUNTS = (1, 2, 3, 4, 8)

TRAIN_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--n-layers", "8",
    "--d-ff", "8192", "--vocab", "32768", "--seq", "2048", "--batch", "8",
    "--bf16", "--lr", "1e-4", "--steps", "6", "--log-every", "1",
    "--device", "cuda"]
PARITY_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--kv-heads", "4",
    "--rope", "--n-layers", "8", "--d-ff", "8192", "--vocab", "32768",
    "--seq", "2048", "--batch", "2", "--lr", "1e-4", "--steps", "2",
    "--log-every", "1", "--device", "cuda"]

# (name, B, Tq, Tk, H, h_kv, D, causal, window, q_off, k_off): the
# training slice's shape first, the CLI defaults' (phase 15) last: one
# block shorter than a 64-row tile
FLASH_SHAPES = [
    ("slice", 8, 2048, 2048, 16, 16, 128, True, None, 0, 0),
    ("gqa4", 2, 1024, 1024, 16, 4, 128, True, None, 0, 0),
    ("mqa", 2, 1024, 1024, 16, 1, 128, True, None, 0, 0),
    ("window256", 2, 1024, 1024, 16, 4, 128, True, 256, 0, 0),
    ("noncausal", 2, 512, 512, 16, 4, 128, False, None, 0, 0),
    ("ragged1000", 2, 1000, 1000, 16, 4, 128, True, None, 0, 0),
    ("offsets", 2, 512, 1024, 16, 4, 128, True, 384, 512, 0),
    ("d64", 2, 1024, 1024, 16, 4, 64, True, None, 0, 0),
    ("d32", 2, 1024, 1024, 16, 4, 32, True, None, 0, 0),
    ("cli-defaults", 2, 32, 32, 4, 4, 32, True, None, 0, 0)]
FLASH_TOL = {"torch.float32": (2e-5, 5e-5), "torch.bfloat16": (3e-2, 3e-2)}
# phase 7: flash vs local attention in training, per compute dtype
PARITY_TOL = {
    # f32 sums in other orders over 2048 keys and 8 layers stay near
    # 1e-5, while a GQA head's lost share would be O(1)
    "float32": {"loss0": 1e-5, "grads": 1e-3, "loss1": 1e-4},
    # bf16 reaches the tensor-core forward, dq and dk/dv: the same cast
    # points, but p and ds round to bf16 (2^-8) against the unnormalised
    # running max where local attention rounds the normalised softmax, so
    # a gradient leaf moves by ~2e-2 of its largest value (2.4e-2 on an
    # H100) and the loss by ~1e-5. The control (one query head's share
    # dropped from dk/dv) must read above the gradient limit; a wrong tile
    # is held at its own kernel's output in phase 5. Step 1 also carries
    # one AdamW step from those gradients (its first update is +-lr
    # wherever a near-zero gradient's sign differs)
    "bfloat16": {"loss0": 2e-3, "grads": 3e-2, "loss1": 5e-3}}
# phase 7's step-0 check: one set of weights and one batch from each seed
PARITY_SEEDS = (0, 1, 2)

# the gradient sync's kernels: name -> (source, TPU kernel body replaced)
SYNC_KERNELS = {
    "masked_reduce": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/masked_reduce.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/reduce.py:30"),
    "quantize_int8": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:52"),
    "dequantize_int8": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:57"),
    "quantize_int8_prng": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:122"),
    "quantize_int8_block": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:205"),
    "quantize_int8_block_rtn": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:211"),
    "dequantize_int8_block": (
        "akka_allreduce_tpu_torch/ops/kernels/csrc/quantize.cu",
        "akka_allreduce_tpu/ops/pallas_kernels/quantized.py:285")}
BUCKET_ELEMS = 65536  # the train command's default --bucket-elems
EF_BLOCK = 512        # the ef8 wire's scale block
# (peers, elems, valid, target) besides the main path's staging matrix:
# bench_suite's first
REDUCE_CASES = [(8, 3_276_800, (1, 1, 1, 0, 1, 1, 1, 1), 8.0),
                (3, 1000, (0, 0, 0), 1.0), (3, 1001, (1, 0, 1), 2.0),
                (5, 4096, (1, 1, 0, 1, 1), 1.0)]
# the multi-rank training phases (9, 13, 16, 17) run on the ipc rank
# transport; each keeps a twin on the gloo host wire whose losses (and,
# when it runs every step, parameters and ef8 residual) must be bitwise
# the ipc run's; a twin runs TWIN_STEPS steps unless it holds a residual
DIST = "ipc"
TWIN = "gloo"
TWIN_STEPS = 2
# phase 18 (after phase 8): the transport against gloo at each (world,
# sp) spawn; the first also moves the 2.16 GB payload, times the
# collectives (median of TRANSPORT_REPS between barriers) and runs the
# fault control (rank 1 skips a call: rank 0 raises within
# TRANSPORT_FAULT_TIMEOUT_S, its wait's timeout, plus the watchdog's poll
# and the abandon, TRANSPORT_FAULT_SLACK_S; the timeout was the
# transport's own 30 s, ring.TIMEOUT_S, until phase 23 came);
# phase 9's traced syncs hold no host copy above TRANSPORT_HOST_COPY_MAX
TRANSPORT_SPAWNS = ((2, 1), (3, 1), (4, 2))
TRANSPORT_REPS = 5
TRANSPORT_HOST_COPY_MAX = 1 << 20
TRANSPORT_FAULT_SLACK_S = 2.0
TRANSPORT_FAULT_TIMEOUT_S = 5.0
TRANSPORT_SOURCE = "akka_allreduce_tpu_torch/ops/kernels/csrc/transport.cu"
# no pl.pallas_call: the wire under the JAX sync's lax.psum_scatter /
# all_gather (and all_to_all, ppermute), which rides ICI on the TPU
TRANSPORT_REPLACES = "akka_allreduce_tpu/ops/collectives.py:118"
# phase 9: the flagship at dp=2 on one card, 3 steps per wire
DP_WORLD = 2
DP_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--n-layers", "8",
    "--d-ff", "8192", "--vocab", "32768", "--seq", "2048", "--batch", "8",
    "--bf16", "--lr", "1e-4", "--steps", "3", "--log-every", "1",
    "--device", "cuda", "--dp", str(DP_WORLD), "--dist-backend", DIST]
DP_WIRES = ("none", "int8", "ef8")
DP_LOSS_RTOL = 5e-5   # f32 wire vs one card, per step (measured ~1.4e-5)
QUANT_LOSS_ATOL = 0.05  # int8/ef8 vs the f32 wire (TestEf8Training)
# the sync kernels that phase 9's wires launch: all but row 2, the
# bits-tensor per-row quantizer (the JAX package's non-default int8
# path; the int8 wire draws its bits in the kernel, row 4)
MAIN_PATH_SYNC = tuple(k for k in SYNC_KERNELS if k != "quantize_int8")
# phase 10: four ranks, every wire x schedule, and masked rounds; the
# ranks are a (dp 2, sp 2) mesh, which the world-spanning schedules
# ignore and the hierarchical one runs on
SYNC4_SHAPE = (64, 65536)
SYNC4_SP = 2
SYNC4_CASES = [
    {"transport": tr, "schedule": sc, "masked": False}
    for tr in ("f32", "bf16", "int8", "ef8")
    for sc in ("fused", "windowed", "swing")] + [
    {"transport": tr, "schedule": sc, "masked": True}
    for tr, sc in (("f32", "fused"), ("bf16", "windowed"), ("int8", "fused"),
                   ("ef8", "fused"), ("ef8", "swing"))] + [
    {"transport": "ef8", "schedule": "hierarchical", "masked": m}
    for m in (False, True)]
# phase 11: (name, B, T_local, H, h_kv, D, causal, q_off, k_off), the
# sequence-parallel slice's shape first, as rank 1's two hops at sp=2;
# then rank 1's two hops of `train --sp 2` at the CLI's defaults, and
# rank (i, 1)'s two hops of phase 17's hierarchical run (MHA, 4
# sequences a dp line, 1,024 positions an sp rank)
RING_SHAPES = [
    ("slice-diagonal", 8, 1024, 16, 4, 128, True, 1024, 1024),
    ("slice-past", 8, 1024, 16, 4, 128, True, 1024, 0),
    ("mqa", 2, 1024, 16, 1, 128, True, 1024, 0),
    ("noncausal", 2, 1024, 16, 4, 128, False, 0, 1024),
    ("ragged1000", 2, 1000, 16, 4, 128, True, 1000, 1000),
    ("d64", 2, 1024, 16, 4, 64, True, 2048, 1024),
    ("d32", 2, 1024, 16, 4, 32, True, 2048, 1024),
    ("cli-defaults-diagonal", 2, 32, 4, 4, 32, True, 32, 32),
    ("cli-defaults-past", 2, 32, 4, 4, 32, True, 32, 0),
    ("hier-mha-diagonal", 4, 1024, 16, 16, 128, True, 1024, 1024),
    ("hier-mha-past", 4, 1024, 16, 16, 128, True, 1024, 0)]
RING_SOURCE = "akka_allreduce_tpu_torch/ops/kernels/csrc/ring_flash.cu"
RING_REPLACES = {
    "ring_fwd": "akka_allreduce_tpu/ops/pallas_kernels/ring_flash.py:61",
    "ring_dq": "akka_allreduce_tpu/ops/pallas_kernels/ring_flash.py:94",
    "ring_dkv": "akka_allreduce_tpu/ops/pallas_kernels/ring_flash.py:121"}
# phase 12: four ranks, (B, T_local, H, h_kv, D), and the window
RING4_SHAPE = (2, 512, 16, 4, 128)
RING4_WINDOW = 256
# phase 13: the gqa4 model at sp=2 against one card
SP_WORLD = 2
SP_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--kv-heads", "4",
    "--rope", "--n-layers", "8", "--d-ff", "8192", "--vocab", "32768",
    "--seq", "2048", "--batch", "8", "--bf16", "--lr", "1e-4", "--steps",
    "3", "--log-every", "1", "--device", "cuda"]
# and the CLI's default dtype, f32 (no --bf16): batch 4, 2 steps
SP_F32_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--kv-heads", "4",
    "--rope", "--n-layers", "8", "--d-ff", "8192", "--vocab", "32768",
    "--seq", "2048", "--batch", "4", "--lr", "1e-4", "--steps", "2",
    "--log-every", "1", "--device", "cuda"]
SP_RUNS = {"bfloat16": SP_ARGV, "float32": SP_F32_ARGV}
# the dtypes whose sp=2 run has a gloo twin (the transport moves bytes:
# the f32 run's K/V take the same route at twice the width)
SP_TWINS = ("bfloat16",)
SP_LOSS_RTOL = 1e-3
# phase 14: the flagship's bucket matrix (ceil(541.1M params / 65,536)
# rows of 65,536 f32) flattened, at two ranks; a 64M slice at four
ALLREDUCE_RUNS = ((2, 8257 * BUCKET_ELEMS), (4, 64 * 2 ** 20))
# checked calls a schedule and run (4 until phase 22 came: each call at
# 2.16 GB waits ~4 s for its plain version)
ALLREDUCE_LOOP = 2
ALLREDUCE_REPS = 5
# the plain versions and gloo all_reduce, seconds a call on 2.16 GB:
# timed over one call (two until phase 21 came)
ALLREDUCE_REF_REPS = 1
ALLREDUCE_SAMPLE = 65536  # columns held against the f64 sum
# a vector whose traffic is negligible (256 KB): its time is the
# handshakes', i.e. the time-slicing between the ranks' contexts
ALLREDUCE_SMALL = 65536
ALLREDUCE_TOL = 1e-5
# phase 15: the train command at the CLI's defaults (head dim 32, f32),
# on one card and at sp=2; losses against the same command on the CPU
DEFAULTS_RUNS = {"one_card": ["train"],
                 "sp2": ["train", "--sp", "2", "--dist-backend", "gloo"]}
DEFAULTS_LOSS_RTOL = 1e-4
DEFAULTS_COMPARED_STEPS = 2
# phase 16: the flagship at dp=2 under straggler deadlines (phase 9's
# argv with --deadline-ms); the f32 wire at --max-lag 1, ef8 at 1, then
# f32 at --max-lag 0 (what the pacer's window buys on the gloo wire)
DEADLINE_MS = 50.0
DEADLINE_RUNS = (("none", 1), ("ef8", 1), ("none", 0))
# the runs with a gloo twin, and its steps (None: every step, so the
# masked rounds, the fallback and the ef8 residual are compared); the f32
# runs' first two losses are held bitwise to phase 9's, whose twin is gloo
DEADLINE_TWINS = {("ef8", 1): None}
DEADLINE_MAX_STEPS = 6
# its direct masked sync: the flagship's bucket matrix, f32, a rank
DEADLINE_SYNC_SHAPE = (8257, BUCKET_ELEMS)
# phase 17: the flagship's full width at dp 2 x sp 2 on the ef8
# hierarchical schedule, its depth cut to 4 layers (four ranks' ef8
# training state share the card's 80 GB)
HIER_ARGV = [
    "train", "--d-model", "2048", "--n-heads", "16", "--n-layers", "4",
    "--d-ff", "8192", "--vocab", "32768", "--seq", "2048", "--batch", "8",
    "--bf16", "--lr", "1e-4", "--steps", "3", "--log-every", "1",
    "--device", "cuda"]
HIER_DIST = ["--dp", "2", "--sp", "2", "--dist-backend", DIST,
             "--grad-quant", "ef8", "--grad-schedule", "hierarchical"]
HIER_PEAK_GB = 72.0  # the four ranks' summed peak the card must hold
# steps 2-3's loss gap to the one-card run, from readings on the H100
# (PERF.md §6): the sound run's 2.04e-4, the fault controls' step-2
# gaps 1.44e-2 (one dp line dropped) and 1.94e-2 (no update); the
# geometric mean of the sound gap and the smaller control
HIER_LOSS_ATOL = 1.7e-3
# the autotuner at the CLI's defaults: f32 at dp 2 (twice, one plan
# directory: measured, then reloaded), then ef8 at dp 2 x sp 2
AUTO_ARGV = ["train", "--steps", "3", "--log-every", "1", "--device",
             "cuda", "--dist-backend", DIST, "--grad-schedule", "auto"]
AUTO_F32 = ["--dp", "2"]
AUTO_EF8 = ["--dp", "2", "--sp", "2", "--grad-quant", "ef8"]
# the bench rows at four ranks: the JAX payloads (None: the bench
# module's, 25M floats in buckets of 3,125,000 for the goodput row), at
# least 4 / 1 rounds, sized up to 0.15 s a set (0.3 until phase 21
# came), 3 reps
BENCH_RANKS = 4
BENCH_R_HI, BENCH_R_LO, BENCH_REPS = 4, 1, 3
BENCH_SET_S = 0.15
BENCH_GOODPUT = None
BENCH_PAYLOADS = None
BENCH_BACKEND = DIST
# phase 19: the protocol plane (``cli emulate``'s code path), each part
# one argv without --device; "c" (None) is built from phase 9's
# gradient by protocol_parts. (a) and (b) also run on the CPU twin
PROTOCOL_SCRIPT = ["--workers", "4", "--data-size", "778",
                   "--max-chunk-size", "3", "--max-lag", "3"]
PROTOCOL_PARTS = {
    "a": ["emulate", *PROTOCOL_SCRIPT, "--th-complete", "1.0",
          "--assert-multiple", "4"],
    "b": ["emulate", *PROTOCOL_SCRIPT, "--th-allreduce", "0.75",
          "--th-reduce", "0.75", "--th-complete", "0.75", "--kill-rank", "1"],
    "c": None,
    "d": ["emulate", "--fuzz", "5", "--workers", "3", "--data-size", "15",
          "--max-round", "5", "--assert-multiple", "3", "--th-complete",
          "1.0"]}
PROTOCOL_TWIN = "cpu"
PROTOCOL_SECONDS = 120
# (c)'s profiled round ends within this many messages of its last one
# (of ~33k a round)
PROTOCOL_PUMP_BITE = 64
# phase 20: the protocol plane across processes (``cli master`` and ``cli
# worker`` as OS processes); each part (master engine, worker engines):
# "card" a Python worker on the card, "native" the C++ worker; (a), (b),
# (c) and (e) at phase 19 (a)'s shape, (d) at phase 19 (c)'s
CLUSTER_SCRIPT = ["--data-size", "778", "--max-chunk-size", "3",
                  "--max-lag", "3"]
CLUSTER_PARTS = {"a": ("python", ["card"] * 4),
                 "b": ("python", ["card", "native", "card", "native"]),
                 "c": ("native", ["card"] * 2),
                 "d": ("python", ["card"] * 2),
                 "e": ("python", ["card"] * 4)}
# (a) 50 of the reference's 100 rounds (cut from 100 for the script's
# time when phase 21 came); (b), (c) and (e) 25, so that the phase keeps
# well inside its limit: each card worker process takes ~10 s to start
# (torch and a CUDA context), makes two synchronizing copies a message,
# and shares the card with the others
CLUSTER_ROUNDS = {"a": 50, "b": 25, "c": 25, "e": 25}
CLUSTER_CHECKPOINT = 10
CLUSTER_TIMEOUT_S = 60
CLUSTER_SCALE_ROUNDS = 2  # 3 until phase 23 came (13 s a round)
CLUSTER_SCALE_TIMEOUT_S = 150
# a card worker can spend seconds inside one poll while it drains the
# scale part's 256 KB frames: (d)'s liveness window is wide
CLUSTER_SCALE_UNREACHABLE_S = 120
CLUSTER_KILL_RANK = 1
CLUSTER_KILL_AFTER = 10  # (e)'s checkpoint: the victim's first sink line
CLUSTER_COPY_REPS = 200
CLUSTER_DEVICE = None  # card workers' --device (a CPU rehearsal: "cpu")
CLUSTER_SECONDS = 180
# phase 21: the A5 training paths at phase 6's configuration (TRAIN_ARGV)
A5_SECONDS = 150
A5_STEPS = 3
A5_FAMILIES = ("lion", "adafactor", "sgd")
# (a)'s updates on the card against the CPU: the flagship's width at
# this many layers, A5_UPDATE_STEPS updates of fresh gradients (from the
# second on, lion's momentum, adafactor's factored moments and sgd's
# trace take part), each leaf within A5_UPDATE_TOL of its largest value
A5_UPDATE_LAYERS = 2
A5_UPDATE_STEPS = 3
A5_UPDATE_TOL = 1e-6
A5_UPDATE_GRAD_SCALE = 1e-3
A5_EMA_DECAY = 0.99
A5_EMA_TOL = 1e-6  # the EMA against its recurrence, of each leaf's max
A5_GENERATE_TOKENS = 16
A5_PROMPT_TOKENS = 16
A5_EVAL_WINDOWS = 16
A5_EVAL_BATCH = 8
A5_EVAL_RTOL = 1e-4
A5_SUBPROCESS_TIMEOUT_S = 120
# (c): phase 9's configuration with two microbatches a rank
A5_ACCUM = 2
A5_OVERLAP_RUNS = (("none", "deferred", 3), ("none", "overlap", 3),
                   ("ef8", "overlap", 3))
A5_OVERLAP_CONTROL_STEPS = 2
A5_OVERLAP_LOSS_RTOL = 5e-5  # overlap vs deferred, steps 1-2
# (d): chunks of A5_SPD steps, two replays
A5_SPD = 3
A5_SPD_STEPS = 6
A5_GRAPH_LOSS_RTOL = 5e-5  # the graph path vs phase 6's eager losses
# phase 22: the serving of ROADMAP A6 part 1 at phase 4's gqa4 shape
# (SERVE_ARGV: 8 lanes, 16 requests, prompts 64-256, 64 new tokens)
A6_SECONDS = 150
A6_SAMPLE = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
A6_DRAFT = ["--speculative", "--draft-steps", "4", "--draft-layers", "4"]
A6_BUCKETS = "64,128,192,256"
A6_EVICTED = 4      # (e): requests 0-3 carry a deadline already past
A6_STEP_REPS = 20   # (a): timed picks a kind
A6_PRNG_INDICES = 8  # (a): token indices a request whose bits are held
A6_INT8_STEPS = 6   # (c): decode steps of one token stream on both caches
A6_INT8_BOUND = 0.1  # tests/test_generate.py::TestQuantizedKV's bound
# (d): the two sampled speculative runs at one wave of the 8 lanes (16
# requests took 14-15 s a run on an H100 80GB HBM3 at 700 W)
A6_SAMPLED_SPEC_REQUESTS = 8
# phase 23: train --steps-per-dispatch across ranks (ROADMAP A5 part 2):
# phase 9's flagship at dp=2 on ipc, chunks of A5R_SPD steps under the
# cosine schedule, per wire (wire, steps): two replays each (int8's
# quantize reads its seeds from the chunk's table: row 4)
A5R_SECONDS = 120
A5R_SPD = 3
A5R_WIRES = (("none", 6), ("ef8", 6), ("int8", 6))
A5R_SCHEDULE = ["--lr-schedule", "cosine"]
# (b): the gqa4 model of phase 13 at sp=2 in bf16, cut to this depth,
# two replays of A5R_SP_SPD steps (the first holds the capture: the
# second gives the wall ms a step)
A5R_SP_LAYERS = 2
A5R_SP_SPD = 2
# (c): the flagship's width at this depth, ef8, resumed at the chunk
# boundary after step A5R_SPD - 1 (its saves are ~2.8 GB, not ~6.5)
A5R_RESUME_LAYERS = 2
# (d): the rank whose chunk seeds are those of the next step
A5R_CONTROL_RANK = 1
# phase 24: the serving of ROADMAP A6 part 2 at phase 4's gqa4 shape
A24_SECONDS = 100
A24_CHAOS_SEED = 3
A24_CHAOS_STEPS = (1, 4)
A24_WATCHDOG_S = 0.3  # (b): several times a healthy 4-step dispatch
A24_COST_WATCHDOG_S = 30.0  # (c): armed, and never reached
A24_COST_TURNS = ("unarmed", "armed", "armed", "unarmed")
A24_PROFILE_STEPS = 4
# (c)'s A/B on one engine: 8 lanes of 240 tokens (60 dispatches of 4), in
# blocks of 4 dispatches, 6 rounds of (off, on) / (on, off)
A24_AB_TOKENS = 240
A24_AB_BLOCK = 4
A24_AB_ROUNDS = 6
A24_HANDOFF_REPS = 1000  # (c): no-op round trips through a guard thread
A24_CHILD_REQUESTS = 8  # (d): every request in flight on the 8 lanes
A24_PREEMPT_INTERVAL_S = 0.1
A24_PREEMPT_AT_POLL = 4  # (d): child 1's 4th poll reads TRUE, ~0.3 s in
A24_CHILD_TIMEOUT_S = 180
ALLREDUCE_SOURCE = ("akka_allreduce_tpu_torch/ops/kernels/csrc/"
                    "ring_allreduce.cu")
ALLREDUCE_REPLACES = {
    "ring_allreduce": "akka_allreduce_tpu/ops/pallas_kernels/ring.py:51",
    "swing_allreduce": "akka_allreduce_tpu/ops/pallas_kernels/ring.py:159"}
# the device kernels of one call (push and gather share the copy kernel)
ALLREDUCE_KERNELS = ("peer_copy_kernel", "peer_reduce_kernel")
FLASH_SOURCE = "akka_allreduce_tpu_torch/ops/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "akka_allreduce_tpu/ops/pallas_kernels/attention.py:113",
    "flash_dq": "akka_allreduce_tpu/ops/pallas_kernels/attention.py:153",
    "flash_dkv": "akka_allreduce_tpu/ops/pallas_kernels/attention.py:184"}
# the tensor-core kernels each flash library must build (bf16, and f32 in
# split TF32), at every head dim the wrappers take (HEAD_DIMS); the
# kernels line names each row's kernel from here
MMA_KERNELS = {
    "flash_attention": ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                        "flash_dkv_mma_kernel", "flash_fwd_tf32_mma_kernel",
                        "flash_dq_tf32_mma_kernel",
                        "flash_dkv_tf32_mma_kernel"),
    "ring_flash": ("ring_fwd_mma_kernel", "ring_dq_mma_kernel",
                   "ring_dkv_mma_kernel", "ring_fwd_tf32_mma_kernel",
                   "ring_dq_tf32_mma_kernel", "ring_dkv_tf32_mma_kernel")}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def ptxas_kernels(report: str) -> list:
    """Per entry function of a ``ptxas -v`` report: its mangled name,
    registers, stack frame and spill bytes."""
    rows, cur, props = {}, None, None
    for line in report.splitlines():
        name = re.search(r"Compiling entry function '([^']+)'", line)
        prop = re.search(r"Function properties for (\S+)", line)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name:
            cur = rows.setdefault(name.group(1), {"kernel": name.group(1)})
        elif prop:
            props = prop.group(1)
        elif frame and props in rows:
            rows[props].update(stack=int(frame.group(1)),
                               spill_stores=int(frame.group(2)),
                               spill_loads=int(frame.group(3)))
        elif regs and cur is not None:
            cur["registers"] = int(regs.group(1))
    return list(rows.values())


def check_mma_spills(info: dict) -> list:
    """The tensor-core kernels (``*_mma_kernel``) of every library built
    in this run, from its ptxas report; raises if one spills or a built
    flash library lacks one of its ``MMA_KERNELS`` at a head dim."""
    from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
        HEAD_DIMS
    rows = []
    for lib, entry in info.items():
        found = [dict(r, library=lib) for r in ptxas_kernels(entry["ptxas"])
                 if "mma_kernel" in r["kernel"]]
        # a reused library has no report; a mangled name reads
        # <length><name>ILi<head dim>E
        expected = MMA_KERNELS.get(lib, ()) if entry["ptxas"] else ()
        missing = [f"{n}<{d}>" for n in expected for d in HEAD_DIMS
                   if not any(f"{len(n)}{n}ILi{d}E" in r["kernel"]
                              for r in found)]
        if missing:
            raise AssertionError(f"{lib}: no tensor-core kernel "
                                 f"{', '.join(missing)} in the ptxas report")
        rows += found
    spills = [r for r in rows if r.get("spill_stores", 1)
              or r.get("spill_loads", 1)]
    if spills:
        raise AssertionError(f"tensor-core kernels spill: {spills}")
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_case(torch, shape, dtype, seed, positions="edges", device="cuda"):
    """Random q and pools, each lane with its own pages.
    ``positions="edges"``: lanes at 0, P-1, P, the last position, at a
    split boundary (the lane's live pages an exact multiple of the
    kernel's S splits) and one page past it (every split's share grows
    by a page, and the last split may be left empty), one parked on the
    scratch page (table row 0, pos 0), the rest random; ``"serve"``:
    every lane at a random position in [64, 320), the range the serve
    phase's requests decode over; ``"long"``: every lane in the table's
    second half, [n_pt * P / 2, n_pt * P)."""
    b, h, h_kv, d, p, n_pt = shape
    gen = torch.Generator().manual_seed(seed)
    num_pages = b * n_pt + 1
    q = torch.randn((b, 1, h, d), generator=gen)
    k = torch.randn((num_pages, p, h_kv, d), generator=gen)
    v = torch.randn((num_pages, p, h_kv, d), generator=gen)
    table = (torch.randperm(num_pages - 1, generator=gen) + 1)[
        :b * n_pt].reshape(b, n_pt).to(torch.int32)
    last = n_pt * p - 1
    if positions == "serve":
        pos = torch.randint(min(64, last), min(320, last + 1), (b,),
                            generator=gen)
    elif positions == "long":
        pos = torch.randint(n_pt * p // 2, last + 1, (b,), generator=gen)
    else:
        pos = torch.randint(0, last + 1, (b,), generator=gen)
        splits = case_splits(torch, shape, device)
        # live pages: a multiple of splits (or the table less one page)
        boundary = min(max(1, n_pt // (2 * splits)) * splits, n_pt - 1)
        pos[:6] = torch.tensor([0, p - 1, p, last, boundary * p - 1,
                                boundary * p])
        table[-1] = 0
        pos[-1] = 0
    dev = torch.device(device)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            table.to(dev), pos.to(dev, torch.int32))


def case_splits(torch, shape, device="cuda") -> int:
    """The S the kernel's wrapper picks for ``shape`` on ``device``'s
    card (132 SMs, an H100's, for a CPU rehearsal)."""
    from akka_allreduce_tpu_torch.ops.kernels.attention import paged_splits
    b, _, h_kv, _, _, n_pt = shape
    sms = (torch.cuda.get_device_properties(torch.device(device))
           .multi_processor_count if torch.device(device).type == "cuda"
           else 132)
    return paged_splits(b, h_kv, n_pt, sms)


def time_ms(torch, fn, flush, reps=20, warmup=3) -> float:
    """Median over ``reps`` single calls, each between two CUDA events,
    with the L2 flushed before it (the decode step finds its KV cold).
    A ~1 ms device spin after the flush keeps the card busy while the
    host enqueues the call, so the events time the device work and not
    the Python launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str) -> "tuple[float, str]":
    """The larger of the byte time and the operation time, in ms."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_bound(torch, q, k_pages, table, pos) -> "tuple[float, str]":
    """Least time for this call's work: the K/V rows at positions <= pos
    read once, q and table entries read, out written; ~4 * D flops per
    query head and live position (q.k and p.v), at the card's peaks."""
    b, _, h, d = q.shape
    _, p, h_kv, _ = k_pages.shape
    live = int((pos.long() + 1).sum())
    es = q.element_size()
    n_pages = int(((pos.long() // p) + 1).sum())
    nbytes = (2 * live * h_kv * d * es + 2 * q.numel() * es
              + 4 * (n_pages + b))
    return bound(4 * h * d * live, nbytes, str(q.dtype).split(".")[-1])


def library_attention(torch, q, k_pages, v_pages, table, pos):
    """One PyTorch attention call over the gathered pages, the yardstick
    for ``library_ms``: gather + scaled_dot_product_attention with a
    boolean position mask. Timed only; the port never calls it."""
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch.ops.kernels.attention import \
        paged_gather_kv
    k_all = paged_gather_kv(k_pages, table).transpose(1, 2)
    v_all = paged_gather_kv(v_pages, table).transpose(1, 2)
    t = k_all.shape[2]
    mask = (torch.arange(t, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k_all, v_all,
                                         attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def paged_agrees(torch, got, want) -> "tuple[bool, float]":
    """The paged kernel's output against the plain version's, both of the
    pool's dtype: all finite, f32 within atol = rtol = 1e-5, bf16 each
    (lane, query head) row within min(2e-2, 1/32 of the row's largest
    |want|), four to eight bf16 steps at that value. A row over thousands
    of keys averages to values of ~0.02, where 2e-2 alone would pass a
    fault the size of a typical output. Returns (agrees, the worst
    |got - want| over its limit)."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        limit = 1e-5 + 1e-5 * want.abs()
    else:
        row_max = want.float().abs().amax(dim=-1, keepdim=True)
        limit = (row_max / 32).clamp(max=2e-2)
    share = float((err / limit).max())
    return bool(torch.isfinite(got).all()) and share <= 1.0, share


def phase_kernels(torch) -> dict:
    from akka_allreduce_tpu_torch.ops.kernels import attention
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timed = {}
    seed = 0
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            timed_at = "long" if shape == LONG_SHAPE else "serve"
            for positions in ("edges", timed_at):
                seed += 1
                args = make_case(torch, shape, dtype, seed, positions)
                out = attention.paged_attention(*args)
                ref = attention.paged_gather_attention(*args)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                finite = bool(torch.isfinite(out).all())
                ok, share = paged_agrees(torch, out, ref)
                row = {"shape": list(shape), "dtype": str(dtype),
                       "positions": positions,
                       "splits": case_splits(torch, shape),
                       "max_abs_err": err, "limit_share": share,
                       "finite": finite, "ok": ok}
                if positions == timed_at and shape in (KERNEL_SHAPES[0],
                                                       LONG_SHAPE):
                    bound, by = paged_bound(torch, args[0], args[1],
                                            args[3], args[4])
                    row.update(
                        ms=time_ms(torch, lambda: attention.paged_attention(
                            *args), flush),
                        plain_ms=time_ms(torch, lambda: attention
                                         .paged_gather_attention(*args),
                                         flush),
                        library_ms=time_ms(torch, lambda: library_attention(
                            torch, *args), flush),
                        bound_ms=bound, bound_by=by)
                    row["bound_share"] = bound / row["ms"]
                    timed[positions, str(dtype)] = row
                emit("kernels", kernel="paged_attention", **row)
                if not ok:
                    raise AssertionError(f"paged_attention disagrees with "
                                         f"its plain version: {row}")
    split_times(torch, flush)
    return timed


def split_times(torch, flush) -> None:
    """The paged kernel at each S of ``SPLIT_COUNTS`` (up to n_pt) and at
    the S its wrapper picks, at ``SPLIT_SHAPES``, f32 and bf16, serve
    positions (long ones at the long cache): each S's output held to
    ``paged_agrees``, then timed as ``time_ms`` times it. Launched
    through the wrapper's own launch with S given."""
    from akka_allreduce_tpu_torch.ops.kernels import attention
    for i, shape in enumerate(SPLIT_SHAPES):
        positions = "long" if shape == LONG_SHAPE else "serve"
        picked = case_splits(torch, shape)
        counts = sorted({s for s in SPLIT_COUNTS if s <= shape[5]}
                        | {picked})
        for dtype in (torch.float32, torch.bfloat16):
            args = make_case(torch, shape, dtype, 200 + i, positions)
            ref = attention.paged_gather_attention(*args)
            ms = {}
            for s in counts:
                ok, share = paged_agrees(
                    torch, attention._launch_kernel(*args, s), ref)
                if not ok:
                    raise AssertionError(
                        f"paged_attention at S {s} disagrees with its plain "
                        f"version at {shape} {dtype}: {share}")
                ms[s] = time_ms(torch, lambda: attention._launch_kernel(
                    *args, s), flush)
            emit("kernels", kernel="paged_attention_splits",
                 shape=list(shape), dtype=str(dtype), positions=positions,
                 picked=picked, ms=ms,
                 best=min(ms, key=ms.get))
            del args, ref


def flash_bounds(torch, q, k, causal, window, q_off, k_off,
                 peak=None) -> dict:
    """Each flash kernel's least time for this call: its own matmul
    flops over the live (q, k) pairs (2 D each: fwd QK and PV; dq also
    dO.V and dS.K; dk/dv QK, dO.V, P.dO and dS.Q), and its tensors read
    or written once (lse and delta in f32). The operations at
    ``PEAK_FLOPS[peak]`` (default: the inputs' dtype)."""
    from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
        score_mask
    b, tq, h, d = q.shape
    tk = k.shape[1]
    mask = score_mask(tq, tk, causal, window, q_off, k_off, q.device)
    pairs = b * h * (tq * tk if mask is None else int(mask.sum()))
    es = q.element_size()
    qb, kb, rows = q.numel() * es, k.numel() * es, 4 * b * h * tq
    dtype = peak or str(q.dtype).split(".")[-1]
    return {"flash_fwd": bound(4 * d * pairs, 2 * qb + 2 * kb + rows, dtype),
            "flash_dq": bound(6 * d * pairs, 3 * qb + 2 * kb + 2 * rows,
                              dtype),
            "flash_dkv": bound(8 * d * pairs, 2 * qb + 4 * kb + 2 * rows,
                               dtype)}


def flash_case(torch, shape, dtype, seed):
    _, b, tq, tk, h, h_kv, d, *_ = shape
    gen = torch.Generator().manual_seed(seed)
    sizes = ((b, tq, h, d), (b, tk, h_kv, d), (b, tk, h_kv, d), (b, tq, h, d))
    return [torch.randn(s, generator=gen).to(DEVICE, dtype) for s in sizes]


def library_backward(torch, q, k, v, do, causal=True):
    """``scaled_dot_product_attention`` forward once, and a function that
    runs its backward (dq, dk, dv) for ``do``: the yardstick of the
    backward pair. Timed only; the port never calls it."""
    import torch.nn.functional as F
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)
    do_t = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, do_t, retain_graph=True)


def phase_flash_kernels(torch) -> dict:
    """Every listed shape in f32 and bf16 through the three kernels and
    the plain versions; the slice's shape also timed. Returns the timed
    rows by dtype."""
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    timed = {}
    for n, shape in enumerate(FLASH_SHAPES):
        name, *_, causal, window, q_off, k_off = shape
        opts = (causal, window, q_off, k_off)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_case(torch, shape, dtype, seed=100 + n)
            o, lse = fa.flash_forward(q, k, v, *opts)
            want_o, want_lse = fa.flash_forward_reference(q, k, v, *opts)
            delta = fa.attention_delta(want_o, do)
            got = {"o": o, "lse": lse,
                   "dq": fa.flash_dq(q, k, v, do, want_lse, delta, *opts)}
            got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, want_lse,
                                                delta, *opts)
            want = dict(zip(("dq", "dk", "dv"), fa.flash_backward_reference(
                q, k, v, want_o, want_lse, do, *opts)), o=want_o,
                lse=want_lse)
            torch.cuda.synchronize()
            tol_fwd, tol_bwd = FLASH_TOL[str(dtype)]
            errs, ok = {}, True
            for key, g in got.items():
                tol = tol_fwd if key in ("o", "lse") else tol_bwd
                w = want[key].float()
                errs[key] = float((g.float() - w).abs().max())
                ok = ok and bool(torch.isfinite(g).all()) and \
                    torch.allclose(g.float(), w, atol=tol, rtol=tol)
            row = {"shape": name, "dtype": str(dtype), "max_abs_err": errs,
                   "ok": ok}
            del got, want
            if name == "slice":
                bounds = flash_bounds(torch, q, k, *opts)
                lib_bwd = library_backward(torch, q, k, v, do)
                row["ms"] = {
                    "flash_fwd": time_ms(torch, lambda: fa.flash_forward(
                        q, k, v, *opts), flush),
                    "flash_dq": time_ms(torch, lambda: fa.flash_dq(
                        q, k, v, do, lse, delta, *opts), flush),
                    "flash_dkv": time_ms(torch, lambda: fa.flash_dkv(
                        q, k, v, do, lse, delta, *opts), flush)}
                row["plain_ms"] = {
                    "forward": time_ms(torch, lambda: fa
                                       .flash_forward_reference(
                                           q, k, v, *opts), flush),
                    "backward": time_ms(torch, lambda: fa
                                        .flash_backward_reference(
                                            q, k, v, o, lse, do, *opts),
                                        flush)}
                row["library_ms"] = {
                    "forward": time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=True), flush),
                    "backward": time_ms(torch, lib_bwd, flush)}
                row["bound_ms"] = {k_: b_[0] for k_, b_ in bounds.items()}
                row["bound_by"] = {k_: b_[1] for k_, b_ in bounds.items()}
                if dtype == torch.float32:
                    # every f32 kernel runs three TF32 products a product
                    # (bound_ms above: the CUDA cores' 67 TFLOP/s)
                    split = flash_bounds(torch, q, k, *opts, "tf32x3")
                    row["bound_tf32x3_ms"] = {
                        k_: b_[0] for k_, b_ in split.items()}
                del lib_bwd
                timed[str(dtype)] = row
            emit("kernels", kernel="flash_attention", **row)
            del q, k, v, do, o, lse, delta, want_o, want_lse
            torch.cuda.empty_cache()
            if not ok:
                raise AssertionError(f"a flash kernel disagrees with its "
                                     f"plain version: {row}")
    return timed


def flash_kernel_rows(frow: dict, launches: dict, suffix: str = "") -> list:
    """The kernels line's rows of the three flash kernels from phase 5's
    timed row of one dtype (``frow``) and their ``launches`` on the main
    path, each naming its CUDA kernel (``kernel``); in f32 (``suffix``
    "_f32") the bound is that of three TF32 products a product
    (``bound_tf32x3_ms``)."""
    split = frow.get("bound_tf32x3_ms", {})
    return [{
        "name": kernel + suffix, "kernel": cuda_kernel(kernel, suffix),
        "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES[kernel], "launches": launches[kernel],
        "max_abs_err": max(frow["max_abs_err"][k] for k in err_keys),
        "ms": frow["ms"][kernel], "plain_ms": frow["plain_ms"][part],
        "bound_ms": split.get(kernel, frow["bound_ms"][kernel]),
        "bound_by": frow["bound_by"][kernel],
        "library_ms": frow["library_ms"][part]}
        for kernel, err_keys, part in (
            ("flash_fwd", ("o", "lse"), "forward"),
            ("flash_dq", ("dq",), "backward"),
            ("flash_dkv", ("dk", "dv"), "backward"))]


def cuda_kernel(kernel: str, suffix: str) -> str:
    """The CUDA kernel behind a flash or ring row of the kernels line:
    ``flash_fwd`` -> ``flash_fwd_mma_kernel`` (bf16) or
    ``flash_fwd_tf32_mma_kernel`` (``suffix`` "_f32")."""
    name = f"{kernel}_tf32_mma_kernel" if suffix else f"{kernel}_mma_kernel"
    lib = "flash_attention" if kernel.startswith("flash") else "ring_flash"
    assert name in MMA_KERNELS[lib], name
    return name


def profile_train_steps(torch, args, params, n_steps=2) -> dict:
    """A torch.profiler window over ``n_steps`` train steps on
    ``params`` (one warm-up step first, so the optimizer's state exists):
    wall ms per step, device ms per step by kernel, the flash kernels'
    share and the device's idle share."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.train import (make_train_state,
                                                       make_train_step)
    cfg = cli.train_config(args, args.seq)
    state = make_train_state(cfg, params=params)
    step = make_train_step(cfg)

    def tokens(i):
        return torch.from_numpy(np.random.default_rng(i).integers(
            0, args.vocab, size=(args.batch, args.seq),
            dtype=np.int32)).to(DEVICE)
    step(state, tokens(args.steps))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(state, tokens(args.steps + 1 + i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    rows = device_kernel_rows(torch, prof.key_averages(), n_steps)
    device_ms = sum(ms for _, ms in rows)
    flash_ms = sum(ms for key, ms in rows if "flash_" in key)
    gemm_ms = sum(ms for key, ms in rows if any(
        tag in key for tag in ("gemm", "nvjet", "cutlass", "xmma")))
    return {
        "steps": n_steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if rows
        else "not measured",
        "flash_kernels_ms_per_step": flash_ms,
        "flash_share_of_device": flash_ms / device_ms if rows
        else "not measured",
        "gemm_kernels_ms_per_step": gemm_ms,
        "top_kernels": sorted(rows, key=lambda r: -r[1])[:12]}


def phase_train(torch) -> dict:
    """The main path: ``run_train`` at the flagship configuration, every
    flash counter set to 0 just before and read just after."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    args = cli.build_parser().parse_args(TRAIN_ARGV)
    params = init_transformer(torch.Generator(DEVICE).manual_seed(0),
                              cli.train_config(args, args.seq).model,
                              DEVICE)
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    report = cli.run_train(args, params=params)
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
                "flash_dq": fa.FLASH_DQ_LAUNCHES,
                "flash_dkv": fa.FLASH_DKV_LAUNCHES}
    expected = args.n_layers * args.steps
    emit("train_run", **{k: report[k] for k in (
        "config", "device", "losses", "step_ms", "wall_ms_per_step",
        "tokens_per_s", "step_flops", "mfu")}, launches=launches,
        expected_launches=expected,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{expected} each (n_layers x steps)")
    if not all(math.isfinite(x) for x in report["losses"]):
        raise AssertionError(f"non-finite losses {report['losses']}")
    profile = profile_train_steps(torch, args, params)
    emit("train_step_profile", **profile)
    return {"launches": launches, "losses": report["losses"],
            "params": report["config"]["params"],
            "wall_ms_per_step": report["wall_ms_per_step"],
            "optimizer_state_gb": report["optimizer_state_gb"],
            "idle_share": profile["device_idle_share"]}


def phase_train_parity(torch) -> dict:
    """gqa4 at full width, f32 and bf16: step-0 loss and grads through
    the kernels against the plain local attention, then two steps of each
    from the same weights and batches (``PARITY_TOL``)."""
    return {dtype: train_parity(torch, dtype) for dtype in PARITY_TOL}


def drop_query_head(dkv, head: int = 0):
    """Phase 7's planted fault: ``dkv`` (the dk/dv wrapper) without query
    head ``head``'s share of its KV head's dk and dv (that head's dO and
    delta zeroed), what a kernel that lost one member of a GQA group
    would return."""
    def faulty(q, k, v, do, lse, delta, *opts):
        do, delta = do.clone(), delta.clone()
        do[:, :, head] = 0
        delta[:, head] = 0
        return dkv(q, k, v, do, lse, delta, *opts)
    return faulty


def step0_parity(torch, args, cfg: dict, seed: int, dkv=None) -> dict:
    """Step 0 from the weights and batch of ``seed``: the loss through the
    flash path and through local attention, and the largest gradient
    difference relative to its leaf's largest value. ``dkv``, where given,
    stands in for the flash path's dk/dv wrapper."""
    import numpy as np

    from akka_allreduce_tpu_torch.models.train import (make_grad_step,
                                                       make_train_state,
                                                       tree_leaves)
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    params = init_transformer(torch.Generator(DEVICE).manual_seed(seed),
                              cfg["flash"].model, DEVICE)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, args.vocab, size=(args.batch, args.seq),
        dtype=np.int32)).to(DEVICE)
    state = make_train_state(cfg["flash"], params=params)
    grads, loss = {}, {}
    sound = fa.flash_dkv
    fa.flash_dkv = dkv or sound
    try:
        for impl in ("flash", "local"):
            g, metrics = make_grad_step(cfg[impl])(state.params, tokens)
            grads[impl], loss[impl] = tree_leaves(g), float(metrics["loss"])
    finally:
        fa.flash_dkv = sound
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(grads["flash"], grads["local"]))
    return {"loss0": loss, "grad_err": err}


def train_parity(torch, dtype: str) -> dict:
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.train import tree_map
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    args = cli.build_parser().parse_args(
        PARITY_ARGV + (["--bf16"] if dtype == "bfloat16" else []))
    tol = PARITY_TOL[dtype]
    cfg = {impl: cli.train_config(args, args.seq, impl)
           for impl in ("flash", "local")}
    step0 = {seed: step0_parity(torch, args, cfg, seed)
             for seed in PARITY_SEEDS}
    control = step0_parity(torch, args, cfg, PARITY_SEEDS[0],
                           drop_query_head(fa.flash_dkv))
    params0 = init_transformer(torch.Generator(DEVICE).manual_seed(0),
                               cfg["flash"].model, DEVICE)
    runs = {}
    for impl in ("flash", "local"):
        runs[impl] = cli.run_train(
            args, params=tree_map(lambda p: p.detach().clone(), params0),
            attn_impl=impl)
        torch.cuda.empty_cache()
    rel = [abs(f - l) / abs(l) for f, l in zip(runs["flash"]["losses"],
                                               runs["local"]["losses"])]
    out = {"compute_dtype": dtype, "step0_by_seed": step0,
           "control_drop_query_head": control,
           "losses": {k: r["losses"] for k, r in runs.items()},
           "step_ms": {k: r["step_ms"] for k, r in runs.items()},
           "flash_launches": runs["flash"]["launches"],
           "loss_rel_err": rel, "tolerances": tol}
    emit("train_parity", **out)
    losses = runs["flash"]["losses"] + runs["local"]["losses"]
    ok = (all(abs(r["loss0"]["flash"] - r["loss0"]["local"])
              <= tol["loss0"] * abs(r["loss0"]["local"])
              and r["grad_err"] <= tol["grads"] for r in step0.values())
          and control["grad_err"] > tol["grads"]
          and len(rel) == args.steps
          and rel[0] <= tol["loss0"] and rel[1] <= tol["loss1"]
          and all(math.isfinite(x) for x in losses)
          and all(n == args.n_layers * args.steps
                  for n in runs["flash"]["launches"].values()))
    if not ok:
        raise AssertionError(f"flash vs local training parity failed: {out}")
    return out


def reduce_bound(peers: int, elems: int) -> "tuple[float, str]":
    """The masked reduce's least time: the staging matrix read once, the
    output written once (and the mask and count); 2 f32 flops per staged
    value."""
    return bound(2 * peers * elems, 4 * (peers * elems + elems + peers + 1),
                 "float32")


def quant_bound(kernel: str, rows: int, cols: int, nb: int
                ) -> "tuple[float, str]":
    """A quantize or dequantize kernel's least time: x (4 B), a bits
    tensor (4 B) where it reads one, the scales, and the int8 values
    (1 B) read or written once; ~5 f32 operations per quantized element
    (division, floor, subtraction, comparison, addition), 1 per
    dequantized one. (The in-kernel Philox's ~20 integer operations per
    element have no entry in the card's table of peaks and are not
    counted.)"""
    n = rows * cols
    per = {"quantize_int8": 9, "quantize_int8_block": 9,
           "quantize_int8_prng": 5, "quantize_int8_block_rtn": 5,
           "dequantize_int8": 5, "dequantize_int8_block": 5}[kernel]
    flops = n if kernel.startswith("dequantize") else 5 * n
    return bound(flops, per * n + 4 * rows * nb, "float32")


def _same(a, b) -> "tuple[bool, float]":
    """(bitwise equal, max |a - b|) of two tensors."""
    err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    return torch_equal(a, b), err


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def library_quantize_rtn(torch, x, scales, block):
    """``torch.quantize_per_channel`` over the (rows * blocks, block) view
    with one scale per block: the library's round-to-nearest int8
    quantizer, the yardstick of the block RTN kernel. Timed only; the
    port never calls it."""
    rows, cols = x.shape
    ch = x.view(rows * (cols // block), block)
    zp = torch.zeros(ch.shape[0], dtype=torch.int64, device=x.device)
    return torch.quantize_per_channel(ch, scales.reshape(-1).double(), zp, 0,
                                      torch.qint8)


def main_path_staging(n_params: int, world: int = DP_WORLD,
                      bucket_elems: int = BUCKET_ELEMS) -> "tuple[int, int]":
    """The masked reduce's shape on phase 9's f32 sync: the bucket matrix
    (ceil(params / bucket_elems) rows of bucket_elems) flattened, padded
    to the world and scattered, so each rank sums ``world`` blocks of
    ceil(rows * bucket_elems / world) (ops/collectives.py
    ``psum_allreduce`` -> ``_rank_sum``)."""
    rows = -(-n_params // bucket_elems)
    return world, -(-rows * bucket_elems // world)


def strided_reduce_cases(n_params: int) -> list:
    """(peers, row width, offset, chunk) of phase 8's strided masked
    reduces: phase 19's script geometry (blocks of 195 and 193 floats in
    chunks of 3: rows whose width is not a multiple of 4, chunks at
    offsets that are not 16-byte aligned, a last chunk of one float), a
    row of 196 in chunks of 4 (the float4 path), and phase 19 (c)'s
    two-worker block of phase 9's gradient in chunks of 65,536 (a full
    chunk, and the last, half-full one)."""
    block = -(-n_params // BUCKET_ELEMS) * BUCKET_ELEMS // 2
    last = (block - 1) // BUCKET_ELEMS * BUCKET_ELEMS
    return [(4, 195, 0, 3), (4, 195, 3, 3), (4, 195, 192, 3),
            (4, 193, 192, 1), (4, 196, 4, 4), (4, 196, 5, 3),
            (2, block, 7 * BUCKET_ELEMS, BUCKET_ELEMS),
            (2, block, last, block - last)]


def phase_sync_kernels(torch, n_params: int) -> dict:
    """Rows 1-7 against their plain versions (see the module docstring);
    returns the timed row of each kernel at its main shape."""
    from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
    from akka_allreduce_tpu_torch.ops.kernels import quantized as qz
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    timed = {}

    peers0, elems0 = main_path_staging(n_params)
    cases = [(peers0, elems0, (1,) * peers0, float(peers0))] + REDUCE_CASES
    for n, (peers, elems, mask, target) in enumerate(cases):
        gen = torch.Generator(DEVICE).manual_seed(200 + n)
        staged = torch.randn((peers, elems), generator=gen, device=DEVICE)
        valid = torch.tensor(mask, dtype=torch.int32, device=DEVICE)
        out, count = mr.masked_reduce(staged, valid, target)
        ref, ref_count = mr.masked_reduce_reference(staged, valid, target)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and int(count) == int(
            ref_count) and torch.allclose(out, ref, rtol=1e-6, atol=1e-7)
        row = {"shape": [peers, elems], "valid": list(mask),
               "target": target, "count": int(count), "max_abs_err": err,
               "bitwise": torch_equal(out, ref), "ok": ok}
        if n == 0:
            w = valid.float() * (target / float(valid.sum()))
            b_ms, by = reduce_bound(peers, elems)
            row.update(
                ms=time_ms(torch, lambda: mr.masked_reduce(
                    staged, valid, target), flush),
                plain_ms=time_ms(torch, lambda: mr.masked_reduce_reference(
                    staged, valid, target), flush, reps=5, warmup=1),
                library_ms=time_ms(torch, lambda: torch.mv(staged.t(), w),
                                   flush),
                library_call="torch.mv(staged.t(), valid * target / count)",
                bound_ms=b_ms, bound_by=by, main_path=True)
            timed["masked_reduce"] = row
        emit("sync_kernels", kernel="masked_reduce", **row)
        if not ok:
            raise AssertionError(f"masked_reduce disagrees with its plain "
                                 f"version: {row}")
        del staged, out, ref

    # the protocol plane's chunk reduce (phase 19): (peers, chunk) slabs
    # of a wider staging row, read in place with ld = the row's width
    for n, (peers, width, start, chunk) in enumerate(
            strided_reduce_cases(n_params)):
        gen = torch.Generator(DEVICE).manual_seed(400 + n)
        staging = torch.randn((peers, width), generator=gen, device=DEVICE)
        slab = staging[:, start:start + chunk]
        ones = torch.ones(peers, device=DEVICE)
        out, count = mr.masked_reduce(slab, ones, float(peers))
        ref, ref_count = mr.masked_reduce_reference(slab, ones, float(peers))
        torch.cuda.synchronize()
        bitwise, err = _same(out, ref)
        row = {"shape": [peers, chunk], "ld": width, "offset": start,
               "vec4": width % 4 == 0 and chunk % 4 == 0 and start % 4 == 0,
               "count": int(count), "max_abs_err": err, "bitwise": bitwise,
               "ok": bitwise and int(count) == int(ref_count) == peers}
        if chunk == BUCKET_ELEMS and "masked_reduce_strided" not in timed:
            b_ms, by = reduce_bound(peers, chunk)
            row.update(
                ms=time_ms(torch, lambda: mr.masked_reduce(
                    slab, ones, float(peers)), flush),
                plain_ms=time_ms(torch, lambda: mr.masked_reduce_reference(
                    slab, ones, float(peers)), flush),
                bound_ms=b_ms, bound_by=by)
            timed["masked_reduce_strided"] = row
        emit("sync_kernels", kernel="masked_reduce_strided", **row)
        if not row["ok"]:
            raise AssertionError(f"masked_reduce on a strided slab disagrees "
                                 f"with its plain version: {row}")
        del staging, slab, out, ref

    rows = -(-n_params // BUCKET_ELEMS)
    shapes = [("flagship", rows, BUCKET_ELEMS, EF_BLOCK),
              ("small", 5, 1000, 128), ("small", 5, 1000, 512),
              ("ragged", 3, 1001, 128)]
    for name, r, c, block in shapes:
        gen = torch.Generator(DEVICE).manual_seed(300 + r + c + block)
        x = torch.randn((r, c), generator=gen, device=DEVICE)
        x[0, :7] *= 50.0  # an outlier block
        bits = torch.randint(-2 ** 31, 2 ** 31, (r, c), dtype=torch.int32,
                             generator=gen, device=DEVICE)
        seed = 0x9E3779B97F4A7C15 + r
        rs, bs = qz.row_scales(x), qz.block_scales(x, block)
        # each quantize kernel's launch alone, on the scales computed
        # above (the wrappers compute them first, outside the kernel)
        launch = {
            "quantize_int8": lambda: qz._quantize(x, rs, c, "bits", bits, 0),
            "quantize_int8_prng": lambda: qz._quantize(x, rs, c, "philox",
                                                       None, seed),
            "quantize_int8_block": lambda: qz._quantize(x, bs, block, "bits",
                                                        bits, 0),
            "quantize_int8_block_rtn": lambda: qz._quantize(x, bs, block,
                                                            "rtn", None, 0)}
        scale_pass = {"quantize_int8": lambda: qz.row_scales(x),
                      "quantize_int8_prng": lambda: qz.row_scales(x),
                      "quantize_int8_block": lambda: qz.block_scales(x, block),
                      "quantize_int8_block_rtn":
                          lambda: qz.block_scales(x, block)}
        runs = {
            "quantize_int8": (lambda: qz.quantize_int8(x, bits),
                              lambda: qz.quantize_reference(x, rs, c, "bits",
                                                            bits), rs),
            "quantize_int8_prng": (
                lambda: qz.quantize_int8_prng(x, seed),
                lambda: qz.quantize_reference(x, rs, c, "philox",
                                              seed=seed), rs),
            "quantize_int8_block": (
                lambda: qz.quantize_int8_block(x, bits, block),
                lambda: qz.quantize_reference(x, bs, block, "bits", bits),
                bs),
            "quantize_int8_block_rtn": (
                lambda: qz.quantize_int8_block_rtn(x, block),
                lambda: qz.quantize_reference(x, bs, block, "rtn"), bs)}
        values = {}
        for kernel, (run, plain, want_s) in runs.items():
            v, s = run()
            ref = plain()
            alone = launch[kernel]()
            torch.cuda.synchronize()
            bitwise, err = _same(v, ref)
            scales_ok = torch_equal(s, want_s)
            alone_ok = torch_equal(alone, v)
            values[kernel] = (v, s)
            row = {"shape": [r, c], "block": block if "block" in kernel
                   else c, "max_abs_err": err, "bitwise": bitwise,
                   "scales_bitwise": scales_ok, "launch_alone_bitwise":
                   alone_ok, "ok": bitwise and scales_ok and alone_ok}
            if kernel == "quantize_int8_prng":
                # the seed read from device memory (a captured chunk's
                # table): bitwise the by-value seed's words
                seed_t = qz.seed_tensor(seed, DEVICE)
                by_ptr = qz.quantize_int8_prng(x, seed_t)[0]
                torch.cuda.synchronize()
                row["pointer_seed_bitwise"] = torch_equal(by_ptr, v)
                row["ok"] = row["ok"] and row["pointer_seed_bitwise"]
                if name == "flagship":
                    row["pointer_seed_ms"] = time_ms(
                        torch, lambda: qz._quantize(x, rs, c, "philox",
                                                    None, 0, seed_t), flush)
                del by_ptr
            del alone
            if name == "flagship" and kernel not in timed:
                nb = s.shape[1]
                b_ms, by = quant_bound(kernel, r, c, nb)
                slow = kernel == "quantize_int8_prng"
                row.update(
                    ms=time_ms(torch, launch[kernel], flush),
                    scales_ms=time_ms(torch, scale_pass[kernel], flush),
                    wrapper_ms=time_ms(torch, run, flush),
                    plain_ms=time_ms(torch, plain, flush,
                                     reps=2 if slow else 3, warmup=1),
                    bound_ms=b_ms, bound_by=by, library_ms=None,
                    main_path=kernel in MAIN_PATH_SYNC)
                if kernel == "quantize_int8_block_rtn":
                    lib = library_quantize_rtn(torch, x, s, block)
                    match = torch_equal(lib.int_repr().view(r, c), v)
                    row["library_matches"] = match
                    if match:
                        row["library_ms"] = time_ms(
                            torch, lambda: library_quantize_rtn(
                                torch, x, s, block), flush)
                        row["library_call"] = "torch.quantize_per_channel"
                    del lib
                timed[kernel] = row
            emit("sync_kernels", kernel=kernel, **row)
            if not row["ok"]:
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     f"version: {row}")
        for kernel, q_name, block_of in (
                ("dequantize_int8", "quantize_int8", c),
                ("dequantize_int8_block", "quantize_int8_block", block)):
            v, s = values[q_name]
            run = ((lambda: qz.dequantize_int8(v, s))
                   if kernel == "dequantize_int8"
                   else (lambda: qz.dequantize_int8_block(v, s, block)))
            out = run()
            ref = qz.dequantize_reference(v, s, block_of)
            torch.cuda.synchronize()
            bitwise, err = _same(out, ref)
            row = {"shape": [r, c], "block": block_of, "max_abs_err": err,
                   "bitwise": bitwise, "ok": bitwise}
            if name == "flagship" and kernel not in timed:
                b_ms, by = quant_bound(kernel, r, c, s.shape[1])
                if kernel == "dequantize_int8":
                    lib = (lambda: torch.mul(v, s))
                    call = "torch.mul(values, scales)"
                else:
                    lib = (lambda: torch.mul(
                        v.view(r, -1, block), s.view(r, -1, 1)))
                    call = "torch.mul(values.view(r, nb, block), scales)"
                match = torch_equal(lib().reshape(r, c), out)
                row.update(
                    ms=time_ms(torch, run, flush),
                    plain_ms=time_ms(torch, lambda: qz.dequantize_reference(
                        v, s, block_of), flush, reps=3, warmup=1),
                    bound_ms=b_ms, bound_by=by, library_matches=match,
                    library_ms=time_ms(torch, lib, flush) if match else None,
                    library_call=call, main_path=True)
                timed[kernel] = row
            emit("sync_kernels", kernel=kernel, **row)
            if not row["ok"]:
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     f"version: {row}")
            del out, ref
        del x, bits, values
        torch.cuda.empty_cache()
    return timed


def window_count(rows: int, num_windows: int) -> int:
    """The windowed f32/bf16 schedule's window count (parallel/dp.py's
    rule, restated): degraded until the zero-row pad is under a window."""
    w = min(num_windows, rows)
    while w > 1 and (-rows) % w >= -(-rows // w):
        w -= 1
    return max(w, 1)


def expected_sync_launches(transport: str, schedule: str, world: int,
                           num_buckets: int, num_windows: int = 4) -> dict:
    """Kernel launches of ONE gradient sync: the fused two-phase sums its
    ranks' blocks with one masked reduce (f32/bf16); the int8 wire
    quantizes twice and dequantizes once; ef8 quantizes to nearest once
    (phase 1), stochastically once (phase 2) and dequantizes three times
    (its own send, what it received, the broadcast). The windowed
    schedule repeats that per window; swing runs log2(world) hops of one
    quantize and two dequantizes (ef8: the first hop to nearest) and
    sums f32/bf16 with plain adds. The hierarchical schedule (ef8 on a
    mesh whose dp and sp are both > 1) sums its sp line's blocks with one
    masked reduce, then runs the fused ef8 over its dp line on the
    shard."""
    out = dict.fromkeys(SYNC_KERNELS, 0)
    quant = "quantize_int8_prng"
    if world == 1:
        return out
    if schedule == "hierarchical":
        out.update({"masked_reduce": 1, "quantize_int8_block_rtn": 1,
                    "quantize_int8_block": 1, "dequantize_int8_block": 3})
        return out
    if schedule == "swing":
        hops = world.bit_length() - 1
        if transport == "int8":
            out.update({quant: hops, "dequantize_int8": 2 * hops})
        elif transport == "ef8":
            out.update({"quantize_int8_block_rtn": 1,
                        "quantize_int8_block": hops - 1,
                        "dequantize_int8_block": 2 * hops})
        return out
    if transport in ("f32", "bf16"):
        out["masked_reduce"] = (window_count(num_buckets, num_windows)
                                if schedule == "windowed" else 1)
        return out
    padded = num_buckets + (-num_buckets) % world
    w = min(num_windows, padded // world) if schedule == "windowed" else 1
    if transport == "int8":
        out.update({quant: 2 * w, "dequantize_int8": w})
    else:
        out.update({"quantize_int8_block_rtn": w, "quantize_int8_block": w,
                    "dequantize_int8_block": 3 * w})
    return out


def steady(xs):
    """The mean after the first entry (the first step warms up)."""
    return statistics.mean(xs[1:] or xs) if xs else None


def run_twin(torch, argv: list, steps: int) -> "tuple[dict, float]":
    """The gloo twin of an ipc run: ``argv`` on the host wire for
    ``steps`` steps (:func:`spawn_batch`). Returns its report and
    seconds."""
    from akka_allreduce_tpu_torch import cli
    args = cli.build_parser().parse_args(
        argv + ["--dist-backend", TWIN, "--steps", str(steps)])
    (report, seconds), = spawn_batch(torch, [("train", args, None)],
                                     sp=args.sp)
    return report, seconds


def twin_fields(report: dict, twin: dict, seconds: float) -> dict:
    """An ipc run against its gloo twin: the twin's losses, times and
    peaks, and whether its losses (and, when it ran every step, its
    parameter and ef8 residual checksums) are bitwise the ipc run's.
    Also the ipc run's transport use (rank 0) and buffers."""
    ranks, tranks = report["ranks"], twin["ranks"]
    n = len(twin["losses"])
    out = {"twin_backend": twin["dist"]["backend"], "twin_steps": n,
           "twin_losses": twin["losses"],
           "losses_bitwise_twin": report["losses"][:n] == twin["losses"],
           "twin_wall_ms_per_step": twin["wall_ms_per_step"],
           "twin_sync_ms_per_step": [steady(r["sync_ms"]) for r in tranks],
           "twin_attn_exchange_ms_per_step": [
               steady(r["attn_exchange_ms"]) for r in tranks],
           "twin_peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                            for r in tranks],
           "transport_buffer_gb_per_rank": [r["transport_buffer_gb"]
                                            for r in ranks],
           "transport": ranks[0]["transport"], "twin_run_seconds": seconds}
    if n == len(report["losses"]):
        out["param_checksums_bitwise_twin"] = (
            [r["param_checksum"] for r in ranks]
            == [r["param_checksum"] for r in tranks])
        if "residual_checksum" in ranks[0]:
            out["residual_checksums"] = [r["residual_checksum"]
                                         for r in ranks]
            out["residual_checksums_bitwise_twin"] = (
                out["residual_checksums"]
                == [r["residual_checksum"] for r in tranks])
    return out


def check_twin(name: str, report: dict, fields: dict,
               peak: bool = False) -> None:
    """Raise unless the ipc run rode the transport and matches its twin
    bitwise; with ``peak``, unless each rank's peak (the allocator's
    plus the fixed buffers) is at most the twin's plus the buffers."""
    bad = [k for k in ("losses_bitwise_twin", "param_checksums_bitwise_twin",
                       "residual_checksums_bitwise_twin")
           if fields.get(k) is False]
    if report["dist"]["backend"] != DIST or (
            DIST == "ipc" and not fields["transport"]["transport_launches"]):
        bad.append(f"backend {report['dist']['backend']}, transport "
                   f"{fields['transport']}")
    if peak:
        over = [(p["peak_memory_gb"], t) for p, t in zip(
            report["ranks"], fields["twin_peak_memory_gb_per_rank"])
            if p["peak_memory_gb"] is not None and p["peak_memory_gb"] > t]
        if over:
            bad.append(f"ipc peaks above the gloo twin's: {over}")
    if bad:
        raise AssertionError(f"{name}: the ipc run against its gloo twin: "
                             f"{bad} ({fields})")

def traced_sync(torch, group, sync):
    """``sync()`` (one gradient sync of a training step) under
    ``torch.profiler``, drained at its end: its result, and the
    host-device copies the trace holds (``Memcpy DtoH`` / ``HtoD``, with
    their bytes) and the transport's kernels in it."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = sync()
        transport.wait(group)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="trace-") as tmp:
        path = os.path.join(tmp, "sync.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [{"name": e.get("name"), "bytes": e.get("args", {}).get(
        "bytes")} for e in events
        if "Memcpy" in str(e.get("name")) and (
            "DtoH" in str(e.get("name")) or "HtoD" in str(e.get("name")))]
    kernels = sum(1 for e in events
                  if e.get("cat") == "kernel"
                  and "transport_copy_kernel" in str(e.get("name")))
    return res, {"host_copies": copies, "transport_kernels": kernels,
                 "largest_host_copy_bytes": max(
                     [c["bytes"] or 0 for c in copies], default=0)}


def traced_train_rank(group, args, params, attn_impl):
    """``cli``'s train rank with step 1's gradient sync traced
    (``traced_sync``; the step that ``wall_ms_per_step`` and the steady
    sync ms leave out), the trace in the rank's ``rank_info``."""
    import torch

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models import train
    real, trace = train.allreduce_gradients, {}

    def sync(*a, **k):
        if trace:
            return real(*a, **k)
        res, found = traced_sync(torch, group, lambda: real(*a, **k))
        trace.update(found)
        return res
    train.allreduce_gradients = sync
    try:
        report = cli._train_rank(group, args, params, attn_impl)
    finally:
        train.allreduce_gradients = real
    report["rank_info"]["sync_trace"] = trace
    return report


def fold_dropped_train_rank(group, args, params, attn_impl):
    """``cli``'s train rank with the overlapped schedule's last fold
    dropped (the last microbatch's synced gradients never reach the
    update): phase 21 (c)'s fault control."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models import train
    fold = train.fold_in_flight
    train.fold_in_flight = lambda acc, fly: acc
    try:
        return cli._train_rank(group, args, params, attn_impl)
    finally:
        train.fold_in_flight = fold


RANK_MODES = {"traced": traced_train_rank,
              "fold_dropped": fold_dropped_train_rank}


def batch_rank(group, jobs: list) -> list:
    """A rank of :func:`spawn_batch`: each job in turn in this one rank
    process. A job is ``("train", args, mode)``, ``cli``'s train rank
    (``RANK_MODES``: plain, "traced" or "fold_dropped"), or ``("call",
    fn, args)``, ``fn(group, *args)``. Returns each job's result and
    seconds; the peak memory is reset before each job."""
    import gc

    import torch

    from akka_allreduce_tpu_torch import cli
    out = []
    for kind, target, extra in jobs:
        gc.collect()  # the last job's tensors gone before its peak resets
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(group.device)
        t0 = time.perf_counter()
        if kind == "call":
            res = target(group, *extra)
        else:
            fn = cli._train_rank if extra is None else RANK_MODES[extra]
            res = fn(group, target, None, None)
        out.append((res, time.perf_counter() - t0))
    return out


def spawn_batch(torch, jobs: list, world: "int | None" = None,
                backend: "str | None" = None, sp: int = 1, ep: int = 1,
                tp: int = 1, pp: int = 1) -> list:
    """Every job of ``jobs`` (:func:`batch_rank`) in one spawn of the
    ranks, so the ranks' start (processes, CUDA contexts, the process
    group and the ipc buffers: ~20 s a spawn on the card) is paid once;
    with ``POOLED`` (set by :func:`main`) in the :class:`RankPool` of
    ``world`` ranks, whose start is paid once for the whole script.
    Train jobs must share their world, mesh (``(pp, dp, ep, sp, tp)``) and
    backend, which they give (their counters are per run: each report's
    launches are the run's own). Returns per job a train job's report as
    ``run_train`` returns it (rank 0's, with ``ranks``) or a call job's
    per-rank results, each with the job's seconds on rank 0."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    meshes = set()
    for kind, args, _ in jobs:
        if kind == "train":
            backend_ = cli._check_train_flags(args)[2]
            meshes.add((args.dp * args.ep * args.sp * args.tp * args.pp,
                        args.sp, args.ep, args.tp, args.pp, backend_))
    if len(meshes) > 1:
        raise ValueError(f"one spawn runs one mesh, got {meshes}")
    if meshes:
        world, sp, ep, tp, pp, backend = meshes.pop()
    if DEVICE == "cuda":
        import gc

        from akka_allreduce_tpu_torch.ops.kernels import build
        build.build_all()
        gc.collect()  # this process's dropped tensors, before the ranks'
        torch.cuda.empty_cache()
    if POOLED:
        per_rank = rank_pool(world).run(backend or DIST, (sp, ep, tp, pp),
                                        jobs)
    else:
        per_rank = spawn_ranks(batch_rank, world, backend or DIST, DEVICE,
                               jobs, sp=sp, ep=ep, tp=tp, pp=pp)
    out = []
    for k, (kind, _, _) in enumerate(jobs):
        results = [r[k][0] for r in per_rank]
        if kind == "train":
            report = results[0]
            report["ranks"] = [r.pop("rank_info") for r in results]
            results = report
        out.append((results, per_rank[0][k][1]))
    return out


# spawn_batch runs its batches in one RankPool a world size (main() sets
# it; each rank process then starts once, not once a phase: on the card
# a start is ~10 s of importing torch and ~2 s of CUDA context)
POOLED = False
_POOLS: dict = {}  # world size -> RankPool
POOL_TIMEOUT_S = 900.0  # a batch's limit, as spawn_ranks' default


def pool_rank(rank: int, world: int, device: str, store: str, inbox,
              results) -> None:
    """A rank process of a :class:`RankPool`: a spawned rank's set-up
    (``parallel/group.py``: its device, intra-op threads and the world's
    gloo process group) once, then each batch ``(n, backend, sp, jobs)``
    from ``inbox`` as a fresh spawn runs it: the batch's ``RankGroup``
    (``sp``, or the mesh's ``(sp, ep, tp, pp)``) and axis subgroups,
    :func:`batch_rank`, the stream drained, the peer buffers and
    subgroups freed, then the allocator's cache emptied.
    Puts ``(rank, n, ok, payload)`` on ``results``; ends at ``None`` or
    after a batch that raised."""
    import gc
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from akka_allreduce_tpu_torch.parallel import group as G
    try:
        dev = G.rank_device(device, rank, "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(1 if dev.type == "cpu"
                              else max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    except Exception:  # noqa: BLE001 - the rank's boundary: reported
        results.put((rank, 0, False, traceback.format_exc()))
        return
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                return
            n, backend, mesh, jobs = msg
            sp, ep, tp, pp = (mesh if isinstance(mesh, tuple)
                              else (mesh, 1, 1, 1))
            try:
                group = G.RankGroup(rank, world, backend, dev, sp, ep=ep,
                                    tp=tp, pp=pp)
                try:
                    G.make_axis_subgroups(group)
                    out = batch_rank(group, jobs)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    G.free_peer_buffers(group)
                finally:
                    G.free_axis_subgroups()
                payload = pickle.dumps(G._to_cpu(out))
                del out
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                ok = True
            except Exception:  # noqa: BLE001 - reported, the pool ends
                payload, ok = traceback.format_exc(), False
            # the batch's lines reach the parent's output before it goes on
            sys.stdout.flush()
            sys.stderr.flush()
            results.put((rank, n, ok, payload))
            if not ok:
                return
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()
        sys.stderr.flush()


class RankPool:
    """``world`` rank processes (:func:`pool_rank`) on ``DEVICE`` that
    run :func:`spawn_batch`'s batches one after another, each as a fresh
    spawn of the ranks would (its own backend, mesh, subgroups and peer
    buffers; every run's counters and peak its own), so a phase pays no
    rank start. A batch that raises on a rank, a rank that dies and a
    batch over ``POOL_TIMEOUT_S`` end the pool and raise here."""

    def __init__(self, world: int):
        import torch
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.batches = world, 0
        self.tmp = tempfile.mkdtemp(prefix="pool-")
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(
            target=pool_rank, daemon=True,
            args=(r, world, DEVICE, os.path.join(self.tmp, "store"),
                  self.inboxes[r], self.results)) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, backend: str, sp: "int | tuple", jobs: list) -> list:
        """One batch on every rank, on the mesh of ``sp`` (or of ``(sp,
        ep, tp, pp)``): each rank's :func:`batch_rank` results, in rank
        order."""
        import pickle
        import queue

        from akka_allreduce_tpu_torch.parallel.group import check_backend
        check_backend(backend, DEVICE, self.world)
        self.batches += 1
        for inbox in self.inboxes:
            inbox.put((self.batches, backend, sp, jobs))
        got: dict = {}
        deadline = time.monotonic() + POOL_TIMEOUT_S
        try:
            while len(got) < self.world:
                try:
                    rank, n, ok, payload = self.results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if r not in got and not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"pool of {self.world} ranks: rank(s) "
                            f"{dead or 'all'} "
                            + ("died" if dead else f"did not finish batch "
                               f"{self.batches} within {POOL_TIMEOUT_S:.0f}"
                               f" s"))
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {self.world} "
                                       f"failed:\n{payload}")
                got[rank] = pickle.loads(payload)
        except BaseException:
            self.close()
            raise
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        """End the rank processes (each leaves its loop; one that does
        not within 30 s is terminated) and drop the pool."""
        import shutil
        for inbox in self.inboxes:
            inbox.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self.tmp, ignore_errors=True)
        if _POOLS.get(self.world) is self:
            del _POOLS[self.world]


@contextlib.contextmanager
def pooled_spawns():
    """Inside, the port's own ``parallel/group.py spawn_ranks`` (as
    ``bench.py``'s rows call it) runs its function as a call job on the
    :class:`RankPool` of its world, when ``POOLED`` and on ``DEVICE``;
    otherwise it spawns as before."""
    from akka_allreduce_tpu_torch.parallel import group as G
    real = G.spawn_ranks

    def spawn(fn, world, backend, device, *args, sp=1, timeout=900.0):
        if not POOLED or device != DEVICE:
            return real(fn, world, backend, device, *args, sp=sp,
                        timeout=timeout)
        return [r[0][0] for r in rank_pool(world).run(
            backend, sp, [("call", fn, args)])]
    G.spawn_ranks = spawn
    try:
        yield
    finally:
        G.spawn_ranks = real


def rank_pool(world: int) -> RankPool:
    """The pool of ``world`` ranks, started on first use."""
    if world not in _POOLS:
        _POOLS[world] = RankPool(world)
    return _POOLS[world]


def close_pools(world: "int | None" = None) -> None:
    """End the pool of ``world`` ranks, or every pool."""
    for w in [world] if world is not None else list(_POOLS):
        if w in _POOLS:
            _POOLS[w].close()


def check_sync_traces(name: str, ranks: list) -> None:
    """Raise unless every rank's traced sync ran the transport's kernels
    and holds no host-device copy above ``TRANSPORT_HOST_COPY_MAX``."""
    traces = [r.get("sync_trace") or {} for r in ranks]
    big = [t.get("largest_host_copy_bytes") for t in traces]
    kernels = [t.get("transport_kernels") for t in traces]
    if not all(kernels) or any(b is None or b > TRANSPORT_HOST_COPY_MAX
                               for b in big):
        raise AssertionError(f"{name}: the traced ipc sync holds host "
                             f"copies of {big} bytes at most and "
                             f"{kernels} transport kernels")


def phase_train_dp(torch, one_card_losses: list) -> dict:
    """``run_train`` at dp=2 per wire on the ipc transport (the main path
    of the sync), each with its gloo twin; the wires share one spawn of
    the ranks and the twins another (``spawn_batch``: each run's counts
    are its own). The f32 wire's losses are held
    against phase 6's first steps (the same weights and global batches
    on one card), the quantized wires' against the f32 wire's. Returns
    the sync kernels' and the transport's launches summed over the runs
    (rank 0's; ``launches``, ``transport``) and each wire's emitted line
    (``runs``), which phase 16 compares with."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    totals = dict.fromkeys(SYNC_KERNELS, 0)
    transport_launches = 0
    runs = {}
    f32_losses = None
    wires = {w: parse(DP_ARGV + ["--grad-quant", w]) for w in DP_WIRES}
    # the three wires in one spawn, then their twins in one (a window of
    # step 1's sync traced on every ipc rank); the ef8 twin runs every
    # step, so its residual is compared too
    ipc = spawn_batch(torch, [("train", wires[w], "traced" if DIST == "ipc"
                               else None) for w in DP_WIRES])
    twins = spawn_batch(torch, [("train", parse(
        DP_ARGV + ["--grad-quant", w, "--dist-backend", TWIN, "--steps",
                   str(wires[w].steps if w == "ef8" else TWIN_STEPS)]),
        None) for w in DP_WIRES])
    for wire, (report, seconds), (twin, twin_s) in zip(DP_WIRES, ipc,
                                                       twins):
        args = wires[wire]
        cfg = report["config"]
        num_buckets = -(-cfg["params"] // cfg["bucket_elems"])
        per_sync = expected_sync_launches(
            cfg["grad_transport"], cfg["transport_schedule"],
            report["dist"]["world"], num_buckets, args.grad_windows)
        expected = {k: v * args.steps for k, v in per_sync.items()}
        flash_expected = (args.n_layers * args.steps if DEVICE == "cuda"
                          else 0)
        sums = [r["param_checksum"] for r in report["ranks"]]
        sync_ms = report["ranks"][0]["sync_ms"]
        losses = report["losses"]
        out = {
            "wire": wire, "backend": report["dist"]["backend"],
            "world": report["dist"]["world"],
            "wire_route": "ipc: device to device through CUDA IPC peer "
                          "buffers on the one card; the twin's gloo: "
                          "host memory",
            "losses": losses, "step_ms": report["step_ms"],
            "wall_ms_per_step": report["wall_ms_per_step"],
            "sync_ms": sync_ms,
            "sync_ms_per_step": (statistics.mean(sync_ms[1:] or sync_ms)
                                 if sync_ms else None),
            "tokens_per_s": report["tokens_per_s"], "mfu": report["mfu"],
            "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                        for r in report["ranks"]],
            "param_checksums": sums, "num_buckets": num_buckets,
            "sync_launches": report["sync_launches"],
            "expected_sync_launches": expected,
            "flash_launches": report["launches"],
            "sync_trace": [r.get("sync_trace") for r in report["ranks"]],
            "run_seconds": seconds, **twin_fields(report, twin, twin_s)}
        if wire == "none":
            ref = one_card_losses[:len(losses)]
            out.update(one_card_losses=ref, loss_rtol=DP_LOSS_RTOL,
                       loss_rel_diff=[abs(a - b) / abs(b)
                                      for a, b in zip(losses, ref)])
            f32_losses = losses
        else:
            out.update(loss_atol=QUANT_LOSS_ATOL, loss_diff_vs_f32=[
                abs(a - b) for a, b in zip(losses, f32_losses)])
        emit("train_dp", **out)
        check_twin(f"phase 9 {wire}", report, out, peak=True)
        if DIST == "ipc":
            check_sync_traces(f"phase 9 {wire}", report["ranks"])
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{wire}: non-finite losses {out}")
        if len(set(sums)) != 1:
            raise AssertionError(f"{wire}: ranks' parameters differ {sums}")
        if report["sync_launches"] != expected:
            raise AssertionError(f"{wire}: sync launches "
                                 f"{report['sync_launches']}, expected "
                                 f"{expected}")
        if any(n != flash_expected for n in report["launches"].values()):
            raise AssertionError(f"{wire}: flash launches "
                                 f"{report['launches']}, expected "
                                 f"{flash_expected} each")
        if wire == "none" and not (
                len(out["loss_rel_diff"]) == args.steps
                and max(out["loss_rel_diff"]) <= DP_LOSS_RTOL):
            raise AssertionError(f"dp=2 f32 losses {losses} vs one card "
                                 f"{out['one_card_losses']}")
        if wire != "none" and not max(out["loss_diff_vs_f32"]
                                      ) < QUANT_LOSS_ATOL:
            raise AssertionError(f"{wire} losses {losses} vs the f32 wire "
                                 f"{f32_losses}")
        for k, v in report["sync_launches"].items():
            totals[k] += v
        transport_launches += out["transport"]["transport_launches"]
        runs[wire] = out
    missing = [k for k in MAIN_PATH_SYNC if totals[k] == 0]
    if missing:
        raise AssertionError(f"sync kernels never launched on the main "
                             f"path: {missing}")
    return {"launches": totals, "runs": runs,
            "transport": transport_launches}


def sync4_envelope(torch, transport: str, schedule: str, contribs: list,
                   world: int):
    """Elementwise bound on |output - exact sum| for a wire: f32 sums in
    rank order (a few roundings of the absolute sum); bf16 (unit
    roundoff 2^-8) rounds each contribution, then the f32 sum once, or on
    swing each of its log2(N) bf16 hops, so (1 + hops) * 2^-8 of the
    absolute sum; int8/ef8 the JAX tests' 3 * 2/127 * N * max|x|."""
    abs_sum = sum(c.abs() for c in contribs)
    if transport == "f32":
        return 4 * 2.0 ** -23 * abs_sum
    if transport == "bf16":
        hops = world.bit_length() - 1 if schedule == "swing" else 1
        return (1 + hops) * 2.0 ** -8 * abs_sum
    return torch.full_like(abs_sum, 3 * 2 / 127 * world * max(
        float(c.abs().max()) for c in contribs))


def sync4_rank(group, cases: list, shape: tuple) -> list:
    """One rank of phase 10: every case on this rank's seeded bucket
    matrix. Every rank draws every rank's inputs (and masks), so each
    computes the exact sum itself; returns per case a digest of the
    output, its largest excess over the envelope and whether the counts
    are exact."""
    import torch

    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    rows, cols = shape
    out = []
    arange = torch.arange(rows, device=group.device)
    for n, case in enumerate(cases):
        hier = case["schedule"] == "hierarchical"
        xs = [torch.randn(shape, device=group.device,
                          generator=torch.Generator(group.device)
                          .manual_seed(1000 * n + r))
              for r in range(group.world)]
        if not case["masked"]:
            masks = [torch.ones(rows, dtype=torch.int32, device=group.device)
                     for r in range(group.world)]
        elif hier:
            # the masks of an sp line agree (the schedule's rule); the
            # last row is masked on every rank
            masks = [(((arange + r // group.sp) % 5 != 0)
                      & (arange != rows - 1)).to(torch.int32)
                     for r in range(group.world)]
        else:
            masks = [((arange + r) % 5 != 0).to(torch.int32)
                     for r in range(group.world)]
        contribs = [x.double() * m.double()[:, None]
                    for x, m in zip(xs, masks)]
        exact = sum(contribs)
        cfg = GradSyncConfig(bucket_elems=cols, average=False,
                             return_elem_counts=False,
                             transport=case["transport"],
                             transport_schedule=case["schedule"],
                             num_windows=4)
        resid = None
        if hier:
            resid = 1e-3 * torch.randn(
                shape, device=group.device, generator=torch.Generator(
                    group.device).manual_seed(5000 + 1000 * n + group.rank))
        res = allreduce_gradients(
            {"g": xs[group.rank]}, cfg, group,
            valid=masks[group.rank] if case["masked"] else None,
            quant_key=(17, n, 0), residual=resid)
        got = res.grads["g"].double()
        excess = float((
            (got - exact).abs()
            - sync4_envelope(torch, case["transport"], case["schedule"],
                             contribs, group.world)).max())
        counts_ok = bool((res.bucket_counts.long()
                          == sum(m.long() for m in masks)).all())
        row = {**case, "digest": hashlib.sha256(
            res.grads["g"].cpu().numpy().tobytes()).hexdigest()[:16],
            "max_err": float((got - exact).abs().max()),
            "excess_over_envelope": excess, "counts_exact": counts_ok}
        if hier:
            row.update(hierarchical_checks(torch, group, res, resid,
                                           masks[group.rank],
                                           sum(masks) == 0))
        out.append(row)
    return out


def hierarchical_checks(torch, group, res, resid, mask, everywhere
                        ) -> dict:
    """Phase 10's hierarchical contracts on one rank: the schedule ran,
    the residual changed only in this rank's owned columns (its sp
    shard) and there only in valid rows, a row masked on every rank sums
    to exact zeros."""
    new = res.residual
    cols = -(-new.shape[1] // group.sp)
    lo = group.axis_index("sp") * cols
    owned = torch.zeros(new.shape[1], dtype=torch.bool, device=new.device)
    owned[lo:lo + cols] = True
    keep = mask == 0
    return {
        "ran": res.schedule,
        "residual_outside_owned_unchanged": bool(torch.equal(
            new[:, ~owned], resid[:, ~owned])),
        "masked_rows_keep_residual": bool(torch.equal(new[keep],
                                                      resid[keep])),
        "owned_valid_residual_moved": bool(
            (new[~keep][:, owned] != resid[~keep][:, owned]).any()),
        "rows_masked_everywhere_zero": bool(
            (res.grads["g"][everywhere] == 0).all())}


def phase_sync4(torch) -> dict:
    """``allreduce_gradients`` at four gloo ranks on the card."""
    (ranks, _), = spawn_batch(
        torch, [("call", sync4_rank, (SYNC4_CASES, SYNC4_SHAPE))], world=4,
        backend="gloo", sp=SYNC4_SP)
    failures = []
    for n, case in enumerate(SYNC4_CASES):
        rows = [r[n] for r in ranks]
        identical = len({r["digest"] for r in rows}) == 1
        ok = identical and all(r["excess_over_envelope"] <= 0
                               and r["counts_exact"] for r in rows)
        hier = {}
        if case["schedule"] == "hierarchical":
            hier = {k: [r[k] for r in rows] for k in (
                "ran", "residual_outside_owned_unchanged",
                "masked_rows_keep_residual", "owned_valid_residual_moved",
                "rows_masked_everywhere_zero")}
            ok = ok and set(hier.pop("ran")) == {"hierarchical"} and all(
                all(v) for v in hier.values())
        emit("sync4", **case, identical_on_all_ranks=identical,
             max_err=max(r["max_err"] for r in rows),
             excess_over_envelope=max(r["excess_over_envelope"]
                                      for r in rows),
             counts_exact=all(r["counts_exact"] for r in rows), **hier,
             ok=ok)
        if not ok:
            failures.append(case)
    if failures:
        raise AssertionError(f"four-rank sync failed: {failures}")
    return {"cases": len(SYNC4_CASES)}


def ring_bounds(torch, q, k, causal, q_off, k_off, peak=None) -> dict:
    """Each ring kernel's least time for one hop: the flash kernels'
    operations over the hop's live (q, k) pairs, and its bytes: q, k, v
    (dO, lse and delta backward) read once, and its f32 state read and
    written once: the carries (m, l) and acc forward, dq or (dk, dv)
    backward. The operations at ``PEAK_FLOPS[peak]`` (default: the
    inputs' dtype)."""
    from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
        score_mask
    b, t, h, d = q.shape
    tk = k.shape[1]
    mask = score_mask(t, tk, causal, None, q_off, k_off, q.device)
    pairs = b * h * (t * tk if mask is None else int(mask.sum()))
    es = q.element_size()
    qb, kb, rows = q.numel() * es, k.numel() * es, 4 * b * h * t
    q32, k32 = 4 * q.numel(), 4 * k.numel()
    dtype = peak or str(q.dtype).split(".")[-1]
    return {"ring_fwd": bound(4 * d * pairs,
                              qb + 2 * kb + 4 * rows + 2 * q32, dtype),
            "ring_dq": bound(6 * d * pairs,
                             2 * qb + 2 * kb + 2 * rows + 2 * q32, dtype),
            "ring_dkv": bound(8 * d * pairs,
                              2 * qb + 2 * kb + 2 * rows + 4 * k32, dtype)}


def phase_ring_kernels(torch) -> dict:
    """Every listed hop in f32 and bf16 through the three ring kernels
    and their plain versions; the slice's two hops also timed. Returns
    the timed rows by (hop, dtype)."""
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    timed = {}
    for n, shape in enumerate(RING_SHAPES):
        name, b, t, h, h_kv, d, causal, q_off, k_off = shape
        hop = (q_off, k_off, causal)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_case(torch, (name, b, t, t, h, h_kv, d),
                                     dtype, seed=500 + n)
            # a carry that already holds a hop (the block against itself)
            # and nonzero f32 gradient accumulators
            m0 = torch.full((b, h, t), -1e30, device=DEVICE)
            carry = [x.contiguous() for x in rf.ring_fwd_reference(
                q, k, v, m0, torch.zeros_like(m0),
                torch.zeros((b, t, h, d), device=DEVICE), 0, 0)]
            gen = torch.Generator(DEVICE).manual_seed(600 + n)
            acc0 = [torch.randn(s_, generator=gen, device=DEVICE)
                    for s_ in (q.shape, k.shape, k.shape)]
            o, lse = fa.flash_forward_reference(q, k, v, causal, None, q_off,
                                                k_off)
            delta = fa.attention_delta(o, do)
            got = dict(zip(("m", "l", "acc"), rf.ring_fwd(
                q, k, v, *[x.clone() for x in carry], *hop)))
            got["dq"] = rf.ring_dq(q, k, v, do, lse, delta, acc0[0].clone(),
                                   *hop)
            got["dk"], got["dv"] = rf.ring_dkv(q, k, v, do, lse, delta,
                                               acc0[1].clone(),
                                               acc0[2].clone(), *hop)
            want = dict(zip(("m", "l", "acc"),
                            rf.ring_fwd_reference(q, k, v, *carry, *hop)))
            parts = rf.ring_bwd_reference(q, k, v, do, lse, delta, *hop)
            for key, a0, part in zip(("dq", "dk", "dv"), acc0, parts):
                want[key] = a0 + part
            # the unnormalised acc (~l |v|) is held as the output it
            # stands for, acc / l, as phase 5 holds o
            for x in (got, want):
                x["acc"] = x["acc"] / x["l"].transpose(1, 2)[..., None]
            torch.cuda.synchronize()
            tol_fwd, tol_bwd = FLASH_TOL[str(dtype)]
            errs, ok = {}, True
            for key, g in got.items():
                tol = tol_fwd if key in ("m", "l", "acc") else tol_bwd
                errs[key] = float((g - want[key]).abs().max())
                ok = ok and bool(torch.isfinite(g).all()) and \
                    torch.allclose(g, want[key], atol=tol, rtol=tol)
            row = {"shape": name, "dtype": str(dtype), "q_off": q_off,
                   "k_off": k_off, "max_abs_err": errs, "ok": ok}
            del got, want, parts
            if name.startswith("slice"):
                st = [x.clone() for x in carry]
                acc = [x.clone() for x in acc0]
                bounds = ring_bounds(torch, q, k, causal, q_off, k_off)
                diagonal = q_off == k_off
                lib_bwd = library_backward(torch, q, k, v, do, diagonal)
                row["ms"] = {
                    "ring_fwd": time_ms(torch, lambda: rf.ring_fwd(
                        q, k, v, *st, *hop), flush),
                    "ring_dq": time_ms(torch, lambda: rf.ring_dq(
                        q, k, v, do, lse, delta, acc[0], *hop), flush),
                    "ring_dkv": time_ms(torch, lambda: rf.ring_dkv(
                        q, k, v, do, lse, delta, acc[1], acc[2], *hop),
                        flush)}
                row["plain_ms"] = {
                    "forward": time_ms(torch, lambda: rf.ring_fwd_reference(
                        q, k, v, *carry, *hop), flush),
                    "backward": time_ms(torch, lambda: rf.ring_bwd_reference(
                        q, k, v, do, lse, delta, *hop), flush)}
                row["library_ms"] = {
                    "forward": time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=diagonal,
                            enable_gqa=True), flush),
                    "backward": time_ms(torch, lib_bwd, flush)}
                row["library_call"] = (
                    "scaled_dot_product_attention(is_causal="
                    f"{diagonal}, enable_gqa=True): no carry merged, "
                    "gradients in the inputs' dtype")
                row["bound_ms"] = {k_: b_[0] for k_, b_ in bounds.items()}
                row["bound_by"] = {k_: b_[1] for k_, b_ in bounds.items()}
                if dtype == torch.float32:
                    # every f32 kernel runs three TF32 products a product
                    # (bound_ms above: the CUDA cores' 67 TFLOP/s)
                    split = ring_bounds(torch, q, k, causal, q_off, k_off,
                                        "tf32x3")
                    row["bound_tf32x3_ms"] = {
                        k_: b_[0] for k_, b_ in split.items()}
                del lib_bwd, st, acc
                timed[name, str(dtype)] = row
            emit("ring_kernels", **row)
            del q, k, v, do, o, lse, delta, carry, acc0
            torch.cuda.empty_cache()
            if not ok:
                raise AssertionError(f"a ring kernel disagrees with its "
                                     f"plain version: {row}")
    return timed


def ring4_rank(group, shape: tuple, window: int) -> list:
    """One rank of phase 12: per dtype, this rank's errors of the ring
    flash path (against the one-rank flash on the gathered sequence and
    the plain ring), of the windowed-SP flash path (against the one-rank
    windowed flash) and the ring kernels' launches in the ring call."""
    import torch

    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    from akka_allreduce_tpu_torch.parallel import ring_attention as ra
    b, t, h, h_kv, d = shape
    n, j = group.axis_size("sp"), group.axis_index("sp")
    mine = slice(j * t, (j + 1) * t)

    def vjp(fn, xs, do):
        leaves = [x.detach().clone().requires_grad_() for x in xs]
        o = fn(*leaves)
        return [o.detach()] + list(torch.autograd.grad(o, leaves, do))

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(group.device).manual_seed(700)
        full = [torch.randn(s_, generator=gen, device=group.device).to(dtype)
                for s_ in ((b, n * t, h, d), (b, n * t, h_kv, d),
                           (b, n * t, h_kv, d), (b, n * t, h, d))]
        local = [x[:, mine].contiguous() for x in full]
        rf.reset_counts()
        ring = vjp(lambda q, k, v: rf.ring_flash_attention(q, k, v, group),
                   local[:3], local[3])
        counts = rf.counts()
        refs = {
            "flash_one_rank": [x[:, mine] for x in vjp(
                fa.flash_causal_attention, full[:3], full[3])],
            "plain_ring": vjp(lambda q, k, v: ra.ring_attention(
                q, k, v, group), local[:3], local[3])}
        win = vjp(lambda q, k, v: ra.flash_windowed_sp_attention(
            q, k, v, window, group), local[:3], local[3])
        win_ref = [x[:, mine] for x in vjp(
            lambda q, k, v: fa.flash_causal_attention(q, k, v, window),
            full[:3], full[3])]
        tol_fwd, tol_bwd = FLASH_TOL[str(dtype)]

        def compare(got, want):
            errs, ok = [], True
            for i, (g, w) in enumerate(zip(got, want)):
                tol = tol_fwd if i == 0 else tol_bwd
                errs.append(float((g.float() - w.float()).abs().max()))
                ok = ok and g.dtype == dtype and bool(
                    torch.isfinite(g).all()) and torch.allclose(
                    g.float(), w.float(), atol=tol, rtol=tol)
            return {"max_abs_err_o_dq_dk_dv": errs, "ok": ok}
        out.append({"dtype": str(dtype), "rank": group.rank,
                    "launches": counts,
                    **{f"ring_vs_{k_}": compare(ring, r)
                       for k_, r in refs.items()},
                    "windowed_vs_flash_one_rank": compare(win, win_ref)})
    return out


def phase_ring4(torch) -> dict:
    """The ring at four gloo ranks on the card."""
    (ranks, _), = spawn_batch(
        torch, [("call", ring4_rank, (RING4_SHAPE, RING4_WINDOW))], world=4,
        backend="gloo", sp=4)
    failures = []
    for rank, rows in enumerate(ranks):
        for row in rows:
            want = dict.fromkeys(("ring_fwd", "ring_dq", "ring_dkv"),
                                 rank + 1)
            ok = row["launches"] == want and all(
                v["ok"] for v in row.values()
                if isinstance(v, dict) and "ok" in v)
            emit("ring4", shape=list(RING4_SHAPE), window=RING4_WINDOW,
                 expected_launches=want, **row, ok=ok)
            if not ok:
                failures.append((rank, row["dtype"]))
    if failures:
        raise AssertionError(f"four-rank ring failed: {failures}")
    return {"ranks": 4}


def phase_train_sp(torch) -> dict:
    """``run_train`` on one card and then at ``--sp 2`` (the main path of
    the ring kernels), in bf16 and in the CLI's default f32 (``SP_RUNS``).
    Returns, per dtype, the ring kernels' launches summed over the ranks
    (``"ring"``) and the one-card run's flash launches (``"flash"``)."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    dist = {dtype: argv + ["--sp", str(SP_WORLD), "--dist-backend", DIST]
            for dtype, argv in SP_RUNS.items()}
    # the sp=2 runs of every dtype in one spawn of the ranks
    runs = spawn_batch(torch, [("train", parse(dist[d]), None)
                               for d in SP_RUNS], sp=SP_WORLD)
    return {dtype: train_sp(torch, argv, dtype, dist[dtype], *run)
            for (dtype, argv), run in zip(SP_RUNS.items(), runs)}


def train_sp(torch, argv: list, dtype: str, dist_argv: list, report: dict,
             seconds: float) -> dict:
    """One ``SP_RUNS`` entry: the one-card run, checks against the ``--sp
    2`` run on the ipc transport (``report``, from :func:`spawn_batch`;
    its counters are the run's own) and its gloo twin."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    one_args = parse(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one = cli.run_train(one_args)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    args = parse(dist_argv)
    twin = (run_twin(torch, dist_argv, min(TWIN_STEPS, args.steps))
            if dtype in SP_TWINS else None)
    losses, ref = report["losses"], one["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    ranks = report["ranks"]
    layers, steps = args.n_layers, args.steps
    expected = [{"ring": dict.fromkeys(("ring_fwd", "ring_dq", "ring_dkv"),
                                       layers * (r + 1) * steps),
                 "flash": dict.fromkeys(("flash_fwd", "flash_dq",
                                         "flash_dkv"), 0),
                 "masked_reduce": steps} for r in range(SP_WORLD)]
    got = [{"ring": r["ring_launches"], "flash": r["launches"],
            "masked_reduce": r["sync_launches"]["masked_reduce"]}
           for r in ranks]
    others = [k_ for r in ranks for k_, v in r["sync_launches"].items()
              if k_ != "masked_reduce" and v]
    sums = [r["param_checksum"] for r in ranks]
    out = {
        "dtype": dtype, "batch": args.batch, "steps": steps,
        "sp": SP_WORLD, "backend": report["dist"]["backend"],
        "world": report["dist"]["world"],
        "losses": losses, "one_card_losses": ref, "loss_rtol": SP_LOSS_RTOL,
        "loss_rel_diff": rel, "step_ms": report["step_ms"],
        "wall_ms_per_step": report["wall_ms_per_step"],
        "one_card_wall_ms_per_step": one["wall_ms_per_step"],
        "sync_ms_per_step": [steady(r["sync_ms"]) for r in ranks],
        "attn_exchange_ms_per_step": [steady(r["attn_exchange_ms"])
                                      for r in ranks],
        "attn_exchange_ms": [r["attn_exchange_ms"] for r in ranks],
        "tokens_per_s": report["tokens_per_s"], "mfu": report["mfu"],
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
        "one_card_peak_memory_gb": one_peak,
        "param_checksums": sums, "launches_per_rank": got,
        "expected_launches_per_rank": expected,
        "one_card_flash_launches": one["launches"], "run_seconds": seconds,
        "transport": ranks[0]["transport"],
        "transport_buffer_gb_per_rank": [r["transport_buffer_gb"]
                                         for r in ranks]}
    if twin is not None:
        out.update(twin_fields(report, *twin))
    emit("train_sp", **out)
    if twin is not None:
        check_twin(f"phase 13 {dtype}", report, out)
    elif report["dist"]["backend"] != DIST:
        raise AssertionError(f"phase 13 {dtype} ran on "
                             f"{report['dist']['backend']}")
    if not all(math.isfinite(x) for x in losses + ref):
        raise AssertionError(f"non-finite losses {losses} / {ref}")
    if len(rel) != steps or max(rel) > SP_LOSS_RTOL:
        raise AssertionError(f"sp=2 losses {losses} vs one card {ref}")
    if len(set(sums)) != 1:
        raise AssertionError(f"sp ranks' parameters differ {sums}")
    if got != expected or others:
        raise AssertionError(f"launches {got} (other sync kernels "
                             f"{others}), expected {expected}")
    if any(n != layers * one_args.steps for n in one["launches"].values()):
        raise AssertionError(f"one-card flash launches {one['launches']}, "
                             f"expected n_layers x steps each")
    return {"ring": {k_: sum(r["ring_launches"][k_] for r in ranks)
                     for k_ in RING_REPLACES},
            "flash": one["launches"],
            "transport": out["transport"]["transport_launches"]}


def phase_train_defaults(torch) -> dict:
    """Phase 15: each ``DEFAULTS_RUNS`` command on the card, then on the
    CPU from the card run's weights. Returns, per run, its flash and ring
    kernels' launches summed over its ranks."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.train import tree_map
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    parse = cli.build_parser().parse_args
    out = {}
    for name, argv in DEFAULTS_RUNS.items():
        args = parse(argv)
        torch.cuda.empty_cache()
        card = cli.run_train(args)
        torch.cuda.synchronize()
        if card["device"]["type"] != DEVICE:
            raise AssertionError(f"{name} ran on {card['device']}")
        # the weights the card run drew: seed 0 on the card's generator
        model = cli.train_config(args, cli._check_train_flags(args)[1]).model
        params = init_transformer(torch.Generator(DEVICE).manual_seed(0),
                                  model, DEVICE)
        cpu = cli.run_train(parse(argv + ["--device", "cpu"]), params=tree_map(
            lambda p: p.detach().cpu(), params))
        n = DEFAULTS_COMPARED_STEPS
        rel = [abs(a - b) / abs(b)
               for a, b in zip(card["losses"][:n], cpu["losses"][:n])]
        layers, steps = args.n_layers, args.steps
        ranks = card.get("ranks") or [card]
        got = [{"flash": r["launches"], "ring": r["ring_launches"]}
               for r in ranks]
        expected = [{"flash": dict.fromkeys(
            FLASH_REPLACES, layers * steps if args.sp == 1 else 0),
            "ring": dict.fromkeys(
                RING_REPLACES, layers * (r + 1) * steps if args.sp > 1
                else 0)} for r in range(len(ranks))]
        row = {"run": name, "argv": argv, "config": card["config"],
               "head_dim": model.head_dim,
               "device": card["device"], "losses": card["losses"],
               "cpu_losses": cpu["losses"], "loss_rel_diff": rel,
               "loss_rtol": DEFAULTS_LOSS_RTOL,
               "wall_ms_per_step": card["wall_ms_per_step"],
               "launches_per_rank": got,
               "expected_launches_per_rank": expected}
        emit("train_defaults", **row)
        if not all(math.isfinite(x) for x in card["losses"] + cpu["losses"]):
            raise AssertionError(f"{name}: non-finite losses {row}")
        if len(rel) != n or max(rel) > DEFAULTS_LOSS_RTOL:
            raise AssertionError(f"{name}: card losses {card['losses'][:n]} "
                                 f"vs CPU {cpu['losses'][:n]}")
        if got != expected:
            raise AssertionError(f"{name}: launches {got}, expected "
                                 f"{expected}")
        out[name] = {"flash": {k: sum(g["flash"][k] for g in got)
                               for k in FLASH_REPLACES},
                     "ring": {k: sum(g["ring"][k] for g in got)
                              for k in RING_REPLACES}}
    return out


def straggle_draws(steps: int, ranks: int, batch: int, seq: int,
                   vocab: int):
    """The straggle draws of ``train --deadline-ms`` on synthetic data:
    step i's ``default_rng(i)`` draws the (batch, seq) global batch, then
    one ``random()`` per data rank in rank order. Returns (steps, ranks)
    float64; a rank is late when its draw is below --straggle-prob."""
    import numpy as np
    out = np.empty((steps, ranks))
    for i in range(steps):
        rng = np.random.default_rng(i)
        rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
        out[i] = [rng.random() for _ in range(ranks)]
    return out


def predicted_rounds(draws, prob: float) -> list:
    """Per step, what the deadline trainer must report for these draws:
    the ranks the clock saw late, whether the round fell back to an exact
    one (every rank late) and its ``min_bucket_count`` (the ranks that
    contributed; all of them after a fallback)."""
    out = []
    for row in draws:
        late = int(sum(d < prob for d in row))
        fell = late == len(row)
        out.append({"n_masked": late, "fell_back": fell,
                    "min_bucket_count": len(row) if fell
                    else len(row) - late})
    return out


def choose_straggle(draws) -> "tuple[float, int]":
    """The fewest steps, and a --straggle-prob for them, whose rounds
    have a clean step 1, a step that masks exactly one rank and a step
    that masks every rank (the fallback): the first gap between the
    sorted draws of those steps that gives all three, at its midpoint."""
    for steps in range(3, len(draws) + 1):
        edges = sorted(set(float(d) for d in draws[:steps].ravel()))
        for lo, hi in zip(edges, edges[1:]):
            prob = (lo + hi) / 2
            rounds = predicted_rounds(draws[:steps], prob)
            if rounds[0]["n_masked"] == 0 \
                    and any(r["n_masked"] == 1 for r in rounds) \
                    and any(r["fell_back"] for r in rounds):
                return prob, steps
    raise ValueError("no --straggle-prob gives a clean step 1, a one-rank "
                     "step and a fallback step within these draws")


def expected_deadline_launches(transport: str, world: int, num_buckets: int,
                               steps: int, n_layers: int
                               ) -> "tuple[dict, int]":
    """Rank 0's launches in a deadline run: a masked round's sync
    launches what an exact one does (``expected_sync_launches``), once a
    step, and each flash kernel runs once per layer a step."""
    per_sync = expected_sync_launches(transport, "fused", world, num_buckets)
    return {k: v * steps for k, v in per_sync.items()}, n_layers * steps


def masked_sync_rank(group, rows: int, cols: int) -> dict:
    """One rank of phase 16's direct masked sync: ``allreduce_gradients``
    on a (rows, cols) f32 gradient (rank r's from a generator seeded 1000
    + r), rank 1's whole row masked. f32: every rank must get exactly 2 x
    rank 0's gradient (rank 1 adds exact zeros, the count 1 rescales by
    2 / 1), counts all 1. ef8 (from a random residual): rank 1's residual
    must come back bitwise unchanged, rank 0's must not."""
    import torch
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    dev = group.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def normal(seed, scale=1.0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((rows, cols), generator=gen, device=dev) * scale

    valid = torch.full((rows,), 1.0 if group.rank == 0 else 0.0,
                       device=dev)
    grads = {"g": normal(1000 + group.rank)}
    out = {"rank": group.rank}
    t0 = time.perf_counter()
    res = allreduce_gradients(grads, GradSyncConfig(
        bucket_elems=cols, rescale_target=2.0, return_elem_counts=False),
        group, valid=valid)
    sync()
    out["f32_seconds"] = time.perf_counter() - t0  # host wire included
    out["f32_exact"] = bool(torch.equal(res.grads["g"], 2 * normal(1000)))
    out["f32_counts"] = sorted(set(res.bucket_counts.tolist()))
    del res
    residual = normal(2000 + group.rank, 1e-3)
    before = residual.clone()
    t0 = time.perf_counter()
    res = allreduce_gradients(grads, GradSyncConfig(
        bucket_elems=cols, rescale_target=2.0, return_elem_counts=False,
        transport="ef8"), group, valid=valid, quant_key=(17, 0, 0),
        residual=residual)
    sync()
    out["ef8_seconds"] = time.perf_counter() - t0
    out["ef8_residual_unchanged"] = bool(torch.equal(res.residual, before))
    out["ef8_counts"] = sorted(set(res.bucket_counts.tolist()))
    out["ef8_finite"] = bool(torch.isfinite(res.grads["g"]).all())
    return out


def phase_train_deadline(torch, dp_runs: dict) -> dict:
    """Phase 16: ``run_train`` at phase 9's flagship dp=2 configuration
    on the ipc transport under ``--deadline-ms`` for each of
    ``DEADLINE_RUNS``, then one direct masked sync at the flagship's
    gradient size, all in one spawn of the ranks (each run's counts its
    own), and the runs of ``DEADLINE_TWINS`` with their gloo twins.
    Returns rank 0's
    sync, flash and transport launches summed over the runs."""
    from akka_allreduce_tpu_torch import cli
    base = cli.build_parser().parse_args(DP_ARGV)
    draws = straggle_draws(DEADLINE_MAX_STEPS, DP_WORLD, base.batch,
                           base.seq, base.vocab)
    # at the flagship's batches (8 x 2048 of vocab 32768) the draws of
    # steps 1-6 are (0.361, 0.720), (0.064, 0.951), (0.915, 0.384),
    # (0.218, 0.325), (0.575, 0.483), (0.426, 0.267): this picks 4 steps
    # and --straggle-prob 0.3428 (between 0.3247 and 0.3608), so step 1
    # is clean, step 2 masks rank 0, step 3 is clean and step 4 masks
    # both ranks and falls back to an exact round
    prob, steps = choose_straggle(draws)
    want = predicted_rounds(draws[:steps], prob)
    totals = {"sync": dict.fromkeys(SYNC_KERNELS, 0),
              "flash": dict.fromkeys(FLASH_REPLACES, 0), "transport": 0}
    runs = {}
    argvs = [DP_ARGV + [
        "--grad-quant", wire, "--steps", str(steps), "--deadline-ms",
        str(DEADLINE_MS), "--straggle-prob", repr(prob), "--max-lag",
        str(lag)] for wire, lag in DEADLINE_RUNS]
    rows, cols = DEADLINE_SYNC_SHAPE
    # every run and the direct masked sync in one spawn of the ranks
    batch = spawn_batch(torch, [("train", cli.build_parser().parse_args(a),
                                 None) for a in argvs]
                        + [("call", masked_sync_rank, (rows, cols))])
    for (wire, lag), argv, (report, seconds) in zip(DEADLINE_RUNS, argvs,
                                                     batch):
        args = cli.build_parser().parse_args(argv)
        twin = None
        if (wire, lag) in DEADLINE_TWINS:
            twin = run_twin(torch, argv,
                            DEADLINE_TWINS[wire, lag] or steps)
        cfg = report["config"]
        num_buckets = -(-cfg["params"] // cfg["bucket_elems"])
        sync_expected, flash_expected = expected_deadline_launches(
            cfg["grad_transport"], report["dist"]["world"], num_buckets,
            steps, args.n_layers)
        rounds = [{k: r[k] for k in ("n_masked", "fell_back",
                                     "min_bucket_count")}
                  for r in report["deadline"]["rounds"]]
        sums = [r["param_checksum"] for r in report["ranks"]]
        sync_ms = report["ranks"][0]["sync_ms"]
        ref = dp_runs[wire]
        out = {
            "wire": wire, "max_lag": lag, "steps": steps,
            "straggle_prob": prob, "deadline_ms": DEADLINE_MS,
            "rounds": rounds, "predicted_rounds": want,
            "masked_round_count": report["deadline"]["masked_round_count"],
            "losses": report["losses"], "step_ms": report["step_ms"],
            "wall_ms_per_step": report["wall_ms_per_step"],
            "sync_ms": sync_ms,
            "sync_ms_per_step": statistics.mean(sync_ms[1:] or sync_ms),
            "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                        for r in report["ranks"]],
            "phase9": {k: ref[k] for k in (
                "wall_ms_per_step", "sync_ms_per_step",
                "peak_memory_gb_per_rank")},
            "param_checksums": sums, "sync_launches": report["sync_launches"],
            "expected_sync_launches": sync_expected,
            "flash_launches": report["launches"],
            "expected_flash_launches": flash_expected,
            "run_seconds": seconds,
            "transport": report["ranks"][0]["transport"]}
        if twin is not None:
            out.update(twin_fields(report, *twin))
        if wire == "none":
            # after the clean step 1 both runs hold the same weights: a
            # mask of ones multiplies by 1.0 and rescales by 2 / 2, so the
            # masked route sums what the exact one does, in its order
            out["phase9_losses"] = ref["losses"]
        emit("train_deadline", **out)
        if twin is not None:
            check_twin(f"phase 16 {wire} lag {lag}", report, out)
        if rounds != want:
            raise AssertionError(f"{wire} lag {lag}: rounds {rounds}, the "
                                 f"draws predict {want}")
        if not all(math.isfinite(x) for x in report["losses"]):
            raise AssertionError(f"{wire}: non-finite losses {out}")
        if len(set(sums)) != 1:
            raise AssertionError(f"{wire}: ranks' parameters differ {sums}")
        if report["sync_launches"] != sync_expected:
            raise AssertionError(f"{wire}: sync launches "
                                 f"{report['sync_launches']}, expected "
                                 f"{sync_expected}")
        if any(n != flash_expected for n in report["launches"].values()):
            raise AssertionError(f"{wire}: flash launches "
                                 f"{report['launches']}, expected "
                                 f"{flash_expected} each")
        if wire == "none" and report["losses"][:2] != ref["losses"][:2]:
            raise AssertionError(f"f32 lag {lag}: losses {report['losses']} "
                                 f"vs phase 9's {ref['losses']} (steps 1-2 "
                                 f"must be bitwise equal)")
        for k, v in report["sync_launches"].items():
            totals["sync"][k] += v
        for k, v in report["launches"].items():
            totals["flash"][k] += v
        totals["transport"] += out["transport"]["transport_launches"]
        runs[wire, lag] = out
    lag1, lag0 = runs["none", 1], runs["none", 0]
    emit("train_deadline_max_lag", wire="none",
         wall_ms_per_step={"max_lag_1": lag1["wall_ms_per_step"],
                           "max_lag_0": lag0["wall_ms_per_step"]},
         step_ms={"max_lag_1": lag1["step_ms"],
                  "max_lag_0": lag0["step_ms"]},
         note="on ipc the host enqueues a round's sync without waiting "
              "for it, so the window can overlap the host's dispatch of "
              "the next round with the device's sync")
    sync = batch[-1][0]
    emit("masked_sync", rows=rows, cols=cols, ranks=sync)
    bad = [r for r in sync if not (
        r["f32_exact"] and r["f32_counts"] == [1] and r["ef8_counts"] == [1]
        and r["ef8_finite"]
        and r["ef8_residual_unchanged"] == (r["rank"] == 1))]
    if bad:
        raise AssertionError(f"masked sync: {bad}")
    return totals


def expected_attention_launches(n_layers: int, sp: int, rank: int,
                                steps: int) -> dict:
    """A rank's flash and ring kernel launches in a training run: on one
    card each flash kernel once a layer a step; at sp > 1 rank (i, j)
    each ring kernel j + 1 times a layer a step, the flash kernels
    never."""
    ring = 0 if sp == 1 else n_layers * (rank % sp + 1) * steps
    return {"ring": dict.fromkeys(RING_REPLACES, ring),
            "flash": dict.fromkeys(FLASH_REPLACES,
                                   n_layers * steps if sp == 1 else 0)}


def choose_line_drop(draws, line: int) -> "tuple[float, int]":
    """A --straggle-prob whose first round drops exactly one line of
    ``line`` consecutive data ranks: the midpoint between the two
    smallest of the lines' least step-1 draws. Returns it and the line
    it drops."""
    row = [float(d) for d in draws[0]]
    mins = [min(row[i:i + line]) for i in range(0, len(row), line)]
    order = sorted(range(len(mins)), key=mins.__getitem__)
    lo, hi = mins[order[0]], mins[order[1]]
    if not lo < hi:
        raise ValueError(f"step 1's lines draw the same least value {lo}")
    return (lo + hi) / 2, order[0]


def dropped_line_args():
    """The second fault control of ``HIER_LOSS_ATOL``: ``HIER_DIST`` for 2
    steps under ``--deadline-ms`` with a straggle draw that makes one dp
    line late at step 1, so its sp line is masked out of the round (the
    other line's 4 sequences alone). Returns its args, the draw's
    probability and the dropped line."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    args = parse(HIER_ARGV + HIER_DIST + ["--steps", "2"])
    draws = straggle_draws(1, args.dp * args.sp, args.batch, args.seq,
                           args.vocab)
    prob, line = choose_line_drop(draws, args.sp)
    return parse(HIER_ARGV + HIER_DIST + [
        "--steps", "2", "--deadline-ms", str(DEADLINE_MS),
        "--straggle-prob", repr(prob)]), prob, line


def hierarchical_controls(torch, one_losses: list, dropped: dict,
                          prob: float, line: int) -> dict:
    """The two faults that ``HIER_LOSS_ATOL`` must tell from a sound
    sync, each read as its step-2 loss gap to the one-card run: no
    update at step 1 (one card at ``--lr 0``), and one dp line's
    gradient dropped at step 1 (``dropped``, the report of
    :func:`dropped_line_args`' run)."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    two = ["--steps", "2"]
    torch.cuda.empty_cache()
    frozen = cli.run_train(parse(HIER_ARGV + two + ["--lr", "0"]))
    args = parse(HIER_ARGV + HIER_DIST + two)
    world = args.dp * args.sp
    round1 = dropped["deadline"]["rounds"][0]
    out = {
        "frozen_step1": {"argv_extra": two + ["--lr", "0"],
                         "losses": frozen["losses"],
                         "step2_gap": abs(frozen["losses"][1]
                                          - one_losses[1])},
        "dropped_line": {"straggle_prob": prob, "line": line,
                         "round1": round1, "losses": dropped["losses"],
                         "step2_gap": abs(dropped["losses"][1]
                                          - one_losses[1])}}
    if round1["n_dropped"] != args.sp or round1["fell_back"] \
            or round1["min_bucket_count"] != world - args.sp:
        raise AssertionError(f"the control's step 1 dropped {round1}, "
                             f"not dp line {line}'s {args.sp} ranks")
    return out


def phase_hierarchical(torch) -> dict:
    """Phase 17, the full-width run: ``HIER_ARGV`` on one card, then at
    ``HIER_DIST`` (four ipc ranks on the card, in one spawn with the
    dropped-line control; each run's counts its own) and its gloo twin
    (every step, so the ef8
    residuals are compared), then the two fault controls of the loss
    bound. Returns the emitted row, rank 0's sync and transport launches
    and the ring kernels' launches summed over the ranks."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    torch.cuda.empty_cache()
    one = cli.run_train(parse(HIER_ARGV))
    torch.cuda.empty_cache()
    args = parse(HIER_ARGV + HIER_DIST)
    # the run and the dropped-line control in one spawn of the ranks
    control_args, prob, line = dropped_line_args()
    (report, seconds), (dropped, dropped_s) = spawn_batch(
        torch, [("train", args, None), ("train", control_args, None)],
        sp=args.sp)
    twin = run_twin(torch, HIER_ARGV + HIER_DIST, args.steps)
    cfg, ranks = report["config"], report["ranks"]
    num_buckets = -(-cfg["params"] // cfg["bucket_elems"])
    per_sync = expected_sync_launches("ef8", "hierarchical",
                                      report["dist"]["world"], num_buckets)
    layers, steps = args.n_layers, args.steps
    expected = {k: v * steps for k, v in per_sync.items()}
    expected_attn = [expected_attention_launches(layers, args.sp, r["rank"],
                                                 steps) for r in ranks]
    got_attn = [{"ring": r["ring_launches"], "flash": r["launches"]}
                for r in ranks + [one]]
    expected_attn.append(expected_attention_launches(layers, 1, 0, steps))
    losses, ref = report["losses"], one["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    later_gap = max(abs(a - b) for a, b in zip(losses[1:], ref[1:]))
    sums = [r["param_checksum"] for r in ranks]
    # rank (i, j) updates only its sp shard j of the residual
    owned = [[(m > 0) == (j == r["rank"] % args.sp)
              for j, m in enumerate(r["residual_abs_max_by_sp_shard"])]
             for r in ranks]
    sync_ms = ranks[0]["sync_ms"]
    peaks = [r["peak_memory_gb"] for r in ranks]
    t1 = time.perf_counter()
    controls = hierarchical_controls(torch, ref, dropped, prob, line)
    row = {
        "argv": HIER_ARGV + HIER_DIST, "params": cfg["params"],
        "n_layers": cfg["n_layers"], "num_buckets": num_buckets,
        "residual_shapes": [r["residual_shape"] for r in ranks],
        "losses": losses, "one_card_losses": ref, "loss_rel_diff": rel,
        "step1_rtol": SP_LOSS_RTOL, "later_gap": later_gap,
        "later_atol": HIER_LOSS_ATOL, "controls": controls,
        "param_checksums": sums,
        "residual_abs_max_by_sp_shard": [
            r["residual_abs_max_by_sp_shard"] for r in ranks],
        "sync_launches": ranks[0]["sync_launches"],
        "expected_sync_launches": expected,
        "attn_launches_per_rank_then_one_card": got_attn,
        "expected_attn_launches": expected_attn,
        "step_ms": report["step_ms"],
        "wall_ms_per_step": report["wall_ms_per_step"],
        "one_card_wall_ms_per_step": one["wall_ms_per_step"],
        "sync_ms": sync_ms,
        "sync_ms_per_step": statistics.mean(sync_ms[1:] or sync_ms),
        "attn_exchange_ms_per_step": statistics.mean(
            ranks[0]["attn_exchange_ms"][1:]
            or ranks[0]["attn_exchange_ms"]),
        "peak_memory_gb_per_rank": peaks,
        "peak_memory_gb_sum": sum(peaks) if all(peaks) else None,
        "run_seconds": seconds,
        "controls_seconds": time.perf_counter() - t1 + dropped_s,
        **twin_fields(report, *twin)}
    emit("hierarchical_train", **row)
    check_twin("phase 17 hierarchical", report, row, peak=True)
    if not all(math.isfinite(x) for x in losses + ref):
        raise AssertionError(f"non-finite losses {losses} / {ref}")
    if [r["residual_shape"] for r in ranks] != [
            [num_buckets, cfg["bucket_elems"]]] * len(ranks):
        raise AssertionError(f"bucket matrix {row['residual_shapes']}, "
                             f"expected {num_buckets} x "
                             f"{cfg['bucket_elems']}")
    if len(rel) != steps or rel[0] > SP_LOSS_RTOL \
            or later_gap >= HIER_LOSS_ATOL:
        raise AssertionError(f"losses {losses} vs one card {ref}")
    faint = {k: c["step2_gap"] for k, c in controls.items()
             if not c["step2_gap"] > HIER_LOSS_ATOL}
    if faint:
        raise AssertionError(f"fault controls within {HIER_LOSS_ATOL} of "
                             f"one card: {faint}")
    if len(set(sums)) != 1:
        raise AssertionError(f"ranks' parameters differ {sums}")
    if not all(all(o) for o in owned):
        raise AssertionError(f"residuals outside the owned shard: "
                             f"{row['residual_abs_max_by_sp_shard']}")
    if ranks[0]["sync_launches"] != expected:
        raise AssertionError(f"sync launches {ranks[0]['sync_launches']}, "
                             f"expected {expected}")
    if got_attn != expected_attn:
        raise AssertionError(f"attention launches (the ranks, then one "
                             f"card) {got_attn}, expected {expected_attn}")
    return {"row": row, "launches": ranks[0]["sync_launches"],
            "ring": {k: sum(r["ring_launches"][k] for r in ranks)
                     for k in RING_REPLACES},
            "transport": row["transport"]["transport_launches"]}


def file_bytes(group, path: str) -> bytes:
    """A file's bytes, read on a rank (a :func:`spawn_batch` call job)."""
    with open(path, "rb") as f:
        return f.read()


def phase_auto(torch, plan_dir: str) -> dict:
    """Phase 17, the autotuner at the CLI's defaults: the f32 dp=2 plan
    measured into ``plan_dir`` and reloaded with its sidecar's bytes
    unchanged, then the ef8 dp 2 x sp 2 plan, whose only arm and winner
    is hierarchical; every entry's note empty."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.autotune import (PLAN_SIDECAR,
                                                       CollectivePlan,
                                                       plan_markdown_table)
    parse = cli.build_parser().parse_args
    sidecar = os.path.join(plan_dir, PLAN_SIDECAR + ".json")
    f32 = parse(AUTO_ARGV + AUTO_F32 + ["--plan-dir", plan_dir])
    # the measuring run and the reloading one in one spawn of the ranks,
    # the sidecar's bytes read after each
    batch = spawn_batch(torch, [("train", f32, None),
                                ("call", file_bytes, (sidecar,)),
                                ("train", f32, None),
                                ("call", file_bytes, (sidecar,))])
    runs = [batch[0][0], batch[2][0]]
    sidecars = [batch[1][0][0], batch[3][0][0]]
    ef8 = parse(AUTO_ARGV + AUTO_EF8)
    runs.append(spawn_batch(torch, [("train", ef8, None)], sp=ef8.sp)[0][0])
    failures = []
    for n, report in enumerate(runs):
        info = report["collective_plan"]
        plan = CollectivePlan.from_json(info["plan"])
        notes = [e.note for e in plan.entries.values()]
        winners = {k: e.schedule for k, e in plan.entries.items()}
        arms = sorted({a for e in plan.entries.values()
                       for a in e.timings_us})
        emit("auto_plan", run=n,
             argv=AUTO_ARGV + (AUTO_F32 if n < 2 else AUTO_EF8),
             hash=info["hash"], reused=info["reused"],
             seconds=info["seconds"], winners=winners, arms=arms,
             notes=notes, losses=report["losses"],
             wall_ms_per_step=report["wall_ms_per_step"])
        print(plan_markdown_table(plan), flush=True)
        if any(notes):
            failures.append(f"run {n}: notes {notes}")
        if not all(math.isfinite(x) for x in report["losses"]):
            failures.append(f"run {n}: losses {report['losses']}")
        if n == 0 and (info["reused"] or arms != ["fused", "swing",
                                                  "windowed:4"]):
            failures.append(f"run 0: reused {info['reused']}, arms {arms}")
        if n == 1 and not (info["reused"] and info["hash"]
                           == runs[0]["collective_plan"]["hash"]
                           and sidecars[0] == sidecars[1]):
            failures.append("run 1 did not reload the plan byte for byte")
        if n == 2 and not (arms == ["hierarchical"]
                           and set(winners.values()) == {"hierarchical"}):
            failures.append(f"run 2: arms {arms}, winners {winners}")
    if failures:
        raise AssertionError(f"auto plans: {failures}")
    return {"hashes": [r["collective_plan"]["hash"] for r in runs]}


def phase_bench_rows(torch) -> dict:
    """Phase 17, the bench rows at ``BENCH_RANKS`` ranks on the card: one
    JSON line per row of ``measure_device_goodput`` and
    ``measure_quantized_collectives`` (the JAX payloads, at least
    ``BENCH_R_HI`` / ``BENCH_R_LO`` rounds, sized up to ``BENCH_SET_S``
    seconds a set, ``BENCH_REPS`` reps)."""
    from akka_allreduce_tpu_torch import bench
    torch.cuda.empty_cache()
    sizing = {"r_hi": BENCH_R_HI, "r_lo": BENCH_R_LO, "reps": BENCH_REPS,
              "ranks": BENCH_RANKS, "device": DEVICE,
              "set_seconds": BENCH_SET_S, "backend": BENCH_BACKEND}
    goodput = {} if BENCH_GOODPUT is None else dict(
        zip(("elems", "bucket_elems"), BENCH_GOODPUT))
    payloads = {} if BENCH_PAYLOADS is None else {"payloads": BENCH_PAYLOADS}
    with pooled_spawns():
        rows = list(bench.measure_device_goodput(**goodput, **sizing))
        rows += bench.measure_quantized_collectives(**payloads, **sizing)
    for row in rows:
        print(json.dumps({"phase": "bench_row", **row}), flush=True)
    errors = [r for r in rows if "error" in r]
    if errors:
        raise AssertionError(f"bench rows failed: {errors}")
    return {"rows": len(rows)}


# -- phase 18: the rank transport (ipc) --------------------------------------

def transport_ranks():
    """``tests/torch_transport_ranks.py``, the rank side that phase 18
    shares with the transport's CPU and card tests (no JAX)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_transport_ranks
    return torch_transport_ranks


def transport_cases(world: int, sp: int, seed: int) -> list:
    """The twin cases of one spawn (``torch_transport_ranks.make_cases``):
    every collective in f32, bf16 and int8 on the world and, on a mesh,
    on its sp and dp lines; each pair's payload one chunk and 12 bytes
    (two chunks, the second ragged; an int8 all_to_all's blocks then
    start unaligned), made on each rank's device from ``seed``."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    from akka_allreduce_tpu_torch.parallel.group import axis_lines
    tr = transport_ranks()
    chunk = transport.chunk_bytes(
        [world] + [len(ln) for ln in axis_lines(world, sp) if 0 in ln])
    seeds = iter(range(seed * 1000, seed * 1000 + 1000))
    sizes = {"float32": 4, "bfloat16": 2, "int8": 1}
    return tr.make_cases(
        world, sp, {d: ((chunk + 12) // s,) for d, s in sizes.items()},
        lambda dtype, shape: tr.Seeded(shape, next(seeds)))


def transport_timed(world: int) -> list:
    """``(label, kind, dtype, elems a pair)`` timed on the world: the f32
    sync's all_to_all and all_gather at the flagship's bucket matrix (2.16
    GB a rank in and out), one K/V block of phase 13's ring (B 8, 1,024
    positions, 4 KV heads of 128, bf16) by exchange and ppermute, and
    the step's metrics all_gather (3 f32)."""
    total = 8257 * BUCKET_ELEMS
    return [("sync_all_to_all", "all_to_all", "float32", total // world),
            ("sync_all_gather", "all_gather", "float32", total // world),
            ("kv_exchange", "exchange", "bfloat16", 8 * 1024 * 4 * 128),
            ("kv_ppermute", "ppermute", "bfloat16", 8 * 1024 * 4 * 128),
            ("metrics_all_gather", "all_gather", "float32", 3)]


def transport_bounds(kind: str, n: int, pair_bytes: int) -> dict:
    """Two byte bounds of one call over every rank on the one card, each
    also in ms at the card's memory rate: ``function`` — each rank reads
    its input once and writes its output once (what any wire must move,
    the kernels line's bound); ``copies`` — this schedule's: each
    received byte written by the push and read by the pull, read and
    written once each way (4 B), and each local block read and written
    (2 B)."""
    peers = {"all_to_all": n - 1, "all_gather": n - 1, "exchange": 1,
             "ppermute": 1}[kind]
    ins = pair_bytes * (n if kind == "all_to_all" else 1)
    outs = pair_bytes * (n if kind in ("all_to_all", "all_gather") else 1)
    local = pair_bytes if kind in ("all_to_all", "all_gather") else 0
    function = n * (ins + outs)
    copies = n * (4 * peers * pair_bytes + 2 * local)
    return {"function_bytes": function,
            "function_ms": function / PEAK_BYTES_PER_S * 1e3,
            "copies_bytes": copies,
            "copies_ms": copies / PEAK_BYTES_PER_S * 1e3}


def transport_timings(torch, group, reps: int) -> list:
    """``transport_timed`` on the world, ``reps`` calls each between
    gloo barriers, host clock from a drained stream to ``transport.wait``:
    this rank's median; every rank's medians come back with it."""
    import dataclasses

    from akka_allreduce_tpu_torch.ops.kernels import transport
    tr = transport_ranks()
    twin = dataclasses.replace(group, backend=TWIN)
    rows = []
    for label, kind, dtype, elems in transport_timed(group.world):
        n = group.world
        kw = {"peers": [p ^ 1 for p in range(n)]} if kind == "exchange" \
            else {"shift": 1}
        if kind == "exchange" and n % 2:
            continue
        case = ("world", kind, dtype, tr.Seeded(
            (n, elems) if kind == "all_to_all" else (elems,), 7), kw)
        x = tr.rank_input(group, case)
        tr.run_case(group, case, x)  # warm-up
        transport.wait(group)
        times = []
        for _ in range(reps):
            twin.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_case(group, case, x)
            transport.wait(group)
            times.append((time.perf_counter() - t0) * 1e3)
        mine = torch.tensor([statistics.median(times)], dtype=torch.float64)
        every = twin.all_gather(mine).tolist()
        pair = elems * x.element_size()
        b = transport_bounds(kind, n, pair)
        received = pair * (n - 1 if kind in ("all_to_all", "all_gather")
                           else 1)
        rows.append({"label": label, "kind": kind, "dtype": dtype,
                     "pair_bytes": pair, "ms_per_rank": every,
                     "ms": max(every),
                     "received_gb_per_s": received / max(every) / 1e6,
                     "bound_bytes": b["function_bytes"],
                     "bound_ms": b["function_ms"],
                     "copies_bound_bytes": b["copies_bytes"],
                     "copies_bound_ms": b["copies_ms"]})
        del x
    return rows


def transport_rank(group, seed: int, first: bool) -> dict:
    """One rank of phase 18's spawn: every ``transport_cases`` case
    against its gloo twin; on the first spawn (two ranks) also the 2.16
    GB all_to_all, the timings, and the fault control, rank 1 skipping
    an all_gather."""
    import torch

    from akka_allreduce_tpu_torch.parallel.group import peer_buffer_list
    tr = transport_ranks()
    cases = transport_cases(group.world, group.sp, seed)
    if first:
        total = 8257 * BUCKET_ELEMS
        cases.append(("world", "all_to_all", "float32", tr.Seeded(
            (group.world, total // group.world), seed * 1000 + 999), {}))
    out = {"rank": group.rank, "cases": tr.run_twins(group, cases)}
    if first:
        out["timings"] = transport_timings(torch, group, TRANSPORT_REPS)
    out["buffers"] = [{"line": list(b.line), "bytes": b.nbytes}
                      for b in peer_buffer_list("transport")]
    if first:
        out["fault"] = {**tr.skip_one_call(group, TRANSPORT_FAULT_TIMEOUT_S),
                        "timeout_s": TRANSPORT_FAULT_TIMEOUT_S}
    return out


def transport_kernel_row(runs: dict, launches: int) -> dict:
    """The kernels line's entry of the transport's copy kernel: timed on
    phase 18's two ranks as the f32 sync's all_to_all of 2.16 GB a rank
    (the slowest rank's median), the gloo twin's call of the same as the
    plain version, bitwise (error 0); its bound the function's bytes
    (each rank's input read and output written once)."""
    ranks = runs[TRANSPORT_SPAWNS[0]]
    timing = next(t for t in ranks[0]["timings"]
                  if t["label"] == "sync_all_to_all")
    big = [c for r in ranks for c in r["cases"]
           if c["kind"] == "all_to_all" and c["pair_bytes"]
           == timing["pair_bytes"]]
    return {"name": "transport_copy", "route": "cuda",
            "source": TRANSPORT_SOURCE, "replaces": TRANSPORT_REPLACES,
            "launches": launches, "max_abs_err": 0.0, "ms": timing["ms"],
            "plain_ms": max(c["gloo_ms"] for c in big),
            "bound_ms": timing["bound_ms"], "bound_by": "bytes",
            "library_ms": None}


def phase_transport(torch) -> dict:
    """Phase 18: the ``ipc`` rank transport against gloo, on spawned
    ranks at each of ``TRANSPORT_SPAWNS``; the first (two ranks) also
    moves the 2.16 GB payload, times each collective and runs the fault
    control."""
    failures, rows = [], {}
    for i, (world, sp) in enumerate(TRANSPORT_SPAWNS):
        first = i == 0
        t0 = time.perf_counter()
        (ranks, _), = spawn_batch(
            torch, [("call", transport_rank, (100 + i, first))],
            world=world, backend=DIST, sp=sp)
        seconds = time.perf_counter() - t0
        cases = ranks[0]["cases"]
        rows[world, sp] = ranks
        emit("transport", world=world, sp=sp, seconds=seconds,
             buffers=ranks[0]["buffers"], cases=cases,
             timings=ranks[0].get("timings"),
             fault=[r.get("fault") for r in ranks])
        bad = [(r["rank"], c["scope"], c["kind"], c["dtype"],
                c["pair_bytes"]) for r in ranks for c in r["cases"]
               if not c["bitwise"]]
        if bad:
            failures.append(f"{world} ranks: not bitwise gloo: {bad}")
        if first:
            fault = ranks[0]["fault"]
            if not (fault.get("raised")
                    and fault["seconds"] <= TRANSPORT_FAULT_TIMEOUT_S
                    + TRANSPORT_FAULT_SLACK_S
                    and "ready from rank 1" in fault["message"]):
                failures.append(f"fault control: {fault}")
    if failures:
        raise AssertionError(f"transport: {failures}")
    return rows


def allreduce_bounds(n: int, elems: int) -> dict:
    """Per kernel, ms at the card's memory rate with all n ranks on one
    card: ``function`` — every rank reads its input once and writes its
    output once (the bytes the allreduce itself must move when the ranks
    can reach each other's memory); ``schedule`` — the bytes of the
    kernels' push / reduce / gather (``ring.rank_bytes`` summed over the
    ranks: 2N + 4(n-1)/n N a rank, both add orders); ``parent`` — the
    bytes the per-step TPU schedules moved when the card ran them (the
    parent's kernels in the turns): the ring's the same, the swing's (1
    + 4 log2 n) N a rank (x read twice, each step's sum stored locally
    and into the partner's slot and read back)."""
    from akka_allreduce_tpu_torch.ops.kernels import ring
    p, rate = 4 * elems, PEAK_BYTES_PER_S / 1e3
    schedule = sum(ring.rank_bytes(n, elems, r) for r in range(n)) / rate
    parent = {"ring_allreduce": schedule,
              "swing_allreduce": n * (1 + 4 * (n.bit_length() - 1)) * p
              / rate}
    return {k: {"function": n * 2 * p / rate, "schedule": schedule,
                "parent": parent[k]} for k in ALLREDUCE_REPLACES}


def int_checksum(torch, x) -> list:
    """Two int64 sums over x's bits (plain and position-weighted, int64
    wrapping alike on every rank), 64M elements at a time."""
    bits, total, weighted = x.view(torch.int32), 0, 0
    for i, part in enumerate(bits.split(1 << 26)):
        v = part.long()
        pos = torch.arange(v.numel(), device=v.device) + (i << 26) + 1
        total += int(v.sum())
        weighted += int((v * pos).sum())
    return [total, weighted]


def ipc_probe(group) -> dict:
    """Each rank fills its peer buffer with 1000 + rank and reads every
    peer's through the IPC mapping."""
    import torch
    bufs = group.peer_buffers("dp", 4096)
    bufs.view().view(torch.int32).fill_(1000 + group.rank)
    torch.cuda.synchronize()
    group.barrier()
    seen = {peer: bufs.view(peer).view(torch.int32).unique().tolist()
            for peer in bufs.peers}
    group.barrier()
    return {"route": "cudaIpcGetMemHandle / cudaIpcOpenMemHandle",
            "peers": sorted(bufs.peers), "seen": list(seen.values()),
            "ok": all(v == [1000 + p] for p, v in seen.items())}


def allreduce_split(torch, group, call, calls: int = 3) -> dict:
    """A torch.profiler window over ``calls`` back-to-back calls on this
    rank (every rank runs one, after a discarded window of one call: a
    process's first window ran ~3x slower): per call, the span between
    CUDA events, the device time of its kernels (``device_kernel_rows``)
    and the span less that time; the kernels that ran on the card a
    call (``ring.kernels_run``, counted on the device), the stream waits
    the calls enqueued (``ring.stream_waits``) and the schedule's
    kernels the profiler recorded a call (below 3 when its window lost
    records, and then ``kernel_ms`` is short too). The ranks'
    contexts time-slice the card, so a kernel's device time also holds
    the slices its peers took while it was resident: the span less the
    kernels is what the card spent in none of this rank's kernels
    (switches, and waits that no kernel overlapped), not the waits."""
    from akka_allreduce_tpu_torch.ops.kernels import ring
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's first start-up
        call()
        ring.wait(group)
    group.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    waits, ran = ring.stream_waits(), ring.kernels_run(group)
    with profile(activities=activities) as prof:
        start.record()
        for _ in range(calls):
            call()
        end.record()
        ring.wait(group)
        end.synchronize()
    waits, ran = ring.stream_waits() - waits, ring.kernels_run(group) - ran
    averages = prof.key_averages()
    rows = device_kernel_rows(torch, averages, calls)
    profiled = sum(e.count for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and any(k in e.key for k in ALLREDUCE_KERNELS))
    span = start.elapsed_time(end) / calls
    kernel = sum(ms for _, ms in rows)
    return {"span_ms": span, "kernel_ms": kernel,
            "span_minus_kernels_ms": span - kernel, "kernels": rows,
            "kernels_per_call": ran / calls, "waits_per_call": waits / calls,
            "profiled_kernels_per_call": profiled / calls}


def allreduce_rank(group, elems: int, loop: int, reps: int) -> dict:
    """One rank of phase 14: the IPC probe; per schedule the loop of
    ``loop`` kernel calls (launches counted from 0), each call ended
    through ``ring.wait`` and checked against its plain version, the
    other ranks and the f64 sum of a sample of columns; then the timings
    (every rank calls and reports its own events), the profiler split
    of a call, and gloo ``all_reduce`` timed once."""
    import torch
    import torch.distributed as dist

    from akka_allreduce_tpu_torch.ops.kernels import ring
    n, dev = group.world, group.device
    out = {"rank": group.rank, "ipc_probe": ipc_probe(group)}
    if not out["ipc_probe"]["ok"]:
        return out
    gen = torch.Generator(dev).manual_seed(group.rank)
    x = torch.randn(elems, generator=gen, device=dev)
    cols = torch.arange(ALLREDUCE_SAMPLE, device=dev) * (elems - 1) // (
        ALLREDUCE_SAMPLE - 1)

    def timed(call, before=None, sync=None, reps=reps) -> list:
        times = []
        for _ in range(reps):
            if before is not None:
                before()
            group.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            if sync is not None:
                sync()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def wait():
        ring.wait(group)

    for name, kernel, plain in (
            ("ring_allreduce", ring.peer_ring_allreduce,
             ring.ring_allreduce_reference),
            ("swing_allreduce", ring.peer_swing_allreduce,
             ring.swing_allreduce_reference)):
        steps, carry = [], x
        ring.reset_counts()
        for _ in range(loop):
            group.barrier()
            got = kernel(carry, group)
            ring.wait(group)
            want = plain(carry, group)
            sample = group.all_gather(carry[cols][None]).double().sum(0)
            sums = group.all_gather(torch.tensor(
                [int_checksum(torch, got)], device=dev)).tolist()
            steps.append({
                "bitwise_plain": bool(torch.equal(got, want)),
                "max_abs_err": float((got - want).abs().max()),
                "finite": bool(torch.isfinite(got).all()),
                "ranks_equal": all(c == sums[0] for c in sums),
                "sample_max_abs_err": float(
                    (got[cols].double() - sample).abs().max()),
                "sample_ok": bool(torch.allclose(
                    got[cols].double(), sample, rtol=ALLREDUCE_TOL,
                    atol=ALLREDUCE_TOL))})
            carry = carry + got / n
            del got, want
        launches = ring.counts()[name]
        del carry
        small = x[:ALLREDUCE_SMALL].clone()
        kernel(small, group)  # maps its own peer buffers
        ring.wait(group)
        out[name] = {
            "steps": steps, "launches": launches,
            "ms": timed(lambda: kernel(x, group), sync=wait),
            "plain_ms": timed(lambda: plain(x, group),
                              reps=ALLREDUCE_REF_REPS),
            "small_ms": timed(lambda: kernel(small, group), sync=wait),
            "split": allreduce_split(torch, group, lambda: kernel(x, group)),
            "small_split": allreduce_split(torch, group,
                                           lambda: kernel(small, group))}
        torch.cuda.empty_cache()
    y = x.clone()
    dist.all_reduce(y)  # the gloo algorithm's warm-up
    out["library_ms"] = timed(lambda: dist.all_reduce(y),
                              before=lambda: y.copy_(x),
                              reps=ALLREDUCE_REF_REPS)
    return out


def phase_allreduce(torch) -> dict:
    """Phase 14 at each (ranks, elements) of ALLREDUCE_RUNS; returns the
    kernels' rows for the kernels line (times at two ranks, the slowest
    rank's median; launches summed over both runs and their ranks)."""
    from akka_allreduce_tpu_torch.ops.kernels import ring
    rows, failures = {}, []
    for n, elems in ALLREDUCE_RUNS:
        (ranks, _), = spawn_batch(
            torch, [("call", allreduce_rank, (elems, ALLREDUCE_LOOP,
                                              ALLREDUCE_REPS))],
            world=n, backend="gloo")
        probes = [r["ipc_probe"] for r in ranks]
        emit("allreduce_ipc_probe", ranks=n, probes=probes)
        if not all(p["ok"] for p in probes):
            raise AssertionError(f"CUDA IPC between the ranks failed: "
                                 f"{probes}")
        bounds = allreduce_bounds(n, elems)
        library = statistics.median(ranks[0]["library_ms"])
        for name in ALLREDUCE_REPLACES:
            per_rank = [r[name] for r in ranks]
            steps_ok = all(
                s["bitwise_plain"] and s["finite"] and s["ranks_equal"]
                and s["sample_ok"] for r in per_rank for s in r["steps"])
            launches = [r["launches"] for r in per_rank]
            ok = steps_ok and launches == [ALLREDUCE_LOOP] * n
            medians = [statistics.median(r["ms"]) for r in per_rank]
            per_call = {k: sorted({r[s][k] for r in per_rank
                                   for s in ("split", "small_split")})
                        for k in ("kernels_per_call", "waits_per_call")}
            ok = ok and per_call == {
                "kernels_per_call": [ring.KERNELS_PER_CALL],
                "waits_per_call": [ring.WAITS_PER_CALL]}
            small = [statistics.median(r["small_ms"]) for r in per_rank]
            row = {
                "ranks": n, "elems": elems, "ok": ok,
                "launches_per_rank": launches,
                "expected_launches_per_rank": ALLREDUCE_LOOP,
                "kernels_per_call": per_call["kernels_per_call"][0],
                "waits_per_call": per_call["waits_per_call"][0],
                "per_call_all_ranks": per_call,
                "steps_rank0": per_rank[0]["steps"],
                "max_abs_err": max(s["max_abs_err"] for r in per_rank
                                   for s in r["steps"]),
                "sample_max_abs_err": max(
                    s["sample_max_abs_err"] for r in per_rank
                    for s in r["steps"]),
                "ms": max(medians), "ms_rank0": medians[0],
                "ms_median_per_rank": medians,
                "ms_all_rank0": per_rank[0]["ms"],
                "small_elems": ALLREDUCE_SMALL,
                "small_ms": max(small), "small_ms_median_per_rank": small,
                "small_ms_all_rank0": per_rank[0]["small_ms"],
                "split_rank0": per_rank[0]["split"],
                "small_split_rank0": per_rank[0]["small_split"],
                "plain_ms": statistics.median(per_rank[0]["plain_ms"]),
                "plain_ms_all": per_rank[0]["plain_ms"],
                "library_ms": library,
                "library_call": "torch.distributed.all_reduce on the gloo "
                                "group (NCCL refuses two ranks on one "
                                "device)",
                "bound_ms": bounds[name]["function"], "bound_by": "bytes",
                "schedule_bound_ms": bounds[name]["schedule"],
                "parent_schedule_bound_ms": bounds[name]["parent"]}
            emit("allreduce", kernel=name, **row)
            if not ok:
                failures.append((name, n))
            if n == ALLREDUCE_RUNS[0][0]:
                rows[name] = row
            rows[name]["launches"] = rows[name].get("launches", 0) + sum(
                launches)
        emit("allreduce_library", ranks=n, elems=elems,
             library_ms_all=ranks[0]["library_ms"])
    if failures:
        raise AssertionError(f"the peer-memory allreduce failed: "
                             f"{failures}")
    return rows


def reference_logits(torch, params, cfg, prompt, tokens):
    """The logits that picked each of ``tokens`` after ``prompt``, from
    one full forward (the cached decode's parity oracle)."""
    from akka_allreduce_tpu_torch.models.transformer import \
        transformer_apply
    seq = torch.tensor(list(prompt) + list(tokens[:-1]),
                       device=params["embed"].device)
    with torch.no_grad():
        logits = transformer_apply(params, seq[None], cfg)[0]
    return logits[len(prompt) - 1:].float().cpu().numpy()


def device_kernel_rows(torch, averages, n_steps: int) -> list:
    """``(name, ms per step)`` of each kernel in a profiler's
    ``key_averages()``: the rows that ran on the card, less the
    annotated ranges. A CPU op's row (``aten::mm``, an autograd node)
    carries in its ``self_device_time_total`` the time of the kernels it
    launched, and a ``record_function`` range (``Optimizer.step``) shows
    on the card as a span over its kernels; both repeat time that the
    kernels' own rows hold, so summing them would count it twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.key, e.self_device_time_total / 1e3 / n_steps)
            for e in averages
            if e.device_type == cuda and not e.is_user_annotation
            and e.self_device_time_total > 0]


def decode_step_breakdown(torch, engine, reqs) -> dict:
    """Admit the first lanes' requests into a fresh kernel engine on the
    same weights, then on copies of that pool state: one decode step
    through the kernel and one through the gather path (their logits
    must agree), and a torch.profiler window over 4 steps of each —
    wall time per step against summed device kernel time, the
    paged_attention kernel's share and the top kernels."""
    from akka_allreduce_tpu_torch.serving.engine import (
        PagedEngineConfig, PagedServingEngine, _paged_decode_step)
    fresh = PagedServingEngine(engine.params, engine.cfg, PagedEngineConfig(
        num_slots=engine.num_slots, page_size=engine.ecfg.page_size,
        attention_impl="kernel"))
    for req in reqs[:fresh.num_slots]:
        fresh.admit(req)
    tok = fresh._state["logits"].argmax(dim=-1).to(torch.int32)
    pos = torch.as_tensor(fresh._pos, device=fresh.device)
    table = fresh._page_table_device()
    logits, out = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        for impl in ("kernel", "gather"):
            kv = {n: fresh._state[n].clone() for n in ("k", "v")}

            def step():
                return _paged_decode_step(engine.params, kv, tok, pos,
                                          table, engine.cfg, impl)[1]
            logits[impl] = step()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(4):
                    step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / 4
            rows = device_kernel_rows(torch, prof.key_averages(), 4)
            device_ms = sum(ms for _, ms in rows)
            out[impl] = {
                "wall_ms_per_step": wall_ms,
                "device_ms_per_step": device_ms if rows else "not measured",
                "device_idle_share": (1 - device_ms / wall_ms) if rows
                else "not measured",
                "paged_attention_kernel_ms_per_step": sum(
                    ms for k, ms in rows if "paged_attention" in k),
                "top_kernels": sorted(rows, key=lambda r: -r[1])[:6]}
    out["max_abs_diff"] = float(
        (logits["kernel"] - logits["gather"]).abs().max())
    return out


def serve_run(torch, impl: str):
    """One ``serve`` run through the CLI's entry point; returns (args,
    report, results, engine) and emits the run's end-to-end numbers."""
    from akka_allreduce_tpu_torch import cli
    args = cli.build_parser().parse_args(
        SERVE_ARGV + ["--paged-attention", impl])
    report, results, engine = cli.run_serve(args)
    torch.cuda.synchronize()
    emit("serve_run", attention=impl,
         completed=report["requests"]["completed"],
         completed_reasons=report["completed_reasons"],
         decode_tokens_per_s=report.get("decode_tokens_per_s"),
         wall_s=report.get("wall_s"), ttft_ms=report["ttft_ms"],
         tpot_ms=report["tpot_ms"], decode_dispatches=report[
             "decode_dispatches"], kv_cache_mb=report["kv_cache_mb"],
         device=report["device"])
    if report["requests"]["completed"] != args.requests:
        raise AssertionError(f"{impl}: {report['requests']} of "
                             f"{args.requests} requests completed")
    return args, report, results, engine


def phase_serve(torch) -> dict:
    """Runs in turns — gather, kernel, kernel, gather — so the two read
    paths are compared on one card with warm-up and drift balanced; the
    first kernel run is the main path whose launches are counted."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.parity import greedy_agree

    _, _, g_results, _ = serve_run(torch, "gather")
    attention.PAGED_ATTENTION_LAUNCHES = 0
    args, report, results, engine = serve_run(torch, "kernel")
    launches = attention.PAGED_ATTENTION_LAUNCHES
    steps = engine.decode_dispatches * args.decode_steps
    expected = engine.cfg.n_layers * steps
    emit("serve_main_path", launches=launches, expected_launches=expected,
         decode_steps_run=steps)
    if launches != expected or launches == 0:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected {expected} (n_layers x steps)")
    serve_run(torch, "kernel")
    serve_run(torch, "gather")

    reqs = cli.make_requests(args, *cli._validate(args))
    breakdown = decode_step_breakdown(torch, engine, reqs)
    emit("serve_decode_step", atol=1e-3, **breakdown)
    if not breakdown["max_abs_diff"] <= 1e-3:
        raise AssertionError(f"kernel vs gather step logits differ by "
                             f"{breakdown['max_abs_diff']}")

    identical, verdicts = 0, []
    for req in reqs:
        ref_toks = g_results[req.rid][0]
        got_toks = results[req.rid][0]
        ok, why = greedy_agree(
            ref_toks, got_toks,
            reference_logits(torch, engine.params, engine.cfg, req.prompt,
                             ref_toks))
        identical += ref_toks == got_toks
        verdicts.append((req.rid, ok, why))
    emit("serve_greedy_parity", requests=len(reqs), identical=identical,
         failures=[v for v in verdicts if not v[1]])
    if not all(ok for _, ok, _ in verdicts):
        raise AssertionError(f"greedy tokens disagree: {verdicts}")
    return {"launches": launches, "report": report, "gather": g_results}


# -- phase 19: the protocol plane -------------------------------------------

def protocol_parts(n_params: int) -> dict:
    """Phase 19's four ``emulate`` argvs (without ``--device``): (a) the
    reference's own cluster, (b) the same geometry lossy with rank 1
    dead, (c) two workers on phase 9's f32 gradient (the bucket matrix
    flattened: ceil(params / 65,536) x 65,536 floats) in chunks of the
    bucket width, (d) the fuzz."""
    parts = dict(PROTOCOL_PARTS)
    if parts["c"] is None:
        rows = -(-n_params // BUCKET_ELEMS)
        parts["c"] = ["emulate", "--workers", "2", "--data-size",
                      str(rows * BUCKET_ELEMS), "--max-chunk-size",
                      str(BUCKET_ELEMS), "--max-lag", "1", "--th-complete",
                      "1.0", "--max-round", "3", "--checkpoint", "1"]
    return parts


def pump_until(cluster, rounds: int) -> int:
    """Pump in bites of ``PROTOCOL_PUMP_BITE`` messages until the master
    has completed ``rounds`` rounds (or traffic drains); returns the
    messages delivered."""
    delivered = 0
    while len(cluster.completed_rounds) < rounds:
        n = cluster.router.pump(max_messages=PROTOCOL_PUMP_BITE,
                                strict=False)
        if n == 0:
            break
        delivered += n
    return delivered


def expected_reduce_launches(tracer, cluster) -> int:
    """Row-1 launches the protocol must have made: one per reduce the
    ``th_reduce`` gate fired, plus one per chunk of the worker's block
    for each round it force-completed (the catch-up path)."""
    catchups = sum(cluster.workers[e.fields["worker"]]
                   .scatter_block_buf.num_chunks
                   for e in tracer.events
                   if e.kind == "catchup_force_complete")
    return tracer.counters["reduce_fired"] + catchups


def protocol_run(torch, argv: list, device: str, check=None, keep=True,
                 profile_round=None) -> dict:
    """One ``emulate`` run through its own code path (the command's flag
    checks and config, ``LocalCluster`` on ``device`` with the
    command's ``ThroughputSink``s, traced), every flush handed to
    ``check(rank, out, source_floats)`` and, with ``keep``, kept.
    ``profile_round``: a torch.profiler window (CUDA activity) over that
    round. The run's clock (``run_s``, ``round_s``, ``rounds_per_s``,
    ``mb_per_s``) starts at registration, stops at the last flush with
    the device synchronized, and leaves out the profiler's own start and
    stop; ``setup_s`` is the cluster's construction; ``sink_mb_per_s``
    are rank 0's ``ThroughputSink`` readings as the command prints them
    (its first interval starts when the sink is made)."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.buffers import base
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
    from akka_allreduce_tpu_torch.protocol.cluster import (
        LocalCluster, ThroughputSink, constant_range_source)
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    args = cli.build_parser().parse_args(argv + ["--device", device])
    cli.check_emulate_flags(args)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    config, n = cli.emulate_config(args)
    src = constant_range_source(n, dev)
    sinks = [ThroughputSink(n, checkpoint=args.checkpoint,
                            assert_multiple=args.assert_multiple, device=dev)
             for _ in range(args.workers)]
    flushes: dict = {r: [] for r in range(args.workers)}

    def sink_for(rank):
        def sink(out):
            sinks[rank](out)
            if check is not None:
                check(rank, out, src.floats)
            if keep:
                flushes[rank].append((out.iteration, out.data, out.count))
        return sink

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tracer = Tracer()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base.STORE_COPIES = 0
    mr.MASKED_REDUCE_LAUNCHES = 0
    t_setup = time.perf_counter()
    cluster = LocalCluster(config, source_factory=lambda r: src,
                           sink_factory=sink_for, tracer=tracer, device=dev)
    sync()
    paused = [0.0]  # the profiler's own start and stop, off the run clock

    def clock():
        return time.perf_counter() - paused[0]

    stamps = []
    counted = cluster.master.on_round_complete

    def on_round(r):
        counted(r)
        stamps.append(clock())
    cluster.master.on_round_complete = on_round
    t0 = clock()
    setup_s = time.perf_counter() - t_setup
    cluster.start()
    if args.kill_rank is not None:
        cluster.kill_worker(args.kill_rank)
    messages, window, prof = 0, None, None
    if profile_round is not None:
        messages += pump_until(cluster, profile_round)
        sync()
        if cuda:
            tp = time.perf_counter()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            paused[0] += time.perf_counter() - tp
        tw = clock()
        m = pump_until(cluster, profile_round + 1)
        sync()
        wall_ms = (clock() - tw) * 1e3
        if prof is not None:
            tp = time.perf_counter()
            prof.__exit__(None, None, None)
            paused[0] += time.perf_counter() - tp
        window = {"round": profile_round, "messages": m, "wall_ms": wall_ms}
        messages += m
    messages += cluster.router.pump(max_messages=cluster._message_budget())
    sync()
    run_s = clock() - t0
    if window is not None:
        rows = device_kernel_rows(torch, prof.key_averages(), 1) \
            if prof is not None else []
        device_ms = sum(ms for _, ms in rows)
        window.update(
            device_ms=device_ms if rows else "not measured",
            device_idle_share=(1 - device_ms / window["wall_ms"]) if rows
            else "not measured",
            top_kernels=sorted(rows, key=lambda r: -r[1])[:6])
    launches = mr.MASKED_REDUCE_LAUNCHES
    expected = expected_reduce_launches(tracer, cluster)
    rounds = len(cluster.completed_rounds)
    round_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    out = {
        "argv": argv, "device": str(dev), "rounds": rounds,
        "setup_s": setup_s, "run_s": run_s, "rounds_per_s": rounds / run_s,
        "round_s": round_s if len(round_s) <= 8 else None,
        "mb_per_s": n * 4 * rounds / run_s / 1e6,
        "sink_mb_per_s": sinks[0].rates_mbps,
        "messages": messages, "messages_per_round": messages / max(1, rounds),
        "launches": launches, "expected_launches": expected,
        "reduce_fired": tracer.counters["reduce_fired"],
        "catchups": tracer.counters["catchup_force_complete"],
        "store_copies": base.STORE_COPIES,
        "flushes": [len(flushes[r]) if keep else sinks[r].outputs_seen
                    for r in range(args.workers)],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "profile": window}
    if rounds != args.max_round:
        raise AssertionError(f"emulate {argv}: {rounds}/{args.max_round} "
                             f"rounds completed")
    if cuda and launches != expected:
        raise AssertionError(
            f"emulate {argv}: {launches} masked-reduce launches, the "
            f"tracer implies {expected} (reduce_fired {out['reduce_fired']}"
            f" + the chunks of {out['catchups']} catch-ups)")
    if cuda and not launches:
        raise AssertionError(f"emulate {argv}: the masked reduce never "
                             f"launched")
    del cluster, sinks, src
    return out, flushes


def same_flushes(got: dict, want: dict) -> bool:
    """Every worker's flushes, in order, bitwise: rounds, data, counts."""
    if sorted(got) != sorted(want):
        return False
    for r in got:
        if len(got[r]) != len(want[r]):
            return False
        for (gi, gd, gc), (wi, wd, wc) in zip(got[r], want[r]):
            if gi != wi or not torch_equal(gd.cpu(), wd.cpu()) \
                    or not torch_equal(gc.cpu(), wc.cpu()):
                return False
    return True


def phase_protocol(torch, n_params: int) -> dict:
    """Phase 19 (see the module docstring); returns the parts' lines and
    the masked-reduce launches of the four parts."""
    import gc

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    t_phase = time.perf_counter()
    parts = protocol_parts(n_params)
    lines = {}

    def multiple_of(k):
        def check(rank, out, floats):
            if not (torch_equal(out.data, floats * k)
                    and bool((out.count == k).all())):
                raise AssertionError(f"worker {rank} round {out.iteration}:"
                                     f" output != {k} x input")
        return check

    def honest(rank, out, floats):
        if not torch_equal(out.data, floats * out.count.float()):
            raise AssertionError(f"worker {rank} round {out.iteration}: "
                                 f"data != arange * count")

    # (a) the reference's cluster, (b) lossy with rank 1 dead: each on the
    # card and on its CPU twin, every flush bitwise
    for part, check in (("a", multiple_of(4)), ("b", honest)):
        got, flushes = protocol_run(torch, parts[part], DEVICE, check)
        twin, twin_flushes = protocol_run(torch, parts[part], PROTOCOL_TWIN,
                                          check)
        got["bitwise_twin"] = same_flushes(flushes, twin_flushes)
        got["twin"] = {k: twin[k] for k in ("device", "setup_s", "run_s",
                                            "rounds_per_s", "mb_per_s",
                                            "sink_mb_per_s")}
        emit("protocol", part=part, **got)
        if not got["bitwise_twin"]:
            raise AssertionError(f"phase 19 ({part}): a flush differs from "
                                 f"its CPU twin's")
        lines[part] = got
        del flushes, twin_flushes

    # (c) the flagship's gradient at two workers: output == 2 x the
    # tensor the source handed out, counts 2, every flush
    want = {}

    def doubled(rank, out, floats):
        if "data" not in want:
            want["data"] = floats + floats
        if not (torch_equal(out.data, want["data"])
                and bool((out.count == 2).all())):
            raise AssertionError(f"worker {rank} round {out.iteration}: "
                                 f"output != 2 x source")
    got, _ = protocol_run(torch, parts["c"], DEVICE, doubled, keep=False,
                          profile_round=1)
    want.clear()
    emit("protocol", part="c", **got)
    lines["c"] = got
    gc.collect()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()

    # (d) the fuzz: every schedule's cluster traced, 0 violations
    args = cli.build_parser().parse_args(parts["d"] + ["--device", DEVICE])
    cli.check_emulate_flags(args)
    tracer = Tracer()
    mr.MASKED_REDUCE_LAUNCHES = 0
    failures, n_scheds, seconds = cli.run_fuzz(args, resolve_device(DEVICE),
                                               tracer=tracer)
    from akka_allreduce_tpu_torch.config import block_ranges, num_chunks
    _, n = cli.emulate_config(args)
    chunks = [num_chunks(hi - lo, args.max_chunk_size)
              for lo, hi in block_ranges(n, args.workers)]
    expected = tracer.counters["reduce_fired"] + sum(
        chunks[e.fields["worker"]] for e in tracer.events
        if e.kind == "catchup_force_complete")
    got = {"argv": parts["d"], "schedules": n_scheds,
           "violations": len(failures), "seconds": seconds,
           "failures": [str(f) for f in failures[:5]],
           "launches": mr.MASKED_REDUCE_LAUNCHES,
           "expected_launches": expected,
           "reduce_fired": tracer.counters["reduce_fired"],
           "catchups": tracer.counters["catchup_force_complete"]}
    emit("protocol", part="d", **got)
    if failures:
        raise AssertionError(f"phase 19 (d): {len(failures)}/{n_scheds} "
                             f"schedules violated invariants")
    cuda = torch.device(DEVICE).type == "cuda"
    if cuda and got["launches"] != expected:
        raise AssertionError(f"phase 19 (d): {got['launches']} launches, "
                             f"the tracer implies {expected}")
    lines["d"] = got
    seconds = time.perf_counter() - t_phase
    emit("protocol_phase_seconds", seconds=seconds,
         limit_s=PROTOCOL_SECONDS)
    if seconds > PROTOCOL_SECONDS:
        raise AssertionError(f"phase 19 took {seconds:.1f} s, over its "
                             f"{PROTOCOL_SECONDS} s")
    return {"lines": lines,
            "launches": sum(lines[p]["launches"] for p in "abcd")}


# -- phase 20: the protocol plane across processes --------------------------

def cluster_argvs(part: str, n_params: int, port: int, trace_dir: str
                  ) -> "tuple[list, list]":
    """Phase 20's ``(master argv, [(engine, worker argv), ...])`` for
    ``part``, each argv for ``python -m akka_allreduce_tpu_torch.cli``.
    A card worker traces to ``trace_dir/<part>-w<i>.jsonl``; the Python
    master to ``trace_dir/<part>-master.jsonl``."""
    master_engine, engines = CLUSTER_PARTS[part]
    lossy = part == "e"
    script = list(CLUSTER_SCRIPT)
    rounds, checkpoint, timeout = CLUSTER_ROUNDS.get(part), \
        CLUSTER_CHECKPOINT, CLUSTER_TIMEOUT_S
    liveness = []
    if part == "d":
        rows = -(-n_params // BUCKET_ELEMS)
        script = ["--data-size", str(rows * BUCKET_ELEMS),
                  "--max-chunk-size", str(BUCKET_ELEMS), "--max-lag", "1"]
        rounds, checkpoint, timeout = CLUSTER_SCALE_ROUNDS, 1, \
            CLUSTER_SCALE_TIMEOUT_S
        liveness = ["--unreachable-after", str(CLUSTER_SCALE_UNREACHABLE_S)]
    if lossy:
        checkpoint = CLUSTER_KILL_AFTER  # the victim's first sink line
    th = "0.75" if lossy else "1.0"
    n = len(engines)
    master = ["master", "--port", str(port), "--workers", str(n), *script,
              "--th-allreduce", th, "--th-reduce", th, "--th-complete", th,
              "--max-round", str(rounds), "--timeout", str(timeout),
              *liveness]
    if master_engine == "native":
        master.append("--native")
    else:
        master += ["--trace-file", os.path.join(trace_dir,
                                                f"{part}-master.jsonl")]
    workers = []
    for i, engine in enumerate(engines):
        argv = ["worker", "--master-port", str(port), "--checkpoint",
                str(checkpoint), "--timeout", str(timeout + 30),
                "--verbose", *liveness]
        if not lossy:
            argv += ["--assert-multiple", str(n)]
        if engine == "native":
            argv.append("--native")
        else:
            argv += ["--data-size", script[1], "--assert-honest",
                     "--trace-file", os.path.join(trace_dir,
                                                  f"{part}-w{i}.jsonl")]
            if CLUSTER_DEVICE is not None:
                argv += ["--device", CLUSTER_DEVICE]
        workers.append((engine, argv))
    return master, workers


class ClusterProc:
    """One ``cli`` process with its output lines read on a thread (a pipe
    left undrained blocks its writer), ``on_line(proc, line)`` called on
    each."""

    def __init__(self, argv: list, on_line=None):
        import threading
        self.argv = argv
        self.lines: list = []
        self.p = subprocess.Popen(
            [sys.executable, "-u", "-m", "akka_allreduce_tpu_torch.cli",
             *argv], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.on_line = on_line
        self.t_first = None  # when the first line arrived
        self.t = threading.Thread(target=self._read, daemon=True)
        self.t.start()

    def _read(self) -> None:
        for line in self.p.stdout:
            if self.t_first is None:
                self.t_first = time.perf_counter()
            self.lines.append(line.rstrip("\n"))
            if self.on_line is not None:
                self.on_line(self, self.lines[-1])

    def wait(self, timeout: float) -> int:
        rc = self.p.wait(timeout=timeout)
        self.t.join(timeout=10)
        return rc

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=30)


def read_trace(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def worker_result(proc, engine: str, trace: list, chunks: list) -> dict:
    """A worker process's line: exit code, the report it printed (card
    workers), its launches against its trace's implied count
    (``reduce_fired`` plus, per ``catchup_force_complete``, the chunks
    of its block), its sink's MB/s and its round times."""
    out = {"engine": engine, "rc": proc.p.returncode,
           "sink_mb_per_s": [float(m.group(1)) for m in (
               re.search(r"at ([0-9.]+) MB/s", ln) for ln in proc.lines)
               if m]}
    for ln in proc.lines:
        m = re.match(r"worker -?\d+: report (\{.*\})$", ln)
        if m:
            out.update(json.loads(m.group(1)))
    if engine == "native":
        out["native_lines"] = [ln for ln in proc.lines if "native" in ln]
        return out
    kinds = collections.Counter(e["kind"] for e in trace)
    rank = out.get("rank", -1)
    out["reduce_fired"] = kinds["reduce_fired"]
    out["catchups"] = kinds["catchup_force_complete"]
    out["expected_launches"] = kinds["reduce_fired"] + (
        kinds["catchup_force_complete"] * chunks[rank] if rank >= 0 else 0)
    done = [e["ts"] for e in trace if e["kind"] == "round_complete"]
    out["rounds_flushed"] = len(done)
    out["worker_rounds_per_s"] = ((len(done) - 1) / (done[-1] - done[0])
                                  if len(done) > 1 and done[-1] > done[0]
                                  else None)
    return out


def cluster_run(torch, part: str, n_params: int, trace_dir: str) -> dict:
    """Phase 20's part ``part``: the master, then at once its workers
    (they retry the dial until the master listens), as ``python -m
    akka_allreduce_tpu_torch.cli`` processes; in (e) the
    worker that joins as rank 1 is SIGKILLed once its sink printed round
    ``CLUSTER_KILL_AFTER``'s checkpoint. Every process is stopped before
    this returns. Checks: the master's rounds, every worker's exit code,
    every card worker's launches against its trace."""
    import signal

    from akka_allreduce_tpu_torch.config import block_ranges, num_chunks
    from akka_allreduce_tpu_torch.protocol.remote import free_port
    port = free_port()
    margv, wargvs = cluster_argvs(part, n_params, port, trace_dir)
    n = len(wargvs)
    size = int(margv[margv.index("--data-size") + 1])
    chunk = int(margv[margv.index("--max-chunk-size") + 1])
    rounds = int(margv[margv.index("--max-round") + 1])
    chunks = [num_chunks(hi - lo, chunk) for lo, hi in block_ranges(size, n)]
    killed = {}

    def on_worker_line(proc, line):
        if part != "e" or killed:
            return
        if line == f"worker: joined as rank {CLUSTER_KILL_RANK}":
            proc.victim = True
        if getattr(proc, "victim", False) and " MB in " in line:
            os.kill(proc.p.pid, signal.SIGKILL)
            killed["argv_index"] = procs.index(proc)

    t0 = time.perf_counter()
    master = ClusterProc(margv)
    procs: list = []
    try:
        for _, argv in wargvs:
            procs.append(ClusterProc(argv, on_worker_line))
        timeout = int(margv[margv.index("--timeout") + 1]) + 60
        master_rc = master.wait(timeout)
        t_master = time.perf_counter()
        rcs = [p.wait(timeout) for p in procs]
    finally:
        for p in procs + [master]:
            p.kill()
    m_rounds = [int(m.group(1)) for m in (
        re.match(r"master: (\d+)/\d+ rounds", ln) for ln in master.lines)
        if m]
    downs = [int(m.group(1)) for m in (
        re.search(r"worker down at round (\d+)", ln) for ln in master.lines)
        if m]
    mtrace = read_trace(os.path.join(trace_dir, f"{part}-master.jsonl"))
    starts = [e["ts"] for e in mtrace if e["kind"] == "round_start"]
    workers = [worker_result(p, engine, read_trace(os.path.join(
        trace_dir, f"{part}-w{i}.jsonl")), chunks)
        for i, (p, (engine, _)) in enumerate(zip(procs, wargvs))]
    # rounds/s on the master's clock: round 0's start to round R's (the
    # R rounds before it completed); the C++ master keeps no trace, so
    # there the card workers' flush clock (rank 0's first to last)
    round_s = None
    if len(starts) > rounds:
        run_s = starts[rounds] - starts[0]
        clock = "master"
        round_s = [b - a for a, b in zip(starts, starts[1:rounds + 1])]
    else:
        card = [w for w in workers if w.get("worker_rounds_per_s")]
        run_s = (rounds / card[0]["worker_rounds_per_s"]) if card else None
        clock = "worker"
    card = [w for w in workers if w["engine"] == "card"]
    got = {
        "part": part, "argv_master": margv, "engines": [e for e, _ in wargvs],
        "master_rc": master_rc, "rounds": m_rounds[-1] if m_rounds else None,
        "max_round": rounds, "downs_at_round": downs, "clock": clock,
        "run_s": run_s, "round_s": round_s if rounds <= 8 else None,
        "rounds_per_s": rounds / run_s if run_s else None,
        "mb_per_s": size * 4 * rounds / run_s / 1e6 if run_s else None,
        "wall_s": time.perf_counter() - t0,
        "master_listening_s": (master.t_first - t0 if master.t_first
                               else None),
        "master_exit_s": t_master - t0,
        "worker_rcs": rcs, "workers": workers,
        "killed_worker": killed.get("argv_index"),
        "launches": sum(w.get("masked_reduce_launches", 0) for w in card)}
    if part == "d":
        # per worker and round, from the shapes: the frames it sends to
        # its one peer (its chunks of the peer's block, and its block's
        # reduced chunks), 256 KB each
        got["frames_per_worker_round"] = {
            f"w{r}": {"scatter": chunks[1 - r], "reduce": chunks[r],
                      "bytes": 4 * (block_ranges(size, n)[1 - r][1]
                                    - block_ranges(size, n)[1 - r][0]
                                    + block_ranges(size, n)[r][1]
                                    - block_ranges(size, n)[r][0])}
            for r in range(n)}
    emit("cluster", **got)
    fail = []
    if master_rc != 0 or got["rounds"] != rounds:
        fail.append(f"master rc {master_rc}, {got['rounds']}/{rounds} "
                    f"rounds: {master.lines[-5:]}")
    for i, w in enumerate(workers):
        if part == "e" and i == killed.get("argv_index"):
            if w["rc"] != -signal.SIGKILL:
                fail.append(f"worker {i} was killed, rc {w['rc']}")
            continue
        if w["rc"] != 0:
            fail.append(f"worker {i} ({w['engine']}) rc {w['rc']}: "
                        f"{procs[i].lines[-8:]}")
        elif w["engine"] == "card":
            if "masked_reduce_launches" not in w:
                fail.append(f"worker {i} printed no report")
            elif CLUSTER_DEVICE is None and (
                    w["masked_reduce_launches"] != w["expected_launches"]
                    or not w["masked_reduce_launches"]):
                fail.append(f"worker {i}: {w['masked_reduce_launches']} "
                            f"masked-reduce launches, its trace implies "
                            f"{w['expected_launches']}")
    if part == "e" and (not killed or len(downs) != 1):
        fail.append(f"rank {CLUSTER_KILL_RANK} killed: {bool(killed)}, "
                    f"downs {downs}")
    if fail:
        raise AssertionError(f"phase 20 ({part}): " + "; ".join(fail))
    return got


def message_copies(torch, device: str) -> dict:
    """The per-message device copies a card worker makes, host-timed as
    the worker makes them (median of ``CLUSTER_COPY_REPS``): encoding a
    chunk view of a round's input (``wire.encode``: the device-to-host
    copy, which waits for the device) and receiving one (``wire.decode``
    then the store's ``copy_`` into a staging row, pageable host to
    device), at (a)'s 3 floats and (d)'s 65,536, beside the same on CPU
    tensors."""
    from akka_allreduce_tpu_torch.messages import ScatterBlock
    from akka_allreduce_tpu_torch.protocol import wire
    rows = {}
    for dev in (device, "cpu"):
        for elems in (3, BUCKET_ELEMS):
            data = torch.arange(4 * elems, dtype=torch.float32, device=dev)
            row = torch.zeros(elems, dtype=torch.float32, device=dev)
            msg = ScatterBlock(data[elems:2 * elems], 0, 1, 1, 0)
            addr = ("127.0.0.1", 1)
            enc, dec = [], []
            for _ in range(CLUSTER_COPY_REPS):
                t = time.perf_counter()
                buf = wire.encode(msg, lambda ref: addr)
                enc.append(time.perf_counter() - t)
                t = time.perf_counter()
                row.copy_(wire.decode(buf, lambda a: None).value)
                dec.append(time.perf_counter() - t)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            if not torch_equal(row.cpu(), data[elems:2 * elems].cpu()):
                raise AssertionError(f"phase 20: a {elems}-float chunk "
                                     f"did not survive the codec on {dev}")
            rows[f"{dev}:{elems}"] = {
                "encode_us": statistics.median(enc) * 1e6,
                "decode_store_us": statistics.median(dec) * 1e6}
    return rows


def phase_cluster(torch, n_params: int) -> dict:
    """Phase 20 (see the module docstring); returns the parts' lines and
    the card workers' masked-reduce launches."""
    import gc
    import io

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.native import build_library
    t_phase = time.perf_counter()
    gc.collect()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    build_library()  # once, before the processes that load it (main()
    # has built it in phase 2; a script that calls this phase alone has not)
    emit("cluster_build", seconds=time.perf_counter() - t)
    lines = {"copies": message_copies(torch, CLUSTER_DEVICE or DEVICE)}
    emit("cluster", part="copies", **lines["copies"])
    with tempfile.TemporaryDirectory(prefix="cluster-") as trace_dir:
        for part in CLUSTER_PARTS:
            lines[part] = cluster_run(torch, part, n_params, trace_dir)
    # (f) the C++ engine in one process, on the host, at (a)'s config
    argv = ["emulate", "--engine", "native", "--workers", "4",
            *CLUSTER_SCRIPT, "--th-complete", "1.0", "--assert-multiple",
            "4", "--max-round", str(CLUSTER_ROUNDS["a"])]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    m = re.search(r"completed (\d+)/(\d+) rounds in ([0-9.]+)s \(([0-9,]+) "
                  r"rounds/s, (\d+) flushes, native engine, host\)",
                  out.getvalue())
    got = {"part": "f", "argv": argv, "rc": rc, "line": out.getvalue().strip()}
    if m:
        got.update(rounds=int(m.group(1)), seconds=float(m.group(3)),
                   rounds_per_s=int(m.group(1)) / float(m.group(3))
                   if float(m.group(3)) > 0 else None,
                   flushes=int(m.group(5)))
    emit("cluster", **got)
    if rc != 0 or not m or got["rounds"] != CLUSTER_ROUNDS["a"]:
        raise AssertionError(f"phase 20 (f): {got}")
    lines["f"] = got
    seconds = time.perf_counter() - t_phase
    emit("cluster_phase_seconds", seconds=seconds, limit_s=CLUSTER_SECONDS)
    if seconds > CLUSTER_SECONDS:
        raise AssertionError(f"phase 20 took {seconds:.1f} s, over its "
                             f"{CLUSTER_SECONDS} s")
    return {"lines": lines,
            "launches": sum(lines[p]["launches"] for p in CLUSTER_PARTS)}


def with_steps(argv: list, steps: int) -> list:
    """``argv`` with its ``--steps`` value replaced."""
    out = list(argv)
    out[out.index("--steps") + 1] = str(steps)
    return out


def model_flags(argv: list) -> list:
    """The model-shape flags of a train argv, for generate and eval."""
    out = []
    for i, a in enumerate(argv):
        if a in ("--d-model", "--n-heads", "--n-layers", "--d-ff", "--vocab",
                 "--kv-heads", "--ffn", "--attn-window"):
            out += [a, argv[i + 1]]
        elif a in ("--rope", "--tie-embeddings"):
            out.append(a)
    return out


def flash_counts() -> dict:
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_dq": fa.FLASH_DQ_LAUNCHES,
            "flash_dkv": fa.FLASH_DKV_LAUNCHES}


def zero_flash_counts(torch) -> None:
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def expected_flash(n: int) -> dict:
    """``n`` launches of each flash kernel on the card (the CPU wrappers
    run the plain versions and count nothing)."""
    return dict.fromkeys(FLASH_REPLACES, n if DEVICE == "cuda" else 0)


def leaf_rel_errs(torch, got: list, want: list) -> list:
    """Per leaf: the largest difference over the leaf's largest value."""
    return [float((a.detach().float().cpu() - b.detach().float().cpu()
                   ).abs().max() / b.detach().float().abs().max().cpu()
                  .clamp(min=1e-30)) for a, b in zip(got, want)]


def a5_families(torch, work: str) -> dict:
    """(a): ``train --optimizer`` lion, adafactor and sgd at the flagship
    configuration (the lion run with ``--metrics-file`` and
    ``--xprof-dir``, part (e)). Returns the runs and their flash
    launches."""
    from akka_allreduce_tpu_torch import cli
    out = {"flash": dict.fromkeys(FLASH_REPLACES, 0), "runs": {}}
    for fam in A5_FAMILIES:
        extra = ["--optimizer", fam]
        if fam == "lion":
            extra += ["--metrics-file", os.path.join(work, "metrics.prom"),
                      "--xprof-dir", os.path.join(work, "trace"),
                      "--xprof-steps", "2"]
        args = cli.build_parser().parse_args(
            with_steps(TRAIN_ARGV, A5_STEPS) + extra)
        zero_flash_counts(torch)
        report = cli.run_train(args)
        launches = flash_counts()
        expected = expected_flash(args.n_layers * args.steps)
        row = {"optimizer": fam, "losses": report["losses"],
               "wall_ms_per_step": report["wall_ms_per_step"],
               "tokens_per_s": report["tokens_per_s"], "mfu": report["mfu"],
               "optimizer_state_gb": report["optimizer_state_gb"],
               "peak_memory_gb": report["peak_memory_gb"],
               "launches": launches, "expected_launches": expected}
        emit("a5_family", **row)
        if not all(math.isfinite(x) for x in report["losses"]):
            raise AssertionError(f"{fam}: non-finite losses {row}")
        if launches != expected:
            raise AssertionError(f"{fam}: flash launches {launches}, "
                                 f"expected {expected}")
        for k in FLASH_REPLACES:
            out["flash"][k] += launches[k]
        out["runs"][fam] = report
    return out


def a5_update_check(torch) -> list:
    """(a): ``A5_UPDATE_STEPS`` updates of each family on the card against
    the same updates on the CPU, from the same weights (the flagship's
    width at ``A5_UPDATE_LAYERS`` layers), gradients and fresh state."""
    import dataclasses

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.train import (apply_update,
                                                       make_train_state,
                                                       tree_leaves, tree_map)
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    args = cli.build_parser().parse_args(
        TRAIN_ARGV + ["--n-layers", str(A5_UPDATE_LAYERS)])
    base = cli.train_config(args, args.seq)
    gen = torch.Generator(DEVICE).manual_seed(0)
    params = init_transformer(gen, base.model, DEVICE)
    grads = [[torch.randn(p.shape, generator=gen, device=DEVICE)
              * A5_UPDATE_GRAD_SCALE for p in tree_leaves(params)]
             for _ in range(A5_UPDATE_STEPS)]
    rows = []
    for fam in A5_FAMILIES:
        cfg = dataclasses.replace(base, optimizer=fam)
        after, seconds = [], []
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            state = make_train_state(cfg, params=tree_map(
                lambda p: p.detach().to(dev, copy=True), params))
            for update in grads:
                apply_update(cfg, state,
                             [g.to(dev, copy=True) for g in update])
            after.append(tree_leaves(state.params))
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        errs = leaf_rel_errs(torch, *after)
        row = {"optimizer": fam, "layers": A5_UPDATE_LAYERS,
               "updates": A5_UPDATE_STEPS, "leaves": len(errs),
               "max_rel_err": max(errs), "tol": A5_UPDATE_TOL,
               "card_s": seconds[0], "cpu_s": seconds[1]}
        emit("a5_update", **row)
        if max(errs) > A5_UPDATE_TOL:
            raise AssertionError(f"{fam}: the card's updates against the "
                                 f"CPU's: {row}")
        rows.append(row)
        del after
    return rows


def a5_ema(torch, work: str) -> dict:
    """(b): ``train --ema-decay`` with a checkpoint, the EMA against its
    recurrence and the checkpoint's item, then ``generate --use-ema``
    and ``eval --use-ema`` as processes on the card against the same
    computations in this process, and the control (``--use-ema`` on a
    checkpoint without EMA exits 2)."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.data import eval_batches, load_corpus
    from akka_allreduce_tpu_torch.models.generate import generate
    from akka_allreduce_tpu_torch.models.train import (
        TrainConfig, select_local_attention, tree_leaves)
    from akka_allreduce_tpu_torch.models.transformer import (
        init_transformer, next_token_loss_and_aux)
    from akka_allreduce_tpu_torch.runtime import checkpoint as ck
    ckpt, plain = os.path.join(work, "ema-ckpt"), os.path.join(work, "plain")
    args = cli.build_parser().parse_args(with_steps(TRAIN_ARGV, A5_STEPS) + [
        "--ema-decay", str(A5_EMA_DECAY), "--ckpt-every", str(A5_STEPS),
        "--ckpt-dir", ckpt])
    mcfg = cli.train_config(args, args.seq).model
    params = init_transformer(torch.Generator(DEVICE).manual_seed(0), mcfg,
                              DEVICE)
    first = [p.detach().clone() for p in tree_leaves(params)]
    kept, live = [], {}

    def keep(_i, state):  # the post-update masters of every step
        kept.append([p.detach().clone() for p in tree_leaves(state.params)])
        live["ema"] = state.ema
    saves, real_save = [], ck.CheckpointManager.save

    def timed_save(self, *a, **k):
        t0 = time.perf_counter()
        done = real_save(self, *a, **k)
        if done:  # an interval-gated call that saved
            saves.append(time.perf_counter() - t0)
        return done
    zero_flash_counts(torch)
    ck.CheckpointManager.save = timed_save
    try:
        report = cli.run_train(args, params=params, on_step=keep)
    finally:
        ck.CheckpointManager.save = real_save
    launches = flash_counts()
    ema = live["ema"]
    mgr = ck.CheckpointManager(ck.CheckpointConfig(ckpt))
    step, saved, _ = mgr.restore_params(ema, item="ema")
    item_bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(saved), tree_leaves(ema)))
    ref = first
    for masters in kept:
        ref = [A5_EMA_DECAY * e + (1 - A5_EMA_DECAY) * p
               for e, p in zip(ref, masters)]
    errs = leaf_rel_errs(torch, tree_leaves(ema), ref)
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, str(step), f))
                     for f in os.listdir(os.path.join(ckpt, str(step))))
    del saved, ref, kept, first
    # the control's checkpoint: one saved without an EMA (the CLI
    # defaults' small model: the item check comes before any weight is
    # read, so its size does not matter)
    small = init_transformer(torch.Generator(DEVICE).manual_seed(0),
                             cli.train_config(cli.build_parser().parse_args(
                                 ["train"]), 32).model, DEVICE)
    ck.CheckpointManager(ck.CheckpointConfig(plain)).save(
        0, small, {"count": 1}, force=True)
    prompt = np.random.default_rng(0).integers(
        0, args.vocab, size=A5_PROMPT_TOKENS).tolist()
    corpus = os.path.join(work, "corpus.bin")
    np.random.default_rng(0).integers(
        0, args.vocab, size=A5_EVAL_WINDOWS * args.seq).astype(
        "<u2").tofile(corpus)
    shape = model_flags(TRAIN_ARGV) + ["--max-seq", str(args.seq),
                                       "--device", DEVICE]
    decode = ["--prompt-tokens", ",".join(map(str, prompt)), "--tokens",
              str(A5_GENERATE_TOKENS), "--raw"]
    cmds = {"generate": ["generate", "--use-ema", "--ckpt-dir", ckpt,
                         *shape, *decode],
            "eval": ["eval", "--use-ema", "--ckpt-dir", ckpt, "--data-file",
                     corpus, "--batch", str(A5_EVAL_BATCH), *shape],
            "control": ["generate", "--use-ema", "--ckpt-dir", plain,
                        *shape, *decode]}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "akka_allreduce_tpu_torch.cli", *argv],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, argv in cmds.items()}
    try:
        # the same decode and cross-entropy in this process, meanwhile
        want_tokens = generate(ema, torch.tensor(
            [prompt], dtype=torch.int32, device=DEVICE), mcfg,
            steps=A5_GENERATE_TOKENS)[0].tolist()
        attn = select_local_attention(TrainConfig(model=mcfg))
        ce, n = 0.0, 0.0
        with torch.no_grad():
            for arr in eval_batches(load_corpus(corpus), A5_EVAL_BATCH,
                                    args.seq):
                loss, w, aux = next_token_loss_and_aux(
                    ema, torch.from_numpy(arr).to(DEVICE), mcfg,
                    attn_fn=attn)
                ce += float(loss - aux["aux_loss"] * w)
                n += float(w)
        outs = {k: p.communicate(timeout=A5_SUBPROCESS_TIMEOUT_S)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    rcs = {k: p.returncode for k, p in procs.items()}
    got_tokens = ([int(t) for t in outs["generate"][0].strip()
                   .splitlines()[-1].split(",")]
                  if rcs["generate"] == 0 else None)
    got_eval = (json.loads(outs["eval"][0].strip().splitlines()[-1])
                if rcs["eval"] == 0 else {})
    want_ce = ce / n
    eval_rel = (abs(got_eval["ce_nats_per_token"] - want_ce) / want_ce
                if got_eval else None)
    row = {"losses": report["losses"], "ema_decay": A5_EMA_DECAY,
           "wall_ms_per_step": report["wall_ms_per_step"],
           "launches": launches, "checkpoint_step": step,
           "checkpoint_gb": ckpt_bytes / 1e9, "save_seconds": saves,
           "ema_item_bitwise": item_bitwise,
           "ema_recurrence_max_rel_err": max(errs), "ema_tol": A5_EMA_TOL,
           "subprocess_rcs": rcs, "subprocess_seconds": seconds,
           "generate_tokens": got_tokens, "in_process_tokens": want_tokens,
           "eval": got_eval, "in_process_ce": want_ce,
           "eval_rel_diff": eval_rel, "eval_rtol": A5_EVAL_RTOL,
           "control_stderr": outs["control"][1].strip().splitlines()[-1:]}
    emit("a5_ema", **row)
    if launches != expected_flash(args.n_layers * args.steps):
        raise AssertionError(f"(b) flash launches {launches}")
    if not item_bitwise or max(errs) > A5_EMA_TOL:
        raise AssertionError(f"(b) the EMA against its checkpoint item and "
                             f"its recurrence: {row}")
    if rcs != {"generate": 0, "eval": 0, "control": 2}:
        raise AssertionError(f"(b) exit codes {rcs}: "
                             f"{ {k: o[1][-2000:] for k, o in outs.items()} }")
    if got_tokens != want_tokens:
        raise AssertionError(f"(b) generate --use-ema {got_tokens} against "
                             f"the in-process decode {want_tokens}")
    if eval_rel is None or eval_rel > A5_EVAL_RTOL:
        raise AssertionError(f"(b) eval --use-ema {got_eval} against "
                             f"{want_ce}")
    return {"flash": launches, "row": row}


def a5_overlap(torch) -> dict:
    """(c): phase 9's configuration with two microbatches a rank on the
    ipc ranks, deferred and overlapped (f32), overlapped on ef8, and the
    fault control, every run in one spawn of the ranks. Returns rank 0's
    sync, flash and transport launches summed over the checked runs."""
    from akka_allreduce_tpu_torch import cli
    totals = {"sync": dict.fromkeys(SYNC_KERNELS, 0),
              "flash": dict.fromkeys(FLASH_REPLACES, 0), "transport": 0}
    plan = [(wire, sched, steps, False)
            for wire, sched, steps in A5_OVERLAP_RUNS]
    plan.append(("none", "overlap", A5_OVERLAP_CONTROL_STEPS, True))
    runs = [("train", cli.build_parser().parse_args(
        with_steps(DP_ARGV, steps) + [
            "--grad-quant", wire, "--grad-accum", str(A5_ACCUM),
            "--accum-schedule", sched]), "fold_dropped" if control else None)
        for wire, sched, steps, control in plan]
    t0 = time.perf_counter()
    batch = spawn_batch(torch, runs)
    spawn_s = time.perf_counter() - t0
    rows = {}
    for (wire, sched, steps, control), (_, args, _), (report, _) in zip(
            plan, runs, batch):
        ranks = report["ranks"]
        cfg = report["config"]
        num_buckets = -(-cfg["params"] // cfg["bucket_elems"])
        per_sync = expected_sync_launches(
            cfg["grad_transport"], cfg["transport_schedule"], DP_WORLD,
            num_buckets, args.grad_windows)
        syncs = A5_ACCUM if sched == "overlap" else 1
        expected = {k2: v * syncs * steps for k2, v in per_sync.items()}
        sync_ms = ranks[0]["sync_ms"]
        row = {"wire": wire, "schedule": sched, "grad_accum": A5_ACCUM,
               "control": control, "backend": report["dist"]["backend"],
               "losses": report["losses"],
               "wall_ms_per_step": report["wall_ms_per_step"],
               "sync_ms": sync_ms, "sync_ms_per_step": steady(sync_ms),
               "sync_launches": report["sync_launches"],
               "expected_sync_launches": expected,
               "flash_launches": report["launches"],
               "transport": report["transport"],
               "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                           for r in ranks],
               "param_checksums": [r["param_checksum"] for r in ranks]}
        rows[wire, sched, control] = row
        emit("a5_overlap", **row)
        if not all(math.isfinite(x) for x in report["losses"]):
            raise AssertionError(f"(c) {wire} {sched}: non-finite losses")
        if len(set(row["param_checksums"])) != 1:
            raise AssertionError(f"(c) {wire} {sched}: the ranks' "
                                 f"parameters differ")
        if report["sync_launches"] != expected:
            raise AssertionError(f"(c) {wire} {sched}: sync launches "
                                 f"{report['sync_launches']}, expected "
                                 f"{expected}")
        want_flash = expected_flash(args.n_layers * A5_ACCUM * steps)
        if report["launches"] != want_flash:
            raise AssertionError(f"(c) {wire} {sched}: flash launches "
                                 f"{report['launches']}, expected "
                                 f"{want_flash}")
        if control:  # a fault control's launches are no main path's
            continue
        for k2 in SYNC_KERNELS:
            totals["sync"][k2] += report["sync_launches"][k2]
        for k2 in FLASH_REPLACES:
            totals["flash"][k2] += report["launches"][k2]
        totals["transport"] += report["transport"]["transport_launches"]
    deferred = rows["none", "deferred", False]["losses"]
    overlap = rows["none", "overlap", False]["losses"]
    control = rows["none", "overlap", True]["losses"]
    ef8 = rows["ef8", "overlap", False]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(overlap, deferred)]
    c_rel = [abs(a - b) / abs(b) for a, b in zip(control, deferred)]
    row = {"step0_bitwise": overlap[0] == deferred[0],
           "loss_rel_diff": rel, "loss_rtol": A5_OVERLAP_LOSS_RTOL,
           "control_losses": control, "control_rel_diff": c_rel,
           "ef8_loss_diff_vs_f32": [abs(a - b) for a, b in
                                    zip(ef8, deferred)],
           "ef8_loss_atol": QUANT_LOSS_ATOL,
           "sync_ms_per_step": {f"{w} {s}{' control' if c else ''}":
                                r["sync_ms_per_step"]
                                for (w, s, c), r in rows.items()},
           "spawn_seconds": spawn_s}
    emit("a5_overlap_checks", **row)
    if not row["step0_bitwise"] or max(rel[1:]) > A5_OVERLAP_LOSS_RTOL:
        raise AssertionError(f"(c) overlap against deferred: {row}")
    if not max(c_rel[1:]) > A5_OVERLAP_LOSS_RTOL:
        raise AssertionError(f"(c) the fault control (the last fold "
                             f"dropped) landed inside the bound: {row}")
    if not max(row["ef8_loss_diff_vs_f32"]) < QUANT_LOSS_ATOL:
        raise AssertionError(f"(c) ef8 overlap against the f32 wire: {row}")
    return totals


def a5_replay_profile(torch, cfg, state, tokens) -> dict:
    """(d): a torch.profiler window of one replay of a captured chunk
    (captured, and replayed once, first): wall ms (host clock to a
    synchronize), device ms (the kernels' rows), the CUDA events' span
    around the replay, and the idle share."""
    from akka_allreduce_tpu_torch.models.train import make_multi_step
    multi = make_multi_step(cfg, A5_SPD)
    multi(state, tokens[:A5_SPD])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start.record()
        multi(state, tokens[A5_SPD:2 * A5_SPD])
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_kernel_rows(torch, prof.key_averages(), 1)
    device_ms = sum(ms for _, ms in rows)
    return {"wall_ms": wall_ms, "event_span_ms": start.elapsed_time(end),
            "device_ms": device_ms if rows else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured", "kernel_rows": len(rows),
            "capture_seconds": multi.capture_seconds,
            "top_kernels": sorted(rows, key=lambda r: -r[1])[:6]}


def a5_graph(torch, trained: dict) -> dict:
    """(d): ``train --steps-per-dispatch A5_SPD`` for ``A5_SPD_STEPS``
    steps (two graph replays on the card), held bitwise against the same
    step code run eagerly from the same weights and batches, and within
    ``A5_GRAPH_LOSS_RTOL`` of phase 6's losses."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.models.train import (make_train_state,
                                                       make_train_step,
                                                       tree_map)
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    args = cli.build_parser().parse_args(
        with_steps(TRAIN_ARGV, A5_SPD_STEPS)
        + ["--steps-per-dispatch", str(A5_SPD)])
    cfg = cli.train_config(args, args.seq)
    params = init_transformer(torch.Generator(DEVICE).manual_seed(0),
                              cfg.model, DEVICE)
    init = tree_map(lambda p: p.detach().clone(), params)
    zero_flash_counts(torch)
    report = cli.run_train(args, params=params)
    launches = flash_counts()
    multi = report["multi_step"]
    del params
    # the same step code, eagerly, step by step, on the same kind of
    # state (the step count on the device), from the same weights and
    # batches
    state = make_train_state(cfg, params=init, device_step=True)
    tokens = torch.from_numpy(np.stack([np.random.default_rng(i).integers(
        0, args.vocab, size=(args.batch, args.seq), dtype=np.int32)
        for i in range(A5_SPD_STEPS)])).to(DEVICE)
    step = make_train_step(cfg)
    eager_losses = torch.stack([step(state, tokens[i])["loss"]
                                for i in range(A5_SPD_STEPS)]).tolist()
    one_card = trained["losses"][:A5_SPD_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(report["losses"], one_card)]
    replays = A5_SPD_STEPS // A5_SPD if DEVICE == "cuda" else 0
    per_replay = expected_flash(args.n_layers * A5_SPD)
    warmup = expected_flash(args.n_layers)
    want = {k: per_replay[k] * replays + warmup[k] for k in FLASH_REPLACES}
    profile = (a5_replay_profile(torch, cfg, state, tokens)
               if DEVICE == "cuda" else "not measured")
    row = {"steps_per_dispatch": A5_SPD, "losses": report["losses"],
           "eager_losses": eager_losses,
           "bitwise_eager": report["losses"] == eager_losses,
           "phase6_losses": one_card, "loss_rel_diff_vs_phase6": rel,
           "loss_rtol": A5_GRAPH_LOSS_RTOL,
           "wall_ms_per_step": report["wall_ms_per_step"],
           "phase6_wall_ms_per_step": trained["wall_ms_per_step"],
           "phase6_idle_share": trained["idle_share"],
           "step_ms": report["step_ms"], "multi_step": multi,
           "launches": launches, "expected_launches": want,
           "replay_launches": {k: per_replay[k] * replays
                               for k in FLASH_REPLACES},
           "warmup_launches": warmup, "replay_profile": profile,
           "peak_memory_gb": report["peak_memory_gb"]}
    emit("a5_graph", **row)
    if not row["bitwise_eager"]:
        raise AssertionError(f"(d) the graph path against the eager step "
                             f"code: {row}")
    if max(rel) > A5_GRAPH_LOSS_RTOL:
        raise AssertionError(f"(d) against phase 6's losses: {row}")
    if launches != want or multi["graph_replays"] != replays:
        raise AssertionError(f"(d) flash launches {launches} over "
                             f"{multi['graph_replays']} replays, expected "
                             f"{want} over {replays}")
    return {"flash": launches}


def a5_telemetry(torch, report: dict, n_layers: int, steps: int) -> dict:
    """(e): the lion run's snapshot (parsed with the port's parser) and
    its trace (the flash kernels of the window's 2 steps)."""
    from akka_allreduce_tpu_torch.telemetry.registry import \
        parse_prometheus_text
    with open(report["metrics_file"]) as f:
        parsed = parse_prometheus_text(f.read())
    counts = {s: parsed[(f"train_step_dispatch_{s}_ms_count", ())]
              for s in ("host", "device", "gap")}
    with open(report["xprof_trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [str(e.get("name")) for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(1 for n in kernels if f"{k}_mma_kernel" in n)
              for k in FLASH_REPLACES}
    steps_traced = sorted(str(e.get("name")) for e in events
                          if str(e.get("name")).startswith("train_step#"))
    b, t = report["config"]["batch"], report["config"]["seq"]
    row = {"train_steps_total": parsed[("train_steps_total", ())],
           "train_tokens_total": parsed[("train_tokens_total", ())],
           "train_loss": parsed[("train_loss", ())],
           "dispatch_counts": counts, "trace": report["xprof_trace"],
           "trace_events": len(events), "trace_kernel_events": len(kernels),
           "traced_flash_kernels": traced,
           "traced_step_ranges": sorted(set(steps_traced))}
    emit("a5_telemetry", **row)
    # the gap series has one sample fewer: the first span has no
    # previous end
    want_counts = {"host": steps, "device": steps, "gap": steps - 1}
    want_traced = expected_flash(2 * n_layers)
    if (row["train_steps_total"] != steps
            or row["train_tokens_total"] != steps * b * t
            or counts != want_counts
            or row["train_loss"] != report["losses"][-1]):
        raise AssertionError(f"(e) the metrics snapshot: {row}")
    if traced != want_traced:
        raise AssertionError(f"(e) the trace holds {traced} flash kernels, "
                             f"expected {want_traced} (2 steps)")
    return row


def phase_a5(torch, trained: dict) -> dict:
    """Phase 21: the A5 training paths on the card (see the module
    docstring). Returns the main path's launches: flash (rows 10-12),
    the sync kernels' (rows 1, 5-7) and the transport's."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="a5-") as work:
        fams = a5_families(torch, work)
        updates = a5_update_check(torch)
        tel = a5_telemetry(torch, fams["runs"]["lion"],
                           fams["runs"]["lion"]["config"]["n_layers"],
                           A5_STEPS)
        ema = a5_ema(torch, work)
    overlap = a5_overlap(torch)
    graph = a5_graph(torch, trained)
    seconds = time.perf_counter() - t0
    adamw_gb = trained["optimizer_state_gb"]
    emit("a5_summary", seconds=seconds, limit_s=A5_SECONDS,
         optimizer_state_gb={"adamw (phase 6)": adamw_gb, **{
             f: fams["runs"][f]["optimizer_state_gb"] for f in A5_FAMILIES}},
         wall_ms_per_step={"adamw (phase 6)": trained["wall_ms_per_step"],
                           **{f: fams["runs"][f]["wall_ms_per_step"]
                              for f in A5_FAMILIES}},
         update_max_rel_err={u["optimizer"]: u["max_rel_err"]
                             for u in updates},
         trace_flash_kernels=tel["traced_flash_kernels"],
         script_seconds=time.perf_counter() - T_START)
    if seconds > A5_SECONDS:
        raise AssertionError(f"phase 21 took {seconds:.1f} s, over its "
                             f"{A5_SECONDS} s")
    flash = {k: fams["flash"][k] + ema["flash"][k] + overlap["flash"][k]
             + graph["flash"][k] for k in FLASH_REPLACES}
    return {"flash": flash, "sync": overlap["sync"],
            "transport": overlap["transport"]}



# -- phase 22: the serving of ROADMAP A6, part 1 ---------------------------

def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def set_flag(argv: list, flag: str, value) -> list:
    """``argv`` with ``flag``'s value set to ``value`` (appended if
    absent)."""
    out = list(argv)
    if flag in out:
        out[out.index(flag) + 1] = str(value)
        return out
    return out + [flag, str(value)]


def slot_argv(argv: list) -> list:
    """``argv`` on the slot engine: the paged engine's flags dropped."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--page-size", "--num-pages", "--paged-attention"):
            skip = True
        elif a != "--paged":
            out.append(a)
    return out


def serve_fields(report: dict) -> dict:
    """A serve report's end-to-end numbers."""
    return {"completed": report["requests"]["completed"],
            "completed_reasons": report["completed_reasons"],
            "decode_tokens_per_s": report.get("decode_tokens_per_s"),
            "tpot_ms_p50": report["tpot_ms"].get("p50"),
            "tpot_ms_p99": report["tpot_ms"].get("p99"),
            "ttft_ms_p50": report["ttft_ms"].get("p50"),
            "decode_tokens": report["tokens"]["decode"],
            "decode_dispatches": report["decode_dispatches"],
            "kv_cache_mb": report["kv_cache_mb"],
            "evictions": report["evictions"],
            **({"speculative": report["speculative"]}
               if "speculative" in report else {})}


def a6_serve(torch, argv: list, name: str):
    """One ``serve`` run of ``argv`` through the CLI's entry point:
    (args, report, results, engine), its numbers emitted."""
    from akka_allreduce_tpu_torch import cli
    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    report, results, engine = cli.run_serve(args)
    sync(torch)
    emit("a6_serve_run", run=name, seconds=time.perf_counter() - t0,
         **serve_fields(report))
    return args, report, results, engine


def a6_engine_run(torch, name: str, engine, reqs: list,
                  policy: str = "fifo") -> "tuple[dict, dict]":
    """Serve ``reqs`` through ``engine`` with ``serve_loop``; (report,
    results), the report's numbers those of the serve command's."""
    from akka_allreduce_tpu_torch.serving import (RequestScheduler,
                                                  SchedulerConfig,
                                                  ServingMetrics,
                                                  serve_loop)
    metrics = ServingMetrics()
    sched = RequestScheduler(SchedulerConfig(policy=policy),
                             num_slots=engine.num_slots)
    for r in reqs:
        metrics.on_submit(r.rid)
        sched.submit(r)
    t0 = time.perf_counter()
    results = serve_loop(engine, sched, metrics=metrics)
    sync(torch)
    report = {**metrics.summary(), "decode_dispatches":
              engine.decode_dispatches, "evictions": engine.evictions,
              "kv_cache_mb": round(engine.kv_cache_bytes() / 1e6, 2),
              "completed_reasons": dict(collections.Counter(
                  r for _, r in results.values()))}
    emit("a6_serve_run", run=name, seconds=time.perf_counter() - t0,
         **serve_fields(report))
    return report, results


def a6_main_path(attention, engine, name: str) -> int:
    """The paged kernel's launches since its count was set to 0 must be
    n_layers x the decode steps the engine ran."""
    launches = attention.PAGED_ATTENTION_LAUNCHES
    expected = engine.cfg.n_layers * engine.decode_dispatches \
        * engine.ecfg.decode_steps
    emit("a6_main_path", run=name, launches=launches,
         expected_launches=expected)
    if launches != expected or launches == 0:
        raise AssertionError(f"{name}: paged_attention launched {launches} "
                             f"times, expected {expected}")
    return launches


def a6_scores(torch, params, cfg, prompt, toks, seed: int, sample: tuple,
              shift: int = 0):
    """The reference's sampled scores along the stream ``toks``: the full
    forward's logits through the filters, plus the Gumbel noise of token
    j's key ``fold_in(key(seed), j + shift)`` at the (1, vocab) shape (the
    argmax the sampled pick takes). ``shift`` 1 is the fault control."""
    from akka_allreduce_tpu_torch.models import prng
    from akka_allreduce_tpu_torch.models.generate import \
        apply_sample_filters
    from akka_allreduce_tpu_torch.models.transformer import \
        transformer_apply
    dev = params["embed"].device
    seq = torch.tensor(list(prompt) + list(toks[:-1]), device=dev)
    with torch.no_grad():
        logits = transformer_apply(params, seq[None], cfg)[0]
        filt = apply_sample_filters(logits[len(prompt) - 1:], *sample)
        keys = prng.fold_in(prng.key(seed, dev),
                            torch.arange(len(toks), device=dev) + shift)
        noise = prng.gumbel(keys, (1, cfg.vocab_size), filt.dtype)[:, 0]
    return (filt + noise).float().cpu().numpy()


def a6_prng_bits(torch, n_req: int, vocab: int) -> dict:
    """Threefry on the card against the CPU, the keys of the first
    ``A6_PRNG_INDICES`` tokens of each request at the (1, vocab) shape:
    the bits bitwise, the Gumbel noise's largest difference."""
    from akka_allreduce_tpu_torch.models import prng
    base = prng.wrap_key_data(torch.stack([prng.key(r)
                                           for r in range(n_req)]))
    keys = prng.fold_in(base[:, None, :],
                        torch.arange(A6_PRNG_INDICES)[None, :])
    cpu = prng.bits(keys, (1, vocab))
    dev = prng.bits(keys.to(DEVICE), (1, vocab)).cpu()
    g_cpu = prng.gumbel(keys, (1, vocab))
    g_dev = prng.gumbel(keys.to(DEVICE), (1, vocab)).cpu()
    return {"draws": int(cpu.numel()), "bits_equal": torch.equal(cpu, dev),
            "gumbel_max_abs_diff": float((g_cpu - g_dev).abs().max())}


def a6_pick_cost(torch, lanes: int, vocab: int, sample: tuple) -> dict:
    """One decode step's pick over ``lanes`` rows of logits, argmax
    against the sampled draw (filters, threefry, Gumbel, argmax): wall ms
    a pick (host clock over A6_STEP_REPS picks, the stream drained at
    both ends, no profiler) and device ms a pick (the kernels' time in a
    torch.profiler window over as many picks; the profiler's own host
    cost makes that window's wall no measure)."""
    from akka_allreduce_tpu_torch.models.generate import sample_token_rows
    from akka_allreduce_tpu_torch.models import prng
    if not torch.cuda.is_available():
        return {"wall_ms": "not measured", "device_ms": "not measured"}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    logits = 3 * torch.randn(lanes, vocab, generator=gen, device=DEVICE)
    keys = torch.stack([prng.key(r, DEVICE) for r in range(lanes)])
    idx = torch.arange(lanes, device=DEVICE, dtype=torch.int32)
    picks = {"greedy": lambda: logits.argmax(dim=-1),
             "sampled": lambda: sample_token_rows(keys, logits, idx,
                                                  sample)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, pick in picks.items():
        for _ in range(3):
            pick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(A6_STEP_REPS):
            pick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / A6_STEP_REPS
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(A6_STEP_REPS):
                pick()
            torch.cuda.synchronize()
        rows = device_kernel_rows(torch, prof.key_averages(), A6_STEP_REPS)
        out[name] = {"wall_ms": wall,
                     "device_ms": sum(ms for _, ms in rows) if rows
                     else "not measured",
                     "kernels": len(rows)}
    g, s = out["greedy"], out["sampled"]
    out["extra_wall_ms"] = s["wall_ms"] - g["wall_ms"]
    if isinstance(s["device_ms"], float) and isinstance(g["device_ms"],
                                                          float):
        out["extra_device_ms"] = s["device_ms"] - g["device_ms"]
    return out


def a6_sampled(torch) -> dict:
    """(a): sampled serving at ``A6_SAMPLE`` on the kernel path (the main
    path, its launches counted) at decode steps 4 and 1, and on the
    gather path; the PRNG on the card; the pick's cost."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.parity import greedy_agree
    argv = SERVE_ARGV + A6_SAMPLE
    attention.PAGED_ATTENTION_LAUNCHES = 0
    args, report, res_k4, engine = a6_serve(
        torch, argv + ["--paged-attention", "kernel"], "sampled_kernel_s4")
    launches = a6_main_path(attention, engine, "sampled_kernel_s4")
    _, _, res_k1, _ = a6_serve(
        torch, set_flag(argv, "--decode-steps", 1)
        + ["--paged-attention", "kernel"], "sampled_kernel_s1")
    differ = [rid for rid in res_k4 if res_k4[rid] != res_k1[rid]]
    emit("a6_sampled_blocks", requests=len(res_k4), differ=differ)
    if differ:
        raise AssertionError(f"sampled tokens at decode steps 4 differ "
                             f"from 1 for requests {differ}")
    _, _, res_g, _ = a6_serve(torch, argv + ["--paged-attention", "gather"],
                              "sampled_gather_s4")
    sample = (args.temperature, args.top_k, args.top_p)
    verdicts, controls, identical = [], [], 0
    for req in cli.make_requests(args, *cli._validate(args)):
        ref, got = res_g[req.rid][0], res_k4[req.rid][0]
        scores = a6_scores(torch, engine.params, engine.cfg, req.prompt,
                           ref, req.rid, sample)
        # the gather stream is the argmax of the reference scores, and
        # the kernel stream agrees with it under the rule
        ok_ref, why_ref = greedy_agree(scores.argmax(-1), ref, scores)
        ok, why = greedy_agree(ref, got, scores)
        verdicts.append((req.rid, ok_ref and ok, why_ref, why))
        identical += ref == got
        wrong = a6_scores(torch, engine.params, engine.cfg, req.prompt,
                          ref, req.rid, sample, shift=1)
        controls.append(greedy_agree(wrong.argmax(-1), ref, wrong)[0])
    emit("a6_sampled_parity", requests=len(verdicts), identical=identical,
         failures=[v for v in verdicts if not v[1]],
         fault_control_passed=sum(controls))
    if not all(v[1] for v in verdicts):
        raise AssertionError(f"sampled tokens outside the perturbed-score "
                             f"rule: {verdicts}")
    if all(controls):
        raise AssertionError("the fault control (key index + 1) passed the "
                             "perturbed-score rule")
    bits = a6_prng_bits(torch, args.requests, args.vocab)
    emit("a6_prng", **bits)
    if not bits["bits_equal"]:
        raise AssertionError("threefry bits on the card differ from the "
                             "CPU's")
    cost = a6_pick_cost(torch, args.slots, args.vocab, sample)
    emit("a6_pick_cost", lanes=args.slots, **cost)
    return {"launches": launches, "report": report, "pick": cost}


def bf16_min_gap(logits) -> float:
    """Two bf16 ulps of the largest logit: where two implementations'
    rounding may swap a bf16 model's top two."""
    top = float(abs(logits).max())
    return 2.0 ** (math.floor(math.log2(top)) - 6) if top > 0 else 0.0


def a6_bf16(torch, reqs_of) -> dict:
    """(b): bf16 serving (the gqa4 model in bf16, weights from seed 0)
    on the kernel path (launches counted) against the gather path."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.parity import greedy_agree
    from akka_allreduce_tpu_torch.serving import (PagedEngineConfig,
                                                  PagedServingEngine)
    args = cli.build_parser().parse_args(SERVE_ARGV)
    cfg, params = cli.serve_model(args, torch.device(DEVICE),
                                  dtype=torch.bfloat16)
    runs, engines = {}, {}
    for impl in ("kernel", "gather"):
        engine = PagedServingEngine(params, cfg, PagedEngineConfig(
            num_slots=args.slots, decode_steps=args.decode_steps,
            page_size=args.page_size, attention_impl=impl))
        attention.PAGED_ATTENTION_LAUNCHES = 0
        runs[impl] = a6_engine_run(torch, f"bf16_{impl}", engine,
                                   reqs_of(args))[1]
        engines[impl] = engine
        if impl == "kernel":
            launches = a6_main_path(attention, engine, "bf16_kernel")
    verdicts, identical = [], 0
    for req in reqs_of(args):
        ref, got = runs["gather"][req.rid][0], runs["kernel"][req.rid][0]
        logits = reference_logits(torch, params, cfg, req.prompt, ref)
        ok, why = greedy_agree(ref, got, logits,
                               min_gap=bf16_min_gap(logits))
        verdicts.append((req.rid, ok, why))
        identical += ref == got
    emit("a6_bf16_parity", requests=len(verdicts), identical=identical,
         failures=[v for v in verdicts if not v[1]])
    if not all(v[1] for v in verdicts):
        raise AssertionError(f"bf16 kernel tokens disagree: {verdicts}")
    if torch.cuda.is_available():
        emit("a6_bf16_decode_step",
             **decode_step_breakdown(torch, engines["kernel"],
                                     reqs_of(args)))
    return {"launches": launches}


def a6_int8(torch, reqs_of) -> dict:
    """(c): int8 KV on the slot and the paged gather engines: cache
    bytes against the float cache's; the step logits of one token
    stream on both caches within ``A6_INT8_BOUND`` and within that share
    of the logit scale; a serve run of each."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.serving.engine import (
        _paged_decode_step, _slot_decode_step)
    args = cli.build_parser().parse_args(SERVE_ARGV)
    cfg, params = cli.serve_model(args, torch.device(DEVICE))
    out = {}
    for kind in ("slot", "paged"):
        kargs = cli.build_parser().parse_args(
            SERVE_ARGV if kind == "paged" else slot_argv(SERVE_ARGV))
        engines = {}
        for fmt in ("model", "int8"):
            kargs.kv_cache = fmt
            engines[fmt] = cli.build_engine(kargs, params, cfg)
            for req in reqs_of(args)[:args.slots]:
                engines[fmt].admit(req)
        f32, q8 = engines["model"], engines["int8"]
        pos = torch.as_tensor(f32._pos, device=DEVICE)
        tok = f32._state["logits"].argmax(-1).to(torch.int32)
        worst = scale = 0.0
        with torch.no_grad():
            for _ in range(A6_INT8_STEPS):
                logits = []
                for e in (f32, q8):
                    kv = {n: t for n, t in e._state.items() if n != "logits"}
                    if kind == "paged":
                        logits.append(_paged_decode_step(
                            params, kv, tok, pos, e._page_table_device(),
                            cfg, "gather")[1])
                    else:
                        logits.append(_slot_decode_step(params, kv, tok,
                                                        pos, cfg)[1])
                worst = max(worst, float((logits[0] - logits[1]).abs().max()))
                scale = max(scale, float(logits[0].abs().max()))
                tok = logits[0].argmax(-1).to(torch.int32)
                pos = pos + 1
        row = {"cache_bytes": q8.kv_cache_bytes(),
               "float_cache_bytes": f32.kv_cache_bytes(),
               "ratio": f32.kv_cache_bytes() / q8.kv_cache_bytes(),
               "worst_logit_diff": worst, "logit_scale": scale,
               "bound": A6_INT8_BOUND}
        emit("a6_int8_step", engine=kind, **row)
        if not (worst < A6_INT8_BOUND and worst < A6_INT8_BOUND * scale):
            raise AssertionError(f"int8 KV ({kind}): logit error {worst} "
                                 f"outside the bound {A6_INT8_BOUND} "
                                 f"(scale {scale})")
        if not row["ratio"] > 3:
            raise AssertionError(f"int8 KV ({kind}) holds {row['ratio']}x "
                                 f"less than the float cache, not > 3x")
        del engines, f32, q8
        argv = (set_flag(SERVE_ARGV, "--paged-attention", "gather")
                if kind == "paged" else slot_argv(SERVE_ARGV))
        a6_serve(torch, argv + ["--kv-cache", "int8"], f"int8_{kind}")
        out[kind] = row
    return out


def a6_speculative(torch, greedy: dict, reqs_of) -> dict:
    """(d): speculation with the target's first 4 of 8 layers as the
    draft, 4 proposals a block, greedy on the slot and the paged engine
    against phase 4's greedy gather tokens; sampled twice, bitwise."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.parity import greedy_agree
    spec = set_flag(SERVE_ARGV, "--decode-steps", 1) + A6_DRAFT
    out = {}
    for kind, argv in (("slot", slot_argv(spec)),
                       ("paged", spec + ["--paged-attention", "gather"])):
        args, report, results, engine = a6_serve(torch, argv, f"spec_{kind}")
        verdicts, identical = [], 0
        for req in reqs_of(args):
            ref, got = greedy[req.rid][0], results[req.rid][0]
            ok, why = greedy_agree(ref, got, reference_logits(
                torch, engine.params, engine.cfg, req.prompt, ref))
            verdicts.append((req.rid, ok, why))
            identical += ref == got
        row = {**engine.speculative_summary(),
               "target_dispatches_per_token": engine.decode_dispatches
               / report["tokens"]["decode"],
               "identical": identical}
        if kind == "paged":
            pages = engine.paging_summary()
            row.update({n: pages[n] for n in (
                "pages_free", "pages_total", "draft_pages_free",
                "draft_pages_total")})
        emit("a6_speculative", engine=kind, requests=len(verdicts),
             failures=[v for v in verdicts if not v[1]], **row)
        if not all(v[1] for v in verdicts):
            raise AssertionError(f"speculative ({kind}) greedy tokens "
                                 f"disagree with the plain engine's: "
                                 f"{verdicts}")
        if kind == "paged" and (
                row["pages_free"] != row["pages_total"]
                or row["draft_pages_free"] != row["draft_pages_total"]):
            raise AssertionError(f"pages not returned: {row}")
        out[kind] = {**row, **serve_fields(report)}
    # the two sampled runs at one wave of requests (A6_SAMPLED_SPEC_REQUESTS)
    sampled = [a6_serve(torch, set_flag(
        spec + ["--paged-attention", "gather"] + A6_SAMPLE, "--requests",
        A6_SAMPLED_SPEC_REQUESTS), f"spec_paged_sampled_{i}")[2]
        for i in range(2)]
    emit("a6_speculative_sampled", identical_runs=sampled[0] == sampled[1])
    if sampled[0] != sampled[1]:
        raise AssertionError("two sampled speculative runs differ")
    return out


def a6_evict_buckets(torch, greedy: dict, reqs_of) -> dict:
    """(e): deadline eviction on the kernel path (requests 0 to
    A6_EVICTED - 1 carry a deadline already past, under the deadline
    policy: evicted after their first dispatch, their lanes refilled)
    and bucketed slot prefill against phase 4's greedy tokens."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.parity import greedy_agree
    args = cli.build_parser().parse_args(SERVE_ARGV
                                         + ["--paged-attention", "kernel"])
    cfg, params = cli.serve_model(args, torch.device(DEVICE))
    engine = cli.build_engine(args, params, cfg)
    reqs = reqs_of(args)
    past = time.monotonic() - 1.0
    for r in reqs[:A6_EVICTED]:
        r.deadline = past
    attention.PAGED_ATTENTION_LAUNCHES = 0
    report, results = a6_engine_run(torch, "evict_kernel", engine, reqs,
                                    policy="deadline")
    launches = a6_main_path(attention, engine, "evict_kernel")
    evicted = sorted(rid for rid, (_, r) in results.items()
                     if r == "evicted")
    row = {"evicted": evicted, "evictions": engine.evictions,
           "evictions_total": report["faults"]["evictions_total"],
           "prefill_dispatches": engine.prefill_dispatches,
           "peak_occupied": engine.peak_occupied,
           "pages_in_use": engine.pool.pages_in_use}
    emit("a6_eviction", **row)
    ran = [rid for rid, (t, r) in results.items() if rid >= A6_EVICTED
           and (r != "max_tokens" or not greedy_agree(
               greedy[rid][0], t, reference_logits(
                   torch, params, cfg, reqs[rid].prompt,
                   greedy[rid][0]))[0])]
    if (evicted != list(range(A6_EVICTED))
            or engine.evictions != A6_EVICTED
            or row["evictions_total"] != A6_EVICTED
            or engine.prefill_dispatches != len(reqs)
            or engine.peak_occupied != args.slots
            or row["pages_in_use"] or ran):
        raise AssertionError(f"eviction: {row}; requests not run to their "
                             f"greedy tokens: {ran}")
    bargs, breport, bresults, bengine = a6_serve(
        torch, slot_argv(SERVE_ARGV) + ["--prefill-buckets", A6_BUCKETS],
        "buckets_slot")
    verdicts = []
    for req in reqs_of(bargs):
        ref = greedy[req.rid][0]
        ok, why = greedy_agree(ref, bresults[req.rid][0], reference_logits(
            torch, params, cfg, req.prompt, ref))
        verdicts.append((req.rid, ok, why))
    emit("a6_buckets", prefill_programs=sorted(bengine.prefill_shapes),
         failures=[v for v in verdicts if not v[1]])
    if not all(v[1] for v in verdicts) \
            or len(bengine.prefill_shapes) > len(A6_BUCKETS.split(",")):
        raise AssertionError(f"bucketed prefill: {verdicts}")
    return {"launches": launches, "eviction": row,
            "buckets": serve_fields(breport)}


def phase_a6(torch, served: dict) -> dict:
    """Phase 22: (a) sampled, (b) bf16, (c) int8 KV, (d) speculative,
    (e) eviction and buckets; each paged-kernel run's launches counted
    from 0."""
    from akka_allreduce_tpu_torch import cli

    def reqs_of(args):
        return cli.make_requests(args, *cli._validate(args))

    t0 = time.perf_counter()
    sampled = a6_sampled(torch)
    ta = time.perf_counter()
    bf16 = a6_bf16(torch, reqs_of)
    tb = time.perf_counter()
    int8 = a6_int8(torch, reqs_of)
    tc = time.perf_counter()
    spec = a6_speculative(torch, served["gather"], reqs_of)
    td = time.perf_counter()
    evict = a6_evict_buckets(torch, served["gather"], reqs_of)
    te = time.perf_counter()
    emit("a6_phase_seconds", seconds=te - t0, sampled=ta - t0,
         bf16=tb - ta, int8=tc - tb, speculative=td - tc,
         evict_buckets=te - td, greedy_f32_kernel=serve_fields(
             served["report"]))
    return {"launches": {"sampled": sampled["launches"],
                         "bf16": bf16["launches"],
                         "evict": evict["launches"]},
            "pick": sampled["pick"], "int8": int8, "speculative": spec}


# -- phase 23: train --steps-per-dispatch across ranks (A5 part 2) ----------

class EagerChunks:
    """``make_multi_step``'s runner with every chunk run step by step on
    the card: phase 23's eager reference, the same step code on the same
    kind of state (the count and the rate on the device, capturable
    adamw) as the graphed run, from the same weights and batches."""

    def __init__(self, cfg, n: int, group=None):
        from akka_allreduce_tpu_torch.models.train import make_train_step
        self.n, self._step = n, make_train_step(cfg, group)
        self.replays, self.captured_launches = 0, None
        self.capture_seconds, self.boundary_ms, self.transport = None, [], None

    def close(self) -> None:
        """Nothing captured, nothing to release."""

    def __call__(self, state, tokens):
        import torch
        ms = [self._step(state, tokens[i]) for i in range(tokens.shape[0])]
        return {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                for k in ms[0]}


def _patched_train_rank(group, args, params, attn_impl, patches: list):
    """``cli``'s train rank with ``(owner, name, value)`` patches set for
    the run and undone after it."""
    from akka_allreduce_tpu_torch import cli
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        return cli._train_rank(group, args, params, attn_impl)
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def eager_chunks_rank(group, args, params, attn_impl):
    """``cli``'s train rank with every chunk run eagerly
    (:class:`EagerChunks`): phase 23's reference run."""
    from akka_allreduce_tpu_torch.models import train
    return _patched_train_rank(group, args, params, attn_impl,
                               [(train, "make_multi_step", EagerChunks)])


def replay_profile(torch, replay, runner, state, tokens) -> dict:
    """A torch.profiler window around one replay (``replay(runner, state,
    tokens)``, boundary included): wall ms to a synchronize, this rank's
    device ms (its kernels' rows) and their idle share."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = replay(runner, state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_kernel_rows(torch, prof.key_averages(), 1)
    device_ms = sum(ms for _, ms in rows)
    return out, {"wall_ms": wall_ms,
                 "device_ms": device_ms if rows else "not measured",
                 "device_idle_share": (1 - device_ms / wall_ms) if rows
                 else "not measured", "kernel_rows": len(rows),
                 "top_kernels": sorted(rows, key=lambda r: -r[1])[:6]}


def keys_off_rank(group, args, params, attn_impl):
    """(d)'s fault control: ``cli``'s train rank whose chunk seeds, on rank
    ``A5R_CONTROL_RANK``, are those of the step after each replay's
    (the seed table and the generators off by one step; on the CPU,
    where chunks run step by step, the rounding keys); on the card rank
    0's second replay is profiled (``replay_profile``, in
    ``rank_info``)."""
    import torch

    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.ops import collectives
    fill, replay, found = collectives.ChunkKeys.fill, \
        train._MultiStep._replay, {}

    off = int(group.rank == A5R_CONTROL_RANK)

    def fill_off(keys, base):
        fill(keys, base + off)

    def key_off(step, microbatch=None, tag=0):
        return quant_key(step + off, microbatch, tag)

    def replay_traced(runner, state, tokens):
        if runner.replays != 1 or group.rank != 0:
            return replay(runner, state, tokens)
        out, found["profile"] = replay_profile(torch, replay, runner, state,
                                               tokens)
        return out
    quant_key = train.quant_key
    # on the card the chunks are graphs and read their seeds from the
    # chunk's table and generators; on the CPU they run step by step and
    # hash their keys on the host: the fault goes where the seeds come from
    patches = ([(collectives.ChunkKeys, "fill", fill_off),
                (train._MultiStep, "_replay", replay_traced)]
               if group.device.type == "cuda"
               else [(train, "quant_key", key_off)])
    report = _patched_train_rank(group, args, params, attn_impl, patches)
    report["rank_info"]["replay_profile"] = found.get("profile")
    return report


RANK_MODES.update(eager_chunks=eager_chunks_rank, keys_off=keys_off_rank)


def drop_checkpoint(group, directory: str, step: int) -> bool:
    """(c): remove the checkpoint of ``step`` (rank 0; every rank waits):
    the next run resumes from the one before it."""
    import shutil
    if group.rank == 0:
        shutil.rmtree(os.path.join(directory, str(step)))
    group.barrier()
    return True


def dp_step_transport_calls(num_buckets: int, bucket_elems: int, world: int,
                            wire: str) -> list:
    """The ``(kind, bytes)`` of the transport calls of one train step at
    dp = ``world`` (sp 1) on the fused schedule, in order: the global
    token count's all_gather, the sync's (f32: the all_to_all of the
    flattened buckets padded to a multiple of the ranks and the
    all_gather of this rank's share; int8 and ef8: the int8 values' and
    the f32 scales' all_to_all over the bucket rows padded to a multiple
    of the ranks, then their all_gathers of this rank's rows), and the
    metrics' all_gather (loss, aux, dispatch)."""
    calls = [("all_gather", 4)]
    if wire in ("none", "f32"):
        total = num_buckets * bucket_elems
        padded = total + (-total) % world
        calls += [("all_to_all", 4 * padded),
                  ("all_gather", 4 * padded // world)]
    else:
        rows = num_buckets + (-num_buckets) % world
        scale_cols = 1 if wire == "int8" else -(-bucket_elems // EF_BLOCK)
        calls += [("all_to_all", rows * bucket_elems),
                  ("all_to_all", 4 * rows * scale_cols),
                  ("all_gather", rows // world * bucket_elems),
                  ("all_gather", 4 * rows // world * scale_cols)]
    return calls + [("all_gather", 12)]


def replay_transport_counts(calls: list, world: int, steps: int,
                            chunk: int) -> dict:
    """What one replay of ``steps`` steps enqueues on rank 0's transport
    (``transport.counts()`` and the stream waits), each step making
    ``calls`` (:func:`dp_step_transport_calls`) on a buffer past its
    first two chunks a pair (every push then waits for its half)."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    out = dict.fromkeys(("transport_calls", "transport_launches",
                         "transport_copies", "transport_bytes",
                         "stream_waits"), 0)
    past = dict.fromkeys(range(world), 2)
    for kind, nbytes in calls:
        rt = transport.routes(kind, 0, world, nbytes)
        ops = transport.rank_plan([p for p, _ in rt["sends"]],
                                  [p for p, _ in rt["recvs"]],
                                  rt["pair_bytes"], past, past, chunk)
        moves = [op for op in ops if op[0] != "wait"]
        out["transport_calls"] += 1
        out["transport_launches"] += len(moves)
        out["transport_copies"] += (len(rt["local"])
                                    + sum(len(op[2]) for op in moves))
        out["transport_bytes"] += rt["pair_bytes"] * len(rt["recvs"])
        out["stream_waits"] += len(ops) - len(moves)
    return {k: v * steps for k, v in out.items()}


def a5r_argv(base: list, steps: int, wire: str, spd: int) -> list:
    """A phase 23 train argv: ``base`` for ``steps`` steps under the
    cosine schedule on ``wire``, ``spd`` steps a dispatch."""
    return (with_steps(base, steps) + A5R_SCHEDULE
            + ["--grad-quant", wire, "--steps-per-dispatch", str(spd)])


def with_layers(argv: list, layers: int) -> list:
    """``argv`` with its ``--n-layers`` value replaced."""
    out = list(argv)
    out[out.index("--n-layers") + 1] = str(layers)
    return out


def a5r_pair(name: str, graph: dict, eager: dict, spd: int) -> dict:
    """A graphed run against its eager reference: losses, every rank's
    parameter checksum and ef8 residual checksum bitwise; the replays,
    the kernel launches a replay (n_layers x spd of each flash kernel on
    one rank; at sp > 1 rank r's ring launches n_layers x (r + 1) x
    spd), the boundary and capture times."""
    steps = graph["config"]["steps"]
    layers = graph["config"]["n_layers"]
    sp = graph["config"]["sp"]
    ranks, eranks = graph["ranks"], eager["ranks"]
    multi = [r["multi_step"] for r in ranks]
    row = {
        "run": name, "steps": steps, "steps_per_dispatch": spd,
        "losses": graph["losses"], "eager_losses": eager["losses"],
        "losses_bitwise": graph["losses"] == eager["losses"],
        "param_checksums": [r["param_checksum"] for r in ranks],
        "params_bitwise": ([r["param_checksum"] for r in ranks]
                           == [r["param_checksum"] for r in eranks]),
        "wall_ms_per_step": graph["wall_ms_per_step"],
        "eager_wall_ms_per_step": eager["wall_ms_per_step"],
        "replays": [m["graph_replays"] for m in multi],
        "capture_seconds": [m["capture_seconds"] for m in multi],
        "boundary_ms": [m["boundary_ms"] for m in multi],
        "captured_launches": [m["captured_launches"] for m in multi],
        "stream_waits_per_replay": [m["stream_waits_per_replay"]
                                    for m in multi],
        "transport_per_replay": [m["transport_per_replay"] for m in multi],
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks]}
    if "residual_checksum" in ranks[0]:
        row["residual_checksums"] = [r["residual_checksum"] for r in ranks]
        row["residuals_bitwise"] = row["residual_checksums"] == [
            r["residual_checksum"] for r in eranks]
    bad = [k for k in ("losses_bitwise", "params_bitwise",
                       "residuals_bitwise") if row.get(k) is False]
    want_replays = steps // spd if DEVICE == "cuda" else 0
    if any(n != want_replays for n in row["replays"]):
        bad.append(f"replays {row['replays']}, expected {want_replays}")
    if DEVICE == "cuda":
        for r, got in enumerate(row["captured_launches"]):
            want = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                                 0 if sp > 1 else layers * spd)
            if sp > 1:
                want.update(dict.fromkeys(("ring_fwd", "ring_dq",
                                           "ring_dkv"),
                                          layers * (r % sp + 1) * spd))
            if any(got[k] != v for k, v in want.items()):
                bad.append(f"rank {r} launches a replay {got}, expected "
                           f"{want}")
    emit("a5_ranks_graph", **row)
    if bad:
        raise AssertionError(f"phase 23 {name}: the graphed run against "
                             f"the eager one: {bad}")
    return row


def phase_a5_ranks(torch) -> dict:
    """Phase 23: ``train --steps-per-dispatch`` across ranks on the ipc
    transport, each chunk one CUDA graph replay on every rank (see the
    module docstring). Returns rank 0's main-path launches: flash, ring,
    the sync kernels' and the transport's."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    t0 = time.perf_counter()
    # what this process still holds on the card beside the two ranks
    held_gb = (torch.cuda.memory_allocated() / 1e9 if DEVICE == "cuda"
               else None)
    work = tempfile.mkdtemp(prefix="a5r-")
    ckpt = os.path.join(work, "ckpt")
    resume = a5r_argv(with_layers(DP_ARGV, A5R_RESUME_LAYERS), 2 * A5R_SPD,
                      "ef8", A5R_SPD) + ["--ckpt-dir", ckpt,
                                         "--ckpt-every", str(A5R_SPD)]
    jobs, names = [], []
    for wire, steps in A5R_WIRES:
        args = parse(a5r_argv(DP_ARGV, steps, wire, A5R_SPD))
        jobs += [("train", args, None), ("train", args, "eager_chunks")]
        names += [wire, f"{wire} eager"]
    jobs += [("train", parse(a5r_argv(DP_ARGV, 2 * A5R_SPD, "ef8", A5R_SPD)),
              "keys_off"),
             ("train", parse(resume), None),
             ("call", drop_checkpoint, (ckpt, 2 * A5R_SPD - 1)),
             ("train", parse(resume), None)]
    names += ["control", "uninterrupted", "drop", "resumed"]
    try:
        runs = dict(zip(names, spawn_batch(torch, jobs)))
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    sp_argv = a5r_argv(with_layers(SP_ARGV, A5R_SP_LAYERS), 2 * A5R_SP_SPD,
                       "none", A5R_SP_SPD) + ["--sp", str(SP_WORLD),
                                              "--dist-backend", DIST]
    sp_runs = spawn_batch(torch, [("train", parse(sp_argv), None),
                                  ("train", parse(sp_argv), "eager_chunks")],
                          sp=SP_WORLD)
    rows, totals = {}, {"flash": dict.fromkeys(FLASH_REPLACES, 0),
                        "ring": dict.fromkeys(RING_REPLACES, 0),
                        "sync": dict.fromkeys(SYNC_KERNELS, 0),
                        "transport": 0}
    for wire, steps in A5R_WIRES:
        graph, eager = runs[wire][0], runs[f"{wire} eager"][0]
        row = a5r_pair(wire, graph, eager, A5R_SPD)
        cfg = graph["config"]
        num_buckets = -(-cfg["params"] // cfg["bucket_elems"])
        per_sync = expected_sync_launches(cfg["grad_transport"], "fused",
                                          DP_WORLD, num_buckets)
        # a replay's syncs, and the warm-up step's before the capture (the
        # CPU's wrappers run the plain versions and count nothing)
        want_sync = {k: v * (steps + 1) if DEVICE == "cuda" else 0
                     for k, v in per_sync.items()}
        calls = dp_step_transport_calls(num_buckets, cfg["bucket_elems"],
                                        DP_WORLD, wire)
        want_tp = replay_transport_counts(
            calls, DP_WORLD, A5R_SPD, chunk_of(DP_WORLD))
        row.update(expected_sync_launches=want_sync,
                   sync_launches=graph["sync_launches"],
                   expected_transport_per_replay=want_tp)
        emit("a5_ranks_counts", run=wire, **{k: row[k] for k in (
            "sync_launches", "expected_sync_launches",
            "transport_per_replay", "expected_transport_per_replay")})
        got_tp = row["transport_per_replay"][0]
        if graph["sync_launches"] != want_sync or (
                DIST == "ipc" and got_tp != want_tp):
            raise AssertionError(
                f"phase 23 {wire}: sync launches {graph['sync_launches']} "
                f"(expected {want_sync}), a replay's transport {got_tp} "
                f"(expected {want_tp})")
        rows[wire] = row
        for k in SYNC_KERNELS:
            totals["sync"][k] += graph["sync_launches"][k]
        for k in FLASH_REPLACES:
            totals["flash"][k] += graph["launches"][k]
        totals["transport"] += graph["transport"]["transport_launches"]
    # (b) the ring kernels and ppermute inside the graph
    sp_row = a5r_pair("gqa4 sp=2 bf16", sp_runs[0][0], sp_runs[1][0],
                      A5R_SP_SPD)
    for k in RING_REPLACES:
        totals["ring"][k] += sp_runs[0][0]["ring_launches"][k]
    totals["transport"] += sp_runs[0][0]["transport"]["transport_launches"]
    # (c) resumed at the chunk boundary against the uninterrupted run
    whole, resumed = runs["uninterrupted"][0], runs["resumed"][0]
    tail = whole["losses"][A5R_SPD:]
    c_row = {"uninterrupted_losses": whole["losses"],
             "resumed_losses": resumed["losses"],
             "resumed_start_step": resumed["config"]["start_step"],
             "losses_bitwise": resumed["losses"] == tail,
             "params_bitwise": [r["param_checksum"] for r in resumed["ranks"]]
             == [r["param_checksum"] for r in whole["ranks"]],
             "residuals_bitwise": [r["residual_checksum"]
                                   for r in resumed["ranks"]]
             == [r["residual_checksum"] for r in whole["ranks"]],
             "resumed_replays": [r["multi_step"]["graph_replays"]
                                 for r in resumed["ranks"]]}
    emit("a5_ranks_resume", **c_row)
    if (c_row["resumed_start_step"] != A5R_SPD or not all(
            c_row[k] for k in ("losses_bitwise", "params_bitwise",
                               "residuals_bitwise"))):
        raise AssertionError(f"phase 23 (c): the resumed run against the "
                             f"uninterrupted one: {c_row}")
    # (d) one rank's seeds a step off: outside the bitwise check
    control = runs["control"][0]
    d_row = {"control_losses": control["losses"],
             "eager_losses": rows["ef8"]["eager_losses"],
             "control_rank": A5R_CONTROL_RANK,
             "control_passed": control["losses"]
             == rows["ef8"]["eager_losses"],
             "replay_profile": control["ranks"][0].get("replay_profile")}
    emit("a5_ranks_control", **d_row)
    if d_row["control_passed"]:
        raise AssertionError(f"phase 23 (d): seeds a step off landed "
                             f"inside the bitwise check: {d_row}")
    seconds = time.perf_counter() - t0
    emit("a5_ranks_summary", seconds=seconds, limit_s=A5R_SECONDS,
         wall_ms_per_step={w: (r["wall_ms_per_step"],
                               r["eager_wall_ms_per_step"])
                           for w, r in rows.items()},
         boundary_ms={w: r["boundary_ms"][0] for w, r in rows.items()},
         capture_seconds={w: r["capture_seconds"][0]
                          for w, r in rows.items()},
         stream_waits_per_replay={w: r["stream_waits_per_replay"][0]
                                  for w, r in rows.items()},
         sp_wall_ms_per_step=(sp_row["wall_ms_per_step"],
                              sp_row["eager_wall_ms_per_step"]),
         spawn_seconds={name: run[1] for name, run in runs.items()},
         peak_memory_gb_per_rank={w: r["peak_memory_gb_per_rank"]
                                  for w, r in rows.items()},
         parent_memory_gb=held_gb,
         script_seconds=time.perf_counter() - T_START)
    if seconds > A5R_SECONDS:
        raise AssertionError(f"phase 23 took {seconds:.1f} s, over its "
                             f"{A5R_SECONDS} s")
    return totals


# -- phase 24: the serving of ROADMAP A6, part 2 ----------------------------

def a24_selfcheck(torch) -> dict:
    """(a) ``cli serve --selfcheck --chaos A24_CHAOS_SEED`` in process at
    each of ``A24_CHAOS_STEPS``: its report must say ok."""
    from akka_allreduce_tpu_torch import cli
    out = {}
    for steps in A24_CHAOS_STEPS:
        args = cli.build_parser().parse_args(
            ["serve", "--selfcheck", "--chaos", str(A24_CHAOS_SEED),
             "--decode-steps", str(steps), "--device", DEVICE])
        t0 = time.perf_counter()
        out[steps] = cli.run_chaos_selfcheck(args)
        emit("a24_selfcheck", seconds=time.perf_counter() - t0,
             **out[steps])
        if out[steps]["selfcheck"] != "ok":
            raise AssertionError(f"phase 24 (a), decode steps {steps}: "
                                 f"{out[steps]['failures']}")
    return out


def a24_args(torch, extra: list):
    from akka_allreduce_tpu_torch import cli
    return cli.build_parser().parse_args(
        set_flag(SERVE_ARGV, "--device", DEVICE)
        + ["--paged-attention", "kernel"] + extra)


def a24_requests(args) -> list:
    from akka_allreduce_tpu_torch import cli
    return cli.make_requests(args, *cli._validate(args))


def a24_stream_check(torch, params, cfg, reqs: dict, want: dict, got: dict,
                     rids) -> dict:
    """``got``'s streams of ``rids`` against the fault-free ``want``:
    (bitwise count, ``greedy_agree`` failures)."""
    from akka_allreduce_tpu_torch.parity import greedy_agree
    bitwise, failures = 0, []
    for rid in sorted(rids):
        ref, toks = want[rid][0], got[rid][0]
        if list(toks) == list(ref):
            bitwise += 1
            continue
        ok, why = greedy_agree(ref, toks, reference_logits(
            torch, params, cfg, reqs[rid].prompt, ref))
        if not ok:
            failures.append((rid, why))
    return {"requests": len(list(rids)), "bitwise": bitwise,
            "failures": failures}


def a24_faults(torch) -> dict:
    """(b) the gqa4 paged-kernel engine under ``FaultPlan.chaos``: a hang
    held past the watchdog, a raise, a NaN lane and a preemption whose
    snapshots are restored into a fresh engine; the fault-free run first
    (the warm-up, no watchdog), then the armed run with row 13's count
    set to 0."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.runtime.faults import FaultPlan
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    from akka_allreduce_tpu_torch.serving import (RequestScheduler,
                                                  RetryPolicy,
                                                  SchedulerConfig,
                                                  ServingMetrics)
    warm_args = a24_args(torch, [])
    args = a24_args(torch, ["--watchdog-timeout", str(A24_WATCHDOG_S)])
    mcfg, params = cli.serve_model(args, torch.device(DEVICE))
    reqs = {r.rid: r for r in a24_requests(args)}
    scfg = SchedulerConfig(retry=RetryPolicy(max_attempts=4,
                                             base_delay=0.0))

    def sched_of():
        sched = RequestScheduler(scfg, num_slots=args.slots)
        for r in a24_requests(args):
            sched.submit(r)
        return sched

    t0 = time.perf_counter()
    base, _, _ = cli.serve_until_done(
        lambda: cli.build_engine(warm_args, params, mcfg), sched_of())
    sync(torch)
    t_base = time.perf_counter() - t0
    plan = cli.held_hang_plan(FaultPlan.chaos(A24_CHAOS_SEED,
                                              slots=args.slots).points,
                              seed=A24_CHAOS_SEED)
    tracer = Tracer()
    metrics = ServingMetrics(tracer=tracer)
    for rid in reqs:
        metrics.on_submit(rid)
    pool_after_recover = []

    def make_engine():
        engine = cli.build_engine(args, params, mcfg)
        recover = engine._recover

        def recover_and_look(reason):
            out = recover(reason)
            pool_after_recover.append((engine.pool.pages_in_use,
                                       engine.pool.free_pages,
                                       engine.pool.capacity))
            return out
        engine._recover = recover_and_look
        return engine

    attention.PAGED_ATTENTION_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        got, engines, restored = cli.serve_until_done(
            make_engine, sched_of(), metrics=metrics, plan=plan,
            max_dispatches=2000)
        sync(torch)
        t_chaos = time.perf_counter() - t0
        # the live state of every engine, before the abandoned dispatch
        # wakes: it must write only into the tensors it was given
        live = [{n: e._state[n].clone() for n in ("k", "v")}
                for e in engines]
    finally:
        plan.release.set()
    # the abandoned dispatches wake now and run to their readback (one
    # cancelled before its thread took it never runs)
    abandoned = [f for e in engines for f in e.abandoned]
    for fut in abandoned:
        if not fut.cancelled():
            fut.result(timeout=60)
    abandoned = [f for f in abandoned if not f.cancelled()]
    sync(torch)
    for e in engines:
        e.close()
    launches = attention.PAGED_ATTENTION_LAUNCHES
    metrics.on_fault_injected(len(plan.fired))
    dispatches = sum(e.decode_dispatches for e in engines)
    expected = mcfg.n_layers * args.decode_steps * (dispatches
                                                    + len(abandoned))
    untouched = all(torch.equal(e._state[n], st[n])
                    for e, st in zip(engines, live) for n in st)
    ends = collections.Counter(
        ev.fields["rid"] for ev in tracer.events
        if ev.kind in ("serve_complete", "serve_drop"))
    failed = {ev.fields["rid"] for ev in tracer.events
              if ev.kind == "serve_failure"}
    kinds = {k for _site, k, _hit in plan.fired}
    retried = failed - restored
    parity = {
        "restored": a24_stream_check(torch, params, mcfg, reqs, base, got,
                                     restored),
        "retried": a24_stream_check(torch, params, mcfg, reqs, base, got,
                                    retried),
        "untouched": a24_stream_check(torch, params, mcfg, reqs, base, got,
                                      set(reqs) - failed - restored)}
    # the control: the restored stream with the most replayed tokens,
    # less the last of them (dropping it from the snapshot instead would
    # only make the restore generate it again)
    replayed = {rr.req.rid: len(rr.generated) for e in engines
                for rr in e.drained}
    victim = max(replayed, key=replayed.get, default=None)
    control = {"failures": []}
    if victim is not None and replayed[victim]:
        cut = replayed[victim]
        toks = got[victim][0]
        control = a24_stream_check(
            torch, params, mcfg, reqs, base,
            {victim: (toks[:cut - 1] + toks[cut:], got[victim][1])},
            [victim])
    out = {"seconds": {"fault_free": t_base, "chaos": t_chaos},
           "faults_fired": [list(f) for f in plan.fired],
           "watchdog_s": A24_WATCHDOG_S,
           "watchdog_trips": metrics.watchdog_trips_total,
           "failed_attempts": metrics.requests_failed,
           "retries": metrics.retries_total,
           "dead_letters": metrics.dead_letter_total,
           "fault_injected": metrics.fault_injected,
           "fault_survived": metrics.fault_survived,
           "engines": len(engines), "restored": sorted(restored),
           "retried": sorted(retried), "ends": dict(ends),
           "pool_after_recover": pool_after_recover,
           "pool_at_end": [(e.pool.pages_in_use, e.pool.capacity)
                           for e in engines],
           "launches": launches, "expected_launches": expected,
           "decode_dispatches": dispatches,
           "abandoned_dispatches": len(abandoned),
           "live_state_untouched": untouched, "parity": parity,
           "control": {"rid": victim,
                       "replayed_tokens": replayed.get(victim),
                       "passed": not control["failures"],
                       "failures": control["failures"]}}
    emit("a24_faults", **out)
    fail = []
    if not {"hang", "raise", "nan", "preempt"} <= kinds:
        fail.append(f"not every fault fired: {plan.fired}")
    if set(got) != set(reqs) or any(ends[r] != 1 for r in reqs):
        fail.append(f"rids did not each end once: {dict(ends)}")
    if metrics.watchdog_trips_total != 1:
        fail.append(f"{metrics.watchdog_trips_total} watchdog trips")
    if metrics.retries_total + metrics.dead_letter_total \
            != metrics.requests_failed:
        fail.append("retries + dead letters != failed attempts")
    if metrics.fault_injected != metrics.fault_survived:
        fail.append("faults injected != survived")
    if not pool_after_recover or any(
            used or free != cap for used, free, cap in pool_after_recover):
        fail.append(f"pool not back to capacity: {pool_after_recover}")
    if any(used for used, _ in out["pool_at_end"]):
        fail.append(f"pages held at the end: {out['pool_at_end']}")
    if not restored or not retried:
        fail.append(f"no restored ({restored}) or retried ({retried}) "
                    f"request to hold")
    for kind in ("restored", "retried", "untouched"):
        if parity[kind]["failures"]:
            fail.append(f"{kind} streams disagree: {parity[kind]}")
    for kind in ("retried", "untouched"):
        # a retry replays from scratch through the same shapes
        if parity[kind]["bitwise"] != parity[kind]["requests"]:
            fail.append(f"{kind} streams not bitwise: {parity[kind]}")
    if DEVICE == "cuda" and (launches != expected or launches == 0):
        fail.append(f"paged_attention launched {launches}, expected "
                    f"{expected}")
    if not untouched:
        fail.append("the abandoned dispatch wrote into a live engine")
    if out["control"]["passed"]:
        fail.append("the control (a restored stream less one token) "
                    "passed the comparison")
    if fail:
        raise AssertionError("phase 24 (b): " + "; ".join(fail))
    return {"launches": launches, "params": params, "cfg": mcfg,
            "base": base, "reqs": reqs}


def a24_interleaved(torch, params, mcfg) -> dict:
    """(c)'s A/B on one engine: 8 lanes of the load's first requests, at
    ``A24_AB_TOKENS`` tokens each, decoded in blocks of ``A24_AB_BLOCK``
    dispatches with the watchdog off and on in turns (unarmed, armed,
    then armed, unarmed), each block's wall ms a decode step to a
    synchronize; then a torch.profiler window of ``A24_PROFILE_STEPS``
    dispatches each way (wall and device ms a step). Row 13's launches
    are counted."""
    import dataclasses

    from akka_allreduce_tpu_torch import cli
    args = a24_args(torch, [])
    engine = cli.build_engine(args, params, mcfg)
    for r in a24_requests(args)[:engine.num_slots]:
        engine.admit(dataclasses.replace(r, max_new_tokens=A24_AB_TOKENS))
    ecfg = {"unarmed": engine.ecfg,
            "armed": dataclasses.replace(
                engine.ecfg, watchdog_timeout_s=A24_COST_WATCHDOG_S)}
    steps = engine.ecfg.decode_steps

    def run(kind: str, n: int) -> float:
        engine.ecfg = ecfg[kind]
        sync(torch)
        t0 = time.perf_counter()
        for _ in range(n):
            if engine.step():
                raise AssertionError("phase 24 (c): a lane finished or "
                                     "failed inside the A/B")
        sync(torch)
        return (time.perf_counter() - t0) * 1e3 / (n * steps)

    run("armed", 1)  # the guard thread is made outside the timing
    run("unarmed", 1)
    blocks = collections.defaultdict(list)
    for i in range(A24_AB_ROUNDS):
        for kind in (("unarmed", "armed") if i % 2 == 0
                     else ("armed", "unarmed")):
            blocks[kind].append(run(kind, A24_AB_BLOCK))
    profiles = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for kind in ("unarmed", "armed"):
        with torch.profiler.profile(activities=acts) as prof:
            wall_ms = run(kind, A24_PROFILE_STEPS)
        rows = device_kernel_rows(torch, prof.key_averages(),
                                  A24_PROFILE_STEPS * steps)
        device_ms = sum(ms for _, ms in rows)
        profiles[kind] = {
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if rows else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured"}
    engine.close()
    med = {k: statistics.median(v) for k, v in blocks.items()}
    return {"blocks_ms_per_step": dict(blocks), "median_ms_per_step": med,
            "quartiles_ms_per_step": {
                k: statistics.quantiles(v, n=4)[::2]
                for k, v in blocks.items()},
            "armed_over_unarmed": med["armed"] / med["unarmed"],
            "profiles": profiles,
            "dispatches": engine.decode_dispatches}


def a24_handoff_us() -> float:
    """What the guard thread adds to a dispatch apart from where the
    dispatch runs: one submit to a one-thread executor and one wait for
    its result, µs each (``A24_HANDOFF_REPS`` no-op calls)."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ex.submit(int).result()
        t0 = time.perf_counter()
        for _ in range(A24_HANDOFF_REPS):
            ex.submit(int).result(timeout=A24_COST_WATCHDOG_S)
        return (time.perf_counter() - t0) * 1e6 / A24_HANDOFF_REPS


def a24_cost(torch, faults: dict) -> dict:
    """(c) the watchdog's cost: the same requests served end to end
    unarmed and armed (``A24_COST_WATCHDOG_S``, no faults) in turns, the
    tokens (b)'s fault-free ones, each run's wall ms a decode step from
    the device timer (host + device means of a dispatch) and TPOT; then
    the interleaved A/B on one engine (``a24_interleaved``). Row 13's
    count is set to 0 before each run and read after it."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.serving import (RequestScheduler,
                                                  SchedulerConfig,
                                                  ServingMetrics,
                                                  serve_loop)
    params, mcfg = faults["params"], faults["cfg"]
    argv = {"unarmed": [],
            "armed": ["--watchdog-timeout", str(A24_COST_WATCHDOG_S)]}
    runs, launches = collections.defaultdict(list), 0
    for kind in A24_COST_TURNS:
        args = a24_args(torch, argv[kind])
        engine = cli.build_engine(args, params, mcfg)
        metrics = ServingMetrics()
        sched = RequestScheduler(SchedulerConfig(), num_slots=args.slots)
        for r in a24_requests(args):
            metrics.on_submit(r.rid)
            sched.submit(r)
        attention.PAGED_ATTENTION_LAUNCHES = 0
        results = serve_loop(engine, sched, metrics=metrics)
        sync(torch)
        launches += attention.PAGED_ATTENTION_LAUNCHES
        engine.close()
        dt = engine.device_time_summary()
        per_dispatch = dt["host_ms"]["mean"] + dt["device_ms"]["mean"]
        runs[kind].append({
            "dispatch_wall_ms_per_step": per_dispatch / args.decode_steps,
            "host_ms_p50": dt["host_ms"]["p50"],
            "device_ms_p50": dt["device_ms"]["p50"],
            "tpot_ms_p50": metrics.summary()["tpot_ms"].get("p50"),
            "decode_dispatches": engine.decode_dispatches,
            "watchdog_trips": engine.watchdog_trips})
        if engine.watchdog_trips or any(
                results[r][0] != faults["base"][r][0] for r in results):
            raise AssertionError(f"phase 24 (c), {kind}: a trip or "
                                 f"tokens off the fault-free run")
    attention.PAGED_ATTENTION_LAUNCHES = 0
    ab = a24_interleaved(torch, params, mcfg)
    launches += attention.PAGED_ATTENTION_LAUNCHES
    mean = {k: statistics.mean(r["dispatch_wall_ms_per_step"]
                               for r in runs[k]) for k in runs}
    out = {"runs": dict(runs), "wall_ms_per_step": mean,
           "runs_armed_over_unarmed": mean["armed"] / mean["unarmed"],
           "interleaved": ab, "handoff_us_per_dispatch": a24_handoff_us()}
    emit("a24_watchdog_cost", **out)
    return {**out, "launches": launches}


class MetadataServer:
    """A 127.0.0.1 stand-in for the GCE metadata endpoint that
    ``--preempt-poll`` reads: ``FALSE``, and once armed ``TRUE`` from the
    ``trip_at``-th GET on (counted from the arming)."""

    def __init__(self):
        import http.server
        import threading
        self.gets, self.armed_at, self.trip_at = 0, None, 0
        server_self = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - the stdlib's name
                server_self.gets += 1
                tripped = server_self.armed_at is not None and (
                    server_self.gets - server_self.armed_at
                    >= server_self.trip_at)
                body = b"TRUE" if tripped else b"FALSE"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = (f"http://127.0.0.1:{self.httpd.server_address[1]}"
                    f"/computeMetadata/v1/instance/preempted")
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def arm(self, trip_at: int) -> None:
        self.armed_at, self.trip_at = self.gets, trip_at

    def disarm(self) -> None:
        self.armed_at = None

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)


# a ``cli serve`` child: ``run_serve`` (what ``cli serve`` runs) with the
# per-request streams written to argv[1] beside the printed report
SERVE_CHILD = (
    "import json, sys\n"
    "from akka_allreduce_tpu_torch import cli\n"
    "args = cli.build_parser().parse_args(sys.argv[2:])\n"
    "report, results, _ = cli.run_serve(args)\n"
    "print(json.dumps(report), flush=True)\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump({r: [list(t), why] for r, (t, why) in results.items()},"
    " f)\n")


def a24_child(argv: list, results_path: str) -> "tuple[dict, dict]":
    """Run one ``cli serve`` child to its end: (report, {rid: (tokens,
    reason)})."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    out = subprocess.run([sys.executable, "-c", SERVE_CHILD, results_path,
                          *argv], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=A24_CHILD_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"phase 24 (d): a serve child exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    with open(results_path) as f:
        results = {int(r): (t, why) for r, (t, why) in json.load(f).items()}
    return json.loads(out.stdout.strip().splitlines()[-1]), results


def a24_processes(torch, faults: dict) -> dict:
    """(d) two ``cli serve`` children on one drain directory, polling a
    local metadata server: child 1 (``A24_CHILD_REQUESTS`` requests, all
    in flight on the 8 lanes) is drained by the poll, child 2 restores
    them (and serves one fresh request); (e) child 2's trace and metrics
    snapshot against its report."""
    from akka_allreduce_tpu_torch.runtime.checkpoint import load_state_json
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    from akka_allreduce_tpu_torch.serving import DRAIN_STATE_NAME
    from akka_allreduce_tpu_torch.telemetry.registry import \
        parse_prometheus_text
    server = MetadataServer()
    try:
        with tempfile.TemporaryDirectory(prefix="a24-") as work:
            def argv(n: int, name: str) -> list:
                return set_flag(SERVE_ARGV, "--device", DEVICE) + [
                    "--paged-attention", "kernel", "--requests", str(n),
                    "--drain-dir", os.path.join(work, "drain"),
                    "--preempt-poll", server.url, "--preempt-interval",
                    str(A24_PREEMPT_INTERVAL_S),
                    "--trace-file", os.path.join(work, f"{name}.jsonl"),
                    "--metrics-file", os.path.join(work, f"{name}.prom")]
            server.arm(A24_PREEMPT_AT_POLL)
            t0 = time.perf_counter()
            rep1, res1 = a24_child(argv(A24_CHILD_REQUESTS, "child1"),
                                   os.path.join(work, "child1.json"))
            t1 = time.perf_counter()
            server.disarm()
            drained = load_state_json(os.path.join(work, "drain"),
                                      DRAIN_STATE_NAME)
            rep2, res2 = a24_child(argv(1, "child2"),
                                   os.path.join(work, "child2.json"))
            t2 = time.perf_counter()
            cleared = load_state_json(os.path.join(work, "drain"),
                                      DRAIN_STATE_NAME) is None
            trace = Tracer.read_jsonl(os.path.join(work, "child2.jsonl"))
            with open(os.path.join(work, "child2.prom")) as f:
                snap2 = parse_prometheus_text(f.read())
            with open(os.path.join(work, "child1.prom")) as f:
                snap1 = parse_prometheus_text(f.read())
    finally:
        server.close()
    reqs, base = faults["reqs"], faults["base"]
    first = set(range(A24_CHILD_REQUESTS))
    resumed = {e["req"]["rid"] for e in (drained or {"requests": []})
               ["requests"]}
    generated = {e["req"]["rid"]: len(e["generated"])
                 for e in (drained or {"requests": []})["requests"]}
    fresh = A24_CHILD_REQUESTS  # child 2's own request: prompt of rid 0
    parity = a24_stream_check(torch, faults["params"], faults["cfg"], reqs,
                              base, res2, resumed)
    fresh_bitwise = res2.get(fresh, ([], None))[0] == base[0][0]
    kinds = collections.Counter(ev["kind"] for ev in trace)
    counters = {
        "serve_submitted_total": rep2["requests"]["submitted"],
        "serve_completed_total": rep2["requests"]["completed"],
        "serve_failed_attempts_total": rep2["requests"]["failed_attempts"],
        "serve_retries_total": rep2["faults"]["retries_total"],
        "serve_watchdog_trips_total": rep2["faults"]["watchdog_trips_total"],
        "serve_dead_letter_total": rep2["faults"]["dead_letter_total"],
        "serve_fault_survived_total": rep2["faults"]["fault_survived"],
        "serve_prefill_tokens_total": rep2["tokens"]["prefill"],
        "serve_decode_tokens_total": rep2["tokens"]["decode"],
        "serve_wasted_tokens_total": rep2["tokens"]["wasted"],
        "serve_drain_persisted_total": rep2["drain_persisted"]}
    snap_off = {k: (snap2.get((k, ())), v) for k, v in counters.items()
                if snap2.get((k, ())) != v}
    out = {"seconds": {"child1": t1 - t0, "child2": t2 - t1},
           "child1": {"drained": rep1["drained"],
                      "drain_persisted": rep1["drain_persisted"],
                      "preempt_notice": rep1.get("preempt_notice"),
                      "preempt_polls": rep1.get("preempt_polls"),
                      "completed": sorted(res1),
                      "generated_at_drain": generated,
                      "snapshot_drain_persisted": snap1.get(
                          ("serve_drain_persisted_total", ()))},
           "child2": {"resumed": rep2["resumed"],
                      "preempt_notice": rep2.get("preempt_notice"),
                      "completed": sorted(res2),
                      "decode_dispatches": rep2["decode_dispatches"],
                      "prefill_dispatches": rep2["prefill_dispatches"],
                      "device_time": rep2["device_time"]},
           "drain_file_cleared": cleared, "parity": parity,
           "fresh_request_bitwise": fresh_bitwise,
           "trace": {"serve_step": kinds["serve_step"],
                     "serve_prefill": kinds["serve_prefill"],
                     "engine_dispatch": kinds["engine_dispatch"]},
           "snapshot_counters_off": snap_off}
    emit("a24_processes", **out)
    fail = []
    if not rep1["drained"] or not rep1.get("preempt_notice"):
        fail.append("child 1 was not drained by the poll")
    if rep1["drain_persisted"] != rep1["drained"] \
            or snap1.get(("serve_drain_persisted_total", ())) \
            != rep1["drained"]:
        fail.append("drain_persisted != drained")
    if rep2["resumed"] != rep1["drained"] or len(resumed) != rep1["drained"]:
        fail.append("resumed != drained")
    if not cleared:
        fail.append("the drain file outlived child 2")
    if rep2.get("preempt_notice"):
        fail.append("child 2 saw a preemption notice")
    done1, done2 = set(res1), set(res2) - {fresh}
    if done1 & done2 or done1 | done2 != first or set(res2) - first \
            != {fresh} or done2 != resumed:
        fail.append(f"rids did not each finish once: {sorted(done1)} / "
                    f"{sorted(res2)}")
    if parity["failures"]:
        fail.append(f"restored streams disagree: {parity['failures']}")
    if not fresh_bitwise:
        fail.append("child 2's fresh request is not the fault-free rid 0")
    if kinds["serve_step"] != rep2["decode_dispatches"] \
            or kinds["serve_prefill"] != rep2["prefill_dispatches"]:
        fail.append(f"trace spans {dict(kinds)} against the report")
    if snap_off:
        fail.append(f"snapshot counters off the report: {snap_off}")
    if fail:
        raise AssertionError("phase 24 (d)/(e): " + "; ".join(fail))
    return out


def phase_a24(torch) -> dict:
    """Phase 24: (a) the chaos selfcheck, (b) faults on the gqa4
    paged-kernel engine, (c) the watchdog's cost, (d) drain/restore
    across processes, (e) their trace and metrics."""
    t0 = time.perf_counter()
    a24_selfcheck(torch)
    ta = time.perf_counter()
    faults = a24_faults(torch)
    tb = time.perf_counter()
    cost = a24_cost(torch, faults)
    tc = time.perf_counter()
    processes = a24_processes(torch, faults)
    td = time.perf_counter()
    seconds = td - t0
    emit("a24_phase_seconds", seconds=seconds, selfcheck=ta - t0,
         faults=tb - ta, watchdog_cost=tc - tb, processes=td - tc,
         script_seconds=time.perf_counter() - T_START)
    if seconds > A24_SECONDS:
        raise AssertionError(f"phase 24 took {seconds:.1f} s, over its "
                             f"{A24_SECONDS} s")
    return {"launches": {"faults": faults["launches"],
                         "watchdog_cost": cost["launches"]},
            "cost": cost, "processes": processes}


# -- phase 25: expert and tensor parallelism (ROADMAP A7, part 1) ----------

A7_WORLD = 2
A7_MOE_FLAGS = ["--moe-experts", "8", "--router-k", "2",
                "--capacity-factor", "1.25", "--moe-every", "2"]
# (b) and (c): the flagship of phase 6, 3 steps, on the ep and tp axes
A7_STEPS = 3
A7_MOE_ARGV = TRAIN_ARGV + A7_MOE_FLAGS
A7_TP_ARGV = list(TRAIN_ARGV)
# (a): full width at depth 2, f32, one step: an ep=2 and a tp=2 step
# against the one-rank step on the same global batch; every gradient
# leaf within A7_GRAD_TOL of that leaf's largest value (f32, TF32 off:
# the sums differ in order only)
A7_PARITY_MODEL = dict(vocab_size=32768, d_model=2048, n_heads=16,
                       n_layers=2, d_ff=8192, max_seq=512, moe_every=2)
# capacity_factor n_experts / router_k: a capacity of N slots an expert,
# which cannot bind; no load-balance term (its statistics are a shard's,
# legitimately: the JAX gold test's setting)
A7_PARITY_MOE = dict(n_experts=8, d_ff=8192, capacity_factor=4.0,
                     router_k=2, aux_loss_coef=0.0)
A7_PARITY_BATCH = (2, 512)
A7_GRAD_TOL = 1e-4
# (d): phase 4's gqa4 serve model with every second layer MoE
A7_SERVE_ARGV = SERVE_ARGV + ["--moe-experts", "8", "--moe-every", "2",
                              "--router-k", "2", "--capacity-factor", "4.0"]
# (e): a tp=2 checkpoint at depth 2, restored by a one-rank generate
A7_CKPT_ARGV = ["train", "--d-model", "2048", "--n-heads", "16",
                "--n-layers", "2", "--d-ff", "8192", "--vocab", "32768",
                "--seq", "256", "--batch", "2", "--lr", "1e-4", "--steps",
                "2", "--log-every", "1", "--device", "cuda"]
A7_PROMPT = list(range(1, 9))
A7_GEN_TOKENS = 16
A7_CHILD_TIMEOUT_S = 300
A7_SECONDS = 250


def a7_model(torch, model: dict, moe: "dict | None", device):
    """(TrainConfig, the full tree from seed 0 on ``device``)."""
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer)
    from akka_allreduce_tpu_torch.parallel.ep import MoEConfig
    mcfg = TransformerConfig(**model,
                             moe=None if moe is None else MoEConfig(**moe))
    cfg = train.TrainConfig(model=mcfg, bucket_elems=BUCKET_ELEMS)
    return cfg, init_transformer(torch.Generator(device).manual_seed(0),
                                 mcfg, device)


def a7_fault(kind: str, group):
    """The fault control of (a): on ep, rank 0's outgoing all_to_all
    blocks swapped; on tp, the first forward tp sum of the step skipped
    on every rank (both ranks skip the same call: no rank waits on the
    other). Returns the undo."""
    from akka_allreduce_tpu_torch.parallel import ep as E
    from akka_allreduce_tpu_torch.parallel import tp as T
    if kind == "ep":
        real = E._AllToAll.forward
        line = group.along("ep")

        def swapped(ctx, blocks, g):
            return real(ctx, blocks.flip(0) if line.rank == 0 else blocks,
                        g)
        E._AllToAll.forward = staticmethod(swapped)
        return lambda: setattr(E._AllToAll, "forward", staticmethod(real))
    real = T._TpPsum.forward
    calls = []

    def skipped(ctx, x, g):
        calls.append(1)
        return x.clone() if len(calls) == 1 else real(ctx, x, g)
    T._TpPsum.forward = staticmethod(skipped)
    return lambda: setattr(T._TpPsum, "forward", staticmethod(real))


def a7_parity_rank(group, kind: str, model: dict, moe, batch) -> dict:
    """(a) on one rank: one grad step on this rank's shard (``kind`` "ep"
    or "tp" the mesh's sharded axis), its gradients gathered to the full
    layout, and the same step under the fault control; on rank 0 the
    one-rank step on the full tree and batch, and each run's largest
    leaf error relative to that leaf's largest reference value."""
    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.convert import gather_params
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    dev = group.device
    cfg, full = a7_model(torch, model, moe, dev)
    tokens = torch.from_numpy(np.array(batch)).to(dev)
    rows = tokens.shape[0] // group.axis_size("ep")
    r = group.axis_index("ep")
    mine = tokens[r * rows:(r + 1) * rows]
    state = train.make_train_state(cfg, params=full, device=dev,
                                   group=group)
    step = train.make_grad_step(cfg, group)
    out = {}
    for name, fault in (("sharded", False), ("control", True)):
        undo = a7_fault(kind, group) if fault else None
        try:
            grads, metrics = step(state.params, mine)
        finally:
            if undo is not None:
                undo()
        out[name] = (tree_leaves(gather_params(grads, cfg.model, group)),
                     float(metrics["dispatch_fraction"]))
        del grads
    res = {"dispatch_fraction": out["sharded"][1],
           "control_dispatch_fraction": out["control"][1]}
    del state
    if group.rank == 0:
        ref_state = train.make_train_state(cfg, params=full, device=dev)
        ref, _ = train.make_grad_step(cfg)(ref_state.params, tokens)
        ref = tree_leaves(ref)
        for name in ("sharded", "control"):
            res[f"{name}_rel_err"] = max(
                float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(out[name][0], ref))
    return res


def a7_parity(torch) -> dict:
    """(a): the ep=2 and the tp=2 step against the one-rank step."""
    import numpy as np
    rng = np.random.default_rng(0)
    batch = rng.integers(0, A7_PARITY_MODEL["vocab_size"],
                         size=A7_PARITY_BATCH, dtype=np.int32)
    rows = {}
    for kind, moe in (("ep", A7_PARITY_MOE), ("tp", None)):
        t0 = time.perf_counter()
        (ranks, _), = spawn_batch(
            torch, [("call", a7_parity_rank,
                     (kind, A7_PARITY_MODEL, moe, batch))],
            world=A7_WORLD, **{kind: A7_WORLD})
        row = {**ranks[0], "tol": A7_GRAD_TOL,
               "seconds": time.perf_counter() - t0,
               "dispatch_fractions": [r["dispatch_fraction"]
                                      for r in ranks]}
        row["held"] = (row["sharded_rel_err"] <= A7_GRAD_TOL
                       and all(d == 1.0 for d in row["dispatch_fractions"]))
        row["control_outside"] = row["control_rel_err"] > A7_GRAD_TOL
        emit("a7_parity", run=f"{kind}=2", **row)
        if not (row["held"] and row["control_outside"]):
            raise AssertionError(f"phase 25 (a) {kind}=2: {row}")
        rows[kind] = row
    return rows


class ExchangeTimer:
    """CUDA events around every call of the ep all_to_all and the two tp
    operators' sums, forward and backward (the patched
    ``autograd.Function`` methods), and of ``RankGroup.ppermute`` along
    ``pp`` (the pipeline's transfers), by kind; on the CPU (``device``)
    the calls are counted and not timed. A call that a CUDA graph
    captures is neither timed nor counted."""

    def __init__(self, torch, device):
        from akka_allreduce_tpu_torch.parallel import ep as E
        from akka_allreduce_tpu_torch.parallel import tp as T
        from akka_allreduce_tpu_torch.parallel.group import RankGroup
        self.torch, self.marks, self.undo = torch, {}, []
        self.cuda = device.type == "cuda"
        for kind, cls, names in (("all_to_all", E._AllToAll,
                                  ("forward", "backward")),
                                 ("tp_psum", T._TpPsum, ("forward",)),
                                 ("tp_psum", T._GradBoundary,
                                  ("backward",))):
            for name in names:
                self._wrap(kind, cls, name)
        real = RankGroup.ppermute

        def ppermute(group, x, axis, shift):
            if axis != "pp":
                return real(group, x, axis, shift)
            return self._timed("pp_ppermute",
                               lambda: real(group, x, axis, shift))
        RankGroup.ppermute = ppermute
        self.undo.append(lambda: setattr(RankGroup, "ppermute", real))

    def _timed(self, kind, call):
        if self.cuda and self.torch.cuda.is_current_stream_capturing():
            return call()  # a captured call records no event
        if not self.cuda:
            self.marks.setdefault(kind, []).append(None)
            return call()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        self.marks.setdefault(kind, []).append((start, end))
        return out

    def _wrap(self, kind, cls, name):
        real = getattr(cls, name)

        def timed(ctx, *a):
            return self._timed(kind, lambda: real(ctx, *a))
        setattr(cls, name, staticmethod(timed))
        self.undo.append(lambda: setattr(cls, name, staticmethod(real)))

    def close(self, steps: int) -> dict:
        for u in self.undo:
            u()
        if self.cuda:
            self.torch.cuda.synchronize()
        out = {}
        for kind, marks in self.marks.items():
            ms = [m[0].elapsed_time(m[1]) for m in marks if m is not None]
            out[kind] = {"calls_per_step": len(marks) / steps,
                         "ms_per_step": sum(ms) / steps if ms
                         else "not measured"}
        return out


def a7_timed_train_rank(group, args, params, attn_impl):
    """``cli``'s train rank with the ep and tp exchanges timed
    (:class:`ExchangeTimer`), their ms and calls a step in the rank's
    ``rank_info["exchanges"]``."""
    import torch

    from akka_allreduce_tpu_torch import cli
    timer = ExchangeTimer(torch, group.device)
    try:
        report = cli._train_rank(group, args, params, attn_impl)
    finally:
        exchanges = timer.close(args.steps)
    report["rank_info"]["exchanges"] = exchanges
    return report


RANK_MODES["a7_timed"] = a7_timed_train_rank


def a7_expected_launches(kind: str, n_layers: int, steps: int) -> dict:
    """A rank's launches of rows 1 and 10-12 that (b) / (c) imply: the
    flash kernels once a layer a step; the masked reduce once a step for
    the dense sync over the ep line (the expert sync at dp=1 is over one
    rank, skipped) on (b), and the tp sums 2 forward and 2 backward a
    layer on (c), whose sync at dp=1 is over one rank."""
    # the fused f32 sync sums its ranks' blocks with one masked reduce
    reduce = (expected_sync_launches("f32", "fused", A7_WORLD, 1)[
        "masked_reduce"] if kind == "ep" else 4 * n_layers)
    if DEVICE != "cuda":
        return {"flash": dict.fromkeys(FLASH_REPLACES, 0),
                "masked_reduce": 0}
    return {"flash": dict.fromkeys(FLASH_REPLACES, n_layers * steps),
            "masked_reduce": reduce * steps}


def a7_train(torch, kind: str, argv: list) -> dict:
    """(b) / (c): ``train`` on the ep or tp axis at full width: its
    numbers, the exchanges' ms a step and every rank's launches against
    :func:`a7_expected_launches`."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    args = cli.build_parser().parse_args(
        set_flag(set_flag(argv, "--steps", A7_STEPS), "--dist-backend",
                 DIST) + [f"--{kind}", str(A7_WORLD)])
    ((report, seconds),) = spawn_batch(torch, [("train", args, "a7_timed")])
    cfg = report["config"]
    want = a7_expected_launches(kind, cfg["n_layers"], A7_STEPS)
    # every rank's launches (rank 0's are the report's)
    per_rank = [{"flash": r["launches"],
                 "masked_reduce": r["sync_launches"]["masked_reduce"]}
                for r in report["ranks"]]
    got = per_rank[0]
    row = {"mesh": cfg["mesh"], "seconds": seconds,
           "losses": report["losses"],
           "wall_ms_per_step": report["wall_ms_per_step"],
           "tokens_per_s": report["tokens_per_s"], "mfu": report["mfu"],
           "aux_loss": report["aux_loss"],
           "dispatch_fraction": report["dispatch_fraction"],
           "exchanges": [r["exchanges"] for r in report["ranks"]],
           "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                       for r in report["ranks"]],
           "transport_buffer_gb_per_rank": [r["transport_buffer_gb"]
                                            for r in report["ranks"]],
           "launches": got, "rank_launches": per_rank,
           "expected_launches": want,
           "transport_launches":
               report["transport"].get("transport_launches", 0)}
    emit("a7_train", run=f"{kind}=2", **row)
    ok = (all(np.isfinite(row["losses"]))
          and all(r == want for r in per_rank)
          and all(0.0 < d <= 1.0 for d in row["dispatch_fraction"]))
    if kind == "ep":
        ok = ok and all(np.isfinite(a) and a > 0 for a in row["aux_loss"])
    if not ok:
        raise AssertionError(f"phase 25 ({'b' if kind == 'ep' else 'c'}): "
                             f"{row}")
    return row


def a7_serve(torch, served: "dict | None") -> dict:
    """(d): MoE serving on the paged kernel engine and on the gather
    path; the kernel's launches; greedy parity with the gather run, and
    the control (the kernel run's tokens against a gather run whose
    experts are rolled by one) outside it."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import attention
    from akka_allreduce_tpu_torch.parity import greedy_agree
    argv = A7_SERVE_ARGV if DEVICE == "cuda" else set_flag(
        A7_SERVE_ARGV, "--device", DEVICE)
    _, g_report, g_results, g_engine = a6_serve(
        torch, set_flag(argv, "--paged-attention", "gather"), "a7 gather")
    attention.PAGED_ATTENTION_LAUNCHES = 0
    args, report, results, engine = a6_serve(
        torch, set_flag(argv, "--paged-attention", "kernel"), "a7 kernel")
    launches = a6_main_path(attention, engine, "a7 moe kernel")
    reqs = cli.make_requests(args, *cli._validate(args))
    rolled = {**engine.params, "layers": [
        {**lyr, **{k: lyr[k].roll(1, dims=0) for k in ("we1", "we2")
                   if k in lyr}} for lyr in engine.params["layers"]]}
    verdicts, control = [], []
    for req in reqs:
        ref = g_results[req.rid][0]
        logits = reference_logits(torch, engine.params, engine.cfg,
                                  req.prompt, ref)
        verdicts.append(greedy_agree(ref, results[req.rid][0], logits)[0])
    # the control: the kernel run's tokens against the rolled experts'
    # own greedy streams (one full forward a token, the reference rule)
    from akka_allreduce_tpu_torch.models.generate import generate
    for req in reqs[:4]:
        want = generate(rolled, torch.tensor([req.prompt],
                                             device=engine.device),
                        engine.cfg, steps=8)[0].tolist()
        logits = reference_logits(torch, rolled, engine.cfg, req.prompt,
                                  want)
        control.append(greedy_agree(want, results[req.rid][0][:8],
                                    logits)[0])
    dense_tok_s = None if served is None else served["report"].get(
        "decode_tokens_per_s")
    row = {"completed": report["requests"]["completed"],
           "requests": args.requests, "launches": launches,
           "decode_tokens_per_s": report.get("decode_tokens_per_s"),
           "gather_decode_tokens_per_s": g_report.get("decode_tokens_per_s"),
           "phase4_dense_decode_tokens_per_s": dense_tok_s,
           "greedy_agree": sum(verdicts), "control_agree": sum(control),
           "control_requests": len(control)}
    emit("a7_serve", **row)
    if (row["completed"] != args.requests or not all(verdicts)
            or any(control)):
        raise AssertionError(f"phase 25 (d): {row}")
    return row


def a7_ckpt_rank(group, args, steps: int) -> dict:
    """(e) on one rank: ``cli train --tp 2 --ckpt-dir`` (its ``_train``
    with an ``on_step`` that gathers the final full tree, every rank);
    rank 0 then decodes the prompt greedily from the tree in memory and
    from the tree with wq's two tp halves swapped (the control)."""
    import torch

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.convert import gather_params
    from akka_allreduce_tpu_torch.models.generate import generate
    held = {}

    def on_step(i, state):
        if i == steps - 1:
            held["cfg"] = cli.train_config(args, args.seq).model
            held["full"] = gather_params(state.params, held["cfg"], group)
    report = cli._train(args, None, None, group, group.device, on_step)
    out = {"losses": report["losses"]}
    if group.rank == 0:
        full, cfg = held["full"], held["cfg"]
        prompt = torch.tensor([A7_PROMPT], device=group.device)
        with torch.no_grad():
            out["tokens"] = generate(full, prompt, cfg,
                                     steps=A7_GEN_TOKENS)[0].tolist()
            swapped = {**full, "layers": [
                {**lyr, "wq": lyr["wq"].roll(lyr["wq"].shape[1] // 2, 1)}
                for lyr in full["layers"]]}
            out["control_tokens"] = generate(
                swapped, prompt, cfg, steps=A7_GEN_TOKENS)[0].tolist()
    return out


GENERATE_CHILD = (
    "import sys\n"
    "from akka_allreduce_tpu_torch import cli\n"
    "sys.exit(cli.main(sys.argv[1:]))\n")


def a7_checkpoint(torch) -> dict:
    """(e): a tp=2 train with a checkpoint, then ``cli generate`` from it
    as a one-rank process: its greedy tokens must equal the trained
    model's in memory, and the control's (wq's tp halves swapped) must
    not."""
    from akka_allreduce_tpu_torch import cli
    work = tempfile.mkdtemp(prefix="a7-")
    try:
        ckpt = os.path.join(work, "ckpt")
        argv = set_flag(set_flag(A7_CKPT_ARGV, "--device", DEVICE),
                        "--dist-backend", DIST) + [
            "--tp", str(A7_WORLD), "--ckpt-dir", ckpt]
        args = cli.build_parser().parse_args(argv)
        steps = args.steps
        ((ranks, seconds),) = spawn_batch(
            torch, [("call", a7_ckpt_rank, (args, steps))], world=A7_WORLD,
            tp=A7_WORLD)
        model = ["--d-model", str(args.d_model), "--n-heads",
                 str(args.n_heads), "--n-layers", str(args.n_layers),
                 "--d-ff", str(args.d_ff), "--vocab", str(args.vocab)]
        gen = ["generate", "--ckpt-dir", ckpt, *model, "--max-seq",
               str(args.seq), "--prompt-tokens",
               ",".join(map(str, A7_PROMPT)), "--tokens",
               str(A7_GEN_TOKENS), "--device", DEVICE]
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", GENERATE_CHILD, *gen], cwd=repo,
            env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
            text=True, timeout=A7_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    if child.returncode != 0:
        raise AssertionError(f"phase 25 (e): generate exited "
                             f"{child.returncode}: {child.stderr[-3000:]}")
    restored = [int(t) for t in child.stdout.strip().splitlines()[-1]
                .split(",")]
    tokens = ranks[0]["tokens"]
    row = {"train_seconds": seconds, "generate_seconds": child_s,
           "losses": ranks[0]["losses"],
           "restored_tokens": restored,
           "in_memory_tokens": tokens[-A7_GEN_TOKENS:],
           "control_tokens": ranks[0]["control_tokens"][-A7_GEN_TOKENS:]}
    row["equal"] = row["restored_tokens"] == row["in_memory_tokens"]
    row["control_equal"] = row["restored_tokens"] == row["control_tokens"]
    emit("a7_checkpoint", **row)
    if not row["equal"] or row["control_equal"]:
        raise AssertionError(f"phase 25 (e): {row}")
    return row


def phase_a7(torch, served: "dict | None" = None) -> dict:
    """Phase 25: (a) ep=2 and tp=2 steps against the one-rank step, (b)
    MoE at full width on ep=2, (c) the dense flagship on tp=2, (d) MoE
    serving on the paged kernel engine, (e) a tp=2 checkpoint restored
    by a one-rank generate. Returns the main-path launches of rows 1,
    10-12 and 13, and the transport's."""
    t0 = time.perf_counter()
    parity = a7_parity(torch)
    ta = time.perf_counter()
    moe = a7_train(torch, "ep", A7_MOE_ARGV)
    tb = time.perf_counter()
    tp = a7_train(torch, "tp", A7_TP_ARGV)
    tc = time.perf_counter()
    serve = a7_serve(torch, served)
    td = time.perf_counter()
    ckpt = a7_checkpoint(torch)
    te = time.perf_counter()
    seconds = te - t0
    emit("a7_phase_seconds", seconds=seconds, parity=ta - t0,
         moe_train=tb - ta, tp_train=tc - tb, serve=td - tc,
         checkpoint=te - td, script_seconds=time.perf_counter() - T_START)
    if seconds > A7_SECONDS:
        raise AssertionError(f"phase 25 took {seconds:.1f} s, over its "
                             f"{A7_SECONDS} s")
    sync = dict.fromkeys(SYNC_KERNELS, 0)
    sync["masked_reduce"] = (moe["launches"]["masked_reduce"]
                             + tp["launches"]["masked_reduce"])
    return {"sync": sync,
            "flash": {k: moe["launches"]["flash"][k]
                      + tp["launches"]["flash"][k] for k in FLASH_REPLACES},
            "paged": serve["launches"],
            "transport": moe["transport_launches"]
            + tp["transport_launches"],
            "parity": parity, "checkpoint": ckpt,
            "moe_wall_ms_per_step": moe["wall_ms_per_step"]}


# -- phase 26: pipeline parallelism (ROADMAP A7, part 2) --------------------

A7PP_WORLD = 2
# (b) and (c): the flagship of phase 6 on two pipeline stages of four
# layers each, A7PP_MICRO microbatches, A7PP_STEPS steps; then both
# schedules at A7PP_MEM_MICRO microbatches for each rank's peak
A7PP_ARGV = list(TRAIN_ARGV)
A7PP_STEPS = 3
A7PP_MICRO = 4
A7PP_MEM_MICRO = 8
A7PP_MEM_STEPS = 2
# (a): A7_PARITY_MODEL's widths, dense, at depth 4, f32 (TF32 off), one
# step of each schedule at pp=2 against the one-rank step on the same
# batch: every gradient leaf within A7_GRAD_TOL of its largest value
A7PP_PARITY_MODEL = dict(vocab_size=32768, d_model=2048, n_heads=16,
                         n_layers=4, d_ff=8192, max_seq=512)
A7PP_PARITY_MICRO = 2
A7PP_CONTROL_MIN = 1e-1  # the stage-swapped control lands above this
# (d): a pp=2 checkpoint at depth 2, restored by a one-rank generate
A7PP_CKPT_ARGV = list(A7_CKPT_ARGV)
A7PP_SECONDS = 100


def a7pp_parity_rank(group, model: dict, batch, micro: int) -> dict:
    """(a) on one rank: a grad step on this rank's stage at pp=2 under
    gpipe and under 1f1b, and the control (gpipe on the full tree with
    the two stages' layers swapped), each gathered to the full layout;
    on rank 0 the one-rank step on the full tree and batch, and each
    run's largest leaf error relative to that leaf's largest reference
    value."""
    import dataclasses

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.convert import gather_params
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    dev = group.device
    cfg, full = a7_model(torch, model, None, dev)
    tokens = torch.from_numpy(np.array(batch)).to(dev)
    half = model["n_layers"] // 2
    swapped = {**full, "layers": full["layers"][half:]
               + full["layers"][:half]}
    got = {}
    for name, sched, tree in (("gpipe", "gpipe", full),
                              ("1f1b", "1f1b", full),
                              ("control", "gpipe", swapped)):
        c = dataclasses.replace(cfg, microbatches=micro, pp_schedule=sched)
        state = train.make_train_state(c, params=tree, device=dev,
                                       group=group)
        grads, _ = train.make_grad_step(c, group)(state.params, tokens)
        got[name] = tree_leaves(gather_params(grads, c.model, group))
        del grads, state
    res = {}
    if group.rank == 0:
        ref_state = train.make_train_state(cfg, params=full, device=dev)
        ref = tree_leaves(train.make_grad_step(cfg)(ref_state.params,
                                                    tokens)[0])
        for name, leaves in got.items():
            res[f"{name}_rel_err"] = max(
                float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(leaves, ref))
    return res


def a7pp_parity(torch) -> dict:
    """(a): gpipe and 1f1b at pp=2 against the one-rank step."""
    import numpy as np
    rng = np.random.default_rng(0)
    batch = rng.integers(0, A7PP_PARITY_MODEL["vocab_size"],
                         size=A7_PARITY_BATCH, dtype=np.int32)
    t0 = time.perf_counter()
    (ranks, _), = spawn_batch(
        torch, [("call", a7pp_parity_rank,
                 (A7PP_PARITY_MODEL, batch, A7PP_PARITY_MICRO))],
        world=A7PP_WORLD, pp=A7PP_WORLD)
    row = {**ranks[0], "tol": A7_GRAD_TOL, "control_min": A7PP_CONTROL_MIN,
           "microbatches": A7PP_PARITY_MICRO,
           "seconds": time.perf_counter() - t0}
    row["held"] = (row["gpipe_rel_err"] <= A7_GRAD_TOL
                   and row["1f1b_rel_err"] <= A7_GRAD_TOL)
    row["control_outside"] = row["control_rel_err"] > A7PP_CONTROL_MIN
    emit("a7pp_parity", run="pp=2", **row)
    if not (row["held"] and row["control_outside"]):
        raise AssertionError(f"phase 26 (a): {row}")
    return row


def a7pp_expected_launches(schedule: str, n_layers: int, micro: int,
                           steps: int) -> dict:
    """A rank's launches of rows 1 and 10-12 that (b) / (c) imply: the
    flash kernels once a stage layer a microbatch a step (1f1b's forward
    twice: the forward unit and the backward unit's recompute); one
    masked reduce a step, the sum of the non-layer gradients over the pp
    line (the dense sync at dp=1 is over one rank, skipped)."""
    if DEVICE != "cuda":
        return {"flash": dict.fromkeys(FLASH_REPLACES, 0),
                "masked_reduce": 0}
    per = micro * (n_layers // A7PP_WORLD) * steps
    flash = dict.fromkeys(FLASH_REPLACES, per)
    if schedule == "1f1b":
        flash["flash_fwd"] = 2 * per
    return {"flash": flash, "masked_reduce": steps}


def a7pp_train(torch) -> dict:
    """(b), (c): ``train --pp 2`` at full width under gpipe and 1f1b at
    ``A7PP_MICRO`` microbatches (their numbers, the transfers' ms a step
    and every rank's launches against :func:`a7pp_expected_launches`),
    then both at ``A7PP_MEM_MICRO`` for each rank's peak: 1f1b's must be
    below gpipe's. The four runs share one batch of the ranks."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    runs = [("gpipe", A7PP_MICRO, A7PP_STEPS), ("1f1b", A7PP_MICRO,
                                                 A7PP_STEPS),
            ("gpipe", A7PP_MEM_MICRO, A7PP_MEM_STEPS),
            ("1f1b", A7PP_MEM_MICRO, A7PP_MEM_STEPS)]
    jobs = []
    for sched, micro, steps in runs:
        argv = set_flag(set_flag(A7PP_ARGV, "--steps", steps),
                        "--dist-backend", DIST)
        if DEVICE != "cuda":
            argv = set_flag(argv, "--device", DEVICE)
        jobs.append(("train", cli.build_parser().parse_args(
            argv + ["--pp", str(A7PP_WORLD), "--microbatches", str(micro),
                    "--pp-schedule", sched]), "a7_timed"))
    out = spawn_batch(torch, jobs)
    rows = {}
    for (sched, micro, steps), (report, seconds) in zip(runs, out):
        cfg = report["config"]
        want = a7pp_expected_launches(sched, cfg["n_layers"], micro, steps)
        per_rank = [{"flash": r["launches"],
                     "masked_reduce": r["sync_launches"]["masked_reduce"]}
                    for r in report["ranks"]]
        transfer = [steady(r["pp_transfer_ms"]) for r in report["ranks"]]
        row = {"schedule": sched, "microbatches": micro, "steps": steps,
               "mesh": cfg["mesh"], "seconds": seconds,
               "losses": report["losses"],
               "wall_ms_per_step": report["wall_ms_per_step"],
               "tokens_per_s": report["tokens_per_s"], "mfu": report["mfu"],
               "pp_schedule_stats": report["pp_schedule_stats"],
               "pp_transfer_ms_per_step": transfer,
               "exchanges": [r["exchanges"] for r in report["ranks"]],
               "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                           for r in report["ranks"]],
               "transport_buffer_gb_per_rank": [r["transport_buffer_gb"]
                                                for r in report["ranks"]],
               "launches": per_rank[0], "rank_launches": per_rank,
               "expected_launches": want,
               "transport_launches":
                   report["transport"].get("transport_launches", 0)}
        emit("a7pp_train", run=f"{sched} m={micro}", **row)
        if not (all(np.isfinite(row["losses"]))
                and all(r == want for r in per_rank)):
            part = "b" if sched == "gpipe" else "c"
            raise AssertionError(f"phase 26 ({part}): {row}")
        rows[sched, micro] = row
    if DEVICE == "cuda":
        peaks = {s: max(rows[s, A7PP_MEM_MICRO]["peak_memory_gb_per_rank"])
                 for s in ("gpipe", "1f1b")}
        emit("a7pp_memory", microbatches=A7PP_MEM_MICRO, peak_gb=peaks,
             resident=report["pp_schedule_stats"])
        if not peaks["1f1b"] < peaks["gpipe"]:
            raise AssertionError(f"phase 26 (c): 1f1b's peak is not below "
                                 f"gpipe's at {A7PP_MEM_MICRO} "
                                 f"microbatches: {peaks}")
    return rows


def a7pp_ckpt_rank(group, args, steps: int) -> dict:
    """(d) on one rank: ``cli train --pp 2 --ckpt-dir`` (its ``_train``
    with an ``on_step`` that gathers the final full tree, every rank);
    rank 0 then decodes the prompt greedily from the tree in memory and
    from the tree with the two stages' layers swapped (the control)."""
    import torch

    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.convert import gather_params
    from akka_allreduce_tpu_torch.models.generate import generate
    held = {}

    def on_step(i, state):
        if i == steps - 1:
            held["cfg"] = cli.train_config(args, args.seq).model
            held["full"] = gather_params(state.params, held["cfg"], group)
    report = cli._train(args, None, None, group, group.device, on_step)
    out = {"losses": report["losses"]}
    if group.rank == 0:
        full, cfg = held["full"], held["cfg"]
        half = cfg.n_layers // 2
        prompt = torch.tensor([A7_PROMPT], device=group.device)
        with torch.no_grad():
            out["tokens"] = generate(full, prompt, cfg,
                                     steps=A7_GEN_TOKENS)[0].tolist()
            swapped = {**full, "layers": full["layers"][half:]
                       + full["layers"][:half]}
            out["control_tokens"] = generate(
                swapped, prompt, cfg, steps=A7_GEN_TOKENS)[0].tolist()
    return out


def a7pp_checkpoint(torch) -> dict:
    """(d): a pp=2 train with a checkpoint (the gathered full list
    layout), then ``cli generate`` from it as a one-rank process: its
    greedy tokens must equal the pipelined model's in memory, and the
    control's (the stages' layers swapped) must not."""
    from akka_allreduce_tpu_torch import cli
    work = tempfile.mkdtemp(prefix="a7pp-")
    try:
        ckpt = os.path.join(work, "ckpt")
        argv = set_flag(set_flag(A7PP_CKPT_ARGV, "--device", DEVICE),
                        "--dist-backend", DIST) + [
            "--pp", str(A7PP_WORLD), "--microbatches", "2",
            "--ckpt-dir", ckpt]
        args = cli.build_parser().parse_args(argv)
        ((ranks, seconds),) = spawn_batch(
            torch, [("call", a7pp_ckpt_rank, (args, args.steps))],
            world=A7PP_WORLD, pp=A7PP_WORLD)
        gen = ["generate", "--ckpt-dir", ckpt, "--d-model",
               str(args.d_model), "--n-heads", str(args.n_heads),
               "--n-layers", str(args.n_layers), "--d-ff", str(args.d_ff),
               "--vocab", str(args.vocab), "--max-seq", str(args.seq),
               "--prompt-tokens", ",".join(map(str, A7_PROMPT)), "--tokens",
               str(A7_GEN_TOKENS), "--device", DEVICE]
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", GENERATE_CHILD, *gen], cwd=repo,
            env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
            text=True, timeout=A7_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    if child.returncode != 0:
        raise AssertionError(f"phase 26 (d): generate exited "
                             f"{child.returncode}: {child.stderr[-3000:]}")
    restored = [int(t) for t in child.stdout.strip().splitlines()[-1]
                .split(",")]
    row = {"train_seconds": seconds, "generate_seconds": child_s,
           "losses": ranks[0]["losses"], "restored_tokens": restored,
           "in_memory_tokens": ranks[0]["tokens"][-A7_GEN_TOKENS:],
           "control_tokens": ranks[0]["control_tokens"][-A7_GEN_TOKENS:]}
    row["equal"] = row["restored_tokens"] == row["in_memory_tokens"]
    row["control_equal"] = row["restored_tokens"] == row["control_tokens"]
    emit("a7pp_checkpoint", **row)
    if not row["equal"] or row["control_equal"]:
        raise AssertionError(f"phase 26 (d): {row}")
    return row


def phase_a7pp(torch) -> dict:
    """Phase 26: (a) gpipe and 1f1b at pp=2 against the one-rank step,
    (b) gpipe and (c) 1f1b at full width on two stages, and both
    schedules' peak at more microbatches, (d) a pp=2 checkpoint restored
    by a one-rank generate. Returns the main-path launches of rows 1 and
    10-12 (rank 0's), and the transport's."""
    t0 = time.perf_counter()
    parity = a7pp_parity(torch)
    ta = time.perf_counter()
    runs = a7pp_train(torch)
    tb = time.perf_counter()
    ckpt = a7pp_checkpoint(torch)
    tc = time.perf_counter()
    seconds = tc - t0
    emit("a7pp_phase_seconds", seconds=seconds, parity=ta - t0,
         train=tb - ta, checkpoint=tc - tb,
         script_seconds=time.perf_counter() - T_START)
    if seconds > A7PP_SECONDS:
        raise AssertionError(f"phase 26 took {seconds:.1f} s, over its "
                             f"{A7PP_SECONDS} s")
    return {"flash": {k: sum(r["launches"]["flash"][k]
                             for r in runs.values())
                      for k in FLASH_REPLACES},
            "masked_reduce": sum(r["launches"]["masked_reduce"]
                                 for r in runs.values()),
            "transport": sum(r["transport_launches"] for r in runs.values()),
            "parity": parity, "checkpoint": ckpt}


# -- phase 27: the parallel axes' compositions (ROADMAP A7, part 3) ------

A7C_SECONDS = 120
# (a): A7_PARITY_MODEL's widths at depth 4, f32 (TF32 off), two rows a
# data rank; one round that masks data rank A7C_MASKED_RANK against one
# that masks none, on the same parameters and tokens
A7C_MASK_MODEL = dict(A7_PARITY_MODEL, n_layers=4)
A7C_MASK_BATCH = (4, 512)
A7C_MASKED_RANK = 1
# (name, world, mesh, MoE or None, TrainConfig fields)
A7C_MASK_MESHES = (("dp=2 tp=2", 4, {"tp": 2}, None, {}),
                   ("dp=2 pp=2", 4, {"pp": 2}, None,
                    {"microbatches": 2, "pp_schedule": "gpipe"}),
                   ("ep=2 moe", 2, {"ep": 2}, A7_PARITY_MOE, {}))
# (b): chunks of A7C_SPD steps, two replays a run (the wall ms a step is
# the second's; the control needs a replay after the first)
A7C_SPD = 3
A7C_STEPS = 6
A7C_PP_MICRO = 4
# the MoE chunks' depth: at 8 layers the ef8 capture took 32.8 GB a rank,
# past what the card had left beside the script's other processes
A7C_MOE_LAYERS = 4
# (name, argv, mesh flags): the flagship of phase 6 and its MoE variant
A7C_CHUNK_RUNS = (
    ("tp=2", TRAIN_ARGV, ["--tp", "2"]),
    ("ep=2 f32", with_layers(A7_MOE_ARGV, A7C_MOE_LAYERS), ["--ep", "2"]),
    ("ep=2 ef8", with_layers(A7_MOE_ARGV, A7C_MOE_LAYERS),
     ["--ep", "2", "--grad-quant", "ef8"]),
    ("pp=2 gpipe", TRAIN_ARGV, ["--pp", "2", "--microbatches",
                                str(A7C_PP_MICRO)]),
    ("pp=2 1f1b", TRAIN_ARGV, ["--pp", "2", "--microbatches",
                               str(A7C_PP_MICRO), "--pp-schedule", "1f1b"]))
A7C_CONTROL_RUN = "ep=2 ef8"
# the sync rows whose launches phase 27's main path adds (rows 1, 5-7)
A7C_SYNC_ROWS = ("masked_reduce", "quantize_int8_block",
                 "quantize_int8_block_rtn", "dequantize_int8_block")
# (c): the MoE flagship at ep=2 under deadlines
A7C_DEADLINE_STEPS = 6


def a7c_tokens(group, tokens):
    """This data rank's rows of the global batch (sharded over ``(dp,
    ep)``, dp-major), and how many rows a data rank takes."""
    rows = tokens.shape[0] // (group.axis_size("dp")
                               * group.axis_size("ep"))
    blk = (group.axis_index("dp") * group.axis_size("ep")
           + group.axis_index("ep"))
    return tokens[blk * rows:(blk + 1) * rows], rows


def a7c_mask_rank(group, model: dict, moe, kw: dict, batch) -> dict:
    """(a) on one rank: two rounds of the dynamic-valid grad step through
    a ``DeadlineTrainer`` whose clock sees every data rank on time, then
    data rank ``A7C_MASKED_RANK`` late, on the same parameters and
    tokens; the reports, whether the expert gradients of the two rounds
    are bitwise equal (MoE), and on rank 0 each round's largest dense
    leaf error, gathered to the full layout, against the one-rank step
    on data rank 0's rows alone (relative to that leaf's largest
    value)."""
    import dataclasses

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.convert import gather_params
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    from akka_allreduce_tpu_torch.runtime.pacer import RoundClock
    from akka_allreduce_tpu_torch.runtime.straggler import DeadlineTrainer
    dev = group.device
    cfg, full = a7_model(torch, model, moe, dev)
    cfg = dataclasses.replace(cfg, **kw)
    tokens = torch.from_numpy(np.array(batch)).to(dev)
    mine, rows = a7c_tokens(group, tokens)
    state = train.make_train_state(cfg, params=full, device=dev,
                                   group=group)
    grad_step = train.make_grad_step(cfg, group, dynamic_valid=True)
    n_data = train.data_rank_count(cfg, group)
    rounds = []

    def step(state_, tokens_, valid):
        grads, metrics = grad_step(state_.params, tokens_, valid=valid)
        rounds.append(grads)
        return metrics
    clock = RoundClock(n_data, deadline_s=1.0)
    trainer = DeadlineTrainer(step, clock,
                              train.dense_bucket_count(cfg, state.params),
                              max_lag=0, line=train.mask_line(cfg, group))
    for late in (None, A7C_MASKED_RANK):
        r = trainer.open_round()
        for peer in range(n_data):
            clock.report_offset(r, peer, 2.0 if peer == late else 0.0)
        trainer.run_round(state, mine)
    trainer.drain()
    res = {"n_data_ranks": n_data,
           "reports": [{"n_masked": rep.n_masked,
                        "n_dropped": rep.n_dropped,
                        "fell_back": rep.fell_back}
                       for rep in trainer.reports]}
    def dense_leaves(tree):
        return tree_leaves(train.split_expert_leaves(tree)[0]
                           if moe is not None else tree)
    if moe is not None:  # this rank's experts: the exact sync's alone
        res["expert_bitwise"] = all(torch.equal(a, b) for a, b in zip(
            *(tree_leaves(train.split_expert_leaves(g)[1])
              for g in rounds)))
    dense = [dense_leaves(gather_params(g, cfg.model, group))
             for g in rounds]
    del state, rounds
    if group.rank == 0:
        one = dataclasses.replace(cfg, microbatches=1)
        ref_state = train.make_train_state(one, params=full, device=dev)
        ref, _ = train.make_grad_step(one)(ref_state.params, tokens[:rows])
        ref = dense_leaves(ref)
        for name, leaves in zip(("unmasked", "masked"), dense):
            res[f"{name}_rel_err"] = max(
                float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(leaves, ref))
    return res


def a7c_mask(results: dict) -> dict:
    """(a): for each of ``A7C_MASK_MESHES`` (``results``: its ranks'
    :func:`a7c_mask_rank` results by name): the masked round within
    ``A7_GRAD_TOL`` of data rank 0's gradients alone, the unmasked
    round outside it (the control), the trainer's reports those of the
    script's clock, and at ep the expert gradients bitwise."""
    want = [{"n_masked": 0, "n_dropped": 0, "fell_back": False},
            {"n_masked": 1, "n_dropped": 1, "fell_back": False}]
    rows = {}
    for name, _, _, moe, _ in A7C_MASK_MESHES:
        ranks = results[name]
        row = {"mesh": name, "tol": A7_GRAD_TOL,
               "masked_rel_err": ranks[0]["masked_rel_err"],
               "unmasked_rel_err": ranks[0]["unmasked_rel_err"],
               "reports": [r["reports"] for r in ranks],
               "expected_reports": want,
               "n_data_ranks": ranks[0]["n_data_ranks"]}
        row["held"] = row["masked_rel_err"] <= A7_GRAD_TOL
        row["control_outside"] = row["unmasked_rel_err"] > A7_GRAD_TOL
        row["reports_agree"] = all(r == want for r in row["reports"])
        if moe is not None:
            row["expert_bitwise"] = [r["expert_bitwise"] for r in ranks]
        ok = row["held"] and row["control_outside"] and row[
            "reports_agree"] and all(row.get("expert_bitwise", [True]))
        emit("a7c_mask", **row)
        if not ok:
            raise AssertionError(f"phase 27 (a) {name}: {row}")
        rows[name] = row
    return rows


def stale_keys_rank(group, args, params, attn_impl):
    """(b)'s control: ``cli``'s train rank whose chunk key table is left
    at the first chunk's steps (``ChunkKeys.fill`` runs once: the second
    replay rounds with the first chunk's seeds and generators); on the
    CPU, where chunks run step by step, each step of a later chunk
    rounds with the key of the step a chunk before."""
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.ops import collectives
    fill, quant_key = collectives.ChunkKeys.fill, train.quant_key
    n = args.steps_per_dispatch

    def fill_once(keys, base):
        if not getattr(keys, "stale", False):
            keys.stale = True
            fill(keys, base)

    def key_stale(step, microbatch=None, tag=0):
        return quant_key(step - n if step >= n else step, microbatch, tag)
    patches = ([(collectives.ChunkKeys, "fill", fill_once)]
               if group.device.type == "cuda"
               else [(train, "quant_key", key_stale)])
    return _patched_train_rank(group, args, params, attn_impl, patches)


RANK_MODES["stale_keys"] = stale_keys_rank


def a7c_argv(argv: list, mesh: list, extra: "list | None" = None) -> list:
    """A phase 27 train argv: ``argv`` on ``DIST`` and ``DEVICE`` for
    ``A7C_STEPS`` steps in chunks of ``A7C_SPD``, on the mesh flags
    ``mesh`` (``extra`` in place of the chunks)."""
    out = set_flag(set_flag(argv, "--steps", A7C_STEPS), "--dist-backend",
                   DIST)
    if DEVICE != "cuda":
        out = set_flag(out, "--device", DEVICE)
    return out + mesh + (extra if extra is not None else [
        "--steps-per-dispatch", str(A7C_SPD)])


def a7c_per_step(name: str, n_layers: int) -> dict:
    """A rank's launches of rows 1, 5-7 and 10-12 a step on (b)'s run
    ``name`` (on the card): the flash kernels once a layer (at pp once a
    stage layer a microbatch, 1f1b's forward twice); the masked reduce:
    the tp sums (2 forward, 2 backward a layer), the dense sync over the
    ep line (f32: one; ef8: the fused ef8's quantizes and dequantizes),
    the pp sum of the non-layer gradients."""
    out = dict.fromkeys(("masked_reduce", "quantize_int8_block",
                         "quantize_int8_block_rtn",
                         "dequantize_int8_block"), 0)
    flash = dict.fromkeys(FLASH_REPLACES, n_layers)
    if name == "tp=2":
        out["masked_reduce"] = 4 * n_layers
    elif name.startswith("ep=2"):
        wire = name.split()[1]
        sync = expected_sync_launches(wire, "fused", 2, 1)
        out.update({k: sync[k] for k in out})
    else:
        flash = dict.fromkeys(FLASH_REPLACES,
                              A7C_PP_MICRO * n_layers // 2)
        if name.endswith("1f1b"):
            flash["flash_fwd"] *= 2
        out["masked_reduce"] = 1
    return {**flash, **out}


def a7c_pair(torch, name: str, graph: dict, eager: dict) -> dict:
    """(b): a graphed run against its eager chunks: losses, every rank's
    parameter checksum and ef8 residual checksum bitwise; two replays;
    each rank's launches a replay those of :func:`a7c_per_step` x
    ``A7C_SPD``; the graphed and eager wall ms a step, capture seconds,
    boundary ms and what a replay enqueues on each transport line."""
    layers = graph["config"]["n_layers"]
    ranks, eranks = graph["ranks"], eager["ranks"]
    multi = [r["multi_step"] for r in ranks]
    want = {k: v * A7C_SPD for k, v in a7c_per_step(name, layers).items()}
    row = {
        "run": name, "mesh": graph["config"]["mesh"],
        "steps": graph["config"]["steps"], "steps_per_dispatch": A7C_SPD,
        "losses": graph["losses"], "eager_losses": eager["losses"],
        "losses_bitwise": graph["losses"] == eager["losses"],
        "param_checksums": [r["param_checksum"] for r in ranks],
        "params_bitwise": ([r["param_checksum"] for r in ranks]
                           == [r["param_checksum"] for r in eranks]),
        "wall_ms_per_step": graph["wall_ms_per_step"],
        "eager_wall_ms_per_step": eager["wall_ms_per_step"],
        "replays": [m["graph_replays"] for m in multi],
        "capture_seconds": [m["capture_seconds"] for m in multi],
        "boundary_ms": [m["boundary_ms"] for m in multi],
        "captured_launches": [{k: m["captured_launches"].get(k, 0)
                               for k in want} for m in multi],
        "expected_launches_per_replay": want,
        "stream_waits_per_replay": [m["stream_waits_per_replay"]
                                    for m in multi],
        "transport_lines_per_replay": [m["transport_lines_per_replay"]
                                       for m in multi],
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks]}
    if "residual_checksum" in ranks[0]:
        row["residuals_bitwise"] = [r["residual_checksum"] for r in ranks] \
            == [r["residual_checksum"] for r in eranks]
    bad = [k for k in ("losses_bitwise", "params_bitwise",
                       "residuals_bitwise") if row.get(k) is False]
    if not all(math.isfinite(x) for x in graph["losses"]):
        bad.append("non-finite losses")
    if DEVICE == "cuda":
        if any(n != A7C_STEPS // A7C_SPD for n in row["replays"]):
            bad.append(f"replays {row['replays']}")
        if any(got != want for got in row["captured_launches"]):
            bad.append("launches a replay")
    emit("a7c_chunks", **row)
    if bad:
        raise AssertionError(f"phase 27 (b) {name}: the graphed run "
                             f"against its eager chunks: {bad}: {row}")
    return row


def a7c_deadline(torch, report: dict, prob: float, want: list,
                 phase25_ms: "float | None") -> dict:
    """(c): the MoE flagship at ep=2 under ``--deadline-ms``: each
    round's ``n_masked`` / ``fell_back`` those of the straggle draws and
    its ``min_bucket_count`` the smaller of the two syncs' (the expert
    sync at dp 1 is over one rank: 1), finite losses, rank 0's flash
    kernels once a layer a step and one masked reduce a step."""
    steps = A7C_DEADLINE_STEPS
    rounds = [{k: r[k] for k in ("n_masked", "fell_back",
                                 "min_bucket_count")}
              for r in report["deadline"]["rounds"]]
    want = [{**w, "min_bucket_count": 1} for w in want]
    n_layers = report["config"]["n_layers"]
    expect = ({"flash": dict.fromkeys(FLASH_REPLACES, n_layers * steps),
               "masked_reduce": steps} if DEVICE == "cuda" else
              {"flash": dict.fromkeys(FLASH_REPLACES, 0),
               "masked_reduce": 0})
    got = {"flash": report["launches"],
           "masked_reduce": report["sync_launches"]["masked_reduce"]}
    row = {"steps": steps, "straggle_prob": prob,
           "deadline_ms": DEADLINE_MS, "rounds": rounds,
           "predicted_rounds": want,
           "masked_round_count": report["deadline"]["masked_round_count"],
           "fallback_count": sum(r["fell_back"] for r in rounds),
           "losses": report["losses"],
           "wall_ms_per_step": report["wall_ms_per_step"],
           "phase25_exact_wall_ms_per_step": phase25_ms,
           "launches": got, "expected_launches": expect,
           "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                       for r in report["ranks"]]}
    emit("a7c_deadline", **row)
    if (rounds != want or got != expect
            or not all(math.isfinite(x) for x in report["losses"])):
        raise AssertionError(f"phase 27 (c): {row}")
    return row


# (c)'s torch.profiler window on rank 0: steps 2..A7C_PROFILE_STEPS + 1
# of the deadline run (its masked and exact rounds), each step's work in
# a ``train_step i`` range (``cli train --xprof-dir``)
A7C_PROFILE_STEPS = 4


def trace_step_split(path: str) -> dict:
    """Per ``train_step i`` range of a ``cli train --xprof-dir`` Chrome
    trace: the host span of the step's work (ms), the device time of the
    kernels, copies and fills it launched (ms, matched to their launches
    by correlation id) by kind (flash kernels, GEMMs, the masked reduce,
    the ipc transport, copies, the rest), the span from its first to its
    last on the device, and the device's idle gap before its first (after
    the previous step's last)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    steps = sorted((e["ts"], e["ts"] + e["dur"], int(e["name"].split()[1]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step "))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {i: {"host_ms": (hi - lo) / 1e3, "device_ms": 0.0,
               "by_kind_ms": {}} for lo, hi, i in steps}
    edges: dict = {}  # step -> [first start, last end] on the device

    def kind(e) -> str:
        name = e["name"].lower()
        if e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            return "copies"
        for key, words in (("flash", ("flash",)),
                           ("masked_reduce", ("masked_reduce",)),
                           ("transport", ("transport", "copy_stretch")),
                           ("gemm", ("gemm", "xmma", "cutlass", "sm90_",
                                     "nvjet"))):
            if any(w in name for w in words):
                return key
        return "other"

    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        at = launched.get(e.get("args", {}).get("correlation"))
        step = next((i for lo, hi, i in steps
                     if at is not None and lo <= at <= hi), None)
        if step is None:
            continue
        row = out[step]
        row["device_ms"] += e["dur"] / 1e3
        k = kind(e)
        row["by_kind_ms"][k] = row["by_kind_ms"].get(k, 0.0) + e["dur"] / 1e3
        span = edges.setdefault(step, [e["ts"], e["ts"] + e["dur"]])
        span[0], span[1] = min(span[0], e["ts"]), max(span[1],
                                                       e["ts"] + e["dur"])
    last_end = None
    for step in sorted(edges):
        first, end = edges[step]
        out[step]["device_span_ms"] = (end - first) / 1e3
        out[step]["gap_before_ms"] = (None if last_end is None
                                      else (first - last_end) / 1e3)
        last_end = end
    return out


def a7c_profile(trace: str, want: list) -> dict:
    """(c)'s profiler window split into its steps, and their means over
    the masked and the exact rounds."""
    split = trace_step_split(trace)
    means = {}
    for label, pick in (("masked", lambda r: r["n_masked"] > 0),
                        ("exact", lambda r: r["n_masked"] == 0)):
        rows = [split[i] for i in split if pick(want[i])]
        kinds = sorted({k for r in rows for k in r["by_kind_ms"]})
        means[label] = {
            "steps": [i for i in split if pick(want[i])],
            "host_ms": statistics.fmean(r["host_ms"] for r in rows)
            if rows else None,
            "device_ms": statistics.fmean(r["device_ms"] for r in rows)
            if rows else None,
            "device_span_ms": statistics.fmean(
                r.get("device_span_ms", 0.0) for r in rows) if rows else None,
            "by_kind_ms": {k: statistics.fmean(
                r["by_kind_ms"].get(k, 0.0) for r in rows) for k in kinds}}
    return {"steps": split, "means": means}


def a7c_straggle(draws) -> float:
    """(c)'s --straggle-prob over all of ``draws``: the first midpoint
    between sorted draws whose rounds have a clean step 1, a step that
    masks one rank and a step that masks both (the fallback); without
    such a gap, the first with the first two."""
    edges = sorted(set(float(d) for d in draws.ravel()))
    probs = [(lo + hi) / 2 for lo, hi in zip(edges, edges[1:])]
    for need_fallback in (True, False):
        for prob in probs:
            rounds = predicted_rounds(draws, prob)
            if (rounds[0]["n_masked"] == 0
                    and any(r["n_masked"] == 1 for r in rounds)
                    and (any(r["fell_back"] for r in rounds)
                         or not need_fallback)):
                return prob
    raise ValueError("no --straggle-prob gives a clean step 1 and a "
                     "one-rank step within these draws")


def phase_a7c(torch, phase25_ms: "float | None" = None) -> dict:
    """Phase 27: (a) masked rounds on dp x tp, dp x pp and ep meshes
    against data rank 0 alone, (b) CUDA-graph chunks at full width on
    tp=2, ep=2 (f32, ef8) and pp=2 (gpipe, 1f1b), bitwise their eager
    chunks, with the stale-keys control, (c) the MoE flagship at ep=2
    under deadlines. Returns rank 0's launches of rows 1, 5-7 and 10-12
    on (b)'s graphed runs and (c)."""
    import numpy as np

    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    t0 = time.perf_counter()
    base = parse(A7_MOE_ARGV)
    draws = straggle_draws(A7C_DEADLINE_STEPS, A7_WORLD, base.batch,
                           base.seq, base.vocab)
    prob = a7c_straggle(draws)
    want_rounds = predicted_rounds(draws, prob)
    deadline_argv = a7c_argv(A7_MOE_ARGV, ["--ep", "2"], [
        "--deadline-ms", str(DEADLINE_MS), "--straggle-prob", repr(prob)])
    deadline_argv = set_flag(deadline_argv, "--steps", A7C_DEADLINE_STEPS)
    trace_dir = tempfile.mkdtemp(prefix="a7c-trace-")
    deadline_argv += ["--xprof-dir", trace_dir, "--xprof-steps",
                      str(A7C_PROFILE_STEPS)]
    rng = np.random.default_rng(0)
    mask_batch = rng.integers(0, A7C_MASK_MODEL["vocab_size"],
                              size=A7C_MASK_BATCH, dtype=np.int32)
    # (a)'s four-rank meshes first, then their pool closes: its ranks'
    # memory back before the full-width runs of two
    masks, extra = {}, {}
    for name, world, mesh, moe, kw in A7C_MASK_MESHES:
        if world == 2:
            continue
        t1 = time.perf_counter()
        (masks[name], _), = spawn_batch(
            torch, [("call", a7c_mask_rank,
                     (A7C_MASK_MODEL, moe, kw, mask_batch))],
            world=world, **mesh)
        extra[name] = time.perf_counter() - t1
    close_pools(4)
    (mask_name, _, _, mask_moe, mask_kw), = [
        m for m in A7C_MASK_MESHES if m[1] == 2]
    groups: dict = {}
    for name, argv, mesh in A7C_CHUNK_RUNS:
        groups.setdefault(mesh[:2][0], []).append((name, argv, mesh))
    runs = {}
    for key, members in groups.items():
        jobs, names = [], []
        for name, argv, mesh in members:
            args = parse(a7c_argv(argv, mesh))
            jobs += [("train", args, None), ("train", args, "eager_chunks")]
            names += [name, f"{name} eager"]
            if name == A7C_CONTROL_RUN:
                jobs.append(("train", args, "stale_keys"))
                names.append("control")
        if key == "--ep":
            jobs += [("train", parse(deadline_argv), None),
                     ("call", a7c_mask_rank, (A7C_MASK_MODEL, mask_moe,
                                              mask_kw, mask_batch))]
            names += ["deadline", mask_name]
        t1 = time.perf_counter()
        out = spawn_batch(torch, jobs)
        runs.update(zip(names, (o[0] for o in out)))
        extra[key] = time.perf_counter() - t1
    mask = a7c_mask({**masks, mask_name: runs[mask_name]})
    chunks, totals = {}, {"sync": dict.fromkeys(SYNC_KERNELS, 0),
                          "flash": dict.fromkeys(FLASH_REPLACES, 0)}
    for name, _, _ in A7C_CHUNK_RUNS:
        chunks[name] = a7c_pair(torch, name, runs[name],
                                runs[f"{name} eager"])
    control = runs["control"]
    c_row = {"run": A7C_CONTROL_RUN, "control_losses": control["losses"],
             "eager_losses": runs[f"{A7C_CONTROL_RUN} eager"]["losses"],
             "control_passed": (
                 control["losses"]
                 == runs[f"{A7C_CONTROL_RUN} eager"]["losses"]
                 and [r["param_checksum"] for r in control["ranks"]]
                 == [r["param_checksum"]
                     for r in runs[f"{A7C_CONTROL_RUN} eager"]["ranks"]])}
    emit("a7c_control", **c_row)
    if c_row["control_passed"]:
        raise AssertionError(f"phase 27 (b): the stale key table landed "
                             f"inside the bitwise check: {c_row}")
    deadline = a7c_deadline(torch, runs["deadline"], prob, want_rounds,
                            phase25_ms)
    profile = a7c_profile(runs["deadline"]["xprof_trace"], want_rounds)
    shutil.rmtree(trace_dir, ignore_errors=True)
    emit("a7c_profile", window_steps=A7C_PROFILE_STEPS, **profile)
    totals["transport"] = 0
    for name in [n for n, _, _ in A7C_CHUNK_RUNS] + ["deadline"]:
        report = runs[name]
        totals["transport"] += report["transport"].get(
            "transport_launches", 0)
        for k in SYNC_KERNELS:
            totals["sync"][k] += report["sync_launches"][k]
        for k in FLASH_REPLACES:
            totals["flash"][k] += report["launches"][k]
    seconds = time.perf_counter() - t0
    emit("a7c_phase_seconds", seconds=seconds, limit_s=A7C_SECONDS,
         batches=extra,
         wall_ms_per_step={n: (r["wall_ms_per_step"],
                               r["eager_wall_ms_per_step"])
                           for n, r in chunks.items()},
         boundary_ms={n: r["boundary_ms"][0] for n, r in chunks.items()},
         capture_seconds={n: r["capture_seconds"][0]
                          for n, r in chunks.items()},
         script_seconds=time.perf_counter() - T_START)
    if seconds > A7C_SECONDS:
        raise AssertionError(f"phase 27 took {seconds:.1f} s, over its "
                             f"{A7C_SECONDS} s")
    return {**totals, "mask": mask, "chunks": chunks, "deadline": deadline}


# -- phase 28: training across processes (ROADMAP A9) --------------------
# (a): A7_PARITY_MODEL without experts (depth 2 at the flagship's widths,
# ~236M parameters, 0.94 GB f32), f32 with TF32 off, batch 4 x 512, as two
# ``cli train --coordinator --deadline-ms`` processes: (a1) held to the
# same command at --dp 2 on ipc ranks, (a2) with process 1 late in the
# round the straggle draws predict
A9_MODEL = {k: v for k, v in A7_PARITY_MODEL.items() if k != "moe_every"}
A9_ARGV = ["train", "--d-model", str(A9_MODEL["d_model"]), "--n-heads",
           str(A9_MODEL["n_heads"]), "--n-layers", str(A9_MODEL["n_layers"]),
           "--d-ff", str(A9_MODEL["d_ff"]), "--vocab",
           str(A9_MODEL["vocab_size"]), "--seq", "512", "--batch", "4",
           "--lr", "1e-4", "--steps", "3", "--log-every", "1", "--device",
           "cuda"]
A9_PROCS = 2
# lockstep (the --dp 2 run applies each step before the next), buckets
# of 1Mi elements, the least retention; (a2) compares the CRCs every
# round (a round's host copy and CRC of the parameters: (a1) holds the
# processes' final parameters bitwise instead)
A9_HYBRID = ["--max-lag", "0", "--dcn-bucket-elems", "1048576",
             "--retain-rounds", "8"]
# f32 sums in other orders (the token-weighted mean against the ranks'
# allreduce), ~1e-7 a step, against a masked round's ~1e-4
A9_LOSS_TOL = 1e-5
# (a1)'s deadline, which no round may miss. (a2)'s: a late process
# sleeps 1.5 deadlines, then publishes bucket by bucket, and the master
# credits the buckets that landed by its deadline (a process with some
# is partial, not masked). The master's deadline opens after its own
# publish, P, so the late process lands nothing in time when 1.5 D > P
# + D, i.e. D > 2 P: D is A9_DEADLINE_FACTOR times (a1)'s last round's
# publish on the master (flatten, D2H, encode, set), at least
# A9_DEADLINE_FLOOR_MS
A9_CLEAN_DEADLINE_MS = 120000.0
A9_DEADLINE_FACTOR = 2.5
A9_DEADLINE_FLOOR_MS = 2000.0
# (b): the flagship of phase 6 (541.1M parameters, bf16, batch 8 x 2048)
# as two processes on the bf16 wire (1.08 GB a payload), one whole-vector
# bucket (the store client's parts), 3 steps
A9_FULL_STEPS = 3
A9_FULL_ARGV = set_flag(TRAIN_ARGV, "--steps", A9_FULL_STEPS) + [
    "--bf16-grads", "--max-lag", "0", "--retain-rounds", "8",
    "--deadline-ms", str(A9_CLEAN_DEADLINE_MS)]
A9_SECONDS = 200
def a9_rank(group, argv: list) -> dict:
    """One process of a phase-28 run on a pool rank: ``cli.run_train`` at
    ``argv`` as process ``group.rank`` (the rank pool's processes have
    torch and the card's context up already)."""
    from akka_allreduce_tpu_torch import cli
    return cli.run_train(cli.build_parser().parse_args(
        argv + ["--process-id", str(group.rank)]))


def a9_processes(torch, argv: list) -> list:
    """``argv`` as A9_PROCS ``train --coordinator`` processes, the world-2
    pool's ranks, joined through a store that rank 0 hosts on a free local
    port; returns each process's train report."""
    from akka_allreduce_tpu_torch.protocol.remote import free_port
    coord = ["--coordinator", f"127.0.0.1:{free_port()}",
             "--num-processes", str(A9_PROCS)]
    (reports, _), = spawn_batch(torch, [("call", a9_rank, (argv + coord,))],
                                world=A9_PROCS)
    return reports


def a9_straggle(late_draws) -> "tuple[float, int]":
    """(a2)'s --straggle-prob from process 1's draws a round: the
    midpoint that makes exactly one round after round 0 late, with a
    round after it to show the control, and round 0 (the barrier) on
    time. Returns (prob, the late round)."""
    draws = [float(d) for d in late_draws]
    for r in range(1, len(draws) - 1):
        others = [d for i, d in enumerate(draws) if i != r]
        above = [d for d in others if d > draws[r]]
        if len(above) == len(others):
            return (draws[r] + min(above)) / 2, r
    raise ValueError(f"no --straggle-prob makes one round after round 0 "
                     f"late with a round after it: {draws}")


def a9_check_pair(name: str, pair: list, want_masked: list) -> dict:
    """Both processes' reports of one run: the same losses, the same
    final parameters (the CRC check ran every round), the rounds'
    n_masked as predicted on both."""
    r0, r1 = pair
    masked = [[r["n_masked"] for r in rep["hybrid"]["rounds"]]
              for rep in (r0, r1)]
    row = {"run": name, "losses": r0["losses"],
           "losses_equal": r0["losses"] == r1["losses"],
           "checksums_equal": r0["param_checksum"] == r1["param_checksum"],
           "n_masked": masked, "want_n_masked": want_masked}
    if not (row["losses_equal"] and row["checksums_equal"]
            and masked == [want_masked, want_masked]
            and all(math.isfinite(x) for x in r0["losses"])):
        raise AssertionError(f"phase 28 {name}: {row}")
    return row


def a9_split(report: dict) -> dict:
    """The last round of a process, in the phases the trainer times: ms
    each, the store's MB/s, and the process's peak RSS."""
    t = report["hybrid"]["rounds"][-1]["times"]
    return {"grad_ms": t["grad_s"] * 1e3,
            "flatten_d2h_ms": t["flatten_d2h_s"] * 1e3,
            "encode_ms": t["encode_s"] * 1e3,
            "set_ms": t["set_s"] * 1e3,
            "set_mb_per_s": t["set_bytes"] / t["set_s"] / 1e6,
            "report_to_mask_ms": t["mask_wait_s"] * 1e3,
            "fetch_ms": t["fetch_s"] * 1e3,
            "fetch_mb_per_s": (t["fetch_bytes"] / t["fetch_s"] / 1e6
                               if t["fetch_s"] else None),
            "decode_mean_ms": t["decode_mean_s"] * 1e3,
            "h2d_apply_ms": t["h2d_apply_s"] * 1e3,
            "checksum_ms": t.get("checksum_s", 0.0) * 1e3,
            "payload_gb": t["set_bytes"] / 1e9,
            "start_rss_gb": report["hybrid"]["start_rss_gb"],
            "peak_rss_gb": report["hybrid"]["peak_rss_gb"]}


def phase_a9(torch, phase9_ms: "float | None" = None) -> dict:
    """Phase 28: (a) the parity model as two ``train --coordinator
    --deadline-ms`` processes, (a1) each step's loss within A9_LOSS_TOL
    of ``--dp 2`` on ipc ranks, (a2) process 1 late in the round its
    draws predict: that round masked on both processes (process 1
    applies it without its own contribution), the CRCs equal, and the
    next round's loss outside A9_LOSS_TOL of (a1)'s (the control); (b)
    the flagship on the bf16 wire, its last round split into its phases
    beside phase 9's exact dp=2 step (``phase9_ms``, the f32 wire's wall
    ms a step in this run). Returns process 0's flash
    launches: (a)'s f32 (the ipc reference's rank 0 added) and (b)'s
    bf16."""
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    t0 = time.perf_counter()
    base = parse(A9_ARGV)
    steps = base.steps
    draws = straggle_draws(steps, A9_PROCS, base.batch, base.seq,
                           base.vocab)
    prob, late = a9_straggle(draws[:, 1])
    want_late = [int(i == late) for i in range(steps)]
    (ref, _), = spawn_batch(torch, [(
        "train", parse(A9_ARGV + ["--dp", str(A9_PROCS), "--dist-backend",
                                  DIST]), None)])
    t1 = time.perf_counter()
    hybrid = A9_ARGV + A9_HYBRID
    a1 = a9_processes(torch, hybrid + ["--deadline-ms",
                                       str(A9_CLEAN_DEADLINE_MS)])
    t2 = time.perf_counter()
    a1_row = a9_check_pair("a1", a1, [0] * steps)
    rel = [abs(h - w) / abs(w) for h, w in zip(a1_row["losses"],
                                              ref["losses"])]
    a1_row.update(dp2_losses=ref["losses"], rel_err=rel, tol=A9_LOSS_TOL,
                  split={p: a9_split(rep) for p, rep in enumerate(a1)})
    emit("a9_parity", **a1_row)
    if max(rel) > A9_LOSS_TOL:
        raise AssertionError(f"phase 28 (a1): {a1_row}")
    t = a1[0]["hybrid"]["rounds"][-1]["times"]
    publish_s = t["flatten_d2h_s"] + t["encode_s"] + t["set_s"]
    deadline_ms = max(A9_DEADLINE_FLOOR_MS,
                      A9_DEADLINE_FACTOR * publish_s * 1e3)
    a2 = a9_processes(torch, hybrid + ["--deadline-ms", repr(deadline_ms),
                                "--straggle-prob", repr(prob),
                                "--check-every", "1"])
    t3 = time.perf_counter()
    a2_row = a9_check_pair("a2", a2, want_late)
    worker_round = a2[1]["hybrid"]["rounds"][late]
    after = late + 1
    control = abs(a2_row["losses"][after] - a1_row["losses"][after]) \
        / abs(a1_row["losses"][after])
    a2_row.update(straggle_prob=prob, late_round=late,
                  deadline_ms=deadline_ms, master_publish_s=publish_s,
                  n_partial=[[r["n_partial"] for r in rep["hybrid"]["rounds"]]
                             for rep in a2],
                  worker_valid_peers=worker_round["valid_peers"],
                  worker_caught_up=[r["caught_up"] for r in
                                    a2[1]["hybrid"]["rounds"]],
                  control_rel_err=control, tol=A9_LOSS_TOL)
    emit("a9_straggle", **a2_row)
    if worker_round["valid_peers"] != [True, False] \
            or control <= A9_LOSS_TOL:
        raise AssertionError(f"phase 28 (a2): {a2_row}")
    full = a9_processes(torch, A9_FULL_ARGV)
    t4 = time.perf_counter()
    f_row = a9_check_pair("b", full, [0] * A9_FULL_STEPS)
    n_layers = full[0]["config"]["n_layers"]
    flash_want = dict.fromkeys(
        FLASH_REPLACES, n_layers * A9_FULL_STEPS if DEVICE == "cuda" else 0)
    launches = [rep["launches"] for rep in full]
    masked_reduce = [rep["sync_launches"]["masked_reduce"] for rep in full]
    f_row.update(split={p: a9_split(rep) for p, rep in enumerate(full)},
                 phase9_exact_wall_ms_per_step=phase9_ms,
                 wall_ms_per_step=[rep["wall_ms_per_step"] for rep in full],
                 flash_launches=launches, expected_flash=flash_want,
                 masked_reduce_launches=masked_reduce,
                 params=full[0]["config"]["params"])
    emit("a9_full_width", **f_row)
    if launches != [flash_want] * A9_PROCS or masked_reduce != [0, 0]:
        raise AssertionError(f"phase 28 (b): {f_row}")
    f32 = {k: ref["launches"][k] + a1[0]["launches"][k]
           + a2[0]["launches"][k] for k in FLASH_REPLACES}
    seconds = time.perf_counter() - t0
    emit("a9_phase_seconds", seconds=seconds, limit_s=A9_SECONDS,
         parts={"dp2_reference": t1 - t0, "a1": t2 - t1, "a2": t3 - t2,
                "b": t4 - t3},
         script_seconds=time.perf_counter() - T_START)
    if seconds > A9_SECONDS:
        raise AssertionError(f"phase 28 took {seconds:.1f} s, over its "
                             f"{A9_SECONDS} s")
    return {"flash": launches[0], "flash_f32": f32}


def chunk_of(world: int) -> int:
    """The transport's chunk for a world of ``world`` ranks with no axis
    lines (dp only)."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    return transport.chunk_bytes([world])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the rank and cli processes this script starts read their bytecode
    # from the checkout's .pycache/ (written by the first), rather than
    # each compiling torch's modules anew: ~3 s a process on the card's
    # host, whose environment turns the writing of bytecode off
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = cache, False
    global POOLED
    POOLED = True
    try:
        return run_phases(torch)
    finally:
        close_pools()


def run_phases(torch) -> int:
    """Every phase in turn (:func:`main`, with the rank pools on)."""
    from akka_allreduce_tpu_torch.ops.kernels import build

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # the rank pools of phases 9-23 start now: their processes import
    # torch while nvcc builds, before any phase that times the host
    for world in sorted({w for w, _ in TRANSPORT_SPAWNS}):
        rank_pool(world)

    # 2. build (the C++ host library of phase 20 beside the nvcc builds)
    import concurrent.futures

    from akka_allreduce_tpu_torch import native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (native.build_library(),
                                    time.perf_counter() - t0)[1])
        info = build.build_all()
        for kernel in build.KERNELS:
            build.load(kernel)
        host_seconds = host.result()
    emit("build", seconds=time.perf_counter() - t0, kernels=info,
         native_seconds=host_seconds,
         mma_kernels=check_mma_spills(info),
         paged_kernels=ptxas_kernels(info["paged_attention"]["ptxas"]))

    # 3. kernels vs plain versions
    timed = phase_kernels(torch)

    # 4. the serving path
    served = phase_serve(torch)

    # 5. the flash kernels vs plain versions
    flash = phase_flash_kernels(torch)

    # 6. the training path, 7. its parity with the plain attention
    trained = phase_train(torch)
    parity = phase_train_parity(torch)

    # 8. the sync kernels, 9. the flagship at dp=2, 10. four ranks
    t8 = time.perf_counter()
    sync = phase_sync_kernels(torch, trained["params"])
    # 18. the ipc rank transport that phases 9, 13, 16 and 17 ride
    t18 = time.perf_counter()
    transport = phase_transport(torch)
    close_pools(3)  # no later phase runs three ranks
    t9 = time.perf_counter()
    dp = phase_train_dp(torch, trained["losses"])
    t10 = time.perf_counter()
    phase_sync4(torch)
    t11 = time.perf_counter()
    emit("sync_phases_seconds", sync_kernels=t18 - t8, transport=t9 - t18,
         train_dp=t10 - t9, sync4=t11 - t10)

    # 11. the ring kernels, 12. the ring at four ranks, 13. train at sp=2
    ring = phase_ring_kernels(torch)
    t12 = time.perf_counter()
    phase_ring4(torch)
    t13 = time.perf_counter()
    sp_launches = phase_train_sp(torch)
    t14 = time.perf_counter()
    emit("ring_phases_seconds", ring_kernels=t12 - t11, ring4=t13 - t12,
         train_sp=t14 - t13)

    # 14. the peer-memory ring and swing allreduce across rank processes
    allreduce = phase_allreduce(torch)
    t15 = time.perf_counter()
    emit("allreduce_phase_seconds", allreduce=t15 - t14)

    # 15. the train command at the CLI's defaults (head dim 32, f32)
    defaults = phase_train_defaults(torch)
    t16 = time.perf_counter()
    emit("train_defaults_phase_seconds", train_defaults=t16 - t15)

    # 16. the flagship at dp=2 under straggler deadlines
    deadline = phase_train_deadline(torch, dp["runs"])
    t17 = time.perf_counter()
    emit("train_deadline_phase_seconds", train_deadline=t17 - t16)

    # 17. the hierarchical schedule at full width, the autotuner at the
    # CLI's defaults, the bench rows
    hier = phase_hierarchical(torch)
    t17b = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="plan-") as plan_dir:
        phase_auto(torch, plan_dir)
    t17c = time.perf_counter()
    phase_bench_rows(torch)
    # the four-rank pool stays for phase 27's dp x tp and dp x pp meshes
    emit("hierarchical_auto_phase_seconds",
         seconds=time.perf_counter() - t17, hierarchical_train=t17b - t17,
         auto=t17c - t17b, bench_rows=time.perf_counter() - t17c,
         script_seconds=time.perf_counter() - T_START)

    # 19. the protocol plane: emulate's code path on the card
    protocol = phase_protocol(torch, trained["params"])
    # 20. the protocol plane across processes: cli master / worker
    cluster = phase_cluster(torch, trained["params"])
    # 21. the A5 training paths: optimizer families, EMA, generate and
    # eval, overlapped accumulation, CUDA-graph chunks, telemetry
    a5 = phase_a5(torch, trained)
    # 22. the A6 serving paths: sampling, bf16, int8 KV, speculation,
    # deadline eviction and bucketed prefill
    a6 = phase_a6(torch, served)
    # 23. train --steps-per-dispatch across ranks: CUDA-graph chunks on
    # the ipc transport
    a5r = phase_a5_ranks(torch)
    # 25. expert and tensor parallelism: parity, MoE and tp at full width,
    # MoE serving, a tp checkpoint restored at one rank
    a7 = phase_a7(torch, served)
    # 26. pipeline parallelism: gpipe and 1f1b parity, both schedules at
    # full width on two stages, a pp checkpoint restored at one rank
    a7pp = phase_a7pp(torch)
    # 27. the parallel axes' compositions: masked rounds on tp / pp / ep
    # meshes, graph chunks on tp, ep and pp, MoE under deadlines
    a7c = phase_a7c(torch, a7["moe_wall_ms_per_step"])
    # 28. training across processes: two train --coordinator processes
    # against --dp 2, a straggling process masked, the flagship's round
    a9 = phase_a9(torch, dp["runs"]["none"]["wall_ms_per_step"])
    close_pools()  # every rank process ended before the closing lines
    # 24. the A6 part 2 serving paths: watchdog and faults, drain/restore
    # across processes, the serve trace
    a24 = phase_a24(torch)
    emit("script_seconds", seconds=time.perf_counter() - T_START)
    sync_launches = {k: dp["launches"][k] + deadline["sync"][k]
                     + hier["launches"][k] + a5["sync"][k] + a5r["sync"][k]
                     + a7["sync"][k] + a7c["sync"][k] for k in SYNC_KERNELS}
    sync_launches["masked_reduce"] += protocol["launches"] \
        + cluster["launches"] + a7pp["masked_reduce"]
    transport_launches = (dp["transport"] + deadline["transport"]
                          + hier["transport"] + a5["transport"]
                          + a5r["transport"] + a7["transport"]
                          + a7pp["transport"] + a7c["transport"]
                          + sum(sp_launches[d]["transport"]
                                for d in sp_launches))
    if not transport_launches:
        raise AssertionError("the transport never launched on the main "
                             "path")

    row = timed["serve", "torch.float32"]
    long_row = timed["long", "torch.float32"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "akka_allreduce_tpu_torch/ops/kernels/csrc/"
                  "paged_attention.cu",
        "replaces": "akka_allreduce_tpu/ops/pallas_kernels/attention.py:516",
        "launches": served["launches"] + sum(a6["launches"].values())
        + sum(a24["launches"].values()) + a7["paged"],
        "serve_launches": served["launches"], "a6_launches": a6["launches"],
        "a24_launches": a24["launches"], "a7_launches": a7["paged"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "long_ms": long_row["ms"],
        "long_bound_ms": long_row["bound_ms"]}]
    # the flagship trains bf16; the f32 flash kernels run in phase 7's f32
    # run, phase 13's one-card f32 run and phase 15's one-card run
    kernels += flash_kernel_rows(flash["torch.bfloat16"], {
        k: trained["launches"][k] + deadline["flash"][k] + a5["flash"][k]
        + a5r["flash"][k] + a7["flash"][k] + a7pp["flash"][k]
        + a7c["flash"][k] + a9["flash"][k] for k in FLASH_REPLACES})
    for row in kernels[-3:]:  # phases 26-28's shares, rank 0's
        row["pp_launches"] = a7pp["flash"][row["name"]]
        row["a7c_launches"] = a7c["flash"][row["name"]]
        row["a9_launches"] = a9["flash"][row["name"]]
    f32_launches = {k: parity["float32"]["flash_launches"][k]
                    + sp_launches["float32"]["flash"][k]
                    + defaults["one_card"]["flash"][k]
                    + a9["flash_f32"][k] for k in FLASH_REPLACES}
    kernels += flash_kernel_rows(flash["torch.float32"], f32_launches, "_f32")
    for row, k in zip(kernels[-3:], FLASH_REPLACES):
        row["a9_launches"] = a9["flash_f32"][k]
    for kernel, (source, replaces) in SYNC_KERNELS.items():
        srow = sync[kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sync_launches[kernel],
            "max_abs_err": srow["max_abs_err"], "ms": srow["ms"],
            "plain_ms": srow["plain_ms"], "bound_ms": srow["bound_ms"],
            "bound_by": srow["bound_by"], "library_ms": srow["library_ms"]})
        kernels[-1]["a5_launches"] = a5["sync"][kernel]
        kernels[-1]["a5r_launches"] = a5r["sync"][kernel]
        kernels[-1]["a7_launches"] = a7["sync"][kernel]
        if kernel in A7C_SYNC_ROWS:
            kernels[-1]["a7c_launches"] = a7c["sync"][kernel]
        if kernel == "quantize_int8_prng":
            # the seed read from device memory (phase 23's int8 chunks)
            kernels[-1]["pointer_seed_ms"] = srow["pointer_seed_ms"]
        if kernel == "masked_reduce":
            # phase 19's chunk reduce: a 65,536-wide slab read in place
            strided = sync["masked_reduce_strided"]
            kernels[-1].update(protocol_launches=protocol["launches"],
                               cluster_launches=cluster["launches"],
                               pp_launches=a7pp["masked_reduce"],
                               strided_ms=strided["ms"],
                               strided_plain_ms=strided["plain_ms"],
                               strided_bound_ms=strided["bound_ms"])
    # the ring kernels of phase 13's two runs: bf16 (phase 17's
    # hierarchical run added), and f32 (named with _f32, split TF32;
    # phase 15's sp=2 run added), each timed at phase 11's past hop; the
    # f32 bound is that of three TF32 products
    for dtype, suffix in (("bfloat16", ""), ("float32", "_f32")):
        rrow = ring["slice-past", f"torch.{dtype}"]
        for kernel, err_keys, part in (
                ("ring_fwd", ("m", "l", "acc"), "forward"),
                ("ring_dq", ("dq",), "backward"),
                ("ring_dkv", ("dk", "dv"), "backward")):
            split = rrow.get("bound_tf32x3_ms", {})
            launches = sp_launches[dtype]["ring"][kernel] + (
                defaults["sp2"]["ring"][kernel] if suffix
                else hier["ring"][kernel] + a5r["ring"][kernel])
            kernels.append({
                "name": kernel + suffix, "kernel": cuda_kernel(kernel, suffix),
                "route": "cuda", "source": RING_SOURCE,
                "replaces": RING_REPLACES[kernel], "launches": launches,
                "max_abs_err": max(rrow["max_abs_err"][k]
                                   for k in err_keys),
                "ms": rrow["ms"][kernel], "plain_ms": rrow["plain_ms"][part],
                "bound_ms": split.get(kernel, rrow["bound_ms"][kernel]),
                "bound_by": rrow["bound_by"][kernel],
                "library_ms": rrow["library_ms"][part]})
    for kernel, replaces in ALLREDUCE_REPLACES.items():
        arow = allreduce[kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": ALLREDUCE_SOURCE,
            "replaces": replaces, "launches": arow["launches"],
            "kernels_per_call": arow["kernels_per_call"],
            "max_abs_err": arow["max_abs_err"], "ms": arow["ms"],
            "plain_ms": arow["plain_ms"], "bound_ms": arow["bound_ms"],
            "bound_by": arow["bound_by"], "library_ms": arow["library_ms"]})
    kernels.append(transport_kernel_row(transport, transport_launches))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
