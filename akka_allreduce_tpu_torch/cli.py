"""Command line of the port: ``serve``, ``train``, ``emulate``, ``master``
and ``worker``.

Counterparts of ``akka_allreduce_tpu/cli.py serve``, ``train``,
``emulate``, ``master`` and ``worker`` for the flags the port's slices
carry. All that hold tensors run on ``cuda`` unless ``--device cpu`` is
given, and raise when CUDA is asked for and absent; the C++ host engines
(``master --native``, ``worker --native``, ``emulate --engine native``)
hold none and refuse ``--device``.

``serve`` (model shape, slot or paged engine, closed or open synthetic
load) builds a model from ``--seed``, runs the synthetic load through
``serve_loop`` and prints ONE JSON summary line shaped like the JAX
command's::

    python -m akka_allreduce_tpu_torch.cli serve --paged \\
        --paged-attention kernel --d-model 2048 --n-heads 16 \\
        --kv-heads 4 --n-layers 8 --d-ff 8192 --vocab 32768 --rope

``train`` trains the flagship transformer from random weights on
synthetic tokens or ``--data-file``, drawing the JAX command's per-step
batches and printing its ``step N: loss X (Y tok/s)`` lines; its attention
runs the CUDA flash kernels (``ops/kernels/csrc/flash_attention.cu``).
With ``--dp N`` it runs N rank processes, each on its rows of the global
batch, whose gradients meet in the bucketed allreduce (``--grad-quant``,
``--grad-schedule``; the sync's CUDA kernels in
``ops/kernels/csrc/masked_reduce.cu`` and ``quantize.cu``). With ``--sp
S`` each row's sequence is split over S ranks more (dp x S processes in
all) whose attention runs around a ring of K/V blocks on the ring-flash
kernels (``ops/kernels/csrc/ring_flash.cu``). With ``--dp`` and ``--sp``
both > 1, ``--grad-quant ef8 --grad-schedule hierarchical`` syncs
exactly over each sp line and on the ef8 wire over each dp line;
``--grad-schedule auto`` measures the feasible schedules on the ranks at
startup and keeps the plan in ``--plan-dir`` (``ops/autotune.py``). With
``--deadline-ms`` a
data rank that misses a round's deadline is masked out of that round's
sync (``runtime/straggler.py``); ``--straggle-prob`` simulates late
ranks from each step's seeded generator, and ``--max-lag`` bounds the
rounds in flight::

    python -m akka_allreduce_tpu_torch.cli train --d-model 2048 \\
        --n-heads 16 --n-layers 8 --d-ff 8192 --vocab 32768 --seq 2048 \\
        --batch 8 --bf16 --lr 1e-4 --steps 6 --log-every 1 \\
        [--dp 2 --dist-backend gloo --grad-quant ef8] [--sp 2] \\
        [--grad-schedule hierarchical | auto --plan-dir DIR] \\
        [--deadline-ms 50 --straggle-prob 0.35 --max-lag 1]

``emulate`` runs the source paper's protocol plane in one process: a
master and N workers on the deterministic router
(``protocol/cluster.py``), the payloads, staging rows and chunk reduces
on ``--device`` (each chunk reduce one launch of
``ops/kernels/csrc/masked_reduce.cu`` on the card), with the JAX
command's flags, refusals and output lines::

    python -m akka_allreduce_tpu_torch.cli emulate --workers 4 \\
        --data-size 778 --max-chunk-size 3 --max-lag 3 --th-complete 1.0 \\
        --assert-multiple 4 [--kill-rank 1] [--fuzz 5] [--device cpu]

``emulate --engine native`` runs the same cluster on the C++ engine in
one process, on the host. ``master`` and ``worker`` run it across OS
processes over the TCP wire (``protocol/remote.py``): a worker's
payloads on ``--device`` (each chunk reduce one masked-reduce launch on
the card), the master's pacing on the host; ``--native`` runs either as
its C++ engine on the same wire::

    python -m akka_allreduce_tpu_torch.cli master --port 2551 \\
        --workers 2 --data-size 778 --max-chunk-size 3 --th-complete 1.0
    python -m akka_allreduce_tpu_torch.cli worker --master-port 2551 \\
        --data-size 778 --assert-multiple 2 [--device cpu | --native]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch


def _add_serve(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "serve", help="continuous-batching greedy inference over a "
        "random model from --seed; one JSON metrics line on stdout")
    # -- model
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="KV heads for grouped-query attention "
                        "(0 = multi-head: one per query head)")
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--ffn", choices=("gelu", "swiglu"), default="gelu")
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings instead of a learned "
                        "positional table")
    p.add_argument("--attn-window", type=int, default=0,
                   help="sliding-window causal attention (0 = full "
                        "causal); not served by --paged-attention kernel")
    p.add_argument("--max-seq", type=int, default=128,
                   help="every request needs prompt + max-new-tokens <= "
                        "this")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights and the synthetic load")
    # -- engine
    p.add_argument("--slots", type=int, default=4,
                   help="decode slots (with --paged: decode lanes)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV engine: one page pool, per-request page "
                        "tables, admission gated on free pages")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=0,
                   help="pool capacity in pages; 0 = slots * "
                        "ceil(max_seq / page_size)")
    p.add_argument("--paged-attention", choices=("gather", "kernel"),
                   default="gather",
                   help="pool read path: gather (plain PyTorch) or the "
                        "CUDA paged-attention kernel "
                        "(ops/kernels/csrc/paged_attention.cu)")
    p.add_argument("--decode-steps", type=int, default=1, metavar="S",
                   help="decode steps per dispatch (one host readback "
                        "per S tokens)")
    # -- synthetic load
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--load", choices=("closed", "open"), default="closed",
                   help="closed = all requests queued at t0; open = "
                        "Poisson arrivals at --arrival-rate")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="open loop: mean arrivals per second")
    p.add_argument("--prompt-len", default="4:16", metavar="MIN:MAX",
                   help="synthetic prompt length range (uniform)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--eos-token", type=int, default=None)
    # -- device
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without CUDA raises")


def _add_train(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("train", help="train the flagship transformer on "
                                     "one card")
    p.add_argument("--steps", type=int, default=20)
    # -- model
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="KV heads for grouped-query attention "
                        "(0 = multi-head: one per query head)")
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings instead of a learned "
                        "positional table")
    p.add_argument("--ffn", choices=("gelu", "swiglu"), default="gelu")
    p.add_argument("--attn-window", type=int, default=0,
                   help="sliding-window causal attention: each position "
                        "sees itself + N-1 predecessors (0 = full causal)")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="output head reuses the input embedding")
    # -- batch and optimizer
    p.add_argument("--batch", type=int, default=0,
                   help="batch (0 = 2 x --grad-accum)")
    p.add_argument("--seq", type=int, default=0,
                   help="global sequence length (0 = 32 x --sp)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant",
                   help="cosine = linear warmup then cosine decay to 0 "
                        "at --steps")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--bucket-elems", type=int, default=1 << 16,
                   help="gradient bucket size of the multi-rank sync: the "
                        "flattened gradients cut into rows of this many "
                        "elements, one wire chunk each")
    # -- data parallelism and the gradient wire
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one process each; rank r "
                        "trains on rows [r*B/N, (r+1)*B/N) of each global "
                        "batch (1 = this process alone)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks per data-parallel rank, "
                        "one process each: rank (i, j) trains on columns "
                        "[j*T/S, (j+1)*T/S) of its rows, attention runs "
                        "around the ring of the S ranks, and the gradient "
                        "sync spans all dp x S ranks")
    p.add_argument("--dist-backend", choices=("nccl", "gloo", "ipc"),
                   default=None,
                   help="process-group backend with dp x sp > 1 (default: "
                        "nccl on cuda, gloo on cpu). nccl needs one GPU "
                        "per rank; gloo runs several ranks on one card "
                        "and moves the wire through host memory; ipc "
                        "(cuda only) runs several ranks on the cards of "
                        "one host and moves every payload device to "
                        "device through CUDA IPC peer buffers, gloo "
                        "carrying only the control plane; at most 32 "
                        "ranks, whose fixed buffers take at most 1 GiB "
                        "of the card a rank (their chunk shrinks as the "
                        "mesh grows)")
    p.add_argument("--int8-grads", action="store_true",
                   help="int8-quantized gradient allreduce transport "
                        "(alias of --grad-quant int8)")
    p.add_argument("--bf16-grads", action="store_true",
                   help="bf16 gradient allreduce transport (alias of "
                        "--grad-quant bf16); masters/optimizer stay f32")
    p.add_argument("--grad-quant",
                   choices=("none", "bf16", "int8", "ef8"), default=None,
                   help="gradient-wire format: none = f32; bf16 = half "
                        "the bytes, plain rounding; int8 = per-bucket-row "
                        "scales, stochastic rounding on both hops; ef8 = "
                        "int8 with one scale per 512 columns and an "
                        "error-feedback residual carried across steps. "
                        "Supersedes --int8-grads/--bf16-grads")
    p.add_argument("--grad-schedule",
                   choices=("fused", "windowed", "swing", "hierarchical",
                            "auto"), default="fused",
                   help="gradient-collective schedule: fused (one "
                        "reduce-scatter + all-gather per sync); windowed "
                        "(the bucket axis in --grad-windows windows, one "
                        "window's all-gather issued after the next one's "
                        "reduce-scatter); swing (log2(N) exchanges of the "
                        "running sum with the rank at XOR distance 2^t; "
                        "power-of-two --dp); hierarchical (--grad-quant "
                        "ef8 with --dp and --sp both > 1: the exact "
                        "reduce-scatter over each sp line, the ef8 wire "
                        "over each dp line, the exact all-gather back); "
                        "auto (measures every feasible schedule on the "
                        "ranks at startup, keeps the plan as a JSON "
                        "sidecar in --plan-dir/--ckpt-dir and reloads it "
                        "on restart)")
    p.add_argument("--grad-windows", type=int, default=4, metavar="W",
                   help="window count for --grad-schedule windowed")
    p.add_argument("--plan-dir", default=None,
                   help="directory for --grad-schedule auto's measured "
                        "collective plan (default: --ckpt-dir)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute with f32 master weights")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the "
                        "backward pass (memory saver)")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="split the batch into K microbatches, summing "
                        "their gradients before one update")
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor", "sgd", "lion"),
                   help="optimizer family; only adamw is ported yet")
    # -- checkpoints, data, logging, device
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory; resumes from the latest "
                        "checkpoint if one exists")
    p.add_argument("--ckpt-every", type=int, default=10,
                   help="save interval in steps")
    # -- straggler deadlines
    p.add_argument("--deadline-ms", type=float, default=0,
                   help="per-round straggler deadline: data ranks whose "
                        "contribution misses it are masked that round and "
                        "the mean is count-rescaled (dynamic lossy sync)")
    p.add_argument("--straggle-prob", type=float, default=0.0,
                   help="simulated probability per data rank per round of "
                        "missing the deadline (demo/testing; real "
                        "deployments report arrivals over DCN)")
    p.add_argument("--max-lag", type=int, default=1,
                   help="extra rounds allowed in flight beyond the one "
                        "being applied (0 = lockstep; the reference's "
                        "maxLag)")
    p.add_argument("--data-file", default=None,
                   help="train on a corpus: raw bytes (vocab 256) or "
                        "*.bin little-endian uint16 tokens (vocab 65536); "
                        "omitted = synthetic random tokens. Batches are "
                        "deterministic in the step index")
    p.add_argument("--log-every", type=int, default=10,
                   help="print a progress line every N steps")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without CUDA raises")


# -- emulate: the source paper's protocol plane ---------------------------

def _add_emulate(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "emulate", help="run the in-process protocol cluster "
        "(reference master defaults: AllreduceMaster.scala:98-107)")
    _add_cluster_flags(p)
    p.add_argument("--checkpoint", type=int, default=50,
                   help="throughput print interval in rounds")
    p.add_argument("--assert-multiple", type=int, default=0,
                   help="assert output == N x input (needs thresholds 1.0)")
    p.add_argument("--kill-rank", type=int, default=None,
                   help="kill this rank after registration (fault demo)")
    p.add_argument("--fuzz", type=int, default=0, metavar="N",
                   help="race-detect THIS config instead of running it "
                        "once: replay it under N seeded-random message "
                        "interleavings plus per-actor starvation and "
                        "rotation schedules (protocol/explorer.py),"
                        " checking rounds complete and — with "
                        "--assert-multiple — exact outputs under every "
                        "ordering; python engine only")
    p.add_argument("--trace-file", default=None,
                   help="write the structured protocol trace (JSONL: "
                        "rounds, members, deaths) here on exit")
    p.add_argument("--engine", choices=("python", "native"),
                   default="python",
                   help="protocol engine: python (the spec; supports "
                        "tracing and per-round sinks; its payloads on "
                        "--device) or native (the C++ engine on the host, "
                        "~100x rounds/s; throughput only)")
    p.add_argument("--device", default=None,
                   help="python engine: cuda (default) or cpu, where the "
                        "payloads, the staging rows and the chunk reduce "
                        "live; cuda without CUDA raises. Refused with "
                        "--engine native (a host engine)")


def _add_cluster_flags(p: argparse.ArgumentParser) -> None:
    """The cluster's shape, as ``emulate`` and ``master`` take it (the
    reference master's defaults)."""
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--data-size", type=int, default=None,
                   help="default: workers * 5 (reference default)")
    p.add_argument("--max-chunk-size", type=int, default=2)
    p.add_argument("--max-round", type=int, default=100)
    p.add_argument("--max-lag", type=int, default=1)
    p.add_argument("--th-allreduce", type=float, default=1.0)
    p.add_argument("--th-reduce", type=float, default=1.0)
    p.add_argument("--th-complete", type=float, default=0.8)


def check_emulate_flags(args: argparse.Namespace) -> None:
    """The JAX command's refusals, in its order (ValueError with the
    operator's message; the command returns 2 for each)."""
    import math
    if args.assert_multiple > 0 and not (
            args.th_allreduce == args.th_reduce == args.th_complete == 1.0):
        raise ValueError("--assert-multiple requires all thresholds at 1.0 "
                         "(lossy rounds legitimately produce partial "
                         "sums); pass --th-complete 1.0 etc.")
    emulate_config(args)  # the config's own checks
    if args.kill_rank is not None \
            and not 0 <= args.kill_rank < args.workers:
        raise ValueError(f"--kill-rank {args.kill_rank} is not a worker "
                         f"seat (0..{args.workers - 1})")
    if args.fuzz > 0:
        if args.engine == "native":
            raise ValueError("--fuzz schedules the python engine's "
                             "deterministic router; the native engine has "
                             "its own loop (drop --engine native)")
        if args.trace_file:
            raise ValueError("--fuzz runs many clusters and writes no "
                             "trace; drop --trace-file (re-run the single "
                             "failing schedule without --fuzz to trace it)")
        if args.kill_rank is not None:
            # the validator demands every round complete with N-1 live
            # workers, so each threshold's required count ceil(th*N) must
            # be satisfiable by N-1 — otherwise every schedule "fails" and
            # a config impossibility is presented as a race
            unreachable = [
                f"{flag} {th} needs ceil({th}*{args.workers})="
                f"{math.ceil(th * args.workers)} workers"
                for flag, th in (("--th-allreduce", args.th_allreduce),
                                 ("--th-reduce", args.th_reduce),
                                 ("--th-complete", args.th_complete))
                if math.ceil(th * args.workers) > args.workers - 1]
            if unreachable:
                raise ValueError(
                    f"--fuzz --kill-rank runs with {args.workers - 1} live "
                    f"workers, but " + "; ".join(unreachable)
                    + " — lower the threshold(s) or raise --workers")
    elif args.engine == "native":
        if args.trace_file:
            raise ValueError("--engine native does not produce traces "
                             "(use the python engine)")
        check_host_engine(args.device, "--engine native")


def check_host_engine(device, flag: str) -> None:
    """A C++ engine holds no tensor: an explicit ``--device`` with it is
    refused (ValueError; the command returns 2), never ignored."""
    if device is not None:
        raise ValueError(f"--device {device} cannot be used with {flag}: "
                         f"the C++ engine is a host engine with no tensor "
                         f"on any device (drop --device, or run the "
                         f"python engine)")


def emulate_config(args: argparse.Namespace):
    """``(AllreduceConfig, data_size)`` from the emulate flags, with the
    reference's default data size (workers * 5)."""
    from akka_allreduce_tpu_torch.config import (AllreduceConfig, DataConfig,
                                                 ThresholdConfig, WorkerConfig)
    data_size = args.workers * 5 if args.data_size is None else args.data_size
    config = AllreduceConfig(
        thresholds=ThresholdConfig(args.th_allreduce, args.th_reduce,
                                   args.th_complete),
        data=DataConfig(data_size=data_size,
                        max_chunk_size=args.max_chunk_size,
                        max_round=args.max_round),
        workers=WorkerConfig(total_size=args.workers, max_lag=args.max_lag),
    )
    return config, data_size


def run_fuzz(args: argparse.Namespace, device, tracer=None
             ) -> "tuple[list, int, float]":
    """``emulate --fuzz``: the config under the standard schedules
    (protocol/explorer.py), each run checked on ``device``: every paced
    round completes, every survivor flushes every round, and each flush
    is honest (``data == arange * count``; ``count == N`` with
    --assert-multiple). ``tracer`` (optional) traces every schedule's
    cluster. Returns (failures, schedules, seconds)."""
    import torch

    from akka_allreduce_tpu_torch.protocol.cluster import (
        LocalCluster, constant_range_source)
    from akka_allreduce_tpu_torch.protocol.explorer import (
        explore, standard_schedules)
    config, data_size = emulate_config(args)
    outputs: dict = {}
    base = torch.arange(data_size, dtype=torch.float64, device=device)

    def make():
        for r in range(args.workers):
            outputs[r] = []
        return LocalCluster(
            config,
            source_factory=lambda r: constant_range_source(data_size, device),
            sink_factory=lambda r: outputs[r].append, tracer=tracer,
            device=device)

    def validate(cluster):
        if len(cluster.completed_rounds) != args.max_round:
            raise AssertionError(
                f"{len(cluster.completed_rounds)}/{args.max_round} "
                f"rounds completed")
        for r in range(args.workers):
            if r == args.kill_rank:
                continue
            if len(outputs[r]) != args.max_round + 1:
                raise AssertionError(
                    f"worker {r} flushed {len(outputs[r])} outputs, "
                    f"wanted {args.max_round + 1}")
            for out in outputs[r]:
                if args.assert_multiple:
                    assert bool((out.count == args.assert_multiple).all())
                if not torch.allclose(out.data.double(),
                                      base * out.count.double(),
                                      rtol=1e-6, atol=0.0):
                    raise AssertionError(
                        f"worker {r} round {out.iteration}: data != "
                        f"arange * count")

    names = ["master"] + [f"worker-{r}" for r in range(args.workers)]
    prepare = None
    if args.kill_rank is not None:
        prepare = lambda c: c.kill_worker(args.kill_rank)  # noqa: E731
    scheds = list(standard_schedules(names, seeds=args.fuzz))
    t0 = time.perf_counter()
    failures = explore(make, scheds, validate, prepare=prepare)
    return failures, len(scheds), time.perf_counter() - t0


def _cmd_emulate(args: argparse.Namespace) -> int:
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.protocol.cluster import (
        LocalCluster, ThroughputSink, constant_range_source)
    from akka_allreduce_tpu_torch.runtime.tracing import tracer_to_file
    try:
        check_emulate_flags(args)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    config, data_size = emulate_config(args)
    if args.engine == "native":
        from akka_allreduce_tpu_torch.protocol.native_cluster import (
            run_native_cluster)
        t0 = time.perf_counter()
        rounds, flushed = run_native_cluster(
            config, kill_rank=args.kill_rank,
            assert_multiple=args.assert_multiple)
        dt = time.perf_counter() - t0
        print(f"completed {rounds}/{args.max_round} rounds in {dt:.3f}s "
              f"({rounds / dt if dt > 0 else float('inf'):,.0f} rounds/s, "
              f"{flushed} flushes, native engine, host)")
        return 0 if rounds == args.max_round \
            or args.kill_rank is not None else 1
    device = resolve_device(args.device or "cuda")
    if args.fuzz > 0:
        failures, n_scheds, dt = run_fuzz(args, device)
        if failures:
            for f in failures[:10]:
                print(f"FAIL {f}", file=sys.stderr)
            print(f"{len(failures)}/{n_scheds} schedules violated "
                  f"invariants", file=sys.stderr)
            return 1
        print(f"fuzz: {n_scheds} schedules x {args.max_round} rounds "
              f"each, 0 violations ({dt:.2f}s)")
        return 0

    sinks = [ThroughputSink(data_size, checkpoint=args.checkpoint,
                            assert_multiple=args.assert_multiple,
                            verbose=(rank == 0), device=device)
             for rank in range(args.workers)]
    with tracer_to_file(args.trace_file) as tracer:
        cluster = LocalCluster(
            config,
            source_factory=lambda r: constant_range_source(data_size, device),
            sink_factory=lambda r: sinks[r], tracer=tracer, device=device)
        t0 = time.perf_counter()
        rounds = cluster.run(kill_rank=args.kill_rank)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    if args.trace_file:
        print(f"trace -> {args.trace_file}")
    print(f"completed {rounds}/{args.max_round} rounds in {dt:.2f}s "
          f"({args.workers} workers, dataSize={data_size}, "
          f"chunk={args.max_chunk_size}, maxLag={args.max_lag})")
    return 0 if rounds == args.max_round or args.kill_rank is not None else 1


# -- master / worker: the protocol plane across processes -----------------

def _add_master(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "master", help="run a master process over the native TCP transport "
        "(reference: AllreduceMaster.scala:95-112)")
    p.add_argument("--port", type=int, default=2551)
    p.add_argument("--bind-host", default="127.0.0.1")
    _add_cluster_flags(p)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--native", action="store_true",
                   help="run the C++ master engine (native/src/"
                        "remote_master.cpp): same wire, so Python and "
                        "native workers join it interchangeably. "
                        "--trace-file is a Python-engine feature")
    _add_liveness_flags(p)


def _add_liveness_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace-file", default=None,
                   help="write the structured protocol+liveness trace "
                        "(JSONL) here on exit")
    p.add_argument("--heartbeat-interval", type=float, default=2.0,
                   help="seconds between transport Pings")
    p.add_argument("--unreachable-after", type=float, default=10.0,
                   help="down a silent peer after this many seconds "
                   "(reference: application.conf:20 auto-down-unreachable-"
                   "after = 10s); 0 disables liveness detection")


def _cmd_master(args: argparse.Namespace) -> int:
    from akka_allreduce_tpu_torch.protocol.remote import (run_master,
                                                          run_master_native)

    config, _ = emulate_config(args)
    if args.native:
        if args.trace_file:
            print("warning: --trace-file is a Python-engine feature; "
                  "the native master writes no trace", file=sys.stderr)
        rounds = run_master_native(
            config, bind_host=args.bind_host, port=args.port,
            timeout_s=args.timeout,
            heartbeat_interval_s=args.heartbeat_interval,
            unreachable_after_s=args.unreachable_after or None)
        sys.stdout.flush()
        print(f"master: {rounds}/{args.max_round} rounds (native engine, "
              f"host)")
    else:
        rounds = run_master(
            config, bind_host=args.bind_host, port=args.port,
            timeout_s=args.timeout,
            heartbeat_interval_s=args.heartbeat_interval,
            unreachable_after_s=args.unreachable_after or None,
            trace_file=args.trace_file)
    return 0 if rounds == args.max_round else 1


def _add_worker(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "worker", help="run a worker process over the native TCP transport "
        "(reference: AllreduceWorker.scala:309-315)")
    p.add_argument("--master-host", default="127.0.0.1",
                   help="master address, or a comma list of seed "
                        "addresses host[:port] tried in order — ANY "
                        "seed admits the worker, mirroring the "
                        "reference's seed-node list "
                        "(application.conf:14-16); entries without a "
                        "port use --master-port")
    p.add_argument("--master-port", type=int, default=2551)
    p.add_argument("--rejoin-timeout", type=float, default=0.0,
                   help="> 0: treat a master disconnect as a possible "
                        "restart instead of shutdown — cold-reset and "
                        "redial through the seed list for up to this "
                        "many seconds (both engines)")
    p.add_argument("--data-size", type=int, default=None,
                   help="synthetic source length, default 10 (must match "
                        "the master's; ignored with --native, which "
                        "takes geometry from InitWorkers)")
    p.add_argument("--checkpoint", type=int, default=10,
                   help="throughput print interval in rounds")
    p.add_argument("--assert-multiple", type=int, default=0,
                   help="assert output == N x input (needs thresholds 1.0)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--native", action="store_true",
                   help="run the C++ worker engine (native/src/"
                        "remote_worker.cpp) instead of the Python engine "
                        "— same protocol, same wire, bit-identical "
                        "outputs, on the host. The silent-peer "
                        "failure detector (--unreachable-after) and "
                        "--trace-file are Python-engine features")
    p.add_argument("--device", default=None,
                   help="python engine: cuda (default) or cpu, where the "
                        "payloads, the staging rows and the chunk reduce "
                        "live; cuda without CUDA raises. Refused with "
                        "--native (a host engine)")
    p.add_argument("--assert-honest", action="store_true",
                   help="python engine: check EVERY flush, at any "
                        "threshold: output == input x count (and, with "
                        "--assert-multiple, count == N); refused with "
                        "--native")
    _add_liveness_flags(p)


def _parse_seeds(master_host: str, master_port: int) -> list:
    """``host[:port],host2[:port2],...`` -> [(host, port), ...]."""
    seeds = []
    for entry in master_host.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            host, _, port_s = entry.rpartition(":")
            seeds.append((host, int(port_s)))
        else:
            seeds.append((entry, master_port))
    if not seeds:
        raise SystemExit("--master-host: no seed addresses given")
    return seeds


def _cmd_worker(args: argparse.Namespace) -> int:
    from akka_allreduce_tpu_torch.protocol.remote import (run_worker,
                                                          run_worker_native)

    seeds = _parse_seeds(args.master_host, args.master_port)
    if args.native:
        try:
            check_host_engine(args.device, "--native")
            if args.assert_honest:
                raise ValueError("--assert-honest is a Python-engine "
                                 "check; the C++ worker has its own "
                                 "--assert-multiple")
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if args.trace_file:
            print("warning: --trace-file is a Python-engine feature; "
                  "the native worker writes no trace", file=sys.stderr)
        if args.unreachable_after != 10.0:
            print("warning: --unreachable-after is ignored with "
                  "--native (the C++ engine downs peers on TCP "
                  "disconnect only; hung-but-connected peers are the "
                  "Python router's detector)", file=sys.stderr)
        if args.data_size is not None:
            print("note: --native derives the data geometry from the "
                  "master's InitWorkers; --data-size is ignored",
                  file=sys.stderr)
        # the C++ engine carries the seed list AND the rejoin window
        # natively (aat_remote_worker_run_seeds): engine parity with the
        # Python worker's master-restart failover
        try:
            outputs = run_worker_native(
                checkpoint=args.checkpoint,
                assert_multiple=args.assert_multiple,
                timeout_s=args.timeout, verbose=args.verbose,
                heartbeat_interval_s=args.heartbeat_interval,
                seeds=seeds, rejoin_timeout_s=args.rejoin_timeout)
        except (ConnectionError, ValueError) as exc:
            # ValueError = malformed seed list (e.g. an empty host the
            # flag parser let through) — same clean-exit convention
            print(f"error: {exc}", file=sys.stderr)
            return 1
        sys.stdout.flush()
        print(f"native worker: {outputs} outputs (native engine, host)")
    else:
        outputs = run_worker(source_data_size=(10 if args.data_size is None
                                               else args.data_size),
                             checkpoint=args.checkpoint,
                             assert_multiple=args.assert_multiple,
                             timeout_s=args.timeout, verbose=args.verbose,
                             heartbeat_interval_s=args.heartbeat_interval,
                             unreachable_after_s=args.unreachable_after
                             or None,
                             trace_file=args.trace_file,
                             seeds=seeds,
                             rejoin_timeout_s=args.rejoin_timeout,
                             device=args.device or "cuda",
                             assert_honest=args.assert_honest)
    return 0 if outputs > 0 else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="akka_allreduce_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_serve(sub)
    _add_train(sub)
    _add_emulate(sub)
    _add_master(sub)
    _add_worker(sub)
    return parser


def _validate(args: argparse.Namespace) -> "tuple[int, int]":
    """Flag checks the JAX command makes; returns the prompt-length
    range. Raises ValueError with the operator's message."""
    try:
        lo, _, hi = args.prompt_len.partition(":")
        p_lo, p_hi = int(lo), int(hi or lo)
    except ValueError:
        raise ValueError(f"bad --prompt-len {args.prompt_len!r} "
                         f"(want MIN:MAX)") from None
    if not 1 <= p_lo <= p_hi:
        raise ValueError(f"--prompt-len needs 1 <= MIN <= MAX, got "
                         f"{p_lo}:{p_hi}")
    if args.decode_steps < 1:
        raise ValueError(f"--decode-steps must be >= 1, got "
                         f"{args.decode_steps}")
    if args.max_new_tokens < 1:
        raise ValueError(f"--max-new-tokens must be >= 1, got "
                         f"{args.max_new_tokens}")
    if p_hi + args.max_new_tokens > args.max_seq:
        raise ValueError(f"--prompt-len max {p_hi} + --max-new-tokens "
                         f"{args.max_new_tokens} exceeds --max-seq "
                         f"{args.max_seq}")
    if args.requests < 1:
        raise ValueError("--requests must be >= 1")
    if args.load == "open" and args.arrival_rate <= 0:
        raise ValueError("--load open needs --arrival-rate > 0")
    if args.eos_token is not None \
            and not 0 <= args.eos_token < args.vocab:
        raise ValueError(f"--eos-token {args.eos_token} out of vocab "
                         f"[0, {args.vocab})")
    return p_lo, p_hi


def make_requests(args: argparse.Namespace, p_lo: int, p_hi: int) -> list:
    """The synthetic load, drawn exactly as the JAX command draws it
    (same generator, same order), so one seed gives one load in both."""
    from akka_allreduce_tpu_torch.serving import Request
    rng = np.random.default_rng(args.seed)
    arrivals = np.zeros(args.requests)
    if args.load == "open":
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             size=args.requests))
    t0 = time.monotonic()
    reqs = []
    for rid in range(args.requests):
        plen = int(rng.integers(p_lo, p_hi + 1))
        arrival = t0 + float(arrivals[rid])
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(x) for x in rng.integers(0, args.vocab,
                                                       size=plen)),
            max_new_tokens=args.max_new_tokens,
            eos_token=args.eos_token, arrival=arrival,
            submitted_at=arrival))
    return reqs


def run_serve(args: argparse.Namespace):
    """Build the model and engine, serve the synthetic load, and return
    ``(report, results, engine)``: the summary dict the command prints,
    ``{rid: (tokens, reason)}``, and the engine (its parameters and
    counters). Raises ValueError on a bad flag combination and
    RuntimeError when CUDA is asked for and absent."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer)
    from akka_allreduce_tpu_torch.serving import (
        EngineConfig, PagedEngineConfig, PagedServingEngine, QueueFull,
        RequestScheduler, SchedulerConfig, ServingEngine, ServingMetrics,
        serve_loop)

    device = resolve_device(args.device)
    p_lo, p_hi = _validate(args)
    mcfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_seq=args.max_seq,
        n_kv_heads=args.kv_heads or None, rope=args.rope, ffn=args.ffn,
        attn_window=args.attn_window or None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_transformer(generator, mcfg)
    if args.paged:
        engine = PagedServingEngine(params, mcfg, PagedEngineConfig(
            num_slots=args.slots, decode_steps=args.decode_steps,
            page_size=args.page_size, num_pages=args.num_pages,
            attention_impl=args.paged_attention))
    else:
        engine = ServingEngine(params, mcfg, EngineConfig(
            num_slots=args.slots, decode_steps=args.decode_steps))
    metrics = ServingMetrics()
    if args.paged:
        metrics.attach_paging(engine.paging_summary)
    sched = RequestScheduler(SchedulerConfig(max_queue_depth=256),
                             num_slots=args.slots,
                             on_reject=metrics.on_reject)
    for req in make_requests(args, p_lo, p_hi):
        metrics.on_submit(req.rid)
        try:
            sched.submit(req)
        except QueueFull:
            pass  # counted through on_reject
    results = serve_loop(engine, sched, metrics=metrics)
    report = {
        "config": {"slots": args.slots, "requests": args.requests,
                   "load": args.load, "policy": "fifo", "th_step": 0.0,
                   "kv_cache": "model", "prefill_buckets": [],
                   "decode_steps": args.decode_steps,
                   "max_new_tokens": args.max_new_tokens,
                   "paged": args.paged, "temperature": 0.0,
                   **({"page_size": args.page_size,
                       "num_pages": engine.pool.capacity,
                       "paged_attention": args.paged_attention}
                      if args.paged else {})},
        "device": {"type": device.type,
                   "name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "matmul_allow_tf32":
                       torch.backends.cuda.matmul.allow_tf32},
        "blocked_on_memory": sched.blocked_on_memory,
        "completed_reasons": {
            reason: sum(1 for _toks, r in results.values() if r == reason)
            for reason in {r for _, r in results.values()}},
        "dead_letter": [
            {"rid": req.rid, "attempts": req.attempts, "reason": rsn}
            for req, rsn in sched.dead_letter],
        "dead_letter_dropped": sched.dead_letter_dropped,
        "decode_dispatches": engine.decode_dispatches,
        "prefill_dispatches": engine.prefill_dispatches,
        "prefill_programs": len(engine.prefill_shapes),
        "kv_cache_mb": round(engine.kv_cache_bytes() / 1e6, 2),
        **metrics.summary(),
    }
    return report, results, engine


def _cmd_serve(args: argparse.Namespace) -> int:
    try:
        report, _results, _engine = run_serve(args)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(report))
    return 0


def grad_wire(args: argparse.Namespace) -> str:
    """The gradient wire from --grad-quant and its legacy aliases, as the
    JAX command resolves them (ValueError when they contradict)."""
    if args.int8_grads and args.bf16_grads:
        raise ValueError("pick ONE gradient wire: --int8-grads or "
                         "--bf16-grads")
    legacy = ("int8" if args.int8_grads
              else "bf16" if args.bf16_grads else None)
    if args.grad_quant is None:
        return legacy or "f32"
    wire = "f32" if args.grad_quant == "none" else args.grad_quant
    if legacy is not None and legacy != wire:
        raise ValueError(f"--grad-quant {args.grad_quant} contradicts "
                         f"--{legacy}-grads — drop the legacy flag "
                         f"(--grad-quant is the one spelling)")
    return wire


def train_config(args: argparse.Namespace, seq: int,
                 attn_impl: "str | None" = None):
    """The ``train`` flags -> TrainConfig (f32 master weights)."""
    from akka_allreduce_tpu_torch.models.train import TrainConfig
    from akka_allreduce_tpu_torch.models.transformer import \
        TransformerConfig
    mcfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_seq=seq,
        n_kv_heads=args.kv_heads or None, rope=args.rope, ffn=args.ffn,
        attn_window=args.attn_window or None,
        tie_embeddings=args.tie_embeddings)
    return TrainConfig(
        model=mcfg, learning_rate=args.lr, bucket_elems=args.bucket_elems,
        compute_dtype="bf16" if args.bf16 else "f32", remat=args.remat,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=args.steps, clip_norm=args.clip_norm,
        optimizer=args.optimizer, grad_accum=args.grad_accum,
        attn_impl=attn_impl or "auto", grad_transport=grad_wire(args),
        transport_schedule=args.grad_schedule, num_windows=args.grad_windows)


def _two_phase_geometry_error(feature: str, data_axes: dict, remedy: str,
                             wire: str = "", power_of_two: bool = False
                             ) -> "str | None":
    """The JAX command's check of the collective geometry a train flag
    demands: exactly one >1 data axis (the quantized wires and the
    windowed and swing schedules), and for swing a power-of-two axis
    size. Returns the error message, or None when the geometry holds."""
    wide = [f"{k}={v}" for k, v in data_axes.items() if v > 1]
    if len(wide) > 1:
        return (f"{feature} needs a single >1 data axis, got "
                f"{' '.join(wide)}; {remedy}")
    axis_size = max(data_axes.values())
    if power_of_two and axis_size & (axis_size - 1):
        return (f"{feature}{f' with a {wire} wire' if wire else ''} "
                f"needs a power-of-two data-axis size (the ±2^t "
                f"exchange pairing), got {axis_size}; {remedy}")
    return None


def _check_train_flags(args: argparse.Namespace) -> "tuple[int, int, str]":
    """Flag checks with the arithmetic spelled out; returns (global batch,
    global sequence, backend). ValueError / NotImplementedError on a bad
    or an unported combination."""
    from akka_allreduce_tpu_torch.models.train import check_supported
    from akka_allreduce_tpu_torch.parallel.group import check_backend
    from akka_allreduce_tpu_torch.parallel.ring_attention import \
        _check_window_fits
    if args.steps < 0 or args.grad_accum < 1:
        raise ValueError("--steps must be >= 0 and --grad-accum >= 1")
    if args.dp < 1 or args.sp < 1:
        raise ValueError(f"--dp and --sp must be >= 1, got {args.dp} and "
                         f"{args.sp}")
    if args.grad_windows < 1:
        raise ValueError(f"--grad-windows must be >= 1, got "
                         f"{args.grad_windows}")
    if args.deadline_ms < 0:
        raise ValueError("--deadline-ms must be >= 0 (0 disables "
                         "deadlines)")
    if args.straggle_prob and not args.deadline_ms:
        raise ValueError("--straggle-prob needs --deadline-ms")
    if args.max_lag < 0:
        # the JAX command leaves this to RoundPacer; checked here before
        # any rank is spawned
        raise ValueError("max_lag must be >= 0")
    dp, sp = args.dp, args.sp
    b = args.batch or 2 * dp * args.grad_accum
    t = args.seq or 32 * sp
    if b % dp:
        raise ValueError(f"--batch {b} must divide over --dp {dp} ranks")
    if (b // dp) % args.grad_accum:
        raise ValueError(f"--grad-accum {args.grad_accum} must divide the "
                         f"per-rank batch {b // dp} (= batch {b} / {dp} "
                         f"ranks)")
    if t % sp:
        raise ValueError(f"--seq {t} must divide over --sp {sp} ranks "
                         f"(each holds T / sp positions)")
    if sp > 1 and args.attn_window:
        _check_window_fits(args.attn_window, t // sp)
    # the quantized wires and the windowed and swing schedules need
    # exactly one >1 data axis (and swing a power-of-two one); the
    # hierarchical schedule is the ef8 wire over exactly two
    data_axes = {"dp": dp, "sp": sp}
    wire = grad_wire(args)
    if args.grad_schedule == "hierarchical":
        if wire != "ef8":
            raise ValueError("--grad-schedule hierarchical IS the ef8 "
                             "ICI x DCN hybrid (the compressed slow-plane "
                             "leg is its point) — pair it with "
                             "--grad-quant ef8")
        wide = [f"{k}={v}" for k, v in data_axes.items() if v > 1]
        if len(wide) != 2:
            raise ValueError(
                f"--grad-schedule hierarchical needs exactly two >1 data "
                f"axes (outer = DCN group, inner = ICI axis), got "
                f"{' '.join(wide) or 'none'} — reshape the mesh (e.g. "
                f"--dp 2 --sp 2) or use a single-axis schedule")
    elif wire in ("int8", "ef8"):
        # auto on the hierarchical geometry (ef8, two >1 data axes) is
        # legal: the autotuner measures the hierarchical arm there
        two_wide = len([v for v in data_axes.values() if v > 1]) == 2
        if not (args.grad_schedule == "auto" and wire == "ef8"
                and two_wide):
            err = _two_phase_geometry_error(
                f"--grad-quant {wire}", data_axes,
                remedy="use f32/bf16 transport, fold the parallelism into "
                       "dp, or (ef8, two axes) --grad-schedule hierarchical "
                       "(measured by --grad-schedule auto)")
            if err:
                raise ValueError(err)
    if args.grad_schedule in ("windowed", "swing"):
        err = _two_phase_geometry_error(
            f"--grad-schedule {args.grad_schedule}", data_axes,
            remedy="fold the parallelism into dp or use --grad-schedule "
                   "fused", wire=wire,
            power_of_two=args.grad_schedule == "swing")
        if err:
            raise ValueError(err)
    check_supported(train_config(args, t))
    device = "cuda" if args.device.startswith("cuda") else args.device
    backend = args.dist_backend or ("nccl" if device == "cuda" else "gloo")
    if dp * sp > 1:
        check_backend(backend, device, dp * sp)
    return b, t, backend


def run_train(args: argparse.Namespace, params: "dict | None" = None,
              attn_impl: "str | None" = None) -> dict:
    """Train for ``args.steps`` steps and return the report: per-step
    losses and wall ms, tokens/s and MFU over the steps after the first,
    and the kernels' launch counts during the run (``launches``: flash;
    ``ring_launches``: ring flash; ``sync_launches``: the gradient
    sync's). ``params`` (optional) are the starting weights (on one rank
    updated in place; with more ranks each trains a copy); otherwise they
    are random from seed 0. ``attn_impl`` overrides the config's "auto"
    (the flash or ring-flash path).

    With ``--dp N`` x ``--sp S`` > 1 the CUDA kernels are built here
    first (the ranks never race ``nvcc``), then N x S rank processes
    train (``parallel/group.py spawn_ranks``); only rank 0 prints, and
    the report is rank 0's, with ``dist`` (backend, world) and ``ranks``
    (each rank's peak memory, sync and attention-exchange ms per step and
    parameter checksum) added. With ``--deadline-ms`` the rounds run
    through a ``DeadlineTrainer``: each round's loss is read when the
    pacer harvests it, and ``deadline`` reports per round the ranks the
    clock saw late (``n_masked``), whether it fell back to an exact round
    and its ``min_bucket_count``. Raises ValueError on bad flags,
    NotImplementedError on what the port has not ported, RuntimeError
    when CUDA is asked for and absent."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models.train import tree_map
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

    device = resolve_device(args.device)
    _b, _t, backend = _check_train_flags(args)
    world = args.dp * args.sp
    if world == 1:
        return _train(args, params, attn_impl, None, device)
    if device.type == "cuda":
        from akka_allreduce_tpu_torch.ops.kernels import build
        build.build_all()
    host = None if params is None else tree_map(
        lambda p: p.detach().cpu(), params)
    reports = spawn_ranks(_train_rank, world, backend, device.type, args,
                          host, attn_impl, sp=args.sp)
    report = reports[0]
    report["ranks"] = [r.pop("rank_info") for r in reports]
    return report


def _train_rank(group, args: argparse.Namespace, params, attn_impl):
    """One rank of a ``--dp`` / ``--sp`` run (a spawned process)."""
    return _train(args, params, attn_impl, group, group.device)


def _param_checksum(params) -> int:
    """The sum of every parameter's 32-bit patterns, in leaf order: equal
    on ranks whose parameters are bitwise equal."""
    from akka_allreduce_tpu_torch.models.train import tree_leaves
    return sum(int(p.detach().contiguous().view(torch.int32).sum(
        dtype=torch.int64)) for p in tree_leaves(params))


def _train(args: argparse.Namespace, params, attn_impl, group, device
           ) -> dict:
    from akka_allreduce_tpu_torch.models import flops
    from akka_allreduce_tpu_torch.models.train import (data_rank_count,
                                                       dense_bucket_count,
                                                       elapsed_ms,
                                                       make_train_state,
                                                       make_train_step,
                                                       mask_line,
                                                       tree_leaves, tree_map)
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
    from akka_allreduce_tpu_torch.ops.kernels import quantized as qz
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    from akka_allreduce_tpu_torch.ops.kernels import transport as tp
    from akka_allreduce_tpu_torch.parallel import ring_attention as ra

    world = 1 if group is None else group.world
    rank = 0 if group is None else group.rank
    dp_i = 0 if group is None else group.axis_index("dp")
    sp_j = 0 if group is None else group.axis_index("sp")
    log = print if rank == 0 else (lambda *a, **k: None)
    b, t, backend = _check_train_flags(args)
    local_b, local_t = b // args.dp, t // args.sp
    log_every = max(1, args.log_every)
    corpus = None
    if args.data_file:
        from akka_allreduce_tpu_torch.data import load_corpus
        corpus = load_corpus(args.data_file)
        needed = (corpus.max_token() + 1
                  if args.vocab < corpus.vocab_size else 0)
        if args.vocab < needed:
            log(f"note: raising --vocab {args.vocab} -> {needed} to "
                f"cover the corpus (largest token id {needed - 1})")
            args.vocab = needed
    cfg = train_config(args, t, attn_impl)
    generator = None
    if params is None:
        generator = torch.Generator(device=device).manual_seed(0)
    elif group is not None:
        # each rank trains its own copy (a CPU rank would otherwise share
        # the spawned tensors' memory with its peers)
        params = tree_map(lambda p: p.detach().clone().to(device), params)
    state = make_train_state(cfg, generator=generator, params=params,
                             device=device)
    plan_report = None
    if cfg.transport_schedule == "auto":
        cfg, plan_report = _collective_plan(args, cfg, state.params, group,
                                            device, log)
    sync_times: list = []
    deadline = args.deadline_ms > 0
    step = make_train_step(cfg, group, sync_times, dynamic_valid=deadline)
    trainer = None
    if deadline:
        from akka_allreduce_tpu_torch.runtime.pacer import RoundClock
        from akka_allreduce_tpu_torch.runtime.straggler import \
            DeadlineTrainer

        def paced_step(state_, tokens_, valid_):
            # the metrics reach the host behind the step's work (pinned,
            # non-blocking): once the pacer harvests the round they read
            # without waiting for the rounds queued after it
            return {k: v.to("cpu", non_blocking=True)
                    for k, v in step(state_, tokens_, valid_).items()}
        clock = RoundClock(data_rank_count(cfg, group),
                           deadline_s=args.deadline_ms / 1e3)
        trainer = DeadlineTrainer(paced_step, clock,
                                  dense_bucket_count(cfg, state.params),
                                  max_lag=args.max_lag,
                                  line=mask_line(cfg, group))
        trainer.pacer.on_harvest = lambda _r: read_round()

    start, mgr = 0, None
    if args.ckpt_dir:
        from akka_allreduce_tpu_torch.runtime.checkpoint import (
            CheckpointConfig, restore_or_init)
        start, loaded, opt_state, extra, mgr = restore_or_init(
            CheckpointConfig(args.ckpt_dir,
                             save_interval_steps=args.ckpt_every),
            state.params, _opt_state(state))
        if start:
            with torch.no_grad():
                for live, saved in zip(tree_leaves(state.params),
                                       tree_leaves(loaded)):
                    live.copy_(saved)
            state.optimizer.load_state_dict(opt_state["optimizer"])
            state.step = int(opt_state["count"])
            log(f"resumed from step {start - 1} "
                f"(data position {extra.get('data_step', '?')})")
            if state.residual is not None:
                # this rank's ef8 residual, bitwise (the JAX ``sync`` item)
                saved = mgr.restore_sync(state.residual, start - 1, rank)
                if saved is None:
                    log("note: no ef8 residual in the checkpoint; error "
                        "feedback restarts from zero")
                else:
                    state.residual.copy_(saved)

    sp_note = f" sp={args.sp}" if args.sp > 1 else ""
    dist_note = (f" dp={args.dp}{sp_note} ({backend}) "
                 f"wire={cfg.grad_transport} "
                 f"schedule={cfg.transport_schedule}" if world > 1 else "")
    log(f"device {device.type}; batch={b} seq={t} "
        f"grad_accum={args.grad_accum} attn={cfg.attn_impl}{dist_note}")

    def build_batch(i):
        # deterministic per-step data stream, drawn as the JAX command
        # draws it: a resumed run sees the tokens the dead run would have;
        # rank (i, j) takes rows [i * B/dp, (i + 1) * B/dp) and columns
        # [j * T/sp, (j + 1) * T/sp) of the global batch. The generator
        # comes back too: the straggle draws follow the global batch
        step_rng = np.random.default_rng(i)
        if corpus is not None:
            batch = corpus.batch(i, b, t)
        else:
            batch = step_rng.integers(0, args.vocab, size=(b, t),
                                      dtype=np.int32)
        return step_rng, batch[dp_i * local_b:(dp_i + 1) * local_b,
                               sp_j * local_t:(sp_j + 1) * local_t]

    counters = (lambda: (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
                         fa.FLASH_DKV_LAUNCHES),
                lambda: {"masked_reduce": mr.MASKED_REDUCE_LAUNCHES,
                         **qz.launch_counts()},
                rf.counts, tp.counts)
    before = [c() for c in counters]
    losses, step_ms, sync_ms, exchange_ms, min_counts = [], [], [], [], []
    dispatched: list = []  # host time each step's dispatch began
    # rounds dispatched and not yet read: (step, dispatch time, metrics,
    # the step's sync marks)
    unread: collections.deque = collections.deque()
    clocks = {"tic": time.perf_counter(), "read": 0.0, "window": 0}

    def read_round():
        """Read the oldest unread round's metrics (harvested by the
        pacer, or the read waits for the step's device work) and log its
        step line."""
        i, t0, metrics, marks = unread.popleft()
        loss = float(metrics["loss"])
        now = time.perf_counter()
        # a step's wall time: from its dispatch, or from the previous
        # read when rounds overlap, to its read (its harvest)
        step_ms.append((now - max(t0, clocks["read"])) * 1e3)
        clocks["read"] = now
        if marks:
            sync_ms.append(elapsed_ms(*marks[-1]))
        losses.append(loss)
        min_counts.append(int(metrics["min_bucket_count"]))
        clocks["window"] += 1
        if i == start or (i + 1) % log_every == 0:
            toks = float(metrics["tokens"])
            dt = now - clocks["tic"]
            lossy = ""
            if trainer is not None:
                rep = trainer.reports[i - start]
                fb = " FELL BACK TO EXACT" if rep.fell_back else ""
                if rep.n_dropped > rep.n_masked:
                    fb += f", {rep.n_dropped} dropped with their sp lines"
                lossy = (f" [masked {rep.n_masked}/"
                         f"{trainer.clock.num_peers} ranks{fb}, "
                         f"min_count {min_counts[-1]}]")
            log(f"step {i + 1:4d}: loss {loss:.4f} "
                f"({toks * clocks['window'] / dt:.0f} tok/s){lossy}",
                flush=True)
            clocks["tic"] = time.perf_counter()
            clocks["window"] = 0

    for i in range(start, args.steps):
        t0 = time.perf_counter()
        dispatched.append(t0)
        ex0 = ra.EXCHANGE_SECONDS
        step_rng, batch = build_batch(i)
        tokens = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        if trainer is None:
            metrics = step(state, tokens)
        else:
            r = trainer.open_round()
            # arrival simulation, the same on every rank: each data rank
            # lands on time or misses the deadline with --straggle-prob
            for peer in range(trainer.clock.num_peers):
                late = step_rng.random() < args.straggle_prob
                trainer.clock.report_offset(
                    r, peer, (2.0 if late else 0.0)
                    * trainer.clock.deadline_s)
            metrics = trainer.run_round(state, tokens)
        exchange_ms.append((ra.EXCHANGE_SECONDS - ex0) * 1e3)
        unread.append((i, t0, metrics, list(sync_times)))
        sync_times.clear()
        if mgr is not None:
            mgr.maybe_save(i, state.params, _opt_state(state),
                           {"data_step": i}, sync=state.residual,
                           group=group)
        if trainer is None:
            read_round()  # waits for the step's device work
    if trainer is not None:
        trainer.drain()
        fell = sum(1 for rep in trainer.reports if rep.fell_back)
        log(f"lossy rounds: {trainer.masked_round_count}/"
            f"{len(trainer.reports)} had masked contributions "
            f"({fell} all-masked, ran exact for liveness)", flush=True)
    if mgr is not None and args.steps > start \
            and mgr.latest_step() != args.steps - 1:
        mgr.save(args.steps - 1, state.params, _opt_state(state),
                 {"data_step": args.steps - 1}, force=True,
                 sync=state.residual, group=group)

    # wall time a step after the first: from the second step's dispatch
    # to the last read, over the steps in it (rounds that overlap under
    # the pacer have no boundaries of their own)
    step_s = None
    if len(dispatched) > 1:
        step_s = (clocks["read"] - dispatched[1]) / (len(dispatched) - 1)
    elif dispatched:
        step_s = step_ms[0] / 1e3
    cards = min(world, torch.cuda.device_count()) \
        if device.type == "cuda" else 1
    peak = flops.chip_peak_flops(device)
    peak = peak * cards if peak else None
    step_flops = flops.transformer_step_flops(cfg.model, b, t)
    after = [c() for c in counters]
    report = {
        "config": {"batch": b, "seq": t, "steps": args.steps,
                   "start_step": start, "compute_dtype": cfg.compute_dtype,
                   "attn_impl": cfg.attn_impl, "n_layers": args.n_layers,
                   "params": sum(p.numel()
                                 for p in tree_leaves(state.params)),
                   "dp": args.dp, "sp": args.sp,
                   "grad_transport": cfg.grad_transport,
                   "transport_schedule": cfg.transport_schedule,
                   "bucket_elems": cfg.bucket_elems},
        "device": {"type": device.type,
                   "name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "matmul_allow_tf32":
                       torch.backends.cuda.matmul.allow_tf32},
        "losses": losses,
        "step_ms": step_ms,
        "wall_ms_per_step": step_s * 1e3 if step_s else None,
        "tokens_per_s": b * t / step_s if step_s else None,
        "step_flops": step_flops,
        "mfu": step_flops / step_s / peak if step_s and peak else None,
        "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                             (a - c for a, c in zip(after[0], before[0])))),
        "ring_launches": {k: after[2][k] - before[2][k] for k in after[2]},
        "sync_launches": {k: after[1][k] - before[1][k] for k in after[1]},
        # the ipc rank transport's calls, stretches, copies and bytes
        "transport": {k: after[3][k] - before[3][k] for k in after[3]},
        # host ms per step in the attention's exchanges (sp > 1)
        "attn_exchange_ms": exchange_ms,
    }
    if plan_report is not None:
        report["collective_plan"] = plan_report
    if trainer is not None:
        report["deadline"] = {
            "deadline_ms": args.deadline_ms, "max_lag": args.max_lag,
            "straggle_prob": args.straggle_prob,
            "rounds": [{"step": start + rep.round,
                        "valid_peers": list(rep.valid_peers),
                        "n_masked": rep.n_masked, "fell_back": rep.fell_back,
                        "n_dropped": rep.n_dropped,
                        "min_bucket_count": count}
                       for rep, count in zip(trainer.reports, min_counts)],
            "masked_round_count": trainer.masked_round_count}
    if group is not None:
        from akka_allreduce_tpu_torch.parallel.group import \
            peer_buffer_list
        report["dist"] = {"backend": backend, "world": world}
        report["rank_info"] = {
            "rank": rank, "sync_ms": sync_ms, "attn_exchange_ms": exchange_ms,
            **{k: report[k] for k in ("launches", "ring_launches",
                                      "sync_launches", "transport")},
            "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None),
            # the ipc transport's fixed peer buffers (cudaMalloc, outside
            # the allocator's peak)
            "transport_buffer_gb": sum(
                b.nbytes for b in peer_buffer_list("transport")
            ) / 1e9,
            "param_checksum": _param_checksum(state.params)}
        if state.residual is not None:
            # the ef8 state's shape, and its largest entry in each sp
            # column shard (the hierarchical sync updates only the shard
            # this rank owns)
            res = state.residual
            cols = -(-res.shape[1] // args.sp)
            report["rank_info"].update(
                residual_shape=list(res.shape),
                # its 32-bit patterns summed, a block of rows at a time
                residual_checksum=sum(
                    int(blk.contiguous().view(torch.int32).sum(
                        dtype=torch.int64)) for blk in res.split(256)),
                residual_abs_max_by_sp_shard=[
                    float(res[:, j * cols:(j + 1) * cols].abs().max())
                    for j in range(args.sp)])
    return report


def _collective_plan(args: argparse.Namespace, cfg, params, group, device,
                     log) -> tuple:
    """``--grad-schedule auto``: measure (or reload) the collective plan
    on the run's own rank group at its own bucket matrix, every rank
    together, and freeze it into the config. Returns the config and the
    report's ``collective_plan`` entry."""
    import dataclasses

    from akka_allreduce_tpu_torch.models.train import dense_bucket_count
    from akka_allreduce_tpu_torch.ops.autotune import load_or_measure
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    shapes = [(dense_bucket_count(cfg, params), cfg.bucket_elems)]
    plan_dir = args.plan_dir or args.ckpt_dir
    if plan_dir is None:
        log("note: --grad-schedule auto without --plan-dir/--ckpt-dir: "
            "the plan is measured fresh every start (give it a directory "
            "to reload on restart)")
    t_plan = time.perf_counter()
    plan, reused = load_or_measure(
        plan_dir, group or RankGroup.single(device), shapes,
        wire=cfg.grad_transport, log=log)
    seconds = time.perf_counter() - t_plan
    winners = {k: (e.schedule if e.schedule != "windowed"
                   else f"windowed:{e.num_windows}")
               for k, e in sorted(plan.entries.items())}
    log(f"collective plan {plan.plan_hash} "
        f"{'reloaded' if reused else 'measured'} in {seconds:.1f}s: "
        f"{winners}")
    return (dataclasses.replace(cfg, collective_plan=plan),
            {"hash": plan.plan_hash, "reused": reused, "seconds": seconds,
             "plan_dir": plan_dir, "plan": plan.to_json()})


def _opt_state(state) -> dict:
    """What a checkpoint keeps of the optimizer: its state dict and the
    step count the LR schedule reads."""
    return {"optimizer": state.optimizer.state_dict(), "count": state.step}


def _cmd_train(args: argparse.Namespace) -> int:
    try:
        run_train(args)
    except (ValueError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return {"serve": _cmd_serve, "train": _cmd_train,
            "emulate": _cmd_emulate, "master": _cmd_master,
            "worker": _cmd_worker}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
