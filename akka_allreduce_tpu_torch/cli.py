"""Command line of the port: ``serve``, ``train``, ``generate``, ``eval``,
``emulate``, ``master`` and ``worker``.

Counterparts of ``akka_allreduce_tpu/cli.py serve``, ``train``,
``generate``, ``eval``, ``emulate``, ``master`` and ``worker`` for the
flags the port's slices carry. All that hold tensors run on ``cuda``
unless ``--device cpu`` is given, and raise when CUDA is asked for and
absent; the C++ host engines
(``master --native``, ``worker --native``, ``emulate --engine native``)
hold none and refuse ``--device``.

``serve`` (model shape, slot or paged engine, closed or open synthetic
load) builds a model from ``--seed`` or reads one from ``--ckpt-dir``,
runs the synthetic load through ``serve_loop`` and prints ONE JSON
summary line shaped like the JAX command's. It samples with
``--temperature/--top-k/--top-p`` (each request's key from its rid, JAX's
threefry), keeps int8 KV (``--kv-cache int8``), pads slot prefill to
``--prefill-buckets``, decodes speculatively (``--speculative
--draft-steps --draft-layers``: the target's first layers draft) and
evicts requests past ``--deadline-slack-s`` (``--policy deadline``). It
bounds each decode dispatch with ``--watchdog-timeout`` (a stalled
dispatch's requests fail into the ``--max-attempts`` retry budget and the
engine rebuilds its state), drains its in-flight requests on SIGTERM or a
``--preempt-poll`` notice into ``--drain-dir`` and restores them from there
at the next start, and writes ``--trace-file`` / ``--metrics-file``.
``--selfcheck --chaos SEED`` runs the fault-matrix smoke (a hang, a
raise, a NaN lane and a preemption into one tiny serve run)::

    python -m akka_allreduce_tpu_torch.cli serve --paged \\
        --paged-attention kernel --d-model 2048 --n-heads 16 \\
        --kv-heads 4 --n-layers 8 --d-ff 8192 --vocab 32768 --rope \\
        [--temperature 0.8 --top-k 50 --top-p 0.95] \\
        [--speculative --draft-steps 4 --draft-layers 4] [--kv-cache int8]

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
sync (``runtime/straggler.py``; on a tp / ep / pp mesh every model
rank of a data rank sends its row, and the expert sync stays exact);
``--straggle-prob`` simulates late ranks from each step's seeded
generator, and ``--max-lag`` bounds the rounds in flight::

    python -m akka_allreduce_tpu_torch.cli train --d-model 2048 \\
        --n-heads 16 --n-layers 8 --d-ff 8192 --vocab 32768 --seq 2048 \\
        --batch 8 --bf16 --lr 1e-4 --steps 6 --log-every 1 \\
        [--dp 2 --dist-backend gloo --grad-quant ef8] [--sp 2] \\
        [--grad-schedule hierarchical | auto --plan-dir DIR] \\
        [--deadline-ms 50 --straggle-prob 0.35 --max-lag 1]

``train`` takes any of the JAX chain's optimizer families (``--optimizer
adamw | lion | adafactor | sgd``), keeps EMA weights (``--ema-decay``,
saved as the checkpoint's ``ema`` item), accumulates on the overlapped
schedule (``--grad-accum K --accum-schedule overlap``), runs ``N`` steps
a dispatch as one CUDA graph replay (``--steps-per-dispatch N``; across
ranks with ``--dist-backend ipc``, on any dp / sp / tp / ep / pp mesh),
writes a Prometheus metrics snapshot
(``--metrics-file``) and a ``torch.profiler`` device trace
(``--xprof-dir``). ``generate`` decodes
from a checkpoint — greedily, sampled (``--temperature --top-k --top-p
--seed``) or speculatively with a draft checkpoint
(``--draft-ckpt-dir``) — and ``eval`` scores one over a corpus, either
from its EMA weights with ``--use-ema``::

    python -m akka_allreduce_tpu_torch.cli generate --ckpt-dir DIR \\
        --max-seq 2048 --prompt-tokens 1,2,3 --tokens 16 [--use-ema] \\
        [--temperature 0.8 --top-k 50 --seed 1] [--draft-ckpt-dir D2]
    python -m akka_allreduce_tpu_torch.cli eval --ckpt-dir DIR \\
        --data-file corpus.bin --max-seq 2048 [--use-ema]

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
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch


def _add_serve(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "serve", help="continuous-batching inference over a checkpoint "
        "(--ckpt-dir) or a random model from --seed; one JSON metrics "
        "line on stdout")
    p.add_argument("--ckpt-dir", default=None,
                   help="serve a trained checkpoint (model shape from "
                        "the --d-model/... flags); omitted = random "
                        "weights from --seed")
    p.add_argument("--use-ema", action="store_true",
                   help="with --ckpt-dir: serve the checkpoint's EMA "
                        "weights (needs a run trained with --ema-decay)")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="output head reuses the input embedding (must "
                        "match the checkpoint)")
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
    _add_moe_args(p)
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
    p.add_argument("--kv-cache", choices=("model", "int8"),
                   default="model",
                   help="KV cache format: the model dtype, or int8 with "
                        "one f32 scale per (position, head) (a quarter "
                        "of the f32 bytes at a bounded logit error; read "
                        "through the gather path)")
    p.add_argument("--prefill-buckets", default="",
                   help="comma list of prompt-length buckets (slot "
                        "engine): prompts pad up to the next one; empty "
                        "= exact-length prefill")
    # -- sampling and speculative decode
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples every pick with the "
                        "request's key (seed = its rid), so its tokens "
                        "are generate()'s with that key whatever lane, "
                        "neighbours or --decode-steps it meets")
    p.add_argument("--top-k", type=int, default=None,
                   help="with --temperature > 0: keep the k most likely "
                        "tokens")
    p.add_argument("--top-p", type=float, default=None,
                   help="with --temperature > 0: nucleus filter")
    p.add_argument("--speculative", action="store_true",
                   help="draft-verify decode: a draft model (the "
                        "target's first --draft-layers layers) proposes "
                        "--draft-steps tokens a lane and one target "
                        "extend verifies them; greedy tokens stay the "
                        "plain engine's. Composes with --paged (gather "
                        "path); not with --decode-steps > 1 or "
                        "--prefill-buckets")
    p.add_argument("--draft-steps", type=int, default=4, metavar="K",
                   help="with --speculative: proposals a lane a block")
    p.add_argument("--draft-layers", type=int, default=0, metavar="N",
                   help="with --speculative: the draft = the target's "
                        "first N layers, embed and unembed shared; 0 = "
                        "half the target's layers, at least 1")
    # -- scheduler
    p.add_argument("--policy", choices=("fifo", "deadline"),
                   default="fifo",
                   help="admission order: arrival, or earliest deadline")
    p.add_argument("--deadline-slack-s", type=float, default=0.0,
                   help="synthetic per-request deadline = arrival + "
                        "slack; a request still running past it is "
                        "evicted between dispatches (0 = none)")
    p.add_argument("--queue-depth", type=int, default=256,
                   help="admission-queue bound: submits beyond it are "
                        "rejected (backpressure at the edge)")
    p.add_argument("--th-step", type=float, default=0.0,
                   help="occupancy fraction gating a decode step: 0.0 "
                        "never waits (continuous batching), 1.0 waits "
                        "for a full batch; the gate only waits for work "
                        "that is due")
    # -- fault tolerance
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   metavar="S",
                   help="bound each decode dispatch and its readback: one "
                        "not back in S seconds trips the watchdog, the "
                        "in-flight requests fail into the retry budget "
                        "and the engine rebuilds its state. A host-side "
                        "stall is recovered; a kernel that never returns "
                        "still holds the CUDA stream. 0 (default) = "
                        "dispatch inline, no watchdog")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="total attempt budget per request: an engine-"
                        "failed request (watchdog/fault/NaN) retries "
                        "with exponential backoff until this many "
                        "attempts have failed, then dead-letters")
    p.add_argument("--retry-base-delay", type=float, default=0.05,
                   help="backoff base: the k-th failure requeues after "
                        "base * 2^(k-1) (+ jitter) seconds")
    p.add_argument("--retry-jitter", type=float, default=0.0,
                   help="uniform [0, J) seconds added to each backoff "
                        "(seeded by --seed)")
    p.add_argument("--tpot-estimate", type=float, default=0.0,
                   help="with --policy deadline: seconds-per-token "
                        "estimate that sheds, at admission, a request "
                        "whose deadline cannot fit one more token "
                        "(rejected_infeasible). 0 = disabled")
    p.add_argument("--chaos", type=int, default=None, metavar="SEED",
                   help="with --selfcheck: the fault-matrix smoke — a "
                        "seeded FaultPlan injects a hang, a dispatch "
                        "exception, a NaN-poisoned lane and a preemption "
                        "into one serve run of a tiny slot engine; "
                        "asserts survival, token parity with the fault-"
                        "free run, exact retry accounting, drain/restore "
                        "and no kernel built or loaded and no new "
                        "prefill shape after recovery")
    p.add_argument("--selfcheck", action="store_true",
                   help="with --chaos: run the fault matrix (the other "
                        "selfchecks are ROADMAP A10)")
    p.add_argument("--drain-dir", default=None, metavar="DIR",
                   help="persist a drain's in-flight request snapshots "
                        "here (runtime/checkpoint.py JSON sidecar, the "
                        "JAX command's layout) and restore any found at "
                        "startup")
    p.add_argument("--preempt-poll", default=None, metavar="URL",
                   help="poll this GCE-style metadata URL for a "
                        "preemption notice (runtime/preempt.py; 'gce' = "
                        "the real instance/preempted endpoint) and drain "
                        "on TRUE, as SIGTERM does")
    p.add_argument("--preempt-interval", type=float, default=1.0,
                   help="seconds between --preempt-poll reads")
    # -- telemetry
    p.add_argument("--trace-file", default=None,
                   help="write serve_* lifecycle events + prefill/step "
                        "spans (JSONL, runtime/tracing.py) here on exit")
    p.add_argument("--metrics-file", default=None, metavar="PATH",
                   help="write the metrics-registry snapshot (Prometheus "
                        "text: serve_* counters, latency summaries, the "
                        "engine's dispatch histograms) every "
                        "--metrics-interval plus once at exit")
    p.add_argument("--metrics-interval", type=float, default=5.0,
                   help="seconds between --metrics-file snapshots")
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
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron: heads and d_ff "
                        "sharded, one sum over tp per projection pair); "
                        "the mesh is dp x ep x sp x tp processes, tp "
                        "innermost")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (layers stack-sharded: each of the "
                        "pp ranks of a line holds n_layers / pp contiguous "
                        "layers; pp outermost in the mesh)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (needs --moe-experts): "
                        "each ep rank owns n_experts / ep experts, and "
                        "the batch rows shard over dp x ep")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches (0 = pp)")
    _add_moe_args(p)
    p.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                   default="gpipe",
                   help="pipeline schedule when --pp > 1: gpipe (the "
                        "forward ticks, then the backward ticks in "
                        "reverse, O(microbatches) activation residency) "
                        "or 1f1b (one forward and one backward unit a "
                        "tick, O(pp) residency, the stage forward "
                        "recomputed; dense layers only)")
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
    p.add_argument("--accum-schedule", choices=("deferred", "overlap"),
                   default="deferred",
                   help="with --grad-accum K > 1 across ranks: deferred = "
                        "one sync after the microbatches; overlap = sync "
                        "each microbatch's grads as produced, each folded "
                        "in one microbatch later (losses match deferred "
                        "to f32 summation order; the syncs run on the "
                        "step's stream)")
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor", "sgd", "lion"),
                   help="optimizer family (models/train.py "
                        "make_optimizer): adafactor = factored second "
                        "moments; lion = half the state of adam; sgd = "
                        "momentum via --sgd-momentum")
    p.add_argument("--sgd-momentum", type=float, default=0.9,
                   help="sgd only: momentum coefficient (0 disables; "
                        "> 0 uses nesterov)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an EMA of the post-update params "
                        "(ema = d*ema + (1-d)*params per step), saved "
                        "as the checkpoint's own 'ema' item — decode "
                        "or eval them with --use-ema. 0 disables")
    p.add_argument("--metrics-file", default=None, metavar="PATH",
                   help="write the telemetry-registry snapshot "
                        "(Prometheus text: train_steps_total / "
                        "train_tokens_total / train_loss plus the "
                        "train_step host/device/dispatch-gap "
                        "histograms) every --metrics-interval and once "
                        "at exit. Each step then blocks on its loss "
                        "readback so the wall delta after the dispatch "
                        "is the device time: a small pipelining cost "
                        "(rank 0 only)")
    p.add_argument("--metrics-interval", type=float, default=5.0,
                   help="seconds between --metrics-file snapshots")
    p.add_argument("--xprof-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome trace "
                        "JSON: host ops and, on the card, CUDA kernels) "
                        "covering K steps starting at step 2 — step 1 is "
                        "excluded so warm-up does not drown the "
                        "timeline (rank 0 only)")
    p.add_argument("--xprof-steps", type=int, default=3, metavar="K",
                   help="how many steps the --xprof-dir trace covers")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run N train steps per host dispatch: on the card "
                        "one CUDA graph holding N steps, replayed once a "
                        "chunk (models/train.py make_multi_step; across "
                        "ranks the gradient syncs, the ring exchanges and "
                        "the tp / ep / pp collectives inside it, on "
                        "--dist-backend ipc only); on the "
                        "cpu the same steps in a loop. Exact path only "
                        "(no --deadline-ms); a tail shorter than N runs "
                        "step by step; checkpoints land at chunk "
                        "boundaries")
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
                        "the mean is count-rescaled (dynamic lossy sync of "
                        "the dense gradients; an ep run's expert sync "
                        "stays exact)")
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
    p.add_argument("--guard-recompiles", action="store_true",
                   help="the JAX post-warmup compile guard (ROADMAP A11, "
                        "not ported); refused with --coordinator and "
                        "--steps-per-dispatch > 1 as in JAX")
    # -- training across processes
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: the coordinator's address (process "
                        "0 hosts a TCPStore there; run the same command in "
                        "every process with its own --process-id). Without "
                        "--deadline-ms one process group spans the "
                        "processes' ranks (--dp etc. size the whole mesh); "
                        "with --deadline-ms each process runs its local "
                        "dp x sp mesh exact and the processes sync through "
                        "the store, deadline-gated (the hybrid)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--retain-rounds", type=int, default=64,
                   help="hybrid (--coordinator --deadline-ms) only: how "
                        "many rounds of masks/payloads stay in the store "
                        "for straggler catch-up replay; beyond it a "
                        "straggler rejoins via checkpoint snapshot (needs "
                        "a shared --ckpt-dir)")
    p.add_argument("--th-allreduce", type=float, default=1.0,
                   help="hybrid only: completion fraction that closes a "
                        "round early (the reference master's threshold "
                        "advance); 1.0 = wait for every non-downed "
                        "process until the deadline")
    p.add_argument("--down-after", type=int, default=4,
                   help="hybrid only: auto-down a process masked this "
                        "many consecutive rounds (it re-ups by reporting "
                        "at the frontier); 0 = never down")
    p.add_argument("--dcn-bucket-elems", type=int, default=0,
                   help="hybrid only: chunk the cross-process gradient "
                        "wire into buckets of N elements (per-bucket masks "
                        "and honest counts for a publish cut midway); 0 = "
                        "one whole-vector bucket")
    p.add_argument("--master-timeout-s", type=float, default=10.0,
                   help="hybrid only: workers fail once the master's "
                        "heartbeat has been silent this long; 0 disables "
                        "the watch")
    p.add_argument("--check-every", type=int, default=None,
                   help="hybrid only: compare the processes' parameter "
                        "CRCs every N rounds (default --retain-rounds; 0 "
                        "disables)")
    p.add_argument("--trace-file", default=None,
                   help="hybrid only: write the round trace (JSONL: "
                        "round_complete / mask_published / catch_up / "
                        "snapshot events) on exit")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without CUDA raises")


# -- generate / eval: consumers of a checkpoint ---------------------------

def _add_model_args(p: argparse.ArgumentParser) -> None:
    """Model-shape flags shared by every checkpoint-consuming command
    (generate/eval must describe the trained model exactly)."""
    p.add_argument("--use-ema", action="store_true",
                   help="restore the checkpoint's EMA (Polyak-averaged) "
                        "weights instead of the raw ones (needs a run "
                        "trained with --ema-decay)")
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
    p.add_argument("--ffn", choices=("gelu", "swiglu"), default="gelu",
                   help="dense FF flavor (swiglu = Llama-style gated FF)")
    p.add_argument("--attn-window", type=int, default=0,
                   help="sliding-window causal attention: each position "
                        "sees itself + N-1 predecessors (0 = full causal)")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="output head reuses the input embedding "
                        "(GPT-2-style weight tying)")
    _add_moe_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without CUDA raises")


def _add_moe_args(p: argparse.ArgumentParser) -> None:
    """The MoE model flags of the JAX commands (``train`` and every
    checkpoint consumer)."""
    p.add_argument("--moe-experts", type=int, default=0,
                   help="experts per MoE layer (0 = dense model)")
    p.add_argument("--moe-every", type=int, default=1,
                   help="every Nth layer is MoE")
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--router-k", type=int, default=2)


def moe_config(args: argparse.Namespace):
    """The ``--moe-experts`` flags -> a ``parallel/ep.py MoEConfig`` (its
    d_ff is ``--d-ff``), or None for a dense model."""
    if not args.moe_experts:
        return None
    from akka_allreduce_tpu_torch.parallel.ep import MoEConfig
    return MoEConfig(n_experts=args.moe_experts, d_ff=args.d_ff,
                     capacity_factor=args.capacity_factor,
                     router_k=args.router_k)


def _build_model_config(args: argparse.Namespace, max_seq: int):
    """args (as declared by _add_model_args) -> TransformerConfig."""
    from akka_allreduce_tpu_torch.models.transformer import \
        TransformerConfig
    return TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_seq=max_seq,
        moe=moe_config(args), moe_every=args.moe_every,
        n_kv_heads=args.kv_heads or None, rope=args.rope, ffn=args.ffn,
        attn_window=args.attn_window or None,
        tie_embeddings=args.tie_embeddings)


def _restore_params(args: argparse.Namespace, mcfg, device
                    ) -> "tuple | int":
    """Build a params template and restore ``args.ckpt_dir``'s weights
    into it — params ONLY (``CheckpointManager.restore_params``), so
    decode/eval work on checkpoints from any ``--optimizer`` family or
    ``--ema-decay`` setting. With ``--use-ema`` the checkpoint's ``ema``
    item is restored instead; a checkpoint without one exits 2 (no fall
    back to the raw weights). Returns (step0, params) or an exit code
    int (message printed)."""
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.runtime.checkpoint import (
        CheckpointConfig, CheckpointManager)

    params = init_transformer(torch.Generator(device).manual_seed(0), mcfg,
                              device)
    item = "ema" if getattr(args, "use_ema", False) else "params"
    try:
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir))
        step0, params, _extra = mgr.restore_params(params, item=item)
        step0 += 1  # restore_or_init convention: resume step index
    except FileNotFoundError:
        print(f"error: no checkpoint found in {args.ckpt_dir}",
              file=sys.stderr)
        return 2
    except Exception as e:
        hint = ("trained without --ema-decay?" if item == "ema" else
                "wrong --d-model/--vocab/--max-seq/...?")
        print(f"error: cannot restore item {item!r} from "
              f"{args.ckpt_dir} ({hint}): {e}", file=sys.stderr)
        return 2
    print(f"restored step {step0 - 1} ({item}) from {args.ckpt_dir}",
          file=sys.stderr)
    return step0, params


def _add_generate(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "generate", help="decode from a trained checkpoint (KV-cache "
        "incremental decoding, models/generate.py)")
    p.add_argument("--ckpt-dir", required=True)
    _add_model_args(p)
    p.add_argument("--max-seq", type=int, required=True,
                   help="the trained model's max_seq (= train's --seq): "
                        "the positional table's shape, which the "
                        "checkpoint restore must match; prompt + --tokens "
                        "must fit inside it")
    p.add_argument("--prompt", default=None,
                   help="text prompt, consumed byte-level (vocab 256 "
                        "models)")
    p.add_argument("--prompt-tokens", default=None,
                   help="comma-separated token ids (any vocab)")
    p.add_argument("--tokens", type=int, default=64,
                   help="tokens to generate")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples with the key of --seed "
                        "(models/prng.py, JAX's threefry)")
    p.add_argument("--top-k", type=int, default=None,
                   help="sample only from the k highest-probability "
                        "tokens (needs --temperature > 0)")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: smallest token set with "
                        "cumulative probability >= p (needs "
                        "--temperature > 0; composes with --top-k)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--raw", action="store_true",
                   help="print token ids instead of decoding bytes")
    p.add_argument("--draft-ckpt-dir", default=None,
                   help="speculative decoding: a draft model (geometry "
                        "from the --draft-* flags, unset ones the "
                        "target's; the target's vocab) proposes "
                        "--speculate-k tokens a round and the target "
                        "verifies them in one pass (models/speculate.py)."
                        " Greedy output is the target's; with "
                        "--temperature > 0 modified rejection keeps the "
                        "target's sampling distribution")
    p.add_argument("--draft-d-model", type=int, default=0)
    p.add_argument("--draft-n-layers", type=int, default=0)
    p.add_argument("--draft-n-heads", type=int, default=0)
    p.add_argument("--draft-d-ff", type=int, default=0)
    p.add_argument("--draft-kv-heads", type=int, default=0)
    p.add_argument("--speculate-k", type=int, default=4,
                   help="draft proposals verified per target pass")


def _generate_prompt(args: argparse.Namespace) -> "list | int":
    """The prompt's ids after the JAX command's checks, or an exit
    code (message printed)."""
    if (args.prompt is None) == (args.prompt_tokens is None):
        print("error: exactly one of --prompt / --prompt-tokens",
              file=sys.stderr)
        return 2
    if args.prompt is not None:
        ids = list(args.prompt.encode())
        if args.vocab < 256:
            print(f"error: --prompt is byte-level but vocab={args.vocab}",
                  file=sys.stderr)
            return 2
    else:
        try:
            ids = [int(x) for x in args.prompt_tokens.split(",") if x]
        except ValueError:
            print(f"error: bad --prompt-tokens {args.prompt_tokens!r}",
                  file=sys.stderr)
            return 2
        if any(i < 0 or i >= args.vocab for i in ids):
            print("error: prompt token out of vocab range", file=sys.stderr)
            return 2
    if not ids:
        print("error: empty prompt", file=sys.stderr)
        return 2
    return ids


def _generate_refusal(args: argparse.Namespace, n_prompt: int
                      ) -> "str | None":
    """The JAX command's checks of the decode flags; the message, or
    None."""
    max_seq = args.max_seq
    if n_prompt + args.tokens > max_seq:
        return (f"prompt ({n_prompt}) + --tokens ({args.tokens}) exceeds "
                f"--max-seq {max_seq}")
    if args.temperature < 0.0:
        return f"--temperature must be >= 0, got {args.temperature}"
    if (args.top_k is not None or args.top_p is not None) \
            and args.temperature == 0.0:
        return "--top-k/--top-p need --temperature > 0 (greedy ignores them)"
    if args.top_k is not None and args.top_k < 1:
        return f"--top-k must be >= 1, got {args.top_k}"
    if args.top_p is not None and not 0.0 < args.top_p <= 1.0:
        return f"--top-p must be in (0, 1], got {args.top_p}"
    if args.draft_ckpt_dir and args.speculate_k < 1:
        return f"--speculate-k must be >= 1, got {args.speculate_k}"
    if args.draft_ckpt_dir \
            and n_prompt + args.tokens + args.speculate_k > max_seq:
        return (f"speculation needs --speculate-k headroom: prompt "
                f"({n_prompt}) + --tokens ({args.tokens}) + k "
                f"({args.speculate_k}) exceeds --max-seq {max_seq}")
    return None


def _speculate(args: argparse.Namespace, mcfg, params, prompt, device
               ) -> "torch.Tensor | int":
    """``generate --draft-ckpt-dir``: restore the draft and run the
    greedy or sampled speculative decode; the tokens (1, steps), or an
    exit code (message printed)."""
    import dataclasses

    from akka_allreduce_tpu_torch.models import prng
    from akka_allreduce_tpu_torch.models.speculate import (
        speculative_generate, speculative_sample)

    dcfg = dataclasses.replace(
        mcfg,
        d_model=args.draft_d_model or mcfg.d_model,
        n_layers=args.draft_n_layers or mcfg.n_layers,
        n_heads=args.draft_n_heads or mcfg.n_heads,
        d_ff=args.draft_d_ff or mcfg.d_ff,
        n_kv_heads=args.draft_kv_heads or mcfg.n_kv_heads)
    d_restored = _restore_params(
        argparse.Namespace(ckpt_dir=args.draft_ckpt_dir, use_ema=False),
        dcfg, device)
    if isinstance(d_restored, int):
        return d_restored
    _d_step, draft_params = d_restored
    if args.temperature == 0.0:
        out, stats = speculative_generate(
            params, draft_params, prompt, mcfg, dcfg, steps=args.tokens,
            k=args.speculate_k)
    else:
        out, stats = speculative_sample(
            params, draft_params, prompt, mcfg, dcfg, steps=args.tokens,
            key=prng.key(args.seed, device), k=args.speculate_k,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p)
    print(f"speculative: {int(stats['rounds'])} target passes for "
          f"{args.tokens} tokens (plain decode would take "
          f"{args.tokens}); acceptance "
          f"{int(stats['accepted'])}/{int(stats['drafted'])} "
          f"drafted", file=sys.stderr)
    return out


def _cmd_generate(args: argparse.Namespace) -> int:
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models.generate import generate

    ids = _generate_prompt(args)
    if isinstance(ids, int):
        return ids
    refusal = _generate_refusal(args, len(ids))
    if refusal is not None:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    mcfg = _build_model_config(args, args.max_seq)
    restored = _restore_params(args, mcfg, device)
    if isinstance(restored, int):
        return restored
    _step0, params = restored
    prompt = torch.tensor(ids, dtype=torch.int32, device=device)[None]
    if args.draft_ckpt_dir:
        out = _speculate(args, mcfg, params, prompt, device)
        if isinstance(out, int):
            return out
    else:
        from akka_allreduce_tpu_torch.models import prng
        out = generate(params, prompt, mcfg, steps=args.tokens,
                       key=prng.key(args.seed, device),
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p)
    toks = out[0].tolist()
    if args.raw or args.prompt_tokens is not None:
        print(",".join(map(str, toks)))
    else:
        print(bytes(t for t in toks if t < 256
                    ).decode("utf-8", errors="replace"))
    return 0


def _add_eval(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "eval", help="held-out perplexity of a trained checkpoint over a "
        "corpus (sequential non-overlapping windows, each token once)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--data-file", required=True,
                   help="byte-level file or .bin uint16 token corpus")
    _add_model_args(p)
    p.add_argument("--max-seq", type=int, required=True,
                   help="the trained model's max_seq (eval windows use it "
                        "as the window length)")
    p.add_argument("--batch", type=int, default=8,
                   help="windows per device batch")
    p.add_argument("--max-windows", type=int, default=0,
                   help="stop after this many windows (0 = whole corpus)")


def _cmd_eval(args: argparse.Namespace) -> int:
    from akka_allreduce_tpu_torch.data import eval_batches, load_corpus
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models.train import (TrainConfig,
                                                       select_local_attention)
    from akka_allreduce_tpu_torch.models.transformer import \
        next_token_loss_and_aux

    try:
        corpus = load_corpus(args.data_file)
    except FileNotFoundError:
        print(f"error: no such corpus {args.data_file}", file=sys.stderr)
        return 2
    mcfg = _build_model_config(args, args.max_seq)
    if corpus.max_token() >= mcfg.vocab_size:
        # out-of-range ids would index garbage embeddings and report NaN
        # perplexity with no explanation
        print(f"error: corpus holds token id {corpus.max_token()} but "
              f"the model's vocab is {mcfg.vocab_size} — wrong "
              f"--vocab for this checkpoint, or wrong corpus",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    restored = _restore_params(args, mcfg, device)
    if isinstance(restored, int):
        return restored
    _step0, params = restored
    attn = select_local_attention(TrainConfig(model=mcfg))

    @torch.no_grad()
    def batch_loss(tokens):
        # pure cross-entropy: the loss sum folds the aux term in, which
        # eval must not count
        loss_sum, w_sum, aux = next_token_loss_and_aux(
            params, tokens, mcfg, attn_fn=attn)
        return loss_sum - aux["aux_loss"] * w_sum, w_sum

    ce_total, tok_total, windows = 0.0, 0.0, 0
    for arr in eval_batches(corpus, args.batch, args.max_seq):
        if args.max_windows and windows >= args.max_windows:
            break
        if args.max_windows:
            arr = arr[:args.max_windows - windows]
        loss_sum, w_sum = batch_loss(torch.from_numpy(arr).to(device))
        ce_total += float(loss_sum)
        tok_total += float(w_sum)
        windows += arr.shape[0]
        print(f"eval: {windows} windows, {int(tok_total)} tokens",
              file=sys.stderr)
    if tok_total == 0:
        print("error: corpus smaller than one window", file=sys.stderr)
        return 2
    nats = ce_total / tok_total
    out = {"windows": windows, "tokens": int(tok_total),
           "ce_nats_per_token": round(nats, 6),
           "perplexity": round(math.exp(nats), 4)}
    if corpus.vocab_size == 256:
        out["bits_per_byte"] = round(nats / math.log(2), 6)
    print(json.dumps(out))
    return 0


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
    _add_generate(sub)
    _add_eval(sub)
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
    _check_fault_flags(args)
    _check_sampling(args)
    if args.speculative:
        _check_speculative(args)
    buckets = prefill_buckets(args)
    if buckets and args.paged:
        raise ValueError("--prefill-buckets is a slot-engine knob; paged "
                         "prefill is page-granular already — drop one")
    if buckets and max(buckets) < p_hi:
        raise ValueError(f"largest prefill bucket {max(buckets)} smaller "
                         f"than --prompt-len max {p_hi}")
    return p_lo, p_hi


def _check_fault_flags(args: argparse.Namespace) -> None:
    """The JAX command's checks of the fault-tolerance flags, and the
    selfcheck the port has (``--selfcheck --chaos``)."""
    if args.watchdog_timeout < 0:
        raise ValueError(f"--watchdog-timeout must be >= 0 (0 disables), "
                         f"got {args.watchdog_timeout}")
    if args.chaos is not None and not args.selfcheck:
        raise ValueError("--chaos requires --selfcheck (the fault-matrix "
                         "smoke)")
    if args.chaos is not None and args.paged:
        raise ValueError("--chaos runs the slot-engine fault matrix; paged "
                         "fault recovery is covered by "
                         "tests/test_torch_serving_faults.py and "
                         "chip_smoke.py phase 24")
    if args.selfcheck and args.chaos is None:
        raise ValueError("--selfcheck without --chaos is not ported "
                         "(ROADMAP A10: the serve selfcheck); --selfcheck "
                         "--chaos SEED runs the fault matrix")
    if args.preempt_poll and args.preempt_interval <= 0:
        raise ValueError(f"--preempt-interval must be > 0, got "
                         f"{args.preempt_interval}")


def _check_sampling(args: argparse.Namespace) -> None:
    if args.temperature < 0.0:
        raise ValueError(f"--temperature must be >= 0 (0 = greedy), got "
                         f"{args.temperature}")
    if args.top_k is not None and args.top_k < 1:
        raise ValueError(f"--top-k must be >= 1, got {args.top_k}")
    if args.top_p is not None and not 0.0 < args.top_p <= 1.0:
        raise ValueError(f"--top-p must be in (0, 1], got {args.top_p}")
    if (args.top_k is not None or args.top_p is not None) \
            and args.temperature == 0.0:
        raise ValueError("--top-k/--top-p require --temperature > 0 "
                         "(temperature 0 is greedy; the filters would be "
                         "silently ignored)")


def _check_speculative(args: argparse.Namespace) -> None:
    if args.draft_steps < 1:
        raise ValueError(f"--draft-steps must be >= 1, got "
                         f"{args.draft_steps}")
    if args.decode_steps > 1:
        raise ValueError("--speculative and --decode-steps are both block "
                         "modes (a speculative block already verifies "
                         "draft-steps+1 tokens per dispatch); pick one")
    if args.prefill_buckets.strip():
        raise ValueError("--speculative prefill is exact-length (the "
                         "parity mode); drop --prefill-buckets")
    if args.paged and args.paged_attention == "kernel":
        raise ValueError("the speculative verify is a block extend; run "
                         "--speculative --paged on the gather path")
    if not 0 <= args.draft_layers <= args.n_layers:
        raise ValueError(f"--draft-layers must be in [0, --n-layers="
                         f"{args.n_layers}], got {args.draft_layers}")


def prefill_buckets(args: argparse.Namespace) -> tuple:
    try:
        return tuple(int(b) for b in args.prefill_buckets.split(",")
                     if b.strip())
    except ValueError:
        raise ValueError(f"bad --prefill-buckets "
                         f"{args.prefill_buckets!r}") from None


def make_draft_model(params: dict, mcfg, draft_layers: int):
    """The serve command's draft model: the target's first N layers with
    the embedding, positional, output-norm and unembedding weights
    shared (no extra parameters, the target's vocabulary). 0 = half the
    target's layers, at least 1."""
    import dataclasses
    n = draft_layers or max(1, mcfg.n_layers // 2)
    return ({**params, "layers": params["layers"][:n]},
            dataclasses.replace(mcfg, n_layers=n))


def make_requests(args: argparse.Namespace, p_lo: int, p_hi: int,
                  rid_base: int = 0) -> list:
    """The synthetic load, drawn exactly as the JAX command draws it
    (same generator, same order), so one seed gives one load in both.
    Rids start at ``rid_base`` (past any restored request's)."""
    from akka_allreduce_tpu_torch.serving import Request
    rng = np.random.default_rng(args.seed)
    arrivals = np.zeros(args.requests)
    if args.load == "open":
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             size=args.requests))
    slack = getattr(args, "deadline_slack_s", 0.0)
    t0 = time.monotonic()
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(p_lo, p_hi + 1))
        arrival = t0 + float(arrivals[i])
        reqs.append(Request(
            rid=rid_base + i,
            prompt=tuple(int(x) for x in rng.integers(0, args.vocab,
                                                       size=plen)),
            max_new_tokens=args.max_new_tokens,
            eos_token=args.eos_token, arrival=arrival,
            deadline=arrival + slack if slack > 0 else None,
            submitted_at=arrival))
    return reqs


def build_engine(args: argparse.Namespace, params: dict, mcfg,
                 tracer=None):
    """The engine ``serve`` runs: slot or paged, plain or speculative,
    with the flags' KV format, buckets, sampling and watchdog."""
    from akka_allreduce_tpu_torch.serving import (
        EngineConfig, PagedEngineConfig, PagedServingEngine,
        PagedSpeculativeEngine, ServingEngine, SpeculativeEngine)
    common = dict(
        num_slots=args.slots, decode_steps=args.decode_steps,
        kv_dtype="int8" if args.kv_cache == "int8" else None,
        watchdog_timeout_s=args.watchdog_timeout or None,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        draft_steps=args.draft_steps if args.speculative else 0)
    draft = (make_draft_model(params, mcfg, args.draft_layers)
             if args.speculative else None)
    if args.paged:
        ecfg = PagedEngineConfig(
            **common, page_size=args.page_size, num_pages=args.num_pages,
            attention_impl=args.paged_attention)
        if draft is not None:
            return PagedSpeculativeEngine(params, mcfg, *draft, ecfg,
                                          tracer=tracer)
        return PagedServingEngine(params, mcfg, ecfg, tracer=tracer)
    ecfg = EngineConfig(**common, prefill_buckets=prefill_buckets(args))
    if draft is not None:
        return SpeculativeEngine(params, mcfg, *draft, ecfg, tracer=tracer)
    return ServingEngine(params, mcfg, ecfg, tracer=tracer)


def serve_model(args: argparse.Namespace, device, dtype=None):
    """``serve``'s model: (config, parameters), read from ``--ckpt-dir``
    or drawn from ``--seed``; ``dtype`` (a torch dtype) overrides f32.
    Raises ValueError when the checkpoint cannot be restored."""
    from akka_allreduce_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer)
    mcfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_seq=args.max_seq,
        moe=moe_config(args), moe_every=args.moe_every,
        n_kv_heads=args.kv_heads or None, rope=args.rope, ffn=args.ffn,
        attn_window=args.attn_window or None,
        tie_embeddings=args.tie_embeddings,
        **({"dtype": dtype} if dtype is not None else {}))
    if args.ckpt_dir:
        restored = _restore_params(args, mcfg, device)
        if isinstance(restored, int):
            raise ValueError(f"cannot serve --ckpt-dir {args.ckpt_dir}")
        return mcfg, restored[1]
    generator = torch.Generator(device=device).manual_seed(args.seed)
    return mcfg, init_transformer(generator, mcfg)


def _load_resumed(args: argparse.Namespace) -> list:
    """``--drain-dir``'s drained requests (empty without the flag or a
    file), each replay checked against the prefill buckets. Raises
    ValueError with the operator's message."""
    if not args.drain_dir:
        return []
    from akka_allreduce_tpu_torch.serving import load_drained
    try:
        resumed = load_drained(args.drain_dir)
    except (ValueError, KeyError, TypeError, OSError) as exc:
        raise ValueError(
            f"--drain-dir {args.drain_dir} holds an unreadable drained-"
            f"requests state ({exc}); move it aside to start fresh, or "
            f"restore it from the preempted run's copy") from None
    buckets = prefill_buckets(args)
    too_long = [(rr.req.rid, len(rr.req.prompt) + len(rr.generated))
                for rr in resumed
                if buckets and len(rr.req.prompt) + len(rr.generated)
                > max(buckets)]
    if too_long:
        rid, n = max(too_long, key=lambda t: t[1])
        raise ValueError(
            f"--drain-dir holds {len(too_long)} drained request(s) whose "
            f"replay (prompt + generated) exceeds the largest prefill "
            f"bucket {max(buckets)} (worst: rid {rid} needs {n}); add a "
            f"bucket >= {n} to --prefill-buckets or drop the flag for "
            f"exact-length prefill")
    return resumed


@contextlib.contextmanager
def _drain_on_sigterm(request_drain):
    """SIGTERM drains instead of killing the in-flight requests while the
    block runs; the previous handler comes back after it. (Only the main
    thread may set a handler; elsewhere the block runs without one.)"""
    import signal
    import threading
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.signal(signal.SIGTERM, lambda *_: request_drain())
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def run_serve(args: argparse.Namespace):
    """Build the model and engine, restore ``--drain-dir``'s drained
    requests, serve the synthetic load, persist a drain, and return
    ``(report, results, engine)``: the summary dict the command prints,
    ``{rid: (tokens, reason)}``, and the engine (its parameters and
    counters). A SIGTERM or a ``--preempt-poll`` notice drains the
    engine. Raises ValueError on a bad flag combination, checkpoint or
    drain file and RuntimeError when CUDA is asked for and absent."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.runtime.tracing import tracer_to_file
    from akka_allreduce_tpu_torch.serving import (
        QueueFull, RequestScheduler, RetryPolicy, SchedulerConfig,
        ServingMetrics, clear_drained, persist_drained, serve_loop)

    device = resolve_device(args.device)
    p_lo, p_hi = _validate(args)
    # drained requests load before the synthetic rids are drawn: a
    # restored request keeps its rid, so the fresh load starts past it
    resumed = _load_resumed(args)
    rid_base = 1 + max((rr.req.rid for rr in resumed), default=-1)
    mcfg, params = serve_model(args, device)
    with contextlib.ExitStack() as stack:
        tracer = stack.enter_context(tracer_to_file(args.trace_file))
        metrics = ServingMetrics(tracer=tracer)
        if args.metrics_file:
            stack.enter_context(metrics.registry.start_snapshotter(
                args.metrics_file, args.metrics_interval))
        engine = build_engine(args, params, mcfg, tracer=tracer)
        stack.callback(engine.close)
        if args.paged:
            metrics.attach_paging(engine.paging_summary)
        sched = RequestScheduler(
            SchedulerConfig(max_queue_depth=args.queue_depth,
                            policy=args.policy, th_step=args.th_step,
                            retry=RetryPolicy(
                                max_attempts=args.max_attempts,
                                base_delay=args.retry_base_delay,
                                jitter=args.retry_jitter),
                            tpot_estimate=args.tpot_estimate,
                            seed=args.seed),
            num_slots=args.slots, on_reject=metrics.on_reject)
        for rr in resumed:
            metrics.on_submit(rr.req.rid)
        if resumed:
            print(f"restoring {len(resumed)} drained request(s) from "
                  f"{args.drain_dir}", file=sys.stderr)
        for req in make_requests(args, p_lo, p_hi, rid_base):
            metrics.on_submit(req.rid)
            try:
                sched.submit(req)
            except QueueFull:
                pass  # counted through on_reject
        watcher = None
        if args.preempt_poll:
            from akka_allreduce_tpu_torch.runtime.preempt import (
                GCE_PREEMPTED_URL, PreemptionWatcher)
            url = (GCE_PREEMPTED_URL if args.preempt_poll == "gce"
                   else args.preempt_poll)
            watcher = stack.enter_context(PreemptionWatcher(
                engine.request_drain, url=url,
                interval_s=args.preempt_interval))
        with _drain_on_sigterm(engine.request_drain):
            results = serve_loop(engine, sched, metrics=metrics,
                                 resume=resumed)
        drained = engine.drained
        drain_path = None
        if args.drain_dir:
            if drained:
                drain_path = persist_drained(args.drain_dir, drained,
                                             metrics=metrics)
                print(f"persisted {len(drained)} drained request(s) -> "
                      f"{drain_path} (restore with --drain-dir on the "
                      f"next run)", file=sys.stderr)
            else:
                # the restored requests finished: a stale drain file
                # must not be replayed into a third run
                clear_drained(args.drain_dir)
    report = {
        "config": {"slots": args.slots, "requests": args.requests,
                   "load": args.load, "policy": args.policy,
                   "th_step": args.th_step, "kv_cache": args.kv_cache,
                   "prefill_buckets": list(prefill_buckets(args)),
                   "decode_steps": args.decode_steps,
                   "max_new_tokens": args.max_new_tokens,
                   "paged": args.paged, "temperature": args.temperature,
                   **({"top_k": args.top_k, "top_p": args.top_p}
                      if args.temperature > 0 else {}),
                   **({"speculative": True,
                       "draft_steps": args.draft_steps,
                       "draft_layers": engine.draft_cfg.n_layers}
                      if args.speculative else {}),
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
        **({"preempt_notice": watcher.fired,
            "preempt_polls": watcher.polls} if watcher else {}),
        "completed_reasons": {
            reason: sum(1 for _toks, r in results.values() if r == reason)
            for reason in {r for _, r in results.values()}},
        "drained": len(drained),
        "dead_letter": [
            {"rid": req.rid, "attempts": req.attempts, "reason": rsn}
            for req, rsn in sched.dead_letter],
        "dead_letter_dropped": sched.dead_letter_dropped,
        "resumed": len(resumed),
        "drain_persisted": len(drained) if drain_path else 0,
        **({"speculative": engine.speculative_summary()}
           if args.speculative else {}),
        "watchdog_trips": engine.watchdog_trips,
        "evictions": engine.evictions,
        "decode_dispatches": engine.decode_dispatches,
        "prefill_dispatches": engine.prefill_dispatches,
        "prefill_programs": len(engine.prefill_shapes),
        "kv_cache_mb": round(engine.kv_cache_bytes() / 1e6, 2),
        # host vs device wall time of each decode dispatch, and the
        # host's bubble between dispatches (telemetry/device.py)
        "device_time": engine.device_time_summary(),
        **metrics.summary(),
    }
    if args.trace_file:
        print(f"trace -> {args.trace_file}", file=sys.stderr)
    return report, results, engine


# the chaos selfcheck's model and load: the JAX harness's tiny shape
CHAOS_MODEL = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2,
                   d_ff=64, max_seq=48)
CHAOS_SLOTS = 3
CHAOS_EOS = 5
# the armed watchdog of the chaos run (the JAX harness arms 0.15 s): the
# injected hang holds its dispatch until the run ends, far past it, so a
# busy host never races the hang, and a healthy dispatch of the tiny
# model stays two orders of magnitude under it
CHAOS_WATCHDOG_S = 1.0
CHAOS_HANG_CAP_S = 120.0


def chaos_requests() -> list:
    """The harness's 10 requests (fresh objects each run: requests are
    mutated in flight)."""
    from akka_allreduce_tpu_torch.serving import Request
    r = np.random.default_rng(11)
    return [Request(
        rid=rid,
        prompt=tuple(int(x) for x in r.integers(
            0, CHAOS_MODEL["vocab_size"], size=int(r.integers(2, 6)))),
        max_new_tokens=8,
        eos_token=CHAOS_EOS if rid % 2 else None,
        submitted_at=0.0) for rid in range(10)]


def held_hang_plan(points, seed: int = 0):
    """A :class:`~akka_allreduce_tpu_torch.runtime.faults.FaultPlan` of
    ``points`` whose hangs hold their dispatch until ``plan.release``
    is set (at most ``CHAOS_HANG_CAP_S``), not for their duration: a
    hang then outlasts any watchdog however busy the host, and the
    abandoned dispatch wakes when the caller chooses."""
    import threading

    from akka_allreduce_tpu_torch.runtime.faults import FaultPlan
    release = threading.Event()
    plan = FaultPlan(points, seed=seed,
                     sleep=lambda _s: release.wait(CHAOS_HANG_CAP_S))
    plan.release = release
    return plan


def serve_until_done(make_engine, sched, metrics=None, plan=None,
                     max_dispatches: "int | None" = None):
    """``serve_loop`` over ``make_engine()`` with ``plan`` armed; each
    drain's snapshots are restored into a fresh engine (the drained one's
    device state goes with its "preempted" process) until the scheduler
    has nothing unfinished. Returns (results, engines in order, restored
    rids)."""
    from akka_allreduce_tpu_torch.serving import serve_loop
    engines = [make_engine()]
    restored = set()
    with (plan.armed() if plan is not None else contextlib.nullcontext()):
        results = serve_loop(engines[-1], sched, metrics=metrics,
                             max_dispatches=max_dispatches)
        while engines[-1].drained or sched.unfinished:
            fresh = make_engine()
            for rr in engines[-1].drained:
                restored.add(rr.req.rid)
                sched.bind(rr.req, fresh.restore(rr))
            engines.append(fresh)
            results.update(serve_loop(fresh, sched, metrics=metrics,
                                      max_dispatches=max_dispatches))
    return results, engines, restored


def run_chaos_selfcheck(args: argparse.Namespace) -> dict:
    """``serve --selfcheck --chaos SEED``: the JAX command's fault-matrix
    smoke. One seeded ``FaultPlan.chaos`` script injects a dispatch hang,
    a dispatch exception, a NaN-poisoned lane and a preemption into one
    serve run of a tiny slot engine; the drained requests are restored
    into a fresh engine. Checked: every fault fired; every request ends
    once with the fault-free run's tokens (bitwise, or for a restored
    request under ``parity.greedy_agree``: a restore replays prompt +
    generated through a T-row prefill where the uninterrupted run took
    1-row decode steps); one watchdog trip; retries + dead letters ==
    failed attempts; injected == survived; and a fault-free churn run
    after the chaos run builds or loads no kernel library and meets no
    prefill shape the warm-up did not (the port's counterpart of the JAX
    harness's zero recompiles) with the warm-up's tokens bitwise."""
    import dataclasses

    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_apply)
    from akka_allreduce_tpu_torch.ops.kernels import build
    from akka_allreduce_tpu_torch.parity import greedy_agree
    from akka_allreduce_tpu_torch.runtime.faults import FaultPlan
    from akka_allreduce_tpu_torch.serving import (
        EngineConfig, RequestScheduler, RetryPolicy, SchedulerConfig,
        ServingEngine, ServingMetrics)

    _check_fault_flags(args)
    if args.decode_steps < 1:
        raise ValueError(f"--decode-steps must be >= 1, got "
                         f"{args.decode_steps}")
    device = resolve_device(args.device)
    cfg = TransformerConfig(**CHAOS_MODEL)
    params = init_transformer(
        torch.Generator(device=device).manual_seed(0), cfg)
    ecfg_warm = EngineConfig(num_slots=CHAOS_SLOTS,
                             decode_steps=args.decode_steps)
    ecfg = dataclasses.replace(ecfg_warm,
                               watchdog_timeout_s=CHAOS_WATCHDOG_S)
    scfg = SchedulerConfig(policy=args.policy,
                           retry=RetryPolicy(max_attempts=4,
                                             base_delay=0.0))

    def run(metrics=None, plan=None, engine_cfg=ecfg):
        sched = RequestScheduler(scfg, num_slots=CHAOS_SLOTS)
        for r in chaos_requests():
            sched.submit(r)
        return serve_until_done(
            lambda: ServingEngine(params, cfg, engine_cfg), sched,
            metrics=metrics, plan=plan, max_dispatches=1000)

    # the fault-free run: the tokens to hold against, and the warm-up
    # (no watchdog: warm before you arm)
    baseline, warm, _ = run(engine_cfg=ecfg_warm)
    warm_shapes = set().union(*(e.prefill_shapes for e in warm))
    libs_warm = set(build._LIBS)
    plan = FaultPlan.chaos(args.chaos, slots=CHAOS_SLOTS)
    plan = held_hang_plan(plan.points, seed=args.chaos)
    metrics = ServingMetrics()
    for r in chaos_requests():
        metrics.on_submit(r.rid)
    try:
        chaos, engines, restored = run(metrics=metrics, plan=plan)
    finally:
        plan.release.set()
    for e in engines:
        e.close()
    metrics.on_fault_injected(len(plan.fired))

    def ref_logits(rid: int, toks: list):
        req = chaos_requests()[rid]
        seq = torch.tensor(list(req.prompt) + list(toks[:-1]),
                           device=device)
        with torch.no_grad():
            logits = transformer_apply(params, seq[None], cfg)[0]
        return logits[len(req.prompt) - 1:].float().cpu().numpy()

    failures = []
    kinds = {k for _site, k, _hit in plan.fired}
    if not {"hang", "raise", "nan", "preempt"} <= kinds:
        failures.append(f"not every fault fired: {sorted(plan.fired)}")
    bitwise = {"restored": 0, "retried_or_untouched": 0}
    for rid, (toks, reason) in baseline.items():
        got = chaos.get(rid)
        if got is None:
            failures.append(f"rid={rid} missing from chaos run")
            continue
        same = list(got[0]) == list(toks) and got[1] == reason
        kind = "restored" if rid in restored else "retried_or_untouched"
        bitwise[kind] += same
        if same:
            continue
        ok, why = (greedy_agree(toks, got[0], ref_logits(rid, toks))
                   if rid in restored else (False, "not bitwise"))
        if not ok:
            failures.append(
                f"rid={rid}: chaos ({got[1]}) {list(got[0])} != "
                f"fault-free ({reason}) {list(toks)}: {why}")
    if set(chaos) != set(baseline):
        failures.append(f"rids {sorted(chaos)} != {sorted(baseline)}")
    if metrics.watchdog_trips_total != 1:
        failures.append(f"watchdog_trips_total="
                        f"{metrics.watchdog_trips_total}, want 1")
    if metrics.retries_total + metrics.dead_letter_total \
            != metrics.requests_failed:
        failures.append(
            f"retry ledger off: {metrics.retries_total} retries + "
            f"{metrics.dead_letter_total} dead letters != "
            f"{metrics.requests_failed} failed attempts")
    if metrics.fault_survived != metrics.fault_injected:
        failures.append(
            f"fault pair off: injected {metrics.fault_injected} != "
            f"survived {metrics.fault_survived}")
    # a fault-free churn run after recovery: nothing new to build
    again, churn, _ = run()
    for e in churn:
        e.close()
    new_shapes = set().union(*(e.prefill_shapes for e in churn)) \
        - warm_shapes
    new_libs = set(build._LIBS) - libs_warm
    if new_shapes or new_libs:
        failures.append(f"post-chaos churn met new prefill shapes "
                        f"{sorted(new_shapes)} / kernel libraries "
                        f"{sorted(new_libs)}")
    for rid, out in again.items():
        if list(out[0]) != list(baseline[rid][0]):
            failures.append(f"rid={rid}: post-chaos churn diverged")
    return {
        "selfcheck": "ok" if not failures else "FAIL",
        "chaos_seed": args.chaos,
        "decode_steps": args.decode_steps,
        "policy": args.policy,
        "device": device.type,
        "faults_fired": [list(f) for f in plan.fired],
        "watchdog_trips": metrics.watchdog_trips_total,
        "retries": metrics.retries_total,
        "dead_letters": metrics.dead_letter_total,
        "discarded_to_wasted": metrics.wasted_tokens,
        "restored": sorted(restored),
        "bitwise": bitwise,
        "churn_new_prefill_shapes": len(new_shapes),
        "churn_kernel_libraries_loaded": len(new_libs),
        "failures": failures,
    }


def _cmd_serve(args: argparse.Namespace) -> int:
    try:
        if args.selfcheck or args.chaos is not None:
            out = run_chaos_selfcheck(args)
            print(json.dumps(out))
            return 0 if out["selfcheck"] == "ok" else 1
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
        moe=moe_config(args), moe_every=args.moe_every,
        n_kv_heads=args.kv_heads or None, rope=args.rope, ffn=args.ffn,
        attn_window=args.attn_window or None,
        tie_embeddings=args.tie_embeddings)
    return TrainConfig(
        model=mcfg, learning_rate=args.lr, bucket_elems=args.bucket_elems,
        compute_dtype="bf16" if args.bf16 else "f32", remat=args.remat,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=args.steps, clip_norm=args.clip_norm,
        optimizer=args.optimizer, sgd_momentum=args.sgd_momentum,
        grad_accum=args.grad_accum, accum_schedule=args.accum_schedule,
        ema_decay=args.ema_decay,
        attn_impl=attn_impl or "auto", grad_transport=grad_wire(args),
        transport_schedule=args.grad_schedule, num_windows=args.grad_windows,
        microbatches=microbatches(args), pp_schedule=args.pp_schedule)


def microbatches(args: argparse.Namespace) -> int:
    """The pipeline's microbatches a step: ``--microbatches``, or ``--pp``
    (the JAX command's ``micro``); 1 without a pipeline."""
    return args.microbatches or (args.pp if args.pp > 1 else 1)


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
    from akka_allreduce_tpu_torch.models.train import (check_mesh_sizes,
                                                       check_supported)
    from akka_allreduce_tpu_torch.parallel.group import check_backend
    from akka_allreduce_tpu_torch.parallel.ring_attention import \
        _check_window_fits
    if args.steps < 0 or args.grad_accum < 1:
        raise ValueError("--steps must be >= 0 and --grad-accum >= 1")
    if args.dp < 0:
        raise ValueError(f"--dp must be >= 0 (0 = every device), got "
                         f"{args.dp}")
    if min(args.sp, args.tp, args.ep, args.pp) < 1:
        raise ValueError(f"--sp, --tp, --ep and --pp must be >= 1, got "
                         f"{args.sp}, {args.tp}, {args.ep} and {args.pp}")
    model_par = args.tp * args.sp * args.pp * args.ep
    if args.dp == 0:
        # the JAX command's dp = 0: the devices left after the model axes
        n_dev = (1 if args.device == "cpu" else torch.cuda.device_count()
                 if torch.cuda.is_available() else 0)
        dp = max(1, n_dev // model_par)
        if dp * model_par != n_dev:
            raise ValueError(f"dp*tp*sp*pp*ep = {dp * model_par} != "
                             f"{n_dev} devices")
        args.dp = dp
    if args.microbatches > 1 and args.pp == 1:
        raise ValueError("--microbatches requires --pp > 1 (microbatching "
                         "only exists on the pipeline path)")
    if args.pp > 1 and args.moe_experts and args.moe_every != 1:
        raise ValueError("--pp > 1 needs homogeneous layers: use "
                         "--moe-every 1 or drop --moe-experts")
    if args.grad_accum > 1 and args.pp > 1:
        raise ValueError("--grad-accum does not compose with --pp (the "
                         "pipeline path has its own --microbatches)")
    if args.microbatches < 0:
        raise ValueError(f"--microbatches must be >= 0 (0 = --pp), got "
                         f"{args.microbatches}")
    if args.grad_windows < 1:
        raise ValueError(f"--grad-windows must be >= 1, got "
                         f"{args.grad_windows}")
    if args.deadline_ms < 0:
        raise ValueError("--deadline-ms must be >= 0 (0 disables "
                         "deadlines)")
    if args.straggle_prob and not args.deadline_ms:
        raise ValueError("--straggle-prob needs --deadline-ms")
    if args.steps_per_dispatch < 1:
        raise ValueError("--steps-per-dispatch must be >= 1")
    nprocs = _check_coordinator_flags(args)
    if args.guard_recompiles:
        if args.coordinator or args.steps_per_dispatch > 1:
            raise ValueError("--guard-recompiles needs the per-step loop "
                             "(--steps-per-dispatch 1, no --coordinator): "
                             "the chunked tail and the hybrid's "
                             "catch-up/rejoin paths compile programs after "
                             "warmup by design")
        raise NotImplementedError("--guard-recompiles (the JAX compile "
                                  "guard) is ROADMAP A11, not ported")
    if args.steps_per_dispatch > 1 and (args.deadline_ms > 0
                                        or args.coordinator):
        # deadline masking and the processes' sync interact with the host
        # every round; a captured chunk has no host-visible round
        # boundary inside it
        raise ValueError("--steps-per-dispatch > 1 needs the "
                         "single-process exact path (no --deadline-ms / "
                         "--coordinator)")
    if args.max_lag < 0:
        # the JAX command leaves this to RoundPacer; checked here before
        # any rank is spawned
        raise ValueError("max_lag must be >= 0")
    dp, sp, ep = args.dp, args.sp, args.ep
    # the batch's rows shard over the dp x ep data ranks (ep doubles as
    # a data axis), dp-major; in the hybrid over the processes first
    shards = dp * ep * (nprocs if is_hybrid(args) else 1)
    micro = microbatches(args)
    b = args.batch or 2 * shards * micro * args.grad_accum
    t = args.seq or 32 * sp
    if b % shards:
        raise ValueError(
            f"--batch {b} must divide over --dp {dp} ranks" if ep == 1
            else f"--batch {b} must divide over {shards} data ranks "
                 f"(dp x ep)")
    if args.pp > 1 and (b // shards) % micro:
        raise ValueError(f"--microbatches {micro} must divide the per-rank "
                         f"batch {b // shards} (= batch {b} / {shards} "
                         f"{'ranks' if ep == 1 else 'data ranks'})")
    if (b // shards) % args.grad_accum:
        raise ValueError(f"--grad-accum {args.grad_accum} must divide the "
                         f"per-rank batch {b // shards} (= batch {b} / "
                         f"{shards} {'ranks' if ep == 1 else 'data ranks'}"
                         f")")
    if t % sp:
        raise ValueError(f"--seq {t} must divide over --sp {sp} ranks "
                         f"(each holds T / sp positions)")
    if sp > 1 and args.attn_window:
        _check_window_fits(args.attn_window, t // sp)
    # the quantized wires and the windowed and swing schedules need
    # exactly one >1 data axis (and swing a power-of-two one); the
    # hierarchical schedule is the ef8 wire over exactly two
    data_axes = {"dp": dp, "sp": sp, "ep": ep}
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
    cfg = train_config(args, t)
    check_supported(cfg)
    check_mesh_sizes(cfg, args.tp, ep, args.pp)
    device = "cuda" if args.device.startswith("cuda") else args.device
    backend = args.dist_backend or ("nccl" if device == "cuda" else "gloo")
    world = dp * model_par
    if args.coordinator and not is_hybrid(args) and world % nprocs:
        raise ValueError(f"the mesh's {world} ranks (dp*tp*sp*pp*ep) must "
                         f"divide over --num-processes {nprocs}")
    if world > 1:
        check_backend(backend, device, world)
        if args.steps_per_dispatch > 1 and device == "cuda" \
                and backend != "ipc":
            # a chunk is one CUDA graph; the host-staged wire is not
            # captured, and a chunk never runs step by step instead
            raise ValueError(
                f"--steps-per-dispatch > 1 across ranks on the card "
                f"captures the gradient sync into a CUDA graph, which "
                f"needs --dist-backend ipc (the {backend} wire stages "
                f"payloads through the host)")
    return b, t, backend


def is_hybrid(args: argparse.Namespace) -> bool:
    """``--coordinator`` with ``--deadline-ms``: each process's local mesh
    exact, the processes' sync deadline-gated through the store."""
    return bool(args.coordinator) and args.deadline_ms > 0


def _check_coordinator_flags(args: argparse.Namespace) -> int:
    """The multi-process flags; returns the process count (1 without
    ``--coordinator``)."""
    if not args.coordinator:
        if args.num_processes is not None or args.process_id is not None:
            raise ValueError("--num-processes / --process-id need "
                             "--coordinator")
        return 1
    n, pid = args.num_processes, args.process_id
    if n is None or pid is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"--process-id {pid} must be in 0..{n - 1} "
                         f"(--num-processes {n})")
    if is_hybrid(args) and max(args.tp, args.ep, args.pp) > 1:
        raise ValueError("--coordinator --deadline-ms runs a dp x sp local "
                         "mesh in each process; a local --tp / --ep / --pp "
                         "mesh is ROADMAP A9 part 2")
    return n


def run_train(args: argparse.Namespace, params: "dict | None" = None,
              attn_impl: "str | None" = None, on_step=None) -> dict:
    """Train for ``args.steps`` steps and return the report: per-step
    losses and wall ms, tokens/s and MFU over the steps after the first,
    and the kernels' launch counts during the run (``launches``: flash;
    ``ring_launches``: ring flash; ``sync_launches``: the gradient
    sync's). ``params`` (optional) are the starting weights (on one rank
    updated in place; with more ranks each trains a copy); otherwise they
    are random from seed 0. ``attn_impl`` overrides the config's "auto"
    (the flash or ring-flash path).

    With ``--pp Q`` x ``--dp N`` x ``--ep E`` x ``--sp S`` x ``--tp P`` >
    1 the CUDA kernels are built here first (the ranks never race
    ``nvcc``), then Q x N x E x S x P rank processes train
    (``parallel/group.py spawn_ranks``; a tp / ep rank keeps its shard
    of the model, a pp rank its stage's layers stacked, the checkpoint
    the full layout); only rank 0 prints, and
    the report is rank 0's, with ``dist`` (backend, world) and ``ranks``
    (each rank's peak memory, sync and attention-exchange ms per step and
    parameter checksum) added. With ``--deadline-ms`` the rounds run
    through a ``DeadlineTrainer``: each round's loss is read when the
    pacer harvests it, and ``deadline`` reports per round the ranks the
    clock saw late (``n_masked``), whether it fell back to an exact round
    and its ``min_bucket_count``. ``on_step(i, state)`` (one rank only),
    when given, is called after step ``i``'s update with the live
    ``TrainState`` (after each chunk's last step under
    ``--steps-per-dispatch``). With ``--coordinator`` this process joins
    the others through the coordinator's store
    (:func:`_train_coordinated`); under ``--deadline-ms`` the report adds
    ``hybrid`` (per round ``valid_peers``, ``n_masked``, ``n_partial``
    and the phases' ``times``; the peak RSS) and ``param_checksum``.
    Raises ValueError on bad flags, NotImplementedError on what the port
    has not ported, RuntimeError when CUDA is asked for and absent."""
    from akka_allreduce_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    _b, _t, backend = _check_train_flags(args)
    if args.coordinator:
        return _train_coordinated(args, params, attn_impl, device, backend,
                                  on_step)
    world = args.dp * args.sp * args.ep * args.tp * args.pp
    if world == 1:
        return _train(args, params, attn_impl, None, device, on_step)
    return _spawn_train(args, params, attn_impl, device, backend, world,
                        on_step)


def _spawn_train(args: argparse.Namespace, params, attn_impl, device,
                 backend: str, world: int, on_step=None,
                 join: "tuple | None" = None) -> dict:
    """Train on ``world`` spawned rank processes (this process's share
    of them with ``join``, see ``spawn_ranks``); rank 0's report with
    every rank's ``rank_info`` as ``ranks``."""
    from akka_allreduce_tpu_torch.models.train import tree_map
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    if on_step is not None:
        raise ValueError("on_step observes one rank's state: pp x dp x ep "
                         "x sp x tp = 1")
    if device.type == "cuda":
        from akka_allreduce_tpu_torch.ops.kernels import build
        build.build_all()
    host = None if params is None else tree_map(
        lambda p: p.detach().cpu(), params)
    reports = spawn_ranks(_train_rank, world, backend, device.type, args,
                          host, attn_impl, sp=args.sp, ep=args.ep,
                          tp=args.tp, pp=args.pp, join=join)
    report = reports[0]
    report["ranks"] = [r.pop("rank_info") for r in reports]
    return report


def _train_coordinated(args: argparse.Namespace, params, attn_impl, device,
                       backend: str, on_step=None) -> dict:
    """``train --coordinator``: join the coordinator's store (process 0
    hosts it), train, and leave only when every process has finished
    (process 0's store serves the others to their last read). The hybrid
    runs the process's local dp x sp mesh (in this process at a local
    world of one); the exact path runs this process's share of one mesh
    over every process's ranks."""
    from akka_allreduce_tpu_torch.runtime import coordinator
    nprocs, pid = args.num_processes, args.process_id
    coordinator.initialize_distributed(args.coordinator, nprocs, pid)
    try:
        if is_hybrid(args):
            local = args.dp * args.sp
            report = (_train(args, params, attn_impl, None, device, on_step)
                      if local == 1 else
                      _spawn_train(args, params, attn_impl, device, backend,
                                   local, on_step))
        else:
            host, port = coordinator.parse_address(args.coordinator)
            world = args.dp * args.sp * args.ep * args.tp * args.pp
            report = _spawn_train(args, params, attn_impl, device, backend,
                                  world, on_step,
                                  join=(host, port, pid, nprocs))
        coordinator.finish(timeout_s=max(60.0, 4 * args.deadline_ms / 1e3))
    finally:
        coordinator.shutdown()
    return report


def _train_rank(group, args: argparse.Namespace, params, attn_impl):
    """One rank of a ``--dp`` / ``--sp`` / ``--ep`` / ``--tp`` / ``--pp``
    run (a spawned process)."""
    return _train(args, params, attn_impl, group, group.device)


def _param_checksum(params) -> int:
    """The sum of every parameter's 32-bit patterns, in leaf order: equal
    on ranks whose parameters are bitwise equal."""
    from akka_allreduce_tpu_torch.models.train import tree_leaves
    return sum(int(p.detach().contiguous().view(torch.int32).sum(
        dtype=torch.int64)) for p in tree_leaves(params))


def _train(args: argparse.Namespace, params, attn_impl, group, device,
           on_step=None) -> dict:
    from akka_allreduce_tpu_torch.models import flops
    from akka_allreduce_tpu_torch.models.train import (data_rank_count,
                                                       dense_bucket_count,
                                                       elapsed_ms,
                                                       load_optimizer_state,
                                                       make_multi_step,
                                                       make_train_state,
                                                       make_train_step,
                                                       mask_line,
                                                       tree_leaves, tree_map)
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
    from akka_allreduce_tpu_torch.ops.kernels import quantized as qz
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    from akka_allreduce_tpu_torch.ops.kernels import transport as tp
    from akka_allreduce_tpu_torch.parallel import pp as pipeline
    from akka_allreduce_tpu_torch.parallel import ring_attention as ra

    from akka_allreduce_tpu_torch.models.train import (full_layout,
                                                       is_sharded,
                                                       shard_optimizer_state)

    world = 1 if group is None else group.world
    rank = 0 if group is None else group.rank
    # the batch's row block: (dp, ep), dp-major; its column block: sp
    row_blk = 0 if group is None else (
        group.axis_index("dp") * args.ep + group.axis_index("ep"))
    sp_j = 0 if group is None else group.axis_index("sp")
    log = print if rank == 0 else (lambda *a, **k: None)
    b, t, backend = _check_train_flags(args)
    hybrid = is_hybrid(args)
    # the hybrid's processes take the batch's row blocks, each over its
    # local dp
    procs, pid = ((args.num_processes, args.process_id) if hybrid
                  else (1, 0))
    local_b, local_t = b // (procs * args.dp * args.ep), t // args.sp
    row_blk += pid * args.dp
    if pid:  # the master's process narrates (and a catching-up worker)
        log = lambda *a, **k: None  # noqa: E731
    hybrid_report = None
    sharded = is_sharded(group)
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
    spd = args.steps_per_dispatch
    # chunks keep the step count, and read the learning rate, beside the
    # parameters (a captured chunk runs no host code)
    state = make_train_state(cfg, generator=generator, params=params,
                             device=device, device_step=spd > 1,
                             group=group)
    plan_report = None
    if cfg.transport_schedule == "auto":
        cfg, plan_report = _collective_plan(args, cfg, state.params, group,
                                            device, log)
    sync_times: list = []
    deadline = args.deadline_ms > 0 and not hybrid
    step = None if hybrid else make_train_step(cfg, group, sync_times,
                                               dynamic_valid=deadline)
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

    def saved_layout():
        """(params, optimizer state, EMA) as the checkpoint keeps them:
        the full layout on a tp / ep / pp mesh (every rank gathers)."""
        if not sharded:
            return state.params, _opt_state(state), state.ema
        full, opt, ema = full_layout(state, group)
        return full, {"optimizer": opt, "count": state.step}, ema

    start, mgr = 0, None
    if args.ckpt_dir:
        from akka_allreduce_tpu_torch.convert import shard_params
        from akka_allreduce_tpu_torch.runtime.checkpoint import (
            CheckpointConfig, restore_or_init)
        params_like, opt_like, ema_like = saved_layout()
        start, loaded, opt_state, extra, mgr = restore_or_init(
            CheckpointConfig(args.ckpt_dir,
                             save_interval_steps=args.ckpt_every),
            params_like, opt_like, ema=ema_like)
        if start:
            saved_opt = opt_state["optimizer"]
            if sharded:  # the full layout sliced back to this rank's
                loaded = shard_params(loaded, cfg.model, group)
                saved_opt = shard_optimizer_state(state, saved_opt, group)
                if ema_like is not None:
                    with torch.no_grad():
                        for live, saved in zip(
                                tree_leaves(state.ema), tree_leaves(
                                    shard_params(ema_like, cfg.model,
                                                 group))):
                            live.copy_(saved)
            with torch.no_grad():
                for live, saved in zip(tree_leaves(state.params),
                                       tree_leaves(loaded)):
                    live.copy_(saved)
            state.step = int(opt_state["count"])
            load_optimizer_state(state, saved_opt)
            log(f"resumed from step {start - 1} "
                f"(data position {extra.get('data_step', '?')})")
            if state.residual is not None:
                # this rank's ef8 residual, bitwise (the JAX ``sync`` item)
                saved = mgr.restore_sync(state.residual, start - 1, rank)
                if saved is None:
                    log("note: no ef8 residual in the checkpoint; error "
                        "feedback restarts from zero")
                else:
                    for live, value in zip(tree_leaves(state.residual),
                                           tree_leaves(saved)):
                        live.copy_(value)

    # the mesh, as the JAX command names it
    micro = cfg.microbatches
    log(f"mesh dp={args.dp} tp={args.tp} sp={args.sp} pp={args.pp} "
        f"ep={args.ep}; batch={b} seq={t} microbatches={micro}"
        + (f" moe_experts={args.moe_experts}" if cfg.model.moe else ""))
    pp_stats = None
    if args.pp > 1:
        pp_stats = pipeline.pp_schedule_stats(args.pp, micro)
        log(f"pp={args.pp} x {micro} microbatches, schedule "
            f"{args.pp_schedule}: bubble gpipe "
            f"{pp_stats['gpipe']['bubble_fraction']:.1%} (resident "
            f"{pp_stats['gpipe']['resident_microbatches']} microbatches) | "
            f"1f1b {pp_stats['1f1b']['bubble_fraction']:.1%} (resident "
            f"{pp_stats['1f1b']['resident_microbatches']})")
    sp_note = f" sp={args.sp}" if args.sp > 1 else ""
    sp_note += "".join(f" {a}={n}" for a, n in (("ep", args.ep),
                                                 ("tp", args.tp),
                                                 ("pp", args.pp)) if n > 1)
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
        return step_rng, batch[row_blk * local_b:(row_blk + 1) * local_b,
                               sp_j * local_t:(sp_j + 1) * local_t]

    counters = (lambda: (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
                         fa.FLASH_DKV_LAUNCHES),
                lambda: {"masked_reduce": mr.MASKED_REDUCE_LAUNCHES,
                         **qz.launch_counts()},
                rf.counts, tp.counts)
    before = [c() for c in counters]
    losses, step_ms, sync_ms, exchange_ms, min_counts = [], [], [], [], []
    # ms a step in the transfers along pp (the pipeline's ppermutes)
    transfer_ms: list = []
    pipeline.TRANSFER_MARKS = [] if args.pp > 1 else None
    moe_metrics: list = []  # (aux_loss, dispatch_fraction) a step
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
        if marks:  # one sync a step, or one a microbatch on overlap
            sync_ms.append(sum(elapsed_ms(*m) for m in marks))
        losses.append(loss)
        min_counts.append(int(metrics["min_bucket_count"]))
        moe_metrics.append((float(metrics["aux_loss"]),
                            float(metrics["dispatch_fraction"])))
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

    lead = rank == 0
    xprof = _XprofWindow(args.xprof_dir if lead else None,
                         start_step=start + 1, n_steps=args.xprof_steps,
                         device=device)
    telem = _TrainTelemetry(args if lead else None)
    multi, first = None, start
    try:
        if spd > 1:  # every step in chunks; the per-step loop runs none
            multi = make_multi_step(cfg, spd, group)
            _train_chunks(args, state, multi, build_batch, device, start,
                          mgr, xprof, telem, log, on_step,
                          (losses, step_ms, min_counts, dispatched, clocks,
                           transfer_ms), group, saved_layout)
            first = args.steps
        if hybrid:  # every round across the processes
            hybrid_report = _train_hybrid(
                args, cfg, state, group, build_batch, device, start, mgr,
                xprof, telem, log, on_step, saved_layout,
                (losses, step_ms, min_counts, dispatched, clocks), b * t)
            first = args.steps
        for i in range(first, args.steps):
            xprof.tick(i)
            t0 = time.perf_counter()
            dispatched.append(t0)
            ex0 = ra.EXCHANGE_SECONDS
            step_rng, batch = build_batch(i)
            tokens = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
            with telem.step_span(step=i) as ds, xprof.step(i):
                if trainer is None:
                    metrics = step(state, tokens)
                else:
                    r = trainer.open_round()
                    # arrival simulation, the same on every rank: each
                    # data rank lands on time or misses the deadline with
                    # --straggle-prob
                    for peer in range(trainer.clock.num_peers):
                        late = step_rng.random() < args.straggle_prob
                        trainer.clock.report_offset(
                            r, peer, (2.0 if late else 0.0)
                            * trainer.clock.deadline_s)
                    metrics = trainer.run_round(state, tokens)
                loss_now = None
                if ds is not None:
                    ds.mark_dispatched()
                    # the blocked readback inside the span: its tail is
                    # the step's device time (the price --metrics-file
                    # documents)
                    _wait(device)
                    loss_now = float(metrics["loss"])
            telem.on_step(b * t, loss=loss_now)
            exchange_ms.append((ra.EXCHANGE_SECONDS - ex0) * 1e3)
            if pipeline.TRANSFER_MARKS is not None:
                transfer_ms.append(sum(elapsed_ms(*m_)
                                       for m_ in pipeline.TRANSFER_MARKS))
                pipeline.TRANSFER_MARKS.clear()
            unread.append((i, t0, metrics, list(sync_times)))
            sync_times.clear()
            if on_step is not None:
                on_step(i, state)
            if mgr is not None and mgr.due(i):
                params_, opt_, ema_ = saved_layout()
                mgr.save(i, params_, opt_, {"data_step": i}, force=True,
                         sync=state.residual, group=group, ema=ema_)
            if trainer is None:
                read_round()  # waits for the step's device work
        if trainer is not None:
            trainer.drain()
            fell = sum(1 for rep in trainer.reports if rep.fell_back)
            log(f"lossy rounds: {trainer.masked_round_count}/"
                f"{len(trainer.reports)} had masked contributions "
                f"({fell} all-masked, ran exact for liveness)", flush=True)
        if mgr is not None and args.steps > start and not hybrid \
                and mgr.latest_step() != args.steps - 1:
            params_, opt_, ema_ = saved_layout()
            mgr.save(args.steps - 1, params_, opt_,
                     {"data_step": args.steps - 1}, force=True,
                     sync=state.residual, group=group, ema=ema_)
    finally:
        pipeline.TRANSFER_MARKS = None
        try:
            telem.close()  # the final metrics snapshot
        except Exception as exc:
            print(f"WARNING: metrics snapshot flush failed: {exc}",
                  file=sys.stderr)
        try:
            xprof.close()
        except Exception as exc:
            print(f"WARNING: device trace flush failed: {exc}",
                  file=sys.stderr)

    # wall time a step after the first: from the second step's dispatch
    # to the last read, over the steps in it (rounds that overlap under
    # the pacer have no boundaries of their own)
    step_s = clocks.get("wall_s")
    if step_s is not None:
        pass  # the chunked loop's own span (_train_chunks)
    elif len(dispatched) > 1:
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
                   "dp": args.dp, "sp": args.sp, "tp": args.tp,
                   "ep": args.ep, "pp": args.pp,
                   "microbatches": micro, "pp_schedule": args.pp_schedule,
                   "mesh": f"dp={args.dp} tp={args.tp} sp={args.sp} "
                           f"pp={args.pp} ep={args.ep}",
                   "moe_experts": args.moe_experts,
                   "grad_transport": cfg.grad_transport,
                   "transport_schedule": cfg.transport_schedule,
                   "bucket_elems": cfg.bucket_elems},
        "device": {"type": device.type,
                   "name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "matmul_allow_tf32":
                       torch.backends.cuda.matmul.allow_tf32},
        "losses": losses,
        # the MoE metrics a step (0 and 1 for a dense model; not read on
        # the chunked path)
        "aux_loss": [a for a, _ in moe_metrics],
        "dispatch_fraction": [d for _, d in moe_metrics],
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
        # pp > 1: the schedules' bubble and residency, and the ms a step
        # in the transfers along pp (CUDA events around each ppermute)
        "pp_schedule_stats": pp_stats,
        "pp_transfer_ms": transfer_ms,
        "optimizer": cfg.optimizer,
        # the optimizer's state tensors (state_dict), EMA excluded
        "optimizer_state_gb": _state_bytes(state.optimizer) / 1e9,
        "ema_decay": cfg.ema_decay,
        "accum_schedule": cfg.accum_schedule,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
        "metrics_file": args.metrics_file if rank == 0 else None,
        "xprof_trace": xprof.path,
    }
    if multi is not None:
        tcap = multi.transport
        report["multi_step"] = {
            "steps_per_dispatch": spd, "graph_replays": multi.replays,
            # the kernel launches one replay makes, by kernel
            "captured_launches": multi.captured_launches or {},
            "capture_seconds": multi.capture_seconds,
            # across ranks: each replay's boundary (drain, barrier,
            # counters rewound, barrier) and what a replay enqueues on the
            # ipc transport
            "boundary_ms": list(multi.boundary_ms),
            "stream_waits_per_replay": (None if tcap is None
                                        else tcap.stream_waits),
            "transport_per_replay": (None if tcap is None
                                     else dict(tcap.per_replay)),
            # a replay's calls and stream waits on each buffer (the
            # world's, each axis line's and each sync's sub-mesh's)
            "transport_lines_per_replay": (None if tcap is None
                                           else tcap.by_line()),
            # the attention's exchanges and the transfers along pp are
            # timed on eager steps only (the capture's warm-up, a tail):
            # a replay's run inside its graph, untimed
            "attn_exchange_ms": "eager steps only",
            "pp_transfer_ms": "eager steps only"}
        multi.close()  # the graph's memory back before the next run
    if plan_report is not None:
        report["collective_plan"] = plan_report
    if hybrid:
        report["hybrid"] = hybrid_report
        report["param_checksum"] = _param_checksum(state.params)
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
            "pp_transfer_ms": transfer_ms,
            **{k: report[k] for k in ("launches", "ring_launches",
                                      "sync_launches", "transport")},
            "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None),
            # the ipc transport's fixed peer buffers (cudaMalloc, outside
            # the allocator's peak)
            "transport_buffer_gb": sum(
                b.nbytes for b in peer_buffer_list("transport")
            ) / 1e9,
            "param_checksum": _param_checksum(state.params),
            "multi_step": report.get("multi_step")}
        if state.residual is not None:
            # the ef8 state's shape, and its largest entry in each sp
            # column shard (the hierarchical sync updates only the shard
            # this rank owns)
            # (an MoE run's dense plane; the expert plane beside it)
            planes = state.residual if isinstance(state.residual, dict) \
                else {"dense": state.residual}
            res = planes["dense"]
            cols = -(-res.shape[1] // args.sp)
            report["rank_info"].update(
                residual_shape=list(res.shape),
                # its 32-bit patterns summed, a block of rows at a time
                residual_checksum=_bits_checksum(res),
                residual_abs_max_by_sp_shard=[
                    float(res[:, j * cols:(j + 1) * cols].abs().max())
                    for j in range(args.sp)])
            if "expert" in planes:
                report["rank_info"].update(
                    expert_residual_shape=list(planes["expert"].shape),
                    expert_residual_checksum=_bits_checksum(
                        planes["expert"]))
    return report


# the connections a process's store client moves a payload's parts on
# (scripts/store_probe.py measures one against several)
STORE_LANES = 4


def _train_hybrid(args: argparse.Namespace, cfg, state, group,
                  build_batch, device, start: int, mgr, xprof, telem, log,
                  on_step, saved_layout, sinks: tuple,
                  step_tokens: int) -> dict:
    """The hybrid's round loop (the JAX ``train`` under ``--coordinator
    --deadline-ms``): ``catch_up`` before each round, then the round
    (``runtime/dcn_train.py``); driven by the trainer's round, not a
    loop counter, so every process stops at the same round. A stall
    beyond the retention window rejoins from the master's snapshot in
    the shared ``--ckpt-dir``. The master's process serves snapshot
    requests every 4th round and saves the checkpoints, at the applied
    frontier. ``--straggle-prob`` makes a worker process sleep 1.5
    deadlines before a round when its draw (``step_rng.random(nprocs)
    [process]`` after the batch) falls under it. Returns the report's
    ``hybrid`` entry."""
    from akka_allreduce_tpu_torch.protocol.kv import StoreKv
    from akka_allreduce_tpu_torch.runtime.coordinator import parse_address
    from akka_allreduce_tpu_torch.runtime.dcn_train import (
        DcnDeadlineTrainer, StalledBeyondRetention)
    losses, step_ms, min_counts, dispatched, clocks = sinks
    nprocs, pid = args.num_processes, args.process_id
    lead = group is None or group.rank == 0
    tracer = None
    if args.trace_file and lead:
        from akka_allreduce_tpu_torch.runtime.tracing import Tracer
        tracer = Tracer()
    wire = grad_wire(args)
    dcn = DcnDeadlineTrainer(
        cfg, group, deadline_s=args.deadline_ms / 1e3,
        client=(StoreKv.connect(*parse_address(args.coordinator),
                                lanes=STORE_LANES) if lead else None),
        rank=pid, num_processes=nprocs,
        # the DCN wire of an ef8 local sync is the stochastic int8 wire
        # (zero-mean across rounds: it needs no residual)
        wire="int8" if wire == "ef8" else wire, max_lag=args.max_lag,
        retain_rounds=args.retain_rounds, th_allreduce=args.th_allreduce,
        down_after=args.down_after,
        dcn_bucket_elems=args.dcn_bucket_elems or None,
        check_every=args.check_every, hb_timeout_s=args.master_timeout_s,
        tracer=tracer)
    if state.residual is not None:
        dcn.set_ef_state(state.residual)
    # the master's process owns the checkpoint writer (the parameters are
    # replicated); every process restores from the shared directory
    saver = mgr if pid == 0 else None

    def save(r: int, force: bool = False) -> None:
        if saver is None or not (force or saver.due(r)):
            return
        params_, opt_, ema_ = saved_layout()
        saver.save(r, params_, opt_, {"data_step": r}, force=True,
                   sync=state.residual, group=group, ema=ema_)

    def serve_snapshot_requests(rep) -> None:
        # master: a beyond-retention straggler asked to rejoin; polled
        # every 4th round (the request scan is a directory read)
        if not dcn.master or rep.round % 4:
            return
        if not dcn.pending_snapshot_requests():
            return
        if saver is None:
            print("WARNING: rejoin snapshot requested but no --ckpt-dir; "
                  "the straggler cannot recover", file=sys.stderr)
            return
        save(rep.round, force=True)
        dcn.publish_snapshot_step(rep.round)
        log(f"served rejoin snapshot at step {rep.round}")

    def rejoin_from_snapshot(exc) -> None:
        # worker: stalled beyond retention; restore the master's snapshot
        from akka_allreduce_tpu_torch.models.train import (
            load_optimizer_state, tree_leaves)
        from akka_allreduce_tpu_torch.runtime.checkpoint import (
            CheckpointConfig, restore_or_init)
        if not args.ckpt_dir:
            raise exc
        if lead:
            print(f"process {pid}: {exc}; requesting rejoin snapshot")
        prev = dcn.request_snapshot()
        snap = dcn.wait_snapshot(prev,
                                 timeout_s=max(120.0, 8 * dcn.deadline_s + 60))
        params_like, opt_like, ema_like = saved_layout()
        s2, loaded, opt_state, _extra, _m = restore_or_init(
            CheckpointConfig(args.ckpt_dir), params_like, opt_like,
            ema=ema_like)
        if s2 <= snap:
            raise RuntimeError(
                f"rejoin restore found step {s2 - 1} but the master "
                f"published {snap} — is --ckpt-dir on storage shared with "
                f"the master?")
        with torch.no_grad():
            for live, saved in zip(tree_leaves(state.params),
                                   tree_leaves(loaded)):
                live.copy_(saved)
        state.step = int(opt_state["count"])
        load_optimizer_state(state, opt_state["optimizer"])
        dcn.reset_to_round(s2)
        if lead:
            print(f"process {pid}: elastic rejoin via checkpoint snapshot "
                  f"at step {s2 - 1}")

    def after_round(rep, drained: bool = False) -> None:
        now = time.perf_counter()
        t0 = dispatched[-1] if dispatched else now
        step_ms.append((now - max(t0, clocks["read"])) * 1e3)
        clocks["read"] = now
        losses.append(rep.loss)
        min_counts.append(min(rep.bucket_counts))
        telem.on_step(step_tokens, loss=rep.loss)
        serve_snapshot_requests(rep)
        if rep.downed != clocks.get("downed", ()):
            # membership changes always narrate: auto-down is the event an
            # operator must see
            log(f"auto-downed processes now: {list(rep.downed) or 'none'} "
                f"(round {rep.round + 1})")
            clocks["downed"] = rep.downed
        save(rep.round)
        if on_step is not None:
            on_step(rep.round, state)
        clocks["window"] += 1
        if drained or rep.round == start \
                or (rep.round + 1) % max(1, args.log_every) == 0:
            pace = step_tokens * clocks["window"] / (now - clocks["tic"])
            partial = f", {rep.n_partial} partial" if rep.n_partial else ""
            log(f"step {rep.round + 1:4d}: loss {rep.loss:.4f} "
                + ("(drained)" if drained else f"({pace:.0f} tok/s)")
                + f" [masked {rep.n_masked}/{nprocs} procs{partial}]",
                flush=True)
            clocks["tic"], clocks["window"] = time.perf_counter(), 0

    dcn.set_start_round(start)
    rss = _RssPeak()
    try:
        while True:
            try:
                replayed = dcn.catch_up(state)
            except StalledBeyondRetention as exc:
                rejoin_from_snapshot(exc)
                continue
            if replayed and lead:
                print(f"process {pid}: caught up {replayed} rounds from DCN "
                      f"retention (stall ended at round {dcn.round})")
            i = dcn.round
            if i >= args.steps:
                break
            xprof.tick(i)
            dispatched.append(time.perf_counter())
            step_rng, batch = build_batch(i)
            tokens = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
            if args.straggle_prob and pid > 0 \
                    and step_rng.random(nprocs)[pid] < args.straggle_prob:
                # a straggler on the real clock: this process publishes
                # late (the master, which paces the rounds, never does)
                time.sleep(1.5 * dcn.deadline_s)
            try:
                rep = dcn.run_round(state, tokens)
            except StalledBeyondRetention as exc:
                rejoin_from_snapshot(exc)
                continue
            if rep is not None:
                after_round(rep)
        # one round at a time, so every checkpoint pairs the round with
        # the parameters applied through it
        while dcn.in_flight:
            after_round(dcn.harvest(state), drained=True)
        log(f"lossy rounds: {dcn.masked_round_count}/{len(dcn.reports)} "
            f"had masked processes", flush=True)
        if tracer is not None:
            n = tracer.write_jsonl(args.trace_file)
            log(f"wrote {n} trace events to {args.trace_file}")
        final = args.steps - 1
        if args.steps > start and saver is not None \
                and saver.latest_step() != final:
            save(final, force=True)
        # a straggler whose rejoin request landed in the master's last
        # rounds gets the final checkpoint on the way out
        if dcn.master and saver is not None and args.steps > start \
                and dcn.pending_snapshot_requests():
            dcn.publish_snapshot_step(final)
            log(f"served rejoin snapshot at step {final} (final)")
    finally:
        dcn.close()
        rss.stop()
    return {"process_id": pid, "num_processes": nprocs, "wire": dcn.wire,
            "deadline_ms": args.deadline_ms, "max_lag": args.max_lag,
            "rounds": [{"step": rep.round,
                        "valid_peers": list(rep.valid_peers),
                        "n_masked": rep.n_masked, "n_partial": rep.n_partial,
                        "bucket_counts": list(rep.bucket_counts),
                        "caught_up": rep.caught_up,
                        "downed": list(rep.downed), "loss": rep.loss,
                        "times": rep.times}
                       for rep in dcn.reports],
            "masked_round_count": dcn.masked_round_count,
            # this process's resident memory at the first round and its
            # peak over the rounds (the master's holds the store's
            # payloads)
            "start_rss_gb": rss.start / 1e9, "peak_rss_gb": rss.peak / 1e9}


class _RssPeak:
    """This process's resident memory sampled every 50 ms on a thread
    from construction to :meth:`stop`: ``start`` the first sample and
    ``peak`` the largest, in bytes (the kernel's lifetime peak would
    count what a long-lived process ran before)."""

    def __init__(self, interval_s: float = 0.05):
        import threading
        self.peak = 0
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._sample()
        self.start = self.peak
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(interval_s,),
                                        daemon=True, name="rss-peak")
        self._thread.start()

    def _sample(self) -> None:
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def _run(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            self._sample()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        self._sample()


def _bits_checksum(x: torch.Tensor) -> int:
    """The 32-bit patterns of an f32 tensor summed, a block of rows at a
    time."""
    return sum(int(blk.contiguous().view(torch.int32).sum(dtype=torch.int64))
               for blk in x.split(256))


def _wait(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_bytes(optimizer) -> int:
    """Bytes of the tensors in an optimizer's state dict."""
    return sum(v.numel() * v.element_size()
               for per_param in optimizer.state_dict()["state"].values()
               for v in per_param.values() if isinstance(v, torch.Tensor))


def _train_chunks(args, state, multi, build_batch, device, start, mgr,
                  xprof, telem, log, on_step, sinks, group,
                  layout) -> None:
    """``--steps-per-dispatch``'s loop (the JAX command's chunked path):
    a full chunk of N steps is one dispatch (``multi``: one CUDA graph
    replay on the card), a tail shorter than N runs step by step; the
    trace window ticks at chunk starts; a checkpoint is forced at a
    chunk's end whenever the chunk crossed a ``--ckpt-every`` line
    (``layout()``: the (params, optimizer state, EMA) it saves, the full
    layout on a tp / ep / pp mesh). Fills ``sinks`` (losses, step ms,
    min counts, dispatch times, clocks, and at pp > 1 the ms of the
    transfers along pp of each eager step: the capture's warm-up and the
    tail; a replay's are not timed) as the per-step loop does;
    ``clocks["wall_s"]`` is the wall time a step from the second
    dispatch to the last read."""
    from akka_allreduce_tpu_torch.models.train import elapsed_ms
    from akka_allreduce_tpu_torch.parallel import pp as pipeline
    losses, step_ms, min_counts, dispatched, clocks, transfer_ms = sinks
    spd, log_every = multi.n, max(1, args.log_every)
    marks = []  # (dispatch start, steps in it)
    window, tic = 0, time.perf_counter()
    i = start
    while i < args.steps:
        xprof.tick(i)  # chunk granularity: whole chunks traced
        n = min(spd, args.steps - i)
        chunk = torch.from_numpy(np.stack(
            [build_batch(j)[1] for j in range(i, i + n)])).to(device)
        for piece in ([chunk] if n == spd
                      else [chunk[j:j + 1] for j in range(n)]):
            k = piece.shape[0]
            t0 = time.perf_counter()
            marks.append((t0, k))
            dispatched.append(t0)
            with telem.step_span(chunk_steps=k) as ds:
                ms = multi(state, piece)
                loss_now = None
                if ds is not None:
                    ds.mark_dispatched()
                    _wait(device)
                    loss_now = float(ms["loss"][-1])
            telem.on_step(piece.numel(), loss=loss_now, steps=k)
            losses.extend(ms["loss"].tolist())  # waits for the dispatch
            if pipeline.TRANSFER_MARKS:  # the eager steps' transfers
                transfer_ms.append(sum(elapsed_ms(*m_)
                                       for m_ in pipeline.TRANSFER_MARKS))
                pipeline.TRANSFER_MARKS.clear()
            now = time.perf_counter()
            step_ms.extend([(now - t0) * 1e3 / k] * k)
            min_counts.extend(int(c) for c in ms["min_bucket_count"])
            clocks["read"] = now
        last = i + n - 1
        if on_step is not None:
            on_step(last, state)
        # --ckpt-every 0 is save-every-chunk (an interval of 1)
        every = max(1, args.ckpt_every)
        if mgr is not None and i // every != (last + 1) // every:
            params_, opt_, ema_ = layout()
            mgr.save(last, params_, opt_, {"data_step": last}, force=True,
                     sync=state.residual, group=group, ema=ema_)
        window += n
        if i == start or i // log_every != (last + 1) // log_every:
            toks = float(ms["tokens"][-1])
            log(f"step {last + 1:4d}: loss {losses[-1]:.4f} "
                f"({toks * window / (time.perf_counter() - tic):.0f} "
                f"tok/s)", flush=True)
            tic, window = time.perf_counter(), 0
        i += n
    if marks:
        first = 1 if len(marks) > 1 else 0
        clocks["wall_s"] = (clocks["read"] - marks[first][0]) / sum(
            k for _, k in marks[first:])


class _XprofWindow:
    """Device-trace window of ``train --xprof-dir``: a
    ``torch.profiler.profile`` (CPU activity and, on the card, CUDA)
    opens at ``start_step`` (skipping the first step's warm-up) and
    closes ``n_steps`` later or at run end, whichever first, then writes
    a Chrome trace into the directory (``path``). ``tick(i)`` is called
    with the step index about to run."""

    def __init__(self, log_dir, start_step: int = 1, n_steps: int = 3,
                 device=None):
        self.dir, self.start, self.n = log_dir, start_step, n_steps
        self.device = device
        self.path = None
        self._prof = None
        self._state = 0 if log_dir else 2  # 0 idle, 1 tracing, 2 done

    def tick(self, i: int) -> None:
        if self._state == 0 and i >= self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._state = 1
        elif self._state == 1 and i >= self.start + self.n:
            self._stop()

    def step(self, i: int):
        """A ``train_step i`` range around step ``i``'s work in the trace
        (on the card also a span over the kernels it launched); nothing
        outside the window."""
        if self._state != 1:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"train_step {i}")

    def _stop(self) -> None:
        self._state = 2
        if self.device is not None:
            _wait(self.device)  # the traced steps' kernels have run
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"train-trace-{os.getpid()}.json")
        self._prof.export_chrome_trace(self.path)

    def close(self) -> None:
        if self._state == 1:
            self._stop()
        elif self._state == 0:
            # the user asked for a trace and no step reached the window
            # (e.g. --steps-per-dispatch covering the whole run in one
            # chunk: ticks happen at chunk starts)
            print(f"WARNING: --xprof-dir {self.dir}: no steps reached "
                  f"the trace window (opens at step {self.start + 1}); "
                  f"lower --steps-per-dispatch or raise --steps",
                  file=sys.stderr)
            self._state = 2


class _TrainTelemetry:
    """``train --metrics-file`` wiring: a MetricsRegistry with
    train_steps_total / train_tokens_total / train_loss series and a
    DeviceTimer bracketing every dispatch (host against device time
    through the blocked loss readback, ``train_step_dispatch_gap_ms``
    the host bubble), snapshotted every ``--metrics-interval`` and at
    close. Every method is a no-op without the flag (``args`` None or no
    file), so the default loop pays nothing."""

    def __init__(self, args):
        self.enabled = bool(args is not None and args.metrics_file)
        self._stack = contextlib.ExitStack()
        self.registry = None
        self.timer = None
        if not self.enabled:
            return
        from akka_allreduce_tpu_torch.telemetry.device import DeviceTimer
        from akka_allreduce_tpu_torch.telemetry.registry import \
            MetricsRegistry
        self.registry = MetricsRegistry()
        self.timer = DeviceTimer("train_step", registry=self.registry)
        self._steps = self.registry.counter(
            "train_steps_total", help="optimizer steps applied")
        self._tokens = self.registry.counter(
            "train_tokens_total", help="tokens consumed")
        self._loss = self.registry.gauge(
            "train_loss", help="latest step loss")
        self._stack.enter_context(self.registry.start_snapshotter(
            args.metrics_file, args.metrics_interval))

    @contextlib.contextmanager
    def step_span(self, **fields):
        """Bracket one dispatch; yields the DeviceSpan (None when
        disabled): the caller marks the dispatch and blocks inside."""
        if self.timer is None:
            yield None
            return
        with self.timer.span(**fields) as ds:
            yield ds

    def on_step(self, n_tokens: float, loss=None, steps: int = 1) -> None:
        if not self.enabled:
            return
        self._steps.inc(steps)
        self._tokens.inc(n_tokens)
        if loss is not None:
            self._loss.set(float(loss))

    def close(self) -> None:
        self._stack.close()  # the final snapshot write


def _collective_plan(args: argparse.Namespace, cfg, params, group, device,
                     log) -> tuple:
    """``--grad-schedule auto``: measure (or reload) the collective plan
    on the run's own rank group at its own bucket matrix, every rank
    together, and freeze it into the config. Returns the config and the
    report's ``collective_plan`` entry."""
    import dataclasses

    from akka_allreduce_tpu_torch.models.train import (dense_bucket_count,
                                                       expert_bucket_count,
                                                       sync_groups)
    from akka_allreduce_tpu_torch.ops.autotune import load_or_measure
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    shapes = [(dense_bucket_count(cfg, params), cfg.bucket_elems)]
    if cfg.model.moe is not None:
        shapes.append((expert_bucket_count(cfg, params), cfg.bucket_elems))
    plan_dir = args.plan_dir or args.ckpt_dir
    if plan_dir is None:
        log("note: --grad-schedule auto without --plan-dir/--ckpt-dir: "
            "the plan is measured fresh every start (give it a directory "
            "to reload on restart)")
    t_plan = time.perf_counter()
    # measured on the dense sync's group (the JAX _data_axes)
    plan, reused = load_or_measure(
        plan_dir, RankGroup.single(device) if group is None
        else sync_groups(cfg, group)[0], shapes,
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
            "generate": _cmd_generate, "eval": _cmd_eval,
            "emulate": _cmd_emulate, "master": _cmd_master,
            "worker": _cmd_worker}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
