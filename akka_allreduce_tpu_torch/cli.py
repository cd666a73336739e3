"""Command line of the port: ``serve``.

Counterpart of ``akka_allreduce_tpu/cli.py serve`` for the flags the
first slice of the port carries (model shape, slot or paged engine,
closed or open synthetic load). It builds a model from ``--seed``, runs
the synthetic load through ``serve_loop`` and prints ONE JSON summary
line shaped like the JAX command's. It runs on ``cuda`` unless
``--device cpu`` is given, and raises when CUDA is asked for and absent::

    python -m akka_allreduce_tpu_torch.cli serve --paged \\
        --paged-attention kernel --d-model 2048 --n-heads 16 \\
        --kv-heads 4 --n-layers 8 --d-ff 8192 --vocab 32768 --rope
"""

from __future__ import annotations

import argparse
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="akka_allreduce_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_serve(sub)
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


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return {"serve": _cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
