"""Command line of the port: ``serve`` and ``train``.

Counterparts of ``akka_allreduce_tpu/cli.py serve`` and ``train`` for the
flags the port's slices carry. Both run on ``cuda`` unless ``--device
cpu`` is given, and raise when CUDA is asked for and absent.

``serve`` (model shape, slot or paged engine, closed or open synthetic
load) builds a model from ``--seed``, runs the synthetic load through
``serve_loop`` and prints ONE JSON summary line shaped like the JAX
command's::

    python -m akka_allreduce_tpu_torch.cli serve --paged \\
        --paged-attention kernel --d-model 2048 --n-heads 16 \\
        --kv-heads 4 --n-layers 8 --d-ff 8192 --vocab 32768 --rope

``train`` (one process, one card) trains the flagship transformer from
random weights on synthetic tokens or ``--data-file``, drawing the JAX
command's per-step batches and printing its ``step N: loss X (Y tok/s)``
lines; its attention runs the CUDA flash kernels
(``ops/kernels/csrc/flash_attention.cu``)::

    python -m akka_allreduce_tpu_torch.cli train --d-model 2048 \\
        --n-heads 16 --n-layers 8 --d-ff 8192 --vocab 32768 --seq 2048 \\
        --batch 8 --bf16 --lr 1e-4 --steps 6 --log-every 1
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
                   help="sequence length (0 = 32)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant",
                   help="cosine = linear warmup then cosine decay to 0 "
                        "at --steps")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--bucket-elems", type=int, default=1 << 16,
                   help="gradient bucket size of the multi-rank sync "
                        "(carried; one card has no sync)")
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
    p.add_argument("--data-file", default=None,
                   help="train on a corpus: raw bytes (vocab 256) or "
                        "*.bin little-endian uint16 tokens (vocab 65536); "
                        "omitted = synthetic random tokens. Batches are "
                        "deterministic in the step index")
    p.add_argument("--log-every", type=int, default=10,
                   help="print a progress line every N steps")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without CUDA raises")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="akka_allreduce_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_serve(sub)
    _add_train(sub)
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
        attn_impl=attn_impl or "auto")


def run_train(args: argparse.Namespace, params: "dict | None" = None,
              attn_impl: "str | None" = None) -> dict:
    """Train for ``args.steps`` steps and return the report: per-step
    losses and wall ms, tokens/s and MFU over the steps after the first,
    and the flash kernels' launch counts during the run. ``params``
    (optional) are the starting weights, updated in place; otherwise
    they are random from seed 0. ``attn_impl`` overrides the config's
    "auto" (the flash path). Raises ValueError on bad flags,
    NotImplementedError on what the port has not ported, RuntimeError
    when CUDA is asked for and absent."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.models import flops
    from akka_allreduce_tpu_torch.models.train import (make_train_state,
                                                       make_train_step,
                                                       tree_leaves)
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa

    device = resolve_device(args.device)
    if args.steps < 0 or args.grad_accum < 1:
        raise ValueError("--steps must be >= 0 and --grad-accum >= 1")
    b = args.batch or 2 * args.grad_accum
    if b % args.grad_accum:
        raise ValueError(f"--grad-accum {args.grad_accum} must divide the "
                         f"batch {b}")
    t = args.seq or 32
    log_every = max(1, args.log_every)
    corpus = None
    if args.data_file:
        from akka_allreduce_tpu_torch.data import load_corpus
        corpus = load_corpus(args.data_file)
        needed = (corpus.max_token() + 1
                  if args.vocab < corpus.vocab_size else 0)
        if args.vocab < needed:
            print(f"note: raising --vocab {args.vocab} -> {needed} to "
                  f"cover the corpus (largest token id {needed - 1})")
            args.vocab = needed
    cfg = train_config(args, t, attn_impl)
    generator = None
    if params is None:
        generator = torch.Generator(device=device).manual_seed(0)
    state = make_train_state(cfg, generator=generator, params=params,
                             device=device)
    step = make_train_step(cfg)

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
            print(f"resumed from step {start - 1} "
                  f"(data position {extra.get('data_step', '?')})")

    print(f"device {device.type}; batch={b} seq={t} "
          f"grad_accum={args.grad_accum} attn={cfg.attn_impl}")

    def build_batch(i):
        # deterministic per-step data stream, drawn as the JAX command
        # draws it: a resumed run sees the tokens the dead run would have
        if corpus is not None:
            return corpus.batch(i, b, t)
        return np.random.default_rng(i).integers(0, args.vocab, size=(b, t),
                                                 dtype=np.int32)

    before = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    losses, step_ms = [], []
    tic = time.perf_counter()
    steps_in_window = 0
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(build_batch(i)).to(device)
        metrics = step(state, tokens)
        loss = float(metrics["loss"])  # waits for the step's device work
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if mgr is not None:
            mgr.maybe_save(i, state.params, _opt_state(state),
                           {"data_step": i})
        steps_in_window += 1
        if i == start or (i + 1) % log_every == 0:
            toks = float(metrics["tokens"])
            dt = time.perf_counter() - tic
            print(f"step {i + 1:4d}: loss {loss:.4f} "
                  f"({toks * steps_in_window / dt:.0f} tok/s)", flush=True)
            tic = time.perf_counter()
            steps_in_window = 0
    if mgr is not None and args.steps > start \
            and mgr.latest_step() != args.steps - 1:
        mgr.save(args.steps - 1, state.params, _opt_state(state),
                 {"data_step": args.steps - 1}, force=True)

    steady = step_ms[1:] or step_ms
    step_s = sum(steady) / len(steady) / 1e3 if steady else None
    peak = flops.chip_peak_flops(device)
    step_flops = flops.transformer_step_flops(cfg.model, b, t)
    after = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
             fa.FLASH_DKV_LAUNCHES)
    return {
        "config": {"batch": b, "seq": t, "steps": args.steps,
                   "start_step": start, "compute_dtype": cfg.compute_dtype,
                   "attn_impl": cfg.attn_impl, "n_layers": args.n_layers,
                   "params": sum(p.numel()
                                 for p in tree_leaves(state.params))},
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
                             (a - c for a, c in zip(after, before)))),
    }


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
    return {"serve": _cmd_serve, "train": _cmd_train}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
