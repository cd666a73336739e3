"""Pipeline parallelism: GPipe and 1F1B microbatch pipelining over ``pp``.

Counterpart of ``akka_allreduce_tpu/parallel/pp.py``. The layer stack
is stacked (:func:`stack_layer_params`: one tensor a leaf with a leading
layer dim) and split over the ``pp`` axis of the rank mesh: rank ``h``
holds layers ``[h L / pp, (h + 1) L / pp)``, its stage. Microbatches
move between the stages with one :meth:`RankGroup.ppermute` along
``pp`` a tick.

The JAX pipeline is a ``lax.scan`` over ticks whose backward comes from
autodiff. Here each schedule runs its ticks as a Python loop on explicit
tensors, and its backward is written out:

* :func:`gpipe_apply` runs the forward ticks and returns a
  :class:`GPipeRun`; its :meth:`GPipeRun.backward` runs the ticks in
  reverse, each with one ``ppermute`` by -1 on every rank and one
  ``torch.autograd.grad`` over the tick's saved stage graph. Autograd
  is never left to cross ticks: the reverse transfer is a collective
  over the ``pp`` line, and rank 0 never uses what it receives, so an
  autograd graph through the transfers would not run that node there
  and the other ranks would wait for it.
* :func:`one_f_one_b` is the fused PipeDream-flush schedule: each tick
  one forward unit and one backward unit a rank, the activations going
  +1 and the cotangents -1 along ``pp``, the saved stage inputs in a
  ring of ``min(m, 2 pp - 1)`` slots, the backward unit recomputing its
  stage from the saved input.

A rank skips the stage compute on the fill and drain ticks outside its
``[idx, idx + m)`` (the JAX scan computes them on garbage and masks the
results), but still makes the tick's transfer: every rank of a ``tp``,
``ep`` or ``sp`` line inside a stage has the same stage index, so the
collectives inside the stages stay paired. Works at ``pp = 1`` (one
stage, the transfers the identity).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import torch

from akka_allreduce_tpu_torch.ops.bucketing import (tree_leaves, tree_map,
                                                    tree_unflatten)
from akka_allreduce_tpu_torch.parallel.group import RankGroup

# stage_fn(stage_params, h) -> (h, aux): aux a dict of 0-dim tensors,
# summed over the valid ticks
StageFn = Callable[[Any, torch.Tensor], "tuple[torch.Tensor, dict]"]

# (start, end) marks around each transfer along the pipeline axis (CUDA
# events on the card, the host clock on the CPU), appended while this is
# a list (``cli train`` sets one for its report's ``pp_transfer_ms``);
# a transfer that a CUDA graph captures is not marked
TRANSFER_MARKS: Optional[list] = None


def _mark(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _transfer(group: RankGroup, x: torch.Tensor, axis: str,
              shift: int) -> torch.Tensor:
    """``group.ppermute(x, axis, shift)``, marked in
    :data:`TRANSFER_MARKS` when that is a list and no CUDA graph is
    being captured."""
    marks = TRANSFER_MARKS
    if marks is None or (x.device.type == "cuda"
                         and torch.cuda.is_current_stream_capturing()):
        return group.ppermute(x, axis, shift)
    start = _mark(x.device)
    out = group.ppermute(x, axis, shift)
    marks.append((start, _mark(x.device)))
    return out


def _structure(tree) -> Any:
    """The nesting of ``tree`` with its leaves left out (dict keys sorted,
    lists by length), the JAX treedef's counterpart for comparing
    layers."""
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(_structure(v) for v in tree))
    return "*"


def stack_layer_params(layers: Sequence[dict]) -> dict:
    """Stack a homogeneous list of per-layer param dicts into one dict of
    tensors with a leading layer dim: the layout that splits over ``pp``.
    Heterogeneous layers (dense FF mixed with MoE, ``moe_every > 1``)
    cannot stack."""
    if not layers:
        raise ValueError("no layers to stack")
    struct0 = _structure(layers[0])
    for i, lyr in enumerate(layers[1:], 1):
        if _structure(lyr) != struct0:
            raise ValueError(
                f"layer {i} structure differs from layer 0 — pipeline "
                f"stages need homogeneous layers (got {_structure(lyr)}"
                f" vs {struct0})")
    leaves = [tree_leaves(lyr) for lyr in layers]
    return tree_unflatten(layers[0],
                          [torch.stack(xs) for xs in zip(*leaves)])


def unstack_layer_params(stacked: dict, n_layers: int) -> list:
    """Inverse of :func:`stack_layer_params`."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n_layers)]


def _unbind_layers(stacked: dict) -> list:
    """The per-layer dicts of ``stacked`` as views (one ``unbind`` a
    leaf: its backward stacks the layers' gradients once)."""
    leaves = tree_leaves(stacked)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(stacked, [p[i] for p in parts])
            for i in range(leaves[0].shape[0])]


def scan_blocks(stacked: dict, x: torch.Tensor,
                block_fn: Callable[[dict, torch.Tensor],
                                   "tuple[torch.Tensor, dict]"]
                ) -> "tuple[torch.Tensor, dict]":
    """Apply a stack of layers in order (the JAX ``lax.scan``). Returns
    the final activations and the per-key sum of the blocks' aux
    dicts."""
    total: dict = {}
    for layer in _unbind_layers(stacked):
        x, aux = block_fn(layer, x)
        for k, v in aux.items():
            total[k] = v if k not in total else total[k] + v
    return x, total


def pp_schedule_stats(s: int, m: int) -> dict:
    """The schedules' economics for ``s`` stages x ``m`` microbatches, as
    the JAX ``pp_schedule_stats`` gives them: the bubble (the idle share
    of a rank's compute slots) and the stage inputs a rank holds at
    peak. GPipe: ``(s-1)/(m+s-1)`` with ``m + s - 1`` resident (the JAX
    scan keeps a residual every tick; the port skips the fill and drain
    ticks and keeps ``m``). 1F1B: ``(2s-2)/(m+2s-2)`` with ``min(m,
    2s-1)`` resident."""
    return {
        "gpipe": {
            "bubble_fraction": (s - 1) / (m + s - 1),
            "resident_microbatches": m + s - 1,
        },
        "1f1b": {
            "bubble_fraction": (2 * s - 2) / (m + 2 * s - 2),
            "resident_microbatches": min(m, 2 * s - 1),
        },
    }


def last_stage_only(value: torch.Tensor, group: RankGroup,
                    axis: str = "pp") -> torch.Tensor:
    """``value`` on the last stage, zero elsewhere (the loss is real only
    there)."""
    if group.axis_index(axis) == group.axis_size(axis) - 1:
        return value
    return torch.zeros_like(value)


def _accumulate(acc: list, grads) -> None:
    """``acc[i] += grads[i]`` in f32 (a None gradient adds nothing)."""
    for i, g in enumerate(grads):
        if g is None:
            continue
        if acc[i] is None:
            acc[i] = g.detach().float().clone()
        else:
            acc[i].add_(g.detach())


def _filled(acc: list, like: list) -> list:
    """The accumulators, zeros (f32) where nothing was added."""
    return [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            if a is None else a for a, x in zip(acc, like)]


@dataclasses.dataclass
class GPipeRun:
    """The forward of :func:`gpipe_apply` on this rank, and its backward.

    ``outputs`` (m, ...) are the last stage's outputs of the m
    microbatches, a leaf that requires grad, on the last stage; None on
    every other rank. ``aux`` is the stage's aux dict, each value summed
    over this rank's m valid ticks and divided by m, as 0-dim leaves (a
    value that carries a gradient requires grad). ``peak_graphs`` is the
    most tick graphs this rank held at once (m: one a valid tick)."""

    outputs: Optional[torch.Tensor]
    aux: dict
    stage_params: Any
    group: RankGroup
    axis: str
    m: int
    ticks: list
    like: torch.Tensor
    peak_graphs: int = 0
    live_graphs: int = 0

    def backward(self, d_outputs: Optional[torch.Tensor] = None,
                 d_aux: Optional[dict] = None
                 ) -> "tuple[Any, Optional[torch.Tensor]]":
        """The reverse ticks: ``(d_stage_params, d_x_micro)`` for the
        cotangents of ``outputs`` (the last stage's; None is zero) and of
        ``aux`` (None: zero). ``d_stage_params`` is shaped like
        ``stage_params``, f32 (every tick's gradient added in f32);
        ``d_x_micro`` (m, ...) is rank 0's, None elsewhere. Each tick,
        every rank issues one ``ppermute`` by -1 along the axis, then
        runs ``torch.autograd.grad`` over the tick's graph, which it then
        drops. Call once."""
        g, axis, m = self.group, self.axis, self.m
        s, idx = g.axis_size(axis), g.axis_index(axis)
        d_aux = d_aux or {}
        leaves = tree_leaves(self.stage_params)
        acc: list = [None] * len(leaves)
        d_x = [None] * m
        zero = torch.zeros_like(self.like)
        d_buf = zero
        for t in reversed(range(len(self.ticks))):
            # the transpose of tick t's send: the cotangent of what this
            # rank sent comes back from the rank it went to
            d_y = _transfer(g, d_buf, axis, -1)
            rec = self.ticks[t]
            self.ticks[t] = None
            if rec is None:  # a fill or drain tick: nothing to carry
                d_buf = zero
                continue
            x_in, y, aux_t = rec
            mb = t - idx
            if idx == s - 1 and d_outputs is not None:
                d_y = d_y + d_outputs[mb].to(d_y.dtype)
            outs, cts = [y], [d_y]
            for k, a in aux_t.items():
                ct = d_aux.get(k)
                if ct is not None and a.requires_grad:
                    outs.append(a)
                    cts.append((ct / m).to(a.dtype).reshape(a.shape))
            grads = torch.autograd.grad(outs, leaves + [x_in], cts,
                                        allow_unused=True)
            self.live_graphs -= 1
            _accumulate(acc, grads[:-1])
            dx = grads[-1] if grads[-1] is not None else zero
            if idx == 0:
                d_x[mb] = dx
                d_buf = zero
            else:
                d_buf = dx
        d_stage = tree_unflatten(self.stage_params, _filled(acc, leaves))
        return d_stage, (torch.stack(d_x) if idx == 0 else None)


def gpipe_apply(stage_params: Any, x_micro: torch.Tensor, stage_fn: StageFn,
                group: RankGroup, axis: str = "pp") -> GPipeRun:
    """Run the microbatches ``x_micro`` (m, ...) through the stage
    pipeline along ``axis`` of ``group``: ``m + s - 1`` ticks; each
    tick stage 0 injects microbatch ``t``, every rank in its valid range
    runs ``stage_fn`` on what it holds and every rank sends its result
    one step along ``axis`` (one ``ppermute`` by +1). Only rank 0 reads
    ``x_micro`` (the other ranks' may be any tensor of its shape and
    dtype). Each valid tick's stage input is saved as a leaf that
    requires grad, with the stage graph built on it, for
    :meth:`GPipeRun.backward` (m graphs a rank; the JAX scan's O(m)
    residency). Returns the :class:`GPipeRun`."""
    s, idx = group.axis_size(axis), group.axis_index(axis)
    m = x_micro.shape[0]
    like = x_micro[0].detach()
    zero = torch.zeros_like(like)
    run = GPipeRun(None, {}, stage_params, group, axis, m, [], like)
    outputs = [None] * m
    aux_sum: dict = {}
    buf = zero
    for t in range(m + s - 1):
        mb = t - idx
        if 0 <= mb < m:
            x_in = (x_micro[mb] if idx == 0 else buf).detach()
            x_in.requires_grad_(True)
            with torch.enable_grad():
                y, aux_t = stage_fn(stage_params, x_in)
            run.ticks.append((x_in, y, aux_t))
            run.live_graphs += 1
            run.peak_graphs = max(run.peak_graphs, run.live_graphs)
            for k, a in aux_t.items():
                a = a.detach()
                aux_sum[k] = a if k not in aux_sum else aux_sum[k] + a
            send = y.detach()
            if idx == s - 1:
                outputs[mb] = send
        else:
            run.ticks.append(None)
            send = zero
        buf = _transfer(group, send, axis, 1)
    if idx == s - 1:
        run.outputs = torch.stack(outputs).requires_grad_(True)
    for k, v in aux_sum.items():
        v = v / m
        if v.is_floating_point():
            v.requires_grad_(True)
        run.aux[k] = v
    return run


def one_f_one_b(stage_params: Any, other_params: Any,
                tokens_micro: torch.Tensor,
                stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                embed_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                head_fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
                group: RankGroup, axis: str = "pp",
                stats: Optional[dict] = None):
    """One-forward-one-backward (PipeDream-flush) pipelined train step
    along ``axis`` of ``group``: ``m + 2(s - 1)`` ticks, each with one
    forward unit (microbatch ``t - idx``) and one backward unit
    (microbatch ``t - (2(s-1) - idx)``) a rank; the activations go +1
    and the cotangents -1 along the axis, one ``ppermute`` each a tick
    on every rank. The forward unit runs ``stage_fn`` without a graph
    and saves its stage input in a ring of ``min(m, 2s - 1)`` slots (a
    fill tick writes none; a write never finds its slot still holding a
    pending input: raises if it would); the backward unit recomputes
    the stage under autograd from the saved input and takes the
    gradients at once, so a rank holds one stage graph at a time. The
    last stage feeds the head's gradient of the microbatch it has just
    run forward in the same tick; the embedding's gradient is taken on
    rank 0 and the head's on the last stage.

    ``stage_fn(stage_params, h) -> h`` (no aux: MoE stays on gpipe),
    ``embed_fn(other_params, tokens_mb) -> h``, ``head_fn(other_params,
    h_mb, mb) -> loss`` (this microbatch's, already globally scaled).
    Returns ``(loss_sum, d_stage, d_other)``: the summed loss (nonzero
    on the last stage only) and f32 gradients shaped like the two
    trees. ``stats``, when given, receives ``ring_depth``,
    ``peak_inputs`` (the most stage inputs the ring held at once) and
    ``peak_graphs`` (the most stage graphs alive at once)."""
    s, idx = group.axis_size(axis), group.axis_index(axis)
    m = tokens_micro.shape[0]
    ring_w = max(1, min(m, 2 * s - 1))
    first, last = idx == 0, idx == s - 1
    stage_leaves = tree_leaves(stage_params)
    other_leaves = tree_leaves(other_params)
    d_stage: list = [None] * len(stage_leaves)
    d_other: list = [None] * len(other_leaves)
    with torch.no_grad():
        zero = torch.zeros_like(embed_fn(other_params, tokens_micro[0]))
    ring: list = [None] * ring_w  # (microbatch, saved stage input)
    loss_sum = torch.zeros((), dtype=torch.float32, device=zero.device)
    fwd_recv, bwd_recv = zero, zero
    peak_inputs = peak_graphs = live = 0
    for t in range(m + 2 * (s - 1)):
        # ---- forward unit: microbatch t - idx ----
        mf = t - idx
        y = zero
        if 0 <= mf < m:
            with torch.no_grad():
                x_in = (embed_fn(other_params, tokens_micro[mf]) if first
                        else fwd_recv)
                y = stage_fn(stage_params, x_in)
            slot = mf % ring_w
            if ring[slot] is not None:
                raise RuntimeError(
                    f"1f1b ring slot {slot} still holds microbatch "
                    f"{ring[slot][0]} when microbatch {mf} is written")
            ring[slot] = (mf, x_in)
            peak_inputs = max(peak_inputs,
                              sum(r is not None for r in ring))
        # ---- backward unit: microbatch t - (2(s-1) - idx) ----
        mb = t - (2 * (s - 1) - idx)
        dx = zero
        if 0 <= mb < m:
            if last:
                # the head on the forward unit's fresh output (mb == mf)
                y_leaf = y.detach().requires_grad_(True)
                with torch.enable_grad():
                    loss_mb = head_fn(other_params, y_leaf, mb)
                grads = torch.autograd.grad(loss_mb, other_leaves + [y_leaf],
                                            allow_unused=True)
                _accumulate(d_other, grads[:-1])
                ct = grads[-1]
                loss_sum = loss_sum + loss_mb.detach().float()
            else:
                ct = bwd_recv
            saved_mb, x_saved = ring[mb % ring_w]
            if saved_mb != mb:
                raise RuntimeError(f"1f1b ring holds microbatch {saved_mb} "
                                   f"where {mb} is read")
            ring[mb % ring_w] = None
            x_leaf = x_saved.detach().requires_grad_(True)
            with torch.enable_grad():
                y2 = stage_fn(stage_params, x_leaf)
            live += 1
            peak_graphs = max(peak_graphs, live)
            grads = torch.autograd.grad(y2, stage_leaves + [x_leaf],
                                        ct.to(y2.dtype), allow_unused=True)
            del y2  # the graph went with the gradients
            live -= 1
            _accumulate(d_stage, grads[:-1])
            if grads[-1] is not None:
                dx = grads[-1]
            if first:
                with torch.enable_grad():
                    x_e = embed_fn(other_params, tokens_micro[mb])
                grads = torch.autograd.grad(x_e, other_leaves,
                                            dx.to(x_e.dtype),
                                            allow_unused=True)
                _accumulate(d_other, grads)
        fwd_recv = _transfer(group, y, axis, 1)
        bwd_recv = _transfer(group, dx, axis, -1)
    if stats is not None:
        stats.update(ring_depth=ring_w, peak_inputs=peak_inputs,
                     peak_graphs=peak_graphs)
    return (loss_sum,
            tree_unflatten(stage_params, _filled(d_stage, stage_leaves)),
            tree_unflatten(other_params, _filled(d_other, other_leaves)))
