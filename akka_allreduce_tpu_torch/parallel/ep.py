"""Expert parallelism: the mixture-of-experts layer over the ``ep`` axis.

Counterpart of ``akka_allreduce_tpu/parallel/ep.py`` (the Switch/GShard
recipe): top-k routing, slot assignment and capacity as one-hot and
cumsum tensor algebra with static shapes; one ``all_to_all`` over the
``ep`` ranks each way (tokens to the ranks that own their experts, the
results back); a token that misses its expert's capacity is dropped from
that expert (the residual path keeps it), and the layer reports the
fraction it dispatched.

Rank-local: every rank of an ``ep`` line calls :func:`moe_ffn` with its
own tokens and its ``n_experts / ep`` experts. ``group`` is the rank's
line along ``ep`` (``RankGroup.along("ep")``); None (or a group of one)
runs every expert here, the JAX ``axis_name=None``. The exchange is
:class:`_AllToAll`, ``group.all_to_all`` (split and concatenate along
axis 0, ``lax.all_to_all(split_axis=0, concat_axis=0)``) whose backward
is the same exchange. The expert products are ``torch.einsum``: the JAX
package computes them outside any Pallas kernel.

Numerics kept from the JAX function: the slot bookkeeping is f32 whatever
the model dtype (a bf16 cumsum saturates past 256 and merges slots);
``argmax`` takes the first maximum (``jnp.argmax``); the one-hot of a
dropped token's slot is a zero row (``jax.nn.one_hot`` of an index out of
range); ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default);
the route fractions enter the aux loss detached; the scatter path adds
zeros at a dropped token's clipped slot, so its sum is exact.

The expert weights ``we1``/``we2`` are ep-rank-OWNED: the train step
syncs their gradients over the data axes only, apart from the dense
leaves (``models/train.py split_expert_leaves``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch.parallel.group import RankGroup


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """``n_experts`` is global; each ep rank owns ``n_experts // ep``.
    ``capacity_factor`` scales the per-expert slot count above the
    perfectly balanced load; ``router_k`` experts are combined per token.
    ``dispatch``: "einsum" (the (N, E, C) one-hot products), "scatter"
    (integer slot indices: scatter-add in, gather out) or "auto" (scatter
    once the dispatch tensor would pass ``_EINSUM_DISPATCH_MAX``
    elements)."""

    n_experts: int = 8
    d_ff: int = 512
    capacity_factor: float = 1.25
    router_k: int = 2
    aux_loss_coef: float = 1e-2
    dispatch: str = "auto"


def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Static per-expert slot count: ceil(cf * k * N / E), floor 1."""
    ideal = cfg.capacity_factor * cfg.router_k * n_tokens / cfg.n_experts
    return max(1, int(-(-ideal // 1)))


def init_moe_layer(generator: torch.Generator, d_model: int, cfg: MoEConfig,
                   ep: int = 1, dtype=torch.float32,
                   device: "torch.device | str | None" = None) -> dict:
    """MoE FF parameters: ``router`` (d_model, E), ``we1`` (E, d_model,
    d_ff), ``we2`` (E, d_ff, d_model), with the FULL expert dimension
    (the train step keeps each rank's slice). Normal draws scaled as the
    JAX function scales them; the draws themselves differ from
    ``jax.random``'s."""
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")
    device = torch.device(device if device is not None
                          else generator.device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    scale = d_model ** -0.5
    return {"router": normal(d_model, cfg.n_experts) * scale,
            "we1": normal(cfg.n_experts, d_model, cfg.d_ff) * scale,
            "we2": normal(cfg.n_experts, cfg.d_ff, d_model)
            * (cfg.d_ff ** -0.5)}


# "auto" switches to scatter dispatch above this many (N, E, C) elements
_EINSUM_DISPATCH_MAX = 1 << 24


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row (``jax.nn.one_hot``; ``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k_assign(probs: torch.Tensor, k: int, capacity: int):
    """The slot assignment both dispatch formulations share. probs (N, E)
    f32. Returns (expert_idx (k, N) int32, slot (k, N) int32, keep (k, N)
    f32, gate_k (k, N) f32, kept_fraction, route_frac (E,)). Choice-major
    priority (every token's first choice outranks any second choice, the
    GShard rule) through a cumsum over the stacked one-hots, every
    counter f32."""
    n, e = probs.shape
    masked = probs
    idxs, gates = [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        oh = _one_hot(idx, e)
        idxs.append(idx.to(torch.int32))
        gates.append((probs * oh).sum(-1))
        masked = masked * (1.0 - oh)
    expert_idx = torch.stack(idxs)
    gate_k = torch.stack(gates)
    if k > 1:
        # the k gates renormalised per token (GShard top-2, generalised);
        # k = 1 keeps the raw router probability (Switch)
        gate_k = gate_k / torch.clamp(gate_k.sum(0, keepdim=True),
                                      min=1e-9)
    flat = _one_hot(expert_idx.reshape(k * n), e)
    pos = torch.cumsum(flat, dim=0) - flat  # slots taken before mine
    slot_f = (pos * flat).sum(-1)
    keep = (slot_f < capacity).float().reshape(k, n)
    slot = slot_f.to(torch.int32).reshape(k, n)
    kept_fraction = keep.sum() / (k * n)
    route_frac = flat.sum(0) / (k * n)
    return expert_idx, slot, keep, gate_k, kept_fraction, route_frac


def _top_k_dispatch(probs: torch.Tensor, k: int, capacity: int,
                    out_dtype=None):
    """Greedy top-k assignment with shared per-expert capacity. probs
    (N, E). Returns (dispatch (N, E, C) 0/1, combine (N, E, C)
    gate-weighted, kept_fraction, route_frac (E,), the pre-capacity
    assignment fraction the load-balance loss reads), the bookkeeping in
    f32 and the two tensors in ``out_dtype``."""
    e = probs.shape[1]
    out_dtype = out_dtype or probs.dtype
    probs = probs.float()
    expert_idx, slot, keep, gate_k, kept_fraction, route_frac = \
        _top_k_assign(probs, k, capacity)
    oh_e = _one_hot(expert_idx, e)                       # (k, N, E)
    oh_c = _one_hot(slot, capacity)                      # (k, N, C)
    dispatch_k = (keep[..., None, None] * oh_e[..., :, None]
                  * oh_c[:, :, None, :])                 # (k, N, E, C)
    dispatch = dispatch_k.sum(0)
    combine = (dispatch_k * gate_k[:, :, None, None]).sum(0)
    return (dispatch.to(out_dtype), combine.to(out_dtype), kept_fraction,
            route_frac)


class _AllToAll(torch.autograd.Function):
    """``group.all_to_all`` along axis 0, whose transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return ctx.group.all_to_all(ct.contiguous()), None


def expert_all_to_all(x: torch.Tensor, group: Optional[RankGroup]
                      ) -> torch.Tensor:
    """``lax.all_to_all(x, "ep", split_axis=0, concat_axis=0)``,
    differentiable: block p goes to ep rank p."""
    if group is None or group.world == 1:
        return x
    return _AllToAll.apply(x, group)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig,
            group: Optional[RankGroup] = None
            ) -> tuple[torch.Tensor, dict]:
    """The MoE feed-forward block, rank-local. x (B, T, D): this rank's
    tokens; ``params`` holds ``router`` and this rank's experts of
    ``we1``/``we2``. Returns (y (B, T, D), aux): ``aux_loss`` (the Switch
    load-balance loss, coefficient-scaled, a per-token mean) and
    ``dispatch_fraction`` (the share of the k N assignments that found a
    slot). Capacity comes from this call's own token count."""
    b, t, d = x.shape
    n = b * t
    e = cfg.n_experts
    ep = 1 if group is None else group.world
    e_local = e // ep
    c = expert_capacity(cfg, n)
    k = cfg.router_k
    tokens = x.reshape(n, d)

    logits = tokens @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    if cfg.dispatch not in ("auto", "einsum", "scatter"):
        raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
    use_scatter = (cfg.dispatch == "scatter"
                   or (cfg.dispatch == "auto"
                       and n * e * c > _EINSUM_DISPATCH_MAX))
    if use_scatter:
        # index-based dispatch: O(k N) routing state, the long-context
        # path; a dropped token adds zeros at its clipped slot
        expert_idx, slot, keep, gate_k, kept, route_frac = _top_k_assign(
            probs, k, c)
        flat_idx = (expert_idx.long() * c
                    + torch.clamp(slot.long(), max=c - 1)).reshape(-1)
        keep_flat = keep.reshape(-1)
        toks_rep = tokens[None].expand(k, n, d).reshape(-1, d)
        expert_in = torch.zeros((e * c, d), dtype=x.dtype,
                                device=x.device).index_add(
            0, flat_idx, toks_rep * keep_flat[:, None].to(x.dtype)
        ).reshape(e, c, d)
    else:
        # probs stay f32 into the dispatch (gate precision, argmax ties);
        # the dispatch and combine tensors are in the model dtype
        dispatch, combine, kept, route_frac = _top_k_dispatch(
            probs, k, c, out_dtype=x.dtype)
        expert_in = torch.einsum("nd,nec->ecd", tokens, dispatch)

    # Switch aux loss: E * sum_e (the pre-capacity fraction routed to e)
    # * (the mean probability of e), differentiable through the
    # probabilities only
    mean_prob = probs.mean(0)
    aux_loss = cfg.aux_loss_coef * e * torch.sum(route_frac.detach()
                                                 * mean_prob)

    # block s of the expert buffer -> ep rank s; receive this rank's
    # experts' slots from every source rank
    recv = expert_all_to_all(expert_in.reshape(ep, e_local, c, d), group)
    h = torch.einsum("secd,edf->secf", recv, params["we1"])
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("secf,efd->secd", h, params["we2"])
    expert_out = expert_all_to_all(out, group).reshape(e, c, d)

    if use_scatter:
        picked = expert_out.reshape(e * c, d)[flat_idx]      # (k N, D)
        w = (gate_k.reshape(-1) * keep_flat).to(x.dtype)
        y = (picked * w[:, None]).reshape(k, n, d).sum(0)
    else:
        y = torch.einsum("ecd,nec->nd", expert_out, combine)
    aux = {"aux_loss": aux_loss, "dispatch_fraction": kept}
    return y.reshape(b, t, d), aux
