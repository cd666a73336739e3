"""Rank-side helpers of the expert- and tensor-parallel tests
(``tests/test_torch_train_moe.py``, ``test_torch_tp.py``,
``test_torch_ep.py``): spawned ranks import this module, which imports
no JAX."""

import numpy as np
import torch

from akka_allreduce_tpu_torch.convert import gather_params, params_from_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.parallel.ep import MoEConfig


def make_cfg(model: dict, moe: "dict | None", **kw) -> "train.TrainConfig":
    mcfg = TransformerConfig(
        **model, moe=None if moe is None else MoEConfig(**moe))
    return train.TrainConfig(model=mcfg, **kw)


def local_tokens(group, tokens: np.ndarray) -> torch.Tensor:
    """This rank's block of the global (B, T) batch: rows sharded over
    (dp, ep), dp-major, columns over sp."""
    dp, ep, sp = (group.axis_size(a) for a in ("dp", "ep", "sp"))
    b, t = tokens.shape[0] // (dp * ep), tokens.shape[1] // sp
    r = group.axis_index("dp") * ep + group.axis_index("ep")
    c = group.axis_index("sp")
    return torch.from_numpy(np.ascontiguousarray(
        tokens[r * b:(r + 1) * b, c * t:(c + 1) * t])).to(group.device)


def grads_rank(group, model, moe, kw, params_np, tokens, steps=1):
    """``steps`` grad steps (the params unchanged) on this rank's shard:
    the gathered full gradients of the last, its metrics and, on ef8,
    the residual planes."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    step = train.make_grad_step(cfg, group)
    mine = local_tokens(group, tokens)
    residual = state.residual
    for i in range(steps):
        out = step(state.params, mine, quant_seed=i, residual=residual)
        if cfg.grad_transport == "ef8":
            residual = out[2]
    grads, metrics = out[0], out[1]
    full = gather_params(grads, cfg.model, group)
    return {"grads": full, "metrics": {k: float(v) for k, v in
                                       metrics.items()},
            "residual": residual}


def train_rank(group, model, moe, kw, params_np, batches):
    """Train steps on this rank's shard: the losses and the gathered
    final params."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    step = train.make_train_step(cfg, group)
    losses = [float(step(state, local_tokens(group, b))["loss"])
              for b in batches]
    return {"losses": losses,
            "params": gather_params(state.params, cfg.model, group)}


def moe_ep_rank(group, moe, params_np, x, permute=False):
    """``moe_ffn`` over the rank's ep line on its block of rows of ``x``
    (B, T, D), and the gradients of ``sum(y * y)``: the expert leaves
    this rank's, the router's summed over ep. ``permute`` swaps the
    blocks of one rank's outgoing all_to_all (the fault control)."""
    from akka_allreduce_tpu_torch.parallel import ep as E
    cfg = MoEConfig(**moe)
    line = group.along("ep")
    n = line.world
    e_l = cfg.n_experts // n
    p = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    p["we1"] = p["we1"][line.rank * e_l:(line.rank + 1) * e_l]
    p["we2"] = p["we2"][line.rank * e_l:(line.rank + 1) * e_l]
    for v in p.values():
        v.requires_grad_(True)
    b = x.shape[0] // n
    xs = torch.from_numpy(np.array(x[line.rank * b:(line.rank + 1) * b]))
    real = E._AllToAll.forward

    def swapped(ctx, blocks, g):
        if line.rank == 0:
            blocks = blocks.flip(0)
        return real(ctx, blocks, g)
    if permute:
        E._AllToAll.forward = staticmethod(swapped)
    try:
        y, aux = E.moe_ffn(xs, p, cfg, line)
    finally:
        E._AllToAll.forward = staticmethod(real)
    (y * y).sum().backward()
    router = line.all_gather(p["router"].grad[None]).sum(0)
    return {"y": y.detach(), "kept": float(aux["dispatch_fraction"]),
            "router": router, "we1": p["we1"].grad, "we2": p["we2"].grad}


def moe_ep_cases(group, cases):
    """:func:`moe_ep_rank` for each ``(moe, params, x, permute)`` of
    ``cases``, in one spawn."""
    return [moe_ep_rank(group, *case) for case in cases]


def tp_mlp_rank(group, w1, w2, x, doubled=False):
    """A two-layer MLP ``gelu(x @ w1) @ w2`` on the rank's tp shards
    (``w1`` columns, ``w2`` rows) with the Megatron boundary and sum, and
    the gradients of ``sum(y * y)`` as full tensors: dx, dw1, dw2.
    ``doubled`` replaces the operators with a plain sum in both
    directions (the control the JAX docstring warns of)."""
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch.parallel import tp as T
    line = group.along("tp")
    n, r = line.world, line.rank
    c = w1.shape[1] // n
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    a = torch.from_numpy(np.array(w1[:, r * c:(r + 1) * c]))
    b = torch.from_numpy(np.array(w2[r * c:(r + 1) * c]))
    a.requires_grad_(True)
    b.requires_grad_(True)
    if doubled:
        class PlainSum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, v):
                return T._psum(v, line)

            @staticmethod
            def backward(ctx, ct):
                return T._psum(ct, line)
        h = T.column_parallel_dense(xt, a)
        y = PlainSum.apply(F.gelu(h, approximate="tanh") @ b)
    else:
        h = T.column_parallel_dense(T.tp_grad_boundary(xt, line), a)
        y = T.row_parallel_dense(F.gelu(h, approximate="tanh"), b, line)
    (y * y).sum().backward()
    return {"y": y.detach(), "dx": xt.grad,
            "dw1": line.all_gather(a.grad.T.contiguous()).T,
            "dw2": line.all_gather(b.grad)}


def tp_mlp_pair(group, w1, w2, x):
    """:func:`tp_mlp_rank` with the Megatron operators and with the
    doubled control, in one spawn."""
    return [tp_mlp_rank(group, w1, w2, x), tp_mlp_rank(group, w1, w2, x,
                                                        True)]


def ef8_planes_rank(group, model, moe, kw, params_np, tokens):
    """One ef8 grad step of an MoE model at dp = world: its synced dense
    and expert gradients and the two residual planes it leaves, beside
    those of the dense and the expert trees synced alone from zero with
    their own keys ((17, 0, 0) and (17, 0, 1)) and, as the control, with
    the keys swapped. The
    rank's unsynced gradients are the one-rank step's on its tokens
    times 1 / world (a power of two: exact)."""
    from akka_allreduce_tpu_torch.parallel.dp import allreduce_gradients
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    mine = local_tokens(group, tokens)
    out = train.make_grad_step(cfg, group)(state.params, mine, quant_seed=0,
                                           residual=state.residual)
    local, _ = train.make_grad_step(
        train.TrainConfig(**{**cfg.__dict__, "grad_transport": "f32"}))(
        state.params, mine)
    local = train.tree_map(lambda g: g / group.world, local)
    dense, expert = train.split_expert_leaves(local)
    dense_g, expert_g = train.sync_groups(cfg, group)
    step_dense, step_expert = train.split_expert_leaves(out[0])
    res = {"step": {"dense": (step_dense, out[2]["dense"]),
                    "expert": (step_expert, out[2]["expert"])}}
    for name, keys in (("own", (0, 1)), ("swapped", (1, 0))):
        res[name] = {}
        for plane, tree, g, tag in (("dense", dense, dense_g, keys[0]),
                                    ("expert", expert, expert_g, keys[1])):
            r = allreduce_gradients(tree, train.sync_config(cfg, g.world),
                                    g, quant_key=train.quant_key(0, tag=tag))
            res[name][plane] = (r.grads, r.residual)
    return res
