"""Carry model weights, training state and protocol buffers between the
JAX package and the port.

Both packages keep one parameter layout (``wq`` is ``(d_model,
d_model)`` and used as ``h @ wq``; see models/transformer.py), so
conversion is a leaf-for-leaf copy that keeps names, nesting, shapes and
dtypes. The JAX side is handed over as numpy arrays (``np.asarray`` of
each leaf), so this module needs neither JAX nor the JAX package.

:func:`train_state_from_jax` maps a JAX training checkpoint's items, read
template-free from orbax (``scripts/orbax_to_torch.py`` reads them where
JAX is installed; here they are numpy trees), to what the port's
``runtime/checkpoint.py`` restores: the params, the optimizer chain's
state as the port optimizer's ``state_dict()`` and the step count, the
EMA weights, each rank's ef8 residual (its shard's or stage's plane,
in the port's rank order, on any mesh) and the ``extra`` dict.

:func:`buffer_state_from_numpy` carries a protocol staging buffer's
state (the numpy ring of the JAX host plane, its counts and its offset)
into the port's buffer on a device, so both engines can go on from one
mid-round state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.parallel.pp import (stack_layer_params,
                                                  unstack_layer_params)


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same 16 bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(tree, device="cpu"):
    """A JAX parameter pytree (dicts and lists of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) -> the same nesting of torch
    tensors on ``device``, dtypes and layouts unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf_to_torch(tree, device)


def params_to_jax(params):
    """The inverse of :func:`params_from_jax`: torch tensors -> numpy
    arrays with the same nesting, ready for ``jnp.asarray``."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_jax(v) for v in params]
    return _leaf_to_numpy(params)


# -- tensor-, expert- and pipeline-parallel shards ---------------------------
#
# The JAX package's ``param_specs`` (models/train.py): wq/wk/wv/w1/w3
# ``P(None, "tp")``, wo/w2 ``P("tp", None)``, we1/we2 ``P("ep", None,
# None)``, every other leaf replicated. A rank keeps the contiguous block
# at its coordinate along the leaf's axis. With ``pp > 1`` the layers are
# stacked (``parallel/pp.py stack_layer_params``: ``params["layers"]`` a
# dict of ``(L, ...)`` leaves, ``P("pp", *spec)``): a rank keeps its
# stage's ``L / pp`` layers, each leaf's split dim shifted by one.

_LAYER_SPLITS = {"wq": ("tp", 1), "wk": ("tp", 1), "wv": ("tp", 1),
                 "w1": ("tp", 1), "w3": ("tp", 1), "wo": ("tp", 0),
                 "w2": ("tp", 0), "we1": ("ep", 0), "we2": ("ep", 0)}


def layer_split(name: str) -> "Optional[tuple]":
    """``(mesh axis, dim)`` a layer leaf ``name`` is split along, or None
    for a replicated leaf."""
    return _LAYER_SPLITS.get(name)


def leaf_splits(name: str, group, stacked: bool = False) -> tuple:
    """The ``(dim, mesh axis)`` pairs a layer leaf ``name`` is split along
    on ``group``'s mesh, axes of one rank left out: for a ``stacked``
    leaf dim 0 along ``pp``, then its own split one dim on."""
    out = []
    if stacked and group.axis_size("pp") > 1:
        out.append((0, "pp"))
    split = layer_split(name)
    if split is not None and group.axis_size(split[0]) > 1:
        out.append((split[1] + int(stacked), split[0]))
    return tuple(out)


def narrow_splits(x: torch.Tensor, splits: tuple, group) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` along each ``(dim,
    axis)`` of ``splits`` (a detached copy, or ``x`` when there is
    none)."""
    for dim, axis in splits:
        n = group.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"{axis}={n} must divide dim {dim} of "
                             f"{tuple(x.shape)}")
        c = x.shape[dim] // n
        x = x.detach().narrow(dim, group.axis_index(axis) * c, c).clone()
    return x


def gather_splits(x: torch.Tensor, splits: tuple, group) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` (detached): an
    all-gather along each split's axis line, a collective over them."""
    for dim, axis in reversed(splits):
        blocks = group.along(axis).all_gather(
            x.detach().movedim(dim, 0).contiguous())
        x = blocks.movedim(0, dim).contiguous()
    return x


def shard_leaf(name: str, x: torch.Tensor, group,
               stacked: bool = False) -> torch.Tensor:
    """This rank's block of the full layer leaf ``x`` (a detached copy),
    or ``x`` itself when the leaf is replicated or its axis has one
    rank. A ``stacked`` leaf is this stage's layers already: its own
    split is taken one dim on."""
    splits = tuple(sp for sp in leaf_splits(name, group, stacked)
                   if sp[1] != "pp")
    return narrow_splits(x, splits, group) if splits else x


def gather_leaf(name: str, x: torch.Tensor, group,
                stacked: bool = False) -> torch.Tensor:
    """The full layer leaf from every rank's block ``x`` (detached; an
    all-gather along the leaf's axis lines: a collective over them). A
    ``stacked`` leaf gathers its stages along ``pp`` too, into ``(L,
    ...)``."""
    splits = leaf_splits(name, group, stacked)
    return gather_splits(x, splits, group) if splits else x


def _check_mesh(cfg, group) -> None:
    pp = group.axis_size("pp")
    if pp > 1:
        if cfg.n_layers % pp:
            raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
        if cfg.moe is not None and cfg.moe_every != 1:
            raise ValueError(
                "pipeline stages need homogeneous layers: use moe_every=1 "
                "(all-MoE) or moe=None (all-dense) when pp > 1")
    tp, ep = group.axis_size("tp"), group.axis_size("ep")
    if cfg.n_heads % tp or cfg.d_ff % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.kv_heads}, and d_ff={cfg.d_ff}")
    if cfg.moe is not None and cfg.moe.n_experts % ep:
        raise ValueError(f"ep={ep} must divide "
                         f"n_experts={cfg.moe.n_experts}")


def stage_layers(n_layers: int, group) -> range:
    """The layers of this rank's pipeline stage: ``[h L / pp, (h + 1) L /
    pp)`` at stage ``h``."""
    pp = group.axis_size("pp")
    per = n_layers // pp
    h = group.axis_index("pp")
    return range(h * per, (h + 1) * per)


def shard_params(full: dict, cfg, group) -> dict:
    """A full (unsharded) parameter tree -> this rank's shard of it on
    the mesh of ``group`` (a ``RankGroup``), as the JAX ``param_specs``
    lay it out; ``cfg`` is the ``TransformerConfig``. Replicated leaves
    are the full tree's own tensors. With ``pp > 1`` the rank's stage's
    layers are stacked (``full``'s layers a list, or a stacked dict of
    all ``L``)."""
    _check_mesh(cfg, group)
    return _shard(full, cfg.n_layers, group)


def _shard(full: dict, n_layers: int, group) -> dict:
    """:func:`shard_params` past its checks, for ``n_layers`` layers."""
    out = {k: v for k, v in full.items() if k != "layers"}
    layers = full["layers"]
    if isinstance(layers, dict):
        layers = unstack_layer_params(layers, n_layers)
    if group.axis_size("pp") == 1:
        out["layers"] = [{k: shard_leaf(k, v, group)
                          for k, v in layer.items()} for layer in layers]
        return out
    stacked = stack_layer_params(
        [layers[i] for i in stage_layers(n_layers, group)])
    out["layers"] = {k: shard_leaf(k, v, group, stacked=True)
                     for k, v in stacked.items()}
    return out


def gather_params(shard: dict, cfg, group) -> dict:
    """The inverse of :func:`shard_params`: every rank's shard -> the
    full tree in the list layout (the stacked stages unstacked), on
    every rank (a collective over the mesh: each rank calls it with its
    own shard)."""
    _check_mesh(cfg, group)
    return gather_tree(shard, group)


def gather_tree(shard: dict, group, unstack: bool = True) -> dict:
    """:func:`gather_params` of any params-shaped tree (gradients, the
    EMA), its leaves detached. With ``unstack=False`` a pp-stacked tree
    stays stacked, its leaves ``(L, ...)``: the JAX package's global
    tree at pp > 1 (``stack_layer_params``), which :func:`shard_params`
    cuts back."""
    out = {k: v.detach() for k, v in shard.items() if k != "layers"}
    if isinstance(shard["layers"], dict):
        full = {k: gather_leaf(k, v, group, stacked=True)
                for k, v in shard["layers"].items()}
        if not unstack:
            out["layers"] = full
            return out
        out["layers"] = unstack_layer_params(
            full, next(iter(full.values())).shape[0])
        return out
    out["layers"] = [{k: gather_leaf(k, v, group) for k, v in layer.items()}
                     for layer in shard["layers"]]
    return out


# -- training checkpoints ---------------------------------------------------
#
# The JAX chain (akka_allreduce_tpu/models/train.py make_optimizer) is
# optax.chain(step_counter(), [clip_by_global_norm], <family>,
# [param_ema]). orbax restores it template-free with each namedtuple as a
# dict of its fields, each tuple as a list and each EmptyState as None:
# slot 0 {"count"}, the clip slot None, the family's chain a list whose
# first slot holds its moments, the EMA slot {"ema"}. The slots are
# matched in that order, never by searching the tree for a field set
# (ROADMAP C6: the JAX package's legacy graft takes the first match).

# the fields of each family's first slot, and the port state keys they
# become (adafactor's are placed by the leaf's factored dims)
_FAMILY_SLOT = {"adamw": ("count", "mu", "nu"), "lion": ("count", "mu"),
                "adafactor": ("count", "v", "v_col", "v_row"),
                "sgd": ("trace",)}


def _chain_slots(cfg) -> list:
    """The JAX chain's slot names for ``cfg`` (a port ``TrainConfig``),
    in chain order."""
    return (["count"] + (["clip"] if cfg.clip_norm > 0 else [])
            + [cfg.optimizer] + (["ema"] if cfg.ema_decay > 0 else []))


def _family_state(cfg, core) -> Optional[dict]:
    """The family slot's moments (a dict of params-shaped trees and the
    count), or None where optax keeps none (sgd without momentum)."""
    fields = _FAMILY_SLOT[cfg.optimizer]
    first = core[0] if isinstance(core, list) and core else None
    if cfg.optimizer == "sgd" and not cfg.sgd_momentum:
        if first is not None:
            raise ValueError("the checkpoint's sgd chain keeps a trace; "
                             "this run's sgd has no momentum")
        return None
    if not isinstance(first, dict) or tuple(sorted(first)) != fields:
        got = sorted(first) if isinstance(first, dict) else first
        raise ValueError(f"the checkpoint's optimizer slot holds {got}; "
                         f"--optimizer {cfg.optimizer} keeps {list(fields)}"
                         f": convert with the family that trained it")
    return first


def optimizer_state_from_jax(cfg, params: dict, opt_state) -> dict:
    """The JAX chain's state (template-free orbax: see above) -> the
    port's ``{"optimizer": state_dict, "count": steps}``, the state dict
    that ``models/train.py make_optimizer(cfg, params)`` loads: adamw's
    ``exp_avg`` / ``exp_avg_sq`` / ``step`` (optax's mu, nu, count),
    lion's ``mu``, adafactor's ``v_row`` / ``v_col`` on a factored leaf
    and ``v`` elsewhere with its ``step``, sgd's ``trace``. ``params``
    are the port's (torch) params the optimizer is built over."""
    from akka_allreduce_tpu_torch.models.optim import factored_dims
    from akka_allreduce_tpu_torch.models.train import make_optimizer
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    slots = _chain_slots(cfg)
    if not isinstance(opt_state, (list, tuple)) or len(opt_state) != len(
            slots):
        n = len(opt_state) if isinstance(opt_state, (list, tuple)) else 0
        raise ValueError(
            f"the checkpoint's optimizer chain has {n} slots; this run's "
            f"({' + '.join(slots)}) has {len(slots)}: convert with the "
            f"--optimizer, --clip-norm and --ema-decay that trained it")
    chain = dict(zip(slots, opt_state))
    counter = chain["count"]
    if not isinstance(counter, dict) or set(counter) != {"count"}:
        raise ValueError(f"slot 0 of the checkpoint's chain is not the step "
                         f"counter: {counter!r:.80}")
    if cfg.ema_decay > 0 and not (isinstance(chain["ema"], dict)
                                  and set(chain["ema"]) == {"ema"}):
        raise ValueError("the checkpoint's last chain slot is not the EMA")
    count = int(np.asarray(counter["count"]))
    leaves = tree_leaves(params)
    opt = make_optimizer(cfg, params)
    moments = _family_state(cfg, chain[cfg.optimizer])
    if moments is not None:
        trees = {k: tree_leaves(params_from_jax(moments[k]))
                 for k in moments if k != "count"}
        step = (torch.tensor(float(np.asarray(moments["count"])),
                             dtype=torch.float32)
                if "count" in moments else None)
        for i, p in enumerate(leaves):
            leaf = {k: t[i].to(p.device, p.dtype) for k, t in trees.items()}
            if cfg.optimizer == "adamw":
                state = {"step": step.clone(), "exp_avg": leaf["mu"],
                         "exp_avg_sq": leaf["nu"]}
            elif cfg.optimizer == "adafactor":
                state = {"step": step.clone().to(p.device)}
                if factored_dims(tuple(p.shape)) is None:
                    state["v"] = leaf["v"]
                else:
                    state.update(v_row=leaf["v_row"], v_col=leaf["v_col"])
            else:
                state = {k: leaf[k] for k in ("mu", "trace") if k in leaf}
            opt.state[p] = state
    return {"optimizer": opt.state_dict(), "count": count}


def _unstack_numpy(tree, n_layers: int, name: str = "", placeholders=False):
    """A pp-stacked JAX tree (``layers`` a dict of ``(L, ...)`` arrays)
    -> the list layout; other trees unchanged. ``placeholders`` keeps a
    ``(1,)`` layer leaf (adafactor's unused moment) as it is in every
    layer."""
    if not (isinstance(tree, dict) and isinstance(tree.get("layers"), dict)):
        return tree
    out = dict(tree)
    layers = {}
    for k, v in tree["layers"].items():
        a = np.asarray(v)
        if placeholders and a.shape == (1,):
            layers[k] = [a] * n_layers
        elif a.ndim == 0 or a.shape[0] != n_layers:
            raise ValueError(f"{name}layers.{k} is {a.shape}, not "
                             f"stacked over {n_layers} layers")
        else:
            layers[k] = [a[i] for i in range(n_layers)]
    out["layers"] = [{k: v[i] for k, v in layers.items()}
                     for i in range(n_layers)]
    return out


def _check_stacked_factoring(params: dict) -> None:
    """Refuse stacked adafactor moments that do not unstack: a stacked
    ``(L, ...)`` layer leaf whose two factored dims are not its
    unstacked leaf's, one dim on (the stacked dim among the two largest,
    or a leaf factored only when stacked)."""
    from akka_allreduce_tpu_torch.models.optim import factored_dims
    for k, v in params["layers"].items():
        shape = tuple(np.shape(v))
        dims, inner = factored_dims(shape), factored_dims(shape[1:])
        want = None if inner is None else (inner[0] + 1, inner[1] + 1)
        if dims != want:
            raise ValueError(
                f"the stacked adafactor moments of layers.{k} {shape} "
                f"factor dims {dims}, the unstacked leaf's {inner}: they "
                f"do not unstack into per-layer moments")


def unstack_jax_items(items: dict) -> dict:
    """A JAX training checkpoint of a pp-stacked run (``params["layers"]``
    a dict of ``(L, ...)`` arrays, the ``param_specs(pp > 1)`` layout)
    -> the same items in the list layout: params, the EMA item and slot,
    and the family slot's moments (adamw / lion ``mu``, ``nu``;
    adafactor ``v``, ``v_row``, ``v_col``, each stacked like its leaf)
    unstacked layer by layer. Items of a list-layout run come back
    unchanged."""
    params = items.get("params")
    if not (isinstance(params, dict) and isinstance(params.get("layers"),
                                                    dict)):
        return items
    n = int(np.shape(next(iter(params["layers"].values())))[0])
    out = dict(items)
    out["params"] = _unstack_numpy(params, n, "params.")
    if items.get("ema") is not None:
        out["ema"] = _unstack_numpy(items["ema"], n, "ema.")
    chain = []
    for slot in items.get("opt_state") or []:
        if isinstance(slot, list) and slot and isinstance(slot[0], dict):
            first = dict(slot[0])
            if "v_row" in first:
                _check_stacked_factoring(params)
            for k, tree in first.items():
                if k != "count":
                    first[k] = _unstack_numpy(tree, n, f"{k}.",
                                              placeholders=True)
            slot = [first] + list(slot[1:])
        elif isinstance(slot, dict) and set(slot) == {"ema"}:
            slot = {"ema": _unstack_numpy(slot["ema"], n, "ema.")}
        chain.append(slot)
    out["opt_state"] = chain
    return out


# the JAX ``_ef_state_axes`` order: the axes a run's ef8 planes stack over
JAX_PLANE_AXES = ("dp", "sp", "ep", "tp", "pp")


def jax_plane_index(group) -> int:
    """The index, in a JAX run's stacked ef8 residual, of the plane of
    the port rank ``group.rank`` on ``group``'s mesh: JAX stacks the
    planes row-major over ``(dp, sp, ep, tp, pp)`` (``_ef_state_axes``),
    the port numbers its ranks row-major over ``(pp, dp, ep, sp, tp)``
    (``parallel/group.py``)."""
    index = 0
    for axis in JAX_PLANE_AXES:
        index = index * group.axis_size(axis) + group.axis_index(axis)
    return index


def _rank_bucket_counts(params: dict, cfg, group) -> dict:
    """Bucket counts of the rank's dense and expert gradient trees (its
    shard of the full list-layout ``params``, a pp stage's layers
    stacked; shapes only): the rows of its ef8 planes."""
    from akka_allreduce_tpu_torch.models.train import (_has_experts,
                                                       dense_bucket_count,
                                                       expert_bucket_count)
    from akka_allreduce_tpu_torch.ops.bucketing import tree_map
    meta = tree_map(lambda p: torch.empty(p.shape, device="meta"), params)
    shard = _shard(meta, len(meta["layers"]), group)
    counts = {"dense": dense_bucket_count(cfg, shard)}
    if _has_experts(shard):
        counts["expert"] = expert_bucket_count(cfg, shard)
    return counts


MESH_FLAGS = "--dp --sp --ep --tp --pp"


def sync_planes_from_jax(residual, params: dict, cfg, mesh: dict,
                         device="cpu") -> list:
    """A JAX run's ef8 ``sync`` residual -> each port rank's, in the
    port's rank order on the mesh ``mesh`` (``{"dp", "sp", "ep", "tp",
    "pp"}`` sizes, 1 where absent): rank r takes the JAX plane
    :func:`jax_plane_index` names. ``residual`` is one ``(ranks,
    num_buckets, bucket_elems)`` array, or an MoE run's ``{"dense",
    "expert"}`` of two; each plane must have the row count of that
    rank's shard or stage at ``cfg.bucket_elems`` (the JAX
    ``dense_bucket_count`` / ``expert_bucket_count`` at that mesh).
    Raises ``ValueError`` naming the mesh flags when the planes do not
    fit the mesh."""
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    bucket_elems = cfg.bucket_elems
    sizes = {a: int(mesh.get(a, 1)) for a in JAX_PLANE_AXES}
    world = int(np.prod(list(sizes.values())))
    named = " ".join(f"--{a} {n}" for a, n in sizes.items())
    stacks = ({k: np.asarray(v, dtype=np.float32)
               for k, v in residual.items()}
              if isinstance(residual, dict)
              else {"dense": np.asarray(residual, dtype=np.float32)})
    out = []
    for rank in range(world):
        group = RankGroup(rank, world, "gloo", torch.device("cpu"),
                          sizes["sp"], ep=sizes["ep"], tp=sizes["tp"],
                          pp=sizes["pp"])
        try:
            counts = _rank_bucket_counts(params, cfg, group)
        except ValueError as exc:
            raise ValueError(f"the model does not split over the mesh "
                             f"{named} ({MESH_FLAGS}): {exc}") from exc
        if set(counts) != set(stacks):
            raise ValueError(
                f"the ef8 residual holds the planes {sorted(stacks)}; a "
                f"{'MoE' if 'expert' in counts else 'dense'} model's are "
                f"{sorted(counts)}")
        j = jax_plane_index(group)
        planes = {}
        for k, stack in stacks.items():
            want = (counts[k], bucket_elems)
            if (stack.ndim != 3 or stack.shape[0] != world
                    or stack.shape[1:] != want):
                raise ValueError(
                    f"the ef8 residual's {k} planes are {stack.shape}; at "
                    f"{named} ({MESH_FLAGS}, the mesh of the run that "
                    f"wrote it) rank {rank}'s are ({world},) + {want} "
                    f"(--bucket-elems {bucket_elems})")
            planes[k] = torch.from_numpy(stack[j].copy()).to(device)
        out.append(planes if isinstance(residual, dict)
                   else planes["dense"])
    return out


def train_state_from_jax(items: dict, cfg, device="cpu",
                         mesh: Optional[dict] = None) -> dict:
    """A JAX training checkpoint step -> the port's checkpoint items.
    ``items`` are the orbax items as numpy trees (template-free:
    ``params``, ``opt_state``, optionally ``ema``, ``sync``, ``extra``);
    ``cfg`` the port ``TrainConfig`` of the run that resumes (its
    optimizer family, clip, EMA, sgd momentum and bucket size); ``mesh``
    the ``{"dp", "sp", "ep", "tp", "pp"}`` sizes of the run that wrote
    it (``dp`` by default the planes left by the others). Returns
    ``params`` (torch, on ``device``), ``opt_state`` (as the port's
    checkpoint keeps it: ``{"optimizer": state_dict, "count": steps}``),
    ``ema`` (the ``ema`` item, or the chain's EMA slot; None without
    ``ema_decay``), ``sync`` (each port rank's ef8 residual, its shard's
    or stage's plane of the JAX item — an MoE run's ``{"dense",
    "expert"}`` planes — in the port's rank order,
    :func:`sync_planes_from_jax`; None without one) and ``extra``. A
    pp-stacked checkpoint comes back in the list layout
    (:func:`unstack_jax_items`), which is what the port's checkpoint
    holds at any ``pp``. The residual resumes at the mesh that wrote
    it, as JAX's does. Raises ``ValueError`` naming what is missing or
    does not match."""
    items = unstack_jax_items(items)
    held = sorted(k for k, v in items.items() if v is not None)
    missing = [k for k in ("params", "opt_state") if k not in held]
    if missing:
        raise ValueError(f"the checkpoint lacks {' and '.join(missing)} "
                         f"(it holds {held}): a training checkpoint has "
                         f"params and opt_state")
    params = params_from_jax(items["params"], device)
    opt_state = optimizer_state_from_jax(cfg, params, items["opt_state"])
    ema = None
    if cfg.ema_decay > 0:
        tree = items.get("ema")
        if tree is None:
            tree = items["opt_state"][-1]["ema"]
        ema = params_from_jax(tree, device)
    sync = None
    if items.get("sync") is not None:
        residual = items["sync"]["residual"]
        mesh = dict(mesh or {})
        if "dp" not in mesh:  # the planes left by the other axes
            first = (next(iter(residual.values()))
                     if isinstance(residual, dict) else residual)
            rest = int(np.prod([mesh.get(a, 1) for a in JAX_PLANE_AXES]))
            mesh["dp"] = max(1, (int(np.shape(first)[0])
                                 if np.ndim(first) else 1) // rest)
        sync = sync_planes_from_jax(residual, params, cfg, mesh, device)
    return {"params": params, "opt_state": opt_state, "ema": ema,
            "sync": sync, "extra": dict(items.get("extra") or {})}


def buffer_state_from_numpy(buffer, device="cpu", into=None):
    """A JAX ``ScatteredDataBuffer`` or ``ReducedDataBuffer`` (numpy ring,
    read by duck typing) -> the port's buffer of the same kind and
    geometry on ``device``, holding the same state: the staged rows
    (``temporal_buffer``), ``count_filled``, ``total_filled``,
    ``temporal_offset`` and, for a reduced buffer,
    ``count_reduce_filled``. ``into`` (optional) is a port buffer of the
    same geometry to fill instead of a new one."""
    from akka_allreduce_tpu_torch.buffers import (ReducedDataBuffer,
                                                  ScatteredDataBuffer)
    reduced = hasattr(buffer, "count_reduce_filled")
    if into is None:
        if reduced:
            into = ReducedDataBuffer(
                buffer.max_block_size, 0, buffer.total_data_size,
                buffer.peer_size, buffer.max_lag,
                buffer.completion_threshold, buffer.max_chunk_size,
                device=device)
        else:
            into = ScatteredDataBuffer(
                buffer.data_size, buffer.peer_size, buffer.max_lag,
                buffer.reducing_threshold, buffer.max_chunk_size,
                device=device)
    ring = np.asarray(buffer.temporal_buffer, dtype=np.float32)
    if tuple(into.temporal_buffer.shape) != ring.shape \
            or into.max_chunk_size != buffer.max_chunk_size \
            or hasattr(into, "count_reduce_filled") != reduced:
        raise ValueError(f"buffer geometry differs: {ring.shape} chunk "
                         f"{buffer.max_chunk_size} into "
                         f"{tuple(into.temporal_buffer.shape)} chunk "
                         f"{into.max_chunk_size}")
    into.temporal_buffer.copy_(torch.from_numpy(ring))
    into.temporal_offset = int(buffer.temporal_offset)
    into.count_filled = np.array(buffer.count_filled, dtype=np.int64)
    into.total_filled = np.array(buffer.total_filled, dtype=np.int64)
    if reduced:
        into.count_reduce_filled = np.array(buffer.count_reduce_filled,
                                            dtype=np.int64)
    return into
