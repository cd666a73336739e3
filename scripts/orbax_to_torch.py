#!/usr/bin/env python
"""Convert a training checkpoint of the JAX package (orbax) into the
port's checkpoint format.

Runs where JAX and orbax are installed: it reads one step of a JAX
``train --ckpt-dir`` directory template-free with orbax (every item:
``params``, ``opt_state``, ``ema``, ``sync``, ``extra``), maps it with
``akka_allreduce_tpu_torch/convert.py train_state_from_jax`` and writes
``OUT_DIR/<step>/`` as the port's ``runtime/checkpoint.py`` writes it
(``params.pt``, ``opt_state.pt``, ``ema.pt``, ``extra.json`` and one
``sync-<rank>.pt`` a rank of the ef8 residual), which the port's ``train
--ckpt-dir OUT_DIR`` resumes from as it resumes from its own::

    python scripts/orbax_to_torch.py JAX_DIR OUT_DIR [--step S] \\
        [--optimizer adamw|lion|adafactor|sgd] [--ema-decay D] \\
        [--clip-norm C] [--sgd-momentum M] [--bucket-elems N] \\
        [--dp N --sp S --ep E --tp P --pp Q]

The flags are the train command's that shape the optimizer chain and the
ef8 residual: give those of the run that wrote the checkpoint (the
chain's slots are matched in order and checked against them). The mesh
flags name its mesh: the JAX run stacks one ef8 plane a rank over
``(dp, sp, ep, tp, pp)``, each of its rank's shard or stage (an MoE
run's dense and expert planes both), and ``sync-<r>.pt`` is the plane of
the port's rank r on the same mesh, which the port resumes at that mesh
(the others default to 1, ``--dp`` to the planes they leave). The model's
shapes come from the params.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _restore_args(item_dir: str, sharding) -> object:
    """The restore arguments of one orbax item: its tree, rebuilt from the
    item's ``_METADATA`` key paths (a sequence key makes a list, a dict
    key a dict, an empty state None), every array restored whole onto
    ``sharding``. The saved arrays' own shardings name the devices of
    the run that wrote them, which this host may not have."""
    import orbax.checkpoint as ocp
    with open(os.path.join(item_dir, "_METADATA")) as f:
        entries = json.load(f)["tree_metadata"].values()
    root: dict = {}
    for entry in entries:
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = (
            None if entry["value_metadata"]["value_type"] == "None"
            else ocp.ArrayRestoreArgs(sharding=sharding))

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(kind == _SEQUENCE_KEY for _, kind in node):
            return [build(node[k]) for k in sorted(node,
                                                   key=lambda k: int(k[0]))]
        return {key: build(v) for (key, _), v in node.items()}
    return build(root)


# orbax's key type of a sequence index in an item's _METADATA
_SEQUENCE_KEY = 1


def read_orbax_step(directory: str, step=None) -> "tuple[int, dict]":
    """``(step, items)``: every item of one checkpoint step (the latest
    by default), restored template-free (namedtuples as dicts, tuples as
    lists, empty states as None) on this host's first device, its arrays
    as numpy."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    directory = os.path.abspath(directory)
    mgr = ocp.CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(step))
    names = sorted(n for n in os.listdir(path) if not n.startswith("_"))
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    restored = mgr.restore(step, args=ocp.args.Composite(**{
        n: ocp.args.JsonRestore() if n == "extra"
        else ocp.args.PyTreeRestore(restore_args=_restore_args(
            os.path.join(path, n), one)) for n in names}))
    items = {n: restored[n] if n == "extra"
             else jax.tree.map(np.asarray, restored[n]) for n in names}
    return int(step), items


def port_config(optimizer="adamw", ema_decay=0.0, clip_norm=0.0,
                sgd_momentum=0.9, bucket_elems=1 << 16):
    """The port ``TrainConfig`` fields that shape the chain and the
    residual (the model comes from the params)."""
    from akka_allreduce_tpu_torch.models.train import TrainConfig
    return TrainConfig(model=None, optimizer=optimizer, ema_decay=ema_decay,
                       clip_norm=clip_norm, sgd_momentum=sgd_momentum,
                       bucket_elems=bucket_elems)


def convert(jax_dir: str, out_dir: str, cfg, step=None,
            mesh: "dict | None" = None) -> str:
    """Convert step ``step`` (the latest by default) of ``jax_dir`` into
    ``out_dir``; ``mesh`` is the ``{"dp", "sp", "ep", "tp", "pp"}`` sizes
    of the run that wrote it (``dp`` by default the planes left by the
    other axes). Returns the written step directory."""
    import torch

    from akka_allreduce_tpu_torch.convert import train_state_from_jax
    from akka_allreduce_tpu_torch.runtime.checkpoint import (
        CheckpointConfig, CheckpointManager)
    step, items = read_orbax_step(jax_dir, step)
    got = train_state_from_jax(items, cfg, mesh=mesh)
    mgr = CheckpointManager(CheckpointConfig(out_dir))
    mgr.save(step, got["params"], got["opt_state"], got["extra"],
             force=True, ema=got["ema"])
    path = os.path.join(out_dir, str(step))
    for rank, plane in enumerate(got["sync"] or []):
        torch.save(plane, os.path.join(path, f"sync-{rank}.pt"))
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("jax_dir", help="the JAX run's --ckpt-dir")
    p.add_argument("out_dir", help="the port run's --ckpt-dir")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: the latest)")
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor", "sgd", "lion"))
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--sgd-momentum", type=float, default=0.9)
    p.add_argument("--bucket-elems", type=int, default=1 << 16)
    for axis in ("dp", "sp", "ep", "tp", "pp"):
        p.add_argument(f"--{axis}", type=int, default=None,
                       help=f"the {axis} size of the run that wrote the "
                            f"checkpoint")
    a = p.parse_args(argv)
    mesh = {k: getattr(a, k) for k in ("dp", "sp", "ep", "tp", "pp")
            if getattr(a, k) is not None}
    path = convert(a.jax_dir, a.out_dir, port_config(
        a.optimizer, a.ema_decay, a.clip_norm, a.sgd_momentum,
        a.bucket_elems), a.step, mesh or None)
    print(f"wrote {path}: {sorted(os.listdir(path))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
