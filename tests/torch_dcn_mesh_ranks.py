"""Rank-side code of ``tests/test_torch_dcn_mesh.py`` (imports no JAX):
one process of a two-process hybrid whose local mesh is a line of the
spawned world (the process is the rank's ``dp`` index, its local group
the ``tp``, ``ep`` or ``pp`` line through it)."""

from akka_allreduce_tpu_torch.convert import gather_tree, params_from_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.ops.bucketing import tree_map, tree_to_vector
from akka_allreduce_tpu_torch.protocol.kv import StoreKv
from akka_allreduce_tpu_torch.runtime.dcn_train import DcnDeadlineTrainer

from torch_moe_ranks import local_tokens, make_cfg


def dcn_process(group, name, axis, model, moe, kw, params_np, batches,
                address, trainer_kw):
    """Process ``group.axis_index("dp")`` of two, on its local line along
    ``axis``: three rounds of ``DcnDeadlineTrainer`` over the store at
    ``address`` (namespace ``name``), each process its half of every
    batch's rows. Returns the losses, the final whole parameters (the
    JAX global layout), their CRC, and on local rank 0 round 0's whole
    gradient tree and published buckets."""
    pid, local = group.axis_index("dp"), group.along(axis)
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=local.device, group=local)
    lead = local.rank == 0
    tr = DcnDeadlineTrainer(
        cfg, local, client=StoreKv.connect(*address) if lead else None,
        rank=pid, num_processes=2, namespace=name, **trainer_kw)
    seen = []
    wire = tr._host_wire

    def host_wire(grads):  # round 0's whole gradient tree, as published
        if not seen:
            seen.append(tree_map(lambda g: g.detach().clone(), grads))
        return wire(grads)
    tr._host_wire = host_wire
    losses = []
    try:
        for b in batches:
            half = b.shape[0] // 2
            rows = b[pid * half:(pid + 1) * half]
            losses.append(tr.run_round(state, local_tokens(local, rows)).loss)
        payload = ([tr._kv.key_value_try_get_bytes(tr._gkey(0, pid, k))
                    for k in range(tr._n_chunks)] if lead else None)
        crc = tr.param_crc(state)
    finally:
        tr.close()
    whole = gather_tree(state.params, local, unstack=False)
    return {"losses": losses, "crc": crc, "lead": lead,
            "params": tree_to_vector(whole).detach().numpy(),
            "grads0": seen[0] if seen else None, "payload": payload}


def mesh_cases(group, cases: list) -> list:
    """:func:`dcn_process` for each ``(mesh, run)`` of ``cases``, in
    order, each on a group of its mesh with its axis subgroups
    (``torch_pp_ranks.mesh_cases``)."""
    from akka_allreduce_tpu_torch.parallel import group as G
    from torch_pp_ranks import mesh_group
    out = []
    for mesh, run in cases:
        g = mesh_group(group, mesh)
        G.make_axis_subgroups(g)
        try:
            out.append(dcn_process(g, *run))
        finally:
            G.free_axis_subgroups()
    return out
