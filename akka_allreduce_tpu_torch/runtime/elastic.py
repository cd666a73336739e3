"""Elastic recovery: quorum tracking, the group's re-formation, resharding.

Counterpart of ``akka_allreduce_tpu/runtime/elastic.py``, the names kept.
The reference only tolerates a dead peer inside a run (deathwatch shrinks
the peer map, thresholds let rounds complete without it; reference:
AllreduceMaster.scala:46-52, AllreduceWorker.scala:141-146); this module
is the re-formation half:

* :class:`QuorumTracker`: membership and a generation counter, bitwise
  JAX's; the group may continue while ``len(alive) >= ceil(min_fraction
  * total)`` (the reference's ``thAllreduce`` at the membership level,
  AllreduceMaster.scala:58), and work of an older generation is stale
  (AllreduceWorker.scala:155).
* :func:`shrink_spec`: the new layout for the survivors. The model axes
  (tp, sp, ep, pp) hold the sharded model state and are kept; dp absorbs
  the loss, dropping incomplete replicas.
* :func:`reform_group`: JAX rebuilds a ``Mesh`` over surviving devices of
  one process. In the port every rank is a process, so the survivors
  build a new process group: a survivor's new rank is its place in the
  sorted survivor list, survivors beyond the spec's size stay idle, and
  the group meets on a prefix of the store named by the generation.
  Nothing here calls a collective on the old world, which the lost ranks
  never enter.
* :func:`reshard`: the live state onto the new group. Each new rank's
  (pp, ep, sp, tp) shard comes from the lowest-ranked survivor that held
  it, broadcast over the new group, so values stay bitwise.
* :class:`ElasticController`: ties them to member-up / member-lost
  signals (the liveness detector's deathwatch).

The port's :func:`reshard` deliberately differs from JAX's, which reads
every value from the old global array, the lost devices' buffers
included (its test reads the buffers of the "lost" devices 2-3): a lost
host cannot supply them, so here a shard that no survivor holds raises
(ROADMAP C16).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import logging
import math
from typing import Any, Callable, Optional, Sequence

import torch

log = logging.getLogger(__name__)

MODEL_AXES = ("pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The mesh's axis sizes (the JAX ``parallel/mesh.py MeshSpec``
    fields the port's ranks use)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp

    @staticmethod
    def of(group) -> "MeshSpec":
        """The spec of a ``RankGroup``'s mesh (its ``mesh_dims``)."""
        return MeshSpec(**{a: n for a, n in group.mesh_dims})


class QuorumTracker:
    """Membership and generation bookkeeping: the group may continue
    while ``len(alive) >= ceil(min_fraction * total)``."""

    def __init__(self, total: int, min_fraction: float = 0.5):
        if not 0.0 < min_fraction <= 1.0:
            raise ValueError(f"min_fraction {min_fraction} not in (0, 1]")
        self.total = total
        self.min_fraction = min_fraction
        self.alive: set = set()
        self.generation = 0

    @property
    def min_quorum(self) -> int:
        # round() before ceil: IEEE noise (0.55*100 == 55.000000000000006)
        # must not demand one more survivor than the fraction implies
        return max(1, math.ceil(round(self.min_fraction * self.total, 9)))

    def member_up(self, rank: int) -> None:
        if rank not in self.alive:
            self.alive.add(rank)
            self.generation += 1

    def member_lost(self, rank: int) -> None:
        if rank in self.alive:
            self.alive.remove(rank)
            self.generation += 1

    def quorum_ok(self) -> bool:
        return len(self.alive) >= self.min_quorum

    def is_current(self, generation: int) -> bool:
        """Work tagged with an older generation is stale: the group it
        was computed for no longer exists."""
        return generation == self.generation


def shrink_spec(spec: MeshSpec, n_ranks: int) -> MeshSpec:
    """The largest layout fitting ``n_ranks`` that keeps the model axes
    (tp / sp / ep / pp) and shrinks dp, dropping incomplete replicas.
    Raises when not one model replica (tp*sp*ep*pp ranks) survives."""
    model_ranks = spec.tp * spec.sp * spec.ep * spec.pp
    new_dp = n_ranks // model_ranks
    if new_dp < 1:
        raise RuntimeError(
            f"unrecoverable: {n_ranks} surviving devices cannot hold one "
            f"model replica of tp*sp*ep*pp = {model_ranks}; restore from "
            f"checkpoint on a fresh slice")
    return dataclasses.replace(spec, dp=new_dp)


@dataclasses.dataclass(frozen=True)
class Reformation:
    """A re-formation's plan: the new ``spec``; the survivors' old global
    ranks, the new group's members first in new-rank order (the first
    ``spec.size``) and the idle survivors after them; the membership
    ``generation``; and, for each member, the model coordinates (pp, ep,
    sp, tp) of the shard it holds (None: it holds none, as a rank that
    rejoined)."""

    spec: MeshSpec
    ranks: tuple
    generation: int
    held: tuple

    def new_rank(self, old_rank: int) -> Optional[int]:
        """The new rank of the survivor ``old_rank``, None when idle."""
        i = self.ranks.index(old_rank)
        return i if i < self.spec.size else None


def plan(spec: MeshSpec, survivors: Sequence[int], generation: int,
         held: Optional[dict] = None) -> Reformation:
    """The :class:`Reformation` of ``spec`` shrunk to the ``survivors``
    (old global ranks). ``held`` maps a survivor to the model coordinates
    of the shard it holds (by default its coordinates on ``spec``; a
    survivor missing from it holds none). The members are chosen by
    model coordinate: for each coordinate of the new mesh the
    lowest-ranked survivor holding its shard, then the lowest-ranked
    others up to the spec's size, so a survivor holding the only copy of
    a shard is never left idle. A member's new rank is its place among
    the members sorted; when the first ``spec.size`` sorted survivors
    hold every shard, they are the members."""
    new_spec = shrink_spec(spec, len(survivors))
    if held is None:
        held = {r: _model_coords(spec, r) for r in survivors}
    ranks = sorted(survivors)
    members = set()
    for coords in _all_coords(new_spec):
        members.update([r for r in ranks if held.get(r) == coords][:1])
    members.update([r for r in ranks if r not in members]
                   [:new_spec.size - len(members)])
    order = sorted(members) + [r for r in ranks if r not in members]
    return Reformation(new_spec, tuple(order), generation,
                       tuple(held.get(r) for r in sorted(members)))


def _drop_old_group(old_group) -> None:
    """This process's old subgroups, peer buffers and process group,
    freed without a collective (the lost ranks never enter one): the
    transport's calls are waited for, each mapped peer buffer closed and
    this rank's own freed, then the process groups destroyed."""
    import torch.distributed as dist

    from akka_allreduce_tpu_torch.parallel import group as G
    if old_group is not None and old_group.backend == "ipc":
        G._transport().close()
    for key in list(G._PEER_BUFFERS):
        bufs = G._PEER_BUFFERS.pop(key)
        for ptr in bufs.peers.values():
            G._ipc_call("peer_close", ctypes.c_void_p(ptr))
        G._ipc_call("peer_free", ctypes.c_void_p(bufs.local))
    G.free_axis_subgroups()
    if dist.is_initialized():
        dist.destroy_process_group()


def reform_group(reform: Reformation, old_rank: int, store,
                 backend: str, device: "torch.device | str",
                 old_group=None):
    """Re-form this survivor's process group (the counterpart of JAX
    ``reform_mesh``): free the old one (:func:`_drop_old_group`: no
    collective on the old world), then join the new world of
    ``reform.spec.size`` ranks on ``store`` under the prefix
    ``elastic/<generation>`` at rank ``reform.new_rank(old_rank)``, and
    make its axis subgroups. Returns the new ``RankGroup``, or None for
    a survivor left idle (beyond the spec's size). ``store`` is a
    ``torch.distributed`` store every survivor reaches (the
    coordinator's TCPStore, or a FileStore); ``backend`` the ranks'
    (``ipc`` opens its peer buffers anew on first use)."""
    import torch.distributed as dist

    from akka_allreduce_tpu_torch.parallel import group as G
    _drop_old_group(old_group)
    new = reform.new_rank(old_rank)
    if new is None:
        log.info("elastic: rank %d idle in generation %d", old_rank,
                 reform.generation)
        return None
    spec = reform.spec
    dist.init_process_group(
        "gloo" if backend == "ipc" else backend,
        store=dist.PrefixStore(f"elastic/{reform.generation}", store),
        rank=new, world_size=spec.size)
    group = G.RankGroup(new, spec.size, backend, torch.device(device),
                        spec.sp, ep=spec.ep, tp=spec.tp, pp=spec.pp)
    G.make_axis_subgroups(group)
    return group


def _model_coords(spec: MeshSpec, rank: int) -> tuple:
    """(pp, ep, sp, tp) of ``rank`` on ``spec``'s mesh (the port's
    ``(pp, dp, ep, sp, tp)`` row-major layout)."""
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    g = RankGroup(rank, spec.size, "gloo", torch.device("cpu"), spec.sp,
                  ep=spec.ep, tp=spec.tp, pp=spec.pp)
    return tuple(g.axis_index(a) for a in MODEL_AXES)


def _all_coords(spec: MeshSpec) -> list:
    """Every model coordinate (pp, ep, sp, tp) of ``spec``'s mesh, in
    order."""
    return list(itertools.product(*(range(getattr(spec, a))
                                     for a in MODEL_AXES)))


def _state_tensors(state) -> list:
    """The tensors a shard of ``state`` holds, in one order on every
    rank: the parameters, their optimizer state (per parameter, its
    tensors by name) and the EMA."""
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    params = tree_leaves(state.params)
    out = list(params)
    opt = state.optimizer.state
    for p in params:
        per = opt.get(p, {})
        out += [per[k] for k in sorted(per) if isinstance(per[k],
                                                          torch.Tensor)]
    if state.ema is not None:
        out += tree_leaves(state.ema)
    return out


@torch.no_grad()
def reshard(state, reform: Reformation, group) -> None:
    """Move the live training ``state`` (a ``models/train.py``
    ``TrainState``) onto the re-formed ``group``, in place (the
    counterpart of JAX ``reshard`` / ``place_tree``): for every model
    coordinate (pp, ep, sp, tp) of the new mesh, the shard of the
    lowest-ranked member of the new group that held it
    (``reform.held``) is broadcast over the group (parameters, optimizer
    state, EMA; values bitwise), and each rank keeps the one of its own
    coordinates. A collective over ``group``; ``reform`` is its
    :func:`reform_group` plan.

    Raises JAX's "restore from checkpoint" error when no member of the
    new group held a shard (the JAX reshard would read it from a lost
    device: ROADMAP C16). The ef8 residual is zeroed: its plane holds
    this rank's rounding errors on its old dp line, and dp changed."""
    spec = reform.spec
    if MeshSpec.of(group) != spec:
        raise ValueError(f"group mesh {MeshSpec.of(group)} is not the "
                         f"plan's {spec}")
    holder: dict = {}  # model coords -> new rank of the lowest holder
    for new, coords in enumerate(reform.held):
        if coords is not None:
            holder.setdefault(coords, new)
    wanted = _all_coords(spec)
    lost = [c for c in wanted if c not in holder]
    if lost:  # before any collective: every rank raises alike
        raise RuntimeError(
            f"unrecoverable: no surviving rank holds the shard at (pp, "
            f"ep, sp, tp) = {lost[0]}; restore from checkpoint on a fresh "
            f"slice")
    mine = _model_coords(spec, group.rank)
    tensors = _state_tensors(state)
    # one byte buffer of the shard (every coordinate's shard has the
    # shapes of this rank's: the splits are even)
    flat = [t.reshape(-1).view(torch.uint8) if t.dim() else
            t.reshape(1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    # what this rank held, taken before any shard lands here: it may be
    # the source of a later coordinate's
    held_bytes = torch.cat(flat)
    got = None
    for coords in wanted:
        src = holder[coords]
        buf = group.broadcast(held_bytes if group.rank == src
                              else torch.empty_like(held_bytes), src)
        if coords == mine:
            got = buf
    for t, part in zip(tensors, torch.split(got, sizes)):
        # a copy: a dtype view needs an aligned start
        t.copy_(part.clone().view(t.dtype).reshape(t.shape))
    if state.residual is not None:
        from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
        for r in tree_leaves(state.residual):
            r.zero_()


class ElasticController:
    """Drives recovery from membership churn. Host r owns the ranks
    ``[r * ranks_per_host, (r + 1) * ranks_per_host)``. After every
    re-formation ``self.group`` is its :class:`Reformation` (the plan
    stands for JAX's mesh) and ``on_reform(group, generation)`` fires:
    in a rank process the callback joins the new group
    (:func:`reform_group`) and reshards its state (:func:`reshard`). The
    controller then counts each member as holding the shard of its new
    coordinates and a rejoining rank as holding none. While the quorum
    is lost the controller parks (``parked``; ``group`` None) and the
    caller idles or restores a checkpoint."""

    def __init__(self, spec: MeshSpec, total_hosts: int,
                 ranks_per_host: int, min_fraction: float = 0.5,
                 on_reform: Optional[Callable[[Reformation, int],
                                              None]] = None):
        self.spec = spec
        self.ranks_per_host = ranks_per_host
        self.tracker = QuorumTracker(total_hosts, min_fraction)
        self.on_reform = on_reform
        self.group: Optional[Reformation] = None
        self.parked = False
        self._held: Optional[dict] = None  # rank -> model coords held

    def surviving_ranks(self) -> list:
        """The ranks of the alive hosts, in rank order."""
        rph = self.ranks_per_host
        return [r for host in sorted(self.tracker.alive)
                for r in range(host * rph, (host + 1) * rph)]

    def handle_member_up(self, host: int) -> Optional[Reformation]:
        self.tracker.member_up(host)
        return self._reform()

    def handle_member_lost(self, host: int) -> Optional[Reformation]:
        self.tracker.member_lost(host)
        return self._reform()

    def _reform(self) -> Optional[Reformation]:
        if not self.tracker.quorum_ok():
            log.warning("elastic: quorum lost (%d/%d alive < %d), parked",
                        len(self.tracker.alive), self.tracker.total,
                        self.tracker.min_quorum)
            self.parked = True
            self.group = None
            return None
        self.group = plan(self.spec, self.surviving_ranks(),
                          self.tracker.generation, self._held)
        spec = self.group.spec
        self._held = {old: _model_coords(spec, new) for new, old in
                      enumerate(self.group.ranks[:spec.size])}
        self.parked = False
        log.info("elastic: generation %d, mesh %s over %d ranks",
                 self.tracker.generation, spec, spec.size)
        if self.on_reform is not None:
            self.on_reform(self.group, self.tracker.generation)
        return self.group
