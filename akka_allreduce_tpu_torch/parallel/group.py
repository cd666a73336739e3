"""Process groups of the port's ranks: the JAX package's rank mesh.

Counterpart of ``akka_allreduce_tpu/parallel/mesh.py`` (``MeshSpec``'s
axes) and ``utils/vma.py`` ``psum_all`` for ranks that are processes. The
JAX package's rank-local collectives name mesh axes; the port's name a
:class:`RankGroup`: this rank, the world size, the backend and the sizes
of the mesh's axes.

The mesh is the JAX axis order ``("pp", "dp", "ep", "sp", "tp")``,
row-major, ``pp`` outermost and ``tp`` innermost: global rank ``r =
(((pp_h * dp + dp_i) * ep + ep_k) * sp + sp_j) * tp + tp_l`` (the JAX
``make_device_mesh`` order). With ``pp = ep = tp = 1`` this is ``r =
dp_i * sp + sp_j``, so the ``sp`` ranks of one ``dp`` row are
neighbours. :meth:`RankGroup.ppermute` moves blocks along one named axis
(the ring attention's K/V rotation along ``sp``, the pipeline's
activations and cotangents along ``pp``).

Axis lines and sub-meshes. :meth:`RankGroup.along` is the group of the
ranks on this rank's line along one axis (the JAX collective over one
mesh axis, such as ``lax.psum_scatter(..., "sp")``), and
:meth:`RankGroup.over` the sub-mesh over several axes, in the order
given (the JAX collective over an axis tuple, such as the dense
gradient sync's ``psum`` over ``("dp", "sp", "ep")``): the ranks that
share this rank's other coordinates, whose ``rank`` is this rank's index
in that order (row-major, the last axis fastest). Either is a
``RankGroup`` whose axes are the ones it spans, so every rank-local
collective of ``ops/collectives.py`` runs unchanged on it. Its
``all_to_all``, ``all_gather`` and ``barrier`` go through a
``torch.distributed`` subgroup of its ranks (a group's rank order may
differ from the subgroup's, which sorts its members: the blocks are put
in the group's order); a group of one rank is a group of one, a group
that spans the world in the world's order is the world.
``dist.new_group`` is collective over the whole world, so
:func:`make_axis_subgroups` makes the subgroup of every line and
sub-mesh on every rank, in one order, before the rank's function runs
(``spawn_ranks`` does), and :func:`free_axis_subgroups` destroys them
before the process group.

The group moves bytes and never reduces. Its collectives are the ones
that the JAX sync and ring issue besides ``psum``: ``all_to_all`` (split
and concatenate along axis 0), ``all_gather`` (tiled along axis 0), the
pairwise ``exchange`` of an involutive ``ppermute`` and the shifted
``ppermute`` of a ring. Every sum over ranks is taken on the rank's own
device by the caller (``ops/collectives.py``, through the masked-reduce
kernel), so the transport never adds floats.

Backends:

* ``nccl`` — one rank per GPU, device tensors on the wire, no staging.
  Needs as many GPUs as ranks.
* ``gloo`` — the wire is host memory: a CUDA tensor is copied to the host,
  the collective runs there, and the result is copied back to the
  tensor's device. This is how the tests run ranks on the CPU.
* ``ipc`` — ranks on CUDA devices of one host (several may share one
  card, which NCCL refuses): every payload of ``all_to_all``,
  ``all_gather``, ``exchange`` and ``ppermute`` moves device to device
  through CUDA IPC peer buffers (``ops/kernels/transport.py``), on the
  caller's stream, never through the host. The process group is gloo and
  carries the control plane only: init, the axis subgroups, ``barrier``
  and the one-time handle exchange. A CPU tensor raises. At most 32
  ranks; a rank's transport buffers take at most 1 GiB.
* a group of one (:meth:`RankGroup.single`) needs no process group: every
  collective is the identity.

Peer memory. :meth:`RankGroup.peer_buffers` gives kernels that move data
themselves (``ops/kernels/ring.py``, the ring and swing allreduce) a
symmetric buffer on every rank of a line along an axis, and
:meth:`RankGroup.transport_buffers` gives the ``ipc`` transport one per
group or line: each rank allocates its own with ``cudaMalloc``, the
64-byte CUDA IPC handles go round the line's process group on the host,
and each rank maps the buffers of the line's peers. The buffers are
cached per (kind, the line's global ranks, bytes) outside the frozen
:class:`RankGroup`, and :func:`free_peer_buffers` unmaps and frees them
(``spawn_ranks`` does so before it destroys the process group). IPC
works between processes on one card and between cards of one host.

:func:`spawn_ranks` starts ``world`` processes with the ``spawn`` start
method (a fork after CUDA is initialised breaks), joins them through a
``file://`` store in a fresh temporary directory (concurrent runs never
contend for a port), calls ``fn(group, *args)`` in each, and returns the
ranks' return values in rank order. ``fn`` must be importable by name in
the child, from a module that does not import JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import itertools
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo", "ipc")
AXES = ("pp", "dp", "ep", "sp", "tp")  # the JAX mesh order, outer first

# all_gather_into_tensor was renamed all_gather_single (same arguments)
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in a mesh of ``world`` ranks. ``backend`` is
    ``"nccl"``, ``"gloo"``, ``"ipc"`` or ``"none"`` (a group of one, no
    process group behind it); ``device`` is where this rank's tensors
    live.

    The whole mesh has the axes ``("pp", "dp", "ep", "sp", "tp")`` of
    sizes ``(pp, world / (pp ep sp tp), ep, sp, tp)``. A line or sub-mesh
    (:meth:`along`, :meth:`over`) has ``dims``, its own axes and sizes
    in its rank order, and ``line``, the global ranks of its indices."""

    rank: int
    world: int
    backend: str
    device: torch.device
    sp: int = 1
    # the global ranks of a line or sub-mesh, in its rank order; None for
    # the whole world
    line: Optional[tuple] = None
    ep: int = 1
    tp: int = 1
    # ((axis, size), ...) of a line or sub-mesh, in its rank order; None
    # for the whole mesh
    dims: Optional[tuple] = None
    pp: int = 1

    def __post_init__(self):
        if self.dims is None:
            inner = self.pp * self.ep * self.sp * self.tp
            if min(self.pp, self.ep, self.sp, self.tp) < 1 \
                    or self.world % inner:
                raise ValueError(
                    f"pp x ep x sp x tp = {self.pp} x {self.ep} x "
                    f"{self.sp} x {self.tp} must divide the world of "
                    f"{self.world} ranks")

    @staticmethod
    def single(device: "torch.device | str" = "cpu") -> "RankGroup":
        return RankGroup(0, 1, "none", torch.device(device))

    @property
    def mesh_dims(self) -> tuple:
        """``((axis, size), ...)`` of this group's axes in its rank order
        (row-major: the last axis varies fastest)."""
        if self.dims is not None:
            return self.dims
        dp = self.world // (self.pp * self.ep * self.sp * self.tp)
        return (("pp", self.pp), ("dp", dp), ("ep", self.ep),
                ("sp", self.sp), ("tp", self.tp))

    @property
    def axis_order(self) -> tuple:
        """This group's axes in its rank order, outer first."""
        return tuple(a for a, _ in self.mesh_dims)

    def along(self, axis: str) -> "RankGroup":
        """The ranks on this rank's line along ``axis``, as a group of
        ``axis_size(axis)`` ranks with ``rank`` = ``axis_index(axis)``
        (a JAX collective over that one mesh axis)."""
        return self.over((axis,))

    def over(self, axes) -> "RankGroup":
        """The sub-mesh over ``axes`` through this rank: the ranks whose
        coordinates on every other axis are this rank's, as a group whose
        rank order is row-major in ``axes`` as given (a JAX collective
        over the axis tuple ``axes``; ``over(("dp", "sp", "ep"))`` orders
        its ranks dp-major, then sp, then ep). A sub-mesh of one rank is
        a group of one."""
        axes = tuple(axes)
        for a in axes:
            self._check_axis(a)
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated mesh axis in {axes}")
        sizes = [self.axis_size(a) for a in axes]
        n = int(np.prod(sizes)) if sizes else 1
        if n == 1:
            return RankGroup.single(self.device)
        coords = self._coords(self.rank)
        members, me = [], 0
        for index in range(n):
            sub, rest = {}, index
            for a, size in zip(reversed(axes), reversed(sizes)):
                sub[a] = rest % size
                rest //= size
            members.append(self._global(self._index({**coords, **sub})))
            if all(sub[a] == coords.get(a, 0) for a in axes):
                me = index
        line = tuple(members)
        if self.line is None and line == tuple(range(self.world)):
            line = None  # the world, in the world's order
        return RankGroup(me, n, self.backend, self.device, line=line,
                         dims=tuple((a, s) for a, s in zip(axes, sizes)))

    def _global(self, index: int) -> int:
        """The global rank of this group's rank ``index``."""
        return index if self.line is None else self.line[index]

    def _pg(self):
        """The process group of this group's collectives: the default
        (world) group, or the subgroup of its members."""
        if self.line is None:
            return None
        return _line_pg(self.line)

    def _pg_order(self) -> Optional[list]:
        """Where each of the process group's ranks (sorted global ranks)
        sits in this group's order, or None when the orders agree."""
        if self.line is None:
            return None
        members = sorted(self.line)
        if list(self.line) == members:
            return None
        return [self.line.index(g) for g in members]

    # -- mesh coordinates ----------------------------------------------------

    def _check_axis(self, axis: str) -> None:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}: {AXES}")

    def _coords(self, index: int) -> dict:
        """The coordinates of this group's rank ``index`` on its axes."""
        out = {}
        for a, size in reversed(self.mesh_dims):
            out[a] = index % size
            index //= size
        return out

    def _index(self, coords: dict) -> int:
        """This group's rank at ``coords`` (one per axis of the group)."""
        index = 0
        for a, size in self.mesh_dims:
            index = index * size + coords[a]
        return index

    def axis_size(self, axis: str) -> int:
        """``lax.axis_size``: the ranks along ``axis`` (1 for an axis the
        group does not span)."""
        self._check_axis(axis)
        return dict(self.mesh_dims).get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """``lax.axis_index``: this rank's coordinate along ``axis``."""
        self._check_axis(axis)
        return self._coords(self.rank).get(axis, 0)

    def _shifted(self, axis: str, shift: int) -> int:
        """This group's rank ``shift`` steps along ``axis`` (wrapping),
        the other coordinates kept."""
        coords = self._coords(self.rank)
        if axis in coords:
            coords[axis] = (coords[axis] + shift) % self.axis_size(axis)
        return self._index(coords)

    def axis_rank(self, axis: str, index: int) -> int:
        """The group's rank at coordinate ``index`` along ``axis``, the
        other coordinates kept."""
        return self._shifted(axis, index - self.axis_index(axis))

    def _ranks(self, axis: Optional[str] = None) -> tuple:
        """The global ranks of this group (``axis`` None) or of this
        rank's line along ``axis``, in line order."""
        if axis is None:
            return self.line or tuple(range(self.world))
        return tuple(self._global(self.axis_rank(axis, q))
                     for q in range(self.axis_size(axis)))

    # -- staging -----------------------------------------------------------

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the transport takes: a contiguous host copy for
        gloo, the tensor itself (made contiguous) for nccl. A CUDA graph
        capture raises: the host-staged wire cannot be captured."""
        if (x.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"a CUDA graph cannot capture the {self.backend} wire (it "
                f"stages payloads through the host): capture multi-rank "
                f"steps with --dist-backend ipc")
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            return x.cpu()
        return x

    def _unstage(self, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return out if out.device == like.device else out.to(like.device)

    # -- collectives (each rank calls each, in the same order) -------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (world, ...): block p goes to rank p; returns (world, ...)
        whose block p is rank p's block for this rank (``lax.all_to_all``
        with split and concat axis 0)."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.world} blocks, got {tuple(x.shape)}")
        if self.world == 1:
            return x
        if self.backend == "ipc":
            return _transport().all_to_all(self, x)
        src = self._stage(x)
        order = self._pg_order()
        if order is not None:  # the subgroup's block p is ours order[p]
            src = src[order].contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._pg())
        if order is not None:
            out = out[_inverse(order)]
        return self._unstage(out, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along axis 0, in rank order
        (``lax.all_gather`` tiled on axis 0)."""
        if self.world == 1:
            return x
        if self.backend == "ipc":
            return _transport().all_gather(self, x)
        src = self._stage(x)
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _all_gather_flat(out, src, group=self._pg())
        order = self._pg_order()
        if order is not None:  # the subgroup's block p is ours order[p]
            out = out.reshape((self.world, -1) + tuple(src.shape[1:]))[
                _inverse(order)].reshape(out.shape)
        return self._unstage(out, x)

    def exchange(self, x: torch.Tensor, peer: int) -> torch.Tensor:
        """Send ``x`` to ``peer`` and return what ``peer`` sent here: one
        pair of a ``lax.ppermute`` whose permutation is an involution."""
        if peer == self.rank:
            return x
        if self.backend == "ipc":
            return _transport().exchange(self, x, peer)
        src = self._stage(x)
        out = torch.empty_like(src)
        peer = self._global(peer)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                        dist.P2POp(dist.irecv, out, peer)])
        for w in works:
            w.wait()
        return self._unstage(out, x)

    def ppermute(self, x: torch.Tensor, axis: str, shift: int
                 ) -> torch.Tensor:
        """Send ``x`` ``shift`` steps along ``axis`` and return what the
        rank ``-shift`` steps away sent here: ``lax.ppermute`` with the
        permutation ``i -> (i + shift) mod n`` of that axis. One
        ``batch_isend_irecv`` between global ranks, staged like
        :meth:`exchange` (on ``ipc``: through the line's peer buffers);
        the payload travels as bytes."""
        if shift % self.axis_size(axis) == 0:
            return x
        if self.backend == "ipc":
            return _transport().ppermute(self, x, axis, shift)
        src = self._stage(x)
        out = torch.empty_like(src)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src.reshape(-1).view(torch.uint8),
                       self._global(self._shifted(axis, shift))),
            dist.P2POp(dist.irecv, out.reshape(-1).view(torch.uint8),
                       self._global(self._shifted(axis, -shift)))])
        for w in works:
            w.wait()
        return self._unstage(out, x)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self._pg())

    def replay_boundary(self, captured) -> float:
        """Before a replay of a CUDA graph that captured ``ipc`` transport
        calls (``transport.capture``'s record): drain this rank's device,
        meet every rank, write this rank's counters of every buffer the
        chunk used back to their values at the capture
        (``transport.rewind``: the world's buffer and each axis line's),
        and meet again; the replay's captured targets then hold. A
        collective over the world. Returns its milliseconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.barrier()
        _transport().rewind(captured)
        self.barrier()
        return (time.perf_counter() - t0) * 1e3

    # -- peer memory -------------------------------------------------------

    def peer_buffers(self, axis: str, nbytes: int) -> "PeerBuffers":
        """This rank's symmetric peer buffer of ``nbytes``, with the
        buffers of its n - 1 peers on its line along ``axis`` mapped into
        this process. A collective over the line: its ranks make the same
        calls in the same order. The first call for a key allocates and
        exchanges the handles; later calls return the cached buffers."""
        return _peer_buffers(self, self._ranks(axis), nbytes, "ring")

    def transport_buffers(self, axis: Optional[str], chunk: int
                          ) -> "PeerBuffers":
        """The ``ipc`` transport's fixed buffer of this group (``axis``
        None) or of this rank's line along ``axis``, of
        ``transport.buffer_bytes`` with halves of ``chunk`` bytes, made on
        first use like :meth:`peer_buffers`. Raises when it would take
        this rank's transport buffers past ``transport.BUFFER_CAP_BYTES``
        (:func:`transport_sizes` gives the chunk that keeps them under
        it)."""
        transport = _transport()
        line = self._ranks(axis)
        nbytes = transport.buffer_bytes(len(line), chunk)
        if ("transport", line, nbytes) not in _PEER_BUFFERS:
            held = sum(b.nbytes for b in peer_buffer_list("transport"))
            if held + nbytes > transport.BUFFER_CAP_BYTES:
                raise RuntimeError(
                    f"ipc transport buffers of {held + nbytes} bytes on "
                    f"rank {self._global(self.rank)} would pass the cap of "
                    f"{transport.BUFFER_CAP_BYTES} bytes a rank")
        return _peer_buffers(self, line, nbytes, "transport")


# -- symmetric peer memory (CUDA IPC) ---------------------------------------

@dataclasses.dataclass
class PeerBuffers:
    """One rank's share of a symmetric peer-memory allocation over the
    ranks ``line`` (global ranks, in line order; ``rank`` is this one):
    ``local`` is this rank's own buffer of ``nbytes`` (a device pointer
    from ``cudaMalloc``; an IPC handle names an allocation's base, so
    PyTorch's caching allocator, which hands out pieces of shared
    segments, cannot be used), ``peers`` maps each peer's global rank to
    this process's mapping of that peer's buffer. ``calls`` counts the
    calls made on the buffers so far (every rank advances it alike), and
    ``done`` is the CUDA event recorded after the last one, which the
    next call waits on. ``abandoned`` is set once a wait gave up a call
    on them."""

    local: int
    peers: dict
    nbytes: int
    line: tuple = ()
    rank: int = 0
    calls: int = 0
    done: Optional[torch.cuda.Event] = None
    abandoned: bool = False

    def view(self, rank: Optional[int] = None) -> torch.Tensor:
        """The buffer of ``rank`` (this rank's own when None) as a uint8
        CUDA tensor that aliases it."""
        ptr = self.local if rank is None else self.peers[rank]
        return torch.as_tensor(_DeviceMemory(ptr, self.nbytes))


class _DeviceMemory:
    """Device memory that PyTorch can alias (``__cuda_array_interface__``)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


# (kind, the line's global ranks, nbytes) -> PeerBuffers, for this
# process; kind "ring" (ops/kernels/ring.py) or "transport"
_PEER_BUFFERS: dict = {}
# the global ranks of an axis line -> its process subgroup, for the lines
# this process is on
_SUBGROUPS: dict = {}


def _transport():
    from akka_allreduce_tpu_torch.ops.kernels import transport
    return transport


def _inverse(order: list) -> list:
    """The inverse permutation of ``order``."""
    inv = [0] * len(order)
    for p, i in enumerate(order):
        inv[i] = p
    return inv


def axis_lines(world: int, sp: int, ep: int = 1, tp: int = 1,
               pp: int = 1) -> list:
    """The member sets (sorted global ranks) of every line and sub-mesh
    of the mesh ``(pp, world / (pp ep sp tp), ep, sp, tp)`` that needs a
    subgroup (more than one rank, fewer than the world): for each
    nonempty proper subset of the axes of size > 1, every sub-mesh over
    it. Single axes first, inner axis first (with ``dp`` and ``sp``
    alone: the ``sp`` lines, one per ``dp`` row, then the ``dp`` lines,
    one per ``sp`` column), then the subsets of two axes and more."""
    mesh = RankGroup(0, world, "gloo", torch.device("cpu"), sp, ep=ep,
                     tp=tp, pp=pp)
    live = [a for a, size in mesh.mesh_dims if size > 1][::-1]
    subsets = []
    for k in range(1, len(live)):
        subsets += [list(c) for c in itertools.combinations(live, k)]
    out: dict = {}
    for axes in subsets:
        for r in range(world):
            group = dataclasses.replace(mesh, rank=r).over(axes)
            out.setdefault(tuple(sorted(group._ranks())), None)
    return list(out)


def make_axis_subgroups(group: RankGroup) -> None:
    """Make the subgroup of every axis line and sub-mesh on this rank. A
    collective: ``dist.new_group`` must be called by every rank of the
    world for every member set, in the same order, members or not."""
    for line in axis_lines(group.world, group.sp, group.ep, group.tp,
                           group.pp):
        pg = dist.new_group(list(line))
        if group.rank in line:
            _SUBGROUPS[line] = pg


def free_axis_subgroups() -> None:
    """Destroy this process's line subgroups (before the world's)."""
    while _SUBGROUPS:
        dist.destroy_process_group(_SUBGROUPS.popitem()[1])


def transport_sizes() -> list:
    """The sizes of the groups this rank may hold an ``ipc`` transport
    buffer for: the world, and each axis line it is on. Every rank of a
    mesh gets the same list, so ``transport.chunk_bytes`` of it gives all
    ranks one chunk."""
    return [dist.get_world_size()] + [len(line) for line in _SUBGROUPS]

_IPC: dict = {}


def _ipc():
    """The peer-memory functions of ``csrc/transport.cu``."""
    if not _IPC:
        from akka_allreduce_tpu_torch.ops.kernels import build
        lib = build.load("transport")
        ptr, pptr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        for name, args in (("peer_alloc", [ctypes.c_int64, pptr]),
                           ("peer_get_handle", [ptr, ptr]),
                           ("peer_open_handle", [ptr, pptr]),
                           ("peer_close", [ptr]), ("peer_free", [ptr]),
                           ("peer_ipc_handle_bytes", [])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _IPC[name] = fn
        err = lib.transport_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _IPC["error"] = err
    return _IPC


def _ipc_call(name: str, *args) -> None:
    fns = _ipc()
    rc = fns[name](*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {fns['error'](rc).decode()} "
                           f"({rc})")


def _line_pg(line: tuple):
    """The process group of the ranks ``line`` (in any order): the
    default (world) group when it spans the world, else the subgroup of
    its members, whose ranks are the members sorted."""
    if len(line) == dist.get_world_size():
        return None
    pg = _SUBGROUPS.get(tuple(sorted(line)))
    if pg is None:
        raise RuntimeError(
            f"no process subgroup for ranks {line}: make_axis_subgroups "
            f"must run on every rank first")
    return pg


def _peer_buffers(group: RankGroup, line: tuple, nbytes: int, kind: str
                  ) -> PeerBuffers:
    if group.device.type != "cuda":
        raise ValueError(f"peer buffers live on a CUDA device, not "
                         f"{group.device}")
    key = (kind, line, nbytes)
    bufs = _PEER_BUFFERS.get(key)
    if bufs is None:
        bufs = _open_peer_buffers(group, line, nbytes)
        _PEER_BUFFERS[key] = bufs
    return bufs


def _open_peer_buffers(group: RankGroup, line: tuple, nbytes: int
                       ) -> PeerBuffers:
    """Allocate this rank's buffer, gather the line's IPC handles over its
    process group (on the host, except on nccl) and map every peer's."""
    me = group._global(group.rank)
    if me not in line:
        raise ValueError(f"rank {me} is not on the line {line}")
    pg = _line_pg(line)
    with torch.cuda.device(group.device):
        local = ctypes.c_void_p()
        _ipc_call("peer_alloc", nbytes, ctypes.byref(local))
        size = _ipc()["peer_ipc_handle_bytes"]()
        handle = ctypes.create_string_buffer(size)
        _ipc_call("peer_get_handle", local, handle)
        mine = torch.frombuffer(bytearray(handle.raw), dtype=torch.uint8)
        if group.backend == "nccl":
            mine = mine.to(group.device)
        handles = torch.empty((len(line), size), dtype=torch.uint8,
                              device=mine.device)
        _all_gather_flat(handles, mine[None], group=pg)
        handles = handles.cpu()
        mapped = {}
        # the process group's order: the members sorted
        for q, peer in enumerate(sorted(line)):
            if peer == me:
                continue
            ptr = ctypes.c_void_p()
            raw = ctypes.create_string_buffer(bytes(handles[q].tolist()),
                                              size)
            _ipc_call("peer_open_handle", raw, ctypes.byref(ptr))
            mapped[peer] = ptr.value
    return PeerBuffers(local.value, mapped, nbytes, line, me)


def peer_buffer_list(kind: str = "ring") -> list:
    """This process's (this rank's) peer buffers of ``kind``, in the
    order made."""
    return [b for k, b in _PEER_BUFFERS.items() if k[0] == kind]


def free_peer_buffers(group: RankGroup) -> None:
    """Unmap and free this process's peer buffers. A collective over the
    world, made after the last call on them: the first barrier keeps a
    peer from writing into a freed buffer, the second keeps a buffer
    alive until no peer maps it. Under ``ipc`` every rank takes part,
    buffers or not, and first waits for its transport calls
    (``transport.close``): one that was given up and not raised yet
    raises here, before the barriers."""
    if group.backend == "ipc":
        _transport().close()
    keys = list(_PEER_BUFFERS)
    if not keys and group.backend != "ipc":
        return
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    group.barrier()
    for key in keys:
        for ptr in _PEER_BUFFERS[key].peers.values():
            _ipc_call("peer_close", ctypes.c_void_p(ptr))
    group.barrier()
    for key in keys:
        _ipc_call("peer_free", ctypes.c_void_p(_PEER_BUFFERS.pop(key).local))


def rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or GPU ``rank`` modulo the count
    (gloo ranks may share a card; nccl needs one card per rank)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def check_backend(backend: str, device: str, world: int) -> None:
    """Refuse what the backend cannot run; never switch backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: {BACKENDS}")
    if backend == "ipc":
        if device != "cuda":
            raise ValueError(
                "the ipc backend moves CUDA tensors device to device and "
                "needs --device cuda; on the CPU use --dist-backend gloo")
        if world > _transport().MAX_RANKS:
            raise ValueError(
                f"the ipc backend runs at most {_transport().MAX_RANKS} "
                f"ranks (its copy kernel's tables); got {world}")
        if not torch.cuda.is_available():
            raise ValueError("the ipc backend needs a CUDA device; none is "
                             "available")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend needs --device cuda; on the "
                             "CPU use --dist-backend gloo")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise ValueError(
                f"nccl needs one GPU per rank: {world} ranks, {have} "
                f"GPU(s). Run them on shared cards with --dist-backend "
                f"ipc (device to device through CUDA IPC) or gloo (the "
                f"wire then goes through host memory)")


def _worker(rank: int, world: int, mesh: tuple, backend: str, device: str,
            store: "str | tuple", fn: Callable, args: tuple, results) -> None:
    index = rank
    try:
        # a joined mesh: (coordinator host, port, this process's first
        # global rank); else the path of a file store
        joined = isinstance(store, tuple)
        if joined:
            rank += store[2]
        dev = rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(1 if dev.type == "cpu"
                              else max(1, (os.cpu_count() or 1) // world))
        # ipc: gloo carries the control plane, the payloads go through
        # peer memory
        pg_backend = "gloo" if backend == "ipc" else backend
        if joined:
            tcp = dist.TCPStore(store[0], store[1], is_master=False,
                                wait_for_workers=False)
            dist.init_process_group(pg_backend,
                                    store=dist.PrefixStore("mesh", tcp),
                                    rank=rank, world_size=world)
        else:
            dist.init_process_group(pg_backend,
                                    init_method=f"file://{store}",
                                    rank=rank, world_size=world)
        sp, ep, tp, pp = mesh
        group = RankGroup(rank, world, backend, dev, sp, ep=ep, tp=tp,
                          pp=pp)
        try:
            make_axis_subgroups(group)
            out = fn(group, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            free_peer_buffers(group)
        finally:
            free_axis_subgroups()
            dist.destroy_process_group()
        results.put((index, True, pickle.dumps(_to_cpu(out))))
    except Exception:  # noqa: BLE001 - the rank's boundary: reported
        results.put((index, False, traceback.format_exc()))
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def spawn_ranks(fn: Callable, world: int, backend: str, device: str,
                *args, sp: int = 1, ep: int = 1, tp: int = 1,
                pp: int = 1, timeout: float = 900.0,
                join: Optional[tuple] = None) -> list:
    """Run ``fn(group, *args)`` in ``world`` new processes, the mesh
    ``(pp, dp, ep, sp, tp)`` with ``dp = world / (pp ep sp tp)``, and return
    their results in rank order (tensors come back on the CPU). A rank
    that raises, dies or outlasts ``timeout`` seconds ends every rank and
    raises here with that rank's traceback.

    ``join = (host, port, process_id, num_processes)`` makes this
    process's share of a mesh that spans ``num_processes`` processes
    (each calls ``spawn_ranks`` with the same mesh): it runs ranks
    ``process_id * world / num_processes`` onward, ``world /
    num_processes`` of them, whose process group meets through the
    coordinator's TCPStore at ``host:port`` (under the prefix ``mesh``),
    and returns their results."""
    check_backend(backend, device, world)
    if world < 1 or min(sp, ep, tp, pp) < 1 \
            or world % (sp * ep * tp * pp):
        raise ValueError(f"world must be >= 1 and a multiple of pp x ep x "
                         f"sp x tp; got world={world}, pp={pp}, ep={ep}, "
                         f"sp={sp}, tp={tp}")
    local = world
    if join is not None:
        host, port, pid, nprocs = join
        if world % nprocs:
            raise ValueError(f"the mesh's {world} ranks must divide over "
                             f"{nprocs} processes")
        local = world // nprocs
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    results = ctx.Queue()
    store = (os.path.join(tmp, "store") if join is None
             else (host, int(port), pid * local))
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, (sp, ep, tp, pp), backend, device,
                               store, fn, args, results))
             for r in range(local)]
    try:
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        while len(got) < local:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"rank(s) {dead or 'all'} "
                        + ("died (exit codes "
                           f"{[procs[r].exitcode for r in dead]})" if dead
                           else f"did not finish within {timeout:.0f} s"))
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(local)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


# -- a generic rank job: call named functions with per-rank inputs --------

@dataclasses.dataclass(frozen=True)
class PerRank:
    """An argument of :func:`run_calls` that differs by rank: rank r
    receives ``values[r]``."""

    values: Any


@dataclasses.dataclass(frozen=True)
class Ref:
    """An argument of :func:`run_calls` that is the result of an earlier
    call of the same list (item ``item`` of it when given): threads state
    such as a residual from one round into the next."""

    call: int
    item: Optional[int] = None


def _resolve(target: str) -> Callable:
    module, _, name = target.partition(":")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _bind(arg: Any, group: RankGroup, done: list) -> Any:
    if isinstance(arg, Ref):
        out = done[arg.call]
        return out if arg.item is None else out[arg.item]
    if isinstance(arg, PerRank):
        arg = arg.values[group.rank]
    if isinstance(arg, np.ndarray):
        return torch.from_numpy(arg.copy()).to(group.device)
    if isinstance(arg, torch.Tensor):
        return arg.clone().to(group.device)
    if isinstance(arg, dict):
        return {k: _bind(v, group, done) for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        return type(arg)(_bind(v, group, done) for v in arg)
    return arg


def run_calls(group: RankGroup, calls: list) -> list:
    """Run ``calls`` in order on this rank and return their results.
    Each call is ``(target, args, kwargs)``: ``target`` names a function
    as ``"package.module:function"``, numpy arrays and tensors among the
    arguments arrive as tensors on the rank's device, a
    :class:`PerRank` argument is replaced by this rank's value, a
    :class:`Ref` by an earlier call's result, and the group is passed as
    the keyword ``group``. A driver for tests and checks that hold
    several ranks' inputs in one place."""
    out: list = []
    for target, args, kwargs in calls:
        fn = _resolve(target)
        out.append(fn(*_bind(tuple(args), group, out),
                      **_bind(dict(kwargs), group, out), group=group))
    return out


def loaded_modules(group: Optional[RankGroup] = None) -> list:
    """The names of the modules this process has imported (a rank's
    import hygiene is checked through it)."""
    return sorted(sys.modules)
