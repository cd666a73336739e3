"""Training across processes: the deadline-gated DCN gradient sync.

Counterpart of ``akka_allreduce_tpu/runtime/dcn_train.py``, the names
kept. The hybrid topology:

* **Within a process** the gradient sync runs exact: the process's local
  mesh (a ``RankGroup`` over its own ranks: pp, dp, ep, sp and tp) syncs
  through the port's collectives (``models/train.py make_grad_step``).
* **Across processes** the host plane runs the reference's protocol:
  every round each process publishes its locally reduced gradient
  vector to the coordinator's key-value store (``protocol/kv.py
  StoreKv`` over the TCPStore of ``runtime/coordinator.py``) and sends a
  ``CompleteAllreduce`` arrival report to the master (process 0) over
  the :class:`~akka_allreduce_tpu_torch.protocol.kv.KvRouter` (reference:
  AllreduceMessage.scala:21, AllreduceMaster.scala:54-63). The master
  feeds the reports into a ``RoundClock`` (``runtime/pacer.py``),
  closes the round at a completion fraction (``th_allreduce``, the
  reference master's ``numComplete >= totalWorkers * thAllreduce``,
  AllreduceMaster.scala:58) or at the deadline, and publishes the
  contribution mask. Every process applies the masked, token-weighted
  mean (reference: ScatteredDataBuffer.scala:9-13,
  ReducedDataBuffer.scala:40-48).

The mask is per process: a process is a whole local mesh, so no process
is ever masked as half of a line of its own mesh (ROADMAP C11's concern
does not arise here). Within a process, local rank 0 is the DCN
participant: it alone publishes, reads the store and talks to the
master. It hands its results (a round's report, a replay, a stall, an
error) to its local peers as pickled objects over the local group, and
the round's mean vector as a tensor broadcast over it
(``RankGroup.broadcast``: device to device on ``ipc``), so every local
rank applies bitwise the same update and no payload is published twice.

The wire vector is JAX's for the same local mesh: the process's whole
gradient tree (JAX's global arrays) in ``tree_bucket_spec`` order. On a
local tp / ep / pp mesh every local rank takes part in the all-gathers
of the shards along their axes (``convert.gather_tree``), at pp > 1
into the stacked ``(L, ...)`` layers of JAX's tree (the non-layer
leaves after the pp sum, local rank 0's copy), and each rank cuts the
mean to its own shard (``convert.shard_params``) before the update,
whose clip then takes the whole model's norm. The replica check's CRC
is of the gathered whole parameters; at pp > 1 their replicated leaves
are local rank 0's (stage 0's) copy: on the f32 and bf16 wires every
stage applies the same mean to the same values, and on an ef8 local
sync the stages' copies drift (ROADMAP C15).

Straggler semantics at three granularities, as in JAX: per wire bucket
(``dcn_bucket_elems``: a process cut mid-publish still contributes the
buckets that landed), per round (a late process is masked, then replays
the retained masks and payloads: ``catch_up``), and permanently (a peer
masked ``down_after`` rounds in a row is auto-downed and re-upped on
probation when it reports at the frontier; beyond the retention window
it rejoins through the checkpoint snapshot protocol). The master beats a
heartbeat key from a thread on its own store connection; workers waiting
on a mask or a snapshot fail within ``hb_timeout_s`` of its last beat.
Every ``check_every`` rounds each process publishes a CRC of its
parameters and the master compares them. The first round is a quorum
barrier with no deadline.

The token-weighted mean runs on the host in numpy, in fixed rank order,
so every process computes bitwise the same vector (and bitwise JAX's for
the same payloads), and it is applied through ``models/train.py
apply_update`` (the exact path's clip, schedule and EMA). The vector's
leaf order is ``ops/bucketing.py tree_bucket_spec``'s, JAX's.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import threading
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.messages import CompleteAllreduce
from akka_allreduce_tpu_torch.ops.bucketing import (num_chunks,
                                                    tree_bucket_spec,
                                                    tree_leaves,
                                                    tree_to_vector,
                                                    vector_to_tree)
from akka_allreduce_tpu_torch.protocol.kv import KvRouter, _default_client
from akka_allreduce_tpu_torch.runtime.pacer import RoundClock

# local loss f32, local tokens u64, wire format u8, 3 pad bytes
_HDR = struct.Struct("<fQBxxx")
_WIRE_F32, _WIRE_INT8, _WIRE_BF16 = 0, 1, 2
_INT8_CHUNK = 65536  # one f32 scale per chunk


def _is_not_found(exc: Exception) -> bool:
    """True iff the store error means 'key missing'; any other failure
    propagates."""
    return "NOT_FOUND" in str(exc)


def _to_bf16_bits(vec: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (int16), rounded to nearest even (torch's
    conversion; JAX's ml_dtypes rounds the same way)."""
    return torch.from_numpy(vec).to(torch.bfloat16).view(torch.int16).numpy()


def _from_bf16(data: bytes, offset: int) -> np.ndarray:
    """bf16 bytes -> f32, exactly (a bf16 is the top half of an f32), on
    torch's threads: at the flagship's 541M values numpy's one-thread
    passes were the round's slowest host step."""
    with warnings.catch_warnings():
        # a read-only payload is only read
        warnings.simplefilter("ignore", UserWarning)
        half = torch.frombuffer(data, dtype=torch.int16, offset=offset)
    return half.view(torch.bfloat16).float().numpy()


def encode_payload(vec: np.ndarray, loss: float, tokens: float,
                   wire: str, seed: int = 0) -> bytes:
    """Serialize one wire chunk of a round's gradient for the store.

    ``wire="int8"``: per-chunk symmetric int8 with stochastic rounding
    from ``np.random.default_rng(seed)`` (unbiased across rounds: the
    seed varies per round), the bytes JAX's for the same seed. Layout:
    header, u64 length, f32 scales (one per 64Ki chunk), int8 values.
    ``wire="bf16"`` rounds to nearest even; ``"f32"`` is the bytes as
    they are."""
    vec = np.ascontiguousarray(vec, np.float32)
    if wire == "f32":  # one copy: the header and the values joined
        return b"".join((_HDR.pack(loss, int(tokens), _WIRE_F32), vec))
    if wire == "bf16":
        return b"".join((_HDR.pack(loss, int(tokens), _WIRE_BF16),
                         _to_bf16_bits(vec)))
    if wire != "int8":
        raise ValueError(f"unknown wire {wire!r}")
    n = vec.size
    pad = (-n) % _INT8_CHUNK
    rows = np.pad(vec, (0, pad)).reshape(-1, _INT8_CHUNK)
    scales = np.maximum(np.abs(rows).max(axis=1, keepdims=True) / 127.0,
                        1e-30).astype(np.float32)
    scaled = rows / scales
    low = np.floor(scaled)
    rng = np.random.default_rng(seed)
    q = low + (scaled - low > rng.random(rows.shape, np.float32))
    values = np.clip(q, -127, 127).astype(np.int8).reshape(-1)[:n]
    return (_HDR.pack(loss, int(tokens), _WIRE_INT8)
            + struct.pack("<Q", n) + scales.tobytes() + values.tobytes())


def decode_payload(data: bytes) -> tuple:
    """Inverse of :func:`encode_payload` -> (loss, tokens, f32 vector)."""
    loss, tokens, wire = _HDR.unpack_from(data)
    off = _HDR.size
    if wire == _WIRE_F32:
        return loss, tokens, np.frombuffer(data, np.float32, offset=off)
    if wire == _WIRE_BF16:
        return loss, tokens, _from_bf16(data, off)
    if wire != _WIRE_INT8:
        raise ValueError(f"unknown wire flag {wire}")
    (n,) = struct.unpack_from("<Q", data, off)
    off += 8
    n_chunks = (n + _INT8_CHUNK - 1) // _INT8_CHUNK
    scales = np.frombuffer(data, np.float32, offset=off, count=n_chunks)
    off += 4 * n_chunks
    values = np.frombuffer(data, np.int8, offset=off, count=n)
    pad = (-n) % _INT8_CHUNK
    out = (np.pad(values, (0, pad)).reshape(-1, _INT8_CHUNK)
           .astype(np.float32) * scales[:, None]).reshape(-1)[:n]
    return loss, tokens, out


# the token-weighted mean runs in ranges of this many elements, on threads
_MEAN_RANGE = 1 << 20
_MEAN_POOL: list = []


def _payload_view(data: bytes) -> tuple:
    """A payload's values without a decoded copy: (f32 values, False), or
    (bf16 bits, True) to widen range by range; an int8 payload decoded
    whole."""
    _, _, wire = _HDR.unpack_from(data)
    if wire == _WIRE_F32:
        return np.frombuffer(data, np.float32, offset=_HDR.size), False
    if wire == _WIRE_BF16:
        return np.frombuffer(data, np.uint16, offset=_HDR.size), True
    return decode_payload(data)[2], False


def _weighted_means(buckets: list) -> None:
    """For each ``(terms, wsum, out)``: ``out = (w0 * v0 + w1 * v1 + ...)
    / wsum`` over the ``(w, (values, bf16))`` terms in their order, in
    numpy, element by element as JAX's whole-vector expression computes it
    (``totals = w * v``, ``totals += w * v``, ``totals / wsum``): no
    element's result depends on another's, so ranges of the buckets,
    each on a thread, give bitwise the whole-vector result."""
    def mean_range(job) -> None:
        terms, wsum, out, lo = job
        hi = min(out.size, lo + _MEAN_RANGE)
        acc = None
        for w, (values, bf16) in terms:
            x = values[lo:hi]
            if bf16:
                x = (x.astype(np.uint32) << 16).view(np.float32)
            if acc is None:
                acc = w * x
            else:
                acc += w * x
        out[lo:hi] = acc / wsum
    jobs = [(terms, wsum, out, lo) for terms, wsum, out in buckets
            for lo in range(0, out.size, _MEAN_RANGE)]
    if len(jobs) == 1:
        mean_range(jobs[0])
        return
    if not _MEAN_POOL:
        _MEAN_POOL.append(ThreadPoolExecutor(os.cpu_count() or 1))
    list(_MEAN_POOL[0].map(mean_range, jobs))


class StalledBeyondRetention(RuntimeError):
    """A process woke after the cluster advanced past the retention
    window: replay is impossible (payloads collected). With a checkpoint
    dir the CLI recovers through the snapshot-rejoin protocol; without
    one this is fatal."""

    def __init__(self, msg: str, current_round: int):
        super().__init__(msg)
        self.current_round = current_round


@dataclasses.dataclass
class DcnRoundReport:
    """One cross-process round as the host saw it. ``times`` holds this
    process's seconds (and bytes) in the round's phases (see
    :meth:`DcnDeadlineTrainer.run_round`)."""

    round: int
    valid_peers: tuple  # per peer: contributed >= 1 bucket
    n_masked: int  # peers that contributed nothing this round
    loss: float  # token-weighted mean of contributors' local losses
    caught_up: int = 0  # rounds replayed before this one (post-stall)
    bucket_counts: tuple = ()  # contributors per wire bucket
    n_partial: int = 0  # peers that contributed some but not all buckets
    downed: tuple = ()  # master only: the auto-downed set
    times: dict = dataclasses.field(default_factory=dict)


def _report_only(out):
    """A (mean vector, report) pair as local rank 0 shares it: the report
    alone (the vector follows as a tensor broadcast)."""
    return None if out is None else (None, out[1])


def _host_vector(tree) -> np.ndarray:
    """A gradient tree (tensors, or numpy arrays from a host-math step)
    as one f32 host vector in ``tree_leaves`` order."""
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], torch.Tensor):
        return tree_to_vector(tree).detach().cpu().numpy()
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in leaves])


def _now(device: Optional[torch.device]) -> float:
    """The wall clock after the device's queued work."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class DcnDeadlineTrainer:
    """Deadline-gated cross-process training rounds.

    One instance per local rank of every process, the same arguments
    everywhere. ``cfg`` is the ``TrainConfig`` of the process-local step
    and ``group`` the process's local ``RankGroup`` (None for a local
    world of one); the cross-process reduction is this class's job.
    ``rank`` / ``num_processes`` are the process id and count (default:
    ``runtime/coordinator.py``'s), ``client`` the store client (default:
    a ``StoreKv`` on the coordinator's store; only local rank 0 uses it).

    Knobs beyond the deadline (see the module doc): ``th_allreduce``,
    ``down_after`` (0 disables), ``dcn_bucket_elems`` (None/0: one
    whole-vector bucket), ``max_lag`` (rounds in flight beyond the one
    being applied), ``retain_rounds``, ``check_every`` (0 disables),
    ``hb_interval_s`` / ``hb_timeout_s``.

    The training state is the port's ``TrainState``, updated in place:
    ``run_round(state, tokens)``, ``harvest(state)``, ``drain(state)``
    and ``catch_up(state)`` take the place of JAX's ``(params,
    opt_state)`` pairs. ``grad_step`` overrides the local step: any
    ``(params, tokens, round) -> (grads, {"loss", "tokens"})`` rides the
    protocol (the protocol tests drive it with host math)."""

    def __init__(self, cfg, group=None, *, deadline_s: float,
                 namespace: str = "aatdcn", retain_rounds: int = 64,
                 barrier_timeout_s: float = 300.0, client=None,
                 rank: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 wire: str = "f32", max_lag: int = 0, tracer=None,
                 th_allreduce: float = 1.0, down_after: int = 4,
                 dcn_bucket_elems: Optional[int] = None,
                 check_every: Optional[int] = None,
                 hb_interval_s: float = 0.5, hb_timeout_s: float = 10.0,
                 grad_step=None):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if wire not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"wire must be 'f32', 'bf16' or 'int8', got {wire!r}")
        if max_lag < 0:
            raise ValueError("max_lag must be >= 0 (0 = lockstep)")
        if max_lag + 1 > retain_rounds // 2:
            raise ValueError(
                f"max_lag={max_lag} must stay well inside the retention "
                f"window ({retain_rounds})")
        if retain_rounds < 8:
            # catch_up keeps a 4-round margin against the survivors'
            # concurrent garbage collection
            raise ValueError("retain_rounds must be >= 8")
        if not 0.0 < th_allreduce <= 1.0:
            raise ValueError(
                f"th_allreduce must be in (0, 1], got {th_allreduce}")
        if down_after < 0:
            raise ValueError("down_after must be >= 0 (0 = never down)")
        if dcn_bucket_elems is not None and dcn_bucket_elems <= 0:
            dcn_bucket_elems = None
        from akka_allreduce_tpu_torch.runtime import coordinator
        self.cfg = cfg
        self.group = group
        self.deadline_s = float(deadline_s)
        self.retain = int(retain_rounds)
        self.barrier_timeout_s = float(barrier_timeout_s)
        proc = coordinator.PROCESS or (0, 1)
        self.rank = proc[0] if rank is None else int(rank)
        self.nprocs = proc[1] if num_processes is None else int(num_processes)
        self.master = self.rank == 0
        self._local_world = 1 if group is None else group.world
        # local rank 0 is the process's DCN participant
        self._lead = group is None or group.rank == 0
        # a local tp / ep / pp mesh: each rank holds a shard, the wire
        # the whole tree
        self._sharded = group is not None and any(
            group.axis_size(a) > 1 for a in ("tp", "ep", "pp"))
        self.wire = wire
        self.tracer = tracer
        self.th = float(th_allreduce)
        self.down_after = int(down_after)
        self.dcn_bucket_elems = dcn_bucket_elems
        self.check_every = (self.retain if check_every is None
                            else int(check_every))
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        # max_lag K: K extra rounds in flight (reference:
        # AllReduceBuffer.scala:9-42)
        self.max_lag = int(max_lag)
        self._window = self.max_lag + 1
        # published-but-not-applied rounds: (round, own bucket bytes or
        # None off the lead, this round's times)
        self._pending: list = []
        self.ns = namespace
        self._kv = None
        self.router = None
        self.clock = None
        if self._lead:
            self._kv = client if client is not None else _default_client()
            self.router = KvRouter(
                rank=self.rank, role="master" if self.master else "worker",
                namespace=f"{namespace}/msg", client=self._kv)
            self._self_ref = self.router.register("trainer",
                                                  self._on_message)
            if self.master:
                self.clock = RoundClock(self.nprocs,
                                        deadline_s=self.deadline_s)
        self._round = 0
        self._start_round = 0
        self._frontier = 0
        self._cleaned_to = 0
        self._downed: set = set()
        self._consec_missed: dict = {}
        self.reports: list = []
        # the local ef8 residual (the TrainState's, installed with
        # set_ef_state or taken at the first round); the DCN wire itself
        # carries no residual: its int8 rounding is zero-mean across rounds
        self.ef_state: Optional[Any] = None
        self._use_ef = (grad_step is None
                        and getattr(cfg, "grad_transport", None) == "ef8")
        self._device = None
        if grad_step is None:
            from akka_allreduce_tpu_torch.models.train import make_grad_step
            inner = make_grad_step(cfg, group)

            def grad_step(params, tokens, r):
                out = inner(params, tokens, quant_seed=int(r),
                            residual=self.ef_state)
                if self._use_ef and self.ef_state is not None:
                    with torch.no_grad():
                        for live, new in zip(tree_leaves(self.ef_state),
                                             tree_leaves(out[2])):
                            live.copy_(new)
                return out[0], out[1]
        self._gstep = grad_step
        self._spec = None
        self._chunk_elems = 0
        self._n_chunks = 0
        self._hb_stop: Optional[threading.Event] = None
        if self.master and self._lead:
            # a previous run's liveness keys in a reused namespace would
            # kill fresh workers' waits: clear them before any worker
            # can probe them
            for key in (self._donekey, self._hbkey):
                try:
                    self._kv.key_value_delete(key)
                except Exception:
                    pass
            if self.hb_interval_s > 0:
                self._hb_stop = threading.Event()
                beat = (self._kv.clone() if hasattr(self._kv, "clone")
                        else self._kv)
                self._hb_thread = threading.Thread(
                    target=self._hb_loop, args=(beat,), daemon=True,
                    name="dcn-master-heartbeat")
                self._hb_thread.start()

    # -- keys -----------------------------------------------------------------

    def _trace(self, kind: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.record(kind, rank=self.rank, **fields)

    def _try_get(self, key: str) -> Optional[str]:
        """A try-get that treats a missing key as None; any other store
        failure propagates."""
        try:
            return self._kv.key_value_try_get(key)
        except Exception as exc:
            if _is_not_found(exc):
                return None
            raise

    def _gkey(self, r: int, p: int, b: int) -> str:
        return f"{self.ns}/g/{r:012d}/{p:04d}/{b:04d}"

    def _gdir(self, r: int, p: int) -> str:
        return f"{self.ns}/g/{r:012d}/{p:04d}/"

    def _maskkey(self, r: int) -> str:
        return f"{self.ns}/mask/{r:012d}"

    def _chkkey(self, r: int, p: int) -> str:
        return f"{self.ns}/chk/{r:012d}/{p:04d}"

    @property
    def _roundkey(self) -> str:
        return f"{self.ns}/round"

    @property
    def _donekey(self) -> str:
        return f"{self.ns}/done"

    @property
    def _hbkey(self) -> str:
        return f"{self.ns}/hb"

    # -- the local group ------------------------------------------------------

    def _share(self, obj=None):
        """Local rank 0's ``obj`` on every local rank."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=self.group._global(0),
                                   group=self.group._pg())
        return box[0]

    def _on_lead(self, fn, share=None):
        """``fn()`` on local rank 0 (the only rank that touches the
        store); its result (or ``share(result)``: a round's report
        without its mean vector, which :meth:`_apply_vector` broadcasts
        as a tensor), or its failure, on every local rank."""
        if self._local_world == 1:
            return fn()
        if not self._lead:
            kind, *rest = self._share()
            if kind == "ok":
                return rest[0]
            if kind == "stalled":
                raise StalledBeyondRetention(rest[0], current_round=rest[1])
            raise RuntimeError(f"local rank 0 failed: {rest[0]}")
        try:
            out = fn()
        except StalledBeyondRetention as exc:
            self._share(("stalled", str(exc), exc.current_round))
            raise
        except Exception as exc:
            self._share(("error", f"{type(exc).__name__}: {exc}"))
            raise
        self._share(("ok", out if share is None else share(out)))
        return out

    def _full(self, tree):
        """A params-shaped tree whole, in the JAX global layout (the
        stacked layers at pp > 1): on a local tp / ep / pp mesh the
        all-gathers of every shard along its axes (a collective over the
        local mesh), else the tree itself."""
        if not self._sharded:
            return tree
        from akka_allreduce_tpu_torch.convert import gather_tree
        return gather_tree(tree, self.group, unstack=False)

    # -- master liveness ------------------------------------------------------

    def _hb_loop(self, kv) -> None:
        """Master thread: bump the heartbeat key every ``hb_interval_s``
        from construction to close(), through the master's own long grad
        steps, so a worker's timeout measures the master's death."""
        n = 0
        while not self._hb_stop.wait(self.hb_interval_s):
            n += 1
            try:
                kv.key_value_set(self._hbkey, str(n), allow_overwrite=True)
            except Exception:
                pass  # the main thread's own requests surface the error

    def _hb_watch(self):
        """A per-wait closure that raises once the master's heartbeat has
        been silent for ``hb_timeout_s``; it never fires before the first
        beat is seen (the master may still be starting)."""
        state = {"val": None, "at": time.monotonic(), "next": 0.0}
        probe_every = min(1.0, max(self.hb_interval_s, 0.05))

        def check() -> None:
            if self.hb_timeout_s <= 0:
                return
            now = time.monotonic()
            if now < state["next"]:
                return
            state["next"] = now + probe_every
            v = self._try_get(self._hbkey)
            if v is not None and v != state["val"]:
                state["val"], state["at"] = v, now
                return
            if state["val"] is not None \
                    and now - state["at"] > self.hb_timeout_s:
                raise TimeoutError(
                    f"master heartbeat silent for {self.hb_timeout_s:.0f}s"
                    f" — the master process died (its death halts the "
                    f"run, like the reference's master actor under the "
                    f"10s failure detector); restart every process from "
                    f"the last checkpoint")
        return check

    # -- master-side arrival handling -----------------------------------------

    def _on_message(self, msg) -> None:
        if self.master and isinstance(msg, CompleteAllreduce):
            # reports for long-closed rounds land harmlessly
            self.clock.report_arrival(msg.round, msg.src_id)
            if (msg.src_id in self._downed
                    and msg.round + self._window >= self._frontier):
                # a downed peer reporting at (or within the streaming
                # window of) the frontier has caught up: re-up it on
                # probation (one further miss re-downs it)
                self._downed.discard(msg.src_id)
                if self.down_after > 1:
                    self._consec_missed[msg.src_id] = self.down_after - 1
                else:
                    self._consec_missed.pop(msg.src_id, None)
                self._trace("peer_rejoined", round=msg.round,
                            peer=msg.src_id)

    def _probe_buckets(self, r: int, p: int) -> list:
        """Which of peer ``p``'s wire chunks for round ``r`` landed (a
        late peer's partial contribution, reference:
        ScatteredDataBuffer.scala:9-13)."""
        try:
            entries = self._kv.key_value_dir_get_bytes(self._gdir(r, p))
        except Exception as exc:
            if _is_not_found(exc):
                return [False] * self._n_chunks
            raise
        present = set()
        for key, _ in entries:
            try:
                present.add(int(key.rsplit("/", 1)[-1]))
            except ValueError:
                pass
        return [b in present for b in range(self._n_chunks)]

    def _master_collect(self, r: int) -> list:
        """Pump arrival reports; close the round at the completion
        fraction (``arrived >= ceil(th_allreduce * active)``), else at the
        deadline. Downed peers are not waited on. The first round is the
        quorum barrier. The deadline clock opens here, after the master's
        own step and publish (arrivals are stamped when the master's poll
        delivers them)."""
        self.clock.open_round(r)
        self.clock.report_arrival(r, 0)
        self._frontier = r
        deadline_at = self.clock.opened_at(r) + self.deadline_s
        barrier_at = time.monotonic() + self.barrier_timeout_s
        barrier = r == self._start_round
        while True:
            self.router.poll(0.005)
            active = [p for p in range(self.nprocs)
                      if p not in self._downed]
            arrived = sum(1 for p in active
                          if self.clock.has_arrived(r, p))
            if barrier:
                if arrived >= self.nprocs:
                    break
                if time.monotonic() >= barrier_at:
                    raise TimeoutError(
                        f"quorum barrier: only {arrived}/"
                        f"{self.nprocs} processes joined within "
                        f"{self.barrier_timeout_s}s")
                continue
            required = max(1, math.ceil(self.th * len(active) - 1e-9))
            if arrived >= required:
                break
            if time.monotonic() >= deadline_at:
                break
        B = self._n_chunks
        if barrier:
            rows = [[True] * B for _ in range(self.nprocs)]
        else:
            ontime = self.clock.valid_peers(r)
            rows = []
            for p in range(self.nprocs):
                if p == 0 or ontime[p]:
                    # the master pins itself in (it paces the round); a
                    # worker reports after its last bucket, so an on-time
                    # report means every bucket landed
                    rows.append([True] * B)
                elif p in self._downed:
                    rows.append([False] * B)
                else:
                    rows.append(self._probe_buckets(r, p))
            # auto-down: a peer that contributed nothing down_after rounds
            # in a row stops being waited on (reference:
            # auto-down-unreachable-after, application.conf:20)
            for p in range(1, self.nprocs):
                if p in self._downed:
                    continue
                if any(rows[p]):
                    self._consec_missed.pop(p, None)
                    continue
                c = self._consec_missed.get(p, 0) + 1
                self._consec_missed[p] = c
                if self.down_after and c >= self.down_after:
                    self._downed.add(p)
                    self._trace("peer_downed", round=r, peer=p,
                                consecutive_missed=c)
        try:
            self._kv.key_value_set(
                self._maskkey(r),
                "".join("1" if v else "0" for row in rows for v in row),
                allow_overwrite=False)
        except Exception as exc:
            if "ALREADY_EXISTS" in str(exc) or "overwrite" in str(exc):
                raise RuntimeError(
                    f"mask for round {r} already exists in the KV store "
                    f"— a stale namespace from a previous run on the "
                    f"same coordinator store; change --namespace or "
                    f"restart the coordinator") from exc
            raise
        self._trace("mask_published", round=r,
                    n_masked=sum(1 for row in rows if not any(row)))
        self.clock.expire(r - 1)
        return rows

    def _read_mask(self, r: int) -> list:
        """Wait for the master's mask: a dead master trips the heartbeat
        watch, a closed master the done marker, a mask already collected
        because this process stalled raises StalledBeyondRetention, and a
        master that stopped publishing times out."""
        deadline = time.monotonic() + self.deadline_s * 2 \
            + self.barrier_timeout_s
        hb_check = self._hb_watch()
        done_next = 0.0
        while True:
            s = self._try_get(self._maskkey(r))
            if s is not None:
                return self._parse_mask(s)
            cur_s = self._try_get(self._roundkey)
            if cur_s is not None and int(cur_s) - r >= self.retain:
                raise StalledBeyondRetention(
                    f"stalled at round {r} while the cluster reached "
                    f"{cur_s}, beyond the {self.retain}-round retention "
                    f"window", current_round=int(cur_s))
            now = time.monotonic()
            if now >= done_next:
                # the master's close() sets the done marker whatever ended
                # it: it catches a master that died before its first beat
                done_next = now + 0.25
                if self._try_get(self._donekey) is not None:
                    s = self._try_get(self._maskkey(r))
                    if s is not None:
                        return self._parse_mask(s)
                    raise TimeoutError(
                        f"no mask for round {r}: the master already "
                        f"closed (finished or died) — restart every "
                        f"process from the last checkpoint. If this "
                        f"fires at startup, a stale namespace from a "
                        f"previous run is the likely cause: change "
                        f"--namespace")
            hb_check()
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no mask for round {r}: the master stopped "
                    f"publishing (its death halts the run, like the "
                    f"reference's master actor)")
            time.sleep(0.01)

    def _parse_mask(self, s: str) -> list:
        """Mask wire format -> per-peer bucket rows."""
        B = len(s) // self.nprocs
        assert B * self.nprocs == len(s), \
            f"mask length {len(s)} not divisible by {self.nprocs} peers"
        return [[c == "1" for c in s[p * B:(p + 1) * B]]
                for p in range(self.nprocs)]

    # -- the masked cross-process reduction -----------------------------------

    def _ensure_apply(self, tree) -> None:
        """The vector's geometry and the wire chunks, from the params (or
        grads: one structure; on a local tp / ep / pp mesh gathered whole
        once, a collective over it)."""
        if self._spec is not None:
            return
        self._spec = tree_bucket_spec(self._full(tree), self.cfg.bucket_elems)
        total = self._spec.total_size
        self._chunk_elems = (self.dcn_bucket_elems
                             if self.dcn_bucket_elems else total)
        self._n_chunks = max(1, num_chunks(total, self._chunk_elems))

    def _chunk_bounds(self, b: int) -> tuple:
        lo = b * self._chunk_elems
        return lo, min(self._spec.total_size, lo + self._chunk_elems)

    def _fetch_peer_buckets(self, r: int, p: int) -> dict:
        """Every landed wire chunk of peer ``p`` for round ``r`` in one
        directory read."""
        try:
            entries = self._kv.key_value_dir_get_bytes(self._gdir(r, p))
        except Exception as exc:
            if _is_not_found(exc):
                return {}
            raise
        out = {}
        for key, data in entries:
            try:
                out[int(key.rsplit("/", 1)[-1])] = data
            except ValueError:
                pass
        return out

    def _get_payload(self, r: int, p: int, b: int,
                     wait_s: float = 30.0) -> bytes:
        """One contributor wire chunk, polled, with a message naming the
        round, rank and bucket when it never comes (a replay passes a
        short window: its payloads exist already or were collected). A
        process stopped between its mask read and this fetch until the
        cluster passed the retention window raises
        StalledBeyondRetention, as at the mask (the snapshot rejoin
        recovers it; JAX's waits out the window and fails: ROADMAP
        C17)."""
        deadline = time.monotonic() + wait_s
        while True:
            try:
                return self._kv.key_value_try_get_bytes(self._gkey(r, p, b))
            except Exception as exc:
                if not _is_not_found(exc):
                    raise
            cur_s = self._try_get(self._roundkey)
            if cur_s is not None and int(cur_s) - r >= self.retain:
                raise StalledBeyondRetention(
                    f"stalled at round {r} while the cluster reached "
                    f"{cur_s}, beyond the {self.retain}-round retention "
                    f"window (its payloads collected)",
                    current_round=int(cur_s))
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"round {r}: contributor {p}'s gradient bucket {b} is "
                    f"missing from the KV store (masked-in but deleted? "
                    f"stalled beyond the {self.retain}-round retention "
                    f"window?) — resume from the last checkpoint")
            time.sleep(0.02)

    def _mean_vector(self, r: int, rows: list, own: Optional[list],
                     replay: bool = False, times: Optional[dict] = None
                     ) -> tuple:
        """The token-weighted mean of the contributors' local-mean
        gradients per wire bucket, in fixed rank order (every process
        computes the bit-identical vector), and the round's report. Each
        payload is the gradient of its process's local mean loss over
        ``tokens_p`` tokens, so the global batch-mean gradient is
        ``sum_p tokens_p * g_p / sum_p tokens_p``; masks compose per
        bucket with honest per-bucket counts (reference:
        ReducedDataBuffer.scala:40-48)."""
        times = {} if times is None else times
        B = self._n_chunks
        if rows and len(rows[0]) != B:
            raise RuntimeError(
                f"mask geometry mismatch: the master published "
                f"{len(rows[0])}-bucket rows but this process chunks the "
                f"wire into {B} buckets — --dcn-bucket-elems must be "
                f"identical on every process")
        terms: list = [[] for _ in range(B)]  # (weight, payload) in rank order
        counts = [0] * B
        wsum = [0.0] * B
        losses = []
        fetch_s = fetch_bytes = mean_s = 0.0
        for p in range(self.nprocs):
            row = rows[p]
            if not any(row):
                continue
            use_own = p == self.rank and own is not None
            t0 = time.perf_counter()
            fetched = {} if use_own else self._fetch_peer_buckets(r, p)
            fetch_s += time.perf_counter() - t0
            fetch_bytes += sum(len(v) for v in fetched.values())
            got_loss = False
            for b in range(B):
                if not row[b]:
                    continue
                if use_own:
                    data = own[b]
                else:
                    data = fetched.get(b)
                    if data is None:
                        t0 = time.perf_counter()
                        data = self._get_payload(
                            r, p, b, wait_s=2.0 if replay else 30.0)
                        fetch_s += time.perf_counter() - t0
                        fetch_bytes += len(data)
                loss_p, toks, _ = _HDR.unpack_from(data)
                w = float(toks)
                if w <= 0.0:
                    # an empty local batch carries no gradient (0/0): weight
                    # it out entirely (0 * NaN would poison the sum)
                    continue
                terms[b].append((w, data))
                counts[b] += 1
                wsum[b] += w
                if not got_loss:
                    losses.append((w, loss_p))
                    got_loss = True
        if min(counts) == 0:
            raise RuntimeError(
                "a wire bucket has no token-bearing contributor — either "
                "the mask let nobody in (the master pins itself, so this "
                "is a protocol bug) or every contributor reported 0 "
                "tokens (empty local batches cannot carry a gradient; "
                "check the data pipeline)")
        t0 = time.perf_counter()
        out = np.empty(self._spec.total_size, np.float32)
        _weighted_means([([(w, _payload_view(data)) for w, data in terms[b]],
                          wsum[b], out[slice(*self._chunk_bounds(b))])
                         for b in range(B)])
        mean_s += time.perf_counter() - t0
        times.update(fetch_s=fetch_s, fetch_bytes=fetch_bytes,
                     decode_mean_s=mean_s)
        full = [p for p in range(self.nprocs) if all(rows[p])]
        contributed = [p for p in range(self.nprocs) if any(rows[p])]
        lw = sum(w for w, _ in losses)
        rep = DcnRoundReport(
            round=r, valid_peers=tuple(any(row) for row in rows),
            n_masked=self.nprocs - len(contributed),
            # the token-weighted global batch-mean loss
            loss=float(sum(w * l for w, l in losses) / lw),
            bucket_counts=tuple(counts),
            n_partial=len(contributed) - len(full),
            downed=tuple(sorted(self._downed)) if self.master else (),
            times=times)
        return out, rep

    def _publish(self, r: int, own: list) -> None:
        """Set this process's buckets of round ``r``: on a store client
        with several lanes, that many at once."""
        lanes = getattr(self._kv, "lanes", 1)
        keys = [self._gkey(r, self.rank, b) for b in range(len(own))]
        if lanes == 1 or len(own) == 1:
            for key, data in zip(keys, own):
                self._kv.key_value_set_bytes(key, data)
            return
        with ThreadPoolExecutor(lanes) as pool:
            list(pool.map(self._kv.key_value_set_bytes, keys, own))

    def _host_wire(self, grads) -> np.ndarray:
        """The round's gradient on the host: f32, or on the bf16 wire its
        bf16 bits (int16), rounded where the gradient lives (half the
        bytes to copy off the card; the rounding is torch's on either
        device, ``encode_payload``'s)."""
        leaves = tree_leaves(grads)
        if self.wire == "bf16" and isinstance(leaves[0], torch.Tensor):
            return tree_to_vector(grads).detach().to(torch.bfloat16).view(
                torch.int16).cpu().numpy()
        return _host_vector(grads)

    def _apply_vector(self, state, vec: Optional[np.ndarray]) -> dict:
        """Apply the round's mean vector (local rank 0's; None on its
        peers) through the exact path's update (clip, schedule,
        optimizer, EMA): on a local mesh of several ranks the vector is
        broadcast over it as a tensor (device to device on ``ipc``), and
        on a tp / ep / pp mesh each rank applies its own shard of it.
        Returns the seconds of the broadcast (``bcast_s``) and of the
        host-to-device copy and the update (``h2d_apply_s``)."""
        from akka_allreduce_tpu_torch.models.train import apply_update
        device = tree_leaves(state.params)[0].device
        t0 = time.perf_counter()
        if vec is not None:
            flat = torch.from_numpy(np.ascontiguousarray(vec)).to(device)
        else:
            flat = torch.empty(self._spec.total_size, dtype=torch.float32,
                               device=device)
        times = {}
        if self._local_world > 1:
            t1 = _now(device)
            flat = self.group.broadcast(flat, 0)
            times["bcast_s"] = _now(device) - t1
        tree = vector_to_tree(flat, self._spec)
        if self._sharded:
            from akka_allreduce_tpu_torch.convert import shard_params
            tree = shard_params(tree, self.cfg.model, self.group)
        apply_update(self.cfg, state, tree_leaves(tree), self.group)
        times["h2d_apply_s"] = _now(device) - t0 - times.get("bcast_s", 0.0)
        return times

    def _apply_round(self, state, r: int, rows: list,
                     own: Optional[list], replay: bool = False,
                     times: Optional[dict] = None) -> DcnRoundReport:
        """Mean, apply and record one round (one local rank, or a whole
        local world of one)."""
        vec, rep = self._mean_vector(r, rows, own, replay, times)
        return self._record(state, vec, rep, replay)

    def _record(self, state, vec: Optional[np.ndarray],
                rep: DcnRoundReport, replay: bool) -> DcnRoundReport:
        rep.times.update(self._apply_vector(state, vec))
        self.reports.append(rep)
        self._trace("round_complete", round=rep.round,
                    n_masked=rep.n_masked, n_partial=rep.n_partial,
                    count=sum(rep.valid_peers), replay=replay)
        r = rep.round
        if self.check_every and not (r + 1) % self.check_every:
            t0 = time.perf_counter()
            params = self._full(state.params)  # every local rank
            self._on_lead(lambda: self._publish_checksum(params, r))
            rep.times["checksum_s"] = time.perf_counter() - t0
        return rep

    def param_crc(self, state) -> int:
        """The CRC the replica check publishes: of the whole parameters
        in the JAX global layout (on a local tp / ep / pp mesh gathered,
        a collective over it; at pp > 1 the replicated leaves are local
        rank 0's copy, stage 0's)."""
        return zlib.crc32(_host_vector(self._full(state.params)).tobytes())

    # -- replica-divergence detection -----------------------------------------

    def _publish_checksum(self, params, r: int) -> None:
        """Every ``check_every`` applied rounds publish a CRC of the
        parameters (whole: :meth:`param_crc`'s); the master compares the
        previous check's CRCs (by then a round-lagged peer's has
        landed)."""
        crc = zlib.crc32(_host_vector(params).tobytes())
        self._kv.key_value_set(self._chkkey(r, self.rank), str(crc),
                               allow_overwrite=True)
        if self.master:
            prev = r - self.check_every
            if prev >= self._start_round:
                self._verify_replicas(prev)

    def _verify_replicas(self, r: int) -> None:
        """Compare every published CRC for round ``r`` (absent peers are
        not compared); a mismatch means the replicated updates are no
        longer bit-identical: fail loudly."""
        try:
            entries = self._kv.key_value_dir_get(f"{self.ns}/chk/{r:012d}/")
        except Exception as exc:
            if _is_not_found(exc):
                return
            raise
        crcs = {int(k.rsplit("/", 1)[-1]): v for k, v in entries}
        if len(set(crcs.values())) > 1:
            raise RuntimeError(
                f"replica divergence at round {r}: params checksums "
                f"differ across processes ({crcs}) — the replicated "
                f"optimizer applies are no longer bit-identical "
                f"(heterogeneous hosts or library versions?); halt and "
                f"restart every process from the last checkpoint")

    @property
    def round(self) -> int:
        """The next round this process will run (or replay): drive the
        training loop on this, not a loop counter (a process that caught
        up advances several rounds per call)."""
        return self._round

    @property
    def downed_peers(self) -> tuple:
        """Master: the currently auto-downed ranks (empty on workers)."""
        return tuple(sorted(self._downed))

    def set_ef_state(self, ef_state: Any) -> None:
        """Install the ef8 residual (the TrainState's, restored with the
        checkpoint's ``sync`` item) before the first round; it is updated
        in place every round."""
        if not self._use_ef:
            raise ValueError(
                "set_ef_state needs the default ef8 grad step "
                "(cfg.grad_transport='ef8', no grad_step override)")
        self.ef_state = ef_state

    def set_start_round(self, r: int) -> None:
        """Start counting rounds at ``r`` (checkpoint resume), before the
        first :meth:`run_round`; the quorum barrier applies to the first
        round whatever its number."""
        if self._round != self._start_round:
            raise RuntimeError("set_start_round after rounds already ran")
        self._round = self._start_round = self._cleaned_to = int(r)
        self._frontier = int(r)

    # -- snapshot-rejoin protocol (beyond-retention recovery) -----------------
    #
    # Worker: request_snapshot() -> wait_snapshot() -> restore the published
    # checkpoint -> reset_to_round(step + 1) -> catch_up replays the gap.
    # Master: the CLI sees pending_snapshot_requests(), force-saves its
    # checkpoint at the apply frontier and publish_snapshot_step()s it
    # (reference: AllreduceWorker.scala:87-89, AllreduceSpec.scala:141-172).

    @property
    def _snapkey(self) -> str:
        return f"{self.ns}/snap/step"

    def request_snapshot(self) -> Optional[int]:
        """Ask the master for a fresh checkpoint; returns the currently
        published snapshot step (to wait for a change on)."""
        def ask():
            prev = self._try_get(self._snapkey)
            self._kv.key_value_set(f"{self.ns}/snapreq/{self.rank}", "1",
                                   allow_overwrite=True)
            return int(prev) if prev is not None else None
        return self._on_lead(ask)

    def wait_snapshot(self, prev: Optional[int],
                      timeout_s: float = 120.0) -> int:
        """Wait until the master publishes a snapshot step newer than
        ``prev``; fails fast when the master died or finished (a run that
        ended after serving a final snapshot still hands it out)."""
        def wait():
            deadline = time.monotonic() + timeout_s
            hb_check = self._hb_watch()
            while True:
                s = self._try_get(self._snapkey)
                if s is not None and (prev is None or int(s) != prev):
                    return int(s)
                if self._try_get(self._donekey) is not None:
                    s = self._try_get(self._snapkey)
                    if s is not None and (prev is None or int(s) != prev):
                        return int(s)
                    raise RuntimeError(
                        "the master finished the run while this process "
                        "was stalled — nobody can serve a rejoin "
                        "snapshot; restart from the last checkpoint")
                hb_check()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "master never published a rejoin snapshot — it "
                        "either died or runs without --ckpt-dir; restart "
                        "from the last checkpoint")
                time.sleep(0.05)
        return self._on_lead(wait)

    def pending_snapshot_requests(self) -> list:
        """Master: ranks currently asking for a rejoin snapshot."""
        def scan():
            try:
                entries = self._kv.key_value_dir_get(f"{self.ns}/snapreq/")
            except Exception as exc:
                if _is_not_found(exc):
                    return []
                raise
            return [int(k.rsplit("/", 1)[-1]) for k, _ in entries]
        return self._on_lead(scan)

    def publish_snapshot_step(self, step: int) -> None:
        """Master: announce a force-saved checkpoint at ``step`` and clear
        the requests it serves."""
        if not self._lead:
            return
        try:
            entries = self._kv.key_value_dir_get(f"{self.ns}/snapreq/")
        except Exception as exc:
            if not _is_not_found(exc):
                raise
            entries = []
        for key, _ in entries:
            try:
                self._kv.key_value_delete(key)
            except Exception:
                pass
        self._kv.key_value_set(self._snapkey, str(step),
                               allow_overwrite=True)
        self._trace("snapshot_served", step=step)

    def reset_to_round(self, r: int) -> None:
        """Rebase at round ``r`` after a snapshot restore (the caller
        restored the state the master published): drops the stale
        in-flight window. Payloads published before the stall age out
        through the normal sweep (other stragglers may still replay
        them)."""
        self._pending.clear()
        self._round = int(r)
        self._trace("rejoin_rebase", round=int(r))

    # -- catch-up after a stall -----------------------------------------------

    def catch_up(self, state) -> int:
        """Replay the rounds the cluster completed while this process was
        stalled (fetch and apply, no gradient): the replayed updates equal
        the survivors' exactly. Returns the rounds replayed."""
        if self.master:
            return 0
        cur_s = self._on_lead(lambda: self._try_get(self._roundkey))
        if cur_s is None or int(cur_s) <= self._round:
            return 0
        cur = int(cur_s)
        # flush the in-flight rounds first: their masks exist now
        while self._pending:
            self.harvest(state)
        # a 4-round margin against the survivors' concurrent collection
        if self._round < cur - self.retain + 4:
            raise StalledBeyondRetention(
                f"stalled for {cur - self._round} rounds, beyond the "
                f"{self.retain}-round retention window — rejoin needs a "
                f"checkpoint (snapshot protocol via the CLI, or restart "
                f"from the last checkpoint)", current_round=cur)
        self._ensure_apply(state.params)
        replayed = 0
        while self._round < cur:
            r = self._round

            def replay():
                mask_s = self._try_get(self._maskkey(r))
                if mask_s is None:
                    return None  # the master is mid-round r
                return self._mean_vector(r, self._parse_mask(mask_s),
                                         own=None, replay=True)
            got = self._on_lead(replay, share=_report_only)
            if got is None:
                break
            self._record(state, got[0], got[1], replay=True)
            self._round += 1
            replayed += 1
        if replayed:
            self.reports[-1] = dataclasses.replace(self.reports[-1],
                                                   caught_up=replayed)
            self._trace("catch_up", replayed=replayed,
                        resumed_at=self._round)
        return replayed

    # -- the public round -----------------------------------------------------

    def run_round(self, state, tokens) -> Optional[DcnRoundReport]:
        """One cross-process round: local grad step -> publish the wire
        chunks -> arrival report -> mask -> per-bucket masked mean ->
        the update, applied to ``state`` in place. Runs exactly round
        ``self.round`` (call :meth:`catch_up` first after a possible
        stall). With ``max_lag > 0`` this publishes round r and applies
        round r - max_lag; while the window fills it returns None (call
        :meth:`drain` after the last round).

        The report's ``times`` hold this process's seconds in the round's
        phases: ``grad_s`` (the local step, to its device work's end),
        ``flatten_d2h_s``, ``encode_s``, ``set_s`` with ``set_bytes``,
        ``mask_wait_s`` (from the arrival report to the mask in hand; on
        the master from its own publish), ``fetch_s`` with
        ``fetch_bytes``, ``decode_mean_s``, ``h2d_apply_s`` and
        ``checksum_s`` (the replica check's CRC; ~0 in a round without
        one)."""
        r = self._round
        if self.master and self._lead:
            self._kv.key_value_set(self._roundkey, str(r),
                                   allow_overwrite=True)
        self._ensure_apply(state.params)
        if self._use_ef and self.ef_state is None:
            self.ef_state = state.residual
        device = tree_leaves(state.params)[0].device
        t0 = _now(device)
        grads, metrics = self._gstep(state.params, tokens, r)
        times = {"grad_s": _now(device) - t0}
        if self._sharded:
            # the wire is the whole tree (JAX's global gradient): every
            # local rank takes part in the all-gathers
            t0 = time.perf_counter()
            grads = self._full(grads)
            times["gather_s"] = _now(device) - t0
        own = None
        if self._lead:
            t0 = time.perf_counter()
            vec = self._host_wire(grads)
            loss = float(metrics["loss"])
            toks = float(metrics["tokens"])
            times["flatten_d2h_s"] = time.perf_counter() - t0
            del grads
            # encode every bucket, then publish them (in order on one
            # connection, or across the store client's lanes), and report
            # after the last has landed: a publish cut anywhere leaves the
            # buckets that landed for the master's probe to credit.
            # Per-(round, rank, bucket) seeds keep the int8 wire's rounding
            # unbiased across rounds
            t1 = time.perf_counter()
            own = []
            for b in range(self._n_chunks):
                lo, hi = self._chunk_bounds(b)
                if vec.dtype == np.int16:  # bf16 bits, rounded on the device
                    own.append(b"".join((
                        _HDR.pack(loss, int(toks), _WIRE_BF16), vec[lo:hi])))
                else:
                    own.append(encode_payload(
                        vec[lo:hi], loss, toks, self.wire,
                        seed=(r * self.nprocs + self.rank) * self._n_chunks
                        + b))
            t2 = time.perf_counter()
            self._publish(r, own)
            times.update(encode_s=t2 - t1, set_s=time.perf_counter() - t2,
                         set_bytes=float(sum(len(d) for d in own)))
            if not self.master:
                self.router.send(self.router.ref_of(0),
                                 CompleteAllreduce(src_id=self.rank,
                                                   round=r))
            times["reported_at"] = time.perf_counter()
        self._pending.append((r, own, times))
        self._round += 1
        if len(self._pending) >= self._window:
            return self.harvest(state)
        return None

    @property
    def in_flight(self) -> int:
        """Rounds published but not yet applied."""
        return len(self._pending)

    def harvest(self, state) -> DcnRoundReport:
        """Apply the oldest in-flight round: collect (master) or read its
        mask, mean the contributors, update ``state``. Returns its
        report."""
        r0, own0, times = self._pending.pop(0)

        def mean():
            t0 = times.pop("reported_at", time.perf_counter())
            rows = (self._master_collect(r0) if self.master
                    else self._read_mask(r0))
            times["mask_wait_s"] = time.perf_counter() - t0
            return self._mean_vector(r0, rows, own0, times=times)
        vec, rep = self._on_lead(mean, share=_report_only)
        rep = self._record(state, vec, rep, replay=False)
        if self._lead:
            self._cleanup(r0)
        return rep

    def drain(self, state) -> list:
        """Apply every in-flight round (after the last ``run_round``);
        returns their reports."""
        reps = []
        while self._pending:
            reps.append(self.harvest(state))
        return reps

    def _cleanup(self, r: int) -> None:
        """Delete this process's payloads and checksums (and, on the
        master, masks) that fell out of retention, as a range from the
        last sweep (catch_up can jump the round forward)."""
        old = r - self.retain
        if old < self._cleaned_to:
            return
        for rr in range(self._cleaned_to, old + 1):
            for b in range(self._n_chunks):
                try:
                    self._kv.key_value_delete(self._gkey(rr, self.rank, b))
                except Exception:
                    pass
            if self.check_every and not (rr + 1) % self.check_every:
                try:
                    self._kv.key_value_delete(self._chkkey(rr, self.rank))
                except Exception:
                    pass
            if self.master:
                try:
                    self._kv.key_value_delete(self._maskkey(rr))
                except Exception:
                    pass
        self._cleaned_to = old + 1

    @property
    def masked_round_count(self) -> int:
        return sum(1 for rep in self.reports if rep.n_masked)

    def close(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if not self._lead:
            return
        if self.master:
            # the end-of-run marker: a straggler waking after it fails fast
            try:
                self._kv.key_value_set(self._donekey, "1",
                                       allow_overwrite=True)
            except Exception:
                pass
        self.router.close()
