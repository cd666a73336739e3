"""Schedule exploration — a race detector for the protocol plane.

Counterpart of ``akka_allreduce_tpu/protocol/explorer.py``. The digest
of a cluster's state hashes each payload tensor's bytes, dtype and
shape (one host copy per tensor: fine at the sizes schedules are
explored at); everything else is the JAX module as it is.

The deterministic router (transport.py) makes every run REPRODUCIBLE;
this module makes the cross-actor delivery order an INPUT. The protocol's
correctness story rests on order-independent invariants — the ``==``
exactly-once threshold fires, ``output == N x input`` at full thresholds,
honest sub-N counts under loss, no round stalls from any legal
interleaving — and those claims are only as strong as the set of
orderings they were checked under. The reference exercises exactly one
ordering (its AllreduceSpec runs under Akka's single-threaded test
dispatcher; reference: AllreduceSpec.scala:1-30), so a message race that
only bites when worker B's scatter overtakes worker A's reduce would
pass its suite. Here the same cluster runs under families of adversarial
schedules (``Router.pump_scheduled``):

* **random**: seeded uniform choice among ready actors — a different
  full-cluster interleaving per seed;
* **starvation**: one actor's mail is delayed as long as ANY other actor
  has work — the message-plane rendering of a GC-paused / descheduled /
  slow-NIC peer (the same adversary the deadline machinery exists for);
* **exhaustive prefixes**: every possible delivery choice for the first
  K steps — the window where registration, quorum formation, and the
  round-0 scatter race — then deterministic rotation.

A failure reproduces by construction: the schedule is the label.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from collections import deque, namedtuple
from itertools import product
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.protocol.transport import ActorRef, Router

# choose(ready_actors, step_index) -> the actor that delivers next
Chooser = Callable[[list, int], ActorRef]


def random_schedule(seed: int) -> Chooser:
    """Uniform choice among ready actors, deterministic in ``seed``."""
    rng = random.Random(seed)

    def choose(ready: list, _step: int) -> ActorRef:
        return ready[rng.randrange(len(ready))]

    return choose


def starvation_schedule(victim_name: str) -> Chooser:
    """Deliver to ``victim_name`` only when nobody else has mail: the
    victim's handler runs as late as a fair dispatcher could ever make
    it, so anything that silently assumed its timeliness breaks."""

    def choose(ready: list, _step: int) -> ActorRef:
        for ref in ready:
            if ref.name != victim_name:
                return ref
        return ready[0]

    return choose


def rotation_schedule(stride: int) -> Chooser:
    """Fixed rotation with a stride through the ready set — cheap
    structured coverage between random seeds (stride 1 is close to the
    production round-robin pump)."""

    def choose(ready: list, step: int) -> ActorRef:
        return ready[(step * stride) % len(ready)]

    return choose


def prefix_schedule(prefix: tuple) -> Chooser:
    """Scripted first ``len(prefix)`` choices (each an index into the
    ready set, modulo its size), rotation after. With
    :func:`exhaustive_prefixes` this enumerates EVERY reachable delivery
    order over the first K steps."""

    def choose(ready: list, step: int) -> ActorRef:
        if step < len(prefix):
            return ready[prefix[step] % len(ready)]
        return ready[step % len(ready)]

    return choose


def exhaustive_prefixes(depth: int, width: int
                        ) -> Iterator[tuple[str, Chooser]]:
    """All ``width ** depth`` scripted prefixes of length ``depth``.
    ``width`` bounds the ready-set size worth distinguishing (a cluster
    of master + n workers has at most n+1 ready actors; indices wrap, so
    width >= the true maximum loses nothing and duplicates nothing that
    changes behavior)."""
    for p in product(range(width), repeat=depth):
        yield f"prefix{p}", prefix_schedule(p)


def standard_schedules(actor_names: Iterable[str], seeds: int = 50
                       ) -> Iterator[tuple[str, Chooser]]:
    """The default battery: per-actor starvation, a stride sweep, and
    ``seeds`` random interleavings."""
    for name in actor_names:
        yield f"starve:{name}", starvation_schedule(name)
    for stride in (1, 2, 3, 5, 7):
        yield f"rotation:stride{stride}", rotation_schedule(stride)
    for s in range(seeds):
        yield f"random:seed{s}", random_schedule(s)


@dataclasses.dataclass
class ScheduleFailure:
    """One schedule under which the cluster violated an invariant."""
    label: str
    error: str

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"[{self.label}] {self.error}"


def explore(make_cluster: Callable[[], object],
            schedules: Iterable[tuple[str, Chooser]],
            validate: Callable[[object], None],
            prepare: Optional[Callable[[object], None]] = None,
            budget: Optional[int] = None) -> list[ScheduleFailure]:
    """Run a fresh cluster under every schedule and collect invariant
    violations.

    ``make_cluster`` builds a LocalCluster (or anything with ``start()``
    and a ``router``); ``prepare`` runs after registration (kill a
    worker, inject a probe); ``validate`` raises on any violated
    invariant after the pump drains. Exceptions from handlers themselves
    (a gate double-fired, an assertion inside a sink) are failures of
    that schedule too, not of the harness — they land in the returned
    list with the schedule's reproducing label. The runaway cap defaults
    to the cluster's own workload-scaled ``_message_budget()`` (a fixed
    cap would cry wolf on big healthy configs whose legitimate traffic
    exceeds it — that is exactly why LocalCluster scales its budget).
    """
    failures = []
    for label, chooser in schedules:
        cluster = make_cluster()
        cap = budget if budget is not None else getattr(
            cluster, "_message_budget", lambda: 1_000_000)()
        try:
            cluster.start()
            if prepare is not None:
                prepare(cluster)
            cluster.router.pump_scheduled(chooser, max_messages=cap)
            validate(cluster)
        except Exception as exc:
            failures.append(ScheduleFailure(
                label, f"{type(exc).__name__}: {exc}"))
    return failures


# -- exhaustive-prefix mode with canonical state dedup --------------------

#: Attributes that are harness plumbing or wall-clock artifacts, not
#: protocol state — excluded from the canonical digest (``tic`` /
#: ``rates_mbps`` are perf_counter readings: identical protocol states
#: reached at different times must collapse to one node).
_DIGEST_SKIP = frozenset({
    "router", "tracer", "data_source", "data_sink", "on_round_complete",
    "on_member", "on_terminated", "tic", "rates_mbps", "verbose",
})


def _canon(obj, seen):
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, torch.Tensor):
        host = obj.detach().cpu().contiguous()
        raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
        return ("tensor", str(host.dtype), tuple(host.shape),
                hashlib.blake2b(raw, digest_size=16).hexdigest())
    if isinstance(obj, np.ndarray):
        return ("nd", obj.dtype.str, obj.shape,
                hashlib.blake2b(np.ascontiguousarray(obj).tobytes(),
                                digest_size=16).hexdigest())
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, ActorRef):
        # refs are freshly numbered per cluster; the NAME is the
        # canonical identity that is stable across replays
        return ("ref", obj.name)
    if isinstance(obj, (list, tuple, deque)):
        return tuple(_canon(x, seen) for x in obj)
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            (repr(_canon(k, seen)), _canon(v, seen))
            for k, v in obj.items())))
    if isinstance(obj, (set, frozenset)):
        return ("set", tuple(sorted(repr(_canon(x, seen))
                                    for x in obj)))
    if callable(obj) and not hasattr(obj, "__dict__"):
        return ("fn", getattr(obj, "__name__", "?"))
    if id(obj) in seen:
        return ("cycle",)
    seen = seen | {id(obj)}
    d = getattr(obj, "__dict__", None)
    if d is not None:
        return (type(obj).__name__, tuple(
            (k, _canon(v, seen)) for k, v in sorted(d.items())
            if k not in _DIGEST_SKIP and not callable(v)))
    return ("opaque", type(obj).__name__)


def state_digest(cluster) -> str:
    """A canonical hash of the cluster's COMPLETE protocol state:
    master, every worker (ids, rounds, buffers — payload tensors by
    content hash), and every pending mailbox in delivery order.  Two
    interleavings that reach byte-identical protocol configurations get
    the same digest, whatever order got them there; wall-clock
    artifacts and harness plumbing are excluded."""
    router: Router = cluster.router
    mail = tuple(
        (ref.name, _canon(tuple(router.mailbox(ref)), frozenset()))
        for ref in router._order if router._mailboxes.get(ref))
    body = (
        _canon(getattr(cluster, "master", None), frozenset()),
        tuple(_canon(w, frozenset())
              for w in getattr(cluster, "workers", ())),
        mail,
    )
    return hashlib.blake2b(repr(body).encode(),
                           digest_size=16).hexdigest()


PrefixReport = namedtuple("PrefixReport", [
    "prefixes_total",    # width ** depth: the naive leaf count
    "prefixes_run",      # full runs actually validated
    "prefixes_deduped",  # subtree prunes (digest already visited)
    "visited_states",    # distinct canonical states encountered
])


def explore_exhaustive(make_cluster: Callable[[], object],
                       validate: Callable[[object], None],
                       depth: int, width: int,
                       prepare: Optional[Callable[[object], None]] = None,
                       budget: Optional[int] = None,
                       digest: Callable[[object], str] = state_digest,
                       ) -> tuple[list[ScheduleFailure], PrefixReport]:
    """Exhaustive-prefix exploration with canonical state-hash dedup.

    Walks the delivery-choice tree of the first ``depth`` steps
    (``width`` choices per step, indices wrapping over the ready set —
    the same prefix space as :func:`exhaustive_prefixes`), but prunes
    any node whose :func:`state_digest` was already reached by another
    prefix: the continuation is a deterministic function of cluster
    state, so an identical mid-state proves the whole subtree —
    including its leaf validations — is a duplicate.  Wrapped sibling
    indices and order-insensitive message races collapse this way,
    typically cutting the leaf count by an order of magnitude while
    checking the SAME set of reachable behaviors.

    Each surviving leaf (or early-quiescent node) continues with the
    deterministic rotation :func:`prefix_schedule` uses after its
    script — the continuation chooser offsets the step index by the
    consumed prefix length, because ``pump_scheduled`` resets its step
    counter per call — then ``validate`` runs.  Returns
    ``(failures, PrefixReport)``; the visited-state counter is the
    dedup's audit trail (reported, never silent).

    Caveat: the default digest hashes PROTOCOL state (engines +
    mailboxes), not sink history — a validator that asserts on what
    was already flushed during the prefix window should pass a custom
    ``digest`` that folds the sink contents in, or two interleavings
    that flushed differently but converged internally would collapse.
    """
    failures: list[ScheduleFailure] = []
    seen: set[str] = set()
    n_run = n_dedup = 0
    stack: list[tuple] = [()]
    while stack:
        p = stack.pop()
        label = f"prefix{p}"
        cluster = make_cluster()
        cap = budget if budget is not None else getattr(
            cluster, "_message_budget", lambda: 1_000_000)()
        try:
            cluster.start()
            if prepare is not None:
                prepare(cluster)
            delivered = cluster.router.pump_scheduled(
                prefix_schedule(p), max_messages=len(p),
                strict=False) if p else 0
            key = digest(cluster)
            if key in seen:
                n_dedup += 1
                continue
            seen.add(key)
            if delivered < len(p) or len(p) >= depth:
                # early quiescence (the run already completed inside
                # the prefix window) or a leaf: finish deterministically
                # and validate.  The offset keeps the continuation
                # identical to prefix_schedule's own rotation tail.
                off = delivered
                cluster.router.pump_scheduled(
                    lambda ready, step: ready[(step + off) % len(ready)],
                    max_messages=cap)
                n_run += 1
                validate(cluster)
            else:
                stack.extend(p + (i,) for i in range(width))
        except Exception as exc:
            n_run += 1
            failures.append(ScheduleFailure(
                label, f"{type(exc).__name__}: {exc}"))
    return failures, PrefixReport(width ** depth, n_run, n_dedup,
                                  len(seen))
