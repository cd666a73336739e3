"""Deterministic in-process message transport.

Counterpart of ``akka_allreduce_tpu/protocol/transport.py``, copied as it
is (pure Python). It replaces the reference's Akka remoting/mailbox
runtime (reference: application.conf:1-21; SURVEY.md §1 L1) with an
explicit router: each actor owns a FIFO mailbox; a deterministic pump
drains mailboxes round-robin in registration order. Delivery guarantees
match what the protocol relies on — FIFO per sender-receiver pair,
at-most-once — and a *probe* (a mailbox with no handler) reproduces the
forged-peer testing trick the reference uses (reference:
AllreduceSpec.scala:812-818): a worker whose peer map points at the
probe exposes its entire outbound traffic to assertions.

Messages are handed over by reference: a payload tensor stays on the
device it was made on, and the receiver's buffer copies it from there.
(``protocol/tcp.py`` carries the same surface between processes over
TCP, and ``protocol/kv.py`` through the coordinator's key-value store.)
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Optional


class ActorRef:
    """An opaque routing handle (the reference's ActorRef)."""

    _counter = itertools.count()

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"actor-{next(self._counter)}"

    def __repr__(self) -> str:
        return f"<ref {self.name}>"


class Router:
    """Mailbox registry + deterministic message pump."""

    def __init__(self):
        self._mailboxes: dict[ActorRef, deque] = {}
        self._handlers: dict[ActorRef, Callable[[Any], None]] = {}
        self._order: list[ActorRef] = []

    def register(self, name: Optional[str] = None,
                 handler: Optional[Callable[[Any], None]] = None) -> ActorRef:
        """Create a ref. With a handler, the pump dispatches its mail; without
        one the mailbox accumulates (a probe)."""
        ref = ActorRef(name)
        self._mailboxes[ref] = deque()
        self._order.append(ref)
        if handler is not None:
            self._handlers[ref] = handler
        return ref

    def set_handler(self, ref: ActorRef,
                    handler: Callable[[Any], None]) -> None:
        self._handlers[ref] = handler

    def unregister(self, ref: ActorRef) -> None:
        self._mailboxes.pop(ref, None)
        self._handlers.pop(ref, None)
        if ref in self._order:
            self._order.remove(ref)

    def send(self, ref: ActorRef, msg: Any) -> None:
        """Enqueue only — processing happens in :meth:`pump`. Messages to
        unknown (terminated) refs are dropped, matching Akka dead letters."""
        box = self._mailboxes.get(ref)
        if box is not None:
            box.append(msg)

    def mailbox(self, ref: ActorRef) -> deque:
        return self._mailboxes[ref]

    def pump(self, max_messages: int = 1_000_000,
             strict: bool = True) -> int:
        """Drain all handler-owned mailboxes deterministically: one message
        per actor per sweep, in registration order (a fair, reproducible
        stand-in for Akka's concurrent-but-FIFO dispatch). Self-sends land at
        the back of the sender's own mailbox, exactly like an actor
        re-enqueueing to itself. Returns messages processed. Hitting the
        cap raises when ``strict`` (a re-queue loop — uninitialized worker?)
        and simply returns otherwise (incremental drivers pump in bites)."""
        processed = 0
        while True:
            progressed = False
            for ref in list(self._order):
                handler = self._handlers.get(ref)
                if handler is None:
                    continue
                box = self._mailboxes.get(ref)
                if box:
                    msg = box.popleft()
                    handler(msg)
                    processed += 1
                    progressed = True
                    if processed >= max_messages:
                        if strict:
                            raise RuntimeError(
                                f"router pump exceeded {max_messages} "
                                "messages — likely a re-queue loop "
                                "(uninitialized worker?)")
                        return processed
            if not progressed:
                return processed


    def pump_scheduled(self, choose: Callable[[list, int], "ActorRef"],
                       max_messages: int = 1_000_000,
                       strict: bool = True) -> int:
        """Adversarial-schedule pump: at every step ``choose(ready, step)``
        picks WHICH actor delivers its next message, from the list of
        actors with non-empty handler-owned mailboxes (registration
        order). FIFO per mailbox — the delivery guarantee the protocol
        relies on — is preserved; only the cross-actor interleaving
        varies, which is exactly the nondeterminism a concurrent actor
        dispatcher exhibits in production and the round-robin
        :meth:`pump` hides. The schedule explorer
        (protocol/explorer.py) drives this with random, starvation, and
        exhaustive-prefix schedules to check protocol invariants across
        orderings. Runs until quiescent; budget semantics match
        :meth:`pump`."""
        processed = 0
        while True:
            ready = [r for r in self._order
                     if self._handlers.get(r) is not None
                     and self._mailboxes.get(r)]
            if not ready:
                return processed
            ref = choose(ready, processed)
            self._handlers[ref](self._mailboxes[ref].popleft())
            processed += 1
            if processed >= max_messages:
                if strict:
                    raise RuntimeError(
                        f"scheduled pump exceeded {max_messages} "
                        "messages — likely a re-queue loop")
                return processed


class Probe:
    """A recording endpoint for protocol tests: poses as any number of peers
    and exposes what the unit under test sent
    (reference: AllreduceSpec.scala:8, :812-818)."""

    def __init__(self, router: Router, name: str = "probe"):
        self.router = router
        self.ref = router.register(name)

    def receive_one(self) -> Any:
        """Pump until delivery, then pop the oldest message."""
        self.router.pump()
        box = self.router.mailbox(self.ref)
        if not box:
            raise AssertionError("probe expected a message, mailbox is empty")
        return box.popleft()

    def expect_no_msg(self) -> None:
        self.router.pump()
        box = self.router.mailbox(self.ref)
        if box:
            raise AssertionError(
                f"probe expected silence, got {list(box)!r}")

    def drain(self) -> list:
        self.router.pump()
        box = self.router.mailbox(self.ref)
        out = list(box)
        box.clear()
        return out
