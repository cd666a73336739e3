"""Page-pool KV memory management for the paged serving engine (host plane).

The port's own copy of ``akka_allreduce_tpu/serving/paging.py``, whole
and unchanged in behaviour: the same seeded admits, splits and releases
give the same page ids in both packages (tests/test_torch_paging.py).
The text below is the original's.

The slot engine (serving/engine.py ``ServingEngine``) reserves
``max_seq`` KV positions per slot for every request regardless of its
actual length — concurrency is capped at ``num_slots`` and short
requests strand most of their reservation. This module is the host half
of the vLLM-style answer: KV HBM becomes one flat pool of fixed-size
PAGES (``init_kv_pool`` in models/generate.py owns the device arrays),
each request holds an int32 PAGE TABLE mapping its logical positions to
pool pages, and this allocator owns which page belongs to whom:

* **free list** — allocation is a stack pop, release a push; the pool
  never compacts (page indirection makes fragmentation internal-only:
  the wasted bytes are the unwritten tail of each request's last page
  plus its not-yet-decoded reservation, both surfaced as the
  ``fragmentation`` metric).
* **refcounts** — a page may back several requests (shared prompt
  prefixes); it returns to the free list when the last holder releases
  it.
* **prefix registry** — pages whose content is fully determined by a
  position-aligned prompt prefix register under an exact content key
  (the token prefix itself — no hash collisions to reason about; the
  prefixes are tiny next to host RAM). A later admission whose prompt
  matches reuses the page (refcount++) instead of allocating: N
  requests with one system prompt pay its KV once. Full prompt pages
  are immutable for the request's lifetime (decode writes land at
  positions past the prompt), so sharing them is copy-free forever.
* **copy-on-write** — the partially-filled TAIL page of a prompt is
  shareable too (identical full prompts — the benchmark-farm load),
  but decode WILL write into it (the first generated token's KV lands
  at ``len(prompt)``). A shared tail page therefore splits on the
  first divergent write: the writer takes a page from the tail's SPARE
  pile, device-copies the content (the engine's ``_copy_page``
  program), points its table at the copy, and drops its reference; the
  last holder left writes in place after the registry entry (about to
  go stale) is dropped.

The spare pile is the OOM-proofing detail: every admission that SHARES
a tail page allocates one spare for it up front, while its own
admission-gate capacity check still holds. Splits happen later, under
whatever load arrived since — a split that had to allocate then could
find the free list empty, failing a request that admission promised
could finish. Invariant (fuzz-pinned): a tail page with refcount r
carries exactly r - 1 spares, so every possible split is pre-paid no
matter which holder writes first.

Everything here is pure host Python — no jax import, unit- and
fuzz-testable in microseconds (tests/test_paging.py pins refcount
conservation, post-split aliasing freedom, spare accounting, and
full-drain recovery). The device arrays the page ids index into live
with the engine; the allocator never touches them.

Admission math (the free-page signal the scheduler consumes): a request
needs ``ceil((len(prompt) + max_new_tokens) / page_size)`` pages end to
end. The paged engine reserves them ALL at admission — conservative,
but it makes admitted == completable (no mid-decode OOM, no swap/
preempt machinery) and it is exactly the threshold judgment the
reference protocol makes: don't start a round you cannot finish.
Shared prefix pages subtract from the bill; a shared tail does not
(its slot in the bill pays for the spare).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` logical positions."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """One request's page bill, priced before any state changes.

    ``total_pages`` is the end-to-end reservation (prompt + full decode
    budget); ``shared_full`` / ``tail_shared`` say which of the
    prompt's pages an earlier admission already holds. ``fresh_pages``
    is what the free list must cover — the admission gate's number
    (a shared tail still bills one fresh page: its COW spare). The plan
    is a quote: :meth:`PagePool.admit` re-derives it, so a stale quote
    can never double-spend."""

    total_pages: int
    shared_full: int
    tail_shared: bool
    fresh_pages: int


class PagePool:
    """Host-side allocator for a ``num_pages`` x ``page_size`` KV pool.

    The engine calls :meth:`plan` / :meth:`can_admit` (admission gate),
    :meth:`admit` (allocate + share a request's pages),
    :meth:`split_for_write` (the COW write protocol), and
    :meth:`release_all` (free a finished request's table). Counters are
    cumulative over the pool's lifetime — the prefix-hit and COW series
    the metrics plane exports.

    ``scratch_pages`` pins the first N page ids as permanently
    allocated, never handed out and excluded from capacity: the paged
    engine reserves page 0 as the garbage sink its parked (free) decode
    lanes write through — their page-table rows are all zeros, so
    without the reservation a parked lane's dummy write would corrupt
    whichever request happened to own page 0."""

    def __init__(self, num_pages: int, page_size: int,
                 scratch_pages: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if scratch_pages < 0:
            raise ValueError(
                f"scratch_pages must be >= 0, got {scratch_pages}")
        if num_pages - scratch_pages < 1:
            raise ValueError(
                f"need >= 1 allocatable page, got {num_pages} total - "
                f"{scratch_pages} scratch")
        self.num_pages = num_pages
        self.page_size = page_size
        self.scratch_pages = scratch_pages
        # stack: low page ids hand out first (deterministic tests)
        self._free = list(range(num_pages - 1, scratch_pages - 1, -1))
        self._ref = [0] * num_pages
        for p in range(scratch_pages):
            self._ref[p] = 1  # permanently held, never released
        # exact-content prefix registry (module docstring): key -> page
        self._by_key: dict = {}
        self._key_of: dict = {}  # page -> key (for unregister-on-free)
        # shared-tail COW spare piles: page -> [pre-paid split targets]
        self._spares: dict = {}
        # -- cumulative counters (metrics plane) ------------------------
        self.prefix_lookups = 0  # full prompt pages priced at admit
        self.prefix_hits = 0     # ... that an earlier admission held
        self.cow_splits = 0
        self.pages_allocated_total = 0
        self.pages_shared_total = 0  # refcount++ acquisitions

    # -- introspection --------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.num_pages - self.scratch_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def is_shared(self, page: int) -> bool:
        return self._ref[page] > 1

    def is_registered(self, page: int) -> bool:
        return page in self._key_of

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of full prompt pages served by sharing instead of
        allocation — the 'system prompts are the production norm'
        payoff number (0.0 before any lookup)."""
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)

    # -- key construction ----------------------------------------------

    @staticmethod
    def _full_key(tokens: tuple, page_index: int, page_size: int):
        """A FULL prompt page's content key: the position-aligned token
        prefix through this page. Exact content, exact position — two
        prompts share page k iff their first (k+1)*P tokens agree,
        which is precisely when the page's K/V (position-dependent via
        rope) are bitwise interchangeable."""
        return ("full", tokens[:(page_index + 1) * page_size])

    @staticmethod
    def _tail_key(tokens: tuple):
        """The partial tail page's key: the WHOLE prompt (content +
        length). Only identical prompts share a tail — and only until
        the first decode write (COW)."""
        return ("tail", tokens)

    # -- admission ------------------------------------------------------

    def plan(self, prompt: tuple, max_new_tokens: int,
             count: bool = False, share: bool = True) -> AdmitPlan:
        """Price a request without changing any state. ``count=False``
        (the admission-gate poll) leaves the prefix-hit counters alone;
        :meth:`admit` prices with ``count=True`` so the exported rate
        reflects admissions, not gate polls. ``share=False`` prices a
        no-sharing pool (every page fresh; the speculative engine's
        draft pool — see :meth:`admit`)."""
        n = len(prompt)
        total = pages_for(n + max_new_tokens, self.page_size)
        if not share:
            return AdmitPlan(total_pages=total, shared_full=0,
                             tail_shared=False, fresh_pages=total)
        full = n // self.page_size
        shared_full = 0
        for k in range(full):
            if count:
                self.prefix_lookups += 1
            if self._full_key(prompt, k, self.page_size) in self._by_key:
                shared_full += 1
                if count:
                    self.prefix_hits += 1
        tail_shared = (n % self.page_size != 0
                       and self._tail_key(prompt) in self._by_key)
        # a shared tail bills fresh anyway: the refcount++ is free but
        # the spare (its guaranteed COW split target) is not
        return AdmitPlan(total_pages=total, shared_full=shared_full,
                         tail_shared=tail_shared,
                         fresh_pages=total - shared_full)

    def can_admit(self, prompt: tuple, max_new_tokens: int,
                  share: bool = True) -> bool:
        """The admission gate: will :meth:`admit` succeed right now?"""
        return self.plan(prompt, max_new_tokens,
                         share=share).fresh_pages <= self.free_pages

    def admit(self, prompt: tuple, max_new_tokens: int,
              share: bool = True) -> "tuple[list, list]":
        """Allocate/share the request's end-to-end page list.

        Returns ``(pages, prefill_writes)``: ``pages`` is the full
        page-table row (one id per logical page through prompt +
        budget); ``prefill_writes`` flags, per PROMPT page, whether the
        content is fresh (False = an earlier admission's shared page —
        the engine still prefill-writes it, identical bytes by the key
        construction, to keep one compiled program per prompt length;
        the flag is the HBM-saving accounting). A shared tail page gets
        a spare pushed onto its pile (module docstring). Raises
        RuntimeError when the free list cannot cover the bill — callers
        gate on :meth:`can_admit` / :meth:`plan` first.

        ``share=False`` allocates every page fresh and registers
        NOTHING — the speculative engine's draft pool, whose block
        writes would otherwise land on shared/registered pages the
        device COW copy does not cover. The prefix counters stay
        untouched so the exported hit rate keeps describing the
        sharing pool only."""
        plan = self.plan(prompt, max_new_tokens, count=share,
                         share=share)
        if plan.fresh_pages > self.free_pages:
            raise RuntimeError(
                f"page pool exhausted: need {plan.fresh_pages} fresh "
                f"pages, have {self.free_pages} (gate admission on "
                f"can_admit)")
        if not share:
            pages = [self._alloc() for _ in range(plan.total_pages)]
            return pages, [True] * (pages_for(len(prompt),
                                              self.page_size))
        n = len(prompt)
        full = n // self.page_size
        pages: list = []
        writes: list = []
        for k in range(full):
            key = self._full_key(prompt, k, self.page_size)
            page = self._by_key.get(key)
            if page is not None:
                self._ref[page] += 1
                self.pages_shared_total += 1
                pages.append(page)
                writes.append(False)
            else:
                page = self._alloc()
                self._register(key, page)
                pages.append(page)
                writes.append(True)
        if n % self.page_size:
            key = self._tail_key(prompt)
            page = self._by_key.get(key)
            if page is not None:
                self._ref[page] += 1
                self.pages_shared_total += 1
                pages.append(page)
                writes.append(False)
                # pre-pay this holder's eventual COW split
                self._spares.setdefault(page, []).append(self._alloc())
            else:
                page = self._alloc()
                self._register(key, page)
                pages.append(page)
                writes.append(True)
        while len(pages) < plan.total_pages:
            pages.append(self._alloc())  # decode pages: never registered
        return pages, writes

    # -- write-time protocol (COW) --------------------------------------

    def split_for_write(self, page: int) -> Optional[int]:
        """The about-to-write protocol for one page. Three cases:

        * shared (refcount > 1): COW — pop the pre-paid spare, move the
          caller's reference onto it, return the new id; the caller
          owns the device copy and its table update.
        * registered but exclusively held: the write is about to
          invalidate the registered content — unregister, return None
          (write in place).
        * plain private page: no-op, return None.
        """
        if self._ref[page] > 1:
            pile = self._spares.get(page)
            # spares == refcount - 1 by the admit/release invariant, so
            # a shared page always has one; the fallback allocation is
            # belt-and-braces for direct (non-engine) pool users
            new = pile.pop() if pile else self._alloc()
            if pile is not None and not pile:
                del self._spares[page]
            self._ref[page] -= 1
            self.cow_splits += 1
            return new
        if page in self._key_of:
            self._unregister(page)
        return None

    # -- release --------------------------------------------------------

    def release(self, page: int) -> None:
        if page < self.scratch_pages:
            raise RuntimeError(f"release of scratch page {page}")
        if self._ref[page] < 1:
            raise RuntimeError(f"release of page {page} with refcount "
                               f"{self._ref[page]}")
        self._ref[page] -= 1
        # a holder leaving un-split (eviction / failure before its
        # first decode write) strands a spare — trim the pile back to
        # refcount - 1 so abandoned reservations return to the pool
        pile = self._spares.get(page)
        while pile and len(pile) > max(0, self._ref[page] - 1):
            spare = pile.pop()
            self._ref[spare] = 0
            self._free.append(spare)
        if pile is not None and not pile:
            del self._spares[page]
        if self._ref[page] == 0:
            if page in self._key_of:
                self._unregister(page)
            self._free.append(page)

    def release_all(self, pages: "list[int]") -> None:
        for p in pages:
            self.release(p)

    # -- internals ------------------------------------------------------

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted")
        page = self._free.pop()
        assert self._ref[page] == 0
        self._ref[page] = 1
        self.pages_allocated_total += 1
        return page

    def _register(self, key, page: int) -> None:
        self._by_key[key] = page
        self._key_of[page] = key

    def _unregister(self, page: int) -> None:
        key = self._key_of.pop(page)
        if self._by_key.get(key) == page:
            del self._by_key[key]

    def check_invariants(self) -> None:
        """The fuzz harness's oracle (tests/test_paging.py): refcount /
        free-list / registry / spare-pile consistency, every call."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates")
        spare_ids = [s for pile in self._spares.values() for s in pile]
        if len(spare_ids) != len(set(spare_ids)):
            raise AssertionError("spare piles hold duplicates")
        for p in range(self.scratch_pages):
            if self._ref[p] != 1:
                raise AssertionError(
                    f"scratch page {p} refcount {self._ref[p]} != 1")
        for p in range(self.num_pages):
            if (self._ref[p] == 0) != (p in free):
                raise AssertionError(
                    f"page {p}: refcount {self._ref[p]} vs free-list "
                    f"membership {p in free}")
            if self._ref[p] < 0:
                raise AssertionError(f"page {p}: negative refcount")
        for page, pile in self._spares.items():
            if len(pile) != self._ref[page] - 1:
                raise AssertionError(
                    f"tail page {page}: {len(pile)} spares != refcount "
                    f"{self._ref[page]} - 1")
            for s in pile:
                if self._ref[s] != 1:
                    raise AssertionError(
                        f"spare {s} refcount {self._ref[s]} != 1")
        for key, page in self._by_key.items():
            if self._key_of.get(page) != key:
                raise AssertionError(
                    f"registry maps {key!r} -> page {page} but reverse "
                    f"map says {self._key_of.get(page)!r}")
            if self._ref[page] == 0:
                raise AssertionError(f"registered page {page} is free")
