"""The port's page allocator against the JAX package's, step for step.

``serving/paging.py`` is pure Python in both packages, so the same seeded
sequence of admits (prompts drawn from a small set, so prefixes and tails
are shared), copy-on-write splits and releases must give identical page
lists, prefill-write flags, split targets and counters, bitwise, with
``check_invariants`` holding after every step.
"""

import numpy as np
import pytest

from akka_allreduce_tpu.serving import paging as jpaging
from akka_allreduce_tpu_torch.serving import paging as tpaging


def drive(mod, seed: int, steps: int = 300) -> list:
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([2, 4]))
    pool = mod.PagePool(40, page_size, scratch_pages=1)
    base = [tuple(int(x) for x in rng.integers(0, 50, size=n))
            for n in (3, 4, 8, 9)]
    held: list = []
    log = []
    for _ in range(steps):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            prompt = base[int(rng.integers(0, len(base)))]
            budget = int(rng.integers(1, 6))
            plan = pool.plan(prompt, budget)
            if pool.can_admit(prompt, budget):
                pages, writes = pool.admit(prompt, budget)
                held.append((len(prompt), pages))
                log.append(("admit", tuple(pages), tuple(writes)))
            else:
                log.append(("full", plan.fresh_pages, pool.free_pages))
        elif op == 1:
            # a write lands at or past the prompt's tail page, as in decode
            n, pages = held[int(rng.integers(0, len(held)))]
            c = int(rng.integers(n // page_size, len(pages)))
            new = pool.split_for_write(pages[c])
            if new is not None:
                pages[c] = new
            log.append(("split", c, new))
        else:
            _, pages = held.pop(int(rng.integers(0, len(held))))
            pool.release_all(pages)
            log.append(("release", tuple(pages)))
        pool.check_invariants()
        log.append((pool.free_pages, pool.pages_in_use, pool.prefix_hits,
                    pool.prefix_lookups, pool.cow_splits,
                    pool.pages_shared_total, pool.pages_allocated_total))
    for _, pages in held:
        pool.release_all(pages)
    pool.check_invariants()
    log.append(("drained", pool.free_pages, pool.capacity))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_ops_same_pages(seed):
    want = drive(jpaging, seed)
    got = drive(tpaging, seed)
    assert got == want
    assert got[-1][1] == got[-1][2]  # every page back on the free list
    assert any(e[0] == "admit" and False in e[2] for e in got
               if isinstance(e[0], str)), "no prefix was ever shared"


def test_pages_for_and_plan_match():
    for n in range(0, 40):
        for p in (1, 3, 16):
            assert tpaging.pages_for(n, p) == jpaging.pages_for(n, p)
    jp = jpaging.PagePool(10, 4, scratch_pages=1)
    tp = tpaging.PagePool(10, 4, scratch_pages=1)
    prompt = tuple(range(9))
    for pool in (jp, tp):
        pool.admit(prompt, 3)
    assert tp.plan(prompt, 5).__dict__ == jp.plan(prompt, 5).__dict__
