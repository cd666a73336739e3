"""Rank-side helpers of the rank transport's checks: the CPU tests
(``tests/test_torch_transport.py``), the card tests and ``chip_smoke.py``'s
phase 18 share them.

Spawned ranks import this module by name, so it imports no JAX. A case is
``(scope, kind, dtype, xs, kwargs)``: ``scope`` "world" runs the
collective on the whole group as one axis, "dp" / "sp" on the rank's
line along that axis; ``xs`` holds every global rank's input as a numpy
array (bfloat16 as its uint16 bit patterns), or a :class:`Seeded` spec
whose input each rank makes on its own device; ``kwargs["peers"]`` gives
each line rank's ``exchange`` peer, ``kwargs["shift"]`` the ``ppermute``
shift.
"""

import dataclasses
import time

import numpy as np
import torch

from akka_allreduce_tpu_torch.ops.kernels import transport

DTYPES = ("float32", "bfloat16", "int8")
# every payload below takes 2-3 chunks of 40 bytes, the last ragged
SHAPES = {"float32": (3, 7), "bfloat16": (3, 9), "int8": (5, 11)}
# rank counts and sp of each spawn
SCENARIOS = {"n2": (2, 1), "n3": (3, 1), "n4": (4, 1), "mesh": (4, 2)}
EXCHANGE_PEERS = {2: [[1, 0]], 3: [[1, 0, 2]], 4: [[1, 0, 3, 2],
                                                   [2, 3, 0, 1]]}


@dataclasses.dataclass(frozen=True)
class Seeded:
    """An input each rank makes on its device: ``shape``, from a torch
    generator seeded ``seed`` * 64 + the rank (normal floats, uniform
    int8)."""

    shape: tuple
    seed: int


def payload(rng, dtype: str, shape: tuple) -> np.ndarray:
    if dtype == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # bit patterns: the transport moves bytes
        return rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    return rng.integers(-128, 128, shape, dtype=np.int8)


def scopes(world: int, sp: int) -> list:
    """The world, and on a mesh with both axes > 1 its two lines."""
    return ["world"] + (["sp", "dp"] if 1 < sp < world else [])


def scope_size(world: int, sp: int, scope: str) -> int:
    return {"world": world, "sp": sp, "dp": world // sp}[scope]


def make_cases(world: int, sp: int, shapes: dict, inputs) -> list:
    """Every collective in each dtype of ``shapes`` (dtype -> a pair's
    shape) on every scope of the ``(world / sp, sp)`` mesh: all_to_all
    (n blocks of the shape), all_gather, an exchange per pairing of
    :data:`EXCHANGE_PEERS` and ppermute by 1 and -1. ``inputs(dtype,
    shape)`` gives a case's ``xs``."""
    cases = []
    for scope in scopes(world, sp):
        n = scope_size(world, sp, scope)
        for dtype, shape in shapes.items():
            specs = ([("all_to_all", (n,) + shape, {}),
                      ("all_gather", shape, {})]
                     + [("exchange", shape, {"peers": p})
                        for p in EXCHANGE_PEERS[n]]
                     + [("ppermute", shape, {"shift": s}) for s in (1, -1)])
            cases += [(scope, kind, dtype, inputs(dtype, shp), kw)
                      for kind, shp, kw in specs]
    return cases


def scenario_cases(name: str) -> list:
    """The cases of one CPU-test spawn, inputs drawn with numpy."""
    world, sp = SCENARIOS[name]
    rng = np.random.default_rng(world * 10 + sp)
    return make_cases(world, sp, SHAPES, lambda dtype, shape: [
        payload(rng, dtype, shape) for _ in range(world)])


def tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def as_bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().copy()


def rank_input(group, case) -> torch.Tensor:
    """This rank's input of ``case``, on its device."""
    _, _, dtype, xs, _ = case
    if not isinstance(xs, Seeded):
        return tensor(xs[group.rank], dtype).to(group.device)
    gen = torch.Generator(device=group.device).manual_seed(
        xs.seed * 64 + group.rank)
    if dtype == "int8":
        return torch.randint(-128, 128, xs.shape, generator=gen,
                             device=group.device, dtype=torch.int8)
    return torch.randn(xs.shape, generator=gen, device=group.device).to(
        getattr(torch, dtype))


def run_case(group, case, x: torch.Tensor) -> torch.Tensor:
    """``case``'s collective of ``x`` on ``group``."""
    scope, kind, _, _, kw = case
    flat = dataclasses.replace(group, sp=1)
    if kind == "ppermute":
        return (flat.ppermute(x, "dp", kw["shift"]) if scope == "world"
                else group.ppermute(x, scope, kw["shift"]))
    g = flat if scope == "world" else group.along(scope)
    if kind == "all_to_all":
        return g.all_to_all(x)
    if kind == "all_gather":
        return g.all_gather(x)
    return g.exchange(x, kw["peers"][g.rank])


def run_cases(group, cases: list) -> list:
    """This rank's output bytes of every case, in order."""
    return [as_bytes(run_case(group, case, rank_input(group, case)))
            for case in cases]


def run_twins(group, cases: list) -> list:
    """Each case on this group (``ipc`` on the card) and on its gloo
    twin (the same process group, the host wire), on the same input: per
    case whether the bytes are equal (``bitwise``), each call's host ms
    from a drained stream to its end (``ipc_ms``, ``gloo_ms``), the
    pair's bytes, and the copies, stretches and stream waits the ipc call
    enqueued."""
    twin = dataclasses.replace(group, backend="gloo")
    out = []
    for case in cases:
        scope, kind, dtype, _, _ = case
        x = rank_input(group, case)
        c0, w0 = transport.counts(), transport.stream_waits()
        torch.cuda.synchronize(group.device)
        t0 = time.perf_counter()
        got = run_case(group, case, x)
        transport.wait(group)
        ipc_ms = (time.perf_counter() - t0) * 1e3
        c1, w1 = transport.counts(), transport.stream_waits()
        t0 = time.perf_counter()
        want = run_case(twin, case, x)
        torch.cuda.synchronize(group.device)
        gloo_ms = (time.perf_counter() - t0) * 1e3
        n = scope_size(group.world, group.sp, scope)
        out.append({
            "scope": scope, "kind": kind, "dtype": dtype,
            "pair_bytes": x.numel() * x.element_size()
            // (n if kind == "all_to_all" else 1),
            "bitwise": torch.equal(got.reshape(-1).view(torch.uint8),
                                   want.reshape(-1).view(torch.uint8)),
            "ipc_ms": ipc_ms, "gloo_ms": gloo_ms,
            "copies": c1["transport_copies"] - c0["transport_copies"],
            "launches": c1["transport_launches"] - c0["transport_launches"],
            "waits": w1 - w0})
        del x, got, want
    return out


def skip_one_call(group, timeout: float) -> dict:
    """One all_gather that every rank makes, then one that rank 1 skips:
    rank 0's ``transport.wait`` must raise within ``timeout`` seconds of
    its call, naming the counters."""
    x = torch.arange(1024, dtype=torch.float32, device=group.device)
    group.all_gather(x)
    transport.wait(group)
    group.barrier()
    if group.rank == 1:
        return {"skipped": True}
    t0 = time.monotonic()
    group.all_gather(x)
    try:
        transport.wait(group, timeout)
    except RuntimeError as err:
        return {"raised": True, "seconds": time.monotonic() - t0,
                "message": str(err)}
    return {"raised": False, "seconds": time.monotonic() - t0}


def train_skipping_a_call(group, args, skip, timeout: float) -> dict:
    """One rank of ``cli train`` (``args``) on its group, the transport's
    watchdog giving up a call after ``timeout`` seconds. With ``skip``,
    rank 1 leaves out its transport call number ``skip`` (from 1), as a
    peer that skips a collective: it returns an unfilled output instead
    of calling."""
    from akka_allreduce_tpu_torch import cli
    transport.TIMEOUT_S = timeout
    if skip and group.rank == 1:
        real, made = transport._run, [0]

        def run(g, axis, kind, x, out_shape, **kw):
            made[0] += 1
            if made[0] == skip:
                return torch.empty(out_shape, dtype=x.dtype, device=x.device)
            return real(g, axis, kind, x, out_shape, **kw)
        transport._run = run
    return cli._train_rank(group, args, None, None)
