"""``chip_smoke.py``'s rank pools on the CPU: a batch run in a
``RankPool`` (the rank processes kept across ``spawn_batch`` calls) gives
what a fresh spawn of the ranks gives, on the same processes batch after
batch, whatever each batch's backend and mesh; a batch that raises, and
``close_pools``, end the processes."""

import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401
import chip_smoke

TINY = ["train", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
        "--d-ff", "64", "--vocab", "61", "--seq", "16", "--batch", "4",
        "--steps", "2", "--log-every", "1", "--device", "cpu",
        "--dist-backend", "gloo", "--grad-quant", "ef8"]


def pids(results) -> list:
    """The rank processes' ids, from each rank's ``/proc/self/stat``."""
    return [int(r.split()[0]) for r in results]


def summary(report: dict) -> dict:
    """What a run's checks read: losses, and per rank the parameter and
    ef8 residual checksums and the sync kernels' launches."""
    return {"losses": report["losses"],
            "ranks": [(r["param_checksum"], r.get("residual_checksum"),
                       r["sync_launches"]) for r in report["ranks"]]}


@pytest.fixture
def pooled(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    yield
    chip_smoke.close_pools()
    monkeypatch.setattr(chip_smoke, "POOLED", False)


def test_pooled_batches_match_fresh_spawns(pooled, monkeypatch):
    from akka_allreduce_tpu_torch import cli
    parse = cli.build_parser().parse_args
    dp = parse(TINY + ["--dp", "2"])
    sp = parse(TINY + ["--sp", "2", "--grad-quant", "none"])
    stat = ("call", chip_smoke.file_bytes, ("/proc/self/stat",))
    fresh = [chip_smoke.spawn_batch(torch, [("train", args, None), stat],
                                    sp=args.sp) for args in (dp, sp)]
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    runs = [chip_smoke.spawn_batch(torch, [("train", args, None), stat],
                                   sp=args.sp) for args in (dp, sp, dp)]
    for got, want in zip(runs, fresh + fresh[:1]):
        assert summary(got[0][0]) == summary(want[0][0])
    # one pool of two ranks ran every batch, on its own processes
    assert list(chip_smoke._POOLS) == [2]
    procs = chip_smoke._POOLS[2].procs
    assert [pids(r[1][0]) for r in runs] == [[p.pid for p in procs]] * 3
    assert pids(fresh[0][1][0]) != pids(runs[0][1][0])
    # a call batch on a gloo group of another mesh, in the same pool
    (res, _), = chip_smoke.spawn_batch(torch, [stat], world=2,
                                       backend="gloo", sp=2)
    assert pids(res) == [p.pid for p in procs]
    chip_smoke.close_pools()
    assert chip_smoke._POOLS == {}
    assert not any(p.is_alive() for p in procs)


def test_a_failing_batch_ends_the_pool(pooled, monkeypatch):
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    missing = ("call", chip_smoke.file_bytes, ("/nonexistent/file",))
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        chip_smoke.spawn_batch(torch, [missing], world=2, backend="gloo")
    assert chip_smoke._POOLS == {}
    # the next batch starts a new pool
    stat = ("call", chip_smoke.file_bytes, ("/proc/self/stat",))
    (res, _), = chip_smoke.spawn_batch(torch, [stat], world=2,
                                       backend="gloo")
    assert pids(res) == [p.pid for p in chip_smoke._POOLS[2].procs]


def test_pooled_spawns_route_the_ports_spawns_to_the_pool(pooled,
                                                          monkeypatch):
    """Inside ``pooled_spawns`` the port's own ``spawn_ranks`` (as
    ``bench.py`` calls it) runs on the pool's processes; outside, and
    with the pools off, it spawns as before."""
    from akka_allreduce_tpu_torch.parallel import group
    real = group.spawn_ranks
    args = (chip_smoke.file_bytes, 2, "gloo", "cpu", "/proc/self/stat")
    with chip_smoke.pooled_spawns():
        fresh = pids(group.spawn_ranks(*args))
    assert chip_smoke._POOLS == {}
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    with chip_smoke.pooled_spawns():
        got = [pids(group.spawn_ranks(*args)) for _ in range(2)]
    assert group.spawn_ranks is real
    assert got == [[p.pid for p in chip_smoke._POOLS[2].procs]] * 2
    assert fresh != got[0]
