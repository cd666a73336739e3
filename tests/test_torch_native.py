"""The port's copy of the C++ engines against the Python engine and JAX's.

``akka_allreduce_tpu_torch/native`` is a copy of the JAX package's
``native/`` (host C++, no kernel), built into a library of its own name.
Pins: the sources are byte for byte the JAX package's; the library
builds once under concurrent first use and loads beside the JAX
package's in one process; on ``tests/test_native_cluster.py``'s case
list the port's ``run_native_cluster`` agrees with the port's Python
``LocalCluster`` on the CPU, and its rounds and flushes equal the JAX
package's ``run_native_cluster``; the ABI refuses a bad config.
"""

import ctypes
import os
import pathlib
import subprocess
import sys

import pytest

from akka_allreduce_tpu.protocol.native_cluster import \
    run_native_cluster as jax_run_native_cluster
from akka_allreduce_tpu_torch import native
from akka_allreduce_tpu_torch.config import (
    AllreduceConfig,
    DataConfig,
    ThresholdConfig,
    WorkerConfig,
)
from akka_allreduce_tpu_torch.protocol.cluster import (
    LocalCluster,
    constant_range_source,
)
from akka_allreduce_tpu_torch.protocol.native_cluster import \
    run_native_cluster

REPO = pathlib.Path(__file__).resolve().parents[1]


def make_config(workers=4, data_size=778, max_chunk_size=3, max_lag=3,
                th=(1.0, 1.0, 1.0), max_round=20):
    return AllreduceConfig(
        thresholds=ThresholdConfig(*th),
        data=DataConfig(data_size=data_size, max_chunk_size=max_chunk_size,
                        max_round=max_round),
        workers=WorkerConfig(total_size=workers, max_lag=max_lag),
    )


def jax_config(cfg):
    from akka_allreduce_tpu import config as jc
    return jc.AllreduceConfig(
        thresholds=jc.ThresholdConfig(cfg.thresholds.th_allreduce,
                                      cfg.thresholds.th_reduce,
                                      cfg.thresholds.th_complete),
        data=jc.DataConfig(data_size=cfg.data.data_size,
                           max_chunk_size=cfg.data.max_chunk_size,
                           max_round=cfg.data.max_round),
        workers=jc.WorkerConfig(total_size=cfg.workers.total_size,
                                max_lag=cfg.workers.max_lag))


def python_rounds(config, kill_rank=None):
    outputs = []
    cluster = LocalCluster(
        config,
        source_factory=lambda r: constant_range_source(
            config.data.data_size, "cpu"),
        sink_factory=lambda r: outputs.append, device="cpu")
    rounds = cluster.run(kill_rank=kill_rank)
    return rounds, len(outputs)


CASES = [
    dict(),                                             # canonical
    dict(workers=2, data_size=10, max_chunk_size=2,
         max_lag=1),                                    # README demo
    dict(workers=8, data_size=1024, max_chunk_size=128,
         max_lag=2, th=(0.85, 0.9, 0.9)),               # lossy
    dict(workers=3, data_size=7, max_chunk_size=3,
         max_lag=0),                                    # uneven blocks
    dict(workers=4, data_size=2, max_chunk_size=1,
         max_lag=1),                                    # empty blocks
]


def test_sources_are_the_jax_packages_byte_for_byte():
    ours = REPO / "akka_allreduce_tpu_torch" / "native" / "src"
    theirs = REPO / "akka_allreduce_tpu" / "native" / "src"
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert names == sorted(os.path.basename(s) for s in native._SRCS)
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


def test_library_has_its_own_name_and_loads_beside_jax():
    from akka_allreduce_tpu.native import load_library as jax_load
    ours, theirs = native.load_library(), jax_load()
    assert os.path.basename(ours._name) == "libaatpu_torch.so"
    assert ours._name != theirs._name
    # both run in one process, each through its own symbols
    cfg = make_config(max_round=3)
    assert run_native_cluster(cfg) == jax_run_native_cluster(jax_config(cfg))


def test_concurrent_cold_builds_build_once(tmp_path):
    """Three processes that find the library missing: one builds, the
    others wait on the lock and reuse it (each checks staleness under
    the lock), and every one loads a whole library. The copy's Makefile
    stands in for g++ with a one-second copy of the built library."""
    built = native.build_library()
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    src = REPO / "akka_allreduce_tpu_torch" / "native"
    dst = pkg / "native"
    dst.mkdir()
    (dst / "__init__.py").write_bytes((src / "__init__.py").read_bytes())
    (dst / "src").mkdir()
    for p in (src / "src").iterdir():
        (dst / "src" / p.name).write_bytes(p.read_bytes())
    # a slow stand-in for the compiler: the build takes a second and
    # yields the real library at the loader's per-pid OUT
    (dst / "Makefile").write_text(
        f"all:\n\tsleep 1\n\tmkdir -p _lib\n\tcp {built} $(OUT)\n")
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "import native, subprocess\n"
            "calls = []\n"
            "real = subprocess.run\n"
            "def run(*a, **k):\n"
            "    calls.append(a[0]); return real(*a, **k)\n"
            "native.subprocess.run = run\n"
            "native.load_library().aat_cluster_run\n"
            "print(len(calls))\n") % str(pkg)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    builds = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0
        builds.append(int(out.strip()))
    assert sorted(builds) == [0, 0, 1]
    assert [p.name for p in (dst / "_lib").iterdir()
            if p.name.endswith(".so")] == ["libaatpu_torch.so"]


class TestNativeCluster:
    def test_canonical_config_correct_and_complete(self):
        """The reference's canonical script config with the output == 4 x
        input invariant checked on EVERY flush inside the engine."""
        rounds, flushed = run_native_cluster(make_config(),
                                             assert_multiple=4)
        assert rounds == 20
        assert flushed >= 4 * 20

    @pytest.mark.parametrize("kw", CASES)
    def test_agrees_with_python_engine_and_jax(self, kw):
        cfg = make_config(**kw)
        py_rounds, py_flushed = python_rounds(cfg)
        nat = run_native_cluster(cfg)
        assert nat == (py_rounds, py_flushed)
        assert nat == jax_run_native_cluster(jax_config(cfg))

    def test_killed_worker_agrees_with_python_engine_and_jax(self):
        cfg = make_config(workers=8, data_size=1024, max_chunk_size=128,
                          max_lag=2, th=(0.85, 0.9, 0.9), max_round=30)
        py_rounds, _ = python_rounds(cfg, kill_rank=7)
        nat_rounds, nat_flushed = run_native_cluster(cfg, kill_rank=7)
        assert nat_rounds == py_rounds == 30
        assert nat_flushed >= 7 * 30  # survivors flush every round
        assert (nat_rounds, nat_flushed) == jax_run_native_cluster(
            jax_config(cfg), kill_rank=7)

    def test_thresholds_one_with_dead_worker_stalls_both(self):
        cfg = make_config(workers=4, data_size=64, max_chunk_size=16,
                          max_lag=1, max_round=10)
        py_rounds, _ = python_rounds(cfg, kill_rank=2)
        nat = run_native_cluster(cfg, kill_rank=2)
        assert nat[0] == py_rounds
        assert nat == jax_run_native_cluster(jax_config(cfg), kill_rank=2)

    def test_round_times_are_monotonic(self):
        rounds, flushed, stamps = run_native_cluster(
            make_config(max_round=5), with_round_times=True)
        assert rounds == 5 and len(stamps) == 5
        assert all(b >= a for a, b in zip(stamps, stamps[1:]))

    def test_out_of_range_kill_rank_rejected(self):
        with pytest.raises(ValueError):
            run_native_cluster(make_config(workers=4), kill_rank=4)

    def test_bad_config_rejected_at_abi(self):
        lib = native.load_library()
        rc = lib.aat_cluster_run(0, 10, 2, 1, 1.0, 1.0, 1.0, 5, -1, 0,
                                 ctypes.POINTER(ctypes.c_long)())
        assert rc == -2
