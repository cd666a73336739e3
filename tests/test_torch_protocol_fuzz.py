"""The port's schedule fuzzing against the JAX package's, on bigger configs.

The rest of ``tests/test_schedule_explorer.py``: the reference's
canonical 4-worker / 778-float / chunk-3 script config under the
standard battery, config-space fuzzing (random workers, sizes, chunks,
lags, thresholds and rounds, each under a battery of schedules), and
``emulate --fuzz`` end to end. Each runs on the JAX package and on the
port on the CPU with the scenario's own invariants, and both must fail
the same schedules (none). The JAX file runs its script-config battery
at 40 random seeds; here it runs at 4, which keeps the file's time in
seconds while every starvation and rotation schedule still runs.
"""

import random as pyrandom
import sys

import numpy as np

from test_torch_protocol_explorer import Side, as_numpy, exact_validator, \
    labels, on_both
from torch_rehearsal import one_intra_op_thread  # noqa: F401


def test_standard_battery_4workers_script_config():
    """The reference's canonical 4w/778/chunk-3 script config (reference:
    scripts/testAllreduceMaster.sc) under the battery."""
    def scenario(s):
        n, ds, rounds = 4, 778, 4
        outputs = {}
        config = s.config(n, ds, chunk=3, max_lag=3, max_round=rounds)
        names = ["master"] + [f"worker-{r}" for r in range(n)]
        failures = s.ex.explore(
            lambda: s.cluster(config, outputs, n, ds),
            s.ex.standard_schedules(names, seeds=4),
            exact_validator(outputs, n, ds, rounds))
        assert not failures, "\n".join(map(str, failures))
        return labels(failures)
    on_both(scenario)


def test_random_configs_under_random_schedules():
    """All paced rounds complete, every worker flushes every round, and
    each flush is honest (``data == arange * count``, ``0 <= count <=
    N``; ``count == N`` at thresholds 1.0) for random all-alive
    configs, under the same schedules on both engines."""
    def scenario(s):
        rng = pyrandom.Random(20260731)
        verdicts = []
        for trial in range(10):
            n = rng.choice([2, 3, 4, 5])
            data_size = rng.randint(n, 48)
            chunk = rng.randint(1, max(1, data_size // 2))
            lag = rng.choice([1, 2, 4])
            rounds = rng.randint(1, 5)
            th = rng.choice([(1.0, 1.0, 1.0), (0.7, 0.8, 0.7),
                             (0.5, 0.9, 0.8)])
            config = s.config(n, data_size, chunk=chunk, max_lag=lag,
                              max_round=rounds, th=th)
            outputs = {}

            def validate(cluster, n=n, ds=data_size, rounds=rounds, th=th,
                         outputs=outputs):
                assert len(cluster.completed_rounds) == rounds
                base = np.arange(ds, dtype=np.float32)
                for r in range(n):
                    assert len(outputs[r]) == rounds + 1
                    for out in outputs[r]:
                        count = as_numpy(out.count)
                        if th == (1.0, 1.0, 1.0):
                            assert (count == n).all()
                        else:
                            assert ((count >= 0) & (count <= n)).all()
                        np.testing.assert_allclose(as_numpy(out.data),
                                                   base * count, rtol=1e-6)

            names = ["master"] + [f"worker-{r}" for r in range(n)]
            failures = s.ex.explore(
                lambda config=config, n=n, ds=data_size, outputs=outputs:
                    s.cluster(config, outputs, n, ds),
                s.ex.standard_schedules(names, seeds=12), validate)
            assert not failures, (trial, "\n".join(map(str, failures[:5])))
            verdicts.append(labels(failures))
        return verdicts
    on_both(scenario)


def run_cli(side, argv, monkeypatch):
    if side == "jax":
        from akka_allreduce_tpu.cli import main
        monkeypatch.setattr(sys, "argv", ["aat"] + argv)
        return main()
    from akka_allreduce_tpu_torch.cli import main
    return main(argv + ["--device", "cpu"])


def both_cli(argv, monkeypatch, capsys):
    got = {}
    for side in ("jax", "port"):
        rc = run_cli(side, argv, monkeypatch)
        cap = capsys.readouterr()
        got[side] = (rc, cap.out, cap.err)
    return got


def test_fuzz_exact_config_passes(monkeypatch, capsys):
    got = both_cli(["emulate", "--fuzz", "10", "--assert-multiple", "2",
                    "--th-complete", "1.0", "--max-round", "3"],
                   monkeypatch, capsys)
    for rc, out, _ in got.values():
        assert rc == 0 and "0 violations" in out
    # the same schedules: the summary line up to its wall time
    assert got["port"][1].split("(")[0] == got["jax"][1].split("(")[0]


def test_fuzz_rejects_native_engine(monkeypatch, capsys):
    got = both_cli(["emulate", "--fuzz", "5", "--engine", "native"],
                   monkeypatch, capsys)
    for rc, _, err in got.values():
        assert rc == 2 and "--fuzz" in err


def test_fuzz_kill_rank_passes_with_reachable_thresholds(monkeypatch,
                                                         capsys):
    got = both_cli(["emulate", "--fuzz", "6", "--workers", "4",
                    "--data-size", "8", "--max-chunk-size", "2",
                    "--kill-rank", "3", "--max-round", "3",
                    "--th-allreduce", "0.6", "--th-reduce", "0.6",
                    "--th-complete", "0.6"], monkeypatch, capsys)
    for rc, out, _ in got.values():
        assert rc == 0 and "0 violations" in out
    assert got["port"][1].split("(")[0] == got["jax"][1].split("(")[0]


def test_fuzz_kill_rank_rejects_unreachable_threshold(monkeypatch, capsys):
    """ceil(0.9 * 4) = 4 > 3 survivors: refused at the flag layer with
    the JAX command's message."""
    got = both_cli(["emulate", "--fuzz", "5", "--workers", "4",
                    "--kill-rank", "3", "--th-allreduce", "0.9",
                    "--th-reduce", "0.6", "--th-complete", "0.6"],
                   monkeypatch, capsys)
    for rc, _, err in got.values():
        assert rc == 2 and "--th-allreduce" in err and "ceil" in err
    assert got["port"][2] == got["jax"][2]
