"""The hybrid's process chains, as the JAX package's tests run them.

The port's counterparts of ``tests/test_dcn_deadline.py``
``TestDcnDeadlineChain`` and ``tests/test_dcn_composed.py``: ``python -m
akka_allreduce_tpu_torch.cli train --device cpu --coordinator ...
--deadline-ms`` processes (process 0 hosts the store), stopped with
SIGSTOP, resumed with SIGCONT and killed with SIGKILL at the steps the
JAX tests pick, held to the lines the JAX command prints: ``[masked
k/n procs]``, ``auto-downed processes now:``, ``lossy rounds:``, the
snapshot rejoin's lines, and every narrated loss finite.

Sizes are the JAX tests' or smaller (one layer, d_model 32, a local
world of one rank; the pipelined case a local ``--tp 2`` mesh), and the
deadlines short enough that each chain runs in well under 30 s here.
The killed master: a TCPStore has no failure detector, but process 0
hosts it, so a worker's next store call fails at once and the worker
says the coordinator's store is gone, the counterpart of JAX's
coordination service detector; the trainer's heartbeat watch covers a
master that hangs (``tests/test_torch_dcn_protocol.py``). At the end
the master waits for the processes it did not auto-down only.
"""

import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest

from akka_allreduce_tpu_torch.protocol.remote import free_port

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--seq", "16", "--vocab", "61", "--d-model",
        "32", "--n-heads", "2", "--n-layers", "1", "--d-ff", "64",
        "--log-every", "1"]
LIMIT_S = 240
# the chains that wake a stopped worker and want it back in the mask run
# without auto-down (JAX's tests keep the default 4): an auto-downed
# worker re-ups only when its report lands within a round of the
# master's, and the master, no longer waiting for it, runs rounds of a
# few ms at these sizes, which the woken worker (catching up, then
# computing and publishing its round) does not match on a loaded host:
# it stays a round or more behind to the end, catching up again each
# round (seen with the stall chains here under six-worker load). Paced
# by its deadline, the master waits for the woken worker's report,
# which lands in the mask. Auto-down and re-up are held by the
# composed chain and ``tests/test_torch_dcn_protocol.py``.
NO_DOWN = ["--down-after", "0"]


def _spawn(port: int, i: int, n: int, flags: list) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "akka_allreduce_tpu_torch.cli", "train",
         *TINY, "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(n), "--process-id", str(i), *flags],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=env, start_new_session=True)


def _signal(proc: subprocess.Popen, sig: int) -> None:
    """``sig`` to a process and the rank processes it spawned (its own
    process group)."""
    try:
        os.killpg(proc.pid, sig)
    except OSError:
        pass


class Chain:
    """``n`` processes at ``flags``; process 0's lines pumped on a
    thread that calls ``on_line(line, procs)`` for each."""

    def __init__(self, n: int, flags: list, on_line=None):
        port = free_port()
        self.procs = [_spawn(port, i, n, flags) for i in range(n)]
        self.lines: list = []
        self.on_line = on_line
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _pump(self) -> None:
        for line in self.procs[0].stdout:
            self.lines.append(line.rstrip())
            if self.on_line is not None:
                self.on_line(line, self.procs)

    def wait(self, which) -> dict:
        """Exit codes of the processes ``which``; every process ends."""
        rcs = {}
        deadline = time.time() + LIMIT_S
        try:
            for i in which:
                rcs[i] = self.procs[i].wait(
                    timeout=max(5, deadline - time.time()))
        finally:
            for p in self.procs:
                _signal(p, signal.SIGCONT)
                _signal(p, signal.SIGKILL)
            self.thread.join(timeout=15)
        return rcs

    @property
    def out(self) -> str:
        return "\n".join(self.lines)

    def tail(self, i: int) -> str:
        return self.procs[i].stdout.read() or ""


def _losses_finite(lines: list) -> None:
    for ln in lines:
        if "loss" in ln and "step" in ln:
            v = float(ln.split("loss")[1].split()[0])
            assert v == v and v < 1e9, ln


def _stop_resume(stop_at: str, resume_at: str, victim: int):
    state = {"stopped": False, "resumed": False}

    def on_line(line, procs):
        if stop_at in line and not state["stopped"]:
            state["stopped"] = True
            _signal(procs[victim], signal.SIGSTOP)
        if resume_at in line and state["stopped"] and not state["resumed"]:
            state["resumed"] = True
            _signal(procs[victim], signal.SIGCONT)
    return state, on_line


def test_sigstop_worker_masked_then_rejoins():
    """3 processes; SIGSTOP process 2 at step 3, SIGCONT at step 7: the
    survivors train on with 1/3 masked, the stopped process catches up
    from the retained rounds and exits cleanly, and the last rounds are
    unmasked again. Auto-down is off (``NO_DOWN``)."""
    steps = 12
    state, on_line = _stop_resume("step    3", "step    7", 2)
    chain = Chain(3, ["--steps", str(steps), "--batch", "6",
                      "--deadline-ms", "1000", *NO_DOWN],
                  on_line)
    rcs = chain.wait([0, 1, 2])
    out, tail2 = chain.out, chain.tail(2)
    assert state["stopped"] and state["resumed"], out
    assert rcs == {0: 0, 1: 0, 2: 0}, (rcs, out, tail2[-1500:])
    assert any("[masked 1/3" in ln for ln in chain.lines), out
    _losses_finite(chain.lines)
    assert f"step   {steps}" in out, out
    summary = [ln for ln in chain.lines if "lossy rounds" in ln]
    assert summary and int(summary[0].split(":")[1].split("/")[0]) >= 1
    last = [ln for ln in chain.lines if "[masked" in ln][-1]
    assert "[masked 0/3" in last, out
    # the woken process replayed what it missed
    assert "caught up" in tail2, tail2[-1500:]


def test_pipelined_max_lag_window():
    """2 processes, each a local --tp 2 mesh, with --max-lag 3: up to 3
    rounds in flight; all 10 apply, the window's tail drained after the
    loop, none masked."""
    chain = Chain(2, ["--steps", "10", "--batch", "4", "--tp", "2",
                      "--max-lag", "3", "--deadline-ms", "5000"])
    rcs = chain.wait([0, 1])
    out = chain.out
    assert rcs == {0: 0, 1: 0}, (rcs, out, chain.tail(1)[-1500:])
    assert "step   10" in out and "(drained)" in out, out
    assert "lossy rounds: 0/10" in out, out
    _losses_finite(chain.lines)


@pytest.mark.parametrize("mesh", [[], ["--tp", "2"]], ids=["one-rank", "tp2"])
def test_beyond_retention_rejoins_via_snapshot(tmp_path, mesh):
    """SIGSTOP a worker past the retention window (retain 8, the stall
    ~14 rounds): the woken worker requests a snapshot, the master
    force-saves and publishes it, the worker restores, rebases, replays
    the tail and rejoins the mask. On a local tp=2 mesh the worker's
    local ranks restore the sharded checkpoint (the full layout).
    Auto-down is off (``NO_DOWN``)."""
    state, on_line = _stop_resume("step    4:", "step   18:", 1)
    chain = Chain(2, ["--steps", "26", "--batch", "4", "--retain-rounds",
                      "8", "--ckpt-dir", str(tmp_path / "ckpt"),
                      "--ckpt-every", "4", "--deadline-ms", "400",
                      *NO_DOWN, *mesh],
                  on_line)
    rcs = chain.wait([0, 1])
    out0, out1 = chain.out, chain.tail(1)
    assert state["stopped"] and state["resumed"], out0
    assert rcs == {0: 0, 1: 0}, (rcs, out0[-1500:], out1[-1500:])
    assert "served rejoin snapshot at step" in out0, out0
    assert "elastic rejoin via checkpoint snapshot" in out1, out1
    last = [ln for ln in chain.lines if "[masked" in ln][-1]
    assert "[masked 0/2" in last, out0


def test_killed_master_fails_workers_in_seconds():
    """SIGKILL the master at step 3: the workers exit non-zero within
    seconds and say why (the store it hosted is gone, or its heartbeat
    went silent)."""
    state = {"killed_at": 0.0}

    def on_line(line, procs):
        if "step    3" in line and not state["killed_at"]:
            state["killed_at"] = time.time()
            procs[0].kill()
    chain = Chain(3, ["--steps", "14", "--batch", "6", "--deadline-ms",
                      "1000", "--master-timeout-s", "3"], on_line)
    chain.wait([1, 2])
    died_at = time.time()
    outs = [chain.tail(1), chain.tail(2)]
    assert state["killed_at"], chain.out
    assert chain.procs[1].returncode not in (0, None)
    assert chain.procs[2].returncode not in (0, None)
    assert died_at - state["killed_at"] < 60, died_at - state["killed_at"]
    assert all("heartbeat" in o or "coordinator's store" in o
               for o in outs), [o[-800:] for o in outs]


def test_straggle_prob_simulation_runs():
    """2 processes with --straggle-prob and --int8-grads: the seeded draws
    make process 1 publish late in some round on the real clock, over the
    int8 DCN wire; both exit cleanly with finite losses."""
    chain = Chain(2, ["--steps", "8", "--batch", "4", "--int8-grads",
                      "--bucket-elems", "65536", "--deadline-ms", "700",
                      "--straggle-prob", "0.45"])
    rcs = chain.wait([0, 1])
    out = chain.out
    assert rcs == {0: 0, 1: 0}, (rcs, out, chain.tail(1)[-1500:])
    assert "[masked 1/2" in out, out
    assert "lossy rounds" in out
    _losses_finite(chain.lines)


def test_all_knobs_survive_straggler_and_kill():
    """The composed chain (JAX ``tests/test_dcn_composed.py``): 4
    processes with the fraction gate, auto-down, bucket-granular bf16
    wire; SIGSTOP process 3 at step 3 (masked, then auto-downed after 2
    misses), SIGKILL process 2 at step 9 (a second auto-down). Processes
    0 and 1 finish every step with finite losses, narrating both
    membership changes and the masked counts."""
    steps = 16
    state = {"stopped": False, "killed": False}

    def on_line(line, procs):
        if "step    3" in line and not state["stopped"]:
            state["stopped"] = True
            _signal(procs[3], signal.SIGSTOP)
        if "step    9" in line and state["stopped"] and not state["killed"]:
            state["killed"] = True
            _signal(procs[2], signal.SIGKILL)
    chain = Chain(4, ["--steps", str(steps), "--batch", "8",
                      "--deadline-ms", "900", "--th-allreduce", "0.75",
                      "--down-after", "2", "--dcn-bucket-elems", "16384",
                      "--bf16-grads", "--master-timeout-s", "60"], on_line)
    rcs = chain.wait([0, 1])
    out, out1 = chain.out, chain.tail(1)
    assert state["stopped"] and state["killed"], out
    assert rcs == {0: 0, 1: 0}, (rcs, out[-2000:], out1[-2000:])
    assert f"step   {steps}" in out, out
    assert "[masked 1/4" in out, out
    assert "auto-downed processes now: [3]" in out, out
    assert "auto-downed processes now: [2, 3]" in out, out
    summary = [ln for ln in chain.lines if "lossy rounds" in ln]
    assert summary and int(summary[0].split(":")[1].split("/")[0]) >= 2, out
    _losses_finite(chain.lines)
