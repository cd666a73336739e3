"""``train --coordinator`` as two CPU processes, held to ``--dp 2``.

Each process is ``cli.run_train`` in its own interpreter (the command's
entry point; its report comes back as one JSON line), both joined
through the coordinator's TCPStore that process 0 hosts.

* The hybrid (``--deadline-ms``, ``--max-lag 0``, a deadline no round
  misses): each process runs its half of every global batch on its own
  local mesh and the processes average through the store, the
  token-weighted mean. Each step's loss is within rtol 1e-5 of ``--dp
  2``'s on the same global batch (the two sum the halves' gradients in
  other orders), the two processes' parameters are bitwise equal
  (``--check-every 1`` compares their CRCs every round), and no round
  is masked.
* The exact path (no deadline): one process group over both processes'
  ranks, rank ``process_id x local_world + local_rank``, is ``--dp 2``'s
  mesh: the losses are bitwise ``--dp 2``'s.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.protocol.remote import free_port

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["train", "--device", "cpu", "--vocab", "61", "--d-model", "32",
        "--n-heads", "2", "--d-ff", "64", "--seq", "16", "--batch", "4",
        "--steps", "3", "--log-every", "1"]
DRIVER = """
import json, sys, torch
torch.set_num_threads(2)
from akka_allreduce_tpu_torch import cli
report = cli.run_train(cli.build_parser().parse_args(sys.argv[1:]))
hybrid = report.get("hybrid") or {}
print("REPORT " + json.dumps({
    "losses": report["losses"],
    "checksum": report.get("param_checksum",
                           (report.get("ranks") or [{}])[0].get(
                               "param_checksum")),
    "n_masked": [r["n_masked"] for r in hybrid.get("rounds", [])]}))
"""


def _run_two(flags: list) -> list:
    port = free_port()
    coord = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRIVER] + TINY + flags + coord
        + ["--process-id", str(pid)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("REPORT ")][-1]
            reports.append((json.loads(line[7:]), out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return reports


def _dp2_losses() -> list:
    return cli.run_train(cli.build_parser().parse_args(
        TINY + ["--dp", "2"]))["losses"]


def test_hybrid_processes_match_dp2():
    reports = _run_two(["--deadline-ms", "30000", "--max-lag", "0",
                        "--check-every", "1"])
    want = _dp2_losses()
    (r0, out0), (r1, out1) = reports
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want, rtol=1e-5)
    assert r0["checksum"] == r1["checksum"]
    assert r0["n_masked"] == r1["n_masked"] == [0, 0, 0]
    # process 0 narrates the JAX command's lines; process 1 is quiet
    assert "[masked 0/2 procs]" in out0
    assert "lossy rounds: 0/3 had masked processes" in out0
    assert "step" not in out1.replace("REPORT", "")


def test_exact_coordinator_is_the_dp2_mesh():
    reports = _run_two(["--dp", "2"])
    want = _dp2_losses()
    for report, _ in reports:
        assert report["losses"] == want
    assert reports[0][0]["checksum"] == reports[1][0]["checksum"]
