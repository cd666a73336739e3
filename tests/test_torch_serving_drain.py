"""Drain and restore across a process boundary, in the port and between
the port and the JAX package.

* The drain file: ``persist_drained`` / ``load_drained`` /
  ``clear_drained`` round trip (the JAX package's
  ``TestDrainPersistence``), and the file each package writes for the
  same snapshots is byte-for-byte the other's, so each restores the
  other's drain; a JAX engine's drain, restored into the port's engine,
  finishes with JAX's uninterrupted tokens under ``greedy_agree``.
* The wire: ``resumable_to_frame`` encodes to JAX's bytes, and
  ``frame_to_resumable`` gives the snapshot back.
* The command: ``cli serve --device cpu --drain-dir`` as a subprocess,
  SIGTERMed mid-run (once its ``--metrics-file`` shows decoded tokens),
  persists its in-flight requests; a second run restores them, finishes
  them with the uninterrupted run's tokens and clears the file.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import akka_allreduce_tpu.serving as jserve
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.protocol import wire as jax_wire
from akka_allreduce_tpu.runtime import faults as jfaults
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree
from akka_allreduce_tpu_torch.protocol import wire
from akka_allreduce_tpu_torch.runtime.checkpoint import save_state_json
from akka_allreduce_tpu_torch.runtime.faults import FaultPlan, FaultPoint
from akka_allreduce_tpu_torch.serving import (
    DRAIN_STATE_NAME,
    EngineConfig,
    Request,
    RequestScheduler,
    ResumableRequest,
    SchedulerConfig,
    ServingEngine,
    ServingMetrics,
    clear_drained,
    load_drained,
    persist_drained,
    serve_loop,
)
from akka_allreduce_tpu_torch.telemetry.registry import \
    parse_prometheus_text

REPO = pathlib.Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=67, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=48)
CFG = ttf.TransformerConfig(**MODEL)
SLOTS = 3


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def make_requests(mod=None, n=6, budget=6):
    rng = np.random.default_rng(3)
    req = mod.Request if mod is not None else Request
    return [req(rid=rid, prompt=tuple(int(x) for x in rng.integers(
        0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
        max_new_tokens=budget, eos_token=3 if rid % 2 == 0 else None,
        submitted_at=0.0) for rid in range(n)]


def snapshots(mod):
    """The same drained snapshots in ``mod``'s classes (the port's serving
    package or the JAX package's): every field set, a seed and a tenant
    among them."""
    req, cls = mod.Request, mod.ResumableRequest
    return [cls(req=req(rid=4, prompt=(1, 2, 3), max_new_tokens=9,
                        eos_token=5, stop_tokens=(7, 8), attempts=2,
                        seed=11, tenant="t0"),
                generated=(4, 4, 6), slot=1),
            cls(req=req(rid=9, prompt=(5,), max_new_tokens=3),
                generated=(), slot=0)]


def fields(rr) -> tuple:
    r = rr.req
    return (r.rid, tuple(r.prompt), r.max_new_tokens, r.eos_token,
            tuple(r.stop_tokens), r.attempts, r.seed, r.tenant,
            r.submitted_at, r.deadline, tuple(rr.generated), rr.slot)


class TestDrainPersistence:
    def test_round_trip_across_process_boundary(self, weights, tmp_path):
        """A drain persisted, reloaded with nothing shared, and restored
        through ``serve_loop(resume=)`` finishes bitwise the fault-free
        run; the sidecar then clears."""
        params = weights[2]
        ecfg = EngineConfig(num_slots=SLOTS)

        def sched_of(reqs):
            sched = RequestScheduler(SchedulerConfig(), num_slots=SLOTS)
            for r in reqs:
                sched.submit(r)
            return sched

        want = serve_loop(ServingEngine(params, CFG, ecfg),
                          sched_of(make_requests()))
        metrics = ServingMetrics()
        engine = ServingEngine(params, CFG, ecfg)
        plan = FaultPlan([FaultPoint("serve.loop", "preempt", hit=4)])
        with plan.armed():
            early = serve_loop(engine, sched_of(make_requests()),
                               metrics=metrics, max_dispatches=2000)
        assert engine.drained, "preempt must leave work in flight"
        n_drained = len(engine.drained)
        path = persist_drained(str(tmp_path), engine.drained,
                               metrics=metrics)
        assert path.endswith("drained_requests.json")
        assert metrics.registry.value(
            "serve_drain_persisted_total") == n_drained
        snap = parse_prometheus_text(metrics.registry.to_prometheus_text())
        assert snap[("serve_drain_persisted_total", ())] == n_drained
        restored = load_drained(str(tmp_path))
        by_rid = {rr.req.rid: rr for rr in engine.drained}
        assert len(restored) == n_drained
        for rr in restored:
            orig = by_rid[rr.req.rid]
            assert fields(rr)[:8] == fields(orig)[:8]
            assert rr.generated == orig.generated and rr.generated
            assert rr.req.submitted_at is None  # the old clock's
        done = set(early) | set(by_rid)
        results = dict(early)
        results.update(serve_loop(
            ServingEngine(params, CFG, ecfg),
            sched_of([r for r in make_requests() if r.rid not in done]),
            max_dispatches=2000, resume=restored))
        assert results == want
        assert clear_drained(str(tmp_path)) is True
        assert load_drained(str(tmp_path)) == []
        assert clear_drained(str(tmp_path)) is False

    def test_version_guard(self, tmp_path):
        save_state_json(str(tmp_path), DRAIN_STATE_NAME,
                        {"version": 99, "requests": []})
        with pytest.raises(ValueError, match="version"):
            load_drained(str(tmp_path))

    def test_second_preemption_keeps_unrestored_snapshots(self, weights):
        """A preemption before every resumable is back in a lane leaves
        the rest on ``engine.drained`` beside the new snapshots."""
        params = weights[2]
        waiting = [ResumableRequest(req=r, generated=(), slot=-1)
                   for r in make_requests(n=5)]
        engine = ServingEngine(params, CFG, EngineConfig(num_slots=2))
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        plan = FaultPlan([FaultPoint("serve.loop", "preempt", hit=2)])
        with plan.armed():
            serve_loop(engine, sched, resume=waiting, max_dispatches=100)
        assert sorted(rr.req.rid for rr in engine.drained) == \
            [0, 1, 2, 3, 4]
        assert [len(rr.generated) for rr in engine.drained[:2]] == [1, 1]


class TestDrainFileBothWays:
    def test_files_are_byte_equal(self, tmp_path):
        jp = jserve.persist_drained(str(tmp_path / "jax"),
                                    snapshots(jserve))
        tp = persist_drained(str(tmp_path / "port"),
                             snapshots(tserve))
        with open(jp, "rb") as a, open(tp, "rb") as b:
            jb, tb = a.read(), b.read()
        assert jb == tb
        assert json.loads(jb)["version"] == 1

    def test_each_restores_the_others_drain(self, tmp_path):
        jserve.persist_drained(str(tmp_path / "jax"),
                               snapshots(jserve))
        persist_drained(str(tmp_path / "port"),
                        snapshots(tserve))
        port_reads_jax = load_drained(str(tmp_path / "jax"))
        jax_reads_port = jserve.load_drained(str(tmp_path / "port"))
        assert [fields(r) for r in port_reads_jax] == \
            [fields(r) for r in jax_reads_port]
        assert fields(port_reads_jax[0])[:8] == (
            4, (1, 2, 3), 9, 5, (7, 8), 2, 11, "t0")
        assert isinstance(port_reads_jax[0].req, Request)
        assert jserve.clear_drained(str(tmp_path / "port")) is True
        assert clear_drained(str(tmp_path / "jax")) is True

    def test_port_finishes_a_jax_drain(self, weights, tmp_path):
        """A JAX engine drained mid-run; its file restored into the
        port's engine: every request ends with JAX's uninterrupted
        tokens, held under ``greedy_agree``."""
        jcfg, jparams, tparams = weights

        def jsched(reqs):
            sched = jserve.RequestScheduler(jserve.SchedulerConfig(),
                                            num_slots=SLOTS)
            for r in reqs:
                sched.submit(r)
            return sched

        jecfg = jserve.EngineConfig(num_slots=SLOTS)
        want = jserve.serve_loop(jserve.ServingEngine(jparams, jcfg, jecfg),
                                 jsched(make_requests(jserve)))
        engine = jserve.ServingEngine(jparams, jcfg, jecfg)
        plan = jfaults.FaultPlan([jfaults.FaultPoint(
            "serve.loop", "preempt", hit=4)])
        with plan.armed():
            early = jserve.serve_loop(engine, jsched(make_requests(jserve)),
                                      max_dispatches=2000)
        assert engine.drained
        jserve.persist_drained(str(tmp_path), engine.drained)
        restored = load_drained(str(tmp_path))
        done = set(early) | {rr.req.rid for rr in restored}
        sched = RequestScheduler(SchedulerConfig(), num_slots=SLOTS)
        for r in make_requests():
            if r.rid not in done:
                sched.submit(r)
        got = {rid: (list(t), why) for rid, (t, why) in early.items()}
        got.update(serve_loop(ServingEngine(tparams, CFG, EngineConfig(
            num_slots=SLOTS)), sched, resume=restored, max_dispatches=2000))
        assert got.keys() == want.keys()
        reqs = {r.rid: r for r in make_requests()}
        for rid, (toks, reason) in want.items():
            seq = np.asarray([list(reqs[rid].prompt) + list(toks[:-1])],
                             np.int32)
            logits = np.asarray(jtf.transformer_apply(jparams, seq,
                                                      jcfg)[0])
            ok, why = greedy_agree(toks, got[rid][0],
                                   logits[len(reqs[rid].prompt) - 1:])
            assert ok, f"rid {rid}: {why}"


class TestResumeFrame:
    @pytest.mark.parametrize("replica", [-1, 2])
    def test_bytes_equal_jax(self, replica):
        def addr_of(_ref):
            return ("127.0.0.1", 0)
        port = snapshots(tserve)
        jax_ = snapshots(jserve)
        for p, j in zip(port, jax_):
            got = wire.encode(wire.resumable_to_frame(p, replica), addr_of)
            assert got == jax_wire.encode(
                jax_wire.resumable_to_frame(j, replica), addr_of)
            back = wire.frame_to_resumable(wire.decode(got, lambda a: a))
            assert fields(back)[:7] == fields(p)[:7]
            assert back.generated == p.generated and back.slot == -1
            assert back.req.tenant is None  # the tenant stays router-side


def _metrics_tokens(path: pathlib.Path) -> float:
    try:
        snap = parse_prometheus_text(path.read_text())
    except FileNotFoundError:
        return 0.0
    return snap.get(("serve_decode_tokens_total", ()), 0.0)


def test_cli_sigterm_drains_and_the_next_run_restores(tmp_path):
    """SIGTERM a ``cli serve --device cpu --drain-dir`` process mid-run:
    it drains and exits 0, the drain file holds its in-flight requests;
    a second run restores them with the uninterrupted run's tokens and
    clears the file."""
    argv = ["serve", "--device", "cpu", "--vocab", "67", "--d-model", "64",
            "--n-heads", "4", "--d-ff", "128", "--max-seq", "256",
            "--slots", "3", "--requests", "3", "--prompt-len", "3:6",
            "--max-new-tokens", "240", "--seed", "5",
            "--drain-dir", str(tmp_path / "drain")]
    prom = tmp_path / "child.prom"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "akka_allreduce_tpu_torch.cli", *argv,
         "--metrics-file", str(prom), "--metrics-interval", "0.02"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while _metrics_tokens(prom) == 0 and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    first = json.loads(out.strip().splitlines()[-1])
    assert first["drained"] == first["drain_persisted"] == 3, first
    assert "persisted 3 drained request(s)" in err
    drained = load_drained(str(tmp_path / "drain"))
    assert all(0 < len(rr.generated) < 240 for rr in drained)
    # the next process: the drain restored ahead of its own request
    args = cli.build_parser().parse_args(
        argv[:argv.index("--requests") + 1] + ["1"]
        + argv[argv.index("--requests") + 2:])
    report, got, _ = cli.run_serve(args)
    assert report["resumed"] == 3 and report["drained"] == 0
    assert not (tmp_path / "drain" / "drained_requests.json").exists()
    whole = cli.build_parser().parse_args(
        [a for a in argv if a not in ("--drain-dir",
                                      str(tmp_path / "drain"))])
    _, want, _ = cli.run_serve(whole)
    assert {r: got[r] for r in want} == want
    assert got[3][0] == want[0][0]  # the fresh request: rid 0's prompt
