"""The DCN hybrid's protocol on the port's trainer, in-process and fast.

Every class of the JAX package's ``tests/test_dcn_protocol.py``, case
for case, on ``akka_allreduce_tpu_torch/runtime/dcn_train.py``: the
``th_allreduce`` fraction gate (reference: AllreduceMaster.scala:58),
auto-down and the probationary re-up (application.conf:20), per-bucket
contributions of a publish cut midway (ScatteredDataBuffer.scala:9-13,
ReducedDataBuffer.scala:40-48), the master's heartbeat, the replica CRC
check, the token-weighted mean and the wire format. N trainers run in
threads over one ``tests/kv_fake.py FakeKvClient`` with the same
host-math grad step as the JAX tests (rank-dependent constant
gradients); the JAX tests' ``optax.sgd(lr)`` is the port's sgd without
momentum, and their ``(params, opt_state)`` pair the port's
``TrainState``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from kv_fake import FakeKvClient

from akka_allreduce_tpu_torch.models.train import (TrainConfig, TrainState,
                                                   make_optimizer)
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.runtime.dcn_train import (
    DcnDeadlineTrainer,
    decode_payload,
    encode_payload,
)

DIM = 64


def make_trainer(rank, n, client, *, lr=0.1, grad=None, step_sleep=0.0,
                 tokens=8.0, **kw):
    """A trainer whose local compute plane is host math: rank-dependent
    constant gradients (rank+1 everywhere unless ``grad`` overrides),
    optionally slowed by ``step_sleep`` to script per-peer pacing;
    ``tokens`` is this rank's reported local token count (the
    token-weighted DCN mean's weight)."""
    cfg = sgd_config(kw.pop("opt_lr", lr))

    def gstep(params, toks, r):
        if step_sleep:
            time.sleep(step_sleep)
        g = (grad(rank, int(r)) if grad is not None
             else np.full(DIM, float(rank + 1), np.float32))
        return {"w": g}, {"loss": float(rank + 1), "tokens": tokens}

    kw.setdefault("retain_rounds", 16)
    kw.setdefault("hb_interval_s", 0.1)
    kw.setdefault("hb_timeout_s", 0.0)  # off unless the test watches it
    return DcnDeadlineTrainer(cfg, None, rank=rank, num_processes=n,
                              client=client, grad_step=gstep, **kw)


def sgd_config(lr):
    """The JAX tests' plain sgd at ``lr``: the port's sgd without
    momentum (the model is never built: the stub step stands for it)."""
    model = TransformerConfig(vocab_size=8, d_model=8, n_heads=2,
                              n_layers=1, d_ff=8, max_seq=4)
    return TrainConfig(model=model, learning_rate=lr, optimizer="sgd",
                       sgd_momentum=0.0, bucket_elems=1024)


def fresh_state(tr):
    """The zero parameters of the JAX tests and the trainer's optimizer
    over them."""
    params = {"w": torch.zeros(DIM, dtype=torch.float32,
                               requires_grad=True)}
    return TrainState(params=params,
                      optimizer=make_optimizer(tr.cfg, params))


def weights(state):
    return state.params["w"].detach().numpy().copy()


def drive(tr, steps, results, errors, *, stall_at=None, stall_s=0.0):
    """The CLI's hybrid loop in miniature: catch_up first, stop at the
    same final round everywhere (cli.py train's round-driven loop)."""
    state = fresh_state(tr)
    try:
        while True:
            tr.catch_up(state)
            i = tr.round
            if i >= steps:
                break
            if stall_at is not None and i >= stall_at and stall_s:
                time.sleep(stall_s)
                stall_s = 0.0  # one stall only
            tr.run_round(state, None)
        tr.drain(state)
        results[tr.rank] = weights(state)
    except Exception as exc:  # noqa: BLE001 — surfaced by the test body
        errors[tr.rank] = exc
    finally:
        tr.close()


def run_cluster(trainers, steps, **per_rank_kw):
    results, errors = {}, {}
    threads = [threading.Thread(
        target=drive, args=(tr, steps, results, errors),
        kwargs=per_rank_kw.get(tr.rank, {}), daemon=True)
        for tr in trainers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():  # dump WHERE it hangs before failing
            import faulthandler
            faulthandler.dump_traceback()
            raise AssertionError("cluster thread hung")
    return results, errors


class TestFractionGate:
    def test_th_allreduce_closes_rounds_early(self):
        """4 peers, th=0.75: rounds close the moment 3 arrive — the
        chronically-slow 4th (0.6 s/step vs a 6 s deadline) costs
        nothing. With th=1.0 every round would wait its arrival."""
        client = FakeKvClient()
        n, steps = 4, 4
        master = make_trainer(0, n, client, deadline_s=6.0,
                              th_allreduce=0.75, down_after=0)
        workers = [make_trainer(i, n, client, deadline_s=6.0,
                                th_allreduce=0.75, down_after=0,
                                step_sleep=0.6 if i == 3 else 0.0)
                   for i in range(1, n)]
        results, errors = {}, {}
        threads = [threading.Thread(target=drive,
                                    args=(w, steps, results, errors),
                                    daemon=True) for w in workers]
        for t in threads:
            t.start()
        state = fresh_state(master)
        durations = []
        try:
            for _ in range(steps):
                t0 = time.monotonic()
                rep = master.run_round(state, None)
                durations.append(time.monotonic() - t0)
        finally:
            master.close()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors, errors
        # post-barrier rounds close at the fraction, far under the slow
        # peer's 0.6 s step (and the 6 s deadline th=1.0 would risk)
        assert all(d < 0.45 for d in durations[1:]), durations
        post = master.reports[1:]
        assert all(r.valid_peers[1] and r.valid_peers[2] for r in post)
        assert sum(1 for r in post if not r.valid_peers[3]) >= 2, \
            [r.valid_peers for r in post]
        # the slow peer still finishes identically (replays the masks)
        np.testing.assert_array_equal(results[3],
                                      weights(state))


class TestAutoDown:
    def test_dead_peer_stops_costing_the_deadline(self):
        """The verdict's core scenario: kill a worker permanently.
        Pre-down rounds each burn the full deadline; after down_after
        consecutive misses the master stops waiting and per-round wall
        time returns to ~step time, forever."""
        client = FakeKvClient()
        n, steps, deadline = 2, 10, 0.5
        master = make_trainer(0, n, client, deadline_s=deadline,
                              down_after=3)
        worker = make_trainer(1, n, client, deadline_s=deadline,
                              down_after=3)
        results, errors = {}, {}
        t = threading.Thread(target=drive, args=(worker, 2, results,
                                                 errors), daemon=True)
        t.start()  # participates in rounds 0-1, then dies for good
        state = fresh_state(master)
        durations = []
        try:
            for _ in range(steps):
                t0 = time.monotonic()
                rep = master.run_round(state, None)
                durations.append(time.monotonic() - t0)
        finally:
            master.close()
        t.join(timeout=60)
        assert not errors, errors
        reps = master.reports
        # rounds 2-4: masked at the deadline (consecutive misses 1..3)
        assert all(d >= deadline * 0.9 for d in durations[2:5]), durations
        assert all(r.n_masked == 1 for r in reps[2:5])
        # downed at round 4's close: every later round is step-speed
        assert reps[4].downed == (1,), [r.downed for r in reps]
        assert all(r.downed == (1,) for r in reps[5:])
        assert all(d < deadline * 0.5 for d in durations[5:]), durations

    def test_re_up_is_probationary(self):
        """Re-up restarts the miss counter at down_after - 1: a
        chronically-too-slow peer that keeps sneaking back in re-downs
        after ONE further miss (one burned deadline per oscillation,
        not down_after of them), while a recovered peer clears the
        counter with its first in-mask round. Stale reports (behind the
        frontier by more than the streaming window) never re-up."""
        from akka_allreduce_tpu_torch.messages import CompleteAllreduce
        client = FakeKvClient()
        m = make_trainer(0, 2, client, deadline_s=1.0, down_after=4)
        try:
            m._downed.add(1)
            m._frontier = 5
            m._on_message(CompleteAllreduce(src_id=1, round=2))
            assert m._downed == {1}  # 3 rounds behind: still down
            m._on_message(CompleteAllreduce(src_id=1, round=5))
            assert m._downed == set()
            assert m._consec_missed[1] == 3  # probation: 1 miss re-downs
        finally:
            m.close()

    @pytest.mark.slow  # wall-clock chain; the probation pin above is fast
    def test_caught_up_straggler_is_re_upped(self):
        """A downed peer that wakes, replays the retained masks and
        reports at the frontier is re-upped — the final rounds run
        unmasked with an empty downed set."""
        client = FakeKvClient()
        n, steps, deadline = 2, 30, 0.4
        master = make_trainer(0, n, client, deadline_s=deadline,
                              down_after=2, step_sleep=0.08)
        worker = make_trainer(1, n, client, deadline_s=deadline,
                              down_after=2)
        results, errors = {}, {}
        t = threading.Thread(
            target=drive, args=(worker, steps, results, errors),
            kwargs={"stall_at": 2, "stall_s": 1.8}, daemon=True)
        t.start()
        m = threading.Thread(target=drive,
                             args=(master, steps, results, errors),
                             daemon=True)
        m.start()
        for th in (m, t):
            th.join(timeout=120)
            assert not th.is_alive(), "cluster thread hung"
        assert not errors, errors
        reps = master.reports
        assert any(r.downed == (1,) for r in reps), \
            "the stalled peer was never downed"
        final = reps[-1]
        assert final.downed == (), [r.downed for r in reps[-5:]]
        assert final.n_masked == 0
        np.testing.assert_array_equal(results[0], results[1])


class TestBucketGranularWire:
    @pytest.mark.parametrize("wire", ["f32", "int8"])
    def test_mid_publish_cut_contributes_landed_buckets(self, wire):
        """Cut a worker between bucket 1 and bucket 2 of round 1: the
        master's probe credits the landed prefix — per-bucket mask rows,
        honest per-bucket counts, and every process applies the same
        per-bucket count-rescaled mean."""
        delayed = "aatdcn/g/000000000001/0001/0002"

        def on_set(key):
            if key == delayed:
                time.sleep(1.2)

        client = FakeKvClient(on_set=on_set)
        n, steps = 2, 3

        def grad(rank, r):
            return np.full(DIM, float(2 * rank + 1), np.float32)

        kw = dict(deadline_s=0.4, down_after=0, dcn_bucket_elems=16,
                  wire=wire, grad=grad)
        master = make_trainer(0, n, client, **kw)
        worker = make_trainer(1, n, client, **kw)
        results, errors = {}, {}
        t = threading.Thread(target=drive,
                             args=(worker, steps, results, errors),
                             daemon=True)
        t.start()
        state = fresh_state(master)
        reps = []
        try:
            for i in range(steps):
                rep = master.run_round(state, None)
                reps.append(rep)
                if i == 1:
                    # let the cut worker finish its delayed publish and
                    # get round 2 on the wire before the master opens it
                    # — round 2 must be a CLEAN round, deterministically
                    time.sleep(1.6)
        finally:
            master.close()
        t.join(timeout=60)
        assert not errors, errors
        r1 = reps[1]
        # the cut worker is PARTIAL, not masked: 2 of 4 buckets landed
        assert r1.n_masked == 0 and r1.n_partial == 1, r1
        assert r1.bucket_counts == (2, 2, 1, 1), r1.bucket_counts
        assert r1.valid_peers == (True, True)
        # recovered rounds are clean again
        assert reps[2].bucket_counts == (2, 2, 2, 2), reps[2]
        # every process applied the identical per-bucket means
        np.testing.assert_array_equal(results[1],
                                      weights(state))
        if wire == "f32":
            # exact math: g0=1, g1=3. r0 and r2 average to 2 everywhere;
            # r1 averages only where the worker's buckets landed
            lr = 0.1
            exp = np.full(DIM, -lr * 2.0, np.float32) * 2
            exp[:32] += -lr * 2.0   # buckets 0-1: (1+3)/2
            exp[32:] += -lr * 1.0   # buckets 2-3: master alone
            np.testing.assert_allclose(weights(state), exp,
                                       rtol=1e-6)


class TestMasterLiveness:
    def test_dead_master_detected_in_seconds(self):
        """A master that beat once and died: the worker's mask wait
        fails within the heartbeat window, not the multi-minute
        2*deadline+barrier timeout."""
        client = FakeKvClient()
        w = make_trainer(1, 2, client, deadline_s=60.0, hb_timeout_s=0.4)
        client.key_value_set("aatdcn/hb", "7", allow_overwrite=True)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="heartbeat"):
            w._read_mask(0)
        assert time.monotonic() - t0 < 5.0
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="heartbeat"):
            w.wait_snapshot(None, timeout_s=60.0)
        assert time.monotonic() - t0 < 5.0
        w.close()

    def test_no_heartbeat_ever_is_not_a_death(self):
        """Before the first beat the watch never fires (the master may
        still be compiling): the wait runs to its own timeout."""
        client = FakeKvClient()
        w = make_trainer(1, 2, client, deadline_s=0.1, hb_timeout_s=0.3,
                         barrier_timeout_s=0.5)
        with pytest.raises(TimeoutError, match="stopped publishing"):
            w._read_mask(0)
        w.close()


class TestReplicaDivergence:
    def test_divergent_replicas_fail_loudly(self):
        """Give the worker a different learning rate: params drift, the
        CRC cross-check trips on the master — and the worker then sees
        the master's death through the heartbeat, end to end."""
        client = FakeKvClient()
        n, steps = 2, 8
        master = make_trainer(0, n, client, deadline_s=2.0,
                              check_every=2)
        worker = make_trainer(1, n, client, deadline_s=2.0,
                              check_every=2, opt_lr=0.2,
                              hb_timeout_s=0.5)
        results, errors = run_cluster([master, worker], steps)
        assert 0 in errors and "replica divergence" in str(errors[0]), \
            errors
        assert 1 in errors and isinstance(errors[1],
                                          (TimeoutError, RuntimeError)), \
            errors

    def test_master_dead_before_first_beat_fails_fast(self):
        """A master that crashes before its heartbeat thread ever
        publishes (hb_interval here outlives the run) leaves NOTHING for
        the worker's hb watch to observe — the watch deliberately never
        fires on no-beat-yet. The unconditional done marker from the
        master's close() must catch that death, or the worker waits the
        full 2*deadline + barrier_timeout slow path (the load-induced
        hang this pins: under GIL contention a FakeKv run can finish
        before the 0.1s first beat)."""
        client = FakeKvClient()
        t0 = time.monotonic()
        master = make_trainer(0, 2, client, deadline_s=2.0,
                              check_every=2, hb_interval_s=3600.0)
        worker = make_trainer(1, 2, client, deadline_s=2.0,
                              check_every=2, opt_lr=0.2,
                              hb_timeout_s=0.5)
        results, errors = run_cluster([master, worker], 8)
        assert 0 in errors and "replica divergence" in str(errors[0]), \
            errors
        assert 1 in errors and isinstance(errors[1],
                                          (TimeoutError, RuntimeError)), \
            errors
        assert time.monotonic() - t0 < 30  # not the 304s slow path

    def test_identical_replicas_pass(self):
        client = FakeKvClient()
        n, steps = 2, 6
        trainers = [make_trainer(i, n, client, deadline_s=2.0,
                                 check_every=2) for i in range(n)]
        results, errors = run_cluster(trainers, steps)
        assert not errors, errors
        np.testing.assert_array_equal(results[0], results[1])


class TestTokenWeightedMean:
    def test_uneven_batches_average_by_token_count(self):
        """rank 0 reports 8 tokens with grad 1s, rank 1 reports 24 with
        grad 2s: the applied gradient must be the token-weighted mean
        (8*1 + 24*2)/32 = 1.75, not the plain mean 1.5 — the exact
        global batch-mean gradient for uneven local batches (the u64
        wire tokens field's whole purpose)."""
        client = FakeKvClient()
        n = 2
        trainers = [make_trainer(i, n, client, deadline_s=5.0, lr=1.0,
                                 tokens=8.0 if i == 0 else 24.0,
                                 grad=lambda rk, r: np.full(
                                     DIM, float(rk + 1), np.float32))
                    for i in range(n)]
        results, errors = run_cluster(trainers, 1)
        assert not errors, errors
        # sgd lr=1, params start at 0: params == -weighted_mean_grad
        np.testing.assert_allclose(results[0], -1.75, rtol=1e-6)
        np.testing.assert_array_equal(results[0], results[1])

    def test_zero_token_nan_contributor_weighted_out(self):
        """An empty local batch's gradient is 0/0 = NaN; its zero token
        weight must exclude it ENTIRELY (0 * NaN would still poison the
        sum) — survivors' weighted mean applies clean, and the reported
        loss ignores the NaN too."""
        client = FakeKvClient()
        n = 2

        def grads(rk, r):
            if rk == 1:
                return np.full(DIM, np.nan, np.float32)
            return np.full(DIM, 2.0, np.float32)

        trainers = [make_trainer(i, n, client, deadline_s=5.0, lr=1.0,
                                 tokens=8.0 if i == 0 else 0.0,
                                 grad=grads) for i in range(n)]
        results, errors = run_cluster(trainers, 1)
        assert not errors, errors
        np.testing.assert_allclose(results[0], -2.0, rtol=1e-6)
        for tr in trainers:
            assert np.isfinite(tr.reports[-1].loss)

    def test_zero_token_round_fails_loudly(self):
        client = FakeKvClient()
        n = 2
        trainers = [make_trainer(i, n, client, deadline_s=5.0,
                                 tokens=0.0) for i in range(n)]
        results, errors = run_cluster(trainers, 1)
        assert errors, "all-zero token counts must not apply silently"
        assert any("0 tokens" in str(e) for e in errors.values()), errors


class TestWireFormat:
    def test_tokens_u64_exact(self):
        """The header carries token counts as u64 — exact beyond the
        f32 wire's old 2^24 precision cliff."""
        vec = np.zeros(4, np.float32)
        big = float(2 ** 33 + 7)
        _, toks, _ = decode_payload(encode_payload(vec, 0.0, big, "f32"))
        assert toks == 2 ** 33 + 7

    def test_stale_liveness_keys_cleared_on_master_boot(self):
        """A reused namespace holding a previous run's done marker and
        frozen heartbeat must not poison a fresh run: the master clears
        both at construction, so workers neither insta-die on the stale
        done key nor false-detect master death on the frozen beat."""
        client = FakeKvClient()
        client.key_value_set("aatdcn/done", "1")
        client.key_value_set("aatdcn/hb", "999")
        n, steps = 2, 4
        trainers = [make_trainer(i, n, client, deadline_s=2.0,
                                 hb_timeout_s=0.5 if i else 0.0)
                    for i in range(n)]
        results, errors = run_cluster(trainers, steps)
        assert not errors, errors
        np.testing.assert_array_equal(results[0], results[1])

    def test_stale_namespace_guidance(self):
        """A mask key left over from a previous run on the same
        coordination-service incarnation produces actionable guidance,
        not an opaque overwrite error."""
        client = FakeKvClient()
        client.key_value_set("aatdcn/mask/000000000000", "1")
        m = make_trainer(0, 1, client, deadline_s=1.0)
        state = fresh_state(m)
        with pytest.raises(RuntimeError, match="stale namespace"):
            m.run_round(state, None)
        m.close()
