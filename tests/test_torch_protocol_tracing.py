"""The port's tracer against the JAX package's.

The scenarios of ``tests/test_tracing.py``: each tracer-core scenario
runs on both ``Tracer`` classes and must read back the same events,
counters, spans, latencies and JSONL rows; the two cluster scenarios (a
healthy traced run, a dead worker seen through deathwatch) run on the
JAX ``LocalCluster`` and on the port's on the CPU, and must record the
same sequence of events, field for field, and the same counters.
"""

import pytest

from akka_allreduce_tpu import config as jax_config
from akka_allreduce_tpu.protocol.cluster import LocalCluster as JaxCluster
from akka_allreduce_tpu.runtime import tracing as jax_tracing
from akka_allreduce_tpu_torch import config as port_config
from akka_allreduce_tpu_torch.protocol.cluster import \
    LocalCluster as PortCluster
from akka_allreduce_tpu_torch.runtime import tracing as port_tracing

SIDES = {"jax": jax_tracing, "port": port_tracing}


def record_counts_and_orders_events(tr, _tmp):
    t = tr.Tracer()
    t.record("a", x=1)
    t.record("b", x=2)
    t.record("a", x=3)
    assert t.counters == {"a": 2, "b": 1}
    assert [e.kind for e in t.events] == ["a", "b", "a"]
    assert t.events[2].fields == {"x": 3}
    return [(e.kind, e.fields, e.parent_id) for e in t.events]


def span_measures_duration(tr, _tmp):
    clock_vals = iter([10.0, 10.5])
    t = tr.Tracer(clock=lambda: next(clock_vals))
    with t.span("work", round=3):
        pass
    (ev,) = t.events
    assert ev.kind == "work" and ev.duration_s == 0.5 and ev.ts == 10.0
    assert t.span_stats("work") == {
        "count": 1, "total_s": 0.5, "mean_s": 0.5, "max_s": 0.5}
    return [ev.as_dict(), t.span_stats("work")]


def span_records_on_exception(tr, _tmp):
    t = tr.Tracer(clock=lambda: 1.0)
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError("x")
    assert t.counters["boom"] == 1
    return [e.as_dict() for e in t.events]


def round_latency_pairs_start_to_last_complete(tr, _tmp):
    ts = iter([0.0, 1.0, 2.0, 5.0])
    t = tr.Tracer(clock=lambda: next(ts))
    t.record("round_start", round=0)
    t.record("round_complete", round=0, worker=0)
    t.record("round_start", round=1)
    t.record("round_complete", round=1, worker=0)
    assert t.round_latencies() == {0: 1.0, 1: 3.0}
    return [t.round_latencies(), t.summary()]


def max_events_cap_keeps_counters(tr, _tmp):
    t = tr.Tracer(max_events=2, clock=lambda: 0.5)
    for i in range(5):
        t.record("e", i=i)
    assert len(t.events) == 2 and t.counters["e"] == 5
    return [dict(t.counters), [e.as_dict() for e in t.events]]


def jsonl_round_trip(tr, tmp):
    t = tr.Tracer(clock=lambda: 1.25)
    t.record("x", round=7, worker=1)
    with t.span("y", round=7):
        pass
    path = str(tmp / f"trace-{tr.__name__}.jsonl")
    assert t.write_jsonl(path) == 2
    rows = tr.Tracer.read_jsonl(path)
    assert rows[0] == {"ts": 1.25, "kind": "x", "round": 7, "worker": 1}
    assert rows[1]["kind"] == "y" and "duration_s" in rows[1]
    with tr.tracer_to_file(str(tmp / "t2.jsonl")) as t2:
        t2.record("z", round=1)
    return [rows, tr.Tracer.read_jsonl(str(tmp / "t2.jsonl"))[0]["kind"]]


@pytest.mark.parametrize("scenario", [
    record_counts_and_orders_events, span_measures_duration,
    span_records_on_exception, round_latency_pairs_start_to_last_complete,
    max_events_cap_keeps_counters, jsonl_round_trip],
    ids=lambda f: f.__name__)
def test_tracer_core_matches_jax(scenario, tmp_path):
    got = {side: scenario(tr, tmp_path) for side, tr in SIDES.items()}
    assert got["port"] == got["jax"]


def make_config(cfg, n, data_size, chunk, max_round, th=(1.0, 1.0, 1.0)):
    return cfg.AllreduceConfig(
        thresholds=cfg.ThresholdConfig(*th),
        data=cfg.DataConfig(data_size=data_size, max_chunk_size=chunk,
                            max_round=max_round),
        workers=cfg.WorkerConfig(total_size=n, max_lag=1))


def traced_run(side, max_round, th=(1.0, 1.0, 1.0), kill_rank=None):
    tracer = SIDES[side].Tracer()
    if side == "jax":
        cluster = JaxCluster(make_config(jax_config, 4, 64, 16, max_round,
                                         th), tracer=tracer)
    else:
        cluster = PortCluster(make_config(port_config, 4, 64, 16, max_round,
                                          th), tracer=tracer, device="cpu")
    rounds = cluster.run(kill_rank=kill_rank)
    events = [(e.kind, e.fields, e.duration_s is None) for e in tracer.events]
    return rounds, tracer, events


def test_healthy_cluster_traces_the_jax_events():
    rounds = 5
    _, _, jax_events = traced_run("jax", rounds)
    got, tracer, events = traced_run("port", rounds)
    assert got == rounds
    assert events == jax_events
    assert tracer.counters["quorum_init"] == 1
    assert tracer.counters["member_up"] == 4
    assert tracer.counters["round_start"] >= rounds
    completes = [e for e in tracer.events if e.kind == "round_complete"]
    for r in range(rounds):
        assert {e.fields["worker"] for e in completes
                if e.fields["round"] == r} == set(range(4))
    fired = [e for e in tracer.events if e.kind == "reduce_fired"]
    assert fired and all(e.fields["contributors"] == 4 for e in fired)
    lat = tracer.round_latencies()
    assert set(range(rounds)) <= set(lat) and min(lat.values()) >= 0
    assert tracer.summary()["rounds_traced"] >= rounds


def test_dead_worker_traced_via_deathwatch_as_jax():
    th = (0.75, 0.75, 0.75)
    _, jax_tracer, jax_events = traced_run("jax", 3, th, kill_rank=2)
    _, tracer, events = traced_run("port", 3, th, kill_rank=2)
    assert events == jax_events
    assert dict(tracer.counters) == dict(jax_tracer.counters)
    dead = [e for e in tracer.events if e.kind == "worker_dead"]
    assert len(dead) == 1 and dead[0].fields["rank"] == 2
    assert tracer.counters["round_complete"] > 0
