"""The port's telemetry: ``telemetry/device.py`` and the grown
``telemetry/registry.py`` against the JAX package's, and ``train
--metrics-file --xprof-dir`` on the CPU.

The DeviceTimer cases are JAX tests/test_telemetry.py's, on a fake clock:
the host / device / gap split, an unmarked span, a failed dispatch. The
registry renders the same series as the JAX registry byte for byte
(Prometheus text) and value for value (JSON), and the port's parser reads
both. The train run writes a snapshot whose counters match the run and a
Chrome trace of the steps in the window.
"""

import json
import math

import pytest

from akka_allreduce_tpu.telemetry import registry as jreg
from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.runtime.tracing import Tracer
from akka_allreduce_tpu_torch.telemetry import registry as treg
from akka_allreduce_tpu_torch.telemetry.device import DeviceTimer


class TestDeviceTimer:
    def test_host_device_gap_split_exact(self):
        clock = iter([10.0, 10.1, 10.5, 11.0, 11.2, 11.3])
        reg = treg.MetricsRegistry()
        t = DeviceTimer("engine", registry=reg, annotate=False,
                        clock=lambda: next(clock))
        with t.span() as s:
            s.mark_dispatched()
        with t.span() as s:
            s.mark_dispatched()
        assert t.host_ms._vals == pytest.approx([100.0, 200.0])
        assert t.device_ms._vals == pytest.approx([400.0, 100.0])
        assert t.gap_ms._vals == pytest.approx([500.0])
        assert math.isclose(
            reg.value("engine_dispatch_gap_ms").percentile(50), 500.0)

    def test_unmarked_span_charges_host(self):
        clock = iter([1.0, 2.0])
        t = DeviceTimer("x", annotate=False, clock=lambda: next(clock))
        with t.span():
            pass
        assert t.host_ms._vals == [1000.0]
        assert t.device_ms._vals == [0.0]

    def test_failed_dispatch_records_nothing(self):
        tracer = Tracer()
        clock = iter([1.0, 10.0, 10.1, 10.3])
        t = DeviceTimer("engine", tracer=tracer, annotate=False,
                        clock=lambda: next(clock))
        with pytest.raises(RuntimeError):
            with t.span():
                raise RuntimeError("hung dispatch")
        assert t.host_ms.count == 0 and t.device_ms.count == 0
        assert tracer.events == []
        with t.span() as s:
            s.mark_dispatched()
        assert t.gap_ms._vals == []
        assert t.device_ms._vals == pytest.approx([200.0])

    def test_annotation_sites(self):
        with pytest.raises(ValueError, match="annotate_site"):
            DeviceTimer("x", annotate_site="thread")
        t = DeviceTimer("x", annotate_site="dispatch")
        with t.span() as s:
            with s.annotation():
                pass
        assert t.host_ms.count == 1


def fill(mod):
    """The same series on a registry of ``mod`` (JAX's or the port's)."""
    reg = mod.MetricsRegistry()
    reg.counter("train_steps_total", help="optimizer steps applied").inc(3)
    reg.counter("bytes_total", labels={"rank": "1"}).inc(2.5)
    reg.gauge("train_loss", help="latest step loss").set(5.25)
    h = reg.histogram("train_step_dispatch_device_ms",
                      help="device ms", labels={"site": 'a"b'})
    for v in (3.0, 1.0, 2.0, 10.5):
        h.record(v)
    reg.histogram("empty_ms")
    live = mod.Histogram()
    live.record(7.0)
    reg.register_histogram("live_ms", lambda: live, help="pulled")
    reg.register_callback("pulled_total", lambda: 41, help="a callback")
    reg.register_callback("level", lambda: 0.5, kind="gauge")
    return reg


def test_prometheus_text_is_the_jax_registrys_byte_for_byte():
    want, got = fill(jreg), fill(treg)
    text = got.to_prometheus_text()
    assert text == want.to_prometheus_text()
    assert got.to_json() == want.to_json()
    # repr: the empty histogram's quantiles are NaN, which != itself
    assert repr(treg.parse_prometheus_text(text)) == \
        repr(jreg.parse_prometheus_text(text))
    parsed = treg.parse_prometheus_text(text)
    assert parsed[("train_steps_total", ())] == 3.0
    assert parsed[("bytes_total", (("rank", "1"),))] == 2.5
    assert parsed[("train_step_dispatch_device_ms_count",
                   (("site", 'a\\"b'),))] == 4.0


def test_registry_rules():
    reg = treg.MetricsRegistry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c  # owned cells are get-or-create
    reg.register_callback("y", lambda: 1)
    with pytest.raises(ValueError, match="already registered"):
        reg.register_callback("y", lambda: 2)
    with pytest.raises(ValueError, match="already registered as"):
        reg.gauge("x_total", labels={"k": "v"})
    assert reg.names() == ["x_total", "y"]


def test_snapshot_writer_writes_at_stop(tmp_path):
    reg = treg.MetricsRegistry()
    reg.counter("n_total").inc(4)
    path = str(tmp_path / "m.prom")
    with reg.start_snapshotter(path, interval_s=60.0):
        pass
    with open(path) as f:
        assert treg.parse_prometheus_text(f.read())[("n_total", ())] == 4
    reg.write_snapshot(path, format="json")
    with open(path) as f:
        assert json.load(f)["n_total"]["values"][0]["value"] == 4


BASE = ["train", "--device", "cpu", "--d-model", "16", "--n-layers", "1",
        "--d-ff", "32", "--vocab", "31", "--seq", "8", "--batch", "4",
        "--log-every", "100"]


@pytest.mark.parametrize("spd", [1, 2], ids=["per_step", "chunks"])
def test_train_writes_metrics_and_trace(tmp_path, spd):
    metrics = str(tmp_path / "metrics.prom")
    trace_dir = tmp_path / "trace"
    report = cli.run_train(cli.build_parser().parse_args(BASE + [
        "--steps", "5", "--metrics-file", metrics, "--xprof-dir",
        str(trace_dir), "--xprof-steps", "2", "--steps-per-dispatch",
        str(spd)]))
    with open(metrics) as f:
        parsed = treg.parse_prometheus_text(f.read())
    assert parsed[("train_steps_total", ())] == 5
    assert parsed[("train_tokens_total", ())] == 5 * 4 * 8
    assert parsed[("train_loss", ())] == pytest.approx(report["losses"][-1])
    dispatches = 5 if spd == 1 else 3  # two chunks and a one-step tail
    for series in ("host", "device", "gap"):
        n = parsed[(f"train_step_dispatch_{series}_ms_count", ())]
        assert n == (dispatches - 1 if series == "gap" else dispatches)
    assert report["metrics_file"] == metrics
    with open(report["xprof_trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the steps in the window: per step, steps 2-3 (indices 1, 2); in
    # chunks, the chunk that starts at index 2 (steps 3-4)
    want = {"per_step": {"train_step#1", "train_step#2"},
            "chunks": {"train_step#1"}}["per_step" if spd == 1 else
                                        "chunks"]
    assert want <= names, sorted(n for n in names if "#" in n)


def test_trace_window_never_reached_warns(tmp_path, capsys):
    report = cli.run_train(cli.build_parser().parse_args(BASE + [
        "--steps", "2", "--steps-per-dispatch", "2", "--xprof-dir",
        str(tmp_path)]))
    assert report["xprof_trace"] is None
    assert "no steps reached the trace window" in capsys.readouterr().err
