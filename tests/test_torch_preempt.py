"""The port's preemption-notice poller (``runtime/preempt.py``) against a
local stand-in metadata server on 127.0.0.1: the JAX package's
``tests/test_preempt.py`` case list, and the notice driving the port's
serving drain, in the engine and through ``cli serve --preempt-poll
--drain-dir``. Only the endpoint is simulated; the watcher thread, its
fire-once rule, ``engine.request_drain()``, the loop's drain and the
persisted snapshots are the production path.
"""

import http.server
import json
import threading
import time

import numpy as np
import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.runtime.preempt import (
    GCE_PREEMPTED_URL,
    PreemptionWatcher,
)


class _MetaState:
    def __init__(self):
        self.preempted = False
        self.requests = 0
        self.trip_at = None  # TRUE from this GET on, when set


@pytest.fixture
def metadata():
    state = _MetaState()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - the stdlib's name
            state.requests += 1
            if state.trip_at is not None \
                    and state.requests >= state.trip_at:
                state.preempted = True
            body = b"TRUE" if state.preempted else b"FALSE"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield state, f"http://127.0.0.1:{srv.server_address[1]}/preempted"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)


def test_the_default_url_is_gce_s():
    """The default endpoint is the JAX package's (these tests never
    poll it: every watcher here reads 127.0.0.1)."""
    from akka_allreduce_tpu.runtime import preempt as jax_preempt
    assert GCE_PREEMPTED_URL == jax_preempt.GCE_PREEMPTED_URL


class TestPollOnce:
    def test_reads_flag(self, metadata):
        state, url = metadata
        w = PreemptionWatcher(lambda: None, url=url)
        assert w.poll_once() is False
        state.preempted = True
        assert w.poll_once() is True
        assert w.errors == 0 and w.polls == 2

    def test_unreachable_reads_false(self):
        """No metadata server: a poll reads False and counts an error —
        never raises, never fires."""
        w = PreemptionWatcher(lambda: None,
                              url="http://127.0.0.1:1/preempted",
                              timeout_s=0.2)
        assert w.poll_once() is False
        assert w.errors == 1

    def test_validation(self):
        with pytest.raises(ValueError, match="interval_s"):
            PreemptionWatcher(lambda: None, interval_s=0.0)


class TestWatcherThread:
    def test_fires_once_then_stops(self, metadata):
        state, url = metadata
        fired = []
        with PreemptionWatcher(lambda: fired.append(1), url=url,
                               interval_s=0.02) as w:
            time.sleep(0.1)
            assert not w.fired
            state.preempted = True
            deadline = time.monotonic() + 5.0
            while not w.fired and time.monotonic() < deadline:
                time.sleep(0.02)
        assert w.fired
        assert fired == [1]  # exactly once; the thread exits after

    def test_started_twice_refused(self, metadata):
        _, url = metadata
        w = PreemptionWatcher(lambda: None, url=url, interval_s=0.05)
        with w:
            with pytest.raises(RuntimeError, match="already started"):
                w.start()
        assert w._thread is None

    def test_drives_serving_drain(self, metadata):
        """The notice stops admission and drains the in-flight requests
        as snapshots; restored into a fresh engine they finish with
        ``generate``'s tokens. The endpoint flips to TRUE as the third
        request is admitted, so the drain meets work in flight."""
        from akka_allreduce_tpu_torch.models.generate import generate
        from akka_allreduce_tpu_torch.models.transformer import (
            TransformerConfig, init_transformer)
        from akka_allreduce_tpu_torch.serving import (
            PagedEngineConfig, PagedServingEngine, Request,
            RequestScheduler, SchedulerConfig, ServingMetrics, serve_loop)
        state, url = metadata
        cfg = TransformerConfig(vocab_size=61, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=48)
        params = init_transformer(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(3)
        reqs = [Request(rid=i, prompt=tuple(int(x) for x in rng.integers(
            0, 61, size=4)), max_new_tokens=40, submitted_at=0.0)
            for i in range(6)]

        class FlipOnThirdAdmit(ServingMetrics):
            def on_admit(self, rid, slot, prompt_len):
                if rid == 2:
                    state.preempted = True
                super().on_admit(rid, slot, prompt_len)

        engine = PagedServingEngine(
            params, cfg, PagedEngineConfig(num_slots=2, page_size=4))
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in reqs:
            sched.submit(r)
        with PreemptionWatcher(engine.request_drain, url=url,
                               interval_s=0.01) as w:
            results = serve_loop(engine, sched, metrics=FlipOnThirdAdmit(),
                                 max_dispatches=5000)
        assert w.fired
        assert engine.drained, "notice did not drain in-flight work"
        assert engine.pool.pages_in_use == 0
        fresh = PagedServingEngine(
            params, cfg, PagedEngineConfig(num_slots=2, page_size=4))
        while engine.drained or sched.unfinished:
            for rr in engine.drained:
                sched.bind(rr.req, fresh.restore(rr))
            results.update(serve_loop(fresh, sched, max_dispatches=5000))
            engine = fresh
        for r in reqs:
            want = generate(params, torch.tensor([r.prompt]), cfg,
                            steps=r.max_new_tokens)[0].tolist()
            assert list(results[r.rid][0]) == want, r.rid


def test_cli_preempt_poll_drains_into_the_drain_dir(metadata, tmp_path,
                                                    capsys):
    """``cli serve --preempt-poll URL --drain-dir D``: the notice drains
    the run, its report counts the drain and the polls, and the drained
    requests wait in D for the next run, which restores them and clears
    the file."""
    state, url = metadata
    state.trip_at = 3
    argv = ["serve", "--device", "cpu", "--vocab", "61", "--d-model", "32",
            "--n-heads", "2", "--n-layers", "4", "--d-ff", "64",
            "--max-seq", "128", "--slots", "2", "--requests", "2",
            "--prompt-len", "3:6", "--max-new-tokens", "120",
            "--drain-dir", str(tmp_path),
            "--preempt-poll", url, "--preempt-interval", "0.02"]
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["preempt_notice"] is True
    assert first["preempt_polls"] >= 3
    assert first["drained"] == first["drain_persisted"] == 2
    assert (tmp_path / "drained_requests.json").exists()
    state.trip_at, state.preempted = None, False
    assert cli.main(argv[:argv.index("--requests") + 1] + ["1"]
                    + argv[argv.index("--requests") + 2:]) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["resumed"] == 2 and second["drained"] == 0
    assert second["preempt_notice"] is False
    assert second["requests"]["completed"] == 3
    assert not (tmp_path / "drained_requests.json").exists()
