"""Serving plane of the port: continuous-batching decode, greedy or
sampled, on float or int8 KV, plain or speculative, under the watchdog,
fault injection and drain/restore.

Counterpart of ``akka_allreduce_tpu/serving``: ``engine.py`` (slot and
paged engines, ``serve_loop``, the drain file), ``paging.py`` (the page allocator),
``scheduler.py`` (admission queue, backpressure, retry budget),
``metrics.py`` (``ServingMetrics``) and ``admission.price``. Replicas,
routers, the stress load generator and the admission controller are
later slices (ROADMAP.md).

Entry point: ``python -m akka_allreduce_tpu_torch.cli serve`` (cli.py).
"""

from akka_allreduce_tpu_torch.serving.engine import (
    DRAIN_STATE_NAME,
    RETRYABLE_REASONS,
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    PagedSpeculativeEngine,
    ResumableRequest,
    ServingEngine,
    SpeculativeEngine,
    WatchdogTimeout,
    clear_drained,
    load_drained,
    persist_drained,
    serve_loop,
)
from akka_allreduce_tpu_torch.serving.metrics import (
    Histogram,
    ServingMetrics,
)
from akka_allreduce_tpu_torch.serving.paging import AdmitPlan, PagePool, pages_for
from akka_allreduce_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    RequestScheduler,
    RetryPolicy,
    SchedulerConfig,
)

__all__ = [
    "AdmitPlan",
    "DRAIN_STATE_NAME",
    "EngineConfig",
    "Histogram",
    "PagePool",
    "PagedEngineConfig",
    "PagedServingEngine",
    "PagedSpeculativeEngine",
    "QueueFull",
    "Request",
    "RETRYABLE_REASONS",
    "RequestScheduler",
    "ResumableRequest",
    "RetryPolicy",
    "SchedulerConfig",
    "ServingEngine",
    "ServingMetrics",
    "SpeculativeEngine",
    "WatchdogTimeout",
    "clear_drained",
    "load_drained",
    "pages_for",
    "persist_drained",
    "serve_loop",
]
