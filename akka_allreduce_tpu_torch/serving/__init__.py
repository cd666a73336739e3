"""Serving plane of the port: continuous-batching decode, greedy or
sampled, on float or int8 KV, plain or speculative.

Counterpart of ``akka_allreduce_tpu/serving``: ``engine.py`` (slot and
paged engines, ``serve_loop``), ``paging.py`` (the page allocator),
``scheduler.py`` (admission queue, backpressure, retry budget),
``metrics.py`` (``ServingMetrics``) and ``admission.price``. Replicas,
routers, the stress load generator and the admission controller are
later slices (ROADMAP.md).

Entry point: ``python -m akka_allreduce_tpu_torch.cli serve`` (cli.py).
"""

from akka_allreduce_tpu_torch.serving.engine import (
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    PagedSpeculativeEngine,
    ServingEngine,
    SpeculativeEngine,
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
    "EngineConfig",
    "Histogram",
    "PagePool",
    "PagedEngineConfig",
    "PagedServingEngine",
    "PagedSpeculativeEngine",
    "QueueFull",
    "Request",
    "RequestScheduler",
    "RetryPolicy",
    "SchedulerConfig",
    "ServingEngine",
    "ServingMetrics",
    "SpeculativeEngine",
    "pages_for",
    "serve_loop",
]
