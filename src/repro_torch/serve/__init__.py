"""Scheduler-as-a-service: coalescing request batcher over the sweep
engine (DESIGN.md §14).

:class:`SchedulerService` admits a stream of heterogeneous scheduling
requests, coalesces them into the engine's pow2 shape buckets, flushes
each bucket as ONE batched dispatch (max-batch or max-delay trigger), and
demuxes per-request :class:`ScheduleFuture` results — with ahead-of-time
:meth:`~SchedulerService.warm` plan builds and bounded-admission
backpressure. The port of ``repro.serve``.
"""

from .coalesce import coalesce_key, combine_batches, pow2_ladder, warm_batch
from .service import (
    FleetFuture,
    FrontierFuture,
    ScheduleFuture,
    SchedulerService,
    ServiceClosed,
    ServiceOverloaded,
)

__all__ = [
    "FleetFuture",
    "FrontierFuture",
    "ScheduleFuture",
    "SchedulerService",
    "ServiceClosed",
    "ServiceOverloaded",
    "coalesce_key",
    "combine_batches",
    "pow2_ladder",
    "warm_batch",
]
