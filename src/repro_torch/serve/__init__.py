"""repro_torch.serve — multi-tenant streaming neighbor-query service (the
reference's ``repro.serve`` on PyTorch).

Layers a serving contract over the functional core and the device-resident
executor: a scene registry (LRU residency, one variant per search
signature), an admission queue with signature-bucket micro-batching (one
concatenated ``api.query`` — on the card's fused path one
``knn_tile_anchored`` launch — and one host sync per drained batch),
futures with bounded-queue backpressure, per-scene fairness, and full
``repro_torch.obs`` telemetry (queue depth, batch occupancy, p50/p95/p99
request latency). It runs on the card unless the caller passes
``device="cpu"``.

Quickstart::

    from repro_torch.serve import NeighborService
    from repro_torch.core import SearchParams

    svc = NeighborService()          # device="cuda"
    svc.register_scene("city", points)
    futs = [svc.submit("city", q, SearchParams(radius=0.1, k=8))
            for q in request_queries]
    svc.drain()                      # or svc.start() for a background pump
    results = [f.result() for f in futs]
"""
from ..reliability.errors import (Cancelled, CircuitOpen,  # noqa: F401
                                  DeadlineExceeded, QueryError)
from ..reliability.quality import ResultQuality  # noqa: F401
from .batcher import (BatchReport, MicroBatcher, Request,  # noqa: F401
                      StagedBatch, split_result, stage_batch)
from .registry import (SceneRecord, SceneRegistry,  # noqa: F401
                       SceneVariant)
from .service import (NeighborService, Rejected,  # noqa: F401
                      ServeFuture, ServeOpts)

__all__ = [
    "BatchReport",
    "Cancelled",
    "CircuitOpen",
    "DeadlineExceeded",
    "MicroBatcher",
    "NeighborService",
    "QueryError",
    "Rejected",
    "Request",
    "ResultQuality",
    "SceneRecord",
    "SceneRegistry",
    "SceneVariant",
    "ServeFuture",
    "ServeOpts",
    "StagedBatch",
    "split_result",
    "stage_batch",
]
