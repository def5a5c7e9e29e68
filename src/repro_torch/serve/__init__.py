"""`repro_torch.serve` — the resilient multi-tenant p-bit sampling service.

The *p-bit chip* serving layer: admission control + deadlines,
chains-axis request batching, a shape-bucketed LRU Session cache over
`api.spec_fingerprint`, heartbeat-driven shard-loss degradation, and a
deterministic fault-schedule harness.  ``python -m repro_torch.serve``
runs the demo loop.  Counterpart of ``repro.serve``, with the same
exports; `SamplerService` runs on ``device="cuda"`` unless given another.
"""
from repro_torch.serve.cache import (
    DEFAULT_BUCKETS,
    Embedding,
    SessionCache,
    bucket_shape,
    embed_graph,
    embed_program,
    make_bucket_graph,
    program_digest,
)
from repro_torch.serve.degrade import ShardHealthMonitor, ShardLostError
from repro_torch.serve.faultplan import FaultEvent, FaultInjector, FaultPlan
from repro_torch.serve.service import (
    AdmissionError,
    CircuitBreaker,
    CircuitOpenError,
    RequestResult,
    SampleRequest,
    SamplerService,
    ServiceError,
    Ticket,
)

__all__ = [
    "DEFAULT_BUCKETS", "Embedding", "SessionCache", "bucket_shape",
    "embed_graph", "embed_program", "make_bucket_graph", "program_digest",
    "ShardHealthMonitor", "ShardLostError",
    "FaultEvent", "FaultInjector", "FaultPlan",
    "AdmissionError", "CircuitBreaker", "CircuitOpenError",
    "RequestResult", "SampleRequest", "SamplerService", "ServiceError",
    "Ticket",
]
