"""Serving (port of ``repro.serve``): the static and continuous-batching
engines over the model's KV cache, the slot pool, the FCFS scheduler, the
fault injector and per-row sampling.

On a mesh, one engine a rank: ``Engine(model, params,
shard_ctx=ShardCtx(mesh))`` or ``ContinuousEngine(model, params,
shard_ctx=ShardCtx(mesh))`` (for one long-context slot,
``ShardCtx(mesh).with_rules(cache_seq=("data",))``), every rank called with
the same requests; the ranks agree every host reading the continuous
engine decides on, and rank 0 alone writes its telemetry."""
from repro_torch.serve.continuous import (
    ContinuousEngine,
    make_pool_decode_step,
    make_pool_prefill,
    serving_stats,
)
from repro_torch.serve.engine import Engine, Request, make_decode_step, make_prefill_step
from repro_torch.serve.faults import (
    SERVE_FAULT_KINDS,
    ServeFaultInjector,
    ServeFaultSpec,
    parse_fault_specs,
)
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.sampling import sample_tokens, top_k_mask
from repro_torch.serve.scheduler import (
    TERMINAL_STATUSES,
    FCFSScheduler,
    RequestStatus,
    ServeRequest,
    assign_arrivals,
    poisson_arrivals,
    request_tokens,
    trace_arrivals,
)

__all__ = [
    "ContinuousEngine",
    "Engine",
    "FCFSScheduler",
    "KVPool",
    "Request",
    "RequestStatus",
    "SERVE_FAULT_KINDS",
    "ServeFaultInjector",
    "ServeFaultSpec",
    "ServeRequest",
    "TERMINAL_STATUSES",
    "assign_arrivals",
    "make_decode_step",
    "make_pool_decode_step",
    "make_pool_prefill",
    "make_prefill_step",
    "parse_fault_specs",
    "poisson_arrivals",
    "request_tokens",
    "sample_tokens",
    "serving_stats",
    "top_k_mask",
    "trace_arrivals",
]
