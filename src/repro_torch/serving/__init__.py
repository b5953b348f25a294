"""Serving runtime (torch counterpart of repro/serving): the stepwise
continuous-batching ``Engine`` over device-resident paged KV pools, the
async / HTTP front end, the observability layer and the deprecated
run-to-drain shims, re-exported with the reference's public surface::

    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    eng = Engine(target, draft, EngineConfig(max_batch=4))
    rid = eng.add_request(prompt, SamplingParams(max_tokens=32))
    while eng.has_unfinished():
        for out in eng.step():          # one speculative round
            stream(out.new_token_ids)   # RequestOutput, incremental

Internals (engine-owned, import from their modules):
  paged_cache.PagedKVPool   — block-granular KV pages, free list, reservations
  request.Request           — lifecycle and per-request sampling key streams
  batcher.ContinuousBatcher — page-budget admission and the WDOS round model
  host_gather               — the frozen legacy gather/scatter loop (baseline)

Deprecated shims (each warns once): ``serve_sd``, ``serve_apsd``,
``serve_batch``, ``serve_batch_host``.
"""
from repro_torch.serving.api import (
    CompletionOutput,
    EngineConfig,
    RequestOutput,
    SamplingParams,
    default_detokenize,
    resolve_paged_attn_impl,
)
from repro_torch.serving.async_engine import AsyncEngine, QueueFullError
from repro_torch.serving.engine import (
    BatchConfig,
    Engine,
    ServingModel,
    make_interface,
    serve_apsd,
    serve_batch,
    serve_batch_host,
    serve_sd,
)
from repro_torch.serving.flight_recorder import ANOMALY_KINDS, FlightRecorder
from repro_torch.serving.observability import (
    LATENCY_BUCKETS,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.serving.server import CompletionServer
from repro_torch.serving.tracing import NULL_TRACER, NullTracer, Tracer, validate_chrome_trace

__all__ = [
    # the Engine API
    "Engine",
    "EngineConfig",
    "SamplingParams",
    "RequestOutput",
    "CompletionOutput",
    "ServingModel",
    "make_interface",
    "resolve_paged_attn_impl",
    "default_detokenize",
    # the async front end
    "AsyncEngine",
    "QueueFullError",
    "CompletionServer",
    # observability: metrics registry and span tracer
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "RATIO_BUCKETS",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "validate_chrome_trace",
    "FlightRecorder",
    "ANOMALY_KINDS",
    # deprecated run-to-drain shims (and their config type)
    "serve_sd",
    "serve_apsd",
    "serve_batch",
    "serve_batch_host",
    "BatchConfig",
]
