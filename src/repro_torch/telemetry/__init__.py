"""Unified telemetry: structured events, span timers, trust-ratio
recording, and the regression-gated run report (port of
``repro.telemetry``; docs/observability.md walks through the reference).
"""
from repro_torch.telemetry.events import (
    EVENT_TYPES,
    SCHEMA_VERSION,
    EventLog,
    config_hash,
    read_events,
    run_provenance,
    validate_event,
)
from repro_torch.telemetry.report import Check, CompareResult, RunReport
from repro_torch.telemetry.spans import SpanRecorder
from repro_torch.telemetry.trust import HIST_EDGES, PER_LAYER_KEY, TrustRecorder, leaf_names

__all__ = [
    "Check",
    "CompareResult",
    "EVENT_TYPES",
    "EventLog",
    "HIST_EDGES",
    "PER_LAYER_KEY",
    "RunReport",
    "SCHEMA_VERSION",
    "SpanRecorder",
    "TrustRecorder",
    "config_hash",
    "leaf_names",
    "read_events",
    "run_provenance",
    "validate_event",
]
