"""Observability: metrics registry, spans, JSONL event log
(:mod:`repro_torch.obs.registry`) and solve traces
(:mod:`repro_torch.obs.trace`)."""
from repro_torch.obs.registry import (DEFAULT_WINDOW, EVENT_SCHEMA_VERSION,
                                      Counter, Gauge, Histogram,
                                      MetricsRegistry, NullRegistry,
                                      default_registry,
                                      set_default_registry)
from repro_torch.obs.trace import (CHUNK, TRACE_LEN, SolveTrace,
                                   instrumented_tol_loop)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NullRegistry", "default_registry", "set_default_registry",
           "DEFAULT_WINDOW", "EVENT_SCHEMA_VERSION",
           "CHUNK", "TRACE_LEN", "SolveTrace", "instrumented_tol_loop"]
