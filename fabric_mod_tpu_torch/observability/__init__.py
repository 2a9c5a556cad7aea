"""Observability: the metrics registry and its text exposition, the span
registry, and the tracer with block timelines, the flight recorder and
the device lens (the port of fabric_mod_tpu/observability/; its
operations HTTP server, logging and diagnostics are not ported)."""
from fabric_mod_tpu_torch.observability.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricOpts, MetricsProvider,
    default_provider)
from fabric_mod_tpu_torch.observability import tracing    # noqa: F401
