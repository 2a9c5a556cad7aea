"""Observability: the metrics registry and its text exposition, the span
registry, the tracer with block timelines, the flight recorder and the
device lens, logging level specs, diagnostics and the operations HTTP
server with its health registry (the port of
fabric_mod_tpu/observability/)."""
from fabric_mod_tpu_torch.observability.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricOpts, MetricsProvider,
    default_provider)
from fabric_mod_tpu_torch.observability.logging import (  # noqa: F401
    activate_spec, get_logger, init_logging)
from fabric_mod_tpu_torch.observability.opsserver import (  # noqa: F401
    HealthRegistry, OperationsServer, default_health)
from fabric_mod_tpu_torch.observability import tracing    # noqa: F401
