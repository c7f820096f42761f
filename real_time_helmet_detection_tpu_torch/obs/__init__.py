"""Flight recorder of the port's serving engine: trace contexts, spans,
live metrics and the SLO watchdog (the JAX package's `obs/trace.py`,
`obs/spans.py`, `obs/metrics.py` and `obs/slo.py`, copied as far as the
engine uses them; stdlib only)."""

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MetricsWriter, default_registry,
                      maybe_writer)
from .slo import (DriftDetector, SloWatchdog,  # noqa: F401
                  default_serving_rules, default_tenant_rules,
                  default_train_rules)
from .spans import SpanTracer, maybe_tracer, read_spans  # noqa: F401
from .trace import TraceContext, links_of, new_root, reset_ids  # noqa: F401
