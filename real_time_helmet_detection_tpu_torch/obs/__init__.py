"""Flight recorder of the port's serving engine and train loop: trace
contexts, spans, live metrics, the SLO watchdog and the step telemetry
(the JAX package's `obs/trace.py`, `obs/spans.py`, `obs/metrics.py`,
`obs/slo.py` and `obs/telemetry.py`, copied as far as the port uses
them; stdlib only but the telemetry, which imports torch)."""

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MetricsWriter, default_registry,
                      maybe_writer)
from .slo import (DriftDetector, SloWatchdog,  # noqa: F401
                  default_serving_rules, default_tenant_rules,
                  default_train_rules)
from .spans import SpanTracer, maybe_tracer, read_spans  # noqa: F401
from .trace import TraceContext, links_of, new_root, reset_ids  # noqa: F401
