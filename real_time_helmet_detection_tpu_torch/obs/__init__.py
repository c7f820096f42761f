"""Flight recorder of the port's serving engine and train loop: trace
contexts, spans, live metrics, the SLO watchdog and the step telemetry
and the readers of what it writes (the JAX package's `obs/trace.py`,
`obs/spans.py`, `obs/metrics.py`, `obs/slo.py`, `obs/telemetry.py` and
`obs/traceview.py`; torch-free but the telemetry)."""

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MetricsWriter, default_registry,
                      latest_path, maybe_writer, read_latest, read_metrics,
                      reset_default_registry, snapshot_digest)
from .slo import (DriftDetector, SloWatchdog,  # noqa: F401
                  default_serving_rules, default_tenant_rules,
                  default_train_rules)
from .spans import SpanTracer, maybe_tracer, read_spans  # noqa: F401
from .trace import TraceContext, links_of, new_root, reset_ids  # noqa: F401
from .traceview import (analyze, assemble, assemble_logs,  # noqa: F401
                        critical_path, tail_exemplars, waterfall)
