"""Flight recorder of the port's serving engine: trace contexts, spans
and live metrics (the JAX package's `obs/trace.py`, `obs/spans.py` and
`obs/metrics.py`, copied as far as the engine uses them; stdlib only)."""

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MetricsWriter, default_registry,
                      maybe_writer)
from .spans import SpanTracer, maybe_tracer, read_spans  # noqa: F401
from .trace import TraceContext, links_of, new_root, reset_ids  # noqa: F401
