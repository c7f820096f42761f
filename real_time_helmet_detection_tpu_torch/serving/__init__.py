"""The serving engine of the PyTorch port (the JAX package's
`serving/engine.py`; no fleet router, cascade or streams yet) and the
load loops that measure it (`loadgen`, ref scripts/serve_bench.py)."""

from .engine import (CLOSED, DEFAULT_BUCKETS, DEGRADED,  # noqa: F401
                     DRAINING, SERVING, EngineClosedError, FetchHungError,
                     ServeFuture, ServingEngine, SheddedError,
                     resolve_buckets)
