"""The serving engine of the PyTorch port (the JAX package's
`serving/engine.py`; no fleet router, cascade or streams yet)."""

from .engine import (CLOSED, DEFAULT_BUCKETS, DEGRADED,  # noqa: F401
                     DRAINING, SERVING, EngineClosedError, FetchHungError,
                     ServeFuture, ServingEngine, SheddedError,
                     resolve_buckets)
