"""The serving plane of the PyTorch port (the JAX package's `serving/`):
the engine, the fleet router with tenants, tiers, canary rollouts and
cascade serving (`fleet`), delta-gated streaming video (`streams`), the
load loops that measure them (`loadgen`, ref scripts/serve_bench.py) and
the fleet, cascade and streams runs (`runs`)."""

from .engine import (CLOSED, DEFAULT_BUCKETS, DEGRADED,  # noqa: F401
                     DRAINING, SERVING, EngineClosedError, FetchHungError,
                     ServeFuture, ServingEngine, SheddedError,
                     resolve_buckets)
from .fleet import (FleetFuture, FleetRouter,  # noqa: F401
                    TenantSheddedError)
from .streams import (FrameResult, StreamFuture,  # noqa: F401
                      StreamSession, smooth_tile)
