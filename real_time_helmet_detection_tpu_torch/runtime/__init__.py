"""Fault injection, the transient-error classifier and liveness signals
of the port's serving engine and train loop (the JAX package's
`runtime/errors.py`, `runtime/faults.py` and `runtime/heartbeat.py`,
copied; no supervisor)."""

from .errors import InjectedBackendError  # noqa: F401
from .faults import (ALL_SITES, CASCADE_SITES,  # noqa: F401
                     FAULT_KINDS, FLEET_SITES, SERVE_SITES, STREAM_SITES,
                     ChaosInjector, FaultEvent, FaultSchedule,
                     maybe_injector)
