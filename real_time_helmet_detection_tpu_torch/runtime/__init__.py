"""Fault injection for the port's serving engine (the JAX package's
`runtime/errors.py` and `runtime/faults.py`, copied; no supervisor)."""

from .errors import InjectedBackendError  # noqa: F401
from .faults import (ALL_SITES, FAULT_KINDS, SERVE_SITES,  # noqa: F401
                     ChaosInjector, FaultEvent, FaultSchedule,
                     maybe_injector)
