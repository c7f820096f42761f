"""The error types of the port's fault injection.

Port of ref real_time_helmet_detection_tpu/runtime/errors.py:40
`InjectedBackendError`: the synthetic transient backend failure a
`ChaosInjector` raises at an instrumented site. Its message carries the
status prefix a real failure would (`UNAVAILABLE:`,
`DEADLINE_EXCEEDED:`). The serving engine's own errors (`SheddedError`,
`EngineClosedError`, `FetchHungError`) live in `serving/engine.py`, as
they do in the JAX package.
"""

from __future__ import annotations


class InjectedBackendError(RuntimeError):
    """Synthetic transient backend failure raised by a ChaosInjector."""


class TrainingDivergenceError(RuntimeError):
    """Sustained numeric divergence seen by the train sentinel: at least
    `--sentinel-divergence` consecutive skipped steps (ref
    runtime/errors.py:45). The device is healthy, the numerics are not;
    `train` answers it with a rollback to its last checkpoint."""
