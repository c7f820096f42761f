"""The error types of the port's fault injection, and the
transient-vs-permanent classifier of its training recovery.

Port of ref real_time_helmet_detection_tpu/runtime/errors.py:22-80:
`InjectedBackendError`, the synthetic transient backend failure a
`ChaosInjector` or the train loop's `FaultInjector` raises (its message
carries the status prefix a real failure would: `UNAVAILABLE:`,
`DEADLINE_EXCEEDED:`); `TrainingDivergenceError`; and the classifier
`--auto-resume` asks before it retries (`is_transient_backend_error`,
`classify_exception`, `classify_error_text`, `EXIT_TRANSIENT`), with
JAX's contract unchanged: status-prefix markers on a `RuntimeError`
(or an exception type named `XlaRuntimeError`, which alone may carry
the `INTERNAL:` marker), and an injected fault always transient. A
sticky CUDA error (an illegal address poisons the context) is raised by
PyTorch as another type and classifies as permanent, as does anything
else a retry would not cure. The serving engine's own errors
(`SheddedError`, `EngineClosedError`, `FetchHungError`) live in
`serving/engine.py`, as they do in the JAX package.

Stdlib only.
"""

from __future__ import annotations

# Status markers of a device or transport failure worth retrying; the
# status-prefix form, so that a programming error whose message merely
# mentions a connection does not retry
TRANSIENT_MARKERS = ("UNAVAILABLE:", "DEADLINE_EXCEEDED:",
                     "Unable to initialize backend", "Socket closed")
# XLA's generic assertion bucket: transient only on its own error type
TRANSIENT_MARKERS_XLA_ONLY = ("INTERNAL:",)

# exit code of a job whose failure a later retry may survive (EX_TEMPFAIL)
EXIT_TRANSIENT = 75


class InjectedBackendError(RuntimeError):
    """Synthetic transient backend failure raised by a ChaosInjector or
    the train loop's FaultInjector."""


class TrainingDivergenceError(RuntimeError):
    """Sustained numeric divergence seen by the train sentinel: at least
    `--sentinel-divergence` consecutive skipped steps (ref
    runtime/errors.py:45). The device is healthy, the numerics are not,
    so it is not transient; `train` answers it with a rollback to its
    last checkpoint."""


def is_transient_backend_error(e: BaseException) -> bool:
    """Would retrying after a backend re-init plausibly succeed?"""
    if isinstance(e, InjectedBackendError):
        return True
    if type(e).__name__ not in ("XlaRuntimeError", "RuntimeError"):
        return False
    msg = str(e)
    if any(m in msg for m in TRANSIENT_MARKERS):
        return True
    return type(e).__name__ == "XlaRuntimeError" and \
        any(m in msg for m in TRANSIENT_MARKERS_XLA_ONLY)


def classify_exception(e: BaseException) -> str:
    """'transient' | 'permanent' for status lines."""
    return "transient" if is_transient_backend_error(e) else "permanent"


def classify_error_text(text: str) -> str:
    """Classification when only the message text survives: the
    unambiguous status-prefix markers alone classify as transient."""
    return ("transient" if any(m in text for m in TRANSIENT_MARKERS)
            else "permanent")
