"""The port's job runtime: the transient-error classifier, fault
injection, liveness signals, the job spool and the supervisor (the JAX
package's `runtime/`, stdlib only; the supervisor's triage probes the
CUDA card). `python -m real_time_helmet_detection_tpu_torch.runtime.queue`
is the queue's command line."""

from .errors import (EXIT_TRANSIENT, InjectedBackendError,  # noqa: F401
                     TrainingDivergenceError, classify_error_text,
                     classify_exception, is_transient_backend_error)
from .faults import (ALL_SITES, CASCADE_SITES,  # noqa: F401
                     FAULT_KINDS, FLEET_SITES, SERVE_SITES, STREAM_SITES,
                     TRAIN_SITES, ChaosInjector, FaultEvent, FaultSchedule,
                     maybe_injector)
from .heartbeat import (FileHeartbeat, HangWatchdog,  # noqa: F401
                        heartbeat_age_s, maybe_job_heartbeat,
                        read_heartbeat, run_as_job, write_job_status)
from .spool import (CLAIM_WAIT, DONE, FAILED, QUEUED,  # noqa: F401
                    RUNNING, SALVAGED, JobSpec, JobState, Spool)
from .supervisor import (DEVICE_BUSY, HEALTHY, NO_DEVICE,  # noqa: F401
                         Supervisor, default_device_probe)
