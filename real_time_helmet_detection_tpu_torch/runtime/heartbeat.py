"""Liveness signals: in-process stall warnings and cross-process
heartbeats.

Port of ref real_time_helmet_detection_tpu/runtime/heartbeat.py:37-289,
stdlib only:

* `HangWatchdog` watches this process: it warns, with the thread stacks
  and an optional status line (the process loader's worker liveness),
  when no progress beat arrives for `warn_seconds` (`--hang-warn-seconds`;
  0 disables it). `pause()` holds the clock across a known-slow phase (a
  checkpoint save) and `resume()` restarts it.
* `FileHeartbeat` mirrors the beats into a small JSON file rewritten
  atomically, whose mtime a supervising process watches;
  `maybe_job_heartbeat()` binds one to $TPU_QUEUE_HEARTBEAT (`HEARTBEAT_ENV`,
  the JAX package's name, so one supervisor watches either package) and
  returns an inert stub otherwise. `read_heartbeat` / `heartbeat_age_s`
  read it back.
* `write_job_status` writes the job's machine-readable exit status to
  $TPU_QUEUE_STATUS (`STATUS_ENV`), which the supervisor
  (`runtime/supervisor.py`) reads instead of scraping logs; `run_as_job`
  runs a job's main function under that contract: 0 done,
  `EXIT_TRANSIENT` (75) transient, 1 permanent, classified by
  `runtime/errors.py`.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from typing import Optional

HEARTBEAT_ENV = "TPU_QUEUE_HEARTBEAT"
STATUS_ENV = "TPU_QUEUE_STATUS"


def _atomic_write_text(path: str, text: str) -> None:
    """tmp + os.replace: a reader (or a crash) never sees a torn file."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:  # graftlint: off=raw-artifact-write
        f.write(text)
    os.replace(tmp, path)


class FileHeartbeat:
    """A job's heartbeat file: `beat(label)` atomically rewrites
    `{"t": wall, "pid": ..., "label": ...}`; beats also land as
    `heartbeat` events in the span log when one is configured."""

    def __init__(self, path: str, tracer=None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if tracer is None:
            from ..obs.spans import maybe_tracer
            tracer = maybe_tracer()
        self._tracer = tracer

    def beat(self, label: str = "beat") -> None:
        try:
            _atomic_write_text(self.path, json.dumps(
                {"t": time.time(), "pid": os.getpid(), "label": str(label)}))
        except OSError:
            pass  # liveness reporting must never kill the job
        if getattr(self._tracer, "enabled", False):
            self._tracer.event("heartbeat", label=str(label))


class _NoopHeartbeat:
    """Inert stand-in when the process runs under no supervisor."""

    path = None

    def beat(self, label: str = "beat") -> None:
        pass


def maybe_job_heartbeat(env: Optional[dict] = None):
    """FileHeartbeat bound to $TPU_QUEUE_HEARTBEAT, or an inert stub."""
    path = (env if env is not None else os.environ).get(HEARTBEAT_ENV)
    return FileHeartbeat(path) if path else _NoopHeartbeat()


def read_heartbeat(path: str) -> Optional[dict]:
    """The last beat record, or None (absent, torn, never beaten)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def heartbeat_age_s(path: str, now: Optional[float] = None
                    ) -> Optional[float]:
    """Seconds since the file was last touched; None if it never was."""
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    return max(0.0, (time.time() if now is None else now) - mtime)


def write_job_status(ok: bool, error: str = "", error_class: str = "",
                     extra: Optional[dict] = None,
                     env: Optional[dict] = None) -> None:
    """The job's exit status at $TPU_QUEUE_STATUS (a no-op when the job
    runs under no supervisor): `{"ok", "t", "pid"}` plus `error` (500
    characters at most), `error_class` ('transient' or 'permanent') and
    `extra`. The supervisor prefers it over the exit code."""
    path = (env if env is not None else os.environ).get(STATUS_ENV)
    if not path:
        return
    rec = {"ok": bool(ok), "t": time.time(), "pid": os.getpid()}
    if error:
        rec["error"] = str(error)[:500]
    if error_class:
        rec["error_class"] = error_class
    if extra:
        rec.update(extra)
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        _atomic_write_text(path, json.dumps(rec))
    except OSError:
        pass


def run_as_job(main_fn) -> None:
    """Run `main_fn` as a supervised job: write the status file and map
    a failure onto the exit-code contract (0 done, `EXIT_TRANSIENT`
    transient, 1 permanent). A string `SystemExit` is the "backend
    unavailable" family and counts as transient; an integer one keeps
    its code and counts as permanent."""
    from .errors import EXIT_TRANSIENT, classify_exception
    try:
        main_fn()
    except KeyboardInterrupt:
        raise
    except SystemExit as e:
        if e.code in (None, 0):
            write_job_status(True)
            raise
        if isinstance(e.code, int):
            write_job_status(False, error="exit code %d" % e.code,
                             error_class="permanent")
            raise
        write_job_status(False, error=str(e.code), error_class="transient")
        raise SystemExit(EXIT_TRANSIENT) from e
    except Exception as e:  # noqa: BLE001 — classified, not swallowed
        klass = classify_exception(e)
        head = str(e).splitlines()[0] if str(e) else repr(e)
        write_job_status(False, error="%s: %s" % (type(e).__name__, head),
                         error_class=klass)
        raise SystemExit(EXIT_TRANSIENT if klass == "transient"
                         else 1) from e
    else:
        write_job_status(True)


class HangWatchdog:
    """Warns (with thread stacks) when no progress beat arrives for
    `warn_seconds`; `beat_file` mirrors every beat (and, while paused,
    the watchdog's own ticks) into a FileHeartbeat. `_mu` guards the beat
    state it shares with its thread."""

    def __init__(self, warn_seconds: float, where: str = "train",
                 beat_file: Optional[str] = None):
        self.warn_seconds = float(warn_seconds)
        self.where = where
        self._mu = threading.Lock()
        self._beat = time.monotonic()
        self._label = "start"
        self._stop = threading.Event()
        self._warned = False
        self._paused = False
        self._thread = None
        self._status_fn = None
        self._file = FileHeartbeat(beat_file) if beat_file else None
        if self._file is not None:
            self._file.beat("start")
        if self.warn_seconds > 0:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def set_status_fn(self, fn) -> None:
        """A () -> str provider appended to every warning."""
        with self._mu:
            self._status_fn = fn

    def beat(self, label: str) -> None:
        with self._mu:
            self._beat = time.monotonic()
            self._label = label
            self._warned = False
        if self._file is not None:
            self._file.beat(label)

    def pause(self, label: str) -> None:
        """Suspend warnings across a known-slow operation."""
        with self._mu:
            self._paused = True
            self._label = label
        if self._file is not None:
            self._file.beat("paused: %s" % label)

    def resume(self, label: str) -> None:
        with self._mu:
            self._paused = False
        self.beat(label)

    def _run(self) -> None:
        while not self._stop.wait(min(30.0, self.warn_seconds / 4)):
            # decide under the lock, warn outside it
            with self._mu:
                stalled = time.monotonic() - self._beat
                paused, label = self._paused, self._label
                status_fn = self._status_fn
                fire = (stalled > self.warn_seconds and not self._warned
                        and not paused)
                if fire:
                    self._warned = True
            if paused and self._file is not None:
                self._file.beat("paused: %s" % label)
            if fire:
                extra = ""
                if status_fn is not None:
                    try:
                        extra = " | " + str(status_fn())
                    except Exception:  # noqa: BLE001 — status is best-effort
                        pass
                print("%s: WATCHDOG: no %s progress for %.0fs (last: %s) — "
                      "the device may be wedged; if this persists, kill "
                      "and resume from the last checkpoint%s"
                      % (time.ctime(), self.where, stalled, label, extra),
                      flush=True)
                try:  # where is the main thread stuck?
                    faulthandler.dump_traceback(file=sys.__stderr__)
                except Exception:  # noqa: BLE001 — no real fd under capture
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
