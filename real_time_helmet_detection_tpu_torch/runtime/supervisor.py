"""Crash-restartable job supervisor for the card: triage, hang-kill-salvage
and backoff requeue.

Port of ref real_time_helmet_detection_tpu/runtime/supervisor.py:142-553
(`Supervisor` with its `triage`, `_await_claim`, `_run_job`,
`_finish_job`, salvage, backoff, `recover`, `run` and `summary`; the
spawn and process plumbing), stdlib only. The control flow is the JAX
package's; what the triage probes is this card's, not a TPU relay's:

* ``no-device`` (JAX ``relay-dead``) — no card is visible
  (`default_device_probe`: $CUDA_VISIBLE_DEVICES hides every card, or
  `nvidia-smi` lists none; without `nvidia-smi`, `/dev/nvidia0` is
  missing). It creates no CUDA context and never raises. Park: spawn
  nothing, re-probe periodically.
* ``device-busy`` (JAX ``claim-wedged``) — a card is seen but the waiter
  (`WAITER_SRC`, a `python -c` child) has not cleared within the claim
  grace, or exited 17: it could not create a context on cuda:0 ("busy or
  unavailable" is what an exclusive-process card held by another
  process answers), or could not launch the peak kernel #1
  (`ops/peak.py` `peak_scores`) on a small seeded logit map, or the
  kernel disagreed with `peak_scores_reference` bit for bit. Exactly
  ONE waiter is parked and every job chains behind it; it is never
  killed from outside.
* ``healthy`` — the waiter exited 0: the card took a context and ran #1
  right. The verdict is cached until a job fails transiently.

The job contract is the JAX package's: the supervisor exports
$TPU_QUEUE_HEARTBEAT and $TPU_QUEUE_STATUS into every job (and
$OBS_SPAN_LOG, by default `<queue dir>/../obs/spans.jsonl`); the train
loop's `HangWatchdog` beats the former, `run_as_job` /
`write_job_status` write the latter. A beat stale past the job's
deadline -> SIGTERM, SIGKILL after the grace; the declared artifact
globs' survivors are recorded; requeue with capped exponential backoff
and 0-25% jitter. Exit codes: 0 done, `EXIT_TRANSIENT` (75) transient,
else permanent; the status file wins over the code.

Each job leads a process group of its own (`default_spawn`), and its
handle signals the whole group, so a kill reaches the job's children too
and nothing of a job outlives it.

Every external effect sits behind an injectable seam (device probe,
waiter factory, spawn, clock, sleep, rng, heartbeat age), so the whole
recovery surface runs on the CPU with fakes.
"""

from __future__ import annotations

import glob
import os
import random
import shutil
import signal
import subprocess
import sys
import time
from typing import Callable, Optional

from .errors import EXIT_TRANSIENT, classify_error_text
from .heartbeat import HEARTBEAT_ENV, STATUS_ENV, read_heartbeat
from .spool import (CLAIM_WAIT, DONE, FAILED, QUEUED, RUNNING, SALVAGED,
                    JobState, Spool)

# the directory holding the port's package: the waiter imports it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# triage outcomes
HEALTHY = "healthy"
NO_DEVICE = "no-device"
DEVICE_BUSY = "device-busy"

# THE waiter: a context on cuda:0, then the peak kernel #1 against its
# plain version; exits 0 when both are right, 17 on any failure
WAITER_SRC = (
    "import sys\n"
    "try:\n"
    "    import torch\n"
    "    torch.zeros(1, device='cuda:0')\n"
    "    from real_time_helmet_detection_tpu_torch.ops import peak\n"
    "    gen = torch.Generator().manual_seed(0)\n"
    "    logits = (3.0 * torch.randn((1, 1, 32, 32, 6), generator=gen)"
    ").to('cuda:0')\n"
    "    before = peak.launches\n"
    "    got = peak.peak_scores(logits, 2)\n"
    "    n = peak.launches - before\n"
    "    want = peak.peak_scores_reference(logits, 2)\n"
    "    assert n == 1, 'peak_scores launched %d kernels' % n\n"
    "    assert torch.equal(got, want), 'peak kernel != its plain version'\n"
    "except Exception as e:\n"
    "    print('waiter: %r' % e, flush=True)\n"
    "    sys.exit(17)\n"
    "print('device clear: %s; peak_scores launched %d kernel(s), "
    "bit-equal to peak_scores_reference' "
    "% (torch.cuda.get_device_name(0), n), flush=True)\n"
)


def default_device_probe() -> bool:
    """A card is visible to this host. Creates no CUDA context and
    never raises."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        return False
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return os.path.exists("/dev/nvidia0")
    try:
        out = subprocess.run([smi, "--query-gpu=name",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0 and any(
        line.strip() for line in out.stdout.splitlines())


def default_waiter_factory(log_path: Optional[str] = None):
    """Spawn THE waiter (see WAITER_SRC); its output is appended to
    `log_path`, else goes to this process's stderr."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    argv = [sys.executable, "-u", "-c", WAITER_SRC]
    if log_path is None:
        return subprocess.Popen(argv, env=env, stdout=sys.stderr,
                                stderr=sys.stderr)
    logf = open(log_path, "ab")
    try:
        return subprocess.Popen(argv, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
    finally:
        logf.close()  # Popen holds its own fd


class GroupHandle:
    """A job's `Popen`, the leader of its own process group:
    `terminate`/`kill` signal the whole group, and once the leader has
    exited `poll` kills whatever of the group is left."""

    def __init__(self, popen: subprocess.Popen):
        self.popen = popen
        self.pid = popen.pid

    def poll(self):
        rc = self.popen.poll()
        if rc is not None:
            _signal_group(self.pid, signal.SIGKILL)
        return rc

    def terminate(self) -> None:
        _signal_group(self.pid, signal.SIGTERM)

    def kill(self) -> None:
        _signal_group(self.pid, signal.SIGKILL)


def default_spawn(spec, env: dict, log_path: str) -> GroupHandle:
    """Launch one job as the leader of a new process group, stdout and
    stderr appended to its per-attempt log."""
    logf = open(log_path, "ab")
    try:
        return GroupHandle(subprocess.Popen(
            spec.argv, env=env, cwd=spec.cwd or None, stdout=logf,
            stderr=subprocess.STDOUT, start_new_session=True))
    finally:
        logf.close()  # Popen holds its own fd


class Supervisor:
    """See module docstring. All seams default to the real thing."""

    def __init__(self, spool: Spool, *,
                 device_probe: Callable[[], bool] = default_device_probe,
                 waiter_factory: Callable[[], object] = None,
                 spawn: Callable = default_spawn,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random,
                 heartbeat_age: Optional[Callable] = None,
                 claim_grace_s: float = 90.0,
                 waiter_retry_s: float = 120.0,
                 park_retry_s: float = 60.0,
                 kill_grace_s: float = 20.0,
                 poll_s: float = 1.0,
                 log: Callable[[str], None] = None):
        self.spool = spool
        self.device_probe = device_probe
        self.waiter_factory = waiter_factory or (
            lambda: default_waiter_factory(self.waiter_log_path()))
        self.spawn = spawn
        self.clock = clock
        self.sleep = sleep
        self.rng = rng
        self._hb_age = heartbeat_age or self._default_hb_age
        self.claim_grace_s = claim_grace_s
        self.waiter_retry_s = waiter_retry_s
        self.park_retry_s = park_retry_s
        self.kill_grace_s = kill_grace_s
        self.poll_s = poll_s
        self._log = log or (lambda m: print("[queue] %s" % m, flush=True))
        self.waiter = None
        self.waiters_spawned = 0
        # the queue.* gauges and counters, exported when $OBS_METRICS is
        # set: the spool's census by state, the running job's heartbeat
        # age (what the stale-kill deadline acts on), requeues, salvages
        from ..obs.metrics import default_registry, maybe_writer
        self._metrics = default_registry()
        self._m_writer = maybe_writer(registry=self._metrics)
        self._mg_hb_age = self._metrics.gauge("queue.heartbeat_age_s")
        self._mc_requeues = self._metrics.counter("queue.requeues")
        self._mc_salvages = self._metrics.counter("queue.salvages")
        # a cleared waiter or a finished job verifies the card; later
        # jobs skip the waiter until transient trouble invalidates it
        self._verified_healthy = False

    def waiter_log_path(self) -> str:
        return os.path.join(self.spool.root, "logs", "waiter.log")

    # ---- metrics seam ----------------------------------------------------

    def _sample_metrics(self, hb_age: Optional[float] = None) -> None:
        """Refresh the queue.* gauges from the spool census (and the
        running job's heartbeat age when given); the exporter's periodic
        flush point."""
        counts: dict = {}
        for js in self.spool.ordered():
            counts[js.state] = counts.get(js.state, 0) + 1
        for state in (QUEUED, CLAIM_WAIT, RUNNING, DONE, FAILED, SALVAGED):
            self._metrics.gauge("queue.jobs.%s" % state).set(
                counts.get(state, 0))
        if hb_age is not None:
            self._mg_hb_age.set(hb_age)
        self._m_writer.maybe_flush()

    # ---- heartbeat seam --------------------------------------------------

    def _default_hb_age(self, path: str, started_at: float) -> float:
        """Seconds of silence: since the last beat, or since spawn if the
        job never beat (start-up counts against the deadline too)."""
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            mtime = started_at
        return max(0.0, self.clock() - max(mtime, started_at))

    # ---- recovery after a supervisor crash/restart -----------------------

    def recover(self) -> None:
        """Resume where a dead supervisor stopped: claim-wait jobs go back
        to queued (they never started); a running job's process is an
        orphan — if its pid is alive its group is terminated first (one
        job on the card at a time), then the job is salvaged and
        requeued."""
        for js in list(self.spool.pending()):
            if js.state == CLAIM_WAIT:
                self.spool.transition(js.spec.job, QUEUED,
                                      reason="supervisor restart")
            elif js.state == RUNNING:
                if js.pid and _pid_alive(js.pid):
                    self._log("job %s: orphan pid %d still alive from a "
                              "previous supervisor; terminating before "
                              "requeue (one job on the card at a time)"
                              % (js.spec.job, js.pid))
                    _terminate_pid(js.pid, self.kill_grace_s, self.sleep)
                self._salvage_and_requeue(
                    js, reason="supervisor restart found job interrupted")

    # ---- triage ----------------------------------------------------------

    def triage(self) -> str:
        """One classification pass; never blocks longer than
        claim_grace_s. Does not kill the waiter — ever."""
        if not self.device_probe():
            self._verified_healthy = False
            return NO_DEVICE
        if self._verified_healthy:
            return HEALTHY
        if self.waiter is not None:
            rc = self.waiter.poll()
            if rc is None:
                return DEVICE_BUSY
            self.waiter = None
            if rc != 0:
                # the waiter failed on its own; a fresh one is parked by
                # the caller after a pause
                return DEVICE_BUSY
            self._verified_healthy = True
            return HEALTHY
        self.waiter = self.waiter_factory()
        self.waiters_spawned += 1
        deadline = self.clock() + self.claim_grace_s
        while self.clock() < deadline:
            rc = self.waiter.poll()
            if rc is not None:
                self.waiter = None
                if rc == 0:
                    self._verified_healthy = True
                    return HEALTHY
                return DEVICE_BUSY
            self.sleep(min(self.poll_s, 1.0))
        return DEVICE_BUSY

    def _await_claim(self, job: JobState) -> bool:
        """Park `job` in claim-wait behind THE waiter until the card
        clears. Returns False if the card vanished while waiting (the job
        goes back to queued). Never kills the waiter."""
        self.spool.transition(job.spec.job, CLAIM_WAIT)
        self._log("device busy: %s parked behind the waiter"
                  % job.spec.job)
        while True:
            if not self.device_probe():
                # the card is gone: leave the waiter be (it fails on its
                # own) and stop trusting it
                self._log("device vanished while waiting; parking")
                self.waiter = None
                self.spool.transition(job.spec.job, QUEUED,
                                      reason="device vanished during "
                                             "claim-wait")
                return False
            if self.waiter is None:
                self.waiter = self.waiter_factory()
                self.waiters_spawned += 1
            rc = self.waiter.poll()
            if rc is None:
                self.sleep(self.poll_s)
                continue
            self.waiter = None
            if rc == 0:
                self._verified_healthy = True
                return True
            # the waiter failed: pause, then park a fresh one
            self.spool.note(event="waiter failed", rc=rc,
                            job=job.spec.job)
            self._log("waiter exited rc=%d; retrying in %.0fs"
                      % (rc, self.waiter_retry_s))
            self.sleep(self.waiter_retry_s)

    # ---- running a single job --------------------------------------------

    def _job_env(self, js: JobState) -> dict:
        env = dict(os.environ)
        env.update(js.spec.env)
        env[HEARTBEAT_ENV] = self.spool.heartbeat_path(js.spec.job)
        env[STATUS_ENV] = self.spool.status_path(js.spec.job, js.attempt)
        # the flight recorder: every job writes its spans into the obs/
        # log beside the queue dir unless the operator or the spec names
        # one
        env.setdefault(
            "OBS_SPAN_LOG",
            os.path.join(os.path.dirname(self.spool.root), "obs",
                         "spans.jsonl"))
        return env

    def _run_job(self, js: JobState) -> None:
        job = js.spec.job
        hb_path = self.spool.heartbeat_path(job)
        # a previous attempt's stale beat must not count for this one
        try:
            os.remove(hb_path)
        except OSError:
            pass
        started = self.clock()
        handle = self.spawn(js.spec, self._job_env(js),
                            self.spool.log_path(job, js.attempt))
        self.spool.transition(job, RUNNING, pid=getattr(handle, "pid", None),
                              started_at=started)
        self._log("job %s attempt %d/%d running (pid %s)"
                  % (job, js.attempt, js.spec.max_attempts,
                     getattr(handle, "pid", "?")))
        while True:
            rc = handle.poll()
            if rc is not None:
                self._finish_job(js, rc)
                self._sample_metrics(hb_age=0.0)
                return
            age = self._hb_age(hb_path, started)
            self._sample_metrics(hb_age=age)
            if age > js.spec.heartbeat_timeout_s:
                self._log("job %s heartbeat stale %.0fs (deadline %.0fs); "
                          "killing" % (job, age,
                                       js.spec.heartbeat_timeout_s))
                _terminate_handle(handle, self.kill_grace_s, self.sleep)
                self._salvage_and_requeue(
                    js, reason="heartbeat stale %.0fs" % age)
                return
            self.sleep(self.poll_s)

    def _finish_job(self, js: JobState, rc: int) -> None:
        job = js.spec.job
        status = read_heartbeat(self.spool.status_path(job, js.attempt))
        if rc == 0 and (status is None or status.get("ok", True)):
            self.spool.transition(job, DONE, rc=rc)
            self._verified_healthy = True  # a finished job IS the probe
            self._log("job %s done" % job)
            return
        # the status file wins; then the exit-code contract; log text is
        # never scraped
        if status is not None and status.get("error_class"):
            klass = status["error_class"]
        elif rc == EXIT_TRANSIENT:
            klass = "transient"
        elif status is not None and status.get("error"):
            klass = classify_error_text(str(status["error"]))
        else:
            klass = "permanent"
        err = (status or {}).get("error", "exit code %d" % rc)
        if klass == "transient":
            self._salvage_and_requeue(js, reason="transient failure: %s"
                                      % str(err)[:200], rc=rc)
        else:
            self.spool.transition(job, FAILED, rc=rc,
                                  error=str(err)[:500],
                                  error_class=klass)
            self._log("job %s FAILED permanently: %s" % (job, err))

    # ---- salvage + requeue ----------------------------------------------

    def _salvage(self, js: JobState) -> list:
        """Which declared artifacts survived (atomic writes make the
        partials trustworthy)."""
        found = []
        base = js.spec.cwd or os.getcwd()
        for pattern in js.spec.artifacts:
            for path in sorted(glob.glob(os.path.join(base, pattern))):
                try:
                    st = os.stat(path)
                    found.append({"path": os.path.relpath(path, base),
                                  "bytes": st.st_size,
                                  "mtime": st.st_mtime})
                except OSError:
                    continue
        return found

    def _backoff_s(self, attempt: int, spec) -> float:
        """Capped exponential with jitter: base * 2^(attempt-1), capped,
        +0-25% jitter so a fleet of requeues cannot synchronize."""
        raw = min(spec.backoff_cap_s,
                  spec.backoff_base_s * (2 ** max(0, attempt - 1)))
        return raw * (1.0 + 0.25 * self.rng())

    def _salvage_and_requeue(self, js: JobState, reason: str,
                             rc: Optional[int] = None) -> None:
        # transient trouble: stop trusting the cached health verdict —
        # the next job re-triages with a waiter
        self._verified_healthy = False
        job = js.spec.job
        salvaged = self._salvage(js)
        self._mc_salvages.inc()
        self.spool.transition(job, SALVAGED, reason=reason, rc=rc,
                              salvaged_artifacts=salvaged)
        self._log("job %s salvaged (%d artifact(s) survived): %s"
                  % (job, len(salvaged), reason))
        if js.attempt >= js.spec.max_attempts:
            self.spool.transition(job, FAILED, error="attempt budget "
                                  "exhausted after: %s" % reason,
                                  error_class="transient")
            self._log("job %s FAILED: attempt budget (%d) exhausted"
                      % (job, js.spec.max_attempts))
            return
        delay = self._backoff_s(js.attempt, js.spec)
        self._mc_requeues.inc()
        self.spool.transition(job, QUEUED, attempt=js.attempt + 1,
                              not_before=self.clock() + delay,
                              reason=reason)
        self._log("job %s requeued (attempt %d/%d) with %.0fs backoff"
                  % (job, js.attempt, js.spec.max_attempts, delay))

    # ---- the loop --------------------------------------------------------

    def run(self, park_exit_s: Optional[float] = None) -> dict:
        """Drain the queue; returns a summary. With `park_exit_s`, a
        supervisor parked on a missing card for that long returns with
        jobs still queued — the spool resumes them on the next run."""
        self.recover()
        self._sample_metrics()
        parked_since = None
        while True:
            job = self.spool.next_runnable(self.clock())
            if job is None:
                pending = self.spool.pending()
                if not pending:
                    break
                gate = self.spool.earliest_gate()
                if gate is None:
                    break  # only non-queued pendings: nothing left to do
                self.sleep(max(self.poll_s,
                               min(gate - self.clock(), 30.0)))
                continue
            health = self.triage()
            if health == NO_DEVICE:
                now = self.clock()
                parked_since = parked_since or now
                if park_exit_s is not None \
                        and now - parked_since >= park_exit_s:
                    self.spool.note(event="park-exit",
                                    parked_s=now - parked_since)
                    self._log("no card for %.0fs; exiting parked (queue "
                              "persists)" % (now - parked_since))
                    self._m_writer.maybe_flush(force=True)
                    return self.summary(parked=True)
                self._log("no card visible: parked (no waiter spawned); "
                          "re-probing in %.0fs" % self.park_retry_s)
                self.sleep(self.park_retry_s)
                continue
            parked_since = None
            if health == DEVICE_BUSY:
                if not self._await_claim(job):
                    continue  # the card vanished mid-wait; job queued
            self._run_job(job)
        self._sample_metrics()
        self._m_writer.maybe_flush(force=True)
        return self.summary()

    def summary(self, parked: bool = False) -> dict:
        out = {"parked": parked, "jobs": {}}
        for js in self.spool.ordered():
            out["jobs"][js.spec.job] = {
                "state": js.state, "attempt": js.attempt}
        return out


# ---- process plumbing ----------------------------------------------------

def _signal_group(pgid: int, sig: int) -> None:
    try:
        os.killpg(pgid, sig)
    except OSError:
        pass  # the group is gone already


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _signal_pid_and_group(pid: int, sig: int) -> None:
    try:
        os.kill(pid, sig)
    except OSError:
        pass
    _signal_group(pid, sig)


def _terminate_pid(pid: int, grace_s: float, sleep) -> None:
    """SIGTERM the orphan and its group, SIGKILL both after the grace."""
    _signal_pid_and_group(pid, signal.SIGTERM)
    deadline = time.time() + grace_s
    while time.time() < deadline:
        if not _pid_alive(pid):
            break
        sleep(0.2)
    _signal_pid_and_group(pid, signal.SIGKILL)


def _terminate_handle(handle, grace_s: float, sleep) -> None:
    """SIGTERM first (jobs flush on it), SIGKILL after the grace."""
    try:
        handle.terminate()
    except OSError:
        pass
    waited = 0.0
    while waited < grace_s:
        if handle.poll() is not None:
            return
        sleep(0.2)
        waited += 0.2
    try:
        handle.kill()
    except OSError:
        pass
    # collect: poll until it reaps (bounded — a kill -9 cannot be ignored)
    for _ in range(50):
        if handle.poll() is not None:
            return
        sleep(0.1)
