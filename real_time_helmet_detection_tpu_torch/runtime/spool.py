"""Persistent job spool: an append-only, fsynced JSON-lines journal.

Port of ref real_time_helmet_detection_tpu/runtime/spool.py:1-270
(`JobSpec`, `JobState`, `Spool`, the state names and
`VALID_TRANSITIONS`), stdlib only. The record kinds, their `"v": 1`
schema and the state machine are the JAX package's, so a journal that
either package writes replays in the other to the same `JobState`s.

Every transition is one `write(line) + flush + fsync` of a record, so
the on-disk journal is always a valid prefix of history and a supervisor
killed between any two transitions loses no job; replay rebuilds the
live view. A crash can tear only the last line: opening a spool
truncates a torn tail before it appends, and replay drops it.

Layout under the queue directory:

    jobs.jsonl      the journal (specs + state transitions)
    logs/           per-attempt job stdout/stderr, and the waiter's log
    hb/             per-job heartbeat files
    status/         per-attempt machine-readable job status files

Record kinds (one JSON object per line, `"v": 1`):

    {"kind": "spec",  "job": id, "argv": [...], ...}
    {"kind": "state", "job": id, "state": s, "t": wall, ...}
    {"kind": "note",  ...}            # diagnostics; replay ignores them

State machine:

    queued -> claim-wait -> running -> done | failed | salvaged
    claim-wait -> queued              (card lost / supervisor restart)
    running -> queued                 (supervisor restart, process gone)
    salvaged -> queued | failed       (requeue with backoff | budget spent)

`claim-wait` keeps the JAX package's name: a job parked behind the one
device waiter (`runtime/supervisor.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

JOURNAL = "jobs.jsonl"

QUEUED = "queued"
CLAIM_WAIT = "claim-wait"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
SALVAGED = "salvaged"

TERMINAL = frozenset({DONE, FAILED})

# the edges the supervisor is allowed to take; anything else is a bug we
# want loud (a silent illegal transition is how a queue quietly loses jobs)
VALID_TRANSITIONS = {
    QUEUED: {CLAIM_WAIT, RUNNING, FAILED},
    CLAIM_WAIT: {RUNNING, QUEUED},
    RUNNING: {DONE, FAILED, SALVAGED, QUEUED},
    SALVAGED: {QUEUED, FAILED},
    DONE: set(),
    FAILED: set(),
}


@dataclasses.dataclass
class JobSpec:
    """What to run and how to supervise it. Serialized once per job."""
    job: str                       # unique id within the spool
    argv: List[str]                # the command; run with cwd=repo root
    artifacts: List[str] = dataclasses.field(default_factory=list)
    # globs (relative to cwd) whose survivors are recorded on salvage
    heartbeat_timeout_s: float = 900.0   # stale beat -> SIGTERM
    max_attempts: int = 3
    backoff_base_s: float = 30.0
    backoff_cap_s: float = 600.0
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    cwd: Optional[str] = None

    def to_record(self) -> dict:
        rec = dataclasses.asdict(self)
        rec.update({"kind": "spec", "v": 1, "t": time.time()})
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "JobSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in rec.items() if k in names})


@dataclasses.dataclass
class JobState:
    """Replayed live view of one job."""
    spec: JobSpec
    state: str = QUEUED
    attempt: int = 1               # 1-based: attempt N is the Nth spawn
    not_before: float = 0.0        # wall clock; backoff gate
    enqueued_at: float = 0.0       # FIFO order key
    pid: Optional[int] = None      # last known pid while RUNNING
    last: dict = dataclasses.field(default_factory=dict)  # last state rec


class Spool:
    """The journal plus its replayed in-memory view.

    Opening a spool replays the journal; every mutation appends one
    fsynced record and updates the view, so memory and disk can never
    disagree by more than a crash's torn final line (which replay drops).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        for sub in ("logs", "hb", "status"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self.path = os.path.join(self.root, JOURNAL)
        self.jobs: Dict[str, JobState] = {}
        self._order: List[str] = []     # enqueue order (FIFO)
        self._repair_tail()
        self._replay()
        # append handle held open: one open() per transition would work,
        # but a persistent handle keeps the fsync path allocation-free
        self._f = open(self.path, "a")

    def _repair_tail(self) -> None:
        """Truncate a torn final line (crash mid-append left no trailing
        newline): replay would drop it anyway, but appending AFTER it
        would weld the next record onto the fragment and corrupt it."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            data = f.read()
            if data.endswith(b"\n"):
                return
            keep = data.rfind(b"\n") + 1  # 0 when no complete line at all
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())

    # ---- durability -----------------------------------------------------

    def _append(self, rec: dict) -> None:
        rec.setdefault("v", 1)
        rec.setdefault("t", time.time())
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    # ---- replay ---------------------------------------------------------

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        lines = data.split(b"\n")
        for i, raw in enumerate(lines):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    # torn tail from a crash mid-append: every complete
                    # earlier record was fsynced before it — drop silently
                    continue
                # mid-file corruption is NOT expected; keep going (losing
                # one record beats refusing to load the whole queue) but
                # make it visible
                print("[spool] WARNING: unparseable journal line %d "
                      "skipped" % (i + 1), flush=True)
                continue
            self._apply(rec)

    def _apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "spec":
            spec = JobSpec.from_record(rec)
            self.jobs[spec.job] = JobState(
                spec=spec, enqueued_at=float(rec.get("t", 0.0)))
            if spec.job not in self._order:
                self._order.append(spec.job)
        elif kind == "state":
            js = self.jobs.get(rec.get("job"))
            if js is None:
                return  # state for an unknown job: tolerate, don't crash
            js.state = rec["state"]
            js.last = rec
            if "attempt" in rec:
                js.attempt = int(rec["attempt"])
            js.not_before = float(rec.get("not_before", 0.0))
            js.pid = rec.get("pid", js.pid if rec["state"] == RUNNING
                             else None)
        # "note" records are diagnostics only

    # ---- mutations ------------------------------------------------------

    def enqueue(self, spec: JobSpec) -> JobState:
        if spec.job in self.jobs:
            raise ValueError("job id %r already spooled" % spec.job)
        self._append(spec.to_record())
        self._apply(spec.to_record())
        self.transition(spec.job, QUEUED, attempt=1)
        return self.jobs[spec.job]

    def transition(self, job: str, state: str, **fields) -> JobState:
        js = self.jobs[job]
        if state != QUEUED or js.last:  # first QUEUED follows the spec rec
            cur = js.state if js.last else QUEUED
            if js.last and state not in VALID_TRANSITIONS[cur]:
                raise ValueError("illegal transition %s -> %s for job %r"
                                 % (cur, state, job))
        rec = {"kind": "state", "job": job, "state": state}
        rec.update(fields)
        rec.setdefault("attempt", js.attempt)
        self._append(rec)
        self._apply(rec)
        return js

    def note(self, **fields) -> None:
        rec = {"kind": "note"}
        rec.update(fields)
        self._append(rec)

    # ---- queries --------------------------------------------------------

    def ordered(self) -> List[JobState]:
        return [self.jobs[j] for j in self._order]

    def next_runnable(self, now: float) -> Optional[JobState]:
        """Oldest QUEUED job whose backoff gate has passed (FIFO)."""
        for js in self.ordered():
            if js.state == QUEUED and js.not_before <= now:
                return js
        return None

    def pending(self) -> List[JobState]:
        """Jobs that still need the supervisor (non-terminal)."""
        return [js for js in self.ordered() if js.state not in TERMINAL]

    def earliest_gate(self) -> Optional[float]:
        """Soonest not_before among QUEUED jobs (None if none queued)."""
        gates = [js.not_before for js in self.ordered()
                 if js.state == QUEUED]
        return min(gates) if gates else None

    # ---- per-job file locations (shared with the job's environment) -----

    def heartbeat_path(self, job: str) -> str:
        return os.path.join(self.root, "hb", "%s.json" % job)

    def status_path(self, job: str, attempt: int) -> str:
        return os.path.join(self.root, "status",
                            "%s.%d.json" % (job, attempt))

    def log_path(self, job: str, attempt: int) -> str:
        return os.path.join(self.root, "logs", "%s.%d.log" % (job, attempt))
