"""Deterministic thread interleavings (graftlint layer 3, the dynamic
half), stdlib only.

Port of ref real_time_helmet_detection_tpu/analysis/interleave.py:47-325
(`DeadlockError`, `ScheduleOverrun`, `InstrumentedLock`, `Scheduler`,
`TornHealthFixture`, `find_torn_read`, `DeadlockFixture`,
`find_deadlock`), unchanged in behaviour: for one seed the same schedule
trace as JAX's. Real `threading.Thread`s run under a token-passing
scheduler that lets exactly one thread run at a time and, at every
instrumented-lock operation (and at `Scheduler.point()`), hands control
to a seeded choice of runnable thread. So a racy fixture has a concrete,
replayable schedule that shows the torn read or the deadlock, and a
fixed one is certified over a seed sweep. A thread that blocks on a held
instrumented lock is descheduled until the holder releases; no runnable
thread while some are unfinished is a detected deadlock (`DeadlockError`,
with the wait-for map), not a hung test.

`TornHealthFixture` is a `health()` that reads its stats and its state
in two lock windows (a reload can fall between them) against one that
reads both in one window, the shape of the port's
`ServingEngine.health()` and `FleetRouter.health()`; the tests drive
those two real methods with their locks swapped for instrumented ones.
`DeadlockFixture` is the AB/BA lock order that `lock/order-cycle` flags.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class DeadlockError(RuntimeError):
    """No runnable thread, but some are unfinished: every survivor waits
    on a lock (or the schedule wedged). Carries the wait-for map."""

    def __init__(self, waiting: Dict[int, str], trace: List[Tuple[int,
                                                                  str]]):
        self.waiting = dict(waiting)
        self.trace = list(trace)
        super().__init__(
            "deadlock: every unfinished thread is blocked (%s)"
            % ", ".join("t%d on %s" % (t, ln)
                        for t, ln in sorted(waiting.items())))


class ScheduleOverrun(RuntimeError):
    """The schedule exceeded max_steps — a livelock or runaway fixture."""


class InstrumentedLock:
    """`threading.Lock` twin whose acquire/release are scheduler yield
    points. Non-reentrant, like the real thing: re-acquiring while held
    by the same thread deadlocks (and is DETECTED, not hung)."""

    def __init__(self, sched: "Scheduler", name: str = "lock"):
        self._sched = sched
        self.name = name
        self._owner: Optional[int] = None

    def acquire(self) -> bool:
        sched = self._sched
        tid = sched._tid()
        sched._yield(tid, "acquire:%s" % self.name)
        while self._owner is not None:
            sched._block(tid, self.name)
        self._owner = tid
        sched._held.setdefault(tid, []).append(self.name)
        sched.trace.append((tid, "hold:%s" % self.name))
        return True

    def release(self) -> None:
        sched = self._sched
        tid = sched._tid()
        if self._owner != tid:
            raise RuntimeError("t%d releasing %s owned by %r"
                               % (tid, self.name, self._owner))
        self._owner = None
        sched._held.get(tid, []).remove(self.name)
        sched._unblock(self.name)
        sched._yield(tid, "release:%s" % self.name)

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._owner is not None


class Scheduler:
    """Seeded token-passing scheduler (see module docstring).

    `run(fns)` executes the thread functions to completion under the
    seed's interleaving and returns the trace; exceptions raised inside
    a thread (including assertion failures — fixtures assert their
    invariants in-thread) re-raise here, tagged with the seed."""

    def __init__(self, seed: int = 0, max_steps: int = 100_000):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._max_steps = max(1, int(max_steps))
        # shared with worker threads — safe WITHOUT a lock because the
        # token protocol serializes: exactly one thread (scheduler or
        # ONE worker) runs between handoffs
        self._go: Dict[int, threading.Event] = {}    # lock-free: token protocol
        self._ready = threading.Event()
        self._runnable: set = set()                  # lock-free: token protocol
        self._blocked: Dict[int, str] = {}           # lock-free: token protocol
        self._finished: set = set()                  # lock-free: token protocol
        self._errors: Dict[int, BaseException] = {}  # lock-free: token protocol
        self._held: Dict[int, List[str]] = {}        # lock-free: token protocol
        self._tids: Dict[int, int] = {}              # lock-free: token protocol
        self.trace: List[Tuple[int, str]] = []       # lock-free: token protocol

    # -- fixture API -------------------------------------------------------

    def lock(self, name: str = "lock") -> InstrumentedLock:
        return InstrumentedLock(self, name)

    def point(self, name: str = "point") -> None:
        """Explicit yield: models an interleaving opportunity between
        plain (un-locked) shared reads — how a lock-FREE torn read is
        exhibited when there is no lock op to hook."""
        self._yield(self._tid(), "point:%s" % name)

    # -- worker protocol ---------------------------------------------------

    def _tid(self) -> int:
        return self._tids[id(threading.current_thread())]

    def _wait_turn(self, tid: int) -> None:
        self._go[tid].wait()
        self._go[tid].clear()

    def _yield(self, tid: int, event: str) -> None:
        self.trace.append((tid, event))
        self._ready.set()
        self._wait_turn(tid)

    def _block(self, tid: int, lockname: str) -> None:
        self.trace.append((tid, "block:%s" % lockname))
        self._runnable.discard(tid)
        self._blocked[tid] = lockname
        self._ready.set()
        self._wait_turn(tid)

    def _unblock(self, lockname: str) -> None:
        for t in [t for t, ln in self._blocked.items() if ln == lockname]:
            del self._blocked[t]
            self._runnable.add(t)

    def _worker(self, tid: int, fn: Callable[[], None]) -> None:
        self._wait_turn(tid)  # first dispatch comes from the scheduler
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by run()
            self._errors[tid] = e
        finally:
            self._finished.add(tid)
            self._runnable.discard(tid)
            self.trace.append((tid, "exit"))
            self._ready.set()

    # -- the schedule loop -------------------------------------------------

    def run(self, fns: Sequence[Callable[[], None]]
            ) -> List[Tuple[int, str]]:
        n = len(fns)
        threads = []
        for tid, fn in enumerate(fns):
            self._go[tid] = threading.Event()
            t = threading.Thread(target=self._worker, args=(tid, fn),
                                 daemon=True,
                                 name="interleave-t%d" % tid)
            self._tids[id(t)] = tid
            self._runnable.add(tid)
            threads.append(t)
        for t in threads:
            t.start()
        steps = 0
        while len(self._finished) < n:
            if not self._runnable:
                raise DeadlockError(self._blocked, self.trace)
            steps += 1
            if steps > self._max_steps:
                raise ScheduleOverrun(
                    "schedule exceeded %d steps (seed %d)"
                    % (self._max_steps, self.seed))
            tid = self._rng.choice(sorted(self._runnable))
            self._ready.clear()
            self._go[tid].set()
            self._ready.wait()
        for t in threads:
            t.join()
        if self._errors:
            tid = sorted(self._errors)[0]
            err = self._errors[tid]
            raise type(err)("seed %d, thread %d: %s"
                            % (self.seed, tid, err)) from err
        return self.trace


# ---------------------------------------------------------------------------
# fixtures: the two-window torn read and the AB/BA deadlock, both shapes


class TornHealthFixture:
    """The two-window `health()` in miniature. `reload()` updates stats
    and state together under ONE lock window, so any coherent observer
    must see `state == "reloaded-<stats['reloads']>"`. The pre-fix
    `health()` read the two fields in TWO windows; the fixed one uses a
    single window (the shipped `ServingEngine.health()` shape)."""

    def __init__(self, sched: Scheduler, fixed: bool):
        self._lock = sched.lock("engine._lock")
        self._fixed = fixed
        self._stats = {"reloads": 0}
        self._state = "serving"

    def reload(self) -> None:
        with self._lock:
            self._stats["reloads"] += 1
            self._state = "reloaded-%d" % self._stats["reloads"]

    def health(self) -> Tuple[dict, str]:
        if self._fixed:
            with self._lock:  # ONE window: stats+state are one snapshot
                return dict(self._stats), self._state
        with self._lock:      # PRE-FIX: window 1 — stats
            stats = dict(self._stats)
        with self._lock:      # window 2 — state (a reload fits between)
            state = self._state
        return stats, state

    @staticmethod
    def consistent(stats: dict, state: str) -> bool:
        want = ("serving" if stats["reloads"] == 0
                else "reloaded-%d" % stats["reloads"])
        return state == want


def find_torn_read(fixed: bool, seeds: int = 64,
                   healths: int = 3, reloads: int = 2) -> Optional[Dict]:
    """Search seeded schedules for an inconsistent (stats, state) pair.
    Returns {"seed", "pair", "trace"} for the FIRST violating schedule,
    or None when every explored schedule observes coherent snapshots —
    the pre-fix fixture must return a violation, the fixed one None
    (graftlint --selfcheck proves both)."""
    for seed in range(int(seeds)):
        sched = Scheduler(seed)
        fx = TornHealthFixture(sched, fixed=fixed)
        observed: List[Tuple[dict, str]] = []

        def reader():
            for _ in range(healths):
                observed.append(fx.health())

        def writer():
            for _ in range(reloads):
                fx.reload()

        sched.run([reader, writer])
        for stats, state in observed:
            if not fx.consistent(stats, state):
                return {"seed": seed, "pair": (stats, state),
                        "trace": list(sched.trace)}
    return None


class DeadlockFixture:
    """The AB/BA shape `lock/order-cycle` flags statically. `ordered=
    True` is the fix: both threads take the locks in ONE global order."""

    def __init__(self, sched: Scheduler, ordered: bool):
        self._a = sched.lock("a")
        self._b = sched.lock("b")
        self._ordered = ordered
        self.n = 0

    def t1(self) -> None:
        with self._a:
            with self._b:
                self.n += 1

    def t2(self) -> None:
        if self._ordered:
            with self._a:
                with self._b:
                    self.n += 1
            return
        with self._b:
            with self._a:
                self.n += 1


def find_deadlock(ordered: bool, seeds: int = 64) -> Optional[Dict]:
    """First seed whose schedule deadlocks the AB/BA fixture (None for
    the ordered twin: no schedule can wedge a single global order)."""
    for seed in range(int(seeds)):
        sched = Scheduler(seed)
        fx = DeadlockFixture(sched, ordered=ordered)
        try:
            sched.run([fx.t1, fx.t2])
        except DeadlockError as e:
            return {"seed": seed, "waiting": e.waiting,
                    "trace": list(e.trace)}
    return None
