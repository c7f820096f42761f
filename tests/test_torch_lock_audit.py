"""The port's lock audit and interleaving harness against the JAX
package's, and the port's serving plane under seeded schedules, on the
CPU.

* `lock_audit.audit_source` gives the same findings (rule, path,
  context, line) as JAX's on the bad/good pairs of
  tests/test_lock_audit.py; the card's syncs (`torch.cuda.synchronize()`,
  an event's or a stream's `.synchronize()`, `.item()`, `.cpu()`,
  `.tolist()`, `.numpy()`) under a lock are blocking calls;
* `interleave` gives JAX's schedule trace for the same seed on
  `TornHealthFixture` and `DeadlockFixture`;
* the port's `ServingEngine.health()` and `FleetRouter.health()`, driven
  with their locks swapped for instrumented ones against a writer that
  moves stats and state together, never tear over 64 seeds, while the
  two-window emulation of the same read tears.
"""

import collections
import queue
import signal

import pytest

from real_time_helmet_detection_tpu.analysis import interleave as jax_il
from real_time_helmet_detection_tpu.analysis import lock_audit as jax_lock
from real_time_helmet_detection_tpu_torch.analysis import (interleave,
                                                           lock_audit)
from real_time_helmet_detection_tpu_torch.serving import engine as engine_mod
from real_time_helmet_detection_tpu_torch.serving import fleet as fleet_mod

from test_lock_audit import FX, LOCK_CASES

TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _hard_timeout():
    """A wedged interleaving fails the test instead of hanging it."""
    def fire(signum, frame):
        raise RuntimeError("test exceeded %d s: an interleaving wedged"
                           % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def keyed(findings):
    return sorted((f.rule, f.path, f.context, f.line) for f in findings)


@pytest.mark.parametrize("rule,bad,good", LOCK_CASES,
                         ids=[c[0] for c in LOCK_CASES])
def test_lock_rules_find_what_jax_finds(rule, bad, good):
    for src in (bad, good):
        assert keyed(lock_audit.audit_source(src, FX)) \
            == keyed(jax_lock.audit_source(src, FX))
    assert any(f.rule == rule for f in lock_audit.audit_source(bad, FX))


SYNC_TMPL = ("import threading, torch\n"
             "class S:\n"
             "    def __init__(self):\n"
             "        self._lock = threading.Lock()\n"
             "        self.v = None\n"
             "    def m(self, t, ev, stream, q):\n"
             "        with self._lock:\n"
             "            self.v = %s\n")


@pytest.mark.parametrize("expr,blocking", [
    ("torch.cuda.synchronize()", True), ("ev.synchronize()", True),
    ("stream.synchronize()", True), ("t.item()", True), ("t.cpu()", True),
    ("t.tolist()", True), ("t.numpy()", True), ("q.get()", True),
    ("t.cpu(memory_format=None)", False), ("t.add(1)", False),
    ("q.get_nowait()", False)])
def test_card_syncs_under_a_lock_block(expr, blocking):
    found = lock_audit.audit_source(SYNC_TMPL % expr, FX)
    assert any(f.rule == "lock/blocking-call-under-lock"
               for f in found) == blocking
    if blocking and expr.startswith(("torch.", "ev.", "stream.", "t.")):
        # JAX's audit knows none of the card's syncs
        assert not jax_lock.audit_source(SYNC_TMPL % expr, FX)


def schedule_of(mod, fixture, seed, fixed):
    sched = mod.Scheduler(seed)
    if fixture == "torn":
        fx = mod.TornHealthFixture(sched, fixed=fixed)

        def reader():
            for _ in range(3):
                fx.health()

        def writer():
            for _ in range(2):
                fx.reload()

        fns = [reader, writer]
    else:
        fx = mod.DeadlockFixture(sched, ordered=fixed)
        fns = [fx.t1, fx.t2]
    try:
        sched.run(fns)
    except mod.DeadlockError as e:
        return ("deadlock", sorted(e.waiting.items()), e.trace)
    return ("done", [], sched.trace)


@pytest.mark.parametrize("fixture", ["torn", "deadlock"])
@pytest.mark.parametrize("fixed", [False, True])
def test_schedules_equal_jaxs(fixture, fixed):
    for seed in range(16):
        assert schedule_of(interleave, fixture, seed, fixed) \
            == schedule_of(jax_il, fixture, seed, fixed), seed


def test_finders_agree_with_jax():
    ours = interleave.find_torn_read(fixed=False)
    theirs = jax_il.find_torn_read(fixed=False)
    assert ours["seed"] == theirs["seed"] and ours["trace"] == theirs["trace"]
    assert interleave.find_torn_read(fixed=True) is None
    dl = interleave.find_deadlock(ordered=False)
    assert dl["seed"] == jax_il.find_deadlock(ordered=False)["seed"]
    assert sorted(dl["waiting"].values()) == ["a", "b"]
    assert interleave.find_deadlock(ordered=True) is None
    with pytest.raises(interleave.ScheduleOverrun):
        sched = interleave.Scheduler(0, max_steps=20)

        def spin():
            while True:
                sched.point("spin")
        sched.run([spin])


# ---------------------------------------------------------------------------
# the port's serving plane under instrumented locks


def mini_engine(lock):
    """A port ServingEngine with exactly what `health()` reads (no model,
    no threads)."""
    eng = engine_mod.ServingEngine.__new__(engine_mod.ServingEngine)
    eng._lock = lock
    eng._state = engine_mod.SERVING
    eng._stats = {"reloads": 0}
    eng._consecutive_failures = 0
    eng._inflight_batches = 0
    eng._last_error = None
    eng._q = queue.Queue()
    eng._retry = collections.deque()
    eng._buckets = (1, 2)
    eng._max_retries = 2
    eng._hang_timeout_s = None
    eng._watchdog = None
    return eng


def engine_writer(eng):
    for i in (1, 2):
        with eng._lock:
            eng._stats["reloads"] = i
            eng._state = "gen-%d" % i


def engine_consistent(h):
    r = h["stats"]["reloads"]
    return h["state"] == (engine_mod.SERVING if r == 0 else "gen-%d" % r)


def two_window_health(eng):
    with eng._lock:
        stats = dict(eng._stats)
    with eng._lock:
        state = eng._state
    return {"state": state, "stats": stats}


def sweep(make, read, write, consistent, seeds=64):
    """The first seed whose schedule hands the reader an inconsistent
    snapshot, or None."""
    for seed in range(seeds):
        sched = interleave.Scheduler(seed)
        obj = make(sched)
        seen = []

        def reader():
            for _ in range(3):
                seen.append(read(obj))

        sched.run([reader, lambda: write(obj)])
        if not all(consistent(h) for h in seen):
            return seed
    return None


def test_engine_health_never_tears():
    make = lambda s: mini_engine(s.lock("engine._lock"))  # noqa: E731
    assert sweep(make, lambda e: e.health(include_metrics=False),
                 engine_writer, engine_consistent) is None
    assert sweep(make, two_window_health, engine_writer,
                 engine_consistent) is not None


class _Counter:
    value = 0


class _Watchdog:
    alerts = ()


def mini_router(sched):
    """A port FleetRouter with what `health()` reads: two replicas whose
    engines share the router's instrumented schedule, the canary slot,
    no tenants."""
    router = fleet_mod.FleetRouter.__new__(fleet_mod.FleetRouter)
    router._lock = sched.lock("fleet._lock")
    reps = []
    for rid in range(2):
        rep = fleet_mod._Replica.__new__(fleet_mod._Replica)
        rep.rid, rep.generation, rep.tier = rid, 0, None
        rep.engine = mini_engine(sched.lock("engine%d._lock" % rid))
        reps.append(rep)
    router._replicas = reps
    router._canary, router._canary_frac = None, 0.0
    router._tenants, router._tenant_tiers = {}, {}
    router._cascade_tenants, router._cascade_tiers = set(), ()
    router._cascade_threshold = None
    router._mc = {"submitted": _Counter()}
    router._watchdog = _Watchdog()
    return router


def router_writer(router):
    """A rollout in miniature: the canary slot and the generation move
    together under the router's lock."""
    for gen in (1, 2):
        with router._lock:
            rep = router._replicas[gen % 2]
            rep.generation = gen
            router._canary, router._canary_frac = rep, 0.1 * gen


def router_consistent(h):
    canary = [r for r in h["replicas"] if r["canary"]]
    if h["canary"] is None:
        return not canary and all(r["generation"] == 0
                                  for r in h["replicas"])
    return len(canary) == 1 and canary[0]["rid"] == h["canary"]["rid"] \
        and abs(h["canary"]["frac"] - 0.1 * canary[0]["generation"]) < 1e-9


def two_window_router_health(router):
    with router._lock:
        reps = [dict(rid=r.rid, generation=r.generation) for r in
                router._replicas]
    with router._lock:
        canary, frac = router._canary, router._canary_frac
    return {"replicas": [dict(r, canary=canary is not None
                              and canary.rid == r["rid"]) for r in reps],
            "canary": None if canary is None else {"rid": canary.rid,
                                                   "frac": frac}}


def test_fleet_health_never_tears():
    assert sweep(mini_router, lambda r: r.health(), router_writer,
                 router_consistent) is None
    assert sweep(mini_router, two_window_router_health, router_writer,
                 router_consistent) is not None
