"""The port's job spool, supervisor and job exit contract against the JAX
package's, on the CPU with fakes only.

* Scripted scenarios (those of tests/test_supervisor.py: a missing card
  parks with no waiter, a busy card parks one waiter then drains, a
  stale heartbeat is killed, salvaged and requeued with backoff, a
  transient exit is retried, a permanent one is not, the status file
  wins over the exit code, the card vanishing during claim-wait,
  recovery of interrupted jobs, FIFO order, each job's environment) run
  through both supervisors with the same `FakeClock`, `FakeHandle`,
  `FakeWaiter`, probe script and rng: the journals' state records (wall
  stamps and pids left out), the summaries, the waiters spawned, the
  fake time slept and the job environments are equal. The port's
  triage outcomes are named for the card (`no-device`, `device-busy`
  for JAX's `relay-dead`, `claim-wedged`), the journal keeps
  `claim-wait`.
* Journals written by either spool replay in the other to the same
  `JobState`s, torn tails included.
* `run_as_job` / `write_job_status` give JAX's exit codes and status
  files for the same raised exceptions.
* The waiter source exits 17 where it cannot launch the peak kernel;
  the device probe never raises; the classifier's CUDA marker.
* `chip_smoke.leftovers` sees a thread or a child process a phase
  leaves behind, and, once the script is the subreaper, a grandchild
  whose parent ended (the orphan a job or a compile pool leaves).

Every test runs under a hard SIGALRM: nothing here may block.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import pytest

from real_time_helmet_detection_tpu import runtime as jax_runtime
from real_time_helmet_detection_tpu.runtime import errors as jax_errors
from real_time_helmet_detection_tpu.runtime import \
    heartbeat as jax_heartbeat
from real_time_helmet_detection_tpu_torch import runtime
from real_time_helmet_detection_tpu_torch.runtime import (errors, heartbeat,
                                                          supervisor)

TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _fire(signum, frame):
        raise RuntimeError("supervisor test exceeded the %ds hard timeout"
                           % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class FakeClock:
    """Deterministic time: sleep() advances it; nothing waits."""

    def __init__(self, t0=1_000_000.0):
        self.t = t0
        self.slept = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        assert s >= 0
        self.t += max(s, 1e-3)
        self.slept += s


class FakeHandle:
    """A job exiting with `rc` after `runtime` fake seconds, or never."""

    def __init__(self, clock, pid, rc=0, runtime=0.0):
        self.pid = pid
        self.clock = clock
        self.rc = rc
        self.done_at = clock.t + runtime
        self.terminated = False
        self.killed = False

    def poll(self):
        if self.terminated or self.killed:
            return -15
        if self.rc is None:
            return None
        return self.rc if self.clock.t >= self.done_at else None

    def terminate(self):
        self.terminated = True

    def kill(self):
        self.killed = True


class FakeWaiter:
    """The waiter: exits `rc` at `clear_at`, or at once when None."""

    pid = 77

    def __init__(self, clock, clear_at=None, rc=0):
        self.clock = clock
        self.clear_at = clear_at
        self.rc = rc

    def poll(self):
        if self.clear_at is None:
            return self.rc
        return self.rc if self.clock.t >= self.clear_at else None


PKGS = {"jax": jax_runtime, "port": runtime}


def make_sup(pkg, spool, clock, *, probe=True, waiters=None, spawner=None,
             hb_age=None, **kw):
    """A supervisor of `pkg` with every external effect faked; the probe
    seam is `relay_probe` in JAX, `device_probe` in the port."""
    spawned = []
    pids = iter(range(30001, 31000))

    def spawn(spec, env, log_path):
        h = (spawner or (lambda s, pid: FakeHandle(clock, pid)))(
            spec, next(pids))
        spawned.append((spec.job, h, env))
        return h

    def waiter_factory():
        assert waiters, "unexpected waiter spawn"
        return waiters.pop(0)

    seam = "relay_probe" if pkg is jax_runtime else "device_probe"
    sup = pkg.Supervisor(
        spool, waiter_factory=waiter_factory, spawn=spawn, clock=clock,
        sleep=clock.sleep, rng=lambda: 0.0,
        heartbeat_age=hb_age or (lambda path, started: 0.0),
        claim_grace_s=kw.pop("claim_grace_s", 5.0),
        waiter_retry_s=kw.pop("waiter_retry_s", 10.0),
        park_retry_s=kw.pop("park_retry_s", 10.0),
        kill_grace_s=kw.pop("kill_grace_s", 1.0),
        poll_s=kw.pop("poll_s", 0.5), log=lambda m: None,
        **{seam: probe if callable(probe) else (lambda: probe)}, **kw)
    sup.spawned = spawned
    return sup


def enqueue(pkg, spool, job="j1", **kw):
    kw.setdefault("argv", ["true"])
    kw.setdefault("heartbeat_timeout_s", 60.0)
    return spool.enqueue(pkg.JobSpec(job=job, **kw))


# the port's words for the card where JAX's speak of its relay
REASONS = {"device vanished during claim-wait":
           "relay died during claim-wait",
           "waiter failed": "waiter outage signature"}


def journal(spool):
    """The journal's records without wall stamps and pids; salvage
    records keep their artifact paths and sizes."""
    with open(spool.path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k not in ("t", "pid", "cwd")}
        for key in ("reason", "event"):
            if key in r:
                r[key] = REASONS.get(r[key], r[key])
        if "salvaged_artifacts" in r:
            r["salvaged_artifacts"] = [
                {k: v for k, v in a.items() if k != "mtime"}
                for a in r["salvaged_artifacts"]]
        out.append(r)
    return out


# ---- the scenarios of tests/test_supervisor.py, as functions of a pkg


def sc_no_device_parks(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "j1")
    sup = make_sup(pkg, sp, clock, probe=False, waiters=[])
    return sp, sup, sup.run(park_exit_s=50.0)


def sc_busy_one_waiter_drains(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "j1")
    enqueue(pkg, sp, "j2")
    sup = make_sup(pkg, sp, clock,
                   waiters=[FakeWaiter(clock, clear_at=clock.t + 300.0)])
    return sp, sup, sup.run()


def sc_stale_kill_salvage(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    work = tmp / "work"
    os.makedirs(work)
    (work / "sweep.json").write_text('{"partial": true}')
    enqueue(pkg, sp, "hang", artifacts=["sweep.json"], cwd=str(work),
            heartbeat_timeout_s=30.0, max_attempts=2, backoff_base_s=60.0,
            backoff_cap_s=600.0)
    sup = make_sup(pkg, sp, clock,
                   spawner=lambda s, pid: FakeHandle(clock, pid, rc=None),
                   waiters=[FakeWaiter(clock), FakeWaiter(clock)],
                   hb_age=lambda path, started: clock.t - started)
    out = sup.run()
    assert all(h.terminated for _, h, _ in sup.spawned)
    return sp, sup, out


def sc_transient_then_done(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "flaky", max_attempts=3, backoff_base_s=5.0,
            backoff_cap_s=10.0)
    rcs = [75, 0]
    sup = make_sup(pkg, sp, clock,
                   spawner=lambda s, pid: FakeHandle(clock, pid,
                                                     rc=rcs.pop(0)),
                   waiters=[FakeWaiter(clock), FakeWaiter(clock)])
    return sp, sup, sup.run()


def sc_permanent(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "broken", max_attempts=5)
    sup = make_sup(pkg, sp, clock,
                   spawner=lambda s, pid: FakeHandle(clock, pid, rc=1),
                   waiters=[FakeWaiter(clock)])
    return sp, sup, sup.run()


def sc_status_file_wins(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "statusy", max_attempts=2, backoff_base_s=1.0)
    attempts = []

    def spawner(spec, pid):
        attempts.append(1)
        with open(sp.status_path("statusy", len(attempts)), "w") as f:
            json.dump({"ok": len(attempts) > 1,
                       "error": "UNAVAILABLE: tunnel died",
                       "error_class": "transient"}, f)
        return FakeHandle(clock, pid, rc=1 if len(attempts) == 1 else 0)

    sup = make_sup(pkg, sp, clock, spawner=spawner,
                   waiters=[FakeWaiter(clock), FakeWaiter(clock)])
    return sp, sup, sup.run()


def sc_failed_waiter_then_clear(pkg, tmp, clock):
    """A waiter that could not launch #1 (rc 17): busy, a pause, a fresh
    waiter, then the job."""
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "j1")
    sup = make_sup(pkg, sp, clock, waiters=[
        FakeWaiter(clock, rc=17), FakeWaiter(clock, rc=17),
        FakeWaiter(clock, clear_at=clock.t + 40.0)])
    return sp, sup, sup.run()


def sc_device_vanishes_in_claim_wait(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "j1")
    die_at = clock.t + 50.0
    sup = make_sup(pkg, sp, clock, probe=lambda: clock.t < die_at,
                   waiters=[FakeWaiter(clock, clear_at=clock.t + 1e9)])
    return sp, sup, sup.run(park_exit_s=30.0)


def sc_recover(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "was-waiting")
    enqueue(pkg, sp, "was-running")
    sp.transition("was-waiting", pkg.CLAIM_WAIT)
    sp.transition("was-running", pkg.RUNNING, pid=2 ** 22 + 12345)
    sp.close()
    sp = pkg.Spool(str(tmp / "q"))
    sup = make_sup(pkg, sp, clock, waiters=[])
    sup.recover()
    return sp, sup, sup.summary()


def sc_fifo_serial(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    for name in ("first", "second", "third"):
        enqueue(pkg, sp, name)
    sup = make_sup(pkg, sp, clock,
                   spawner=lambda s, pid: FakeHandle(clock, pid, rc=0,
                                                     runtime=1.0),
                   waiters=[FakeWaiter(clock) for _ in range(3)])
    return sp, sup, sup.run()


def sc_job_env(pkg, tmp, clock):
    sp = pkg.Spool(str(tmp / "q"))
    enqueue(pkg, sp, "j1", env={"EXTRA": "1"})
    enqueue(pkg, sp, "j2", env={"OBS_SPAN_LOG": "/custom/spans.jsonl"})
    sup = make_sup(pkg, sp, clock, waiters=[FakeWaiter(clock)])
    return sp, sup, sup.run()


SCENARIOS = [sc_no_device_parks, sc_busy_one_waiter_drains,
             sc_stale_kill_salvage, sc_transient_then_done, sc_permanent,
             sc_status_file_wins, sc_failed_waiter_then_clear,
             sc_device_vanishes_in_claim_wait, sc_recover, sc_fifo_serial,
             sc_job_env]


def run_both(scenario, tmp_path, monkeypatch):
    monkeypatch.delenv("OBS_SPAN_LOG", raising=False)
    monkeypatch.delenv("OBS_METRICS", raising=False)
    out = {}
    for name, pkg in PKGS.items():
        clock = FakeClock()
        tmp = tmp_path / name
        os.makedirs(tmp)
        sp, sup, summary = scenario(pkg, tmp, clock)
        envs = [(job, {k: os.path.relpath(v, str(tmp))
                       if k in ("TPU_QUEUE_HEARTBEAT", "TPU_QUEUE_STATUS",
                                "OBS_SPAN_LOG") and v.startswith(str(tmp))
                       else v for k, v in env.items()
                       if k in ("TPU_QUEUE_HEARTBEAT", "TPU_QUEUE_STATUS",
                                "OBS_SPAN_LOG", "EXTRA")})
                for job, _, env in sup.spawned]
        out[name] = dict(journal=journal(sp), summary=summary,
                         waiters=sup.waiters_spawned, t=clock.t,
                         slept=clock.slept, envs=envs)
        sp.close()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_scenario_matches_jax(scenario, tmp_path, monkeypatch):
    out = run_both(scenario, tmp_path, monkeypatch)
    assert out["port"] == out["jax"]


def test_scenarios_reach_the_states_jax_tests_pin(tmp_path, monkeypatch):
    """The scenarios do what tests/test_supervisor.py asserts of them."""
    got = {s.__name__[3:]: run_both(s, tmp_path / s.__name__,
                                    monkeypatch)["port"]
           for s in SCENARIOS}
    assert got["no_device_parks"]["summary"]["parked"] is True
    assert got["no_device_parks"]["waiters"] == 0
    assert got["busy_one_waiter_drains"]["waiters"] == 1
    assert {j["state"] for j in got["busy_one_waiter_drains"]["summary"][
        "jobs"].values()} == {"done"}
    stale = got["stale_kill_salvage"]
    salv = [r for r in stale["journal"] if r.get("state") == "salvaged"]
    assert len(salv) == 2 and salv[0]["salvaged_artifacts"][0]["path"] \
        == "sweep.json"
    assert stale["summary"]["jobs"]["hang"]["state"] == "failed"
    assert got["transient_then_done"]["summary"]["jobs"]["flaky"] == {
        "state": "done", "attempt": 2}
    assert got["transient_then_done"]["slept"] >= 5.0
    assert got["permanent"]["summary"]["jobs"]["broken"] == {
        "state": "failed", "attempt": 1}
    assert got["status_file_wins"]["summary"]["jobs"]["statusy"][
        "state"] == "done"
    assert got["failed_waiter_then_clear"]["waiters"] == 3
    assert got["device_vanishes_in_claim_wait"]["summary"]["parked"]
    assert got["recover"]["summary"]["jobs"] == {
        "was-waiting": {"state": "queued", "attempt": 1},
        "was-running": {"state": "queued", "attempt": 2}}
    assert [j for j, _ in got["fifo_serial"]["envs"]] == [
        "first", "second", "third"]
    env1, env2 = dict(got["job_env"]["envs"])["j1"], dict(
        got["job_env"]["envs"])["j2"]
    assert env1["TPU_QUEUE_HEARTBEAT"] == os.path.join("q", "hb", "j1.json")
    assert env1["TPU_QUEUE_STATUS"] == os.path.join("q", "status",
                                                    "j1.1.json")
    assert env1["OBS_SPAN_LOG"] == os.path.join("obs", "spans.jsonl")
    assert env1["EXTRA"] == "1"
    assert env2["OBS_SPAN_LOG"] == "/custom/spans.jsonl"


@pytest.mark.parametrize("rc,want", [(0, "healthy"), (17, "device-busy")])
def test_triage_outcomes(tmp_path, rc, want):
    """A waiter exiting 17 (no context, or #1 not launched or wrong) is
    never `healthy`; a missing card spawns no waiter; a waiter still
    blocked past the grace stays parked, never killed."""
    clock = FakeClock()
    sp = runtime.Spool(str(tmp_path / "q"))
    sup = make_sup(runtime, sp, clock, waiters=[FakeWaiter(clock, rc=rc)])
    assert sup.triage() == want and sup.waiters_spawned == 1
    dead = make_sup(runtime, sp, clock, probe=False, waiters=[])
    assert dead.triage() == runtime.NO_DEVICE and dead.waiters_spawned == 0
    w = FakeWaiter(clock, clear_at=clock.t + 10_000)
    busy = make_sup(runtime, sp, clock, waiters=[w])
    assert busy.triage() == runtime.DEVICE_BUSY and busy.waiter is w
    sp.close()


@pytest.mark.parametrize("attempt", [1, 2, 3, 9])
def test_backoff_capped_exponential_matches_jax(tmp_path, attempt):
    outs = []
    for name, pkg in PKGS.items():
        clock = FakeClock()
        sp = pkg.Spool(str(tmp_path / name))
        for jitter in (0.0, 0.5, 1.0):
            sup = make_sup(pkg, sp, clock, waiters=[])
            sup.rng = lambda: jitter
            spec = pkg.JobSpec(job="x", argv=["true"], backoff_base_s=30.0,
                               backoff_cap_s=100.0)
            outs.append((name, jitter, sup._backoff_s(attempt, spec)))
        sp.close()
    port = [o[1:] for o in outs if o[0] == "port"]
    assert port == [o[1:] for o in outs if o[0] == "jax"]
    base = min(100.0, 30.0 * 2 ** (attempt - 1))
    assert [b for _, b in port] == [base, base * 1.125, base * 1.25]


# ---- journals interchange


def write_journal(pkg, root, work):
    sp = pkg.Spool(root)
    enqueue(pkg, sp, "a", artifacts=["*.json"], cwd=work,
            env={"K": "v"}, max_attempts=4)
    enqueue(pkg, sp, "b")
    enqueue(pkg, sp, "c")
    sp.transition("a", pkg.RUNNING, pid=11, started_at=5.0)
    sp.transition("a", pkg.SALVAGED, reason="hb stale",
                  salvaged_artifacts=[{"path": "x.json", "bytes": 3}])
    sp.transition("a", pkg.QUEUED, attempt=2, not_before=123.5)
    sp.transition("b", pkg.CLAIM_WAIT)
    sp.transition("b", pkg.RUNNING, pid=12)
    sp.transition("b", pkg.DONE, rc=0)
    sp.transition("c", pkg.RUNNING, pid=13)
    sp.transition("c", pkg.FAILED, rc=1, error="boom",
                  error_class="permanent")
    sp.note(event="waiter failed", rc=17, job="a")
    sp.close()


def states_of(sp):
    return [(dataclasses.asdict(js.spec), js.state, js.attempt,
             js.not_before, js.enqueued_at, js.pid, js.last)
            for js in sp.ordered()]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_journal_replays_in_the_other_package(tmp_path, writer, reader):
    root = str(tmp_path / "q")
    write_journal(PKGS[writer], root, str(tmp_path))
    with open(os.path.join(root, "jobs.jsonl"), "ab") as f:
        f.write(b'{"kind": "state", "job": "a", "state": "runn')  # torn
    theirs = PKGS[reader].Spool(root)  # repairs the torn tail
    got = states_of(theirs)
    theirs.close()
    mine = PKGS[writer].Spool(root)
    assert got == states_of(mine)
    assert [s[1:3] for s in got] == [("queued", 2), ("done", 1),
                                     ("failed", 1)]
    mine.close()
    theirs = PKGS[reader].Spool(root)  # the reader appends, the writer
    theirs.transition("a", PKGS[reader].RUNNING, pid=14)  # reads it
    theirs.close()
    mine = PKGS[writer].Spool(root)
    assert mine.jobs["a"].state == "running" and mine.jobs["a"].pid == 14
    mine.close()


def test_spool_state_machine_is_jax_s():
    from real_time_helmet_detection_tpu.runtime import spool as jax_spool
    from real_time_helmet_detection_tpu_torch.runtime import spool
    assert spool.VALID_TRANSITIONS == jax_spool.VALID_TRANSITIONS
    assert spool.TERMINAL == jax_spool.TERMINAL
    assert spool.JOURNAL == jax_spool.JOURNAL
    assert [f.name for f in dataclasses.fields(spool.JobSpec)] == [
        f.name for f in dataclasses.fields(jax_spool.JobSpec)]


# ---- the job exit contract


def _raise(exc):
    def main():
        if exc is not None:
            raise exc
    return main


CONTRACT = [
    ("ok", lambda pkg: None),
    ("exit-0", lambda pkg: SystemExit(0)),
    ("exit-none", lambda pkg: SystemExit(None)),
    ("exit-3", lambda pkg: SystemExit(3)),
    ("exit-text", lambda pkg: SystemExit("backend unavailable")),
    ("injected", lambda pkg: pkg.InjectedBackendError("UNAVAILABLE: x")),
    ("runtime-transient", lambda pkg: RuntimeError("DEADLINE_EXCEEDED: y")),
    ("runtime-permanent", lambda pkg: RuntimeError("shape mismatch")),
    ("value", lambda pkg: ValueError("bad\nsecond line")),
    ("empty", lambda pkg: KeyError()),
]


@pytest.mark.parametrize("case,make", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_run_as_job_matches_jax(tmp_path, monkeypatch, case, make):
    got = {}
    for name, (hb, errs) in {"jax": (jax_heartbeat, jax_errors),
                             "port": (heartbeat, errors)}.items():
        path = tmp_path / ("%s.json" % name)
        monkeypatch.setenv("TPU_QUEUE_STATUS", str(path))
        code = "returned"
        try:
            hb.run_as_job(_raise(make(errs)))
        except SystemExit as e:
            code = e.code
        with open(path) as f:
            rec = json.load(f)
        assert rec.pop("pid") == os.getpid() and rec.pop("t") > 0
        got[name] = (code, rec)
    assert got["port"] == got["jax"]
    monkeypatch.delenv("TPU_QUEUE_STATUS")
    with pytest.raises(KeyboardInterrupt):
        heartbeat.run_as_job(_raise(KeyboardInterrupt()))


def test_write_job_status_matches_jax(tmp_path, monkeypatch):
    recs = []
    for hb in (jax_heartbeat, heartbeat):
        path = tmp_path / ("s%d" % len(recs)) / "status.json"
        env = {"TPU_QUEUE_STATUS": str(path)}
        hb.write_job_status(False, error="x" * 900, error_class="transient",
                            extra={"stage": "fetch"}, env=env)
        hb.write_job_status(True, env={})  # unsupervised: a no-op
        with open(path) as f:
            rec = json.load(f)
        rec.pop("t"), rec.pop("pid")
        recs.append(rec)
    assert recs[0] == recs[1] and len(recs[1]["error"]) == 500


# ---- the card's probes and classifier


def test_waiter_exits_17_without_a_kernel_launch(monkeypatch, capsys):
    """In this process (no card): the context step fails; with it moved
    to the CPU, the peak test runs its plain version and launches no
    kernel — 17 either way, never a clear."""
    for src in (supervisor.WAITER_SRC,
                supervisor.WAITER_SRC.replace("device='cuda:0'",
                                              "device='cpu'")
                .replace(").to('cuda:0')", ")")):
        with pytest.raises(SystemExit) as e:
            exec(compile(src, "<waiter>", "exec"), {})
        assert e.value.code == 17
    out = capsys.readouterr().out
    assert "device clear" not in out
    assert "launched 0 kernels" in out


def test_device_probe_never_raises(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert supervisor.default_device_probe() is False
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("PATH", "")  # no nvidia-smi: the device node
    assert supervisor.default_device_probe() == os.path.exists(
        "/dev/nvidia0")


@pytest.mark.parametrize("msg", [
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: all CUDA-capable devices are busy or unavailable"])
def test_busy_card_is_transient(msg):
    """An exclusive-process card held by another process clears when
    that process exits: the port retries it (JAX has no card)."""
    assert errors.is_transient_backend_error(RuntimeError(msg))
    accel = type("AcceleratorError", (RuntimeError,), {})
    assert errors.is_transient_backend_error(accel(msg))
    assert errors.classify_error_text(msg) == "transient"
    assert not errors.is_transient_backend_error(ValueError(msg))
    sticky = "CUDA error: an illegal memory access was encountered"
    assert not errors.is_transient_backend_error(accel(sticky))


def test_default_spawn_kills_the_whole_group(tmp_path):
    """A job's children die with it: the handle signals the group."""
    spec = runtime.JobSpec(job="g", argv=[
        "/bin/sh", "-c", "sleep 30 & sleep 30 & wait"], cwd=str(tmp_path))
    h = supervisor.default_spawn(spec, dict(os.environ),
                                 str(tmp_path / "g.log"))
    try:
        assert h.poll() is None
        h.kill()
        h.popen.wait(timeout=30)
        assert h.poll() is not None
    finally:
        supervisor._signal_group(h.pid, signal.SIGKILL)
    members = subprocess.run(["pgrep", "-g", str(h.pid)],
                             capture_output=True, text=True).stdout.split()
    alive = [p for p in members
             if open("/proc/%s/stat" % p).read().rsplit(")", 1)[1].split()[0]
             != "Z"] if members else []
    assert alive == []


def test_smoke_leftovers_sees_threads_and_children():
    import chip_smoke
    before = chip_smoke.leftovers()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="leaky")
    t.start()
    child = subprocess.Popen(["sleep", "30"])
    try:
        left = chip_smoke.leftovers()
        assert "leaky" in left["threads"]
        assert any(c.startswith("%d (" % child.pid) and "sleep 30" in c
                   for c in left["children"])
    finally:
        stop.set()
        t.join()
        child.kill()
        child.wait()
    assert chip_smoke.leftovers() == before


ORPHAN_SRC = """
import json, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert chip_smoke.become_subreaper()
before = chip_smoke.leftovers()
# a child that starts a grandchild in a session of its own, then ends
subprocess.run(["sh", "-c", "setsid sleep 30 >/dev/null 2>&1 &"], check=True)
left = chip_smoke.settle(before, grace_s=0.5)
chip_smoke.stop_left(before)
print(json.dumps({"left": left, "after": chip_smoke.settle(before, 0.5)}))
"""


GROUP_SRC = """
import json, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert chip_smoke.become_subreaper()
before = chip_smoke.leftovers()
# a job: the leader of its own session, with a member it started
job = subprocess.Popen(["sh", "-c", "sleep 30 & exec sleep 31"],
                       start_new_session=True)
time.sleep(0.3)
members = [p for p in chip_smoke.group_members(job.pid) if p[1] != "Z"]
chip_smoke.stop_left(before)
print(json.dumps({"members": len(members), "left": [
    p for p in chip_smoke.group_members(job.pid) if p[1] != "Z"],
    "after": chip_smoke.settle(before, 0.5)}))
"""



@pytest.mark.parametrize("src,want", [
    # an orphaned grandchild is seen, then stopped
    (ORPHAN_SRC, {"left": {"threads": [], "children": ["sleep 30"]},
                  "after": {"threads": [], "children": []}}),
    # a job's whole process group is stopped
    (GROUP_SRC, {"members": 2, "left": [],
                 "after": {"threads": [], "children": []}}),
], ids=["orphaned-grandchild", "job-process-group"])
def test_smoke_settle_and_stop_left(src, want):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", src, repo],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if "children" in got.get("left", {}):
        got["left"]["children"] = [c.split(" ", 2)[2]
                                   for c in got["left"]["children"]]
    assert got == want
