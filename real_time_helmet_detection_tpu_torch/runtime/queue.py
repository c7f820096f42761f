"""The job queue's command line: enqueue jobs, drain them on the card
under the supervisor, inspect the spool.

Port of ref scripts/tpu_queue.py:57-316 (`enqueue`, `run`, `status
[--summary]`, `--selfcheck`), on the port's spool and supervisor
(`runtime/spool.py`, `runtime/supervisor.py`, whose triage probes the
CUDA card). Stdlib only: it builds no model and touches the card only
through the supervisor's waiter and the jobs it spawns.

    # queue jobs (does not touch the card); the command follows `--`
    python -m real_time_helmet_detection_tpu_torch.runtime.queue \\
        enqueue train --artifacts 'runs/w/check_point_*' \\
        --heartbeat-timeout 600 -- python -m \\
        real_time_helmet_detection_tpu_torch --train-flag --data VOC \\
        --save-path runs/w --amp

    # drain it (one supervisor owns the card; jobs run one at a time)
    python -m real_time_helmet_detection_tpu_torch.runtime.queue run

    # inspect: this queue, or a census of every queue beside it
    python -m real_time_helmet_detection_tpu_torch.runtime.queue status
    python -m real_time_helmet_detection_tpu_torch.runtime.queue status \\
        --summary

    # the spool's state machine end to end on the CPU with real
    # subprocesses (ok / transient retry / hang-kill-salvage)
    python -m real_time_helmet_detection_tpu_torch.runtime.queue \\
        --selfcheck

The default `--queue-dir` is `chip_queue/queue` beside the package
(listed in .gitignore); the jobs' span log defaults to
`chip_queue/obs/spans.jsonl`. Jobs run with the current directory as
their cwd. `run` exits 0 when every job is done, 1 when one failed, and
`EXIT_TRANSIENT` (75) when it gave up parked on a missing card (the
queue persists).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

from .errors import EXIT_TRANSIENT
from .spool import JobSpec, Spool
from .supervisor import PACKAGE_ROOT, Supervisor


def default_queue_dir() -> str:
    return os.path.join(PACKAGE_ROOT, "chip_queue", "queue")


def cmd_enqueue(args) -> int:
    if not args.command:
        raise SystemExit("enqueue: no command given (use `-- cmd ...`)")
    spool = Spool(args.queue_dir)
    spec = JobSpec(
        job=args.name, argv=list(args.command),
        artifacts=args.artifacts or [],
        heartbeat_timeout_s=args.heartbeat_timeout,
        max_attempts=args.max_attempts,
        backoff_base_s=args.backoff_base,
        backoff_cap_s=args.backoff_cap,
        cwd=os.getcwd())
    spool.enqueue(spec)
    spool.close()
    print("enqueued %s: %s" % (args.name, " ".join(args.command)))
    return 0


def cmd_run(args) -> int:
    spool = Spool(args.queue_dir)
    sup = Supervisor(spool,
                     claim_grace_s=args.claim_grace_s,
                     park_retry_s=args.park_retry_s,
                     waiter_retry_s=args.waiter_retry_s)
    summary = sup.run(park_exit_s=args.park_exit_s)
    spool.close()
    print(json.dumps(summary))
    if summary.get("parked"):
        return EXIT_TRANSIENT  # retry later; the queue persists
    states = {j["state"] for j in summary["jobs"].values()}
    return 1 if "failed" in states else 0


def cmd_status(args) -> int:
    if args.summary:
        return cmd_status_summary(args)
    spool = Spool(args.queue_dir)
    rows = [{"job": js.spec.job, "state": js.state, "attempt": js.attempt,
             "not_before": js.not_before or None,
             "argv": " ".join(js.spec.argv)}
            for js in spool.ordered()]
    spool.close()
    print(json.dumps({"queue_dir": spool.root, "jobs": rows}, indent=1))
    return 0


def journal_census(path: str):
    """Read-only census of one journal: the last state of each job, the
    jobs that passed through salvage, the lines dropped. It never opens
    a Spool (whose constructor repairs a torn tail in place)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    jobs: dict = {}
    salvaged = set()
    dropped = 0
    for ln in data.splitlines():
        if not ln.strip():
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            dropped += 1
            continue
        kind, job = rec.get("kind"), rec.get("job")
        if kind == "spec" and job:
            jobs.setdefault(job, "queued")
        elif kind == "state" and job in jobs and rec.get("state"):
            jobs[job] = rec["state"]
            if rec["state"] == "salvaged":
                # a waypoint (salvaged -> failed/queued): counted apart
                # from the terminal state
                salvaged.add(job)
    by_state: dict = {}
    for st in jobs.values():
        by_state[st] = by_state.get(st, 0) + 1
    return {"jobs": len(jobs), "by_state": dict(sorted(by_state.items())),
            "salvaged": len(salvaged), "dropped_lines": dropped}


def cmd_status_summary(args) -> int:
    """One table over every queue beside `--queue-dir`
    (`<parent>/*/jobs.jsonl`): each queue's jobs by state and its
    salvaged count, on stderr; one JSON line on stdout."""
    parent = os.path.dirname(os.path.abspath(args.queue_dir))
    queues = {}
    for path in sorted(glob.glob(os.path.join(parent, "*", "jobs.jsonl"))):
        census = journal_census(path)
        if census is not None:
            queues[os.path.basename(os.path.dirname(path))] = census
    if queues:
        states = sorted({s for c in queues.values() for s in c["by_state"]})
        hdr = ["queue", "jobs"] + states + ["salvaged"]
        print("  ".join("%-9s" % h for h in hdr), file=sys.stderr)
        for name, c in queues.items():
            row = [name, str(c["jobs"])]
            row += [str(c["by_state"].get(s, 0)) for s in states]
            row += [str(c["salvaged"])]
            print("  ".join("%-9s" % v for v in row), file=sys.stderr)
    else:
        print("no queues under %s" % parent, file=sys.stderr)
    print(json.dumps({"tool": "queue", "summary": True, "queues": queues}))
    return 0


# ---- selfcheck: the spool state machine end to end on the CPU -----------

_OK_JOB = (
    "import os, time\n"
    "from real_time_helmet_detection_tpu_torch.runtime.heartbeat import ("
    "maybe_job_heartbeat, write_job_status)\n"
    "from real_time_helmet_detection_tpu_torch.utils import "
    "atomic_write_bytes\n"
    "hb = maybe_job_heartbeat()\n"
    "for i in range(3):\n"
    "    hb.beat('step %d' % i)\n"
    "    time.sleep(0.05)\n"
    "atomic_write_bytes(os.environ['SELFCHECK_ARTIFACT'], b'{\"ok\": true}')\n"
    "write_job_status(True)\n"
)

_TRANSIENT_JOB = (
    "import os, sys\n"
    "from real_time_helmet_detection_tpu_torch.runtime.errors import "
    "EXIT_TRANSIENT\n"
    "from real_time_helmet_detection_tpu_torch.runtime.heartbeat import ("
    "maybe_job_heartbeat, write_job_status)\n"
    "from real_time_helmet_detection_tpu_torch.utils import "
    "atomic_write_bytes\n"
    "maybe_job_heartbeat().beat('attempt')\n"
    "marker = os.environ['SELFCHECK_MARKER']\n"
    "if not os.path.exists(marker):\n"
    "    atomic_write_bytes(marker, b'1')\n"
    "    write_job_status(False, error='UNAVAILABLE: injected',"
    " error_class='transient')\n"
    "    sys.exit(EXIT_TRANSIENT)\n"
    "write_job_status(True)\n"
)

# flushes one partial artifact, then hangs without beating: the
# stale-heartbeat kill and the salvage record
_HANG_JOB = (
    "import os, time\n"
    "from real_time_helmet_detection_tpu_torch.runtime.heartbeat import "
    "maybe_job_heartbeat\n"
    "from real_time_helmet_detection_tpu_torch.utils import "
    "atomic_write_bytes\n"
    "maybe_job_heartbeat().beat('before hang')\n"
    "atomic_write_bytes(os.environ['SELFCHECK_ARTIFACT'], b'{\"partial\": 1}')\n"
    "time.sleep(120)\n"
)


class _InstantWaiter:
    pid = 0

    def poll(self):
        return 0


def selfcheck() -> int:
    """The spool exercised with real subprocesses on the CPU: the device
    probe and the waiter are replaced by instant healthy ones (no card),
    everything else is the production path — spawn as a process group, the
    heartbeat files, the group SIGTERM, salvage, backoff requeue, and the
    journal's replay across a supervisor restart."""
    failures = []

    def check(name, cond):
        print("selfcheck %-42s %s" % (name, "ok" if cond else "FAIL"),
              flush=True)
        if not cond:
            failures.append(name)

    with tempfile.TemporaryDirectory(prefix="queue_selfcheck.") as tmp:
        qdir = os.path.join(tmp, "queue")
        env_common = {"PYTHONPATH": os.pathsep.join(
            [PACKAGE_ROOT] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p])}
        py = sys.executable

        spool = Spool(qdir)
        art_ok = os.path.join(tmp, "ok_artifact.json")
        art_hang = os.path.join(tmp, "hang_partial.json")
        marker = os.path.join(tmp, "transient_marker")
        spool.enqueue(JobSpec(
            job="ok", argv=[py, "-c", _OK_JOB], cwd=tmp,
            artifacts=[os.path.basename(art_ok)],
            heartbeat_timeout_s=30.0,
            env=dict(env_common, SELFCHECK_ARTIFACT=art_ok)))
        spool.enqueue(JobSpec(
            job="transient", argv=[py, "-c", _TRANSIENT_JOB], cwd=tmp,
            heartbeat_timeout_s=30.0, max_attempts=3,
            backoff_base_s=0.1, backoff_cap_s=0.2,
            env=dict(env_common, SELFCHECK_MARKER=marker)))
        # the deadline outlives a cold interpreter start, so the pre-hang
        # beat and the artifact flush happen first
        spool.enqueue(JobSpec(
            job="hang", argv=[py, "-c", _HANG_JOB], cwd=tmp,
            artifacts=[os.path.basename(art_hang)],
            heartbeat_timeout_s=8.0, max_attempts=2,
            backoff_base_s=0.1, backoff_cap_s=0.2,
            env=dict(env_common, SELFCHECK_ARTIFACT=art_hang)))

        sup = Supervisor(spool, device_probe=lambda: True,
                         waiter_factory=_InstantWaiter,
                         poll_s=0.05, kill_grace_s=1.0)
        t0 = time.time()
        summary = sup.run()
        print("selfcheck drained in %.1fs: %s"
              % (time.time() - t0, json.dumps(summary)), flush=True)

        jobs = summary["jobs"]
        check("ok job done", jobs["ok"]["state"] == "done")
        check("ok artifact written", os.path.exists(art_ok))
        check("transient retried then done",
              jobs["transient"]["state"] == "done"
              and jobs["transient"]["attempt"] == 2)
        check("hang killed, budget exhausted -> failed",
              jobs["hang"]["state"] == "failed")
        with open(spool.path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        salv = [r for r in recs if r.get("kind") == "state"
                and r.get("job") == "hang" and r["state"] == "salvaged"]
        check("hang salvaged with partial artifact",
              bool(salv) and any(a["path"] == os.path.basename(art_hang)
                                 for a in salv[0]["salvaged_artifacts"]))
        requeues = [r for r in recs if r.get("kind") == "state"
                    and r.get("job") == "hang" and r["state"] == "queued"
                    and r.get("attempt", 1) > 1]
        check("hang requeued with backoff gate",
              bool(requeues) and requeues[0].get("not_before", 0) > 0)
        spool.close()

        # restart: replay the journal in a fresh Spool — nothing lost,
        # terminal states intact
        spool2 = Spool(qdir)
        check("replay preserves all jobs", len(spool2.jobs) == 3)
        check("replay preserves terminal states",
              spool2.jobs["ok"].state == "done"
              and spool2.jobs["hang"].state == "failed")
        spool2.close()

    if failures:
        print("selfcheck: %d FAILURE(s): %s" % (len(failures), failures),
              flush=True)
        return 1
    print("selfcheck: all checks passed", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--queue-dir", default=None,
                   help="spool dir (default chip_queue/queue beside the "
                        "package)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("enqueue", help="append a job to the spool")
    pe.add_argument("name")
    pe.add_argument("--artifacts", action="append", default=[],
                    help="glob (relative to the cwd) recorded on salvage; "
                         "repeat")
    pe.add_argument("--heartbeat-timeout", type=float, default=1800.0,
                    help="stale-beat kill deadline, seconds (default 1800)")
    pe.add_argument("--max-attempts", type=int, default=3)
    pe.add_argument("--backoff-base", type=float, default=60.0)
    pe.add_argument("--backoff-cap", type=float, default=900.0)

    pr = sub.add_parser("run", help="drain the queue (owns the card)")
    pr.add_argument("--park-exit-s", type=float, default=None,
                    help="give up (exit 75, queue persists) after this "
                         "long parked with no card visible")
    pr.add_argument("--claim-grace-s", type=float, default=90.0)
    pr.add_argument("--park-retry-s", type=float, default=60.0)
    pr.add_argument("--waiter-retry-s", type=float, default=120.0)

    ps = sub.add_parser("status", help="print the spool state as JSON")
    ps.add_argument("--summary", action="store_true",
                    help="census of every queue beside --queue-dir "
                         "(read-only; journals are never repaired)")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--selfcheck" in argv:
        return selfcheck()
    # the job command sits after a literal `--` (argparse's REMAINDER
    # would swallow enqueue's own options)
    command = []
    if "--" in argv:
        cut = argv.index("--")
        argv, command = argv[:cut], argv[cut + 1:]
    args = build_parser().parse_args(argv)
    args.command = command
    args.queue_dir = args.queue_dir or default_queue_dir()
    return {"enqueue": cmd_enqueue, "run": cmd_run,
            "status": cmd_status}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
