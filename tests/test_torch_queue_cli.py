"""The port's queue command line (`python -m
real_time_helmet_detection_tpu_torch.runtime.queue`) against
scripts/tpu_queue.py, on the CPU without running a job.

* Every option string of the JAX CLI's parser and of each of its
  subcommands parses in the port's, to the same namespace.
* `enqueue` through either CLI and `status` through the other agree on
  the jobs; `status --summary` counts the same census.
* The CLI's defaults are its own: a queue directory beside the package
  that .gitignore lists, and no import of bench.py.
"""

import argparse
import ast
import io
import json
import os
import signal
import sys
from contextlib import redirect_stdout

import pytest

from real_time_helmet_detection_tpu_torch.runtime import queue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import tpu_queue  # noqa: E402

TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _fire(signum, frame):
        raise RuntimeError("queue CLI test exceeded the %ds hard timeout"
                           % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def jax_parser(monkeypatch):
    """scripts/tpu_queue.py builds its parser inside main(): catch it at
    its parse_args."""
    def capture(self, *a, **kw):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        tpu_queue.main(["status"])
    except _Captured as c:
        return c.parser
    finally:
        monkeypatch.undo()
    raise AssertionError("tpu_queue.main never parsed")


def subparsers(parser):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices
    return {}


def sample_argv(action):
    """One argv fragment setting `action` to a value."""
    opt = action.option_strings[0]
    if action.nargs == 0:
        return [opt]
    if action.type in (int, float):
        return [opt, "7"]
    return [opt, "x/*.json"]


def option_cases(monkeypatch):
    parser = jax_parser(monkeypatch)
    cases = []
    for action in parser._actions:
        if action.option_strings and action.dest != "help":
            cases.append(sample_argv(action) + ["status"])
    for name, sub in subparsers(parser).items():
        head = [name] + (["job"] if name == "enqueue" else [])
        for action in sub._actions:
            if action.option_strings and action.dest != "help":
                cases.append(head + sample_argv(action))
        cases.append(head)
    return parser, cases


def test_every_jax_option_parses_the_same(monkeypatch):
    parser, cases = option_cases(monkeypatch)
    strings = {s for c in cases for s in c if s.startswith("--")}
    assert {"--queue-dir", "--artifacts", "--heartbeat-timeout",
            "--max-attempts", "--backoff-base", "--backoff-cap",
            "--park-exit-s", "--claim-grace-s", "--park-retry-s",
            "--waiter-retry-s", "--summary"} <= strings
    ours = queue.build_parser()
    assert set(subparsers(ours)) == set(subparsers(parser))
    for argv in cases:
        assert vars(ours.parse_args(argv)) == vars(parser.parse_args(argv)), \
            argv


def run_main(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_enqueue_and_status_across_the_two_clis(tmp_path, writer):
    mains = {"port": queue.main, "jax": tpu_queue.main}
    reader = "jax" if writer == "port" else "port"
    qdir = str(tmp_path / "queue")
    for name in ("first", "second"):
        rc, _ = run_main(mains[writer], [
            "--queue-dir", qdir, "enqueue", name, "--artifacts", "w/*.npz",
            "--heartbeat-timeout", "600", "--max-attempts", "2", "--",
            sys.executable, "-c", "print(%r)" % name])
        assert rc == 0
    outs = {}
    for who in (writer, reader):
        rc, out = run_main(mains[who], ["--queue-dir", qdir, "status"])
        assert rc == 0
        outs[who] = json.loads(out)
    assert outs[writer] == outs[reader]
    assert [(j["job"], j["state"], j["attempt"]) for j in outs[reader][
        "jobs"]] == [("first", "queued", 1), ("second", "queued", 1)]
    with pytest.raises(SystemExit):  # no command after `--`
        mains[reader](["--queue-dir", qdir, "enqueue", "third"])


def test_status_summary_census_matches_jax(tmp_path, capsys):
    from real_time_helmet_detection_tpu_torch.runtime import JobSpec, Spool
    qa = Spool(str(tmp_path / "a"))
    qa.enqueue(JobSpec(job="x", argv=["true"]))
    qa.transition("x", "running", pid=1)
    qa.transition("x", "salvaged", salvaged_artifacts=[])
    qa.transition("x", "failed", error="budget")
    qa.enqueue(JobSpec(job="y", argv=["true"]))
    qa.close()
    with open(qa.path, "ab") as f:
        f.write(b"{torn")
    census = queue.journal_census(qa.path)
    assert census == tpu_queue._journal_census(qa.path) == {
        "jobs": 2, "by_state": {"failed": 1, "queued": 1}, "salvaged": 1,
        "dropped_lines": 1}
    qb = Spool(str(tmp_path / "b"))
    qb.close()
    rc, out = run_main(queue.main, ["--queue-dir", str(tmp_path / "a"),
                                    "status", "--summary"])
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["queues"] == {
        "a": census, "b": {"jobs": 0, "by_state": {}, "salvaged": 0,
                           "dropped_lines": 0}}
    with open(qa.path, "rb") as f:  # the census repaired nothing
        assert f.read().endswith(b"{torn")


def test_defaults_are_the_port_s_own():
    assert queue.default_queue_dir() == os.path.join(REPO, "chip_queue",
                                                     "queue")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "chip_queue/" in f.read().split()
    with open(queue.__file__) as f:
        tree = ast.parse(f.read())
    imported = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)} | {
        a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
        for a in n.names}
    assert "bench" not in imported and not any(
        m and m.startswith("real_time_helmet_detection_tpu.")
        for m in imported)
