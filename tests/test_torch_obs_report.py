"""The port's round report (`real_time_helmet_detection_tpu_torch/obs/
report.py`) against the JAX package's `scripts/obs_report.py`, on the
CPU: one seeded round written by the port's own writers (span logs with
trace contexts and links, a spool journal, metrics snapshots,
`stream:frame` records, a loss log, a bench line) gives equal report
dicts from both `build_report`s once the paths are left out, and the
same markdown but for the generator's name; `read_report` nulls the same
sections of v1-v7 reports; the port's `--selfcheck` exits 0."""

import importlib.util
import json
import os

import numpy as np
import pytest

from real_time_helmet_detection_tpu_torch.obs import report as port_report
from real_time_helmet_detection_tpu_torch.obs import trace
from real_time_helmet_detection_tpu_torch.obs.metrics import (MetricsRegistry,
                                                              MetricsWriter)
from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
from real_time_helmet_detection_tpu_torch.runtime.spool import (
    DONE, FAILED, RUNNING, SALVAGED, JobSpec, Spool)
from real_time_helmet_detection_tpu_torch.utils import save_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_round(root, seed=0):
    """A round under `root` as the port writes one: the paths of
    (span logs, queue dir, bench files, loss logs, metrics files)."""
    rng = np.random.default_rng(seed)
    obs = os.path.join(root, "obs")
    os.makedirs(obs)
    trace.reset_ids(seed)
    spans = os.path.join(obs, "spans.jsonl")
    tr = SpanTracer(spans)
    tr.bind(rank=0, world=1)
    # serving: request traces, a batch span linked to both, one closure
    # each; a redispatch and a fault inside one of them
    roots = [trace.new_root() for _ in range(4)]
    for r in roots:
        tr.record("serve:queue-wait", float(rng.uniform(1e-3, 5e-3)),
                  ctx=r.child(), b=2)
    tr.record("serve:batch-form", 1e-3, n=2)
    tr.record("serve:compute", float(rng.uniform(2e-3, 8e-3)),
              links=trace.links_of(roots[:2]), b=2)
    tr.record("serve:compute", float(rng.uniform(2e-3, 8e-3)),
              links=trace.links_of(roots[2:]), b=2)
    tr.event("fault:device-loss", site="serve:dispatch", ctx=roots[0].child())
    tr.event("fleet:redispatch", ctx=roots[0].child(), rid=0, attempt=1)
    for r in roots:
        tr.record("serve:e2e", float(rng.uniform(5e-3, 2e-2)), ctx=r)
    # training steps with their step traces, a checkpoint, a heartbeat
    for i in range(5):
        tr.record("step", float(rng.uniform(0.01, 0.05)),
                  ctx=trace.step_context(i, rank=0, run="fix"), it=i)
    with tr.span("checkpoint", epoch=0):
        pass
    tr.event("heartbeat", label="flush 0")
    tr.event("recover:requeue", stage="dispatch", b=2, n=2,
             error="InjectedBackendError")
    tr.event("alert:serve-error-burn", frac=0.5, budget=0.1, window=2)
    # the cascade's markers and the streams' delivery records (the
    # fleet's e2e meta and `serving/streams.py`'s stream:frame shape)
    tr.record("fleet:e2e", 0.006, rid=0, escalated=False, degraded=False)
    tr.event("fleet:escalate", rid=0, tenant="cas", confidence=0.12,
             threshold=0.3)
    tr.record("fleet:e2e", 0.030, rid=1, escalated=True, degraded=False)
    for sid in range(2):
        for seq in range(4):
            tr.record("stream:frame", float(rng.uniform(1e-3, 4e-3)),
                      sid=sid, seq=seq, computed=int(rng.integers(0, 5)),
                      total=4, gap=seq == 2 and sid == 0,
                      late=seq == 3 and sid == 1)
    tr.event("recover:frame-gap", ctx=None, sid=0, seq=2,
             kind="dropped-frame")
    tr.close()
    # a second (rank) log
    tr2 = SpanTracer(os.path.join(obs, "spans_rank1.jsonl"))
    tr2.bind(rank=1, world=2)
    tr2.record("step", 0.02, ctx=trace.step_context(0, rank=1, run="fix"))
    tr2.close()
    # the spool journal: done, salvaged -> queued -> failed
    qdir = os.path.join(root, "queue")
    spool = Spool(qdir)
    spool.enqueue(JobSpec(job="train", argv=["python", "-m", "x"]))
    spool.transition("train", RUNNING, pid=1, started_at=1.0)
    spool.transition("train", DONE)
    spool.enqueue(JobSpec(job="eval", argv=["python", "-m", "y"]))
    spool.transition("eval", RUNNING, pid=2, started_at=2.0)
    spool.transition("eval", SALVAGED,
                     salvaged_artifacts=[{"path": "w/check_point_1"}])
    spool.transition("eval", "queued", attempt=2)
    spool.transition("eval", RUNNING, pid=3, started_at=3.0, attempt=2)
    spool.transition("eval", FAILED, error="UNAVAILABLE: injected")
    spool.close()
    # metrics snapshots
    reg = MetricsRegistry()
    reg.counter("queue.requeues").inc(2)
    reg.gauge("queue.jobs.done").set(1)
    for v in rng.uniform(5.0, 50.0, 16):
        reg.histogram("serve.e2e_ms").observe(float(v))
    metrics = os.path.join(obs, "metrics.jsonl")
    w = MetricsWriter(reg, metrics, period_s=0.0)
    w.maybe_flush(force=True)
    reg.counter("queue.requeues").inc(1)
    w.close()
    # a loss log and a bench line
    log = LossLog()
    for i in range(3):
        log.append({k: float(1.0 / (i + 1)) for k in LossLog.KEYS})
    loss = os.path.join(root, "loss_log.json")
    save_json(loss, log.state_dict())
    bench = os.path.join(root, "BENCH_rXX_local.json")
    with open(bench, "w") as f:
        f.write(json.dumps({"metric": "inference_fps_512", "value": 931.7,
                            "platform": "gpu", "latency_ms_b1": 1.955})
                + "\n")
    return ([spans, os.path.join(obs, "spans_rank1.jsonl")], qdir, [bench],
            [loss], [metrics])


PATH_KEYS = ("logs", "path", "journal")


def strip_paths(obj):
    if isinstance(obj, dict):
        return {k: strip_paths(v) for k, v in obj.items()
                if k not in PATH_KEYS}
    if isinstance(obj, list):
        return [strip_paths(v) for v in obj]
    return obj


def test_build_report_and_markdown_match_jax(tmp_path, jax_report):
    spans, qdir, bench, loss, metrics = write_round(str(tmp_path / "r17"))
    ours = port_report.build_report("r17", spans, qdir, bench, loss,
                                    metrics_paths=metrics)
    theirs = jax_report.build_report("r17", spans, qdir, bench, loss,
                                     metrics_paths=metrics)
    assert strip_paths(ours) == strip_paths(theirs)
    # every section this round feeds is there, and the traces close
    for section in ("serving", "faults", "metrics", "slo", "fleet",
                    "streams", "traces", "queue"):
        assert ours[section], section
    assert ours["traces"]["orphans"] == 0
    assert ours["traces"]["broken_chains"] == 0
    assert ours["streams"]["frames"] == 8
    assert ours["queue"]["jobs"]["eval"]["state"] == "failed"
    md_ours = port_report.render_markdown(ours)
    md_theirs = jax_report.render_markdown(theirs)
    assert md_ours == md_theirs.replace("scripts/obs_report.py",
                                        port_report.GENERATOR)


def test_cli_writes_the_round_report(tmp_path, capsys):
    """`--round-dir` finds the round's inputs by their default places."""
    root = str(tmp_path / "r17")
    spans, qdir, bench, loss, metrics = write_round(root)
    assert port_report.main(["--round-dir", root, "--loss-log",
                             loss[0]]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["round"] == "r17" and rep["schema"] == port_report.SCHEMA
    assert len(rep["spans"]["logs"]) == 2
    assert rep["metrics"]["files"][0]["counters"]["queue.requeues"] == 3
    assert rep["bench"][0]["value"] == 931.7 and rep["loss"]
    assert os.path.isfile(os.path.join(root, "obs", "report.md"))
    back = port_report.read_report(os.path.join(root, "obs", "report.json"))
    assert back is not None and back["streams"]["frames"] == 8


@pytest.mark.parametrize("version", range(1, 8))
def test_read_report_nulls_the_same_sections(tmp_path, jax_report, version):
    rep = {"schema": "obs-report-v%d" % version, "round": "r%02d" % version,
           "spans": {"records": version}}
    if version >= 2:
        rep.update(metrics={"files": []}, slo=None)
    if version >= 3:
        rep["scaling"] = {"files": [], "spans": {}}
    if version >= 4:
        rep["fleet"] = {"dispatches_total": 3}
    if version >= 5:
        rep["traces"] = {"traces": 0}
    if version >= 6:
        rep["fleet"]["cascade"] = {"requests": 3}
    if version >= 7:
        rep["streams"] = {"frames": 4}
    path = str(tmp_path / "report.json")
    with open(path, "w") as f:
        json.dump(rep, f)
    ours = port_report.read_report(path)
    assert ours == jax_report.read_report(path)
    assert (ours["streams"] is None) == (version < 7)
    assert (ours["traces"] is None) == (version < 5)
    with open(path, "w") as f:
        json.dump({"schema": "obs-report-v9"}, f)
    assert port_report.read_report(path) is None
    assert jax_report.read_report(path) is None


def test_selfcheck_exits_zero(capsys):
    assert port_report.main(["--selfcheck"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["failures"] == []


def test_streams_run_writes_what_the_report_reads(tmp_path, monkeypatch,
                                                  jax_report):
    """The repair: `serving.runs --streams` gave its fault run's session
    and injector no tracer, so with $OBS_SPAN_LOG set the port wrote no
    `stream:frame`, `recover:frame-gap` or `fault:*` record where JAX's
    serve_bench writes them. Now the report's Streams section reads the
    fault run's 10 delivered frames, its 2 gaps (a dropped and a corrupt
    frame, answered from the cache) and its late frame, as JAX's
    report does from the same log. The record's simulated sections write
    to their own span log (`--span-log`), so this one holds the real
    engines' fault run alone."""
    from real_time_helmet_detection_tpu_torch.serving import runs
    log = str(tmp_path / "obs" / "spans.jsonl")
    monkeypatch.setenv("OBS_SPAN_LOG", log)
    out = runs.main(["--streams", "--device", "cpu", "--imsize", "64",
                     "--streams-n", "1", "--stream-frames", "2",
                     "--duration", "0.1", "--no-amp",
                     "--span-log", str(tmp_path / "sim_spans.jsonl"),
                     "--out", str(tmp_path / "streams.json")])
    out = out["engine"]  # the real-engine section of the record
    ours = port_report.build_report("r", [log], None, [], [])
    assert strip_paths(ours) == strip_paths(
        jax_report.build_report("r", [log], None, [], []))
    st = ours["streams"]
    assert st is not None and st["streams"] == 1
    assert st["frames"] == out["faults"]["delivered"] == 10
    assert (st["gaps"], st["late"]) == (2, 1)
    assert st["frame_gap_recoveries"] == {"corrupt-frame": 1,
                                          "dropped-frame": 1}
    assert ours["faults"]["injected"] == {"corrupt-frame": 1,
                                          "dropped-frame": 1,
                                          "late-frame": 1}
