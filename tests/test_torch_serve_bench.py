"""The port's serve_bench (`serving/runs.py`, `serving/sim.py`,
`serving/selfcheck.py`) against the JAX package's
`scripts/serve_bench.py`, on the CPU.

* The sims: rows of a seeded pool at buckets 1/2/4 bit-equal, on the
  leaves JAX's sims carry, to JAX's `_SimCompiled`,
  `_SimCascadeCompiled` and `_SimStreamCompiled`; a bucket-b stream
  batch takes b tile times; the pools and the confidence oracle are
  JAX's, so the pool's escalation fraction is JAX's; in a closed loop
  through the cascade the requests that escalate are exactly those
  whose oracle confidence is below the threshold.
* The records: a tiny CPU run of each mode (`--device cpu --imsize 64
  --inch 8 --duration 0.3 --clients 4 --pool 8`) carries JAX's schema
  string and every key of JAX's committed record of that schema
  (recursively into rows, curve, closed, faults, canary, death and
  serial_overload); `main` prints it as the one line of stdout.
* The trace sections equal JAX's traceview on the same span log; the
  engine under faults loses nothing, its retried rows equal the eager
  predict, the SLO error burn alerts; `--selfcheck --device cpu` passes
  as a subprocess; without `--device cpu` every mode wants the card.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
from real_time_helmet_detection_tpu_torch.ops.decode import (
    CascadeDetections, Detections)
from real_time_helmet_detection_tpu_torch.serving import ServingEngine, runs
from real_time_helmet_detection_tpu_torch.serving.loadgen import closed_loop
from real_time_helmet_detection_tpu_torch.serving.sim import (
    SimCascadePredict, SimServePredict, SimStreamPredict, sim_confidence,
    sim_pool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--imsize", "64", "--inch", "8", "--duration",
        "0.3", "--clients", "4", "--pool", "8"]
FAULTS = "serve:dispatch=device-loss@9,serve:fetch=hung-fetch@20"
# mode -> (flags, JAX's committed record of its schema)
MODES = {
    "engine": ([], "artifacts/r12/serving/serve_bench.json"),
    "faults": (["--faults", FAULTS],
               "artifacts/r11/serving/serve_bench_faults.json"),
    "fleet": (["--replicas", "1", "2"],
              "artifacts/r16/serving/serve_bench_fleet.json"),
    "cascade": (["--cascade"],
                "artifacts/r16/serving/serve_bench_cascade.json"),
    "streams": (["--streams"],
                "artifacts/r17/serving/serve_bench_streams.json"),
}
NESTED = {"rows", "curve", "closed", "faults", "canary", "death",
          "serial_overload"}


@pytest.fixture(scope="module")
def jax_sb():
    spec = importlib.util.spec_from_file_location(
        "serve_bench", os.path.join(REPO, "scripts", "serve_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """mode -> (record, stdout, span log or None), each mode run once,
    when a test first asks for it (inside the test, so on one torch
    thread)."""
    cache = {}
    tmp = tmp_path_factory.mktemp("serve_bench")

    def get(mode):
        if mode not in cache:
            flags, _ = MODES[mode]
            extra = ["--out", str(tmp / (mode + ".json"))]
            spans = None
            if mode == "engine":
                spans = str(tmp / "engine_spans.jsonl")
                extra += ["--span-log", spans]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = runs.main(flags + TINY + extra)
            cache[mode] = (out, buf.getvalue(), spans)
        return cache[mode]

    return get


def jsonable(x):
    return json.loads(json.dumps(x, default=str))


def missing_keys(jax, port, path=""):
    """JAX's keys absent from the port's record, recursively into the
    NESTED sections (every element of a list against every element)."""
    out = []
    for k, v in jax.items():
        where = path + "." + k if path else k
        if k not in port:
            out.append(where)
            continue
        if k not in NESTED:
            continue
        if isinstance(v, dict) and isinstance(port[k], dict):
            out += missing_keys(v, port[k], where)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            assert isinstance(port[k], list) and port[k], where
            for j in v:
                for p in port[k]:
                    out += missing_keys(j, p, where + "[]")
    return sorted(set(out))


# ------------------------------------------------------------------ sims


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("kind", ["serve", "cascade", "stream"])
def test_sim_rows_match_jax(jax_sb, kind, b):
    """Rows of a seeded pool, bit-equal to JAX's sim outputs on the leaves
    JAX's sims carry, in the engine's Detections leaves."""
    imgs = np.stack(sim_pool(runs.parse_args(TINY))[:b])
    x = torch.from_numpy(imgs)
    if kind == "serve":
        got = SimServePredict(0.0).body(x)
        want = jax_sb._SimCompiled(b, 0.0)(None, imgs)
        assert type(got) is Detections
    elif kind == "cascade":
        got = SimCascadePredict(0.0).body(x)
        want = jax_sb._SimCascadeCompiled(b, 0.0)(None, imgs)
        assert type(got) is CascadeDetections
        assert np.array_equal(got.confidence.numpy(), want.confidence)
        assert got.confidence.dtype == torch.float32
    else:
        got = SimStreamPredict(0.0).body(x)
        want = jax_sb._SimStreamCompiled(b, 0.0)(None, imgs)
        assert type(got) is Detections
        for name in ("boxes", "classes", "scores", "valid"):
            g, w = getattr(got, name).numpy(), getattr(want, name)
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        return
    assert np.array_equal(got.boxes.numpy().reshape(b, 4), want.boxes)
    assert np.array_equal(got.scores.numpy()[:, 0], want.scores)
    assert got.boxes.dtype == got.scores.dtype == torch.float32
    assert got.classes.dtype == torch.int32 and bool(got.valid.all())


@pytest.mark.parametrize("b", [1, 2, 4])
def test_stream_sim_sleeps_b_tile_times(b):
    sim = SimStreamPredict(20.0)
    x = torch.zeros((b, 64, 64, 3), dtype=torch.uint8)
    with SpanTracer(None).span("t") as sp:
        sim.body(x)
    assert sp.dur_s >= b * 0.020
    assert SimServePredict(20.0).service_time(b) == pytest.approx(0.020)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_sim_pool_and_escalation_frac_match_jax(jax_sb, seed):
    """The pool and the confidence oracle are JAX's, so the pool's
    escalation fraction at any threshold is JAX's."""
    args = runs.parse_args(TINY + ["--seed", str(seed)])
    ours, theirs = sim_pool(args), jax_sb._sim_pool(args)
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    for th in (0.1, 0.5, 0.9):
        ours_frac = sum(sim_confidence(i) < th for i in ours) / len(ours)
        theirs_frac = sum(jax_sb.SimCascadePredict.sim_confidence(i) < th
                          for i in theirs) / len(theirs)
        assert ours_frac == theirs_frac


def test_cascade_record_escalation_frac_is_jax(jax_sb, records):
    out, _, _ = records("cascade")
    args = runs.parse_args(TINY)
    pool = jax_sb._sim_pool(args)
    th = out["cascade_threshold"]
    assert th == 0.1
    want = sum(1 for img in pool
               if jax_sb.SimCascadePredict.sim_confidence(img) < th) \
        / len(pool)
    assert out["pool_escalation_frac"] == want
    e = out["escalations"]
    assert e["answered"] > 0 and e["agree"] == e["answered"]


def test_cascade_closed_loop_escalates_exactly_low_confidence():
    """Through the cascade sims in a closed loop, a request escalates
    iff its oracle confidence is below the threshold; both happen."""
    args = runs.parse_args(TINY + ["--cascade-edge-ms", "1",
                                   "--replica-sim-ms", "2", "--pool", "16"])
    pool = sim_pool(args)
    th = 0.5
    router = runs.cascade_sim_router(args, th, SpanTracer(None))
    rec = runs.Recorder(runs.TenantPin(router, "cascade"), pool)
    try:
        loop = closed_loop(rec, pool, 4, 0.5)
    finally:
        router.close()
    got = runs.answered(rec.take())
    assert loop["completed"] > 0 and len(got) >= loop["completed"]
    assert all(f.escalated == (sim_confidence(pool[i]) < th)
               for i, f in got)
    assert {f.escalated for _, f in got} == {True, False}


def test_sim_engine_serves_the_sim_rows():
    """A ServingEngine over a sim builds its buckets through its CPU path
    and serves each image its own row."""
    pool = sim_pool(runs.parse_args(TINY))
    sim = SimServePredict(1.0)
    eng = ServingEngine(sim, None, (64, 64, 3), np.uint8, buckets=(1, 2, 4),
                        max_wait_ms=1.0)
    try:
        rows = eng.predict_many(pool)
        assert eng.stats()["bucket_builds"] == 3
    finally:
        eng.close()
    for img, row in zip(pool, rows):
        want = sim.rows(img[None])
        assert all(np.array_equal(r, w[0].numpy())
                   for r, w in zip(row, want))


# --------------------------------------------------------------- records


@pytest.mark.parametrize("mode", list(MODES))
def test_record_has_jax_schema_and_keys(records, mode):
    out, _, _ = records(mode)
    with open(os.path.join(REPO, MODES[mode][1])) as f:
        jax = json.load(f)
    assert out["schema"] == jax["schema"]
    assert out["tool"] == "serve_bench" and out["platform"] == "cpu"
    assert missing_keys(jax, jsonable(out)) == []
    assert out["gate_traces_complete"] is True
    assert out["trace_summary"]["orphans"] == 0
    assert out["trace_summary"]["broken_chains"] == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_main_prints_one_json_line(records, mode):
    out, stdout, _ = records(mode)
    lines = stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == jsonable(out)
    with open(out["artifact"]) as f:
        saved = json.load(f)
    assert saved == {k: v for k, v in line.items() if k != "artifact"}


def test_trace_sections_match_jax_traceview(records):
    """The engine run's span log, read by JAX's traceview: the same
    summary and exemplars as the record's, no orphan, no broken chain."""
    from real_time_helmet_detection_tpu.obs import traceview as jax_tv
    out, _, spans = records("engine")
    traces = jax_tv.assemble_logs([spans])
    summary = jax_tv.analyze(traces)
    assert jsonable(out["trace_summary"]) == jsonable(summary)
    assert out["trace_exemplars"]["n"] == 3
    assert jsonable(out["trace_exemplars"]["exemplars"]) == jsonable(
        jax_tv.tail_exemplars(traces, 3))
    assert summary["orphans"] == summary["broken_chains"] == 0
    assert summary["request_traces"] > 0
    assert out["exemplar_p99_stage"] == out["trace_exemplars"][
        "exemplars"][0]["critical_path"]["dominant_stage"]


def test_engine_faults_on_cpu(records):
    """Under the injected device loss and hung fetch: lost 0 in every
    row, a retry, every answered row (the retried ones too) equal to
    the eager predict at its bucket, the SLO error burn alerted."""
    out, _, _ = records("faults")
    assert all(r["lost"] == 0 for r in out["curve"])
    f = out["faults"]
    assert f["lost_acks"] == 0 and f["injected"]["total"] == 2
    assert f["spec"] == FAULTS and out["retried"] >= 1
    rc = out["rows_check"]
    assert rc["rows"] > 0 and rc["equal"] == rc["rows"]
    assert "serve-error-burn" in out["slo_alerts"]
    assert out["bucket_builds"] == len(out["buckets"])


def test_engine_record_on_cpu(records):
    """The clean engine run: the curve at JAX's loads, the serial server
    on the overload trace, the ratio between them."""
    out, _, _ = records("engine")
    assert [r["load_multiplier"] for r in out["curve"]] == [0.5, 0.9, 2.0]
    assert out["serial_b1_rps"] > 0 and out["engine_capacity_rps"] > 0
    over = out["curve"][-1]["goodput_rps"]
    assert out["goodput_vs_serial_at_overload"] == pytest.approx(
        over / max(out["serial_overload"]["goodput_rps"], 1e-6))
    assert out["rows_check"]["equal"] == out["rows_check"]["rows"] > 0
    assert "faults" not in out and out["retried"] == 0


def test_selfcheck_subprocess():
    """`--selfcheck --device cpu` as a real subprocess: rc 0 and JAX's
    line, ok with no failures, as its last line of stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m",
         "real_time_helmet_detection_tpu_torch.serving.runs", "--selfcheck",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line["tool"] == "serve_bench" and line["selfcheck"] is True
    assert line["ok"] is True and line["failures"] == []
    assert 0 < line["elapsed_s"] < time.monotonic() - t0
    assert proc.stderr.count(" ok\n") >= 57


@pytest.mark.parametrize("flags", [[], ["--replicas", "1"], ["--cascade"],
                                   ["--streams"], ["--selfcheck"]],
                         ids=["engine", "fleet", "cascade", "streams",
                              "selfcheck"])
def test_every_mode_wants_the_card_without_device_cpu(flags, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        runs.main(flags + ["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
