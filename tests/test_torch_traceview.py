"""The port's trace analyzer and metric readers against the JAX
package's, on the same files (CPU).

* `analyze`, `tail_exemplars`, and each trace's `waterfall` and
  `critical_path` are equal dicts from `obs.traceview` of both packages
  over: a span log of the port's own fleet (two replica engines of a
  tiny model, a seeded dispatch fault, requests co-batched), and a log
  with a closed trace, an orphan (its closure torn mid-record), a broken
  chain and two ranks' step traces.
* `read_metrics`, `read_latest` and `snapshot_digest` agree on the files
  each package's `MetricsWriter` writes, torn tail and missing sidecar
  included; `reset_default_registry` replaces the process registry.
"""

import json
import signal

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.obs import metrics as jax_metrics
from real_time_helmet_detection_tpu.obs import spans as jax_spans
from real_time_helmet_detection_tpu.obs import traceview as jax_traceview
from real_time_helmet_detection_tpu_torch import obs
from real_time_helmet_detection_tpu_torch.obs import (metrics, spans, trace,
                                                      traceview)

TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _fire(signum, frame):
        raise RuntimeError("traceview test exceeded the %ds hard timeout"
                           % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def fleet_log(path):
    """Eight requests through the port's FleetRouter over two CPU engines
    of a width-8 model at 64^2, buckets 1 and 2, replica 0 losing its
    second dispatch; every record to one span log."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.serving import FleetRouter
    from real_time_helmet_detection_tpu_torch.serving.runs import \
        make_replica_factory
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=8, imsize=64,
                 topk=8, conf_th=0.0)

    def predict(rid):
        model = init_weights(build_model(cfg), 0)
        return make_predict_fn(model, cfg, normalize="imagenet",
                               device="cpu")

    trace.reset_ids(11)
    tracer = spans.SpanTracer(path)
    factory = make_replica_factory(
        predict, (64, 64, 3), lambda rid: (1, 2), max_wait_ms=1.0,
        tracer=tracer, injector_for={0: "serve:dispatch=device-loss@2"})
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        router = FleetRouter(factory, 2, metrics=metrics.MetricsRegistry(),
                             tracer=tracer, start=False)
        pool = np.random.default_rng(0).integers(0, 256, (8, 64, 64, 3),
                                                 dtype=np.uint8)
        futs = [router.submit(img) for img in pool]
        router.start()
        for f in futs:
            f.result(timeout=60)
        router.close()
    finally:
        torch.set_num_threads(threads)
        tracer.close()
        trace.reset_ids()


def damaged_log(path):
    """A closed trace, a broken chain, an orphan whose closure is torn,
    and step traces of ranks 0 and 1."""
    trace.reset_ids(5)
    tracer = spans.SpanTracer(path)
    done = trace.new_root()
    tracer.record("serve:queue-wait", 0.001, ctx=done.child())
    tracer.record("serve:compute", 0.004, links=[done.link()])
    tracer.record("serve:e2e", 0.01, ctx=done)
    broken = trace.new_root()
    tracer.record("serve:queue-wait", 0.002, ctx=trace.TraceContext(
        broken.trace_id, "c1", "never-written"))
    tracer.record("serve:e2e", 0.02, ctx=broken)
    for rank in (0, 1):
        tracer.bind(rank=rank, world=2)
        for step in range(2):
            sctx = trace.step_context(step, epoch=0, rank=rank)
            tracer.record("loader-wait", 0.003, ctx=sctx.child())
            tracer.record("step", 0.05, ctx=sctx.child())
    torn = trace.new_root()
    tracer.record("serve:queue-wait", 0.001, ctx=torn.child())
    tracer.close()
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "span", "name": "serve:e2e",
                            "trace": torn.trace_id, "span": torn.span_id,
                            "dur_s": 0.01})[:40])
    trace.reset_ids()
    return torn.trace_id


def views(mod, read, paths):
    traces = mod.assemble_logs(paths) if read is None else mod.assemble(
        [r for p in paths for r in read(p)])
    return dict(
        analyze=mod.analyze(traces),
        tails=mod.tail_exemplars(traces, 5),
        each={tid: (mod.waterfall(t), mod.critical_path(t))
              for tid, t in traces.items()})


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    fleet = str(root / "fleet.jsonl")
    fleet_log(fleet)
    damaged = str(root / "damaged.jsonl")
    torn = damaged_log(damaged)
    return fleet, damaged, torn


@pytest.mark.parametrize("which", ["fleet", "damaged", "both"])
def test_analysis_matches_jax(logs, which):
    fleet, damaged, _ = logs
    paths = {"fleet": [fleet], "damaged": [damaged],
             "both": [fleet, damaged]}[which]
    ours = views(traceview, None, paths)
    assert ours == views(jax_traceview, None, paths)
    assert ours == views(jax_traceview, jax_spans.read_spans, paths)


def test_fleet_log_is_whole_and_damage_is_found(logs):
    fleet, damaged, torn = logs
    report = obs.analyze(obs.assemble_logs([fleet]))
    assert report["request_traces"] == 8 == report["closed"] \
        == report["complete"]
    assert report["orphans"] == 0 and report["broken_chains"] == 0
    assert {"fleet:dispatch-wait", "serve:batch-form", "serve:d2h"} <= set(
        report["stage_shares"])
    report = traceview.analyze(traceview.assemble_logs([damaged]))
    assert report["orphan_ids"] == [torn]
    assert report["broken_chains"] == 1 and report["closed"] == 2 \
        and report["complete"] == 1
    assert report["broken_detail"][0]["parent"] == "never-written"
    assert report["step_traces"] == 2 and report["step_ranks"] == [0, 1]


def write_metrics(mod, path):
    reg = mod.MetricsRegistry()
    reg.counter("queue.requeues").inc(2)
    reg.gauge("queue.jobs.done").set(3)
    h = reg.histogram("train.step_ms")
    for v in np.random.default_rng(1).lognormal(3.0, 0.7, 200):
        h.observe(float(v))
    w = mod.MetricsWriter(registry=reg, path=path, period_s=0.0)
    w.maybe_flush(force=True)
    reg.counter("queue.salvages").inc()
    h.observe(1e9)
    w.close()


def test_metric_readers_match_jax(tmp_path):
    files = {}
    for name, mod in (("port", metrics), ("jax", jax_metrics)):
        files[name] = str(tmp_path / ("%s.jsonl" % name))
        write_metrics(mod, files[name])
    for path in files.values():
        snaps = metrics.read_metrics(path)
        assert snaps == jax_metrics.read_metrics(path) and len(snaps) == 2
        latest = metrics.read_latest(path)
        assert latest == jax_metrics.read_latest(path) == snaps[-1]
        assert metrics.snapshot_digest(latest) == \
            jax_metrics.snapshot_digest(latest)
        assert latest["counters"] == {"queue.requeues": 2,
                                      "queue.salvages": 1}
    strip = [{k: v for k, v in s.items() if k not in ("t", "pid")}
             for s in metrics.read_metrics(files["port"])]
    assert strip == [{k: v for k, v in s.items() if k not in ("t", "pid")}
                     for s in metrics.read_metrics(files["jax"])]
    # no sidecar and a torn tail: the last complete line
    path = files["port"]
    with open(path, "ab") as f:
        f.write(b'{"counters": {"queue.req')
    import os
    os.remove(metrics.latest_path(path))
    assert metrics.read_latest(path) == jax_metrics.read_latest(path) \
        == metrics.read_metrics(path)[-1]
    assert metrics.read_metrics(str(tmp_path / "none")) == []
    assert metrics.read_latest(str(tmp_path / "none")) is None
    assert metrics.latest_path("m.jsonl") == \
        jax_metrics.latest_path("m.jsonl")


def test_reset_default_registry():
    old = metrics.default_registry()
    old.counter("x").inc()
    new = metrics.reset_default_registry()
    assert new is metrics.default_registry() and new is not old
    assert new.snapshot()["counters"] == {}
    assert obs.reset_default_registry is metrics.reset_default_registry
