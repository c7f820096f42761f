"""The port's SLO watchdog (`obs/slo.py`) and the serving engine's hooks for
it, against the JAX package's, on the CPU.

The SLO cases of the JAX package's metrics-plane tests, on the port:

* the drift detector is replay-deterministic, re-arms after a clean
  observation, and never divides by zero on a flat series;
* the error-burn and latency-burn rules window their counters and
  histograms and fire on transitions; the same observation sequence
  gives the port's rules and JAX's the same alerts;
* through the engine: the alerts are the same list when one fault
  schedule (`runtime/faults.py`) is replayed over one sequential stream,
  the burn flips the engine to DEGRADED with no request lost,
  `health()["alerts"]` carries them, `degrade()` is undone by healthy
  batches, and arming the metrics export changes no row.
"""

import json
import time

import numpy as np
import pytest

from real_time_helmet_detection_tpu.obs import slo as jax_slo
from real_time_helmet_detection_tpu.obs.metrics import \
    MetricsRegistry as JaxRegistry
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.evaluate import init_weights
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs import slo as port_slo
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.obs.slo import (
    DriftDetector, ErrorBurnRule, LatencyBurnRule, SloWatchdog,
    default_serving_rules, default_tenant_rules, default_train_rules)
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.runtime import (ChaosInjector,
                                                          FaultSchedule)
from real_time_helmet_detection_tpu_torch.serving import (DEGRADED, SERVING,
                                                          ServingEngine)

IMSIZE = 64
SHAPE = (IMSIZE, IMSIZE, 3)


# ---------------------------------------------------------------- the rules


def test_drift_detector_deterministic_and_rearming():
    series = [100.0] * 30 + [180.0] + [100.0] * 10 + [175.0]

    def run():
        wd = SloWatchdog(default_train_rules(z_thresh=4.0, warmup=10))
        for v in series:
            wd.observe("train.step_ms", v)
        return [(a["rule"], round(a["value"], 1)) for a in wd.alerts]

    first, second = run(), run()
    assert first == second
    assert [r for r, _ in first] == ["train-step-drift", "train-step-drift"]
    assert [v for _, v in first] == [180.0, 175.0]


def test_drift_detector_flat_series_never_divides_by_zero():
    d = DriftDetector(warmup=5, z_thresh=4.0)
    for _ in range(50):
        assert d.observe(10.0) is None


def test_error_burn_rule_windows_and_rearms():
    reg = MetricsRegistry()
    rule = ErrorBurnRule("r", err="e", total="t", objective=0.1, burn=2.0)
    wd = SloWatchdog([rule], registry=reg)
    reg.counter("t").inc(10)
    assert wd.check() == []                # 0/10: clean
    reg.counter("e").inc(5)
    reg.counter("t").inc(10)
    assert [a["rule"] for a in wd.check()] == ["r"]  # 5/10 > 0.2
    reg.counter("e").inc(5)
    reg.counter("t").inc(10)
    assert wd.check() == []                # still bad: no re-alert
    reg.counter("t").inc(10)
    assert wd.check() == []                # a clean window re-arms
    reg.counter("e").inc(9)
    reg.counter("t").inc(10)
    assert [a["rule"] for a in wd.check()] == ["r"]


def test_latency_burn_rule_over_histogram_window():
    reg = MetricsRegistry()
    rule = LatencyBurnRule("lat", hist="h", threshold=100.0,
                           objective=0.05, burn=2.0, min_count=8)
    wd = SloWatchdog([rule], registry=reg)
    h = reg.histogram("h")
    for _ in range(10):
        h.observe(10.0)
    assert wd.check() == []
    for _ in range(5):
        h.observe(10.0)
    for _ in range(5):
        h.observe(500.0)  # half the new window over budget
    assert [a["rule"] for a in wd.check()] == ["lat"]


def test_rules_give_jax_alerts_on_the_same_sequence():
    """Seeded counter, histogram and drift sequences through the port's
    stock rule sets and JAX's: the same alerts, field for field."""
    rng = np.random.default_rng(7)
    steps = []
    for _ in range(60):
        steps.append(dict(total=int(rng.integers(1, 20)),
                          err=int(rng.integers(0, 4)),
                          lat=list(rng.lognormal(3.0, 1.2, 6)),
                          step=float(rng.normal(100.0, 3.0))
                          + (80.0 if rng.random() < 0.05 else 0.0)))

    def run(slo, registry):
        reg = registry()
        rules = (slo.default_serving_rules(deadline_ms=60.0)
                 + slo.default_tenant_rules("a", deadline_ms=60.0)
                 + slo.default_train_rules(warmup=10))
        wd = slo.SloWatchdog(rules, registry=reg)
        for st in steps:
            reg.counter("serve.batches_total").inc(st["total"])
            reg.counter("serve.failed_batches").inc(st["err"])
            reg.counter("serve.tenant.a.submitted").inc(st["total"])
            reg.counter("serve.tenant.a.failed").inc(st["err"])
            for v in st["lat"]:
                reg.histogram("serve.e2e_ms").observe(v)
                reg.histogram("serve.tenant.a.e2e_ms").observe(v)
            wd.observe("train.step_ms", st["step"])
            wd.check()
        return wd.alerts

    ours = run(port_slo, MetricsRegistry)
    theirs = run(jax_slo, JaxRegistry)
    assert ours == theirs
    assert {a["kind"] for a in ours} == {"drift", "error-burn",
                                         "latency-burn"}


def test_stock_rule_sets_match_jax():
    for ours, theirs in (
            (default_serving_rules(deadline_ms=50.0),
             jax_slo.default_serving_rules(deadline_ms=50.0)),
            (default_serving_rules(), jax_slo.default_serving_rules()),
            (default_tenant_rules("t", deadline_ms=9.0),
             jax_slo.default_tenant_rules("t", deadline_ms=9.0)),
            (default_train_rules(), jax_slo.default_train_rules())):
        assert [(type(r).__name__, vars(r).keys()) for r in ours] \
            == [(type(r).__name__, vars(r).keys()) for r in theirs]
        for a, b in zip(ours, theirs):
            keep = {k: v for k, v in vars(a).items() if k != "detector"}
            assert keep == {k: v for k, v in vars(b).items()
                            if k != "detector"}


# ------------------------------------------------------- through the engine


@pytest.fixture(scope="module")
def parts():
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=8, num_cls=2,
                 topk=16, imsize=IMSIZE)
    model = init_weights(build_model(cfg), 0)
    predict = make_predict_fn(model, cfg, normalize="imagenet", device="cpu")
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 256, SHAPE, dtype=np.uint8) for _ in range(8)]
    return predict, pool


def _stream(predict, pool, monkeypatch, export=None):
    if export is None:
        monkeypatch.delenv("OBS_METRICS", raising=False)
    else:
        monkeypatch.setenv("OBS_METRICS", export)
    eng = ServingEngine(predict, None, SHAPE, np.uint8, buckets=(1, 2),
                        max_wait_ms=0.0, depth=1, queue_capacity=16,
                        metrics=MetricsRegistry())
    rows = [eng.submit(pool[i % len(pool)]).result(timeout=30)
            for i in range(6)]
    eng.close()
    blob = b"".join(np.asarray(r.boxes).tobytes()
                    + np.asarray(r.scores).tobytes() for r in rows)
    return blob, eng.stats()


def test_metrics_export_changes_no_row(parts, tmp_path, monkeypatch):
    predict, pool = parts
    export = tmp_path / "metrics.jsonl"
    blob_on, st_on = _stream(predict, pool, monkeypatch, str(export))
    blob_off, st_off = _stream(predict, pool, monkeypatch)
    assert blob_on == blob_off
    assert st_on["completed"] == st_off["completed"] == 6
    snaps = [json.loads(line) for line in export.read_text().splitlines()]
    assert snaps and snaps[-1]["counters"]["serve.completed"] == 6


def test_slo_alerts_deterministic_under_fault_replay(parts):
    predict, pool = parts
    spec = "serve:dispatch=device-loss@2,serve:dispatch=device-loss@5"

    def run():
        reg = MetricsRegistry()
        wd = SloWatchdog(default_serving_rules(objective=0.05, burn=2.0),
                         registry=reg)
        inj = ChaosInjector(FaultSchedule.parse(spec))
        eng = ServingEngine(predict, None, SHAPE, np.uint8, buckets=(1, 2),
                            max_wait_ms=0.0, depth=1, queue_capacity=16,
                            max_retries=3, metrics=reg, watchdog=wd,
                            injector=inj)
        states = []
        for i in range(6):
            eng.submit(pool[i % len(pool)]).result(timeout=30)
            states.append(eng.state)
        health = eng.health()
        eng.close()
        return [a["rule"] for a in wd.alerts], states, eng.stats(), health

    alerts_a, states_a, st_a, health = run()
    alerts_b, states_b, st_b, _ = run()
    assert alerts_a == alerts_b
    assert "serve-error-burn" in alerts_a
    assert DEGRADED in states_a
    assert st_a["failed"] == st_b["failed"] == 0
    assert st_a["retried"] == st_b["retried"] >= 2
    assert [a["rule"] for a in health["alerts"]] == alerts_a


def test_engine_without_watchdog_has_no_alerts(parts):
    predict, pool = parts
    with ServingEngine(predict, None, SHAPE, np.uint8, buckets=(1,),
                       max_wait_ms=0.0, metrics=MetricsRegistry()) as eng:
        eng.submit(pool[0]).result(timeout=30)
        assert "alerts" not in eng.health()
        assert "alerts" not in eng.health(include_metrics=False)


def test_engine_degrade_api_recovers_after_healthy_batches(parts):
    predict, pool = parts
    eng = ServingEngine(predict, None, SHAPE, np.uint8, buckets=(1,),
                        max_wait_ms=0.0, depth=1, queue_capacity=8,
                        recover_after=2, metrics=MetricsRegistry())
    try:
        eng.submit(pool[0]).result(timeout=30)
        assert eng.state == SERVING
        eng.degrade("test alert")
        assert eng.state == DEGRADED
        assert "degraded: test alert" in eng.health()["last_error"]
        for i in range(3):
            eng.submit(pool[i % len(pool)]).result(timeout=30)
        time.sleep(0.05)  # recovery bookkeeping rides the fetcher thread
        assert eng.state == SERVING
    finally:
        eng.close()
