"""The port's copies of the JAX package's fault injection, trace
contexts, span tracer and metrics plane against the JAX modules, on the
same inputs (CPU, stdlib only on both sides).

* `FaultSchedule.parse`/`spec`/`seeded(seed)` give the same schedules for
  several seeds, and a `ChaosInjector` fires the same sequence (kinds,
  returned events, raised messages);
* histograms give the same snapshots, quantiles and digests on the same
  seeded samples;
* span records carry the same fields, and trace ids are equal after
  `reset_ids(seed)`.
"""

import numpy as np
import pytest

from real_time_helmet_detection_tpu.obs import metrics as jax_metrics
from real_time_helmet_detection_tpu.obs import spans as jax_spans
from real_time_helmet_detection_tpu.obs import trace as jax_trace
from real_time_helmet_detection_tpu.runtime import faults as jax_faults
from real_time_helmet_detection_tpu_torch.obs import metrics, spans, trace
from real_time_helmet_detection_tpu_torch.runtime import faults

TIMES = ("t", "t0", "dur_s", "pid")


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_seeded_schedules_equal(seed):
    for n in (1, 4, 9):
        ours = faults.FaultSchedule.seeded(seed, n=n)
        theirs = jax_faults.FaultSchedule.seeded(seed, n=n)
        assert ours.spec() == theirs.spec() and len(ours) == len(theirs)
        spec = "seed=%d,n=%d" % (seed, n)
        assert faults.FaultSchedule.parse(spec).spec() \
            == jax_faults.FaultSchedule.parse(spec).spec()
        assert faults.FaultSchedule.parse(ours.spec()).spec() == ours.spec()


def test_parse_spec_and_errors_equal():
    spec = ("serve:fetch=hung-fetch@3,serve:dispatch=device-loss@2,"
            "fleet:replica=worker-death@1,serve:dispatch=slow-batch@5")
    assert faults.FaultSchedule.parse(spec).spec() \
        == jax_faults.FaultSchedule.parse(spec).spec()
    assert faults.ALL_SITES == jax_faults.ALL_SITES
    assert faults.SERVE_SITES == jax_faults.SERVE_SITES
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS
    for bad in ("serve:dispatch", "serve:dispatch=boom@1",
                "serve:dispatch=device-loss@0", "seed=1,serve:x=nan-batch@2",
                "bogus=3"):
        with pytest.raises(ValueError) as ours:
            faults.FaultSchedule.parse(bad)
        with pytest.raises(ValueError) as theirs:
            jax_faults.FaultSchedule.parse(bad)
        assert str(ours.value) == str(theirs.value)
    assert faults.maybe_injector("") is None
    assert jax_faults.maybe_injector("") is None


def _fire_all(mod, arrivals):
    """Fire the arrivals through an injector of `mod`; returns what each
    arrival did and the injector's record."""
    events = [mod.FaultEvent("serve:dispatch", "device-loss", 2),
              mod.FaultEvent("serve:fetch", "hung-fetch", 1,
                             {"hang_s": 0.0}),
              mod.FaultEvent("serve:fetch", "slow-batch", 3,
                             {"slow_s": 0.0}),
              mod.FaultEvent("serve:dispatch", "nan-batch", 4)]
    inj = mod.ChaosInjector(mod.FaultSchedule(events))
    out = []
    for site in arrivals:
        try:
            ev = inj.fire(site, b=4)
            out.append(("ok", None if ev is None else ev.key))
        except RuntimeError as e:
            out.append((type(e).__name__, str(e)))
    return out, [e.key for e in inj.fired], inj.summary(), inj.pending()


def test_injector_firing_sequence_equal():
    arrivals = ["serve:dispatch", "serve:fetch", "serve:dispatch",
                "serve:fetch", "serve:fetch", "serve:dispatch",
                "serve:dispatch", "serve:fetch"]
    ours = _fire_all(faults, arrivals)
    assert ours == _fire_all(jax_faults, arrivals)
    assert ours[1] == ["serve:fetch=hung-fetch@1",
                       "serve:dispatch=device-loss@2",
                       "serve:fetch=slow-batch@3",
                       "serve:dispatch=nan-batch@4"]


@pytest.mark.parametrize("seed", [0, 3])
def test_histograms_equal(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(0.0, 2.0, 500), [0.0, -1.0,
                                                            1e-5, 3e7]])
    ours, theirs = metrics.Histogram("h"), jax_metrics.Histogram("h")
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    assert ours.snapshot() == theirs.snapshot()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.digest() == theirs.digest() and ours.mean == theirs.mean
    assert metrics.Histogram("e").quantile(0.5) is None


def test_registry_digest_equal():
    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("serve.completed").inc(5)
        reg.counter("serve.completed").inc()
        reg.gauge("serve.queue_depth").set(3)
        reg.gauge("other.x").set(1)
        for v in (0.5, 1.5, 12.0):
            reg.histogram("serve.e2e_ms").observe(v)
        return reg
    ours, theirs = fill(metrics), fill(jax_metrics)
    assert ours.digest(prefix="serve.") == theirs.digest(prefix="serve.")
    strip = lambda s: {k: v for k, v in s.items() if k not in TIMES}
    assert strip(ours.snapshot()) == strip(theirs.snapshot())


def _write_spans(mod, trace_mod, path):
    trace_mod.reset_ids(11)
    tracer = mod.maybe_tracer(str(path))
    root = trace_mod.new_root()
    child = root.child()
    with tracer.span("serve:compile", b=4):
        pass
    with tracer.span("serve:h2d", b=2, links=trace_mod.links_of(
            [root, None, child])):
        pass
    tracer.record("serve:e2e", 0.25, ctx=root, b=1)
    tracer.event("serve:state", **{"from": "serving", "to": "degraded"})
    tracer.event("serve:shed", ctx=child, reason="deadline")
    try:
        with tracer.span("serve:d2h", ctx=child):
            raise KeyError("x")
    except KeyError:
        pass
    tracer.close()
    return [{k: v for k, v in r.items() if k not in TIMES}
            for r in mod.read_spans(str(path))]


def test_span_records_carry_the_same_fields(tmp_path):
    ours = _write_spans(spans, trace, tmp_path / "port.jsonl")
    theirs = _write_spans(jax_spans, jax_trace, tmp_path / "jax.jsonl")
    assert ours == theirs and len(ours) == 7
    assert spans.SPAN_SCHEMA == jax_spans.SPAN_SCHEMA
    # a disabled tracer still times and writes nothing
    off = spans.maybe_tracer(None, env={})
    with off.span("serve:compile") as sp:
        pass
    assert not off.enabled and sp.dur_s >= 0.0


@pytest.mark.parametrize("seed", [None, 0, 5])
def test_trace_ids_equal_after_reset(seed):
    def mint(mod):
        mod.reset_ids(seed)
        root = mod.new_root()
        kids = [root.child() for _ in range(3)]
        grand = kids[1].child()
        out = [c.to_fields() for c in [root] + kids + [grand]]
        out.append(mod.links_of([root, None, grand]))
        out.append(mod.TraceContext.from_fields(grand.to_fields())
                   .to_fields())
        return out
    assert mint(trace) == mint(jax_trace)
    trace.reset_ids()
    jax_trace.reset_ids()
