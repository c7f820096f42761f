"""The port's serving engine on the CPU, mirroring tests/test_serving.py
test for test on the same tiny fixture (hourglass_inch 8, imsize 64,
topk 16, conf_th 0, buckets (1, 2, 4)), plus the same request stream
through the JAX engine and the port's on the same weights.

Rows depend on the batch size on the CPU (its convolutions pick their
blocking by batch), never on the neighbours in the batch or the
position. So the oracle of a row served by bucket b is the port's
one-shot predict of that image in a batch of b (zeros around it):
`ServeFuture.bucket` names b, and every engine row must equal it bit for
bit. The JAX engine's rows and the port's match both ways under
`assert_detections_match` (class, IoU >= 0.99, |score diff| <= 1e-3).
"""

import time

import jax
import numpy as np
import pytest

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu.serving import \
    ServingEngine as JaxServingEngine
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch import predict as predict_mod
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.obs.spans import (maybe_tracer,
                                                            read_spans)
from real_time_helmet_detection_tpu_torch.runtime import (ChaosInjector,
                                                          FaultEvent,
                                                          FaultSchedule)
from real_time_helmet_detection_tpu_torch.serving import (
    DEFAULT_BUCKETS, DEGRADED, SERVING, EngineClosedError, FetchHungError,
    ServingEngine, SheddedError, resolve_buckets)
from test_torch_predict import assert_detections_match, bn_scaled
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

IMSIZE = 64
BUCKETS = (1, 2, 4)
ARCH = dict(num_stack=1, hourglass_inch=8, num_cls=2, topk=16,
            conf_th=0.0, nms_th=0.5, imsize=IMSIZE)
SHAPE = (IMSIZE, IMSIZE, 3)


def port_predict(variables):
    """A port model of its own filled from the flax tree, and its
    Predict on the CPU."""
    cfg = Config(device="cpu", **ARCH)
    model = convert.load_into(build_model(cfg), variables)
    return predict_mod.make_predict_fn(model, cfg, normalize="imagenet",
                                       device="cpu")


def oracle_rows(predict, pool, buckets=BUCKETS):
    """{(b, i): row of image i predicted in a batch of b}."""
    out = {}
    for b in buckets:
        for i, img in enumerate(pool):
            batch = np.zeros((b,) + SHAPE, np.uint8)
            batch[0] = img
            out[(b, i)] = tuple(t[0].numpy() for t in predict(batch))
    return out


@pytest.fixture(scope="module")
def parts():
    jcfg = JaxConfig(**ARCH)
    params, stats = init_variables(jax_build(jcfg), jax.random.key(0),
                                   IMSIZE)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 0)
    predict = port_predict(variables)
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 256, SHAPE, dtype=np.uint8) for _ in range(10)]
    return variables, predict, pool, oracle_rows(predict, pool)


def make_engine(predict, **kw):
    kw.setdefault("metrics", MetricsRegistry())
    return ServingEngine(predict, None, SHAPE, np.uint8, **kw)


@pytest.fixture(scope="module")
def engine(parts):
    _, predict, _, _ = parts
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=2.0, depth=2,
                      queue_capacity=64)
    yield eng
    eng.close()


def _rows_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _matches_oracle(fut, i, oracle) -> bool:
    return _rows_equal(fut.result(timeout=60), oracle[(fut.bucket, i)])


def test_any_stream_bit_identical_to_one_shot(parts, engine):
    """Any request stream (burst sizes spanning the buckets, pacing
    jitter) gives each request the row of its one-shot predict at the
    batch size that served it, bit for bit."""
    _, _, pool, oracle = parts
    rng = np.random.default_rng(17)
    for stream in range(3):
        futs = []
        for _ in range(6):
            k = int(rng.integers(1, 7))
            for i in rng.integers(0, len(pool), k):
                futs.append((int(i), engine.submit(pool[int(i)])))
            if rng.random() < 0.5:
                time.sleep(float(rng.uniform(0, 0.004)))
        for i, fut in futs:
            assert _matches_oracle(fut, i, oracle), \
                "stream %d: request for image %d diverged" % (stream, i)
            assert fut.bucket in BUCKETS


def test_partial_batch_takes_smallest_bucket(parts):
    _, predict, pool, oracle = parts
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=50.0, depth=1,
                      queue_capacity=16, start=False)
    futs = [eng.submit(pool[i]) for i in range(3)]
    eng.start()
    for f in futs:
        f.result(timeout=60)
    st = eng.stats()
    eng.close()
    # 3 requests coalesce into ONE bucket-4 batch: 1 padded slot
    assert st["batches"] == 1
    assert st["padded_slots"] == 1
    assert all(f.bucket == 4 for f in futs)
    assert all(_matches_oracle(f, i, oracle) for i, f in enumerate(futs))


def test_no_bucket_rebuild_after_construction(parts, monkeypatch):
    """One runner per bucket, built at construction (on CUDA the graph
    capture); a stream spanning every bucket size builds none more."""
    _, predict, pool, oracle = parts
    calls = []

    class Counting(predict_mod.BucketRunner):
        def __init__(self, *args, **kw):
            calls.append(args[1])
            super().__init__(*args, **kw)
    monkeypatch.setattr(predict_mod, "BucketRunner", Counting)
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=2.0)
    assert sorted(calls) == list(BUCKETS)
    for n in (1, 2, 3, 4, 1):
        futs = [eng.submit(pool[i]) for i in range(n)]
        assert all(_matches_oracle(f, i, oracle)
                   for i, f in enumerate(futs))
    st = eng.stats()
    eng.close()
    assert sorted(calls) == list(BUCKETS)
    assert st["bucket_builds"] == len(BUCKETS)


def test_queue_full_sheds_immediately(parts):
    _, predict, pool, _ = parts
    eng = make_engine(predict, buckets=(1, 2), max_wait_ms=0.0,
                      queue_capacity=2, start=False)
    futs = [eng.submit(pool[0], block=False) for _ in range(5)]
    shed = [f for f in futs if f.done()]
    assert len(shed) == 3
    for f in shed:
        with pytest.raises(SheddedError):
            f.result()
    eng.start()
    served = [f for f in futs if f not in shed]
    assert all(f.result(timeout=60) is not None for f in served)
    st = eng.stats()
    eng.close()
    assert st["shed_queue_full"] == 3
    assert st["completed"] == 2


def test_deadline_shed_before_dispatch(parts):
    _, predict, pool, _ = parts
    eng = make_engine(predict, buckets=(1, 2), max_wait_ms=0.0,
                      queue_capacity=8, start=False)
    late = eng.submit(pool[0], deadline_s=0.001)
    ok = eng.submit(pool[1])  # no deadline: must still be served
    time.sleep(0.05)
    eng.start()
    with pytest.raises(SheddedError):
        late.result(timeout=60)
    assert ok.result(timeout=60) is not None
    st = eng.stats()
    eng.close()
    assert st["shed_deadline"] == 1 and st["completed"] == 1


def test_close_fails_pending_and_rejects_new(parts):
    _, predict, pool, _ = parts
    eng = make_engine(predict, buckets=(1,), max_wait_ms=0.0,
                      queue_capacity=4, start=False)
    fut = eng.submit(pool[0])
    eng.close()
    with pytest.raises(EngineClosedError):
        fut.result(timeout=10)
    with pytest.raises(EngineClosedError):
        eng.submit(pool[0])


def test_submit_validates_shape_and_dtype(parts, engine):
    with pytest.raises(ValueError):
        engine.submit(np.zeros(SHAPE, np.float32))
    with pytest.raises(ValueError):
        engine.submit(np.zeros((32, 32, 3), np.uint8))


def test_spans_cover_the_taxonomy(parts, tmp_path):
    """compile spans per bucket at construction, then queue-wait /
    batch-form / h2d / compute / d2h per batch and e2e per request."""
    _, predict, pool, _ = parts
    path = str(tmp_path / "serve_spans.jsonl")
    tracer = maybe_tracer(path)
    eng = make_engine(predict, buckets=(1, 2), max_wait_ms=1.0,
                      queue_capacity=8, tracer=tracer)
    eng.predict_many(pool[:3])
    eng.close()
    tracer.close()
    recs = read_spans(path)
    names = {r.get("name") for r in recs}
    assert {"serve:compile", "serve:queue-wait", "serve:batch-form",
            "serve:h2d", "serve:compute", "serve:d2h",
            "serve:e2e"} <= names
    assert sum(1 for r in recs if r.get("name") == "serve:compile") == 2
    assert sum(1 for r in recs if r.get("name") == "serve:e2e") == 3


def test_resolve_buckets_contract():
    assert resolve_buckets(Config()) == tuple(DEFAULT_BUCKETS)
    assert resolve_buckets(Config(serve_buckets=[8, 2, 2])) == (2, 8)
    with pytest.raises(ValueError):
        Config(serve_buckets=[0, 2])
    with pytest.raises(ValueError):
        Config(serve_buckets=[])


def test_injected_dispatch_fault_retries_bit_identical(parts):
    """An injected device loss at dispatch requeues the batch; the retry
    goes through the same bucket runner, rows stay bit-identical and no
    acknowledged request is lost."""
    _, predict, pool, oracle = parts
    inj = ChaosInjector(FaultSchedule.parse("serve:dispatch=device-loss@2"))
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=1.0, depth=2,
                      queue_capacity=32, max_retries=2, injector=inj)
    futs = [(i, eng.submit(pool[i])) for i in range(6)]
    ok = [_matches_oracle(f, i, oracle) for i, f in futs]
    st = eng.stats()
    health = eng.health()
    eng.close()
    assert all(ok)
    assert len(inj.fired) == 1 and inj.fired[0].kind == "device-loss"
    assert st["failed"] == 0 and st["completed"] == 6
    assert st["retried"] >= 1 and st["requeued_batches"] == 1
    assert health["stats"]["failed_batches"] == 1


def test_hung_fetch_watchdog_requeues(parts):
    """An injected hung fetch (sleeping past the watchdog) is detected,
    the batch requeued, and the retried requests complete
    bit-identically."""
    _, predict, pool, oracle = parts
    inj = ChaosInjector(FaultSchedule([
        FaultEvent("serve:fetch", "hung-fetch", 1, {"hang_s": 1.0})]))
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=1.0, depth=2,
                      queue_capacity=32, max_retries=2,
                      hang_timeout_s=0.15, injector=inj)
    futs = [(i, eng.submit(pool[i])) for i in range(3)]
    ok = [_matches_oracle(f, i, oracle) for i, f in futs]
    st = eng.stats()
    last_error = eng.health()["last_error"]
    eng.close()
    assert all(ok)
    assert st["hung_batches"] == 1
    assert st["failed"] == 0 and st["completed"] == 3
    assert last_error.startswith(FetchHungError.__name__)


def test_retry_budget_exhaustion_surfaces_error(parts):
    """Past its budget the error surfaces on the future and the loss is
    counted."""
    _, predict, pool, _ = parts
    spec = ",".join("serve:dispatch=device-loss@%d" % n for n in (1, 2, 3))
    inj = ChaosInjector(FaultSchedule.parse(spec))
    eng = make_engine(predict, buckets=(1,), max_wait_ms=0.0, depth=1,
                      queue_capacity=8, max_retries=2, injector=inj)
    fut = eng.submit(pool[0])
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        fut.result(timeout=60)
    st = eng.stats()
    eng.close()
    assert st["failed"] == 1 and st["retried"] == 2


def test_state_machine_degraded_and_recovery(parts):
    """SERVING -> DEGRADED on a batch failure, back after
    `recover_after` healthy batches in a row; health() snapshots it."""
    _, predict, pool, _ = parts
    inj = ChaosInjector(FaultSchedule.parse("serve:dispatch=device-loss@1"))
    eng = make_engine(predict, buckets=(1,), max_wait_ms=0.0, depth=1,
                      queue_capacity=8, max_retries=1, recover_after=2,
                      injector=inj)
    assert eng.state == SERVING
    eng.submit(pool[0]).result(timeout=60)  # fault -> retry succeeds
    assert eng.state == DEGRADED  # one healthy batch < recover_after
    eng.submit(pool[1]).result(timeout=60)
    assert eng.drain(10.0)
    assert eng.state == SERVING
    h = eng.health()
    eng.close()
    assert h["state"] == SERVING and h["consecutive_failures"] == 0
    assert h["queued"] == 0 and h["inflight_batches"] == 0
    assert h["stats"]["failed_batches"] == 1
    assert eng.health()["state"] == "closed"


def test_hot_reload_swaps_weights_without_dropping(parts, monkeypatch):
    """Requests before the swap match the old weights' oracle, requests
    after match the new weights'; no runner is rebuilt, no request is
    dropped, and every parameter and buffer keeps its storage."""
    variables, _, pool, oracle = parts
    predict = port_predict(variables)  # reload writes into its model
    flat = convert.flatten_tree(variables)
    key = next(k for k in sorted(flat) if k.endswith("kernel"))
    new_vars = convert.unflatten_tree(
        {k: (v + 0.25 if k == key else v) for k, v in flat.items()})
    new_oracle = oracle_rows(port_predict(new_vars), pool[:4])
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=1.0, depth=2,
                      queue_capacity=32)
    model = predict.model
    ptrs = [t.data_ptr() for t in list(model.parameters())
            + list(model.buffers())]
    before = [(i, eng.submit(pool[i])) for i in range(4)]
    builds = []
    monkeypatch.setattr(predict_mod, "BucketRunner",
                        lambda *a, **k: builds.append(a))
    eng.reload(new_vars, timeout_s=30.0)
    after = [(i, eng.submit(pool[i])) for i in range(4)]
    ok_before = [_matches_oracle(f, i, oracle) for i, f in before]
    ok_after = [_matches_oracle(f, i, new_oracle) for i, f in after]
    rows_b = [f.result() for _, f in before]
    rows_a = [f.result() for _, f in after]
    st = eng.stats()
    eng.close()
    assert builds == []
    assert all(ok_before) and all(ok_after)
    assert any(not _rows_equal(a, b) for a, b in zip(rows_b, rows_a))
    assert ptrs == [t.data_ptr() for t in list(model.parameters())
                    + list(model.buffers())]
    assert st["reloads"] == 1 and st["failed"] == 0
    assert st["completed"] == 8


def test_recovery_spans_land_in_flight_recorder(parts, tmp_path):
    """fault:* injections and recover:* evidence land in the span log."""
    _, predict, pool, _ = parts
    path = str(tmp_path / "chaos_spans.jsonl")
    tracer = maybe_tracer(path)
    inj = ChaosInjector(FaultSchedule.parse(
        "serve:dispatch=device-loss@1,serve:dispatch=device-loss@2"),
        tracer=tracer)
    eng = make_engine(predict, buckets=(1,), max_wait_ms=0.0, depth=1,
                      queue_capacity=8, max_retries=1, tracer=tracer,
                      injector=inj)
    with pytest.raises(RuntimeError):
        eng.submit(pool[0]).result(timeout=60)
    eng.close()
    tracer.close()
    recs = read_spans(path)
    names = [r.get("name") for r in recs]
    assert names.count("fault:device-loss") == 2
    assert names.count("recover:requeue") == 2
    assert "recover:retry-exhausted" in names
    states = [r["meta"] for r in recs if r.get("name") == "serve:state"]
    assert {"from": "serving", "to": "degraded"} in states


def test_results_in_submission_order_across_batches(parts):
    """Futures complete in dispatch order across partial batches (the
    `evaluate` consumes its pending deque head first)."""
    _, predict, pool, oracle = parts
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=0.5, depth=2,
                      queue_capacity=64)
    futs = [eng.submit(pool[i % len(pool)]) for i in range(11)]
    done_at = []
    for i, f in enumerate(futs):
        assert _matches_oracle(f, i % len(pool), oracle)
        done_at.append(f.t_done)
    eng.close()
    assert done_at == sorted(done_at)


def test_engine_rows_match_jax_engine(parts):
    """One request stream through the JAX engine and through the port's
    on the same weights: every detection >= 0.1 of one has its match in
    the other, both ways."""
    variables, predict, pool, _ = parts
    jcfg = JaxConfig(**ARCH)
    jpredict = jax_make_predict_fn(jax_build(jcfg), jcfg,
                                   normalize="imagenet")
    order = [int(i) for i in np.random.default_rng(5).integers(0, 10, 14)]
    jeng = JaxServingEngine(jpredict, variables, SHAPE, np.uint8,
                            buckets=BUCKETS, max_wait_ms=2.0, depth=2)
    jrows = [f.result(timeout=120) for f in
             [jeng.submit(pool[i]) for i in order]]
    jeng.close()
    eng = make_engine(predict, buckets=BUCKETS, max_wait_ms=2.0, depth=2)
    rows = [f.result(timeout=60) for f in
            [eng.submit(pool[i]) for i in order]]
    eng.close()

    def valid(rs):
        return [(r.boxes[r.valid], r.classes[r.valid], r.scores[r.valid])
                for r in rs]
    n = assert_detections_match(valid(rows), valid(jrows)) \
        + assert_detections_match(valid(jrows), valid(rows))
    assert n > 0


def test_kill_fails_queued_requests_and_stops(parts):
    """kill(): every request still queued fails with EngineClosedError at
    once (the count is returned), new submits are refused, and a second
    kill is a no-op."""
    _, predict, pool, _ = parts
    eng = make_engine(predict, buckets=(1,), max_wait_ms=0.0,
                      queue_capacity=8, start=False)
    futs = [eng.submit(pool[i]) for i in range(3)]
    assert eng.kill("test") == 3
    for f in futs:
        with pytest.raises(EngineClosedError, match="killed: test"):
            f.result(timeout=10)
    with pytest.raises(EngineClosedError):
        eng.submit(pool[0])
    assert eng.kill() == 0 and eng.state == "closed"
