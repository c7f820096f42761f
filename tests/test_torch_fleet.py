"""The port's FleetRouter on the CPU, mirroring tests/test_fleet.py test
for test (least-loaded routing, tenant budgets and SLO penalty boxes,
canary promote and rollback, replica death and respawn, the cascade's
edge-first routing, escalation faults), then the same request sequences
and fault schedules through JAX's router over JAX engines and the port's
over port engines.

Fixture: hourglass_inch 16, imsize 64, topk 16, conf_th 0, buckets
(1, 2), weights from JAX's init with BN state drawn by `bn_scaled`,
loaded through `convert`. On the CPU a row depends on the batch size
that served it (not on its neighbours), so a port row is held bit for
bit to the port's one-shot predict of that image at `FleetFuture.bucket`
(`runs.oracle_rows`); JAX rows and port rows match both ways under
`assert_detections_match` (class, IoU >= 0.99, |score diff| <= 1e-3).
Every test runs under a hard SIGALRM: a routing or recovery path that
hangs is a failed path.
"""

import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.obs.metrics import \
    MetricsRegistry as JaxMetricsRegistry
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu.runtime import (
    ChaosInjector as JaxChaosInjector, FaultSchedule as JaxFaultSchedule)
from real_time_helmet_detection_tpu.serving import \
    FleetRouter as JaxFleetRouter
from real_time_helmet_detection_tpu.serving import \
    ServingEngine as JaxServingEngine
from real_time_helmet_detection_tpu.serving import \
    SheddedError as JaxSheddedError
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.runtime import (ChaosInjector,
                                                          FaultSchedule)
from real_time_helmet_detection_tpu_torch.runtime.faults import FLEET_SITES
from real_time_helmet_detection_tpu_torch.serving import (FleetRouter,
                                                          ServingEngine,
                                                          SheddedError,
                                                          TenantSheddedError)
from real_time_helmet_detection_tpu_torch.serving.runs import oracle_rows
from test_torch_predict import assert_detections_match, bn_scaled


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file's engines run: their threads
    and the oracle's would otherwise each bring a full pool, and under the
    suite's parallel workers the oversubscribed pools stall (the rows do
    not depend on it: oracle and engine run under the same setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

TIMEOUT_S = 300
IMSIZE = 64
SHAPE = (IMSIZE, IMSIZE, 3)
BUCKETS = (1, 2)
ARCH = dict(num_stack=1, hourglass_inch=16, num_cls=2, topk=16,
            conf_th=0.0, nms_th=0.5, imsize=IMSIZE)


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _fire(signum, frame):
        raise RuntimeError("fleet test exceeded the %ds hard timeout — a "
                           "routing/recovery path hung" % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def port_predict(variables, cascade=False):
    """A predict with a model of its own (a replica's reload writes into
    its model's storages)."""
    cfg = Config(device="cpu", **ARCH)
    model = convert.load_into(build_model(cfg), variables)
    return make_predict_fn(model, cfg, normalize="imagenet", device="cpu",
                           cascade_summary=cascade)


def perturbed(variables):
    """A distinct checkpoint: the first kernel shifted (ref
    tests/test_fleet.py `parts`)."""
    leaves, treedef = jax.tree.flatten(variables)
    leaves = [np.asarray(x) for x in leaves]
    leaves[0] = leaves[0] + 0.25
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def parts():
    jcfg = JaxConfig(**ARCH)
    params, stats = init_variables(jax_build(jcfg), jax.random.key(0),
                                   IMSIZE)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 0)
    new_vars = perturbed(variables)
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 256, SHAPE, dtype=np.uint8) for _ in range(8)]
    oracle = oracle_rows(port_predict(variables), pool, BUCKETS)
    new_oracle = oracle_rows(port_predict(new_vars), pool, BUCKETS)
    return variables, new_vars, pool, oracle, new_oracle


def factory_of(variables, injector_for=None, predicts=None, **kw):
    """A replica factory: each replica (and respawn) its own predict of
    `variables` (or `predicts(rid)`), its own registry, an optional
    chaos injector by rid."""
    defaults = dict(buckets=BUCKETS, max_wait_ms=1.0, depth=2,
                    queue_capacity=64, max_retries=4)
    defaults.update(kw)

    def factory(rid, start=True):
        inj = None
        if injector_for and rid in injector_for:
            inj = ChaosInjector(FaultSchedule.parse(injector_for[rid]))
        predict = (predicts(rid) if predicts is not None
                   else port_predict(variables))
        return ServingEngine(predict, None, SHAPE, np.uint8,
                             metrics=MetricsRegistry(), injector=inj,
                             start=start, **defaults)

    return factory


def row_is(fut, i, oracle, timeout=60) -> bool:
    row = fut.result(timeout=timeout)
    want = oracle[(fut.bucket, i)]
    return all(np.array_equal(x, y) for x, y in zip(tuple(row)[:4], want))


def _wait_canary_armed(router, rollout_thread, timeout_s=120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and rollout_thread.is_alive():
        if router.health()["canary"] is not None:
            return
        time.sleep(0.005)
    if rollout_thread.is_alive():
        raise AssertionError("canary never armed within %.0fs" % timeout_s)


def _wait_outstanding_zero(router, timeout_s=60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(t["outstanding"] == 0
               for t in router.health()["tenants"].values()):
            return
        time.sleep(0.01)
    raise AssertionError("fleet never drained: %r" % (router.health(),))


class _CountingLock:
    def __init__(self, lock):
        self._lock = lock
        self.acquires = 0

    def __enter__(self):
        self.acquires += 1
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


# ---------------------------------------------------------------------------
# the engine surfaces the router reads


def test_health_digest_is_one_lock_acquisition(parts):
    """health(include_metrics=False) — what every dispatch scores — is
    one `_lock` acquisition, and carries every field the router reads."""
    eng = factory_of(parts[0])(0, start=False)
    counting = _CountingLock(eng._lock)
    eng._lock = counting
    h = eng.health(include_metrics=False)
    assert counting.acquires == 1
    assert h["state"] == "serving" and "metrics" not in h
    assert {"queued", "retry_queued", "inflight_batches"} <= set(h)
    counting.acquires = 0
    h = eng.health()
    assert counting.acquires == 1 and "metrics" in h
    eng._lock = counting._lock
    eng.close()


def test_health_consistent_under_reload_storm(parts):
    variables, new_vars, pool = parts[:3]
    eng = factory_of(variables, max_wait_ms=0.5)(0)
    stop = threading.Event()
    snaps = []

    def prober():  # yields the GIL between snapshots
        while not stop.is_set():
            snaps.append(eng.health(include_metrics=False))
            time.sleep(0.0005)

    th = threading.Thread(target=prober, daemon=True)
    th.start()
    for i in range(6):
        eng.predict_many(pool[:2])
        eng.reload(new_vars if i % 2 == 0 else variables, timeout_s=30)
    stop.set()
    th.join(timeout=10)
    eng.close()
    reloads = [s["stats"]["reloads"] for s in snaps]
    assert snaps and all(s["state"] in ("serving", "degraded", "draining",
                                        "closed") for s in snaps)
    assert reloads == sorted(reloads)


def test_done_callback_fires_once_inline_when_done(parts):
    """ServeFuture.add_done_callback: the one callback runs once, on
    completion, or inline when the future is already done; a raising
    callback does not kill the fetcher."""
    variables, _, pool = parts[:3]
    eng = factory_of(variables)(0)
    seen = []
    f = eng.submit(pool[0])
    f.add_done_callback(lambda fut: (seen.append(fut.bucket), 1 / 0))
    f.result(timeout=60)
    deadline = time.monotonic() + 10
    while not seen and time.monotonic() < deadline:
        time.sleep(0.001)
    f.add_done_callback(lambda fut: seen.append("again"))  # fired: no-op
    g = eng.submit(pool[1])
    g.result(timeout=60)
    g.add_done_callback(lambda fut: seen.append("inline"))
    assert seen == [f.bucket, "inline"]
    assert eng.submit(pool[2]).result(timeout=60) is not None
    eng.close()


# ---------------------------------------------------------------------------
# dispatch policy


def test_least_loaded_routing_under_skewed_load(parts):
    variables, _, pool, oracle, _ = parts
    router = FleetRouter(factory_of(variables), 2,
                         metrics=MetricsRegistry(), start=False)
    rep0 = router.engines[0]
    backlog = [rep0.submit(pool[0]) for _ in range(8)]  # skew replica 0
    futs = [router.submit(pool[i % len(pool)]) for i in range(6)]
    assert all(f.replicas == [1] for f in futs)
    router.start()
    assert all(row_is(f, i % len(pool), oracle)
               for i, f in enumerate(futs))
    for b in backlog:
        b.result(timeout=60)
    router.close()


def test_fleet_results_bit_identical_and_zero_captures(parts):
    """Any stream over 2 replicas gives each request its one-shot row at
    the bucket that served it, and no bucket is built after the replicas
    exist."""
    variables, _, pool, oracle, _ = parts
    router = FleetRouter(factory_of(variables), 2,
                         metrics=MetricsRegistry())
    rng = np.random.default_rng(11)
    futs = []
    for _ in range(5):
        for i in rng.integers(0, len(pool), int(rng.integers(1, 4))):
            futs.append((int(i), router.submit(pool[int(i)])))
        time.sleep(float(rng.uniform(0, 0.003)))
    assert all(row_is(f, i, oracle) for i, f in futs)
    st = router.stats()
    builds = [e.stats()["bucket_builds"] for e in router.engines]
    router.close()
    assert builds == [len(BUCKETS)] * 2
    assert st["lost"] == 0 and st["completed"] == len(futs)


# ---------------------------------------------------------------------------
# tenants


def test_tenant_budget_isolation(parts):
    variables, _, pool, oracle, _ = parts
    router = FleetRouter(factory_of(variables), 2,
                         tenants={"a": 2, "b": 8},
                         metrics=MetricsRegistry(), start=False)
    fa = [router.submit(pool[0], tenant="a") for _ in range(5)]
    fb = [router.submit(pool[1], tenant="b") for _ in range(5)]
    shed_a = [f for f in fa if f.done()]
    assert len(shed_a) == 3
    assert all(isinstance(f.exception(), TenantSheddedError)
               for f in shed_a)
    assert not any(f.done() for f in fb)
    router.start()
    assert all(row_is(f, 1, oracle) for f in fb)
    assert all(row_is(f, 0, oracle) for f in fa if f not in shed_a)
    h = router.health()
    router.close()
    assert h["tenants"]["a"]["shed"] == 3
    assert h["tenants"]["b"]["shed"] == 0
    assert h["tenants"]["b"]["completed"] == 5


def test_tenant_slo_alert_sheds_that_tenant_only(parts):
    variables, _, pool, oracle, _ = parts
    # a 0.001 ms deadline: every completion burns tenant a's budget
    router = FleetRouter(factory_of(variables), 2,
                         tenants={"a": 16, "b": 16}, deadline_ms=0.001,
                         metrics=MetricsRegistry())
    for _ in range(4):
        router.submit(pool[0], tenant="a").result(timeout=60)
    h = router.health()
    assert any(a["rule"] == "tenant-a-latency-burn" for a in h["alerts"])
    assert h["tenants"]["a"]["penalty"] > 0
    boxed = router.submit(pool[0], tenant="a")
    assert isinstance(boxed.exception(), TenantSheddedError)
    assert row_is(router.submit(pool[1], tenant="b"), 1, oracle)
    h = router.health()
    router.close()
    assert h["tenants"]["b"]["shed"] == 0
    assert h["counters"]["fleet.shed_tenant"] >= 1


# ---------------------------------------------------------------------------
# canary rollout


def test_canary_promote_swaps_every_replica(parts):
    variables, new_vars, pool, _, new_oracle = parts
    router = FleetRouter(factory_of(variables), 2, variables=variables,
                         default_budget=100_000, metrics=MetricsRegistry())
    stop = threading.Event()

    def traffic():
        k = 0
        while not stop.is_set():
            router.submit(pool[k % len(pool)])
            k += 1
            time.sleep(0.02)  # under the CPU replicas' rate

    box = {}
    rt = threading.Thread(target=lambda: box.update(res=router.rollout(
        new_vars, canary_frac=0.5, window=4, timeout_s=120)), daemon=True)
    rt.start()
    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    rt.join(timeout=180)
    stop.set()
    th.join(timeout=30)
    _wait_outstanding_zero(router)
    assert box["res"]["outcome"] == "promoted", box
    after = [(i, router.submit(pool[i])) for i in range(len(pool))]
    assert all(row_is(f, i, new_oracle) for i, f in after)
    for eng in router.engines:  # every replica, each on its own
        futs = [(i, eng.submit(pool[i])) for i in range(len(pool))]
        assert all(row_is(f, i, new_oracle) for i, f in futs)
    st = router.stats()
    router.close()
    assert st["promotes"] == 1 and st["rollbacks"] == 0 and st["lost"] == 0


def test_canary_rollback_restores_old_weight_bit_identity(parts):
    variables, new_vars, pool, oracle, new_oracle = parts
    router = FleetRouter(
        factory_of(variables,
                   injector_for={0: "serve:dispatch=device-loss@2,"
                                    "serve:dispatch=device-loss@4"}),
        2, variables=variables, default_budget=100_000,
        metrics=MetricsRegistry())
    stop = threading.Event()
    futs, lock = [], threading.Lock()

    def traffic():
        k = 0
        while not stop.is_set():
            f = router.submit(pool[k % len(pool)])
            with lock:
                futs.append((k % len(pool), f))
            k += 1
            time.sleep(0.05)  # well under the CPU replicas' rate

    box = {}
    rt = threading.Thread(target=lambda: box.update(res=router.rollout(
        new_vars, canary_frac=0.9, window=10_000, timeout_s=120)),
        daemon=True)
    rt.start()
    _wait_canary_armed(router, rt)
    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    rt.join(timeout=180)
    stop.set()
    th.join(timeout=30)
    res = box["res"]
    assert res["outcome"] == "rolled-back", res
    assert any(a["rule"] == "canary-error-burn" for a in res["alerts"])
    lost = 0
    for i, f in list(futs):
        try:
            f.result(timeout=60)
        except SheddedError:
            continue
        except Exception:  # noqa: BLE001 - a lost acknowledged request
            lost += 1
            continue
        assert row_is(f, i, oracle) or row_is(f, i, new_oracle)
    assert lost == 0
    after = [(i, router.submit(pool[i])) for i in range(len(pool))]
    assert all(row_is(f, i, oracle) for i, f in after)
    st = router.stats()
    router.close()
    assert st["rollbacks"] == 1 and st["promotes"] == 0 and st["lost"] == 0


# ---------------------------------------------------------------------------
# replica death / respawn


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replica_death_requeues_and_respawns(parts, seed):
    """Seeded fleet:replica worker-deaths (+ fleet:dispatch faults, the
    schedule JAX draws for the seed) kill live replicas mid-stream: every
    acknowledged request completes bit-identically, each death has its
    respawn, and a respawned engine builds each bucket once."""
    variables, _, pool, oracle, _ = parts
    sched = FaultSchedule.seeded(seed, n=3, sites=FLEET_SITES, max_at=20)
    assert sched.spec() == JaxFaultSchedule.seeded(
        seed, n=3, sites=FLEET_SITES, max_at=20).spec()
    inj = ChaosInjector(sched)
    router = FleetRouter(factory_of(variables), 2,
                         metrics=MetricsRegistry(), injector=inj)
    rng = np.random.default_rng(100 + seed)
    futs = []
    for _ in range(30):
        i = int(rng.integers(0, len(pool)))
        futs.append((i, router.submit(pool[i])))
        if rng.random() < 0.4:
            time.sleep(float(rng.uniform(0, 0.003)))
    assert all(row_is(f, i, oracle, timeout=120) for i, f in futs)
    st = router.stats()
    builds = [e.stats()["bucket_builds"] for e in router.engines]
    router.close()
    assert st["lost"] == 0
    deaths = sum(1 for e in inj.fired if e.kind == "worker-death")
    assert st["replica_deaths"] == deaths and st["respawns"] == deaths
    assert len(inj.fired) == len(sched)
    assert builds == [len(BUCKETS)] * 2


def test_single_replica_fleet_survives_death(parts):
    variables, _, pool, oracle, _ = parts
    inj = ChaosInjector(FaultSchedule.parse("fleet:replica=worker-death@4"))
    router = FleetRouter(factory_of(variables), 1,
                         metrics=MetricsRegistry(), injector=inj)
    futs = [(i % len(pool), router.submit(pool[i % len(pool)]))
            for i in range(8)]
    assert all(row_is(f, i, oracle, timeout=120) for i, f in futs)
    st = router.stats()
    router.close()
    assert st["lost"] == 0
    assert st["replica_deaths"] == 1 and st["respawns"] == 1


# ---------------------------------------------------------------------------
# cascade serving: edge-first with confidence-gated escalation


@pytest.fixture(scope="module")
def cascade_parts(parts):
    """rid 0 = edge tier (the confidence predict, the old weights), rid 1
    = quality tier (plain predict, the new weights), with the oracles and
    each image's confidence at bucket 1."""
    variables, new_vars, pool = parts[:3]
    edge_oracle = oracle_rows(port_predict(variables, cascade=True), pool,
                              BUCKETS)
    confidences = [float(edge_oracle[(1, i)][4]) for i in range(len(pool))]
    return dict(variables=variables, new_vars=new_vars, pool=pool,
                edge=edge_oracle, quality=parts[4],
                confidences=confidences)


def cascade_router(cp, threshold, injector=None, **kw):
    def predicts(rid):
        return (port_predict(cp["variables"], cascade=True) if rid == 0
                else port_predict(cp["new_vars"]))
    return FleetRouter(factory_of(None, predicts=predicts), 2,
                       replica_tiers=["edge", "quality"],
                       cascade_tenants=["cas"],
                       cascade_tiers=("edge", "quality"),
                       cascade_threshold=threshold,
                       metrics=MetricsRegistry(), injector=injector, **kw)


def test_cascade_edge_resolve_bit_identity(cascade_parts):
    """A threshold below every confidence (derived from the pool):
    nothing escalates, every answer is the edge oracle's row, confidence
    included, and a tier-pinned submit opts out of the cascade."""
    cp = cascade_parts
    pool = cp["pool"]
    router = cascade_router(cp, min(cp["confidences"]) - 1.0)
    futs = [(i, router.submit(pool[i], tenant="cas"))
            for i in range(len(pool))]
    direct = [(i, router.submit(pool[i], tenant="cas", tier="edge"))
              for i in range(len(pool))]
    for i, f in futs + direct:
        assert row_is(f, i, cp["edge"])
        assert np.array_equal(f.result().confidence,
                              cp["edge"][(f.bucket, i)][4])
    st = router.stats()
    router.close()
    assert all(not f.escalated and not f.degraded_answer for _, f in futs)
    assert st["edge_resolved"] == len(pool)
    assert st["escalated"] == 0 and st["degraded_answers"] == 0
    assert st["lost"] == 0


def test_cascade_escalation_bit_identity(cascade_parts):
    cp = cascade_parts
    pool = cp["pool"]
    th = max(cp["confidences"]) + 1.0
    router = cascade_router(cp, th)
    futs = [(i, router.submit(pool[i], tenant="cas"))
            for i in range(len(pool))]
    assert all(row_is(f, i, cp["quality"]) for i, f in futs)
    st = router.stats()
    h = router.health()
    router.close()
    assert all(f.escalated and not f.degraded_answer for _, f in futs)
    assert all(f.edge_confidence < th for _, f in futs)
    assert st["escalated"] == len(pool) and st["edge_resolved"] == 0
    assert st["completed"] == len(pool) and st["lost"] == 0
    assert h["cascade"] == {"tiers": ["edge", "quality"], "threshold": th,
                            "tenants": ["cas"]}


def test_cascade_mixed_threshold_routes_by_confidence(cascade_parts):
    """At the median confidence, each request's answer follows its own
    confidence (from the edge bucket's rows) against the threshold."""
    cp = cascade_parts
    pool = cp["pool"]
    th = float(np.median(cp["confidences"]))
    router = cascade_router(cp, th)
    futs = [(i, router.submit(pool[i], tenant="cas"))
            for i in range(len(pool))]
    escalated = 0
    for i, f in futs:
        row = f.result(timeout=60)
        if f.escalated:
            escalated += 1
            assert f.edge_confidence < th
            assert row_is(f, i, cp["quality"])
        else:
            assert float(row.confidence) >= th
            assert row_is(f, i, cp["edge"])
    st = router.stats()
    router.close()
    assert 0 < escalated < len(pool)
    assert st["escalated"] == escalated
    assert st["edge_resolved"] == len(pool) - escalated
    assert st["lost"] == 0 and st["degraded_answers"] == 0


def test_cascade_degraded_answer_on_escalation_fault(cascade_parts):
    cp = cascade_parts
    pool = cp["pool"]
    inj = ChaosInjector(FaultSchedule.parse("fleet:escalate=device-loss@1"))
    router = cascade_router(cp, max(cp["confidences"]) + 1.0, injector=inj)
    futs = [(i, router.submit(pool[i], tenant="cas")) for i in range(4)]
    for _, f in futs:
        f.result(timeout=60)
    st = router.stats()
    router.close()
    degraded = [(i, f) for i, f in futs if f.degraded_answer]
    assert len(degraded) == 1
    i, f = degraded[0]
    assert f.escalated and row_is(f, i, cp["edge"])
    assert st["degraded_answers"] == 1
    assert st["completed"] == 4 and st["lost"] == 0
    assert len(inj.fired) == 1


def test_cascade_escalation_survives_quality_replica_death(cascade_parts):
    """A fleet:escalate worker-death kills the quality replica from the
    edge engine's fetch thread (not the edge engine itself, which would
    join its own thread); the hop proceeds through the respawn or
    degrades, and no acknowledged request is lost."""
    cp = cascade_parts
    pool = cp["pool"]
    inj = ChaosInjector(FaultSchedule.parse(
        "fleet:escalate=worker-death@2"))
    router = cascade_router(cp, max(cp["confidences"]) + 1.0, injector=inj)
    futs = [(i % len(pool), router.submit(pool[i % len(pool)],
                                          tenant="cas")) for i in range(6)]
    for i, f in futs:
        f.result(timeout=120)
        assert row_is(f, i, cp["quality"]) or (
            f.degraded_answer and row_is(f, i, cp["edge"]))
    st = router.stats()
    router.close()
    assert st["lost"] == 0
    assert st["replica_deaths"] == 1 and st["respawns"] == 1
    assert len(inj.fired) == 1


# ---------------------------------------------------------------------------
# the port's router against JAX's, on the same sequences and faults


def jax_factory(predict_of, variables_of, injector_for=None):
    def factory(rid, start=True):
        inj = None
        if injector_for and rid in injector_for:
            inj = JaxChaosInjector(JaxFaultSchedule.parse(
                injector_for[rid]))
        return JaxServingEngine(predict_of(rid), variables_of(rid), SHAPE,
                                np.uint8, buckets=BUCKETS, max_wait_ms=1.0,
                                depth=2, queue_capacity=64, max_retries=4,
                                metrics=JaxMetricsRegistry(), injector=inj,
                                start=start)
    return factory


@pytest.fixture(scope="module")
def jax_predicts():
    jcfg = JaxConfig(**ARCH)
    model = jax_build(jcfg)
    return (jax_make_predict_fn(model, jcfg, normalize="imagenet"),
            jax_make_predict_fn(model, jcfg, normalize="imagenet",
                                cascade_summary=True))


def assert_rows_match(port_rows, jax_rows):
    def valid(rs):
        return [(np.asarray(r.boxes)[np.asarray(r.valid)],
                 np.asarray(r.classes)[np.asarray(r.valid)],
                 np.asarray(r.scores)[np.asarray(r.valid)]) for r in rs]
    n = assert_detections_match(valid(port_rows), valid(jax_rows)) \
        + assert_detections_match(valid(jax_rows), valid(port_rows))
    assert n > 0


def outcome(f, timeout=120):
    """(shed, redispatches, escalated, degraded) and the row or None."""
    try:
        row = f.result(timeout=timeout)
    except (SheddedError, JaxSheddedError):
        return (True, f.redispatches, f.escalated, f.degraded_answer), None
    return (False, f.redispatches, f.escalated, f.degraded_answer), row


def test_fleet_matches_jax_fleet_under_death(parts, jax_predicts):
    """Both routers paused, the same 14 submits (tenant "a", budget 1,
    bursts 3 of them) and the same schedule (a fleet:dispatch fault, a
    fleet:replica worker-death at the 9th arrival, when each replica
    holds 3): the same 2 requests shed, the same 3 re-dispatched, the
    same deaths and respawns, rows matched both ways."""
    variables, _, pool = parts[:3]
    spec = "fleet:dispatch=device-loss@3,fleet:replica=worker-death@9"
    seq = [(i % len(pool), "a" if i in (2, 3, 4) else "b")
           for i in range(14)]
    runs = {}
    for name, router in (
            ("port", FleetRouter(factory_of(variables), 2,
                                 tenants={"a": 1, "b": 64},
                                 metrics=MetricsRegistry(),
                                 injector=ChaosInjector(
                                     FaultSchedule.parse(spec)),
                                 start=False)),
            ("jax", JaxFleetRouter(jax_factory(lambda rid: jax_predicts[0],
                                               lambda rid: variables), 2,
                                   tenants={"a": 1, "b": 64},
                                   metrics=JaxMetricsRegistry(),
                                   injector=JaxChaosInjector(
                                       JaxFaultSchedule.parse(spec)),
                                   start=False))):
        futs = [router.submit(pool[i], tenant=t) for i, t in seq]
        router.start()
        runs[name] = ([outcome(f) for f in futs], router.stats())
        router.close()
    (p_out, p_st), (j_out, j_st) = runs["port"], runs["jax"]
    assert [o for o, _ in p_out] == [o for o, _ in j_out]
    assert sum(o[1] for o, _ in p_out) == 3
    assert sum(o[0] for o, _ in p_out) == 2
    for key in ("lost", "replica_deaths", "respawns", "redispatched",
                "dispatch_faults", "shed_tenant", "completed"):
        assert p_st[key] == j_st[key], key
    assert_rows_match([r for _, r in p_out if r is not None],
                      [r for _, r in j_out if r is not None])


def test_cascade_matches_jax_cascade(cascade_parts, jax_predicts):
    """One request at a time at the median confidence, with an escalation
    fault at the 2nd escalation: the same requests escalate, the same one
    degrades, rows matched both ways; the confidences agree within 1e-6
    (relative)."""
    cp = cascade_parts
    pool = cp["pool"]
    th = float(np.median(cp["confidences"]))
    spec = "fleet:escalate=device-loss@2"
    jr = JaxFleetRouter(
        jax_factory(lambda rid: jax_predicts[1 - rid],
                    lambda rid: (cp["variables"], cp["new_vars"])[rid]),
        2, replica_tiers=["edge", "quality"], cascade_tenants=["cas"],
        cascade_tiers=("edge", "quality"), cascade_threshold=th,
        metrics=JaxMetricsRegistry(),
        injector=JaxChaosInjector(JaxFaultSchedule.parse(spec)))
    pr = cascade_router(cp, th, injector=ChaosInjector(
        FaultSchedule.parse(spec)))
    got = {"port": [], "jax": []}
    for name, router in (("port", pr), ("jax", jr)):
        for i in range(len(pool)):
            got[name].append(outcome(router.submit(pool[i], tenant="cas")))
        direct = [router.submit(pool[i], tier="edge").result(timeout=60)
                  for i in range(len(pool))]
        got[name + "_conf"] = [float(d.confidence) for d in direct]
        router.close()
    assert [o for o, _ in got["port"]] == [o for o, _ in got["jax"]]
    assert sum(o[3] for o, _ in got["port"]) == 1
    assert 0 < sum(o[2] for o, _ in got["port"]) < len(pool)
    assert_rows_match([r for _, r in got["port"]],
                      [r for _, r in got["jax"]])
    np.testing.assert_allclose(got["port_conf"], got["jax_conf"],
                               rtol=1e-6)


def test_canary_matches_jax_canary(parts, jax_predicts):
    """A rollout at canary_frac 0.25 with a window of 4 on both routers,
    then 16 requests in one burst: the same canary, the same requests
    sent to it (counter quota, not chance), the same verdict; rows
    matched both ways, the canary's with the new weights."""
    variables, new_vars, pool = parts[:3]
    got = {}
    for name, router in (
            ("port", FleetRouter(factory_of(variables), 2,
                                 variables=variables,
                                 metrics=MetricsRegistry())),
            ("jax", JaxFleetRouter(jax_factory(lambda rid: jax_predicts[0],
                                               lambda rid: variables), 2,
                                   variables=variables,
                                   metrics=JaxMetricsRegistry()))):
        box = {}
        rt = threading.Thread(target=lambda r=router: box.update(
            res=r.rollout(new_vars, canary_frac=0.25, window=4,
                          timeout_s=120)), daemon=True)
        rt.start()
        _wait_canary_armed(router, rt)
        canary = router.health()["canary"]["rid"]
        futs = [router.submit(pool[k % len(pool)]) for k in range(16)]
        rt.join(timeout=180)
        rows = [f.result(timeout=60) for f in futs]
        got[name] = dict(canary=canary, outcome=box["res"]["outcome"],
                         to_canary=[f.replicas[0] == canary for f in futs],
                         rows=rows)
        router.close()
    p, j = got["port"], got["jax"]
    assert p["canary"] == j["canary"] == 0
    assert p["outcome"] == j["outcome"] == "promoted"
    assert p["to_canary"] == j["to_canary"]
    assert p["to_canary"] == [k % 4 == 3 for k in range(16)]
    assert_rows_match(p["rows"], j["rows"])


def test_fleet_run_on_cpu(tmp_path):
    """`serving.runs --replicas 1 2` at a small size on the CPU: every
    check the smoke run holds on the card holds here (rows equal the
    oracle, skew, tenants, a death with its respawn, promote, rollback),
    in the record's real-engine section (`engine`)."""
    from real_time_helmet_detection_tpu_torch.serving import runs
    out = runs.main(["--replicas", "1", "2", "--device", "cpu", "--imsize",
                     "64", "--inch", "16", "--buckets", "1", "2", "--pool",
                     "4", "--duration", "0.3", "--clients", "4",
                     "--no-amp", "--out", str(tmp_path / "fleet.json")])
    out = out["engine"]
    for row in out["rows"]:
        assert row["rows"]["equal"] == row["rows"]["rows"] > 0
        assert row["lost"] == 0 and row["builds"] == [2] * row["replicas"]
    r = out["routing"]
    assert r["b_replicas"] == [[1]] * 6
    assert r["a_shed"] == r["a_tenant_shed"] == 3
    assert r["tenants"]["b"]["shed"] == r["tenants"]["bulk"]["shed"] == 0
    assert r["rows"]["equal"] == r["rows"]["rows"] == 16
    d = out["death"]
    assert d["fired"] and d["lost"] == 0
    assert d["deaths"] == d["respawns"] == 1 and d["builds"] == [2, 2]
    assert d["after"]["equal"] == d["after"]["rows"]
    p, b = out["promote"], out["rollback"]
    assert p["outcome"] == "promoted" and p["lost"] == 0
    assert p["after"]["equal"] == p["after"]["rows"]
    assert b["outcome"] == "rolled-back" and "canary-error-burn" in b[
        "alerts"]
    assert b["lost_acks"] == b["lost"] == 0
    assert b["during_equal"] == b["during"] - b["shed"]
    assert b["after"]["equal"] == b["after"]["rows"]
