"""serve_bench's selfcheck: the engine, fleet, trace, cascade and streams
contracts on seeded load, at a small size, on the card or the CPU.

Port of ref scripts/serve_bench.py:1581-2228 (`selfcheck`,
`_rows_equal_sc`, `_raises_shed`), with its sections and checks, run by
`python -m real_time_helmet_detection_tpu_torch.serving.runs
--selfcheck [--device cuda|cpu]` (the card by default). Each check
prints `selfcheck <name> ok|FAIL` to stderr; `selfcheck()` returns JAX's
line, `{"tool": "serve_bench", "selfcheck": true, "ok", "failures",
"elapsed_s"}`.

Where JAX holds a row to the batch-1 predict of its image, the port
holds it to the eager predict at the bucket that served it (cuDNN, and
the CPU's convolutions, may pick another algorithm per batch size), and
where JAX counts recompiles after the warm-up the port counts bucket
captures after construction (`stats()["bucket_builds"]`). The model is
JAX's selfcheck model: width 8, 64^2, top-k 16, f32, buckets 1/2/4,
seed 7, 12 images.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..obs.slo import SloWatchdog, default_serving_rules
from ..obs.spans import SpanTracer, read_spans
from ..predict import resolve_device
from ..runtime import ChaosInjector, FaultSchedule
from ..utils import save_json
from .engine import ServingEngine, SheddedError
from .fleet import FleetRouter
from .loadgen import arrival_schedule, open_loop
from .runs import (FLEET_SCHEMA, REPO, SCHEMA, _tile_oracle_match,
                   builds_of, fleet_scaling_rows, make_predict,
                   make_replica_factory, oracle_rows, rows_equal,
                   run_config, sim_pool)
from .sim import SimServePredict
from .streams import StreamSession

BUCKETS = (1, 2, 4)
DET = slice(0, 4)  # boxes, classes, scores, valid


def engine_of(predict, image_shape, **kw) -> ServingEngine:
    """One engine on its own, outside any fleet: the single-engine
    sections' engines (uint8 wire, the predict's weights)."""
    return ServingEngine(  # graftlint: off=engine-bypass-in-fleet
        predict, None, image_shape, np.uint8, **kw)


def raises_shed(fut) -> bool:
    try:
        fut.result(timeout=0.5)
        return False
    except SheddedError:
        return True
    except Exception:  # noqa: BLE001 - another error is not a shed
        return False


def selfcheck(device="cuda") -> Dict:
    """Every section's checks (module docstring); the line JAX prints."""
    dev = resolve_device(device)
    failures: List[str] = []
    # the selfcheck times itself through a span (disabled tracers time)
    sp_all = SpanTracer(None).span("serve-bench:selfcheck").__enter__()

    def check(name, cond):
        print("selfcheck %-52s %s" % (name, "ok" if cond else "FAIL"),
              file=sys.stderr, flush=True)
        if not cond:
            failures.append(name)

    # the threaded engine and fleet plane must be lock-audit clean
    # before its behaviour is checked (stdlib ast, about a second)
    from ..analysis import diff_baseline, load_baseline, lock_audit
    check("lock audit clean (graftlint layer 3)",
          not diff_baseline(lock_audit.audit_repo(REPO),
                            load_baseline())["new"])

    ns = argparse.Namespace(device=str(dev), imsize=64, inch=8, topk=16,
                            amp=False, infer_dtype="bf16", buckets=BUCKETS,
                            seed=7, pool=12)
    cfg = run_config(ns)
    predict = make_predict(cfg)
    pool = sim_pool(ns)
    # the oracle: each image's eager predict at each bucket
    oracle = oracle_rows(predict, pool, BUCKETS)

    def served_ok(futs):
        """The answered (index, future) pairs' rows all equal their
        image's oracle at the bucket that served each."""
        return all(rows_equal(tuple(f.result(timeout=60))[DET],
                              oracle[(f.bucket, i)])
                   for i, f in futs if f.exception() is None)

    def replica(rid):
        return make_predict(cfg)

    with tempfile.TemporaryDirectory(prefix="serve_bench_selfcheck.") as tmp:
        span_path = os.path.join(tmp, "spans.jsonl")
        tracer = SpanTracer(span_path)
        _engine_sections(check, predict, pool, served_ok, tracer, tmp)
        tracer.close()
        spans = read_spans(span_path)
        names = {r.get("name") for r in spans}
        check("serve spans recorded",
              {"serve:compile", "serve:batch-form", "serve:h2d",
               "serve:compute", "serve:d2h", "serve:queue-wait",
               "serve:e2e"} <= names)
        check("shed events recorded",
              sum(1 for r in spans if r.get("name") == "serve:shed") == 3)
        _fault_sections(check, predict, pool, served_ok, tmp)
        _fleet_sections(check, replica, pool, served_ok, tmp)
        _trace_sections(check, pool, tmp)
        _cascade_sections(check, cfg, pool, oracle, served_ok)
        _stream_sections(check, predict, pool, oracle, tracer, span_path,
                         dev)
    ok = not failures
    return {"tool": "serve_bench", "selfcheck": True, "ok": ok,
            "failures": failures, "elapsed_s": sp_all.close()}


def _engine_sections(check, predict, pool, served_ok, tracer, tmp):
    """One engine under a random stream; metrics against stats; the
    queue-full and deadline sheds; an open loop."""
    mreg = MetricsRegistry()
    eng1 = engine_of(predict, (64, 64, 3),
                     buckets=BUCKETS, max_wait_ms=2.0, depth=2,
                     queue_capacity=32, tracer=tracer, metrics=mreg)
    eng1.predict_many(pool[:4])
    rng = np.random.default_rng(0)
    futs = []
    for _ in range(8):
        k = int(rng.integers(1, 6))
        idx = rng.integers(0, len(pool), k)
        futs += [(int(i), eng1.submit(pool[int(i)])) for i in idx]
        time.sleep(float(rng.uniform(0, 0.004)))
    rows = [f.result(timeout=30) for _, f in futs]
    check("stream bit-identical to one-shot predict", served_ok(futs))
    st = eng1.stats()
    check("no capture after construction",
          st["bucket_builds"] == len(BUCKETS))
    check("engine served the stream",  # + the 4 warm-up requests
          st["completed"] == len(rows) + 4 and st["batches"] >= 1)
    # snapshot after close: a future resolves before the fetch loop's
    # e2e observe, so an open engine could still be mid-bookkeeping
    eng1.close()
    snap = mreg.snapshot()
    check("metrics snapshot agrees with stats rows",
          snap["counters"]["serve.submitted"] == st["submitted"]
          and snap["counters"]["serve.completed"] == st["completed"]
          and snap["counters"]["serve.batches_total"] == st["batches"]
          and snap["counters"]["serve.padded_slots"] == st["padded_slots"])
    check("metrics e2e histogram absorbed the stream",
          snap["histograms"]["serve.e2e_ms"]["count"] == st["completed"])
    hl = eng1.health()
    check("health() carries the metrics digest",
          hl["metrics"]["histograms"]["serve.e2e_ms"]["count"]
          == st["completed"]
          and hl["metrics"]["counters"]["serve.completed"]
          == st["completed"])

    # admission control: a paused engine with a queue of 2 sheds at once
    eng2 = engine_of(predict, (64, 64, 3),
                     buckets=(1, 2), max_wait_ms=0.0, queue_capacity=2,
                     tracer=tracer, start=False)
    futs2 = [eng2.submit(pool[0], block=False) for _ in range(4)]
    shed = [f for f in futs2 if f.done()]
    check("queue-full sheds immediately",
          len(shed) == 2 and all(raises_shed(f) for f in shed))
    eng2.start()
    ok_rows = [f.result(timeout=30) for f in futs2 if not raises_shed(f)]
    check("admitted requests still served", len(ok_rows) == 2)
    check("queue-full counter recorded",
          eng2.stats()["shed_queue_full"] == 2)
    eng2.close()

    # a request expired before its batch formed never reaches the device
    eng3 = engine_of(predict, (64, 64, 3),
                     buckets=(1, 2), max_wait_ms=0.0, queue_capacity=8,
                     tracer=tracer, start=False)
    late = eng3.submit(pool[0], deadline_s=0.001, block=False)
    time.sleep(0.05)
    eng3.start()
    check("expired request shed at batch formation", raises_shed(late))
    check("deadline counter recorded", eng3.stats()["shed_deadline"] == 1)
    eng3.close()

    engine3 = engine_of(predict, (64, 64, 3),
                        buckets=BUCKETS, max_wait_ms=2.0,
                        queue_capacity=32)
    row = open_loop(engine3, pool, arrival_schedule(60.0, 1.0, seed=3), 1.0,
                    deadline_s=2.0, offered_rps=60.0)
    engine3.close()
    check("open loop completes its schedule",
          row["completed"] + row["shed"] + row["lost"] == row["n"]
          and row["completed"] > 0 and row["lost"] == 0)
    check("p50 <= p99", (row["p50_ms"] or 0) <= (row["p99_ms"] or 0))


def _fault_sections(check, predict, pool, served_ok, tmp):
    """The canned schedule (device losses at dispatch, a hung fetch):
    every acknowledged request served, bit-identical; the error burn
    alerts; the record round-trips."""
    inj = ChaosInjector(FaultSchedule.parse(
        "serve:dispatch=device-loss@2,serve:fetch=hung-fetch@4,"
        "serve:dispatch=device-loss@6"))
    reg = MetricsRegistry()
    slo = SloWatchdog(default_serving_rules(), registry=reg)
    eng = engine_of(predict, (64, 64, 3),
                    buckets=BUCKETS, max_wait_ms=2.0, depth=2,
                    queue_capacity=64, max_retries=3,
                    hang_timeout_s=0.1, injector=inj, metrics=reg,
                    watchdog=slo)
    futs = [(int(i), eng.submit(pool[int(i)]))
            for i in np.random.default_rng(5).integers(0, len(pool), 24)]
    lost = 0
    for _, f in futs:
        try:
            f.result(timeout=60)
        except Exception:  # noqa: BLE001 - would be a lost ack
            lost += 1
    st = eng.stats()
    eng.close()
    check("faults: all scheduled events fired",
          len(inj.fired) == 3 and inj.pending() == 0)
    check("faults: zero lost acknowledged requests",
          lost == 0 and st["failed"] == 0 and st["completed"] == len(futs))
    check("faults: retried results bit-identical to one-shot",
          served_ok(futs))
    check("faults: recovery accounted",
          st["retried"] >= 1 and st["requeued_batches"] >= 2
          and st["hung_batches"] == 1)
    snap = reg.snapshot()
    check("faults: metrics snapshot agrees with stats rows",
          snap["counters"]["serve.retried"] == st["retried"]
          and snap["counters"]["serve.requeued_batches"]
          == st["requeued_batches"]
          and snap["counters"]["serve.hung_batches"] == st["hung_batches"]
          and snap["counters"]["serve.failed_batches"]
          == st["failed_batches"])
    check("faults: SLO error-burn alerted",
          any(a["rule"] == "serve-error-burn" for a in slo.alerts))
    art = os.path.join(tmp, "serve_bench.json")
    save_json(art, {"schema": SCHEMA, "metrics": snap}, indent=1)
    with open(art) as f:
        back = json.load(f)
    check("artifact roundtrips", back["schema"] == SCHEMA)
    check("metrics snapshot rides the artifact",
          back["metrics"]["schema"] == "obs-metrics-v1"
          and back["metrics"]["counters"]["serve.retried"] == st["retried"])


def _fleet_sections(check, replica, pool, served_ok, tmp):
    """The router: rows, captures, tenant sheds, a death with lost 0,
    the scaling rows over sims and the fleet record's line fields."""
    sp = SpanTracer(None).span("serve-bench:selfcheck-fleet").__enter__()
    factory = make_replica_factory(replica, (64, 64, 3), lambda rid: BUCKETS,
                                   queue_capacity=64, max_wait_ms=2.0)
    fr = FleetRouter(factory, 2, metrics=MetricsRegistry())
    fr.predict_many(pool[:4])  # warm both replicas' paths
    rng = np.random.default_rng(1)
    futs = []
    for _ in range(6):
        idx = rng.integers(0, len(pool), int(rng.integers(1, 5)))
        futs += [(int(i), fr.submit(pool[int(i)])) for i in idx]
        time.sleep(float(rng.uniform(0, 0.004)))
    rows = [f.result(timeout=30) for _, f in futs]
    st = fr.stats()
    builds = builds_of(fr)
    fr.close()
    check("fleet: stream bit-identical to one-shot predict",
          served_ok(futs))
    check("fleet: no capture after construction across replicas",
          builds == [len(BUCKETS)] * 2)
    check("fleet: zero lost acks on the clean stream",
          st["lost"] == 0 and st["completed"] == len(rows) + 4)

    # per-tenant sheds on a paused fleet: tenant a over its budget sheds
    # exactly its overflow, tenant b is untouched
    fr2 = FleetRouter(factory, 2, tenants={"a": 2, "b": 8},
                      metrics=MetricsRegistry(), start=False)
    fa = [fr2.submit(pool[0], tenant="a") for _ in range(5)]
    fb = [fr2.submit(pool[1], tenant="b") for _ in range(5)]
    shed_a = [f for f in fa if f.done()]
    fr2.start()
    served = [f.result(timeout=30) for f in fb] \
        + [f.result(timeout=30) for f in fa if f not in shed_a]
    h2 = fr2.health()
    fr2.close()
    check("fleet: tenant budget sheds the right tenant",
          len(shed_a) == 3 and h2["tenants"]["a"]["shed"] == 3
          and h2["tenants"]["b"]["shed"] == 0 and len(served) == 7)

    # a canned fleet:replica death: re-dispatch and respawn keep every
    # acknowledged request
    inj = ChaosInjector(FaultSchedule.parse(
        "fleet:dispatch=device-loss@2,fleet:replica=worker-death@5"))
    fr3 = FleetRouter(factory, 2, metrics=MetricsRegistry(), injector=inj)
    futs3 = [(k % len(pool), fr3.submit(pool[k % len(pool)]))
             for k in range(16)]
    lost = 0
    for _, f in futs3:
        try:
            f.result(timeout=60)
        except Exception:  # noqa: BLE001 - would be a lost ack
            lost += 1
    st3 = fr3.stats()
    fr3.close()
    check("fleet: canned death schedule fired",
          len(inj.fired) == 2 and inj.pending() == 0)
    check("fleet: death run lost zero acknowledged requests",
          lost == 0 and st3["lost"] == 0 and st3["replica_deaths"] == 1
          and st3["respawns"] == 1)
    check("fleet: death-run survivors bit-identical", served_ok(futs3))

    # the fleet record's scaling rows over sims (short loops) and the
    # line fields through a record round-trip
    nsf = argparse.Namespace(
        imsize=64, buckets=(1, 2, 4, 8), queue_cap=8, max_wait_ms=2.0,
        depth=2, deadline_ms=600.0, duration=1.5, clients=16, pool=8,
        seed=3, replicas=[1, 2], replica_sim_ms=30.0, fleet_load=2.0)
    rows_sim = fleet_scaling_rows(nsf, SpanTracer(None))
    check("fleet: scaling rows carry the gated fields",
          [r["replicas"] for r in rows_sim] == [1, 2]
          and all(isinstance(r["scaling_eff"], float) and r["lost"] == 0
                  for r in rows_sim)
          and rows_sim[0]["scaling_eff"] == 1.0)
    line = {"schema": FLEET_SCHEMA, "replicas": [1, 2],
            "tenants": ["bulk", "flagged"],
            "canary": {"outcome": "rolled-back", "lost_acks": 0},
            "exemplar_p99_stage": "serve:queue-wait", "rows": rows_sim}
    art = os.path.join(tmp, "serve_bench_fleet.json")
    save_json(art, line, indent=1)
    with open(art) as f:
        back = json.load(f)
    check("fleet: artifact roundtrips with line fields",
          back["schema"] == FLEET_SCHEMA and back["replicas"] == [1, 2]
          and back["tenants"] == ["bulk", "flagged"]
          and back["canary"]["lost_acks"] == 0
          and back["exemplar_p99_stage"] == "serve:queue-wait")
    print("selfcheck fleet section elapsed %.1fs" % sp.close(),
          file=sys.stderr, flush=True)


def _trace_sections(check, pool, tmp):
    """Exemplar reassembly over a fixed-service sim engine (the span sum
    explains the e2e) and a fleet death whose re-dispatch hop shows in
    the reassembled trace: no orphan, no broken chain."""
    from ..obs import traceview
    sp = SpanTracer(None).span("serve-bench:selfcheck-traces").__enter__()
    tpath = os.path.join(tmp, "trace_spans.jsonl")
    ttr = SpanTracer(tpath)
    # 80 ms of service: compute dominates each e2e by construction
    eng = engine_of(SimServePredict(80.0), (64, 64, 3),
                    buckets=(1, 2), max_wait_ms=1.0, queue_capacity=32,
                    metrics=MetricsRegistry(), tracer=ttr)
    # sequential: each e2e is one compute and some slop
    for i in range(4):
        eng.submit(pool[i % len(pool)]).result(timeout=30)
    eng.close()
    ttr.close()
    traces = traceview.assemble_logs([tpath])
    summ = traceview.analyze(traces)
    ex = traceview.tail_exemplars(traces, 3)
    check("traces: engine stream complete (no orphans/broken)",
          summ["request_traces"] == 4 and summ["orphans"] == 0
          and summ["broken_chains"] == 0)
    cp = ex[0]["critical_path"] if ex else {}
    check("traces: exemplar e2e equals its span-sum (tolerance)",
          len(ex) == 3
          and abs(cp["stage_sum_ms"] - cp["e2e_ms"])
          <= max(0.5 * cp["e2e_ms"], 40.0)
          and (cp["attributed_frac"] or 0) >= 0.5)
    check("traces: compute dominates the fixed-service exemplar",
          cp.get("dominant_stage") == "serve:compute")

    tpath2 = os.path.join(tmp, "trace_fleet.jsonl")
    ttr2 = SpanTracer(tpath2)
    factory = make_replica_factory(lambda rid: SimServePredict(20.0),
                                   (64, 64, 3), lambda rid: (1, 2),
                                   queue_capacity=64, max_wait_ms=1.0,
                                   tracer=ttr2)
    inj = ChaosInjector(FaultSchedule.parse(
        "fleet:replica=worker-death@30"), tracer=ttr2)
    fr = FleetRouter(factory, 2, metrics=MetricsRegistry(), injector=inj,
                     tracer=ttr2)
    # a dense burst: backlog exists when the death fires, so the killed
    # queued requests take the re-dispatch path
    futs = [fr.submit(pool[k % len(pool)]) for k in range(40)]
    lost = 0
    for f in futs:
        try:
            f.result(timeout=60)
        except Exception:  # noqa: BLE001 - would be a lost ack
            lost += 1
    st = fr.stats()
    fr.close()
    ttr2.close()
    traces2 = traceview.assemble_logs([tpath2])
    summ2 = traceview.analyze(traces2)
    check("traces: death run reassembles completely",
          lost == 0 and summ2["request_traces"] == 40
          and summ2["orphans"] == 0 and summ2["broken_chains"] == 0)
    hop = [t for t in traces2.values()
           if any(r.get("name") == "fleet:redispatch" for r in t.records)]
    check("traces: re-dispatch hop visible in reassembled trace",
          st["redispatched"] >= 1 and len(hop) >= 1
          and summ2["redispatched_traces"] == len(hop)
          and all(t.root_closure() is not None for t in hop)
          and any(sum(1 for r in t.records
                      if r.get("name") == "fleet:dispatch") >= 2
                  for t in hop))
    print("selfcheck traces section elapsed %.1fs" % sp.close(),
          file=sys.stderr, flush=True)


def _cascade_sections(check, cfg, pool, oracle, served_ok):
    """Edge-first routing over real predicts: the escalation-hop fault
    degrades to the edge answer, no capture after construction, every
    answer its oracle's, the outcome follows the confidence; a quality
    replica's death mid-cascade loses nothing."""
    sp = SpanTracer(None).span("serve-bench:selfcheck-cascade").__enter__()
    edge_oracle = oracle_rows(make_predict(cfg, cascade_summary=True), pool,
                              BUCKETS)
    check("cascade: summary predict det-identical to plain predict",
          all(rows_equal(edge_oracle[k][DET], oracle[k]) for k in oracle))
    # the confidences an edge hop can see, per image (one per bucket)
    confs = {i: {float(edge_oracle[(b, i)][4]) for b in BUCKETS}
             for i in range(len(pool))}
    # a fixture operating point, not a latency digest: the middle of the
    # batch-1 confidences makes both outcomes happen over the pool
    th = float(np.median([float(edge_oracle[(1, i)][4])  # graftlint: off=raw-metric-aggregation
                          for i in range(len(pool))]))

    def factory(rid, start=True):
        return make_replica_factory(
            lambda r: make_predict(cfg, cascade_summary=r == 0),
            (64, 64, 3), lambda r: BUCKETS, queue_capacity=64,
            max_wait_ms=2.0)(rid, start=start)

    inj = ChaosInjector(FaultSchedule.parse("fleet:escalate=device-loss@2"))
    frc = FleetRouter(factory, 2, replica_tiers=["edge", "quality"],
                      cascade_tenants=["cas"],
                      cascade_tiers=("edge", "quality"),
                      cascade_threshold=th, metrics=MetricsRegistry(),
                      injector=inj)
    for f in [frc.submit(pool[i], tenant="cas") for i in range(4)]:
        f.result(timeout=60)
    futs = [(i % len(pool), frc.submit(pool[i % len(pool)], tenant="cas"))
            for i in range(12)]
    lost, rows = 0, []
    for i, f in futs:
        try:
            rows.append((i, f, f.result(timeout=120)))
        except Exception:  # noqa: BLE001 - would be a lost ack
            lost += 1
    st = frc.stats()
    builds = builds_of(frc)
    frc.close()

    def edge_row(i, f, r):
        return edge_oracle[(f.bucket, i)]

    check("cascade: escalation-hop fault fired",
          len(inj.fired) == 1 and inj.pending() == 0)
    check("cascade: zero lost acks under escalation faults",
          lost == 0 and st["lost"] == 0)
    check("cascade: no capture after construction across both tiers",
          builds == [len(BUCKETS)] * 2)
    check("cascade: faulted hop degraded to the edge answer",
          st["degraded_answers"] >= 1
          and all(rows_equal(tuple(r), edge_row(i, f, r))
                  for i, f, r in rows if f.degraded_answer))
    check("cascade: every answer bit-identical to its oracle",
          served_ok([(i, f) for i, f, _ in rows]))
    check("cascade: edge answers carry the in-jit confidence",
          all(np.array_equal(r.confidence, edge_row(i, f, r)[4])
              for i, f, r in rows
              if not f.escalated or f.degraded_answer))
    check("cascade: outcome follows the confidence vs threshold",
          all((f.edge_confidence in confs[i] and f.edge_confidence < th)
              if f.escalated else float(r.confidence) >= th
              for i, f, r in rows))

    # a quality replica's death mid-cascade: respawn, the hop proceeds
    # or degrades, the ack is never lost (a respawn captures again)
    injd = ChaosInjector(FaultSchedule.parse(
        "fleet:escalate=worker-death@2"))
    frd = FleetRouter(factory, 2, replica_tiers=["edge", "quality"],
                      cascade_tenants=["cas"],
                      cascade_tiers=("edge", "quality"),
                      # above every oracle confidence: all escalate
                      cascade_threshold=max(max(c) for c in confs.values())
                      + 1.0, metrics=MetricsRegistry(), injector=injd)
    futd = [frd.submit(pool[i % len(pool)], tenant="cas") for i in range(6)]
    lostd = 0
    for f in futd:
        try:
            f.result(timeout=120)
        except Exception:  # noqa: BLE001 - would be a lost ack
            lostd += 1
    std = frd.stats()
    frd.close()
    check("cascade: quality death respawned, zero lost acks",
          lostd == 0 and std["lost"] == 0 and std["replica_deaths"] == 1
          and std["respawns"] == 1)
    print("selfcheck cascade section elapsed %.1fs" % sp.close(),
          file=sys.stderr, flush=True)


def _stream_sections(check, predict, pool, oracle, tracer, span_path, dev):
    """Delta-gated tiles over a real predict: reassembly equals the
    per-tile oracle, only changed tiles recompute, a copy answers from
    the cache, gate-off equals the whole-frame predict, frame faults
    deliver from the cache in order with `recover:frame-gap` events."""
    from ..ops.delta import tile_origins
    sp = SpanTracer(None).span("serve-bench:selfcheck-streams").__enter__()

    def mk_frame(i0, i1, i2, i3):
        # a 2x2 frame whose tiles are pool images: the per-tile oracle is
        # the oracle of those images
        top = np.concatenate([pool[i0], pool[i1]], axis=1)
        bot = np.concatenate([pool[i2], pool[i3]], axis=1)
        return np.concatenate([top, bot], axis=0)

    def oracle_of(tile):
        i = next(k for k, img in enumerate(pool)
                 if np.array_equal(img, tile))
        return [oracle[(b, i)] for b in BUCKETS]

    def tiles_ok(res, frame):
        return _tile_oracle_match(res, frame, origins, (64, 64),
                                  oracle_of) == len(origins)

    def frame_equal(a, b):
        return rows_equal(tuple(a), tuple(b))

    origins = tile_origins((128, 128, 3), 2)
    eng = engine_of(predict, (64, 64, 3),
                    buckets=BUCKETS, max_wait_ms=2.0, depth=2,
                    queue_capacity=32, tracer=tracer)
    eng.predict_many(pool[:2])

    # derived, not hand-picked: half the smallest changed-tile mean
    # |delta| of the fixture's swaps (unchanged tiles delta exactly 0)
    def pair_delta(a, b):
        return float(np.abs(pool[a].astype(np.float32)
                            - pool[b].astype(np.float32)).mean())

    th = 0.5 * min(pair_delta(a, b)
                   for a, b in ((2, 4), (0, 5), (1, 6), (3, 7)))
    # ema 0 isolates the reassembly arithmetic
    sess = StreamSession(eng, (128, 128, 3), grid=2, threshold=th, ema=0.0,
                         tracer=tracer, device=dev)
    f0, f1 = mk_frame(0, 1, 2, 3), mk_frame(0, 1, 4, 3)
    r0 = sess.submit_frame(f0).result(timeout=60)
    check("streams: first frame computes every tile",
          r0.computed_tiles == 4 and r0.total_tiles == 4)
    check("streams: reassembly bit-identical to per-tile oracle",
          tiles_ok(r0, f0))
    r1 = sess.submit_frame(f1).result(timeout=60)
    check("streams: only the changed tile recomputes",
          r1.computed_tiles == 1 and tiles_ok(r1, f1))
    r2 = sess.submit_frame(f1).result(timeout=60)
    check("streams: identical frame answers fully from the cache",
          r2.computed_tiles == 0
          and frame_equal(r2.detections, r1.detections))
    sess.close()

    # gate off: the whole frame passes straight through
    eng_off = engine_of(predict, (128, 128, 3),
                        buckets=(1,), max_wait_ms=0.0, queue_capacity=8,
                        tracer=tracer)
    whole = oracle_rows(predict, [f0], (1,))[(1, 0)]
    sess_off = StreamSession(eng_off, (128, 128, 3), gate=False,
                             tracer=tracer, device=dev)
    roff = sess_off.submit_frame(f0).result(timeout=60)
    check("streams: gate-off bit-identical to whole-frame predict",
          rows_equal(tuple(roff.detections)[DET], whole)
          and roff.computed_tiles == roff.total_tiles)
    sess_off.close()
    eng_off.close()

    # frame faults: dropped@2, corrupt@3, late@5 over one stream
    inj = ChaosInjector(FaultSchedule.parse(
        "stream:frame=dropped-frame@2,stream:frame=corrupt-frame@3,"
        "stream:frame=late-frame@5"), tracer=tracer)
    sess_f = StreamSession(eng, (128, 128, 3), grid=2, threshold=th,
                           ema=0.0, injector=inj, tracer=tracer, sid=1,
                           device=dev)
    frames = [mk_frame(0, 1, 2, 3), mk_frame(0, 1, 4, 3),
              mk_frame(5, 1, 4, 3), mk_frame(5, 6, 4, 3),
              mk_frame(5, 6, 4, 7), mk_frame(5, 6, 4, 7)]
    futs = [sess_f.submit_frame(f) for f in frames]
    lost, res = 0, []
    for f in futs:
        try:
            res.append(f.result(timeout=60))
        except Exception:  # noqa: BLE001 - would be a lost ack
            lost += 1
    st = sess_f.stats()
    sess_f.close()
    eng.close()
    tracer.close()
    check("streams: zero lost acked frames under frame faults",
          lost == 0 and len(res) == 6 and inj.pending() == 0)
    check("streams: in-order delivery", [r.seq for r in res]
          == list(range(6)))
    check("streams: dropped/corrupt frames answer from the cache",
          res[1].gap and res[2].gap
          and frame_equal(res[1].detections, res[0].detections)
          and frame_equal(res[2].detections, res[0].detections))
    check("streams: frame-fault accounting",
          st["gaps"] == 2 and st["corrupt"] == 1 and st["late"] == 1)
    gaps = [s for s in read_spans(span_path)
            if s.get("name") == "recover:frame-gap"]
    check("streams: recover:frame-gap events in the span log",
          len(gaps) >= 2)
    print("selfcheck streams section elapsed %.1fs" % sp.close(),
          file=sys.stderr, flush=True)
