"""Fleet, cascade and streams runs of the serving plane, real engines on
the card.

Port of the fleet, cascade and streams modes of ref
scripts/serve_bench.py:463 (`make_replica_factory` :463, `run_fleet_bench`
:715, `run_cascade_bench` :862, `synth_stream_frames` :1036,
`stream_closed_loop` :1059, `run_streams_bench` :1241). The JAX script's
simulated replicas (`--replica-sim-ms`, `--cascade-edge-ms`,
`--tile-sim-ms`) are not ported: every replica here is a
`ServingEngine` with its own model and bucket graphs, the replicas of a
fleet sharing the one card. Each run measures and checks what it
serves: rows against the eager predict of the same image at the bucket
that served it (bit for bit), lost acknowledged requests, respawns and
captures, canary verdicts, cascade routing and streaming tile gates.

    python -m real_time_helmet_detection_tpu_torch.serving.runs \\
        --replicas 1 2 | --cascade | --streams [--out result.json]

Weights are seeded (`--seed`), images and frames too. Thresholds
default to the committed calibrations (`config.cascade_overrides()`,
`config.stream_overrides()`). `--device cpu` runs the same code on the
CPU at small sizes (the tests); otherwise the card is required.
Each `run_*` takes an optional `inspect(label, cfg, engines)` hook,
called once per configuration while its replicas are idle (the smoke
run counts their graphs' launches there).
"""

from __future__ import annotations

import argparse
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import (Config, apply_tier, cascade_overrides,
                      stream_overrides)
from ..evaluate import load_eval_state
from ..obs.metrics import MetricsRegistry
from ..obs.spans import SpanTracer
from ..ops.decode import confidence_summary
from ..ops.delta import (offset_detections, tile_delta_summary,
                         tile_origins, tile_shape)
from ..predict import make_predict_fn, resolve_device
from ..runtime import ChaosInjector, FaultEvent, FaultSchedule
from ..utils import save_json
from .engine import ServingEngine, SheddedError
from .fleet import FleetRouter, TenantSheddedError
from .loadgen import _lat_ms, arrival_schedule, closed_loop
from .streams import StreamSession

Inspect = Optional[Callable[[str, Config, List[ServingEngine]], None]]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- parts


def run_config(args, tier: str = "") -> Config:
    """The served configuration: the flagship (residual, 1 stack,
    `--inch` wide) or a named tier's preset, at `--imsize`, bf16 under
    `--amp`, seeded from `--seed`."""
    cfg = Config(device=args.device, imsize=args.imsize, amp=args.amp,
                 hourglass_inch=args.inch, random_seed=args.seed,
                 serve_buckets=list(args.buckets), tier=tier)
    return apply_tier(cfg) if tier else cfg


def make_predict(cfg: Config, cascade_summary: bool = False, state=None):
    """A `Predict` with a model of its own (seeded weights, or `state`
    loaded): a replica's reload copies into its own storages."""
    model = load_eval_state(cfg)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return make_predict_fn(model, cfg, normalize="imagenet",
                           device=cfg.device,
                           cascade_summary=cascade_summary)


def host_state(predict) -> Dict[str, torch.Tensor]:
    """The predict's weights as a CPU state dict (the fleet's stable
    checkpoint)."""
    return {k: v.detach().cpu().clone()
            for k, v in predict.model.state_dict().items()}


def perturbed(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Another checkpoint for a rollout: the first conv kernel shifted by
    a quarter (ref serve_bench.py `_perturb`)."""
    out = dict(state)
    key = next(k for k, v in state.items() if v.dim() == 4)
    out[key] = state[key] + 0.25
    return out


def image_pool(args, n: Optional[int] = None) -> List[np.ndarray]:
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, 256, (args.imsize, args.imsize, 3),
                         dtype=np.uint8) for _ in range(n or args.pool)]


def oracle_rows(predict, images: Sequence[np.ndarray],
                buckets: Sequence[int]) -> Dict:
    """{(b, i): row of image i in an eager predict at batch b} (the other
    rows zeros): what a graph of bucket b must serve for image i."""
    out = {}
    for b in buckets:
        for i, img in enumerate(images):
            batch = np.zeros((b,) + img.shape, np.uint8)
            batch[0] = img
            dets = predict(batch)
            # the eager oracle, made before any measured loop: one fetch
            # per image is its output
            out[(b, i)] = tuple(t[0].cpu().numpy()  # graftlint: off=device-get-in-loop,device-get-in-serving-loop
                                for t in dets)
    return out


def rows_equal(a, b) -> bool:
    """Leaf by leaf bit-equal, NaN where the other has NaN."""
    return len(a) == len(b) and all(np.array_equal(x, y, equal_nan=True)
                                    for x, y in zip(a, b))


def row_diff(row, want) -> Dict:
    """Where a row differs from the oracle's: per differing leaf, the
    elements that differ, the largest finite difference, NaNs."""
    out = {}
    for k, (x, y) in enumerate(zip(row, want)):
        x, y = np.asarray(x), np.asarray(y)
        if np.array_equal(x, y, equal_nan=True):
            continue
        bad = ~((x == y) | (np.isnan(x) & np.isnan(y))
                if x.dtype.kind == "f" else (x == y))
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))[bad]
        out[k] = {"differ": int(bad.sum()),
                  "max_abs": float(np.nanmax(d)) if d.size else 0.0,
                  "nan": int(np.isnan(d).sum())}
    return out


def make_replica_factory(make_rid_predict: Callable[[int], object],
                         image_shape, buckets_of: Callable[[int], Sequence],
                         queue_capacity: int = 64, max_wait_ms=2.0,
                         depth: int = 2, max_retries: int = 4,
                         injector_for: Optional[Dict[int, str]] = None,
                         tracer=None, build_s: Optional[List] = None):
    """The fleet's replica construction: `(rid, start) -> ServingEngine`
    over `make_rid_predict(rid)` (a predict of its own per replica and
    respawn) with `buckets_of(rid)`, its own MetricsRegistry and,
    optionally, its own chaos injector keyed by rid. `max_wait_ms` is a
    number or `rid -> number`. The wall time of each construction is
    appended to `build_s` when given."""
    tracer = tracer if tracer is not None else SpanTracer(None)

    def factory(rid, start=True):
        with tracer.span("replica-build", rid=rid) as sp:
            inj = None
            if injector_for and rid in injector_for:
                inj = ChaosInjector(FaultSchedule.parse(injector_for[rid]),
                                    tracer=tracer)
            wait = max_wait_ms(rid) if callable(max_wait_ms) \
                else max_wait_ms
            engine = ServingEngine(  # graftlint: off=engine-bypass-in-fleet
                make_rid_predict(rid), None, image_shape, np.uint8,
                buckets=buckets_of(rid), max_wait_ms=wait, depth=depth,
                queue_capacity=queue_capacity, max_retries=max_retries,
                metrics=MetricsRegistry(), injector=inj, tracer=tracer,
                start=start)
        if build_s is not None:
            build_s.append(sp.dur_s)
        return engine

    return factory


class TenantPin:
    """A submit shim that pins every request to one tenant, so the
    tenant-agnostic load loops drive a cascade tenant."""

    def __init__(self, router, tenant: str):
        self.router, self.tenant = router, tenant

    def submit(self, image, **kw):
        return self.router.submit(image, tenant=self.tenant, **kw)


def burst(router, pool, rounds: int = 2, seed: int = 0, **submit_kw):
    """Each pool image `rounds` times, with seeded pacing jitter (bursts
    of 1-6): [(image index, fleet future)]."""
    rng = np.random.default_rng(seed)
    futs = []
    order = [i for _ in range(rounds) for i in range(len(pool))]
    k = 0
    while k < len(order):
        n = int(rng.integers(1, 7))
        for i in order[k:k + n]:
            futs.append((i, router.submit(pool[i], **submit_kw)))
        k += n
        time.sleep(float(rng.uniform(0, 0.003)))
    return futs


def rows_against(futs, oracle) -> Dict:
    """Served rows against the oracle at the bucket that served each:
    {"rows", "equal", "replicas" (rids that answered)}."""
    equal, rids, misses = 0, set(), []
    for i, f in futs:
        row = tuple(f.result(timeout=120))
        want = oracle[(f.bucket, i)]
        if rows_equal(row, want):
            equal += 1
        elif len(misses) < 3:
            misses.append({"image": i, "bucket": f.bucket,
                           "leaves": row_diff(row, want)})
        rids.update(f.replicas[-1:])
    return {"rows": len(futs), "equal": equal, "replicas": sorted(rids),
            "misses": misses}


def rows_on_every_replica(router, pool, oracle, seed: int = 0,
                          attempts: int = 8) -> Dict:
    """`rows_against` over paced bursts until every replica has answered
    some (at most `attempts` bursts): a fleet-wide check of the rows."""
    total = {"rows": 0, "equal": 0, "replicas": [], "misses": []}
    for k in range(attempts):
        got = rows_against(burst(router, pool, rounds=2, seed=seed + k),
                           oracle)
        total["rows"] += got["rows"]
        total["equal"] += got["equal"]
        total["misses"] += got["misses"]
        total["replicas"] = sorted(set(total["replicas"])
                                   | set(got["replicas"]))
        if len(total["replicas"]) == router.replicas:
            break
    return total


def builds_of(router) -> List[int]:
    return [e.stats()["bucket_builds"] for e in router.engines]


def peak_gb(device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e9


# ---------------------------------------------------------------- fleet


def _traffic(router, pool, stop, pace_s, futs=None, lock=None):
    """Background traffic until `stop`: one request every `pace_s`."""
    k = 0
    while not stop.is_set():
        f = router.submit(pool[k % len(pool)])
        if futs is not None:
            with lock:
                futs.append((k % len(pool), f))
        k += 1
        time.sleep(pace_s)


def _wait_canary_armed(router, thread, timeout_s: float = 120.0) -> None:
    """Until the rollout thread has picked and reloaded its canary."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and thread.is_alive():
        if router.health()["canary"] is not None:
            return
        time.sleep(0.005)


def fleet_canary(args, factory, stable, new, pool, old_oracle,
                 new_oracle, pace_s: float) -> Dict:
    """A rollout of `new` at canary_frac 0.25 under traffic: promoted,
    then every replica serves the new weights' rows. Then, on a fleet
    whose replica 0 fails two dispatches (the canary of a quiescent
    fleet), a rollout at 0.9 rolls back on the canary's error burn, and
    every replica serves the old rows again."""
    out = {}
    router = FleetRouter(factory(), 2, variables=stable,
                         default_budget=1_000_000,
                         metrics=MetricsRegistry())
    try:
        stop = threading.Event()
        box = {}
        rt = threading.Thread(target=lambda: box.update(res=router.rollout(
            new, canary_frac=0.25, window=16, timeout_s=120)), daemon=True)
        rt.start()
        th = threading.Thread(target=_traffic,
                              args=(router, pool, stop, pace_s), daemon=True)
        th.start()
        rt.join(timeout=180)
        stop.set()
        th.join(timeout=30)
        after = rows_on_every_replica(router, pool, new_oracle, args.seed)
        st = router.stats()
        out["promote"] = dict(outcome=box["res"]["outcome"],
                              observed=box["res"]["observed"],
                              after=after, promotes=st["promotes"],
                              lost=st["lost"], builds=builds_of(router))
    finally:
        router.close()
    router = FleetRouter(
        # two dispatches in a row: the second is due while the first's
        # retry keeps the engine busy, so it fires before the rollback's
        # reload can finish; a fault after it would leave replica 0
        # DEGRADED, routed around by an idle fleet that never needs it
        factory(injector_for={0: "serve:dispatch=device-loss@2,"
                                 "serve:dispatch=device-loss@3"}),
        2, variables=stable, default_budget=1_000_000,
        metrics=MetricsRegistry())
    try:
        stop = threading.Event()
        box, futs, lock = {}, [], threading.Lock()
        rt = threading.Thread(target=lambda: box.update(res=router.rollout(
            new, canary_frac=0.9, window=10_000, timeout_s=120)),
            daemon=True)
        rt.start()
        _wait_canary_armed(router, rt)
        th = threading.Thread(target=_traffic,
                              args=(router, pool, stop, pace_s, futs, lock),
                              daemon=True)
        th.start()
        rt.join(timeout=180)
        stop.set()
        th.join(timeout=30)
        lost = during_equal = shed = 0
        for i, f in futs:
            try:
                row = f.result(timeout=120)
            except SheddedError:
                shed += 1
                continue
            except Exception:  # noqa: BLE001 - an acknowledged loss
                lost += 1
                continue
            during_equal += (rows_equal(row, old_oracle[(f.bucket, i)])
                             or rows_equal(row, new_oracle[(f.bucket, i)]))
        states = [e.state for e in router.engines]
        after = rows_on_every_replica(router, pool, old_oracle, args.seed)
        st = router.stats()
        res = box["res"]
        out["rollback"] = dict(
            outcome=res["outcome"], canary=res["canary"],
            alerts=[a.get("rule") for a in res["alerts"]],
            during=len(futs), during_equal=during_equal, shed=shed,
            lost_acks=lost, states=states, after=after,
            rollbacks=st["rollbacks"],
            lost=st["lost"], builds=builds_of(router))
    finally:
        router.close()
    return out


def fleet_routing(args, factory, pool, oracle) -> Dict:
    """Skewed load through the router on a paused fleet: 8 requests
    pinned to replica 0's tier ("pinned") make it the busy one, then
    tenant "b"'s 6 unpinned requests must all go to replica 1; tenant
    "a" (budget 2) bursts 5 and only it sheds. Started, every admitted
    request's row is the oracle's."""
    router = FleetRouter(factory(), 2, replica_tiers=["pinned", "free"],
                         tenants={"bulk": 64, "a": 2, "b": 8},
                         metrics=MetricsRegistry(), start=False)
    try:
        backlog = [(i % len(pool), router.submit(
            pool[i % len(pool)], tenant="bulk", tier="pinned"))
            for i in range(8)]
        fb = [(i % len(pool), router.submit(pool[i % len(pool)],
                                            tenant="b")) for i in range(6)]
        fa = [(i % len(pool), router.submit(pool[i % len(pool)],
                                            tenant="a")) for i in range(5)]
        b_replicas = [f.replicas for _, f in fb]
        a_shed = sum(f.done() for _, f in fa)
        a_tenant_shed = sum(isinstance(f.exception(), TenantSheddedError)
                            for _, f in fa)
        router.start()
        admitted = backlog + fb + [(i, f) for i, f in fa
                                   if f.exception() is None]
        rows = rows_against(admitted, oracle)
        h = router.health()
        return dict(b_replicas=b_replicas, a_shed=a_shed,
                    a_tenant_shed=a_tenant_shed,
                    tenants={t: {k: v[k] for k in ("shed", "completed")}
                             for t, v in h["tenants"].items()},
                    rows=rows, builds=builds_of(router))
    finally:
        router.close()


def fleet_death(args, factory, pool, oracle, build_s,
                expected: int) -> Dict:
    """A closed loop of `--clients` through 2 replicas during which a
    seeded `fleet:replica` worker-death kills one, at an arrival in the
    first quarter of the `expected` requests: every admitted request
    completes (lost 0), one respawn, the fresh engine captures each
    bucket once, rows stay the oracle's."""
    at = int(np.random.default_rng(args.seed).integers(
        2, max(3, expected // 4)))
    inj = ChaosInjector(FaultSchedule([FaultEvent("fleet:replica",
                                                  "worker-death", at)]))
    n0 = len(build_s)
    router = FleetRouter(factory(), 2, metrics=MetricsRegistry(),
                         default_budget=1_000_000, injector=inj)
    try:
        loop = closed_loop(router, pool, args.clients, args.duration)
        after = rows_on_every_replica(router, pool, oracle, args.seed)
        st = router.stats()
        h = router.health()
        return dict(at=at, fired=[e.key for e in inj.fired],
                    loop=loop, lost=st["lost"],
                    deaths=st["replica_deaths"], respawns=st["respawns"],
                    redispatched=st["redispatched"],
                    generations=[r["generation"] for r in h["replicas"]],
                    builds=builds_of(router), after=after,
                    respawn_build_s=build_s[n0 + 2:])
    finally:
        router.close()


def run_fleet_bench(args, inspect: Inspect = None) -> Dict:
    """The fleet at each `--replicas` N: a closed loop of `--clients`
    (images/s, p50/p99) and the rows of a paced burst against the oracle;
    then skewed routing and tenants, a replica's death during a closed
    loop, a canary promote and a rollback (module docstring)."""
    cfg = run_config(args)
    dev = resolve_device(cfg.device)
    buckets = tuple(sorted(set(cfg.serve_buckets)))
    pool = image_pool(args)
    base = make_predict(cfg)
    stable = host_state(base)
    new = perturbed(stable)
    old_oracle = oracle_rows(base, pool, buckets)
    new_oracle = oracle_rows(make_predict(cfg, state=new), pool, buckets)
    del base
    shape = (cfg.imsize, cfg.imsize, 3)
    build_s: List[float] = []

    def factory(**kw):
        return make_replica_factory(lambda rid: make_predict(cfg), shape,
                                    lambda rid: buckets,
                                    queue_capacity=max(64, args.clients),
                                    max_wait_ms=args.max_wait_ms,
                                    depth=args.depth, build_s=build_s,
                                    **kw)

    out: Dict = {"mode": "fleet", "device": str(dev),
                 "imsize": cfg.imsize, "inch": cfg.hourglass_inch,
                 "amp": cfg.amp, "buckets": list(buckets),
                 "clients": args.clients, "duration_s": args.duration,
                 "rows": []}
    for n in args.replicas:
        router = FleetRouter(factory(), n, metrics=MetricsRegistry(),
                             default_budget=1_000_000)
        try:
            if inspect is not None:
                inspect("fleet x%d" % n, cfg, router.engines)
            # a short unrecorded loop first: the measured one starts on
            # warm replicas, not on the inspection's tail
            closed_loop(router, pool, args.clients, args.duration / 4)
            loop = closed_loop(router, pool, args.clients, args.duration)
            rows = rows_against(burst(router, pool, seed=args.seed + n),
                                old_oracle)
            st = router.stats()
            row = dict(replicas=n, loop=loop, rows=rows, lost=st["lost"],
                       builds=builds_of(router))
        finally:
            router.close()
        out["rows"].append(row)
        log("fleet x%d: %.1f img/s closed loop (%d clients), p50 %s ms, "
            "p99 %s ms; %d of %d rows equal the oracle, lost %d"
            % (n, loop["goodput_rps"], args.clients, loop["p50_ms"],
               loop["p99_ms"], rows["equal"], rows["rows"], st["lost"]))
    # the last loop's rate sizes the death's arrival and, at half of it,
    # the rollouts' background traffic
    done = out["rows"][-1]["loop"]["completed"]
    rate = max(out["rows"][-1]["loop"]["goodput_rps"], 1.0)
    out["routing"] = fleet_routing(args, factory, pool, old_oracle)
    out["death"] = fleet_death(args, factory, pool, old_oracle, build_s,
                               done)
    out.update(fleet_canary(args, factory, stable, new, pool, old_oracle,
                            new_oracle, pace_s=2.0 / rate))
    out["engine_build_s"] = build_s
    out["peak_gb"] = peak_gb(dev)
    d, p, r = out["death"], out["promote"], out["rollback"]
    log("fleet death: %s; lost %d, respawns %d, builds %s; closed loop "
        "%.1f img/s, p99 %s ms; respawn built in %s s"
        % (d["fired"], d["lost"], d["respawns"], d["builds"],
           d["loop"]["goodput_rps"], d["loop"]["p99_ms"],
           d["respawn_build_s"]))
    log("fleet canary: promote %s (%d of %d rows the new weights'), "
        "rollback %s on %s (%d of %d rows the old weights', replicas %s; "
        "states after it %s)"
        % (p["outcome"], p["after"]["equal"], p["after"]["rows"],
           r["outcome"], r["alerts"], r["after"]["equal"],
           r["after"]["rows"], r["after"]["replicas"], r["states"]))
    return out


# -------------------------------------------------------------- cascade


def run_cascade_bench(args, inspect: Inspect = None) -> Dict:
    """Edge-first serving: rid 0 an edge-tier engine predicting with the
    confidence (`cascade_summary`), rid 1 a quality-tier engine, tenant
    "cascade" enrolled at the threshold (`--cascade-threshold`, else the
    calibrated one). Checks: the graph's confidence equals
    `confidence_summary` of the same rows on the host, tier-pinned rows
    equal each tier's oracle, cascade answers follow their confidence
    and equal the answering tier's oracle; an injected escalation fault
    degrades to the edge answer and a quality replica's death during
    escalation still delivers. Records the escalation rate, images/s and
    p50/p99 of a closed loop."""
    threshold = (args.cascade_threshold if args.cascade_threshold
                 is not None else cascade_overrides()["cascade_threshold"])
    tiers = list(args.cascade_tiers)
    cfgs = [run_config(args, t) for t in tiers]
    dev = resolve_device(cfgs[0].device)
    pool = image_pool(args)
    buckets = [tuple(sorted(set(c.serve_buckets))) for c in cfgs]
    oracle = [oracle_rows(make_predict(c, cascade_summary=(k == 0)), pool,
                          buckets[k]) for k, c in enumerate(cfgs)]
    shape = (cfgs[0].imsize, cfgs[0].imsize, 3)
    build_s: List[float] = []

    def factory(**kw):
        return make_replica_factory(
            lambda rid: make_predict(cfgs[rid], cascade_summary=rid == 0),
            shape, lambda rid: buckets[rid],
            queue_capacity=max(64, args.clients),
            max_wait_ms=lambda rid: cfgs[rid].serve_max_wait_ms,
            depth=args.depth, build_s=build_s, **kw)

    def router_at(th, **kw):
        return FleetRouter(factory(), 2, replica_tiers=tiers,
                           cascade_tenants=["cascade"],
                           cascade_tiers=tuple(tiers),
                           cascade_threshold=th, metrics=MetricsRegistry(),
                           default_budget=1_000_000, **kw)

    out: Dict = {"mode": "cascade", "device": str(dev),
                 "imsize": cfgs[0].imsize, "tiers": tiers,
                 "buckets": [list(b) for b in buckets],
                 "threshold": threshold, "clients": args.clients,
                 "duration_s": args.duration}
    router = router_at(threshold)
    try:
        if inspect is not None:
            for k, t in enumerate(tiers):
                inspect("cascade " + t, cfgs[k], router.engines[k:k + 1])
        # each tier on its own (an explicit tier opts out of the cascade)
        pinned = {}
        for k, t in enumerate(tiers):
            futs = burst(router, pool, seed=args.seed + k, tenant="cascade",
                         tier=t)
            pinned[t] = rows_against(futs, oracle[k])
            if k == 0:
                conf_equal = 0
                for _, f in futs:
                    row = f.result()
                    host = confidence_summary(torch.from_numpy(row.scores),
                                              torch.from_numpy(row.valid))
                    # CPU tensors: no device fetch
                    conf_equal += np.array_equal(host.numpy(),  # graftlint: off=device-get-in-loop,device-get-in-serving-loop
                                                 row.confidence)
                pinned[t]["confidence_equal"] = conf_equal
        # the cascade: answers follow the confidence
        futs = burst(router, pool, seed=args.seed + 7, tenant="cascade")
        res = {"rows": len(futs), "resolved": 0, "escalated": 0,
               "equal": 0, "follows_threshold": 0}
        for i, f in futs:
            row = f.result(timeout=120)
            if f.escalated:
                res["escalated"] += 1
                res["equal"] += rows_equal(row, oracle[1][(f.bucket, i)])
                res["follows_threshold"] += f.edge_confidence < threshold
            else:
                res["resolved"] += 1
                res["equal"] += rows_equal(row, oracle[0][(f.bucket, i)])
                res["follows_threshold"] += float(row.confidence) \
                    >= threshold
        st0 = router.stats()
        loop = closed_loop(TenantPin(router, "cascade"), pool,
                           args.clients, args.duration)
        st = router.stats()
        hops = (st["edge_resolved"] - st0["edge_resolved"]
                + st["escalated"] - st0["escalated"])
        out.update(pinned=pinned, cascade=res, loop=loop,
                   escalation_rate=((st["escalated"] - st0["escalated"])
                                    / max(hops, 1)),
                   lost=st["lost"], builds=builds_of(router))
    finally:
        router.close()
    # faults: every request escalates (a threshold above every edge
    # confidence of the pool, derived from the oracle), the second
    # escalation errors, the fifth kills the quality replica
    th_all = max(float(r[4]) for r in oracle[0].values()) + 1.0
    inj = ChaosInjector(FaultSchedule.parse(
        "fleet:escalate=device-loss@2,fleet:escalate=worker-death@5"))
    n0 = len(build_s)
    router = router_at(th_all, injector=inj)
    try:
        futs = [(k % len(pool), router.submit(pool[k % len(pool)],
                                              tenant="cascade"))
                for k in range(8)]  # past the 5th escalation
        faults = {"requests": len(futs), "lost_acks": 0, "degraded": 0,
                  "degraded_equal": 0, "quality_equal": 0}
        for i, f in futs:
            try:
                row = f.result(timeout=120)
            except Exception:  # noqa: BLE001 - an acknowledged loss
                faults["lost_acks"] += 1
                continue
            if f.degraded_answer:
                faults["degraded"] += 1
                faults["degraded_equal"] += rows_equal(
                    row, oracle[0][(f.bucket, i)])
            else:
                faults["quality_equal"] += rows_equal(
                    row, oracle[1][(f.bucket, i)])
        st = router.stats()
        faults.update(fired=[e.key for e in inj.fired], lost=st["lost"],
                      deaths=st["replica_deaths"], respawns=st["respawns"],
                      builds=builds_of(router),
                      respawn_build_s=build_s[n0 + 2:])
        out["faults"] = faults
    finally:
        router.close()
    out["peak_gb"] = peak_gb(dev)
    log("cascade at threshold %g: escalation rate %.4f; %.1f img/s "
        "closed loop (%d clients), p50 %s ms, p99 %s ms; faults %s"
        % (threshold, out["escalation_rate"], out["loop"]["goodput_rps"],
           args.clients, out["loop"]["p50_ms"], out["loop"]["p99_ms"],
           faults["fired"]))
    return out


# -------------------------------------------------------------- streams


def synth_stream_frames(args, sid: int, n_frames: int) -> List[np.ndarray]:
    """One seeded camera stream: frame 0 random uint8; each later frame
    keeps each tile with probability `--redundancy` and redraws it
    otherwise (ref serve_bench.py:1036, the same draws)."""
    rng = np.random.default_rng(args.seed * 1000 + 77 + sid)
    g = args.tile_grid
    fshape = (g * args.imsize, g * args.imsize, 3)
    origins = tile_origins(fshape, g)
    frames = [rng.integers(0, 256, fshape, dtype=np.uint8)]
    while len(frames) < n_frames:
        nxt = frames[-1].copy()
        for (y0, x0) in origins:
            if rng.random() >= args.redundancy:
                nxt[y0:y0 + args.imsize, x0:x0 + args.imsize] = \
                    rng.integers(0, 256, (args.imsize, args.imsize, 3),
                                 dtype=np.uint8)
        frames.append(nxt)
    return frames


def stream_closed_loop(sessions, seqs, duration_s: float) -> Dict:
    """Each stream submits its next frame when the last delivers: the
    sessions' frames/s at saturation (ref serve_bench.py:1059)."""
    stop = threading.Event()
    lock = threading.Lock()
    done = [0]

    def cam(si: int) -> None:
        sess, frames = sessions[si], seqs[si]
        k = 0
        while not stop.is_set():
            fut = sess.submit_frame(frames[k % len(frames)])
            k += 1
            fut.result(timeout=120)
            with lock:
                done[0] += 1

    threads = [threading.Thread(target=cam, args=(i,), daemon=True)
               for i in range(len(sessions))]
    with SpanTracer(None).span("streams:closed-loop") as sp:
        for t in threads:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=120)
    wall = sp.dur_s
    return {"streams": len(sessions), "duration_s": wall,
            "frames": done[0], "fps": done[0] / wall}


def stream_open_loop(sessions, seqs, schedules, duration_s: float,
                     deadline_s: float, offered_fps: float) -> Dict:
    """Seeded Poisson frame arrivals per stream (ref serve_bench.py
    `stream_open_loop`): goodput counts frames delivered within the
    deadline with no degraded tile; `lost` frames never delivered."""
    lock = threading.Lock()
    rows: List = []   # (latency_s, degraded_tiles, gap)
    delivered: List[List[int]] = [[] for _ in sessions]  # seqs, in order
    lost = [0]
    t0 = time.monotonic() + 0.05

    def cam(si: int) -> None:
        sess, frames, sched = sessions[si], seqs[si], schedules[si]
        futs = []
        for k, at in enumerate(sched):
            lag = t0 + at - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            arrive = t0 + at

            def stamp(f, arrive=arrive, si=si):
                res = f.result(timeout=0)
                with lock:
                    rows.append((f.t_done - arrive, res.degraded_tiles,
                                 res.gap))
                    delivered[si].append(res.seq)

            fut = sess.submit_frame(frames[k % len(frames)])
            fut.add_done_callback(stamp)
            futs.append(fut)
        grace = time.monotonic() + deadline_s + 5.0
        for f in futs:
            try:
                f.result(timeout=max(0.1, grace - time.monotonic()))
            except Exception:  # noqa: BLE001 - an undelivered frame
                with lock:
                    lost[0] += 1

    threads = [threading.Thread(target=cam, args=(i,), daemon=True)
               for i in range(len(sessions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with lock:
        got = list(rows)
    lats = [lat for lat, _, _ in got]
    ontime = sum(1 for lat, deg, gap in got
                 if lat <= deadline_s and deg == 0 and not gap)
    in_order = all(d == list(range(len(s)))
                   for d, s in zip(delivered, schedules))
    return {"offered_fps": offered_fps, "duration_s": duration_s,
            "in_order": in_order,
            "n": sum(len(s) for s in schedules), "completed": len(got),
            "ontime": ontime, "degraded": sum(1 for _, d, _ in got if d),
            "lost": lost[0], "deadline_ms": deadline_s * 1e3,
            "goodput_fps": ontime / duration_s, **_lat_ms(lats)}


def _tile_oracle_match(result, frame, origins, tile_hw, oracle_of) -> int:
    """Tiles of a delivered frame whose stitched block equals the oracle
    row of that tile (shifted to its origin) at one of the buckets."""
    th, tw = tile_hw
    n = len(result.detections.boxes) // len(origins)
    hits = 0
    for t, (y0, x0) in enumerate(origins):
        block = tuple(leaf[t * n:(t + 1) * n]
                      for leaf in result.detections)
        rows = oracle_of(np.ascontiguousarray(frame[y0:y0 + th,
                                                    x0:x0 + tw]))
        hits += any(rows_equal(block, tuple(offset_detections(
            type(result.detections)(*r[:4]), y0, x0))) for r in rows)
    return hits


def run_streams_bench(args, inspect: Inspect = None) -> Dict:
    """`--streams-n` seeded streams of (grid * imsize)^2 uint8 frames at
    `--redundancy`, through sessions over an edge-tier engine behind a
    one-replica fleet. Checks: the card's delta summary equals the CPU's
    on every frame pair; a first frame computes every tile, its copy
    none; an all-changed frame's stitched answer equals the tile oracle;
    frames deliver in order; injected frame faults and a failed tile
    deliver from the cache. Records frames/s gated against ungated at
    the same offered rate, and the tile skip rate."""
    threshold = (args.stream_threshold if args.stream_threshold
                 is not None else stream_overrides()["stream_threshold"])
    cfg = run_config(args, "edge")
    dev = resolve_device(cfg.device)
    buckets = tuple(sorted(set(cfg.serve_buckets)))
    g = args.tile_grid
    fshape = (g * cfg.imsize, g * cfg.imsize, 3)
    origins = tile_origins(fshape, g)
    tile_hw = tile_shape(fshape, g)
    deadline_s = args.deadline_ms / 1e3
    seqs = [synth_stream_frames(args, sid, args.stream_frames)
            for sid in range(args.streams_n)]
    out: Dict = {"mode": "streams", "device": str(dev),
                 "tile_imsize": cfg.imsize, "frame": list(fshape),
                 "tier": "edge", "buckets": list(buckets),
                 "streams": args.streams_n, "redundancy": args.redundancy,
                 "threshold": threshold}
    # the card's summary against the CPU's, every consecutive pair
    pairs = equal = 0
    for frames in seqs:
        for a, b in zip(frames, frames[1:]):
            a, b = torch.from_numpy(a), torch.from_numpy(b)
            # the card's summary checked against the CPU's, before the
            # measured loops
            got = tile_delta_summary(a.to(dev), b.to(dev), g).cpu()  # graftlint: off=device-get-in-loop,device-get-in-serving-loop
            pairs += 1
            equal += torch.equal(got, tile_delta_summary(a, b, g))
    out["delta"] = {"pairs": pairs, "equal": equal}

    predict = make_predict(cfg)

    def oracle_of(tile):
        return [tuple(t[0].cpu().numpy() for t in predict(np.concatenate(
            [tile[None], np.zeros((b - 1,) + tile.shape, np.uint8)])))
            for b in buckets]

    build_s: List[float] = []

    def fleet(**kw):
        # the tiles are one tenant's traffic: no SLO penalty box, so a
        # failed tile degrades that tile, not the frames after it
        return FleetRouter(
            make_replica_factory(lambda rid: make_predict(cfg),
                                 tile_hw + (3,), lambda rid: buckets,
                                 max_wait_ms=cfg.serve_max_wait_ms,
                                 depth=args.depth, build_s=build_s,
                                 max_retries=kw.pop("max_retries", 4),
                                 injector_for=kw.pop("injector_for", None)),
            1, metrics=MetricsRegistry(), default_budget=1_000_000,
            tenant_shed_requests=0, **kw)

    def sessions(router, th, **kw):
        return [StreamSession(router, fshape, grid=g, threshold=th,
                              deadline_s=kw.get("deadline_s"),
                              ema=kw.get("ema", 0.5), sid=sid,
                              injector=kw.get("injector"), device=dev)
                for sid in range(kw.get("n", args.streams_n))]

    router = fleet()
    try:
        if inspect is not None:
            inspect("streams edge", cfg, router.engines)
        # gating: a first frame computes all, its copy none; an
        # all-changed frame equals the tile oracle
        sess = sessions(router, threshold, ema=0.0, n=1)[0]
        rng = np.random.default_rng(args.seed + 5)
        f0 = seqs[0][0]
        f1 = rng.integers(0, 256, fshape, dtype=np.uint8)
        r0 = sess.submit_frame(f0).result(timeout=120)
        r1 = sess.submit_frame(f0.copy()).result(timeout=120)
        r2 = sess.submit_frame(f1).result(timeout=120)
        sess.close()
        out["gating"] = dict(
            first_computed=r0.computed_tiles, copy_computed=r1.computed_tiles,
            copy_same=rows_equal(tuple(r1.detections), tuple(r0.detections)),
            changed_computed=r2.computed_tiles, tiles=len(origins),
            first_oracle=_tile_oracle_match(r0, f0, origins, tile_hw,
                                            oracle_of),
            changed_oracle=_tile_oracle_match(r2, f1, origins, tile_hw,
                                              oracle_of))
        # ungated capacity (every tile computes: no delta is below -inf)
        ungated = -math.inf
        ss = sessions(router, ungated)
        closed = stream_closed_loop(ss, seqs, args.duration)
        for s in ss:
            s.close()
        rate = args.stream_load * max(closed["fps"], 1e-6)
        schedules = [arrival_schedule(rate / args.streams_n, args.duration,
                                      args.seed + 1700 + sid)
                     for sid in range(args.streams_n)]
        arms = {}
        for arm, th in (("ungated", ungated), ("gated", threshold)):
            ss = sessions(router, th, deadline_s=deadline_s)
            arms[arm] = stream_open_loop(ss, seqs, schedules,
                                         args.duration, deadline_s, rate)
            sts = [s.stats() for s in ss]
            for s in ss:
                s.close()
            computed = sum(st["computed_tiles"] for st in sts)
            skipped = sum(st["skipped_tiles"] for st in sts)
            arms[arm]["tile_skip_rate"] = skipped / max(computed + skipped,
                                                        1)
        out.update(capacity_ungated=closed, offered_fps=rate, arms=arms,
                   in_order=all(a["in_order"] for a in arms.values()),
                   tile_skip_rate=arms["gated"]["tile_skip_rate"],
                   goodput_ratio=arms["gated"]["goodput_fps"]
                   / max(arms["ungated"]["goodput_fps"], 1e-6),
                   builds=builds_of(router))
    finally:
        router.close()
    # faults: a dropped, a corrupt and a late frame, and the tiles of a
    # batch that fails with no retry left (no re-dispatch): all deliver.
    # Two distinct frames in turns: every frame computes every tile.
    inj = ChaosInjector(FaultSchedule.parse(
        "stream:frame=dropped-frame@3,stream:frame=corrupt-frame@5,"
        "stream:frame=late-frame@7"))
    router = fleet(max_retries=0, max_redispatch=0,
                   injector_for={0: "serve:dispatch=device-loss@4"})
    try:
        sess = sessions(router, threshold, injector=inj, n=1)[0]
        futs = [sess.submit_frame(f) for f in [f0, f1] * 5]
        lost = 0
        seqs_got = []
        for f in futs:
            try:
                seqs_got.append(f.result(timeout=120).seq)
            except Exception:  # noqa: BLE001 - an undelivered frame
                lost += 1
        st = sess.stats()
        sess.close()
        out["faults"] = dict(frames=len(futs), lost=lost,
                             in_order=seqs_got == sorted(seqs_got),
                             fired=[e.key for e in inj.fired],
                             gaps=st["gaps"], corrupt=st["corrupt"],
                             late=st["late"],
                             degraded_tiles=st["degraded_tiles"],
                             delivered=st["delivered"])
    finally:
        router.close()
    out["engine_build_s"] = build_s
    out["peak_gb"] = peak_gb(dev)
    log("streams: %d x %s frames at redundancy %g, threshold %g: gated "
        "%.1f vs ungated %.1f frames/s on time at %.1f offered (capacity "
        "ungated %.1f), tile skip rate %.4f; delta card = CPU on %d of %d "
        "pairs" % (args.streams_n, "x".join(map(str, fshape[:2])),
                   args.redundancy, threshold,
                   arms["gated"]["goodput_fps"],
                   arms["ungated"]["goodput_fps"], rate, closed["fps"],
                   out["tile_skip_rate"], equal, pairs))
    return out


# ----------------------------------------------------------------- main


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.serving.runs",
        description="fleet, cascade and streams runs of the serving plane")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--replicas", type=int, nargs="+",
                      help="fleet runs at these replica counts")
    mode.add_argument("--cascade", action="store_true",
                      help="edge-first cascade over two tiers")
    mode.add_argument("--streams", action="store_true",
                      help="delta-gated streaming video")
    p.add_argument("--device", default="cuda")
    p.add_argument("--imsize", type=int, default=512)
    p.add_argument("--inch", type=int, default=128,
                   help="the flagship's width (tiers set their own)")
    p.add_argument("--amp", action=argparse.BooleanOptionalAction,
                   default=True, help="bf16 (default) or f32")
    p.add_argument("--buckets", type=int, nargs="+",
                   default=[1, 2, 4, 8, 16],
                   help="the flagship's buckets (tiers set their own)")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--duration", type=float, default=2.0,
                   help="seconds of each load loop")
    p.add_argument("--pool", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cascade-threshold", type=float, default=None,
                   help="default: config.cascade_overrides()")
    p.add_argument("--cascade-tiers", nargs=2, default=["edge", "quality"])
    p.add_argument("--stream-threshold", type=float, default=None,
                   help="default: config.stream_overrides()")
    p.add_argument("--streams-n", type=int, default=4)
    p.add_argument("--stream-frames", type=int, default=24)
    p.add_argument("--redundancy", type=float, default=0.75)
    p.add_argument("--tile-grid", type=int, default=2)
    p.add_argument("--stream-load", type=float, default=2.0,
                   help="offered frame rate, in units of the ungated "
                   "capacity")
    p.add_argument("--deadline-ms", type=float, default=600.0)
    p.add_argument("--out", default=None, help="write the record here")
    return p


def main(argv=None, inspect: Inspect = None) -> Dict:
    args = build_parser().parse_args(argv)
    if args.replicas:
        out = run_fleet_bench(args, inspect)
    elif args.cascade:
        out = run_cascade_bench(args, inspect)
    else:
        out = run_streams_bench(args, inspect)
    if args.out:
        save_json(args.out, out, indent=1, sort_keys=True, default=str)
    return out


if __name__ == "__main__":
    main()
