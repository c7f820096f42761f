"""serve_bench for the card: the engine's load curve against the serial
server, the fleet, cascade and streams runs, tail exemplars, fault
replay and the selfcheck.

Port of ref scripts/serve_bench.py:182-2439 (`arm_trace_log` :182,
`trace_sections` :194, `make_replica_factory` :463, `fleet_scaling_rows`
:498, `run_fleet_bench` :715, `run_cascade_bench` :862,
`synth_stream_frames` :1036, `run_streams_bench` :1241, `build_parts`
:1376, `run_bench` :1417, `main` :2231), with JAX's flags, defaults and
record schemas. The load loops are `serving/loadgen.py`'s; the
simulated replicas `serving/sim.py`'s; the selfcheck
`serving/selfcheck.py`'s.

    python -m real_time_helmet_detection_tpu_torch.serving.runs \\
        [--replicas N [N ...] | --cascade | --streams | --selfcheck] \\
        [--device cuda|cpu] [--out record.json]

Modes (one record each, JAX's schema and keys):

* **engine** (no mode flag; `serve-bench-v1`): the seeded flagship at
  `--inch` (`--infer-dtype int8`: the int8 twin with synthetic
  calibration) in one `ServingEngine`; the serial batch-1 server's
  capacity (one bucket-1 graph, one request at a time); the engine's
  closed loop; open loops at `--loads` x its capacity, with `--faults`
  replayed at `serve:dispatch` / `serve:fetch`; a fresh metrics registry
  and SLO watchdog; the serial server on the past-saturation trace;
  `goodput_vs_serial_at_overload` and `gate_3x`. The port adds
  `rows_check`: every answered request's row against the eager predict
  of its image at the bucket that served it.
* **fleet** (`--replicas`; `serve-bench-fleet-v1`): JAX's scaling rows,
  open loops at `--fleet-load` x N x the per-replica capacity over
  `SimServePredict` replicas (`--replica-sim-ms`; 0: flagship engines on
  the card), `canary` and `death`, gates. The port's real-engine runs
  (`engine`): per-N closed loops with rows against the oracle, skewed
  routing and tenants, a replica's death in a closed loop, a canary
  promote and a rollback.
* **cascade** (`--cascade`; `serve-bench-cascade-v1`): all-quality (two
  quality sims) against a cascade of an edge sim (`--cascade-edge-ms`,
  confidence pixel[0,0,0]/255) and a quality sim, on one seeded trace at
  `--cascade-load` x the all-quality capacity, at the sim threshold
  `--cascade-threshold`; the escalation-fault replay. The port's
  real-engine cascade (`engine`) at `config.cascade_overrides()`.
* **streams** (`--streams`; `serve-bench-streams-v1`): the full arm
  against the delta-gated arm over `SimStreamPredict` tile replicas
  (`--tile-sim-ms` per tile), at `--stream-load` x the full arm's
  capacity, sim threshold `--stream-threshold`; the frame-fault replay.
  The port's real-engine streams (`engine`) at
  `config.stream_overrides()`.

The sims are a service model: a fixed sleep per batch (per tile for the
streams), rows from the image bytes. What their rows measure is the
router's and the engine's host cost, never the card; their sections
say so (`replica_sim_ms`, `edge_sim_ms`, `tile_sim_ms`, `note`).

Every mode with `--trace-exemplars N` (default 3) arms a span log (a
temporary one when `--span-log` and $OBS_SPAN_LOG are unset) and adds
`trace_exemplars` (the N slowest requests' waterfalls), `trace_summary`,
`exemplar_p99_stage` and `gate_traces_complete` (no orphan, no broken
chain). A run with a span log measures with tracing on.

Weights, images and frames are seeded (`--seed`). It runs on the card
and raises without one unless `--device cpu` (or `--cpu`) is given,
where the defaults are JAX's CPU ones (64^2, width 16, top-k 32, f32).
Logs go to stderr; `main` writes the record to `--out` (default
`serve_bench_out/<name>.json` in the repo) and prints it as one JSON
line, the last of stdout. The `run_*` functions return the record and
print nothing to stdout; each takes an optional `inspect(label, cfg,
engines)` hook, called once per configuration of real engines while
they are idle (the card check counts their graphs' launches there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import (Config, apply_tier, cascade_overrides,
                      stream_overrides)
from ..evaluate import load_eval_state
from ..obs.metrics import MetricsRegistry
from ..obs.slo import SloWatchdog, default_serving_rules
from ..obs.spans import SpanTracer, maybe_tracer
from ..ops.decode import confidence_summary
from ..ops.delta import (offset_detections, tile_delta_summary,
                         tile_origins, tile_shape)
from ..predict import BucketRunner, make_predict_fn, resolve_device
from ..runtime import (CASCADE_SITES, FLEET_SITES, STREAM_SITES,
                       ChaosInjector, FaultSchedule, maybe_injector,
                       maybe_job_heartbeat, run_as_job)
from ..utils import save_json
from .engine import ServingEngine, SheddedError
from .fleet import FleetRouter, TenantSheddedError
from .loadgen import (_lat_ms, arrival_schedule, closed_loop, open_loop,
                      serial_loop)
from .sim import (SimCascadePredict, SimServePredict, SimStreamPredict,
                  sim_confidence, sim_pool)
from .streams import StreamSession

SCHEMA = "serve-bench-v1"
FLEET_SCHEMA = "serve-bench-fleet-v1"
CASCADE_SCHEMA = "serve-bench-cascade-v1"
STREAMS_SCHEMA = "serve-bench-streams-v1"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT_DIR = os.path.join(REPO, "serve_bench_out")

Inspect = Optional[Callable[[str, Config, List[ServingEngine]], None]]


def log(msg: str) -> None:
    print("[serve_bench] %s" % msg, file=sys.stderr, flush=True)


def beat(label: str) -> None:
    """A beat of the job's heartbeat when a supervisor runs this one
    (`runtime.run_as_job`), else nothing."""
    maybe_job_heartbeat().beat(label)


def platform_of(device) -> str:
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


# ---------------------------------------------------------------- parts


def run_config(args, tier: str = "") -> Config:
    """The served configuration: a named tier's preset (its weights
    seeded from `--seed`), or the flagship (residual, 1 stack, `--inch`
    wide, `--topk`, confidence threshold 0, NMS 0.5, `--infer-dtype`, its
    weights from seed 0 whatever `--seed`, which seeds the images: ref
    serve_bench.py `build_parts`), at `--imsize`, bf16 under `--amp`."""
    if tier:
        return apply_tier(Config(device=args.device, imsize=args.imsize,
                                 amp=args.amp, random_seed=args.seed,
                                 tier=tier))
    return Config(device=args.device, imsize=args.imsize, amp=args.amp,
                  num_stack=1, hourglass_inch=args.inch, num_cls=2,
                  topk=args.topk, conf_th=0.0, nms_th=0.5,
                  infer_dtype=args.infer_dtype, random_seed=0,
                  serve_buckets=list(args.buckets))


def calibration(cfg: Config) -> Optional[Dict]:
    """The int8 activation scales of the seeded model of `cfg`, from two
    synthetic uint8 batches of the largest bucket (ref serve_bench.py
    `build_parts`); None unless `--infer-dtype int8`."""
    if cfg.infer_dtype != "int8":
        return None
    from ..ops.quant import calibrate_scales, synthetic_calibration_batches
    model = load_eval_state(cfg)
    return calibrate_scales(
        cfg, model.state_dict(),
        synthetic_calibration_batches(max(cfg.serve_buckets), cfg.imsize,
                                      n=2, raw=True),
        dtype=model.dtype, normalize="imagenet", device=cfg.device)


def make_predict(cfg: Config, cascade_summary: bool = False, state=None,
                 scales=None):
    """A `Predict` with a model of its own (seeded weights, or `state`
    loaded; the int8 twin with `scales`): a replica's reload copies into
    its own storages."""
    model = load_eval_state(cfg)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return make_predict_fn(model, cfg, normalize="imagenet",
                           device=cfg.device, quant_scales=scales,
                           cascade_summary=cascade_summary)


def float_state(cfg: Config) -> Dict[str, torch.Tensor]:
    """The seeded float model's weights as a CPU state dict (the fleet's
    stable checkpoint; an int8 replica folds it on reload)."""
    return {k: v.detach().cpu().clone()
            for k, v in load_eval_state(cfg).state_dict().items()}


def perturbed(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Another checkpoint for a rollout: the first conv kernel shifted by
    a quarter (ref serve_bench.py `_perturb`)."""
    out = dict(state)
    key = next(k for k, v in state.items() if v.dim() == 4)
    out[key] = state[key] + 0.25
    return out


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
    respawn, or a sim) with `buckets_of(rid)`, its own MetricsRegistry
    and, optionally, its own chaos injector keyed by rid. `max_wait_ms`
    is a number or `rid -> number`. The wall time of each construction
    is appended to `build_s` when given."""
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


class Recorder:
    """A submit shim that keeps (pool index, future) of every request a
    load loop makes from `pool`, for checks after the loop (`take`)."""

    def __init__(self, server, pool: Sequence[np.ndarray]):
        self.server = server
        self._index = {id(img): i for i, img in enumerate(pool)}
        self._futs: List = []
        self._lock = threading.Lock()

    def submit(self, image, **kw):
        fut = self.server.submit(image, **kw)
        with self._lock:
            self._futs.append((self._index[id(image)], fut))
        return fut

    def take(self) -> List:
        """The recorded (index, future) pairs so far; forgets them."""
        with self._lock:
            futs, self._futs = self._futs, []
        return futs


def answered(futs) -> List:
    """The (index, future) pairs whose future holds a result."""
    return [(i, f) for i, f in futs if f.done() and f.exception() is None]


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
    {"rows", "equal", "replicas" (rids that answered, fleet futures),
    "misses" (the first three)}."""
    equal, rids, misses = 0, set(), []
    for i, f in futs:
        row = tuple(f.result(timeout=120))
        want = oracle[(f.bucket, i)]
        if rows_equal(row, want):
            equal += 1
        elif len(misses) < 3:
            misses.append({"image": i, "bucket": f.bucket,
                           "leaves": row_diff(row, want)})
        rids.update(getattr(f, "replicas", [])[-1:])
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


def fault_schedule(args, sites, n: int, max_at: int,
                   default: str) -> FaultSchedule:
    """A mode's fault-run schedule: `--faults` when given (its `seed=N[,
    n=K]` shorthand drawn over `sites`), else the canned `default`
    (ref serve_bench.py `fleet_death_run`, `cascade_fault_run`)."""
    spec = (args.faults or "").strip()
    if spec.startswith("seed="):
        opts = dict(p.split("=", 1) for p in spec.split(",") if "=" in p)
        return FaultSchedule.seeded(int(opts["seed"]),
                                    n=int(opts.get("n", n)), sites=sites,
                                    max_at=max_at)
    return FaultSchedule.parse(spec or default)


# -------------------------------------------------------------- traces


class _ScratchTracer(SpanTracer):
    """A span log in a temporary directory of its own, removed once
    `trace_sections` has read it."""

    def __init__(self):
        self.scratch_dir = tempfile.mkdtemp(prefix="serve_bench_trace.")
        super().__init__(os.path.join(self.scratch_dir, "spans.jsonl"))


def arm_trace_log(args, tracer: SpanTracer) -> SpanTracer:
    """Tail exemplars need span records: with `--trace-exemplars` > 0 and
    no span log configured, a temporary one (the waterfalls land in the
    record; the raw log is scratch)."""
    if args.trace_exemplars > 0 and not tracer.enabled:
        return _ScratchTracer()
    return tracer


def trace_sections(tracer: SpanTracer, n: int):
    """(trace_exemplars, trace_summary) of the run's span log: the N
    slowest requests' waterfalls and the completeness analysis (orphans
    and broken chains are hard errors); (None, None) when tracing never
    armed. Closes the tracer."""
    if not tracer.enabled or n <= 0:
        return None, None
    from ..obs import traceview
    tracer.close()
    traces = traceview.assemble_logs([tracer.path])
    summary = traceview.analyze(traces)
    exemplars = traceview.tail_exemplars(traces, n)
    if isinstance(tracer, _ScratchTracer):
        shutil.rmtree(tracer.scratch_dir, ignore_errors=True)
    return {"n": n, "exemplars": exemplars}, summary


def add_trace_sections(out: Dict, tracer: SpanTracer, n: int) -> None:
    """`trace_exemplars`, `trace_summary`, `exemplar_p99_stage` (the
    dominant stage of the slowest exemplar) and `gate_traces_complete`
    into a record."""
    exemplars, summary = trace_sections(tracer, n)
    if exemplars is None:
        return
    out["trace_exemplars"] = exemplars
    out["trace_summary"] = summary
    if exemplars["exemplars"]:
        out["exemplar_p99_stage"] = \
            exemplars["exemplars"][0]["critical_path"]["dominant_stage"]
    out["gate_traces_complete"] = bool(
        summary["orphans"] == 0 and summary["broken_chains"] == 0
        and summary["request_traces"] > 0)
    log("trace gate: %d request traces, orphans %d, broken %d, "
        "redispatched %d, p99 stage %s"
        % (summary["request_traces"], summary["orphans"],
           summary["broken_chains"], summary["redispatched_traces"],
           out.get("exemplar_p99_stage")))


# --------------------------------------------------------------- engine


def build_parts(args):
    """(cfg, predict, image pool) at the bench configuration: the seeded
    flagship on the raw uint8 wire (normalization on the device), the
    int8 twin when asked (ref serve_bench.py:1376)."""
    cfg = run_config(args)
    predict = make_predict(cfg, scales=calibration(cfg))
    return cfg, predict, sim_pool(args)


def serial_server(predict, cfg: Config):
    """The status-quo server's program: one bucket-1 runner (on CUDA a
    graph), `b1(images) -> Detections` for one (1, H, W, 3) request."""
    runner = BucketRunner(predict, 1, (cfg.imsize, cfg.imsize, 3),
                          torch.uint8)

    def b1(images):
        runner.input.copy_(torch.from_numpy(np.ascontiguousarray(images)))
        return runner.run()

    return runner, b1


def drain_schedule(rec: Recorder, pool, injector) -> Dict:
    """Keep the load going after the loops until every scheduled fault
    has fired, whatever the host's speed: one round submits the pool and
    waits for every answer, so it dispatches and fetches at least one
    batch (a faulted batch is dispatched and fetched again), and the
    schedule's largest trigger bounds the rounds. Rounds and requests it
    took, and the admitted requests that surfaced an error (`lost`)."""
    bound = max((e.at for e in injector.schedule), default=0)
    out = {"rounds": 0, "requests": 0, "lost": 0}
    while injector.pending() and out["rounds"] < bound:
        futs = [rec.submit(img) for img in pool]
        for fut in futs:
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - an admitted request lost
                out["lost"] += 1
        out["rounds"] += 1
        out["requests"] += len(futs)
    if injector.pending():
        raise RuntimeError("fault schedule %s: %d events never fired in %d "
                           "rounds" % (injector.schedule.spec(),
                                       injector.pending(), out["rounds"]))
    return out


def run_bench(args, inspect: Inspect = None) -> Dict:
    """The engine's goodput against offered load, with the serial
    batch-1 server as the baseline (ref serve_bench.py:1417; module
    docstring)."""
    dev = resolve_device(args.device)
    platform = platform_of(dev)
    log("device up: %s (engine mode)" % dev)
    beat("device up (%s)" % platform)
    tracer = arm_trace_log(args, maybe_tracer(args.span_log or None))
    cfg, predict, pool = build_parts(args)
    buckets = tuple(sorted(set(cfg.serve_buckets)))
    out: Dict = {"schema": SCHEMA, "tool": "serve_bench",
                 "platform": platform, "device": str(dev),
                 "imsize": args.imsize, "inch": args.inch,
                 "topk": args.topk, "amp": args.amp,
                 "infer_dtype": args.infer_dtype, "buckets": list(buckets),
                 "max_wait_ms": args.max_wait_ms, "depth": args.depth,
                 "queue_cap": args.queue_cap, "seed": args.seed}
    oracle = oracle_rows(predict, pool, buckets)

    # serial b1 capacity: the status-quo server's throughput ceiling
    with tracer.span("serve-bench:serial-compile"):
        _, b1 = serial_server(predict, cfg)
    b1(pool[0][None]).scores.cpu()  # warm
    n = 30
    with tracer.span("serve-bench:serial-capacity", n=n) as sp:
        for i in range(n):
            # the serial server: each request's own fetch completes it
            b1(pool[i % len(pool)][None]).scores.cpu()  # graftlint: off=device-get-in-loop,device-get-in-serving-loop
    serial_rps = n / sp.dur_s
    out["serial_b1_rps"] = serial_rps
    log("serial b1 capacity: %.1f req/s" % serial_rps)
    beat("serial capacity measured")

    # --faults: the seeded schedule fires at serve:dispatch / serve:fetch
    # while the same load loops run: `lost` proves recovery kept every
    # acknowledged request
    injector = maybe_injector(args.faults, tracer=tracer)
    if injector is not None:
        out["faults_spec"] = injector.schedule.spec()
        log("fault injection armed: %s" % out["faults_spec"])
    # a fresh registry per run (the record's snapshot is this run's
    # evidence alone); the watchdog's alerts land in the span log too
    mreg = MetricsRegistry()
    slo = SloWatchdog(default_serving_rules(deadline_ms=args.deadline_ms),
                      registry=mreg, tracer=tracer)
    # one engine, no fleet: the load curve measures the engine itself
    server = ServingEngine(  # graftlint: off=engine-bypass-in-fleet
        predict, None, (args.imsize, args.imsize, 3), np.uint8,
        buckets=buckets, max_wait_ms=args.max_wait_ms, depth=args.depth,
        queue_capacity=args.queue_cap, tracer=tracer,
        max_retries=args.max_retries,
        hang_timeout_s=(args.hang_timeout_ms / 1e3
                        if args.hang_timeout_ms > 0 else None),
        injector=injector, metrics=mreg, watchdog=slo)
    checked = {"rows": 0, "equal": 0, "misses": []}
    rec = Recorder(server, pool)

    def check_rows():
        got = rows_against(answered(rec.take()), oracle)
        checked["rows"] += got["rows"]
        checked["equal"] += got["equal"]
        checked["misses"] = (checked["misses"] + got["misses"])[:3]

    deadline_s = args.deadline_ms / 1e3
    try:
        if inspect is not None:
            inspect("engine", cfg, [server])
        warm = server.predict_many(pool[:min(4, len(pool))])
        assert len(warm) == min(4, len(pool))
        closed = closed_loop(rec, pool, args.clients, args.duration,
                             tracer=tracer)
        check_rows()
        out["closed"] = closed
        capacity = max(closed["goodput_rps"], 1e-6)
        out["engine_capacity_rps"] = closed["goodput_rps"]
        out["batch_capacity_ratio"] = capacity / serial_rps
        log("engine capacity (closed, %d clients): %.1f req/s (%.2fx "
            "serial b1)" % (args.clients, capacity, capacity / serial_rps))
        beat("closed loop done")
        curve = []
        for mult in args.loads:
            rate = mult * capacity
            sched = arrival_schedule(rate, args.duration,
                                     args.seed + int(mult * 1000))
            row = open_loop(rec, pool, sched, args.duration, deadline_s,
                            rate)
            check_rows()
            row["load_multiplier"] = mult
            curve.append(row)
            log("open loop x%.2f (%.1f rps offered): goodput %.1f, p50 %s "
                "ms, p99 %s ms, shed %d, lost %d"
                % (mult, rate, row["goodput_rps"], row["p50_ms"],
                   row["p99_ms"], row["shed"], row["lost"]))
            beat("open loop x%.2f done" % mult)
        out["curve"] = curve
        if injector is not None:
            drain = drain_schedule(rec, pool, injector)
            check_rows()
            st = server.stats()
            out["faults"] = {
                "spec": injector.schedule.spec(),
                "injected": injector.summary(),
                "retried": st["retried"],
                "requeued_batches": st["requeued_batches"],
                "hung_batches": st["hung_batches"],
                "lost_acks": sum(r.get("lost", 0) for r in curve)
                + drain["lost"],
                "engine_state": server.state,
                "drain": drain,
            }
            log("faults: injected %d, retried %d, lost acks %d"
                % (out["faults"]["injected"]["total"],
                   out["faults"]["retried"], out["faults"]["lost_acks"]))
    finally:
        server.close()
    out["rows_check"] = checked
    log("rows: %d of %d answered rows equal the eager predict at their "
        "bucket" % (checked["equal"], checked["rows"]))

    # the final metrics snapshot and the dashboard aggregates
    st = server.stats()
    out["metrics"] = mreg.snapshot()
    out["shed_total"] = st["shed_queue_full"] + st["shed_deadline"]
    out["retried"] = st["retried"]
    out["bucket_builds"] = st["bucket_builds"]
    slots = mreg.counter("serve.batch_slots").value
    out["mean_batch_fill"] = (1.0 - st["padded_slots"] / slots
                              if slots else None)
    out["slo_alerts"] = [a["rule"] for a in slo.alerts]
    log("metrics: shed %d, retried %d, mean fill %s, alerts %s"
        % (out["shed_total"], out["retried"], out["mean_batch_fill"],
           out["slo_alerts"] or "none"))

    # the serial server under the same past-saturation arrival trace
    over = max(args.loads)
    rate = over * capacity
    sched = arrival_schedule(rate, args.duration,
                             args.seed + int(over * 1000))
    out["serial_overload"] = serial_loop(b1, pool, sched, args.duration,
                                         deadline_s, rate)
    beat("serial overload done")
    add_trace_sections(out, tracer, args.trace_exemplars)

    eng_over = next(r for r in curve if r["load_multiplier"] == over)
    ratio = eng_over["goodput_rps"] / max(
        out["serial_overload"]["goodput_rps"], 1e-6)
    out["goodput_vs_serial_at_overload"] = ratio
    out["gate_3x"] = bool(ratio >= 3.0)
    out["note"] = ("goodput = on-time completions/s under a %.0f ms "
                   "deadline; past saturation the serial b1 server's "
                   "unbounded FIFO delay misses every deadline while the "
                   "engine sheds at admission and keeps serving%s"
                   % (args.deadline_ms, "; measured with tracing on (a "
                      "span log)" if tracer.enabled else ""))
    out["peak_gb"] = peak_gb(dev)
    log("goodput at %.1fx saturation: engine %.1f vs serial %.1f rps "
        "(%.1fx, gate_3x=%s)" % (over, eng_over["goodput_rps"],
                                 out["serial_overload"]["goodput_rps"],
                                 ratio, out["gate_3x"]))
    return out


# ---------------------------------------------------------------- fleet


def fleet_scaling_rows(args, tracer, parts=None) -> List[Dict]:
    """The headline fleet rows: open-loop goodput at `--fleet-load` x N x
    the per-replica capacity (a closed loop at the first N), for each N
    in `--replicas`, over `SimServePredict` replicas; with
    `--replica-sim-ms 0` over real replicas, `parts` = (rid -> predict).
    scaling_eff@N = goodput@N / (N * goodput@1) (ref serve_bench.py:498).
    """
    if args.replica_sim_ms > 0:
        def predict_of(rid):
            return SimServePredict(args.replica_sim_ms)
    elif parts is None:
        raise ValueError("--replica-sim-ms 0 needs the real parts")
    else:
        predict_of = parts
    buckets = tuple(sorted(set(args.buckets)))
    deadline_s = args.deadline_ms / 1e3
    pool = sim_pool(args)
    rows: List[Dict] = []
    cap1 = None
    for n in args.replicas:
        factory = make_replica_factory(
            predict_of, (args.imsize, args.imsize, 3), lambda rid: buckets,
            queue_capacity=max(args.queue_cap, 64),
            max_wait_ms=args.max_wait_ms, depth=args.depth, tracer=tracer)
        router = FleetRouter(factory, n, metrics=MetricsRegistry(),
                             default_budget=1_000_000, tracer=tracer)
        try:
            if cap1 is None:
                closed = closed_loop(router, pool, args.clients,
                                     max(2.0, args.duration / 2),
                                     tracer=tracer)
                cap1 = max(closed["goodput_rps"] / n, 1e-6)
                log("fleet capacity: %.1f req/s per replica (N=%d closed "
                    "loop)" % (cap1, n))
            rate = args.fleet_load * n * cap1
            sched = arrival_schedule(rate, args.duration,
                                     args.seed + 31 * n)
            row = open_loop(router, pool, sched, args.duration, deadline_s,
                            rate)
        finally:
            router.close()
        row["replicas"] = n
        row["per_replica_goodput"] = row["goodput_rps"] / n
        rows.append(row)
        log("fleet x%d (%.0f rps offered): goodput %.1f (%.1f/replica), "
            "p99 %s ms, shed %d, lost %d"
            % (n, rate, row["goodput_rps"], row["per_replica_goodput"],
               row["p99_ms"], row["shed"], row["lost"]))
        beat("fleet row N=%d done" % n)
    g1 = max(rows[0]["goodput_rps"], 1e-6)
    for row in rows:
        row["scaling_eff"] = row["goodput_rps"] / (row["replicas"] * g1)
    return rows


def _traffic(router, pool, stop, pace_s, futs=None, lock=None,
             tenants=()):
    """Background traffic until `stop`: one request every `pace_s`, the
    tenants in turns."""
    k = 0
    while not stop.is_set():
        kw = {"tenant": tenants[k % len(tenants)]} if tenants else {}
        f = router.submit(pool[k % len(pool)], **kw)
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
    of `--tenants` whose replica 0 fails two dispatches (the canary of a
    quiescent fleet), a rollout at 0.9 rolls back on the canary's error
    burn under the tenants' traffic, and every replica serves the old
    rows again."""
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
    tenants = dict(args.tenant_budgets) or {"bulk": 64, "flagged": 64}
    router = FleetRouter(
        # two dispatches in a row: the second is due while the first's
        # retry keeps the engine busy, so it fires before the rollback's
        # reload can finish; a fault after it would leave replica 0
        # DEGRADED, routed around by an idle fleet that never needs it
        factory(injector_for={0: "serve:dispatch=device-loss@2,"
                                 "serve:dispatch=device-loss@3"}),
        2, variables=stable, tenants=tenants, default_budget=1_000_000,
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
                              args=(router, pool, stop, pace_s, futs, lock,
                                    sorted(tenants)),
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
        tenant_health = router.health()["tenants"]
        after = rows_on_every_replica(router, pool, old_oracle, args.seed)
        st = router.stats()
        res = box["res"]
        out["rollback"] = dict(
            outcome=res["outcome"], canary=res["canary"],
            alerts=[a.get("rule") for a in res["alerts"]],
            during=len(futs), during_equal=during_equal, shed=shed,
            lost_acks=lost, states=states, after=after,
            rollbacks=st["rollbacks"], promotes=st["promotes"],
            redispatched=st["redispatched"], lost=st["lost"],
            tenants=tenant_health, builds=builds_of(router))
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
    first quarter of the `expected` requests (`--faults` replaces the
    schedule; its `seed=` shorthand draws over the fleet sites): every
    admitted request completes (lost 0), one respawn, the fresh engine
    captures each bucket once, rows stay the oracle's."""
    at = int(np.random.default_rng(args.seed).integers(
        2, max(3, expected // 4)))
    inj = ChaosInjector(fault_schedule(
        args, FLEET_SITES, 3, 40, "fleet:replica=worker-death@%d" % at))
    n0 = len(build_s)
    router = FleetRouter(factory(), 2, metrics=MetricsRegistry(),
                         default_budget=1_000_000, injector=inj)
    try:
        loop = closed_loop(router, pool, args.clients, args.duration)
        after = rows_on_every_replica(router, pool, oracle, args.seed)
        st = router.stats()
        h = router.health()
        return dict(at=at, fired=[e.key for e in inj.fired],
                    spec=inj.schedule.spec(), injected=inj.summary(),
                    requests=st["submitted"], loop=loop, lost=st["lost"],
                    lost_acks=st["lost"], deaths=st["replica_deaths"],
                    replica_deaths=st["replica_deaths"],
                    respawns=st["respawns"],
                    redispatched=st["redispatched"],
                    generations=[r["generation"] for r in h["replicas"]],
                    builds=builds_of(router), after=after,
                    respawn_build_s=build_s[n0 + 2:])
    finally:
        router.close()


def fleet_engine_run(args, inspect: Inspect = None) -> Dict:
    """The fleet over real engines (the port's sections beyond JAX's):
    at each `--replicas` N a closed loop of `--clients` (images/s,
    p50/p99) and the rows of a paced burst against the oracle; then
    skewed routing and tenants, a replica's death during a closed loop,
    a canary promote and a rollback."""
    cfg = run_config(args)
    dev = resolve_device(cfg.device)
    buckets = tuple(sorted(set(cfg.serve_buckets)))
    pool = sim_pool(args)
    scales = calibration(cfg)
    stable = float_state(cfg)
    new = perturbed(stable)
    old_oracle = oracle_rows(make_predict(cfg, scales=scales), pool,
                             buckets)
    new_oracle = oracle_rows(make_predict(cfg, state=new, scales=scales),
                             pool, buckets)
    shape = (cfg.imsize, cfg.imsize, 3)
    build_s: List[float] = []

    def factory(**kw):
        return make_replica_factory(
            lambda rid: make_predict(cfg, scales=scales), shape,
            lambda rid: buckets, queue_capacity=max(64, args.clients),
            max_wait_ms=args.max_wait_ms, depth=args.depth,
            build_s=build_s, **kw)

    out: Dict = {"device": str(dev), "imsize": cfg.imsize,
                 "inch": cfg.hourglass_inch, "amp": cfg.amp,
                 "infer_dtype": cfg.infer_dtype, "buckets": list(buckets),
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
        log("fleet engines x%d: %.1f img/s closed loop (%d clients), p50 "
            "%s ms, p99 %s ms; %d of %d rows equal the oracle, lost %d"
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


def run_fleet_bench(args, inspect: Inspect = None) -> Dict:
    """The `serve-bench-fleet-v1` record (ref serve_bench.py:715): the
    scaling rows, `canary` and `death` of the real-engine run (`engine`),
    the gates, the trace sections."""
    dev = resolve_device(args.device)
    log("device up: %s (fleet mode, replicas %s)"
        % (dev, list(args.replicas)))
    beat("device up (%s, fleet)" % platform_of(dev))
    tracer = arm_trace_log(args, maybe_tracer(args.span_log or None))
    out: Dict = {"schema": FLEET_SCHEMA, "tool": "serve_bench",
                 "platform": platform_of(dev), "device": str(dev),
                 "imsize": args.imsize, "inch": args.inch,
                 "topk": args.topk, "infer_dtype": args.infer_dtype,
                 "buckets": list(args.buckets),
                 "replicas": list(args.replicas),
                 "replica_sim_ms": args.replica_sim_ms,
                 "fleet_load": args.fleet_load,
                 "deadline_ms": args.deadline_ms, "seed": args.seed,
                 "note": ("scaling rows run simulated replicas (a fixed "
                          "service time the host only waits on: they "
                          "measure the router's and the engines' host "
                          "cost, not the card) unless replica_sim_ms is "
                          "0; canary and death run real engines "
                          "(`engine`)")}
    parts = None
    if args.replica_sim_ms <= 0:
        cfg = run_config(args)
        scales = calibration(cfg)

        def parts(rid):
            return make_predict(cfg, scales=scales)
    out["rows"] = fleet_scaling_rows(args, tracer, parts)
    beat("fleet scaling rows done")
    eng = fleet_engine_run(args, inspect)
    out["engine"] = eng
    beat("fleet engine runs done")
    r, d = eng["rollback"], eng["death"]
    out["canary"] = {"outcome": r["outcome"], "canary_rid": r["canary"],
                     "alerts": r["alerts"], "requests": r["during"],
                     "lost_acks": r["lost_acks"], "router_lost": r["lost"],
                     "redispatched": r["redispatched"],
                     "rollbacks": r["rollbacks"],
                     "promotes": r["promotes"], "tenants": r["tenants"]}
    out["death"] = {k: d[k] for k in ("spec", "injected", "requests",
                                      "lost_acks", "replica_deaths",
                                      "respawns", "redispatched")}
    out["tenants"] = sorted(out["canary"]["tenants"])
    out["gate_scaling_08"] = bool(all(
        row["scaling_eff"] >= 0.8 for row in out["rows"]))
    out["gate_zero_lost_acks"] = bool(
        out["canary"]["lost_acks"] == 0 and out["death"]["lost_acks"] == 0
        and all(row["lost"] == 0 for row in out["rows"]))
    add_trace_sections(out, tracer, args.trace_exemplars)
    log("fleet gates: scaling>=0.8 %s, zero lost acks %s"
        % (out["gate_scaling_08"], out["gate_zero_lost_acks"]))
    return out


# -------------------------------------------------------------- cascade


def cascade_engine_run(args, inspect: Inspect = None) -> Dict:
    """Edge-first serving over real engines at the calibrated threshold
    (`config.cascade_overrides()`): rid 0 an edge-tier engine predicting
    with the confidence (`cascade_summary`), rid 1 a quality-tier
    engine, tenant "cascade" enrolled. Checks: the graph's confidence
    equals `confidence_summary` of the same rows on the host,
    tier-pinned rows equal each tier's oracle, cascade answers follow
    their confidence and equal the answering tier's oracle; an injected
    escalation fault degrades to the edge answer and a quality replica's
    death during escalation still delivers. Records the escalation
    rate, images/s and p50/p99 of a closed loop."""
    threshold = cascade_overrides()["cascade_threshold"]
    tiers = list(args.cascade_tiers)
    cfgs = [run_config(args, t) for t in tiers]
    dev = resolve_device(cfgs[0].device)
    pool = sim_pool(args)
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

    out: Dict = {"device": str(dev), "imsize": cfgs[0].imsize,
                 "tiers": tiers, "buckets": [list(b) for b in buckets],
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
    log("cascade engines at threshold %g: escalation rate %.4f; %.1f "
        "img/s closed loop (%d clients), p50 %s ms, p99 %s ms; faults %s"
        % (threshold, out["escalation_rate"], out["loop"]["goodput_rps"],
           args.clients, out["loop"]["p50_ms"], out["loop"]["p99_ms"],
           faults["fired"]))
    return out


def make_cascade_sim_factory(args, tracer=None):
    """rid 0 an edge-tier sim (`--cascade-edge-ms`, the confidence leaf),
    rid 1 a quality-tier sim (`--replica-sim-ms`), both through
    `make_replica_factory` (ref serve_bench.py:781)."""
    buckets = tuple(sorted(set(args.buckets)))

    def predict_of(rid):
        return (SimCascadePredict(args.cascade_edge_ms) if rid == 0
                else SimServePredict(args.replica_sim_ms))

    return make_replica_factory(
        predict_of, (args.imsize, args.imsize, 3), lambda rid: buckets,
        queue_capacity=max(args.queue_cap, 64),
        max_wait_ms=args.max_wait_ms, depth=args.depth, tracer=tracer)


def cascade_sim_router(args, threshold, tracer, injector=None):
    return FleetRouter(make_cascade_sim_factory(args, tracer), 2,
                       replica_tiers=list(args.cascade_tiers),
                       cascade_tenants=["cascade"],
                       cascade_tiers=tuple(args.cascade_tiers),
                       cascade_threshold=threshold,
                       metrics=MetricsRegistry(), default_budget=1_000_000,
                       injector=injector, tracer=tracer)


def cascade_sim_rows(args, tracer) -> Dict:
    """Cascade against all-quality over sims at the same offered load on
    the same seeded trace with the same replica count (ref
    serve_bench.py:862): the all-quality capacity (closed loop), one
    past-saturation open loop per side. Also the port's check of the
    cascade row: every answered request escalated iff its host oracle
    confidence is below the threshold (`escalations`)."""
    threshold = args.cascade_threshold
    pool = sim_pool(args)
    oracle = [sim_confidence(img) < threshold for img in pool]
    out: Dict = {"pool_escalation_frac": sum(oracle) / len(pool)}
    deadline_s = args.deadline_ms / 1e3
    buckets = tuple(sorted(set(args.buckets)))
    base = FleetRouter(make_replica_factory(
        lambda rid: SimServePredict(args.replica_sim_ms),
        (args.imsize, args.imsize, 3), lambda rid: buckets,
        queue_capacity=max(args.queue_cap, 64),
        max_wait_ms=args.max_wait_ms, depth=args.depth, tracer=tracer),
        2, metrics=MetricsRegistry(), default_budget=1_000_000,
        tracer=tracer)
    try:
        closed = closed_loop(base, pool, args.clients,
                             max(2.0, args.duration / 2), tracer=tracer)
        cap = max(closed["goodput_rps"], 1e-6)
        out["all_quality_capacity_rps"] = closed["goodput_rps"]
        log("all-quality capacity: %.1f req/s (2 sim replicas, closed "
            "loop)" % cap)
        rate = args.cascade_load * cap
        sched = arrival_schedule(rate, args.duration, args.seed + 616)
        out["offered_rps"] = rate
        row_base = open_loop(base, pool, sched, args.duration, deadline_s,
                             rate)
    finally:
        base.close()
    row_base["mode"] = "all-quality"
    log("all-quality at %.1f rps offered: goodput %.1f, p99 %s ms, shed %d"
        % (rate, row_base["goodput_rps"], row_base["p99_ms"],
           row_base["shed"]))
    beat("all-quality row done")

    casc = cascade_sim_router(args, threshold, tracer)
    rec = Recorder(TenantPin(casc, "cascade"), pool)
    try:
        row_casc = open_loop(rec, pool, sched, args.duration, deadline_s,
                             rate)
    finally:
        st = casc.stats()
        casc.close()
    row_casc["mode"] = "cascade"
    hops = max(st["edge_resolved"] + st["escalated"], 1)
    out["escalation_rate"] = st["escalated"] / hops
    out["edge_resolved"] = st["edge_resolved"]
    out["escalated"] = st["escalated"]
    out["degraded_answers"] = st["degraded_answers"]
    got = answered(rec.take())
    out["escalations"] = {
        "answered": len(got),
        "escalated": sum(bool(f.escalated) for _, f in got),
        "oracle": sum(oracle[i] for i, _ in got),
        "agree": sum(bool(f.escalated) == oracle[i] for i, f in got)}
    out["rows"] = [row_casc, row_base]
    ratio = row_casc["goodput_rps"] / max(row_base["goodput_rps"], 1e-6)
    out["cascade_goodput_ratio"] = ratio
    out["gate_cascade_2x"] = bool(ratio >= 2.0)
    log("cascade at the same %.1f rps: goodput %.1f vs %.1f all-quality "
        "(%.2fx, escalation rate %.1f%%, gate_cascade_2x=%s); %d of %d "
        "answered escalations follow the host oracle"
        % (rate, row_casc["goodput_rps"], row_base["goodput_rps"], ratio,
           100 * out["escalation_rate"], out["gate_cascade_2x"],
           out["escalations"]["agree"], out["escalations"]["answered"]))
    beat("cascade row done")
    return out


def cascade_fault_run(args, tracer) -> Dict:
    """The escalation hop under faults over sims (ref serve_bench.py:804):
    every request escalates (a threshold one above the pool's largest
    sim confidence), a quality-tier device-loss and a quality replica's
    death fire at `fleet:escalate`; the loss degrades to the edge answer,
    the death respawns; lost_acks must be 0."""
    inj = ChaosInjector(fault_schedule(
        args, CASCADE_SITES, 2, 24, "fleet:escalate=device-loss@2,"
        "fleet:escalate=worker-death@5"), tracer=tracer)
    pool = sim_pool(args)
    th_all = max(sim_confidence(img) for img in pool) + 1.0
    router = cascade_sim_router(args, th_all, tracer, injector=inj)
    futs = [router.submit(img, tenant="cascade") for img in pool * 2]
    lost = 0
    for f in futs:
        try:
            f.result(timeout=120)
        except Exception:  # noqa: BLE001 - an acknowledged loss
            lost += 1
    st = router.stats()
    router.close()
    out = {"spec": inj.schedule.spec(), "injected": inj.summary(),
           "requests": len(futs), "lost_acks": lost,
           "degraded_answers": st["degraded_answers"],
           "escalated": st["escalated"],
           "replica_deaths": st["replica_deaths"],
           "respawns": st["respawns"]}
    log("cascade faults: %d injected, degraded %d, deaths %d, lost acks "
        "%d" % (out["injected"]["total"], out["degraded_answers"],
                out["replica_deaths"], out["lost_acks"]))
    return out


def run_cascade_bench(args, inspect: Inspect = None) -> Dict:
    """The `serve-bench-cascade-v1` record: the sim comparison, the
    escalation-fault replay, the real-engine cascade (`engine`), the
    trace sections."""
    dev = resolve_device(args.device)
    log("device up: %s (cascade mode)" % dev)
    beat("device up (%s, cascade)" % platform_of(dev))
    tracer = arm_trace_log(args, maybe_tracer(args.span_log or None))
    out: Dict = {"schema": CASCADE_SCHEMA, "tool": "serve_bench",
                 "platform": platform_of(dev), "device": str(dev),
                 "imsize": args.imsize,
                 "buckets": list(sorted(set(args.buckets))),
                 "cascade": True, "cascade_tiers": list(args.cascade_tiers),
                 "cascade_threshold": args.cascade_threshold,
                 "edge_sim_ms": args.cascade_edge_ms,
                 "quality_sim_ms": args.replica_sim_ms,
                 "cascade_load": args.cascade_load,
                 "deadline_ms": args.deadline_ms, "seed": args.seed,
                 "note": ("both sides run simulated fixed-service "
                          "replicas (host waits only: they measure the "
                          "router's and the engines' host cost, not the "
                          "card); cascade = 1 edge + 1 quality replica "
                          "vs 2 quality replicas, same seeded Poisson "
                          "trace at the same offered load; `engine` is "
                          "the cascade over real engines at the "
                          "calibrated threshold")}
    out.update(cascade_sim_rows(args, tracer))
    out["faults"] = cascade_fault_run(args, tracer)
    beat("cascade fault run done")
    out["gate_zero_lost_acks"] = bool(
        all(r["lost"] == 0 for r in out["rows"])
        and out["faults"]["lost_acks"] == 0)
    out["engine"] = cascade_engine_run(args, inspect)
    beat("cascade engine run done")
    add_trace_sections(out, tracer, args.trace_exemplars)
    log("cascade gates: 2x goodput %s, zero lost acks %s"
        % (out["gate_cascade_2x"], out["gate_zero_lost_acks"]))
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


def stream_closed_loop(sessions, seqs, duration_s: float,
                       tracer=None) -> Dict:
    """Each stream submits its next frame when the last delivers: the
    sessions' frames/s at saturation (ref serve_bench.py:1059)."""
    tracer = tracer or SpanTracer(None)
    stop = threading.Event()
    lock = threading.Lock()
    done = [0]

    def cam(si: int) -> None:
        sess, frames = sessions[si], seqs[si]
        k = 0
        while not stop.is_set():
            fut = sess.submit_frame(frames[k % len(frames)])
            k += 1
            try:
                fut.result(timeout=120)
            except Exception:  # noqa: BLE001 - closing down
                return
            with lock:
                done[0] += 1

    threads = [threading.Thread(target=cam, args=(i,), daemon=True)
               for i in range(len(sessions))]
    with tracer.span("serve-bench:stream-closed",
                     streams=len(sessions)) as sp:
        for t in threads:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=120)
    wall = sp.dur_s
    return {"mode": "stream-closed", "streams": len(sessions),
            "duration_s": wall, "frames": done[0],
            "goodput_fps": done[0] / wall}


def stream_open_loop(sessions, seqs, schedules, duration_s: float,
                     deadline_s: float, offered_fps: float,
                     mode: str) -> Dict:
    """Seeded Poisson frame arrivals per stream (ref serve_bench.py:1099):
    goodput counts frames delivered within the deadline with no
    degraded tile; `lost` frames never delivered; `in_order` whether
    every stream delivered its frames in submit order."""
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
    return {"mode": mode, "offered_fps": offered_fps,
            "duration_s": duration_s, "in_order": in_order,
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


def streams_engine_run(args, inspect: Inspect = None, tracer=None) -> Dict:
    """`--streams-n` seeded streams of (grid * imsize)^2 uint8 frames at
    `--redundancy`, through sessions over an edge-tier engine behind a
    one-replica fleet, at the calibrated threshold
    (`config.stream_overrides()`). Checks: the card's delta summary
    equals the CPU's on every frame pair; a first frame computes every
    tile, its copy none; an all-changed frame's stitched answer equals
    the tile oracle; frames deliver in order; injected frame faults and
    a failed tile deliver from the cache. Records frames/s gated against
    ungated at the same offered rate, and the tile skip rate. The fault
    run's session and injector write their `stream:frame`,
    `recover:frame-gap` and `fault:*` records to `tracer` (default
    $OBS_SPAN_LOG), as JAX's serve_bench's do (ref
    scripts/serve_bench.py:1193); the measured arms write none, so span
    writes do not move their frames/s."""
    threshold = stream_overrides()["stream_threshold"]
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
    out: Dict = {"device": str(dev), "tile_imsize": cfg.imsize,
                 "frame": list(fshape), "tier": "edge",
                 "buckets": list(buckets), "streams": args.streams_n,
                 "redundancy": args.redundancy, "threshold": threshold}
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
                              injector=kw.get("injector"),
                              tracer=kw.get("tracer"), device=dev)
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
        rate = args.stream_load * max(closed["goodput_fps"], 1e-6)
        schedules = [arrival_schedule(rate / args.streams_n, args.duration,
                                      args.seed + 1700 + sid)
                     for sid in range(args.streams_n)]
        arms = {}
        for arm, th in (("ungated", ungated), ("gated", threshold)):
            ss = sessions(router, th, deadline_s=deadline_s)
            arms[arm] = stream_open_loop(ss, seqs, schedules,
                                         args.duration, deadline_s, rate,
                                         arm)
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
    tracer = tracer if tracer is not None else maybe_tracer()
    inj = ChaosInjector(FaultSchedule.parse(
        "stream:frame=dropped-frame@3,stream:frame=corrupt-frame@5,"
        "stream:frame=late-frame@7"), tracer=tracer)
    router = fleet(max_retries=0, max_redispatch=0,
                   injector_for={0: "serve:dispatch=device-loss@4"})
    try:
        sess = sessions(router, threshold, injector=inj, tracer=tracer,
                        n=1)[0]
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
    log("streams engines: %d x %s frames at redundancy %g, threshold %g: "
        "gated %.1f vs ungated %.1f frames/s on time at %.1f offered "
        "(capacity ungated %.1f), tile skip rate %.4f; delta card = CPU on "
        "%d of %d pairs" % (args.streams_n, "x".join(map(str, fshape[:2])),
                            args.redundancy, threshold,
                            arms["gated"]["goodput_fps"],
                            arms["ungated"]["goodput_fps"], rate,
                            closed["goodput_fps"], out["tile_skip_rate"],
                            equal, pairs))
    return out


def make_stream_fleet(args, tracer=None):
    """Two `SimStreamPredict` tile replicas (`--tile-sim-ms` per tile)
    behind a FleetRouter: the serving surface both arms share (ref
    serve_bench.py:1167)."""
    return FleetRouter(
        make_replica_factory(lambda rid: SimStreamPredict(args.tile_sim_ms),
                             (args.imsize, args.imsize, 3),
                             lambda rid: tuple(sorted(set(args.buckets))),
                             queue_capacity=max(args.queue_cap, 64),
                             max_wait_ms=args.max_wait_ms,
                             depth=args.depth, tracer=tracer),
        2, metrics=MetricsRegistry(), default_budget=1_000_000,
        tracer=tracer)


def make_stream_sessions(args, router, threshold: float, deadline_s,
                         tracer=None):
    """`--streams-n` sessions over `router`, the delta summary on
    `--device`."""
    g = args.tile_grid
    fshape = (g * args.imsize, g * args.imsize, 3)
    dev = resolve_device(args.device)
    return [StreamSession(router, fshape, grid=g, threshold=threshold,
                          deadline_s=deadline_s, tracer=tracer, sid=sid,
                          device=dev)
            for sid in range(args.streams_n)]


def streams_sim_arms(args, tracer) -> Dict:
    """Delta-gated against full inference over sim tile replicas at the
    same offered frame rate over the same seeded frames and arrival
    trace (ref serve_bench.py:1241): the full arm's capacity (closed
    loop, every tile computes), one past-saturation open loop per arm,
    the computed tile fraction."""
    out: Dict = {}
    deadline_s = args.deadline_ms / 1e3
    full = -math.inf  # every tile computes: no delta is below it
    seqs = [synth_stream_frames(args, sid, 128)
            for sid in range(args.streams_n)]

    def arm(threshold, run):
        router = make_stream_fleet(args, tracer)
        sess = make_stream_sessions(args, router, threshold, deadline_s,
                                    tracer=tracer)
        try:
            return run(sess), [s.stats() for s in sess]
        finally:
            for s in sess:
                s.close()
            router.close()

    closed, _ = arm(full, lambda sess: stream_closed_loop(
        sess, seqs, max(2.0, args.duration / 2), tracer))
    cap = max(closed["goodput_fps"], 1e-6)
    out["full_capacity_fps"] = closed["goodput_fps"]
    log("full-inference capacity: %.1f frames/s (%d streams, closed loop)"
        % (cap, args.streams_n))
    beat("stream capacity measured")
    rate = args.stream_load * cap
    out["offered_fps"] = rate
    schedules = [arrival_schedule(rate / args.streams_n, args.duration,
                                  args.seed + 1700 + sid)
                 for sid in range(args.streams_n)]
    row_full, _ = arm(full, lambda sess: stream_open_loop(
        sess, seqs, schedules, args.duration, deadline_s, rate,
        "full-inference"))
    log("full-inference at %.1f fps offered: goodput %.1f, p99 %s ms, "
        "degraded %d" % (rate, row_full["goodput_fps"], row_full["p99_ms"],
                         row_full["degraded"]))
    beat("full-inference row done")
    row_gated, stats_g = arm(args.stream_threshold, lambda sess:
                             stream_open_loop(sess, seqs, schedules,
                                              args.duration, deadline_s,
                                              rate, "delta-gated"))
    computed = sum(st["computed_tiles"] for st in stats_g)
    skipped = sum(st["skipped_tiles"] for st in stats_g)
    out["computed_tile_fraction"] = computed / max(computed + skipped, 1)
    out["tile_skip_rate"] = skipped / max(computed + skipped, 1)
    out["rows"] = [row_gated, row_full]
    ratio = row_gated["goodput_fps"] / max(row_full["goodput_fps"], 1e-6)
    out["stream_goodput_ratio"] = ratio
    out["gate_streams_2x"] = bool(ratio >= 2.0)
    log("delta-gated at the same %.1f fps: goodput %.1f vs %.1f full "
        "(%.2fx, computed tile fraction %.1f%%, gate_streams_2x=%s)"
        % (rate, row_gated["goodput_fps"], row_full["goodput_fps"], ratio,
           100 * out["computed_tile_fraction"], out["gate_streams_2x"]))
    beat("delta-gated row done")
    return out


def stream_fault_run(args, tracer) -> Dict:
    """Frame faults over sim tile replicas (ref serve_bench.py:1193):
    dropped, corrupt and late frames at `stream:frame` mid-stream; every
    acknowledged frame delivers (gaps from the tile cache with
    `recover:frame-gap` events, corrupt frames never the delta
    reference); lost_acks must be 0."""
    inj = ChaosInjector(fault_schedule(
        args, STREAM_SITES, 3, 10, "stream:frame=dropped-frame@2,"
        "stream:frame=corrupt-frame@5,stream:frame=late-frame@8"),
        tracer=tracer)
    router = make_stream_fleet(args, tracer)
    g = args.tile_grid
    sess = StreamSession(router, (g * args.imsize, g * args.imsize, 3),
                         grid=g, threshold=args.stream_threshold,
                         injector=inj, tracer=tracer, sid=0,
                         device=resolve_device(args.device))
    futs = [sess.submit_frame(f) for f in synth_stream_frames(args, 0, 12)]
    lost = 0
    for f in futs:
        try:
            f.result(timeout=120)
        except Exception:  # noqa: BLE001 - a lost acknowledged frame
            lost += 1
    st = sess.stats()
    sess.close()
    router.close()
    out = {"spec": inj.schedule.spec(), "injected": inj.summary(),
           "frames": len(futs), "lost_acks": lost, "gaps": st["gaps"],
           "corrupt": st["corrupt"], "late": st["late"],
           "degraded_tiles": st["degraded_tiles"]}
    log("stream faults: %d injected, gaps %d, corrupt %d, late %d, lost "
        "acks %d" % (out["injected"]["total"], out["gaps"], out["corrupt"],
                     out["late"], out["lost_acks"]))
    return out


def run_streams_bench(args, inspect: Inspect = None, tracer=None) -> Dict:
    """The `serve-bench-streams-v1` record: the sim arms, the frame-fault
    replay, the real-engine streams (`engine`; its fault run writes to
    `tracer`), the trace sections."""
    dev = resolve_device(args.device)
    log("device up: %s (streams mode)" % dev)
    beat("device up (%s, streams)" % platform_of(dev))
    armed = arm_trace_log(args, maybe_tracer(args.span_log or None))
    out: Dict = {"schema": STREAMS_SCHEMA, "tool": "serve_bench",
                 "platform": platform_of(dev), "device": str(dev),
                 "imsize": args.imsize, "tile_grid": args.tile_grid,
                 "tiles": args.tile_grid * args.tile_grid,
                 "streams": args.streams_n,
                 "redundancy": args.redundancy,
                 "stream_threshold": args.stream_threshold,
                 "tile_sim_ms": args.tile_sim_ms,
                 "stream_load": args.stream_load,
                 "deadline_ms": args.deadline_ms, "seed": args.seed,
                 "note": ("both arms run the same StreamSession tile path "
                          "over simulated per-tile-service tile replicas "
                          "(host waits only: they measure the sessions', "
                          "router's and engines' host cost, not the "
                          "card; service is linear in the padded batch, "
                          "so capacity is tiles/s); the full arm computes "
                          "every tile; same seeded frames and Poisson "
                          "trace at the same offered rate; `engine` is "
                          "the streams over real engines at the "
                          "calibrated threshold")}
    out.update(streams_sim_arms(args, armed))
    out["faults"] = stream_fault_run(args, armed)
    beat("stream fault run done")
    out["gate_zero_lost_acks"] = bool(
        all(r["lost"] == 0 for r in out["rows"])
        and out["faults"]["lost_acks"] == 0)
    out["engine"] = streams_engine_run(args, inspect, tracer)
    beat("streams engine run done")
    add_trace_sections(out, armed, args.trace_exemplars)
    log("stream gates: 2x goodput %s, zero lost acks %s"
        % (out["gate_streams_2x"], out["gate_zero_lost_acks"]))
    return out


# ----------------------------------------------------------------- main


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.serving.runs",
        description="serve_bench: p50/p99 and goodput against offered "
                    "load for the serving engine, fleet, cascade and "
                    "streams")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--imsize", type=int, default=None,
                   help="default: 512 on the card, 64 on the CPU")
    p.add_argument("--inch", type=int, default=None,
                   help="the flagship's width (default: 128 on the card, "
                        "16 on the CPU; tiers set their own)")
    p.add_argument("--topk", type=int, default=None,
                   help="default: 100 on the card, 32 on the CPU")
    p.add_argument("--amp", action=argparse.BooleanOptionalAction,
                   default=None, help="bf16 (default on the card) or f32")
    p.add_argument("--infer-dtype", default=None, choices=("bf16", "int8"),
                   help="the flagship's serving dtype (default: int8 on "
                        "the card, bf16 on the CPU)")
    p.add_argument("--buckets", type=int, nargs="+",
                   default=[1, 2, 4, 8, 16],
                   help="the flagship's and the sims' buckets (tiers set "
                        "their own)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--queue-cap", type=int, default=8,
                   help="the engine's admission bound: keep it small so "
                        "admitted requests finish inside the deadline; "
                        "excess load sheds at submit")
    p.add_argument("--deadline-ms", type=float, default=600.0,
                   help="goodput deadline")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds per load point")
    p.add_argument("--loads", type=float, nargs="+",
                   default=[0.5, 0.9, 2.0],
                   help="offered-load multipliers of the measured capacity "
                        "(include one > 1: the past-saturation point)")
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--pool", type=int, default=32,
                   help="distinct request images")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replicas", type=int, nargs="+", default=[],
                   help="fleet mode: a FleetRouter over N replicas for "
                        "each N given; the serve-bench-fleet-v1 record")
    p.add_argument("--replica-sim-ms", type=float, default=40.0,
                   help="fleet scaling rows: the simulated replicas' "
                        "service time (0: flagship engines on the card)")
    p.add_argument("--fleet-load", type=float, default=2.0,
                   help="fleet rows' offered load as a multiple of N x "
                        "the per-replica capacity")
    p.add_argument("--cascade", action="store_true",
                   help="cascade mode: edge-first serving against "
                        "all-quality; the serve-bench-cascade-v1 record")
    # the sims' own scale (pixel[0,0,0]/255 in [0, 1]); the real-engine
    # section resolves its threshold from config.cascade_overrides()
    p.add_argument("--cascade-threshold", type=float,
                   default=0.1,  # graftlint: off=hand-picked-threshold
                   help="the cascade sims' escalation threshold on the "
                        "sim confidence scale (about the escalation "
                        "fraction of a uniform pool); the real engines use "
                        "config.cascade_overrides()")
    p.add_argument("--cascade-tiers", nargs=2, default=["edge", "quality"],
                   metavar=("EDGE", "QUALITY"))
    p.add_argument("--cascade-edge-ms", type=float, default=5.0,
                   help="the edge sim's service time (the quality sim "
                        "uses --replica-sim-ms)")
    p.add_argument("--cascade-load", type=float, default=5.0,
                   help="cascade rows' offered load as a multiple of the "
                        "all-quality closed-loop capacity")
    p.add_argument("--streams", action="store_true",
                   help="streams mode: delta-gated tile inference against "
                        "full inference; the serve-bench-streams-v1 record")
    p.add_argument("--streams-n", type=int, default=4)
    p.add_argument("--stream-frames", type=int, default=24,
                   help="frames of each stream in the real-engine run")
    p.add_argument("--redundancy", type=float, default=0.75,
                   help="probability that a tile is unchanged from one "
                        "frame to the next")
    # the sims' own scale (unchanged tiles delta 0, redrawn ones ~85);
    # the real-engine section resolves its threshold from
    # config.stream_overrides()
    p.add_argument("--stream-threshold", type=float,
                   default=1.0,  # graftlint: off=hand-picked-threshold
                   help="the sim streams' tile skip threshold (mean "
                        "|delta| in [0, 255]); the real engines use "
                        "config.stream_overrides()")
    p.add_argument("--tile-grid", type=int, default=2)
    p.add_argument("--stream-load", type=float, default=2.5,
                   help="offered frame rate as a multiple of the full "
                        "arm's closed-loop capacity")
    p.add_argument("--tile-sim-ms", type=float, default=10.0,
                   help="the tile sims' service time per tile of a batch")
    p.add_argument("--tenants", default="bulk:64,flagged:64",
                   help="the canary run's tenants, 'name:budget,...'")
    p.add_argument("--faults", default="",
                   help="a fault schedule 'site=kind@n,...' or "
                        "'seed=<int>[,n=<int>]', replayed in the load run "
                        "(engine mode) or the mode's fault run")
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--hang-timeout-ms", type=float, default=0.0,
                   help="the engine's fetch watchdog (0 disables; 500 when "
                        "--faults is set)")
    p.add_argument("--span-log", default="",
                   help="span log (else $OBS_SPAN_LOG)")
    p.add_argument("--trace-exemplars", type=int, default=3,
                   help="the N slowest requests' waterfalls and the trace "
                        "completeness in the record (0 disables)")
    p.add_argument("--out", default=None,
                   help="record path (default serve_bench_out/<mode "
                        "name>.json in the repo)")
    p.add_argument("--selfcheck", action="store_true",
                   help="the engine, fleet, trace, cascade and streams "
                        "contracts on seeded load (serving/selfcheck.py)")
    return p


def resolve_args(args):
    """The device-dependent defaults (JAX's card/CPU split), sorted
    buckets, the fault watchdog, the tenant budgets."""
    if args.cpu:
        args.device = "cpu"
    on_cpu = torch.device(args.device).type == "cpu"
    args.imsize = args.imsize or (64 if on_cpu else 512)
    args.inch = args.inch or (16 if on_cpu else 128)
    args.topk = args.topk or (32 if on_cpu else 100)
    args.amp = (not on_cpu) if args.amp is None else args.amp
    args.infer_dtype = args.infer_dtype or ("bf16" if on_cpu else "int8")
    args.buckets = tuple(sorted(set(args.buckets)))
    if args.faults and args.hang_timeout_ms <= 0:
        args.hang_timeout_ms = 500.0
    args.tenant_budgets = {}
    for part in (args.tenants or "").split(","):
        part = part.strip()
        if part:
            name, _, budget = part.partition(":")
            args.tenant_budgets[name] = int(budget or 64)
    return args


def parse_args(argv=None):
    return resolve_args(build_parser().parse_args(argv))


def main(argv=None, inspect: Inspect = None) -> Dict:
    """Run the mode the flags pick, write its record (not the
    selfcheck's), print it as one JSON line and return it."""
    args = parse_args(argv)
    # what the layers below print (a tier's preset, a calibration's
    # source) goes to stderr with the logs: stdout holds the one line
    with contextlib.redirect_stdout(sys.stderr):
        if args.selfcheck:
            from .selfcheck import selfcheck
            out = selfcheck(args.device)
        else:
            out, name = run_mode(args, inspect)
            path = args.out or os.path.join(DEFAULT_OUT_DIR, name + ".json")
            save_json(path, out, indent=1, sort_keys=True, default=str)
            out["artifact"] = os.path.abspath(path)
            log("record -> %s" % path)
    print(json.dumps(out, default=str), flush=True)
    return out


def run_mode(args, inspect: Inspect = None):
    """(record, its file name) of the mode the flags pick: streams, else
    cascade, else fleet, else the engine (ref serve_bench.py:2410)."""
    if args.streams:
        return run_streams_bench(args, inspect), "serve_bench_streams"
    if args.cascade:
        return run_cascade_bench(args, inspect), "serve_bench_cascade"
    if args.replicas:
        return run_fleet_bench(args, inspect), "serve_bench_fleet"
    return run_bench(args, inspect), "serve_bench"


def _exit_code(out: Dict) -> int:
    return 1 if out.get("selfcheck") and not out.get("ok") else 0


if __name__ == "__main__":
    run_as_job(lambda: sys.exit(_exit_code(main())))
