"""Serving fleet: a router over N ServingEngine replicas, with tenants,
tiers, canary rollouts, respawn and cascade serving.

Port of ref real_time_helmet_detection_tpu/serving/fleet.py:162-1119
(`TenantSheddedError`, `FleetFuture`, `FleetRouter`), behind the same
submit/future API as one engine. On one card the replicas are engines
of their own (each with its model's storages and its bucket graphs)
that share the card.

* **Least-loaded, deadline-aware dispatch over `health()` digests.** A
  submit scores each replica from `health(include_metrics=False)`:
  queued + retry_queued + inflight_batches * the largest bucket, an
  upper bound on the request's queue position; DEGRADED replicas carry
  a large penalty, DRAINING ones (mid-reload) a larger one, CLOSED ones
  are skipped. A replica whose queue sheds is skipped for the next; the
  fleet sheds only when every replica does (`fleet.shed_capacity`).
* **Bounded re-dispatch: an acknowledged request is never lost.** The
  fleet future chains onto the replica's through
  `ServeFuture.add_done_callback`; a replica failure (killed, retries
  spent, injected error) re-dispatches to another replica up to
  `max_redispatch` times; a deadline shed propagates as a shed.
* **Tenants.** Each tenant has a budget of outstanding requests (over
  it: `TenantSheddedError`) and burn rules (`obs.slo.
  default_tenant_rules`) over its `serve.tenant.<t>.*` metrics; an
  alert puts that tenant, and only it, in a penalty box counted in
  requests, so a replay sheds the same requests.
* **Tiers.** Replica slots carry a tier label (`replica_tiers`; the
  factory builds a slot's engine for its tier, also on respawn) and
  tenants a tier (`tenant_tiers`, or `submit(tier=)`). Routing is strict
  by default: a tier with no routable replica sheds
  (`tier_fallback=True` falls back to any replica).
* **Canary rollout over the engine's hot reload.** `rollout(variables,
  canary_frac)` reloads one replica, routes a deterministic share of
  traffic to it (request k goes to the canary iff floor(k * frac) >
  floor((k - 1) * frac)), and watches the canary's own registry: a
  clean window of completions promotes the weights to the tier's other
  replicas, any alert rolls the canary back to the stable weights.
* **Replica death is an input.** The chaos sites `fleet:dispatch` (a
  routing-layer fault) and `fleet:replica` (a worker-death kills the
  replica the request would have gone to; `ServingEngine.kill`) fire on
  the submit path; the router builds a fresh engine into the slot
  through the factory (reloaded to the stable weights) before it kills
  the old one, whose requests re-dispatch to the living.
* **Cascade serving.** Tenants in `cascade_tenants` go to the edge
  tier first; its replicas run `make_predict_fn(cascade_summary=True)`,
  whose rows carry the confidence computed in the bucket's graph, and
  the router escalates to the quality tier iff the confidence is below
  `cascade_threshold` (calibrated: `config.cascade_overrides()`). The
  escalation re-enters `_dispatch` with the same request and trace
  context; a quality tier that cannot answer (dead, shed, deadline, an
  injected `fleet:escalate` fault) degrades to the edge answer, flagged
  `degraded_answer`. A `fleet:escalate` worker-death kills a quality
  replica, never the edge engine whose fetch thread runs the callback
  (`ServingEngine.kill` joins its own threads).
* **Tracing.** With tracing on, `submit` mints the request's root
  context; hops are child contexts passed to `ServingEngine.submit(ctx=)`
  and every acknowledged request's trace ends in one `fleet:e2e`,
  `fleet:shed` or `fleet:lost`.

Beyond the JAX future, `FleetFuture.bucket` is the bucket that served
the answer and `FleetFuture.edge_confidence` the edge hop's confidence
of an escalated request. Replica engines are built only in `_spawn`
(the factory) and receive requests only in `_dispatch`.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs.trace import new_root
from .engine import (CLOSED, DEGRADED, DRAINING, EngineClosedError,
                     ServingEngine, SheddedError)

# additive dispatch-score penalties (in queue-position units): DEGRADED
# replicas are a last resort, DRAINING ones are mid-reload and effectively
# out of rotation unless nothing else serves
PENALTY_DEGRADED = 1_000.0
PENALTY_DRAINING = 1_000_000.0

DEFAULT_TENANT = "default"
DEFAULT_TIER = "default"

_TENANT_RE = re.compile(r"[^A-Za-z0-9_-]")

# rollout outcomes
PROMOTED = "promoted"
ROLLED_BACK = "rolled-back"
ROLLOUT_TIMEOUT = "timeout"


class TenantSheddedError(SheddedError):
    """Shed by per-tenant admission (budget exhausted or the tenant's SLO
    penalty box) — the fleet is healthy; THIS tenant is over its share."""


def _sanitize_tenant(name: str) -> str:
    return _TENANT_RE.sub("_", str(name)) or DEFAULT_TENANT


class FleetFuture:
    """Completion handle for one fleet request (the ServeFuture API —
    `result()`/`done()`/`exception()`/`t_submit`/`t_done` — plus the
    dispatch trail: `tenant`, `replicas` (rid per attempt) and
    `redispatches`). First-wins like ServeFuture.

    Cascade flags: `escalated` — the edge hop's confidence fell
    below the threshold and a quality hop was attempted; `degraded_answer`
    — the quality hop could not answer and the result is the EDGE answer
    (an acknowledged cascade request degrades, it is never lost)."""

    __slots__ = ("_event", "_value", "_error", "t_submit", "t_done",
                 "deadline", "tenant", "replicas", "redispatches", "ctx",
                 "escalated", "degraded_answer", "bucket",
                 "edge_confidence")

    def __init__(self, tenant: str, deadline: Optional[float] = None):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        self.deadline = deadline
        self.tenant = tenant
        self.replicas: List[int] = []
        self.redispatches = 0
        self.ctx = None  # root TraceContext when tracing is on
        self.escalated = False        # cascade: quality hop attempted
        self.degraded_answer = False  # cascade: answered at edge fidelity
        self.bucket: Optional[int] = None  # the answering hop's bucket
        self.edge_confidence: Optional[float] = None  # escalated: the
        # edge hop's confidence

    def _set(self, value) -> bool:
        if self._event.is_set():
            return False
        self._value = value
        self.t_done = time.monotonic()
        self._event.set()
        return True

    def _fail(self, error: BaseException) -> bool:
        if self._event.is_set():
            return False
        self._error = error
        self.t_done = time.monotonic()
        self._event.set()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        return self._error if self._event.is_set() else None

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("fleet request still pending after %ss"
                               % timeout)
        if self._error is not None:
            raise self._error
        return self._value


class _Replica:
    __slots__ = ("rid", "engine", "generation", "tier")

    def __init__(self, rid: int, engine: ServingEngine,
                 tier: str = DEFAULT_TIER):
        self.rid = rid
        self.engine = engine
        self.generation = 0
        self.tier = tier


class _Tenant:
    __slots__ = ("name", "budget", "outstanding", "penalty",
                 "c_submitted", "c_completed", "c_shed", "c_failed",
                 "h_e2e")

    def __init__(self, name: str, budget: int, mm):
        self.name = name
        self.budget = max(1, int(budget))
        self.outstanding = 0
        self.penalty = 0
        prefix = "serve.tenant.%s." % name
        self.c_submitted = mm.counter(prefix + "submitted")
        self.c_completed = mm.counter(prefix + "completed")
        self.c_shed = mm.counter(prefix + "shed")
        self.c_failed = mm.counter(prefix + "failed")
        self.h_e2e = mm.histogram(prefix + "e2e_ms")


class _Request:
    __slots__ = ("image", "future", "attempts", "tier", "ctx",
                 "cascade", "edge_result", "edge_rid", "edge_bucket")

    def __init__(self, image: np.ndarray, future: FleetFuture,
                 tier: Optional[str] = None, ctx=None,
                 cascade: bool = False):
        self.image = image
        self.future = future
        self.attempts = 0  # re-dispatches consumed
        self.tier = tier   # tier pin: None = any replica
        self.ctx = ctx     # root TraceContext: the router
        # mints it and owns the closure; replicas only add child hops
        self.cascade = cascade  # edge-first routing
        self.edge_result = None  # first-hop answer, held across the
        # escalation — the degraded-answer fallback if quality can't serve
        self.edge_rid = -1
        self.edge_bucket: Optional[int] = None


class FleetRouter:
    """The fleet front door (see module docstring).

    Parameters
    ----------
    replica_factory : Callable[[int, bool], ServingEngine]
        `(rid, start) -> ServingEngine`; called N times at construction
        (with `start=start`) and once per respawn (`start=True`). The
        factory owns predict/variables/buckets; give each replica its OWN
        MetricsRegistry so per-replica health digests stay per-replica,
        and its own `Predict` (its own model): `reload` copies weights
        into the storages of the predict's model.
    n_replicas : fleet size (>= 1).
    variables : the current stable weights (a flax variable tree or a
        state dict; or {tier: weights}) — the rollback
        target for canary rollouts (optional until `rollout` is used).
    tenants : {tenant: budget} token budgets (max outstanding admitted
        requests per tenant); unknown tenants are auto-created at
        `default_budget`.
    max_redispatch : per-REQUEST cross-replica re-dispatch budget after a
        replica-level failure (0 = surface the first replica error).
    deadline_ms : tenant latency-burn threshold (arms the per-tenant
        LatencyBurnRule; None = error burn only).
    tenant_shed_requests : penalty-box size after a tenant SLO alert
        (default: that tenant's budget).
    metrics : fleet obs.metrics registry (default: the process-wide one,
        engine.py's convention).
    watchdog_objective/burn : per-tenant + canary burn-rule tuning.
    injector : runtime.faults.ChaosInjector for the `fleet:*` sites
        (incl. the `fleet:escalate` cascade site).
    tracer : obs.spans tracer (default: $OBS_SPAN_LOG via maybe_tracer).
    start : construct paused replicas (tests) — `start()` arms them.
    cascade_tenants : tenants routed edge-first with confidence-gated
        escalation (module docstring). Empty/None = cascade off.
    cascade_tiers : (edge_tier, quality_tier) pair the cascade spans;
        both must have replica slots. The edge tier's replicas must run
        the confidence-summary predict (`cascade_summary=True`) — a
        result without a `confidence` leaf escalates unconditionally
        (correctness over throughput).
    cascade_threshold : escalate iff confidence < threshold (the
        calibrated operating point; `config.cascade_overrides`).
    """

    def __init__(self, replica_factory: Callable[[int, bool],
                                                 ServingEngine],
                 n_replicas: int, variables=None,
                 tenants: Optional[Dict[str, int]] = None,
                 replica_tiers: Optional[Sequence[str]] = None,
                 tenant_tiers: Optional[Dict[str, str]] = None,
                 tier_fallback: bool = False,
                 default_budget: int = 64, max_redispatch: int = 2,
                 deadline_ms: Optional[float] = None,
                 tenant_shed_requests: Optional[int] = None,
                 metrics=None, watchdog_objective: float = 0.05,
                 watchdog_burn: float = 2.0, injector=None, tracer=None,
                 start: bool = True,
                 cascade_tenants: Optional[Sequence[str]] = None,
                 cascade_tiers: Sequence[str] = ("edge", "quality"),
                 cascade_threshold: float = 0.0):
        from ..obs import metrics as metrics_mod
        from ..obs.slo import SloWatchdog, default_tenant_rules
        from ..obs.spans import maybe_tracer

        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1, got %d" % n_replicas)
        self._factory = replica_factory
        tiers = list(replica_tiers) if replica_tiers is not None \
            else [DEFAULT_TIER] * int(n_replicas)
        if len(tiers) != int(n_replicas):
            raise ValueError(
                "replica_tiers must name every slot: %d tiers for %d "
                "replicas" % (len(tiers), n_replicas))
        self._tiers = [str(t) for t in tiers]
        self._tier_fallback = bool(tier_fallback)
        self._tenant_tiers = {
            _sanitize_tenant(k): str(v)
            for k, v in (tenant_tiers or {}).items()}
        unknown = set(self._tenant_tiers.values()) - set(self._tiers)
        if unknown:
            raise ValueError(
                "tenant_tiers name tier(s) with no replica slot: %s "
                "(replica tiers: %s)"
                % (sorted(unknown), sorted(set(self._tiers))))
        # cascade policy: enabled iff any tenant is enrolled
        self._cascade_tenants = frozenset(
            _sanitize_tenant(t) for t in (cascade_tenants or ()))
        ctiers = tuple(str(t) for t in cascade_tiers)
        self._cascade_tiers = ctiers
        self._cascade_threshold = float(cascade_threshold)
        if self._cascade_tenants:
            if len(ctiers) != 2 or ctiers[0] == ctiers[1]:
                raise ValueError(
                    "cascade_tiers must be a (edge, quality) pair of two "
                    "distinct tiers, got %r" % (ctiers,))
            missing = set(ctiers) - set(self._tiers)
            if missing:
                raise ValueError(
                    "cascade tier(s) with no replica slot: %s (replica "
                    "tiers: %s)" % (sorted(missing),
                                    sorted(set(self._tiers))))
        # stable weights are PER TIER (a quality checkpoint cannot fit an
        # edge replica's param tree); plain weights `variables` apply
        # to every tier — the homogeneous-fleet (pre-tier) behavior
        if isinstance(variables, dict) and variables \
                and set(variables) <= set(self._tiers):
            self._stable_variables = dict(variables)
        elif variables is not None:
            self._stable_variables = {t: variables
                                      for t in set(self._tiers)}
        else:
            self._stable_variables = {}
        self._max_redispatch = max(0, int(max_redispatch))
        self._deadline_ms = deadline_ms
        self._default_budget = max(1, int(default_budget))
        self._tenant_shed_requests = tenant_shed_requests
        self._objective = float(watchdog_objective)
        self._burn = float(watchdog_burn)
        self._injector = injector
        self._tracer = tracer if tracer is not None else maybe_tracer()
        self._metrics = (metrics if metrics is not None
                         else metrics_mod.default_registry())
        self._m_writer = metrics_mod.maybe_writer(registry=self._metrics)
        mm = self._metrics
        self._mc = {name: mm.counter("fleet." + name) for name in (
            "submitted", "completed", "lost", "shed_tenant",
            "shed_capacity", "shed_deadline", "redispatched",
            "dispatch_faults", "replica_deaths", "respawns", "rollouts",
            "promotes", "rollbacks", "escalated", "edge_resolved",
            "degraded_answers")}
        self._mg_replicas = mm.gauge("fleet.replicas")
        self._mh_e2e = mm.histogram("fleet.e2e_ms")

        self._lock = threading.Lock()
        self._replicas: List[_Replica] = [
            _Replica(rid, self._spawn(rid, start=start),
                     tier=self._tiers[rid])
            for rid in range(int(n_replicas))]
        self._mg_replicas.set(len(self._replicas))
        self._tenants: Dict[str, _Tenant] = {}
        for name, budget in (tenants or {}).items():
            t = _sanitize_tenant(name)
            self._tenants[t] = _Tenant(t, budget, mm)
        # ONE fleet watchdog over the per-tenant burn rules; alerts map
        # back to the tenant by rule-name prefix (default_tenant_rules)
        self._make_tenant_rules = lambda t: default_tenant_rules(
            t, deadline_ms=self._deadline_ms, objective=self._objective,
            burn=self._burn)
        self._watchdog = SloWatchdog([], registry=mm, tracer=self._tracer)
        for t in self._tenants.values():
            self._watchdog.rules.extend(self._make_tenant_rules(t.name))
        self._canary: Optional[_Replica] = None
        self._canary_frac = 0.0
        self._canary_k = 0
        self._closing = False

    # ---- lifecycle -------------------------------------------------------

    def _spawn(self, rid: int, start: bool = True) -> ServingEngine:
        """The one place a replica engine is built (the factory)."""
        engine = self._factory(rid, start)
        return engine

    def start(self) -> None:
        for rep in self._replicas:
            rep.engine.start()

    def close(self) -> None:
        """Graceful fleet shutdown: stop re-dispatching, close every
        replica (each drains its admitted work), final metrics flush.
        Idempotent."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        for rep in self._replicas:
            try:
                rep.engine.close()
            except Exception:  # noqa: BLE001 — close every replica
                pass
        self._m_writer.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- health ----------------------------------------------------------

    @property
    def replicas(self) -> int:
        return len(self._replicas)

    @property
    def engines(self) -> List[ServingEngine]:
        """The replica engines now in the slots, by rid (read-only: for
        inspection, never for traffic)."""
        with self._lock:
            return [rep.engine for rep in self._replicas]

    def health(self) -> Dict:
        """Fleet digest: per-replica engine health (the consistent
        snapshot, without per-replica metrics digests), tenant budgets /
        penalty boxes, canary state and the fleet counters."""
        with self._lock:
            canary = self._canary
            canary_frac = self._canary_frac
            # each slot's fields with the canary in the same window: a
            # respawn moves the engine, the generation and the canary
            # together
            reps = [(rep.rid, rep.generation, rep.tier, rep.engine,
                     canary is rep) for rep in self._replicas]
            tenants = {t.name: {"budget": t.budget,
                                "outstanding": t.outstanding,
                                "penalty": t.penalty,
                                "submitted": t.c_submitted.value,
                                "completed": t.c_completed.value,
                                "shed": t.c_shed.value,
                                "failed": t.c_failed.value}
                       for t in self._tenants.values()}
        return {
            "replicas": [dict(rid=rid, generation=gen, tier=tier,
                              canary=is_canary,
                              **engine.health(include_metrics=False))
                         for rid, gen, tier, engine, is_canary in reps],
            "tenants": tenants,
            "tenant_tiers": dict(self._tenant_tiers),
            "cascade": (None if not self._cascade_tenants else {
                "tiers": list(self._cascade_tiers),
                "threshold": self._cascade_threshold,
                "tenants": sorted(self._cascade_tenants)}),
            "canary": (None if canary is None
                       else {"rid": canary.rid,
                             "frac": canary_frac}),
            "counters": {("fleet." + k): c.value
                         for k, c in sorted(self._mc.items())},
            "alerts": list(self._watchdog.alerts),
        }

    def stats(self) -> Dict[str, int]:
        return {k: c.value for k, c in self._mc.items()}

    # ---- tenant admission ------------------------------------------------

    def _tenant(self, name: str) -> _Tenant:  # guarded-by: _lock
        # every caller (submit/_shed/_on_replica_done) holds the router
        # lock — the call-graph fact the annotation states for the audit
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name, self._default_budget,
                                              self._metrics)
            self._watchdog.rules.extend(self._make_tenant_rules(name))
        return t

    def _tenant_alerts(self, fired: List[Dict]) -> None:  # guarded-by: _lock
        """Map fired `tenant-<t>-*` alerts to penalty boxes (called with
        the router lock HELD)."""
        for alert in fired:
            rule = alert.get("rule", "")
            if not rule.startswith("tenant-"):
                continue
            name = rule[len("tenant-"):].rsplit("-", 2)[0]
            t = self._tenants.get(name)
            if t is None:
                continue
            box = (self._tenant_shed_requests
                   if self._tenant_shed_requests is not None
                   else t.budget)
            t.penalty = max(t.penalty, int(box))
            self._tracer.event("fleet:tenant-shed", tenant=name,
                               penalty=t.penalty, rule=rule)

    # ---- dispatch --------------------------------------------------------

    def _score(self, rep: _Replica):
        """(score, state) for a routable replica, None for CLOSED."""
        h = rep.engine.health(include_metrics=False)
        state = h["state"]
        if state == CLOSED:
            return None
        score = float(h["queued"] + h["retry_queued"]
                      + h["inflight_batches"] * rep.engine.buckets[-1])
        if state == DEGRADED:
            score += PENALTY_DEGRADED
        elif state == DRAINING:
            score += PENALTY_DRAINING
        return score, state

    def _candidates(self, exclude_engines: set,
                    to_canary: bool,
                    tier: Optional[str] = None) -> List[_Replica]:
        """Replicas in dispatch order: canary-first for the canary slice,
        else least-loaded among non-canary (canary excluded from the
        non-canary share so its observation window stays ~frac), with
        every non-CLOSED replica as fallback so a full/dead primary never
        strands a request the fleet could still serve. DRAINING replicas
        are dropped outright whenever anything else is routable: a
        mid-reload engine must be able to run dry — routing into its
        drain would stall the reload under sustained load (it stays the
        last resort only when the whole fleet is draining)."""
        with self._lock:
            reps = list(self._replicas)
            canary = self._canary
        if tier is not None:
            # tier pin: STRICT — a wrong-tier answer is a
            # wrong result; tier_fallback opts into any-tier fallback
            tiered = [rep for rep in reps if rep.tier == tier]
            if tiered or not self._tier_fallback:
                reps = tiered
        scored = []
        for rep in reps:
            if id(rep.engine) in exclude_engines:
                continue
            ss = self._score(rep)
            if ss is None:
                continue
            scored.append((ss[0], rep.rid, rep, ss[1]))
        scored.sort(key=lambda x: (x[0], x[1]))
        if any(state != DRAINING for _, _, _, state in scored):
            scored = [row for row in scored if row[3] != DRAINING]
        ordered = [rep for _, _, rep, _ in scored]
        if canary is not None and canary in ordered:
            if to_canary:
                ordered.remove(canary)
                ordered.insert(0, canary)
            else:
                # non-canary share: canary only as the last resort
                ordered.remove(canary)
                ordered.append(canary)
        return ordered

    def _dispatch(self, req: _Request, exclude_engines: set,
                  to_canary: bool = False) -> bool:
        """Try candidates in order until one admits the request; chain
        the fleet future onto the replica future. False = nobody
        admitted (fleet capacity shed). The one place a request reaches
        a replica engine."""
        if self._injector is not None:
            try:
                self._injector.fire("fleet:dispatch")
            except Exception as e:  # noqa: BLE001 — routing-layer fault
                self._mc["dispatch_faults"].inc()
                self._tracer.event("fleet:dispatch-fault",
                                   ctx=(req.ctx.child() if req.ctx
                                        else None),
                                   error=type(e).__name__)
                # transient front-door fault: the request is still ours;
                # fall through and route it (bounded by the schedule)
        fut = req.future
        remaining = (None if fut.deadline is None
                     else fut.deadline - time.monotonic())
        if remaining is not None and remaining <= 0:
            self._shed(req, "deadline", SheddedError(
                "deadline passed before fleet dispatch"))
            return True  # resolved (as a shed), not a capacity miss
        for rep in self._candidates(exclude_engines, to_canary,
                                    tier=req.tier):
            eng = rep.engine  # pin: a respawn may swap rep.engine later
            try:
                sf = eng.submit(req.image, deadline_s=remaining,
                                block=False, ctx=req.ctx)
            except EngineClosedError:
                continue  # raced a death; next candidate
            err = sf.exception()
            if err is not None and isinstance(err, SheddedError):
                continue  # this replica's queue is full; next candidate
            fut.replicas.append(rep.rid)
            # the submit -> this-dispatch window as a named stage: router
            # turnaround (admission, scoring, host scheduling) and — on a
            # re-dispatch — the whole failed previous hop; without it a
            # starved-host or re-dispatched p99 waterfall cannot
            # attribute its leading gap
            self._tracer.record("fleet:dispatch-wait",
                                time.monotonic() - fut.t_submit,
                                ctx=(req.ctx.child() if req.ctx
                                     else None),
                                rid=rep.rid, attempt=req.attempts)
            self._tracer.event("fleet:dispatch",
                               ctx=(req.ctx.child() if req.ctx
                                    else None),
                               rid=rep.rid, tenant=fut.tenant)
            sf.add_done_callback(
                lambda f, req=req, rid=rep.rid, eng=eng:
                self._on_replica_done(req, rid, eng, f))
            return True
        return False

    def _shed(self, req: _Request, reason: str,
              error: SheddedError) -> None:
        if req.edge_result is not None:
            # cascade: the quality hop shed, but the edge
            # answer is in hand — degrade instead of losing the ack
            self._degrade(req, "shed-" + reason)
            return
        fut = req.future
        if not fut._fail(error):
            return
        with self._lock:
            t = self._tenant(fut.tenant)
            t.outstanding = max(0, t.outstanding - 1)
            t.c_shed.inc()
        self._mc["shed_deadline" if reason == "deadline"
                 else "shed_capacity"].inc()
        # the shed IS the trace's closure: the router minted the root
        self._tracer.event("fleet:shed", ctx=req.ctx, reason=reason,
                           tenant=fut.tenant)

    def _complete(self, req: _Request, rid: int, value,
                  degraded: bool = False,
                  bucket: Optional[int] = None) -> None:
        """Resolve + account one fleet request (the ONE completion path:
        plain, cascade edge-resolve, escalated, and degraded answers all
        end here, so `fleet:e2e` fires exactly once per trace)."""
        fut = req.future
        if degraded:
            fut.degraded_answer = True
        fut.bucket = bucket
        if not fut._set(value):
            return
        e2e_ms = (fut.t_done - fut.t_submit) * 1e3
        with self._lock:
            t = self._tenant(fut.tenant)
            t.outstanding = max(0, t.outstanding - 1)
            t.c_completed.inc()
            t.h_e2e.observe(e2e_ms)
            fired = self._watchdog.check()
            self._tenant_alerts(fired)
        self._mc["completed"].inc()
        if degraded:
            self._mc["degraded_answers"].inc()
        self._mh_e2e.observe(e2e_ms)
        # the fleet-level e2e closes the trace the router minted
        # (the replica's serve:e2e is a child hop of it); cascade
        # requests carry their outcome so a waterfall can attribute
        # two-hop tails without re-deriving the policy
        extra = ({"escalated": fut.escalated,
                  "degraded": fut.degraded_answer}
                 if req.cascade else {})
        self._tracer.record("fleet:e2e", fut.t_done - fut.t_submit,
                            ctx=req.ctx, tenant=fut.tenant, rid=rid,
                            redispatches=fut.redispatches, **extra)
        self._m_writer.maybe_flush()

    def _degrade(self, req: _Request, reason: str) -> None:
        """Cascade fallback: the quality hop cannot answer
        (dead tier, shed, deadline, injected fault) — resolve with the
        in-hand EDGE result, flagged `degraded_answer`. Never a lost
        ack; never re-raised."""
        self._tracer.event("fleet:degraded",
                           ctx=(req.ctx.child() if req.ctx else None),
                           tenant=req.future.tenant,
                           reason=str(reason)[:200])
        self._complete(req, req.edge_rid, req.edge_result, degraded=True,
                       bucket=req.edge_bucket)

    def _escalate(self, req: _Request, rid: int, value,
                  confidence, bucket: Optional[int] = None) -> None:
        """Edge confidence below threshold: hold the edge answer and
        dispatch the SAME request (same future, same root TraceContext)
        to the quality tier as a child hop."""
        fut = req.future
        req.edge_result = value
        req.edge_rid = rid
        req.edge_bucket = bucket
        req.tier = self._cascade_tiers[1]
        fut.escalated = True
        fut.edge_confidence = (None if confidence is None
                               else float(confidence))
        self._mc["escalated"].inc()
        self._tracer.event("fleet:escalate",
                           ctx=(req.ctx.child() if req.ctx else None),
                           rid=rid, tenant=fut.tenant,
                           confidence=(None if confidence is None
                                       else float(confidence)),
                           threshold=self._cascade_threshold)
        if self._injector is not None:
            # the fleet:escalate chaos site (runtime/faults.py): a
            # device-loss here models the quality tier erroring as the
            # hop launches -> degrade; a worker-death kills the SELECTED
            # quality replica (a different engine than the one whose
            # fetcher thread runs this callback — killing our own would
            # self-join) and the hop proceeds through the respawn
            try:
                ev = self._injector.fire("fleet:escalate")
            except Exception as e:  # noqa: BLE001 — injected hop fault
                self._degrade(req, "escalate-fault:" + type(e).__name__)
                return
            if ev is not None and ev.kind == "worker-death":
                self._kill_least_loaded(tier=req.tier)
        if not self._dispatch(req, exclude_engines=set()):
            self._degrade(req, "no-quality-capacity")

    def _on_replica_done(self, req: _Request, rid: int, engine,
                         sf) -> None:
        """Replica future completed: success -> complete + account (or,
        for a cascade first hop below threshold, escalate); deadline
        shed -> propagate; replica failure -> bounded re-dispatch
        elsewhere, else the error surfaces (a lost ack) — unless an edge
        answer is in hand, which degrades instead. `engine` is the
        engine the request FAILED ON (pinned at dispatch — after a
        respawn the slot holds a fresh engine that must remain a
        re-dispatch candidate, single-replica fleets included)."""
        fut = req.future
        err = sf.exception()
        if err is None:
            value = sf._value
            if req.cascade and req.edge_result is None:
                # cascade first hop: the graph's confidence decides.
                # A missing confidence leaf (edge replicas built without
                # cascade_summary) escalates unconditionally —
                # correctness over throughput
                conf = getattr(value, "confidence", None)
                if conf is not None \
                        and float(conf) >= self._cascade_threshold:
                    self._mc["edge_resolved"].inc()
                    self._complete(req, rid, value, bucket=sf.bucket)
                else:
                    self._escalate(req, rid, value, conf,
                                   bucket=sf.bucket)
                return
            self._complete(req, rid, value, bucket=sf.bucket)
            return
        if isinstance(err, SheddedError):
            # the engine shed on DEADLINE (fleet admission already
            # happened): propagate — expired work is not re-dispatched
            # (a cascade second hop degrades inside _shed)
            self._shed(req, "deadline", err)
            return
        # replica-level failure: re-dispatch within budget and deadline
        with self._lock:
            closing = self._closing
        if (not closing) and req.attempts < self._max_redispatch:
            req.attempts += 1
            fut.redispatches += 1
            self._mc["redispatched"].inc()
            self._tracer.event("fleet:redispatch",
                               ctx=(req.ctx.child() if req.ctx
                                    else None),
                               rid=rid, attempt=req.attempts,
                               error=type(err).__name__)
            if self._dispatch(req, exclude_engines={id(engine)}):
                return
            # nobody could take it: fall through to surface the error
        if req.edge_result is not None:
            # cascade: the quality hop failed out of budget — the edge
            # answer still stands (degraded, never lost)
            self._degrade(req, "hop-failure:" + type(err).__name__)
            return
        if fut._fail(err):
            with self._lock:
                t = self._tenant(fut.tenant)
                t.outstanding = max(0, t.outstanding - 1)
                t.c_failed.inc()
                fired = self._watchdog.check()
                self._tenant_alerts(fired)
            self._mc["lost"].inc()
            # a surfaced error is still a closure: the trace ends here
            self._tracer.event("fleet:lost", ctx=req.ctx,
                               tenant=fut.tenant,
                               error=type(err).__name__)

    # ---- client API ------------------------------------------------------

    def submit(self, image: np.ndarray, tenant: str = DEFAULT_TENANT,
               deadline_s: Optional[float] = None,
               block: bool = False,
               tier: Optional[str] = None) -> FleetFuture:
        """Route one request. Admission is per-tenant (budget + penalty
        box) then per-fleet (every replica's queue full => capacity
        shed); an admitted request is ACKNOWLEDGED — it completes with a
        result or a surfaced error, through re-dispatch if its replica
        dies. Never blocks on a
        replica queue (engine submits use block=False — blocking the
        router on one replica would stall every tenant); the `block`
        parameter exists for ServingEngine.submit API compatibility (the
        load loops drive either) and is ignored.

        `tier` pins the request to that tier's replicas;
        unset, the tenant's `tenant_tiers` policy applies (bulk tenants
        -> cheap tier, flagged -> quality); a
        tenant with no policy routes fleet-wide as before. A
        `cascade_tenants` tenant with no explicit pin takes the
        edge-first cascade path instead — an explicit `tier=`
        opts a single request out of the cascade."""
        del block  # API-compat only: a router shed is always immediate
        with self._lock:
            closing = self._closing
        if closing:
            raise EngineClosedError("fleet router closed")
        tenant = _sanitize_tenant(tenant)
        cascade = False
        if tier is None:
            if tenant in self._cascade_tenants:
                cascade = True
                tier = self._cascade_tiers[0]  # edge hop first
            else:
                tier = self._tenant_tiers.get(tenant)
        elif tier not in set(self._tiers):
            raise ValueError("unknown tier %r (replica tiers: %s)"
                             % (tier, sorted(set(self._tiers))))
        fut = FleetFuture(tenant, deadline=None if deadline_s is None
                          else time.monotonic() + float(deadline_s))
        # the ROOT trace context is minted here, at the fleet front door
        #: it rides through tenant admission, dispatch
        # scoring, the canary split, every replica hop and re-dispatch
        ctx = new_root() if self._tracer.enabled else None
        fut.ctx = ctx
        req = _Request(np.asarray(image), fut, tier=tier, ctx=ctx,
                       cascade=cascade)
        self._mc["submitted"].inc()
        # fleet:replica chaos: a worker-death kills the replica the
        # request WOULD have routed to (submit path only — never from an
        # engine-thread callback, where killing would self-join)
        if self._injector is not None:
            ev = self._injector.fire("fleet:replica")
            if ev is not None and ev.kind == "worker-death":
                self._kill_least_loaded()
        with self._lock:
            t = self._tenant(tenant)
            t.c_submitted.inc()
            if t.penalty > 0:
                t.penalty -= 1
                t.c_shed.inc()
                fut._fail(TenantSheddedError(
                    "tenant %s in SLO penalty box" % tenant))
                self._mc["shed_tenant"].inc()
                shed_reason = "tenant-slo"
            elif t.outstanding >= t.budget:
                t.c_shed.inc()
                fut._fail(TenantSheddedError(
                    "tenant %s over budget (%d outstanding)"
                    % (tenant, t.outstanding)))
                self._mc["shed_tenant"].inc()
                shed_reason = "tenant-budget"
            else:
                t.outstanding += 1
                shed_reason = None
            if self._canary is not None:
                self._canary_k += 1
                k = self._canary_k
                to_canary = (int(k * self._canary_frac)
                             != int((k - 1) * self._canary_frac))
            else:
                to_canary = False
        if shed_reason is not None:
            self._tracer.event("fleet:shed", ctx=ctx, reason=shed_reason,
                               tenant=tenant)
            return fut
        if not self._dispatch(req, exclude_engines=set(),
                              to_canary=to_canary):
            self._shed(req, "capacity", SheddedError(
                "every replica shed (fleet at capacity)"))
        return fut

    def predict_many(self, images: Sequence[np.ndarray],
                     tenant: str = DEFAULT_TENANT,
                     tier: Optional[str] = None) -> List:
        futs = [self.submit(img, tenant=tenant, tier=tier)
                for img in images]
        return [f.result() for f in futs]

    # ---- replica death / respawn -----------------------------------------

    def _kill_least_loaded(self, tier: Optional[str] = None) -> None:
        with self._lock:
            reps = list(self._replicas)
        if tier is not None:
            reps = [rep for rep in reps if rep.tier == tier]
        best = None
        for rep in reps:
            ss = self._score(rep)
            if ss is not None and (best is None or ss[0] < best[0]):
                best = (ss[0], rep)
        if best is not None:
            self.kill_replica(best[1].rid, reason="fault: worker-death")

    def kill_replica(self, rid: int, reason: str = "killed") -> None:
        """Abrupt replica death + respawn-and-requeue (the
        `fleet:replica` recovery path; also the chaos tests' lever). The
        fresh engine is swapped into the slot BEFORE the old one is
        killed, so the killed requests' re-dispatch callbacks always see
        a live fleet — single-replica fleets heal too."""
        with self._lock:
            rep = next((r for r in self._replicas if r.rid == rid), None)
            if rep is None:
                raise ValueError("no replica %d" % rid)
            old = rep.engine
            canary_died = self._canary is rep
        self._mc["replica_deaths"].inc()
        self._tracer.event("fleet:replica-death", rid=rid,
                           reason=str(reason)[:200])
        fresh = self._spawn(rid, start=True)
        stable = self._stable_variables.get(rep.tier)
        if stable is not None:
            # a respawn mid-rollout (or post-promote) must not resurrect
            # the factory's original weights — per-TIER stable weights
            # (a quality checkpoint cannot fit an edge replica)
            fresh.reload(stable)
        with self._lock:
            rep.engine = fresh
            rep.generation += 1
            if canary_died:
                self._canary = None  # rollout poll sees the death
        old.kill(reason)  # queued acks fail -> callbacks re-dispatch
        self._mc["respawns"].inc()
        self._tracer.event("fleet:respawn", rid=rid,
                           generation=rep.generation)

    # ---- canary rollout --------------------------------------------------

    def rollout(self, variables, canary_frac: float = 0.25,
                window: int = 16, timeout_s: float = 60.0,
                poll_s: float = 0.002,
                tier: Optional[str] = None) -> Dict:
        """Canary rollout (module docstring): swap ONE replica to
        `variables`, watch `window` post-swap completions on the canary
        slice, promote to the rest on a clean window, roll back on any
        canary `alert:*` (or canary death). Blocking control path —
        traffic flows from other threads meanwhile (mirrors
        engine.drain's polling discipline). Returns the outcome dict.

        On a heterogeneous (multi-tier) fleet `tier` is REQUIRED: the
        canary pick, the promote fan-out and the rollback target are all
        scoped to that tier's replicas — a quality checkpoint does not
        fit an edge replica's param tree."""
        from ..obs.slo import (ErrorBurnRule, LatencyBurnRule,
                               SloWatchdog)
        fleet_tiers = set(self._tiers)
        if tier is None:
            if len(fleet_tiers) > 1:
                raise ValueError(
                    "rollout on a multi-tier fleet needs tier=: replica "
                    "tiers are %s" % sorted(fleet_tiers))
            tier = next(iter(fleet_tiers))
        elif tier not in fleet_tiers:
            raise ValueError("unknown tier %r (replica tiers: %s)"
                             % (tier, sorted(fleet_tiers)))
        if self._stable_variables.get(tier) is None:
            raise ValueError("rollout needs the stable checkpoint: "
                             "construct FleetRouter(variables=...)")
        with self._lock:
            if self._canary is not None:
                raise RuntimeError("a rollout is already in progress")
            reps = [r for r in self._replicas if r.tier == tier]
        frac = min(1.0, max(0.0, float(canary_frac)))
        # deterministic pick: healthiest (lowest score), lowest rid
        scored = sorted((ss[0], r.rid, r) for ss, r in
                        ((self._score(r), r) for r in reps)
                        if ss is not None)
        if not scored:
            raise EngineClosedError("no live replica to canary")
        canary = scored[0][2]
        rules = [ErrorBurnRule("canary-error-burn",
                               err="serve.failed_batches",
                               total="serve.batches_total",
                               objective=self._objective, burn=self._burn,
                               min_total=1)]
        if self._deadline_ms is not None:
            rules.append(LatencyBurnRule(
                "canary-latency-burn", hist="serve.e2e_ms",
                threshold=self._deadline_ms, objective=self._objective,
                burn=self._burn, min_count=max(1, window // 4)))
        creg = canary.engine.metrics
        for rule in rules:
            rule.prime(creg)  # post-swap window only
        wd = SloWatchdog(rules, registry=creg, tracer=self._tracer)
        c0 = creg.counter("serve.completed").value
        self._mc["rollouts"].inc()
        self._tracer.event("fleet:rollout", rid=canary.rid, frac=frac,
                           window=window)
        canary.engine.reload(variables)
        with self._lock:
            self._canary = canary
            self._canary_frac = frac
            self._canary_k = 0
        outcome = ROLLOUT_TIMEOUT
        deadline = time.monotonic() + max(0.0, timeout_s)
        try:
            while time.monotonic() < deadline:
                with self._lock:
                    died = self._canary is not canary
                fired = [] if died else wd.check()
                if died or fired or canary.engine.state == CLOSED:
                    died = died or canary.engine.state == CLOSED
                    reason = ("replica-death" if died
                              else fired[0].get("rule", "alert"))
                    outcome = ROLLED_BACK
                    self._end_canary(canary)
                    self._rollback(canary, died, reason, wd)
                    break
                done = creg.counter("serve.completed").value - c0
                if done >= max(1, int(window)):
                    outcome = PROMOTED
                    self._end_canary(canary)
                    self._promote(canary, variables, tier)
                    break
                time.sleep(poll_s)
            else:
                # observation window never filled: fail safe — back out
                outcome = ROLLED_BACK
                self._end_canary(canary)
                self._rollback(canary, False, "window-timeout", wd)
        finally:
            with self._lock:
                if self._canary is canary:
                    self._canary = None
                self._canary_frac = 0.0
        return {"outcome": outcome, "canary": canary.rid,
                "observed": creg.counter("serve.completed").value - c0,
                "alerts": list(wd.alerts)}

    def _end_canary(self, canary: _Replica) -> None:
        """Stop canary-share routing BEFORE the promote/rollback reloads:
        the reloading engines must run dry, and a canary-first split
        would keep feeding the one being drained."""
        with self._lock:
            if self._canary is canary:
                self._canary = None
            self._canary_frac = 0.0

    def _reload_or_respawn(self, rep: _Replica, variables) -> None:
        """Swap a replica's weights, with the death path as the fallback:
        a reload whose drain times out (a replica wedged under sustained
        saturation) is resolved by kill+respawn — the fresh engine starts
        at the CURRENT stable weights, so either path converges and a
        rollout can never strand a replica on the outgoing checkpoint."""
        if rep.engine.state == CLOSED:
            return
        try:
            rep.engine.reload(variables)
        except TimeoutError:
            self._tracer.event("fleet:reload-timeout", rid=rep.rid)
            self.kill_replica(rep.rid, reason="reload drain timeout")

    def _promote(self, canary: _Replica, variables,
                 tier: str) -> None:
        with self._lock:
            others = [r for r in self._replicas
                      if r is not canary and r.tier == tier]
        # stable flips FIRST: a respawn fallback (or a concurrent death)
        # during the fan-out must come up on the NEW weights; only THIS
        # tier's stable entry moves (other tiers keep their checkpoints)
        self._stable_variables[tier] = variables
        for rep in others:
            self._reload_or_respawn(rep, variables)
        self._mc["promotes"].inc()
        self._tracer.event("fleet:promote", rid=canary.rid, tier=tier,
                           replicas=len(others) + 1)

    def _rollback(self, canary: _Replica, died: bool, reason: str,
                  wd) -> None:
        if not died:
            self._reload_or_respawn(canary,
                                    self._stable_variables[canary.tier])
        # a dead canary was already respawned at the STABLE weights by
        # kill_replica — the rollback is the respawn itself
        self._mc["rollbacks"].inc()
        self._tracer.event("fleet:rollback", rid=canary.rid,
                           reason=str(reason)[:200],
                           alerts=len(wd.alerts))
