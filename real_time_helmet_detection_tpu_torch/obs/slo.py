"""SLO watchdog: drift detection and error-budget burn rules over metrics.

Port of ref real_time_helmet_detection_tpu/obs/slo.py:58-332
(`DriftDetector`, the drift / error-burn / latency-burn rules,
`default_serving_rules`, `default_tenant_rules`, `default_train_rules`,
`SloWatchdog`) over the port's `obs/metrics.py`. The watchdog reads the
metrics registry and a few directly observed series and turns a sustained
bad signal into an `alert:<rule>` span-log event and, for a serving rule,
a DEGRADED flip of the attached `serving.ServingEngine` (which checks it
after every batch outcome).

* stdlib only and deterministic: every detector is arithmetic over the
  observed sequence (EWMA mean/variance z-scores, windowed budget
  fractions), with no wall clock, so replaying one fault schedule
  (`runtime/faults.py`) through one request stream gives the same alerts.
* Alerts fire on transitions: a rule that stays bad alerts once until a
  clean evaluation re-arms it.
* `check()` is O(#rules) host arithmetic over counter and histogram reads.

===================  ====================================================
rule                 fires when
===================  ====================================================
drift (z-score)      |value - EWMA mean| > z_thresh * EWMA std after a
                     warmup count (step time, loss)
error burn           windowed error fraction (err counter delta / total
                     counter delta) > objective * burn factor (failed
                     batches per batch)
latency burn         windowed fraction of histogram observations at or
                     above `threshold` > objective * burn factor (the
                     share of serve e2e requests over the deadline)
===================  ====================================================
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from .metrics import Histogram, MetricsRegistry, default_registry

ALERT_EVENT_PREFIX = "alert:"


class DriftDetector:
    """EWMA mean/variance z-score drift detector (deterministic).

    `observe(v)` returns the z-score when it crossed `z_thresh` (an
    alert) or None. The first `warmup` observations only train the
    baseline; the EWMA update ALWAYS runs, so a drifted regime
    eventually becomes the new baseline (one alert per excursion, not an
    alert forever)."""

    def __init__(self, alpha: float = 0.1, z_thresh: float = 4.0,
                 warmup: int = 20, min_std_frac: float = 0.01):
        self.alpha = float(alpha)
        self.z_thresh = float(z_thresh)
        self.warmup = int(warmup)
        # std floor as a fraction of |mean|: a perfectly flat warmup
        # series must not make every later jitter an infinite z
        self.min_std_frac = float(min_std_frac)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def observe(self, v) -> Optional[float]:
        v = float(v)
        z = None
        if self.n >= self.warmup:
            std = math.sqrt(max(self.var, 0.0))
            std = max(std, abs(self.mean) * self.min_std_frac, 1e-12)
            score = (v - self.mean) / std
            if abs(score) > self.z_thresh:
                z = score
        if self.n == 0:
            self.mean = v
        else:
            d = v - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d)
        self.n += 1
        return z


class Rule:
    """Base: named, transition-armed (one alert until a clean check)."""

    def __init__(self, name: str):
        self.name = name
        self._bad = False

    def _transition(self, bad: bool) -> bool:
        """True only on the clean->bad edge."""
        fired = bad and not self._bad
        self._bad = bad
        return fired


class DriftRule(Rule):
    """Drift on a directly-observed series (step time, loss). Fed via
    `SloWatchdog.observe(series, value)`; `check()` never fires it."""

    def __init__(self, name: str, series: str, alpha: float = 0.1,
                 z_thresh: float = 4.0, warmup: int = 20):
        super().__init__(name)
        self.series = series
        self.detector = DriftDetector(alpha=alpha, z_thresh=z_thresh,
                                      warmup=warmup)

    def feed(self, value: float) -> Optional[Dict]:
        z = self.detector.observe(value)
        if not self._transition(z is not None):
            return None
        return {"rule": self.name, "kind": "drift", "series": self.series,
                "value": float(value), "z": round(z, 3),
                "mean": round(self.detector.mean, 6)}


class ErrorBurnRule(Rule):
    """Windowed error-budget burn over two counters: the fraction
    err_delta/total_delta since the last check exceeding
    `objective * burn` fires. `min_total` gates tiny windows (one failed
    batch out of one is not a statistic)."""

    def __init__(self, name: str, err: str, total: str,
                 objective: float = 0.01, burn: float = 2.0,
                 min_total: int = 1):
        super().__init__(name)
        self.err = err
        self.total = total
        self.objective = float(objective)
        self.burn = float(burn)
        self.min_total = int(min_total)
        self._err0 = 0
        self._total0 = 0

    def prime(self, reg: MetricsRegistry) -> None:
        """Anchor the burn window at the registry's CURRENT counts, so
        the first check() covers only observations made after this call —
        the canary-rollout requirement: a canary must be
        judged on its post-swap traffic, not on counter history from
        before the rollout."""
        self._err0 = reg.counter(self.err).value
        self._total0 = reg.counter(self.total).value

    def check(self, reg: MetricsRegistry) -> Optional[Dict]:
        err = reg.counter(self.err).value
        total = reg.counter(self.total).value
        d_err = err - self._err0
        d_total = total - self._total0
        if d_total < self.min_total:
            return None  # window too small: keep accumulating
        self._err0, self._total0 = err, total
        frac = d_err / d_total if d_total else 0.0
        if not self._transition(frac > self.objective * self.burn):
            return None
        return {"rule": self.name, "kind": "error-burn",
                "err": self.err, "total": self.total,
                "frac": round(frac, 4),
                "budget": round(self.objective * self.burn, 4),
                "window": d_total}


class LatencyBurnRule(Rule):
    """Windowed latency-budget burn over a histogram: the fraction of
    observations >= `threshold` (bucket granularity) among those added
    since the last check exceeding `objective * burn` fires."""

    def __init__(self, name: str, hist: str, threshold: float,
                 objective: float = 0.01, burn: float = 2.0,
                 min_count: int = 8):
        super().__init__(name)
        self.hist = hist
        self.threshold = float(threshold)
        self.objective = float(objective)
        self.burn = float(burn)
        self.min_count = int(min_count)
        self._prev: Optional[List[int]] = None

    def prime(self, reg: MetricsRegistry) -> None:
        """Anchor the window at the histogram's current buckets (the
        ErrorBurnRule.prime contract, for the same canary reason)."""
        h = reg.histogram(self.hist)
        with h._lock:
            self._prev = list(h._buckets)

    def _over_and_total(self, h: Histogram) -> tuple:
        with h._lock:
            buckets = list(h._buckets)
        prev = self._prev or [0] * len(buckets)
        if len(prev) != len(buckets):
            prev = [0] * len(buckets)
        delta = [b - p for b, p in zip(buckets, prev)]
        total = sum(delta)
        if total < self.min_count:
            return None, None  # window too small: keep accumulating
        self._prev = buckets
        over = sum(n for i, n in enumerate(delta)
                   if h._bucket_mid(i) >= self.threshold)
        return over, total

    def check(self, reg: MetricsRegistry) -> Optional[Dict]:
        h = reg.histogram(self.hist)
        over, total = self._over_and_total(h)
        if total is None:
            return None
        frac = over / total if total else 0.0
        if not self._transition(frac > self.objective * self.burn):
            return None
        return {"rule": self.name, "kind": "latency-burn",
                "hist": self.hist, "threshold": self.threshold,
                "frac": round(frac, 4),
                "budget": round(self.objective * self.burn, 4),
                "window": total}


def default_serving_rules(deadline_ms: Optional[float] = None,
                          objective: float = 0.05,
                          burn: float = 2.0) -> List[Rule]:
    """The engine's stock rule set: failed-batch burn always; e2e latency
    burn when a deadline is known."""
    rules: List[Rule] = [
        ErrorBurnRule("serve-error-burn", err="serve.failed_batches",
                      total="serve.batches_total", objective=objective,
                      burn=burn, min_total=1),
    ]
    if deadline_ms is not None:
        rules.append(LatencyBurnRule(
            "serve-latency-burn", hist="serve.e2e_ms",
            threshold=float(deadline_ms), objective=objective, burn=burn))
    return rules


def default_tenant_rules(tenant: str, deadline_ms: Optional[float] = None,
                         objective: float = 0.05,
                         burn: float = 2.0,
                         min_total: int = 4) -> List[Rule]:
    """Per-tenant burn rules over the fleet registry's `serve.tenant.<t>.*`
    names: error burn (failed acks / submitted) always, e2e
    latency burn when the tenant traffic carries a deadline. Rule names
    are `tenant-<t>-...` so the FleetRouter can map an `alert:*` back to
    the ONE tenant to shed (one tenant's burst sheds that tenant, not the
    fleet)."""
    prefix = "serve.tenant.%s." % tenant
    rules: List[Rule] = [
        ErrorBurnRule("tenant-%s-error-burn" % tenant,
                      err=prefix + "failed", total=prefix + "submitted",
                      objective=objective, burn=burn,
                      min_total=min_total),
    ]
    if deadline_ms is not None:
        rules.append(LatencyBurnRule(
            "tenant-%s-latency-burn" % tenant, hist=prefix + "e2e_ms",
            threshold=float(deadline_ms), objective=objective, burn=burn,
            min_count=min_total))
    return rules


def default_train_rules(z_thresh: float = 4.0,
                        warmup: int = 20) -> List[Rule]:
    """Train's stock rule set: step-time and loss drift (fed from the
    loop's existing host-side measurements — zero extra D2H)."""
    return [DriftRule("train-step-drift", series="train.step_ms",
                      z_thresh=z_thresh, warmup=warmup),
            DriftRule("train-loss-drift", series="train.loss",
                      z_thresh=z_thresh, warmup=warmup)]


class SloWatchdog:
    """Evaluates rules, records alerts, emits `alert:*` events and
    degrades an attached engine (see module docstring).

    `observe(series, value)` feeds DriftRules for that series (and may
    alert immediately); `check(engine=None)` evaluates the counter/
    histogram burn rules. Both are deterministic given the observation
    sequence."""

    def __init__(self, rules: List[Rule], registry=None, tracer=None,
                 degrade_on: Optional[set] = None):
        self.rules = list(rules)
        self.registry = registry if registry is not None \
            else default_registry()
        self._tracer = tracer
        # alert rule names that flip an attached engine to DEGRADED;
        # None = every serving rule ("serve-" prefix)
        self._degrade_on = degrade_on
        self.alerts: List[Dict] = []

    def _emit(self, alert: Dict, engine=None) -> None:
        self.alerts.append(alert)
        if self._tracer is not None:
            self._tracer.event(ALERT_EVENT_PREFIX + alert["rule"],
                               **{k: v for k, v in alert.items()
                                  if k != "rule"})
        if engine is not None:
            name = alert["rule"]
            hit = (name in self._degrade_on if self._degrade_on is not None
                   else name.startswith("serve-"))
            if hit:
                engine.degrade("slo alert: %s" % name)

    def observe(self, series: str, value, engine=None) -> None:
        for rule in self.rules:
            if isinstance(rule, DriftRule) and rule.series == series:
                alert = rule.feed(value)
                if alert is not None:
                    self._emit(alert, engine=engine)

    def check(self, engine=None) -> List[Dict]:
        fired = []
        for rule in self.rules:
            if isinstance(rule, DriftRule):
                continue
            alert = rule.check(self.registry)
            if alert is not None:
                fired.append(alert)
                self._emit(alert, engine=engine)
        return fired
