"""Deterministic, seeded fault injection: the chaos layer the serving
engine's recovery paths are tested against.

Port of ref real_time_helmet_detection_tpu/runtime/faults.py:136-327
(`FaultEvent`, `FaultSchedule`, `ChaosInjector`, `maybe_injector`) and
its site vocabulary (:87 `SERVE_SITES`), stdlib only. The loader and
artifact sites are kept as names, so a schedule written for the JAX
package parses here; the serving sites, the fleet's (`fleet:dispatch`,
`fleet:replica`, `fleet:escalate`; `serving/fleet.py`), the stream's
(`stream:frame`; `serving/streams.py`) and the train loop's
(`train:batch`: a `nan-batch` poisons the host batch; `train:rank`: a
`worker-death` raises the transient `UNAVAILABLE:` a lost rank would)
are instrumented in the port.

* A schedule is a finite list of `(site, kind, at)` events: `at` is the
  Nth arrival at that site, so a replay hits the same program points
  whatever the wall clock. `FaultSchedule.seeded(seed, n)` draws one from
  `random.Random(seed)` (the same events as the JAX package for the same
  seed); `spec()`/`parse()` round-trip the text form
  `serve:dispatch=device-loss@3,...`.
* One event fires once: per-site counters only grow, so a retried
  operation arrives with a higher count and a single fault cannot wedge a
  bounded-retry loop.
* `fire()` raises for `device-loss` (`UNAVAILABLE: ...`), sleeps
  `hang_s` (default 0.25 s) and raises `DEADLINE_EXCEEDED: ...` for
  `hung-fetch`, sleeps `slow_s` (default 0.05 s) for `slow-batch`, and
  returns the event of a data kind for the caller to apply; None means no
  fault. Every firing is a `fault:<kind>` event in the span log.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .errors import InjectedBackendError

FAULT_KINDS = ("device-loss", "hung-fetch", "slow-batch", "nan-batch",
               "worker-death", "torn-write", "dropped-frame",
               "late-frame", "corrupt-frame")

SERVE_SITES = ("serve:dispatch", "serve:fetch")
FLEET_SITES = ("fleet:dispatch", "fleet:replica")
CASCADE_SITES = ("fleet:escalate",)
STREAM_SITES = ("stream:frame",)
TRAIN_SITES = ("train:batch", "train:rank")
LOADER_SITES = ("loader:batch", "loader:worker")
ARTIFACT_SITES = ("artifact:write",)
ALL_SITES = (SERVE_SITES + FLEET_SITES + CASCADE_SITES + STREAM_SITES
             + TRAIN_SITES + LOADER_SITES + ARTIFACT_SITES)

# the kinds seeded generation draws at the instrumented sites (parse()
# accepts any kind anywhere: a hand-written schedule may be adversarial)
SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "serve:dispatch": ("device-loss", "slow-batch"),
    "serve:fetch": ("device-loss", "hung-fetch", "slow-batch"),
    # a routing-layer dispatch fault; a whole replica's death (the router
    # kills and respawns it); the cascade's escalation hop erroring or
    # losing its quality replica; one stream frame lost, late or corrupt
    "fleet:dispatch": ("device-loss", "slow-batch"),
    "fleet:replica": ("worker-death",),
    "fleet:escalate": ("device-loss", "worker-death"),
    "stream:frame": ("dropped-frame", "late-frame", "corrupt-frame"),
    "train:batch": ("nan-batch", "slow-batch"),
    "train:rank": ("worker-death",),
}


class FaultEvent:
    """One scheduled fault: fire `kind` on the `at`-th arrival (1-based)
    at `site`. `meta` tunes the delay kinds (hang_s / slow_s)."""

    __slots__ = ("site", "kind", "at", "meta")

    def __init__(self, site: str, kind: str, at: int,
                 meta: Optional[dict] = None):
        if kind not in FAULT_KINDS:
            raise ValueError("unknown fault kind %r (have %s)"
                             % (kind, ", ".join(FAULT_KINDS)))
        if at < 1:
            raise ValueError("fault trigger count must be >= 1, got %d" % at)
        self.site = site
        self.kind = kind
        self.at = int(at)
        self.meta = dict(meta or {})

    @property
    def key(self) -> str:
        return "%s=%s@%d" % (self.site, self.kind, self.at)

    def __repr__(self) -> str:
        return "FaultEvent(%s)" % self.key


class FaultSchedule:
    """A finite, ordered set of FaultEvents; equal `spec()` strings mean
    equal injected behaviour."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.site, e.at, e.kind))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def spec(self) -> str:
        """The text form (`parse(s.spec())` equals s)."""
        return ",".join(e.key for e in self.events)

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """Parse `site=kind@n[,site=kind@n...]`, or the seeded shorthand
        `seed=<int>[,n=<int>]` over the serving sites."""
        spec = (spec or "").strip()
        if not spec:
            return cls(())
        events: List[FaultEvent] = []
        opts: Dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "@" not in part:
                k, _, v = part.partition("=")
                if k not in ("seed", "n") or not v:
                    raise ValueError(
                        "bad fault spec part %r (want site=kind@n, or "
                        "seed=<int>[,n=<int>])" % part)
                opts[k] = int(v)
                continue
            head, at = part.rsplit("@", 1)
            site, _, kind = head.rpartition("=")
            if not site or not kind:
                raise ValueError("bad fault spec part %r (want site=kind@n)"
                                 % part)
            events.append(FaultEvent(site, kind, int(at)))
        if "seed" in opts:
            if events:
                raise ValueError(
                    "fault spec mixes seed= with explicit events; pick one")
            return cls.seeded(opts["seed"], n=opts.get("n", 4))
        return cls(events)

    @classmethod
    def seeded(cls, seed: int, n: int = 4,
               sites: Sequence[str] = SERVE_SITES,
               kinds: Optional[Sequence[str]] = None,
               max_at: Optional[int] = None) -> "FaultSchedule":
        """`n` events drawn from `random.Random(seed)`: triggers distinct
        per site and spread over [2, max_at] (default 2 + 3n), so the
        first arrival, usually a warm-up, is never poisoned."""
        rng = random.Random(seed)
        hi = max_at if max_at is not None else 2 + 3 * max(1, n)
        used: Dict[str, set] = {s: set() for s in sites}
        events: List[FaultEvent] = []
        for _ in range(n):
            site = rng.choice(list(sites))
            pool = kinds if kinds is not None else SITE_KINDS.get(
                site, FAULT_KINDS)
            kind = rng.choice(list(pool))
            free = [a for a in range(2, hi + 1) if a not in used[site]]
            if not free:
                continue
            at = rng.choice(free)
            used[site].add(at)
            events.append(FaultEvent(site, kind, at))
        return cls(events)


class ChaosInjector:
    """The registry instrumented sites fire through. Thread-safe (the
    engine fires from its dispatcher and its fetcher); `fired` records
    every injected event in order."""

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 tracer=None):
        self.schedule = schedule or FaultSchedule(())
        self._tracer = tracer
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._armed: Dict[Tuple[str, int], FaultEvent] = {
            (e.site, e.at): e for e in self.schedule}
        self.fired: List[FaultEvent] = []

    def pending(self) -> int:
        with self._lock:
            return len(self._armed)

    def summary(self) -> Dict[str, int]:
        """Injected-event counts by kind, plus 'total'."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self.fired:
                out[e.kind] = out.get(e.kind, 0) + 1
            out["total"] = len(self.fired)
        return out

    def fire(self, site: str, **ctx) -> Optional[FaultEvent]:
        """Arrive at `site` (see the module docstring for what each kind
        does)."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            event = self._armed.pop((site, count), None)
            if event is not None:
                self.fired.append(event)
                arrival = len(self.fired)
        if event is None:
            return None
        if self._tracer is not None:
            meta = {"site": site, "at": event.at, "arrival": arrival}
            meta.update(ctx)
            self._tracer.event("fault:%s" % event.kind, **meta)
        if event.kind == "device-loss":
            raise InjectedBackendError(
                "UNAVAILABLE: injected device-loss at %s (arrival %d)"
                % (site, event.at))
        if event.kind == "hung-fetch":
            time.sleep(float(event.meta.get("hang_s", 0.25)))
            raise InjectedBackendError(
                "DEADLINE_EXCEEDED: injected hung fetch at %s (arrival %d)"
                % (site, event.at))
        if event.kind == "slow-batch":
            time.sleep(float(event.meta.get("slow_s", 0.05)))
        return event


def maybe_injector(spec_or_schedule, tracer=None) -> Optional[ChaosInjector]:
    """'' / None -> None (no injector: the sites skip even the check); a
    spec string or a FaultSchedule -> a live ChaosInjector."""
    if not spec_or_schedule:
        return None
    sched = (spec_or_schedule
             if isinstance(spec_or_schedule, FaultSchedule)
             else FaultSchedule.parse(spec_or_schedule))
    if not len(sched):
        return None
    return ChaosInjector(sched, tracer=tracer)
