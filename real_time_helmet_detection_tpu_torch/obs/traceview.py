"""Trace analyzer: per-request waterfalls and critical paths from span
logs.

Port of ref real_time_helmet_detection_tpu/obs/traceview.py:58-314
(`Trace`, `assemble`, `assemble_logs`, `waterfall`, `critical_path`,
`analyze`, `tail_exemplars`), stdlib only. It reassembles the port's
`obs-spans-v1` logs — one or many, one per process: the fleet router's,
the engines', the train loop's step contexts — into traces, and flags
the two hard errors exactly as the JAX package does:

* **orphan** — a request trace (records named `serve:*` or `fleet:*`)
  with no root closure: no record carrying `span` but no `parent` (the
  router's `fleet:e2e`, the engine's `serve:e2e`, or a terminal
  shed/lost/failed event). A request acknowledged into the causal chain
  whose end nobody accounted for.
* **broken chain** — a record of a CLOSED request trace whose `parent`
  names no span of that trace. Unclosed traces count as orphans only.

A batch-stage span carries `links` to every member request instead of a
parent; it is attached to each linked trace (fan-in), so one slow
compute shows in every member's waterfall. Intervals are `[t0, t0 +
dur_s]` (`t` when a record has no `t0`); stage attribution reports the
per-stage sums and the union coverage of the clipped stage intervals
over the root interval (`attributed_frac`). Step traces (`step-*`, the
train loop's `step_context`) are join keys, not requests: the
completeness rules skip them and `analyze` reports their ranks.

Read-only over its inputs; `read_spans` drops torn tails.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .spans import read_spans

# root-closure span names in preference order (a fleet trace carries
# BOTH the router's fleet:e2e and the replica's serve:e2e when the
# engine also owned no root — the router's is the client-visible one)
CLOSURE_PREFERENCE = ("fleet:e2e", "serve:e2e")

# trace ids minted by obs.trace.step_context (cross-rank train/scaling
# joins): completeness rules do not apply — a step trace is a join key,
# not an acknowledged request
STEP_TRACE_PREFIX = "step-"


class Trace:
    """One assembled trace: its own records + fan-in linked records."""

    __slots__ = ("trace_id", "records", "linked")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.records: List[dict] = []
        self.linked: List[dict] = []

    @property
    def is_step(self) -> bool:
        return self.trace_id.startswith(STEP_TRACE_PREFIX)

    @property
    def is_request(self) -> bool:
        """A serving/fleet request trace (completeness rules apply)."""
        return (not self.is_step
                and any(str(r.get("name", "")).startswith(
                    ("serve:", "fleet:")) for r in self.records))

    def span_ids(self) -> set:
        return {r["span"] for r in self.records if "span" in r}

    def root_closure(self) -> Optional[dict]:
        """The root-minter's closing record: carries `span`, no
        `parent`. Preference: fleet:e2e, then serve:e2e, then any
        parentless span, then a terminal parentless event."""
        roots = [r for r in self.records
                 if "span" in r and r.get("parent") is None]
        if not roots:
            return None
        for name in CLOSURE_PREFERENCE:
            for r in roots:
                if r.get("name") == name:
                    return r
        spans = [r for r in roots if r.get("kind") == "span"]
        return spans[0] if spans else roots[0]

    def broken_chains(self) -> List[dict]:
        """Records whose parent id names a span never written — only
        meaningful on a CLOSED trace (module docstring)."""
        if self.root_closure() is None:
            return []
        ids = self.span_ids()
        return [r for r in self.records
                if r.get("parent") is not None and r["parent"] not in ids]


def _interval(rec: dict) -> Tuple[float, float]:
    t0 = rec.get("t0", rec.get("t", 0.0))
    dur = rec.get("dur_s")
    return float(t0), float(t0) + (float(dur)
                                   if isinstance(dur, (int, float))
                                   else 0.0)


def assemble(records: Iterable[dict]) -> Dict[str, Trace]:
    """Group records into traces: by `trace` field (own records) and by
    `links` entries (fan-in). Records with neither are not trace
    material and are skipped."""
    traces: Dict[str, Trace] = {}

    def _get(tid: str) -> Trace:
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = Trace(tid)
        return t

    for rec in records:
        if not isinstance(rec, dict):
            continue
        tid = rec.get("trace")
        if tid is not None:
            _get(str(tid)).records.append(rec)
        for link in rec.get("links") or []:
            ltid = link.get("trace") if isinstance(link, dict) else None
            if ltid is not None and ltid != tid:
                _get(str(ltid)).linked.append(rec)
    for t in traces.values():
        t.records.sort(key=lambda r: _interval(r)[0])
        t.linked.sort(key=lambda r: _interval(r)[0])
    return traces


def assemble_logs(paths: Iterable[str]) -> Dict[str, Trace]:
    """Assemble over one-or-many span logs (one per process — the
    cross-process join point)."""
    recs: List[dict] = []
    for p in paths:
        recs.extend(read_spans(p))
    return assemble(recs)


def _merge_coverage(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of intervals (no double counting)."""
    total = 0.0
    last_end = None
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if last_end is None or lo >= last_end:
            total += hi - lo
            last_end = hi
        elif hi > last_end:
            total += hi - last_end
            last_end = hi
    return total


def waterfall(trace: Trace) -> List[dict]:
    """The per-trace timeline, ordered by interval start: every own and
    linked record as a row with offsets relative to the trace start.
    Linked (fan-in) rows are marked — a reader sees which stages were
    shared with batch neighbors."""
    rows: List[dict] = []
    closure = trace.root_closure()
    all_recs = [(r, False) for r in trace.records] \
        + [(r, True) for r in trace.linked]
    if not all_recs:
        return rows
    base = min(_interval(r)[0] for r, _ in all_recs)
    if closure is not None:
        base = min(base, _interval(closure)[0])
    for rec, via_link in sorted(all_recs, key=lambda p: _interval(p[0])[0]):
        lo, hi = _interval(rec)
        meta = rec.get("meta") or {}
        row = {"name": rec.get("name", "?"), "kind": rec.get("kind"),
               "rel_ms": round((lo - base) * 1e3, 3),
               "dur_ms": round((hi - lo) * 1e3, 3),
               "fan_in": via_link, "pid": rec.get("pid"),
               "root": ("span" in rec and rec.get("parent") is None
                        and not via_link)}
        if "rank" in rec:
            row["rank"] = rec["rank"]
        for k in ("rid", "b", "n", "error", "reason", "tenant", "stage"):
            if k in meta:
                row[k] = meta[k]
        rows.append(row)
    return rows


def critical_path(trace: Trace) -> Optional[dict]:
    """Stage attribution for a CLOSED trace: per-stage duration sums,
    the union coverage of the stage intervals over the root interval
    (`attributed_frac` — the acceptance quantity), and the dominant
    stage. None for an unclosed trace (orphans have no e2e to
    attribute)."""
    closure = trace.root_closure()
    if closure is None:
        return None
    root_lo, root_hi = _interval(closure)
    e2e = root_hi - root_lo
    stages: Dict[str, float] = {}
    intervals: List[Tuple[float, float]] = []
    for rec, via_link in [(r, False) for r in trace.records] \
            + [(r, True) for r in trace.linked]:
        if rec is closure or rec.get("kind") != "span":
            continue
        if not via_link and "span" in rec and rec.get("parent") is None:
            continue  # a secondary root closure (a terminal event twin,
            # or an engine e2e that also closed the root) spans the whole
            # window — it is the measurement, not a stage of it
        if rec.get("name") in CLOSURE_PREFERENCE:
            continue  # a replica-level e2e under a fleet root is a hop
            # SUMMARY (it covers that hop's queue-wait+compute+d2h): it
            # stays in the waterfall but must not double-count as a stage
        lo, hi = _interval(rec)
        lo, hi = max(lo, root_lo), min(hi, root_hi)
        if hi <= lo:
            continue
        name = rec.get("name", "?")
        stages[name] = stages.get(name, 0.0) + (hi - lo)
        intervals.append((lo, hi))
    attributed = _merge_coverage(intervals)
    dominant = max(stages.items(), key=lambda kv: kv[1])[0] \
        if stages else None
    return {"e2e_ms": round(e2e * 1e3, 3),
            "closure": closure.get("name"),
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in sorted(stages.items())},
            "stage_sum_ms": round(sum(stages.values()) * 1e3, 3),
            "attributed_ms": round(attributed * 1e3, 3),
            "attributed_frac": (round(attributed / e2e, 4)
                                if e2e > 0 else None),
            "dominant_stage": dominant}


def analyze(traces: Dict[str, Trace]) -> dict:
    """The health summary over an assembled trace set: request-trace
    completeness (orphans/broken as HARD errors), aggregate stage
    shares over closed request traces, and the step-trace join digest
    (cross-rank coverage)."""
    request = [t for t in traces.values() if t.is_request]
    steps = [t for t in traces.values() if t.is_step]
    orphans = [t.trace_id for t in request if t.root_closure() is None]
    broken: List[dict] = []
    for t in request:
        for rec in t.broken_chains():
            broken.append({"trace": t.trace_id,
                           "span": rec.get("span"),
                           "parent": rec.get("parent"),
                           "name": rec.get("name")})
    closed = [t for t in request if t.root_closure() is not None]
    stage_totals: Dict[str, float] = {}
    e2e_total = 0.0
    redispatched = 0
    for t in closed:
        cp = critical_path(t)
        if cp is None:
            continue
        e2e_total += cp["e2e_ms"]
        for name, ms in cp["stages_ms"].items():
            stage_totals[name] = stage_totals.get(name, 0.0) + ms
        if any(r.get("name") == "fleet:redispatch" for r in t.records):
            redispatched += 1
    shares = {k: round(v / e2e_total, 4)
              for k, v in sorted(stage_totals.items())} \
        if e2e_total > 0 else {}
    step_ranks = sorted({r.get("rank") for t in steps
                         for r in t.records if "rank" in r})
    broken_traces = {b["trace"] for b in broken}
    return {"traces": len(traces), "request_traces": len(request),
            "complete": sum(1 for t in closed
                            if t.trace_id not in broken_traces),
            "closed": len(closed),
            "orphans": len(orphans),
            "orphan_ids": sorted(orphans)[:20],
            "broken_chains": len(broken),
            "broken_detail": broken[:20],
            "redispatched_traces": redispatched,
            "stage_shares": shares,
            "step_traces": len(steps),
            "step_ranks": step_ranks}


def tail_exemplars(traces: Dict[str, Trace], n: int = 3) -> List[dict]:
    """The slowest-N closed request traces, each with its waterfall and
    critical path — the evidence a p99 claim ships with."""
    scored: List[Tuple[float, str, Trace]] = []
    for t in traces.values():
        if not t.is_request:
            continue
        cp = critical_path(t)
        if cp is None:
            continue
        scored.append((cp["e2e_ms"], t.trace_id, t))
    scored.sort(key=lambda x: (-x[0], x[1]))
    out = []
    for e2e_ms, tid, t in scored[:max(0, int(n))]:
        cp = critical_path(t)
        out.append({"trace": tid, "e2e_ms": e2e_ms,
                    "critical_path": cp,
                    "waterfall": waterfall(t)})
    return out
