"""The round report: what actually happened, joined from the flight
recorder's streams into one artifact (ref scripts/obs_report.py:1-49;
the reference has no observability tooling, its loop prints meters):

* span logs (`obs/spans.py` JSONL: spans, events, context samples, with
  the trace / span / parent / links fields `obs/traceview.py` joins into
  per-request waterfalls; orphans and broken chains are hard errors),
* the job spool's journal (`runtime/spool.py`, JAX's format),
* bench JSON lines, loss-log sidecars (loss-log-v1 / -v2),
* `obs-metrics-v1` snapshots (counters, gauges, histogram digests),
* SLO alert events, fleet and cascade records, `stream:frame` delivery
  records (`serving/streams.py`).

Output: `<out>/report.md` and `report.json` (schema `obs-report-v7`) and
one JSON line on stdout; `read_report` reads v1-v7 reports, nulling the
sections each lacks. Read-only over its inputs, torch-free, CPU-only:

    python -m real_time_helmet_detection_tpu_torch.obs.report \
        --round-dir DIR [--out DIR] [--span-log F ...] [--queue-dir D]
        [--bench F ...] [--loss-log F ...] [--metrics F ...]
        [--scaling F ...]
    python -m real_time_helmet_detection_tpu_torch.obs.report --selfcheck

Without `--span-log` the span logs are `DIR/obs/*.jsonl` but the
`metrics*` ones, which are `--metrics`' default; `--queue-dir` defaults
to `DIR/queue`, `--bench` to `DIR/BENCH_*.json`, `--scaling` to
`DIR/scaling*.json`, `--out` to `DIR/obs`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from ..utils import atomic_write_bytes, save_json
from .metrics import read_metrics, snapshot_digest
from .spans import maybe_tracer, read_spans

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GENERATOR = "real_time_helmet_detection_tpu_torch/obs/report.py"

SCHEMA = "obs-report-v7"
READABLE_SCHEMAS = ("obs-report-v1", "obs-report-v2", "obs-report-v3",
                    "obs-report-v4", "obs-report-v5", "obs-report-v6",
                    "obs-report-v7")
# sections older schemas lack; read_report nulls them (v1 lacks every
# group, v2 lacks Scaling + Fleet + Traces, v3 lacks Fleet + Traces,
# v4 lacks Traces, v6 and older lack Streams; v5 fleet sections lack
# the Cascade subsection, nulled inside the fleet dict)
V2_SECTIONS = ("metrics", "slo")
V3_SECTIONS = ("scaling",)
V4_SECTIONS = ("fleet",)
V5_SECTIONS = ("traces",)
V6_SECTIONS = ("streams",)


def read_report(path: str) -> Optional[Dict]:
    """Load a report.json of ANY readable schema, normalized to the v2
    shape (missing v2 sections -> None). Consumers (perfgate's obs
    source, tests) read old rounds' committed reports through this
    instead of sniffing schemas themselves. Unknown schemas refuse
    loudly (None) rather than half-parse."""
    try:
        with open(path) as f:
            rep = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if rep.get("schema") not in READABLE_SCHEMAS:
        log("unreadable report schema %r in %s" % (rep.get("schema"), path))
        return None
    for section in (V2_SECTIONS + V3_SECTIONS + V4_SECTIONS + V5_SECTIONS
                    + V6_SECTIONS):
        rep.setdefault(section, None)
    if isinstance(rep.get("fleet"), dict):
        rep["fleet"].setdefault("cascade", None)  # pre-v6 fleet sections
    return rep


def log(msg: str) -> None:
    print("[obs.report] %s" % msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# per-source loaders/summarizers (each tolerant: a missing/torn source
# nulls its section instead of killing the report)


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize_spans(paths: List[str]) -> Dict:
    """Roll every span log up into per-name duration stats + event counts
    + the context-sample digest (loadavg spread, relay incidents)."""
    spans: Dict[str, List[float]] = {}
    events: Dict[str, int] = {}
    contexts: List[dict] = []
    total_records = 0
    for path in paths:
        for rec in read_spans(path):
            total_records += 1
            kind = rec.get("kind")
            if kind == "span" and isinstance(rec.get("dur_s"), (int, float)):
                spans.setdefault(rec.get("name", "?"), []).append(
                    float(rec["dur_s"]))
            elif kind == "event":
                events[rec.get("name", "?")] = \
                    events.get(rec.get("name", "?"), 0) + 1
            elif kind == "context":
                contexts.append(rec.get("sample", {}))
    by_name = {}
    for name, durs in sorted(spans.items()):
        s = sorted(durs)
        by_name[name] = {
            "count": len(s), "total_s": round(sum(s), 3),
            "mean_s": round(sum(s) / len(s), 6),
            "p50_s": round(_pctl(s, 0.50), 6),
            "p95_s": round(_pctl(s, 0.95), 6),
            "max_s": round(s[-1], 6),
        }
    ctx: Dict = {"samples": len(contexts)}
    load1 = [c["loadavg"][0] for c in contexts
             if isinstance(c.get("loadavg"), list) and c["loadavg"]]
    if load1:
        ctx["load1_min"] = min(load1)
        ctx["load1_max"] = max(load1)
        ctx["load1_mean"] = round(sum(load1) / len(load1), 2)
    relay_seen = [c for c in contexts
                  if c.get("relay_process") is not None]
    if relay_seen:
        ctx["relay_down_samples"] = sum(
            1 for c in relay_seen
            if not (c["relay_process"] and c.get("relay_listening")))
    # recompile evidence: compile spans (one per backend compile when the
    # counter's tracer mirror is on) and any recompile-total closing event
    recompiles = {"compile_spans": by_name.get("compile", {}).get("count", 0),
                  "compile_total_s": by_name.get("compile",
                                                 {}).get("total_s", 0.0)}
    return {"logs": [os.path.relpath(p, REPO) if p.startswith(REPO) else p
                     for p in paths],
            "records": total_records, "by_name": by_name,
            "events": events, "context": ctx, "recompiles": recompiles}


def summarize_serving(paths: List[str]) -> Optional[Dict]:
    """The serving-engine section (ISSUE 8): p50/p99 joined from the
    engine's span taxonomy (serve:e2e per request, serve:queue-wait,
    the serve:batch-form/h2d/compute/d2h stages, serve:shed events).
    Returns None when the round recorded no serving activity."""
    e2e: List[float] = []
    qwait: List[float] = []
    stages: Dict[str, List[float]] = {}
    shed: Dict[str, int] = {}
    fills: List[int] = []
    batches = 0
    for path in paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            if not name.startswith("serve:"):
                continue
            if rec.get("kind") == "event" and name == "serve:shed":
                reason = (rec.get("meta") or {}).get("reason", "?")
                shed[reason] = shed.get(reason, 0) + 1
                continue
            dur = rec.get("dur_s")
            if not isinstance(dur, (int, float)):
                continue
            if name == "serve:e2e":
                e2e.append(float(dur))
            elif name == "serve:queue-wait":
                qwait.append(float(dur))
            else:
                stages.setdefault(name[len("serve:"):], []).append(
                    float(dur))
            if name == "serve:batch-form":
                batches += 1
                n = (rec.get("meta") or {}).get("n")
                if isinstance(n, int):
                    fills.append(n)
    if not (e2e or qwait or stages or shed):
        return None

    def digest(vals: List[float]) -> Dict:
        s = sorted(vals)
        return {"count": len(s),
                "p50_ms": round(_pctl(s, 0.50) * 1e3, 3),
                "p99_ms": round(_pctl(s, 0.99) * 1e3, 3),
                "max_ms": round((s[-1] if s else float("nan")) * 1e3, 3)}

    out: Dict = {"requests": len(e2e), "batches": batches,
                 "shed": shed, "shed_total": sum(shed.values())}
    if e2e:
        out["e2e"] = digest(e2e)
    if qwait:
        out["queue_wait"] = digest(qwait)
    if fills:
        out["mean_batch_fill"] = round(sum(fills) / len(fills), 2)
    out["stages"] = {name: digest(v) for name, v in sorted(stages.items())}
    return out


def summarize_faults(paths: List[str]) -> Optional[Dict]:
    """The Faults section (ISSUE 9): join `fault:*` injection events
    against the `recover:*` evidence of what healed (requeues, retries
    exhausted, skip-steps, backoffs, rollbacks, quarantines, reloads) and
    the engine's `serve:state` transitions — a post-mortem reads what was
    injected (or actually failed) next to what the self-healing layers
    did about it. Returns None when the round recorded no fault
    activity."""
    injected: Dict[str, int] = {}
    by_site: Dict[str, int] = {}
    recoveries: Dict[str, int] = {}
    requeued = exhausted = skipped = 0
    transitions: Dict[str, int] = {}
    for path in paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            meta = rec.get("meta") or {}
            if name.startswith("fault:"):
                kind = name[len("fault:"):]
                injected[kind] = injected.get(kind, 0) + 1
                site = meta.get("site", "?")
                by_site[site] = by_site.get(site, 0) + 1
            elif name.startswith("recover:"):
                what = name[len("recover:"):]
                recoveries[what] = recoveries.get(what, 0) + 1
                n = meta.get("n")
                if isinstance(n, int):
                    if what == "requeue":
                        requeued += n
                    elif what == "retry-exhausted":
                        exhausted += n
                    elif what == "skip-step":
                        skipped += n
            elif name == "serve:state":
                arc = "%s->%s" % (meta.get("from", "?"), meta.get("to", "?"))
                transitions[arc] = transitions.get(arc, 0) + 1
    if not (injected or recoveries or transitions):
        return None
    return {"injected": injected, "injected_total": sum(injected.values()),
            "by_site": by_site, "recoveries": recoveries,
            "requeued_requests": requeued,
            "retry_exhausted_requests": exhausted,
            "skipped_steps": skipped,
            "engine_transitions": transitions}


def summarize_metrics(paths: List[str]) -> Optional[Dict]:
    """The Metrics section (ISSUE 10): per obs-metrics-v1 JSONL, the
    LAST complete snapshot digested (counters/gauges verbatim,
    histograms to count/mean/p50/p99/max) plus the snapshot count — a
    reader sees the final state of every exported registry without
    spelunking raw bucket arrays. Returns None when the round exported
    no metrics (a pre-ISSUE-10 round)."""
    out = []
    for path in sorted(paths):
        snaps = read_metrics(path)
        # tolerate a spans-style meta line or foreign records: a metrics
        # snapshot is recognizable by its histogram/counter sections
        snaps = [s for s in snaps
                 if isinstance(s, dict) and ("counters" in s
                                             or "histograms" in s)]
        if not snaps:
            continue
        row = {"path": os.path.relpath(path, REPO)
               if path.startswith(REPO) else path,
               "snapshots": len(snaps)}
        row.update(snapshot_digest(snaps[-1]))
        out.append(row)
    return {"files": out} if out else None


def summarize_slo(paths: List[str]) -> Optional[Dict]:
    """The SLO section (ISSUE 10): every `alert:*` watchdog event, with
    counts by rule and a merged timeline against the `fault:*` /
    `recover:*` / `serve:state` evidence (sorted by wall time) — the
    post-mortem question "did the watchdog see it, and when relative to
    the failure" answered in one table. Returns None when no alerts
    fired."""
    alerts: List[Dict] = []
    timeline: List[Dict] = []
    by_rule: Dict[str, int] = {}
    for path in paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            kind = rec.get("kind")
            t = rec.get("t")
            meta = rec.get("meta") or {}
            if name.startswith("alert:"):
                rule = name[len("alert:"):]
                by_rule[rule] = by_rule.get(rule, 0) + 1
                alerts.append({"t": t, "rule": rule, **meta})
                timeline.append({"t": t, "what": "alert", "name": rule})
            elif name.startswith(("fault:", "recover:")) \
                    or name == "serve:state":
                label = name if name != "serve:state" else (
                    "serve:state %s->%s" % (meta.get("from", "?"),
                                            meta.get("to", "?")))
                timeline.append({"t": t, "what": kind or "event",
                                 "name": label})
    if not alerts:
        return None
    timeline.sort(key=lambda r: (r.get("t") is None, r.get("t")))
    return {"alerts": alerts, "by_rule": by_rule,
            "alert_total": len(alerts), "timeline": timeline}


def summarize_scaling(paths: List[str],
                      span_paths: List[str]) -> Optional[Dict]:
    """The Scaling section (ISSUE 11): per-device-count efficiency tables
    from the round's scaling-v2 artifact(s) joined with the harness's
    `scale:compile`/`scale:barrier`/`scale:step` flight-recorder spans —
    the artifact says WHAT scaled, the spans say where the wall time went
    (per-rank compile skew included). Returns None when the round has no
    scaling activity."""
    files = []
    for path in sorted(paths):
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if d.get("schema") != "scaling-v2":
            continue
        files.append({"path": os.path.relpath(path, REPO)
                      if path.startswith(REPO) else path,
                      "config": d.get("config") or {},
                      "curves": d.get("curves") or {},
                      "rows_measured": sum(
                          1 for r in d.get("results") or []
                          if "img_per_sec" in r),
                      "rows_error": sum(1 for r in d.get("results") or []
                                        if "error" in r)})
    spans: Dict[str, List[float]] = {}
    for path in span_paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            if name.startswith("scale:") \
                    and isinstance(rec.get("dur_s"), (int, float)):
                spans.setdefault(name[len("scale:"):], []).append(
                    float(rec["dur_s"]))
    span_digest = {}
    for name, durs in sorted(spans.items()):
        s = sorted(durs)
        span_digest[name] = {"count": len(s),
                             "total_s": round(sum(s), 3),
                             "max_s": round(s[-1], 4)}
    if not files and not span_digest:
        return None
    return {"files": files, "spans": span_digest}


def summarize_fleet(paths: List[str]) -> Optional[Dict]:
    """The Fleet section (ISSUE 12): per-replica dispatch counts, the
    replica lifecycle (deaths/respawns/reload-timeouts), per-tenant shed
    accounting, and the canary rollout events joined against `alert:*`
    and `fault:*` in one timeline — a post-mortem reads which replica a
    canary was, what the watchdog saw on its slice, and whether the
    promote/rollback decision lined up with the injected (or real)
    failures. Returns None when the round recorded no fleet activity."""
    by_replica: Dict[str, int] = {}
    shed: Dict[str, int] = {}
    tenants_shed: Dict[str, int] = {}
    lifecycle: Dict[str, int] = {}
    rollouts: Dict[str, int] = {}
    redispatches = lost = 0
    timeline: List[Dict] = []
    # Cascade subsection (ISSUE 16, obs-report-v6): escalation events +
    # their confidence distribution, degraded-answer reasons, and the
    # per-outcome e2e split read off fleet:e2e's escalated/degraded meta
    # (the cascade markers ride the records the router already writes)
    casc_events = 0
    casc_conf: List[float] = []
    casc_degraded: Dict[str, int] = {}
    casc_e2e = {"requests": 0, "escalated": 0, "degraded": 0}
    casc_ms: Dict[str, List[float]] = {"edge": [], "escalated": []}
    for path in paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            meta = rec.get("meta") or {}
            t = rec.get("t")
            if name.startswith("fleet:"):
                what = name[len("fleet:"):]
                if what == "dispatch":
                    rid = str(meta.get("rid", "?"))
                    by_replica[rid] = by_replica.get(rid, 0) + 1
                    continue  # per-dispatch records stay out of the
                    # timeline (volume)
                if what == "escalate":
                    casc_events += 1
                    c = meta.get("confidence")
                    if isinstance(c, (int, float)):
                        casc_conf.append(float(c))
                    continue  # per-escalation volume, like dispatch
                if what == "e2e" and "escalated" in meta:
                    casc_e2e["requests"] += 1
                    dur = rec.get("dur_s")
                    hop = "escalated" if meta.get("escalated") else "edge"
                    if meta.get("escalated"):
                        casc_e2e["escalated"] += 1
                    if meta.get("degraded"):
                        casc_e2e["degraded"] += 1
                    if isinstance(dur, (int, float)):
                        casc_ms[hop].append(dur * 1e3)
                    continue  # per-request volume
                if what == "degraded":
                    reason = meta.get("reason", "?")
                    casc_degraded[reason] = casc_degraded.get(reason,
                                                              0) + 1
                    # stays in the timeline: rare, and the join point
                    # against alert:*/fault:* for why the tier was out
                if what == "redispatch":
                    redispatches += 1
                elif what == "lost":
                    lost += 1
                elif what == "shed":
                    reason = meta.get("reason", "?")
                    shed[reason] = shed.get(reason, 0) + 1
                elif what == "tenant-shed":
                    tenant = meta.get("tenant", "?")
                    tenants_shed[tenant] = tenants_shed.get(tenant, 0) + 1
                elif what in ("replica-death", "respawn",
                              "reload-timeout", "killed"):
                    lifecycle[what] = lifecycle.get(what, 0) + 1
                elif what in ("rollout", "promote", "rollback"):
                    rollouts[what] = rollouts.get(what, 0) + 1
                label = name
                if "rid" in meta:
                    label += " rid=%s" % meta["rid"]
                if "reason" in meta:
                    label += " (%s)" % meta["reason"]
                timeline.append({"t": t, "what": "fleet", "name": label})
            elif name.startswith(("alert:", "fault:")):
                timeline.append({"t": t, "what": name.split(":", 1)[0],
                                 "name": name})
    if not (by_replica or lifecycle or rollouts or shed or redispatches
            or casc_e2e["requests"] or casc_events):
        return None
    timeline.sort(key=lambda r: (r.get("t") is None, r.get("t")))
    cascade = None
    if casc_e2e["requests"] or casc_events:
        n = casc_e2e["requests"]
        cascade = {
            "requests": n,
            "escalated": casc_e2e["escalated"],
            "escalation_rate": (round(casc_e2e["escalated"] / n, 4)
                                if n else None),
            "degraded_answers": casc_e2e["degraded"],
            "degraded_reasons": dict(sorted(casc_degraded.items())),
            "escalate_events": casc_events,
            "confidence": ({"min": round(min(casc_conf), 4),
                            "max": round(max(casc_conf), 4)}
                           if casc_conf else None),
            "e2e_ms_by_hop": {
                hop: ({"n": len(v),
                       "p50": round(_pctl(sorted(v), 0.50), 3),
                       "p99": round(_pctl(sorted(v), 0.99), 3)}
                      if v else None)
                for hop, v in casc_ms.items()}}
    return {"dispatches_by_replica": dict(sorted(by_replica.items())),
            "dispatches_total": sum(by_replica.values()),
            "redispatches": redispatches, "lost": lost, "shed": shed,
            "tenants_shed": tenants_shed, "lifecycle": lifecycle,
            "rollouts": rollouts, "cascade": cascade,
            "timeline": timeline}


def summarize_traces(paths: List[str], top_n: int = 5) -> Optional[Dict]:
    """The Traces section (ISSUE 14): reassemble the round's trace
    contexts (obs/traceview.py) across EVERY span log — router, replica
    and rank logs join here — into (a) the completeness verdict (orphan
    spans and broken parent links are HARD errors, not noise), (b)
    aggregate critical-path stage shares over the closed request traces,
    (c) the top-N slowest requests' waterfalls, and (d) a join of the
    `fault:*`/`recover:*`/`fleet:*` events that landed INSIDE traces —
    a post-mortem reads which request a fault actually hit. Returns None
    when the round recorded no traced spans (every pre-ISSUE round)."""
    from . import traceview
    traces = traceview.assemble_logs(paths)
    if not traces:
        return None
    summary = traceview.analyze(traces)
    exemplars = traceview.tail_exemplars(traces, top_n)
    # events joined INTO traces: which requests did faults/recoveries/
    # fleet hops actually touch (ctx- or links-carrying events only)
    joined: Dict[str, int] = {}
    for t in traces.values():
        for rec in t.records + t.linked:
            name = str(rec.get("name", ""))
            if rec.get("kind") == "event" and name.startswith(
                    ("fault:", "recover:", "fleet:")):
                joined[name] = joined.get(name, 0) + 1
    summary["events_in_traces"] = dict(sorted(joined.items()))
    summary["waterfalls"] = exemplars
    return summary


def summarize_streams(paths: List[str]) -> Optional[Dict]:
    """The Streams section (ISSUE 17): per-stream rollup of the
    delta-gated video sessions' `stream:frame` delivery records (meta
    sid/seq/computed/total/gap/late; dur_s is the resolve+stitch
    delivery time) joined against the `recover:frame-gap` evidence of
    dropped/corrupt frames answered from the tile cache. The aggregate
    computed-tile fraction is the compute the gating actually spent —
    the same quantity the serve-bench streams artifact gates. Returns
    None when the round recorded no stream activity (every
    pre-ISSUE-17 round)."""
    per: Dict[str, Dict] = {}
    gap_kinds: Dict[str, int] = {}
    durs: Dict[str, List[float]] = {}
    for path in paths:
        for rec in read_spans(path):
            name = rec.get("name", "")
            meta = rec.get("meta") or {}
            if name == "recover:frame-gap":
                kind = str(meta.get("kind", "?"))
                gap_kinds[kind] = gap_kinds.get(kind, 0) + 1
                continue
            if name != "stream:frame":
                continue
            sid = str(meta.get("sid", "?"))
            st = per.setdefault(sid, {"frames": 0, "computed_tiles": 0,
                                      "total_tiles": 0, "gaps": 0,
                                      "late": 0})
            st["frames"] += 1
            if isinstance(meta.get("computed"), int):
                st["computed_tiles"] += meta["computed"]
            if isinstance(meta.get("total"), int):
                st["total_tiles"] += meta["total"]
            if meta.get("gap"):
                st["gaps"] += 1
            if meta.get("late"):
                st["late"] += 1
            dur = rec.get("dur_s")
            if isinstance(dur, (int, float)):
                durs.setdefault(sid, []).append(float(dur))
    if not (per or gap_kinds):
        return None

    def digest(vals: List[float]) -> Dict:
        s = sorted(vals)
        return {"count": len(s),
                "p50_ms": round(_pctl(s, 0.50) * 1e3, 3),
                "p99_ms": round(_pctl(s, 0.99) * 1e3, 3),
                "max_ms": round((s[-1] if s else float("nan")) * 1e3, 3)}

    for sid, vals in durs.items():
        per[sid]["delivery"] = digest(vals)
    computed = sum(st["computed_tiles"] for st in per.values())
    total = sum(st["total_tiles"] for st in per.values())
    return {"streams": len(per),
            "frames": sum(st["frames"] for st in per.values()),
            "computed_tiles": computed, "total_tiles": total,
            "computed_tile_fraction": (round(computed / total, 4)
                                       if total else None),
            "tile_skip_rate": (round(1.0 - computed / total, 4)
                               if total else None),
            "gaps": sum(st["gaps"] for st in per.values()),
            "late": sum(st["late"] for st in per.values()),
            "frame_gap_recoveries": dict(sorted(gap_kinds.items())),
            "per_stream": {sid: per[sid] for sid in sorted(per)}}


def summarize_queue(queue_dir: Optional[str]) -> Optional[Dict]:
    """Read-only tolerant replay of the job journal: per-job final state,
    attempts, salvage evidence, queued->terminal wall seconds."""
    if not queue_dir:
        return None
    path = os.path.join(queue_dir, "jobs.jsonl")
    try:
        with open(path, "rb") as f:
            raw_lines = f.read().split(b"\n")
    except OSError:
        return None
    jobs: Dict[str, dict] = {}
    dropped = 0
    for i, raw in enumerate(raw_lines):
        if not raw.strip():
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            dropped += 1  # torn tail (or mid-file damage): report, skip
            continue
        kind = rec.get("kind")
        if kind == "spec":
            jobs[rec.get("job", "?")] = {
                "state": "queued", "attempts": 1,
                "enqueued_t": rec.get("t"), "terminal_t": None,
                "salvaged_artifacts": 0, "error": None}
        elif kind == "state":
            j = jobs.get(rec.get("job"))
            if j is None:
                continue
            j["state"] = rec.get("state", j["state"])
            j["attempts"] = max(j["attempts"],
                                int(rec.get("attempt", 1) or 1))
            if rec.get("state") in ("done", "failed"):
                j["terminal_t"] = rec.get("t")
            if rec.get("state") == "salvaged":
                j["salvaged_artifacts"] += len(
                    rec.get("salvaged_artifacts", []))
            if rec.get("error"):
                j["error"] = str(rec["error"])[:200]
    for j in jobs.values():
        if j["enqueued_t"] and j["terminal_t"]:
            j["wall_s"] = round(j["terminal_t"] - j["enqueued_t"], 1)
        j.pop("enqueued_t", None)
        j.pop("terminal_t", None)
    states = [j["state"] for j in jobs.values()]
    return {"journal": os.path.relpath(path, REPO)
            if path.startswith(REPO) else path,
            "jobs": jobs, "dropped_lines": dropped,
            "counts": {s: states.count(s) for s in sorted(set(states))}}


def summarize_bench(paths: List[str]) -> List[Dict]:
    """Headline fields from each bench JSON line (the LAST line per file,
    matching find_last_tpu_result's convention)."""
    out = []
    keep = ("metric", "value", "platform", "train_img_per_sec_chip",
            "mfu_train", "mfu_fwd", "latency_ms_b1", "infer_dtype",
            "int8_fps", "int8_vs_bf16", "recompile_count", "loadavg",
            "span_log", "error", "error_class")
    for path in sorted(paths):
        try:
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            rec = json.loads(lines[-1])
        except (OSError, json.JSONDecodeError, IndexError):
            continue
        row = {"path": os.path.relpath(path, REPO)
               if path.startswith(REPO) else path}
        row.update({k: rec[k] for k in keep if k in rec})
        out.append(row)
    return out


def summarize_loss_log(paths: List[str]) -> List[Dict]:
    """Per-sidecar digest, reading v1 (untagged) and v2 (schema-tagged)
    alike — mirrors ops.loss.LossLog's compat contract without importing
    jax."""
    out = []
    for path in sorted(paths):
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        schema = d.pop("schema", "loss-log-v1")
        row: Dict = {"path": os.path.relpath(path, REPO)
                     if path.startswith(REPO) else path, "schema": schema}
        for key, vals in d.items():
            if not isinstance(vals, list) or not vals:
                continue
            tail = vals[-min(100, len(vals)):]
            row[key] = {"n": len(vals), "final": round(float(vals[-1]), 5),
                        "mean_last100": round(sum(tail) / len(tail), 5)}
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# report assembly


def build_report(round_name: str, span_paths: List[str],
                 queue_dir: Optional[str], bench_paths: List[str],
                 loss_paths: List[str],
                 metrics_paths: Optional[List[str]] = None,
                 scaling_paths: Optional[List[str]] = None) -> Dict:
    return {
        "schema": SCHEMA, "tool": "obs_report", "round": round_name,
        "spans": summarize_spans(span_paths),
        "serving": summarize_serving(span_paths),
        "faults": summarize_faults(span_paths),
        "metrics": summarize_metrics(metrics_paths or []),
        "slo": summarize_slo(span_paths),
        "scaling": summarize_scaling(scaling_paths or [], span_paths),
        "fleet": summarize_fleet(span_paths),
        "streams": summarize_streams(span_paths),
        "traces": summarize_traces(span_paths),
        "queue": summarize_queue(queue_dir),
        "bench": summarize_bench(bench_paths),
        "loss": summarize_loss_log(loss_paths),
    }


def render_markdown(rep: Dict) -> str:
    """The human half of the artifact: one table per evidence stream."""
    lines = ["# Round %s — flight-recorder report" % rep["round"], "",
             "Schema `%s`; generated by %s. Read" % (rep["schema"],
                                                     GENERATOR),
             "docs/ARCHITECTURE.md \"Observability & flight recorder\" "
             "for the span taxonomy.", ""]
    sp = rep["spans"]
    lines += ["## Spans (%d records over %d log(s))"
              % (sp["records"], len(sp["logs"])), ""]
    if sp["by_name"]:
        lines += ["| span | count | total s | mean s | p50 s | p95 s | "
                  "max s |", "|---|---|---|---|---|---|---|"]
        for name, s in sp["by_name"].items():
            lines.append("| %s | %d | %.3f | %.4f | %.4f | %.4f | %.4f |"
                         % (name, s["count"], s["total_s"], s["mean_s"],
                            s["p50_s"], s["p95_s"], s["max_s"]))
    else:
        lines.append("_no spans recorded_")
    if sp["events"]:
        lines += ["", "Events: " + ", ".join(
            "%s ×%d" % (k, v) for k, v in sorted(sp["events"].items()))]
    ctx = sp["context"]
    if ctx.get("samples"):
        lines += ["", "Context: %d sample(s), load1 %s–%s (mean %s), "
                  "relay-down samples: %s"
                  % (ctx["samples"], ctx.get("load1_min", "?"),
                     ctx.get("load1_max", "?"), ctx.get("load1_mean", "?"),
                     ctx.get("relay_down_samples", 0))]
    lines += ["", "Recompiles: %d compile span(s), %.1f s total" % (
        sp["recompiles"]["compile_spans"],
        sp["recompiles"]["compile_total_s"]), ""]
    srv = rep.get("serving")
    lines += ["## Serving", ""]
    if srv:
        e2e = srv.get("e2e", {})
        lines += ["%d request(s) over %d batch(es)%s; shed: %s"
                  % (srv["requests"], srv["batches"],
                     (", mean fill %.2f" % srv["mean_batch_fill"]
                      if "mean_batch_fill" in srv else ""),
                     (", ".join("%s ×%d" % (k, v)
                                for k, v in sorted(srv["shed"].items()))
                      or "none")), ""]
        if e2e:
            lines += ["e2e latency: p50 %.3f ms, p99 %.3f ms (n=%d)"
                      % (e2e["p50_ms"], e2e["p99_ms"], e2e["count"]), ""]
        if srv["stages"] or srv.get("queue_wait"):
            lines += ["| stage | count | p50 ms | p99 ms | max ms |",
                      "|---|---|---|---|---|"]
            rows = dict(srv["stages"])
            if srv.get("queue_wait"):
                rows["queue-wait"] = srv["queue_wait"]
            for name in sorted(rows):
                s = rows[name]
                lines.append("| %s | %d | %.3f | %.3f | %.3f |"
                             % (name, s["count"], s["p50_ms"],
                                s["p99_ms"], s["max_ms"]))
    else:
        lines.append("_no serving activity recorded_")
    lines += [""]
    flt = rep.get("faults")
    lines += ["## Faults", ""]
    if flt:
        lines += ["Injected: %s (by site: %s)"
                  % ((", ".join("%s ×%d" % (k, v) for k, v
                                in sorted(flt["injected"].items()))
                      or "none"),
                     (", ".join("%s ×%d" % (k, v) for k, v
                                in sorted(flt["by_site"].items()))
                      or "-")), "",
                  "Healed: %s" % (", ".join(
                      "%s ×%d" % (k, v) for k, v
                      in sorted(flt["recoveries"].items())) or "none"), "",
                  "Requests requeued: %d, retry-exhausted: %d; train "
                  "steps skipped: %d" % (flt["requeued_requests"],
                                         flt["retry_exhausted_requests"],
                                         flt["skipped_steps"])]
        if flt["engine_transitions"]:
            lines += ["", "Engine state transitions: " + ", ".join(
                "%s ×%d" % (k, v) for k, v
                in sorted(flt["engine_transitions"].items()))]
    else:
        lines.append("_no fault/recovery activity recorded_")
    lines += [""]
    mtr = rep.get("metrics")
    lines += ["## Metrics", ""]
    if mtr:
        for row in mtr["files"]:
            lines += ["`%s` — %d snapshot(s); final state:"
                      % (row["path"], row["snapshots"]), ""]
            if row.get("counters"):
                lines += ["Counters: " + ", ".join(
                    "%s=%d" % (k, v)
                    for k, v in sorted(row["counters"].items()))]
            gauges = {k: v for k, v in (row.get("gauges") or {}).items()
                      if v is not None}
            if gauges:
                lines += ["Gauges: " + ", ".join(
                    "%s=%.4g" % (k, v) for k, v in sorted(gauges.items()))]
            if row.get("histograms"):
                lines += ["", "| histogram | count | mean | p50 | p99 | "
                          "max |", "|---|---|---|---|---|---|"]
                for name, h in sorted(row["histograms"].items()):
                    lines.append("| %s | %d | %s | %s | %s | %s |"
                                 % (name, h["count"], h["mean"], h["p50"],
                                    h["p99"], h["max"]))
            lines += [""]
    else:
        lines.append("_no metrics snapshots found (export with "
                     "$OBS_METRICS)_")
    lines += [""]
    slo = rep.get("slo")
    lines += ["## SLO", ""]
    if slo:
        lines += ["Alerts: " + ", ".join(
            "%s ×%d" % (k, v) for k, v in sorted(slo["by_rule"].items())),
            "", "| t | what | name |", "|---|---|---|"]
        for ev in slo["timeline"]:
            lines.append("| %s | %s | %s |"
                         % (("%.3f" % ev["t"]) if isinstance(
                             ev.get("t"), (int, float)) else "?",
                            ev["what"], ev["name"]))
    else:
        lines.append("_no SLO alerts fired_")
    lines += [""]
    scl = rep.get("scaling")
    lines += ["## Scaling", ""]
    if scl:
        for row in scl["files"]:
            cfg = row["config"]
            lines += ["`%s` — pc=%s imsize=%s spatial=%s platform=%s "
                      "(%d row(s) measured, %d error(s)):"
                      % (row["path"], cfg.get("per_chip_batch", "?"),
                         cfg.get("imsize", "?"), cfg.get("spatial", "?"),
                         cfg.get("platform", "?"), row["rows_measured"],
                         row["rows_error"]), ""]
            for mode in ("weak", "strong", "multiproc"):
                entries = row["curves"].get(mode) or []
                if not entries:
                    continue
                lines += ["%s:" % mode, "",
                          "| devices | procs | img/s | img/s/chip | "
                          "eff | sharding eff | speedup |",
                          "|---|---|---|---|---|---|---|"]
                for e in entries:
                    lines.append(
                        "| %s | %s | %s | %s | %s | %s | %s |"
                        % (e.get("devices", "?"), e.get("processes", 1),
                           e.get("img_per_sec", "?"),
                           e.get("img_per_sec_per_chip", "?"),
                           e.get("weak_efficiency",
                                 e.get("strong_efficiency", "")),
                           e.get("sharding_efficiency", ""),
                           e.get("speedup", "")))
                lines += [""]
        if scl["spans"]:
            lines += ["Harness spans: " + ", ".join(
                "%s ×%d (%.2fs total)" % (k, v["count"], v["total_s"])
                for k, v in sorted(scl["spans"].items()))]
    else:
        lines.append("_no scaling activity recorded_")
    lines += [""]
    ft = rep.get("fleet")
    lines += ["## Fleet", ""]
    if ft:
        lines += ["%d dispatch(es) over %d replica(s): %s; "
                  "redispatches %d, lost %d"
                  % (ft["dispatches_total"],
                     len(ft["dispatches_by_replica"]),
                     (", ".join("rid %s ×%d" % (k, v) for k, v in
                                ft["dispatches_by_replica"].items())
                      or "-"),
                     ft["redispatches"], ft["lost"]), ""]
        if ft["shed"] or ft["tenants_shed"]:
            lines += ["Shed: %s%s" % (
                (", ".join("%s ×%d" % (k, v)
                           for k, v in sorted(ft["shed"].items()))
                 or "none"),
                ("; tenant penalty boxes: " + ", ".join(
                    "%s ×%d" % (k, v)
                    for k, v in sorted(ft["tenants_shed"].items()))
                 if ft["tenants_shed"] else "")), ""]
        if ft["lifecycle"]:
            lines += ["Replica lifecycle: " + ", ".join(
                "%s ×%d" % (k, v)
                for k, v in sorted(ft["lifecycle"].items())), ""]
        if ft["rollouts"]:
            lines += ["Canary: " + ", ".join(
                "%s ×%d" % (k, v)
                for k, v in sorted(ft["rollouts"].items())), ""]
        cs = ft.get("cascade")
        if cs:
            lines += ["### Cascade", ""]
            rate = cs.get("escalation_rate")
            lines += ["%d cascade request(s): %d escalated (%s), "
                      "%d degraded answer(s)%s"
                      % (cs["requests"], cs["escalated"],
                         ("rate %.1f%%" % (100 * rate)
                          if isinstance(rate, (int, float)) else "rate ?"),
                         cs["degraded_answers"],
                         ("; reasons: " + ", ".join(
                             "%s ×%d" % (k, v) for k, v in
                             cs["degraded_reasons"].items())
                          if cs["degraded_reasons"] else "")), ""]
            hops = cs.get("e2e_ms_by_hop") or {}
            hop_bits = ["%s p50 %s ms p99 %s ms (n=%d)"
                        % (hop, h["p50"], h["p99"], h["n"])
                        for hop, h in hops.items() if h]
            if hop_bits:
                lines += ["Per-hop e2e: " + "; ".join(hop_bits), ""]
            if cs.get("confidence"):
                lines += ["Escalation confidence range [%s, %s] over %d "
                          "fleet:escalate event(s)"
                          % (cs["confidence"]["min"],
                             cs["confidence"]["max"],
                             cs["escalate_events"]), ""]
        if ft["timeline"]:
            lines += ["| t | what | event |", "|---|---|---|"]
            for ev in ft["timeline"]:
                lines.append("| %s | %s | %s |"
                             % (("%.3f" % ev["t"]) if isinstance(
                                 ev.get("t"), (int, float)) else "?",
                                ev["what"], ev["name"]))
    else:
        lines.append("_no fleet activity recorded_")
    lines += [""]
    stm = rep.get("streams")
    lines += ["## Streams", ""]
    if stm:
        frac = stm.get("computed_tile_fraction")
        lines += ["%d stream(s), %d frame(s) delivered: %d/%d tiles "
                  "computed (%s), %d gap frame(s), %d late"
                  % (stm["streams"], stm["frames"], stm["computed_tiles"],
                     stm["total_tiles"],
                     ("computed fraction %.1f%%" % (100 * frac)
                      if isinstance(frac, (int, float))
                      else "fraction ?"),
                     stm["gaps"], stm["late"]), ""]
        if stm["frame_gap_recoveries"]:
            lines += ["Frame-gap recoveries (cache answers): " + ", ".join(
                "%s ×%d" % (k, v)
                for k, v in stm["frame_gap_recoveries"].items()), ""]
        rows = [(sid, st) for sid, st in stm["per_stream"].items()]
        if rows:
            lines += ["| sid | frames | computed | total | gaps | late "
                      "| delivery p50 ms | p99 ms |", "|---|---|---|---|"
                      "---|---|---|---|"]
            for sid, st in rows:
                d = st.get("delivery") or {}
                lines.append("| %s | %d | %d | %d | %d | %d | %s | %s |"
                             % (sid, st["frames"], st["computed_tiles"],
                                st["total_tiles"], st["gaps"], st["late"],
                                d.get("p50_ms", "?"), d.get("p99_ms", "?")))
            lines += [""]
    else:
        lines.append("_no stream activity recorded_")
    lines += [""]
    trc = rep.get("traces")
    lines += ["## Traces", ""]
    if trc:
        lines += ["%d trace(s): %d request trace(s) (%d closed, "
                  "%d re-dispatched), %d step trace(s)%s"
                  % (trc["traces"], trc["request_traces"], trc["closed"],
                     trc["redispatched_traces"], trc["step_traces"],
                     (" over ranks %s" % trc["step_ranks"]
                      if trc["step_ranks"] else "")), ""]
        if trc["orphans"] or trc["broken_chains"]:
            lines += ["**HARD ERRORS**: %d orphan trace(s) %s, %d broken "
                      "chain(s) %s — an acknowledged request's causal "
                      "chain did not close; treat like a lost ack"
                      % (trc["orphans"], trc["orphan_ids"],
                         trc["broken_chains"],
                         [b["trace"] for b in trc["broken_detail"]]), ""]
        else:
            lines += ["Completeness: every request trace closed, zero "
                      "broken chains.", ""]
        if trc["stage_shares"]:
            lines += ["Critical-path stage shares (over closed request "
                      "traces): " + ", ".join(
                          "%s %.1f%%" % (k, v * 100)
                          for k, v in trc["stage_shares"].items()), ""]
        for wf in (trc.get("waterfalls") or [])[:3]:
            cp = wf["critical_path"]
            lines += ["Trace `%s` — e2e %.3f ms, dominant stage %s, "
                      "%.1f%% attributed:"
                      % (wf["trace"], wf["e2e_ms"],
                         cp["dominant_stage"],
                         (cp["attributed_frac"] or 0) * 100), "",
                      "| rel ms | dur ms | span | fan-in | info |",
                      "|---|---|---|---|---|"]
            for row in wf["waterfall"][:20]:
                info = ", ".join("%s=%s" % (k, row[k])
                                 for k in ("rid", "b", "rank", "error",
                                           "reason", "tenant", "stage")
                                 if k in row)
                lines.append("| %.3f | %.3f | %s | %s | %s |"
                             % (row["rel_ms"], row["dur_ms"], row["name"],
                                "yes" if row["fan_in"] else "",
                                info))
            if len(wf["waterfall"]) > 20:
                lines.append("| ... | | %d more row(s) | | |"
                             % (len(wf["waterfall"]) - 20))
            lines += [""]
        if trc.get("events_in_traces"):
            lines += ["Events joined into traces: " + ", ".join(
                "%s ×%d" % (k, v)
                for k, v in trc["events_in_traces"].items()), ""]
    else:
        lines.append("_no traced spans recorded (pre-ISSUE-14 round, or "
                     "tracing never armed)_")
    lines += [""]
    q = rep["queue"]
    lines += ["## Queue", ""]
    if q:
        lines += ["Journal `%s` — states: %s%s" % (
            q["journal"],
            ", ".join("%s ×%d" % (s, n) for s, n in q["counts"].items()),
            ("; %d torn/damaged line(s) dropped" % q["dropped_lines"]
             if q["dropped_lines"] else "")), "",
            "| job | state | attempts | wall s | salvaged | error |",
            "|---|---|---|---|---|---|"]
        for name, j in q["jobs"].items():
            lines.append("| %s | %s | %d | %s | %d | %s |"
                         % (name, j["state"], j["attempts"],
                            j.get("wall_s", ""), j["salvaged_artifacts"],
                            j.get("error") or ""))
    else:
        lines.append("_no queue journal found_")
    lines += ["", "## Bench lines", ""]
    if rep["bench"]:
        for row in rep["bench"]:
            lines.append("- `%s`: %s" % (row["path"], json.dumps(
                {k: v for k, v in row.items() if k != "path"})))
    else:
        lines.append("_no bench artifacts found_")
    lines += ["", "## Loss logs", ""]
    if rep["loss"]:
        for row in rep["loss"]:
            lines.append("- `%s` (%s): %s" % (row["path"], row["schema"],
                         json.dumps({k: v for k, v in row.items()
                                     if k not in ("path", "schema")})))
    else:
        lines.append("_no loss logs given (pass --loss-log "
                     "<ckpt>/loss_log.json)_")
    return "\n".join(lines) + "\n"


def generate(args) -> Dict:
    """The report of `args.round_dir` (its name is the round's), written
    to `args.out` or `<round_dir>/obs`; each input list defaults to its
    files under the round dir."""
    round_dir = os.path.abspath(args.round_dir)
    round_name = os.path.basename(round_dir.rstrip(os.sep))
    span_paths = list(args.span_log or [])
    if not span_paths:
        # metrics*.jsonl under obs/ are obs-metrics-v1 exports, not span
        # logs — they have their own section (and glob below)
        span_paths = [p for p in sorted(glob.glob(os.path.join(
            round_dir, "obs", "*.jsonl")))
            if not os.path.basename(p).startswith("metrics")]
    queue_dir = args.queue_dir
    if queue_dir is None:
        cand = os.path.join(round_dir, "queue")
        queue_dir = cand if os.path.isdir(cand) else None
    bench_paths = list(args.bench or [])
    if not bench_paths:
        bench_paths = sorted(glob.glob(os.path.join(round_dir,
                                                    "BENCH_*.json")))
    metrics_paths = list(getattr(args, "metrics", None) or [])
    if not metrics_paths:
        metrics_paths = sorted(glob.glob(os.path.join(round_dir, "obs",
                                                      "metrics*.jsonl")))
    scaling_paths = list(getattr(args, "scaling", None) or [])
    if not scaling_paths:
        scaling_paths = sorted(glob.glob(os.path.join(round_dir,
                                                      "scaling*.json")))
    rep = build_report(round_name, span_paths, queue_dir, bench_paths,
                       list(args.loss_log or []),
                       metrics_paths=metrics_paths,
                       scaling_paths=scaling_paths)
    out_dir = args.out or os.path.join(round_dir, "obs")
    os.makedirs(out_dir, exist_ok=True)
    save_json(os.path.join(out_dir, "report.json"), rep, indent=1,
              sort_keys=True)
    atomic_write_bytes(os.path.join(out_dir, "report.md"),
                       render_markdown(rep).encode())
    log("report -> %s/report.{json,md}" % out_dir)
    return rep


# ---------------------------------------------------------------------------
# selfcheck: seeded fixtures -> report invariants (CI smoke tier)


def selfcheck() -> int:
    """Build one of everything (spans with a torn tail, a queue journal
    with done/salvaged/failed arcs, a bench line, a v2 loss log), run the
    full report path into a temp dir, and assert the joins. Mirrors
    the queue's and graftlint's --selfcheck: seconds, CPU-only."""
    import tempfile
    failures: List[str] = []

    def check(name, cond):
        print("selfcheck %-52s %s" % (name, "ok" if cond else "FAIL"),
              file=sys.stderr, flush=True)
        if not cond:
            failures.append(name)

    with tempfile.TemporaryDirectory(prefix="obs_report_selfcheck.") as tmp:
        # spans: real tracer output + a torn tail the reader must skip
        span_path = os.path.join(tmp, "obs", "spans.jsonl")
        tracer = maybe_tracer(span_path)
        for i in range(4):
            tracer.record("step", 0.01 * (i + 1), it=i)
        with tracer.span("checkpoint", epoch=0):
            pass
        tracer.event("heartbeat", label="flush 0")
        tracer.context(phase="selfcheck")
        # serving-engine taxonomy (ISSUE 8): two 2-request batches with
        # stage spans, one queue-full shed — the serving section's joins
        for i in range(4):
            tracer.record("serve:queue-wait", 0.002 * (i + 1), b=2)
            tracer.record("serve:e2e", 0.010 * (i + 1), b=2)
        for i in range(2):
            tracer.record("serve:batch-form", 0.001, n=2)
            tracer.record("serve:h2d", 0.001, b=2)
            tracer.record("serve:compute", 0.0005, b=2)
            tracer.record("serve:d2h", 0.008, b=2, n=2)
        tracer.event("serve:shed", reason="queue-full")
        # fault/recovery taxonomy (ISSUE 9): injections + what healed —
        # the Faults section's joins
        tracer.event("fault:device-loss", site="serve:dispatch", at=3,
                     seq=1)
        tracer.event("fault:nan-batch", site="train:batch", at=5, seq=2)
        tracer.event("recover:requeue", stage="dispatch", b=2, n=2,
                     error="InjectedBackendError")
        tracer.event("recover:retry-exhausted", stage="dispatch", n=1,
                     error="InjectedBackendError")
        tracer.event("recover:skip-step", n=1, total=1)
        tracer.event("recover:rollback", checkpoint="ck", epoch=1,
                     attempt=1)
        tracer.event("serve:state", **{"from": "serving",
                                       "to": "degraded"})
        with tracer.span("recover:reload"):
            pass
        # SLO watchdog taxonomy (ISSUE 10): two alerts bracketing the
        # fault above — the SLO section's join + timeline ordering
        tracer.event("alert:serve-error-burn", frac=0.5, budget=0.1,
                     window=2)
        tracer.event("alert:train-step-drift", z=5.2, value=180.0)
        # scaling harness taxonomy (ISSUE 11): compile/barrier/step spans
        # — the Scaling section's span digest
        tracer.record("scale:compile", 1.5, program="d8")
        tracer.record("scale:compile", 2.5, program="d8")
        tracer.record("scale:barrier", 0.2, program="d8")
        tracer.record("scale:step", 0.4, devices=8, world=2)
        # fleet taxonomy (ISSUE 12): dispatch counts per replica, a
        # tenant penalty box, a replica death/respawn arc and a canary
        # rollout that rolls back — the Fleet section's joins
        tracer.event("fleet:dispatch", rid=0, tenant="bulk")
        tracer.event("fleet:dispatch", rid=0, tenant="flagged")
        tracer.event("fleet:dispatch", rid=1, tenant="bulk")
        tracer.event("fleet:shed", reason="tenant-budget", tenant="bulk")
        tracer.event("fleet:tenant-shed", tenant="bulk", penalty=2,
                     rule="tenant-bulk-latency-burn")
        tracer.event("fleet:rollout", rid=1, frac=0.25, window=16)
        tracer.event("fleet:replica-death", rid=0,
                     reason="fault: worker-death")
        tracer.event("fleet:respawn", rid=0, generation=1)
        tracer.event("fleet:redispatch", rid=0, attempt=1,
                     error="EngineClosedError")
        tracer.event("fleet:rollback", rid=1, reason="canary-error-burn",
                     alerts=1)
        # distributed-tracing taxonomy (ISSUE 14): a complete two-hop
        # request arc (root closure + child hops + a fan-in batch span +
        # a fault/redispatch joined INTO the trace), an orphan (child,
        # never closed) and a broken chain (parent never written) — the
        # Traces section's joins and its hard-error detectors
        from . import trace as trace_mod
        trace_mod.reset_ids(42)
        tr1 = trace_mod.new_root()
        tr2 = trace_mod.new_root()
        tracer.record("serve:queue-wait", 0.004, ctx=tr1.child(), b=2)
        tracer.record("serve:queue-wait", 0.002, ctx=tr2.child(), b=2)
        tracer.record("serve:compute", 0.006,
                      links=trace_mod.links_of([tr1, tr2]), b=2)
        tracer.event("fault:device-loss", site="serve:dispatch",
                     ctx=tr1.child())
        tracer.event("fleet:redispatch", ctx=tr1.child(), rid=0,
                     attempt=1)
        tracer.record("fleet:e2e", 0.020, ctx=tr1)
        tracer.record("fleet:e2e", 0.012, ctx=tr2)
        orphan = trace_mod.new_root()
        tracer.record("serve:queue-wait", 0.001, ctx=orphan.child())
        broken = trace_mod.new_root()
        tracer.record("serve:queue-wait", 0.001,
                      ctx=trace_mod.TraceContext(broken.trace_id,
                                                 "dangling-child",
                                                 "never-written"))
        tracer.record("serve:e2e", 0.005, ctx=broken)
        # cascade taxonomy (ISSUE 16, obs-report-v6): an edge-resolved
        # request, an escalated two-hop request and a degraded answer —
        # the Fleet Cascade subsection's joins (ctx-free on purpose: the
        # cascade counters read the e2e meta, not the trace graph, so
        # the Traces-section fixtures above stay untouched)
        tracer.record("fleet:e2e", 0.006, rid=0, escalated=False,
                      degraded=False)
        tracer.event("fleet:escalate", rid=0, tenant="cas",
                     confidence=0.12, threshold=0.3)
        tracer.record("fleet:e2e", 0.030, rid=1, escalated=True,
                      degraded=False)
        tracer.event("fleet:escalate", rid=0, tenant="cas",
                     confidence=0.05, threshold=0.3)
        tracer.event("fleet:degraded", tenant="cas",
                     reason="escalate-fault:InjectedBackendError")
        tracer.record("fleet:e2e", 0.009, rid=0, escalated=True,
                      degraded=True)
        # streaming taxonomy (ISSUE 17, obs-report-v7): per-frame
        # delivery records for two delta-gated sessions (sid 0 takes a
        # dropped-frame gap answered from the tile cache, sid 1 a late
        # frame) — the Streams section's joins
        tracer.record("stream:frame", 0.004, sid=0, seq=0, computed=4,
                      total=4, gap=False, late=False)
        tracer.record("stream:frame", 0.002, sid=0, seq=1, computed=1,
                      total=4, gap=False, late=False)
        tracer.record("stream:frame", 0.001, sid=0, seq=2, computed=0,
                      total=4, gap=True, late=False)
        tracer.record("stream:frame", 0.003, sid=1, seq=0, computed=4,
                      total=4, gap=False, late=True)
        tracer.event("recover:frame-gap", sid=0, seq=2,
                     kind="dropped-frame")
        tracer.close()
        with open(span_path, "a") as f:  # graftlint: off=raw-artifact-write
            f.write('{"kind": "span", "torn')  # kill -9 mid-append twin

        # a second (per-rank) span log with a rank-tagged step trace and
        # a torn TRACED tail: the cross-process join + the reader's
        # recovery contract over trace records specifically
        span2_path = os.path.join(tmp, "obs", "spans_rank1.jsonl")
        from .spans import SpanTracer
        t2 = SpanTracer(span2_path)
        t2.bind(rank=1, world=2)
        t2.record("step", 0.01,
                  ctx=trace_mod.step_context(0, rank=1, run="fix"))
        t2.close()
        with open(span2_path, "a") as f:  # graftlint: off=raw-artifact-write
            f.write('{"kind": "span", "name": "serve:e2e", "trace": "to')

        # queue journal: done + salvaged->failed arcs, torn tail
        qdir = os.path.join(tmp, "queue")
        os.makedirs(qdir)
        recs = [
            {"kind": "spec", "job": "bench", "argv": ["python", "bench.py"],
             "t": 100.0, "v": 1},
            {"kind": "state", "job": "bench", "state": "queued", "t": 100.0,
             "attempt": 1},
            {"kind": "state", "job": "bench", "state": "running",
             "t": 101.0, "attempt": 1},
            {"kind": "state", "job": "bench", "state": "done", "t": 161.0,
             "attempt": 1},
            {"kind": "spec", "job": "sweep", "argv": ["python", "s.py"],
             "t": 102.0, "v": 1},
            {"kind": "state", "job": "sweep", "state": "queued", "t": 102.0,
             "attempt": 1},
            {"kind": "state", "job": "sweep", "state": "running",
             "t": 103.0, "attempt": 1},
            {"kind": "state", "job": "sweep", "state": "salvaged",
             "t": 113.0, "attempt": 1,
             "salvaged_artifacts": [{"path": "sweep.json"}]},
            {"kind": "state", "job": "sweep", "state": "failed", "t": 114.0,
             "attempt": 2, "error": "UNAVAILABLE: injected"},
            {"kind": "note", "event": "diagnostic"},
        ]
        body = "".join(json.dumps(r) + "\n" for r in recs) + '{"kind": "st'
        atomic_write_bytes(os.path.join(qdir, "jobs.jsonl"), body.encode())

        # one bench line + one v2 loss log
        bench_path = os.path.join(tmp, "BENCH_rXX_local.json")
        atomic_write_bytes(bench_path, (json.dumps(
            {"metric": "inference_fps_512", "value": 1207.7,
             "platform": "tpu", "mfu_train": 0.53, "recompile_count": 7,
             "loadavg": [1.0, 1.2, 1.4]}) + "\n").encode())
        loss_path = os.path.join(tmp, "loss_log.json")
        atomic_write_bytes(loss_path, json.dumps(
            {"schema": "loss-log-v2", "hm": [1.0, 0.5], "offset": [1, 0.4],
             "size": [1, 0.3], "total": [3.0, 1.2],
             "grad_norm": [30.0, 7.0], "update_norm": [0.8, 0.5],
             "param_norm": [49.0, 49.1]}).encode())

        # live metrics export (ISSUE 10): two snapshots + a torn tail the
        # reader must drop — the Metrics section's input
        from .metrics import MetricsRegistry, MetricsWriter
        metrics_path = os.path.join(tmp, "obs", "metrics.jsonl")
        mreg = MetricsRegistry()
        mreg.counter("serve.completed").inc(7)
        mreg.gauge("queue.jobs.done").set(1)
        for v in (10.0, 20.0, 30.0, 40.0):
            mreg.histogram("serve.e2e_ms").observe(v)
        mw = MetricsWriter(mreg, metrics_path, period_s=0.0)
        mw.maybe_flush(force=True)
        mreg.counter("serve.completed").inc(1)
        mw.maybe_flush(force=True)
        mw.close()
        with open(metrics_path, "a") as f:  # graftlint: off=raw-artifact-write
            f.write('{"schema": "obs-met')  # kill -9 mid-append twin

        # scaling-v2 artifact (ISSUE 11): the Scaling section's table input
        scaling_path = os.path.join(tmp, "scaling.json")
        save_json(scaling_path, {
            "schema": "scaling-v2",
            "config": {"per_chip_batch": 2, "imsize": 64, "iters": 4,
                       "spatial": 1, "max_devices": 8, "platform": "cpu"},
            "results": [{"devices": 8, "processes": 2, "global_batch": 16,
                         "img_per_sec": 300.0}],
            "curves": {"weak": [{"devices": 8, "img_per_sec": 300.0,
                                 "img_per_sec_per_chip": 37.5,
                                 "step_ms": 426.0,
                                 "weak_efficiency": 0.83,
                                 "sharding_efficiency": 0.91}],
                       "strong": [],
                       "multiproc": [{"devices": 8, "processes": 2,
                                      "img_per_sec": 290.0,
                                      "img_per_sec_per_chip": 36.2,
                                      "step_ms": 441.0,
                                      "sharding_efficiency": 0.88}]}})

        ns = argparse.Namespace(round_dir=os.path.join(tmp, "rXX"),
                                span_log=[span_path, span2_path],
                                queue_dir=qdir, bench=[bench_path],
                                loss_log=[loss_path],
                                metrics=[metrics_path],
                                scaling=[scaling_path],
                                out=os.path.join(tmp, "out"))
        rep = generate(ns)

        check("schema tagged", rep["schema"] == SCHEMA)
        sp = rep["spans"]
        check("torn span tail dropped, all real records read",
              sp["records"] == 72)  # meta + 4 steps + ckpt + hb + ctx
        # + 16 serve spans + shed event + 7 fault/recover events +
        # reload span + 2 alert events + 4 scale spans + 10 fleet events
        # + 10 trace-fixture records + 6 cascade records + 4 stream
        # records + frame-gap event + log2's meta + rank-1 step (both
        # torn tails dropped)
        check("step span stats", sp["by_name"].get("step", {}).get(
            "count") == 5 and abs(sp["by_name"]["step"]["total_s"]
                                  - 0.11) < 1e-6)
        check("heartbeat event counted",
              sp["events"].get("heartbeat") == 1)
        check("context sampled", sp["context"]["samples"] == 1)
        srv = rep["serving"]
        check("serving section joined", srv is not None
              and srv["requests"] == 5 and srv["batches"] == 2
              and srv["shed"] == {"queue-full": 1})
        # nearest-rank percentiles over [5, 10, 20, 30, 40] ms (the
        # trace fixtures add a 5 ms e2e): p50 idx round(0.5*4)=2 -> 20,
        # p99 idx 4 -> 40
        check("serving p50/p99 computed",
              srv["e2e"]["p50_ms"] == 20.0 and srv["e2e"]["p99_ms"] == 40.0
              and srv["queue_wait"]["count"] == 8)
        check("serving stage digests + fill",
              set(srv["stages"]) == {"batch-form", "h2d", "compute", "d2h"}
              and srv["mean_batch_fill"] == 2.0)
        flt = rep["faults"]
        check("faults section joined", flt is not None
              and flt["injected"] == {"device-loss": 2, "nan-batch": 1}
              and flt["by_site"] == {"serve:dispatch": 2,
                                     "train:batch": 1})
        check("recovery evidence joined",
              flt["recoveries"].get("requeue") == 1
              and flt["recoveries"].get("reload") == 1
              and flt["recoveries"].get("rollback") == 1
              and flt["requeued_requests"] == 2
              and flt["retry_exhausted_requests"] == 1
              and flt["skipped_steps"] == 1)
        check("engine transitions joined",
              flt["engine_transitions"] == {"serving->degraded": 1})
        mtr = rep["metrics"]
        check("metrics section joined", mtr is not None
              and len(mtr["files"]) == 1
              and mtr["files"][0]["snapshots"] == 3  # 2 flushes + close
              and mtr["files"][0]["counters"]["serve.completed"] == 8)
        # nearest-rank over [10, 20, 30, 40] ms at histogram resolution:
        # p50 -> the 30 ms bucket (~9% wide), p99 -> max = 40
        check("metrics histogram digested",
              abs(mtr["files"][0]["histograms"]["serve.e2e_ms"]["p50"]
                  - 30.0) < 3.0
              and mtr["files"][0]["histograms"]["serve.e2e_ms"]["max"]
              == 40.0)
        slo_sec = rep["slo"]
        check("slo section joined", slo_sec is not None
              and slo_sec["by_rule"] == {"serve-error-burn": 1,
                                         "train-step-drift": 1}
              and slo_sec["alert_total"] == 2)
        tl_names = [ev["name"] for ev in slo_sec["timeline"]]
        check("slo timeline joins faults + state transitions",
              "fault:device-loss" in tl_names
              and "recover:requeue" in tl_names
              and "serve:state serving->degraded" in tl_names
              and tl_names.index("fault:device-loss")
              < tl_names.index("serve-error-burn"))
        scl = rep["scaling"]
        check("scaling section joined", scl is not None
              and len(scl["files"]) == 1
              and scl["files"][0]["rows_measured"] == 1
              and scl["files"][0]["curves"]["weak"][0][
                  "sharding_efficiency"] == 0.91)
        check("scaling spans digested",
              scl["spans"].get("compile", {}).get("count") == 2
              and abs(scl["spans"]["compile"]["total_s"] - 4.0) < 1e-6
              and scl["spans"].get("barrier", {}).get("count") == 1)
        ft = rep["fleet"]
        check("fleet section joined", ft is not None
              and ft["dispatches_by_replica"] == {"0": 2, "1": 1}
              and ft["dispatches_total"] == 3
              and ft["redispatches"] == 2
              and ft["shed"] == {"tenant-budget": 1}
              and ft["tenants_shed"] == {"bulk": 1})
        check("fleet lifecycle + canary joined",
              ft["lifecycle"] == {"replica-death": 1, "respawn": 1}
              and ft["rollouts"] == {"rollout": 1, "rollback": 1})
        ft_names = [ev["name"] for ev in ft["timeline"]]
        check("fleet timeline joins alerts + faults",
              "fault:device-loss" in ft_names
              and any(n.startswith("alert:") for n in ft_names)
              and any(n.startswith("fleet:rollout") for n in ft_names)
              and (ft_names.index("fleet:rollout rid=1")
                   < ft_names.index(
                       "fleet:rollback rid=1 (canary-error-burn)")))
        cs = ft["cascade"]
        check("fleet cascade subsection joined",
              cs is not None and cs["requests"] == 3
              and cs["escalated"] == 2
              and cs["escalation_rate"] == round(2 / 3, 4)
              and cs["degraded_answers"] == 1
              and cs["escalate_events"] == 2
              and cs["degraded_reasons"]
              == {"escalate-fault:InjectedBackendError": 1}
              and cs["confidence"] == {"min": 0.05, "max": 0.12})
        check("cascade per-hop e2e split",
              (cs["e2e_ms_by_hop"]["edge"] or {}).get("n") == 1
              and cs["e2e_ms_by_hop"]["edge"]["p50"] == 6.0
              and (cs["e2e_ms_by_hop"]["escalated"] or {}).get("n") == 2)
        check("cascade volume stays out of the fleet timeline",
              not any(n.startswith("fleet:escalate") for n in ft_names)
              and any(n.startswith("fleet:degraded") for n in ft_names))
        trc = rep["traces"]
        check("traces section joined", trc is not None
              and trc["request_traces"] == 4 and trc["closed"] == 3
              and trc["redispatched_traces"] == 1)
        check("traces hard errors detected",
              trc["orphans"] == 1 and trc["broken_chains"] == 1
              and trc["complete"] == 2)
        check("traces step join carries rank",
              trc["step_traces"] == 1 and trc["step_ranks"] == [1])
        check("traces waterfalls + joined events",
              trc["waterfalls"]
              and trc["waterfalls"][0]["e2e_ms"] == 20.0
              and trc["waterfalls"][0]["critical_path"][
                  "dominant_stage"] == "serve:compute"
              and any(r["fan_in"] for r in
                      trc["waterfalls"][0]["waterfall"])
              and trc["events_in_traces"].get("fault:device-loss") == 1
              and trc["events_in_traces"].get("fleet:redispatch") == 1)
        stm = rep["streams"]
        check("streams section joined", stm is not None
              and stm["streams"] == 2 and stm["frames"] == 4
              and stm["computed_tiles"] == 9 and stm["total_tiles"] == 16
              and stm["computed_tile_fraction"] == 0.5625
              and stm["tile_skip_rate"] == 0.4375
              and stm["gaps"] == 1 and stm["late"] == 1
              and stm["frame_gap_recoveries"] == {"dropped-frame": 1})
        check("streams per-stream rollup + delivery digest",
              stm["per_stream"]["0"]["frames"] == 3
              and stm["per_stream"]["0"]["computed_tiles"] == 5
              and stm["per_stream"]["0"]["gaps"] == 1
              and stm["per_stream"]["0"]["delivery"]["p50_ms"] == 2.0
              and stm["per_stream"]["1"]["late"] == 1)
        check("stream frame-gap recovery also joins the faults section",
              flt["recoveries"].get("frame-gap") == 1)
        q = rep["queue"]
        check("queue states joined", q is not None
              and q["jobs"]["bench"]["state"] == "done"
              and q["jobs"]["sweep"]["state"] == "failed")
        check("queue wall computed",
              q["jobs"]["bench"].get("wall_s") == 61.0)
        check("salvage evidence carried",
              q["jobs"]["sweep"]["salvaged_artifacts"] == 1)
        check("torn journal tail dropped", q["dropped_lines"] == 1)
        check("bench line joined", rep["bench"]
              and rep["bench"][0]["value"] == 1207.7
              and rep["bench"][0]["recompile_count"] == 7)
        check("loss log v2 read", rep["loss"]
              and rep["loss"][0]["schema"] == "loss-log-v2"
              and rep["loss"][0]["grad_norm"]["final"] == 7.0)
        check("report files written",
              os.path.exists(os.path.join(tmp, "out", "report.json"))
              and os.path.exists(os.path.join(tmp, "out", "report.md")))
        md = open(os.path.join(tmp, "out", "report.md")).read()
        check("markdown carries queue table", "| bench | done |" in md)
        check("markdown carries serving section",
              "## Serving" in md and "e2e latency: p50 20.000 ms" in md)
        check("markdown carries faults section",
              "## Faults" in md and "device-loss ×2" in md
              and "rollback ×1" in md
              and "serving->degraded ×1" in md)
        check("markdown carries metrics + slo sections",
              "## Metrics" in md and "serve.completed=8" in md
              and "## SLO" in md and "serve-error-burn ×1" in md)
        check("markdown carries scaling section",
              "## Scaling" in md and "| 8 | 2 |" in md
              and "0.91" in md and "Harness spans:" in md)
        check("markdown carries fleet section",
              "## Fleet" in md and "rid 0 ×2" in md
              and "replica-death ×1" in md and "rollback ×1" in md
              and "tenant penalty boxes: bulk ×1" in md)
        check("markdown carries traces section",
              "## Traces" in md and "HARD ERRORS" in md
              and "dominant stage serve:compute" in md
              and "fleet:redispatch ×1" in md)
        check("markdown carries cascade subsection",
              "### Cascade" in md and "2 escalated (rate 66.7%)" in md
              and "1 degraded answer(s)" in md
              and "escalate-fault:InjectedBackendError" in md)
        check("markdown carries streams section",
              "## Streams" in md
              and "9/16 tiles computed" in md
              and "dropped-frame ×1" in md
              and "| 0 | 3 | 5 | 12 | 1 | 0 |" in md)

        # schema compat: the generated v2 report reads back through
        # read_report, and a committed v1 report (a pre-ISSUE-10 round)
        # normalizes with the new sections nulled; junk schemas refuse
        rep_path = os.path.join(tmp, "out", "report.json")
        back = read_report(rep_path)
        check("v2 report readable via read_report",
              back is not None and back["schema"] == SCHEMA
              and back["metrics"] is not None)
        v1_path = os.path.join(tmp, "report_v1.json")
        atomic_write_bytes(v1_path, json.dumps(
            {"schema": "obs-report-v1", "round": "r08",
             "spans": {"records": 3}}).encode())
        v1 = read_report(v1_path)
        check("v1 report readable with v2 sections nulled",
              v1 is not None and v1["metrics"] is None
              and v1["slo"] is None and v1["scaling"] is None
              and v1["fleet"] is None
              and v1["spans"]["records"] == 3)
        # a committed v2 report (pre-ISSUE-11 round) nulls Scaling+Fleet
        v2_path = os.path.join(tmp, "report_v2.json")
        atomic_write_bytes(v2_path, json.dumps(
            {"schema": "obs-report-v2", "round": "r12",
             "metrics": {"files": []}, "slo": None,
             "spans": {"records": 5}}).encode())
        v2 = read_report(v2_path)
        check("v2 report readable with scaling nulled",
              v2 is not None and v2["scaling"] is None
              and v2["fleet"] is None
              and v2["metrics"] is not None
              and v2["spans"]["records"] == 5)
        # a committed v3 report (pre-ISSUE-12 round) nulls only Fleet
        v3_path = os.path.join(tmp, "report_v3.json")
        atomic_write_bytes(v3_path, json.dumps(
            {"schema": "obs-report-v3", "round": "r13",
             "metrics": {"files": []}, "slo": None,
             "scaling": {"files": [], "spans": {}},
             "spans": {"records": 7}}).encode())
        v3 = read_report(v3_path)
        check("v3 report readable with fleet nulled",
              v3 is not None and v3["fleet"] is None
              and v3["scaling"] is not None
              and v3["spans"]["records"] == 7)
        check("v1-v3 reports null the traces section",
              v1["traces"] is None and v2["traces"] is None
              and v3["traces"] is None)
        # a committed v4 report (pre-ISSUE-14 round) nulls only Traces
        v4_path = os.path.join(tmp, "report_v4.json")
        atomic_write_bytes(v4_path, json.dumps(
            {"schema": "obs-report-v4", "round": "r15",
             "metrics": {"files": []}, "slo": None,
             "scaling": {"files": [], "spans": {}},
             "fleet": {"dispatches_total": 3},
             "spans": {"records": 9}}).encode())
        v4 = read_report(v4_path)
        check("v4 report readable with traces nulled",
              v4 is not None and v4["traces"] is None
              and v4["fleet"] is not None
              and v4["spans"]["records"] == 9)
        # a committed v5 report (pre-ISSUE-16 round) keeps its fleet
        # section but nulls the Cascade subsection inside it
        v5_path = os.path.join(tmp, "report_v5.json")
        atomic_write_bytes(v5_path, json.dumps(
            {"schema": "obs-report-v5", "round": "r15",
             "metrics": {"files": []}, "slo": None,
             "scaling": {"files": [], "spans": {}},
             "fleet": {"dispatches_total": 3},
             "traces": {"traces": 0},
             "spans": {"records": 11}}).encode())
        v5 = read_report(v5_path)
        check("v5 report readable with fleet cascade nulled",
              v5 is not None and v5["fleet"] is not None
              and v5["fleet"]["cascade"] is None
              and v5["traces"] is not None
              and v5["spans"]["records"] == 11)
        check("v1-v4 fleet sections also null cascade on read",
              v4["fleet"]["cascade"] is None)
        # a committed v6 report (pre-ISSUE-17 round) nulls only Streams
        v6_path = os.path.join(tmp, "report_v6.json")
        atomic_write_bytes(v6_path, json.dumps(
            {"schema": "obs-report-v6", "round": "r16",
             "metrics": {"files": []}, "slo": None,
             "scaling": {"files": [], "spans": {}},
             "fleet": {"dispatches_total": 3, "cascade": {"requests": 3}},
             "traces": {"traces": 0},
             "spans": {"records": 13}}).encode())
        v6 = read_report(v6_path)
        check("v6 report readable with streams nulled",
              v6 is not None and v6["streams"] is None
              and v6["fleet"]["cascade"] is not None
              and v6["traces"] is not None
              and v6["spans"]["records"] == 13)
        check("v1-v5 reports also null streams on read",
              v1["streams"] is None and v3["streams"] is None
              and v5["streams"] is None)
        junk_path = os.path.join(tmp, "report_junk.json")
        atomic_write_bytes(junk_path, json.dumps(
            {"schema": "obs-report-v9"}).encode())
        check("unknown report schema refused",
              read_report(junk_path) is None)

    ok = not failures
    print(json.dumps({"tool": "obs_report", "selfcheck": True, "ok": ok,
                      "failures": failures}))
    sys.stdout.flush()
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.obs.report",
        description=__doc__.splitlines()[0])
    p.add_argument("--round-dir", default=None,
                   help="the round's directory (its name names the round)")
    p.add_argument("--span-log", action="append", default=[],
                   help="span JSONL path; repeat (default "
                        "<round-dir>/obs/*.jsonl but metrics*)")
    p.add_argument("--queue-dir", default=None,
                   help="job spool dir (default <round-dir>/queue when "
                        "present)")
    p.add_argument("--bench", action="append", default=[],
                   help="bench JSON-line file; repeat (default "
                        "<round-dir>/BENCH_*.json)")
    p.add_argument("--loss-log", action="append", default=[],
                   help="loss_log.json sidecar (v1 or v2); repeat")
    p.add_argument("--metrics", action="append", default=[],
                   help="obs-metrics-v1 JSONL path; repeat (default "
                        "<round-dir>/obs/metrics*.jsonl)")
    p.add_argument("--scaling", action="append", default=[],
                   help="scaling-v2 artifact path; repeat (default "
                        "<round-dir>/scaling*.json)")
    p.add_argument("--out", default=None,
                   help="output dir (default <round-dir>/obs)")
    p.add_argument("--selfcheck", action="store_true",
                   help="seeded fixtures -> report invariants, then exit")
    args = p.parse_args(argv)
    if args.selfcheck:
        return selfcheck()
    if args.round_dir is None:
        p.error("--round-dir is required (or --selfcheck)")
    rep = generate(args)
    print(json.dumps(rep, sort_keys=True))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
