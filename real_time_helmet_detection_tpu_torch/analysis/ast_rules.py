"""AST convention rules over the port's sources (graftlint layer 2).

Port of ref real_time_helmet_detection_tpu/analysis/ast_rules.py:963-969
(`RULES`) and its entry functions (:975-1019), stdlib `ast` only, no torch. The
scope is the port: `real_time_helmet_detection_tpu_torch/` and the root
scripts that drive it (`chip_smoke.py`, `qconv_ablation.py`), without
tests, build outputs and artifacts (JAX's `EXCLUDE_DIRS`,
ast_rules.py:133). Every JAX rule has a counterpart here, or a line
saying why none applies:

* `per-call-timing`     — two wall-clock reads around a kernel launch (a
                          `helmet` op, a kernel wrapper, a CUDA graph
                          replay, a `launch_*` helper) with no
                          synchronize, event read or host fetch between
                          them: a launch is asynchronous, so that
                          interval measures the enqueue only.
* `queue-bypass`        — none: JAX's scope is its `scripts/` of TPU jobs
                          that must heartbeat to its queue; the port has
                          no such scripts (its jobs call
                          `runtime.run_as_job`; `chip_smoke.py` is a
                          one-shot smoke run on one card).
* `env-platform-write`  — a write of `CUDA_VISIBLE_DEVICES` (assignment,
                          `setdefault`, `putenv`) after a `torch.cuda`
                          call in the same scope: CUDA reads the
                          variable once, when it initialises.
* `raw-artifact-write`  — `open(..., "w"/"wb")` outside
                          `utils.atomic_write_bytes` (use it or
                          `utils.save_json`).
* `device-get-in-loop`  — a host fetch (`.item()`, `.cpu()`, `.tolist()`,
                          `.numpy()`) or `torch.cuda.synchronize()`
                          inside a loop, outside the modules whose loops
                          fetch by design (`DEVICE_GET_LOOP_ALLOW`).
* `missing-ref-citation`— a module docstring with no `ref <file:line>`
                          or no-analogue statement.
* `raw-span-timing`     — `time.X() - start` in a chip-path script
                          (`CHIP_SCRIPTS` that use the card): route it
                          through `obs.spans.SpanTracer`.
* `device-get-in-serving-loop` — a host fetch inside a loop in
                          `serving/` anywhere but the engine's batched
                          fetch (`ServingEngine._fetch_loop`).
* `raw-metric-aggregation` — hand-rolled percentile/median arithmetic in
                          a chip-path script: use `obs.metrics`.
* `unbarriered-collective-start` — a multi-process entry point
                          (`init_process_group` / `init_distributed`)
                          that builds a kernel library (`build_ops`,
                          `_build.*`, `load_library`) or AOT-compiles
                          (`.lower(...).compile()`) with no
                          `barrier_synced_build` or barrier helper: a
                          rank that builds late reaches the first
                          collective after the others' deadline.
* `engine-bypass-in-fleet` — raw `ServingEngine` construction or
                          `<x>.engine.submit(...)` in fleet code, outside
                          `FleetRouter._spawn` / `_dispatch`.
* `context-free-span`   — a `serve:`/`fleet:`/`recover:` span in
                          `serving/` without `ctx=` or `links=`.
* `hand-picked-threshold` — a numeric-literal cascade/stream threshold
                          in the serving plane (`config.cascade_overrides`
                          and `stream_overrides` hold the calibrated
                          ones).
* `unbounded-retry`     — a `while True` whose handler swallows and
                          loops again with no cap and no backoff.

Suppression: `# graftlint: off=<rule>[,<rule>]` inside the flagged
node's lines, with a comment that says why (as JAX's).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Sequence, Tuple

from . import Finding

PKG = "real_time_helmet_detection_tpu_torch/"

# ---------------------------------------------------------------------------
# scope (paths repo-relative, "/"-separated)

EXCLUDE_DIRS = {"tests", "artifacts", "build", "cpp", "csrc", "docs",
                ".git", "__pycache__"}
# the port's root scripts; the rest of the root is the JAX side's
ROOT_FILES = ("chip_smoke.py", "qconv_ablation.py")
# chip-path scripts: what JAX's scripts/ and bench.py are to the TPU
CHIP_SCRIPTS = {"chip_smoke.py", "qconv_ablation.py",
                PKG + "serving/runs.py"}

TIMING_ALLOW = set()
DEVICE_GET_LOOP_ALLOW = {
    # the eval pipeline: the fetch of batch i IS its completion point
    # while batch i + 1 computes
    PKG + "evaluate.py",
    # the deferred loss flush every --print-interval steps and the
    # epoch-boundary reads: the documented alternative to a per-step sync
    PKG + "train.py",
    # the engine's batched fetch; serving/ is policed by the stricter
    # device-get-in-serving-loop below
    PKG + "serving/engine.py",
    # the card check and the ablation: every comparison and timing loop
    # fetches on purpose, outside any hot path
    "chip_smoke.py", "qconv_ablation.py",
}
SERVING_PREFIX = PKG + "serving/"
SERVING_FETCH_ALLOW = {PKG + "serving/engine.py::ServingEngine._fetch_loop"}
FLEET_FILE_MARKERS = ("fleet", "router")
FLEET_ENGINE_ALLOW = {
    PKG + "serving/fleet.py::FleetRouter._spawn",
    PKG + "serving/fleet.py::FleetRouter._dispatch",
}
RAW_WRITE_ALLOW = {PKG + "utils.py"}
TRACE_LIFECYCLE_SPANS = {
    "serve:compile", "serve:state", "serve:killed", "serve:degrade",
    "recover:reload",
    "fleet:rollout", "fleet:promote", "fleet:rollback",
    "fleet:replica-death", "fleet:respawn", "fleet:reload-timeout",
    "fleet:tenant-shed",
}
_TRACED_SPAN_PREFIXES = ("serve:", "fleet:", "recover:")
_TRACER_EMIT_FNS = {"span", "record", "event"}
# the card check's own timing harness: each wall it reports brackets a
# synchronize or CUDA events, and its statistics go to its JSON line
RAW_SPAN_ALLOW = {"chip_smoke.py", "qconv_ablation.py"}
METRIC_AGG_ALLOW = {"chip_smoke.py", "qconv_ablation.py"}

_REF_PATTERNS = (
    re.compile(r"\bref\s+\S+:\d"),             # "ref train.py:86"
    re.compile(r"reference\s+has\s+no", re.I),
    re.compile(r"no\s+reference\s+analogue", re.I),
)

_SUPPRESS_RE = re.compile(r"#.*graftlint:\s*off=([\w,/-]+)")

_TIMING_FNS = {"time", "perf_counter", "monotonic"}
# host fetches of a tensor (zero-argument methods) and the syncs
_FETCH_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_LEAVES = {"synchronize", "elapsed_time"}
# what launches a kernel: a `helmet` op, a kernel wrapper, a replay
_LAUNCH_LEAVES = {
    "replay", "peak_scores", "bn_act", "bn_add_act", "bn_act_eval",
    "bn_add_act_eval", "bn_act_train", "bn_add_act_train", "bn_stats",
    "bn_eval_bwd", "bn_add_eval_bwd", "bn_bwd_sums", "bn_bwd_dx",
    "bn_add_bwd_sums", "bn_add_bwd_dx", "loss_sums", "loss_sums_bwd",
    "fused_detection_loss", "quantize_act", "abs_max", "conv_dense",
    "conv_dw", "ste_conv"}


def _suppressed(rule: str, lines: Sequence[str], lo: int, hi: int) -> bool:
    """Is `rule` switched off by a `# graftlint: off=` marker in
    source lines [lo, hi] (1-based, inclusive)?"""
    short = rule.split("/", 1)[-1]
    for ln in lines[max(0, lo - 1):hi]:
        m = _SUPPRESS_RE.search(ln)
        if m and short in m.group(1).split(","):
            return True
    return False


def _node_span(node: ast.AST) -> Tuple[int, int]:
    lo = getattr(node, "lineno", 1)
    hi = getattr(node, "end_lineno", lo)
    return lo, hi


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target, best effort ("time.perf_counter",
    "torch.cuda.synchronize", "open", ...)."""
    parts: List[str] = []
    t = node.func
    while isinstance(t, ast.Attribute):
        parts.append(t.attr)
        t = t.value
    if isinstance(t, ast.Name):
        parts.append(t.id)
    return ".".join(reversed(parts))


def _is_fetch(call: ast.Call) -> bool:
    """A host fetch or a sync: `<x>.item()`, `.cpu()`, `.tolist()`,
    `.numpy()` with no arguments, or `torch.cuda.synchronize(...)`."""
    name = _call_name(call)
    leaf = name.split(".")[-1]
    if name.endswith("cuda.synchronize"):
        return True
    return isinstance(call.func, ast.Attribute) and leaf in _FETCH_METHODS \
        and not call.args and not call.keywords


def _is_launch(call: ast.Call) -> bool:
    name = _call_name(call)
    leaf = name.split(".")[-1]
    return leaf in _LAUNCH_LEAVES or leaf.startswith("launch_") \
        or ".ops.helmet." in "." + name + "."


def _iter_scopes(tree: ast.Module) -> Iterable[Tuple[str, ast.AST,
                                                     List[ast.stmt]]]:
    """(qualname, node, body) for the module and every (nested) function/
    class scope. Each function's body EXCLUDES nested function bodies, so
    a pattern split across an outer function and its closure does not
    double-report."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = (prefix + "." + child.name) if prefix else child.name
                yield qual, child, child.body
                yield from walk(child, qual)
            else:
                yield from walk(child, prefix)

    yield "module", tree, tree.body
    yield from walk(tree, "")


def _scope_calls(body: List[ast.stmt]) -> Iterable[ast.Call]:
    """Every Call in a scope body, NOT descending into nested defs."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# the rules


def rule_per_call_timing(tree, lines, relpath) -> List[Finding]:
    """Two wall-clock reads with a kernel launch between them and no
    synchronize, event read or host fetch in that interval (source
    order within one function, nested defs apart)."""
    out = []
    for qual, node, body in _iter_scopes(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "%s::%s" % (relpath, qual) in TIMING_ALLOW:
            continue
        events = []  # (line, col, kind)
        for call in _scope_calls(body):
            name = _call_name(call)
            pos = (call.lineno, call.col_offset)
            if name.startswith("time.") \
                    and name.split(".")[-1] in _TIMING_FNS:
                events.append(pos + ("clock",))
            elif _is_fetch(call) or name.split(".")[-1] in _SYNC_LEAVES:
                events.append(pos + ("sync",))
            elif _is_launch(call):
                events.append(pos + ("launch",))
        events.sort()
        hit = 0
        opened = launched = False
        for line, _, kind in events:
            if kind == "clock":
                if opened and launched:
                    hit = line
                    break
                opened, launched = True, False
            elif kind == "sync":
                launched = False
            elif opened:
                launched = True
        if not hit:
            continue
        lo, hi = _node_span(node)
        if _suppressed("per-call-timing", lines, lo, hi):
            continue
        out.append(Finding(
            rule="ast/per-call-timing", path=relpath, line=hit,
            context=qual,
            message="wall-clock reads around a kernel launch with no "
                    "synchronize or event between them: the launch is "
                    "asynchronous, so the interval measures the enqueue "
                    "only — time with torch.cuda.Event, or synchronize "
                    "before the second read"))
    return out


def _cuda_touch(call: ast.Call) -> bool:
    """Does this call initialise CUDA: `torch.cuda.*(...)`, `<t>.cuda()`,
    `torch.device("cuda...")`?"""
    name = _call_name(call)
    if name.startswith("torch.cuda.") or name.endswith(".cuda"):
        return True
    return name in ("torch.device", "device") and bool(call.args) \
        and isinstance(call.args[0], ast.Constant) \
        and str(call.args[0].value).startswith("cuda")


def rule_env_platform_write(tree, lines, relpath) -> List[Finding]:
    """`CUDA_VISIBLE_DEVICES` written after CUDA was touched in the same
    scope (source order; nested defs apart)."""
    out = []

    def env_key(sub: ast.AST) -> bool:
        return isinstance(sub, ast.Subscript) \
            and isinstance(sub.value, ast.Attribute) \
            and sub.value.attr == "environ" \
            and isinstance(sub.slice, ast.Constant) \
            and sub.slice.value == "CUDA_VISIBLE_DEVICES"

    for qual, node, body in _iter_scopes(tree):
        first_touch = 0
        writes = []
        for n in (m for stmt in body for m in _subtree_nodes(stmt)):
            if isinstance(n, ast.Call):
                if _cuda_touch(n):
                    first_touch = min(first_touch or n.lineno, n.lineno)
                name = _call_name(n)
                arg = n.args[0] if n.args else None
                if (name.endswith("environ.setdefault")
                        or name.endswith("putenv")) \
                        and isinstance(arg, ast.Constant) \
                        and arg.value == "CUDA_VISIBLE_DEVICES":
                    writes.append(n.lineno)
            elif isinstance(n, ast.Assign) and any(env_key(t)
                                                   for t in n.targets):
                writes.append(n.lineno)
        for hit in sorted(writes):
            if not first_touch or hit <= first_touch:
                continue
            if _suppressed("env-platform-write", lines, hit, hit):
                continue
            out.append(Finding(
                rule="ast/env-platform-write", path=relpath, line=hit,
                context=qual,
                message="CUDA_VISIBLE_DEVICES written after torch.cuda "
                        "was touched (line %d): CUDA read it at its "
                        "initialisation, so this write changes nothing in "
                        "this process — set it before the first CUDA call "
                        "or in the child's environment" % first_touch))
    return out


def rule_raw_artifact_write(tree, lines, relpath) -> List[Finding]:
    if relpath in RAW_WRITE_ALLOW:
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        if isinstance(node, ast.ClassDef):
            continue
        for call in _scope_calls(body):
            if _call_name(call) != "open":
                continue
            mode = None
            if len(call.args) >= 2 and isinstance(call.args[1],
                                                  ast.Constant):
                mode = call.args[1].value
            for kw in call.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if not (isinstance(mode, str) and "w" in mode):
                continue
            if _suppressed("raw-artifact-write", lines, call.lineno,
                           getattr(call, "end_lineno", call.lineno)):
                continue
            out.append(Finding(
                rule="ast/raw-artifact-write", path=relpath,
                line=call.lineno, context=qual,
                message="raw open(..., %r) write: a kill mid-write leaves "
                        "a truncated file where a complete one stood — "
                        "use utils.save_json / atomic_write_bytes "
                        "(tmp + os.replace)" % mode))
    return out


def rule_device_get_in_loop(tree, lines, relpath) -> List[Finding]:
    if relpath in DEVICE_GET_LOOP_ALLOW:
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        stack: List[ast.AST] = list(body)
        loops: List[ast.AST] = []
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(n, (ast.For, ast.While)):
                loops.append(n)
            stack.extend(ast.iter_child_nodes(n))
        for loop in loops:
            for call in _scope_calls(loop.body):
                if not _is_fetch(call):
                    continue
                if _suppressed("device-get-in-loop", lines, call.lineno,
                               getattr(call, "end_lineno", call.lineno)):
                    continue
                out.append(Finding(
                    rule="ast/device-get-in-loop", path=relpath,
                    line=call.lineno, context=qual,
                    message="%s inside a loop: a host<->device sync "
                            "every iteration stalls the launch queue — "
                            "keep the values on the card and fetch them "
                            "once (a deferred flush) or pipeline the "
                            "fetch" % _call_name(call)))
    return out


def rule_missing_ref_citation(tree, lines, relpath) -> List[Finding]:
    if os.path.basename(relpath) == "__init__.py":
        return []  # namespace modules: the citation lives in the members
    doc = ast.get_docstring(tree) or ""
    if any(p.search(doc) for p in _REF_PATTERNS):
        return []
    if _suppressed("missing-ref-citation", lines, 1,
                   min(len(lines), 3)):
        return []
    return [Finding(
        rule="ast/missing-ref-citation", path=relpath, line=1,
        context="module",
        message="public module docstring has no reference citation: add "
                "`ref <file:line>` (the function it ports) or state the "
                "reference has no analogue (the repo's convention)")]


def _acquires_backend(tree: ast.Module) -> bool:
    """Does this module use the card (a chip-path script)?"""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and (_cuda_touch(node) or _call_name(
                node).split(".")[-1] == "resolve_device"):
            return True
    return False


def rule_raw_span_timing(tree, lines, relpath) -> List[Finding]:
    """`time.X() - <start>` span arithmetic in a chip-path script: route
    it through obs.spans.SpanTracer. Scope mirrors
    queue-bypass — scripts/ + the root chip scripts — narrowed to modules
    that actually acquire a backend; the flight recorder is about chip
    evidence, not generic CLI stopwatches."""
    if relpath not in CHIP_SCRIPTS:
        return []
    if not _acquires_backend(tree):
        return []
    if relpath in RAW_SPAN_ALLOW:
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(n))
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)):
                continue
            left = n.left
            if not isinstance(left, ast.Call):
                continue
            name = _call_name(left)
            if not (name.startswith("time.")
                    and name.split(".")[-1] in _TIMING_FNS):
                continue
            if _suppressed("raw-span-timing", lines, n.lineno,
                           getattr(n, "end_lineno", n.lineno)):
                continue
            out.append(Finding(
                rule="ast/raw-span-timing", path=relpath, line=n.lineno,
                context=qual,
                message="hand-rolled span timing (time.%s() - start) in a "
                        "chip-path script is invisible to the flight "
                        "recorder — use obs.spans.SpanTracer.span(...) "
                        "(sp.dur_s carries the value; the record lands in "
                        "the round's span log)" % name.split(".")[-1]))
    return out


def rule_device_get_in_serving_loop(tree, lines, relpath) -> List[Finding]:
    """Per-request fetches in serving hot loops. Scope
    is the serving package; the engine's single batched fetch point is
    allowlisted (SERVING_FETCH_ALLOW) — anything else that fetches inside
    a loop is syncing per request and defeats the pipeline."""
    if not relpath.startswith(SERVING_PREFIX):
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        if "%s::%s" % (relpath, qual) in SERVING_FETCH_ALLOW:
            continue
        stack: List[ast.AST] = list(body)
        loops: List[ast.AST] = []
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(n, (ast.For, ast.While)):
                loops.append(n)
            stack.extend(ast.iter_child_nodes(n))
        for loop in loops:
            for call in _scope_calls(loop.body):
                if not _is_fetch(call):
                    continue
                if _suppressed("device-get-in-serving-loop", lines,
                               call.lineno,
                               getattr(call, "end_lineno", call.lineno)):
                    continue
                out.append(Finding(
                    rule="ast/device-get-in-serving-loop", path=relpath,
                    line=call.lineno, context=qual,
                    message="host fetch inside a serving loop outside "
                            "the engine's batched fetch point: a "
                            "per-request sync serializes the pipeline — "
                            "return futures and let "
                            "ServingEngine._fetch_loop's per-batch D2H "
                            "complete them"))
    return out


def rule_context_free_span(tree, lines, relpath) -> List[Finding]:
    """Trace-context hygiene in the serving package: a
    tracer span/record/event call whose name literal is a request-path
    span (`serve:*`/`fleet:*`/`recover:*`) must carry `ctx=` (its
    request's TraceContext) or `links=` (a batch's fan-in edges) —
    module-scope/process-lifecycle spans (TRACE_LIFECYCLE_SPANS) are
    exempt. Scope: serving/ modules, where every such record belongs to
    an acknowledged request whose causal chain the fleet acceptance
    gates reassemble."""
    if not relpath.startswith(SERVING_PREFIX):
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        for call in _scope_calls(body):
            name = _call_name(call)
            parts = name.split(".")
            if parts[-1] not in _TRACER_EMIT_FNS or len(parts) < 2 \
                    or "tracer" not in parts[-2].lower():
                continue
            first = call.args[0] if call.args else None
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith(_TRACED_SPAN_PREFIXES)):
                continue
            if first.value in TRACE_LIFECYCLE_SPANS:
                continue
            if any(kw.arg in ("ctx", "links") for kw in call.keywords):
                continue
            if _suppressed("context-free-span", lines, call.lineno,
                           getattr(call, "end_lineno", call.lineno)):
                continue
            out.append(Finding(
                rule="ast/context-free-span", path=relpath,
                line=call.lineno, context=qual,
                message="request-path span %r emitted without a trace "
                        "context (ctx=) or fan-in links (links=): the "
                        "record is invisible to the waterfall assembler "
                        "and the request's causal chain silently loses "
                        "this stage — thread the request's TraceContext "
                        "through (obs/trace.py), or add the name to "
                        "TRACE_LIFECYCLE_SPANS if it is genuinely "
                        "process-lifecycle" % first.value))
    return out


def _references_name(tree: ast.Module, name: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == name:
            return True
        if isinstance(node, ast.Attribute) and node.attr == name:
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)) \
                and any(a.name == name for a in node.names):
            return True
    return False


def _references_fleet_router(tree: ast.Module) -> bool:
    return _references_name(tree, "FleetRouter")


def rule_engine_bypass_in_fleet(tree, lines, relpath) -> List[Finding]:
    """Raw ServingEngine use inside fleet/router code paths:
    constructing an engine directly, or submitting to a
    replica's engine (`<x>.engine.submit/predict_many`), skips
    FleetRouter dispatch — per-tenant budgets, SLO penalty boxes, canary
    traffic splits and the re-dispatch ack guarantee all silently stop
    applying to that traffic. Scope: serving/ modules named like fleet
    code, plus any module referencing FleetRouter; the sanctioned
    construction/dispatch scopes and single-engine surfaces are
    allowlisted (FLEET_ENGINE_ALLOW)."""
    base = os.path.basename(relpath)
    fleet_file = relpath.startswith(SERVING_PREFIX) \
        and any(m in base for m in FLEET_FILE_MARKERS)
    if not fleet_file and not _references_fleet_router(tree):
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        if "%s::%s" % (relpath, qual) in FLEET_ENGINE_ALLOW:
            continue
        for call in _scope_calls(body):
            name = _call_name(call)
            parts = name.split(".")
            hit = None
            if parts[-1] == "ServingEngine":
                hit = "raw ServingEngine construction"
            elif len(parts) >= 2 and parts[-2] == "engine" \
                    and parts[-1] in ("submit", "predict_many"):
                hit = "direct replica-engine %s()" % parts[-1]
            if hit is None:
                continue
            if _suppressed("engine-bypass-in-fleet", lines, call.lineno,
                           getattr(call, "end_lineno", call.lineno)):
                continue
            out.append(Finding(
                rule="ast/engine-bypass-in-fleet", path=relpath,
                line=call.lineno, context=qual,
                message="%s in a fleet/router code path bypasses "
                        "FleetRouter dispatch — tenant budgets, SLO "
                        "penalty boxes, the canary split and the "
                        "re-dispatch ack guarantee stop applying; go "
                        "through router.submit (or the allowlisted "
                        "factory/dispatch scopes)" % hit))
    return out


_THRESHOLD_KWARGS = {"threshold", "cascade_threshold", "stream_threshold",
                     "skip_threshold"}
_THRESHOLD_REFS = ("FleetRouter", "StreamSession")
_THRESHOLD_FILES = {PKG + "serving/runs.py"}


def _numeric_literal(node) -> bool:
    """A bare numeric constant (possibly signed) — the hand-picked shape.
    None, names, attribute reads and computed expressions all pass: the
    sanctioned flows (cfg fields, calibrated-artifact lookups, values
    derived from the data in hand) are never literals."""
    if isinstance(node, ast.UnaryOp) \
            and isinstance(node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    return isinstance(node, ast.Constant) \
        and isinstance(node.value, (int, float)) \
        and not isinstance(node.value, bool)


def rule_hand_picked_threshold(tree, lines, relpath) -> List[Finding]:
    """A numeric-literal confidence/skip threshold reaching the serving
    plane: the cascade escalation threshold and the
    stream tile-skip threshold are CALIBRATED ARTIFACTS
    (`quality_matrix --cascade/--streams` -> `config.cascade_overrides()`
    / `stream_overrides()`), never constants — a hand-picked value either
    over-escalates (goodput collapses to all-quality) or under-escalates
    (blended mAP silently decays), and nothing re-checks it when the
    model or data drifts. Scope: serving/ modules, serving/runs.py,
    and any module referencing FleetRouter/StreamSession. Two signatures:
    (a) a threshold-named kwarg bound to a numeric literal at any call
    site, (b) an argparse `--*threshold` option with a numeric default
    (None + explicit resolution is the sanctioned CLI shape)."""
    in_scope = relpath.startswith(SERVING_PREFIX) \
        or relpath in _THRESHOLD_FILES \
        or any(_references_name(tree, n) for n in _THRESHOLD_REFS)
    if not in_scope:
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        for call in _scope_calls(body):
            leaf = _call_name(call).split(".")[-1]
            hits = []
            if leaf == "add_argument":
                opt = next((a.value for a in call.args
                            if isinstance(a, ast.Constant)
                            and isinstance(a.value, str)
                            and "threshold" in a.value), None)
                if opt is not None:
                    hits += ["argparse option %s with a numeric default"
                             % opt
                             for kw in call.keywords
                             if kw.arg == "default"
                             and _numeric_literal(kw.value)]
            else:
                hits += ["%s=<literal> at a call site" % kw.arg
                         for kw in call.keywords
                         if kw.arg in _THRESHOLD_KWARGS
                         and _numeric_literal(kw.value)]
            for desc in hits:
                if _suppressed("hand-picked-threshold", lines,
                               call.lineno,
                               getattr(call, "end_lineno", call.lineno)):
                    continue
                out.append(Finding(
                    rule="ast/hand-picked-threshold", path=relpath,
                    line=call.lineno, context=qual,
                    message="hand-picked threshold (%s): confidence/skip "
                            "thresholds are calibrated artifacts — "
                            "resolve via config.cascade_overrides()/"
                            "stream_overrides() (or derive from the data "
                            "in hand), never a constant" % desc))
    return out


_STAT_FNS = {"percentile", "quantile", "quantiles", "median"}


def rule_raw_metric_aggregation(tree, lines, relpath) -> List[Finding]:
    """Hand-rolled percentile/median arithmetic in a chip-path script
   : scope mirrors raw-span-timing — scripts/ + the
    root chip scripts, narrowed to modules that acquire a backend. Two
    signatures: (a) a call whose leaf name is a statistics function
    (np.percentile/median/statistics.quantiles/...), (b) the
    nearest-rank idiom — `round(q * (len(s) - 1))`-style rank
    arithmetic, or indexing directly into a `sorted(...)` call with a
    computed index. Both should be `obs.metrics.Histogram` digests."""
    if relpath not in CHIP_SCRIPTS:
        return []
    if not _acquires_backend(tree):
        return []

    def contains_len_call(node) -> bool:
        return any(isinstance(n, ast.Call) and _call_name(n) == "len"
                   for n in ast.walk(node))

    if relpath in METRIC_AGG_ALLOW:
        return []
    out = []
    for qual, node, body in _iter_scopes(tree):
        for call in _scope_calls(body):
            name = _call_name(call)
            leaf = name.split(".")[-1]
            root_mod = name.split(".")[0]
            hit = None
            # stat-library calls only (np.percentile, statistics.median,
            # a bare percentile): `Histogram.quantile()` IS the sanctioned
            # digest and must not flag itself
            if leaf in _STAT_FNS and (name == leaf or root_mod in
                                      ("np", "numpy", "statistics",
                                       "scipy")):
                hit = "%s()" % name
            elif leaf == "round" and any(
                    isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
                    and contains_len_call(n)
                    for a in call.args for n in ast.walk(a)):
                hit = "rank arithmetic (round(q * (len(..) - 1)))"
            if hit is None:
                continue
            if _suppressed("raw-metric-aggregation", lines, call.lineno,
                           getattr(call, "end_lineno", call.lineno)):
                continue
            out.append(Finding(
                rule="ast/raw-metric-aggregation", path=relpath,
                line=call.lineno, context=qual,
                message="hand-rolled metric aggregation (%s) in a "
                        "chip-path script: ad-hoc percentiles neither "
                        "merge nor export — observe into an obs.metrics "
                        "Histogram and read quantile()/digest() (the SLO "
                        "watchdog and perfgate consume those snapshots)"
                        % hit))
        # the sorted-then-index idiom outside calls (s = sorted(v);
        # s[int(...)] on the sorted() call directly)
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(n))
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Call) \
                    and _call_name(n.value) == "sorted" \
                    and not isinstance(n.slice, ast.Constant) \
                    and not (isinstance(n.slice, ast.UnaryOp)
                             and isinstance(n.slice.operand, ast.Constant)):
                if _suppressed("raw-metric-aggregation", lines, n.lineno,
                               getattr(n, "end_lineno", n.lineno)):
                    continue
                out.append(Finding(
                    rule="ast/raw-metric-aggregation", path=relpath,
                    line=n.lineno, context=qual,
                    message="computed index into sorted(...) (the "
                            "nearest-rank percentile idiom) in a "
                            "chip-path script — observe into an "
                            "obs.metrics Histogram instead"))
    return out


# multi-process rendezvous markers + the sanctioned barrier helpers
_MULTIPROC_INIT = ("init_process_group", "init_distributed")
_BARRIER_NAMES = {"barrier_synced_build", "barrier_synced_compile",
                  "coordination_barrier", "wait_at_barrier"}
# the port's counterpart of the AOT compile: building a kernel library
_BUILD_LEAVES = {"build_ops", "build_library", "load_library"}


def rule_unbarriered_collective_start(tree, lines, relpath) -> List[Finding]:
    """Build-or-compile without a barrier in a multi-process entry
    point: the first-collective deadline as a mechanical check. Scope is
    any module that initializes a process group; the finding lands on
    the first kernel-library build or `.compile()` call when no barrier
    helper is referenced anywhere in the module."""
    init_line = 0
    barriered = False
    compile_line = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            leaf = name.split(".")[-1]
            if name.endswith("distributed.initialize") \
                    or leaf in _MULTIPROC_INIT:
                init_line = init_line or node.lineno
            # the AOT idiom specifically — `<jitted>.lower(...).compile()`
            # — so `re.compile(...)` and friends never match
            if leaf == "compile" and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Call) \
                    and _call_name(node.func.value).split(".")[-1] \
                    == "lower":
                compile_line = compile_line or node.lineno
            if leaf in _BUILD_LEAVES or name.startswith("_build."):
                compile_line = compile_line or node.lineno
        if isinstance(node, ast.Name) and node.id in _BARRIER_NAMES:
            barriered = True
        if isinstance(node, ast.Attribute) and node.attr in _BARRIER_NAMES:
            barriered = True
    if not (init_line and compile_line) or barriered:
        return []
    if _suppressed("unbarriered-collective-start", lines, compile_line,
                   compile_line):
        return []
    return [Finding(
        rule="ast/unbarriered-collective-start", path=relpath,
        line=compile_line, context="module",
        message="multi-process entry point builds or compiles "
                "without a barrier: a rank that builds the kernel "
                "libraries late reaches the first collective after the "
                "others' deadline — use parallel.barrier_synced_build "
                "(build -> barrier -> first collective)")]


def _subtree_nodes(root) -> Iterable[ast.AST]:
    """Every node under `root` (inclusive), NOT descending into nested
    function/class defs — loop analysis must not be confused by a
    closure's control flow."""
    stack: List[ast.AST] = [root]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


def rule_unbounded_retry(tree, lines, relpath) -> List[Finding]:
    """`while True` + an except handler that swallows and loops again +
    no cap, no backoff, no queue-consume (see the module docstring)."""
    out = []
    for qual, node, body in _iter_scopes(tree):
        loops = [n for stmt in body for n in _subtree_nodes(stmt)
                 if isinstance(n, ast.While)]
        for loop in loops:
            test = loop.test
            if not (isinstance(test, ast.Constant) and test.value is True):
                continue
            nodes = [n for stmt in loop.body for n in _subtree_nodes(stmt)]
            # a backoff or a blocking queue-consume anywhere in the loop
            # legitimizes it (bounded-in-time, or a consumer loop)
            slept = consumes = False
            for n in nodes:
                if isinstance(n, ast.Call):
                    name = _call_name(n)
                    leaf = name.split(".")[-1]
                    if leaf == "sleep" or "backoff" in leaf:
                        slept = True
                    if leaf == "get" and "." in name:
                        consumes = True
            if slept or consumes:
                continue
            for n in nodes:
                if not isinstance(n, ast.ExceptHandler):
                    continue
                handler_nodes = [m for stmt in n.body
                                 for m in _subtree_nodes(stmt)]
                if any(isinstance(m, (ast.Raise, ast.Return, ast.Break))
                       for m in handler_nodes):
                    continue  # the handler exits the loop: bounded
                if _suppressed("unbounded-retry", lines, n.lineno,
                               getattr(n, "end_lineno", n.lineno)):
                    continue
                out.append(Finding(
                    rule="ast/unbounded-retry", path=relpath,
                    line=n.lineno, context=qual,
                    message="while-True retry loop swallows the exception "
                            "and loops again with no attempt cap and no "
                            "backoff — "
                            "bound it (for attempt in range(N)) and/or "
                            "back off (time.sleep) before re-attempting"))
                break  # one finding per loop
    return out


RULES = (rule_per_call_timing, rule_env_platform_write,
         rule_raw_artifact_write, rule_device_get_in_loop,
         rule_missing_ref_citation, rule_raw_span_timing,
         rule_device_get_in_serving_loop, rule_unbounded_retry,
         rule_raw_metric_aggregation, rule_unbarriered_collective_start,
         rule_engine_bypass_in_fleet, rule_context_free_span,
         rule_hand_picked_threshold)


# ---------------------------------------------------------------------------
# entry functions


def lint_source(src: str, relpath: str,
                rules=RULES) -> List[Finding]:
    """Run `rules` over one file's source. Unparseable source is itself a
    finding (a syntax error in prod code must not pass silently)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule="ast/syntax-error", path=relpath,
                        line=e.lineno or 0, context="module",
                        message="unparseable: %s" % e.msg)]
    lines = src.splitlines()
    out: List[Finding] = []
    for rule in rules:
        out.extend(rule(tree, lines, relpath))
    return out


def repo_files(root: str) -> List[str]:
    """Repo-relative .py files of the port in lint scope: the package
    (tests, build outputs, artifacts excluded) and the root scripts of
    `ROOT_FILES` that exist."""
    out = [f for f in ROOT_FILES if os.path.isfile(os.path.join(root, f))]
    pkg_root = os.path.join(root, PKG.rstrip("/"))
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames if d not in EXCLUDE_DIRS)
        rel = os.path.relpath(dirpath, root).replace(os.sep, "/")
        out += [rel + "/" + f for f in sorted(filenames)
                if f.endswith(".py")]
    return sorted(out)


def lint_repo(root: str, rules=RULES) -> List[Finding]:
    out: List[Finding] = []
    for rel in repo_files(root):
        with open(os.path.join(root, rel)) as f:
            src = f.read()
        out.extend(lint_source(src, rel, rules))
    return out
