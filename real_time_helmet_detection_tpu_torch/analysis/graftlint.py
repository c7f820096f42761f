"""graftlint for the port: the convention lint, the lock audit, the
export-graph audit and the transfer audit, in one command.

Port of ref scripts/graftlint.py:116 (`run_lint`, :1061 `selfcheck`,
:1085 `main`), over the port's own layers
(`real_time_helmet_detection_tpu_torch/analysis/`):

* AST rules (`ast_rules.py`, stdlib only) — always run;
* the lock audit (`lock_audit.py`, stdlib only) and its dynamic twin
  (`interleave.py`, exercised by `--selfcheck`) — always run;
* the export-graph audit (`trace_audit.py`: `torch.export` of every
  public entry point at tiny CPU shapes, and one real CPU step of each
  train configuration) — skipped by `--ast-only` and `--changed`;
* the transfer audit (`transfer_audit.py`: each registered entry's
  host<->device surface against `transfer_manifest.json`) — skipped by
  `--ast-only`; in `--changed` mode only the entries whose modules
  changed.

Usage:

    python -m real_time_helmet_detection_tpu_torch.analysis.graftlint
    ... --ast-only            # AST + lock layers only
    ... --changed HEAD        # AST + lock over the files changed vs a ref
                              # (+ the transfer gate of touched entries)
    ... --format github       # ::error annotations before the JSON line
    ... --write-baseline      # rewrite baseline.json (keep it empty)
    ... --write-manifest      # adopt the measured transfer surfaces
    ... --selfcheck [--ast-only]  # every rule fires on a seeded fixture
                              # and stays silent on its fixed form

It runs on the CPU: every layer builds its programs with `device="cpu"`
and touches no card. Findings detail goes to stderr; the last line of
stdout is one JSON object. Exit 0: clean against the baseline (or the
selfcheck passed); 1: new findings (or a selfcheck failure).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import diff_baseline, load_baseline, write_baseline
from . import ast_rules, interleave, lock_audit

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(msg: str) -> None:
    print("[graftlint] %s" % msg, file=sys.stderr, flush=True)


def changed_files(ref: str):
    """The port's .py files changed vs `ref` (staged and unstaged), in
    lint scope."""
    import subprocess
    r = subprocess.run(["git", "diff", "--name-only", "-z", ref, "--"],
                       capture_output=True, text=True, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit("graftlint --changed: git diff vs %r failed: %s"
                         % (ref, r.stderr.strip()[:200]))
    changed = {p for p in r.stdout.split("\0") if p.endswith(".py")}
    return sorted(changed & set(ast_rules.repo_files(REPO)))


def github_annotations(findings) -> list:
    return ["::error file=%s,line=%d,title=%s::%s"
            % (f.path, max(1, f.line), f.rule,
               f.message.replace("\n", " "))
            for f in findings]


def run_lint(args) -> int:
    t0 = time.time()
    only = None
    if args.changed:
        only = changed_files(args.changed)
        log("changed mode vs %s: %d file(s) in scope"
            % (args.changed, len(only)))
        findings = []
        for rel in only:
            with open(os.path.join(REPO, rel)) as f:
                findings += ast_rules.lint_source(f.read(), rel)
    else:
        findings = ast_rules.lint_repo(REPO)
    log("ast layer: %d finding(s) over %d file(s)"
        % (len(findings), len(only if only is not None
                              else ast_rules.repo_files(REPO))))
    # the lock-order graph is always global: an edge added in a changed
    # file can close a cycle through an untouched one
    lfind = lock_audit.audit_repo(REPO, only=only)
    log("lock layer: %d finding(s)" % len(lfind))
    findings += lfind
    trace_ran = False
    if not args.ast_only and not args.changed:
        from . import trace_audit
        tfind = trace_audit.audit_repo_entry_points()
        log("trace layer: %d finding(s)" % len(tfind))
        findings += tfind
        trace_ran = True
    xfer_entries = 0
    if not args.ast_only:
        from . import transfer_audit
        xonly = None
        if args.changed:
            xonly = transfer_audit.entries_for_changed(only)
        if xonly is None or xonly:
            xres = transfer_audit.audit_transfers(only=xonly)
            xfer_entries = len(xres["measured"])
            log("xfer layer: %d entry point(s), %d finding(s)"
                % (xfer_entries, len(xres["findings"])))
            for line in xres["improved"]:
                log("xfer IMPROVED %s (adopt with --write-manifest)" % line)
            for k in xres["stale"]:
                log("xfer stale manifest entry: %s" % k)
            findings += xres["findings"]
            if args.write_manifest:
                path = transfer_audit.write_manifest(xres["measured"])
                log("transfer manifest rewritten -> %s (%d entries)"
                    % (path, xfer_entries))
                findings = [f for f in findings
                            if not f.rule.startswith("xfer/")]
                findings += transfer_audit.gate_manifest(
                    xres["measured"],
                    transfer_audit.load_manifest())["findings"]
        else:
            log("xfer layer: no changed entry-point module")
    elif args.write_manifest:
        raise SystemExit("graftlint --write-manifest needs the transfer "
                         "layer (drop --ast-only)")
    if args.write_baseline:
        path = write_baseline(findings, reasons=load_baseline())
        log("baseline rewritten -> %s (%d entries)" % (path, len(findings)))
    baseline = load_baseline()
    d = diff_baseline(findings, baseline)
    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    for f in d["new"]:
        log("NEW %s %s:%d [%s] %s"
            % (f.rule, f.path, f.line, f.context, f.message))
    for k in d["stale"]:
        log("stale baseline entry (fixed — drop it): %s" % k)
    ok = not d["new"]
    if args.format == "github":
        for ln in github_annotations(d["new"]):
            print(ln)
    print(json.dumps({
        "tool": "graftlint", "package": "real_time_helmet_detection_tpu_"
        "torch", "ok": ok, "findings": len(findings), "new": len(d["new"]),
        "baselined": len(d["baselined"]), "stale_baseline": len(d["stale"]),
        "by_rule": by_rule, "trace_layer": trace_ran,
        "xfer_entries": xfer_entries, "changed": args.changed or None,
        "elapsed_s": round(time.time() - t0, 1),
        "new_keys": sorted(f.key for f in d["new"])[:20]}))
    sys.stdout.flush()
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# selfcheck: every rule fires on its seeded bad fixture and stays silent
# on the fixed twin. Fixtures are strings: they are never imported.

PKG = ast_rules.PKG
# a chip-path script under serving/: every path-scoped rule applies
FIXTURE_PATH = PKG + "serving/runs.py"
PLAIN_PATH = PKG + "fixture.py"

AST_FIXTURES = {
    # rule-short-name: (bad source, good source)
    "per-call-timing": (
        "import time, torch\n"
        "def f(runner):\n"
        "    t0 = time.perf_counter()\n"
        "    runner.replay()\n"
        "    return time.perf_counter() - t0\n",
        "import time, torch\n"
        "def f(runner):\n"
        "    t0 = time.perf_counter()\n"
        "    runner.replay()\n"
        "    torch.cuda.synchronize()\n"
        "    return time.perf_counter() - t0\n"),
    "env-platform-write": (
        "import os, torch\n"
        "def pick(i):\n"
        "    n = torch.cuda.device_count()\n"
        "    os.environ['CUDA_VISIBLE_DEVICES'] = str(i % n)\n",
        "import os, torch\n"
        "def pick(i):\n"
        "    os.environ['CUDA_VISIBLE_DEVICES'] = str(i)\n"
        "    return torch.cuda.device_count()\n"),
    "raw-artifact-write": (
        "import json\n"
        "def dump(path, obj):\n"
        "    with open(path, 'w') as f:\n"
        "        json.dump(obj, f)\n",
        "from real_time_helmet_detection_tpu_torch.utils import save_json\n"
        "def dump(path, obj):\n"
        "    save_json(path, obj)\n"
        "def read(path):\n"
        "    with open(path) as f:\n"
        "        return f.read()\n"),
    "device-get-in-loop": (
        "def run(step, batches):\n"
        "    out = []\n"
        "    for b in batches:\n"
        "        out.append(step(b)['total'].item())\n"
        "    return out\n",
        "import torch\n"
        "def run(step, batches):\n"
        "    out = [step(b)['total'] for b in batches]\n"
        "    return torch.stack(out).cpu().tolist()\n"),
    "missing-ref-citation": (
        '"""A module with no provenance statement."""\nX = 1\n',
        '"""A module citing ref evaluate.py:15."""\nX = 1\n'),
    "raw-span-timing": (
        "import time, torch\n"
        "torch.cuda.init()\n"
        "def bench(fn):\n"
        "    t0 = time.perf_counter()\n"
        "    fn()\n"
        "    return time.perf_counter() - t0\n",
        "import torch\n"
        "from real_time_helmet_detection_tpu_torch.obs.spans import "
        "SpanTracer\n"
        "torch.cuda.init()\n"
        "def bench(fn):\n"
        "    with SpanTracer(None).span('bench') as sp:\n"
        "        fn()\n"
        "    return sp.dur_s\n"),
    "raw-metric-aggregation": (
        "import numpy as np, torch\n"
        "torch.cuda.init()\n"
        "def digest(lats):\n"
        "    return float(np.percentile(lats, 99))\n",
        "import torch\n"
        "from real_time_helmet_detection_tpu_torch.obs.metrics import "
        "Histogram\n"
        "torch.cuda.init()\n"
        "def digest(lats):\n"
        "    h = Histogram('lat_ms')\n"
        "    for v in lats:\n"
        "        h.observe(v)\n"
        "    return h.quantile(0.99)\n"),
    "unbarriered-collective-start": (
        "from real_time_helmet_detection_tpu_torch.parallel import "
        "init_distributed\n"
        "from real_time_helmet_detection_tpu_torch.ops import _build\n"
        "def main(cfg):\n"
        "    dev = init_distributed(cfg)\n"
        "    _build.build_ops()\n"
        "    return dev\n",
        "from real_time_helmet_detection_tpu_torch.parallel import (\n"
        "    barrier_synced_build, init_distributed)\n"
        "def main(cfg):\n"
        "    dev = init_distributed(cfg)\n"
        "    barrier_synced_build(dev)\n"
        "    return dev\n"),
    "unbounded-retry": (
        "import torch\n"
        "def wait():\n"
        "    while True:\n"
        "        try:\n"
        "            return torch.cuda.init()\n"
        "        except Exception:\n"
        "            continue\n",
        "import time, torch\n"
        "def wait():\n"
        "    for attempt in range(5):\n"
        "        try:\n"
        "            return torch.cuda.init()\n"
        "        except Exception:\n"
        "            time.sleep(2.0 * (attempt + 1))\n"
        "    raise RuntimeError('never came up')\n"),
    "device-get-in-serving-loop": (
        "def fetch_all(requests, body):\n"
        "    out = []\n"
        "    for r in requests:\n"
        "        out.append(body(r).cpu())\n"
        "    return out\n",
        "import torch\n"
        "def fetch_all(requests, body):\n"
        "    pending = [body(r) for r in requests]\n"
        "    return torch.stack(pending).cpu()\n"),
    "context-free-span": (
        "def shed(tracer, req):\n"
        "    tracer.event('serve:shed', reason='deadline')\n",
        "def shed(tracer, req, links):\n"
        "    tracer.event('serve:shed', ctx=req.ctx, reason='deadline')\n"
        "    with tracer.span('serve:d2h', b=2, links=links):\n"
        "        pass\n"
        "    tracer.event('serve:state', **{'from': 'a', 'to': 'b'})\n"),
    "hand-picked-threshold": (
        "def route(router, img):\n"
        "    return router.submit(img, tenant='cam',\n"
        "                         cascade_threshold=0.25)\n",
        "def route(router, img, cfg):\n"
        "    th = cfg.cascade_overrides()['threshold']\n"
        "    return router.submit(img, tenant='cam',\n"
        "                         cascade_threshold=th)\n"),
}
FLEET_FIXTURES = {
    "engine-bypass-in-fleet": (
        "def route(predict, replicas, image):\n"
        "    spare = ServingEngine(predict, None, (64, 64, 3), 'uint8')\n"
        "    return replicas[0].engine.submit(image)\n",
        "def route(router, image):\n"
        "    return router.submit(image, tenant='bulk')\n"
        "def spawn(factory, rid):\n"
        "    return factory(rid, True)\n"),
}

LOCK_FIXTURES = {
    "unguarded-shared-write": (
        "import threading\n"
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._state = 'serving'\n"
        "    def set_state(self, s):\n"
        "        with self._lock:\n"
        "            self._state = s\n"
        "    def state(self):\n"
        "        return self._state\n",
        "import threading\n"
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._state = 'serving'\n"
        "    def set_state(self, s):\n"
        "        with self._lock:\n"
        "            self._state = s\n"
        "    def state(self):\n"
        "        with self._lock:\n"
        "            return self._state\n"),
    "order-cycle": (
        "import threading\n"
        "class X:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def m1(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def m2(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n",
        "import threading\n"
        "class X:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def m1(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def m2(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"),
    "blocking-call-under-lock": (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.out = None\n"
        "    def flush(self, dev):\n"
        "        with self._lock:\n"
        "            self.out = dev.cpu()\n",
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.out = None\n"
        "    def flush(self, dev):\n"
        "        host = dev.cpu()\n"
        "        with self._lock:\n"
        "            self.out = host\n"),
    "callback-under-lock": (
        "import threading\n"
        "class F:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cb = None\n"
        "    def set_cb(self, fn):\n"
        "        with self._lock:\n"
        "            self._cb = fn\n"
        "    def fire(self):\n"
        "        with self._lock:\n"
        "            cb = self._cb\n"
        "            cb(self)\n",
        "import threading\n"
        "class F:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cb = None\n"
        "    def set_cb(self, fn):\n"
        "        with self._lock:\n"
        "            self._cb = fn\n"
        "    def fire(self):\n"
        "        with self._lock:\n"
        "            cb = self._cb\n"
        "        cb(self)\n"),
}
# the card's syncs under a lock, one bad source each
LOCK_SYNC_FIXTURES = ("torch.cuda.synchronize()", "ev.synchronize()",
                      "dev.item()", "dev.tolist()", "dev.numpy()")


def _fires(findings, rule) -> bool:
    return any(f.rule == rule for f in findings)


def _selfcheck_ast(check) -> None:
    for short, (bad, good) in AST_FIXTURES.items():
        rule = "ast/" + short
        check("%s fires on bad fixture" % rule,
              _fires(ast_rules.lint_source(bad, FIXTURE_PATH), rule))
        check("%s silent on good fixture" % rule,
              not _fires(ast_rules.lint_source(good, FIXTURE_PATH), rule))
    for short in ("device-get-in-serving-loop", "context-free-span",
                  "hand-picked-threshold"):
        check("ast/%s scoped to serving/" % short,
              not _fires(ast_rules.lint_source(AST_FIXTURES[short][0],
                                               PLAIN_PATH), "ast/" + short))
    for short in ("raw-span-timing", "raw-metric-aggregation"):
        check("ast/%s scoped to chip scripts" % short,
              not _fires(ast_rules.lint_source(AST_FIXTURES[short][0],
                                               PLAIN_PATH), "ast/" + short))
    bad, good = FLEET_FIXTURES["engine-bypass-in-fleet"]
    rule = "ast/engine-bypass-in-fleet"
    fpath = PKG + "serving/fleet_fixture.py"
    check("%s fires on bad fixture" % rule,
          _fires(ast_rules.lint_source(bad, fpath), rule))
    check("%s silent on good fixture" % rule,
          not _fires(ast_rules.lint_source(good, fpath), rule))
    check("%s scoped to fleet code paths" % rule,
          not _fires(ast_rules.lint_source(bad, PLAIN_PATH), rule))
    check("%s follows FleetRouter references" % rule,
          _fires(ast_rules.lint_source(
              "from real_time_helmet_detection_tpu_torch.serving import "
              "FleetRouter\n" + bad, PLAIN_PATH), rule))
    check("ast/device-get-in-loop allows the train loop's module",
          not _fires(ast_rules.lint_source(
              AST_FIXTURES["device-get-in-loop"][0], PKG + "train.py"),
              "ast/device-get-in-loop"))
    sup = AST_FIXTURES["raw-artifact-write"][0].replace(
        "'w') as f:", "'w') as f:  # graftlint: off=raw-artifact-write")
    check("inline suppression honored",
          not _fires(ast_rules.lint_source(sup, FIXTURE_PATH),
                     "ast/raw-artifact-write"))
    check("a syntax error is a finding",
          _fires(ast_rules.lint_source("def broken(:\n", FIXTURE_PATH),
                 "ast/syntax-error"))


def _selfcheck_lock(check) -> None:
    spath = ast_rules.SERVING_PREFIX + "lock_fixture_%s.py"
    for short, (bad, good) in LOCK_FIXTURES.items():
        rule = "lock/" + short
        check("%s fires on bad fixture" % rule,
              _fires(lock_audit.audit_source(bad, spath % "bad"), rule))
        check("%s silent on good fixture" % rule,
              not _fires(lock_audit.audit_source(good, spath % "good"),
                         rule))
    bad = LOCK_FIXTURES["blocking-call-under-lock"][0]
    for call in LOCK_SYNC_FIXTURES:
        src = bad.replace("dev.cpu()", call)
        check("lock/blocking-call-under-lock fires on %s" % call,
              _fires(lock_audit.audit_source(src, spath % "sync"),
                     "lock/blocking-call-under-lock"))
    bad = LOCK_FIXTURES["unguarded-shared-write"][0]
    ann = bad.replace("    def state(self):",
                      "    def state(self):  # lock-free: a GIL-atomic "
                      "single-field read")
    check("lock-free annotation honored",
          not lock_audit.audit_source(ann, spath % "ann"))
    guarded = (
        "import threading\n"
        "class R:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._tenants = {}\n"
        "    def _tenant(self, name):  # guarded-by: _lock\n"
        "        self._tenants[name] = 1\n"
        "    def submit(self, name):\n"
        "        with self._lock:\n"
        "            self._tenant(name)\n")
    check("guarded-by annotation honored",
          not lock_audit.audit_source(guarded, spath % "gb"))
    sup = bad.replace("        return self._state",
                      "        return self._state  "
                      "# graftlint: off=unguarded-shared-write")
    check("lock layer honors graftlint: off=",
          not lock_audit.audit_source(sup, spath % "sup"))
    torn = interleave.find_torn_read(fixed=False)
    check("interleave reproduces the two-window torn read",
          torn is not None)
    check("single-window health() certified over the seed sweep",
          interleave.find_torn_read(fixed=True) is None)
    dl = interleave.find_deadlock(ordered=False)
    check("interleave drives the AB/BA cycle into a detected deadlock",
          dl is not None and len(dl["waiting"]) == 2)
    check("single-order twin never deadlocks over the seed sweep",
          interleave.find_deadlock(ordered=True) is None)


def _selfcheck_trace(check) -> None:
    import random

    import torch

    from . import trace_audit as ta

    def export(fn, x, **kw):
        class M(torch.nn.Module):
            def forward(self, x):
                return fn(x)
        return torch.export.export(M(), (x,), **kw)

    x = torch.randn(4, 8)

    def rules(ep):
        return {f.rule for f in ta.graph_findings(ep, "fixture")}

    check("trace/host-callback fires on boolean indexing",
          "trace/host-callback" in rules(export(lambda t: t[t > 0].sum(),
                                                x)))
    check("trace/host-callback silent on the masked form",
          "trace/host-callback" not in rules(export(
              lambda t: torch.where(t > 0, t, 0.0).sum(), x)))
    check("trace/f64 fires on a float64 cast",
          "trace/f64" in rules(export(lambda t: t.double().sum(), x)))
    check("trace/f64 silent on float32",
          "trace/f64" not in rules(export(lambda t: t.float().sum(), x)))
    dim = torch.export.Dim("b", min=2, max=64)
    check("trace/dynamic-shape fires on a symbolic batch",
          "trace/dynamic-shape" in rules(export(
              lambda t: t * 2.0, x, dynamic_shapes={"x": {0: dim}})))
    check("trace/dynamic-shape silent on fixed shapes",
          "trace/dynamic-shape" not in rules(export(lambda t: t * 2.0, x)))

    def broken():
        raise ValueError("no longer exports")

    found, _ = ta.audit_entry(broken, "fixture")
    check("trace/trace-failure on an entry that no longer exports",
          _fires(found, "trace/trace-failure"))
    found, _ = ta.audit_entry(
        lambda: export(lambda t: t + random.random(), x), "fixture")
    check("trace/retrace-unstable fires on an export-time constant",
          _fires(found, "trace/retrace-unstable"))
    found, _ = ta.audit_entry(lambda: export(lambda t: t + 0.5, x),
                              "fixture")
    check("trace/retrace-unstable silent on a fixed program", not found)
    p = torch.nn.Parameter(torch.ones(3))

    def rebind():
        p.data = p.data * 2.0

    check("trace/realloc sees a rebound parameter",
          ta.moved_storages(lambda: {"p": p}, rebind) == ["p"])
    check("trace/realloc silent on an in-place update",
          not ta.moved_storages(lambda: {"p": p},
                                lambda: p.data.mul_(2.0)))


def _selfcheck_xfer(check) -> None:
    import numpy as np
    import torch

    from . import transfer_audit as xa

    state = torch.zeros(100)
    batch = np.zeros((100,), np.float32)

    def entry(program):
        return xa.Entry(program, (batch,), (state,))

    m0 = xa.measure_entry(entry(lambda b: (b * 2.0,)))
    check("measure: one fetched leaf, one fresh input, one resident",
          m0["d2h"]["leaves"] == 1 and m0["d2h"]["bytes"] == 400
          and m0["h2d_fresh"]["leaves"] == 1
          and m0["resident"]["leaves"] == 1)
    manifest = {"schema": xa.SCHEMA, "entries": {"base": m0}}

    def gate(program, **kw):
        e = xa.Entry(program, kw.get("host", (batch,)),
                     kw.get("resident", (state,)))
        return {f.rule for f in xa.gate_manifest(
            {"base": xa.measure_entry(e)}, manifest)["findings"]}

    check("identical surface gates clean", not gate(lambda b: (b * 2.0,)))
    check("xfer/extra-fetch-leaf on a new output leaf",
          "xfer/extra-fetch-leaf" in gate(lambda b: (b * 2.0, b.sum())))
    check("xfer/undonated-input when resident state goes up per call",
          "xfer/undonated-input" in gate(
              lambda b, s: (b * 2.0 + s,),
              host=(batch, np.zeros((100,), np.float32)), resident=()))
    check("xfer/d2h-bytes-grew at +10%",
          "xfer/d2h-bytes-grew" in gate(
              lambda b: (torch.cat([b, b[:10]]) * 2.0,)))
    check("an in-tolerance wiggle (+1%) passes",
          not gate(lambda b: (torch.cat([b, b[:1]]) * 2.0,)))
    check("xfer/host-callback-grew on a host read",
          "xfer/host-callback-grew" in gate(
              lambda b: (b * float(b.sum().item()),)))
    check("xfer/unknown-entry on an unbudgeted entry",
          "xfer/unknown-entry" in {f.rule for f in xa.gate_manifest(
              {"new_surface": m0}, manifest)["findings"]})
    check("xfer/entry-unmeasurable on an entry that fails to build",
          "xfer/entry-unmeasurable" in {f.rule for f in xa.gate_manifest(
              {"base": {"error": "ValueError: boom"}},
              manifest)["findings"]})
    real = torch.Tensor.item
    with xa.counting_syncs() as c:
        torch.ones(3).sum().item()
        torch.ones(3).tolist()
        torch.ones(2).cpu().numpy()
    check("counting_syncs counts calls (.cpu then .numpy: two)",
          c.count == 4)
    check("counting_syncs restores the real methods",
          torch.Tensor.item is real)


def selfcheck(ast_only: bool = False) -> int:
    t0 = time.time()
    failures = []

    def check(name, cond):
        print("selfcheck %-60s %s" % (name, "ok" if cond else "FAIL"),
              file=sys.stderr, flush=True)
        if not cond:
            failures.append(name)

    _selfcheck_ast(check)
    _selfcheck_lock(check)
    if not ast_only:
        _selfcheck_trace(check)
        _selfcheck_xfer(check)
    ok = not failures
    print(json.dumps({"tool": "graftlint", "selfcheck": True, "ok": ok,
                      "failures": failures, "trace_layer": not ast_only,
                      "elapsed_s": round(time.time() - t0, 1)}))
    sys.stdout.flush()
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.analysis."
             "graftlint", description=__doc__.splitlines()[0])
    p.add_argument("--ast-only", action="store_true",
                   help="skip the export-graph and transfer layers")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite analysis/baseline.json from the current "
                        "findings")
    p.add_argument("--write-manifest", action="store_true",
                   help="adopt the measured transfer surfaces as the "
                        "committed analysis/transfer_manifest.json")
    p.add_argument("--selfcheck", action="store_true",
                   help="prove every rule fires on its seeded fixture "
                        "(with --ast-only: the AST and lock rules only)")
    p.add_argument("--changed", metavar="REF", default=None,
                   help="AST + lock layers over the files changed vs REF "
                        "(+ the transfer gate of the touched entries)")
    p.add_argument("--format", choices=("text", "github"), default="text",
                   help="'github': ::error annotations for new findings "
                        "before the JSON line")
    args = p.parse_args(argv)
    if args.selfcheck:
        return selfcheck(ast_only=args.ast_only)
    if args.changed and (args.write_baseline or args.write_manifest):
        p.error("--write-baseline and --write-manifest need the full run")
    return run_lint(args)


if __name__ == "__main__":
    raise SystemExit(main())
