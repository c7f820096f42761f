"""The port's graftlint (`real_time_helmet_detection_tpu_torch/analysis/`)
against the JAX package's, on the CPU.

* every rule the port shares with JAX's `ast_rules` gives the same
  findings (rule, context, line; the path mapped to the port's tree) on
  the bad/good fixture pairs of tests/test_graftlint.py; a fixture that
  acquires the TPU (`jax.devices()`) acquires the card instead
  (`torch.cuda.init()`, on the same line);
* the torch rules (per-call timing around a launch, a late
  `CUDA_VISIBLE_DEVICES`, host fetches in a loop and in a serving loop)
  fire on their fixtures and stay silent on the fixed forms; every JAX
  rule is ported or named in the module docstring;
* the port's tree lints clean (AST and lock layers) against the empty
  `analysis/baseline.json`;
* the export-graph and transfer layers' selfchecks pass in process, and
  the real predict and train step audit clean;
* `python -m real_time_helmet_detection_tpu_torch.analysis.graftlint
  --selfcheck --ast-only` exits 0 in a subprocess and prints one JSON
  line.
"""

import json
import os
import subprocess
import sys

import pytest

from real_time_helmet_detection_tpu.analysis import ast_rules as jax_rules
from real_time_helmet_detection_tpu_torch.analysis import (ast_rules,
                                                           diff_baseline,
                                                           graftlint,
                                                           load_baseline,
                                                           lock_audit)

from test_graftlint import AST_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = ast_rules.PKG
SHARED = {"ast/raw-artifact-write", "ast/missing-ref-citation",
          "ast/raw-span-timing", "ast/unbounded-retry",
          "ast/raw-metric-aggregation", "ast/unbarriered-collective-start",
          "ast/engine-bypass-in-fleet", "ast/context-free-span",
          "ast/hand-picked-threshold"}
CHIP_SCOPED = {"ast/raw-span-timing", "ast/raw-metric-aggregation"}
THRESHOLD_FIXTURE = (
    "def route(router, img):\n"
    "    return router.submit(img, tenant='cam',\n"
    "                         cascade_threshold=0.25)\n"
    "def cli(p):\n"
    "    p.add_argument('--skip-threshold', type=float, default=1.0)\n",
    "def route(router, img, cfg):\n"
    "    th = cfg.cascade_overrides()['threshold']\n"
    "    return router.submit(img, tenant='cam',\n"
    "                         cascade_threshold=th)\n"
    "def cli(p):\n"
    "    p.add_argument('--skip-threshold', type=float, default=None)\n")
SHARED_CASES = [c for c in AST_CASES if c[0] in SHARED] + [
    ("ast/hand-picked-threshold", "scripts/serve_bench.py",
     *THRESHOLD_FIXTURE)]


def port_path(rule, path):
    """A JAX fixture path in the port's tree: the chip-script rules at
    the port's chip script under serving/, JAX's package at the port's."""
    if rule in CHIP_SCOPED or path == "scripts/serve_bench.py":
        return PKG + "serving/runs.py"
    if path.startswith("scripts/"):
        return PKG + path[len("scripts/"):]
    return path.replace("real_time_helmet_detection_tpu/", PKG)


def of_rule(findings, rule):
    return sorted((f.rule, f.context, f.line) for f in findings
                  if f.rule == rule)


@pytest.mark.parametrize("rule,path,bad,good", SHARED_CASES,
                         ids=[c[0] + ":" + c[1] for c in SHARED_CASES])
def test_shared_rule_finds_what_jax_finds(rule, path, bad, good):
    ppath = port_path(rule, path)
    for src in (bad, good):
        want = of_rule(jax_rules.lint_source(src, path), rule)
        port_src = src.replace("jax.devices()", "torch.cuda.init()")
        found = ast_rules.lint_source(port_src, ppath)
        assert of_rule(found, rule) == want, (src, ppath)
        assert all(f.path == ppath for f in found if f.rule == rule)
    assert of_rule(jax_rules.lint_source(bad, path), rule)


TORCH_RULES = ("per-call-timing", "env-platform-write",
               "device-get-in-loop", "device-get-in-serving-loop")


@pytest.mark.parametrize("short", TORCH_RULES)
def test_torch_rule_fires_on_its_fixture(short):
    bad, good = graftlint.AST_FIXTURES[short]
    rule = "ast/" + short
    assert of_rule(ast_rules.lint_source(bad, graftlint.FIXTURE_PATH), rule)
    assert not of_rule(ast_rules.lint_source(good, graftlint.FIXTURE_PATH),
                       rule)


def test_every_jax_rule_is_ported_or_explained():
    doc = ast_rules.__doc__
    ported = {r.__name__ for r in ast_rules.RULES}
    for rule in jax_rules.RULES:
        short = rule.__name__[len("rule_"):].replace("_", "-")
        assert rule.__name__ in ported or ("`%s`" % short in doc
                                           and "none:" in doc), short
    assert "rule_queue_bypass" not in ported and "`queue-bypass`" in doc


def test_fetch_rules_read_the_card_not_numpy():
    """`.item()`/`.cpu()`/`.tolist()`/`.numpy()` with arguments, and a
    fetch outside any loop, are not flagged; `torch.cuda.synchronize()`
    in a loop is."""
    tmpl = "import torch\ndef f(xs):\n    for x in xs:\n        %s\n"
    rule = "ast/device-get-in-loop"
    for expr, flagged in [("x.item()", True), ("torch.cuda.synchronize()",
                                               True),
                          ("x.cpu(memory_format=None)", False),
                          ("x.numpy(force=True)", False),
                          ("y = x + 1", False)]:
        got = of_rule(ast_rules.lint_source(tmpl % expr, PKG + "x.py"), rule)
        assert bool(got) == flagged, expr
    assert not of_rule(ast_rules.lint_source(
        "def f(x):\n    return x.cpu().numpy()\n", PKG + "x.py"), rule)


def test_repo_files_are_the_ports():
    files = ast_rules.repo_files(REPO)
    assert "chip_smoke.py" in files and PKG + "train.py" in files
    assert PKG + "analysis/graftlint.py" in files
    assert not any(f.startswith(("real_time_helmet_detection_tpu/",
                                 "tests/", "scripts/")) for f in files)


def test_port_tree_clean_against_the_empty_baseline():
    findings = ast_rules.lint_repo(REPO) + lock_audit.audit_repo(REPO)
    baseline = load_baseline()
    assert baseline == {}
    d = diff_baseline(findings, baseline)
    assert d["new"] == [], [(f.rule, f.path, f.line, f.message)
                            for f in d["new"]]


@pytest.mark.parametrize("layer", ["trace", "xfer"])
def test_selfcheck_layers_in_process(layer):
    failures = []

    def check(name, cond):
        if not cond:
            failures.append(name)

    getattr(graftlint, "_selfcheck_" + layer)(check)
    assert failures == []


def test_real_entries_audit_clean():
    from real_time_helmet_detection_tpu_torch.analysis import trace_audit
    builds = trace_audit.export_entries()
    findings, sig = trace_audit.audit_entry(builds["predict"], "predict")
    assert findings == [] and len(sig) == 64
    assert trace_audit.step_findings("sentinel", "train_step[sentinel]") \
        == []


def test_cli_selfcheck_ast_only_subprocess():
    r = subprocess.run(
        [sys.executable, "-m",
         "real_time_helmet_detection_tpu_torch.analysis.graftlint",
         "--selfcheck", "--ast-only"], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["selfcheck"] and not last["failures"]


def test_cli_ast_only_run_subprocess():
    r = subprocess.run(
        [sys.executable, "-m",
         "real_time_helmet_detection_tpu_torch.analysis.graftlint",
         "--ast-only", "--format", "github"], capture_output=True,
        text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["findings"] == 0
    assert last["package"] == "real_time_helmet_detection_tpu_torch"


def test_github_annotations():
    from real_time_helmet_detection_tpu_torch.analysis import Finding
    f = Finding(rule="ast/x", path="a.py", message="two\nlines", line=3)
    assert graftlint.github_annotations([f]) == [
        "::error file=a.py,line=3,title=ast/x::two lines"]
