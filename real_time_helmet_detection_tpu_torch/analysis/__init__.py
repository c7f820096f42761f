"""Static and dynamic checks of the port's own hot paths (graftlint).

Port of ref real_time_helmet_detection_tpu/analysis/__init__.py:37-101
(`Finding`, `load_baseline`, `diff_baseline`, `write_baseline`), with
the port's own layers beside it:

* `ast_rules`      — the convention rules over the port's sources
                     (stdlib `ast`, no torch);
* `lock_audit`     — lockset inference, lock order, blocking and
                     callback calls under a lock, over the port's
                     threads (engine, fleet, watchdogs, loaders);
* `interleave`     — seeded thread schedules that make a flagged race
                     or deadlock replayable, driving the port's
                     `ServingEngine.health()` and `FleetRouter.health()`;
* `trace_audit`    — `torch.export` of the public entry points at tiny
                     CPU shapes, the graphs inspected for symbolic dims,
                     float64, host syncs and instability;
* `transfer_audit` — every registered entry point's host<->device
                     interface, gated against `transfer_manifest.json`;
* `graftlint`      — the command line over all of them.

Findings diff against the committed `baseline.json`, which stays empty:
a finding on the port is fixed or carries a suppression that says why.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class Finding:
    """One rule violation. `key` (rule::path::context) leaves the line
    out, so a baseline entry survives unrelated edits of its file; `line`
    is for the reader of the report."""

    rule: str          # e.g. "ast/raw-artifact-write", "trace/realloc"
    path: str          # repo-relative file, or "<entry>" for trace rules
    message: str
    line: int = 0
    context: str = ""  # enclosing def/class qualname, or the entry's name

    @property
    def key(self) -> str:
        return "%s::%s::%s" % (self.rule, self.path, self.context)

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    """key -> justification from the committed baseline (empty when the
    file is missing: then nothing is grandfathered)."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {e["key"]: e.get("reason", "") for e in data.get("findings", [])}


def diff_baseline(findings: List[Finding],
                  baseline: Dict[str, str]) -> Dict[str, List]:
    """The ratchet: `new` fails the gate, `baselined` is tolerated,
    `stale` are baseline entries no longer observed."""
    seen = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    baselined = [f for f in findings if f.key in baseline]
    stale = sorted(k for k in baseline if k not in seen)
    return {"new": new, "baselined": baselined, "stale": stale}


def write_baseline(findings: List[Finding], path: Optional[str] = None,
                   reasons: Optional[Dict[str, str]] = None) -> str:
    """Rewrite baseline.json from the current findings, atomically
    (`utils.save_json`)."""
    from ..utils import save_json
    path = path or BASELINE_PATH
    reasons = reasons or {}
    entries = [{"key": f.key, "rule": f.rule, "path": f.path,
                "context": f.context,
                "reason": reasons.get(f.key, "baselined at introduction; "
                                             "justify or fix")}
               for f in sorted(findings, key=lambda f: f.key)]
    save_json(path, {"version": 1, "findings": entries}, indent=1,
              sort_keys=True)
    return path
