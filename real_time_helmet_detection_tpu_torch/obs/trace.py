"""Trace contexts: per-request causality for the span log.

Port of ref real_time_helmet_detection_tpu/obs/trace.py:55-163
(`TraceContext`, `new_root`, `step_context`, `links_of`, `reset_ids`),
stdlib only.

* Ids come from a per-process counter under a per-process prefix (the
  pid, or `reset_ids(seed)` for tests and replay), so the same traffic
  through the same code mints the same ids; nothing here reads a clock.
* Fan-in is links, not parents: a serving batch serves N requests at
  once and carries `links=[{trace, span}, ...]` naming each member's
  context.
* Whoever mints a root (the engine, when it serves alone) writes its one
  closing record (`serve:e2e`, or a terminal `serve:shed` /
  `serve:failed`); everything downstream writes child contexts.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

class _IdGen:
    """Per-process id mint: `<prefix>-<counter>`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._prefix = "%x" % os.getpid()

    def reset(self, seed: Optional[int] = None) -> None:
        with self._lock:
            self._n = 0
            self._prefix = ("%x" % os.getpid() if seed is None
                            else "s%x" % int(seed))

    def next_id(self) -> str:
        with self._lock:
            self._n += 1
            return "%s-%x" % (self._prefix, self._n)


_IDS = _IdGen()


def reset_ids(seed: Optional[int] = None) -> None:
    """Re-seed the id mint (tests, replay); None restores the pid
    prefix."""
    _IDS.reset(seed)


class TraceContext:
    """One node of a request's causal chain: (trace_id, span_id,
    parent_id). Propagation mints children, never mutates."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = None if parent_id is None else str(parent_id)

    def child(self) -> "TraceContext":
        """A fresh span under this one (same trace, parent = this span)."""
        return TraceContext(self.trace_id, _IDS.next_id(), self.span_id)

    def link(self) -> Dict[str, str]:
        """The fan-in edge a batch span's `links` list holds."""
        return {"trace": self.trace_id, "span": self.span_id}

    def to_fields(self) -> Dict[str, str]:
        """The record fields (parent omitted at the root)."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        return out

    @classmethod
    def from_fields(cls, rec: Dict) -> Optional["TraceContext"]:
        """Rebuild from a span-log record (None without trace fields)."""
        if not isinstance(rec, dict) or "trace" not in rec:
            return None
        span = rec.get("span")
        if span is None:
            return None
        return cls(rec["trace"], span, rec.get("parent"))

    def __repr__(self) -> str:
        return "TraceContext(%s, %s, parent=%s)" % (
            self.trace_id, self.span_id, self.parent_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)


def new_root() -> TraceContext:
    """Mint a request root (the standalone `ServingEngine.submit`)."""
    t = _IDS.next_id()
    return TraceContext(t, _IDS.next_id(), None)


def step_context(step: int, epoch: int = 0, rank: int = 0,
                 run: Optional[str] = None) -> TraceContext:
    """A train step's context: the trace id from (run, epoch, step)
    alone, so every rank's span log joins the same per-step trace; the
    span id is rank-scoped. `run` defaults to $OBS_TRACE_RUN, else
    "train" (ref obs/trace.py:148)."""
    run = run or os.environ.get("OBS_TRACE_RUN") or "train"
    trace_id = "step-%s-e%d-i%06d" % (run, int(epoch), int(step))
    return TraceContext(trace_id, "%s.r%d" % (trace_id, int(rank)), None)


def links_of(contexts: List[Optional[TraceContext]]) -> List[Dict]:
    """Fan-in links over a batch's member contexts (untraced members
    dropped; empty means the batch is untraced)."""
    return [c.link() for c in contexts if c is not None]
