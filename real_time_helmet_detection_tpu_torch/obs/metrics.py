"""Live metrics plane: thread-safe counters, gauges and histograms, with
periodic snapshots.

Port of ref real_time_helmet_detection_tpu/obs/metrics.py:55-508
(`Counter`, `Gauge`, `Histogram`, `MetricsRegistry`, `default_registry`,
`reset_default_registry`, `MetricsWriter`, `maybe_writer`, and the
readers `latest_path`, `read_metrics`, `read_latest`,
`snapshot_digest`).

* The latency histogram is log-linear with a fixed layout: `sub`
  geometric sub-buckets per power of two between `lo` and `hi`, an
  underflow and an overflow bucket. count/total/min/max are exact;
  quantiles report the bucket's geometric midpoint clamped to the
  observed range, as the JAX package's do.
* Everything is host-side bookkeeping: nothing here touches the device.
* `maybe_writer()` arms the export from $OBS_METRICS: each period one
  `obs-metrics-v1` line is appended to the file and the `<path>.latest`
  sidecar is replaced atomically. Without a path the writer is disabled
  and the registry still counts.
* The readers take either package's files: `read_metrics` returns every
  parseable snapshot line (a torn last line dropped), `read_latest` the
  `.latest` sidecar or else the last line, and `snapshot_digest` digests
  a snapshot already read (counters and gauges as they are, histograms
  to count/mean/p50/p99/max) without a live registry.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils import atomic_write_bytes

METRICS_SCHEMA = "obs-metrics-v1"
OBS_METRICS_ENV = "OBS_METRICS"


class Counter:
    """Monotonic integer counter; `inc` takes a lock, so concurrent
    threads never lose an increment."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last write wins; None until first set."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-layout log-linear histogram (see the module docstring);
    relative resolution 2^(1/sub), about 9% at sub 8."""

    __slots__ = ("name", "lo", "hi", "sub", "_buckets", "count", "total",
                 "min", "max", "_lock", "_nbuckets")

    DEFAULT_LO = 1e-3
    DEFAULT_HI = 1e7
    DEFAULT_SUB = 8

    def __init__(self, name: str, lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI, sub: int = DEFAULT_SUB):
        if not (lo > 0 and hi > lo and sub >= 1):
            raise ValueError("bad histogram layout lo=%r hi=%r sub=%r"
                             % (lo, hi, sub))
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.sub = int(sub)
        octaves = int(math.ceil(math.log2(self.hi / self.lo)))
        self._nbuckets = octaves * self.sub + 2
        self._buckets = [0] * self._nbuckets
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def _index(self, v: float) -> int:
        if not (v >= self.lo):      # also catches NaN
            return 0
        if v >= self.hi:
            return self._nbuckets - 1
        i = int(math.log2(v / self.lo) * self.sub)
        return max(1, min(self._nbuckets - 2, 1 + i))

    def _bucket_mid(self, i: int) -> float:
        if i <= 0:
            return self.lo
        if i >= self._nbuckets - 1:
            return self.hi
        return self.lo * 2.0 ** ((i - 1 + 0.5) / self.sub)

    def observe(self, v) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._buckets[i] += 1
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def _quantile_unlocked(self, q: float):  # guarded-by: _lock
        if self.count == 0:
            return None
        rank = min(self.count - 1,
                   max(0, int(round(float(q) * (self.count - 1)))))
        seen = 0
        for i, n in enumerate(self._buckets):
            seen += n
            if seen > rank:
                return max(self.min, min(self.max, self._bucket_mid(i)))
        return self.max

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile at bucket resolution; None when empty."""
        with self._lock:
            return self._quantile_unlocked(q)

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.total / self.count if self.count else None

    def snapshot(self) -> Dict:
        with self._lock:
            return {"lo": self.lo, "hi": self.hi, "sub": self.sub,
                    "count": self.count, "total": round(self.total, 9),
                    "min": self.min, "max": self.max,
                    "buckets": list(self._buckets)}

    @classmethod
    def from_snapshot(cls, name: str, snap: Dict) -> "Histogram":
        """The histogram a `snapshot()` dict describes."""
        h = cls(name, lo=snap["lo"], hi=snap["hi"], sub=snap["sub"])
        h._buckets = list(snap["buckets"])
        h.count = int(snap["count"])
        h.total = float(snap["total"])
        h.min = snap.get("min")
        h.max = snap.get("max")
        return h

    def digest(self) -> Dict:
        """count, mean, p50, p99, max under one lock acquisition."""
        with self._lock:
            count = self.count
            mean = self.total / count if count else None
            p50 = self._quantile_unlocked(0.50)
            p99 = self._quantile_unlocked(0.99)
            mx = self.max
        return {"count": count,
                "mean": None if mean is None else round(mean, 4),
                "p50": None if p50 is None else round(p50, 4),
                "p99": None if p99 is None else round(p99, 4),
                "max": mx}


class MetricsRegistry:
    """Named metrics, get-or-create; one coherent snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, lo: float = Histogram.DEFAULT_LO,
                  hi: float = Histogram.DEFAULT_HI,
                  sub: int = Histogram.DEFAULT_SUB) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, lo=lo, hi=hi,
                                                  sub=sub)
            return h

    def _handles(self):
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._hists))

    def snapshot(self) -> Dict:
        """One `obs-metrics-v1` snapshot, names sorted."""
        counters, gauges, hists = self._handles()
        return {"v": 1, "schema": METRICS_SCHEMA, "t": time.time(),
                "pid": os.getpid(),
                "counters": {n: c.value for n, c in sorted(counters.items())},
                "gauges": {n: g.value for n, g in sorted(gauges.items())},
                "histograms": {n: h.snapshot()
                               for n, h in sorted(hists.items())}}

    def digest(self, prefix: str = "") -> Dict:
        """Counters and gauges as they are, histograms digested; names
        starting with `prefix`."""
        counters, gauges, hists = self._handles()
        return {"counters": {n: c.value for n, c in sorted(counters.items())
                             if n.startswith(prefix)},
                "gauges": {n: g.value for n, g in sorted(gauges.items())
                           if n.startswith(prefix)},
                "histograms": {n: h.digest() for n, h in sorted(hists.items())
                               if n.startswith(prefix)}}


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry the engine counts into unless given one
    of its own."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Replace the process-wide registry (tests: one test's counts must
    not leak into the next one's snapshot)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT


def latest_path(path: str) -> str:
    return path + ".latest"


class MetricsWriter:
    """Periodic snapshot export; `path=None` builds a disabled writer."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 path: Optional[str] = None, period_s: float = 30.0):
        self.registry = registry if registry is not None \
            else default_registry()
        self.path = path or None
        self.enabled = self.path is not None
        self.period_s = max(0.0, float(period_s))
        self._f = None
        self._last_flush = 0.0
        self._lock = threading.Lock()

    def maybe_flush(self, force: bool = False) -> bool:
        """Append one snapshot (and refresh `<path>.latest`) once the
        period has passed, or when forced; True when one was written. An
        export failure disables the writer instead of raising."""
        now = time.monotonic()
        with self._lock:
            if not self.enabled:
                return False
            if not force and now - self._last_flush < self.period_s:
                return False
            self._last_flush = now
            try:
                snap = json.dumps(self.registry.snapshot(), sort_keys=True)
                if self._f is None:
                    parent = os.path.dirname(os.path.abspath(self.path))
                    os.makedirs(parent, exist_ok=True)
                    self._f = open(self.path, "a")
                self._f.write(snap + "\n")
                self._f.flush()
                atomic_write_bytes(latest_path(self.path), snap.encode())
                return True
            except (OSError, ValueError, TypeError):
                self.enabled = False
                return False

    def close(self) -> None:
        self.maybe_flush(force=True)
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


def maybe_writer(path: Optional[str] = None, env: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None,
                 period_s: float = 30.0) -> MetricsWriter:
    """Explicit `path`, else $OBS_METRICS, else a disabled writer."""
    p = path or (env if env is not None else os.environ).get(
        OBS_METRICS_ENV)
    return MetricsWriter(registry=registry, path=p, period_s=period_s)


def read_metrics(path: str) -> List[dict]:
    """Every parseable snapshot of a metrics JSONL; a torn last line is
    dropped silently, unparseable lines elsewhere with a warning."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    out = []
    lines = data.split(b"\n")
    for i, raw in enumerate(lines):
        if not raw.strip():
            continue
        try:
            out.append(json.loads(raw))
        except json.JSONDecodeError:
            if i != len(lines) - 1:
                print("[obs] WARNING: unparseable metrics line %d skipped"
                      % (i + 1), flush=True)
    return out


def read_latest(path: str) -> Optional[dict]:
    """The newest complete snapshot: the `.latest` sidecar if it parses,
    else the last parseable line."""
    try:
        with open(latest_path(path)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    snaps = read_metrics(path)
    return snaps[-1] if snaps else None


def snapshot_digest(snap: dict) -> Dict:
    """A snapshot already read, digested: counters and gauges as they
    are, each histogram as count/mean/p50/p99/max."""
    hists = {}
    for name, h in (snap.get("histograms") or {}).items():
        try:
            hists[name] = Histogram.from_snapshot(name, h).digest()
        except (KeyError, TypeError, ValueError):
            continue
    return {"counters": dict(snap.get("counters") or {}),
            "gauges": dict(snap.get("gauges") or {}),
            "histograms": hists}
