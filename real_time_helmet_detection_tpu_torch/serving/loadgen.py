"""Load generators that measure a served tier: closed, open and serial
loops.

Port of the loops of ref scripts/serve_bench.py:213 (`_lat_ms`;
`arrival_schedule` :229, `closed_loop` :247, `open_loop` :290,
`serial_loop` :332). They drive anything with the engine's `submit`
(`serving.ServingEngine`) from host threads and make no assumption about
the device:

* `closed_loop`: `clients` threads, each submitting its next request as
  its last completes, for `duration_s`: saturation goodput and latency;
  one client is a serial stream;
* `open_loop`: requests at the seeded Poisson times of
  `arrival_schedule`, each with a deadline, admitted without blocking
  (a full queue sheds): on-time goodput, late, shed and lost (admitted
  requests that surfaced an error) counts;
* `serial_loop`: the status-quo server, one batch-1 predict per request
  in arrival order, for the same schedule.

Latencies are submit-to-result host times; their p50/p99 come from an
`obs.metrics.Histogram` (bucket resolution about 9%, the max exact),
their mean is exact. Numbers are not rounded.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

import numpy as np

from ..obs.metrics import Histogram
from ..obs.spans import maybe_tracer
from .engine import SheddedError


def _lat_ms(vals: List[float]) -> Dict:
    """p50/p99/mean (ms) of latencies given in seconds."""
    if not vals:
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    h = Histogram("lat_ms")
    for v in vals:
        h.observe(v * 1e3)
    return {"p50_ms": h.quantile(0.50), "p99_ms": h.quantile(0.99),
            "mean_ms": h.mean}


def arrival_schedule(rate_rps: float, duration_s: float,
                     seed: int) -> List[float]:
    """Seeded Poisson arrival offsets (seconds from the start) within
    `duration_s`: the same trace can drive the engine and the serial
    baseline."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t >= duration_s:
            return out
        out.append(t)


def closed_loop(server, pool: List[np.ndarray], clients: int,
                duration_s: float, tracer=None) -> Dict:
    """`clients` clients back to back for `duration_s`: goodput (completed
    requests / s) and latency. The horizon is timed by a span of
    `tracer` (default `obs.spans.maybe_tracer()`; a disabled tracer still
    times)."""
    tracer = tracer or maybe_tracer()
    stop = threading.Event()
    lats: List[float] = []
    lock = threading.Lock()
    done = [0]

    def client(ci: int) -> None:
        k = ci
        while not stop.is_set():
            fut = server.submit(pool[k % len(pool)])
            k += clients
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - closed/shed at shutdown
                return
            with lock:
                done[0] += 1
                lats.append(fut.t_done - fut.t_submit)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    with tracer.span("serve-bench:closed", clients=clients) as sp:
        for t in threads:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    wall = sp.dur_s
    return {"mode": "closed", "clients": clients, "duration_s": wall,
            "completed": done[0], "goodput_rps": done[0] / wall,
            **_lat_ms(lats)}


def open_loop(server, pool: List[np.ndarray], schedule: List[float],
              duration_s: float, deadline_s: float,
              offered_rps: float) -> Dict:
    """Requests at the `schedule` offsets, each with `deadline_s`,
    submitted without blocking: goodput = on-time completions / s. Sheds
    are counted, never retried; `lost` counts admitted requests that
    surfaced an error."""
    futs = []
    t0 = time.monotonic()
    for i, at in enumerate(schedule):
        lag = t0 + at - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        futs.append(server.submit(pool[i % len(pool)],
                                  deadline_s=deadline_s, block=False))
    # grace: what was admitted near the horizon may still complete
    deadline_wall = time.monotonic() + deadline_s + 2.0
    ontime, late, shed, lost, lats = 0, 0, 0, 0, []
    for fut in futs:
        try:
            fut.result(timeout=max(0.1, deadline_wall - time.monotonic()))
        except SheddedError:
            shed += 1
            continue
        except Exception:  # noqa: BLE001 - retry-exhausted / closed /
            lost += 1      # timed out: an admitted request was lost
            continue
        lat = fut.t_done - fut.t_submit
        lats.append(lat)
        if lat <= deadline_s:
            ontime += 1
        else:
            late += 1
    return {"mode": "open", "offered_rps": offered_rps,
            "duration_s": duration_s, "n": len(schedule),
            "completed": ontime + late, "ontime": ontime, "late": late,
            "shed": shed, "lost": lost, "deadline_ms": deadline_s * 1e3,
            "goodput_rps": ontime / duration_s, **_lat_ms(lats)}


def serial_loop(predict_b1: Callable, pool: List[np.ndarray],
                schedule: List[float], duration_s: float,
                deadline_s: float, offered_rps: float) -> Dict:
    """One batch-1 `predict_b1(images)` per request, in arrival order, no
    deadline awareness; a request is not served before it arrives, and
    serving stops at the horizon (what is still queued is missed). Each
    request's scores are copied to the host: its result is there."""
    t0 = time.monotonic()
    t_end = t0 + duration_s
    ontime, served, lats = 0, 0, []
    for i, at in enumerate(schedule):
        now = time.monotonic()
        if now >= t_end:
            break
        lag = t0 + at - now
        if lag > 0:
            time.sleep(lag)  # an idle server waits for the next arrival
        scores = predict_b1(pool[i % len(pool)][None]).scores
        np.asarray(scores.cpu() if hasattr(scores, "cpu") else scores)
        lat = time.monotonic() - (t0 + at)
        served += 1
        lats.append(lat)
        if lat <= deadline_s:
            ontime += 1
    return {"mode": "serial-b1", "offered_rps": offered_rps,
            "duration_s": duration_s, "n": len(schedule),
            "served": served, "ontime": ontime,
            "missed": len(schedule) - ontime,
            "deadline_ms": deadline_s * 1e3,
            "goodput_rps": ontime / duration_s, **_lat_ms(lats)}
