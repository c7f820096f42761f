"""The port's load generators (`serving/loadgen.py`) against the JAX
package's serve_bench loops, on the CPU.

The cases of the JAX package's serve_bench helper tests, on the port:
the seeded arrival schedule (the same offsets as JAX's for a seed), the
latency digest through the metrics histogram, the serial batch-1 loop's
goodput collapse past saturation; then the open loop's accounting (on
time, late, shed, lost) and the closed loop against a stub server and
against the serving engine.
"""

import importlib.util
import os
import threading
import time

import numpy as np
import pytest

from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.evaluate import init_weights
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.serving import (ServingEngine,
                                                          SheddedError,
                                                          loadgen)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_serve_bench():
    spec = importlib.util.spec_from_file_location(
        "serve_bench", os.path.join(REPO, "scripts", "serve_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_arrival_schedule_seeded_and_bounded():
    a = loadgen.arrival_schedule(100.0, 2.0, seed=5)
    b = loadgen.arrival_schedule(100.0, 2.0, seed=5)
    assert a == b
    assert all(0 < t < 2.0 for t in a)
    assert a == sorted(a)
    assert 140 < len(a) < 260  # Poisson at 100 rps over 2 s, 3 sigma
    assert loadgen.arrival_schedule(100.0, 2.0, seed=6) != a
    assert a == _jax_serve_bench().arrival_schedule(100.0, 2.0, seed=5)


def test_latency_digest_rides_the_metrics_histogram():
    d = loadgen._lat_ms([0.010, 0.020, 0.030, 0.040])
    # nearest-rank p50 over 4 samples is the 3rd (30 ms) at bucket
    # resolution; p99 clamps to the exact max; the mean is exact
    assert abs(d["p50_ms"] - 30.0) <= 3.0
    assert d["p99_ms"] == 0.040 * 1e3
    assert d["mean_ms"] == pytest.approx(25.0, rel=1e-12)
    assert d["p50_ms"] <= d["p99_ms"]
    assert loadgen._lat_ms([]) == {"p50_ms": None, "p99_ms": None,
                                   "mean_ms": None}
    theirs = _jax_serve_bench()._lat_ms([0.010, 0.020, 0.030, 0.040])
    for key in ("p50_ms", "p99_ms", "mean_ms"):
        assert round(d[key], 2) == theirs[key]


class _FakeDets:
    scores = np.zeros((1,))


def _slow_b1(images):
    time.sleep(0.010)
    return _FakeDets()


def test_serial_loop_goodput_collapses_past_saturation():
    """A FIFO b1 server with a 10 ms service time, offered 2x its
    capacity with a 50 ms deadline: the queueing delay grows and goodput
    collapses to the early prefix; at a quarter of its capacity every
    request is on time."""
    pool = [np.zeros((4, 4, 3), np.uint8)]
    sched = loadgen.arrival_schedule(200.0, 1.0, seed=1)
    over = loadgen.serial_loop(_slow_b1, pool, sched, 1.0, deadline_s=0.05,
                               offered_rps=200.0)
    assert over["served"] < len(sched)
    assert over["goodput_rps"] < 30.0
    sched2 = loadgen.arrival_schedule(50.0, 1.0, seed=2)
    under = loadgen.serial_loop(_slow_b1, pool, sched2, 1.0,
                                deadline_s=0.05, offered_rps=50.0)
    assert under["ontime"] == under["served"] > 0
    assert under["goodput_rps"] > over["goodput_rps"]


class _Future:
    def __init__(self, delay, error=None):
        self.t_submit = time.monotonic()
        self.t_done = None
        self._error = error
        self._done = threading.Event()
        threading.Timer(delay, self._finish).start()

    def _finish(self):
        self.t_done = time.monotonic()
        self._done.set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("pending")
        if self._error is not None:
            raise self._error
        return "row"


class _StubServer:
    """submit() -> a future that completes after `delays[i % n]`; every
    `shed_every`-th request is shed, every `lose_every`-th fails."""

    def __init__(self, delays, shed_every=0, lose_every=0):
        self.delays, self.n = delays, 0
        self.shed_every, self.lose_every = shed_every, lose_every
        self.kwargs = []

    def submit(self, image, **kw):
        self.kwargs.append(kw)
        i, self.n = self.n, self.n + 1
        err = None
        if self.shed_every and i % self.shed_every == self.shed_every - 1:
            err = SheddedError("queue full")
        elif self.lose_every and i % self.lose_every == self.lose_every - 1:
            err = RuntimeError("retries exhausted")
        return _Future(self.delays[i % len(self.delays)], err)


def test_open_loop_accounting():
    server = _StubServer([0.001, 0.001, 0.08], shed_every=5, lose_every=7)
    sched = [0.002 * i for i in range(35)]
    r = loadgen.open_loop(server, [np.zeros(1)], sched, 0.1,
                          deadline_s=0.05, offered_rps=350.0)
    assert r["n"] == 35 == r["ontime"] + r["late"] + r["shed"] + r["lost"]
    assert r["shed"] == 7 and r["lost"] == 4
    assert r["late"] > 0 and r["ontime"] > r["late"]
    assert r["goodput_rps"] == r["ontime"] / 0.1
    assert all(kw == {"deadline_s": 0.05, "block": False}
               for kw in server.kwargs)
    assert r["p99_ms"] >= 50.0 > r["p50_ms"]


def test_closed_loop_against_a_stub_server():
    server = _StubServer([0.005])
    r = loadgen.closed_loop(server, [np.zeros(1)], 4, 0.3)
    assert r["mode"] == "closed" and r["clients"] == 4
    # 4 clients, 5 ms a request: about 800 requests/s
    assert 50 < r["goodput_rps"] < 1000
    assert r["completed"] == pytest.approx(r["goodput_rps"]
                                           * r["duration_s"])
    assert r["p50_ms"] >= 5.0


def test_loops_drive_the_serving_engine():
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=8, num_cls=2,
                 topk=8, imsize=64)
    predict = make_predict_fn(init_weights(build_model(cfg), 0), cfg,
                              normalize="imagenet", device="cpu")
    pool = [np.random.default_rng(i).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
            for i in range(4)]
    with ServingEngine(predict, None, (64, 64, 3), np.uint8,
                       buckets=(1, 2, 4), max_wait_ms=2.0,
                       metrics=MetricsRegistry()) as eng:
        closed = loadgen.closed_loop(eng, pool, 4, 0.5)
        assert closed["completed"] > 0 and closed["p99_ms"] > 0
        rate = 0.5 * closed["goodput_rps"]
        sched = loadgen.arrival_schedule(rate, 0.5, seed=3)
        opened = loadgen.open_loop(eng, pool, sched, 0.5, 5.0, rate)
        assert opened["lost"] == 0
        assert opened["ontime"] + opened["late"] + opened["shed"] \
            == len(sched)
        stats = eng.stats()
    assert stats["completed"] >= closed["completed"] + opened["completed"]
    serial = loadgen.serial_loop(predict, pool, [0.0, 0.01, 0.02], 5.0, 5.0,
                                 150.0)
    assert serial["served"] == serial["ontime"] == 3
