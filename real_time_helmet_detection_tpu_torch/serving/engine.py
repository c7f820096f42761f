"""Continuous-batching serving engine: one CUDA graph per bucket,
pipelined micro-batching, admission control, in-flight recovery, hot
reload.

Port of ref real_time_helmet_detection_tpu/serving/engine.py:130-1011
(`ServingEngine`, `ServeFuture`, `resolve_buckets`, the state machine),
the one predict surface of the port's eval and demo (ref evaluate.py:
236-300, :474-477). The public API is the JAX engine's, except that
`reload` (and the constructor's `variables`) take a flax variable tree
(numpy) or a state dict, loaded in place into the storages the graphs
read (for an int8 predict: folded and quantized, with new activation
scales when `reload` is given them); there is no sharding. An optional
`obs.slo.SloWatchdog` (ref engine.py:310, :529-539, :575-585) is checked
after every batch outcome and may `degrade()` the engine; its alerts
are in `health()["alerts"]`.

Design rules:

* **One CUDA graph per bucket, captured at construction.** The JAX
  engine compiles each bucket's program AOT (`predict.lower().compile()`)
  and never traces again; here each bucket's predict body is warmed up
  and captured once (`predict.BucketRunner`, a `serve:compile`
  span each) on the constructing thread, before the dispatcher and the
  fetcher start. After `__init__` nothing is captured again
  (`stats()["bucket_builds"]` stays at the bucket count); retries and
  reloads replay the same graphs, so their rows are bit-identical. On
  the CPU (`device="cpu"`, the tests' path) a bucket calls the same body
  eagerly. On CUDA there is no eager path: a failed capture raises from
  the constructor, a failed launch fails the batch into recovery.
* **Rows and buckets.** Padding rows are zeros and are never read back;
  each request gets its own numpy row. A row is bit-identical to the
  one-shot predict of the same image at the same batch size; across
  batch sizes cuDNN (and the CPU's convolutions) may pick other
  algorithms, so rows of one image in two buckets agree as detections,
  not always in the last bit. `ServeFuture.bucket` says which bucket
  served a request.
* **Batching = max-wait vs max-batch.** The dispatcher takes the oldest
  request, then gathers until the largest bucket fills or `max_wait_ms`
  has passed since that request's submit; under backlog it drains
  without waiting. The batch takes the smallest bucket >= its size.
* **Pipelining, `depth` batches deep.** Each in-flight slot owns a
  pinned staging buffer of the image wire (uint8 for eval) and pinned
  host buffers of the four Detections leaves. Per batch, on one engine
  stream: the H2D copy into the bucket's static input
  (`non_blocking`), `replay()`, the D2H copies of the static outputs
  into the slot, an event. The dispatcher hands the batch to the fetcher
  thread, which waits on the event and cuts the rows out. A slot returns
  to the free list after its fetch, so at most `depth` batches are in
  flight and device work is never handed a view of static outputs that
  the next replay overwrites (stream order keeps the D2H ahead of it).
* **Admission control.** The request queue is bounded: `submit(...,
  block=False)` sheds at once when it is full (`SheddedError`), and a
  request whose deadline passed before its batch formed is shed instead
  of taking a slot.
* **In-flight recovery.** A batch that fails at dispatch or fetch, or
  whose fetch outlasts `hang_timeout_s` (the watchdog polls the batch's
  event), requeues each request within its retry budget (`max_retries`;
  past it the error surfaces on the future). Requeues go to a deque the
  dispatcher drains first. SERVING -> DEGRADED on a failed batch, back
  after `recover_after` healthy batches in a row; `health()` snapshots
  it.
* **Graceful drain + hot reload.** `reload` drains what was admitted
  (served with the old weights), then copies the new weights in place
  into the model's parameters and buffers under the dispatch mutex: the
  graphs read those storages, so nothing is captured again. Under
  `--amp` the conv weights were cast to bf16 once before capture; the
  copy casts into those bf16 storages.
* **Chaos hooks, spans, metrics.** An optional `ChaosInjector` fires at
  `serve:dispatch` and `serve:fetch`. Spans `serve:compile`,
  `serve:queue-wait`, `serve:batch-form`, `serve:h2d`, `serve:compute`
  (host walls of the enqueues), `serve:inflight-wait`, `serve:d2h` (the
  wait for the device and the row copies) and `serve:e2e`, with trace
  contexts as in the JAX engine (`submit(ctx=...)`, or a root minted
  here when tracing is on). `serve.*` counters, gauges and latency
  histograms land in an `obs.metrics` registry.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import predict as predict_mod
from ..obs import metrics as metrics_mod
from ..obs.spans import maybe_tracer
from ..obs.trace import links_of, new_root
from ..ops.decode import Detections

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# engine states
SERVING = "serving"      # healthy steady state
DEGRADED = "degraded"    # a recent batch failed; still serving, retries
# in flight; leaves after `recover_after` healthy batches in a row
DRAINING = "draining"    # reload(): serving admitted work before the swap
CLOSED = "closed"        # terminal

_SENTINEL = object()
_WAKE = object()         # fetcher -> dispatcher: "check the retry deque"


class SheddedError(RuntimeError):
    """The request was shed by admission control (queue full, or its
    deadline passed before dispatch)."""


class EngineClosedError(RuntimeError):
    """The engine was closed before this request completed."""


class FetchHungError(RuntimeError):
    """A batch's fetch outlasted the hang watchdog (`hang_timeout_s`); its
    requests are requeued and the stuck fetch abandoned."""


def resolve_buckets(cfg) -> Tuple[int, ...]:
    """The static bucket set from `cfg.serve_buckets`, validated and
    sorted (ref serving/engine.py:161)."""
    raw = list(getattr(cfg, "serve_buckets", None) or DEFAULT_BUCKETS)
    buckets = sorted({int(b) for b in raw})
    if not buckets or buckets[0] < 1:
        raise ValueError("serve_buckets must be positive ints, got %r"
                         % (raw,))
    return tuple(buckets)


class ServeFuture:
    """Completion handle of one request. `result()` blocks; a shed or a
    close surfaces as the recorded exception. Completion is first-wins:
    an abandoned fetch that lands late cannot overwrite the retry's
    result. `t_submit`/`t_done` are monotonic stamps; `bucket` is the
    bucket that served the request.

    `add_done_callback(fn)` (ref serving/engine.py:204-232) is the fleet
    router's chaining hook: `fn(self)` runs once, on the completing
    thread (the engine's fetcher, dispatcher or a closing thread), or
    inline when the future is already done; its exceptions are
    swallowed, so a callback cannot kill the fetcher."""

    __slots__ = ("_event", "_value", "_error", "t_submit", "t_done",
                 "deadline", "ctx", "bucket", "_cb", "_cb_lock",
                 "_cb_fired")

    def __init__(self, deadline: Optional[float] = None):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        self.deadline = deadline
        self.ctx = None  # TraceContext when tracing is on
        self.bucket: Optional[int] = None
        self._cb = None
        self._cb_lock = threading.Lock()
        self._cb_fired = False

    def _run_callback(self) -> None:
        with self._cb_lock:
            cb = self._cb
            if cb is None or self._cb_fired:
                return
            self._cb_fired = True
        try:
            cb(self)
        except Exception:  # noqa: BLE001 - see the class docstring
            pass

    def add_done_callback(self, fn) -> None:
        """Register the one completion callback (the last registration
        wins); fires inline when the future is already done."""
        with self._cb_lock:
            self._cb = fn
        if self._event.is_set():
            self._run_callback()

    def _set(self, value, bucket: int) -> bool:
        if self._event.is_set():
            return False
        self._value = value
        self.bucket = bucket
        self.t_done = time.monotonic()
        self._event.set()
        self._run_callback()
        return True

    def _fail(self, error: BaseException) -> bool:
        if self._event.is_set():
            return False
        self._error = error
        self.t_done = time.monotonic()
        self._event.set()
        self._run_callback()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """The recorded error of a done future, else None."""
        return self._error if self._event.is_set() else None

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve request still pending after %ss"
                               % timeout)
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    __slots__ = ("image", "future", "attempts", "ctx", "ctx_owner")

    def __init__(self, image: np.ndarray, future: ServeFuture,
                 ctx=None, ctx_owner: bool = False):
        self.image = image
        self.future = future
        self.attempts = 0    # dispatch attempts that failed
        self.ctx = ctx       # TraceContext, stable across retries
        self.ctx_owner = ctx_owner  # True: this engine minted the root


class _Slot:
    """One in-flight batch's host memory: the staging buffer of the image
    wire and the predict's output leaves (the four of Detections, five
    of CascadeDetections), pinned on CUDA, each sized for the largest
    bucket, with an event that marks the batch's D2H done."""

    def __init__(self, maxb: int, image_shape, image_dtype: torch.dtype,
                 outputs: Detections, cuda: bool):
        self.stage = torch.zeros((maxb,) + image_shape, dtype=image_dtype,
                                 pin_memory=cuda)
        self.stage_np = self.stage.numpy()
        self.host = [torch.empty((maxb,) + tuple(o.shape[1:]),
                                 dtype=o.dtype, pin_memory=cuda)
                     for o in outputs]
        self.host_np = [h.numpy() for h in self.host]
        self.kind = type(outputs)
        self.event = torch.cuda.Event() if cuda else None

    def stage_rows(self, images: Sequence[np.ndarray], b: int) -> None:
        """Images into rows [0, n), zeros in the padding rows [n, b)."""
        n = len(images)
        for i, img in enumerate(images):
            self.stage_np[i] = img
        self.stage_np[n:b] = 0

    def rows(self, n: int) -> List[Detections]:
        """Each of the first n rows as its own numpy Detections (or
        CascadeDetections, with a 0-d confidence)."""
        return [self.kind(*(leaf[i].copy() for leaf in self.host_np))
                for i in range(n)]


class ServingEngine:
    """Persistent continuous-batching server over a `Predict`.

    Parameters
    ----------
    predict : `predict.make_predict_fn`'s `Predict`; its device (cuda or
        cpu) is the engine's, its `body` what each bucket captures.
    variables : None (the model's weights as they are), or a flax variable
        tree (numpy, `{"params", "batch_stats"}`) or a state dict, loaded
        in place before capture.
    image_shape : (H, W, C) of one request.
    image_dtype : numpy dtype of the wire (uint8 for the raw eval wire).
    buckets : static batch sizes, one graph each, built at construction.
    max_wait_ms : batch-formation wait bound (0 = dispatch at once).
    depth : batches in flight (>= 1), each with its pinned slot.
    queue_capacity : admission bound on queued (not yet batched) requests.
    tracer : `obs.spans.SpanTracer`; default `maybe_tracer()` ($OBS_SPAN_LOG).
    start : construct paused (`start=False`) to exercise admission control
        deterministically, then call `.start()`.
    max_retries : per-request retry budget after a failed or hung batch.
    hang_timeout_s : fetch watchdog (None disables).
    recover_after : healthy batches in a row that clear DEGRADED.
    injector : optional `runtime.faults.ChaosInjector`.
    metrics : optional `obs.metrics.MetricsRegistry` (default: the
        process-wide one).
    watchdog : optional `obs.slo.SloWatchdog`, checked after every batch
        outcome; its serving alerts degrade this engine.
    """

    def __init__(self, predict, variables, image_shape: Sequence[int],
                 image_dtype, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, depth: int = 2,
                 queue_capacity: int = 128, tracer=None,
                 start: bool = True, max_retries: int = 2,
                 hang_timeout_s: Optional[float] = None,
                 recover_after: int = 2, injector=None, metrics=None,
                 watchdog=None):
        self._buckets = tuple(sorted({int(b) for b in buckets}))
        if not self._buckets or self._buckets[0] < 1:
            raise ValueError("buckets must be positive, got %r" % (buckets,))
        self._predict = predict
        self._dev = predict.device
        self._cuda = self._dev.type == "cuda"
        if self._cuda and self._dev.index is None:
            self._dev = torch.device("cuda", torch.cuda.current_device())
        self._image_shape = tuple(int(s) for s in image_shape)
        self._image_dtype = np.dtype(image_dtype)
        self._max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._depth = max(1, int(depth))
        self._tracer = tracer if tracer is not None else maybe_tracer()
        self._max_retries = max(0, int(max_retries))
        self._hang_timeout_s = (None if hang_timeout_s is None
                                else max(1e-3, float(hang_timeout_s)))
        self._recover_after = max(1, int(recover_after))
        self._injector = injector
        self._metrics = (metrics if metrics is not None
                         else metrics_mod.default_registry())
        self._m_writer = metrics_mod.maybe_writer(registry=self._metrics)
        self._watchdog = watchdog
        mm = self._metrics
        self._mc = {name: mm.counter("serve." + name) for name in (
            "submitted", "completed", "batches_total", "batch_slots",
            "padded_slots", "shed_queue_full", "shed_deadline", "retried",
            "requeued_batches", "failed_batches", "hung_batches",
            "retry_exhausted", "reloads")}
        self._mg_queue = mm.gauge("serve.queue_depth")
        self._mg_retry = mm.gauge("serve.retry_depth")
        self._mg_inflight = mm.gauge("serve.inflight_batches")
        self._mh = {name: mm.histogram("serve.%s_ms" % name) for name in (
            "queue_wait", "batch_form", "h2d", "compute", "d2h", "e2e")}
        self._mg_fill = {b: mm.gauge("serve.fill.b%d" % b)
                         for b in self._buckets}
        self._stats = {"submitted": 0, "completed": 0, "batches": 0,
                       "shed_queue_full": 0, "shed_deadline": 0,
                       "padded_slots": 0, "failed": 0, "retried": 0,
                       "requeued_batches": 0, "hung_batches": 0,
                       "failed_batches": 0, "reloads": 0,
                       "bucket_builds": 0}

        if variables is not None:
            self._load_weights(variables)
        wire = torch.from_numpy(np.zeros(0, self._image_dtype)).dtype
        if self._cuda:
            torch.cuda.set_device(self._dev)
            self._stream = torch.cuda.Stream(self._dev)
        # one runner per bucket, built here and never again: on CUDA a
        # warm-up (kernel libraries, cuDNN plans) and one graph capture
        self._runners: Dict[int, predict_mod.BucketRunner] = {}
        for b in self._buckets:
            with self._tracer.span("serve:compile", b=b):
                self._runners[b] = predict_mod.BucketRunner(
                    predict, b, self._image_shape, wire)
            self._stats["bucket_builds"] += 1
        maxb = self._buckets[-1]
        outs = self._runners[maxb].outputs
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(self._depth):
            self._free.put(_Slot(maxb, self._image_shape, wire, outs,
                                 self._cuda))
        if self._cuda:
            # the engine stream runs after everything set up so far
            self._stream.wait_stream(torch.cuda.current_stream(self._dev))

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1,
                                                         int(queue_capacity)))
        self._retry: "collections.deque" = collections.deque()
        self._inflight: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        # serializes batch dispatch against reload's weight copy; the
        # dispatcher holds it across one batch's staging, H2D and replay
        self._dispatch_mutex = threading.Lock()
        self._state = SERVING
        self._consecutive_failures = 0
        self._consecutive_ok = 0
        self._inflight_batches = 0
        self._dispatch_busy = False  # a batch is being formed/dispatched
        self._last_error: Optional[str] = None
        self._closed = False
        self._started = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="serve-dispatch")
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True, name="serve-fetch")
        if start:
            self.start()

    def _load_weights(self, variables, scales=None) -> None:
        """A flax tree or a state dict, copied in place into the storages
        the graphs read (`Predict.load`: `load_state_dict` keeps every
        storage and casts into the bf16 conv weights of `--amp`; the int8
        twin folds and quantizes into its int8 weights, steps and
        rescales, with new activation `scales` when given)."""
        self._predict.load(variables, scales)

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._dispatcher.start()
        self._fetcher.start()

    def _fail_queued(self, err: BaseException) -> int:
        """Fail every request still in the admission queue or the retry
        deque; returns how many."""
        failed = 0
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req not in (_SENTINEL, _WAKE):
                req.future._fail(err)
                self._note_request_failed(req, err)
                failed += 1
        while self._retry:
            req = self._retry.popleft()
            req.future._fail(err)
            self._note_request_failed(req, err)
            failed += 1
        return failed

    def _stop_threads(self) -> None:
        if self._started:
            self._q.put(_SENTINEL)  # may block only on a full queue, which
            # the dispatcher is draining
            self._dispatcher.join()
            self._fetcher.join()

    def close(self) -> None:
        """Finish in-flight work, stop the threads, fail whatever is still
        queued. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop_threads()
        self._fail_queued(EngineClosedError("engine closed"))
        self._set_state(CLOSED)
        self._m_writer.close()

    def kill(self, reason: str = "replica death") -> int:
        """Abrupt death: fail every queued request with
        `EngineClosedError` now, then stop the threads; batches already
        dispatched complete normally. Returns the number failed out of the
        queues. Idempotent."""
        if self._closed:
            return 0
        self._closed = True
        err = EngineClosedError("replica killed: %s" % str(reason)[:200])
        failed = self._fail_queued(err)
        self._tracer.event("serve:killed", reason=str(reason)[:200],
                           failed=failed)
        self._stop_threads()
        failed += self._fail_queued(err)
        self._set_state(CLOSED)
        self._m_writer.close()
        return failed

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- state machine ---------------------------------------------------

    def _set_state(self, new: str) -> None:
        with self._lock:
            old = self._state
            if old == new or old == CLOSED:
                return
            self._state = new
        self._tracer.event("serve:state", **{"from": old, "to": new})

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def degrade(self, reason: str) -> None:
        """External DEGRADED flip (the SLO watchdog's lever): the engine
        keeps serving but advertises trouble, as after a failed batch;
        `recover_after` healthy batches in a row clear it. A closed engine
        ignores it."""
        with self._lock:
            self._consecutive_ok = 0
            self._last_error = "degraded: %s" % str(reason)[:200]
        self._tracer.event("serve:degrade", reason=str(reason)[:200])
        self._set_state(DEGRADED)

    def health(self, include_metrics: bool = True) -> Dict:
        """Point-in-time snapshot: state, backlog depths, failure counters
        (read under one lock acquisition), the digested `serve.*` metrics
        and, with a watchdog, its alerts so far."""
        with self._lock:
            state = self._state
            stats = dict(self._stats)
            consec_fail = self._consecutive_failures
            inflight = self._inflight_batches
            last_error = self._last_error
        out = {"state": state, "queued": self._q.qsize(),
               "retry_queued": len(self._retry),
               "inflight_batches": inflight,
               "consecutive_failures": consec_fail,
               "buckets": list(self._buckets),
               "max_retries": self._max_retries,
               "hang_timeout_s": self._hang_timeout_s,
               "last_error": last_error, "stats": stats}
        if include_metrics:
            out["metrics"] = self._metrics.digest(prefix="serve.")
            if self._watchdog is not None:
                out["alerts"] = list(self._watchdog.alerts)
        return out

    def _after_batch_outcome(self) -> None:
        """After every batch outcome, healthy or failed: check the SLO
        watchdog (an alert may degrade this engine) and give the metrics
        exporter its flush point. Host-side only."""
        if self._watchdog is not None:
            self._watchdog.check(engine=self)
        self._m_writer.maybe_flush()

    def _is_idle(self) -> bool:
        with self._lock:
            inflight = self._inflight_batches
            forming = self._dispatch_busy
        return (self._q.qsize() == 0 and not self._retry
                and inflight == 0 and not forming)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until everything admitted so far has completed. False on
        timeout."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while not self._is_idle():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def reload(self, variables, timeout_s: float = 30.0,
               scales=None) -> None:
        """Hot weight swap: drain admitted work (served with the old
        weights), copy the new weights (and, for an int8 predict, new
        activation `scales`) in place under the dispatch mutex, resume.
        Nothing is captured again and no request is dropped; requests
        admitted during the drain get the new weights."""
        if self._closed:
            raise EngineClosedError("engine closed")
        self._set_state(DRAINING)
        with self._tracer.span("recover:reload"):
            if not self.drain(timeout_s):
                self._set_state(DEGRADED)
                raise TimeoutError(
                    "reload: engine did not drain within %.1fs" % timeout_s)
            with self._dispatch_mutex:
                self._load_weights(variables, scales)
                if self._cuda:
                    # the copies ran on this thread's stream
                    self._stream.wait_stream(
                        torch.cuda.current_stream(self._dev))
                with self._lock:
                    self._stats["reloads"] += 1
                self._mc["reloads"].inc()
        self._set_state(SERVING)

    # ---- client API ------------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def metrics(self):
        """This engine's MetricsRegistry (the fleet's canary watchdog
        reads the canary replica's own)."""
        return self._metrics

    @property
    def runners(self) -> Dict[int, "predict_mod.BucketRunner"]:
        """The bucket runners (each bucket's graph on CUDA), by size."""
        return dict(self._runners)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def _req_ctx(self, req: _Request):
        """The context a per-request record carries: the root when this
        engine minted it, a child hop otherwise, None untraced."""
        if req.ctx is None:
            return None
        return req.ctx if req.ctx_owner else req.ctx.child()

    def _note_request_failed(self, req: _Request,
                             error: BaseException) -> None:
        """Terminal record of a request whose root this engine minted."""
        if req.ctx is not None and req.ctx_owner:
            self._tracer.event("serve:failed", ctx=req.ctx,
                               error=type(error).__name__)

    def submit(self, image: np.ndarray, deadline_s: Optional[float] = None,
               block: bool = True, timeout: Optional[float] = None,
               ctx=None) -> ServeFuture:
        """Enqueue one request; returns its future at once.

        `deadline_s` (relative seconds) arms deadline shedding.
        `block=False` sheds at once on a full queue (`SheddedError` from
        `result()`); the default blocks (backpressure). An admitted request
        completes with a result or a surfaced error, never disappears.
        `ctx`: the request's TraceContext, else one is minted when tracing
        is on."""
        if self._closed:
            raise EngineClosedError("engine closed")
        image = np.asarray(image)
        if image.shape != self._image_shape \
                or image.dtype != self._image_dtype:
            raise ValueError(
                "request image must be %s %s, got %s %s"
                % (self._image_shape, self._image_dtype, image.shape,
                   image.dtype))
        fut = ServeFuture(
            deadline=None if deadline_s is None
            else time.monotonic() + float(deadline_s))
        owner = False
        if ctx is None and self._tracer.enabled:
            ctx = new_root()
            owner = True
        fut.ctx = ctx
        req = _Request(image, fut, ctx=ctx, ctx_owner=owner)
        with self._lock:
            self._stats["submitted"] += 1
        self._mc["submitted"].inc()
        try:
            self._q.put(req, block=block, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._stats["shed_queue_full"] += 1
            self._mc["shed_queue_full"].inc()
            self._tracer.event("serve:shed", ctx=self._req_ctx(req),
                               reason="queue-full")
            fut._fail(SheddedError("queue full (admission control)"))
        self._mg_queue.set(self._q.qsize())
        return fut

    def predict_many(self, images: Sequence[np.ndarray]) -> List:
        """Submit every image, wait for all rows."""
        futs = [self.submit(img) for img in images]
        return [f.result() for f in futs]

    # ---- recovery --------------------------------------------------------

    def _requeue_or_fail(self, live: List[_Request], error: BaseException,
                         stage: str, b: int) -> None:
        """A batch failed at `stage`: requeue each request within its
        retry budget, surface the error on the rest; a _WAKE token pops a
        dispatcher blocked on the admission queue."""
        retried_reqs: List[_Request] = []
        exhausted_reqs: List[_Request] = []
        for r in live:
            r.attempts += 1
            if r.attempts <= self._max_retries:
                self._retry.append(r)
                retried_reqs.append(r)
            else:
                exhausted_reqs.append(r)
                r.future._fail(error)
        retried, exhausted = len(retried_reqs), len(exhausted_reqs)
        with self._lock:
            self._stats["failed_batches"] += 1
            self._stats["retried"] += retried
            self._stats["failed"] += exhausted
            if retried:
                self._stats["requeued_batches"] += 1
            self._consecutive_failures += 1
            self._consecutive_ok = 0
            self._last_error = "%s: %s" % (type(error).__name__,
                                           str(error).splitlines()[0][:200]
                                           if str(error) else "")
        self._mc["failed_batches"].inc()
        self._mc["retried"].inc(retried)
        self._mc["retry_exhausted"].inc(exhausted)
        if retried:
            self._mc["requeued_batches"].inc()
        self._mg_retry.set(len(self._retry))
        self._set_state(DEGRADED)
        self._tracer.event(
            "recover:requeue", stage=stage, b=b, n=retried,
            links=links_of([r.ctx for r in retried_reqs]) or None,
            error=type(error).__name__)
        if exhausted:
            self._tracer.event(
                "recover:retry-exhausted", stage=stage, n=exhausted,
                links=links_of([r.ctx for r in exhausted_reqs]) or None,
                error=type(error).__name__)
            for r in exhausted_reqs:
                self._note_request_failed(r, error)
        if retried:
            try:
                self._q.put_nowait(_WAKE)
            except queue.Full:
                pass  # a full queue wakes the dispatcher anyway
        self._after_batch_outcome()

    def _note_batch_ok(self) -> None:
        with self._lock:
            self._consecutive_ok += 1
            self._consecutive_failures = 0
            recovered = (self._state == DEGRADED
                         and self._consecutive_ok >= self._recover_after)
        if recovered:
            self._set_state(SERVING)
        self._after_batch_outcome()

    # ---- dispatcher ------------------------------------------------------

    def _pick_bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _shed_expired(self, batch: List[_Request], now: float
                      ) -> List[_Request]:
        live = []
        for r in batch:
            if r.future.deadline is not None and now > r.future.deadline:
                with self._lock:
                    self._stats["shed_deadline"] += 1
                self._mc["shed_deadline"].inc()
                self._tracer.event("serve:shed", ctx=self._req_ctx(r),
                                   reason="deadline")
                r.future._fail(SheddedError("deadline passed before "
                                            "dispatch"))
            else:
                live.append(r)
        return live

    def _take_blocking(self):
        """Next request, retries first; blocks on the admission queue.
        _SENTINEL at shutdown."""
        while True:
            if self._retry:
                return self._retry.popleft()
            item = self._q.get()
            if item is _WAKE:
                continue
            return item

    def _poll_next(self, timeout_s: float):
        """Intake during batch formation: retries first, then the queue
        within `timeout_s` (<= 0: no wait). None when nothing came."""
        if self._retry:
            return self._retry.popleft()
        try:
            item = (self._q.get_nowait() if timeout_s <= 0
                    else self._q.get(timeout=timeout_s))
        except queue.Empty:
            return None
        if item is _WAKE:
            if self._retry:
                return self._retry.popleft()
            return None
        return item

    def _launch(self, slot: _Slot, b: int, links=None) -> None:
        """H2D of the staged rows, the bucket's replay (or eager body on
        the CPU), D2H of the outputs into the slot, and its event: all on
        the engine stream, in this order. `links`: the batch's requests'
        contexts, which the two spans carry (ref serving/engine.py:895)."""
        runner = self._runners[b]
        with self._tracer.span("serve:h2d", b=b, links=links) as sp_h2d:
            runner.input.copy_(slot.stage[:b], non_blocking=True)
        with self._tracer.span("serve:compute", b=b,
                               links=links) as sp_comp:
            outputs = runner.run()
            for host, out in zip(slot.host, outputs):
                host[:b].copy_(out, non_blocking=True)
            if slot.event is not None:
                slot.event.record(self._stream)
        self._mh["h2d"].observe(sp_h2d.dur_s * 1e3)
        self._mh["compute"].observe(sp_comp.dur_s * 1e3)

    def _dispatch_loop(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self._dev)
        on_stream = (torch.cuda.stream(self._stream) if self._cuda
                     else contextlib.nullcontext())
        maxb = self._buckets[-1]
        stop = False
        with on_stream:
            while not stop:
                req = self._take_blocking()
                if req is _SENTINEL:
                    break
                with self._lock:
                    self._dispatch_busy = True
                batch = [req]
                # max-wait vs max-batch, anchored on the first request's
                # submit; under backlog the anchor has passed and the
                # queue drains without waiting
                anchor = req.future.t_submit + self._max_wait_s
                while len(batch) < maxb:
                    nxt = self._poll_next(anchor - time.monotonic())
                    if nxt is None:
                        if anchor - time.monotonic() <= 0:
                            break
                        continue
                    if nxt is _SENTINEL:
                        stop = True
                        break
                    batch.append(nxt)
                live = self._shed_expired(batch, time.monotonic())
                if not live:
                    with self._lock:
                        self._dispatch_busy = False
                    continue
                self._dispatch(live)
        self._inflight.put(_SENTINEL)

    def _dispatch(self, live: List[_Request]) -> None:
        """Stage, launch and hand one formed batch to the fetcher; a
        failure requeues its requests."""
        blinks = links_of([r.ctx for r in live]) or None
        slot = self._free.get()  # at most `depth` batches in flight
        with self._dispatch_mutex:
            with self._tracer.span("serve:batch-form", links=blinks,
                                   n=len(live)) as sp_form:
                b = self._pick_bucket(len(live))
                slot.stage_rows([r.image for r in live], b)
            self._mh["batch_form"].observe(sp_form.dur_s * 1e3)
            now = time.monotonic()
            for r in live:
                self._tracer.record("serve:queue-wait",
                                    now - r.future.t_submit,
                                    ctx=(r.ctx.child() if r.ctx else None))
                self._mh["queue_wait"].observe(
                    (now - r.future.t_submit) * 1e3)
            try:
                if self._injector is not None:
                    self._injector.fire("serve:dispatch", b=b)
                self._launch(slot, b, blinks)
            except Exception as e:  # noqa: BLE001 - requeue, serve on
                self._free.put(slot)
                self._requeue_or_fail(live, e, stage="dispatch", b=b)
                with self._lock:
                    self._dispatch_busy = False
                return
            with self._lock:
                self._stats["batches"] += 1
                self._stats["padded_slots"] += b - len(live)
                self._inflight_batches += 1
                self._dispatch_busy = False
                inflight = self._inflight_batches
            self._mc["batches_total"].inc()
            self._mc["batch_slots"].inc(b)
            self._mc["padded_slots"].inc(b - len(live))
            self._mg_fill[b].set(len(live) / b)
            self._mg_inflight.set(inflight)
            self._mg_queue.set(self._q.qsize())
        self._inflight.put((slot, live, b, time.monotonic()))

    # ---- fetcher ---------------------------------------------------------

    def _wait_device(self, slot: _Slot, b: int, poll: bool) -> None:
        """The chaos site, then the wait for the batch's event (polled
        when a watchdog is on, so the waiting thread never blocks in a
        CUDA call the watchdog cannot interrupt)."""
        if self._injector is not None:
            self._injector.fire("serve:fetch", b=b)
        if slot.event is None:
            return
        if not poll:
            slot.event.synchronize()
            return
        while not slot.event.query():
            time.sleep(1e-4)

    def _fetch(self, slot: _Slot, b: int) -> None:
        """Wait until the batch's D2H has landed in the slot, under the
        hang watchdog when configured: the wait then runs in a short-lived
        daemon thread so a hang can be abandoned (a late completion is
        discarded; futures are first-wins)."""
        if self._hang_timeout_s is None:
            self._wait_device(slot, b, poll=False)
            return
        box: Dict = {}
        done = threading.Event()

        def _wait():
            try:
                self._wait_device(slot, b, poll=True)
            except BaseException as e:  # noqa: BLE001 - surfaced below
                box["e"] = e
            finally:
                done.set()

        threading.Thread(target=_wait, daemon=True,
                         name="serve-d2h").start()
        if not done.wait(self._hang_timeout_s):
            with self._lock:
                self._stats["hung_batches"] += 1
            self._mc["hung_batches"].inc()
            raise FetchHungError(
                "batch (bucket %d) fetch exceeded the %.3fs hang watchdog"
                % (b, self._hang_timeout_s))
        if "e" in box:
            raise box["e"]

    def _fetch_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            slot, live, b, t_inq = item
            flinks = links_of([r.ctx for r in live]) or None
            self._tracer.record("serve:inflight-wait",
                                time.monotonic() - t_inq, b=b,
                                links=flinks)
            try:
                with self._tracer.span("serve:d2h", b=b, n=len(live),
                                       links=flinks) as sp_d2h:
                    self._fetch(slot, b)
                    rows = slot.rows(len(live))
            except Exception as e:  # noqa: BLE001 - requeue, serve on
                self._free.put(slot)
                self._requeue_or_fail(live, e, stage="fetch", b=b)
                with self._lock:
                    self._inflight_batches -= 1
                continue
            self._free.put(slot)
            self._mh["d2h"].observe(sp_d2h.dur_s * 1e3)
            with self._lock:
                self._stats["completed"] += len(live)
            self._mc["completed"].inc(len(live))
            for r, row in zip(live, rows):
                r.future._set(row, b)
                self._tracer.record(
                    "serve:e2e", r.future.t_done - r.future.t_submit,
                    ctx=self._req_ctx(r), b=b)
                self._mh["e2e"].observe(
                    (r.future.t_done - r.future.t_submit) * 1e3)
            with self._lock:
                self._inflight_batches -= 1
                inflight = self._inflight_batches
            self._mg_inflight.set(inflight)
            self._note_batch_ok()
