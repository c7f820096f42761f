"""Per-stream delta-gated tile inference: a camera stream pays only for
the tiles that changed.

Port of ref real_time_helmet_detection_tpu/serving/streams.py:58-428
(`StreamFuture`, `FrameResult`, `smooth_tile`, `StreamSession`). A
`StreamSession` keeps the previous frame on the summary's device and a
per-tile detection cache; each frame is uploaded once, classified tile by
tile with `ops.delta.tile_delta_summary` (one (T,) float32 vector copied
back per frame), and only the changed tiles are cropped on the host and
submitted through a serving surface (a `ServingEngine` or a
`FleetRouter`: anything with `submit(image, block=False, deadline_s=...)
-> future`); static tiles answer from the cache. Per-tile boxes stitch
back into frame detections, with center-distance track association and
EMA score smoothing (host numpy, deterministic).

Contracts:

* **Gating off is the server's answer.** `gate=False` submits the whole
  frame as one request and delivers the server's answer untouched.
* **In-order delivery.** Frames carry sequence numbers; one delivery
  thread resolves them in submit order, so retries and fleet
  re-dispatch can reorder completion but never delivery.
* **An acknowledged frame is never lost.** A tile request that fails
  (shed, deadline, replica death past its retry budget) falls back to
  the cached tile; an injected `stream:frame` fault (dropped-frame,
  late-frame, corrupt-frame; `runtime/faults.py`) answers from the cache
  with a `recover:frame-gap` event, and a dropped or corrupt frame never
  becomes the delta reference.

Threading: one submitting thread per session (a camera's frames are
serial) and the session's delivery thread. `_prev` and the summary live
on the submit side; what both threads touch is guarded by `_lock`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..ops.decode import Detections
from ..ops.delta import (make_delta_fn, stitch_detections, tile_origins,
                         tile_shape)

# defaults of the host-side smoothing and association; the config's
# stream_* fields override them per session
EMA_DEFAULT = 0.5
TRACK_RADIUS_DEFAULT = 8.0


class StreamFuture:
    """One frame's pending answer (`result`/`done`/`add_done_callback`),
    delivered in sequence order by the session's delivery thread."""

    __slots__ = ("seq", "t_submit", "t_done", "_event", "_value", "_cb",
                 "_lock")

    def __init__(self, seq: int):
        self.seq = seq
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None  # stamped at delivery
        self._event = threading.Event()
        self._value = None
        self._cb: Optional[Callable] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The FrameResult. Never raises a request's error: a frame
        degrades, it does not fail."""
        if not self._event.wait(timeout):
            raise TimeoutError("stream frame %d not delivered" % self.seq)
        return self._value  # lock-free: written before _event.set() in
        # _set(); the Event wait/set pair is the publication barrier

    def add_done_callback(self, fn: Callable) -> None:
        with self._lock:
            if not self._event.is_set():
                self._cb = fn
                return
        fn(self)  # already delivered: inline, outside the lock

    def _set(self, value) -> None:
        with self._lock:
            self._value = value
            self.t_done = time.monotonic()
            self._event.set()
            cb, self._cb = self._cb, None
        if cb is not None:
            cb(self)


class FrameResult:
    """A delivered frame: its detections and the gating evidence."""

    __slots__ = ("seq", "detections", "computed_tiles", "total_tiles",
                 "degraded_tiles", "gap", "late")

    def __init__(self, seq, detections, computed_tiles, total_tiles,
                 degraded_tiles=0, gap=False, late=False):
        self.seq = seq
        self.detections = detections
        self.computed_tiles = computed_tiles
        self.total_tiles = total_tiles
        self.degraded_tiles = degraded_tiles
        self.gap = gap
        self.late = late


class _FrameWork:
    """One submitted frame in flight: a future per changed tile (None:
    answer from the tile cache at delivery)."""

    __slots__ = ("seq", "future", "tile_futs", "whole_fut", "gap", "late",
                 "raw")

    def __init__(self, seq, future, tile_futs=None, whole_fut=None,
                 gap=False, late=False, raw=False):
        self.seq = seq
        self.future = future
        self.tile_futs = tile_futs
        self.whole_fut = whole_fut
        self.gap = gap
        self.late = late
        self.raw = raw


def _centers(boxes: np.ndarray) -> np.ndarray:
    return np.stack([(boxes[:, 0] + boxes[:, 2]) * 0.5,
                     (boxes[:, 1] + boxes[:, 3]) * 0.5], axis=-1)


def smooth_tile(new: Detections, prev: Optional[Detections],
                ema: float, radius: float) -> Detections:
    """Track association + EMA score smoothing of one recomputed tile
    (both in tile pixels). Valid rows associate in index order to the
    nearest previous valid detection of the same class within `radius`
    (argmin's first-lowest tie-break); a matched row's score becomes
    `ema * prev + (1 - ema) * new`, others start fresh. Boxes, classes
    and validity are always the new tile's."""
    new_np = Detections(*(np.asarray(new[i]) for i in range(4)))
    if prev is None or ema <= 0.0 or not bool(np.any(prev.valid)):
        return new_np
    pv = np.asarray(prev.valid)
    pc = _centers(np.asarray(prev.boxes)[pv])
    pscore = np.asarray(prev.scores)[pv]
    pcls = np.asarray(prev.classes)[pv]
    scores = np.array(new_np.scores, copy=True)
    nc = _centers(new_np.boxes)
    for i in np.flatnonzero(np.asarray(new_np.valid)):
        d = np.hypot(pc[:, 0] - nc[i, 0], pc[:, 1] - nc[i, 1])
        d = np.where(pcls == new_np.classes[i], d, np.inf)
        j = int(np.argmin(d))
        if d[j] <= radius:
            scores[i] = ema * pscore[j] + (1.0 - ema) * scores[i]
    return Detections(boxes=new_np.boxes, classes=new_np.classes,
                      scores=scores.astype(new_np.scores.dtype,
                                           copy=False),
                      valid=new_np.valid)


_EMPTY_TILE = Detections(boxes=np.zeros((0, 4), np.float32),
                         classes=np.zeros((0,), np.int32),
                         scores=np.zeros((0,), np.float32),
                         valid=np.zeros((0,), bool))


class StreamSession:
    """One camera stream's stateful front door over a serving surface.

    `server`: anything with `submit(image, block=False, deadline_s=...)
    -> future` (a ServingEngine or a FleetRouter); `submit_kwargs` are
    passed on (a fleet tenant, say). `gate=True` needs a calibrated
    `threshold` (mean |delta| per tile in [0, 255];
    `config.stream_overrides()` resolves the committed one) and a
    `frame_shape` that divides into `grid x grid` tiles of the server's
    image shape; `gate=False` passes whole frames through. `device` is
    where the previous frame lives and the summary runs (the CPU only
    when asked)."""

    def __init__(self, server, frame_shape, grid=2,
                 threshold: Optional[float] = None, gate: bool = True,
                 ema: float = EMA_DEFAULT,
                 track_radius: float = TRACK_RADIUS_DEFAULT,
                 deadline_s: Optional[float] = None, submit_kwargs=None,
                 injector=None, tracer=None, sid: int = 0,
                 device="cuda"):
        if gate and threshold is None:
            raise ValueError(
                "gated StreamSession needs a calibrated threshold "
                "(config.stream_overrides())")
        self.server = server
        self.frame_shape = tuple(frame_shape)
        self.grid = int(grid)
        self.threshold = None if threshold is None else float(threshold)
        self.gate = bool(gate)
        self.ema = float(ema)
        self.track_radius = float(track_radius)
        self.deadline_s = deadline_s
        self.submit_kwargs = dict(submit_kwargs or {})
        self.injector = injector
        self.tracer = tracer
        self.sid = int(sid)
        self.origins = tile_origins(self.frame_shape, self.grid)
        self.tile_hw = tile_shape(self.frame_shape, self.grid)
        # submit-thread state: the summary and the previous frame, both
        # on the summary's device
        self._delta_fn = (make_delta_fn(self.grid, device) if self.gate
                          else None)
        self._prev = None
        # delivery-thread state: the last whole-frame answer (gate off)
        self._last_raw = None
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._tile_cache: List[Optional[Detections]] = \
            [None] * len(self.origins)
        self._seq = 0                       # guarded-by: _lock
        self._t0: Optional[float] = None    # guarded-by: _lock
        self._stats = {"frames": 0, "delivered": 0, "computed_tiles": 0,
                       "skipped_tiles": 0, "degraded_tiles": 0, "gaps": 0,
                       "late": 0, "corrupt": 0}  # guarded-by: _lock
        # FIFO to the delivery thread (None: the close sentinel)
        self._q: "queue.Queue[Optional[_FrameWork]]" = queue.Queue()
        self._closed = False                # guarded-by: _lock
        self._deliver_thread = threading.Thread(
            target=self._deliver_loop, name="stream-deliver-%d" % sid,
            daemon=True)
        self._deliver_thread.start()

    # ---------------------------------------------------------------- submit

    def submit_frame(self, frame: np.ndarray) -> StreamFuture:
        """Acknowledge one frame; its future always delivers (maybe from
        the cache), in sequence order."""
        frame = np.asarray(frame)
        if frame.shape != self.frame_shape:
            raise ValueError("frame shape %r != session shape %r"
                             % (frame.shape, self.frame_shape))
        with self._lock:
            if self._closed:
                raise RuntimeError("StreamSession is closed")
            seq = self._seq
            self._seq += 1
            self._stats["frames"] += 1
            if self._t0 is None:
                self._t0 = time.monotonic()
        fut = StreamFuture(seq)

        event = None
        if self.injector is not None:
            event = self.injector.fire("stream:frame", sid=self.sid,
                                       seq=seq)
        if event is not None and event.kind in ("dropped-frame",
                                                "corrupt-frame"):
            # never the delta reference; answered from the cache
            with self._lock:
                self._stats["gaps"] += 1
                if event.kind == "corrupt-frame":
                    self._stats["corrupt"] += 1
            if self.tracer is not None:
                self.tracer.event("recover:frame-gap", ctx=None,
                                  sid=self.sid, seq=seq, kind=event.kind)
            self._q.put(_FrameWork(seq, fut, gap=True))
            return fut
        late = event is not None and event.kind == "late-frame"
        if late:
            with self._lock:
                self._stats["late"] += 1

        if not self.gate:
            wf = self.server.submit(frame, block=False,
                                    deadline_s=self.deadline_s,
                                    **self.submit_kwargs)
            self._q.put(_FrameWork(seq, fut, whole_fut=wf, late=late,
                                   raw=True))
            return fut

        cur = self._delta_fn.upload(frame)
        if self._prev is None:
            changed = np.ones((len(self.origins),), bool)
        else:
            changed = self._delta_fn(self._prev, cur) >= self.threshold
            with self._lock:
                cache_miss = [c is None for c in self._tile_cache]
            for t, miss in enumerate(cache_miss):
                if miss:  # a tile with no cache yet computes regardless
                    changed[t] = True
        th, tw = self.tile_hw
        tile_futs: List[Optional[object]] = []
        for t, (y0, x0) in enumerate(self.origins):
            if changed[t]:
                tile = np.ascontiguousarray(
                    frame[y0:y0 + th, x0:x0 + tw])
                tile_futs.append(self.server.submit(
                    tile, block=False, deadline_s=self.deadline_s,
                    **self.submit_kwargs))
            else:
                tile_futs.append(None)
        self._prev = cur
        with self._lock:
            n = int(changed.sum())
            self._stats["computed_tiles"] += n
            self._stats["skipped_tiles"] += len(self.origins) - n
        self._q.put(_FrameWork(seq, fut, tile_futs=tile_futs, late=late))
        return fut

    # --------------------------------------------------------------- deliver

    def _deliver_loop(self) -> None:
        # FIFO order is sequence order, so delivery is in order even when
        # tile futures complete out of order
        while True:
            work = self._q.get()
            if work is None:
                return  # close() sentinel
            t0 = time.monotonic()
            result = self._resolve(work)
            with self._lock:
                self._stats["delivered"] += 1
            if self.tracer is not None:
                self.tracer.record(
                    "stream:frame", time.monotonic() - t0, sid=self.sid,
                    seq=work.seq, computed=result.computed_tiles,
                    total=result.total_tiles, gap=result.gap,
                    late=result.late)
            work.future._set(result)

    def _resolve(self, work: _FrameWork) -> FrameResult:
        total = len(self.origins)
        if work.raw:
            try:
                det = work.whole_fut.result()
                self._last_raw = det
                return FrameResult(work.seq, det, total, total,
                                   late=work.late)
            except Exception:  # noqa: BLE001 - degrade, never lose
                with self._lock:
                    self._stats["degraded_tiles"] += total
                return FrameResult(work.seq, self._last_raw, 0, total,
                                   degraded_tiles=total, gap=True,
                                   late=work.late)
        # wait for the changed tiles outside the lock, fold them into the
        # cache under it
        fresh: List[Optional[Detections]] = [None] * total
        computed = degraded = 0
        if not work.gap:
            for t, tf in enumerate(work.tile_futs):
                if tf is None:
                    continue
                try:
                    fresh[t] = tf.result()
                    computed += 1
                except Exception:  # noqa: BLE001 - fall back to the cache
                    degraded += 1
        with self._lock:
            for t, det in enumerate(fresh):
                if det is not None:
                    self._tile_cache[t] = smooth_tile(
                        det, self._tile_cache[t], self.ema,
                        self.track_radius)
            if degraded:
                self._stats["degraded_tiles"] += degraded
            dets = [c if c is not None else _EMPTY_TILE
                    for c in self._tile_cache]
        frame_det = stitch_detections(dets, self.origins)
        return FrameResult(work.seq, frame_det, computed, total,
                           degraded_tiles=degraded, gap=work.gap,
                           late=work.late)

    # ----------------------------------------------------------------- admin

    def stats(self) -> dict:
        with self._lock:
            st = dict(self._stats)
            t0 = self._t0
        seen = st["computed_tiles"] + st["skipped_tiles"]
        st["tile_skip_rate"] = (round(st["skipped_tiles"] / seen, 4)
                                if seen else None)
        st["fps"] = (round(st["delivered"]
                           / max(time.monotonic() - t0, 1e-9), 2)
                     if t0 is not None and st["delivered"] else None)
        return st

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted frame has delivered."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._stats["delivered"] >= self._stats["frames"]:
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("stream %d did not drain" % self.sid)
            time.sleep(0.002)

    def close(self) -> None:
        self.drain()
        with self._lock:
            self._closed = True
        self._q.put(None)  # wake the delivery thread to exit
        self._deliver_thread.join(timeout=5.0)
