"""Process-based shared-memory input pipeline (`--loader process`).

Port of ref real_time_helmet_detection_tpu/data/shm_pool.py:153-519
(the reference's `DataLoader(num_workers=N)`, its train.py:39):
`ProcessBatchLoader`, a `BatchLoader` whose batches are produced by
worker processes instead of threads, so the numpy stages of decode,
augment, encode and normalize scale over the host's cores without the
interpreter lock.

* Workers come from the spawn context: fork is unsafe once CUDA (or any
  threaded runtime) is initialised in the parent. A worker's import
  chain is numpy, PIL and the standard library (this module, `pipeline`,
  `augment`, `voc`, `encode_native`): it never imports torch or touches
  a card.
* Each batch is built inside its own POSIX shared-memory segment:
  `collate` gets an allocator that carves its output arrays out of the
  segment, the worker sends only the layout and the VOC dicts, and the
  parent maps the segment read-only and yields numpy views. The parent
  unlinks the name the moment it has mapped it (the pages live as long
  as the views) and removes it from `resource_tracker`; a sweep by the
  loader's name prefix removes whatever a killed worker left.
* Batches are bit-identical to the thread loader's: both reseed the
  augmentor per (seed, epoch, batch index) and both encode with the
  native encoder.
* A Python exception in a worker reaches the consumer as the thread
  loader's would. A worker that dies (killed, out of memory) makes the
  loader tear the pool down and produce the rest of the run in-process
  on the thread path, with the same bytes: logged, and counted in
  `fallbacks` and on the `train.loader_fallbacks` counter.
* `quarantine=True` (train's `--sentinel`): a produced batch with a
  non-finite float drops before the step, counted in `quarantined` (the
  `train.quarantined_batches` gauge at the end of training) and written
  as a `recover:quarantine` span-log event.
* `worker_status()` gives the `HangWatchdog` each worker's liveness and
  heartbeat age.
"""

from __future__ import annotations

import glob
import mmap
import os
import queue as queue_mod
import time
import traceback
import uuid
import weakref
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import get_context
from multiprocessing.shared_memory import SharedMemory
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .pipeline import Batch, BatchLoader, collate, seed_augmentor_for_batch

_ALIGN = 64      # field alignment inside a segment
_SHM_DIR = "/dev/shm"


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _max_canvas(augmentor, dataset) -> int:
    """The largest square canvas the augmentor can emit: TrainAugmentor's
    `max_size`, TestAugmentor's `imsize`, else a probe of sample 0."""
    for attr in ("max_size", "imsize"):
        v = getattr(augmentor, attr, None)
        if v:
            return int(v)
    img, bx, lb, _ = dataset[0]
    (img,), _, _ = augmentor([img], [bx], [lb])
    return int(max(img.shape[:2]))


def _segment_capacity(batch_size: int, canvas: int, num_cls: int,
                      scale_factor: int, max_boxes: int, raw: bool) -> int:
    """Bytes one segment needs for the largest batch (pages are only
    materialized when written)."""
    b, t = batch_size, canvas
    m = -(-t // scale_factor)
    total = 0
    if raw:
        total += _aligned(b * t * t * 3)
    else:
        total += _aligned(b * t * t * 3 * 4)
        total += _aligned(b * m * m * num_cls * 4)
        total += 2 * _aligned(b * m * m * 2 * 4)
        total += _aligned(b * m * m * 4)
    total += _aligned(b * max_boxes * 4 * 4)
    total += _aligned(b * max_boxes * 4)
    total += _aligned(b * max_boxes)
    return total + 4096


class _SegmentArena:
    """A worker's allocator over one batch's segment: zero-initialized
    views (fresh pages are zeroed) and the (field, shape, dtype, offset)
    layout the parent maps back."""

    def __init__(self, name: str, capacity: int):
        self.shm = SharedMemory(create=True, name=name, size=capacity)
        self.offset = 0
        self.meta: List[Tuple] = []

    def alloc(self, field: str, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        if self.offset + nbytes > self.shm.size:
            raise ValueError(
                "batch (%d bytes at field %r) exceeds the shared-memory "
                "segment's %d bytes: the augmentor made a larger canvas "
                "than its max_size/imsize" % (self.offset + nbytes, field,
                                              self.shm.size))
        arr = np.frombuffer(self.shm.buf, dtype, count=count,
                            offset=self.offset).reshape(shape)
        self.meta.append((field, tuple(shape), dtype.str, self.offset))
        self.offset = _aligned(self.offset + nbytes)
        return arr

    def close(self) -> None:
        try:
            self.shm.close()
        except BufferError:  # a stray view survives: freed at exit
            pass


def _unlink_segment(name: str) -> None:
    """Remove a segment's file and its resource_tracker registration;
    idempotent."""
    try:
        os.unlink(os.path.join(_SHM_DIR, name))
    except FileNotFoundError:
        return
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:  # noqa: BLE001 — bookkeeping only; the file is gone
        pass


def _map_batch(meta: Sequence[Tuple], name: str, infos: List[dict]) -> Batch:
    """The batch as read-only views of the mapped segment."""
    with open(os.path.join(_SHM_DIR, name), "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    fields = {}
    for fname, shape, dtype_str, offset in meta:
        count = int(np.prod(shape, dtype=np.int64))
        fields[fname] = np.frombuffer(mm, np.dtype(dtype_str), count=count,
                                      offset=offset).reshape(shape)
    return Batch(infos=infos, **fields)


def _worker_main(task_q, result_q, dataset, augmentor, collate_kw,
                 seed: int, heartbeat, capacity: int) -> None:
    """A worker: pull (batch index, epoch, segment name, indices), build
    the batch in the named segment, send its layout."""
    while True:
        task = task_q.get()
        if task is None:
            break
        batch_idx, epoch, seg_name, indices = task
        heartbeat.value = time.monotonic()
        arena = None
        batch = None
        try:
            samples = [dataset[int(i)] for i in indices]
            seed_augmentor_for_batch(augmentor, seed, epoch, batch_idx)
            arena = _SegmentArena(seg_name, capacity)
            batch = collate(samples, augmentor, alloc=arena.alloc,
                            **collate_kw)
            result_q.put(("ok", batch_idx, seg_name, arena.meta,
                          batch.infos))
        except BaseException:  # noqa: BLE001 — sent on to the parent
            result_q.put(("err", batch_idx, seg_name,
                          traceback.format_exc(), None))
            if arena is not None:  # destroy the failed batch's segment
                batch = None
                arena.close()
                try:
                    SharedMemory(name=seg_name).unlink()
                except Exception:  # noqa: BLE001
                    pass
                arena = None
        finally:
            batch = None  # drop the views before the mapping
            if arena is not None:
                arena.close()
        heartbeat.value = time.monotonic()


def _cleanup(procs, prefix: str, task_q, result_q) -> None:
    """Terminate the workers, close the queues, sweep every segment under
    `prefix` (module level, so `weakref.finalize` keeps no loader
    alive)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5)
    for q in (task_q, result_q):
        if q is not None:
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:  # noqa: BLE001
                pass
    for path in glob.glob(os.path.join(_SHM_DIR, prefix + "*")):
        _unlink_segment(os.path.basename(path))


class ProcessBatchLoader(BatchLoader):
    """`BatchLoader` over spawned worker processes and shared memory (ref
    shm_pool.py:241): the same constructor and batches, plus
    `quarantine`. The pool starts at the first iteration and lives
    across epochs; `close()` (or garbage collection) ends it."""

    def __init__(self, *args, quarantine: bool = False, **kw):
        super().__init__(*args, **kw)
        self.quarantine = bool(quarantine)
        self.quarantined = 0
        self.fallbacks = 0
        from ..obs.spans import maybe_tracer
        self._obs = maybe_tracer() if quarantine else None
        self._ctx = get_context("spawn")
        self._procs: List = []
        self._heartbeats: List = []
        self._task_q = None
        self._result_q = None
        self._capacity = 0
        self._prefix = "helmet_shm_%d_%s" % (os.getpid(),
                                             uuid.uuid4().hex[:8])
        self._iter_seq = 0
        self._fell_back = False
        self._finalizer = None

    # -- pool lifecycle

    def _start_pool(self) -> None:
        if not os.path.isdir(_SHM_DIR):
            raise OSError("%s not available (POSIX shared memory)"
                          % _SHM_DIR)
        canvas = _max_canvas(self.augmentor, self.dataset)
        self._capacity = _segment_capacity(
            self.batch_size, canvas, self.kw["num_cls"],
            self.kw["scale_factor"], self.kw["max_boxes"], self.kw["raw"])
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        for _ in range(self.num_workers):
            hb = self._ctx.Value("d", 0.0, lock=False)
            p = self._ctx.Process(
                target=_worker_main,
                args=(self._task_q, self._result_q, self.dataset,
                      self.augmentor, self.kw, self.seed, hb,
                      self._capacity),
                daemon=True)
            p.start()
            self._procs.append(p)
            self._heartbeats.append(hb)
        self._finalizer = weakref.finalize(
            self, _cleanup, list(self._procs), self._prefix,
            self._task_q, self._result_q)

    def _stop_pool(self) -> None:
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        _cleanup(self._procs, self._prefix, self._task_q, self._result_q)
        self._procs = []
        self._heartbeats = []
        self._task_q = None
        self._result_q = None

    def close(self) -> None:
        """End the workers and sweep in-flight segments; batches already
        yielded stay valid."""
        self._stop_pool()

    def worker_status(self) -> str:
        """One line of worker health for the HangWatchdog's warning."""
        if not self._procs:
            return "loader: process pool not started" + (
                " (FELL-BACK-TO-THREAD)" if self._fell_back else "")
        now = time.monotonic()
        parts = []
        for i, (p, hb) in enumerate(zip(self._procs, self._heartbeats)):
            age = ("%.0fs" % (now - hb.value)) if hb.value else "never"
            parts.append("w%d=%s/hb:%s" % (i, "up" if p.is_alive()
                                           else "DEAD", age))
        if self.quarantined:
            parts.append("quarantined:%d" % self.quarantined)
        return "loader workers: " + " ".join(parts)

    # -- poison-batch quarantine

    def _quarantine_batch(self, batch: Batch, batch_idx: int,
                          epoch: int) -> bool:
        """True if `batch` holds a non-finite float (and was counted)."""
        if not self.quarantine:
            return False
        for name in ("image", "heatmap", "offset", "wh", "boxes"):
            arr = getattr(batch, name, None)
            if not (isinstance(arr, np.ndarray) and arr.dtype.kind == "f"
                    and arr.size):
                continue
            if not np.isfinite(arr).all():
                self.quarantined += 1
                print("process loader: QUARANTINED poisoned batch %d "
                      "(epoch %d): non-finite values in %r (total "
                      "quarantined: %d)" % (batch_idx, epoch, name,
                                            self.quarantined), flush=True)
                if self._obs is not None:
                    self._obs.event("recover:quarantine", batch=batch_idx,
                                    epoch=epoch, field=name)
                return True
        return False

    # -- iteration

    def _fallback_batches(self, chunks, start: int,
                          epoch: int) -> Iterator[Batch]:
        with ThreadPoolExecutor(self.num_workers) as pool:
            for bi in range(start, len(chunks)):
                batch = self.make_batch(pool, chunks[bi], epoch, bi)
                if self._quarantine_batch(batch, bi, epoch):
                    continue
                yield batch

    def _fall_back(self, why: str) -> None:
        from ..obs.metrics import default_registry
        self._fell_back = True
        self.fallbacks += 1
        default_registry().counter("train.loader_fallbacks").inc()
        print("process loader: %s; falling back to the thread loader for "
              "the rest of the run (fallback %d)" % (why, self.fallbacks),
              flush=True)

    def __iter__(self) -> Iterator[Batch]:
        epoch = self.epoch
        chunks = self.chunks()
        nb = len(chunks)
        if self._fell_back:
            yield from self._fallback_batches(chunks, 0, epoch)
            return
        if not self._procs:
            try:
                self._start_pool()
            except OSError as e:
                self._stop_pool()
                self._fall_back("pool start failed (%s)" % e)
                yield from self._fallback_batches(chunks, 0, epoch)
                return
        self._iter_seq += 1
        prefix = "%s_i%d_b" % (self._prefix, self._iter_seq)
        # batches in flight: the workers (no more than the cores) plus
        # queue headroom
        cores = os.cpu_count() or 1
        window = max(1, min(self.num_workers, cores)) + (
            max(1, self.prefetch) if cores > 1 else 0)
        outstanding = {}    # batch index -> segment name
        ready = {}          # batch index -> mapped Batch
        next_dispatch = next_emit = 0
        clean = False
        try:
            while next_emit < nb:
                while len(outstanding) < window and next_dispatch < nb:
                    name = prefix + str(next_dispatch)
                    outstanding[next_dispatch] = name
                    self._task_q.put((next_dispatch, epoch, name,
                                      chunks[next_dispatch]))
                    next_dispatch += 1
                if next_emit in ready:
                    batch = ready.pop(next_emit)
                    bi = next_emit
                    next_emit += 1
                    if not self._quarantine_batch(batch, bi, epoch):
                        yield batch
                    continue
                try:
                    kind, bi, name, payload, infos = \
                        self._result_q.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(self._procs)
                            if not p.is_alive()]
                    if dead:
                        self._stop_pool()
                        self._fall_back("worker(s) %s died" % dead)
                        yield from self._fallback_batches(chunks, next_emit,
                                                          epoch)
                        clean = True
                        return
                    continue
                if kind == "err":
                    raise RuntimeError("process loader worker failed:\n%s"
                                       % payload)
                ready[bi] = _map_batch(payload, name, infos)
                _unlink_segment(name)
                outstanding.pop(bi, None)
            clean = True
        finally:
            if not clean:
                # the consumer left mid-epoch: queued tasks are stale
                self._stop_pool()
            else:
                for name in outstanding.values():
                    _unlink_segment(name)
