"""Train input pipeline: collation, shuffling, threaded prefetch, and
the device side of the input: staging ahead of the step and the
device-resident dataset.

A copy of ref real_time_helmet_detection_tpu/data/pipeline.py (reference
data.py:93-125 `collate_fn` and the DataLoader of reference
train.py:54-55), one process per card:

* `seed_augmentor_for_batch` (ref pipeline.py:70): every batch's
  augmentation is a pure function of (seed, epoch, batch index), so one
  batch coordinate gives the same batch in the JAX package and here, and
  in the thread and the process loader (data/shm_pool.py);
* `pad_boxes` / `collate` (ref pipeline.py:90, :122): batch-level
  augmentation, GT encoding at the batch's shared size over at most
  `max_boxes` boxes per image, normalization and stacking —
  channels-last numpy, the padded boxes, labels and validity riding
  along. The loaders encode with the native encoder
  (`encode_native.encode_boxes_batch_native`, JAX's collate default);
  `collate(native=False)` keeps the numpy encoder (ops/encode.py).
  `raw=True` (`--device-augment`) leaves the uint8 canvases
  un-normalized and encodes nothing. `alloc` lets the process loader's
  workers build the arrays inside a shared-memory segment;
* `epoch_indices` (ref pipeline.py:206): the (seed, epoch)-keyed
  permutation and a rank's wrap-padded shard of it;
* `BatchLoader` (ref pipeline.py:225): worker threads decode and augment
  ahead of the consumer through a bounded queue; `drop_last` keeps the
  batch size fixed;
* `StagedBatch` / `DevicePrefetcher` (ref pipeline.py:338-386,
  `--device-prefetch N`): the step's host-to-device copies of the next N
  batches, issued on a side CUDA stream while the current step runs.
  Before a staged batch is handed over, the compute stream waits on the
  event recorded after its copies, and every staged tensor
  `record_stream`s the compute stream, so the caching allocator does not
  recycle it while the step reads it; the pinned host copies are
  PyTorch's caching host allocator's, which keeps each block until the
  copy reading it has completed;
* `DeviceDatasetCache` (ref pipeline.py:389, `--cache-device`): every
  sample decoded and resized once, the uint8 canvases and padded boxes
  staged on the card; iterating yields (B,) int32 index vectors in
  `BatchLoader`'s order, and the step gathers its batch on the card;
* `load_dataset` (ref pipeline.py:477).

This module imports no torch at import time (the process loader's
workers import it); the device classes import it where they run.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from ..utils import normalize_image
from .encode_native import encode_boxes_batch_native


@dataclass
class Batch:
    """One training batch, channels-last numpy."""
    image: np.ndarray     # (B, S, S, 3) float32 normalized (raw: uint8)
    heatmap: np.ndarray   # (B, S/4, S/4, num_cls) (raw: (B, 0, 0, 0))
    offset: np.ndarray    # (B, S/4, S/4, 2)
    wh: np.ndarray        # (B, S/4, S/4, 2)
    mask: np.ndarray      # (B, S/4, S/4, 1)
    infos: List[dict]     # per-image voc dicts
    boxes: Optional[np.ndarray] = None   # (B, max_boxes, 4) padded xyxy
    labels: Optional[np.ndarray] = None  # (B, max_boxes) int32
    valid: Optional[np.ndarray] = None   # (B, max_boxes) bool


_overflow_warned = False
# pad_boxes runs in the loader's worker threads: the warn-once
# check-then-set must be atomic
_overflow_warn_lock = threading.Lock()


def seed_augmentor_for_batch(augmentor, seed: int, epoch: int,
                             batch_idx: int) -> None:
    """Reseed the augmentor's generator from (seed, epoch, batch_idx)."""
    augmentor.rng = np.random.default_rng(
        np.random.SeedSequence((seed, epoch, batch_idx)))


def pad_boxes(boxes: np.ndarray, labels: np.ndarray, max_boxes: int):
    """(boxes (max_boxes, 4), labels (max_boxes,), valid (max_boxes,)):
    the first `max_boxes` boxes, zero-padded; warns once when an image
    has more."""
    global _overflow_warned
    n = min(len(boxes), max_boxes)
    if len(boxes) > max_boxes:
        with _overflow_warn_lock:
            first = not _overflow_warned
            _overflow_warned = True
        if first:  # warn outside the lock
            import warnings
            warnings.warn(
                "image with %d boxes exceeds --max-boxes %d; the excess "
                "boxes lose heatmap/offset supervision (raise --max-boxes)"
                % (len(boxes), max_boxes), stacklevel=2)
    b = np.zeros((max_boxes, 4), np.float32)
    lb = np.zeros((max_boxes,), np.int32)
    v = np.zeros((max_boxes,), bool)
    b[:n], lb[:n], v[:n] = boxes[:n], labels[:n], True
    return b, lb, v


def _stack_into(alloc, name: str, arrays) -> np.ndarray:
    """np.stack, or into `alloc`-provided storage."""
    if alloc is None:
        return np.stack(arrays)
    out = alloc(name, (len(arrays),) + tuple(arrays[0].shape),
                arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i] = a
    return out


def collate(samples: Sequence, augmentor, pretrained: str = "imagenet",
            num_cls: int = 2, normalized_coord: bool = False,
            scale_factor: int = 4, max_boxes: int = 128,
            raw: bool = False, native: bool = False, alloc=None) -> Batch:
    """samples: list of (img, boxes, labels, voc_dict) from `VOCDataset`.

    `native` encodes with the native encoder (one call for the batch),
    else with the numpy one; `raw` keeps the uint8 canvases and encodes
    nothing (the fused device step augments and encodes). `alloc(name,
    shape, dtype) -> writable zero-initialized array` places the output
    arrays (the process loader's shared-memory segment); the bytes are
    the same either way (ref pipeline.py:122)."""
    imgs, boxes, labels, infos = zip(*samples)
    imgs, boxes, labels = augmentor(list(imgs), list(boxes), list(labels))
    size = imgs[0].shape[0]  # square; shared across the batch
    pb_, pl_, pv_ = zip(*(pad_boxes(b, lb, max_boxes)
                          for b, lb in zip(boxes, labels)))
    pb = _stack_into(alloc, "boxes", pb_)
    pl = _stack_into(alloc, "labels", pl_)
    pv = _stack_into(alloc, "valid", pv_)
    b = len(imgs)
    if raw:
        # uint8 on the wire: the device step casts on the card
        image = _stack_into(alloc, "image", imgs)
        empties = [np.zeros((b, 0, 0, 0), np.float32) if alloc is None
                   else alloc(n, (b, 0, 0, 0), np.float32)
                   for n in ("heatmap", "offset", "wh", "mask")]
        return Batch(image, *empties, infos=list(infos), boxes=pb,
                     labels=pl, valid=pv)
    m = size // scale_factor
    maps_out = None if alloc is None else tuple(
        alloc(n, (b, m, m, c), np.float32)
        for n, c in (("heatmap", num_cls), ("offset", 2), ("wh", 2),
                     ("mask", 1)))
    if native:
        counts = pv.sum(axis=1).astype(np.int32)
        heat, off, wh, mask = encode_boxes_batch_native(
            pb, pl, counts, (size, size), scale_factor, num_cls,
            normalized_coord, out=maps_out)
    else:
        from ..ops.encode import encode_boxes_batch
        maps = encode_boxes_batch([pb[i][pv[i]] for i in range(b)],
                                  [pl[i][pv[i]] for i in range(b)],
                                  (size, size), scale_factor, num_cls,
                                  normalized_coord)
        if maps_out is not None:
            for dst, src in zip(maps_out, maps):
                dst[...] = src
            maps = maps_out
        heat, off, wh, mask = maps
    if alloc is None:
        image = np.stack([normalize_image(im, pretrained) for im in imgs])
    else:
        image = alloc("image", (b, size, size, 3), np.float32)
        for i, im in enumerate(imgs):
            image[i] = normalize_image(im, pretrained)
    return Batch(image=image, heatmap=heat, offset=off, wh=wh, mask=mask,
                 infos=list(infos), boxes=pb, labels=pl, valid=pv)


def epoch_indices(n: int, seed: int, epoch: int, shuffle: bool = True,
                  rank: int = 0, world_size: int = 1) -> np.ndarray:
    """The (seed, epoch)-keyed permutation of range(n), wrap-padded to a
    multiple of `world_size` so every rank gets as many samples, and this
    rank's shard `idx[rank::world_size]` (the DistributedSampler
    contract, ref pipeline.py:206)."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(idx)
    total = -(-len(idx) // world_size) * world_size
    if total > len(idx) and len(idx) > 0:
        idx = np.concatenate([idx, idx[:total - len(idx)]])
    return idx[rank::world_size]


class BatchLoader:
    """Sharded, shuffled, prefetching batch iterator (ref pipeline.py:225):
    this rank's `epoch_indices` shard in batches of `batch_size` (the
    rank's share of the global batch); worker threads decode, augment and
    encode up to `prefetch` batches ahead. Batch i of every rank draws
    its augmentation from the same (seed, epoch, i), encoded by the
    native encoder; `raw` is `collate`'s."""

    def __init__(self, dataset, augmentor, batch_size: int,
                 pretrained: str = "imagenet", num_cls: int = 2,
                 normalized_coord: bool = False, scale_factor: int = 4,
                 max_boxes: int = 128, shuffle: bool = True,
                 drop_last: bool = True, rank: int = 0, world_size: int = 1,
                 seed: int = 777, num_workers: int = 4, prefetch: int = 2,
                 raw: bool = False):
        self.dataset = dataset
        self.augmentor = augmentor
        self.batch_size = batch_size
        self.kw = dict(pretrained=pretrained, num_cls=num_cls,
                       normalized_coord=normalized_coord,
                       scale_factor=scale_factor, max_boxes=max_boxes,
                       raw=raw, native=True)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank, self.world_size = rank, world_size
        self.seed = seed
        self.epoch = 0
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        return epoch_indices(len(self.dataset), self.seed, self.epoch,
                             shuffle=self.shuffle, rank=self.rank,
                             world_size=self.world_size)

    def __len__(self) -> int:
        n = len(self._indices())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def make_batch(self, pool: ThreadPoolExecutor, idx_chunk, epoch: int,
                   batch_idx: int) -> Batch:
        samples = list(pool.map(self.dataset.__getitem__, idx_chunk))
        seed_augmentor_for_batch(self.augmentor, self.seed, epoch, batch_idx)
        return collate(samples, self.augmentor, **self.kw)

    def chunks(self) -> List[np.ndarray]:
        """This epoch's batches of dataset indices."""
        idx = self._indices()
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[Batch]:
        epoch = self.epoch
        chunks = self.chunks()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a blocking put would deadlock a producer whose consumer has
            # left; poll so `stop` is always observed
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, chunk in enumerate(chunks):
                        if stop.is_set():
                            return
                        if not put(self.make_batch(pool, chunk, epoch, bi)):
                            return
                put(None)
            except BaseException as e:  # surface decode/augment failures
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


@dataclass
class StagedBatch:
    """A host batch whose device copies are issued: `arrays` the step's
    device tensors, `host` the batch they came from."""
    arrays: Any
    host: Any


class DevicePrefetcher:
    """Stage each item of `iterable` with `stage(item) -> tuple of device
    tensors` up to `depth` items ahead of the consumer (ref
    pipeline.py:353). On a CUDA `device` the copies run on a side stream
    (see the module docstring for the stream discipline); elsewhere
    `stage` runs in line."""

    def __init__(self, iterable, stage, depth: int = 1, device=None):
        self.iterable = iterable
        self.stage = stage
        self.depth = max(1, int(depth))
        self.device = device

    def __len__(self) -> int:
        return len(self.iterable)

    def __iter__(self) -> Iterator[StagedBatch]:
        from collections import deque

        import torch
        cuda = self.device is not None and \
            torch.device(self.device).type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        buf: deque = deque()

        def issue(item):
            if side is None:
                return StagedBatch(self.stage(item), item), None
            with torch.cuda.stream(side):
                arrays = self.stage(item)
                done = torch.cuda.Event()
                done.record(side)
            return StagedBatch(arrays, item), done

        def hand_over(staged, done):
            if done is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                for t in staged.arrays:
                    t.record_stream(compute)
            return staged

        for item in self.iterable:
            buf.append(issue(item))
            if len(buf) > self.depth:
                yield hand_over(*buf.popleft())
        while buf:
            yield hand_over(*buf.popleft())


class DeviceDatasetCache:
    """The dataset on the card for `--cache-device` (ref pipeline.py:389):
    every sample decoded and resized once by `augmentor` (deterministic:
    `augment.TestAugmentor`), its uint8 canvas and padded boxes, labels
    and validity staged on `device` (`images`, `boxes`, `labels`,
    `valid`). Iterating yields the (B,) int32 dataset indices of each
    batch, in `BatchLoader`'s order (`epoch_indices`); `nbytes` is its
    device footprint."""

    def __init__(self, dataset, augmentor, batch_size: int,
                 max_boxes: int = 128, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 777,
                 num_workers: int = 4, device="cpu"):
        import torch
        n = len(dataset)
        probe, bx, lb, _ = dataset[0]
        (probe,), _, _ = augmentor([probe], [bx], [lb])
        canvas = probe.shape[0]
        # one host copy of the canvases at a time: workers fill their slot
        images = np.empty((n, canvas, canvas, 3), np.uint8)
        boxes = np.zeros((n, max_boxes, 4), np.float32)
        labels = np.zeros((n, max_boxes), np.int32)
        valid = np.zeros((n, max_boxes), bool)
        self.infos: List[Optional[dict]] = [None] * n

        def load_one(i):
            img, b, lab, info = dataset[i]
            (img,), (b,), (lab,) = augmentor([img], [b], [lab])
            images[i] = img
            boxes[i], labels[i], valid[i] = pad_boxes(b, lab, max_boxes)
            self.infos[i] = info

        with ThreadPoolExecutor(max(1, num_workers)) as pool:
            list(pool.map(load_one, range(n)))
        self.device = torch.device(device)
        self.images, self.boxes, self.labels, self.valid = (
            torch.from_numpy(a).to(self.device)
            for a in (images, boxes, labels, valid))
        self.nbytes = sum(a.nbytes for a in (images, boxes, labels, valid))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = int(self.images.shape[0])
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = epoch_indices(int(self.images.shape[0]), self.seed,
                            self.epoch, shuffle=self.shuffle)
        if not self.drop_last and len(idx) % self.batch_size:
            pad = self.batch_size - len(idx) % self.batch_size
            idx = np.concatenate([idx, idx[:pad]])
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size].astype(
                np.int32)

    def alive(self) -> bool:
        """Can the staged canvases still be read? (one tiny read back)"""
        try:
            int(self.images[:1, :1, :1].sum().item())
            return True
        except RuntimeError:
            return False


def load_dataset(cfg, rng: Optional[np.random.Generator] = None):
    """(trainval dataset, TrainAugmentor) from the config
    (ref pipeline.py:477; reference data.py:172-189)."""
    from .augment import TrainAugmentor
    from .voc import VOCDataset
    augmentor = TrainAugmentor(
        crop_percent=tuple(cfg.crop_percent),
        color_multiply=tuple(cfg.color_multiply),
        translate_percent=cfg.translate_percent,
        affine_scale=tuple(cfg.affine_scale),
        multiscale_flag=cfg.multiscale_flag, multiscale=cfg.multiscale,
        rng=rng or np.random.default_rng(cfg.random_seed))
    return VOCDataset(cfg.data, image_set="trainval"), augmentor
