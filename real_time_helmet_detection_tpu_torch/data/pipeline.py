"""Train input pipeline: collation, shuffling, threaded prefetch.

A copy of the host path of ref real_time_helmet_detection_tpu/data/
pipeline.py (reference data.py:93-125 `collate_fn` and the DataLoader of
reference train.py:54-55), one process per card:

* `seed_augmentor_for_batch` (ref pipeline.py:70): every batch's
  augmentation is a pure function of (seed, epoch, batch index), so one
  batch coordinate gives the same batch in the JAX package and here;
* `pad_boxes` / `collate` (ref pipeline.py:90, :122): batch-level
  augmentation, GT encoding with the numpy encoder (ops/encode.py) at the
  batch's shared size over at most `max_boxes` boxes per image,
  normalization and stacking — channels-last numpy;
* `epoch_indices` (ref pipeline.py:206): the (seed, epoch)-keyed
  permutation and a rank's wrap-padded shard of it;
* `BatchLoader` (ref pipeline.py:225): worker threads decode and augment
  ahead of the consumer through a bounded queue; `drop_last` keeps the
  batch size fixed;
* `load_dataset` (ref pipeline.py:477).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..ops.encode import encode_boxes_batch
from ..utils import normalize_image


@dataclass
class Batch:
    """One training batch, channels-last numpy."""
    image: np.ndarray     # (B, S, S, 3) float32 normalized
    heatmap: np.ndarray   # (B, S/4, S/4, num_cls)
    offset: np.ndarray    # (B, S/4, S/4, 2)
    wh: np.ndarray        # (B, S/4, S/4, 2)
    mask: np.ndarray      # (B, S/4, S/4, 1)
    infos: List[dict]     # per-image voc dicts


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


def collate(samples: Sequence, augmentor, pretrained: str = "imagenet",
            num_cls: int = 2, normalized_coord: bool = False,
            scale_factor: int = 4, max_boxes: int = 128) -> Batch:
    """samples: list of (img, boxes, labels, voc_dict) from `VOCDataset`."""
    imgs, boxes, labels, infos = zip(*samples)
    imgs, boxes, labels = augmentor(list(imgs), list(boxes), list(labels))
    size = imgs[0].shape[0]  # square; shared across the batch
    kept_boxes, kept_labels = [], []
    for b, lb in zip(boxes, labels):
        pb, pl, pv = pad_boxes(b, lb, max_boxes)
        kept_boxes.append(pb[pv])
        kept_labels.append(pl[pv])
    heat, off, wh, mask = encode_boxes_batch(
        kept_boxes, kept_labels, (size, size), scale_factor, num_cls,
        normalized_coord)
    image = np.stack([normalize_image(im, pretrained) for im in imgs])
    return Batch(image=image, heatmap=heat, offset=off, wh=wh, mask=mask,
                 infos=list(infos))


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
    its augmentation from the same (seed, epoch, i)."""

    def __init__(self, dataset, augmentor, batch_size: int,
                 pretrained: str = "imagenet", num_cls: int = 2,
                 normalized_coord: bool = False, scale_factor: int = 4,
                 max_boxes: int = 128, shuffle: bool = True,
                 drop_last: bool = True, rank: int = 0, world_size: int = 1,
                 seed: int = 777, num_workers: int = 4, prefetch: int = 2):
        self.dataset = dataset
        self.augmentor = augmentor
        self.batch_size = batch_size
        self.kw = dict(pretrained=pretrained, num_cls=num_cls,
                       normalized_coord=normalized_coord,
                       scale_factor=scale_factor, max_boxes=max_boxes)
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

    def __iter__(self) -> Iterator[Batch]:
        epoch = self.epoch
        idx = self._indices()
        chunks = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(len(self))]
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
