"""Training augmentation with joint image/box transforms.

A copy of ref real_time_helmet_detection_tpu/data/augment.py:86
`TrainAugmentor`, :153 `TestAugmentor` (the deterministic square resize
the `--device-augment` paths load with) and their helpers `transform_boxes`, `apply_affine_image`
and `filter_boxes` (reference data.py:127-161): color multiply, centered
affine (scale + translate), crop-and-keep-size, horizontal flip p=0.5 and
the final square resize, composed into one 3x3 matrix per image that is
applied once to the pixels (PIL bilinear affine) and exactly to the boxes
(corner transform -> axis-aligned envelope). The target size is drawn
once per batch from `range(min, max, step)` (max excluded) under
`--multiscale-flag`, else it is the max.

All randomness flows through an explicit `np.random.Generator`, drawn in
the JAX package's order, so one generator state gives the same batch on
both sides.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def _translation(tx: float, ty: float) -> np.ndarray:
    m = np.eye(3, dtype=np.float64)
    m[0, 2], m[1, 2] = tx, ty
    return m


def _scaling(sx: float, sy: float) -> np.ndarray:
    return np.diag([sx, sy, 1.0]).astype(np.float64)


def transform_boxes(boxes: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Map (N, 4) xyxy boxes through a 3x3 matrix: the axis-aligned
    envelope of the 4 transformed corners."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4).astype(np.float32)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], -1), np.stack([x2, y1], -1),
        np.stack([x2, y2], -1), np.stack([x1, y2], -1),
    ], axis=1)  # (N, 4, 2)
    ones = np.ones((*corners.shape[:2], 1))
    pts = np.concatenate([corners, ones], axis=-1) @ m.T  # (N, 4, 3)
    xy = pts[..., :2] / pts[..., 2:3]
    return np.concatenate([xy.min(axis=1), xy.max(axis=1)],
                          axis=-1).astype(np.float32)


def apply_affine_image(img: np.ndarray, m: np.ndarray,
                       out_size: Tuple[int, int]) -> np.ndarray:
    """Warp an (H, W, 3) uint8 image by forward matrix `m` into
    (out_h, out_w); PIL's AFFINE takes the inverse (output->input) map."""
    inv = np.linalg.inv(m)
    coeffs = (inv[0, 0], inv[0, 1], inv[0, 2], inv[1, 0], inv[1, 1],
              inv[1, 2])
    out_w, out_h = int(out_size[0]), int(out_size[1])
    pil = Image.fromarray(img).transform((out_w, out_h), Image.AFFINE,
                                         coeffs, resample=Image.BILINEAR)
    return np.asarray(pil)


def filter_boxes(boxes: np.ndarray, labels: np.ndarray,
                 size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Drop boxes fully outside the (w, h) canvas, clip the rest, and drop
    boxes that clipping collapsed to zero extent."""
    if len(boxes) == 0:
        return boxes, labels
    w, h = size
    keep = ((boxes[:, 2] > 0) & (boxes[:, 0] < w)
            & (boxes[:, 3] > 0) & (boxes[:, 1] < h))
    boxes, labels = boxes[keep].copy(), labels[keep]
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return boxes[keep], labels[keep]


class TrainAugmentor:
    """Batch-level training augmentation (ref augment.py:86)."""

    def __init__(self, crop_percent=(0.0, 0.1), color_multiply=(1.2, 1.5),
                 translate_percent: float = 0.1, affine_scale=(0.5, 1.5),
                 multiscale_flag: bool = False,
                 multiscale: Sequence[int] = (320, 512, 64),
                 rng: Optional[np.random.Generator] = None):
        self.crop_percent = tuple(crop_percent)
        self.color_multiply = tuple(color_multiply)
        self.translate_percent = translate_percent
        self.affine_scale = tuple(affine_scale)
        self.multiscale_flag = multiscale_flag
        self.sizes = list(range(multiscale[0], multiscale[1], multiscale[2]))
        self.max_size = multiscale[1]
        self.rng = rng or np.random.default_rng()

    def sample_size(self) -> int:
        if self.multiscale_flag:
            return int(self.rng.choice(self.sizes))
        return int(self.max_size)

    def _sample_matrix(self, w: int, h: int, target: int) -> np.ndarray:
        rng = self.rng
        # centered affine: scale about the center + translate by a fraction
        s = rng.uniform(*self.affine_scale)
        tx = rng.uniform(-self.translate_percent, self.translate_percent) * w
        ty = rng.uniform(-self.translate_percent, self.translate_percent) * h
        affine = (_translation(w / 2 + tx, h / 2 + ty)
                  @ _scaling(s, s)
                  @ _translation(-w / 2, -h / 2))
        # crop-and-keep-size: per-side fractions, then zoom back to (w, h)
        lo, hi = self.crop_percent
        top, right, bottom, left = (rng.uniform(lo, hi) for _ in range(4))
        cw = max(w * (1.0 - left - right), 1.0)
        ch = max(h * (1.0 - top - bottom), 1.0)
        crop = _scaling(w / cw, h / ch) @ _translation(-left * w, -top * h)
        m = crop @ affine
        if rng.random() < 0.5:  # horizontal flip
            m = (_translation(w, 0.0) @ _scaling(-1.0, 1.0)) @ m
        return _scaling(target / w, target / h) @ m

    def __call__(self, images: List[np.ndarray], boxes: List[np.ndarray],
                 labels: List[np.ndarray]):
        target = self.sample_size()
        out_imgs, out_boxes, out_labels = [], [], []
        for img, bxs, lbs in zip(images, boxes, labels):
            h, w = img.shape[:2]
            mult = self.rng.uniform(*self.color_multiply)
            img = np.clip(img.astype(np.float32) * mult, 0,
                          255).astype(np.uint8)
            m = self._sample_matrix(w, h, target)
            out_imgs.append(apply_affine_image(img, m, (target, target)))
            bxs, lbs = filter_boxes(transform_boxes(bxs, m), lbs,
                                    (target, target))
            out_boxes.append(bxs)
            out_labels.append(lbs)
        return out_imgs, out_boxes, out_labels


class TestAugmentor:
    """Deterministic square resize (ref augment.py:153; reference
    data.py:163-170): each image to (imsize, imsize) by PIL bilinear, its
    boxes scaled with it, labels unchanged."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, imsize: int):
        self.imsize = int(imsize)

    def __call__(self, images: List[np.ndarray], boxes: List[np.ndarray],
                 labels: List[np.ndarray]):
        t = self.imsize
        out_imgs, out_boxes = [], []
        for img, bxs in zip(images, boxes):
            h, w = img.shape[:2]
            m = _scaling(t / w, t / h)
            pil = Image.fromarray(img).resize((t, t), Image.BILINEAR)
            out_imgs.append(np.asarray(pil))
            out_boxes.append(transform_boxes(bxs, m))
        return out_imgs, out_boxes, list(labels)
