"""Ground-truth encoding: boxes -> (heatmap, offset, size, mask) target maps.

A copy of the numpy half of the JAX package's ops/encode.py (ref
encode.py:35-120: `gaussian_radius`, `_prepare_boxes`, `encode_boxes`,
`encode_boxes_batch`; reference transform.py:4-70 `box2hm`): channels-last
maps (H, W, C), every box's Gaussian in one broadcast.

Semantics (the JAX package's, verified there against the reference):
  - center index = floor(box_center / scale_factor), clipped to the map
  - offset = fractional part of the scaled center; size = scaled box w/h
  - `normalized=True` divides offsets by `scale_factor` and sizes by the
    map width/height
  - Gaussian radius r = distance from center to a box corner at map scale,
    sigma = r/3, support window clipped to |dx|,|dy| <= int(r)
  - overlapping Gaussians of the same class merge with `max`
  - for coincident centers, the last box in the list wins the
    offset/size/mask scatter
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(xmin: np.ndarray, ymin: np.ndarray, xcen: np.ndarray,
                    ycen: np.ndarray) -> np.ndarray:
    """Half-diagonal Gaussian radius at map scale (ref encode.py:35)."""
    return np.sqrt((xcen - xmin) ** 2 + (ycen - ymin) ** 2)


def _prepare_boxes(boxes, labels, width, height, scale_factor, normalized):
    """Shared scalar precomputation. boxes: (N,4) xyxy at image scale."""
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 4) \
        / float(scale_factor)
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    xmin, ymin, xmax, ymax = boxes.T
    xcen, ycen = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    xind = np.clip(np.floor(xcen).astype(np.int32), 0, width - 1)
    yind = np.clip(np.floor(ycen).astype(np.int32), 0, height - 1)
    xoff, yoff = xcen - xind, ycen - yind
    xsize, ysize = xmax - xmin, ymax - ymin
    if normalized:
        xoff, yoff = xoff / scale_factor, yoff / scale_factor
        xsize, ysize = xsize / width, ysize / height
    radius = gaussian_radius(xmin, ymin, xcen, ycen)
    return labels, xind, yind, xoff, yoff, xsize, ysize, radius


def encode_boxes(boxes, labels, imsize, scale_factor: int = 4,
                 num_cls: int = 2, normalized: bool = False):
    """Encode one image's boxes into dense target maps (ref encode.py:57).

    boxes: (N, 4) xyxy at image scale, or None/empty; labels: (N,) ints in
    [0, num_cls); imsize: (width, height) of the augmented image.

    Returns heatmap (H, W, num_cls), offset (H, W, 2), size (H, W, 2),
    mask (H, W, 1) — float32, channels-last."""
    width = int(imsize[0]) // scale_factor
    height = int(imsize[1]) // scale_factor
    heat = np.zeros((height, width, num_cls), dtype=np.float32)
    offset = np.zeros((height, width, 2), dtype=np.float32)
    size = np.zeros((height, width, 2), dtype=np.float32)
    mask = np.zeros((height, width, 1), dtype=np.float32)
    if boxes is None or len(boxes) == 0:
        return heat, offset, size, mask

    labels, xind, yind, xoff, yoff, xsize, ysize, radius = _prepare_boxes(
        boxes, labels, width, height, scale_factor, normalized)
    # point scatters in order, so the last coincident box wins
    for i in range(labels.shape[0]):
        mask[yind[i], xind[i], 0] = 1.0
        offset[yind[i], xind[i]] = (xoff[i], yoff[i])
        size[yind[i], xind[i]] = (xsize[i], ysize[i])

    # Gaussian splat: (N, H, W) field, windowed to |d| <= int(r), then a
    # per-class max
    ri = np.floor(radius).astype(np.int32)
    ys = np.arange(height, dtype=np.float32)[None, :, None]
    xs = np.arange(width, dtype=np.float32)[None, None, :]
    dy = ys - yind[:, None, None].astype(np.float32)
    dx = xs - xind[:, None, None].astype(np.float32)
    sigma = np.maximum(radius, 1e-6) / 3.0
    g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma)[:, None, None])
    window = (np.abs(dx) <= ri[:, None, None]) \
        & (np.abs(dy) <= ri[:, None, None])
    g = np.where(window, g, 0.0).astype(np.float32)
    for c in range(num_cls):
        sel = labels == c
        if sel.any():
            heat[:, :, c] = np.max(g[sel], axis=0)
    return heat, offset, size, mask


def encode_boxes_batch(boxes_list, labels_list, imsize,
                       scale_factor: int = 4, num_cls: int = 2,
                       normalized: bool = False):
    """Encode a batch (a list per image) and stack to (B, H, W, C) arrays
    (ref encode.py:111)."""
    outs = [encode_boxes(b, lb, imsize, scale_factor, num_cls, normalized)
            for b, lb in zip(boxes_list, labels_list)]
    return tuple(np.stack(x) for x in zip(*outs))
