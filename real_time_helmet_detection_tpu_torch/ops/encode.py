"""Ground-truth encoding: boxes -> (heatmap, offset, size, mask) target maps.

A copy of the numpy half of the JAX package's ops/encode.py (ref
encode.py:35-120: `gaussian_radius`, `_prepare_boxes`, `encode_boxes`,
`encode_boxes_batch`; reference transform.py:4-70 `box2hm`): channels-last
maps (H, W, C), every box's Gaussian in one broadcast; and the device
encoder of `--device-augment`, `encode_boxes_device` (ref encode.py:121
`encode_boxes_jax`), plain PyTorch on any device, batched over images
with `max_boxes` padding and a validity mask.

Semantics (the JAX package's, verified there against the reference):
  - center index = floor(box_center / scale_factor), clipped to the map
  - offset = fractional part of the scaled center; size = scaled box w/h
  - `normalized=True` divides offsets by `scale_factor` and sizes by the
    map width/height
  - Gaussian radius r = distance from center to a box corner at map scale,
    sigma = r/3, support window clipped to |dx|,|dy| <= int(r)
  - overlapping Gaussians of the same class merge with `max`
  - for coincident centers, the last box in the list wins the
    offset/size/mask scatter (on the device: the largest valid box
    index of each cell, a `scatter_reduce` with `amax` and a gather,
    since an `index_put_` of duplicate indices has no defined winner on
    CUDA)
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


def encode_boxes_device(boxes, labels, valid, *, height: int, width: int,
                        scale_factor: int = 4, num_cls: int = 2,
                        normalized: bool = False):
    """The GT encoder of the fused input path (ref encode.py:121
    `encode_boxes_jax`, vmapped over the batch): boxes (B, N, 4) xyxy at
    image scale, labels (B, N) int, valid (B, N) bool, all on one device;
    height/width the map size. Returns channels-last float32 maps heat
    (B, H, W, num_cls), offset (B, H, W, 2), size (B, H, W, 2), mask
    (B, H, W, 1) on that device, with JAX's float32 arithmetic in its
    order; no host read."""
    import torch
    bsz, n = labels.shape
    dev = boxes.device
    if n == 0:  # no boxes: background everywhere
        zeros = [torch.zeros((bsz, height, width, c), device=dev)
                 for c in (num_cls, 2, 2, 1)]
        return tuple(zeros)
    sf = float(scale_factor)
    b = boxes.float() / sf
    xmin, ymin, xmax, ymax = b.unbind(-1)
    xcen, ycen = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    xind = torch.floor(xcen).to(torch.int64).clamp(0, width - 1)
    yind = torch.floor(ycen).to(torch.int64).clamp(0, height - 1)
    xoff, yoff = xcen - xind.float(), ycen - yind.float()
    xsize, ysize = xmax - xmin, ymax - ymin
    if normalized:
        xoff, yoff = xoff / sf, yoff / sf
        xsize, ysize = xsize / width, ysize / height
    radius = torch.sqrt((xcen - xmin) ** 2 + (ycen - ymin) ** 2)

    # Gaussian field (B, N, H, W), windowed to |d| <= floor(r), valid
    # boxes only; a per-class max (initial 0)
    ri = torch.floor(radius)[..., None, None]
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    dy = ys[None, None, :, None] - yind.float()[..., None, None]
    dx = xs[None, None, None, :] - xind.float()[..., None, None]
    sigma = torch.clamp(radius, min=1e-6) / 3.0
    g = torch.exp(-(dx * dx + dy * dy)
                  / (2.0 * (sigma * sigma))[..., None, None])
    window = (dx.abs() <= ri) & (dy.abs() <= ri) & valid[..., None, None]
    g = torch.where(window, g, torch.zeros((), device=dev))
    heat = torch.stack([
        torch.where((labels == c)[..., None, None], g,
                    torch.zeros((), device=dev)).amax(dim=1)
        for c in range(num_cls)], dim=-1)

    # last-valid-wins point scatter: each cell's largest valid box index
    cell = yind * width + xind
    order = torch.arange(n, device=dev).expand(bsz, n)
    winner = torch.full((bsz, height * width), -1, dtype=torch.int64,
                        device=dev).scatter_reduce_(
        1, cell, torch.where(valid, order, -1), reduce="amax")
    hit = (winner >= 0)[..., None]
    pick = winner.clamp(min=0)[..., None].expand(bsz, height * width, 2)

    def scatter(a, b2):
        vals = torch.gather(torch.stack([a, b2], -1), 1, pick)
        return torch.where(hit, vals, torch.zeros((), device=dev)).reshape(
            bsz, height, width, 2)

    offset = scatter(xoff, yoff)
    size = scatter(xsize, ysize)
    mask = hit.float().reshape(bsz, height, width, 1)
    return heat, offset, size, mask
