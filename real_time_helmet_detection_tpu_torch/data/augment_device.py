"""Batched training augmentation with box tracking, on the device
(`--device-augment`).

Port of ref real_time_helmet_detection_tpu/data/augment_device.py:45-183
(`sample_params`, `build_matrix`, `warp_image`, `transform_boxes_jax`,
`filter_boxes_jax`, `augment_encode_batch`): the host only decodes and
resizes each image to a fixed canvas (`augment.TestAugmentor`); the
random colour multiply, centred affine, crop-and-keep-size, horizontal
flip and the bucket resize, one 3x3 matrix per image, run on the card
with the GT encoder (`ops.encode.encode_boxes_device`) in plain PyTorch.

* Randomness: JAX folds the step index into a threefry key inside the
  step; the port cannot reproduce threefry, so `step_generator(seed,
  step)` seeds an explicit CPU `torch.Generator` from (seed, step) and
  `sample_params` draws the same distributions from it (scale, translate,
  crop, flip with p = 0.5, colour), in JAX's order. The draw and the
  matrices (`build_matrix`, its inverse) are a few hundred bytes made on
  the host and copied over in one pinned transfer, so a run on the card
  and the same run on the CPU see the same parameters and matrices.
* The warp samples the colour-multiplied canvas bilinearly at
  floor(inv(M) (p + 0.5) - 0.5) as JAX's gather does (out-of-image taps
  are 0, PIL AFFINE fill), in float32, clipped to [0, 255] before and
  after. Every step is an elementwise float32 operation, correctly
  rounded on either device, so the card's warp equals the CPU's for the
  same matrices; against JAX's the floors of a source coordinate that
  lands within an ulp of an integer can differ (the test states the
  rule). `grid_sample` is not used: its sampling convention is not
  JAX's.
* Boxes go through the forward matrix (corner envelope), fully-outside
  boxes are masked out and the rest clipped (`filter_boxes_device`:
  `filter_boxes` with a validity mask and fixed shapes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.encode import encode_boxes_device

PARAM_KEYS = ("scale", "translate", "crop", "flip", "color")


def step_generator(seed: int, step_idx: int) -> torch.Generator:
    """The CPU generator of one step's draw, seeded from (seed, step):
    any process that asks for a step gets the same parameters."""
    state = np.random.SeedSequence((int(seed), int(step_idx))) \
        .generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32
                                         | int(state[1]))


def sample_params(gen: torch.Generator, batch: int, *,
                  crop_percent=(0.0, 0.1), color_multiply=(1.2, 1.5),
                  translate_percent: float = 0.1,
                  affine_scale=(0.5, 1.5)) -> Dict[str, torch.Tensor]:
    """Per-image augmentation parameters on the CPU (the distributions of
    `TrainAugmentor`, ref augment_device.py:45): float32 `scale` (B,),
    `translate` (B, 2), `crop` (B, 4) as (top, right, bottom, left),
    `color` (B,), bool `flip` (B,)."""
    def u(lo, hi, shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float32)
                * (hi - lo) + lo)
    return {
        "scale": u(*affine_scale, (batch,)),
        "translate": u(-translate_percent, translate_percent, (batch, 2)),
        "crop": u(crop_percent[0], crop_percent[1], (batch, 4)),
        "flip": torch.rand((batch,), generator=gen) < 0.5,
        "color": u(*color_multiply, (batch,)),
    }


def _translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    m = torch.eye(3, dtype=torch.float32).repeat(tx.shape[0], 1, 1)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _scaling(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.stack(
        [sx, sy, torch.ones_like(sx)], dim=-1))


def _full(batch: int, value: float) -> torch.Tensor:
    return torch.full((batch,), value, dtype=torch.float32)


def build_matrix(params: Dict, w: float, h: float,
                 target: float) -> torch.Tensor:
    """(B, 3, 3) float32 forward matrices on the CPU, composed as JAX
    composes them (ref augment_device.py:63): centred affine, then crop,
    then flip, then the resize to `target`. `params` may hold numpy
    arrays (JAX's draw) or tensors."""
    p = {k: torch.tensor(np.asarray(params[k])) for k in PARAM_KEYS}
    s = p["scale"].float()
    b = s.shape[0]
    tx = p["translate"][:, 0].float() * w
    ty = p["translate"][:, 1].float() * h
    top, right, bottom, left = p["crop"].float().unbind(-1)
    affine = (_translation(w / 2 + tx, h / 2 + ty) @ _scaling(s, s)
              @ _translation(_full(b, -w / 2), _full(b, -h / 2)))
    cw = torch.clamp(w * (1.0 - left - right), min=1.0)
    ch = torch.clamp(h * (1.0 - top - bottom), min=1.0)
    crop = _scaling(w / cw, h / ch) @ _translation(-left * w, -top * h)
    m = crop @ affine
    flip_m = _translation(_full(b, w), _full(b, 0.0)) @ _scaling(
        _full(b, -1.0), _full(b, 1.0))
    m = torch.where(p["flip"].bool()[:, None, None], flip_m @ m, m)
    return _scaling(_full(b, np.float32(target / w)),
                    _full(b, np.float32(target / h))) @ m


def warp_image(images: torch.Tensor, inv: torch.Tensor,
               target: int) -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) float32 images by the INVERSE
    matrices (B, 3, 3) (same device) into (B, target, target, C);
    out-of-image taps are 0 (ref augment_device.py:85)."""
    bsz, h, w, c = images.shape
    dev = images.device
    grid = torch.arange(target, dtype=torch.float32, device=dev)
    px = (grid + 0.5)[None, None, :]   # output column centres
    py = (grid + 0.5)[None, :, None]   # output row centres
    i = inv[:, :, :, None, None]
    sx = i[:, 0, 0] * px + i[:, 0, 1] * py + i[:, 0, 2] - 0.5
    sy = i[:, 1, 0] * px + i[:, 1, 1] * py + i[:, 1, 2] - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = images.reshape(bsz, h * w, c)
    zero = torch.zeros((), device=dev)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(bsz, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(bsz, target, target, c)
        return torch.where(inside[..., None], vals, zero)

    fx, fy = fx[..., None], fy[..., None]
    return ((1 - fx) * (1 - fy) * tap(y0, x0)
            + fx * (1 - fy) * tap(y0, x0 + 1)
            + (1 - fx) * fy * tap(y0 + 1, x0)
            + fx * fy * tap(y0 + 1, x0 + 1))


def transform_boxes_device(boxes: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) xyxy through (B, 3, 3) matrices: the axis-aligned
    envelope of the 4 transformed corners (ref augment_device.py:116)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = torch.stack([x1, x2, x2, x1], -1)  # corners (B, N, 4)
    ys = torch.stack([y1, y1, y2, y2], -1)
    mm = m[:, None, None]

    def row(k):
        return xs * mm[..., k, 0] + ys * mm[..., k, 1] + mm[..., k, 2]

    wgt = row(2)
    px, py = row(0) / wgt, row(1) / wgt
    return torch.stack([px.amin(-1), py.amin(-1), px.amax(-1),
                        py.amax(-1)], -1)


def filter_boxes_device(boxes: torch.Tensor, valid: torch.Tensor,
                        size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask out fully-outside boxes, clip the rest, mask out boxes the
    clip collapsed (ref augment_device.py:131)."""
    keep = ((boxes[..., 2] > 0) & (boxes[..., 0] < size)
            & (boxes[..., 3] > 0) & (boxes[..., 1] < size))
    clipped = boxes.clamp(0.0, size)
    nonzero = ((clipped[..., 2] > clipped[..., 0])
               & (clipped[..., 3] > clipped[..., 1]))
    return clipped, valid & keep & nonzero


def device_matrices(params: Dict, w: int, h: int, target: int,
                    device) -> Tuple[torch.Tensor, ...]:
    """(colour (B,), M (B, 3, 3), inv(M) (B, 3, 3)) on `device`: made on
    the CPU, copied in one pinned, non-blocking transfer."""
    m = build_matrix(params, float(w), float(h), float(target))
    inv = torch.linalg.inv(m)
    color = torch.tensor(np.asarray(params["color"])).float()
    packed = torch.cat([color[:, None], m.reshape(-1, 9),
                        inv.reshape(-1, 9)], dim=1)
    if torch.device(device).type == "cuda":
        packed = packed.pin_memory().to(device, non_blocking=True)
    return (packed[:, 0], packed[:, 1:10].reshape(-1, 3, 3),
            packed[:, 10:].reshape(-1, 3, 3))


def augment_encode_batch(params: Dict, images: torch.Tensor,
                         boxes: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor, *, target: int,
                         scale_factor: int = 4, num_cls: int = 2,
                         normalized: bool = False):
    """Augment and GT-encode one batch on the images' device (ref
    augment_device.py:140).

    params: `sample_params`' dict (tensors or numpy, B rows); images
    (B, H, W, 3) uint8 or float in [0, 255]; boxes (B, N, 4) padded xyxy
    at canvas scale, labels (B, N), valid (B, N) bool. Returns (images
    (B, target, target, 3) float32 in [0, 255], heat, offset, size, mask
    (channels-last at target // scale_factor), boxes, valid)."""
    bsz, h, w, _ = images.shape
    color, m, inv = device_matrices(params, w, h, target, images.device)
    img = torch.clamp(images.float() * color[:, None, None, None],
                      0.0, 255.0)
    # re-clip after the warp: bilinear weights can overshoot by an ulp
    img = torch.clamp(warp_image(img, inv, target), 0.0, 255.0)
    bx = transform_boxes_device(boxes.float(), m)
    bx, vd = filter_boxes_device(bx, valid.bool(), float(target))
    maps = target // scale_factor
    heat, off, size, mask = encode_boxes_device(
        bx, labels, vd, height=maps, width=maps, scale_factor=scale_factor,
        num_cls=num_cls, normalized=normalized)
    return img, heat, off, size, mask, bx, vd


def rows_of(params: Dict[str, torch.Tensor], lo: int, hi: int
            ) -> Dict[str, torch.Tensor]:
    """Rows [lo, hi) of a draw: a rank's share of the global batch."""
    return {k: v[lo:hi] for k, v in params.items()}


def normalizer(pretrained: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) float32 on `device`, made once per run."""
    from ..utils import normalizer_stats
    mean, std = normalizer_stats(pretrained)
    return (torch.as_tensor(np.asarray(mean, np.float32)).to(device),
            torch.as_tensor(np.asarray(std, np.float32)).to(device))


def normalize_device(img: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor) -> torch.Tensor:
    """(img / 255 - mean) / std, as the fused JAX step normalizes (ref
    train.py:669)."""
    return (img / 255.0 - mean) / std
