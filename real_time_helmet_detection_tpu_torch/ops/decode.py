"""Peak scores -> fixed-size top-k boxes, batched over any leading dims.

Port of ref ops/decode.py:108 `decode_peak_scores` and
ref ops/decode.py:158 `decode_heatmap` (reference transform.py:73-110
`hm2box`). Shapes stay fixed: always `topk` boxes plus a `valid` mask
(score >= conf_th) instead of a data-dependent filter.

Tie order reaches the mAP: with the default conf_th 0.0 every top-k slot
is valid, including the zero-score fillers, so the order ties take picks
which filler boxes reach NMS and the txt files. `lax.top_k` puts the lower
flat index first; a stable descending `torch.sort` does the same
(`torch.topk` does not promise it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Detections(NamedTuple):
    """Fixed-size detections; leaves carry the caller's leading dims."""
    boxes: torch.Tensor    # (..., N, 4) xyxy at image scale, float32
    classes: torch.Tensor  # (..., N) int32
    scores: torch.Tensor   # (..., N) float32
    valid: torch.Tensor    # (..., N) bool


def peak_mask(heat: torch.Tensor, pool_size: int = 3) -> torch.Tensor:
    """pool_size x pool_size max-pool equality peak test over the last two
    dims of (..., h, w) (ref ops/decode.py:88-104); ties count."""
    lead, (h, w) = heat.shape[:-2], heat.shape[-2:]
    flat = heat.reshape(-1, 1, h, w)
    p = (pool_size - 1) // 2
    pooled = F.max_pool2d(flat, pool_size, stride=1, padding=p)
    return (pooled == flat).reshape(*lead, h, w)


def decode_peak_scores(peaks: torch.Tensor, offset: torch.Tensor,
                       wh: torch.Tensor, scale_factor: int = 4,
                       topk: int = 100, conf_th: float = 0.3,
                       normalized: bool = False) -> Detections:
    """Decode pre-masked peak scores into top-k boxes.

    peaks: (..., C, h, w) with non-peaks already 0 (`ops.peak`);
    offset, wh: (..., h, w, 2) channels-last, as sliced from the model
    output. Returns leaves of shape (..., topk, ...)."""
    *lead, num_cls, height, width = peaks.shape
    hw = height * width
    flat = peaks.reshape(*lead, num_cls * hw)
    if topk > flat.shape[-1]:
        raise ValueError("topk %d exceeds the %d map cells"
                         % (topk, flat.shape[-1]))
    scores, indices = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, indices = scores[..., :topk], indices[..., :topk]

    clss = torch.div(indices, hw, rounding_mode="floor")
    inds = indices - clss * hw
    yinds = torch.div(inds, width, rounding_mode="floor")
    xinds = inds - yinds * width

    cells = offset.reshape(*lead, hw, 2)
    sizes = wh.reshape(*lead, hw, 2)
    gather = inds.unsqueeze(-1).expand(*inds.shape, 2)
    offs = torch.gather(cells, -2, gather)
    sizs = torch.gather(sizes, -2, gather)
    xoffs, yoffs = offs[..., 0], offs[..., 1]
    xsizs, ysizs = sizs[..., 0], sizs[..., 1]

    if normalized:
        xoffs = xoffs * scale_factor
        yoffs = yoffs * scale_factor
        xsizs = xsizs * width
        ysizs = ysizs * height

    xf = xinds.to(torch.float32) + xoffs
    yf = yinds.to(torch.float32) + yoffs
    sf = float(scale_factor)
    boxes = torch.stack([(xf - xsizs / 2) * sf, (yf - ysizs / 2) * sf,
                         (xf + xsizs / 2) * sf, (yf + ysizs / 2) * sf],
                        dim=-1)
    return Detections(boxes=boxes, classes=clss.to(torch.int32),
                      scores=scores, valid=scores >= conf_th)


def decode_heatmap(heat: torch.Tensor, offset: torch.Tensor,
                   wh: torch.Tensor, scale_factor: int = 4, topk: int = 100,
                   conf_th: float = 0.3, normalized: bool = False,
                   pool_size: int = 3) -> Detections:
    """The plain peak path: heat (..., C, h, w) post-sigmoid, peak test by
    max pool, then `decode_peak_scores`."""
    peaks = torch.where(peak_mask(heat, pool_size), heat,
                        torch.zeros_like(heat))
    return decode_peak_scores(peaks, offset, wh, scale_factor=scale_factor,
                              topk=topk, conf_th=conf_th,
                              normalized=normalized)
