"""Non-maximum suppression over fixed-size, masked box sets, batched over
images: greedy hard NMS, Gaussian soft-NMS and maxpool NMS.

Ports of ref ops/nms.py:50 `nms_mask` (the reference's
`torchvision.ops.nms` call, evaluate.py:173-174), :83 `soft_nms_mask`
(the reference's `soft_nms_pytorch`, evaluate.py:184-243) and :116
`maxpool_nms_mask` (PSRR-MaxpoolNMS-style suppression). The JAX package
runs them outside any Pallas kernel, and so does the port: plain PyTorch
ops, each vectorised over the batch.

* invalid entries take a score of -1e9, are never kept and never
  suppress;
* hard NMS visits boxes in a stable descending score order (the JAX
  `jnp.argsort(-masked)`, nms.py:66), ties in index order, in a Python
  loop over the N positions (nms.py:71-78);
* soft-NMS runs N rounds of argmax (the first index among ties, as
  `jnp.argmax`) and Gaussian decay of the others by exp(-iou^2 / sigma),
  with the inclusive (+1) IoU by default, and returns the decayed scores;
* maxpool NMS scatters each box's score (max) onto a (grid, grid,
  scale x ratio) map, tests each scale octave's window peak with
  `ops.decode.peak_mask`, and keeps a box that owns its cell's max at a
  peak. It approximates hard NMS by design.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .decode import peak_mask

_NEG = -1e9


def _iou_matrix(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) xyxy boxes -> (..., N, N)
    (ref ops/nms.py:33-46); `plus_one` takes the inclusive pixel
    convention of the reference's exported and soft NMS."""
    e = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + e) * (y2 - y1 + e)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (xx2 - xx1 + e).clamp_min(0.0) * (yy2 - yy1 + e).clamp_min(0.0)
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_th: float = 0.5) -> torch.Tensor:
    """boxes (B, N, 4), scores (B, N), valid (B, N) bool -> keep (B, N)
    bool in the original order. IoU strictly above iou_th suppresses."""
    b, n = scores.shape
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.sort(-masked, dim=1, stable=True).indices
    v = torch.gather(valid, 1, order)
    sorted_boxes = torch.gather(boxes, 1, order.unsqueeze(-1).expand(b, n, 4))
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # sup[:, i, j]: if i survives it suppresses j (j after i, IoU > th)
    sup = (_iou_matrix(sorted_boxes) > iou_th) & later
    keep = v.clone()
    for i in range(n):
        alive = keep[:, i] & v[:, i]
        keep &= ~(sup[:, i] & alive[:, None])
    out = torch.zeros_like(keep)
    return out.scatter_(1, order, keep)


def soft_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, sigma: float = 0.5,
                  score_th: float = 0.001, plus_one: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian soft-NMS, N rounds (ref ops/nms.py:83-113): each round
    takes the highest-scoring unprocessed valid box and multiplies every
    other unprocessed valid box's score by exp(-iou^2 / sigma).

    boxes (B, N, 4), scores (B, N) float32, valid (B, N) bool -> (keep
    (B, N) bool = decayed score > score_th and valid, the decayed scores
    (B, N)), both in the original order; invalid entries keep their
    input scores."""
    b, n = scores.shape
    iou = _iou_matrix(boxes, plus_one=plus_one)
    rows = torch.arange(b, device=scores.device)
    # the mark written each round, on the device: a Python True would be
    # a host-to-device copy per round, which a CUDA graph cannot hold
    mark = torch.ones(b, dtype=torch.bool, device=scores.device)
    cur = scores.clone()
    processed = torch.zeros_like(valid)
    for _ in range(n):
        blocked = processed | ~valid
        cand = torch.where(blocked, torch.full_like(cur, _NEG), cur)
        i = torch.argmax(cand, dim=1)
        has_cand = cand[rows, i] > _NEG / 2
        row = iou[rows, i]
        weight = torch.exp(-(row * row) / sigma)
        decayed = torch.where(blocked, cur, cur * weight)
        decayed[rows, i] = cur[rows, i]  # the selected box keeps its score
        cur = torch.where(has_cand[:, None], decayed, cur)
        processed[rows, i] = mark
    return (cur > score_th) & valid, cur


def maxpool_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, extent: float = 512.0,
                     grid_size: int = 64, scale_bins: int = 4,
                     ratio_bins: int = 3) -> torch.Tensor:
    """Maxpool NMS (ref ops/nms.py:116-183): each box's score goes (max)
    into the map cell of its centre, size octave and aspect octave; per
    size octave a window peak test with the window the octave's box size
    halved, in cells. A box is kept iff it is valid, it owns its cell's
    max and its cell is a peak.

    boxes (B, N, 4) xyxy at image scale in [0, extent), scores (B, N),
    valid (B, N) bool -> keep (B, N) bool."""
    b, n = scores.shape
    g = grid_size
    nch = scale_bins * ratio_bins
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = torch.clamp((x1 + x2) * 0.5, 0.0, extent * (1 - 1e-6))
    cy = torch.clamp((y1 + y2) * 0.5, 0.0, extent * (1 - 1e-6))
    w = torch.clamp_min(x2 - x1, 1e-3)
    h = torch.clamp_min(y2 - y1, 1e-3)
    rel = torch.sqrt(w * h) / extent
    sbin = torch.clamp(torch.floor(torch.log2(rel)).to(torch.int64)
                       + scale_bins, 0, scale_bins - 1)
    rbin = torch.clamp(torch.floor(torch.log2(w / h) + 0.5).to(torch.int64)
                       + ratio_bins // 2, 0, ratio_bins - 1)
    ch = sbin * ratio_bins + rbin
    gx = torch.clamp((cx / extent * g).to(torch.int32), 0, g - 1).long()
    gy = torch.clamp((cy / extent * g).to(torch.int32), 0, g - 1).long()

    # scatter-max the scores onto (B, scale x ratio, g, g); the background
    # stays below any real score
    cell = (ch * g + gy) * g + gx                                 # (B, N)
    smap = torch.full((b, nch * g * g), _NEG, dtype=torch.float32,
                      device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    smap.scatter_reduce_(1, cell, masked.float(), reduce="amax",
                         include_self=True)
    grid = smap.view(b, nch, g, g)
    size = extent / g
    peaks = []
    for s in range(scale_bins):
        s_rep = extent * (2.0 ** (s + 0.5 - scale_bins))
        half = max(1, int(round(s_rep / (2.0 * size))))
        peaks.append(peak_mask(grid[:, s * ratio_bins:(s + 1) * ratio_bins],
                               2 * half + 1))
    is_peak = torch.gather(torch.cat(peaks, dim=1).view(b, -1), 1, cell)
    cellv = torch.gather(smap, 1, cell)
    return valid & is_peak & (scores.float() >= cellv)
