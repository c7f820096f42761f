"""Greedy hard NMS over fixed-size, masked box sets, batched over images.

Port of ref ops/nms.py:50 `nms_mask` (the reference's
`torchvision.ops.nms` call, evaluate.py:173-174). The JAX package runs it
outside any Pallas kernel, and so does the port: plain PyTorch ops.

* invalid entries take a score of -1e9, are never kept and never
  suppress;
* boxes are visited in a stable descending score order (the JAX
  `jnp.argsort(-masked)`, nms.py:66), ties in index order;
* the greedy sweep is a Python loop over the N positions, each step
  vectorised over the batch (nms.py:71-78).
"""

from __future__ import annotations

import torch

_NEG = -1e9


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) xyxy boxes -> (..., N, N)
    (ref ops/nms.py:33-46)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (xx2 - xx1).clamp_min(0.0) * (yy2 - yy1).clamp_min(0.0)
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
