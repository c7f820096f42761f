"""Detection losses: CenterNet focal loss + mask-normalized L1, in PyTorch.

Port of ref real_time_helmet_detection_tpu/ops/loss.py:28-163
(`focal_loss`, `normed_l1_loss`, `detection_loss`,
`split_stack_predictions`, `stacked_detection_loss`, `LossLog`; reference
loss.py:9-69). The port trains with this composition (the JAX package's
`--loss-kernel xla`); the Pallas loss kernels of ref ops/pallas/loss.py
are not ported yet.

Reductions match the JAX package exactly: per-sample sums over
(H, W, C), a mean over the batch, and normalization by the global
positive count `clip(sum(mask), 1, 1e30)`. Arrays are channels-last,
as the model's output (B, S, H, W, C+4) and the encoded targets are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def _num_pos(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.sum(), 1.0, 1e30)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0,
               eps: float = 1e-7) -> torch.Tensor:
    """CenterNet focal loss on a post-sigmoid heatmap (ref loss.py:28).

    pred/gt: (B, H, W, C); mask: (B, H, W, 1) positive-center indicator,
    broadcast over the class axis."""
    pred, gt = pred.float(), gt.float()
    neg_weights = torch.pow(1.0 - gt, beta)
    pos = torch.log(pred + eps) * torch.pow(1.0 - pred, alpha) * mask
    neg = (torch.log(1.0 - pred + eps) * torch.pow(pred, alpha)
           * neg_weights * (1.0 - mask))
    pos = pos.sum(dim=(1, 2, 3)).mean()
    neg = neg.sum(dim=(1, 2, 3)).mean()
    return -(pos + neg) / _num_pos(mask)


def normed_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked L1, summed per sample, batch-meaned, over the global
    positive count (ref loss.py:47)."""
    loss = torch.abs(pred.float() * mask - gt * mask)
    return loss.sum(dim=(1, 2, 3)).mean() / _num_pos(mask)


def detection_loss(pred_heatmap, pred_offset, pred_size, gt_heatmap,
                   gt_offset, gt_size, mask, *, hm_weight: float = 1.0,
                   offset_weight: float = 1.0, size_weight: float = 0.1,
                   focal_alpha: float = 2.0,
                   focal_beta: float = 4.0) -> Dict[str, torch.Tensor]:
    """Weighted total loss of one prediction stack (ref loss.py:56);
    `pred_heatmap` is post-sigmoid. Returns 'hm', 'offset', 'size' and
    'total' scalars."""
    hm = focal_loss(pred_heatmap, gt_heatmap, mask, focal_alpha, focal_beta)
    off = normed_l1_loss(pred_offset, gt_offset, mask)
    size = normed_l1_loss(pred_size, gt_size, mask)
    total = hm * hm_weight + off * offset_weight + size * size_weight
    return {"hm": hm, "offset": off, "size": size, "total": total}


def split_stack_predictions(out: torch.Tensor, num_cls: int,
                            normalized_coord: bool):
    """One stack's raw output (B, H, W, C+4) -> post-activation (heatmap,
    offset, size) (ref loss.py:73)."""
    heat = torch.sigmoid(out[..., :num_cls])
    offset = out[..., num_cls:num_cls + 2]
    size = out[..., num_cls + 2:num_cls + 4]
    if normalized_coord:
        offset, size = torch.sigmoid(offset), torch.sigmoid(size)
    return heat, offset, size


def stacked_detection_loss(out: torch.Tensor, gt_heat: torch.Tensor,
                           gt_off: torch.Tensor, gt_wh: torch.Tensor,
                           mask: torch.Tensor, *, num_cls: int,
                           normalized_coord: bool = False,
                           hm_weight: float = 1.0,
                           offset_weight: float = 1.0,
                           size_weight: float = 0.1,
                           focal_alpha: float = 2.0,
                           focal_beta: float = 4.0
                           ) -> Dict[str, torch.Tensor]:
    """Deep-supervision loss over all stacks of the raw model output
    (B, S, H, W, C+4): sigmoid + per-stack `detection_loss`, summed over
    stacks (ref loss.py:86)."""
    totals: Dict[str, torch.Tensor] = {}
    for s in range(out.shape[1]):
        heat, off, size = split_stack_predictions(out[:, s], num_cls,
                                                  normalized_coord)
        losses = detection_loss(
            heat, off, size, gt_heat, gt_off, gt_wh, mask,
            hm_weight=hm_weight, offset_weight=offset_weight,
            size_weight=size_weight, focal_alpha=focal_alpha,
            focal_beta=focal_beta)
        for k, v in losses.items():
            totals[k] = totals[k] + v if k in totals else v
    return totals


class LossLog:
    """Host-side loss history (ref loss.py:115; reference loss.py:9),
    appended once per step and kept in checkpoints. `state_dict()` tags
    the key -> list dict with the JAX package's schema name; the
    constructor also reads an untagged dict of the four loss keys."""

    KEYS = ("hm", "offset", "size", "total")
    SCHEMA = "loss-log-v2"

    def __init__(self, log: Optional[Mapping[str, list]] = None):
        log = log or {}
        schema = log.get("schema")
        if schema is not None and schema != self.SCHEMA:
            raise ValueError("unknown loss-log schema %r (this build reads "
                             "untagged logs and %s)" % (schema, self.SCHEMA))
        self.log = {k: list(log.get(k, [])) for k in self.KEYS}

    def append(self, losses: Mapping[str, float]) -> None:
        for k in self.KEYS:
            self.log[k].append(float(losses[k]))

    def get_log(self, length: int = 100) -> str:
        parts = []
        for key in self.KEYS:
            n = min(length, len(self.log[key]))
            avg = sum(self.log[key][-n:]) / n if n else float("nan")
            parts.append("%s: %5.2f" % (key, avg))
        return ", ".join(parts)

    def state_dict(self) -> Dict:
        out: Dict = {"schema": self.SCHEMA}
        out.update({k: list(v) for k, v in self.log.items()})
        return out
