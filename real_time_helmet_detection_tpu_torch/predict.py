"""Prediction path: network -> sigmoid + peak test -> top-k -> hard NMS.

Port of ref real_time_helmet_detection_tpu/predict.py:32
`make_predict_fn` (reference evaluate.py:114-180 `Prediction`). Shapes
stay fixed: `(B, S * topk)` boxes, classes, scores and a `valid` mask
that combines the confidence threshold and the NMS keep mask; hosts
filter when they write files.

On CUDA the peak test is the hand-written kernel (`ops.peak`) and every
BN of the network runs through the epilogue and residual-tail kernels;
on the CPU the same calls run their plain versions.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ops import decode, nms, peak
from .ops.decode import Detections
from .utils import normalizer_stats


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. CUDA without a card
    raises: an entry point never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "versions on the CPU" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu, got %r" % str(device))
    return dev


def make_predict_fn(model: torch.nn.Module, cfg,
                    normalize: Optional[str] = None,
                    device="cuda") -> Callable[..., Detections]:
    """Build `predict(images) -> Detections` for a model on `device`.

    images: (B, H, W, 3), either normalized float32 or, when `normalize`
    names a statistics set ("imagenet"/"scratch"), raw pixels (uint8 or
    float in [0, 255]) that are cast and normalized on the device
    (ref predict.py:148-151) — `evaluate` ships uint8.

    Returns Detections with leaves (B, S * topk, ...) on `device`. On
    CUDA it turns TF32 off for cuDNN and matmuls, process-wide."""
    dev = resolve_device(device)
    num_cls = int(cfg.num_cls)
    topk = int(cfg.topk)
    conf_th = float(cfg.conf_th)
    nms_th = float(cfg.nms_th)
    scale_factor = int(cfg.scale_factor)
    pool_size = int(cfg.pool_size)
    peak.check_pool_size(pool_size)
    if cfg.nms != "nms":
        raise NotImplementedError("nms %r is not ported yet" % cfg.nms)
    normalized = bool(cfg.normalized_coord)
    if normalize is not None:
        mean, std = (torch.as_tensor(s, device=dev)
                     for s in normalizer_stats(normalize))
    if dev.type == "cuda":
        # fp32 means fp32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = model.to(dev).eval()

    @torch.inference_mode()
    def predict(images) -> Detections:
        x = torch.as_tensor(images).to(dev)
        if normalize is not None:
            x = (x.to(torch.float32) / 255.0 - mean) / std
        out = model(x)                                   # (B, S, h, w, K)
        b, s = out.shape[:2]
        offset = out[..., num_cls:num_cls + 2]
        wh = out[..., num_cls + 2:num_cls + 4]
        if normalized:
            offset, wh = torch.sigmoid(offset), torch.sigmoid(wh)
        dets = decode.decode_peak_scores(
            peak.peak_scores(out, num_cls, pool_size), offset, wh,
            scale_factor=scale_factor, topk=topk, conf_th=conf_th,
            normalized=normalized)
        boxes = dets.boxes.reshape(b, s * topk, 4)
        classes = dets.classes.reshape(b, s * topk)
        scores = dets.scores.reshape(b, s * topk)
        valid = dets.valid.reshape(b, s * topk)
        keep = nms.nms_mask(boxes, scores, valid, nms_th)
        return Detections(boxes=boxes, classes=classes, scores=scores,
                          valid=keep & valid)

    return predict
