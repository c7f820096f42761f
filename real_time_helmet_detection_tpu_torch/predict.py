"""Prediction path: network -> sigmoid + peak test -> top-k -> NMS.

Port of ref real_time_helmet_detection_tpu/predict.py:32
`make_predict_fn` (reference evaluate.py:114-180 `Prediction`). Shapes
stay fixed: `(B, S * topk)` boxes, classes, scores and a `valid` mask
that combines the confidence threshold and the NMS keep mask; hosts
filter when they write files. `--nms` picks the suppression as the JAX
package does (ref predict.py:84-146): hard NMS at `nms_th`; soft-NMS
with `score_th = conf_th`, whose decayed scores replace the scores; or
maxpool NMS over an extent of `imsize or 512`, which keeps the scores.

On CUDA the peak test is the hand-written kernel (`ops.peak`) and every
BN of the network runs through the epilogue and residual-tail kernels;
on the CPU the same calls run their plain versions.

`--infer-dtype int8` (ref predict.py:96-107, :152-159) predicts with the
BN-folded int8 twin (`ops.quant.make_quant_model`) and the calibrated
activation scales (`quant_scales`, required): the float model's weights
are folded and quantized once when the predict is built
(`ops.quant.load_twin`), not in every call, and its convs run the int8
kernels (`ops.qconv`); decode, the peak test and NMS are the same.

`cascade_summary=True` (ref predict.py:34, :172-177) adds the per-image
cascade confidence (`ops.decode.confidence_summary` of the final rows)
as a fifth leaf, `CascadeDetections`: one more output of the body, so
one more output of each serving bucket's graph, copied back with the
rows. Off, the body is what it was.

`make_predict_fn` returns a `Predict`: its `body` takes a device tensor
and is what the serving engine captures; calling the `Predict` with host
images is the one-shot path. A `BucketRunner` is one serving
bucket of a body (the counterpart of the JAX engine's per-bucket AOT
compile, ref serving/engine.py:365-370): on CUDA a static input, a
warm-up on a side stream (kernel libraries loaded, cuDNN plans made,
before any capture) and one `torch.cuda.CUDAGraph` of the body under
`inference_mode`, replayed by `run()` into static outputs; on the CPU
the same body, called eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Optional, Sequence

import torch

from .convert import flax_to_state_dict
from .ops import decode, nms, peak
from .ops.decode import CascadeDetections, Detections
from .utils import normalizer_stats


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. CUDA without a card
    raises: an entry point never drops to the CPU on its own. `meta`
    runs shapes alone (`obs.roofline`'s count)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "versions on the CPU" % str(device))
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError("device must be cuda, cpu or meta, got %r"
                         % str(device))
    return dev


class Predict:
    """`predict(images) -> Detections`: host images (B, H, W, 3) copied to
    `device`, then `body`. `body(x)` takes the images already on the
    device; `model` (the float model, or the int8 twin), `device` and
    `load` are what the serving engine reads."""

    def __init__(self, body: Callable[[torch.Tensor], Detections],
                 model: torch.nn.Module, device: torch.device,
                 int8: bool = False):
        self.body = body
        self.model = model
        self.device = device
        self.int8 = int8

    def load(self, variables, scales=None) -> None:
        """New weights, copied in place into the storages `body` reads (a
        captured graph sees them): a flax variable tree or a state dict of
        the float model. The int8 twin folds and quantizes them (and takes
        new activation `scales`, the `quant` tree, when given)."""
        if self.int8:
            from .ops.quant import load_twin
            load_twin(self.model, variables, scales)
            return
        if scales is not None:
            raise ValueError("activation scales apply to --infer-dtype int8")
        state = (flax_to_state_dict(variables)
                 if isinstance(variables, Mapping) and "params" in variables
                 else variables)
        self.model.load_state_dict(state, strict=True)

    def __call__(self, images) -> Detections:
        with torch.inference_mode():
            return self.body(torch.as_tensor(images).to(self.device))


def make_predict_fn(model: torch.nn.Module, cfg,
                    normalize: Optional[str] = None,
                    device="cuda", quant_scales=None,
                    cascade_summary: bool = False) -> Predict:
    """Build `predict(images) -> Detections` for a model on `device`.

    images: (B, H, W, 3), either normalized float32 or, when `normalize`
    names a statistics set ("imagenet"/"scratch"), raw pixels (uint8 or
    float in [0, 255]) that are cast and normalized on the device
    (ref predict.py:148-151) — `evaluate` ships uint8.

    With `cfg.infer_dtype == "int8"` the int8 twin of `model`'s
    architecture predicts, its weights folded from `model`'s (float32
    conv weights: an --amp model's must not be cast yet) with the
    activation scales `quant_scales` (the `quant` tree), which it needs.

    Returns Detections with leaves (B, S * topk, ...) on `device`
    (`CascadeDetections`, with a (B,) confidence, under
    `cascade_summary`). On CUDA it turns TF32 off for cuDNN and matmuls,
    process-wide."""
    dev = resolve_device(device)
    num_cls = int(cfg.num_cls)
    topk = int(cfg.topk)
    conf_th = float(cfg.conf_th)
    nms_th = float(cfg.nms_th)
    scale_factor = int(cfg.scale_factor)
    pool_size = int(cfg.pool_size)
    peak.check_pool_size(pool_size)
    mode = cfg.nms  # Config refuses any other mode
    extent = float(cfg.imsize or 512)  # the maxpool NMS grid's extent
    normalized = bool(cfg.normalized_coord)
    if normalize is not None:
        mean, std = (torch.as_tensor(s, device=dev)
                     for s in normalizer_stats(normalize))
    if dev.type == "cuda":
        # fp32 means fp32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    infer_dtype = getattr(cfg, "infer_dtype", "bf16")
    if infer_dtype not in ("bf16", "int8"):
        raise NotImplementedError("Not expected infer dtype: %s"
                                  % infer_dtype)
    int8 = infer_dtype == "int8"
    if int8:
        if quant_scales is None:
            raise ValueError(
                "--infer-dtype int8 needs calibrated activation scales: "
                "pass quant_scales (ops.quant.calibrate_scales or "
                "load_scales of a saved artifact)")
        from .models.hourglass import cast_convs
        from .ops.quant import load_twin, make_quant_model
        twin = make_quant_model(cfg, dtype=model.dtype, mode="int8")
        load_twin(twin, model.state_dict(), quant_scales)
        model = twin.to(dev).eval()
        if model.dtype is not None:
            cast_convs(model, model.dtype)  # the float convs, once
    else:
        model = model.to(dev).eval()

    def body(x: torch.Tensor) -> Detections:
        """The predict program on device images: no host sync, fixed
        shapes, so a CUDA graph can hold all of it."""
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
        if mode == "soft-nms":
            keep, scores = nms.soft_nms_mask(boxes, scores, valid,
                                             score_th=conf_th)
        elif mode == "maxpool":
            keep = nms.maxpool_nms_mask(boxes, scores, valid, extent=extent)
        else:
            keep = nms.nms_mask(boxes, scores, valid, nms_th)
        valid = keep & valid
        if cascade_summary:
            return CascadeDetections(
                boxes=boxes, classes=classes, scores=scores, valid=valid,
                confidence=decode.confidence_summary(scores, valid))
        return Detections(boxes=boxes, classes=classes, scores=scores,
                          valid=valid)

    return Predict(body, model, dev, int8=int8)


class BucketRunner:
    """One serving bucket: `input` is the static (batch, *image_shape)
    tensor the caller fills, `run()` computes the body on it and returns
    the Detections. On CUDA `run()` replays the captured graph on the
    current stream and returns the static `outputs`, which the next
    replay overwrites; on the CPU it calls the body. `build_s` is the
    warm-up and capture wall time. On CUDA a failed capture raises."""

    def __init__(self, predict: Predict, batch: int,
                 image_shape: Sequence[int], dtype: torch.dtype):
        dev = predict.device
        self.body = predict.body
        self.batch = int(batch)
        self.input = torch.zeros((self.batch,) + tuple(image_shape),
                                 dtype=dtype, device=dev)
        self.graph = None
        t0 = time.perf_counter()
        if dev.type != "cuda":
            self.outputs = self.run()  # shapes and dtypes for the caller
            self.build_s = time.perf_counter() - t0
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(2):  # cuDNN plans, kernel libraries, allocator
                self.body(self.input)
        torch.cuda.current_stream(dev).wait_stream(side)
        # keep_graph: the cudaGraph_t stays readable (node counts) after
        # capture; instantiate() builds the executable now, not at the
        # first replay. thread_local: another engine's threads may query
        # their events while this thread captures.
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.inference_mode(), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.outputs = self.body(self.input)
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.build_s = time.perf_counter() - t0

    def run(self) -> Detections:
        if self.graph is None:
            with torch.inference_mode():
                return self.body(self.input)
        self.graph.replay()
        return self.outputs
