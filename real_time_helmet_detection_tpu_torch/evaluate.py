"""Test-split evaluation and the single-image demo for the PyTorch port.

Port of ref real_time_helmet_detection_tpu/evaluate.py:121 `evaluate`
and :453 `demo` (reference evaluate.py:15-97, 245-290), without the
serving engine, mesh or multi-host paths:

* `load_eval_state` builds the model and fills it from an npz of the
  flax variable tree (`convert.py`), or seeds fresh weights from a
  `torch.Generator`;
* `evaluate` runs plain batched predict over the test split, rescales
  boxes to each image's original W x H from its VOC XML
  (ref evaluate.py:209-234), writes per-image txt files and
  `prediction_results.pickle`, and scores the VOC mAP;
* `demo` runs one image end to end and saves the overlay as `image.png`.
"""

from __future__ import annotations

import io
import math
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .convert import load_into, load_npz
from .data.eval_loader import eval_batches
from .data.voc import CLASS2COLOR, INDEX2CLASS, VOCDataset, boxes_from_voc_dict
from .metrics import compute_map, write_detection_txt
from .models.hourglass import build_model, cast_convs
from .predict import make_predict_fn, resolve_device
from .utils import (AverageMeter, atomic_write_bytes, draw_box, imload,
                    save_pickle, timestamp, write_text)


def init_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded fresh weights, drawn on the CPU from one `torch.Generator`:
    conv kernels normal with variance 1/fan_in (flax's lecun scale),
    conv biases 0, BatchNorm at flax's init (scale 1, bias 0, mean 0,
    var 1)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
    return model


def load_eval_state(cfg: Config, device=None) -> torch.nn.Module:
    """The eval model on its device (≡ ref evaluate.py:42-60): weights from
    `cfg.model_load` (npz) or seeded from `cfg.random_seed`; under --amp
    the conv weights are cast to bf16 once."""
    dev = resolve_device(cfg.device if device is None else device)
    dtype = torch.bfloat16 if cfg.amp else None
    model = build_model(cfg, dtype=dtype)
    if cfg.model_load:
        if not cfg.model_load.endswith(".npz"):
            raise ValueError(
                "--model-load must be an .npz of the flax variable tree "
                "(convert.save_npz); orbax checkpoints need jax to read, "
                "and their conversion is not built yet: %r" % cfg.model_load)
        load_into(model, load_npz(cfg.model_load))
    else:
        init_weights(model, cfg.random_seed)
    model = model.to(dev).eval()
    if dtype is not None:
        cast_convs(model, dtype)
    return model


def _origin_size(voc_dict: Dict) -> Tuple[int, int]:
    size = voc_dict["annotation"]["size"]
    return int(size["width"]), int(size["height"])


def evaluate(cfg: Config) -> Dict:
    """Test-split evaluation (≡ ref evaluate.py:15-97) + in-repo mAP.
    Returns `compute_map`'s dict plus host timing."""
    dev = resolve_device(cfg.device)
    model = load_eval_state(cfg, dev)
    predict = make_predict_fn(model, cfg, normalize=cfg.pretrained,
                              device=dev)
    dataset = VOCDataset(cfg.data, image_set="test")
    imsize = int(cfg.imsize or 512)
    txt_dir = os.path.join(cfg.save_path, "results", "txt")
    os.makedirs(cfg.save_path, exist_ok=True)
    results: Dict[str, Dict] = {}
    gt_boxes: Dict[str, np.ndarray] = {}
    gt_labels: Dict[str, np.ndarray] = {}
    meters = {k: AverageMeter() for k in ("data", "predict", "consume")}
    n_batches = -(-len(dataset) // cfg.batch_size)
    seen = 0
    tic = time.time()
    for i, batch in enumerate(eval_batches(dataset, imsize, cfg.batch_size)):
        meters["data"].update(time.time() - tic)
        t0 = time.time()
        dets = predict(batch.image)
        rows = [t.cpu().numpy() for t in dets]  # waits for the device
        meters["predict"].update(time.time() - t0)
        t0 = time.time()
        boxes_b, classes_b, scores_b, valid_b = rows
        for j, info in enumerate(batch.infos):
            image_id = os.path.splitext(
                info["annotation"].get("filename") or "%06d" % seen)[0]
            seen += 1
            ow, oh = _origin_size(info)
            keep = valid_b[j]
            # (imsize x imsize) -> original W x H (ref evaluate.py:100-112)
            boxes = boxes_b[j][keep] * np.array(
                [ow / imsize, oh / imsize, ow / imsize, oh / imsize],
                np.float32)
            classes, scores = classes_b[j][keep], scores_b[j][keep]
            results[image_id] = {"box": boxes, "cls": classes,
                                 "score": scores}
            write_detection_txt(txt_dir, image_id, boxes, classes, scores)
            gt_boxes[image_id], gt_labels[image_id] = \
                boxes_from_voc_dict(info)
        meters["consume"].update(time.time() - t0)
        if i % max(1, cfg.print_interval // 10) == 0:
            print("%s: eval iter %d/%d, data %.3fs predict %.3fs "
                  "consume %.3fs" % (timestamp(), i, n_batches,
                                     meters["data"].avg,
                                     meters["predict"].avg,
                                     meters["consume"].avg), flush=True)
        tic = time.time()

    save_pickle(os.path.join(cfg.save_path, "prediction_results.pickle"),
                results)
    m = compute_map(gt_boxes, gt_labels,
                    {k: v["box"] for k, v in results.items()},
                    {k: v["cls"] for k, v in results.items()},
                    {k: v["score"] for k, v in results.items()},
                    num_cls=cfg.num_cls)
    names = {c: INDEX2CLASS.get(c, str(c)) for c in m["ap"]}
    print("%s: mAP %.4f (%s)" % (
        timestamp(), m["map"],
        ", ".join("%s %.4f" % (names[c], ap) for c, ap in m["ap"].items())),
        flush=True)
    m["timing"] = {k: v.avg for k, v in meters.items()}
    return m


def demo(cfg: Config) -> Dict:
    """Single-image demo (≡ ref evaluate.py:245-290): `cfg.data` is the
    image; the overlay goes to `<save_path>/image.png`."""
    dev = resolve_device(cfg.device)
    model = load_eval_state(cfg, dev)
    imsize = int(cfg.imsize or 512)
    img, img_pil, origin_size = imload(cfg.data, cfg.pretrained, imsize)
    predict = make_predict_fn(model, cfg, device=dev)
    dets = predict(img)
    boxes_b, classes_b, scores_b, valid_b = (t.cpu().numpy() for t in dets)
    keep = valid_b[0]
    boxes = np.clip(boxes_b[0][keep], 0, imsize)  # clamp (ref :270)
    classes, scores = classes_b[0][keep], scores_b[0][keep]
    pil = img_pil.resize((imsize, imsize))
    rw, rh = origin_size[0] / imsize, origin_size[1] / imsize
    for box, c, s in zip(boxes, classes, scores):
        pil = draw_box(pil, box, color=CLASS2COLOR.get(int(c), (0, 0, 255)))
        pil = write_text(pil, "%s: %.2f" % (INDEX2CLASS.get(int(c), c), s),
                         (box[0], box[1]), fontsize=cfg.fontsize)
        print("%s %.2f: (%d, %d) (%d, %d)"
              % (INDEX2CLASS.get(int(c), c), s, box[0] * rw, box[1] * rh,
                 box[2] * rw, box[3] * rh), flush=True)
    os.makedirs(cfg.save_path, exist_ok=True)
    out = os.path.join(cfg.save_path, "image.png")
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    atomic_write_bytes(out, buf.getvalue())
    print("%s: demo overlay -> %s" % (timestamp(), out), flush=True)
    return {"boxes": boxes, "classes": classes, "scores": scores}
