"""Test-split evaluation and the single-image demo for the PyTorch port.

Port of ref real_time_helmet_detection_tpu/evaluate.py:121 `evaluate`
and :453 `demo` (reference evaluate.py:15-97, 245-290), through the
serving engine as the JAX package's are (ref evaluate.py:236-300,
:474-477):

* `load_eval_state` builds the model and fills it from an npz of the
  flax variable tree (`convert.py`) or a port checkpoint dir (its
  `weights.npz`; with `--ema-eval` its `ema.npz`, ref train.py:1031
  `restore_variables(prefer_ema)`), or seeds fresh weights from a
  `torch.Generator`;
* `evaluate` submits every test image to a `ServingEngine` (buckets: the
  `--serve-buckets` up to the batch size, and the batch size; depth
  `--serve-depth`), consumes the head of its pending batches while later
  ones are in flight, rescales boxes to each image's original W x H from
  its VOC XML (ref evaluate.py:209-234), writes per-image txt files and
  `prediction_results.pickle`, and scores the VOC mAP;
* `demo` serves one image through bucket (1,) with no wait and saves
  the overlay as `image.png`;
* with `--world-size N` (ref evaluate.py:139-192, :339
  `_score_multihost`), each rank scores its `epoch_indices` shard of the
  split (wrap-padded, unshuffled) through its own engine on its own card,
  the ranks gather fixed-shape blocks (64-byte ids, (M, num_stack * topk)
  boxes, classes and scores, a count; M = ceil(n / N)), wrap duplicates
  are dropped, and every rank scores the whole split in its order, the
  same mAP; rank 0 alone writes the txt files and the pickle. The one-
  process multi-card sharding of ref evaluate.py:246-249 is not ported.

`--infer-dtype int8` (ref evaluate.py:69-118, :182-194, :460-470) serves
the int8 twin: its activation scales come from `--quant-scales`, or from
a calibration pass over the first `--calib-batches` eval batches (raw
uint8, a short last batch padded to `--batch-size`, normalized on the
device) that is saved to `<save_path>/calibration/quant_scales.json`
with its sha256 printed (every rank of a multi-process eval calibrates
on the split's first batches, and rank 0 saves); the demo calibrates on
its own image.
"""

from __future__ import annotations

import io
import math
import os
import time
import xml.etree.ElementTree as ET
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .convert import load_into, load_npz
from .data.eval_loader import eval_batches
from .data.pipeline import epoch_indices
from .data.voc import (CLASS2COLOR, INDEX2CLASS, VOCDataset,
                       boxes_from_voc_dict, parse_voc_xml)
from .metrics import compute_map, write_detection_txt
from .models.hourglass import PReLU, build_model, cast_convs
from .obs.spans import maybe_tracer
from .ops.quant import calibrate_scales, load_scales, save_scales
from .parallel import all_gather_arrays, init_distributed
from .predict import make_predict_fn, resolve_device
from .serving import ServingEngine, resolve_buckets
from .utils import (AverageMeter, atomic_write_bytes, draw_box, imload,
                    save_pickle, timestamp, write_text)


def init_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded fresh weights, drawn on the CPU from one `torch.Generator`:
    conv kernels (the pool and SPP convs among them) normal with variance
    1/fan_in (flax's lecun scale), conv biases 0, PReLU slopes 0.25
    (ref models/hourglass.py:119-122), BatchNorm at flax's init (scale 1,
    bias 0, mean 0, var 1)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, PReLU):
                m.negative_slope.fill_(0.25)
    return model


def weights_file(path: str, ema: bool = False) -> str:
    """The npz `--model-load path` names: the path itself, or a port
    checkpoint dir's `weights.npz` (`ema.npz` with `ema`, which raises
    without one, as JAX's restore does, rather than evaluating the raw
    weights)."""
    if ema and path.endswith(".npz"):
        raise ValueError(
            "--ema-eval takes a port checkpoint dir (its ema.npz): %r is "
            "an .npz, evaluated as it is without --ema-eval (convert a JAX "
            "checkpoint's EMA with `scripts/orbax_to_npz.py --ema`)" % path)
    if path.endswith(".npz"):
        return path
    if os.path.isfile(os.path.join(path, "weights.npz")):
        if not ema:
            return os.path.join(path, "weights.npz")
        if not os.path.isfile(os.path.join(path, "ema.npz")):
            raise ValueError(
                "--ema-eval: checkpoint %s has no EMA weights (trained "
                "without --ema-decay)" % path)
        return os.path.join(path, "ema.npz")
    raise ValueError(
        "--model-load must be an .npz of the flax variable tree "
        "(convert.save_npz), a port checkpoint dir or a save dir holding "
        "one; an orbax checkpoint of the JAX package needs jax to read: "
        "convert it first with `python scripts/orbax_to_npz.py CKPT_DIR "
        "OUT.npz`: %r" % path)


def load_eval_state(cfg: Config, device=None) -> torch.nn.Module:
    """The eval model on its device (≡ ref evaluate.py:42-60): weights from
    `cfg.model_load` (`weights_file`) or seeded from `cfg.random_seed`;
    under --amp the conv weights are cast to bf16 once, except for
    --infer-dtype int8, whose twin folds the float32 weights."""
    dev = resolve_device(cfg.device if device is None else device)
    dtype = torch.bfloat16 if cfg.amp else None
    model = build_model(cfg, dtype=dtype)
    if cfg.model_load:
        load_into(model, load_npz(weights_file(cfg.model_load,
                                               cfg.ema_eval)))
    else:
        init_weights(model, cfg.random_seed)
    model = model.to(dev).eval()
    if dtype is not None and cfg.infer_dtype != "int8":
        cast_convs(model, dtype)
    return model


def eval_quant_scales(cfg: Config, model: torch.nn.Module, dataset,
                      imsize: int, device) -> Dict:
    """Activation scales for --infer-dtype int8: the `--quant-scales`
    artifact, else a calibration pass over the first `--calib-batches`
    eval batches (each a short tail padded to the batch size with zero
    images), persisted atomically under `<save_path>/calibration/`."""
    if cfg.quant_scales:
        print("%s: int8 scales <- %s" % (timestamp(), cfg.quant_scales),
              flush=True)
        return load_scales(cfg.quant_scales)

    def batches():
        for n, batch in enumerate(eval_batches(dataset, imsize,
                                               cfg.batch_size)):
            if n >= cfg.calib_batches:
                return
            images = batch.image
            if images.shape[0] < cfg.batch_size:
                pad = cfg.batch_size - images.shape[0]
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:],
                                      images.dtype)])
            yield images

    scales = calibrate_scales(cfg, model.state_dict(), batches(),
                              dtype=model.dtype, normalize=cfg.pretrained,
                              percentile=cfg.calib_percentile, device=device)
    if cfg.rank != 0:
        return scales
    path = os.path.join(cfg.save_path, "calibration", "quant_scales.json")
    digest = save_scales(path, scales, meta={
        "calib_batches": cfg.calib_batches,
        "calib_percentile": cfg.calib_percentile,
        "model_load": cfg.model_load})
    print("%s: int8 calibration (%d batches, p%.5g) -> %s (sha256 %s)"
          % (timestamp(), cfg.calib_batches, cfg.calib_percentile, path,
             digest[:12]), flush=True)
    return scales


def _origin_size(voc_dict: Dict) -> Tuple[int, int]:
    size = voc_dict["annotation"]["size"]
    return int(size["width"]), int(size["height"])


def serve_engine(cfg: Config, predict, imsize: int, image_dtype,
                 buckets, max_wait_ms: float) -> ServingEngine:
    """The serving engine eval and the demo predict through, with the
    `--serve-*` depth, queue, retry and watchdog settings."""
    return ServingEngine(
        predict, None, (imsize, imsize, 3), image_dtype, buckets=buckets,
        max_wait_ms=max_wait_ms, depth=cfg.serve_depth,
        queue_capacity=cfg.serve_queue, tracer=maybe_tracer(),
        max_retries=cfg.serve_max_retries,
        hang_timeout_s=(cfg.serve_hang_timeout_ms / 1e3
                        if cfg.serve_hang_timeout_ms > 0 else None))


class _Shard:
    """The images `indices` of a dataset, in that order."""

    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]


ID_BYTES = 64  # an image id's slot in the gathered blocks


def evaluate(cfg: Config) -> Dict:
    """Test-split evaluation (≡ ref evaluate.py:15-97) + in-repo mAP, on
    every rank of a `--world-size` run. Returns `compute_map`'s dict plus
    host timing."""
    dev = init_distributed(cfg)
    rank, world = cfg.rank, cfg.world_size
    model = load_eval_state(cfg, dev)
    dataset = VOCDataset(cfg.data, image_set="test")
    if world > 1:
        # the same ids on every rank: a refusal here is symmetric, before
        # any collective (ref evaluate.py:361-370)
        for image_id in dataset.ids:
            if len(image_id.encode()) > ID_BYTES:
                raise ValueError(
                    "image id %r exceeds the %d-byte multi-host gather "
                    "slot" % (image_id, ID_BYTES))
        print("%s: multi-host eval rank %d/%d (split sharded by rank)"
              % (timestamp(), rank, world), flush=True)
    imsize = int(cfg.imsize or 512)
    scales = None
    if cfg.infer_dtype == "int8":
        with maybe_tracer().span("calibrate", batches=cfg.calib_batches):
            scales = eval_quant_scales(cfg, model, dataset, imsize, dev)
    predict = make_predict_fn(model, cfg, normalize=cfg.pretrained,
                              device=dev, quant_scales=scales)
    txt_dir = os.path.join(cfg.save_path, "results", "txt")
    os.makedirs(cfg.save_path, exist_ok=True)
    results: Dict[str, Dict] = {}
    gt_boxes: Dict[str, np.ndarray] = {}
    gt_labels: Dict[str, np.ndarray] = {}
    # "submit": the engine's submit wall (it batches and dispatches in its
    # own threads); "consume": the wait for the rows + the host's box
    # rescale and txt writes
    meters = {k: AverageMeter() for k in ("data", "submit", "consume")}
    shard = dataset if world == 1 else _Shard(dataset, epoch_indices(
        len(dataset), 0, 0, shuffle=False, rank=rank, world_size=world))
    n_batches = -(-len(shard) // cfg.batch_size)
    seen = 0

    def consume_row(row, info):
        nonlocal seen
        image_id = os.path.splitext(
            info["annotation"].get("filename") or "%06d" % seen)[0]
        seen += 1
        ow, oh = _origin_size(info)
        keep = row.valid
        # (imsize x imsize) -> original W x H (ref evaluate.py:100-112)
        boxes = row.boxes[keep] * np.array(
            [ow / imsize, oh / imsize, ow / imsize, oh / imsize],
            np.float32)
        classes, scores = row.classes[keep], row.scores[keep]
        results[image_id] = {"box": boxes, "cls": classes, "score": scores}
        if world == 1:
            write_detection_txt(txt_dir, image_id, boxes, classes, scores)
        gt_boxes[image_id], gt_labels[image_id] = boxes_from_voc_dict(info)

    def consume_batch(futs, infos):
        t0 = time.time()
        for fut, info in zip(futs, infos):
            consume_row(fut.result(), info)
        meters["consume"].update(time.time() - t0)

    # the last partial batch takes a smaller bucket: nothing is padded on
    # the host and nothing is captured after the engine starts
    buckets = tuple(sorted({b for b in resolve_buckets(cfg)
                            if b <= cfg.batch_size} | {cfg.batch_size}))
    pending: deque = deque()  # (futures, infos) per loader batch
    with serve_engine(cfg, predict, imsize, np.uint8, buckets,
                      cfg.serve_max_wait_ms) as engine:
        tic = time.time()
        for i, batch in enumerate(eval_batches(shard, imsize,
                                               cfg.batch_size)):
            meters["data"].update(time.time() - tic)
            t0 = time.time()
            futs = [engine.submit(img) for img in batch.image]
            meters["submit"].update(time.time() - t0)
            pending.append((futs, batch.infos))
            # consume finished heads without blocking: the host's txt
            # writes overlap the engine's pipeline
            while len(pending) > 1 and all(f.done() for f in pending[0][0]):
                consume_batch(*pending.popleft())
            if i % max(1, cfg.print_interval // 10) == 0:
                print("%s: eval iter %d/%d, data %.3fs submit %.3fs "
                      "fetch+consume %.3fs" % (timestamp(), i, n_batches,
                                               meters["data"].avg,
                                               meters["submit"].avg,
                                               meters["consume"].avg),
                      flush=True)
            tic = time.time()
        while pending:
            consume_batch(*pending.popleft())

    if world > 1:
        results, gt_boxes, gt_labels = _gather_results(cfg, dataset,
                                                       results)
        if rank == 0:
            for k, v in results.items():
                write_detection_txt(txt_dir, k, v["box"], v["cls"],
                                    v["score"])
    if rank == 0:
        save_pickle(os.path.join(cfg.save_path,
                                 "prediction_results.pickle"), results)
    m = compute_map(gt_boxes, gt_labels,
                    {k: v["box"] for k, v in results.items()},
                    {k: v["cls"] for k, v in results.items()},
                    {k: v["score"] for k, v in results.items()},
                    num_cls=cfg.num_cls)
    if rank == 0:
        names = {c: INDEX2CLASS.get(c, str(c)) for c in m["ap"]}
        print("%s: mAP %.4f (%s)" % (
            timestamp(), m["map"], ", ".join(
                "%s %.4f" % (names[c], ap) for c, ap in m["ap"].items())),
            flush=True)
    m["timing"] = {k: v.avg for k, v in meters.items()}
    return m


def _gather_results(cfg: Config, dataset, results: Dict):
    """Every rank's detections, gathered as fixed-shape blocks (ref
    evaluate.py:339 `_score_multihost`), as (results, gt_boxes,
    gt_labels) over the whole split in its order, identical on every
    rank; wrap-padded duplicates keep their first copy."""
    world = cfg.world_size
    d = cfg.num_stack * cfg.topk
    m = -(-len(dataset) // world)
    ids = np.zeros((m, ID_BYTES), np.uint8)
    boxes = np.zeros((m, d, 4), np.float32)
    classes = np.zeros((m, d), np.int32)
    scores = np.zeros((m, d), np.float32)
    nval = np.zeros((m,), np.int32)
    for i, (image_id, r) in enumerate(results.items()):
        enc = image_id.encode()
        ids[i, :len(enc)] = np.frombuffer(enc, np.uint8)
        n = min(len(r["box"]), d)
        boxes[i, :n], classes[i, :n] = r["box"][:n], r["cls"][:n]
        scores[i, :n], nval[i] = r["score"][:n], n
    g_ids, g_boxes, g_classes, g_scores, g_nval = all_gather_arrays(
        (ids, boxes, classes, scores, nval))
    found = {}
    for p in range(world):
        for i in range(m):
            image_id = bytes(g_ids[p, i]).rstrip(b"\0").decode()
            if image_id and image_id not in found:
                n = int(g_nval[p, i])
                found[image_id] = {"box": g_boxes[p, i, :n],
                                   "cls": g_classes[p, i, :n],
                                   "score": g_scores[p, i, :n]}
    id2ann = dict(zip(dataset.ids, dataset.annotations))
    missing = sorted(set(found) - set(id2ann))
    if missing:
        # a fallback id (an XML with no <filename>) names no annotation
        raise ValueError("multi-host eval cannot resolve image ids %s to "
                         "annotation files (images must carry real "
                         "<filename> tags)" % missing[:5])
    out, gt_boxes, gt_labels = {}, {}, {}
    for image_id in dataset.ids:
        if image_id in found:
            out[image_id] = found[image_id]
            voc = parse_voc_xml(ET.parse(id2ann[image_id]).getroot())
            gt_boxes[image_id], gt_labels[image_id] = \
                boxes_from_voc_dict(voc)
    return out, gt_boxes, gt_labels


def demo(cfg: Config) -> Dict:
    """Single-image demo (≡ ref evaluate.py:245-290): `cfg.data` is the
    image; the overlay goes to `<save_path>/image.png`."""
    dev = resolve_device(cfg.device)
    model = load_eval_state(cfg, dev)
    imsize = int(cfg.imsize or 512)
    img, img_pil, origin_size = imload(cfg.data, cfg.pretrained, imsize)
    scales = None
    if cfg.infer_dtype == "int8":
        # the saved artifact when given, else calibrate on the demo image
        # (the normalized wire)
        scales = (load_scales(cfg.quant_scales) if cfg.quant_scales
                  else calibrate_scales(cfg, model.state_dict(), [img],
                                        dtype=model.dtype,
                                        percentile=cfg.calib_percentile,
                                        device=dev))
    predict = make_predict_fn(model, cfg, device=dev, quant_scales=scales)
    # one image through the engine's bucket (1,), the normalized wire
    with serve_engine(cfg, predict, imsize, np.float32, (1,), 0.0) as engine:
        row = engine.submit(img[0]).result()
    keep = row.valid
    boxes = np.clip(row.boxes[keep], 0, imsize)  # clamp (ref :270)
    classes, scores = row.classes[keep], row.scores[keep]
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
