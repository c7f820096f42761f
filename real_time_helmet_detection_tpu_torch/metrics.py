"""Self-contained VOC-style mAP, and the per-image detection txt files.

A copy of ref real_time_helmet_detection_tpu/metrics.py:91 `compute_map`
(the reference delegates AP to the external Cartucho/mAP tool and writes
its `cls score x1 y1 x2 y2` txt files, reference evaluate.py:43-54):
PASCAL VOC2010+ all-point interpolated AP, IoU >= 0.5, greedy best-IoU
matching of score-sorted detections, duplicates of a matched GT counted
as false positives, classes absent from the ground truth left out.
`read_detection_txt` / `compute_map_from_txt` (ref metrics.py:139-166)
score a directory of those txt files, the eval's `results/txt`, against
in-memory ground truth; an image with no file has no detections.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .utils import atomic_write_bytes


def box_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one (4,) box against (N, 4) boxes, xyxy."""
    if len(boxes) == 0:
        return np.zeros((0,), np.float32)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area + areas - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (VOC2010+ / Cartucho-mAP definition)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def compute_class_ap(gt: Mapping[str, np.ndarray],
                     detections: Sequence[Tuple[str, float, np.ndarray]],
                     iou_th: float = 0.5) -> Tuple[float, int]:
    """(AP, number of GT boxes) for one class; NaN when the class has no
    ground truth."""
    num_gt = sum(len(b) for b in gt.values())
    if num_gt == 0:
        return float("nan"), 0
    if not detections:
        return 0.0, num_gt
    matched = {img: np.zeros(len(b), bool) for img, b in gt.items()}
    dets = sorted(detections, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, _, box) in enumerate(dets):
        boxes = gt.get(img, np.zeros((0, 4), np.float32))
        ious = box_iou(np.asarray(box, np.float32), boxes)
        j = int(np.argmax(ious)) if len(ious) else -1
        if j >= 0 and ious[j] >= iou_th and not matched[img][j]:
            matched[img][j] = True
            tp[i] = 1.0
        else:
            fp[i] = 1.0
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    recall = tp / max(num_gt, 1)
    precision = tp / np.maximum(tp + fp, 1e-9)
    return voc_ap(recall, precision), num_gt


def compute_map(gt_boxes: Mapping[str, np.ndarray],
                gt_labels: Mapping[str, np.ndarray],
                det_boxes: Mapping[str, np.ndarray],
                det_labels: Mapping[str, np.ndarray],
                det_scores: Mapping[str, np.ndarray],
                num_cls: int = 2, iou_th: float = 0.5) -> Dict:
    """{"ap": {cls: ap}, "map": float, "num_gt": {cls: n}} from per-image
    arrays keyed by image id."""
    aps, counts = {}, {}
    for c in range(num_cls):
        cls_gt = {img: np.asarray(b, np.float32).reshape(-1, 4)[
                      np.asarray(gt_labels[img]).reshape(-1) == c]
                  for img, b in gt_boxes.items()}
        cls_det: List[Tuple[str, float, np.ndarray]] = []
        for img, boxes in det_boxes.items():
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            labels = np.asarray(det_labels[img]).reshape(-1)
            scores = np.asarray(det_scores[img]).reshape(-1)
            for b, l, s in zip(boxes, labels, scores):
                if int(l) == c:
                    cls_det.append((img, float(s), b))
        aps[c], counts[c] = compute_class_ap(cls_gt, cls_det, iou_th)
    vals = [v for v in aps.values() if not np.isnan(v)]
    return {"ap": aps, "map": float(np.mean(vals)) if vals else 0.0,
            "num_gt": counts}


def write_detection_txt(out_dir: str, image_id: str, boxes, labels,
                        scores) -> str:
    """One image's detections as `cls score x1 y1 x2 y2` lines, written
    atomically (ref evaluate.py:46-54)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, image_id + ".txt")
    lines = "".join("%d %f %f %f %f %f\n"
                    % (int(l), float(s), b[0], b[1], b[2], b[3])
                    for b, l, s in zip(boxes, labels, scores))
    atomic_write_bytes(path, lines.encode())
    return path


def read_detection_txt(path: str):
    """One detection txt back as (boxes (N, 4), labels, scores)."""
    boxes, labels, scores = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 6:
                continue
            labels.append(int(parts[0]))
            scores.append(float(parts[1]))
            boxes.append([float(x) for x in parts[2:]])
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32), np.asarray(scores, np.float32))


def compute_map_from_txt(det_dir: str, gt_boxes, gt_labels, num_cls: int = 2,
                         iou_th: float = 0.5) -> Dict:
    """`compute_map` of the detection txt files in `det_dir`."""
    det_b, det_l, det_s = {}, {}, {}
    for fname in os.listdir(det_dir):
        if not fname.endswith(".txt"):
            continue
        img = fname[:-4]
        det_b[img], det_l[img], det_s[img] = read_detection_txt(
            os.path.join(det_dir, fname))
    for img in gt_boxes:
        det_b.setdefault(img, np.zeros((0, 4), np.float32))
        det_l.setdefault(img, np.zeros((0,), np.int32))
        det_s.setdefault(img, np.zeros((0,), np.float32))
    return compute_map(gt_boxes, gt_labels, det_b, det_l, det_s, num_cls,
                       iou_th)
