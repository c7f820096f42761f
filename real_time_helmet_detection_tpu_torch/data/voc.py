"""VOC2028 / SHWD dataset parsing for the PyTorch port.

A copy of ref real_time_helmet_detection_tpu/data/voc.py:83 `VOCDataset`
(reference data.py:22-91 `VOC`): the same directory layout
(`JPEGImages`, `Annotations`, `ImageSets/Main/{trainval,test}.txt`), the
same recursive XML -> dict parser and the same class map
`{'hat': 0, 'person': 1, 'dog': 0}` (SHWD's mislabeled `dog` boxes fold
into class 0). `__getitem__` returns plain numpy:
`(image uint8 (H, W, 3), boxes float32 (N, 4) xyxy, labels int32 (N,),
voc_dict)`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

CLASS2INDEX = {"hat": 0, "person": 1, "dog": 0}
INDEX2CLASS = {0: "hat", 1: "person"}
CLASS2COLOR = {0: (255, 0, 0), 1: (0, 255, 0)}


def _element_value(node: ET.Element):
    """A leaf's stripped text; for an interior node a dict keyed by child
    tag (a repeated tag maps to a list). `annotation`'s `object` children
    are always a list, whatever their count."""
    if len(node) == 0:
        return (node.text or "").strip()
    grouped: Dict[str, List] = {}
    for child in node:
        grouped.setdefault(child.tag, []).append(_element_value(child))
    value = {tag: vals[0] if len(vals) == 1 else vals
             for tag, vals in grouped.items()}
    if node.tag == "annotation":
        value["object"] = grouped.get("object", [])
    return value


def parse_voc_xml(node: ET.Element) -> Dict:
    """XML -> nested dict in the VOCDetection convention."""
    return {node.tag: _element_value(node)}


def boxes_from_voc_dict(voc_dict: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(boxes (N, 4) xyxy float32, labels (N,) int32) (ref data.py:55-63);
    placeholder objects (empty name or bndbox) are skipped."""
    boxes: List[List[int]] = []
    labels: List[int] = []
    objects = voc_dict.get("annotation", {}).get("object", [])
    if isinstance(objects, dict):
        objects = [objects]
    for obj in objects:
        if not isinstance(obj, dict) or not obj.get("name") \
                or not isinstance(obj.get("bndbox"), dict):
            continue
        labels.append(CLASS2INDEX[obj["name"].lower()])
        bb = obj["bndbox"]
        boxes.append([int(bb["xmin"]), int(bb["ymin"]),
                      int(bb["xmax"]), int(bb["ymax"])])
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
    return np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


class VOCDataset:
    """SHWD/VOC2028 image + annotation reader (ref data.py:22-53)."""

    def __init__(self, root: str, image_set: str = "trainval"):
        split_f = os.path.join(root, "ImageSets", "Main",
                               image_set.rstrip("\n") + ".txt")
        with open(split_f) as f:
            names = [x.strip() for x in f.readlines() if x.strip()]
        self.ids = names
        self.images = [os.path.join(root, "JPEGImages", x + ".jpg")
                       for x in names]
        self.annotations = [os.path.join(root, "Annotations", x + ".xml")
                            for x in names]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        img = np.asarray(Image.open(self.images[index]).convert("RGB"))
        voc_dict = parse_voc_xml(ET.parse(self.annotations[index]).getroot())
        boxes, labels = boxes_from_voc_dict(voc_dict)
        return img, boxes, labels, voc_dict
