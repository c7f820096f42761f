"""Synthetic SHWD-style fixture dataset, for tests and the chip smoke run.

A copy of the "blocks" style of ref
real_time_helmet_detection_tpu/data/synthetic.py:224 `make_synthetic_voc`
(the reference has no test fixtures at all): a miniature VOC2028-layout
dataset (JPEGImages / Annotations / ImageSets/Main) whose objects are
opaque non-overlapping rectangles on dark noise, drawn from the same
numpy generator calls, so one seed gives the same files as the JAX
package's generator. Every file is written atomically.
"""

from __future__ import annotations

import io
import os
from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw

from ..utils import atomic_write_bytes
from .voc import INDEX2CLASS

_XML = """<annotation>
  <folder>VOC2028</folder>
  <filename>{fname}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  <segmented>0</segmented>
{objects}</annotation>
"""

_OBJ = """  <object>
    <name>{name}</name>
    <pose>Unspecified</pose>
    <truncated>0</truncated>
    <difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>
"""


def _draw_blocks(rng, w: int, h: int, max_objects: int):
    """Opaque non-overlapping colored rectangles on dark noise."""
    img = Image.fromarray(rng.integers(0, 80, (h, w, 3), dtype=np.uint8))
    draw = ImageDraw.Draw(img)
    boxes, placed = [], []
    for _ in range(int(rng.integers(1, max_objects + 1))):
        cls = int(rng.integers(0, 2))
        for _attempt in range(20):
            bw = int(rng.integers(w // 8, w // 3))
            bh = int(rng.integers(h // 8, h // 3))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            x2, y2 = x1 + bw, y1 + bh
            if all(x1 >= px2 or x2 <= px1 or y1 >= py2 or y2 <= py1
                   for px1, py1, px2, py2 in placed):
                break
        else:
            continue  # no free spot; place fewer objects
        placed.append((x1, y1, x2, y2))
        color = (220, 40, 40) if cls == 0 else (40, 220, 40)
        draw.rectangle([x1, y1, x2, y2], fill=color)
        boxes.append((cls, x1, y1, x2, y2))
    return img, boxes


def make_synthetic_voc(root: str, num_train: int = 8, num_test: int = 4,
                       imsize: Tuple[int, int] = (160, 120),
                       max_objects: int = 3, seed: int = 0) -> str:
    """Write the fixture under `root` (JPEG quality 90); returns root."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages")
    ann_dir = os.path.join(root, "Annotations")
    set_dir = os.path.join(root, "ImageSets", "Main")
    for d in (img_dir, ann_dir, set_dir):
        os.makedirs(d, exist_ok=True)
    counter = 0
    for split, n in (("trainval", num_train), ("test", num_test)):
        names = []
        for _ in range(n):
            fname = "%06d" % counter
            counter += 1
            names.append(fname)
            w, h = imsize
            img, boxes = _draw_blocks(rng, w, h, max_objects)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=90)
            atomic_write_bytes(os.path.join(img_dir, fname + ".jpg"),
                               buf.getvalue())
            objects = "".join(
                _OBJ.format(name=INDEX2CLASS[c], x1=x1, y1=y1, x2=x2, y2=y2)
                for c, x1, y1, x2, y2 in boxes)
            atomic_write_bytes(
                os.path.join(ann_dir, fname + ".xml"),
                _XML.format(fname=fname, w=w, h=h, objects=objects).encode())
        atomic_write_bytes(os.path.join(set_dir, split + ".txt"),
                           ("\n".join(names) + "\n").encode())
    return root
