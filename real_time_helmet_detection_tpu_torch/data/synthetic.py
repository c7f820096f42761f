"""Synthetic SHWD-style fixture dataset, for tests and the chip smoke run.

A copy of ref real_time_helmet_detection_tpu/data/synthetic.py:41-275
(`make_synthetic_voc` and its two styles; the reference has no test
fixtures at all): a miniature VOC2028-layout dataset (JPEGImages /
Annotations / ImageSets/Main), drawn from the same numpy generator calls,
so one seed gives the same files as the JAX package's generator. Every
file is written atomically.

* style="blocks": opaque non-overlapping rectangles on dark noise, JPEG
  quality 90 — a fast "the pipeline learns" signal.
* style="scenes": head glyphs ("hat" = helmeted head, "person" = bare
  head, annotated by the tight head box) over a textured background
  with decoys, a log-uniform head scale in [min_dim / far_div, min_dim /
  near_div] (`head_div_range`), occlusion capped by coverage, a
  `helmeted_rate` class balance (0.72 by default, SHWD-like) and a
  global illumination jitter, JPEG quality 60-91 — a fixture whose mAP
  has headroom.

`synthetic_target_batch` makes a random batch that is already encoded,
for train-step tests and the chip smoke run.
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


# palettes of the "scenes" style
_HELMET_COLORS = [(230, 200, 40), (200, 50, 40), (40, 90, 200),
                  (240, 240, 235), (240, 140, 40)]
_HAIR_COLORS = [(25, 20, 18), (60, 40, 25), (110, 100, 95), (140, 120, 90)]
_SKIN_TONES = [(240, 200, 170), (200, 150, 120), (150, 100, 70),
               (105, 70, 50)]


def _textured_background(rng, w: int, h: int) -> Image.Image:
    """Cluttered background: smooth low-frequency color field + distractor
    shapes (some in helmet-like colors, none with the head-on-shoulders
    structure that defines the classes)."""
    low = rng.integers(30, 180, (h // 24 + 2, w // 24 + 2, 3)).astype(np.uint8)
    img = Image.fromarray(low).resize((w, h), Image.BILINEAR)
    draw = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(6, 16))):
        x1 = int(rng.integers(0, w)); y1 = int(rng.integers(0, h))
        x2 = x1 + int(rng.integers(4, w // 3))
        y2 = y1 + int(rng.integers(4, h // 3))
        bright = rng.random() < 0.3  # occasional helmet-colored decoys
        color = (tuple(_HELMET_COLORS[int(rng.integers(len(_HELMET_COLORS)))])
                 if bright else tuple(int(c) for c in rng.integers(20, 200, 3)))
        kind = rng.random()
        if kind < 0.45:
            draw.rectangle([x1, y1, x2, y2], fill=color)
        elif kind < 0.8:
            draw.ellipse([x1, y1, x2, y2], fill=color)
        else:
            draw.line([x1, y1, x2, y2], fill=color,
                      width=int(rng.integers(1, 6)))
    return img


def _draw_person(draw, rng, cx: int, cy: int, r: float, helmeted: bool):
    """One head glyph (+ body below as context): returns the tight head
    bbox, which is what SHWD annotates — 'hat' = helmeted head, 'person' =
    bare head (ref data.py:17 class map)."""
    rx = r * float(rng.uniform(0.85, 1.15))   # aspect jitter
    ry = r * float(rng.uniform(0.9, 1.25))
    # body: context pixels only, deliberately outside the annotation
    bw = rx * float(rng.uniform(1.4, 2.2))
    bh = ry * float(rng.uniform(2.5, 4.0))
    body_color = tuple(int(c) for c in rng.integers(30, 220, 3))
    draw.ellipse([cx - bw, cy + ry * 0.8, cx + bw, cy + ry * 0.8 + bh],
                 fill=body_color)
    skin = _SKIN_TONES[int(rng.integers(len(_SKIN_TONES)))]
    draw.ellipse([cx - rx, cy - ry, cx + rx, cy + ry], fill=skin)
    if helmeted:
        hc = _HELMET_COLORS[int(rng.integers(len(_HELMET_COLORS)))]
        # helmet shell: upper half-dome overshooting the scalp + brim line
        draw.pieslice([cx - rx * 1.15, cy - ry * 1.3,
                       cx + rx * 1.15, cy + ry * 0.9], 180, 360, fill=hc)
        draw.line([cx - rx * 1.15, cy - ry * 0.2, cx + rx * 1.15,
                   cy - ry * 0.2], fill=hc, width=max(1, int(r * 0.18)))
        top = cy - ry * 1.3
    else:
        hair = _HAIR_COLORS[int(rng.integers(len(_HAIR_COLORS)))]
        draw.pieslice([cx - rx, cy - ry, cx + rx, cy + ry * 0.6], 180, 360,
                      fill=hair)
        top = cy - ry
    x1 = int(round(cx - rx * (1.15 if helmeted else 1.0)))
    x2 = int(round(cx + rx * (1.15 if helmeted else 1.0)))
    return x1, int(round(top)), x2, int(round(cy + ry))


def _draw_scene(rng, w: int, h: int, max_objects: int,
                head_div_range=(28.0, 3.8), helmeted_rate: float = 0.72):
    """Hard fixture scene: textured clutter, a 5-10x head-scale range,
    aspect jitter, occlusion (heads may overlap up to a coverage cap),
    helmet-colored decoys and a `helmeted_rate` class balance; small far
    heads are drawn first so near objects occlude them.

    `head_div_range` = (far_div, near_div): head diameters are
    log-uniform in [min_dim/far_div, min_dim/near_div]; a larger far
    divisor keeps every head resolvable at stride 4 on a small canvas.
    A tiny overfit fixture needs `helmeted_rate` near 0.5 for the person
    class to have examples enough to learn."""
    img = _textured_background(rng, w, h)
    draw = ImageDraw.Draw(img)
    min_dim = min(w, h)
    far_div, near_div = head_div_range
    proposals = []
    for _ in range(int(rng.integers(1, max_objects + 1))):
        # log-uniform head diameter across [min/far_div, min/near_div]
        r = float(np.exp(rng.uniform(np.log(min_dim / far_div),
                                     np.log(min_dim / near_div)))) / 2.0
        helmeted = rng.random() < helmeted_rate  # SHWD-like imbalance
        proposals.append((r, helmeted))
    proposals.sort(key=lambda p: p[0])  # far (small) first
    def covered_frac(a, b):
        """Fraction of box a's area covered by box b."""
        iw = min(a[2], b[2]) - max(a[0], b[0])
        ih = min(a[3], b[3]) - max(a[1], b[1])
        if iw <= 0 or ih <= 0:
            return 0.0
        return iw * ih / max(1.0, (a[2] - a[0]) * (a[3] - a[1]))

    boxes = []
    for r, helmeted in proposals:
        for _attempt in range(20):
            cx = int(rng.integers(int(r * 1.3), max(int(r * 1.3) + 1,
                                                    w - int(r * 1.3))))
            cy = int(rng.integers(int(r * 1.4), max(int(r * 1.4) + 1,
                                                    int(h * 0.8))))
            # conservative MAXIMAL head extent: aspect jitter (<=1.15) x
            # helmet overshoot (<=1.15) wider, ry jitter (<=1.25) x helmet
            # dome (<=1.3) taller — the drawn annotation box is always
            # inside this, so the coverage caps below bound the real boxes
            head = (cx - r * 1.33, cy - r * 1.63, cx + r * 1.33,
                    cy + r * 1.25)
            # worst-case footprint of the body drawn BELOW this head
            # (aspect jitter maxima in _draw_person): bodies are drawn
            # after earlier (smaller) heads and would bury them silently
            body = (cx - r * 2.55, cy + r * 0.7, cx + r * 2.55,
                    cy + r * 0.7 + r * 5.0)
            ok = True
            for prev in boxes:
                pbox = prev[1:]
                # cap mutual head coverage: intersection-over-min-area
                # catches full containment that a plain IoU cap misses
                # (a tiny head inside a 50x-area head has IoU ~0.02)
                if max(covered_frac(head, pbox),
                       covered_frac(pbox, head)) > 0.3:
                    ok = False
                    break
                # and never bury an existing (smaller, farther) head under
                # this person's body ellipse beyond partial occlusion
                if covered_frac(pbox, body) > 0.55:
                    ok = False
                    break
            if ok:
                break
        else:
            continue
        bx1, by1, bx2, by2 = _draw_person(draw, rng, cx, cy, r, helmeted)
        bx1 = max(0, bx1); by1 = max(0, by1)
        bx2 = min(w - 1, bx2); by2 = min(h - 1, by2)
        if bx2 - bx1 >= 2 and by2 - by1 >= 2:
            boxes.append((0 if helmeted else 1, bx1, by1, bx2, by2))
    # global illumination jitter
    arr = np.asarray(img, np.float32) * float(rng.uniform(0.65, 1.25))
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)), boxes


def make_synthetic_voc(root: str, num_train: int = 8, num_test: int = 4,
                       imsize: Tuple[int, int] = (160, 120),
                       max_objects: int = 3, seed: int = 0,
                       style: str = "blocks",
                       head_div_range=(28.0, 3.8),
                       helmeted_rate: float = 0.72) -> str:
    """Write the fixture of `style` under `root`; returns root."""
    if style not in ("blocks", "scenes"):
        raise ValueError("style must be 'blocks' or 'scenes', got %r" % style)
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
            if style == "scenes":
                img, boxes = _draw_scene(rng, w, h, max_objects,
                                         head_div_range=head_div_range,
                                         helmeted_rate=helmeted_rate)
                quality = int(rng.integers(60, 92))
            else:
                img, boxes = _draw_blocks(rng, w, h, max_objects)
                quality = 90
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=quality)
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


def synthetic_target_batch(batch: int, imsize: int, num_cls: int = 2,
                           scale_factor: int = 4, seed: int = 0,
                           pos_rate: float = 0.05):
    """Random (image, heatmap, offset, wh, mask) batch with the train
    step's input contract (channels-last, encoded-map shapes at
    imsize/scale), from the same generator calls as ref
    data/synthetic.py:278 `synthetic_target_batch`."""
    m = imsize // scale_factor
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, imsize, imsize, 3)).astype(np.float32),
            rng.uniform(0, 1, (batch, m, m, num_cls)).astype(np.float32),
            rng.uniform(0, 1, (batch, m, m, 2)).astype(np.float32),
            rng.uniform(1, 8, (batch, m, m, 2)).astype(np.float32),
            (rng.uniform(0, 1, (batch, m, m, 1)) < pos_rate
             ).astype(np.float32))
