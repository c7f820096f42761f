"""Utilities for the PyTorch port: atomic artifact writes, normalization
statistics, image I/O, box drawing, meters.

The port keeps its own copy of what it needs from the JAX package's
`utils.py` (ref real_time_helmet_detection_tpu/utils.py:25 and the
reference helpers ref utils.py:9-94): the same atomic tmp + os.replace
writes, the same normalization statistics, the same PIL image path.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def atomic_write_bytes(path, data: bytes) -> None:
    """Write through a tmp file beside the target and `os.replace`: a kill
    mid-write never leaves a truncated file where a complete one stood."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        # the atomic-write implementation itself
        with open(tmp, "wb") as f:  # graftlint: off=raw-artifact-write
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def save_json(path, obj, **dump_kw) -> None:
    atomic_write_bytes(path, json.dumps(obj, **dump_kw).encode())


def save_pickle(path, data) -> None:
    atomic_write_bytes(
        path, pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL))


class AverageMeter:
    """Running mean (ref utils.py:19-31)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def timestamp() -> str:
    return time.ctime()


_STATS = {
    "imagenet": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "scratch": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
}


def normalizer_stats(pretrained: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) as (3,) float32 arrays (ref utils.py:55-68)."""
    try:
        mean, std = _STATS[pretrained.lower()]
    except KeyError:
        raise NotImplementedError(
            "Not expected dataset pretrained parameter: %s" % pretrained)
    return np.asarray(mean, np.float32), np.asarray(std, np.float32)


def normalize_image(img: np.ndarray, pretrained: str = "imagenet") -> np.ndarray:
    """uint8 (H, W, 3) -> normalized float32 channels-last."""
    mean, std = normalizer_stats(pretrained)
    return (img.astype(np.float32) / 255.0 - mean) / std


def imload(path: str, pretrained: str = "imagenet", size: Optional[int] = None):
    """One image for the demo (ref utils.py:87-94): returns
    (img (1, H, W, 3) normalized float32, PIL image, origin (W, H))."""
    img_pil = Image.open(path).convert("RGB")
    origin_size = img_pil.size
    if size:
        img_pil = img_pil.resize((size, size))
    img = normalize_image(np.asarray(img_pil), pretrained)[None]
    return img, img_pil, origin_size


def draw_box(pil: Image.Image, box, width: int = 2, color=(0, 0, 255)) -> Image.Image:
    draw = ImageDraw.Draw(pil)
    # a raw size regression can emit inverted boxes, which PIL refuses
    x1, y1, x2, y2 = map(int, box)
    draw.rectangle([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)],
                   width=width, outline=color, fill=None)
    return pil


def write_text(pil: Image.Image, text: str, coordinate, fontsize: int = 15,
               fontcolor: str = "red") -> Image.Image:
    draw = ImageDraw.Draw(pil)
    try:
        font = ImageFont.truetype("arial.ttf", size=fontsize)
    except OSError:  # font not shipped; PIL's built-in bitmap font
        font = ImageFont.load_default()
    draw.text(coordinate, text, fill=fontcolor, font=font)
    return pil
