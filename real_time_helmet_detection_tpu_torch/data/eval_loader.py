"""Deterministic eval input: square resize + raw uint8 batches.

Port of ref real_time_helmet_detection_tpu/data/augment.py:153
`TestAugmentor` (reference data.py:163-170) and the raw path of
ref data/pipeline.py:122 `collate`: images are resized to
(imsize, imsize) with PIL bilinear and stacked as uint8 — normalization
happens on the device inside `predict`, so images cross to the card at a
quarter of the float32 bytes.

The JAX package feeds eval from a threaded prefetching loader; this is a
plain sequential iterator (no threads, no locks).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple

import numpy as np
from PIL import Image


class EvalBatch(NamedTuple):
    image: np.ndarray  # (B, S, S, 3) uint8
    infos: List[Dict]  # per-image voc dicts (eval needs the origin size)


def resize_image(img: np.ndarray, imsize: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (imsize, imsize, 3) uint8, PIL bilinear."""
    t = int(imsize)
    return np.asarray(Image.fromarray(img).resize((t, t), Image.BILINEAR))


def eval_batches(dataset, imsize: int, batch_size: int) -> Iterator[EvalBatch]:
    """Batches over the dataset in order; the last one may be short."""
    for start in range(0, len(dataset), batch_size):
        images, infos = [], []
        for i in range(start, min(start + batch_size, len(dataset))):
            img, _boxes, _labels, info = dataset[i]
            images.append(resize_image(img, imsize))
            infos.append(info)
        yield EvalBatch(image=np.stack(images), infos=infos)
