"""The quality matrix's data: the synthetic VOC fixture, regenerated only
when its generation parameters change (ref scripts/quality_matrix.py:164-185),
the held-out split as uint8 model inputs, and the video fixture of
`--streams` drawn from it (ref scripts/quality_matrix.py:738-866):
grid x grid tiles from the held-out pool, each tile replaced
with probability 1 - redundancy in every frame, and a uint8 sensor
jitter so that a static tile still has a delta above zero. Every draw is
numpy's, in JAX's order, so one seed gives both packages the same
frames."""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from ..data.eval_loader import eval_batches
from ..data.synthetic import make_synthetic_voc
from ..data.voc import VOCDataset, boxes_from_voc_dict
from ..utils import save_json

DATASET_SEED = 42     # the fixture's images and boxes
VIDEO_SEED = 1717     # the streams' tile draws and jitter


def ensure_dataset(root: str, n_train: int, n_test: int, imsize: int,
                   style: str, max_objects: int,
                   log=lambda msg: None) -> bool:
    """The fixture under `root`, made anew unless its `dataset_meta.json`
    holds these generation parameters: a smaller stale fixture is never
    trained on under a record of the larger one. True when it was made."""
    meta = {"n_train": n_train, "n_test": n_test, "imsize": imsize,
            "style": style, "max_objects": max_objects}
    path = os.path.join(root, "dataset_meta.json")
    try:
        with open(path) as f:
            have = json.load(f)
    except (OSError, json.JSONDecodeError):
        have = None
    if have != meta:
        if os.path.isdir(root):
            shutil.rmtree(root)
        log("generating %s dataset (%d train / %d test @%d^2)..."
            % (style, n_train, n_test, imsize))
        make_synthetic_voc(root, num_train=n_train, num_test=n_test,
                           imsize=(imsize, imsize), max_objects=max_objects,
                           seed=DATASET_SEED, style=style)
        save_json(path, meta)
    return have != meta


def held_out(root: str, imsize: int,
             batch_size: int = 16) -> Tuple[List[np.ndarray], List[Dict]]:
    """The test split in order: (uint8 (imsize, imsize, 3) images, their
    VOC dicts)."""
    images, infos = [], []
    for b in eval_batches(VOCDataset(root, image_set="test"), imsize,
                          batch_size):
        images.extend(b.image)
        infos.extend(b.infos)
    return images, infos


def image_id(info: Dict, k: int) -> str:
    """The id an eval keys image `k` by (its file name without suffix)."""
    return os.path.splitext(info["annotation"].get("filename")
                            or "%06d" % k)[0]


def origin_size(info: Dict) -> Tuple[int, int]:
    size = info["annotation"]["size"]
    return int(size["width"]), int(size["height"])


def video_fixture(images: List[np.ndarray], n_seq: int, frames: int,
                  tiles: int, redundancy: float, noise: int,
                  seed: int = VIDEO_SEED):
    """(seq_idx, noisy): seq_idx[s][f][k] is the pool index of tile k of
    frame f of stream s, and noisy[(s, f, k)] that image with a uniform
    integer jitter in [-noise, noise], clipped to uint8."""
    rng = np.random.default_rng(seed)
    n_pool = len(images)
    seq_idx = []
    for _ in range(n_seq):
        cur = [int(i) for i in rng.integers(0, n_pool, size=tiles)]
        fr = [list(cur)]
        for _ in range(1, frames):
            cur = [int(rng.integers(0, n_pool))
                   if rng.random() >= redundancy else i for i in cur]
            fr.append(list(cur))
        seq_idx.append(fr)
    noisy = {}
    for s in range(n_seq):
        for f in range(frames):
            for k in range(tiles):
                img = images[seq_idx[s][f][k]].astype(np.int16)
                jit = rng.integers(-noise, noise + 1, size=img.shape)
                noisy[(s, f, k)] = np.clip(img + jit, 0, 255).astype(
                    np.uint8)
    return seq_idx, noisy


def assemble_frame(noisy: Dict, s: int, f: int, grid: int) -> np.ndarray:
    """Frame f of stream s: its tiles laid out row-major on the grid."""
    ts = [noisy[(s, f, k)] for k in range(grid * grid)]
    return np.concatenate([np.concatenate(ts[r * grid:(r + 1) * grid],
                                          axis=1) for r in range(grid)],
                          axis=0)


def frame_ground_truth(infos: List[Dict], seq_idx, origins, imsize: int):
    """Each frame's ground truth in model coordinates, keyed
    "sNN_fNN": every tile's VOC boxes scaled to the model canvas and
    shifted to its tile origin."""
    tile_gt = {}
    for idx in {i for fr in seq_idx for tl in fr for i in tl}:
        ow, oh = origin_size(infos[idx])
        gb, gl = boxes_from_voc_dict(infos[idx])
        sc = np.array([imsize / ow, imsize / oh, imsize / ow, imsize / oh],
                      np.float32)
        tile_gt[idx] = (gb * sc, gl)
    gt_boxes, gt_labels = {}, {}
    for s, frames in enumerate(seq_idx):
        for f, tiles in enumerate(frames):
            bs, ls = [], []
            for k, idx in enumerate(tiles):
                y0, x0 = origins[k]
                gb, gl = tile_gt[idx]
                bs.append(gb + np.array([x0, y0, x0, y0], np.float32))
                ls.append(gl)
            fid = frame_id(s, f)
            gt_boxes[fid] = (np.concatenate(bs) if bs
                             else np.zeros((0, 4), np.float32))
            gt_labels[fid] = (np.concatenate(ls) if ls
                              else np.zeros((0,), np.int64))
    return gt_boxes, gt_labels


def frame_id(s: int, f: int) -> str:
    return "s%02d_f%02d" % (s, f)
