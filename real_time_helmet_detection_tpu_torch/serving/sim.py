"""Simulated replicas: predicts with a fixed service time whose rows are a
pure function of the image bytes.

Port of ref scripts/serve_bench.py:378-450 (`_SimCompiled`,
`SimServePredict`, `_SimCascadeCompiled`, `SimCascadePredict`) and
:1001-1033 (`_SimStreamCompiled`, `SimStreamPredict`), with `_sim_pool`
(:557). They are a labelled service model, not a fallback: the record
sections that use one say so (`replica_sim_ms`, `edge_sim_ms`,
`tile_sim_ms`, `note`).

Each sim is a `predict.Predict` on the CPU. Its `body` sleeps (a wait
that releases the GIL: a remote replica's latency is device time the
host only waits on), then computes its rows from the bytes of the
images, so a `ServingEngine` builds a `BucketRunner` for it through its
CPU path and serves it like a model: what a sim row measures is the
host cost of the engine and the router, never the card. The rows fit
the engine's fixed `Detections` leaves:

* `SimServePredict`: one box per image, JAX's `imgs[:, :2, :2, 0]` as
  float32 (`boxes` (B, 1, 4)), its sum as the score (`scores` (B, 1)),
  class 0, valid.
* `SimCascadePredict`: the same rows plus the per-image `confidence`
  pixel[0, 0, 0] / 255 (`CascadeDetections`): `sim_confidence` is the
  host oracle of the escalation mix of a pool.
* `SimStreamPredict`: JAX's four tile rows (`boxes` from the first
  column of channel 0, classes from channel 1 mod 2, scores channel 2 /
  255), and a batch of b sleeps b times the tile time: tile convs are
  compute-bound, so capacity is tiles/s and a skipped tile buys
  headroom while batching buys none.

A sim has no weights: `load` (a reload, a respawn's restore) changes
nothing.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..ops.decode import CascadeDetections, Detections
from ..predict import Predict

# rows of one simulated tile (ref serve_bench.py:998 `_SIM_TILE_ROWS`)
SIM_TILE_ROWS = 4


class SimServePredict(Predict):
    """A fixed-service-time predict: `service_ms` of sleep per batch,
    then one row per image from its bytes (module docstring)."""

    def __init__(self, service_ms: float):
        self.service_s = max(0.0, float(service_ms)) / 1e3
        super().__init__(self._body, None, torch.device("cpu"))

    def service_time(self, batch: int) -> float:
        """Seconds one batch of `batch` images sleeps."""
        return self.service_s

    def rows(self, imgs: np.ndarray):
        """The batch's rows, a pure function of the uint8 images."""
        b = imgs.shape[0]
        boxes = imgs[:, :2, :2, 0].astype(np.float32).reshape(b, 1, 4)
        return Detections(boxes=torch.from_numpy(boxes),
                          classes=torch.zeros((b, 1), dtype=torch.int32),
                          scores=torch.from_numpy(boxes.sum(axis=2)),
                          valid=torch.ones((b, 1), dtype=torch.bool))

    def _body(self, x: torch.Tensor):
        time.sleep(self.service_time(x.shape[0]))
        return self.rows(x.numpy())

    def load(self, variables, scales=None) -> None:
        """A sim has no weights: nothing to load."""


class SimCascadePredict(SimServePredict):
    """The edge tier's sim: `SimServePredict`'s rows plus the per-image
    confidence pixel[0, 0, 0] / 255, in [0, 1]."""

    def rows(self, imgs: np.ndarray):
        det = super().rows(imgs)
        conf = imgs[:, 0, 0, 0].astype(np.float32) / np.float32(255.0)
        return CascadeDetections(*det, confidence=torch.from_numpy(conf))

    @staticmethod
    def sim_confidence(img: np.ndarray) -> float:
        """The host oracle of one image's confidence."""
        return float(img[0, 0, 0]) / 255.0


class SimStreamPredict(SimServePredict):
    """A tile replica's sim: `service_ms` per tile of the padded batch,
    four Detections rows per tile from the tile's bytes."""

    def service_time(self, batch: int) -> float:
        return self.service_s * batch

    def rows(self, imgs: np.ndarray):
        k = SIM_TILE_ROWS
        base = imgs[:, :k, 0, 0].astype(np.float32)
        boxes = np.stack([base, base, base + 4.0, base + 4.0], axis=-1)
        classes = (imgs[:, :k, 1, 0] % 2).astype(np.int32)
        scores = imgs[:, :k, 2, 0].astype(np.float32) / np.float32(255.0)
        return Detections(
            boxes=torch.from_numpy(boxes), classes=torch.from_numpy(classes),
            scores=torch.from_numpy(scores),
            valid=torch.ones((imgs.shape[0], k), dtype=torch.bool))


def sim_pool(args) -> List[np.ndarray]:
    """`--pool` seeded uint8 images of `--imsize`^2 (the same draws as
    the JAX script's pool)."""
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, 256, (args.imsize, args.imsize, 3),
                         dtype=np.uint8) for _ in range(args.pool)]


def sim_confidence(img: np.ndarray) -> float:
    """`SimCascadePredict.sim_confidence`."""
    return SimCascadePredict.sim_confidence(img)
