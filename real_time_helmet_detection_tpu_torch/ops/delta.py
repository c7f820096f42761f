"""Per-tile frame-delta summary and the tile crop/stitch helpers of the
streaming plane (`serving/streams.py`).

Port of ref real_time_helmet_detection_tpu/ops/delta.py:43-125
(`tile_shape`, `tile_origins`, `tile_delta_summary`, `make_delta_fn`,
`crop_tile`, `offset_detections`, `stitch_detections`); the reference
has no change detection (its video loop runs every frame). A frame is a `grid x grid`
array of equal tiles, each the tile model's input size; the summary is
one `(T,)` float32 vector, the mean |cur - prev| of each tile in
[0, 255], row-major over the grid (the `tile_origins` order every
consumer shares).

`tile_delta_summary` is plain PyTorch on the uint8 pair (XLA in the JAX
package, no Pallas kernel): the difference in int32, each tile's sum as
an exact integer (int64), then one float32 division (by a tensor: a
host-scalar divisor on CUDA becomes a multiply by its reciprocal, which
rounds once more than the CPU's division). A 1024^2 x 3
frame's tile sums pass 2^24, where a float32 sum would round in an order
of its own; integer sums make the card's value and the CPU's the same
bit for bit, so a gate decision never depends on the device. The JAX
package sums in float32, equal to these where the sums stay below 2^24.

Stitching is host arithmetic: per-tile Detections (tile pixels) are
shifted by their tile origin and concatenated, `T * N` rows with the
valid mask intact.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .decode import Detections

# default tile grid (G x G tiles a frame); the config's stream_tile_grid
# overrides it per session
TILE_GRID_DEFAULT = 2


def tile_shape(frame_shape: Tuple[int, ...], grid: int) -> Tuple[int, int]:
    """(tile_h, tile_w) of an (H, W, C) frame cut into grid x grid tiles;
    raises unless the frame divides evenly."""
    h, w = int(frame_shape[0]), int(frame_shape[1])
    if grid < 1 or h % grid or w % grid:
        raise ValueError(
            "frame %dx%d does not divide into a %dx%d tile grid"
            % (h, w, grid, grid))
    return h // grid, w // grid


def tile_origins(frame_shape: Tuple[int, ...],
                 grid: int) -> List[Tuple[int, int]]:
    """Row-major (y0, x0) origins of the grid's T = grid * grid tiles."""
    th, tw = tile_shape(frame_shape, grid)
    return [(gy * th, gx * tw)
            for gy in range(grid) for gx in range(grid)]


def tile_delta_summary(prev: torch.Tensor, cur: torch.Tensor,
                       grid: int = TILE_GRID_DEFAULT) -> torch.Tensor:
    """Mean absolute change per tile: an (H, W, C) uint8 pair on one
    device -> (T,) float32 on it, row-major over the grid."""
    h, w, c = prev.shape
    th, tw = tile_shape((h, w), grid)
    diff = (cur.to(torch.int32) - prev.to(torch.int32)).abs_()
    sums = diff.view(grid, th, grid, tw, c).sum(dim=(1, 3, 4),
                                                dtype=torch.int64)
    sums = sums.reshape(-1).to(torch.float32)
    # a tensor divisor: CUDA's division by a host scalar multiplies by
    # its reciprocal, one rounding more than the CPU's true division
    return sums / torch.full_like(sums, float(th * tw * c))


class DeltaFn:
    """The session's summary program on `device`: `upload(frame)` copies
    one uint8 frame there (once), `__call__(prev, cur)` takes two
    uploaded frames and returns the (T,) summary as numpy, its one small
    copy back."""

    def __init__(self, grid: int = TILE_GRID_DEFAULT, device="cuda"):
        self.grid = int(grid)
        self.device = torch.device(device)

    def upload(self, frame) -> torch.Tensor:
        return torch.as_tensor(np.asarray(frame)).to(self.device)

    def __call__(self, prev, cur) -> np.ndarray:
        prev = prev if torch.is_tensor(prev) else self.upload(prev)
        cur = cur if torch.is_tensor(cur) else self.upload(cur)
        return tile_delta_summary(prev, cur, self.grid).cpu().numpy()


def make_delta_fn(grid: int = TILE_GRID_DEFAULT,
                  device="cuda") -> DeltaFn:
    """The session's summary program: (prev, cur) uint8 -> (T,) float32
    numpy, computed on `device` (the CPU only when asked)."""
    return DeltaFn(grid, device)


def crop_tile(frame: np.ndarray, y0: int, x0: int, th: int,
              tw: int) -> np.ndarray:
    """A fixed-shape host view of one tile (the session crops before it
    submits, so the engine sees one tile shape)."""
    return frame[y0:y0 + th, x0:x0 + tw]


def offset_detections(det: Detections, y0: int, x0: int) -> Detections:
    """A tile's detections (x1, y1, x2, y2 in tile pixels) shifted into
    frame coordinates; numpy on the host, invalid rows shift too."""
    boxes = np.asarray(det.boxes) + np.array(
        [x0, y0, x0, y0], dtype=np.float32)
    return Detections(boxes=boxes, classes=np.asarray(det.classes),
                      scores=np.asarray(det.scores),
                      valid=np.asarray(det.valid))


def stitch_detections(tile_dets: List[Detections],
                      origins: List[Tuple[int, int]]) -> Detections:
    """Per-tile blocks (tile_origins order) -> one frame Detections of
    T * N rows."""
    if len(tile_dets) != len(origins):
        raise ValueError("got %d tile results for %d tiles"
                         % (len(tile_dets), len(origins)))
    shifted = [offset_detections(d, y0, x0)
               for d, (y0, x0) in zip(tile_dets, origins)]
    return Detections(
        boxes=np.concatenate([d.boxes for d in shifted], axis=0),
        classes=np.concatenate([d.classes for d in shifted], axis=0),
        scores=np.concatenate([d.scores for d in shifted], axis=0),
        valid=np.concatenate([d.valid for d in shifted], axis=0))
