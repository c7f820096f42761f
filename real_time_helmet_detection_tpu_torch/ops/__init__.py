"""Kernels of the port: hand-written CUDA with plain PyTorch versions.

Importing the package registers the `helmet` operator namespace
(`ops.library`), through which the eval wrappers reach their kernels.
It also exports the streaming plane's tile helpers (`ops.delta`).
"""

from . import library  # noqa: F401
from .delta import (TILE_GRID_DEFAULT, crop_tile,  # noqa: F401
                    make_delta_fn, offset_detections, stitch_detections,
                    tile_delta_summary, tile_origins, tile_shape)
