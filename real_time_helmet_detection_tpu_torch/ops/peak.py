"""Fused sigmoid + peak test on the raw detector output.

Port of ref ops/pallas/peak.py:95 `fused_peak_scores` (its Pallas
`_peak_kernel`, peak.py:68): per class map, s = sigmoid(logit), kept
where s equals the max of its pool_size x pool_size window (ties count,
cells outside the map are -inf, a NaN in the window makes its max NaN),
0 elsewhere. The peak test runs on sigmoid values, not logits, exactly
as the JAX decode path does.

* `peak_scores` checks its arguments and calls `helmet::peak_scores`
  (`ops.library`), which launches `csrc/peak.cu` for CUDA tensors or
  raises, and runs the plain version for CPU tensors. The kernel's
  variant, "vector" (both heat channels of a cell in one 8-byte load,
  16-byte stores) or "scalar", is chosen at launch by the C entry
  `helmet_peak_pick`; `peak_variant` states the same rule for code that
  counts launches without a card.
* `peak_scores_reference` is the plain PyTorch version (sigmoid, then
  `ops.decode.peak_mask`: a stride-1 max pool with implicit -inf
  padding, and equality).
* `launches` counts kernel launches (the op's CUDA implementation adds
  to it); `vector_launches` and `scalar_launches` split it by variant.

Both read the C heat channels straight out of the model's
(B, S, h, w, C+4) float32 output and write class-major (B, S, C, h, w),
the order the top-k flattening needs (ref ops/decode.py:120-123), so the
two transposes around the TPU kernel (peak.py:109-111) do not exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .decode import peak_mask

launches = 0
vector_launches = 0
scalar_launches = 0

# the kernel's spatial tile (csrc/peak.cu kPeakTileH x kPeakTileW)
TILE_H, TILE_W = 16, 32
# Shared memory of one block: per class plane (16 + 2p) rows of the
# staged sigmoids, (16 + 2p) x 32 of the horizontal max; two planes in
# the vector variant. `smem_bytes` mirrors csrc/peak.cu; pool size 81
# (p = 40) takes 110.6 KB, inside the 227 KB a block may opt into.
MAX_POOL_SIZE = 2 * 40 + 1


def check_pool_size(pool_size: int) -> None:
    if pool_size % 2 != 1 or pool_size < 1 or pool_size > MAX_POOL_SIZE:
        raise ValueError("pool_size must be odd, >= 1 and <= %d, got %d"
                         % (MAX_POOL_SIZE, pool_size))


def smem_bytes(pool_size: int, variant: str) -> int:
    """Dynamic shared memory of one block of the kernel (csrc/peak.cu
    `peak_plane_floats` x planes x 4 bytes)."""
    p = (pool_size - 1) // 2
    lead = -(-p // 4) * 4
    stride = -(-(lead + TILE_W + p) // 4) * 4
    planes = 2 if variant == "vector" else 1
    return planes * (TILE_H + 2 * p) * (stride + TILE_W) * 4


def tiles(h: int, w: int) -> Tuple[int, int]:
    """(rows, columns) of TILE_H x TILE_W tiles that cover one h x w map;
    tile (i, j) holds rows [i * TILE_H, (i + 1) * TILE_H) and columns
    [j * TILE_W, (j + 1) * TILE_W), cut at the map's edge."""
    return -(-h // TILE_H), -(-w // TILE_W)


def peak_variant(num_cls: int, k: int, w: int, logits_ptr: int,
                 out_ptr: int) -> str:
    """The variant `helmet_peak_pick` (csrc/peak.cu) launches: "vector"
    when there are two classes, the channel count K is even and the
    logits 8-byte aligned (each cell's heat pair is one 8-byte load), and
    w is a multiple of 4 with the output 16-byte aligned (four outputs in
    one 16-byte store); else "scalar". A choice by shape, not a fallback
    on failure."""
    if num_cls == 2 and k % 2 == 0 and logits_ptr % 8 == 0 \
            and w % 4 == 0 and out_ptr % 16 == 0:
        return "vector"
    return "scalar"


def _check(logits: torch.Tensor, num_cls: int) -> None:
    if logits.dim() != 5 or not 0 < num_cls <= logits.shape[-1]:
        raise ValueError("logits must be (B, S, h, w, K) with K >= num_cls "
                         "= %d, got %s" % (num_cls, tuple(logits.shape)))
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("logits must be contiguous float32, got %s "
                         "(contiguous=%s)" % (logits.dtype,
                                              logits.is_contiguous()))


def peak_scores_reference(logits: torch.Tensor, num_cls: int,
                          pool_size: int = 3) -> torch.Tensor:
    """Plain PyTorch version: (B, S, h, w, K) -> (B, S, C, h, w)."""
    heat = torch.sigmoid(logits[..., :num_cls]).permute(0, 1, 4, 2, 3)
    return torch.where(peak_mask(heat, pool_size), heat,
                       torch.zeros_like(heat)).contiguous()


def peak_scores(logits: torch.Tensor, num_cls: int, pool_size: int = 3,
                variant: Optional[str] = None) -> torch.Tensor:
    """Masked sigmoid peak scores, (B, S, h, w, K) f32 -> (B, S, C, h, w),
    through the `helmet::peak_scores` op (`ops.library`): the kernel on a
    CUDA tensor, the plain version on a CPU one. `variant` ("vector" or
    "scalar") forces a kernel variant on a CUDA tensor; None leaves the
    choice to the kernel library at launch (`helmet_peak_pick`, the rule
    `peak_variant` states). The vector variant refuses, and this raises
    on, a shape it cannot take."""
    check_pool_size(pool_size)
    _check(logits, num_cls)
    if logits.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError("peak_scores runs on cuda or cpu, got %s"
                         % logits.device)
    if variant not in (None, "vector", "scalar"):
        raise ValueError("variant must be 'vector' or 'scalar', got %r"
                         % (variant,))
    b, s, h, w, _ = logits.shape
    rows, cols = tiles(h, w)
    return torch.ops.helmet.peak_scores.default(
        logits, num_cls, pool_size, b * s * rows * cols, variant or "auto")
