"""Fused sigmoid + peak test on the raw detector output.

Port of ref ops/pallas/peak.py:95 `fused_peak_scores` (its Pallas
`_peak_kernel`, peak.py:68): per class map, s = sigmoid(logit), kept
where s equals the max of its pool_size x pool_size window (ties count,
cells outside the map are -inf), 0 elsewhere. The peak test runs on
sigmoid values, not logits, exactly as the JAX decode path does.

* `peak_scores` launches `csrc/peak.cu` for CUDA tensors or raises, and
  runs the plain version for CPU tensors.
* `peak_scores_reference` is the plain PyTorch version (sigmoid, then
  `ops.decode.peak_mask`: a stride-1 max pool with implicit -inf
  padding, and equality).
* `launches` counts kernel launches.

Both read the C heat channels straight out of the model's
(B, S, h, w, C+4) float32 output and write class-major (B, S, C, h, w),
the order the top-k flattening needs (ref ops/decode.py:120-123), so the
two transposes around the TPU kernel (peak.py:109-111) do not exist.
"""

from __future__ import annotations

import torch

from . import _build
from .decode import peak_mask

launches = 0

# shared-memory tile of the kernel: (8 + 2p) x (32 + 2p) floats <= 48 KB
MAX_POOL_SIZE = 2 * 40 + 1


def check_pool_size(pool_size: int) -> None:
    if pool_size % 2 != 1 or pool_size < 1 or pool_size > MAX_POOL_SIZE:
        raise ValueError("pool_size must be odd, >= 1 and <= %d, got %d"
                         % (MAX_POOL_SIZE, pool_size))


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


def peak_scores(logits: torch.Tensor, num_cls: int,
                pool_size: int = 3) -> torch.Tensor:
    """Masked sigmoid peak scores, (B, S, h, w, K) f32 -> (B, S, C, h, w)."""
    global launches
    check_pool_size(pool_size)
    _check(logits, num_cls)
    if logits.device.type == "cpu":
        return peak_scores_reference(logits, num_cls, pool_size)
    if logits.device.type != "cuda":
        raise ValueError("peak_scores runs on cuda or cpu, got %s"
                         % logits.device)
    b, s, h, w, k = logits.shape
    maps = b * s * num_cls
    if maps > 65535:
        raise ValueError("peak_scores: %d maps exceed the kernel's grid "
                         "(65535); split the batch" % maps)
    out = torch.empty((b, s, num_cls, h, w), dtype=torch.float32,
                      device=logits.device)
    if out.numel() == 0:
        return out
    lib = _build.load("peak")
    err = lib.helmet_peak_scores(logits.data_ptr(), out.data_ptr(), maps,
                                 num_cls, h, w, k, (pool_size - 1) // 2,
                                 _build.stream_handle(logits.device))
    _build.check(err, "peak_scores")
    launches += 1
    return out
