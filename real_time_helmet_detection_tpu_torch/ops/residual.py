"""Eval residual-block tail: `act(y * eff_scale + eff_bias + skip)`.

Port of the eval forward of ref ops/pallas/residual.py:420
`fused_bn_add_act` (its Pallas `_fwd_add_kernel`, residual.py:91): the
last conv's BatchNorm (running statistics folded into a per-channel
affine, ref models/hourglass.py:437-440), the skip-add and the block's
closing activation in one pass.

* `bn_add_act` launches `csrc/residual.cu` for CUDA tensors or raises,
  and runs the plain version for CPU tensors — no fallback between them.
* `bn_add_act_reference` is the plain PyTorch version, summed in the TPU
  kernel's order: ((y * a) + b) + skip.
* `launches` counts kernel launches.

Layout is the epilogue's: channels-last NCHW tensors, read by the kernel
as (N*H*W, C) row-major blocks with no copy.
"""

from __future__ import annotations

import torch

from . import _build
from .epilogue import (_ACT_CODE, _DTYPE_CODE, activate, check_activation,
                       check_affine, check_layout)

launches = 0


def bn_add_act_reference(y: torch.Tensor, eff_scale: torch.Tensor,
                         eff_bias: torch.Tensor, skip: torch.Tensor,
                         activation: str) -> torch.Tensor:
    """Plain PyTorch version: f32 math, result in y's dtype and layout."""
    c = y.shape[1]
    z = (y.float() * eff_scale.view(1, c, 1, 1) + eff_bias.view(1, c, 1, 1)
         + skip.float())
    return activate(z, activation).to(y.dtype).contiguous(
        memory_format=torch.channels_last)


def bn_add_act(y: torch.Tensor, eff_scale: torch.Tensor,
               eff_bias: torch.Tensor, skip: torch.Tensor,
               activation: str) -> torch.Tensor:
    """Residual tail, eval forward only.

    y, skip: (N, C, H, W) channels-last, same shape, dtype (float32 or
    bfloat16) and device; eff_scale, eff_bias: (C,) float32."""
    global launches
    check_activation(activation)
    check_layout("y", y)
    check_layout("skip", skip, like=y)
    check_affine(y, eff_scale, eff_bias)
    if y.device.type == "cpu":
        return bn_add_act_reference(y, eff_scale, eff_bias, skip, activation)
    if y.device.type != "cuda":
        raise ValueError("bn_add_act runs on cuda or cpu, got %s" % y.device)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    lib = _build.load("residual")
    err = lib.helmet_bn_add_act(y.data_ptr(), eff_scale.data_ptr(),
                                eff_bias.data_ptr(), skip.data_ptr(),
                                out.data_ptr(), y.numel(), y.shape[1],
                                _DTYPE_CODE[y.dtype], _ACT_CODE[activation],
                                _build.stream_handle(y.device))
    _build.check(err, "bn_add_act")
    launches += 1
    return out
