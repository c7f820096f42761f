"""Eval BatchNorm + activation epilogue: `act(x * eff_scale + eff_bias)`.

Port of the eval forward of ref ops/pallas/epilogue.py:481
`fused_bn_act` (its Pallas `_fwd_kernel`, epilogue.py:138). Every BN'd
conv of the detector ends here with the running statistics folded into
a per-channel affine (`eff_scale = gamma * rsqrt(var + eps)`,
`eff_bias = beta - mean * eff_scale`, ref models/hourglass.py:387-390).

* `bn_act` is the wrapper: for a CUDA tensor it launches the hand-written
  kernel `csrc/epilogue.cu` or raises; for a CPU tensor it runs the plain
  version. There is no fallback from one to the other.
* `bn_act_reference` is the plain PyTorch version: the same f32
  arithmetic as the kernel, one eager op per step.
* `launches` counts kernel launches (never plain-version calls).

Layout: x is an NCHW tensor in `torch.channels_last` memory format, whose
storage is the (N*H*W, C) row-major block the TPU kernel tiled
(ref ops/pallas/epilogue.py:506-510) — the kernel reads it as is, with
no copy. Anything else raises.
"""

from __future__ import annotations

import torch

from . import _build

ACTIVATIONS = ("ReLU", "Mish", "Linear")
_ACT_CODE = {"ReLU": 0, "Mish": 1, "Linear": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    """act(z) for the supported activations (ref hourglass.py:98-129)."""
    if activation == "ReLU":
        return torch.clamp_min(z, 0.0)
    if activation == "Mish":
        return z * torch.tanh(torch.log1p(torch.exp(z)))
    if activation == "Linear":
        return z
    raise NotImplementedError("activation %r is not ported (have %s)"
                              % (activation, ACTIVATIONS))


def check_layout(name: str, x: torch.Tensor, like: torch.Tensor = None) -> None:
    """Raise unless x is a 4-D channels-last f32/bf16 tensor (matching
    `like` in shape, dtype and device when given)."""
    if x.dim() != 4:
        raise ValueError("%s must be 4-D NCHW, got shape %s"
                         % (name, tuple(x.shape)))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("%s must be float32 or bfloat16, got %s"
                        % (name, x.dtype))
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("%s must be channels_last contiguous (strides %s)"
                         % (name, x.stride()))
    if like is not None and (x.shape != like.shape or x.dtype != like.dtype
                             or x.device != like.device):
        raise ValueError("%s must match %s/%s/%s, got %s/%s/%s"
                         % (name, tuple(like.shape), like.dtype, like.device,
                            tuple(x.shape), x.dtype, x.device))


def check_affine(x: torch.Tensor, eff_scale: torch.Tensor,
                 eff_bias: torch.Tensor) -> None:
    c = x.shape[1]
    for name, v in (("eff_scale", eff_scale), ("eff_bias", eff_bias)):
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError("%s must be a contiguous (%d,) float32 tensor "
                             "on %s, got %s %s on %s"
                             % (name, c, x.device, tuple(v.shape), v.dtype,
                                v.device))


def check_activation(activation: str) -> None:
    if activation not in _ACT_CODE:
        raise NotImplementedError("activation %r is not ported (have %s)"
                                  % (activation, ACTIVATIONS))


def bn_act_reference(x: torch.Tensor, eff_scale: torch.Tensor,
                     eff_bias: torch.Tensor, activation: str) -> torch.Tensor:
    """Plain PyTorch version: f32 math, result in x's dtype and layout."""
    c = x.shape[1]
    z = x.float() * eff_scale.view(1, c, 1, 1) + eff_bias.view(1, c, 1, 1)
    return activate(z, activation).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def bn_act(x: torch.Tensor, eff_scale: torch.Tensor, eff_bias: torch.Tensor,
           activation: str) -> torch.Tensor:
    """`act(x * eff_scale + eff_bias)` per channel, eval forward only.

    x: (N, C, H, W) channels-last, float32 or bfloat16; eff_scale and
    eff_bias: (C,) float32. Returns a new tensor like x."""
    global launches
    check_activation(activation)
    check_layout("x", x)
    check_affine(x, eff_scale, eff_bias)
    if x.device.type == "cpu":
        return bn_act_reference(x, eff_scale, eff_bias, activation)
    if x.device.type != "cuda":
        raise ValueError("bn_act runs on cuda or cpu, got %s" % x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load("epilogue")
    err = lib.helmet_bn_act(x.data_ptr(), eff_scale.data_ptr(),
                            eff_bias.data_ptr(), out.data_ptr(), x.numel(),
                            x.shape[1], _DTYPE_CODE[x.dtype],
                            _ACT_CODE[activation],
                            _build.stream_handle(x.device))
    _build.check(err, "bn_act")
    launches += 1
    return out
