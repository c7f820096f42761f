"""int8 inference convolutions and the activation quantizer.

The int8 path of the quantized model twin (ref
real_time_helmet_detection_tpu/models/hourglass.py:228-298 `QuantConv`,
ops/quant.py:167 `quantize_activations`). The JAX package leaves both to
XLA (`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`
then `acc.astype(dt) * (s_a * s_w).astype(dt) + bias`); the port runs
them as three hand-written CUDA kernels (`csrc/qconv.cu`):

* `quantize_act(x, step)`: `int8(clip(rint(f32(x) / step), -127, 127))`
  of a channels-last f32/bf16 activation, NaN -> 0 (what XLA's float ->
  int8 conversion gives), `step` a 0-d float32 device tensor (the
  calibrated clip range / 127);
* `conv_dense(q, w, mult, bias, dtype, activation)`: a dense k x k conv,
  k = 1 or 3, stride 1, zero padding k // 2, of an int8 channels-last
  input with int8 weights (Cout, k, k, Cin) (each output channel's K
  contiguous), int32 sums, then the rescale
  `dtype(dtype(f32(acc)) * dtype(mult[c])) + dtype(bias[c])`, each
  operation rounded to `dtype` (float32 or bfloat16), and ReLU or Linear;
  `dtype=torch.int32` returns the raw sums;
* `conv_dw(q, w, mult, bias, dtype, activation)`: the same for a 3 x 3
  depthwise conv (groups = C), weights (9, C) (a tap's channels
  contiguous).

Every wrapper launches its kernel for CUDA tensors or raises, and runs
its plain version (`*_reference`) for CPU tensors; there is no fallback
between them. The plain convs take `F.conv2d` in float64 of the int8
values, exact for any K here (|sum| < 2^53), then int32. On CUDA the
wrappers also raise where the kernel does not go: a dense Cin that is no
multiple of 16, a Cout or depthwise C that is no multiple of 8, or an
input or weight pointer that is not 16-byte aligned. `quant_launches`,
`dense_launches` and `dw_launches` count launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .epilogue import _DTYPE_CODE, _channels_last, activate, check_cuda

ACTIVATIONS = ("ReLU", "Linear")  # what the conv epilogue fuses
_ACT_CODE = {"ReLU": 0, "Linear": 2}  # common.cuh Act
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

quant_launches = 0
dense_launches = 0
dw_launches = 0


def _check_act_input(name: str, x: torch.Tensor, dtypes) -> None:
    if x.dim() != 4:
        raise ValueError("%s must be 4-D NCHW, got shape %s"
                         % (name, tuple(x.shape)))
    if x.dtype not in dtypes:
        raise TypeError("%s must be one of %s, got %s"
                        % (name, sorted(map(str, dtypes)), x.dtype))
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("%s must be channels_last contiguous (strides %s)"
                         % (name, x.stride()))


def _check_aligned(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError("%s: %s is not 16-byte aligned (data_ptr %% 16 "
                             "= %d)" % (what, name, t.data_ptr() % 16))


# ---------------------------------------------------------------- quantizer


def quantize_act_reference(x: torch.Tensor, step: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version: JAX's order (ref ops/quant.py:167), round
    half to even, clip, NaN -> 0, int8 in x's layout."""
    q = torch.clamp(torch.round(x.float() / step), -127.0, 127.0)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return _channels_last(q.to(torch.int8))


def quantize_act(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) channels-last float32/bfloat16, step a 0-d float32
    tensor on x's device -> int8 (N, C, H, W) channels-last."""
    global quant_launches
    _check_act_input("x", x, (torch.float32, torch.bfloat16))
    if step.dim() != 0 or step.dtype != torch.float32 \
            or step.device != x.device:
        raise ValueError("step must be a 0-d float32 tensor on %s, got %s "
                         "%s on %s" % (x.device, tuple(step.shape),
                                       step.dtype, step.device))
    if x.device.type == "cpu":
        return quantize_act_reference(x, step)
    check_cuda("quantize_act", x)
    _check_aligned("quantize_act", x=x)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                      memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    err = _build.load("qconv").helmet_quantize(
        x.data_ptr(), step.data_ptr(), out.data_ptr(), x.numel(),
        _DTYPE_CODE[x.dtype], _build.stream_handle(x.device))
    _build.check(err, "quantize_act")
    quant_launches += 1
    return out


# -------------------------------------------------------------------- convs


def rescale_reference(acc: torch.Tensor, mult: torch.Tensor,
                      bias: torch.Tensor, dtype: torch.dtype,
                      activation: str) -> torch.Tensor:
    """The conv epilogue in JAX's order (ref models/hourglass.py:292-298):
    each operation rounded to `dtype`; int32 returns `acc` as it is."""
    if dtype == torch.int32:
        return acc
    c = acc.shape[1]
    y = (acc.to(torch.float32).to(dtype) * mult.to(dtype).view(1, c, 1, 1)
         + bias.to(dtype).view(1, c, 1, 1))
    return _channels_last(activate(y, activation))


def conv_dense_reference(q, w, mult, bias, dtype, activation):
    """Plain PyTorch version of `conv_dense`."""
    k = w.shape[1]
    acc = F.conv2d(q.to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64),
                   padding=(k - 1) // 2).to(torch.int32)
    return rescale_reference(acc, mult, bias, dtype, activation)


def conv_dw_reference(q, w, mult, bias, dtype, activation):
    """Plain PyTorch version of `conv_dw`."""
    c = q.shape[1]
    wd = w.t().reshape(c, 1, 3, 3).to(torch.float64)
    acc = F.conv2d(q.to(torch.float64), wd, padding=1,
                   groups=c).to(torch.int32)
    return rescale_reference(acc, mult, bias, dtype, activation)


def _check_conv(what, q, w, mult, bias, dtype, activation, cout):
    _check_act_input("q", q, (torch.int8,))
    if w.dtype != torch.int8 or not w.is_contiguous():
        raise ValueError("%s: weights must be contiguous int8, got %s"
                         % (what, w.dtype))
    if dtype not in _OUT_CODE:
        raise TypeError("%s: dtype must be float32, bfloat16 or int32, got %s"
                        % (what, dtype))
    if activation not in ACTIVATIONS:
        raise NotImplementedError("%s: activation %r is not fused (have %s)"
                                  % (what, activation, ACTIVATIONS))
    for name, v in (("mult", mult), ("bias", bias)):
        if v.shape != (cout,) or v.dtype != torch.float32 \
                or not v.is_contiguous():
            raise ValueError("%s: %s must be contiguous float32 (%d,), got "
                             "%s %s" % (what, name, cout, v.dtype,
                                        tuple(v.shape)))
    for name, t in (("w", w), ("mult", mult), ("bias", bias)):
        if t.device != q.device:
            raise ValueError("%s: %s on %s, q on %s"
                             % (what, name, t.device, q.device))


def conv_dense(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
               bias: torch.Tensor, dtype: torch.dtype,
               activation: str = "Linear") -> torch.Tensor:
    """q (N, Cin, H, W) int8 channels-last, w (Cout, k, k, Cin) int8 with
    k in (1, 3), mult/bias (Cout,) float32 -> (N, Cout, H, W)
    channels-last `dtype`."""
    global dense_launches
    if w.dim() != 4 or w.shape[1] != w.shape[2] or w.shape[1] not in (1, 3) \
            or w.shape[3] != q.shape[1]:
        raise ValueError("conv_dense: weights must be (Cout, k, k, %d) with "
                         "k 1 or 3, got %s" % (q.shape[1], tuple(w.shape)))
    cout = w.shape[0]
    _check_conv("conv_dense", q, w, mult, bias, dtype, activation, cout)
    if q.device.type == "cpu":
        return conv_dense_reference(q, w, mult, bias, dtype, activation)
    check_cuda("conv_dense", q)
    n, cin, h, wd = q.shape
    if cin % 16 or cout % 8:
        raise ValueError("conv_dense: the kernel takes Cin % 16 == 0 and "
                         "Cout % 8 == 0, got %d -> %d" % (cin, cout))
    _check_aligned("conv_dense", q=q, w=w)
    out = torch.empty((n, cout, h, wd), dtype=dtype, device=q.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    err = _build.load("qconv").helmet_qconv_dense(
        q.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, wd, cin, cout, w.shape[1], _OUT_CODE[dtype],
        _ACT_CODE[activation], _build.stream_handle(q.device))
    _build.check(err, "conv_dense")
    dense_launches += 1
    return out


def conv_dw(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
            bias: torch.Tensor, dtype: torch.dtype,
            activation: str = "Linear") -> torch.Tensor:
    """q (N, C, H, W) int8 channels-last, w (9, C) int8 (3 x 3 taps, row
    major), mult/bias (C,) float32 -> (N, C, H, W) channels-last
    `dtype`."""
    global dw_launches
    c = q.shape[1] if q.dim() == 4 else -1
    if w.shape != (9, c):
        raise ValueError("conv_dw: weights must be (9, %d) (3 x 3 taps), "
                         "got %s" % (c, tuple(w.shape)))
    _check_conv("conv_dw", q, w, mult, bias, dtype, activation, c)
    if q.device.type == "cpu":
        return conv_dw_reference(q, w, mult, bias, dtype, activation)
    check_cuda("conv_dw", q)
    n, _, h, wd = q.shape
    if c % 8 or n * h * wd * (c // 8) >= 2 ** 31:
        raise ValueError("conv_dw: the kernel takes C % 8 == 0 and fewer "
                         "than 2^31 8-channel groups, got %s"
                         % (tuple(q.shape),))
    _check_aligned("conv_dw", q=q, w=w)
    out = torch.empty(q.shape, dtype=dtype, device=q.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    err = _build.load("qconv").helmet_qconv_dw(
        q.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, wd, c, _OUT_CODE[dtype], _ACT_CODE[activation],
        _build.stream_handle(q.device))
    _build.check(err, "conv_dw")
    dw_launches += 1
    return out
