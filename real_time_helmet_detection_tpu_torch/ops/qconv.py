"""int8 inference convolutions and the activation quantizer.

The int8 path of the quantized model twin (ref
real_time_helmet_detection_tpu/models/hourglass.py:228-298 `QuantConv`,
ops/quant.py:167 `quantize_activations`). The JAX package leaves both to
XLA (`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`
then `acc.astype(dt) * (s_a * s_w).astype(dt) + bias`); the port runs
them as hand-written CUDA kernels (`csrc/qconv.cu`):

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

Each conv has two kernels, picked by shape:

* dense: "wgmma" (`qconv_wgmma_kernel`), an implicit GEMM on Hopper's
  `wgmma` fed by TMA, whose tile is a spatial box of WG_ROWS output
  pixels x all of Cout, the input box loaded once with its halo for all
  k * k taps, the weights resident in shared memory; `dense_plan` gives
  its box, wgmma width, stage count and shared memory, and takes it for
  every shape whose weights fit; "mma" (`qconv_dense_kernel`, the first
  design on `mma.sync`) for the rest and when asked
  (`conv_dense_variant`), for timing it;
* depthwise: "tiled" (`qconv_dw_tile_kernel`), a tile and its halo
  staged once by TMA, for C % 16 == 0 (TMA's 16-byte strides);
  "gather" (`qconv_dw_kernel`, nine loads a pixel) for the rest;
  `dw_plan` picks and sizes the tile.

Every wrapper checks its arguments, computes its plan, and calls its
`helmet` op (`ops.library`: `helmet::quantize_act`, `qconv_dense`,
`qconv_dw`), which launches the kernel for CUDA tensors or raises, and
runs the plain version (`*_reference`) for CPU tensors; there is no
fallback between them. The plain convs take `F.conv2d` in float64 of the
int8 values, exact for any K here (|sum| < 2^53), then int32. On CUDA
they also raise where the kernels do not go: a dense Cin that is no
multiple of 16, a Cout or depthwise C that is no multiple of 8 (the
wrappers), or an input or weight pointer that is not 16-byte aligned
(the C entries' check, a ValueError here). `quant_launches`,
`dense_launches` and `dw_launches` count launches; `dense_wgmma_launches`
+ `dense_mma_launches` and `dw_tiled_launches` + `dw_gather_launches`
split the last two by kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .epilogue import _channels_last, activate, check_cuda, plain_device

ACTIVATIONS = ("ReLU", "Linear")  # what the conv epilogue fuses
_ACT_CODE = {"ReLU": 0, "Linear": 2}  # common.cuh Act
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OUT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4}

quant_launches = 0
dense_launches = 0
dense_wgmma_launches = 0
dense_mma_launches = 0
dw_launches = 0
dw_tiled_launches = 0
dw_gather_launches = 0

# csrc/qconv.cu's wgmma geometry (kWgRows, kWgBoxW, kWgConsumers,
# kWgMaxStages, kWgAlign; `wg_planes`, `wg_plane_bytes`, `wg_b_bytes`,
# `wg_row_bytes`, `wg_smem`)
WG_ROWS = 128          # output pixels a tile: a box of 8 x bh x bn
WG_BOX_W = 8           # box width: one 8-row core matrix of wgmma
WG_CONSUMER_WARPS = 8  # two consumer warpgroups (+ one producer warp)
WG_MAX_STAGES = 6
WG_ALIGN = 128         # a TMA destination's alignment
# the wgmma widths the kernel is built for: legal widths of
# wgmma.m64nNk32.s32.s8.s8 (8, 16, 24, 32, then multiples of 16 to 256)
WGMMA_N = (32, 48, 64, 96, 128, 256)
# shared memory of one H100 SM, and what each resident block reserves
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
# csrc/qconv.cu's tiled depthwise geometry (kDwStrip, kDwAlign)
DW_STRIP = 8
DW_ALIGN = 128
DW_TILE_W, DW_TILE_H, DW_MAX_CT = 32, 16, 64


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
    tensor on x's device -> int8 (N, C, H, W) channels-last, through the
    `helmet::quantize_act` op (`ops.library`)."""
    _check_act_input("x", x, (torch.float32, torch.bfloat16))
    if step.dim() != 0 or step.dtype != torch.float32 \
            or step.device != x.device:
        raise ValueError("step must be a 0-d float32 tensor on %s, got %s "
                         "%s on %s" % (x.device, tuple(step.shape),
                                       step.dtype, step.device))
    if not plain_device(x):
        check_cuda("quantize_act", x)
    return torch.ops.helmet.quantize_act.default(x, step)


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """One dense int8 conv launch: variant "wgmma" (`qconv_wgmma_kernel`)
    or "mma" (`qconv_dense_kernel`; the other fields describe the wgmma
    kernel's geometry all the same)."""
    variant: str
    box: Tuple[int, int, int]   # (8, bh, bn) output pixels, x fastest
    planes: int                 # the K chunk: 16-channel planes a tap,
    #                             Cin rounded up to 32 bytes (no swizzle)
    n: int                      # wgmma width: output channels a tile
    stages: int                 # input boxes in the ring
    smem: int                   # dynamic shared memory, bytes


def wg_planes(cin: int) -> int:
    """csrc/qconv.cu `wg_planes`: 16-channel planes a tap, Cin rounded up
    to wgmma's 32-byte K step."""
    return _cdiv(cin, 32) * 2


def wg_plane_bytes(bh: int, bn: int, k: int) -> int:
    """csrc/qconv.cu `wg_plane_bytes`: one plane of the input box with its
    halo, 16 bytes a pixel, padded to WG_ALIGN."""
    return _cdiv(bn * (bh + k - 1) * (WG_BOX_W + k - 1) * 16,
                 WG_ALIGN) * WG_ALIGN


def wg_b_bytes(cin: int, k: int, n: int) -> int:
    """csrc/qconv.cu `wg_b_bytes`: the resident weights, k * k taps x
    planes x n rows of 16 bytes."""
    return k * k * wg_planes(cin) * n * 16


def wg_row_bytes(out_bytes: int) -> int:
    """csrc/qconv.cu `wg_row_bytes`: a staging row of 128 bytes of output,
    padded off the bank period."""
    return 128 + (16 if out_bytes == 2 else 32)


def wg_smem(cin: int, k: int, bh: int, bn: int, n: int, stages: int,
            out_bytes: int) -> int:
    """csrc/qconv.cu `wg_smem`: alignment slack, the weights, the ring of
    input boxes, the consumer warps' 16 staging rows each, the rounded
    mult and bias (16 bytes a column pair), two mbarriers a stage and two
    for the weights."""
    return (WG_ALIGN + wg_b_bytes(cin, k, n)
            + stages * wg_planes(cin) * wg_plane_bytes(bh, bn, k)
            + WG_CONSUMER_WARPS * 16 * wg_row_bytes(out_bytes) + n * 8
            + 16 * stages + 16)


@functools.lru_cache(maxsize=1024)
def dense_plan(n: int, h: int, w: int, cin: int, cout: int, k: int,
               out_bytes: int = 2, variant: Optional[str] = None
               ) -> DensePlan:
    """The launch of a dense k x k int8 conv of an (n, cin, h, w) input to
    cout channels with `out_bytes` output elements (2: bf16, 4: f32 or
    int32):

    * the box: 8 x bh x bn output pixels, bh = 16 (8 where H <= 8), bn =
      128 / (8 * bh) images; its input with a halo of k // 2 is one TMA
      load a 16-channel plane, read by all k * k taps at shifted offsets;
      TMA zero-fills what lies past the image (and channels past Cin);
    * n: the narrowest WGMMA_N >= Cout (or 256, in ceil(Cout / 256)
      channel blocks); the block's weights stay in shared memory;
    * stages: as many input boxes (<= WG_MAX_STAGES) as fit two blocks an
      SM at n <= 96 (the kernel's launch bounds), else one.

    Every shape whose weights and one input box fit a block's shared
    memory takes "wgmma"; the others, or `variant` "mma", the mma.sync
    kernel. Cached by shape: an eager launch rebuilds no plan."""
    if variant not in (None, "wgmma", "mma"):
        raise ValueError("dense_plan: variant must be None, 'wgmma' or "
                         "'mma', got %r" % (variant,))
    bh = 16 if h > 8 else 8
    bn = WG_ROWS // (WG_BOX_W * bh)
    planes = wg_planes(cin)
    wn = next(x for x in WGMMA_N if x >= min(cout, WGMMA_N[-1]))
    stage = planes * wg_plane_bytes(bh, bn, k)
    fixed = wg_smem(cin, k, bh, bn, wn, 0, out_bytes)

    def fit(per_sm):
        budget = min(_build.MAX_DYNAMIC_SMEM,
                     SMEM_PER_SM // per_sm - SMEM_RESERVED)
        return min(WG_MAX_STAGES, (budget - fixed) // (stage + 16))

    per_sm = 2 if wn <= 96 and fit(2) >= 2 else 1
    stages = fit(per_sm)
    if variant is None:
        variant = "wgmma" if stages >= 1 else "mma"
    if variant == "wgmma" and stages < 1:
        raise ValueError("dense_plan: the weights (%d bytes) and one input "
                         "box do not fit shared memory"
                         % wg_b_bytes(cin, k, wn))
    stages = max(stages, 1)
    return DensePlan(variant, (WG_BOX_W, bh, bn), planes, wn, stages,
                     wg_smem(cin, k, bh, bn, wn, stages, out_bytes))


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One depthwise int8 conv launch: variant "tiled"
    (`qconv_dw_tile_kernel`, with its tile) or "gather"
    (`qconv_dw_kernel`; tile, ct and smem None)."""
    variant: str
    tile: Optional[Tuple[int, int]]  # (tw, th) output pixels a block
    ct: Optional[int]                # channels a block (the box's inner)
    smem: Optional[int]


def dw_box_bytes(tw: int, th: int, ct: int) -> int:
    """csrc/qconv.cu `dw_box_bytes`: one input box with its halo, padded
    to DW_ALIGN."""
    return _cdiv(ct * (tw + 2) * (th + 2), DW_ALIGN) * DW_ALIGN


def dw_tile_smem(tw: int, th: int, ct: int) -> int:
    """csrc/qconv.cu `dw_tile_smem`: alignment slack, two input boxes (the
    one read, the next one loading), their mbarriers."""
    return DW_ALIGN + 2 * dw_box_bytes(tw, th, ct) + 16


@functools.lru_cache(maxsize=1024)
def dw_plan(n: int, h: int, w: int, c: int,
            variant: Optional[str] = None) -> DwPlan:
    """The launch of a 3 x 3 depthwise int8 conv of an (n, c, h, w)
    input: "tiled" for C % 16 == 0 (tw = min(32, W), th = 8 for H <= 8
    else 16, up to DW_MAX_CT channels a block, one block a tile), else
    "gather"; `variant` forces one (the tiled kernel refuses C % 16).
    A persistent block walks several tiles. Cached by shape."""
    if variant not in (None, "tiled", "gather"):
        raise ValueError("dw_plan: variant must be None, 'tiled' or "
                         "'gather', got %r" % (variant,))
    if variant is None:
        variant = "tiled" if c % 16 == 0 else "gather"
    if variant == "gather":
        return DwPlan("gather", None, None, None)
    if c % 16:
        raise ValueError("dw_plan: the tiled kernel takes C % 16 == 0, got "
                         "%d" % c)
    tw = min(DW_TILE_W, w)
    th = DW_STRIP if h <= DW_STRIP else DW_TILE_H
    ct = min(c, DW_MAX_CT)
    return DwPlan("tiled", (tw, th), ct, dw_tile_smem(tw, th, ct))


def conv_dense(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
               bias: torch.Tensor, dtype: torch.dtype,
               activation: str = "Linear") -> torch.Tensor:
    """q (N, Cin, H, W) int8 channels-last, w (Cout, k, k, Cin) int8 with
    k in (1, 3), mult/bias (Cout,) float32 -> (N, Cout, H, W)
    channels-last `dtype`."""
    return conv_dense_variant(q, w, mult, bias, dtype, activation, None)


def conv_dense_variant(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                       bias: torch.Tensor, dtype: torch.dtype,
                       activation: str, variant: Optional[str]
                       ) -> torch.Tensor:
    """`conv_dense` on the kernel `variant` names ("wgmma", "mma"; None:
    `dense_plan`'s choice)."""
    if w.dim() != 4 or w.shape[1] != w.shape[2] or w.shape[1] not in (1, 3) \
            or w.shape[3] != q.shape[1]:
        raise ValueError("conv_dense: weights must be (Cout, k, k, %d) with "
                         "k 1 or 3, got %s" % (q.shape[1], tuple(w.shape)))
    cout = w.shape[0]
    _check_conv("conv_dense", q, w, mult, bias, dtype, activation, cout)
    n, cin, h, wd = q.shape
    if not plain_device(q):
        check_cuda("conv_dense", q)
        if cin % 16 or cout % 8:
            raise ValueError("conv_dense: the kernel takes Cin % 16 == 0 and "
                             "Cout % 8 == 0, got %d -> %d" % (cin, cout))
    plan = dense_plan(n, h, wd, cin, cout, w.shape[1], _OUT_BYTES[dtype],
                      variant)
    return torch.ops.helmet.qconv_dense.default(
        q, w, mult, bias, _OUT_CODE[dtype], activation, plan.variant,
        plan.box[1], plan.box[2], plan.n, plan.stages)


def conv_dw(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
            bias: torch.Tensor, dtype: torch.dtype,
            activation: str = "Linear") -> torch.Tensor:
    """q (N, C, H, W) int8 channels-last, w (9, C) int8 (3 x 3 taps, row
    major), mult/bias (C,) float32 -> (N, C, H, W) channels-last
    `dtype`."""
    return conv_dw_variant(q, w, mult, bias, dtype, activation, None)


def conv_dw_variant(q: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                    bias: torch.Tensor, dtype: torch.dtype, activation: str,
                    variant: Optional[str]) -> torch.Tensor:
    """`conv_dw` on the kernel `variant` names ("tiled", "gather"; None:
    `dw_plan`'s choice)."""
    c = q.shape[1] if q.dim() == 4 else -1
    if w.shape != (9, c):
        raise ValueError("conv_dw: weights must be (9, %d) (3 x 3 taps), "
                         "got %s" % (c, tuple(w.shape)))
    _check_conv("conv_dw", q, w, mult, bias, dtype, activation, c)
    n, _, h, wd = q.shape
    if not plain_device(q):
        check_cuda("conv_dw", q)
        if c % 8 or n * h * wd * (c // 8) >= 2 ** 31:
            raise ValueError("conv_dw: the kernel takes C % 8 == 0 and fewer "
                             "than 2^31 8-channel groups, got %s"
                             % (tuple(q.shape),))
    plan = dw_plan(n, h, wd, c, variant)
    tw, th = plan.tile or (0, 0)
    return torch.ops.helmet.qconv_dw.default(
        q, w, mult, bias, _OUT_CODE[dtype], activation, plan.variant, tw, th,
        plan.ct or 0)
