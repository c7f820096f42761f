"""Stacked-hourglass CenterNet detector in PyTorch, train and eval.

Port of ref models/hourglass.py:877 `StackedHourglass` (reference
hourglass.py:198-237) and its blocks: `Convolution` (hourglass.py:443),
`Residual` (:603, the flagship "residual" variant), `Pool` (:155),
`Hourglass` (:740), `PreLayer` (:793), `Neck` (:836), `Head` (:866).

* Submodules carry the flax auto-names (`PreLayer_0`, `Convolution_1`,
  `Conv_0`, `BatchNorm_0`, ...), so a state dict's keys mirror the flax
  module paths and `convert.py` fills every leaf under
  `load_state_dict(strict=True)`.
* Every BatchNorm runs through the hand-written BN kernels — the TPU
  program's `--epilogue fused --block-fuse fused`; the port has no other
  BN path. In eval (`model.eval()`) the running statistics fold into a
  per-channel f32 affine (`eff_scale = gamma * rsqrt(var + eps)`,
  `eff_bias = beta - mean * eff_scale`, hourglass.py:387-390) feeding
  the epilogue (`ops.epilogue.bn_act_eval`) after every BN'd conv and
  the residual tail (`ops.residual.bn_add_act_eval`) at the end of every
  Residual block; both are differentiable through their eval backward
  kernels, so a gradient of an eval-mode model reaches every parameter,
  gamma and beta through the fold. In train (`model.train()`) the same sites run
  `bn_act_train`/`bn_add_act_train` with batch moments and update the
  running buffers as flax does (hourglass.py:367-384, :426-436): momentum
  0.9, the biased variance, no gradient.
* Activations are NCHW tensors in `torch.channels_last` memory format
  (physically NHWC, what the kernels read and cuDNN prefers). The public
  contract is the JAX one: images (B, H, W, 3) in, logits
  (B, S, H/4, W/4, C+4) float32 out.
* Precision follows the JAX fp32 param policy: parameters stay float32
  and every conv casts its weight and bias to its input's dtype at each
  call (bf16 under --amp), so gradients and optimizer state stay
  float32. Eval may cast the conv weights once (`cast_convs`); the
  per-call cast is then a no-op.
* Padding is the reference's symmetric (k-1)//2; the 2x upsample is
  exact nearest.
* Quirks kept from the JAX model: the PreLayer and Neck Residual blocks
  always use ReLU (their `Residual` is built without the activation
  argument, hourglass.py:829-832, :861), and the Neck conv has a bias
  before its BN (hourglass.py:859).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import epilogue, residual
from ..ops.epilogue import ACTIVATIONS

POOLS = ("Max", "None")
VARIANTS = ("residual",)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` state in torch
    names: weight (scale), bias, running_mean, running_var (the biased
    variance flax keeps, used as is), fused with the activation that
    follows it and, given a skip, the residual add before it."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def folded(self):
        """(eff_scale, eff_bias), both (C,) float32."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, y: torch.Tensor, activation: str,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """act(BN(y) (+ skip)): batch moments in train mode (the running
        buffers take flax's momentum update), running statistics in eval
        (ref hourglass.py:367-390, :426-440)."""
        if not self.training:
            a, b = self.folded()
            if skip is None:
                return epilogue.bn_act_eval(y, a, b, activation)
            return residual.bn_add_act_eval(y, a, b, skip, activation)
        if skip is None:
            out, mean, var = epilogue.bn_act_train(
                y, self.weight, self.bias, activation, self.eps)
        else:
            out, mean, var = residual.bn_add_act_train(
                y, self.weight, self.bias, skip, activation, self.eps)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return out


class Convolution(nn.Module):
    """Conv -> optional BN + activation (ref hourglass.py:443-561). With
    `skip`, the BN feeds the residual tail: act(BN(conv(x)) + skip). The
    conv's weight and bias are cast to the input's dtype at each call."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True, bn: bool = False,
                 activation: str = "ReLU"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise NotImplementedError("activation %r is not ported (have %s)"
                                      % (activation, ACTIVATIONS))
        if not bn and activation != "Linear":
            raise NotImplementedError("a conv without BN is Linear in this "
                                      "model, got %r" % activation)
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                                padding=(kernel_size - 1) // 2,
                                bias=use_bias)
        self.bn = bn
        if bn:
            self.BatchNorm_0 = BatchNorm(out_ch)
        self.activation = activation

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = self.Conv_0
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        y = F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                     conv.padding)
        if not self.bn:
            return y
        return self.BatchNorm_0(y, self.activation, skip)


class Residual(nn.Module):
    """Residual block, "residual" variant (ref hourglass.py:603-733): two
    3x3 BN convs, a 1x1 BN projection on the skip when the width
    changes, and the post-add activation carried by the tail conv."""

    def __init__(self, in_ch: int, out_ch: int, activation: str = "ReLU",
                 variant: str = "residual"):
        super().__init__()
        if variant not in VARIANTS:
            raise NotImplementedError("variant %r is not ported (have %s)"
                                      % (variant, VARIANTS))
        self.Convolution_0 = Convolution(in_ch, out_ch, 3, 1, use_bias=False,
                                         bn=True, activation=activation)
        self.Convolution_1 = Convolution(out_ch, out_ch, 3, 1,
                                         use_bias=False, bn=True,
                                         activation=activation)
        self.project = in_ch != out_ch
        if self.project:
            self.Convolution_2 = Convolution(in_ch, out_ch, 1, 1,
                                             use_bias=False, bn=True,
                                             activation="Linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Convolution_0(x)
        skip = self.Convolution_2(x) if self.project else x
        return self.Convolution_1(y, skip=skip)


def pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Downsample (ref hourglass.py:155-177): Max 2x2/2 or None."""
    if kind == "Max":
        return F.max_pool2d(x, 2, 2)
    if kind == "None":
        return x
    raise NotImplementedError("pool %r is not ported (have %s)"
                              % (kind, POOLS))


class Hourglass(nn.Module):
    """Recursive U-module (ref hourglass.py:740-790): skip branch +
    [pool -> residual -> recurse/bottom -> residual -> nearest 2x up]."""

    def __init__(self, num_layer: int, in_ch: int, increase_ch: int = 0,
                 activation: str = "ReLU", pool: str = "Max",
                 variant: str = "residual"):
        super().__init__()
        mid = in_ch + increase_ch
        self.num_layer = num_layer
        self.pool = pool
        self.Residual_0 = Residual(in_ch, in_ch, activation, variant)
        self.Residual_1 = Residual(in_ch, mid, activation, variant)
        if num_layer > 1:
            self.Hourglass_0 = Hourglass(num_layer - 1, mid, increase_ch,
                                         activation, pool, variant)
            self.Residual_2 = Residual(mid, in_ch, activation, variant)
        else:
            self.Residual_2 = Residual(mid, mid, activation, variant)
            self.Residual_3 = Residual(mid, in_ch, activation, variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.Residual_0(x)
        low = self.Residual_1(pool(x, self.pool))
        if self.num_layer > 1:
            low = self.Residual_2(self.Hourglass_0(low))
        else:
            low = self.Residual_3(self.Residual_2(low))
        if self.pool != "None":
            low = F.interpolate(low, scale_factor=2, mode="nearest")
        return up1 + low


class PreLayer(nn.Module):
    """Stem, a fixed 4x downsample (ref hourglass.py:793-833): 7x7 s2
    conv(64, BN) -> Residual(mid) -> pool -> Residual(mid) ->
    Residual(out)."""

    def __init__(self, mid_ch: int = 128, out_ch: int = 128,
                 activation: str = "ReLU", pool: str = "Max",
                 variant: str = "residual"):
        super().__init__()
        self.pool = pool
        self.Convolution_0 = Convolution(3, 64, 7, 2, use_bias=True, bn=True,
                                         activation=activation)
        self.Residual_0 = Residual(64, mid_ch, "ReLU", variant)
        self.Residual_1 = Residual(mid_ch, mid_ch, "ReLU", variant)
        self.Residual_2 = Residual(mid_ch, out_ch, "ReLU", variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Residual_0(self.Convolution_0(x))
        x = self.Residual_1(pool(x, self.pool))
        return self.Residual_2(x)


class Neck(nn.Module):
    """Feature neck (ref hourglass.py:836-863): pool (None) -> 1x1 BN
    conv -> Residual."""

    def __init__(self, ch: int = 128, activation: str = "ReLU",
                 pool: str = "None", variant: str = "residual"):
        super().__init__()
        if pool != "None":
            raise NotImplementedError("neck_pool %r is not ported (have "
                                      "'None')" % pool)
        self.Convolution_0 = Convolution(ch, ch, 1, 1, use_bias=True, bn=True,
                                         activation=activation)
        self.Residual_0 = Residual(ch, ch, "ReLU", variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Residual_0(self.Convolution_0(x))


class Head(nn.Module):
    """Prediction head, one 1x1 linear conv (ref hourglass.py:866-874)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Convolution_0 = Convolution(in_ch, out_ch, 1, 1, use_bias=True,
                                         bn=False, activation="Linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Convolution_0(x)


class StackedHourglass(nn.Module):
    """Full detector (ref hourglass.py:877-964): PreLayer -> per stack
    [Hourglass -> Neck -> Head], with `x = x + merge(feature) +
    merge(prediction)` between stacks. images (B, H, W, 3) ->
    (B, S, H/4, W/4, out_ch) float32 raw logits.

    `dtype` is the compute dtype (None = float32; bfloat16 under --amp,
    with float32 parameters cast at each conv call)."""

    def __init__(self, num_stack: int = 1, in_ch: int = 128, out_ch: int = 6,
                 increase_ch: int = 0, activation: str = "ReLU",
                 pool: str = "Max", neck_activation: str = "ReLU",
                 neck_pool: str = "None", variant: str = "residual",
                 stem_width: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_stack < 1:
            raise NotImplementedError("num_stack must be >= 1, got %d"
                                      % num_stack)
        if pool not in POOLS:
            raise NotImplementedError("pool %r is not ported (have %s)"
                                      % (pool, POOLS))
        self.num_stack = num_stack
        self.dtype = dtype
        self.PreLayer_0 = PreLayer(stem_width or 128, in_ch, activation,
                                   pool, variant)
        for i in range(num_stack):
            setattr(self, "Hourglass_%d" % i,
                    Hourglass(4, in_ch, increase_ch, activation, pool,
                              variant))
            setattr(self, "Neck_%d" % i,
                    Neck(in_ch, neck_activation, neck_pool, variant))
            setattr(self, "Head_%d" % i, Head(in_ch, out_ch))
            if i < num_stack - 1:
                setattr(self, "Convolution_%d" % (2 * i),
                        Convolution(in_ch, in_ch, 1, 1, use_bias=True,
                                    bn=False, activation="Linear"))
                setattr(self, "Convolution_%d" % (2 * i + 1),
                        Convolution(out_ch, in_ch, 1, 1, use_bias=True,
                                    bn=False, activation="Linear"))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # (B, H, W, 3) -> NCHW view, already channels-last in memory
        x = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.PreLayer_0(x.contiguous(memory_format=torch.channels_last))
        predictions = []
        for i in range(self.num_stack):
            hg = getattr(self, "Hourglass_%d" % i)(x)
            feature = getattr(self, "Neck_%d" % i)(hg)
            prediction = getattr(self, "Head_%d" % i)(feature)
            predictions.append(prediction.permute(0, 2, 3, 1))
            if i < self.num_stack - 1:
                x = (x + getattr(self, "Convolution_%d" % (2 * i))(feature)
                     + getattr(self, "Convolution_%d" % (2 * i + 1))(
                         prediction))
        return torch.stack(predictions, dim=1).float()


def cast_convs(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every conv's weight and bias to the compute dtype, once, for
    eval; the BatchNorm state stays float32 (the BN fold is f32). Never
    for training: the optimizer must update float32 weights."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return model


def build_model(cfg, dtype: Optional[torch.dtype] = None) -> StackedHourglass:
    """The detector from a config with the JAX flag names
    (ref models/hourglass.py:967 `build_model`), conv weights in
    channels-last memory format."""
    model = StackedHourglass(
        num_stack=cfg.num_stack, in_ch=cfg.hourglass_inch,
        out_ch=cfg.num_cls + 4, increase_ch=cfg.increase_ch,
        activation=cfg.activation, pool=cfg.pool,
        neck_activation=cfg.neck_activation, neck_pool=cfg.neck_pool,
        variant=cfg.variant, stem_width=cfg.stem_width, dtype=dtype)
    return model.to(memory_format=torch.channels_last)
