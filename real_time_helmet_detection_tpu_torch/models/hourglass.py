"""Stacked-hourglass CenterNet detector in PyTorch, train and eval.

Port of ref models/hourglass.py:877 `StackedHourglass` (reference
hourglass.py:198-237) and its blocks: `Activation` (hourglass.py:103),
`SPP` (:132), `Pool` (:155), `StemConv` (:180), `QuantConv` (:228),
`Convolution` (:443), `GhostModule` (:564), `Residual` (:603, the
"residual", "depthwise" and "ghost" variants), `Hourglass` (:740),
`PreLayer` (:793), `Neck` (:836), `Head` (:866) — every architecture
option of JAX `build_model` (:967), and its inference-compression twins
(`fold_bn`, `quant_mode`).

* Submodules carry the flax auto-names (`PreLayer_0`, `Convolution_1`,
  `GhostModule_0`, `Pool_0`, `SPP_0`, `Conv_0`, `BatchNorm_0`,
  `Activation_0/PReLU_0`, ...), so a state dict's keys mirror the flax
  module paths and `convert.py` fills every leaf under
  `load_state_dict(strict=True)`.
* Every BatchNorm runs through the hand-written BN kernels — the TPU
  program's `--epilogue fused --block-fuse fused`; the port has no other
  BN path. In eval (`model.eval()`) the running statistics fold into a
  per-channel f32 affine (`eff_scale = gamma * rsqrt(var + eps)`,
  `eff_bias = beta - mean * eff_scale`, hourglass.py:387-390) feeding
  the epilogue (`ops.epilogue.bn_act_eval`) after every BN'd conv and,
  where the JAX rule fuses it, the residual tail
  (`ops.residual.bn_add_act_eval`); both are differentiable through their
  eval backward kernels, so a gradient of an eval-mode model reaches every
  parameter, gamma and beta through the fold. In train (`model.train()`)
  the same sites run `bn_act_train`/`bn_add_act_train` with batch moments
  and update the running buffers as flax does (hourglass.py:367-384,
  :426-436): momentum 0.9, the biased variance, no gradient.
* The kernels take the activations ReLU, Mish and Linear
  (`FUSED_ACTIVATIONS`, JAX `FUSED_EPILOGUE_ACTIVATIONS`). At a BN site
  with another activation (LReLU, PReLU, Sigmoid, CELU) the same BN
  kernels run with Linear and the activation follows in plain PyTorch,
  chosen by name when the module is built (JAX keeps `nn.BatchNorm` +
  `Activation` in XLA there, hourglass.py:556-561).
* The residual tail kernel runs where JAX fuses the tail
  (hourglass.py:650-654): the residual and depthwise variants with a
  post-add activation in `FUSED_ACTIVATIONS`. In every other block the
  tail conv's BN runs the epilogue with Linear and the skip-add and the
  activation follow in plain PyTorch (hourglass.py:689). The PreLayer
  and Neck Residual blocks always use ReLU (hourglass.py:829-832, :861),
  so their tails stay fused whatever `--activation` is.
* Activations are NCHW tensors in `torch.channels_last` memory format
  (physically NHWC, what the kernels read and cuDNN prefers; the ghost
  and SPP concatenations keep it). The public contract is the JAX one:
  images (B, H, W, 3) in, logits (B, S, H/4, W/4, C+4) float32 out (H/2
  with `--pool SPP` or `None`, which never downsample).
* Precision follows the JAX fp32 param policy: parameters stay float32
  and every conv casts its weight and bias to its input's dtype at each
  call (bf16 under --amp), as does the PReLU slope, so gradients and
  optimizer state stay float32. Eval may cast the conv weights once
  (`cast_convs`); the per-call cast is then a no-op.
* Padding is the reference's symmetric (k-1)//2; the 2x upsample is
  exact nearest; `stem_s2d` computes the 7x7 stride-2 stem as a 4x4
  stride-1 conv over the 2x2 space-to-depth input (odd H or W take the
  direct conv), with the same `Conv_0` parameters.
* The twins (ref hourglass.py:443-561, ops/quant.py): `fold_bn=True`
  builds the model without BatchNorm, each BN'd conv with a bias that
  holds the fold (`ops.quant.fold_batchnorm`), its activation in plain
  PyTorch after it and every residual tail unfused (`act(y + skip)`,
  hourglass.py:650-655), so no BN kernel runs. `quant_mode="calibrate"`
  or `"int8"` (fold required) makes each BN'd conv but the stem a
  `QuantConv` (same `Conv_0` name): in "calibrate" a float conv that
  records the running abs-max (or percentile) of its input in its
  `act_scale` buffer; in "int8" the activation quantizer and the int8
  conv kernels of `ops.qconv`, with ReLU/Linear fused into the conv's
  epilogue. The stem stays a float conv (its BN still folds), as do the
  heads, the inter-stack merges and the pool/SPP convs, which carry no
  BN. In "int8" the residual and ghost blocks quantize their input once
  and each int8 conv writes the codes of the conv that alone reads its
  output (`Residual.fuse_codes`): 18 quantizer launches a throughput or
  flagship predict, not one a conv.
* Quirks kept from the JAX model: the Neck conv has a bias before its BN
  (hourglass.py:859); the PReLU slope is one scalar initialised at 0.25
  (hourglass.py:119-122), not torch's per-channel default.
* Train-step extras: `fwd_dtype="int8"` (ref hourglass.py:300-330
  `STEConv`, eligibility :516-535) runs every BN'd, bias-free, unfolded
  conv but the stem through `ops.quant.ste_conv` in train mode (the
  int8 kernels forward, the float conv's backward); `Conv_0` stays an
  `nn.Conv2d`, so checkpoints interchange and eval binds the float conv.
  `remat="stacks"` recomputes each `Hourglass` stack in backward,
  `"full"` the whole forward (ref hourglass.py:938-945, train.py:263-268),
  through a non-reentrant `torch.utils.checkpoint` that reruns the whole
  forward (no early stop); a BatchNorm in the recompute leaves its
  running statistics alone, so they move once per step, as flax's do.
  Under `--param-policy bf16-compute` the parameters are bf16
  (`cast_params`): the BN kernels take gamma and beta cast to float32.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import epilogue, qconv, quant, residual

ACTIVATIONS = ("ReLU", "LReLU", "PReLU", "Linear", "Mish", "Sigmoid", "CELU")
FUSED_ACTIVATIONS = epilogue.ACTIVATIONS  # what the BN kernels compute
POOLS = ("Max", "Avg", "Conv", "SPP", "None")
NECK_POOLS = ("None", "SPP")
VARIANTS = ("residual", "depthwise", "ghost")
QUANT_MODES = ("off", "calibrate", "int8")
REMAT = ("none", "stacks", "full")

_recompute = threading.local()  # set while a checkpoint recomputes


def recomputing() -> bool:
    """Is this thread rerunning a forward for a checkpoint's backward?"""
    return getattr(_recompute, "active", False)


@contextlib.contextmanager
def _recompute_scope():
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def _contexts():
    return contextlib.nullcontext(), _recompute_scope()


def remat(fn, *args):
    """`fn(*args)` whose activations are recomputed in backward: a
    non-reentrant checkpoint that reruns all of `fn` (no early stop),
    the rerun marked so that BatchNorm keeps its running statistics."""
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=_contexts)


def _check(kind: str, value: str, allowed) -> None:
    if value not in allowed:
        raise NotImplementedError("%s %r is not ported (have %s)"
                                  % (kind, value, ", ".join(allowed)))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` applied with its weight and bias cast to x's dtype, its
    output channels-last. cuDNN writes a channels-last output for a
    channels-last input, so eagerly the last step returns the tensor
    itself; under `torch.export`, whose fake convolutions may report a
    contiguous output (torch 2.11), it fixes the layout the kernels'
    wrappers require."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return _channels_last(F.conv2d(x, conv.weight.to(x.dtype), bias,
                                   conv.stride, conv.padding, conv.dilation,
                                   conv.groups))


class PReLU(nn.Module):
    """flax `nn.PReLU(negative_slope_init=0.25)`: one scalar slope,
    `x if x >= 0 else slope * x`, the slope cast to x's dtype."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class Activation(nn.Module):
    """The activation factory (ref hourglass.py:103-129) in plain
    PyTorch: ReLU | LReLU (slope 0.01) | PReLU | Linear | Mish | Sigmoid |
    CELU (alpha 1). PReLU keeps its slope in the child `PReLU_0`."""

    def __init__(self, activation: str):
        super().__init__()
        _check("activation", activation, ACTIVATIONS)
        self.activation = activation
        if activation == "PReLU":
            self.PReLU_0 = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        name = self.activation
        if name == "PReLU":
            return self.PReLU_0(x)
        if name == "LReLU":
            return F.leaky_relu(x, 0.01)
        if name == "Sigmoid":
            return torch.sigmoid(x)
        if name == "CELU":
            return F.celu(x, 1.0)
        return epilogue.activate(x, name)  # ReLU, Mish, Linear


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
        scale = self.weight.float() * torch.rsqrt(self.running_var
                                                  + self.eps)
        return scale, self.bias.float() - self.running_mean * scale

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
        # the kernels take float32 (C,) vectors: bf16 parameters
        # (--param-policy bf16-compute) are cast here, their gradients
        # cast back (ref ops/pallas/epilogue.py:473-474)
        gamma, beta = self.weight.float(), self.bias.float()
        if skip is None:
            out, mean, var = epilogue.bn_act_train(
                y, gamma, beta, activation, self.eps)
        else:
            out, mean, var = residual.bn_add_act_train(
                y, gamma, beta, skip, activation, self.eps)
        if recomputing():  # the first forward updated them
            return out
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return out


def stem_s2d_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """The 7x7 stride-2 conv with padding 3 as a 4x4 stride-1 conv over
    the 2x2 space-to-depth input (ref models/hourglass.py:180-229): the
    kernel padded to 8x8 at the top and left and regrouped so that
    out(i, j) = sum W8[2a+p, 2b+q] x[2(i+a-2)+p, 2(j+b-2)+q]. Needs even
    H and W."""
    n, c, h, w = x.shape
    f = conv.weight.shape[0]
    xs = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = _channels_last(xs.reshape(n, 4 * c, h // 2, w // 2))
    k8 = F.pad(conv.weight.to(x.dtype), (1, 0, 1, 0))        # (F, C, 8, 8)
    ks = k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    ks = _channels_last(ks.reshape(f, 4 * c, 4, 4))
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return _channels_last(F.conv2d(F.pad(xs, (2, 1, 2, 1)), ks, bias))


class QuantConv(nn.Module):
    """The conv body of the int8 twin (ref hourglass.py:228-298), stride
    1, dense (k 1 or 3) or 3 x 3 depthwise, under the `Conv_0` name.

    State dict: `weight` (OIHW float32) and `bias` (float32), the BN fold
    (`ops.quant.fold_batchnorm`), and `act_scale`, the calibrated clip
    range of its input (the JAX `quant` collection's leaf). Derived by
    `requantize` and kept out of the state dict: `weight_q`, the int8
    weights as the kernel reads them ((Cout, k*k*Cin) dense, (9, C)
    depthwise), `step` = max(act_scale, 1e-8) / 127 and `mult` = step *
    the per-channel weight scale (JAX's float32 product), all device
    tensors the kernels read, so new weights or scales need no new CUDA
    graph.

    mode "calibrate": the float conv of the folded weights, after raising
    `act_scale` to the abs-max (or the `calib_percentile` of |x|) of the
    input. mode "int8": `qconv.quantize_act` and `qconv.conv_dense` /
    `conv_dw`, the rescale in the input's dtype, `activation` (ReLU or
    Linear) fused. An int8 `x` is the input's codes at this conv's
    `step` already (then `dtype` names the output's dtype); `store` and
    `codes` are the conv wrappers' (the float output, the codes that
    the next convs read)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 groups: int = 1, mode: str = "int8",
                 calib_percentile: float = 100.0):
        super().__init__()
        _check("quant mode", mode, QUANT_MODES[1:])
        self.depthwise = groups > 1
        if self.depthwise and (groups != in_ch or in_ch != out_ch
                               or kernel_size != 3):
            raise NotImplementedError(
                "a grouped int8 conv is a 3x3 depthwise one (groups = in = "
                "out channels), got %d -> %d, groups %d, k %d"
                % (in_ch, out_ch, groups, kernel_size))
        if kernel_size not in (1, 3):
            raise NotImplementedError("int8 convs are 1x1 or 3x3, got %d"
                                      % kernel_size)
        self.k, self.groups, self.mode = kernel_size, groups, mode
        self.calib_percentile = float(calib_percentile)
        k = kernel_size
        # inference only: no gradient is ever taken through the twin
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, k, k),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_ch), requires_grad=False)
        self.register_buffer("act_scale", torch.ones(()))
        wq = (k * k, out_ch) if self.depthwise else (out_ch, k * k * in_ch)
        self.register_buffer("weight_q", torch.zeros(wq, dtype=torch.int8),
                             persistent=False)
        self.register_buffer("mult", torch.zeros(out_ch), persistent=False)
        self.register_buffer("step", torch.ones(()), persistent=False)

    @torch.no_grad()
    def requantize(self) -> None:
        """weight_q, step and mult from weight and act_scale, on the host
        (the CPU and the card get the same bits), copied in place."""
        from ..ops import quant
        q, w_scale = quant.quantize_weights(self.weight.detach().cpu())
        step = quant.act_step(self.act_scale.detach().cpu())
        cout = q.shape[0]
        if self.depthwise:
            wq = q.reshape(cout, self.k * self.k).t()
        else:
            wq = q.permute(0, 2, 3, 1).reshape(cout, -1)
        self.weight_q.copy_(wq)
        self.step.copy_(step)
        self.mult.copy_(step * w_scale)

    def forward(self, x: torch.Tensor, activation: str = "Linear",
                store: bool = True, codes=(),
                dtype: Optional[torch.dtype] = None
                ) -> Optional[torch.Tensor]:
        dt = x.dtype
        if self.mode == "calibrate":
            from ..ops import quant
            stat = (x.detach().float().abs().amax()
                    if self.calib_percentile >= 100.0
                    else quant.abs_percentile(x, self.calib_percentile))
            self.act_scale.copy_(torch.maximum(self.act_scale, stat))
            y = F.conv2d(x, self.weight.to(dt), None, 1, self.k // 2, 1,
                         self.groups)
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
            return epilogue.activate(_channels_last(y), activation)
        if x.dtype == torch.int8:
            q, dt = x, dtype
        else:
            q = qconv.quantize_act(x, self.step)
        if self.depthwise:
            return qconv.conv_dw(q, self.weight_q, self.mult, self.bias, dt,
                                 activation, store, codes)
        cout, cin = self.weight.shape[:2]
        return qconv.conv_dense(q, self.weight_q.view(cout, self.k, self.k,
                                                      cin),
                                self.mult, self.bias, dt, activation, store,
                                codes)


def _codes_like(x: torch.Tensor, channels: int) -> torch.Tensor:
    """An int8 channels-last tensor of x's batch and size, `channels`
    channels: the input codes an int8 conv writes for the next one. A
    view of a flat buffer: an exported program's mutations then land in
    a buffer whose layout no size-1 dimension leaves open (AOTInductor
    copied a 1x1 map's channels-last buffer, and lost the writes)."""
    n, _, h, w = x.shape
    flat = torch.empty((n * h * w * channels,), dtype=torch.int8,
                       device=x.device)
    return flat.view(n, h, w, channels).permute(0, 3, 1, 2)


class Convolution(nn.Module):
    """Conv -> optional BN + activation (ref hourglass.py:443-561). With
    `skip`, the BN feeds the residual tail: act(BN(conv(x)) + skip), which
    takes an activation the kernels compute. An activation they do not
    compute runs after a Linear BN as `Activation_0`. `groups` is the
    conv's feature-group count (depthwise when it equals the channels);
    `stem_s2d`, set on the 7x7 stride-2 stem only, computes it in its
    space-to-depth form.

    Twins: with `fold_bn` a BN'd conv has no BatchNorm and a bias (the
    fold), and its activation follows in plain PyTorch; with `quant_mode`
    calibrate/int8 (fold required) and `quantize` (the stem opts out) its
    body is a `QuantConv`, whose int8 epilogue fuses ReLU/Linear.

    `fwd_dtype="int8"`: a BN'd, bias-free, unfolded conv with `quantize`
    (`self.ste`) computes its train-mode forward with `quant.ste_conv`
    (ref hourglass.py:516-535); eval keeps the float conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True, bn: bool = False,
                 activation: str = "ReLU", groups: int = 1,
                 stem_s2d: bool = False, fold_bn: bool = False,
                 quant_mode: str = "off", quantize: bool = True,
                 calib_percentile: float = 100.0, fwd_dtype: str = "bf16"):
        super().__init__()
        _check("activation", activation, ACTIVATIONS)
        if not bn and activation != "Linear":
            raise NotImplementedError("a conv without BN is Linear in this "
                                      "model, got %r" % activation)
        fold = bn and fold_bn
        quant = quant_mode != "off" and quantize and bn
        if quant and not fold:
            raise ValueError(
                "quant_mode=%r requires fold_bn: BN must be folded into "
                "the conv before its weights are quantized (ops/quant.py)"
                % quant_mode)
        if quant:
            if stride != 1:
                raise NotImplementedError("int8 convs have stride 1, got %d"
                                          % stride)
            self.Conv_0 = QuantConv(in_ch, out_ch, kernel_size, groups,
                                    quant_mode, calib_percentile)
        else:
            self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                                    padding=(kernel_size - 1) // 2,
                                    groups=groups, bias=use_bias or fold)
        self.bn = bn and not fold
        self.fold = fold
        self.s2d = stem_s2d
        self.activation = activation
        self.ste = (fwd_dtype == "int8" and self.bn and quantize
                    and not use_bias)
        if self.ste and stride != 1:
            raise NotImplementedError("the int8 train forward has stride "
                                      "1 convs, got stride %d" % stride)
        if self.bn:
            self.BatchNorm_0 = BatchNorm(out_ch)
        if bn and activation not in FUSED_ACTIVATIONS:
            self.Activation_0 = Activation(activation)

    def _activate(self, y: torch.Tensor) -> torch.Tensor:
        if self.activation in FUSED_ACTIVATIONS:
            return epilogue.activate(y, self.activation)
        return self.Activation_0(y)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(self.Conv_0, QuantConv):
            fuse = self.activation in qconv.ACTIVATIONS
            y = self.Conv_0(x, self.activation if fuse else "Linear")
            return y if fuse else self._activate(y)
        if self.ste and self.training:
            y = quant.ste_conv(x, self.Conv_0.weight.to(x.dtype),
                               self.Conv_0.groups)
        elif self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            y = stem_s2d_conv(x, self.Conv_0)
        else:
            y = conv2d(x, self.Conv_0)
        if self.fold:
            return self._activate(y)
        if not self.bn:
            return y
        if self.activation in FUSED_ACTIVATIONS:
            return self.BatchNorm_0(y, self.activation, skip)
        if skip is not None:
            raise ValueError("the fused residual tail takes an activation "
                             "in %s, got %r" % (FUSED_ACTIVATIONS,
                                                self.activation))
        return self.Activation_0(self.BatchNorm_0(y, "Linear"))


class GhostModule(nn.Module):
    """Ghost module (ref hourglass.py:564-600): a 1x1 BN conv to out_ch/2
    "primary" features, a depthwise kxk BN conv of those to the other
    out_ch/2, concatenated along the channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, activation: str = "ReLU", **twin):
        super().__init__()
        if out_ch % 2:
            raise ValueError(
                "ghost variant needs an even channel width (half primary "
                "+ half ghost features), got out_ch=%d" % out_ch)
        half = out_ch // 2
        self.Convolution_0 = Convolution(in_ch, half, 1, stride,
                                         use_bias=False, bn=True,
                                         activation=activation, **twin)
        self.Convolution_1 = Convolution(half, half, kernel_size, 1,
                                         use_bias=False, bn=True,
                                         activation=activation, groups=half,
                                         **twin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        primary = self.Convolution_0(x)
        ghost = self.Convolution_1(primary)
        return _channels_last(torch.cat([primary, ghost], dim=1))

    def int8(self, q: torch.Tensor, dtype: torch.dtype,
             into: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Optional[torch.Tensor]:
        """The int8 twin's module from its input codes q (at the 1x1's
        step), each conv writing the codes its consumer reads: the 1x1 the
        depthwise conv's. With `into` (codes, step), the next module's
        input codes at its step: the 1x1 writes the first half of them
        and the depthwise conv the second, and no float output or concat
        is made (returns None); else the concat of both outputs, in
        `dtype`."""
        p, g = self.Convolution_0, self.Convolution_1
        dw = _codes_like(q, p.Conv_0.weight.shape[0])
        first = [(dw, g.Conv_0.step, 0)]
        if into is None:
            primary = p.Conv_0(q, p.activation, codes=first, dtype=dtype)
            ghost = g.Conv_0(dw, g.activation, dtype=dtype)
            return _channels_last(torch.cat([primary, ghost], dim=1))
        out, step = into
        p.Conv_0(q, p.activation, store=False,
                 codes=first + [(out, step, 0)], dtype=dtype)
        g.Conv_0(dw, g.activation, store=False,
                 codes=[(out, step, dw.shape[1])], dtype=dtype)
        return None


class Residual(nn.Module):
    """Residual block, `variant`-selectable (ref hourglass.py:603-733):

    * "residual" — two 3x3 BN convs;
    * "depthwise" — each 3x3 conv becomes a depthwise 3x3 and a pointwise
      1x1 BN conv (`Convolution_0..3`);
    * "ghost" — each 3x3 conv becomes a `GhostModule` (`GhostModule_0/1`);

    a 1x1 BN projection on the skip when the width changes (named after
    the body convs: `Convolution_2`, `_4`, `_0`), and the post-add
    activation. The tail is fused (`fuse_tail`: the last conv's BN, the
    add and the activation in the residual tail kernel) for the residual
    and depthwise variants with an activation in FUSED_ACTIVATIONS, and
    no twin (`twin`: the Convolution keywords `fold_bn`, `quant_mode`,
    `calib_percentile`); otherwise the tail conv is Linear and
    `Activation_0` follows the add (ref hourglass.py:650-655, :689).

    In the int8 twin (`quant_mode="int8"`) of the residual and ghost
    variants with an activation the int8 epilogue fuses (`fuse_codes`),
    the block quantizes its input once (at two steps where the
    projection takes it too) and each int8 conv writes the input codes
    of the conv that alone reads its output: the residual variant's
    `Convolution_0` those of `Convolution_1`, a ghost module's 1x1 those
    of its depthwise conv, and `GhostModule_0`'s two convs the halves of
    `GhostModule_1`'s input codes, so that concat is never made. The
    values are the unfused twin's, bit for bit."""

    def __init__(self, in_ch: int, out_ch: int, activation: str = "ReLU",
                 variant: str = "residual", **twin):
        super().__init__()
        _check("variant", variant, VARIANTS)
        _check("activation", activation, ACTIVATIONS)
        self.fuse_tail = (variant in ("residual", "depthwise")
                          and activation in FUSED_ACTIVATIONS
                          and not twin.get("fold_bn"))
        tail_act = activation if self.fuse_tail else "Linear"
        bn = dict(use_bias=False, bn=True, **twin)
        if variant == "residual":
            self.body = ("Convolution_0",)
            self.Convolution_0 = Convolution(in_ch, out_ch, 3, 1,
                                             activation=activation, **bn)
            self.tail = "Convolution_1"
            self.Convolution_1 = Convolution(out_ch, out_ch, 3, 1,
                                             activation=tail_act, **bn)
            skip = "Convolution_2"
        elif variant == "depthwise":
            self.body = ("Convolution_0", "Convolution_1", "Convolution_2")
            self.Convolution_0 = Convolution(in_ch, in_ch, 3, 1,
                                             activation=activation,
                                             groups=in_ch, **bn)
            self.Convolution_1 = Convolution(in_ch, out_ch, 1, 1,
                                             activation=activation, **bn)
            self.Convolution_2 = Convolution(out_ch, out_ch, 3, 1,
                                             activation=activation,
                                             groups=out_ch, **bn)
            self.tail = "Convolution_3"
            self.Convolution_3 = Convolution(out_ch, out_ch, 1, 1,
                                             activation=tail_act, **bn)
            skip = "Convolution_4"
        else:  # ghost: its tail is a concat of two BN'd halves
            self.body = ("GhostModule_0",)
            self.GhostModule_0 = GhostModule(in_ch, out_ch, 3, 1, activation,
                                             **twin)
            self.tail = "GhostModule_1"
            self.GhostModule_1 = GhostModule(out_ch, out_ch, 3, 1, "Linear",
                                             **twin)
            skip = "Convolution_0"
        self.skip = skip if in_ch != out_ch else None
        if self.skip:
            setattr(self, skip, Convolution(in_ch, out_ch, 1, 1,
                                            activation="Linear", **bn))
        if not self.fuse_tail:
            self.Activation_0 = Activation(activation)
        self.variant = variant
        self.fuse_codes = (twin.get("quant_mode") == "int8"
                           and variant in ("residual", "ghost")
                           and activation in qconv.ACTIVATIONS)

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 twin's block with the convs' code outputs (the class
        docstring)."""
        dt = x.dtype
        if self.variant == "residual":
            first, second = self.Convolution_0, self.Convolution_1
        else:
            first = self.GhostModule_0.Convolution_0
            second = self.GhostModule_1.Convolution_0
        if self.skip:
            proj = getattr(self, self.skip).Conv_0
            q, qs = qconv.quantize_act(x, first.Conv_0.step, proj.step)
            skip = proj(qs, "Linear", dtype=dt)
        else:
            q, skip = qconv.quantize_act(x, first.Conv_0.step), x
        mid = _codes_like(x, second.Conv_0.weight.shape[1])
        if self.variant == "residual":
            first.Conv_0(q, first.activation, store=False,
                         codes=[(mid, second.Conv_0.step, 0)], dtype=dt)
            y = second.Conv_0(mid, second.activation, dtype=dt)
        else:
            self.GhostModule_0.int8(q, dt, into=(mid, second.Conv_0.step))
            y = self.GhostModule_1.int8(mid, dt)
        return self.Activation_0(y + skip)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_codes:
            return self._int8(x)
        y = x
        for name in self.body:
            y = getattr(self, name)(y)
        skip = getattr(self, self.skip)(x) if self.skip else x
        tail = getattr(self, self.tail)
        if self.fuse_tail:
            return tail(y, skip=skip)
        return self.Activation_0(tail(y) + skip)


def spp_pools(x: torch.Tensor, kernel_sizes=(5, 9, 13)) -> list:
    """[x] + its stride-1 k x k max pools (padded with -inf), each pool
    taken from the one before it: a k x k max is the max over a p x p
    window of (k - p + 1) x (k - p + 1) maxes, exactly, so 5, 9 and 13
    are three 5 x 5 pools (75 reads an output instead of 275)."""
    pooled, prev = [x], 1
    for k in kernel_sizes:
        step = k - prev + 1
        pooled.append(F.max_pool2d(pooled[-1], step, 1, (step - 1) // 2))
        prev = k
    return pooled


class SPP(nn.Module):
    """Spatial pyramid pooling (ref hourglass.py:132-152): a 1x1 conv to
    ch/2, stride-1 max pools of 5, 9 and 13 (padded with -inf;
    `spp_pools`), the four concatenated, a 1x1 conv back to ch; neither
    conv has a bias."""

    def __init__(self, ch: int, kernel_sizes=(5, 9, 13)):
        super().__init__()
        half = ch // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.Conv_0 = nn.Conv2d(ch, half, 1, bias=False)
        self.Conv_1 = nn.Conv2d(half * (1 + len(self.kernel_sizes)), ch, 1,
                                bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = spp_pools(conv2d(x, self.Conv_0), self.kernel_sizes)
        return conv2d(_channels_last(torch.cat(pooled, dim=1)), self.Conv_1)


class Pool(nn.Module):
    """Downsample factory (ref hourglass.py:155-177): Max or Avg 2x2/2,
    Conv (2x2 stride-2 VALID conv with bias, `Conv_0`), SPP (`SPP_0`,
    keeps the resolution) or None (identity)."""

    def __init__(self, channel: int, pool: str = "Max"):
        super().__init__()
        _check("pool", pool, POOLS)
        self.pool = pool
        if pool == "Conv":
            self.Conv_0 = nn.Conv2d(channel, channel, 2, 2, bias=True)
        elif pool == "SPP":
            self.SPP_0 = SPP(channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool == "Max":
            return F.max_pool2d(x, 2, 2)
        if self.pool == "Avg":
            return F.avg_pool2d(x, 2, 2)
        if self.pool == "Conv":
            return conv2d(x, self.Conv_0)
        if self.pool == "SPP":
            return self.SPP_0(x)
        return x


class Hourglass(nn.Module):
    """Recursive U-module (ref hourglass.py:740-790): skip branch +
    [pool -> residual -> recurse/bottom -> residual -> nearest 2x up];
    SPP and None pools keep the resolution, so nothing is upsampled."""

    def __init__(self, num_layer: int, in_ch: int, increase_ch: int = 0,
                 activation: str = "ReLU", pool: str = "Max",
                 variant: str = "residual", **twin):
        super().__init__()
        mid = in_ch + increase_ch
        self.num_layer = num_layer
        self.upsample = pool not in ("SPP", "None")
        self.Residual_0 = Residual(in_ch, in_ch, activation, variant, **twin)
        self.Pool_0 = Pool(in_ch, pool)
        self.Residual_1 = Residual(in_ch, mid, activation, variant, **twin)
        if num_layer > 1:
            self.Hourglass_0 = Hourglass(num_layer - 1, mid, increase_ch,
                                         activation, pool, variant, **twin)
            self.Residual_2 = Residual(mid, in_ch, activation, variant,
                                       **twin)
        else:
            self.Residual_2 = Residual(mid, mid, activation, variant, **twin)
            self.Residual_3 = Residual(mid, in_ch, activation, variant,
                                       **twin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.Residual_0(x)
        low = self.Residual_1(self.Pool_0(x))
        if self.num_layer > 1:
            low = self.Residual_2(self.Hourglass_0(low))
        else:
            low = self.Residual_3(self.Residual_2(low))
        if self.upsample:
            low = F.interpolate(low, scale_factor=2, mode="nearest")
        return up1 + low


class PreLayer(nn.Module):
    """Stem, a 4x downsample with the Max/Avg/Conv pools (ref
    hourglass.py:793-833): 7x7 s2 conv(64, BN) -> Residual(mid) -> pool ->
    Residual(mid) -> Residual(out); its Residuals use ReLU. The stem conv
    is never quantized (its BN still folds)."""

    def __init__(self, mid_ch: int = 128, out_ch: int = 128,
                 activation: str = "ReLU", pool: str = "Max",
                 variant: str = "residual", stem_s2d: bool = False,
                 **twin):
        super().__init__()
        self.Convolution_0 = Convolution(3, 64, 7, 2, use_bias=True, bn=True,
                                         activation=activation,
                                         stem_s2d=stem_s2d, quantize=False,
                                         **twin)
        self.Residual_0 = Residual(64, mid_ch, "ReLU", variant, **twin)
        self.Pool_0 = Pool(mid_ch, pool)
        self.Residual_1 = Residual(mid_ch, mid_ch, "ReLU", variant, **twin)
        self.Residual_2 = Residual(mid_ch, out_ch, "ReLU", variant, **twin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Residual_0(self.Convolution_0(x))
        x = self.Residual_1(self.Pool_0(x))
        return self.Residual_2(x)


class Neck(nn.Module):
    """Feature neck (ref hourglass.py:836-863): pool (None | SPP) -> 1x1
    BN conv -> Residual (ReLU)."""

    def __init__(self, ch: int = 128, activation: str = "ReLU",
                 pool: str = "None", variant: str = "residual", **twin):
        super().__init__()
        _check("neck_pool", pool, NECK_POOLS)
        self.Pool_0 = Pool(ch, pool)
        self.Convolution_0 = Convolution(ch, ch, 1, 1, use_bias=True, bn=True,
                                         activation=activation, **twin)
        self.Residual_0 = Residual(ch, ch, "ReLU", variant, **twin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Residual_0(self.Convolution_0(self.Pool_0(x)))


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
    with float32 parameters cast at each conv call). `twin`: the
    Convolution keywords `fold_bn`, `quant_mode`, `calib_percentile`
    and `fwd_dtype`. `remat` ("none" | "stacks" | "full") applies in
    train mode with gradients on."""

    def __init__(self, num_stack: int = 1, in_ch: int = 128, out_ch: int = 6,
                 increase_ch: int = 0, activation: str = "ReLU",
                 pool: str = "Max", neck_activation: str = "ReLU",
                 neck_pool: str = "None", variant: str = "residual",
                 stem_width: int = 0, stem_s2d: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: str = "none",
                 **twin):
        super().__init__()
        if num_stack < 1:
            raise NotImplementedError("num_stack must be >= 1, got %d"
                                      % num_stack)
        _check("remat", remat, REMAT)
        self.num_stack = num_stack
        self.dtype = dtype
        self.remat = remat
        self.PreLayer_0 = PreLayer(stem_width or 128, in_ch, activation,
                                   pool, variant, stem_s2d, **twin)
        for i in range(num_stack):
            setattr(self, "Hourglass_%d" % i,
                    Hourglass(4, in_ch, increase_ch, activation, pool,
                              variant, **twin))
            setattr(self, "Neck_%d" % i,
                    Neck(in_ch, neck_activation, neck_pool, variant, **twin))
            setattr(self, "Head_%d" % i, Head(in_ch, out_ch))
            if i < num_stack - 1:
                setattr(self, "Convolution_%d" % (2 * i),
                        Convolution(in_ch, in_ch, 1, 1, use_bias=True,
                                    bn=False, activation="Linear"))
                setattr(self, "Convolution_%d" % (2 * i + 1),
                        Convolution(out_ch, in_ch, 1, 1, use_bias=True,
                                    bn=False, activation="Linear"))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        on = self.training and torch.is_grad_enabled()
        if on and self.remat == "full":
            return remat(self._forward, images, False)
        return self._forward(images, on and self.remat == "stacks")

    def _forward(self, images: torch.Tensor, remat_stacks: bool
                 ) -> torch.Tensor:
        # (B, H, W, 3) -> NCHW view, already channels-last in memory
        x = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.PreLayer_0(_channels_last(x))
        predictions = []
        for i in range(self.num_stack):
            stack = getattr(self, "Hourglass_%d" % i)
            hg = remat(stack, x) if remat_stacks else stack(x)
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
    eval; the BatchNorm state and the PReLU slopes stay float32 (the BN
    fold is f32). Never for training: the optimizer must update float32
    weights."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return model


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every float parameter in `dtype`, in place (its memory format
    kept); buffers (the BN statistics) stay float32 — the parameters of
    `--param-policy bf16-compute` (ref train.py:103-128)."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def build_model(cfg, dtype: Optional[torch.dtype] = None,
                fold_bn: bool = False, quant_mode: str = "off",
                calib_percentile: float = 100.0) -> StackedHourglass:
    """The detector from a config with the JAX flag names
    (ref models/hourglass.py:967 `build_model`), conv weights in
    channels-last memory format. `fold_bn` / `quant_mode` build the
    inference twins (see the module docstring); quantization needs the
    fold, as in JAX. `cfg.fwd_dtype` and `cfg.remat` (when present) set
    the train forward's int8 convs and recompute."""
    if quant_mode not in QUANT_MODES:
        raise ValueError("quant_mode must be one of %s, got %r"
                         % (QUANT_MODES, quant_mode))
    if quant_mode != "off" and not fold_bn:
        raise ValueError("quant_mode=%r requires fold_bn=True (BN folds "
                         "before quantization)" % quant_mode)
    twin = {}
    if fold_bn:
        twin = dict(fold_bn=True, quant_mode=quant_mode,
                    calib_percentile=calib_percentile)
    elif getattr(cfg, "fwd_dtype", "bf16") == "int8":
        twin = dict(fwd_dtype="int8")
    model = StackedHourglass(
        num_stack=cfg.num_stack, in_ch=cfg.hourglass_inch,
        out_ch=cfg.num_cls + 4, increase_ch=cfg.increase_ch,
        activation=cfg.activation, pool=cfg.pool,
        neck_activation=cfg.neck_activation, neck_pool=cfg.neck_pool,
        variant=cfg.variant, stem_width=cfg.stem_width,
        stem_s2d=cfg.stem_s2d, dtype=dtype,
        remat=getattr(cfg, "remat", "none"), **twin)
    return model.to(memory_format=torch.channels_last)


def layer_summary(cfg, imsize: int
                  ) -> Tuple[List[Tuple[str, str, Tuple[int, ...], int]],
                             int]:
    """The layer table of `cfg`'s detector (ref train.py:1832-1842, flax
    `nn.tabulate(depth=2)`; the reference prints torchsummary on rank 0):
    (rows, total). A row is (name, type, output shape, parameters) of a
    module at depth 2, or of a depth-1 module without submodules, in
    module order; the rows' parameters add up to `total`, the model's
    `sum(p.numel())`. Shape inference alone: the model is built on the
    `meta` device and run on a (1, imsize, imsize, 3) `meta` image in eval
    mode, so no tensor lives on a card and no kernel launches (the
    wrappers take their fakes and plain versions on `meta` tensors)."""
    with torch.device("meta"):
        model = build_model(cfg).eval()
    picked = [(name, m) for name, m in model.named_modules()
              if name.count(".") == 1
              or (name and "." not in name and not any(m.children()))]
    shapes: Dict[str, Tuple[int, ...]] = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: shapes.__setitem__(
            name, tuple(out.shape)))
        for name, m in picked]
    try:
        with torch.no_grad():
            model(torch.empty(1, imsize, imsize, 3, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    rows = [(name, type(m).__name__, shapes.get(name, ()),
             sum(p.numel() for p in m.parameters())) for name, m in picked]
    return rows, sum(p.numel() for p in model.parameters())


def format_summary(rows, total: int) -> str:
    """`layer_summary`'s table as text, the total on its last line."""
    lines = ["%-40s %-18s %-22s %12s" % ("layer", "type",
                                          "output (N, C, H, W)", "params")]
    for name, kind, shape, n in rows:
        lines.append("%-40s %-18s %-22s %12d"
                     % (name, kind, shape or "-", n))  # "-": not called
    lines.append("total params: %d" % total)
    return "\n".join(lines)
