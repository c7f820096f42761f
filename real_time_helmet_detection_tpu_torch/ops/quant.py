"""Inference compression: BN folding and post-training int8 quantization.

Port of ref real_time_helmet_detection_tpu/ops/quant.py:84
(`fold_batchnorm`; `quantize_weights` :151, `quantize_activations` :167,
`make_quant_model` :248, the calibration step and `calibrate_scales`
:262-326, the scales artifact :328-361, `synthetic_calibration_batches`
:364) for the port's int8 eval path:

* `fold_batchnorm(params, batch_stats)` folds every `Conv_0` +
  `BatchNorm_0` pair of a flax-layout variable tree (nested numpy dicts,
  the tree `convert.state_dict_to_flax` gives) into the conv: kernel *
  inv and (conv bias - mean) * inv + beta, inv = gamma * rsqrt(var +
  eps) rounded to float32 first, JAX's operation order. It runs on the
  host in numpy, each step rounded to float32 as JAX's is, with the
  reciprocal square root correctly rounded (through float64), so the
  CPU path and the card fold the same bits. XLA-CPU's rsqrt is not
  correctly rounded, so a folded value can be an ulp or two from JAX's.
* `quantize_weights` (per output channel, abs-max / 127) and
  `quantize_activations` (per tensor, clip range / 127): plain PyTorch,
  JAX's formulas, round half to even. The twin quantizes its weights once
  when its weights load (`QuantConv.requantize`), not in every predict as
  the JAX program does (same values), so a captured CUDA graph holds no
  fold.
* `calibrate_scales` runs the twin in "calibrate" mode over batches; each
  eligible conv records the abs-max (or the `percentile` of |x|, numpy's
  "linear" rule in JAX's float32 arithmetic, from two `torch.kthvalue`
  order statistics: `torch.quantile` refuses more than 2^24 elements) of
  its input, max-combined across batches on the device, fetched once.
* `save_scales` / `load_scales` / `scales_hash` keep the JAX package's
  `quant-scales-v1` JSON with the same flax-path keys
  (`PreLayer_0/.../Conv_0/act_scale`) and the same sha256, so an artifact
  of either package loads into the other unchanged.
* `load_twin` puts a float checkpoint (flax tree or state dict of the
  BN'd model) into a twin in place: fold, load, requantize.
* `ste_conv` (ref ops/quant.py:184 `make_ste_conv`) is the conv of
  `--fwd-dtype int8` training: its forward quantizes the input against
  its own abs-max (the one-pass abs-max kernel, then one MAX all-reduce
  per call across the ranks of a process group) with the quantizer
  kernel (#16), the compute-dtype
  weight per output channel, and runs the int8 conv kernel, dense (#14)
  or depthwise (#15), rescaled as JAX does, `dt(acc) * dt(s_a * s_w)`;
  its backward is the float conv's (`aten.convolution_backward`, the
  kernels autograd of `F.conv2d` runs), a straight-through estimator.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

BN_EPS = 1e-5  # the BatchNorm epsilon of models/hourglass.py

# floors keeping the int8 grids defined on degenerate inputs (an all-zero
# calibration batch, a dead channel)
_SCALE_FLOOR = 1e-8

SCALES_FORMAT = "quant-scales-v1"


# ---------------------------------------------------------------------------
# BN folding


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def fold_batchnorm(params: Mapping, batch_stats: Mapping,
                   eps: float = BN_EPS) -> Dict:
    """Fold every BatchNorm into its sibling conv; returns the params tree
    of the `fold_bn=True` twin (BatchNorm subtrees dropped, each folded
    `Conv_0` with a bias). Refuses a BatchNorm without a `Conv_0` sibling
    or without its statistics, as JAX does."""

    def fold(p: Mapping, s) -> Dict:
        s = s if isinstance(s, Mapping) else {}
        out: Dict = {}
        if "BatchNorm_0" in p:
            if "Conv_0" not in p:
                raise ValueError(
                    "BatchNorm_0 without a Conv_0 sibling: fold_batchnorm "
                    "only understands the Convolution block layout "
                    "(models/hourglass.py); keys: %r" % sorted(p))
            bn = p["BatchNorm_0"]
            st = s.get("BatchNorm_0", {})
            if "mean" not in st or "var" not in st:
                raise ValueError(
                    "batch_stats missing mean/var for a BatchNorm_0 "
                    "(keys: %r) — pass the checkpoint's batch_stats "
                    "collection" % sorted(st))
            kernel = _f32(p["Conv_0"]["kernel"])
            cout = kernel.shape[-1]
            conv_bias = _f32(p["Conv_0"].get("bias", np.zeros(cout)))
            gamma = _f32(bn.get("scale", np.ones(cout)))
            beta = _f32(bn.get("bias", np.zeros(cout)))
            v = _f32(st["var"]) + np.float32(eps)
            rsqrt = _f32(1.0 / np.sqrt(v.astype(np.float64)))
            inv = _f32(gamma * rsqrt)
            out["Conv_0"] = {
                "kernel": _f32(kernel * inv),  # broadcast on HWIO's out axis
                "bias": _f32(_f32(_f32(conv_bias - _f32(st["mean"])) * inv)
                             + beta),
            }
        for key, val in p.items():
            if key == "BatchNorm_0" or key in out:
                continue
            out[key] = fold(val, s.get(key)) if isinstance(val, Mapping) \
                else val
        return out

    return fold(params, batch_stats)


# ---------------------------------------------------------------------------
# quantizers


def quantize_weights(weight: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-output-channel symmetric int8 of a (Cout, ...) weight (the
    port's OIHW; JAX's HWIO reduces over all axes but the last): returns
    (q int8 of weight's shape, scale float32 (Cout,)), scale = max(absmax,
    1e-8) / 127, q = clip(round(w / scale), -127, 127)."""
    w = weight.detach().to(torch.float32)
    absmax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    scale = torch.clamp(absmax, min=_SCALE_FLOOR) / 127.0
    view = (-1,) + (1,) * (w.dim() - 1)
    q = torch.clamp(torch.round(w / scale.view(view)), -127, 127)
    return q.to(torch.int8), scale


def act_step(absmax) -> torch.Tensor:
    """The activation quantization step of a calibrated clip range:
    max(absmax, 1e-8) / 127, a 0-d float32 tensor."""
    a = torch.as_tensor(absmax, dtype=torch.float32)
    return torch.clamp(a, min=_SCALE_FLOOR) / 127.0


def quantize_activations(x: torch.Tensor, absmax) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Symmetric per-tensor int8 against a calibrated clip range: (q int8
    in x's layout, step float32 0-d) with q * step ~= clip(x, -absmax,
    absmax). The plain version of `ops.qconv.quantize_act`."""
    from .qconv import quantize_act_reference
    step = act_step(absmax).to(x.device)
    return quantize_act_reference(x, step), step


def abs_percentile(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """`jnp.percentile(|x|, p)` over all of x (numpy's "linear" rule, in
    JAX's float32 arithmetic), from two order statistics: a 0-d float32
    tensor on x's device."""
    flat = x.detach().reshape(-1).to(torch.float32).abs()
    n = flat.numel()
    pos = (torch.tensor(percentile, dtype=torch.float32) / 100.0) \
        * torch.tensor(n - 1, dtype=torch.float32)
    lo = torch.clamp(torch.floor(pos), 0, n - 1)
    hi = torch.clamp(torch.ceil(pos), 0, n - 1)
    w_hi = pos - torch.floor(pos)
    w_lo = 1.0 - w_hi
    v_lo = torch.kthvalue(flat, int(lo) + 1).values
    v_hi = torch.kthvalue(flat, int(hi) + 1).values
    return v_lo * w_lo.to(flat.device) + v_hi * w_hi.to(flat.device)


# ---------------------------------------------------------------------------
# int8-forward training (--fwd-dtype int8)


def ste_forward(x: torch.Tensor, weight: torch.Tensor, groups: int
                ) -> torch.Tensor:
    """The int8 forward of a stride-1 conv with padding k // 2: x
    (N, C, H, W) channels-last f32/bf16, weight (Cout, C / groups, k, k)
    in x's dtype -> (N, Cout, H, W) in x's dtype, no bias. The step is
    max(abs-max of x over the global batch, 1e-8) / 127, on the device."""
    from . import qconv
    from ..parallel import distributed
    x = x.contiguous(memory_format=torch.channels_last)
    absmax = qconv.abs_max(x)
    if distributed.world_size() > 1:
        torch.distributed.all_reduce(absmax, op=torch.distributed.ReduceOp.MAX)
    step = act_step(absmax)
    q = qconv.quantize_act(x, step)
    wq, w_scale = quantize_weights(weight)
    mult = step * w_scale
    zero = torch.zeros_like(mult)
    cout = wq.shape[0]
    if groups > 1:
        return qconv.conv_dw(q, wq.reshape(cout, -1).t().contiguous(), mult,
                             zero, x.dtype, "Linear")
    return qconv.conv_dense(q, wq.permute(0, 2, 3, 1).contiguous(), mult,
                            zero, x.dtype, "Linear")


class STEConv(torch.autograd.Function):
    """(x, weight) -> the int8 forward (`ste_forward`); backward: the
    float conv's VJP at the same geometry (ref ops/quant.py:240-250)."""

    @staticmethod
    def forward(ctx, x, weight, groups):
        ctx.save_for_backward(x, weight)
        ctx.groups = groups
        return ste_forward(x, weight, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        p = weight.shape[-1] // 2
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, weight, None, [1, 1], [p, p], [1, 1], False, [0, 0],
            ctx.groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None


def ste_conv(x: torch.Tensor, weight: torch.Tensor,
             groups: int) -> torch.Tensor:
    """A stride-1 conv with padding k // 2 whose forward runs int8 and
    whose gradient is the float conv's."""
    return STEConv.apply(x, weight, groups)


# ---------------------------------------------------------------------------
# the twin


def make_quant_model(cfg, dtype: Optional[torch.dtype] = None,
                     mode: str = "int8", calib_percentile: float = 100.0):
    """The BN-folded twin in a quantization mode ("calibrate" | "int8")
    (ref ops/quant.py:248)."""
    from ..models.hourglass import build_model
    return build_model(cfg, dtype=dtype, fold_bn=True, quant_mode=mode,
                       calib_percentile=calib_percentile)


def flax_variables(variables) -> Dict:
    """A flax variable tree ({"params", "batch_stats"}, numpy) as it is,
    or the tree of a state dict of the BN'd model."""
    if isinstance(variables, Mapping) and "params" in variables:
        return variables
    from ..convert import state_dict_to_flax
    return state_dict_to_flax(variables)


@torch.no_grad()
def load_twin(twin: torch.nn.Module, variables, scales=None
              ) -> torch.nn.Module:
    """Fold a float checkpoint (flax tree or state dict of the BN'd model)
    into `twin` in place, with `scales` (the `quant` tree) as its clip
    ranges when given (else it keeps its own), then requantize every
    int8 conv. Every storage of the twin is kept: a CUDA graph that reads
    them sees the new weights."""
    from ..convert import flax_to_state_dict
    tree = flax_variables(variables)
    folded = {"params": fold_batchnorm(tree["params"],
                                       tree.get("batch_stats", {}))}
    if scales is not None:
        folded["quant"] = scales
    state = flax_to_state_dict(folded)
    own = twin.state_dict()
    for key, value in own.items():  # the clip ranges it keeps
        if key.endswith(".act_scale") and key not in state:
            state[key] = value
    twin.load_state_dict(state, strict=True)
    requantize(twin)
    return twin


def requantize(twin: torch.nn.Module) -> None:
    """Recompute every int8 conv's weights, step and rescale from its
    folded weight and clip range, in place."""
    from ..models.hourglass import QuantConv
    for m in twin.modules():
        if isinstance(m, QuantConv):
            m.requantize()


def quant_modules(twin: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{flax path of the conv ("PreLayer_0/.../Conv_0"): QuantConv}."""
    from ..models.hourglass import QuantConv
    return {name.replace(".", "/"): m for name, m in twin.named_modules()
            if isinstance(m, QuantConv)}


def read_scales(twin: torch.nn.Module) -> Dict:
    """The twin's clip ranges as the `quant` tree (nested dicts of
    float32, floored at 1e-8), one device fetch."""
    mods = quant_modules(twin)
    values = torch.stack([m.act_scale.detach().float().reshape(())
                          for m in mods.values()]).cpu().numpy()
    from ..convert import unflatten_tree
    return unflatten_tree({
        path + "/act_scale": np.maximum(np.float32(v), np.float32(
            _SCALE_FLOOR)) for path, v in zip(mods, values)})


@torch.no_grad()
def calibrate_scales(cfg, variables, batches: Iterable,
                     dtype: Optional[torch.dtype] = None,
                     normalize: Optional[str] = None,
                     percentile: float = 100.0, device="cuda") -> Dict:
    """Run the instrumented twin over calibration batches; return the
    activation scales tree (ref ops/quant.py:291). `variables` is the
    float checkpoint (flax tree or state dict); `batches` yields (B, H, W,
    3) arrays, normalized float32 or, when `normalize` names a statistics
    set, raw pixels normalized on the device. The running max stays on
    the device; the scales are fetched once at the end."""
    from ..predict import resolve_device
    from ..utils import normalizer_stats
    dev = resolve_device(device)
    twin = make_quant_model(cfg, dtype=dtype, mode="calibrate",
                            calib_percentile=percentile)
    load_twin(twin, variables)
    twin = twin.to(dev).eval()
    for m in quant_modules(twin).values():
        m.act_scale.zero_()
    if normalize is not None:
        mean, std = (torch.as_tensor(s, device=dev)
                     for s in normalizer_stats(normalize))
    n = 0
    for images in batches:
        x = torch.as_tensor(np.asarray(images)).to(dev)
        if normalize is not None:
            x = (x.to(torch.float32) / 255.0 - mean) / std
        twin(x)
        n += 1
    if n == 0:
        raise ValueError("calibrate_scales: no calibration batches given")
    return read_scales(twin)


# ---------------------------------------------------------------------------
# scales artifact (atomic, hashable)


def _scales_to_nested(scales) -> Dict:
    if isinstance(scales, Mapping):
        return {k: _scales_to_nested(v) for k, v in scales.items()}
    return float(np.asarray(scales))


def scales_hash(scales) -> str:
    """sha256 of the canonical JSON encoding (ref ops/quant.py:335)."""
    text = json.dumps(_scales_to_nested(scales), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def save_scales(path: str, scales, meta: Optional[Dict] = None) -> str:
    """Persist the scales tree atomically; returns its sha256."""
    from ..utils import save_json
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    digest = scales_hash(scales)
    save_json(path, {"format": SCALES_FORMAT, "sha256": digest,
                     **(meta or {}), "scales": _scales_to_nested(scales)},
              indent=1, sort_keys=True)
    return digest


def load_scales(path: str) -> Dict:
    """Load a `save_scales` artifact (of either package) into a tree of
    float32."""
    with open(path) as f:
        rec = json.load(f)
    if rec.get("format") != SCALES_FORMAT:
        raise ValueError("%s is not a %s artifact (format=%r)"
                         % (path, SCALES_FORMAT, rec.get("format")))

    def leaves(node):
        if isinstance(node, Mapping):
            return {k: leaves(v) for k, v in node.items()}
        return np.float32(node)
    return leaves(rec["scales"])


def synthetic_calibration_batches(batch: int, imsize: int, n: int = 2,
                                  raw: bool = False, seed: int = 0):
    """Deterministic synthetic calibration inputs (ref ops/quant.py:364):
    uint8 pixels when `raw`, else normalized-ish float32; the same numpy
    draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        if raw:
            yield rng.integers(0, 256, (batch, imsize, imsize, 3),
                               dtype=np.uint8)
        else:
            yield rng.standard_normal(
                (batch, imsize, imsize, 3)).astype(np.float32)
