"""BatchNorm + activation epilogue, eval and train.

Eval: `act(x * eff_scale + eff_bias)`, the port of ref
ops/pallas/epilogue.py:481 `fused_bn_act` (its Pallas `_fwd_kernel`,
epilogue.py:138, and the backward `_bwd_kernel`, epilogue.py:144). Every
BN'd conv of the detector ends here with the running statistics folded
into a per-channel affine (`eff_scale = gamma * rsqrt(var + eps)`,
`eff_bias = beta - mean * eff_scale`, ref models/hourglass.py:387-390).
`bn_act_eval` is the differentiable form (`BNEval`, a
`torch.autograd.Function`): its backward is one pass of
`csrc/bn_train.cu`'s eval kernel, which writes dx = dz * eff_scale and
the channel partials of d(eff_scale) = sum(dz * x) and d(eff_bias) =
sum(dz); autograd carries those two through the fold to gamma and beta,
as `jax.grad` does through the custom_vjp.

Train: `bn_act_train`, the port of ref ops/pallas/epilogue.py:235
`_make_fused_train` — batch moments, the same pointwise pass with the
batch-moment affine, and the analytic BN backward (S1/S2 channel sums,
then one `dx = a*dz - k2*x - k1` pass), as a `torch.autograd.Function`.
Its three passes are the kernels of `csrc/bn_train.cu` (ref
epilogue.py:424 `_stats_kernel`, :430 `_bwd_sums_kernel`, :439
`_bwd_dx_kernel`); `ops/residual.py` runs the same kernels with a skip
operand.

* Every wrapper (`bn_act`, `bn_eval_bwd`, `bn_stats`, `bn_bwd_sums`,
  `bn_bwd_dx`) launches its hand-written kernel for a CUDA tensor or
  raises, and runs its plain version for a CPU tensor. There is no
  fallback from one to the other.
* `*_reference` are the plain PyTorch versions: the same f32 arithmetic
  as the kernels, one eager op per step.
* `bn_act` reaches its kernels through the `helmet::bn_act` op
  (`ops.library`), which launches one of two kernels of csrc/epilogue.cu,
  chosen at launch by the C entry `helmet_bn_act_pick` (the rule
  `bn_act_variant` states): the 16-byte vector kernel, or the scalar
  kernel for a channel count or an alignment the vector kernel cannot
  take. A launch error raises either way.
* The module counters (`launches`, `eval_bwd_launches`,
  `stats_launches`, ...) count kernel launches, never plain-version
  calls; `vector_launches` and `scalar_launches` split `launches` by
  variant; `grad_conversions` counts the
  backward gradients that arrived in another layout than channels-last
  and were copied into it.

Layout: x is an NCHW tensor in `torch.channels_last` memory format, whose
storage is the (N*H*W, C) row-major block the TPU kernels tiled
(ref ops/pallas/epilogue.py:506-510) — the kernels read it as is, with
no copy. Anything else raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _build
from ..parallel import distributed

ACTIVATIONS = ("ReLU", "Mish", "Linear")
_ACT_CODE = {"ReLU": 0, "Mish": 1, "Linear": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132  # streaming multiprocessors of the H100
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
PLAIN_DEVICES = ("cpu", "meta")  # the wrappers' plain (or fake) path
_VEC_BYTES = 16   # one access of csrc/epilogue.cu's vector kernel
_MAX_GROUPS = 256  # its most channel groups (C / V), kMaxGroups there

launches = 0
vector_launches = 0
scalar_launches = 0
eval_bwd_launches = 0
stats_launches = 0
bwd_sums_launches = 0
bwd_dx_launches = 0
grad_conversions = 0


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


def activate_grad(z: torch.Tensor, activation: str) -> torch.Tensor:
    """d act(z)/dz recomputed from z (ref ops/pallas/epilogue.py:109):
    ReLU 0 at the tie; Mish with sigmoid written as 1 / (1 + exp(-z)),
    as the kernel computes it."""
    if activation == "ReLU":
        return (z > 0.0).to(z.dtype)
    if activation == "Mish":
        t = torch.tanh(torch.log1p(torch.exp(z)))
        return t + z * (1.0 - t * t) * (1.0 / (1.0 + torch.exp(-z)))
    if activation == "Linear":
        return torch.ones_like(z)
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


def check_vectors(x: torch.Tensor, **vectors: torch.Tensor) -> None:
    """Raise unless every named vector is a contiguous (C,) float32
    tensor on x's device."""
    c = x.shape[1]
    for name, v in vectors.items():
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


def plain_device(x: torch.Tensor) -> bool:
    """True where a wrapper runs the plain version (or, through its op,
    the fake): a CPU tensor, or a `meta` one (shape inference, which
    launches nothing)."""
    return x.device.type in PLAIN_DEVICES


def check_cuda(what: str, x: torch.Tensor) -> None:
    """Raise unless x lies on a CUDA card: the wrappers run their plain
    versions for CPU (and meta) tensors only."""
    if x.device.type != "cuda":
        raise ValueError("%s runs on cuda or cpu, got %s" % (what, x.device))


def _channel_vec(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _rows2d(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels-last -> its (N*H*W, C) block, no copy."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def bn_act_reference(x: torch.Tensor, eff_scale: torch.Tensor,
                     eff_bias: torch.Tensor, activation: str) -> torch.Tensor:
    """Plain PyTorch version: f32 math, result in x's dtype and layout."""
    z = x.float() * _channel_vec(eff_scale) + _channel_vec(eff_bias)
    return _channels_last(activate(z, activation).to(x.dtype))


def bn_act_variant(channels: int, dtype: torch.dtype, *pointers: int) -> str:
    """The kernel `helmet_bn_act_pick` (csrc/epilogue.cu) launches: "vector"
    when the channel count is a multiple of V = 16 bytes / element size (8
    bf16, 4 f32) with C / V <= 256 and every pointer (x's and out's data)
    is 16-byte aligned, else "scalar". A choice by shape, not a fallback on
    failure."""
    v = _VEC_BYTES // _ELEMENT_BYTES[dtype]
    if channels % v == 0 and channels // v <= _MAX_GROUPS \
            and all(p % _VEC_BYTES == 0 for p in pointers):
        return "vector"
    return "scalar"


def bn_act(x: torch.Tensor, eff_scale: torch.Tensor, eff_bias: torch.Tensor,
           activation: str, variant: Optional[str] = None) -> torch.Tensor:
    """`act(x * eff_scale + eff_bias)` per channel, the forward pass of
    eval and train, through the `helmet::bn_act` op (`ops.library`).

    x: (N, C, H, W) channels-last, float32 or bfloat16; eff_scale and
    eff_bias: (C,) float32. Returns a new tensor like x. `variant` ("vector"
    or "scalar") forces a kernel on a CUDA tensor; None leaves the choice
    to the kernel library at launch (`helmet_bn_act_pick`, the rule
    `bn_act_variant` states). The vector kernel refuses, and this raises
    on, a shape it cannot take."""
    check_activation(activation)
    check_layout("x", x)
    check_vectors(x, eff_scale=eff_scale, eff_bias=eff_bias)
    if not plain_device(x):
        check_cuda("bn_act", x)
    if variant not in (None, "vector", "scalar"):
        raise ValueError("variant must be 'vector' or 'scalar', got %r"
                         % (variant,))
    return torch.ops.helmet.bn_act.default(x, eff_scale, eff_bias,
                                           activation, variant or "auto")


# ---------------------------------------------------------- eval backward


def eval_bwd_reference(x, a, b, g, activation, skip=None):
    """Plain PyTorch version of the eval backward (with or without the
    skip): (dx = dz * a in x's dtype, ds = dz in the skip's dtype or None,
    (1, C) partial of sum(dz * x), (1, C) partial of sum(dz))."""
    dz = _dz_reference(x, a, b, g, activation, skip)
    dx = _channels_last((dz * _channel_vec(a)).to(x.dtype))
    ds = None if skip is None else _channels_last(dz.to(skip.dtype))
    dz2 = _rows2d(dz)
    return (dx, ds, (dz2 * _rows2d(x.float())).sum(0, keepdim=True),
            dz2.sum(0, keepdim=True))


def bn_eval_bwd_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          g: torch.Tensor, activation: str
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain PyTorch version of `bn_eval_bwd`."""
    dx, _, da, db = eval_bwd_reference(x, a, b, g, activation)
    return dx, da, db


def bn_eval_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                g: torch.Tensor, activation: str
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eval epilogue's backward in one pass (ref epilogue.py:144):
    dz = g * act'(x * a + b) recomputed; returns (dx = dz * a in x's
    dtype, partials of d(eff_scale) = sum(dz * x), partials of
    d(eff_bias) = sum(dz)), the partials (nblocks, C) float32 whose
    column sums are the totals."""
    global eval_bwd_launches
    _check_bwd(x, a, b, g, activation)
    if plain_device(x):
        return bn_eval_bwd_reference(x, a, b, g, activation)
    db, da, dx, _, launched = launch_bwd_sums(x, a, b, g, activation,
                                              write_dx=True)
    eval_bwd_launches += launched
    return dx, da, db


class EvalPasses(NamedTuple):
    """The forward and the backward pass of one eval BN family, with the
    activation bound; each takes the skip operand (None for the
    epilogue)."""
    forward: Callable   # (x, a, b, skip) -> out
    backward: Callable  # (x, a, b, g, skip) -> (dx, ds or None, da, db)


def _grad_channels_last(g: torch.Tensor) -> torch.Tensor:
    """The incoming gradient in channels-last, copied (and counted in
    `grad_conversions`) when it arrives in another layout."""
    global grad_conversions
    if g.is_contiguous(memory_format=torch.channels_last):
        return g
    grad_conversions += 1
    return _channels_last(g)


class BNEval(torch.autograd.Function):
    """Eval-mode BN + activation (+ skip) over the folded running
    statistics, ref ops/pallas/epilogue.py:157 `_make_fused` and
    residual.py:147 `_make_fused_add`: the forward kernel, and a backward
    that recomputes z from the saved inputs in one pass and returns
    (dx, d eff_scale, d eff_bias[, ds]); the partials are summed here."""

    @staticmethod
    def forward(ctx, x, a, b, skip, passes):
        ctx.save_for_backward(x, a, b, skip)
        ctx.passes = passes
        return passes.forward(x, a, b, skip)

    @staticmethod
    def backward(ctx, g):
        x, a, b, skip = ctx.saved_tensors
        dx, ds, da, db = ctx.passes.backward(x, a, b, _grad_channels_last(g),
                                             skip)
        return dx, da.sum(0), db.sum(0), ds, None


def bn_act_eval(x: torch.Tensor, eff_scale: torch.Tensor,
                eff_bias: torch.Tensor, activation: str) -> torch.Tensor:
    """Eval-mode BatchNorm + activation, differentiable w.r.t. x,
    eff_scale and eff_bias: `bn_act` forward, `bn_eval_bwd` backward.
    With grad mode off (`no_grad`, `inference_mode`: predict, the serving
    engine's graphs) the forward runs alone, without the autograd
    Function around it: the same kernel, the same bits."""
    check_activation(activation)
    check_layout("x", x)
    check_vectors(x, eff_scale=eff_scale, eff_bias=eff_bias)
    if not torch.is_grad_enabled():
        return bn_act(x, eff_scale, eff_bias, activation)

    def backward(x, a, b, g, skip):
        dx, da, db = bn_eval_bwd(x, a, b, g, activation)
        return dx, None, da, db

    return BNEval.apply(x, eff_scale, eff_bias, None, EvalPasses(
        lambda x, a, b, skip: bn_act(x, a, b, activation), backward))


# ------------------------------------------------------------- train passes


def reduction_blocks(rows: int) -> int:
    """Blocks of the two-stage reductions of csrc/bn_train.cu: 64 rows a
    block or more, at most 8 blocks per SM."""
    return max(1, min(-(-rows // 64), 8 * _SMS))


def _check_pairs(what: str, *tensors: torch.Tensor) -> None:
    """The train kernels read channel pairs (one bf16x2 / float2 load)."""
    for t in tensors:
        if t.shape[1] % 2 or t.data_ptr() % (2 * t.element_size()):
            raise ValueError("%s reads channel pairs: C must be even and the "
                             "data aligned to two elements, got C=%d at %#x"
                             % (what, t.shape[1], t.data_ptr()))


def _check_bwd(x, a, b, g, activation, skip=None, **more) -> None:
    check_activation(activation)
    check_layout("x", x)
    check_layout("g", g, like=x)
    if skip is not None:
        check_layout("skip", skip, like=x)
    check_vectors(x, a=a, b=b, **more)


def bn_stats_reference(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `bn_stats`: one (1, C) partial each."""
    x2 = _rows2d(x.float())
    return x2.sum(0, keepdim=True), (x2 * x2).sum(0, keepdim=True)


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel partial sums of x and x^2: two (nblocks, C) float32
    tensors whose column sums are the totals (ref epilogue.py:424).

    x: (N, C, H, W) channels-last, float32 or bfloat16."""
    global stats_launches
    check_layout("x", x)
    if plain_device(x):
        return bn_stats_reference(x)
    check_cuda("bn_stats", x)
    rows, c = x.numel() // x.shape[1], x.shape[1]
    nb = reduction_blocks(rows)
    part = torch.zeros((2, nb, c), device=x.device, dtype=torch.float32)
    if rows == 0:
        return part[0], part[1]
    _check_pairs("bn_stats", x)
    lib = _build.load("bn_train")
    err = lib.helmet_bn_stats(x.data_ptr(), part[0].data_ptr(),
                              part[1].data_ptr(), rows, c, nb,
                              _DTYPE_CODE[x.dtype],
                              _build.stream_handle(x.device))
    _build.check(err, "bn_stats")
    stats_launches += 1
    return part[0], part[1]


def _dz_reference(x, a, b, g, activation, skip):
    z = x.float() * _channel_vec(a) + _channel_vec(b)
    if skip is not None:
        z = z + skip.float()
    return g.float() * activate_grad(z, activation)


def bn_bwd_sums_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          g: torch.Tensor, activation: str,
                          skip: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sums pass (with or without the skip):
    one (1, C) partial each of S1 = sum(dz) and S2 = sum(dz * x)."""
    dz2 = _rows2d(_dz_reference(x, a, b, g, activation, skip))
    x2 = _rows2d(x.float())
    return dz2.sum(0, keepdim=True), (dz2 * x2).sum(0, keepdim=True)


def bn_bwd_dx_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        g: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                        activation: str, skip: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the dx pass: (dx = a*dz - k2*x - k1 in
    x's dtype, ds = dz in the skip's dtype or None)."""
    dz = _dz_reference(x, a, b, g, activation, skip)
    dx = _channel_vec(a) * dz - _channel_vec(k2) * x.float() \
        - _channel_vec(k1)
    ds = None if skip is None else _channels_last(dz.to(skip.dtype))
    return _channels_last(dx.to(x.dtype)), ds


def launch_bwd_sums(x, a, b, g, activation, skip=None, write_dx=False):
    """Launch csrc/bn_train.cu's sums kernel (the skip variant when `skip`
    is given) on CUDA tensors. With `write_dx`, the eval backward: the
    same pass also writes dx = dz * a (and ds = dz). Returns (s1
    partials, s2 partials, dx or None, ds or None, launched); the callers
    count the launch."""
    check_cuda("bn_bwd_sums", x)
    rows, c = x.numel() // x.shape[1], x.shape[1]
    nb = reduction_blocks(rows)
    part = torch.zeros((2, nb, c), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x) if write_dx else None
    ds = torch.empty_like(skip) if write_dx and skip is not None else None
    if rows == 0:
        return part[0], part[1], dx, ds, False
    operands = [t for t in (x, g, skip, dx, ds) if t is not None]
    _check_pairs("bn_bwd_sums", *operands)
    lib = _build.load("bn_train")
    err = lib.helmet_bn_bwd_sums(
        *(None if t is None else t.data_ptr() for t in (x, skip, g, a, b)),
        part[0].data_ptr(), part[1].data_ptr(),
        None if dx is None else dx.data_ptr(),
        None if ds is None else ds.data_ptr(), rows, c, nb,
        _DTYPE_CODE[x.dtype], _ACT_CODE[activation],
        _build.stream_handle(x.device))
    _build.check(err, "bn_bwd_sums")
    return part[0], part[1], dx, ds, True


def launch_bwd_dx(x, a, b, g, k1, k2, activation, skip=None):
    """Launch csrc/bn_train.cu's dx kernel on CUDA tensors; returns
    (dx, ds or None, launched)."""
    check_cuda("bn_bwd_dx", x)
    dx = torch.empty_like(x)
    ds = None if skip is None else torch.empty_like(skip)
    if x.numel() == 0:
        return dx, ds, False
    operands = (x, g, dx) if skip is None else (x, g, dx, skip, ds)
    _check_pairs("bn_bwd_dx", *operands)
    lib = _build.load("bn_train")
    err = lib.helmet_bn_bwd_dx(
        x.data_ptr(), None if skip is None else skip.data_ptr(),
        g.data_ptr(), a.data_ptr(), b.data_ptr(), k1.data_ptr(),
        k2.data_ptr(), dx.data_ptr(), None if ds is None else ds.data_ptr(),
        x.numel() // x.shape[1], x.shape[1], _DTYPE_CODE[x.dtype],
        _ACT_CODE[activation], _build.stream_handle(x.device))
    _build.check(err, "bn_bwd_dx")
    return dx, ds, True


def bn_bwd_sums(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                g: torch.Tensor, activation: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partials of S1 = sum(dz) and S2 = sum(dz * x) per channel, with
    dz = g * act'(x * a + b) recomputed (ref epilogue.py:430)."""
    global bwd_sums_launches
    _check_bwd(x, a, b, g, activation)
    if plain_device(x):
        return bn_bwd_sums_reference(x, a, b, g, activation)
    s1, s2, _, _, launched = launch_bwd_sums(x, a, b, g, activation)
    bwd_sums_launches += launched
    return s1, s2


def bn_bwd_dx(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              g: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
              activation: str) -> torch.Tensor:
    """dx = a*dz - k2*x - k1 in x's dtype (ref epilogue.py:439)."""
    global bwd_dx_launches
    _check_bwd(x, a, b, g, activation, k1=k1, k2=k2)
    if plain_device(x):
        return bn_bwd_dx_reference(x, a, b, g, k1, k2, activation)[0]
    dx, _, launched = launch_bwd_dx(x, a, b, g, k1, k2, activation)
    bwd_dx_launches += launched
    return dx


class Passes(NamedTuple):
    """The pointwise forward and the two backward passes of one train
    BN family, with the activation bound; each takes the skip operand
    (None for the epilogue)."""
    forward: Callable  # (x, a, b, skip) -> out
    sums: Callable     # (x, a, b, g, skip) -> (s1 partials, s2 partials)
    dx: Callable       # (x, a, b, g, k1, k2, skip) -> (dx, ds or None)


class BNTrain(torch.autograd.Function):
    """Train-mode BN + activation (+ skip), ref ops/pallas/epilogue.py:235
    `_make_fused_train` and residual.py:219 `_make_fused_add_train`.

    Forward: batch moments of x alone (the skip never enters them),
    mean and the biased variance max(E[x^2] - mean^2, 0), then the
    pointwise pass with a = gamma * rsqrt(var + eps), b = beta - mean*a.

    Backward, the JAX formulas exactly (epilogue.py:353-388): r2 =
    1/(var+eps), a = gamma*sqrt(r2); the sums pass gives S1, S2; dgamma =
    sqrt(r2)*(S2 - mean*S1), dbeta = S1, k2 = a*(S2 - mean*S1)*r2/N,
    k1 = a*S1/N - k2*mean; the dx pass writes a*dz - k2*x - k1 (and
    ds = dz). (mean, var) feed only the running statistics and are not
    differentiable.

    In a process group of world W > 1 (ref models/hourglass.py: JAX's
    GSPMD step takes the moments of the global batch), the forward sums
    (s, ss) and the backward's (S1, S2) are summed over the ranks, one
    (2C,) all-reduce each, and N is the global count; dgamma and dbeta
    stay this rank's, and DistributedDataParallel averages them. The
    running statistics come out equal on every rank."""

    @staticmethod
    def forward(ctx, x, gamma, beta, skip, eps, passes):
        s_part, ss_part = bn_stats(x)
        count = x.numel() // x.shape[1]
        s, ss = s_part.sum(0), ss_part.sum(0)
        world = distributed.world_size()
        if world > 1:  # the global batch's moments, as JAX's GSPMD step
            s, ss = distributed.all_reduce_sum_(torch.cat([s, ss])).chunk(2)
            count *= world
        mean = s / count
        var = torch.clamp_min(ss / count - mean * mean, 0.0)
        a = gamma * torch.rsqrt(var + eps)
        out = passes.forward(x, a, beta - mean * a, skip)
        ctx.save_for_backward(x, gamma, beta, skip, mean, var)
        ctx.eps, ctx.passes = eps, passes
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, beta, skip, mean, var = ctx.saved_tensors
        g = _grad_channels_last(g)
        count = x.numel() // x.shape[1]
        r2 = 1.0 / (var + ctx.eps)
        sr2 = torch.sqrt(r2)
        a = gamma * sr2
        b = beta - mean * a
        s1_part, s2_part = ctx.passes.sums(x, a, b, g, skip)
        s1, s2 = s1_part.sum(0), s2_part.sum(0)
        ctr = s2 - mean * s1
        dgamma, dbeta = sr2 * ctr, s1
        world = distributed.world_size()
        if world > 1:
            # k1, k2 take the global sums; dgamma and dbeta stay this
            # rank's, which DDP averages (SyncBatchNorm's convention)
            s1, s2 = distributed.all_reduce_sum_(
                torch.cat([s1, s2])).chunk(2)
            ctr = s2 - mean * s1
            count *= world
        k2 = a * ctr * r2 / count
        k1 = a * s1 / count - k2 * mean
        dx, ds = ctx.passes.dx(x, a, b, g, k1, k2, skip)
        return dx, dgamma, dbeta, ds, None, None


def bn_act_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 activation: str, eps: float = 1e-5):
    """Train-mode BatchNorm + activation with the analytic backward.
    Returns `(out, mean, var)`: out like x; mean and the biased var, (C,)
    float32 batch moments for the running statistics, not differentiable.

    x: (N, C, H, W) channels-last, float32 or bfloat16; gamma, beta: (C,)
    float32. Differentiable w.r.t. x, gamma and beta."""
    check_activation(activation)
    check_layout("x", x)
    check_vectors(x, gamma=gamma, beta=beta)
    return BNTrain.apply(x, gamma, beta, None, eps, Passes(
        lambda x, a, b, skip: bn_act(x, a, b, activation),
        lambda x, a, b, g, skip: bn_bwd_sums(x, a, b, g, activation),
        lambda x, a, b, g, k1, k2, skip: (
            bn_bwd_dx(x, a, b, g, k1, k2, activation), None)))
