"""Residual-block tail: `act(y * eff_scale + eff_bias + skip)`, eval and
train.

Eval: the port of ref ops/pallas/residual.py:420 `fused_bn_add_act`
(its Pallas `_fwd_add_kernel`, residual.py:91, and the backward
`_bwd_add_kernel`, residual.py:97): the last conv's BatchNorm (running
statistics folded into a per-channel affine, ref
models/hourglass.py:437-440), the skip-add and the block's closing
activation in one pass. `bn_add_act_eval` is the differentiable form
(`ops.epilogue.BNEval` with the skip): its backward, one pass of the
skip variant of `csrc/bn_train.cu`'s eval kernel, writes dy = dz *
eff_scale, ds = dz and the channel partials of d(eff_scale) and
d(eff_bias).

Train: `bn_add_act_train`, the port of ref ops/pallas/residual.py:219
`_make_fused_add_train` — the epilogue's train family
(`ops.epilogue.BNTrain`) with the skip: moments of y alone, the tail
forward above with the batch-moment affine, and the analytic backward
through the add, whose skip gradient is ds = dz. Its backward passes are
the skip variants of the `csrc/bn_train.cu` kernels (ref residual.py:112
`_bwd_add_sums_kernel`, :121 `_bwd_add_dx_kernel`).

* `bn_add_act` (through the `helmet::bn_add_act` op, `ops.library`),
  `bn_add_eval_bwd`, `bn_add_bwd_sums` and `bn_add_bwd_dx` launch their
  CUDA kernels for CUDA tensors or raise, and run the plain versions for
  CPU tensors — no fallback between them.
* `bn_add_act_reference` is the plain PyTorch version of the tail,
  summed in the TPU kernel's order: ((y * a) + b) + skip.
* `launches`, `eval_bwd_launches`, `bwd_sums_launches`,
  `bwd_dx_launches` count kernel launches.

Layout is the epilogue's: channels-last NCHW tensors, read by the kernels
as (N*H*W, C) row-major blocks with no copy.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import marks
from .epilogue import (BNEval, BNTrain, EvalPasses,
                       Passes, _check_bwd, activate, bn_bwd_dx_reference,
                       bn_bwd_sums_reference, check_activation, check_cuda,
                       check_layout, check_vectors, eval_bwd_reference,
                       launch_bwd_dx, launch_bwd_sums, plain_device)

launches = 0
eval_bwd_launches = 0
bwd_sums_launches = 0
bwd_dx_launches = 0


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
    """Residual tail, the forward pass of eval and train, through the
    `helmet::bn_add_act` op (`ops.library`).

    y, skip: (N, C, H, W) channels-last, same shape, dtype (float32 or
    bfloat16) and device; eff_scale, eff_bias: (C,) float32."""
    check_activation(activation)
    check_layout("y", y)
    check_layout("skip", skip, like=y)
    check_vectors(y, eff_scale=eff_scale, eff_bias=eff_bias)
    if not plain_device(y):
        check_cuda("bn_add_act", y)
    return torch.ops.helmet.bn_add_act.default(y, eff_scale, eff_bias,
                                               skip, activation)


def bn_add_eval_bwd_reference(y, a, b, skip, g, activation):
    """Plain PyTorch version of `bn_add_eval_bwd`."""
    return eval_bwd_reference(y, a, b, g, activation, skip=skip)


@marks.kernel("bn_add_eval_bwd")
def bn_add_eval_bwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    skip: torch.Tensor, g: torch.Tensor, activation: str
                    ) -> Tuple[torch.Tensor, ...]:
    """The eval tail's backward in one pass (ref residual.py:97): dz = g *
    act'(y * a + b + skip) recomputed; returns (dy = dz * a in y's dtype,
    ds = dz in the skip's dtype, partials of d(eff_scale) = sum(dz * y),
    partials of d(eff_bias) = sum(dz)), the partials (nblocks, C)."""
    global eval_bwd_launches
    _check_bwd(y, a, b, g, activation, skip=skip)
    if plain_device(y):
        return bn_add_eval_bwd_reference(y, a, b, skip, g, activation)
    db, da, dy, ds, launched = launch_bwd_sums(y, a, b, g, activation,
                                               skip=skip, write_dx=True)
    eval_bwd_launches += launched
    return dy, ds, da, db


def bn_add_act_eval(y: torch.Tensor, eff_scale: torch.Tensor,
                    eff_bias: torch.Tensor, skip: torch.Tensor,
                    activation: str) -> torch.Tensor:
    """Eval-mode residual tail, differentiable w.r.t. y, eff_scale,
    eff_bias and skip: `bn_add_act` forward, `bn_add_eval_bwd`
    backward. With grad mode off the forward runs alone, as in
    `epilogue.bn_act_eval`."""
    check_activation(activation)
    check_layout("y", y)
    check_layout("skip", skip, like=y)
    check_vectors(y, eff_scale=eff_scale, eff_bias=eff_bias)
    if not torch.is_grad_enabled():
        return bn_add_act(y, eff_scale, eff_bias, skip, activation)
    return BNEval.apply(y, eff_scale, eff_bias, skip, EvalPasses(
        lambda y, a, b, skip: bn_add_act(y, a, b, skip, activation),
        lambda y, a, b, g, skip: bn_add_eval_bwd(y, a, b, skip, g,
                                                 activation)))


def bn_add_bwd_sums_reference(y, a, b, skip, g, activation):
    """Plain PyTorch version of `bn_add_bwd_sums`."""
    return bn_bwd_sums_reference(y, a, b, g, activation, skip=skip)


def bn_add_bwd_dx_reference(y, a, b, skip, g, k1, k2, activation):
    """Plain PyTorch version of `bn_add_bwd_dx`."""
    return bn_bwd_dx_reference(y, a, b, g, k1, k2, activation, skip=skip)


@marks.kernel("bn_add_bwd_sums")
def bn_add_bwd_sums(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    skip: torch.Tensor, g: torch.Tensor, activation: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partials of S1 = sum(dz) and S2 = sum(dz * y) per channel, with
    dz = g * act'(y * a + b + skip) (ref residual.py:112)."""
    global bwd_sums_launches
    _check_bwd(y, a, b, g, activation, skip=skip)
    if plain_device(y):
        return bn_add_bwd_sums_reference(y, a, b, skip, g, activation)
    s1, s2, _, _, launched = launch_bwd_sums(y, a, b, g, activation,
                                             skip=skip)
    bwd_sums_launches += launched
    return s1, s2


@marks.kernel("bn_add_bwd_dx")
def bn_add_bwd_dx(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  skip: torch.Tensor, g: torch.Tensor, k1: torch.Tensor,
                  k2: torch.Tensor, activation: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy = a*dz - k2*y - k1 in y's dtype, ds = dz in the skip's dtype)
    (ref residual.py:121)."""
    global bwd_dx_launches
    _check_bwd(y, a, b, g, activation, skip=skip, k1=k1, k2=k2)
    if plain_device(y):
        return bn_add_bwd_dx_reference(y, a, b, skip, g, k1, k2, activation)
    dy, ds, launched = launch_bwd_dx(y, a, b, g, k1, k2, activation,
                                     skip=skip)
    bwd_dx_launches += launched
    return dy, ds


def bn_add_act_train(y: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, skip: torch.Tensor,
                     activation: str, eps: float = 1e-5):
    """Train-mode residual tail: BatchNorm of y with batch moments, + skip,
    activation, with the analytic backward through the add. Returns
    `(out, mean, var)` as `ops.epilogue.bn_act_train` does.

    Differentiable w.r.t. y, gamma, beta and skip."""
    check_activation(activation)
    check_layout("y", y)
    check_layout("skip", skip, like=y)
    check_vectors(y, gamma=gamma, beta=beta)
    return BNTrain.apply(y, gamma, beta, skip, eps, Passes(
        lambda y, a, b, skip: bn_add_act(y, a, b, skip, activation),
        lambda y, a, b, g, skip: bn_add_bwd_sums(y, a, b, skip, g,
                                                 activation),
        lambda y, a, b, g, k1, k2, skip: bn_add_bwd_dx(
            y, a, b, skip, g, k1, k2, activation)))
