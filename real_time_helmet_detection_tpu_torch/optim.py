"""Optimizer + learning-rate schedule for the PyTorch port.

Port of ref real_time_helmet_detection_tpu/optim.py:88 `make_lr_schedule`
and :101 `_base_optimizer` (reference optim.py:3-12: Adam + `MultiStepLR`
milestones [50, 90], gamma 0.1):

* the schedule is per optimizer update, as optax's
  `piecewise_constant_schedule` with boundaries `milestone *
  steps_per_epoch`: update number `count` (0-based) runs at
  lr * gamma^(number of boundaries <= count);
* `--optim` selects Adam, AdamW (weight decay 1e-4, optax's default, not
  torch's 1e-2) or SGD with momentum 0.9 (`torch.optim.SGD` computes
  optax's `sgd(momentum=0.9)` exactly);
* `Adam` computes optax's `scale_by_adam` (+ `add_decayed_weights` for
  AdamW) in its order, with the bias corrections 1 - b^count rounded to
  float32 as optax rounds them — `torch.optim.Adam` takes them in double,
  which moves the first updates by ~1e-5 relative.

Gradient accumulation (ref optim.py:112-190): the update applies the
SUM of the accumulated micro-gradients (`p.grad` accumulates across
backward calls and is zeroed only after an update: the reference's
accumulate-without-dividing, ref train.py:128-136, which JAX gets from
`optax.MultiSteps` over `scale(k)`); an epoch's trailing partial window
is flushed with the partial sum (ref optim.py:150 `make_accum_flush`);
the schedule and Adam's bias-correction count advance per update only,
so `make_lr_schedule` takes `updates_per_epoch`. The fp32-master wrapper
of `--param-policy bf16-compute` is not ported (config.py refuses it).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def updates_per_epoch(cfg, steps_per_epoch: int) -> int:
    """Optimizer updates in an epoch of `steps_per_epoch` host steps
    (ref optim.py:112 `_updates_per_epoch`): ceil(steps / sub_divisions),
    the epoch-end flush making the last one of a partial window."""
    return max(1, -(-steps_per_epoch // max(1, cfg.sub_divisions)))


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR as a function of the update count; `steps_per_epoch`
    counts updates (`updates_per_epoch`), as optax's count does."""
    boundaries = {int(m) * steps_per_epoch: cfg.lr_gamma
                  for m in cfg.lr_milestone if int(m) > 0}

    def lr_at(count: int) -> float:
        lr = float(cfg.lr)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                lr *= scale
        return lr

    return lr_at


class Adam(torch.optim.Optimizer):
    """optax `adam` / `adamw` arithmetic: mu = (1-b1) g + b1 mu,
    nu = (1-b2) g^2 + b2 nu, update = mu_hat / (sqrt(nu_hat) + eps)
    (+ weight_decay * p), p += -lr * update. Multi-tensor (`_foreach`)
    ops, one launch per step per operation."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            group["count"] += 1
            one, c = np.float32(1.0), np.float32(group["count"])
            bc1 = float(one - np.float32(b1) ** c)
            bc2 = float(one - np.float32(b2) ** c)
            update = torch._foreach_div(mus, bc1)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The `--optim` optimizer over `params` at the base learning rate;
    `set_lr` applies the schedule before each update."""
    name = cfg.optim.lower()
    if name == "adam":
        return Adam(params, lr=cfg.lr)
    if name == "adamw":
        return Adam(params, lr=cfg.lr, weight_decay=1e-4)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    raise NotImplementedError("Not expected optimizer: %s" % cfg.optim)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
