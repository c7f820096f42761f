"""Optimizer + learning-rate schedule for the PyTorch port.

Port of ref real_time_helmet_detection_tpu/optim.py:88 `make_lr_schedule`
and :101 `_base_optimizer` (reference optim.py:3-12: Adam + `MultiStepLR`
milestones [50, 90], gamma 0.1):

* the schedule is per optimizer update, as optax's
  `piecewise_constant_schedule` with boundaries `milestone *
  steps_per_epoch`: update number `count` (0-based) runs at
  lr * gamma^(number of boundaries <= count);
* `--optim` selects Adam, AdamW (weight decay 1e-4, optax's default, not
  torch's 1e-2) or SGD with momentum 0.9 (`SGD`: optax's
  `sgd(momentum=0.9)`, `torch.optim.SGD`'s arithmetic);
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
so `make_lr_schedule` takes `updates_per_epoch`.

`--param-policy bf16-compute` (ref optim.py:28-80 `MasterParams`,
`MasterOptimizer`, `with_fp32_master`): `MasterOptimizer` keeps an fp32
master of every (bf16) parameter and runs the `--optim` optimizer over
the masters; the gradients reach it summed in fp32 (`accumulate`, after
each micro-batch's backward, so `--grad-accum` sums in fp32 as JAX's
does, ref train.py:386-401), and each update re-emits `params :=
bf16(master)`.

`--sentinel` keeps the schedule's and Adam's counts on the device
(`device_counts`): `make_lr_schedule`'s function then takes the count
as a 0-d tensor and returns the LR as one, and Adam's bias corrections
are computed there too, so a skipped step can leave them as they were
without a host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

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

    def lr_at(count):
        if torch.is_tensor(count):  # on the device (optax's f32 rounding)
            lr = torch.full_like(count, float(cfg.lr), dtype=torch.float32)
            for threshold, scale in sorted(boundaries.items()):
                lr = torch.where(count >= threshold, lr * scale, lr)
            return lr
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
    ops, one launch per step per operation. The count is a host int, or
    a 0-d float32 device tensor (`device_counts`), and the LR a float or
    a 0-d tensor."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, count=0))

    def init_state(self) -> None:
        """The zero moments of every parameter, made now rather than at
        the first step."""
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
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
            c = group["count"]
            if torch.is_tensor(c):
                bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
                bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
            else:
                one, c = np.float32(1.0), np.float32(c)
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


class SGD(torch.optim.Optimizer):
    """optax `sgd(momentum=0.9)`: trace = g + m trace, p += -lr trace —
    `torch.optim.SGD`'s arithmetic (dampening 0), taking the LR as a
    float or a 0-d device tensor."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    def init_state(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            traces = [self.state[p]["trace"] for p in params]
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, [p.grad for p in params])
            lr = group["lr"]
            if torch.is_tensor(lr):
                torch._foreach_add_(params, torch._foreach_mul(traces, -lr))
            else:
                torch._foreach_add_(params, traces, alpha=-lr)


class MasterOptimizer:
    """`--param-policy bf16-compute`: `inner` (the `--optim` optimizer)
    over fp32 masters of `params` (bf16); `accumulate()` after each
    backward adds the parameters' gradients into the masters' in fp32,
    `step()` updates the masters and writes `bf16(master)` into the
    parameters (ref optim.py:28-80). `param_groups` are the inner
    optimizer's (`set_lr` reaches them); the state dict holds the
    masters, the inner state and the dtypes."""

    def __init__(self, params, build_inner):
        self.params = list(params)
        self.masters = [p.detach().float().clone() for p in self.params]
        self.inner = build_inner(self.masters)

    @property
    def param_groups(self):
        # the inner optimizer's live list: its load_state_dict replaces it
        return self.inner.param_groups

    def accumulate(self) -> None:
        with torch.no_grad():
            for p, m in zip(self.params, self.masters):
                if p.grad is None:
                    continue
                if m.grad is None:
                    m.grad = p.grad.float()
                else:
                    m.grad.add_(p.grad)
                p.grad = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in self.params + self.masters:
            t.grad = None

    def init_state(self) -> None:
        self.inner.init_state()

    @torch.no_grad()
    def step(self) -> None:
        self.accumulate()
        self.inner.step()
        torch._foreach_copy_(self.params, self.masters)

    def state_dict(self) -> Dict:
        return {"policy": "bf16-compute", "param_dtype": "bfloat16",
                "master_dtype": "float32",
                "master": [m.detach().clone() for m in self.masters],
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        if state.get("policy") != "bf16-compute":
            raise ValueError(
                "the checkpoint's optimizer state is not a bf16-compute "
                "master (policy %r): resume it with its own "
                "--param-policy" % (state.get("policy", "fp32"),))
        with torch.no_grad():
            for m, saved in zip(self.masters, state["master"]):
                m.copy_(saved)
            torch._foreach_copy_(self.params, self.masters)
        self.inner.load_state_dict(state["inner"])


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]):
    """The `--optim` optimizer over `params` at the base learning rate,
    inside a `MasterOptimizer` under `--param-policy bf16-compute`;
    `set_lr` applies the schedule before each update."""
    name = cfg.optim.lower()

    def inner(ps):
        if name == "adam":
            return Adam(ps, lr=cfg.lr)
        if name == "adamw":
            return Adam(ps, lr=cfg.lr, weight_decay=1e-4)
        if name == "sgd":
            return SGD(ps, lr=cfg.lr, momentum=0.9)
        raise NotImplementedError("Not expected optimizer: %s" % cfg.optim)

    if getattr(cfg, "param_policy", "fp32") == "bf16-compute":
        return MasterOptimizer(params, inner)
    return inner(params)


def device_counts(optimizer, device) -> None:
    """Move each param group's update count (Adam's) onto `device` as a
    0-d float32 tensor (`device` None: back to a host int)."""
    for group in optimizer.param_groups:
        if "count" not in group:
            continue
        c = group["count"]
        if device is None:
            group["count"] = int(c)
        else:
            group["count"] = torch.as_tensor(
                float(c), dtype=torch.float32).to(device)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
