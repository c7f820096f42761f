"""Training driver of the PyTorch port.

Port of the plain train path of the JAX package's train.py (ref
train.py:1698 `train`; reference train.py:23-162): `loss_fn` (:246), the
non-sentinel step body `make_train_step_body` (:442) with its optimizer
update (:308), the core loop of `train_epoch` (:1508) and `train`, on
one card:

    batch (host numpy, data/pipeline.py) -> pinned memory -> device
    -> model.train() forward through the BN kernels -> the fused
    detection loss (ops/loss.py, the loss kernels) -> backward (the
    kernels' analytic BN backward) -> Adam/AdamW/SGD at the scheduled
    LR -> checkpoint.

* Weights start from the port's seeded `init_weights` or from
  `--model-load` of an npz of the flax variable tree (the weight
  bridge); a port checkpoint (`checkpoint.pt`) resumes the run.
* The loss scalars of each step stay on the device and are fetched in
  one copy every `--print-interval` steps.
* Every `--ckpt-interval` epochs (and after the last) the run writes
  `<save_path>/check_point_<epoch+1>/` (the JAX package's naming):
  `checkpoint.pt` = {state_dict, optimizer, epoch, step, loss_log} and
  `weights.npz`, the flax-shaped tree the eval CLI loads (`--model-load
  .../weights.npz`), both written atomically. `step` counts optimizer
  updates.

The training runtime (ref train.py:642-1245, :1345-1697, :1698-2123):
the input path of `make_step_runner` (host batches; `--device-augment`'s
fused augment + encode on the card; `--cache-device`'s gather from the
dataset on the card; `--device-prefetch`'s staging ahead; `--prewarm`),
the checkpoint writer (`--async-ckpt`: a device snapshot written by a
thread; `--keep-ckpt` of this run's own), `--auto-resume` after a
transient failure (`--fault-inject` makes one), `--async-eval`,
`--telemetry` and the flight recorder (`--span-log`: JAX's span and
event names, `train.*` metrics, the SLO drift rules, `HangWatchdog`).

Gradient accumulation (ref train.py:359 `_make_accum_step_body`, :582
`make_state_accum_flush`; reference train.py:124-139): `--grad-accum k`
runs k micro-batches, rows [j B/k, (j+1) B/k), forward and backward in
one step, their gradients summed in `p.grad` (f32: the parameters stay
f32 under --amp), the running statistics updated k times in turn, then
one update; it reports the micro-batches' mean losses. `--sub-divisions
k` updates on every k-th host step and on an epoch's last, so a partial
window is flushed with its partial sum (the reference's `iteration ==
len(dataloader)`). Both feed the optimizer the sum, and they compose.

Data parallelism (ref train.py:1705-1731, :1778-1787): with
`--world-size N` each rank joins the process group on its own card
(`parallel.init_distributed`), builds the kernel libraries before the
first collective (`barrier_synced_build`), reads its shard of every
epoch in batches of `--batch-size / N`, and trains a
DistributedDataParallel wrapper of the model (`broadcast_buffers=False`:
the BN hooks keep the running statistics equal), whose gradient
all-reduce runs once per update (`no_sync` elsewhere). The BN passes and
the loss reduce over the global batch (`ops/epilogue.py`,
`ops/loss.py`), so a step computes what JAX's global-batch step does.
Only rank 0 prints and writes checkpoints; the losses it logs are the
global ones, one all-reduce per `--print-interval` flush.

The train-step extras (ref train.py:141-357, :582-615, :1249-1345):

* `--ema-decay d` (`EMA`): e := d e + (1 - d) p after every host step
  (ref `_optimizer_update`, train.py:308-328; under `--sub-divisions`
  also on the steps that take no update, and once more with the old
  parameters before an epoch-end flush of a partial window, as JAX's
  MultiSteps step and flush do), in the parameters' dtype; checkpoints
  carry it (`checkpoint.pt` "ema", and `ema.npz`, the tree
  `scripts/orbax_to_npz.py --ema` writes).
* `--sentinel` (`Sentinel`, ref `_sentinel_update` :331-357): the loss is
  scaled before backward by the monitor's scale and the gradients
  unscaled after; `bad = !finite(total) | !finite(|g|) | |g| > spike`
  (the same on every rank: one MAX all-reduce); on `bad` every state
  tensor — parameters, fp32 masters, optimizer moments and counts, BN
  running statistics, the EMA, the LR count — keeps its pre-step value
  (a device-side select, no host sync). The flag, |g| and the scale join
  the losses dict the flush fetches; `SentinelMonitor` (ref :1249) reads
  them there and backs the scale off, and `--sentinel-divergence`
  consecutive skips raise `TrainingDivergenceError`, on which `train`
  restores this run's last checkpoint (`--sentinel-rollbacks` times).
* `--distill CKPT` (`Distiller`, ref :141-243): the teacher (its
  architecture from the snapshot beside its checkpoint), in eval mode
  under `torch.no_grad()`, and its soft losses at `--distill-alpha`.
* `--param-policy bf16-compute` (`optim.MasterOptimizer`), `--remat`
  and `--fwd-dtype int8` (`models/hourglass.py`) change what the model
  and the optimizer compute; the step drives them as it drives the rest.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import (Config, load_config, resolve_model_load,
                     snapshot_beside, update_config_for_eval)
from .convert import load_into, load_npz, save_npz, state_dict_to_flax
from .data.augment import TestAugmentor
from .data.pipeline import (Batch, BatchLoader, DeviceDatasetCache,
                            DevicePrefetcher, StagedBatch, load_dataset)
from .evaluate import init_weights, weights_file
from .models.hourglass import build_model, cast_convs, cast_params
from .obs.metrics import default_registry
from .obs.telemetry import telemetry_scalars
from .ops.loss import (LossLog, _num_pos, fused_detection_loss,
                       normed_l1_loss, split_stack_predictions)
from .optim import (MasterOptimizer, build_optimizer, device_counts,
                    make_lr_schedule, set_lr, updates_per_epoch)
from .parallel import (all_reduce_sum_, barrier_synced_build,
                       init_distributed, local_batch_size, world_size)
from .runtime.errors import (InjectedBackendError, TrainingDivergenceError,
                             is_transient_backend_error)
from .runtime.heartbeat import HEARTBEAT_ENV, STATUS_ENV, HangWatchdog
from .utils import AverageMeter, atomic_write_bytes, save_json, timestamp

CHECKPOINT = "checkpoint.pt"
WEIGHTS = "weights.npz"
EMA_WEIGHTS = "ema.npz"
SENTINEL_KEYS = ("sentinel_bad", "sentinel_grad_norm", "sentinel_scale")


class Distiller:
    """The teacher of `--distill` (ref train.py:141 `Distiller`): its
    model in eval mode, run under `torch.no_grad()` (its BN sites take
    the eval kernels), and the soft losses of the student's output
    against its last stack."""

    def __init__(self, model: torch.nn.Module, alpha: float, num_cls: int,
                 normalized_coord: bool):
        self.model = model
        self.alpha = float(alpha)
        self.num_cls = int(num_cls)
        self.normalized = bool(normalized_coord)

    @torch.no_grad()
    def soft_targets(self, images):
        out = self.model(images)
        return split_stack_predictions(out[:, -1], self.num_cls,
                                       self.normalized)

    def soft_losses(self, student_out, images, mask, cfg
                    ) -> Dict[str, torch.Tensor]:
        """Per student stack against the teacher's last (ref
        train.py:181-209): the sigmoid-heat MSE summed over HWC, the
        batch mean over the global positive count; `normed_l1_loss` of
        offset and size."""
        t_heat, t_off, t_size = self.soft_targets(images)
        t_heat = t_heat.float()
        num_pos = _num_pos(mask.float())
        hm = off = size = 0.0
        for s in range(student_out.shape[1]):
            s_heat, s_off, s_size = split_stack_predictions(
                student_out[:, s], self.num_cls, self.normalized)
            d = torch.square(s_heat.float() - t_heat)
            hm = hm + d.sum(dim=(1, 2, 3)).mean() / num_pos
            off = off + normed_l1_loss(s_off, t_off, mask)
            size = size + normed_l1_loss(s_size, t_size, mask)
        total = (hm * cfg.hm_weight + off * cfg.offset_weight
                 + size * cfg.size_weight)
        return {"hm": hm, "offset": off, "size": size, "total": total}


def make_distiller(cfg: Config, device) -> Optional[Distiller]:
    """The `--distill` teacher, or None (ref train.py:211): its checkpoint
    resolved as `--model-load` is, its architecture from the snapshot
    beside it (the student's own without one), its weights in eval mode
    on `device`."""
    if not cfg.distill:
        return None
    path = resolve_model_load(cfg.distill)
    tcfg = cfg
    snap = snapshot_beside(path)
    if snap is not None:
        tcfg = update_config_for_eval(cfg, load_config(snap))
    else:
        print("%s: --distill %s has no argument.json; assuming the "
              "student's own architecture" % (timestamp(), path), flush=True)
    dtype = torch.bfloat16 if cfg.amp else None
    model = build_model(tcfg, dtype=dtype)
    load_into(model, load_npz(weights_file(path)))
    model = model.to(device).eval()
    if dtype is not None:
        cast_convs(model, dtype)
    for p in model.parameters():
        p.requires_grad_(False)
    print("%s: --distill teacher %s (variant=%s stacks=%d width=%d, "
          "alpha=%g)" % (timestamp(), path, tcfg.variant, tcfg.num_stack,
                         tcfg.hourglass_inch, cfg.distill_alpha), flush=True)
    return Distiller(model, cfg.distill_alpha, cfg.num_cls,
                     cfg.normalized_coord)


def loss_fn(model: torch.nn.Module, images, gt_heat, gt_off, gt_wh, mask,
            cfg: Config, distiller: Optional[Distiller] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + deep-supervision loss over all stacks (ref train.py:246),
    through the fused loss (the JAX package's TPU default, `--loss-kernel
    fused`). The model must be in train mode: its BatchNorms use batch
    moments and update their running statistics. With a `distiller`, its
    soft losses join the total at its alpha (`distill` in the dict); the
    teacher and the loss stay outside any recompute."""
    out = model(images)
    totals = fused_detection_loss(
        out, gt_heat, gt_off, gt_wh, mask,
        normalized_coord=cfg.normalized_coord, hm_weight=cfg.hm_weight,
        offset_weight=cfg.offset_weight, size_weight=cfg.size_weight,
        focal_alpha=cfg.focal_alpha, focal_beta=cfg.focal_beta)
    if distiller is not None:
        soft = distiller.soft_losses(out, images, mask, cfg)
        totals["distill"] = soft["total"]
        totals["total"] = totals["total"] + distiller.alpha * soft["total"]
    return totals["total"], totals


class EMA:
    """An exponential moving average of a model's parameters, in their
    dtype (ref train.py:308-328): `update()` computes e := d e + (1 - d) p
    as JAX's `d * e + (1.0 - d) * p`, each product rounded, then the
    sum."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = float(decay)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.tensors = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def update(self) -> None:
        d = self.decay
        torch._foreach_mul_(self.tensors, d)
        torch._foreach_add_(self.tensors,
                            torch._foreach_mul(self.params, 1.0 - d))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: t.detach().clone() for n, t in zip(self.names,
                                                     self.tensors)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for n, t in zip(self.names, self.tensors):
            t.copy_(state[n])

    def model_state(self, model: torch.nn.Module) -> Dict:
        """`model`'s state dict with the EMA in place of the parameters
        (the running statistics are the model's)."""
        state = dict(model.state_dict())
        state.update(zip(self.names, self.tensors))
        return state


class Sentinel:
    """The device half of `--sentinel`: `snapshot()` before a step,
    `verdict(total, grads, scale)` after its backward, `restore(bad)`
    after its update — every state tensor of the step keeps its
    pre-step value where `bad` (a 0-d bool tensor) holds, by a select on
    the device. `count` is the LR schedule's count of updates taken,
    a 0-d float32 device tensor."""

    def __init__(self, cfg: Config, model: torch.nn.Module, optimizer,
                 ema: Optional[EMA], device, count: int = 0):
        self.spike = float(cfg.sentinel_spike)
        self.count = torch.full((), float(count), dtype=torch.float32,
                                device=device)
        optimizer.init_state()  # the zero moments a skip must keep
        device_counts(optimizer, device)
        self.model, self.optimizer, self.ema = model, optimizer, ema

    def tensors(self) -> List[torch.Tensor]:
        opt = self.optimizer
        inner = opt.inner if isinstance(opt, MasterOptimizer) else opt
        ts = [p.data for p in self.model.parameters()]
        ts += list(self.model.buffers())
        for st in inner.state.values():
            ts += [t for t in st.values() if torch.is_tensor(t)]
        ts += [g["count"] for g in inner.param_groups
               if torch.is_tensor(g.get("count"))]
        if isinstance(opt, MasterOptimizer):
            ts += opt.masters
        if self.ema is not None:
            ts += self.ema.tensors
        return ts + [self.count]

    def snapshot(self) -> List[torch.Tensor]:
        return [t.detach().clone() for t in self.tensors()]

    def verdict(self, total: torch.Tensor, grads, scale: float):
        """(bad, |g|) of a step: the gradients unscaled in place first."""
        if scale != 1.0:
            torch._foreach_div_(grads, scale)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)).float())
        bad = ~torch.isfinite(total) | ~torch.isfinite(norm)
        if self.spike > 0:
            bad = bad | (norm > self.spike)
        if world_size() > 1:  # no rank may skip a step its peers take
            bad = all_reduce_sum_(bad.float()) > 0
        return bad, norm

    @torch.no_grad()
    def restore(self, bad: torch.Tensor, snapshot) -> None:
        for t, old in zip(self.tensors(), snapshot):
            torch.where(bad, old, t, out=t)


class SentinelMonitor:
    """The host half of `--sentinel` (ref train.py:1249): reads each
    flush window's fetched `sentinel_bad` flags, backs the loss scale off
    by `--sentinel-backoff` after a window with skips (floor 1/1024),
    doubles it back toward 1 after a clean one, and raises
    `TrainingDivergenceError` after `--sentinel-divergence` consecutive
    skips. Its decisions count on the metrics registry:
    `train.skipped_steps`, `train.rollbacks`, `train.loss_scale`."""

    MIN_SCALE = 1.0 / 1024.0

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.scale = 1.0
        self.skipped = 0
        self.consecutive_bad = 0
        self.rollbacks = 0
        reg = default_registry()
        self._m_skipped = reg.counter("train.skipped_steps")
        self._m_rollbacks = reg.counter("train.rollbacks")
        self._mg_scale = reg.gauge("train.loss_scale")

    def scale_value(self) -> float:
        return self.scale

    def observe(self, fetched) -> None:
        """One window of fetched (host) loss dicts."""
        window_bad = 0
        diverged = False
        for rec in fetched:
            if float(rec.get("sentinel_bad", 0.0)) > 0.5:
                window_bad += 1
                self.skipped += 1
                self.consecutive_bad += 1
                if self.consecutive_bad >= self.cfg.sentinel_divergence:
                    diverged = True
            else:
                self.consecutive_bad = 0
        if window_bad:
            self._m_skipped.inc(window_bad)
            self.scale = max(self.MIN_SCALE,
                             self.scale * self.cfg.sentinel_backoff)
        elif self.scale < 1.0:
            self.scale = min(1.0, self.scale * 2.0)
        self._mg_scale.set(self.scale)
        if diverged:
            raise TrainingDivergenceError(
                "sentinel: %d consecutive skipped steps (>= "
                "--sentinel-divergence %d) — sustained numeric divergence"
                % (self.consecutive_bad, self.cfg.sentinel_divergence))

    def note_rollback(self) -> None:
        """A rollback restored a checkpoint from before the blowup: the
        backoff resets with it."""
        self.rollbacks += 1
        self._m_rollbacks.inc()
        self.consecutive_bad = 0
        self.scale = 1.0
        self._mg_scale.set(self.scale)


def make_train_step(model: torch.nn.Module, optimizer,
                    schedule: Callable, cfg: Config,
                    net: Optional[torch.nn.Module] = None,
                    ema: Optional[EMA] = None,
                    sentinel: Optional[Sentinel] = None,
                    distiller: Optional[Distiller] = None,
                    loss_scale: Optional[Callable[[], float]] = None):
    """`step(count, images, heat, off, wh, mask, update=True) -> losses`:
    forward + backward of `--grad-accum` k
    micro-batches, their gradients summed into `p.grad` (zeroed first when
    the step opens an update window; under `--param-policy bf16-compute`
    into the fp32 masters, after each micro-batch); with `update`, one
    optimizer update at `schedule(count)`, which closes the window (ref
    train.py:359, :442, :308); an update that closes a window of fewer
    than `--sub-divisions` steps is an epoch-end flush. The forward goes
    through `net`
    (default `model`): a DistributedDataParallel wrapper all-reduces the
    gradients on the update's last micro-batch only (each micro-batch's
    under the bf16 policy, which sums them in fp32 after). `ema`,
    `sentinel` (with the monitor's `loss_scale`) and `distiller` add
    their parts; `--telemetry` adds the gradient, update and parameter
    norms (`obs.telemetry`, ref train.py:290; under `--sub-divisions` the
    gradient norm is the window's running sum). The losses dict holds
    detached device scalars, the micro-batches' mean."""
    net = model if net is None else net
    k = cfg.grad_accum
    master = isinstance(optimizer, MasterOptimizer)
    no_sync = None if master else getattr(net, "no_sync", None)
    window = [0]  # host steps whose gradients are in p.grad

    def step(count: int, images, gt_heat, gt_off, gt_wh, mask,
             update: bool = True):
        if not window[0]:
            optimizer.zero_grad(set_to_none=True)
        window[0] += 1
        scale = 1.0
        if sentinel is not None:
            scale = float(loss_scale()) if loss_scale else 1.0
            snapshot = sentinel.snapshot()
        arrays = (images, gt_heat, gt_off, gt_wh, mask)
        rows = images.shape[0] // k
        micro = []
        for j in range(k):
            part = arrays if k == 1 else tuple(
                a[j * rows:(j + 1) * rows] for a in arrays)
            syncs = no_sync is None or (update and j == k - 1)
            with contextlib.nullcontext() if syncs else no_sync():
                total, losses = loss_fn(net, *part, cfg, distiller)
                (total * scale if sentinel is not None else total).backward()
            if master:
                optimizer.accumulate()
            micro.append(losses)
        if k == 1:
            out = {n: v.detach() for n, v in micro[0].items()}
        else:
            out = {n: torch.stack([m[n].detach() for m in micro]).mean()
                   for n in micro[0]}
        grads = [m.grad for m in optimizer.masters] if master else \
            [p.grad for p in model.parameters() if p.grad is not None]
        if sentinel is not None:
            bad, norm = sentinel.verdict(out["total"], grads, scale)
            # the schedule counts the updates taken: a skip delays it
            count = sentinel.count
            out.update(sentinel_bad=bad.float(), sentinel_grad_norm=norm,
                       sentinel_scale=torch.full_like(norm, scale))
        if cfg.telemetry:
            old = [p.detach().clone() for p in model.parameters()]
        if update:
            if ema is not None and window[0] < cfg.sub_divisions:
                # an epoch-end update of a partial window: JAX's host step
                # (no update) and then its flush each move the EMA
                ema.update()
            set_lr(optimizer, schedule(count))
            optimizer.step()
            window[0] = 0
            if sentinel is not None:
                sentinel.count += 1
        if ema is not None:
            ema.update()
        if sentinel is not None:
            sentinel.restore(bad, snapshot)
        if cfg.telemetry:
            out.update(telemetry_scalars(grads, old,
                                         list(model.parameters())))
        return out

    return step


def stage(batch: Batch, device: torch.device):
    """The step's five input tensors on `device`; to a card they go
    through pinned host memory, asynchronously."""
    arrays = (batch.image, batch.heatmap, batch.offset, batch.wh, batch.mask)
    return _to_device(arrays, device)


def _to_device(arrays, device: torch.device):
    """numpy arrays (the process loader's are read-only views of shared
    memory) as tensors on `device`: to a card through a pinned copy,
    asynchronously; on the CPU without a copy unless read-only."""
    out = []
    for a in map(np.asarray, arrays):
        if device.type != "cuda":
            out.append(torch.from_numpy(a if a.flags.writeable else a.copy()))
            continue
        host = torch.empty(a.shape, dtype=torch.from_numpy(
            np.empty(0, a.dtype)).dtype, pin_memory=True)
        np.copyto(host.numpy(), a)
        out.append(host.to(device, non_blocking=True))
    return tuple(out)


def stage_raw(batch: Batch, device: torch.device):
    """The fused step's four input tensors on `device`: the uint8
    canvases and the padded boxes, labels and validity."""
    return _to_device((batch.image, batch.boxes, batch.labels, batch.valid),
                      device)


def multiscale_sizes(cfg: Config) -> List[int]:
    """The bucket grid of `--multiscale-flag` (max excluded), else the
    max (ref train.py:1118)."""
    if cfg.multiscale_flag:
        return list(range(cfg.multiscale[0], cfg.multiscale[1],
                          cfg.multiscale[2]))
    return [cfg.multiscale[1]]


def pick_target(cfg: Config, step_idx: int) -> int:
    """The fused step's bucket at a global step (ref train.py:1130): numpy
    on (seed, step), so both packages pick the same sequence and a
    resumed run the same buckets."""
    return int(np.random.default_rng(
        (cfg.random_seed, step_idx)).choice(multiscale_sizes(cfg)))


def make_step_runner(cfg: Config, step, device: torch.device, cache=None):
    """`runner(batch, step_idx, count, update) -> losses` for the
    configured input path (ref train.py:1073 `make_step_runner`):

    * host path: the batch's five arrays staged (`stage`) and `step`;
    * `--device-augment`: the raw batch staged (`stage_raw`), then on the
      card `augment_device.augment_encode_batch` at `pick_target(step)`
      with `sample_params` from `step_generator(seed + 2, step)` (the
      global batch's draw; this rank's rows), normalized, then `step`;
    * `--cache-device`: `batch` is a (B,) index vector; the batch is
      gathered from the `DeviceDatasetCache` on the card, then as above.

    `runner.stage(batch)` is the staging alone (None on the cached path,
    whose only copy is B int32 indices), the `--device-prefetch` hook: a
    `StagedBatch` passes its staged arrays straight to the step.
    `runner.prewarm(trainer)` runs each bucket once (`prewarm`; None on
    the host path)."""
    if not cfg.device_augment:
        def run_host(batch, step_idx, count, update):
            arrays = (batch.arrays if isinstance(batch, StagedBatch)
                      else stage(batch, device))
            return step(count, *arrays, update=update)

        run_host.stage = lambda batch: stage(batch, device)
        run_host.prewarm = None
        return run_host

    from .data.augment_device import (augment_encode_batch,
                                      normalize_device, normalizer, rows_of,
                                      sample_params, step_generator)
    mean, std = normalizer(cfg.pretrained, device)
    local = local_batch_size(cfg)
    lo = cfg.rank * local

    def fused(images, boxes, labels, valid, step_idx, count, update,
              target=None):
        target = pick_target(cfg, step_idx) if target is None else target
        params = rows_of(sample_params(
            step_generator(cfg.random_seed + 2, step_idx), cfg.batch_size,
            crop_percent=tuple(cfg.crop_percent),
            color_multiply=tuple(cfg.color_multiply),
            translate_percent=cfg.translate_percent,
            affine_scale=tuple(cfg.affine_scale)), lo, lo + local)
        with torch.no_grad():
            img, heat, off, wh, mask, _, _ = augment_encode_batch(
                params, images, boxes, labels, valid, target=target,
                scale_factor=cfg.scale_factor, num_cls=cfg.num_cls,
                normalized=cfg.normalized_coord)
            img = normalize_device(img, mean, std)
        return step(count, img, heat, off, wh, mask, update=update)

    if cache is not None:
        def gather(idx_batch):
            idx = _to_device((np.asarray(idx_batch, np.int64),), device)[0]
            return tuple(t.index_select(0, idx) for t in (
                cache.images, cache.boxes, cache.labels, cache.valid))

        def run_cached(idx_batch, step_idx, count, update):
            return fused(*gather(idx_batch), step_idx, count, update)

        run_cached.stage = None
        run_cached.prewarm = lambda trainer: prewarm(
            cfg, trainer, lambda target: fused(
                *gather(np.zeros((local,), np.int64)), 0, 0, True,
                target=target))
        return run_cached

    def run_fused(batch, step_idx, count, update):
        arrays = (batch.arrays if isinstance(batch, StagedBatch)
                  else stage_raw(batch, device))
        return fused(*arrays, step_idx, count, update)

    canvas = cfg.multiscale[1]
    dummy = Batch(np.zeros((local, canvas, canvas, 3), np.uint8),
                  *([np.zeros((local, 0, 0, 0), np.float32)] * 4), infos=[],
                  boxes=np.zeros((local, cfg.max_boxes, 4), np.float32),
                  labels=np.zeros((local, cfg.max_boxes), np.int32),
                  valid=np.zeros((local, cfg.max_boxes), bool))
    run_fused.stage = lambda batch: stage_raw(batch, device)
    run_fused.prewarm = lambda trainer: prewarm(
        cfg, trainer, lambda target: fused(
            *stage_raw(dummy, device), 0, 0, True, target=target))
    return run_fused


def _clone_tree(obj):
    """A copy of a nested dict/list of tensors, every tensor cloned on its
    device (ordered on the current stream)."""
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone_tree(v) for v in obj)
    return obj


def _tree_to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _tree_to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_cpu(v) for v in obj)
    return obj


class Trainer:
    """The mutable train state of a run, as the runtime restores it: the
    model, its optimizer, the EMA, the sentinel (with its LR count), the
    loss log and the update count."""

    def __init__(self, model, optimizer, ema, sentinel, loss_log, count,
                 device):
        self.model, self.optimizer, self.ema = model, optimizer, ema
        self.sentinel, self.loss_log, self.count = sentinel, loss_log, count
        self.device = device

    def snapshot(self) -> Dict:
        """Every state tensor, cloned on its device (`restore_snapshot`)."""
        return {"model": _clone_tree(self.model.state_dict()),
                "optimizer": copy.deepcopy(self.optimizer.state_dict()),
                "ema": None if self.ema is None else self.ema.state_dict(),
                "sentinel": None if self.sentinel is None
                else self.sentinel.count.clone(),
                "loss_log": self.loss_log.state_dict(), "count": self.count}

    def restore_snapshot(self, snap: Dict) -> None:
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema is not None:
            self.ema.load_state_dict(snap["ema"])
        if self.sentinel is not None:
            device_counts(self.optimizer, None)
            device_counts(self.optimizer, self.device)
            self.sentinel.count.copy_(snap["sentinel"])
        self.loss_log = LossLog(snap["loss_log"])
        self.count = snap["count"]

    def restore_checkpoint(self, path: str) -> int:
        """Restore `path` (ref train.py:942); returns its epoch."""
        ckpt = load_checkpoint(path)
        restore(ckpt, self.model, self.optimizer, self.ema)
        self.optimizer.zero_grad(set_to_none=True)
        self.loss_log = LossLog(ckpt["loss_log"])
        self.count = int(ckpt["step"])
        if self.sentinel is not None:
            device_counts(self.optimizer, self.device)
            self.sentinel.count.fill_(self.count)
        return int(ckpt["epoch"])


def prewarm(cfg: Config, trainer: Trainer, call_bucket) -> Dict[int, float]:
    """`--prewarm` (ref train.py:1141): each multiscale bucket's fused
    step once on zero inputs before the first epoch, so that its first
    real step finds cuDNN's algorithm choice and the caching allocator's
    blocks made. The buckets chain one sacrificial state: every state
    tensor is cloned first and written back after, so the run's state is
    bit-identical. Returns {bucket: wall seconds}."""
    saved = trainer.snapshot()
    walls = {}
    try:
        for target in multiscale_sizes(cfg):
            t0 = time.perf_counter()
            losses = call_bucket(target)
            float(losses["total"])  # the step has run
            walls[target] = time.perf_counter() - t0
            if cfg.rank == 0:
                print("%s: prewarmed bucket %d (%.2fs)"
                      % (timestamp(), target, walls[target]), flush=True)
    finally:
        trainer.restore_snapshot(saved)
    return walls


class FaultInjector:
    """`--fault-inject EPOCH:ITER` (ref train.py:1223): raise one
    synthetic transient backend error there, so that `--auto-resume` can
    be exercised without a real outage."""

    def __init__(self, spec: str = ""):
        if spec:
            parts = spec.split(":")
            if len(parts) != 2:
                raise ValueError(
                    "--fault-inject wants 'EPOCH:ITER', got %r" % spec)
            self.target = (int(parts[0]), int(parts[1]))
        else:
            self.target = None
        self.fired = False

    def maybe_fire(self, epoch: int, i: int) -> None:
        if self.target is not None and not self.fired \
                and (epoch, i) == self.target:
            self.fired = True
            raise InjectedBackendError(
                "injected backend fault at epoch %d iter %d (UNAVAILABLE)"
                % (epoch, i))


def _poison_batch(batch):
    """A chaos `nan-batch` (ref train.py:1495): the first float field of a
    host batch set to NaN, so the forward (and the sentinel) sees it; a
    raw uint8 batch has nothing to poison on the host."""
    for name in ("image", "heatmap", "boxes"):
        arr = getattr(batch, name, None)
        if isinstance(arr, np.ndarray) and arr.dtype.kind == "f":
            return dataclasses.replace(
                batch, **{name: np.full_like(arr, np.nan)})
    return batch


def train_epoch(cfg: Config, epoch: int, loader, step,
                device: torch.device, loss_log: LossLog,
                count: int, chief: bool = True,
                monitor: Optional[SentinelMonitor] = None, *,
                runner=None, epoch_base_step: int = 0, tracer=None,
                injector: Optional[FaultInjector] = None, chaos=None,
                watchdog=None, mwriter=None, slo=None) -> int:
    """One epoch of the hot loop (ref train.py:1508); returns the update
    count after it. Under `--sub-divisions k` a step updates on every
    k-th batch and on the epoch's last. `runner` (default: the host
    path's over `step`) runs a batch; `--device-prefetch N` stages N
    batches ahead through `runner.stage`. `monitor` reads each flush
    window's sentinel flags (and may raise TrainingDivergenceError).

    The flight recorder (ref train.py:1536-1697): with an enabled
    `tracer`, each step writes `loader-wait` and `step` spans under its
    step's trace context, the prefetcher's staging `h2d` spans, each
    flush a `fetch` span; `train.step_ms`, `train.loader_wait_ms`,
    `train.fetch_ms` and `train.steps` always count, and `slo` watches
    the step time and the loss. `injector` and `chaos` (the `train:rank`
    and `train:batch` sites) fire at the top of an iteration; `watchdog`
    beats at each flush."""
    from .obs.spans import SpanTracer
    from .obs.trace import step_context
    tracer = tracer if tracer is not None else SpanTracer(None)
    runner = runner if runner is not None else make_step_runner(
        cfg, step, device)
    reg = default_registry()
    mh_step = reg.histogram("train.step_ms")
    mh_wait = reg.histogram("train.loader_wait_ms")
    mh_fetch = reg.histogram("train.fetch_ms")
    mc_steps = reg.counter("train.steps")
    loader.set_epoch(epoch)
    meters = {k: AverageMeter() for k in ("data", "step")}
    pending = []
    n, k = len(loader), cfg.sub_divisions

    def flush_losses():
        # one device -> host copy (and, across ranks, one all-reduce) for
        # the whole interval; the sentinel's and telemetry's scalars ride
        # along
        if not pending:
            return
        with tracer.span("fetch", steps=len(pending)) as sp:
            keys = LossLog.KEYS + tuple(sorted(
                set(pending[0]) - set(LossLog.KEYS)))
            rows = torch.stack([torch.stack([p[key].float() for key in keys])
                                for p in pending])
            if world_size() > 1:
                rows = all_reduce_sum_(rows) / world_size()
            fetched = [dict(zip(keys, row)) for row in rows.cpu().tolist()]
        mh_fetch.observe(sp.dur_s * 1e3)
        for rec in fetched:
            loss_log.append(rec)
            if slo is not None:
                slo.observe("train.loss", float(rec.get("total", 0.0)))
        pending.clear()
        if mwriter is not None:
            mwriter.maybe_flush()
        if monitor is not None:
            monitor.observe(fetched)

    iterator = loader
    if cfg.device_prefetch > 0 and runner.stage is not None:
        iterator = DevicePrefetcher(loader, tracer.wrap("h2d", runner.stage),
                                    depth=cfg.device_prefetch, device=device)
    tic = time.time()
    for i, batch in enumerate(iterator):
        if injector is not None:
            injector.maybe_fire(epoch, i)
        if chaos is not None:
            ev = chaos.fire("train:rank", epoch=epoch, it=i)
            if ev is not None and ev.kind == "worker-death":
                # a lost rank: the transient signature, not a hang at the
                # next collective
                raise InjectedBackendError(
                    "UNAVAILABLE: injected worker death at epoch %d iter "
                    "%d — a training rank is gone; restart the whole "
                    "multi-process job" % (epoch, i))
            ev = chaos.fire("train:batch", epoch=epoch, it=i)
            if ev is not None and ev.kind == "nan-batch" \
                    and isinstance(batch, Batch):
                batch = _poison_batch(batch)
        data_t = time.time() - tic
        meters["data"].update(data_t)
        mh_wait.observe(data_t * 1e3)
        sctx = None
        if tracer.enabled:
            sctx = step_context(epoch_base_step + i, epoch=epoch,
                                rank=cfg.rank)
            tracer.record("loader-wait", data_t, ctx=sctx.child(),
                          epoch=epoch, it=i)
        update = (i + 1) % k == 0 or i == n - 1
        pending.append(runner(batch, epoch_base_step + i, count, update))
        count += update
        if i % cfg.print_interval == 0:
            flush_losses()
            if watchdog is not None:
                watchdog.beat("epoch %d iter %d (flushed)" % (epoch, i))
        step_t = time.time() - tic - data_t
        meters["step"].update(step_t)
        mh_step.observe(step_t * 1e3)
        mc_steps.inc()
        if slo is not None:
            slo.observe("train.step_ms", step_t * 1e3)
        if tracer.enabled:
            tracer.record("step", step_t, ctx=sctx.child(), epoch=epoch,
                          it=i)
        if i % cfg.print_interval == 0 and chief:
            print("%s: epoch %d iter %d/%d, %s | data %.3fs step %.3fs"
                  % (timestamp(), epoch, i, n,
                     loss_log.get_log(length=cfg.print_interval),
                     meters["data"].avg, meters["step"].avg), flush=True)
        tic = time.time()
    flush_losses()
    return count


def checkpoint_dir(save_path: str, epoch: int) -> str:
    """The on-disk naming contract (ref train.py:764)."""
    return os.path.abspath(os.path.join(save_path,
                                        "check_point_%d" % (epoch + 1)))


def checkpoint_payload(epoch: int, count: int, model: torch.nn.Module,
                       optimizer, loss_log: LossLog,
                       ema: Optional[EMA] = None) -> Dict:
    """What a checkpoint holds, as live references: `checkpoint.pt`'s
    dict and the EMA's model state (`ema_model`)."""
    opt_state = optimizer.state_dict()
    return {"ckpt": {"state_dict": model.state_dict(),
                     "optimizer": opt_state,
                     "ema": None if ema is None else ema.state_dict(),
                     "param_policy": opt_state.get("policy", "fp32"),
                     "epoch": epoch, "step": count,
                     "loss_log": loss_log.state_dict()},
            "ema_model": None if ema is None else ema.model_state(model)}


def write_checkpoint(path: str, payload: Dict) -> str:
    """`checkpoint.pt`, with the EMA `ema.npz`, then `weights.npz` (the
    file whose presence makes the checkpoint complete), each atomic."""
    os.makedirs(path, exist_ok=True)
    buf = io.BytesIO()
    torch.save(payload["ckpt"], buf)
    atomic_write_bytes(os.path.join(path, CHECKPOINT), buf.getvalue())
    if payload["ema_model"] is not None:
        save_npz(os.path.join(path, EMA_WEIGHTS),
                 state_dict_to_flax(payload["ema_model"]))
    save_npz(os.path.join(path, WEIGHTS),
             state_dict_to_flax(payload["ckpt"]["state_dict"]))
    return path


def save_checkpoint(save_path: str, epoch: int, count: int,
                    model: torch.nn.Module, optimizer,
                    loss_log: LossLog, ema: Optional[EMA] = None) -> str:
    """Write the epoch's checkpoint dir: `checkpoint.pt` = {state_dict,
    optimizer (under the bf16 policy the fp32 masters and the dtypes),
    ema, param_policy, epoch, step, loss_log}, `ema.npz` with the EMA,
    `weights.npz`."""
    return write_checkpoint(checkpoint_dir(save_path, epoch),
                            checkpoint_payload(epoch, count, model,
                                               optimizer, loss_log, ema))


class CheckpointWriter:
    """Checkpoints, synchronous or `--async-ckpt` (ref train.py:802).

    Async: `save()` waits for the previous save (at most one in flight;
    its error raises here), clones every state tensor on its device on
    the current stream — ordered before the next step's in-place
    updates, so the snapshot is the state at the boundary — records an
    event, and returns; a writer thread waits on the event, copies the
    snapshot to the host on a stream of its own and writes the files as
    a sync save does (`write_checkpoint`: weights.npz last, so
    `checkpoint_complete` never picks a half-written save). `finalize()`
    waits for the last save. The snapshot doubles the state's device
    memory until its copy-out. `_mu` guards the writer's error."""

    def __init__(self, async_save: bool = False):
        self.async_save = async_save
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._mu:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed: %s" % err) \
                from err

    def _write(self, path: str, snap: Dict, event) -> None:
        try:
            if event is not None:
                side = torch.cuda.Stream(event.device)
                with torch.cuda.stream(side):
                    side.wait_event(event)
                    snap = _tree_to_cpu(snap)
            write_checkpoint(path, snap)
        except BaseException as e:  # noqa: BLE001 — raised at the next wait
            with self._mu:
                self._error = e

    def save(self, save_path: str, epoch: int, count: int, model, optimizer,
             loss_log: LossLog, ema: Optional[EMA] = None) -> str:
        if not self.async_save:
            return save_checkpoint(save_path, epoch, count, model,
                                   optimizer, loss_log, ema)
        self._wait()
        path = checkpoint_dir(save_path, epoch)
        snap = _clone_tree(checkpoint_payload(epoch, count, model,
                                              optimizer, loss_log, ema))
        event = None
        if next(model.parameters()).is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(target=self._write,
                                        args=(path, snap, event),
                                        daemon=True)
        self._thread.start()
        return path

    def finalize(self) -> None:
        self._wait()


def apply_retention(cfg: Config, run_ckpts: List[str]) -> None:
    """`--keep-ckpt N` (ref train.py:1960-1990): keep this run's newest N
    checkpoints (one more under `--async-ckpt`: the newest save may still
    be in flight); only this run's own are ever removed."""
    n_keep = cfg.keep_ckpt + (1 if cfg.async_ckpt else 0)
    if cfg.keep_ckpt <= 0 or len(run_ckpts) <= n_keep:
        return
    for old in run_ckpts[:-n_keep]:
        try:
            shutil.rmtree(old)
            print("%s: retention: removed %s" % (timestamp(), old),
                  flush=True)
        except OSError as e:
            print("%s: retention: could not remove %s: %s"
                  % (timestamp(), old, e), flush=True)
    del run_ckpts[:-n_keep]


def load_checkpoint(path: str) -> Dict:
    """A `checkpoint.pt` (or the dir holding one), on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(ckpt: Dict, model: torch.nn.Module, optimizer,
            ema: Optional[EMA]) -> None:
    """Model, optimizer and EMA from a `load_checkpoint` dict; across an
    EMA mismatch as JAX resumes (ref train.py:942-1014): a run with
    `--ema-decay` seeds the EMA from the restored parameters when the
    checkpoint has none, a run without drops the checkpoint's."""
    model.load_state_dict(ckpt["state_dict"])
    optimizer.load_state_dict(ckpt["optimizer"])
    device_counts(optimizer, None)  # a sentinel run's counts: host ints
    disk = ckpt.get("ema")
    if ema is not None:
        if disk is None:
            print("%s: checkpoint has no EMA stream; seeding EMA from the "
                  "restored params" % timestamp(), flush=True)
            disk = {n: p.detach() for n, p in model.named_parameters()}
        ema.load_state_dict(disk)
    elif disk is not None:
        print("%s: checkpoint has an EMA stream but --ema-decay is off; "
              "dropping it" % timestamp(), flush=True)


def init_train_state(cfg: Config, model: torch.nn.Module, device
                     ) -> Tuple[object, Optional[EMA]]:
    """(optimizer, EMA or None) of `model`, moved to `device` in train
    mode: under `--param-policy bf16-compute` the masters copy the
    float32 weights, then the parameters become bf16 (ref train.py:103
    `create_train_state`); the EMA starts as a copy of the parameters in
    their dtype."""
    model.to(device).train()
    optimizer = build_optimizer(cfg, model.parameters())
    if cfg.param_policy == "bf16-compute":
        cast_params(model, torch.bfloat16)
    ema = EMA(model, cfg.ema_decay) if cfg.ema_decay > 0 else None
    return optimizer, ema


# The --async-eval subprocess: the port's own evaluate on the training
# run's device, from a spec file holding the eval Config; it imports
# only the port
ASYNC_EVAL_SRC = (
    "import json, os, sys\n"
    "sys.path.insert(0, sys.argv[2])\n"
    "from real_time_helmet_detection_tpu_torch.config import Config\n"
    "from real_time_helmet_detection_tpu_torch.evaluate import evaluate\n"
    "from real_time_helmet_detection_tpu_torch.utils import save_json\n"
    "with open(sys.argv[1]) as f:\n"
    "    spec = json.load(f)\n"
    "cfg = Config(**spec['config'])\n"
    "m = evaluate(cfg)\n"
    "save_json(os.path.join(cfg.save_path, 'scores.json'),\n"
    "          {'epoch': spec['epoch'], 'checkpoint': spec['checkpoint'],\n"
    "           'map': float(m['map']),\n"
    "           'ap': {str(k): float(v) for k, v in m['ap'].items()}})\n"
)


class AsyncEvaluator:
    """`--async-eval` (ref train.py:1370): at each checkpoint boundary the
    chief starts ONE background subprocess that evaluates the checkpoint
    just written (`ASYNC_EVAL_SRC`); a boundary that finds one still
    running is skipped and counted, never queued. Results land in
    `save_path/eval_async/e<N>/scores.json` (and `eval.log`), reaped at
    the next boundary and awaited, bounded, at the end of training.

    Departure from JAX: its subprocess runs on the CPU because a TPU
    admits one process per chip; a CUDA card admits a second context, so
    this one runs the port's `evaluate` on the training run's device
    (`--device cpu` for a CPU run). The subprocess's environment drops
    the supervisor's heartbeat and status paths (`HEARTBEAT_ENV`,
    `STATUS_ENV`): the eval must not beat for the trainer. `_mu` guards
    the in-flight state."""

    FINALIZE_TIMEOUT_S = 900.0

    def __init__(self, cfg: Config, tracer=None):
        self.cfg = cfg
        self._tracer = tracer
        self._mu = threading.Lock()
        self._proc = None
        self._current = None        # (epoch, outdir)
        self._log_f = None
        self.completed: List[Dict] = []   # [{"epoch", "ok", "map"}]
        self.skipped = 0

    def eval_config(self, ckpt_path: str, outdir: str) -> Dict:
        d = dataclasses.asdict(self.cfg)
        d.update(train_flag=False, export_flag=False, model_load=ckpt_path,
                 save_path=outdir, world_size=1, rank=0, num_devices=0,
                 device_prefetch=0, loader="thread", device_augment=False,
                 cache_device=False, async_eval=False, async_ckpt=False,
                 auto_resume=0, sentinel=False, grad_accum=1, span_log="",
                 fault_inject="", prewarm=False,
                 imsize=self.cfg.imsize or self.cfg.multiscale[1],
                 num_workers=min(2, max(1, self.cfg.num_workers)))
        return d

    def submit(self, epoch: int, ckpt_path: str) -> bool:
        """Start an eval of `ckpt_path`; False (and counted) when one is
        still running. Never waits on eval work."""
        self.poll()
        with self._mu:
            busy = self._proc is not None
            if busy:
                self.skipped += 1
                running, skipped = self._current[0], self.skipped
        if busy:
            print("%s: --async-eval: epoch %d eval still running; skipping "
                  "the epoch %d boundary (%d skipped so far)"
                  % (timestamp(), running, epoch, skipped), flush=True)
            return False
        outdir = os.path.join(self.cfg.save_path, "eval_async",
                              "e%d" % epoch)
        os.makedirs(outdir, exist_ok=True)
        spec_path = os.path.join(outdir, "spec.json")
        save_json(spec_path, {"epoch": epoch, "checkpoint": ckpt_path,
                              "config": self.eval_config(ckpt_path,
                                                         outdir)})
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items()
               if k not in (HEARTBEAT_ENV, STATUS_ENV)}
        log_f = open(os.path.join(outdir, "eval.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-c", ASYNC_EVAL_SRC, spec_path, repo],
            stdout=log_f, stderr=subprocess.STDOUT, env=env)
        with self._mu:
            self._proc, self._log_f = proc, log_f
            self._current = (epoch, outdir)
        if self._tracer is not None:
            self._tracer.event("eval-async:submit", epoch=epoch,
                               checkpoint=ckpt_path)
        print("%s: --async-eval: epoch %d eval -> %s (pid %d)"
              % (timestamp(), epoch, outdir, proc.pid), flush=True)
        return True

    def running(self) -> bool:
        with self._mu:
            return self._proc is not None and self._proc.poll() is None

    def poll(self) -> None:
        """Reap a finished eval (non-blocking) and report its score."""
        with self._mu:
            if self._proc is None or self._proc.poll() is None:
                return
            proc, (epoch, outdir) = self._proc, self._current
            log_f, self._log_f = self._log_f, None
            self._proc = self._current = None
        if log_f is not None:
            log_f.close()
        rc = proc.returncode
        scores_path = os.path.join(outdir, "scores.json")
        rec = {"epoch": epoch, "ok": False, "map": None}
        if rc == 0 and os.path.exists(scores_path):
            with open(scores_path) as f:
                rec.update(ok=True, map=json.load(f).get("map"))
        with self._mu:
            self.completed.append(rec)
        if self._tracer is not None:
            self._tracer.event("eval-async:done", epoch=epoch,
                               ok=rec["ok"], map=rec["map"])
        print("%s: --async-eval: epoch %d eval %s (see %s)"
              % (timestamp(), epoch,
                 "done, mAP %s" % rec["map"] if rec["ok"]
                 else "FAILED (rc %s) — training unaffected" % rc, outdir),
              flush=True)

    def finalize(self) -> None:
        """Wait (bounded) for the eval in flight at the end of training."""
        with self._mu:
            proc = self._proc
        if proc is not None:
            try:
                proc.wait(timeout=self.FINALIZE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                print("%s: --async-eval: final eval still running after "
                      "%.0fs; killing" % (timestamp(),
                                          self.FINALIZE_TIMEOUT_S),
                      flush=True)
                proc.kill()
                proc.wait()
        self.poll()


def probe_device(device: torch.device) -> None:
    """A tiny op and its read back (ref train.py:2031): raises when the
    card is gone or its context poisoned."""
    float((torch.zeros((), device=device) + 1.0).item())


def make_loader(cfg: Config, dataset, augmentor, device: torch.device):
    """The run's input: a `DeviceDatasetCache` under `--cache-device`,
    else a thread or process loader of host batches (raw under
    `--device-augment`)."""
    if cfg.cache_device:
        return DeviceDatasetCache(
            dataset, augmentor, batch_size=cfg.batch_size,
            max_boxes=cfg.max_boxes, shuffle=True, drop_last=True,
            seed=cfg.random_seed, num_workers=cfg.num_workers,
            device=device)
    kw = dict(batch_size=local_batch_size(cfg), pretrained=cfg.pretrained,
              num_cls=cfg.num_cls, normalized_coord=cfg.normalized_coord,
              scale_factor=cfg.scale_factor, max_boxes=cfg.max_boxes,
              shuffle=True, drop_last=True, rank=cfg.rank,
              world_size=cfg.world_size, seed=cfg.random_seed,
              num_workers=cfg.num_workers, raw=cfg.device_augment)
    if cfg.loader == "process":
        from .data.shm_pool import ProcessBatchLoader
        return ProcessBatchLoader(dataset, augmentor,
                                  quarantine=cfg.sentinel, **kw)
    return BatchLoader(dataset, augmentor, **kw)


def train(cfg: Config, chaos=None) -> Dict:
    """Full training run (ref train.py:1698), on every rank of a
    `--world-size` run. Returns {"model", "optimizer", "loss_log",
    "step", "ema", "monitor", "loader", "evaluator", "prewarm"} after the
    last epoch. `chaos` (a `runtime.faults.ChaosInjector`, tests) fires
    the `train:rank` and `train:batch` sites."""
    dev = init_distributed(cfg)
    chief = cfg.rank == 0
    if dev.type == "cuda":
        # fp32 means fp32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if cfg.world_size > 1:
        barrier_synced_build(dev)
    injector = FaultInjector(cfg.fault_inject)
    dataset, augmentor = load_dataset(cfg)
    if cfg.device_augment:
        # the host decodes and resizes to the canvas; the random
        # augmentation and the encode run on the card
        augmentor = TestAugmentor(imsize=cfg.multiscale[1])
    loader = make_loader(cfg, dataset, augmentor, dev)
    steps_per_epoch = max(1, len(loader))
    model = build_model(cfg, dtype=torch.bfloat16 if cfg.amp else None)
    init_weights(model, cfg.random_seed)
    resume = None
    if cfg.model_load and cfg.model_load.endswith(".npz"):
        load_into(model, load_npz(cfg.model_load))
    elif cfg.model_load:
        resume = load_checkpoint(resolve_model_load(cfg.model_load))
    optimizer, ema = init_train_state(cfg, model, dev)
    net = model
    if cfg.world_size > 1:
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    loss_log, count, start_epoch = LossLog(), 0, cfg.start_epoch
    if resume is not None:
        restore(resume, model, optimizer, ema)
        loss_log = LossLog(resume["loss_log"])
        count = int(resume["step"])
        start_epoch = cfg.start_epoch or int(resume["epoch"]) + 1
        if chief:
            print("%s: resumed from %s (epoch %d)"
                  % (timestamp(), cfg.model_load, resume["epoch"]),
                  flush=True)
    monitor = SentinelMonitor(cfg) if cfg.sentinel else None
    sentinel = (Sentinel(cfg, model, optimizer, ema, dev, count)
                if cfg.sentinel else None)
    trainer = Trainer(model, optimizer, ema, sentinel, loss_log, count, dev)
    distiller = make_distiller(cfg, dev)
    schedule = make_lr_schedule(cfg, updates_per_epoch(cfg, steps_per_epoch))

    def build_runner():
        step = make_train_step(
            model, optimizer, schedule, cfg, net=net, ema=ema,
            sentinel=sentinel, distiller=distiller,
            loss_scale=monitor.scale_value if monitor else None)
        return make_step_runner(
            cfg, step, dev,
            cache=loader if isinstance(loader, DeviceDatasetCache) else None)

    runner = build_runner()
    prewarm_walls = None
    if cfg.prewarm:
        if runner.prewarm is not None:
            if chief:
                print("%s: prewarming %s multiscale buckets..."
                      % (timestamp(), "all" if cfg.multiscale_flag else "1"),
                      flush=True)
            prewarm_walls = runner.prewarm(trainer)
        elif chief:
            print("%s: --prewarm has no effect without --device-augment "
                  "(the host path has a single fixed-shape step)"
                  % timestamp(), flush=True)
    if chief:
        print("%s: model built, %d params, device %s, rank 0 of %d, %d "
              "steps per epoch" % (
                  timestamp(), sum(p.numel() for p in model.parameters()),
                  dev, cfg.world_size, steps_per_epoch), flush=True)
    from .obs.metrics import maybe_writer
    from .obs.slo import SloWatchdog, default_train_rules
    from .obs.spans import maybe_tracer
    tracer = maybe_tracer(cfg.span_log or None)
    if tracer.enabled:
        tracer.bind(rank=cfg.rank, world=cfg.world_size)
        if chief:
            print("%s: span log -> %s" % (timestamp(), tracer.path),
                  flush=True)
    mwriter = maybe_writer()
    slo = SloWatchdog(default_train_rules(), tracer=tracer)
    evaluator = (AsyncEvaluator(cfg, tracer=tracer)
                 if cfg.async_eval and chief else None)
    watchdog = HangWatchdog(cfg.hang_warn_seconds,
                            beat_file=os.environ.get(HEARTBEAT_ENV))
    if hasattr(loader, "worker_status"):
        watchdog.set_status_fn(loader.worker_status)
    writer = CheckpointWriter(async_save=cfg.async_ckpt)
    # the state a recovery before this run's first checkpoint returns to
    # (the --model-load checkpoint or the seeded init, ref train.py:2074)
    entry = trainer.snapshot() if cfg.auto_resume else None
    resume_attempts = 0
    run_ckpts: List[str] = []  # this run's checkpoints, oldest first
    epoch = start_epoch
    try:
        while epoch < cfg.end_epoch:
            try:
                if tracer.enabled:
                    tracer.context(epoch=epoch)
                trainer.count = train_epoch(
                    cfg, epoch, loader, None, dev, trainer.loss_log,
                    trainer.count, chief=chief, monitor=monitor,
                    runner=runner, epoch_base_step=epoch * steps_per_epoch,
                    tracer=tracer, injector=injector, chaos=chaos,
                    watchdog=watchdog, mwriter=mwriter, slo=slo)
                if sentinel is not None:  # the updates taken, skips out
                    trainer.count = int(sentinel.count.item())
                if (epoch + 1) % max(1, cfg.ckpt_interval) == 0 \
                        or epoch == cfg.end_epoch - 1:
                    watchdog.pause("epoch %d boundary (checkpoint)" % epoch)
                    if chief:
                        with tracer.span("checkpoint", epoch=epoch):
                            path = writer.save(
                                cfg.save_path, epoch, trainer.count, model,
                                optimizer, trainer.loss_log, ema)
                        print("%s: epoch %d checkpoint -> %s"
                              % (timestamp(), epoch, path), flush=True)
                        if evaluator is not None:
                            evaluator.submit(epoch, path)
                    run_ckpts.append(checkpoint_dir(cfg.save_path, epoch))
                    if chief:
                        apply_retention(cfg, run_ckpts)
                    watchdog.resume("epoch %d checkpoint done" % epoch)
            except TrainingDivergenceError as e:
                # sustained divergence (ref train.py:1983-2004): restore
                # this run's last checkpoint and rerun from its epoch
                if not (monitor is not None and run_ckpts
                        and monitor.rollbacks < cfg.sentinel_rollbacks):
                    raise
                monitor.note_rollback()
                latest = run_ckpts[-1]
                epoch = trainer.restore_checkpoint(latest) + 1
                tracer.event("recover:rollback", checkpoint=latest,
                             epoch=epoch, attempt=monitor.rollbacks)
                if chief:
                    print("%s: sentinel divergence (%s); rollback %d/%d to "
                          "%s (epoch %d)" % (
                              timestamp(), str(e)[:160], monitor.rollbacks,
                              cfg.sentinel_rollbacks, latest, epoch - 1),
                          flush=True)
                continue
            except Exception as e:  # noqa: BLE001 — filtered just below
                # --auto-resume (ref train.py:2005-2093): a transient
                # backend failure backs off, probes the card and restores
                # this run's newest checkpoint; anything else propagates
                if not (cfg.auto_resume
                        and resume_attempts < cfg.auto_resume
                        and is_transient_backend_error(e)):
                    raise
                resume_attempts += 1
                wait = min(300.0, cfg.resume_backoff_s * resume_attempts)
                print("%s: transient backend failure in epoch %d (%s: %s); "
                      "recovery %d/%d in %.0fs"
                      % (timestamp(), epoch, type(e).__name__,
                         str(e).splitlines()[0][:200], resume_attempts,
                         cfg.auto_resume, wait), flush=True)
                tracer.event("recover:backoff", epoch=epoch,
                             attempt=resume_attempts, wait_s=wait)
                watchdog.pause("auto-resume backoff")
                time.sleep(wait)
                watchdog.resume("auto-resume device probe")
                try:
                    probe_device(dev)
                except Exception as probe_err:  # noqa: BLE001
                    raise RuntimeError(
                        "auto-resume aborted: device probe failed after "
                        "backoff (%s) — the card is gone or its context "
                        "is poisoned, not transient; restart the process "
                        "with --model-load"
                        % str(probe_err).splitlines()[0][:200]) from e
                if isinstance(loader, DeviceDatasetCache) \
                        and not loader.alive():
                    print("%s: --cache-device cache lost; re-staging the "
                          "dataset" % timestamp(), flush=True)
                    loader = make_loader(cfg, dataset, augmentor, dev)
                runner = build_runner()
                if run_ckpts:
                    latest = run_ckpts[-1]
                    epoch = trainer.restore_checkpoint(latest) + 1
                    what = "auto-resumed from %s (epoch %d)" % (latest,
                                                                epoch - 1)
                else:
                    trainer.restore_snapshot(entry)
                    epoch = start_epoch
                    what = ("no checkpoint from this run yet; restarted "
                            "from its entry state (epoch %d)" % epoch)
                tracer.event("recover:auto-resume", epoch=epoch,
                             attempt=resume_attempts)
                print("%s: %s" % (timestamp(), what), flush=True)
                watchdog.resume("auto-resume restored")
                continue
            epoch += 1
    finally:
        watchdog.pause("finalizing checkpoints")
        writer.finalize()
        if evaluator is not None:
            evaluator.finalize()
        watchdog.stop()
        if hasattr(loader, "quarantined"):
            default_registry().gauge("train.quarantined_batches").set(
                loader.quarantined)
        if hasattr(loader, "close"):
            loader.close()
        mwriter.close()
        tracer.close()
    return {"model": model, "optimizer": optimizer,
            "loss_log": trainer.loss_log, "step": trainer.count, "ema": ema,
            "monitor": monitor, "loader": loader, "evaluator": evaluator,
            "prewarm": prewarm_walls}
