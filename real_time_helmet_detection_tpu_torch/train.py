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
* Each epoch writes `<save_path>/check_point_<epoch+1>/` (the JAX
  package's naming): `checkpoint.pt` = {state_dict, optimizer, epoch,
  step, loss_log} and `weights.npz`, the flax-shaped tree the eval CLI
  loads (`--model-load .../weights.npz`), both written atomically.
  `step` counts optimizer updates.

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
import io
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .config import (Config, load_config, resolve_model_load,
                     snapshot_beside, update_config_for_eval)
from .convert import load_into, load_npz, save_npz, state_dict_to_flax
from .data.pipeline import Batch, BatchLoader, load_dataset
from .evaluate import init_weights, weights_file
from .models.hourglass import build_model, cast_convs, cast_params
from .obs.metrics import default_registry
from .ops.loss import (LossLog, _num_pos, fused_detection_loss,
                       normed_l1_loss, split_stack_predictions)
from .optim import (MasterOptimizer, build_optimizer, device_counts,
                    make_lr_schedule, set_lr, updates_per_epoch)
from .parallel import (all_reduce_sum_, barrier_synced_build,
                       init_distributed, local_batch_size, world_size)
from .runtime.errors import TrainingDivergenceError
from .utils import AverageMeter, atomic_write_bytes, timestamp

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
    their parts. The losses dict holds detached device scalars, the
    micro-batches' mean."""
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
        if sentinel is not None:
            grads = [m.grad for m in optimizer.masters] if master else \
                [p.grad for p in model.parameters() if p.grad is not None]
            bad, norm = sentinel.verdict(out["total"], grads, scale)
            # the schedule counts the updates taken: a skip delays it
            count = sentinel.count
            out.update(sentinel_bad=bad.float(), sentinel_grad_norm=norm,
                       sentinel_scale=torch.full_like(norm, scale))
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
        return out

    return step


def stage(batch: Batch, device: torch.device):
    """The step's five input tensors on `device`; to a card they go
    through pinned host memory, asynchronously."""
    arrays = (batch.image, batch.heatmap, batch.offset, batch.wh, batch.mask)
    if device.type != "cuda":
        return tuple(torch.from_numpy(a) for a in arrays)
    return tuple(torch.from_numpy(a).pin_memory().to(device,
                                                     non_blocking=True)
                 for a in arrays)


def train_epoch(cfg: Config, epoch: int, loader: BatchLoader, step,
                device: torch.device, loss_log: LossLog,
                count: int, chief: bool = True,
                monitor: Optional[SentinelMonitor] = None) -> int:
    """One epoch of the hot loop (ref train.py:1508); returns the update
    count after it. Under `--sub-divisions k` a step updates on every
    k-th batch and on the epoch's last. `monitor` reads each flush
    window's sentinel flags (and may raise TrainingDivergenceError)."""
    loader.set_epoch(epoch)
    meters = {k: AverageMeter() for k in ("data", "step")}
    pending = []
    n, k = len(loader), cfg.sub_divisions

    def flush_losses():
        # one device -> host copy (and, across ranks, one all-reduce) for
        # the whole interval; the sentinel's scalars ride along
        if pending:
            keys = LossLog.KEYS + tuple(sorted(
                set(pending[0]) - set(LossLog.KEYS)))
            rows = torch.stack([torch.stack([p[key].float() for key in keys])
                                for p in pending])
            if world_size() > 1:
                rows = all_reduce_sum_(rows) / world_size()
            fetched = [dict(zip(keys, row)) for row in rows.cpu().tolist()]
            for rec in fetched:
                loss_log.append(rec)
            pending.clear()
            if monitor is not None:
                monitor.observe(fetched)

    tic = time.time()
    for i, batch in enumerate(loader):
        data_t = time.time() - tic
        meters["data"].update(data_t)
        update = (i + 1) % k == 0 or i == n - 1
        pending.append(step(count, *stage(batch, device), update=update))
        count += update
        if i % cfg.print_interval == 0:
            flush_losses()
        meters["step"].update(time.time() - tic - data_t)
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


def save_checkpoint(save_path: str, epoch: int, count: int,
                    model: torch.nn.Module, optimizer,
                    loss_log: LossLog, ema: Optional[EMA] = None) -> str:
    """Write `checkpoint.pt`, with the EMA `ema.npz`, then `weights.npz`
    (the two files that make the checkpoint complete) into the epoch's
    dir. `checkpoint.pt` = {state_dict, optimizer (under the bf16 policy
    the fp32 masters and the dtypes), ema, param_policy, epoch, step,
    loss_log}."""
    path = checkpoint_dir(save_path, epoch)
    os.makedirs(path, exist_ok=True)
    state = model.state_dict()
    opt_state = optimizer.state_dict()
    buf = io.BytesIO()
    torch.save({"state_dict": state, "optimizer": opt_state,
                "ema": None if ema is None else ema.state_dict(),
                "param_policy": opt_state.get("policy", "fp32"),
                "epoch": epoch, "step": count,
                "loss_log": loss_log.state_dict()}, buf)
    atomic_write_bytes(os.path.join(path, CHECKPOINT), buf.getvalue())
    if ema is not None:
        save_npz(os.path.join(path, EMA_WEIGHTS),
                 state_dict_to_flax(ema.model_state(model)))
    save_npz(os.path.join(path, WEIGHTS), state_dict_to_flax(state))
    return path


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


def train(cfg: Config) -> Dict:
    """Full training run (ref train.py:1698), on every rank of a
    `--world-size` run. Returns {"model", "optimizer", "loss_log",
    "step", "ema", "monitor"} after the last epoch."""
    dev = init_distributed(cfg)
    chief = cfg.rank == 0
    if dev.type == "cuda":
        # fp32 means fp32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if cfg.world_size > 1:
        barrier_synced_build(dev)
    dataset, augmentor = load_dataset(cfg)
    loader = BatchLoader(
        dataset, augmentor, batch_size=local_batch_size(cfg),
        pretrained=cfg.pretrained, num_cls=cfg.num_cls,
        normalized_coord=cfg.normalized_coord,
        scale_factor=cfg.scale_factor, max_boxes=cfg.max_boxes,
        shuffle=True, drop_last=True, rank=cfg.rank,
        world_size=cfg.world_size, seed=cfg.random_seed,
        num_workers=cfg.num_workers)
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
    distiller = make_distiller(cfg, dev)
    schedule = make_lr_schedule(cfg, updates_per_epoch(cfg, steps_per_epoch))
    step = make_train_step(
        model, optimizer, schedule, cfg, net=net, ema=ema,
        sentinel=sentinel, distiller=distiller,
        loss_scale=monitor.scale_value if monitor else None)
    if chief:
        print("%s: model built, %d params, device %s, rank 0 of %d, %d "
              "steps per epoch" % (
                  timestamp(), sum(p.numel() for p in model.parameters()),
                  dev, cfg.world_size, steps_per_epoch), flush=True)
    run_ckpts: List[str] = []  # this run's checkpoints, oldest first
    epoch = start_epoch
    while epoch < cfg.end_epoch:
        try:
            count = train_epoch(cfg, epoch, loader, step, dev, loss_log,
                                count, chief=chief, monitor=monitor)
        except TrainingDivergenceError as e:
            # sustained divergence (ref train.py:1983-2004): restore this
            # run's last checkpoint and rerun from its epoch
            if not (monitor is not None and run_ckpts
                    and monitor.rollbacks < cfg.sentinel_rollbacks):
                raise
            monitor.note_rollback()
            latest = run_ckpts[-1]
            ckpt = load_checkpoint(latest)
            restore(ckpt, model, optimizer, ema)
            device_counts(optimizer, dev)
            loss_log = LossLog(ckpt["loss_log"])
            count = int(ckpt["step"])
            sentinel.count.fill_(count)
            epoch = int(ckpt["epoch"]) + 1
            if chief:
                print("%s: sentinel divergence (%s); rollback %d/%d to %s "
                      "(epoch %d)" % (timestamp(), str(e)[:160],
                                      monitor.rollbacks,
                                      cfg.sentinel_rollbacks, latest,
                                      ckpt["epoch"]), flush=True)
            continue
        if sentinel is not None:  # the updates taken, skips left out
            count = int(sentinel.count.item())
        path = checkpoint_dir(cfg.save_path, epoch)
        if chief:
            save_checkpoint(cfg.save_path, epoch, count, model, optimizer,
                            loss_log, ema)
            print("%s: epoch %d checkpoint -> %s"
                  % (timestamp(), epoch, path), flush=True)
        run_ckpts.append(path)
        epoch += 1
    return {"model": model, "optimizer": optimizer, "loss_log": loss_log,
            "step": count, "ema": ema, "monitor": monitor}
