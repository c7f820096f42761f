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
"""

from __future__ import annotations

import contextlib
import io
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .config import Config
from .convert import load_into, load_npz, save_npz, state_dict_to_flax
from .data.pipeline import Batch, BatchLoader, load_dataset
from .evaluate import init_weights
from .models.hourglass import build_model
from .ops.loss import LossLog, fused_detection_loss
from .optim import (build_optimizer, make_lr_schedule, set_lr,
                    updates_per_epoch)
from .parallel import (all_reduce_sum_, barrier_synced_build,
                       init_distributed, local_batch_size, world_size)
from .utils import AverageMeter, atomic_write_bytes, timestamp

CHECKPOINT = "checkpoint.pt"
WEIGHTS = "weights.npz"


def loss_fn(model: torch.nn.Module, images, gt_heat, gt_off, gt_wh, mask,
            cfg: Config) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + deep-supervision loss over all stacks (ref train.py:246),
    through the fused loss (the JAX package's TPU default, `--loss-kernel
    fused`). The model must be in train mode: its BatchNorms use batch
    moments and update their running statistics."""
    out = model(images)
    totals = fused_detection_loss(
        out, gt_heat, gt_off, gt_wh, mask,
        normalized_coord=cfg.normalized_coord, hm_weight=cfg.hm_weight,
        offset_weight=cfg.offset_weight, size_weight=cfg.size_weight,
        focal_alpha=cfg.focal_alpha, focal_beta=cfg.focal_beta)
    return totals["total"], totals


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], cfg: Config,
                    net: Optional[torch.nn.Module] = None):
    """`step(count, images, heat, off, wh, mask, update=True) -> losses`:
    forward + backward of `--grad-accum` k micro-batches, their gradients
    summed into `p.grad` (zeroed first when the step opens an update
    window); with `update`, one optimizer update at `schedule(count)`,
    which closes the window (ref train.py:359, :442, :308). The forward
    goes through `net` (default `model`): a DistributedDataParallel
    wrapper all-reduces the gradients on the update's last micro-batch
    only. The losses dict holds detached device scalars, the
    micro-batches' mean."""
    net = model if net is None else net
    k = cfg.grad_accum
    no_sync = getattr(net, "no_sync", None)
    window_open = [False]  # gradients of this update window in p.grad

    def step(count: int, images, gt_heat, gt_off, gt_wh, mask,
             update: bool = True):
        if not window_open[0]:
            optimizer.zero_grad(set_to_none=True)
            window_open[0] = True
        arrays = (images, gt_heat, gt_off, gt_wh, mask)
        rows = images.shape[0] // k
        micro = []
        for j in range(k):
            part = arrays if k == 1 else tuple(
                a[j * rows:(j + 1) * rows] for a in arrays)
            syncs = no_sync is None or (update and j == k - 1)
            with contextlib.nullcontext() if syncs else no_sync():
                total, losses = loss_fn(net, *part, cfg)
                total.backward()
            micro.append(losses)
        if update:
            set_lr(optimizer, schedule(count))
            optimizer.step()
            window_open[0] = False
        if k == 1:
            return {n: v.detach() for n, v in micro[0].items()}
        return {n: torch.stack([m[n].detach() for m in micro]).mean()
                for n in micro[0]}

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
                count: int, chief: bool = True) -> int:
    """One epoch of the hot loop (ref train.py:1508); returns the update
    count after it. Under `--sub-divisions k` a step updates on every
    k-th batch and on the epoch's last."""
    loader.set_epoch(epoch)
    meters = {k: AverageMeter() for k in ("data", "step")}
    pending = []
    n, k = len(loader), cfg.sub_divisions

    def flush_losses():
        # one device -> host copy (and, across ranks, one all-reduce) for
        # the whole interval
        if pending:
            rows = torch.stack([torch.stack([p[key] for key in LossLog.KEYS])
                                for p in pending])
            if world_size() > 1:
                rows = all_reduce_sum_(rows) / world_size()
            for row in rows.cpu().tolist():
                loss_log.append(dict(zip(LossLog.KEYS, row)))
            pending.clear()

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
                    model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_log: LossLog) -> str:
    """Write `checkpoint.pt` and `weights.npz` into the epoch's dir."""
    path = checkpoint_dir(save_path, epoch)
    os.makedirs(path, exist_ok=True)
    state = model.state_dict()
    buf = io.BytesIO()
    torch.save({"state_dict": state, "optimizer": optimizer.state_dict(),
                "epoch": epoch, "step": count,
                "loss_log": loss_log.state_dict()}, buf)
    atomic_write_bytes(os.path.join(path, CHECKPOINT), buf.getvalue())
    save_npz(os.path.join(path, WEIGHTS), state_dict_to_flax(state))
    return path


def load_checkpoint(path: str) -> Dict:
    """A `checkpoint.pt` (or the dir holding one), on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    return torch.load(path, map_location="cpu", weights_only=True)


def train(cfg: Config) -> Dict:
    """Full training run (ref train.py:1698), on every rank of a
    `--world-size` run. Returns {"model", "optimizer", "loss_log",
    "step"} after the last epoch."""
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
        resume = load_checkpoint(cfg.model_load)
        model.load_state_dict(resume["state_dict"])
    model.to(dev).train()
    net = model
    if cfg.world_size > 1:
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    optimizer = build_optimizer(cfg, model.parameters())
    loss_log, count, start_epoch = LossLog(), 0, cfg.start_epoch
    if resume is not None:
        optimizer.load_state_dict(resume["optimizer"])
        loss_log = LossLog(resume["loss_log"])
        count = int(resume["step"])
        start_epoch = cfg.start_epoch or int(resume["epoch"]) + 1
        if chief:
            print("%s: resumed from %s (epoch %d)"
                  % (timestamp(), cfg.model_load, resume["epoch"]),
                  flush=True)
    schedule = make_lr_schedule(cfg, updates_per_epoch(cfg, steps_per_epoch))
    step = make_train_step(model, optimizer, schedule, cfg, net=net)
    if chief:
        print("%s: model built, %d params, device %s, rank 0 of %d, %d "
              "steps per epoch" % (
                  timestamp(), sum(p.numel() for p in model.parameters()),
                  dev, cfg.world_size, steps_per_epoch), flush=True)
    for epoch in range(start_epoch, cfg.end_epoch):
        count = train_epoch(cfg, epoch, loader, step, dev, loss_log, count,
                            chief=chief)
        if chief:
            path = save_checkpoint(cfg.save_path, epoch, count, model,
                                   optimizer, loss_log)
            print("%s: epoch %d checkpoint -> %s"
                  % (timestamp(), epoch, path), flush=True)
    return {"model": model, "optimizer": optimizer, "loss_log": loss_log,
            "step": count}
