"""Configuration of the PyTorch port's train and eval/predict paths.

A dataclass copy of the JAX package's flags that these paths read
(ref real_time_helmet_detection_tpu/config.py:88 `Config`; reference
config.py:139-169), with the same names and defaults, plus `--device`.
Field name -> CLI flag: underscores become dashes; list fields take
several values (`--multiscale 320 512 64`).

Every architecture option of the JAX model is built
(`--variant residual|depthwise|ghost`, `--activation` and
`--neck-activation` ReLU|LReLU|PReLU|Linear|Mish|Sigmoid|CELU, `--pool
Max|Avg|Conv|SPP|None`, `--neck-pool None|SPP`, `--stem-s2d`), and every
`--nms` mode (nms|soft-nms|maxpool). Values the port has not built yet
raise `NotImplementedError` instead of running something else: any other
activation, pool, neck pool or variant and `--num-stack` < 1 where the
model is built (models/hourglass.py); and any other `--nms`. The JAX
flags that only choose
between a kernel and its XLA composition (`--use-pallas`, `--epilogue`,
`--block-fuse`, `--loss-kernel`) have no field: the port has one path —
the kernels, the fused loss among them (the JAX package's TPU default,
`--loss-kernel fused`) — and the parser refuses those flags.

Inference precision (ref config.py:168-179): `--infer-dtype int8` runs
eval and the demo on the BN-folded, post-training-quantized twin
(`ops/quant.py`, the int8 conv kernels of `ops/qconv.py`), with the
activation scales of `--quant-scales` or calibrated on the first
`--calib-batches` eval batches (`--calib-percentile` < 100 clips to that
percentile of |x|). Training never reads it (ref config.py:78-80): a
`--train-flag` run under `--infer-dtype int8` or `--tier throughput`
trains the float architecture (the tier's ghost-96), whose checkpoint
the same flags then evaluate through the int8 twin.

Serving (ref config.py:181-210): the `--serve-*` fields configure the
serving engine (`serving/engine.py`) that eval and the demo predict
through. `--tier edge|throughput|quality` (ref config.py:59-85 `TIER_PRESETS`,
:813 `apply_tier`) sets a named architecture + serving bundle, applied by
the CLI before it dispatches; the tier wins over the individual flags.
The throughput tier sets `infer_dtype="int8"`.

Cascade and streams (ref config.py:212-246, :562-586, :700-800):
`--cascade [--cascade-threshold t] [--cascade-tiers edge quality]`
enrolls fleet tenants in edge-first serving (`serving/fleet.py`);
`--stream [--stream-threshold t] [--stream-tile-grid g] [--stream-ema e]
[--stream-track-radius r]` configures delta-gated tile inference
(`serving/streams.py`). A threshold left unset resolves, in
`get_config`, to the operating point of the newest committed
`artifacts/*/cascade.json` or `streams.json` (`cascade_overrides`,
`stream_overrides`): thresholds are calibrated, never picked by hand.

Gradient accumulation (ref config.py:98-111, :498-512): `--grad-accum k`
splits each step's batch into k micro-batches and makes one optimizer
update on the sum of their gradients; `--sub-divisions k` makes one
update every k host steps (and at an epoch's last step), on the sum of
theirs. The two compose.

Data parallelism (ref config.py:93-94, :149-152): one process per card,
`--world-size N --rank R --dist-url tcp://host:port`; `--dist-backend`
keeps JAX's default "xla", which here names the device's own backend
(NCCL on cuda, gloo on the CPU), and also takes `nccl` or `gloo`.
`--num-devices` takes 0 or 1 (a process drives one card) and
`--spatial` only 1 (halo-split images need more than one card).

The train-step extras (ref config.py:319-440, validation :470-503,
:527-529, :587-598), with JAX's values and checks:

* `--fwd-dtype int8`: the train forward of every BN'd, bias-free conv
  but the stem runs int8 (the quantizer and the int8 conv kernels of
  `ops/qconv.py`) with a straight-through float backward
  (`ops/quant.py` `ste_conv`);
* `--param-policy bf16-compute` (needs `--amp`, refused with
  `--sub-divisions` > 1): bf16 parameters, an fp32 master in the
  optimizer (`optim.MasterOptimizer`);
* `--remat none|stacks|full` (the old boolean form too): recompute each
  hourglass stack, or the whole forward, in backward;
* `--ema-decay d`: an exponential moving average of the parameters,
  kept in the checkpoint; `--ema-eval` evaluates it;
* `--sentinel` (+ `--sentinel-spike/-backoff/-divergence/-rollbacks`):
  a step with a non-finite loss or gradient norm, or a gradient norm
  above the spike, leaves the whole train state as it was; the loss
  scale backs off; sustained skips roll back to the last checkpoint.
  With `--sub-divisions` > 1 the update window counts good steps on the
  device (`train.make_train_step`): a skip moves neither the window nor
  the accumulated gradient;
* `--distill CKPT --distill-alpha a`: a teacher's soft targets join the
  loss.

The training runtime (ref config.py:119-130, :255-258, :322-330,
:382-416, :443-455, the refusals of ref config.py:513-517 and
train.py:1733-1757, :1845-1857), with JAX's names, defaults and checks:

* input: `--loader thread|process` (`data/shm_pool.py`),
  `--device-prefetch N` (stage N batches ahead on a side stream),
  `--device-augment` (augment and encode on the card;
  `data/augment_device.py`), `--cache-device` (the dataset on the card;
  needs `--device-augment`), `--prewarm` (run each multiscale bucket's
  step once before the first epoch);
* checkpoints and recovery: `--ckpt-interval N`, `--keep-ckpt N`,
  `--async-ckpt`, `--auto-resume N`, `--resume-backoff-s s`,
  `--async-eval`, `--hang-warn-seconds s`, `--fault-inject EPOCH:ITER`;
* observability: `--telemetry` (gradient/update/parameter norms in the
  losses), `--span-log PATH` (the flight recorder; else $OBS_SPAN_LOG).

Refused as JAX refuses them: `--grad-accum` > 1 with `--device-augment`
(always); in a training run `--cache-device` without `--device-augment`,
`--async-eval` with `--async-ckpt` or without a dataset root,
`--auto-resume` with `--async-ckpt`, and `--async-ckpt`, `--auto-resume`
or `--cache-device` with `--world-size` > 1 (JAX refuses them for more
than one process).

Config snapshots (ref config.py:853-913): the CLI writes
`argument.json`/`argument.txt` into `--save-path` (`save_config`; JAX's
keys, so either package reads the other's); eval, the demo and export
with `--model-load` resolve a save dir to its newest complete
checkpoint (`resolve_model_load`) and take `ARCHITECTURE_FIELDS` from
the snapshot beside it (`get_config`).

Export (ref config.py:155-156, :197): `--export-flag` writes the predict
program (`export.py`) and exits; `--export-raw-input` bakes the uint8
wire and the normalization into it; `--export-serve` adds one program per
serve bucket.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

# The architecture fields an eval takes from the checkpoint's snapshot
# (ref config.py:45-49)
ARCHITECTURE_FIELDS = (
    "scale_factor", "num_cls", "pretrained", "normalized_coord",
    "num_stack", "hourglass_inch", "increase_ch", "activation", "pool",
    "neck_activation", "neck_pool", "variant", "stem_width",
)

# Latency-tier presets, the JAX package's (ref config.py:68-85): each
# overrides the listed fields. Each tier's serve_buckets is its own
# bucket set (one CUDA graph each in the engine).
TIER_PRESETS = {
    # latency first: ghost blocks at width 64, small buckets, no wait
    "edge": dict(variant="ghost", num_stack=1, hourglass_inch=64,
                 stem_width=64, increase_ch=0, serve_buckets=[1, 2, 4],
                 serve_max_wait_ms=0.0),
    # batch-16 goodput with int8 inference
    "throughput": dict(variant="ghost", num_stack=1, hourglass_inch=96,
                       stem_width=96, increase_ch=0, infer_dtype="int8",
                       serve_buckets=[4, 8, 16]),
    # accuracy first: the flagship with 2 stacks and soft-NMS
    "quality": dict(variant="residual", num_stack=2, hourglass_inch=128,
                    increase_ch=0, nms="soft-nms",
                    serve_buckets=[1, 2, 4, 8, 16]),
}


@dataclass
class Config:
    # device
    device: str = "cuda"          # torch device; "cpu" runs the kernels'
    # plain versions (tests). cuda without a card raises.
    num_devices: int = 0          # cards of this process: 0 or 1 (one
    # process per card; more cards = more processes, --world-size)
    spatial: int = 1              # spatial split of the maps: only 1
    random_seed: int = 777

    # train
    train_flag: bool = False
    data: Optional[str] = None
    batch_size: int = 16          # the global batch, over every rank
    sub_divisions: int = 1        # one update every k host steps (ref
    # train.py:124), on the summed gradients
    grad_accum: int = 1           # k equal micro-batches in one step,
    # one update on the summed gradients; must divide --batch-size
    start_epoch: int = 0
    end_epoch: int = 100
    num_workers: int = 8          # host data-pipeline workers (threads
    # or processes, per --loader)
    loader: str = "thread"        # thread | process (data/shm_pool.py:
    # spawned workers, shared-memory batches, bit-identical)
    device_prefetch: int = 0      # stage the next N batches' copies to
    # the card on a side stream while the step runs (0 disables)
    save_path: str = "./WEIGHTS/"
    print_interval: int = 100

    # precision: bf16 activations (conv weights cast at each call),
    # float32 parameters, BN statistics and output
    amp: bool = False
    param_policy: str = "fp32"    # "bf16-compute" (needs --amp): bf16
    # parameters, the fp32 master inside the optimizer, no per-call casts

    # augmentation
    crop_percent: List[float] = field(default_factory=lambda: [0.0, 0.1])
    color_multiply: List[float] = field(default_factory=lambda: [1.2, 1.5])
    translate_percent: float = 0.1
    affine_scale: List[float] = field(default_factory=lambda: [0.5, 1.5])
    multiscale_flag: bool = False
    multiscale: List[int] = field(default_factory=lambda: [320, 512, 64])

    # loss
    hm_weight: float = 1.0
    offset_weight: float = 1.0
    size_weight: float = 0.1
    focal_alpha: float = 2.0
    focal_beta: float = 4.0

    # optimization
    lr: float = 5e-4
    optim: str = "Adam"
    lr_milestone: List[int] = field(default_factory=lambda: [50, 90])
    lr_gamma: float = 0.1
    max_boxes: int = 128          # per-image GT padding for encode

    # train-step extras (ref config.py:319-440)
    remat: str = "none"           # none | stacks | full: recompute each
    # hourglass stack / the whole forward in backward
    fwd_dtype: str = "bf16"       # bf16 | int8: the train forward of the
    # eligible convs in int8, straight-through float backward
    ema_decay: float = 0.0        # > 0: an EMA of the parameters
    ema_eval: bool = False        # eval/demo/export with the EMA weights
    sentinel: bool = False        # skip non-finite / spiking steps
    sentinel_spike: float = 0.0   # gradient-norm spike threshold; 0 = off
    sentinel_backoff: float = 0.5  # loss-scale factor after a window
    # with skipped steps (floor 1/1024; doubled back after a clean one)
    sentinel_divergence: int = 3  # consecutive skips that roll back
    sentinel_rollbacks: int = 2   # rollbacks a run may take
    distill: Optional[str] = None  # teacher checkpoint (dir, save dir or
    # npz); its architecture from the snapshot beside it
    distill_alpha: float = 0.5    # weight of the soft losses

    # the training runtime (ref config.py:255-258, :322-330, :382-455)
    device_augment: bool = False  # augment + encode on the card, inside
    # the step (data/augment_device.py); the host only decodes and resizes
    cache_device: bool = False    # the whole dataset's canvases on the
    # card; each step gathers its batch by index (needs --device-augment)
    prewarm: bool = False         # run every multiscale bucket's step once
    # on zeros before epoch 0 (cuDNN plans, allocator); state unchanged
    ckpt_interval: int = 1        # checkpoint every N epochs (and the last)
    keep_ckpt: int = 0            # keep only this run's newest N
    # checkpoints (0 keeps all)
    async_ckpt: bool = False      # snapshot on the card, write from a
    # thread while the next epoch trains (at most one save in flight)
    hang_warn_seconds: float = 300.0  # watchdog: warn when no step
    # completes for this long (0 disables)
    async_eval: bool = False      # evaluate each checkpoint in one
    # background subprocess on the training device (skipped when busy)
    auto_resume: int = 0          # on a transient backend failure, back
    # off, probe the card, restore this run's newest checkpoint and go on,
    # up to N times (0 disables)
    resume_backoff_s: float = 15.0  # attempt k sleeps min(300, k * this)
    fault_inject: str = ""        # "EPOCH:ITER": raise one synthetic
    # transient backend error there (exercises --auto-resume)
    telemetry: bool = False       # gradient/update/parameter norms in each
    # step's losses, fetched with them
    span_log: str = ""            # flight-recorder span log (JSONL); "" =
    # $OBS_SPAN_LOG when set, else off
    profile: bool = False         # torch.profiler trace of the first
    # epoch's steps 2-7 on the chief, into <save_path>/trace
    summary: bool = True          # print a layer table at train start on
    # the chief (the reference's torchsummary on rank 0, ref
    # config.py:456-458): shape inference on `meta` tensors, no device work

    # distributed: one process per card (the reference's convention)
    world_size: int = 1           # number of processes
    rank: int = 0                 # this process's index
    dist_backend: str = "xla"     # "xla" = the device's own backend
    # (nccl on cuda, gloo on the cpu); or "nccl" / "gloo"
    dist_url: str = "tcp://localhost:29500"  # rank 0's rendezvous store

    # evaluation, demo, export
    export_flag: bool = False     # export the predict program and exit
    export_raw_input: bool = False  # bake normalization into the export:
    # the program takes raw [0, 255] uint8 pixels (self-contained
    # deployment)
    imsize: Optional[int] = None
    topk: int = 100
    conf_th: float = 0.0
    nms_th: float = 0.5
    pool_size: int = 3
    model_load: Optional[str] = None  # npz of the flax variable tree, a
    # port checkpoint dir (check_point_N) or a save dir (its newest
    # complete checkpoint); train resumes from a checkpoint
    nms: str = "nms"              # nms | soft-nms | maxpool
    fontsize: int = 10
    infer_dtype: str = "bf16"     # eval/demo numeric path: "bf16" = the
    # float model (compute dtype from --amp); "int8" = the BN-folded,
    # post-training-quantized twin (ops/quant.py). Training ignores it.
    quant_scales: Optional[str] = None  # a saved activation-scales
    # artifact (ops.quant.save_scales); unset = calibrate on the first
    # --calib-batches eval batches and save one
    calib_batches: int = 4        # calibration batches when no --quant-scales
    calib_percentile: float = 100.0  # activation clip statistic: 100 =
    # abs-max, < 100 = that upper percentile of |x|

    # serving engine (serving/engine.py), the eval and demo predict path
    serve_buckets: List[int] = field(
        default_factory=lambda: [1, 2, 4, 8, 16])  # static batch sizes, one
    # CUDA graph each; a batch takes the smallest bucket >= its size
    serve_max_wait_ms: float = 5.0  # dispatch when the largest bucket
    # fills or this long after the oldest queued request arrived
    serve_depth: int = 2          # batches in flight (H2D, replay, D2H)
    serve_queue: int = 128        # admission bound on queued requests
    export_serve: bool = False    # export additionally writes one program
    # per serve bucket (out_dir/serving/b<N>/) so the C++ runner can serve
    # the same bucket set the Python engine does
    serve_max_retries: int = 2    # per-request retries after a failed or
    # hung batch
    serve_hang_timeout_ms: float = 0.0  # fetch watchdog; 0 disables
    tier: str = ""                # "" | edge | throughput | quality (see
    # TIER_PRESETS)

    # cascade serving (ref config.py:212-227; serving/fleet.py): tenants
    # enrolled in the cascade dispatch to the edge tier first and
    # escalate to the quality tier iff the edge predict's confidence
    # (ops.decode.confidence_summary) is below the threshold
    cascade: bool = False
    cascade_threshold: Optional[float] = None  # None: the calibrated
    # operating point of the newest artifacts/*/cascade.json
    # (cascade_overrides); an explicit value wins
    cascade_tiers: List[str] = field(
        default_factory=lambda: ["edge", "quality"])  # (edge, quality)

    # streaming video (ref config.py:229-246; serving/streams.py): a
    # StreamSession computes only the tiles whose mean |delta| reaches
    # the threshold, the others answer from its tile cache
    stream: bool = False
    stream_threshold: Optional[float] = None  # mean |delta| in [0, 255];
    # None: the newest artifacts/*/streams.json (stream_overrides)
    stream_tile_grid: int = 2     # grid x grid tiles a frame
    stream_ema: float = 0.5       # weight of the previous score of an
    # associated track (0: no smoothing)
    stream_track_radius: float = 8.0  # association radius, tile pixels

    # network
    variant: str = "residual"
    stem_width: int = 0
    scale_factor: int = 4
    num_cls: int = 2
    pretrained: str = "imagenet"
    normalized_coord: bool = False
    num_stack: int = 1
    hourglass_inch: int = 128
    increase_ch: int = 0
    activation: str = "ReLU"
    pool: str = "Max"
    neck_activation: str = "ReLU"
    neck_pool: str = "None"
    stem_s2d: bool = False        # the 7x7 s2 stem as a 4x4 conv over the
    # 2x2 space-to-depth input: the same sums, the same parameters

    def __post_init__(self):
        def only(flag, value, allowed):
            if value not in allowed:
                raise NotImplementedError(
                    "--%s %r is not ported yet (have %s)"
                    % (flag, value, ", ".join(map(str, allowed))))

        only("nms", self.nms, ("nms", "soft-nms", "maxpool"))
        # the boolean form of --remat (ref config.py:470-476)
        if isinstance(self.remat, bool):
            self.remat = "stacks" if self.remat else "none"
        if self.remat not in ("none", "stacks", "full"):
            raise ValueError("--remat must be one of none|stacks|full, "
                             "got %r" % (self.remat,))
        if self.fwd_dtype not in ("bf16", "int8"):
            raise ValueError("--fwd-dtype must be 'bf16' or 'int8', "
                             "got %r" % (self.fwd_dtype,))
        if self.param_policy not in ("fp32", "bf16-compute"):
            raise ValueError("--param-policy must be 'fp32' or "
                             "'bf16-compute', got %r" % (self.param_policy,))
        if self.param_policy == "bf16-compute":
            if not self.amp:
                raise ValueError(
                    "--param-policy bf16-compute requires --amp: without "
                    "the bf16 compute policy the once-cast params would "
                    "silently change the compute dtype itself")
            if self.sub_divisions > 1:
                raise ValueError(
                    "--param-policy bf16-compute is incompatible with "
                    "--sub-divisions > 1: optax.MultiSteps would "
                    "accumulate micro-gradients in bf16 — keep the fp32 "
                    "policy for accumulation runs")
        if not self.distill_alpha > 0:
            raise ValueError("--distill-alpha must be > 0, got %r"
                             % (self.distill_alpha,))
        if self.sentinel_spike < 0:
            raise ValueError("--sentinel-spike must be >= 0, got %r"
                             % (self.sentinel_spike,))
        if not 0.0 < self.sentinel_backoff <= 1.0:
            raise ValueError("--sentinel-backoff must be in (0, 1], got %r"
                             % (self.sentinel_backoff,))
        if self.sentinel_divergence < 1:
            raise ValueError("--sentinel-divergence must be >= 1, got %d"
                             % self.sentinel_divergence)
        if self.sentinel_rollbacks < 0:
            raise ValueError("--sentinel-rollbacks must be >= 0, got %d"
                             % self.sentinel_rollbacks)
        self._check_runtime()
        only("optim", self.optim.lower(), ("adam", "adamw", "sgd"))
        if self.sub_divisions < 1:
            raise ValueError("--sub-divisions must be >= 1, got %d"
                             % self.sub_divisions)
        if self.grad_accum < 1:
            raise ValueError("--grad-accum must be >= 1, got %d"
                             % self.grad_accum)
        if self.grad_accum > 1 and self.batch_size % self.grad_accum:
            raise ValueError(
                "--grad-accum %d must divide --batch-size %d (equal "
                "fixed-shape micro-batches under jit)"
                % (self.grad_accum, self.batch_size))
        if self.num_devices not in (0, 1):
            raise ValueError(
                "--num-devices %d: a process of the port drives one card; "
                "run one process per card with --world-size N --rank R "
                "--dist-url tcp://host:port" % self.num_devices)
        if self.spatial != 1:
            raise NotImplementedError(
                "--spatial %d is not ported: halo-split images need more "
                "than one card per process (only --spatial 1)"
                % self.spatial)
        if self.world_size < 1 or not 0 <= self.rank < self.world_size:
            raise ValueError("--rank must be in [0, --world-size), got "
                             "rank %d of %d" % (self.rank, self.world_size))
        if self.dist_backend not in ("xla", "nccl", "gloo"):
            raise ValueError("--dist-backend must be xla (the device's "
                             "own: nccl on cuda, gloo on the cpu), nccl or "
                             "gloo, got %r" % (self.dist_backend,))
        if self.tier and self.tier not in TIER_PRESETS:
            raise ValueError("--tier must be '' or one of %s, got %r"
                             % (sorted(TIER_PRESETS), self.tier))
        if self.infer_dtype not in ("bf16", "int8"):
            raise ValueError("--infer-dtype must be 'bf16' or 'int8', "
                             "got %r" % (self.infer_dtype,))
        if self.calib_batches < 1:
            raise ValueError("--calib-batches must be >= 1, got %d"
                             % self.calib_batches)
        if not 0.0 < self.calib_percentile <= 100.0:
            raise ValueError("--calib-percentile must be in (0, 100], "
                             "got %r" % (self.calib_percentile,))
        if not self.serve_buckets or any(int(b) < 1
                                         for b in self.serve_buckets):
            raise ValueError("--serve-buckets must be a non-empty list of "
                             "positive batch sizes, got %r"
                             % (self.serve_buckets,))
        if self.serve_max_wait_ms < 0:
            raise ValueError("--serve-max-wait-ms must be >= 0, got %r"
                             % (self.serve_max_wait_ms,))
        if self.serve_depth < 1:
            raise ValueError("--serve-depth must be >= 1, got %d"
                             % self.serve_depth)
        if self.serve_queue < 1:
            raise ValueError("--serve-queue must be >= 1, got %d"
                             % self.serve_queue)
        if self.serve_max_retries < 0:
            raise ValueError("--serve-max-retries must be >= 0, got %d"
                             % self.serve_max_retries)
        if self.serve_hang_timeout_ms < 0:
            raise ValueError("--serve-hang-timeout-ms must be >= 0, got %r"
                             % (self.serve_hang_timeout_ms,))
        self._check_cascade_streams()
        if self.scale_factor != 4:
            raise ValueError("--scale-factor must be 4: the stem's 4x "
                             "downsample is structural")
        if self.stem_width < 0:
            raise ValueError("--stem-width must be >= 0, got %d"
                             % self.stem_width)
        if self.pool_size % 2 != 1 or self.pool_size < 1:
            raise ValueError("--pool-size must be odd and >= 1, got %d"
                             % self.pool_size)
        if len(self.multiscale) != 3 or self.multiscale[2] <= 0:
            raise ValueError("--multiscale takes MIN MAX STEP with STEP > 0, "
                             "got %r" % (self.multiscale,))


    def _check_cascade_streams(self) -> None:
        """The cascade and stream fields' checks (ref config.py:562-586)."""
        if self.cascade:
            if (len(self.cascade_tiers) != 2
                    or self.cascade_tiers[0] == self.cascade_tiers[1]):
                raise ValueError(
                    "--cascade-tiers must name two distinct tiers "
                    "(edge-hop first), got %r" % (self.cascade_tiers,))
            bad = [t for t in self.cascade_tiers if t not in TIER_PRESETS]
            if bad:
                raise ValueError(
                    "--cascade-tiers must be named tier presets %s, got %r"
                    % (sorted(TIER_PRESETS), self.cascade_tiers))
        if self.cascade_threshold is not None \
                and not math.isfinite(self.cascade_threshold):
            raise ValueError("--cascade-threshold must be finite, got %r"
                             % (self.cascade_threshold,))
        if self.stream_tile_grid < 1:
            raise ValueError("--stream-tile-grid must be >= 1, got %d"
                             % self.stream_tile_grid)
        if self.stream_threshold is not None \
                and not math.isfinite(self.stream_threshold):
            raise ValueError("--stream-threshold must be finite, got %r"
                             % (self.stream_threshold,))
        if not 0.0 <= self.stream_ema < 1.0:
            raise ValueError("--stream-ema must be in [0, 1), got %r"
                             % (self.stream_ema,))

    def _check_runtime(self) -> None:
        """The training runtime's values and JAX's refusals of its
        combinations (ref config.py:513-517, :599-604; train.py:1733-1757,
        :1845-1857)."""
        if self.loader not in ("thread", "process"):
            raise ValueError("--loader must be 'thread' or 'process', got %r"
                             % self.loader)
        if self.device_prefetch < 0:
            raise ValueError("--device-prefetch must be >= 0, got %d"
                             % self.device_prefetch)
        if self.grad_accum > 1 and self.device_augment:
            raise ValueError(
                "--grad-accum > 1 is host-input-path only: the fused "
                "--device-augment step augments per batch and has no "
                "micro-batch scan")
        if not self.train_flag:  # the rest JAX refuses when it trains
            return
        if self.cache_device and not self.device_augment:
            raise ValueError("--cache-device requires --device-augment "
                             "(augmentation must run on-device; the cache "
                             "holds un-augmented canvases)")
        if self.async_eval and self.async_ckpt:
            raise ValueError("--async-eval requires synchronous "
                             "checkpoints (drop --async-ckpt)")
        if self.async_eval and not (self.data
                                    and os.path.isdir(str(self.data))):
            raise ValueError("--async-eval needs --data pointing at a "
                             "dataset root (the eval subprocess scores "
                             "the test split)")
        if self.auto_resume and self.async_ckpt:
            raise ValueError("--auto-resume requires synchronous "
                             "checkpoints (drop --async-ckpt)")
        if self.world_size > 1:
            for flag, on in (("--async-ckpt", self.async_ckpt),
                             ("--auto-resume", self.auto_resume),
                             ("--cache-device", self.cache_device)):
                if on:
                    raise ValueError(
                        "%s is single-process only (--world-size %d): "
                        "restart a multi-process run with --model-load "
                        "instead" % (flag, self.world_size))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch",
        description="Helmet detection train/eval/demo, PyTorch port")
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        default = (f.default_factory()
                   if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if f.type in ("bool", bool):
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=default)
        elif f.type.startswith("List["):
            elem = {"List[int]": int, "List[float]": float,
                    "List[str]": str}[f.type]
            parser.add_argument(flag, type=elem, nargs="+", default=default)
        elif f.type == "Optional[int]":
            parser.add_argument(flag, type=int, default=default)
        elif f.type == "Optional[str]":
            parser.add_argument(flag, type=str, default=default)
        elif f.type == "Optional[float]":
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=type(default), default=default)
    # reference-compat aliases (ref config.py:636-640)
    parser.add_argument("--multiscale_flag", dest="multiscale_flag",
                        action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--scale_factor", dest="scale_factor", type=int,
                        help=argparse.SUPPRESS)
    return parser


def parse_args(argv=None) -> Config:
    ns = vars(build_parser().parse_args(argv))
    return Config(**{f.name: ns[f.name] for f in dataclasses.fields(Config)})


def save_config(cfg: Config, save_path: str) -> None:
    """Write `argument.txt` and `argument.json` into `save_path` (ref
    config.py:853): the fields by name, sorted, atomically."""
    from .utils import atomic_write_bytes, save_json
    os.makedirs(save_path, exist_ok=True)
    d = dataclasses.asdict(cfg)
    txt = "".join("%s: %s\n" % (k, v) for k, v in sorted(d.items()))
    atomic_write_bytes(os.path.join(save_path, "argument.txt"), txt.encode())
    save_json(os.path.join(save_path, "argument.json"), d, indent=2,
              sort_keys=True)


def load_config(path: str) -> Config:
    """The `ARCHITECTURE_FIELDS` of a JSON snapshot of either package on
    a default Config (ref config.py:866): what eval, the demo, export and
    a distillation teacher take from it. The train and runtime fields are
    left out, so a JAX run's options the port refuses (`--device-augment`,
    `--num-devices`, `--spatial`) do not stop its checkpoint loading."""
    with open(path) as f:
        d = json.load(f)
    return dataclasses.replace(
        Config(), **{k: d[k] for k in ARCHITECTURE_FIELDS if k in d})


def update_config_for_eval(cfg: Config, loaded: Config) -> Config:
    """`cfg` with the architecture fields of the training-time snapshot
    (ref config.py:874)."""
    return dataclasses.replace(
        cfg, **{k: getattr(loaded, k) for k in ARCHITECTURE_FIELDS})


# a port checkpoint dir and the files that make it complete (train.py
# writes both atomically, checkpoint.pt first)
_CKPT_RE = re.compile(r"^check_point_(\d+)$")
CHECKPOINT_FILES = ("checkpoint.pt", "weights.npz")


def checkpoint_complete(path: str) -> bool:
    """Does the dir hold a finished port checkpoint (both files)?"""
    return os.path.isdir(path) and all(
        os.path.isfile(os.path.join(path, f)) for f in CHECKPOINT_FILES)


def find_latest_checkpoint(save_path: str) -> Optional[str]:
    """The newest complete `check_point_N` under `save_path`, or None
    (ref train.py:874); incomplete dirs are skipped with a line."""
    try:
        entries = os.listdir(save_path)
    except OSError:
        return None
    numbered = sorted(((int(m.group(1)), name) for name in entries
                       for m in [_CKPT_RE.match(name)] if m), reverse=True)
    for _, name in numbered:
        path = os.path.join(save_path, name)
        if checkpoint_complete(path):
            return path
        print("skipping incomplete checkpoint %s" % path, flush=True)
    return None


def resolve_model_load(path: Optional[str]) -> Optional[str]:
    """A save dir (holding check_point_N dirs, not one itself) -> its
    newest complete checkpoint; anything else unchanged, so a later
    error names the path given (ref train.py:900)."""
    if not path or not os.path.isdir(path):
        return path
    if _CKPT_RE.match(os.path.basename(os.path.normpath(path))) \
            or checkpoint_complete(path):
        return path
    latest = find_latest_checkpoint(path)
    if latest:
        print("--model-load %s is a save dir; using its newest complete "
              "checkpoint %s" % (path, latest), flush=True)
        return latest
    return path


def snapshot_beside(path: str) -> Optional[str]:
    """The `argument.json` of the save dir holding checkpoint `path`, if
    there is one (ref config.py:907)."""
    snap = os.path.join(os.path.dirname(os.path.normpath(
        os.path.abspath(path))), "argument.json")
    return snap if os.path.exists(snap) else None


TRAINING_LOG = "training_log"


def get_config(argv=None) -> Config:
    """The CLI's config (ref config.py:880 `get_config`): parse, apply
    the tier; for a train run create `<save_path>/training_log/`, where
    the train loop writes its gt and pred snapshots (ref
    config.py:898-899); for an eval, demo or export with `--model-load`,
    resolve a save dir to its newest complete checkpoint and take the
    architecture from the snapshot beside it. The snapshot of the
    result is written by the CLI (`save_config`)."""
    cfg = apply_streams(apply_cascade(apply_tier(parse_args(argv))))
    if cfg.train_flag:
        os.makedirs(os.path.join(cfg.save_path, TRAINING_LOG),
                    exist_ok=True)
    elif cfg.model_load:
        cfg = dataclasses.replace(
            cfg, model_load=resolve_model_load(cfg.model_load))
        snap = snapshot_beside(cfg.model_load)
        if snap is not None:
            cfg = update_config_for_eval(cfg, load_config(snap))
    return cfg


def apply_tier(cfg: Config) -> Config:
    """Resolve `--tier` into its preset's fields (a no-op when unset); the
    tier wins over individually passed architecture and serving flags
    (ref config.py:813)."""
    if not cfg.tier:
        return cfg
    over = TIER_PRESETS[cfg.tier]
    print("--tier %s: %s" % (cfg.tier, over), flush=True)
    return dataclasses.replace(cfg, **over)


def tier_of(cfg) -> str:
    """The tier whose architecture (variant, stacks, width) `cfg` has,
    else "flagship" (residual, 1 stack, 128) or "custom"; serving fields
    do not count (ref config.py:828)."""
    arch = (cfg.variant, cfg.num_stack, cfg.hourglass_inch)
    for name, over in TIER_PRESETS.items():
        if arch == (over["variant"], over["num_stack"],
                    over["hourglass_inch"]):
            return name
    if arch == ("residual", 1, 128):
        return "flagship"
    return "custom"


def _calibrated(kind: str, field_name: str,
                repo_root: Optional[str] = None) -> dict:
    """The `selected` threshold of the newest committed
    `artifacts/r<N>/<kind>.json` (highest round wins; unreadable files
    and records without a threshold are skipped), as {field_name: value,
    "_source": its path relative to the repo root}. FileNotFoundError
    when none carries one."""
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    best = None
    for path in glob.glob(os.path.join(root, "artifacts", "*",
                                       kind + ".json")):
        try:
            with open(path) as f:
                rec = json.load(f).get("selected")
        except (OSError, json.JSONDecodeError):
            continue
        if not rec or "threshold" not in rec:
            continue
        m = re.search(r"r(\d+)", os.path.basename(os.path.dirname(path)))
        key = int(m.group(1)) if m else -1
        if best is None or key > best[0]:
            best = (key, path, rec)
    if best is None:
        flag = {"cascade": "cascade", "streams": "stream"}[kind]
        raise FileNotFoundError(
            "--%s: no artifacts/*/%s.json carries a selected operating "
            "point; pass --%s-threshold explicitly" % (flag, kind, flag))
    _, path, rec = best
    return {field_name: float(rec["threshold"]),
            "_source": os.path.relpath(path, root)}


def cascade_overrides(repo_root: Optional[str] = None) -> dict:
    """The calibrated cascade threshold of the newest committed
    `artifacts/*/cascade.json` (ref config.py:700): {"cascade_threshold",
    "_source"}."""
    return _calibrated("cascade", "cascade_threshold", repo_root)


def stream_overrides(repo_root: Optional[str] = None) -> dict:
    """The calibrated tile-skip threshold of the newest committed
    `artifacts/*/streams.json` (ref config.py:751): {"stream_threshold",
    "_source"}."""
    return _calibrated("streams", "stream_threshold", repo_root)


def apply_cascade(cfg: Config) -> Config:
    """`--cascade` without `--cascade-threshold` -> the calibrated
    threshold (a no-op otherwise; ref config.py:738)."""
    if not cfg.cascade or cfg.cascade_threshold is not None:
        return cfg
    over = cascade_overrides()
    print("--cascade: %s -> %s" % (over.pop("_source"), over), flush=True)
    return dataclasses.replace(cfg, **over)


def apply_streams(cfg: Config) -> Config:
    """`--stream` without `--stream-threshold` -> the calibrated
    threshold (a no-op otherwise; ref config.py:790)."""
    if not cfg.stream or cfg.stream_threshold is not None:
        return cfg
    over = stream_overrides()
    print("--stream: %s -> %s" % (over.pop("_source"), over), flush=True)
    return dataclasses.replace(cfg, **over)
